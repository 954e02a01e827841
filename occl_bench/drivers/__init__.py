"""One driver per program path: ``<driver>.py`` exposes ``run(ctx) ->
Outcome`` (``harness/window.py``); a cell's workload file names it."""
