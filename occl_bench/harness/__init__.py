"""The general parts of the benchmark: manifest, window, seeds, spans,
the profiled slice, the comparison and the run of one cell.  Nothing here
names a model family."""
