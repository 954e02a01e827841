"""Fleet-level reliability over the port's runtime: the straggler detector
(``straggler.py``) and the detection -> diagnosis -> eviction controller
(``ft.py``)."""
