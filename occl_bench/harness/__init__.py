"""The general parts of the benchmark: manifest, feed, drivers, spans,
the profiled slice, the comparison and the run of one cell."""
