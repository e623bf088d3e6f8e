"""Command-line entry points of the port: detection over image files, and
the kernels' stage ladders and probes."""
