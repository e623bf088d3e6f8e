"""Command-line entry points of the port: the kernels' stage ladders."""
