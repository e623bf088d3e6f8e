"""Ops of the port: boxes, resize, NMS and the stem, with their kernels."""
