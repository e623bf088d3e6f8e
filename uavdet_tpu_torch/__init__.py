"""PyTorch + CUDA port of uavdet_tpu for NVIDIA Hopper GPUs.

Beside the JAX package, with the same layout (``ops/``, ``models/``,
``utils/``, ``inference.py``) and the CUDA sources of its hand-written
kernels in ``csrc/``. Imports torch and numpy, never JAX.
"""
