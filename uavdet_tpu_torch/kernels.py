"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source and all of them at once, and linked into one shared
library with a plain C interface, loaded with ctypes. The library is built
at the first launch, never at import, into ``_build/`` beside this file
(git-ignored). Its file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Each kernel is a :class:`CudaKernel`; its ``launches`` counts the launches
that went through it, so a run can show that the main path used the kernel.
A launch that CUDA refuses raises: there is no fallback. The wrappers in
``ops/`` reach the kernels through operators registered with
``torch.library`` (``torch.ops.uavdet.*``), whose real implementations
launch them: the counts advance when an exported program runs too.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


class BuildInfo(NamedTuple):
    path: Path
    seconds: float     # time spent in nvcc; 0 when the library was cached
    log: str           # nvcc's output (ptxas resource usage) when built


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc "
                           "on PATH")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libuavdet_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return BuildInfo(lib, time.perf_counter() - t0, "".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    lib.uavdet_error_string.argtypes = [_I]
    lib.uavdet_error_string.restype = ctypes.c_char_p
    lib.uavdet_stem_l1_num_partials.argtypes = [_I, _I]
    lib.uavdet_stem_l1_num_partials.restype = _I
    lib.uavdet_dyconv_num_partials.argtypes = [_I, _I]
    lib.uavdet_dyconv_num_partials.restype = _I
    return lib


class CudaKernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, symbol: str, argtypes, counts_into=None):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        # another path of the same kernel counts its launches there
        self.counts_into = counts_into or self

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = _I
        return fn

    def __call__(self, *args) -> None:
        err = self._fn(*args)
        if err != 0:
            msg = library().uavdet_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.counts_into.launches += 1


# (x, x_is_u8, k1, out, partial, B, H, W, stream)
STEM_L1 = CudaKernel("uavdet_stem_l1", [_P, _I, _P, _P, _P, _I, _I, _I, _P])
# (a1, k2, out, B, H, W, stream)
STEM_L2 = CudaKernel("uavdet_stem_l2", [_P, _P, _P, _I, _I, _I, _P])
# (boxes, alive, B, N, iou_threshold, stream)
NMS = CudaKernel("uavdet_nms_alive", [_P, _P, _I, _I, ctypes.c_float, _P])
# above ops.nms.MAX_BOXES boxes: (boxes, alive, mask, B, N, iou_threshold,
# stream), counted as NMS
NMS_LARGE = CudaKernel("uavdet_nms_alive_large",
                       [_P, _P, _P, _I, _I, ctypes.c_float, _P], NMS)
# (x, k, mul, add, out, partial or NULL, B, H, W, C, Co, fold_out, stream)
DYCONV = CudaKernel("uavdet_dyconv", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _P])
# (x, x_is_u8, k1, k2, out, B, H, W, stream)
STEM_FUSED = CudaKernel("uavdet_stem_fused", [_P, _I, _P, _P, _P, _I, _I, _I,
                                              _P])
# (a1, k2, out, B, H, W, stage, stream)
STEM_L2_STAGE = CudaKernel("uavdet_stem_l2_stage", [_P, _P, _P, _I, _I, _I,
                                                    _I, _P])
# (x, w1, k2, k3, b1, b2, b3, out, B, H, W, stage, stream)
POST_STEM_BLOCK = CudaKernel("uavdet_post_stem_block", [
    _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
# (x, x_is_bf16, weight, bias, y, workspace, B, C, HW, S, eps, stream): two
# kernels, moments and apply, counted as one
GROUP_NORM1 = CudaKernel("uavdet_group_norm1", [
    _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P])
# (x, residual or NULL, y, mean, var, weight, bias, params_bf16, eps, act, B,
# C, HW, channels_last, grid, stream)
BN_ACT = CudaKernel("uavdet_bn_act", [
    _P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_float, _I, _I, _I, _I, _I, _I,
    _P])

# Measuring aids of the NMS kernel, on no path and so not in ALL: the kernel
# with the global timer read after each of its two phases
# (boxes, alive, stamps, B, N, iou_threshold, stream), and its grid with no
# work in it (B, stream).
NMS_STAMPED = CudaKernel("uavdet_nms_alive_stamped",
                         [_P, _P, _P, _I, _I, ctypes.c_float, _P])
NMS_EMPTY = CudaKernel("uavdet_nms_empty_launch", [_I, _P])

ALL = {"stem_l1": STEM_L1, "stem_l2": STEM_L2, "nms": NMS, "dyconv": DYCONV,
       "stem_fused": STEM_FUSED, "stem_l2_stage": STEM_L2_STAGE,
       "post_stem_block": POST_STEM_BLOCK, "group_norm1": GROUP_NORM1,
       "bn_act": BN_ACT}


def launch_counts() -> dict:
    return {name: k.launches for name, k in ALL.items()}


def reset_launch_counts() -> None:
    for k in ALL.values():
        k.launches = 0


def add_launches(counts: dict) -> None:
    """Adds ``counts`` ({name: launches}, as ``launch_counts`` gives them)
    to the launch counts: a CUDA graph's replay launches the kernels its
    capture counted, without calling their wrappers."""
    for name, n in counts.items():
        ALL[name].launches += n


def check_device(t, what: str) -> None:
    """Raises for a tensor on neither a CUDA device nor the CPU: the kernels
    run on the card and their plain versions on the CPU, nothing else."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} for device {t.device}")


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as a pointer."""
    import torch
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream
