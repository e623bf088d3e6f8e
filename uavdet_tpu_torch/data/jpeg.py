"""JPEG on the card: nvJPEG decode and encode, bound with ctypes.

``csrc/io/jpeg.cu`` is compiled by ``nvcc`` and linked against the CUDA
toolkit's ``libnvjpeg`` into its own library in ``_build/`` (git-ignored),
apart from the kernels' library (``kernels.build``), so a toolkit without
nvJPEG does not take the kernels down with it. The library is built at the
first call, never at import; a build, load, decode or encode failure
raises: there is no host path on the card.

  decode(list of bytes, device) -> list of (H, W, 3) uint8 RGB tensors
  encode((H, W, 3) uint8 tensor on the card, quality) -> bytes

This is I/O through a library call, not the port of a TPU kernel (the JAX
package decodes on the host with PIL or ``native/uavloader.cc``).

nvJPEG's own conversion to RGB truncates where libjpeg rounds (about half
a unit darker on average, and off by up to 19 units at 4:2:0 chroma
edges), so ``decode`` takes nvJPEG's YCbCr planes and does libjpeg's
chroma upsampling and colour conversion itself (``ycc_to_rgb``, torch ops
on the decode's stream): the frames then are PIL's, and the JAX
package's, but for nvJPEG's IDCT. ``REFERENCE`` holds JPEGs as the JAX
package's writer and Anti-UAV's frames are stored (PIL's defaults: quality
75, 4:2:0 chroma; and 4:2:2, grey, 4:4:4 at quality 95) beside PIL's
decode of them, for holding the decode against libjpeg's on the card
whatever that host has installed; ``write_reference`` makes the file on a
host with PIL.
"""

import ctypes
import functools
import hashlib
import io
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import BUILD_DIR, CSRC, BuildInfo, _nvcc

SOURCE = CSRC / "io" / "jpeg.cu"
REFERENCE = Path(__file__).with_name("jpeg_reference.npz")
NVCC_FLAGS = ("-O2", "-std=c++17", "-Xcompiler", "-fPIC", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIZE = ctypes.c_size_t
_MAX_COMPONENT = 4
# nvjpegChromaSubsampling_t and nvjpegOutputFormat_t (nvjpeg.h)
CSS_444, CSS_422, CSS_420, CSS_GRAY = 0, 1, 2, 6
OUTPUT_YUV, OUTPUT_Y, OUTPUT_RGBI = 1, 2, 5


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _fancy_upsample(c, rows: bool):
    """libjpeg's "fancy" 2x chroma upsampling (jdsample.c, h2v1 and h2v2:
    3/4 of the nearer sample and 1/4 of the further, edges replicated) of
    an int32 (h, w) plane -> (2h or h, 2w); its rounding bias alternates
    between the two outputs of a sample as libjpeg's does."""
    if rows:   # h2v2: the column sums 3 c[i] + c[i -/+ 1], 16ths below
        up = torch.cat([c[:1], c[:-1]])
        down = torch.cat([c[1:], c[-1:]])
        c = torch.stack([3 * c + up, 3 * c + down], 1).flatten(0, 1)
        bias, shift = (8, 7), 4
    else:      # h2v1: quarters
        bias, shift = (1, 2), 2
    left = torch.cat([c[:, :1], c[:, :-1]], 1)
    right = torch.cat([c[:, 1:], c[:, -1:]], 1)
    return torch.stack([(3 * c + left + bias[0]) >> shift,
                        (3 * c + right + bias[1]) >> shift], 2).flatten(1)


def ycc_to_rgb(planes, subsampling: int):
    """A JPEG's decoded YCbCr planes (uint8 tensors: Y, or Y, Cb, Cr at
    their subsampled sizes) -> (H, W, 3) uint8 RGB, with libjpeg's fancy
    upsampling and fixed-point colour conversion (jdcolor.c), bit for bit,
    on the planes' device."""
    if subsampling == CSS_GRAY:
        return planes[0].unsqueeze(-1).expand(-1, -1, 3).contiguous()
    y = planes[0].to(torch.int32)
    h, w = y.shape
    cb, cr = (p.to(torch.int32) for p in planes[1:3])
    if subsampling != CSS_444:
        rows = subsampling == CSS_420
        cb, cr = (_fancy_upsample(c, rows)[:h, :w] for c in (cb, cr))
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.402) * cr + (1 << 15)) >> 16)
    g = y + ((-_fix(0.34414) * cb + (1 << 15) - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.772) * cb + (1 << 15)) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def _lib_dirs() -> list:
    from torch.utils.cpp_extension import CUDA_HOME
    return [str(Path(CUDA_HOME) / d) for d in ("lib64", "lib")
            if (Path(CUDA_HOME) / d).is_dir()]


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/io/jpeg.cu`` against nvJPEG unless a library of the
    same hash exists."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libuavdet_jpeg_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    # the toolkit's library directory as the run path: the loader finds
    # libnvjpeg there without LD_LIBRARY_PATH
    rpath = [f"-Xlinker=-rpath={d}" for d in _lib_dirs()]
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *NVCC_FLAGS, *rpath, "-o", str(tmp),
                          str(SOURCE), "-lnvjpeg"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE.name} ({res.returncode})"
                           f":\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return BuildInfo(lib, time.perf_counter() - t0, res.stdout + res.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    sigs = {
        "uavjpeg_create": [ctypes.POINTER(_P)],
        "uavjpeg_state_create": [_P, ctypes.POINTER(_P)],
        "uavjpeg_info": [_P, ctypes.c_char_p, _SIZE, ctypes.POINTER(_I),
                         ctypes.POINTER(_I), ctypes.POINTER(_I),
                         ctypes.POINTER(_I)],
        "uavjpeg_decode": [_P, _P, ctypes.c_char_p, _SIZE, _I,
                           ctypes.POINTER(_P), ctypes.POINTER(_I), _P],
        "uavjpeg_encode_rgbi": [_P, _P, _I, _I, _I, _I, _P,
                                ctypes.POINTER(_SIZE)],
        "uavjpeg_retrieve": [_P, _P, ctypes.POINTER(_SIZE), _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    for name in ("uavjpeg_destroy", "uavjpeg_state_destroy"):
        getattr(lib, name).argtypes = [_P]
        getattr(lib, name).restype = None
    lib.uavjpeg_error_string.argtypes = [_I]
    lib.uavjpeg_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: error {err} "
                           f"({lib.uavjpeg_error_string(err).decode()})")


class _DecoderState:
    """One thread's nvJPEG decoder state, destroyed with the thread's
    ``threading.local``."""

    def __init__(self, lib, codec_ptr):
        self._lib = lib
        self.ptr = _P()
        _check(lib, "nvjpegJpegStateCreate",
               lib.uavjpeg_state_create(codec_ptr, ctypes.byref(self.ptr)))

    def __del__(self):
        if self.ptr:
            self._lib.uavjpeg_state_destroy(self.ptr)


class Codec:
    """The nvJPEG handle, shared by every thread, with a decoder state per
    decoding thread (threads decode at once: ctypes releases the GIL, and
    the host parts of their decodes overlap) and one encoder behind a
    lock."""

    def __init__(self):
        self._lib = library()
        self._ptr = _P()
        _check(self._lib, "uavjpeg_create",
               self._lib.uavjpeg_create(ctypes.byref(self._ptr)))
        self._local = threading.local()
        self._encode_lock = threading.Lock()

    def _state(self) -> _DecoderState:
        state = getattr(self._local, "state", None)
        if state is None:
            state = self._local.state = _DecoderState(self._lib, self._ptr)
        return state

    def info(self, data: bytes) -> tuple:
        """(chroma subsampling, [(height, width) of each component]) from
        the JPEG header (nvjpegGetImageInfo)."""
        n, css = _I(), _I()
        widths, heights = (_I * _MAX_COMPONENT)(), (_I * _MAX_COMPONENT)()
        _check(self._lib, "nvjpegGetImageInfo",
               self._lib.uavjpeg_info(self._ptr, data, len(data),
                                      ctypes.byref(n), ctypes.byref(css),
                                      widths, heights))
        return css.value, [(heights[k], widths[k]) for k in range(n.value)]

    def decode_planes(self, data: bytes, device, fmt: int, sizes) -> list:
        """The decoder's output planes of the format ``fmt``, one uint8
        tensor of each (height, width[, 3]) in ``sizes``, on ``device``'s
        current stream."""
        planes = [torch.empty(hw, dtype=torch.uint8, device=device)
                  for hw in sizes]
        ptrs = (_P * 3)(*[p.data_ptr() for p in planes])
        pitches = (_I * 3)(*[p.stride(0) for p in planes])
        stream = torch.cuda.current_stream(planes[0].device).cuda_stream
        _check(self._lib, "nvjpegDecode",
               self._lib.uavjpeg_decode(self._ptr, self._state().ptr, data,
                                        len(data), fmt, ptrs, pitches,
                                        stream))
        return planes

    def decode(self, data: bytes, device):
        """(H, W, 3) uint8 RGB on ``device``, decoded on its current
        stream. Baseline 4:4:4, 4:2:2, 4:2:0 and grey JPEGs come out as
        libjpeg's (PIL's) decode of them would: nvJPEG's YCbCr planes,
        then libjpeg's chroma upsampling and colour conversion
        (``ycc_to_rgb``); other subsamplings as nvJPEG's own RGB."""
        css, sizes = self.info(data)
        if css == CSS_GRAY:
            return ycc_to_rgb(self.decode_planes(data, device, OUTPUT_Y,
                                                 sizes[:1]), css)
        if css in (CSS_444, CSS_422, CSS_420):
            return ycc_to_rgb(self.decode_planes(data, device, OUTPUT_YUV,
                                                 sizes[:3]), css)
        h, w = sizes[0]
        return self.decode_planes(data, device, OUTPUT_RGBI,
                                  [(h, w, 3)])[0]

    def encode(self, img, quality: int) -> bytes:
        """JPEG bytes of a (H, W, 3) uint8 RGB tensor on the card, 4:4:4;
        waits for the current stream."""
        if (img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3
                or img.device.type != "cuda"):
            raise ValueError("encode takes a (H, W, 3) uint8 CUDA tensor, "
                             f"got {tuple(img.shape)} {img.dtype} on "
                             f"{img.device}")
        img = img.contiguous()
        h, w = img.shape[:2]
        stream = torch.cuda.current_stream(img.device).cuda_stream
        n = _SIZE()
        with self._encode_lock:
            _check(self._lib, "nvjpegEncodeImage",
                   self._lib.uavjpeg_encode_rgbi(
                       self._ptr, img.data_ptr(), h, w, 3 * w, int(quality),
                       stream, ctypes.byref(n)))
            buf = ctypes.create_string_buffer(n.value)
            _check(self._lib, "nvjpegEncodeRetrieveBitstream",
                   self._lib.uavjpeg_retrieve(self._ptr, buf,
                                              ctypes.byref(n), stream))
        return buf.raw[:n.value]


@functools.cache
def codec() -> Codec:
    """The process's codec, made at its first use."""
    return Codec()


def decode(datas, device) -> list:
    """JPEG bytes -> (H, W, 3) uint8 RGB tensors on the CUDA ``device``, on
    the calling thread's current stream, with its decoder state."""
    c = codec()
    return [c.decode(d, device) for d in datas]


def encode(img, quality: int = 95) -> bytes:
    return codec().encode(img, quality)



def reference_frames() -> dict:
    """name -> (source frame, PIL's save options) of the reference: the
    first two frames of the synthetic tree at 128 px (the JAX writer's
    visible and infrared frame: noise of 0..80 and a bright box) and a
    smooth sky of 120 x 200 (a height off the 16-pixel MCU) with a dark,
    soft-edged target, at PIL's defaults as the JAX writer stores frames;
    then the samplings of the other decode paths: the sky at 4:2:2 and in
    grey, the visible frame as the card's writer stores it (quality 95,
    4:4:4)."""
    from .synthetic import synthetic_frames
    out = {}
    it = synthetic_frames("", splits=("val",), n_seq=1, n_frames=1,
                          img_size=128, seed=0)
    for kind, path, arr in it:
        if kind == "frame":
            out[Path(path).parent.name] = (arr, {})
    y, x = np.mgrid[0:120, 0:200].astype(np.float64)
    sky = np.stack([90 + 0.9 * y, 140 + 0.6 * y + 0.1 * x,
                    230 - 0.2 * y], -1)
    blob = np.exp(-(((x - 131) / 6.0) ** 2 + ((y - 47) / 3.5) ** 2))
    sky = np.clip(np.round(sky * (1 - 0.8 * blob[..., None])), 0, 255)
    out["sky"] = (sky.astype(np.uint8), {})
    out["sky_422"] = (out["sky"][0], {"subsampling": 1})
    out["sky_grey"] = (np.ascontiguousarray(out["sky"][0][..., 1]), {})
    out["visible_444_q95"] = (out["visible"][0],
                              {"quality": 95, "subsampling": 0})
    return out


def write_reference(path=REFERENCE) -> None:
    """Encode ``reference_frames`` with PIL and store the bytes
    (``jpeg_<name>``) beside PIL's RGB decode (``rgb_<name>``)."""
    from PIL import Image
    arrays = {}
    for name, (img, options) in reference_frames().items():
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", **options)
        data = buf.getvalue()
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.array(im.convert("RGB"))
        arrays[f"jpeg_{name}"] = np.frombuffer(data, np.uint8)
        arrays[f"rgb_{name}"] = rgb
    np.savez_compressed(path, **arrays)


def load_reference(path=REFERENCE) -> dict:
    """name -> (JPEG bytes, PIL's (H, W, 3) uint8 decode)."""
    with np.load(path) as z:
        return {k[5:]: (z[k].tobytes(), z[f"rgb_{k[5:]}"])
                for k in z.files if k.startswith("jpeg_")}
