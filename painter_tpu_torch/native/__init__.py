"""Host C++ image ops of the training data workers (the port of
``painter_tpu/native``).

``image_ops.cpp`` is built with ``g++`` at first use by
:mod:`painter_tpu_torch.kernels.build` (``HOST_SOURCES``: keyed by a hash
of the source, the flags and the host's ISA, renamed into place) and
loaded with ``ctypes``. The wrappers keep the JAX package's signatures:
``color_jitter_inplace`` (one pass over the four ColorJitter ops),
``normalize`` (uint8 through a lookup table, or float32) and
``resize_hwc`` (the separable *banded* resize: per output index only the
taps that :func:`painter_tpu_torch.ops.resample.resize_weights`' dense
matrix holds nonzero, with the same values).

There is no quiet fallback: a failed build raises. The JAX package's
``_load`` falls back to numpy when the build fails; the port does not copy
that, so a host whose compiler broke is told so instead of training on
the slower path unawares. The numpy versions in
:mod:`painter_tpu_torch.data.transforms` stay as the plain versions, which
a transform selects with ``native=False``, and a user opts out of the
native ops as in the JAX package, with ``PAINTER_TPU_NO_NATIVE=1``:
:func:`enabled` is then false, and the datasets built with ``native=None``
(the trainer's and the dryrun's) take the numpy versions without building
anything.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np

from painter_tpu_torch.kernels import build
from painter_tpu_torch.ops.resample import _cubic_kernel, nearest_indices


def enabled() -> bool:
    """False when the environment opts out of the native ops
    (``PAINTER_TPU_NO_NATIVE=1``, the JAX package's variable); read at
    each call."""
    return os.environ.get("PAINTER_TPU_NO_NATIVE", "") != "1"


@build.lookup
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when ``g++``
    fails or is missing."""
    lib = build.library("image_ops")
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.color_jitter.argtypes = [f32p, i64, i64, i32p, f32p]
    lib.normalize_u8.argtypes = [u8p, f32p, i64, i64, f32p, f32p]
    lib.normalize_f32.argtypes = [f32p, f32p, i64, i64, f32p, f32p]
    lib.resize_hwc.argtypes = [f32p, i64, i64, i64, f32p, i64, i64,
                               i32p, f32p, ctypes.c_int32,
                               i32p, f32p, ctypes.c_int32]
    lib.resize_nearest_hwc.argtypes = [f32p, i64, i64, i64, f32p, i64,
                                       i64, i32p, i32p]
    for fn in (lib.color_jitter, lib.normalize_u8, lib.normalize_f32,
               lib.resize_hwc, lib.resize_nearest_hwc):
        fn.restype = None
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_hwc(x: np.ndarray, what: str) -> None:
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"{what} takes an (H, W, 3) image, got {x.shape}")


def color_jitter_inplace(arr: np.ndarray, order, factors) -> np.ndarray:
    """Apply up to 4 jitter ops in ``order`` (0 brightness, 1 contrast, 2
    saturation, 3 hue) to float32 [0,1] HWC ``arr``; ``factors[slot]``
    NaN = skip. A contiguous float32 ``arr`` is mutated in place; the
    result is returned either way."""
    lib = library()
    arr = np.ascontiguousarray(arr, np.float32)
    _check_hwc(arr, "color_jitter_inplace")
    o = np.ascontiguousarray(order, np.int32)
    f = np.ascontiguousarray(factors, np.float32)
    if o.shape != (4,) or f.shape != (4,):
        raise ValueError(f"order {o.shape} and factors {f.shape} must "
                         "each hold 4 slots")
    lib.color_jitter(_fp(arr), arr.shape[0], arr.shape[1], _ip(o), _fp(f))
    return arr


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """uint8 or float32-[0,1] HWC -> ``(x - mean) / std`` float32 HWC."""
    lib = library()
    _check_hwc(img, "normalize")
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if m.shape != (3,) or s.shape != (3,):
        raise ValueError(f"mean {m.shape} and std {s.shape} must be (3,)")
    out = np.empty(img.shape[:2] + (3,), np.float32)
    if img.dtype == np.uint8:
        src = np.ascontiguousarray(img)
        lib.normalize_u8(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fp(out),
            img.shape[0], img.shape[1], _fp(m), _fp(s))
    else:
        src = np.ascontiguousarray(img, np.float32)
        lib.normalize_f32(_fp(src), _fp(out), img.shape[0], img.shape[1],
                          _fp(m), _fp(s))
    return out


@functools.lru_cache(maxsize=None)
def _banded_weights(in_size: int, out_size: int, mode: str
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(idx (out, taps) int32, w (out, taps) float32): the nonzeros of
    ``ops/resample.resize_weights``' dense matrix, identical values."""
    if in_size == out_size:
        idx = np.arange(out_size, dtype=np.int32)[:, None]
        return idx, np.ones((out_size, 1), np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    if mode == "linear":
        # torch clamps the source coordinate at 0 (resize_weights); with
        # src in [0, in - 0.5) the floor needs no further clipping
        src = np.maximum(src, 0.0)
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        idx = np.stack([i0, np.clip(i0 + 1, 0, in_size - 1)], 1)
        w = np.stack([1.0 - t, t], 1)
        return idx.astype(np.int32), w.astype(np.float32)
    if mode == "cubic":
        i = np.floor(src).astype(np.int64)
        t = src - i
        idx = np.stack([np.clip(i + k, 0, in_size - 1)
                        for k in range(-1, 3)], 1)
        w = np.stack([_cubic_kernel(t - k) for k in range(-1, 3)], 1)
        return idx.astype(np.int32), w.astype(np.float32)
    raise ValueError(f"unknown mode {mode!r}")


def resize_hwc(x: np.ndarray, out_hw, mode: str) -> np.ndarray:
    """(H, W, C) -> (out_h, out_w, C) float32 with torch ``F.interpolate``
    semantics (``mode`` 'bicubic' | 'bilinear' | 'nearest'), as
    ``ops/resample.np_resize2d``."""
    lib = library()
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 3:
        raise ValueError(f"resize_hwc takes an (H, W, C) array, got "
                         f"{x.shape}")
    h, w, c = x.shape
    out = np.empty((out_hw[0], out_hw[1], c), np.float32)
    if mode == "nearest":
        ih = np.ascontiguousarray(nearest_indices(h, out_hw[0]), np.int32)
        iw = np.ascontiguousarray(nearest_indices(w, out_hw[1]), np.int32)
        lib.resize_nearest_hwc(_fp(x), h, w, c, _fp(out), out_hw[0],
                               out_hw[1], _ip(ih), _ip(iw))
        return out
    modes = {"bicubic": "cubic", "bilinear": "linear"}
    if mode not in modes:
        raise ValueError(f"unknown mode {mode!r}")
    ih, wh = _banded_weights(h, out_hw[0], modes[mode])
    iw, ww = _banded_weights(w, out_hw[1], modes[mode])
    lib.resize_hwc(_fp(x), h, w, c, _fp(out), out_hw[0], out_hw[1],
                   _ip(ih), _fp(wh), ih.shape[1], _ip(iw), _fp(ww),
                   iw.shape[1])
    return out
