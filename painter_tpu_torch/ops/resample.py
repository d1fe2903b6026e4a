"""Torch-semantics resampling as separable fp32 matmuls.

The reference resizes positional tables and painted outputs with
``torch.nn.functional.interpolate`` (``vitdet_utils.py:75-93`` linear,
``:128-157`` bicubic). The exact interpolation weight matrix is built with
numpy (align_corners=False, antialias=False, cubic a=-0.75) and applied as
one matmul per axis, the same construction the JAX package uses, so both
packages resize with identical weights.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel; torch uses a=-0.75."""
    s = np.abs(s)
    out = np.zeros_like(s)
    m1 = s <= 1.0
    out[m1] = ((a + 2.0) * s[m1] - (a + 3.0)) * s[m1] * s[m1] + 1.0
    m2 = (s > 1.0) & (s < 2.0)
    out[m2] = ((a * s[m2] - 5.0 * a) * s[m2] + 8.0 * a) * s[m2] - 4.0 * a
    return out


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) float64 matrix W with ``y = W @ x`` equal to
    torch interpolate; mode 'linear' or 'cubic'."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float64)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = dst.astype(np.int64)
    if mode == "linear":
        # torch clamps the source coordinate at 0 for linear modes
        src = np.maximum(src, 0.0)
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        i0 = np.clip(i0, 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        np.add.at(w, (rows, i0), 1.0 - t)
        np.add.at(w, (rows, i1), t)
    elif mode == "cubic":
        i = np.floor(src).astype(np.int64)
        t = src - i
        for k in range(-1, 3):
            idx = np.clip(i + k, 0, in_size - 1)
            np.add.at(w, (rows, idx), _cubic_kernel(t - k))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return w


@functools.lru_cache(maxsize=None)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """torch 'nearest' (legacy) source index per output position."""
    dst = np.arange(out_size, dtype=np.float64)
    return np.minimum(np.floor(dst * (in_size / out_size)),
                      in_size - 1).astype(np.int64)


def resize1d(x: torch.Tensor, out_size: int, mode: str,
             axis: int = 0) -> torch.Tensor:
    """Resize one axis of ``x`` with torch ``F.interpolate`` semantics."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if mode == "nearest":
        idx = torch.from_numpy(nearest_indices(in_size, out_size))
        return x.index_select(axis, idx.to(x.device))
    w = torch.from_numpy(resize_weights(in_size, out_size, mode)).to(
        device=x.device, dtype=x.dtype)
    y = torch.matmul(x.movedim(axis, -1), w.T)
    return y.movedim(-1, axis)


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int], mode: str,
             h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Resize the (H, W) axes; mode 'bilinear' | 'bicubic' | 'nearest'."""
    mode1d = {"bilinear": "linear", "bicubic": "cubic",
              "nearest": "nearest"}[mode]
    x = resize1d(x, out_hw[0], mode1d, axis=h_axis % x.ndim)
    return resize1d(x, out_hw[1], mode1d, axis=w_axis % x.ndim)


def np_resize2d(x: np.ndarray, out_hw: Tuple[int, int],
                mode: str) -> np.ndarray:
    """Host-side (H, W, C) resize with the same weights (fp32 gemms)."""
    h, w = x.shape[:2]
    if mode == "nearest":
        return x[nearest_indices(h, out_hw[0])][:,
                                                nearest_indices(w, out_hw[1])]
    m = {"bicubic": "cubic", "bilinear": "linear"}[mode]
    wh = resize_weights(h, out_hw[0], m).astype(np.float32)
    ww = resize_weights(w, out_hw[1], m).astype(np.float32)
    y = np.tensordot(wh, x.astype(np.float32), axes=(1, 0))  # (H, w, c)
    z = np.tensordot(ww, y, axes=(1, 1))                     # (W, H, c)
    return z.transpose(1, 0, 2)
