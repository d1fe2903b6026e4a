"""Patchify/unpatchify for stitched-pair images (NHWC).

Mirrors ``Painter/models_painter.py:355-383``: images are the vertical
stitch of an in-context pair so H == 2*W, and the per-patch pixel vector
is ordered (patch_row, patch_col, channel), channel fastest.
"""
from __future__ import annotations

import torch


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, L, p*p*C), requires H == 2*W."""
    n, height, width, c = imgs.shape
    p = patch_size
    if height != 2 * width or height % p:
        raise ValueError(f"patchify needs H == 2*W divisible by {p}; got "
                         f"{height}x{width}")
    h, w = height // p, width // p
    x = imgs.reshape(n, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * w, p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int,
               channels: int = 3) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, H, W, C), assuming the H == 2*W token grid."""
    n, length, _ = x.shape
    p = patch_size
    w = int(round((length * 0.5) ** 0.5))
    h = w * 2
    if h * w != length:
        raise ValueError(f"{length} tokens are not an H == 2*W grid")
    x = x.reshape(n, h, w, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * p, w * p, channels)
