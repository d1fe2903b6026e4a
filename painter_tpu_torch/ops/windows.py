"""Window partition/unpartition for windowed attention (NHWC).

Mirrors ``Painter/util/vitdet_utils.py:16-60``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nWin, ws, ws, C), zero-padding bottom/right."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size,
                  wp // window_size, window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(
        -1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`, cropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size,
                        window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w]
    return x
