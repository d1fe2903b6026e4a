"""PSNR / SSIM for the restoration tasks (SIDD denoise, derain, LoL).

The reference computes LoL metrics inline with skimage
(``eval/lol/painter_inference_lol.py:168-172``) and defers SIDD/derain to
MATLAB scripts it does not ship (``docs/EVAL.md:48-64``); here both are
self-contained (SURVEY.md §7 non-goal: no MATLAB).

PSNR matches skimage ``peak_signal_noise_ratio``; SSIM implements Wang et
al. 2004 with the settings skimage uses for floating images and
``gaussian_weights=True`` unavailable in the LoL script — the script uses
skimage defaults (7x7 uniform window), reproduced exactly here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(pred: np.ndarray, target: np.ndarray,
         data_range: float = 1.0) -> float:
    err = np.mean((pred.astype(np.float64)
                   - target.astype(np.float64)) ** 2)
    return float(10 * np.log10(data_range ** 2 / max(err, 1e-12)))


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """skimage-default SSIM: uniform filter, per-channel mean.

    Matches skimage.metrics.structural_similarity(pred, target,
    multichannel=True / channel_axis=-1) for float inputs.
    """
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    if pred.ndim == 2:
        pred = pred[..., None]
        target = target[..., None]

    def one_channel(x, y):
        nd = 2
        cov_norm = win_size ** nd / (win_size ** nd - 1)  # sample cov
        ux = uniform_filter(x, size=win_size)
        uy = uniform_filter(y, size=win_size)
        uxx = uniform_filter(x * x, size=win_size)
        uyy = uniform_filter(y * y, size=win_size)
        uxy = uniform_filter(x * y, size=win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        c1 = (k1 * data_range) ** 2
        c2 = (k2 * data_range) ** 2
        a1 = 2 * ux * uy + c1
        a2 = 2 * vxy + c2
        b1 = ux ** 2 + uy ** 2 + c1
        b2 = vx + vy + c2
        s = (a1 * a2) / (b1 * b2)
        pad = (win_size - 1) // 2
        return s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean()

    vals = [one_channel(pred[..., c], target[..., c])
            for c in range(pred.shape[-1])]
    return float(np.mean(vals))


class RestorationEvaluator:
    def __init__(self, data_range: float = 1.0):
        self.data_range = data_range
        self._psnr = []
        self._ssim = []

    def process(self, pred: np.ndarray, target: np.ndarray):
        pred = np.clip(pred, 0, self.data_range)
        target = np.clip(target, 0, self.data_range)
        self._psnr.append(psnr(pred, target, self.data_range))
        self._ssim.append(ssim(pred, target, self.data_range))

    def evaluate(self) -> Dict[str, float]:
        return {"psnr": float(np.mean(self._psnr)),
                "ssim": float(np.mean(self._ssim)),
                "n": len(self._psnr)}
