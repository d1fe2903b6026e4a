"""Paired image transforms with explicit RNG (host-side, PIL + numpy).

The PyTorch port's copy of ``painter_tpu/data/transforms.py``: the same
parameter draws and the same arithmetic, so a seeded pipeline gives the
same arrays. Behavioral contract from ``Painter/data/pair_transforms.py``
and the transform stacks built in ``main_train.py:232-254``:

- RandomResizedCrop: crop params sampled once and shared between input
  and target; interpolation mode per image ('nearest' for seg-like
  targets, bicubic otherwise) (pair_transforms.py:110-162);
- ColorJitter wrapped in RandomApply(p=0.8) applies to the *input only*
  (pair_transforms.py:241-261), with torchvision's formulas in numpy;
- RandomHorizontalFlip flips both;
- ToTensor + ImageNet Normalize.

All randomness flows through an explicit ``np.random.Generator``.

ColorJitter, the normalize and the seccrop resize run on the host C++ ops
of :mod:`painter_tpu_torch.native` where the JAX package runs its own
(``native=True``, the default); ``native=False`` selects the numpy
versions, which are their plain versions. Both make the same draws.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter

from painter_tpu_torch import native as native_ops
from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.ops.resample import np_resize2d

_PIL_MODES = {"nearest": Image.NEAREST, "bicubic": Image.BICUBIC,
              "bilinear": Image.BILINEAR}


def _resample(mode: Optional[str]):
    return _PIL_MODES["nearest" if mode == "nearest" else "bicubic"]


# ---------------------------------------------------------------------------
# photometric ops (torchvision formulas, numpy)
# ---------------------------------------------------------------------------

def _grayscale(arr: np.ndarray) -> np.ndarray:
    return (0.2989 * arr[..., 0] + 0.587 * arr[..., 1]
            + 0.114 * arr[..., 2])


def adjust_brightness(arr: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(arr * factor, 0.0, 1.0)


def adjust_contrast(arr: np.ndarray, factor: float) -> np.ndarray:
    mean = _grayscale(arr).mean()
    return np.clip(factor * arr + (1 - factor) * mean, 0.0, 1.0)


def adjust_saturation(arr: np.ndarray, factor: float) -> np.ndarray:
    gray = _grayscale(arr)[..., None]
    return np.clip(factor * arr + (1 - factor) * gray, 0.0, 1.0)


def adjust_hue(arr: np.ndarray, factor: float) -> np.ndarray:
    """factor in [-0.5, 0.5]: shift hue in HSV space."""
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr.max(-1)
    minc = arr.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    h = (h + factor) % 1.0

    # vectorized hsv -> rgb: c(n) = v - v*s*clip(min(k, 4-k), 0, 1),
    # k = (n + 6h) mod 6, n = 5/3/1 for r/g/b
    def chan(n):
        k = (n + h * 6.0) % 6.0
        return v - v * s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    out = np.stack([chan(5.0), chan(3.0), chan(1.0)], axis=-1)
    return np.clip(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# paired transforms
# ---------------------------------------------------------------------------

class PairRandomResizedCrop:
    """Shared crop params, per-image interpolation."""

    def __init__(self, size, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def get_params(self, width: int, height: int,
                   rng: np.random.Generator):
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= width and 0 < ch <= height:
                top = int(rng.integers(0, height - ch + 1))
                left = int(rng.integers(0, width - cw + 1))
                return top, left, ch, cw
        # center-crop fallback (torchvision semantics)
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            cw = width
            ch = int(round(cw / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch = height
            cw = int(round(ch * self.ratio[1]))
        else:
            cw, ch = width, height
        top = (height - ch) // 2
        left = (width - cw) // 2
        return top, left, ch, cw

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        top, left, ch, cw = self.get_params(*img.size, rng)
        box = (left, top, left + cw, top + ch)
        wh = (self.size[1], self.size[0])  # self.size is (H, W); PIL wants (W, H)
        img = img.resize(wh, _resample(interp1), box=box)
        tgt = tgt.resize(wh, _resample(interp2), box=box)
        return img, tgt


class PairRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        if rng.random() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            tgt = tgt.transpose(Image.FLIP_LEFT_RIGHT)
        return img, tgt


class PairColorJitter:
    """ColorJitter on the input only, RandomApply(p) wrapper included."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.2,
                 hue=0.1, p=0.8, native: bool = True):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.p = p
        self.native = native

    def _draw_factors(self, rng):
        """(order, factors): one factor per slot, NaN = skip. The draws
        are the same with and without the native ops."""
        order = rng.permutation(4)
        strengths = (self.brightness, self.contrast, self.saturation)
        factors = []
        for fn_id in order:
            if fn_id < 3 and strengths[fn_id]:
                s = strengths[fn_id]
                factors.append(rng.uniform(max(0, 1 - s), 1 + s))
            elif fn_id == 3 and self.hue:
                factors.append(rng.uniform(-self.hue, self.hue))
            else:
                factors.append(np.nan)
        return order, np.asarray(factors, np.float32)

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        if rng.random() >= self.p:
            return img, tgt
        arr = np.asarray(img, np.float32) / 255.0
        order, factors = self._draw_factors(rng)
        if self.native:
            arr = native_ops.color_jitter_inplace(arr, order, factors)
        else:
            fns = (adjust_brightness, adjust_contrast, adjust_saturation,
                   adjust_hue)
            for fn_id, f in zip(order, factors):
                if not np.isnan(f):
                    arr = fns[fn_id](arr, float(f))
        img = Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))
        return img, tgt


class PairRandomErasing:
    """Random erasing on the *input only* (pair_transforms.py:264-320;

    unused by the reference training recipe but part of its transform
    toolkit). torchvision get_params semantics: uniform area in ``scale``
    x image area, log-uniform aspect in ``ratio``, 10 attempts, no-op
    fallback. Operates on whatever array stage it's placed at (the
    reference applies it post-normalize); PIL inputs are converted.
    ``value='random'`` fills with standard-normal noise."""

    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0.0):
        self.p = p
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        if rng.random() >= self.p:
            return img, tgt
        was_pil = isinstance(img, Image.Image)
        arr = np.array(img, np.float32)  # copy: erasing mutates
        h, w = arr.shape[:2]
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            erase_area = h * w * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            eh = int(round(math.sqrt(erase_area * aspect)))
            ew = int(round(math.sqrt(erase_area / aspect)))
            if not (eh < h and ew < w):
                continue
            top = int(rng.integers(0, h - eh + 1))
            left = int(rng.integers(0, w - ew + 1))
            if self.value == "random":
                arr[top:top + eh, left:left + ew] = rng.standard_normal(
                    (eh, ew) + arr.shape[2:]).astype(np.float32)
            else:
                arr[top:top + eh, left:left + ew] = self.value
            break
        if was_pil:
            img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
        else:
            img = arr
        return img, tgt


class PairGaussianBlur:
    """SimCLR-style Gaussian blur on the *input only*

    (pair_transforms.py:323-337; unused by the recipe): sigma ~
    U(sigma[0], sigma[1]), PIL GaussianBlur(radius=sigma)."""

    def __init__(self, sigma=(0.1, 2.0)):
        self.sigma = sigma

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        sigma = rng.uniform(self.sigma[0], self.sigma[1])
        img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
        return img, tgt


class PairToArrayNormalize:
    """PIL -> float32 HWC in ImageNet-normalized space."""

    def __init__(self, native: bool = True):
        self.native = native

    def __call__(self, img, tgt, rng=None, interp1=None, interp2=None):
        mean = np.asarray(IMAGENET_MEAN, np.float32)
        std = np.asarray(IMAGENET_STD, np.float32)

        def conv(x):
            if isinstance(x, Image.Image):
                x = np.asarray(x)  # uint8: the native op has a table
                if not self.native:
                    x = x.astype(np.float32) / 255.0
            if self.native and x.ndim == 3 and x.shape[-1] == 3:
                return native_ops.normalize(x, mean, std)
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
            return (x - mean) / std
        return conv(img), conv(tgt)


class PairCompose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        for t in self.transforms:
            img, tgt = t(img, tgt, rng, interp1, interp2)
        return img, tgt


class ArrayRandomResizedCrop(PairRandomResizedCrop):
    """RRC over already-normalized float arrays (HWC), host-side. The
    native resize is the banded C++ one (4 taps per output for bicubic);
    the plain one, ``ops/resample.np_resize2d``, is a dense gemm over the
    whole crop axis with the same nonzeros."""

    def __init__(self, size, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0), native: bool = True):
        super().__init__(size, scale, ratio)
        self.native = native

    def _resize(self, x, mode):
        if self.native and x.ndim == 3:
            return native_ops.resize_hwc(x, self.size, mode)
        return np_resize2d(x, self.size, mode)

    def __call__(self, img, tgt, rng, interp1=None, interp2=None):
        h, w = img.shape[:2]
        top, left, ch, cw = self.get_params(w, h, rng)
        mode1 = "nearest" if interp1 == "nearest" else "bicubic"
        mode2 = "nearest" if interp2 == "nearest" else "bicubic"
        img = self._resize(img[top:top + ch, left:left + cw], mode1)
        tgt = self._resize(tgt[top:top + ch, left:left + cw], mode2)
        return img, tgt


def train_transform(input_size: int, min_random_scale: float = 0.3,
                    native: bool = True):
    """transform_train (main_train.py:232-238)."""
    return PairCompose([
        PairRandomResizedCrop(input_size, scale=(min_random_scale, 1.0)),
        PairColorJitter(0.4, 0.4, 0.2, 0.1, p=0.8, native=native),
        PairRandomHorizontalFlip(),
        PairToArrayNormalize(native),
    ])


def identity_crop_transform(input_size: int, native: bool = True):
    """transform_train2/3 and transform_val: full-image 'crop'

    (scale=(0.9999, 1.0)) + normalize (main_train.py:240-254)."""
    return PairCompose([
        PairRandomResizedCrop(input_size, scale=(0.9999, 1.0)),
        PairToArrayNormalize(native),
    ])


def seccrop_transform(input_size: Tuple[int, int],
                      min_random_scale: float = 0.3, native: bool = True):
    """transform_train_seccrop: second RRC on the stitched 896x448 canvas,

    ratio (0.3, 0.7) (main_train.py:248-250). Operates on arrays."""
    return PairCompose([
        ArrayRandomResizedCrop(input_size, scale=(min_random_scale, 1.0),
                               ratio=(0.3, 0.7), native=native),
    ])
