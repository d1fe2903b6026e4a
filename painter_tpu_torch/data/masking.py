"""BEiT-style block-wise masking on the patch grid (PyTorch port's copy of
``painter_tpu/data/masking.py``; numpy only, the same draws for a seed).

Behavioral contract from ``Painter/util/masking_generator.py``: repeated
random block proposals (10 attempts each, area in [min, max], log-uniform
aspect in [0.3, 1/0.3]) until the target count is reached, then random
add/remove of single cells to hit *exactly* ``num_masking_patches`` —
the exact-count invariant the reference self-tests over 10M draws
(masking_generator.py:96-105).

Deviation: global ``random``/``np.random`` state is replaced by an
explicit ``np.random.Generator`` per call for reproducibility (SURVEY.md
§4 item 5).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class BlockMaskingGenerator:
    def __init__(self, input_size, num_masking_patches: int,
                 min_num_patches: int = 4,
                 max_num_patches: Optional[int] = None,
                 min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1.0 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def get_shape(self) -> Tuple[int, int]:
        return self.height, self.width

    def _add_block(self, mask: np.ndarray, max_mask_patches: int,
                   rng: np.random.Generator) -> int:
        delta = 0
        for _ in range(10):
            # python random.uniform tolerates b < a (the reference relies
            # on that when the remaining budget < min_num_patches);
            # numpy raises, so order the bounds explicitly.
            lo, hi = sorted((float(self.min_num_patches),
                             float(max_mask_patches)))
            target_area = rng.uniform(lo, hi)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h + 1)
                left = rng.integers(0, self.width - w + 1)
                region = mask[top:top + h, left:left + w]
                num_masked = int(region.sum())
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta = int(h * w - num_masked)
                    region[:] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        mask = np.zeros(self.get_shape(), dtype=np.int32)
        count = 0
        while count < self.num_masking_patches:
            budget = min(self.num_masking_patches - count,
                         self.max_num_patches)
            delta = self._add_block(mask, budget, rng)
            if delta == 0:
                break
            count += delta
        # enforce the exact-count invariant
        if count > self.num_masking_patches:
            ys, xs = mask.nonzero()
            drop = rng.choice(len(ys), count - self.num_masking_patches,
                              replace=False)
            mask[ys[drop], xs[drop]] = 0
        elif count < self.num_masking_patches:
            ys, xs = (mask == 0).nonzero()
            add = rng.choice(len(ys), self.num_masking_patches - count,
                             replace=False)
            mask[ys[add], xs[add]] = 1
        assert mask.sum() == self.num_masking_patches
        return mask

    def half_mask(self) -> np.ndarray:
        """Deterministic bottom-half mask (= inference distribution,

        pairdataset.py:183-186)."""
        mask = np.zeros(self.get_shape(), dtype=np.int32)
        mask[self.height // 2:, :] = 1
        return mask
