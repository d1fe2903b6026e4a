"""Training data pipeline: pair dataset, mixture sampling, batching.

The PyTorch port's copy of ``painter_tpu/data/pairdataset.py``: for a
given seed it yields the same samples. Behavioral contract from
``Painter/data/pairdataset.py`` and ``main_train.py:232-307``:
- JSON pair lists per task, mixture weight per list
  ``[0.1, 0.2, 0.15, 0.25, 0.2, 0.15, 0.05, 0.05]`` normalized per-sample
  by dataset size (pairdataset.py:56-61, train_painter_vit_large.sh:23-31);
- per-type interpolation ('nearest' target for "image2" seg-like types,
  'nearest' input for "2image", bicubic for depth/pose)
  (pairdataset.py:111-124);
- no photometric aug for "inst"/"pose" types (identity-crop stacks)
  (pairdataset.py:126-132);
- a second same-type pair is sampled and stitched on top as the
  in-context prompt (pairdataset.py:136-146; sample *under* prompt);
- a second 896x448 RandomResizedCrop (ratio 0.3-0.7) on the stitched
  canvas except for inst/pose/half-mask samples (pairdataset.py:148-152);
- per-type valid maps (pairdataset.py:154-181);
- 10% of samples get the deterministic bottom-half mask, the rest the
  BEiT block mask with 784/1568 patches, max block 392
  (pairdataset.py:183-188, train script flags);
- NYUv2 depth pngs scale to 0..255 grayscale at load (pairdataset.py:91-97).

Randomness is an explicit per-sample ``np.random.Generator`` derived from
(seed, epoch, index), replacing torch global state; sampling/sharding
reproduces WeightedRandomSampler + DistributedSamplerWrapper
(``data/sampler.py``) with a seeded permutation.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from painter_tpu_torch import native as native_ops
from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD
from painter_tpu_torch.data import transforms as T
from painter_tpu_torch.data.masking import BlockMaskingGenerator

DEFAULT_TYPE_WEIGHTS = (0.1, 0.2, 0.15, 0.25, 0.2, 0.15, 0.05, 0.05)


def _normalized_threshold(raw: float) -> np.ndarray:
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (raw - mean) / std


class PairDataset:
    def __init__(self, root: str, json_path_list: Sequence[str],
                 transform=None, transform2=None, transform3=None,
                 transform_seccrop=None,
                 masking_generator: Optional[BlockMaskingGenerator] = None,
                 use_two_pairs: bool = True, half_mask_ratio: float = 0.0,
                 type_weight_list: Sequence[float] = DEFAULT_TYPE_WEIGHTS):
        self.root = root
        self.pairs: List[Dict] = []
        self.weights: List[float] = []
        for idx, json_path in enumerate(json_path_list):
            with open(json_path) as f:
                cur_pairs = json.load(f)
            self.pairs.extend(cur_pairs)
            w = type_weight_list[idx] if idx < len(type_weight_list) else 0.05
            self.weights.extend([w / max(len(cur_pairs), 1)] * len(cur_pairs))
        self.use_two_pairs = use_two_pairs
        self.pair_type_dict: Dict[str, List[int]] = {}
        if use_two_pairs:
            for idx, pair in enumerate(self.pairs):
                if "type" in pair:
                    self.pair_type_dict.setdefault(pair["type"], []).append(
                        idx)
        self.transform = transform
        self.transform2 = transform2
        self.transform3 = transform3
        self.transform_seccrop = transform_seccrop
        self.masking_generator = masking_generator
        self.half_mask_ratio = half_mask_ratio

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_image(self, path: str, max_retries: int = 5) -> Image.Image:
        # retry on flaky filesystems (pairdataset.py:81-90 retries
        # forever; bounded here so a missing file fails loudly)
        for attempt in range(max_retries):
            try:
                img = Image.open(os.path.join(self.root, path))
                break
            except OSError as e:
                if attempt == max_retries - 1:
                    raise
                print(f"Caught exception: {e}. Re-trying...")
                import time
                time.sleep(1)
        if "sync_depth" in path:
            # nyuv2 depth range 0..10m stored x1e4 -> 0..255 gray
            arr = np.asarray(img, np.float64) / 10000.0 * 255.0
            img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
        return img.convert("RGB")

    @staticmethod
    def _interpolations(pair_type: str):
        if "depth" in pair_type or "pose" in pair_type:
            return "bicubic", "bicubic"
        if "image2" in pair_type:
            return "bicubic", "nearest"
        if "2image" in pair_type:
            return "nearest", "bicubic"
        return "bicubic", "bicubic"

    def _transform_for(self, pair_type: str):
        if "inst" in pair_type and self.transform2 is not None:
            return self.transform2
        if "pose" in pair_type and self.transform3 is not None:
            return self.transform3
        return self.transform

    def get(self, index: int, rng: np.random.Generator) -> Dict:
        """One sample: {image, target, mask, valid} numpy (NHWC floats)."""
        pair = self.pairs[index]
        pair_type = pair["type"]
        interp1, interp2 = self._interpolations(pair_type)
        cur_transform = self._transform_for(pair_type)

        image = self._load_image(pair["image_path"])
        target = self._load_image(pair["target_path"])
        image, target = cur_transform(image, target, rng, interp1, interp2)

        if self.use_two_pairs:
            pair2_index = int(rng.choice(self.pair_type_dict[pair_type]))
            pair2 = self.pairs[pair2_index]
            image2 = self._load_image(pair2["image_path"])
            target2 = self._load_image(pair2["target_path"])
            image2, target2 = cur_transform(image2, target2, rng,
                                            interp1, interp2)
            # stitched: sample under the prompt (pairdataset.py:100-104)
            image = np.concatenate([image, image2], axis=0)
            target = np.concatenate([target, target2], axis=0)

        use_half_mask = rng.random() < self.half_mask_ratio
        if not (self.transform_seccrop is None or "inst" in pair_type
                or "pose" in pair_type or use_half_mask):
            image, target = self.transform_seccrop(image, target, rng,
                                                   interp1, interp2)

        valid = np.ones_like(target, np.float32)
        if "nyuv2_image2depth" in pair_type:
            thres = _normalized_threshold(1e-3 * 0.1)
            valid[target < thres] = 0.0
        elif ("ade20k_image2semantic" in pair_type
              or "coco_image2panoptic_sem_seg" in pair_type):
            thres = _normalized_threshold(1e-5)
            valid[target < thres] = 0.0
        elif "image2pose" in pair_type:
            thres = _normalized_threshold(1e-5)
            fg = target > thres
            valid[fg] = 10.0
            if fg.sum() < 100 * 3:
                valid *= 0.0
        elif "image2panoptic_inst" in pair_type:
            thres = _normalized_threshold(1e-5)
            if (target > thres).sum() < 100 * 3:
                valid *= 0.0

        if use_half_mask:
            mask = self.masking_generator.half_mask()
        else:
            mask = self.masking_generator(rng)

        # mask/valid ship as uint8: their value sets are exactly
        # {0, 1} and {0, 1, 10} (the pose fg weight above), the model
        # casts to fp32 in-graph (forward_loss / forward_encoder), and
        # the host->device feed drops from 115.6 to 86.8 MB per B=8
        # flagship batch (valid is a full (H, W, 3) map)
        return {
            "imgs": np.asarray(image, np.float32),
            "tgts": np.asarray(target, np.float32),
            "mask": mask.reshape(-1).astype(np.uint8),
            "valid": valid.astype(np.uint8),
        }


class WeightedMixtureSampler:
    """WeightedRandomSampler + DistributedSamplerWrapper semantics

    (``data/sampler.py``): per epoch, draw len(dataset) weighted indices
    with replacement, then shard across replicas on a seeded epoch
    permutation (padding to divisibility)."""

    def __init__(self, weights: Sequence[float], num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        w = np.asarray(weights, np.float64)
        self.probs = w / w.sum()
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.num_samples = -(-len(w) // num_replicas)  # ceil
        self.total = self.num_samples * num_replicas

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        drawn = rng.choice(len(self.probs), size=len(self.probs),
                           replace=True, p=self.probs)
        perm = rng.permutation(len(drawn))
        drawn = drawn[perm]
        if len(drawn) < self.total:  # pad
            drawn = np.concatenate(
                [drawn, drawn[:self.total - len(drawn)]])
        return drawn[self.rank:self.total:self.num_replicas]


def _resolve_native(native: Optional[bool]) -> bool:
    """``None`` -> ``native_ops.enabled()``; a native choice builds the
    host library now, before the sample workers spawn."""
    if native is None:
        native = native_ops.enabled()
    if native:
        native_ops.library()
    return native


def make_train_dataset(root: str, json_paths: Sequence[str],
                       img_size=(896, 448), num_mask_patches: int = 784,
                       max_mask_patches_per_block: int = 392,
                       min_mask_patches_per_block: int = 16,
                       min_random_scale: float = 0.3,
                       half_mask_ratio: float = 0.1,
                       patch_size: int = 16,
                       native: Optional[bool] = None) -> PairDataset:
    """The canonical training dataset (main_train.py:232-261). With
    ``native`` the transforms run the host C++ ops, built here, in the
    process that spawns the sample workers (a failed build raises);
    ``native=False`` runs their numpy versions; ``None`` (the default)
    is ``native_ops.enabled()``: native unless ``PAINTER_TPU_NO_NATIVE=1``."""
    native = _resolve_native(native)
    grid = (img_size[0] // patch_size, img_size[1] // patch_size)
    return PairDataset(
        root, json_paths,
        transform=T.train_transform(img_size[1], min_random_scale, native),
        transform2=T.identity_crop_transform(img_size[1], native),
        transform3=T.identity_crop_transform(img_size[1], native),
        transform_seccrop=T.seccrop_transform(img_size, min_random_scale,
                                              native),
        masking_generator=BlockMaskingGenerator(
            grid, num_masking_patches=num_mask_patches,
            max_num_patches=max_mask_patches_per_block,
            min_num_patches=min_mask_patches_per_block),
        use_two_pairs=True, half_mask_ratio=half_mask_ratio)


def make_val_dataset(root: str, json_paths: Sequence[str],
                     img_size=(896, 448), num_mask_patches: int = 784,
                     patch_size: int = 16,
                     native: Optional[bool] = None) -> PairDataset:
    """Validation: identity crop, always bottom-half mask

    (main_train.py:262, half_mask_ratio=1.0); ``native`` as in
    :func:`make_train_dataset`."""
    native = _resolve_native(native)
    grid = (img_size[0] // patch_size, img_size[1] // patch_size)
    return PairDataset(
        root, json_paths,
        transform=T.identity_crop_transform(img_size[1], native),
        masking_generator=BlockMaskingGenerator(
            grid, num_masking_patches=num_mask_patches),
        use_two_pairs=True, half_mask_ratio=1.0)


def collate(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def data_iterator(dataset: PairDataset, sampler: WeightedMixtureSampler,
                  batch_size: int, epoch: int, seed: int = 0,
                  accum_iter: int = 1, num_workers: Optional[int] = None,
                  prefetch: int = 2):
    """Yields host batches; with accum_iter > 1, leaves have a leading
    microbatch axis (matching train.step). Samples are built by a pool of
    worker processes with ``prefetch`` batches in flight (the reference's
    DataLoader(num_workers=10) role). The workers are spawned, not
    forked: the parent holds a CUDA context and torch's threads."""
    from collections import deque
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    if num_workers is None:
        # worker processes only pay off with spare cores (each sample is
        # ~14MB of IPC); single-core hosts run the serial path
        num_workers = min(8, (os.cpu_count() or 1) - 1)

    indices = sampler.epoch_indices(epoch)
    step_size = batch_size * accum_iter
    starts = list(range(0, len(indices) - step_size + 1, step_size))

    def fetch_local(start, j):
        i = int(indices[start + j])
        return dataset.get(i, np.random.default_rng(
            (seed, epoch, int(start + j), i)))

    def assemble(samples):
        batch = collate(samples)
        if accum_iter > 1:
            batch = {k: v.reshape((accum_iter, batch_size) + v.shape[1:])
                     for k, v in batch.items()}
        return batch

    if num_workers <= 1:
        for start in starts:
            yield assemble([fetch_local(start, j)
                            for j in range(step_size)])
        return

    jobs = [(int(indices[start + j]), (seed, epoch, int(start + j),
                                       int(indices[start + j])))
            for start in starts for j in range(step_size)]
    with ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(dataset,)) as pool:
        window = step_size * max(prefetch, 1)
        futs = deque(pool.submit(_worker_fetch, job)
                     for job in jobs[:window])
        next_submit = min(window, len(jobs))
        for _ in starts:
            samples = []
            for _ in range(step_size):
                samples.append(futs.popleft().result())
                if next_submit < len(jobs):
                    futs.append(pool.submit(_worker_fetch,
                                            jobs[next_submit]))
                    next_submit += 1
            yield assemble(samples)


_WORKER_DATASET: Optional[PairDataset] = None


def _worker_init(dataset: PairDataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(job):
    index, rng_key = job
    return _WORKER_DATASET.get(index, np.random.default_rng(rng_key))
