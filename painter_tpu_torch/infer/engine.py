"""In-context inference engine (SegGPT + Painter protocols), PyTorch port.

Behavioral contract from ``SegGPT/SegGPT_inference/seggpt_engine.py`` and
``Painter/eval/*/painter_inference_*.py``, as in the JAX package's
``infer/engine.py``:

- prompt and query are resized to 448^2, stacked prompt-over-query into
  896x448 and ImageNet-normalized; the target's bottom half is a copy of
  the prompt target;
- a bottom-half patch mask; several prompts form a prompt batch with the
  feature ensemble (``merge_between_batch = 0 iff num_prompts > 1``);
- the output is the painted bottom half, de-normalized, then scaled and
  resized per task (:data:`TASK_SPECS`).

The host normalizes and resizes in numpy; the model, the bottom-half
decode and the de-normalization run on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from painter_tpu_torch.device import resolve_device
from painter_tpu_torch.models import incontext_vit as model_lib
from painter_tpu_torch.ops import image as image_ops
from painter_tpu_torch.ops import quant as quant_lib
from painter_tpu_torch.ops.resample import np_resize2d


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Per-task output decoding protocol (painter_inference_*.py)."""
    name: str
    out_scale: float = 255.0
    clip: Optional[Tuple[float, float]] = (0.0, 255.0)
    resize_mode: str = "bilinear"
    channel_mean: bool = False  # depth: mean over RGB after resize


TASK_SPECS = {
    # seggpt_engine.py:48-53,97-103
    "seggpt": TaskSpec("seggpt", 255.0, (0.0, 255.0), "nearest"),
    # eval/ade20k_semantic/painter_inference_segm.py:88-91
    "ade20k_semseg": TaskSpec("ade20k_semseg", 255.0, (0.0, 255.0),
                              "bilinear"),
    # eval/coco_panoptic/painter_inference_pano_semseg.py
    "coco_semseg": TaskSpec("coco_semseg", 255.0, (0.0, 255.0), "bilinear"),
    # eval/coco_panoptic/painter_inference_pano_inst.py:89-90
    "coco_inst": TaskSpec("coco_inst", 255.0, (0.0, 255.0), "nearest"),
    # eval/mmpose_custom/painter_inference_pose.py:87-88
    "pose": TaskSpec("pose", 255.0, (0.0, 255.0), "nearest"),
    # eval/nyuv2_depth/painter_inference_depth.py:69-74
    "depth": TaskSpec("depth", 10000.0, (0.0, 10000.0), "bilinear",
                      channel_mean=True),
    # eval/{derain,sidd,lol}/painter_inference_*.py: float output, bicubic
    "restoration": TaskSpec("restoration", 1.0, None, "bicubic"),
}


def _array_digest(a: np.ndarray) -> bytes:
    """Content digest of a host array (prompt-cache key component)."""
    a = np.ascontiguousarray(a)
    h = hashlib.blake2b(a.tobytes(), digest_size=16)
    h.update(str((a.shape, a.dtype)).encode())
    return h.digest()


def _prompt_bucket(n: int) -> int:
    """Next power of two >= n: the prompt-count buckets."""
    b = 1
    while b < n:
        b *= 2
    return b


def _np_normalize(x: np.ndarray) -> np.ndarray:
    """Host-side ImageNet normalize (== ops/image.normalize)."""
    return ((np.asarray(x, np.float32) - np.asarray(IMAGENET_MEAN,
                                                    np.float32))
            / np.asarray(IMAGENET_STD, np.float32))


#: serving precisions (``seggpt_cli --quant``): "int8" quantizes the MLP
#: gemms (w8a8, ``ops.quant.quantize_model``), "int8-fused" also runs each
#: MLP through the fused int8 kernel
QUANT_MODES = ("none", "int8", "int8-fused")


def prepare_model(model: model_lib.InContextViT,
                  quant: str = "none") -> model_lib.InContextViT:
    """``model`` for serving at ``quant`` (the branch of the JAX
    ``seggpt_cli.prepare_model``); "none" returns it as it is."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    if quant == "none":
        return model
    return quant_lib.quantize_model(
        model, mlp_impl="fused" if quant == "int8-fused" else "xla")


class InContextModel:
    """A model on its device with the in-context predict paths.

    ``device`` defaults to ``cuda`` and raises when there is none; pass
    ``device="cpu"`` to run on the host. ``quant`` serves an int8 copy of
    the model (:data:`QUANT_MODES`, :func:`prepare_model`).
    """

    def __init__(self, cfg: ModelConfig, model: model_lib.InContextViT,
                 seg_type: str = "semantic", pad_prompts: bool = True,
                 device=None, quant: str = "none"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = prepare_model(model.to(self.device), quant).eval()
        self.seg_type = seg_type  # 'semantic' | 'instance' (SegGPT CLI)
        # prompt counts pad to powers of two with a weighted ensemble
        # (weight 0 on pads == the mean over the real prompts), so a
        # growing prompt set meets few distinct shapes
        self.pad_prompts = pad_prompts
        self._prompt_dev_cache = None

    def _seg_type(self, n: int) -> Optional[torch.Tensor]:
        if not self.cfg.seg_type_tokens:
            return None
        val = 1 if self.seg_type == "instance" else 0
        return torch.full((n, 1), val, dtype=torch.long, device=self.device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def run_one_image(self, img: np.ndarray, tgt: np.ndarray) -> np.ndarray:
        """img/tgt: (N, 2R, R, 3) normalized stitched batch (N prompts).

        Returns the painted bottom half (R, R, 3), de-normalized float
        (unscaled). Mirrors ``seggpt_engine.run_one_image`` (:26-53).
        """
        n = img.shape[0]
        merge = 0 if n > 1 else -1  # seggpt_engine.py:46
        weights = None
        if self.pad_prompts and n > 1:
            nb = _prompt_bucket(n)
            # 1/n on real prompts, 0 on padding; pads repeat sample 0 so
            # every intermediate stays finite
            w = np.zeros((nb,), np.float32)
            w[:n] = np.float32(1.0 / n)
            weights = self._put(w)
            if nb != n:
                img = np.concatenate(
                    [img, np.repeat(img[:1], nb - n, axis=0)])
                tgt = np.concatenate(
                    [tgt, np.repeat(tgt[:1], nb - n, axis=0)])
                n = nb
        num_patches = (img.shape[1] // self.cfg.patch_size) * \
            (img.shape[2] // self.cfg.patch_size)
        mask = image_ops.bottom_half_mask(n, num_patches, self.device)
        out = model_lib.predict_query_half(
            self.model, self._put(np.asarray(img, np.float32)),
            self._put(np.asarray(tgt, np.float32)), mask,
            seg_type=self._seg_type(n), merge_between_batch=merge,
            ensemble_weights=weights)
        return image_ops.denormalize(out).cpu().numpy()

    @torch.inference_mode()
    def run_queries(self, imgs: np.ndarray, tgts: np.ndarray,
                    real_count: Optional[int] = None) -> np.ndarray:
        """Batched independent queries (Q, 2R, R, 3) -> (Q, R, R, 3).

        Every sample is its own (prompt, query) pair. Returns
        de-normalized [0,1]-scale bottom halves of the first
        ``real_count`` samples.
        """
        n = imgs.shape[0]
        num_patches = (imgs.shape[1] // self.cfg.patch_size) * \
            (imgs.shape[2] // self.cfg.patch_size)
        mask = image_ops.bottom_half_mask(n, num_patches, self.device)
        out = model_lib.predict_query_half_batch(
            self.model, self._put(np.asarray(imgs, np.float32)),
            self._put(np.asarray(tgts, np.float32)), mask,
            seg_type=self._seg_type(n))
        out = image_ops.denormalize(out).cpu().numpy()
        return out[:real_count if real_count else n]

    @torch.inference_mode()
    def run_queries_shared(self, queries: np.ndarray, img2: np.ndarray,
                           tgt2: np.ndarray,
                           real_count: Optional[int] = None,
                           out_dtype=np.float32) -> np.ndarray:
        """Fixed-prompt batched queries (Q, R, R, 3) -> painted halves.

        Every query shares one (img2, tgt2) prompt: only the query halves
        are uploaded, and the normalized prompt halves stay cached on the
        device across calls. ``queries`` may be uint8 (the /255 runs on
        the device, bit-exact vs the host divide); ``out_dtype=np.uint8``
        returns the 0-255 write-path values instead of [0,1] float32 --
        protocol-exact only for nearest/identity-resize tasks.
        """
        # the cache HOLDS the host arrays, so the `is` checks cannot be
        # fooled by a recycled id(); the content digest catches in-place
        # edits of the cached arrays
        fp = (_array_digest(img2), _array_digest(tgt2))
        cache = self._prompt_dev_cache
        if (cache is None or cache[0] is not img2 or cache[1] is not tgt2
                or cache[2] != fp):
            tgt_pair = _np_normalize(np.concatenate([tgt2, tgt2], axis=0))
            self._prompt_dev_cache = (
                img2, tgt2, fp, self._put(_np_normalize(img2)),
                self._put(tgt_pair))
        img2_dev, tgt2_dev = self._prompt_dev_cache[3:]
        n = queries.shape[0]
        q = self._put(queries if queries.dtype == np.uint8
                      else np.asarray(queries, np.float32))
        if q.dtype == torch.uint8:
            q = image_ops.from_uint8(q)
        q = image_ops.normalize(q)
        imgs = torch.cat([img2_dev.expand(q.shape), q], dim=1)
        tgts = tgt2_dev.expand((n,) + tuple(tgt2_dev.shape))
        num_patches = (imgs.shape[1] // self.cfg.patch_size) * \
            (imgs.shape[2] // self.cfg.patch_size)
        mask = image_ops.bottom_half_mask(n, num_patches, self.device)
        out = model_lib.predict_query_half_batch(
            self.model, imgs, tgts, mask, seg_type=self._seg_type(n))
        out = image_ops.denormalize(out)
        if np.dtype(out_dtype) == np.uint8:
            out = image_ops.to_uint8_255(out)
        return out.cpu().numpy()[:real_count if real_count else n]


def scale_and_resize(output: np.ndarray, size_wh: Tuple[int, int],
                     spec: TaskSpec) -> np.ndarray:
    """De-normalized bottom half -> task output at the original size."""
    out = np.asarray(output, np.float32) * spec.out_scale
    if spec.clip is not None:
        out = np.clip(out, spec.clip[0], spec.clip[1])
    out = np_resize2d(out, (size_wh[1], size_wh[0]), spec.resize_mode)
    if spec.channel_mean:
        out = out.mean(axis=-1)
    return out


def build_prompt_batch(query: np.ndarray,
                       prompts: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """query (R,R,3) [0,1]; prompts: [(img2, tgt2)] -> normalized batch."""
    imgs, tgts = [], []
    for img2, tgt2 in prompts:
        imgs.append(_np_normalize(np.concatenate([img2, query], axis=0)))
        tgts.append(_np_normalize(np.concatenate([tgt2, tgt2], axis=0)))
    return np.stack(imgs), np.stack(tgts)


def build_query_batch(queries: Sequence[np.ndarray], img2: np.ndarray,
                      tgt2: np.ndarray):
    """Independent queries sharing one prompt -> stacked normalized
    (Q, 2R, R, 3) input/target batches for :meth:`run_queries`."""
    tgt = _np_normalize(np.concatenate([tgt2, tgt2], axis=0))
    imgs = [_np_normalize(np.concatenate([img2, q], axis=0))
            for q in queries]
    return np.stack(imgs), np.broadcast_to(
        tgt, (len(imgs),) + tgt.shape).copy()
