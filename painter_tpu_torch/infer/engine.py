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
  resized per task (:data:`TASK_SPECS`);
- video: a rolling cache of recent frames and their binarized
  predictions serves as extra prompts, so each frame's painting depends
  on the frames before it (``seggpt_engine.py:106-181``).

The host normalizes and resizes in numpy; the model, the bottom-half
decode and the de-normalization run on the device. :class:`VideoEngine`
keeps its prompt cache on the device and runs the normalize, stitch,
binarization and cache insert there too. The file drivers
(:func:`inference_image`, :func:`inference_video`,
:func:`painter_task_inference`) read and write with PIL (and cv2 for
video, imported only there).
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

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


def _ensemble_weights(n: int, nb: int) -> np.ndarray:
    """Feature-ensemble weights of ``n`` real rows in a bucket of ``nb``:
    1/n on each real row, 0 on the pads (== the mean over the real rows)."""
    w = np.zeros((nb,), np.float32)
    w[:n] = np.float32(1.0 / n)
    return w


def _np_normalize(x: np.ndarray) -> np.ndarray:
    """Host-side ImageNet normalize (== ops/image.normalize)."""
    return ((np.asarray(x, np.float32) - np.asarray(IMAGENET_MEAN,
                                                    np.float32))
            / np.asarray(IMAGENET_STD, np.float32))


#: serving precisions (``seggpt_cli --quant``): "int8" quantizes the MLP
#: gemms (w8a8, ``ops.quant.quantize_model``), "int8-fused" also runs each
#: MLP through the fused int8 kernel
QUANT_MODES = ("none", "int8", "int8-fused")

#: attention routes of the serving forward: "kernel" runs the CUDA
#: attention kernel on the card (its plain version on the CPU), "plain"
#: the plain attention on any device (for a grid the kernel refuses)
ATTN_IMPLS = ("kernel", "plain")


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
    the model (:data:`QUANT_MODES`, :func:`prepare_model`); ``attn_impl``
    picks the attention route of every forward (:data:`ATTN_IMPLS`).

    ``mesh`` makes the batched paths (:meth:`run_queries`,
    :meth:`run_queries_shared`) data-parallel, as the JAX engine's
    ``mesh``; a ragged batch is padded to a multiple of the dp size by
    repeating row 0, and each dp rank paints its block of rows:

    - a sequence of devices (one process; ``["cuda:0", "cuda:1"]``, or a
      device named twice): one replica of the model per device, the row
      blocks' forwards all issued before any output is fetched, the
      prompt cache replicated on every device. ``device`` is the first;
    - a ``DeviceMesh`` with a ``dp`` dim (one device per process, as JAX's
      ``_multiproc``): every rank is given the full host batch, paints its
      own rows on ``device`` (default: the mesh's ``device_type``, which
      raises when that is ``cuda`` and there is no card) and all-gathers
      the output to every rank.

    ``run_one_image``, the video caches and the endpoint stay on one
    device: only the batched paths are data-parallel.
    """

    def __init__(self, cfg: ModelConfig, model: model_lib.InContextViT,
                 attn_impl: str = "kernel", seg_type: str = "semantic",
                 pad_prompts: bool = True, device=None, quant: str = "none",
                 mesh=None):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.mesh = mesh
        self._multiproc = mesh is not None and not isinstance(
            mesh, (list, tuple))
        if self._multiproc:
            if device is None:
                device = mesh.device_type
            self.n_dp = mesh["dp"].size()
            self._dp_rank = mesh.get_local_rank("dp")
        elif mesh is not None:
            if not len(mesh):
                raise ValueError("mesh must name at least one device")
            device = mesh[0]
            self.n_dp = len(mesh)
        else:
            self.n_dp = 1
        self.device = resolve_device(device)
        self.model = prepare_model(model.to(self.device), quant).eval()
        # the (device, model) replica of each dp row block on this
        # process; a device named twice serves both blocks from one copy
        self._replicas = [(self.device, self.model)]
        if mesh is not None and not self._multiproc:
            copies = {self.device: self.model}
            for d in mesh[1:]:
                d = resolve_device(d)
                if d not in copies:
                    copies[d] = copy.deepcopy(self.model).to(d)
                self._replicas.append((d, copies[d]))
        self.seg_type = seg_type  # 'semantic' | 'instance' (SegGPT CLI)
        # prompt counts pad to powers of two with a weighted ensemble
        # (weight 0 on pads == the mean over the real prompts), so a
        # growing prompt set meets few distinct shapes
        self.pad_prompts = pad_prompts
        self._prompt_dev_cache = None

    def _seg_type(self, n: int, device=None) -> Optional[torch.Tensor]:
        if not self.cfg.seg_type_tokens:
            return None
        val = 1 if self.seg_type == "instance" else 0
        return torch.full((n, 1), val, dtype=torch.long,
                          device=device or self.device)

    def _put(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device or self.device)

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
            # pads repeat sample 0 so every intermediate stays finite
            weights = self._put(_ensemble_weights(n, nb))
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
            ensemble_weights=weights, attn_impl=self.attn_impl)
        return image_ops.denormalize(out).cpu().numpy()

    def _pad_dp(self, *arrays: np.ndarray):
        """Pad the rows to a multiple of the dp size by repeating row 0
        (the JAX engine's ragged-batch padding)."""
        pad = -arrays[0].shape[0] % self.n_dp
        if not pad:
            return arrays
        return tuple(np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                     for a in arrays)

    def _dp_run(self, paint, n: int) -> np.ndarray:
        """``paint(device, model, rows)`` on every row
        block of a padded batch of ``n`` -> the whole output on the host.
        One process: every block's launches go out before any fetch.
        Across processes: this rank's block, all-gathered."""
        per = n // self.n_dp
        if self._multiproc:
            import torch.distributed as dist
            r = self._dp_rank
            out = paint(self.device, self.model,
                        slice(r * per, (r + 1) * per)).contiguous()
            parts = [torch.empty_like(out) for _ in range(self.n_dp)]
            dist.all_gather(parts, out, group=self.mesh.get_group("dp"))
            return torch.cat(parts).cpu().numpy()
        outs = [paint(dev, model, slice(i * per, (i + 1) * per))
                for i, (dev, model) in enumerate(self._replicas)]
        return np.concatenate([o.cpu().numpy() for o in outs])

    @torch.inference_mode()
    def run_queries(self, imgs: np.ndarray, tgts: np.ndarray,
                    real_count: Optional[int] = None) -> np.ndarray:
        """Batched independent queries (Q, 2R, R, 3) -> (Q, R, R, 3).

        Every sample is its own (prompt, query) pair. Returns
        de-normalized [0,1]-scale bottom halves of the first
        ``real_count`` samples.
        """
        q = imgs.shape[0]
        imgs, tgts = self._pad_dp(imgs, tgts)
        num_patches = (imgs.shape[1] // self.cfg.patch_size) * \
            (imgs.shape[2] // self.cfg.patch_size)

        def paint(device, model, rows):
            im = imgs[rows]
            b = im.shape[0]
            out = model_lib.predict_query_half_batch(
                model, self._put(np.asarray(im, np.float32), device),
                self._put(np.asarray(tgts[rows], np.float32), device),
                image_ops.bottom_half_mask(b, num_patches, device),
                seg_type=self._seg_type(b, device),
                attn_impl=self.attn_impl)
            return image_ops.denormalize(out)

        out = self._dp_run(paint, imgs.shape[0])
        return out[:real_count if real_count else q]

    def _prompt_cache(self, img2: np.ndarray, tgt2: np.ndarray) -> dict:
        """device -> the normalized prompt halves on it, cached across
        calls while the prompt arrays stay the same."""
        # the cache HOLDS the host arrays, so the `is` checks cannot be
        # fooled by a recycled id(); the content digest catches in-place
        # edits of the cached arrays
        fp = (_array_digest(img2), _array_digest(tgt2))
        cache = self._prompt_dev_cache
        if (cache is None or cache[0] is not img2 or cache[1] is not tgt2
                or cache[2] != fp):
            cache = self._prompt_dev_cache = (img2, tgt2, fp, {})
        return cache[3]

    def _prompt_on(self, by_device: dict, img2: np.ndarray,
                   tgt2: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
        if device not in by_device:
            tgt_pair = _np_normalize(np.concatenate([tgt2, tgt2], axis=0))
            by_device[device] = (self._put(_np_normalize(img2), device),
                                 self._put(tgt_pair, device))
        return by_device[device]

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
        q_total = queries.shape[0]
        (queries,) = self._pad_dp(queries)
        by_device = self._prompt_cache(img2, tgt2)
        u8_out = np.dtype(out_dtype) == np.uint8

        def paint(device, model, rows):
            img2_dev, tgt2_dev = self._prompt_on(by_device, img2, tgt2,
                                                 device)
            qh = queries[rows]
            n = qh.shape[0]
            q = self._put(qh if qh.dtype == np.uint8
                          else np.asarray(qh, np.float32), device)
            if q.dtype == torch.uint8:
                q = image_ops.from_uint8(q)
            q = image_ops.normalize(q)
            imgs = torch.cat([img2_dev.expand(q.shape), q], dim=1)
            tgts = tgt2_dev.expand((n,) + tuple(tgt2_dev.shape))
            num_patches = (imgs.shape[1] // self.cfg.patch_size) * \
                (imgs.shape[2] // self.cfg.patch_size)
            mask = image_ops.bottom_half_mask(n, num_patches, device)
            out = model_lib.predict_query_half_batch(
                model, imgs, tgts, mask, seg_type=self._seg_type(n, device),
                attn_impl=self.attn_impl)
            out = image_ops.denormalize(out)
            return image_ops.to_uint8_255(out) if u8_out else out

        out = self._dp_run(paint, queries.shape[0])
        return out[:real_count if real_count else q_total]


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


# ---------------------------------------------------------------------------
# File drivers (PIL / cv2 I/O of the reference protocols)
# ---------------------------------------------------------------------------

def _load_rgb(path: str, res: int, nearest: bool = False) -> np.ndarray:
    """Image file -> (res, res, 3) [0,1] float64; PIL's default resample,
    NEAREST for SegGPT's targets."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    img = img.resize((res, res), Image.NEAREST if nearest else None)
    return np.array(img) / 255.0


def _composite(input_image: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The reference's blend of the x255 mask over the input
    (``seggpt_engine.py:100``)."""
    return (input_image * (0.6 * out / 255 + 0.4)).astype(np.uint8)


def inference_image(model: InContextModel, img_path: str,
                    img2_paths: Sequence[str], tgt2_paths: Sequence[str],
                    out_path: str, res: int = 448) -> np.ndarray:
    """SegGPT single-image driver (``seggpt_engine.py:56-103``): returns
    the x255 output at the input's size and writes the composite PNG to
    ``out_path`` (when given)."""
    from PIL import Image
    image = Image.open(img_path).convert("RGB")
    input_image = np.array(image)
    size = image.size
    query = np.array(image.resize((res, res))) / 255.0

    prompts = [(_load_rgb(p, res), _load_rgb(t, res, nearest=True))
               for p, t in zip(img2_paths, tgt2_paths)]
    imgs, tgts = build_prompt_batch(query, prompts)
    output = model.run_one_image(imgs, tgts)
    output = scale_and_resize(output, size, TASK_SPECS["seggpt"])
    if out_path:
        Image.fromarray(_composite(input_image, output)).save(out_path)
    return output


def run_video_frames(model: InContextModel, frames_rgb: Iterable[np.ndarray],
                     tgt2: np.ndarray, num_frames: int,
                     img2: Optional[np.ndarray] = None,
                     res: int = 448) -> Iterator[np.ndarray]:
    """Rolling-prompt-cache video loop over in-memory uint8 RGB frames,
    the prompt cache on the host (``seggpt_engine.py:106-181``).

    Each frame's ensemble batch is (img2, tgt2) and the ``num_frames``
    most recent frames with their binarized predictions, oldest first.
    With ``img2=None`` the first frame is the prompt image and is not
    painted. Yields one uint8 RGB composite per painted frame.
    """
    from PIL import Image

    frames_cache: List[np.ndarray] = []
    targets_cache: List[np.ndarray] = []
    for input_image in frames_rgb:
        if img2 is None:
            img2 = np.array(Image.fromarray(input_image)
                            .resize((res, res))) / 255.0
            continue
        image = Image.fromarray(input_image)
        size = image.size
        query = np.array(image.resize((res, res))) / 255.0

        prompts = list(zip([img2] + frames_cache, [tgt2] + targets_cache))
        imgs, tgts = build_prompt_batch(query, prompts)
        output = model.run_one_image(imgs, tgts)

        if num_frames > 0:
            frames_cache.append(query)
            # the reference's math (seggpt_engine.py:52 + :167-171): clip
            # the x255 output per channel, channel mean, > 128 (128/255 is
            # not 0.5)
            binarized = (np.clip(output * 255.0, 0, 255).mean(-1) > 128) \
                .astype(np.float32)
            targets_cache.append(np.repeat(binarized[..., None], 3, axis=-1))
            if len(frames_cache) > num_frames:
                frames_cache.pop(0)
                targets_cache.pop(0)

        out = scale_and_resize(output, size, TASK_SPECS["seggpt"])
        yield _composite(input_image, out)


def _binarize(out: torch.Tensor) -> torch.Tensor:
    """:func:`run_video_frames`' re-prompt mask on the device, bit for
    bit (``clip(out * 255, 0, 255).mean(-1) > 128``): numpy's float32
    channel mean sums (c0 + c1) + c2 and divides; a divisor held as a
    tensor keeps the division a true one (CUDA multiplies by the
    reciprocal of a Python scalar divisor)."""
    c = torch.clamp(out * 255.0, 0.0, 255.0)
    mean = (c[..., 0] + c[..., 1] + c[..., 2]) / torch.tensor(
        3.0, dtype=c.dtype, device=c.device)
    return mean > 128


class VideoEngine:
    """Device-resident rolling-prompt-cache video engine.

    :func:`run_video_frames` rebuilds and uploads the whole (bucket, 2R,
    R, 3) fp32 ensemble batch for every frame. This engine keeps the
    normalized prompt halves on the device as (bucket, R, R, 3) fp32
    tensors and uploads only each frame's query (raw uint8 or [0,1]
    float); the /255, normalize, stitch, forward, de-normalize, the
    re-prompt binarization and the cache insert run on the device.

    Semantics of :func:`run_video_frames`: row 0 is the fixed (img2,
    tgt2) prompt; rows 1..num_frames hold the most recent frames and
    their binarized predictions. Once the cache is full a new frame
    overwrites the oldest row in place (circular, FIFO); the weighted
    feature ensemble does not depend on the row order but for fp32
    summation order. Row counts pad to power-of-two buckets by repeating
    row 0 at ensemble weight 0, so pad content cannot matter.
    """

    @torch.inference_mode()
    def __init__(self, model: InContextModel, num_frames: int,
                 img2: np.ndarray, tgt2: np.ndarray):
        self.model = model
        self.num_frames = num_frames
        self._imgs_top = model._put(_np_normalize(img2))[None]
        self._tgts_half = model._put(_np_normalize(tgt2))[None]
        self._n_real = 1
        self._wrap = 0  # circular insert pointer once the cache is full

    @property
    def bucket(self) -> int:
        """Rows of the cache tensors (a power of two)."""
        return self._imgs_top.shape[0]

    @torch.inference_mode()
    def paint_frame(self, query: np.ndarray,
                    out_dtype=np.float32) -> np.ndarray:
        """(R, R, 3) query -> painted (R, R, 3).

        ``query`` is [0,1] float or raw uint8 pixels (the /255 runs on the
        device, bit-exact vs the host divide). ``out_dtype=np.uint8``
        returns the 0-255 write-path values (:func:`ops.image.to_uint8_255`)
        instead of the [0,1] float32 default.
        """
        model = self.model
        n, nb = self._n_real, self.bucket
        weights = model._put(_ensemble_weights(n, nb)) if n > 1 else None
        q = model._put(query if query.dtype == np.uint8
                       else np.asarray(query, np.float32))
        if q.dtype == torch.uint8:
            q = image_ops.from_uint8(q)
        q = image_ops.normalize(q)
        imgs = torch.cat([self._imgs_top, q.expand(self._imgs_top.shape)],
                         dim=1)
        tgts = torch.cat([self._tgts_half, self._tgts_half], dim=1)
        num_patches = (imgs.shape[1] // model.cfg.patch_size) * \
            (imgs.shape[2] // model.cfg.patch_size)
        mask = image_ops.bottom_half_mask(nb, num_patches, model.device)
        out = model_lib.predict_query_half(
            model.model, imgs, tgts, mask, seg_type=model._seg_type(nb),
            merge_between_batch=0 if n > 1 else -1,
            ensemble_weights=weights, attn_impl=model.attn_impl)
        out = image_ops.denormalize(out)

        if self.num_frames > 0:
            if n < 1 + self.num_frames:
                pos = n
                self._n_real = n + 1
                if pos >= nb:  # grow to the next bucket, pads = row 0
                    grow = _prompt_bucket(pos + 1) - nb
                    self._imgs_top = torch.cat(
                        [self._imgs_top,
                         self._imgs_top[:1].expand(grow, -1, -1, -1)])
                    self._tgts_half = torch.cat(
                        [self._tgts_half,
                         self._tgts_half[:1].expand(grow, -1, -1, -1)])
            else:  # full: overwrite the oldest cached frame
                pos = 1 + self._wrap
                self._wrap = (self._wrap + 1) % self.num_frames
            self._imgs_top[pos] = q
            self._tgts_half[pos] = image_ops.normalize(
                _binarize(out).float()[..., None].expand(-1, -1, 3))
        if np.dtype(out_dtype) == np.uint8:
            out = image_ops.to_uint8_255(out)
        return out.cpu().numpy()


def run_video_frames_device(model: InContextModel,
                            frames_rgb: Iterable[np.ndarray],
                            tgt2: np.ndarray, num_frames: int,
                            img2: Optional[np.ndarray] = None,
                            res: int = 448) -> Iterator[np.ndarray]:
    """:func:`run_video_frames` on a :class:`VideoEngine` (the prompt
    cache on the device); yields the same uint8 composites."""
    from PIL import Image

    engine = None
    for input_image in frames_rgb:
        if img2 is None:
            img2 = np.array(Image.fromarray(input_image)
                            .resize((res, res))) / 255.0
            continue
        if engine is None:
            engine = VideoEngine(model, num_frames, img2, tgt2)
        image = Image.fromarray(input_image)
        size = image.size
        output = engine.paint_frame(np.array(image.resize((res, res))))
        out = scale_and_resize(output, size, TASK_SPECS["seggpt"])
        yield _composite(input_image, out)


def inference_video(model: InContextModel, vid_path: str, num_frames: int,
                    img2_paths: Optional[Sequence[str]],
                    tgt2_paths: Sequence[str], out_path: str,
                    res: int = 448, cache_impl: str = "device") -> int:
    """SegGPT video driver with the rolling prompt cache
    (``seggpt_engine.py:106-181``): reads ``vid_path`` with cv2 and writes
    the composites as mp4v to ``out_path``; returns the frames written.
    ``cache_impl`` "device" runs :class:`VideoEngine`, "host"
    :func:`run_video_frames`."""
    import cv2

    if cache_impl not in ("device", "host"):
        raise ValueError(f"cache_impl must be 'device' or 'host', got "
                         f"{cache_impl!r}")
    cap = cv2.VideoCapture(vid_path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height), True)

    def frames():
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield np.ascontiguousarray(frame[:, :, ::-1])  # BGR -> RGB

    img2 = None if img2_paths is None else _load_rgb(img2_paths[0], res)
    tgt2 = _load_rgb(tgt2_paths[0], res, nearest=True)
    runner = run_video_frames_device if cache_impl == "device" \
        else run_video_frames
    n_written = 0
    try:
        for composite in runner(model, frames(), tgt2, num_frames,
                                img2=img2, res=res):
            writer.write(np.ascontiguousarray(composite[:, :, ::-1]))
            n_written += 1
    finally:
        writer.release()
        cap.release()
    return n_written


def painter_task_inference(model: InContextModel, img_path: str,
                           prompt_img_path: str, prompt_tgt_path: str,
                           task: str, res: int = 448) -> np.ndarray:
    """Painter per-task driver (the fixed-prompt ``painter_inference_*.py``
    loops): the task's output at the query's size (:data:`TASK_SPECS`)."""
    from PIL import Image
    image = Image.open(img_path).convert("RGB")
    size = image.size
    query = np.array(image.resize((res, res))) / 255.0
    # Painter resizes the prompt target with PIL's default (bicubic), not
    # SegGPT's NEAREST (painter_inference_segm.py:138-141)
    img2 = _load_rgb(prompt_img_path, res)
    tgt2 = _load_rgb(prompt_tgt_path, res)
    imgs, tgts = build_prompt_batch(query, [(img2, tgt2)])
    output = model.run_one_image(imgs, tgts)
    return scale_and_resize(output, size, TASK_SPECS[task])
