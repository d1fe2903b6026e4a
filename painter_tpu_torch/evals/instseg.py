"""Class-agnostic instance decoding from position-coded colors, PyTorch
port of the JAX package's ``evals/instseg.py``.

Behavioral contract from
``eval/coco_panoptic/COCOCAInstSegEvaluatorCustom.py:252-354``
(threshold variant, the one used for the published PQ): for each of the
6400 position colors, candidate mask = pixels with mean-channel L1
distance < dist_thr; score = 1 - normalized mean in-mask distance
("maskness"); top-2000 by maskness, matrix NMS (gaussian, sigma 2),
top-100 by decayed score.

Layout: every per-pixel quantity depends on the pixel's color alone, so
the decode works on the image's distinct colors (with their pixel counts)
and gathers per-pixel masks back from them. One loop over 800-color
palette chunks on the device returns only the (6400,)-sized per-color
stats (the chunk bounds the live (chunk, colors) distance tensor, as the
reference's chunked GPU loop does at :282); the candidate masks are
regenerated on the device for the kept colors only; the matrix NMS runs
on them, weighted by the colors' pixel counts and padded to a
power-of-two count (the same padding as the JAX package, so the same
candidates meet the NMS), its top-k on the device, and only the final
top-``max_num`` masks are expanded to pixels and cross to the host.

Order: the in-mask distance sums run in float64, which holds the exact
sum of the fp32 distances (times their integer pixel counts) at the
protocols' sizes, so the maskness, and with it the candidate order, does
not depend on the order a device sums in. The top-k is a stable
descending sort: ``lax.top_k`` puts the lower index first on ties, and
``torch.topk`` does not promise that.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from painter_tpu_torch.device import resolve_device
from painter_tpu_torch.ops.nms import matrix_nms_scores
from painter_tpu_torch.ops.palette import coco_instance_palette

# sentinel pad color: sum-L1 distance >= ~3e6 to any uint8 pixel, so it
# can never pass a threshold or win a nearest-color assignment
_PAD_COLOR = 1.0e6


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _pad_palette(palette: np.ndarray, multiple: int) -> np.ndarray:
    padk = -len(palette) % multiple
    if not padk:
        return palette
    return np.concatenate(
        [palette, np.full((padk, 3), _PAD_COLOR, np.float32)])


def _l1(points: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """(P, 3) x (K, 3) -> (K, P) sum-L1 distances, channel by channel
    (no (K, P, 3) temporary)."""
    dist = (points[None, :, 0] - colors[:, 0, None]).abs_()
    for c in (1, 2):
        dist += (points[None, :, c] - colors[:, c, None]).abs_()
    return dist


def _distinct_colors(segm: torch.Tensor):
    """(H, W, 3) -> (colors (U, 3), inverse (H*W,), counts (U,)): every
    per-pixel quantity here depends on the pixel's color alone, so it is
    computed once per distinct color and gathered back."""
    return torch.unique(segm.reshape(-1, 3), dim=0, return_inverse=True,
                        return_counts=True)


def _palette_stats(colors: torch.Tensor, counts: torch.Tensor,
                   palette: torch.Tensor, dist_thr: float,
                   colors_per_chunk: int):
    """Distinct colors (U, 3) with pixel counts (U,) x palette (K, 3) ->
    per palette color (num_pos (K,), maskness_neg (K,))."""
    nums, negs = [], []
    for chunk in palette.split(colors_per_chunk):
        dist = _l1(colors, chunk) / 3.0
        mask = dist < dist_thr
        num_pos = torch.where(mask, counts, 0).sum(1)
        total = torch.where(mask, dist.double() * counts, 0.0).sum(1)
        nums.append(num_pos)
        negs.append(total.float() / num_pos.clamp(min=1).float())
    return torch.cat(nums), torch.cat(negs)


def _masks_for(colors: torch.Tensor, cand: torch.Tensor,
               dist_thr: float) -> torch.Tensor:
    """Candidate masks over the distinct colors, (K, U) bool, for an
    explicit candidate color list."""
    return _l1(colors, cand) / 3.0 < dist_thr


def _nms_topk(masks: torch.Tensor, counts: torch.Tensor,
              scores: torch.Tensor, kernel: str, sigma: float,
              max_num: int):
    """Matrix-NMS decay + top-k, on the device; masks (N, U) bool over
    the distinct colors, ``counts`` their pixel counts."""
    labels = torch.ones(masks.shape[0], dtype=torch.int32,
                        device=masks.device)
    decayed = matrix_nms_scores(masks, labels, scores, kernel=kernel,
                                sigma=sigma, weights=counts)
    top_idx = torch.argsort(decayed, descending=True, stable=True)[
        :min(max_num, masks.shape[0])]
    return masks[top_idx], decayed[top_idx]


def decode_instances(segm: np.ndarray,
                     dist_thr_list: Sequence[float] = (19.0,),
                     topk_pre: int = 2000, max_num: int = 100,
                     keep_all: bool = False,
                     colors_per_chunk: int = 800,
                     return_device: bool = False,
                     device=None) -> Dict[str, np.ndarray]:
    """(H, W, 3) painted prediction -> {'masks' (N,H,W), 'scores' (N,)}.

    Runs on ``device`` (default ``cuda``). ``return_device=True`` also
    returns the top masks as a tensor on the device ('masks_dev'), so a
    consumer on the device (the panoptic class vote) skips a host round
    trip of the mask stack.
    """
    dev = resolve_device(device)
    full_palette = coco_instance_palette()[:-1].astype(np.float32)
    colors, inverse, counts = _distinct_colors(
        torch.from_numpy(np.asarray(segm, np.float32)).to(dev))
    h, w = segm.shape[:2]

    # Pass 1 (one sweep per threshold): per-color stats only.
    cand_neg: List[float] = []
    cand_color: List[np.ndarray] = []
    cand_thr: List[float] = []
    pal = torch.from_numpy(_pad_palette(full_palette,
                                        colors_per_chunk)).to(dev)
    for dist_thr in dist_thr_list:
        num_pos, neg = _palette_stats(colors, counts, pal, float(dist_thr),
                                      colors_per_chunk)
        k = len(full_palette)
        num_pos = num_pos.cpu().numpy()[:k]
        neg = neg.cpu().numpy()[:k]
        kept = np.nonzero(num_pos > 0)[0]
        cand_neg.extend(neg[kept].tolist())
        cand_color.extend(full_palette[kept])
        cand_thr.extend([float(dist_thr)] * len(kept))

    if not cand_neg:
        out = {"masks": np.zeros((1, h, w), np.float32),
               "scores": np.zeros(1, np.float32)}
        if return_device:
            out["masks_dev"] = torch.zeros((1, h, w), dtype=torch.float32,
                                           device=dev)
        return out

    neg = np.asarray(cand_neg, np.float32)
    order = np.argsort(neg, kind="stable")[:topk_pre]
    neg = neg[order]
    scores = 1.0 - neg / max(float(neg.max()), 1.0)

    # Pass 2: regenerate the kept masks on the device (per threshold
    # group, preserving the maskness order).
    def masks_for_group(thr: float, idxs: np.ndarray) -> torch.Tensor:
        cand = np.stack([cand_color[i] for i in idxs])
        return _masks_for(colors, torch.from_numpy(cand).to(dev), float(thr))

    def per_pixel(m: torch.Tensor) -> torch.Tensor:
        return m[:, inverse].reshape(len(m), h, w)

    if len(dist_thr_list) == 1:
        cand_masks = masks_for_group(dist_thr_list[0], order)
    else:
        parts, pos_in_cat, off = [], {}, 0
        for thr in dist_thr_list:
            sel = [int(i) for i in order if cand_thr[i] == thr]
            if sel:
                parts.append(masks_for_group(thr, np.asarray(sel)))
                for j, i in enumerate(sel):
                    pos_in_cat[i] = off + j
                off += len(sel)
        # restore the global maskness order across threshold groups
        gather = torch.tensor([pos_in_cat[int(i)] for i in order],
                              device=dev)
        cand_masks = torch.cat(parts)[gather]

    if keep_all:
        masks_dev = per_pixel(cand_masks)
        out = {"masks": masks_dev.cpu().numpy().astype(np.float32),
               "scores": scores}
        if return_device:
            out["masks_dev"] = masks_dev
        return out

    # Pass 3: NMS + top-k on the device at a bucketed candidate count.
    n = len(order)
    nb = _bucket(n)
    if nb != n:
        cand_masks = torch.cat([cand_masks, cand_masks.new_zeros(
            (nb - n, cand_masks.shape[1]))])
    scores_dev = torch.zeros((nb,), dtype=torch.float32, device=dev)
    scores_dev[:n] = torch.from_numpy(scores).to(dev)
    top_masks, top_scores = _nms_topk(cand_masks, counts, scores_dev,
                                      "gaussian", 2.0, max_num)
    keep = min(max_num, n)
    top_masks = per_pixel(top_masks[:keep])
    out = {"masks": top_masks.cpu().numpy().astype(np.float32),
           "scores": top_scores[:keep].cpu().numpy()}
    if return_device:
        out["masks_dev"] = top_masks
    return out


def _minmax_assign(colors: torch.Tensor, palette: torch.Tensor,
                   colors_per_chunk: int):
    """Nearest palette color of each distinct color (U, 3) (sum-L1; the
    first one on ties)."""
    best_d = torch.full(colors.shape[:1], float("inf"), device=colors.device)
    best_i = torch.zeros(colors.shape[:1], dtype=torch.int32,
                         device=colors.device)
    for ci, chunk in enumerate(palette.split(colors_per_chunk)):
        dist = _l1(colors, chunk)
        k_min = dist.argmin(0).to(torch.int32)
        d_min = dist.amin(0)
        upd = d_min < best_d
        best_d = torch.where(upd, d_min, best_d)
        best_i = torch.where(upd, k_min + ci * colors_per_chunk, best_i)
    return best_d, best_i


def decode_instances_minmax(segm: np.ndarray,
                            colors_per_chunk: int = 800,
                            device=None) -> Dict[str, np.ndarray]:
    """Min-max decode variant (COCOCAInstSegEvaluatorCustom.py:172-250):

    every pixel is assigned its nearest palette color (sum-L1, including
    the background black entry) on ``device`` (default ``cuda``); each
    occupied color becomes one mask; score = 1 - mean in-mask distance /
    max; masks decoded as background get class 0 ('bg class will be
    ignored in eval'), others class 1. Returns {'masks', 'scores',
    'classes'}.
    """
    dev = resolve_device(device)
    palette = coco_instance_palette().astype(np.float32)  # incl. bg last
    pal = _pad_palette(palette, colors_per_chunk)
    colors, inverse, _ = _distinct_colors(
        torch.from_numpy(np.asarray(segm, np.float32)).to(dev))
    best_d, best_i = _minmax_assign(colors, torch.from_numpy(pal).to(dev),
                                    colors_per_chunk)
    best_dist = best_d[inverse].reshape(segm.shape[:2]).cpu().numpy()
    best_idx = best_i[inverse].reshape(segm.shape[:2]).cpu().numpy()

    masks, neg, classes = [], [], []
    for cat in np.unique(best_idx):
        mask = best_idx == cat
        masks.append(mask)
        neg.append(float(best_dist[mask].mean()))
        classes.append(0 if cat == len(palette) - 1 else 1)
    neg = np.asarray(neg, np.float32)
    scores = 1.0 - neg / max(float(neg.max()), 1.0)
    return {"masks": np.stack(masks).astype(np.float32),
            "scores": scores.astype(np.float32),
            "classes": np.asarray(classes, np.int32)}
