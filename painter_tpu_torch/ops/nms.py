"""Matrix NMS (SOLOv2), PyTorch port of the JAX package's ``ops/nms.py``.

The reference is the pure-torch ``Painter/util/matrix_nms.py:5-121``:
decay each score by the pairwise mask IoU with a gaussian or linear
kernel. :func:`matrix_nms_scores` runs on the device of its tensors with
fixed shapes (masking instead of filtering); :func:`mask_matrix_nms` is
the reference-compatible host driver around it, with the filter and the
top-k on the host.

The intersection product of per-pixel masks stays fp32: its 0/1
operands are exact even where TF32 is allowed, and its counts (at most
H·W) are exact in the fp32 accumulator, so every device gives the same
intersections.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from painter_tpu_torch.device import resolve_device


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls in full fp32 inside the block: TF32 off, and the
    process's setting restored after it."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def matrix_nms_scores(masks: torch.Tensor, labels: torch.Tensor,
                      scores: torch.Tensor, kernel: str = "gaussian",
                      sigma: float = 2.0,
                      mask_area: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Decayed scores, in the input's order.

    masks: (N, H, W) binary; labels: (N,); scores: (N,) float32.
    Equivalent to the reference with nms_pre/max_num disabled; callers
    sort and filter afterwards (matrix_nms.py:53-121).

    ``weights`` (P,) integer counts make ``masks`` (N, P) masks over P
    groups of pixels, group p standing for ``weights[p]`` pixels (the
    instance decode's distinct colors). The weighted intersections are
    integers of at most H·W < 2^24, exact in fp32 with TF32 off, so they
    equal the per-pixel ones.
    """
    n = masks.shape[0]
    if n == 0:
        return scores
    if weights is None:
        flat = masks.reshape(n, -1).float()
        inter = flat @ flat.T
        area = flat.sum(-1)
    else:
        flat = masks.reshape(n, -1).float()
        weighted = flat * weights.float()
        with no_tf32():
            inter = weighted @ flat.T
        area = weighted.sum(-1)
    if mask_area is None:
        mask_area = area
    # the reference works on score-sorted masks; replicate via argsort
    order = torch.argsort(-scores, stable=True)
    inv_order = torch.argsort(order, stable=True)
    inter = inter[order][:, order]
    area = mask_area[order]
    lab = labels[order]
    sc = scores[order]

    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union, 0.0)
    triu = torch.ones((n, n), dtype=torch.bool,
                      device=masks.device).triu(1)
    iou = torch.where(triu, iou, 0.0)
    label_match = triu & (lab[:, None] == lab[None, :])
    decay_iou = torch.where(label_match, iou, 0.0)

    compensate = decay_iou.max(0).values[:, None]   # per column, over rows
    if kernel == "gaussian":
        decay = torch.exp(-sigma * decay_iou ** 2) / \
            torch.exp(-sigma * compensate ** 2)
    elif kernel == "linear":
        decay = (1.0 - decay_iou) / (1.0 - compensate)
    else:
        raise ValueError(kernel)
    coeff = decay.min(0).values
    return (sc * coeff)[inv_order]


def mask_matrix_nms(masks: np.ndarray, labels: np.ndarray,
                    scores: np.ndarray, filter_thr: float = -1,
                    nms_pre: int = -1, max_num: int = -1,
                    kernel: str = "gaussian", sigma: float = 2.0,
                    device=None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Full reference-compatible driver: returns

    (scores, labels, masks, keep_inds) sorted by decayed score
    (matrix_nms.py:5-121). The decay runs on ``device`` (default
    ``cuda``)."""
    masks = np.asarray(masks)
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    if len(labels) == 0:
        return (np.zeros(0, np.float32), labels[:0],
                masks[:0], np.zeros(0, np.int64))
    dev = resolve_device(device)
    order = np.argsort(-scores, kind="stable")
    if nms_pre > 0:
        order = order[:nms_pre]
    keep_inds = order
    decayed = matrix_nms_scores(
        torch.from_numpy(np.ascontiguousarray(masks[order])).to(dev),
        torch.from_numpy(np.ascontiguousarray(labels[order])).to(dev),
        torch.from_numpy(np.ascontiguousarray(scores[order])).to(dev)
        .float(), kernel=kernel, sigma=sigma).cpu().numpy()
    if filter_thr > 0:
        keep = decayed >= filter_thr
        if not keep.any():
            return (np.zeros(0, np.float32), labels[:0], masks[:0],
                    np.zeros(0, np.int64))
        keep_inds = keep_inds[keep]
        decayed = decayed[keep]
    order2 = np.argsort(-decayed, kind="stable")
    if max_num > 0:
        order2 = order2[:max_num]
    keep_inds = keep_inds[order2]
    return (decayed[order2], labels[keep_inds], masks[keep_inds],
            keep_inds)
