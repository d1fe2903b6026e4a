"""PyTorch port: the eval stack's decode ops (``ops/palette.py``,
``ops/nms.py``, ``evals/semseg.py``, ``evals/instseg.py`` and the
panoptic class vote) against the JAX package on the CPU.

Inputs are integer-valued (decoded PNGs), where every palette distance is
an exact integer in fp32 and both packages take the first minimum: the
decoded indices, the candidate masks and their order must be equal. The
decayed NMS scores go through ``exp`` and a division, whose last bits may
differ between the two libraries, so they are held to 1e-6 relative.

The instance decode's maskness (the mean in-mask distance) is a sum of
fp32 values: the port sums it exactly (float64), the JAX package in fp32
in XLA's order, a few ulps off. Candidates whose exact maskness ties (a
1-pixel and a 20-pixel mask with the same mean, say) then come out of the
JAX package in an order set by those ulps, and the matrix NMS, which lets
the higher-scored of two masks decay the other, carries the swap on. So
the decode is compared three ways: the port's maskness equals an exact
numpy oracle bit for bit; with the JAX package's stats patched to that
oracle, the two decodes are equal (masks equal, scores to 1e-6 relative);
and unpatched, the candidate lists hold the same masks, in an order that
differs only among candidates whose scores agree to 1e-6 on their [0, 1]
scale (1 - neg / max(neg) cancels the ulps into up to ~1e-7 absolute).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.evals import instseg as jinst
from painter_tpu.evals import panoptic as jpan
from painter_tpu.evals import semseg as jsem
from painter_tpu.ops import nms as jnms
from painter_tpu.ops import palette as jpal
from painter_tpu_torch.evals import instseg as tinst
from painter_tpu_torch.evals import panoptic as tpan
from painter_tpu_torch.evals import run_panoptic as trp
from painter_tpu_torch.evals import semseg as tsem
from painter_tpu_torch.ops import nms as tnms
from painter_tpu_torch.ops import palette as tpal

from torch_port_common import t

SCORE_RTOL = 1e-6
MASKNESS_ATOL = 1e-6


def exact_palette_stats(segm, palette, dist_thr, n_chunks):
    """The instance decode's per-color stats (``evals/instseg.py``
    ``_palette_stats``) with the in-mask distance sums made exact: each
    distinct pixel color's fp32 distance times its pixel count, summed in
    float64 (which holds these sums exactly at these sizes), then rounded
    to fp32. The JAX package sums in fp32, in XLA's order; the port sums
    exactly. Patched into the JAX package, it leaves the two packages
    nothing to differ on but their own arithmetic.
    """
    colors, counts = np.unique(np.asarray(segm, np.float32).reshape(-1, 3),
                               axis=0, return_counts=True)
    nums, negs = [], []
    for pal in np.split(np.asarray(palette, np.float32), n_chunks):
        dist = sum(np.abs(colors[None, :, c] - pal[:, c, None])
                   for c in range(3)) / np.float32(3.0)
        mask = dist < np.float32(dist_thr)
        num_pos = np.where(mask, counts, 0).sum(1).astype(np.int32)
        total = (np.where(mask, dist, 0).astype(np.float64)
                 * counts).sum(1)
        nums.append(num_pos)
        negs.append(total.astype(np.float32)
                    / np.maximum(num_pos, 1).astype(np.float32))
    return (jnp.asarray(np.concatenate(nums)),
            jnp.asarray(np.concatenate(negs)))


def _painted(rng, palette, labels, noise):
    """Palette colors of ``labels`` plus integer noise, clipped to uint8."""
    img = palette[labels].astype(np.int32)
    img += rng.randint(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _instance_painting(seed, hw=(40, 48), n=4, noise=6):
    """Blobs painted with their mass-center instance colors, plus integer
    noise, so many palette colors fall under the threshold."""
    from painter_tpu_torch.data import prep
    rng = np.random.RandomState(seed)
    h, w = hw
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y0, x0 = rng.randint(0, h - 10), rng.randint(0, w - 10)
        masks[i, y0:y0 + rng.randint(6, 16), x0:x0 + rng.randint(6, 20)] = 1
    img = prep.paint_instances(masks, hw).astype(np.int32)
    img += rng.randint(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def test_palettes_match_jax():
    for name in ("ade20k_palette", "coco_semseg_palette",
                 "coco_instance_palette", "pose_gb_palette"):
        np.testing.assert_array_equal(getattr(tpal, name)(),
                                      getattr(jpal, name)())
    labels = np.random.RandomState(0).randint(0, 151, (9, 11))
    labels[0, 0] = 255
    np.testing.assert_array_equal(
        tpal.paint_semantic(labels, tpal.ade20k_palette()),
        jpal.paint_semantic(labels, jpal.ade20k_palette()))


@pytest.mark.parametrize("dist_type", ["abs", "square", "mean"])
@pytest.mark.parametrize("palette", ["ade20k_palette", "coco_semseg_palette"])
def test_nearest_color_decode_and_distance_map(dist_type, palette):
    rng = np.random.RandomState(1)
    pal = getattr(tpal, palette)()
    labels = rng.randint(0, len(pal), (23, 19))
    img = _painted(rng, pal, labels, 40)
    img[0, :len(pal) // 10] = 128.0  # many equidistant candidates
    got = tpal.nearest_color_decode(t(img), t(pal), dist_type)
    ref = np.asarray(jpal.nearest_color_decode(jnp.asarray(img),
                                               jnp.asarray(pal), dist_type))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    dmap = tpal.color_distance_map(t(img), t(pal), dist_type)
    np.testing.assert_array_equal(
        dmap.numpy(), np.asarray(jpal.color_distance_map(
            jnp.asarray(img), jnp.asarray(pal), dist_type)))
    with pytest.raises(ValueError):
        tpal.color_distance_map(t(img), t(pal), "cosine")


def _nms_case(seed, n=14, hw=(12, 16)):
    rng = np.random.RandomState(seed)
    masks = (rng.rand(n, *hw) > 0.55).astype(np.float32)
    labels = rng.randint(0, 3, n)
    # ties: scores on a 0.1 grid
    scores = (rng.randint(1, 8, n) / 10.0).astype(np.float32)
    return masks, labels, scores


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_matrix_nms_scores_matches_jax(kernel):
    masks, labels, scores = _nms_case(2)
    got = tnms.matrix_nms_scores(t(masks), torch.from_numpy(labels),
                                 t(scores), kernel=kernel, sigma=2.0)
    ref = np.asarray(jnms.matrix_nms_scores(
        jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(scores),
        kernel=kernel, sigma=2.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=SCORE_RTOL, atol=0)
    assert got.numpy().min() < scores.min()  # some decay happened
    # the same masks as weighted distinct pixel columns give the same bits
    cols, counts = np.unique(masks.reshape(len(masks), -1), axis=1,
                             return_counts=True)
    weighted = tnms.matrix_nms_scores(t(cols), torch.from_numpy(labels),
                                      t(scores), kernel=kernel, sigma=2.0,
                                      weights=torch.from_numpy(counts))
    assert cols.shape[1] < masks[0].size
    np.testing.assert_array_equal(weighted.numpy(), got.numpy())
    assert tnms.matrix_nms_scores(t(masks[:0]), torch.from_numpy(labels[:0]),
                                  t(scores[:0])).shape == (0,)


@pytest.mark.parametrize("kw", [
    {},
    {"filter_thr": 0.3},
    {"nms_pre": 9, "max_num": 5},
    {"filter_thr": 0.2, "nms_pre": 10, "max_num": 4, "kernel": "linear"},
    {"filter_thr": 10.0},          # everything filtered
])
def test_mask_matrix_nms_matches_jax(kw):
    masks, labels, scores = _nms_case(3)
    got = tnms.mask_matrix_nms(masks, labels, scores, device="cpu", **kw)
    ref = jnms.mask_matrix_nms(masks, labels, scores, **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=SCORE_RTOL, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)


def test_maskness_is_exact():
    segm = _instance_painting(4)
    pal = tinst._pad_palette(
        tpal.coco_instance_palette()[:-1].astype(np.float32), 800)
    colors, _, counts = tinst._distinct_colors(t(segm))
    num_pos, neg = tinst._palette_stats(colors, counts, t(pal), 19.0, 800)
    want_num, want_neg = exact_palette_stats(segm, pal, 19.0, 8)
    np.testing.assert_array_equal(num_pos.numpy(), np.asarray(want_num))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(want_neg))
    jax_num, jax_neg = jinst._palette_stats(jnp.asarray(segm),
                                            jnp.asarray(pal), 19.0, 8)
    np.testing.assert_array_equal(np.asarray(jax_num), np.asarray(want_num))
    np.testing.assert_allclose(np.asarray(jax_neg), np.asarray(want_neg),
                               rtol=SCORE_RTOL, atol=0)


DECODE_CASES = [
    dict(dist_thr_list=(19.0,)),
    dict(dist_thr_list=(19.0,), max_num=5),
    dict(dist_thr_list=(12.0, 19.0)),
    dict(dist_thr_list=(19.0,), keep_all=True),
    dict(dist_thr_list=(12.0, 19.0), keep_all=True, return_device=True),
    dict(dist_thr_list=(19.0,), return_device=True, topk_pre=7),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_instances_matches_jax(case, monkeypatch):
    segm = _instance_painting(4)
    got = tinst.decode_instances(segm, device="cpu", **case)
    monkeypatch.setattr(jinst, "_palette_stats", exact_palette_stats)
    ref = jinst.decode_instances(segm, **case)
    assert got["masks"].dtype == np.float32 and len(got["masks"]) > 1
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_allclose(got["scores"], ref["scores"],
                               rtol=SCORE_RTOL, atol=0)
    if case.get("return_device"):
        assert isinstance(got["masks_dev"], torch.Tensor)
        np.testing.assert_array_equal(got["masks_dev"].float().numpy(),
                                      np.asarray(ref["masks_dev"],
                                                 np.float32))


@pytest.mark.parametrize("thrs", [(19.0,), (12.0, 19.0)])
def test_decode_instances_candidates_match_unpatched_jax(thrs):
    segm = _instance_painting(4)
    got = tinst.decode_instances(segm, thrs, keep_all=True, device="cpu")
    ref = jinst.decode_instances(segm, thrs, keep_all=True)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=MASKNESS_ATOL)
    keys = [m.tobytes() for m in got["masks"]]
    ref_keys = [m.tobytes() for m in ref["masks"]]
    assert collections.Counter(keys) == collections.Counter(ref_keys)
    for i, key in enumerate(keys):
        if key != ref_keys[i]:
            near = [j for j, k in enumerate(ref_keys) if k == key]
            assert min(abs(ref["scores"][j] - got["scores"][i])
                       for j in near) <= MASKNESS_ATOL, i


def test_decode_instances_empty_and_minmax_match_jax():
    # every uint8 color lies within 19 of some palette color; this does not
    far = np.full((10, 12, 3), -100.0, np.float32)
    got = tinst.decode_instances(far, return_device=True, device="cpu")
    ref = jinst.decode_instances(far, return_device=True)
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_array_equal(got["scores"], ref["scores"])
    assert got["masks_dev"].shape == (1, 10, 12)
    segm = _instance_painting(5, noise=20)
    got = tinst.decode_instances_minmax(segm, device="cpu")
    ref = jinst.decode_instances_minmax(segm)
    assert set(got) == set(ref) and len(got["masks"]) > 2
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinst.decode_instances(segm)


def test_semseg_evaluator_matches_jax():
    rng = np.random.RandomState(6)
    pal = tpal.ade20k_palette()
    ours = tsem.SemSegEvaluator(150, pal, dist_type="abs", device="cpu")
    theirs = jsem.SemSegEvaluator(150, pal, dist_type="abs")
    for _ in range(3):
        gt = rng.randint(0, 150, (21, 17))
        gt[rng.rand(21, 17) < 0.1] = 255
        pred = _painted(rng, pal, np.where(rng.rand(21, 17) < 0.7, gt % 150,
                                           rng.randint(0, 150, (21, 17))),
                        25)
        np.testing.assert_array_equal(ours.decode(pred), theirs.decode(pred))
        ours.process(pred, gt)
        theirs.process(pred, gt)
    np.testing.assert_array_equal(ours._conf, theirs._conf)
    assert ours.evaluate() == theirs.evaluate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsem.SemSegEvaluator(150, pal)


def test_panoptic_vote_matches_jax_and_host_reference():
    rng = np.random.RandomState(7)
    h, w, n, num_things = 24, 28, 6, 80
    pal = tpal.coco_semseg_palette()
    sem_png = _painted(rng, pal, rng.randint(0, 133, (h, w)), 30)
    masks = (rng.rand(n, h, w) > 0.7).astype(np.float32)
    got = trp.vote_classes(t(masks), t(sem_png), t(pal), num_things).numpy()
    jpal_f = jnp.asarray(pal, jnp.float32)
    d = jpal.color_distance_map(jnp.asarray(sem_png), jpal_f, "abs")
    d = d[..., :num_things]
    prob = 1.0 - d / jnp.maximum(jnp.max(d), 1e-12)
    jax_vote = np.asarray(jnp.argmax(jnp.einsum(
        "nhw,hwk->nk", jnp.asarray(masks), prob), -1))
    host = jpan.vote_instance_classes(masks, np.asarray(
        jpal.color_distance_map(jnp.asarray(sem_png), jpal_f, "abs")),
        num_things)
    np.testing.assert_array_equal(got, jax_vote)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        tpan.vote_instance_classes(masks, tpal.color_distance_map(
            t(sem_png), t(pal)).numpy(), num_things), host)
