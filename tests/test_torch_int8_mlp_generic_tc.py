"""PyTorch port: K5g's tensor-core design (``csrc/int8_mlp_generic.cu``)
on the CPU, against the JAX package's fused w8a8 MLP.

A plain torch model of the kernel's tiling -- CTA tiles of 128 rows and
``k5g_tile_n`` output columns, depth slices of 128 bytes read as TMA boxes
that zero-fill past the maps (depth past K, rows past M, columns past N),
four k32 products per slice summed into int32 accumulators, stores masked
to (M, N), the weights through ``k5g_staged_weight``, the row quantization's
lane-strided maxima, the requantization's row maximum taken over fc1's
per-tile maxima -- is held bit for bit to the exact int32 products of
the JAX kernel's own quantization, and its output to
``painter_tpu.kernels.int8_mlp.int8_mlp`` in interpret mode (as the JAX
package's tests run it) within the stated tolerance, and bit for bit to the
port's plain version. Then a SegGPT at ViT-B width (768 / 3072 / 12 heads,
four blocks: the decoder takes four taps) on a small image, int8-fused,
against the JAX package's quantized model with its ``mlp`` on the Pallas
kernel. Inputs are numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.kernels import int8_mlp as jk
from painter_tpu.models import incontext_vit as jm
from painter_tpu.ops import quant as jq
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.kernels import int8_mlp as k5
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.ops import quant as tq

from test_torch_generic_widths import (_jax_mlp_on_the_kernel, _mlp_args,
                                       _port_mlp_calls)
from torch_port_common import jax_params_np, stitched_batch, t

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
JDTYPES = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
# (M, K, N): the JAX kernel test's K 128 / N 256, odd widths whose weights
# the wrapper stages (rows of 40 and 136 bytes), tiny_test's MLP and a
# ViT-B-wide MLP at a ragged M
SHAPES = {"jax_test": (224, 128, 256), "odd_widths": (37, 40, 136),
          "tiny": (64, 32, 128), "vitb": (37, 768, 3072)}
# the kernel's depth slice (csrc KC) and its wgmma depth step (k32)
SLICE, STEP = 128, 32
SMS = 132  # an H100 SXM's SMs


def _box(mat, rows, cols, r0, c0, box_rows, box_cols):
    """A TMA box of a map of ``rows`` x ``cols`` valid elements: mat[r0:,
    c0:] cut to the box, zero past the map (whatever ``mat`` holds
    there)."""
    out = torch.zeros(box_rows, box_cols, dtype=mat.dtype)
    r1, c1 = min(rows, r0 + box_rows), min(cols, c0 + box_cols)
    out[:r1 - r0, :c1 - c0] = mat[r0:r1, c0:c1]
    return out


def _tc_gemm(a, b, m, n, depth):
    """int32 C (m, n) = A . B^T as ``tc_gemm`` tiles it: A (m, >= depth)
    and B (n, >= depth) int8 read through maps of ``depth`` columns; per
    CTA 128 rows x ``k5g_tile_n`` columns, per ring stage a 128-byte-deep
    box of each (zero past the maps), each k32 step's product added into
    the int32 accumulator; stores masked to (m, n). The k32 products run
    in float64, exact: |step| <= 32 * 127^2."""
    bn = k5.k5g_tile_n(m, n, SMS)
    slices = -(-depth // SLICE)
    c = torch.full((m, n), -2 ** 31, dtype=torch.int64)
    for m0 in range(0, m, k5.K5G_ROWS):
        for n0 in range(0, n, bn):
            # the tile's boxes of every stage side by side, cut into k32 steps
            sa = _box(a, m, depth, m0, 0, k5.K5G_ROWS, slices * SLICE)
            sb = _box(b, n, depth, n0, 0, bn, slices * SLICE)
            steps = torch.einsum(
                "rsk,csk->src", sa.double().view(k5.K5G_ROWS, -1, STEP),
                sb.double().view(bn, -1, STEP))
            # the running int32 sum of the steps; exact in float64 too
            # (|sum| <= depth * 127^2 < 2^53), so summed there
            acc = steps.sum(dim=0).long()
            r1, c1 = min(m, m0 + k5.K5G_ROWS), min(n, n0 + bn)
            c[m0:r1, n0:c1] = acc[:r1 - m0, :c1 - n0]
    assert c.abs().max() < 2 ** 31  # every output written, no overflow
    return c.to(torch.int32)


def _quant_rows(x, ldq, tmax=None):
    """``quant_rows``: the row maximum as the max of 32 lane-strided
    partial maxima, of the row or of its per-tile maxima ``tmax``; the
    codes zero-padded to ``ldq`` columns."""
    xf = x.float()
    parts = xf.abs() if tmax is None else tmax
    amax = torch.stack([parts[:, lane::32].amax(dim=1)
                        if lane < parts.shape[1] else torch.zeros(len(xf))
                        for lane in range(32)], dim=1).amax(dim=1,
                                                            keepdim=True)
    q, r = k5.row_quant(xf)
    assert torch.equal(r, amax * (1.0 / 127.0))
    pad = torch.zeros(len(q), ldq, dtype=torch.int8)
    pad[:, :q.shape[1]] = q
    return pad, r


def _k5g(x, w1q, s1, b1, w2q, s2, b2):
    """K5g's four launches in plain torch; returns (out, the int32 sums of
    fc1 and fc2, xq, hq)."""
    k = x.shape[-1]
    n = w1q.shape[0]
    w1s, w2s = k5.k5g_staged_weight(w1q), k5.k5g_staged_weight(w2q)
    xq, r1 = _quant_rows(x.reshape(-1, k), -(-k // 16) * 16)
    m = xq.shape[0]
    acc1 = _tc_gemm(xq, w1s, m, n, k)
    h = k5.gelu_tanh_f32(acc1.float() * (r1 * s1) + b1)
    # fc1's epilogue: each row's |h| maximum per tile of BN columns; the
    # requantization takes the row maximum as the maximum of those
    bn = k5.k5g_tile_n(m, n, SMS)
    tmax = torch.stack([h[:, c:c + bn].abs().amax(dim=1)
                        for c in range(0, n, bn)], dim=1)
    hq, r2 = _quant_rows(h, -(-n // 16) * 16, tmax)
    acc2 = _tc_gemm(hq, w2s, m, k, n)
    out = acc2.float() * (r2 * s2) + b2
    return out.to(x.dtype).reshape(x.shape), acc1, acc2, xq, hq


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_k5g_tiling_matches_jax_kernel(case, dt):
    """The tiling model against the JAX package. Bitwise: the port's xq is
    the JAX kernel's ``_row_quant`` codes, fc1's int32 sums are the exact
    int32 ``dot_general`` of those codes and W1q (order-free integer sums,
    zero codes past K), fc2's those of its hq; and the model's output is
    ``int8_mlp_reference``'s. After the sums, against the JAX Pallas kernel
    in interpret mode: the fp32 dequantization and GELU round in another
    order there (XLA contracts and fuses them, ulps in fp32), so bf16 is
    held within one bf16 step at the output's largest magnitude (2^-7 x
    max |out|) and fp32 within 1e-5 x max |out|, where at most one row may
    pass it: an ulp can move one hidden value across a requantization
    boundary, one int8 step times that row's fc2 weights (as
    tests/test_torch_generic_widths.py holds K5's plain version)."""
    m, k, n = SHAPES[case]
    fc1, fc2, x, args = _mlp_args(m, k, n, 21, DTYPES[dt], (1,))
    got, acc1, acc2, xq, hq = _k5g(*args)
    assert torch.equal(got, k5.int8_mlp_reference(*args))
    # the JAX kernel's quantization of the same x and its int32 products
    xq_j, _ = jk._row_quant(jnp.asarray(x, JDTYPES[dt]).astype(jnp.float32))
    assert np.array_equal(np.asarray(xq_j), xq[:, :k].numpy())
    w1_j = jq.quantize_linear_params(fc1)["kernel_q"]
    w2_j = jq.quantize_linear_params(fc2)["kernel_q"]
    for codes, w, acc in ((xq_j, w1_j, acc1),
                          (jnp.asarray(hq[:, :n].numpy()), w2_j, acc2)):
        want = jax.lax.dot_general(codes, w, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        assert np.array_equal(np.asarray(want), acc.numpy())
    ref = np.asarray(jk.int8_mlp(jnp.asarray(x, JDTYPES[dt]),
                                 jq.quantize_linear_params(fc1),
                                 jq.quantize_linear_params(fc2),
                                 block_m=64, interpret=True), np.float32)
    got = got.float().numpy()
    diff, top = np.abs(got - ref), np.abs(ref).max()
    assert diff.max() <= 2.0 ** -7 * top, diff.max() / top
    if dt == "fp32":
        rows = np.unique(np.nonzero(diff > 1e-5 * top)[0])
        assert rows.size <= 1, (rows, diff.max() / top)


@pytest.mark.parametrize("m,n,sms,bn", [
    (12544, 3072, 132, 256),   # ViT-B-wide b8 fc1: 9 waves either way
    (12544, 768, 132, 128),    # its fc2: 5 waves of 128 beat 3 of 256
    (25088, 768, 132, 128), (3136, 768, 132, 256), (1568, 3072, 132, 128),
    (64, 128, 132, 128), (64, 32, 132, 128), (1, 256, 132, 128),
    (128, 256, 1, 256),        # one SM: the same columns, A read once
])
def test_k5g_tile_width(m, n, sms, bn):
    """``k5g_tile_n`` gives the width whose waves of one CTA per SM leave
    each SM the fewest output columns, 256 on a tie."""
    assert k5.k5g_tile_n(m, n, sms) == bn

    def per_sm(w):
        return -(-(-(-m // k5.K5G_ROWS) * -(-n // w)) // sms) * w

    assert per_sm(bn) == min(per_sm(w) for w in k5.K5G_TILE_N)
    assert bn == 256 or per_sm(128) < per_sm(256)


def test_k5g_staged_weight():
    """Weights whose rows are 16-byte aligned go to TMA as they are;
    others as a copy zero-padded to a multiple of 16 columns."""
    rng = np.random.RandomState(3)
    w = t(rng.randint(-127, 128, (136, 48)), torch.int8)
    assert k5.k5g_staged_weight(w) is w
    for cols in (1, 7, 40, 136):
        w = t(rng.randint(-127, 128, (9, cols)), torch.int8)
        s = k5.k5g_staged_weight(w)
        assert s.shape == (9, -(-cols // 16) * 16) and s.data_ptr() % 16 == 0
        assert torch.equal(s[:, :cols], w) and not s[:, cols:].any()


# the port's int8-fused SegGPT at ViT-B width against the JAX one, fp32:
# relative Frobenius. The two MLPs round their fp32 steps in other places
# (XLA fuses the JAX kernel's dequantization and GELU; the port's plain
# version rounds each step), so a hidden value an ulp from a
# requantization boundary takes another int8 code there, one int8 step
# times its row's fc2 weights; at 3072 hidden values a row such flips are
# common, and four blocks of attention spread them over every token toward
# the level of the quantization error itself (int8 vs unquantized reads
# 2.08e-2 on this model). Read 3.666e-3 at 1, 2 and 8 torch threads; the
# bound is 1.5x that. A port MLP that dropped b1 reads 5.4e-2, one on the
# exact GELU 1.1e-2
VITB_FP32_REL_FRO = 5.5e-3


VITB = dict(embed_dim=768, depth=4, num_heads=12, out_indices=(0, 1, 2, 3),
            merge_idx=0, img_size=(64, 32), pretrain_img_size=32)
SEGGPT = "seggpt_vit_large_patch16_input896x448"


@pytest.fixture(scope="module")
def vitb_params():
    """The ViT-B-wide SegGPT's weights (fp32, independent of the compute
    type), made once for both types."""
    return jax_params_np(jcfg.get_config(SEGGPT, **VITB), 23)


def _port_vitb(cfg_t, params):
    """The port's model holding ``params``: built on the meta device and
    filled by ``load_jax_params`` (strict: every tensor comes from
    ``params``), without the random init a built model would draw first."""
    with torch.device("meta"):
        model = tm.InContextViT(cfg_t)
    return convert.load_jax_params(model.to_empty(device="cpu"), params)


@pytest.mark.parametrize("dtype,gelu", [("bfloat16", "auto"),
                                        ("float32", "tanh")],
                         ids=["bf16", "fp32_tanh"])
def test_vitb_width_int8_fused_matches_jax_kernel(monkeypatch, vitb_params,
                                                  dtype, gelu):
    """SegGPT at ViT-B width (768 -> 3072 -> 768, 12 heads of 64), four
    global blocks (the decoder takes four taps: blocks 0-3, the streams
    merged after block 0) on a 64x32 image, quantized with the fused MLP:
    predict_image against the JAX quantized model whose ``mlp`` runs the
    Pallas kernel in interpret mode. Both sides call their kernel once per
    block per forward, at K 768 / N 3072: K5g's route in both types. bf16
    within 0.1 on the painted scale (tests/test_torch_generic_widths.py's
    tiny_test bound); fp32 within VITB_FP32_REL_FRO."""
    kw = dict(VITB, dtype=dtype, gelu=gelu)
    cfg_j, cfg_t = jcfg.get_config(SEGGPT, **kw), tcfg.get_config(SEGGPT, **kw)
    assert k5.int8_mlp_route(768, 3072, cfg_t.compute_dtype) == "generic"
    params = vitb_params
    imgs, tgts, mask = stitched_batch(cfg_j, 2, seed=24)
    st = np.asarray([[0], [1]], np.int32)
    j_calls = _jax_mlp_on_the_kernel(monkeypatch)
    ref = np.asarray(jax.jit(lambda p, *a: jm.predict_image(
        p, cfg_j, *a))(jq.quantize_params(params), imgs, tgts, mask, st))
    t_calls = _port_mlp_calls(monkeypatch)
    qmodel = tq.quantize_model(_port_vitb(cfg_t, params), mlp_impl="fused")
    with torch.no_grad():
        got = tm.predict_image(qmodel, t(imgs), t(tgts), t(mask),
                               seg_type=t(st, torch.long)).numpy()
    assert len(t_calls) == len(j_calls) == cfg_t.depth
    assert np.isfinite(got).all()
    if dtype == "float32":
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= VITB_FP32_REL_FRO, rel
    else:
        np.testing.assert_allclose(got, ref, atol=0.1)
