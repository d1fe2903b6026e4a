"""PyTorch port: K5 and the decoder tail at every width the JAX kernels
take, on the CPU.

``int8_mlp_route`` keeps every shape K5 took, gives it fp32 x at its
widths too, and sends the rest to K5g; K5's plain version against the JAX Pallas kernel in interpret
mode at the JAX test's shapes and at odd widths, in bf16 and fp32; K5g's
decomposition (K padded with zero codes to its 32-byte depth step, the
fp32 hidden scratch, the separate requantization) bit for bit against the
plain version; ``int8_matmul``'s float64 route; ``tiny_test`` served
int8-fused against the JAX package's quantized model with its ``mlp`` on
the Pallas kernel; ``decoder_route`` past 128 channels (the tensor-core
route's arithmetic there is in tests/test_torch_generic_tail_tc.py and
tests/test_torch_fp32_tail_tc.py). Inputs are numpy from a seed.
Tolerances with their reasons at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from painter_tpu import configs as jcfg
from painter_tpu.kernels.int8_mlp import int8_mlp as j_int8_mlp
from painter_tpu.models import incontext_vit as jm
from painter_tpu.ops import quant as jq
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import decoder_head as dh
from painter_tpu_torch.kernels import int8_mlp as k5
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.ops import quant as tq

from test_torch_decoder_head import _inputs, _port_args
from torch_port_common import jax_params_np, port_model, stitched_batch, t

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
JDTYPES = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
# K5's plain version vs the JAX kernel: (M, K, N, block_m, zero rows): the
# JAX test's K 128 / N 256 at block_m 64 and a ragged 96, tiny_test's
# widths, odd widths, one row, and a ragged M with zero rows
K5_CASES = {"jax_test_bm64": (224, 128, 256, 64, ()),
            "jax_test_bm96": (224, 128, 256, 96, ()),
            "tiny": (64, 32, 128, 32, ()),
            "odd_widths": (37, 40, 136, 16, ()),
            "m1": (1, 128, 256, 8, ()),
            "m37_zero_rows": (37, 128, 256, 16, (0, 5, 36))}
# the kernel's depth step: K5g zero-pads the reduction to a multiple of it
# (csrc/int8_mlp_generic.cu: k32 wgmma steps)
K5G_DEPTH = 32


def _dense(k, n, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {"kernel": (scale * rng.randn(k, n)).astype(np.float32),
            "bias": (0.05 * rng.randn(n)).astype(np.float32)}


def _port_linear(lp):
    lin = torch.nn.Linear(*lp["kernel"].shape)
    with torch.no_grad():
        lin.weight.copy_(t(lp["kernel"].T))
        lin.bias.copy_(t(lp["bias"]))
    return tq.QuantizedLinear.from_linear(lin)


def _mlp_args(m, k, n, seed, dtype, zero_rows=()):
    fc1, fc2 = _dense(k, n, seed), _dense(n, k, seed + 1)
    x = np.random.RandomState(seed + 2).randn(m, k).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    l1, l2 = _port_linear(fc1), _port_linear(fc2)
    return fc1, fc2, x, (t(x).to(dtype), l1.weight.q, l1.weight.scale,
                         l1.bias, l2.weight.q, l2.weight.scale, l2.bias)


# ---------------------------------------------------------------------------
# K5 / K5g routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,dtype", [
    pytest.param(k, dt, id=str(k) if dt == torch.bfloat16 else f"{k}-fp32")
    for k in (128, 256, 768, 1024, 2048)
    for dt in (torch.bfloat16, torch.float32)])
def test_int8_mlp_route_keeps_every_k5_shape(k, dtype):
    """Hidden 4096, K a multiple of 128: the shapes K5 took in bf16, and
    takes in fp32 too (ViT-L's 1024 -> 4096 among them)."""
    assert k5.int8_mlp_route(k, k5.HIDDEN, dtype) == "vitl"


# each case keeps the id it had before fp32 (1024, 4096) moved to K5
@pytest.mark.parametrize("k,n,dtype", [
    pytest.param(k, n, dt, id=f"{k}-{n}-dtype{i}") for i, k, n, dt in [
        (0, 128, 256, torch.bfloat16), (1, 32, 128, torch.bfloat16),
        (2, 40, 136, torch.bfloat16), (3, 768, 3072, torch.bfloat16),
        (4, 1000, 4096, torch.bfloat16), (5, 1, 1, torch.bfloat16),
        (7, 128, 256, torch.float32), (8, 32, 128, torch.float32),
        (9, 40, 136, torch.float32)]])
def test_int8_mlp_route_sends_the_rest_to_k5g(k, n, dtype):
    """The JAX test's shape, tiny_test's, odd widths and other hidden
    widths go to K5g, in either type."""
    assert k5.int8_mlp_route(k, n, dtype) == "generic"


def test_int8_mlp_route_refuses_other_types_and_empty_widths():
    with pytest.raises(TypeError, match="bf16 or fp32"):
        k5.int8_mlp_route(128, 256, torch.float16)
    with pytest.raises(ValueError, match="K, N >= 1"):
        k5.int8_mlp_route(0, 256, torch.float32)


# ---------------------------------------------------------------------------
# K5's plain version against the JAX kernel, and K5g's decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_plain_matches_jax_kernel(case, dt):
    """``int8_mlp`` on CPU tensors (the plain version) == the JAX Pallas
    kernel in interpret mode, output in x's type. The int32 sums are exact
    on both sides; only the fp32 order of the dequantization and the GELU
    differs (ulps in fp32: XLA contracts and fuses them). bf16 is held
    within one bf16 step at the output's largest magnitude (2^-7 x max
    |out|), as tests/test_torch_quant.py holds it. fp32 is held near its
    ulps, within 1e-5 x max |out| (measured at most 1.8e-7 x max |out| at
    every case here): an fp32 ulp apart can move one hidden value across a
    requantization boundary, which shifts one row's outputs by one int8
    step times the fc2 weights, so at most one row may pass that limit and
    only by one bf16 step. Zero rows give gelu(b1) . W2 + b2, no NaN."""
    m, k, n, block_m, zero_rows = K5_CASES[case]
    fc1, fc2, x, args = _mlp_args(m, k, n, 8, DTYPES[dt], zero_rows)
    ref = np.asarray(j_int8_mlp(jnp.asarray(x, JDTYPES[dt]),
                                jq.quantize_linear_params(fc1),
                                jq.quantize_linear_params(fc2),
                                block_m=block_m, interpret=True), np.float32)
    got = k5.int8_mlp(*args)
    assert got.dtype == DTYPES[dt] and got.shape == (m, k)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    diff, top = np.abs(got - ref), np.abs(ref).max()
    assert diff.max() <= 2.0 ** -7 * top, diff.max()
    if dt == "fp32":
        rows = np.unique(np.nonzero(diff > 1e-5 * top)[0])
        assert rows.size <= 1, (rows, diff.max() / top)
    for r in zero_rows:
        h = jax.nn.gelu(jnp.asarray(fc1["bias"]), approximate=True)
        want = np.asarray(h @ fc2["kernel"] + fc2["bias"])
        assert np.abs(got[r] - want).max() < 0.05


def _pad_depth(q, depth):
    """int8 (rows, K) zero-padded along K to a multiple of ``depth``."""
    return F.pad(q, (0, -(-q.shape[1] // depth) * depth - q.shape[1]))


def _depth_padded_mm(a, b_t):
    """int32 ``a . b_t^T`` summed in int64 over the depth zero-padded to
    K5G_DEPTH."""
    a, b_t = _pad_depth(a, K5G_DEPTH), _pad_depth(b_t, K5G_DEPTH)
    return (a.long() @ b_t.long().t()).to(torch.int32)


def _k5g(x, w1q, s1, b1, w2q, s2, b2):
    """K5g's arithmetic in plain torch: (a) xq with K zero-padded to the
    kernel's depth step; (b) fc1 as exact int sums over the padded depth
    (int64 here), dequantization (int -> fp32, times r1 * s1, plus b1) and
    the GELU into an fp32 h (M, N) scratch; (c) h requantized on its own;
    (d) fc2 the same way. Returns (out, h, hq)."""
    k = x.shape[-1]
    xq, r1 = k5.row_quant(x.reshape(-1, k).float())
    h = k5.gelu_tanh_f32(_depth_padded_mm(xq, w1q).float() * (r1 * s1) + b1)
    hq, r2 = k5.row_quant(h)
    out = _depth_padded_mm(hq, w2q).float() * (r2 * s2) + b2
    return out.to(x.dtype).reshape(x.shape), h, hq


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["tiny", "odd_widths", "m1",
                                  "m37_zero_rows"])
def test_k5g_decomposition_is_bit_equal(case, dt):
    """K5g's decomposition == ``int8_mlp_reference`` bit for bit: integer
    sums do not depend on their order or on zero codes past K, and every
    fp32 step (dequantization, GELU, the row maxima and requantization of
    the stored fp32 h) is the plain version's, in its order."""
    m, k, n, _, zero_rows = K5_CASES[case]
    _, _, _, args = _mlp_args(m, k, n, 9, DTYPES[dt], zero_rows)
    ref = k5.int8_mlp_reference(*args)
    got, h, hq = _k5g(*args)
    assert torch.equal(got, ref)
    xq, r1 = k5.row_quant(args[0].float())
    h_ref = k5.gelu_tanh_f32(k5.int8_matmul(xq, args[1]).float()
                             * (r1 * args[2]) + args[3])
    assert torch.equal(h, h_ref)
    assert torch.equal(hq, k5.row_quant(h_ref)[0])


@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (16, 128, 256),
                                   (37, 44, 130), (1, 40, 136),
                                   (64, 33, 7)])
def test_int8_matmul_f64_route_is_exact(m, k, n):
    """The float64 route (the card's route where cuBLASLt's ``_int_mm``
    refuses the shape) == numpy's int64 product, at the extreme codes
    too."""
    rng = np.random.RandomState(m + k + n)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (n, k)).astype(np.int8)
    a[0] = 127
    b[0] = -127
    assert not k5.int_mm_takes(m, k, n)
    got = k5.int8_matmul_f64(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        k5.int8_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        want)


@pytest.mark.parametrize("m,k,n,takes", [(17, 8, 8, True), (16, 8, 8, False),
                                         (17, 12, 8, False),
                                         (17, 8, 12, False),
                                         (12544, 1024, 4096, True)])
def test_int_mm_takes_cublaslt_shapes(m, k, n, takes):
    assert k5.int_mm_takes(m, k, n) == takes


# ---------------------------------------------------------------------------
# tiny_test served int8-fused against the JAX package's quantized model
# ---------------------------------------------------------------------------

def _jax_mlp_on_the_kernel(monkeypatch):
    """The JAX package's ``quant.mlp`` with its "fused" dispatch taken on
    the CPU: tanh GELU runs the Pallas kernel in interpret mode (JAX on the
    CPU otherwise takes XLA, ``painter_tpu/ops/quant.py:191-192``); exact
    GELU the unfused path. Returns the kernel's calls."""
    calls = []
    real = jq.mlp

    def mlp(fc1, fc2, x, gelu_approx=False, kernel_mesh=None):
        if gelu_approx:
            calls.append(x.shape)
            return j_int8_mlp(x, fc1, fc2, block_m=32, interpret=True)
        return real(fc1, fc2, x, gelu_approx=gelu_approx,
                    kernel_mesh=kernel_mesh)

    monkeypatch.setattr(jq, "mlp", mlp)
    return calls


def _port_mlp_calls(monkeypatch):
    calls = []
    real = tq.int8_mlp

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(tq, "int8_mlp", counted)
    return calls


@pytest.mark.parametrize("dtype,gelu", [("bfloat16", "auto"),
                                        ("float32", "tanh"),
                                        ("float32", "auto")],
                         ids=["bf16", "fp32_tanh", "fp32_exact"])
def test_tiny_int8_fused_matches_jax_kernel(monkeypatch, dtype, gelu):
    """tiny_test (K 32, N 128: K5g's shapes) quantized with the fused MLP:
    predict_image and predict_query_half_batch against the JAX quantized
    model whose ``mlp`` runs the Pallas kernel. Both sides call their
    kernel once per block per forward under the tanh GELU, neither under
    the exact one (fp32 ``gelu="auto"``, the unfused path, as JAX).
    Tolerances of tests/test_torch_quant.py's quantized model: fp32 2e-4
    on the painted scale (6 blocks of per-row requantization, where an fp32
    step in another order can move a value by one int8 step), bf16 0.1."""
    kw = dict(seg_type_tokens=True, dtype=dtype, gelu=gelu)
    cfg_j, cfg_t = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, 13)
    params_q = jq.quantize_params(params)
    imgs, tgts, mask = stitched_batch(cfg_j, 2, seed=14)
    st = np.asarray([[0], [1]], np.int32)
    j_calls = _jax_mlp_on_the_kernel(monkeypatch)
    ref_img = np.asarray(jax.jit(lambda p, *a: jm.predict_image(
        p, cfg_j, *a))(params_q, imgs, tgts, mask, st))
    ref_half = np.asarray(jax.jit(lambda p, *a: jm.predict_query_half_batch(
        p, cfg_j, *a))(params_q, imgs, tgts, mask, st))
    t_calls = _port_mlp_calls(monkeypatch)
    qmodel = tq.quantize_model(port_model(cfg_t, params), mlp_impl="fused")
    with torch.no_grad():
        got_img = tm.predict_image(qmodel, t(imgs), t(tgts), t(mask),
                                   seg_type=t(st, torch.long))
        got_half = tm.predict_query_half_batch(
            qmodel, t(imgs), t(tgts), t(mask), seg_type=t(st, torch.long))
    want = 2 * cfg_t.depth if cfg_t.gelu_approximate else 0
    assert len(t_calls) == len(j_calls) == want
    if want:
        assert k5.int8_mlp_route(cfg_t.embed_dim, 4 * cfg_t.embed_dim,
                                 cfg_t.compute_dtype) == "generic"
    atol = 2e-4 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got_img.numpy(), ref_img, atol=atol)
    np.testing.assert_allclose(got_half.numpy(), ref_half, atol=atol)


# ---------------------------------------------------------------------------
# the decoder tail past 128 channels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,cp", [(129, 136), (160, 160), (200, 200),
                                  (256, 256), (257, 264), (1000, 1000)])
def test_decoder_route_past_128_channels(c, cp):
    """Every width past 128 goes to K3g / K4g, padded to a multiple of 8
    (not to a power of two), in both types."""
    for dtype in DTYPES.values():
        assert dh.decoder_route(c, dtype) == "generic"
    assert dh.generic_channels(c) == cp


# ---------------------------------------------------------------------------
# the new wrappers on the CPU and on other devices
# ---------------------------------------------------------------------------

def test_new_wrappers_on_the_cpu_run_plain_and_count_no_launch():
    """On CPU tensors ``int8_mlp`` / ``int8_mlp_generic`` are the plain
    version, and the decoder tail's wrappers at C = 160 the plain tail; no
    route counts a launch."""
    _, _, _, args = _mlp_args(37, 40, 136, 3, torch.float32)
    counters = (k5.int8_mlp, k5.int8_mlp_generic, dh.fused_decoder_tail,
                dh.fused_decoder_tail_bwd, dh.fused_decoder_tail_generic,
                dh.fused_decoder_tail_bwd_generic)
    before = [fn.launches for fn in counters]
    ref = k5.int8_mlp_reference(*args)
    for fn in (k5.int8_mlp, k5.int8_mlp_generic):
        assert torch.equal(fn(*args), ref)
    pix, w1, b1, lns, lnb, w2, b2 = _port_args(_inputs(4, 1, 8, 6, 160),
                                               torch.float32)
    go = t(np.random.RandomState(5).randn(1, 8, 6, 3))
    out = dh.fused_decoder_tail_reference(pix, w1, b1, lns, lnb, w2, b2,
                                          False)
    for fn in (dh.fused_decoder_tail, dh.fused_decoder_tail_generic):
        assert torch.equal(fn(pix, w1, b1, lns, lnb, w2, b2, False), out)
    grads = dh.fused_decoder_tail_bwd_reference(pix, w1, b1, lns, lnb, w2,
                                                go, False)
    for fn in (dh.fused_decoder_tail_bwd, dh.fused_decoder_tail_bwd_generic):
        got = fn(pix, w1, b1, lns, lnb, w2, go, False)
        assert all(torch.equal(a, r) for a, r in zip(got, grads))
    assert [fn.launches for fn in counters] == before


def test_new_wrappers_refuse_other_devices():
    _, _, _, args = _mlp_args(4, 32, 128, 6, torch.float32)
    meta = tuple(a.to("meta") for a in args)
    for fn in (k5.int8_mlp, k5.int8_mlp_generic):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*meta)
    pix, w1, b1, lns, lnb, w2, b2 = (
        a.to("meta") for a in _port_args(_inputs(7, 1, 4, 4, 160),
                                         torch.float32))
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail_generic(pix, w1, b1, lns, lnb, w2, b2, True)
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail_bwd_generic(pix, w1, b1, lns, lnb, w2,
                                          pix[..., :3], True)


def test_k5g_source_notes_its_tpu_kernel():
    assert "int8_mlp_generic" in build.SOURCES
    with open(f"{build.CSRC}/int8_mlp_generic.cu") as f:
        src = f.read()
    assert "painter_tpu/kernels/int8_mlp.py:_int8_mlp_2d" in src
    assert 'extern "C"' in src and "int8_mlp_generic_f32" in src
    with open(f"{build.CSRC}/decoder_tail_generic.cu") as f:
        src = f.read()
    # the narrow tail takes C <= 8 on mma.sync; the chunked route past 128
    # channels went when fp32 moved to the tensor cores
    assert "decoder_tail_generic_bwd_f32" in src and "mma.sync" in src
    assert "decoder_tail_generic_wide" not in src
    assert build._target("int8_mlp_generic").startswith(build.BUILD_DIR)
