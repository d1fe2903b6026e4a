"""PyTorch port: int8 (w8a8) serving against the JAX package on the CPU.

Weights and inputs are numpy from a seed. The quantized weights must be
bit-identical to the JAX package's. The int8 products are exact int32 on
both sides, so the rest differs only by fp32 sums and transcendentals
taken in another order; tolerances, with their reasons, at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.infer import engine as je
from painter_tpu.kernels.int8_mlp import int8_mlp as j_int8_mlp
from painter_tpu.models import incontext_vit as jm
from painter_tpu.ops import quant as jq
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.infer import engine as te
from painter_tpu_torch.kernels import int8_mlp as k5
from painter_tpu_torch.models import incontext_vit as tm
from painter_tpu_torch.ops import quant as tq

from torch_port_common import jax_params_np, port_model, stitched_batch, t

TARGET_SETS = [("mlp",), ("attn",), ("dec",), ("attn", "mlp", "dec")]
_TARGET_LINEARS = {"attn": ("attn.qkv", "attn.proj"),
                   "mlp": ("mlp.fc1", "mlp.fc2")}


def _dense(k, n, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return {"kernel": (scale * rng.randn(k, n)).astype(np.float32),
            "bias": (0.05 * rng.randn(n)).astype(np.float32)}


def _port_linear(lp):
    """A quantized port linear from a JAX-layout fp dense dict."""
    lin = torch.nn.Linear(*lp["kernel"].shape)
    with torch.no_grad():
        lin.weight.copy_(t(lp["kernel"].T))
        lin.bias.copy_(t(lp["bias"]))
    return tq.QuantizedLinear.from_linear(lin)


def test_quantize_linear_params_bit_identical():
    """Stacked (depth, K, N) leaves, a zero column, values on .5 steps."""
    kernel = np.random.RandomState(0).randn(3, 16, 24).astype(np.float32)
    kernel[:, :, 5] = 0.0
    kernel[1, :, 7] = np.arange(16) - 7.5  # absmax 8: steps of 8/127
    ref = jq.quantize_linear_params({"kernel": kernel,
                                     "bias": np.zeros((3, 24), np.float32)})
    kq, scale = tq.quantize_linear_params(kernel)
    assert kq.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(kq, np.asarray(ref["kernel_q"]))
    np.testing.assert_array_equal(scale, np.asarray(ref["scale"]))


@pytest.mark.parametrize("targets", TARGET_SETS,
                         ids=["+".join(s) for s in TARGET_SETS])
def test_quantize_model_matches_quantize_params(targets):
    """The port's quantized copy holds the JAX tree's int8 values and
    scales, transposed to (out, in); untargeted layers stay fp and share
    the original tensors' storage. ``load_jax_params`` of the JAX tree
    gives the same buffers."""
    cfg_j, cfg_t = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    params = jax_params_np(cfg_j, seed=1)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jq.quantize_params(params, targets=targets))
    model = port_model(cfg_t, params)
    qmodel = tq.quantize_model(model, targets=targets)
    from_tree = port_model(cfg_t, ref)
    for i, blk in enumerate(qmodel.blocks):
        for group, names in _TARGET_LINEARS.items():
            for name in names:
                part, leaf = name.split(".")
                mod = blk.get_submodule(name)
                jleaf = ref["blocks"][part][leaf]
                if group not in targets:
                    assert isinstance(mod, torch.nn.Linear)
                    assert mod.weight.data_ptr() == model.blocks[
                        i].get_submodule(name).weight.data_ptr()
                    continue
                assert isinstance(mod, tq.QuantizedLinear)
                np.testing.assert_array_equal(mod.weight.q.numpy(),
                                              jleaf["kernel_q"][i].T)
                np.testing.assert_array_equal(mod.weight.scale.numpy(),
                                              jleaf["scale"][i])
                np.testing.assert_array_equal(mod.bias.numpy(),
                                              jleaf["bias"][i])
    dec = qmodel.decoder_embed
    assert isinstance(dec, tq.QuantizedLinear) == ("dec" in targets)
    assert qmodel.patch_embed.proj.weight.data_ptr() == \
        model.patch_embed.proj.weight.data_ptr()
    assert isinstance(model.blocks[0].mlp.fc1, torch.nn.Linear)
    sd_q, sd_t = qmodel.state_dict(), from_tree.state_dict()
    assert set(sd_q) == set(sd_t)
    for k in sd_q:
        assert torch.equal(sd_q[k], sd_t[k]), k


def test_quantize_model_rejects_unknown_targets_and_impls():
    model = tm.build_model(tcfg.tiny_test_config(), device="cpu")
    with pytest.raises(ValueError, match="unknown quant targets"):
        tq.quantize_model(model, targets=("mlp", "bogus"))
    with pytest.raises(ValueError, match="mlp_impl"):
        tq.quantize_model(model, mlp_impl="pallas")
    with pytest.raises(ValueError, match="mlp"):
        tq.quantize_model(model, targets=("attn",), mlp_impl="fused")


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_fused_mlp_refuses_float_layers(gelu_approx):
    """"fused" on floating-point fc1 / fc2 raises, whatever the GELU: it
    never runs the fp MLP in K5's place."""
    fc1, fc2 = torch.nn.Linear(64, 128), torch.nn.Linear(128, 64)
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="int8"):
        tq.mlp(x, fc1, fc2, gelu_approx, "fused")
    with pytest.raises(TypeError, match="int8"):
        tq.mlp(x, _port_linear(_dense(64, 128, seed=1)), fc2, gelu_approx,
               "fused")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_linear_matches_jax(dtype):
    """fp32: 1e-5 x max |out| (exact int32 sums, the same fp32 dequant
    ops); bf16: one bf16 step at the largest magnitude (2^-7 x max)."""
    lp = _dense(64, 48, seed=2)
    x = np.random.RandomState(3).randn(2, 20, 64).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero row: no division by zero
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jq.int8_linear(jnp.asarray(x, jdt),
                                    jq.quantize_linear_params(lp)),
                     np.float32)
    lin = _port_linear(lp)
    got = tq.linear(t(x).to(dtype), lin.weight, lin.bias)
    assert got.dtype == dtype and got.shape == (2, 20, 48)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= rtol * np.abs(ref).max(), err
    np.testing.assert_allclose(got[0, 3].float().numpy(), lp["bias"],
                               atol=1e-6 if dtype == torch.float32 else 1e-2)


def test_int8_linear_product_is_exact():
    """The int32 product of the port == numpy's int64 product."""
    rng = np.random.RandomState(4)
    a = rng.randint(-127, 128, (5, 40)).astype(np.int8)
    b = rng.randint(-127, 128, (24, 40)).astype(np.int8)
    got = k5.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64)
                                  @ b.astype(np.int64).T)


@pytest.mark.parametrize("approx", [False, True])
def test_unfused_mlp_matches_jax(approx):
    """quant.mlp with "xla": int8 fc1, GELU in the input type, int8 fc2;
    bf16 input (the serving type), one bf16 step of the output range plus
    the requantization of a bf16 hidden value that sits on a rounding
    boundary: 1e-2 x max |out|."""
    fc1, fc2 = _dense(64, 128, seed=5), _dense(128, 64, seed=6)
    x = np.random.RandomState(7).randn(3, 16, 64).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jq.mlp(jq.quantize_linear_params(fc1),
                            jq.quantize_linear_params(fc2), xj,
                            gelu_approx=approx), np.float32)
    got = tq.mlp(t(x).to(torch.bfloat16), _port_linear(fc1),
                 _port_linear(fc2), approx, "xla")
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


def _k5_inputs(m, seed, zero_rows=()):
    fc1, fc2 = _dense(128, 256, seed=seed), _dense(256, 128, seed=seed + 1)
    x = np.random.RandomState(seed + 2).randn(m, 128).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    return fc1, fc2, x


@pytest.mark.parametrize("m,zero_rows", [(224, ()), (96, (0, 5, 95)),
                                         (37, ())],
                         ids=["m224", "zero_rows", "ragged"])
def test_int8_mlp_reference_matches_jax_kernel(m, zero_rows):
    """K5's plain version == the JAX Pallas kernel in interpret mode, bf16
    in and out. The int32 sums are exact on both sides; only the fp32
    order of the dequantization and the GELU can move a hidden value
    across a requantization boundary (one int8 step of one hidden
    element), so: within one bf16 step at the output's largest magnitude
    (2^-7 x max |out|). Zero rows give gelu(b1) . W2 + b2, no NaN."""
    fc1, fc2, x = _k5_inputs(m, seed=8, zero_rows=zero_rows)
    q1, q2 = jq.quantize_linear_params(fc1), jq.quantize_linear_params(fc2)
    ref = np.asarray(j_int8_mlp(jnp.asarray(x, jnp.bfloat16), q1, q2,
                                block_m=32, interpret=True), np.float32)
    l1, l2 = _port_linear(fc1), _port_linear(fc2)
    got = k5.int8_mlp(t(x).to(torch.bfloat16), l1.weight.q, l1.weight.scale,
                      l1.bias, l2.weight.q, l2.weight.scale, l2.bias)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 128)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= 2.0 ** -7 * np.abs(ref).max(), err
    for r in zero_rows:
        h = jax.nn.gelu(jnp.asarray(fc1["bias"]), approximate=True)
        want = np.asarray(h @ fc2["kernel"] + fc2["bias"])
        assert np.abs(got[r] - want).max() < 0.05


def _k5_split(x, w1q, s1, b1, w2q, s2, b2, slices):
    """The kernel's decomposition in plain torch: fc1 and GELU per hidden
    slice (one per cluster CTA), each slice's row maxima of |h| max-combined
    across slices (the distributed-shared-memory exchange), each slice
    requantized with the combined scale, and fc2 as int32 partial products
    over the slices, summed, then dequantized. Returns (out, the combined
    row maxima, hq)."""
    k = x.shape[-1]
    n = w1q.shape[0]
    xq, row1 = k5.row_quant(x.reshape(-1, k).float())
    cols = torch.arange(n).reshape(slices, n // slices)
    hs = [k5.gelu_tanh_f32(k5.int8_matmul(xq, w1q[c]).float()
                           * (row1 * s1[c].float()) + b1[c].float())
          for c in cols]
    amax = torch.stack([h.abs().amax(dim=-1, keepdim=True) for h in hs])
    amax = amax.amax(dim=0)
    inv = amax.new_tensor(127.0) / amax.clamp_min(1e-20)
    hq = [torch.clamp(torch.round(h * inv), -127.0, 127.0).to(torch.int8)
          for h in hs]
    acc = sum(q.long() @ w2q[:, c].long().t() for q, c in zip(hq, cols))
    out = acc.float() * (amax * (1.0 / 127.0) * s2.float()) + b2.float()
    return out.to(x.dtype).reshape(x.shape), amax, torch.cat(hq, dim=-1)


@pytest.mark.parametrize("slices", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_mlp_cluster_split_is_bit_equal(slices, dtype):
    """K5's split over a cluster (hidden slices, max-combined row maxima,
    summed int32 fc2 partials) == ``int8_mlp_reference`` bit for bit, on a
    ragged M with zero rows: maxima and int32 sums do not depend on the
    order they are taken in, and every fp32 step is the same."""
    fc1, fc2, x = _k5_inputs(37, seed=21, zero_rows=(0, 36))
    l1, l2 = _port_linear(fc1), _port_linear(fc2)
    args = (t(x).to(dtype), l1.weight.q, l1.weight.scale, l1.bias,
            l2.weight.q, l2.weight.scale, l2.bias)
    ref = k5.int8_mlp_reference(*args)
    got, amax, hq = _k5_split(*args, slices)
    assert torch.equal(got, ref)
    xq, row1 = k5.row_quant(args[0].float())
    h = k5.gelu_tanh_f32(k5.int8_matmul(xq, l1.weight.q).float()
                         * (row1 * l1.weight.scale) + l1.bias)
    hq_full, row2 = k5.row_quant(h)
    assert torch.equal(amax * (1.0 / 127.0), row2)
    assert torch.equal(hq, hq_full)


def test_fused_dispatch_follows_the_gelu_flavour(monkeypatch):
    """"fused" runs K5 (its plain version on the CPU) only with the tanh
    GELU; the exact-GELU config takes the unfused path, as the JAX mlp
    does; "xla" never calls K5."""
    calls = []
    real = tq.int8_mlp

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tq, "int8_mlp", counted)
    fc1, fc2 = _dense(64, 128, seed=9), _dense(128, 64, seed=10)
    l1, l2 = _port_linear(fc1), _port_linear(fc2)
    x = t(np.random.RandomState(12).randn(8, 64)).to(torch.bfloat16)
    exact = tq.mlp(x, l1, l2, False, "fused")
    assert not calls
    torch.testing.assert_close(exact, tq.mlp(x, l1, l2, False, "xla"),
                               rtol=0, atol=0)
    tq.mlp(x, l1, l2, True, "xla")
    assert not calls
    fused = tq.mlp(x, l1, l2, True, "fused")
    assert len(calls) == 1
    ref = k5.int8_mlp_reference(x, l1.weight.q, l1.weight.scale, l1.bias,
                                l2.weight.q, l2.weight.scale, l2.bias)
    torch.testing.assert_close(fused, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mlp_impl"):
        tq.mlp(x, l1, l2, True, "auto")


def _quantized_pair(seed, **kw):
    cfg_j = jcfg.tiny_test_config(**kw)
    cfg_t = tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed)
    return cfg_j, cfg_t, params, jq.quantize_params(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_model_matches_jax(dtype):
    """A tiny int8 model (mlp targets): predict_image and
    predict_query_half_batch against the JAX quantized model. The JAX
    tree loaded into the port and ``quantize_model`` of the port's fp
    model give the same output bit for bit. fp32: 2e-4 on the painted
    scale (6 blocks of per-row requantization, where an fp32 sum in
    another order can move an activation by one int8 step); bf16 within
    the bf16 envelope of the port's fp model tests (0.1)."""
    cfg_j, cfg_t, params, params_q = _quantized_pair(
        13, seg_type_tokens=True, dtype=dtype)
    imgs, tgts, mask = stitched_batch(cfg_j, 2, seed=14)
    st = np.asarray([[0], [1]], np.int32)
    ref_img = np.asarray(jax.jit(lambda p, *a: jm.predict_image(
        p, cfg_j, *a))(params_q, imgs, tgts, mask, st))
    ref_half = np.asarray(jax.jit(lambda p, *a: jm.predict_query_half_batch(
        p, cfg_j, *a))(params_q, imgs, tgts, mask, st))
    qmodel = tq.quantize_model(port_model(cfg_t, params))
    from_tree = port_model(cfg_t, jax.tree_util.tree_map(np.asarray,
                                                         params_q))
    atol = 2e-4 if dtype == "float32" else 0.1
    with torch.no_grad():
        for m in (qmodel, from_tree):
            got_img = tm.predict_image(m, t(imgs), t(tgts), t(mask),
                                       seg_type=t(st, torch.long))
            got_half = tm.predict_query_half_batch(
                m, t(imgs), t(tgts), t(mask), seg_type=t(st, torch.long))
            np.testing.assert_allclose(got_img.numpy(), ref_img, atol=atol)
            np.testing.assert_allclose(got_half.numpy(), ref_half, atol=atol)
        a = tm.predict_image(qmodel, t(imgs), t(tgts), t(mask),
                             seg_type=t(st, torch.long))
        b = tm.predict_image(from_tree, t(imgs), t(tgts), t(mask),
                             seg_type=t(st, torch.long))
    assert torch.equal(a, b)


def test_engine_quant_plumbing():
    """InContextModel(quant=...): int8 serves the quantized copy (same
    painted output as the JAX engine on the JAX quantized tree, fp32, 2e-4
    as above); int8-fused sets every MLP to the fused kernel; the fp model
    it was given stays fp; unknown modes raise."""
    kw = dict(img_size=(64, 32), pretrain_img_size=32, seg_type_tokens=True)
    cfg_j, cfg_t, params, params_q = _quantized_pair(15, **kw)
    model = port_model(cfg_t, params)
    jax_eng = je.InContextModel(cfg_j, params_q, attn_impl="xla")
    res = cfg_t.img_size[1]
    rng = np.random.RandomState(16)
    img, tgt = te.build_prompt_batch(rng.rand(res, res, 3),
                                     [(rng.rand(res, res, 3),
                                       rng.rand(res, res, 3))])
    eng = te.InContextModel(cfg_t, model, device="cpu", quant="int8")
    assert isinstance(eng.model.blocks[0].mlp.fc1, tq.QuantizedLinear)
    assert eng.model.blocks[0].mlp.mlp_impl == "xla"
    assert isinstance(model.blocks[0].mlp.fc1, torch.nn.Linear)
    np.testing.assert_allclose(eng.run_one_image(img, tgt),
                               jax_eng.run_one_image(img, tgt), atol=2e-4)
    fused = te.InContextModel(cfg_t, model, device="cpu", quant="int8-fused")
    assert {b.mlp.mlp_impl for b in fused.model.blocks} == {"fused"}
    assert np.isfinite(fused.run_one_image(img, tgt)).all()
    with pytest.raises(ValueError, match="quant"):
        te.InContextModel(cfg_t, model, device="cpu", quant="int4")
