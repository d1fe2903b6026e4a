"""PyTorch port: the kernels' shape domain on the CPU.

The routers (``attention_route``, ``decoder_route``) against the JAX
kernels' domain (``_fold_axis``: hd + min(kh, kw) <= 128; the decoder tail
at any width the presets give); the ViT-L shapes keep the ViT-L kernels;
the width-generic kernels' transforms (head-dim zero-padding, channel
padding with LayerNorm over the real C, per-tile partial sums) on the
plain versions; and the models whose shapes reach the generic kernels on
the card -- tiny_test (global, and windowed with kw = 2) -- and a narrow
head_dim-64 model on the 80x40 grid of ``--input_size 1280 640`` (K1 and
K2 on the card) through the port against the JAX package on the same seeded numpy
weights and inputs (fp32: forward 1e-4, loss 1e-5 relative, each
gradient 1e-4 x its own max abs, as tests/test_torch_train.py holds
them).
"""
import jax
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.kernels import flash_relpos as jfr
from painter_tpu.models import incontext_vit as jm
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.kernels import decoder_head as dh
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm

from test_torch_generic_tail_tc import _tc_tail
from test_torch_narrow_tail import _narrow_tail
from torch_port_common import jax_params_np, port_model, stitched_batch, t

DTYPES = (torch.bfloat16, torch.float32)
# the JAX package's own kernel tests: K1/K2 at hd 16 on 8x4 and 12x6, hd
# 120 on 16x8 (folding w), gradients at hd 8 on 6x4
JAX_TEST_SHAPES = ((16, (8, 4)), (16, (12, 6)), (120, (16, 8)), (8, (6, 4)))
# (hd, grid) on both sides of the domain's edge hd + min(kh, kw) = 128
DOMAIN_EDGES = (((64, (80, 64)), True), ((65, (80, 64)), False),
                ((120, (16, 8)), True), ((121, (16, 8)), False),
                ((8, (120, 120)), True), ((8, (121, 121)), False),
                ((127, (3, 1)), True), ((128, (3, 1)), False),
                ((16, (8, 4)), True), ((125, (8, 4)), False))
GRAD_RTOL = 1e-4
PRED_ATOL = 1e-4
# db2 (decoder_pred.3.bias) at 1280x640 is a sum over 819,200 pixels,
# which XLA on the CPU adds in fp32 1.8e-4 x its max abs away from the
# port's float64 run, where the port's fp32 run lands 1.3e-7 away: against
# JAX it is held to 1e-3, and every gradient of that model is also held to
# the port's own float64 run at GRAD_RTOL
JAX_FP32_SUM_RTOL = {"grid80x40": {"decoder_pred.3.bias": 1e-3}}
# tiny_test, its windowed variant (2x2 windows: key grids of width 2),
# and a 4-block head_dim-64 model on the 80x40 grid (embed 128, 2 heads:
# narrow, so the CPU holds its (2, 3200, 3200) logits; four blocks, the
# fewest that give the decoder its four taps)
MODELS = {
    "tiny": dict(),
    "tiny_windowed": dict(window_block_indexes=(0, 3, 4)),
    "grid80x40": dict(img_size=(1280, 640), patch_size=16, embed_dim=128,
                      num_heads=2, depth=4, merge_idx=0,
                      out_indices=(0, 1, 2, 3), pretrain_img_size=224),
}


def _jax_message(hd, grid):
    with pytest.raises(ValueError) as info:
        jfr._fold_axis(hd, grid)
    return str(info.value)


# ---------------------------------------------------------------------------
# attention routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,grid", JAX_TEST_SHAPES)
def test_attention_route_takes_the_jax_tests_shapes(hd, grid):
    """Every shape the JAX package's kernel tests run goes to K1g / K2g,
    forward and backward, in both types."""
    jfr._fold_axis(hd, grid)  # inside the JAX domain
    for dtype in DTYPES:
        for backward in (False, True):
            assert fr.attention_route(hd, grid, grid[0] * grid[1], dtype,
                                      backward) == "generic"


@pytest.mark.parametrize("shape,inside", DOMAIN_EDGES)
def test_attention_route_domain_edges(shape, inside):
    """At the edge of the JAX domain: inside, a route; outside, the JAX
    kernel's own error, word for word."""
    hd, grid = shape
    length = grid[0] * grid[1]
    for dtype in DTYPES:
        for backward in (False, True):
            if inside:
                jfr._fold_axis(hd, grid)
                assert fr.attention_route(hd, grid, length, dtype,
                                          backward) in ("vitl", "generic")
            else:
                with pytest.raises(ValueError) as info:
                    fr.attention_route(hd, grid, length, dtype, backward)
                assert str(info.value) == _jax_message(hd, grid)


@pytest.mark.parametrize("grid,fwd,bwd", [
    ((56, 28), "vitl", "vitl"),      # 896x448
    ((70, 35), "vitl", "vitl"),      # 1120x560 (COCO eval)
    ((14, 14), "vitl", "vitl"),      # windows of the windowed preset
    ((80, 40), "vitl", "vitl"),      # 1280x640: fits K2's layouts
    ((90, 45), "vitl", "generic"),   # 1440x720, L = 4050: past them
    ((95, 95), "vitl", None),        # K1's own limit, past the JAX domain
])
def test_vitl_shapes_keep_their_routes(grid, fwd, bwd):
    """head_dim 64: every shape the ViT-L kernels took keeps them, and
    K2 takes 80x40 too; grids past K2's shared-memory layouts go to K2g;
    a grid neither takes raises."""
    length = grid[0] * grid[1]
    for dtype in DTYPES:
        assert fr.attention_route(64, grid, length, dtype) == fwd
        if bwd is None:
            with pytest.raises(ValueError, match="exceeds"):
                fr.attention_route(64, grid, length, dtype, backward=True)
        else:
            assert fr.attention_route(64, grid, length, dtype,
                                      backward=True) == bwd


def test_attention_route_refuses_uncovered_grids_and_types():
    with pytest.raises(ValueError, match="does not cover"):
        fr.attention_route(16, (8, 4), 30, torch.float32)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fr.attention_route(16, (8, 4), 32, torch.float16)


@pytest.mark.parametrize("hd,want", [(1, 16), (8, 16), (16, 16), (17, 32),
                                     (40, 64), (64, 64), (120, 128),
                                     (127, 128)])
def test_generic_head_dims(hd, want):
    assert fr.generic_head_dim(hd) == want


def _attn_inputs(bh, hd, grid, seed):
    rng = np.random.RandomState(seed)
    length = grid[0] * grid[1]
    q, k, v, do = (t(rng.randn(bh, length, hd)) for _ in range(4))
    rh, rw = t(rng.randn(bh, length, grid[0])), t(rng.randn(bh, length,
                                                            grid[1]))
    return q, k, v, do, rh, rw


@pytest.mark.parametrize("hd,grid", [(8, (6, 4)), (120, (16, 8)),
                                     (40, (12, 6)), (16, (8, 4))])
def test_head_dim_padding_on_plain_versions(hd, grid):
    """K1g / K2g's transform -- q, k, v, dout zero-padded to the built
    head dim, the padded columns sliced off, the scale the real head
    dim's -- run on the plain versions in fp32: the padded columns of out,
    dq, dk and dv come out exactly zero, and every output equals the
    unpadded plain version's within 1e-6 x its max abs. (Not bit for
    bit: the CPU GEMM picks its kernel by shape, so an (L, 8) and an
    (L, 16) right-hand side sum their products in other orders.)"""
    d = fr.generic_head_dim(hd)
    q, k, v, do, rh, rw = _attn_inputs(2, hd, grid, seed=hd)
    scale = hd ** -0.5
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rh, rw, grid,
                                                   scale)
    qp, kp, vp, dop = fr.pad_head_dim(d, q, k, v, do)
    assert qp.shape[-1] == d and torch.equal(qp[..., :hd], q)
    out_p, lse_p = fr.flash_attention_relpos_reference(qp, kp, vp, rh, rw,
                                                       grid, scale)
    grads = fr.flash_attention_relpos_bwd_reference(q, k, v, rh, rw, out,
                                                    lse, do, grid, scale)
    grads_p = fr.flash_attention_relpos_bwd_reference(
        qp, kp, vp, rh, rw, out_p, lse_p, dop, grid, scale)
    for name, got in (("out", out_p), ("dq", grads_p[0]),
                      ("dk", grads_p[1]), ("dv", grads_p[2])):
        assert torch.count_nonzero(got[..., hd:]) == 0, name
    unpadded = (*fr.unpad_head_dim(hd, out_p, *grads_p[:3]), lse_p,
                *grads_p[3:])
    for name, got, ref in zip(("out", "dq", "dk", "dv", "lse", "d_rel_h",
                               "d_rel_w"), unpadded,
                              (out, *grads[:3], lse, *grads[3:])):
        assert got.shape == ref.shape, name
        err = (got - ref).abs().max().item()
        assert err <= 1e-6 * ref.abs().max().item(), (name, err)


def test_generic_wrappers_on_the_cpu_run_plain_and_count_no_launch():
    """On CPU tensors K1g / K2g's wrappers, and the dispatchers that route
    to them, are the plain versions; no route counts a launch."""
    q, k, v, do, rh, rw = _attn_inputs(2, 16, (8, 4), seed=1)
    counters = (fr.flash_attention_relpos, fr.flash_attention_relpos_bwd,
                fr.flash_attention_relpos_generic,
                fr.flash_attention_relpos_bwd_generic)
    before = [c.launches for c in counters]
    ref = fr.flash_attention_relpos_reference(q, k, v, rh, rw, (8, 4), 0.25)
    for fn in (fr.flash_attention_relpos, fr.flash_attention_relpos_generic):
        got = fn(q, k, v, rh, rw, (8, 4), 0.25)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    args = (q, k, v, rh, rw, *ref, do, (8, 4), 0.25)
    gref = fr.flash_attention_relpos_bwd_reference(*args)
    for fn in (fr.flash_attention_relpos_bwd,
               fr.flash_attention_relpos_bwd_generic):
        assert all(torch.equal(a, b) for a, b in zip(fn(*args), gref))
    assert [c.launches for c in counters] == before


def test_generic_wrappers_refuse_other_devices():
    q, k, v, do, rh, rw = (x.to("meta") for x in
                           _attn_inputs(1, 16, (8, 4), seed=2))
    with pytest.raises(RuntimeError, match="no kernel"):
        fr.flash_attention_relpos_generic(q, k, v, rh, rw, (8, 4), 0.25)
    with pytest.raises(RuntimeError, match="no kernel"):
        fr.flash_attention_relpos_bwd_generic(
            q, k, v, rh, rw, q, q[..., 0].float(), do, (8, 4), 0.25)


# ---------------------------------------------------------------------------
# decoder-tail routes and K3g / K4g's transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,want", [(64, "vitl"), (8, "generic"),
                                    (16, "generic"), (40, "generic"),
                                    (128, "generic"), (1, "generic"),
                                    (129, "generic"), (0, None)])
def test_decoder_route(c, want):
    """C = 64 (the presets' ViT-L width) keeps K3 / K4 at any H and W;
    every other width >= 1 goes to K3g / K4g (past 128 too, as the JAX
    kernel takes any C); the domain's one edge is C = 0."""
    for dtype in DTYPES:
        if want is None:
            with pytest.raises(ValueError, match="C >= 1"):
                dh.decoder_route(c, dtype)
        else:
            assert dh.decoder_route(c, dtype) == want
    with pytest.raises(TypeError, match="bf16 or fp32"):
        dh.decoder_route(8, torch.float16)


def _tail_inputs(seed, b, h, w, c):
    rng = np.random.RandomState(seed)
    return (t(rng.randn(b, h, w, c)),
            t(rng.randn(c, c, 3, 3) * (9 * c) ** -0.5),
            t(rng.randn(c) * 0.1), t(1.0 + 0.1 * rng.randn(c)),
            t(rng.randn(c) * 0.1), t(rng.randn(3, c, 1, 1) * c ** -0.5),
            t(rng.randn(3) * 0.1), t(rng.randn(b, h, w, 3)))


def test_generic_tail_weight_layout():
    """The C = 64 kernels' packing at any width: W1 as (tap, c, o), b1 /
    LN / W2 in the input type, nothing padded (the narrow route stages
    the torch layouts itself, the tensor-core route packs its own)."""
    pix, w1, b1, lns, lnb, w2, _, _ = _tail_inputs(0, 1, 4, 4, 5)
    packed, pb1, plns, plnb, pw2 = dh._packed_params(pix, w1, b1, lns, lnb,
                                                     w2)
    assert packed.shape == (3, 3, 5, 5)
    assert torch.equal(packed, w1.permute(2, 3, 1, 0))
    for got, ref in ((pb1, b1), (plns, lns), (plnb, lnb)):
        assert torch.equal(got, ref)
    assert torch.equal(pw2, w2.reshape(3, 5).t())
    with pytest.raises(ValueError, match="do not fit C=5"):
        dh._packed_params(pix, w1[:4], b1, lns, lnb, w2)


def _k3g_k4g(pix, w1, b1, lns, lnb, w2, b2, go, approx):
    """K3g / K4g's arithmetic on the route ``generic_tail_route`` names:
    the narrow kernels' restatement at C <= 8 (tests/
    test_torch_narrow_tail.py: taps packed into K, quad sums, per-tile
    partials in the kernels' order), the tensor-core route's at C >= 9
    (tests/test_torch_generic_tail_tc.py, whole rows, one pixel slice)."""
    if dh.generic_tail_route(pix.shape[-1], pix.dtype) == "narrow":
        return _narrow_tail(pix, w1, b1, lns, lnb, w2, b2, go, approx)
    return _tc_tail(pix, w1, b1, lns, lnb, w2, b2, go, approx, False, 1)


@pytest.mark.parametrize("shape,c", [((2, 16, 12), 8), ((2, 12, 8), 8),
                                     ((1, 11, 21), 5), ((1, 9, 17), 40)])
@pytest.mark.parametrize("approx", [False, True])
def test_generic_tail_padded_arithmetic_matches_plain(shape, c, approx):
    """K3g / K4g's arithmetic on their route (the JAX tests' C = 8 at 16x12
    and 12x8, C 5 padded to 8 on a ragged grid: narrow; C 40: tensor
    cores) == the plain forward and backward in fp32 within 1e-5 x each
    output's max abs."""
    b, h, w = shape
    pix, w1, b1, lns, lnb, w2, b2, go = _tail_inputs(c + h, b, h, w, c)
    got = _k3g_k4g(pix, w1, b1, lns, lnb, w2, b2, go, approx)
    ref = (dh.fused_decoder_tail_reference(pix, w1, b1, lns, lnb, w2, b2,
                                           approx),
           *dh.fused_decoder_tail_bwd_reference(pix, w1, b1, lns, lnb, w2,
                                                go, approx))
    for name, a, r in zip(("out", "dpix", "dW1", "db1", "dln_scale",
                           "dln_bias", "dW2", "db2"), got, ref):
        assert a.shape == r.shape, name
        err = (a - r).abs().max().item()
        assert err <= 1e-5 * r.abs().max().item(), (name, err)


def test_generic_tail_wrappers_on_the_cpu_run_plain_and_count_no_launch():
    pix, w1, b1, lns, lnb, w2, b2, go = _tail_inputs(3, 2, 16, 12, 8)
    counters = (dh.fused_decoder_tail, dh.fused_decoder_tail_bwd,
                dh.fused_decoder_tail_generic,
                dh.fused_decoder_tail_bwd_generic)
    before = [c.launches for c in counters]
    ref = dh.fused_decoder_tail_reference(pix, w1, b1, lns, lnb, w2, b2,
                                          True)
    for fn in (dh.fused_decoder_tail, dh.fused_decoder_tail_generic):
        assert torch.equal(fn(pix, w1, b1, lns, lnb, w2, b2, True), ref)
    gref = dh.fused_decoder_tail_bwd_reference(pix, w1, b1, lns, lnb, w2,
                                               go, True)
    for fn in (dh.fused_decoder_tail_bwd, dh.fused_decoder_tail_bwd_generic):
        got = fn(pix, w1, b1, lns, lnb, w2, go, True)
        assert all(torch.equal(a, r) for a, r in zip(got, gref))
    assert [c.launches for c in counters] == before


def test_generic_sources_note_their_tpu_kernels():
    from painter_tpu_torch.kernels import build
    notes = {"flash_relpos_generic": (
        "painter_tpu/kernels/flash_relpos.py:_fwd_impl", "_bwd_impl"),
        "decoder_tail_generic": (
        "painter_tpu/kernels/decoder_head.py:_fwd_impl", "_bwd_impl")}
    for name, words in notes.items():
        assert name in build.SOURCES
        with open(f"{build.CSRC}/{name}.cu") as f:
            src = f.read()
        assert all(w in src for w in words) and 'extern "C"' in src, name
        assert build._target(name).startswith(build.BUILD_DIR)


# ---------------------------------------------------------------------------
# the models whose shapes reach the generic kernels, against JAX
# ---------------------------------------------------------------------------

def _model_pair(name, seed):
    kw = MODELS[name]
    cfg_j, cfg_t = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed=seed)
    return cfg_j, cfg_t, params


def _attention_shapes(monkeypatch):
    """Records (head_dim, key grid) of every attention forward and
    backward the port runs; returns the two lists."""
    shapes = {"fwd": [], "bwd": []}
    fwd, bwd = fr.flash_attention_relpos, fr.flash_attention_relpos_bwd

    def rec_fwd(q, k, v, rel_h, rel_w, k_size, scale):
        shapes["fwd"].append((q.shape[-1], tuple(k_size)))
        return fwd(q, k, v, rel_h, rel_w, k_size, scale)

    def rec_bwd(q, *rest):
        shapes["bwd"].append((q.shape[-1], tuple(rest[-2])))
        return bwd(q, *rest)

    monkeypatch.setattr(fr, "flash_attention_relpos", rec_fwd)
    monkeypatch.setattr(fr, "flash_attention_relpos_bwd", rec_bwd)
    return shapes


@pytest.mark.parametrize("name,routes", [
    ("tiny", {(16, (8, 4))}),
    ("tiny_windowed", {(16, (8, 4)), (16, (2, 2))}),
    ("grid80x40", {(64, (80, 40))})])
def test_models_reaching_generic_kernels_match_jax(monkeypatch, name,
                                                   routes):
    """Loss, prediction and every parameter's gradient of the port's
    training forward (drop-path 0, fp32, remat) == the JAX model's
    (``jax.value_and_grad``, XLA attention); the attention shapes the
    port runs are the ones the card routes to K1g / K2g (grid80x40: K1 and
    K2, the ViT-L kernels, at the grid of --input_size 1280 640)."""
    cfg_j, cfg_t, params = _model_pair(name, seed=5)
    n = 1 if name == "grid80x40" else 2
    imgs, tgts, mask = stitched_batch(cfg_j, n, seed=6)
    valid = np.ones_like(tgts)
    valid[:, :4] = 0.0

    def loss_fn(p):
        loss, pred, _ = jm.forward(p, cfg_j, imgs, tgts, mask, valid,
                                   train=True, rng=jax.random.PRNGKey(0),
                                   attn_impl="xla")
        return loss, pred

    (loss_j, pred_j), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    shapes = _attention_shapes(monkeypatch)
    model = port_model(cfg_t, params).train()
    loss_t, pred_t, _ = tm.forward(
        model, t(imgs), t(tgts), t(mask), t(valid), train=True,
        generator=torch.Generator().manual_seed(0), remat=True)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    np.testing.assert_allclose(pred_t.detach().numpy(), np.asarray(pred_j),
                               atol=PRED_ATOL)
    ref = {k: v.numpy() for k, v in convert.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads_j), cfg_t).items()}
    sums = JAX_FP32_SUM_RTOL.get(name, {})
    for pname, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - ref[pname]).max()
        rtol = sums.get(pname, GRAD_RTOL)
        assert err <= rtol * max(np.abs(ref[pname]).max(), 1e-30), \
            (pname, err)
    assert set(shapes["fwd"]) == set(shapes["bwd"]) == routes
    if sums:
        m64 = port_model(cfg_t, params).train().double()
        loss64, _, _ = tm.forward(
            m64, t(imgs, torch.float64), t(tgts, torch.float64),
            t(mask, torch.float64), t(valid, torch.float64), train=True,
            generator=torch.Generator().manual_seed(0), remat=True)
        loss64.backward()
        for (pname, p), p64 in zip(model.named_parameters(),
                                   m64.parameters()):
            err = (p.grad.double() - p64.grad).abs().max().item()
            assert err <= GRAD_RTOL * p64.grad.abs().max().item(), \
                (pname, err)
    for hd, grid in routes:
        length = grid[0] * grid[1]
        want = ("vitl", "vitl") if name == "grid80x40" else (
            "generic", "generic")
        assert (fr.attention_route(hd, grid, length, torch.bfloat16),
                fr.attention_route(hd, grid, length, torch.bfloat16,
                                   backward=True)) == want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_converter_maps_the_new_configs(name):
    """``state_dict_from_jax_params`` carries every leaf of the JAX tree
    of each new config into the port's names and shapes."""
    cfg_j, cfg_t, params = _model_pair(name, seed=7)
    sd = convert.state_dict_from_jax_params(params, cfg_t)
    model = tm.build_model(cfg_t, device="cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    np.testing.assert_array_equal(sd["blocks.1.attn.rel_pos_h"].numpy(),
                                  params["blocks"]["attn"]["rel_pos_h"][1])


def test_converter_maps_vit_large_at_1280x640():
    """Painter ViT-L built at 1280x640 (full width, one block: the CPU
    holds no 24-block ViT-L): its rel-pos tables are 159 x 64 and 79 x 64,
    and every leaf lands under the port's name and shape."""
    kw = dict(img_size=(1280, 640), depth=1, merge_idx=0,
              out_indices=(0,))
    cfg_j = jcfg.get_config(
        "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1", **kw)
    cfg_t = tcfg.get_config(
        "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1", **kw)
    shapes = jax.eval_shape(lambda k: jm.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape).astype(np.float32) if s.size < 2 ** 20
                   else np.zeros(s.shape, np.float32)), shapes)
    sd = convert.state_dict_from_jax_params(params, cfg_t)
    assert tuple(sd["blocks.0.attn.rel_pos_h"].shape) == (159, 64)
    assert tuple(sd["blocks.0.attn.rel_pos_w"].shape) == (79, 64)
    np.testing.assert_array_equal(sd["blocks.0.attn.rel_pos_w"].numpy(),
                                  params["blocks"]["attn"]["rel_pos_w"][0])
    with torch.device("meta"):
        model = tm.InContextViT(cfg_t)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
