"""PyTorch port: the tiny in-context ViT in fp32 against the JAX model,
one set of weights carried across by ``state_dict_from_jax_params``.

Tolerances: pred atol 2e-5 / loss rtol 1e-5 (fp32 through 6 blocks, sums
in another order than XLA's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.models import incontext_vit as jm
from painter_tpu.train import checkpoint as jckpt
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.models import convert
from painter_tpu_torch.models import incontext_vit as tm

from torch_port_common import (jax_init_params_np, jax_params_np, port_model,
                               stitched_batch, t)

PRED_ATOL = 2e-5

VARIANTS = {
    "seggpt": dict(seg_type_tokens=True),
    "painter": dict(),
    "windowed": dict(window_block_indexes=(0, 1, 3),
                     window_rel_pos_tables=True, seg_type_tokens=True),
    "windowed_interp": dict(window_block_indexes=(1, 4)),
    "residual": dict(residual_block_indexes=(1, 4)),
}


def _jit(fn, cfg_j):
    """A jitted JAX model function with its config bound."""
    return jax.jit(lambda params, *args: fn(params, cfg_j, *args))


def _pair(variant, seed=0, **extra):
    kw = {**VARIANTS[variant], **extra}
    cfg_j = jcfg.tiny_test_config(**kw)
    cfg_t = tcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg_j, seed)
    return cfg_j, cfg_t, params, port_model(cfg_t, params)


def test_state_dict_matches_jax_exporter():
    """The port's own converter == the JAX package's torch exporter, key
    for key and value for value (windowed tables and residual blocks)."""
    kw = dict(window_block_indexes=(0, 3), window_rel_pos_tables=True,
              residual_block_indexes=(2,), seg_type_tokens=True)
    cfg = jcfg.tiny_test_config(**kw)
    params = jax_params_np(cfg, 1)
    ref = jckpt.params_to_torch_state_dict(params, cfg)
    got = convert.state_dict_from_jax_params(params,
                                             tcfg.tiny_test_config(**kw))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    model = tm.build_model(tcfg.tiny_test_config(**kw), device="cpu")
    assert set(model.state_dict()) == set(ref)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    cfg_j, cfg_t, params, model = _pair(variant)
    imgs, tgts, mask = stitched_batch(cfg_j, 2, seed=1)
    valid = np.ones_like(tgts)
    st = np.asarray([[0], [1]], np.int32)
    loss_j, pred_j, _ = _jit(jm.forward, cfg_j)(
        params, imgs, tgts, mask, valid, st)
    with torch.no_grad():
        loss_t, pred_t, _ = tm.forward(model, t(imgs), t(tgts), t(mask),
                                       t(valid), seg_type=t(st, torch.long))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=PRED_ATOL)


def _grid(shape, seed):
    n = int(np.prod(shape))
    return ((np.arange(n, dtype=np.float64).reshape(shape) * 0.001
             + seed * 0.1) % 1.0).astype(np.float32)


def test_golden_regression_values_reproduced():
    """tests/test_golden_regression.py's pinned numbers, through the port
    (JAX init weights at PRNGKey(0), zero rel tables as initialized)."""
    cfg_j = jcfg.tiny_test_config(seg_type_tokens=True)
    params = jax_init_params_np(cfg_j, 0)
    model = port_model(tcfg.tiny_test_config(seg_type_tokens=True), params)
    h, w = cfg_j.img_size
    length = cfg_j.num_patches
    mask = np.zeros((2, length), np.float32)
    mask[:, length // 2:] = 1.0
    with torch.no_grad():
        loss, pred, _ = tm.forward(
            model, t(_grid((2, h, w, 3), 1)), t(_grid((2, h, w, 3), 2)),
            t(mask), torch.ones(2, h, w, 3),
            seg_type=torch.tensor([[0], [1]]))
    p = pred.numpy()
    np.testing.assert_allclose(float(loss), 0.7525162100791931, rtol=1e-5)
    np.testing.assert_allclose(float(p.sum()), -2173.32861328125, rtol=1e-4)
    np.testing.assert_allclose(
        p[0, 0, :4], [0.8238483667373657, -0.24129362404346466,
                      -0.4575721025466919, 0.4909161329269409], rtol=1e-4)
    np.testing.assert_allclose(
        p[1, -1, -4:], [-0.5369495153427124, -0.13434115052223206,
                        -0.6072441339492798, -0.08763974905014038],
        rtol=1e-4)


@pytest.mark.parametrize("variant", ["seggpt", "windowed"])
def test_predict_query_half_ensemble_matches_jax(variant):
    """3 prompts with ensemble weights [.5, .3, .2]: the port's query half
    == JAX's, and == the bottom half of the port's full decode, which is
    identical across the prompt batch."""
    cfg_j, cfg_t, params, model = _pair(variant, seed=2)
    imgs, tgts, mask = stitched_batch(cfg_j, 3, seed=3)
    imgs[:, cfg_j.img_size[0] // 2:] = imgs[:1, cfg_j.img_size[0] // 2:]
    weights = np.asarray([0.5, 0.3, 0.2], np.float32)
    ref = jax.jit(lambda p, i, tg, m, w: jm.predict_query_half(
        p, cfg_j, i, tg, m, merge_between_batch=0, ensemble_weights=w))(
            params, imgs, tgts, mask, weights)
    with torch.no_grad():
        got = tm.predict_query_half(model, t(imgs), t(tgts), t(mask),
                                    merge_between_batch=0,
                                    ensemble_weights=t(weights))
        full = tm.predict_image(model, t(imgs), t(tgts), t(mask),
                                merge_between_batch=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PRED_ATOL)
    half = cfg_t.img_size[0] // 2
    # unweighted full decode: query halves identical across the batch,
    # but for the seam's first pixel row, whose 3x3 conv reads the
    # (per-sample) prompt row above it
    for i in range(1, 3):
        np.testing.assert_allclose(full[i, half + 1:].numpy(),
                                   full[0, half + 1:].numpy(), atol=1e-6)
    with torch.no_grad():
        mean_half = tm.predict_query_half(model, t(imgs), t(tgts), t(mask),
                                          merge_between_batch=0)
    # seam trick: decoding the query half == slicing the full decode
    np.testing.assert_allclose(mean_half.numpy(), full[0, half:].numpy(),
                               atol=1e-5)


def test_predict_query_half_batch_matches_jax():
    cfg_j, cfg_t, params, model = _pair("seggpt", seed=4)
    imgs, tgts, mask = stitched_batch(cfg_j, 3, seed=5)
    st = np.asarray([[0], [1], [0]], np.int32)
    ref = _jit(jm.predict_query_half_batch, cfg_j)(
        params, imgs, tgts, mask, st)
    with torch.no_grad():
        got = tm.predict_query_half_batch(model, t(imgs), t(tgts), t(mask),
                                          seg_type=t(st, torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PRED_ATOL)


def test_build_model_init_distributions():
    cfg = tcfg.tiny_test_config(seg_type_tokens=True,
                                residual_block_indexes=(1,))
    gen = torch.Generator().manual_seed(7)
    model = tm.build_model(cfg, gen, device="cpu")
    blk = model.blocks[0]
    w = blk.attn.qkv.weight
    assert w.abs().max() <= 0.04 + 1e-7 and 0.012 < w.std() < 0.02
    assert torch.count_nonzero(blk.attn.rel_pos_h) == 0
    assert torch.all(blk.norm1.weight == 1) and torch.all(blk.mlp.fc1.bias == 0)
    pe = model.patch_embed.proj.weight
    assert pe.abs().max() <= (3 * 8 * 8) ** -0.5
    assert torch.count_nonzero(model.blocks[1].residual.norm3.weight) == 0
    again = tm.build_model(cfg, torch.Generator().manual_seed(7),
                           device="cpu")
    assert torch.equal(again.blocks[2].mlp.fc2.weight,
                       model.blocks[2].mlp.fc2.weight)


def test_bf16_forward_close_to_jax():
    """bf16 compute on both sides: the same model within bf16's envelope
    (both round at slightly different places)."""
    cfg_j, cfg_t, params, model = _pair("seggpt", seed=6, dtype="bfloat16")
    imgs, tgts, mask = stitched_batch(cfg_j, 2, seed=7)
    ref = _jit(jm.predict_query_half_batch, cfg_j)(params, imgs, tgts,
                                                   mask)
    with torch.no_grad():
        got = tm.predict_query_half_batch(model, t(imgs), t(tgts), t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.1)


def _by_name(tree_np, cfg_t):
    return {k: v.numpy() for k, v in
            convert.state_dict_from_jax_params(tree_np, cfg_t).items()}


@pytest.mark.parametrize("impl", ["packed", "fused"])
def test_forward_decoder_impls_match_jax(impl):
    """forward_decoder with the packed tail (plain torch) and the fused
    tail (its plain versions on the CPU) against the JAX impl of the same
    name, fp32: the painted output 1e-5 and every decoder gradient 1e-4 x
    its max abs (sums in another order), and against the port's stock
    tail."""
    cfg_j, cfg_t, params, model = _pair("painter", seed=8, dtype="float32")
    gh, gw = cfg_j.grid_size
    rng = np.random.RandomState(9)
    feats = [(0.2 * rng.randn(2, gh, gw, cfg_j.embed_dim)).astype(np.float32)
             for _ in range(4)]
    wsum = rng.randn(2, *cfg_j.img_size, 3).astype(np.float32)

    def loss_j(p):
        return jnp.sum(wsum * jm.forward_decoder(p, cfg_j, feats,
                                                 decoder_impl=impl))

    params_j = jax.tree_util.tree_map(jnp.asarray, params)
    ref, gref = jax.value_and_grad(loss_j)(params_j)
    pred_j = jm.forward_decoder(params_j, cfg_j, feats, decoder_impl=impl)
    gref = _by_name(jax.tree_util.tree_map(np.asarray, gref), cfg_t)
    pred = tm.forward_decoder(model, [t(f) for f in feats],
                              decoder_impl=impl)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j),
                               atol=1e-5)
    loss = (pred * t(wsum)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for name, p in model.named_parameters():
        if name.startswith("decoder"):
            err = np.abs(p.grad.numpy() - gref[name]).max()
            assert err <= 1e-4 * np.abs(gref[name]).max(), (name, err)
    with torch.no_grad():
        stock = tm.forward_decoder(model, [t(f) for f in feats])
    np.testing.assert_allclose(pred.detach().numpy(), stock.numpy(),
                               atol=1e-5)


def test_forward_decoder_rejects_odd_packed_width_and_unknown_impl():
    cfg_j, cfg_t, params, model = _pair("painter", seed=10)
    d = cfg_t.embed_dim
    odd = [torch.zeros(1, 2, 1, d) for _ in range(4)]  # w*p = 8: even
    tm.forward_decoder(model, odd, decoder_impl="packed")
    with pytest.raises(ValueError, match="even painted width"):
        cfg_odd = tcfg.tiny_test_config(patch_size=7)
        with torch.device("meta"):
            m_odd = tm.InContextViT(cfg_odd)
        tm.forward_decoder(m_odd, [torch.zeros(1, 2, 1, d, device="meta")
                                   for _ in range(4)], decoder_impl="packed")
    with pytest.raises(ValueError, match="decoder_impl"):
        tm.forward_decoder(model, odd, decoder_impl="pallas")
