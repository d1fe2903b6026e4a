"""PyTorch port: each op against its JAX function (CPU, fp32, atol 1e-6
unless a line says why)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu import configs as jcfg
from painter_tpu.ops import attention as j_att
from painter_tpu.ops import image as j_img
from painter_tpu.ops import norm as j_norm
from painter_tpu.ops import patches as j_patches
from painter_tpu.ops import pos_embed as j_pos
from painter_tpu.ops import quant as j_quant
from painter_tpu.ops import resample as j_res
from painter_tpu.ops import windows as j_win
from painter_tpu_torch import configs as tcfg
from painter_tpu_torch.ops import attention as t_att
from painter_tpu_torch.ops import image as t_img
from painter_tpu_torch.ops import norm as t_norm
from painter_tpu_torch.ops import patches as t_patches
from painter_tpu_torch.ops import pos_embed as t_pos
from painter_tpu_torch.ops import quant as t_quant
from painter_tpu_torch.ops import resample as t_res
from painter_tpu_torch.ops import windows as t_win

from torch_port_common import t

ATOL = 1e-6
RNG = np.random.RandomState(0)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match_field_for_field(name):
    j = jcfg.get_config(name)
    p = tcfg.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert p.grid_size == j.grid_size and p.head_dim == j.head_dim
    for dt in ("float32", "bfloat16"):
        assert tcfg.get_config(name, dtype=dt).compute_dtype == \
            getattr(torch, dt)
        assert (tcfg.get_config(name, dtype=dt).gelu_approximate
                == jcfg.get_config(name, dtype=dt).gelu_approximate)


def test_layer_norm():
    x = RNG.randn(3, 5, 16).astype(np.float32) * 3 + 1
    s = RNG.randn(16).astype(np.float32)
    b = RNG.randn(16).astype(np.float32)
    _close(t_norm.layer_norm(t(x), t(s), t(b), 1e-6),
           j_norm.layer_norm(jnp.asarray(x), s, b, 1e-6), 1e-5)


def test_patchify_roundtrip():
    x = RNG.randn(2, 32, 16, 3).astype(np.float32)
    got = t_patches.patchify(t(x), 8)
    _close(got, j_patches.patchify(jnp.asarray(x), 8), 0)
    _close(t_patches.unpatchify(got, 8), x, 0)


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("sizes", [(15, 23), (14, 8), (7, 7)])
def test_resize_weights_identical(mode, sizes):
    np.testing.assert_array_equal(t_res.resize_weights(*sizes, mode),
                                  j_res.resize_weights(*sizes, mode))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
def test_resize2d(mode):
    x = RNG.rand(2, 9, 7, 3).astype(np.float32)
    _close(t_res.resize2d(t(x), (12, 5), mode),
           j_res.resize2d(jnp.asarray(x), (12, 5), mode))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
def test_np_resize2d_matches_device_resize(mode):
    x = RNG.rand(9, 7, 3).astype(np.float32)
    _close(t_res.np_resize2d(x, (12, 5), mode),
           j_res.resize2d(jnp.asarray(x), (12, 5), mode, h_axis=0,
                          w_axis=1))


@pytest.mark.parametrize("hw", [(8, 4), (12, 6), (14, 14)])
def test_get_abs_pos(hw):
    table = RNG.randn(1, 14 * 14 + 1, 8).astype(np.float32)
    _close(t_pos.get_abs_pos(t(table), True, hw),
           j_pos.get_abs_pos(jnp.asarray(table), True, hw), 1e-5)


@pytest.mark.parametrize("q_size,table", [(8, 8), (12, 8), (6, 4), (14, 14)])
def test_get_rel_pos(q_size, table):
    """(12, 8) and (6, 4) are the 12x6 grid read through 8x4 tables: the
    linear-interpolation path."""
    rp = RNG.randn(2 * table - 1, 16).astype(np.float32)
    _close(t_pos.get_rel_pos(q_size, q_size, t(rp)),
           j_pos.get_rel_pos(q_size, q_size, jnp.asarray(rp)))


def test_sincos_identical():
    np.testing.assert_array_equal(
        t_pos.get_2d_sincos_pos_embed(16, 4, cls_token=True),
        j_pos.get_2d_sincos_pos_embed(16, 4, cls_token=True))


@pytest.mark.parametrize("hw,ws", [((8, 4), 2), ((7, 5), 3)])
def test_window_roundtrip(hw, ws):
    x = RNG.randn(2, *hw, 6).astype(np.float32)
    got, pad = t_win.window_partition(t(x), ws)
    ref, pad_j = j_win.window_partition(jnp.asarray(x), ws)
    assert pad == pad_j
    _close(got, ref, 0)
    _close(t_win.window_unpartition(got, ws, pad, hw), x, 0)


def test_linear():
    x = RNG.randn(4, 8).astype(np.float32)
    w = RNG.randn(8, 6).astype(np.float32)  # JAX (in, out)
    b = RNG.randn(6).astype(np.float32)
    _close(t_quant.linear(t(x), t(w.T), t(b)),
           j_quant.linear({"kernel": w, "bias": b}, jnp.asarray(x)), 1e-5)


def test_from_uint8_all_256_values_bit_exact():
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    host = (u.astype(np.float64) / 255.0).astype(np.float32)
    got = t_img.from_uint8(torch.from_numpy(u)).numpy()
    ref = np.asarray(j_img.from_uint8(jnp.asarray(u)))
    assert np.array_equal(got.view(np.uint32), host.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_to_uint8_255_matches_host_chain():
    x = np.concatenate([RNG.randn(512), np.linspace(-0.25, 1.25, 512),
                        np.arange(256) / 255.0]).astype(np.float32)
    host = np.clip(x * np.float32(255.0), 0, 255).astype(np.uint8)
    got = t_img.to_uint8_255(t(x)).numpy()
    assert np.array_equal(got, host)
    assert np.array_equal(got, np.asarray(j_img.to_uint8_255(
        jnp.asarray(x))))


def test_normalize_denormalize_stitch_mask():
    x = RNG.rand(2, 4, 4, 3).astype(np.float32)
    y = RNG.rand(2, 4, 4, 3).astype(np.float32)
    _close(t_img.normalize(t(x)), j_img.normalize(jnp.asarray(x)))
    _close(t_img.denormalize(t(x)), j_img.denormalize(jnp.asarray(x)))
    _close(t_img.stitch_pairs(t(x), t(y)),
           j_img.stitch_pairs(jnp.asarray(x), jnp.asarray(y)), 0)
    _close(t_img.bottom_half_mask(3, 10), j_img.bottom_half_mask(3, 10), 0)


@pytest.mark.parametrize("hw,table", [((8, 4), (8, 4)), ((12, 6), (8, 4))])
def test_rel_pos_bias(hw, table):
    q = RNG.randn(2, 3, hw[0] * hw[1], 16).astype(np.float32)
    rph = RNG.randn(2 * table[0] - 1, 16).astype(np.float32)
    rpw = RNG.randn(2 * table[1] - 1, 16).astype(np.float32)
    got = t_att.rel_pos_bias(t(q), t(rph), t(rpw), hw, hw)
    ref = j_att.rel_pos_bias(jnp.asarray(q), jnp.asarray(rph),
                             jnp.asarray(rpw), hw, hw)
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)
