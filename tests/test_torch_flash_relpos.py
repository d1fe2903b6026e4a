"""PyTorch port: K1's plain version against the JAX kernel (Pallas
interpret mode on the CPU, as tests/test_flash_relpos.py runs it) and
against the JAX stock attention path. fp32, atol 1e-5 (the sums run in
another order than the Pallas interpreter's); bf16 cases against the JAX
kernel in bf16, and the bf16 rounding point the CUDA kernel copies (P
rounded to bf16 before P.V) pinned exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.kernels.flash_relpos import (
    flash_attention_relpos as j_flash)
from painter_tpu.ops import attention as j_att
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.ops import attention as t_att

from torch_port_common import t

ATOL = 1e-5


def _inputs(b, nh, grid, table, hd=16, seed=0):
    rng = np.random.RandomState(seed)
    length = grid[0] * grid[1]
    q, k, v = (rng.randn(b, nh, length, hd).astype(np.float32)
               for _ in range(3))
    rph = rng.randn(2 * table[0] - 1, hd).astype(np.float32)
    rpw = rng.randn(2 * table[1] - 1, hd).astype(np.float32)
    return q, k, v, rph, rpw


def _port(q, k, v, rph, rpw, grid, fn=fr.flash_attention_relpos,
          dtype=torch.float32):
    b, nh, length, hd = q.shape
    q, k, v, rph, rpw = (t(a, dtype) for a in (q, k, v, rph, rpw))
    rel_h, rel_w = t_att.rel_pos_bias(q, rph, rpw, grid, grid)
    out, lse = fn(q.reshape(b * nh, length, hd),
                  k.reshape(b * nh, length, hd),
                  v.reshape(b * nh, length, hd),
                  rel_h.reshape(b * nh, length, grid[0]),
                  rel_w.reshape(b * nh, length, grid[1]), grid, hd ** -0.5)
    return out.reshape(b, nh, length, hd).float().numpy(), lse.numpy()


@pytest.mark.parametrize("block_q", [8, 24])  # divisible + ragged tail
def test_plain_matches_jax_kernel(block_q):
    q, k, v, rph, rpw = _inputs(2, 3, (8, 4), (8, 4))
    ref = j_flash(*map(jnp.asarray, (q, k, v, rph, rpw)), (8, 4), (8, 4),
                  16 ** -0.5, block_q=block_q, exp2_impl="native")
    got, _ = _port(q, k, v, rph, rpw, (8, 4),
                   fn=fr.flash_attention_relpos_reference)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("grid,table,block_q", [
    ((12, 6), (8, 4), 16),   # rel-table interpolation, ragged L=72
    ((7, 5), (7, 5), 8),     # kh != 2*kw, ragged L=35
])
def test_plain_matches_jax_kernel_other_grids(grid, table, block_q):
    q, k, v, rph, rpw = _inputs(1, 2, grid, table, seed=1)
    ref = j_flash(*map(jnp.asarray, (q, k, v, rph, rpw)), grid, grid,
                  16 ** -0.5, block_q=block_q, exp2_impl="native")
    got, _ = _port(q, k, v, rph, rpw, grid)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


# bf16 against the JAX kernel in bf16, max abs error over max |JAX|: both
# round activations to 8 mantissa bits (2^-9 relative) at other points --
# JAX feeds its logit matmul q * scale * log2e and the rel terms * log2e
# pre-rounded to bf16 and rounds unnormalized probabilities, the port
# rounds the normalized P -- so they differ by what JAX's bf16 kernel
# differs from its own fp32 run (6.7e-3 to 1.0e-2 measured on these
# inputs); the port measured 5.7e-3 to 9.3e-3
BF16_RTOL = 2e-2


def _bf16_exact(a):
    """numpy values that bf16 holds exactly, so both packages get the
    same bf16 inputs."""
    return t(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("grid,table,block_q", [
    ((8, 4), (8, 4), 8),
    ((7, 5), (7, 5), 8),     # kh != 2*kw, ragged L=35
])
def test_plain_bf16_matches_jax_kernel(grid, table, block_q):
    q, k, v, rph, rpw = (_bf16_exact(a)
                         for a in _inputs(1, 2, grid, table, seed=6))
    ref = np.asarray(j_flash(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, rph, rpw)),
        grid, grid, 16 ** -0.5, block_q=block_q, exp2_impl="native"),
        np.float32)
    got, _ = _port(q, k, v, rph, rpw, grid,
                   fn=fr.flash_attention_relpos_reference,
                   dtype=torch.bfloat16)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= BF16_RTOL, err


@pytest.mark.parametrize("grid", [(8, 4), (7, 5)])
def test_plain_bf16_rounds_p_before_pv(grid):
    """The rounding point K1's bf16 kernel copies: P = softmax(S) in fp32,
    rounded to bf16, then P.V summed in fp32 and rounded once. Exact on
    the CPU; not rounding P gives another output."""
    q, k, v, rph, rpw = _inputs(1, 2, grid, grid, seed=7)
    length = grid[0] * grid[1]
    tq, tk, tv = (t(a, torch.bfloat16).reshape(2, length, 16)
                  for a in (q, k, v))
    rel_h, rel_w = (x.reshape(2, length, -1) for x in t_att.rel_pos_bias(
        tq.reshape(1, 2, length, 16), t(rph, torch.bfloat16),
        t(rpw, torch.bfloat16), grid, grid))
    out, _ = fr.flash_attention_relpos_reference(tq, tk, tv, rel_h, rel_w,
                                                 grid, 0.25)
    s = torch.matmul(tq.float() * 0.25, tk.float().transpose(1, 2))
    s = (s.view(2, length, *grid) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(2, length, length)
    p = torch.softmax(s, dim=-1)
    rounded = torch.matmul(p.to(torch.bfloat16).float(), tv.float())
    unrounded = torch.matmul(p, tv.float())
    assert torch.equal(out, rounded.to(torch.bfloat16))
    assert not torch.equal(out, unrounded.to(torch.bfloat16))


@pytest.mark.parametrize("grid", [(8, 4), (7, 5)])
def test_lse_is_natural_logsumexp_of_biased_logits(grid):
    q, k, v, rph, rpw = _inputs(1, 2, grid, grid, seed=2)
    _, lse = _port(q, k, v, rph, rpw, grid)
    length = grid[0] * grid[1]
    rel_h, rel_w = j_att.rel_pos_bias(*map(jnp.asarray, (q, rph, rpw)),
                                      grid, grid)
    s = jnp.einsum("bnqd,bnkd->bnqk", jnp.asarray(q) * 16 ** -0.5,
                   jnp.asarray(k)).reshape(1, 2, *grid, *grid)
    s = (s + rel_h[..., None] + rel_w[..., None, :]).reshape(
        1, 2, length, length)
    ref = jax.nn.logsumexp(s, axis=-1).reshape(2, length)
    np.testing.assert_allclose(lse, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("grid,table", [((8, 4), (8, 4)), ((12, 6), (8, 4))])
def test_attention_matches_jax_xla(grid, table):
    """The port's full attention op (qkv, K1's plain version, proj)
    against the JAX stock path, one set of weights."""
    rng = np.random.RandomState(3)
    c, nh = 32, 2
    x = rng.randn(2, *grid, c).astype(np.float32)
    wq = (rng.randn(c, 3 * c) * 0.2).astype(np.float32)
    bq = rng.randn(3 * c).astype(np.float32)
    wp = (rng.randn(c, c) * 0.2).astype(np.float32)
    bp = rng.randn(c).astype(np.float32)
    rph = rng.randn(2 * table[0] - 1, c // nh).astype(np.float32)
    rpw = rng.randn(2 * table[1] - 1, c // nh).astype(np.float32)
    ref = j_att.attention(
        jnp.asarray(x), {"qkv": {"kernel": wq, "bias": bq},
                         "proj": {"kernel": wp, "bias": bp}},
        nh, grid, rel_pos=(jnp.asarray(rph), jnp.asarray(rpw)), impl="xla")
    for impl in ("kernel", "plain"):
        got = t_att.attention(t(x), t(wq.T), t(bq), t(wp.T), t(bp), nh, grid,
                              rel_pos=(t(rph), t(rpw)), attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_attention_without_rel_pos_matches_jax():
    rng = np.random.RandomState(4)
    c, nh, grid = 32, 2, (4, 2)
    x = rng.randn(1, *grid, c).astype(np.float32)
    wq = (rng.randn(c, 3 * c) * 0.2).astype(np.float32)
    wp = (rng.randn(c, c) * 0.2).astype(np.float32)
    zq, zp = np.zeros(3 * c, np.float32), np.zeros(c, np.float32)
    ref = j_att.attention(jnp.asarray(x),
                          {"qkv": {"kernel": wq, "bias": zq},
                           "proj": {"kernel": wp, "bias": zp}}, nh, grid)
    got = t_att.attention(t(x), t(wq.T), t(zq), t(wp.T), t(zp), nh, grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    q, k, v, rph, rpw = _inputs(1, 2, (8, 4), (8, 4), seed=5)
    before = fr.flash_attention_relpos.launches
    got, lse = _port(q, k, v, rph, rpw, (8, 4))
    ref, ref_lse = _port(q, k, v, rph, rpw, (8, 4),
                         fn=fr.flash_attention_relpos_reference)
    assert np.array_equal(got, ref) and np.array_equal(lse, ref_lse)
    assert fr.flash_attention_relpos.launches == before


def test_unknown_attn_impl_raises():
    x = torch.zeros(1, 2, 2, 8)
    w = torch.zeros(24, 8)
    with pytest.raises(ValueError, match="attn_impl"):
        t_att.attention(x, w, None, torch.zeros(8, 8), None, 1, (2, 2),
                        attn_impl="xla")


def _kernel_args(hd=64, dtype=torch.bfloat16, k_size=(56, 28)):
    bh, length, kh, kw = 2, 1568, 56, 28
    q = torch.zeros(bh, length, hd, dtype=dtype)
    return (q, q.clone(), q.clone(), torch.zeros(bh, length, kh, dtype=dtype),
            torch.zeros(bh, length, kw, dtype=dtype), k_size)


@pytest.mark.parametrize("change,match", [
    (dict(hd=101), "head_dim"),  # 101 + min(56, 28) = 129 > 128
    (dict(k_size=(50, 28)), "does not cover"),
    (dict(dtype=torch.float16), "bf16 or fp32"),
])
def test_kernel_input_checks(change, match):
    """What the CUDA wrapper refuses before it would launch: its layout
    checks and its route, which raises outside the JAX kernel's domain
    (hd + min(kh, kw) <= 128) as ``_fold_axis`` does."""
    with pytest.raises((ValueError, TypeError), match=match):
        fr._check(*_kernel_args(**change))


def test_kernel_checks_layout():
    q, k, v, rh, rw, ks = _kernel_args()
    fr._check(q, k, v, rh, rw, ks)  # the main path's shapes pass
    with pytest.raises(ValueError, match="contiguous"):
        fr._check(q, k, v, rh.transpose(0, 1).contiguous().transpose(0, 1),
                  rw, ks)
    with pytest.raises(ValueError, match="shape"):
        fr._check(q, k[:1], v, rh, rw, ks)


def test_build_target_is_keyed_by_source_and_flags():
    """Import needs no nvcc; the library name carries a hash of the
    source and flags, under the build directory that .gitignore lists."""
    path = build._target("flash_relpos_fwd")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    assert "flash_relpos_fwd-" in path
    with open("/".join([build.CSRC, "flash_relpos_fwd.cu"])) as f:
        src = f.read()
    assert "painter_tpu/kernels/flash_relpos.py:_fwd_impl" in src
