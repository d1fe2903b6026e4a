"""PyTorch port: the width-generic attention (K1g, K2g) on Hopper's tensor
cores, on the CPU.

(a) A torch restatement of the kernels' arithmetic
(``kernels/csrc/flash_relpos_generic.cu``): head dims padded to 16 / 32 /
64 / 128; key (query) tiles of 64 rows where a row of the padded head dim
fits 128 bytes, else 32, walked in order; the bias (rel_h + rel_w) log2(e)
per (query, key) cell; the online softmax in the exp2 domain; P rounded to
the input type before P.V and dv, dS before dq, dk and both rel-bias sums;
each tile's product in its own accumulator, added into the running sum;
fp32 products in 3xTF32 (big + small tf32 parts, three products), the
head-dim products in chunks of four k8 steps; d rel_h summed per grid row
in key order, d rel_w added key by key into per-column totals. It is held
to the JAX Pallas kernel in interpret mode (fp32, the forward and, at two
shapes, its vjp through the rel-pos tables) at the JAX tests' shapes and
the route's odd grids, and to the plain versions and float64 at full-size
grids with BH 1.
(b) The routes at the full-size shapes the kernels now carry.
(c) Index models: the key-grid walk of a tile (its rows and columns, and
the d rel sums' incremental walk against division) for kw 1-200, and the
swizzled tile layouts' bytes against the launchers' shared memory.
Inputs are numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.kernels.flash_relpos import (
    flash_attention_relpos as j_flash)
from painter_tpu_torch import configs
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.ops import attention as t_att

from torch_port_common import t

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# chip_smoke.py's limits for K1g / K2g against the plain versions: max abs
# error over max |reference| per output, bf16 2e-2 (bf16 rounding of P,
# dS and the outputs, in another summation order), fp32 1e-4 (the fp32
# route's: 3xTF32 keeps ~21 bits of each operand)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SMEM_OPTIN = 232448    # the dynamic shared memory a block may opt into
REL_SMEM_MAX = 64      # d rel_w totals in shared memory up to this kw


# ---------------------------------------------------------------------------
# (a) the arithmetic
# ---------------------------------------------------------------------------

def tf32_rn(x):
    """fp32 -> the nearest tf32, ties away (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b in 3xTF32, each product's sums in fp32."""
    ab = tf32_rn(a)
    as_ = tf32_rn(a - ab)
    bb = tf32_rn(b)
    bs = tf32_rn(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def tile_rows(d, dtype):
    """Rows of a streamed tile: 64 where a row of head dim d fits one
    128-byte swizzle row, else 32."""
    return 64 if d * torch.finfo(dtype).bits // 8 <= 128 else 32


def head_product(a, b, dtype):
    """a . b^T summed over the (padded) head dim: bf16 products summed in
    fp32; fp32 in 3xTF32, four k8 steps (32 columns) a chunk, each chunk
    in its own accumulator added into the total."""
    if dtype == torch.bfloat16:
        return a @ b.T
    out = None
    for c0 in range(0, a.shape[-1], 32):
        part = mm3(a[:, c0:c0 + 32], b[:, c0:c0 + 32].T)
        out = part if out is None else out + part
    return out


def tile_product(p, b, dtype):
    """p . b summed over a tile's rows (P.V, dS.K, P^T.dO, dS^T.Q)."""
    return p @ b if dtype == torch.bfloat16 else mm3(p, b)


def rnd(x, dtype):
    """x rounded to the input type, as fp32."""
    return x.to(dtype).float()


def bias_cells(rel_h, rel_w, queries, keys, kw):
    """(rel_h[q, kr] + rel_w[q, kc]) log2(e) of each (query, key) cell."""
    kr, kc = keys // kw, keys % kw
    return (rel_h[queries][:, kr] + rel_w[queries][:, kc]) * LOG2E


def k1g_model(q, k, v, rel_h, rel_w, k_size, scale):
    """K1g's arithmetic on (L, hd) tensors of one head -> (out, lse)."""
    dtype = q.dtype
    length, hd = q.shape
    d = fr.generic_head_dim(hd)
    qf, kf, vf = (x.float() for x in fr.pad_head_dim(d, q, k, v))
    rh, rw = rel_h.float(), rel_w.float()
    bn = tile_rows(d, dtype)
    sc = scale * LOG2E
    rows = torch.arange(length)
    m = torch.full((length,), -float("inf"))
    l = torch.zeros(length)
    o = torch.zeros(length, d)
    for k0 in range(0, length, bn):
        keys = torch.arange(k0, min(k0 + bn, length))
        x = head_product(qf, kf[keys], dtype) * sc + bias_cells(
            rh, rw, rows, keys, k_size[1])
        m_new = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[:, None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None] + tile_product(rnd(p, dtype), vf[keys], dtype)
        m = m_new
    out = (o / l[:, None]).to(dtype)[:, :hd]
    return out, (m + torch.log2(l)) * LN2


def k2g_model(q, k, v, rel_h, rel_w, out, lse, dout, k_size, scale):
    """K2g's arithmetic on one head -> (dq, dk, dv, d_rel_h, d_rel_w):
    (a) walks key tiles for dq and the rel sums, (b) query tiles for dk,
    dv in the transposed orientation."""
    dtype = q.dtype
    length, hd = q.shape
    kh, kw = k_size
    d = fr.generic_head_dim(hd)
    qf, kf, vf, dof = (x.float() for x in fr.pad_head_dim(d, q, k, v,
                                                         dout))
    rh, rw = rel_h.float(), rel_w.float()
    lse2 = lse * LOG2E
    delta = (dout.float() * out.float()).sum(-1)
    bn = tile_rows(d, dtype)
    sc = scale * LOG2E
    rows = torch.arange(length)
    # (a) dq; the dS tiles kept for the rel sums
    dq = torch.zeros(length, d)
    ds_all = torch.zeros(length, length)
    for k0 in range(0, length, bn):
        keys = torch.arange(k0, min(k0 + bn, length))
        s = head_product(qf, kf[keys], dtype)
        dp = head_product(dof, vf[keys], dtype)
        p = torch.exp2(s * sc + bias_cells(rh, rw, rows, keys, kw)
                       - lse2[:, None])
        ds = rnd(p * (dp - delta[:, None]), dtype)
        dq = dq + tile_product(ds, kf[keys], dtype)
        ds_all[:, keys] = ds
    # the rel sums in key order: a running sum per grid row, each key's
    # dS added into its column's total
    ds4 = ds_all.view(length, kh, kw)
    d_rel_h = torch.zeros(length, kh)
    for c in range(kw):
        d_rel_h = d_rel_h + ds4[:, :, c]
    d_rel_w = torch.zeros(length, kw)
    for b in range(kh):
        d_rel_w = d_rel_w + ds4[:, b, :]
    # (b) dk, dv per key tile over query tiles (S^T = K . Q^T)
    dk = torch.zeros(length, d)
    dv = torch.zeros(length, d)
    for q0 in range(0, length, bn):
        queries = torch.arange(q0, min(q0 + bn, length))
        st = head_product(kf, qf[queries], dtype)
        dpt = head_product(vf, dof[queries], dtype)
        pt = torch.exp2(st * sc + bias_cells(rh, rw, queries, rows, kw).T
                        - lse2[queries][None, :])
        dst = rnd(pt * (dpt - delta[queries][None, :]), dtype)
        dv = dv + tile_product(rnd(pt, dtype), dof[queries], dtype)
        dk = dk + tile_product(dst, qf[queries], dtype)
    return ((dq * scale).to(dtype)[:, :hd], (dk * scale).to(dtype)[:, :hd],
            dv.to(dtype)[:, :hd], d_rel_h.to(dtype), d_rel_w.to(dtype))


def _per_head(fn, *tensors, **kw):
    outs = [fn(*(x[i] for x in tensors), **kw)
            for i in range(tensors[0].shape[0])]
    return tuple(torch.stack(z) for z in zip(*outs))


def model_fwd(q, k, v, rel_h, rel_w, k_size, scale):
    return _per_head(k1g_model, q, k, v, rel_h, rel_w, k_size=k_size,
                     scale=scale)


def model_bwd(q, k, v, rel_h, rel_w, out, lse, dout, k_size, scale):
    return _per_head(k2g_model, q, k, v, rel_h, rel_w, out, lse, dout,
                     k_size=k_size, scale=scale)


class Model(torch.autograd.Function):
    """The modelled K1g forward and K2g backward."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, k_size, scale):
        out, lse = model_fwd(q, k, v, rel_h, rel_w, k_size, scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.k_size, ctx.scale = k_size, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        grads = model_bwd(q, k, v, rel_h, rel_w, out, lse,
                          dout.contiguous(), ctx.k_size, ctx.scale)
        return (*grads, None, None)


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


# the JAX tests' kernel shapes (hd, grid) and the route's odd grids (kw 3,
# past a 64-key tile; kw 200, past the shared d rel_w totals); the backward
# is held to the JAX kernel's vjp at hd 120 (padded to 128) and at 2x200
# (each costs ~3 s of the interpreter), the others to the plain version
JAX_SHAPES = ((16, (8, 4), False), (16, (12, 6), False),
              (120, (16, 8), True), (8, (6, 4), False),
              (32, (40, 3), False), (32, (2, 200), True))


@pytest.mark.parametrize("hd,grid,vjp", JAX_SHAPES)
def test_model_matches_jax_kernel_interpret(hd, grid, vjp):
    """fp32: the modelled K1g forward (and K2g backward), through the
    rel-term einsum to the tables as the port's Function carries them,
    against the JAX kernel in interpret mode (and its vjp) within the fp32
    limit, 1e-4 of max |reference| per output; without the vjp the modelled
    backward against the plain one at that limit. B 1, 2 heads."""
    assert fr.attention_route(hd, grid, grid[0] * grid[1],
                              torch.float32) == "generic"
    rng = np.random.RandomState(hd + grid[1])
    length = grid[0] * grid[1]
    q, k, v, g = (rng.randn(1, 2, length, hd).astype(np.float32)
                  for _ in range(4))
    rph = (0.2 * rng.randn(2 * grid[0] - 1, hd)).astype(np.float32)
    rpw = (0.2 * rng.randn(2 * grid[1] - 1, hd)).astype(np.float32)
    scale = hd ** -0.5

    def j_out(*a):
        return j_flash(*a, grid, grid, scale)

    jargs = tuple(map(jnp.asarray, (q, k, v, rph, rpw)))
    if vjp:
        ref_out, pullback = jax.vjp(j_out, *jargs)
        ref_grads = pullback(jnp.asarray(g))
    else:
        ref_out = j_out(*jargs)

    leaves = [t(a).requires_grad_() for a in (q, k, v, rph, rpw)]
    tq, tk, tv, trph, trpw = leaves
    rel_h, rel_w = t_att.rel_pos_bias(tq, trph, trpw, grid, grid)
    heads = [x.reshape(2, length, hd) for x in (tq, tk, tv)]
    rel = (rel_h.reshape(2, length, grid[0]),
           rel_w.reshape(2, length, grid[1]))
    out = Model.apply(*heads, *rel, grid, scale).reshape(1, 2, length, hd)
    assert _rel_err(out.detach().numpy(), np.asarray(ref_out)) <= \
        TOL[torch.float32]
    if vjp:
        got = torch.autograd.grad(out, leaves, t(g))
        for name, a, b in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"),
                              got, ref_grads):
            assert _rel_err(a.numpy(), b) <= TOL[torch.float32], name
        return
    args = [x.detach() for x in heads + list(rel)]
    ref, lse = fr.flash_attention_relpos_reference(*args, grid, scale)
    bwd = (*args, ref, lse, t(g).reshape(2, length, hd), grid, scale)
    for name, a, b in zip(("dq", "dk", "dv", "d_rel_h", "d_rel_w"),
                          model_bwd(*bwd),
                          fr.flash_attention_relpos_bwd_reference(*bwd)):
        assert _rel_err(a, b) <= TOL[torch.float32], name


def _head_inputs(hd, grid, seed, dtype, bh=1):
    rng = np.random.RandomState(seed)
    length = grid[0] * grid[1]
    q, k, v, dout = (torch.from_numpy(rng.randn(bh, length, hd).astype(
        np.float32)).to(dtype) for _ in range(4))
    rel_h, rel_w = (torch.from_numpy(rng.randn(bh, length, n).astype(
        np.float32)).to(dtype) for n in grid)
    return q, k, v, rel_h, rel_w, dout


@pytest.mark.parametrize("hd,grid", [(16, (8, 4)), (120, (16, 8)),
                                     (32, (2, 200)), (8, (6, 4))])
def test_bf16_model_against_plain_versions(hd, grid):
    """bf16: the modelled K1g / K2g against the plain versions on the same
    bf16 inputs (both round P and dS to bf16, in other orders), within the
    bf16 limit (2e-2 of max |plain| per output; lse within 1e-3, as
    chip_smoke.py holds K1g), BH 2."""
    q, k, v, rel_h, rel_w, dout = _head_inputs(hd, grid, 11, torch.bfloat16,
                                               bh=2)
    scale = hd ** -0.5
    out, lse = model_fwd(q, k, v, rel_h, rel_w, grid, scale)
    ref, ref_lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                       grid, scale)
    assert _rel_err(out.float(), ref.float()) <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max() <= 1e-3
    args = (q, k, v, rel_h, rel_w, ref, ref_lse, dout, grid, scale)
    got = model_bwd(*args)
    want = fr.flash_attention_relpos_bwd_reference(*args)
    for name, a, b in zip(("dq", "dk", "dv", "d_rel_h", "d_rel_w"), got,
                          want):
        assert _rel_err(a.float(), b.float()) <= TOL[torch.bfloat16], name


def _f64(q, k, v, rel_h, rel_w, dout, k_size, scale):
    """The forward and the five backward outputs in float64, directly."""
    q, k, v, rel_h, rel_w, dout = (x.double() for x in
                                   (q, k, v, rel_h, rel_w, dout))
    length = q.shape[1]
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        -1, length, length)
    p = torch.softmax(q @ k.transpose(1, 2) * scale + bias, -1)
    out = p @ v
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (dout @ v.transpose(1, 2) - delta)
    ds4 = ds.view(-1, length, *k_size)
    return out, (ds @ k * scale, ds.transpose(1, 2) @ q * scale,
                 p.transpose(1, 2) @ dout, ds4.sum(-1), ds4.sum(-2))


@pytest.mark.parametrize("hd,grid,dtype", [
    (64, (90, 45), torch.float32),    # the 1440x720 update's backward
    (80, (56, 28), torch.float32),    # a ViT-H-width head, padded to 128
    (64, (90, 45), torch.bfloat16),
])
def test_model_at_full_size(hd, grid, dtype):
    """The modelled kernels at full-size grids, BH 1: fp32 within 1e-4 of
    float64 and of the plain versions (whose products are fp32); bf16
    within 2e-2 of the plain versions on the same bf16 inputs."""
    q, k, v, rel_h, rel_w, dout = _head_inputs(hd, grid, 21, dtype)
    scale = hd ** -0.5
    out, lse = model_fwd(q, k, v, rel_h, rel_w, grid, scale)
    ref, ref_lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                       grid, scale)
    assert _rel_err(out.float(), ref.float()) <= TOL[dtype]
    args = (q, k, v, rel_h, rel_w, ref, ref_lse, dout, grid, scale)
    got = model_bwd(*args)
    want = fr.flash_attention_relpos_bwd_reference(*args)
    names = ("dq", "dk", "dv", "d_rel_h", "d_rel_w")
    for name, a, b in zip(names, got, want):
        assert _rel_err(a.float(), b.float()) <= TOL[dtype], name
    if dtype == torch.float32:
        out64, grads64 = _f64(q, k, v, rel_h, rel_w, dout, grid, scale)
        assert _rel_err(out, out64) <= TOL[dtype]
        grads = model_bwd(q, k, v, rel_h, rel_w, out, lse, dout, grid, scale)
        for name, a, b in zip(names, grads, grads64):
            assert _rel_err(a, b) <= TOL[dtype], name


def test_model_pads_head_dims_and_tiles_as_the_kernels():
    """The restatement's tiles follow the kernels' rule, and its padding
    is the wrapper's: hd 80 runs at D 128 in 32-row tiles (bf16 and fp32),
    hd 64 in 64-row tiles in bf16 and 32 in fp32, hd 16 / 32 in 64."""
    assert [fr.generic_head_dim(h) for h in (8, 16, 32, 64, 80, 120)] == [
        16, 16, 32, 64, 128, 128]
    rows = {(d, dt): tile_rows(d, dt) for d in fr.GENERIC_HEAD_DIMS
            for dt in (torch.bfloat16, torch.float32)}
    assert rows == {(16, torch.bfloat16): 64, (16, torch.float32): 64,
                    (32, torch.bfloat16): 64, (32, torch.float32): 64,
                    (64, torch.bfloat16): 64, (64, torch.float32): 32,
                    (128, torch.bfloat16): 32, (128, torch.float32): 32}


# ---------------------------------------------------------------------------
# (b) the routes at the full-size shapes
# ---------------------------------------------------------------------------

PAINTER = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"


@pytest.mark.parametrize("img_size,fwd,bwd", [
    ((1440, 720), "vitl", "generic"),     # 90x45: 135 <= 190, > 127
    ((2048, 1024), "generic", "generic"),  # 128x64: 192 > 190, 64 + 64
    ((1280, 640), "vitl", "vitl"),        # 80x40: K1 / K2 (PR 15's grid)
])
def test_painter_vit_large_routes(img_size, fwd, bwd):
    """Painter ViT-L's global blocks at 1440x720 (forward on K1, the whole
    backward on K2g in both types) and at 2048x1024 (the domain's edge:
    hd 64 + min(128, 64) = 128; forward on K1g)."""
    cfg = configs.get_config(PAINTER, img_size=img_size)
    grid = (img_size[0] // 16, img_size[1] // 16)
    hd = cfg.embed_dim // cfg.num_heads
    assert hd == 64 and cfg.num_patches == grid[0] * grid[1]
    for dtype in (torch.bfloat16, torch.float32):
        assert fr.attention_route(hd, grid, cfg.num_patches, dtype) == fwd
        assert fr.attention_route(hd, grid, cfg.num_patches, dtype,
                                  backward=True) == bwd


def test_wide_head_and_past_the_edge_routes():
    """hd 80 at 56x28 (80 + 28 = 108) takes K1g / K2g at D 128; one grid
    row more than 2048x1024's (129x64) leaves the domain and raises."""
    for dtype in (torch.bfloat16, torch.float32):
        for backward in (False, True):
            assert fr.attention_route(80, (56, 28), 1568, dtype,
                                      backward) == "generic"
        with pytest.raises(ValueError, match="128-lane"):
            fr.attention_route(64, (129, 65), 129 * 65, dtype)
    assert fr.attention_route(64, (128, 64), 8192, torch.bfloat16,
                              backward=True) == "generic"


# ---------------------------------------------------------------------------
# (c) index models
# ---------------------------------------------------------------------------

def _tile_cells(k0, n, kw):
    """The kernels' walk of keys k0 .. k0 + n - 1: (kr, kc) from one
    division at k0, then incremented key by key."""
    kr, kc = divmod(k0, kw)
    out = []
    for _ in range(n):
        out.append((kr, kc))
        kc += 1
        if kc == kw:
            kc, kr = 0, kr + 1
    return out


@pytest.mark.parametrize("bn", [64, 32])
def test_tile_walk_and_touched_slice(bn):
    """For kw 1-200 (and kh = 3 grid rows past a tile's span): every tile's
    incremental walk equals divmod; a tile touches at most ceil((bn - 1) /
    kw) + 1 grid rows, contiguous, and min(kw, n) grid columns; d rel_h's
    running sum closes each grid row exactly once, after its kw keys, and
    d rel_w's totals take every key of their column, in key order."""
    for kw in range(1, 201):
        kh = (bn + kw - 1) // kw + 3
        length = kh * kw
        closed = []
        col_keys = {c: [] for c in range(kw)}
        open_row, open_n = None, 0
        for k0 in range(0, length, bn):
            n = min(bn, length - k0)
            cells = _tile_cells(k0, n, kw)
            assert cells == [divmod(key, kw) for key in range(k0, k0 + n)]
            rows = sorted({r for r, _ in cells})
            assert rows == list(range(rows[0], rows[-1] + 1))
            assert len(rows) <= -(-(bn - 1) // kw) + 1
            assert len({c for _, c in cells}) == min(kw, n)
            for key, (r, c) in zip(range(k0, k0 + n), cells):
                if open_row is None:
                    open_row, open_n = r, 0
                assert r == open_row
                open_n += 1
                col_keys[c].append(key)
                if c == kw - 1:  # the walk's flush: kc wraps to 0
                    closed.append((open_row, open_n))
                    open_row = None
        assert closed == [(r, kw) for r in range(kh)]
        assert all(keys == list(range(c, length, kw))
                   for c, keys in col_keys.items())


def _swz(r, kb, rows):
    return (kb >> 7) * rows * 128 + r * 128 + ((((kb & 127) >> 4) ^ (r & 7))
                                               << 4) + (kb & 15)


def _round128(n):
    return (n + 127) // 128 * 128


def _perm_col(j):
    return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("es", [2, 4])
def test_tile_layouts_are_bijective_within_their_parts(d, es):
    """The plain tile (bn rows, K = d) and the transposed tile (d rows,
    K = bn, keys in perm_col order in fp32) of ``stage``: every element
    lands on its own 4-byte word (2 bytes in bf16) inside the part, and
    the descriptors' k steps (32 bytes each) start where the element
    layout puts k."""
    bn = 64 if d * es <= 128 else 32
    dtype = torch.bfloat16 if es == 2 else torch.float32
    assert bn == tile_rows(d, dtype)
    plain = {_swz(r, es * c, bn) for r in range(bn) for c in range(d)}
    assert len(plain) == bn * d and max(plain) < bn * _round128(d * es)
    trans = {_swz(c, es * (_perm_col(j) if es == 4 else j), d)
             for c in range(d) for j in range(bn)}
    assert len(trans) == bn * d and max(trans) < d * _round128(bn * es)
    for rows, kbytes in ((bn, d * es), (d, bn * es)):
        for kk in range(kbytes // 32):
            step = ((kk >> 2) * rows * 128 + (kk & 3) * 32)  # k8_step, bytes
            assert step == _swz(0, 32 * kk, rows)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("es", [2, 4])
def test_shared_memory_fits_for_every_grid(d, es):
    """The three kernels' shared memory (Cfg / FwdSmem / DqSmem / DkvSmem
    in the .cu, restated: 64 own rows) does not
    depend on kh + kw, only on kw up to 64 (the d rel_w totals), and fits
    what a block may opt into at every D and type: no key grid of the
    domain is refused."""
    bn = 64 if d * es <= 128 else 32
    bm = 64  # a CTA's own rows: one warpgroup
    parts = 1 if es == 2 else 2
    plain = parts * bn * _round128(d * es)
    trans = parts * d * _round128(bn * es)
    own = bm * (d + (8 if es == 2 else 4)) * es
    fwd = 1024 + plain + trans + own + bm * (bn + 1) * 4
    dq = 1024 + 2 * plain + trans + 2 * own + bm * (bn + 1) * 4 \
        + bm * (REL_SMEM_MAX | 1) * 4
    dkv = 1024 + 2 * plain + 2 * trans + 2 * own + bn * (bm + 1) * 4 \
        + 2 * bn * 4
    assert max(fwd, dq, dkv) <= SMEM_OPTIN, (fwd, dq, dkv)
    if (d, es) == (64, 2):  # the main path, bf16 at hd 64
        assert (fwd, dq, dkv) == (43_264, 77_312, 69_376)
