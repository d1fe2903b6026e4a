"""PyTorch port: the fp32 attention kernels (K1, K2) on Hopper's tensor
cores, 3xTF32, on the CPU.

(a) A plain torch model of the kernels' arithmetic: ``tf32_rn`` by integer
rounding of the low 13 bits (round to nearest, ties away, as
``cvt.rna.tf32.f32``), the split x = big + small and the three products
A_small.B_big + A_big.B_small + A_big.B_big with fp32 accumulation. The K1
and K2 contracts run through it at head dim 64 and are held to the JAX
kernel in interpret mode and to float64 within the fp32 tolerance 1e-4;
one TF32 product per product is not.
(b) An index model of the ``wgmma`` m64nNk8 tf32 accumulator and A-fragment
layouts and of the 128-byte-swizzled K-major layout
(``csrc/flash_relpos_tf32.cuh``): an accumulator P, handed on as A
fragments with no shuffle, times V^T stored in the permuted key order,
equals P.V.
(c) The fp32 backward's key-grid width limit (``BWD_F32_KW_MAX``) and its
shared-memory reckonings, derived from ``csrc/flash_relpos_bwd.cu``'s
constants, and the route swept over them.
Inputs are numpy from a seed.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.kernels.flash_relpos import (
    flash_attention_relpos as j_flash)
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.ops import attention as t_att

from torch_port_common import t

# the fp32 tolerance of chip_smoke.py's K1 / K2 rows and of the parity
# oracle: max abs error over max |reference| per output
TOL = 1e-4
HD = 64
SMEM_OPTIN = 232448


def _src(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# (a) the 3xTF32 arithmetic
# ---------------------------------------------------------------------------

def tf32_rn(x):
    """fp32 -> the nearest tf32 (ties away from zero): the low 13 bits of
    the magnitude rounded by integer arithmetic."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32_rn(x)
    return big, tf32_rn(x - big)


def mm3(a, b):
    """a @ b in 3xTF32: each product of tf32 parts is exact in fp32, the
    sums are fp32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a, b):
    """a @ b in one TF32 product."""
    return tf32_rn(a) @ tf32_rn(b)


def _bias(rel_h, rel_w):
    bh, length, kh = rel_h.shape
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length)


def k1_model(q, k, v, rel_h, rel_w, scale, mm=mm3):
    """K1's contract with its products in ``mm``; fp32 softmax."""
    s = mm(q, k.transpose(1, 2)) * scale + _bias(rel_h, rel_w)
    lse = torch.logsumexp(s, -1)
    return mm(torch.softmax(s, -1), v), lse


def k2_model(q, k, v, rel_h, rel_w, out, lse, dout, scale, mm=mm3):
    """K2's contract with its products in ``mm``: P from lse, the rel
    gradients summed from the fp32 dS."""
    bh, length, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    s = mm(q, k.transpose(1, 2)) * scale + _bias(rel_h, rel_w)
    p = torch.exp(s - lse[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(1, 2)) - delta)
    ds4 = ds.reshape(bh, length, kh, kw)
    return (mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale,
            mm(p.transpose(1, 2), dout), ds4.sum(-1), ds4.sum(-2))


class Model3(torch.autograd.Function):
    """The modelled K1 forward, the modelled K2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        out, lse = k1_model(q, k, v, rel_h, rel_w, scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        return (*k2_model(q, k, v, rel_h, rel_w, out, lse, dout.contiguous(),
                          ctx.scale), None)


def _inputs(grid, seed, bh=2):
    rng = np.random.RandomState(seed)
    length = grid[0] * grid[1]
    q, k, v, dout = (rng.randn(bh, length, HD).astype(np.float32)
                     for _ in range(4))
    rel_h = rng.randn(bh, length, grid[0]).astype(np.float32)
    rel_w = rng.randn(bh, length, grid[1]).astype(np.float32)
    return q, k, v, rel_h, rel_w, dout


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _f64_fwd_bwd(q, k, v, rel_h, rel_w, dout, scale):
    """K1 and K2 in float64 (torch autograd of the plain formula)."""
    leaves = [t(a, torch.float64).requires_grad_()
              for a in (q, k, v, rel_h, rel_w)]
    tq, tk, tv, th, tw = leaves
    s = tq @ tk.transpose(1, 2) * scale + _bias(th, tw)
    out = torch.softmax(s, -1) @ tv
    grads = torch.autograd.grad(out, leaves, t(dout, torch.float64))
    return out.detach(), grads


def _model_errors(grid, seed, mm):
    q, k, v, rel_h, rel_w, dout = _inputs(grid, seed)
    scale = HD ** -0.5
    out, lse = k1_model(*(t(a) for a in (q, k, v, rel_h, rel_w)), scale,
                        mm=mm)
    grads = k2_model(*(t(a) for a in (q, k, v, rel_h, rel_w)), out, lse,
                     t(dout), scale, mm=mm)
    out64, grads64 = _f64_fwd_bwd(q, k, v, rel_h, rel_w, dout, scale)
    errs = {"out": _rel_err(out, out64)}
    for name, a, b in zip(("dq", "dk", "dv", "d_rel_h", "d_rel_w"), grads,
                          grads64):
        errs[name] = _rel_err(a, b)
    return errs


def test_tf32_rn_is_round_to_nearest_ties_away():
    """The integer rounding against float64 arithmetic: the nearest
    multiple of 2^-10 of the binade, ties away from zero."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4096), -rng.randn(4096) * 1e-3,
                        [1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                         1 + 2 ** -11 - 2 ** -20]]).astype(np.float32)
    got = tf32_rn(torch.from_numpy(x)).numpy().astype(np.float64)
    xd = x.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(xd))) - 10)
    want = np.sign(xd) * np.floor(np.abs(xd) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got, want)
    assert got[-4] == 1 + 2 ** -10 and got[-2] == -(1 + 2 ** -10)
    assert got[-1] == 1.0
    big, small = split(torch.from_numpy(x))
    # x = big + small to ~21 bits
    assert (np.abs((big + small).numpy().astype(np.float64) - xd)
            <= np.abs(xd) * 2.0 ** -21).all()


@pytest.mark.parametrize("grid", [(8, 4), (14, 7)])
def test_3xtf32_model_holds_fp32_tolerance_one_tf32_does_not(grid):
    """K1's out and K2's five gradients through the 3xTF32 model are
    within TOL of float64; through one TF32 product per product at least
    one output is past it. That is why the kernels run three products."""
    errs3 = _model_errors(grid, 3, mm3)
    errs1 = _model_errors(grid, 3, mm1)
    assert max(errs3.values()) <= TOL, errs3
    assert max(errs1.values()) > TOL, errs1
    # one TF32 product is ~2^-11 relative; three keep fp32's order
    assert max(errs1.values()) > 10 * max(errs3.values()), (errs1, errs3)


@pytest.mark.parametrize("grid,block_q", [((8, 4), 8), ((14, 7), 16)])
def test_3xtf32_model_matches_jax_kernel_interpret(grid, block_q):
    """The modelled K1 forward and K2 backward (through the rel-term
    einsum to the tables, as the port's Function carries them) against
    the JAX kernel in interpret mode and jax.grad of it, within TOL."""
    rng = np.random.RandomState(5)
    length = grid[0] * grid[1]
    q, k, v, g = (rng.randn(1, 2, length, HD).astype(np.float32)
                  for _ in range(4))
    rph = rng.randn(2 * grid[0] - 1, HD).astype(np.float32)
    rpw = rng.randn(2 * grid[1] - 1, HD).astype(np.float32)
    scale = HD ** -0.5

    def j_out(*a):
        return j_flash(*a, grid, grid, scale, block_q=block_q,
                       exp2_impl="native")

    jargs = tuple(map(jnp.asarray, (q, k, v, rph, rpw)))
    ref_out = np.asarray(j_out(*jargs))
    ref_grads = jax.grad(lambda *a: jnp.sum(j_out(*a) * g),
                         argnums=(0, 1, 2, 3, 4))(*jargs)

    leaves = [t(a).requires_grad_() for a in (q, k, v, rph, rpw)]
    tq, tk, tv, trph, trpw = leaves
    rel_h, rel_w = t_att.rel_pos_bias(tq, trph, trpw, grid, grid)
    out = Model3.apply(tq.reshape(2, length, HD), tk.reshape(2, length, HD),
                       tv.reshape(2, length, HD),
                       rel_h.reshape(2, length, grid[0]),
                       rel_w.reshape(2, length, grid[1]), scale)
    out = out.reshape(1, 2, length, HD)
    assert _rel_err(out.detach().numpy(), ref_out) <= TOL
    got = torch.autograd.grad(out, leaves, t(g))
    for name, a, b in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), got,
                          ref_grads):
        assert _rel_err(a.numpy(), b) <= TOL, name


def _rz32(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_running_sums_leave_the_truncating_accumulator():
    """A model of why K1's O and K2's dq, dk, dv are summed in registers:
    fp32 additions rounded toward zero (as the card's fp32 accumulation
    in wgmma behaves, PERF.md) over every k8 step of a 1568-key loop
    drift toward zero by ~1e-5 of the result; each tile's product in a
    zeroed accumulator, added to the running sum with round-to-nearest,
    stays near fp32's own error. P.V of a softmax row, 3 products a step."""
    rng = np.random.RandomState(9)
    length, tile = 1568, 64
    p = rng.rand(16, length) ** 8          # nonnegative, as P
    v = rng.randn(length, HD)
    exact = p @ v
    steps = [(p[:, k:k + 8] @ v[k:k + 8]) / 3 for k in range(0, length, 8)]
    one = np.zeros((16, HD), np.float32)
    for step in steps:
        for _ in range(3):
            one = _rz32(one.astype(np.float64) + step)
    tiled = np.zeros((16, HD), np.float32)
    per_tile = tile // 8
    for t0 in range(0, len(steps), per_tile):
        acc = np.zeros((16, HD), np.float32)
        for step in steps[t0:t0 + per_tile]:
            for _ in range(3):
                acc = _rz32(acc.astype(np.float64) + step)
        tiled = tiled + acc  # float32, round to nearest
    err_one = _rel_err(one, exact)
    err_tiled = _rel_err(tiled, exact)
    assert err_one > 1e-5 and err_tiled < 3e-6, (err_one, err_tiled)


# ---------------------------------------------------------------------------
# (b) the fragment and shared-memory layouts
# ---------------------------------------------------------------------------

def sw_off(r, k, rows):
    """``sw_off`` of csrc/flash_relpos_tf32.cuh."""
    return ((k >> 5) * rows * 128 + r * 128
            + ((((k & 31) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4)


def perm_col(j):
    return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)


def k8_step(kk, rows):
    return ((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4


def part_bytes(rows, cols):
    return (cols + 31) // 32 * rows * 128


def test_the_header_states_these_formulas():
    src = _src("flash_relpos_tf32.cuh")
    for line in (
            "return (uint32_t)((k >> 5) * rows * 128 + r * 128 +",
            "((((k & 31) >> 2) ^ (r & 7)) << 4) + (k & 3) * 4);",
            "return (cols + 31) / 32 * rows * 128;",
            "return (uint32_t)(((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4);",
            "return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);",
            'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));',
            "split(d[4 * kk], big[0], small[0]);",
            "split(d[4 * kk + 2], big[1], small[1]);",
            "split(d[4 * kk + 1], big[2], small[2]);",
            "split(d[4 * kk + 3], big[3], small[3]);"):
        assert line in src, line


def acc_coord(warp, lane, i):
    """(row, col) of register i of an m64nN fp32 accumulator."""
    g, tq = lane >> 2, lane & 3
    j, e = i >> 2, i & 3
    return 16 * warp + g + 8 * (e >> 1), 8 * j + 2 * tq + (e & 1)


def a_coord(warp, lane, r):
    """(row, k) of register r of a k8 tf32 A fragment."""
    g, tq = lane >> 2, lane & 3
    return 16 * warp + g + 8 * (r & 1), tq + 4 * (r >> 1)


def wgmma_read(buf, base, kk, rows, n_rows):
    """B (n_rows x 8) of k8 step kk as wgmma reads a K-major operand with
    the 128-byte swizzle: the descriptor's start plus (row / 8) x 1024
    (SBO) plus (row % 8) x 128 plus 4 bytes a column, then address bits
    [4, 7) XOR-ed with bits [7, 10) (the tile is 1024-byte aligned)."""
    start = base + 16 * k8_step(kk, rows)
    out = np.empty((n_rows, 8), np.float32)
    for n in range(n_rows):
        for c in range(8):
            addr = start + (n // 8) * 1024 + (n % 8) * 128 + 4 * c
            addr ^= ((addr >> 7) & 7) << 4
            out[n, c] = buf[addr // 4]
    return out


@pytest.mark.parametrize("n", [32, 64])
def test_accumulator_times_permuted_transposed_copy_is_p_v(n):
    """P (64 x n keys) in accumulator layout, handed on as A fragments as
    ``frag_from_acc`` picks them (registers 4kk, 4kk + 2, 4kk + 1, 4kk + 3),
    times V^T written by ``store4_t`` (``sw_off`` at ``perm_col``) and read
    back as wgmma reads it, k8 step by k8 step: exactly P.V."""
    rng = np.random.RandomState(7)
    p = rng.randn(64, n).astype(np.float32)
    v = rng.randn(n, HD).astype(np.float32)
    buf = np.zeros(part_bytes(HD, n) // 4, np.float32)
    for j in range(n):
        for d in range(HD):
            buf[sw_off(d, perm_col(j), HD) // 4] = v[j, d]
    acc = {}
    for warp in range(4):
        for lane in range(32):
            for i in range(n // 2):
                acc[warp, lane, i] = p[acc_coord(warp, lane, i)]
    out = np.zeros((64, HD), np.float64)
    for kk in range(n // 8):
        a = np.zeros((64, 8), np.float32)
        for warp in range(4):
            for lane in range(32):
                regs = [acc[warp, lane, 4 * kk + x] for x in (0, 2, 1, 3)]
                for r in range(4):
                    a[a_coord(warp, lane, r)] = regs[r]
        b = wgmma_read(buf, 0, kk, HD, HD)  # (64 dims, 8 keys)
        out += a.astype(np.float64) @ b.T.astype(np.float64)
    np.testing.assert_allclose(out, p.astype(np.float64) @ v, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("rows", [32, 40, 48, 64, 128])
def test_k_major_tiles_read_back_as_written(rows):
    """A (rows x 64) operand written by ``store4`` (``sw_off``) reads
    back, k8 step by k8 step, as wgmma reads it: the swizzle and
    ``k8_step`` agree at every tile height the kernels use."""
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, HD).astype(np.float32)
    buf = np.zeros(part_bytes(rows, HD) // 4, np.float32)
    for r in range(rows):
        for c in range(HD):
            buf[sw_off(r, c, rows) // 4] = x[r, c]
    for kk in range(HD // 8):
        np.testing.assert_array_equal(
            wgmma_read(buf, 0, kk, rows, rows), x[:, 8 * kk:8 * kk + 8])


# ---------------------------------------------------------------------------
# the sources: 3xTF32 wgmma on the fp32 routes, no scalar code left
# ---------------------------------------------------------------------------

def test_fp32_launchers_run_3xtf32_wgmma():
    hop = _src("hopper.cuh")
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n64k8\.f32\.tf32"
                     r"\.tf32", hop)
    hdr = _src("flash_relpos_tf32.cuh")
    for fn in ("mma3_rs", "mma3_ss"):
        body = hdr[hdr.index(f"void {fn}("):]
        body = body[:body.index("\n}\n")]
        assert body.count("wgmma_tf32_") == 3, fn
    for name, entry in (("flash_relpos_fwd.cu", "flash_relpos_fwd_f32"),
                        ("flash_relpos_bwd.cu", "flash_relpos_bwd_f32")):
        src = _src(name)
        assert "namespace f32" not in src and "f32::" not in src
        assert "tight comparisons" not in src
        assert '#include "flash_relpos_tf32.cuh"' in src
        launcher = src[src.index(f"int {entry}("):]
        assert "return tc::launch(" in launcher[:launcher.index("\n}\n")]
        tc = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
        assert "mma3_rs<" in tc and "fmaf(qr[d]" not in tc
    assert "allow_tf32" not in open(fr.__file__).read()


# ---------------------------------------------------------------------------
# (c) the fp32 backward's limits, from the .cu constants
# ---------------------------------------------------------------------------

def _constant(name):
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       _src("flash_relpos_bwd.cu"))
    assert len(found) == 1, name
    return int(found[0])


def _tile_cols(kw, tile_max):
    return ((tile_max // kw) * kw + 7) & ~7


def _dq_smem(nt, rows):
    """``dq_smem_f32``: dO's two parts, two stages of K, V (2 parts each)
    and K^T (2 parts), barriers, alignment slack."""
    stage = 4 * part_bytes(nt, HD) + 2 * part_bytes(HD, nt)
    return 1024 + 2 * part_bytes(rows, HD) + 2 * stage + 64


def _block_room(n):
    """``block_room<float>``: a copy_block destination of n floats."""
    return (n * 4 + 16 + 15) // 16 * 4


def _dkv_smem(kh, kw, keys, qt):
    """``dkv_smem_f32``: V's two parts, two stages of Q, dO, Q^T, dO^T
    (2 parts each) and their raw rel blocks (the tile rows' rel_h, rel_w,
    lse, delta), barriers, alignment slack."""
    rel = 4 * (_block_room(qt * kh) + _block_room(qt * kw)
               + 2 * _block_room(qt))
    return (1024 + 2 * part_bytes(keys, HD) + 2 * 8 * part_bytes(qt, HD)
            + 2 * rel + 64)


def test_fp32_bwd_limits_read_the_kernel_constants():
    """BWD_F32_KW_MAX is the dq kernel's key-tile width F32_TILE_MAX; at
    every kw up to it the dq kernel's bytes fit, and at every kh + kw up
    to BWD_MAX_REL_ENTRIES the dk/dv kernel's do; the launcher refuses
    what its own counts exceed."""
    src = _src("flash_relpos_bwd.cu")
    tile_max = _constant("F32_TILE_MAX")
    rows, keys, qt = (_constant(n) for n in ("F32_ROWS", "F32_KEYS",
                                             "F32_QT"))
    assert (tile_max, rows, keys, qt) == (48, 128, 128, 32)
    assert fr.BWD_F32_KW_MAX == tile_max
    assert "return 4 * part_bytes(nt, D) + 2 * part_bytes(D, nt);" in src
    assert "kw > F32_TILE_MAX || dq_smem_f32(tile_cols(kw)) > SMEM_OPTIN" \
        in src
    assert "dkv_smem_f32(kh, kw) > SMEM_OPTIN)" in src
    assert ("return 4 * (block_room<float>(F32_QT * kh) + "
            "block_room<float>(F32_QT * kw)") in src
    assert "inline int tile_cols(int kw) { return (tile_rows(kw) * kw + 7) " \
        "& ~7; }" in src
    widest = max(_dq_smem(_tile_cols(kw, tile_max), rows)
                 for kw in range(1, tile_max + 1))
    assert widest == _dq_smem(48, rows) == 230464 <= SMEM_OPTIN
    worst = max(_dkv_smem(kh, kw, keys, qt)
                for kw in range(1, fr.BWD_MAX_REL_ENTRIES)
                for kh in range(1, fr.BWD_MAX_REL_ENTRIES - kw + 1))
    assert worst == _dkv_smem(126, 1, keys, qt) == 230848 <= SMEM_OPTIN
    assert _dkv_smem(80, 40, keys, qt) == 229056
    # the key tiles of the port's grids
    assert [_tile_cols(kw, tile_max) for kw in (28, 35, 40, 14, 7)] == [
        32, 40, 40, 48, 48]


@pytest.mark.parametrize("kw", [1, 7, 14, 28, 35, 40, 42, 48, 49, 64, 100])
def test_fp32_bwd_route_follows_the_tile_width(kw):
    """fp32 backward at head dim 64: ``"vitl"`` exactly where kh + kw <=
    127 and kw <= 48; bf16 keeps its own window; every grid of the port's
    paths (56x28, 70x35, 14x14, 80x40) keeps K2 in both types."""
    for kh in range(1, 128):
        length = kh * kw
        if 64 + min(kh, kw) > 128 and not (kh + kw <= 127 and kw <= 48):
            continue  # outside both domains
        want = "vitl" if kh + kw <= 127 and kw <= 48 else "generic"
        assert fr.attention_route(64, (kh, kw), length, torch.float32,
                                  backward=True) == want, (kh, kw)
    for grid in ((56, 28), (70, 35), (14, 14), (80, 40)):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                assert fr.attention_route(64, grid, grid[0] * grid[1], dtype,
                                          backward) == "vitl", grid
