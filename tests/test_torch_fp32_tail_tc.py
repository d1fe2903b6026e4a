"""PyTorch port: the fp32 decoder tail on the tensor cores (K3 / K4's fp32
route at C = 64 and K3g / K4g's at C >= 9), 3xTF32, on the CPU.

``_tf32x3_tail`` restates the kernels' arithmetic in plain torch: the
packed parameters with W1 split into big and small tf32 parts as the
packing launch writes them (``pack_reference`` in fp32); the conv3x3 as
steps of one tap x one 32-channel chunk, tap major, each step's three
products (A_small.B_big + A_big.B_small + A_big.B_big, the pixels split
where the consumers split them) summed into fp32 totals step by step; the
LayerNorm, GELU and the LayerNorm backward in fp32 with no rounding to a
narrower type (LayerNorm sums per warpgroup, wg0 + wg1 in split mode);
dpix the rotated taps over du with W1T's parts; dW1 per 64-pixel unit, the
pixels (c as M) split in registers and du's copy split by the du launch,
summed per warpgroup over the even and odd units of each pixel slice into
partial rows; the small gradients as per-unit partials. It is held against
the JAX ``fused_decoder_tail`` (Pallas in interpret mode) and the plain
versions at the card's limits (``chip_smoke.py`` ``K3_TOL`` / ``K4_TOL``
fp32: 1e-4 of max |out|, 1e-3 of each gradient's max abs). Also: the
tf32 rounding, the packed buffer's parts, index models of the K-major
swizzled operands (the fp32 pixel box's 32-channel chunk, the A fragment
gathers of the forward and of dW1, dW1's B from du^T), and the route's
limits in the sources. The kernels themselves run only on the card
(``chip_smoke.py`` ``phase_tail`` / ``phase_generic_tail``). Inputs are
numpy from a seed.
"""
import functools
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from painter_tpu.kernels.decoder_head import fused_decoder_tail as j_tail
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import decoder_head as dh

from test_torch_decoder_head import (NAMES, _inputs, _jax_args, _jax_grads,
                                     _port_args)
from torch_port_common import t

import jax.numpy as jnp

KCH = 32      # fp32 channels per 128-byte K chunk (Ty<float>::KCH)
TILE = 64     # pixels per unit
NW_MAX = 128  # the widest fp32 warpgroup N (Ty<float>::NW_MAX)
K3_TOL = 1e-4  # chip_smoke.py K3_TOL[torch.float32]
K4_TOL = 1e-3  # chip_smoke.py K4_TOL[torch.float32]


def _nw(c, split):
    """The fp32 warpgroup width: whole rows up to 128 channels, split rows
    up to 256 (N >= C / 2), N tiles of 2 x 128 past that."""
    if c > dh.TC_ROW_CHANNELS_F32:
        return NW_MAX
    n = (c + 1) // 2 if split else c
    return -(-n // 64) * 64


def _mm3(a, bb, bs):
    """a (m, k) . (bb + bs)^T (n, k) in 3xTF32: a split where the kernels
    split it, the three products of one step (small terms first) summed in
    fp32 (the tensor cores sum a step's terms in their own order)."""
    ab, as_ = dh.tf32_split(a)
    return as_ @ bb.t() + ab @ bs.t() + ab @ bb.t()


def _wg_sum(v, nw, split):
    if not split:
        return v.sum(-1, keepdim=True)
    return v[..., :nw].sum(-1, keepdim=True) + v[..., nw:].sum(-1,
                                                             keepdim=True)


def _units(v, w):
    """(b, h, w, k) -> (units, 64, k), zero past w, in unit order."""
    b, h, _, k = v.shape
    xt = -(-w // TILE)
    v = F.pad(v, (0, 0, 0, xt * TILE - w))
    return v.reshape(b * h * xt, TILE, k)


def _tf32x3_tail(pix, w1, b1, lns, lnb, w2, b2, go, approx, split, slices):
    """The fp32 tensor-core route in torch. Returns (out, dpix, dW1, db1,
    dLN scale, dLN bias, dW2, db2) in the plain versions' layouts."""
    b, h, w, c = pix.shape
    cd = dh.generic_channels(c, torch.float32)
    tiles = c > dh.TC_ROW_CHANNELS_F32  # N tiles: the row kernel's sums
    split = split and not tiles
    nw = _nw(c, split)
    nt = -(-cd // (2 * nw)) * 2 * nw if tiles else 2 * nw if split else nw
    kc = -(-cd // KCH)
    packed = dh.pack_reference(w1, b1, lns, lnb, w2, b2, cd, torch.float32)
    p2 = 9 * cd * cd

    def planes(i):  # W1P big, W1P small, W1T big, W1T small
        return F.pad(packed[i * p2:(i + 1) * p2].reshape(9, cd, cd),
                     (0, kc * KCH - cd, 0, nt - cd))
    w1p, w1p_s, w1t, w1t_s = (planes(i) for i in range(4))
    rows = packed[4 * p2:]
    pb1, plns, plnb = (F.pad(rows[i * cd:(i + 1) * cd], (0, nt - cd))
                       for i in range(3))
    pw2 = F.pad(rows[3 * cd:6 * cd].reshape(cd, 3), (0, 0, 0, nt - cd))
    pb2 = rows[6 * cd:6 * cd + 3]
    real = (torch.arange(nt) < c).float()

    def shifted(v, dy, dx):
        vp = F.pad(v, (0, 0, 1, 1, 1, 1))
        return vp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    def conv(src, wb, ws, rot):
        """Steps of (tap, 32-channel chunk), tap major, each added into
        the fp32 totals."""
        src = F.pad(src, (0, kc * KCH - src.shape[-1]))
        tot = torch.zeros(b * h * w, nt)
        for tap in range(9):
            dy, dx = tap // 3 - 1, tap % 3 - 1
            box = shifted(src, -dy, -dx) if rot else shifted(src, dy, dx)
            box = box.reshape(-1, kc * KCH)
            for k in range(kc):
                ch = slice(k * KCH, (k + 1) * KCH)
                tot = tot + _mm3(box[:, ch], wb[tap][:, ch], ws[tap][:, ch])
        return tot.reshape(b, h, w, nt)

    u = conv(pix.float(), w1p, w1p_s, False) + pb1
    mean = _wg_sum(u * real, nw, split) / c
    d = u - mean
    rstd = torch.rsqrt(_wg_sum(d * d * real, nw, split) / c + dh.LN_EPS)
    xhat = d * rstd * real
    n = xhat * plns + plnb
    g = dh._gelu(n, approx) * real
    out = _wg_sum(g[..., None, :] * pw2.t(), nw, split)[..., 0] + pb2
    dn = (go @ pw2.t()) * dh.gelu_grad(n, approx) * real
    dxh = dn * plns
    mx = _wg_sum(dxh, nw, split) / c
    mxx = _wg_sum(dxh * xhat, nw, split) / c
    du = rstd * (dxh - mx - xhat * mxx) * real
    dpix = conv(du[..., :cd], w1t, w1t_s, True)[..., :c]
    # dW1: per unit, warpgroup w the slice's units w, w + 2, ...; one
    # partial row per (slice, warpgroup)
    units = b * h * -(-w // TILE)
    per = -(-units // slices)
    d_big, d_small = dh.tf32_split(_units(du[..., :cd], w))
    taps = []
    for tap in range(9):
        x_u = _units(shifted(pix.float(), tap // 3 - 1, tap % 3 - 1), w)
        a_big, a_small = dh.tf32_split(x_u.transpose(1, 2))  # (u, c, px)
        part = a_small @ d_big + a_big @ d_small + a_big @ d_big
        rows_ = [part[u0 + wg:min(units, u0 + per):2].sum(0)
                 for u0 in range(0, units, per) for wg in (0, 1)]
        taps.append(torch.stack(rows_).sum(0))
    dw1 = torch.stack(taps)[:, :c, :c].reshape(3, 3, c, c)
    small = [_units(v, w).sum(1).sum(0)[:c] for v in (du, dn * xhat, dn)]
    dw2 = torch.einsum("upc,upk->ck", _units(g, w), _units(go, w))[:c]
    db2 = _units(go, w).sum(1).sum(0)
    return (out, dpix, dw1.permute(3, 2, 0, 1), *small,
            dw2.t().reshape(3, c, 1, 1), db2)


def _rel(a, r):
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return np.abs(a - r).max() / max(np.abs(r).max(), 1e-30)


# ---------------------------------------------------------------------------
# the arithmetic against JAX and the plain versions
# ---------------------------------------------------------------------------

JAX_CASES = [(64, False), (64, True), (16, True), (40, False),
             (100, True), (100, False)]
JAX_SHAPE = (1, 10, 70)  # two ragged units a row (the JAX backward: even H)


@functools.lru_cache(maxsize=None)
def _jax_case(c, approx):
    """numpy inputs, upstream gradient, and the JAX tail's output and
    gradients at JAX_SHAPE and width c."""
    b, h, w = JAX_SHAPE
    args = _inputs(30 + c, b, h, w, c)
    go = np.random.RandomState(c + h).randn(b, h, w, 3).astype(np.float32)
    ref_out = np.asarray(j_tail(*_jax_args(args, jnp.float32), approx))
    return args, go, ref_out, _jax_grads(args, jnp.float32, approx, go)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("c,split", JAX_CASES)
def test_tf32x3_tail_matches_jax(c, split, approx):
    """The 3xTF32 arithmetic == the JAX ``fused_decoder_tail`` (Pallas in
    interpret mode), forward and all seven gradients through its custom
    VJP, at the card's fp32 limits; whole rows and split rows; ragged
    units at W 70; dW1 over 3 pixel slices."""
    args, go, ref_out, ref_grads = _jax_case(c, approx)
    got = _tf32x3_tail(*_port_args(args, torch.float32), t(go), approx,
                       split, 3)
    assert _rel(got[0].numpy(), ref_out) <= K3_TOL
    for name, a, r in zip(NAMES, got[1:], ref_grads):
        assert tuple(a.shape) == r.shape, name
        assert _rel(a.numpy(), r) <= K4_TOL, name


@pytest.mark.parametrize("approx", [False, True])
def test_tf32x3_tail_c64_odd_height(approx):
    """C = 64 on (2, 37, 29), the fp32 K3 / K4 route's ragged shape of
    ``chip_smoke.py``: the forward == JAX's, the backward == the plain
    version (the JAX backward takes an even H), whole rows, 2 slices."""
    args = _inputs(64, 2, 37, 29, 64)
    go = t(np.random.RandomState(3).randn(2, 37, 29, 3))
    port = _port_args(args, torch.float32)
    got = _tf32x3_tail(*port, go, approx, False, 2)
    ref_out = np.asarray(j_tail(*_jax_args(args, jnp.float32), approx))
    assert _rel(got[0].numpy(), ref_out) <= K3_TOL
    ref = dh.fused_decoder_tail_bwd_reference(*port[:6], go, approx)
    for name, a, r in zip(NAMES, got[1:], ref):
        assert _rel(a.numpy(), r.numpy()) <= K4_TOL, name


@pytest.mark.parametrize("shape,c,split,slices", [
    ((2, 16, 12), 13, True, 2), ((1, 9, 70), 160, True, 3),
    ((1, 5, 7), 264, True, 1), ((1, 3, 5), 517, True, 2),
    ((1, 9, 70), 128, False, 2), ((2, 4, 65), 9, True, 3)])
def test_tf32x3_tail_matches_plain(shape, c, split, slices):
    """The widths past the whole-rows limit (split rows at 160, N tiles
    and the row kernels at 264 and 517), padded widths (13, 9, 517) and
    the widest whole rows (128) == the plain forward and backward at the
    card's fp32 limits."""
    b, h, w = shape
    args = _port_args(_inputs(c + h, b, h, w, c), torch.float32)
    go = t(np.random.RandomState(c).randn(b, h, w, 3))
    got = _tf32x3_tail(*args, go, True, split, slices)
    ref = (dh.fused_decoder_tail_reference(*args, True),
           *dh.fused_decoder_tail_bwd_reference(*args[:6], go, True))
    assert _rel(got[0].numpy(), ref[0].numpy()) <= K3_TOL
    for name, a, r in zip(NAMES, got[1:], ref[1:]):
        assert a.shape == r.shape, name
        assert _rel(a.numpy(), r.numpy()) <= K4_TOL, name


# ---------------------------------------------------------------------------
# tf32 rounding and the packed parameters
# ---------------------------------------------------------------------------

def test_tf32_round_is_nearest_ties_away():
    """``tf32_round``: the low 13 bits dropped, to nearest, ties away from
    zero (cvt.rna.tf32.f32), in both signs."""
    one = 0x3F800000
    bits = torch.tensor([one, one + 0x0FFF, one + 0x1000, one + 0x1001,
                         one + 0x2000 + 0x1000, 0x00001000, 0x7F7FEFFF],
                        dtype=torch.int32)
    want = torch.tensor([one, one, one + 0x2000, one + 0x2000,
                         one + 0x4000, 0x00002000, 0x7F7FE000],
                        dtype=torch.int32)
    for sign in (1.0, -1.0):
        x = bits.view(torch.float32) * sign
        got = dh.tf32_round(x)
        assert torch.equal(got, want.view(torch.float32) * sign)
        assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


@pytest.mark.parametrize("c", [13, 40, 64, 100])
def test_fp32_packed_parts(c):
    """The fp32 packed buffer: W1P and W1T each as a big and a small tf32
    plane set (low 13 bits zero) that sum back to W1 within 2^-22 of
    |W1|; W1T the transposes of W1P; the row vectors in fp32 as they are;
    zero past C; the size the kernels take."""
    pix, w1, b1, lns, lnb, w2, b2 = _port_args(_inputs(c, 1, 4, 4, c),
                                               torch.float32)
    cd = dh.generic_channels(c, torch.float32)
    packed = dh.pack_reference(w1, b1, lns, lnb, w2, b2, cd, torch.float32)
    assert packed.dtype == torch.float32
    assert packed.numel() == dh._packed_size(cd, torch.float32)
    p2 = 9 * cd * cd
    big_p, small_p, big_t, small_t = (packed[i * p2:(i + 1) * p2].reshape(
        9, cd, cd) for i in range(4))
    for part in (big_p, small_p, big_t, small_t):
        assert torch.all((part.contiguous().view(torch.int32) & 0x1FFF) == 0)
    want = torch.zeros(9, cd, cd)
    want[:, :c, :c] = w1.permute(2, 3, 0, 1).reshape(9, c, c)  # (t, o, c)
    err = ((big_p.double() + small_p.double()) - want.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * want.double().abs())
    assert torch.equal(big_t, big_p.transpose(1, 2))
    assert torch.equal(small_t, small_p.transpose(1, 2))
    rows = packed[4 * p2:]
    for i, v in enumerate((b1, lns, lnb)):
        assert torch.equal(rows[i * cd:i * cd + c], v)
        assert torch.count_nonzero(rows[i * cd + c:(i + 1) * cd]) == 0
    assert torch.equal(rows[3 * cd:3 * cd + 3 * c],
                       w2.reshape(3, c).t().reshape(-1))
    assert torch.equal(rows[6 * cd:], b2)


# ---------------------------------------------------------------------------
# index models of the K-major operands
# ---------------------------------------------------------------------------

def _sw_off(r, k):
    """flash_relpos_tf32.cuh sw_off for one 32-column (128-byte) block:
    the byte offset of fp32 element (row r, column k) as TMA's 128-byte
    swizzle writes a box: 16-byte chunk k // 4 XOR r % 8."""
    return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4


def _tma_box(rows):
    """A (rows, 32) fp32 box as TMA writes it with 128-byte swizzle:
    {byte offset: (row, column)}."""
    return {_sw_off(r, k): (r, k) for r in range(rows) for k in range(32)}


def test_fp32_box_swizzle_is_a_bijection():
    """A 64-row box of 32 fp32 channels fills its 8 KiB exactly once, each
    128-byte row holding its own row's 32 values, 4-byte aligned."""
    box = _tma_box(TILE)
    assert sorted(box) == list(range(0, TILE * 128, 4))
    assert all(off // 128 == r for off, (r, _) in box.items())


@pytest.mark.parametrize("kk", range(4))
def test_forward_a_fragments(kk):
    """The forward's A fragments (a_frags): thread (warp, g, tq) of a
    warpgroup reads rows 16 warp + g (+ 8) and columns 8 kk + tq (+ 4) of
    the pixel box, in wgmma_tf32_rs's register order; over the 128
    threads each k8 step's (64, 8) tile is read once, and each register's
    warp-wide load hits 32 distinct banks."""
    seen = set()
    for reg in range(4):
        for warp in range(4):
            banks = set()
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                r = warp * 16 + g + 8 * (reg & 1)
                k = 8 * kk + tq + 4 * (reg >> 1)
                off = _sw_off(r, k)
                banks.add((off // 4) % 32)
                seen.add((r, k))
            assert len(banks) == 32
    assert seen == {(r, 8 * kk + j) for r in range(TILE) for j in range(8)}


def test_dw1_a_gather_and_b_from_dut():
    """dW1's operands: A (c as M, pixels as K) gathered from the two
    pixel boxes (c // 32, row = pixel, column = c % 32) covers the (64,
    64) tile once per unit (at most 2-way bank conflicts a load); B is du^T
    as the du launch writes it, (part, b, y, channel, pixel) with the
    image row padded to whole units, whose (32 pixels, 64 channels) TMA
    boxes read K-major give du[pixel, o] at k8 step kk in box kk // 4."""
    seen = set()
    for kk in range(8):
        for reg in range(4):
            for warp in range(4):
                banks = {}
                for lane in range(32):
                    g, tq = lane >> 2, lane & 3
                    c = (warp & 1) * 16 + g + 8 * (reg & 1)
                    px = 8 * kk + tq + 4 * (reg >> 1)
                    bank = (_sw_off(px, c) // 4) % 32
                    banks[bank] = banks.get(bank, 0) + 1
                    seen.add(((warp >> 1) * 32 + c, px))
                assert max(banks.values()) <= 2
    assert seen == {(c, p) for c in range(64) for p in range(TILE)}
    # du^T: the epilogue's index of (b, y, x, c) -> the B operand's element
    rng = np.random.RandomState(0)
    b, h, w, cd = 2, 3, 70, 16
    wp = -(-w // TILE) * TILE
    du = rng.randn(b, h, w, cd).astype(np.float32)
    dut = np.zeros(2 * b * h * cd * wp, np.float32)
    big, small = (v.numpy() for v in dh.tf32_split(t(du)))
    half = b * h * cd * wp
    for bi in range(b):
        for y in range(h):
            for x in range(w):
                for c in range(cd):
                    i = ((bi * h + y) * cd + c) * wp + x
                    dut[i], dut[i + half] = big[bi, y, x, c], small[bi, y, x, c]
    dut = dut.reshape(2, b, h, cd, wp)
    for x0 in range(0, wp, TILE):  # each unit of image 1, row 2
        for kk in range(8):
            box = dut[0, 1, 2, :, x0 + 32 * (kk // 4):x0 + 32 * (kk // 4) + 32]
            tile = np.zeros((64, 32), np.float32)  # 64 o rows, zero-filled
            tile[:cd] = box
            mem = {_sw_off(o, p): tile[o, p] for o in range(64)
                   for p in range(32)}
            for o in range(cd):
                for j in range(8):
                    px = x0 + 8 * kk + j
                    k = (8 * kk + j) % 32
                    want = big[1, 2, px, o] if px < w else 0.0
                    assert mem[_sw_off(o, k)] == want


# ---------------------------------------------------------------------------
# the route, the wrappers and the sources
# ---------------------------------------------------------------------------

def _source(name):
    with open(f"{build.CSRC}/{name}") as f:
        return f.read()


def test_fp32_route_limits_match_the_sources():
    """Ty<float> in decoder_tail_tc.cuh: 32-channel chunks, two W1 parts,
    N up to 128, whole rows up to 128 channels and split rows up to
    TC_ROW_CHANNELS_F32; every fp32 C >= 9 is the tensor-core route, C = 64
    the vitl route (whose fp32 wrappers launch the same kernels)."""
    head = _source("decoder_tail_tc.cuh")
    m = re.search(r"struct Ty<float> \{\s*static constexpr int KCH = (\d+), "
                  r"PARTS = (\d+), NW_MAX = (\d+), WHOLE_C = (\d+),\s*"
                  r"ROW_C = (\d+);", head)
    assert m, "Ty<float> not found"
    assert tuple(int(v) for v in m.groups()) == (
        KCH, 2, NW_MAX, NW_MAX, dh.TC_ROW_CHANNELS_F32)
    assert dh.decoder_route(64, torch.float32) == "vitl"
    for c in (9, 13, 64, 100, 256, 257, 1000):
        assert dh.generic_tail_route(c, torch.float32) == "tc"
        assert dh.generic_channels(c, torch.float32) == -(-c // 8) * 8
    for c in (1, 8):
        assert dh.generic_tail_route(c, torch.float32) == "narrow"


def test_scalar_fp32_c64_code_is_gone():
    """The C = 64 sources are bf16 only; the fp32 launchers are the
    tensor-core sources' and name what they replace."""
    fwd, bwd = _source("decoder_tail_fwd.cu"), _source("decoder_tail_bwd.cu")
    assert "decoder_tail_fwd_f32" not in fwd
    assert "decoder_tail_bwd_f32" not in bwd
    assert "mma16x64" not in _source("decoder_tail_common.cuh")
    tcf, tcb = (_source("decoder_tail_tc_fwd.cu"),
                _source("decoder_tail_tc_bwd.cu"))
    for sym in ("decoder_tail_tc_pack_f32", "decoder_tail_tc_fwd_f32"):
        assert f"int {sym}(" in tcf
    for sym in ("decoder_tail_tc_bwd_f32", "decoder_tail_tc_partials_f32"):
        assert f" {sym}(" in tcb
    assert "dw1_tf32_kernel" in tcb and "3xTF32" in tcf
    assert "painter_tpu/kernels/decoder_head.py:_fwd_impl" in tcf
    assert "painter_tpu/kernels/decoder_head.py:_bwd_impl" in tcb
    assert "wgmma_tf32_rs<128>" in _source("hopper.cuh")


@pytest.mark.parametrize("c", [64, 40])
def test_fp32_wrappers_on_the_cpu_run_plain_and_count_no_launch(c):
    """fp32 CPU tensors take the plain versions through every wrapper of
    the route; no count moves."""
    args = _port_args(_inputs(c, 1, 4, 6, c), torch.float32)
    go = t(np.random.RandomState(2).randn(1, 4, 6, 3))
    counters = (dh.fused_decoder_tail, dh.fused_decoder_tail_bwd,
                dh.fused_decoder_tail_tc, dh.fused_decoder_tail_bwd_tc)
    before = [fn.launches for fn in counters]
    out = dh.fused_decoder_tail_reference(*args, True)
    ref = dh.fused_decoder_tail_bwd_reference(*args[:6], go, True)
    for fwd, bwd in ((dh.fused_decoder_tail, dh.fused_decoder_tail_bwd),
                     (dh.fused_decoder_tail_tc,
                      dh.fused_decoder_tail_bwd_tc)):
        assert torch.equal(fwd(*args, True), out)
        assert all(torch.equal(a, r) for a, r in zip(
            bwd(*args[:6], go, True), ref))
    assert [fn.launches for fn in counters] == before
