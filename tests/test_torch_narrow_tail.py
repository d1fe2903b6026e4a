"""PyTorch port: the narrow route of the width-generic decoder tail (K3g /
K4g at C <= 8, ``csrc/decoder_tail_generic.cu``), on the CPU.

``_narrow_tail`` restates the kernels' arithmetic in plain torch:

- the parameters cast to the input type and padded to 8 channels, the
  pixels padded to 8 channels and zero outside the image;
- the conv3x3 (and dpix's transposed one) as one product with the taps
  packed into K in the kernels' order: bf16 in k16 steps of two taps (tap
  9 a zero one), fp32 in 3xTF32 per tap (the small terms, then the big
  one, each tap's three into a zeroed accumulator added in fp32);
- the LayerNorm sums, mean(dxhat), mean(dxhat xhat) and the fp32 output
  dots as a quad of lanes takes them ((p0 + p1) + (p2 + p3), lane q
  holding channels 2q, 2q + 1), the sums times 1 / C rounded once; the
  bf16 output dots as one more product (g by W2);
- the parameter gradients as the kernels sum them: each tile's own
  pixels only, ring M tiles two at a time per warp, each lane's pixels in
  order over its CTA's tiles (CTA i takes tiles i, i + grid, ...), the
  8 quads by xor butterfly, the 4 warps in order; dW1 as the 72 x 8
  product over each own M tile of 16 pixels; then the rows of the CTAs in
  the reduction launch's order (32 warps over rows w, w + 32, ..., their
  sums in order).

The bf16 kernels take the tanh GELU on tanh.approx.f32 (about 2^-11
relative, rounded to bf16 next), this restatement on torch's tanh. It is
held against the JAX ``fused_decoder_tail`` (Pallas in interpret mode) at
C 1, 3 and 8, bf16 and fp32, both GELUs, on a ragged grid, and against
the plain versions. The tiling and the grid (``narrow_tiling``,
``narrow_grid``) are pinned by shape, and the source's constants against
the wrapper's. The kernels themselves run only on the card
(``chip_smoke.py`` ``phase_generic_tail``).
"""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from painter_tpu.kernels.decoder_head import fused_decoder_tail as j_tail
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import decoder_head as dh

from test_torch_decoder_head import (GRAD_RTOL, NAMES, _close_rel, _inputs,
                                     _jax_args, _jax_grads, _port_args)
from torch_port_common import t

import jax.numpy as jnp

CP = dh.NARROW_CHANNELS
TW = dh.NARROW_TILE_W
WARPS = 4
RED_WARPS = 32  # reduce_kernel's warps
SMS = 132       # an H100's SMs
# the backward's CTAs an SM on an H100 at 16-row tiles (bf16 by its
# registers, fp32 by its shared memory); on the card the wrapper reads them
# from the kernel (decoder_tail_generic_ctas_per_sm_*)
BWD_CTAS = {torch.bfloat16: 4, torch.float32: 3}


def _r(v, dt):
    """``v`` cast to the input type, as fp32 for the math."""
    return v.to(dt).float()


def _quad_sum(v):
    """(..., 8) -> (...,): lane q holds channels 2q, 2q + 1; two xor
    shuffles add (p0 + p1) + (p2 + p3)."""
    p = v[..., 0::2] + v[..., 1::2]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _split_product(a, b):
    """a @ b in 3xTF32: small terms, then the big one."""
    ab, as_ = dh.tf32_split(a)
    bb, bs = dh.tf32_split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _tap_product(a, wk, dt):
    """sum over the taps of a[:, tap] @ wk[tap] in the kernels' K order: a
    (N, 9, 8) pixels at the taps, wk (9, 8, 8) (tap, k, n)."""
    acc = torch.zeros(a.shape[0], CP)
    if dt == torch.bfloat16:
        a = F.pad(a, (0, 0, 0, 1))    # tap 9: zero weights
        wk = F.pad(wk, (0, 0, 0, 0, 0, 1))
        for s in range(5):            # k16 steps of two taps
            acc = acc + a[:, 2 * s:2 * s + 2].reshape(-1, 16) @ \
                wk[2 * s:2 * s + 2].reshape(16, CP)
        return acc
    for tap in range(9):              # k8 steps, each into a zeroed sum
        acc = acc + _split_product(a[:, tap], wk[tap])
    return acc


def _conv(xp, wk, dt, rot=False):
    """xp (b, h + 2, w + 2, 8) padded by one pixel -> (b, h, w, 8): the
    taps' shifts +(dy, dx), or with ``rot`` the rotated ones (dpix)."""
    b, hp, wp, _ = xp.shape
    h, w = hp - 2, wp - 2
    a = torch.stack([xp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w] if rot
                     else xp[:, dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3)], -2)
    return _tap_product(a.reshape(-1, 9, CP), wk, dt).reshape(b, h, w, CP)


def _pad8(x):
    return F.pad(x, (0, CP - x.shape[-1]))


def _params(w1, b1, lns, lnb, w2, b2, dt):
    """W1 (tap, o, c), b1, LN scale, LN bias (8,), W2 (3, 8), b2 (3,):
    cast to the input type and zero past C, as each CTA stages them."""
    c = w1.shape[0]
    wt = torch.zeros(9, CP, CP)
    wt[:, :c, :c] = _r(w1, dt).permute(2, 3, 0, 1).reshape(9, c, c)
    rows = [_pad8(_r(v, dt)) for v in (b1, lns, lnb)]
    wo = _pad8(_r(w2, dt).reshape(3, c))
    return wt, rows, wo, (None if b2 is None else _r(b2, dt))


def _gelu_and_grad(n, approx):
    return dh._gelu(n, approx), dh.gelu_grad(n, approx)


def _chain(pix, wt, rows, wo, approx):
    """Per pixel (b, h, w, 8): xhat, rstd, n, the rounded GELU output and
    gelu'(n), from the conv in the kernels' K order and the quad sums."""
    dt = pix.dtype
    c = pix.shape[-1]
    b1, lns, lnb = rows
    real = torch.arange(CP) < c
    inv_c = torch.tensor(1.0 / c, dtype=torch.float32)
    xp = F.pad(_pad8(pix.float()), (0, 0, 1, 1, 1, 1))
    u = _conv(xp, wt.transpose(1, 2), dt) + b1
    mean = _quad_sum(u * real) * inv_c
    d = (u - mean[..., None]) * real
    rstd = torch.rsqrt(_quad_sum(d * d) * inv_c + dh.LN_EPS)[..., None]
    xh = d * rstd
    n = xh * lns + lnb
    g, gd = _gelu_and_grad(n, approx)
    return xh, rstd, n, _r(g, dt), gd, inv_c, real


def _forward(pix, w1, b1, lns, lnb, w2, b2, approx):
    dt = pix.dtype
    wt, rows, wo, bo = _params(w1, b1, lns, lnb, w2, b2, dt)
    _, _, _, g, _, _, _ = _chain(pix, wt, rows, wo, approx)
    if dt == torch.bfloat16:  # one more product: g (k = channel) by W2
        o = g @ wo.t()
    else:
        o = torch.stack([_quad_sum(g * wo[k]) for k in range(3)], -1)
    return (o + bo).to(dt)


def _tiles(b, h, w, th):
    """(b, y0, x0) of every tile, in the kernels' tile order."""
    tx, ty = -(-w // TW), -(-h // th)
    return [(i // (tx * ty), i // tx % ty * th, i % tx * TW)
            for i in range(b * tx * ty)]


def _cta_rounds(n_tiles, grid):
    """(grid, rounds) tile index of each CTA's rounds, -1 past the end."""
    rounds = -(-n_tiles // grid)
    idx = torch.arange(grid)[:, None] + grid * torch.arange(rounds)[None]
    return torch.where(idx < n_tiles, idx, -1)


def _column_sum(v):
    """(..., 8 quads, k) -> (..., k): the xor 4, 8, 16 butterfly."""
    p = v[..., 0::2, :] + v[..., 1::2, :]
    p = p[..., 0::2, :] + p[..., 1::2, :]
    return p[..., 0, :] + p[..., 1, :]


def _warps_in_order(v):
    """(..., 4 warps, k) -> (..., k): warp 0 + warp 1 + ... in order."""
    s = v[..., 0, :]
    for w in range(1, v.shape[-2]):
        s = s + v[..., w, :]
    return s


def _sum_seq(v):
    """(n, k) -> (k,): the rows added in order."""
    out = v[0]
    for row in v[1:]:
        out = out + row
    return out


def _reduce_rows(part):
    """The reduction launch: warp w of 32 sums rows w, w + 32, ... in
    order, then the 32 warps' sums are added in order."""
    part = F.pad(part, (0, 0, 0, -part.shape[0] % RED_WARPS))
    s = torch.zeros(RED_WARPS, part.shape[1])
    for blk in part.reshape(-1, RED_WARPS, part.shape[1]):
        s = s + blk
    return _sum_seq(s)


def _backward(pix, w1, b1, lns, lnb, w2, go, approx, sms):
    """dpix, and the parameter gradients summed as the kernels sum them
    (tiles, CTAs and the reduction order by ``narrow_tiling`` /
    ``narrow_grid`` at ``sms`` SMs of ``BWD_CTAS`` each)."""
    dt = pix.dtype
    b, h, w, c = pix.shape
    wt, rows, wo, _ = _params(w1, b1, lns, lnb, w2, None, dt)
    xh, rstd, n, g, gd, inv_c, real = _chain(pix, wt, rows, wo, approx)
    gor = _r(go, dt)
    dg = gor[..., 0:1] * wo[0] + gor[..., 1:2] * wo[1] + \
        gor[..., 2:3] * wo[2]
    dn = dg * gd
    dx = dn * rows[1]
    mx = (_quad_sum(dx) * inv_c)[..., None]
    mxx = (_quad_sum(dx * xh) * inv_c)[..., None]
    du = rstd * (dx - mx - xh * mxx) * real
    dur = _r(du, dt)
    dpix = _conv(F.pad(dur, (0, 0, 1, 1, 1, 1)), wt, dt, rot=True)
    dpix = dpix[..., :c].to(dt)

    # per pixel: the small partials' terms in the source's row order
    small = torch.cat([du, dn * xh, dn,
                       (g[..., :, None] * gor[..., None, :]).flatten(-2),
                       gor], -1)                            # (b, h, w, 51)
    th, n_tiles = dh.narrow_tiling(b, h, w, sms)
    grid = dh.narrow_grid(n_tiles, BWD_CTAS[dt], sms)
    tiles = _tiles(b, h, w, th)
    nring = (th + 2) * (TW + 2)
    rp = torch.arange(nring)
    mt, m16 = rp // 16, rp % 16
    lane_g, hh = m16 % 8, m16 // 8
    pair = mt // 2
    warp, slot = pair % WARPS, (pair // WARPS) * 4 + (mt % 2) * 2 + hh
    n_slots = int(slot.max()) + 1
    ry, rx = rp // (TW + 2), rp % (TW + 2)
    own = (ry >= 1) & (ry <= th) & (rx >= 1) & (rx <= TW)
    # the ring's terms of each tile, (tiles, warps, slots, quads, 51)
    terms = torch.zeros(len(tiles) + 1, WARPS, n_slots, 8, small.shape[-1])
    sp = F.pad(small, (0, 0, 1, TW + 1, 1, th + 1))  # ring / overhang zeros
    for i, (bi, y0, x0) in enumerate(tiles):
        v = sp[bi, y0 + ry, x0 + rx] * own[:, None]
        yy, xx = y0 - 1 + ry, x0 - 1 + rx
        v = v * ((yy < h) & (xx < w))[:, None]
        terms[i, warp, slot, lane_g] = v
    # dW1: the 72 x 8 product of each own M tile, (tiles, warps, rows a
    # warp, 2 M tiles, 72, 8)
    xpad = F.pad(_pad8(pix.float()), (0, 0, 1, TW + 1, 1, th + 1))
    dpad = F.pad(dur, (0, 0, 0, TW, 0, th))
    rpw = -(-th // WARPS)
    prods = torch.zeros(len(tiles) + 1, WARPS, rpw, 2, 72, CP)
    col = torch.arange(16)
    for i, (bi, y0, x0) in enumerate(tiles):
        for oy in range(th):
            if y0 + oy >= h:
                break
            for m in range(2):
                xs = x0 + 16 * m + col
                a = torch.stack([xpad[bi, y0 + oy + dy, xs + dx]
                                 for dy in range(3) for dx in range(3)],
                                1).reshape(16, 72)  # (pixel, (tap, c))
                bmat = dpad[bi, y0 + oy, xs]        # (pixel, o)
                if dt == torch.bfloat16:
                    p = a.t() @ bmat
                else:
                    p = _split_product(a[:8].t(), bmat[:8]) + \
                        _split_product(a[8:].t(), bmat[8:])
                prods[i, oy % WARPS, oy // WARPS, m] = p
    # each CTA's lanes in order over its rounds
    cta = _cta_rounds(n_tiles, grid)                  # (grid, rounds)
    acc_s = torch.zeros(grid, WARPS, 8, small.shape[-1])
    acc_w = torch.zeros(grid, WARPS, 72, CP)
    for r in range(cta.shape[1]):
        tile = cta[:, r]                              # -1: the zero tile
        for s in range(n_slots):
            acc_s = acc_s + terms[tile, :, s]
        for j in range(rpw):
            for m in range(2):
                acc_w = acc_w + prods[tile, :, j, m]
    row_w = _warps_in_order(acc_w.flatten(-2))        # dW1 (tap, c, o)
    row_s = _warps_in_order(_column_sum(acc_s))
    part = torch.cat([row_w, row_s], 1)
    assert part.shape == (grid, dh.NARROW_PARTIALS)
    tot = _reduce_rows(part)
    dw1 = tot[:9 * CP * CP].reshape(3, 3, CP, CP)[:, :, :c, :c]
    sm = tot[9 * CP * CP:]
    dw2 = sm[3 * CP:6 * CP].reshape(CP, 3)[:c]
    return (dpix, dw1.permute(3, 2, 0, 1), sm[:c], sm[CP:CP + c],
            sm[2 * CP:2 * CP + c], dw2.t().reshape(3, c, 1, 1),
            sm[6 * CP:])


def _narrow_tail(pix, w1, b1, lns, lnb, w2, b2, go, approx, sms=SMS):
    """K3g / K4g's narrow route in torch: (out, dpix, dW1, db1, dLN scale,
    dLN bias, dW2, db2) in the plain versions' types and layouts."""
    return (_forward(pix, w1, b1, lns, lnb, w2, b2, approx),
            *_backward(pix, w1, b1, lns, lnb, w2, go, approx, sms))


# ---------------------------------------------------------------------------
# the arithmetic against JAX and the plain versions
# ---------------------------------------------------------------------------

# a ragged grid: 37 columns (a tile of 32 and one of 5), 18 rows (the JAX
# backward takes even heights); at 1 SM 16-row tiles, at 132 2-row ones
JAX_SHAPE = (1, 18, 37)


@pytest.mark.parametrize("approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_narrow_tail_matches_jax(c, dtype, approx):
    """The narrow route's arithmetic == the JAX ``fused_decoder_tail``
    (Pallas in interpret mode), forward and all seven gradients through
    its custom VJP, at C 1, 3 and 8 on a ragged grid. bf16: the forward
    within one bf16 step at the largest magnitude (2^-7 x max |out|), the
    gradients within tests/test_torch_decoder_head.py's 1e-2 x their max
    abs (both round at the same points; an fp32 sum in another order can
    cross a bf16 rounding boundary). fp32: the forward within 1e-4 x max
    |out| and the gradients within that file's 5e-4 (3xTF32 keeps ~21 bits
    of each product; the sums run in another order)."""
    b, h, w = JAX_SHAPE
    args = _inputs(30 + c, b, h, w, c)
    go = np.random.RandomState(c).randn(b, h, w, 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref_out = np.asarray(j_tail(*_jax_args(args, jdt), approx), np.float32)
    ref_grads = _jax_grads(args, jdt, approx, go)
    pix, w1, b1, lns, lnb, w2, b2 = _port_args(args, dtype)
    got = _narrow_tail(pix, w1, b1, lns, lnb, w2, b2, t(go), approx, sms=1)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    _close_rel(got[0].float().numpy(), ref_out,
               2.0 ** -7 if dtype == torch.bfloat16 else 1e-4, "out")
    for name, a, r in zip(NAMES, got[1:], ref_grads):
        assert tuple(a.shape) == r.shape, name
        _close_rel(a.float().numpy(), r, GRAD_RTOL[dtype], name)


@pytest.mark.parametrize("shape,c,sms", [
    ((2, 16, 12), 8, SMS), ((2, 12, 8), 8, SMS), ((1, 11, 21), 5, SMS),
    ((2, 37, 29), 3, 1), ((2, 40, 70), 8, 1), ((1, 9, 17), 1, 2),
    ((3, 34, 33), 7, 1)])
def test_narrow_tail_matches_plain(shape, c, sms):
    """The route's arithmetic in fp32 == the plain forward and backward
    within the limits chip_smoke.py holds the kernels to (K3 1e-4, K4 1e-3
    x each output's max abs); several tiles per CTA where ``sms`` is
    small, ragged tiles at both edges. LayerNorm over a few channels is
    ill-conditioned: at C 3 on (2, 37, 29) rstd reaches 272, and 3xTF32's
    ~2^-21 per product puts dpix 4.9e-5 x its max abs from a float64 run
    where the fp32 plain version lands 1.3e-5 away."""
    b, h, w = shape
    args = _port_args(_inputs(c + h, b, h, w, c), torch.float32)
    go = t(np.random.RandomState(c + w).randn(b, h, w, 3))
    got = _narrow_tail(*args, go, True, sms=sms)
    ref = (dh.fused_decoder_tail_reference(*args, True),
           *dh.fused_decoder_tail_bwd_reference(*args[:6], go, True))
    for name, a, r in zip(("out",) + NAMES, got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        err = (a - r).abs().max().item()
        tol = 1e-4 if name == "out" else 1e-3
        assert err <= tol * r.abs().max().item(), (name, err)


def test_reduction_order_is_the_launchs():
    """The rows are summed in the reduction launch's order (32 strided
    warps, their sums in order), not in row order: with values whose fp32
    sum depends on the order the two differ, and the restatement equals
    an explicit loop in that order."""
    rows = torch.zeros(70, dh.NARROW_PARTIALS)
    rows[:, 0] = torch.tensor([1e8 if i % 3 == 0 else (-1e8 if i % 3 == 1
                                                     else 3.0)
                               for i in range(70)])
    got = _reduce_rows(rows)[0]
    sums = []
    for wi in range(RED_WARPS):
        s = torch.tensor(0.0)
        for r in range(wi, 70, RED_WARPS):
            s = s + rows[r, 0]
        sums.append(s)
    want = sums[0]
    for s in sums[1:]:
        want = want + s
    assert torch.equal(got, want)
    in_row_order = torch.tensor(0.0)
    for v in rows[:, 0]:
        in_row_order = in_row_order + v
    assert not torch.equal(got, in_row_order)


# ---------------------------------------------------------------------------
# tiles, CTAs, the source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,th,tiles", [
    ((2, 64, 32), 2, 64),        # tiny_test's decoder at b2: 64 CTAs
    ((2, 896, 448), 16, 1568),   # an 8-channel Painter ViT-L decoder, b2
    ((1, 896, 448), 16, 784), ((2, 16, 12), 2, 16),
    ((1, 1280, 640), 16, 1600), ((1, 100, 33), 2, 100)])
def test_narrow_tiling(shape, th, tiles):
    """Tiles of 32 columns by the most of 16, 8, 4, 2 rows that gives two
    tiles per SM; every pixel is an own pixel of exactly one tile."""
    b, h, w = shape
    assert dh.narrow_tiling(b, h, w, SMS) == (th, tiles)
    seen = torch.zeros(b, h, w, dtype=torch.int64)
    for bi, y0, x0 in _tiles(b, h, w, th):
        seen[bi, y0:y0 + th, x0:x0 + TW] += 1
    assert torch.equal(seen, torch.ones_like(seen))


@pytest.mark.parametrize("tiles", [1, 63, 64, 528, 784, 1568, 5000])
def test_narrow_grid_is_balanced(tiles):
    """The persistent grid takes the tiles in as few rounds as the CTAs an
    SM allow, with no CTA idle and every tile taken once."""
    for k in range(1, 9):
        grid = dh.narrow_grid(tiles, k, SMS)
        rounds = -(-tiles // (k * SMS))
        assert 1 <= grid <= min(tiles, k * SMS)
        assert -(-tiles // grid) == rounds
        taken = _cta_rounds(tiles, grid)
        assert (taken >= 0).sum(1).min() >= 1
        assert sorted(taken[taken >= 0].tolist()) == list(range(tiles))


def _source():
    with open(f"{build.CSRC}/decoder_tail_generic.cu") as f:
        return f.read()


def _signature(src, name):
    """(pointers, ints) of an extern "C" launcher, the stream not counted."""
    args = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
    ptrs = sum("void*" in a for a in args) - 1
    ints = sum(a.split()[0] == "int" for a in args)
    return ptrs, ints


def test_narrow_source_matches_the_wrapper():
    """The source's tile, channel and partial-row constants are the
    wrapper's; its launchers take the arguments the wrapper passes; the
    product runs on mma.sync with ldmatrix, no atomics; the per-pixel
    scalar kernels are gone."""
    src = _source()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["CP"] == dh.NARROW_CHANNELS
    assert consts["TW"] == dh.NARROW_TILE_W
    assert consts["TH_MAX"] == max(dh.NARROW_TILE_ROWS)
    assert consts["WARPS"] == WARPS and consts["RED_WARPS"] == RED_WARPS
    assert "constexpr int NPART = 9 * CP * CP + 6 * CP + 3;" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in src
    assert "atomicAdd" not in src and "atom." not in src
    for gone in ("du_kernel", "dpix_kernel", "load8", "fmaf(",
                 "decoder_tail_generic_tiles"):
        assert gone not in src, gone
    for dt in ("bf16", "f32"):
        assert _signature(src, f"decoder_tail_generic_fwd_{dt}") == (8, 7)
        assert _signature(src, f"decoder_tail_generic_bwd_{dt}") == (10, 7)
        assert (f"int decoder_tail_generic_ctas_per_sm_{dt}(int bwd, int th, "
                f"int approx,") in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    for name in dh.NARROW_KERNEL_NAMES:
        assert name.split("::")[1].rstrip("<") + "(" in src, name
    assert "namespace narrow {" in src
    assert "painter_tpu/kernels/decoder_head.py:_fwd_impl" in src


@pytest.mark.parametrize("c", [1, 3, 8])
def test_narrow_wrappers_on_the_cpu_run_plain_and_count_no_launch(c):
    """CPU tensors at the narrow widths take the plain versions in both
    types; no route counts a launch; the route is "narrow" for C <= 8."""
    counters = (dh.fused_decoder_tail_generic,
                dh.fused_decoder_tail_bwd_generic, dh.fused_decoder_tail_tc,
                dh.fused_decoder_tail_bwd_tc)
    before = [fn.launches for fn in counters]
    for dtype in (torch.bfloat16, torch.float32):
        assert dh.generic_tail_route(c, dtype) == "narrow"
        args = _port_args(_inputs(c, 1, 4, 6, c), dtype)
        go = t(np.random.RandomState(2).randn(1, 4, 6, 3)).to(dtype)
        assert torch.equal(dh.fused_decoder_tail_generic(*args, True),
                           dh.fused_decoder_tail_reference(*args, True))
        got = dh.fused_decoder_tail_bwd_generic(*args[:6], go, False)
        ref = dh.fused_decoder_tail_bwd_reference(*args[:6], go, False)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert [fn.launches for fn in counters] == before
