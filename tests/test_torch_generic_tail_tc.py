"""PyTorch port: the tensor-core route of the width-generic decoder tail
(K3g / K4g in bf16 at C >= 9 but 64), on the CPU. Its fp32 (3xTF32)
instantiation has its own tests (tests/test_torch_fp32_tail_tc.py).

``_tc_tail`` restates the kernels' arithmetic in plain torch: the
parameters packed and rounded to bf16 as the packing launch does; the
conv3x3 summed over the taps and 64-channel K chunks in the kernels'
order (tap major); the channels padded to a multiple of 8 and, in split
mode, cut between two warpgroups of NW channels each, whose LayerNorm
sums, centred squares, output dots and mean(dxhat), mean(dxhat xhat) are
summed as wg0 + wg1 (past 512 channels: N tiles of 512, u through a
scratch, the row's sums whole); LayerNorm over the real C; the GELU
output and du rounded to the input type; dpix the rotated taps over du's 64-channel
chunks; dW1 as partial sums over pixel slices of 64-pixel units; the
small gradients as per-unit partials. It is held against the JAX
``fused_decoder_tail`` (Pallas in interpret mode) and against the plain
versions. The route table (``decoder_route``, ``generic_tail_route``,
``generic_channels``) is pinned by shape and type, and the packed layout
against the C = 64 kernels' layouts. The kernels themselves run only on
the card (``chip_smoke.py`` ``phase_generic_tail``). Inputs are numpy
from a seed; tolerances with their reasons at each test.
"""
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

KCH = 64    # input channels per K chunk (csrc/decoder_tail_tc.cuh KCH)
TILE = 64   # pixels per unit (TILE)


def _nw_for(c, split):
    """The warpgroup width (decoder_tail_tc.cuh nw_for): NW >= C in
    whole-rows mode, >= C / 2 in split mode, a multiple of 64."""
    n = (c + 1) // 2 if split else c
    return -(-n // 64) * 64


def _wg_sum(v, nw, split):
    """Sum over the last axis as the kernels take it: per warpgroup, then
    wg0 + wg1 in split mode."""
    if not split:
        return v.sum(-1, keepdim=True)
    return v[..., :nw].sum(-1, keepdim=True) + v[..., nw:].sum(-1,
                                                             keepdim=True)


def _units(v, w):
    """(b, h, w, k) -> (units, 64, k): 64-pixel row segments, zero-padded
    past w, in the kernels' unit order (image, row, segment)."""
    b, h, _, k = v.shape
    xt = -(-w // TILE)
    v = F.pad(v, (0, 0, 0, xt * TILE - w))
    return v.reshape(b * h * xt, TILE, k)


def _tc_tail(pix, w1, b1, lns, lnb, w2, b2, go, approx, split, slices):
    """K3g / K4g's tensor-core route in torch, rounding where the kernels
    round. Returns (out, dpix, dW1, db1, dLN scale, dLN bias, dW2, db2) in
    the plain versions' types and layouts."""
    dt = pix.dtype
    b, h, w, c = pix.shape
    cd = dh.generic_channels(c, torch.bfloat16)
    tiles = c > dh.TC_ROW_CHANNELS  # N tiles; the row kernel's sums
    nw = 256 if tiles else _nw_for(c, split)
    nt = -(-cd // 512) * 512 if tiles else 2 * nw if split else nw
    split = split and not tiles
    kc = -(-cd // KCH)
    packed = dh.pack_reference(w1, b1, lns, lnb, w2, b2, cd, dt).float()
    parts = 2 if dt == torch.float32 else 1  # fp32: big + small tf32 parts
    p2 = 9 * cd * cd * parts
    w1p = F.pad(packed[:p2].reshape(parts, 9, cd, cd).sum(0),
                (0, kc * KCH - cd, 0, nt - cd))          # (tap, o, c)
    w1t = F.pad(packed[p2:2 * p2].reshape(parts, 9, cd, cd).sum(0),
                (0, kc * KCH - cd, 0, nt - cd))          # (tap, c, o)
    rows = packed[2 * p2:]
    vec = [F.pad(rows[i * cd:(i + 1) * cd], (0, nt - cd)) for i in range(3)]
    pb1, plns, plnb = vec
    pw2 = F.pad(rows[3 * cd:6 * cd].reshape(cd, 3), (0, 0, 0, nt - cd))
    pb2 = rows[6 * cd:6 * cd + 3]
    real = (torch.arange(nt) < c).float()

    def shifted(v, dy, dx):
        """v at (y + dy, x + dx), zero outside the image."""
        vp = F.pad(v, (0, 0, 1, 1, 1, 1))
        return vp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    def conv(src, wt, rot):
        """sum over (tap, 64-channel chunk) of the shifted boxes . the
        slab, tap major (W1P for the forward, W1T rotated for dpix)."""
        src = F.pad(src, (0, kc * KCH - src.shape[-1]))
        acc = torch.zeros(b, h, w, nt)
        for tap in range(9):
            dy, dx = tap // 3 - 1, tap % 3 - 1
            box = shifted(src, -dy, -dx) if rot else shifted(src, dy, dx)
            for k in range(kc):
                ch = slice(k * KCH, (k + 1) * KCH)
                acc = acc + box[..., ch] @ wt[tap][:, ch].t()
        return acc

    u = conv(pix.float(), w1p, False) + pb1
    mean = _wg_sum(u, nw, split) / c
    d = u - mean
    rstd = torch.rsqrt(_wg_sum(d * d * real, nw, split) / c + dh.LN_EPS)
    xhat = d * rstd * real
    n = xhat * plns + plnb
    g = dh._gelu(n, approx).to(dt).float()
    out = (_wg_sum(g[..., None, :] * pw2.t(), nw, split)[..., 0]
           + pb2).to(dt)
    gof = go.to(dt).float()
    dn = (gof @ pw2.t()) * dh.gelu_grad(n, approx)
    dxh = dn * plns
    mx = _wg_sum(dxh, nw, split) / c
    mxx = _wg_sum(dxh * xhat, nw, split) / c
    du = rstd * (dxh - mx - xhat * mxx) * real
    du_r = du.to(dt).float()
    dpix = conv(du_r[..., :cd], w1t, True)[..., :c].to(dt)
    # dW1: per slice of units, each unit's 64 pixels in one product
    units = b * h * -(-w // TILE)
    per = -(-units // slices)
    d_u = _units(du_r, w)
    parts = []
    for tap in range(9):
        x_u = _units(shifted(pix.float(), tap // 3 - 1, tap % 3 - 1), w)
        parts.append(torch.stack([
            sum((x_u[i].t() @ d_u[i] for i in range(s0, min(units,
                                                            s0 + per))),
                torch.zeros(c, nt))
            for s0 in range(0, units, per)]))
    dw1 = torch.stack(parts, 1).sum(0)[:, :, :c].reshape(3, 3, c, c)
    # small partials: per unit, summed in unit order
    small = [_units(v, w).sum(1).sum(0)[:c] for v in (du, dn * xhat, dn)]
    dw2 = torch.einsum("upc,upk->ck", _units(g * real, w),
                       _units(gof, w))[:c]
    db2 = _units(gof, w).sum(1).sum(0)
    return (out, dpix, dw1.permute(3, 2, 0, 1), *small,
            dw2.t().reshape(3, c, 1, 1), db2)


# ---------------------------------------------------------------------------
# the route table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,bf16_route,bf16_cp,f32_cp", [
    (1, "narrow", 8, 8), (8, "narrow", 8, 8), (9, "tc", 16, 16),
    (13, "tc", 16, 16), (16, "tc", 16, 16), (40, "tc", 40, 40), (100, "tc", 104, 104),
    (128, "tc", 128, 128), (160, "tc", 160, 160), (256, "tc", 256, 256),
    (264, "tc", 264, 264), (512, "tc", 512, 512), (513, "tc", 520, 520),
    (1000, "tc", 1000, 1000)])
def test_tc_route_table(c, bf16_route, bf16_cp, f32_cp):
    """C >= 9 goes to the tensor-core kernels in bf16 and fp32 (3xTF32),
    padded to a multiple of 8; C <= 8 to the narrow kernels, padded to 8 in
    shared memory, in both types. Every width is decoder_route's
    "generic"."""
    for dtype in (torch.bfloat16, torch.float32):
        assert dh.decoder_route(c, dtype) == "generic"
    assert dh.generic_tail_route(c, torch.bfloat16) == bf16_route
    assert dh.generic_tail_route(c, torch.float32) == bf16_route
    assert dh.generic_channels(c, torch.bfloat16) == bf16_cp
    assert dh.generic_channels(c, torch.float32) == f32_cp
    assert dh.generic_channels(c) == f32_cp


def test_tc_route_keeps_c64_on_the_vitl_kernels():
    for dtype in (torch.bfloat16, torch.float32):
        assert dh.decoder_route(64, dtype) == "vitl"
    with pytest.raises(TypeError, match="bf16 or fp32"):
        dh.generic_tail_route(40, torch.float16)
    with pytest.raises(ValueError, match="C >= 1"):
        dh.generic_tail_route(0, torch.bfloat16)


@pytest.mark.parametrize("c,split,nw", [(16, False, 64), (160, False, 192),
                                        (256, False, 256), (160, True, 128),
                                        (264, True, 192), (512, True, 256)])
def test_tc_warpgroup_widths(c, split, nw):
    """Whole rows up to 256 channels (m64n256 at most), split rows up to
    512: the widths the kernels are instantiated for."""
    assert _nw_for(c, split) == nw and nw in (64, 128, 192, 256)


# ---------------------------------------------------------------------------
# the packed parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [5, 8, 40])
def test_pack_reference_holds_the_scalar_layouts(c):
    """The packed buffer: W1 (tap, o, c), W1 (tap, c, o), b1, LN scale,
    LN bias, W2 (c, k), b2, each rounded to bf16 and zero-padded to the
    multiple of 8: at their offsets (csrc/decoder_tail_tc.cuh) the C = 64
    kernels' layouts (``_packed_params``) of the padded parameters."""
    args = _port_args(_inputs(c, 1, 4, 4, c), torch.bfloat16)
    pix, w1, b1, lns, lnb, w2, b2 = args
    cd = dh.generic_channels(c, torch.bfloat16)
    packed = dh.pack_reference(w1, b1, lns, lnb, w2, b2, cd)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == dh._packed_size(cd)
    p2, rows = 9 * cd * cd, 18 * cd * cd
    views = (packed[p2:2 * p2], packed[:p2], packed[rows:rows + cd],
             packed[rows + cd:rows + 2 * cd],
             packed[rows + 2 * cd:rows + 3 * cd],
             packed[rows + 3 * cd:rows + 6 * cd],
             packed[rows + 6 * cd:rows + 6 * cd + 3])
    pad = dh._pad_channels(pix, cd, (3,))
    ref = dh._packed_params(pad, dh._pad_channels(w1, cd, (0, 1)),
                            dh._pad_channels(b1, cd, (0,)),
                            dh._pad_channels(lns, cd, (0,)),
                            dh._pad_channels(lnb, cd, (0,)),
                            dh._pad_channels(w2, cd, (1,)))
    w1_tco, b1_r, lns_r, lnb_r, w2_r = ref
    assert torch.equal(views[0].reshape(3, 3, cd, cd), w1_tco)
    assert torch.equal(views[1].reshape(3, 3, cd, cd),
                       w1_tco.transpose(2, 3))
    for got, want in zip(views[2:6], (b1_r, lns_r, lnb_r, w2_r)):
        assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(views[6], b2.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the arithmetic against JAX and the plain versions
# ---------------------------------------------------------------------------

JAX_CASES = [(13, True), (16, False), (16, True), (40, False), (40, True),
             (160, False), (160, True), (264, True), (520, True)]


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("c,split", JAX_CASES)
def test_tc_tail_arithmetic_matches_jax(c, split, approx):
    """The tensor-core route's arithmetic in bf16 on a few pixels (1 x 8 x
    6: one unit a row) == the JAX ``fused_decoder_tail`` (Pallas in
    interpret mode, lanes padded to C), forward and all seven gradients
    through its custom VJP; C 13 padded to 16 channels; whole-rows and
    split modes (C 264: split only, past 256; C 520: N tiles, past 512),
    dW1 over 3 slices. Tolerances of tests/test_torch_decoder_head.py's
    bf16 cases: bf16 forward one bf16 step at the largest magnitude (2^-7
    x max |out|), gradients 1e-2 x their max abs (both round at the same points; an fp32 sum in another order can
    cross a bf16 rounding boundary, and du's flips add up in dpix and
    dW1)."""
    b, h, w = 1, 8, 6
    args = _inputs(20 + c, b, h, w, c)
    go = np.random.RandomState(c).randn(b, h, w, 3).astype(np.float32)
    ref_out = np.asarray(j_tail(*_jax_args(args, jnp.bfloat16), approx),
                         np.float32)
    ref_grads = _jax_grads(args, jnp.bfloat16, approx, go)
    pix, w1, b1, lns, lnb, w2, b2 = _port_args(args, torch.bfloat16)
    got = _tc_tail(pix, w1, b1, lns, lnb, w2, b2, t(go), approx, split, 3)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    err = np.abs(got[0].float().numpy() - ref_out).max()
    assert err <= 2.0 ** -7 * np.abs(ref_out).max(), err
    for name, a, r in zip(NAMES, got[1:], ref_grads):
        assert tuple(a.shape) == r.shape, name
        _close_rel(a.float().numpy(), r, GRAD_RTOL[torch.bfloat16], name)


@pytest.mark.parametrize("shape,c,split,slices", [
    ((2, 16, 12), 40, False, 1), ((2, 16, 12), 40, True, 4),
    ((1, 9, 70), 160, False, 2), ((1, 9, 70), 160, True, 5),
    ((1, 5, 7), 264, True, 1), ((2, 4, 65), 9, True, 3),
    ((1, 3, 5), 520, True, 2), ((1, 9, 70), 100, False, 2)])
def test_tc_tail_arithmetic_matches_plain(shape, c, split, slices):
    """The route's arithmetic in fp32 == the plain forward and backward
    within 1e-5 x each output's max abs (sums in another order; ragged
    units at W 70 and 65)."""
    b, h, w = shape
    args = _port_args(_inputs(c + h, b, h, w, c), torch.float32)
    go = t(np.random.RandomState(c).randn(b, h, w, 3))
    got = _tc_tail(*args, go, True, split, slices)
    ref = (dh.fused_decoder_tail_reference(*args, True),
           *dh.fused_decoder_tail_bwd_reference(*args[:6], go, True))
    for name, a, r in zip(("out",) + NAMES, got, ref):
        assert a.shape == r.shape, name
        err = (a - r).abs().max().item()
        assert err <= 1e-5 * r.abs().max().item(), (name, err)


# ---------------------------------------------------------------------------
# the wrappers and sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [16, 160, 264, 520])
def test_tc_wrappers_on_the_cpu_run_plain_and_count_no_launch(c):
    """bf16 CPU tensors at tensor-core widths take the plain versions; no
    route counts a launch."""
    args = _port_args(_inputs(c, 1, 4, 6, c), torch.bfloat16)
    go = t(np.random.RandomState(1).randn(1, 4, 6, 3)).to(torch.bfloat16)
    counters = (dh.fused_decoder_tail_generic, dh.fused_decoder_tail_tc,
                dh.fused_decoder_tail_bwd_generic,
                dh.fused_decoder_tail_bwd_tc)
    before = [fn.launches for fn in counters]
    out = dh.fused_decoder_tail_reference(*args, True)
    for fn in (dh.fused_decoder_tail_generic, dh.fused_decoder_tail_tc):
        assert torch.equal(fn(*args, True), out)
    ref = dh.fused_decoder_tail_bwd_reference(*args[:6], go, True)
    for fn in (dh.fused_decoder_tail_bwd_generic,
               dh.fused_decoder_tail_bwd_tc):
        got = fn(*args[:6], go, True)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert [fn.launches for fn in counters] == before


def test_tc_wrappers_refuse_other_devices_and_routes():
    """A meta tensor has no kernel; the tensor-core wrappers refuse a width
    off their route (C <= 8, in either type)."""
    args = [a.to("meta") for a in _port_args(_inputs(3, 1, 4, 4, 40),
                                             torch.bfloat16)]
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail_tc(*args, True)
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail_bwd_tc(*args[:6], args[0][..., :3], True)
    with pytest.raises(ValueError, match="tensor-core tail"):
        dh.fused_decoder_tail_tc(args[0][..., :5].float(), *args[1:], True)


def test_tc_sources_note_their_tpu_kernels():
    for name, fn in (("decoder_tail_tc_fwd", "_fwd_impl"),
                     ("decoder_tail_tc_bwd", "_bwd_impl")):
        assert name in build.SOURCES
        with open(f"{build.CSRC}/{name}.cu") as f:
            src = f.read()
        assert f"painter_tpu/kernels/decoder_head.py:{fn}" in src
        assert "What bounds it on an H100" in src and "wgmma" in src
        assert build._target(name).startswith(build.BUILD_DIR)
    with open(f"{build.CSRC}/decoder_tail_tc.cuh") as f:
        head = f.read()
    assert "MAX_ROW_C = 512" in head and "m64n256k16" in head
    assert dh.TC_ROW_CHANNELS == 512
