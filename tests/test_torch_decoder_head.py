"""PyTorch port: the fused decoder tail's plain versions (K3 forward, K4
backward) against the JAX package's ``fused_decoder_tail``, which runs its
Pallas kernels in interpret mode on the CPU.

Inputs are numpy normals from a seed. Tolerances: fp32 forward 1e-4
absolute and gradients 5e-4 x each gradient's max abs (the JAX kernel
test's own limits, ``tests/test_decoder_head.py``). bf16: both sides round
at the same points (weights, row vectors, the GELU output, du and the
output cast to bf16), so they differ only where an fp32 sum taken in
another order lands on the other side of a bf16 rounding boundary: the
output by at most one bf16 step at its largest magnitude (2^-7 x max
|out|), the gradients by 1e-2 x their max abs (du's bf16 rounding flips,
each 2^-8 relative, summed over a 3x3 window and 64 channels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from painter_tpu.kernels.decoder_head import fused_decoder_tail as j_tail
from painter_tpu_torch.kernels import decoder_head as dh

from torch_port_common import t

GRAD_RTOL = {torch.float32: 5e-4, torch.bfloat16: 1e-2}
NAMES = ("dpix", "dconv1_w", "dconv1_b", "dln_w", "dln_b", "dconv2_w",
         "dconv2_b")


def _inputs(seed, b=2, h=16, w=12, c=8):
    """numpy (pix, conv1 HWIO, b1, LN scale, LN bias, conv2 HWIO, b2)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(b, h, w, c).astype(f),
            (0.2 * rng.randn(3, 3, c, c)).astype(f),
            (0.1 * rng.randn(c)).astype(f),
            (1.0 + 0.1 * rng.randn(c)).astype(f),
            (0.1 * rng.randn(c)).astype(f),
            (0.2 * rng.randn(1, 1, c, 3)).astype(f),
            (0.1 * rng.randn(3)).astype(f))


def _port_args(args, dtype):
    """The same values in the port's layout (conv weights (out, in, kh,
    kw)); pixels in ``dtype``, params fp32."""
    pix, c1k, c1b, lns, lnb, c2k, c2b = args
    return (t(pix).to(dtype), t(c1k.transpose(3, 2, 0, 1)), t(c1b), t(lns),
            t(lnb), t(c2k.transpose(3, 2, 0, 1)), t(c2b))


def _jax_args(args, dtype):
    return (jnp.asarray(args[0], dtype),) + tuple(jnp.asarray(a)
                                                  for a in args[1:])


def _jax_grads(args, dtype, approx, go):
    def loss(*a):
        out = j_tail(*a, approx).astype(jnp.float32)
        return jnp.sum(out * go)
    g = jax.grad(loss, argnums=tuple(range(7)))(*_jax_args(args, dtype))
    g = [np.asarray(x, np.float32) for x in g]
    # to the port's layouts
    g[1] = g[1].transpose(3, 2, 0, 1)
    g[5] = g[5].transpose(3, 2, 0, 1)
    return g


def _close_rel(got, ref, rtol, name):
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (name, err,
                                                          np.abs(ref).max())


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (2, 4, 8, 8)],
                         ids=["grid", "one_token_row"])
def test_forward_matches_jax_fp32(approx, shape):
    """fp32 forward, both GELU flavours; (2, 4, 8, 8) is a one-token-row
    grid at patch 4 (its row block is the whole height)."""
    b, h, w, c = shape
    args = _inputs(1, b, h, w, c)
    ref = np.asarray(j_tail(*_jax_args(args, jnp.float32), approx))
    got = dh.fused_decoder_tail(*_port_args(args, torch.float32), approx)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("approx", [False, True])
def test_forward_matches_jax_bf16(approx):
    args = _inputs(2)
    ref = np.asarray(j_tail(*_jax_args(args, jnp.bfloat16), approx),
                     np.float32)
    got = dh.fused_decoder_tail(*_port_args(args, torch.bfloat16), approx)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2.0 ** -7 * np.abs(ref).max(), err


def test_forward_matches_stock_tail_fp32():
    """The plain version == conv3x3 -> F.layer_norm -> GELU -> conv1x1."""
    args = _port_args(_inputs(3), torch.float32)
    pix, w1, b1, lns, lnb, w2, b2 = args
    x = F.conv2d(pix.permute(0, 3, 1, 2), w1, b1, padding=1)
    x = F.layer_norm(x.permute(0, 2, 3, 1), (8,), lns, lnb, eps=1e-6)
    ref = F.conv2d(F.gelu(x).permute(0, 3, 1, 2), w2, b2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        dh.fused_decoder_tail(*args, False).numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 12, 8), (2, 4, 8, 8)],
                         ids=["grid", "one_token_row"])
def test_backward_matches_jax(dtype, approx, shape):
    """The plain backward (the kernel's math) == jax.grad through the JAX
    kernel's custom VJP, all seven gradients."""
    b, h, w, c = shape
    args = _inputs(4, b, h, w, c)
    go = np.random.RandomState(5).randn(b, h, w, 3).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_grads(args, jdt, approx, go)
    pix, w1, b1, lns, lnb, w2, _ = _port_args(args, dtype)
    got = dh.fused_decoder_tail_bwd(pix, w1, b1, lns, lnb, w2,
                                    t(go).to(dtype), approx)
    assert got[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, a, r in zip(NAMES, got, ref):
        assert tuple(a.shape) == r.shape, name
        _close_rel(a.float().numpy(), r, GRAD_RTOL[dtype], name)


@pytest.mark.parametrize("approx", [False, True])
def test_autograd_function_reaches_all_seven_inputs(approx):
    """FusedDecoderTail: the forward is the plain forward, and backward
    through it gives every input its gradient, equal to the plain
    backward's, and to autograd of the stock fp32 tail."""
    args = _port_args(_inputs(6), torch.float32)
    leaves = [a.clone().requires_grad_() for a in args]
    go = t(np.random.RandomState(7).randn(2, 16, 12, 3))
    out = dh.decoder_tail_fn(*leaves, approx)
    np.testing.assert_array_equal(
        out.detach().numpy(), dh.fused_decoder_tail(*args, approx).numpy())
    (out * go).sum().backward()
    ref = dh.fused_decoder_tail_bwd(*args[:6], go, approx)
    for name, leaf, r in zip(NAMES, leaves, ref):
        assert leaf.grad is not None, name
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)

    stock = [a.clone().requires_grad_() for a in args]
    pix, w1, b1, lns, lnb, w2, b2 = stock
    x = F.conv2d(pix.permute(0, 3, 1, 2), w1, b1, padding=1)
    x = F.layer_norm(x.permute(0, 2, 3, 1), (8,), lns, lnb, eps=1e-6)
    x = F.gelu(x, approximate="tanh" if approx else "none")
    y = F.conv2d(x.permute(0, 3, 1, 2), w2, b2).permute(0, 2, 3, 1)
    (y * go).sum().backward()
    for name, leaf, s in zip(NAMES, leaves, stock):
        _close_rel(leaf.grad.numpy(), s.grad.numpy(), 5e-4, name)


def test_gelu_grad_matches_autograd():
    x = torch.linspace(-6, 6, 241, dtype=torch.float64, requires_grad=True)
    for approx in (False, True):
        y = F.gelu(x, approximate="tanh" if approx else "none")
        (g,) = torch.autograd.grad(y.sum(), x)
        torch.testing.assert_close(dh.gelu_grad(x.detach(), approx), g,
                                   rtol=1e-12, atol=1e-12)


def _box(x4, b, y, x0, tile, flat=False):
    """The (tile, C) TMA box of ``x4`` (B, H, W, C) at pixel (x0, y) of image
    b, zero where it leaves the image: a 4-D (C, W, H, B) map. ``flat``
    models a 3-D map over B*H rows instead, whose zero fill starts only at
    the first or last image."""
    bsz, h, w, c = x4.shape
    out = x4.new_zeros(tile, c)
    rows = x4.reshape(bsz * h, w, c) if flat else x4[b]
    row = b * h + y if flat else y
    lo, hi = max(x0, 0), min(x0 + tile, w)
    if 0 <= row < rows.shape[0] and hi > lo:
        out[lo - x0:hi - x0] = rows[row, lo:hi]
    return out


def _k4_split(pix, w1, b1, lns, lnb, w2, go, approx, tile, ctas, flat=False):
    """K4's three launches in plain torch, fp32. Units of ``tile`` pixels of
    one row; every tap is its own shifted box. (A) u per unit from nine
    boxes of pix, the LayerNorm / GELU backward per pixel, du and the small
    sums (partial rows per unit group, summed at the end); (B) dpix per
    unit from nine boxes of du against the rotated kernel; (C) dW1 as
    per-CTA split-K partials box^T . du, summed. Returns the seven
    gradients in the plain version's layouts."""
    bsz, h, w, c = pix.shape
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]
    wk = w1.permute(2, 3, 1, 0).reshape(9, c, c)  # (tap, c, o)
    w2k = w2.reshape(3, c).t()
    units = [(b, y, x0) for b in range(bsz) for y in range(h)
             for x0 in range(0, w, tile)]
    du = torch.zeros_like(pix)
    small = torch.zeros(2 * ctas, 6 * c + 3)
    for i, (b, y, x0) in enumerate(units):
        n = min(tile, w - x0)
        u = sum(_box(pix, b, y + dy - 1, x0 + dx - 1, tile, flat) @ wk[3 * dy + dx]
                for dy, dx in taps)[:n] + b1
        mean = u.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((u - mean) ** 2).mean(-1, keepdim=True)
                           + dh.LN_EPS)
        xhat = (u - mean) * rstd
        nrm = xhat * lns + lnb
        gk = go[b, y, x0:x0 + n]
        dn = (gk @ w2k.t()) * dh.gelu_grad(nrm, approx)
        dxhat = dn * lns
        d = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        du[b, y, x0:x0 + n] = d
        g = dh._gelu(nrm, approx)
        small[i % (2 * ctas)] += torch.cat([
            d.sum(0), (dn * xhat).sum(0), dn.sum(0),
            (g.t() @ gk).reshape(-1), gk.sum(0)])
    dpix = torch.zeros_like(pix)
    dw1 = torch.zeros(ctas, 9, c, c)
    for i, (b, y, x0) in enumerate(units):
        n = min(tile, w - x0)
        dpix[b, y, x0:x0 + n] = sum(
            _box(du, b, y - dy + 1, x0 - dx + 1, tile, flat)
            @ wk[3 * dy + dx].t() for dy, dx in taps)[:n]
        d = _box(du, b, y, x0, tile, flat)
        for dy, dx in taps:
            dw1[i % ctas, 3 * dy + dx] += _box(
                pix, b, y + dy - 1, x0 + dx - 1, tile, flat).t() @ d
    sm = small.sum(0)
    return (dpix, dw1.sum(0).reshape(3, 3, c, c).permute(3, 2, 0, 1),
            sm[:c], sm[c:2 * c], sm[2 * c:3 * c],
            sm[3 * c:6 * c].reshape(c, 3).t().reshape(w2.shape), sm[6 * c:])


@pytest.mark.parametrize("approx", [False, True])
def test_backward_unit_split_matches_plain_fp32(approx):
    """K4's decomposition (per-unit du from shifted tap boxes, dpix from
    the rotated kernel, dW1 from split-K partials) == the plain backward in
    fp32 to 1e-5 x each gradient's max abs (sums in another order), on a
    ragged shape (W = 19: the last 8-pixel unit holds 3) whose boxes cross
    every image edge, in two images. With a 3-D map over B*H rows the
    first image's bottom halo reads the second image's top row: that model
    must differ, which pins the 4-D map."""
    b, h, w, c = 2, 5, 19, 16
    args = _port_args(_inputs(11, b, h, w, c), torch.float32)
    pix, w1, b1, lns, lnb, w2, _ = args
    go = t(np.random.RandomState(12).randn(b, h, w, 3).astype(np.float32))
    ref = dh.fused_decoder_tail_bwd_reference(pix, w1, b1, lns, lnb, w2, go,
                                              approx)
    got = _k4_split(pix, w1, b1, lns, lnb, w2, go, approx, tile=8, ctas=3)
    for name, a, r in zip(NAMES, got, ref):
        assert a.shape == r.shape, name
        _close_rel(a.numpy(), r.numpy(), 1e-5, name)
    leak = _k4_split(pix, w1, b1, lns, lnb, w2, go, approx, tile=8, ctas=3,
                     flat=True)
    assert not torch.allclose(leak[0], ref[0], rtol=1e-3, atol=1e-3)


def _strips(b, h, w, tile, sms):
    """``strips_of`` of ``csrc/decoder_tail_hopper.cuh``: strips of R rows
    (16, halved while fewer strips than SMs) -> (R, strips down an image,
    unit columns, total strips)."""
    xt = -(-w // tile)
    r = 16
    while r > 2 and b * xt * -(-h // r) < sms:
        r //= 2
    ys = -(-h // r)
    return r, ys, xt, b * xt * ys


def _k3_split(pix, w1, b1, lns, lnb, w2, b2, approx, tile, sms, flat=False):
    """K3's bf16 route in plain torch, fp32: persistent CTAs (one per SM, at
    most one per strip) walk strips of R rows of one ``tile``-pixel unit
    column, decoded as ``Strips::decode``; every row of a strip is u from
    nine shifted tap boxes (a 4-D map, or the 3-D one with ``flat``), then
    the per-pixel LayerNorm / GELU / 64 -> 3 epilogue; rows past H are
    computed and masked. Returns the output and how often each pixel was
    written."""
    bsz, h, w, c = pix.shape
    wk = w1.permute(2, 3, 1, 0).reshape(9, c, c)  # (tap, c, o)
    w2k = w2.reshape(3, c).t()
    r, ys, xt, total = _strips(bsz, h, w, tile, sms)
    grid = min(sms, total)
    out = torch.zeros(bsz, h, w, 3)
    hits = torch.zeros(bsz, h, w, dtype=torch.int64)
    for cta in range(grid):
        for st in range(cta, total, grid):
            col, rest = st % xt, st // xt
            b, y0, x0 = rest // ys, rest % ys * r, col * tile
            n = min(tile, w - x0)
            for y in range(y0, y0 + r):
                u = sum(_box(pix, b, y + dy - 1, x0 + dx - 1, tile, flat)
                        @ wk[3 * dy + dx]
                        for dy in range(3) for dx in range(3)) + b1
                mean = u.mean(-1, keepdim=True)
                rstd = torch.rsqrt(((u - mean) ** 2).mean(-1, keepdim=True)
                                   + dh.LN_EPS)
                g = dh._gelu((u - mean) * rstd * lns + lnb, approx)
                if y < h:
                    out[b, y, x0:x0 + n] = (g @ w2k + b2)[:n]
                    hits[b, y, x0:x0 + n] += 1
    return out, hits


@pytest.mark.parametrize("approx", [False, True])
def test_forward_strip_split_matches_plain_fp32(approx):
    """K3's decomposition (persistent CTAs over strips, u per unit row from
    nine shifted tap boxes, the epilogue per pixel) == the plain forward in
    fp32 to 1e-5 x max |plain|, on a ragged shape (W = 19: the last 8-pixel
    unit holds 3; H = 5 with R = 4: a short last strip) whose boxes cross
    every image edge, in two images; every pixel is written once. With a
    3-D map over B*H rows the first image's bottom halo reads the second
    image's top row: that model must differ, which pins the 4-D map."""
    b, h, w, c = 2, 5, 19, 16
    args = _port_args(_inputs(13, b, h, w, c), torch.float32)
    ref = dh.fused_decoder_tail_reference(*args, approx)
    assert h % _strips(b, h, w, 8, 8)[0] != 0
    got, hits = _k3_split(*args, approx, tile=8, sms=8)
    assert torch.equal(hits, torch.ones_like(hits))
    _close_rel(got.numpy(), ref.numpy(), 1e-5, "out")
    leak, _ = _k3_split(*args, approx, tile=8, sms=8, flat=True)
    assert not torch.allclose(leak, ref, rtol=1e-3, atol=1e-3)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain version: the wrappers raise."""
    args = [a.to("meta") for a in _port_args(_inputs(8), torch.float32)]
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail(*args, True)
    with pytest.raises(RuntimeError, match="no kernel"):
        dh.fused_decoder_tail_bwd(*args[:6], args[0][..., :3], True)


def test_kernel_sources_note_their_tpu_kernels_and_headers_are_hashed(
        tmp_path, monkeypatch):
    """Each new source names the TPU kernel it replaces and exposes a C
    launcher; an edit of a shared header (the fp32 pieces, the bf16 strip
    mainloop) changes the build targets of both decoder-tail sources that
    include it, so a stale library is never loaded."""
    import shutil
    from painter_tpu_torch.kernels import build
    notes = {
        "decoder_tail_fwd": "painter_tpu/kernels/decoder_head.py:_fwd_impl",
        "decoder_tail_bwd": "painter_tpu/kernels/decoder_head.py:_bwd_impl",
        "int8_mlp": "painter_tpu/kernels/int8_mlp.py:_int8_mlp_2d"}
    for name, note in notes.items():
        assert name in build.SOURCES
        with open(f"{build.CSRC}/{name}.cu") as f:
            src = f.read()
        assert note in src and 'extern "C"' in src, name
        if name.startswith("decoder_tail"):
            assert '#include "decoder_tail_hopper.cuh"' in src, name
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    tail = ("decoder_tail_fwd", "decoder_tail_bwd")
    for header in ("decoder_tail_common.cuh", "decoder_tail_hopper.cuh"):
        before = [build._target(name) for name in tail]
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        after = [build._target(name) for name in tail]
        assert all(a != b for a, b in zip(after, before)), header


def test_kernel_variant_edits_apply_to_the_sources(tmp_path):
    """Every design variant of ``utils/kernel_variants`` still finds each
    string it edits exactly once in the current sources, so the trials it
    times against the real kernel stay buildable."""
    from painter_tpu_torch.utils import kernel_variants as kv
    variants = {**{f"k3_{k}": v for k, v in kv.K3_VARIANTS.items()},
                **{f"k4_{k}": v for k, v in kv.K4_VARIANTS.items()}}
    for name, (source, edits) in variants.items():
        dst = tmp_path / name
        kv.apply_edits(edits, str(dst))
        assert (dst / f"{source}.cu").exists(), name
        for fname, pairs in edits.items():
            text = (dst / fname).read_text()
            assert all(new in text for _, new in pairs), (name, fname)
    with pytest.raises(ValueError, match="occurs 0 times"):
        kv.apply_edits({"decoder_tail_fwd.cu": [("no such text", "")]},
                       str(tmp_path / "missing"))
