"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``painter_tpu_torch/kernels/csrc``,
holds each kernel (K1 attention forward, K2 its backward, K3 / K4 the
fused decoder tail forward / backward, K5 the fused w8a8 MLP) against its
plain PyTorch version on the card, then drives the main paths at full
width and depth with random weights from a seed: serving SegGPT ViT-L
896x448 (bf16) through ``InContextModel``, in bf16 and quantized (int8,
and int8 with the fused MLP kernel); and training Painter ViT-L 896x448
(bf16 compute, fp32 params) with the fused decoder tail through
``painter_tpu_torch.train.train.main`` on a synthetic dataset, after
full-model gradient checks of K1/K2 against plain attention and of K3/K4
against the stock tail. Checks that each path went through its kernels,
and that K2, K3, K4 and K5 give the same bits on two runs of the same
inputs. Prints its findings, then a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is not 0 and the last line is not printed. Needs a CUDA device;
it imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from painter_tpu_torch.utils.cuda_timing import device_ms, event_ms

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak, same sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (scalar FMA)
H100_BYTES_PER_S = 3.35e12

BF16, FP32 = (torch.bfloat16,), (torch.bfloat16, torch.float32)
# K1 at the (batch*heads, (key grid), types) of the port's paths. At
# L=1568 (56x28) every BH the main path gives it: 16 = b1 trunk, 32 = b1
# prefix (2 streams x 16 heads), 64 = bucket-4 trunk, 128 = bucket-4
# prefix and b8 trunk, 256 = b8 prefix. Beside them the COCO-eval
# 1120x560 grid and the 14x14 windows of the windowed preset (b8).
K1_SHAPES = ((16, (56, 28), BF16), (32, (56, 28), FP32),
             (64, (56, 28), BF16), (128, (56, 28), FP32),
             (256, (56, 28), BF16), (16, (70, 35), FP32),
             (256, (14, 14), FP32))
# the shape of most main-path launches (3 + 21 of the 72), for the
# kernels line
K1_MAIN_SHAPE = (128, (56, 28))
# kernel vs plain: bf16 outputs round P and out to 8 mantissa bits
# (2^-9 relative) in other places than the plain version, on O(1)
# outputs; fp32 differs only by summation order and exp2f's ulps
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K2 at the (BH, (key grid), types) of the training path at batch 2:
# 64 = two streams x 2 x 16 heads in blocks 0-2, 32 in blocks 3-23; beside
# them the 70x35 grid and the 14x14 windows
K2_SHAPES = ((32, (56, 28), FP32), (64, (56, 28), FP32),
             (16, (70, 35), BF16), (256, (14, 14), BF16))
# the shape of most training-path launches (21 of 24 per micro-batch)
K2_MAIN_SHAPE = (32, (56, 28))
# K2 vs plain, max abs error over max |plain| of each of dq, dk, dv,
# d rel_h, d rel_w: bf16 rounds P and dS to 8 mantissa bits (2^-9) before
# the three products, in other places than the plain version; fp32
# differs only by summation order and exp2f's ulps
K2_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# fp32 ViT-L forward, kernel vs plain attention, [0,1] painted scale:
# 24 blocks of fp32 sums in another order
FWD_FP32_TOL = 1e-3
# bf16 ViT-L forward (the wgmma kernel that serves the path) against the
# same bf16 forward with plain attention, and the bf16 engine output
# against the fp32 plain forward, [0,1] scale: every activation is
# rounded to 8 mantissa bits (2^-9 relative) over 24 blocks; the bf16
# engine output was 5.7e-3 from the fp32 one on the H100
FWD_BF16_TOL = 3e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def phase_build():
    """Every kernel source at once, one nvcc process each."""
    from painter_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"# build {', '.join(paths)}: {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"# ptxas {name}: {line.strip()}")


def k1_case(bh, grid, dtype, seed, iters):
    """K1 and its plain version on one input; returns the row of numbers."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    g = torch.Generator(device="cuda").manual_seed(seed)
    length = grid[0] * grid[1]
    d = 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v = (rnd(bh, length, d) for _ in range(3))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    scale = d ** -0.5
    out, lse = fr.flash_attention_relpos(q, k, v, rel_h, rel_w, grid, scale)
    ref, ref_lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                       grid, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(torch.isfinite(out).all().item(), f"K1 non-finite at {bh}x{grid}")
    check(err <= K1_TOL[dtype] and lse_err <= 1e-3,
          f"K1 {dtype} {bh}x{grid}: max abs err {err} (tol "
          f"{K1_TOL[dtype]}), lse err {lse_err}")
    ms = event_ms(lambda: fr.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                                   grid, scale), iters)
    plain_ms = event_ms(lambda: fr.flash_attention_relpos_reference(
        q, k, v, rel_h, rel_w, grid, scale), max(1, iters // 2))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale),
                         iters)
    del bias
    # the card's own attention at head_dim 64 with no bias: not the same
    # function, a yardstick of the kernel's design only
    nobias_ms = event_ms(lambda: sdpa(q, k, v, scale=scale), iters)
    flops = 4 * bh * length * length * d
    es = q.element_size()
    nbytes = (4 * bh * length * d + bh * length * sum(grid)) * es \
        + bh * length * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bh": bh, "grid": list(grid), "dtype": str(dtype),
            "max_abs_err": err, "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "sdpa_nobias_ms": nobias_ms, "flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rate(row):
    """Achieved TFLOP/s and the share of the bound, for a '#' line."""
    return (f"{row['flop'] / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound")


def phase_k1(label):
    rows = []
    for i, (bh, grid, dtypes) in enumerate(K1_SHAPES):
        for dtype in dtypes:
            iters = 10 if dtype == torch.bfloat16 else 3
            row = k1_case(bh, grid, dtype, seed=i, iters=iters)
            rows.append(row)
            print(f"# K1 {row['dtype']} BH={bh} L={grid[0] * grid[1]} "
                  f"grid={grid[0]}x{grid[1]}: max_abs_err "
                  f"{row['max_abs_err']:.3e} kernel_ms {row['ms']:.4f} "
                  f"({_rate(row)}) plain_ms {row['plain_ms']:.4f} "
                  f"library_ms(sdpa+bias) {row['library_ms']:.4f} "
                  f"sdpa_nobias_ms(not the same function) "
                  f"{row['sdpa_nobias_ms']:.4f} bound_ms "
                  f"{row['bound_ms']:.4f} ({row['flop']:.4e} FLOP at "
                  f"{'989' if dtype == torch.bfloat16 else '67'} TFLOP/s, "
                  f"{row['bound_by']}) [{label}]")
    return rows


def k2_case(bh, grid, dtype, seed, iters):
    """K2 and its plain backward on one input; returns the row of numbers.

    out and lse come from K1's plain version on the same q, k, v and rel
    terms, dO from a seeded normal; both backwards read the same tensors.
    K2 runs twice and must agree with itself to the bit (no atomics).
    """
    from painter_tpu_torch.kernels import flash_relpos as fr
    g = torch.Generator(device="cuda").manual_seed(seed)
    length = grid[0] * grid[1]
    d = 64

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, dout = (rnd(bh, length, d) for _ in range(4))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    scale = d ** -0.5
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   grid, scale)
    args = (q, k, v, rel_h, rel_w, out, lse, dout, grid, scale)
    got = fr.flash_attention_relpos_bwd(*args)
    again = fr.flash_attention_relpos_bwd(*args)
    ref = fr.flash_attention_relpos_bwd_reference(*args)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "d_rel_h", "d_rel_w")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 {dtype} {bh}x{grid}: two runs on the same inputs differ")
    del again
    rel_errs = {}
    for name, a, b in zip(names, got, ref):
        check(torch.isfinite(a).all().item(),
              f"K2 {name} non-finite at {bh}x{grid}")
        rel_errs[name] = ((a.float() - b.float()).abs().max()
                          / b.float().abs().max()).item()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, ref))
    worst = max(rel_errs.values())
    check(worst <= K2_TOL[dtype],
          f"K2 {dtype} {bh}x{grid}: max abs err / max |plain| per output "
          f"{rel_errs} (tol {K2_TOL[dtype]})")
    del got, ref
    ms = event_ms(lambda: fr.flash_attention_relpos_bwd(*args), iters)
    plain_ms = event_ms(lambda: fr.flash_attention_relpos_bwd_reference(*args),
                       max(1, iters // 2))
    # the library's backward: SDPA with the materialized bias as a
    # grad-requiring attn_mask, its forward run once outside the timing
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length).detach().requires_grad_()
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=bias, scale=scale)
    library_ms = event_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves + [bias], dout, retain_graph=True), iters)
    del sdpa_out, bias
    # SDPA's backward with no bias: not the same function, a yardstick only
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, scale=scale)
    nobias_ms = event_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dout, retain_graph=True), iters)
    del sdpa_out, leaves
    flops = 10 * bh * length * length * d
    es = q.element_size()
    # read q, k, v, dO, out, rel_h, rel_w, lse; write dq, dk, dv and both
    # rel gradients
    nbytes = (5 * bh * length * d + 2 * bh * length * sum(grid)
              + 3 * bh * length * d) * es + bh * length * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bh": bh, "grid": list(grid), "dtype": str(dtype),
            "max_abs_err": err, "rel_errs": rel_errs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "sdpa_nobias_ms": nobias_ms, "flop": flops,
            "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_k2(label):
    rows = []
    for i, (bh, grid, dtypes) in enumerate(K2_SHAPES):
        for dtype in dtypes:
            iters = 10 if dtype == torch.bfloat16 else 2
            row = k2_case(bh, grid, dtype, seed=100 + i, iters=iters)
            rows.append(row)
            errs = " ".join(f"{n} {e:.2e}" for n, e in row["rel_errs"].items())
            print(f"# K2 {row['dtype']} BH={bh} L={grid[0] * grid[1]} "
                  f"grid={grid[0]}x{grid[1]}: max_abs_err "
                  f"{row['max_abs_err']:.3e} (err/max|plain|: {errs}; two "
                  f"runs bitwise equal) kernel_ms {row['ms']:.4f} "
                  f"({_rate(row)}) plain_ms {row['plain_ms']:.4f} "
                  f"library_ms(sdpa bwd, bias grad) {row['library_ms']:.4f} "
                  f"sdpa_nobias_ms(not the same function) "
                  f"{row['sdpa_nobias_ms']:.4f} "
                  f"bound_ms {row['bound_ms']:.4f} ({row['flop']:.4e} FLOP "
                  f"at {'989' if dtype == torch.bfloat16 else '67'} TFLOP/s, "
                  f"{row['bound_by']}) [{label}]")
    return rows


# K3 / K4 at the trainer's b2 (2, 896, 448) in bf16 and fp32, a ragged
# shape (neither side a multiple of the 16 / 14-pixel tiles) and the
# one-token-row grid (16 pixel rows), both GELU flavours where cheap
TAIL_SHAPES = (((2, 896, 448), FP32, (True,)),
               ((2, 37, 29), FP32, (True, False)),
               ((2, 16, 448), BF16, (True, False)))
TAIL_MAIN_SHAPE = (2, 896, 448)
# kernel vs plain, max abs error over max |plain| of each output. bf16:
# both round at the same points (weights, GELU output, du, the outputs),
# so they differ only where an fp32 sum in another order crosses a bf16
# rounding boundary (one step, 2^-8 relative; du's flips summed over a
# 3x3 window and 64 channels in dpix and dW1); fp32: summation order only,
# but K4's dW1 and LN sums add ~8e5 pixels' terms (per-tile partials, then
# a sum of 1024 partials against cuDNN's order: 9.1e-5 measured on an H100)
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
K4_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
TAIL_GRADS = ("dpix", "dW1", "db1", "dln_scale", "dln_bias", "dW2", "db2")


def _stock_tail(pix, w1, b1, lns, lnb, w2, b2, approx):
    """The library yardstick: cuDNN conv3x3 + F.layer_norm + F.gelu +
    conv1x1 in the input type (channels-last), as the xla decoder tail."""
    dt = pix.dtype
    x = torch.nn.functional.conv2d(pix.permute(0, 3, 1, 2), w1.to(dt),
                                   b1.to(dt), padding=1)
    x = torch.nn.functional.layer_norm(
        x.permute(0, 2, 3, 1).float(), (x.shape[1],), lns, lnb,
        eps=1e-6).to(dt)
    x = torch.nn.functional.gelu(x, approximate="tanh" if approx else "none")
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w2.to(dt),
                                      b2.to(dt)).permute(0, 2, 3, 1)


def tail_case(shape, dtype, approx, seed, iters):
    """K3 and K4 against their plain versions on one input; the rows of
    numbers of both."""
    from painter_tpu_torch.kernels import decoder_head as dh
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w = shape
    c = 64

    def rnd(*sh, scale=1.0, shift=0.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale + shift

    pix = rnd(b, h, w, c).to(dtype)
    params = (rnd(c, c, 3, 3, scale=(9 * c) ** -0.5), rnd(c, scale=0.1),
              rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
              rnd(3, c, 1, 1, scale=c ** -0.5), rnd(3, scale=0.1))
    go = rnd(b, h, w, 3).to(dtype)
    out = dh.fused_decoder_tail(pix, *params, approx)
    out_again = dh.fused_decoder_tail(pix, *params, approx)
    ref = dh.fused_decoder_tail_reference(pix, *params, approx)
    got_g = dh.fused_decoder_tail_bwd(pix, *params[:5], go, approx)
    again = dh.fused_decoder_tail_bwd(pix, *params[:5], go, approx)
    ref_g = dh.fused_decoder_tail_bwd_reference(pix, *params[:5], go, approx)
    torch.cuda.synchronize()
    check(torch.equal(out, out_again),
          f"K3 {dtype} {shape} approx={approx}: two runs on the same inputs "
          f"differ")
    check(all(torch.equal(a, x) for a, x in zip(got_g, again)),
          f"K4 {dtype} {shape} approx={approx}: two runs on the same inputs "
          f"differ")
    del again, out_again

    def rel(a, r):
        return ((a.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-30)).item()

    check(torch.isfinite(out).all().item(), f"K3 non-finite at {shape}")
    k3_err = rel(out, ref)
    k4_errs = {n: rel(a, r) for n, a, r in zip(TAIL_GRADS, got_g, ref_g)}
    for a, n in zip(got_g, TAIL_GRADS):
        check(torch.isfinite(a).all().item(), f"K4 {n} non-finite at {shape}")
    check(k3_err <= K3_TOL[dtype], f"K3 {dtype} {shape} approx={approx}: "
          f"err / max|plain| {k3_err} (tol {K3_TOL[dtype]})")
    check(max(k4_errs.values()) <= K4_TOL[dtype],
          f"K4 {dtype} {shape} approx={approx}: err / max|plain| "
          f"{k4_errs} (tol {K4_TOL[dtype]})")
    k3_abs = (out.float() - ref.float()).abs().max().item()
    k4_abs = max((a.float() - r.float()).abs().max().item()
                 for a, r in zip(got_g, ref_g))
    del got_g, ref_g
    n_pix = b * h * w
    es = pix.element_size()
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    rows = {}
    for name, flops, nbytes, fn, plain, lib in (
            ("K3", 2 * n_pix * c * (9 * c + 3), n_pix * (c + 3) * es,
             lambda: dh.fused_decoder_tail(pix, *params, approx),
             lambda: dh.fused_decoder_tail_reference(pix, *params, approx),
             lambda: _stock_tail(pix, *params, approx)),
            ("K4", 2 * n_pix * c * (27 * c + 6), n_pix * (2 * c + 3) * es,
             lambda: dh.fused_decoder_tail_bwd(pix, *params[:5], go, approx),
             lambda: dh.fused_decoder_tail_bwd_reference(pix, *params[:5],
                                                         go, approx),
             None)):
        if lib is None:
            # the library's backward: autograd of the stock tail, its
            # forward run once outside the timing
            leaves = [pix.detach().clone().requires_grad_()] + [
                p.detach().clone().requires_grad_() for p in params]
            y = _stock_tail(*leaves, approx)

            def lib(y=y, leaves=leaves):
                return torch.autograd.grad(y, leaves, go, retain_graph=True)
        t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        rows[name] = {
            "shape": list(shape), "dtype": str(dtype), "approx": approx,
            "max_abs_err": k3_abs if name == "K3" else k4_abs,
            "rel_err": k3_err if name == "K3" else max(k4_errs.values()),
            "ms": event_ms(fn, iters),
            "device_ms": device_ms(fn, iters, dh.KERNEL_NAMES),
            "plain_ms": event_ms(plain, max(1, iters // 2)),
            "library_ms": event_ms(lib, iters), "flop": flops,
            "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        if name == "K4":
            del y, leaves
    rows["K4"]["rel_errs"] = k4_errs
    rows["K4"]["library_fwd_bwd_ms"] = rows["K3"]["library_ms"] + \
        rows["K4"]["library_ms"]
    return rows


def _opt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def phase_tail(label):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for i, (shape, dtypes, approxes) in enumerate(TAIL_SHAPES):
        for dtype in dtypes:
            for approx in approxes:
                big = shape == TAIL_MAIN_SHAPE
                iters = (10 if dtype == torch.bfloat16 else 3) if big else 5
                r = tail_case(shape, dtype, approx, seed=200 + i,
                              iters=iters)
                rows.append(r)
                k4e = " ".join(f"{n} {e:.1e}"
                               for n, e in r["K4"]["rel_errs"].items())
                for name in ("K3", "K4"):
                    x = r[name]
                    print(f"# {name} {x['dtype']} {shape} "
                          f"{'tanh' if approx else 'erf'}: err/max|plain| "
                          f"{x['rel_err']:.2e}"
                          + (f" ({k4e})" if name == "K4" else "")
                          + " (two runs bitwise equal)"
                          + f" kernel_ms {x['ms']:.4f} ({_rate(x)}) "
                          f"device_ms {_opt(x['device_ms'])} plain_ms "
                          f"{x['plain_ms']:.4f} library_ms(stock tail "
                          f"{'fwd' if name == 'K3' else 'bwd'}) "
                          f"{x['library_ms']:.4f}"
                          + (f" (fwd+bwd {x['library_fwd_bwd_ms']:.4f})"
                             if name == "K4" else "")
                          + f" bound_ms {x['bound_ms']:.4f} "
                          f"({x['flop']:.4e} FLOP, {x['bound_by']}) "
                          f"[{label}]")
    return rows


# K5 at the M (rows = batch x tokens) of the int8 serving paths: 12544 =
# b8 trunk, 25088 = b8 prefix (two streams), 1568 = b1 trunk, 3136 = b1
# prefix (image and target streams side by side), and a ragged 1000;
# ViT-L widths (1024 -> 4096 -> 1024)
K5_SHAPES = (12544, 25088, 1568, 3136, 1000)
K5_MAIN_M = 12544
# kernel vs plain, max abs error over max |plain|: the int32 sums are
# exact and the kernel rounds every fp32 step where the plain version
# does, so they agree to the bit where their tanh does; a tanh an ulp
# apart can move a hidden value across a requantization boundary (one
# int8 step of one hidden element, ~1/127 of its row's range, times one
# fc2 weight: up to ~1e-2 of the output's range)
K5_TOL = 2e-2


def k5_case(m, seed, iters):
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, n = 1024, 4096
    lins = []
    for k_in, k_out in ((d, n), (n, d)):
        lin = torch.nn.Linear(k_in, k_out, device="cuda")
        with torch.no_grad():
            lin.weight.normal_(0.0, 0.02, generator=g)
            lin.bias.normal_(0.0, 0.02, generator=g)
        lins.append(quant.QuantizedLinear.from_linear(lin))
    fc1, fc2 = lins
    x = torch.randn(m, d, generator=g, device="cuda").to(torch.bfloat16)
    x[1] = 0  # a zero row
    args = (x, fc1.weight.q, fc1.weight.scale, fc1.bias, fc2.weight.q,
            fc2.weight.scale, fc2.bias)
    out = k5.int8_mlp(*args)
    again = k5.int8_mlp(*args)
    ref = k5.int8_mlp_reference(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(out).all().item(), f"K5 non-finite at M={m}")
    check(torch.equal(out, again),
          f"K5 M={m}: two runs on the same inputs differ")
    del again
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = err / ref.float().abs().max().item()
    check(rel <= K5_TOL, f"K5 M={m}: err / max|plain| {rel} (tol {K5_TOL})")
    ops = 4 * m * d * n
    nbytes = 2 * m * d * x.element_size() + 2 * d * n + 4 * 2 * (d + n)
    t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    # a yardstick of another function: the same MLP in bf16 (dequantized
    # weights), two F.linear calls around the tanh GELU; never called by
    # the port
    wb = [(lin.weight.q.float() * lin.weight.scale[:, None]).to(x.dtype)
          for lin in (fc1, fc2)]
    bb = [lin.bias.to(x.dtype) for lin in (fc1, fc2)]
    lin = torch.nn.functional.linear

    def bf16_mlp():
        return lin(torch.nn.functional.gelu(lin(x, wb[0], bb[0]),
                                            approximate="tanh"), wb[1], bb[1])

    return {"m": m, "max_abs_err": err, "rel_err": rel,
            "bf16_linear_ms": event_ms(bf16_mlp, iters),
            "frac_differ": (diff > 0).float().mean().item(),
            "ms": event_ms(lambda: k5.int8_mlp(*args), iters),
            "plain_ms": event_ms(lambda: k5.int8_mlp_reference(*args),
                                max(1, iters // 2)),
            # the unfused w8a8 MLP, two torch._int_mm products
            "library_ms": event_ms(lambda: quant.mlp(x, fc1, fc2, True, "xla"),
                                  iters),
            "flop": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_k5(label):
    rows = []
    for i, m in enumerate(K5_SHAPES):
        r = k5_case(m, seed=300 + i, iters=10)
        rows.append(r)
        print(f"# K5 bf16 M={m} (1024->4096->1024): err/max|plain| "
              f"{r['rel_err']:.2e} (values that differ "
              f"{r['frac_differ']:.2e}; two runs bitwise equal) kernel_ms "
              f"{r['ms']:.4f} ({r['flop'] / r['ms'] / 1e9:.1f} TOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound) plain_ms "
              f"{r['plain_ms']:.4f} library_ms(unfused int8 MLP, "
              f"torch._int_mm) {r['library_ms']:.4f} bf16_linear_ms(two "
              f"bf16 F.linear, not the same function) "
              f"{r['bf16_linear_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.4f} ({r['flop']:.4e} int8 ops at 1979 "
              f"TOP/s, {r['bound_by']}) [{label}]")
    return rows


def _seeded_model(cfg, seed):
    from painter_tpu_torch.models import incontext_vit as tm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tm.build_model(cfg, gen, device="cuda")
    with torch.no_grad():
        # init zeroes the rel-pos tables, which would leave K1's bias
        # path untested
        for blk in model.blocks:
            blk.attn.rel_pos_h.normal_(0.0, 0.1, generator=gen)
            blk.attn.rel_pos_w.normal_(0.0, 0.1, generator=gen)
    return model


def _same_weights(model, cfg):
    """The same parameter tensors under another config (compute dtype)."""
    from painter_tpu_torch.models import incontext_vit as tm
    with torch.device("meta"):
        other = tm.InContextViT(cfg)
    other.load_state_dict(model.state_dict(), assign=True)
    return other.eval()


def phase_model(label):
    """SegGPT ViT-L through the engine: 1 and 3 prompts, b8 uint8."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops import image as image_ops

    cfg = configs.get_config("seggpt_vit_large_patch16_input896x448",
                             dtype="bfloat16")
    model = _seeded_model(cfg, 0)
    eng = engine.InContextModel(cfg, model, device="cuda")
    res = cfg.img_size[1]
    rng = np.random.RandomState(0)
    prompts = [(rng.rand(res, res, 3), rng.rand(res, res, 3))
               for _ in range(3)]
    query = rng.rand(res, res, 3)
    queries = (rng.rand(8, res, res, 3) * 255).astype(np.uint8)

    # the main path: K1's count is read around exactly these runs
    fr.flash_attention_relpos.launches = 0
    counts = []
    img1, tgt1 = engine.build_prompt_batch(query, prompts[:1])
    out1 = eng.run_one_image(img1, tgt1)
    counts.append(fr.flash_attention_relpos.launches)
    img3, tgt3 = engine.build_prompt_batch(query, prompts)
    out3 = eng.run_one_image(img3, tgt3)
    counts.append(fr.flash_attention_relpos.launches)
    out8 = eng.run_queries_shared(queries, *prompts[0], out_dtype=np.uint8)
    counts.append(fr.flash_attention_relpos.launches)
    launches = counts[-1]
    per_forward = np.diff([0] + counts).tolist()
    print(f"# main path K1 launches {launches}, per forward {per_forward}")
    check(per_forward == [cfg.depth] * 3,
          f"K1 must launch once per block per forward, got {per_forward}")
    check(out1.shape == (res, res, 3) and out3.shape == (res, res, 3),
          f"run_one_image shapes {out1.shape} {out3.shape}")
    check(np.isfinite(out1).all() and np.isfinite(out3).all(),
          "run_one_image painted non-finite values")
    check(out8.shape == (8, res, res, 3) and out8.dtype == np.uint8,
          f"run_queries_shared gave {out8.shape} {out8.dtype}")
    print(f"# run_one_image 1 prompt: range [{out1.min():.4f}, "
          f"{out1.max():.4f}]; 3 prompts (bucket 4): range "
          f"[{out3.min():.4f}, {out3.max():.4f}]; run_queries_shared b8 "
          f"uint8: mean {out8.mean():.2f}")

    # fp32 compute, one b1 forward: kernel attention vs plain attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m32 = _same_weights(model, configs.get_config(
        "seggpt_vit_large_patch16_input896x448", dtype="float32"))
    imgs = torch.from_numpy(img1).cuda()
    tgts = torch.from_numpy(tgt1).cuda()
    mask = image_ops.bottom_half_mask(1, cfg.num_patches, "cuda")
    st = torch.zeros((1, 1), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        outs = {impl: image_ops.denormalize(tm.predict_query_half(
            m32, imgs, tgts, mask, seg_type=st, attn_impl=impl))
            for impl in ("kernel", "plain")}
        outs16 = {impl: image_ops.denormalize(tm.predict_query_half(
            model, imgs, tgts, mask, seg_type=st, attn_impl=impl)).float()
            for impl in ("kernel", "plain")}
    fwd_err = (outs["kernel"] - outs["plain"]).abs().max().item()
    fwd16_err = (outs16["kernel"] - outs16["plain"]).abs().max().item()
    bf16_vs_fp32 = float(np.abs(out1 - outs["plain"].cpu().numpy()).max())
    print(f"# b1 forward, kernel vs plain attention: fp32 max abs "
          f"{fwd_err:.3e} (tol {FWD_FP32_TOL}), bf16 max abs "
          f"{fwd16_err:.3e} (tol {FWD_BF16_TOL}); bf16 engine output vs "
          f"fp32 plain: max abs {bf16_vs_fp32:.3e} (tol {FWD_BF16_TOL}) "
          f"[{label}]")
    check(fwd_err <= FWD_FP32_TOL, f"fp32 forward differs by {fwd_err}")
    check(fwd16_err <= FWD_BF16_TOL, f"bf16 forward differs by {fwd16_err}")
    check(bf16_vs_fp32 <= FWD_BF16_TOL,
          f"bf16 engine output is {bf16_vs_fp32} from the fp32 forward")
    return model, launches


def phase_times(model, label, what="bf16", profile=True):
    """b8 ensemble pairs/s (bench.py:120-147 semantics) and b1 p50 of
    ``model`` (``what`` names it); returns (pairs/s, b1 p50 ms)."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops import image as image_ops
    cfg = model.cfg
    h, w = cfg.img_size
    rng = np.random.RandomState(0)

    def inputs(batch):
        imgs = rng.randn(batch, h, w, 3)
        imgs[:, h // 2:] = imgs[:1, h // 2:]  # one shared query half
        tgts = rng.randn(batch, h, w, 3)
        return (torch.from_numpy(imgs).float().cuda(),
                torch.from_numpy(tgts).float().cuda(),
                image_ops.bottom_half_mask(batch, cfg.num_patches, "cuda"),
                torch.zeros((batch, 1), dtype=torch.long, device="cuda"))

    imgs, tgts, mask, st = inputs(8)

    def b8():
        return tm.predict_query_half(model, imgs, tgts, mask, seg_type=st,
                                     merge_between_batch=0)

    fr.flash_attention_relpos.launches = 0
    with torch.inference_mode():
        b8()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            out = b8()
        float(out.flatten()[0])  # fetch closes the timed region
        b8_s = (time.perf_counter() - t0) / iters
        check(fr.flash_attention_relpos.launches == cfg.depth * (1 + iters),
              f"timed b8 forwards launched K1 "
              f"{fr.flash_attention_relpos.launches} times, expected "
              f"{cfg.depth * (1 + iters)}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy = (profile_device(b8, f"one b8 forward ({what})", label)
                if profile else "not measured")

        i1, t1, m1, s1 = inputs(1)
        lat = []
        for _ in range(11):
            t0 = time.perf_counter()
            image_ops.denormalize(tm.predict_query_half(
                model, i1, t1, m1, seg_type=s1)).cpu().numpy()
            lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat[1:])
    print(f"# b8 ensemble ({what}): {8 / b8_s:.3f} pairs/s ({b8_s * 1e3:.2f} "
          f"ms per batch, peak memory {peak_gb:.2f} GB, device busy share "
          f"{busy}); b1 p50 latency incl. host fetch {p50 * 1e3:.2f} ms "
          f"[{label}]")
    return 8 / b8_s, p50 * 1e3


# int8 serving output against the bf16 output, relative Frobenius: the
# JAX package's own bound for its tiny int8 model (tests/test_quant.py)
INT8_REL_FRO = 5e-2


def phase_int8_serving(model, label):
    """SegGPT ViT-L bf16 served quantized through ``InContextModel``:
    quant "int8" (unfused w8a8 MLPs, K5 never launched) and "int8-fused"
    (K5 once per block per forward), each through run_queries_shared at
    b8 and run_one_image at b1, held against the bf16 output; then the
    timings of both beside bf16's. Returns K5's launches on the path."""
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import int8_mlp as k5
    cfg = model.cfg
    res = cfg.img_size[1]
    rng = np.random.RandomState(1)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    queries = (rng.rand(8, res, res, 3) * 255).astype(np.uint8)
    img1, tgt1 = engine.build_prompt_batch(rng.rand(res, res, 3),
                                           [(img2, tgt2)])

    def serve(eng):
        return (eng.run_queries_shared(queries, img2, tgt2),
                eng.run_one_image(img1, tgt1))

    outs = {"bf16": serve(engine.InContextModel(cfg, model, device="cuda"))}
    engines = {}
    k5_launches = 0
    for quant in ("int8", "int8-fused"):
        engines[quant] = engine.InContextModel(cfg, model, device="cuda",
                                               quant=quant)
        k5.int8_mlp.launches = 0
        outs[quant] = serve(engines[quant])
        launches = k5.int8_mlp.launches
        want = 0 if quant == "int8" else 2 * cfg.depth
        print(f"# {quant} serving: K5 launches {launches} over a b8 "
              f"run_queries_shared and a b1 run_one_image (expected {want})")
        check(launches == want, f"{quant}: K5 launched {launches} times")
        if quant == "int8-fused":
            k5_launches = launches

    def rel_fro(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for a, b in (("int8", "bf16"), ("int8-fused", "bf16"),
                 ("int8-fused", "int8")):
        devs = [rel_fro(x, y) for x, y in zip(outs[a], outs[b])]
        print(f"# {a} vs {b}: relative Frobenius deviation b8 "
              f"{devs[0]:.4e}, b1 {devs[1]:.4e} (bound {INT8_REL_FRO}) "
              f"[{label}]")
        for o in outs[a]:
            check(np.isfinite(o).all(), f"{a} painted non-finite values")
        check(max(devs) <= INT8_REL_FRO, f"{a} deviates {devs} from {b}")
    times = {name: phase_times(eng.model, label, what=name, profile=False)
             for name, eng in engines.items()}
    return k5_launches, times


def profile_device(fn, what, label):
    """Device time by kernel over one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel entries only: an operator's entry repeats the time
    # of the kernels it launched, and a user annotation on the device
    # timeline (the optimizer's step) spans kernels counted already
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    total = sum(dev_us(e) for e in events)
    if not total:
        print("# profile: the profiler saw no device time; breakdown not "
              "measured")
        return "not measured"
    top = sorted(events, key=dev_us, reverse=True)[:8]
    print(f"# profile of {what}: device {total / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall [{label}]")
    for e in top:
        print(f"#   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / total:5.1f}%"
              f"  x{e.count:<4d} {e.key[:90]}")
    # the host side of the same window: operators by self CPU time
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    print(f"# host self time of {what}: {host_us / 1e3:.2f} ms in "
          f"{sum(e.count for e in host)} operator calls; top:")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        print(f"#   {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    share = total / wall_us
    check(share <= 1.0, f"device time {total} us exceeds the wall time "
          f"{wall_us} us: the profile counts kernels twice")
    return f"{share:.3f}"


PAINTER = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"
# full-model gradients, K1/K2 vs plain attention. fp32: the loss to 1e-5
# relative and each gradient to 1e-3 x its own max abs (24 blocks of fp32
# sums in another order, forward and backward). bf16: relative L2 of the
# concatenated gradient, both runs rounding every activation to 8 mantissa
# bits in other places
GRAD_FP32_LOSS_RTOL, GRAD_FP32_RTOL, GRAD_BF16_REL_L2 = 1e-5, 1e-3, 5e-2


def _train_batch(cfg, batch, seed, accum=1):
    """A device batch of the training recipe's shapes: normal images and
    targets, the BEiT block mask (half the patches in blocks of 16 up to a
    quarter of them: 784 of 1568 and 392 at 896x448)."""
    from painter_tpu_torch.data.masking import BlockMaskingGenerator
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, w = cfg.img_size
    lead = (accum, batch) if accum > 1 else (batch,)
    gen = BlockMaskingGenerator(cfg.grid_size, cfg.num_patches // 2,
                                min_num_patches=16,
                                max_num_patches=cfg.num_patches // 4)
    rng = np.random.default_rng(seed)
    masks = np.stack([gen(rng).reshape(-1) for _ in range(accum * batch)])
    return {"imgs": torch.randn(*lead, h, w, 3, generator=g, device="cuda"),
            "tgts": torch.randn(*lead, h, w, 3, generator=g, device="cuda"),
            "mask": torch.from_numpy(masks.astype(np.uint8)).reshape(
                *lead, -1).cuda(),
            "valid": torch.ones(*lead, h, w, 3, dtype=torch.uint8,
                                device="cuda")}


def _loss_and_grads(model, batch, impl, decoder_impl="xla"):
    from painter_tpu_torch.models import incontext_vit as tm
    model.zero_grad(set_to_none=True)
    loss, _, _ = tm.forward(
        model, batch["imgs"], batch["tgts"], batch["mask"], batch["valid"],
        attn_impl=impl, train=True, remat=True, remat_policy="save_kernel",
        generator=torch.Generator(device="cuda").manual_seed(7),
        decoder_impl=decoder_impl)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _grad_pair(model, batch, what, label, fp32, kernel, other):
    """Loss and gradients of ``kernel`` against ``other`` (each a
    (attn_impl, decoder_impl) pair) on one micro-batch, held to the fp32
    or bf16 limits."""
    from painter_tpu_torch.kernels import decoder_head as dh
    dh.fused_decoder_tail.launches = dh.fused_decoder_tail_bwd.launches = 0
    loss_k, g_k = _loss_and_grads(model, batch, *kernel)
    launches = (dh.fused_decoder_tail.launches,
                dh.fused_decoder_tail_bwd.launches)
    loss_p, g_p = _loss_and_grads(model, batch, *other)
    check(launches == ((1, 1) if kernel[1] == "fused" else (0, 0)),
          f"{what}: K3 / K4 launched {launches}")
    check(all(torch.isfinite(g).all().item() for g in g_k.values()),
          f"{what}: kernel gradients are not finite")
    if fp32:
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        rel = {n: ((g_k[n] - g_p[n]).abs().max()
                   / g_p[n].abs().max().clamp_min(1e-30)).item() for n in g_p}
        worst = max(rel, key=rel.get)
        print(f"# grad check {what} fp32 b1: loss {loss_k:.7f} vs "
              f"{loss_p:.7f} (rel err {loss_err:.2e}, tol "
              f"{GRAD_FP32_LOSS_RTOL}); worst gradient {worst} max abs err "
              f"/ max abs {rel[worst]:.2e} (tol {GRAD_FP32_RTOL}) [{label}]")
        check(loss_err <= GRAD_FP32_LOSS_RTOL,
              f"{what} fp32 loss differs: {loss_err}")
        check(rel[worst] <= GRAD_FP32_RTOL,
              f"{what} fp32 gradient {worst} differs by {rel[worst]}")
    else:
        num = sum(((g_k[n] - g_p[n]).double() ** 2).sum() for n in g_p)
        den = sum((g_p[n].double() ** 2).sum() for n in g_p)
        rel_l2 = (num / den).sqrt().item()
        print(f"# grad check {what} bf16 b2: loss {loss_k:.6f} vs "
              f"{loss_p:.6f}; concatenated gradient relative L2 "
              f"{rel_l2:.3e} (tol {GRAD_BF16_REL_L2}) [{label}]")
        check(rel_l2 <= GRAD_BF16_REL_L2,
              f"{what} bf16 gradients differ: {rel_l2}")


def phase_grad_check(label):
    """Painter ViT-L 896x448: one micro-batch's loss and every parameter's
    gradient with K1/K2 against the same step with plain attention, and
    with the fused tail (K3/K4) against the stock tail (same weights, mask
    and drop-path generator seed); fp32 at batch 1, bf16 at batch 2."""
    from painter_tpu_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = configs.get_config(PAINTER, dtype="float32")
    model = _seeded_model(cfg32, 1).train()
    m16 = _same_weights(model, configs.get_config(PAINTER,
                                                  dtype="bfloat16")).train()
    for m, fp32, batch in ((model, True, _train_batch(cfg32, 1, seed=2)),
                           (m16, False, _train_batch(cfg32, 2, seed=3))):
        _grad_pair(m, batch, "K1/K2 vs plain attention", label, fp32,
                   ("kernel", "xla"), ("plain", "xla"))
        _grad_pair(m, batch, "K3/K4 vs stock tail", label, fp32,
                   ("kernel", "fused"), ("kernel", "xla"))
    del model, m16
    torch.cuda.empty_cache()


def _write_dataset(root, n=12, seed=0):
    """``n`` (image, target) pairs of about 1000x700 px in the reference
    JSON format (two task types), smooth random content."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    pairs = []
    for i in range(n):
        size = (700 + rng.randint(0, 60), 1000 + rng.randint(0, 60))
        for name in ("img", "tgt"):
            small = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
            Image.fromarray(small).resize(size, Image.BICUBIC).save(
                f"{root}/{name}_{i}.png", compress_level=1)
        pairs.append({"image_path": f"img_{i}.png",
                      "target_path": f"tgt_{i}.png",
                      "type": ("derain_image2derain", "ade20k_image2semantic"
                               )[i % 2]})
    path = f"{root}/pairs.json"
    with open(path, "w") as f:
        json.dump(pairs, f)
    return path


def phase_train_cli(label):
    """The training main path: ``painter_tpu_torch.train.train.main`` on
    the Painter preset in bf16 (batch 2, accum 2, 3 updates, save_kernel
    remat, the fused decoder tail, validation), K1-K4 counted around
    exactly this run."""
    import os
    import tempfile
    from painter_tpu_torch import configs
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.train import train
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    data = os.path.join(root, "data")
    os.makedirs(data)
    pairs = _write_dataset(data)
    out = os.path.join(root, "run")
    updates, accum, val_batches = 3, 2, 3
    cfg = configs.get_config(PAINTER)
    args = train.get_args_parser().parse_args([
        "--data_path", data, "--json_path", pairs, "--val_json_path", pairs,
        "--output_dir", out, "--model", PAINTER, "--dtype", "bfloat16",
        "--input_size", *map(str, cfg.img_size),
        "--num_mask_patches", str(cfg.num_patches // 2),
        "--max_mask_patches_per_block", str(cfg.num_patches // 4),
        "--batch_size", "2", "--accum_iter", str(accum), "--epochs", "1",
        "--max_steps_per_epoch", str(updates), "--remat_policy",
        "save_kernel", "--decoder_impl", "fused", "--print_freq", "1",
        "--watchdog_freq", "1"])
    fr.flash_attention_relpos.launches = 0
    fr.flash_attention_relpos_bwd.launches = 0
    dh.fused_decoder_tail.launches = 0
    dh.fused_decoder_tail_bwd.launches = 0
    result = train.main(args)
    k1 = fr.flash_attention_relpos.launches
    k2 = fr.flash_attention_relpos_bwd.launches
    k3 = dh.fused_decoder_tail.launches
    k4 = dh.fused_decoder_tail_bwd.launches
    micro = updates * accum
    depth = result["model"].cfg.depth
    print(f"# training main path: K1 launches {k1} ({micro} micro-batches "
          f"+ {val_batches} validation batches), K2 launches {k2}: per "
          f"micro-batch K1 {(k1 - depth * val_batches) / micro:g}, K2 "
          f"{k2 / micro:g}; K3 launches {k3}, K4 launches {k4} (one each "
          f"per micro-batch; validation keeps the stock tail)")
    check(result["step"] == updates, f"trained {result['step']} updates")
    check(k3 == micro and k4 == micro,
          f"K3 / K4 launched {k3} / {k4} times, expected {micro} each")
    check(k2 == depth * micro, f"K2 launched {k2} times, expected "
          f"{depth * micro}")
    check(k1 == depth * (micro + val_batches),
          f"K1 launched {k1} times, expected {depth * (micro + val_batches)}")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    with open(os.path.join(out, "log.txt")) as f:
        stats = json.loads(f.readline())
    check([s["step"] for s in scalars] == list(range(updates)),
          f"scalars.jsonl steps {[s['step'] for s in scalars]}")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              for s in scalars), f"non-finite loss or grad_norm {scalars}")
    check(np.isfinite(stats["train_loss"]) and np.isfinite(stats["val_loss"]),
          f"log.txt {stats}")
    ckpts = os.listdir(os.path.join(out, "checkpoints"))
    check(ckpts == [f"checkpoint-{updates}.pth"], f"checkpoints {ckpts}")
    print(f"# train.main: {updates} updates, losses "
          f"{[round(s['loss'], 5) for s in scalars]}, grad norms "
          f"{[round(s['grad_norm'], 4) for s in scalars]}, val loss "
          f"{stats['val_loss']:.5f}, wrote log.txt, scalars.jsonl, "
          f"{ckpts[0]} [{label}]")
    tmp.cleanup()
    return result, k1, k2, k3, k4


def phase_remat_full(result):
    """One extra micro-step under remat "full": K1 runs twice per block."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.train import step as step_lib
    model, opt = result["model"], result["optimizer"]
    step = step_lib.make_train_step(model.cfg, opt, accum_iter=1,
                                    remat_policy="full")
    batch = _train_batch(model.cfg, 2, seed=4)
    fr.flash_attention_relpos.launches = 0
    fr.flash_attention_relpos_bwd.launches = 0
    m = step(model, batch, torch.Generator(device="cuda").manual_seed(5))
    k1 = fr.flash_attention_relpos.launches
    k2 = fr.flash_attention_relpos_bwd.launches
    print(f"# remat full, one micro-step: K1 launches {k1}, K2 {k2}, loss "
          f"{m['loss'].item():.5f}")
    check(k1 == 2 * model.cfg.depth and k2 == model.cfg.depth,
          f"remat full launched K1 {k1} and K2 {k2} times")


def _timed_updates(step, model, batch, gen, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(model, batch, gen)
        float(m["loss"])  # the fetch closes the timed update
        times.append(time.perf_counter() - t0)
    return times


def phase_train_times(result, label):
    """ms per update at batch 2 x accum 2 (save_kernel remat) on a
    device-resident batch, updates 2..5, and a profile of one update; then
    the remat choices and the fused decoder tail in turns (save_kernel,
    full, none, fused = save_kernel with K3/K4), 2 rounds of 2 updates
    each after one warm-up update."""
    from painter_tpu_torch.train import step as step_lib
    model, opt = result["model"], result["optimizer"]
    batch = _train_batch(model.cfg, 2, seed=6, accum=2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    steps = {name: step_lib.make_train_step(
        model.cfg, opt, accum_iter=2, remat=name != "none",
        remat_policy=name if name in ("save_kernel", "full") else
        "save_kernel", decoder_impl="fused" if name == "fused" else "auto")
        for name in ("save_kernel", "full", "none", "fused")}
    step = steps["save_kernel"]
    step(model, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = _timed_updates(step, model, batch, gen, 4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per = statistics.mean(times)
    busy = profile_device(lambda: step(model, batch, gen),
                          "one training update (b2 x accum 2)", label)
    print(f"# training b2 x accum 2, bf16, save_kernel: "
          f"{per * 1e3:.2f} ms per update (updates 2..5: "
          f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), "
          f"{4 / per:.3f} samples/s, peak memory {peak_gb:.2f} GB, device "
          f"busy share {busy} [{label}]")
    by_name = {name: [] for name in steps}
    peaks = {}
    for name in steps:  # warm-up and peak memory of each
        torch.cuda.reset_peak_memory_stats()
        steps[name](model, batch, gen)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(2):
        for name, st in steps.items():
            by_name[name] += _timed_updates(st, model, batch, gen, 2)
    print("# remat and decoder tail in turns, ms per update (mean of 4; "
          "peak GB): " + "; ".join(
        f"{name} {statistics.mean(t) * 1e3:.2f} ({peaks[name]:.2f})"
        for name, t in by_name.items()) + f" [{label}]")


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"# phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def _kernel_entry(name, replaces, launches, row):
    return {"name": name, "route": "cuda",
            "source": f"painter_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def _row(rows, shape):
    return next(r for r in rows if (r["bh"], tuple(r["grid"])) == shape
                and r["dtype"] == str(torch.bfloat16))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    label = card_label()
    print(label)
    timed("build", phase_build)
    k1_rows = timed("K1 vs plain", phase_k1, label)
    k2_rows = timed("K2 vs plain", phase_k2, label)
    tail_rows = timed("K3/K4 vs plain", phase_tail, label)
    k5_rows = timed("K5 vs plain", phase_k5, label)
    model, serve_k1 = timed("serving drive", phase_model, label)
    bf16_times = timed("serving times", phase_times, model, label)
    serve_k5, int8_times = timed("int8 serving drive", phase_int8_serving,
                                 model, label)
    all_times = (bf16_times, *int8_times.values())
    print("# serving in bf16 / int8 / int8-fused: pairs/s (b8 ensemble) "
          + " / ".join(f"{t[0]:.3f}" for t in all_times) + "; b1 p50 ms "
          + " / ".join(f"{t[1]:.2f}" for t in all_times) + f" [{label}]")
    del model
    torch.cuda.empty_cache()
    timed("gradient check", phase_grad_check, label)
    result, train_k1, train_k2, train_k3, train_k4 = timed(
        "training drive", phase_train_cli, label)
    timed("remat full", phase_remat_full, result)
    timed("training times", phase_train_times, result, label)
    print(f"# K1 launches: serving main path {serve_k1}, training main path "
          f"{train_k1}; K2 launches: training main path {train_k2}; K3 / K4 "
          f"launches: training main path {train_k3} / {train_k4}; K5 "
          f"launches: int8-fused serving path {serve_k5}")
    tail = next(r for r in tail_rows if tuple(r["K3"]["shape"]) ==
                TAIL_MAIN_SHAPE and r["K3"]["dtype"] == str(torch.bfloat16))
    k5_row = next(r for r in k5_rows if r["m"] == K5_MAIN_M)
    kernels = [
        _kernel_entry("flash_relpos_fwd",
                      "painter_tpu/kernels/flash_relpos.py:399",
                      serve_k1 + train_k1, _row(k1_rows, K1_MAIN_SHAPE)),
        _kernel_entry("flash_relpos_bwd",
                      "painter_tpu/kernels/flash_relpos.py:438",
                      train_k2, _row(k2_rows, K2_MAIN_SHAPE)),
        _kernel_entry("decoder_tail_fwd",
                      "painter_tpu/kernels/decoder_head.py:180", train_k3,
                      tail["K3"]),
        _kernel_entry("decoder_tail_bwd",
                      "painter_tpu/kernels/decoder_head.py:304", train_k4,
                      tail["K4"]),
        _kernel_entry("int8_mlp", "painter_tpu/kernels/int8_mlp.py:87",
                      serve_k5, k5_row)]
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
