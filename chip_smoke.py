"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``painter_tpu_torch/kernels/csrc``,
holds each kernel (K1 attention forward, K2 its backward, K3 / K4 the
fused decoder tail forward / backward, K5 the fused w8a8 MLP) against its
plain PyTorch version on the card, then drives the main paths at full
width and depth with random weights from a seed: serving SegGPT ViT-L
896x448 (bf16) through ``InContextModel``; the tools of
``painter_tpu_torch/utils`` (the parity CLI on SegGPT and the windowed
Painter ViT-L, the float64 oracle against the fp32 forward, a profiler
trace, the component profile and the K1 / K2 stage profile); serving
again in bf16 and quantized (int8,
and int8 with the fused MLP kernel); the rest of serving through the
entry points a user calls: SegGPT's video protocol on 10 DAVIS-sized
frames through both prompt caches (bitwise equal, also after the device
cache's circular insert reorders the rows) and their steady rates over 56
more, ``seggpt_cli.main`` in image mode (bf16 and int8-fused), the HTTP
endpoint (``demo_app.serve``: single /paint requests, 8 concurrent ones
micro-batched, 8 clients in a closed loop, one /paint_video) and Painter
ViT-L's depth task through ``painter_task_inference``; Painter ViT-L's
eval protocols through ``painter_tpu_torch.evals`` on synthetic data
(ADE20K at 896x448, COCO panoptic at 1120x560, pose, and ADE20K under
``--quant int8-fused``), with the decoders on the card held to the same
decoders on the CPU; and training
Painter ViT-L 896x448 (bf16 compute, fp32 params) with the fused decoder
tail through ``painter_tpu_torch.train.train.main`` on a synthetic
dataset, after
full-model gradient checks of K1/K2 against plain attention and of K3/K4
against the stock tail. Then the data-parallel paths and the remat
policies: serving on two replicas of SegGPT ViT-L on the one card, one
micro-step of Painter ViT-L under each of the seven remat policies,
``train.main --distributed`` over NCCL at world size 1 (its first update
held to the non-distributed one's bits), and two gloo ranks on the one
card (spawned as ``chip_smoke.py --gloo-rank R --store FILE --out FILE``;
NCCL refuses two ranks on one device), fsdp 2 and dp 2 against one
process at the global batch. Last the training-data front end: synthetic
raw COCO panoptic and person keypoints, ADE20K and SIDD in their own
formats and sizes, through the port's prep CLI in subprocesses (the
instance and pose generators resizing and warping on the card, held to
the same generators on the CPU, their targets decoded back to the
annotations), the seccrop transform's host time with the native resize
and the dense one in turns, ``train.main`` of Painter ViT-L on the
generated sets with two spawned workers on the native ops, and
``python -m painter_tpu_torch.dryrun 2 --procs 2`` on the card. After
them, the shapes past the ViT-L kernels (none of the paths above launches
a width-generic kernel): the width-generic kernels K1g / K2g (every head
dim and key grid of the JAX kernel's domain), K3g / K4g (every decoder
width but 64, past 128 channels too) and K5g (the fused w8a8 MLP at every
K, N and row count, bf16 and fp32) against their plain versions at the
JAX package's kernel-test shapes and at odd, b1-sized and full widths;
tiny_test (head_dim 16, decoder width 8) serving
through ``InContextModel`` in bf16 and fp32 against plain attention, also
windowed (2x2 windows), and training through ``train.main --model
tiny_test --decoder_impl fused``; an fp32 b1 gradient check of Painter
ViT-L at 1280x640 (K1 and K2 on the 80x40 grid, K3 / K4 at 1280x640);
and Painter ViT-L training through ``train.main --input_size 1280 640``
(bf16, fused tail, b1 x accum 2); tiny_test served quantized (bf16 and
fp32 with the tanh GELU, quant int8 and int8-fused: K5g) and through
``seggpt_cli.main --model tiny_test --quant int8-fused``; tiny_test with
a 160-channel decoder trained through ``train.main`` on the fused tail,
and Painter ViT-L 896x448 with a 256-channel decoder (two updates, its ms
per update and K3g / K4g's device share), both on K3g / K4g's tensor-core
route (``csrc/decoder_tail_tc_*.cu``, every bf16 width from 9 but 64);
SegGPT ViT-L 896x448 in fp32 with the tanh GELU served at int8 and
int8-fused (K5 in fp32); and SegGPT at ViT-B width (768 -> 3072, 12
heads, 12 blocks) at 896x448 in bf16 and in fp32 with the tanh GELU,
served at int8 and int8-fused (K5g on the int8 tensor cores: 24 launches
per b8 + b1 pair, held to the unquantized output and, in fp32, to the
same forward with K5g's plain version). K2 at the 80x40 grid and K5 in fp32 are timed in
turns with K2g and K5g called directly. Checks that each path went through its
kernels, and that K2, K3, K4, K5, K2g, K3g, K4g and K5g give the same
bits on two runs of the same inputs. Prints its
findings, then a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Any failed check raises, so the
exit code is not 0 and the last line is not printed. Needs a CUDA device;
it imports nothing of JAX.
"""
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from painter_tpu_torch.utils.cuda_timing import (device_ms, device_ms_by_kernel,
                                              event_ms)

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak, same sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (scalar FMA)
# dense TF32 tensor-core peak, same sheet. An fp32-accurate product takes
# three TF32 products (3xTF32: big and small tf32 parts of each operand),
# so the least time for fp32 attention is 3 x FLOP at this rate
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12

BF16, FP32 = (torch.bfloat16,), (torch.bfloat16, torch.float32)
# K1 at the (batch*heads, (key grid), types) of the port's paths. At
# L=1568 (56x28) every BH the main path gives it: 16 = b1 trunk, 32 = b1
# prefix (2 streams x 16 heads), 64 = bucket-4 trunk, 128 = bucket-4
# prefix and b8 trunk, 256 = b8 prefix. Beside them the COCO-eval
# 1120x560 grid, the 14x14 windows of the windowed preset (b8) and the
# trainer's 80x40 grid at --input_size 1280 640 (b1).
K1_SHAPES = ((16, (56, 28), BF16), (32, (56, 28), FP32),
             (64, (56, 28), BF16), (128, (56, 28), FP32),
             (256, (56, 28), BF16), (16, (70, 35), FP32),
             (256, (14, 14), FP32), (16, (80, 40), FP32))
# the shape of most main-path launches (3 + 21 of the 72), for the
# kernels line
K1_MAIN_SHAPE = (128, (56, 28))
# kernel vs plain: bf16 outputs round P and out to 8 mantissa bits
# (2^-9 relative) in other places than the plain version, on O(1)
# outputs; fp32 differs only by summation order and exp2f's ulps
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K2 at the (BH, (key grid), types) of the training path at batch 2:
# 64 = two streams x 2 x 16 heads in blocks 0-2, 32 in blocks 3-23; beside
# them the 70x35 grid, the 14x14 windows and the trainer's 80x40 grid at
# --input_size 1280 640 (b1: 16 heads; 32 = the two streams of blocks 0-2)
K2_SHAPES = ((32, (56, 28), FP32), (64, (56, 28), FP32),
             (16, (70, 35), BF16), (256, (14, 14), BF16),
             (16, (80, 40), FP32), (32, (80, 40), FP32))
# the 80x40 grid, where K2 is timed in turns with K2g called directly
K2_1280_GRID = (80, 40)
# a grid whose bytes K2's bf16 launcher refuses: kh + kw = 128, one past
# the dq kernel's raw rel-term staging (32,800 B against its two 16 KiB
# ring stages); every other figure fits
K2_REFUSED_GRID = (100, 28)
# K2's kernels in a profile (csrc/flash_relpos_bwd.cu, bf16); K2g's are
# the templated dq_kernel< / dkv_kernel< of csrc/flash_relpos_generic.cu
K2_KERNEL_NAMES = ("hop::dq_kernel", "hop::dkv_kernel")
# the shape of most training-path launches (21 of 24 per micro-batch)
K2_MAIN_SHAPE = (32, (56, 28))
# the shape of most fp32 launches of K2: the 1280x640 update at b1 (21 of
# 24 per micro-batch)
K2_F32_MAIN_SHAPE = (16, (80, 40))
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
    """Every kernel source at once, one nvcc process each, beside the
    data workers' host library (g++)."""
    from painter_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all(build.SOURCES + build.HOST_SOURCES)
    print(f"# build {', '.join(paths)}: {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"# ptxas {name}: {line.strip()}")


def k1_case(bh, grid, dtype, seed, iters, d=64, fn=None):
    """K1 (or ``fn``, another forward wrapper) and its plain version on one
    input at head dim ``d``; returns the row of numbers."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    fn = fn or fr.flash_attention_relpos
    g = torch.Generator(device="cuda").manual_seed(seed)
    length = grid[0] * grid[1]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v = (rnd(bh, length, d) for _ in range(3))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    scale = d ** -0.5
    out, lse = fn(q, k, v, rel_h, rel_w, grid, scale)
    ref, ref_lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                       grid, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel_err = err / ref.float().abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(torch.isfinite(out).all().item(), f"K1 non-finite at {bh}x{grid}")
    check(err <= K1_TOL[dtype] and lse_err <= 1e-3,
          f"K1 {dtype} {bh}x{grid}: max abs err {err} (tol "
          f"{K1_TOL[dtype]}), lse err {lse_err}")
    ms = event_ms(lambda: fn(q, k, v, rel_h, rel_w, grid, scale), iters)
    plain_ms = event_ms(lambda: fr.flash_attention_relpos_reference(
        q, k, v, rel_h, rel_w, grid, scale), max(1, iters // 2))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale),
                         iters)
    del bias
    # the card's own attention with no bias: not the same
    # function, a yardstick of the kernel's design only
    nobias_ms = event_ms(lambda: sdpa(q, k, v, scale=scale), iters)
    flops = 4 * bh * length * length * d
    es = q.element_size()
    nbytes = (4 * bh * length * d + bh * length * sum(grid)) * es \
        + bh * length * 4
    return {"bh": bh, "grid": list(grid), "dtype": str(dtype), "hd": d,
            "max_abs_err": err, "rel_err": rel_err, "lse_err": lse_err,
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "sdpa_nobias_ms": nobias_ms, "flop": flops, "bytes": nbytes,
            **attention_bound(flops, nbytes, dtype)}


def attention_bound(flops, nbytes, dtype):
    """The least time of an attention call: bytes over the memory rate
    or its products over the peak of their type. fp32 products take
    three TF32 products each (3xTF32, ``H100_TF32_FLOPS``); beside it
    ``bound_fma_ms``, the same FLOP at the fp32 FMA rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        t_ops, fma = flops / H100_BF16_FLOPS * 1e3, None
    else:
        t_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        fma = max(flops / H100_FP32_FLOPS * 1e3, t_bytes)
    return {"bound_ms": max(t_ops, t_bytes), "bound_fma_ms": fma,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _bound_note(row, dtype):
    """The rate a row's bound_ms was taken at, for a '#' line."""
    if dtype == torch.bfloat16:
        return f"{row['flop']:.4e} FLOP at 989 TFLOP/s, {row['bound_by']}"
    return (f"3 x {row['flop']:.4e} FLOP at 495 TFLOP/s TF32 (3xTF32), "
            f"{row['bound_by']}; at the 67 TFLOP/s fp32 FMA rate "
            f"{row['bound_fma_ms']:.4f} ms")


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
                  f"{row['bound_ms']:.4f} ({_bound_note(row, dtype)}) "
                  f"[{label}]")
    return rows


def k2_case(bh, grid, dtype, seed, iters, d=64, fn=None):
    """K2 (or ``fn``, another backward wrapper) and its plain backward on
    one input at head dim ``d``; returns the row of numbers.

    out and lse come from K1's plain version on the same q, k, v and rel
    terms, dO from a seeded normal; both backwards read the same tensors.
    The kernel runs twice and must agree with itself to the bit (no
    atomics).
    """
    from painter_tpu_torch.kernels import flash_relpos as fr
    fn = fn or fr.flash_attention_relpos_bwd
    g = torch.Generator(device="cuda").manual_seed(seed)
    length = grid[0] * grid[1]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, dout = (rnd(bh, length, d) for _ in range(4))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    scale = d ** -0.5
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   grid, scale)
    args = (q, k, v, rel_h, rel_w, out, lse, dout, grid, scale)
    got = fn(*args)
    again = fn(*args)
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
    ms = event_ms(lambda: fn(*args), iters)
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
    return {"bh": bh, "grid": list(grid), "dtype": str(dtype), "hd": d,
            "max_abs_err": err, "rel_errs": rel_errs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "sdpa_nobias_ms": nobias_ms, "flop": flops,
            "bytes": nbytes, **attention_bound(flops, nbytes, dtype)}


def turns(fns, iters, rounds=2):
    """ms per call of each of ``fns`` (name -> callable), timed in turns
    A B .. B A (``rounds`` passes, the order reversed on every other one);
    each name's times over the passes."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(event_ms(fns[n], iters[n]))
    return out


def k2_turns(bh, grid, dtype, seed):
    """K2 and K2g (``flash_attention_relpos_bwd_generic``, called
    directly) on one input, timed in turns; each kernel's launches are
    checked on its own wrapper."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    g = torch.Generator(device="cuda").manual_seed(seed)
    length = grid[0] * grid[1]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, dout = (rnd(bh, length, 64) for _ in range(4))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   grid, 0.125)
    args = (q, k, v, rel_h, rel_w, out, lse, dout, grid, 0.125)
    before = _read_counts()
    t = turns({"K2": lambda: fr.flash_attention_relpos_bwd(*args),
               "K2g": lambda: fr.flash_attention_relpos_bwd_generic(*args)},
              {"K2": 10, "K2g": 3 if dtype == torch.bfloat16 else 1})
    after = _read_counts()
    check(after[0][1] > before[0][1] and after[1][1] > before[1][1]
          and after[0][0] == before[0][0],
          f"K2 / K2g turns at {bh}x{grid}: launches {before} -> {after}")
    return t


def k2_refusal():
    """K2's bf16 launcher, called directly at K2_REFUSED_GRID (which the
    route sends to K2g), refuses the grid its bytes exceed with
    cudaErrorInvalidValue and launches nothing."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    grid = K2_REFUSED_GRID
    length = grid[0] * grid[1]
    check(fr.attention_route(64, grid, length, torch.bfloat16,
                             backward=True) == "generic",
          f"{grid} is routed to K2")

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="cuda")

    qkv = [z(1, length, 64) for _ in range(4)]  # q, k, v, dO
    rel = [z(1, length, n) for n in grid]
    rows = [z(1, length, dtype=torch.float32) for _ in range(2)]  # lse, delta
    grads = [z(1, length, 64) for _ in range(3)] + [torch.empty_like(r)
                                                    for r in rel]
    ptrs = [t.data_ptr() for t in qkv[:3] + rel + qkv[3:] + rows + grads]
    before = _read_counts()
    rc = fr._bwd_kernel_fn(torch.bfloat16)(
        *ptrs, 1, length, grid[0], grid[1], 0.125,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    msg = fr._error_string("flash_relpos_bwd")(rc).decode()
    check(rc == 1, f"K2 at {grid} was not refused: rc {rc} ({msg})")
    check(_read_counts() == before, "a refused K2 launch was counted")
    print(f"# K2 bf16 launcher at {grid[0]}x{grid[1]}: refused ({msg}, "
          f"rc {rc}); no K2 / K2g launch counted")


def phase_k2(label):
    rows = []
    for i, (bh, grid, dtypes) in enumerate(K2_SHAPES):
        for dtype in dtypes:
            iters = 10 if dtype == torch.bfloat16 else 2
            row = k2_case(bh, grid, dtype, seed=100 + i, iters=iters)
            if grid == K2_1280_GRID or (dtype == torch.float32 and (
                    bh, grid) == K2_MAIN_SHAPE):
                t = k2_turns(bh, grid, dtype, seed=150 + i)
                row["turns_ms"] = t
                print(f"# K2 vs K2g (called directly) {row['dtype']} BH={bh} "
                      f"grid={grid[0]}x{grid[1]}, in turns K2 K2g K2g K2: "
                      f"K2 {', '.join(f'{x:.4f}' for x in t['K2'])} ms, K2g "
                      f"{', '.join(f'{x:.4f}' for x in t['K2g'])} ms "
                      f"[{label}]")
                # the route sends the grid to K2: K2 must be the faster
                check(max(t["K2"]) < min(t["K2g"]),
                      f"K2 {dtype} at {bh}x{grid} is routed to K2 but K2g "
                      f"was faster in turns: {t}")
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
                  f"bound_ms {row['bound_ms']:.4f} "
                  f"({_bound_note(row, dtype)}) [{label}]")
    k2_refusal()
    return rows


# K3 / K4 at the trainer's b2 (2, 896, 448) in bf16 and fp32, a ragged
# shape (neither side a multiple of the 16 / 14-pixel tiles), the
# one-token-row grid (16 pixel rows) and the trainer's b1 at
# --input_size 1280 640, both GELU flavours where cheap
TAIL_SHAPES = (((2, 896, 448), FP32, (True,)),
               ((2, 37, 29), FP32, (True, False)),
               ((2, 16, 448), BF16, (True, False)),
               ((1, 1280, 640), FP32, (True,)))
TAIL_MAIN_SHAPE = (2, 896, 448)
# the fp32 tail's main path: the 1280x640 fp32 update at b1 (fused tail)
PAINTER_1280_TAIL = (1, 1280, 640)
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


def tail_case(shape, dtype, approx, seed, iters, c=64, generic=False,
              stock_turns=False):
    """K3 and K4 (with ``generic``, K3g and K4g) against their plain
    versions on one input of width ``c``; the rows of numbers of both. In
    fp32 a profile checks that the 3xTF32 kernels ran; in fp32, and with
    ``stock_turns``, each is timed in turns with the stock tail."""
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    fwd = dh.fused_decoder_tail_generic if generic else dh.fused_decoder_tail
    bwd = (dh.fused_decoder_tail_bwd_generic if generic
           else dh.fused_decoder_tail_bwd)
    names = dh.GENERIC_KERNEL_NAMES if generic else dh.KERNEL_NAMES
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w = shape

    def rnd(*sh, scale=1.0, shift=0.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale + shift

    pix = rnd(b, h, w, c).to(dtype)
    params = (rnd(c, c, 3, 3, scale=(9 * c) ** -0.5), rnd(c, scale=0.1),
              rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
              rnd(3, c, 1, 1, scale=c ** -0.5), rnd(3, scale=0.1))
    go = rnd(b, h, w, 3).to(dtype)
    out = fwd(pix, *params, approx)
    out_again = fwd(pix, *params, approx)
    ref = dh.fused_decoder_tail_reference(pix, *params, approx)
    got_g = bwd(pix, *params[:5], go, approx)
    again = bwd(pix, *params[:5], go, approx)
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
    if dtype == torch.float32 and dh.generic_tail_route(c, dtype) == "tc":
        # the fp32 route (C = 64 and every generic "tc" width): the 3xTF32
        # kernels of csrc/decoder_tail_tc_*.cu and no other tail kernel
        # (two calls profiled: a profile can miss its first launches)
        seen = list(device_ms_by_kernel(
            lambda: (fwd(pix, *params, approx),
                     bwd(pix, *params[:5], go, approx)), 2,
            ("tc::", "hop::", "strip_kernel", "du_kernel<",
             "dpix_kernel<")))
        epis = (("FwdEpi<", "DuEpi<", "DpixEpi<")
                if c <= dh.TC_ROW_CHANNELS_F32
                else ("UEpi<", "row_fwd_kernel<", "row_bwd_kernel<"))
        check(all(any(e in k and "float" in k for k in seen) for e in epis)
              and any("dw1_tf32_kernel" in k for k in seen)
              and any("pack_kernel<float>" in k for k in seen)
              and all(k.startswith("tc::") and "bfloat16" not in k
                      for k in seen),
              f"fp32 tail {shape} C={c}: kernels {seen}")
    rows = {}
    for name, flops, nbytes, fn, plain, lib in (
            ("K3", 2 * n_pix * c * (9 * c + 3), n_pix * (c + 3) * es,
             lambda: fwd(pix, *params, approx),
             lambda: dh.fused_decoder_tail_reference(pix, *params, approx),
             lambda: _stock_tail(pix, *params, approx)),
            ("K4", 2 * n_pix * c * (27 * c + 6), n_pix * (2 * c + 3) * es,
             lambda: bwd(pix, *params[:5], go, approx),
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
        rows[name] = {
            "shape": list(shape), "dtype": str(dtype), "approx": approx,
            "c": c,
            "max_abs_err": k3_abs if name == "K3" else k4_abs,
            "rel_err": k3_err if name == "K3" else max(k4_errs.values()),
            "ms": event_ms(fn, iters),
            "split": device_ms_by_kernel(fn, iters, names),
            "plain_ms": event_ms(plain, max(1, iters // 2)),
            "library_ms": event_ms(lib, iters), "flop": flops,
            "bytes": nbytes, **attention_bound(flops, nbytes, dtype)}
        rows[name]["device_ms"] = sum(rows[name]["split"].values()) or None
        if dtype == torch.float32 or stock_turns:
            # the kernel and the stock tail (TF32 off) in turns
            rows[name]["turns"] = turns({"kernel": fn, "stock": lib},
                                        {"kernel": iters, "stock": iters})
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
                          f"({_bound_note(x, dtype)})"
                          + (f"; in turns with the stock tail (TF32 off) "
                             f"kernel {_ms_list(x['turns']['kernel'])} "
                             f"stock {_ms_list(x['turns']['stock'])} "
                             f"(3xTF32 route)" if "turns" in x else "")
                          + f" [{label}]")
    return rows


def _ms_list(times):
    return " / ".join(f"{t:.4f}" for t in times)


# K5 at the M (rows = batch x tokens) of the int8 serving paths: 12544 =
# b8 trunk, 25088 = b8 prefix (two streams), 1568 = b1 trunk, 3136 = b1
# prefix (image and target streams side by side), and a ragged 1000;
# ViT-L widths (1024 -> 4096 -> 1024), bf16 x, and fp32 x (the SegGPT
# ViT-L fp32 tanh-GELU serving path) at the four serving M
K5_SHAPES = ((12544, FP32), (25088, FP32), (1568, FP32), (3136, FP32),
             (1000, BF16))
K5_MAIN_M = 12544
# kernel vs plain, max abs error over max |plain|: the int32 sums are
# exact and the kernel rounds every fp32 step where the plain version
# does, so they agree to the bit where their tanh does. bf16: a tanh an
# ulp apart could move a hidden value across a requantization boundary
# (one int8 step of one hidden element, ~1/127 of its row's range, times
# one fc2 weight: up to ~1e-2 of the output's range). fp32: every reading
# on the card is 0 (K5 and K5g at every shape), so the limit is one a
# kernel that rounded x or its output through bf16 (~2^-9 of the range)
# would fail by three orders of magnitude
K5_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-6}


def _int8_mlp_layers(k, n, g):
    """Quantized fc1 (K -> N) and fc2 (N -> K) of N(0, 0.02) weights."""
    from painter_tpu_torch.ops import quant
    lins = []
    for k_in, k_out in ((k, n), (n, k)):
        lin = torch.nn.Linear(k_in, k_out, device="cuda")
        with torch.no_grad():
            lin.weight.normal_(0.0, 0.02, generator=g)
            lin.bias.normal_(0.0, 0.02, generator=g)
        lins.append(quant.QuantizedLinear.from_linear(lin))
    return lins


def k5_case(m, seed, iters, dtype=torch.bfloat16):
    """K5 through ``int8_mlp`` (routed there by shape) against its plain
    version on one input with a zero row; twice, bitwise. In fp32 also K5
    and K5g (``int8_mlp_generic``, called directly) in turns."""
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, n = 1024, 4096
    check(k5.int8_mlp_route(d, n, dtype) == "vitl",
          f"K {d} N {n} {dtype} is not routed to K5")
    fc1, fc2 = _int8_mlp_layers(d, n, g)
    x = torch.randn(m, d, generator=g, device="cuda").to(dtype)
    x[1] = 0  # a zero row
    args = (x, fc1.weight.q, fc1.weight.scale, fc1.bias, fc2.weight.q,
            fc2.weight.scale, fc2.bias)
    before = _read_counts()
    out = k5.int8_mlp(*args)
    again = k5.int8_mlp(*args)
    after = _read_counts()
    check(after[0][4] == before[0][4] + 2 and after[1] == before[1],
          f"K5 {dtype} M={m}: launches {before} -> {after}")
    ref = k5.int8_mlp_reference(*args)
    torch.cuda.synchronize()
    what = f"K5 {dtype} M={m}"
    check(out.dtype == dtype and torch.isfinite(out).all().item(),
          f"{what}: output")
    check(torch.equal(out, again),
          f"{what}: two runs on the same inputs differ")
    del again
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = err / ref.float().abs().max().item()
    check(rel <= K5_TOL[dtype],
          f"{what}: err / max|plain| {rel} (tol {K5_TOL[dtype]})")
    turns_ms = None
    if dtype == torch.float32:
        turns_ms = turns({"K5": lambda: k5.int8_mlp(*args),
                          "K5g": lambda: k5.int8_mlp_generic(*args)},
                         {"K5": iters, "K5g": max(1, iters // 2)})
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

    return {"m": m, "dtype": str(dtype), "max_abs_err": err,
            "rel_err": rel, "turns_ms": turns_ms,
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
    for i, (m, dtypes) in enumerate(K5_SHAPES):
        for dtype in dtypes:
            seed = 300 + i if dtype == torch.bfloat16 else 350 + i
            r = k5_case(m, seed=seed, iters=10, dtype=dtype)
            rows.append(r)
            lin = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"# K5 {r['dtype']} M={m} (1024->4096->1024): "
                  f"err/max|plain| {r['rel_err']:.2e} (values that differ "
                  f"{r['frac_differ']:.2e}; two runs bitwise equal) "
                  f"kernel_ms {r['ms']:.4f} ({r['flop'] / r['ms'] / 1e9:.1f}"
                  f" TOP/s, {100 * r['bound_ms'] / r['ms']:.1f}% of the "
                  f"bound) plain_ms {r['plain_ms']:.4f} library_ms(unfused "
                  f"int8 MLP, torch._int_mm) {r['library_ms']:.4f} "
                  f"{lin}_linear_ms(two {lin} F.linear, not the same "
                  f"function) {r['bf16_linear_ms']:.4f} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['flop']:.4e} int8 ops at 1979 "
                  f"TOP/s, {r['bound_by']}) [{label}]")
            if r["turns_ms"]:
                t = r["turns_ms"]
                print(f"# K5 vs K5g (called directly) {r['dtype']} M={m}, in "
                      f"turns K5 K5g K5g K5: K5 "
                      f"{', '.join(f'{x:.4f}' for x in t['K5'])} ms, K5g "
                      f"{', '.join(f'{x:.4f}' for x in t['K5g'])} ms "
                      f"[{label}]")
    k5_offset_case()
    return rows


def k5_offset_case(m=1568, seed=390):
    """K5 on an fp32 x that starts 4 bytes past a 16-byte boundary (a view
    into a flat buffer): ``int8_mlp`` copies it to an aligned tensor and
    launches K5 once, bit-equal to the call on an aligned copy; K5's
    launcher, given the unaligned pointer directly, refuses it with
    cudaErrorInvalidValue and launches nothing."""
    from painter_tpu_torch.kernels import int8_mlp as k5
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, n = 1024, 4096
    fc1, fc2 = _int8_mlp_layers(d, n, g)
    x = torch.randn(m * d + 1, generator=g, device="cuda")[1:].view(m, d)
    check(x.is_contiguous() and x.data_ptr() % 16 == 4,
          f"K5 offset x at {x.data_ptr() % 16} bytes past 16")
    w = (fc1.weight.q, fc1.weight.scale, fc1.bias, fc2.weight.q,
         fc2.weight.scale, fc2.bias)
    before = _read_counts()
    got = k5.int8_mlp(x, *w)
    after = _read_counts()
    check(after[0][4] == before[0][4] + 1 and after[1] == before[1],
          f"K5 offset x: launches {before} -> {after}")
    want = k5.int8_mlp(x.clone(), *w)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K5 on an offset x differs from the "
          "call on an aligned copy")
    vecs = [v.float().contiguous() for v in (w[1], w[2], w[4], w[5])]
    out = torch.empty(m, d, device="cuda")
    xq = torch.empty(m, d, dtype=torch.int8, device="cuda")
    hq = torch.empty(m, n, dtype=torch.int8, device="cuda")
    rows = torch.empty(2, m, device="cuda")
    before = _read_counts()
    rc = k5._kernel_fn("int8_mlp", "int8_mlp_fp32", 12, 3)(
        x.data_ptr(), w[0].data_ptr(), vecs[0].data_ptr(),
        vecs[1].data_ptr(), w[3].data_ptr(), vecs[2].data_ptr(),
        vecs[3].data_ptr(), out.data_ptr(), xq.data_ptr(),
        rows[0].data_ptr(), hq.data_ptr(), rows[1].data_ptr(), m, d, n,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    msg = k5._error_string("int8_mlp")(rc).decode()
    check(rc == 1 and _read_counts() == before,
          f"K5's launcher took an x 4 bytes past 16: rc {rc} ({msg})")
    print(f"# K5 fp32 M={m} on an x 4 bytes past a 16-byte boundary: one "
          f"K5 launch (on the wrapper's aligned copy), bit-equal to the "
          f"aligned call; the launcher given the offset x refuses it "
          f"({msg}, rc {rc})")


# K5g (csrc/int8_mlp_generic.cu) at (M, K, N, types): the JAX kernel
# test's K 128 / N 256 at its M 224 and a ragged 37 (zero rows), b1-sized M
# 1 and 16 (under cuBLASLt's M > 16), tiny_test's M 64 / K 32 / N 128, odd
# widths K 40 / N 136 and a ViT-B-wide 768 / 3072 at the b8 trunk's M
# 12544. SegGPT ViT-L's 1024 / 4096 is K5's in both types.
K5G_SHAPES = ((224, 128, 256, FP32), (37, 128, 256, FP32),
              (1, 128, 256, FP32), (16, 128, 256, FP32),
              (64, 32, 128, FP32), (37, 40, 136, FP32),
              (12544, 768, 3072, FP32))
# the ViT-B-wide SegGPT's b8 trunk in bf16 (phase_int8_vitb_serving),
# where K5g's time goes
K5G_MAIN = (12544, 768, 3072, torch.bfloat16)


def k5g_case(m, k, n, dtype, seed, iters):
    """K5g through ``int8_mlp`` (routed there by shape) against its plain
    version on one input with zero rows; twice, bitwise."""
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant
    check(k5.int8_mlp_route(k, n, dtype) == "generic",
          f"K {k} N {n} {dtype} is not routed to K5g")
    g = torch.Generator(device="cuda").manual_seed(seed)
    fc1, fc2 = _int8_mlp_layers(k, n, g)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    if m > 2:
        x[1] = 0  # a zero row
    args = (x, fc1.weight.q, fc1.weight.scale, fc1.bias, fc2.weight.q,
            fc2.weight.scale, fc2.bias)
    before = (k5.int8_mlp.launches, k5.int8_mlp_generic.launches)
    out = k5.int8_mlp(*args)
    again = k5.int8_mlp(*args)
    after = (k5.int8_mlp.launches, k5.int8_mlp_generic.launches)
    check(after == (before[0], before[1] + 2),
          f"K5g M={m} K={k} N={n}: launches {before} -> {after}")
    ref = k5.int8_mlp_reference(*args)
    torch.cuda.synchronize()
    what = f"K5g {dtype} M={m} K={k} N={n}"
    check(out.dtype == dtype and out.shape == (m, k)
          and torch.isfinite(out).all().item(), f"{what}: output")
    check(torch.equal(out, again), f"{what}: two runs differ")
    del again
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = err / ref.float().abs().max().item()
    check(rel <= K5_TOL[dtype],
          f"{what}: err / max|plain| {rel} (tol {K5_TOL[dtype]})")
    ops = 4 * m * k * n
    nbytes = 2 * m * k * x.element_size() + 2 * k * n + 4 * 2 * (k + n)
    t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    # the unfused w8a8 MLP, two torch._int_mm products, where cuBLASLt
    # takes both shapes; never called by K5g
    lib_ok = k5.int_mm_takes(m, k, n) and k5.int_mm_takes(m, n, k)
    profile = None
    if m * k * n > 1e9:
        # the device kernels of one call: the tensor-core products, and
        # none of the scalar design's gemm_kernel
        profile = device_ms_by_kernel(lambda: k5.int8_mlp(*args), 3,
                                      k5.K5G_KERNEL_NAMES + ("gemm_kernel",))
        check(any("tc_gemm" in name for name in profile)
              and not any("gemm_kernel" in name for name in profile),
              f"{what}: the profile shows {sorted(profile)}")
    return {"m": m, "k": k, "n": n, "dtype": str(dtype), "max_abs_err": err,
            "profile": profile,
            "rel_err": rel, "frac_differ": (diff > 0).float().mean().item(),
            "ms": event_ms(lambda: k5.int8_mlp(*args), iters),
            "plain_ms": event_ms(lambda: k5.int8_mlp_reference(*args),
                                 max(1, iters // 2)),
            "library_ms": (event_ms(lambda: quant.mlp(x, fc1, fc2, True,
                                                      "xla"), iters)
                           if lib_ok else None),
            "library_none": None if lib_ok else (
                "torch._int_mm's cuBLASLt path takes M > 16 and K, N "
                "multiples of 8"),
            "flop": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_k5_generic(label):
    """K5g against its plain version at every shape of K5G_SHAPES, each
    twice, bitwise; its launches through ``int8_mlp`` only."""
    rows = []
    for i, (m, k, n, dtypes) in enumerate(K5G_SHAPES):
        for dtype in dtypes:
            big = m * k * n > 1e9
            r = k5g_case(m, k, n, dtype, seed=700 + i, iters=5 if big else 10)
            rows.append(r)
            lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
                   else f"none ({r['library_none']})")
            print(f"# K5g {r['dtype']} M={m} K={k} N={n}: err/max|plain| "
                  f"{r['rel_err']:.2e} (values that differ "
                  f"{r['frac_differ']:.2e}; two runs bitwise equal) "
                  f"kernel_ms {r['ms']:.4f} ({r['flop'] / r['ms'] / 1e9:.1f} "
                  f"TOP/s, {100 * r['bound_ms'] / r['ms']:.2f}% of the "
                  f"bound) plain_ms {r['plain_ms']:.4f} library_ms(unfused "
                  f"int8 MLP, torch._int_mm) {lib} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['flop']:.4e} int8 ops at 1979 "
                  f"TOP/s, {r['bytes']:.4e} bytes at 3.35 TB/s: "
                  f"{r['bound_by']}) [{label}]")
            if r["profile"]:
                print(f"# K5g {r['dtype']} M={m} K={k} N={n}: device ms "
                      "per call by kernel "
                      + ", ".join(f"{name} {ms:.4f}" for name, ms in
                                  r["profile"].items()) + f" [{label}]")
    return rows


def _noisy_rel_pos(model, gen):
    """Random rel-pos tables: init zeroes them, which would leave K1's
    bias path untested."""
    with torch.no_grad():
        for blk in model.blocks:
            blk.attn.rel_pos_h.normal_(0.0, 0.1, generator=gen)
            blk.attn.rel_pos_w.normal_(0.0, 0.1, generator=gen)


def _seeded_model(cfg, seed):
    from painter_tpu_torch.models import incontext_vit as tm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = tm.build_model(cfg, gen, device="cuda")
    _noisy_rel_pos(model, gen)
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


# the parity CLI's tolerance (the JAX CLI's default): the fp32 forward
# (TF32 off) against the float64 oracle, painted output on the normalized
# scale and loss
PARITY_TOL = 1e-3
# the smoke's own limit on the oracle against the fp32 forward in its
# process: between that reading with TF32 off (~5e-6) and the same
# forward with TF32 on, which must exceed it, so a forward that kept TF32
# would fail
ORACLE_TOL = 1e-4
PARITY_MODELS = ("seggpt_vit_large_patch16_input896x448",
                 "painter_vit_large_patch16_input896x448_windowed")
# the component profile's chains in the smoke (the CLI keeps JAX's 16 /
# 64 / 48 and 3 reps); 2 reps, each length's time their minimum: with one,
# a host stall of ~250 ms in a 2-chain made a slope negative on an H100
TOOLS_N1, TOOLS_N2, TOOLS_REPS = 2, 6, 2
TOOLS_FWD_KEYS = {"block_ms", "mlp_ms", "ln_ms", "qkv_proj_ms",
                  "flash_kernel_ms"}
TOOLS_BWD_KEYS = {"block_ms", "attn_sub_ms", "mlp_sub_ms", "kernel_ms",
                  "decoder_ms", "loss_ms", "patch_embed_ms"}


def phase_tools(model, label):
    """The tools of ``painter_tpu_torch/utils``: the parity CLI on SegGPT
    and on the windowed Painter ViT-L (subprocesses, both at once); the
    float64 oracle against the fp32 forward of the seeded SegGPT (noisy
    rel-pos tables, K1's fp32 route), with TF32 off within ORACLE_TOL and
    with TF32 on beyond it; a ``profiling.trace`` of one b1 bf16
    serving forward, ``StepTimer`` and ``device_memory_stats``; the
    component profile of Painter ViT-L at b8 bf16 through K1 / K2 on short
    chains; the K1 / K2 stage profile, its ``full`` variants bitwise equal
    to the kernels. Returns K1's and K2's launches of the oracle check,
    the trace and the component profile (the stage profile's variants
    are not the path's kernels and are not counted)."""
    import glob
    import os
    import tempfile
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.ops.patches import unpatchify
    from painter_tpu_torch.utils import component_profile as cp
    from painter_tpu_torch.utils import kernel_stage_profile as ksp
    from painter_tpu_torch.utils import cuda_timing, parity, profiling
    from painter_tpu_torch.utils.torch_oracle import torch_forward

    # the parity CLI, both models at once
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "painter_tpu_torch.utils.parity", "--model",
         name], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in PARITY_MODELS}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            lines = out.strip().splitlines()
            check(proc.returncode == 0 and lines
                  and lines[-1] == "PARITY OK",
                  f"parity CLI --model {name} exited {proc.returncode}:\n"
                  f"{out[-2000:]}\n{err[-3000:]}")
            print(f"# parity CLI --model {name} (fp32, TF32 off, K1's fp32 "
                  f"route) vs the float64 oracle: {lines[-3].strip()}; "
                  f"{lines[-2].strip()} (tol {PARITY_TOL}) [{label}]")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    counters = (fr.flash_attention_relpos, fr.flash_attention_relpos_bwd)
    for c in counters:
        c.launches = 0
    # the oracle against the fp32 forward, noisy rel-pos tables
    cfg32 = configs.get_config(PARITY_MODELS[0], dtype="float32")
    m32 = _same_weights(model, cfg32)
    h, w = cfg32.img_size
    rng = np.random.RandomState(2)
    imgs = rng.randn(1, h, w, 3).astype(np.float32)
    tgts = rng.randn(1, h, w, 3).astype(np.float32)
    mask = np.zeros((1, cfg32.num_patches), np.float32)
    mask[:, cfg32.num_patches // 2:] = 1.0
    valid = np.ones_like(tgts)
    seg = np.zeros((1, 1), np.int32)
    def fp32_forward():
        with torch.no_grad():
            loss, patches, _ = tm.forward(
                m32, *(torch.from_numpy(a).cuda() for a in (imgs, tgts, mask,
                                                             valid)),
                seg_type=torch.from_numpy(seg).cuda().long())
            return (loss.item(),
                    unpatchify(patches, cfg32.patch_size).cpu().numpy())

    with parity.no_tf32():
        loss, pred = fp32_forward()
        k1_oracle = fr.flash_attention_relpos.launches
        ref_loss, ref_pred = torch_forward(m32.state_dict(), cfg32, imgs,
                                           tgts, mask, valid, seg_type=seg,
                                           device="cuda")
    # the same forward with TF32 on for cuBLAS and cuDNN
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss_tf32, pred_tf32 = fp32_forward()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
    k1_tf32 = fr.flash_attention_relpos.launches - k1_oracle
    pred_err = float(np.abs(pred - ref_pred).max())
    loss_err = abs(loss - ref_loss)
    tf32_pred_err = float(np.abs(pred_tf32 - ref_pred).max())
    tf32_loss_err = abs(loss_tf32 - ref_loss)
    print(f"# float64 oracle vs the fp32 forward of the seeded SegGPT "
          f"(rel-pos tables N(0, 0.1)): TF32 off painted max abs "
          f"{pred_err:.3e}, loss abs {loss_err:.3e} (tol {ORACLE_TOL}); "
          f"TF32 on painted max abs {tf32_pred_err:.3e}, loss abs "
          f"{tf32_loss_err:.3e} (must exceed {ORACLE_TOL}); K1 fp32 "
          f"launches {k1_oracle} + {k1_tf32} [{label}]")
    check(pred_err < ORACLE_TOL and loss_err < ORACLE_TOL,
          f"oracle vs fp32 forward: {pred_err}, {loss_err}")
    check(tf32_pred_err > ORACLE_TOL,
          f"the fp32 forward with TF32 on is {tf32_pred_err} from the "
          f"oracle: the limit {ORACLE_TOL} does not tell TF32 from fp32")
    check(k1_oracle == k1_tf32 == cfg32.depth,
          f"K1 launched {k1_oracle} and {k1_tf32} times in the fp32 "
          f"forwards")
    k1_oracle += k1_tf32

    # a trace of one b1 bf16 serving forward, StepTimer, memory stats
    eng = engine.InContextModel(model.cfg, model, device="cuda")
    res = model.cfg.img_size[1]
    img1, tgt1 = engine.build_prompt_batch(rng.rand(res, res, 3),
                                           [(rng.rand(res, res, 3),
                                             rng.rand(res, res, 3))])
    with tempfile.TemporaryDirectory() as d:
        # traced again (up to cuda_timing.CAPTURES times) while the trace
        # holds no kernel at all: the profiler's lost capture
        for _ in range(cuda_timing.CAPTURES):
            for old in glob.glob(os.path.join(d, "*.json")):
                os.remove(old)
            before = fr.flash_attention_relpos.launches
            with profiling.trace(d):
                eng.run_one_image(img1, tgt1)
            k1_trace = fr.flash_attention_relpos.launches - before
            files = glob.glob(os.path.join(d, "*.json"))
            check(len(files) == 1, f"trace wrote {files}")
            with open(files[0]) as f:
                text = f.read()
            if re.search(r'"cat":\s*"kernel"', text):
                break
        size = os.path.getsize(files[0])
    check("hop::fwd_kernel" in text, "the trace names no K1 kernel")
    timer = profiling.StepTimer(sync_every=2)
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    rates = [timer.step(x @ x) for _ in range(4)]
    check([r is None for r in rates] == [True, False, True, False]
          and all(r > 0 for r in rates[1::2]), f"StepTimer gave {rates}")
    mem = profiling.device_memory_stats()
    dev0 = mem.get("cuda:0", {})
    check(len(mem) == torch.cuda.device_count()
          and 70e9 < dev0.get("bytes_limit", 0) < 90e9
          and 0 < dev0["bytes_in_use"] <= dev0["peak_bytes_in_use"],
          f"device_memory_stats gave {mem}")
    print(f"# profiling.trace of one b1 bf16 serving forward: {size} bytes, "
          f"names K1's hop::fwd_kernel, K1 launches {k1_trace}; StepTimer "
          f"every 2nd step {[round(r, 3) for r in rates[1::2]]} steps/s; "
          f"device_memory_stats cuda:0 {dev0} [{label}]")
    check(k1_trace == model.cfg.depth, f"K1 launched {k1_trace} times in "
          f"the traced forward")
    del eng, m32, x

    # the component profile: Painter ViT-L b8 bf16, K1 / K2, short chains
    pcfg = configs.get_config(PAINTER, dtype="bfloat16", drop_path_rate=0.0)
    before = [c.launches for c in counters]
    fwd = cp.profile_forward(pcfg, 8, "kernel", n1=TOOLS_N1, n2=TOOLS_N2,
                             reps=TOOLS_REPS, device="cuda")
    bwd = cp.profile_backward(pcfg, 8, "kernel", "save_kernel", n1=TOOLS_N1,
                              n2=TOOLS_N2, reps=TOOLS_REPS, device="cuda")
    k1_cp, k2_cp = (c.launches - b for c, b in zip(counters, before))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"# component profile, {PAINTER} b8 bf16, kernel attention, "
          f"save_kernel, chains {TOOLS_N1} / {TOOLS_N2}, {TOOLS_REPS} reps: "
          f"FWD {json.dumps(fwd)} BWD {json.dumps(bwd)}; K1 launches "
          f"{k1_cp}, K2 {k2_cp} [{label}]")
    check(set(fwd) == TOOLS_FWD_KEYS and set(bwd) == TOOLS_BWD_KEYS,
          f"component profile keys {sorted(fwd)} {sorted(bwd)}")
    check(all(np.isfinite(v) and v > 0 for v in (*fwd.values(),
                                                  *bwd.values())),
          f"component profile times {fwd} {bwd}")
    # every chain is run once to warm and TOOLS_REPS times at each length:
    # K1 in block and flash forward chains and in the block, attention
    # and bare-kernel gradient chains, K2 in the last three
    runs = (1 + TOOLS_REPS) * (TOOLS_N1 + TOOLS_N2)
    check((k1_cp, k2_cp) == (5 * runs, 3 * runs),
          f"component profile launched K1 {k1_cp}, K2 {k2_cp} times, "
          f"expected {5 * runs}, {3 * runs}")

    # the K1 / K2 stage profile: variants are comparisons, not the path
    saved = [c.launches for c in counters]
    stages = ksp.profile(iters=5, reps=2)
    for c, n in zip(counters, saved):
        c.launches = n
    check(stages["full_bitwise_equal"] == {"fwd": True, "bwd": True},
          f"the full variants differ from the kernels: "
          f"{stages['full_bitwise_equal']}")
    times = [*stages["fwd"].values(), *stages["bwd"].values()]
    check(set(stages["fwd"]) == set(ksp.FWD_STAGES)
          and set(stages["bwd"]) == set(ksp.BWD_STAGES)
          and all(np.isfinite(t) and t > 0 for t in times),
          f"stage profile {stages}")
    for what in ("fwd", "bwd"):
        print(f"# stage profile {what} (bf16, BH 128, 56x28; ms per call): "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages[what].items())
              + f" [{label}]")
    print("# stage profile bwd device ms (dq kernel / dkv kernel): "
          + ", ".join(f"{k} {v['dq']:.4f} / {v['dkv']:.4f}" if v else
                      f"{k} not measured"
                      for k, v in stages["bwd_device_ms"].items())
          + f" [{label}]")
    print("STAGE_PROFILE " + json.dumps(stages))
    return k1_oracle + k1_trace + k1_cp, k2_cp


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


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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

    for a, b in (("int8", "bf16"), ("int8-fused", "bf16"),
                 ("int8-fused", "int8")):
        devs = [_rel_fro(x, y) for x, y in zip(outs[a], outs[b])]
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


# the endpoint's batched composites against another bf16 forward of the
# same request that rounds in other places: FWD_BF16_TOL on the painted
# [0,1] scale moves the composite input * (0.6 * out + 0.4) by at most
# 0.6 * 255 * 3e-2 = 4.59 uint8 steps, so 5
COMPOSITE_STEPS = 5
# DAVIS frames (SegGPT's video protocol), the demo's rolling cache depth
VIDEO_HW, VIDEO_FRAMES, VIDEO_CACHE = (480, 854), 10, 4
# the steady-rate video drive: the first 8 frames fill the cache (buckets
# 1, 2, 4, 4, 8, ...), the rate is read over the 48 after them, all at
# bucket 8
RATE_FRAMES, RATE_WARM = 56, 8
# the endpoint's rate drives: single /paint requests one after another
# (latency percentiles), then 8 clients that each send their next request
# as soon as the last is answered (requests/s, latency percentiles)
SINGLE_REQUESTS, CLIENTS, REQUESTS_PER_CLIENT = 20, 8, 8


def _smooth_u8(rng, hw):
    """A smooth synthetic uint8 RGB image (random 16x16 field, bicubic)."""
    from PIL import Image
    small = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
    return np.asarray(Image.fromarray(small).resize((hw[1], hw[0]),
                                                    Image.BICUBIC))


def _write_pngs(root, names, hw, seed):
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = []
    for name in names:
        path = f"{root}/{name}.png"
        Image.fromarray(_smooth_u8(rng, hw)).save(path)
        paths.append(path)
    return paths


def _video_pass(run, eng, frames, img2, tgt2):
    """One video path over ``frames``: composites, K1 launches, frames/s
    after the first frame, the peak memory and the host clock at the end
    of each frame (closed by its fetch)."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comps, stamps = [], []
    fr.flash_attention_relpos.launches = 0
    for comp in run(eng, frames, tgt2, VIDEO_CACHE, img2=img2,
                    res=eng.cfg.img_size[1]):
        stamps.append(time.perf_counter())
        comps.append(comp)
    launches = fr.flash_attention_relpos.launches
    fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    return (comps, launches, fps, torch.cuda.max_memory_allocated() / 1e9,
            stamps)


def _percentiles(seconds):
    """p50 and p90 in ms (nearest rank)."""
    ms = np.sort(np.asarray(seconds) * 1e3)
    return tuple(float(ms[min(len(ms) - 1, int(np.ceil(q * len(ms))) - 1)])
                 for q in (0.5, 0.9))


def phase_video(model, label):
    """SegGPT's video protocol on SegGPT ViT-L: 10 DAVIS-sized frames, a
    4-frame rolling cache, img2 given (every frame painted), through
    ``run_video_frames_device`` (the cache on the card, ``VideoEngine``)
    and ``run_video_frames`` (the cache on the host), bitwise equal on
    every frame, before the circular insert first reorders the rows and
    after; then the steady rate of each path over RATE_FRAMES more
    frames. Returns K1's launches on both paths and both drives."""
    from PIL import Image
    from painter_tpu_torch.infer import engine
    cfg = model.cfg
    res = cfg.img_size[1]
    eng = engine.InContextModel(cfg, model, device="cuda")
    rng = np.random.RandomState(7)
    frames = [_smooth_u8(rng, VIDEO_HW) for _ in range(VIDEO_FRAMES)]
    img2 = _smooth_u8(rng, (res, res)) / 255.0
    tgt2 = np.repeat((_smooth_u8(rng, (res, res))[..., :1] > 127)
                     .astype(np.float32), 3, axis=-1)

    painted = {"device": [], "host": []}
    model_s = {"device": [], "host": []}  # host clock of each model call
    states = []

    class RecordingEngine(engine.VideoEngine):
        def paint_frame(self, query, out_dtype=np.float32):
            used = (self.bucket, self._n_real)
            t0 = time.perf_counter()
            out = super().paint_frame(query, out_dtype)
            model_s["device"].append(time.perf_counter() - t0)
            states.append(used + (self._wrap,))
            painted["device"].append(out)
            return out

    def host_run_one_image(img, tgt):
        t0 = time.perf_counter()
        out = engine.InContextModel.run_one_image(eng, img, tgt)
        model_s["host"].append(time.perf_counter() - t0)
        painted["host"].append(out)
        return out

    # run_video_frames_device makes its VideoEngine by the module's name
    original = engine.VideoEngine
    engine.VideoEngine = RecordingEngine
    try:
        dev, dev_k1, dev_fps, dev_gb, _ = _video_pass(
            engine.run_video_frames_device, eng, frames, img2, tgt2)
    finally:
        engine.VideoEngine = original
    eng.run_one_image = host_run_one_image
    host, host_k1, host_fps, host_gb, _ = _video_pass(
        engine.run_video_frames, eng, frames, img2, tgt2)

    buckets = [st[0] for st in states]
    rows = [st[1] for st in states]
    wraps = [st[2] for st in states]
    print(f"# video: device cache (bucket, real rows, insert pointer after "
          f"the frame) per frame {states}")
    check(buckets == [1, 2, 4, 4, 8, 8, 8, 8, 8, 8],
          f"device cache buckets {buckets}, expected 1->2->4->8")
    check(rows == [1, 2, 3, 4, 5, 5, 5, 5, 5, 5], f"real rows {rows}")
    # the fifth frame's insert is the first circular one (row 1), so the
    # sixth frame is the first to see the rows out of the host's order
    check(wraps == [0, 0, 0, 0, 1, 2, 3, 0, 1, 2], f"insert pointer {wraps}")
    wrap_at = 5
    for name, comps, k1 in (("device", dev, dev_k1), ("host", host, host_k1)):
        check(len(comps) == VIDEO_FRAMES,
              f"{name} path painted {len(comps)} frames")
        check(k1 == cfg.depth * VIDEO_FRAMES,
              f"{name} path launched K1 {k1} times, expected "
              f"{cfg.depth * VIDEO_FRAMES}")
        for c in comps:
            check(c.shape == VIDEO_HW + (3,) and c.dtype == np.uint8,
                  f"{name} composite {c.shape} {c.dtype}")
        for out in painted[name]:
            check(np.isfinite(out).all(), f"{name} painted non-finite")
    # Before the wrap both paths feed the same values in the same row
    # order at the same shapes. After it the device cache holds the rows
    # in another order than the host's FIFO. Everything but the feature
    # ensemble is per row (K1 per head, each cuBLAS output element over K
    # alone, LayerNorm per token); the ensemble rounds each feature x
    # weight product to bf16 (8 significant bits) and sums the five real
    # ones in an fp32 accumulator before one bf16 rounding, so the order
    # shows only if their exponents spread over more than ~16 bits and
    # the bf16 rounding then sits on a tie. The frames are seeded and the
    # kernels deterministic: the check is bitwise on every frame, and a
    # wrong or stale cache row fails it by any amount it moves the output.
    for i in range(VIDEO_FRAMES):
        check(np.array_equal(painted["device"][i], painted["host"][i])
              and np.array_equal(dev[i], host[i]),
              f"video frame {i + 1}: the device cache differs from the host "
              f"cache {'after' if i >= wrap_at else 'before'} the wrap")
    diffs = [np.abs(a.astype(np.int32) - b.astype(np.int32))
             for a, b in zip(dev[wrap_at:], host[wrap_at:])]

    def mask(out):
        return np.clip(out * 255.0, 0, 255).mean(-1) > 128

    mask_share = [float((mask(a) != mask(b)).mean()) for a, b in
                  zip(painted["device"][wrap_at:], painted["host"][wrap_at:])]
    worst = int(max(d.max() for d in diffs))
    painted_gap = max(float(np.abs(a - b).max()) for a, b in
                      zip(painted["device"][wrap_at:],
                          painted["host"][wrap_at:]))
    fg = float(np.mean([mask(o).mean() for o in painted["host"]]))
    print(f"# video frames 1-{VIDEO_FRAMES}: device and host caches "
          f"bitwise equal (painted halves and composites), before the wrap "
          f"(frames 1-{wrap_at}) and after it: largest composite difference "
          f"{worst} steps, share of pixels > 1 step "
          f"{[float((d > 1).mean()) for d in diffs]}, share of re-prompt "
          f"mask pixels that differ {mask_share}, largest painted [0,1] "
          f"difference {painted_gap:.3e}; re-prompt masks "
          f"{100 * fg:.1f}% foreground")
    print(f"# video 480x854, num_frames {VIDEO_CACHE}, {VIDEO_FRAMES} frames "
          f"(a smoke reading: frames/s over frames 2-{VIDEO_FRAMES}, buckets "
          f"2-8 with each bucket's first call, host clock closed by each "
          f"frame's fetch): device cache {dev_fps:.3f} frames/s, peak "
          f"memory {dev_gb:.2f} GB; host cache {host_fps:.3f} frames/s, "
          f"peak memory {host_gb:.2f} GB [{label}]")
    for name, fps in (("device", dev_fps), ("host", host_fps)):
        call_ms = 1e3 * statistics.mean(model_s[name][1:])
        print(f"# video {name} cache, frames 2-{VIDEO_FRAMES}: "
              f"{1e3 / fps:.2f} ms per frame, of which "
              f"{'paint_frame' if name == 'device' else 'run_one_image'} "
              f"(upload, forward, fetch) {call_ms:.2f} ms and the rest of "
              f"the loop (PIL resize, "
              f"{'' if name == 'device' else 'the ensemble batch build, '}"
              f"output resize, composite) {1e3 / fps - call_ms:.2f} ms "
              f"[{label}]")
    # the steady rate: RATE_FRAMES new frames through each path, read over
    # the frames after RATE_WARM (all at bucket 8)
    del eng.run_one_image
    rate_frames = [_smooth_u8(rng, VIDEO_HW) for _ in range(RATE_FRAMES)]
    rate_k1 = 0
    for name, run in (("device", engine.run_video_frames_device),
                      ("host", engine.run_video_frames)):
        comps, k1, _, gb, stamps = _video_pass(run, eng, rate_frames, img2,
                                               tgt2)
        check(len(comps) == RATE_FRAMES and k1 == cfg.depth * RATE_FRAMES,
              f"{name} rate drive: {len(comps)} frames, K1 {k1}")
        check(all(c.shape == VIDEO_HW + (3,) for c in comps),
              f"{name} rate drive composites")
        steady = np.diff(stamps[RATE_WARM - 1:])
        p50, p90 = _percentiles(steady)
        print(f"# video {name} cache, steady rate: frames "
              f"{RATE_WARM + 1}-{RATE_FRAMES} at bucket 8 "
              f"({len(steady)} frames) {len(steady) / steady.sum():.3f} "
              f"frames/s, per frame p50 {p50:.2f} ms, p90 {p90:.2f} ms, "
              f"min {steady.min() * 1e3:.2f}, max {steady.max() * 1e3:.2f}; "
              f"peak memory {gb:.2f} GB; K1 launches {k1} [{label}]")
        rate_k1 += k1
    # one bucket-8 frame of the device cache under the profiler
    ve = engine.VideoEngine(eng, VIDEO_CACHE, img2, tgt2)
    queries = [np.array(Image.fromarray(f).resize((res, res)))
               for f in frames]
    for q in queries[:4]:
        ve.paint_frame(q)
    profile_device(lambda: ve.paint_frame(queries[4]),
                   "one device-cache video frame (bucket 8)", label)
    return dev_k1 + host_k1 + rate_k1, dev_fps, host_fps


def phase_cli(label):
    """``seggpt_cli.main`` in process through ``sys.argv``, image mode
    with 2 prompts (bucket 2), ``--quant none`` then ``int8-fused``, on
    the card by default. Returns (K1, K5) launches over both runs."""
    import os
    import tempfile
    from PIL import Image
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import seggpt_cli
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.kernels import int8_mlp as k5
    model_name = seggpt_cli.get_args_parser().get_default("model")
    depth = configs.get_config(model_name).depth
    k1_total = k5_total = 0
    with tempfile.TemporaryDirectory() as root:
        query, p1, p2, t1, t2 = _write_pngs(
            root, ["query", "p1", "p2", "t1", "t2"], (480, 640), seed=11)
        for quant in ("none", "int8-fused"):
            out_dir = os.path.join(root, f"out_{quant}")
            argv = sys.argv
            sys.argv = ["seggpt_cli", "--input_image", query,
                        "--prompt_image", p1, p2, "--prompt_target", t1, t2,
                        "--output_dir", out_dir, "--quant", quant]
            fr.flash_attention_relpos.launches = 0
            k5.int8_mlp.launches = 0
            t0 = time.perf_counter()
            try:
                seggpt_cli.main()
            finally:
                sys.argv = argv
            wall = time.perf_counter() - t0
            k1, k5n = fr.flash_attention_relpos.launches, k5.int8_mlp.launches
            out = os.path.join(out_dir, "output_query.png")
            check(os.path.exists(out), f"CLI --quant {quant} wrote no {out}")
            png = Image.open(out)
            check(png.size == (640, 480) and png.mode == "RGB",
                  f"CLI output {png.size} {png.mode}")
            want5 = depth if quant == "int8-fused" else 0
            print(f"# seggpt_cli --quant {quant}: K1 launches {k1}, K5 "
                  f"launches {k5n} (expected {depth}, {want5}); "
                  f"output_query.png {png.size}; {wall:.2f} s wall with "
                  f"the model's build [{label}]")
            check(k1 == depth and k5n == want5,
                  f"CLI --quant {quant}: K1 {k1}, K5 {k5n}")
            k1_total += k1
            k5_total += k5n
    return k1_total, k5_total


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_endpoint(label):
    """``demo_app.serve`` (SegGPT ViT-L, ``--max_batch 8``, ``--device
    cuda``) in a thread: /paint requests one at a time, a wave of 8
    concurrent identical /paint requests (micro-batched), CLIENTS clients
    in a closed loop, one /paint_video of 4 frames with the first as the
    prompt. Returns K1's launches over all of them."""
    import base64
    import io
    import threading
    import types
    import urllib.request
    from PIL import Image
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import demo_app
    from painter_tpu_torch.kernels import flash_relpos as fr
    args = demo_app.get_args_parser().parse_args(
        ["serve", "--max_batch", "8", "--device", "cuda", "--port",
         str(_free_port())])
    depth = configs.get_config(args.model).depth
    ready, stop = threading.Event(), threading.Event()
    server = threading.Thread(target=demo_app.serve,
                              args=(args, ready, stop), daemon=True)
    server.start()
    check(ready.wait(600), "the endpoint did not come up")

    def b64(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def png(data):
        return np.asarray(Image.open(io.BytesIO(base64.b64decode(data))))

    def post(route, req):
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{args.port}{route}", json.dumps(req).encode(),
            {"Content-Type": "application/json"}), timeout=600)
        return json.loads(r.read())

    rng = np.random.RandomState(13)
    req = {"image": b64(_smooth_u8(rng, (480, 640))),
           "prompt_image": b64(_smooth_u8(rng, (480, 640))),
           "prompt_target": b64(np.repeat(
               (_smooth_u8(rng, (480, 640))[..., :1] > 127).astype(np.uint8)
               * 255, 3, axis=-1))}

    # the server's first request, then the same request again, one at a
    # time
    fr.flash_attention_relpos.launches = 0
    latency = []
    for _ in range(2 + SINGLE_REQUESTS):
        t0 = time.perf_counter()
        answer = png(post("/paint", req)["output"])
        latency.append(time.perf_counter() - t0)
        if len(latency) == 1:
            single = answer
        check(np.array_equal(answer, single),
              "a repeated single /paint gave another answer")
    k1_single = fr.flash_attention_relpos.launches
    check(single.shape == (480, 640, 3), f"/paint gave {single.shape}")
    check(k1_single == (2 + SINGLE_REQUESTS) * depth,
          f"{2 + SINGLE_REQUESTS} /paint launched K1 {k1_single} times")
    p50, p90 = _percentiles(latency[2:])
    # the host pieces of one request, timed alone on the same images
    t0 = time.perf_counter()
    decoded = [demo_app._decode_b64_image(req[k]) for k in
               ("image", "prompt_image", "prompt_target")]
    t1 = time.perf_counter()
    demo_app._prep_query(types.SimpleNamespace(cfg=configs.get_config(
        args.model)), *decoded)
    t2 = time.perf_counter()
    demo_app._encode_b64_image(single)
    t3 = time.perf_counter()
    print(f"# /paint single request: first {latency[0] * 1e3:.2f} ms, "
          f"second {latency[1] * 1e3:.2f} ms; the {SINGLE_REQUESTS} after "
          f"them p50 {p50:.2f} ms, p90 {p90:.2f} ms, min "
          f"{min(latency[2:]) * 1e3:.2f}, max {max(latency[2:]) * 1e3:.2f}; "
          f"host pieces alone: decode "
          f"3 PNGs {(t1 - t0) * 1e3:.2f} ms, resize + normalize "
          f"{(t2 - t1) * 1e3:.2f} ms, encode the answer "
          f"{(t3 - t2) * 1e3:.2f} ms [{label}]")

    n = 8
    results = [None] * n

    def one(i):
        try:
            results[i] = post("/paint", req)["output"]
        except Exception as e:  # noqa: BLE001 — reported by the check
            results[i] = e

    fr.flash_attention_relpos.launches = 0
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wave = time.perf_counter() - t0
    k1_wave = fr.flash_attention_relpos.launches
    for res in results:
        check(isinstance(res, str), f"a concurrent /paint failed: {res}")
    worst = max(int(np.abs(png(r).astype(np.int32) - single).max())
                for r in results)
    batches = k1_wave / depth
    print(f"# /paint: {n} concurrent "
          f"identical requests in {wave * 1e3:.2f} ms (a smoke reading, one "
          f"wave: {n / wave:.3f} requests/s) as {batches:g} run_queries "
          f"batches (K1 launches "
          f"{k1_wave}); largest difference from the single answer {worst} "
          f"steps (bound {COMPOSITE_STEPS}) [{label}]")
    check(k1_wave % depth == 0 and batches < n,
          f"the wave launched K1 {k1_wave} times: {batches} batches for "
          f"{n} requests")
    check(worst <= COMPOSITE_STEPS,
          f"a batched answer is {worst} steps from the single one")

    # CLIENTS clients, each sending its next request when the last is
    # answered
    answers, waits = [], []

    def client():
        for _ in range(REQUESTS_PER_CLIENT):
            t = time.perf_counter()
            try:
                out = post("/paint", req)["output"]
            except Exception as e:  # noqa: BLE001 — reported by the check
                out = e
            waits.append(time.perf_counter() - t)
            answers.append(out)

    fr.flash_attention_relpos.launches = 0
    threads = [threading.Thread(target=client) for _ in range(CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    loop_s = time.perf_counter() - t0
    k1_loop = fr.flash_attention_relpos.launches
    total = CLIENTS * REQUESTS_PER_CLIENT
    check(len(answers) == total and all(isinstance(a, str) for a in answers),
          f"closed loop: {len(answers)} answers of {total}, failures "
          f"{[a for a in answers if not isinstance(a, str)][:2]}")
    loop_worst = max(int(np.abs(png(a).astype(np.int32) - single).max())
                     for a in answers)
    loop_batches = k1_loop / depth
    p50, p90 = _percentiles(waits)
    print(f"# /paint closed loop: {CLIENTS} clients x "
          f"{REQUESTS_PER_CLIENT} requests in {loop_s * 1e3:.2f} ms, "
          f"{total / loop_s:.3f} requests/s, latency p50 {p50:.2f} ms, p90 "
          f"{p90:.2f} ms, {loop_batches:g} run_queries batches (mean "
          f"{total / loop_batches:.2f} requests each); largest difference "
          f"from the single answer {loop_worst} steps (bound "
          f"{COMPOSITE_STEPS}) [{label}]")
    check(k1_loop % depth == 0 and loop_batches < total,
          f"the closed loop launched K1 {k1_loop} times for {total} requests")
    check(loop_worst <= COMPOSITE_STEPS,
          f"a closed-loop answer is {loop_worst} steps from the single one")

    fr.flash_attention_relpos.launches = 0
    vreq = {"frames": [b64(_smooth_u8(rng, VIDEO_HW)) for _ in range(4)],
            "prompt_target": req["prompt_target"], "num_frames": 4}
    t0 = time.perf_counter()
    frames = post("/paint_video", vreq)["frames"]
    video_s = time.perf_counter() - t0
    k1_video = fr.flash_attention_relpos.launches
    print(f"# /paint_video: 4 frames, the first as the prompt: {len(frames)} "
          f"painted in {video_s * 1e3:.2f} ms, K1 launches {k1_video} "
          f"[{label}]")
    check(len(frames) == 3 and all(png(f).shape == VIDEO_HW + (3,)
                                   for f in frames),
          f"/paint_video gave {len(frames)} frames")
    check(k1_video == 3 * depth, f"/paint_video launched K1 {k1_video}")
    # the server's model must not stay resident through the later phases
    # (its request handler class holds it in a reference cycle)
    stop.set()
    server.join(120)
    check(not server.is_alive(), "the endpoint did not stop")
    gc.collect()
    return k1_single + k1_wave + k1_loop + k1_video


def phase_painter_task(label):
    """``painter_task_inference`` on Painter ViT-L (bf16, random weights),
    task depth (channel mean, x10000, bilinear), on synthetic PNGs."""
    import tempfile
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import flash_relpos as fr
    cfg = configs.get_config(PAINTER, dtype="bfloat16")
    eng = engine.InContextModel(cfg, _seeded_model(cfg, 3), device="cuda")
    with tempfile.TemporaryDirectory() as root:
        query, p_img, p_tgt = _write_pngs(root, ["query", "img2", "tgt2"],
                                          (480, 640), seed=17)
        fr.flash_attention_relpos.launches = 0
        t0 = time.perf_counter()
        depth_map = engine.painter_task_inference(
            eng, query, p_img, p_tgt, "depth", res=cfg.img_size[1])
        wall = time.perf_counter() - t0
        k1 = fr.flash_attention_relpos.launches
    print(f"# painter_task_inference depth: shape {depth_map.shape}, range "
          f"[{depth_map.min():.2f}, {depth_map.max():.2f}], K1 launches {k1}, "
          f"{wall * 1e3:.2f} ms [{label}]")
    check(depth_map.shape == (480, 640), f"depth map {depth_map.shape}")
    check(np.isfinite(depth_map).all() and depth_map.min() >= 0
          and depth_map.max() <= 10000, "depth map outside [0, 10000]")
    check(k1 == cfg.depth, f"the Painter task launched K1 {k1} times")
    return k1


PAINTER = "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1"
# the eval drive (Painter's published protocols on synthetic data made by
# the port's rehearsal generators): ADE20K images at their usual 512x683,
# COCO panoptic at 480x640 painted at 560 (1120x560), pose crops and their
# flips; every pipeline at --batch_size 8
EVAL_BATCH, ADE_IMAGES, PANO_IMAGES, POSE_CROPS = 8, 16, 8, 8
# rates come from a steady window: the checked call of each pipeline (the
# first at its shape) stays off the clock, and this many calls more over
# the same images are timed
EVAL_REPS = 3
# painted uint8 PNGs, K1 against plain attention: FWD_BF16_TOL on the
# painted [0,1] scale is this many uint8 steps
EVAL_PNG_STEPS = round(FWD_BF16_TOL * 255)
# the card-vs-CPU decode runs on this centre crop of the first painted
# panoptic PNGs: the CPU side of the 6400-color decode at 480x640 would
# take minutes
DECODE_CROP = (120, 160)
# decayed NMS scores, card against CPU: ``exp`` may round the last bit
# differently on the two devices
NMS_RTOL = 1e-6


def _pngs(paths):
    from PIL import Image
    return [np.asarray(Image.open(p), np.int32) for p in paths]


def _decoders_card_vs_cpu(ade_png, inst_png, sem_png):
    """The eval stack's device decoders on the card and on the CPU, on
    painted PNGs of this run: indices, masks and classes equal, decayed
    NMS scores to NMS_RTOL."""
    from painter_tpu_torch.evals import instseg, run_panoptic
    from painter_tpu_torch.ops import nms, palette
    h, w = DECODE_CROP
    y0, x0 = (inst_png.shape[0] - h) // 2, (inst_png.shape[1] - w) // 2
    inst = inst_png[y0:y0 + h, x0:x0 + w].astype(np.float32)
    sem = sem_png[y0:y0 + h, x0:x0 + w].astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        ade_pal = torch.from_numpy(palette.ade20k_palette()).to(dev)
        sem_pal = torch.from_numpy(
            palette.coco_semseg_palette().astype(np.float32)).to(dev)
        dec = instseg.decode_instances(inst, return_device=True, device=dev)
        masks = dec.pop("masks_dev")
        out[dev] = {
            "ade": palette.nearest_color_decode(torch.from_numpy(
                ade_png.astype(np.float32)).to(dev), ade_pal).cpu().numpy(),
            "inst": dec, "minmax": instseg.decode_instances_minmax(
                inst, device=dev),
            "vote": run_panoptic.vote_classes(
                masks, torch.from_numpy(sem).to(dev), sem_pal,
                80).cpu().numpy(),
            "nms": nms.matrix_nms_scores(
                masks, torch.ones(len(masks), device=dev),
                torch.from_numpy(dec["scores"]).to(dev)).cpu().numpy()}
    card, cpu = out["cuda"], out["cpu"]
    check(np.array_equal(card["ade"], cpu["ade"]),
          "nearest_color_decode differs between the card and the CPU")
    check(np.array_equal(card["inst"]["masks"], cpu["inst"]["masks"]),
          "decode_instances masks differ between the card and the CPU")
    for name, a, b in (("decode_instances", card["inst"]["scores"],
                        cpu["inst"]["scores"]),
                       ("matrix_nms_scores", card["nms"], cpu["nms"])):
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
        check(rel <= NMS_RTOL, f"{name} scores differ by {rel} relative")
    for key in ("masks", "scores", "classes"):
        check(np.array_equal(card["minmax"][key], cpu["minmax"][key]),
              f"decode_instances_minmax {key} differ")
    check(np.array_equal(card["vote"], cpu["vote"]),
          "the panoptic vote differs between the card and the CPU")
    return (len(card["inst"]["masks"]), len(card["minmax"]["masks"]),
            float(np.max(np.abs(card["nms"] - cpu["nms"]))))


def phase_eval(label):
    """Painter ViT-L (bf16) through the eval drivers, as
    ``painter_tpu_torch.evals.rehearsal`` runs them: ADE20K (paint at
    896x448, palette decode, mIoU), COCO panoptic (instance and semantic
    paints at 1120x560, the 6400-color instance decode, the class vote,
    the fusion, PQ), pose (crops and flips, flip test, AP), and ADE20K again
    with ``--quant int8-fused``. Checks K1's (and K5's) launches per
    forward, K1's paints against plain attention, and the decoders on the
    card against the CPU. Returns (K1, K5) launches."""
    import os
    import tempfile
    from painter_tpu_torch.evals import (rehearsal, run_eval, run_panoptic,
                                         run_pose)
    from painter_tpu_torch.infer.engine import InContextModel
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.kernels import int8_mlp as k5

    def engine(args):
        eng = run_eval.build_model(args)
        _noisy_rel_pos(eng.model,
                       torch.Generator(device="cuda").manual_seed(11))
        return eng

    def paint(args, eng, n_images, what):
        """Paints (the checked call), checks K1 ran once per block per
        forward; returns the outputs and K1's launches."""
        fr.flash_attention_relpos.launches = 0
        outputs = run_eval.paint_predictions(args, eng)
        k1 = fr.flash_attention_relpos.launches
        forwards = -(-n_images // EVAL_BATCH)
        check(len(outputs) == n_images, f"{what}: painted {len(outputs)}")
        check(k1 == eng.cfg.depth * forwards,
              f"{what}: K1 launched {k1} times for {forwards} forwards")
        return outputs, k1

    def steady(fn, n_items, eng=None):
        """EVAL_REPS more calls of ``fn`` after its checked one: items/s
        over the window, the slowest and the fastest call's, and, with
        ``eng``, the share of the window spent inside its batched call
        (upload, forward, fetch of the painted halves)."""
        inside = [0.0]
        if eng is not None:
            call = eng.run_queries_shared

            def clocked(*a, **k):
                t = time.perf_counter()
                try:
                    return call(*a, **k)
                finally:
                    inside[0] += time.perf_counter() - t
            eng.run_queries_shared = clocked
        rates, total = [], 0.0
        try:
            for _ in range(EVAL_REPS):
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                total += dt
                rates.append(n_items / dt)
        finally:
            if eng is not None:
                del eng.run_queries_shared
        return {"rate": EVAL_REPS * n_items / total, "lo": min(rates),
                "hi": max(rates), "engine": inside[0] / total}

    def fmt(r, unit="images/s"):
        text = (f"{r['rate']:.3f} {unit} (calls {r['lo']:.3f}-"
                f"{r['hi']:.3f}")
        if "engine" in r and r["engine"]:
            text += f"; {100 * r['engine']:.1f}% inside the engine call"
        return text + ")"

    def paint_steady(args, eng, n_images):
        return steady(lambda: run_eval.paint_predictions(args, eng),
                      n_images, eng)

    def against_plain(args, eng, outputs, what):
        """The first batch painted again with plain attention."""
        plain = InContextModel(eng.cfg, eng.model, attn_impl="plain",
                               device="cuda")
        sub = rehearsal.eval_args(**{**vars(args), "max_images": EVAL_BATCH,
                                     "output_dir": args.output_dir + "_plain"})
        fr.flash_attention_relpos.launches = 0
        ref = run_eval.paint_predictions(sub, plain)
        check(fr.flash_attention_relpos.launches == 0,
              f"{what}: plain attention launched K1")
        worst = max(int(np.abs(a - b).max()) for a, b in zip(
            _pngs(p for _, p in outputs[:EVAL_BATCH]),
            _pngs(p for _, p in ref)))
        check(worst <= EVAL_PNG_STEPS,
              f"{what}: K1 paints {worst} uint8 steps from plain attention")
        return worst

    lines = []
    with tempfile.TemporaryDirectory() as root:
        # ADE20K at 896x448
        img_dir, ann_dir, p_img, p_tgt = rehearsal.make_ade20k(
            os.path.join(root, "ade"), ADE_IMAGES)
        args = rehearsal.eval_args(
            task="ade20k_semseg", image_dir=img_dir, gt_dir=ann_dir,
            prompt_image=p_img, prompt_target=p_tgt, model=PAINTER,
            batch_size=EVAL_BATCH, output_dir=os.path.join(root, "ade_out"))
        eng = engine(args)
        ade_out, k1_ade = paint(args, eng, ADE_IMAGES, "ADE20K")
        metrics = run_eval.compute_metrics(args, ade_out)
        check(all(np.isfinite(v) for v in metrics.values()),
              f"ADE20K metrics {metrics}")
        ade_steps = against_plain(args, eng, ade_out, "ADE20K")
        ade_paint = paint_steady(args, eng, ADE_IMAGES)
        ade_decode = steady(lambda: run_eval.compute_metrics(args, ade_out),
                            ADE_IMAGES)
        # where one paint call's time goes: one b8 forward under the profiler
        one = rehearsal.eval_args(**{**vars(args), "max_images": EVAL_BATCH})
        ade_busy = profile_device(
            lambda: run_eval.paint_predictions(one, eng),
            f"one ADE20K paint call ({EVAL_BATCH} images, 896x448)", label)
        lines.append(f"ADE20K 896x448: {ADE_IMAGES} images x {EVAL_REPS} "
                     f"calls, paint {fmt(ade_paint)}, decode + mIoU "
                     f"{fmt(ade_decode)}, mIoU {metrics['mIoU']:.4f},"
                     f" K1 {k1_ade}, K1 vs plain {ade_steps} uint8 steps,"
                     f" device busy share of one paint call {ade_busy}")

        # pose on the same 896x448 model: crops and their flips
        crops, meta, gt, p_img, p_tgt = rehearsal.make_pose(
            os.path.join(root, "pose"), POSE_CROPS)
        pargs = rehearsal.eval_args(
            task="pose", image_dir=crops, prompt_image=p_img,
            prompt_target=p_tgt, model=PAINTER, batch_size=EVAL_BATCH,
            skip_metrics=True, output_dir=os.path.join(root, "pose_out"))
        _, k1_pose = paint(pargs, eng, 2 * POSE_CROPS, "pose")
        pose_args = run_pose.get_args_parser().parse_args([
            "--pred_dir", pargs.output_dir, "--meta_json", meta,
            "--gt_json", gt, "--flip_test"])
        res = run_pose.evaluate(pose_args)
        check(np.isfinite(res["AP"]), f"pose metrics {res}")
        pose_paint = paint_steady(pargs, eng, 2 * POSE_CROPS)
        pose_decode = steady(lambda: run_pose.evaluate(pose_args),
                             2 * POSE_CROPS)
        lines.append(f"pose 256x192 crops at 896x448: {2 * POSE_CROPS} "
                     f"crops x {EVAL_REPS} calls, paint "
                     f"{fmt(pose_paint, 'crops/s')}, "
                     f"decode + AP (flip test) {fmt(pose_decode, 'crops/s')}"
                     f", AP {res['AP']:.4f}, K1 {k1_pose}")

        # ADE20K with the fused int8 MLP: the same weights, quantized
        qargs = rehearsal.eval_args(**{**vars(args), "quant": "int8-fused",
                                       "output_dir": args.output_dir + "8"})
        qeng = engine(qargs)
        k5.int8_mlp.launches = 0
        q_out, k1_q = paint(qargs, qeng, ADE_IMAGES, "int8-fused")
        k5_q = k5.int8_mlp.launches
        check(k5_q == k1_q, f"int8-fused: K5 launched {k5_q} times, K1 "
              f"{k1_q}")
        a = np.stack(_pngs(p for _, p in q_out)).astype(np.float64)
        b = np.stack(_pngs(p for _, p in ade_out)).astype(np.float64)
        dev8 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        check(dev8 <= INT8_REL_FRO, f"int8-fused ADE20K paints deviate "
              f"{dev8} from bf16")
        q_paint = paint_steady(qargs, qeng, ADE_IMAGES)
        lines.append(f"ADE20K int8-fused: paint {fmt(q_paint)}, K5 "
                     f"{k5_q}, K1 {k1_q}, relative Frobenius vs bf16 "
                     f"{dev8:.4e} (bound {INT8_REL_FRO})")
        del eng, qeng

        # COCO panoptic at 1120x560
        (img_dir, gt_dir, gt_json, p_img, p_inst,
         p_sem) = rehearsal.make_panoptic(os.path.join(root, "pano"),
                                          PANO_IMAGES)
        iargs = rehearsal.eval_args(
            task="coco_inst", image_dir=img_dir, prompt_image=p_img,
            prompt_target=p_inst, model=PAINTER, input_size=560,
            batch_size=EVAL_BATCH, skip_metrics=True,
            output_dir=os.path.join(root, "inst_out"))
        sargs = rehearsal.eval_args(**{**vars(iargs), "task": "coco_semseg",
                                       "prompt_target": p_sem,
                                       "output_dir": os.path.join(
                                           root, "sem_out")})
        peng = engine(iargs)
        check(peng.cfg.img_size == (1120, 560) and peng.cfg.num_patches ==
              2450, f"panoptic model at {peng.cfg.img_size}")
        inst_out, k1_inst = paint(iargs, peng, PANO_IMAGES,
                                  "panoptic instances")
        sem_out, k1_sem = paint(sargs, peng, PANO_IMAGES,
                                "panoptic semantics")
        inst_steps = against_plain(iargs, peng, inst_out, "panoptic")
        inst_paint = paint_steady(iargs, peng, PANO_IMAGES)
        sem_paint = paint_steady(sargs, peng, PANO_IMAGES)
        pano_args = run_panoptic.get_args_parser().parse_args([
            "--inst_dir", iargs.output_dir, "--semseg_dir",
            sargs.output_dir, "--gt_json", gt_json, "--gt_dir", gt_dir])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run_panoptic.evaluate(pano_args)
        peak = torch.cuda.max_memory_allocated() / 1e9
        pano_decode = steady(lambda: run_panoptic.evaluate(pano_args),
                             PANO_IMAGES)
        check(res["n_images"] == PANO_IMAGES and np.isfinite(res["PQ"]),
              f"panoptic {res}")
        n_inst, n_minmax, nms_diff = _decoders_card_vs_cpu(
            _pngs([ade_out[0][1]])[0], *_pngs([inst_out[0][1],
                                               sem_out[0][1]]))
        lines.append(f"COCO panoptic 480x640 at 1120x560: {PANO_IMAGES} "
                     f"images x {EVAL_REPS} calls, paint instances "
                     f"{fmt(inst_paint)}, semantics {fmt(sem_paint)}, "
                     f"decode + vote + fusion + PQ {fmt(pano_decode)} (peak "
                     f"device memory {peak:.2f} GB), PQ {res['PQ']:.4f}, "
                     f"K1 {k1_inst + k1_sem}, K1 vs plain {inst_steps} "
                     f"uint8 steps")
        lines.append(f"decoders card vs CPU on a {DECODE_CROP} crop: equal "
                     f"({n_inst} instance masks, {n_minmax} min-max masks; "
                     f"NMS scores max abs diff {nms_diff:.3e})")
    for line in lines:
        print(f"# eval {line} [{label}]")
    gc.collect()
    torch.cuda.empty_cache()
    return k1_ade + k1_pose + k1_q + k1_inst + k1_sem, k5_q


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


# data-parallel serving against the single-device model: the painted
# [0,1] outputs within FWD_BF16_TOL, the uint8 ones within as many steps
# (the replicas run their gemms at half the batch rows, which may pick
# other cuBLAS kernels and round elsewhere)
DP_U8_STEPS = round(FWD_BF16_TOL * 255)


def phase_dp_serving(model, label):
    """Data-parallel serving: ``InContextModel(mesh=["cuda:0", "cuda:0"])``
    (two replicas on the one card, each painting half of every batch, the
    ragged b7 padded to 8 by repeating row 0) on SegGPT ViT-L 896x448 in
    bf16, through ``run_queries`` and ``run_queries_shared`` (float and
    uint8 out), held to the single-device model on the same inputs; K1
    counted around the dp calls: one forward per replica."""
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import flash_relpos as fr
    cfg = model.cfg
    one = engine.InContextModel(cfg, model, device="cuda")
    dp = engine.InContextModel(cfg, model, mesh=["cuda:0", "cuda:0"])
    check(dp.n_dp == 2 and [m is model for _, m in dp._replicas] ==
          [True, True], "dp replicas on one card share one model")
    res = cfg.img_size[1]
    rng = np.random.RandomState(5)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    launches = 0
    for n in (8, 7):
        q_u8 = (rng.rand(n, res, res, 3) * 255).astype(np.uint8)
        imgs, tgts = engine.build_query_batch(list(q_u8 / 255.0), img2,
                                              tgt2)
        calls = {
            "run_queries": lambda e: e.run_queries(imgs, tgts),
            "run_queries_shared": lambda e: e.run_queries_shared(
                q_u8, img2, tgt2),
            "run_queries_shared uint8": lambda e: e.run_queries_shared(
                q_u8, img2, tgt2, out_dtype=np.uint8)}
        for name, call in calls.items():
            ref = call(one)
            fr.flash_attention_relpos.launches = 0
            got = call(dp)
            k1 = fr.flash_attention_relpos.launches
            launches += k1
            err = float(np.abs(got.astype(np.float64)
                               - ref.astype(np.float64)).max())
            tol = DP_U8_STEPS if got.dtype == np.uint8 else FWD_BF16_TOL
            print(f"# dp serving b{n} {name}: 2 replicas vs one device, max "
                  f"abs {err:.4g} (tol {tol}), K1 launches {k1} [{label}]")
            check(k1 == 2 * cfg.depth,
                  f"dp {name}: K1 launched {k1}, expected {2 * cfg.depth}")
            check(got.shape == ref.shape == (n, res, res, 3)
                  and got.dtype == ref.dtype,
                  f"dp {name}: {got.shape} {got.dtype} vs {ref.shape}")
            check(np.isfinite(got).all() and err <= tol,
                  f"dp {name} differs from one device by {err}")
    return launches


def _params_and_grads(model):
    return ([p.detach().clone() for p in model.parameters()],
            [p.grad.detach().clone() for p in model.parameters()])


def _rel_l2(a, b):
    num = sum(((x - y).double() ** 2).sum() for x, y in zip(a, b))
    den = sum((y.double() ** 2).sum() for y in b)
    return (num / den).sqrt().item()


def phase_remat_policies(result, label):
    """The seven remat policies at full width (Painter ViT-L 896x448,
    bf16, the fused tail), in turns: one b2 micro-step's gradients under
    each (same weights, batch and drop-path draws), K1 launches per
    policy (one per block under the save_kernel policies, two under the
    rest) and the gradients against save_kernel's within the bf16 limit;
    then ms per update (b2, accum 1) and peak memory of each: every
    policy's step runs once, then each peak window starts from the same
    state (no gradients, garbage collected, the cache emptied), its base
    taken there."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.models import incontext_vit as tm
    from painter_tpu_torch.train import step as step_lib
    model, opt = result["model"], result["optimizer"]
    depth = model.cfg.depth
    batch = _train_batch(model.cfg, 2, seed=9)
    ref, k1, k2, rel = None, {}, {}, {}
    for pol in ("save_kernel",) + tuple(
            p for p in tm.REMAT_POLICIES if p != "save_kernel"):
        model.zero_grad(set_to_none=True)
        fr.flash_attention_relpos.launches = 0
        fr.flash_attention_relpos_bwd.launches = 0
        loss, _, _ = tm.forward(
            model, batch["imgs"], batch["tgts"], batch["mask"],
            batch["valid"], train=True, remat=True, remat_policy=pol,
            generator=torch.Generator(device="cuda").manual_seed(7),
            decoder_impl="fused")
        loss.backward()
        k1[pol] = fr.flash_attention_relpos.launches
        k2[pol] = fr.flash_attention_relpos_bwd.launches
        grads = [p.grad.detach().clone() for p in model.parameters()]
        if ref is None:
            ref = grads
        rel[pol] = (_rel_l2(grads, ref),
                    all(torch.equal(g, r) for g, r in zip(grads, ref)))
        del grads
        want = depth if pol.startswith("save_kernel") else 2 * depth
        check(k1[pol] == want and k2[pol] == depth,
              f"remat {pol}: K1 {k1[pol]} (expected {want}), K2 {k2[pol]}")
        check(rel[pol][0] <= GRAD_BF16_REL_L2,
              f"remat {pol}: gradients differ from save_kernel's by "
              f"{rel[pol][0]}")
    model.zero_grad(set_to_none=True)
    del ref
    gen = torch.Generator(device="cuda").manual_seed(8)
    steps = {pol: step_lib.make_train_step(
        model.cfg, opt, accum_iter=1, remat_policy=pol, decoder_impl="fused")
        for pol in k1}
    held = {}  # allocated after each warm-up step, before any clean-up
    for pol, st in steps.items():  # warm-up; the optimizer state exists
        st(model, batch, gen)
        torch.cuda.synchronize()
        held[pol] = torch.cuda.memory_allocated() / 1e9
    peaks = {}
    for pol, st in steps.items():
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st(model, batch, gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks[pol] = (peak / 1e9, (peak - base) / 1e9, base / 1e9)
    times = {pol: [] for pol in steps}
    for _ in range(2):
        for pol, st in steps.items():
            times[pol] += _timed_updates(st, model, batch, gen, 2)
    print("# remat policies, b2 micro-step: policy K1 launches, gradient "
          "relative L2 vs save_kernel (bitwise?), ms per update (mean of "
          "4, in turns), peak GB (above the step's start; the start; "
          "allocated after the warm-up step): " + "; ".join(
              f"{pol} K1 {k1[pol]}, {rel[pol][0]:.2e} "
              f"({'bitwise' if rel[pol][1] else 'not bitwise'}), "
              f"{statistics.mean(times[pol]) * 1e3:.2f} ms, "
              f"{peaks[pol][0]:.3f} ({peaks[pol][1]:.3f}; "
              f"{peaks[pol][2]:.3f}; {held[pol]:.3f}) GB"
              for pol in steps) + f" [{label}]")
    return sum(k1.values()), sum(k2.values())


def phase_nccl_world1(label):
    """``torch.distributed`` over NCCL at world size 1 on Painter ViT-L
    896x448, bf16, b2 x accum 2, save_kernel_attn remat, the fused tail.
    First the data-parallel step (``make_train_step(mesh=...)``) against
    the non-distributed step from the same weights, batch and drop-path
    seed: the parameters, reduced gradients and moments after one update
    (lr 1e-3 from the first update: no warmup), bitwise expected; then
    both updates timed in turns. Then ``train.main --distributed`` (2
    updates, 2 validation batches) on a synthetic dataset, K1-K4 counted
    around it, and its rank-0 artifacts."""
    import copy
    import os
    import tempfile
    import torch.distributed as dist
    from painter_tpu_torch import configs
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.parallel.mesh import make_mesh
    from painter_tpu_torch.train import optim, step as step_lib, train
    cfg = configs.get_config(PAINTER, dtype="bfloat16")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1)
        oc = optim.OptimConfig(warmup_epochs=0.0, steps_per_epoch=10)
        models = {"dist": _seeded_model(cfg, 11).train()}
        models["plain"] = copy.deepcopy(models["dist"])
        start = [p.detach().clone() for p in models["plain"].parameters()]
        opts = {"dist": optim.LayerDecayAdamW(models["dist"], cfg, oc,
                                              mesh=mesh),
                "plain": optim.LayerDecayAdamW(models["plain"], cfg, oc)}
        kw = dict(accum_iter=2, remat_policy="save_kernel_attn",
                  decoder_impl="fused")
        steps = {"dist": step_lib.make_train_step(cfg, opts["dist"],
                                                  mesh=mesh, **kw),
                 "plain": step_lib.make_train_step(cfg, opts["plain"], **kw)}
        batch = _train_batch(cfg, 2, seed=12, accum=2)
        out, metrics = {}, {}
        for name in ("dist", "plain"):
            metrics[name] = steps[name](
                models[name], batch,
                torch.Generator(device="cuda").manual_seed(13))
            out[name] = _params_and_grads(models[name])
        moments = {name: [s["exp_avg"] for s in
                          opts[name].adamw.state_dict()["state"].values()]
                   for name in opts}
        same = {what: all(torch.equal(a, b) for a, b in zip(
            out["dist"][i], out["plain"][i]))
            for i, what in enumerate(("parameters", "gradients"))}
        same["moments"] = all(torch.equal(a, b) for a, b in zip(
            moments["dist"], moments["plain"]))
        same["loss"] = torch.equal(metrics["dist"]["loss"],
                                   metrics["plain"]["loss"])
        grad_rel = _rel_l2(out["dist"][1], out["plain"][1])
        param_err = max((a - b).abs().max().item() for a, b in zip(
            out["dist"][0], out["plain"][0]))
        largest_update = max((a - b).abs().max().item() for a, b in zip(
            out["plain"][0], start))
        print(f"# NCCL world 1, first update vs the non-distributed step: "
              f"bitwise {same}; gradients relative L2 {grad_rel:.3e}, "
              f"parameters max abs {param_err:.3e} (largest update "
              f"{largest_update:.3e}); loss "
              f"{metrics['dist']['loss'].item():.6f} vs "
              f"{metrics['plain']['loss'].item():.6f}, grad norm "
              f"{metrics['dist']['grad_norm'].item():.5f} vs "
              f"{metrics['plain']['grad_norm'].item():.5f} [{label}]")
        # a sum over one rank and a copy through the flat bucket change
        # no bit; if bits differ, a nondeterministic op of the backward
        # did (none is known on this path): then the gradients are held to
        # the bf16 limit, the parameters to twice the largest update (the
        # first Adam step is sign-like)
        check(largest_update > 0, "the first update moved nothing")
        if not all(same.values()):
            check(grad_rel <= GRAD_BF16_REL_L2,
                  f"NCCL world-1 gradients differ by {grad_rel}")
            check(param_err <= 2 * largest_update,
                  f"NCCL world-1 parameters differ by {param_err}")
        gen = torch.Generator(device="cuda").manual_seed(14)
        times = {name: [] for name in steps}
        for _ in range(3):
            for name in ("dist", "plain"):
                times[name] += _timed_updates(steps[name], models[name],
                                              batch, gen, 1)
        print(f"# NCCL world 1 vs non-distributed, b2 x accum 2 update "
              f"(in turns, mean of 3): "
              f"{statistics.mean(times['dist']) * 1e3:.2f} ms vs "
              f"{statistics.mean(times['plain']) * 1e3:.2f} ms (updates "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times['dist'])} / "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times['plain'])}) "
              f"[{label}]")
        del models, opts, steps, out, moments, start
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
    os.makedirs(data)
    pairs = _write_dataset(data)
    run = os.path.join(tmp.name, "run")
    updates, accum, val_batches = 2, 2, 2
    args = train.get_args_parser().parse_args([
        "--distributed", "--coordinator", f"localhost:{_free_port()}",
        "--num_processes", "1", "--process_id", "0",
        "--data_path", data, "--json_path", pairs, "--val_json_path", pairs,
        "--output_dir", run, "--model", PAINTER, "--dtype", "bfloat16",
        "--input_size", *map(str, cfg.img_size),
        "--num_mask_patches", str(cfg.num_patches // 2),
        "--max_mask_patches_per_block", str(cfg.num_patches // 4),
        "--batch_size", "2", "--accum_iter", str(accum), "--epochs", "1",
        "--max_steps_per_epoch", str(updates), "--remat_policy",
        "save_kernel_attn", "--decoder_impl", "fused", "--print_freq", "1",
        "--watchdog_freq", "1"])
    counters = (fr.flash_attention_relpos, fr.flash_attention_relpos_bwd,
                dh.fused_decoder_tail, dh.fused_decoder_tail_bwd)
    for c in counters:
        c.launches = 0
    result = train.main(args)
    k1, k2, k3, k4 = (c.launches for c in counters)
    micro = updates * accum
    depth = cfg.depth
    print(f"# train.main --distributed (NCCL, world 1, save_kernel_attn): "
          f"K1 {k1} ({micro} micro-batches + {val_batches} validation "
          f"batches), K2 {k2}, K3 {k3}, K4 {k4}")
    check(not dist.is_initialized(), "train.main left its group")
    check(result["step"] == updates, f"trained {result['step']} updates")
    check((k1, k2, k3, k4) == (depth * (micro + val_batches), depth * micro,
                               micro, micro),
          f"NCCL training launched K1-K4 {(k1, k2, k3, k4)}")
    with open(os.path.join(run, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    with open(os.path.join(run, "log.txt")) as f:
        stats = json.loads(f.readline())
    ckpts = os.listdir(os.path.join(run, "checkpoints"))
    check([s["step"] for s in scalars] == list(range(updates))
          and all(np.isfinite(s["loss"]) for s in scalars),
          f"scalars.jsonl {scalars}")
    check(np.isfinite(stats["train_loss"]) and np.isfinite(stats["val_loss"]),
          f"log.txt {stats}")
    check(ckpts == [f"checkpoint-{updates}.pth"], f"checkpoints {ckpts}")
    print(f"# train.main --distributed: losses "
          f"{[round(s['loss'], 5) for s in scalars]}, val loss "
          f"{stats['val_loss']:.5f}, wrote log.txt, scalars.jsonl, "
          f"{ckpts[0]} [{label}]")
    del result
    tmp.cleanup()
    torch.cuda.empty_cache()
    return k1, k2, k3, k4


# the two gloo ranks on the one card: Painter ViT-L at full width, cut to
# 6 blocks (the stream merge after block 2, taps at 2-5), bf16, b1 per
# rank x accum 2, drop-path 0.1, save_kernel remat, the fused tail
GLOO_CFG = dict(depth=6, merge_idx=2, out_indices=(2, 3, 4, 5),
                dtype="bfloat16")
GLOO_MODES = {"fsdp": (1, 2), "dp": (2, 1)}
GLOO_RES = 448  # the painted half of 896x448


def _gloo_rank(rank, store, out_path):
    """One of the two gloo ranks on cuda:0 (run as ``chip_smoke.py
    --gloo-rank R --store FILE --out FILE``): one data-parallel update
    under each mesh of ``GLOO_MODES``; rank 0 also holds it to the
    one-process update at the global batch (loss, grad norm, the reduced
    gradients) and to the one-process AdamW applied to the reduced
    gradients (the sharded optimizer's update), and checks that both ranks
    hold the same parameters. Writes a JSON summary."""
    import copy
    import torch.distributed as dist
    from painter_tpu_torch import configs
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.parallel.mesh import make_mesh
    from painter_tpu_torch.train import optim, step as step_lib
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    cfg = configs.get_config(PAINTER, **GLOO_CFG)
    oc = optim.OptimConfig(warmup_epochs=0.0, steps_per_epoch=10)
    kw = dict(accum_iter=2, remat_policy="save_kernel", decoder_impl="fused")
    batch = _train_batch(cfg, 2, seed=21, accum=2)
    local = {k: v[:, rank:rank + 1] for k, v in batch.items()}
    summary = {}
    try:
        for mode, (n_dp, n_fsdp) in GLOO_MODES.items():
            mesh = make_mesh(n_dp, n_fsdp, device_type="cuda")
            model = _seeded_model(cfg, 22).train()
            start = copy.deepcopy(model)
            opt = optim.LayerDecayAdamW(model, cfg, oc, mesh=mesh)
            step = step_lib.make_train_step(cfg, opt, mesh=mesh, **kw)
            for c in (fr.flash_attention_relpos,
                      fr.flash_attention_relpos_bwd, dh.fused_decoder_tail,
                      dh.fused_decoder_tail_bwd):
                c.launches = 0
            m = step(model, local, torch.Generator(device="cuda")
                     .manual_seed(23))
            torch.cuda.synchronize()
            got = {"launches": [fr.flash_attention_relpos.launches,
                                fr.flash_attention_relpos_bwd.launches,
                                dh.fused_decoder_tail.launches,
                                dh.fused_decoder_tail_bwd.launches],
                   "loss": m["loss"].item(),
                   "grad_norm": m["grad_norm"].item(),
                   "sharded": sum(s is not None for s in opt.shards)}
            # both ranks' parameters, one fingerprint each
            fp = torch.stack([torch.stack([p.detach().double().sum(),
                                           (p.detach().double() ** 2).sum()])
                              for p in model.parameters()]).cpu()
            fps = [torch.empty_like(fp) for _ in range(2)]
            dist.all_gather(fps, fp)
            got["ranks_equal"] = torch.equal(fps[0], fps[1])
            if rank == 0:
                params, grads = _params_and_grads(model)
                ref = copy.deepcopy(start)
                ref_opt = optim.LayerDecayAdamW(ref, cfg, oc)
                ref_m = step_lib.make_train_step(cfg, ref_opt, **kw)(
                    ref, batch, torch.Generator(device="cuda")
                    .manual_seed(23))
                got["ref_loss"] = ref_m["loss"].item()
                got["ref_grad_norm"] = ref_m["grad_norm"].item()
                got["grad_rel_l2"] = _rel_l2(
                    grads, [p.grad for p in ref.parameters()])
                # the one-process AdamW on the two ranks' reduced,
                # clipped gradients
                replay_opt = optim.LayerDecayAdamW(
                    start, cfg, optim.OptimConfig(
                        warmup_epochs=0.0, steps_per_epoch=10,
                        clip_grad=None))
                for p, g in zip(start.parameters(), grads):
                    p.grad = g
                replay_opt.step()
                got["update_max_abs"] = max(
                    (a - b.detach()).abs().max().item()
                    for a, b in zip(params, start.parameters()))
                got["param_max"] = max(p.abs().max().item() for p in params)
                del ref, ref_opt, params, grads
            summary[mode] = got
            del model, start, opt, step
            torch.cuda.empty_cache()
        summary["serve"] = _gloo_serve(cfg, rank)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(summary, f)


def _gloo_serve(cfg, rank):
    """dp serving over the gloo group: ``InContextModel(mesh=<a cuda
    DeviceMesh>)`` with no ``device`` serves on the card; a ragged batch
    of 3 (padded to 4, two rows per rank) through ``run_queries``; rank 0
    holds it to one device."""
    import hashlib
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.parallel.mesh import make_mesh
    model = _seeded_model(cfg, 24)
    eng = engine.InContextModel(cfg, model,
                                mesh=make_mesh(2, 1, device_type="cuda"))
    res = cfg.img_size[1]
    rng = np.random.RandomState(25)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    imgs, tgts = engine.build_query_batch(list(rng.rand(3, res, res, 3)),
                                          img2, tgt2)
    fr.flash_attention_relpos.launches = 0
    got = eng.run_queries(imgs, tgts)
    out = {"device": str(eng.device), "shape": list(got.shape),
           "launches": fr.flash_attention_relpos.launches,
           "finite": bool(np.isfinite(got).all()),
           "digest": hashlib.sha256(got.tobytes()).hexdigest()}
    if rank == 0:
        ref = engine.InContextModel(cfg, model).run_queries(imgs, tgts)
        out["max_abs"] = float(np.abs(got.astype(np.float64) - ref).max())
    return out


def phase_gloo_ranks(label):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), spawned as processes of this script: an update under fsdp 2
    and one under dp 2 (``GLOO_CFG``), held to the one-process update at
    the global batch, then dp serving over the group (``_gloo_serve``).
    Returns each kernel's launches over both ranks."""
    import os
    import tempfile
    tmp = tempfile.TemporaryDirectory()
    outs = [os.path.join(tmp.name, f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--gloo-rank", str(r), "--store",
         os.path.join(tmp.name, "store"), "--out", outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"gloo rank {r} failed:\n{log[-3000:]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    tmp.cleanup()
    depth = GLOO_CFG["depth"]
    s0, s1 = ranks[0]["serve"], ranks[1]["serve"]
    print(f"# gloo, 2 ranks on cuda:0, dp serving (a cuda DeviceMesh, no "
          f"device), ragged b3, {depth} blocks: devices {s0['device']} / "
          f"{s1['device']}, K1 launches {s0['launches']} / "
          f"{s1['launches']}, ranks' outputs equal "
          f"{s0['digest'] == s1['digest']}, max abs vs one device "
          f"{s0['max_abs']:.4g} (tol {FWD_BF16_TOL}) [{label}]")
    for r in (s0, s1):
        check(r["device"].startswith("cuda") and r["finite"]
              and r["shape"] == [3] + [GLOO_RES] * 2 + [3]
              and r["launches"] == depth,
              f"gloo dp serving: {r}")
    check(s0["digest"] == s1["digest"] and s0["max_abs"] <= FWD_BF16_TOL,
          f"gloo dp serving differs: {s0}, {s1}")
    totals = [s0["launches"] + s1["launches"], 0, 0, 0]
    for mode in GLOO_MODES:
        r0, r1 = ranks[0][mode], ranks[1][mode]
        for r in (r0, r1):
            totals = [a + b for a, b in zip(totals, r["launches"])]
        loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        gn_err = abs(r0["grad_norm"] - r0["ref_grad_norm"]) / \
            r0["ref_grad_norm"]
        print(f"# gloo, 2 ranks on cuda:0, {mode} (mesh "
              f"{GLOO_MODES[mode]}), {depth} blocks: launches K1-K4 rank 0 "
              f"{r0['launches']}, rank 1 {r1['launches']}; loss "
              f"{r0['loss']:.6f} vs one process {r0['ref_loss']:.6f} (rel "
              f"{loss_err:.2e}), grad norm rel {gn_err:.2e}, reduced "
              f"gradients relative L2 {r0['grad_rel_l2']:.3e} (tol "
              f"{GRAD_BF16_REL_L2}); the update vs one-process AdamW on the "
              f"same gradients max abs {r0['update_max_abs']:.3e} (params "
              f"max {r0['param_max']:.3f}); {r0['sharded']} parameters "
              f"sharded; ranks hold equal parameters "
              f"{r0['ranks_equal'] and r1['ranks_equal']} [{label}]")
        for r in (r0, r1):
            check(r["launches"] == [2 * depth, 2 * depth, 2, 2],
                  f"gloo {mode}: launches {r['launches']}")
        check(r0["ranks_equal"] and r1["ranks_equal"],
              f"gloo {mode}: the ranks hold different parameters")
        check((r0["sharded"] > 0) == (mode == "fsdp"),
              f"gloo {mode}: {r0['sharded']} sharded parameters")
        check(max(loss_err, gn_err, r0["grad_rel_l2"]) <= GRAD_BF16_REL_L2,
              f"gloo {mode}: the update differs from one process's")
        # AdamW is elementwise: the sliced update is the whole one up to
        # fp32 rounding of the parameters
        check(r0["update_max_abs"] <= 1e-6 * r0["param_max"],
              f"gloo {mode}: the sharded update differs by "
              f"{r0['update_max_abs']}")
    return totals


# ---------------------------------------------------------------------------
# the data front end: raw datasets -> prep CLI -> training
# ---------------------------------------------------------------------------

# Counts cut for time; the shapes are the datasets': COCO 640x480 images
# (panoptic and person keypoints), ADE20K 512x683, SIDD Medium sRGB
# 3000x5328 pairs, instance copies at 1024^2, pose crops at 256x192.
FE_SEED = 40
FE_PAN_IMAGES = 4        # the last one without things
FE_ADE_IMAGES = 6
FE_SIDD_SCENES, FE_SIDD_HW, FE_SIDD_PATCHES = 2, (3000, 5328), 8  # 300
FE_INST_AUG, FE_POSE_AUG = 2, 2                                   # 30, 20
FE_TOY_N = 4             # pairs per task in the training set
FE_UPDATES, FE_ACCUM, FE_BATCH, FE_WORKERS = 3, 2, 2, 2
# the seccrop transform's host time, native against the numpy dense path
FE_SECCROP_SAMPLES = 6
# pose decode of an unaugmented crop, in crop pixels (as
# tests/test_trainset_gen.py's 1.5 px at a 0.46 px crop stride)
FE_POSE_DECODE_PX = 1.5


def _fe_panoptic(root, rng):
    """COCO panoptic: images/*.jpg (640x480), panoptic/*.png (id = R + 256
    G), panoptic.json with 80 thing and 53 stuff categories; every image
    with a stuff background, image 0 with a crowd thing, the last with no
    things."""
    import os
    from PIL import Image
    os.makedirs(f"{root}/images")
    os.makedirs(f"{root}/panoptic")
    h, w = 480, 640
    cats = [{"id": 1 + i, "name": f"thing{i}", "isthing": 1}
            for i in range(80)] + \
        [{"id": 92 + i, "name": f"stuff{i}", "isthing": 0}
         for i in range(53)]
    images, anns = [], []
    for i in range(FE_PAN_IMAGES):
        Image.fromarray(_smooth_u8(rng, (h, w))).save(
            f"{root}/images/{i:012d}.jpg", quality=90)
        ids = np.full((h, w), 1000 + i, np.uint32)
        segs = [{"id": 1000 + i, "category_id": 92 + int(rng.randint(53)),
                 "iscrowd": 0}]
        n_things = 0 if i == FE_PAN_IMAGES - 1 else 3
        for t in range(n_things):
            y0, x0 = 20 + 130 * t, 30 + 190 * t
            hh, ww = 120 + int(rng.randint(60)), 140 + int(rng.randint(60))
            yy, xx = np.mgrid[0:hh, 0:ww]
            ell = ((yy - hh / 2) / (hh / 2)) ** 2 + \
                ((xx - ww / 2) / (ww / 2)) ** 2 <= 1
            seg_id = 256 * (t + 1) + 7 * i + 3  # ids past one byte
            ids[y0:y0 + hh, x0:x0 + ww][ell] = seg_id
            segs.append({"id": seg_id, "category_id": 1 + int(
                rng.randint(80)), "iscrowd": int(i == 0 and t == 2)})
        png = np.stack([ids % 256, (ids // 256) % 256, ids // 65536],
                       -1).astype(np.uint8)
        Image.fromarray(png).save(f"{root}/panoptic/{i:012d}.png")
        images.append({"id": 100 + i, "file_name": f"{i:012d}.jpg",
                       "height": h, "width": w})
        anns.append({"image_id": 100 + i, "file_name": f"{i:012d}.png",
                     "segments_info": segs})
    with open(f"{root}/panoptic.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)


def _fe_keypoints(root, rng):
    """COCO person keypoints: images/*.jpg (640x480) and kp.json, 17
    joints per person, one joint unlabeled, a crowd box and a box with no
    keypoints; dets.json holds the people's boxes as detections (their
    x1.25 crops lie inside the image, as PIL's crop takes)."""
    import os
    from PIL import Image
    os.makedirs(f"{root}/images")
    boxes = {200: [[200, 100, 120, 240], [400, 150, 100, 200]],
             201: [[260, 120, 110, 220]]}
    images, anns, dets = [], [], []
    ann_id = 500
    for img_id, people in boxes.items():
        Image.fromarray(_smooth_u8(rng, (480, 640))).save(
            f"{root}/images/{img_id:012d}.jpg", quality=90)
        images.append({"id": img_id, "file_name": f"{img_id:012d}.jpg",
                       "height": 480, "width": 640})
        for p, (x, y, bw, bh) in enumerate(people):
            k = np.zeros((17, 3), np.float64)
            k[:, 0] = rng.uniform(x + 5, x + bw - 5, 17)
            k[:, 1] = rng.uniform(y + 5, y + bh - 5, 17)
            k[:, 2] = 2
            if ann_id == 500:
                k[3] = 0  # an unlabeled joint
            anns.append({"id": ann_id, "image_id": img_id, "iscrowd": 0,
                         "area": float(bw * bh),
                         "num_keypoints": int((k[:, 2] > 0).sum()),
                         "bbox": [float(v) for v in (x, y, bw, bh)],
                         "keypoints": k.ravel().round(2).tolist()})
            dets.append({"image_id": img_id, "category_id": 1,
                         "bbox": [float(v) for v in (x, y, bw, bh)],
                         "score": 0.9 - 0.1 * p})
            ann_id += 1
    anns.append({"id": ann_id, "image_id": 200, "iscrowd": 1, "area": 900.0,
                 "num_keypoints": 0, "bbox": [10.0, 10.0, 30.0, 30.0],
                 "keypoints": [0] * 51})
    anns.append({"id": ann_id + 1, "image_id": 201, "iscrowd": 0,
                 "area": 400.0, "num_keypoints": 0,
                 "bbox": [500.0, 20.0, 20.0, 20.0], "keypoints": [0] * 51})
    with open(f"{root}/kp.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    with open(f"{root}/dets.json", "w") as f:
        json.dump(dets, f)


def _fe_ade(root, rng):
    """ADE20K: images/*.jpg and annotations/*.png at 512x683, 1-based
    labels (0 = ignore) in rectangles."""
    import os
    from PIL import Image
    os.makedirs(f"{root}/images")
    os.makedirs(f"{root}/annotations")
    h, w = 512, 683
    for i in range(FE_ADE_IMAGES):
        name = f"ADE_train_{i:08d}"
        Image.fromarray(_smooth_u8(rng, (h, w))).save(
            f"{root}/images/{name}.jpg", quality=90)
        lab = np.full((h, w), 1 + int(rng.randint(150)), np.uint8)
        for _ in range(6):
            y0, x0 = int(rng.randint(0, h - 100)), int(rng.randint(0, w - 100))
            lab[y0:y0 + 100 + int(rng.randint(200)),
                x0:x0 + 100 + int(rng.randint(200))] = int(rng.randint(151))
        Image.fromarray(lab).save(f"{root}/annotations/{name}.png")


def _fe_sidd(root, rng):
    """SIDD Medium sRGB: <scene>/{GT,NOISY}_SRGB_010.PNG at 3000x5328."""
    import os
    from PIL import Image
    for s in range(FE_SIDD_SCENES):
        scene = f"{root}/{s + 1:04d}_001_S6_00100_00060_3200_L"
        os.makedirs(scene)
        clean = _smooth_u8(rng, FE_SIDD_HW)
        noise = rng.randint(-12, 13, (FE_SIDD_HW[0], 1, 3))
        noisy = np.clip(clean.astype(np.int16) + noise, 0, 255).astype(
            np.uint8)
        Image.fromarray(clean).save(f"{scene}/GT_SRGB_010.PNG",
                                    compress_level=1)
        Image.fromarray(noisy).save(f"{scene}/NOISY_SRGB_010.PNG",
                                    compress_level=1)


def _prep_cli(*commands):
    """Run each command line of the port's prep CLI as a user would, in
    subprocesses started together; returns their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "painter_tpu_torch.data.prep", *cmd],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(commands, procs, outs):
        check(p.returncode == 0, f"prep {cmd[0]} failed:\n{out[-3000:]}")
        print(f"# prep {cmd[0]}: {out.strip().splitlines()[-1][:200]}")
    return outs


def _fe_compare_sets(card_json, cpu_json, image_key):
    """The card's generated set against the CPU's: the same JSON, targets
    bit for bit, images within one uint8 step. Returns (files, share of
    image values that differ)."""
    import os
    from PIL import Image
    with open(card_json, "rb") as a, open(cpu_json, "rb") as b:
        check(a.read() == b.read(), f"{card_json}: JSON differs on the CPU")
    with open(card_json) as f:
        pairs = json.load(f)
    croot, hroot = os.path.dirname(card_json), os.path.dirname(cpu_json)
    differing = total = 0
    for pair in pairs:
        for key in ("image_path", "target_path"):
            a = np.asarray(Image.open(f"{croot}/{pair[key]}"), np.int16)
            b = np.asarray(Image.open(f"{hroot}/{pair[key]}"), np.int16)
            if key == image_key:
                check(np.abs(a - b).max() <= 1,
                      f"{pair[key]}: the card's image is "
                      f"{np.abs(a - b).max()} steps off the CPU's")
                differing += int((a != b).sum())
                total += a.size
            else:
                check(np.array_equal(a, b),
                      f"{pair[key]}: the card's target differs")
    return len(pairs), differing / max(total, 1)


def _fe_instance_decodes(data, pan_root):
    """Each thing of a train_org target decodes (the 6400-color palette
    on the card) to the cell of its mass centre; the crowd thing and the
    stuff stay black."""
    from PIL import Image
    from painter_tpu_torch.data import prep, trainset_gen as tg
    from painter_tpu_torch.ops.palette import (coco_instance_palette,
                                               nearest_color_decode)
    with open(f"{pan_root}/panoptic.json") as f:
        pan = json.load(f)
    pal = torch.from_numpy(coco_instance_palette().astype(np.float32)).cuda()
    checked = 0
    # one color per thing: decode the distinct colors (a (1024, 1024, 6400)
    # distance map would not fit)
    for ann in pan["annotations"][:FE_PAN_IMAGES - 1]:
        stem = ann["file_name"][:-4]
        img = np.asarray(Image.open(
            f"{data}/train_org/{stem}_label_train_org.png"))
        ids = prep.panoptic_png_to_ids(np.asarray(Image.open(
            f"{pan_root}/panoptic/{ann['file_name']}").convert("RGB")))
        for seg in ann["segments_info"]:
            if seg["category_id"] > 80:
                continue
            mask = tg.resize_nearest((ids == seg["id"])[None], (1024, 1024),
                                     torch.device("cpu"))[0]
            if seg["iscrowd"]:
                check(not img[mask].any(), f"{stem}: a crowd thing painted")
                continue
            cx, cy = prep.mass_center(mask)
            ax, ay = int(cx / 1024 * 79), int(cy / 1024 * 79)
            want = ((ay // 20 * 4 + ax // 20) * 20 + ay % 20) * 20 + ax % 20
            colors = np.unique(img[mask], axis=0)
            got = nearest_color_decode(torch.from_numpy(colors).float()
                                       .cuda()[None], pal)[0].tolist()
            check(got == [want], f"{stem} segment {seg['id']}: decodes to "
                  f"{got[:5]}, its mass centre to {want}")
            checked += 1
    return checked


def _fe_pose_decodes(kp_root, out):
    """An unaugmented crop of every person, painted on the card, decodes
    (``evals/pose.py``) back to its joints; the unlabeled joint stays
    silent. Returns (people, worst error in crop pixels)."""
    from PIL import Image
    from painter_tpu_torch.data import trainset_gen as tg
    from painter_tpu_torch.evals.pose import (decode_painted_heatmaps,
                                              keypoints_from_heatmaps)
    jp = tg.gen_pose_trainset(f"{kp_root}/kp.json", f"{kp_root}/images",
                              out, val=True)
    with open(jp) as f:
        pairs = json.load(f)
    with open(f"{kp_root}/kp.json") as f:
        people = [a for a in json.load(f)["annotations"]
                  if a["num_keypoints"] > 0 and not a["iscrowd"]]
    check(len(pairs) == len(people), f"{len(pairs)} val crops for "
          f"{len(people)} people")
    worst = 0.0
    for pair, ann in zip(pairs, people):
        lab = np.asarray(Image.open(f"{out}/{pair['target_path']}"),
                         np.float32)
        kpts = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
        center, scale = tg.bbox_to_center_scale(ann["bbox"])
        dec, maxvals = keypoints_from_heatmaps(
            decode_painted_heatmaps(lab[None]), center[None], scale[None])
        vis = kpts[:, 2] > 0
        px = scale[0] * 200.0 / 192  # image pixels per crop pixel
        err = float(np.abs(dec[0][vis] - kpts[vis, :2]).max() / px)
        worst = max(worst, err)
        check(err < FE_POSE_DECODE_PX and (maxvals[0, vis, 0] > 0.9).all()
              and (maxvals[0, ~vis, 0] < 0.1).all(),
              f"pose crop {pair['target_path']}: decode error {err:.3f} "
              f"crop px, peaks {maxvals[0, :, 0]}")
    return len(pairs), worst


def _fe_card_vs_cpu_ops(pan_root):
    """The generators' torch ops on the card against the CPU at the
    instance sizes (1024 x 0.7..2.0) and the pose warp."""
    from PIL import Image
    from painter_tpu_torch.data import trainset_gen as tg
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    img = np.asarray(Image.open(f"{pan_root}/images/{0:012d}.jpg"))
    masks = np.asarray(Image.open(f"{pan_root}/panoptic/{0:012d}.png"))[
        None, ..., 1] > 0
    worst, share = 0, 0.0
    for size in (716, 1024, 2047):
        a = tg.resize_bilinear(img, (size, size), cuda).astype(np.int16)
        b = tg.resize_bilinear(img, (size, size), cpu).astype(np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
        share = max(share, float((a != b).mean()))
        check(np.array_equal(tg.resize_nearest(masks, (size, size), cuda),
                             tg.resize_nearest(masks, (size, size), cpu)),
              f"nearest masks at {size} differ between card and CPU")
    for rot in (0.0, 31.0, -70.0):
        mat = tg.get_affine_transform(np.array([300.0, 240.0], np.float32),
                                      np.array([1.1, 1.5], np.float32), rot,
                                      (192, 256))
        a = tg.warp_affine(img, mat, (192, 256), cuda).astype(np.int16)
        b = tg.warp_affine(img, mat, (192, 256), cpu).astype(np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
        share = max(share, float((a != b).mean()))
    check(worst <= 1, f"card resize / warp {worst} steps off the CPU's")
    return worst, share


def _fe_seccrop_times():
    """ms per sample of the seccrop transform on stitched 896x448 canvases
    (image bicubic, target nearest), native banded resize against the
    numpy dense gemm, on the same draws, in turns (dense, native, native,
    dense). Returns {"native": [ms, ms], "dense": [ms, ms]}."""
    from painter_tpu_torch.data import transforms as T
    rng = np.random.RandomState(FE_SEED)
    canvases = [(rng.randn(896, 448, 3).astype(np.float32),
                 rng.randn(896, 448, 3).astype(np.float32))
                for _ in range(FE_SECCROP_SAMPLES)]
    times = {"native": [], "dense": []}
    outs = {}
    for native in (False, True, True, False):
        tf = T.seccrop_transform((896, 448), native=native)
        t0 = time.perf_counter()
        res = [tf(img, tgt, np.random.default_rng((FE_SEED, i)), None,
                  "nearest") for i, (img, tgt) in enumerate(canvases)]
        key = "native" if native else "dense"
        times[key].append((time.perf_counter() - t0) * 1e3 / len(res))
        outs[key] = res
    for (a, b), (c, d) in zip(outs["native"], outs["dense"]):
        check(a.shape == c.shape == (896, 448, 3) and np.array_equal(b, d)
              and np.abs(a - c).max() <= 1e-4,
              f"seccrop native vs dense: {np.abs(a - c).max()}")
    return times


def _fe_seccrop_one_thread():
    """:func:`_fe_seccrop_times` in a process whose BLAS and OpenMP run one
    thread (the share of a data worker when the pool fills the host's
    cores), spawned as ``chip_smoke.py --seccrop-times OUT``."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "times.json")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, __file__, "--seccrop-times",
                               out], env=env, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"one-thread seccrop timing failed:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        with open(out) as f:
            return json.load(f)


def _timed_iterator(pd, waits):
    """Wrap ``pd.data_iterator``: each ``next()``'s wait and the time
    between batches, per call (the trainer's epoch, then validation)."""
    real = pd.data_iterator

    def data_iterator(*args, **kwargs):
        it = real(*args, **kwargs)
        call = {"wait": [], "start": []}
        waits.append(call)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                call["wait"].append(time.perf_counter() - t0)
                call["start"].append(time.perf_counter())
                yield batch
        finally:
            it.close()
    return real, data_iterator


def phase_data_front_end(label):
    """Raw synthetic datasets in their own formats -> the port's prep CLI
    (subprocesses; the two generators on the card) -> checks that the
    targets decode back to their annotations and that the card's set
    equals the CPU's -> ``train.main`` of Painter ViT-L 896x448 on the
    generated sets (K1-K4 counted, native ops in 2 spawned workers) ->
    the dryrun on two ranks of the card. Returns K1-K4's launches."""
    import os
    import tempfile
    from painter_tpu_torch import configs
    from painter_tpu_torch.data import pairdataset as pd
    from painter_tpu_torch.data import trainset_gen as tg
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.train import train
    tmp = tempfile.TemporaryDirectory()
    raw, data = f"{tmp.name}/raw", f"{tmp.name}/data"
    rng = np.random.RandomState(FE_SEED)
    t0 = time.perf_counter()
    _fe_panoptic(f"{raw}/coco_pan", rng)
    _fe_keypoints(f"{raw}/coco_kp", rng)
    _fe_ade(f"{raw}/ade20k", rng)
    _fe_sidd(f"{raw}/sidd", rng)
    print(f"# data front end: raw datasets written in "
          f"{time.perf_counter() - t0:.1f} s ({FE_PAN_IMAGES} COCO panoptic "
          f"640x480, 3 person-keypoint people in 2 images, "
          f"{FE_ADE_IMAGES} ADE20K 512x683, {FE_SIDD_SCENES} SIDD pairs "
          f"{FE_SIDD_HW[0]}x{FE_SIDD_HW[1]})")
    pan, kp = f"{raw}/coco_pan", f"{raw}/coco_kp"
    t0 = time.perf_counter()
    _prep_cli(
        ["paint-semantic", "--label_dir", f"{raw}/ade20k/annotations",
         "--out_dir", f"{data}/ade20k/painted", "--task", "ade20k"],
        ["semantic-from-panoptic", "--panoptic_json",
         f"{pan}/panoptic.json", "--panoptic_root", f"{pan}/panoptic",
         "--out_dir", f"{raw}/coco_semantic"],
        ["gen-instance-trainset", "--panoptic_json", f"{pan}/panoptic.json",
         "--panoptic_root", f"{pan}/panoptic", "--image_root",
         f"{pan}/images", "--out_dir", data, "--num_aug", str(FE_INST_AUG),
         "--seed", str(FE_SEED)],
        ["gen-pose-trainset", "--keypoints_json", f"{kp}/kp.json",
         "--image_root", f"{kp}/images", "--out_dir", data, "--num_aug",
         str(FE_POSE_AUG), "--seed", str(FE_SEED)],
        ["gen-sidd-patches", "--src_dir", f"{raw}/sidd", "--out_dir",
         f"{data}/sidd", "--num_patches", str(FE_SIDD_PATCHES)],
        ["pose-eval-crops", "--image_dir", f"{kp}/images", "--det_json",
         f"{kp}/dets.json", "--coco_images_json", f"{kp}/kp.json",
         "--out_dir", f"{tmp.name}/pose_eval"])
    t_gen = time.perf_counter() - t0
    _prep_cli(
        ["paint-semantic", "--label_dir", f"{raw}/coco_semantic",
         "--out_dir", f"{data}/coco/painted", "--task", "coco_semseg"])
    os.symlink(f"{raw}/ade20k/images", f"{data}/ade20k/images")
    os.symlink(f"{pan}/images", f"{data}/coco/images")
    jsons = {"coco_inst": f"{data}/coco_train_image2panoptic_inst.json",
             "pose": f"{data}/coco_train_image2pose.json",
             "ade20k": f"{data}/ade20k.json", "coco_semseg":
             f"{data}/coco_semseg.json", "denoise": f"{data}/sidd.json"}
    _prep_cli(
        ["gen-json", "--image_dir", f"{data}/ade20k/images", "--target_dir",
         f"{data}/ade20k/painted", "--type", "ade20k_image2semantic",
         "--out_json", jsons["ade20k"], "--root", data, "--image_ext",
         "*.jpg"],
        ["gen-json", "--image_dir", f"{data}/coco/images", "--target_dir",
         f"{data}/coco/painted", "--type", "coco_image2panoptic_sem_seg",
         "--out_json", jsons["coco_semseg"], "--root", data, "--image_ext",
         "*.jpg"],
        ["gen-json", "--image_dir", f"{data}/sidd/input", "--target_dir",
         f"{data}/sidd/groundtruth", "--type", "ssid_image2denoise",
         "--out_json", jsons["denoise"], "--root", data])
    toy = f"{tmp.name}/toy"
    _prep_cli(["toy-dataset", "--json_paths", *jsons.values(), "--out_dir",
               toy, "--root", data, "--n", str(FE_TOY_N)])
    counts = {}
    for task, path in jsons.items():
        with open(path) as f:
            counts[task] = len(json.load(f))
    with open(f"{tmp.name}/pose_eval/meta.json") as f:
        crops = len(json.load(f))
    # an aug copy whose crop holds no thing is skipped, as in the
    # reference; org / orgflip of the three images with things never are
    inst = counts.pop("coco_inst")
    check(3 * 2 <= inst <= 3 * (FE_INST_AUG + 2)
          and counts == {"pose": 3 * FE_POSE_AUG, "ade20k": FE_ADE_IMAGES,
                         "coco_semseg": FE_PAN_IMAGES,
                         "denoise": FE_SIDD_SCENES * FE_SIDD_PATCHES}
          and crops == 3, f"generated pairs {inst}, {counts}, eval crops "
          f"{crops}")
    counts["coco_inst"] = inst
    print(f"# data front end: prep CLI wrote {counts} pairs and {crops} "
          f"pose eval crops (+ flips); the generators took {t_gen:.1f} s "
          f"on the card, beside the other first-stage subcommands")
    # the card's sets against the CPU's, and the targets' decodes
    t0 = time.perf_counter()
    cpu_inst = tg.gen_instance_trainset(
        f"{pan}/panoptic.json", f"{pan}/panoptic", f"{pan}/images",
        f"{tmp.name}/cpu", num_aug=FE_INST_AUG, seed=FE_SEED, device="cpu")
    cpu_pose = tg.gen_pose_trainset(f"{kp}/kp.json", f"{kp}/images",
                                    f"{tmp.name}/cpu", num_aug=FE_POSE_AUG,
                                    seed=FE_SEED, device="cpu")
    t_cpu = time.perf_counter() - t0
    n_inst, inst_share = _fe_compare_sets(jsons["coco_inst"], cpu_inst,
                                          "image_path")
    n_pose, pose_share = _fe_compare_sets(jsons["pose"], cpu_pose,
                                          "image_path")
    worst, op_share = _fe_card_vs_cpu_ops(pan)
    things = _fe_instance_decodes(data, pan)
    people, pose_err = _fe_pose_decodes(kp, f"{tmp.name}/pose_val")
    print(f"# data front end: the card's sets vs the CPU's ({t_cpu:.1f} s "
          f"on the host): {n_inst} instance and {n_pose} pose pairs, JSON "
          f"and targets identical, images within 1 step ({inst_share:.4f} / "
          f"{pose_share:.4f} of values differ); resize / warp ops card vs "
          f"CPU max {worst} step ({op_share:.4f}), nearest masks equal; "
          f"{things} things decode to their mass-centre cells, {people} "
          f"val pose crops to their joints (worst {pose_err:.3f} crop px, "
          f"tol {FE_POSE_DECODE_PX}) [{label}]")
    for where, times in (("this process (BLAS on every core)",
                          _fe_seccrop_times()),
                         ("a process with one BLAS thread",
                          _fe_seccrop_one_thread())):
        native, dense = min(times["native"]), min(times["dense"])
        print(f"# seccrop transform on stitched 896x448 canvases in {where}"
              f", host ms per sample in turns (dense, native, native, "
              f"dense): {times['dense'][0]:.2f}, {times['native'][0]:.2f}, "
              f"{times['native'][1]:.2f}, {times['dense'][1]:.2f}; best "
              f"native {native:.2f} vs dense {dense:.2f} "
              f"({dense / native:.2f}x) [{label}]")
    # training on the generated sets
    cfg = configs.get_config(PAINTER)
    toy_jsons = [f"{toy}/{os.path.basename(p)}" for p in jsons.values()]
    args = train.get_args_parser().parse_args([
        "--data_path", toy, "--json_path", *toy_jsons, "--val_json_path",
        *toy_jsons, "--output_dir", f"{tmp.name}/run", "--model", PAINTER,
        "--dtype", "bfloat16", "--input_size", *map(str, cfg.img_size),
        "--num_mask_patches", str(cfg.num_patches // 2),
        "--max_mask_patches_per_block", str(cfg.num_patches // 4),
        "--batch_size", str(FE_BATCH), "--accum_iter", str(FE_ACCUM),
        "--epochs", "1", "--max_steps_per_epoch", str(FE_UPDATES),
        "--remat_policy", "save_kernel", "--decoder_impl", "fused",
        "--num_workers", str(FE_WORKERS), "--print_freq", "1",
        "--watchdog_freq", "1"])
    counters = (fr.flash_attention_relpos, fr.flash_attention_relpos_bwd,
                dh.fused_decoder_tail, dh.fused_decoder_tail_bwd)
    for c in counters:
        c.launches = 0
    waits = []
    real, pd.data_iterator = _timed_iterator(pd, waits)
    try:
        result = train.main(args)
    finally:
        pd.data_iterator = real
    k1, k2, k3, k4 = (c.launches for c in counters)
    micro, depth = FE_UPDATES * FE_ACCUM, cfg.depth
    val_batches = len(waits[1]["wait"])
    with open(f"{tmp.name}/run/scalars.jsonl") as f:
        scalars = [json.loads(line) for line in f]
    with open(f"{tmp.name}/run/log.txt") as f:
        stats = json.loads(f.readline())
    check(result["step"] == FE_UPDATES, f"trained {result['step']} updates")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              for s in scalars) and np.isfinite(stats["val_loss"]),
          f"non-finite loss: {scalars}, {stats}")
    check(k1 == depth * (micro + val_batches) and k2 == depth * micro
          and k3 == micro and k4 == micro,
          f"K1-K4 launched {k1}, {k2}, {k3}, {k4} times on the generated "
          f"sets ({micro} micro-batches, {val_batches} validation batches)")
    train_wait = waits[0]["wait"]
    starts = waits[0]["start"]
    update_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    print(f"# training on the generated sets (instance, pose, ADE20K, COCO "
          f"semseg, denoise; {FE_TOY_N} pairs each, {FE_WORKERS} spawned "
          f"workers with the native ops): losses "
          f"{[round(s['loss'], 5) for s in scalars]}, val loss "
          f"{stats['val_loss']:.5f}; K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} "
          f"launches; data wait per update "
          f"{', '.join(f'{1e3 * w:.1f}' for w in train_wait)} ms (the "
          f"first spawns the workers), validation "
          f"{', '.join(f'{1e3 * w:.1f}' for w in waits[1]['wait'])} ms; "
          f"ms between batches (an update and the next batch's wait) "
          f"{', '.join(f'{t:.1f}' for t in update_ms)} [{label}]")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    # the dryrun, two ranks on the one card (gloo)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "painter_tpu_torch.dryrun", "2", "--procs",
         "2"], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"dryrun failed:\n{proc.stdout[-3000:]}"
          f"\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    for want in ("rank 0: mesh", "meter sync ok", "dp-sharded serving",
                 "flagship ViT-L", "real processes over gloo on cuda:0"):
        check(any(want in line for line in lines),
              f"dryrun printed no {want!r} line:\n{proc.stdout}")
    for line in lines:
        print(f"# {line}")
    print(f"# dryrun 2 --procs 2 on the card: {time.perf_counter() - t0:.1f}"
          f" s [{label}]")
    tmp.cleanup()
    return k1, k2, k3, k4


# ---------------------------------------------------------------------------
# The shapes past the ViT-L kernels: K1g-K4g, tiny_test, ViT-L at 1280x640
# ---------------------------------------------------------------------------

# K1g / K2g (csrc/flash_relpos_generic.cu) at the JAX package's
# kernel-test shapes ((BH, hd, grid): hd 16 on 8x4 and 12x6, hd 120 on
# 16x8, hd 8 on 6x4), tiny_test's serving and training shapes (hd 16 on
# its 8x4 grid at b2 x 2 heads; 2x2 windows, 16 windows x b2 x 2 heads)
# and grids past the ViT-L kernels' rel-term limits (kw 3; kw 200, past a
# 64-key tile)
GENERIC_ATTN_SHAPES = ((4, 16, (8, 4)), (4, 16, (12, 6)), (4, 120, (16, 8)),
                       (4, 8, (6, 4)), (64, 16, (2, 2)), (4, 32, (40, 3)),
                       (2, 32, (2, 200)))
# K1g / K2g at full size, (BH, hd, grid, with the backward): the ViT-L
# update at --input_size 1280 640 (b1 x 16 heads on 80x40, where K1 and K2
# take both: K1g and K2g called directly, timed beside K2), at 1440 720
# (90x45: K1 forward, K2g backward), a b1 forward at 2048x1024 (128x64,
# kh + kw 192 past K1's 190: K1g; the domain's edge, 64 + 64 = 128) and a
# ViT-H-width head (1280 / 16 = 80, padded to 128) on the 56x28 grid at
# b8 (80 + 28 = 108)
GENERIC_MAIN_SHAPE = (16, 64, (80, 40))
GENERIC_FULL_SHAPES = ((16, 64, (80, 40), True), (16, 64, (90, 45), True),
                       (16, 64, (128, 64), False),
                       (128, 80, (56, 28), True))
# the full-size main paths' shapes: K2g's (the 1440x720 update) and K1g's
# (the 2048x1024 forward)
GENERIC_BWD_MAIN = (16, 64, (90, 45))
GENERIC_FWD_MAIN = (16, 64, (128, 64))
# K1g's and K2g's kernels in a profile (csrc/flash_relpos_generic.cu)
GENERIC_ATTN_KERNELS = {"fwd": ("gtc::fwd_kernel",),
                        "bwd": ("gtc::dq_kernel", "gtc::dkv_kernel")}
# K3g / K4g at the JAX tests' C = 8 on 16x12 and 12x8, tiny_test's b2
# (2, 64, 32, 8) (the main-path shape of the narrow route), 40 on a
# ragged 37x29 and 128, and past 128 channels: 160 and 256 at tiny_test's
# pixels (split rows: its 128 units would leave SMs idle in whole rows),
# 264 there (past 256: split rows at any size), 520 on a ragged 16x40
# (past 512: the N tiles with u in a scratch), 96 on 267x60 (267 units:
# whole rows whose last item holds one real unit), and a b1 896x448
# decoder at 256 (whole rows of m64n256, the widest one-warpgroup width;
# the wide ViT-L update's shape) and 128 (tanh only at 896x448, for time).
# Widths that are not a multiple of 8, where the tensor-core route pads
# the pixels to CD > C: 13 on 16x12 and 100 on 37x29 (split rows), 100 on
# 140x70 (whole rows) and 517 on 8x40 (the N tiles and the row kernels).
# C >= 9 runs the tensor-core kernels (csrc/decoder_tail_tc_*.cu; fp32 in
# 3xTF32), C <= 8 the narrow ones (csrc/decoder_tail_generic.cu): also at
# C 1, 3 and 5 on ragged grids (the pixels read unpadded, tiles ragged at
# both edges), at (1, 896, 448, 8), the shape the 8-channel ViT-L update
# gives it (b1 x accum 2: 16-row tiles, at most one round of persistent
# CTAs), and at (2, 896, 448, 8), its b2 (several tiles per persistent
# CTA). In fp32 whole rows stop at 128 channels and split rows at 256: 160
# and 256 run split rows, 264, 517 and 520 the N tiles and the row kernels.
GENERIC_TAIL_SHAPES = (((2, 16, 12), 8), ((2, 12, 8), 8), ((2, 64, 32), 8),
                       ((2, 37, 29), 1), ((1, 23, 45), 3), ((2, 19, 70), 5),
                       ((2, 896, 448), 8),
                       ((2, 37, 29), 40), ((1, 16, 16), 128),
                       ((2, 64, 32), 160), ((2, 64, 32), 256),
                       ((2, 64, 32), 264), ((1, 16, 40), 520),
                       ((1, 267, 60), 96), ((2, 16, 12), 13),
                       ((2, 37, 29), 100), ((1, 140, 70), 100),
                       ((1, 8, 40), 517), ((1, 896, 448), 256),
                       ((1, 896, 448), 128), ((1, 896, 448), 8))
GENERIC_TAIL_BIG = ((1, 896, 448), 256)
GENERIC_TAIL_BIG_SHAPES = (GENERIC_TAIL_BIG, ((1, 896, 448), 128),
                           ((1, 896, 448), 8), ((2, 896, 448), 8))
GENERIC_TAIL_MAIN = ((2, 64, 32), 8)
# the narrow route timed in turns with the stock tail, both types, with
# its device ms per launch by kernel: tiny_test's decoder and the
# 8-channel one at a full 896x448 pixel count
NARROW_TIMED = (GENERIC_TAIL_MAIN, ((2, 896, 448), 8))
TINY = "tiny_test"
# tiny_test with 2x2 windows in half its blocks: key grids of width 2
TINY_WINDOWED = dict(window_block_indexes=(0, 3, 4))
PAINTER_1280 = (1280, 640)
# Painter ViT-L on a 90x45 grid (the backward on K2g) and a 128x64 one
# (the forward on K1g)
PAINTER_1440 = (1440, 720)
PAINTER_2048 = (2048, 1024)


def _generic_counts():
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.kernels import int8_mlp as k5
    return (fr.flash_attention_relpos_generic,
            fr.flash_attention_relpos_bwd_generic,
            dh.fused_decoder_tail_generic, dh.fused_decoder_tail_bwd_generic,
            k5.int8_mlp_generic)


def _vitl_counts():
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.kernels import flash_relpos as fr
    from painter_tpu_torch.kernels import int8_mlp as k5
    return (fr.flash_attention_relpos, fr.flash_attention_relpos_bwd,
            dh.fused_decoder_tail, dh.fused_decoder_tail_bwd, k5.int8_mlp)


def _tc_counts():
    from painter_tpu_torch.kernels import decoder_head as dh
    return dh.fused_decoder_tail_tc, dh.fused_decoder_tail_bwd_tc


def _zero_counts():
    for fn in _generic_counts() + _vitl_counts() + _tc_counts():
        fn.launches = 0


def _read_tc_counts():
    """(K3g, K4g) launches on the tensor-core route (the narrow route's are
    in :func:`_read_counts`)."""
    return tuple(fn.launches for fn in _tc_counts())


def _read_counts():
    """(K1, K2, K3, K4, K5) and (K1g, K2g, K3g, K4g, K5g) launches."""
    return (tuple(fn.launches for fn in _vitl_counts()),
            tuple(fn.launches for fn in _generic_counts()))


def _attn_line(what, row, label):
    dtype = torch.bfloat16 if row["dtype"] == str(torch.bfloat16) \
        else torch.float32
    errs = (" ".join(f"{n} {e:.2e}" for n, e in row["rel_errs"].items())
            + "; two runs bitwise equal") if "rel_errs" in row else \
        f"lse err {row['lse_err']:.2e}"
    print(f"# {what} {row['dtype']} BH={row['bh']} hd={row['hd']} "
          f"grid={row['grid'][0]}x{row['grid'][1]}: max_abs_err "
          f"{row['max_abs_err']:.3e} ({errs}) kernel_ms {row['ms']:.4f} "
          f"({_rate(row)}) plain_ms {row['plain_ms']:.4f} library_ms(sdpa"
          f"{' bwd' if 'rel_errs' in row else ''}+bias) "
          f"{row['library_ms']:.4f} sdpa_nobias_ms(not the same function) "
          f"{row['sdpa_nobias_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
          f"({_bound_note(row, dtype)}) [{label}]")


def _generic_profile(fn, what):
    """K1g's (``what`` "fwd") or K2g's ("bwd") kernels in one profiled call
    of ``fn``: every attention forward (backward) kernel that ran is one of
    theirs -- no K1 (K2) kernel -- and each of them ran. Returns their
    device ms."""
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    names = GENERIC_ATTN_KERNELS[what]
    by_kernel = device_ms_by_kernel(fn, 1, [n.split("::")[1]
                                            for n in names])
    check(by_kernel and all(any(n in k for n in names) for k in by_kernel)
          and all(any(n in k for k in by_kernel) for n in names),
          f"the timed {what} launches ran {sorted(by_kernel)}, not {names}")
    return sum(by_kernel.values())


def generic_full_case(bh, d, grid, backward, dtype, seed, label):
    """K1g (and K2g) at a full-size shape, called directly: against the
    plain versions (max abs error over max |plain| within K1_TOL /
    K2_TOL), K2g twice bitwise, each profiled to be the tensor-core kernels
    and timed in turns (A B .. B A) with SDPA on the same inputs (the bias
    a materialized attn_mask; in the backward a grad-requiring one), K2g
    at 80x40 also with K2. Returns the rows."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    big = dtype == torch.float32 or grid[0] * grid[1] > 4000
    iters = 2 if big else 5
    fwd = k1_case(bh, grid, dtype, seed, iters, d=d,
                  fn=fr.flash_attention_relpos_generic)
    check(fwd["rel_err"] <= K1_TOL[dtype],
          f"K1g {dtype} {bh}x{grid} hd {d}: err / max|plain| "
          f"{fwd['rel_err']} (tol {K1_TOL[dtype]})")
    rows = [("K1g", fwd)]
    if backward:
        rows.append(("K2g", k2_case(bh, grid, dtype, seed + 1, iters, d=d,
                                    fn=fr.flash_attention_relpos_bwd_generic)))
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    length = grid[0] * grid[1]

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, dout = (rnd(bh, length, d) for _ in range(4))
    rel_h, rel_w = rnd(bh, length, grid[0]), rnd(bh, length, grid[1])
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length)
    fargs = (q, k, v, rel_h, rel_w, grid, scale)
    fwd["device_ms"] = _generic_profile(
        lambda: fr.flash_attention_relpos_generic(*fargs), "fwd")
    fwd["turns_ms"] = turns(
        {"K1g": lambda: fr.flash_attention_relpos_generic(*fargs),
         "SDPA": lambda: sdpa(q, k, v, attn_mask=bias, scale=scale)},
        {"K1g": iters, "SDPA": iters})
    print(f"# K1g {dtype} BH={bh} hd={d} grid={grid[0]}x{grid[1]} called "
          f"directly, in turns K1g SDPA SDPA K1g: K1g "
          f"{', '.join(f'{x:.4f}' for x in fwd['turns_ms']['K1g'])} ms "
          f"(device {fwd['device_ms']:.4f}), SDPA+bias "
          f"{', '.join(f'{x:.4f}' for x in fwd['turns_ms']['SDPA'])} ms; "
          f"err / max|plain| {fwd['rel_err']:.2e}; bound "
          f"{fwd['bound_ms']:.4f} ms ({_bound_note(fwd, dtype)}) [{label}]")
    if backward:
        bwd = rows[1][1]
        out, lse = fr.flash_attention_relpos_reference(*fargs)
        bargs = (q, k, v, rel_h, rel_w, out, lse, dout, grid, scale)
        bwd["device_ms"] = _generic_profile(
            lambda: fr.flash_attention_relpos_bwd_generic(*bargs), "bwd")
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        mask = bias.detach().requires_grad_()
        sdpa_out = sdpa(*leaves, attn_mask=mask, scale=scale)
        fns = {"K2g": lambda: fr.flash_attention_relpos_bwd_generic(*bargs),
               "SDPA": lambda: torch.autograd.grad(
                   sdpa_out, leaves + [mask], dout, retain_graph=True)}
        if grid == GENERIC_MAIN_SHAPE[2]:
            check(fr.attention_route(d, grid, length, dtype, True) == "vitl",
                  f"{grid} is not K2's")
            fns["K2"] = lambda: fr.flash_attention_relpos_bwd(*bargs)
        bwd["turns_ms"] = turns(fns, {n: iters for n in fns})
        del sdpa_out, leaves, mask
        print(f"# K2g {dtype} BH={bh} hd={d} grid={grid[0]}x{grid[1]}"
              f"{' called directly' if 'K2' in fns else ''}, in turns "
              f"{' '.join(fns)} {' '.join(list(fns)[::-1])}: "
              + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in ts)} ms"
                          for n, ts in bwd["turns_ms"].items())
              + f" (K2g device {bwd['device_ms']:.4f}); err / max|plain| "
              f"{max(bwd['rel_errs'].values()):.2e}, two runs bitwise "
              f"equal; bound {bwd['bound_ms']:.4f} ms "
              f"({_bound_note(bwd, dtype)}) [{label}]")
    del bias
    torch.cuda.empty_cache()
    return rows


def phase_generic_attention(label):
    """K1g / K2g against their plain versions at every shape of
    GENERIC_ATTN_SHAPES (each routed to them by ``attention_route``) and,
    called directly, at GENERIC_FULL_SHAPES, in bf16 and fp32; K2g twice,
    bitwise."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    rows = []
    for i, (bh, d, grid) in enumerate(GENERIC_ATTN_SHAPES):
        for dtype in FP32:
            length = grid[0] * grid[1]
            check(fr.attention_route(d, grid, length, dtype) == "generic"
                  and fr.attention_route(d, grid, length, dtype,
                                         backward=True) == "generic",
                  f"hd {d} grid {grid} is not routed to K1g / K2g")
            before = _read_counts()
            fwd = k1_case(bh, grid, dtype, seed=300 + i, iters=5, d=d)
            bwd = k2_case(bh, grid, dtype, seed=400 + i, iters=5, d=d)
            after = _read_counts()
            check(after[0] == before[0] and after[1][0] > before[1][0]
                  and after[1][1] > before[1][1],
                  f"hd {d} grid {grid}: launches {before} -> {after}")
            check(fwd["rel_err"] <= K1_TOL[dtype],
                  f"K1g {dtype} hd {d} grid {grid}: err / max|plain| "
                  f"{fwd['rel_err']}")
            _attn_line("K1g", fwd, label)
            _attn_line("K2g", bwd, label)
            rows += [("K1g", fwd), ("K2g", bwd)]
    for i, (bh, d, grid, backward) in enumerate(GENERIC_FULL_SHAPES):
        for dtype in FP32:
            before = _read_counts()
            full = generic_full_case(bh, d, grid, backward, dtype,
                                     500 + 10 * i, label)
            after = _read_counts()
            check(after[1][0] > before[1][0]
                  and (after[1][1] > before[1][1]) == backward,
                  f"K1g / K2g at {grid}: launches {before} -> {after}")
            for kind, row in full:
                _attn_line(f"{kind} (full size, called directly)", row,
                           label)
            rows += full
    return rows


def phase_generic_tail(label):
    """K3g / K4g against their plain versions at GENERIC_TAIL_SHAPES, in
    bf16 and fp32, both GELU flavours (the tanh one at
    GENERIC_TAIL_BIG_SHAPES); each twice, bitwise; each on the route
    ``generic_tail_route`` names (its launches counted); at NARROW_TIMED
    in turns with the stock tail, with the device ms per launch of each
    narrow kernel. Then K3g / K4g's device time per launch at
    GENERIC_TAIL_BIG in bf16 (the packing, the kernels and the wrapper's
    partial sums)."""
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for i, (shape, c) in enumerate(GENERIC_TAIL_SHAPES):
        check(dh.decoder_route(c, torch.bfloat16) == "generic",
              f"C={c} is not routed to K3g / K4g")
        big = (shape, c) in GENERIC_TAIL_BIG_SHAPES
        for dtype in FP32:
            route = dh.generic_tail_route(c, dtype)
            timed_narrow = (shape, c) in NARROW_TIMED
            for approx in (True,) if big else (True, False):
                _zero_counts()
                iters = (20 if (shape, c) == GENERIC_TAIL_MAIN else
                         (10 if dtype == torch.bfloat16 else 2) if big
                         else 5)
                r = tail_case(shape, dtype, approx, seed=600 + i,
                              iters=iters, c=c, generic=True,
                              stock_turns=timed_narrow and approx)
                narrow, tc = _read_counts()[1][2:4], _read_tc_counts()
                check(min(tc if route == "tc" else narrow) > 0
                      and max(narrow if route == "tc" else tc) == 0,
                      f"C={c} {dtype}: route {route}, launches narrow "
                      f"{narrow} tensor-core {tc}")
                r["K3"]["route"] = r["K4"]["route"] = route
                if timed_narrow and approx:
                    _narrow_line(shape, c, dtype, r, label)
                rows.append(r)
                k4e = " ".join(f"{n} {e:.1e}"
                               for n, e in r["K4"]["rel_errs"].items())
                for name in ("K3g", "K4g"):
                    x = r[name[:2]]
                    print(f"# {name} {x['dtype']} {shape} C={c} "
                          f"{'tanh' if approx else 'erf'} ({route} route): "
                          f"err/max|plain| {x['rel_err']:.2e}"
                          + (f" ({k4e})" if name == "K4g" else "")
                          + " (two runs bitwise equal)"
                          + f" kernel_ms {x['ms']:.4f} ({_rate(x)}) "
                          f"device_ms {_opt(x['device_ms'])} plain_ms "
                          f"{x['plain_ms']:.4f} library_ms(stock tail "
                          f"{'fwd' if name == 'K3g' else 'bwd'}, TF32 off) "
                          f"{x['library_ms']:.4f} bound_ms "
                          f"{x['bound_ms']:.4f} ({_bound_note(x, dtype)})"
                          + (f"; in turns with the stock tail kernel "
                             f"{_ms_list(x['turns']['kernel'])} stock "
                             f"{_ms_list(x['turns']['stock'])}"
                             if "turns" in x else "")
                          + f" [{label}]")
    # the packing launch against its plain version: bf16, and fp32 with
    # W1 split into tf32 parts
    for c, dtype in ((5, torch.bfloat16), (40, torch.bfloat16),
                     (264, torch.bfloat16), (13, torch.float32),
                     (64, torch.float32), (264, torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(680 + c)
        params = _tail_params(c, g)
        cd = -(-c // dh.TC_STEP) * dh.TC_STEP
        packed = dh._pack(torch.empty(1, 1, 1, c, device="cuda",
                                      dtype=dtype), *params, cd)
        check(torch.equal(packed, dh.pack_reference(*params, cd, dtype)),
              f"the packing launch at C={c} {dtype} differs from its plain "
              f"version")
    print(f"# K3g / K4g packing launch at C 5, 40, 264 bf16 and 13, 64, 264 "
          f"fp32 (W1 split into tf32 parts): bitwise equal to its plain "
          f"version [{label}]")
    shape, c = GENERIC_TAIL_BIG
    g = torch.Generator(device="cuda").manual_seed(690)
    pix = torch.randn(*shape, c, generator=g, device="cuda").to(
        torch.bfloat16)
    params = _tail_params(c, g)
    go = torch.randn(*shape, 3, generator=g, device="cuda").to(
        torch.bfloat16)
    for what, fn, names in (
            ("K3g", lambda: dh.fused_decoder_tail_generic(pix, *params, True),
             dh.GENERIC_KERNEL_NAMES),
            ("K4g", lambda: dh.fused_decoder_tail_bwd_generic(
                pix, *params[:5], go, True),
             dh.GENERIC_KERNEL_NAMES + ("reduce_kernel",))):
        split = device_ms_by_kernel(fn, 10, names)
        print(f"# {what} bf16 {shape} C={c} tanh, device ms per launch: "
              + "; ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f" (sum {sum(split.values()):.4f}) [{label}]")
    del pix, go, params
    for shape, c in TF32_TAIL_SHAPES:
        shift = _tf32_tail_shift(shape, c)
        print(f"# plain fp32 tail {shape} C={c}: cuDNN TF32 on moves it "
              f"{shift:.3e} of max|plain| (K3_TOL "
              f"{K3_TOL[torch.float32]}; this phase runs with it off) "
              f"[{label}]")
        check(shift > K3_TOL[torch.float32],
              f"TF32 moved the plain tail only {shift} at {shape} C={c}")
    return rows


def _narrow_line(shape, c, dtype, r, label):
    """K3g / K4g's times in turns with the stock tail and their device ms
    per launch of each narrow kernel (tanh), from tail_case's rows ``r``;
    checks that only narrow kernels ran."""
    for name in ("K3", "K4"):
        x = r[name]
        check(x["split"] and all(k.startswith("narrow::")
                                 for k in x["split"]),
              f"narrow {name}g {dtype} {shape}: kernels {sorted(x['split'])}")
        print(f"# {name}g {dtype} {shape} C={c} tanh (narrow route), in "
              f"turns with the stock tail (TF32 off): kernel "
              f"{_ms_list(x['turns']['kernel'])} stock "
              f"{_ms_list(x['turns']['stock'])} ms; device ms per launch "
              + "; ".join(f"{k} {v:.4f}" for k, v in x["split"].items())
              + f" (sum {x['device_ms']:.4f}); bound {x['bound_ms']:.6f} ms "
              f"({_bound_note(x, dtype)}) [{label}]")


def _tail_params(c, g):
    """Seeded fp32 decoder-tail parameters of width ``c`` (conv1 weight,
    conv1 bias, LN scale, LN bias, conv2 weight, conv2 bias) on the card,
    scaled as ``tail_case``'s."""
    return (torch.randn(c, c, 3, 3, generator=g, device="cuda")
            * (9 * c) ** -0.5,
            *(torch.randn(c, generator=g, device="cuda") * 0.1 + s
              for s in (0.0, 1.0, 0.0)),
            torch.randn(3, c, 1, 1, generator=g, device="cuda") * c ** -0.5,
            torch.randn(3, generator=g, device="cuda") * 0.1)


# fp32 tails at which the plain version is read with cuDNN's TF32 on and
# off: the conv3x3 in TF32 alone moves it past K3_TOL
TF32_TAIL_SHAPES = (((2, 37, 29), 40), ((2, 64, 32), 160))


def _tf32_tail_shift(shape, c):
    """max |plain(TF32 on) - plain(TF32 off)| / max |plain(TF32 off)| of
    the fp32 tail's plain version on one seeded input; leaves TF32 off."""
    from painter_tpu_torch.kernels import decoder_head as dh
    g = torch.Generator(device="cuda").manual_seed(650)
    pix = torch.randn(*shape, c, generator=g, device="cuda")
    params = _tail_params(c, g)
    outs = []
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        outs.append(dh.fused_decoder_tail_reference(pix, *params, True))
    return ((outs[0] - outs[1]).abs().max()
            / outs[1].abs().max()).item()


def phase_tiny_serving(label):
    """tiny_test (hd 16 on its 8x4 grid, decoder width 8) and its windowed
    variant (2x2 windows) through ``InContextModel`` with the default
    ``attn_impl="kernel"`` in bf16 and fp32, ``run_queries`` and
    ``run_queries_shared``, against the same model with plain attention;
    K1g launched, K1 not. Returns K1g's launches."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    total = 0
    for name, kw in (("global", {}), ("windowed", TINY_WINDOWED)):
        for dtype in ("bfloat16", "float32"):
            cfg = configs.get_config(TINY, dtype=dtype, **kw)
            model = _seeded_model(cfg, 11)
            res = cfg.img_size[1]
            rng = np.random.RandomState(12)
            img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
            queries = [rng.rand(res, res, 3) for _ in range(3)]
            imgs, tgts = engine.build_query_batch(queries, img2, tgt2)
            outs = {}
            for impl in ("plain", "kernel"):
                eng = engine.InContextModel(cfg, model, attn_impl=impl,
                                            device="cuda")
                _zero_counts()
                outs[impl] = (eng.run_queries(imgs, tgts, real_count=3),
                              eng.run_queries_shared(np.stack(queries),
                                                     img2, tgt2))
                vitl, gen = _read_counts()
                if impl == "kernel":
                    total += gen[0]
                    check(gen[0] == 2 * cfg.depth and vitl == (0,) * 5
                          and gen[1:] == (0,) * 4,
                          f"tiny {name} {dtype}: launches {vitl} {gen}")
                else:
                    check(gen == (0,) * 5 and vitl == (0,) * 5,
                          f"plain attention launched {vitl} {gen}")
            tol = FWD_BF16_TOL if dtype == "bfloat16" else FWD_FP32_TOL
            errs = []
            for got, ref in zip(outs["kernel"], outs["plain"]):
                check(got.shape == ref.shape == (3, res, res, 3)
                      and np.isfinite(got).all(),
                      f"tiny {name} {dtype}: {got.shape} / {ref.shape}")
                errs.append(float(np.abs(got - ref).max()))
            print(f"# tiny_test {name} {dtype} serving (K1g {2 * cfg.depth} "
                  f"launches, one forward per call): run_queries / "
                  f"run_queries_shared max abs vs plain attention "
                  f"{errs[0]:.3e} / {errs[1]:.3e} (tol {tol}) [{label}]")
            check(max(errs) <= tol, f"tiny {name} {dtype}: {errs}")
            del model
    return total


def _changing_updates(step_lib, changed):
    """Wrap ``step_lib.make_train_step`` (the trainer's step module):
    after each update, append how many parameter tensors differ from
    before it. Returns the real function, to restore."""
    real = step_lib.make_train_step

    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(model, batch, gen):
            before = [p.detach().clone() for p in model.parameters()]
            out = step(model, batch, gen)
            changed.append(sum(not torch.equal(a, p.detach())
                               for a, p in zip(before, model.parameters())))
            del before
            return out
        return run
    step_lib.make_train_step = make_train_step
    return real


def _train_main(label, what, model, input_size, dtype, batch, accum,
                updates, val_batches, extra=()):
    """``train.main`` on a synthetic dataset (``_write_dataset``) with the
    fused tail; returns (launches (K1-K4, K1g-K4g), losses, changed
    parameter tensors per update, depth)."""
    import os
    import tempfile
    from painter_tpu_torch import configs
    from painter_tpu_torch.train import step as step_lib
    from painter_tpu_torch.train import train
    tmp = tempfile.TemporaryDirectory()
    data = os.path.join(tmp.name, "data")
    os.makedirs(data)
    pairs = _write_dataset(data)
    out = os.path.join(tmp.name, "run")
    cfg = configs.get_config(model, img_size=input_size)
    length = cfg.num_patches
    args = train.get_args_parser().parse_args([
        "--data_path", data, "--json_path", pairs, "--val_json_path", pairs,
        "--output_dir", out, "--model", model, "--dtype", dtype,
        "--input_size", *map(str, input_size),
        "--num_mask_patches", str(length // 2),
        "--max_mask_patches_per_block", str(length // 4),
        "--min_mask_patches_per_block", str(min(16, length // 8)),
        "--batch_size", str(batch), "--accum_iter", str(accum),
        "--epochs", "1", "--max_steps_per_epoch", str(updates),
        "--warmup_epochs", "0", "--remat_policy", "save_kernel",
        "--decoder_impl", "fused", "--print_freq", "1", *extra])
    changed = []
    real = _changing_updates(step_lib, changed)
    _zero_counts()
    try:
        result = train.main(args)
    finally:
        step_lib.make_train_step = real
    counts = _read_counts()
    with open(os.path.join(out, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    with open(os.path.join(out, "log.txt")) as f:
        stats = json.loads(f.readline())
    n_params = sum(1 for _ in result["model"].parameters())
    losses = [s["loss"] for s in scalars]
    check(result["step"] == updates, f"{what}: {result['step']} updates")
    check(len(losses) == updates and all(np.isfinite(losses))
          and all(np.isfinite(s["grad_norm"]) for s in scalars)
          and np.isfinite(stats["val_loss"]),
          f"{what}: non-finite loss or grad_norm {scalars} {stats}")
    check(len(changed) == updates and all(changed),
          f"{what}: parameter tensors changed per update {changed}")
    print(f"# {what}: {updates} updates (b{batch} x accum {accum}), losses "
          f"{[round(x, 5) for x in losses]}, val loss "
          f"{stats['val_loss']:.5f}, parameter tensors changed per update "
          f"{changed} of {n_params}; launches K1-K5 {counts[0]}, "
          f"K1g-K5g {counts[1]} [{label}]")
    depth = result["model"].cfg.depth
    del result
    tmp.cleanup()
    torch.cuda.empty_cache()
    return counts, losses, changed, depth


def phase_tiny_train(label):
    """tiny_test trains through ``train.main --model tiny_test
    --decoder_impl fused`` (bf16, b2 x accum 2, 3 updates, validation):
    K1g / K2g / K3g / K4g counted, no ViT-L kernel; then one fused-tail
    micro-step of the windowed variant (K2g at 2x2 windows, kw 2)."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    updates, accum, val = 3, 2, 3
    counts, _, _, depth = _train_main(
        label, "train.main --model tiny_test", TINY, (64, 32), "bfloat16",
        2, accum, updates, val)
    micro = updates * accum
    check(counts[0] == (0,) * 5 and counts[1] == (
        depth * (micro + val), depth * micro, micro, micro, 0),
        f"tiny_test training launched {counts}")
    cfg = configs.get_config(TINY, dtype="bfloat16", **TINY_WINDOWED)
    model = _seeded_model(cfg, 13).train()
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=1))
    step = step_lib.make_train_step(cfg, opt, accum_iter=1,
                                    decoder_impl="fused")
    before = [p.detach().clone() for p in model.parameters()]
    _zero_counts()
    m = step(model, _train_batch(cfg, 2, seed=14),
             torch.Generator(device="cuda").manual_seed(15))
    win = _read_counts()
    loss = float(m["loss"])
    changed = sum(not torch.equal(a, p.detach())
                  for a, p in zip(before, model.parameters()))
    print(f"# tiny_test windowed (2x2 windows in blocks "
          f"{TINY_WINDOWED['window_block_indexes']}), one fused-tail "
          f"micro-step: loss {loss:.5f}, {changed} parameter tensors "
          f"changed, launches K1-K5 {win[0]}, K1g-K5g {win[1]} [{label}]")
    check(np.isfinite(loss) and changed > 0, f"windowed step {loss}")
    check(win[0] == (0,) * 5 and win[1] == (depth, depth, 1, 1, 0),
          f"windowed tiny_test step launched {win}")
    return tuple(a + b for a, b in zip(counts[1][:4], win[1][:4]))


# tiny_test's quantized configs: bf16 (tanh GELU), fp32 with the tanh GELU
# (K5g), fp32 with the default exact GELU (the unfused path, as JAX)
TINY_INT8_CONFIGS = (("bfloat16", "auto"), ("float32", "tanh"),
                     ("float32", "auto"))
# int8-fused vs int8 at tiny_test, relative Frobenius, per config. bf16:
# the unfused path rounds the hidden activation through bf16 and K5g keeps
# it in fp32, ~8e-4 apart; fp32 tanh: the same arithmetic but for where
# each rounds, ~5e-8; fp32 exact GELU: both run the unfused path, equal
TINY_FUSED_VS_INT8 = {("bfloat16", "auto"): 5e-3,
                      ("float32", "tanh"): 1e-6,
                      ("float32", "auto"): 0.0}


def phase_tiny_int8_serving(label):
    """tiny_test (K 32, N 128: K5g's shapes) served through
    ``InContextModel`` at quant "int8" and "int8-fused" in each of
    TINY_INT8_CONFIGS, through run_queries, run_queries_shared and
    run_one_image, each against the unquantized output at INT8_REL_FRO
    and int8-fused against int8 at TINY_FUSED_VS_INT8; K5g launched once
    per block per fused tanh-GELU forward, K5 never. Returns K5g's
    launches."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    # TF32 off, as the fp32 bounds assume: a TF32 convolution in the
    # decoder rounds the paths' ulp-level differences to TF32 steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = 0
    for dtype, gelu in TINY_INT8_CONFIGS:
        cfg = configs.get_config(TINY, dtype=dtype, gelu=gelu)
        model = _seeded_model(cfg, 41)
        res = cfg.img_size[1]
        rng = np.random.RandomState(42)
        img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
        queries = [rng.rand(res, res, 3) for _ in range(3)]
        imgs, tgts = engine.build_query_batch(queries, img2, tgt2)
        img1, tgt1 = engine.build_prompt_batch(queries[0], [(img2, tgt2)])

        def serve(eng):
            return (eng.run_queries(imgs, tgts, real_count=3),
                    eng.run_queries_shared(np.stack(queries), img2, tgt2),
                    eng.run_one_image(img1, tgt1))

        ref = serve(engine.InContextModel(cfg, model, device="cuda"))
        by_quant = {}
        for quant in ("int8", "int8-fused"):
            eng = engine.InContextModel(cfg, model, device="cuda",
                                        quant=quant)
            _zero_counts()
            outs = serve(eng)
            k5n, k5g = (c[4] for c in _read_counts())
            fused = quant == "int8-fused" and cfg.gelu_approximate
            want = 3 * cfg.depth if fused else 0
            devs = [_rel_fro(o, r) for o, r in zip(outs, ref)]
            print(f"# tiny_test {dtype} gelu={gelu} --quant {quant}: K5g "
                  f"launches {k5g} (expected {want}), K5 {k5n}; relative "
                  f"Frobenius vs unquantized run_queries / "
                  f"run_queries_shared / run_one_image "
                  f"{' / '.join(f'{d:.4e}' for d in devs)} (bound "
                  f"{INT8_REL_FRO}) [{label}]")
            check(k5g == want and k5n == 0,
                  f"tiny {dtype} {gelu} {quant}: K5 {k5n}, K5g {k5g}")
            for o, r in zip(outs, ref):
                check(o.shape == r.shape and np.isfinite(o).all(),
                      f"tiny {dtype} {gelu} {quant}: {o.shape}")
            check(max(devs) <= INT8_REL_FRO,
                  f"tiny {dtype} {gelu} {quant} deviates {devs}")
            by_quant[quant] = outs
            total += k5g
        devs = [_rel_fro(a, b) for a, b in zip(by_quant["int8-fused"],
                                               by_quant["int8"])]
        bound = TINY_FUSED_VS_INT8[dtype, gelu]
        print(f"# tiny_test {dtype} gelu={gelu} int8-fused vs int8: relative "
              f"Frobenius run_queries / run_queries_shared / run_one_image "
              f"{' / '.join(f'{d:.4e}' for d in devs)} (bound {bound}) "
              f"[{label}]")
        check(max(devs) <= bound,
              f"tiny {dtype} {gelu} int8-fused deviates {devs} from int8")
        del model
    return total


def phase_cli_tiny(label):
    """``seggpt_cli.main(["--model", "tiny_test", "--quant",
    "int8-fused", ...])`` on the card with no checkpoint (bf16, random
    weights from seed 0): K5g once per block, K5 never. Returns K5g's
    launches."""
    import os
    import tempfile
    from PIL import Image
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import seggpt_cli
    depth = configs.get_config(TINY).depth
    with tempfile.TemporaryDirectory() as root:
        query, p1, t1 = _write_pngs(root, ["query", "p1", "t1"], (48, 80),
                                    seed=43)
        out_dir = os.path.join(root, "out")
        _zero_counts()
        seggpt_cli.main(["--model", TINY, "--input_image", query,
                         "--prompt_image", p1, "--prompt_target", t1,
                         "--output_dir", out_dir, "--quant", "int8-fused"])
        k5n, k5g = (c[4] for c in _read_counts())
        out = os.path.join(out_dir, "output_query.png")
        check(os.path.exists(out), f"CLI tiny_test wrote no {out}")
        png = Image.open(out)
        print(f"# seggpt_cli --model tiny_test --quant int8-fused: K5g "
              f"launches {k5g} (expected {depth}), K5 {k5n}; "
              f"output_query.png {png.size} {png.mode} [{label}]")
        check(png.size == (80, 48) and png.mode == "RGB",
              f"CLI tiny_test output {png.size} {png.mode}")
        check(k5g == depth and k5n == 0, f"CLI tiny_test: K5 {k5n}, K5g "
              f"{k5g}")
    return k5g


# a decoder past 128 channels (K3g / K4g's tensor-core route in bf16)
WIDE_DECODER = 160
# Painter ViT-L 896x448 with a 256-channel decoder (the widest whole-rows
# width of the tensor-core route)
WIDE_VITL_DECODER = 256
# Painter ViT-L 896x448 with an 8-channel decoder: the narrow route at a
# full 896x448 pixel count
NARROW_VITL_DECODER = 8


def _vitl_decoder_model(width, seed):
    """(cfg, seeded bf16 model in train mode) of Painter ViT-L 896x448 with
    ``decoder_embed_dim`` ``width`` (the preset widened by a
    ``functools.partial`` for the call, restored after it)."""
    from painter_tpu_torch import configs
    real = configs.PRESETS[PAINTER]
    configs.PRESETS[PAINTER] = functools.partial(real,
                                                 decoder_embed_dim=width)
    try:
        cfg = configs.get_config(PAINTER, dtype="bfloat16")
        check(cfg.decoder_embed_dim == width,
              f"decoder width {cfg.decoder_embed_dim}")
        return cfg, _seeded_model(cfg, seed).train()
    finally:
        configs.PRESETS[PAINTER] = real


def phase_tiny_wide_decoder(label):
    """tiny_test with ``decoder_embed_dim`` 160 trains through
    ``train.main --model tiny_test --decoder_impl fused`` (the preset
    widened for the call): K3g / K4g on the tensor-core route once per
    micro-batch, no ViT-L kernel and no narrow K3g / K4g; each loss finite,
    each update changes the parameters. Returns (K3g, K4g) launches."""
    import functools
    from painter_tpu_torch import configs
    updates, accum, val = 2, 2, 2
    real = configs.PRESETS[TINY]
    configs.PRESETS[TINY] = functools.partial(
        real, decoder_embed_dim=WIDE_DECODER)
    try:
        counts, _, _, depth = _train_main(
            label, f"train.main --model tiny_test (decoder_embed_dim "
            f"{WIDE_DECODER})", TINY, (64, 32), "bfloat16", 2, accum,
            updates, val)
        tc = _read_tc_counts()
    finally:
        configs.PRESETS[TINY] = real
    micro = updates * accum
    check(counts[0] == (0,) * 5 and counts[1] == (
        depth * (micro + val), depth * micro, 0, 0, 0)
        and tc == (micro, micro),
        f"tiny_test (decoder {WIDE_DECODER}) training launched {counts}, "
        f"tensor-core K3g / K4g {tc}")
    return tc


def phase_vitl_wide_decoder(label):
    """Painter ViT-L 896x448 with ``decoder_embed_dim`` 256 (the preset
    widened for the call, as phase_tiny_wide_decoder widens tiny_test)
    trains through ``train.main --decoder_impl fused`` (bf16, b1 x accum 2,
    2 updates, validation): K1 / K2 on every block, K3g / K4g on the
    tensor-core route once per micro-batch, no K3 / K4 and no K1g / K2g;
    each loss finite, each update changes the parameters. Then the ms per
    update on a device-resident batch (median of 3 after a warm-up) and
    K3g / K4g's device time in one profiled update. Returns ((K3g, K4g)
    launches, ms per update, K3g / K4g device ms per update)."""
    import functools
    from painter_tpu_torch import configs
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    updates, accum, val = 2, 2, 2
    real = configs.PRESETS[PAINTER]
    configs.PRESETS[PAINTER] = functools.partial(
        real, decoder_embed_dim=WIDE_VITL_DECODER)
    try:
        t0 = time.perf_counter()
        counts, _, _, depth = _train_main(
            label, f"train.main Painter ViT-L 896x448 (decoder_embed_dim "
            f"{WIDE_VITL_DECODER})", PAINTER, (896, 448), "bfloat16", 1,
            accum, updates, val)
        tc = _read_tc_counts()
        micro = updates * accum
        check(counts[0] == (depth * (micro + val), depth * micro, 0, 0, 0)
              and counts[1] == (0,) * 5 and tc == (micro, micro),
              f"ViT-L wide-decoder training launched {counts}, "
              f"tensor-core K3g / K4g {tc}")
        print(f"# ViT-L 896x448 decoder {WIDE_VITL_DECODER} training drive: "
              f"{time.perf_counter() - t0:.1f} s with model build, data "
              f"workers and validation")
    finally:
        configs.PRESETS[PAINTER] = real
    cfg, model = _vitl_decoder_model(WIDE_VITL_DECODER, 41)
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=10))
    step = step_lib.make_train_step(cfg, opt, accum_iter=accum,
                                    decoder_impl="fused")
    batch = _train_batch(cfg, 1, seed=42, accum=accum)
    gen = torch.Generator(device="cuda").manual_seed(43)
    _timed_updates(step, model, batch, gen, 1)
    times = _timed_updates(step, model, batch, gen, 3)
    by_kernel = device_ms_by_kernel(lambda: step(model, batch, gen), 1,
                                    dh.TC_KERNEL_NAMES)
    tail_ms = sum(by_kernel.values())
    ms = 1e3 * statistics.median(times)
    print(f"# ViT-L 896x448 decoder {WIDE_VITL_DECODER} update (b1 x accum "
          f"{accum}, bf16, save_kernel, fused tail): {ms:.2f} ms median of "
          f"{[round(1e3 * x, 2) for x in times]}; K3g / K4g device time in "
          f"one update {tail_ms:.3f} ms ({100 * tail_ms / ms:.2f}% of the "
          f"update; {', '.join(f'{k} {v:.3f}' for k, v in by_kernel.items())}"
          f"; {accum} calls each) [{label}]")
    del model, opt
    torch.cuda.empty_cache()
    return tc, ms, tail_ms


def phase_vitl_narrow_decoder(label):
    """Painter ViT-L 896x448 with ``decoder_embed_dim`` 8 (K3g / K4g on the
    narrow route at (1, 896, 448, 8) once per micro-batch), bf16, b1 x
    accum 2, save_kernel, on a device-resident batch: one update with the
    fused tail and one with ``decoder_impl="auto"`` (the stock tail), each
    loss finite and the launches checked -- fused: K1 / K2 on every block,
    narrow K3g / K4g once per micro-batch, no K3 / K4 / K1g / K2g / K5 /
    K5g and no tensor-core tail; auto: no K3g / K4g. Then the ms per update,
    median of 3, in turns (fused, auto, auto, fused) and K3g / K4g's device
    time in one profiled fused update. ``train.main`` drives the route with
    tiny_test (phase_tiny_train). Returns ((K3g, K4g) launches of the
    checked fused update, {impl: [ms per round]}, K3g / K4g device ms)."""
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    accum = 2
    check(((1, 896, 448), NARROW_VITL_DECODER) in GENERIC_TAIL_SHAPES,
          "phase_generic_tail does not hold the narrow kernels at this "
          "update's shape")
    cfg, model = _vitl_decoder_model(NARROW_VITL_DECODER, 51)
    check(dh.generic_tail_route(NARROW_VITL_DECODER, torch.bfloat16)
          == "narrow", "the 8-channel decoder is not on the narrow route")
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=10))
    steps = {impl: step_lib.make_train_step(cfg, opt, accum_iter=accum,
                                            decoder_impl=impl)
             for impl in ("fused", "auto")}
    batch = _train_batch(cfg, 1, seed=52, accum=accum)
    gen = torch.Generator(device="cuda").manual_seed(53)
    depth = cfg.depth
    want = {"fused": ((depth * accum, depth * accum, 0, 0, 0),
                      (0, 0, accum, accum, 0)),
            "auto": ((depth * accum, depth * accum, 0, 0, 0), (0,) * 5)}
    for impl, step in steps.items():
        _zero_counts()
        loss = float(step(model, batch, gen)["loss"])
        counts, tc = _read_counts(), _read_tc_counts()
        print(f"# ViT-L 896x448 decoder {NARROW_VITL_DECODER} update "
              f"({impl} tail): loss {loss:.5f}, launches K1-K5 {counts[0]}, "
              f"K1g-K5g {counts[1]}, tensor-core K3g / K4g {tc} [{label}]")
        check(np.isfinite(loss) and counts == want[impl] and tc == (0, 0),
              f"ViT-L decoder {NARROW_VITL_DECODER} {impl} update launched "
              f"{counts}, tensor-core {tc}, loss {loss}")
    times = {"fused": [], "auto": []}
    for impl in ("fused", "auto", "auto", "fused"):
        times[impl].append(1e3 * statistics.median(
            _timed_updates(steps[impl], model, batch, gen, 3)))
    by_kernel = device_ms_by_kernel(lambda: steps["fused"](model, batch, gen),
                                    1, dh.NARROW_KERNEL_NAMES)
    tail_ms = sum(by_kernel.values())
    check(by_kernel and all(k.startswith("narrow::") for k in by_kernel),
          f"the profiled fused update ran {sorted(by_kernel)}")
    ms = statistics.median(times["fused"])
    print(f"# ViT-L 896x448 decoder {NARROW_VITL_DECODER} update (b1 x accum "
          f"{accum}, bf16, save_kernel), ms per update (median of 3) in "
          f"turns fused, auto, auto, fused: fused "
          f"{_ms_list(times['fused'])}, auto {_ms_list(times['auto'])}; "
          f"K3g / K4g device time in one fused update {tail_ms:.4f} ms "
          f"({100 * tail_ms / ms:.3f}% of the update; "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
          + f"; {accum} calls each) [{label}]")
    del model, opt, steps
    torch.cuda.empty_cache()
    return want["fused"][1][2:4], times, tail_ms


# SegGPT ViT-L fp32 tanh, relative Frobenius. int8-fused vs int8: the two
# paths round the same fp32 steps in other places (e.g. the GELU), so a
# hidden value an ulp from a requantization boundary takes another int8
# code, and over 24 blocks the codes that differ spread to the level of
# the quantization error itself (int8 vs none ~4.1e-3); read 3.3286e-03
# (b8) and 3.3262e-03 (b1) on the card (NVIDIA H100 80GB HBM3, 700 W).
# int8-fused vs int8-fused with the fused MLP's plain version in K5's
# place: K5 is bit-equal to it, so the whole forward is too
FP32_FUSED_VS_INT8 = 5e-3
FP32_FUSED_VS_PLAIN = 1e-6


def phase_int8_fp32_serving(label):
    """SegGPT ViT-L 896x448 in fp32 with the tanh GELU (``dtype=
    "float32", gelu="tanh"``), full width and depth, served through
    ``InContextModel`` unquantized, at quant "int8" and "int8-fused": a
    b8 run_queries_shared and a b1 run_one_image each. int8-fused runs
    K5 (K 1024, N 4096, M up to 25088 in fp32) once per block per
    forward, K5g never; each quantized output within INT8_REL_FRO of the
    fp32 one, int8-fused within FP32_FUSED_VS_INT8 of int8 and within
    FP32_FUSED_VS_PLAIN of int8-fused served with ``int8_mlp_reference``
    in K5's place. K1 runs on its fp32 (3xTF32) route once per block per
    forward, K1g never; K1's device ms in one unquantized b8 call.
    Returns (K5 launches, seconds of a b8 call per mode, K1 launches)."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant as quant_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config("seggpt_vit_large_patch16_input896x448",
                             dtype="float32", gelu="tanh")
    model = _seeded_model(cfg, 51)
    res = cfg.img_size[1]
    rng = np.random.RandomState(52)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    queries = (rng.rand(8, res, res, 3) * 255).astype(np.uint8)
    img1, tgt1 = engine.build_prompt_batch(rng.rand(res, res, 3),
                                           [(img2, tgt2)])
    outs, b8_s = {}, {}
    k5_total = k1_total = 0
    for quant in ("none", "int8", "int8-fused"):
        eng = engine.InContextModel(cfg, model, device="cuda", quant=quant)
        _zero_counts()
        outs[quant] = (eng.run_queries_shared(queries, img2, tgt2),
                       eng.run_one_image(img1, tgt1))
        (k1n, k5n), (k1g, k5g) = ((c[0], c[4]) for c in _read_counts())
        want = 2 * cfg.depth if quant == "int8-fused" else 0
        print(f"# SegGPT ViT-L fp32 tanh --quant {quant}: K5 launches "
              f"{k5n} over a b8 run_queries_shared and a b1 run_one_image "
              f"(expected {want}), K5g {k5g}; K1 (fp32, 3xTF32) {k1n} "
              f"(expected {2 * cfg.depth}), K1g {k1g}")
        check(k5n == want and k5g == 0,
              f"fp32 ViT-L {quant}: K5 {k5n}, K5g {k5g}")
        check(k1n == 2 * cfg.depth and k1g == 0,
              f"fp32 ViT-L {quant}: K1 {k1n}, K1g {k1g}")
        k5_total += k5n
        k1_total += k1n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_queries_shared(queries, img2, tgt2)
        b8_s[quant] = time.perf_counter() - t0
        if quant == "none":
            k1_ms = device_ms(lambda: eng.run_queries_shared(
                queries, img2, tgt2), 1, ("tc::fwd_kernel",))
            print(f"# SegGPT ViT-L fp32 b8 run_queries_shared: K1 (fp32, "
                  f"3xTF32) device time {k1_ms:.2f} ms of the "
                  f"{1e3 * b8_s[quant]:.2f} ms call ({cfg.depth} "
                  f"launches) [{label}]")
        del eng
    eng = engine.InContextModel(cfg, model, device="cuda",
                                quant="int8-fused")
    _zero_counts()
    kernel = quant_ops.int8_mlp
    quant_ops.int8_mlp = k5.int8_mlp_reference
    try:
        outs["int8-fused, plain MLP"] = (
            eng.run_queries_shared(queries, img2, tgt2),
            eng.run_one_image(img1, tgt1))
    finally:
        quant_ops.int8_mlp = kernel
    del eng
    check([c[4] for c in _read_counts()] == [0, 0],
          f"int8-fused with the plain MLP launched {_read_counts()}")
    for a, b, bound in (("int8", "none", INT8_REL_FRO),
                        ("int8-fused", "none", INT8_REL_FRO),
                        ("int8-fused", "int8", FP32_FUSED_VS_INT8),
                        ("int8-fused", "int8-fused, plain MLP",
                         FP32_FUSED_VS_PLAIN)):
        devs = [_rel_fro(x, y) for x, y in zip(outs[a], outs[b])]
        print(f"# SegGPT ViT-L fp32 tanh {a} vs {b}: relative Frobenius "
              f"b8 {devs[0]:.4e}, b1 {devs[1]:.4e} (bound {bound}) "
              f"[{label}]")
        for o in outs[a]:
            check(np.isfinite(o).all(), f"fp32 {a}: non-finite values")
        check(max(devs) <= bound, f"fp32 {a} deviates {devs} from {b}")
    print("# SegGPT ViT-L fp32 tanh b8 run_queries_shared (one call after "
          "the checked one, host clock): "
          + ", ".join(f"{q} {s:.3f} s ({8 / s:.3f} pairs/s)"
                      for q, s in b8_s.items()) + f" [{label}]")
    del model
    torch.cuda.empty_cache()
    return k5_total, b8_s, k1_total


# SegGPT at ViT-B/16's widths (Dosovitskiy et al., ICLR 2021, Table 1:
# hidden 768, MLP 3072, 12 heads, 12 layers), its taps ViTDet ViT-B's
# global blocks 2 / 5 / 8 / 11 (detectron2 projects/ViTDet), all blocks
# global at 896x448: head dim 64 on the 56x28 grid keeps the attention on
# K1, and the MLP (768 -> 3072 -> 768) routes to K5g in both types
VITB_WIDTHS = dict(embed_dim=768, depth=12, num_heads=12,
                   out_indices=(2, 5, 8, 11))
# fp32 tanh int8-fused vs int8 on that config, relative Frobenius: the
# two paths round the same fp32 steps in other places, so hidden values an
# ulp from a requantization boundary take other int8 codes. The plain
# versions (int8-fused served with int8_mlp_reference in K5g's place,
# against int8) read 1.8338e-03 (b8) and 1.8298e-03 (b1) on this seed on
# the card (NVIDIA H100 80GB HBM3, 700 W); the bound is 1.5x the larger
VITB_FP32_FUSED_VS_INT8 = 2.75e-3


def phase_int8_vitb_serving(label):
    """SegGPT at ViT-B width (``VITB_WIDTHS``), 896x448, full depth, served
    through ``InContextModel`` unquantized, at quant "int8" and
    "int8-fused" (and int8-fused with ``int8_mlp_reference`` in K5g's
    place): a b8 run_queries_shared and a b1 run_one_image each, in bf16
    and in fp32 with the tanh GELU. int8-fused runs K5g (K 768, N 3072, M
    up to 25088) once per block per forward, K5 never; K1 once per block
    per forward in every mode. bf16: each quantized output and int8-fused
    vs int8 within INT8_REL_FRO. fp32: the quantized outputs within
    INT8_REL_FRO of the fp32 one, int8-fused within
    VITB_FP32_FUSED_VS_INT8 of int8 and within FP32_FUSED_VS_PLAIN of the
    plain-MLP run. The b8 call's time per mode, and K5g's device share of
    the int8-fused b8 call (one profile in bf16). Returns (K5g launches of
    the checked calls, {(dtype, quant): seconds of a b8 call})."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant as quant_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k5g_total, b8_s = 0, {}
    plain = "int8-fused, plain MLP"
    for dtype, gelu, seed in (("bfloat16", "auto", 61),
                              ("float32", "tanh", 63)):
        cfg = configs.get_config("seggpt_vit_large_patch16_input896x448",
                                 dtype=dtype, gelu=gelu, **VITB_WIDTHS)
        hidden = int(cfg.mlp_ratio * cfg.embed_dim)
        check(k5.int8_mlp_route(cfg.embed_dim, hidden, cfg.compute_dtype)
              == "generic", f"ViT-B {dtype}: the MLP is not routed to K5g")
        what = f"SegGPT ViT-B-wide {dtype} {gelu}"
        model = _seeded_model(cfg, seed)
        res = cfg.img_size[1]
        rng = np.random.RandomState(seed + 1)
        img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
        queries = (rng.rand(8, res, res, 3) * 255).astype(np.uint8)
        img1, tgt1 = engine.build_prompt_batch(rng.rand(res, res, 3),
                                               [(img2, tgt2)])
        outs = {}
        modes = ("none", "int8", "int8-fused") + (
            (plain,) if dtype == "float32" else ())
        for quant in modes:
            eng = engine.InContextModel(cfg, model, device="cuda",
                                        quant=quant.split(",")[0])
            _zero_counts()
            kernel = quant_ops.int8_mlp
            if quant == plain:
                quant_ops.int8_mlp = k5.int8_mlp_reference
            try:
                outs[quant] = (eng.run_queries_shared(queries, img2, tgt2),
                               eng.run_one_image(img1, tgt1))
            finally:
                quant_ops.int8_mlp = kernel
            (k1n, k5n), (k1g, k5g) = ((c[0], c[4]) for c in _read_counts())
            want = 2 * cfg.depth if quant == "int8-fused" else 0
            print(f"# {what} --quant {quant}: K5g launches {k5g} over a b8 "
                  f"run_queries_shared and a b1 run_one_image (expected "
                  f"{want}), K5 {k5n}; K1 {k1n} (expected {2 * cfg.depth}),"
                  f" K1g {k1g}")
            check(k5g == want and k5n == 0,
                  f"{what} {quant}: K5g {k5g}, K5 {k5n}")
            check(k1n == 2 * cfg.depth and k1g == 0,
                  f"{what} {quant}: K1 {k1n}, K1g {k1g}")
            k5g_total += k5g
            if quant != plain:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run_queries_shared(queries, img2, tgt2)
                b8_s[(dtype, quant)] = time.perf_counter() - t0
            if quant == "int8-fused":
                call = functools.partial(eng.run_queries_shared, queries,
                                         img2, tgt2)
                k5g_ms = device_ms(call, 1, k5.K5G_KERNEL_NAMES)
                print(f"# {what} int8-fused b8 run_queries_shared: K5g "
                      f"device time {k5g_ms:.2f} ms ({cfg.depth} calls) of "
                      f"the {1e3 * b8_s[(dtype, quant)]:.2f} ms call "
                      f"[{label}]")
                if dtype == "bfloat16":
                    profile_device(call, f"{what} int8-fused b8 "
                                   "run_queries_shared", label)
            del eng
        for a, b, bound in (
                ("int8", "none", INT8_REL_FRO),
                ("int8-fused", "none", INT8_REL_FRO),
                ("int8-fused", "int8", INT8_REL_FRO if dtype == "bfloat16"
                 else VITB_FP32_FUSED_VS_INT8),
                *(((plain, "int8", VITB_FP32_FUSED_VS_INT8),
                   ("int8-fused", plain, FP32_FUSED_VS_PLAIN))
                  if dtype == "float32" else ())):
            devs = [_rel_fro(x, y) for x, y in zip(outs[a], outs[b])]
            print(f"# {what} {a} vs {b}: relative Frobenius b8 "
                  f"{devs[0]:.4e}, b1 {devs[1]:.4e} (bound {bound}) "
                  f"[{label}]")
            for o in outs[a]:
                check(np.isfinite(o).all(), f"{what} {a}: non-finite values")
            check(max(devs) <= bound, f"{what} {a} deviates {devs} from {b}")
        del model, outs
        torch.cuda.empty_cache()
    print("# SegGPT ViT-B-wide b8 run_queries_shared (one call after the "
          "checked one, host clock): "
          + ", ".join(f"{d} {q} {s:.3f} s ({8 / s:.3f} pairs/s)"
                      for (d, q), s in b8_s.items()) + f" [{label}]")
    return k5g_total, b8_s


def phase_grad_check_1280(label):
    """Painter ViT-L at 1280x640, fp32 b1: the loss and every parameter's
    gradient with K1 / K2 (the 80x40 grid) against plain attention, and
    with K3 / K4 against the stock tail, at ``phase_grad_check``'s
    tolerances."""
    from painter_tpu_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(PAINTER, dtype="float32",
                             img_size=PAINTER_1280)
    model = _seeded_model(cfg, 21).train()
    batch = _train_batch(cfg, 1, seed=22)
    _zero_counts()
    _grad_pair(model, batch, "K1/K2 vs plain attention at 1280x640", label,
               True, ("kernel", "xla"), ("plain", "xla"))
    _grad_pair(model, batch, "K3/K4 vs stock tail at 1280x640", label, True,
               ("kernel", "fused"), ("kernel", "xla"))
    vitl, gen = _read_counts()
    print(f"# grad check 1280x640: launches K1-K5 {vitl}, K1g-K5g {gen}")
    check(vitl[1] == 3 * cfg.depth and gen == (0,) * 5
          and vitl[2:] == (1, 1, 0),
          f"1280x640 gradient check launched {vitl} {gen}")
    del model
    torch.cuda.empty_cache()


def phase_train_1280(label):
    """Painter ViT-L at full width trains through ``train.main
    --input_size 1280 640`` (bf16, fused tail, b1 x accum 2, 3 updates,
    validation): K1 on the 80x40 grid, K2 its backward (K2g never), K3 /
    K4 at 1280x640; each loss finite, each update changes the parameters.
    Returns (K1, K2, K3, K4) launches."""
    updates, accum, val = 3, 2, 3
    t0 = time.perf_counter()
    counts, _, _, depth = _train_main(
        label, "train.main Painter ViT-L --input_size 1280 640", PAINTER,
        PAINTER_1280, "bfloat16", 1, accum, updates, val)
    micro = updates * accum
    check(counts[0] == (depth * (micro + val), depth * micro, micro, micro,
                        0) and counts[1] == (0,) * 5,
          f"ViT-L 1280x640 training launched {counts}")
    print(f"# ViT-L 1280x640 training drive: {time.perf_counter() - t0:.1f}"
          f" s with model build, data workers and validation")
    return counts[0][:4]


def train_1280_times(label):
    """ms per update of Painter ViT-L at 1280x640 (bf16, b1 x accum 2,
    save_kernel, fused tail) on a device-resident batch, and K2's share:
    its device time in one profiled update, in which no K2g kernel ran."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    cfg = configs.get_config(PAINTER, dtype="bfloat16",
                             img_size=PAINTER_1280)
    model = _seeded_model(cfg, 31).train()
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=10))
    step = step_lib.make_train_step(cfg, opt, accum_iter=2,
                                    decoder_impl="fused")
    batch = _train_batch(cfg, 1, seed=32, accum=2)
    gen = torch.Generator(device="cuda").manual_seed(33)
    _timed_updates(step, model, batch, gen, 1)
    times = _timed_updates(step, model, batch, gen, 3)
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    # both K2's and K2g's kernels: dq_kernel / dkv_kernel
    by_kernel = device_ms_by_kernel(lambda: step(model, batch, gen), 1,
                                    ("dq_kernel", "dkv_kernel"))
    others = [k for k in by_kernel
              if not any(n in k for n in K2_KERNEL_NAMES)]
    check(not others, f"the 1280x640 update ran K2g's kernels: {others}")
    k2 = sum(by_kernel.values())
    ms = 1e3 * statistics.median(times)
    print(f"# ViT-L 1280x640 update (b1 x accum 2, bf16, save_kernel, fused "
          f"tail): {ms:.2f} ms median of {[round(1e3 * x, 2) for x in times]}"
          f"; K2 device time in one update {k2:.2f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in by_kernel.items())}; "
          f"{2 * cfg.depth} calls; {100 * k2 / ms:.1f}% of the update) "
          f"[{label}]")
    del model, opt
    torch.cuda.empty_cache()
    return ms, k2


# K1's and K2's fp32 (3xTF32) kernels in a profile (csrc/flash_relpos_fwd.cu,
# csrc/flash_relpos_bwd.cu)
F32_KERNEL_NAMES = ("tc::fwd_kernel", "tc::dq_kernel", "tc::dkv_kernel")


def train_1280_fp32_times(label):
    """ms per update of Painter ViT-L at 1280x640 in fp32 (b1 x accum 2,
    save_kernel) on a device-resident batch, with the auto (stock) tail and
    with the fused tail (``decoder_impl="fused"``: K3 / K4 on their fp32
    route, the 3xTF32 kernels of csrc/decoder_tail_tc_*.cu). The warm-up
    update of each launches K1 and K2 once per block per micro-batch on
    their fp32 (3xTF32) route, no K1g-K4g, and K3 / K4 once per
    micro-batch with the fused tail only; then 3 updates of each in turns
    (auto, fused, fused, auto, auto, fused), and K1's, K2's, K3's and K4's
    device ms in one profiled fused update. Returns (auto ms, fused ms, K1
    ms, K2 ms, K1 launches, K2 launches, K3 launches, K4 launches)."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.kernels import decoder_head as dh
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(PAINTER, dtype="float32",
                             img_size=PAINTER_1280)
    model = _seeded_model(cfg, 41).train()
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=10))
    steps = {impl: step_lib.make_train_step(cfg, opt, accum_iter=2,
                                            decoder_impl=impl)
             for impl in ("auto", "fused")}
    batch = _train_batch(cfg, 1, seed=42, accum=2)
    gen = torch.Generator(device="cuda").manual_seed(43)
    counts = {}
    for impl, step in steps.items():
        _zero_counts()
        _timed_updates(step, model, batch, gen, 1)
        counts[impl] = _read_counts() + (_read_tc_counts(),)
        tail = 2 if impl == "fused" else 0
        want = (2 * cfg.depth, 2 * cfg.depth, tail, tail, 0)
        check(counts[impl] == (want, (0,) * 5, (0, 0)),
              f"the fp32 1280x640 update ({impl} tail) launched "
              f"{counts[impl]}, expected {want} and no generic kernel")
    times = {"auto": [], "fused": []}
    for impl in ("auto", "fused", "fused", "auto", "auto", "fused"):
        times[impl] += _timed_updates(steps[impl], model, batch, gen, 1)
    by_kernel = device_ms_by_kernel(
        lambda: steps["fused"](model, batch, gen), 1,
        F32_KERNEL_NAMES + dh.TC_KERNEL_NAMES)
    k1 = sum(v for k, v in by_kernel.items() if "tc::fwd_kernel" in k)
    k2 = sum(v for k, v in by_kernel.items()
             if "dq_kernel" in k or "dkv_kernel" in k)
    k3 = sum(v for k, v in by_kernel.items() if "FwdEpi" in k)
    k4 = sum(v for k, v in by_kernel.items()
             if any(n in k for n in ("DuEpi", "DpixEpi", "dw1_tf32")))
    ms = {impl: 1e3 * statistics.median(v) for impl, v in times.items()}
    vitl = counts["fused"][0]
    print(f"# ViT-L 1280x640 update (b1 x accum 2, fp32, save_kernel) in "
          f"turns: auto tail {ms['auto']:.2f} ms median of "
          f"{[round(1e3 * x, 2) for x in times['auto']]}, fused tail "
          f"{ms['fused']:.2f} ms median of "
          f"{[round(1e3 * x, 2) for x in times['fused']]}; launches per "
          f"fused update K1 {vitl[0]} / K2 {vitl[1]} / K3 {vitl[2]} / K4 "
          f"{vitl[3]} (fp32, 3xTF32); device time in one fused update K1 "
          f"{k1:.2f} ms ({100 * k1 / ms['fused']:.1f}%), K2 {k2:.2f} ms "
          f"({100 * k2 / ms['fused']:.1f}%), K3 {k3:.2f} ms, K4 {k4:.2f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in by_kernel.items())}) "
          f"[{label}]")
    del model, opt
    torch.cuda.empty_cache()
    return (ms["auto"], ms["fused"], k1, k2, vitl[0], vitl[1], vitl[2],
            vitl[3])


def phase_train_1440(label):
    """Painter ViT-L trains through ``train.main --input_size 1440 720``
    (bf16, fused tail, save_kernel, b1 x accum 2, 2 updates, validation):
    K1 on the 90x45 grid (kh + kw 135 <= 190), its whole backward on K2g's
    tensor-core kernels (135 > K2's 127), no K2; each loss finite, each
    update changes the parameters. Returns (K1, K2g, K3, K4) launches."""
    updates, accum = 2, 2
    t0 = time.perf_counter()
    counts, _, _, depth = _train_main(
        label, "train.main Painter ViT-L --input_size 1440 720", PAINTER,
        PAINTER_1440, "bfloat16", 1, accum, updates, updates)
    micro = updates * accum
    check(counts[0] == (depth * (micro + updates), 0, micro, micro, 0)
          and counts[1] == (0, depth * micro, 0, 0, 0),
          f"ViT-L 1440x720 training launched {counts}")
    print(f"# ViT-L 1440x720 training drive: {time.perf_counter() - t0:.1f}"
          f" s with model build, data workers and validation")
    return counts[0][0], counts[1][1], counts[0][2], counts[0][3]


def _update_times(cfg, seed, n, label, what):
    """ms per update of Painter ViT-L at ``cfg`` (b1 x accum 2,
    save_kernel, fused tail) on a device-resident batch: launches of the
    warm-up update (24 K1 and 24 K2g per micro-batch, no K2, no K1g), ``n``
    timed updates, and K2g's device ms in one profiled update. Returns
    (median ms, K2g ms, K2g launches per update)."""
    from painter_tpu_torch.train import optim
    from painter_tpu_torch.train import step as step_lib
    model = _seeded_model(cfg, seed).train()
    opt = optim.LayerDecayAdamW(model, cfg, optim.OptimConfig(
        warmup_epochs=0.0, steps_per_epoch=10))
    step = step_lib.make_train_step(cfg, opt, accum_iter=2,
                                    decoder_impl="fused")
    batch = _train_batch(cfg, 1, seed=seed + 1, accum=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    _zero_counts()
    _timed_updates(step, model, batch, gen, 1)
    vitl, gen_counts = _read_counts()
    check(vitl == (2 * cfg.depth, 0, 2, 2, 0)
          and gen_counts == (0, 2 * cfg.depth, 0, 0, 0),
          f"the {what} update launched {vitl} {gen_counts}")
    times = _timed_updates(step, model, batch, gen, n)
    k2g = _generic_profile(lambda: step(model, batch, gen), "bwd")
    ms = 1e3 * statistics.median(times)
    print(f"# ViT-L {what} update (b1 x accum 2, save_kernel, fused tail): "
          f"{ms:.2f} ms median of {[round(1e3 * x, 2) for x in times]}; "
          f"K2g device time in one update {k2g:.2f} ms ({2 * cfg.depth} "
          f"calls on the tensor cores; {100 * k2g / ms:.1f}% of the "
          f"update); launches per update K1 {vitl[0]}, K2g "
          f"{gen_counts[1]} [{label}]")
    del model, opt
    torch.cuda.empty_cache()
    return ms, k2g, gen_counts[1]


def train_1440_times(label):
    """The 1440x720 update's time in bf16 (3 updates) and in fp32 (one;
    K2g on 3xTF32, TF32 off elsewhere), each with K2g's device share.
    Returns (bf16 ms, bf16 K2g ms, fp32 ms, fp32 K2g ms, fp32 K2g
    launches)."""
    from painter_tpu_torch import configs
    bf16 = _update_times(configs.get_config(
        PAINTER, dtype="bfloat16", img_size=PAINTER_1440), 51, 3, label,
        "1440x720 bf16")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = _update_times(configs.get_config(
        PAINTER, dtype="float32", img_size=PAINTER_1440), 61, 1, label,
        "1440x720 fp32")
    return bf16[0], bf16[1], fp32[0], fp32[1], fp32[2]


def phase_grad_check_1440(label):
    """Painter ViT-L at 1440x720, fp32 b1, TF32 off: the loss and every
    parameter's gradient with K1 (forward) and K2g (backward, 3xTF32) on
    the 90x45 grid against plain attention, at ``phase_grad_check``'s
    limits. Returns K2g's launches."""
    from painter_tpu_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(PAINTER, dtype="float32",
                             img_size=PAINTER_1440)
    model = _seeded_model(cfg, 71).train()
    batch = _train_batch(cfg, 1, seed=72)
    _zero_counts()
    _grad_pair(model, batch, "K1/K2g vs plain attention at 1440x720", label,
               True, ("kernel", "xla"), ("plain", "xla"))
    vitl, gen = _read_counts()
    print(f"# grad check 1440x720: launches K1-K5 {vitl}, K1g-K5g {gen}")
    check(vitl == (cfg.depth, 0, 0, 0, 0)
          and gen == (0, cfg.depth, 0, 0, 0),
          f"1440x720 gradient check launched {vitl} {gen}")
    del model
    torch.cuda.empty_cache()
    return gen[1]


def phase_forward_2048(label):
    """One b1 forward of Painter ViT-L built at img_size (2048, 1024) (a
    128x64 grid, kh + kw 192 past K1's 190, hd + min 128: the domain's
    edge) through ``InContextModel`` with ``attn_impl="kernel"``: 24 K1g
    launches, no K1; its painted half against the same weights with plain
    attention within FWD_BF16_TOL. Returns K1g's launches."""
    from painter_tpu_torch import configs
    from painter_tpu_torch.infer import engine
    cfg = configs.get_config(PAINTER, dtype="bfloat16",
                             img_size=PAINTER_2048)
    model = _seeded_model(cfg, 81)
    res = cfg.img_size[1]
    rng = np.random.RandomState(82)
    img2, tgt2 = rng.rand(res, res, 3), rng.rand(res, res, 3)
    imgs, tgts = engine.build_query_batch([rng.rand(res, res, 3)], img2,
                                          tgt2)
    outs, secs = {}, {}
    for impl in ("kernel", "plain"):
        eng = engine.InContextModel(cfg, model, attn_impl=impl,
                                    device="cuda")
        _zero_counts()
        t0 = time.perf_counter()
        outs[impl] = eng.run_queries(imgs, tgts, real_count=1)
        secs[impl] = time.perf_counter() - t0
        counts = _read_counts()
        want = ((0,) * 5, (cfg.depth, 0, 0, 0, 0)) if impl == "kernel" \
            else ((0,) * 5, (0,) * 5)
        check(counts == want, f"2048x1024 {impl} forward launched {counts}")
    got, ref = outs["kernel"], outs["plain"]
    err = float(np.abs(got - ref).max())
    check(got.shape == ref.shape == (1, res, res, 3)
          and np.isfinite(got).all() and err <= FWD_BF16_TOL,
          f"2048x1024 forward: {got.shape} {ref.shape}, max abs err {err}")
    print(f"# Painter ViT-L 2048x1024 b1 forward (128x64 grid, K1g "
          f"{cfg.depth} launches, no K1): max abs vs plain attention "
          f"{err:.3e} (tol {FWD_BF16_TOL}); first call {secs['kernel']:.2f}"
          f" s (plain {secs['plain']:.2f} s) [{label}]")
    del model
    torch.cuda.empty_cache()
    return cfg.depth


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"# phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def _kernel_entry(name, replaces, launches, row, source=None):
    return {"name": name, "route": "cuda",
            "source": f"painter_tpu_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def _row(rows, shape, dtype=torch.bfloat16):
    return next(r for r in rows if (r["bh"], tuple(r["grid"])) == shape
                and r["dtype"] == str(dtype))


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
    gen_attn_rows = timed("K1g/K2g vs plain", phase_generic_attention, label)
    gen_tail_rows = timed("K3g/K4g vs plain", phase_generic_tail, label)
    k5g_rows = timed("K5g vs plain", phase_k5_generic, label)
    # every ViT-L 896x448 path below launches no K1g-K4g and no K5g
    _zero_counts()
    model, serve_k1 = timed("serving drive", phase_model, label)
    tools_k1, tools_k2 = timed("tools", phase_tools, model, label)
    bf16_times = timed("serving times", phase_times, model, label)
    serve_k5, int8_times = timed("int8 serving drive", phase_int8_serving,
                                 model, label)
    all_times = (bf16_times, *int8_times.values())
    print("# serving in bf16 / int8 / int8-fused: pairs/s (b8 ensemble) "
          + " / ".join(f"{t[0]:.3f}" for t in all_times) + "; b1 p50 ms "
          + " / ".join(f"{t[1]:.2f}" for t in all_times) + f" [{label}]")
    video_k1, _, _ = timed("video drive", phase_video, model, label)
    cli_k1, cli_k5 = timed("CLI drive", phase_cli, label)
    endpoint_k1 = timed("endpoint drive", phase_endpoint, label)
    painter_k1 = timed("Painter task drive", phase_painter_task, label)
    eval_k1, eval_k5 = timed("eval drive", phase_eval, label)
    dp_k1 = timed("dp serving", phase_dp_serving, model, label)
    del model
    torch.cuda.empty_cache()
    timed("gradient check", phase_grad_check, label)
    result, train_k1, train_k2, train_k3, train_k4 = timed(
        "training drive", phase_train_cli, label)
    timed("remat full", phase_remat_full, result)
    timed("training times", phase_train_times, result, label)
    remat_k1, remat_k2 = timed("remat policies", phase_remat_policies,
                               result, label)
    del result
    torch.cuda.empty_cache()
    nccl_k1, nccl_k2, nccl_k3, nccl_k4 = timed("NCCL world 1",
                                               phase_nccl_world1, label)
    gloo_k1, gloo_k2, gloo_k3, gloo_k4 = timed("gloo two ranks",
                                               phase_gloo_ranks, label)
    fe_k1, fe_k2, fe_k3, fe_k4 = timed("data front end",
                                       phase_data_front_end, label)
    vitl_gen = _read_counts()[1] + _read_tc_counts()
    print(f"# K1g-K4g and K5g, tensor-core K3g / K4g launches on every ViT-L "
          f"896x448 path above: {vitl_gen}")
    check(vitl_gen == (0,) * 7,
          f"a ViT-L 896x448 path launched a generic kernel: {vitl_gen}")
    tiny_k1g = timed("tiny_test serving", phase_tiny_serving, label)
    tiny_gen = timed("tiny_test training", phase_tiny_train, label)
    tiny_k5g = timed("tiny_test int8 serving", phase_tiny_int8_serving,
                     label)
    cli_tiny_k5g = timed("CLI tiny_test int8-fused", phase_cli_tiny, label)
    wide_k3g, wide_k4g = timed("tiny_test wide decoder training",
                               phase_tiny_wide_decoder, label)
    (vw_k3g, vw_k4g), _, _ = timed("ViT-L 896x448 wide decoder training",
                                   phase_vitl_wide_decoder, label)
    (vn_k3g, vn_k4g), _, _ = timed("ViT-L 896x448 narrow decoder updates",
                                   phase_vitl_narrow_decoder, label)
    fp32_k5, _, fp32_serve_k1 = timed("SegGPT ViT-L fp32 int8 serving",
                                      phase_int8_fp32_serving, label)
    vitb_k5g, _ = timed("SegGPT ViT-B-wide int8 serving",
                        phase_int8_vitb_serving, label)
    timed("gradient check 1280x640", phase_grad_check_1280, label)
    t1280 = timed("training drive 1280x640", phase_train_1280, label)
    timed("training times 1280x640", train_1280_times, label)
    *_, f32_k1, f32_k2, f32_k3, f32_k4 = timed(
        "fp32 training times 1280x640", train_1280_fp32_times, label)
    t1440 = timed("training drive 1440x720", phase_train_1440, label)
    *_, f1440_k2g = timed("training times 1440x720", train_1440_times,
                          label)
    gc1440_k2g = timed("gradient check 1440x720", phase_grad_check_1440,
                       label)
    fwd2048_k1g = timed("forward 2048x1024", phase_forward_2048, label)
    infer_k1 = video_k1 + cli_k1 + endpoint_k1 + painter_k1 + eval_k1 + \
        dp_k1
    dist_k = (remat_k1 + nccl_k1 + gloo_k1 + fe_k1 + tools_k1,
              remat_k2 + nccl_k2 + gloo_k2 + fe_k2 + tools_k2,
              nccl_k3 + gloo_k3 + fe_k3, nccl_k4 + gloo_k4 + fe_k4)
    print(f"# K1 launches: serving main path {serve_k1}, video {video_k1}, "
          f"CLI {cli_k1}, endpoint {endpoint_k1}, Painter task {painter_k1}, "
          f"eval {eval_k1}, dp serving {dp_k1}, training main path "
          f"{train_k1}, remat policies {remat_k1}, NCCL world 1 {nccl_k1}, "
          f"gloo ranks {gloo_k1}, data front end {fe_k1}, tools "
          f"{tools_k1}; K2 launches: "
          f"training main path {train_k2}, remat policies {remat_k2}, NCCL "
          f"world 1 {nccl_k2}, gloo ranks {gloo_k2}, data front end "
          f"{fe_k2}, tools {tools_k2}; K3 / K4 launches: training main path {train_k3} / "
          f"{train_k4}, NCCL world 1 {nccl_k3} / {nccl_k4}, gloo ranks "
          f"{gloo_k3} / {gloo_k4}, data front end {fe_k3} / {fe_k4}; K5 "
          f"launches: int8-fused "
          f"serving "
          f"path {serve_k5}, CLI --quant int8-fused {cli_k5}, eval "
          f"--quant int8-fused {eval_k5}, SegGPT ViT-L fp32 int8-fused "
          f"serving {fp32_k5}; ViT-L 1280x640 training (K1, "
          f"K2, K3, K4) {t1280}; fp32 (3xTF32) K1: SegGPT ViT-L fp32 "
          f"serving {fp32_serve_k1}, 1280x640 fp32 update {f32_k1}; fp32 "
          f"K2: 1280x640 fp32 update {f32_k2}; fp32 (3xTF32) K3 / K4: "
          f"1280x640 fp32 fused update {f32_k3} / {f32_k4}; ViT-L 1440x720 "
          f"training (K1, K2g, K3, K4) {t1440}, fp32 update K2g "
          f"{f1440_k2g}, fp32 gradient check K2g {gc1440_k2g}; ViT-L "
          f"2048x1024 forward K1g {fwd2048_k1g}; tiny_test: K1g "
          f"serving {tiny_k1g}, "
          f"training (K1g, K2g, K3g, K4g) {tiny_gen}, decoder "
          f"{WIDE_DECODER} training (tensor-core K3g, K4g) ({wide_k3g}, "
          f"{wide_k4g}); ViT-L 896x448 decoder {WIDE_VITL_DECODER} training "
          f"(tensor-core K3g, K4g) ({vw_k3g}, {vw_k4g}); ViT-L 896x448 "
          f"decoder {NARROW_VITL_DECODER} fused update (narrow K3g, K4g) "
          f"({vn_k3g}, {vn_k4g}); "
          f"K5g launches: "
          f"tiny_test int8-fused serving {tiny_k5g}, CLI tiny_test "
          f"{cli_tiny_k5g}, SegGPT ViT-B-wide int8-fused serving (bf16 and "
          f"fp32) {vitb_k5g}")
    tail = next(r for r in tail_rows if tuple(r["K3"]["shape"]) ==
                TAIL_MAIN_SHAPE and r["K3"]["dtype"] == str(torch.bfloat16))
    tail_f32 = next(r for r in tail_rows if tuple(r["K3"]["shape"]) ==
                    PAINTER_1280_TAIL and r["K3"]["dtype"] ==
                    str(torch.float32))
    k5_row = next(r for r in k5_rows if r["m"] == K5_MAIN_M
                  and r["dtype"] == str(torch.bfloat16))
    k5g_row = next(r for r in k5g_rows if (
        r["m"], r["k"], r["n"], r["dtype"]) == (*K5G_MAIN[:3],
                                                str(K5G_MAIN[3])))

    def gen_row(kind, bh, d, grid, dtype=torch.bfloat16):
        return next(r for k, r in gen_attn_rows if k == kind
                    and (r["bh"], r["hd"], tuple(r["grid"])) == (bh, d, grid)
                    and r["dtype"] == str(dtype))
    gen_tail = next(r for r in gen_tail_rows if (
        tuple(r["K3"]["shape"]), r["K3"]["c"]) == GENERIC_TAIL_MAIN
        and r["K3"]["dtype"] == str(torch.bfloat16) and r["K3"]["approx"])
    tc_tail = next(r for r in gen_tail_rows if (
        tuple(r["K3"]["shape"]), r["K3"]["c"]) == GENERIC_TAIL_BIG
        and r["K3"]["dtype"] == str(torch.bfloat16))
    kernels = [
        _kernel_entry("flash_relpos_fwd",
                      "painter_tpu/kernels/flash_relpos.py:399",
                      serve_k1 + infer_k1 + train_k1 + dist_k[0] + t1280[0],
                      _row(k1_rows, K1_MAIN_SHAPE)),
        _kernel_entry("flash_relpos_bwd",
                      "painter_tpu/kernels/flash_relpos.py:438",
                      train_k2 + dist_k[1] + t1280[1],
                      _row(k2_rows, K2_MAIN_SHAPE)),
        _kernel_entry("flash_relpos_fwd_f32",
                      "painter_tpu/kernels/flash_relpos.py:399",
                      fp32_serve_k1 + f32_k1,
                      _row(k1_rows, K1_MAIN_SHAPE, torch.float32),
                      "flash_relpos_fwd"),
        _kernel_entry("flash_relpos_bwd_f32",
                      "painter_tpu/kernels/flash_relpos.py:438", f32_k2,
                      _row(k2_rows, K2_F32_MAIN_SHAPE, torch.float32),
                      "flash_relpos_bwd"),
        _kernel_entry("decoder_tail_fwd",
                      "painter_tpu/kernels/decoder_head.py:180",
                      train_k3 + dist_k[2] + t1280[2], tail["K3"]),
        _kernel_entry("decoder_tail_bwd",
                      "painter_tpu/kernels/decoder_head.py:304",
                      train_k4 + dist_k[3] + t1280[3], tail["K4"]),
        _kernel_entry("decoder_tail_tc_fwd_f32",
                      "painter_tpu/kernels/decoder_head.py:180", f32_k3,
                      tail_f32["K3"], "decoder_tail_tc_fwd"),
        _kernel_entry("decoder_tail_tc_bwd_f32",
                      "painter_tpu/kernels/decoder_head.py:304", f32_k4,
                      tail_f32["K4"], "decoder_tail_tc_bwd"),
        _kernel_entry("int8_mlp", "painter_tpu/kernels/int8_mlp.py:87",
                      serve_k5 + cli_k5 + eval_k5 + fp32_k5, k5_row),
        _kernel_entry("flash_relpos_generic_fwd",
                      "painter_tpu/kernels/flash_relpos.py:399",
                      tiny_k1g + tiny_gen[0] + fwd2048_k1g,
                      gen_row("K1g", *GENERIC_FWD_MAIN),
                      "flash_relpos_generic"),
        _kernel_entry("flash_relpos_generic_bwd",
                      "painter_tpu/kernels/flash_relpos.py:438",
                      tiny_gen[1] + t1440[1],
                      gen_row("K2g", *GENERIC_BWD_MAIN),
                      "flash_relpos_generic"),
        _kernel_entry("flash_relpos_generic_bwd_f32",
                      "painter_tpu/kernels/flash_relpos.py:438",
                      f1440_k2g + gc1440_k2g,
                      gen_row("K2g", *GENERIC_BWD_MAIN, torch.float32),
                      "flash_relpos_generic"),
        _kernel_entry("decoder_tail_generic_fwd",
                      "painter_tpu/kernels/decoder_head.py:180",
                      tiny_gen[2] + vn_k3g, gen_tail["K3"],
                      "decoder_tail_generic"),
        _kernel_entry("decoder_tail_generic_bwd",
                      "painter_tpu/kernels/decoder_head.py:304",
                      tiny_gen[3] + vn_k4g, gen_tail["K4"],
                      "decoder_tail_generic"),
        _kernel_entry("decoder_tail_tc_fwd",
                      "painter_tpu/kernels/decoder_head.py:180",
                      wide_k3g + vw_k3g, tc_tail["K3"]),
        _kernel_entry("decoder_tail_tc_bwd",
                      "painter_tpu/kernels/decoder_head.py:304",
                      wide_k4g + vw_k4g, tc_tail["K4"]),
        _kernel_entry("int8_mlp_generic",
                      "painter_tpu/kernels/int8_mlp.py:87",
                      tiny_k5g + cli_tiny_k5g + vitb_k5g, k5g_row)]
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-rank":
        # one of phase_gloo_ranks' processes
        _gloo_rank(int(sys.argv[2]), sys.argv[4], sys.argv[6])
    elif len(sys.argv) > 1 and sys.argv[1] == "--seccrop-times":
        # phase_data_front_end's one-thread seccrop timing
        with open(sys.argv[2], "w") as f:
            json.dump(_fe_seccrop_times(), f)
    else:
        main()
