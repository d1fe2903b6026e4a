"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``painter_tpu_torch/kernels/csrc``,
holds each kernel (K1 attention forward, K2 its backward) against its
plain PyTorch version on the card, then drives both main paths at full
width and depth with random weights from a seed: serving SegGPT ViT-L
896x448 (bf16) through ``InContextModel``, and training Painter ViT-L
896x448 (bf16 compute, fp32 params) through
``painter_tpu_torch.train.train.main`` on a synthetic dataset, after a
full-model gradient check of K1/K2 against plain attention. Checks that
each path went through the kernels. Prints its findings, then a
``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and the last line is not printed. Needs
a CUDA device; it imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
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
# bf16 ViT-L forward (the WMMA kernel that serves the path) against the
# same bf16 forward with plain attention, and the bf16 engine output
# against the fp32 plain forward, [0,1] scale: every activation is
# rounded to 8 mantissa bits (2^-9 relative) over 24 blocks; the bf16
# engine output was 5.7e-3 from the fp32 one on the H100
FWD_BF16_TOL = 3e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    ms = cuda_ms(lambda: fr.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                                   grid, scale), iters)
    plain_ms = cuda_ms(lambda: fr.flash_attention_relpos_reference(
        q, k, v, rel_h, rel_w, grid, scale), max(1, iters // 2))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale),
                         iters)
    del bias
    flops = 4 * bh * length * length * d
    es = q.element_size()
    nbytes = (4 * bh * length * d + bh * length * sum(grid)) * es \
        + bh * length * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bh": bh, "grid": list(grid), "dtype": str(dtype),
            "max_abs_err": err, "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "flop": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
                  f"plain_ms {row['plain_ms']:.4f} library_ms(sdpa+bias) "
                  f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
                  f"({row['flop']:.4e} FLOP at "
                  f"{'989' if dtype == torch.bfloat16 else '67'} TFLOP/s, "
                  f"{row['bound_by']}) [{label}]")
    return rows


def k2_case(bh, grid, dtype, seed, iters):
    """K2 and its plain backward on one input; returns the row of numbers.

    out and lse come from K1's plain version on the same q, k, v and rel
    terms, dO from a seeded normal; both backwards read the same tensors.
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
    ref = fr.flash_attention_relpos_bwd_reference(*args)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "d_rel_h", "d_rel_w")
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
    ms = cuda_ms(lambda: fr.flash_attention_relpos_bwd(*args), iters)
    plain_ms = cuda_ms(lambda: fr.flash_attention_relpos_bwd_reference(*args),
                       max(1, iters // 2))
    # the library's backward: SDPA with the materialized bias as a
    # grad-requiring attn_mask, its forward run once outside the timing
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        bh, length, length).detach().requires_grad_()
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=bias, scale=scale)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves + [bias], dout, retain_graph=True), iters)
    del sdpa_out, bias, leaves
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
            "plain_ms": plain_ms, "library_ms": library_ms, "flop": flops,
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
                  f"{row['max_abs_err']:.3e} (err/max|plain|: {errs}) "
                  f"kernel_ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                  f"library_ms(sdpa bwd, bias grad) {row['library_ms']:.4f} "
                  f"bound_ms {row['bound_ms']:.4f} ({row['flop']:.4e} FLOP "
                  f"at {'989' if dtype == torch.bfloat16 else '67'} TFLOP/s, "
                  f"{row['bound_by']}) [{label}]")
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


def phase_times(model, label):
    """b8 ensemble pairs/s (bench.py:120-147 semantics) and b1 p50."""
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
        busy = profile_device(b8, "one b8 forward", label)

        i1, t1, m1, s1 = inputs(1)
        lat = []
        for _ in range(11):
            t0 = time.perf_counter()
            image_ops.denormalize(tm.predict_query_half(
                model, i1, t1, m1, seg_type=s1)).cpu().numpy()
            lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat[1:])
    print(f"# b8 ensemble: {8 / b8_s:.3f} pairs/s ({b8_s * 1e3:.2f} ms per "
          f"batch, peak memory {peak_gb:.2f} GB, device busy share "
          f"{busy}); b1 p50 latency incl. host fetch {p50 * 1e3:.2f} ms "
          f"[{label}]")


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


def _loss_and_grads(model, batch, impl):
    from painter_tpu_torch.models import incontext_vit as tm
    model.zero_grad(set_to_none=True)
    loss, _, _ = tm.forward(
        model, batch["imgs"], batch["tgts"], batch["mask"], batch["valid"],
        attn_impl=impl, train=True, remat=True, remat_policy="save_kernel",
        generator=torch.Generator(device="cuda").manual_seed(7))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_grad_check(label):
    """Painter ViT-L 896x448: one micro-batch's loss and every parameter's
    gradient with K1/K2 against the same step with plain attention (same
    weights, mask and drop-path generator seed); fp32 at batch 1, bf16 at
    batch 2."""
    from painter_tpu_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = configs.get_config(PAINTER, dtype="float32")
    model = _seeded_model(cfg32, 1).train()
    batch = _train_batch(cfg32, 1, seed=2)
    loss_k, g_k = _loss_and_grads(model, batch, "kernel")
    loss_p, g_p = _loss_and_grads(model, batch, "plain")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    rel = {n: ((g_k[n] - g_p[n]).abs().max()
               / g_p[n].abs().max().clamp_min(1e-30)).item() for n in g_p}
    worst = max(rel, key=rel.get)
    print(f"# grad check fp32 b1: loss kernel {loss_k:.7f} plain "
          f"{loss_p:.7f} (rel err {loss_err:.2e}, tol "
          f"{GRAD_FP32_LOSS_RTOL}); worst gradient {worst} max abs err / "
          f"max abs {rel[worst]:.2e} (tol {GRAD_FP32_RTOL}) [{label}]")
    check(loss_err <= GRAD_FP32_LOSS_RTOL, f"fp32 loss differs: {loss_err}")
    check(rel[worst] <= GRAD_FP32_RTOL,
          f"fp32 gradient {worst} differs by {rel[worst]}")
    del g_k, g_p

    m16 = _same_weights(model, configs.get_config(PAINTER,
                                                  dtype="bfloat16")).train()
    batch = _train_batch(cfg32, 2, seed=3)
    loss_k, g_k = _loss_and_grads(m16, batch, "kernel")
    loss_p, g_p = _loss_and_grads(m16, batch, "plain")
    num = sum(((g_k[n] - g_p[n]).double() ** 2).sum() for n in g_p)
    den = sum((g_p[n].double() ** 2).sum() for n in g_p)
    rel_l2 = (num / den).sqrt().item()
    print(f"# grad check bf16 b2: loss kernel {loss_k:.6f} plain "
          f"{loss_p:.6f}; concatenated gradient relative L2 {rel_l2:.3e} "
          f"(tol {GRAD_BF16_REL_L2}) [{label}]")
    check(all(torch.isfinite(g).all().item() for g in g_k.values()),
          "bf16 kernel gradients are not finite")
    check(rel_l2 <= GRAD_BF16_REL_L2, f"bf16 gradients differ: {rel_l2}")
    del model, m16, g_k, g_p
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
    remat, validation), K1/K2 counted around exactly this run."""
    import os
    import tempfile
    from painter_tpu_torch import configs
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
        "save_kernel", "--print_freq", "1", "--watchdog_freq", "1"])
    fr.flash_attention_relpos.launches = 0
    fr.flash_attention_relpos_bwd.launches = 0
    result = train.main(args)
    k1 = fr.flash_attention_relpos.launches
    k2 = fr.flash_attention_relpos_bwd.launches
    micro = updates * accum
    depth = result["model"].cfg.depth
    print(f"# training main path: K1 launches {k1} ({micro} micro-batches "
          f"+ {val_batches} validation batches), K2 launches {k2}: per "
          f"micro-batch K1 {(k1 - depth * val_batches) / micro:g}, K2 "
          f"{k2 / micro:g}")
    check(result["step"] == updates, f"trained {result['step']} updates")
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
    return result, k1, k2


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
    the remat choices in turns (save_kernel, full, none), 2 rounds of 2
    updates each after one warm-up update."""
    from painter_tpu_torch.train import step as step_lib
    model, opt = result["model"], result["optimizer"]
    batch = _train_batch(model.cfg, 2, seed=6, accum=2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    steps = {name: step_lib.make_train_step(
        model.cfg, opt, accum_iter=2, remat=name != "none",
        remat_policy=name if name != "none" else "save_kernel")
        for name in ("save_kernel", "full", "none")}
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
    print("# remat in turns, ms per update (mean of 4; peak GB): " + "; ".join(
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
    model, serve_k1 = timed("serving drive", phase_model, label)
    timed("serving times", phase_times, model, label)
    del model
    torch.cuda.empty_cache()
    timed("gradient check", phase_grad_check, label)
    result, train_k1, train_k2 = timed("training drive", phase_train_cli,
                                       label)
    timed("remat full", phase_remat_full, result)
    timed("training times", phase_train_times, result, label)
    print(f"# K1 launches: serving main path {serve_k1}, training main path "
          f"{train_k1}; K2 launches: training main path {train_k2}")
    kernels = [
        _kernel_entry("flash_relpos_fwd",
                      "painter_tpu/kernels/flash_relpos.py:399",
                      serve_k1 + train_k1, _row(k1_rows, K1_MAIN_SHAPE)),
        _kernel_entry("flash_relpos_bwd",
                      "painter_tpu/kernels/flash_relpos.py:438",
                      train_k2, _row(k2_rows, K2_MAIN_SHAPE))]
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
