"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``painter_tpu_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, then
serves SegGPT ViT-L 896x448 (bf16, full width and depth, random weights
from a seed) through ``InContextModel`` and checks that every forward went
through the kernels. Prints its findings, then a ``{"kernels": [...]}``
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
    from painter_tpu_torch.kernels import build
    for name in build.SOURCES:
        t0 = time.perf_counter()
        path = build.build(name)
        print(f"# build {name}: {time.perf_counter() - t0:.2f} s")
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
        busy = profile_forward(b8, label)

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


def profile_forward(fn, label):
    """Device time by kernel over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: an operator's entry repeats the time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    total = sum(dev_us(e) for e in events)
    if not total:
        print("# profile: the profiler saw no device time; breakdown not "
              "measured")
        return "not measured"
    top = sorted(events, key=dev_us, reverse=True)[:8]
    print(f"# profile of one b8 forward: device {total / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall [{label}]")
    for e in top:
        print(f"#   {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / total:5.1f}%"
              f"  x{e.count:<4d} {e.key[:90]}")
    share = total / wall_us
    check(share <= 1.0, f"device time {total} us exceeds the wall time "
          f"{wall_us} us: the profile counts kernels twice")
    return f"{share:.3f}"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    label = card_label()
    print(label)
    phase_build()
    rows = phase_k1(label)
    model, launches = phase_model(label)
    phase_times(model, label)
    main_row = next(r for r in rows if (r["bh"], tuple(r["grid"]))
                    == (K1_MAIN_SHAPE[0], K1_MAIN_SHAPE[1])
                    and r["dtype"] == str(torch.bfloat16))
    kernels = [{
        "name": "flash_relpos_fwd", "route": "cuda",
        "source": "painter_tpu_torch/kernels/csrc/flash_relpos_fwd.cu",
        "replaces": "painter_tpu/kernels/flash_relpos.py:399",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
