"""Stage-marginal profiles of the attention kernels K1 (forward) and K2
(backward) on the card.

The port of ``painter_tpu/utils/kernel_stage_profile.py``: variants of the
real kernels with stages dropped, each timed as the wrapper calls it, so
the difference between two variants is that stage's cost as it runs
(about zero for a stage the card overlaps with the tensor cores). The
variants are string edits of a copy of ``kernels/csrc``, built by
``utils/kernel_variants.py`` (:func:`apply_edits`, :func:`build_variants`)
and swapped in under the real wrappers by ``kernels/build.py``'s
``swapped``; the tool patches nothing itself. A variant's outputs are garbage in the stages it
drops: the tool times, it does not compute. Only ``full`` (the source
built again with no edit) must give the real kernel's bits, which
:func:`profile` checks, so the mechanism is shown to time the real code.

K1, ``flash_relpos_fwd.cu``, bf16 route (``hop::Consumer``). JAX's kernel
used a fixed softmax max; K1 keeps a running max (online softmax), whose
extra work is the rescale factor ``alpha`` and the O rescale by it. Each
variant drops only its own stage, as JAX's do:

- ``no_recip``: the final ``1 / l`` of each row (``i0`` / ``i1``) and the
  ``log2f`` of the lse store (the store stays, as JAX's variant still
  writes its denominator column);
- ``no_exp2``: every ``exp2f`` of the softmax, P's and ``alpha``'s, so
  ``alpha`` is 1 and the O rescale folds away; the max stays;
- ``qk_only``: only S = Q.K^T and the K / V stream: no bias gather
  (``bias.tile``), no softmax (max, ``exp2f``, row sums), no P.V product.

K2, ``flash_relpos_bwd.cu``, bf16 route: two kernels, (a) ``dq_kernel``
(S, dP, dS, dq += dS.K, and d rel_h / d rel_w by ``mma.sync`` on the one-hot
expanders) and (b) ``dkv_kernel`` (S^T, dP^T, P^T, dS^T, dv += P^T.dO, dk
+= dS^T.Q). The stages drop cumulatively, each the one before and one
more, as JAX's:

- ``no_dv``: (b)'s dv product;
- ``no_dkv``: (b)'s dk product too; (b) is then its own recompute of S^T,
  dP^T, P^T and dS^T (JAX's one kernel shared that recompute with dq);
- ``no_drx``: (a)'s d rel_w / d rel_h products (``ldmatrix`` +
  ``mma.sync``) and their per-tile row sums in shared memory;
- ``dq_from_p``: the dP product and dS in both kernels (dq = P.K in (a));
- ``no_exp2``: the ``exp2f`` of P in both kernels;
- ``qk_only``: the bias and lse in both kernels: (a) is S and dq = S.K,
  (b) S^T alone.

No stage of JAX's lists lacks a meaning in the CUDA design, so none is
dropped: ``FWD_STAGES`` and ``BWD_STAGES`` are JAX's. Besides the time per
wrapper call (``utils/cuda_timing.py`` ``event_ms``, the min over
``reps`` runs of ``iters`` calls), each K2 variant's device time per call
is split between (a) and (b) by ``torch.profiler``.

CLI (needs a CUDA device and ``nvcc``)::

    python -m painter_tpu_torch.utils.kernel_stage_profile \\
        [--qh 56 --qw 28 --batch 8 --heads 16 --iters 10 --reps 3]
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.utils import kernel_variants as kv
from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel, event_ms

FWD_STAGES = ("full", "no_recip", "no_exp2", "qk_only")
BWD_STAGES = ("full", "no_dv", "no_dkv", "no_drx", "dq_from_p",
              "no_exp2", "qk_only")
FWD_SOURCE, BWD_SOURCE = "flash_relpos_fwd", "flash_relpos_bwd"
K2_KERNELS = {"dq": "dq_kernel", "dkv": "dkv_kernel"}

Pairs = List[Tuple[str, str]]

# K1: each stage's own edits (hop::Consumer and the epilogue)
FWD_EDITS: Dict[str, Pairs] = {
    "full": [],
    "no_recip": [
        ("    const float i0 = 1.f / l0;\n    const float i1 = 1.f / l1;\n",
         "    const float i0 = 1.f;\n    const float i1 = 1.f;\n"),
        ("(m0 + log2f(l0)) * LN2", "l0"),
        ("(m1 + log2f(l1)) * LN2", "l1")],
    "no_exp2": [
        ("make_float2(exp2f(m0 - n0), exp2f(m1 - n1))",
         "make_float2(1.f, 1.f)"),
        ("s[4 * j + e] = exp2f(s[4 * j + e] - n0);",
         "s[4 * j + e] = s[4 * j + e] - n0;"),
        ("s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - n1);",
         "s[4 * j + 2 + e] = s[4 * j + 2 + e] - n1;")],
    "qk_only": [
        ("    bias.tile(0);\n", ""),
        ("      bias.tile(t);\n", ""),
        ("  __device__ float2 softmax() {\n",
         "  __device__ float2 softmax() {\n    return make_float2(1.f, 1.f);\n"),
        ("      wgmma_m64n64k16_rs(o, pa[kk], dv + (uint64_t)(kk * 16 * "
         "ROW_BYTES >> 4));\n", "      (void)dv;\n")],
}

# K2: each stage's edits on top of the stages before it, (a) then (b)
_BWD_STEPS: Dict[str, Pairs] = {
    "full": [],
    "no_dv": [
        ("        wgmma_m64n64k16_rs(dva, pf[kk], dD + (uint64_t)(kk * 16 * "
         "128 >> 4));\n", "        (void)dD;\n")],
    "no_dkv": [
        ("        wgmma_m64n64k16_rs(dka, df[kk], dQ + (uint64_t)(kk * 16 * "
         "128 >> 4));\n", "        (void)dQ;\n")],
    "no_drx": [
        ("          uint32_t b[4];\n"
         "          ldsm_x4_t(b, e_addr(tE, m + kk * 16, np * 16, lane));\n"
         "          mma16816(gw[2 * np], ds[kk], b[0], b[1]);\n"
         "          if (np < 2)\n"
         "            mma16816(gw[2 * np + 1], ds[kk], b[2], b[3]);\n"
         "          else\n"
         "            mma16816(gh, ds[kk], b[2], b[3]);\n",
         "          (void)tE;\n          (void)m;\n"),
        ("          float2 cur = ghrow[bin];\n          cur.x += gh[e];\n"
         "          cur.y += gh[2 + e];\n          ghrow[bin] = cur;\n", "")],
    "dq_from_p": [
        ("        wgmma_m64n64k16_ss(dp, dO + 2 * kk, dV + 2 * kk, kk);\n",
         "        (void)dV;\n"),
        ("          s[ia] = va ? pa * (dp[ia] - dl_a) : 0.f;\n"
         "          s[ib] = vb ? pb * (dp[ib] - dl_b) : 0.f;\n",
         "          s[ia] = va ? pa : 0.f;\n          s[ib] = vb ? pb : 0.f;\n"),
        ("        wgmma_m64n64k16_ss(dp, dV + 2 * kk, dD + 2 * kk, kk);\n",
         "        (void)dV;\n"),
        ("          dp[ia] = s[ia] * (dp[ia] - dl);\n"
         "          dp[ib] = s[ib] * (dp[ib] - dl);\n", "")],
    "no_exp2": [
        ("const float pa = exp2f(fmaf(s[ia], sc, bias[j][e].x) - lse_a);",
         "const float pa = fmaf(s[ia], sc, bias[j][e].x) - lse_a;"),
        ("const float pb = exp2f(fmaf(s[ib], sc, bias[j][e].y) - lse_b);",
         "const float pb = fmaf(s[ib], sc, bias[j][e].y) - lse_b;"),
        ("              exp2f(fmaf(fmaf(s[ia], scale, bias_a), LOG2E, -l2));",
         "              fmaf(fmaf(s[ia], scale, bias_a), LOG2E, -l2);"),
        ("              exp2f(fmaf(fmaf(s[ib], scale, bias_b), LOG2E, -l2));",
         "              fmaf(fmaf(s[ib], scale, bias_b), LOG2E, -l2);")],
    "qk_only": [
        ("const float pa = fmaf(s[ia], sc, bias[j][e].x) - lse_a;",
         "const float pa = s[ia];"),
        ("const float pb = fmaf(s[ib], sc, bias[j][e].y) - lse_b;",
         "const float pb = s[ib];"),
        ("              fmaf(fmaf(s[ia], scale, bias_a), LOG2E, -l2);",
         "              s[ia];"),
        ("              fmaf(fmaf(s[ib], scale, bias_b), LOG2E, -l2);",
         "              s[ib];")],
}
BWD_EDITS: Dict[str, Pairs] = {
    stage: [e for s in BWD_STAGES[:i + 1] for e in _BWD_STEPS[s]]
    for i, stage in enumerate(BWD_STAGES)}


def variants() -> Dict[str, Tuple[str, kv.Edits]]:
    """Every stage variant in ``kernel_variants``' form: ``fwd_<stage>``
    and ``bwd_<stage>`` -> (source, {file: edits})."""
    out = {f"fwd_{s}": (FWD_SOURCE, {f"{FWD_SOURCE}.cu": FWD_EDITS[s]})
           for s in FWD_STAGES}
    out.update({f"bwd_{s}": (BWD_SOURCE, {f"{BWD_SOURCE}.cu": BWD_EDITS[s]})
                for s in BWD_STAGES})
    return out


def _min_ms(fn, iters: int, reps: int) -> float:
    return min(event_ms(fn, iters, warmup=1) for _ in range(reps))


def _k2_split(fn, iters: int):
    """K2's device ms per call in its dq and dk/dv kernels
    (torch.profiler), or None where a second try still saw neither: a
    profiler session can come back without the card's events."""
    for _ in range(2):
        by = device_ms_by_kernel(fn, iters, tuple(K2_KERNELS.values()))
        if by:
            return {short: sum(t for key, t in by.items() if name in key)
                    for short, name in K2_KERNELS.items()}
    return None


def profile(qh: int = 56, qw: int = 28, batch: int = 8, heads: int = 16,
            head_dim: int = 64, iters: int = 10, reps: int = 3,
            seed: int = 0) -> Dict[str, Dict]:
    """Both stage-marginal profiles at (batch * heads, qh * qw, head_dim)
    bf16 -> ``{"fwd": {stage: ms}, "bwd": {stage: ms}, "bwd_device_ms":
    {stage: {"dq": ms, "dkv": ms} or None}, "full_bitwise_equal": {"fwd":
    bool, "bwd": bool}}``, ms per wrapper call (see the module
    docstring)."""
    from painter_tpu_torch.ops.attention import rel_pos_bias
    if not torch.cuda.is_available():
        raise RuntimeError("the stage profile builds and times CUDA "
                           "kernels: it needs a CUDA device")
    libs = kv.build_variants(variants())
    bh, length = batch * heads, qh * qw
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return (torch.randn(*shape, generator=g, device="cuda")
                * 0.3).to(torch.bfloat16)

    q, k, v, dout = (mk(bh, length, head_dim) for _ in range(4))
    rel_h, rel_w = rel_pos_bias(q.view(batch, heads, length, head_dim),
                                mk(2 * qh - 1, head_dim),
                                mk(2 * qw - 1, head_dim), (qh, qw), (qh, qw))
    rel_h = rel_h.reshape(bh, length, qh).contiguous()
    rel_w = rel_w.reshape(bh, length, qw).contiguous()
    scale = head_dim ** -0.5

    def fwd():
        return fr.flash_attention_relpos(q, k, v, rel_h, rel_w, (qh, qw),
                                         scale)

    out, lse = fwd()

    def bwd():
        return fr.flash_attention_relpos_bwd(q, k, v, rel_h, rel_w, out, lse,
                                             dout, (qh, qw), scale)

    real = {"fwd": (out, lse), "bwd": bwd()}
    results: Dict[str, Dict] = {"fwd": {}, "bwd": {}, "bwd_device_ms": {},
                                "full_bitwise_equal": {}}
    for what, fn, stages, source in (("fwd", fwd, FWD_STAGES, FWD_SOURCE),
                                     ("bwd", bwd, BWD_STAGES, BWD_SOURCE)):
        for stage in stages:
            with build.swapped({source: libs[f"{what}_{stage}"]}):
                if stage == "full":
                    got = fn()
                    torch.cuda.synchronize()
                    results["full_bitwise_equal"][what] = all(
                        torch.equal(a, b) for a, b in zip(got, real[what]))
                ms = _min_ms(fn, iters, reps)
                results[what][stage] = ms
                line = f"{what} {stage}: {ms:.4f} ms"
                if what == "bwd":
                    split = _k2_split(fn, iters)
                    results["bwd_device_ms"][stage] = split
                    line += " (device: " + (", ".join(
                        f"{n} {t:.4f}" for n, t in split.items())
                        if split else "not measured") + ")"
            print(line, flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--qh", type=int, default=56)
    ap.add_argument("--qw", type=int, default=28)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--block_q", type=int, default=None,
                    help="JAX's query tile; the CUDA kernels' tiles are "
                         "fixed at build time (K1 128 query rows, K2 128 "
                         "rows per CTA), so only those values are taken")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.block_q not in (None, 128):
        ap.error("--block_q: the CUDA kernels' query tile is 128 rows")
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(label)
    results = profile(args.qh, args.qw, args.batch, args.heads,
                      iters=args.iters, reps=args.reps)
    print("STAGE_PROFILE " + json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
