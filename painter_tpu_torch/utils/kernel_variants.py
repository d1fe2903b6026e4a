"""Design variants of the port's CUDA kernels, timed against the real ones.

A variant is a set of string edits to a copy of ``kernels/csrc`` (each
edited string must occur exactly once in its file), built by the same
``nvcc`` command as the real kernel into a library of its own under
``kernels/_build/variants/``, and swapped in under the real wrapper, so the
wrapper's checks and launch are the ones the port runs. Each variant is
held against the plain version (max abs error over max |plain|, and two
runs bitwise equal) and timed in turns with the real kernel on the same
inputs (real, variants, variants reversed, real).

K3's variants (the decoder-tail forward at the trainer's (2, 896, 448, 64)
bf16, both GELU flavours):

- ``tanhf``: the tanh GELU on the accurate ``tanhf`` instead of
  ``tanh.approx.f32``;
- ``two_rows``: two rows in flight per consumer warpgroup: row r + 2's
  products are issued into a second accumulator before row r's epilogue
  (strips of at least 4 rows, so that the rows pair up);
- ``flavour_branch``: one row body for both GELU flavours, branching on
  the flavour per element instead of once per row.

K4's (the backward, tanh): ``flavour_branch`` in the du launch.

``utils/kernel_stage_profile.py`` builds K1's and K2's stage-dropped
variants on the same mechanism (:func:`apply_edits`, :func:`build_variants`
and ``kernels/build.py``'s ``swapped``).

With ``--against DIR`` (the root of another checkout, e.g. ``git archive``
of a parent commit unpacked), K3 and K4 built from DIR's sources are timed
in turns with this checkout's (other, this, this, other), and so are K3g
and K4g in bf16 (tanh) at ``GENERIC_SHAPES``: DIR's tensor-core sources
(``decoder_tail_tc_*.cu``) under this checkout's wrappers
(``fused_decoder_tail_tc`` / ``fused_decoder_tail_bwd_tc``), and K1g /
K2g at ``ATTENTION_SHAPES`` in both types: DIR's
``flash_relpos_generic.cu`` under DIR's own wrappers
(``kernels/flash_relpos.py`` loaded from DIR, so that builds with other
entry-point arguments compare), K3g / K4g at C <= 8 at ``NARROW_SHAPES``
in both types: DIR's ``decoder_tail_generic.cu`` under DIR's own wrappers
(``kernels/decoder_head.py`` loaded from DIR), and K5g at ``K5G_SHAPES``
in both types: DIR's ``int8_mlp_generic.cu`` under DIR's own
``int8_mlp_generic``
(``kernels/int8_mlp.py`` loaded from DIR).

    python -m painter_tpu_torch.utils.kernel_variants [--iters 50]
        [--against DIR]

Each turn reports ``ms`` (CUDA events per wrapper call, the wrapper's host
work included where the host is the slower side) and ``device_ms`` (the
tail kernels' device time per call, torch.profiler).

Needs a CUDA device and ``nvcc``; prints one line per measurement and a
JSON line last.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import decoder_head as dh
from painter_tpu_torch.utils.cuda_timing import device_ms_by_kernel, event_ms

Edits = Dict[str, List[Tuple[str, str]]]

_TWO_ROWS_LOOP_OLD = """      for (int r = wg; r < R; r += 2) {
        issue(acc, r);
        wgmma_wait0();
        fence_regs(acc);
        retire(r);
        epi.row(acc, b, y0 + r, x0, sp, aux, out);
      }
"""
_TWO_ROWS_LOOP_NEW = """      for (int r = wg; r < R; r += 4) {
        issue(acc, r);
        issue(acc2, r + 2);
        wgmma_wait<TAPS>();
        fence_regs(acc);
        retire(r);
        epi.row(acc, b, y0 + r, x0, sp, aux, out);
        wgmma_wait0();
        fence_regs(acc2);
        retire(r + 2);
        epi.row(acc2, b, y0 + r + 2, x0, sp, aux, out);
      }
"""
# strips of at least 4 rows: every warpgroup's rows then pair up, so the
# second issue is unconditional (a conditional one made ptxas serialize
# the wgmma, note C7518)
_R_MIN_OLD = "while (sp.R > 2 && "
_R_MIN_NEW = "while (sp.R > 4 && "
_ACC_OLD = """    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
"""
_ACC_NEW = """    float acc[32], acc2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = acc2[i] = 0.f;
"""

# name -> (source, edits)
K3_VARIANTS: Dict[str, Tuple[str, Edits]] = {
    "tanhf": ("decoder_tail_fwd", {"decoder_tail_fwd.cu": [
        ("(1.0f + tanh_approx(", "(1.0f + tanhf(")]}),
    "two_rows": ("decoder_tail_fwd", {"decoder_tail_hopper.cuh": [
        (_ACC_OLD, _ACC_NEW), (_TWO_ROWS_LOOP_OLD, _TWO_ROWS_LOOP_NEW),
        (_R_MIN_OLD, _R_MIN_NEW)]}),
    # one row body for both GELU flavours, branching on the flavour per
    # element
    "flavour_branch": ("decoder_tail_fwd", {"decoder_tail_fwd.cu": [
        ("    else row_as<false>(acc, b, y, x0, sp, out);\n", ""),
        ("    if (approx) row_as<true>(acc, b, y, x0, sp, out);",
         "    row_as<true>(acc, b, y, x0, sp, out);"),
        ("gelu_bf16_route(n, APPROX)", "gelu_bf16_route(n, approx)")]}),
}
K4_VARIANTS: Dict[str, Tuple[str, Edits]] = {
    "flavour_branch": ("decoder_tail_bwd", {"decoder_tail_bwd.cu": [
        ("    else row_as<false>(acc, b, y, x0, sp, go, out);\n", ""),
        ("    if (approx) row_as<true>(acc, b, y, x0, sp, go, out);",
         "    row_as<true>(acc, b, y, x0, sp, go, out);"),
        ("gelu_and_grad(n, APPROX, gl, gd)",
         "gelu_and_grad(n, approx, gl, gd)")]}),
}
# the decoder tail's device kernels, and K4's du / dpix launches as an
# earlier design named them
TAIL_KERNELS = (*dh.KERNEL_NAMES, "conv_kernel")
# K3g / K4g's --against shapes ((B, H, W), C): the wide ViT-L update's
# decoder and tiny_test's pixels at a 160-channel decoder
GENERIC_SHAPES = (((1, 896, 448), 256), ((2, 64, 32), 160))
# K1g / K2g's --against shapes (BH, hd, grid, types): tiny_test's training
# shape and its 2x2 windows, where a call is launch-bound, and the
# full-size 80x40 and 90x45 grids in bf16
ATTENTION_SHAPES = ((4, 16, (8, 4), (torch.bfloat16, torch.float32)),
                    (64, 16, (2, 2), (torch.bfloat16, torch.float32)),
                    (16, 64, (80, 40), (torch.bfloat16,)),
                    (16, 64, (90, 45), (torch.bfloat16,)))
ATTENTION_KERNELS = ("fwd_kernel", "dq_kernel", "dkv_kernel")
# the narrow route's --against shapes ((B, H, W), C): tiny_test's decoder
# at its b2 training shape and an 8-channel decoder at Painter ViT-L's
# 896x448 b2
NARROW_SHAPES = (((2, 64, 32), 8), ((2, 896, 448), 8))
# K5g's --against shapes (M, K, N): tiny_test's MLP, b1-sized M 1 and 16
# (the JAX kernel test's K 128 / N 256) and a ViT-B-wide SegGPT's b8
# trunk, where a call is launch-bound and where it is not
K5G_SHAPES = ((64, 32, 128), (1, 128, 256), (16, 128, 256),
              (12544, 768, 3072))
# K5g's device kernels in this checkout and in the scalar design before it
K5G_KERNELS = ("quant_rows", "tc_gemm", "gemm_kernel")


def apply_edits(edits: Edits, dst: str, csrc: str = build.CSRC) -> None:
    """Copy ``csrc`` to ``dst`` and apply ``edits``; raises if an edited
    string does not occur exactly once."""
    shutil.copytree(csrc, dst)
    for fname, pairs in edits.items():
        path = os.path.join(dst, fname)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"{fname}: the edit's string occurs "
                                 f"{text.count(old)} times: {old[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)


def build_variants(variants: Dict[str, Tuple[str, Edits]],
                   csrc: str = build.CSRC) -> Dict[str, str]:
    """Build every variant (edits of a copy of ``csrc``) at once, one
    ``nvcc`` each; {name: library}."""
    root = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(root, exist_ok=True)
    procs = {}
    for name, (source, edits) in variants.items():
        src = os.path.join(root, f"{source}-{name}")
        shutil.rmtree(src, ignore_errors=True)
        apply_edits(edits, src, csrc)
        lib = src + ".so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"# ptxas {name}: {line.strip()}")
        if proc.returncode:
            failed.append(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = lib
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def tail_inputs(shape=(2, 896, 448), seed=200, c=dh.CHANNELS):
    """bf16 pixels and upstream gradient, fp32 parameters at ``shape`` and
    width ``c`` from ``seed``, scaled as ``chip_smoke.py``'s tail case."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w = shape

    def rnd(*sh, scale=1.0, shift=0.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale + shift

    pix = rnd(b, h, w, c).to(torch.bfloat16)
    params = (rnd(c, c, 3, 3, scale=(9 * c) ** -0.5), rnd(c, scale=0.1),
              rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1),
              rnd(3, c, 1, 1, scale=c ** -0.5), rnd(3, scale=0.1))
    go = rnd(b, h, w, 3).to(torch.bfloat16)
    return pix, params, go


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _measure(what, variant, libs, fn, ref, iters, names=TAIL_KERNELS):
    """One turn: ``fn`` on ``libs`` against ``ref``, then its times (device
    time of the kernels named ``names``)."""
    with build.swapped(libs):
        out, again = _tuple(fn()), _tuple(fn())
        torch.cuda.synchronize()
        row = {"kernel": what, "variant": variant,
               "rel_err": max(((a.float() - r.float()).abs().max()
                               / r.float().abs().max()).item()
                              for a, r in zip(out, _tuple(ref))),
               "repeatable": all(torch.equal(a, x)
                                 for a, x in zip(out, again)),
               "ms": event_ms(fn, iters, warmup=3),
               "device_ms_by_kernel": device_ms_by_kernel(fn, iters,
                                                          names)}
    by_kernel = row["device_ms_by_kernel"]
    row["device_ms"] = sum(by_kernel.values()) if by_kernel else None
    dev = ("not measured" if row["device_ms"] is None else
           f"{row['device_ms']:.4f} ("
           + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()) + ")")
    print(f"# {what} {variant}: ms {row['ms']:.4f} device_ms {dev} "
          f"err/max|plain| {row['rel_err']:.2e} two runs equal "
          f"{row['repeatable']}", flush=True)
    return row


def _turns(what, fn, ref, libs, source, iters):
    """The kernel and each variant of ``libs`` in turns: kernel, variants,
    variants reversed, kernel."""
    return [_measure(what, name,
                     {} if name == "kernel" else {source: libs[name]},
                     fn, ref, iters)
            for name in ["kernel", *libs, *reversed(list(libs)), "kernel"]]


def run(iters: int, against: str = "") -> List[dict]:
    """K3's variants in turns with the kernel, both GELU flavours; K4's,
    tanh; with ``against`` (the root of another checkout), K3 and K4 built
    from its sources in turns with this checkout's."""
    k3_libs = build_variants(K3_VARIANTS)
    k4_libs = build_variants(K4_VARIANTS)
    parent = build_variants(
        {"against_fwd": ("decoder_tail_fwd", {}),
         "against_bwd": ("decoder_tail_bwd", {})},
        os.path.join(against, "painter_tpu_torch", "kernels", "csrc")
    ) if against else {}
    pix, params, go = tail_inputs()
    k3 = {approx: (functools.partial(dh.fused_decoder_tail, pix, *params,
                                     approx),
                   dh.fused_decoder_tail_reference(pix, *params, approx))
          for approx in (True, False)}
    k4 = (functools.partial(dh.fused_decoder_tail_bwd, pix, *params[:5], go,
                            True),
          dh.fused_decoder_tail_bwd_reference(pix, *params[:5], go, True))
    shape = "bf16 (2, 896, 448)"
    rows = []
    for approx, (fn, ref) in k3.items():
        rows += _turns(f"K3 {shape} {'tanh' if approx else 'erf'}", fn, ref,
                       k3_libs, "decoder_tail_fwd", iters)
    rows += _turns(f"K4 {shape} tanh", *k4, k4_libs, "decoder_tail_bwd",
                   iters)
    if parent:
        use = {"decoder_tail_fwd": parent["against_fwd"],
               "decoder_tail_bwd": parent["against_bwd"]}
        for what, (fn, ref) in ((f"K3 {shape} tanh", k3[True]),
                                (f"K4 {shape} tanh", k4)):
            for name in ("against", "kernel", "kernel", "against"):
                rows.append(_measure(what, name,
                                     {} if name == "kernel" else use,
                                     fn, ref, iters))
    if against:
        rows += narrow_against(against, iters)
        rows += generic_against(against, max(2, iters // 10))
        rows += attention_against(against, max(2, iters // 10))
        rows += k5g_against(against, iters)
    return rows


def generic_against(against: str, iters: int) -> List[dict]:
    """K3g and K4g (bf16, tanh) at ``GENERIC_SHAPES`` built from the
    tensor-core sources of the checkout at ``against`` in turns with this
    checkout's (other, this, this, other); the wrapper's host work is in
    ``ms``."""
    csrc = os.path.join(against, "painter_tpu_torch", "kernels", "csrc")
    sources = ("decoder_tail_tc_fwd", "decoder_tail_tc_bwd")
    built = build_variants({f"against_{name}": (name, {})
                            for name in sources}, csrc)
    use = {name: built[f"against_{name}"] for name in sources}
    rows = []
    for shape, c in GENERIC_SHAPES:
        pix, params, go = tail_inputs(shape, 610, c)
        for what, fn, ref in (
                (f"K3g bf16 {shape} C={c} tanh",
                 functools.partial(dh.fused_decoder_tail_tc, pix, *params,
                                   True),
                 dh.fused_decoder_tail_reference(pix, *params, True)),
                (f"K4g bf16 {shape} C={c} tanh",
                 functools.partial(dh.fused_decoder_tail_bwd_tc, pix,
                                   *params[:5], go, True),
                 dh.fused_decoder_tail_bwd_reference(pix, *params[:5], go,
                                                     True))):
            for name in ("against", "kernel", "kernel", "against"):
                rows.append(_measure(
                    what, name, use if name == "against" else {}, fn, ref,
                    iters, dh.TC_KERNEL_NAMES + ("reduce_kernel",)))
        del pix, params, go
        torch.cuda.empty_cache()
    return rows


def narrow_against(against: str, iters: int) -> List[dict]:
    """K3g and K4g at C <= 8 (``generic_tail_route``'s "narrow") at
    ``NARROW_SHAPES`` in bf16 and fp32 (tanh) built from the checkout at
    ``against`` (its ``decoder_tail_generic.cu``, launched by its own
    ``kernels/decoder_head.py`` wrappers) in turns with this checkout's
    (other, this, this, other), each held to the plain versions;
    ``device_ms`` counts every kernel a call launches (the packing launch,
    the wrapper's sums and pads included)."""
    root = os.path.join(against, "painter_tpu_torch", "kernels")
    built = build_variants({"against_narrow": ("decoder_tail_generic", {})},
                           os.path.join(root, "csrc"))
    use = {"decoder_tail_generic": built["against_narrow"]}
    other = _load_module(os.path.join(root, "decoder_head.py"),
                         "against_decoder_head")
    rows = []
    for shape, c in NARROW_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            pix, params, go = tail_inputs(shape, 640, c)
            pix, go = pix.to(dtype), go.to(dtype)
            kind = f"{str(dtype)[6:]} {shape} C={c} tanh"
            calls = iters if shape[1] * shape[2] > 1e5 else 4 * iters
            for what, fns, args, ref in (
                    (f"K3g {kind}", (other.fused_decoder_tail_generic,
                                     dh.fused_decoder_tail_generic),
                     (pix, *params, True),
                     dh.fused_decoder_tail_reference(pix, *params, True)),
                    (f"K4g {kind}", (other.fused_decoder_tail_bwd_generic,
                                     dh.fused_decoder_tail_bwd_generic),
                     (pix, *params[:5], go, True),
                     dh.fused_decoder_tail_bwd_reference(pix, *params[:5],
                                                         go, True))):
                for name in ("against", "kernel", "kernel", "against"):
                    rows.append(_measure(
                        what, name, use if name == "against" else {},
                        functools.partial(fns[name == "kernel"], *args),
                        ref, calls, ("",)))
            del pix, params, go
            torch.cuda.empty_cache()
    return rows


def attention_against(against: str, iters: int) -> List[dict]:
    """K1g and K2g at ``ATTENTION_SHAPES`` built from the checkout at
    ``against`` (its ``flash_relpos_generic.cu``, launched by its own
    wrappers) in turns with this checkout's (other, this, this, other),
    each held to the plain versions."""
    from painter_tpu_torch.kernels import flash_relpos as fr
    root = os.path.join(against, "painter_tpu_torch", "kernels")
    built = build_variants({"against_attention": ("flash_relpos_generic",
                                                  {})},
                           os.path.join(root, "csrc"))
    use = {"flash_relpos_generic": built["against_attention"]}
    other = _load_module(os.path.join(root, "flash_relpos.py"),
                         "against_flash_relpos")
    rows = []
    for bh, hd, grid, dtypes in ATTENTION_SHAPES:
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(620)
            length = grid[0] * grid[1]
            q, k, v, dout = (torch.randn(bh, length, hd, generator=g,
                                         device="cuda").to(dtype)
                             for _ in range(4))
            rel = [torch.randn(bh, length, n, generator=g,
                               device="cuda").to(dtype) for n in grid]
            scale = hd ** -0.5
            fargs = (q, k, v, *rel, grid, scale)
            out, lse = fr.flash_attention_relpos_reference(*fargs)
            bargs = (q, k, v, *rel, out, lse, dout, grid, scale)
            bref = fr.flash_attention_relpos_bwd_reference(*bargs)
            kind = f"{str(dtype)[6:]} BH {bh} hd {hd} {grid[0]}x{grid[1]}"
            for what, fns, fargs_, ref in (
                    (f"K1g {kind}", (other.flash_attention_relpos_generic,
                                     fr.flash_attention_relpos_generic),
                     fargs, out),
                    (f"K2g {kind}", (other.flash_attention_relpos_bwd_generic,
                                     fr.flash_attention_relpos_bwd_generic),
                     bargs, bref)):
                # K1g's error is its out's (the first of out, lse)
                for name in ("against", "kernel", "kernel", "against"):
                    rows.append(_measure(
                        what, name, use if name == "against" else {},
                        functools.partial(fns[name == "kernel"], *fargs_),
                        ref, iters, ATTENTION_KERNELS))
            del q, k, v, dout, rel, out, lse, bref
            torch.cuda.empty_cache()
    return rows


def _load_module(path: str, name: str):
    """The Python module at ``path`` (another checkout's wrapper)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k5g_against(against: str, iters: int) -> List[dict]:
    """K5g at ``K5G_SHAPES`` in bf16 and fp32 built from the checkout at
    ``against`` (its ``int8_mlp_generic.cu``, launched by its own
    ``int8_mlp_generic``) in turns with this checkout's (other, this,
    this, other), each held to the plain version; the launch-bound shapes
    over 4x ``iters`` calls a turn."""
    from painter_tpu_torch.kernels import int8_mlp as k5
    from painter_tpu_torch.ops import quant
    root = os.path.join(against, "painter_tpu_torch", "kernels")
    built = build_variants({"against_k5g": ("int8_mlp_generic", {})},
                           os.path.join(root, "csrc"))
    use = {"int8_mlp_generic": built["against_k5g"]}
    other = _load_module(os.path.join(root, "int8_mlp.py"),
                         "against_int8_mlp")
    rows = []
    for m, k, n in K5G_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(630)
            lins = []
            for k_in, k_out in ((k, n), (n, k)):
                lin = torch.nn.Linear(k_in, k_out, device="cuda")
                with torch.no_grad():
                    lin.weight.normal_(0.0, 0.02, generator=g)
                    lin.bias.normal_(0.0, 0.02, generator=g)
                lins.append(quant.QuantizedLinear.from_linear(lin))
            x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
            args = (x, lins[0].weight.q, lins[0].weight.scale, lins[0].bias,
                    lins[1].weight.q, lins[1].weight.scale, lins[1].bias)
            ref = k5.int8_mlp_reference(*args)
            what = f"K5g {str(dtype)[6:]} M {m} K {k} N {n}"
            calls = iters if m * k * n > 1e9 else 4 * iters
            for name in ("against", "kernel", "kernel", "against"):
                fn = (other if name == "against" else k5).int8_mlp_generic
                rows.append(_measure(
                    what, name, use if name == "against" else {},
                    functools.partial(fn, *args), ref, calls, K5G_KERNELS))
            del x, lins, args, ref
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--against", default="",
                        help="root of another checkout whose decoder-tail, "
                             "generic attention and K5g kernels are timed "
                             "in turns with these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(label)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = run(args.iters, args.against)
    print(json.dumps({"card": label, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
