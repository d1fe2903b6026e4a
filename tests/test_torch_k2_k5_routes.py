"""PyTorch port: the routes that send Painter ViT-L's 1280x640 attention
backward to K2 and fp32 int8-fused serving to K5, on the CPU.

K2 takes a key grid up to kh + kw = 127, where its bf16 dq kernel's raw
rel-term staging fills the two ring stages it borrows: the limit derived
from ``csrc/flash_relpos_bwd.cu``'s own constants and the route swept
over every kw of the bf16 kernel's window. K5's plain version in fp32 at
a K5-route shape (a ragged M of 37 with zero rows, K 128, N 4096)
against the JAX Pallas kernel in interpret mode. Both wrappers on CPU tensors run their plain
versions and count no launch. Inputs are numpy from a seed.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.kernels.int8_mlp import int8_mlp as j_int8_mlp
from painter_tpu.ops import quant as jq
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.kernels import int8_mlp as k5

from test_torch_generic_widths import _mlp_args
from torch_port_common import t

GRID_1280 = (80, 40)
# the grid past K2 at head dim 64: kw 45 is past the bf16 d rel_w
# accumulator (KW_MAX 40) and kh + kw 135 past the raw rel-term staging
GRID_1440 = (90, 45)


def _cu_source():
    with open(os.path.join(build.CSRC, "flash_relpos_bwd.cu")) as f:
        return f.read()


def _cu_constant(name):
    found = re.findall(rf"constexpr (?:int|size_t) {name} = (\d+);",
                       _cu_source())
    assert found, name
    return {int(v) for v in found}


def _raw_stage_bytes(kh, kw, rows):
    """``raw_stage_bytes`` of csrc/flash_relpos_bwd.cu: rows' raw bf16
    rel_h, rel_w's block at the next 16 bytes past rel_h's room (n + 8
    elements), and rel_w's room."""
    return 2 * (((rows * kh + 8 + 7) & ~7) + rows * kw + 8)


def test_bwd_limit_at_the_1280_grid():
    """80x40 (120 entries) is within the limit, its staging 30,752 of the
    32,768 B of two ring stages; 87x40 is the last grid at kw 40 and
    88x40 (32,800 B) the first past it; 90x45 (135, 34,592 B) is past."""
    assert fr.BWD_MAX_REL_ENTRIES == 127
    room = 2 * 2 * 64 * 128
    assert _raw_stage_bytes(*GRID_1280, 128) == 30752 <= room
    assert _raw_stage_bytes(87, 40, 128) == 32544 <= room
    assert _raw_stage_bytes(88, 40, 128) == 32800 > room
    assert _raw_stage_bytes(*GRID_1440, 128) == 34592 > room
    for dtype in (torch.bfloat16, torch.float32):
        for grid, want in ((GRID_1280, "vitl"), ((87, 40), "vitl"),
                           ((88, 40), "generic"), (GRID_1440, "generic")):
            assert fr.attention_route(64, grid, grid[0] * grid[1], dtype,
                                      backward=True) == want, (grid, dtype)


def test_bwd_limit_reads_the_kernel_constants():
    """BWD_MAX_REL_ENTRIES is the largest kh + kw whose raw staging fits
    RAW_STAGE_ROOM at every kw of the bf16 window, reckoned from the
    constants and formulas the .cu file declares; the bf16 launcher
    refuses what exceeds it."""
    src = _cu_source()
    assert "return (n + 8 + 7) & ~7;" in src
    assert ("return 2 * ((size_t)raw_w_offset(DQ_ROWS * kh) + "
            "DQ_ROWS * kw + 8);") in src
    assert "RAW_STAGE_ROOM = 2 * (size_t)DQ_STAGE_BYTES;" in src
    assert "DQ_STAGE_BYTES = 2 * KVT_BYTES;" in src
    assert "KVT_BYTES = BT * 128;" in src
    assert "raw_stage_bytes(kh, kw) > RAW_STAGE_ROOM" in src
    (rows,), (bt,) = _cu_constant("DQ_ROWS"), _cu_constant("BT")
    assert _cu_constant("KW_MAX") == {fr.BWD_BF16_KW[1]}
    room = 2 * 2 * bt * 128
    for kw in range(fr.BWD_BF16_KW[0], fr.BWD_BF16_KW[1] + 1):
        last = max(kh for kh in range(1, 256)
                   if _raw_stage_bytes(kh, kw, rows) <= room)
        assert last + kw == fr.BWD_MAX_REL_ENTRIES, kw


@pytest.mark.parametrize("kw", range(fr.BWD_BF16_KW[0],
                                     fr.BWD_BF16_KW[1] + 1))
def test_bwd_route_follows_the_layouts(kw):
    """Every kh up to 200 at this kw: ``"vitl"`` in both types exactly
    where the bf16 raw staging fits its two ring stages (kh + kw <= 127),
    and so wherever K2 took the grid before (kh + kw <= 110)."""
    room = 2 * 2 * 64 * 128
    for kh in range(1, 201):
        fits = _raw_stage_bytes(kh, kw, 128) <= room
        assert fits == (kh + kw <= 127), (kh, kw)
        for dtype in (torch.bfloat16, torch.float32):
            want = "vitl" if fits else "generic"
            assert fr.attention_route(64, (kh, kw), kh * kw, dtype,
                                      backward=True) == want, (kh, kw)
        if kh + kw <= 110:
            assert fits


@pytest.mark.parametrize("block_m", [16, 64])
def test_k5_fp32_plain_matches_jax_kernel(block_m):
    """fp32 x at a K5 shape (K 128, N 4096; M 37, ragged, with zero rows):
    ``int8_mlp_route`` names K5 and its plain version == the JAX Pallas
    kernel in interpret mode, held as tests/test_torch_generic_widths.py
    holds fp32 (within one bf16 step of max |out| everywhere, and within
    1e-5 x max |out| on all rows but at most one, which one fp32 ulp of a
    hidden value across a requantization boundary may move)."""
    m, k, n = 37, 128, k5.HIDDEN
    assert k5.int8_mlp_route(k, n, torch.float32) == "vitl"
    fc1, fc2, x, args = _mlp_args(m, k, n, 21, torch.float32, (0, 5, 36))
    ref = np.asarray(j_int8_mlp(jnp.asarray(x, jnp.float32),
                                jq.quantize_linear_params(fc1),
                                jq.quantize_linear_params(fc2),
                                block_m=block_m, interpret=True), np.float32)
    got = k5.int8_mlp(*args)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    got = got.numpy()
    assert np.isfinite(got).all()
    diff, top = np.abs(got - ref), np.abs(ref).max()
    assert diff.max() <= 2.0 ** -7 * top, diff.max()
    rows = np.unique(np.nonzero(diff > 1e-5 * top)[0])
    assert rows.size <= 1, (rows, diff.max() / top)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_dispatch_runs_the_plain_versions(dtype):
    """On CPU tensors K2's wrapper at 80x40 and K5's at ViT-L's fp32 /
    bf16 widths run the plain versions, bit for bit, and count no launch
    on any route."""
    counters = (fr.flash_attention_relpos_bwd,
                fr.flash_attention_relpos_bwd_generic, k5.int8_mlp,
                k5.int8_mlp_generic)
    before = [f.launches for f in counters]
    rng = np.random.RandomState(5)
    length = GRID_1280[0] * GRID_1280[1]
    q, k, v, dout = (t(rng.randn(1, length, 64)).to(dtype) for _ in range(4))
    rel_h = t(rng.randn(1, length, GRID_1280[0])).to(dtype)
    rel_w = t(rng.randn(1, length, GRID_1280[1])).to(dtype)
    assert fr.attention_route(64, GRID_1280, length, dtype,
                              backward=True) == "vitl"
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   GRID_1280, 0.125)
    args = (q, k, v, rel_h, rel_w, out, lse, dout, GRID_1280, 0.125)
    for got, want in zip(fr.flash_attention_relpos_bwd(*args),
                         fr.flash_attention_relpos_bwd_reference(*args)):
        assert got.dtype == dtype and torch.equal(got, want)

    *_, margs = _mlp_args(24, 1024, k5.HIDDEN, 9, dtype, (3,))
    assert k5.int8_mlp_route(1024, k5.HIDDEN, dtype) == "vitl"
    assert torch.equal(k5.int8_mlp(*margs), k5.int8_mlp_reference(*margs))
    assert [f.launches for f in counters] == before
