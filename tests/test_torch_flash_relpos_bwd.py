"""PyTorch port: K2 (attention backward with a decomposed rel-pos bias).

Its plain version against torch autograd of the plain forward, and the
port's autograd Function (K1 forward, K2 backward, the rel-term einsum in
autograd) against JAX: ``jax.grad`` of the Pallas kernel in interpret mode
at one tiny shape, and of the JAX stock attention op on ragged grids and
a grid with kh != 2 * kw. fp32: tolerance 1e-5 relative to each
gradient's max abs (the sums run in another order than JAX's). bf16: the
Function against jax.grad of the Pallas kernel in bf16, and the rounding
points the CUDA kernel copies (P and dS rounded to bf16 before dv, dq, dk
and the rel-bias sums) pinned exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from painter_tpu.kernels.flash_relpos import (
    flash_attention_relpos as j_flash)
from painter_tpu.ops import attention as j_att
from painter_tpu_torch.kernels import build
from painter_tpu_torch.kernels import flash_relpos as fr
from painter_tpu_torch.ops import attention as t_att

from torch_port_common import t

RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, err


def _rel_inputs(bh, grid, hd=16, seed=0):
    """Seeded (q, k, v, rel_h, rel_w, dout) as CPU tensors."""
    rng = np.random.RandomState(seed)
    length = grid[0] * grid[1]
    q, k, v, dout = (t(rng.randn(bh, length, hd)) for _ in range(4))
    rel_h = t(rng.randn(bh, length, grid[0]))
    rel_w = t(rng.randn(bh, length, grid[1]))
    return q, k, v, rel_h, rel_w, dout


@pytest.mark.parametrize("grid", [(8, 4), (12, 6), (7, 5)])
def test_plain_bwd_matches_autograd_of_plain_fwd(grid):
    """(dq, dk, dv, d rel_h, d rel_w) from the saved lse == autograd."""
    q, k, v, rel_h, rel_w, dout = _rel_inputs(3, grid, seed=1)
    scale = 16 ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v, rel_h, rel_w)]
    out, lse = fr.flash_attention_relpos_reference(*leaves, grid, scale)
    ref = torch.autograd.grad(out, leaves, dout)
    got = fr.flash_attention_relpos_bwd_reference(
        q, k, v, rel_h, rel_w, out.detach(), lse.detach(), dout, grid, scale)
    for g, r in zip(got, ref):
        _close(g.numpy(), r.numpy())


def test_function_matches_jax_kernel_grad_interpret():
    """jax.grad of the Pallas kernel (interpret mode on the CPU) w.r.t.
    q, k, v and both tables == the port's Function + rel-term autograd."""
    rng = np.random.RandomState(2)
    grid, hd = (8, 4), 16
    length = grid[0] * grid[1]
    q, k, v, g = (rng.randn(1, 2, length, hd).astype(np.float32)
                  for _ in range(4))
    rph = rng.randn(15, hd).astype(np.float32)
    rpw = rng.randn(7, hd).astype(np.float32)

    def j_loss(*a):
        out = j_flash(*a, grid, grid, hd ** -0.5, block_q=8,
                      exp2_impl="native")
        return jnp.sum(out * g)

    ref = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, rph, rpw)))
    leaves = [t(a).requires_grad_() for a in (q, k, v, rph, rpw)]
    tq, tk, tv, trph, trpw = leaves
    rel_h, rel_w = t_att.rel_pos_bias(tq, trph, trpw, grid, grid)
    out, _ = fr.flash_attention_relpos_fn(
        tq.reshape(2, length, hd), tk.reshape(2, length, hd),
        tv.reshape(2, length, hd), rel_h.reshape(2, length, grid[0]),
        rel_w.reshape(2, length, grid[1]), grid, hd ** -0.5)
    got = torch.autograd.grad(out.reshape(1, 2, length, hd), leaves, t(g))
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


# bf16 gradients against jax.grad of the JAX kernel in bf16, max abs error
# over max |JAX| per gradient: both round every activation to 8 mantissa
# bits at other points (JAX pre-rounds q * scale * log2e and the rel terms,
# the forward's unnormalized probabilities and the per-block outputs), and
# the rel-table gradients pass through the rel-term einsum's backward in
# bf16; measured 4.5e-3 to 2.4e-2 (dq) on these inputs
BF16_GRAD_RTOL = 5e-2


@pytest.mark.parametrize("grid,table", [((8, 4), (8, 4)), ((7, 5), (7, 5))])
def test_function_bf16_matches_jax_kernel_grad_interpret(grid, table):
    rng = np.random.RandomState(8)
    hd = 16
    length = grid[0] * grid[1]

    def bf16_exact(*shape):
        return t(rng.randn(*shape)).to(torch.bfloat16).float().numpy()

    q, k, v, g = (bf16_exact(1, 2, length, hd) for _ in range(4))
    rph = bf16_exact(2 * table[0] - 1, hd)
    rpw = bf16_exact(2 * table[1] - 1, hd)

    def j_loss(*a):
        out = j_flash(*a, grid, grid, hd ** -0.5, block_q=8,
                      exp2_impl="native")
        return jnp.sum(out.astype(jnp.float32) * g)

    ref = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, rph, rpw)))
    leaves = [t(a, torch.bfloat16).requires_grad_()
              for a in (q, k, v, rph, rpw)]
    tq, tk, tv, trph, trpw = leaves
    rel_h, rel_w = t_att.rel_pos_bias(tq, trph, trpw, grid, grid)
    out, _ = fr.flash_attention_relpos_fn(
        tq.reshape(2, length, hd), tk.reshape(2, length, hd),
        tv.reshape(2, length, hd), rel_h.reshape(2, length, grid[0]),
        rel_w.reshape(2, length, grid[1]), grid, hd ** -0.5)
    got = torch.autograd.grad(
        (out.reshape(1, 2, length, hd).float() * t(g)).sum(), leaves)
    for a, b in zip(got, ref):
        _close(a.float().numpy(), np.asarray(b, np.float32),
               rtol=BF16_GRAD_RTOL)


@pytest.mark.parametrize("grid", [(8, 4), (7, 5)])
def test_plain_bwd_bf16_rounds_p_and_ds(grid):
    """The rounding points K2's bf16 kernel copies, exact on the CPU: dv
    from bf16 P; dq, dk and both rel-bias gradients from bf16 dS (the JAX
    kernel's ds_b). Summing the unrounded dS gives other rel gradients."""
    q, k, v, rel_h, rel_w, dout = (
        x.to(torch.bfloat16) for x in _rel_inputs(2, grid, seed=9))
    scale = 0.25
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   grid, scale)
    dq, dk, dv, drh, drw = fr.flash_attention_relpos_bwd_reference(
        q, k, v, rel_h, rel_w, out, lse, dout, grid, scale)
    length = grid[0] * grid[1]
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    s = (s.view(2, length, *grid) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(2, length, length)
    p = torch.exp(s - lse[..., None])
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dout.float(), v.float().transpose(1, 2)) - delta)
    dsr = ds.to(torch.bfloat16).float()
    bf = torch.bfloat16
    assert torch.equal(dv, torch.matmul(p.to(bf).float().transpose(1, 2),
                                        dout.float()).to(bf))
    assert torch.equal(dq, (torch.matmul(dsr, k.float()) * scale).to(bf))
    assert torch.equal(dk, (torch.matmul(dsr.transpose(1, 2), q.float())
                            * scale).to(bf))
    ds4 = dsr.view(2, length, *grid)
    assert torch.equal(drh, ds4.sum(-1).to(bf))
    assert torch.equal(drw, ds4.sum(-2).to(bf))
    unrounded = ds.view(2, length, *grid)
    assert not (torch.equal(drh, unrounded.sum(-1).to(bf))
                and torch.equal(drw, unrounded.sum(-2).to(bf)))


def _attention_grads_jax(x, wq, bq, wp, bp, rph, rpw, nh, grid, g):
    def loss(x, wq, bq, wp, bp, rph, rpw):
        out = j_att.attention(x, {"qkv": {"kernel": wq, "bias": bq},
                                  "proj": {"kernel": wp, "bias": bp}},
                              nh, grid, rel_pos=(rph, rpw), impl="xla")
        return jnp.sum(out * g)
    return jax.grad(loss, argnums=tuple(range(7)))(
        *map(jnp.asarray, (x, wq, bq, wp, bp, rph, rpw)))


@pytest.mark.parametrize("grid,table", [
    ((8, 4), (8, 4)),     # the kernel's rel tables as initialized
    ((12, 6), (8, 4)),    # table interpolation, ragged L=72
    ((7, 5), (7, 5)),     # kh != 2 * kw, ragged L=35
])
def test_attention_grads_reach_qkv_and_tables(grid, table):
    """The port's attention op differentiates through the autograd
    Function: its gradients w.r.t. x, the qkv and proj weights and both
    rel-pos tables match the JAX stock path. (Before the Function, the
    kernel's output had no autograd history on the card, so nothing
    upstream of it got a gradient through attention.)"""
    rng = np.random.RandomState(3)
    c, nh = 32, 2
    x = rng.randn(2, *grid, c).astype(np.float32)
    wq = (rng.randn(c, 3 * c) * 0.2).astype(np.float32)
    bq = rng.randn(3 * c).astype(np.float32)
    wp = (rng.randn(c, c) * 0.2).astype(np.float32)
    bp = rng.randn(c).astype(np.float32)
    rph = rng.randn(2 * table[0] - 1, c // nh).astype(np.float32)
    rpw = rng.randn(2 * table[1] - 1, c // nh).astype(np.float32)
    g = rng.randn(2, *grid, c).astype(np.float32)
    ref = _attention_grads_jax(x, wq, bq, wp, bp, rph, rpw, nh, grid, g)
    # the port keeps torch's (out, in) weight layout
    leaves = [t(a).requires_grad_()
              for a in (x, wq.T, bq, wp.T, bp, rph, rpw)]
    out = t_att.attention(leaves[0], *leaves[1:5], nh, grid,
                          rel_pos=(leaves[5], leaves[6]),
                          attn_impl="kernel")
    got = torch.autograd.grad(out, leaves, t(g))
    names = ("x", "qkv weight", "qkv bias", "proj weight", "proj bias",
             "rel_pos_h", "rel_pos_w")
    for name, a, b in zip(names, got, ref):
        b = np.asarray(b)
        if name.endswith("weight"):
            b = b.T
        assert np.abs(a.numpy()).max() > 0, name
        _close(a.numpy(), b)


def test_attention_output_is_the_function_and_saves_its_residuals():
    q, k, v, rel_h, rel_w, _ = _rel_inputs(2, (8, 4), seed=4)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, rel_h, rel_w)]
    out, lse = fr.flash_attention_relpos_fn(*leaves, (8, 4), 0.25)
    assert type(out.grad_fn).__name__ == "FlashAttentionRelposBackward"
    assert not lse.requires_grad
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7  # (q, k, v, rel_h, rel_w, out, lse)
    assert torch.equal(saved[5], out.detach())
    assert torch.equal(saved[6], lse)


def test_cpu_bwd_runs_plain_and_counts_no_launch():
    q, k, v, rel_h, rel_w, dout = _rel_inputs(2, (7, 5), seed=5)
    out, lse = fr.flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                   (7, 5), 0.25)
    args = (q, k, v, rel_h, rel_w, out, lse, dout, (7, 5), 0.25)
    before = fr.flash_attention_relpos_bwd.launches
    got = fr.flash_attention_relpos_bwd(*args)
    ref = fr.flash_attention_relpos_bwd_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fr.flash_attention_relpos_bwd.launches == before


def _bwd_kernel_args(dtype=torch.bfloat16):
    bh, length, kh, kw = 2, 1568, 56, 28
    z = torch.zeros(bh, length, 64, dtype=dtype)
    return dict(q=z, k=z.clone(), v=z.clone(),
                rel_h=torch.zeros(bh, length, kh, dtype=dtype),
                rel_w=torch.zeros(bh, length, kw, dtype=dtype),
                k_size=(kh, kw), out=z.clone(), dout=z.clone(),
                lse=torch.zeros(bh, length))


@pytest.mark.parametrize("change,match", [
    (dict(lse=torch.zeros(2, 1568, dtype=torch.bfloat16)), "lse is"),
    (dict(dout=torch.zeros(2, 64, 1568, dtype=torch.bfloat16)
          .transpose(1, 2)), "contiguous"),
    (dict(out=torch.zeros(2, 1568, 64)), "out is"),
    (dict(k_size=(70, 35), q=torch.zeros(2, 2450, 64)), "shape"),
])
def test_bwd_kernel_input_checks(change, match):
    """What the CUDA wrapper of K2 refuses before it would launch."""
    kw = {**_bwd_kernel_args(), **change}
    with pytest.raises((ValueError, TypeError), match=match):
        fr._check(kw["q"], kw["k"], kw["v"], kw["rel_h"], kw["rel_w"],
                  kw["k_size"], out=kw["out"], dout=kw["dout"],
                  lse=kw["lse"])


def test_bwd_rel_entries_limit():
    """The ViT-L K2 takes a grid up to kh + kw = 127, where its bf16 dq
    kernel's raw rel-term staging fills its two 16 KiB ring stages: 80x40
    (the trainer at --input_size 1280 640, 120 rel-term entries) fits;
    90x45 (135) goes to K2g; a grid outside the JAX kernel's domain raises
    the JAX message."""
    kw = _bwd_kernel_args()
    fr._check(kw["q"], kw["k"], kw["v"], kw["rel_h"], kw["rel_w"],
              kw["k_size"], out=kw["out"], dout=kw["dout"], lse=kw["lse"])
    for dtype in (torch.bfloat16, torch.float32):
        assert fr.attention_route(64, (56, 28), 1568, dtype,
                                  backward=True) == "vitl"
        assert fr.attention_route(64, (70, 40), 2800, dtype,
                                  backward=True) == "vitl"  # 110
        assert fr.attention_route(64, (80, 40), 3200, dtype,
                                  backward=True) == "vitl"  # 120
        assert fr.attention_route(64, (90, 45), 4050, dtype,
                                  backward=True) == "generic"  # 135
        with pytest.raises(ValueError, match="rel table 65 exceeds"):
            fr.attention_route(64, (65, 65), 65 * 65, dtype, backward=True)


@pytest.mark.parametrize("k_size,ok", [
    ((56, 28), True), ((70, 35), True), ((14, 14), True),   # the paths
    ((10, 10), True), ((2, 40), True),                      # the limits
    ((14, 7), False), ((2, 42), False)])
def test_bwd_bf16_grid_width_limit(k_size, ok):
    """The bf16 ViT-L backward's one-hot expanders take kw in [10, 40];
    other widths of the JAX kernel's domain go to K2g. The fp32 ViT-L
    kernel has no such limit."""
    length = k_size[0] * k_size[1]
    for dtype in (torch.bfloat16, torch.float32):
        z = torch.zeros(1, length, 64, dtype=dtype)
        fr._check(z, z, z, torch.zeros(1, length, k_size[0], dtype=dtype),
                  torch.zeros(1, length, k_size[1], dtype=dtype), k_size,
                  out=z, dout=z, lse=torch.zeros(1, length))
        want = "vitl" if ok or dtype == torch.float32 else "generic"
        assert fr.attention_route(64, k_size, length, dtype,
                                  backward=True) == want


def test_bwd_build_target_and_source_note():
    path = build._target("flash_relpos_bwd")
    assert path.startswith(build.BUILD_DIR) and "flash_relpos_bwd-" in path
    assert set(build.SOURCES) == {"flash_relpos_fwd", "flash_relpos_bwd",
                                  "flash_relpos_generic",
                                  "decoder_tail_fwd", "decoder_tail_bwd",
                                  "decoder_tail_generic",
                                  "decoder_tail_tc_fwd",
                                  "decoder_tail_tc_bwd", "int8_mlp",
                                  "int8_mlp_generic"}
    with open("/".join([build.CSRC, "flash_relpos_bwd.cu"])) as f:
        src = f.read()
    assert "painter_tpu/kernels/flash_relpos.py:_bwd_impl" in src
    assert 'extern "C"' in src
