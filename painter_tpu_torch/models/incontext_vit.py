"""The in-context ViT shared by Painter and SegGPT (PyTorch port).

Behavioral contract from ``Painter/models_painter.py:238-487`` and
``SegGPT/SegGPT_inference/models_seggpt.py:241-494``, numerics from the
JAX package (params fp32, compute in ``cfg.dtype``, LayerNorm statistics
and softmax in fp32, tanh GELU in bf16, NHWC token grids):

- two token streams x=patch_embed(imgs), y=patch_embed(tgts); masked y
  positions take a learned mask token; per-stream segment tokens; the
  bicubic-resized absolute pos-embed is added to both;
- the streams run stacked on the batch axis for the first ``merge_idx+1``
  blocks, then are averaged into one stream;
- final-norm'ed features at blocks ``out_indices`` feed the decoder:
  channel concat -> Linear -> pixel shuffle -> Conv3x3 -> LayerNorm2D ->
  GELU -> Conv1x1 -> 3 channels;
- SegGPT feature ensemble: from block ``merge_between_batch`` on, the
  query-half tokens are averaged (or weight-summed) across the prompt
  batch (models_seggpt.py:207-238).

The modules carry the reference ``.pth`` names (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``decoder_pred.0`` ...), so released checkpoints
load with ``load_state_dict``; the forward is written as plain functions
over them.

Training (``forward(..., train=True)``) adds per-sample stochastic depth
(timm DropPath, rate ``linspace(0, drop_path_rate, depth)``) with masks
drawn from an explicit ``torch.Generator`` outside each block, and
per-block activation checkpointing (:data:`REMAT_POLICIES`).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from painter_tpu_torch.device import resolve_device
from painter_tpu_torch.kernels.decoder_head import decoder_tail_fn
from painter_tpu_torch.kernels.flash_relpos import KernelOutputCache
from painter_tpu_torch.ops.attention import attention
from painter_tpu_torch.ops.norm import layer_norm
from painter_tpu_torch.ops.patches import patchify
from painter_tpu_torch.ops.pos_embed import get_abs_pos
from painter_tpu_torch.ops.quant import linear, mlp
from painter_tpu_torch.ops.windows import window_partition, window_unpartition


# ---------------------------------------------------------------------------
# Modules (reference parameter names)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, p, stride=p)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, rel_extent: int):
        super().__init__()
        d = cfg.embed_dim
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d)
        if cfg.use_rel_pos:
            gh, gw = (rel_extent, rel_extent) if rel_extent else cfg.grid_size
            self.rel_pos_h = nn.Parameter(torch.empty(2 * gh - 1, cfg.head_dim))
            self.rel_pos_w = nn.Parameter(torch.empty(2 * gw - 1, cfg.head_dim))


class Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)
        # "fused" runs the int8 MLP kernel once quantize_model made fc1 and
        # fc2 int8 (ops.quant.mlp)
        self.mlp_impl = "xla"


class ResBottleneck(nn.Module):
    """ResBottleneckBlock (models_painter.py:92-150): conv1x1 -> LN ->
    GELU -> conv3x3 -> LN -> GELU -> conv1x1 -> LN, residual added."""

    def __init__(self, dim: int):
        super().__init__()
        bott = dim // 2
        self.conv1 = nn.Conv2d(dim, bott, 1, bias=False)
        self.norm1 = nn.LayerNorm(bott)
        self.conv2 = nn.Conv2d(bott, bott, 3, padding=1, bias=False)
        self.norm2 = nn.LayerNorm(bott)
        self.conv3 = nn.Conv2d(bott, dim, 1, bias=False)
        self.norm3 = nn.LayerNorm(dim)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, index: int):
        super().__init__()
        d = cfg.embed_dim
        windowed = index in cfg.window_block_indexes
        # a window-trained checkpoint sizes a windowed block's tables by
        # the window (models_painter.py:309); otherwise full-grid tables
        rel_extent = cfg.window_size if (
            windowed and cfg.window_rel_pos_tables) else 0
        self.norm1 = nn.LayerNorm(d)
        self.attn = Attention(cfg, rel_extent)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = Mlp(cfg)
        if index in cfg.residual_block_indexes:
            self.residual = ResBottleneck(d)


class InContextViT(nn.Module):
    """Parameters of the in-context ViT; see :func:`build_model`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        p = cfg.patch_size
        dec = cfg.decoder_embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.mask_token = nn.Parameter(torch.empty(1, 1, 1, d))
        self.segment_token_x = nn.Parameter(torch.empty(1, 1, 1, d))
        self.segment_token_y = nn.Parameter(torch.empty(1, 1, 1, d))
        if cfg.seg_type_tokens:
            self.type_token_cls = nn.Parameter(torch.empty(1, 1, 1, d))
            self.type_token_ins = nn.Parameter(torch.empty(1, 1, 1, d))
        if cfg.use_abs_pos:
            n_pos = (cfg.pretrain_img_size // p) ** 2 + (
                1 if cfg.pretrain_use_cls_token else 0)
            self.pos_embed = nn.Parameter(torch.empty(1, n_pos, d))
        self.blocks = nn.ModuleList(Block(cfg, i) for i in range(cfg.depth))
        self.norm = nn.LayerNorm(d)
        self.decoder_embed = nn.Linear(4 * d, p * p * dec)
        self.decoder_pred = nn.Sequential(
            nn.Conv2d(dec, dec, 3, padding=1), nn.LayerNorm(dec), nn.GELU(),
            nn.Conv2d(dec, 3, 1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions (incontext_vit.py:78-202),
        drawn from ``generator`` on the parameters' device."""
        cfg = self.cfg

        def trunc(t, std=0.02):
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

        def kaiming(t, fan_in):
            bound = fan_in ** -0.5
            nn.init.uniform_(t, -bound, bound, generator=generator)

        pe = self.patch_embed.proj
        fan = cfg.in_chans * cfg.patch_size ** 2
        kaiming(pe.weight, fan)
        kaiming(pe.bias, fan)
        for name in ("mask_token", "segment_token_x", "segment_token_y",
                     "type_token_cls", "type_token_ins", "pos_embed"):
            if hasattr(self, name):
                trunc(getattr(self, name))
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
        trunc(self.decoder_embed.weight)
        nn.init.zeros_(self.decoder_embed.bias)
        c1, c2 = self.decoder_pred[0], self.decoder_pred[3]
        for conv, fan_in in ((c1, 9 * cfg.decoder_embed_dim),
                             (c2, cfg.decoder_embed_dim)):
            kaiming(conv.weight, fan_in)
            kaiming(conv.bias, fan_in)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1,
                        blk.mlp.fc2):
                trunc(lin.weight)
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
            if cfg.use_rel_pos:
                # rel_pos_zero_init=True in the reference factories
                nn.init.zeros_(blk.attn.rel_pos_h)
                nn.init.zeros_(blk.attn.rel_pos_w)
            if hasattr(blk, "residual"):
                res = blk.residual
                # detectron2 c2_msra_fill: kaiming normal, fan_out, relu
                for conv in (res.conv1, res.conv2, res.conv3):
                    fan_out = conv.out_channels * conv.kernel_size[0] ** 2
                    nn.init.normal_(conv.weight, 0.0, (2.0 / fan_out) ** 0.5,
                                    generator=generator)
                nn.init.zeros_(res.norm3.weight)


def build_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> InContextViT:
    """A randomly initialized model on ``device`` (default ``cuda``).

    The weights are drawn from ``generator`` (default: a CPU generator
    seeded 0) on the generator's device, then moved to ``device``.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        model = InContextViT(cfg)
    model.to_empty(device=generator.device)
    model.init_weights(generator)
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], padding: int) -> torch.Tensor:
    """SAME / VALID stride-1 conv over NHWC with an (out, in, kh, kw)
    weight cast to ``x.dtype``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


def _feature_ensemble(x: torch.Tensor, groups: int,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """SegGPT multi-prompt ensemble (models_seggpt.py:221-230).

    The query half of the token grid (bottom rows) is replaced by its mean
    over the prompt batch; ``weights`` (per prompt, summing to 1) makes it
    a weighted sum so padded prompts (weight 0) drop out exactly. Before
    the stream merge the batch holds both streams (groups=2), after it 1.
    """
    hp = x.shape[1] // 2
    prompt, inputs = x[:, :hp], x[:, hp:]
    n = x.shape[0] // groups
    grouped = inputs.reshape(groups, n, *inputs.shape[1:])
    if weights is None:
        pooled = grouped.mean(dim=1, keepdim=True)
    else:
        w = weights.to(inputs.dtype).reshape((1, n) + (1,) * (inputs.ndim - 1))
        pooled = (grouped * w).sum(dim=1, keepdim=True)
    inputs = pooled.expand(groups, n, *inputs.shape[1:]).reshape(
        inputs.shape)
    return torch.cat([prompt, inputs], dim=1)


def residual_bottleneck_apply(res: ResBottleneck, x: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """ResBottleneckBlock over (B, H, W, C) (models_painter.py:144-150)."""
    out = _conv_nhwc(x, res.conv1.weight, None, 0)
    out = _gelu(layer_norm(out, res.norm1.weight, res.norm1.bias, eps), False)
    out = _conv_nhwc(out, res.conv2.weight, None, 1)
    out = _gelu(layer_norm(out, res.norm2.weight, res.norm2.bias, eps), False)
    out = _conv_nhwc(out, res.conv3.weight, None, 0)
    out = layer_norm(out, res.norm3.weight, res.norm3.bias, eps)
    return x + out


def _drop_path(x: torch.Tensor, keep_mask: Optional[torch.Tensor],
               rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath): ``keep_mask`` (B,)
    of 0/1, the kept samples scaled by 1 / (1 - rate)."""
    if keep_mask is None:
        return x
    m = keep_mask.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return x * m / (1.0 - rate)


def block_apply(blk: Block, x: torch.Tensor, cfg: ModelConfig, *,
                window_size: int = 0, ensemble_groups: int = 0,
                ensemble_weights: Optional[torch.Tensor] = None,
                attn_impl: str = "kernel", dpr: float = 0.0,
                drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One transformer block over an (B, H, W, C) grid.

    ``drop_mask`` (2, B) holds the keep masks of the attention and MLP
    branches (stochastic depth at rate ``dpr``); None keeps every sample.
    """
    b, h, w, _ = x.shape
    shortcut = x
    xn = layer_norm(x, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
    if window_size > 0:
        xn, pad_hw = window_partition(xn, window_size)
        hw = (window_size, window_size)
    else:
        hw = (h, w)
    at = blk.attn
    rel = (at.rel_pos_h, at.rel_pos_w) if cfg.use_rel_pos else None
    att = attention(xn, at.qkv.weight, at.qkv.bias, at.proj.weight,
                    at.proj.bias, cfg.num_heads, hw, rel_pos=rel,
                    attn_impl=attn_impl)
    if window_size > 0:
        att = window_unpartition(att, window_size, pad_hw, (h, w))
    if ensemble_groups:
        att = _feature_ensemble(att, ensemble_groups, ensemble_weights)
    keep_attn, keep_mlp = (None, None) if drop_mask is None else drop_mask
    x = shortcut + _drop_path(att, keep_attn, dpr)
    m = blk.mlp
    xm = mlp(layer_norm(x, blk.norm2.weight, blk.norm2.bias, cfg.ln_eps),
             m.fc1, m.fc2, cfg.gelu_approximate, m.mlp_impl)
    return x + _drop_path(xm, keep_mlp, dpr)


# Per-block activation checkpointing (the JAX ``remat_policy``): "full"
# recomputes the whole block in the backward; "save_kernel" keeps the
# attention kernel's outputs (out, lse), so the recompute re-runs LN, the
# gemms and the MLP but never the attention forward
REMAT_POLICIES = ("full", "save_kernel")


def _checkpointed(fn, policy: str):
    """``fn(x, drop_mask=...)`` checkpointed under ``policy``. The block
    draws no random numbers (its drop-path masks come in), so the RNG
    state is not saved for the recompute."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not ported; the port "
                         f"has {REMAT_POLICIES}")

    def run(x, drop_mask, cache):
        if cache is None:
            return fn(x, drop_mask=drop_mask)
        with cache.active():
            return fn(x, drop_mask=drop_mask)

    def apply(x, drop_mask):
        cache = KernelOutputCache() if policy == "save_kernel" else None
        return checkpoint(run, x, drop_mask, cache, use_reentrant=False,
                          preserve_rng_state=False)

    return apply


def _drop_masks(n: int, rate: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """(2, n) keep masks, Bernoulli(1 - rate), drawn from ``generator``."""
    u = torch.rand((2, n), generator=generator, device=generator.device)
    return (u >= rate).float().to(device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _block_plan(cfg: ModelConfig, merge_between_batch: int):
    """Per-block (window_size, ensemble_groups)."""
    plan = []
    for i in range(cfg.depth):
        ws = cfg.window_size if i in cfg.window_block_indexes else 0
        groups = 0
        if merge_between_batch >= 0 and i >= merge_between_batch:
            # two stream-groups up to and incl. the stream-merge block,
            # one after (models_seggpt.py:425-429)
            groups = 2 if cfg.merge_idx >= i else 1
        plan.append((ws, groups))
    return plan


def _patch_embed(model: InContextViT, im: torch.Tensor) -> torch.Tensor:
    """Stride-p conv as a matmul over (kh, kw, c)-ordered patch vectors."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    proj = model.patch_embed.proj
    n, height, width, c = im.shape
    p = cfg.patch_size
    x = im.to(dtype).reshape(n, height // p, p, width // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, height // p, width // p,
                                            p * p * c)
    wm = proj.weight.permute(0, 2, 3, 1).reshape(proj.out_channels, -1)
    return linear(x, wm, proj.bias)


def forward_encoder(model: InContextViT, imgs: torch.Tensor,
                    tgts: torch.Tensor, bool_masked_pos: torch.Tensor,
                    seg_type: Optional[torch.Tensor] = None,
                    merge_between_batch: int = -1,
                    ensemble_weights: Optional[torch.Tensor] = None,
                    attn_impl: str = "kernel", train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False,
                    remat_policy: str = "save_kernel") -> List[torch.Tensor]:
    """imgs/tgts (B, H, W, 3) NHWC -> tapped features (B, Hp, Wp, C).

    With ``train`` and a ``generator``, each block draws its drop-path
    masks before it runs, so a checkpointed block's recompute reuses
    them; ``remat`` checkpoints every block under ``remat_policy``.
    """
    cfg = model.cfg
    dtype = cfg.compute_dtype
    x = _patch_embed(model, imgs)
    y = _patch_embed(model, tgts)
    b, hp, wp, d = x.shape

    m = bool_masked_pos.to(dtype).reshape(b, hp, wp, 1)
    y = y * (1.0 - m) + model.mask_token.to(dtype) * m
    x = x + model.segment_token_x.to(dtype)
    y = y + model.segment_token_y.to(dtype)
    if cfg.use_abs_pos:
        pos = get_abs_pos(model.pos_embed, cfg.pretrain_use_cls_token,
                          (hp, wp)).to(dtype)
        x = x + pos
        y = y + pos
    if cfg.seg_type_tokens:
        if seg_type is None:
            seg_type = torch.zeros((b, 1), dtype=torch.long, device=x.device)
        st = seg_type.reshape(b).long()
        type_emb = torch.where(
            (st == 1)[:, None], model.type_token_ins.to(dtype).reshape(1, d),
            model.type_token_cls.to(dtype).reshape(1, d))[:, None, None, :]
        x = x + type_emb
        y = y + type_emb
    x = torch.cat([x, y], dim=0)

    if any(t < cfg.merge_idx for t in cfg.out_indices):
        raise ValueError("taps before the stream merge would mix batch "
                         "sizes")
    checkpointed = remat and train
    dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
    taps: List[torch.Tensor] = []
    for i, ((ws, groups), blk) in enumerate(
            zip(_block_plan(cfg, merge_between_batch), model.blocks)):
        rate = float(dpr[i]) if train and generator is not None else 0.0
        mask = (_drop_masks(x.shape[0], rate, generator, x.device)
                if rate > 0 else None)
        fn = functools.partial(block_apply, blk, cfg=cfg, window_size=ws,
                               ensemble_groups=groups,
                               ensemble_weights=ensemble_weights,
                               attn_impl=attn_impl, dpr=rate)
        if checkpointed:
            x = _checkpointed(fn, remat_policy)(x, mask)
        else:
            x = fn(x, drop_mask=mask)
        if i in cfg.residual_block_indexes:
            x = residual_bottleneck_apply(blk.residual, x)
        if i == cfg.merge_idx:
            half = x.shape[0] // 2
            x = (x[:half] + x[half:]) * 0.5
        if i in cfg.out_indices:
            taps.append(x)
    return [layer_norm(t, model.norm.weight, model.norm.bias, cfg.ln_eps)
            for t in taps]


# ---------------------------------------------------------------------------
# Decoder, loss, full forward
# ---------------------------------------------------------------------------

DECODER_IMPLS = ("xla", "fused", "packed")


def forward_decoder(model: InContextViT, feats: Sequence[torch.Tensor],
                    decoder_impl: str = "xla") -> torch.Tensor:
    """4 tapped features -> painted prediction (B, H, W, 3).

    ``decoder_impl`` "xla" runs the stock tail (conv3x3, LN, GELU,
    conv1x1); "fused" runs it through :class:`FusedDecoderTail` (K3
    forward, K4 backward on the card); "packed" runs it with W-pixel pairs
    packed into the channel dim (:func:`_decoder_tail_packed`).
    """
    if decoder_impl not in DECODER_IMPLS:
        raise ValueError(f"decoder_impl must be one of {DECODER_IMPLS}, got "
                         f"{decoder_impl!r}")
    cfg = model.cfg
    x = torch.cat(list(feats), dim=-1)  # (B, Hp, Wp, 4C)
    x = linear(x, model.decoder_embed.weight, model.decoder_embed.bias)
    b, h, w, _ = x.shape
    p = cfg.patch_size
    dec = cfg.decoder_embed_dim
    x = x.reshape(b, h, w, p, p, dec).permute(0, 1, 3, 2, 4, 5)
    conv1, ln, _, conv2 = model.decoder_pred
    if decoder_impl == "packed":
        if (w * p) % 2:
            raise ValueError(
                f"decoder_impl='packed' pairs adjacent W pixels and needs "
                f"an even painted width; got w*p = {w}*{p} = {w * p} -- "
                f"use decoder_impl='xla' for odd widths")
        # the same shuffle, straight into the packed layout: the two
        # pixels of each W-pair land in one 2*dec channel row
        return _decoder_tail_packed(
            model, x.reshape(b, h * p, (w * p) // 2, 2 * dec))
    # pixel shuffle: (B, h, w, p*p*dec) -> (B, h*p, w*p, dec)
    x = x.reshape(b, h * p, w * p, dec)
    if decoder_impl == "fused":
        return decoder_tail_fn(x, conv1.weight, conv1.bias, ln.weight,
                               ln.bias, conv2.weight, conv2.bias,
                               cfg.gelu_approximate)
    x = _conv_nhwc(x, conv1.weight, conv1.bias, 1)
    x = _gelu(layer_norm(x, ln.weight, ln.bias, eps=1e-6),
              cfg.gelu_approximate)
    return _conv_nhwc(x, conv2.weight, conv2.bias, 0)


def _decoder_tail_packed(model: InContextViT,
                         x: torch.Tensor) -> torch.Tensor:
    """The decoder tail on W-pixel pairs packed into channels
    (``incontext_vit._decoder_tail_packed``): x (B, H, W/2, 2*dec).

    The 3x3 conv becomes a block-structured (2*dec, 2*dec, 3, 3) conv over
    half the width; LN normalizes each pixel's own dec channels; the 1x1
    conv is a block-diagonal (2*dec, 6) product. Same math as the stock
    tail; gradients reach the canonical weights through the packing.
    """
    dtype = x.dtype
    b, hh, wp2, cc = x.shape
    dec = cc // 2
    conv1, ln, _, conv2 = model.decoder_pred
    w1 = conv1.weight.to(dtype)  # (dec_out, dec_in, 3, 3)
    # output pixel t of a pair reads input pixel t + dw, which lives at
    # packed column offset floor((t + dw) / 2), slot (t + dw) % 2
    wp = w1.new_zeros((2 * dec, 2 * dec, 3, 3))
    for t in (0, 1):
        for dw in (-1, 0, 1):
            kwp, u = (t + dw) // 2, (t + dw) % 2
            wp[t * dec:(t + 1) * dec, u * dec:(u + 1) * dec, :, kwp + 1] = \
                w1[:, :, :, dw + 1]
    x = _conv_nhwc(x, wp, None, 1) + conv1.bias.to(dtype).repeat(2)
    x = layer_norm(x.reshape(b, hh, wp2, 2, dec), ln.weight, ln.bias,
                   eps=1e-6).reshape(b, hh, wp2, cc)
    x = _gelu(x, model.cfg.gelu_approximate)
    w2 = conv2.weight.to(dtype)[:, :, 0, 0].t()  # (dec, 3)
    w2p = w2.new_zeros((2 * dec, 6))
    w2p[:dec, :3] = w2
    w2p[dec:, 3:] = w2
    x = x @ w2p + conv2.bias.to(dtype).repeat(2)
    return x.reshape(b, hh, wp2 * 2, 3)


def pixel_mask_from_patch_mask(bool_masked_pos: torch.Tensor,
                               cfg: ModelConfig, hw) -> torch.Tensor:
    """(B, L) patch mask -> (B, H, W, 1) per-pixel mask."""
    b = bool_masked_pos.shape[0]
    gh, gw = hw[0] // cfg.patch_size, hw[1] // cfg.patch_size
    m = bool_masked_pos.reshape(b, gh, gw).float()
    m = m.repeat_interleave(cfg.patch_size, dim=1).repeat_interleave(
        cfg.patch_size, dim=2)
    return m[..., None]


def forward_loss(cfg: ModelConfig, pred: torch.Tensor, tgts: torch.Tensor,
                 bool_masked_pos: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Masked, valid-weighted regression loss (models_painter.py:433-462)."""
    pred = pred.float()
    tgts = tgts.float()
    valid = valid.float()
    mask = pixel_mask_from_patch_mask(bool_masked_pos, cfg, tgts.shape[1:3])
    if cfg.near_black_check:
        mean = torch.tensor(IMAGENET_MEAN, device=tgts.device)
        std = torch.tensor(IMAGENET_STD, device=tgts.device)
        denorm = tgts * std + mean
        unmasked_sum = (denorm * (1.0 - mask)).sum(dim=(1, 2, 3))
        ignore = unmasked_sum < 100.0 * 3
        valid = torch.where(ignore[:, None, None, None],
                            torch.zeros_like(valid), valid)
    mask = mask * valid
    diff = pred - tgts
    if cfg.loss_func == "l1l2":
        loss = (diff.abs() + diff ** 2) * 0.5
    elif cfg.loss_func == "l1":
        loss = diff.abs()
    elif cfg.loss_func == "l2":
        loss = diff ** 2
    elif cfg.loss_func == "smoothl1":
        beta = 0.01
        loss = torch.where(diff.abs() < beta, 0.5 * diff ** 2 / beta,
                           diff.abs() - 0.5 * beta)
    else:
        raise ValueError(cfg.loss_func)
    return (loss * mask).sum() / (mask.sum() + cfg.loss_denom_eps)


def forward(model: InContextViT, imgs: torch.Tensor, tgts: torch.Tensor,
            bool_masked_pos: Optional[torch.Tensor] = None,
            valid: Optional[torch.Tensor] = None,
            seg_type: Optional[torch.Tensor] = None,
            merge_between_batch: int = -1, attn_impl: str = "kernel",
            train: bool = False, generator: Optional[torch.Generator] = None,
            remat: bool = False, remat_policy: str = "save_kernel",
            decoder_impl: str = "xla"):
    """Full forward -> (loss, patchified pred, bool_masked_pos), as
    ``models_painter.py:464-472`` (NHWC in and out); ``train`` and the
    rest as :func:`forward_encoder`, ``decoder_impl`` as
    :func:`forward_decoder`."""
    cfg = model.cfg
    b = imgs.shape[0]
    num_patches = (imgs.shape[1] // cfg.patch_size) * \
        (imgs.shape[2] // cfg.patch_size)
    if bool_masked_pos is None:
        bool_masked_pos = torch.zeros((b, num_patches), device=imgs.device)
    else:
        bool_masked_pos = bool_masked_pos.reshape(b, -1)
    if valid is None:
        valid = torch.ones_like(tgts)
    feats = forward_encoder(model, imgs, tgts, bool_masked_pos,
                            seg_type=seg_type,
                            merge_between_batch=merge_between_batch,
                            attn_impl=attn_impl, train=train,
                            generator=generator, remat=remat,
                            remat_policy=remat_policy)
    pred = forward_decoder(model, feats, decoder_impl=decoder_impl)
    loss = forward_loss(cfg, pred, tgts, bool_masked_pos, valid)
    return loss, patchify(pred.float(), cfg.patch_size), bool_masked_pos


def predict_image(model: InContextViT, imgs: torch.Tensor,
                  tgts: torch.Tensor, bool_masked_pos: torch.Tensor,
                  seg_type: Optional[torch.Tensor] = None,
                  merge_between_batch: int = -1,
                  attn_impl: str = "kernel") -> torch.Tensor:
    """Inference-only path -> painted prediction (B, H, W, 3) fp32."""
    feats = forward_encoder(model, imgs, tgts,
                            bool_masked_pos.reshape(imgs.shape[0], -1),
                            seg_type=seg_type,
                            merge_between_batch=merge_between_batch,
                            attn_impl=attn_impl)
    return forward_decoder(model, feats).float()


def predict_query_half(model: InContextViT, imgs: torch.Tensor,
                       tgts: torch.Tensor, bool_masked_pos: torch.Tensor,
                       seg_type: Optional[torch.Tensor] = None,
                       merge_between_batch: int = -1,
                       ensemble_weights: Optional[torch.Tensor] = None,
                       attn_impl: str = "kernel") -> torch.Tensor:
    """In-context inference fast path -> (H/2, W, 3) painted query half.

    Only sample 0's bottom half is read (``seggpt_engine.py:51``; the
    ensemble makes all samples' query halves identical). Decoding those
    tokens plus one extra token row, so the 3x3 conv sees its real context
    across the seam, then cropping, equals slicing the full decode.
    """
    cfg = model.cfg
    feats = forward_encoder(model, imgs, tgts,
                            bool_masked_pos.reshape(imgs.shape[0], -1),
                            seg_type=seg_type,
                            merge_between_batch=merge_between_batch,
                            ensemble_weights=ensemble_weights,
                            attn_impl=attn_impl)
    half = feats[0].shape[1] // 2
    pred = forward_decoder(model, [f[:1, half - 1:] for f in feats])
    return pred[0, cfg.patch_size:].float()


def predict_query_half_batch(model: InContextViT, imgs: torch.Tensor,
                             tgts: torch.Tensor,
                             bool_masked_pos: torch.Tensor,
                             seg_type: Optional[torch.Tensor] = None,
                             attn_impl: str = "kernel") -> torch.Tensor:
    """Batched independent queries -> (B, H/2, W, 3) painted halves, each
    sample its own (prompt, query) pair, with the same seam trick."""
    cfg = model.cfg
    feats = forward_encoder(model, imgs, tgts,
                            bool_masked_pos.reshape(imgs.shape[0], -1),
                            seg_type=seg_type, merge_between_batch=-1,
                            attn_impl=attn_impl)
    half = feats[0].shape[1] // 2
    pred = forward_decoder(model, [f[:, half - 1:] for f in feats])
    return pred[:, cfg.patch_size:].float()
