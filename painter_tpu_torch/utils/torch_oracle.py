"""The float64 oracle of the in-context ViT (the parity CLI and the tests).

A compact float64 restatement of the reference math
(``Painter/models_painter.py``, ``SegGPT/models_seggpt.py``,
``util/vitdet_utils.py``), as ``painter_tpu/utils/torch_oracle.py`` is for
the JAX package, but over the port's **state dict**: the reference
``.pth`` names and layouts (``blocks.{i}.attn.qkv.weight`` as (out, in),
convs as (out, in, kh, kw)). It is independent of the port's model code
(it calls nothing of ``painter_tpu_torch.models`` or ``.ops``), so holding
the port's forward against it checks the port and not the port against
itself.

It covers what the JAX oracle covers: the absolute position table with
its bicubic resize and the cls-token strip; the rel-pos tables with their
linear resize, where a windowed block of a ``window_rel_pos_tables``
model carries window-sized tables under its own names (the JAX tree's
``_win`` leaves); window partition and unpartition with padding; the
feature ensemble of ``merge_between_batch`` and the stream average at
``merge_idx``; the residual bottleneck blocks; the seg-type tokens; the
decoder (``decoder_embed``, the pixel shuffle, conv3x3, LayerNorm at eps
1e-6, GELU, conv1x1); the smooth-L1 loss with ``near_black_check`` and
``loss_denom_eps``.

It runs on the device it is given (``cuda`` by default): float64 on an
H100 is cuBLAS DGEMM and cuDNN, no kernel of the port.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from painter_tpu_torch.configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from painter_tpu_torch.device import resolve_device


class _Weights:
    """The state dict's entries in float64 on one device, on demand."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], device):
        self.sd = state_dict
        self.device = device

    def __call__(self, name: str) -> torch.Tensor:
        return self.sd[name].to(self.device, torch.float64)

    def get(self, name: str) -> Optional[torch.Tensor]:
        return self(name) if name in self.sd else None

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(x, self(name + ".weight"),
                        self.get(name + ".bias"))

    def ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self(name + ".weight"),
                            self(name + ".bias"), eps)


def _abs_pos(table: torch.Tensor, has_cls: bool, hw) -> torch.Tensor:
    tbl = table.reshape(-1, table.shape[-1])
    if has_cls:
        tbl = tbl[1:]
    size = int(round(tbl.shape[0] ** 0.5))
    grid = tbl.reshape(1, size, size, -1).permute(0, 3, 1, 2)
    if (size, size) != tuple(hw):
        grid = F.interpolate(grid, size=tuple(hw), mode="bicubic",
                             align_corners=False)
    return grid.permute(0, 2, 3, 1)


def _rel_table(q: int, k: int, tbl: torch.Tensor) -> torch.Tensor:
    dist = 2 * max(q, k) - 1
    if tbl.shape[0] != dist:
        tbl = F.interpolate(tbl.reshape(1, tbl.shape[0], -1).permute(0, 2, 1),
                            size=dist, mode="linear")
        tbl = tbl.reshape(-1, dist).permute(1, 0)
    qc = torch.arange(q)[:, None] * max(k / q, 1.0)
    kc = torch.arange(k)[None, :] * max(q / k, 1.0)
    rel = (qc - kc) + (k - 1) * max(q / k, 1.0)
    return tbl[rel.long().to(tbl.device)]


def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(win: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _attn(W: _Weights, pre: str, x: torch.Tensor, num_heads: int,
          use_rel_pos: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    length = h * w
    hd = c // num_heads
    qkv = W.linear(x.reshape(b, length, c), pre + "qkv")
    qkv = qkv.reshape(b, length, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * num_heads, length, hd).unbind(0)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    if use_rel_pos:
        rh = _rel_table(h, h, W(pre + "rel_pos_h"))
        rw = _rel_table(w, w, W(pre + "rel_pos_w"))
        rq = q.reshape(b * num_heads, h, w, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
        attn = (attn.view(b * num_heads, h, w, h, w)
                + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * num_heads, length, length)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(b, num_heads, h, w, hd).permute(0, 2, 3, 1, 4)
    return W.linear(x.reshape(b, h, w, c), pre + "proj")


def _ln2d(W: _Weights, z: torch.Tensor, name: str, eps: float):
    """LayerNorm over the channels of an NCHW map."""
    u = z.mean(1, keepdim=True)
    s2 = (z - u).pow(2).mean(1, keepdim=True)
    z = (z - u) / torch.sqrt(s2 + eps)
    return (W(name + ".weight")[:, None, None] * z
            + W(name + ".bias")[:, None, None])


def _residual_block(W: _Weights, pre: str, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    # NHWC -> NCHW convs with channel-wise LN (models_painter.py:92-150)
    h = x.permute(0, 3, 1, 2)
    out = F.gelu(_ln2d(W, F.conv2d(h, W(pre + "conv1.weight")),
                       pre + "norm1", eps))
    out = F.gelu(_ln2d(W, F.conv2d(out, W(pre + "conv2.weight"), padding=1),
                       pre + "norm2", eps))
    out = _ln2d(W, F.conv2d(out, W(pre + "conv3.weight")), pre + "norm3",
                eps)
    return x + out.permute(0, 2, 3, 1)


def _block(W: _Weights, i: int, x: torch.Tensor, cfg: ModelConfig,
           window_size: int, merge: int) -> torch.Tensor:
    pre = f"blocks.{i}."
    shortcut = x
    x = W.ln(x, pre + "norm1", cfg.ln_eps)
    if window_size > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = _window_partition(x, window_size)
    x = _attn(W, pre + "attn.", x, cfg.num_heads, cfg.use_rel_pos)
    if window_size > 0:
        x = _window_unpartition(x, window_size, pad_hw, (h, w))
    if merge > 0:
        prompt, inputs = x.split(x.shape[1] // 2, dim=1)
        if merge == 1:
            num_prompts = x.shape[0] // 2
            inputs = inputs.reshape(2, num_prompts, -1)
            inputs = inputs.mean(dim=1, keepdim=True).expand_as(inputs)
            inputs = inputs.reshape(*prompt.shape)
        else:
            inputs = inputs.mean(dim=0, keepdim=True).expand_as(inputs)
        x = torch.cat([prompt, inputs], dim=1)
    x = shortcut + x
    y = W.ln(x, pre + "norm2", cfg.ln_eps)
    y = W.linear(F.gelu(W.linear(y, pre + "mlp.fc1")), pre + "mlp.fc2")
    return x + y


def torch_forward(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  imgs, tgts, bool_masked_pos, valid, seg_type=None,
                  merge_between_batch: int = -1, device=None):
    """NHWC inputs (numpy arrays or tensors) -> (loss: float, pred image
    NHWC numpy), the whole model in float64 on ``device`` (default
    ``cuda``) from a reference-named ``state_dict``."""
    dev = resolve_device(device)
    W = _Weights(state_dict, dev)

    def t(a):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return a.to(dev, torch.float64)

    imgs = t(imgs).permute(0, 3, 1, 2)
    tgts_im = t(tgts).permute(0, 3, 1, 2)
    p = cfg.patch_size

    def embed(im):
        y = F.conv2d(im, W("patch_embed.proj.weight"),
                     W("patch_embed.proj.bias"), stride=p)
        return y.permute(0, 2, 3, 1)

    x = embed(imgs)
    y = embed(tgts_im)
    b, hp, wp, d = x.shape
    m = t(bool_masked_pos).reshape(b, hp, wp, 1)
    y = y * (1 - m) + W("mask_token").reshape(1, 1, 1, -1) * m
    x = x + W("segment_token_x").reshape(1, 1, 1, -1)
    y = y + W("segment_token_y").reshape(1, 1, 1, -1)
    if cfg.use_abs_pos:
        pos = _abs_pos(W("pos_embed"), cfg.pretrain_use_cls_token, (hp, wp))
        x = x + pos
        y = y + pos
    if cfg.seg_type_tokens:
        st = t(seg_type).reshape(b).long()
        emb = torch.where((st == 1)[:, None],
                          W("type_token_ins").reshape(1, d),
                          W("type_token_cls").reshape(1, d))[:, None, None, :]
        x = x + emb
        y = y + emb
    x = torch.cat([x, y], dim=0)

    outs = []
    for i in range(cfg.depth):
        ws = cfg.window_size if i in cfg.window_block_indexes else 0
        merge = 0
        if merge_between_batch >= 0 and i >= merge_between_batch:
            merge = 1 if cfg.merge_idx >= i else 2
        x = _block(W, i, x, cfg, ws, merge)
        if i in cfg.residual_block_indexes:
            x = _residual_block(W, f"blocks.{i}.residual.", x)
        if i == cfg.merge_idx:
            x = (x[:x.shape[0] // 2] + x[x.shape[0] // 2:]) * 0.5
        if i in cfg.out_indices:
            outs.append(W.ln(x, "norm", cfg.ln_eps))

    x = W.linear(torch.cat(outs, dim=-1), "decoder_embed")
    h, w = x.shape[1], x.shape[2]
    dec = cfg.decoder_embed_dim
    x = x.reshape(x.shape[0], h, w, p, p, dec)
    x = torch.einsum("nhwpqc->nchpwq", x).reshape(x.shape[0], dec,
                                                  h * p, w * p)
    x = F.conv2d(x, W("decoder_pred.0.weight"), W("decoder_pred.0.bias"),
                 padding=1)
    x = F.gelu(_ln2d(W, x, "decoder_pred.1", 1e-6))
    pred = F.conv2d(x, W("decoder_pred.3.weight"), W("decoder_pred.3.bias"))

    # loss
    mask = t(bool_masked_pos).reshape(b, hp, wp)
    mask = mask.repeat_interleave(p, 1).repeat_interleave(p, 2)[:, None]
    valid = t(valid).permute(0, 3, 1, 2).clone()
    if cfg.near_black_check:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64,
                            device=dev)[None, :, None, None]
        std = torch.tensor(IMAGENET_STD, dtype=torch.float64,
                           device=dev)[None, :, None, None]
        ign = ((tgts_im * std + mean) * (1 - mask)).sum((1, 2, 3)) < 300
        valid[ign] = 0.0
    mask = mask * valid
    loss = F.smooth_l1_loss(pred, tgts_im, reduction="none", beta=0.01)
    loss = (loss * mask).sum() / (mask.sum() + cfg.loss_denom_eps)
    return loss.item(), pred.permute(0, 2, 3, 1).cpu().numpy()
