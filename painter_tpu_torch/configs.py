"""Typed model configurations with named presets (PyTorch port).

Field for field the same dataclass and presets as the JAX package's
``configs.py``; only :attr:`ModelConfig.compute_dtype` differs, returning
a ``torch.dtype``. Painter and SegGPT are two presets of one in-context
ViT.

A load-bearing reference quirk carried over: the reference factories pass
a *tuple of lists* as ``window_block_indexes`` (a misplaced comma at
``models_painter.py:481-482``), so every block of the released checkpoints
runs global attention. ``window_block_indexes=()`` (all-global) is
therefore the default, with window attention implemented and selectable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the in-context ViT (Painter/SegGPT family)."""

    img_size: Tuple[int, int] = (896, 448)  # (H, W); H == 2*W (stitched pair)
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    # Empty = all blocks global (checkpoint parity; see module docstring).
    window_block_indexes: Tuple[int, ...] = ()
    # ResBottleneckBlock after these blocks (models_painter.py:232-233).
    residual_block_indexes: Tuple[int, ...] = ()
    # Windowed blocks carry exact (2*window_size-1)-entry rel-pos tables
    # (the layout a window-trained checkpoint stores); without it every
    # block holds full-grid tables and windowed blocks interpolate them.
    window_rel_pos_tables: bool = False
    pretrain_img_size: int = 224
    pretrain_use_cls_token: bool = True
    decoder_embed_dim: int = 64
    loss_func: str = "smoothl1"  # smoothl1 | l1 | l2 | l1l2
    # Stream-merge block index and encoder feature-tap indices
    # (models_painter.py:408-418).
    merge_idx: int = 2
    out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    ln_eps: float = 1e-6
    # SegGPT extras (models_seggpt.py:285-286,414-420,448-469).
    seg_type_tokens: bool = False
    # Painter adds +1e-2 to the loss denominator and zeroes `valid` for
    # near-black targets (models_painter.py:443-461); SegGPT does neither.
    loss_denom_eps: float = 1e-2
    near_black_check: bool = True
    # Compute dtype of the trunk ("float32" or "bfloat16"). Params are
    # stored fp32; LayerNorm statistics and the softmax always run fp32.
    dtype: str = "float32"
    # "auto": tanh GELU when computing in bf16, exact erf in fp32.
    gelu: str = "auto"

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        h, w = self.grid_size
        return h * w

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def gelu_approximate(self) -> bool:
        """True -> tanh GELU (see the ``gelu`` field)."""
        if self.gelu == "auto":
            return self.dtype == "bfloat16"
        return self.gelu == "tanh"

    def with_img_size(self, img_size: Tuple[int, int]) -> "ModelConfig":
        """Same model at another eval resolution; rel/abs-pos tables are
        interpolated at forward time (``vitdet_utils.py:75-93,128-157``)."""
        return dataclasses.replace(self, img_size=tuple(img_size))


def painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1(
        **kwargs) -> ModelConfig:
    """Painter ViT-L preset (models_painter.py:476-487)."""
    defaults = dict(
        img_size=(896, 448), patch_size=16, embed_dim=1024, depth=24,
        num_heads=16, drop_path_rate=0.1, window_size=14, qkv_bias=True,
        mlp_ratio=4.0, use_rel_pos=True, decoder_embed_dim=64,
        loss_func="smoothl1", seg_type_tokens=False,
        loss_denom_eps=1e-2, near_black_check=True)
    defaults.update(kwargs)
    return ModelConfig(**defaults)


# The indexes the reference factory meant to pass (models_painter.py:
# 481-482): 16 windowed blocks at ws=14, 8 global at {2, 5, ..., 23}.
WINDOWED_8GLB_BLOCK_INDEXES = tuple(
    i for i in range(24) if i not in (2, 5, 8, 11, 14, 17, 20, 23))


def painter_vit_large_patch16_input896x448_windowed(**kwargs) -> ModelConfig:
    """The windowed Painter ViT-L with exact per-window rel-pos tables."""
    defaults = dict(window_block_indexes=WINDOWED_8GLB_BLOCK_INDEXES,
                    window_rel_pos_tables=True)
    defaults.update(kwargs)
    return painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1(
        **defaults)


def seggpt_vit_large_patch16_input896x448(**kwargs) -> ModelConfig:
    """SegGPT ViT-L preset (models_seggpt.py:483-494)."""
    defaults = dict(
        img_size=(896, 448), patch_size=16, embed_dim=1024, depth=24,
        num_heads=16, drop_path_rate=0.1, window_size=14, qkv_bias=True,
        mlp_ratio=4.0, use_rel_pos=True, decoder_embed_dim=64,
        loss_func="smoothl1", seg_type_tokens=True,
        loss_denom_eps=0.0, near_black_check=False)
    defaults.update(kwargs)
    return ModelConfig(**defaults)


def tiny_test_config(**kwargs) -> ModelConfig:
    """Small config for fast CPU tests (not in reference)."""
    defaults = dict(
        img_size=(64, 32), patch_size=8, embed_dim=32, depth=6, num_heads=2,
        drop_path_rate=0.0, window_size=2, pretrain_img_size=32,
        decoder_embed_dim=8, out_indices=(2, 3, 4, 5), merge_idx=2)
    defaults.update(kwargs)
    return ModelConfig(**defaults)


PRESETS = {
    "painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1":
        painter_vit_large_patch16_input896x448_win_dec64_8glb_sl1,
    "painter_vit_large_patch16_input896x448_windowed":
        painter_vit_large_patch16_input896x448_windowed,
    "seggpt_vit_large_patch16_input896x448":
        seggpt_vit_large_patch16_input896x448,
    "tiny_test": tiny_test_config,
}


def get_config(name: str, **kwargs) -> ModelConfig:
    return PRESETS[name](**kwargs)
