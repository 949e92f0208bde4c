"""Patch embedding and 2-D sin-cos position embeddings.

Counterpart of :mod:`mmlearn_tpu.modules.layers.embedding`. Images are NHWC,
as in the JAX package. The patch projection is a patch unfold plus one
matmul in (h, w, c) flatten order -- exactly flax's strided ``Conv`` and
free of cuDNN's default TF32 convolution on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlearn_tpu_torch.modules.layers.dense import lecun_normal_


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """Sin-cos embedding of scalar positions."""
    if embed_dim % 2 != 0:
        raise ValueError("embed_dim must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int | tuple[int, int], cls_token: bool = False
) -> np.ndarray:
    """2-D sin-cos position embedding, ``(grid_h * grid_w [+1], embed_dim)``."""
    if isinstance(grid_size, int):
        grid_h = grid_w = grid_size
    else:
        grid_h, grid_w = grid_size
    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    grid = np.meshgrid(gw, gh)  # w goes first (reference convention)
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_h, grid_w)
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    emb = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim), np.float32), emb], axis=0)
    return emb


class PatchProj(nn.Module):
    """The strided patch convolution as a matmul. ``weight`` is
    ``(embed_dim, patch, patch, in_chans)``: flax's HWIO kernel with the
    output axis moved first."""

    def __init__(
        self,
        patch_size: int,
        in_chans: int,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, patch_size, patch_size, in_chans, dtype=param_dtype)
        )
        self.bias = nn.Parameter(torch.zeros(embed_dim, dtype=param_dtype))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.reshape(self.weight.shape[0], -1).to(dt)
        return F.linear(patches.to(dt), w, self.bias.to(dt))


class PatchEmbed(nn.Module):
    """Image-to-patch embedding. ``(B, H, W, C)`` to ``(B, num_patches, E)``."""

    def __init__(
        self,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.proj = PatchProj(patch_size, in_chans, embed_dim, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"Expected (B, H, W, C) input, got {tuple(x.shape)}")
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        # VALID padding: a ragged border is dropped, as flax's conv drops it
        x = x[:, : gh * p, : gw * p]
        patches = (
            x.reshape(b, gh, p, gw, p, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, gh * gw, p * p * c)
        )
        return self.proj(patches)
