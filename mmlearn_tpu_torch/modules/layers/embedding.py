"""Patch embedding (with or without a bias), the 3x3 convolution stem
``ConvEmbed``, 1-D and 2-D sin-cos position embeddings and the resize of a
learned position table.

Counterpart of :mod:`mmlearn_tpu.modules.layers.embedding`. Images are NHWC,
as in the JAX package. The patch projection is a patch unfold plus one
matmul in (h, w, c) flatten order -- exactly flax's strided ``Conv`` and
free of cuDNN's default TF32 convolution on the card. ``ConvEmbed``'s
convolutions keep flax's HWIO kernels with the output axis moved first
(``(out, kh, kw, in)``, as :class:`PatchProj`) and flax's ``SAME`` padding.
:func:`interpolate_pos_embed` resizes with the bicubic of ``jax.image.resize``
(Keys' cubic with a = -0.5, weights renormalised at the edges), which
``F.interpolate(mode="bicubic")`` (a = -0.75, clamped indices) is not.
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


def get_1d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """1-D sin-cos position embedding, ``(grid_size [+1], embed_dim)``."""
    pos = np.arange(grid_size, dtype=np.float32)
    emb = get_1d_sincos_pos_embed_from_grid(embed_dim, pos)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim), np.float32), emb], axis=0)
    return emb


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
    output axis moved first; ``bias`` is absent with ``use_bias=False``."""

    def __init__(
        self,
        patch_size: int,
        in_chans: int,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        use_bias: bool = True,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, patch_size, patch_size, in_chans, dtype=param_dtype)
        )
        self.bias = (nn.Parameter(torch.zeros(embed_dim, dtype=param_dtype))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.weight.reshape(self.weight.shape[0], -1).to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(patches.to(dt), w, bias)


class PatchEmbed(nn.Module):
    """Image-to-patch embedding. ``(B, H, W, C)`` to ``(B, num_patches, E)``."""

    def __init__(
        self,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        use_bias: bool = True,
    ) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.proj = PatchProj(patch_size, in_chans, embed_dim, dtype, param_dtype, use_bias)

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


class Conv(nn.Module):
    """flax ``nn.Conv`` over NHWC with ``SAME`` padding (``pad_lo = total //
    2``, the rest after), a bias, weights ``(out, kh, kw, in)``."""

    def __init__(self, in_chans: int, out_chans: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype, self.kernel, self.stride = dtype, kernel, stride
        self.weight = nn.Parameter(
            torch.empty(out_chans, kernel, kernel, in_chans, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(out_chans, dtype=param_dtype))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k, s = self.dtype, self.kernel, self.stride
        pads = []
        for size in (x.shape[2], x.shape[1]):  # F.pad's order: w, then h
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x.to(dt).permute(0, 3, 1, 2), pads)
        w = self.weight.permute(0, 3, 1, 2).to(dt)
        return F.conv2d(x, w, self.bias.to(dt), stride=s).permute(0, 2, 3, 1)


class ConvEmbed(nn.Module):
    """A stack of 3x3 convolutions (ReLU after each) and a 1x1 projection,
    ``(B, H, W, C)`` to ``(B, tokens, embed_dim)``: the JAX ``ConvEmbed``,
    its layers named ``conv{i}`` and ``proj``."""

    def __init__(
        self,
        channels: tuple[int, ...] = (64, 128, 256),
        embed_dim: int = 768,
        strides: tuple[int, ...] = (2, 2, 2),
        in_chans: int = 3,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        prev = in_chans
        self.num_convs = len(channels)
        for i, (ch, s) in enumerate(zip(channels, strides)):
            self.add_module(f"conv{i}", Conv(prev, ch, 3, s, dtype, param_dtype))
            prev = ch
        self.proj = Conv(prev, embed_dim, 1, 1, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = self.proj(x)
        b, gh, gw, c = x.shape
        return x.reshape(b, gh * gw, c)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at distances ``x >= 0``."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` weights of one axis, as
    ``jax.image.scale_and_translate`` builds them for ``resize`` (scale
    ``out / in``, no translation, antialiasing: the kernel widens by ``in /
    out`` when shrinking): each output column's weights sum to one, and a
    sample outside the input gets none."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    new_grid: tuple[int, int],
    old_grid: tuple[int, int],
    num_prefix_tokens: int = 1,
) -> torch.Tensor:
    """Resize a learned ``(1, prefix + old_h * old_w, dim)`` position table
    to ``new_grid``, keeping the prefix (cls) rows: the JAX package's
    ``interpolate_pos_embed``, bicubic as ``jax.image.resize`` computes it,
    one axis at a time (an axis whose size does not change is left as it
    is). The weights are built in f64 and applied in the table's dtype."""
    prefix = pos_embed[:, :num_prefix_tokens]
    dim = pos_embed.shape[-1]
    grid = pos_embed[:, num_prefix_tokens:].reshape(1, old_grid[0], old_grid[1], dim)
    for axis, (old, new) in enumerate(zip(old_grid, new_grid)):
        if old != new:
            w = torch.from_numpy(_resize_weights(old, new)).to(grid.device, grid.dtype)
            grid = torch.movedim(torch.tensordot(grid, w, dims=([axis + 1], [0])), -1, axis + 1)
    return torch.cat([prefix, grid.reshape(1, new_grid[0] * new_grid[1], dim)], dim=1)
