"""Vision Transformer, counterpart of :mod:`mmlearn_tpu.modules.encoders.vision`.

Covers the CLIP-style tower of the JAX ``VisionTransformer`` (:68-280): the
cls token, learned or fixed 2-D sin-cos position embeddings, ``norm_pre``,
the final ``norm``, cls/avg pooling and the ``proj`` head. I-JEPA patch
masks, the predictor and patch dropout are not ported yet. ``norm_pre`` and
``norm`` are plain LayerNorms, as in the JAX package; the blocks' norms run
kernel K2 and their attention kernel K1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.modules.encoders.base import (
    EncoderOutput,
    as_dtype,
    dtype_name,
    reset_submodules,
)
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.embedding import (
    PatchEmbed,
    get_2d_sincos_pos_embed,
)
from mmlearn_tpu_torch.modules.layers.normalization import LayerNorm
from mmlearn_tpu_torch.modules.layers.transformer_block import BlockStack


class VisionTransformer(nn.Module):
    """ViT trunk over NHWC images with optional CLS token and projection."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        use_cls_token: bool = False,
        learned_pos_embed: bool = False,
        pre_norm: bool = False,
        act_layer: str = "gelu",
        norm_eps: float = 1e-6,
        global_pool: str = "none",
        proj_dim: Optional[int] = None,
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if global_pool not in ("none", "cls", "avg"):
            raise ValueError(f"global_pool must be none|cls|avg, got {global_pool!r}")
        if global_pool == "cls" and not use_cls_token:
            raise ValueError("global_pool='cls' requires use_cls_token=True")
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.config = dict(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, use_cls_token=use_cls_token,
            learned_pos_embed=learned_pos_embed, pre_norm=pre_norm,
            act_layer=act_layer, norm_eps=norm_eps, global_pool=global_pool,
            proj_dim=proj_dim, dtype=dtype_name(dtype),
            param_dtype=dtype_name(param_dtype),
        )
        self.dtype = dtype
        self.global_pool = global_pool
        self.num_prefix = 1 if use_cls_token else 0
        grid = img_size // patch_size
        num_tokens = grid * grid + self.num_prefix

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype, param_dtype)
        if learned_pos_embed:
            self.pos_embed = nn.Parameter(
                torch.empty(1, num_tokens, embed_dim, dtype=param_dtype)
            )
        else:
            table = get_2d_sincos_pos_embed(embed_dim, grid, cls_token=use_cls_token)
            # the JAX tower holds the fixed table in the compute dtype
            self.register_buffer(
                "pos_embed", torch.from_numpy(np.asarray(table[None])).to(dtype),
                persistent=False,
            )
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, dtype=param_dtype))
        self.norm_pre = LayerNorm(embed_dim, norm_eps, dtype, param_dtype) if pre_norm else None
        self.blocks = BlockStack(
            depth, dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, act_layer=act_layer, norm_eps=norm_eps,
            dtype=dtype, param_dtype=param_dtype,
        )
        self.norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype)
        self.proj = (  # CLIP-style projection: no bias
            Dense(embed_dim, proj_dim, False, dtype, param_dtype)
            if proj_dim is not None and global_pool != "none" else None
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator``."""
        reset_submodules(self, generator)
        with torch.no_grad():
            if isinstance(self.pos_embed, nn.Parameter):
                nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
            if self.num_prefix:
                nn.init.normal_(self.cls_token, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> EncoderOutput:
        """``x``: ``(B, H, W, C)`` images."""
        x = self.patch_embed(x)
        b = x.shape[0]
        pos = self.pos_embed
        x = x + pos[:, self.num_prefix:].to(x.dtype)
        if self.num_prefix:
            cls = self.cls_token + pos[:, :1].to(self.cls_token.dtype)
            dt = torch.promote_types(cls.dtype, x.dtype)  # jnp.concatenate promotes
            x = torch.cat([cls.expand(b, 1, x.shape[-1]).to(dt), x.to(dt)], dim=1)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        x = self.norm(self.blocks(x))
        pooled = None
        if self.global_pool == "cls":
            pooled = x[:, 0]
        elif self.global_pool == "avg":
            pooled = x[:, self.num_prefix:].mean(dim=1)
        if pooled is not None and self.proj is not None:
            pooled = self.proj(pooled)
        return EncoderOutput(last_hidden_state=x, pooler_output=pooled)
