"""Vision Transformer, counterpart of :mod:`mmlearn_tpu.modules.encoders.vision`.

Covers the JAX ``VisionTransformer`` (:68-280): the cls token, learned or
fixed 2-D sin-cos position embeddings, a patch embedding with or without a
bias, I-JEPA patch-keep masks, patch dropout, ``norm_pre``, the blocks with
their dropout, attention dropout and drop-path (a linear schedule from 0
to ``drop_path_rate`` over the blocks) and activation checkpointing
(``remat``, ``remat_policy``), the optional final ``norm``, cls/avg
pooling or every token projected (``proj_all_tokens``), the ``proj`` head
with or without a bias, and each block's output (``return_hidden_states``);
the I-JEPA ``VisionTransformerPredictor`` (:283-380) with its drop rates,
:func:`apply_masks` and :func:`repeat_interleave_batch`; and the size
presets ``vit_tiny`` ... ``vit_giant`` (:385-418).

The JAX tower applies ``remat_policy`` only to its scanned stack
(``scan_blocks=True``) and checkpoints an unscanned block whole; the port
has one layout (``blocks.{i}``, which :mod:`~mmlearn_tpu_torch.bridge` maps
to either JAX layout) and applies the policy to every block. The values are
the same either way. ``norm_pre`` and ``norm`` are plain
LayerNorms, as in the JAX package; the blocks' norms run kernel K2 and their
attention kernel K1 (or its head-grouped variant, see
:func:`~mmlearn_tpu_torch.ops.fused_attention.use_packed`), or K3 past the
lengths K1 takes (a 448-px ViT-B/16 at 785 tokens, ViT-g/14 at 257).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
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
from mmlearn_tpu_torch.modules.layers.patch_dropout import PatchDropout
from mmlearn_tpu_torch.modules.layers.transformer_block import BlockStack


def apply_masks(x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Gather the kept tokens of ``x`` ``(B, N, D)`` under integer keep
    indices ``masks`` ``(num_masks, B, K)`` (or ``(B, K)``): ``(num_masks * B,
    K, D)``, mask-major, as the JAX package's ``apply_masks``."""
    if masks.ndim == 2:
        masks = masks[None]
    num_masks, b, k = masks.shape
    idx = masks.long()[..., None].expand(num_masks, b, k, x.shape[-1])
    gathered = torch.gather(x[None].expand(num_masks, *x.shape), 2, idx)
    return gathered.reshape(num_masks * b, k, x.shape[-1])


def repeat_interleave_batch(x: torch.Tensor, b: int, repeat: int) -> torch.Tensor:
    """Repeat each consecutive ``b``-row group ``repeat`` times: a tile of
    the group (``[g0, g0, g1, g1]`` for two groups of ``b`` rows and
    ``repeat=2``, each ``g`` whole), not ``torch.repeat_interleave``."""
    n = x.shape[0] // b
    out = x.reshape(n, b, *x.shape[1:]).repeat(1, repeat, *([1] * (x.ndim - 1)))
    return out.reshape(n * repeat * b, *x.shape[1:])


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
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        use_cls_token: bool = False,
        learned_pos_embed: bool = False,
        pre_norm: bool = False,
        final_norm: bool = True,
        act_layer: str = "gelu",
        norm_eps: float = 1e-6,
        global_pool: str = "none",
        proj_all_tokens: bool = False,
        proj_dim: Optional[int] = None,
        proj_bias: bool = False,
        patch_drop_rate: float = 0.0,
        patch_embed_bias: bool = True,
        remat: bool = False,
        remat_policy: Optional[str] = "dots_no_batch",
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
            mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop_rate=drop_rate,
            attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
            use_cls_token=use_cls_token, learned_pos_embed=learned_pos_embed,
            pre_norm=pre_norm, final_norm=final_norm, act_layer=act_layer,
            norm_eps=norm_eps, global_pool=global_pool, proj_all_tokens=proj_all_tokens,
            proj_dim=proj_dim, proj_bias=proj_bias, patch_drop_rate=patch_drop_rate,
            patch_embed_bias=patch_embed_bias, remat=remat, remat_policy=remat_policy,
            dtype=dtype_name(dtype),
            param_dtype=dtype_name(param_dtype),
        )
        self.dtype = dtype
        self.global_pool = global_pool
        self.proj_all_tokens = proj_all_tokens
        self.num_prefix = 1 if use_cls_token else 0
        grid = img_size // patch_size
        num_tokens = grid * grid + self.num_prefix

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, dtype, param_dtype,
                                      use_bias=patch_embed_bias)
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
        self.patch_drop = (PatchDropout(1.0 - patch_drop_rate, self.num_prefix)
                           if patch_drop_rate > 0.0 else None)
        self.norm_pre = LayerNorm(embed_dim, norm_eps, dtype, param_dtype) if pre_norm else None
        self.blocks = BlockStack(
            depth, remat=remat, remat_policy=remat_policy if remat else None,
            drop_path_rates=np.linspace(0, drop_path_rate, depth).tolist(),
            dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, drop=drop_rate, attn_drop=attn_drop_rate,
            act_layer=act_layer, norm_eps=norm_eps, dtype=dtype, param_dtype=param_dtype,
        )
        self.norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype) if final_norm else None
        # a CLIP-style projection has no bias; a timm classifier head has one
        self.proj = (
            Dense(embed_dim, proj_dim, proj_bias, dtype, param_dtype)
            if proj_dim is not None and (global_pool != "none" or proj_all_tokens) else None
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

    def forward(
        self,
        x: torch.Tensor,
        patch_masks: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
    ) -> EncoderOutput:
        """``x``: ``(B, H, W, C)`` images (or ``(B, N, embed_dim)`` tokens
        already embedded). ``patch_masks``: optional ``(M, B, K)`` patch
        indices to keep; the output then has ``M * B`` rows of ``K`` (+ cls)
        tokens. ``return_hidden_states``: each block's output too."""
        if x.ndim == 4:
            x = self.patch_embed(x)
        pos = self.pos_embed
        # the patch position embedding goes on before the gather, so a kept
        # patch keeps its position
        x = x + pos[:, self.num_prefix:].to(x.dtype)
        if patch_masks is not None:
            x = apply_masks(x, patch_masks)
        b = x.shape[0]
        if self.num_prefix:
            cls = self.cls_token + pos[:, :1].to(self.cls_token.dtype)
            dt = torch.promote_types(cls.dtype, x.dtype)  # jnp.concatenate promotes
            x = torch.cat([cls.expand(b, 1, x.shape[-1]).to(dt), x.to(dt)], dim=1)
        if self.patch_drop is not None:
            x = self.patch_drop(x)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        hidden = None
        if return_hidden_states:
            x, hidden = self.blocks(x, return_hidden_states=True)
        else:
            x = self.blocks(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.proj_all_tokens:
            if self.proj is not None:
                x = self.proj(x)
            return EncoderOutput(last_hidden_state=x, pooler_output=None, hidden_states=hidden)
        pooled = None
        if self.global_pool == "cls":
            pooled = x[:, 0]
        elif self.global_pool == "avg":
            pooled = x[:, self.num_prefix:].mean(dim=1)
        if pooled is not None and self.proj is not None:
            pooled = self.proj(pooled)
        return EncoderOutput(last_hidden_state=x, pooler_output=pooled, hidden_states=hidden)


class VisionTransformerPredictor(nn.Module):
    """I-JEPA predictor: from the context tokens, predicts the targets'
    representations.

    ``forward(z, enc_masks, pred_masks)``: the context tokens ``z``
    ``(n_enc * B, K_ctx, embed_dim)`` go to the predictor width with their
    sin-cos positions added; one mask token a target patch, at its position,
    is appended to the context, which is tiled once per target mask; after
    the blocks and the norm, the target tokens go back to ``embed_dim``:
    ``(n_pred * n_enc * B, K_tgt, embed_dim)``.
    """

    def __init__(
        self,
        num_patches: int = 196,
        embed_dim: int = 768,
        predictor_embed_dim: int = 384,
        depth: int = 6,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        norm_eps: float = 1e-6,
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.dtype = dtype
        grid = int(num_patches**0.5)
        self.predictor_embed = Dense(embed_dim, predictor_embed_dim, True, dtype, param_dtype)
        # the JAX predictor holds the fixed table in the compute dtype
        table = get_2d_sincos_pos_embed(predictor_embed_dim, grid)
        self.register_buffer("pos_embed", torch.from_numpy(table).to(dtype), persistent=False)
        self.mask_token = nn.Parameter(
            torch.empty(1, 1, predictor_embed_dim, dtype=param_dtype)
        )
        self.blocks = BlockStack(
            depth, drop_path_rates=np.linspace(0, drop_path_rate, depth).tolist(),
            dim=predictor_embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, drop=drop_rate, attn_drop=attn_drop_rate, norm_eps=norm_eps,
            dtype=dtype, param_dtype=param_dtype,
        )
        self.norm = LayerNorm(predictor_embed_dim, norm_eps, dtype, param_dtype)
        self.predictor_proj = Dense(predictor_embed_dim, embed_dim, True, dtype, param_dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator``."""
        reset_submodules(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.mask_token, std=0.02, generator=generator)

    def forward(
        self, z: torch.Tensor, enc_masks: torch.Tensor, pred_masks: torch.Tensor
    ) -> torch.Tensor:
        if enc_masks.ndim == 2:
            enc_masks = enc_masks[None]
        if pred_masks.ndim == 2:
            pred_masks = pred_masks[None]
        n_enc, b, k_ctx = enc_masks.shape
        n_pred = pred_masks.shape[0]
        x = self.predictor_embed(z)  # (n_enc * B, K_ctx, Dp)
        table = self.pos_embed[None].expand(b, *self.pos_embed.shape)
        x = x + apply_masks(table, enc_masks)
        tgt_pos = repeat_interleave_batch(apply_masks(table, pred_masks), b, n_enc)
        pred_tokens = self.mask_token.to(self.dtype) + tgt_pos
        # the context once per target mask: (n_pred * n_enc * B, K_ctx, Dp)
        x = torch.cat([x.repeat(n_pred, 1, 1), pred_tokens], dim=1)
        x = self.norm(self.blocks(x))
        return self.predictor_proj(x[:, k_ctx:])


# -- size presets (the JAX package's ``_VIT_DIMS``, vision.py:385-418) -------

_VIT_DIMS = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "huge": dict(embed_dim=1280, depth=32, num_heads=16),
    "giant": dict(embed_dim=1408, depth=40, num_heads=16, mlp_ratio=48 / 11),
}


def _vit(size: str, **kwargs: Any) -> VisionTransformer:
    """The ``size`` preset's width, depth, heads (and MLP ratio), with
    ``kwargs`` over them."""
    return VisionTransformer(**{**_VIT_DIMS[size], **kwargs})


vit_tiny = functools.partial(_vit, "tiny")
vit_small = functools.partial(_vit, "small")
vit_base = functools.partial(_vit, "base")
vit_large = functools.partial(_vit, "large")
vit_huge = functools.partial(_vit, "huge")
vit_giant = functools.partial(_vit, "giant")

for _size in _VIT_DIMS:
    store.store_node("modules/encoders", f"vit_{_size}", {
        "_target_": "mmlearn_tpu_torch.modules.encoders.vision._vit",
        "_args_": [_size], "img_size": 224, "patch_size": 16,
    })


def vit_predictor(**kwargs: Any) -> VisionTransformerPredictor:
    """A ``VisionTransformerPredictor`` (the store's ``vit_predictor``)."""
    return VisionTransformerPredictor(**kwargs)


store(group="modules/encoders", name="vit_predictor", populate_full_signature=False)(
    vit_predictor
)
store(group="modules/encoders", name="VisionTransformer")(VisionTransformer)
