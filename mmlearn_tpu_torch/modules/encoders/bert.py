"""Post-LN BERT text encoder, counterpart of
:mod:`mmlearn_tpu.modules.encoders.bert`.

``BertTextEncoder`` (JAX :65-173): word, position and token-type embeddings,
the embeddings' LayerNorm and dropout, ``depth`` post-LN blocks, then the
tanh pooler, ``cls``, mask-weighted ``mean`` or no pooling, and an optional
projection. :func:`mmlearn_tpu_torch.hf_utils.convert_bert` fills it from any
HF ``BertModel``-family state dict.

Each block is ``x = LN(x + Attn(x)); x = LN(x + MLP(x))``: the attention
runs kernel K1 (with the key-padding mask), and both norms are
``FusedLayerNorm(x, residual=branch)``, the add+LayerNorm path of kernel K2
(the JAX block's ``nn.LayerNorm(x + branch)``; the JAX package leaves its
TPU norm kernel opt-in, the port runs K2 by default as it does in ``Block``).
The embeddings' norm is a plain LayerNorm, as the towers' ``norm_pre``.
``remat`` checkpoints every block whole (the JAX ``nn.remat`` of a block, no
policy) through :class:`~mmlearn_tpu_torch.modules.layers.transformer_block.
BlockStack`. The JAX ``scan_blocks`` layout has no counterpart: the port has
one layout, ``blocks.{i}``, which :mod:`~mmlearn_tpu_torch.bridge` maps to
the per-layer JAX one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.encoders.base import (
    EncoderOutput,
    as_dtype,
    dtype_name,
    reset_submodules,
)
from mmlearn_tpu_torch.modules.encoders.text import Embed
from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.dropout import Dropout
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.layers.normalization import FusedLayerNorm, LayerNorm
from mmlearn_tpu_torch.modules.layers.transformer_block import BlockStack

POOLINGS = ("pooler", "cls", "mean", "none")


class BertBlock(nn.Module):
    """One post-LN BERT layer."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        act_layer: str = "gelu",
        norm_eps: float = 1e-12,
        drop: float = 0.0,
        attn_drop: float = 0.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.attn = Attention(dim, num_heads, True, False, dtype, param_dtype,
                              attn_drop=attn_drop, proj_drop=drop)
        self.attn_norm = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)
        self.mlp = MLP(dim, out_dim=dim, hidden_dims=[int(dim * mlp_ratio)],
                       activation=act_layer, dropout=drop, dtype=dtype,
                       param_dtype=param_dtype)
        self.mlp_norm = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)

    def draw_masks(self, x_shape) -> Optional[dict]:
        """The block's keep-masks for an input of ``x_shape``, in the JAX
        block's order (the attention's, then the MLP's); ``None`` where
        nothing is dropped."""
        attn = self.attn.draw_masks(x_shape)
        mlp = self.mlp.draw_masks(x_shape)
        if attn == (None, None) and mlp is None:
            return None
        return {"attn": attn, "mlp": mlp}

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                masks: Optional[dict] = None) -> torch.Tensor:
        if masks is None:
            masks = self.draw_masks(x.shape)
        m = masks or {}
        branch = self.attn(x, attention_mask, keeps=m.get("attn", (None, None)))
        _, x = self.attn_norm(x, residual=branch)
        _, x = self.mlp_norm(x, residual=self.mlp(x, keeps=m.get("mlp")))
        return x


@store(group="modules/encoders", name="BertTextEncoder")
class BertTextEncoder(nn.Module):
    """Post-LN BERT trunk over token ids."""

    def __init__(
        self,
        vocab_size: int = 30522,
        max_length: int = 512,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        act_layer: str = "gelu",
        norm_eps: float = 1e-12,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        pooling: str = "pooler",
        use_pooler: bool = True,
        proj_dim: Optional[int] = None,
        remat: bool = False,
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {POOLINGS}, got {pooling!r}")
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.config = dict(
            vocab_size=vocab_size, max_length=max_length, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, mlp_ratio=mlp_ratio, act_layer=act_layer, norm_eps=norm_eps,
            drop_rate=drop_rate, attn_drop_rate=attn_drop_rate, pooling=pooling,
            use_pooler=use_pooler, proj_dim=proj_dim, remat=remat, dtype=dtype_name(dtype),
            param_dtype=dtype_name(param_dtype),
        )
        self.pooling = pooling
        self.num_heads = num_heads
        self.token_embedding = Embed(vocab_size, embed_dim, dtype, param_dtype)
        self.position_embedding = Embed(max_length, embed_dim, dtype, param_dtype)
        self.token_type_embedding = Embed(2, embed_dim, dtype, param_dtype)
        self.embed_norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype)
        self.drop = Dropout(drop_rate)
        self.blocks = BlockStack(
            depth, remat=remat, block_cls=BertBlock, dim=embed_dim, num_heads=num_heads,
            mlp_ratio=mlp_ratio, act_layer=act_layer, norm_eps=norm_eps, drop=drop_rate,
            attn_drop=attn_drop_rate, dtype=dtype, param_dtype=param_dtype,
        )
        pooled = pooling in ("cls", "mean") or (pooling == "pooler" and use_pooler)
        self.pooler = (Dense(embed_dim, embed_dim, True, dtype, param_dtype)
                       if pooling == "pooler" and use_pooler else None)
        self.proj = (Dense(embed_dim, proj_dim, False, dtype, param_dtype)
                     if proj_dim is not None and pooled else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator``."""
        reset_submodules(self, generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> EncoderOutput:
        """``input_ids`` ``(B, N)``; ``attention_mask`` ``(B, N)``, 1 where a
        key is attended; ``token_type_ids`` ``(B, N)`` in {0, 1}, 0 where not
        given."""
        n = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding(torch.arange(n, device=input_ids.device)[None])
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embedding(token_type_ids)
        x = self.drop(self.embed_norm(x))
        x = self.blocks(x, attention_mask)

        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(x[:, 0]))
        elif self.pooling == "cls":
            pooled = x[:, 0]
        elif self.pooling == "mean":
            if attention_mask is not None:
                m = attention_mask[..., None].to(x.dtype)
                pooled = (x * m).sum(1) / torch.clamp_min(m.sum(1), 1e-6)
            else:
                pooled = x.mean(dim=1)
        if pooled is not None and self.proj is not None:
            pooled = self.proj(pooled)
        return EncoderOutput(last_hidden_state=x, pooler_output=pooled)
