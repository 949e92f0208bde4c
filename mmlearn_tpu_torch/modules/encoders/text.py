"""Text transformer, counterpart of :mod:`mmlearn_tpu.modules.encoders.text`.

Covers the CLIP-style tower of the JAX ``TextTransformer`` (:30-191): token
embedding plus a learned position embedding, causal blocks that take the
key-validity mask, the final ``norm``, ``eos``/``cls``/``mean`` pooling and
the ``proj`` head. BERT-style token types are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.modules.encoders.base import (
    EncoderOutput,
    as_dtype,
    dtype_name,
    reset_submodules,
)
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.normalization import LayerNorm
from mmlearn_tpu_torch.modules.layers.transformer_block import BlockStack


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``(num, dim)`` table, looked up then cast to
    ``dtype``."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=param_dtype))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # flax's default embed init: variance 1 / dim, plain normal
        with torch.no_grad():
            nn.init.normal_(self.weight, std=self.weight.shape[1] ** -0.5,
                            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight).to(self.dtype)


class TextTransformer(nn.Module):
    """Transformer text encoder over token ids."""

    def __init__(
        self,
        vocab_size: int = 49408,
        max_length: int = 77,
        embed_dim: int = 512,
        depth: int = 12,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        causal: bool = True,
        act_layer: str = "quick_gelu",
        norm_eps: float = 1e-5,
        pooling: str = "eos",
        proj_dim: Optional[int] = None,
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if pooling not in ("eos", "cls", "mean"):
            raise ValueError(f"pooling must be eos|cls|mean, got {pooling!r}")
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.config = dict(
            vocab_size=vocab_size, max_length=max_length, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, causal=causal, act_layer=act_layer,
            norm_eps=norm_eps, pooling=pooling, proj_dim=proj_dim,
            dtype=dtype_name(dtype), param_dtype=dtype_name(param_dtype),
        )
        self.pooling = pooling
        self.token_embedding = Embed(vocab_size, embed_dim, dtype, param_dtype)
        self.pos_embed = nn.Parameter(
            torch.empty(1, max_length, embed_dim, dtype=param_dtype)
        )
        self.blocks = BlockStack(
            depth, dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, act_layer=act_layer, norm_eps=norm_eps,
            causal=causal, dtype=dtype, param_dtype=param_dtype,
        )
        self.norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype)
        self.proj = (
            Dense(embed_dim, proj_dim, False, dtype, param_dtype)
            if proj_dim is not None else None
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator``."""
        reset_submodules(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, std=0.01, generator=generator)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> EncoderOutput:
        b, n = input_ids.shape
        tok = self.token_embedding(input_ids)
        x = tok + self.pos_embed[:, :n].to(tok.dtype)
        x = self.blocks(x, attention_mask)
        x = self.norm(x)

        if self.pooling == "eos":
            # CLIP: features at the end-of-text token, the largest token id
            eos = input_ids.argmax(dim=-1)
            pooled = x[torch.arange(b, device=x.device), eos]
        elif self.pooling == "cls":
            pooled = x[:, 0]
        else:  # mean
            if attention_mask is not None:
                m = attention_mask[..., None].to(x.dtype)
                pooled = (x * m).sum(1) / torch.clamp_min(m.sum(1), 1e-6)
            else:
                pooled = x.mean(dim=1)
        if self.proj is not None:
            pooled = self.proj(pooled)
        return EncoderOutput(last_hidden_state=x, pooler_output=pooled)
