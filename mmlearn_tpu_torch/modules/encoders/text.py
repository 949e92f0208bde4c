"""Text transformer, counterpart of :mod:`mmlearn_tpu.modules.encoders.text`.

Covers the JAX ``TextTransformer`` (:30-191): token embedding plus a learned
position embedding, BERT-style token types (``use_token_type``: segment 0's
row of a 2-row table added to every token), dropout of the embeddings and in
the blocks (``drop_rate``, ``attn_drop_rate``), blocks that take the
key-validity mask (dropped on causal towers with ``elide_padding_mask``)
under activation checkpointing (``remat``, ``remat_policy``, as the vision
tower), the final ``norm``, ``eos``/``cls``/``mean``/``none`` pooling or
every token projected (``proj_all_tokens``), the ``proj`` head, and each
block's output (``return_hidden_states``).
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
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.dropout import Dropout
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


@store(group="modules/encoders", name="TextTransformer")
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
        use_token_type: bool = False,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        act_layer: str = "quick_gelu",
        norm_eps: float = 1e-5,
        pooling: str = "eos",
        proj_all_tokens: bool = False,
        elide_padding_mask: bool = False,
        proj_dim: Optional[int] = None,
        remat: bool = False,
        remat_policy: Optional[str] = "dots_no_batch",
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if pooling not in ("eos", "cls", "mean", "none"):
            raise ValueError(f"pooling must be eos|cls|mean|none, got {pooling!r}")
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.config = dict(
            vocab_size=vocab_size, max_length=max_length, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, causal=causal, use_token_type=use_token_type,
            drop_rate=drop_rate, attn_drop_rate=attn_drop_rate, act_layer=act_layer,
            norm_eps=norm_eps, pooling=pooling, proj_all_tokens=proj_all_tokens,
            elide_padding_mask=elide_padding_mask, proj_dim=proj_dim, remat=remat,
            remat_policy=remat_policy, dtype=dtype_name(dtype), param_dtype=dtype_name(param_dtype),
        )
        self.pooling = pooling
        self.causal = causal
        self.proj_all_tokens = proj_all_tokens
        self.elide_padding_mask = elide_padding_mask
        self.token_embedding = Embed(vocab_size, embed_dim, dtype, param_dtype)
        self.pos_embed = nn.Parameter(
            torch.empty(1, max_length, embed_dim, dtype=param_dtype)
        )
        self.token_type_embedding = (Embed(2, embed_dim, dtype, param_dtype)
                                     if use_token_type else None)
        self.drop = Dropout(drop_rate)
        self.blocks = BlockStack(
            depth, remat=remat, remat_policy=remat_policy if remat else None,
            dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
            drop=drop_rate, attn_drop=attn_drop_rate, act_layer=act_layer,
            norm_eps=norm_eps, causal=causal, dtype=dtype, param_dtype=param_dtype,
        )
        self.norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype)
        self.proj = (
            Dense(embed_dim, proj_dim, False, dtype, param_dtype)
            if proj_dim is not None and (pooling != "none" or proj_all_tokens) else None
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, drawn from ``generator``."""
        reset_submodules(self, generator)
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, std=0.01, generator=generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
    ) -> EncoderOutput:
        """``input_ids`` ``(B, N)``, ``attention_mask`` ``(B, N)`` (1 =
        attend). ``return_hidden_states``: each block's output too."""
        b, n = input_ids.shape
        tok = self.token_embedding(input_ids)
        x = tok + self.pos_embed[:, :n].to(tok.dtype)
        if self.token_type_embedding is not None:
            x = x + self.token_type_embedding(torch.zeros_like(input_ids))
        x = self.drop(x)
        # on a causal tower the padding follows the EOS token and no earlier
        # position sees it: dropping the mask changes only padded positions
        block_mask = None if self.elide_padding_mask and self.causal else attention_mask
        hidden = None
        if return_hidden_states:
            x, hidden = self.blocks(x, block_mask, return_hidden_states=True)
        else:
            x = self.blocks(x, block_mask)
        x = self.norm(x)
        if self.proj_all_tokens:
            if self.proj is not None:
                x = self.proj(x)
            return EncoderOutput(last_hidden_state=x, pooler_output=None, hidden_states=hidden)

        pooled = None
        if self.pooling == "eos":
            # CLIP: features at the end-of-text token, the largest token id
            eos = input_ids.argmax(dim=-1)
            pooled = x[torch.arange(b, device=x.device), eos]
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
        return EncoderOutput(last_hidden_state=x, pooler_output=pooled, hidden_states=hidden)
