"""Pre-LN transformer block, counterpart of
:mod:`mmlearn_tpu.modules.layers.transformer_block`.

Trains through the kernels' autograd Functions (attention K1, or K3 for
long sequences; both norms K2). Dropout, attention dropout and drop-path are not ported: the flagship
sets their rates to 0, and a nonzero rate raises ``NotImplementedError``.
:class:`BlockStack` is a plain ``nn.ModuleList`` (no activation
checkpointing). The JAX package's scanned
``BlockStack`` stores its weights stacked along a leading depth axis;
:mod:`mmlearn_tpu_torch.bridge` unstacks them into ``blocks.{i}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.layers.normalization import FusedLayerNorm


class Block(nn.Module):
    """``x + Attn(LN(x))``, then ``+ MLP(LN(.))``; the residual add and the
    second norm run as one fused add + LayerNorm."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        act_layer: str = "gelu",
        norm_eps: float = 1e-6,
        causal: bool = False,
        drop: float = 0.0,
        attn_drop: float = 0.0,
        drop_path_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if drop or attn_drop or drop_path_rate:
            raise NotImplementedError(
                f"dropout is not ported yet: drop={drop}, attn_drop={attn_drop}, "
                f"drop_path_rate={drop_path_rate} (the flagship sets all to 0)"
            )
        self.norm1 = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, causal, dtype, param_dtype)
        self.norm2 = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)
        self.mlp = MLP(dim, out_dim=dim, hidden_dims=[int(dim * mlp_ratio)],
                       activation=act_layer, dtype=dtype, param_dtype=param_dtype)

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        branch = self.attn(self.norm1(x), attention_mask)
        x, y = self.norm2(x, residual=branch)
        return x + self.mlp(y)


class BlockStack(nn.ModuleList):
    """``depth`` blocks of one configuration, run in order."""

    def __init__(self, depth: int, **block_kwargs) -> None:
        super().__init__([Block(**block_kwargs) for _ in range(depth)])

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        for block in self:
            x = block(x, attention_mask)
        return x
