"""Layers of the port, each the counterpart of the same path in
:mod:`mmlearn_tpu.modules.layers`."""

from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.embedding import (
    PatchEmbed,
    get_2d_sincos_pos_embed,
    interpolate_pos_embed,
)
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.layers.normalization import (
    FusedLayerNorm,
    LayerNorm,
    l2_normalize,
)
from mmlearn_tpu_torch.modules.layers.quantization import Int8Dense, quant_mode
from mmlearn_tpu_torch.modules.layers.transformer_block import Block, BlockStack

__all__ = [
    "MLP",
    "Attention",
    "Block",
    "BlockStack",
    "Dense",
    "FusedLayerNorm",
    "Int8Dense",
    "LayerNorm",
    "PatchEmbed",
    "get_2d_sincos_pos_embed",
    "interpolate_pos_embed",
    "l2_normalize",
    "quant_mode",
]
