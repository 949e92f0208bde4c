"""Layers of the port, each the counterpart of the same path in
:mod:`mmlearn_tpu.modules.layers`."""

from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.dropout import (
    DropPath,
    Dropout,
    MaskSource,
    drop_path,
    masks_from,
)
from mmlearn_tpu_torch.modules.layers.embedding import (
    ConvEmbed,
    PatchEmbed,
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
    interpolate_pos_embed,
)
from mmlearn_tpu_torch.modules.layers.logit_scaling import LearnableLogitScaling
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.layers.normalization import (
    FusedLayerNorm,
    LayerNorm,
    L2Norm,
    l2_normalize,
)
from mmlearn_tpu_torch.modules.layers.patch_dropout import PatchDropout
from mmlearn_tpu_torch.modules.layers.quantization import Int8Dense, quant_mode
from mmlearn_tpu_torch.modules.layers.transformer_block import Block, BlockStack

__all__ = [
    "MLP",
    "Attention",
    "Block",
    "BlockStack",
    "ConvEmbed",
    "Dense",
    "DropPath",
    "Dropout",
    "FusedLayerNorm",
    "Int8Dense",
    "LayerNorm",
    "LearnableLogitScaling",
    "MaskSource",
    "PatchDropout",
    "PatchEmbed",
    "drop_path",
    "get_1d_sincos_pos_embed",
    "get_2d_sincos_pos_embed",
    "interpolate_pos_embed",
    "L2Norm",
    "l2_normalize",
    "masks_from",
    "quant_mode",
]
