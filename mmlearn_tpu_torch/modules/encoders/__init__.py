"""Encoders of the port: the CLIP-style vision and text towers, the I-JEPA
predictor and the post-LN BERT tower (``bert.py``); the HF, timm and CLIP
factories live in ``hf_wrappers.py`` and ``clip.py``."""

from mmlearn_tpu_torch.modules.encoders.base import EncoderOutput
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
from mmlearn_tpu_torch.modules.encoders.vision import (
    VisionTransformer,
    VisionTransformerPredictor,
    apply_masks,
    repeat_interleave_batch,
    vit_base,
    vit_giant,
    vit_huge,
    vit_large,
    vit_small,
    vit_tiny,
)

__all__ = ["BertTextEncoder", "EncoderOutput", "TextTransformer", "VisionTransformer",
           "VisionTransformerPredictor", "apply_masks", "repeat_interleave_batch",
           "vit_base", "vit_giant", "vit_huge", "vit_large", "vit_small", "vit_tiny"]
