"""Encoders of the port: the CLIP-style vision and text towers."""

from mmlearn_tpu_torch.modules.encoders.base import EncoderOutput
from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

__all__ = ["EncoderOutput", "TextTransformer", "VisionTransformer"]
