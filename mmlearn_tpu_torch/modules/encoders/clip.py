"""HF CLIP encoder factories, counterpart of
:mod:`mmlearn_tpu.modules.encoders.clip`.

The four factories (``HFCLIPVisionEncoder``, ``HFCLIPVisionEncoderWithProjection``,
``HFCLIPTextEncoder``, ``HFCLIPTextEncoderWithProjection``) build the port's
``VisionTransformer`` / ``TextTransformer`` of an HF ``CLIPModel``'s
geometry and return it with the model's weights loaded. Each takes a
``CLIPModel``, a name (``transformers`` then loads it), or a config (an HF
``CLIPConfig`` or a mapping of its fields, ``vision_config`` and
``text_config`` nested) and a state dict. The reference's options carry
over: ``patch_dropout_rate`` (patch dropout after the embeddings) and
``use_all_token_embeddings`` (every token projected, no pooling); the text
tower drops its padding mask (causal attention with eos pooling never reads
the padded positions), as the JAX factory does.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.hf_utils import (
    clip_text_kwargs,
    clip_vision_kwargs,
    convert_clip_text,
    convert_clip_vision,
)
from mmlearn_tpu_torch.modules.encoders.hf_wrappers import _model_and_config, load_converted


def _load_clip(name: str):
    from transformers import CLIPModel

    return CLIPModel.from_pretrained(name)


def _vision(model, with_projection: bool, patch_dropout_rate: float,
            use_all_token_embeddings: bool, dtype, remat: bool, config, state_dict) -> nn.Module:
    from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

    cfg, sd = _model_and_config(model, config, state_dict, _load_clip)
    kwargs = clip_vision_kwargs(cfg)
    kwargs.update(
        proj_dim=cfg.projection_dim if with_projection else None,
        patch_drop_rate=patch_dropout_rate,
        global_pool="none" if use_all_token_embeddings else "cls",
        proj_all_tokens=use_all_token_embeddings, remat=remat, dtype=dtype,
    )
    converted = convert_clip_vision(
        sd, cfg.vision_config.num_hidden_layers,
        projection_key="visual_projection.weight" if with_projection else None,
        num_heads=cfg.vision_config.num_attention_heads)
    return load_converted(VisionTransformer(**kwargs), converted)


def _text(model, with_projection: bool, use_all_token_embeddings: bool, dtype, remat: bool,
          config, state_dict) -> nn.Module:
    from mmlearn_tpu_torch.modules.encoders.text import TextTransformer

    cfg, sd = _model_and_config(model, config, state_dict, _load_clip)
    kwargs = clip_text_kwargs(cfg)
    kwargs.update(
        proj_dim=cfg.projection_dim if with_projection else None, pooling="eos",
        proj_all_tokens=use_all_token_embeddings, remat=remat, dtype=dtype,
        elide_padding_mask=not use_all_token_embeddings,
    )
    converted = convert_clip_text(
        sd, cfg.text_config.num_hidden_layers,
        projection_key="text_projection.weight" if with_projection else None,
        num_heads=cfg.text_config.num_attention_heads)
    return load_converted(TextTransformer(**kwargs), converted)


@store(group="modules/encoders", name="HFCLIPVisionEncoder",
       populate_full_signature=False)
def HFCLIPVisionEncoder(
    pretrained_model_name_or_path: Any = "openai/clip-vit-base-patch16",
    patch_dropout_rate: float = 0.0,
    use_all_token_embeddings: bool = False,
    dtype: Any = torch.float32,
    remat: bool = False,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """The CLIP vision tower without the projection head."""
    return _vision(pretrained_model_name_or_path, False, patch_dropout_rate,
                   use_all_token_embeddings, dtype, remat, config, state_dict)


@store(group="modules/encoders", name="HFCLIPVisionEncoderWithProjection",
       populate_full_signature=False)
def HFCLIPVisionEncoderWithProjection(
    pretrained_model_name_or_path: Any = "openai/clip-vit-base-patch16",
    patch_dropout_rate: float = 0.0,
    use_all_token_embeddings: bool = False,
    dtype: Any = torch.float32,
    remat: bool = False,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """The CLIP vision tower with the contrastive projection head."""
    return _vision(pretrained_model_name_or_path, True, patch_dropout_rate,
                   use_all_token_embeddings, dtype, remat, config, state_dict)


@store(group="modules/encoders", name="HFCLIPTextEncoder",
       populate_full_signature=False)
def HFCLIPTextEncoder(
    pretrained_model_name_or_path: Any = "openai/clip-vit-base-patch16",
    use_all_token_embeddings: bool = False,
    dtype: Any = torch.float32,
    remat: bool = False,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """The CLIP text tower without the projection head."""
    return _text(pretrained_model_name_or_path, False, use_all_token_embeddings, dtype, remat,
                 config, state_dict)


@store(group="modules/encoders", name="HFCLIPTextEncoderWithProjection",
       populate_full_signature=False)
def HFCLIPTextEncoderWithProjection(
    pretrained_model_name_or_path: Any = "openai/clip-vit-base-patch16",
    use_all_token_embeddings: bool = False,
    dtype: Any = torch.float32,
    remat: bool = False,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """The CLIP text tower with the contrastive projection head."""
    return _text(pretrained_model_name_or_path, True, use_all_token_embeddings, dtype, remat,
                 config, state_dict)
