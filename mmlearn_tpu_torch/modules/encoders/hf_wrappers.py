"""HF and timm encoder factories, counterpart of
:mod:`mmlearn_tpu.modules.encoders.hf_wrappers`.

Each factory builds the port's tower of a checkpoint's geometry and returns
it with the checkpoint's weights loaded:

- :func:`HFTextEncoder`: a BERT-family encoder (decoders are refused) as
  :class:`~mmlearn_tpu_torch.modules.encoders.bert.BertTextEncoder`;
- :func:`HFViTEncoder`: an HF ``ViTModel`` as ``VisionTransformer``
  (:func:`convert_hf_vit`);
- :func:`TimmViT`: a timm ViT, its geometry read from the state dict, with
  a projection head.

Each takes a model object, or a config (an HF config object or a mapping of
its fields) and a state dict; ``transformers`` and ``timm`` are imported
only where a model is asked for by name. The JAX factories' deferred
loaders have no counterpart: the weights are loaded at once.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.bridge import jax_to_torch
from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.hf_utils import (
    _layernorm,
    _linear,
    _np,
    convert_bert,
    convert_timm_vit,
    timm_vit_geometry,
)
from mmlearn_tpu_torch.ops.fused_attention import interleave_qkv_heads


def as_config(config: Any) -> Any:
    """An HF config object as it is; a mapping (nested ones too) as an
    object with its keys as attributes."""
    if isinstance(config, Mapping) and all(isinstance(k, str) for k in config):
        return SimpleNamespace(**{k: as_config(v) for k, v in config.items()})
    return config


def load_converted(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                   fresh: tuple[str, ...] = ()) -> nn.Module:
    """Load converted weights into ``module``: every key must be the
    module's; the module's keys that the checkpoint lacks must be among
    ``fresh`` (a projection the checkpoint does not hold keeps its
    initialisation)."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    stray = [k for k in missing if not k.startswith(fresh)] if fresh else list(missing)
    if unexpected or stray:
        raise ValueError(f"converted weights do not fit {type(module).__name__}: missing "
                         f"{stray[:6]}, unexpected {list(unexpected)[:6]}")
    return module


def _model_and_config(model: Any, config: Any, state_dict: Any, loader) -> tuple[Any, dict]:
    if config is not None or state_dict is not None:
        if config is None or state_dict is None:
            raise ValueError("pass a config together with a state dict")
        return as_config(config), dict(state_dict)
    if isinstance(model, str):
        model = loader(model)
    return model.config, model.state_dict()


@store(group="modules/encoders", name="HFTextEncoder",
       populate_full_signature=False)
def HFTextEncoder(
    model_name_or_path: Any = "bert-base-uncased",
    pooling: str = "pooler",
    proj_dim: Optional[int] = None,
    dtype: Any = torch.float32,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """A BERT-family text encoder with its weights: from an HF model (or
    its name), or from ``config`` and ``state_dict``."""

    def load(name):
        from transformers import AutoModel

        return AutoModel.from_pretrained(name)

    cfg, sd = _model_and_config(model_name_or_path, config, state_dict, load)
    if getattr(cfg, "is_decoder", False):
        raise ValueError("HFTextEncoder requires an encoder model; got a decoder")
    from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder

    encoder = BertTextEncoder(
        vocab_size=cfg.vocab_size, max_length=cfg.max_position_embeddings,
        embed_dim=cfg.hidden_size, depth=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads, mlp_ratio=cfg.intermediate_size / cfg.hidden_size,
        norm_eps=cfg.layer_norm_eps, pooling=pooling, proj_dim=proj_dim, dtype=dtype,
    )
    converted = convert_bert(sd, cfg.num_hidden_layers, num_heads=cfg.num_attention_heads)
    return load_converted(encoder, converted, fresh=("proj.", "pooler."))


def hf_vit_tree(state_dict: Mapping[str, Any], depth: int, prefix: str = "vit",
                num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_hf_vit``'s tree (hf_wrappers.py)."""
    sd = state_dict
    p = f"{prefix}." if prefix else ""
    params: dict[str, Any] = {
        "patch_embed": {"proj": {
            "kernel": _np(sd[f"{p}embeddings.patch_embeddings.projection.weight"]).transpose(
                2, 3, 1, 0),
            "bias": _np(sd[f"{p}embeddings.patch_embeddings.projection.bias"])}},
        "cls_token": _np(sd[f"{p}embeddings.cls_token"]).reshape(1, 1, -1),
        "pos_embed": _np(sd[f"{p}embeddings.position_embeddings"]),
        "norm": _layernorm(sd, f"{p}layernorm"),
    }
    if num_heads is None:
        num_heads = params["cls_token"].shape[-1] // 64
    for i in range(depth):
        lp = f"{p}encoder.layer.{i}"
        names = ("query", "key", "value")
        kernels = [_np(sd[f"{lp}.attention.attention.{n}.weight"]).T for n in names]
        biases = [_np(sd[f"{lp}.attention.attention.{n}.bias"]) for n in names]
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{lp}.layernorm_before"),
            "attn": {"qkv": {
                "kernel": interleave_qkv_heads(np.concatenate(kernels, axis=1), num_heads),
                "bias": interleave_qkv_heads(np.concatenate(biases), num_heads)},
                "proj": _linear(sd, f"{lp}.attention.output.dense")},
            "norm2": _layernorm(sd, f"{lp}.layernorm_after"),
            "mlp": {"fc1": _linear(sd, f"{lp}.intermediate.dense"),
                    "fc2": _linear(sd, f"{lp}.output.dense")},
        }
    return params


def convert_hf_vit(state_dict: Mapping[str, Any], depth: int, prefix: str = "vit",
                   num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """HF ``ViTModel`` to ``VisionTransformer`` (cls token, learned
    positions, final norm, gelu, qkv bias)."""
    return jax_to_torch(hf_vit_tree(state_dict, depth, prefix, num_heads))


@store(group="modules/encoders", name="HFViTEncoder",
       populate_full_signature=False)
def HFViTEncoder(
    model_name_or_path: Any = "google/vit-base-patch16-224-in21k",
    global_pool: str = "cls",
    proj_dim: Optional[int] = None,
    dtype: Any = torch.float32,
    remat: bool = False,
    config: Any = None,
    state_dict: Optional[Mapping[str, Any]] = None,
) -> nn.Module:
    """An HF ViT vision encoder with its weights: from a ``ViTModel`` (or
    its name), or from ``config`` and ``state_dict``."""

    def load(name):
        from transformers import ViTModel

        return ViTModel.from_pretrained(name)

    cfg, sd = _model_and_config(model_name_or_path, config, state_dict, load)
    from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

    encoder = VisionTransformer(
        img_size=cfg.image_size, patch_size=cfg.patch_size, embed_dim=cfg.hidden_size,
        depth=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
        mlp_ratio=cfg.intermediate_size / cfg.hidden_size, qkv_bias=cfg.qkv_bias,
        use_cls_token=True, learned_pos_embed=True, final_norm=True, act_layer="gelu",
        norm_eps=cfg.layer_norm_eps, global_pool=global_pool, proj_dim=proj_dim, remat=remat,
        dtype=dtype,
    )
    # ViTModel checkpoints carry the "vit." prefix or not
    prefix = "vit" if any(k.startswith("vit.") for k in sd) else ""
    converted = convert_hf_vit(sd, cfg.num_hidden_layers, prefix=prefix,
                               num_heads=cfg.num_attention_heads)
    return load_converted(encoder, converted, fresh=("proj.",))


@store(group="modules/encoders", name="TimmViT", populate_full_signature=False)
def TimmViT(
    model_name: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    state_dict: Optional[Mapping[str, Any]] = None,
    projection_dim: int = 768,
    num_heads: Optional[int] = None,
    global_pool: str = "cls",
    dtype: Any = torch.float32,
    remat: bool = False,
    model: Any = None,
) -> nn.Module:
    """A timm ViT with a projection head (the reference's ``TimmViT``:
    ``timm.create_model(model_name, num_classes=projection_dim)``), its
    geometry read from the weights: a timm model object, ``state_dict``, a
    ``checkpoint_path`` (a torch state dict, or a trainer checkpoint holding
    one under ``state_dict`` or ``model``) or ``model_name`` (needs timm).
    A ``head`` of ``projection_dim`` rows becomes the biased ``proj``;
    otherwise ``proj`` keeps its initialisation."""
    sd = state_dict
    if sd is None and model is not None:
        sd = model.state_dict()
    if sd is None and checkpoint_path is not None:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            if isinstance(sd, dict) and isinstance(sd.get(key), dict):
                sd = sd[key]
                break
    if sd is None and model_name is not None:
        import timm

        sd = timm.create_model(model_name, pretrained=True).state_dict()
    if sd is None:
        raise ValueError("TimmViT requires one of model / state_dict / checkpoint_path / "
                         "model_name")
    sd = dict(sd)
    geo = timm_vit_geometry(sd, num_heads=num_heads)
    if "head.weight" in sd and _np(sd["head.weight"]).shape[0] != projection_dim:
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

    encoder = VisionTransformer(
        img_size=geo["img_size"], patch_size=geo["patch_size"], embed_dim=geo["embed_dim"],
        depth=geo["depth"], num_heads=geo["num_heads"], mlp_ratio=geo["mlp_ratio"],
        qkv_bias=geo["qkv_bias"], use_cls_token=True, learned_pos_embed=True,
        final_norm=True, act_layer="gelu", global_pool=global_pool, proj_dim=projection_dim,
        proj_bias=True, remat=remat, dtype=dtype,
    )
    return load_converted(encoder, convert_timm_vit(sd, num_heads=geo["num_heads"]),
                          fresh=("proj.",))
