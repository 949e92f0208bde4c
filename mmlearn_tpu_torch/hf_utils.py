"""HuggingFace, timm and reference state dicts to the port's state dicts,
counterpart of :mod:`mmlearn_tpu.hf_utils`.

Each ``convert_*`` takes a torch state dict (tensors or arrays) and returns
the ``state_dict`` of the port's tower with that checkpoint's weights:

- :func:`convert_clip_vision` / :func:`convert_clip_text`: HF
  ``CLIPVisionModel``/``CLIPTextModel`` (with or without projection) to
  :class:`~mmlearn_tpu_torch.modules.encoders.VisionTransformer` (CLIP
  config: ``pre_norm``, no patch bias, ``quick_gelu``, cls pooling) and
  :class:`~mmlearn_tpu_torch.modules.encoders.TextTransformer` (causal, eos
  pooling); :func:`clip_modules_from_config` builds both from an HF
  ``CLIPConfig``;
- :func:`convert_bert`: HF ``BertModel`` to
  :class:`~mmlearn_tpu_torch.modules.encoders.bert.BertTextEncoder`;
- :func:`convert_timm_vit` (geometry from :func:`timm_vit_geometry`): a timm
  ``VisionTransformer`` to ``VisionTransformer`` (its ``head`` to ``proj``,
  with a bias);
- :func:`convert_bert_mlm`: a ``BertForMaskedLM``-shaped tower to
  :class:`~mmlearn_tpu_torch.projects.bioscan_clip.encoders.BarcodeBERT`;
- :func:`convert_ijepa_vit` / :func:`convert_ijepa_predictor`: the
  reference I-JEPA encoder and predictor.

Separate q/k/v projections are concatenated ``[q | k | v]`` and
head-interleaved into the fused ``qkv`` layout that kernel K1 reads
(:func:`~mmlearn_tpu_torch.ops.fused_attention.interleave_qkv_heads`); timm's
fused ``qkv`` rows are already ``[q; k; v]``. Each converter builds the JAX
converter's parameter tree (the ``*_tree`` functions, copies of the JAX
package's, numpy only) and maps it with :func:`~mmlearn_tpu_torch.bridge.
jax_to_torch`, so its output equals ``jax_to_torch`` of the JAX converter's
bit for bit. The JAX package's ``stack_block_params`` (its scanned layout)
and deferred pretrained loaders have no counterpart: the port has one block
layout, and its factories load the weights at once.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from mmlearn_tpu_torch.bridge import jax_to_torch
from mmlearn_tpu_torch.ops.fused_attention import interleave_qkv_heads


def _np(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping[str, Any], prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _fused_qkv(sd: Mapping[str, Any], prefix: str, num_heads: int,
               names: tuple[str, str, str] = ("q_proj", "k_proj", "v_proj")) -> dict:
    """Separate q/k/v projections as one head-major ``(in, 3 * out)`` kernel."""
    kernels = [_np(sd[f"{prefix}.{n}.weight"]).T for n in names]
    out = {"kernel": interleave_qkv_heads(np.concatenate(kernels, axis=1), num_heads)}
    if f"{prefix}.{names[0]}.bias" in sd:
        biases = [_np(sd[f"{prefix}.{n}.bias"]) for n in names]
        out["bias"] = interleave_qkv_heads(np.concatenate(biases), num_heads)
    return out


def _clip_block(sd: Mapping[str, Any], prefix: str, num_heads: int) -> dict:
    return {
        "norm1": _layernorm(sd, f"{prefix}.layer_norm1"),
        "attn": {"qkv": _fused_qkv(sd, f"{prefix}.self_attn", num_heads),
                 "proj": _linear(sd, f"{prefix}.self_attn.out_proj")},
        "norm2": _layernorm(sd, f"{prefix}.layer_norm2"),
        "mlp": {"fc1": _linear(sd, f"{prefix}.mlp.fc1"),
                "fc2": _linear(sd, f"{prefix}.mlp.fc2")},
    }


def infer_num_heads(embed_dim: int) -> int:
    """The head count of a ViT of this width where the checkpoint does not
    say: the standard presets' (ViT-H is 1280/16, D=80; ViT-g 1408/16,
    D=88), else ``embed_dim // 64``."""
    from mmlearn_tpu_torch.modules.encoders.vision import _VIT_DIMS

    for cfg in _VIT_DIMS.values():
        if cfg["embed_dim"] == embed_dim:
            return int(cfg["num_heads"])
    if embed_dim % 64:
        raise ValueError(f"Cannot infer num_heads for embed_dim={embed_dim} (not a standard "
                         "ViT width and not divisible by 64): pass num_heads")
    return max(1, embed_dim // 64)


# -- CLIP ---------------------------------------------------------------------


def clip_vision_tree(state_dict: Mapping[str, Any], depth: int, prefix: str = "vision_model",
                     projection_key: Optional[str] = "visual_projection.weight",
                     num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_clip_vision``'s tree (hf_utils.py:108)."""
    sd = state_dict
    params: dict[str, Any] = {
        "patch_embed": {"proj": {"kernel": _np(
            sd[f"{prefix}.embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)}},
        "cls_token": _np(sd[f"{prefix}.embeddings.class_embedding"]).reshape(1, 1, -1),
        "pos_embed": _np(sd[f"{prefix}.embeddings.position_embedding.weight"])[None],
        "norm_pre": _layernorm(sd, f"{prefix}.pre_layrnorm"),
        "norm": _layernorm(sd, f"{prefix}.post_layernorm"),
    }
    if f"{prefix}.embeddings.patch_embedding.bias" in sd:
        params["patch_embed"]["proj"]["bias"] = _np(sd[f"{prefix}.embeddings.patch_embedding.bias"])
    if num_heads is None:
        num_heads = infer_num_heads(params["cls_token"].shape[-1])
    for i in range(depth):
        params[f"blocks_{i}"] = _clip_block(sd, f"{prefix}.encoder.layers.{i}", num_heads)
    if projection_key and projection_key in sd:
        params["proj"] = {"kernel": _np(sd[projection_key]).T}
    return params


def convert_clip_vision(state_dict: Mapping[str, Any], depth: int, prefix: str = "vision_model",
                        projection_key: Optional[str] = "visual_projection.weight",
                        num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """HF ``CLIPVisionModel(WithProjection)`` to the CLIP-config
    ``VisionTransformer``. HF applies ``post_layernorm`` to the pooled cls
    token only, the port to every token: the pooled output is the same."""
    return jax_to_torch(clip_vision_tree(state_dict, depth, prefix, projection_key, num_heads))


def clip_text_tree(state_dict: Mapping[str, Any], depth: int, prefix: str = "text_model",
                   projection_key: Optional[str] = "text_projection.weight",
                   num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_clip_text``'s tree (hf_utils.py:154)."""
    sd = state_dict
    params: dict[str, Any] = {
        "token_embedding": {"embedding": _np(sd[f"{prefix}.embeddings.token_embedding.weight"])},
        "pos_embed": _np(sd[f"{prefix}.embeddings.position_embedding.weight"])[None],
        "norm": _layernorm(sd, f"{prefix}.final_layer_norm"),
    }
    if num_heads is None:
        num_heads = params["token_embedding"]["embedding"].shape[-1] // 64
    for i in range(depth):
        params[f"blocks_{i}"] = _clip_block(sd, f"{prefix}.encoder.layers.{i}", num_heads)
    if projection_key and projection_key in sd:
        params["proj"] = {"kernel": _np(sd[projection_key]).T}
    return params


def convert_clip_text(state_dict: Mapping[str, Any], depth: int, prefix: str = "text_model",
                      projection_key: Optional[str] = "text_projection.weight",
                      num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """HF ``CLIPTextModel(WithProjection)`` to the causal, eos-pooled
    ``TextTransformer``."""
    return jax_to_torch(clip_text_tree(state_dict, depth, prefix, projection_key, num_heads))


def clip_vision_kwargs(hf_config: Any) -> dict[str, Any]:
    """``VisionTransformer`` arguments of an HF ``CLIPConfig``'s vision tower
    (with its projection)."""
    v = hf_config.vision_config
    return dict(
        img_size=v.image_size, patch_size=v.patch_size, embed_dim=v.hidden_size,
        depth=v.num_hidden_layers, num_heads=v.num_attention_heads,
        mlp_ratio=v.intermediate_size / v.hidden_size, qkv_bias=True, use_cls_token=True,
        learned_pos_embed=True, pre_norm=True, final_norm=True, act_layer="quick_gelu",
        norm_eps=v.layer_norm_eps, global_pool="cls", proj_dim=hf_config.projection_dim,
        patch_embed_bias=False,
    )


def clip_text_kwargs(hf_config: Any) -> dict[str, Any]:
    """``TextTransformer`` arguments of an HF ``CLIPConfig``'s text tower
    (with its projection)."""
    t = hf_config.text_config
    return dict(
        vocab_size=t.vocab_size, max_length=t.max_position_embeddings,
        embed_dim=t.hidden_size, depth=t.num_hidden_layers, num_heads=t.num_attention_heads,
        mlp_ratio=t.intermediate_size / t.hidden_size, qkv_bias=True, causal=True,
        act_layer="quick_gelu", norm_eps=t.layer_norm_eps, pooling="eos",
        proj_dim=hf_config.projection_dim,
    )


def clip_modules_from_config(hf_config: Any, dtype: Any = torch.float32) -> tuple:
    """``(vision, text)`` port towers of an HF ``CLIPConfig``'s geometry."""
    from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
    from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

    return (VisionTransformer(**clip_vision_kwargs(hf_config), dtype=dtype),
            TextTransformer(**clip_text_kwargs(hf_config), dtype=dtype))


# -- BERT ---------------------------------------------------------------------


def bert_tree(state_dict: Mapping[str, Any], depth: int, prefix: str = "",
              num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_bert``'s tree (hf_utils.py:296)."""
    sd = state_dict
    p = f"{prefix}." if prefix else ""
    params: dict[str, Any] = {
        "token_embedding": {"embedding": _np(sd[f"{p}embeddings.word_embeddings.weight"])},
        "position_embedding": {"embedding": _np(sd[f"{p}embeddings.position_embeddings.weight"])},
        "token_type_embedding": {
            "embedding": _np(sd[f"{p}embeddings.token_type_embeddings.weight"])},
        "embed_norm": _layernorm(sd, f"{p}embeddings.LayerNorm"),
    }
    if num_heads is None:
        num_heads = params["embed_norm"]["scale"].shape[-1] // 64
    for i in range(depth):
        lp = f"{p}encoder.layer.{i}"
        params[f"blocks_{i}"] = {
            "attn": {"qkv": _fused_qkv(sd, f"{lp}.attention.self", num_heads,
                                       ("query", "key", "value")),
                     "proj": _linear(sd, f"{lp}.attention.output.dense")},
            "attn_norm": _layernorm(sd, f"{lp}.attention.output.LayerNorm"),
            "mlp": {"fc1": _linear(sd, f"{lp}.intermediate.dense"),
                    "fc2": _linear(sd, f"{lp}.output.dense")},
            "mlp_norm": _layernorm(sd, f"{lp}.output.LayerNorm"),
        }
    if f"{p}pooler.dense.weight" in sd:
        params["pooler"] = _linear(sd, f"{p}pooler.dense")
    return params


def convert_bert(state_dict: Mapping[str, Any], depth: int, prefix: str = "",
                 num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """HF ``BertModel`` to ``BertTextEncoder`` (its pooler where the
    checkpoint has one)."""
    return jax_to_torch(bert_tree(state_dict, depth, prefix, num_heads))


def bert_mlm_tree(state_dict: Mapping[str, Any], depth: int, prefix: str = "",
                  num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_bert_mlm``'s tree (hf_utils.py:475)."""
    p = f"{prefix}." if prefix else ""
    params: dict[str, Any] = {"bert": bert_tree(state_dict, depth, f"{p}bert", num_heads)}
    if f"{p}cls.predictions.transform.dense.weight" in state_dict:
        params["transform"] = _linear(state_dict, f"{p}cls.predictions.transform.dense")
        params["transform_norm"] = _layernorm(state_dict,
                                              f"{p}cls.predictions.transform.LayerNorm")
    if f"{p}cls.predictions.decoder.weight" in state_dict:
        params["decoder"] = _linear(state_dict, f"{p}cls.predictions.decoder")
    return params


def convert_bert_mlm(state_dict: Mapping[str, Any], depth: int, prefix: str = "",
                     num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A ``BertForMaskedLM``-shaped tower to ``BarcodeBERT``: the ``bert``
    trunk, the MLM head's ``transform`` and ``transform_norm``, and the
    ``decoder`` (the reference replaces the MLM decoder by the projection)."""
    return jax_to_torch(bert_mlm_tree(state_dict, depth, prefix, num_heads))


# -- timm ViT -----------------------------------------------------------------


def timm_vit_geometry(state_dict: Mapping[str, Any], num_heads: Optional[int] = None) -> dict:
    """A timm ViT's geometry from its state dict (``img_size``,
    ``patch_size``, ``embed_dim``, ``depth``, ``mlp_ratio``, ``num_heads``,
    ``qkv_bias``); ``num_heads`` where given skips the head-count inference,
    the one fact a ViT state dict does not hold."""
    sd = state_dict
    embed_dim = int(_np(sd["cls_token"]).shape[-1])
    patch = int(_np(sd["patch_embed.proj.weight"]).shape[-1])
    grid = int(round((int(_np(sd["pos_embed"]).shape[1]) - 1) ** 0.5))
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    mlp_hidden = int(_np(sd["blocks.0.mlp.fc1.weight"]).shape[0])
    return {
        "img_size": grid * patch, "patch_size": patch, "embed_dim": embed_dim, "depth": depth,
        "mlp_ratio": mlp_hidden / embed_dim,
        "num_heads": int(num_heads) if num_heads is not None else infer_num_heads(embed_dim),
        "qkv_bias": "blocks.0.attn.qkv.bias" in sd,
    }


def _fused_timm_qkv(sd: Mapping[str, Any], lp: str, num_heads: int) -> dict:
    qkv = {"kernel": interleave_qkv_heads(_np(sd[f"{lp}.attn.qkv.weight"]).T, num_heads)}
    if f"{lp}.attn.qkv.bias" in sd:
        qkv["bias"] = interleave_qkv_heads(_np(sd[f"{lp}.attn.qkv.bias"]), num_heads)
    return qkv


def timm_vit_tree(state_dict: Mapping[str, Any], depth: Optional[int] = None,
                  num_heads: Optional[int] = None) -> dict:
    """The JAX ``convert_timm_vit``'s tree (hf_utils.py:413)."""
    sd = state_dict
    geo = timm_vit_geometry(sd, num_heads=num_heads)
    depth = geo["depth"] if depth is None else depth
    num_heads = geo["num_heads"]
    params: dict[str, Any] = {
        "patch_embed": {"proj": {
            "kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd["patch_embed.proj.bias"])}},
        "cls_token": _np(sd["cls_token"]).reshape(1, 1, -1),
        "pos_embed": _np(sd["pos_embed"]),
        "norm": _layernorm(sd, "norm"),
    }
    for i in range(depth):
        lp = f"blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{lp}.norm1"),
            "attn": {"qkv": _fused_timm_qkv(sd, lp, num_heads),
                     "proj": _linear(sd, f"{lp}.attn.proj")},
            "norm2": _layernorm(sd, f"{lp}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{lp}.mlp.fc1"), "fc2": _linear(sd, f"{lp}.mlp.fc2")},
        }
    if "head.weight" in sd:
        params["proj"] = _linear(sd, "head")
    return params


def convert_timm_vit(state_dict: Mapping[str, Any], depth: Optional[int] = None,
                     num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A timm ``VisionTransformer`` to ``VisionTransformer`` (cls token,
    learned positions, final norm, gelu; its ``head`` to a biased
    ``proj``)."""
    return jax_to_torch(timm_vit_tree(state_dict, depth, num_heads))


# -- I-JEPA -------------------------------------------------------------------


def _ijepa_block(sd: Mapping[str, Any], lp: str, num_heads: int) -> dict:
    """A reference I-JEPA block; its MLP is a Sequential (``mlp.0``, ``mlp.3``)."""
    return {
        "norm1": _layernorm(sd, f"{lp}.norm1"),
        "attn": {"qkv": _fused_timm_qkv(sd, lp, num_heads), "proj": _linear(sd, f"{lp}.attn.proj")},
        "norm2": _layernorm(sd, f"{lp}.norm2"),
        "mlp": {"fc1": _linear(sd, f"{lp}.mlp.0"), "fc2": _linear(sd, f"{lp}.mlp.3")},
    }


def ijepa_vit_tree(state_dict: Mapping[str, Any], depth: int, num_heads: int) -> dict:
    """The JAX ``convert_ijepa_vit``'s tree (hf_utils.py:535)."""
    sd = state_dict
    params: dict[str, Any] = {
        "patch_embed": {"proj": {
            "kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd["patch_embed.proj.bias"])}},
        "norm": _layernorm(sd, "norm"),
    }
    for i in range(depth):
        params[f"blocks_{i}"] = _ijepa_block(sd, f"blocks.{i}", num_heads)
    return params


def convert_ijepa_vit(state_dict: Mapping[str, Any], depth: int,
                      num_heads: int) -> dict[str, torch.Tensor]:
    """The reference I-JEPA ``VisionTransformer`` (its fixed sin-cos
    ``pos_embed`` buffer dropped: the port computes it) to the I-JEPA-config
    ``VisionTransformer``."""
    return jax_to_torch(ijepa_vit_tree(state_dict, depth, num_heads))


def ijepa_predictor_tree(state_dict: Mapping[str, Any], depth: int, num_heads: int) -> dict:
    """The JAX ``convert_ijepa_predictor``'s tree (hf_utils.py:563)."""
    sd = state_dict
    params: dict[str, Any] = {
        "predictor_embed": _linear(sd, "predictor_embed"),
        "mask_token": _np(sd["mask_token"]),
        "norm": _layernorm(sd, "predictor_norm"),
        "predictor_proj": _linear(sd, "predictor_proj"),
    }
    for i in range(depth):
        params[f"blocks_{i}"] = _ijepa_block(sd, f"predictor_blocks.{i}", num_heads)
    return params


def convert_ijepa_predictor(state_dict: Mapping[str, Any], depth: int,
                            num_heads: int) -> dict[str, torch.Tensor]:
    """The reference ``VisionTransformerPredictor`` to the port's."""
    return jax_to_torch(ijepa_predictor_tree(state_dict, depth, num_heads))
