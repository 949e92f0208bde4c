"""The port's towers to HuggingFace, timm and reference state dicts,
counterpart of :mod:`mmlearn_tpu.hf_export`: the inverse of
:mod:`mmlearn_tpu_torch.hf_utils`.

Each ``export_*`` maps a tower's ``state_dict`` (the port's keys) to the
keys of the torch model it came from, as f32 tensors ready for
``load_state_dict``: the head-major fused ``qkv`` back to separate q/k/v
projections (HF CLIP and BERT) or to timm's ``[q; k; v]`` rows
(:func:`~mmlearn_tpu_torch.ops.fused_attention.uninterleave_qkv_heads`), the
patch projection's ``(out, kh, kw, in)`` to torch's ``(out, in, kh, kw)``.

:func:`export_module` picks the format from the tower's type and geometry,
and :func:`export_task` exports every tower of a task: a contrastive task's
encoders with their LoRA deltas merged, a one-layer ``Dense`` head folded
into its tower's projection slot where that slot can hold it, other heads
and parameterised postprocessors under ``heads.<key>`` and
``postprocessors.<key>`` (their own ``state_dict``), and the learned
``logit_scale`` in HF CLIP's log form; an I-JEPA task's ``encoder``,
``predictor`` and ``target_encoder`` (the teacher).
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Mapping, Optional

import torch
from torch import nn

from mmlearn_tpu_torch.hf_utils import infer_num_heads
from mmlearn_tpu_torch.ops.fused_attention import uninterleave_qkv_heads

__all__ = ["export_bert", "export_clip", "export_clip_text", "export_clip_vision",
           "export_ijepa_predictor", "export_ijepa_vit", "export_module", "export_task",
           "export_timm_vit"]

logger = logging.getLogger(__name__)

StateDict = Mapping[str, torch.Tensor]


def _f32(t: Any) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _num_blocks(sd: StateDict, prefix: str = "") -> int:
    pattern = re.compile(rf"^{re.escape(prefix)}blocks\.(\d+)\.")
    depths = [int(m.group(1)) for k in sd for m in [pattern.match(k)] if m]
    if not depths:
        raise ValueError(f"no {prefix}blocks.{{i}} entries in the state dict")
    return max(depths) + 1


def _copy(out: dict, dst: str, sd: StateDict, src: str) -> None:
    """``src.weight`` (and ``src.bias`` where present) to ``dst``."""
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def _qkv_rows(sd: StateDict, src: str, num_heads: int) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fused head-major ``qkv`` as ``[q; k; v]`` rows ``(3C, in)`` and
    its bias."""
    w = uninterleave_qkv_heads(_f32(sd[f"{src}.weight"]).t(), num_heads).t().contiguous()
    b = sd.get(f"{src}.bias")
    return w, None if b is None else uninterleave_qkv_heads(_f32(b), num_heads).contiguous()


def _split_qkv(out: dict, sd: StateDict, src: str, num_heads: int, names: tuple[str, ...],
               dst: str) -> None:
    w, b = _qkv_rows(sd, src, num_heads)
    c = w.shape[0] // 3
    for i, name in enumerate(names):
        out[f"{dst}.{name}.weight"] = w[i * c:(i + 1) * c].clone()
        if b is not None:
            out[f"{dst}.{name}.bias"] = b[i * c:(i + 1) * c].clone()


def _patch_weight(w: torch.Tensor) -> torch.Tensor:
    return _f32(w).permute(0, 3, 1, 2).contiguous()


def _clip_block(out: dict, dst: str, sd: StateDict, src: str, num_heads: int) -> None:
    _copy(out, f"{dst}.layer_norm1", sd, f"{src}.norm1")
    _split_qkv(out, sd, f"{src}.attn.qkv", num_heads, ("q_proj", "k_proj", "v_proj"),
               f"{dst}.self_attn")
    _copy(out, f"{dst}.self_attn.out_proj", sd, f"{src}.attn.proj")
    _copy(out, f"{dst}.layer_norm2", sd, f"{src}.norm2")
    _copy(out, f"{dst}.mlp.fc1", sd, f"{src}.mlp.fc1")
    _copy(out, f"{dst}.mlp.fc2", sd, f"{src}.mlp.fc2")


def export_clip_vision(state_dict: StateDict, prefix: str = "vision_model",
                       projection_key: Optional[str] = "visual_projection.weight",
                       num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A CLIP-config ``VisionTransformer``'s state dict as HF
    ``CLIPVisionModel(WithProjection)``'s."""
    sd = state_dict
    if num_heads is None:
        num_heads = infer_num_heads(sd["cls_token"].shape[-1])
    out = {f"{prefix}.embeddings.patch_embedding.weight": _patch_weight(sd["patch_embed.proj.weight"]),
           f"{prefix}.embeddings.class_embedding": _f32(sd["cls_token"]).reshape(-1),
           f"{prefix}.embeddings.position_embedding.weight": _f32(sd["pos_embed"])[0]}
    if "patch_embed.proj.bias" in sd:
        out[f"{prefix}.embeddings.patch_embedding.bias"] = _f32(sd["patch_embed.proj.bias"])
    _copy(out, f"{prefix}.pre_layrnorm", sd, "norm_pre")
    _copy(out, f"{prefix}.post_layernorm", sd, "norm")
    for i in range(_num_blocks(sd)):
        _clip_block(out, f"{prefix}.encoder.layers.{i}", sd, f"blocks.{i}", num_heads)
    if projection_key and "proj.weight" in sd:
        out[projection_key] = _f32(sd["proj.weight"])
    return out


def export_clip_text(state_dict: StateDict, prefix: str = "text_model",
                     projection_key: Optional[str] = "text_projection.weight",
                     num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A CLIP-config ``TextTransformer``'s state dict as HF
    ``CLIPTextModel(WithProjection)``'s."""
    sd = state_dict
    if num_heads is None:
        num_heads = sd["token_embedding.weight"].shape[-1] // 64
    out = {f"{prefix}.embeddings.token_embedding.weight": _f32(sd["token_embedding.weight"]),
           f"{prefix}.embeddings.position_embedding.weight": _f32(sd["pos_embed"])[0]}
    _copy(out, f"{prefix}.final_layer_norm", sd, "norm")
    for i in range(_num_blocks(sd)):
        _clip_block(out, f"{prefix}.encoder.layers.{i}", sd, f"blocks.{i}", num_heads)
    if projection_key and "proj.weight" in sd:
        out[projection_key] = _f32(sd["proj.weight"])
    return out


def export_clip(vision_state_dict: StateDict, text_state_dict: StateDict,
                log_logit_scale: float = math.log(1 / 0.07),
                vision_num_heads: Optional[int] = None,
                text_num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A whole HF ``CLIPModel`` state dict: both towers and the learned log
    logit scale (the task's ``log_logit_scale``)."""
    out = export_clip_vision(vision_state_dict, num_heads=vision_num_heads)
    out.update(export_clip_text(text_state_dict, num_heads=text_num_heads))
    out["logit_scale"] = torch.tensor(float(log_logit_scale), dtype=torch.float32)
    return out


def export_bert(state_dict: StateDict, prefix: str = "",
                num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A ``BertTextEncoder``'s state dict as HF ``BertModel``'s."""
    sd = state_dict
    p = f"{prefix}." if prefix else ""
    if num_heads is None:
        num_heads = sd["embed_norm.weight"].shape[-1] // 64
    out = {f"{p}embeddings.word_embeddings.weight": _f32(sd["token_embedding.weight"]),
           f"{p}embeddings.position_embeddings.weight": _f32(sd["position_embedding.weight"]),
           f"{p}embeddings.token_type_embeddings.weight": _f32(sd["token_type_embedding.weight"])}
    _copy(out, f"{p}embeddings.LayerNorm", sd, "embed_norm")
    for i in range(_num_blocks(sd)):
        lp, src = f"{p}encoder.layer.{i}", f"blocks.{i}"
        _split_qkv(out, sd, f"{src}.attn.qkv", num_heads, ("query", "key", "value"),
                   f"{lp}.attention.self")
        _copy(out, f"{lp}.attention.output.dense", sd, f"{src}.attn.proj")
        _copy(out, f"{lp}.attention.output.LayerNorm", sd, f"{src}.attn_norm")
        _copy(out, f"{lp}.intermediate.dense", sd, f"{src}.mlp.fc1")
        _copy(out, f"{lp}.output.dense", sd, f"{src}.mlp.fc2")
        _copy(out, f"{lp}.output.LayerNorm", sd, f"{src}.mlp_norm")
    if "pooler.weight" in sd:
        _copy(out, f"{p}pooler.dense", sd, "pooler")
    return out


def _vit_block(out: dict, dst: str, sd: StateDict, src: str, num_heads: int,
               mlp_keys: tuple[str, str] = ("mlp.fc1", "mlp.fc2")) -> None:
    """A timm / I-JEPA block: the fused ``qkv`` stays fused, rows ``[q; k; v]``."""
    _copy(out, f"{dst}.norm1", sd, f"{src}.norm1")
    w, b = _qkv_rows(sd, f"{src}.attn.qkv", num_heads)
    out[f"{dst}.attn.qkv.weight"] = w
    if b is not None:
        out[f"{dst}.attn.qkv.bias"] = b
    _copy(out, f"{dst}.attn.proj", sd, f"{src}.attn.proj")
    _copy(out, f"{dst}.norm2", sd, f"{src}.norm2")
    _copy(out, f"{dst}.{mlp_keys[0]}", sd, f"{src}.mlp.fc1")
    _copy(out, f"{dst}.{mlp_keys[1]}", sd, f"{src}.mlp.fc2")


def export_timm_vit(state_dict: StateDict, num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A timm-config ``VisionTransformer``'s state dict as timm
    ``VisionTransformer``'s; a projection exports as timm's ``head``."""
    sd = state_dict
    if num_heads is None:
        num_heads = infer_num_heads(sd["cls_token"].shape[-1])
    out = {"patch_embed.proj.weight": _patch_weight(sd["patch_embed.proj.weight"]),
           "patch_embed.proj.bias": _f32(sd["patch_embed.proj.bias"]),
           "cls_token": _f32(sd["cls_token"]), "pos_embed": _f32(sd["pos_embed"])}
    _copy(out, "norm", sd, "norm")
    for i in range(_num_blocks(sd)):
        _vit_block(out, f"blocks.{i}", sd, f"blocks.{i}", num_heads)
    if "proj.weight" in sd:
        _copy(out, "head", sd, "proj")
    return out


def export_ijepa_vit(state_dict: StateDict, num_heads: int) -> dict[str, torch.Tensor]:
    """An I-JEPA-config ``VisionTransformer``'s state dict as the reference
    I-JEPA ``VisionTransformer``'s (a learned ``pos_embed`` under its own
    key; a fixed sin-cos table is not a parameter on either side). The
    reference format has no projection head: a tower with one raises."""
    sd = state_dict
    if "proj.weight" in sd:
        raise ValueError("the reference I-JEPA ViT format has no projection head: export a "
                         "timm- or CLIP-format tower instead")
    out = {"patch_embed.proj.weight": _patch_weight(sd["patch_embed.proj.weight"]),
           "patch_embed.proj.bias": _f32(sd["patch_embed.proj.bias"])}
    if "pos_embed" in sd:
        out["pos_embed"] = _f32(sd["pos_embed"])
    _copy(out, "norm", sd, "norm")
    for i in range(_num_blocks(sd)):
        _vit_block(out, f"blocks.{i}", sd, f"blocks.{i}", num_heads, ("mlp.0", "mlp.3"))
    return out


def export_ijepa_predictor(state_dict: StateDict, num_heads: int) -> dict[str, torch.Tensor]:
    """A ``VisionTransformerPredictor``'s state dict as the reference
    predictor's."""
    sd = state_dict
    out = {"mask_token": _f32(sd["mask_token"])}
    _copy(out, "predictor_embed", sd, "predictor_embed")
    _copy(out, "predictor_norm", sd, "norm")
    _copy(out, "predictor_proj", sd, "predictor_proj")
    for i in range(_num_blocks(sd)):
        _vit_block(out, f"predictor_blocks.{i}", sd, f"blocks.{i}", num_heads,
                   ("mlp.0", "mlp.3"))
    return out


def export_module(module: nn.Module, state_dict: Optional[StateDict] = None) -> dict[str, torch.Tensor]:
    """A port tower (its ``state_dict`` with each LoRA'd layer's weight
    merged, or ``state_dict`` where given) in the format its type and
    geometry name: ``BertTextEncoder`` to HF BERT,
    ``TextTransformer`` to HF CLIP text, a ``VisionTransformer`` with
    ``pre_norm`` to HF CLIP vision, with a cls token to timm, else to the
    reference I-JEPA encoder, ``VisionTransformerPredictor`` to the
    reference predictor. Raises ``TypeError`` for other modules."""
    from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
    from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
    from mmlearn_tpu_torch.modules.encoders.vision import (
        VisionTransformer,
        VisionTransformerPredictor,
    )
    from mmlearn_tpu_torch.modules.layers.embedding import get_2d_sincos_pos_embed
    from mmlearn_tpu_torch.peft import merged_state_dict

    sd = dict(merged_state_dict(module) if state_dict is None else state_dict)
    cfg = getattr(module, "config", {})
    if isinstance(module, BertTextEncoder):
        return export_bert(sd, num_heads=cfg["num_heads"])
    if isinstance(module, TextTransformer):
        return export_clip_text(sd, num_heads=cfg["num_heads"])
    if isinstance(module, VisionTransformerPredictor):
        return export_ijepa_predictor(sd, num_heads=module.blocks[0].attn.num_heads)
    if isinstance(module, VisionTransformer):
        if cfg["pre_norm"] or cfg["use_cls_token"]:
            if "pos_embed" not in sd:
                # a fixed sin-cos table: torch formats carry positions as a tensor
                table = get_2d_sincos_pos_embed(cfg["embed_dim"],
                                                cfg["img_size"] // cfg["patch_size"],
                                                cls_token=cfg["use_cls_token"])
                sd["pos_embed"] = torch.from_numpy(table)[None]
            if cfg["pre_norm"]:
                return export_clip_vision(sd, num_heads=cfg["num_heads"])
            return export_timm_vit(sd, num_heads=cfg["num_heads"])
        return export_ijepa_vit(sd, num_heads=cfg["num_heads"])
    raise TypeError(f"No torch-format exporter for {type(module).__name__}: export_module "
                    "covers VisionTransformer, TextTransformer, BertTextEncoder and "
                    "VisionTransformerPredictor")


def _proj_slot(module: nn.Module) -> Optional[str]:
    """What the tower's format can hold in its projection slot: HF CLIP's
    projections have no bias, timm's ``head`` has one, BERT and I-JEPA
    have no slot."""
    from mmlearn_tpu_torch.modules.encoders.text import TextTransformer
    from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer

    if isinstance(module, TextTransformer):
        return "kernel_only"
    if type(module) is VisionTransformer:
        if module.config["pre_norm"]:
            return "kernel_only"
        if module.config["use_cls_token"]:
            return "kernel_bias"
    return None


def _f32_state(module: nn.Module) -> dict[str, torch.Tensor]:
    return {k: _f32(v) for k, v in module.state_dict().items()}


def export_task(task: nn.Module, skip_unknown: bool = False) -> dict[str, dict[str, torch.Tensor]]:
    """Every exportable tower of ``task`` as ``{name: state dict}`` (see the
    module docstring). ``skip_unknown``: skip, with a warning, an encoder
    that :func:`export_module` has no format for, instead of raising."""
    from mmlearn_tpu_torch.modules.layers.dense import Dense
    from mmlearn_tpu_torch.peft import merged_state_dict

    out: dict[str, dict[str, torch.Tensor]] = {}
    if hasattr(task, "encoders") and hasattr(task, "modalities"):
        enc_heads: dict[str, set] = {}
        for m in task.modalities:
            if task.head_keys[m] in task.heads:
                enc_heads.setdefault(task.encoder_keys[m], set()).add(task.head_keys[m])
        folded: set = set()
        for key, module in task.encoders.items():
            sd = merged_state_dict(module)
            hks = enc_heads.get(key, set())
            slot = _proj_slot(module)
            if len(hks) == 1 and slot and "proj.weight" not in sd:
                hk = next(iter(hks))
                head = task.heads[hk]
                if isinstance(head, Dense) and (head.bias is None or slot == "kernel_bias"):
                    # the projection head folds into the tower's slot
                    sd["proj.weight"] = head.merged_weight().detach()
                    if head.bias is not None:
                        sd["proj.bias"] = head.bias.detach()
                    folded.add(hk)
            try:
                out[key] = export_module(module, sd)
            except (TypeError, ValueError):
                if not skip_unknown:
                    raise
                logger.warning("Skipping encoder %r (%s): no torch-format exporter", key,
                               type(module).__name__)
        for hk, head in task.heads.items():
            if hk not in folded and any(True for _ in head.parameters()):
                logger.warning("Projection head %r cannot fold into a tower's projection slot: "
                               "exported separately as 'heads.%s'", hk, hk)
                out[f"heads.{hk}"] = _f32_state(head)
        for pk, post in task.postprocessors.items():
            if any(True for _ in post.parameters()):
                logger.warning("Postprocessor %r has parameters with no torch-side naming: "
                               "exported separately as 'postprocessors.%s'", pk, pk)
                out[f"postprocessors.{pk}"] = _f32_state(post)
        out["logit_scale"] = {"logit_scale": _f32(task.log_logit_scale)}
        return out
    if hasattr(task, "encoder") and hasattr(task, "predictor"):
        out["encoder"] = export_module(task.encoder)
        out["predictor"] = export_module(task.predictor)
        if hasattr(task, "teacher"):
            out["target_encoder"] = export_module(task.teacher)
        return out
    raise TypeError(f"export_task covers ContrastivePretraining- and IJEPA-shaped tasks, got "
                    f"{type(task).__name__}")
