"""Reference (Lightning) checkpoints into the port, counterpart of
:mod:`mmlearn_tpu.lightning_import`.

:func:`import_lightning_checkpoint` reads a reference ``.ckpt`` (a torch
pickle of ``{"state_dict", "global_step", "epoch", ...}``) and gives back an
*overlay*: the port task's ``state_dict`` entries for the weights the
checkpoint holds, with run metadata. Set it as ``task.init_overlay`` and
``Trainer.fit`` loads it (:func:`overlay_params`: every key must exist in
the task, with the same shape) before it builds the optimizer, then calls
``task.init_extras()``.

Task layouts, detected from the state dict's key prefixes:

- ContrastivePretraining: ``encoders.<key>.*``, each converted by the
  converter of :mod:`~mmlearn_tpu_torch.hf_utils` that its keys name (the
  table below), ``heads.<key>.*`` and ``postprocessors.<key>.*`` (a bare
  ``nn.Linear`` to a one-layer ``MLP``'s ``fc1``, the reference's
  Sequential ``MLP`` to ``fc{i}`` and ``norm{i}``) and ``log_logit_scale``;
- IJEPA: ``encoder.*`` and ``predictor.*``. The reference persists no
  teacher and restores it from the student on load; ``IJEPA.init_extras``
  does the same, and ``meta["ema"]`` (``{decay, num_updates}``) goes to
  ``task.apply_import_metadata``.

Encoder detection (keys of the encoder's own sub-dict):

================================================  =========================
key                                               converter
================================================  =========================
``model.text_model.embeddings.token_embedding.*`` convert_clip_text
``model.vision_model.embeddings.patch_embedding`` convert_clip_vision
``model.embeddings.token_embedding.weight``       convert_clip_text (bare)
``model.embeddings.patch_embedding.weight``       convert_clip_vision (bare)
``model.bert.embeddings.word_embeddings.weight``  convert_bert_mlm
``model.embeddings.word_embeddings.weight``       convert_bert
``model.patch_embed.proj.weight``                 convert_timm_vit
``patch_embed.proj.weight``                       convert_ijepa_vit
``predictor_embed.weight``                        convert_ijepa_predictor
================================================  =========================

A `peft`-wrapped encoder is unwrapped first: the base tower converts with
the trained ``modules_to_save`` copies, and each LoRA ``A``/``B`` pair lands
in the task's ``lora.<key>`` tree (:mod:`~mmlearn_tpu_torch.peft`): per-slice
factors for per-projection targets (``["query", "value"]``), head-interleaved
full factors for a fused ``qkv`` target (timm's). The task must be built with
the matching ``peft_configs``. The overlay is built as the JAX importer's
tree (copies of its functions, numpy only) and mapped with
:func:`~mmlearn_tpu_torch.bridge.jax_to_torch`. The JAX ``_stack_if_scanned``
and ``_stack_lora_entries`` (its scanned layout) have no counterpart.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch import hf_utils as H
from mmlearn_tpu_torch.bridge import jax_to_torch
from mmlearn_tpu_torch.ops.fused_attention import interleave_qkv_heads

__all__ = ["convert_reference_state_dict", "import_lightning_checkpoint", "overlay_params"]

logger = logging.getLogger(__name__)


def _load_ckpt(path: str) -> dict:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - pickled hyper_parameters need the full unpickler
        logger.warning(
            "%s: weights_only load failed (checkpoint carries pickled hyper_parameters); "
            "falling back to full unpickling -- only load checkpoints you trust", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def _strip(sd: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _np(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def _count_blocks(sd: Mapping[str, Any], pattern: str) -> int:
    idx = {int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m is not None}
    return max(idx) + 1 if idx else 0


def _is_peft_state_dict(sub: Mapping[str, Any]) -> bool:
    return any("base_model.model." in k or ".lora_A." in k or ".lora_B." in k for k in sub)


def _unwrap_peft_state_dict(sub: Mapping[str, Any]) -> tuple[dict, dict[str, dict[str, Any]]]:
    """One encoder's peft-wrapped state dict as ``(clean, lora_raw)``: the
    unwrapped names (the trained ``modules_to_save`` copy kept, the frozen
    original dropped, ``base_layer`` folded), and each target module's
    ``{"A": (r, in), "B": (out, r)}``."""
    clean: dict[str, Any] = {}
    lora: dict[str, dict[str, Any]] = {}
    for key, value in sub.items():
        key = key.replace("base_model.model.", "", 1)
        if ".original_module." in key or key.startswith("original_module."):
            continue
        key = key.replace(".modules_to_save.default", "").replace("modules_to_save.default.", "")
        m = re.match(r"(.*)\.lora_([AB])\.[^.]+\.weight$", key)
        if m is not None:
            lora.setdefault(m.group(1), {})[m.group(2)] = value
            continue
        if ".lora_" in key:
            raise ValueError(f"unsupported peft parameter {key!r}")
        clean[key.replace(".base_layer.", ".")] = value
    return clean, lora


#: torch attention-projection name to its fused-qkv slice
_QKV_SLICES = {"query": "q", "key": "k", "value": "v", "q_proj": "q", "k_proj": "k", "v_proj": "v"}

#: per converter family: (regex over the torch module path, the port layer's
#: JAX path); a ``slice`` group marks a per-projection target on the fused qkv
_LORA_PATH_TABLES: dict[str, list[tuple[str, str]]] = {
    "bert": [
        (r"model\.encoder\.layer\.(?P<i>\d+)\.attention\.self\.(?P<slice>query|key|value)$",
         "blocks_{i}/attn/qkv"),
        (r"model\.encoder\.layer\.(?P<i>\d+)\.attention\.output\.dense$", "blocks_{i}/attn/proj"),
        (r"model\.encoder\.layer\.(?P<i>\d+)\.intermediate\.dense$", "blocks_{i}/mlp/fc1"),
        (r"model\.encoder\.layer\.(?P<i>\d+)\.output\.dense$", "blocks_{i}/mlp/fc2"),
    ],
    "bert_mlm": [
        (r"model\.bert\.encoder\.layer\.(?P<i>\d+)\.attention\.self\."
         r"(?P<slice>query|key|value)$", "bert/blocks_{i}/attn/qkv"),
        (r"model\.bert\.encoder\.layer\.(?P<i>\d+)\.attention\.output\.dense$",
         "bert/blocks_{i}/attn/proj"),
        (r"model\.bert\.encoder\.layer\.(?P<i>\d+)\.intermediate\.dense$",
         "bert/blocks_{i}/mlp/fc1"),
        (r"model\.bert\.encoder\.layer\.(?P<i>\d+)\.output\.dense$", "bert/blocks_{i}/mlp/fc2"),
    ],
    "timm_vit": [
        (r"model\.blocks\.(?P<i>\d+)\.attn\.qkv$", "blocks_{i}/attn/qkv"),
        (r"model\.blocks\.(?P<i>\d+)\.attn\.proj$", "blocks_{i}/attn/proj"),
        (r"model\.blocks\.(?P<i>\d+)\.mlp\.fc1$", "blocks_{i}/mlp/fc1"),
        (r"model\.blocks\.(?P<i>\d+)\.mlp\.fc2$", "blocks_{i}/mlp/fc2"),
    ],
    "clip_text": [
        (r"model\.(?:text_model\.)?encoder\.layers\.(?P<i>\d+)\.self_attn\."
         r"(?P<slice>q_proj|k_proj|v_proj)$", "blocks_{i}/attn/qkv"),
        (r"model\.(?:text_model\.)?encoder\.layers\.(?P<i>\d+)\.self_attn\.out_proj$",
         "blocks_{i}/attn/proj"),
        (r"model\.(?:text_model\.)?encoder\.layers\.(?P<i>\d+)\.mlp\.fc1$", "blocks_{i}/mlp/fc1"),
        (r"model\.(?:text_model\.)?encoder\.layers\.(?P<i>\d+)\.mlp\.fc2$", "blocks_{i}/mlp/fc2"),
    ],
}
_LORA_PATH_TABLES["clip_vision"] = [
    (pat.replace("text_model", "vision_model"), tmpl) for pat, tmpl in _LORA_PATH_TABLES["clip_text"]
]


def _convert_lora_factors(family: str, lora_raw: Mapping[str, Mapping[str, Any]],
                          num_heads: Optional[int]) -> dict:
    """peft factors to the JAX ``params["lora"][<encoder>]`` layout (the
    port's ``lora.<encoder>`` tree through the bridge). torch adds ``B @ A``
    to an ``(out, in)`` weight, so ``a = A^T`` and ``b = B^T``; both sides
    apply ``alpha / r`` when merging, so the factors travel unscaled. A
    fused-qkv target's ``b`` is head-interleaved as the base kernel is."""
    table = _LORA_PATH_TABLES.get(family)
    if table is None:
        raise ValueError(f"LoRA import not supported for encoder family {family!r}")
    out: dict[str, dict] = {}
    for mod_path, ab in lora_raw.items():
        if set(ab) != {"A", "B"}:
            raise ValueError(f"incomplete LoRA factor pair for {mod_path!r}: {sorted(ab)}")
        for pattern, template in table:
            m = re.match(pattern, mod_path)
            if m is None:
                continue
            parent = template.format(i=m.group("i"))
            a, b = _np(ab["A"]).T, _np(ab["B"]).T
            slice_name = m.groupdict().get("slice")
            if slice_name is not None:
                out.setdefault(parent, {})[_QKV_SLICES[slice_name]] = {"a": a, "b": b}
            elif parent.endswith("/attn/qkv"):
                if num_heads is None:
                    raise ValueError("fused-qkv LoRA import needs num_heads (the fused "
                                     "kernel's head-interleaved packing)")
                out[parent] = {"a": a, "b": interleave_qkv_heads(b, num_heads)}
            else:
                out[parent] = {"a": a, "b": b}
            break
        else:
            raise ValueError(f"no LoRA path mapping for module {mod_path!r} (family {family!r})")
    return out


def _detect_encoder_converter(
    sub: Mapping[str, Any], num_heads: Optional[int] = None
) -> tuple[str, Callable[[Mapping[str, Any]], dict]]:
    """The family and tree converter of one encoder's stripped state dict;
    ``num_heads`` overrides the head-count inference."""
    if "model.text_model.embeddings.token_embedding.weight" in sub:
        depth = _count_blocks(sub, r"model\.text_model\.encoder\.layers\.(\d+)\.")
        return "clip_text", lambda sd: H.clip_text_tree(
            sd, depth, prefix="model.text_model", projection_key="model.text_projection.weight",
            num_heads=num_heads)
    if "model.vision_model.embeddings.patch_embedding.weight" in sub:
        depth = _count_blocks(sub, r"model\.vision_model\.encoder\.layers\.(\d+)\.")
        return "clip_vision", lambda sd: H.clip_vision_tree(
            sd, depth, prefix="model.vision_model",
            projection_key="model.visual_projection.weight", num_heads=num_heads)
    if "model.embeddings.token_embedding.weight" in sub:
        depth = _count_blocks(sub, r"model\.encoder\.layers\.(\d+)\.")
        return "clip_text", lambda sd: H.clip_text_tree(
            sd, depth, prefix="model", projection_key=None, num_heads=num_heads)
    if "model.embeddings.patch_embedding.weight" in sub:
        depth = _count_blocks(sub, r"model\.encoder\.layers\.(\d+)\.")
        return "clip_vision", lambda sd: H.clip_vision_tree(
            sd, depth, prefix="model", projection_key=None, num_heads=num_heads)
    if "model.bert.embeddings.word_embeddings.weight" in sub:
        depth = _count_blocks(sub, r"model\.bert\.encoder\.layer\.(\d+)\.")
        return "bert_mlm", lambda sd: H.bert_mlm_tree(sd, depth, prefix="model",
                                                      num_heads=num_heads)
    if "model.embeddings.word_embeddings.weight" in sub:
        depth = _count_blocks(sub, r"model\.encoder\.layer\.(\d+)\.")
        return "bert", lambda sd: H.bert_tree(sd, depth, prefix="model", num_heads=num_heads)
    if "model.patch_embed.proj.weight" in sub:
        return "timm_vit", lambda sd: H.timm_vit_tree(
            {k[len("model."):]: v for k, v in sd.items()}, num_heads=num_heads)
    if "patch_embed.proj.weight" in sub:
        depth = _count_blocks(sub, r"blocks\.(\d+)\.")
        dim = _np(sub["patch_embed.proj.weight"]).shape[0]
        heads = num_heads or {384: 6, 768: 12, 1024: 16, 1280: 16}.get(dim, max(dim // 64, 1))
        return "ijepa_vit", lambda sd: H.ijepa_vit_tree(sd, depth, heads)
    if "predictor_embed.weight" in sub:
        depth = _count_blocks(sub, r"predictor_blocks\.(\d+)\.")
        dim = _np(sub["predictor_embed.weight"]).shape[0]
        heads = num_heads or {384: 6, 768: 12}.get(dim, max(dim // 32, 1))
        return "ijepa_predictor", lambda sd: H.ijepa_predictor_tree(sd, depth, heads)
    raise ValueError("unrecognized encoder state dict (no converter matches); keys start "
                     f"with: {sorted(sub)[:6]}")


def _convert_sequential_head(sub: Mapping[str, Any]) -> dict:
    """A reference head as an ``MLP``'s tree: a bare ``nn.Linear`` to
    ``{fc1}``, the Sequential ``MLP`` (numeric children) to ``fc{i}`` and
    ``norm{i}``; a module of leaf parameters (a logit-scaling
    postprocessor) passes through."""
    if "weight" in sub:
        out = {"kernel": _np(sub["weight"]).T}
        if "bias" in sub:
            out["bias"] = _np(sub["bias"])
        return {"fc1": out}
    if not any(re.match(r"\d+\.", k) for k in sub):
        return {k: _np(v) for k, v in sub.items()}
    children: dict[int, dict] = {}
    for k, v in sub.items():
        m = re.match(r"(\d+)\.(weight|bias)$", k)
        if not m:
            raise ValueError(f"unrecognized head param {k!r}")
        children.setdefault(int(m.group(1)), {})[m.group(2)] = _np(v)
    params: dict[str, Any] = {}
    n_fc = n_norm = 0
    for idx in sorted(children):
        child = children[idx]
        if child["weight"].ndim == 2:
            n_fc += 1
            entry = {"kernel": child["weight"].T}
            if "bias" in child:
                entry["bias"] = child["bias"]
            params[f"fc{n_fc}"] = entry
        else:
            n_norm += 1
            params[f"norm{n_norm}"] = {"scale": child["weight"], "bias": child["bias"]}
    return params


def _overlay_tree(
    state_dict: Mapping[str, Any],
    converters: Optional[Mapping[str, Callable[[Mapping[str, Any]], dict]]] = None,
    num_heads: Any = None,
) -> dict:
    """The JAX ``convert_reference_state_dict``'s overlay tree (its
    parameter layout, numpy leaves)."""

    def heads_for(key: str) -> Optional[int]:
        return num_heads.get(key) if isinstance(num_heads, Mapping) else num_heads

    sd = dict(state_dict)
    overlay: dict[str, Any] = {}
    top = {k.split(".", 1)[0] for k in sd if "." in k}
    if "encoders" in top:
        overlay["encoders"] = {}
        lora_overlay: dict[str, dict] = {}
        for key in sorted({k.split(".")[1] for k in sd if k.startswith("encoders.")}):
            sub = _strip(sd, f"encoders.{key}.")
            lora_raw: dict[str, dict[str, Any]] = {}
            if _is_peft_state_dict(sub):
                sub, lora_raw = _unwrap_peft_state_dict(sub)
            conv = (converters or {}).get(key)
            name = None
            if conv is None or lora_raw:
                name, detected = _detect_encoder_converter(sub, heads_for(key))
                conv = conv or detected
                logger.info("encoders.%s: converting as %s", key, name)
            overlay["encoders"][key] = conv(sub)
            if lora_raw:
                lora_overlay[key] = _convert_lora_factors(name, lora_raw, heads_for(key))
        if lora_overlay:
            overlay["lora"] = lora_overlay
        for group in ("heads", "postprocessors"):
            keys = sorted({k.split(".")[1] for k in sd if k.startswith(f"{group}.")})
            if keys:
                overlay[group] = {key: _convert_sequential_head(_strip(sd, f"{group}.{key}."))
                                  for key in keys}
        if "log_logit_scale" in sd:
            overlay["log_logit_scale"] = _np(sd["log_logit_scale"]).reshape(())
        return overlay
    if "encoder" in top or "predictor" in top:
        for part in ("encoder", "predictor"):
            sub = _strip(sd, f"{part}.")
            if sub:
                overlay[part] = _detect_encoder_converter(sub, heads_for(part))[1](sub)
        return overlay
    raise ValueError(f"unrecognized reference task state dict (top-level keys: {sorted(top)})")


def convert_reference_state_dict(
    state_dict: Mapping[str, Any],
    converters: Optional[Mapping[str, Callable[[Mapping[str, Any]], dict]]] = None,
    num_heads: Any = None,
) -> dict[str, torch.Tensor]:
    """A reference task's ``state_dict`` as the port task's ``state_dict``
    entries. ``converters`` overrides the detected encoder converter by
    encoder key (a stripped sub state dict to the JAX converter's tree, as
    the ``*_tree`` functions of :mod:`~mmlearn_tpu_torch.hf_utils`);
    ``num_heads``: an int for every encoder or ``{encoder key: int}``.
    An I-JEPA checkpoint's overlay holds no teacher: ``IJEPA.init_extras``
    copies it from the imported student, as the reference restores it."""
    return jax_to_torch(_overlay_tree(state_dict, converters, num_heads))


def import_lightning_checkpoint(
    path: str,
    converters: Optional[Mapping[str, Callable]] = None,
    num_heads: Any = None,
) -> tuple[dict[str, torch.Tensor], dict]:
    """A reference Lightning ``.ckpt`` as ``(overlay, meta)``: the overlay
    of :func:`convert_reference_state_dict`, and ``meta`` with
    ``global_step``, ``epoch`` and, of an I-JEPA run, ``ema`` (``{decay,
    num_updates}`` of ``checkpoint["ema_params"]``)."""
    ckpt = _load_ckpt(path)
    overlay = convert_reference_state_dict(ckpt.get("state_dict", ckpt), converters, num_heads)
    meta = {"global_step": int(ckpt.get("global_step", 0)), "epoch": int(ckpt.get("epoch", 0))}
    if "ema_params" in ckpt:
        ema = ckpt["ema_params"]
        meta["ema"] = {"decay": float(ema.get("decay", 0.0)),
                       "num_updates": int(ema.get("num_updates", 0))}
    return overlay, meta


def overlay_params(module: nn.Module, overlay: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load ``overlay`` (``state_dict`` entries) into ``module`` in place:
    every key must be one of the module's, with the same shape; each value is
    cast to the dtype and device of the entry it replaces. Keys the overlay
    lacks keep their values."""
    state = module.state_dict(keep_vars=True)
    for key, value in overlay.items():
        if key not in state:
            raise ValueError(f"overlay param {key!r} not in the target module")
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"shape mismatch at {key!r}: overlay {tuple(value.shape)} vs "
                             f"target {tuple(state[key].shape)}")
    with torch.no_grad():
        for key, value in overlay.items():
            target = state[key]
            target.copy_(torch.as_tensor(value).to(device=target.device, dtype=target.dtype))
    return module
