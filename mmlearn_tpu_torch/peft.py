"""Parameter-efficient fine-tuning: LoRA and layer freezing, counterpart of
:mod:`mmlearn_tpu.peft`.

- :class:`LoRAConfig` has the JAX config's fields. Its ``target_patterns``
  (``re.match``) select layers by their path written the JAX way
  (``blocks_3/attn/qkv``, :func:`~mmlearn_tpu_torch.bridge.jax_module_path`),
  so one config selects the same layers in both packages.
- :func:`init_lora` gives every selected ``Dense`` a factor pair ``a``
  ``(in, r)``, kaiming-scaled (``N(0, 1) / sqrt(in)``), and ``b`` ``(r,
  out)``, zero, so the merged delta starts at 0. With ``qkv_slices`` a
  fused ``qkv`` layer gets one pair per listed slice (``q``/``k``/``v``,
  each ``(in, r)`` and ``(r, C)``).
- The layer then computes with ``W0 + (a @ b)^T * alpha / r``, merged in the
  parameter dtype (f32) at every forward and then cast, as ``apply_lora``
  (JAX :130-177); per-slice deltas are assembled in ``[q | k | v]`` packing
  and head-interleaved into the fused layout, which is LoRA on separate q/k/v
  projections.
- The factors of one encoder live in one module tree that mirrors the
  encoder's layer names (``blocks.3.attn.qkv.a``, ``...qkv.q.a``); a task
  holds it under ``lora.<encoder key>``, so :mod:`~mmlearn_tpu_torch.bridge`
  maps the JAX ``lora/<key>/<path>/a`` to it one to one. The base weights
  keep their ``state_dict`` keys and are frozen with
  ``requires_grad_(False)``.
- :func:`modules_to_save_mask` and :func:`freeze_layers_mask` give ``{name:
  trainable}`` over an encoder's parameters by the JAX functions' rules
  (``re.search`` on the JAX path; the reference's bool/int/float/list freeze
  specs).

The JAX ``lora_dropout`` is accepted and not applied, as there. Under a
split over the mesh's ``model`` axis each rank merges into its share of the
weight (:meth:`_Merge.merge`).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
from torch import nn

from mmlearn_tpu_torch.bridge import jax_module_path, jax_paths
from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.ops.fused_attention import interleave_qkv_heads

DEFAULT_TARGETS = (r".*attn/qkv$", r".*attn/proj$")
EMBEDDING_KEYS = ("patch_embed", "token_embedding", "position_embedding",
                  "token_type_embedding", "pos_embed", "cls_token", "embed_norm")


@store(group="modules/peft", name="LoRAConfig", populate_full_signature=False)
@dataclass(frozen=True)
class LoRAConfig:
    """LoRA hyperparameters (peft ``LoraConfig``'s core fields).

    ``qkv_slices`` puts per-projection targets (peft ``target_modules=
    ["query", "value"]``) on the fused head-major ``qkv``; it needs
    ``qkv_num_heads``. ``modules_to_save``: path patterns (``re.search``)
    whose parameters stay trainable beside the factors."""

    r: int = 8
    lora_alpha: float = 16.0
    target_patterns: tuple[str, ...] = DEFAULT_TARGETS
    lora_dropout: float = 0.0
    qkv_slices: tuple[str, ...] = ()
    qkv_num_heads: int = 0
    modules_to_save: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        for name in ("target_patterns", "qkv_slices", "modules_to_save"):
            object.__setattr__(self, name, tuple(getattr(self, name)))
        if self.qkv_slices:
            bad = set(self.qkv_slices) - {"q", "k", "v"}
            if bad:
                raise ValueError(f"qkv_slices must be among q/k/v, got {bad}")
            if self.qkv_num_heads <= 0:
                raise ValueError("qkv_slices requires qkv_num_heads (the fused kernel's "
                                 "head-interleaved packing)")

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r


class LoRAFactors(nn.Module):
    """One factor pair ``a`` ``(in, r)``, ``b`` ``(r, out)``."""

    def __init__(self, d_in: int, d_out: int, r: int, generator: Optional[torch.Generator],
                 device=None) -> None:
        super().__init__()
        a = torch.randn(d_in, r, generator=generator, dtype=torch.float32)
        self.a = nn.Parameter((a * (1.0 / math.sqrt(d_in))).to(device))
        self.b = nn.Parameter(torch.zeros(r, d_out, dtype=torch.float32, device=device))

    def product(self) -> torch.Tensor:
        return self.a @ self.b


class LoRASlices(nn.Module):
    """Per-slice factor pairs of a fused ``qkv`` layer (children ``q``,
    ``k``, ``v`` as configured)."""

    def __init__(self, slices: Sequence[str], d_in: int, c: int, r: int,
                 generator: Optional[torch.Generator], device=None) -> None:
        super().__init__()
        for s in slices:
            self.add_module(s, LoRAFactors(d_in, c, r, generator, device))

    def product(self, num_heads: int) -> torch.Tensor:
        """The ``(in, 3C)`` delta kernel: ``[q | k | v]``, zero where a
        slice has no factors, head-interleaved."""
        parts = [getattr(self, s, None) for s in ("q", "k", "v")]
        like = next(p for p in parts if p is not None)
        zero = torch.zeros(like.a.shape[0], like.b.shape[1], dtype=like.a.dtype,
                           device=like.a.device)
        return interleave_qkv_heads(
            torch.cat([zero if p is None else p.product() for p in parts], dim=-1), num_heads)


class _Merge:
    """What a LoRA'd ``Dense`` holds (outside its parameters): its factors
    and how to merge them."""

    def __init__(self, factors: nn.Module, config: LoRAConfig) -> None:
        self.factors = factors
        self.config = config

    def merge(self, weight: torch.Tensor) -> torch.Tensor:
        """``weight + (a @ b)^T * scaling``. A weight split over the
        ``model`` axis takes the rank's share of the delta: rows of a column
        split (the factor's output columns), columns of a row split (its
        input rows); the factors stay whole and replicated, and their
        gradients are the whole delta's."""
        f = self.factors
        ab = (f.product(self.config.qkv_num_heads) if isinstance(f, LoRASlices)
              else f.product())
        delta = (ab * self.config.scaling).t()
        placements = getattr(weight, "placements", None)
        if placements is not None:
            from torch.distributed.tensor import DTensor, Replicate

            delta = DTensor.from_local(delta, weight.device_mesh, [Replicate()],
                                       run_check=False).redistribute(placements=placements)
        return weight + delta.to(weight.dtype)


def _target_layers(encoder: nn.Module, config: LoRAConfig) -> list[tuple[str, Dense]]:
    return [(name, mod) for name, mod in encoder.named_modules()
            if isinstance(mod, Dense)
            and any(re.match(p, jax_module_path(name)) for p in config.target_patterns)]


def init_lora(encoder: nn.Module, config: LoRAConfig,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """Factors for every layer of ``encoder`` that ``config`` selects,
    attached to those layers; returns the module tree that holds them
    (register it where the optimizer and ``state_dict`` see it)."""
    root = nn.Module()
    device = next(encoder.parameters()).device
    for name, layer in _target_layers(encoder, config):
        d_out, d_in = layer.weight.shape
        if config.qkv_slices and name.endswith("qkv"):
            factors = LoRASlices(config.qkv_slices, d_in, d_out // 3, config.r, generator, device)
        else:
            factors = LoRAFactors(d_in, d_out, config.r, generator, device)
        node = root
        *parents, leaf = name.split(".")
        for part in parents:
            if part not in node._modules:
                node.add_module(part, nn.Module())
            node = node._modules[part]
        node.add_module(leaf, factors)
        # held outside the layer's parameters: its state_dict keys stay the base layer's
        layer.__dict__["lora"] = _Merge(factors, config)
    return root


def merged_state_dict(encoder: nn.Module) -> dict[str, torch.Tensor]:
    """``encoder``'s ``state_dict`` with each LoRA'd layer's weight merged
    (``W0 + delta``), detached."""
    sd = dict(encoder.state_dict())
    with torch.no_grad():
        for name, mod in encoder.named_modules():
            if isinstance(mod, Dense) and "lora" in mod.__dict__:
                sd[f"{name}.weight"] = mod.merged_weight().detach()
    return sd


def modules_to_save_mask(encoder: nn.Module, patterns: Sequence[str]) -> dict[str, bool]:
    """``{parameter name: trainable}``: trainable where the parameter's JAX
    path matches one of ``patterns`` (``re.search``), peft's
    ``modules_to_save``."""
    return {name: any(re.search(p, path) for p in patterns)
            for name, path in jax_paths(encoder).items()}


def freeze_layers_mask(
    encoder: nn.Module,
    freeze_spec: Union[bool, int, float, Sequence[int], None],
    block_prefix: str = "blocks_",
    embedding_keys: tuple[str, ...] = EMBEDDING_KEYS,
) -> dict[str, bool]:
    """``{parameter name: trainable}`` from a reference-style spec, on the
    parameters' JAX paths:

    - ``True`` freezes everything, ``False``/``None`` nothing;
    - an int ``n`` freezes the embeddings and the first ``n`` blocks (from
      the end where negative);
    - a float ``f`` in (0, 1] the embeddings and the first ``round(f *
      depth)``;
    - a list of ints the embeddings and those blocks.
    """
    paths = jax_paths(encoder)
    if freeze_spec is None or freeze_spec is False:
        return {name: True for name in paths}
    if freeze_spec is True:
        return {name: False for name in paths}
    depth = 0
    for path in paths.values():
        m = re.search(rf"{block_prefix}(\d+)", path)
        if m:
            depth = max(depth, int(m.group(1)) + 1)
    if depth == 0:
        raise ValueError(f"Per-layer freeze spec {freeze_spec!r} found no blocks matching "
                         f"prefix {block_prefix!r} in the encoder: pass its block prefix")
    if isinstance(freeze_spec, float):
        frozen = set(range(int(round(freeze_spec * depth))))
    elif isinstance(freeze_spec, int):
        frozen = set(range(freeze_spec if freeze_spec >= 0 else depth + freeze_spec))
    else:
        frozen = {i if i >= 0 else depth + i for i in freeze_spec}

    def trainable(path: str) -> bool:
        m = re.search(rf"{block_prefix}(\d+)", path)
        if m:
            return int(m.group(1)) not in frozen
        return path.split("/")[0] not in embedding_keys

    return {name: trainable(path) for name, path in paths.items()}
