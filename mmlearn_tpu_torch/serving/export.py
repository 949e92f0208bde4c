"""Encoder serving artifacts, counterpart of :mod:`mmlearn_tpu.serving.export`.

An artifact directory holds:

- ``meta.json`` -- the keys of the JAX artifact: ``modality``,
  ``normalized``, ``embedding_dim``, ``platforms`` and ``inputs`` (the feed
  contract: exactly the batch keys the encoder consumes, with shape and
  dtype; the leading batch dimension is free);
- ``encoder.json`` -- the encoder's class and constructor arguments;
- ``weights.npz`` -- the encoder's weights, flat and keyed by the JAX
  package's parameter paths (:mod:`mmlearn_tpu_torch.bridge`); a LoRA'd
  layer's weight is its merged one (:func:`~mmlearn_tpu_torch.peft.merged_state_dict`),
  so the artifact computes what the tower computes in the task.

Where the JAX artifact freezes the computation as StableHLO, this one
rebuilds the module from its class: torch cannot load StableHLO, and
``torch.export`` is later work. The format is numpy plus JSON, so a serving
host needs nothing beyond torch and numpy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.peft import merged_state_dict
from mmlearn_tpu_torch.tasks.contrastive_pretraining import ContrastivePretraining

_ENCODERS = {cls.__name__: cls for cls in (VisionTransformer, TextTransformer)}


def _encoder_input_keys(modality: str, example_batch: Mapping[str, Any]) -> list[str]:
    """The batch keys the encoder consumes (its input and padding mask)."""
    mod = Modalities.get_modality(modality)
    keys = [k for k in (mod.name, mod.attention_mask) if k in example_batch]
    if not keys:
        raise ValueError(f"example_batch has no '{mod.name}' input for modality {modality}")
    return keys


def save_encoder(
    output_dir: str,
    task: ContrastivePretraining,
    modality: str,
    example_batch: Mapping[str, Any],
    normalize: bool = True,
) -> str:
    """Write the artifact directory for one modality's tower. Returns
    ``output_dir``. ``example_batch`` gives the input keys, shapes and
    dtypes; one of its rows is encoded to read the embedding width."""
    modality = str(modality).lower()
    if task.head_keys[modality] in task.heads or (
        task.postprocessor_keys[modality] in task.postprocessors
    ):
        raise NotImplementedError(
            f"'{modality}' has a head or postprocessor; artifacts of such "
            "towers are not ported yet"
        )
    encoder = task.encoders[task.encoder_keys[modality]]
    if type(encoder).__name__ not in _ENCODERS:
        raise TypeError(f"cannot export a {type(encoder).__name__} encoder")
    keys = _encoder_input_keys(modality, example_batch)
    with torch.inference_mode():
        probe = task.encode({k: np.asarray(example_batch[k])[:1] for k in keys},
                            modality, normalize=normalize)
    os.makedirs(output_dir, exist_ok=True)
    bridge.save_npz(os.path.join(output_dir, "weights.npz"), bridge.torch_to_jax(
        encoder, state_dict=merged_state_dict(encoder)))
    with open(os.path.join(output_dir, "encoder.json"), "w") as f:
        json.dump({"class": type(encoder).__name__, "kwargs": encoder.config}, f, indent=2)
    meta = {
        "modality": modality,
        "normalized": bool(normalize),
        "embedding_dim": int(probe.shape[-1]),
        "platforms": ["cpu", "cuda"],
        "inputs": {
            k: {
                "shape": list(np.shape(example_batch[k])),
                "dtype": str(np.asarray(example_batch[k]).dtype),
            }
            for k in keys
        },
    }
    with open(os.path.join(output_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return output_dir


def load_encoder(
    artifact_dir: str, device: torch.device | str = "cuda"
) -> Callable[[Mapping[str, Any]], torch.Tensor]:
    """Load an artifact onto ``device`` as ``fn(batch) -> embeddings``.

    The returned function carries ``meta`` (the artifact's ``meta.json``)
    and ``task`` (the rebuilt one-tower :class:`ContrastivePretraining`).
    """
    with open(os.path.join(artifact_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(artifact_dir, "encoder.json")) as f:
        spec = json.load(f)
    if spec["class"] not in _ENCODERS:
        raise ValueError(f"unknown encoder class {spec['class']!r} in {artifact_dir}")
    encoder = _ENCODERS[spec["class"]](**spec["kwargs"])
    weights = bridge.load_npz(os.path.join(artifact_dir, "weights.npz"))
    encoder.load_state_dict(bridge.jax_to_torch(weights))
    modality = meta["modality"]
    task = ContrastivePretraining({modality: encoder}).to(device).eval()

    def encode(batch: Mapping[str, Any]) -> torch.Tensor:
        with torch.inference_mode():
            return task.encode(batch, modality, normalize=meta["normalized"])

    encode.meta = meta  # type: ignore[attr-defined]
    encode.task = task  # type: ignore[attr-defined]
    return encode
