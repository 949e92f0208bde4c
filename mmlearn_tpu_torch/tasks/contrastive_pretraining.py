"""N-modality contrastive (CLIP-style) task, reduced to what serving needs.

Counterpart of :mod:`mmlearn_tpu.tasks.contrastive_pretraining`: the
encoder/head/postprocessor key mapping (``modality_module_mapping``, shared
modules by key) and ``encode`` / ``forward`` (JAX :466-529). ``encode`` is
encoder, then postprocessor, then head, then optional L2 norm. The loss,
the logit scale, auxiliary tasks and the optimizer are not ported yet.

PyTorch idiom: the modules hold their weights, so ``encode`` takes no
parameter tree; inputs may be numpy arrays or tensors and land on the
device of the encoder's weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize


def _as_tensor(value: Any, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


@dataclass(frozen=True)
class ModuleKeySpec:
    """Maps a modality to shared module keys."""

    encoder_key: Optional[str] = None
    head_key: Optional[str] = None
    postprocessor_key: Optional[str] = None


class ContrastivePretraining(nn.Module):
    """CLIP-style contrastive model over N modalities (inference half)."""

    def __init__(
        self,
        encoders: Mapping[str, nn.Module],
        heads: Optional[Mapping[str, nn.Module]] = None,
        postprocessors: Optional[Mapping[str, nn.Module]] = None,
        modality_module_mapping: Optional[Mapping[str, Any]] = None,
    ) -> None:
        super().__init__()
        mapping: dict[str, ModuleKeySpec] = {}
        for m, spec in (modality_module_mapping or {}).items():
            if isinstance(spec, Mapping):
                spec = ModuleKeySpec(**spec)
            mm = str(m).lower()
            if not Modalities.has_modality(mm):
                raise ValueError(f"Unknown modality '{mm}'")
            mapping[mm] = spec
        referenced = {
            str(spec.encoder_key).lower() for spec in mapping.values() if spec.encoder_key
        }
        self.modalities = list(mapping)
        for key in encoders:
            k = str(key).lower()
            if Modalities.has_modality(k):
                if k not in self.modalities:
                    self.modalities.append(k)
            elif k not in referenced:
                raise ValueError(f"Unknown modality '{k}'")
        for m in self.modalities:
            mapping.setdefault(m, ModuleKeySpec())
        self.encoder_keys = {m: (mapping[m].encoder_key or m) for m in self.modalities}
        self.head_keys = {m: (mapping[m].head_key or m) for m in self.modalities}
        self.postprocessor_keys = {
            m: (mapping[m].postprocessor_key or m) for m in self.modalities
        }
        self.encoders = nn.ModuleDict({str(k).lower(): v for k, v in encoders.items()})
        for m in self.modalities:
            if self.encoder_keys[m] not in self.encoders:
                raise ValueError(
                    f"Modality '{m}' maps to encoder key '{self.encoder_keys[m]}' "
                    f"but no such encoder was given (available: "
                    f"{sorted(self.encoders)})"
                )
        self.heads = nn.ModuleDict({str(k).lower(): v for k, v in (heads or {}).items()})
        self.postprocessors = nn.ModuleDict(
            {str(k).lower(): v for k, v in (postprocessors or {}).items()}
        )

    def _encoder_inputs(
        self, batch: Mapping[str, Any], modality: str, device: torch.device
    ) -> tuple[tuple, dict]:
        mod = Modalities.get_modality(modality)
        x = _as_tensor(batch[mod.name], device)
        kwargs: dict[str, Any] = {}
        # token ids (integer inputs) take the modality's padding mask
        if not x.is_floating_point() and mod.attention_mask in batch:
            kwargs["attention_mask"] = _as_tensor(batch[mod.attention_mask], device)
        return (x,), kwargs

    def encode(
        self, batch: Mapping[str, Any], modality: str, normalize: bool = False
    ) -> torch.Tensor:
        """Encoder, then postprocessor, then head, then optional L2 norm."""
        modality = str(modality).lower()
        encoder = self.encoders[self.encoder_keys[modality]]
        device = next(encoder.parameters()).device
        args, kwargs = self._encoder_inputs(batch, modality, device)
        out = encoder(*args, **kwargs)
        x = out.last_hidden_state
        pkey = self.postprocessor_keys[modality]
        if pkey in self.postprocessors:
            x = self.postprocessors[pkey](x)
        elif out.pooler_output is not None:
            x = out.pooler_output
        else:
            x = x.mean(dim=1)
        hkey = self.head_keys[modality]
        if hkey in self.heads:
            x = self.heads[hkey](x)
        if normalize:
            x = l2_normalize(x)
        return x

    def forward(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Embed every modality present in the batch:
        ``{modality.embedding: (B, D)}``, L2-normalised."""
        return {
            Modalities.get_modality(m).embedding: self.encode(batch, m, normalize=True)
            for m in self.modalities
            if Modalities.get_modality(m).name in batch
        }
