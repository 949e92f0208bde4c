"""Modality registry, counterpart of
:mod:`mmlearn_tpu.datasets.core.modalities`.

A modality derives its batch keys from its name (``{name}_attention_mask``,
``{name}_embedding``, ...) by the same rule as the JAX package. This is a
copy of that rule, not an import: importing the JAX module runs
``mmlearn_tpu/datasets/__init__.py``, which loads the whole data layer and
the config layer, none of which a serving host needs.
"""

from __future__ import annotations

from dataclasses import dataclass

_DEFAULT_PROPERTIES = (
    "target",
    "attention_mask",
    "mask",
    "embedding",
    "masked_embedding",
    "ema_embedding",
)
_DEFAULT_MODALITIES = ("rgb", "depth", "thermal", "text", "audio", "video")


@dataclass(frozen=True)
class Modality:
    """A data modality with its derived batch keys as attributes."""

    name: str

    def __getattr__(self, prop: str) -> str:
        if prop in _DEFAULT_PROPERTIES:
            return f"{self.name}_{prop}"
        raise AttributeError(f"Modality '{self.name}' has no property '{prop}'")


class ModalityRegistry:
    """Registered modalities by name."""

    def __init__(self, names: tuple[str, ...] = _DEFAULT_MODALITIES) -> None:
        self._modalities = {n: Modality(n) for n in names}

    def get_modality(self, name: str) -> Modality:
        name = str(name).lower()
        if name not in self._modalities:
            raise KeyError(
                f"Modality '{name}' is not registered. "
                f"Available: {sorted(self._modalities)}"
            )
        return self._modalities[name]

    def has_modality(self, name: str) -> bool:
        return str(name).lower() in self._modalities


Modalities = ModalityRegistry()
