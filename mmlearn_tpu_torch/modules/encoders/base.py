"""Common encoder output container and construction helpers."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class EncoderOutput:
    """The towers' output, as the JAX package's ``EncoderOutput`` (per-layer
    hidden states are not ported yet)."""

    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None


def as_dtype(dtype: torch.dtype | str) -> torch.dtype:
    """A torch dtype from itself or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def reset_submodules(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialise every submodule that has ``reset_parameters(generator)``
    in a fixed order (registration order), so a seeded generator gives the
    same weights every time."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
