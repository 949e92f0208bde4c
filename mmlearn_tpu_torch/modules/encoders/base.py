"""Common encoder output container and construction helpers."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class EncoderOutput:
    """The towers' output, as the JAX package's ``EncoderOutput``:
    ``hidden_states`` holds each block's output, in order, when the tower is
    asked for them (``return_hidden_states=True``)."""

    last_hidden_state: torch.Tensor
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[tuple[torch.Tensor, ...]] = None


# a pytree node, so that what walks a module's outputs finds the tensors in
# it: FSDP2 hooks a wrapped tower's outputs to gather its weights again before
# their backward (PyTorch releases before 2.13 walk outputs with tree_flatten)
pytree.register_pytree_node(
    EncoderOutput,
    lambda o: ([o.last_hidden_state, o.pooler_output, o.hidden_states], None),
    lambda children, _: EncoderOutput(*children),
    serialized_type_name="mmlearn_tpu_torch.modules.encoders.base.EncoderOutput",
)


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
