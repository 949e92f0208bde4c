"""Configurable MLP, counterpart of :mod:`mmlearn_tpu.modules.layers.mlp`.

Layers are named ``fc{i}`` as in the JAX package, so
:mod:`mmlearn_tpu_torch.bridge` maps weights by path. Ported so far: an
explicit ``hidden_dims`` list; the JAX module's ``hidden_dims_multiplier``,
inter-layer norm and dropout are not (this package is forward-only).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlearn_tpu_torch.modules.layers.dense import Dense

# the towers' activations: exact-erf gelu and CLIP's quick_gelu
_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(_ACTIVATIONS)}"
        )
    return _ACTIVATIONS[name]


class MLP(nn.Module):
    """Multi-layer perceptron with configurable width schedule."""

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        hidden_dims: Sequence[int] = (),
        activation: str = "gelu",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        dims = [*hidden_dims, out_dim if out_dim is not None else in_dim]
        self.act = get_activation(activation)
        self.num_layers = len(dims)
        prev = in_dim
        for i, dim in enumerate(dims):
            self.add_module(f"fc{i + 1}", Dense(prev, dim, True, dtype, param_dtype))
            prev = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers:
                x = self.act(x)
        return x
