"""Configurable MLP, counterpart of :mod:`mmlearn_tpu.modules.layers.mlp`.

Layers are named ``fc{i}`` as in the JAX package, so
:mod:`mmlearn_tpu_torch.bridge` maps weights by path, and are ``Int8Dense``
(``MMLEARN_QUANT``) as in the JAX package. Ported: an explicit
``hidden_dims`` list, a LayerNorm after each hidden layer
(``norm_layer="layernorm"``, ``norm{i}``: the reference checkpoints'
Sequential-MLP heads) and dropout after each hidden activation (its masks
from :mod:`~mmlearn_tpu_torch.modules.layers.dropout`); the JAX module's
``hidden_dims_multiplier`` and ``bias`` are not.

Split over the mesh's ``model`` axis
(:mod:`~mmlearn_tpu_torch.parallel.tensor_parallel`), ``fc1`` is
column-parallel and ``fc2`` row-parallel: the activation and the hidden
dropout act on the rank's columns, the dropout's mask drawn for the whole
width and cut to them, so a dropped-out step is one process's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.layers.dropout import apply_keep, draw_keep
from mmlearn_tpu_torch.modules.layers.normalization import LayerNorm
from mmlearn_tpu_torch.modules.layers.quantization import Int8Dense
from mmlearn_tpu_torch.parallel.tensor_parallel import local_slice

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


@store(group="modules/layers", name="MLP", populate_full_signature=False)
class MLP(nn.Module):
    """Multi-layer perceptron with configurable width schedule."""

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        hidden_dims: Sequence[int] = (),
        activation: str = "gelu",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        norm_layer: Optional[str] = None,
    ) -> None:
        super().__init__()
        if norm_layer not in (None, "layernorm"):
            raise ValueError(f"norm_layer must be None or 'layernorm', got {norm_layer!r}")
        dims = [*hidden_dims, out_dim if out_dim is not None else in_dim]
        self.act = get_activation(activation)
        self.dropout = float(dropout)
        self.hidden_dims = tuple(hidden_dims)
        self.num_layers = len(dims)
        prev = in_dim
        for i, dim in enumerate(dims):
            self.add_module(f"fc{i + 1}", Int8Dense(prev, dim, True, dtype, param_dtype))
            if norm_layer is not None and i < len(dims) - 1:
                # flax nn.LayerNorm's default epsilon
                self.add_module(f"norm{i + 1}", LayerNorm(dim, 1e-6, dtype, param_dtype))
            prev = dim
        #: ``(rank, size)`` in the ``model`` group where ``fc1``'s output is
        #: split (set by ``tensor_parallel.parallelize``)
        self.model_shard: Optional[tuple[int, int]] = None

    def draw_masks(self, x_shape) -> Optional[list[torch.Tensor]]:
        """The keep-masks of the dropouts after the hidden activations for an
        input of ``x_shape``, from the current source (``None`` where nothing
        is dropped), in the order the JAX module draws them."""
        if not self.dropout:
            return None
        keeps = [draw_keep(self.training, self.dropout, (*x_shape[:-1], h))
                 for h in self.hidden_dims]
        return None if keeps and keeps[0] is None else keeps

    def forward(self, x: torch.Tensor,
                keeps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``keeps``: the masks :meth:`draw_masks` gives, drawn now where
        not passed."""
        if keeps is None:
            keeps = self.draw_masks(x.shape)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers:
                norm = getattr(self, f"norm{i}", None)
                if norm is not None:
                    x = norm(x)
                x = self.act(x)
                if keeps is not None:
                    keep = keeps[i - 1]
                    if keep is not None and keep.shape[-1] != x.shape[-1]:
                        keep = local_slice(keep, -1, self.model_shard)
                    x = apply_keep(x, keep, self.dropout)
        return x
