"""Pre-LN transformer block with stochastic depth, and the stack of them,
counterpart of :mod:`mmlearn_tpu.modules.layers.transformer_block`.

Trains through the kernels' autograd Functions (attention K1, or K3 for
long sequences; both norms K2). ``drop`` (the projection's and the MLP's
dropout), ``attn_drop`` (of the attention weights, on the materialized
route) and ``drop_path_rate`` draw their masks from the current
:class:`~mmlearn_tpu_torch.modules.layers.dropout.MaskSource`, in the JAX
block's order; :meth:`Block.draw_masks` draws them all before the block
runs.

:class:`BlockStack` runs the blocks in order, each under activation
checkpointing with ``remat=True`` (``torch.utils.checkpoint``, non-reentrant):
the masks of a block are drawn before its checkpointed forward and passed
in, so its recompute applies the same masks. ``remat_policy=None`` saves
nothing of a block; ``"dots_no_batch"`` saves the outputs of its products
that have no batch dimension (``aten.mm`` and ``addmm``: the qkv, proj and
MLP projections), as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
does, and recomputes everything else, the attention and norm kernels
included; under ``MMLEARN_QUANT`` the exact integer sums of the int8 modes
(f64 products) are not saved either, the JAX ``exclude_int_dots``. The JAX
package's ``save_attn_out`` policy and ``scan_unroll`` are XLA scheduling
options with no counterpart here.

The JAX package's scanned ``BlockStack`` stores its weights stacked along a
leading depth axis; :mod:`mmlearn_tpu_torch.bridge` unstacks them into
``blocks.{i}``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from mmlearn_tpu_torch.modules.layers.attention import Attention
from mmlearn_tpu_torch.modules.layers.dropout import drop_path, draw_keep, drop_path_shape
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.layers.normalization import FusedLayerNorm

REMAT_POLICIES = (None, "dots_no_batch")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_no_batch(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of 2-D products (the projections), except the f64
    ones (the int8 modes' exact integer sums); recompute the rest."""
    if op in _SAVED_PRODUCTS and not any(
            isinstance(a, torch.Tensor) and a.dtype == torch.float64 for a in args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class Block(nn.Module):
    """``x + DropPath(Attn(LN(x)))``, then ``+ DropPath(MLP(LN(.)))``; the
    residual add and the second norm run as one fused add + LayerNorm."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = False,
        act_layer: str = "gelu",
        norm_eps: float = 1e-6,
        causal: bool = False,
        drop: float = 0.0,
        attn_drop: float = 0.0,
        drop_path_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        qk_scale: Optional[float] = None,
    ) -> None:
        super().__init__()
        self.drop_path_rate = float(drop_path_rate)
        self.norm1 = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, causal, dtype, param_dtype,
                              qk_scale=qk_scale, attn_drop=attn_drop, proj_drop=drop)
        self.norm2 = FusedLayerNorm(dim, norm_eps, dtype, param_dtype)
        self.mlp = MLP(dim, out_dim=dim, hidden_dims=[int(dim * mlp_ratio)],
                       activation=act_layer, dropout=drop, dtype=dtype,
                       param_dtype=param_dtype)

    def draw_masks(self, x_shape) -> Optional[dict]:
        """Every keep-mask of the block for an input of ``x_shape`` from the
        current source, in the JAX block's order (attention weights, the
        projection's output, the first drop-path, the MLP's hidden layers,
        the second drop-path); ``None`` where nothing is dropped."""
        attn = self.attn.draw_masks(x_shape)
        path_shape = drop_path_shape(x_shape)
        path1 = draw_keep(self.training, self.drop_path_rate, path_shape)
        mlp = self.mlp.draw_masks(x_shape)
        path2 = draw_keep(self.training, self.drop_path_rate, path_shape)
        masks = {"attn": attn, "path1": path1, "mlp": mlp, "path2": path2}
        if attn == (None, None) and mlp is None and path1 is None:
            return None
        return masks

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        masks: Optional[dict] = None,
        return_attention: bool = False,
    ):
        """``masks``: what :meth:`draw_masks` gives, drawn now where not
        passed. With ``return_attention`` also returns the attention weights
        (the materialized route)."""
        if masks is None:
            masks = self.draw_masks(x.shape)
        m = masks or {}
        branch = self.attn(self.norm1(x), attention_mask, keeps=m.get("attn", (None, None)),
                           return_weights=return_attention)
        if return_attention:
            branch, weights = branch
        branch = drop_path(branch, self.drop_path_rate, m.get("path1"))
        x, y = self.norm2(x, residual=branch)
        mlp_out = self.mlp(y, keeps=m.get("mlp"))
        x = x + drop_path(mlp_out, self.drop_path_rate, m.get("path2"))
        return (x, weights) if return_attention else x


class BlockStack(nn.ModuleList):
    """``depth`` blocks of one configuration, run in order; block ``i``
    takes ``drop_path_rates[i]`` (where given), and each runs checkpointed
    with ``remat``. ``block_cls`` is :class:`Block` by default; any module
    with its ``draw_masks`` and ``forward(x, attention_mask, masks)`` will do
    (the post-LN BERT block)."""

    def __init__(
        self,
        depth: int,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        drop_path_rates: Optional[Sequence[float]] = None,
        block_cls: type = Block,
        **block_kwargs,
    ) -> None:
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        if drop_path_rates is None:
            blocks = [block_cls(**block_kwargs) for _ in range(depth)]
        else:
            rates = [float(r) for r in drop_path_rates]
            if len(rates) != depth:
                raise ValueError(f"{len(rates)} drop-path rates for {depth} blocks")
            blocks = [block_cls(**block_kwargs, drop_path_rate=r) for r in rates]
        super().__init__(blocks)
        self.remat = remat
        self.remat_policy = remat_policy

    def _checkpointed(self, block: nn.Module, x, attention_mask, masks):
        kwargs = {}
        if self.remat_policy == "dots_no_batch":
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     _dots_no_batch)
        # nothing inside a block draws from a generator (its masks come in),
        # so the default generators' state need not be saved and restored
        return checkpoint(block, x, attention_mask, masks, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
    ):
        """The blocks' output; with ``return_hidden_states`` also each
        block's output, in order."""
        hidden = []
        remat = self.remat and torch.is_grad_enabled()
        for block in self:
            masks = block.draw_masks(x.shape)
            if remat:
                x = self._checkpointed(block, x, attention_mask, masks)
            else:
                x = block(x, attention_mask, masks)
            if return_hidden_states:
                hidden.append(x)
        return (x, tuple(hidden)) if return_hidden_states else x
