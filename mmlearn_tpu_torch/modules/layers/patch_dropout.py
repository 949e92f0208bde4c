"""Patch (token) dropout that keeps the prefix tokens, counterpart of
:mod:`mmlearn_tpu.modules.layers.patch_dropout`.

The JAX module's sorted-noise selection (``patch_dropout.py:17-39``): one
uniform draw a patch from the current
:class:`~mmlearn_tpu_torch.modules.layers.dropout.MaskSource`, the
``int(num_patches * keep_rate)`` patches of least noise kept in their
original order (a stable sort, as ``jnp.argsort``), the prefix (cls) tokens
kept whole. Nothing is dropped in eval mode or without a source.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.layers.dropout import current_source


@store(group="modules/layers", name="PatchDropout", populate_full_signature=False)
class PatchDropout(nn.Module):
    """Randomly drop patch tokens (keeps ``num_prefix_tokens`` in front)."""

    def __init__(self, keep_rate: float = 0.5, num_prefix_tokens: int = 1) -> None:
        super().__init__()
        self.keep_rate = float(keep_rate)
        self.num_prefix_tokens = int(num_prefix_tokens)

    def draw_noise(self, x_shape) -> Optional[torch.Tensor]:
        """``(B, num_patches)`` noise from the current source, or ``None``
        where nothing is dropped."""
        source = current_source()
        if not self.training or source is None or self.keep_rate >= 1.0:
            return None
        return source.uniform((x_shape[0], x_shape[1] - self.num_prefix_tokens))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise``: what :meth:`draw_noise` gives, drawn now where not
        passed."""
        if noise is None:
            noise = self.draw_noise(x.shape)
        if noise is None:
            return x
        p = self.num_prefix_tokens
        prefix, patches = x[:, :p], x[:, p:]
        num_keep = max(1, int(patches.shape[1] * self.keep_rate))
        order = torch.argsort(noise.to(x.device), dim=1, stable=True)[:, :num_keep]
        keep = torch.sort(order, dim=1).values
        kept = torch.gather(patches, 1, keep[..., None].expand(-1, -1, x.shape[-1]))
        return torch.cat([prefix, kept], dim=1)
