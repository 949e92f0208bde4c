"""Learnable logit scaling (ImageBind-style), counterpart of
:mod:`mmlearn_tpu.modules.layers.logit_scaling`: the input times
``exp(log_logit_scale)`` clamped at ``max_logit_scale``, the log scale an f32
parameter (or a fixed buffer when not learnable).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmlearn_tpu_torch.conf import store


@store(
    group="modules/layers",
    name="LearnableLogitScaling",
    populate_full_signature=False,
)
class LearnableLogitScaling(nn.Module):
    """Multiply inputs by a (learnable) clamped ``exp(log_logit_scale)``."""

    def __init__(
        self,
        logit_scale_init: float = 1 / 0.07,
        learnable: bool = True,
        max_logit_scale: float = 100.0,
    ) -> None:
        super().__init__()
        self.logit_scale_init = float(logit_scale_init)
        self.max_logit_scale = float(max_logit_scale)
        init = torch.tensor(math.log(self.logit_scale_init), dtype=torch.float32)
        if learnable:
            self.log_logit_scale = nn.Parameter(init)
        else:
            self.register_buffer("log_logit_scale", init, persistent=False)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.log_logit_scale.fill_(math.log(self.logit_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(torch.exp(self.log_logit_scale), max=self.max_logit_scale)
        # jnp promotes: an f32 scale times a bf16 input is f32
        return scale * x.to(torch.promote_types(x.dtype, scale.dtype))
