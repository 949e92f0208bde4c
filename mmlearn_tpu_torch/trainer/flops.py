"""FLOPs of a train step that count the hand-written kernels, counterpart of
:mod:`mmlearn_tpu.trainer.flops`.

``torch.utils.flop_counter.FlopCounterMode`` counts the ATen products a
step dispatches (``mm``, ``bmm``, convolutions and their backwards, as the
JAX walker counts ``dot_general`` and convolutions) but sees nothing of a
kernel launched through ctypes, so every attention layer of the
port would count as zero on the card: the trap the JAX module fixed for
Pallas. :class:`FlopCounter` is ``FlopCounterMode`` plus what each kernel's
autograd Function reports (:func:`mmlearn_tpu_torch.ops.report_flops`): the
count of its plain version's products at the same shapes, so a step counts
the same FLOPs on the card as on the CPU, where the plain versions run.

A product on ``DTensor`` operands (a layer split over the mesh's ``model``
axis) is counted at its local shapes: the rank's share, which is what the
rank computes and what the JAX trainer's per-device count holds.

Elementwise work is not counted, per the usual MFU convention. Recompute is
counted where the code does it: the attention backward recomputes the
scores, one product in seven of an attention layer.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Callable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from mmlearn_tpu_torch import ops

__all__ = ["FlopCounter", "count_flops", "device_peak_tflops"]

#: dense bf16 peak TFLOP/s of one card, by ``torch.cuda.get_device_name``
#: (NVIDIA's data sheet, H100 SXM at 700 W)
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def device_peak_tflops(device: torch.device | str = "cuda") -> Optional[float]:
    """The card's dense bf16 peak TFLOP/s, or ``None`` off the table (the CPU
    included). ``MMLEARN_PEAK_TFLOPS`` overrides, as in the JAX package."""
    env = os.environ.get("MMLEARN_PEAK_TFLOPS")
    if env:
        return float(env)
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return PEAK_TFLOPS.get(torch.cuda.get_device_name(device))


class _LocalFlopCounterMode(FlopCounterMode):
    """``FlopCounterMode`` that counts an op on ``DTensor`` operands at
    their local shards' shapes (the mode sees the op before ``DTensor``
    dispatches it to the local tensors, with the global shapes)."""

    def _count_flops(self, func_packet, out, args, kwargs):
        from torch.utils._pytree import tree_map

        def local(t: Any) -> Any:
            return getattr(t, "_local_tensor", t)

        super()._count_flops(func_packet, tree_map(local, out), tree_map(local, args),
                             tree_map(local, kwargs))
        return out


class FlopCounter:
    """``FlopCounterMode`` over the block, plus the kernels' reports.

    ``kernel_flops`` holds what the kernels reported, by kernel;
    :meth:`total` is everything counted."""

    def __init__(self) -> None:
        self.mode = _LocalFlopCounterMode(display=False)
        self.kernel_flops: dict[str, int] = defaultdict(int)

    def add(self, kernel: str, flops: int) -> None:
        self.kernel_flops[kernel] += int(flops)

    def total(self) -> int:
        return int(self.mode.get_total_flops()) + sum(self.kernel_flops.values())

    def __enter__(self) -> "FlopCounter":
        self.mode.__enter__()
        ops.FLOP_COUNTERS.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        ops.FLOP_COUNTERS.remove(self)
        self.mode.__exit__(*exc)


def count_flops(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> tuple[Any, int]:
    """``(fn(*args, **kwargs), FLOPs it computed)``."""
    with FlopCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.total()
