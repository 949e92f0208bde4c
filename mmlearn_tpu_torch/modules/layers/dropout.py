"""Dropout, drop-path (stochastic depth) and where their masks come from.

Counterpart of flax ``nn.Dropout`` and of
:func:`mmlearn_tpu.modules.layers.transformer_block.drop_path` /
``DropPath``. The JAX package draws every mask from the ``dropout`` rng that
its trainer passes to a train step (``fold_in(key(seed + 1), step)``), and
draws none where ``deterministic=True``: every call outside the train step.
The port draws them from the :class:`MaskSource` made current by
:func:`masks_from`: ``Trainer.fit`` makes one a micro-step, its generator
seeded by ``(seed, micro-step)`` on the task's device, so a resumed run draws
the masks the whole run drew. A module draws nothing in eval mode or while
no source is current: outside ``fit`` the towers run deterministically, as
the JAX tasks do.

A mask is drawn before the function that applies it runs and is passed in,
never drawn inside a checkpointed block: ``torch.utils.checkpoint`` restores
the default generators' state for its recompute, not that of an explicit
generator, so a mask drawn there would be drawn again, differently, and the
gradients would be silently wrong (:class:`~mmlearn_tpu_torch.modules.layers.
transformer_block.BlockStack` draws each block's masks before it runs).

Both apply a mask as the JAX package does: ``where(keep, x / keep_prob, 0)``
in the input's type, ``keep`` true with probability ``1 - rate``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


class MaskSource:
    """Bernoulli keep-masks and uniform noise from one generator, made at
    the first draw on ``device`` and seeded by ``seed`` (an int, or a
    sequence of ints mixed by numpy's ``SeedSequence``)."""

    def __init__(self, seed: int | Sequence[int], device: torch.device | str) -> None:
        self.seed = seed
        self.device = torch.device(device)
        self._generator: Optional[torch.Generator] = None

    @property
    def generator(self) -> torch.Generator:
        if self._generator is None:
            entropy = [self.seed] if isinstance(self.seed, int) else list(self.seed)
            words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
            g = torch.Generator(device=self.device)
            g.manual_seed(int(words[0]) << 32 | int(words[1]))
            self._generator = g
        return self._generator

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """f32 noise in ``[0, 1)`` of ``shape``."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def keep(self, keep_prob: float, shape: Sequence[int]) -> torch.Tensor:
        """A bool mask of ``shape``, each element true with probability
        ``keep_prob``: ``uniform < keep_prob``, as ``jax.random.bernoulli``."""
        return self.uniform(shape) < keep_prob


# the current source, per thread (the autograd engine's threads see none:
# a checkpointed block's recompute takes the masks it was given)
_SOURCE: contextvars.ContextVar[Optional[MaskSource]] = contextvars.ContextVar(
    "mask_source", default=None)


def current_source() -> Optional[MaskSource]:
    """The source :func:`masks_from` made current, or ``None``."""
    return _SOURCE.get()


@contextlib.contextmanager
def masks_from(source: Optional[MaskSource]) -> Iterator[Optional[MaskSource]]:
    """Make ``source`` the one every dropout in the block draws from, in
    this thread (``None``: no module draws)."""
    token = _SOURCE.set(source)
    try:
        yield source
    finally:
        _SOURCE.reset(token)


def step_source(seed: int, step: int, device: torch.device | str) -> MaskSource:
    """The masks of micro-step ``step`` of a run seeded ``seed``: the same
    draws whenever that micro-step runs, a resumed run included."""
    return MaskSource((seed, step), device)


def draw_keep(training: bool, rate: float, shape: Sequence[int]) -> Optional[torch.Tensor]:
    """A keep-mask for a dropout of ``rate`` over ``shape`` from the current
    source, or ``None`` where nothing is dropped (eval mode, no source, a
    zero rate)."""
    source = current_source()
    if not training or source is None or rate == 0.0:
        return None
    return source.keep(1.0 - rate, shape)


def apply_keep(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)``; ``x`` where ``keep`` is ``None``.
    ``keep`` broadcasts against ``x`` (drop-path's ``(B, 1, 1)``) and may lie
    on another device (masks drawn once for a card and a CPU copy)."""
    if keep is None:
        return x
    return torch.where(keep.to(x.device), x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path_shape(x_shape: Sequence[int]) -> tuple[int, ...]:
    """The mask shape of drop-path over an input of ``x_shape``: one value a
    sample, ``(B, 1, ..., 1)``."""
    return (x_shape[0],) + (1,) * (len(x_shape) - 1)


class Dropout(torch.nn.Module):
    """flax ``nn.Dropout`` (no broadcast dims): draws its mask from the
    current source in train mode, or takes one passed in."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            keep = draw_keep(self.training, self.rate, x.shape)
        return apply_keep(x, keep, self.rate)


class DropPath(torch.nn.Module):
    """Stochastic depth: the JAX ``DropPath``, one keep draw a sample."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if keep is None:
            keep = draw_keep(self.training, self.rate, drop_path_shape(x.shape))
        return apply_keep(x, keep, self.rate)


def drop_path(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX ``drop_path`` with its mask given: ``x`` where ``keep`` is
    ``None`` or the rate is 0."""
    return x if rate == 0.0 else apply_keep(x, keep, rate)
