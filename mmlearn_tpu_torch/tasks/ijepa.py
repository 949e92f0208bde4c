"""I-JEPA pretraining task, counterpart of :mod:`mmlearn_tpu.tasks.ijepa`.

A student ``VisionTransformer``, a ``VisionTransformerPredictor`` and an
EMA teacher. Each step:

1. ``prepare_batch`` draws the context and target masks on the host
   (``IJEPAMaskGenerator``, seeded by run seed, step and phase);
2. the teacher encodes the whole image without gradients; its features are
   standardised over the channels, the target patches gathered and repeated
   once per context mask;
3. the student encodes the context patches only;
4. the predictor predicts the targets' features; the loss is smooth-L1;
5. ``post_update`` moves the teacher towards the student after the
   optimizer's step.

PyTorch idiom: the teacher is a deep copy of the student held as the
submodule ``teacher``: frozen (no gradients, so outside the optimizer's
groups), always in eval mode, and updated in place. In the JAX package it is
``extras["ema_encoder"]``; :func:`mmlearn_tpu_torch.bridge.ijepa_jax_to_torch`
maps one to the other. The EMA step offset (``extras["ema_step_offset"]``
in the JAX package) is the module's extra state, so it lies in every
``state_dict`` and checkpoint as ``_extra_state``.

The auxiliary-task protocol (JAX :305-351): ``ContrastivePretraining``
builds the task around one of its encoders with ``auxiliary=True``. The
student is then that shared encoder, held by reference and not registered
here, so its weights are the contrastive task's and enter the optimizer
once; the task registers its ``predictor`` and ``teacher`` only, and keeps
the shared encoder's initialisation and the predictor's own, as the JAX
``init_aux_params`` does. :meth:`IJEPA.aux_loss` and :meth:`IJEPA.aux_post_update`
are the JAX ``aux_loss_fn`` and ``aux_post_update``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.datasets.processors.masking import IJEPAMaskGenerator
from mmlearn_tpu_torch.modules.ema import ExponentialMovingAverage
from mmlearn_tpu_torch.modules.encoders.text import Embed
from mmlearn_tpu_torch.modules.encoders.vision import (
    VisionTransformer,
    VisionTransformerPredictor,
    apply_masks,
    repeat_interleave_batch,
)
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.dropout import MaskSource, masks_from
from mmlearn_tpu_torch.modules.layers.embedding import PatchProj
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize
from mmlearn_tpu_torch.modules.losses.data2vec import smooth_l1
from mmlearn_tpu_torch.tasks.base import TrainingTask, as_tensor

ENCODER_MASK_KEY = "ijepa_encoder_masks"
PREDICTOR_MASK_KEY = "ijepa_predictor_masks"


def reinit_trunc_normal(
    module: nn.Module, generator: Optional[torch.Generator] = None, std: float = 0.02
) -> None:
    """The reference I-JEPA init: every kernel and embedding (flax's
    ``kernel``/``embedding`` leaves: Dense and patch weights, token
    embeddings) from a normal of ``std`` cut at two standard deviations,
    biases zero; norms and other parameters as they are."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Dense, PatchProj, Embed)):
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            if isinstance(mod, (Dense, PatchProj)) and mod.bias is not None:
                nn.init.zeros_(mod.bias)


def standardize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``jax.nn.standardize`` over the last axis, rounding where it rounds:
    the means accumulate in f32 and are cast to ``x``'s type, the variance
    is ``mean(x^2) - mean(x)^2`` in ``x``'s type, clipped at 0."""
    mean = x.float().mean(-1, keepdim=True).to(x.dtype)
    mean_sq = x.square().float().mean(-1, keepdim=True).to(x.dtype)
    var = torch.clamp_min(mean_sq - mean.square(), 0)
    return (x - mean) * torch.rsqrt(var + eps)


@store(group="task", name="IJEPA", populate_full_signature=False)
class IJEPA(TrainingTask):
    """I-JEPA: predict the features an EMA teacher gives masked regions.

    Args:
        encoder: the student; the teacher starts as its copy.
        predictor: defaults to the JAX task's: width ``max(64, embed_dim //
            2)``, depth ``max(1, depth // 2)``, the encoder's heads and
            types.
        ema_decay, ema_decay_end, ema_anneal_end_step: the teacher's decay,
            annealed linearly over the steps.
        loss_beta: smooth-L1 threshold.
        generator: draws the predictor when it is not given, then the
            reference init of the student's and the predictor's kernels
            (:func:`reinit_trunc_normal`), before the teacher is copied.
        auxiliary: the task is another task's auxiliary one (see the module
            docstring): ``encoder`` is shared and kept by reference, and
            neither it nor the predictor is re-initialised.
    """

    def __init__(
        self,
        encoder: VisionTransformer,
        predictor: Optional[VisionTransformerPredictor] = None,
        optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
        lr_scheduler: Optional[Callable[..., Callable[[int], float]]] = None,
        ema_decay: float = 0.996,
        ema_decay_end: float = 1.0,
        ema_anneal_end_step: int = 1000,
        loss_beta: float = 1.0,
        modality: str = "rgb",
        mask_generator: Optional[IJEPAMaskGenerator] = None,
        generator: Optional[torch.Generator] = None,
        compute_validation_loss: bool = True,
        compute_test_loss: bool = True,
        auxiliary: bool = False,
    ) -> None:
        super().__init__(optimizer, lr_scheduler, None, compute_validation_loss,
                         compute_test_loss)
        cfg = encoder.config
        if predictor is None:
            grid = cfg["img_size"] // cfg["patch_size"]
            predictor = VisionTransformerPredictor(
                num_patches=grid * grid, embed_dim=cfg["embed_dim"],
                predictor_embed_dim=max(64, cfg["embed_dim"] // 2),
                depth=max(1, cfg["depth"] // 2), num_heads=cfg["num_heads"],
                dtype=cfg["dtype"], param_dtype=cfg["param_dtype"], generator=generator,
            )
        self.auxiliary = auxiliary
        if auxiliary:
            # a plain attribute, not a submodule: the owner registers it
            object.__setattr__(self, "encoder", encoder)
        else:
            self.encoder = encoder
        self.predictor = predictor
        if not auxiliary:
            reinit_trunc_normal(self.encoder, generator)
            reinit_trunc_normal(self.predictor, generator)
        self.teacher = copy.deepcopy(encoder).requires_grad_(False).eval()
        self.modality = str(modality).lower()
        self.loss_beta = loss_beta
        self.ema = ExponentialMovingAverage(
            ema_decay=ema_decay, ema_end_decay=ema_decay_end,
            ema_anneal_end_step=ema_anneal_end_step,
        )
        self.mask_generator = mask_generator or IJEPAMaskGenerator(
            input_size=cfg["img_size"], patch_size=cfg["patch_size"]
        )
        #: where the teacher's decay anneal starts (a run resumed from a
        #: half-trained checkpoint continues the anneal); in the state dict
        self.ema_step_offset = 0
        self.prepare_seed = 0

    def get_extra_state(self) -> dict[str, int]:
        return {"ema_step_offset": int(self.ema_step_offset)}

    def set_extra_state(self, state: dict[str, int]) -> None:
        self.ema_step_offset = int(state["ema_step_offset"])

    def train(self, mode: bool = True) -> "IJEPA":
        super().train(mode)
        self.teacher.eval()  # the teacher only ever runs as in evaluation
        return self

    def prepare_batch(
        self, batch: dict[str, Any], step: int, training: bool = True
    ) -> dict[str, Any]:
        """Add the step's masks, drawn from ``numpy.random.default_rng((seed,
        step, phase))``, unless the batch has them."""
        name = Modalities.get_modality(self.modality).name
        if name not in batch or ENCODER_MASK_KEY in batch:
            return batch
        rng = np.random.default_rng((int(self.prepare_seed), int(step), 0 if training else 1))
        masks = self.mask_generator(int(batch[name].shape[0]), rng=rng)
        batch = dict(batch)
        batch[ENCODER_MASK_KEY] = masks["encoder_masks"]
        batch[PREDICTOR_MASK_KEY] = masks["predictor_masks"]
        return batch

    def loss_fn(self, batch: Mapping[str, Any]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Smooth-L1 between the predictor's output and the teacher's
        standardised features at the target patches, mean over everything.
        Of an encoder with a cls token (the multi-task experiment's shared
        tower) both take the patch tokens only; the JAX task has no such
        case (its predictor and its target gather take every token as a
        patch, and it raises on such an encoder)."""
        device = self.predictor.mask_token.device
        images = as_tensor(batch[Modalities.get_modality(self.modality).name], device)
        enc_masks = as_tensor(batch[ENCODER_MASK_KEY], device).long()
        pred_masks = as_tensor(batch[PREDICTOR_MASK_KEY], device).long()
        b, n_enc = images.shape[0], enc_masks.shape[0]
        prefix = getattr(self.encoder, "num_prefix", 0)  # a cls token: patches only
        with torch.no_grad():
            h = self.teacher(images).last_hidden_state[:, prefix:]
            h = standardize(h, eps=1e-5)  # torch F.layer_norm's eps, no affine
            h = repeat_interleave_batch(apply_masks(h, pred_masks), b, n_enc)
        z = self.encoder(images, patch_masks=enc_masks).last_hidden_state[:, prefix:]
        z_pred = self.predictor(z, enc_masks, pred_masks)
        loss = smooth_l1(z_pred.float(), h.float(), self.loss_beta).mean()
        return loss, {"loss": loss.detach()}

    def init_extras(self) -> None:
        """The teacher copied from the student: after an imported student
        (the reference persists no teacher and restores it from the student
        on load)."""
        with torch.no_grad():
            for t, s in zip(self.teacher.parameters(), self.encoder.parameters()):
                t.copy_(s)

    def apply_import_metadata(self, meta: dict) -> None:
        """A reference run's EMA position: the teacher's decay anneal
        continues from its ``num_updates``."""
        if "ema" in meta:
            self.ema_step_offset = int(meta["ema"].get("num_updates", 0))

    def post_update(self, step: int) -> None:
        """The teacher's EMA step towards the student, at the decay of
        ``step + ema_step_offset``."""
        self.ema.step(self.teacher, self.encoder, step + self.ema_step_offset)

    def aux_loss(
        self, batch: Mapping[str, Any], source: Optional[MaskSource] = None
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The loss of the task as an auxiliary one (JAX ``aux_loss_fn``):
        :meth:`loss_fn` on the shared student, its dropout masks drawn from
        ``source`` (none where it is ``None``)."""
        with masks_from(source):
            return self.loss_fn(batch)

    def aux_post_update(self, step: int) -> None:
        """The teacher's EMA step after the owner's update (JAX
        ``aux_post_update``)."""
        self.post_update(step)

    def encode(
        self, batch: Mapping[str, Any], modality: Optional[str] = None, normalize: bool = False
    ) -> torch.Tensor:
        """The student's mean-pooled features (the teacher's: pass its
        weights to a copy of the encoder)."""
        name = Modalities.get_modality(str(modality or self.modality).lower()).name
        device = self.predictor.mask_token.device
        x = self.encoder(as_tensor(batch[name], device)).last_hidden_state.mean(dim=1)
        return l2_normalize(x) if normalize else x
