"""N-modality contrastive (CLIP-style) pretraining task.

Counterpart of :mod:`mmlearn_tpu.tasks.contrastive_pretraining`: the
encoder/head/postprocessor key mapping (``modality_module_mapping``, shared
modules by key), ``encode`` / ``forward`` (JAX :466-529), the learnable
clamped ``log_logit_scale`` (:532) and ``loss_fn`` (:540-609): every
modality in the batch is encoded and L2-normalised, presence masks and the
batch's ``batch_validity`` select the valid rows, and the contrastive loss
runs over ``modality_loss_pairs`` (every pair of modalities by default).
``encode`` is encoder, then postprocessor, then head, then optional L2 norm.
``evaluation_tasks`` maps names to :class:`EvaluationSpec` entries (a hook such as
:class:`~mmlearn_tpu_torch.tasks.ZeroShotCrossModalRetrieval` and whether it
runs on validation and on test), which the trainer's evaluation loop
drives. ``peft_configs`` (:class:`~mmlearn_tpu_torch.peft.LoRAConfig` by
modality or encoder key) give an encoder LoRA factors, held under
``lora.<encoder key>``, and freeze its base weights except
``modules_to_save``; ``freeze_encoders`` freezes an encoder by a
reference-style spec (:func:`~mmlearn_tpu_torch.peft.freeze_layers_mask`).
The parameters left trainable are those of the JAX task's
``_trainable_mask`` (:295-303). ``auxiliary_tasks`` maps names to
:class:`AuxiliaryTaskSpec` entries (or mappings of their fields): each
spec's ``task`` is called with ``encoder=`` the encoder of its modality and
``auxiliary=True`` (an I-JEPA task on the shared rgb tower, say), and its
loss, times ``loss_weight``, is added to the contrastive loss (JAX
:241-256, :590-607). The auxiliary task draws its dropout masks from a
source of its own, derived from the step's by its name. ``post_update``,
``init_extras``, ``apply_import_metadata`` and ``prepare_batch`` (with the
run seed) reach each auxiliary task (JAX :612-647). The shared encoder is
registered once, under ``encoders``, so its weights enter the optimizer
once; an auxiliary task's own modules lie under
``auxiliary_tasks.<name>`` (its frozen teacher outside the optimizer). A
batch's ``<modality>_token_type_ids``, where given, reach an
encoder that takes ``token_type_ids`` (the BERT tower); the JAX task passes
none.

PyTorch idiom: the modules hold their weights, so ``encode`` and
``loss_fn`` take no parameter tree; inputs may be numpy arrays or tensors
and land on the device of the encoder's weights.
"""

from __future__ import annotations

import itertools
import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
from torch import nn

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import MODALITY_PRESENCE_SUFFIX
from mmlearn_tpu_torch.datasets.core.modalities import Modalities
from mmlearn_tpu_torch.modules.layers.dropout import MaskSource, current_source
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize
from mmlearn_tpu_torch.modules.losses import ContrastiveLoss, LossPairSpec
from mmlearn_tpu_torch.peft import (
    LoRAConfig,
    freeze_layers_mask,
    init_lora,
    modules_to_save_mask,
)
from mmlearn_tpu_torch.tasks.base import TrainingTask, as_tensor


@dataclass
class AuxiliaryTaskSpec:
    """An auxiliary task attached to one modality's encoder: ``task`` is a
    callable (a partial of the task's class) that takes the shared encoder
    as ``encoder=``."""

    modality: str = "rgb"
    task: Any = None
    loss_weight: float = 1.0


def stable_hash(s: str) -> int:
    """The JAX task's process-independent name hash (``zlib.crc32`` mod
    2^31)."""
    return zlib.crc32(s.encode()) % (2**31)


@dataclass
class EvaluationSpec:
    """An evaluation task and when it runs."""

    task: Any = None
    run_on_validation: bool = True
    run_on_test: bool = True


@dataclass(frozen=True)
class ModuleKeySpec:
    """Maps a modality to shared module keys."""

    encoder_key: Optional[str] = None
    head_key: Optional[str] = None
    postprocessor_key: Optional[str] = None


@store(group="task", name="ContrastivePretraining", populate_full_signature=False)
class ContrastivePretraining(TrainingTask):
    """CLIP-style contrastive pretraining over N modalities."""

    def __init__(
        self,
        encoders: Mapping[str, nn.Module],
        heads: Optional[Mapping[str, nn.Module]] = None,
        postprocessors: Optional[Mapping[str, nn.Module]] = None,
        modality_module_mapping: Optional[Mapping[str, Any]] = None,
        optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
        lr_scheduler: Optional[Callable[..., Callable[[int], float]]] = None,
        init_logit_scale: float = 1 / 0.07,
        max_logit_scale: float = 100.0,
        learnable_logit_scale: bool = True,
        loss: Optional[ContrastiveLoss] = None,
        modality_loss_pairs: Optional[Sequence[Any]] = None,
        auxiliary_tasks: Optional[Mapping[str, AuxiliaryTaskSpec | Mapping]] = None,
        log_auxiliary_tasks_loss: bool = False,
        compute_validation_loss: bool = True,
        compute_test_loss: bool = True,
        evaluation_tasks: Optional[Mapping[str, EvaluationSpec | Mapping]] = None,
        peft_configs: Optional[Mapping[str, Any]] = None,
        freeze_encoders: Optional[Mapping[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        """``generator`` draws the LoRA factors (the default generator's
        state where not given)."""
        super().__init__(optimizer, lr_scheduler,
                         loss if loss is not None else ContrastiveLoss(),
                         compute_validation_loss, compute_test_loss)
        mapping: dict[str, ModuleKeySpec] = {}
        for m, spec in (modality_module_mapping or {}).items():
            if isinstance(spec, Mapping):
                spec = ModuleKeySpec(**spec)
            mm = str(m).lower()
            if not Modalities.has_modality(mm):
                raise ValueError(f"Unknown modality '{mm}'")
            mapping[mm] = spec
        referenced = {
            str(spec.encoder_key).lower() for spec in mapping.values() if spec.encoder_key
        }
        self.modalities = list(mapping)
        for key in encoders:
            k = str(key).lower()
            if Modalities.has_modality(k):
                if k not in self.modalities:
                    self.modalities.append(k)
            elif k not in referenced:
                raise ValueError(f"Unknown modality '{k}'")
        for m in self.modalities:
            mapping.setdefault(m, ModuleKeySpec())
        self.encoder_keys = {m: (mapping[m].encoder_key or m) for m in self.modalities}
        self.head_keys = {m: (mapping[m].head_key or m) for m in self.modalities}
        self.postprocessor_keys = {
            m: (mapping[m].postprocessor_key or m) for m in self.modalities
        }
        self.encoders = nn.ModuleDict({str(k).lower(): v for k, v in encoders.items()})
        for m in self.modalities:
            if self.encoder_keys[m] not in self.encoders:
                raise ValueError(
                    f"Modality '{m}' maps to encoder key '{self.encoder_keys[m]}' "
                    f"but no such encoder was given (available: "
                    f"{sorted(self.encoders)})"
                )
        self.heads = nn.ModuleDict({str(k).lower(): v for k, v in (heads or {}).items()})
        self.postprocessors = nn.ModuleDict(
            {str(k).lower(): v for k, v in (postprocessors or {}).items()}
        )

        self.max_logit_scale = float(max_logit_scale)
        self.log_logit_scale = nn.Parameter(
            torch.tensor(math.log(init_logit_scale), dtype=torch.float32),
            requires_grad=learnable_logit_scale,
        )
        if modality_loss_pairs is None:
            pairs = [LossPairSpec((a, b)) for a, b in
                     itertools.combinations(self.modalities, 2)]
        else:
            pairs = [
                p if isinstance(p, LossPairSpec) else LossPairSpec(
                    tuple(str(m).lower() for m in p["modalities"]), p.get("weight", 1.0))
                for p in modality_loss_pairs
            ]
        for pair in pairs:
            for m in pair.modalities:
                if str(m).lower() not in self.modalities:
                    raise ValueError(
                        f"Loss pair {pair.modalities} references unknown "
                        f"modality '{m}' (have {self.modalities})"
                    )
        self.modality_loss_pairs = pairs
        self.aux_task_specs: dict[str, AuxiliaryTaskSpec] = {}
        aux: dict[str, nn.Module] = {}
        for name, spec in (auxiliary_tasks or {}).items():
            if isinstance(spec, Mapping):
                spec = AuxiliaryTaskSpec(**spec)
            if not isinstance(spec, AuxiliaryTaskSpec):
                raise TypeError(f"Auxiliary task '{name}': expected an AuxiliaryTaskSpec or a "
                                f"mapping of its fields, got {type(spec).__name__}")
            modality = str(spec.modality).lower()
            if modality not in self.modalities:
                raise ValueError(f"Auxiliary task '{name}' is attached to unknown modality "
                                 f"'{modality}'")
            self.aux_task_specs[name] = spec
            aux[name] = spec.task(encoder=self.encoders[self.encoder_keys[modality]],
                                  auxiliary=True)
        self.auxiliary_tasks = nn.ModuleDict(aux)
        self.log_auxiliary_tasks_loss = log_auxiliary_tasks_loss
        self.evaluation_tasks: dict[str, EvaluationSpec] = {
            name: spec if isinstance(spec, EvaluationSpec) else EvaluationSpec(**spec)
            for name, spec in (evaluation_tasks or {}).items()
        }

        self.peft_configs: dict[str, LoRAConfig] = {
            self.encoder_keys[str(m).lower()]: cfg if isinstance(cfg, LoRAConfig)
            else LoRAConfig(**cfg)
            for m, cfg in (peft_configs or {}).items()
        }
        self.freeze_encoders = {self.encoder_keys[str(m).lower()]: spec
                                for m, spec in (freeze_encoders or {}).items()}
        self.lora = nn.ModuleDict({
            key: init_lora(self.encoders[key], cfg, generator)
            for key, cfg in self.peft_configs.items()
        })
        for key, encoder in self.encoders.items():
            if key in self.peft_configs:
                # LoRA: the base frozen but for modules_to_save; the factors train
                mask = modules_to_save_mask(encoder, self.peft_configs[key].modules_to_save)
            elif key in self.freeze_encoders:
                mask = freeze_layers_mask(encoder, self.freeze_encoders[key])
            else:
                continue
            for name, p in encoder.named_parameters():
                p.requires_grad_(mask[name])

    def _encoder_inputs(
        self, batch: Mapping[str, Any], modality: str, device: torch.device
    ) -> tuple[tuple, dict]:
        mod = Modalities.get_modality(modality)
        x = as_tensor(batch[mod.name], device)
        kwargs: dict[str, Any] = {}
        # token ids (integer inputs) take the modality's padding mask
        if not x.is_floating_point() and mod.attention_mask in batch:
            kwargs["attention_mask"] = as_tensor(batch[mod.attention_mask], device)
        token_types = f"{mod.name}_token_type_ids"
        if token_types in batch:
            kwargs["token_type_ids"] = as_tensor(batch[token_types], device)
        return (x,), kwargs

    def encode(
        self, batch: Mapping[str, Any], modality: str, normalize: bool = False
    ) -> torch.Tensor:
        """Encoder, then postprocessor, then head, then optional L2 norm.

        The norm is taken in the compute dtype, as the JAX package takes it:
        the loss and serving's ``/embed`` use these rows. Evaluation
        (``EvalRuntime.encode(normalize=True)``: the exports an index is
        built from, and so ``/search``'s corpus) normalizes the un-normalized
        rows in f32 instead: in bf16 a row's norm lies up to 2^-8 from 1,
        enough for a near-duplicate to outscore the row itself in an index.
        """
        modality = str(modality).lower()
        encoder = self.encoders[self.encoder_keys[modality]]
        device = next(encoder.parameters()).device
        args, kwargs = self._encoder_inputs(batch, modality, device)
        out = encoder(*args, **kwargs)
        x = out.last_hidden_state
        pkey = self.postprocessor_keys[modality]
        if pkey in self.postprocessors:
            x = self.postprocessors[pkey](x)
        elif out.pooler_output is not None:
            x = out.pooler_output
        else:
            x = x.mean(dim=1)
        hkey = self.head_keys[modality]
        if hkey in self.heads:
            x = self.heads[hkey](x)
        if normalize:
            x = l2_normalize(x)
        return x

    def forward(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Embed every modality present in the batch:
        ``{modality.embedding: (B, D)}``, L2-normalised."""
        return {
            Modalities.get_modality(m).embedding: self.encode(batch, m, normalize=True)
            for m in self.modalities
            if Modalities.get_modality(m).name in batch
        }

    def logit_scale(self) -> torch.Tensor:
        """``exp`` of ``log_logit_scale`` clamped to ``[0, log
        max_logit_scale]``."""
        return torch.clamp(self.log_logit_scale, 0.0, math.log(self.max_logit_scale)).exp()

    def loss_fn(self, batch: Mapping[str, Any]) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Contrastive loss of one batch: ``(loss, metrics)`` with one
        ``loss_<a>_<b>`` per pair, ``logit_scale`` and ``loss``.

        Rows that ``batch["batch_validity"]`` marks invalid (padding of a
        partial batch) drop out of every modality, as anchors and as
        negatives; ``batch["<modality>_presence"]`` drops one modality's
        absent rows; ``batch["example_ids"][<modality>]`` rows of -1 do the
        same where no presence mask is given.
        """
        embeddings: dict[str, torch.Tensor] = {}
        presence: dict[str, torch.Tensor] = {}
        example_ids: dict[str, torch.Tensor] = {}
        device = self.log_logit_scale.device
        validity = batch.get("batch_validity")
        if validity is not None:
            validity = as_tensor(validity, device).bool()
        ids = batch.get("example_ids", {})
        for m in self.modalities:
            name = Modalities.get_modality(m).name
            if name not in batch:
                continue
            embeddings[m] = self.encode(batch, m, normalize=True)
            key = f"{name}{MODALITY_PRESENCE_SUFFIX}"
            pres = as_tensor(batch[key], device).bool() if key in batch else None
            if validity is not None:
                pres = validity if pres is None else pres & validity
            if pres is not None:
                presence[m] = pres
            if name in ids:
                example_ids[m] = as_tensor(ids[name], device)
        scale = self.logit_scale()
        loss, metrics = self.loss(embeddings, example_ids or None, scale,
                                  self.modality_loss_pairs, presence=presence or None)
        metrics = dict(metrics, logit_scale=scale)
        source = current_source()
        for name, task in self.auxiliary_tasks.items():
            # the JAX task's fold_in(rng, hash(name) + 1)
            aux_source = None if source is None else MaskSource(
                (*_seed_words(source.seed), stable_hash(name) + 1), source.device)
            aux_loss, _ = task.aux_loss(batch, aux_source)
            loss = loss + self.aux_task_specs[name].loss_weight * aux_loss
            if self.log_auxiliary_tasks_loss:
                metrics[f"aux_{name}_loss"] = aux_loss
        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    def post_update(self, step: int) -> None:
        """Each auxiliary task's update after the optimizer's (an EMA
        teacher's)."""
        for task in self.auxiliary_tasks.values():
            task.aux_post_update(step)

    def init_extras(self) -> None:
        """Each auxiliary task's state re-derived from the weights (an
        I-JEPA teacher copied from the shared encoder)."""
        for task in self.auxiliary_tasks.values():
            task.init_extras()

    def apply_import_metadata(self, meta: dict) -> None:
        """Each auxiliary task's import state (I-JEPA's EMA position)."""
        for task in self.auxiliary_tasks.values():
            task.apply_import_metadata(meta)

    def prepare_batch(
        self, batch: dict[str, Any], step: int, training: bool = True
    ) -> dict[str, Any]:
        """Each auxiliary task's host-side hook, with this task's run seed
        (the trainer sets it here only)."""
        for task in self.auxiliary_tasks.values():
            task.prepare_seed = getattr(self, "prepare_seed", 0)
            batch = task.prepare_batch(batch, step, training=training)
        return batch


def _seed_words(seed: int | Sequence[int]) -> tuple[int, ...]:
    return (seed,) if isinstance(seed, int) else tuple(seed)
