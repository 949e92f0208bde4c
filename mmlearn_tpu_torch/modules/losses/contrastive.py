"""N-modality CLIP-style contrastive (InfoNCE) loss, counterpart of
:mod:`mmlearn_tpu.modules.losses.contrastive`.

The loss runs over the whole batch: rows of different modalities align by
construction (one row is one example), and an example missing from a
modality carries a boolean presence mask, so a pair's valid rows are the
rows present in both modalities. Invalid columns drop out of the
log-sum-exp (masked with the finite ``NEG``) and invalid rows add nothing.
``modality_alignment`` adds the BCE term over the full cross-modality
similarity matrix.

The ``(B, B)`` logits are f32: the JAX package computes them with
``preferred_element_type=float32`` outside any Pallas kernel, and the port
takes ``torch.matmul`` on f32 operands (exact widening of bf16 embeddings;
PyTorch's default keeps TF32 off for f32 matmuls). The JAX class's
``cache_labels`` flag changes nothing there and is not carried over.

Over several processes the batch is split over ``data x fsdp``, and the loss
runs over the **global** batch, as GSPMD runs the JAX loss: each rank's
embeddings (and presence masks) are gathered from every rank of the batch's
group (:func:`~mmlearn_tpu_torch.parallel.collectives.all_gather`, with
gradient, whose backward sums the ranks' gradients; FSDP2 averages them, so
the weights' gradient is one process's on the global batch).
``gather_with_grad=False`` detaches the other ranks' rows. With
``local_loss`` a rank scores only its own rows against the gathered columns,
positives at the offset :func:`~mmlearn_tpu_torch.parallel.collectives.local_loss_label_offset`
gives, and returns its share of the global mean times the ranks (so that the
ranks' mean is the global loss); without it every rank computes the global
loss. In one process both are the loss above.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize

NEG = -0.7 * float(np.finfo(np.float32).max)


@dataclass(frozen=True)
class LossPairSpec:
    """A pair of modalities to contrast, with a loss weight."""

    modalities: tuple[str, str] = ("rgb", "text")
    weight: float = 1.0


def masked_infonce(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with diagonal positives over valid rows and columns.

    ``logits``: ``(B, B)``; ``valid``: ``(B,)`` bool. Invalid columns are
    masked from the log-sum-exp, invalid rows contribute 0. Returns the mean
    over valid rows (0 if none).
    """
    logits = logits.float()
    lse = torch.logsumexp(torch.where(valid[None, :], logits, NEG), dim=-1)
    ce = lse - logits.diagonal()
    return torch.where(valid, ce, 0.0).sum() / valid.sum().clamp_min(1)


def infonce_rows(za: torch.Tensor, zb: torch.Tensor, scale: torch.Tensor,
                 valid_rows: torch.Tensor, valid_cols: torch.Tensor, offset: int,
                 chunk_size: Optional[int] = None) -> torch.Tensor:
    """The sum of InfoNCE(a -> b) over the valid rows of ``za`` (all rows,
    or a rank's under ``local_loss``) against every column of ``zb``, the
    positive of row ``i`` at column ``offset + i``. With ``chunk_size`` the
    log-sum-exp streams over column chunks: the logits are never held
    whole."""
    za32, zb32 = za.float(), zb.float()
    if chunk_size is None:
        lse = torch.logsumexp(torch.where(valid_cols[None, :], scale * za32 @ zb32.T, NEG), -1)
    else:
        m = torch.full((za.shape[0],), -torch.inf, device=za.device)
        l = torch.zeros(za.shape[0], device=za.device)
        for start in range(0, zb.shape[0], chunk_size):
            s = scale * torch.matmul(za32, zb32[start:start + chunk_size].T)
            s = torch.where(valid_cols[None, start:start + chunk_size], s, NEG)
            m_cur = torch.maximum(m, s.max(dim=-1).values)
            l = l * torch.exp(m - m_cur) + torch.exp(s - m_cur[:, None]).sum(dim=-1)
            m = m_cur
        lse = m + torch.log(l)
    pos = scale * (za32 * zb32[offset:offset + za.shape[0]]).sum(dim=-1)
    return torch.where(valid_rows, lse - pos, 0.0).sum()


def masked_infonce_chunked(
    za: torch.Tensor,
    zb: torch.Tensor,
    scale: torch.Tensor,
    valid: torch.Tensor,
    chunk_size: int = 4096,
) -> torch.Tensor:
    """InfoNCE(a -> b) with a streaming log-sum-exp over column chunks:
    :func:`infonce_rows`' mean over the valid rows. Equal to
    :func:`masked_infonce` of ``scale * za zb^T``."""
    return infonce_rows(za, zb, scale, valid, valid, 0, chunk_size) / valid.sum().clamp_min(1)


def _validity(
    mod: str,
    b: int,
    device: torch.device,
    example_ids: Optional[Mapping[str, torch.Tensor]],
    presence: Optional[Mapping[str, torch.Tensor]],
) -> torch.Tensor:
    if presence is not None and mod in presence:
        return presence[mod].bool()
    if example_ids is not None and mod in example_ids:
        return (example_ids[mod] >= 0).all(dim=-1)
    return torch.ones(b, dtype=torch.bool, device=device)


@store(group="modules/losses", name="ContrastiveLoss", populate_full_signature=False)
@dataclass
class ContrastiveLoss:
    """CLIP InfoNCE generalised to N modality pairs (see module docstring)."""

    l2_normalize: bool = False
    local_loss: bool = False  # a rank's rows against the gathered columns
    gather_with_grad: bool = True  # False: the other ranks' rows detached
    modality_alignment: bool = False
    chunked: bool = False  # streaming log-sum-exp; O(B * chunk) memory
    chunk_size: int = 4096

    def __call__(
        self,
        embeddings: Mapping[str, torch.Tensor],
        example_ids: Optional[Mapping[str, torch.Tensor]],
        logit_scale: torch.Tensor,
        modality_loss_pairs: Sequence[LossPairSpec],
        presence: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The total weighted loss and one metric per pair.

        Args:
            embeddings: ``{modality: (B, D)}``, one B for all.
            example_ids: optional ``{modality: (B, 2)}``; rows of ``-1`` are
                absent examples.
            logit_scale: scalar multiplier (already clamped and exponentiated).
            modality_loss_pairs: the pairs to contrast.
            presence: optional ``{modality: (B,) bool}`` masks, which take
                precedence over ``example_ids``.
        """
        from mmlearn_tpu_torch.parallel.collectives import (
            all_gather,
            axis_size,
            local_loss_label_offset,
        )

        feats = dict(embeddings)
        if self.l2_normalize:
            feats = {k: l2_normalize(v) for k, v in feats.items()}
        device = next(iter(feats.values())).device
        world = axis_size()
        local_b = next(iter(feats.values())).shape[0]
        local_feats = feats
        if world > 1:
            # the global batch: every rank's rows, in rank order
            feats = {k: all_gather(v, with_grad=self.gather_with_grad) for k, v in feats.items()}
            example_ids = None if example_ids is None else {
                k: all_gather(v) for k, v in example_ids.items()}
            presence = None if presence is None else {
                k: all_gather(v) for k, v in presence.items()}
        offset = local_loss_label_offset("batch", local_b)
        total = torch.zeros((), device=device)
        metrics: dict[str, torch.Tensor] = {}
        for pair in modality_loss_pairs:
            mod_a, mod_b = (str(m) for m in pair.modalities)
            za, zb = feats[mod_a], feats[mod_b]
            b = za.shape[0]
            valid = (_validity(mod_a, b, device, example_ids, presence)
                     & _validity(mod_b, b, device, example_ids, presence))
            if self.local_loss and world > 1:
                # this rank's share of the global mean, times the ranks
                rows = valid[offset:offset + local_b]
                chunk = self.chunk_size if self.chunked else None
                n = valid.sum().clamp_min(1)
                loss_ab = world * infonce_rows(local_feats[mod_a], zb, logit_scale, rows, valid,
                                               offset, chunk) / n
                loss_ba = world * infonce_rows(local_feats[mod_b], za, logit_scale, rows, valid,
                                               offset, chunk) / n
            elif self.chunked:
                loss_ab = masked_infonce_chunked(za, zb, logit_scale, valid, self.chunk_size)
                loss_ba = masked_infonce_chunked(zb, za, logit_scale, valid, self.chunk_size)
            else:
                logits = logit_scale * torch.matmul(za.float(), zb.float().T)
                loss_ab = masked_infonce(logits, valid)
                loss_ba = masked_infonce(logits.T, valid)
            pair_loss = 0.5 * (loss_ab + loss_ba)
            metrics[f"loss_{mod_a}_{mod_b}"] = pair_loss
            total = total + pair.weight * pair_loss
        if self.modality_alignment:
            align = self._alignment_loss(feats, example_ids, logit_scale, presence)
            metrics["loss_alignment"] = align
            total = total + align
        return total, metrics

    def _alignment_loss(
        self,
        feats: Mapping[str, torch.Tensor],
        example_ids: Optional[Mapping[str, torch.Tensor]],
        logit_scale: torch.Tensor,
        presence: Optional[Mapping[str, torch.Tensor]],
    ) -> torch.Tensor:
        """BCE over the full cross-modality similarity matrix: the targets
        are the identity plus the strict upper triangle of each modality's
        diagonal block; per row, mean positive BCE plus mean negative BCE,
        averaged over valid rows. Rows and columns of absent examples are
        excluded."""
        mods = list(feats)
        all_feats = torch.cat([feats[m] for m in mods]).float()
        b = feats[mods[0]].shape[0]
        device = all_feats.device
        all_valid = torch.cat([_validity(m, b, device, example_ids, presence) for m in mods])
        block = torch.cat([torch.full((feats[m].shape[0],), i, device=device)
                           for i, m in enumerate(mods)])
        n = all_feats.shape[0]
        sim = logit_scale * torch.matmul(all_feats, all_feats.T)
        idx = torch.arange(n, device=device)
        same_block = block[:, None] == block[None, :]
        target = (idx[:, None] == idx[None, :]) | (same_block & (idx[:, None] < idx[None, :]))
        pair_valid = all_valid[:, None] & all_valid[None, :]
        bce = sim.clamp_min(0) - sim * target.float() + torch.log1p(torch.exp(-sim.abs()))
        bce = torch.where(pair_valid, bce, 0.0)
        pos = target & pair_valid
        neg = ~target & pair_valid
        loss_pos = torch.where(pos, bce, 0.0).sum(1) / pos.sum(1).clamp_min(1)
        loss_neg = torch.where(neg, bce, 0.0).sum(1) / neg.sum(1).clamp_min(1)
        row = torch.where(all_valid, loss_pos + loss_neg, 0.0)
        return row.sum() / all_valid.sum().clamp_min(1)
