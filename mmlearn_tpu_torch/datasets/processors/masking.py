"""Host-side mask generators, counterpart of
:mod:`mmlearn_tpu.datasets.processors.masking`: BERT-style token masking
(``RandomMaskGenerator`` :28), data2vec-style blockwise patch masking
(``BlockwiseImagePatchMaskGenerator`` :106) and the I-JEPA context/target
blocks (``IJEPAMaskGenerator`` :192-285, ``_sample_block_size`` :80,
``_block_indices`` :169).

Plain numpy on the host, draw for draw the JAX package's generators: the
same ``numpy.random.Generator`` gives the same arrays. Every output has a
fixed size. Called without a generator, each spawns a child of its own
persistent one under a lock (numpy generators are not thread-safe, and the
loader fetches from a thread pool). The I-JEPA keep counts are fixed
(``k_tgt`` from the mean target scale; ``k_ctx`` from the mean context scale
less the expected union of the targets), so every batch has one shape. At
224 px with 16-px patches that is ``k_tgt`` 34 and ``k_ctx`` 84.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from mmlearn_tpu_torch.conf import store

_RNG_LOCK = threading.Lock()


def _sample_block_size(
    rng: np.random.Generator,
    num_patches_h: int,
    num_patches_w: int,
    scale: tuple[float, float],
    aspect_ratio: tuple[float, float],
) -> tuple[int, int]:
    """Sample a (h, w) patch block from scale/aspect ranges."""
    total = num_patches_h * num_patches_w
    s = rng.uniform(scale[0], scale[1])
    target_area = s * total
    log_ar = (math.log(aspect_ratio[0]), math.log(aspect_ratio[1]))
    ar = math.exp(rng.uniform(*log_ar))
    h = int(round(math.sqrt(target_area * ar)))
    w = int(round(math.sqrt(target_area / ar)))
    h = max(1, min(h, num_patches_h - 1))
    w = max(1, min(w, num_patches_w - 1))
    return h, w


@store(group="datasets/masking", name="RandomMaskGenerator", populate_full_signature=False)
@dataclass
class RandomMaskGenerator:
    """BERT-style 80/10/10 token masking. ``__call__(input_ids,
    attention_mask, rng)`` returns ``(masked_ids, labels, mask)``: a share
    ``probability`` of the eligible tokens (not special, not padding) is
    masked; of those 80% become ``mask_token_id``, 10% a random id and 10%
    stay; ``labels`` holds the original id where masked, else -100."""

    probability: float = 0.15
    mask_token_id: int = 103
    vocab_size: int = 30522
    special_token_ids: tuple[int, ...] = (0, 101, 102, 103)
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        # one persistent generator, advanced across calls
        self._rng = np.random.default_rng(self.seed)

    def __call__(
        self,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if rng is None:
            with _RNG_LOCK:
                rng = self._rng.spawn(1)[0]
        input_ids = np.asarray(input_ids)
        eligible = ~np.isin(input_ids, np.asarray(self.special_token_ids))
        if attention_mask is not None:
            eligible &= np.asarray(attention_mask).astype(bool)
        mask = (rng.random(input_ids.shape) < self.probability) & eligible
        labels = np.where(mask, input_ids, -100)
        masked_ids = input_ids.copy()
        roll = rng.random(input_ids.shape)
        use_mask_tok = mask & (roll < 0.8)
        use_random = mask & (roll >= 0.8) & (roll < 0.9)
        masked_ids[use_mask_tok] = self.mask_token_id
        masked_ids[use_random] = rng.integers(0, self.vocab_size, size=int(use_random.sum()))
        return masked_ids, labels, mask


@store(
    group="datasets/masking",
    name="BlockwiseImagePatchMaskGenerator",
    populate_full_signature=False,
)
@dataclass
class BlockwiseImagePatchMaskGenerator:
    """Blockwise patch masking: ``__call__(rng)`` returns a boolean
    ``(input_size ** 2,)`` mask with exactly ``num_masking_patches`` True
    entries (blocks of random scale and aspect, then random patches if 100
    attempts fall short)."""

    input_size: int = 14  # patches a side
    num_masking_patches: int = 75
    min_num_patches: int = 4
    max_num_patches: Optional[int] = None
    min_aspect: float = 0.3
    max_aspect: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        self.height = self.width = self.input_size
        self._max_patches = self.max_num_patches or self.num_masking_patches
        self._max_aspect = self.max_aspect or 1 / self.min_aspect
        self._rng = np.random.default_rng(self.seed)

    def __call__(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if rng is None:
            with _RNG_LOCK:
                rng = self._rng.spawn(1)[0]
        mask = np.zeros((self.height, self.width), dtype=bool)
        count = 0
        attempts = 0
        while count < self.num_masking_patches and attempts < 100:
            attempts += 1
            target = min(self._max_patches, self.num_masking_patches - count)
            if target < self.min_num_patches:
                target = self.min_num_patches
            s = target / (self.height * self.width)
            h, w = _sample_block_size(
                rng, self.height, self.width, (s, s), (self.min_aspect, self._max_aspect))
            top = rng.integers(0, self.height - h + 1)
            left = rng.integers(0, self.width - w + 1)
            new = ~mask[top : top + h, left : left + w]
            take = min(int(new.sum()), self.num_masking_patches - count)
            if take <= 0:
                continue
            ys, xs = np.nonzero(new)
            mask[top + ys[:take], left + xs[:take]] = True
            count += take
        if count < self.num_masking_patches:  # random patches up to the fixed count
            flat = mask.reshape(-1)
            empty = np.nonzero(~flat)[0]
            flat[rng.choice(empty, self.num_masking_patches - count, replace=False)] = True
        return mask.reshape(-1)


def _block_indices(
    rng: np.random.Generator, grid_h: int, grid_w: int, h: int, w: int, fixed_size: int
) -> np.ndarray:
    """Flattened patch indices of a random (h, w) block, padded (by cycling:
    duplicates are harmless to a gather) or cut to ``fixed_size``."""
    top = rng.integers(0, grid_h - h + 1)
    left = rng.integers(0, grid_w - w + 1)
    rows = np.arange(top, top + h)[:, None]
    cols = np.arange(left, left + w)[None, :]
    idx = (rows * grid_w + cols).reshape(-1)
    if len(idx) >= fixed_size:
        return idx[:fixed_size]
    reps = int(np.ceil(fixed_size / len(idx)))
    return np.tile(idx, reps)[:fixed_size]


@store(group="datasets/masking", name="IJEPAMaskGenerator", populate_full_signature=False)
@dataclass
class IJEPAMaskGenerator:
    """``__call__(batch_size, rng)`` returns ``{"encoder_masks": (nenc, B,
    k_ctx), "predictor_masks": (npred, B, k_tgt)}`` int32 patch indices.
    Context blocks leave out every target patch (``allow_overlap=False``)."""

    input_size: int = 224
    patch_size: int = 16
    min_keep: int = 10
    allow_overlap: bool = False
    enc_mask_scale: tuple[float, float] = (0.85, 1.0)
    pred_mask_scale: tuple[float, float] = (0.15, 0.2)
    aspect_ratio: tuple[float, float] = (0.75, 1.0)
    nenc: int = 1
    npred: int = 4
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        self.grid = self.input_size // self.patch_size
        self.num_patches = self.grid * self.grid
        mean_pred = 0.5 * (self.pred_mask_scale[0] + self.pred_mask_scale[1])
        self.k_tgt = max(self.min_keep, int(round(self.num_patches * mean_pred)))
        mean_enc = 0.5 * (self.enc_mask_scale[0] + self.enc_mask_scale[1])
        k_enc_raw = int(round(self.num_patches * mean_enc))
        if not self.allow_overlap:
            # the targets overlap each other: the context loses the expected
            # union of the npred target blocks
            coverage = 1.0 - (1.0 - mean_pred) ** self.npred
            k_enc_raw = int(round(k_enc_raw * (1.0 - coverage)))
        self.k_ctx = max(self.min_keep, k_enc_raw)
        self._rng = np.random.default_rng(self.seed)

    def __call__(
        self, batch_size: int, rng: Optional[np.random.Generator] = None
    ) -> dict[str, np.ndarray]:
        if rng is None:
            with _RNG_LOCK:
                rng = self._rng.spawn(1)[0]
        pred_masks = np.zeros((self.npred, batch_size, self.k_tgt), np.int32)
        enc_masks = np.zeros((self.nenc, batch_size, self.k_ctx), np.int32)
        # block shapes once a batch, offsets once an example
        ph, pw = _sample_block_size(
            rng, self.grid, self.grid, self.pred_mask_scale, self.aspect_ratio
        )
        eh, ew = _sample_block_size(rng, self.grid, self.grid, self.enc_mask_scale, (1.0, 1.0))
        for b in range(batch_size):
            taken = np.zeros(self.num_patches, dtype=bool)
            for m in range(self.npred):
                idx = _block_indices(rng, self.grid, self.grid, ph, pw, self.k_tgt)
                pred_masks[m, b] = idx
                taken[idx] = True
            for m in range(self.nenc):
                # context: a block at the context scale less every target patch
                top = rng.integers(0, self.grid - eh + 1)
                left = rng.integers(0, self.grid - ew + 1)
                rows = np.arange(top, top + eh)[:, None]
                cols = np.arange(left, left + ew)[None, :]
                block = (rows * self.grid + cols).reshape(-1)
                if not self.allow_overlap:
                    free = block[~taken[block]]
                    if len(free) < self.min_keep:
                        fallback = np.nonzero(~taken)[0]
                        free = fallback if len(fallback) >= self.min_keep else block
                else:
                    free = block
                k = min(self.k_ctx, len(free))
                sel = rng.choice(free, size=k, replace=False)
                if k < self.k_ctx:
                    sel = np.concatenate([sel, rng.choice(free, self.k_ctx - k, replace=True)])
                enc_masks[m, b] = np.sort(sel)
        return {"encoder_masks": enc_masks, "predictor_masks": pred_masks}
