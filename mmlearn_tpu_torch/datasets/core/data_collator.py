"""Batch collation of heterogeneous examples, counterpart of
:mod:`mmlearn_tpu.datasets.core.data_collator` (``_stack_with_presence``
:31, ``collate_example_list`` :90, ``DefaultDataCollator`` :115).

Every key becomes one dense, fixed-size numpy array: an example that lacks
the key contributes zeros, and a boolean mask under
``f"{key}{MODALITY_PRESENCE_SUFFIX}"`` says which rows are real. Nested
mappings collate key by key (``example_ids`` fills a missing id with the
sentinel ``(-1, -1)``); strings stay python lists. Arrays come out of
``np.stack`` C-contiguous, so ``torch.from_numpy`` takes them without a
copy. ``batch_processors`` run after collation (batch-level tokenization).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

from mmlearn_tpu_torch.constants import MODALITY_PRESENCE_SUFFIX
from mmlearn_tpu_torch.datasets.core.example import Example

_ID_SENTINEL = np.asarray([-1, -1], dtype=np.int64)


def _is_arraylike(value: Any) -> bool:
    return isinstance(value, (np.ndarray, np.generic, int, float, bool, np.bool_))


def _stack_with_presence(values: list[Any], present: np.ndarray, key: str) -> tuple[Any, bool]:
    """Stack per-example values (``None`` where missing) into one batch
    value. Returns ``(batch_value, needs_mask)``."""
    template = next(v for v in values if v is not None)
    if isinstance(template, Mapping):
        sub_keys: list[str] = []
        for v in values:
            if v is not None:
                for k in v:
                    if k not in sub_keys:
                        sub_keys.append(k)
        out: dict[str, Any] = {}
        for sub_key in sub_keys:
            sub_values = [v.get(sub_key) if v is not None else None for v in values]
            sub_present = np.asarray([v is not None for v in sub_values], dtype=bool)
            if key == "example_ids":
                filled = [np.asarray(v, dtype=np.int64) if v is not None else _ID_SENTINEL
                          for v in sub_values]
                out[sub_key] = np.stack(filled)
            else:
                collated, needs_mask = _stack_with_presence(sub_values, sub_present, sub_key)
                out[sub_key] = collated
                if needs_mask:
                    out[f"{sub_key}{MODALITY_PRESENCE_SUFFIX}"] = sub_present
        return out, False
    if isinstance(template, str):
        return [v if v is not None else "" for v in values], not present.all()
    if _is_arraylike(template):
        template_arr = np.asarray(template)
        zero = np.zeros_like(template_arr)
        rows = []
        for v in values:
            if v is None:
                rows.append(zero)
                continue
            arr = np.asarray(v)
            if arr.shape != template_arr.shape:
                raise ValueError(
                    f"Inconsistent shapes for key '{key}': {arr.shape} vs "
                    f"{template_arr.shape}. Datasets must emit fixed-shape values "
                    "(pad/resize in transforms)."
                )
            rows.append(arr)
        return np.stack(rows), not present.all()
    # opaque python objects stay a list
    return list(values), not present.all()


def collate_example_list(examples: Sequence[Example | Mapping[str, Any]]) -> dict[str, Any]:
    """Merge a list of (possibly hetero-keyed) examples into one batch dict."""
    if not examples:
        raise ValueError("Cannot collate an empty list of examples")
    keys: list[str] = []
    for ex in examples:
        for k in ex:
            if k not in keys:
                keys.append(k)
    batch: dict[str, Any] = {}
    for key in keys:
        values = [ex.get(key) if hasattr(ex, "get") else ex[key] for ex in examples]
        present = np.asarray([v is not None for v in values], dtype=bool)
        if not present.any():
            continue
        collated, needs_mask = _stack_with_presence(values, present, key)
        batch[key] = collated
        if needs_mask:
            batch[f"{key}{MODALITY_PRESENCE_SUFFIX}"] = present
    return batch


class DefaultDataCollator:
    """Collate ``Example`` lists, then apply the per-key batch processors
    (a processor returning a mapping merges it into the batch, replacing
    its key unless the mapping keeps it)."""

    def __init__(self, batch_processors: Optional[dict[str, Callable[[Any], Any]]] = None) -> None:
        self.batch_processors = batch_processors or {}

    def __call__(self, examples: Sequence[Example]) -> dict[str, Any]:
        batch = collate_example_list(examples)
        for key, processor in self.batch_processors.items():
            batch_key = str(key)
            if batch_key not in batch:
                continue
            processed = processor(batch[batch_key])
            if isinstance(processed, Mapping):
                if batch_key not in processed:
                    del batch[batch_key]
                batch.update(processed)
            else:
                batch[batch_key] = processed
        return batch
