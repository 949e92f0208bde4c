"""Tokenizers, counterpart of :mod:`mmlearn_tpu.datasets.processors.tokenizers`
(``HFTokenizer`` :20, ``HFCLIPTokenizer`` :73, ``Img2Seq`` :80).

``HFTokenizer`` wraps a HuggingFace tokenizer and returns the text
modality's keys as int32 numpy arrays padded to ``max_length``.
``transformers`` is imported only where a name or path is given; a
tokenizer object passed in needs nothing.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.datasets.core.modalities import Modalities


@store(group="datasets/tokenizers", name="HFTokenizer", populate_full_signature=False)
class HFTokenizer:
    """Wrap a HuggingFace tokenizer; emit modality-keyed numpy arrays."""

    def __init__(
        self,
        pretrained_model_name_or_path: Optional[str] = None,
        tokenizer: Optional[Any] = None,
        max_length: int = 77,
        padding: str = "max_length",
        truncation: bool = True,
        **kwargs: Any,
    ) -> None:
        if tokenizer is not None:
            self.tokenizer = tokenizer
        else:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(pretrained_model_name_or_path, **kwargs)
        self.max_length = max_length
        self.padding = padding
        self.truncation = truncation

    def __call__(self, sentence: Union[str, Sequence[str]], **kwargs: Any) -> dict[str, np.ndarray]:
        batched = not isinstance(sentence, str)
        out = self.tokenizer(
            list(sentence) if batched else sentence,
            max_length=self.max_length,
            padding=self.padding,
            truncation=self.truncation,
            return_tensors="np",
            **kwargs,
        )
        input_ids = np.asarray(out["input_ids"])
        # read before np.asarray: asarray(None) is a 0-d object array
        attention_mask = out.get("attention_mask")
        if attention_mask is not None:
            attention_mask = np.asarray(attention_mask)
        if not batched:
            input_ids = input_ids[0]
            if attention_mask is not None:
                attention_mask = attention_mask[0]
        text = Modalities.get_modality("text")
        result = {text.name: input_ids.astype(np.int32)}
        if attention_mask is not None:
            result[text.attention_mask] = attention_mask.astype(np.int32)
        return result


@store(group="datasets/tokenizers", name="HFCLIPTokenizer", populate_full_signature=False)
class HFCLIPTokenizer(HFTokenizer):
    """The CLIP tokenizer preset (77 tokens)."""

    def __init__(
        self, pretrained_model_name_or_path: str = "openai/clip-vit-base-patch16", **kwargs: Any
    ) -> None:
        super().__init__(pretrained_model_name_or_path, max_length=77, **kwargs)


class Img2Seq:
    """Patchify an HWC image into ``(num_patches, patch_size ** 2 * C)``
    (a ragged border is dropped); the CLS token and positions belong to the
    model."""

    def __init__(self, img_size: int, patch_size: int) -> None:
        self.img_size = img_size
        self.patch_size = patch_size

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w, c = img.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        img = img[: gh * p, : gw * p]
        img = img.reshape(gh, p, gw, p, c).transpose(0, 2, 1, 3, 4)
        return img.reshape(gh * gw, p * p * c)
