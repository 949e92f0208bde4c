"""BarcodeBERT DNA encoder, counterpart of ``projects.bioscan_clip.encoders``.

A BERT-MLM trunk (:class:`~mmlearn_tpu_torch.modules.encoders.bert.
BertTextEncoder`, no pooling) whose MLM head keeps its ``transform`` dense,
gelu and ``transform_norm`` and has its decoder replaced by a projection to
``projection_dim``; the pooled embedding is ``softmax(logits, -1)`` averaged
over the sequence, in f32. LoRA and freezing come from the task's
``peft_configs`` (:mod:`mmlearn_tpu_torch.peft`); a torch MLM checkpoint
converts with :func:`load_barcode_bert_checkpoint`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmlearn_tpu_torch.bridge import jax_to_torch
from mmlearn_tpu_torch.modules.encoders.base import (
    EncoderOutput,
    as_dtype,
    dtype_name,
    reset_submodules,
)
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.modules.layers.normalization import LayerNorm


class BarcodeBERT(nn.Module):
    """BERT trunk and MLM-style head projecting to the shared embedding."""

    def __init__(
        self,
        vocab_size: int = 1027,  # 3 special tokens + 4^5 k-mers
        projection_dim: int = 512,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        max_length: int = 256,
        norm_eps: float = 1e-12,
        remat: bool = False,
        dtype: torch.dtype | str = torch.float32,
        param_dtype: torch.dtype | str = torch.float32,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dtype, param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        self.config = dict(
            vocab_size=vocab_size, projection_dim=projection_dim, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, max_length=max_length, norm_eps=norm_eps,
            remat=remat, dtype=dtype_name(dtype), param_dtype=dtype_name(param_dtype),
        )
        self.num_heads = num_heads
        self.bert = BertTextEncoder(
            vocab_size=vocab_size, max_length=max_length, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, norm_eps=norm_eps, pooling="none", use_pooler=False,
            remat=remat, dtype=dtype, param_dtype=param_dtype,
        )
        self.transform = Dense(embed_dim, embed_dim, True, dtype, param_dtype)
        self.transform_norm = LayerNorm(embed_dim, norm_eps, dtype, param_dtype)
        self.decoder = Dense(embed_dim, projection_dim, True, dtype, param_dtype)
        reset_submodules(self, generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> EncoderOutput:
        hidden = self.bert(input_ids, attention_mask=attention_mask).last_hidden_state
        x = self.transform_norm(F.gelu(self.transform(hidden), approximate="none"))
        logits = self.decoder(x)
        pooled = torch.softmax(logits.float(), dim=-1).mean(dim=1)
        return EncoderOutput(last_hidden_state=logits, pooler_output=pooled)


def load_barcode_bert_checkpoint(state_dict: Any, depth: int, projection_dim: int,
                                 num_heads: Optional[int] = None) -> dict[str, torch.Tensor]:
    """A torch BarcodeBERT / ``BertForMaskedLM`` state dict as
    ``BarcodeBERT``'s ``state_dict`` entries: the trunk, the MLM head's
    ``transform`` and ``transform_norm``, and the decoder only where its
    shape is the projection's (the replaced decoder otherwise keeps its
    initialisation). Load it with ``load_state_dict(..., strict=False)``."""
    from mmlearn_tpu_torch.hf_utils import _layernorm, _linear, _np, bert_tree

    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    params: dict[str, Any] = {"bert": bert_tree(sd, depth, prefix="bert", num_heads=num_heads)}
    if "cls.predictions.transform.dense.weight" in sd:
        params["transform"] = _linear(sd, "cls.predictions.transform.dense")
        params["transform_norm"] = _layernorm(sd, "cls.predictions.transform.LayerNorm")
    if ("cls.predictions.decoder.weight" in sd
            and _np(sd["cls.predictions.decoder.weight"]).shape[0] == projection_dim):
        params["decoder"] = _linear(sd, "cls.predictions.decoder")
    return jax_to_torch(params)
