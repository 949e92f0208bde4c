"""The BIOSCAN-CLIP trimodal recipe built in Python: the ``task`` of the
port's ``configs/experiment/bioscan_1m.yaml`` (composed by the CLI with
``searchpath=[pkg://mmlearn_tpu_torch.projects.bioscan_clip.configs]``),
parameter for parameter; ``tests/test_torch_med_benchmarking.py::
test_bioscan_yaml_task_equals_the_recipe`` holds the two equal.

:func:`bioscan_task` is the YAML's ``task``: a ViT-B/16 rgb tower of timm
``vit_base_patch16_224``'s geometry (gelu, no pre-norm, final norm, cls
pooling, a biased projection to 768), a post-LN BERT text tower of
``prajjwal1/bert-small``'s geometry (width 512, depth 4, 8 heads, mean
pooling) with an ``MLP`` head to 768, and the BarcodeBERT dna tower (width
768, depth 12, 12 heads, 5-mer vocabulary 1027); LoRA r=4, alpha 8 on every
tower's fused qkv (per-slice q and v factors on text and dna; the rgb and dna
projections kept trainable), the three weighted loss pairs, AdamW (eps
1e-6, weight decay 0.01) and the one-cycle schedule (max_lr 1e-3,
pct_start 0.3). Each tower's geometry can be overridden (the tests' tiny
towers).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from mmlearn_tpu_torch.modules.encoders.base import as_dtype
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.encoders.vision import VisionTransformer
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.lr_schedulers import onecycle_lr
from mmlearn_tpu_torch.peft import LoRAConfig
from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT
from mmlearn_tpu_torch.tasks.contrastive_pretraining import ContrastivePretraining

#: timm vit_base_patch16_224 (bioscan_1m.yaml:52-73)
RGB = dict(img_size=224, patch_size=16, embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
           use_cls_token=True, learned_pos_embed=True, pre_norm=False, final_norm=True,
           act_layer="gelu", norm_eps=1e-6, global_pool="cls", proj_dim=768, proj_bias=True,
           patch_embed_bias=True)
#: prajjwal1/bert-small (bioscan_1m.yaml:74-88)
TEXT = dict(vocab_size=30522, max_length=512, embed_dim=512, depth=4, num_heads=8,
            mlp_ratio=4.0, pooling="mean", use_pooler=False)
#: BarcodeBERT (bioscan_1m.yaml:89-99)
DNA = dict(vocab_size=1027, projection_dim=768, embed_dim=768, depth=12, num_heads=12,
           max_length=256)
LOSS_PAIRS = (("rgb", "dna"), ("rgb", "text"), ("dna", "text"))


def peft_configs(text_heads: int, dna_heads: int) -> dict[str, LoRAConfig]:
    """The recipe's LoRA configs (bioscan_1m.yaml:110-128)."""
    qkv = (r".*attn/qkv$",)
    return {
        "rgb": LoRAConfig(r=4, lora_alpha=8, target_patterns=qkv, modules_to_save=("^proj/",)),
        "text": LoRAConfig(r=4, lora_alpha=8, target_patterns=qkv, qkv_slices=("q", "v"),
                           qkv_num_heads=text_heads),
        "dna": LoRAConfig(r=4, lora_alpha=8, target_patterns=qkv, qkv_slices=("q", "v"),
                          qkv_num_heads=dna_heads, modules_to_save=("^decoder/",)),
    }


def bioscan_task(
    rgb: Optional[dict[str, Any]] = None,
    text: Optional[dict[str, Any]] = None,
    dna: Optional[dict[str, Any]] = None,
    total_steps: int = 20264,
    max_lr: float = 1e-3,
    dtype: torch.dtype | str = torch.float32,
    remat: bool = False,
    device: torch.device | str = "cuda",
    seed: int = 0,
) -> ContrastivePretraining:
    """The recipe's task; ``rgb``, ``text`` and ``dna`` override entries of
    :data:`RGB`, :data:`TEXT` and :data:`DNA`. The weights come from
    generators seeded by ``seed`` (one a tower, one for the LoRA factors),
    made on the CPU and moved to ``device`` (the card unless the caller
    passes another)."""
    rgb, text, dna = {**RGB, **(rgb or {})}, {**TEXT, **(text or {})}, {**DNA, **(dna or {})}
    dtype = as_dtype(dtype)
    gen = [torch.Generator().manual_seed(seed + i) for i in range(5)]
    encoders = {
        "rgb": VisionTransformer(**rgb, remat=remat, dtype=dtype, generator=gen[0]),
        "text": BertTextEncoder(**text, remat=remat, dtype=dtype, generator=gen[1]),
        "dna": BarcodeBERT(**dna, remat=remat, dtype=dtype, generator=gen[2]),
    }
    head = MLP(text["embed_dim"], out_dim=dna["projection_dim"], dtype=dtype)
    head.fc1.reset_parameters(gen[3])
    task = ContrastivePretraining(
        encoders,
        heads={"text": head},
        modality_loss_pairs=[{"modalities": pair, "weight": 1.0} for pair in LOSS_PAIRS],
        optimizer=functools.partial(torch.optim.AdamW, eps=1e-6, weight_decay=0.01),
        lr_scheduler=functools.partial(onecycle_lr, max_lr=max_lr, total_steps=total_steps,
                                       pct_start=0.3),
        peft_configs=peft_configs(text["num_heads"], dna["num_heads"]),
        generator=gen[4],
    )
    return task.to(device)
