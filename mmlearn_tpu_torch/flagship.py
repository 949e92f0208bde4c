"""The flagship model of the port: CLIP ViT-B/16 with its text tower.

Counterpart of ``__graft_entry__._flagship_task``: the same two towers at
full width, weights in f32 and compute in bf16 (flax ``dtype=bfloat16``),
initialised from a seeded ``torch.Generator``.

- image: ViT-B/16 at 224 px (197 tokens), 12 blocks of width 768, 12 heads
  of dim 64, quick_gelu, pre-norm, CLS pooling, 512-d projection without
  bias;
- text: vocab 49408, 77 tokens, 12 causal blocks of width 512, 8 heads of
  dim 64, EOS pooling, 512-d projection.
"""

from __future__ import annotations

import torch

from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.tasks.contrastive_pretraining import ContrastivePretraining

IMAGE_SIZE = 224
TEXT_LENGTH = 77
VOCAB_SIZE = 49408


def flagship_task(device: torch.device | str, seed: int = 0) -> ContrastivePretraining:
    """Build the flagship towers on ``device`` in eval mode. The weights are
    drawn on the CPU from ``seed``, so they are the same on every device."""
    g = torch.Generator().manual_seed(seed)
    vision = VisionTransformer(
        img_size=IMAGE_SIZE, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        use_cls_token=True, learned_pos_embed=True, pre_norm=True,
        act_layer="quick_gelu", global_pool="cls", proj_dim=512,
        dtype=torch.bfloat16, generator=g,
    )
    text = TextTransformer(
        vocab_size=VOCAB_SIZE, max_length=TEXT_LENGTH, embed_dim=512, depth=12,
        num_heads=8, causal=True, pooling="eos", proj_dim=512,
        dtype=torch.bfloat16, generator=g,
    )
    return ContrastivePretraining({"rgb": vision, "text": text}).to(device).eval()
