"""The flagship model of the port: CLIP ViT-B/16 with its text tower.

Counterpart of ``__graft_entry__._flagship_task`` and ``_synthetic_batch``:
the same two towers at full width, weights in f32 and compute in bf16 (flax
``dtype=bfloat16``), initialised from a seeded ``torch.Generator``.

- image: ViT-B/16 at 224 px (197 tokens), 12 blocks of width 768, 12 heads
  of dim 64, quick_gelu, pre-norm, CLS pooling, 512-d projection without
  bias;
- text: vocab 49408, 77 tokens, 12 causal blocks of width 512, 8 heads of
  dim 64, EOS pooling, 512-d projection.

:func:`flagship_training_task` adds what ``bench.py`` trains with: AdamW
with weight decay 0.01 and the linear-warmup cosine schedule (base rate
1e-3, 100 warmup steps, 10,000 steps). :func:`synthetic_batch` and
:func:`ragged_text_batch` make the inputs of the training step and of text
serving.

:func:`highres_task` and :func:`highres_training_task` are the same towers
with the image tower at 448 px (28 x 28 patches + CLS = 785 tokens), the
usual high-resolution fine-tune and serving setting of a 224-px CLIP: the
seed's 224-px towers, with the 197-row position table carried to 785 rows by
:func:`~mmlearn_tpu_torch.modules.layers.interpolate_pos_embed`. Their image
attention takes the flash kernel (:func:`~mmlearn_tpu_torch.ops.fused_attention.supports_fused`
admits N <= 768 at D=64); :func:`highres_batch` is the synthetic batch at 448
px.

:func:`ijepa_training_task` is ``bench.py``'s second step
(``_ijepa_img_per_sec``): an I-JEPA ViT-B/16 student (224 px, 196 patch
tokens, no cls token, fixed 2-D sin-cos positions, exact-erf gelu, norm eps
1e-6, final norm), the default predictor (width 384, depth 6, 12 heads of
dim 32) and an EMA teacher (decay 0.996 to 1.0 over 100,000 steps), weights
f32 and compute bf16, trained with ``optax.adamw(learning_rate=1e-3)``:
AdamW at 1e-3 with optax's default weight decay 1e-4 (on weights of ndim >=
2), no schedule. :func:`ijepa_batch` makes its input.

:func:`vit_h14_training_task` and :func:`vit_g14_task` are the large presets
at the geometries of two public CLIP models, OpenCLIP's ``ViT-H-14.json``
and ``ViT-g-14.json``, with random weights drawn from ``seed`` (no
published weights are read):

- ViT-H/14: the ``vit_huge`` preset (32 blocks of width 1280, 16 heads of
  dim 80) at 224 px in 14-px patches (256 + CLS = 257 tokens), exact-erf
  gelu, LayerNorm eps 1e-5, ``norm_pre``, a patch embedding without bias,
  CLS pooling and a 1024-d projection without bias; its attention takes K1
  at D=80 (``supports_fused`` admits N <= 336 there);
- ViT-g/14: the ``vit_giant`` preset (40 blocks of width 1408, 16 heads of
  dim 88, MLP ratio 48/11) at the same geometry; its 257 tokens are past
  K1's limit at D=88 (208), so its attention takes the flash kernel K3;
- the text tower of both: 77 tokens, 24 causal blocks of width 1024, 16
  heads of dim 64, gelu, eps 1e-5, EOS pooling, 1024-d projection.

The ViT-H/14 pair trains with both towers under activation checkpointing
(``remat=True``, the ``dots_no_batch`` policy, as every project config and
the JAX flagship train) in bf16 with the flagship's AdamW and schedule;
``drop_path_rate`` sets the image tower's stochastic depth (0 by default,
as OpenCLIP trains it). ``vit_g14_task(patch_size=16)`` is ViT-g/16 (197
tokens), whose attention takes K1 at D=88.

:func:`tiny_training_task` is ``__graft_entry__._flagship_task(tiny=True)``:
the pair at test widths (2 blocks of width 64, 32-px images, 16 tokens), in
f32. :func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: one sharded step of the tiny pair over
n CPU processes on gloo (:mod:`mmlearn_tpu_torch.parallel`), started in
fresh processes by :func:`~mmlearn_tpu_torch.parallel.mp_launch.run_workers`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mmlearn_tpu_torch.datasets.processors.masking import IJEPAMaskGenerator
from mmlearn_tpu_torch.modules.encoders import (
    TextTransformer,
    VisionTransformer,
    vit_giant,
    vit_huge,
)
from mmlearn_tpu_torch.modules.layers import interpolate_pos_embed
from mmlearn_tpu_torch.modules.lr_schedulers import linear_warmup_cosine_annealing_lr
from mmlearn_tpu_torch.tasks.contrastive_pretraining import ContrastivePretraining
from mmlearn_tpu_torch.tasks.ijepa import ENCODER_MASK_KEY, IJEPA, PREDICTOR_MASK_KEY

IMAGE_SIZE = 224
HIGHRES_IMAGE_SIZE = 448
TEXT_LENGTH = 77
VOCAB_SIZE = 49408


def _towers(seed: int) -> dict[str, torch.nn.Module]:
    """Both towers, weights drawn on the CPU from ``seed`` (the same on
    every device)."""
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
    return {"rgb": vision, "text": text}


def _highres_towers(seed: int, image_size: int) -> dict[str, torch.nn.Module]:
    """:func:`_towers` with the image tower rebuilt at ``image_size``: the
    224-px weights, and the position table interpolated to the new grid."""
    towers = _towers(seed)
    low = towers["rgb"]
    config = {**low.config, "img_size": image_size}
    high = VisionTransformer(**config, generator=torch.Generator().manual_seed(seed))
    state = low.state_dict()
    patch = low.config["patch_size"]
    state["pos_embed"] = interpolate_pos_embed(
        state["pos_embed"], (image_size // patch,) * 2, (IMAGE_SIZE // patch,) * 2,
        low.num_prefix)
    high.load_state_dict(state)
    towers["rgb"] = high
    return towers


def _training(towers: dict[str, torch.nn.Module]) -> ContrastivePretraining:
    """The contrastive task with the optimizer and schedule of ``bench.py``'s
    train step: AdamW with weight decay 0.01, warmup-cosine from 1e-3."""
    return ContrastivePretraining(
        towers,
        optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
        lr_scheduler=functools.partial(
            linear_warmup_cosine_annealing_lr, base_lr=1e-3, warmup_steps=100,
            max_steps=10_000,
        ),
    )


def flagship_task(device: torch.device | str = "cuda", seed: int = 0) -> ContrastivePretraining:
    """The flagship towers on ``device`` in eval mode, for serving."""
    return ContrastivePretraining(_towers(seed)).to(device).eval()


def flagship_training_task(
    device: torch.device | str = "cuda", seed: int = 0
) -> ContrastivePretraining:
    """The flagship contrastive task on ``device`` in train mode, with the
    optimizer and schedule of ``bench.py``'s train step."""
    return _training(_towers(seed)).to(device).train()


def highres_task(
    device: torch.device | str = "cuda", seed: int = 0, image_size: int = HIGHRES_IMAGE_SIZE
) -> ContrastivePretraining:
    """The flagship towers with the image tower at ``image_size`` (its
    position table interpolated from the seed's 224-px one) on ``device`` in
    eval mode, for serving."""
    return ContrastivePretraining(_highres_towers(seed, image_size)).to(device).eval()


def highres_training_task(
    device: torch.device | str = "cuda", seed: int = 0, image_size: int = HIGHRES_IMAGE_SIZE
) -> ContrastivePretraining:
    """:func:`highres_task`'s towers as the flagship contrastive task in
    train mode: a 224-px checkpoint fine-tuned at ``image_size``."""
    return _training(_highres_towers(seed, image_size)).to(device).train()


def synthetic_batch(
    batch_size: int,
    generator: torch.Generator,
    device: torch.device | str = "cuda",
    image_size: int = IMAGE_SIZE,
) -> dict[str, torch.Tensor]:
    """The synthetic batch of ``_synthetic_batch``, drawn from ``generator``
    (on its own device) and placed on ``device``: standard-normal bf16
    images of ``image_size`` pixels a side, token ids in ``[2, vocab - 2]``
    with the end-of-text id ``vocab - 1`` at the last position, and no
    padding mask (the sequences are full length)."""
    g_dev = generator.device
    images = torch.randn(batch_size, image_size, image_size, 3, generator=generator,
                         device=g_dev)
    ids = torch.randint(2, VOCAB_SIZE - 1, (batch_size, TEXT_LENGTH), generator=generator,
                        device=g_dev, dtype=torch.int32)
    ids[:, -1] = VOCAB_SIZE - 1
    return {"rgb": images.to(device, torch.bfloat16), "text": ids.to(device)}


def highres_batch(
    batch_size: int, generator: torch.Generator, device: torch.device | str = "cuda"
) -> dict[str, torch.Tensor]:
    """:func:`synthetic_batch` at 448 px, the input of
    :func:`highres_training_task`."""
    return synthetic_batch(batch_size, generator, device, HIGHRES_IMAGE_SIZE)


def ragged_text_batch(
    batch_size: int, generator: torch.Generator, device: torch.device | str = "cuda"
) -> dict[str, torch.Tensor]:
    """Texts of ragged lengths with right padding, drawn from ``generator``
    (on its own device) and placed on ``device``: lengths in ``[2,
    TEXT_LENGTH]``, token ids in ``[1, vocab - 2]``, the end-of-text id
    ``vocab - 1`` at ``length - 1``, pad id 0 after it, and the matching 0/1
    ``int32`` ``text_attention_mask``."""
    g_dev = generator.device
    lens = torch.randint(2, TEXT_LENGTH + 1, (batch_size, 1), generator=generator,
                         device=g_dev)
    ids = torch.randint(1, VOCAB_SIZE - 1, (batch_size, TEXT_LENGTH), generator=generator,
                        device=g_dev)
    pos = torch.arange(TEXT_LENGTH, device=g_dev)[None]
    ids = torch.where(pos == lens - 1, VOCAB_SIZE - 1, ids)
    ids = torch.where(pos < lens, ids, 0)
    return {"text": ids.to(device, torch.int32),
            "text_attention_mask": (pos < lens).to(device, torch.int32)}


def ijepa_training_task(device: torch.device | str = "cuda", seed: int = 0) -> IJEPA:
    """``bench.py``'s I-JEPA ViT-B/16 task on ``device`` in train mode,
    weights drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    encoder = VisionTransformer(
        img_size=IMAGE_SIZE, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        dtype=torch.bfloat16, generator=g,
    )
    return IJEPA(
        encoder,
        optimizer=functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4),
        ema_decay=0.996, ema_anneal_end_step=100_000, generator=g,
    ).to(device).train()


def ijepa_batch(
    batch_size: int, generator: torch.Generator, device: torch.device | str = "cuda"
) -> dict[str, torch.Tensor]:
    """``bench.py``'s I-JEPA batch: standard-normal bf16 images drawn from
    ``generator`` (on its own device), with the masks ``IJEPA.prepare_batch``
    draws at step 0 under seed 0, prepared once (the task then leaves the
    batch as it is)."""
    images = torch.randn(batch_size, IMAGE_SIZE, IMAGE_SIZE, 3, generator=generator,
                         device=generator.device)
    masks = IJEPAMaskGenerator(input_size=IMAGE_SIZE, patch_size=16)(
        batch_size, rng=np.random.default_rng((0, 0, 0)))
    return {
        "rgb": images.to(device, torch.bfloat16),
        ENCODER_MASK_KEY: torch.from_numpy(masks["encoder_masks"]).to(device),
        PREDICTOR_MASK_KEY: torch.from_numpy(masks["predictor_masks"]).to(device),
    }


#: OpenCLIP's embedding width of ViT-H-14 and ViT-g-14 (both ``"embed_dim":
#: 1024``) and their shared text tower's configuration
LARGE_EMBED_DIM = 1024
LARGE_TEXT = dict(vocab_size=VOCAB_SIZE, max_length=TEXT_LENGTH, embed_dim=1024, depth=24,
                  num_heads=16, causal=True, pooling="eos", act_layer="gelu", norm_eps=1e-5,
                  proj_dim=LARGE_EMBED_DIM)


def _large_towers(preset, seed: int, patch_size: int = 14, remat: bool = False,
                  drop_path_rate: float = 0.0, image_depth=None, text_depth=None,
                  image_size: int = IMAGE_SIZE) -> dict[str, torch.nn.Module]:
    """A large preset's image tower (at 224 px unless ``image_size`` says
    otherwise) and the text tower of OpenCLIP's ViT-H-14 / ViT-g-14, weights
    drawn on the CPU from ``seed``; depths cut where given (the image
    tower's drop-path schedule spread over the blocks it keeps)."""
    g = torch.Generator().manual_seed(seed)
    depth = {} if image_depth is None else {"depth": image_depth}
    vision = preset(
        img_size=image_size, patch_size=patch_size, use_cls_token=True,
        learned_pos_embed=True, pre_norm=True, patch_embed_bias=False, act_layer="gelu",
        norm_eps=1e-5, global_pool="cls", proj_dim=LARGE_EMBED_DIM, remat=remat,
        drop_path_rate=drop_path_rate, dtype=torch.bfloat16, generator=g, **depth,
    )
    text_cfg = {**LARGE_TEXT, **({} if text_depth is None else {"depth": text_depth})}
    text = TextTransformer(**text_cfg, remat=remat, dtype=torch.bfloat16, generator=g)
    return {"rgb": vision, "text": text}


def vit_h14_training_task(
    device: torch.device | str = "cuda", seed: int = 0, remat: bool = True,
    drop_path_rate: float = 0.0, image_depth=None, text_depth=None,
    image_size: int = IMAGE_SIZE,
) -> ContrastivePretraining:
    """OpenCLIP ViT-H-14's pair (``vit_huge`` at 14-px patches and its text
    tower) as the contrastive task on ``device`` in train mode, both towers
    under activation checkpointing (``remat``, the ``dots_no_batch``
    policy), with the flagship's optimizer and schedule. ``image_depth`` and
    ``text_depth`` cut the towers (a CPU reference at full width);
    ``image_size=448`` gives 1,025 image tokens, past K1's limit at D=80, so
    the image attention takes K3."""
    towers = _large_towers(vit_huge, seed, remat=remat, drop_path_rate=drop_path_rate,
                           image_depth=image_depth, text_depth=text_depth,
                           image_size=image_size)
    return _training(towers).to(device).train()


def vit_g14_task(
    device: torch.device | str = "cuda", seed: int = 0, patch_size: int = 14,
    image_depth=None, text_depth=None,
) -> ContrastivePretraining:
    """OpenCLIP ViT-g-14's pair (``vit_giant`` at 14-px patches, 257 tokens,
    on K3; ``patch_size=16`` gives ViT-g/16, 197 tokens, on K1) on ``device``
    in eval mode, for serving; ``image_depth`` and ``text_depth`` cut the
    towers."""
    towers = _large_towers(vit_giant, seed, patch_size=patch_size, image_depth=image_depth,
                           text_depth=text_depth)
    return ContrastivePretraining(towers).to(device).eval()


def tiny_training_task(seed: int = 0, device: torch.device | str = "cpu") -> ContrastivePretraining:
    """The flagship pair at the JAX package's test widths (``_flagship_task
    (tiny=True)``): ViT of 2 blocks of width 64 (4 heads) on 32-px images in
    8-px patches with a CLS token, the text tower of 2 blocks of width 64 on
    16 tokens of a 64-word vocabulary, 32-d projections; AdamW with weight
    decay 0.01 and warmup-cosine from 1e-3 over 100 warmup steps; f32."""
    g = torch.Generator().manual_seed(seed)
    towers = {
        "rgb": VisionTransformer(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                                 use_cls_token=True, global_pool="cls", proj_dim=32,
                                 generator=g),
        "text": TextTransformer(vocab_size=64, max_length=16, embed_dim=64, depth=2,
                                num_heads=4, pooling="eos", proj_dim=32, generator=g),
    }
    return ContrastivePretraining(
        towers,
        optimizer=functools.partial(torch.optim.AdamW, weight_decay=0.01),
        lr_scheduler=functools.partial(linear_warmup_cosine_annealing_lr, base_lr=1e-3,
                                       warmup_steps=100),
    ).to(device)


def _dryrun_mesh(n: int) -> dict:
    """The dry run's mesh, the JAX ``_dryrun_multichip_impl``'s rule:
    ``fsdp=2, model=2`` where 4 divides ``n``, ``fsdp=2`` where ``n`` is
    even, else pure data."""
    if n % 4 == 0:
        return {"data": n // 4, "fsdp": 2, "model": 2}
    return {"data": n // 2, "fsdp": 2} if n % 2 == 0 else {"data": n}


def dryrun_step() -> float:
    """One sharded step of the tiny pair in a process group of n CPU
    processes (gloo) on :func:`_dryrun_mesh`: each batch shard (``data x
    fsdp``; the ranks of a ``model`` group read the same rows) loads its 2
    rows of the global batch through the distributed sampler. Returns the
    logged loss."""
    from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImageText
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
    from mmlearn_tpu_torch.datasets.core.samplers import CombinedDatasetRatioSampler
    from mmlearn_tpu_torch.parallel.mesh import set_global_mesh
    from mmlearn_tpu_torch.trainer import Trainer

    n = torch.distributed.get_world_size()
    losses: list[float] = []

    class Capture:
        def on_train_start(self, trainer): ...

        def on_train_batch_end(self, trainer, metrics, step):
            if "loss" in metrics:
                losses.append(float(metrics["loss"]))

        def on_train_epoch_end(self, trainer, epoch): ...

        def on_validation_end(self, trainer, metrics, step): ...

        def on_train_end(self, trainer): ...

    trainer = Trainer(max_steps=1, log_every_n_steps=1, mesh_shape=_dryrun_mesh(n),
                      callbacks=[Capture()], device="cpu")
    ds = CombinedDataset([SyntheticImageText(size=2 * n, image_size=32, seq_len=16,
                                             vocab_size=64, num_classes=4)])
    mesh = trainer.mesh
    loader = DataLoader(ds, batch_size=2, sampler=CombinedDatasetRatioSampler(
        ds, shuffle=True, seed=0, rank=mesh.dp_rank, num_replicas=mesh.dp_size),
        drop_last=True)
    trainer.fit(tiny_training_task(), loader)
    set_global_mesh(None)
    return losses[-1]


def _dryrun_worker() -> None:
    """One process of :func:`dryrun_multichip` (its rank and world from the
    environment): :func:`dryrun_step`; prints ``dryrun loss <value>``."""
    from mmlearn_tpu_torch.parallel.mesh import init_from_env

    init_from_env("cpu")
    loss = dryrun_step()
    torch.distributed.destroy_process_group()
    print(f"dryrun loss {loss!r}", flush=True)


def dryrun_multichip(n_devices: int, timeout: float = 600) -> float:
    """One sharded training step of the tiny pair over ``n_devices`` CPU
    processes on gloo (mesh :func:`_dryrun_mesh`), each in a fresh
    process. Raises if a process fails or the processes' losses differ;
    returns the loss."""
    import os
    import sys

    from mmlearn_tpu_torch.parallel.mp_launch import run_workers

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    code = "from mmlearn_tpu_torch.flagship import _dryrun_worker; _dryrun_worker()"
    outs = run_workers([[sys.executable, "-c", code]] * int(n_devices), env=env, cwd=root,
                       timeout=timeout)
    losses = {line.split()[-1] for out in outs for line in out.splitlines()
              if line.startswith("dryrun loss ")}
    if len(losses) != 1:
        raise RuntimeError(f"dryrun_multichip({n_devices}): the processes' losses {losses}")
    loss = float(losses.pop())
    print(f"dryrun_multichip: {n_devices} processes, mesh {_dryrun_mesh(int(n_devices))}, "
          f"loss {loss}")
    return loss
