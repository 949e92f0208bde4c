"""The port's LoRA and freezing against the JAX package's ``peft`` and the
contrastive task's ``_trainable_mask``.

- the merged weights against ``apply_lora`` (full factors on a ViT's qkv
  and proj, per-slice q/v factors on a BERT trunk), atol 1e-6 as the JAX
  package's own merge test, and the LoRA'd tower's forward against the JAX
  tower on the merged tree, atol 1e-5;
- the trainable sets of a task against ``_trainable_mask``, by parameter
  path, for the BIOSCAN recipe's LoRA configs and for ``freeze_encoders``
  specs, and ``freeze_layers_mask`` for every kind of spec;
- at init (``b = 0``) every ``a`` gradient exactly 0 and every ``b``
  gradient nonzero; LoRA gradients reach every block under remat (equal bit
  for bit to no remat) while the frozen embeddings get none; frozen weights
  unchanged by ``Trainer.fit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.datasets.core.modalities import Modalities as JModalities
from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.encoders.bert import BertTextEncoder as JBert
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu.peft import LoRAConfig as JLoRAConfig
from mmlearn_tpu.peft import apply_lora, init_lora_params
from mmlearn_tpu.peft import freeze_layers_mask as jax_freeze_layers_mask
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.peft import LoRAConfig, freeze_layers_mask, init_lora, merged_state_dict
from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT
from mmlearn_tpu_torch.projects.bioscan_clip import recipe
from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task, peft_configs
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from mmlearn_tpu_torch.trainer import Trainer
from projects.bioscan_clip.encoders import BarcodeBERT as JBarcodeBERT

if not JModalities.has_modality("dna"):
    JModalities.register_modality("dna")

VIT = dict(img_size=16, patch_size=8, embed_dim=32, depth=3, num_heads=4, use_cls_token=True,
           global_pool="cls", proj_dim=16)
BERT = dict(vocab_size=40, max_length=16, embed_dim=32, depth=2, num_heads=4, pooling="mean",
            use_pooler=False)
BARCODE = dict(vocab_size=19, projection_dim=16, embed_dim=32, depth=2, num_heads=4,
               max_length=16)
#: the tiny BIOSCAN towers of the port's recipe
TINY_BIOSCAN = dict(
    rgb=dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4, proj_dim=16),
    text=dict(vocab_size=40, max_length=16, embed_dim=32, depth=2, num_heads=4),
    dna=dict(vocab_size=19, projection_dim=16, embed_dim=32, depth=2, num_heads=4,
             max_length=16))


def t(x):
    return torch.from_numpy(np.asarray(x))


def bioscan_batch(seed: int = 0, b: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 12), np.int32)
    mask[1, 7:] = 0
    return {"rgb": rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
            "text": rng.integers(1, 40, (b, 12)).astype(np.int32), "text_attention_mask": mask,
            "dna": rng.integers(3, 19, (b, 10)).astype(np.int32)}


def _lora_case(kind: str):
    """A JAX tower's params, LoRA config and factors with ``b`` random, and
    the port tower with the same weights."""
    rng = np.random.default_rng(1)
    if kind == "vit_full":
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        jmod, mod = JVision(**VIT), VisionTransformer(**VIT)
        cfg = dict(r=4, lora_alpha=8.0)
    else:
        x = rng.integers(1, 40, (2, 12)).astype(np.int32)
        jmod, mod = JBert(**BERT), BertTextEncoder(**BERT)
        cfg = dict(r=4, lora_alpha=8.0, target_patterns=(r".*attn/qkv$",), qkv_slices=("q", "v"),
                   qkv_num_heads=4)
    params = jax.device_get(jmod.init(jax.random.key(0), x)["params"])
    jcfg = JLoRAConfig(**cfg)
    lora = init_lora_params(params, jcfg, jax.random.key(1))
    lora = jax.tree.map(lambda a: np.asarray(a), lora)
    for parent, entry in lora.items():
        for pair in ([entry] if "a" in entry else entry.values()):
            pair["b"] = rng.standard_normal(pair["b"].shape).astype(np.float32)
    mod.load_state_dict(bridge.jax_to_torch(params), strict=True)
    root = init_lora(mod, LoRAConfig(**cfg))
    root.load_state_dict(bridge.jax_to_torch(lora), strict=True)
    return jmod, params, jcfg, lora, mod, x


@pytest.mark.parametrize("kind", ["vit_full", "bert_slices"])
def test_merge_matches_apply_lora(kind):
    jmod, params, jcfg, lora, mod, x = _lora_case(kind)
    merged = jax.device_get(apply_lora(params, lora, jcfg))
    want = bridge.jax_to_torch(merged)
    got = merged_state_dict(mod)
    assert set(got) == set(want)
    changed = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-6, err_msg=name)
        changed += not torch.equal(value, mod.state_dict()[name])
    assert changed == (2 * VIT["depth"] if kind == "vit_full" else BERT["depth"])
    with torch.no_grad():
        out = mod(t(x))
    ref = jmod.apply({"params": merged}, x)
    np.testing.assert_allclose(out.pooler_output.numpy(), np.asarray(ref.pooler_output),
                               atol=1e-5)


def test_lora_config_validation():
    with pytest.raises(ValueError, match="qkv_num_heads"):
        LoRAConfig(qkv_slices=("q", "v"))
    with pytest.raises(ValueError, match="q/k/v"):
        LoRAConfig(qkv_slices=("query",), qkv_num_heads=4)


def _jax_mask(jtask, batch) -> dict:
    """The JAX task's ``_trainable_mask`` over its parameter tree (traced
    abstractly: the mask reads only the tree's paths)."""
    params = jax.eval_shape(jtask.init_params, jax.random.key(0), batch)
    return bridge.flatten(jtask._trainable_mask(params))


def _port_mask(task) -> dict:
    paths = bridge.jax_paths(task)
    return {paths[name]: p.requires_grad for name, p in task.named_parameters()}


def test_bioscan_trainable_set_matches_jax_mask():
    """The recipe's LoRA configs: the trainable parameters by name equal the
    JAX task's mask (the factors, the rgb and dna projections, the text
    head and the logit scale)."""
    batch = bioscan_batch()
    geo = {m: dict(g, depth=1) for m, g in TINY_BIOSCAN.items()}
    jtask = JTask(
        encoders={"rgb": JVision(**{**recipe.RGB, **geo["rgb"]}),
                  "text": JBert(**{**recipe.TEXT, **geo["text"]}),
                  "dna": JBarcodeBERT(**{**recipe.DNA, **geo["dna"]})},
        heads={"text": JMLP(out_dim=geo["dna"]["projection_dim"])},
        peft_configs={m: dict(vars(c)) for m, c in peft_configs(4, 4).items()},
    )
    task = bioscan_task(**geo, device="cpu")
    want, got = _jax_mask(jtask, batch), _port_mask(task)
    assert set(got) == set(want)
    assert {k for k, v in got.items() if v} == {k for k, v in want.items() if v}
    trainable = {k for k, v in got.items() if v}
    assert "encoders/rgb/proj/kernel" in trainable and "encoders/dna/decoder/bias" in trainable
    assert "lora/text/blocks_0/attn/qkv/v/b" in trainable
    assert "encoders/text/blocks_0/attn/qkv/kernel" not in trainable


@pytest.mark.parametrize("specs", [{"rgb": 1, "text": True}, {"rgb": [0, 2], "text": -1},
                                   {"rgb": 2 / 3, "text": False}])
def test_freeze_encoders_matches_jax_mask(specs):
    vision = dict(VIT)
    text = dict(vocab_size=32, max_length=8, embed_dim=32, depth=2, num_heads=4, causal=True,
                pooling="eos", proj_dim=16)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 30, (2, 8)).astype(np.int32)
    ids[:, -1] = 31
    batch = {"rgb": rng.standard_normal((2, 16, 16, 3)).astype(np.float32), "text": ids}
    jtask = JTask(encoders={"rgb": JVision(**vision), "text": JText(**text)},
                  freeze_encoders=specs)
    task = ContrastivePretraining({"rgb": VisionTransformer(**vision),
                                   "text": TextTransformer(**text)}, freeze_encoders=specs)
    want, got = _jax_mask(jtask, batch), _port_mask(task)
    assert got == {k: bool(v) for k, v in want.items()}


@pytest.mark.parametrize("spec", [True, False, None, 2, -1, 2 / 3, [0, 2]])
def test_freeze_layers_mask_matches_jax(spec):
    jmod = JVision(**VIT)
    params = jax.eval_shape(jmod.init, jax.random.key(0), jnp.ones((1, 16, 16, 3)))["params"]
    want = bridge.flatten(jax_freeze_layers_mask(params, spec))
    mod = VisionTransformer(**VIT)
    paths = bridge.jax_paths(mod)
    got = {paths[name]: v for name, v in freeze_layers_mask(mod, spec).items()}
    assert got == {k: bool(v) for k, v in want.items()}


def _lora_grads(remat: bool) -> tuple:
    task = bioscan_task(**TINY_BIOSCAN, remat=remat, device="cpu")
    loss, _ = task.loss_fn(bioscan_batch(1))
    loss.backward()
    return task, {n: p.grad for n, p in task.named_parameters()}


def test_lora_gradients_at_init_and_under_remat():
    task, grads = _lora_grads(remat=True)
    factors = {n: g for n, g in grads.items() if n.startswith("lora.")}
    # every qkv of the three towers: rgb one pair a block, text and dna q and v
    assert len(factors) == 2 * (2 + 2 * 2 + 2 * 2)
    for name, grad in factors.items():
        if name.endswith(".a"):
            assert torch.equal(grad, torch.zeros_like(grad)), name  # b = 0 at init
        else:
            assert bool(grad.any()), name
    for name, p in task.named_parameters():
        if "embed" in name or "norm" in name or "attn.qkv" in name:
            if not name.startswith("lora."):
                assert not p.requires_grad and p.grad is None, name
    _, plain = _lora_grads(remat=False)
    for name, grad in grads.items():
        assert (grad is None) == (plain[name] is None), name
        if grad is not None:
            assert torch.equal(grad, plain[name]), name


def test_fit_leaves_frozen_weights_unchanged():
    task = bioscan_task(**TINY_BIOSCAN, total_steps=3, device="cpu")
    before = {n: p.detach().clone() for n, p in task.named_parameters()}
    batches = [bioscan_batch(s) for s in range(3)]
    Trainer(max_steps=3, log_every_n_steps=1, device="cpu").fit(task, batches)
    for name, p in task.named_parameters():
        if p.requires_grad:
            assert not torch.equal(p.detach(), before[name]), name
        else:
            assert torch.equal(p.detach(), before[name]), name


def test_lora_merge_is_counted_in_the_step_flops():
    """The merge's product is a matmul of the step: the FLOP counter sees
    ``2 * in * r * out`` more a LoRA'd layer."""
    from torch.utils.flop_counter import FlopCounterMode

    counts = []
    for cfg in (None, LoRAConfig(r=4, target_patterns=(r".*attn/qkv$",))):
        mod = BarcodeBERT(**BARCODE, generator=torch.Generator().manual_seed(0))
        if cfg is not None:
            init_lora(mod, cfg)
        with FlopCounterMode(display=False) as fc:
            mod(torch.ones(2, 10, dtype=torch.long)).pooler_output.sum()
        counts.append(fc.get_total_flops())
    assert counts[1] - counts[0] == BARCODE["depth"] * 2 * 32 * 4 * 96


def test_lora_tower_artifacts_carry_the_merged_weights(tmp_path):
    """A LoRA'd tower with a live delta (``b`` random) written as a serving
    artifact and exported to timm keys: each, loaded into a plain tower,
    computes what the tower computes in the task."""
    from mmlearn_tpu_torch.hf_export import export_module
    from mmlearn_tpu_torch.hf_utils import convert_timm_vit
    from mmlearn_tpu_torch.serving import load_encoder, save_encoder

    cfg = dict(VIT, proj_bias=True, learned_pos_embed=True)  # the timm geometry
    task = ContrastivePretraining(
        {"rgb": VisionTransformer(**cfg)},
        peft_configs={"rgb": LoRAConfig(r=4, modules_to_save=(r"^proj",))},
        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in task.lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(len(name)))
    task.eval()
    imgs = np.random.default_rng(4).standard_normal((3, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        want = task.encode({"rgb": t(imgs)}, "rgb", normalize=True)
        tower = task.encoders["rgb"](t(imgs)).pooler_output
        base = VisionTransformer(**cfg)
        base.load_state_dict(task.encoders["rgb"].state_dict())
        assert not torch.allclose(base(t(imgs)).pooler_output, tower, atol=1e-3)

    save_encoder(str(tmp_path / "rgb"), task, "rgb", {"rgb": imgs})
    encode = load_encoder(str(tmp_path / "rgb"), device="cpu")
    assert torch.equal(encode({"rgb": t(imgs)}), want)

    plain = VisionTransformer(**cfg)
    plain.load_state_dict(convert_timm_vit(export_module(task.encoders["rgb"]),
                                           num_heads=VIT["num_heads"]), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(plain(t(imgs)).pooler_output.numpy(), tower.numpy(),
                                   atol=1e-6)
