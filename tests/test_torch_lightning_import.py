"""The port's Lightning-checkpoint importer, the counterparts of
``tests/test_lightning_import.py``, at its tolerances.

The fixtures were written by the reference's own task classes: a
contrastive checkpoint (HF CLIP towers as the reference's wrappers store
them, a bare-Linear head and a Sequential-MLP head, ``log_logit_scale``), an
I-JEPA checkpoint (encoder and predictor, ``ema_params``) and the
peft-wrapped BIOSCAN-CLIP init. Imported into the port's modules they must
give the recorded reference features (atol 2e-4, rtol 1e-3); each overlay
equals ``bridge.jax_to_torch`` of the JAX importer's, bit for bit; the
trainer loads ``init_overlay`` (every key checked) and re-copies the I-JEPA
teacher from the imported student; the EMA anneal continues from the
reference's ``num_updates``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mmlearn_tpu.lightning_import import import_lightning_checkpoint as jax_import
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.lightning_import import import_lightning_checkpoint, overlay_params
from mmlearn_tpu_torch.modules.encoders import (
    TextTransformer,
    VisionTransformer,
    VisionTransformerPredictor,
)
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.tasks import IJEPA, ContrastivePretraining
from mmlearn_tpu_torch.trainer import Trainer
from tests.tasks.test_bioscan_trajectory import BIOSCAN_TRAJ, INIT_CKPT
from tests.test_lightning_import import CLIP, CONTRASTIVE_CKPT, FIXDIR, IJEPA_CKPT
from tests.test_lightning_import import IJEPA as IJEPA_GEO

BIOSCAN_HEADS = {"rgb": BIOSCAN_TRAJ["vit_heads"], "text": BIOSCAN_TRAJ["txt_heads"],
                 "dna": BIOSCAN_TRAJ["dna_heads"]}


def clip_task() -> ContrastivePretraining:
    c = CLIP
    vision = VisionTransformer(
        img_size=c["img"], patch_size=c["patch"], embed_dim=c["hidden"], depth=c["depth"],
        num_heads=c["heads"], mlp_ratio=c["inter"] / c["hidden"], qkv_bias=True,
        use_cls_token=True, learned_pos_embed=True, pre_norm=True, final_norm=True,
        act_layer="quick_gelu", norm_eps=1e-5, global_pool="cls", patch_embed_bias=False)
    text = TextTransformer(
        vocab_size=c["vocab"], max_length=c["max_pos"], embed_dim=c["hidden"],
        depth=c["depth"], num_heads=c["heads"], mlp_ratio=c["inter"] / c["hidden"],
        qkv_bias=True, causal=True, act_layer="quick_gelu", norm_eps=1e-5, pooling="eos")
    heads = {"rgb": MLP(c["hidden"], out_dim=c["head_out"]),
             "text": MLP(c["hidden"], out_dim=c["head_out"], hidden_dims=[c["head_hidden"]],
                         norm_layer="layernorm", activation="gelu")}
    return ContrastivePretraining({"rgb": vision, "text": text}, heads=heads)


def ijepa_encoder() -> VisionTransformer:
    c = IJEPA_GEO
    return VisionTransformer(img_size=c["img"], patch_size=c["patch"], embed_dim=c["embed_dim"],
                             depth=c["depth"], num_heads=c["num_heads"], use_cls_token=False,
                             learned_pos_embed=False, final_norm=True, norm_eps=1e-5,
                             global_pool="none")


@pytest.fixture(scope="module")
def contrastive_import():
    return import_lightning_checkpoint(CONTRASTIVE_CKPT, num_heads=4)


def test_meta_and_layout(contrastive_import):
    overlay, meta = contrastive_import
    assert meta == {"global_step": 120, "epoch": 3}
    assert {k.split(".")[1] for k in overlay if k.startswith("encoders.")} == {"rgb", "text"}
    assert {k for k in overlay if k.startswith("heads.rgb.")} == {"heads.rgb.fc1.weight",
                                                                 "heads.rgb.fc1.bias"}
    assert {k.split(".")[2] for k in overlay if k.startswith("heads.text.")} == {
        "fc1", "fc2", "norm1"}
    assert float(overlay["log_logit_scale"]) == pytest.approx(np.log(1 / 0.07), rel=1e-5)


@pytest.mark.parametrize("ckpt,heads", [(CONTRASTIVE_CKPT, 4), (IJEPA_CKPT, 4),
                                        (INIT_CKPT, BIOSCAN_HEADS)])
def test_overlay_equals_bridge_of_the_jax_import(ckpt, heads):
    overlay, meta = import_lightning_checkpoint(ckpt, num_heads=heads)
    jover, jmeta = jax_import(ckpt, num_heads=heads)
    want = bridge.jax_to_torch(jax.device_get(jover))
    assert meta == jmeta and set(overlay) == set(want)
    for k, v in want.items():
        assert torch.equal(overlay[k], v), k


def test_contrastive_features_match_reference(contrastive_import):
    overlay, _ = contrastive_import
    expect = np.load(os.path.join(FIXDIR, "reference_lightning_contrastive_expect.npz"))
    task = overlay_params(clip_task(), overlay)
    batch = {"rgb": torch.from_numpy(expect["imgs"].transpose(0, 2, 3, 1).copy()),
             "text": torch.from_numpy(expect["ids"].astype(np.int64))}
    with torch.no_grad():
        out = task.forward(batch)
    np.testing.assert_allclose(out["rgb_embedding"].numpy(), expect["rgb_embedding"], atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out["text_embedding"].numpy(), expect["text_embedding"],
                               atol=2e-4, rtol=1e-3)


def test_trainer_applies_init_overlay(contrastive_import, tmp_path):
    """``Trainer.fit`` loads ``task.init_overlay`` before it builds the
    optimizer: with training off the weights are the overlay's exactly."""
    overlay, _ = contrastive_import
    task = clip_task()
    task.init_overlay = overlay
    batch = {"rgb": np.zeros((2, 32, 32, 3), np.float32), "text": np.ones((2, 12), np.int32)}
    Trainer(max_steps=1, limit_train_batches=0, device="cpu",
            default_root_dir=str(tmp_path)).fit(task, [batch])
    state = task.state_dict()
    for k, v in overlay.items():
        assert torch.equal(state[k], v), k


def test_overlay_checks_keys_and_shapes(contrastive_import):
    overlay, _ = contrastive_import
    with pytest.raises(ValueError, match="not in the target"):
        overlay_params(clip_task(), {**overlay, "encoders.rgb.nope": torch.zeros(1)})
    bad = dict(overlay)
    bad["encoders.rgb.pos_embed"] = torch.zeros(1, 3, 32)
    task = clip_task()
    before = {k: v.clone() for k, v in task.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        overlay_params(task, bad)
    # nothing was written: the checks come before the first copy
    for k, v in task.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_ijepa_import_matches_reference_and_copies_the_teacher(tmp_path):
    overlay, meta = import_lightning_checkpoint(IJEPA_CKPT, num_heads=4)
    assert meta["ema"] == {"decay": 0.9971, "num_updates": 77}
    assert {k.split(".")[0] for k in overlay} == {"encoder", "predictor"}
    expect = np.load(os.path.join(FIXDIR, "reference_lightning_ijepa_expect.npz"))
    enc = ijepa_encoder()
    enc.load_state_dict({k[len("encoder."):]: v for k, v in overlay.items()
                         if k.startswith("encoder.")}, strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(expect["imgs"].transpose(0, 2, 3, 1).copy())).last_hidden_state
    np.testing.assert_allclose(out.numpy(), expect["encoder_out"], atol=2e-4, rtol=1e-3)

    # the reference persists no teacher: the trainer's init_extras copies it
    c = IJEPA_GEO
    task = IJEPA(ijepa_encoder(), predictor=None)
    pred_dim = overlay["predictor.predictor_embed.weight"].shape[0]
    task.predictor = VisionTransformerPredictor(
        num_patches=(c["img"] // c["patch"]) ** 2, embed_dim=c["embed_dim"],
        predictor_embed_dim=pred_dim, depth=1, num_heads=c["num_heads"])
    task.init_overlay = overlay
    batch = {"rgb": np.zeros((2, c["img"], c["img"], 3), np.float32)}
    Trainer(max_steps=1, limit_train_batches=0, device="cpu",
            default_root_dir=str(tmp_path)).fit(task, [batch])
    for name, p in task.teacher.named_parameters():
        assert torch.equal(p, overlay[f"encoder.{name}"]), name


def test_ijepa_import_continues_ema_anneal():
    """``apply_import_metadata`` shifts the EMA anneal by the reference's
    ``num_updates``: at trainer step 0 the decay is the one annealed to 77
    updates (0.9 + 0.77 * 0.1 = 0.977)."""
    _, meta = import_lightning_checkpoint(IJEPA_CKPT, num_heads=4)
    task = IJEPA(ijepa_encoder(), ema_decay=0.9, ema_decay_end=1.0, ema_anneal_end_step=100)
    task.apply_import_metadata(meta)
    assert task.ema_step_offset == 77
    with torch.no_grad():
        for p in task.teacher.parameters():
            p.fill_(1.0)
        for p in task.encoder.parameters():
            p.zero_()
    task.post_update(0)
    for p in task.teacher.parameters():
        np.testing.assert_allclose(p.numpy(), 0.977, atol=1e-6)
