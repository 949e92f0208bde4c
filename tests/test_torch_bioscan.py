"""The BIOSCAN-CLIP trimodal recipe in the port, against the reference and
the JAX package.

- the 20-step trimodal gate of ``tests/tasks/test_bioscan_trajectory.py``:
  the recipe's task (``projects.bioscan_clip.recipe.bioscan_task``, at the
  fixture's geometry: the JAX test composes the YAML, which the port cannot
  yet) from the recorded peft-wrapped init through the port's importer and
  ``Trainer.fit``; losses, learning rates, logit scales, probe and eval-split
  embeddings and the taxonomic accuracies at that test's tolerances;
- the 30-step CLIP tower gate of ``tests/tasks/test_training_trajectory.py``
  (:568-665), through the importer, at its tolerances;
- the one-cycle schedule against torch's ``OneCycleLR`` and the JAX
  ``onecycle_lr``;
- 3 steps of a tiny BIOSCAN task in the port's ``Trainer`` against the JAX
  ``Trainer`` from one JAX init (loss rtol 1e-5 at the first step and 3e-4
  over all, weights atol 2e-5, as the port's other trainer comparisons);
- ``TaxonomicClassification`` through ``Trainer.validate`` against the
  project's scoring functions on the same embeddings.
"""

import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.datasets.core.modalities import Modalities as JModalities
from mmlearn_tpu.modules.encoders.bert import BertTextEncoder as JBert
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu.modules.lr_schedulers.onecycle import onecycle_lr as jax_onecycle
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.trainer import Trainer as JTrainer
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.lightning_import import import_lightning_checkpoint
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.modules.lr_schedulers import (
    linear_warmup_cosine_annealing_lr,
    onecycle_lr,
)
from mmlearn_tpu_torch.projects.bioscan_clip import recipe
from mmlearn_tpu_torch.projects.bioscan_clip.eval_task import (
    TaxonomicClassification,
    knn_predict,
    top_k_macro_accuracy,
    top_k_micro_accuracy,
)
from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task
from mmlearn_tpu_torch.tasks import ContrastivePretraining, EvaluationSpec
from mmlearn_tpu_torch.trainer import LearningRateMonitor, Trainer
from projects.bioscan_clip import eval_task as jax_eval
from projects.bioscan_clip.encoders import BarcodeBERT as JBarcodeBERT
from tests.tasks.test_bioscan_trajectory import (
    BIOSCAN_TRAJ,
    FIXTURE,
    INIT_CKPT,
    Recorder,
    make_bioscan_eval_data,
    make_bioscan_trajectory_data,
)
from tests.tasks.test_training_trajectory import (
    CLIP_FIXTURE,
    CLIP_INIT_CKPT,
    CLIP_TRAJ,
    make_clip_trajectory_data,
)

if not JModalities.has_modality("dna"):
    JModalities.register_modality("dna")


def fixture_task() -> ContrastivePretraining:
    """The recipe at the trajectory fixture's geometry."""
    c = BIOSCAN_TRAJ
    return bioscan_task(
        rgb=dict(img_size=c["img"], patch_size=c["patch"], embed_dim=c["vit_dim"],
                 depth=c["vit_depth"], num_heads=c["vit_heads"], mlp_ratio=c["vit_mlp"],
                 proj_dim=c["emb"]),
        text=dict(vocab_size=c["txt_vocab"], max_length=c["txt_max_pos"], embed_dim=c["txt_dim"],
                  depth=c["txt_depth"], num_heads=c["txt_heads"]),
        dna=dict(vocab_size=c["dna_vocab"], projection_dim=c["emb"], embed_dim=c["dna_dim"],
                 depth=c["dna_depth"], num_heads=c["dna_heads"], max_length=c["dna_max_pos"]),
        total_steps=c["steps"], device="cpu")


def _forward(task, rgb, txt, dna) -> dict:
    task.eval()
    with torch.no_grad():
        out = task.forward({"rgb": torch.from_numpy(np.transpose(rgb, (0, 2, 3, 1)).copy()),
                            "text": torch.from_numpy(txt.astype(np.int32)),
                            "dna": torch.from_numpy(dna.astype(np.int32))})
    return {m: out[f"{m}_embedding"].numpy() for m in ("rgb", "text", "dna")}


def _l2(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_bioscan_trimodal_trajectory_matches_reference(tmp_path):
    c = BIOSCAN_TRAJ
    fx = np.load(FIXTURE)
    imgs, txt, dna, ex_ids = make_bioscan_trajectory_data()
    task = fixture_task()
    overlay, _ = import_lightning_checkpoint(
        INIT_CKPT, num_heads={"rgb": c["vit_heads"], "text": c["txt_heads"],
                              "dna": c["dna_heads"]})
    # the overlay fills every weight of the task, the LoRA factors included
    assert set(overlay) == set(task.state_dict())
    assert "lora.text.blocks.0.attn.qkv.q.a" in overlay and "lora.rgb.blocks.0.attn.qkv.a" in overlay
    task.init_overlay = overlay
    batches = [{"rgb": np.transpose(imgs[i], (0, 2, 3, 1)), "text": txt[i].astype(np.int32),
                "dna": dna[i].astype(np.int32),
                "example_ids": {m: ex_ids for m in ("rgb", "text", "dna")}}
               for i in range(c["n_batches"])]
    rec = Recorder()
    trainer = Trainer(max_steps=c["steps"], log_every_n_steps=1,
                      callbacks=[LearningRateMonitor(), rec], default_root_dir=str(tmp_path),
                      device="cpu")
    assert trainer.fit(task, batches).step == c["steps"]
    got = np.asarray(rec.losses)
    np.testing.assert_allclose(got[0], fx["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got[:10], fx["losses"][:10], rtol=3e-4)
    np.testing.assert_allclose(got, fx["losses"], rtol=5e-3)
    np.testing.assert_allclose(rec.lrs, fx["lrs"], rtol=1e-5)
    np.testing.assert_allclose(rec.scales, np.exp(fx["log_scales"]), rtol=5e-3)

    probe = _forward(task, imgs[0, :8], txt[0, :8], dna[0, :8])
    for m in ("rgb", "text", "dna"):
        np.testing.assert_allclose(probe[m], fx[f"final_{m}"], atol=2e-3)

    # taxonomic classification: embeddings of the eval splits, then the
    # reference's accuracies from the port's kNN and scoring
    emb, ref_emb = {}, {}
    for split, data in make_bioscan_eval_data().items():
        store = _forward(task, data["rgb"], data["text"], data["dna"])
        for m in ("rgb", "text", "dna"):
            np.testing.assert_allclose(store[m], fx[f"eval_{split}_{m}"], atol=2e-3)
        ref = {m: fx[f"eval_{split}_{m}"] for m in ("rgb", "dna", "text")}
        for s in (store, ref):
            s["averaged"] = (s["rgb"] + s["dna"]) / 2.0
            s["concatenated"] = np.concatenate([s["rgb"], s["dna"]], axis=1)
        store["labels"] = data["labels"]
        emb[split], ref_emb[split] = store, ref
    for s in (emb, ref_emb):
        s["all_keys"]["all_key"] = np.concatenate([s["all_keys"][m] for m in ("rgb", "dna", "text")])
    emb["all_keys"]["all_key_labels"] = emb["all_keys"]["labels"] * 3
    ref_acc = json.loads(str(fx["acc_json"]))
    combos = [("rgb", "dna", "rgb_embedding", "dna_embedding"),
              ("averaged", "averaged", "averaged_embedding", "averaged_embedding"),
              ("concatenated", "concatenated", "concatenated_embedding",
               "concatenated_embedding"),
              ("rgb", "all_key", "rgb_embedding", "all_key_embedding")]
    for split, ref_split in (("val_seen", "seen"), ("val_unseen", "unseen")):
        for q_type, k_type, ref_q, ref_k in combos:
            keys = emb["all_keys"][k_type]
            labels = emb["all_keys"]["all_key_labels" if k_type == "all_key" else "labels"]
            ref_sims = _l2(ref_emb[split][q_type]) @ _l2(ref_emb["all_keys"][k_type]).T
            top2 = np.sort(ref_sims, axis=1)[:, -2:]
            margin = (top2[:, 1] - top2[:, 0]).min()
            sim_err = np.abs(_l2(emb[split][q_type]) @ _l2(keys).T - ref_sims).max()
            assert sim_err < margin / 4, (split, q_type, k_type, sim_err, margin)
            preds = knn_predict(emb[split][q_type], keys, labels, max_k=1)
            micro = top_k_micro_accuracy(preds, emb[split]["labels"], [1])
            macro, _ = top_k_macro_accuracy(preds, emb[split]["labels"], [1])
            ref_entry = ref_acc[ref_q][ref_k][ref_split]
            for level in ("order", "family", "genus", "species"):
                assert micro[1][level] == pytest.approx(ref_entry["micro_acc"]["1"][level])
                assert macro[1][level] == pytest.approx(ref_entry["macro_acc"]["1"][level])


def test_clip_tower_trajectory_matches_reference(tmp_path):
    c = CLIP_TRAJ
    fx = np.load(CLIP_FIXTURE)
    imgs, ids, probe_imgs, probe_ids, ex_ids = make_clip_trajectory_data()
    overlay, _ = import_lightning_checkpoint(CLIP_INIT_CKPT, num_heads=c["heads"])
    vision = VisionTransformer(
        img_size=c["img"], patch_size=c["patch"], embed_dim=c["hidden"], depth=c["depth"],
        num_heads=c["heads"], mlp_ratio=c["inter"] / c["hidden"], qkv_bias=True,
        use_cls_token=True, learned_pos_embed=True, pre_norm=True, final_norm=True,
        act_layer="quick_gelu", norm_eps=1e-5, global_pool="cls", patch_embed_bias=False)
    text = TextTransformer(
        vocab_size=c["vocab"], max_length=c["max_pos"], embed_dim=c["hidden"], depth=c["depth"],
        num_heads=c["heads"], mlp_ratio=c["inter"] / c["hidden"], qkv_bias=True, causal=True,
        act_layer="quick_gelu", norm_eps=1e-5, pooling="eos")
    task = ContrastivePretraining(
        {"rgb": vision, "text": text},
        heads={m: MLP(c["hidden"], out_dim=c["head_out"]) for m in ("rgb", "text")},
        optimizer=functools.partial(torch.optim.AdamW, betas=c["betas"], eps=c["eps"],
                                    weight_decay=c["weight_decay"]),
        lr_scheduler=functools.partial(
            linear_warmup_cosine_annealing_lr, base_lr=c["lr"], warmup_steps=c["warmup_steps"],
            max_steps=c["steps"], start_factor=c["start_factor"], eta_min=c["eta_min"]))
    task.init_overlay = overlay
    batches = [{"rgb": np.transpose(imgs[i], (0, 2, 3, 1)), "text": ids[i].astype(np.int32),
                "example_ids": {"rgb": ex_ids, "text": ex_ids}} for i in range(c["n_batches"])]
    rec = Recorder()
    Trainer(max_steps=c["steps"], log_every_n_steps=1, callbacks=[LearningRateMonitor(), rec],
            default_root_dir=str(tmp_path), device="cpu").fit(task, batches)
    got = np.asarray(rec.losses)
    assert len(got) == c["steps"]
    np.testing.assert_allclose(got[0], fx["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got[:10], fx["losses"][:10], rtol=3e-4)
    np.testing.assert_allclose(got, fx["losses"], rtol=5e-3)
    np.testing.assert_allclose(rec.lrs, fx["lrs"], rtol=1e-4)
    np.testing.assert_allclose(rec.scales, np.exp(fx["log_scales"]), rtol=5e-3)
    task.eval()
    with torch.no_grad():
        out = task.forward({"rgb": torch.from_numpy(np.transpose(probe_imgs, (0, 2, 3, 1)).copy()),
                            "text": torch.from_numpy(probe_ids.astype(np.int32))})
    np.testing.assert_allclose(out["rgb_embedding"].numpy(), fx["final_rgb"], atol=2e-3)
    np.testing.assert_allclose(out["text_embedding"].numpy(), fx["final_text"], atol=2e-3)


@pytest.mark.parametrize("kw", [
    dict(max_lr=1e-3, total_steps=20, pct_start=0.3),
    dict(max_lr=1e-3, total_steps=20264, pct_start=0.3),
    dict(max_lr=0.5, total_steps=37, pct_start=0.25, div_factor=10.0, final_div_factor=100.0)])
def test_onecycle_matches_torch_and_jax(kw):
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=kw["max_lr"])
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=kw["max_lr"], total_steps=kw["total_steps"], pct_start=kw["pct_start"],
        anneal_strategy="cos", **{k: v for k, v in kw.items()
                                  if k in ("div_factor", "final_div_factor")})
    steps = sorted({*range(min(kw["total_steps"], 60)), kw["total_steps"] // 2,
                    kw["total_steps"] - 1})
    torch_lrs = []
    for s in range(max(steps) + 1):
        torch_lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        if s < kw["total_steps"] - 1:
            sched.step()
    ours, theirs = onecycle_lr(**kw), jax_onecycle(**kw)
    for s in steps:
        assert ours(s) == pytest.approx(torch_lrs[s], rel=1e-12, abs=0), s
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-5)


TINY = dict(
    rgb=dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=4, proj_dim=16),
    text=dict(vocab_size=40, max_length=16, embed_dim=32, depth=1, num_heads=4),
    dna=dict(vocab_size=19, projection_dim=16, embed_dim=32, depth=1, num_heads=4,
             max_length=16))


def tiny_batches(n: int = 3, b: int = 6) -> list[dict]:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        mask = np.ones((b, 12), np.int32)
        for i, keep in enumerate(rng.integers(5, 13, b)):
            mask[i, keep:] = 0
        out.append({"rgb": rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
                    "text": rng.integers(1, 40, (b, 12)).astype(np.int32),
                    "text_attention_mask": mask,
                    "dna": rng.integers(3, 19, (b, 10)).astype(np.int32)})
    return out


def test_tiny_bioscan_steps_match_the_jax_trainer(tmp_path):
    """The recipe's task, 3 steps of LoRA on three towers and the one-cycle
    schedule, from one JAX init in both trainers."""
    batches = tiny_batches()
    jtask = JTask(
        encoders={"rgb": JVision(**{**recipe.RGB, **TINY["rgb"]}),
                  "text": JBert(**{**recipe.TEXT, **TINY["text"]}),
                  "dna": JBarcodeBERT(**{**recipe.DNA, **TINY["dna"]})},
        heads={"text": JMLP(out_dim=16)},
        modality_loss_pairs=[{"modalities": p, "weight": 1.0} for p in recipe.LOSS_PAIRS],
        optimizer=functools.partial(optax.adamw, eps=1e-6, weight_decay=0.01),
        lr_scheduler=functools.partial(jax_onecycle, max_lr=1e-3, total_steps=3, pct_start=0.3),
        peft_configs={m: dict(vars(c)) for m, c in recipe.peft_configs(4, 4).items()})
    params = jax.device_get(jtask.init_params(jax.random.key(0), batches[0]))
    jtask.init_overlay = params
    jrec = Recorder()
    jstate = JTrainer(max_steps=3, log_every_n_steps=1, callbacks=[jrec], mesh_shape={"data": 1},
                      default_root_dir=str(tmp_path / "jax"), seed=0).fit(jtask, batches)

    task = bioscan_task(**TINY, total_steps=3, device="cpu")
    task.load_state_dict(bridge.jax_to_torch(params), strict=True)
    rec = Recorder()
    Trainer(max_steps=3, log_every_n_steps=1, callbacks=[rec], device="cpu",
            default_root_dir=str(tmp_path / "port")).fit(task, batches)
    np.testing.assert_allclose(rec.losses[0], jrec.losses[0], rtol=1e-5)
    np.testing.assert_allclose(rec.losses, jrec.losses, rtol=3e-4)
    want = bridge.jax_to_torch(jax.device_get(jstate.params))
    for name, value in task.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


class SplitLoader:
    """Eval batches with ``split`` names and taxonomy ``labels``."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def test_taxonomic_classification_matches_the_project_scoring(tmp_path):
    task = bioscan_task(**TINY, device="cpu")
    hook = TaxonomicClassification(top_k=(1, 3), report_combos=(
        ("rgb", "dna"), ("averaged", "averaged"), ("concatenated", "concatenated"),
        ("rgb", "all_key")))
    task.evaluation_tasks = {"taxonomic": EvaluationSpec(hook)}
    rng = np.random.default_rng(3)
    batches, store = [], {}
    for split, n in (("all_keys", 12), ("val_seen", 6), ("val_unseen", 6), ("all_keys", 6)):
        b = tiny_batches(1, n)[0]
        b["split"] = [split] * n
        b["labels"] = [{lv: f"{lv}{int(rng.integers(0, 3))}" for lv in
                        ("order", "family", "genus", "species")} for _ in range(n)]
        batches.append(b)
    results = Trainer(device="cpu", default_root_dir=str(tmp_path)).validate(
        task, SplitLoader(batches))
    assert len(results) == 2 * 4 * 2 * 2 * 4 + 1  # splits, combos, k, micro/macro, levels; loss
    # the same scoring by the project's own functions, on the port's embeddings
    task.eval()
    for b in batches:
        with torch.no_grad():
            emb = {m: torch.nn.functional.normalize(
                task.encode({k: torch.as_tensor(v) for k, v in b.items()
                             if k not in ("split", "labels")}, m).float(), dim=-1).numpy()
                for m in ("rgb", "dna", "text")}
        s = store.setdefault(b["split"][0], {"labels": []})
        for m, v in emb.items():
            s.setdefault(m, []).append(v)
        s["labels"] += b["labels"]
    cat = {split: {k: (np.concatenate(v) if k != "labels" else v) for k, v in s.items()}
           for split, s in store.items()}
    for s in cat.values():
        s["averaged"] = (s["rgb"] + s["dna"]) / 2.0
        s["concatenated"] = np.concatenate([s["rgb"], s["dna"]], axis=1)
    keys = cat["all_keys"]
    keys["all_key"] = np.concatenate([np.concatenate([keys[m][i:j] for m in ("rgb", "dna", "text")])
                                      for i, j in ((0, 12), (12, 18))])
    keys["all_key_labels"] = keys["labels"][:12] * 3 + keys["labels"][12:] * 3
    for split in ("val_seen", "val_unseen"):
        for q, k in hook.report_combos:
            labels = keys["all_key_labels" if k == "all_key" else "labels"]
            preds = jax_eval.knn_predict(cat[split][q], keys[k], labels, max_k=3)
            micro = jax_eval.top_k_micro_accuracy(preds, cat[split]["labels"], [1, 3])
            macro, _ = jax_eval.top_k_macro_accuracy(preds, cat[split]["labels"], [1, 3])
            for topk in (1, 3):
                for level in ("order", "family", "genus", "species"):
                    name = f"{split}_{q}_2_{k}_top_{topk}"
                    assert results[f"{name}_micro_{level}"] == pytest.approx(micro[topk][level])
                    assert results[f"{name}_macro_{level}"] == pytest.approx(macro[topk][level])
