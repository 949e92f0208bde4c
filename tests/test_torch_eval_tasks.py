"""The port's evaluation layer against the JAX package's, on the CPU.

Tiny towers (width 32, depth 2) with the JAX weights carried across by
``bridge.py``; one eval ``CombinedDataset`` of a 4-class and a 2-class set
(the binary path), batch 16 with the last batch padded. The JAX
``Trainer.validate`` and the port's run the same three hooks: zero-shot
retrieval (rgb->text at k 1 and 5, text->rgb at 5), zero-shot
classification (top-1 and top-2) with ragged class prompts, and embedding
export (f32 and f16). Both compute in f32 in two packages, so embeddings
agree to ``EMB_ATOL``; recall and accuracy are exact once the scores that
decide each hit stand further apart than 100x that, which the test checks.
"""

import functools
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.datasets.core import CombinedDataset as JCombined
from mmlearn_tpu.datasets.core import DataLoader as JLoader
from mmlearn_tpu.datasets.core.example import Example as JExample
from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu import tasks as jtasks
from mmlearn_tpu.trainer import Trainer as JTrainer
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch import tasks
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader, Example
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.serving import EmbeddingIndex
from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer
from tests.test_torch_trainer_fit import port_task

VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
              use_cls_token=True, global_pool="cls", proj_dim=16)
TEXT = dict(vocab_size=32, max_length=8, embed_dim=32, depth=2, num_heads=4,
            causal=True, pooling="eos", proj_dim=16)
EOS = 31  # end of text: the row maximum, for EOS pooling
#: embeddings and class embeddings, JAX against the port (f32 in both;
#: reads 5.1e-7)
EMB_ATOL = 1e-6
#: AUROC from scores that agree to EMB_ATOL
AUROC_ATOL = 1e-6
#: the losses, the port's limit against the JAX trainer
LOSS_RTOL = 1e-5


class EvalPairs:
    """Image-text pairs of ``len(names)`` classes, as ``Example``s of
    ``example_cls``: image pattern k plus noise of the index, tokens of
    class k with two of the index; with ``id2label`` and prompt
    templates."""

    def __init__(self, example_cls, names, templates, size, seed):
        rng = np.random.default_rng(seed)
        self.example_cls, self.size, self.seed = example_cls, size, seed
        self.id2label = {i: name for i, name in enumerate(names)}
        self.zero_shot_prompt_templates = templates
        self.labels = rng.integers(0, len(names), size)
        self.patterns = rng.standard_normal((len(names), 16, 16, 3)).astype(np.float32)

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        k = int(self.labels[idx])
        noise = np.random.default_rng((self.seed, idx)).standard_normal((16, 16, 3))
        ids = np.full((8,), k + 2, dtype=np.int32)
        # two tokens of the index and the seed: no two texts alike
        ids[0], ids[3], ids[4], ids[-1] = 1, 10 + idx % 20, 10 + (idx // 20 + self.seed) % 20, EOS
        return self.example_cls({"rgb": self.patterns[k] + 0.3 * noise.astype(np.float32),
                                 "rgb_target": k, "text": ids,
                                 "text_attention_mask": np.ones(8, np.int32),
                                 EXAMPLE_INDEX_KEY: idx})


def eval_datasets(example_cls):
    return [EvalPairs(example_cls, ["zero", "one", "two", "three"],
                      ["a photo of {}.", "an image of {}."], size=24, seed=0),
            EvalPairs(example_cls, ["no", "yes"], ["an x-ray of {}."], size=16, seed=5)]


class RaggedTokenizer:
    """Prompts to token ids: the class's token, right-padded at a length
    that depends on the prompt, with the matching attention mask."""

    def __init__(self, labels):
        self.vocab = {label: i + 2 for i, label in enumerate(labels)}

    def __call__(self, prompts):
        ids = np.zeros((len(prompts), 8), np.int32)
        mask = np.zeros((len(prompts), 8), np.int32)
        for i, p in enumerate(prompts):
            length = 4 + len(p) % 5
            tok = next(t for label, t in self.vocab.items() if f" {label}." in p)
            ids[i, :length] = tok
            ids[i, 0], ids[i, length - 1] = 1, EOS
            mask[i, :length] = 1
        return {"text": ids, "text_attention_mask": mask}


def hooks(pkg, out_dir):
    """The three hooks of ``pkg`` (the JAX or the port's ``tasks``); two
    exports, f32 and f16."""
    return {
        "retrieval": pkg.EvaluationSpec(task=pkg.ZeroShotCrossModalRetrieval(
            [pkg.RetrievalTaskSpec("rgb", "text", top_k=[1, 5]),
             pkg.RetrievalTaskSpec("text", "rgb", top_k=[5])])),
        "classification": pkg.EvaluationSpec(task=pkg.ZeroShotClassification(
            [pkg.ClassificationTaskSpec("rgb", top_k=[1, 2])],
            tokenizer=RaggedTokenizer(["zero", "one", "two", "three", "no", "yes"]),
            batch_size=3)),
        "export": pkg.EvaluationSpec(task=pkg.EmbeddingExport(
            os.path.join(out_dir, "f32"), modalities=["rgb", "text"], shard_size=16)),
        "export16": pkg.EvaluationSpec(task=pkg.EmbeddingExport(
            os.path.join(out_dir, "f16"), modalities=["rgb"], shard_size=32,
            dtype="float16"), run_on_test=False),
    }


@pytest.fixture(scope="module")
def validated(tmp_path_factory):
    """``Trainer.validate`` of the JAX package and of the port on the same
    weights and data: (JAX results, port results, JAX dir, port dir, JAX
    class embeddings, port class embeddings)."""
    root = tmp_path_factory.mktemp("eval")
    jdir, pdir = str(root / "jax"), str(root / "port")
    jtask = jtasks.ContrastivePretraining(
        encoders={"rgb": JVision(**VISION), "text": JText(**TEXT)},
        optimizer=functools.partial(optax.adamw, learning_rate=1e-3),
        evaluation_tasks=hooks(jtasks, jdir))
    jloader = JLoader(JCombined(eval_datasets(JExample)), batch_size=16,
                      pad_partial_batches=True)
    jtrainer = JTrainer(seed=0, mesh_shape={"data": 1}, default_root_dir=str(root))
    jstate = jtrainer.prepare_eval_state(jtask, jloader)
    jclass = {}
    jzs = jtask.evaluation_tasks["classification"].task
    end = jzs.on_evaluation_epoch_end

    def keep_jax(runtime):
        jclass.update({k: np.asarray(v) for k, v in jzs._class_embeddings.items()})
        return end(runtime)

    jzs.on_evaluation_epoch_end = keep_jax
    want = jtrainer.validate(jtask, jloader, state=jstate)

    task = tasks.ContrastivePretraining(
        {"rgb": VisionTransformer(**VISION), "text": TextTransformer(**TEXT)},
        evaluation_tasks=hooks(tasks, pdir))
    task.load_state_dict(bridge.jax_to_torch(jax.device_get(jstate.params)), strict=True)
    pclass = {}
    zs = task.evaluation_tasks["classification"].task
    pend = zs.on_evaluation_epoch_end

    def keep_port(runtime):
        pclass.update({k: v.numpy() for k, v in zs._class_embeddings.items()})
        return pend(runtime)

    zs.on_evaluation_epoch_end = keep_port
    loader = DataLoader(CombinedDataset(eval_datasets(Example)), batch_size=16,
                        pad_partial_batches=True)
    got = Trainer(device="cpu").validate(task, loader)
    return want, got, jdir, pdir, jclass, pclass


def _shards(out_dir, mod):
    manifest = json.load(open(os.path.join(out_dir, "manifest.json")))
    return manifest, [np.load(os.path.join(out_dir, n)) for n in manifest[mod]["shards"]]


def _exported(out_dir, mod):
    return np.concatenate([s["embeddings"] for s in _shards(out_dir, mod)[1]])


def test_validate_matches_jax_metrics(validated):
    """The same keys; recall and accuracy equal; the other classification
    metrics to 1e-12 (exact where the predictions agree); AUROC to
    ``AUROC_ATOL``; the loss at ``LOSS_RTOL``."""
    want, got, *_ = validated
    assert sorted(got) == sorted(want)
    assert {"retrieval/rgb_to_text_R@1", "retrieval/rgb_to_text_R@5",
            "retrieval/text_to_rgb_R@5", "classification/ds0_rgb_top1_accuracy",
            "classification/ds0_rgb_top2_accuracy", "classification/ds1_rgb_accuracy",
            "classification/ds1_rgb_auroc", "export/rgb_rows"} <= set(got)
    for key, value in want.items():
        if key.endswith("loss"):
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, err_msg=key)
        elif key.endswith("auroc"):
            np.testing.assert_allclose(got[key], value, rtol=0, atol=AUROC_ATOL, err_msg=key)
        else:
            assert got[key] == value, (key, got[key], value)
    assert got["export/rgb_rows"] == got["export/text_rows"] == 40


def _margins(sim: np.ndarray, positives: np.ndarray, ks) -> np.ndarray:
    """For each row and k, how far the positive's score stands from the
    k-th best other score: what decides whether the row is a hit at k."""
    out = []
    for row, pos in zip(sim, positives):
        others = -np.sort(-np.delete(row, pos))
        out += [abs(row[pos] - others[k - 1]) for k in ks]
    return np.asarray(out)


def test_scores_that_decide_the_metrics_stand_apart(validated):
    """Exact equality is sound: the embeddings and class embeddings agree to
    ``EMB_ATOL``, and every hit or miss (R@k, top-k accuracy, the argmax
    predictions, the binary sign) is decided by scores more than 100x that
    apart (cosines from the JAX export, in f64)."""
    _, _, jdir, pdir, jclass, pclass = validated
    jdir, pdir = os.path.join(jdir, "f32"), os.path.join(pdir, "f32")
    emb = {m: _exported(jdir, m).astype(np.float64) for m in ("rgb", "text")}
    for m in emb:
        np.testing.assert_allclose(_exported(pdir, m), emb[m], rtol=0, atol=EMB_ATOL)
    for ds in jclass:
        np.testing.assert_allclose(pclass[ds], jclass[ds], rtol=0, atol=EMB_ATOL)
    n = len(emb["rgb"])  # row i of each modality is the same example
    margins = [_margins(emb["rgb"] @ emb["text"].T, np.arange(n), (1, 5)),
               _margins(emb["text"] @ emb["rgb"].T, np.arange(n), (5,))]
    shards = _shards(jdir, "rgb")[1]
    ds_index = np.concatenate([s["dataset_index"] for s in shards])
    ex_index = np.concatenate([s["example_index"] for s in shards])
    datasets = eval_datasets(Example)
    labels = np.array([datasets[d].labels[e] for d, e in zip(ds_index, ex_index)])
    for ds, classes in jclass.items():
        sim = emb["rgb"][ds_index == ds] @ classes.T.astype(np.float64)
        top = -np.sort(-sim, axis=1)
        margins += [_margins(sim, labels[ds_index == ds], (1, 2) if len(classes) > 2 else (1,)),
                    top[:, 0] - top[:, 1]]  # the argmax, and the binary sign
    assert np.concatenate(margins).min() > 100 * EMB_ATOL


def test_export_layout_matches_jax(validated):
    """The same files, keys, dtypes, row counts and indices as the JAX
    export (f32 and f16); the embeddings within ``EMB_ATOL`` (f16: one
    rounding); each exported rgb row its own rank-1 neighbour in the port's
    ``EmbeddingIndex``."""
    _, _, jdir, pdir, *_ = validated
    for sub, mods in (("f32", ("rgb", "text")), ("f16", ("rgb",))):
        assert sorted(os.listdir(os.path.join(pdir, sub))) == sorted(
            os.listdir(os.path.join(jdir, sub)))
        for mod in mods:
            jm, jshards = _shards(os.path.join(jdir, sub), mod)
            pm, pshards = _shards(os.path.join(pdir, sub), mod)
            assert pm == jm
            for p, j in zip(pshards, jshards):
                assert sorted(p.files) == sorted(j.files)
                for key in j.files:
                    assert p[key].dtype == j[key].dtype and p[key].shape == j[key].shape, key
                np.testing.assert_array_equal(p["example_index"], j["example_index"])
                np.testing.assert_array_equal(p["dataset_index"], j["dataset_index"])
                atol = EMB_ATOL if sub == "f32" else 2e-3
                np.testing.assert_allclose(p["embeddings"].astype(np.float64),
                                           j["embeddings"], rtol=0, atol=atol)
    index = EmbeddingIndex.load(os.path.join(pdir, "f32"), modality="rgb", device="cpu")
    rows = _exported(os.path.join(pdir, "f32"), "rgb")
    _, ids = index.query(rows, k=1)
    assert ids[:, 0].tolist() == index.example_index.tolist()


def test_encode_restores_the_mode_and_returns_the_compute_dtype():
    task = port_task()
    task.train()
    runtime = tasks.EvalRuntime(task, "cpu")
    batch = {"rgb": np.zeros((2, 16, 16, 3), np.float32), "names": ["a", "b"]}
    out = runtime.encode(batch, "rgb", normalize=True)
    assert task.training and out.dtype == torch.float32 and out.shape == (2, 16)
    assert not out.requires_grad


def test_eval_runtime_computes_on_the_card_unless_told():
    """The runtime's device is the card by default, and a task whose
    parameters live elsewhere is refused, not run there silently."""
    task = port_task()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tasks.EvalRuntime(task)
    else:
        with pytest.raises(ValueError, match="parameters are on cpu"):
            tasks.EvalRuntime(task)
    assert tasks.EvalRuntime(task, "cpu").device == torch.device("cpu")


def _fit_loader():
    return DataLoader(CombinedDataset([eval_datasets(Example)[0]]), batch_size=8,
                      drop_last=True)


def test_eval_only_job_from_a_port_checkpoint(tmp_path):
    """Train 4 steps with a checkpoint; a fresh task restored through
    ``prepare_eval_state(ckpt_path="last")`` tests to the same metrics,
    hooks included; a missing checkpoint raises."""
    ckpt_dir = str(tmp_path / "ckpts")

    def task_with_hooks():
        task = port_task(evaluation_tasks={"retrieval": {"task": tasks.ZeroShotCrossModalRetrieval(
            [tasks.RetrievalTaskSpec("rgb", "text", top_k=[1, 3])])}})
        return task

    task = task_with_hooks()
    trainer = Trainer(max_steps=4, device="cpu", callbacks=[ModelCheckpoint(
        dirpath=ckpt_dir, every_n_epochs=None, save_last=True)])
    trainer.fit(task, _fit_loader())
    test_loader = DataLoader(CombinedDataset(eval_datasets(Example)), batch_size=16,
                             pad_partial_batches=True)
    want = trainer.test(task, test_loader)

    trainer2 = Trainer(device="cpu", callbacks=[ModelCheckpoint(dirpath=ckpt_dir)])
    task2 = task_with_hooks()
    state = trainer2.prepare_eval_state(task2, test_loader, ckpt_path="last")
    assert state.step == 4
    got = trainer2.test(task2, test_loader)
    assert "retrieval/rgb_to_text_R@3" in got and "test/loss" in got
    assert got == want

    for missing in (str(tmp_path / "none"), "last"):
        with pytest.raises(FileNotFoundError):
            Trainer(device="cpu", callbacks=[ModelCheckpoint(dirpath=str(tmp_path / "empty"))]
                    ).prepare_eval_state(task_with_hooks(), test_loader, ckpt_path=missing)


def test_validation_inside_fit_runs_the_hooks():
    """``fit``'s validation runs the hooks and passes their metrics to the
    callbacks; ``run_on_validation=False`` keeps a hook out of it."""
    seen = []

    class Recorder:
        def on_validation_end(self, trainer, metrics, step):
            seen.append((step, dict(metrics)))

        def __getattr__(self, name):
            return lambda *a, **k: None

    retrieval = tasks.ZeroShotCrossModalRetrieval([tasks.RetrievalTaskSpec("rgb", "text", [1])])
    task = port_task(evaluation_tasks={
        "retrieval": tasks.EvaluationSpec(task=retrieval),
        "test_only": tasks.EvaluationSpec(task=tasks.ZeroShotCrossModalRetrieval(
            [tasks.RetrievalTaskSpec("text", "rgb", [2])]), run_on_validation=False)})
    val_loader = DataLoader(CombinedDataset(eval_datasets(Example)), batch_size=16,
                            pad_partial_batches=True)
    Trainer(max_steps=2, val_check_interval=2, device="cpu", callbacks=[Recorder()]).fit(
        task, _fit_loader(), val_loader)
    assert [s for s, _ in seen] == [2]
    assert set(seen[0][1]) == {"validation/loss", "retrieval/rgb_to_text_R@1"}


def test_contrastive_task_takes_evaluation_tasks_only():
    spec = tasks.EvaluationSpec(task=tasks.EmbeddingExport("unused"))
    assert port_task(evaluation_tasks={"export": spec}).evaluation_tasks == {"export": spec}
    # PEFT, frozen encoders and auxiliary tasks are ported since; an
    # auxiliary spec of another type is refused
    with pytest.raises(TypeError, match="AuxiliaryTaskSpec"):
        port_task(auxiliary_tasks={"rgb": object()})
