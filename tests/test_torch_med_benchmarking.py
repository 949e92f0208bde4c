"""The port's project layer against the JAX package on the CPU: every
med_benchmarking reader (``mmlearn_tpu_torch.projects.med_benchmarking``)
against its JAX twin on the same files, key for key and value for value;
the stdlib CSV reading against pandas; the local CLIP-format vocabulary
through both packages' ``HFCLIPTokenizer``; ``baseline.yaml``'s task at tiny
widths on one collated batch of the four train readers (loss and every
gradient against ``jax.value_and_grad``); the zero-shot classification job
at tiny widths (accuracies equal); BIOSCAN's HDF5 reader and
``bioscan_1m.yaml``'s task against the recipe.

The files are written here from a seed (``chip_smoke.write_med_tree``, the
layouts phase 18 writes on the card, and per-test files for the hub, cache,
xlsx and VQA readers). Each test states its tolerance.
"""

import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from mmlearn_tpu_torch import bridge

SEED = 0
PX = 16  # the readers' image size in these tests
HW = ((24, 20), (18, 26), (20, 20))
ATOL = 1e-5  # f32 end to end (tests/test_torch_multitask.py's)
MED = "pkg://mmlearn_tpu_torch.projects.med_benchmarking.configs"
JAX_MED = "pkg://projects.med_benchmarking.configs"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the tiny models of this file: under a
    parallel test run, several workers' thread pools on the same cores slow
    such steps many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Phase 18's layouts at a tiny size and a CLIP-format vocabulary
    learned from their captions: ``(roots, vocab_dir, vocab)``."""
    from chip_smoke import med_captions, write_clip_vocab, write_med_tree

    root = tmp_path_factory.mktemp("med")
    roots = write_med_tree(str(root / "data"), 8, 6, 10, hw=HW, mnist_px=PX)
    vocab = write_clip_vocab(str(root / "vocab"), med_captions(pairs=8, valid=6), merges=120)
    return roots, str(root / "vocab"), vocab


@pytest.fixture()
def env(tree, monkeypatch):
    from chip_smoke import MED_ROOTS

    roots = tree[0]
    for name, var in MED_ROOTS:
        monkeypatch.setenv(var, roots[name])
    return tree


def _equal_examples(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray) or isinstance(got[key], np.ndarray):
            assert isinstance(got[key], np.ndarray), key
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert type(got[key]) is type(value) and got[key] == value, (key, got[key], value)


def _same_reader(port, jax_reader):
    assert len(port) == len(jax_reader) > 0
    for i in range(len(port)):
        _equal_examples(port[i], jax_reader[i])
    for attr in ("id2label", "zero_shot_prompt_templates"):
        if hasattr(jax_reader, attr):
            assert getattr(port, attr) == getattr(jax_reader, attr), attr


READERS = {
    "PMCOA-train": ("PMCOA", dict(split="train")),
    "PMCOA-valid": ("PMCOA", dict(split="valid")),
    "ROCO": ("ROCO", {}),
    "MIMICIVCXR": ("MIMICIVCXR", {}),
    "Quilt": ("Quilt", {}),
    "Quilt-subset": ("Quilt", dict(subset=["pubmed", "laion"])),
    "HAM10000": ("HAM10000", {}),
    "PadUfes20": ("PadUfes20", {}),
    "MedMNISTPlus-path": ("MedMNISTPlus", dict(name="pathmnist", split="test")),
    "MedMNISTPlus-derma": ("MedMNISTPlus", dict(name="dermamnist", split="test")),
}


@pytest.mark.parametrize("case", sorted(READERS))
def test_reader_matches_jax_on_phase_18_files(case, env):
    """Each reader that runs on the card, from the roots in its environment
    variable: ``len``, every key and value (index, caption, label,
    ``rgb_target``, the rgb array at the eval transform), ``id2label`` and
    the prompt templates equal the JAX reader's. Exact."""
    import projects.med_benchmarking.datasets as jds

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets as pds

    name, kwargs = READERS[case]
    _same_reader(getattr(pds, name)(image_size=PX, **kwargs),
                 getattr(jds, name)(image_size=PX, **kwargs))


def _image(seed, hw=(20, 24)):
    from chip_smoke import med_image

    return med_image(SEED, 90, seed, hw)


def _hub_rows(labels):
    """A hub table as ``datasets.Dataset.from_dict`` makes it: images as
    nested lists, one label a row."""
    import datasets

    return datasets.Dataset.from_dict({
        "image": [_image(i).tolist() for i in range(len(labels))], "label": list(labels)})


HUB = {
    # BACH: the seeded 75/25 split of the hub's train split
    "BACH-train": ("BACH", dict(split="train"), [0, 1, 2, 3] * 3),
    "BACH-test": ("BACH", dict(split="test"), [0, 1, 2, 3] * 3),
    # PCAM: an official split passed through
    "PCAM-test": ("PCAM", dict(split="test"), [0, 1] * 4),
    # NCK-CRC: the BACK rows dropped, string labels mapped to ids
    "NckCrc-validation": ("NckCrc", dict(split="validation"),
                          ["ADI", "BACK", "TUM", "STR", "BACK", "NORM", "MUC", "LYM", "DEB"]),
}


@pytest.mark.parametrize("case", sorted(HUB))
def test_hub_reader_matches_jax(case, tmp_path, monkeypatch):
    """The hub readers with ``datasets.load_dataset`` stubbed in both
    packages by one ``Dataset.from_dict`` table (the split protocol, the
    ``BACK`` filter, ``label_mapping``): every example equal. Exact."""
    import datasets
    import projects.med_benchmarking.datasets as jds

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets as pds

    name, kwargs, labels = HUB[case]
    table = _hub_rows(labels)
    calls = []

    def load_dataset(hub, cache_dir=None, split=None):
        calls.append((hub, split))
        return table

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    port = getattr(pds, name)(root_dir=str(tmp_path), image_size=PX, **kwargs)
    want = getattr(jds, name)(root_dir=str(tmp_path), image_size=PX, **kwargs)
    _same_reader(port, want)
    assert calls[0] == calls[1] and calls[0][0] == getattr(pds, name).hub_name
    if name == "NckCrc":
        assert len(port) == len(labels) - 2


def test_lc25000_reads_its_save_to_disk_cache(tmp_path):
    """LC25000 from a ``save_to_disk`` cache of each organ, through
    ``load_from_disk`` in both packages: every example and ``id2label``
    equal. Exact."""
    import projects.med_benchmarking.datasets as jds

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets as pds

    for organ, classes in (("lung", 3), ("colon", 2)):
        _hub_rows([i % classes for i in range(5)]).save_to_disk(
            str(tmp_path / "cache" / f"lc25000_{organ}_test.arrow"))
        kwargs = dict(root_dir=str(tmp_path), organ=organ, split="test", image_size=PX)
        _same_reader(pds.LC25000(**kwargs), jds.LC25000(**kwargs))
    with pytest.raises(FileNotFoundError, match="lc25000_lung_train"):
        pds.LC25000(root_dir=str(tmp_path), split="train")


def test_sicap_reduces_its_grade_columns_as_jax(tmp_path, monkeypatch):
    """SICAP with ``pandas.read_excel`` stubbed in both packages (so that
    the test needs no ``openpyxl``): the one-hot grades reduced by
    ``idxmax``, every example equal. Exact."""
    import pandas as pd
    import projects.med_benchmarking.datasets as jds
    from PIL import Image

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets as pds

    (tmp_path / "images").mkdir()
    names = [f"16B{i:04d}_Block_Region_{i}.jpg" for i in range(6)]
    for i, name in enumerate(names):
        Image.fromarray(_image(i)).save(tmp_path / "images" / name)
    grades = np.eye(4)[[0, 3, 1, 2, 3, 0]]
    frame = pd.DataFrame({"image_name": names, **{g: grades[:, k]
                                                  for k, g in enumerate(("NC", "G3", "G4", "G5"))},
                          "G4C": np.zeros(6)})
    read = []
    monkeypatch.setattr(pd, "read_excel", lambda path: read.append(path) or frame.copy())
    port = pds.SICAP(root_dir=str(tmp_path), split="test", image_size=PX)
    want = jds.SICAP(root_dir=str(tmp_path), split="test", image_size=PX)
    _same_reader(port, want)
    assert read[0] == read[1] and read[0].endswith(os.path.join("partition", "Test", "Test.xlsx"))
    assert [int(port[i]["rgb_target"]) for i in range(6)] == [0, 3, 1, 2, 3, 0]


def test_medvqa_answers_come_from_the_train_split(tmp_path):
    """MedVQA: the answer vocabulary of the train split for every split (an
    answer the train split lacks is -1), with and without ``answers.json``;
    every example equal to the JAX reader's. Exact."""
    import projects.med_benchmarking.datasets as jds
    from PIL import Image

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets as pds

    (tmp_path / "images").mkdir()
    answers = {"train": ["yes", "no", "left lung", "yes"], "test": ["no", "3", "yes"]}
    for split, values in answers.items():
        rows = []
        for i, answer in enumerate(values):
            name = f"{split}_{i}.png"
            Image.fromarray(_image(i)).save(tmp_path / "images" / name)
            rows.append({"image": name, "question": f"what is seen in {i}?", "answer": answer,
                         "answer_type": "CLOSED"})
        (tmp_path / f"{split}.json").write_text(json.dumps(rows))
    for split in ("train", "test"):
        kwargs = dict(root_dir=str(tmp_path), split=split, image_size=PX)
        _same_reader(pds.MedVQA(**kwargs), jds.MedVQA(**kwargs))
    assert pds.MedVQA(root_dir=str(tmp_path), split="test")[1]["rgb_target"] == -1
    (tmp_path / "answers.json").write_text(json.dumps(["3", "no", "yes"]))
    kwargs = dict(root_dir=str(tmp_path), split="test", image_size=PX)
    _same_reader(pds.MedVQA(**kwargs), jds.MedVQA(**kwargs))


# the CSV bodies: a label column of ints, labels mapped by str, a split
# column, captions that look like numbers, empty cells and quoted commas
CSVS = {
    "int-labels": "image,label\na.png,0\nb.png,2\nc.png,1\n",
    "str-mapped": "image,label,split\na.png,1,train\nb.png,0,test\nc.png,1,train\nd.png,0,train\n",
    "numbers": "image_path,caption,subset\n0.jpg,42,a\n1.jpg,3.50,b\n2.jpg,007,a\n",
    "mixed": 'image_path,caption,subset,age\n0.jpg,"left lobe, 3 cm",a,\n1.jpg,12,b,40\n'
             '2.jpg,-1.5e3,a,7\n\n3.jpg,x-ray,,55\n',
}


@pytest.mark.parametrize("case", sorted(CSVS))
def test_read_csv_types_cells_as_pandas(case, tmp_path):
    """``read_csv`` against ``pandas.read_csv`` on each body: the same rows
    and columns, each cell the same value and type once both are ``str``-ed
    (ints, floats, strings), but for the one departure: an empty cell of a
    string column reads as ``""`` where pandas reads NaN. Exact."""
    import pandas as pd

    from mmlearn_tpu_torch.projects.med_benchmarking.datasets.base import read_csv

    path = tmp_path / "rows.csv"
    path.write_text(CSVS[case])
    got = read_csv(str(path))
    want = pd.read_csv(path).to_dict("records")
    assert len(got) == len(want) and all(list(g) == list(w) for g, w in zip(got, want))
    for g_row, w_row in zip(got, want):
        for key, w in w_row.items():
            g = g_row[key]
            if isinstance(w, float) and math.isnan(w) and isinstance(g, str):
                assert g == "", (key, g)
            else:
                assert str(g) == str(w) and isinstance(g, (int, float, str)), (key, g, w)
                assert isinstance(g, str) == isinstance(w, str), (key, g, w)


def test_csv_readers_match_pandas_and_the_empty_caption_departs(tmp_path):
    """``CSVImageClassification`` on an int label column, on labels mapped
    through ``label_names`` by ``str`` after a ``split`` filter, and
    ``ImageTextManifest`` on a CSV with captions that look like numbers:
    equal to the JAX readers (pandas). One departure, shown here: an empty
    caption is ``""`` in the port and ``"nan"`` in the JAX package
    (ROADMAP §3)."""
    import projects.med_benchmarking.datasets.base as jbase
    from PIL import Image

    import mmlearn_tpu_torch.projects.med_benchmarking.datasets.base as pbase

    for sub in ("images", "figs"):
        (tmp_path / sub).mkdir()
    for i, name in enumerate("abcd"):
        Image.fromarray(_image(i)).save(tmp_path / "images" / f"{name}.png")
        Image.fromarray(_image(i + 4)).save(tmp_path / "figs" / f"{i}.jpg")
    (tmp_path / "ints.csv").write_text(CSVS["int-labels"])
    (tmp_path / "mapped.csv").write_text(CSVS["str-mapped"])
    for csv_name, names in (("ints.csv", None), ("mapped.csv", {"0": 4, "1": 5})):
        classes = [type("Set", (cls,), {"csv_name": csv_name, "label_names": names})
                   for cls in (pbase.CSVImageClassification, jbase.CSVImageClassification)]
        port, want = (c(str(tmp_path), split="train", image_size=PX) for c in classes)
        _same_reader(port, want)
    assert len(port) == 3 and [port[i]["rgb_target"] for i in range(3)] == [5, 5, 4]
    (tmp_path / "train.csv").write_text(
        "image_path,caption\n0.jpg,42\n1.jpg,3.50\n2.jpg,\n3.jpg,\"a lobe, 2 cm\"\n")
    kwargs = dict(split="train", file_type="csv", image_key="image_path", image_dir="figs",
                  image_size=PX)
    port = pbase.ImageTextManifest(str(tmp_path), **kwargs)
    want = jbase.ImageTextManifest(str(tmp_path), **kwargs)
    assert len(port) == len(want) == 4
    for i in (0, 1, 3):
        _equal_examples(port[i], want[i])
    assert [port[i]["text"] for i in range(4)] == ["42", "3.50", "", "a lobe, 2 cm"]
    assert want[2]["text"] == "nan"
    np.testing.assert_array_equal(port[2]["rgb"], want[2]["rgb"])


def test_local_clip_vocabulary_tokenizes_alike_in_both_packages(tree):
    """The CLIP-format vocabulary written from the captions (the byte
    alphabet, the learned merges, ``<|startoftext|>`` and ``<|endoftext|>``
    the two highest ids) through both packages' ``HFCLIPTokenizer``:
    identical ids and masks; each row's EOS (``input_ids.argmax``, the
    text tower's pooling) where its mask ends."""
    from chip_smoke import eos_positions, med_caption
    from mmlearn_tpu.datasets.processors.tokenizers import HFCLIPTokenizer as JTokenizer

    from mmlearn_tpu_torch.datasets.processors.tokenizers import HFCLIPTokenizer

    _, vocab_dir, vocab = tree
    texts = [med_caption(SEED, 1, i, (1, 90)) for i in range(12)] + ["", "Ünïcode ✓ 12,5 mm"]
    got, want = HFCLIPTokenizer(vocab_dir)(texts), JTokenizer(vocab_dir)(texts)
    assert sorted(got) == sorted(want) == ["text", "text_attention_mask"]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    ids, mask = got["text"], got["text_attention_mask"]
    assert ids.shape == (len(texts), 77) and ids.max() == vocab["eos"] == vocab["size"] - 1
    assert (ids[:, 0] == vocab["bos"]).all()
    pooled, last = eos_positions(ids, mask)
    np.testing.assert_array_equal(pooled, last)
    assert mask[:, -1].any()  # a caption cut at 77 tokens keeps its EOS


def _tiny(modalities=("rgb", "text")):
    """``baseline.yaml``'s towers at 1 block of width 64, 4 heads, in f32."""
    out = []
    for m in modalities:
        out += [f"task.encoders.{m}.depth=1", f"task.encoders.{m}.embed_dim=64",
                f"task.encoders.{m}.num_heads=4", f"task.encoders.{m}.proj_dim=32",
                f"task.encoders.{m}.dtype=float32"]
    return out + [f"task.encoders.rgb.img_size={PX}", "task.encoders.rgb.patch_size=8"]


def _both(overrides):
    """The composition of the JAX YAML and of the port's with the same
    overrides (the port's searchpath and the JAX one)."""
    from mmlearn_tpu.cli.run import build_experiment as jax_build

    from mmlearn_tpu_torch.cli.run import build_experiment

    return (jax_build([f"searchpath=[{JAX_MED}]", *overrides]),
            build_experiment([f"searchpath=[{MED}]", *overrides]))


@pytest.fixture(scope="module")
def baseline(tree):
    """``baseline.yaml`` composed in both packages at tiny widths (the same
    overrides), one batch of two rows of each train reader (from the
    composed datasets, the roots in their environment variables) collated
    by each package's composed collator and the local tokenizer, and the
    JAX task's weights, initialised once: the zero-shot job's towers are
    the same. ``(jcfg, cfg, jtask, jbatch, batch, params)``."""
    from chip_smoke import MED_ROOTS
    from mmlearn_tpu.conf import instantiate as jinstantiate

    from mmlearn_tpu_torch.conf import instantiate

    roots, vocab_dir, _ = tree
    tok = f"pretrained_model_name_or_path={vocab_dir}"
    overrides = ["+experiment=baseline", *_tiny(),
                 f"+dataloader.train.collate_fn.batch_processors.text.{tok}",
                 *[f"+datasets.train.{n}.image_size={PX}" for n in ("pmcoa", "roco", "mimic",
                                                                      "quilt")]]
    jcfg, cfg = _both(overrides)
    batches = []
    with pytest.MonkeyPatch.context() as mp:
        for name, var in MED_ROOTS:
            mp.setenv(var, roots[name])
        for inst, c in ((jinstantiate, jcfg), (instantiate, cfg)):
            readers = [inst(node) for node in c["datasets"]["train"].values()]
            batches.append(inst(c["dataloader"]["train"]["collate_fn"])(
                [ds[i] for ds in readers for i in (0, 1)]))
    jbatch, batch = batches
    jtask = jinstantiate(jcfg["task"])
    params = jax.device_get(jax.jit(jtask.init_params)(jax.random.key(0), jbatch))
    return jcfg, cfg, jtask, jbatch, batch, params


def test_baseline_step_matches_jax_value_and_grad(baseline):
    """``baseline.yaml``'s task at tiny widths in both packages, the JAX
    task's weights carried by ``bridge``, on the fixture's batch: the two
    batches equal (MIMIC's ``rgb_target`` present on its two rows only),
    and the loss and every gradient against ``jax.value_and_grad`` to atol
    1e-5."""
    from mmlearn_tpu_torch.conf import instantiate

    _, cfg, jtask, jbatch, batch, params = baseline
    assert sorted(batch) == sorted(jbatch)
    for key, value in jbatch.items():
        np.testing.assert_array_equal(batch[key], value, err_msg=key)
    np.testing.assert_array_equal(batch["rgb_target_presence"], np.arange(8) // 2 == 2)

    torch.manual_seed(0)
    task = instantiate(cfg["task"])
    task.load_state_dict(bridge.jax_to_torch(params), strict=True)

    def jloss(p):
        loss, (metrics, _) = jtask.loss_fn(p, jbatch, jax.random.key(1), {}, deterministic=True)
        return loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    loss, _ = task.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=ATOL)
    want = {k: v for k, v in bridge.jax_to_torch(jax.device_get(want_grads)).items()}
    got = {n: p.grad for n, p in task.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=ATOL, msg=name)


def test_zero_shot_job_matches_jax_accuracies(env, baseline):
    """``zeroshot_classification_eval.yaml`` composed in both packages at
    tiny widths over HAM10000 and MedMNIST+ (the other sets deleted with
    ``~``), the local tokenizer, the baseline fixture's JAX weights (the
    same towers) carried by ``bridge``: ``test`` of each package's trainer
    on its own readers gives every metric equal (accuracies, precision,
    recall, F1, AUROC). Exact."""
    import jax.numpy as jnp
    from mmlearn_tpu.conf import instantiate as jinstantiate
    from mmlearn_tpu.datasets.core import CombinedDataset as JCombined
    from mmlearn_tpu.datasets.core import DataLoader as JLoader
    from mmlearn_tpu.trainer import Trainer as JTrainer
    from mmlearn_tpu.trainer.state import TrainState

    from mmlearn_tpu_torch.conf import instantiate
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader
    from mmlearn_tpu_torch.trainer import Trainer

    _, vocab_dir, _ = env
    params = baseline[-1]
    kept = ("ham10000", "pathmnist")
    overrides = ["+experiment=zeroshot_classification_eval", *_tiny(),
                 "+task.evaluation_tasks.classification.task.tokenizer."
                 f"pretrained_model_name_or_path={vocab_dir}",
                 *[f"~datasets.test.{n}" for n in ("bach", "pcam", "lc25000_lung",
                                                   "lc25000_colon", "pad_ufes_20", "nck_crc",
                                                   "sicap", "dermamnist")],
                 *[f"+datasets.test.{n}.image_size={PX}" for n in kept]]
    jcfg, cfg = _both(overrides)
    assert list(cfg["datasets"]["test"]) == list(kept)
    jloader = JLoader(JCombined([jinstantiate(n) for n in jcfg["datasets"]["test"].values()]),
                      batch_size=8, pad_partial_batches=True)
    jtask = jinstantiate(jcfg["task"])
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=None,
                        extras=jtask.init_extras(params))
    want = JTrainer(seed=0, mesh_shape={"data": 1}).test(jtask, jloader, state=jstate)

    task = instantiate(cfg["task"])
    task.load_state_dict(bridge.jax_to_torch(params), strict=True)
    loader = DataLoader(CombinedDataset([instantiate(n) for n in cfg["datasets"]["test"].values()]),
                        batch_size=8, pad_partial_batches=True)
    got = Trainer(device="cpu").test(task, loader)
    acc = [k for k in want if k.endswith("top1_accuracy")]
    assert len(acc) == len(kept)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=0 if "accuracy" in key else 1e-6), key


@functools.lru_cache(maxsize=1)
def _bioscan_file(path):
    from tests.test_projects import _make_bioscan_h5

    _make_bioscan_h5(path, ["train_seen", "val_seen"], n_per_split=6)
    return path


@pytest.mark.parametrize("for_training", [False, True])
def test_bioscan_reader_matches_jax(for_training, tmp_path_factory):
    """``BIOSCANInsectDataset`` on a tiny HDF5 file (``tests/test_projects.py``'s
    layout) against the JAX reader: every key and value (the JPEG decode at
    the eval transform, the DNA tokens, the language tokens, the taxonomy
    dicts); with ``for_training`` every key but the randomly cropped image,
    whose shape and dtype match. Exact."""
    from projects.bioscan_clip.dataset import BIOSCANInsectDataset as JBioscan
    from projects.bioscan_clip.dna_tokenizer import DNAProcessor as JDNA

    from mmlearn_tpu_torch.projects.bioscan_clip.dataset import BIOSCANInsectDataset
    from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor

    path = _bioscan_file(str(tmp_path_factory.getbasetemp() / "bioscan.h5"))
    split = "train_seen" if for_training else "val_seen"
    kw = dict(split=split, for_training=for_training, image_size=32)
    port = BIOSCANInsectDataset(path, dna_processor=DNAProcessor(max_length=60), **kw)
    want = JBioscan(path, dna_processor=JDNA(max_length=60), **kw)
    assert len(port) == len(want) == 6
    for i in range(len(port)):
        got, ref = port[i], want[i]
        if for_training:
            assert got["rgb"].shape == ref["rgb"].shape and got["rgb"].dtype == ref["rgb"].dtype
            got.pop("rgb"), ref.pop("rgb")
        _equal_examples(got, ref)
    if not for_training:
        assert port.labels == want.labels


def test_bioscan_yaml_task_equals_the_recipe():
    """``bioscan_1m.yaml`` composed by the port's CLI and its task built on
    the ``meta`` device: every parameter name and shape, the LoRA factors
    and the trainable set equal to ``recipe.bioscan_task()``'s."""
    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.conf import instantiate
    from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task

    cfg = build_experiment(["searchpath=[pkg://mmlearn_tpu_torch.projects.bioscan_clip.configs]",
                            "+experiment=bioscan_1m"])
    assert cfg["datasets"]["train"]["_target_"] == (
        "mmlearn_tpu_torch.projects.bioscan_clip.dataset.BIOSCANInsectDataset")
    with torch.device("meta"):
        task, recipe = instantiate(cfg["task"]), bioscan_task(device="meta")

    def layout(t):
        return ({n: tuple(p.shape) for n, p in t.named_parameters()},
                {n for n, p in t.named_parameters() if p.requires_grad})

    got, want = layout(task), layout(recipe)
    assert got == want
    assert sum("lora" in n for n in got[0]) == 88
