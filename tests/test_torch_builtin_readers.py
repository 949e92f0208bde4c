"""The port's built-in readers against the JAX package's, on the CPU, on
small files each test writes (JPEG and PNG images, JSON manifests, XML
boxes, depth PNGs, scene and intrinsics files, LibriSpeech transcripts):
every ``Example`` equal key for key and bit for bit, and the metadata
(``id2label``, prompt templates, scene tables). ImageNet's JPEG branch goes
through the native decoder on both sides; PNGs and the depth maps through
PIL (on the CPU only). LibriSpeech's audio decode is monkeypatched on both
sides, as the JAX test does (``soundfile`` is absent).
"""

import json
import os

import numpy as np
import pytest

from mmlearn_tpu.datasets import builtin as jbuiltin
from mmlearn_tpu.datasets.builtin import librispeech as jlibri
from mmlearn_tpu_torch.datasets import builtin
from mmlearn_tpu_torch.datasets.builtin import librispeech as libri
from tests.test_torch_tfrecord import same


def write_image(path, size=(40, 48), seed=0, mode="RGB"):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    if mode == "I;16":
        arr = rng.integers(300, 60000, size, dtype=np.uint16)
        Image.fromarray(arr).save(path)
        return
    Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(path, quality=90)


def both(name, *args, **kw):
    return getattr(builtin, name)(*args, **kw), getattr(jbuiltin, name)(*args, **kw)


def assert_items_equal(ds, jds):
    assert len(ds) == len(jds) > 0
    for i in range(len(jds)):
        same(dict(ds[i]), dict(jds[i]))


def imagenet_tree(root, ext=".jpg"):
    for c, cls in enumerate(("n01", "n02", "n03")):
        for i in range(2):
            write_image(str(root / "train" / cls / f"{i}{ext}"), size=(40 + 8 * i, 56),
                        seed=c * 2 + i)
    return root


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_imagenet_items_and_metadata(tmp_path, ext):
    root = imagenet_tree(tmp_path / "imagenet", ext)
    (root / "id2label.json").write_text(json.dumps({"n01": "tench", "n03": "goldfish"}))
    ds, jds = both("ImageNet", root_dir=str(root), split="train", image_size=16)
    assert_items_equal(ds, jds)
    assert ds.id2label == jds.id2label == {0: "tench", 1: "n02", 2: "goldfish"}
    assert ds.zero_shot_prompt_templates == jds.zero_shot_prompt_templates
    assert len(ds.zero_shot_prompt_templates) == 80


def test_imagenet_manifest_read_across_packages(tmp_path):
    """The JAX package's manifest is read by the port (and the tree's later
    changes are not seen, as there); the port's by the JAX package."""
    root = imagenet_tree(tmp_path / "imagenet")
    jds = jbuiltin.ImageNet(root_dir=str(root), image_size=16, manifest_cache=True)
    write_image(str(root / "train" / "n01" / "9.jpg"), seed=9)  # after the manifest
    ds = builtin.ImageNet(root_dir=str(root), image_size=16, manifest_cache=True)
    assert ds.samples == jds.samples and len(ds) == 6
    os.remove(root / "train" / ".mmlearn_manifest.json")
    ds = builtin.ImageNet(root_dir=str(root), image_size=16, manifest_cache=True)
    jds = jbuiltin.ImageNet(root_dir=str(root), image_size=16, manifest_cache=True)
    assert ds.samples == jds.samples and len(ds) == 7


def test_imagenet_1000_classes_and_masks(tmp_path):
    from mmlearn_tpu.datasets.builtin._imagenet_labels import IMAGENET_ID2LABEL as want
    from mmlearn_tpu_torch.datasets.builtin._imagenet_labels import IMAGENET_ID2LABEL

    assert IMAGENET_ID2LABEL == want
    root = tmp_path / "imagenet"
    for c in range(1000):
        os.makedirs(root / "val" / f"n{c:04d}")
    write_image(str(root / "val" / "n0000" / "a.jpg"))
    ds = builtin.ImageNet(root_dir=str(root), split="val", image_size=16,
                          mask_generator=lambda: np.arange(4) % 2 == 0)
    assert ds.id2label == want and len(ds) == 1
    np.testing.assert_array_equal(ds[0]["rgb_mask"], [True, False, True, False])


def test_chexpert_and_nihcxr(tmp_path):
    root = tmp_path / "cx"
    write_image(str(root / "imgs" / "a.jpg"), seed=1)
    write_image(str(root / "imgs" / "b.png"), seed=2)
    manifest = [{"image_path": "imgs/a.jpg", "label": [0.0, 1.0] * 7, "qid": "q1"},
                {"image_path": str(root / "imgs" / "b.png"), "label": [1.0] * 14}]
    for name in ("chexbert_train_data.json", "valid_data.json", "train_data.json"):
        (root / name).write_text(json.dumps(manifest))
    assert_items_equal(*both("CheXpert", root_dir=str(root), split="train", labeler="chexbert",
                             image_size=16))
    assert_items_equal(*both("CheXpert", root_dir=str(root), split="valid", image_size=16))
    assert_items_equal(*both("NIHCXR", root_dir=str(root), split="train", image_size=16))
    transform = builtin.ImageTransform(size=16, device_normalize=True)
    jtransform = jbuiltin.ImageTransform(size=16, device_normalize=True)
    ds = builtin.CheXpert(root_dir=str(root), split="valid", transform=transform)
    jds = jbuiltin.CheXpert(root_dir=str(root), split="valid", transform=jtransform)
    assert ds[0]["rgb"].dtype == np.uint8
    assert_items_equal(ds, jds)
    with pytest.raises(ValueError, match="requires a labeler"):
        builtin.CheXpert(root_dir=str(root), split="train", labeler=None)


def test_llvip(tmp_path):
    root = tmp_path / "llvip"
    for i in range(2):
        write_image(str(root / "visible" / "train" / f"{i}.jpg"), seed=i)
        write_image(str(root / "infrared" / "train" / f"{i}.jpg"), seed=10 + i)
    (root / "Annotations").mkdir()
    (root / "Annotations" / "0.xml").write_text(
        "<annotation><object><bndbox><xmin>1</xmin><ymin>2</ymin><xmax>3</xmax><ymax>4</ymax>"
        "</bndbox></object></annotation>")
    ds, jds = both("LLVIP", root_dir=str(root), train=True, include_bboxes=True, image_size=16)
    assert_items_equal(ds, jds)
    np.testing.assert_array_equal(ds[0]["bboxes"][0], [1, 2, 3, 4])


def rgbd_tree(root, sensors: bool):
    ids = ["kv1/a/0001", "xtion/b/0002", "kv2/c/0003"] if sensors else ["0001", "0002", "0003"]
    scenes = ["kitchen", "office", "not_a_scene"]
    for split in ("train", "test"):
        (root / f"{split}.txt").parent.mkdir(parents=True, exist_ok=True)
        (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
        for k, (fid, scene) in enumerate(zip(ids, scenes)):
            base = root / split
            write_image(str(base / "rgb" / f"{fid}{'.jpg' if sensors else '.png'}"), seed=k)
            write_image(str(base / "depth" / f"{fid}.png"), mode="I;16", seed=20 + k)
            os.makedirs(base / "scene_class" / os.path.dirname(fid), exist_ok=True)
            (base / "scene_class" / f"{fid}.txt").write_text(scene.replace(" ", "_"))
            if sensors:
                os.makedirs(base / "intrinsics" / os.path.dirname(fid), exist_ok=True)
                (base / "intrinsics" / f"{fid}.txt").write_text(f"{500 + k}.5 0 0\n0 1 0\n")
    return root


@pytest.mark.parametrize("name", ["NYUv2", "SUNRGBD"])
@pytest.mark.parametrize("split,return_type,image_size", [
    ("train", "disparity", 16), ("test", "image", 16), ("train", "image", None)])
def test_rgbd_readers(tmp_path, name, split, return_type, image_size):
    root = rgbd_tree(tmp_path / name, sensors=name == "SUNRGBD")
    ds, jds = both(name, root_dir=str(root), split=split, return_type=return_type,
                   image_size=image_size)
    assert len(ds) == (2 if split == "test" else 3)  # the test split drops unknown scenes
    assert_items_equal(ds, jds)


def test_librispeech(tmp_path, monkeypatch):
    chap = tmp_path / "train-clean-100" / "19" / "198"
    chap.mkdir(parents=True)
    (chap / "19-198.trans.txt").write_text("19-198-0000 HELLO WORLD\n19-198-0001 SECOND ONE\n"
                                            "19-198-0002 NO FILE\n")
    for utt in ("19-198-0000", "19-198-0001"):
        (chap / f"{utt}.flac").write_bytes(b"fake")
    lengths = {"19-198-0000": 16000 * 2, "19-198-0001": 16000 * 40}

    def fake_load(path):
        utt = os.path.splitext(os.path.basename(path))[0]
        return np.random.default_rng(lengths[utt]).standard_normal(lengths[utt]).astype(
            np.float32)

    monkeypatch.setattr(libri.LibriSpeech, "_load_audio", staticmethod(fake_load))
    monkeypatch.setattr(jlibri.LibriSpeech, "_load_audio", staticmethod(fake_load))
    ds, jds = both("LibriSpeech", root_dir=str(tmp_path), split="train-clean-100")
    assert len(ds) == 2 and ds[0]["audio"].shape == (16000 * 30, 1)
    assert_items_equal(ds, jds)
