"""The port's fastloader (``csrc/fastloader.cpp`` through
``mmlearn_tpu_torch.native``) and image transforms against the JAX
package's ``mmlearn_tpu.native`` and ``image_utils``, on the CPU, on the
committed JPEG fixtures (``tests/fixtures/jpeg/``, written by
``tools/make_jpeg_fixtures.py``: ImageNet-sized, quality 90, 4:2:0, one
progressive, one grayscale).

Tolerance: none. Both libraries are built from the same arithmetic with the
same ``g++`` commands in the same order (``-march=native`` first), so the
decoded bytes are held equal bit for bit, eval and train, with libjpeg's
DCT-domain scaling on and off. The build itself: at first use into
``build/host/`` under a hash of the source and flags, reused after, and a
failed build raises (naming libjpeg for the decoders), never falling back.
"""

import glob
import io
import logging
import os
import pathlib

import numpy as np
import pytest

from mmlearn_tpu import native as jnative
from mmlearn_tpu.datasets.builtin import image_utils as jimage
from mmlearn_tpu_torch import _build, native
from mmlearn_tpu_torch.datasets.builtin import image_utils

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "jpeg", "*.jpg")))
SIZE = 224


def jpegs() -> list:
    return [pathlib.Path(p).read_bytes() for p in FIXTURES]


def test_fixtures_as_described():
    """At most 32 files and 3 MB, one progressive and one grayscale."""
    from PIL import Image

    sizes = [os.path.getsize(p) for p in FIXTURES]
    assert 8 <= len(FIXTURES) <= 32 and sum(sizes) <= 3 * 2**20
    assert 40_000 <= np.mean(sizes) <= 120_000
    kinds = []
    for p in FIXTURES:
        with Image.open(p) as img:
            kinds.append((img.mode, bool(img.info.get("progressive"))))
    assert kinds.count(("L", False)) == 1 and kinds.count(("RGB", True)) == 1


def test_build_cached_under_a_hash():
    path = _build.build_host("fastloader", libs=("-ljpeg", "-lpthread"))
    assert os.path.dirname(path) == _build.HOST_BUILD_DIR and os.path.exists(path)
    stamp = os.stat(path).st_mtime_ns
    assert _build.build_host("fastloader", libs=("-ljpeg", "-lpthread")) == path
    assert os.stat(path).st_mtime_ns == stamp  # reused, not rebuilt
    crc = _build.build_host("fastloader", flags=("-DFASTLOADER_CRC_ONLY",))
    assert crc != path and os.path.basename(crc).startswith("libfastloader-")
    assert native.has_libjpeg()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    the decoders' error names libjpeg. No fallback."""
    (tmp_path / "fastloader.cpp").write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="libjpeg") as err:
        native.decode_jpeg(jpegs()[0], SIZE)
    assert "no_such_header.h" in str(err.value)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.crc32c(b"abc")


@pytest.mark.parametrize("dct", ["scaled", "unscaled"])
@pytest.mark.parametrize("path", ["eval", "train"])
def test_decode_equals_the_jax_decoder(monkeypatch, path, dct):
    if dct == "unscaled":
        monkeypatch.setenv("MMLEARN_FASTLOADER_NO_DCT_SCALE", "1")
    for i, data in enumerate(jpegs()):
        if path == "eval":
            got, want = native.decode_jpeg(data, SIZE), jnative.decode_jpeg(data, SIZE)
        else:
            got = native.decode_jpeg_train(data, SIZE, seed=1000 + i)
            want = jnative.decode_jpeg_train(data, SIZE, seed=1000 + i)
        assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
        assert got.std() > 1.0, FIXTURES[i]  # decoded, not a zero image
        np.testing.assert_array_equal(got, want, err_msg=FIXTURES[i])


def test_batches_equal_per_image_and_repeat():
    """The batch decode on 3 threads equals the per-image decode, eval and
    train under per-image seeds; the same seeds repeat, others differ; the
    JAX batch decoders agree."""
    data = jpegs()
    seeds = [7 * i + 1 for i in range(len(data))]
    train = native.decode_jpeg_batch_train(data, SIZE, seeds, n_threads=3)
    np.testing.assert_array_equal(train, jnative.decode_jpeg_batch_train(data, SIZE, seeds,
                                                                         n_threads=2))
    np.testing.assert_array_equal(train, native.decode_jpeg_batch_train(data, SIZE, seeds,
                                                                        n_threads=1))
    for i, d in enumerate(data):
        np.testing.assert_array_equal(train[i], native.decode_jpeg_train(d, SIZE, seed=seeds[i]))
    other = native.decode_jpeg_batch_train(data, SIZE, [s + 1 for s in seeds], n_threads=3)
    assert all((other[i] != train[i]).any() for i in range(len(data)))
    evals = native.decode_jpeg_batch(data, SIZE, n_threads=3)
    np.testing.assert_array_equal(evals, jnative.decode_jpeg_batch(data, SIZE, n_threads=2))
    for i, d in enumerate(data[:4]):
        np.testing.assert_array_equal(evals[i], native.decode_jpeg(d, SIZE))
    with pytest.raises(ValueError, match="one entry per image"):
        native.decode_jpeg_batch_train(data, SIZE, seeds[:-1])


def test_bad_jpeg_zeroed_and_counted(caplog):
    data = jpegs()[:2]
    batch = [data[0], b"\xff\xd8not a jpeg", data[1]]
    with caplog.at_level(logging.WARNING):
        out = native.decode_jpeg_batch_train(batch, 32, [1, 2, 3], n_threads=2)
    assert "1/3 JPEGs failed" in caplog.text
    assert not out[1].any() and out[0].any() and out[2].any()
    np.testing.assert_array_equal(out, jnative.decode_jpeg_batch_train(batch, 32, [1, 2, 3]))
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_jpeg(batch[1], 32)


def cmyk_jpeg() -> bytes:
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, (40, 56, 4), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="CMYK").save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("train,device_normalize", [(False, False), (True, False), (False, True),
                                                    (True, True)])
def test_decode_transform_jpeg_equals_the_jax_one(train, device_normalize):
    """The native path (a fixture) and the PIL retry (a CMYK JPEG, which
    libjpeg's RGB output refuses) under the same rng: equal bit for bit."""
    for data in (jpegs()[3], cmyk_jpeg()):
        kw = dict(size=48, train=train, device_normalize=device_normalize)
        got = image_utils.decode_transform_jpeg(data, image_utils.ImageTransform(**kw),
                                                rng=np.random.default_rng(5))
        want = jimage.decode_transform_jpeg(data, jimage.ImageTransform(**kw),
                                            rng=np.random.default_rng(5))
        assert got.dtype == (np.uint8 if device_normalize else np.float32)
        assert got.dtype == want.dtype and got.shape == (48, 48, 3)
        np.testing.assert_array_equal(got, want)


def test_rejected_jpeg_without_pil_raises(monkeypatch):
    """Where PIL is absent, a JPEG the native decoder rejects raises a
    ValueError that names the failure, never a zero image."""
    real = image_utils.importlib.util.find_spec
    monkeypatch.setattr(image_utils.importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else real(name, *a))
    for train in (False, True):
        with pytest.raises(ValueError, match="rejected a JPEG.*PIL"):
            image_utils.decode_transform_jpeg(cmyk_jpeg(), image_utils.ImageTransform(
                size=16, train=train))


@pytest.mark.parametrize("case", ["eval", "train", "gray", "uint8"])
def test_image_transform_on_arrays_equals_the_jax_one(case):
    img = np.random.default_rng(1).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    kw = {"eval": {}, "train": {"train": True}, "gray": {}, "uint8": {"device_normalize": True,
                                                                     "train": True}}[case]
    if case == "gray":
        img = img[..., 0]
    got = image_utils.ImageTransform(size=16, **kw)(img, rng=np.random.default_rng(2))
    want = jimage.ImageTransform(size=16, **kw)(img, rng=np.random.default_rng(2))
    assert got.shape == (16, 16, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert image_utils.to_model_dtype(got).dtype == jimage.to_model_dtype(want).dtype
    assert (image_utils.CLIP_MEAN, image_utils.IMAGENET_STD) == (jimage.CLIP_MEAN,
                                                                 jimage.IMAGENET_STD)
