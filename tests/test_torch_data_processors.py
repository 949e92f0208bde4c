"""The port's host processors and synthetic datasets on the CPU, held to the
JAX package's: the three mask generators draw for draw on the same
``numpy.random.Generator``, the numpy transforms, ``Img2Seq``,
``HFTokenizer`` on a local vocab written here (skipped where
``transformers`` is absent), and ``SyntheticImageText`` / ``SyntheticImages``
item for item. Host code: every output must be exactly equal.
"""

import functools

import numpy as np
import pytest

from mmlearn_tpu.datasets.builtin import image_utils as j_image_utils
from mmlearn_tpu.datasets.builtin import synthetic as j_synthetic
from mmlearn_tpu.datasets.processors import masking as j_masking
from mmlearn_tpu.datasets.processors import tokenizers as j_tokenizers
from mmlearn_tpu.datasets.processors import transforms as j_transforms
from mmlearn_tpu_torch.datasets.builtin import SyntheticImages, SyntheticImageText
from mmlearn_tpu_torch.datasets.processors import (
    CLIP_MEAN,
    CLIP_STD,
    BlockwiseImagePatchMaskGenerator,
    HFTokenizer,
    IJEPAMaskGenerator,
    Img2Seq,
    RandomMaskGenerator,
    TrimText,
    center_crop,
    normalize_image,
    pad_or_trim,
    resize_image,
)
from tests.test_torch_data_core import assert_same as _assert_same

# a transform's output need not be contiguous: the collator's np.stack makes it so
assert_same = functools.partial(_assert_same, contiguous=False)

# ------------------------------------------------------------ mask generators


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("with_mask", [False, True])
def test_random_mask_generator_matches_jax(seed, with_mask):
    rng = np.random.default_rng(100 + seed)
    ids = rng.integers(0, 200, (6, 24)).astype(np.int32)
    ids[:, 0] = 101
    mask = (np.arange(24)[None] < rng.integers(4, 25, (6, 1))).astype(np.int32)
    kw = dict(probability=0.3, vocab_size=200)
    args = (ids, mask if with_mask else None)
    got = RandomMaskGenerator(**kw)(*args, rng=np.random.default_rng(seed))
    want = j_masking.RandomMaskGenerator(**kw)(*args, rng=np.random.default_rng(seed))
    for a, b in zip(got, want, strict=True):
        assert_same(a, b)
    # without a generator: children spawned from the seeded one, call after call
    gen, jgen = RandomMaskGenerator(seed=seed, **kw), j_masking.RandomMaskGenerator(seed=seed, **kw)
    for _ in range(2):
        for a, b in zip(gen(*args), jgen(*args), strict=True):
            assert_same(a, b)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(input_size=8, num_masking_patches=40, max_num_patches=10, min_aspect=0.5),
    dict(input_size=6, num_masking_patches=30, min_num_patches=8),
])
def test_blockwise_mask_generator_matches_jax(kw):
    for seed in range(4):
        got = BlockwiseImagePatchMaskGenerator(**kw)(np.random.default_rng(seed))
        want = j_masking.BlockwiseImagePatchMaskGenerator(**kw)(np.random.default_rng(seed))
        assert_same(got, want)
        assert got.sum() == want.sum() == kw.get("num_masking_patches", 75)
    gen = BlockwiseImagePatchMaskGenerator(seed=3, **kw)
    jgen = j_masking.BlockwiseImagePatchMaskGenerator(seed=3, **kw)
    assert_same(gen(), jgen())


def test_ijepa_mask_generator_matches_jax():
    kw = dict(input_size=96, patch_size=16, npred=3)
    got = IJEPAMaskGenerator(**kw)(5, rng=np.random.default_rng(11))
    want = j_masking.IJEPAMaskGenerator(**kw)(5, rng=np.random.default_rng(11))
    assert_same(got, want)


# ---------------------------------------------------------------- transforms


def test_clip_statistics_match_jax():
    assert CLIP_MEAN == j_image_utils.CLIP_MEAN and CLIP_STD == j_image_utils.CLIP_STD


def test_trim_text_matches_jax():
    for text in ("a photo of a cat", ["abcdef", "ab", ""]):
        assert TrimText(4)(text) == j_transforms.TrimText(4)(text)


@pytest.mark.parametrize("size", [5, (7, 3), (9, 12)])
def test_resize_image_matches_jax(size):
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (9, 12, 3), dtype=np.uint8),
                rng.standard_normal((9, 12)).astype(np.float32)):
        assert_same(resize_image(img, size), j_transforms.resize_image(img, size))


def test_normalize_crop_pad_and_img2seq_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((10, 8, 3)).astype(np.float32)
    assert_same(normalize_image(img), j_transforms.normalize_image(img))
    stats = ((0.2, 0.3, 0.4), (0.5, 0.6, 0.7))
    assert_same(normalize_image(img, *stats), j_transforms.normalize_image(img, *stats))
    for size in (4, 8, 12):
        assert_same(center_crop(img, size), j_transforms.center_crop(img, size))
    x = rng.standard_normal((3, 11)).astype(np.float32)
    for length, axis in ((11, -1), (5, -1), (16, -1), (5, 0)):
        assert_same(pad_or_trim(x, length, axis), j_transforms.pad_or_trim(x, length, axis))
    img = rng.standard_normal((18, 13, 3)).astype(np.float32)  # a ragged border
    assert_same(Img2Seq(16, 4)(img), j_tokenizers.Img2Seq(16, 4)(img))


# ---------------------------------------------------------------- tokenizers


@pytest.fixture(scope="module")
def bert_tokenizer(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "a", "cat", "dog", "photo", "of", "the"]
    path = tmp_path_factory.mktemp("tok") / "vocab.txt"
    path.write_text("\n".join(vocab))
    return transformers.BertTokenizer(str(path), do_lower_case=True)


@pytest.mark.parametrize("max_length", [4, 8])
def test_hf_tokenizer_matches_jax(bert_tokenizer, max_length):
    tok = HFTokenizer(tokenizer=bert_tokenizer, max_length=max_length)
    jtok = j_tokenizers.HFTokenizer(tokenizer=bert_tokenizer, max_length=max_length)
    for text in ("a photo of a cat", ["a cat", "a photo of the dog dog dog"]):
        got, want = tok(text), jtok(text)
        assert_same(got, want)
        assert got["text"].dtype == np.int32 and set(got) == {"text", "text_attention_mask"}


# ------------------------------------------------------------------ synthetic


def test_synthetic_datasets_match_jax_item_for_item():
    kw = dict(size=6, image_size=8, seq_len=5, vocab_size=50, num_classes=3, seed=4)
    ds = SyntheticImageText(**kw, with_target=True)
    jds = j_synthetic.SyntheticImageText(**kw, with_target=True)
    images, jimages = SyntheticImages(5, 8, seed=2), j_synthetic.SyntheticImages(5, 8, seed=2)
    assert len(ds) == len(jds) == 6 and len(images) == len(jimages) == 5
    for i in range(6):
        assert_same(dict(ds[i]), dict(jds[i]))
    for i in range(5):
        assert_same(dict(images[i]), dict(jimages[i]))
