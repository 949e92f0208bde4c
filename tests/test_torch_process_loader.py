"""The port's process loader (``datasets/core/grain_loader.py``: torch
``DataLoader`` workers started by ``spawn``) against the port's thread
``DataLoader``, on the CPU: TFRecord shards of the JPEG fixtures, decoded by
the native train path under per-record seeds, shuffled, the last batch
padded, over 2 epochs: every batch equal, bit for bit, with its
``batch_validity``. This module imports no JAX, so that the workers, which
import it to unpickle its dataset, start quickly.
"""

import glob
import os
import pathlib

import numpy as np
import pytest

from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import ImageTransform, decode_transform_jpeg
from mmlearn_tpu_torch.datasets.core import (
    CombinedDataset,
    DataLoader,
    Example,
    StreamingDataset,
    TFRecordDataset,
)
from mmlearn_tpu_torch.datasets.core.grain_loader import GrainDataLoader
from mmlearn_tpu_torch.datasets.core.tfrecord import encode_tf_example, write_tfrecord

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "jpeg", "*.jpg")))


class JpegPairs:
    """``to_example`` of the JPEG records: the ``jpeg`` feature through
    ``decode`` and ``transform``, seeded by ``(seed, index)`` so that every
    process draws the same crop; ``tokens`` and ``index`` as they are."""

    def __init__(self, transform, decode=decode_transform_jpeg, example_cls=Example,
                 seed: int = 0) -> None:
        self.transform, self.decode, self.example_cls, self.seed = (transform, decode,
                                                                    example_cls, seed)

    def __call__(self, features):
        idx = int(features["index"][0])
        rgb = self.decode(features["jpeg"][0], self.transform,
                          rng=np.random.default_rng((self.seed, idx)))
        return self.example_cls({"rgb": rgb, "text": features["tokens"].astype(np.int32),
                                 EXAMPLE_INDEX_KEY: idx})


def write_jpeg_shards(out_dir, n: int, shards: int, tokens: np.ndarray):
    """``n`` records over ``shards`` shards: a fixture's JPEG bytes (the
    smallest files first), the token pattern ``tokens[k]`` of its class k
    and its index."""
    files = [pathlib.Path(p).read_bytes() for p in sorted(FIXTURES, key=os.path.getsize)]
    classes = len(tokens)
    paths = []
    for s in range(shards):
        paths.append(os.path.join(str(out_dir), f"jpeg-{s:05d}.tfrecord"))
        write_tfrecord(paths[-1], (encode_tf_example({
            "jpeg": files[i % len(files)], "tokens": tokens[i % classes],
            "label": i % classes, "index": i}) for i in range(s, n, shards)))
    return paths


def batches(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def test_process_loader_batches_equal_the_thread_loader(tmp_path):
    shards = write_jpeg_shards(tmp_path, n=11, shards=2,
                               tokens=np.random.default_rng(0).integers(2, 99, (4, 8)))
    ds = TFRecordDataset(shards, to_example=JpegPairs(ImageTransform(
        size=32, train=True, device_normalize=True)), verify_crc=True)
    kw = dict(batch_size=4, shuffle=True, seed=3, pad_partial_batches=True)
    want = batches(DataLoader(ds, num_workers=2, **kw))
    for workers in (0, 2):
        loader = GrainDataLoader(ds, num_workers=workers, **kw)
        got = batches(loader)
        loader.close()
        assert len(got[0]) == len(want[0]) == 3
        for g_epoch, w_epoch in zip(got, want):
            for g, w in zip(g_epoch, w_epoch):
                assert list(g) == list(w)
                for key in w:
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert want[0][-1]["batch_validity"].tolist() == [True, True, True, False]
    assert want[0][0]["rgb"].dtype == np.uint8 and want[0][0]["rgb"].shape == (4, 32, 32, 3)
    orders = [[b[EXAMPLE_INDEX_KEY].tolist() for b in epoch] for epoch in want]
    assert orders[0] != orders[1]


def test_process_loader_refuses_streams():
    stream = StreamingDataset(["a"], lambda s: iter([]), rank=0, world_size=1)
    with pytest.raises(ValueError, match="iterable/streaming"):
        GrainDataLoader(CombinedDataset([stream]), num_workers=2)
    assert len(GrainDataLoader(list(range(10)), batch_size=4, num_workers=0)) == 3
    assert len(GrainDataLoader(list(range(10)), batch_size=4, drop_last=True,
                               num_workers=0)) == 2
