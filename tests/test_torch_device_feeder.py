"""``DeviceFeeder``, the port's device input pipeline.

On the CPU these mirror ``tests/datasets/test_device_feeder.py``: order
with ``normalize``, a producer exception raised in the consumer, a stalled
source timing out, an early close that releases the producer, and no
reference held to a yielded batch; and the feeder's placement rules (numpy
arrays by ``torch.from_numpy``, strings and python values untouched, no
fallback for a CUDA device without CUDA). The ``cuda`` tests hold the
card's path: pinned staging buffers reused in a ring, the copies and
``normalize`` on the feeder's stream, the consumer's wait on its event,
``record_stream``, tensors already on the card passed through, and every
batch intact while a step on the compute stream reads it. The file imports
no JAX, so that its ``cuda`` tests run on the card's host:
``python -m pytest --noconftest -m cuda tests/test_torch_device_feeder.py``.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from mmlearn_tpu_torch.datasets.core.loader import DeviceFeeder


def _batches(n, size=4):
    for i in range(n):
        yield {"x": np.full((size, 3), i, np.uint8), "i": np.asarray(i, np.int32)}


def test_yields_all_batches_in_order_with_normalize():
    def normalize(b):
        return {"x": b["x"].float() / 255.0, "i": b["i"]}

    with DeviceFeeder(_batches(5), "cpu", normalize=normalize, prefetch=2) as feeder:
        seen = list(feeder)
    assert [int(b["i"]) for b in seen] == list(range(5))
    assert seen[3]["x"].dtype == torch.float32
    np.testing.assert_allclose(seen[3]["x"].numpy(), 3 / 255.0, rtol=1e-6)
    assert feeder.wait_s >= 0.0


def test_cpu_placement_shares_memory_and_keeps_other_values():
    """On the CPU a C-contiguous array becomes a tensor over the same
    memory; strided arrays are copied; strings, lists of strings, python
    numbers and tuples keep their form."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    item = {"a": arr, "t": arr.T, "s": ["x", "y"], "n": 3, "nested": {"b": np.ones(2, bool)},
            "pair": (np.zeros(1, np.int64), "z")}
    with DeviceFeeder([item], "cpu") as feeder:
        (out,) = list(feeder)
    assert out["a"].data_ptr() == torch.from_numpy(arr).data_ptr()
    assert torch.equal(out["t"], torch.from_numpy(arr.T.copy()))
    assert out["s"] == ["x", "y"] and out["n"] == 3
    assert out["nested"]["b"].dtype == torch.bool and isinstance(out["pair"], tuple)
    assert out["pair"][1] == "z" and out["pair"][0].dtype == torch.int64


def test_device_put_gets_the_item_and_the_placement():
    def device_put(item, place):
        idx, batch = item
        return idx, batch, place(batch)

    source = ((i, {"x": np.full((2,), i, np.int32)}) for i in range(3))
    with DeviceFeeder(source, "cpu", device_put=device_put) as feeder:
        for i, (idx, host, placed) in enumerate(feeder):
            assert idx == i and isinstance(host["x"], np.ndarray)
            assert torch.equal(placed["x"], torch.full((2,), i, dtype=torch.int32))


def test_producer_exception_surfaces():
    def bad_source():
        yield {"x": np.zeros(2)}
        raise RuntimeError("decode failed")

    with DeviceFeeder(bad_source(), "cpu") as feeder:
        it = iter(feeder)
        next(it)
        with pytest.raises(RuntimeError, match="decode failed"):
            next(it)


def test_dead_source_times_out_instead_of_hanging():
    forever = threading.Event()

    def stalled_source():
        yield {"x": np.zeros(2)}
        forever.wait(60)  # a wedged decoder
        yield {"x": np.zeros(2)}

    feeder = DeviceFeeder(stalled_source(), "cpu", timeout_s=0.5)
    try:
        it = iter(feeder)
        next(it)
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="no batch within"):
            next(it)
        assert time.perf_counter() - t0 < 5
    finally:
        forever.set()
        feeder.close()


def test_early_close_releases_producer():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((2,), i)}

    feeder = DeviceFeeder(source(), "cpu", prefetch=2)
    it = iter(feeder)
    next(it)
    feeder.close()
    n_at_close = len(produced)
    time.sleep(0.3)
    assert len(produced) <= n_at_close + 2
    assert not feeder._thread.is_alive()


def test_feeder_holds_no_reference_to_yielded_batches():
    refs = []
    with DeviceFeeder(_batches(3), "cpu", prefetch=1) as feeder:
        for batch in feeder:
            refs.append(weakref.ref(batch["x"]))
            del batch
        assert feeder._queue.qsize() == 0
    gc.collect()
    assert all(r() is None for r in refs)


def test_a_cuda_feeder_without_cuda_raises(monkeypatch):
    """No fallback to the CPU: a feeder for the card needs the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeeder(_batches(1), "cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        DeviceFeeder(_batches(1), "meta")


# ---------------------------------------------------------------- the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the feeder's pinned staging and stream)")


@pytest.mark.cuda
def test_cuda_placement_pins_streams_and_passes_device_tensors():
    """Arrays go through pinned buffers, reused in a ring of prefetch + 2
    per key; the copies run on the feeder's stream, not the consumer's;
    tensors already on the card pass through without a copy."""
    _need_card()
    resident = torch.arange(6, device="cuda")

    def source():
        for i in range(9):
            yield {"x": np.full((64, 3), i, np.uint8), "keep": resident}

    with DeviceFeeder(source(), "cuda", prefetch=2) as feeder:
        for i, batch in enumerate(feeder):
            assert batch["x"].is_cuda and int(batch["x"][0, 0]) == i
            assert batch["keep"] is resident
        ring = feeder._rings[("x",)]
        assert len(ring) == 4 and all(buf.is_pinned() for buf, _ in ring)
        assert feeder._stream != torch.cuda.current_stream()


@pytest.mark.cuda
def test_cuda_batches_stay_intact_under_a_step_on_the_compute_stream():
    """Each batch, read back after a long step on the compute stream has
    used it, equals its host batch: a staging buffer reused too early or a
    missing record_stream would show as another batch's values."""
    _need_card()
    w = torch.randn(2048, 2048, device="cuda")
    host = [np.random.default_rng(i).integers(0, 256, (256, 2048), dtype=np.uint8)
            for i in range(12)]

    def normalize(b):
        return {"x": b["x"].float()}

    source = ({"x": x} for x in host)
    with DeviceFeeder(source, "cuda", normalize=normalize, prefetch=2) as feeder:
        for i, batch in enumerate(feeder):
            y = batch["x"]
            for _ in range(20):
                y = torch.tanh(y @ w)  # keep the compute stream busy
            del y
            got = batch["x"].cpu().numpy()
            np.testing.assert_array_equal(got, host[i].astype(np.float32))
