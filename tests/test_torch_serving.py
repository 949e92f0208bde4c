"""Serving path of the PyTorch port: artifacts, the embedding index and the
HTTP server, against the JAX package on the CPU.

The port's towers carry the JAX task's weights (``mmlearn_tpu_torch.bridge``),
so served embeddings must equal the JAX ``task.encode`` in f32, and index
queries must return the JAX index's ids and scores.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from mmlearn_tpu.serving import EmbeddingIndex as JIndex
from mmlearn_tpu.serving import save_encoder as jax_save_encoder
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.metrics import retrieval_recall as rr
from mmlearn_tpu_torch.serving import EmbeddingIndex, load_encoder, save_encoder
from mmlearn_tpu_torch.serving import index as index_mod
from mmlearn_tpu_torch.serving.server import serve
from tests.test_torch_encoders import tiny_pair

ATOL = 1e-5


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _write_index(path, emb, normalized=True, name="rgb_00000.npz", manifest="manifest.json",
                 rows=None):
    rows = np.arange(len(emb)) if rows is None else np.asarray(rows)
    np.savez(path / name, embeddings=emb, example_index=rows,
             dataset_index=np.zeros(len(rows), np.int64))
    (path / manifest).write_text(json.dumps(
        {"rgb": {"shards": [name], "rows": len(rows), "dim": emb.shape[1],
                 "normalized": normalized}}))


@pytest.fixture
def served(tmp_path):
    """Port artifacts of the tiny towers, an index of 8 corpus images
    embedded by JAX, and two running servers (rgb->rgb, text->rgb)."""
    jtask, params, batch, ptask = tiny_pair()
    text_batch = dict(batch, text_attention_mask=np.ones((4, 8), np.int32))
    save_encoder(str(tmp_path / "rgb"), ptask, "rgb", {"rgb": batch["rgb"]})
    save_encoder(str(tmp_path / "text"), ptask, "text",
                 {k: text_batch[k] for k in ("text", "text_attention_mask")})
    corpus = np.random.default_rng(3).standard_normal((8, 16, 16, 3)).astype(np.float32)
    (tmp_path / "index").mkdir()
    _write_index(tmp_path / "index",
                 np.asarray(jtask.encode(params, {"rgb": corpus}, "rgb", normalize=True)))
    servers = [
        serve(str(tmp_path / "rgb"), port=0, index_dir=str(tmp_path / "index"),
              device="cpu"),
        serve(str(tmp_path / "text"), port=0, index_dir=str(tmp_path / "index"),
              index_modality="rgb", device="cpu"),
    ]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        yield jtask, params, corpus, [s.server_address[1] for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()


def test_server_healthz_embed_search(served):
    jtask, params, corpus, (rport, _) = served
    with urllib.request.urlopen(f"http://127.0.0.1:{rport}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "modality": "rgb", "embedding_dim": 16,
                      "index_rows": 8}

    q = corpus[:3]
    status, out = _post(rport, "/embed", {"inputs": {"rgb": q.tolist()}})
    assert status == 200
    want = np.asarray(jtask.encode(params, {"rgb": q}, "rgb", normalize=True))
    np.testing.assert_allclose(np.asarray(out["embeddings"]), want, atol=ATOL)

    for approx in (False, True):  # approx is answered exactly
        status, out = _post(rport, "/search",
                            {"inputs": {"rgb": q.tolist()}, "k": 2, "approx": approx})
        assert status == 200
        assert np.asarray(out["example_index"])[:, 0].tolist() == [0, 1, 2]
        np.testing.assert_allclose(np.asarray(out["scores"])[:, 0], 1.0, atol=ATOL)


def test_server_text_tower_with_mask(served):
    jtask, params, _, (_, tport) = served
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 30, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 4:] = 0
    inputs = {"text": ids.tolist(), "text_attention_mask": mask.tolist()}
    status, out = _post(tport, "/embed", {"inputs": inputs})
    assert status == 200
    want = np.asarray(jtask.encode(
        params, {"text": ids, "text_attention_mask": mask}, "text", normalize=True))
    np.testing.assert_allclose(np.asarray(out["embeddings"]), want, atol=ATOL)
    status, out = _post(tport, "/search", {"inputs": inputs, "k": 3})
    assert status == 200 and np.asarray(out["example_index"]).shape == (3, 3)


def test_server_rejects_wrong_keys_and_paths(served):
    _, _, corpus, (rport, tport) = served
    status, out = _post(rport, "/embed", {"inputs": {"wrong": [1]}})
    assert status == 400 and "exactly the keys" in out["error"]
    status, out = _post(tport, "/embed", {"inputs": {"text": [[1, 2]]}})
    assert status == 400 and "text_attention_mask" in out["error"]
    status, _ = _post(rport, "/nope", {})
    assert status == 404


def test_artifact_weights_are_keyed_by_jax_paths(tmp_path):
    jtask, params, batch, ptask = tiny_pair()
    save_encoder(str(tmp_path / "port"), ptask, "rgb", {"rgb": batch["rgb"]})
    jax_save_encoder(str(tmp_path / "jax"), jtask, params, "rgb",
                     {"rgb": batch["rgb"]}, platforms=("cpu",))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jmeta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert set(meta) == set(jmeta)
    for key in ("modality", "normalized", "embedding_dim", "inputs"):
        assert meta[key] == jmeta[key]

    weights = bridge.load_npz(str(tmp_path / "port" / "weights.npz"))
    want = bridge.flatten(jax.device_get(params["encoders"]["rgb"]))
    assert sorted(weights) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(weights[k], want[k])

    encode = load_encoder(str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(
        encode({"rgb": batch["rgb"]}).numpy(),
        np.asarray(jtask.encode(params, {"rgb": batch["rgb"]}, "rgb", normalize=True)),
        atol=ATOL,
    )


def _corpus(seed=3):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((101, 8)).astype(np.float32)  # uneven vs 16
    q = rng.standard_normal((7, 8)).astype(np.float32)
    return (emb / np.linalg.norm(emb, axis=1, keepdims=True),
            q / np.linalg.norm(q, axis=1, keepdims=True))


@pytest.mark.parametrize("k,block_size", [(5, None), (5, 16), (13, 16), (3, 101)])
def test_index_query_matches_jax(k, block_size):
    """Full-axis and forced-blockwise queries return the JAX index's ids and
    scores (block_size=101 is unusable and keeps the memory routing)."""
    emb, q = _corpus()
    want_s, want_i = JIndex(emb).query(q, k=k, block_size=block_size)
    got_s, got_i = EmbeddingIndex(emb).query(q, k=k, block_size=block_size)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL)
    np.testing.assert_array_equal(got_i, want_i)


def test_index_memory_routing_streams_past_the_budget(monkeypatch):
    emb, q = _corpus(5)
    index = EmbeddingIndex(emb)
    want_s, want_i = JIndex(emb).query(q, k=5)
    monkeypatch.setattr(rr, "TOPK_SIM_BYTES_BUDGET", 0)
    monkeypatch.setattr(rr, "TOPK_BLOCK", 16)

    def full_axis_forbidden(*a, **kw):
        raise AssertionError("full-axis similarity past the budget")

    monkeypatch.setattr(index_mod, "_topk_scores_chunk", full_axis_forbidden)
    for block in (None, 4):  # 4 < k: unusable, memory routing again
        s, i = index.query(q, k=5, block_size=block)
        np.testing.assert_allclose(s, want_s, atol=ATOL)
        np.testing.assert_array_equal(i, want_i)


def test_index_load_merges_dedups_and_checks_normalization(tmp_path):
    for p, rows in ((0, [0, 1, 2]), (1, [2, 3, 4])):  # row 2 exported twice
        _write_index(tmp_path, np.eye(8, dtype=np.float32)[rows],
                     name=f"rgb_p{p}_00000.npz", manifest=f"manifest_p{p}.json",
                     rows=rows)
    index = EmbeddingIndex.load(str(tmp_path), "rgb")
    assert len(index) == 5
    assert len(EmbeddingIndex.load(str(tmp_path), "rgb", dedup=False)) == 6
    scores, ids = index.query(np.eye(8, dtype=np.float32)[:5], k=1)
    assert ids[:, 0].tolist() == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(scores[:, 0], 1.0)

    _write_index(tmp_path, np.eye(8, dtype=np.float32)[[5]], normalized=False,
                 name="rgb_p2_00000.npz", manifest="manifest_p2.json", rows=[5])
    with pytest.raises(ValueError, match="normalized"):
        EmbeddingIndex.load(str(tmp_path), "rgb")
