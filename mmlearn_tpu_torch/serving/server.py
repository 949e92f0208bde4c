"""Embedding/search HTTP server over exported artifacts, counterpart of
:mod:`mmlearn_tpu.serving.server` (same endpoints, same flags, plus
``--device``)::

    python -m mmlearn_tpu_torch.serving.server \\
        --artifact outputs/run/artifacts/rgb \\
        --index outputs/run/index --index-modality rgb --port 8389

Endpoints (JSON in/out):

- ``GET /healthz`` -> ``{"status": "ok", "modality": ..., "index_rows": N}``
- ``POST /embed`` -- body ``{"inputs": {key: nested lists}}`` with exactly
  the keys in the artifact's ``meta.json["inputs"]`` -> ``{"embeddings":
  [[...], ...]}``. The leading batch dimension is free.
- ``POST /search`` -- body ``{"inputs": {...}, "k": 5}`` (needs ``--index``)
  -> ``{"scores": [[...]], "example_index": [[...]]}``; embeds, then queries
  the loaded :class:`EmbeddingIndex` on the same device.

All device work (encode and index queries) runs behind one lock, as in the
JAX server. One process serves one card.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from mmlearn_tpu_torch.serving.export import load_encoder
from mmlearn_tpu_torch.serving.index import EmbeddingIndex

logger = logging.getLogger(__name__)


class ServingState:
    """Loaded artifact (and optional index) shared by request handlers."""

    def __init__(
        self,
        artifact_dir: str,
        index_dir: Optional[str] = None,
        index_modality: Optional[str] = None,
        device: torch.device | str = "cuda",
    ) -> None:
        self.encode = load_encoder(artifact_dir, device=device)
        self.meta = self.encode.meta  # type: ignore[attr-defined]
        self.index = None
        if index_dir:
            self.index = EmbeddingIndex.load(
                index_dir, index_modality or self.meta["modality"], device=device
            )
            if self.index.normalized != bool(self.meta.get("normalized", True)):
                raise ValueError(
                    "artifact/index normalization mismatch: the encoder emits "
                    f"normalized={self.meta.get('normalized')} embeddings but the "
                    f"index holds normalized={self.index.normalized} vectors -- "
                    "cosine and raw inner-product scores cannot mix"
                )
        self._lock = threading.Lock()

    def _batch(self, inputs: dict[str, Any]) -> dict[str, np.ndarray]:
        want = set(self.meta["inputs"])
        got = set(inputs)
        if got != want:
            raise ValueError(
                f"inputs must have exactly the keys {sorted(want)}, got "
                f"{sorted(got)} (see the artifact's meta.json)"
            )
        return {
            k: np.asarray(v, dtype=self.meta["inputs"][k]["dtype"])
            for k, v in inputs.items()
        }

    def embed(self, inputs: dict[str, Any]) -> np.ndarray:
        batch = self._batch(inputs)
        with self._lock:
            return self.encode(batch).float().cpu().numpy()

    def search(self, inputs: dict[str, Any], k: int, approx: bool = False) -> dict[str, Any]:
        if self.index is None:
            raise ValueError("server started without --index")
        batch = self._batch(inputs)
        with self._lock:
            emb = self.encode(batch)
            scores, ids = self.index.query(emb, k=int(k), approx=bool(approx))
        return {"scores": scores.tolist(), "example_index": ids.tolist()}


def make_handler(state: ServingState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            return self._reply(200, {
                "status": "ok",
                "modality": state.meta["modality"],
                "embedding_dim": state.meta["embedding_dim"],
                "index_rows": len(state.index) if state.index is not None else None,
            })

        def do_POST(self):  # noqa: N802 - http.server API
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/embed":
                    emb = state.embed(req["inputs"])
                    return self._reply(200, {"embeddings": emb.tolist()})
                if self.path == "/search":
                    return self._reply(200, state.search(
                        req["inputs"], req.get("k", 10), approx=req.get("approx", False)
                    ))
                return self._reply(404, {"error": "unknown path"})
            except (KeyError, ValueError, TypeError) as err:
                return self._reply(400, {"error": str(err)})
            except Exception as err:  # noqa: BLE001 - a request must not kill the server
                logger.exception("request failed")
                return self._reply(500, {"error": f"{type(err).__name__}: {err}"})

    return Handler


def serve(
    artifact_dir: str,
    port: int = 8389,
    index_dir: Optional[str] = None,
    index_modality: Optional[str] = None,
    host: str = "127.0.0.1",
    device: torch.device | str = "cuda",
) -> ThreadingHTTPServer:
    """Build the server (the caller runs ``serve_forever``)."""
    state = ServingState(artifact_dir, index_dir, index_modality, device)
    return ThreadingHTTPServer((host, port), make_handler(state))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--index", default=None)
    ap.add_argument("--index-modality", default=None)
    ap.add_argument("--port", type=int, default=8389)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    logging.basicConfig(level="INFO")
    server = serve(
        args.artifact, port=args.port, index_dir=args.index,
        index_modality=args.index_modality, host=args.host, device=args.device,
    )
    logger.info("serving on %s:%d (%s)", args.host, args.port, args.device)
    server.serve_forever()


if __name__ == "__main__":
    main()
