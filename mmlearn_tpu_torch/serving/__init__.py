"""Serving: encoder artifacts, the embedding index and the HTTP server.

``server`` is not imported here, so that ``python -m
mmlearn_tpu_torch.serving.server`` runs it once as ``__main__``.
"""

from mmlearn_tpu_torch.serving.export import load_encoder, save_encoder
from mmlearn_tpu_torch.serving.index import EmbeddingIndex

__all__ = ["EmbeddingIndex", "load_encoder", "save_encoder"]
