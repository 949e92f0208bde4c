"""Serving: encoder artifacts, the embedding index and the HTTP server.

The names are imported on first use, so that loading an artifact
(``serving.export.load_encoder``) imports nothing of the port's model code.
``server`` is not imported here, so that ``python -m
mmlearn_tpu_torch.serving.server`` runs it once as ``__main__``.
"""

import importlib

_NAMES = {"EmbeddingIndex": "index", "export_encoder": "export", "load_encoder": "export",
          "save_encoder": "export"}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
