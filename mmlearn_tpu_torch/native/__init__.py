"""The port's native host code, loaded with ctypes: a counterpart of
:mod:`mmlearn_tpu.native` (``decode_jpeg_batch`` :132, ``decode_jpeg`` :161,
``crc32c`` :179, ``decode_jpeg_train`` :191, ``decode_jpeg_batch_train``
:213).

``csrc/fastloader.cpp`` (the JAX package's ``fastloader.cpp`` with the same
C ABI) decodes JPEGs with libjpeg on a C++ thread pool and computes CRC-32C.
It is built at first use by :func:`mmlearn_tpu_torch._build.build_host`
into ``build/host/``, twice from the one source: the whole library, linked
with ``-ljpeg``, for the decoders, and its CRC-32C alone
(``-DFASTLOADER_CRC_ONLY``, no libjpeg) for the TFRecord reader, so that
records can be read and checked on a host without libjpeg. Unlike the JAX
package, which logs and falls back to PIL, a missing compiler, a missing
libjpeg or a failed build raises.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Sequence

import numpy as np

from mmlearn_tpu_torch import _build

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p  # every pointer, as _build's binding rule says


def has_libjpeg() -> bool:
    """Whether ``g++`` here compiles and links a program against libjpeg
    (``jpeglib.h`` and ``-ljpeg``): the JPEG decoders need both."""
    if shutil.which("g++") is None:
        return False
    src = "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_std_error(0); }\n"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(["g++", "-x", "c++", "-", "-ljpeg", "-o", os.path.join(tmp, "a")],
                              input=src, capture_output=True, text=True, check=False)
    return proc.returncode == 0


def _declare_crc(lib: ctypes.CDLL) -> None:
    lib.fl_crc32c.restype = ctypes.c_uint32
    lib.fl_crc32c.argtypes = [_P, ctypes.c_size_t, ctypes.c_uint32]


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    _declare_crc(lib)
    lib.fl_decode_jpeg_resize.restype = ctypes.c_int
    lib.fl_decode_jpeg_resize.argtypes = [_P, ctypes.c_size_t, ctypes.c_int, _P]
    lib.fl_decode_jpeg_train.restype = ctypes.c_int
    lib.fl_decode_jpeg_train.argtypes = [
        _P, ctypes.c_size_t, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint64, _P]
    lib.fl_decode_jpeg_batch.restype = ctypes.c_int
    lib.fl_decode_jpeg_batch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int]
    lib.fl_decode_jpeg_batch_train.restype = ctypes.c_int
    lib.fl_decode_jpeg_batch_train.argtypes = [
        _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _P, _P, ctypes.c_int]


def _library(kind: str) -> ctypes.CDLL:
    """The loaded library ``"jpeg"`` (the whole fastloader) or ``"crc"``
    (its CRC-32C alone), built at first use; one load a process."""
    with _LOCK:
        if kind not in _LIBS:
            if kind == "crc":
                lib = ctypes.CDLL(_build.build_host("fastloader",
                                                    flags=("-DFASTLOADER_CRC_ONLY",)))
                _declare_crc(lib)
            else:
                try:
                    lib = ctypes.CDLL(_build.build_host("fastloader",
                                                        libs=("-ljpeg", "-lpthread")))
                except (RuntimeError, OSError) as err:  # no build, or no libjpeg to load
                    raise RuntimeError(
                        "the fastloader's JPEG decoders need libjpeg (jpeglib.h and -ljpeg) "
                        f"and g++; building or loading csrc/fastloader.cpp failed:\n{err}"
                    ) from None
                _declare_jpeg(lib)
            _LIBS[kind] = lib
        return _LIBS[kind]


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    return int(_library("crc").fl_crc32c(data, len(data), crc & 0xFFFFFFFF))


def _blob(jpegs: Sequence[bytes]) -> tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(jpegs) + 1, dtype=np.uintp)
    np.cumsum([len(j) for j in jpegs], out=offsets[1:])
    return b"".join(jpegs), offsets


def _check_failures(failures: int, n: int) -> None:
    if failures:
        logger.warning("fastloader: %d/%d JPEGs failed to decode (zeroed)", failures, n)


def decode_jpeg(jpeg: bytes, out_size: int) -> np.ndarray:
    """Eval-path decode: the shorter side to ``out_size``, centre crop ->
    ``(out_size, out_size, 3)`` uint8. Raises ``ValueError`` if it fails."""
    lib = _library("jpeg")
    out = np.empty((out_size, out_size, 3), dtype=np.uint8)
    if lib.fl_decode_jpeg_resize(jpeg, len(jpeg), out_size, out.ctypes.data) != 0:
        raise ValueError("JPEG decode failed")
    return out


def decode_jpeg_train(
    jpeg: bytes,
    out_size: int,
    scale: tuple[float, float] = (0.6, 1.0),
    hflip_prob: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """Train-path decode: random-resized crop (area in ``scale``) and a
    horizontal flip with ``hflip_prob``, drawn from ``seed``. Raises
    ``ValueError`` if it fails."""
    lib = _library("jpeg")
    out = np.empty((out_size, out_size, 3), dtype=np.uint8)
    rc = lib.fl_decode_jpeg_train(jpeg, len(jpeg), out_size, float(scale[0]), float(scale[1]),
                                  float(hflip_prob), int(seed) & (2**64 - 1), out.ctypes.data)
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out


def decode_jpeg_batch(jpegs: Sequence[bytes], out_size: int, n_threads: int = 0) -> np.ndarray:
    """The eval path over a batch on ``n_threads`` threads (0: one a core)
    -> ``(N, out_size, out_size, 3)`` uint8; a failed image is zeroed,
    counted and logged."""
    lib = _library("jpeg")
    blob, offsets = _blob(jpegs)
    out = np.empty((len(jpegs), out_size, out_size, 3), dtype=np.uint8)
    failures = lib.fl_decode_jpeg_batch(blob, offsets.ctypes.data, len(jpegs), out_size,
                                        out.ctypes.data, n_threads)
    _check_failures(failures, len(jpegs))
    return out


def decode_jpeg_batch_train(
    jpegs: Sequence[bytes],
    out_size: int,
    seeds: Sequence[int],
    scale: tuple[float, float] = (0.6, 1.0),
    hflip_prob: float = 0.5,
    n_threads: int = 0,
) -> np.ndarray:
    """The train path over a batch, one seed an image, on ``n_threads``
    threads (0: one a core); a failed image is zeroed, counted and logged."""
    lib = _library("jpeg")
    n = len(jpegs)
    seed_arr = np.asarray(seeds, dtype=np.uint64)
    if seed_arr.shape != (n,):  # the C side reads seeds[0..n-1]
        raise ValueError(f"seeds must have exactly one entry per image: got {seed_arr.shape} "
                         f"for {n} images")
    blob, offsets = _blob(jpegs)
    out = np.empty((n, out_size, out_size, 3), dtype=np.uint8)
    failures = lib.fl_decode_jpeg_batch_train(
        blob, offsets.ctypes.data, n, out_size, float(scale[0]), float(scale[1]),
        float(hflip_prob), seed_arr.ctypes.data, out.ctypes.data, n_threads)
    _check_failures(failures, n)
    return out
