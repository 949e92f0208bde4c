"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. :func:`load_library`
compiles it at first use into ``build/kernels/`` at the root of the checkout
(``-gencode arch=compute_90a,code=sm_90a``), named by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, so that an edited source or
header is rebuilt and an unchanged one is reused, and loads it with
:mod:`ctypes`. A missing ``nvcc`` or a failed
build raises: there is no fallback.

Binding rule: the wrapper of every entry point declares ``argtypes`` with
``ctypes.c_void_p`` for each pointer and for the stream, or ctypes would pass
them as 32-bit ints and cut them.

Host C++ (``csrc/<name>.cpp``, code the card never runs) builds the same way
with ``g++`` through :func:`build_host` into ``build/host/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "host")
HOST_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$PATH`` first, then ``$CUDA_HOME`` and the usual
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content, that of every
    header in ``csrc/`` (a source may include any of them) and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for file in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, file), "rb") as f:
            digest.update(file.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]


def host_commands(name: str, flags: tuple = (), libs: tuple = ()) -> list:
    """The ``g++`` commands that build ``csrc/<name>.cpp``, each without its
    output path, in the order tried: with ``-march=native``, then without
    (the JAX package's order)."""
    src = os.path.join(CSRC_DIR, f"{name}.cpp")
    base = [*HOST_FLAGS, *flags, src, *libs]
    return [["g++", "-march=native", *base], ["g++", *base]]


def build_host(name: str, flags: tuple = (), libs: tuple = ()) -> str:
    """Compile the host C++ source ``csrc/<name>.cpp`` with ``g++`` unless
    its library exists, into ``build/host/lib<name>-<hash>.so``, keyed by
    the source and the flags. Returns its path. Where every command fails
    it raises with the compiler's output: there is no fallback."""
    commands = host_commands(name, flags, libs)
    digest = hashlib.sha1(repr(("-march=native", HOST_FLAGS, flags, libs)).encode())
    with open(os.path.join(CSRC_DIR, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    out = os.path.join(HOST_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found on PATH: csrc/{name}.cpp is built at first use")
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    errors = []
    for cmd in commands:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True, check=False)
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: another process never sees half a file
            return out
        errors.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(f"g++ failed building csrc/{name}.cpp:\n" + "\n".join(errors))
