"""The PyTorch port runs where JAX is absent, and ``chip_smoke.py`` has no
CPU fallback.

Both checks run in subprocesses: the test process itself has JAX loaded.
"""

import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mmlearn_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, NoJax())
import mmlearn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmlearn_tpu_torch.__path__,
                                               "mmlearn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
assert not leaked, leaked
print(len(names), "modules")
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300, check=False)


def test_every_module_imports_without_jax_or_flax():
    proc = _run([sys.executable, "-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 20  # every module was walked


def test_chip_smoke_fails_without_a_cuda_card(tmp_path):
    if not torch.cuda.is_available():
        # no CUDA card: the script must refuse, not fall back
        proc = _run([sys.executable, "chip_smoke.py"], REPO)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package it drives, it fails anywhere
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
