"""Phase 17's limits against faulty copies of the row-parallel product.

For each fault, copies ``chip_smoke.py`` and ``mmlearn_tpu_torch/`` to
``build/mutants/tp_<fault>/``, edits the row split's output hook in
``parallel/tensor_parallel.py`` there, and runs ``chip_smoke.tp_phase`` in
the copy (the kernels it launches are built once, in this checkout, and
shared). Each copy must fail
one of phase 17's checks; the readings its lines print are what a fault
reads against the limits.

- ``no_reduce``: the row split's partial products are taken as the whole
  product, not all-reduced over the ``model`` group;
- ``bias_twice``: each rank adds the bias to its partial product before the
  all-reduce, so the sum holds it twice.

On a host with one CUDA card, from the root of a checkout::

    python tools/tp_mutants.py [--sound]

``--sound`` runs phase 17 in the checkout first. Prints one line a run:
its exit code and the phase's reading lines.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join("mmlearn_tpu_torch", "parallel", "tensor_parallel.py")
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as c; "
       "sys.modules['chip_smoke'] = c; from mmlearn_tpu_torch import _build; "
       "[_build.build(n) for n in ('fused_attention', 'layernorm_fwd', 'layernorm_bwd', "
       "'flash_attention')]; "
       "c.tp_phase(torch.device('cuda', 0))")

_SOUND = """            outputs = outputs.redistribute(placements=output_layouts)
            if bias is not None:
                outputs = outputs + bias.to(outputs.dtype)
"""
FAULTS = {
    "no_reduce": """            from torch.distributed.tensor import DTensor

            outputs = DTensor.from_local(outputs.to_local(), device_mesh, output_layouts,
                                         run_check=False)
            if bias is not None:
                outputs = outputs + bias.to(outputs.dtype)
""",
    "bias_twice": """            from torch.distributed.tensor import DTensor

            if bias is not None:
                outputs = DTensor.from_local(
                    outputs.to_local() + bias.to_local().to(outputs.dtype), device_mesh,
                    outputs.placements, run_check=False)
            outputs = outputs.redistribute(placements=output_layouts)
""",
}


def copy_with(fault: str) -> str:
    """The faulty copy's root, made anew."""
    root = os.path.join(REPO, "build", "mutants", f"tp_{fault}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "mmlearn_tpu_torch"),
                    os.path.join(root, "mmlearn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    os.makedirs(os.path.join(root, "build"))
    os.symlink(os.path.join(REPO, "build", "kernels"), os.path.join(root, "build", "kernels"))
    path = os.path.join(root, TARGET)
    with open(path) as f:
        source = f.read()
    # the row split's reduction and bias add, in its output hook, replaced whole
    if _SOUND not in source:
        raise SystemExit(f"{TARGET}: the row-parallel output hook is not where this tool "
                         "expects it")
    source = source.replace(_SOUND, FAULTS[fault], 1)
    with open(path, "w") as f:
        f.write(source)
    return root


def run(label: str, root: str) -> int:
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if ln.startswith(("tensor-parallel path", "chip_smoke.SmokeError"))]
    print(f"{label}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    print("\n".join(f"  {ln}" for ln in lines), flush=True)
    return proc.returncode


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sound", action="store_true", help="run phase 17 in the checkout first")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from mmlearn_tpu_torch import _build

    for name in ("fused_attention", "layernorm_fwd", "layernorm_bwd", "flash_attention"):
        _build.build(name)
    failed = []
    if args.sound and run("sound", REPO) != 0:
        failed.append("sound")
    for fault in FAULTS:
        if run(fault, copy_with(fault)) == 0:
            failed.append(fault)
    print("every faulty copy failed phase 17" if not failed else f"unexpected: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
