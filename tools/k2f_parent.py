"""K2f against an earlier ``ops/fused_norm.py``: its bits and its device time, in turns on one card.

At ``chip_smoke.py``'s K2 grids (``NORM_GRIDS``, ``BIOSCAN_NORM_GRIDS``,
``LARGE_NORM_GRIDS``; bf16, ``chip_smoke.norm_batch_inputs``), for LN and
add+LN, this checkout's ``fused_layernorm`` / ``fused_add_layernorm`` and the
parent's (the file at PATH, loaded beside this checkout's package): whether
``y`` (and ``r``) are equal bit for bit, and each one's device time alone
(``chip_smoke.device_ms``, L2 cold where the operands fit in it) in turns,
parent, change, change, parent, with its share of the bound. Stage the
parent's file under the gitignored ``build/`` and run from the root of a
checkout::

    mkdir -p build/parent && git archive HEAD~1 mmlearn_tpu_torch/ops/fused_norm.py \\
        | tar -x -C build/parent
    python tools/k2f_parent.py build/parent/mmlearn_tpu_torch/ops/fused_norm.py

Needs a CUDA card; exits 1 without one, or where any output's bits differ.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("k2f_parent: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mmlearn_tpu_torch.ops import fused_norm as change

    spec = importlib.util.spec_from_file_location("fused_norm_parent", argv[0])
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    differ = 0
    grids = (*cs.NORM_GRIDS, *cs.BIOSCAN_NORM_GRIDS, *cs.LARGE_NORM_GRIDS)
    for label, _, x, br, _, _, g, beta in cs.norm_batch_inputs(dev, grids):
        for variant, add in (("LN", False), ("add+LN", True)):
            calls = {name: ((lambda m=m: (m.fused_layernorm(x, g, beta), None)) if not add
                            else (lambda m=m: m.fused_add_layernorm(x, br, g, beta)[::-1]))
                     for name, m in (("parent", parent), ("change", change))}
            (y0, r0), (y1, r1) = calls["parent"](), calls["change"]()
            same = torch.equal(y0, y1) and (r0 is None or torch.equal(r0, r1))
            differ += not same
            moved = (x, x, g, beta) if not add else (x, br, x, x, g, beta)
            cold = cs.nbytes(*moved) < cs.L2_BYTES
            bnd = cs.bound(cs.nbytes(*moved), 0, "bfloat16")[0]
            times = {"parent": [], "change": []}
            for name in ("parent", "change", "change", "parent"):
                times[name].append(cs.device_ms(calls[name], cold))
            print(f"K2f {variant} {label} (bound {bnd:.4f} ms, L2 {'cold' if cold else 'warm'}): "
                  f"bits equal the parent's {'yes' if same else 'NO'}; "
                  + "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms "
                              f"({bnd / min(ts):.1%})" for name, ts in times.items()),
                  flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
