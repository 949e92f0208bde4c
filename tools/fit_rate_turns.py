"""The flagship ``Trainer.fit`` rate of two checkouts of the port, in turns on
one card.

Each turn is a process that builds the kernels of one checkout (once: they
are kept under its ``build/kernels/``), makes the flagship training task and
runs that checkout's timed fit. With ``--path flagship`` (the default) that
is ``chip_smoke.fit_flagship`` (phase 5: 34 steps at batch 256 on the
synthetic batch, 3 windows of 10 timed), and the turn prints its pairs/s;
with ``--path trainer`` it is ``chip_smoke.trainer_fit`` (phase 9's run A:
micro-batches of 128 at k=2, a validation and a checkpoint every 6), and
the turn prints its ms a micro-step over micro-steps 2-6. The turns go A,
B, B, A, ... so that a drift of the card shows on both sides. Run from the
root of a checkout, on a host with one CUDA card::

    python tools/fit_rate_turns.py PARENT_ROOT . [--pairs 2] [--path trainer]

Prints the card's name and power limit, each turn's reading and each
checkout's median, and B's median over A's.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
import statistics
import subprocess
import sys

_TURN = r"""
import os, sys, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from mmlearn_tpu_torch.flagship import flagship_training_task
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
os.environ[cs.PACKED_ENV] = "0"
os.environ.pop(cs.QUANT_ENV, None)
device = torch.device("cuda", 0)
task = flagship_training_task(device, seed=cs.SEED)
cs.fit_flagship(task, device, "", cs.flagship_launches(task, 0))
"""

_TRAINER_TURN = r"""
import os, sys, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from mmlearn_tpu_torch.flagship import flagship_training_task
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
os.environ[cs.PACKED_ENV] = "0"
os.environ.pop(cs.QUANT_ENV, None)
device = torch.device("cuda", 0)
master = flagship_training_task("cpu", seed=cs.SEED)
probe = cs.TrainerProbe((1, cs.TRAINER_EVERY))
cs.trainer_fit(master, device, sys.argv[1], probe)
ms = (probe.times[cs.TRAINER_EVERY] - probe.times[1]) / (cs.TRAINER_EVERY - 1) * 1e3
print(f"trainer path: {ms:.2f} ms a micro-step (micro-steps 2-{cs.TRAINER_EVERY})")
"""

#: per path: the turn's program and the pattern of the line it prints
PATHS = {"flagship": (_TURN, r"train b256: ([0-9.]+) pairs/s"),
         "trainer": (_TRAINER_TURN, r"trainer path: ([0-9.]+) ms a micro-step")}


def turn(root: str, path: str) -> float:
    program, pattern = PATHS[path]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        proc = subprocess.run([sys.executable, "-c", program, ckpt_dir], cwd=root,
                              capture_output=True, text=True, timeout=900, check=False)
    found = re.search(pattern, proc.stdout)
    if proc.returncode != 0 or found is None:
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    print(f"{root}: {found.group(0)}", flush=True)
    return float(found.group(1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", help="root of the first checkout (the parent)")
    parser.add_argument("b", help="root of the second checkout (the change)")
    parser.add_argument("--pairs", type=int, default=2, help="A, B, B, A rounds: 2 a pair")
    parser.add_argument("--path", choices=sorted(PATHS), default="flagship",
                        help="phase 5's fit (pairs/s) or phase 9's (ms a micro-step)")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    rates: dict[str, list[float]] = {"A": [], "B": []}
    order = [("A", "B"), ("B", "A")]
    for i in range(args.pairs):
        for side in order[i % 2]:
            rates[side].append(turn(roots[side], args.path))
    med = {side: statistics.median(r) for side, r in rates.items()}
    for side in "AB":
        print(f"{side} {roots[side]}: {', '.join(f'{r:.2f}' for r in rates[side])}, "
              f"median {med[side]:.2f}")
    print(f"B / A: {med['B'] / med['A']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
