"""Time the port's exact top-k of two checkouts in turns on one CUDA card.

Three calls of ``EmbeddingIndex.query`` on unit-norm random f32 rows of
width 512 (seeded on the card; scores do not tie):

- ``search``: one query, k=5, over 8,192 rows (``/search`` at b=1, the
  query part of ``chip_smoke.py``'s serving path), median of 200 calls;
- ``full_axis``: 1,024 queries, k=10, over 262,144 rows (a 1 GiB f32
  similarity, the full-axis route), median of 5;
- ``blockwise``: 8,192 queries, k=10, over 262,144 rows (8 GiB, over the
  byte budget: the blockwise route, ``chip_smoke.py``'s check 4 size),
  median of 3;

each with the peak device memory it allocates above its inputs, and a hash
of the rows it returns (equal across checkouts when they agree). Each turn
is a process of its own importing one checkout's ``mmlearn_tpu_torch``.

Usage::

    python tools/topk_turns.py PARENT_DIR CHANGE_DIR            # parent, change, change, parent
    python tools/topk_turns.py --one DIR                        # one turn, one JSON line
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time


def _one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from mmlearn_tpu_torch.serving.index import EmbeddingIndex

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)

    def unit(n):
        x = torch.randn(n, 512, generator=gen, device=device)
        return x / x.norm(dim=1, keepdim=True)

    small = EmbeddingIndex(unit(8192).cpu().numpy(), device=device)
    large = EmbeddingIndex(unit(262144).cpu().numpy(), device=device)
    queries = unit(8192)
    cases = {
        "search": (small, queries[:1], 5, 200),
        "full_axis": (large, queries[:1024], 10, 5),
        "blockwise": (large, queries, 10, 3),
    }
    out = {"root": root}
    for name, (index, q, k, reps) in cases.items():
        index.query(q, k=k)  # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, ids = index.query(q, k=k)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {
            "ms": statistics.median(times),
            "peak_gib_above_inputs": (torch.cuda.max_memory_allocated(device) - held) / 2**30,
            "rows_sha1": hashlib.sha1(ids.tobytes()).hexdigest()[:12],
        }
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*", help="PARENT_DIR CHANGE_DIR")
    parser.add_argument("--one", help="run one turn on this checkout")
    args = parser.parse_args()
    if args.one:
        print(json.dumps(_one(args.one)))
        return 0
    parent, change = args.roots
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        line = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
        print(label, line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
