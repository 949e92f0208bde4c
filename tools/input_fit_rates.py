"""Phase 10's input-fed flagship fit by host pipeline, on one card.

In one process: phase 5's fit on the synthetic batch already on the card
(``chip_smoke.fit_flagship``, the reference rate), then phase 10's fit
(``chip_smoke.input_fit``: 34 steps at batch 256, 3 windows of 10 timed) on
uint8 host batches fed through the trainer's ``DeviceFeeder``, from

- ``prebuilt``: the pass's 16 batches collated once before the fit and
  replayed (the feeder's pinned copy, transfer and normalization only);
- ``workers=N``: ``Uint8Pairs`` through the port's ``DataLoader`` with N
  fetch threads (phase 10 itself runs 8);

then phase 5's fit again, for the card's drift. Each prints pairs/s, its
ratio to phase 5's, ms a step and the step's wait on the feeder. Run from
the root of a checkout, on a host with one CUDA card::

    python tools/input_fit_rates.py [--workers 8 4 2 1]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


class Replayed:
    """A loader replaying ``batches`` (collated host batches) each pass."""

    def __init__(self, batches) -> None:
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workers", type=int, nargs="+", default=[8, 4, 2, 1])
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mmlearn_tpu_torch.flagship import flagship_training_task

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ[cs.PACKED_ENV] = "0"
    os.environ.pop(cs.QUANT_ENV, None)
    device = torch.device("cuda", 0)
    master = flagship_training_task("cpu", seed=cs.SEED)

    def phase5(label: str) -> None:
        task = flagship_training_task(device, seed=cs.SEED)
        cs.fit_flagship(task, device, label, cs.flagship_launches(task, 0))
        del task
        torch.cuda.empty_cache()

    phase5("")
    data = cs.Uint8Pairs(cs.SEED + 31)
    batches = list(cs.input_loader(data))
    cs.input_fit(master, device, Replayed(batches), " (prebuilt)")
    del batches
    for workers in args.workers:
        cs.input_fit(master, device, cs.input_loader(cs.Uint8Pairs(cs.SEED + 31), workers),
                     f" (workers={workers})")
    phase5("again ")
    print(f"phase 5 before and after: {cs.FIT_RATES['']:.1f}, {cs.FIT_RATES['again ']:.1f} "
          f"pairs/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
