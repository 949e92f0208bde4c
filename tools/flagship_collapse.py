"""Where the flagship fit collapses: trajectories by K1 implementation, mode and seed.

On one CUDA card, for each seed and for bf16 and ``MMLEARN_QUANT=int8_sb``, runs the
flagship contrastive fit of ``chip_smoke.py`` (``flagship_training_task(seed)``, the
synthetic batch from ``seed + 4``, batch 256, 34 steps, ``bench.py``'s schedule) with K1 as
the card runs it ("kernels"), with K1's plain versions on the card in its place ("plain":
``mha_reference`` forward, ``mha_bwd_reference`` backward), and, given ``--k1-source``,
with another build of ``csrc/fused_attention.cu`` (same C interface) as K1 ("source"). For
each run it prints the loss and gradient norm at a few steps and the trained tensors whose
last gradient is exactly zero. A run has collapsed when its loss sits at chance, ln 256 =
5.545, with a gradient norm near 0::

    python tools/flagship_collapse.py --seeds 0 1 2 3
    python tools/flagship_collapse.py --seeds 0 1 --k1-source build/old/fused_attention.cu

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 34
BATCH = 256
SHOWN = (0, 1, 5, 10, 15, 20, 25, 30, 33)


@contextlib.contextmanager
def k1_arm(arm: str, library: str | None):
    """K1 as the arm runs it, restored on exit: "kernels" leaves the port as
    it is; "plain" puts K1's plain versions in place of its two launch
    functions; "source" loads ``library`` as K1's compiled library."""
    from mmlearn_tpu_torch import _build
    from mmlearn_tpu_torch.ops import fused_attention as fa

    saved = (fa._fused_mha_cuda, fa._fused_mha_bwd_cuda, _build._loaded.get("fused_attention"))
    if arm == "plain":
        fa._fused_mha_cuda = (lambda qkv, mask, h, scale, causal, packed=False:
                              fa.mha_reference(qkv, mask, h, scale, causal))
        fa._fused_mha_bwd_cuda = (lambda qkv, mask, out, dout, h, scale, causal, packed=False:
                                  fa.mha_bwd_reference(qkv, mask, out, dout, h, scale, causal))
    elif arm == "source":
        _build._loaded["fused_attention"] = ctypes.CDLL(library)
    try:
        yield
    finally:
        fa._fused_mha_cuda, fa._fused_mha_bwd_cuda = saved[:2]
        if saved[2] is None:
            _build._loaded.pop("fused_attention", None)
        else:
            _build._loaded["fused_attention"] = saved[2]


@contextlib.contextmanager
def quant_mode(mode: str | None):
    before = os.environ.get("MMLEARN_QUANT")
    if mode:
        os.environ["MMLEARN_QUANT"] = mode
    else:
        os.environ.pop("MMLEARN_QUANT", None)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("MMLEARN_QUANT", None)
        else:
            os.environ["MMLEARN_QUANT"] = before


def build(source: str) -> str:
    from mmlearn_tpu_torch import _build

    out = os.path.join(tempfile.mkdtemp(), "libk1.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, source]
    subprocess.run(cmd, check=True, capture_output=True)
    return out


def run(seed: int, mode: str | None, arm: str, library: str | None) -> str:
    import torch

    from mmlearn_tpu_torch.flagship import flagship_training_task, synthetic_batch
    from mmlearn_tpu_torch.trainer import Trainer

    with quant_mode(mode), k1_arm(arm, library):
        task = flagship_training_task("cuda", seed=seed)
        batch = synthetic_batch(BATCH, torch.Generator(device="cuda").manual_seed(seed + 4),
                                "cuda")
        trainer = Trainer(max_steps=STEPS, log_every_n_steps=STEPS, device="cuda")
        trainer.fit(task, [batch])
        torch.cuda.synchronize()
        zero = [n for n, p in task.named_parameters()
                if p.grad is not None and bool(p.grad.isfinite().all()) and not bool(p.grad.any())]
        hist = trainer.history
    last = hist[-1]
    collapsed = abs(last["loss"] - math.log(BATCH)) < 0.01 and last["grad_norm"] < 0.1
    traj = " ".join(f"{i}:{hist[i]['loss']:.4f}/{hist[i]['grad_norm']:.3f}"
                    for i in SHOWN if i < len(hist))
    del task, batch
    torch.cuda.empty_cache()
    return (f"seed {seed} {mode or 'bf16'} {arm}: {traj} | collapsed {collapsed} | "
            f"exactly zero gradients {len(zero)} {zero[:4]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--modes", nargs="+", default=["bf16", "int8_sb"])
    parser.add_argument("--arms", nargs="+", default=["kernels", "plain"])
    parser.add_argument("--k1-source", help="another fused_attention.cu to run as K1")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flagship_collapse: needs a CUDA card", file=sys.stderr)
        return 1
    library = build(args.k1_source) if args.k1_source else None
    arms = args.arms + (["source"] if library else [])
    print(torch.cuda.get_device_name(0), flush=True)
    for seed in args.seeds:
        for mode in args.modes:
            for arm in arms:
                print(run(seed, None if mode == "bf16" else mode, arm, library), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
