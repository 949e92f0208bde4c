"""Device-time breakdown of the flagship's paths on a CUDA card, by kernel.

Run from the root of a checkout, on a host with a CUDA card::

    python -m mmlearn_tpu_torch.profile_step --path train --batch 256
    python -m mmlearn_tpu_torch.profile_step --path ijepa --batch 256
    python -m mmlearn_tpu_torch.profile_step --path encode-rgb --batch 256
    python -m mmlearn_tpu_torch.profile_step --path encode-text --batch 256
    python -m mmlearn_tpu_torch.profile_step --path train --quant int8_sb
    python -m mmlearn_tpu_torch.profile_step --path highres --batch 64
    python -m mmlearn_tpu_torch.profile_step --path vit-h14 --batch 128 [--no-remat]

``train`` takes ``Trainer.fit`` steps of the flagship contrastive task on the
synthetic batch; ``highres`` those of its 448-px variant (785 image tokens,
attention on the flash kernel K3) on ``highres_batch`` (batch 64 unless
``--batch`` says otherwise); ``vit-h14`` those of OpenCLIP ViT-H/14's pair
(``flagship.vit_h14_training_task``: both towers under activation
checkpointing unless ``--no-remat``; batch 128 by default) on the synthetic
batch; ``ijepa`` those of the I-JEPA ViT-B/16 task on its batch
(with ``MMLEARN_FUSED_ATTN_PACKED=1`` in the environment its attention runs
the head-grouped kernels); ``encode-*`` embeds a batch of images, or of
ragged right-padded texts, with one tower. ``--quant`` sets
``MMLEARN_QUANT`` for the run, so the block projections take that int8 mode
(``int8_sb``: kernel K5 for their forward and dgrad). After 3 warm-up steps,
``--steps`` steps run under ``torch.profiler`` (CPU and CUDA activity). The script
prints the wall time a step (host clock between two synchronisations), the
device kernel time a step, the idle share (1 - kernel time / wall time),
the kernels grouped by what they do and the 15 slowest kernels by name,
each in ms a step. Without a CUDA card, or when the profiler records no
device time, it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch

from mmlearn_tpu_torch.trainer.callbacks import Callback

WARMUP = 3  # steps before the profiler starts
TOP = 15  # kernels listed by name

# kernel-name patterns, first match wins
GROUPS = [
    ("K1f attention forward", r"fused_mha_fwd_(f32_)?kernel"),
    ("K1b attention backward", r"fused_mha_bwd_"),
    ("K1f-p attention forward, head-grouped", r"packed_fwd_"),
    ("K1b-p attention backward, head-grouped", r"packed_bwd_"),
    ("K3f flash attention forward", r"flash_fwd"),
    ("K3b flash attention backward", r"flash_bwd_"),
    ("K2f layernorm forward", r"ln_fwd_(rows|wide)_kernel"),
    ("K2b layernorm backward", r"ln_bwd_"),
    ("K5 quantizing int8 product", r"int8_qmm|int8_gemm_kernel|quantize_rows_kernel"),
    ("GEMMs (cuBLAS)", r"nvjet|gemm|xmma|cutlass|sm90_|ampere_"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("reductions", r"reduce_kernel|reduction"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def _group(name: str) -> str:
    for label, pattern in GROUPS:
        if re.search(pattern, name):
            return label
    return "other"


class _StepMarks(Callback):
    """A trainer callback that calls ``on_step(n)`` after the n-th step, on
    the trainer's thread: ``Trainer.fit`` draws batches on its feeder's
    thread, and the profiler starts and stops on the thread that made it."""

    def __init__(self, on_step) -> None:
        self.on_step = on_step

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        self.on_step(step)


def _steps(path: str, batch: int, total: int, on_step, remat: bool = True):
    """Run ``total`` steps of ``path``, calling ``on_step(i)``: on the
    training paths after the i-th step (i from 1), on the ``encode`` paths
    before the i-th forward and once after the last (i from 0)."""
    from mmlearn_tpu_torch.flagship import (
        flagship_task,
        flagship_training_task,
        highres_batch,
        highres_training_task,
        ijepa_batch,
        ijepa_training_task,
        ragged_text_batch,
        synthetic_batch,
        vit_h14_training_task,
    )
    from mmlearn_tpu_torch.trainer import Trainer

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    steps = {"train": (synthetic_batch, flagship_training_task),
             "highres": (highres_batch, highres_training_task),
             "ijepa": (ijepa_batch, ijepa_training_task),
             "vit-h14": (synthetic_batch,
                         lambda dev: vit_h14_training_task(dev, remat=remat))}
    if path in steps:
        make_batch, make_task = steps[path]
        data = make_batch(batch, gen, device)
        Trainer(max_steps=total, log_every_n_steps=total, device=device,
                callbacks=[_StepMarks(on_step)]).fit(make_task(device), [data] * total)
        return
    task = flagship_task(device)
    if path == "encode-rgb":
        modality = "rgb"
        data = {"rgb": torch.randn(batch, 224, 224, 3, generator=gen, device=device)}
    else:
        modality = "text"
        data = ragged_text_batch(batch, gen, device)
    with torch.inference_mode():
        for i in range(total + 1):
            on_step(i)
            if i < total:
                task.encode(data, modality, normalize=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=["train", "highres", "ijepa", "vit-h14",
                                           "encode-rgb", "encode-text"], default="train")
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default: 64 for highres, 128 for vit-h14, 256 "
                             "otherwise)")
    parser.add_argument("--no-remat", action="store_true",
                        help="vit-h14 without activation checkpointing")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--quant", choices=["int8_fwd", "int8", "int8_sb"], default=None,
                        help="run under MMLEARN_QUANT=<mode> (default: the variable as set)")
    args = parser.parse_args(argv)
    if args.batch is None:
        args.batch = {"highres": 64, "vit-h14": 128}.get(args.path, 256)
    if args.quant:
        os.environ["MMLEARN_QUANT"] = args.quant
    if not torch.cuda.is_available():
        print("profile_step: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    marks = {}

    def on_step(i: int) -> None:
        # the profiler starts before the first mark: its start-up (seconds
        # on a first start) stays out of the timed window
        if i == WARMUP:
            prof.start()
        if i in (WARMUP, WARMUP + args.steps):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
        if i == WARMUP + args.steps:
            prof.stop()

    _steps(args.path, args.batch, WARMUP + args.steps + 1, on_step, remat=not args.no_remat)
    wall_ms = (marks[WARMUP + args.steps] - marks[WARMUP]) * 1e3 / args.steps
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        # kernels and device memsets; a user range (``Optimizer.step#...``)
        # would count its kernels twice
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.self_device_time_total > 0 and not evt.is_user_annotation):
            by_name[evt.key][0] += evt.self_device_time_total / 1e3 / args.steps
            by_name[evt.key][1] += evt.count / args.steps
    kernel_ms = sum(ms for ms, _ in by_name.values())
    if kernel_ms == 0:
        print("profile_step: the profiler recorded no device time", file=sys.stderr)
        return 1
    quant = os.environ.get("MMLEARN_QUANT") or "off"
    print(f"{args.path} b{args.batch} (MMLEARN_QUANT {quant}): {wall_ms:.3f} ms a step "
          f"(wall, under the profiler), kernels {kernel_ms:.3f} ms, idle share {1 - kernel_ms / wall_ms:.3f}")
    groups: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for name, (ms, count) in by_name.items():
        groups[_group(name)][0] += ms
        groups[_group(name)][1] += count
    for label, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label}: {ms:.3f} ms a step, {count:g} launches, "
              f"{ms / kernel_ms:.1%} of kernel time")
    print("slowest kernels by name:")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {ms:.3f} ms a step, {count:g} launches: {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
