"""The readings of ``chip_smoke.py``'s noise-bound checks under sound
LayerNorms, and under faulty copies, to set and test their limits.

Phases 9 (the accumulation parity's loss, ``ACCUM_LOSS_RTOL``), 11 (the
fresh flagship's eval metrics card vs CPU, ``EVAL_OTHER_ATOL`` and the rest
of check 3) and 17 (the tensor-parallel loss, ``TP_LOSS_REL``) compare the
card against another computation of the same numbers, so a sound change of
any rounding moves their readings. Each variant is a copy of ``chip_smoke.py``
and ``mmlearn_tpu_torch/`` under ``build/variants/<name>/`` with one edit,
run in its own process (the kernels it launches are built once, in this
checkout, and shared):

Sound LayerNorm forwards (every K2f call of the path, counted as a launch):

- ``k2f``: the checkout as it is (K2f's own bits);
- ``k2f_plain``: K2f's plain version (``ln_reference``) on the card;
- ``aten``: ``F.layer_norm`` in f32, cast to the input's type.

Faulty copies, each run on the phase it was made for:

- ``accum_drop`` (phase 9): on the card, the accumulation window's second
  micro-batch's gradient is left out of the running mean;
- ``k1_half_scale`` (phase 11): K1f's output x 1.03 on the first half of
  each batch;
- ``k1_no_causal`` (phase 11): K1f launched without its causal flag.

Phase 17's faulty copies are ``tools/tp_mutants.py``'s. On a host with one
CUDA card, from the root of a checkout::

    python tools/noise_limits.py [--variants k2f,aten,...] [--phases 9,11,17]

Prints, for each variant, its exit code and the phases' reading lines.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_attention", "layernorm_fwd", "layernorm_bwd", "flash_attention")
NORM = os.path.join("mmlearn_tpu_torch", "ops", "fused_norm.py")
ATTENTION = os.path.join("mmlearn_tpu_torch", "ops", "fused_attention.py")
TRAINER = os.path.join("mmlearn_tpu_torch", "trainer", "trainer.py")

_LAUNCH = '''    """The forward kernel on CUDA tensors, one launch: ``y`` (and ``r``)
    written in place."""
'''
_LN = '''    src = x if branch is None else x + branch
    if r is not None:
        r.copy_(src)
    y.copy_({})
    LAUNCHES["layernorm_fwd"] += 1
    return
'''
_K1_LAUNCH = "    out = _fused_mha_cuda(qkv, mask, num_heads, scale, causal, packed)\n"
_ACC_ADD = "                torch._foreach_add_(acc_local, deltas)\n"

#: name: (phases it runs, [(file, sound text, its replacement)])
VARIANTS = {
    "k2f": ("9,11,17", []),
    "k2f_plain": ("9,11,17", [(NORM, _LAUNCH, _LAUNCH + _LN.format(
        "ln_reference(src, gamma, beta, eps)"))]),
    "aten": ("9,11,17", [(NORM, _LAUNCH, _LAUNCH + _LN.format(
        "torch.nn.functional.layer_norm(src.float(), src.shape[-1:], gamma.float(), "
        "beta.float(), eps).to(y.dtype)"))]),
    "accum_drop": ("9", [(TRAINER, _ACC_ADD, (
        "                if not deltas or deltas[0].device.type != \"cuda\":\n"
        "    " + _ACC_ADD))]),
    "k1_half_scale": ("11", [(ATTENTION, _K1_LAUNCH, _K1_LAUNCH + (
        "    out[: out.shape[0] // 2] *= 1.03\n"))]),
    "k1_no_causal": ("11", [(ATTENTION, _K1_LAUNCH, _K1_LAUNCH.replace(
        "scale, causal,", "scale, False,"))]),
}

RUN = r"""
import os, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as c
sys.modules["chip_smoke"] = c
from mmlearn_tpu_torch import _build
from mmlearn_tpu_torch.flagship import flagship_training_task
for name in {kernels!r}:
    _build.build(name)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
os.environ[c.PACKED_ENV] = "0"
os.environ.pop(c.QUANT_ENV, None)
device = torch.device("cuda", 0)
failed = 0
for phase in {phases!r}.split(","):
    t0 = time.perf_counter()
    try:
        if phase == "9":
            c.accumulation_parity(flagship_training_task("cpu", seed=c.SEED), device)
        elif phase == "11":
            c.eval_card_vs_cpu(flagship_training_task("cpu", seed=c.SEED), device,
                               c.eval_sets(c.Uint8Pairs(c.SEED + 31)), "fresh")
        elif phase == "17":
            c.tp_phase(device)
    except c.SmokeError as err:
        failed += 1
        print(f"chip_smoke.SmokeError in phase {{phase}}: {{err}}")
    print(f"phase {{phase}} done in {{time.perf_counter() - t0:.1f}} s", flush=True)
sys.exit(1 if failed else 0)
"""

#: the reading lines of each phase
READINGS = ("trainer path: accumulation parity", "trainer path: applied gradient",
            "trainer path: weight update", "eval path, fresh weights, card vs CPU",
            "tensor-parallel path: largest", "chip_smoke.SmokeError", "phase ")


def copy_with(name: str) -> str:
    """The variant's root, made anew (the checkout itself for ``k2f``)."""
    edits = VARIANTS[name][1]
    if not edits:
        return REPO
    root = os.path.join(REPO, "build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "mmlearn_tpu_torch"),
                    os.path.join(root, "mmlearn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    os.makedirs(os.path.join(root, "build"))
    os.symlink(os.path.join(REPO, "build", "kernels"), os.path.join(root, "build", "kernels"))
    for target, sound, edit in edits:
        path = os.path.join(root, target)
        with open(path) as f:
            source = f.read()
        if source.count(sound) != 1:
            raise SystemExit(f"{target}: the text {name} edits is not where this tool "
                             "expects it")
        with open(path, "w") as f:
            f.write(source.replace(sound, edit, 1))
    return root


def run(name: str, phases: str) -> int:
    root = copy_with(name)
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", RUN.format(kernels=KERNELS, phases=phases)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=1500)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(READINGS)]
    print(f"{name} (phases {phases}): exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    print("\n".join(f"  {ln}" for ln in lines), flush=True)
    if proc.returncode not in (0, 1):
        print(proc.stderr[-3000:], flush=True)
    return proc.returncode


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--phases", default=None,
                        help="the phases to run (default: each variant's own)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from mmlearn_tpu_torch import _build

    for name in KERNELS:
        _build.build(name)
    codes = {}
    for name in args.variants.split(","):
        codes[name] = run(name, args.phases or VARIANTS[name][0])
    print("exit codes: " + ", ".join(f"{k} {v}" for k, v in codes.items()))
    return 0 if all(v in (0, 1) for v in codes.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
