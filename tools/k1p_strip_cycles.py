"""Where the head-grouped forward K1f-p spends its time, against K1f's.

Run from the root of a checkout, on a host with a CUDA card::

    python tools/k1p_strip_cycles.py

Builds instrumented copies of ``csrc/fused_attention.cu`` (K1f) and
``csrc/fused_attention_packed.cu`` (K1f-p) under ``build/k1p_strip_cycles/``:
``clock64()`` counters around K1f's 16-row strip and around each part of a
K1f-p warp's loop (the slot's wait, the wait for the strip's Q, the claim of
the next item with its Q copy, the strip, the count on the ring buffer with
its refill), summed over the lanes 0 by atomics into a device array. At the
I-JEPA step's three attention grids (bf16, b256, the predictor at 1,024
rows) it prints each kernel's time (CUDA events, with the counters on) and
the SM cycles a strip takes, per item for K1f-p by part. The strip is the
same routine in both (``fwd_strip`` in ``csrc/k1_arithmetic.cuh``); the
counters show how long it runs where each kernel runs it. The copies fail
to build, and the script stops, if the sources no longer have the lines the
counters are put at.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mmlearn_tpu_torch import _build  # noqa: E402
from mmlearn_tpu_torch.ops import fused_attention as fa  # noqa: E402

OUT = os.path.join(REPO, "build", "k1p_strip_cycles")
# (label, batch, tokens, heads, head dim): the I-JEPA step's attention
GRIDS = (("teacher", 256, 196, 12, 64), ("student", 256, 84, 12, 64),
         ("predictor", 1024, 118, 12, 32))
COUNTERS = """__device__ unsigned long long g_count[8];
namespace {
"""
READER = """
extern "C" int read_counters(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_count, sizeof(g_count));
  unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_count, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def _insert(text: str, anchor: str, before: str = "", after: str = "") -> str:
    if text.count(anchor) != 1:
        raise SystemExit(f"the source no longer has one line {anchor.strip()!r}")
    return text.replace(anchor, before + anchor + after)


def instrumented_k1(text: str) -> str:
    """K1f: counter 0 the strip's cycles, 1 the strips."""
    strip = "    fwd_strip<D, G, kOneSweep, kLd>(st, v_s, r0, skip, oh, o_stride, lane);\n"
    text = _insert(text, strip, before="    const long long t_strip = clock64();\n",
                   after="    if (lane == 0) {\n      atomicAdd(&g_count[0], static_cast"
                         "<unsigned long long>(clock64() - t_strip));\n"
                         "      atomicAdd(&g_count[1], 1ull);\n    }\n")
    return text.replace("namespace {\n", COUNTERS, 1) + READER


def instrumented_k1p(text: str) -> str:
    """K1f-p: counters 0-4 the loop's parts (slot wait, Q wait, claim and Q
    copy, strip, count and refill), 5 the items."""
    text = _insert(text, "    const int j = i / strips, r0 = (i % strips) * 16;\n",
                   before="    const long long t_a = clock64();\n")
    text = _insert(text, "    wait_slot(j);\n", after="    const long long t_b = clock64();\n")
    q_wait = "    cp_async_wait<1>();  // all but the group committed after this strip's Q\n"
    text = _insert(text, q_wait, after="    const long long t_c = clock64();\n")
    text = _insert(text, "    cp_async_commit();\n    const unsigned char* buf = buffer(j);\n",
                   after="    const long long t_d = clock64();\n")
    text = _insert(text, "                                     o_stride, lane);\n",
                   after="    const long long t_e = clock64();\n")
    parts = "".join(
        f"      atomicAdd(&g_count[{k}], static_cast<unsigned long long>({b} - {a}));\n"
        for k, (a, b) in enumerate(zip(("t_a", "t_b", "t_c", "t_d", "t_e"),
                                       ("t_b", "t_c", "t_d", "t_e", "t_f"))))
    text = _insert(text, "    i = next;\n", before=(
        "    const long long t_f = clock64();\n    if (lane == 0) {\n" + parts +
        "      atomicAdd(&g_count[5], 1ull);\n    }\n"))
    return text.replace("namespace {\n", COUNTERS, 1) + READER


def build() -> dict:
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, OUT)
    jobs = {"k1": ("fused_attention", instrumented_k1),
            "k1p": ("fused_attention_packed", instrumented_k1p)}
    for source, edit in jobs.values():
        path = os.path.join(OUT, f"{source}.cu")
        with open(path) as f:
            text = edit(f.read())
        with open(path, "w") as f:
            f.write(text)

    def nvcc(name: str, source: str) -> str:
        lib = os.path.join(OUT, f"lib{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
               os.path.join(OUT, f"{source}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {source}:\n{proc.stderr[-3000:]}")
        return lib

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(nvcc, name, source) for name, (source, _) in jobs.items()}
        libs = {name: ctypes.CDLL(f.result()) for name, f in futures.items()}
    fwd = {"k1": libs["k1"].mmlearn_fused_mha_fwd,
           "k1p": libs["k1p"].mmlearn_fused_mha_packed_fwd}
    for name, fn in fwd.items():
        fn.restype = ctypes.c_int
        fn.argtypes = fa._PACKED_FWD_ARGTYPES if name == "k1p" else fa._FWD_ARGTYPES
        libs[name].read_counters.argtypes = [ctypes.c_void_p]
    return {name: (fwd[name], libs[name].read_counters) for name in fwd}


def main() -> int:
    if not torch.cuda.is_available():
        print("k1p_strip_cycles: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kernels = build()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    counts = (ctypes.c_ulonglong * 8)()
    for label, b, n, h, d in GRIDS:
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device).bfloat16()
        out = torch.empty(b, n, h * d, dtype=torch.bfloat16, device=device)
        scale, stream = d ** -0.5, torch.cuda.current_stream().cuda_stream
        args = {"k1": (qkv.data_ptr(), None, out.data_ptr(), b, n, h, d, 1, scale, 0, stream),
                "k1p": (qkv.data_ptr(), None, out.data_ptr(), b, n, h, d, 1, scale, 0,
                        fa.packed_fwd_plan(n, d)[1], stream)}
        line = [f"{label} B={b} N={n} H={h} D={d}:"]
        for name, (fn, read) in kernels.items():
            if fn(*args[name]):
                raise SystemExit(f"{name} failed to launch")
            torch.cuda.synchronize()
            read(counts)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(*args[name])
            end.record()
            torch.cuda.synchronize()
            if read(counts):
                raise SystemExit("reading the counters failed")
            c = list(counts)
            ms = start.elapsed_time(end) / 20
            if name == "k1":
                line.append(f"K1f {ms:.4f} ms, strip {c[0] / c[1]:.0f} cycles;")
            else:
                per = [x / c[5] for x in c[:5]]
                line.append(f"K1f-p {ms:.4f} ms, per item: slot wait {per[0]:.0f}, Q wait "
                            f"{per[1]:.0f}, claim and Q copy {per[2]:.0f}, strip {per[3]:.0f}, "
                            f"count and refill {per[4]:.0f} cycles")
        print(" ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
