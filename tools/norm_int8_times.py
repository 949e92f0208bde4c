"""K2b's and K5's times, in one process, for the checkout at ROOT (this one by default).

On one CUDA card, for the LayerNorm backward (K2b) at (256 x 197, 768) and at the I-JEPA
predictor's (1,024 x 118, 384), bf16: its dgamma/dbeta least atol against the plain version
(at ``chip_smoke.py``'s rtol 1e-4) and its dx least atol (rtol 2^-7), then the time of the
plain and the add variant and of one ``aten.native_layer_norm_backward`` call (dx, dgamma,
dbeta), twice; for the quantizing int8 product (K5) at image fc1 (K=768, N=3072) and fc2
(K=3072, N=768), M = 256 x 197: its time, and, where ROOT's K5 launches more than one kernel,
each kernel's mean device time under ``torch.profiler``. Run it for a parent checkout and
this one in turns to compare the two on one card::

    python tools/norm_int8_times.py build/parent
    python tools/norm_int8_times.py

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import os
import subprocess
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("norm_int8_times: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), root, flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)

    def least_atol(got, want, rtol):
        d = (got.float() - want.float()).abs() - rtol * want.float().abs()
        return max(float(d.max()), 0.0)

    for label, b, n, c in (("N=197 C=768", 256, 197, 768), ("B=1024 N=118 C=384", 1024, 118, 384)):
        x, dy, dr = (torch.randn(b, n, c, generator=gen, device=dev).bfloat16() for _ in range(3))
        g = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        got, want = fn._launch_bwd(x, g, dy, 1e-6), fn.ln_bwd_reference(x, g, dy, 1e-6)
        print(f"K2b {label}: dx least_atol {least_atol(got[0], want[0], 2 ** -7):.3e}, dgamma "
              f"{least_atol(got[1], want[1], 1e-4):.3e}, dbeta {least_atol(got[2], want[2], 1e-4):.3e}",
              flush=True)
        gl, bl = g.bfloat16(), torch.zeros_like(g).bfloat16()
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, (c,), gl, bl, 1e-6)
        for _ in range(2):
            ln = cs.cuda_ms(lambda: fn._launch_bwd(x, g, dy, 1e-6))
            add = cs.cuda_ms(lambda: fn._launch_bwd(x, g, dy, 1e-6, dr))
            lib = cs.cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, (c,), mean, rstd, gl, bl, (True, True, True)))
            print(f"K2b {label} ms: layernorm {ln:.4f}, add+layernorm {add:.4f}, "
                  f"aten.native_layer_norm_backward {lib:.4f}", flush=True)
        del x, dy, dr
    for label, m, k, n in (("fc1", 50432, 768, 3072), ("fc2", 50432, 3072, 768)):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        qw, sw = im.quantize_weight((torch.randn(n, k, generator=gen, device=dev) * k ** -0.5)
                                    .bfloat16())
        print(f"K5 {label} M={m} K={k} N={n} ms: {cs.cuda_ms(lambda: im.int8_qmm(x, qw, sw)):.4f}",
              flush=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                im.int8_qmm(x, qw, sw)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                print(f"K5 {label} kernel {e.key[:70]}: {e.device_time_total / e.count / 1e3:.4f} ms "
                      f"x{e.count}", flush=True)
        del x, qw, sw
    return 0


if __name__ == "__main__":
    sys.exit(main())
