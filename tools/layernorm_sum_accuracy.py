"""K2b's dgamma/dbeta against an f64 evaluation, on ``chip_smoke.py``'s own batch-256 data.

On one CUDA card, draws the inputs ``chip_smoke.norms_at_batch`` checks
(``chip_smoke.norm_batch_inputs``) and compares, for each of its three shapes, K2b's sums (both
variants), the plain version's (``ln_bwd_reference``, f32 column sums of the f32 products) and
a plain f32 column sum of the same products taken as one ``sum(0)`` of a ``(rows, C)`` tensor,
each against ``chip_smoke.ln_sums_f64``: the largest error against the unrounded f64 sums, and
against those sums rounded to f32 (as ``chip_smoke.compare`` takes them) the least atol at
rtol 1e-4 (``SUM_TOL``'s) and at ``SUM_F64_TOL``'s rtol. It shows which side of K2b's sum check
an error comes from, and where a limit passes K2b and refuses an f32 sum::

    python tools/layernorm_sum_accuracy.py

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("layernorm_sum_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mmlearn_tpu_torch.ops import fused_norm as fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    rtol = cs.SUM_F64_TOL[1]

    def error(got, exact):
        d = (got.double() - exact).abs().max()
        r = (got.float() - exact.float()).abs()
        want = exact.float().abs()
        return (f"max {float(d):.3e}, least atol {max(float((r - 1e-4 * want).max()), 0.0):.3e} "
                f"at rtol 1e-4, {max(float((r - rtol * want).max()), 0.0):.3e} at rtol {rtol:.3g}")

    for label, c, x, _, dy, dr, g, _ in cs.norm_batch_inputs(dev):
        k2b = fn._launch_bwd(x, g, dy, 1e-6)
        k2b_add = fn._launch_bwd(x, g, dy, 1e-6, dr)
        plain = fn.ln_bwd_reference(x, g, dy, 1e-6)
        exact = cs.ln_sums_f64(x, dy, 1e-6)
        xf = x.float()
        muf = xf.mean(-1, keepdim=True)
        xhat = (xf - muf) * torch.rsqrt((xf - muf).square().mean(-1, keepdim=True) + 1e-6)
        f32 = ((dy.float() * xhat).reshape(-1, c).sum(0), dy.float().reshape(-1, c).sum(0))
        for i, name in ((1, "dgamma"), (2, "dbeta")):
            print(f"{label} {name} against f64: K2b {error(k2b[i], exact[i - 1])}; K2b add "
                  f"{error(k2b_add[i], exact[i - 1])}; plain version "
                  f"{error(plain[i], exact[i - 1])}; f32 column sum "
                  f"{error(f32[i - 1], exact[i - 1])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
