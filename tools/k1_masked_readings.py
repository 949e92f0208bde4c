"""K1b's and K1b-p's element readings on rows longer than the checks' texts.

Run from the root of a checkout, on a host with a CUDA card::

    python tools/k1_masked_readings.py [--draws 8]

At N = 257 and 768 (D = 64, 4 heads, batch 8), each draw with a ragged key
mask built as ``chip_smoke.py`` builds it, no causal rule, this runs K1 and
the head-grouped K1-p (bf16) through ``fused_mha`` and autograd and prints,
per draw, the least atol that dqkv needs against the plain backward at rtol
2^-7 (the quantity ``chip_smoke.py`` prints as least_atol), for K1b and
K1b-p, and whether the two are equal bit for bit. The readings are the
output's rounding of f32 sums taken in another order, near zero; they grow
with the row's length.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mmlearn_tpu_torch.flagship import ragged_text_batch  # noqa: E402
from mmlearn_tpu_torch.ops import fused_attention as fa  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_masked_readings: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    b, h, d = 8, 4, 64
    for n in (257, 768):
        for draw in range(args.draws):
            lens = ragged_text_batch(b, gen, device)["text_attention_mask"].sum(1, keepdim=True)
            mask = torch.arange(n, device=device)[None] < (lens * n) // 77
            x = torch.randn(b, n, 3 * h * d, generator=gen, device=device).bfloat16()
            dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
            got = {}
            for packed in ("0", "1"):
                os.environ["MMLEARN_FUSED_ATTN_PACKED"] = packed
                leaf = x.clone().requires_grad_()
                out = fa.fused_mha(leaf, mask, num_heads=h)
                (dqkv,) = torch.autograd.grad(out, leaf, dout)
                want = fa.mha_bwd_reference(x, mask, out.detach(), dout, h, d ** -0.5, False)
                err = (dqkv.float() - want.float()).abs() - 2 ** -7 * want.float().abs()
                got[packed] = (dqkv, max(float(err.max()), 0.0))
            same = torch.equal(got["0"][0], got["1"][0])
            print(f"N={n} draw {draw}: least atol K1b {got['0'][1]:.3e}, K1b-p {got['1'][1]:.3e}; "
                  f"bit for bit: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
