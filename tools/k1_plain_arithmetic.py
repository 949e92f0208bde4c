"""What K1b's bit-for-bit backward assumes of the plain version on the card.

``mha_bwd_reference`` rounds p and ds to bf16, so K1b reproduces the f32 values
it rounds, and with them the order in which PyTorch takes each sum on the card.
This checks that order on the card, by emulating it exactly in f32 with torch
ops and counting equal bits at the text tower's grid (B=256, N=77, H=8, D=64,
causal):

- the scores ``einsum(q, k) * scale`` and dP ``einsum(dout, v)``: a sequential
  f32 FMA chain over d = 0 .. D-1 from 0 (cuBLAS's f32 GEMM);
- ``softmax``: each row's max, ``exp(s - m)``, the sum as PyTorch's warp
  softmax takes it (lane L adds keys L, L + 32, ... from 0, then an xor
  butterfly 16 .. 1), and ``e / l``;
- ``delta = (dout * out).sum(-1)``: lane L adds columns L and L + 32, then
  the same butterfly;

then the whole of ``mha_bwd_reference`` from those pieces, and, for scale,
the same with the scores summed by the tensor cores instead (TF32 matmul on
bf16 values) and with the sum of each row taken left to right: the least atol
each reads against the plain version over ``--draws`` draws. If a new PyTorch
or cuBLAS changes an order, the first lines say which, and K1b must follow::

    python tools/k1_plain_arithmetic.py --draws 4

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def chain(a, b):
    """sum_d a[..., i, d] b[..., j, d] as a sequential f32 FMA chain from 0
    (each step exact in f64, then rounded to f32: one FMA)."""
    import torch

    acc = torch.zeros(*a.shape[:-1], b.shape[-2], dtype=torch.float32, device=a.device)
    for d in range(a.shape[-1]):
        acc = (acc.double() + a[..., :, None, d].double() * b[..., None, :, d].double()).float()
    return acc


def butterfly(parts):
    """PyTorch's warp reduction: an xor butterfly 16 .. 1 over the last dim
    (32 lanes)."""
    import torch

    lane = torch.arange(32, device=parts.device)
    for off in (16, 8, 4, 2, 1):
        parts = parts + parts[..., lane ^ off]
    return parts[..., :1]


def lanes(x):
    """Lane L's sum of x[..., L], x[..., L + 32], ... from 0, in order."""
    import torch

    pad = torch.nn.functional.pad(x, (0, (-x.shape[-1]) % 32)).unflatten(-1, (-1, 32))
    acc = torch.zeros_like(pad[..., 0, :])
    for it in range(pad.shape[-2]):
        acc = acc + pad[..., it, :]
    return acc


def backward(x, out, dout, h, scale, scores, row_sum):
    """``mha_bwd_reference`` (causal, no mask) with the scores, dP and row
    sums taken as given; the products after the roundings as the plain
    version takes them."""
    import torch

    from mmlearn_tpu_torch.ops import fused_attention as fa

    b, n, three_c = x.shape
    d = three_c // (3 * h)
    q, k, v = x.view(b, n, h, 3, d).permute(3, 0, 2, 1, 4).float().unbind(0)
    do = dout.view(b, n, h, d).permute(0, 2, 1, 3).float()
    o = out.view(b, n, h, d).permute(0, 2, 1, 3).float()
    s = torch.where(torch.ones(n, n, dtype=torch.bool, device=x.device).tril(),
                    scores(q, k) * scale, fa.NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / row_sum(e)
    delta = butterfly(lanes(do * o))
    ds = torch.where(torch.ones(n, n, dtype=torch.bool, device=x.device).tril(),
                     p * (scores(do, v) - delta) * scale, 0.0).bfloat16().float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), do)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    return torch.stack([dq, dk, dv], 0).permute(1, 3, 2, 0, 4).reshape(b, n, three_c).bfloat16()


def tensor_core_scores(a, b):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.einsum("bhid,bhjd->bhij", a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=4)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_plain_arithmetic: needs a CUDA card", file=sys.stderr)
        return 1
    from mmlearn_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    b, n, h, d, scale = 256, 77, 8, 64, 0.125
    gen = torch.Generator(device="cuda").manual_seed(0)

    def warp_sum(e):
        return butterfly(lanes(e))

    def left_to_right(e):
        acc = torch.zeros_like(e[..., :1])
        for j in range(e.shape[-1]):
            acc = acc + e[..., j:j + 1]
        return acc

    for draw in range(args.draws):
        x = torch.randn(b, n, 3 * h * d, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(b, n, h * d, generator=gen, device="cuda").bfloat16()
        out = fa.mha_reference(x, None, h, scale, True)
        want = fa.mha_bwd_reference(x, None, out, dout, h, scale, True)
        q, k, v = x.view(b, n, h, 3, d).permute(3, 0, 2, 1, 4).float().unbind(0)
        do = dout.view(b, n, h, d).permute(0, 2, 1, 3).float()
        o = out.view(b, n, h, d).permute(0, 2, 1, 3).float()
        s_eq = float((chain(q, k) == torch.einsum("bhid,bhjd->bhij", q, k)).float().mean())
        dp_eq = float((chain(do, v) == torch.einsum("bhid,bhjd->bhij", do, v)).float().mean())
        s = chain(q, k) * scale
        s = torch.where(torch.ones(n, n, dtype=torch.bool, device="cuda").tril(), s, fa.NEG)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p_eq = float((e / warp_sum(e) == torch.softmax(s, -1)).float().mean())
        delta_eq = float((butterfly(lanes(do * o)) == (do * o).sum(-1, keepdim=True))
                         .float().mean())
        line = [f"draw {draw}: equal bits: scores {s_eq:.6f}, dP {dp_eq:.6f}, softmax {p_eq:.6f}, "
                f"delta {delta_eq:.6f}; least atol of dqkv against the plain version:"]
        for label, scores, row_sum in (("as emulated", chain, warp_sum),
                                       ("row sums left to right", chain, left_to_right),
                                       ("tensor-core scores", tensor_core_scores, warp_sum)):
            got = backward(x, out, dout, h, scale, scores, row_sum).float()
            err = (got - want.float()).abs() - 2 ** -7 * want.float().abs()
            line.append(f"{label} {float(err.clamp_min(0).max()):.3e}")
        print(" ".join(line[:1]) + " " + ", ".join(line[1:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
