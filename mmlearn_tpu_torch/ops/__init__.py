"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`.fused_attention` -- K1, fused short-sequence attention (CUDA C++);
- :mod:`.flash_attention` -- K3, blocked online-softmax attention for every
  layer K1 does not take (CUDA C++);
- :mod:`.fused_norm` -- K2, LayerNorm and residual-add + LayerNorm (CUDA C++);
- :mod:`.int8_matmul` -- K5, the quantizing int8 product of
  ``MMLEARN_QUANT=int8_sb`` (CUDA C++);
- :mod:`.registered` -- the forward kernels as registered operators
  (``torch.ops.mmlearn``), which programs traced by ``torch.export`` call.
"""

#: the open :class:`mmlearn_tpu_torch.trainer.flops.FlopCounter` objects. A
#: kernel's launch is invisible to ``torch.utils.flop_counter.FlopCounterMode``
#: (a ctypes call, no ATen operation), so each kernel's autograd
#: Function reports here what its plain version's products count there.
FLOP_COUNTERS: list = []


def report_flops(kernel: str, flops: int) -> None:
    """Add ``flops`` under ``kernel`` to every open counter."""
    for counter in FLOP_COUNTERS:
        counter.add(kernel, flops)


def attention_flops(b: int, h: int, n_q: int, n_k: int, d: int, backward: bool) -> int:
    """The products of K1's and K3's plain versions as ``FlopCounterMode``
    counts them, each ``2 B H N_q N_k D`` and dense whatever the masks: the
    scores and ``p v`` forward; the scores again, ``dv``, ``dp``, ``dq`` and
    ``dk`` backward."""
    return (10 if backward else 4) * b * h * n_q * n_k * d
