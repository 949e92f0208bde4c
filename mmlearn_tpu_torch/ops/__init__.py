"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`.fused_attention` -- K1, fused short-sequence attention (CUDA C++);
- :mod:`.flash_attention` -- K3, blocked online-softmax attention for every
  layer K1 does not take (CUDA C++);
- :mod:`.fused_norm` -- K2, LayerNorm and residual-add + LayerNorm (Triton);
- :mod:`.int8_matmul` -- K5, the quantizing int8 product of
  ``MMLEARN_QUANT=int8_sb`` (CUDA C++).
"""
