"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- :mod:`.fused_attention` -- K1, fused short-sequence attention (CUDA C++);
- :mod:`.fused_norm` -- K2, LayerNorm and residual-add + LayerNorm (Triton).
"""
