"""The forward kernels as registered operators, for programs that
``torch.export`` traces (:mod:`mmlearn_tpu_torch.serving.export`).

Traced through, the kernels' wrappers would leave their plain versions in
the graph as ATen operations (a ctypes launch cannot run on the fake tensors
of a trace), and a program run on the card would compute those in place of
the kernels. So each forward kernel a tower's ``encode`` can reach is one
``torch.library.custom_op`` here, with a fake implementation that gives the
output's shape at a symbolic batch:

- ``mmlearn::fused_mha`` -- K1f, or K1f-p under ``packed``
  (:func:`~mmlearn_tpu_torch.ops.fused_attention.fused_mha_forward`);
- ``mmlearn::layernorm`` and ``mmlearn::add_layernorm`` -- K2f, the second
  returning the residual and its norm
  (:func:`~mmlearn_tpu_torch.ops.fused_norm.layernorm_forward`);
- ``mmlearn::flash_qkv`` -- K3f on the strided q, k, v views of a packed
  projection, the output with the heads merged and the log-sum-exp
  (:func:`~mmlearn_tpu_torch.ops.flash_attention.flash_qkv_forward`);
- ``mmlearn::int8_qmm`` -- K5's quantizing product, the bias in its
  epilogue (:func:`~mmlearn_tpu_torch.ops.int8_matmul.int8_qmm_forward`).

Each operator has one implementation a device type: the plain version for a
CPU tensor, the kernel for a CUDA tensor (launch counters and FLOP reports
included). The autograd Functions take these operators only while
``torch.export`` traces (``torch.compiler.is_exporting()``); eager calls
launch directly, the same kernels, without the operator's dispatch. Loading
a program that calls them needs this module imported, and nothing of the
port's model code: this module imports the kernels' wrappers only.
"""

from typing import Optional, Tuple

import torch

from mmlearn_tpu_torch.ops import fused_attention as _fa
from mmlearn_tpu_torch.ops import fused_norm as _fn
from mmlearn_tpu_torch.ops import flash_attention as _fl
from mmlearn_tpu_torch.ops import int8_matmul as _im

#: the namespace of every operator here (``torch.ops.mmlearn``)
NAMESPACE = "mmlearn"


@torch.library.custom_op(f"{NAMESPACE}::fused_mha", mutates_args=(), device_types="cpu")
def fused_mha(qkv: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int, scale: float,
              causal: bool, packed: bool) -> torch.Tensor:
    """K1f on a head-major packed ``(B, N, H * 3 * D)`` projection:
    ``(B, N, H * D)``."""
    return _fa.mha_reference(qkv, mask, num_heads, scale, causal)


@fused_mha.register_kernel("cuda")
def _(qkv, mask, num_heads, scale, causal, packed):
    return _fa.fused_mha_forward(qkv, mask, num_heads, scale, causal, packed)


@fused_mha.register_fake
def _(qkv, mask, num_heads, scale, causal, packed):
    b, n, three_c = qkv.shape
    return qkv.new_empty(b, n, three_c // 3)


@torch.library.custom_op(f"{NAMESPACE}::layernorm", mutates_args=(), device_types="cpu")
def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float) -> torch.Tensor:
    """K2f: LayerNorm over the last axis, in x's dtype."""
    return _fn.ln_reference(x, gamma, beta, eps)


@layernorm.register_kernel("cuda")
def _(x, gamma, beta, eps):
    return _fn.layernorm_forward(x, gamma, beta, eps)


@layernorm.register_fake
def _(x, gamma, beta, eps):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::add_layernorm", mutates_args=(), device_types="cpu")
def add_layernorm(x: torch.Tensor, branch: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2f's add variant: ``(r, LN(r))`` with ``r = x + branch``."""
    return _fn.add_layernorm_forward(x, branch, gamma, beta, eps)


@add_layernorm.register_kernel("cuda")
def _(x, branch, gamma, beta, eps):
    return _fn.add_layernorm_forward(x, branch, gamma, beta, eps)


@add_layernorm.register_fake
def _(x, branch, gamma, beta, eps):
    return torch.empty_like(x), torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::flash_qkv", mutates_args=(), device_types="cpu")
def flash_qkv(qkv: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int, scale: float,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3f on the q, k, v views of a head-major packed ``(B, N, H * 3 * D)``
    projection: the output ``(B, N, H * D)`` and the f32 log-sum-exp
    ``(B, H, N)``."""
    return _fl.flash_qkv_forward(qkv, mask, num_heads, scale, causal)


@flash_qkv.register_kernel("cuda")
def _(qkv, mask, num_heads, scale, causal):
    return _fl.flash_qkv_forward(qkv, mask, num_heads, scale, causal)


@flash_qkv.register_fake
def _(qkv, mask, num_heads, scale, causal):
    b, n, three_c = qkv.shape
    return (qkv.new_empty(b, n, three_c // 3),
            qkv.new_empty(b, num_heads, n, dtype=torch.float32))


@torch.library.custom_op(f"{NAMESPACE}::int8_qmm", mutates_args=(), device_types="cpu")
def int8_qmm(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K5: ``x @ (qw * sw).T + bias``, the rows of x quantized to int8."""
    return _im.int8_qmm_reference(x, qw, sw, bias)


@int8_qmm.register_kernel("cuda")
def _(x, qw, sw, bias):
    return _im.int8_qmm_forward(x, qw, sw, bias)


@int8_qmm.register_fake
def _(x, qw, sw, bias):
    return x.new_empty(*x.shape[:-1], qw.shape[0])


#: the operators, by the name a graph's call targets carry
#: (``torch.ops.mmlearn.<name>.default``)
OPERATORS = {"fused_mha": fused_mha, "layernorm": layernorm, "add_layernorm": add_layernorm,
             "flash_qkv": flash_qkv, "int8_qmm": int8_qmm}
