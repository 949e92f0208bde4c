"""The FLOP counter that counts the hand-written kernels
(``mmlearn_tpu_torch.trainer.flops``).

A kernel's launch is invisible to ``FlopCounterMode``, so each kernel's
autograd Function reports the count of its plain version's products. Here
the Functions take their kernel branch on ``meta`` tensors with the launches
stubbed out, and what they report is held to what ``FlopCounterMode``
counts for the plain versions on the CPU at the same shapes, forward and
backward. The tiny step's count is held to the JAX package's jaxpr walker
(``mmlearn_tpu.trainer.flops.step_flops``).
"""

import functools

import jax
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu.trainer.flops import step_flops
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.ops import flash_attention as fl
from mmlearn_tpu_torch.ops import fused_attention as fa
from mmlearn_tpu_torch.ops import fused_norm as fn
from mmlearn_tpu_torch.ops import int8_matmul as im
from mmlearn_tpu_torch.trainer import Trainer
from mmlearn_tpu_torch.trainer.flops import FlopCounter, count_flops, device_peak_tflops
from tests.test_torch_trainer_fit import TEXT, VISION, make_batches, port_task


def plain_flops(fn_, *args) -> int:
    with FlopCounterMode(display=False) as mode:
        fn_(*args)
    return mode.get_total_flops()


def reported(fn_, *args) -> dict:
    """What the kernels reported while ``fn_`` ran forward and backward."""
    with FlopCounter() as counter:
        out = fn_(*args)
        outs = out if isinstance(out, tuple) else (out,)
        sum(o.float().sum() for o in outs).backward()
    return dict(counter.kernel_flops)


def _meta(*shape):
    return torch.empty(*shape, device="meta", requires_grad=True)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_mha_reports_its_plain_versions_count(monkeypatch, packed, causal):
    b, n, h, d = 2, 33, 3, 16
    monkeypatch.setattr(fa, "_fused_mha_cuda",
                        lambda qkv, *a: torch.empty(b, n, h * d, device=qkv.device))
    monkeypatch.setattr(fa, "_fused_mha_bwd_cuda", lambda qkv, *a: torch.empty_like(qkv))
    got = reported(fa.FusedMHAFunction.apply, _meta(b, n, 3 * h * d), None, h, 0.25, causal,
                   packed)
    qkv = torch.randn(b, n, 3 * h * d)
    mask = torch.ones(b, n, dtype=torch.bool)
    out = fa.mha_reference(qkv, mask, h, 0.25, causal)
    name = "fused_mha_packed" if packed else "fused_mha"
    assert got == {
        f"{name}_fwd": plain_flops(fa.mha_reference, qkv, mask, h, 0.25, causal),
        f"{name}_bwd": plain_flops(fa.mha_bwd_reference, qkv, mask, out, out, h, 0.25, causal),
    }


@pytest.mark.parametrize("qkv", [False, True], ids=["split", "packed_qkv"])
def test_flash_attention_reports_its_plain_versions_count(monkeypatch, qkv):
    b, h, n_q, n_k, d = 2, 3, 40, 40 if qkv else 57, 16

    def fwd(q, k, v, *a):
        return (torch.empty(b, h, q.shape[2], d, device=q.device),
                torch.empty(b, h, q.shape[2], device=q.device))

    monkeypatch.setattr(fl, "_flash_fwd_cuda", fwd)
    monkeypatch.setattr(fl, "_flash_bwd_cuda", lambda q, k, v, *a, grads=None: (
        None if grads is not None else (torch.empty_like(q), torch.empty_like(k),
                                        torch.empty_like(v))))
    if qkv:
        got = reported(fl.FlashQKVFunction.apply, _meta(b, n_q, 3 * h * d), None, h, 0.25, True)
    else:
        got = reported(fl.FlashAttentionFunction.apply, _meta(b, h, n_q, d), _meta(b, h, n_k, d),
                       _meta(b, h, n_k, d), None, 0.25, True)
    q, k, v = torch.randn(b, h, n_q, d), torch.randn(b, h, n_k, d), torch.randn(b, h, n_k, d)
    out, lse = fl.flash_fwd_reference(q, k, v, None, 0.25, True)
    assert got == {
        "flash_fwd": plain_flops(fl.flash_fwd_reference, q, k, v, None, 0.25, True),
        "flash_bwd": plain_flops(fl.flash_bwd_reference, q, k, v, None, out, lse, out, 0.25,
                                 True),
    }


@pytest.mark.parametrize("add", [False, True])
def test_layernorm_reports_its_plain_versions_count(monkeypatch, add):
    """Neither plain version has a product, so K2 reports 0 each way."""
    monkeypatch.setattr(fn, "_on_cuda", lambda x: x.device.type != "cpu")
    monkeypatch.setattr(fn, "_launch", lambda *a: None)
    monkeypatch.setattr(fn, "_launch_bwd", lambda x, g, dy, eps, dr=None: (
        torch.empty_like(x), torch.empty_like(g), torch.empty_like(g)))
    x, g = torch.randn(4, 9, 32), torch.ones(32)
    if add:
        got = reported(fn.AddLayerNormFunction.apply, _meta(4, 9, 32), _meta(4, 9, 32),
                       _meta(32), _meta(32), 1e-6)
    else:
        got = reported(fn.LayerNormFunction.apply, _meta(4, 9, 32), _meta(32), _meta(32), 1e-6)
    assert got == {"layernorm_fwd": plain_flops(fn.ln_reference, x, g, g, 1e-6),
                   "layernorm_bwd": plain_flops(fn.ln_bwd_reference, x, g, x, 1e-6)} == {
        "layernorm_fwd": 0, "layernorm_bwd": 0}


def test_switchback_reports_its_plain_versions_count(monkeypatch):
    """K5 runs forward and dgrad; the exact wgrad is an ATen product that
    ``FlopCounterMode`` counts itself."""
    m, k, n = 24, 160, 192
    monkeypatch.setattr(im, "int8_qmm", lambda a, qw, sw, bias=None: torch.empty(
        *a.shape[:-1], qw.shape[0], device=a.device))
    got = reported(im.SwitchbackMatmul.apply, _meta(2, m // 2, k), _meta(n, k), None)
    x, w, g = torch.randn(m, k), torch.randn(n, k), torch.randn(m, n)
    qw, sw = im.quantize_weight(w)
    qwt, swt = im.quantize_weight(w.t().contiguous())
    assert got == {"int8_qmm": plain_flops(im.int8_qmm_reference, x, qw, sw)
                   + plain_flops(im.int8_qmm_reference, g, qwt, swt)}


def test_no_report_without_an_open_counter_and_on_the_cpu():
    qkv = torch.randn(2, 9, 48, requires_grad=True)
    with FlopCounter() as counter:  # the plain version's own products are counted
        fa.fused_mha(qkv, num_heads=1).sum().backward()
    assert counter.kernel_flops == {}
    assert counter.total() == plain_flops(fa.mha_reference, qkv, None, 1, 0.25, False) + \
        plain_flops(fa.mha_bwd_reference, qkv, None, qkv[..., :16], qkv[..., :16], 1, 0.25,
                    False)


def test_tiny_step_counts_as_the_jax_walker_does():
    """Forward and backward of the tiny pair's loss: the forward equal to the
    JAX count; the step within 1% of it, and equal once one term is named:
    the port's attention backward recomputes the scores (one ``2 B H N^2
    D`` product a layer) where the JAX CPU path's autodiff keeps them."""
    batch = make_batches(1)[0]
    jtask = JTask(encoders={"rgb": JVision(**VISION), "text": JText(**TEXT)},
                  optimizer=functools.partial(optax.adamw, learning_rate=1e-3))
    params = jtask.init_params(jax.random.key(0), batch)

    def loss(p):
        return jtask.loss_fn(p, batch, jax.random.key(1), {}, deterministic=False)[0]

    task = port_task()
    task.load_state_dict(bridge.jax_to_torch(jax.device_get(params)))

    def step():
        task.loss_fn(batch)[0].backward()

    _, port_fwd = count_flops(lambda: task.loss_fn(batch))
    _, port_step = count_flops(step)
    jax_fwd, jax_step = step_flops(loss, params), step_flops(jax.value_and_grad(loss), params)
    b, h, d = 4, VISION["num_heads"], VISION["embed_dim"] // VISION["num_heads"]
    n_img = (VISION["img_size"] // VISION["patch_size"]) ** 2 + 1
    recompute = sum(2 * b * h * n * n * d * 2 for n in (n_img, TEXT["max_length"]))
    assert port_fwd == jax_fwd
    assert abs(port_step - jax_step) / jax_step < 0.01
    assert port_step == jax_step + recompute


def test_trainer_counts_the_first_step_once(monkeypatch):
    monkeypatch.delenv("MMLEARN_PEAK_TFLOPS", raising=False)
    assert device_peak_tflops("cpu") is None
    trainer = Trainer(max_steps=3, log_every_n_steps=1, log_mfu=True, device="cpu")
    task = port_task()
    trainer.fit(task, make_batches(2))
    batch = make_batches(2)[0]
    _, want = count_flops(lambda: task.loss_fn(batch)[0].backward())
    assert trainer._step_flops == want  # the update adds no product
