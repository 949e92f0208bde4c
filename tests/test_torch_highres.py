"""The long-sequence path of the PyTorch port against the JAX package on the
CPU: the routing between the fused and the flash attention kernels, the
position-table resize, a tiny ViT whose attention takes the flash branch,
and one contrastive step of a tiny pair with that tower.

Inputs are made from a seed with numpy and fed to both packages in f32.
Each test states its tolerance.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.layers.embedding import interpolate_pos_embed as jax_interpolate
from mmlearn_tpu.ops.fused_attention import supports_fused as jax_supports_fused
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch import flagship
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.modules.layers import interpolate_pos_embed
from mmlearn_tpu_torch.ops import flash_attention as fl
from mmlearn_tpu_torch.ops import fused_attention as fa
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from tests.test_torch_encoders import TINY_TEXT

# width 128, 4 heads of dim 32, 192 px in 8-px patches: 24 x 24 + CLS = 577
# tokens, past the 512 the fused kernel takes at D=32
FLASH_VISION = dict(img_size=192, patch_size=8, embed_dim=128, depth=2, num_heads=4,
                    use_cls_token=True, learned_pos_embed=True, global_pool="cls",
                    proj_dim=16)
ATOL = 1e-5  # f32 end to end; sums in another order (tests/test_torch_encoders.py)


def test_supports_fused_matches_jax_everywhere():
    """The port routes exactly where the JAX package does, over every head
    count to 16, head dims 16-128 and every length to 2,100."""
    for d in (16, 32, 64, 128):
        for h in range(1, 17):
            got = [fa.supports_fused(h, d, n) for n in range(1, 2101)]
            want = [jax_supports_fused(h, d, n) for n in range(1, 2101)]
            assert got == want, (h, d)
    assert fa.supports_fused(12, 64, 768) and not fa.supports_fused(12, 64, 785)
    assert fa.supports_fused(4, 32, 512) and not fa.supports_fused(4, 32, 577)


@pytest.mark.parametrize("prefix", [0, 1])
@pytest.mark.parametrize("grids", [((28, 28), (14, 14)), ((11, 11), (7, 7)),
                                   ((5, 9), (7, 7))], ids=["14to28", "7to11", "shrink"])
def test_interpolate_pos_embed_matches_jax(grids, prefix):
    """``jax.image.resize``'s bicubic, including its antialiased shrink: atol
    1e-5 (the JAX weights are built in f32, the port's in f64)."""
    new, old = grids
    rng = np.random.default_rng(prefix)
    table = rng.standard_normal((1, prefix + old[0] * old[1], 24)).astype(np.float32)
    want = np.asarray(jax_interpolate(jnp.asarray(table), new, old, prefix))
    got = interpolate_pos_embed(torch.from_numpy(table), new, old, prefix)
    assert got.shape == (1, prefix + new[0] * new[1], 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got[:, :prefix].numpy(), table[:, :prefix])


def test_interpolate_pos_embed_is_not_torch_bicubic():
    """``F.interpolate``'s bicubic (a = -0.75, clamped edges) is another
    function: on a 14 -> 28 grid it differs from the JAX one by far more than
    the tolerance above."""
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 196, 8))
                             .astype(np.float32))
    grid = table.reshape(1, 14, 14, 8).permute(0, 3, 1, 2)
    torch_bicubic = torch.nn.functional.interpolate(grid, (28, 28), mode="bicubic")
    torch_bicubic = torch_bicubic.permute(0, 2, 3, 1).reshape(1, 784, 8)
    assert float((torch_bicubic - interpolate_pos_embed(table, (28, 28), (14, 14), 0))
                 .abs().max()) > 0.1


def _flash_vit():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 192, 192, 3)).astype(np.float32)
    jvit = JVision(**FLASH_VISION)
    params = jax.jit(jvit.init)(jax.random.key(0), jnp.asarray(images))["params"]
    vit = VisionTransformer(**FLASH_VISION)
    vit.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)
    return jvit, params, vit, images


def test_flash_branch_vit_matches_jax(monkeypatch):
    """A tiny ViT at 577 tokens: every block's attention takes the flash
    branch in both packages, and the embeddings agree to atol 1e-5."""
    jvit, params, vit, images = _flash_vit()
    calls = []
    monkeypatch.setattr(fl.FlashQKVFunction, "apply",
                        functools.partial(lambda f, *a: calls.append(1) or f(*a),
                                          fl.FlashQKVFunction.apply))
    with torch.no_grad():
        got = vit(torch.from_numpy(images)).pooler_output.numpy()
    assert len(calls) == FLASH_VISION["depth"]
    want = np.asarray(jvit.apply({"params": params}, jnp.asarray(images)).pooler_output)
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_flash_branch_pair_step_matches_jax():
    """One contrastive step of a tiny pair whose image tower takes the flash
    branch, from the same (bridged) weights: the loss to rtol 1e-5 (step 0 of
    tests/test_torch_training.py's trajectory) and every gradient tensor to
    atol 1e-5 (its loss-gradient test) with rtol 1e-5 (its optimizer-step
    test: the cls token's gradient, ~7 in size, sums 577 x 4 rows in
    another order) against ``jax.value_and_grad``."""
    jtask = JTask(encoders={"rgb": JVision(**FLASH_VISION), "text": JText(**TINY_TEXT)},
                  optimizer=functools.partial(optax.adamw, learning_rate=1e-3))
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 30, (4, 8)).astype(np.int32)
    ids[:, -1] = 31
    batch = {"rgb": rng.standard_normal((4, 192, 192, 3)).astype(np.float32), "text": ids}
    params = jtask.init_params(jax.random.key(0), batch)
    ptask = ContrastivePretraining({"rgb": VisionTransformer(**FLASH_VISION),
                                    "text": TextTransformer(**TINY_TEXT)})
    ptask.load_state_dict(bridge.jax_to_torch(jax.device_get(params)), strict=True)

    def loss_wrap(p):
        return jtask.loss_fn(p, batch, jax.random.key(1), {}, deterministic=False)[0]

    want, grads = jax.jit(jax.value_and_grad(loss_wrap))(params)
    loss, _ = ptask.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    twin = copy.deepcopy(ptask)
    with torch.no_grad():
        for p, g in zip(ptask.parameters(), twin.parameters()):
            g.copy_(p.grad)
    got = bridge.torch_to_jax(twin)
    flat = bridge.flatten(jax.device_get(grads))
    assert got.keys() == flat.keys()
    for path, g in flat.items():
        np.testing.assert_allclose(got[path], g, atol=1e-5, rtol=1e-5, err_msg=path)
    assert min(_cosine(got[p].ravel(), g.ravel()) for p, g in flat.items() if g.any()) > 0.9999


def test_highres_task_carries_the_224_weights(monkeypatch):
    """The 448-px towers are the seed's 224-px ones with the position table
    interpolated (197 -> 785 rows); every other tensor is the same."""
    built, towers = [], flagship._towers
    monkeypatch.setattr(flagship, "_towers",
                        lambda seed: built.append(towers(seed)) or dict(built[-1]))
    task = flagship.highres_training_task("cpu", seed=0)
    low, high = built[0]["rgb"], task.encoders["rgb"]
    assert high.config["img_size"] == 448 and high.pos_embed.shape == (1, 785, 768)
    want = interpolate_pos_embed(low.pos_embed.detach(), (28, 28), (14, 14), 1)
    torch.testing.assert_close(high.pos_embed.detach(), want, rtol=0, atol=0)
    for (name, a), (_, b) in zip(low.state_dict().items(), high.state_dict().items()):
        if name != "pos_embed":
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    batch = flagship.highres_batch(2, torch.Generator().manual_seed(0), "cpu")
    assert batch["rgb"].shape == (2, 448, 448, 3) and batch["rgb"].dtype == torch.bfloat16
    assert batch["text"].shape == (2, flagship.TEXT_LENGTH)
    assert task.training and task.configure_optimizers(max_steps=10)[0].defaults[
        "weight_decay"] == 0.01


@pytest.mark.cuda
def test_cuda_flash_branch_vit_matches_cpu():
    """The tiny flash-branch ViT on the card (K3f, K2f) against the plain
    versions on the CPU, f32: sums in another order, atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    _, _, vit, images = _flash_vit()
    x = torch.from_numpy(images)
    with torch.no_grad():
        want = vit(x).pooler_output
        before = fl.LAUNCHES["flash_fwd"]
        got = vit.cuda()(x.cuda()).pooler_output.cpu()
    assert fl.LAUNCHES["flash_fwd"] == before + FLASH_VISION["depth"]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
