"""Encoders and the contrastive task of the PyTorch port against the JAX
package: the same weights (through ``mmlearn_tpu_torch.bridge``) and the
same numpy inputs give the same embeddings in f32 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
from mmlearn_tpu_torch.tasks import ContrastivePretraining

ATOL = 1e-5  # f32 end to end; sums in another order

# the geometry of tests/test_serving_export.py::_tiny_task_and_batch
TINY_VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
                   use_cls_token=True, global_pool="cls", proj_dim=16)
TINY_TEXT = dict(vocab_size=32, max_length=8, embed_dim=32, depth=2, num_heads=4,
                 causal=True, pooling="eos", proj_dim=16)


def tiny_pair(scan_blocks=False):
    """The tiny JAX task with params and batch, and its port."""
    jtask = JTask(
        encoders={"rgb": JVision(**TINY_VISION, scan_blocks=scan_blocks),
                  "text": JText(**TINY_TEXT, scan_blocks=scan_blocks)},
        optimizer=functools.partial(optax.adamw, learning_rate=1e-3),
    )
    rng = np.random.default_rng(0)
    batch = {
        "rgb": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
        "text": rng.integers(1, 30, (4, 8)).astype(np.int32),
    }
    params = jtask.init_params(jax.random.key(0), batch)
    ptask = port_of(params, TINY_VISION, TINY_TEXT)
    return jtask, params, batch, ptask


def port_of(params, vision_kw, text_kw):
    vision, text = VisionTransformer(**vision_kw), TextTransformer(**text_kw)
    host = jax.device_get(params["encoders"])
    vision.load_state_dict(bridge.jax_to_torch(host["rgb"]))
    text.load_state_dict(bridge.jax_to_torch(host["text"]))
    return ContrastivePretraining({"rgb": vision, "text": text}).eval()


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["per_layer", "scanned"])
@pytest.mark.parametrize("modality", ["rgb", "text"])
def test_tiny_encode_matches_jax(scan_blocks, modality):
    jtask, params, batch, ptask = tiny_pair(scan_blocks)
    want = np.asarray(jtask.encode(params, batch, modality, normalize=True))
    with torch.inference_mode():
        got = ptask.encode(batch, modality, normalize=True).numpy()
    assert got.shape == (4, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiny_text_with_padding_mask_matches_jax():
    jtask, params, batch, ptask = tiny_pair()
    mask = np.ones((4, 8), np.int32)
    mask[0, 5:] = 0
    mask[2, 3:] = 0
    batch = dict(batch, text_attention_mask=mask)
    want = np.asarray(jtask.encode(params, batch, "text", normalize=True))
    with torch.inference_mode():
        got = ptask.encode(batch, "text", normalize=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_text_pooling_matches_jax(pooling):
    kw = dict(TINY_TEXT, pooling=pooling)
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 30, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 5:] = 0  # mean pooling averages valid tokens only
    jm = JText(**kw)
    params = jm.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)).pooler_output
    pm = TextTransformer(**kw)
    pm.load_state_dict(bridge.jax_to_torch(jax.device_get(params)))
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(ids), torch.from_numpy(mask)).pooler_output
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_forward_embeds_every_modality_in_the_batch():
    jtask, params, batch, ptask = tiny_pair()
    want = jtask.forward(params, batch)
    with torch.inference_mode():
        got = ptask(batch)
    assert set(got) == set(want) == {"rgb_embedding", "text_embedding"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)
    with torch.inference_mode():
        only_rgb = ptask({"rgb": batch["rgb"]})
    assert set(only_rgb) == {"rgb_embedding"}


def test_encode_runs_postprocessor_then_head():
    _, _, batch, ptask = tiny_pair()
    encoder = ptask.encoders["rgb"]

    class FirstToken(torch.nn.Module):
        def forward(self, x):
            return x[:, 0]

    head = torch.nn.Linear(32, 8)
    task = ContrastivePretraining({"rgb": encoder}, heads={"rgb": head},
                                  postprocessors={"rgb": FirstToken()})
    with torch.inference_mode():
        got = task.encode(batch, "rgb", normalize=True)
        h = head(encoder(torch.from_numpy(batch["rgb"])).last_hidden_state[:, 0])
    torch.testing.assert_close(got, h / h.norm(dim=-1, keepdim=True))


def test_shared_encoder_key_mapping():
    """Two modalities mapped to one encoder key share that module."""
    _, _, batch, ptask = tiny_pair()
    shared = ContrastivePretraining(
        {"shared": ptask.encoders["rgb"]},
        modality_module_mapping={"rgb": {"encoder_key": "shared"},
                                 "depth": {"encoder_key": "shared"}},
    )
    assert shared.modalities == ["rgb", "depth"]
    with torch.inference_mode():
        a = shared.encode({"rgb": batch["rgb"]}, "rgb")
        b = shared.encode({"depth": batch["rgb"]}, "depth")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no such encoder"):
        ContrastivePretraining({"rgb": ptask.encoders["rgb"]},
                               modality_module_mapping={"text": {"encoder_key": "t"}})


# the flagship (__graft_entry__._flagship_task) at full width, batch 1, f32:
# 13 s (image) and 8 s (text) on an 8-core CPU host
FLAGSHIP_VISION = dict(img_size=224, patch_size=16, embed_dim=768, depth=12,
                       num_heads=12, use_cls_token=True, learned_pos_embed=True,
                       pre_norm=True, act_layer="quick_gelu", global_pool="cls",
                       proj_dim=512)
FLAGSHIP_TEXT = dict(vocab_size=49408, max_length=77, embed_dim=512, depth=12,
                     num_heads=8, causal=True, pooling="eos", proj_dim=512)
FLAGSHIP_ATOL = 2e-5  # 12 f32 blocks at width 768; measured 3.6e-6


@pytest.mark.parametrize("modality", ["rgb", "text"])
def test_flagship_geometry_matches_jax(modality):
    rng = np.random.default_rng(1)
    if modality == "rgb":
        jm, pm = JVision(**FLAGSHIP_VISION, scan_blocks=True), VisionTransformer(**FLAGSHIP_VISION)
        args = (rng.standard_normal((1, 224, 224, 3)).astype(np.float32),)
    else:
        jm, pm = JText(**FLAGSHIP_TEXT, scan_blocks=True), TextTransformer(**FLAGSHIP_TEXT)
        ids = rng.integers(1, 49406, (1, 77)).astype(np.int32)
        ids[0, 40] = 49407  # end of text
        args = (ids, (np.arange(77) <= 40)[None].astype(np.int32))
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(jm.init)(jax.random.key(0), *jargs)["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *jargs).pooler_output)
    pm.load_state_dict(bridge.jax_to_torch(jax.device_get(params)))
    with torch.inference_mode():
        got = pm.eval()(*(torch.from_numpy(a) for a in args)).pooler_output.numpy()
    assert got.shape == (1, 512)
    np.testing.assert_allclose(got, want, atol=FLAGSHIP_ATOL)
