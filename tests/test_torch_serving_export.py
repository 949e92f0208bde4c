"""Serving artifacts of the PyTorch port against the JAX package's, on the CPU.

Each port artifact (``torch.export`` programs, :mod:`mmlearn_tpu_torch.serving.export`)
is written from a port task that carries the JAX task's weights
(``mmlearn_tpu_torch.bridge``) and held, loaded, against the JAX artifact of
the same task (``mmlearn_tpu.serving``) at batch sizes 1, 3 and 5 from one
program, to the JAX test's tolerance; and bit for bit against the port's
eager ``encode``. The programs call the registered operators of the
kernels, and load in a process where the port's model code is blocked.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from mmlearn_tpu.modules.encoders import TextTransformer as JText
from mmlearn_tpu.modules.encoders import VisionTransformer as JVision
from mmlearn_tpu.modules.encoders import VisionTransformerPredictor as JPredictor
from mmlearn_tpu.modules.encoders.bert import BertTextEncoder as JBert
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu.serving import load_encoder as jax_load_encoder
from mmlearn_tpu.serving import save_encoder as jax_save_encoder
from mmlearn_tpu.tasks import IJEPA as JIJEPA
from mmlearn_tpu.tasks import ContrastivePretraining as JTask
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.modules.encoders import (
    TextTransformer,
    VisionTransformer,
    VisionTransformerPredictor,
)
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.ops import registered
from mmlearn_tpu_torch.serving import export_encoder, load_encoder, save_encoder
from mmlearn_tpu_torch.tasks import IJEPA, ContrastivePretraining

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # tests/test_serving_export.py's tolerance
SIZES = (1, 3, 5)

# the JAX test's towers (tests/test_serving_export.py:16-35)
VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4, use_cls_token=True,
              global_pool="cls", proj_dim=16)
TEXT = dict(vocab_size=32, max_length=8, embed_dim=32, depth=2, num_heads=4, causal=True,
            pooling="eos", proj_dim=16)
# two heads of 64: a head group of K1 (the JAX rule's), so the BERT tower runs K1
BERT = dict(vocab_size=40, max_length=12, embed_dim=128, depth=1, num_heads=2, pooling="mean",
            proj_dim=16)
#: operations of the attention's and the LayerNorm's plain versions
PLAIN = ("aten.einsum", "aten._softmax", "aten.softmax", "aten.rsqrt", "aten.amax")


class MeanTokens(torch.nn.Module):
    """The port's counterpart of the JAX postprocessor ``x.mean(axis=1)``."""

    def forward(self, x):
        return x.mean(dim=1)


def _rows(key, n, seed):
    """``n`` rows of the modality's inputs, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if key == "rgb":
        return {"rgb": rng.standard_normal((n, 16, 16, 3)).astype(np.float32)}
    if key == "text":
        return {"text": rng.integers(1, 30, (n, 8)).astype(np.int32)}
    ids = rng.integers(1, BERT["vocab_size"], (n, BERT["max_length"])).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, keep in enumerate(rng.integers(3, BERT["max_length"] + 1, n)):
        mask[i, :keep] = 1
    return {"text": ids, "text_attention_mask": mask}


def _contrastive(case):
    """A JAX task with its parameters, and its port with the same weights,
    for ``case``: ``rgb`` and ``text`` (the JAX test's pair), ``head`` (the
    text tower with an MLP head), ``postprocessor`` (the image tower's tokens
    mean-pooled by a postprocessor), ``bert`` (a BERT tower with a key mask)."""
    if case == "bert":
        jenc, penc = {"text": JBert(**BERT)}, {"text": BertTextEncoder(**BERT)}
    else:
        jenc = {"rgb": JVision(**VISION), "text": JText(**TEXT)}
        penc = {"rgb": VisionTransformer(**VISION), "text": TextTransformer(**TEXT)}
    jkw, pkw = {}, {}
    if case == "head":
        jkw["heads"] = {"text": JMLP(out_dim=24, hidden_dims=[40])}
        pkw["heads"] = {"text": MLP(16, out_dim=24, hidden_dims=[40])}
    if case == "postprocessor":
        jkw["postprocessors"] = {"rgb": lambda x: x.mean(axis=1)}
        pkw["postprocessors"] = {"rgb": MeanTokens()}
    jtask = JTask(encoders=jenc, optimizer=functools.partial(optax.adamw, learning_rate=1e-3),
                  **jkw)
    batch = {**_rows("bert" if case == "bert" else "text", 4, 0),
             **({} if case == "bert" else _rows("rgb", 4, 0))}
    params = jax.device_get(jtask.init_params(jax.random.key(0), batch))
    ptask = ContrastivePretraining(penc, **pkw)
    ptask.load_state_dict(bridge.task_jax_to_torch(params), strict=True)
    return jtask, params, ptask.eval(), batch


CASES = {"rgb": "rgb", "text": "text", "head": "text", "postprocessor": "rgb", "bert": "text"}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each case's port and JAX artifacts, and the port task."""
    out = {}
    for case, modality in CASES.items():
        jtask, params, ptask, batch = _contrastive(case)
        root = tmp_path_factory.mktemp(case)
        feed = {k: v for k, v in batch.items() if k.startswith(modality)}
        save_encoder(str(root / "port"), ptask, modality, feed)
        jax_save_encoder(str(root / "jax"), jtask, params, modality, feed, platforms=("cpu",))
        out[case] = (root, ptask, modality)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_the_jax_artifact(artifacts, case):
    """One program, batch sizes 1, 3 and 5: the JAX artifact's embeddings
    to 1e-5, and the port's eager ``encode`` bit for bit."""
    root, ptask, modality = artifacts[case]
    port = load_encoder(str(root / "port"), device="cpu")
    jserve = jax_load_encoder(str(root / "jax"))
    key = "bert" if case == "bert" else modality
    for n in SIZES:
        rows = _rows(key, n, seed=10 + n)
        got = port(rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(jserve(rows)), atol=ATOL)
        with torch.inference_mode():
            assert torch.equal(got, ptask.encode(rows, modality, normalize=True))
    assert port.meta["embedding_dim"] == got.shape[-1]


def test_ijepa_encoder_artifact_matches_jax(tmp_path):
    """The I-JEPA encoder's artifact (``tests/test_serving_export.py:68``'s
    counterpart)."""
    enc = dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=4)
    pred = dict(num_patches=4, embed_dim=32, predictor_embed_dim=32, depth=1, num_heads=4)
    jtask = JIJEPA(encoder=JVision(**enc), predictor=JPredictor(**pred),
                   optimizer=functools.partial(optax.adamw, learning_rate=1e-3))
    batch = _rows("rgb", 4, 0)
    params = jax.device_get(jtask.init_params(jax.random.key(0), batch))
    ptask = IJEPA(encoder=VisionTransformer(**enc), predictor=VisionTransformerPredictor(**pred))
    ptask.load_state_dict(bridge.ijepa_jax_to_torch(params), strict=True)
    save_encoder(str(tmp_path / "port"), ptask.eval(), "rgb", batch)
    jax_save_encoder(str(tmp_path / "jax"), jtask, params, "rgb", batch, platforms=("cpu",))
    port = load_encoder(str(tmp_path / "port"), device="cpu")
    jserve = jax_load_encoder(str(tmp_path / "jax"))
    for n in SIZES:
        rows = _rows("rgb", n, seed=20 + n)
        np.testing.assert_allclose(port(rows).numpy(), np.asarray(jserve(rows)), atol=ATOL)
    # the student's weights under its own paths; the predictor is not read
    weights = np.load(tmp_path / "port" / "weights.npz")
    assert sorted(weights.files) == sorted(bridge.flatten(params["encoder"]))


def test_meta_keys_and_weights_follow_the_jax_artifact(artifacts):
    """``meta.json`` has the JAX artifact's keys; a tower with a head keeps
    the head's weights under the task's paths."""
    for case in CASES:
        root = artifacts[case][0]
        meta = json.loads((root / "port" / "meta.json").read_text())
        jmeta = json.loads((root / "jax" / "meta.json").read_text())
        assert set(meta) == set(jmeta)
        for key in ("modality", "normalized", "embedding_dim", "inputs"):
            assert meta[key] == jmeta[key], (case, key)
        assert meta["platforms"] == ["cpu"]
    weights = np.load(artifacts["head"][0] / "port" / "weights.npz").files
    assert {k.split("/")[0] for k in weights} == {"encoders", "heads"}
    assert "heads/text/fc2/kernel" in weights


@pytest.mark.parametrize("case", ["rgb", "bert"])
def test_graph_calls_the_registered_operators(artifacts, case):
    """The program calls K1's (BERT: N=12), K2f's and K3f's (the 5-token
    image tower, whose heads K1 does not take) operators, and holds none of
    their plain versions' operations."""
    root, _, _ = artifacts[case]
    program = torch.export.load(str(root / "port" / "encoder.cpu.pt2"))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    attention = "mmlearn.flash_qkv.default" if case == "rgb" else "mmlearn.fused_mha.default"
    assert {attention, "mmlearn.add_layernorm.default"} <= targets
    assert not {t for t in targets if t.startswith(PLAIN)}


def test_artifact_loads_without_the_model_code(artifacts, tmp_path):
    """A fresh process with the port's ``modules``, ``tasks``, ``bridge`` and
    ``peft`` blocked (and JAX) loads the artifacts and computes what the
    test process computes."""
    script = r"""
import importlib.abc, sys
import numpy as np
BLOCKED = ("mmlearn_tpu_torch.modules", "mmlearn_tpu_torch.tasks", "mmlearn_tpu_torch.bridge",
           "mmlearn_tpu_torch.peft", "jax", "jaxlib", "flax", "optax", "mmlearn_tpu.", "projects")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "mmlearn_tpu" or name.startswith(BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from mmlearn_tpu_torch.serving.export import load_encoder
for art, rows, out in zip(*[iter(sys.argv[1:])] * 3):
    with np.load(rows) as z:
        np.save(out, load_encoder(art, device="cpu")({k: z[k] for k in z.files}).numpy())
leaked = sorted(m for m in sys.modules if m.startswith(BLOCKED))
assert not leaked, leaked
print("ok")
"""
    args, want = [], {}
    for case in ("head", "bert"):
        root, ptask, modality = artifacts[case]
        rows = _rows("bert" if case == "bert" else modality, 3, seed=7)
        np.savez(tmp_path / f"{case}_rows.npz", **rows)
        args += [str(root / "port"), str(tmp_path / f"{case}_rows.npz"),
                 str(tmp_path / f"{case}_out.npy")]
        with torch.inference_mode():
            want[case] = ptask.encode(rows, modality, normalize=True).numpy()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    for case, emb in want.items():
        np.testing.assert_array_equal(np.load(tmp_path / f"{case}_out.npy"), emb)


def test_loading_to_cuda_without_a_cuda_program_raises(artifacts):
    with pytest.raises(ValueError, match="no cuda program"):
        load_encoder(str(artifacts["rgb"][0] / "port"), device="cuda")


def test_lora_is_exported_merged_and_the_trace_reads_no_factor():
    """A LoRA'd tower's program takes the merged weight as the layer's own
    and no LoRA factor; the task keeps its factors after the export."""
    from mmlearn_tpu_torch.peft import LoRAConfig

    task = ContrastivePretraining({"rgb": VisionTransformer(**VISION)},
                                  peft_configs={"rgb": LoRAConfig(r=2)},
                                  generator=torch.Generator().manual_seed(0)).eval()
    _, weights, signature, _ = export_encoder(task, "rgb", _rows("rgb", 2, 0))
    names = [p["name"] for p in signature["params"]]
    assert names and not any(n.startswith("lora.") for n in names)
    assert all("lora" in m.__dict__ for m in task.modules()
               if hasattr(m, "merged_weight") and m.weight.shape[0] == 96)
    qkv = task.encoders["rgb"].blocks[0].attn.qkv
    np.testing.assert_array_equal(weights["blocks_0/attn/qkv/kernel"],
                                  qkv.merged_weight().detach().numpy().T)


def _op_args():
    rng = np.random.default_rng(0)

    def f(*shape, dtype=np.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype))

    mask = torch.from_numpy(rng.integers(0, 2, (2, 7)).astype(bool))
    mask[:, 0] = True
    qw = torch.from_numpy(rng.integers(-127, 128, (16, 24)).astype(np.int8))
    return {
        "fused_mha": [(f(2, 7, 48), mask, 2, 0.25, True, False), (f(2, 7, 48), None, 2, 0.25,
                                                                  False, False)],
        "layernorm": [(f(3, 5, 16), f(16), f(16), 1e-6)],
        "add_layernorm": [(f(3, 5, 16), f(3, 5, 16), f(16), f(16), 1e-6)],
        "flash_qkv": [(f(2, 7, 48), mask, 2, 0.25, True), (f(2, 7, 48), None, 2, 0.25, False)],
        "int8_qmm": [(f(2, 9, 24), qw, f(16).abs() + 0.01, f(16)),
                     (f(9, 24), qw, f(16).abs() + 0.01, None)],
    }


@pytest.mark.parametrize("name", list(registered.OPERATORS))
def test_operator_opcheck(name):
    """``torch.library.opcheck``: each operator's CPU implementation against
    its fake one (schema, fake tensors, the dispatch under tracing)."""
    for args in _op_args()[name]:
        torch.library.opcheck(registered.OPERATORS[name], args)
