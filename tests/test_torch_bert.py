"""The port's BERT towers against the JAX package's: ``BertTextEncoder`` in
every pooling mode with ragged masks and token types, ``BarcodeBERT``'s
outputs and gradients, remat against no remat, the ``MLP``'s LayerNorm
between layers, the modality registry's ``register_modality`` and the DNA
tokenizer.

Tiny towers (width 32, 2 blocks, 4 heads) with the JAX package's init
carried across by ``bridge.jax_to_torch``; inputs from numpy seeds. f32 on
the CPU in both packages: outputs atol 1e-5 (sums in another order, as the
port's other encoder tests), gradients atol and rtol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlearn_tpu.modules.encoders.bert import BertTextEncoder as JBert
from mmlearn_tpu.modules.layers.mlp import MLP as JMLP
from mmlearn_tpu_torch import bridge
from mmlearn_tpu_torch.datasets.core.modalities import Modalities, ModalityRegistry
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.layers.mlp import MLP
from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor
from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT
from projects.bioscan_clip.dna_tokenizer import DNAProcessor as JDNAProcessor
from projects.bioscan_clip.encoders import BarcodeBERT as JBarcodeBERT

ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-5, 2e-5
BERT = dict(vocab_size=40, max_length=16, embed_dim=32, depth=2, num_heads=4)
BARCODE = dict(vocab_size=19, projection_dim=24, embed_dim=32, depth=2, num_heads=4,
               max_length=16)


def text_inputs(seed: int = 0, b: int = 3, n: int = 12):
    """Token ids, a ragged key mask (every row keeps 4 or more tokens) and
    token types that switch to segment 1 part way."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT["vocab_size"], (b, n)).astype(np.int32)
    mask = np.zeros((b, n), np.int32)
    types = np.zeros((b, n), np.int32)
    for i, keep in enumerate(rng.integers(4, n + 1, b)):
        mask[i, :keep] = 1
        types[i, keep // 2:keep] = 1
    return ids, mask, types


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("pooling,use_pooler,proj_dim", [
    ("pooler", True, None), ("pooler", True, 8), ("pooler", False, None), ("cls", True, 8),
    ("mean", True, None), ("mean", True, 8), ("none", True, None)])
@pytest.mark.parametrize("masked", [True, False])
def test_bert_text_encoder_matches_jax(pooling, use_pooler, proj_dim, masked):
    ids, mask, types = text_inputs()
    mask = mask if masked else None
    cfg = dict(BERT, pooling=pooling, use_pooler=use_pooler, proj_dim=proj_dim)
    jmod = JBert(**cfg)
    params = jmod.init(jax.random.key(0), ids, attention_mask=mask, token_type_ids=types)["params"]
    want = jmod.apply({"params": params}, ids, attention_mask=mask, token_type_ids=types)
    mod = BertTextEncoder(**cfg)
    mod.load_state_dict(bridge.jax_to_torch(params), strict=True)
    with torch.no_grad():
        got = mod(t(ids), None if mask is None else t(mask), t(types))
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want.last_hidden_state),
                               atol=ATOL)
    if want.pooler_output is None:
        assert got.pooler_output is None
    else:
        np.testing.assert_allclose(got.pooler_output.numpy(), np.asarray(want.pooler_output),
                                   atol=ATOL)
    # the bridge both ways: the port's parameters are the JAX tree
    back = bridge.torch_to_jax(mod)
    flat = bridge.flatten(jax.device_get(params))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def _barcode_pair(seed: int = 1):
    ids, mask, _ = text_inputs(seed, n=10)
    ids = ids % BARCODE["vocab_size"]
    jmod = JBarcodeBERT(**BARCODE)
    params = jmod.init(jax.random.key(seed), ids, attention_mask=mask)["params"]
    mod = BarcodeBERT(**BARCODE)
    mod.load_state_dict(bridge.jax_to_torch(params), strict=True)
    return jmod, params, mod, ids, mask


def test_barcode_bert_outputs_and_gradients_match_jax():
    jmod, params, mod, ids, mask = _barcode_pair()
    rng = np.random.default_rng(5)
    w_pool = rng.standard_normal((ids.shape[0], BARCODE["projection_dim"])).astype(np.float32)
    w_seq = rng.standard_normal((*ids.shape, BARCODE["projection_dim"])).astype(np.float32)

    def jloss(p):
        out = jmod.apply({"params": p}, ids, attention_mask=mask)
        return (out.pooler_output * w_pool).sum() + (out.last_hidden_state * w_seq).sum() * 1e-2

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    out = mod(t(ids), t(mask))
    loss = (out.pooler_output * t(w_pool)).sum() + (out.last_hidden_state * t(w_seq)).sum() * 1e-2
    loss.backward()
    want_out = jmod.apply({"params": params}, ids, attention_mask=mask)
    np.testing.assert_allclose(out.pooler_output.detach().numpy(),
                               np.asarray(want_out.pooler_output), atol=ATOL)
    np.testing.assert_allclose(out.last_hidden_state.detach().numpy(),
                               np.asarray(want_out.last_hidden_state), atol=ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    want = bridge.jax_to_torch(jax.device_get(jgrad))
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("tower", ["bert", "barcode"])
def test_remat_equals_no_remat(tower):
    """Checkpointed blocks compute the same bits as plain ones, forward and
    backward."""
    ids, mask, types = text_inputs(2)
    outs = []
    for remat in (False, True):
        if tower == "bert":
            mod = BertTextEncoder(**BERT, pooling="mean", remat=remat,
                                  generator=torch.Generator().manual_seed(0))
            out = mod(t(ids), t(mask), t(types)).pooler_output
        else:
            mod = BarcodeBERT(**BARCODE, remat=remat, generator=torch.Generator().manual_seed(0))
            out = mod(t(ids % BARCODE["vocab_size"]), t(mask)).pooler_output
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        outs.append((out.detach(), {n: p.grad for n, p in mod.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for name, grad in outs[0][1].items():
        assert torch.equal(grad, outs[1][1][name]), name


def test_mlp_with_layernorm_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 20)).astype(np.float32)
    jmod = JMLP(out_dim=16, hidden_dims=[24, 12], norm_layer="layernorm", activation="gelu")
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    mod = MLP(20, out_dim=16, hidden_dims=[24, 12], norm_layer="layernorm")
    mod.load_state_dict(bridge.jax_to_torch(params), strict=True)
    assert set(dict(mod.named_children())) == {"fc1", "norm1", "fc2", "norm2", "fc3"}
    with torch.no_grad():
        got = mod(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply({"params": params}, x)), atol=ATOL)


def test_register_modality():
    reg = ModalityRegistry()
    dna = reg.register_modality("DNA")
    assert reg.has_modality("dna") and dna.attention_mask == "dna_attention_mask"
    assert dna.embedding == "dna_embedding" and reg.get_modality("dna") is dna
    with pytest.raises(AttributeError):
        dna.label
    assert [m.name for m in reg.list_modalities()][-1] == "dna"
    with pytest.warns(UserWarning, match="already registered"):
        reg.register_modality("dna")
    # importing the project registers dna in the process-wide registry
    assert Modalities.has_modality("dna")


def test_dna_tokenizer_matches_the_project():
    rng = np.random.default_rng(0)
    ours, theirs = DNAProcessor(), JDNAProcessor()
    assert ours.seq_length == theirs.seq_length == 133 and ours.vocab == theirs.vocab
    for n in (0, 7, 400, 660, 700):
        seq = "".join(rng.choice(list("ACGTN"), n))
        np.testing.assert_array_equal(ours(seq), theirs(seq))
