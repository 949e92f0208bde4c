"""The port's checkpoint converters, encoder factories and exporters.

- every converter's output equals ``bridge.jax_to_torch`` of the JAX
  package's converter on the same torch state dict, bit for bit (tiny HF
  CLIP, BERT, ``BertForMaskedLM`` and ViT models; a synthetic timm ViT; the
  recorded reference I-JEPA checkpoint);
- the factories' features against the HF torch model's own forward, at the
  JAX package's tolerances for the same check (atol 5e-4 and rtol 1e-3 for
  the CLIP factories, as ``tests/tasks/test_pretrained_wrappers.py``; 3e-4
  and 1e-3 for BERT and ViT, as ``tests/modules/test_hf_conversion.py``),
  and the same tower from a config mapping and a state dict;
- ``hf_export``: each export loads into the torch model it came from
  (``strict=True``) and gives back its weights bit for bit; ``export_task``
  merges LoRA and folds a ``Dense`` head.
"""

import jax
import numpy as np
import pytest
import torch

from mmlearn_tpu import hf_utils as J
from mmlearn_tpu.modules.encoders.hf_wrappers import convert_hf_vit as jax_convert_hf_vit
from mmlearn_tpu_torch import bridge, hf_export
from mmlearn_tpu_torch import hf_utils as H
from mmlearn_tpu_torch.lightning_import import _load_ckpt
from mmlearn_tpu_torch.modules.encoders import VisionTransformer
from mmlearn_tpu_torch.modules.encoders.bert import BertTextEncoder
from mmlearn_tpu_torch.modules.encoders.clip import (
    HFCLIPTextEncoder,
    HFCLIPTextEncoderWithProjection,
    HFCLIPVisionEncoder,
    HFCLIPVisionEncoderWithProjection,
)
from mmlearn_tpu_torch.modules.encoders.hf_wrappers import (
    HFTextEncoder,
    HFViTEncoder,
    TimmViT,
    convert_hf_vit,
)
from mmlearn_tpu_torch.modules.layers.dense import Dense
from mmlearn_tpu_torch.peft import LoRAConfig
from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT, load_barcode_bert_checkpoint
from mmlearn_tpu_torch.tasks import ContrastivePretraining
from projects.bioscan_clip.encoders import load_barcode_bert_checkpoint as jax_load_barcode
from tests.test_lightning_import import IJEPA_CKPT

transformers = pytest.importorskip("transformers")

HEADS = 4


@pytest.fixture(scope="module")
def clip_model():
    config = transformers.CLIPConfig(
        text_config=transformers.CLIPTextConfig(
            vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=HEADS, max_position_embeddings=16, eos_token_id=98).to_dict(),
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=HEADS, image_size=32, patch_size=8).to_dict(),
        projection_dim=24)
    torch.manual_seed(0)
    return transformers.CLIPModel(config).eval()


def _bert_config():
    return transformers.BertConfig(vocab_size=50, hidden_size=32, num_hidden_layers=2,
                                   num_attention_heads=HEADS, intermediate_size=64,
                                   max_position_embeddings=20)


@pytest.fixture(scope="module")
def bert_model():
    torch.manual_seed(1)
    return transformers.BertModel(_bert_config()).eval()


@pytest.fixture(scope="module")
def vit_model():
    config = transformers.ViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=HEADS,
                                    intermediate_size=64, image_size=32, patch_size=8)
    torch.manual_seed(2)
    return transformers.ViTModel(config, add_pooling_layer=False).eval()


def timm_state_dict(seed: int = 3, head: int = 24) -> dict:
    """A timm ``VisionTransformer``'s state dict (width 32, 2 blocks, 16 px
    patches of 32 px images), random."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    sd = {"cls_token": r(1, 1, 32), "pos_embed": r(1, 5, 32),
          "patch_embed.proj.weight": r(32, 3, 16, 16), "patch_embed.proj.bias": r(32),
          "norm.weight": r(32), "norm.bias": r(32), "head.weight": r(head, 32),
          "head.bias": r(head)}
    for i in range(2):
        for name, shape in (("norm1", (32,)), ("norm2", (32,)), ("attn.qkv", (96, 32)),
                            ("attn.proj", (32, 32)), ("mlp.fc1", (128, 32)),
                            ("mlp.fc2", (32, 128))):
            sd[f"blocks.{i}.{name}.weight"] = r(*shape)
            sd[f"blocks.{i}.{name}.bias"] = r(shape[0])
    return sd


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _converter_cases(clip_model, bert_model, vit_model):
    clip_sd = clip_model.state_dict()
    torch.manual_seed(4)
    mlm = transformers.BertForMaskedLM(_bert_config()).eval().state_dict()
    ijepa = _load_ckpt(IJEPA_CKPT)["state_dict"]
    enc = {k[len("encoder."):]: v for k, v in ijepa.items() if k.startswith("encoder.")}
    pred = {k[len("predictor."):]: v for k, v in ijepa.items() if k.startswith("predictor.")}
    timm = timm_state_dict()
    return {
        "clip_vision": (H.convert_clip_vision, J.convert_clip_vision, (clip_sd, 2),
                        dict(num_heads=HEADS)),
        "clip_vision_bare": (H.convert_clip_vision, J.convert_clip_vision,
                             ({f"model.{k[len('vision_model.'):]}": v for k, v in clip_sd.items()
                               if k.startswith("vision_model.")}, 2),
                             dict(prefix="model", projection_key=None, num_heads=HEADS)),
        "clip_text": (H.convert_clip_text, J.convert_clip_text, (clip_sd, 2),
                      dict(num_heads=HEADS)),
        "bert": (H.convert_bert, J.convert_bert, (bert_model.state_dict(), 2),
                 dict(num_heads=HEADS)),
        "bert_mlm": (H.convert_bert_mlm, J.convert_bert_mlm, (mlm, 2), dict(num_heads=HEADS)),
        "barcode_bert": (load_barcode_bert_checkpoint, jax_load_barcode, (mlm, 2, 50),
                         dict(num_heads=HEADS)),
        "hf_vit": (convert_hf_vit, jax_convert_hf_vit, (vit_model.state_dict(), 2),
                   dict(prefix="", num_heads=HEADS)),
        "timm_vit": (H.convert_timm_vit, J.convert_timm_vit, (timm,), dict(num_heads=HEADS)),
        "ijepa_vit": (H.convert_ijepa_vit, J.convert_ijepa_vit, (enc, 2, HEADS), {}),
        "ijepa_predictor": (H.convert_ijepa_predictor, J.convert_ijepa_predictor,
                            (pred, 1, HEADS), {}),
    }


CONVERTERS = ("clip_vision", "clip_vision_bare", "clip_text", "bert", "bert_mlm",
              "barcode_bert", "hf_vit", "timm_vit", "ijepa_vit", "ijepa_predictor")


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_equals_bridge_of_jax_converter(name, clip_model, bert_model, vit_model):
    ours, theirs, args, kwargs = _converter_cases(clip_model, bert_model, vit_model)[name]
    want = bridge.jax_to_torch(jax.device_get(theirs(*args, **kwargs)))
    _assert_same(ours(*args, **kwargs), want)


def test_timm_geometry_matches_jax():
    sd = timm_state_dict()
    assert H.timm_vit_geometry(sd, num_heads=HEADS) == J.timm_vit_geometry(sd, num_heads=HEADS)
    assert H.infer_num_heads(1280) == J._infer_num_heads(1280) == 16


def _clip_inputs():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, (2, 12)).astype(np.int64)
    ids[:, -1] = 98
    return imgs, ids


def test_clip_factories_match_the_torch_model(clip_model):
    imgs, ids = _clip_inputs()
    with torch.no_grad():
        want_img = clip_model.get_image_features(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2)))
        want_txt = clip_model.get_text_features(input_ids=torch.from_numpy(ids))
        vis_pool = clip_model.vision_model(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).pooler_output
        txt_pool = clip_model.text_model(input_ids=torch.from_numpy(ids)).pooler_output
        got = {
            "img": HFCLIPVisionEncoderWithProjection(clip_model)(torch.from_numpy(imgs)),
            "txt": HFCLIPTextEncoderWithProjection(clip_model)(torch.from_numpy(ids)),
            "vis": HFCLIPVisionEncoder(clip_model)(torch.from_numpy(imgs)),
            "tpool": HFCLIPTextEncoder(clip_model)(torch.from_numpy(ids)),
        }
    tol = dict(atol=5e-4, rtol=1e-3)
    for key, want in (("img", want_img), ("txt", want_txt), ("vis", vis_pool),
                      ("tpool", txt_pool)):
        np.testing.assert_allclose(got[key].pooler_output.numpy(), want.numpy(), **tol,
                                   err_msg=key)
    # from a config mapping and a state dict: the same tower, bit for bit
    again = HFCLIPTextEncoderWithProjection(config=clip_model.config.to_dict(),
                                            state_dict=clip_model.state_dict())
    with torch.no_grad():
        assert torch.equal(again(torch.from_numpy(ids)).pooler_output, got["txt"].pooler_output)


def test_hf_text_encoder_matches_bert(bert_model):
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 50, (3, 10)))
    mask = torch.ones(3, 10, dtype=torch.long)
    mask[1, 6:] = 0
    enc = HFTextEncoder(bert_model)
    with torch.no_grad():
        got, want = enc(ids, mask), bert_model(input_ids=ids, attention_mask=mask)
    keep = mask.bool()
    np.testing.assert_allclose(got.last_hidden_state[keep].numpy(),
                               want.last_hidden_state[keep].numpy(), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got.pooler_output.numpy(), want.pooler_output.numpy(),
                               atol=3e-4, rtol=1e-3)
    assert isinstance(enc, BertTextEncoder)
    with pytest.raises(ValueError, match="decoder"):
        HFTextEncoder(config={**bert_model.config.to_dict(), "is_decoder": True},
                      state_dict=bert_model.state_dict())


def test_hf_vit_encoder_matches_vit(vit_model):
    imgs = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = HFViTEncoder(vit_model)(torch.from_numpy(imgs)).pooler_output
        want = vit_model(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy(), want.last_hidden_state[:, 0].numpy(), atol=3e-4,
                               rtol=1e-3)


def test_timm_vit_factory_loads_every_weight():
    sd = timm_state_dict(head=24)
    enc = TimmViT(state_dict=sd, projection_dim=24, num_heads=HEADS)
    _assert_same(dict(enc.state_dict()), H.convert_timm_vit(sd, num_heads=HEADS))
    # a head of another width (a classifier) is not the projection
    other = TimmViT(state_dict=timm_state_dict(head=10), projection_dim=24, num_heads=HEADS)
    assert other.proj.weight.shape == (24, 32)


def test_export_round_trips(clip_model, bert_model):
    vision = HFCLIPVisionEncoderWithProjection(clip_model)
    text = HFCLIPTextEncoderWithProjection(clip_model)
    exported = hf_export.export_clip(vision.state_dict(), text.state_dict(),
                                     float(clip_model.logit_scale.detach()), HEADS, HEADS)
    copy = transformers.CLIPModel(clip_model.config)
    copy.load_state_dict(exported, strict=True)
    _assert_same(dict(copy.state_dict()), dict(clip_model.state_dict()))

    bert = HFTextEncoder(bert_model)
    copy = transformers.BertModel(bert_model.config)
    copy.load_state_dict(hf_export.export_module(bert), strict=True)
    _assert_same(dict(copy.state_dict()), dict(bert_model.state_dict()))

    sd = timm_state_dict()
    timm = TimmViT(state_dict=sd, projection_dim=24, num_heads=HEADS)
    _assert_same(hf_export.export_module(timm), {k: v.float() for k, v in sd.items()})

    ijepa = _load_ckpt(IJEPA_CKPT)["state_dict"]
    for part, convert, export in (
            ("encoder", H.convert_ijepa_vit, hf_export.export_ijepa_vit),
            ("predictor", H.convert_ijepa_predictor, hf_export.export_ijepa_predictor)):
        src = {k[len(part) + 1:]: v for k, v in ijepa.items() if k.startswith(f"{part}.")
               and not k.endswith("pos_embed")}
        depth = 2 if part == "encoder" else 1
        _assert_same(export(convert(src, depth, HEADS), HEADS),
                     {k: v.float() for k, v in src.items()})


def test_export_task_merges_lora_and_folds_dense_heads(clip_model):
    torch.manual_seed(5)
    vision = HFCLIPVisionEncoder(clip_model)
    head = Dense(32, 24, False)
    task = ContrastivePretraining(
        {"rgb": vision, "text": HFCLIPTextEncoderWithProjection(clip_model)},
        heads={"rgb": head},
        peft_configs={"rgb": LoRAConfig(r=2, target_patterns=(r".*attn/qkv$",))})
    with torch.no_grad():
        for p in task.lora.parameters():
            p.normal_()
    out = hf_export.export_task(task)
    assert set(out) == {"rgb", "text", "logit_scale"}
    # the export is the task's function: a CLIP vision model loaded with it
    # projects as the task's rgb tower and head do
    cfg = transformers.CLIPVisionConfig(**clip_model.config.vision_config.to_dict())
    model = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(**{**cfg.to_dict(), "projection_dim": 24})).eval()
    model.load_state_dict(out["rgb"], strict=True)
    imgs, _ = _clip_inputs()
    with torch.no_grad():
        want = task.encode({"rgb": torch.from_numpy(imgs)}, "rgb")
        got = model(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).image_embeds
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4, rtol=1e-3)
    with pytest.raises(TypeError):
        hf_export.export_module(BarcodeBERT(vocab_size=19, projection_dim=8, embed_dim=32,
                                            depth=1, num_heads=4))
    assert isinstance(vision, VisionTransformer)
