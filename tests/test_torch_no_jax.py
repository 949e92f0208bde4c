"""The PyTorch port runs where JAX is absent, and ``chip_smoke.py`` has no
CPU fallback.

Both checks run in subprocesses: the test process itself has JAX loaded.
"""

import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mmlearn_tpu", "projects"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, NoJax())
import mmlearn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmlearn_tpu_torch.__path__,
                                               "mmlearn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
assert not leaked, leaked
print(len(names), "modules")
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300, check=False)


def test_every_module_imports_without_jax_or_flax():
    proc = _run([sys.executable, "-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 20  # every module was walked


def test_evaluation_layer_imports_without_jax():
    """The evaluation slice's public names, with JAX and the JAX package
    blocked."""
    names = ("from mmlearn_tpu_torch.tasks import EvaluationSpec, EvaluationHooks, "
             "EvalRuntime, ZeroShotCrossModalRetrieval, RetrievalTaskSpec, "
             "ZeroShotClassification, ClassificationTaskSpec, EmbeddingExport\n"
             "from mmlearn_tpu_torch.modules.metrics import RetrievalRecallAtK, "
             "top_k_accuracy, macro_precision, macro_recall, macro_f1, macro_auroc, "
             "binary_precision, binary_recall, binary_f1\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_large_presets_slice_imports_without_jax():
    """The layer and encoder options, the presets and the large builders,
    with JAX and the JAX package blocked."""
    names = ("from mmlearn_tpu_torch.modules.layers import Dropout, DropPath, MaskSource, "
             "masks_from, drop_path, PatchDropout, LearnableLogitScaling, ConvEmbed, "
             "get_1d_sincos_pos_embed\n"
             "from mmlearn_tpu_torch.modules.layers.dropout import step_source\n"
             "from mmlearn_tpu_torch.modules.layers.attention import materialized_attention\n"
             "from mmlearn_tpu_torch.modules.encoders import vit_tiny, vit_small, vit_base, "
             "vit_large, vit_huge, vit_giant\n"
             "from mmlearn_tpu_torch.flagship import vit_h14_training_task, vit_g14_task\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_readers_slice_imports_without_jax():
    """The readers and formats, the process loader and the native bindings,
    with JAX and the JAX package blocked."""
    names = ("from mmlearn_tpu_torch.datasets import MaterializedDataset, materialize\n"
             "from mmlearn_tpu_torch.datasets.core import StreamingDataset, TFRecordDataset, "
             "jsonl_open_shard, tfrecord_open_shard\n"
             "from mmlearn_tpu_torch.datasets.core.grain_loader import GrainDataLoader\n"
             "from mmlearn_tpu_torch.datasets.builtin import CheXpert, ImageNet, ImageTransform, "
             "LLVIP, LibriSpeech, NIHCXR, NYUv2, SUNRGBD\n"
             "from mmlearn_tpu_torch.datasets.builtin.image_utils import decode_transform_jpeg\n"
             "from mmlearn_tpu_torch import native\n"
             "assert native.crc32c(b'123456789') == 0xE3069283\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_encoders_and_weight_io_slice_imports_without_jax():
    """The BERT towers, the converters, LoRA, the importer, the exporters
    and the BIOSCAN-CLIP project, with JAX, the JAX package and the root
    ``projects`` package blocked; ``transformers`` and ``timm`` stay
    unimported until a model is asked for by name."""
    names = ("from mmlearn_tpu_torch.modules.encoders.bert import BertBlock, BertTextEncoder\n"
             "from mmlearn_tpu_torch.modules.encoders.hf_wrappers import HFTextEncoder, "
             "HFViTEncoder, TimmViT, convert_hf_vit\n"
             "from mmlearn_tpu_torch.modules.encoders.clip import HFCLIPTextEncoder, "
             "HFCLIPTextEncoderWithProjection, HFCLIPVisionEncoder, "
             "HFCLIPVisionEncoderWithProjection\n"
             "from mmlearn_tpu_torch.hf_utils import convert_clip_vision, convert_clip_text, "
             "clip_modules_from_config, convert_bert, timm_vit_geometry, convert_timm_vit, "
             "convert_bert_mlm, convert_ijepa_vit, convert_ijepa_predictor\n"
             "from mmlearn_tpu_torch.hf_export import export_clip, export_bert, "
             "export_timm_vit, export_module, export_task\n"
             "from mmlearn_tpu_torch.peft import LoRAConfig, init_lora, freeze_layers_mask, "
             "modules_to_save_mask\n"
             "from mmlearn_tpu_torch.lightning_import import import_lightning_checkpoint, "
             "convert_reference_state_dict, overlay_params\n"
             "from mmlearn_tpu_torch.modules.lr_schedulers import onecycle_lr\n"
             "import mmlearn_tpu_torch.projects\n"
             "from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT, "
             "load_barcode_bert_checkpoint\n"
             "from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor\n"
             "from mmlearn_tpu_torch.projects.bioscan_clip.eval_task import "
             "TaxonomicClassification, knn_predict\n"
             "from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task\n"
             "from mmlearn_tpu_torch.datasets.core.modalities import Modalities\n"
             "assert Modalities.has_modality('dna')\n"
             "assert not {'transformers', 'timm'} & set(sys.modules), 'eager import'\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_parallel_slice_imports_without_jax():
    """The parallel slice's modules and names (the mesh, collectives,
    partitioning and FSDP2 wrapper, the local launcher, the ring), with JAX
    and the JAX package blocked; the launcher's worker environment and the
    ring's list exchange run there too."""
    names = ("from mmlearn_tpu_torch.parallel import DATA_AXIS, FSDP_AXIS, SEQ_AXIS, "
             "MODEL_AXIS, MESH_AXES, MESH_AXES_SEQ, DEFAULT_RULES, all_gather, axis_index, "
             "axis_size, batch_spec, create_mesh, get_global_mesh, infer_param_specs, "
             "local_batch_size, local_loss_label_offset, pmean, process_allgather, psum, "
             "set_global_mesh, shard_batch, shard_task\n"
             "from mmlearn_tpu_torch.parallel.mesh import emulated_seq_mesh, init_from_env\n"
             "from mmlearn_tpu_torch.parallel.collectives import process_allgather_object, "
             "process_local_rows, process_local_rows_device\n"
             "from mmlearn_tpu_torch.parallel.partitioning import sync_replicated_grads\n"
             "from mmlearn_tpu_torch.parallel.mp_launch import free_port, run_workers, "
             "worker_env\n"
             "from mmlearn_tpu_torch.ops.ring_attention import ring_attention, "
             "ring_attention_blocks, sequence_sharded_attention, GroupExchange, "
             "ListExchange\n"
             "from mmlearn_tpu_torch.flagship import dryrun_multichip, tiny_training_task\n"
             "import torch\n"
             "assert worker_env(1, 2, 1234, {})['RANK'] == '1'\n"
             "q = torch.randn(1, 2, 8, 4)\n"
             "out = sequence_sharded_attention(q, q, q, ListExchange(2), causal=True)\n"
             "assert out.shape == q.shape\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_cuda_card(tmp_path):
    if not torch.cuda.is_available():
        # no CUDA card: the script must refuse, not fall back
        proc = _run([sys.executable, "chip_smoke.py"], REPO)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
    # alone in a directory, without the package it drives, it fails anywhere
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_tensor_parallel_slice_imports_without_jax():
    """The tensor-parallel slice's modules and names (the splits, the
    sharded plan, the attention layer's route, the bridge's loader), with
    JAX and the JAX package blocked; the plan of the tiny pair's splits,
    ``shard_plan`` and ``kernel_route`` run there too."""
    names = ("from mmlearn_tpu_torch.parallel.tensor_parallel import COLUMN, ROW, "
             "gather_heads, local_slice, parallelize, tp_plan\n"
             "from mmlearn_tpu_torch.ops.fused_attention import PLAIN_ROUTE, shard_plan\n"
             "from mmlearn_tpu_torch.modules.layers.attention import kernel_route\n"
             "from mmlearn_tpu_torch.bridge import load_state\n"
             "from mmlearn_tpu_torch.flagship import tiny_training_task\n"
             "from mmlearn_tpu_torch.parallel.mesh import Mesh, mesh_shape\n"
             "from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs\n"
             "mesh = Mesh(*mesh_shape(8, data=2, fsdp=2, model=2), 'cpu')\n"
             "task = tiny_training_task()\n"
             "plan = tp_plan(task, infer_param_specs(task, mesh), 2)\n"
             "assert plan['encoders.rgb.blocks.0.attn.qkv'] == (COLUMN, False)\n"
             "assert plan['encoders.text.blocks.1.mlp.fc2'] == (ROW, False)\n"
             "assert shard_plan(12, 64, 8, mesh) == 6 and shard_plan(2, 64, 8, mesh) == 'xla'\n"
             "assert kernel_route('cuda', 'xla', 1, 1, 64, 77) == 'flash'\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_project_layer_reads_without_pandas_datasets_or_h5py(tmp_path):
    """The project layer's modules and names (the med_benchmarking readers,
    transform and configs, BIOSCAN's dataset and configs, the W&B and
    TensorBoard loggers), with JAX, the JAX package and the root
    ``projects`` blocked, and ``pandas``, ``datasets`` and ``h5py`` blocked
    too (the card's host has none of them): the readers phase 18 runs
    construct and read their files; the others raise an ``ImportError``
    naming the package they need."""
    from chip_smoke import write_med_tree

    roots = write_med_tree(str(tmp_path), 2, 2, 2, hw=((20, 24),), mnist_px=16)
    names = ("from mmlearn_tpu_torch.projects.med_benchmarking.datasets import BACH, HAM10000, "
             "LC25000, MIMICIVCXR, PCAM, PMCOA, ROCO, SICAP, MedMNISTPlus, MedVQA, NckCrc, "
             "PadUfes20, Quilt, med_clip_vision_transform\n"
             "import mmlearn_tpu_torch.projects.med_benchmarking.configs\n"
             "from mmlearn_tpu_torch.projects.bioscan_clip.dataset import BIOSCANInsectDataset\n"
             "import mmlearn_tpu_torch.projects.bioscan_clip.configs\n"
             "from mmlearn_tpu_torch.trainer import TensorBoardLogger, WandbLogger\n"
             f"roots = {roots!r}\n"
             "read = [PMCOA(roots['pmcoa'], split='valid'), ROCO(roots['roco']), "
             "MIMICIVCXR(roots['mimic']), Quilt(roots['quilt']), HAM10000(roots['ham10000']), "
             "PadUfes20(roots['pad_ufes_20']), "
             "MedMNISTPlus('dermamnist', roots['medmnist'], split='test')]\n"
             "for ds in read:\n"
             "    ex = ds[len(ds) - 1]\n"
             "    assert ex['rgb'].shape == (224, 224, 3) and ex['rgb'].dtype.name == 'float32'\n"
             "assert med_clip_vision_transform(job_type='eval').train is False\n"
             "for make, package in ((lambda: BACH(roots['pmcoa']), 'datasets'), "
             "(lambda: PCAM(roots['pmcoa']), 'datasets'), "
             "(lambda: NckCrc(roots['pmcoa']), 'datasets'), "
             "(lambda: SICAP(roots['pmcoa']), 'pandas'), "
             "(lambda: BIOSCANInsectDataset('x.h5'), 'h5py')):\n"
             "    try:\n"
             "        make()\n"
             "        raise AssertionError('no ImportError')\n"
             "    except ImportError as err:\n"
             "        assert repr(package) in str(err) or package in str(err), err\n"
             "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('pandas', 'datasets', 'h5py'))\n"
             "assert not leaked, leaked\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0].replace(
        '"mmlearn_tpu", "projects")', '"mmlearn_tpu", "projects", "pandas", "datasets", "h5py")')
    assert '"h5py")' in blocked
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_registered_operators_import_without_jax():
    """The kernels' registered operators (what a serving artifact's program
    calls), with JAX and the JAX package blocked."""
    names = ("import torch\n"
             "from mmlearn_tpu_torch.ops import registered\n"
             "assert set(registered.OPERATORS) == {'fused_mha', 'layernorm', 'add_layernorm', "
             "'flash_qkv', 'int8_qmm'}\n"
             "assert all(hasattr(torch.ops.mmlearn, n) for n in registered.OPERATORS)\n"
             "print('ok')\n")
    blocked = _IMPORT_ALL.split("import mmlearn_tpu_torch\n")[0]
    proc = _run([sys.executable, "-c", blocked + names], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
