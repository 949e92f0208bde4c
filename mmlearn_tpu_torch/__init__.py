"""mmlearn-tpu on PyTorch and CUDA (NVIDIA Hopper).

The port of :mod:`mmlearn_tpu` to PyTorch. It mirrors that package module
for module, so each counterpart sits at the same path; the JAX package stays
the reference every module here is tested against. It imports ``torch`` and
never ``jax`` or ``flax``.

Every Pallas kernel on a ported path is a kernel written by hand for Hopper
(``sm_90a``) here: CUDA C++ under ``csrc/``, built by :mod:`._build` at first
use. Beside each kernel sits its plain PyTorch version, which a
wrapper takes only for a tensor that lies on the CPU.

Ported so far: the embedding-serving path (encoders, artifact export, the
embedding index and the HTTP server), the flagship contrastive training
step (loss, AdamW with its schedule, a minimal trainer), the I-JEPA step,
the ``MMLEARN_QUANT`` int8 modes and the long-sequence attention path (the
towers at 448 px), with the kernels they run; the trainer, evaluation, the
ViT options and large presets, and the data layer with its readers and
formats (TFRecord, streams, materialized shards, the process loader, the
built-in readers and the native JPEG fastloader, host C++ in ``csrc/``); the
encoders and weight I/O (the BERT towers, HF/timm converters, factories and
exporters, LoRA, the Lightning importer) and the BIOSCAN-CLIP project; the
auxiliary tasks (I-JEPA on a contrastive task's shared tower), the config
layer (``conf/``) and the experiment CLI (``cli/``, ``mmlearn_torch_run``)
with the multi-task and I-JEPA project configs; parallelism over
``torch.distributed`` (``parallel/``: the ``data``, ``fsdp``, ``seq`` and
``model`` mesh axes, FSDP2 and the column and row splits of tensor
parallelism) with ring attention (``ops/ring_attention.py``).
"""

__version__ = "0.1.0"
