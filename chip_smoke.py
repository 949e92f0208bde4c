"""Drive the PyTorch port's serving, training, evaluation, data, BIOSCAN-CLIP, multi-task, parallel and med_benchmarking paths once on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the hand-written kernels from the sources in the checkout, one
   ``nvcc`` a source, all at once: K1 forward and backward
   (``mmlearn_tpu_torch/csrc/fused_attention.cu``) and their head-grouped
   variant K1f-p/K1b-p (``csrc/fused_attention_packed.cu``), K2f and K2b,
   the LayerNorm forward and backward (``csrc/layernorm_fwd.cu``,
   ``csrc/layernorm_bwd.cu``), K5, the quantizing int8
   product (``csrc/int8_matmul.cu``), and K3 (``csrc/flash_attention.cu``;
   K3 and K5 on the wgmma, TMA and mbarrier helpers of
   ``csrc/hopper_tiles.cuh``), CUDA C++ for sm_90a, into ``build/kernels/``;
2. hold each kernel against its plain PyTorch version on the card, with
   the tolerance printed on each line: at batch 8 over every case (masks,
   head dims, f32 and bf16; K1 also at the lengths where its code branches,
   up to ``supports_fused``'s N = 768 at D = 64 and 512 at D = 32, its
   output and gradients also as a whole, ||got - want|| / ||want||; K2b's
   dgamma / dbeta also bit for bit on two runs of one input; K2f on each
   route of its plan (C 384 to 1408, 136, 300, 8192, f32, rows not 16-byte
   aligned), its residual ``r`` bit for bit; K5 at
   ragged M, N and K, forward and dgrad through ``switchback_matmul``,
   with its shape routing, on both of its paths (TMA and byte loads), with
   a bias), and at batch 256 in bf16 at the paths' shapes (K5 at all 16
   projection shapes), so at the grids the training step launches; then
   time the kernel, its
   plain version and, where one PyTorch call computes the same function,
   that call, at batch 256, beside the kernel's bound (the bytes it must
   move over 3.35 TB/s or its operations over the dense peak of its type,
   whichever is larger; K2 in device time alone, its launches queued
   behind a sleep of the card, with L2 flushed before each where the
   operands fit in it, beside the host's time a call); K5 beside a bf16
   ``F.linear`` and ``torch._int_mm``
   on operands quantized beforehand, printed as context (no one PyTorch call
   computes K5's function);
3. build the full-width flagship (CLIP ViT-B/16 + text tower, random
   weights from a fixed seed, bf16 compute), check that one tower forward
   launches K1 ``depth`` times and K2 ``2 * depth`` times, and time
   ``encode`` at batch 256;
4. the serving path, with every launch count set to 0 first: write an rgb
   and a text artifact with ``save_encoder``, embed 8,192 synthetic images
   into ``.npz`` shards plus a manifest through the port's
   ``EmbeddingExport``, start two ``serve()`` servers on
   127.0.0.1 (image->image and text->image search over the same index), and
   send ``/healthz``, ``/embed`` and ``/search`` to each; then check the
   results: finite, unit-norm embeddings; every queried indexed image found
   at rank 1 with score ~1; served embeddings agree with the port's
   plain-version forward (the same artifact on the CPU);
5. the training path: one step of the flagship contrastive task at batch 8
   with the kernels on the card against the same weights and batch through
   the plain versions on the CPU (loss and every gradient tensor); then,
   with every launch count set to 0, ``Trainer.fit`` on the synthetic batch
   at batch 256: 3 warm-up steps, 3 timed windows of 10 steps and one more
   step; check the launches per step (per block: K1 forward once and each
   of K1 backward's two kernels once, K2 forward and backward twice), a
   finite, nonzero gradient for every parameter, and a last loss below the
   first;
6. the I-JEPA path (``flagship.ijepa_training_task``: ViT-B/16 student, EMA
   teacher, the default predictor of 12 heads of dim 32): the host time of
   one batch of masks; one step at batch 8 on the card against the CPU
   (loss, every gradient, the teacher after one ``post_update``); then
   ``Trainer.fit`` at batch 256 twice, with every launch count set to 0
   before each: with the default dispatch (K1) and with
   ``MMLEARN_FUSED_ATTN_PACKED=1`` (K1f-p/K1b-p), each 3 warm-up steps and 3
   timed windows of 5; check the launches per step exactly, every student
   and predictor gradient finite and nonzero, the teacher moved and finite,
   the loss finite, and both runs' first losses alike;
7. the flagship step under ``MMLEARN_QUANT``: one step at batch 8 on the
   card against the CPU for each of ``int8_sb``, ``int8_fwd`` and ``int8``;
   then, with every count set to 0, ``Trainer.fit`` at batch 256 under
   ``int8_sb`` (3 warm-up steps, 3 timed windows of 10, one more step):
   launches a step checked exactly (K5 twice a projection: forward and
   dgrad), every gradient of the first step finite and nonzero (where a
   kernel that cuts the autograd graph shows), every gradient of the last
   step finite (the fit on one synthetic batch may have collapsed to chance
   by then, and the int8 dgrad rounds its deepest gradients to exactly
   zero: their names are printed), the loss falling and its first value
   within 2% of the bf16 run's from the same weights; then ``encode`` of
   images at batch 256 under ``int8_sb`` (K5 once a projection);
8. the long-sequence path: the flagship towers with the image tower at 448
   px (785 tokens, its position table interpolated from the 224-px one), whose
   attention takes the flash kernel K3: with every count set to 0, image
   ``encode`` at batch 256 (exact launches: K3f 12, K2f 24, K1 0; the
   embeddings against the plain versions on the CPU) and images/s; then one
   training step at batch 8 on the card against the CPU, and
   ``Trainer.fit`` at batch 64 (3 warm-up steps, 3 timed windows of 5, one
   more step) with exact launches a step (K3f and both K3b kernels 12 each
   on the image tower, K1 only on the text tower), every gradient finite
   and nonzero, the loss falling, pairs/s, ms a step and peak memory;
9. the trainer path (``Trainer.fit`` with what a pretraining job uses): the
   flagship on distinct synthetic micro-batches of 128 pairs (8 a pass,
   drawn from the epoch and the index), two a global batch of 256
   (``accumulate_grad_batches=2``), clipping by norm, a validation of 2
   batches and a ``ModelCheckpoint`` (monitoring ``validation/loss``) every
   6 micro-steps, the LR monitor, the timer, a JSONL logger and
   ``log_mfu``. Run A, 12 micro-steps with every count set to 0 first:
   launches exactly the flagship's a micro-step plus the validation
   forwards, every gradient of the first micro-step finite and nonzero, 6
   optimizer steps, 6 ``post_update`` calls (0-5) and 6 schedule steps,
   checkpoints at 6 and 12 complete, finite validation losses, the JSONL
   lines. Run A again, bit-equal to A (records and weights); run B, a fresh
   task resumed from A's step-6 checkpoint, bit-equal to A's micro-steps
   6-11 and weights; run C, stopped by SIGTERM after micro-step 4 with its
   end checkpoint, then resumed to 12, bit-equal to A. The trainer at k=2
   on micro-batches of 8 for 2 optimizer steps (SGD at rate 1: AdamW's
   first updates are about a sign an element, which bf16's rounding turns
   either way where a gradient is near zero, and the warmup's rates move a
   LayerNorm gain by a few f32 ulps) on the card against the CPU: losses
   within ``ACCUM_LOSS_RTOL``, each applied (accumulated, clipped) gradient and
   each weight's update at cosine ``MIN_GRAD_COSINE`` (key biases without
   their key part: a zero gradient in exact arithmetic), and the FLOP
   counter's count of a micro-step equal on both (the kernels reporting on
   the card, the plain versions counted on the CPU). Prints ms a
   micro-step, pairs/s a global
   batch, checkpoint bytes, save (sync and async) and restore seconds, the
   counted FLOPs, TFLOP/s and MFU, and phase 5's pairs/s again;
10. the input-fed path: the flagship trained on host batches of
    ``Uint8Pairs`` (uint8 NHWC images at 224 px, class by class correlated
    with token patterns; 16 distinct batches a pass) through
    ``RandomSampler``, ``DefaultDataCollator`` and the port's ``DataLoader``
    (8 fetch threads), then the trainer's ``DeviceFeeder`` (pinned staging,
    a side stream) with the uint8 pixels normalized on the card by
    ``device_normalize`` (CLIP's statistics). The MB/s of pinned and of
    pageable copies of one batch; then, with every count set to 0,
    ``Trainer.fit`` at batch 256 (3 warm-up steps, 3 timed windows of 10,
    one more step): the launches a step exactly the flagship's, every
    gradient of the first step finite and nonzero, the loss finite and
    falling, and the images of 3 batches, copied on the compute stream as
    the step read them, equal to the host's f32 normalization cast to bf16
    bit for bit, their example indices the sampler's (and every batch's, on
    the host side); pairs/s, its ratio to phase 5's, ms a step, the step's
    wait on the feeder and peak memory. Run U (12 steps, a checkpoint at
    6) and run R (a fresh task resumed from it): R's records, example
    indices and weights equal U's bit for bit, and R fetches no example of
    the 6 skipped batches. Last, for context, 10 steps on the port's
    ``SyntheticImageText`` (f32 host images, 154 MB a batch): pairs/s and
    the wait. The main fit's state is saved at its end for phase 11;
11. the eval path: the flagship's eval-only job at b256 over held-out
    pairs of phase 10's classes (``EvalPairs``: 2,048 of all 64 classes with
    two prompt templates, 200 of a 2-class subset, the binary path; the
    last batch padded), uint8 images normalized on the card. Check 1, with
    every count set to 0: one eval batch's image tower launches K1f
    ``depth`` times unmasked, its text tower ``depth`` times causal, a
    chunk of the ragged class prompts ``depth`` times masked and causal;
    K2f ``2 * depth`` a tower; nothing else. Then ``Trainer.validate`` of
    the weights phase 10's fit left, with zero-shot retrieval (rgb->text at
    1, 5, 10; text->rgb at 5), zero-shot classification (top-1, top-5) and
    two exports (normalized and raw): launches exactly ``depth`` K1f and
    ``2 * depth`` K2f a tower forward, K1f's cases counted; eval pairs/s,
    export MB/s and peak memory. Check 2: each recall and accuracy equal to
    its f64 recomputation from the raw export, ties to the lower row. Check
    5: ``EmbeddingIndex`` over the normalized export serves each row as its
    own rank-1 neighbour (or an earlier row of the same bits). The fresh
    weights' accuracy beside the trained and chance; then the eval-only
    route: ``prepare_eval_state`` from phase 10's checkpoint and
    ``Trainer.test``, its metrics equal validate's bit for bit. Check 3: the
    same hooks over 64 pairs (two batches of 32) on the card and on an f32
    CPU copy with the plain versions, for the fresh flagship (its rows
    distinct) and phase 10's weights: per-row cosines of the exported and
    the class embeddings >= ``MIN_COSINE``; on the fresh flagship also the
    rows less the CPU rows' mean (``EVAL_CENTERED_COS``, each row nearest
    its own), the loss within ``EVAL_LOSS_RTOL``, each recall and accuracy
    within ``EVAL_ROWS`` rows, the other metrics within
    ``EVAL_OTHER_ATOL`` (phase 10's, a nearly collapsed model whose scores
    rounding orders, printed). Check 4: the blockwise top-k at 8,192 x
    262,144 (integer-valued f32, so every product is exact) equal to the
    full-axis top-k in query chunks and, on 256 queries, to a stable
    descending sort (the lower row first among equal scores); the recall
    pass's times at 2,048^2 and 8,192 x 262,144;
12. the large presets' path: OpenCLIP ViT-H/14 (``vit_huge`` at 14-px
    patches: 32 blocks of 16 heads of dim 80, 257 tokens on K1; a 24-block
    text tower of width 1024) and ViT-g/14 (``vit_giant``: 40 blocks of 16
    heads of dim 88, 257 tokens, past K1's limit at D=88, on K3), random
    weights from the seed, bf16. (a) One ViT-H/14 tower forward each,
    counted exactly: K1f 32 at D=80 and K2f 64 (image), K1f 24 at D=64 and
    K2f 48 (text). (b) One step of the pair at batch 8, both towers cut to
    4 blocks at full width, under activation checkpointing (``remat``,
    ``dots_no_batch``) and drop-path 0.1 with the same masks, on the card
    against the plain versions on the CPU: the loss and every gradient at
    phase 5's limits. (c) The full pair at batch 8 with remat and without,
    on the card: losses and every gradient equal bit for bit. (d)
    ``Trainer.fit`` of the pair at batch 128 under remat on ``Uint8Pairs``
    through the ``DataLoader`` (3 warm-up steps, 3 timed windows of 5, one
    more step): launches a step exactly (per block K1f twice, its forward
    and its recompute; K1b's two kernels once; K2f four times; K2b twice),
    by head dim too; every gradient of the first step finite and nonzero;
    the loss finite; pairs/s, ms a step, peak memory, the counted FLOPs
    (the recompute included), TFLOP/s and MFU. (e) The same fit at batch
    64 with remat off, then on: the same checks and figures. (f) ViT-g/14 image ``encode``
    at batch 64: exact launches (K3f 40 at D=88, K2f 80, K1 0), finite
    embeddings, images/s; then ViT-g/16 (197 tokens: K1 at D=88), ViT-g/14
    (K3 at D=88) and ViT-H/14 at 448 px (1,025 tokens: K3 at D=80) image
    towers, cut to 2 blocks at full width, one forward and backward at
    batch 4 on the card against the CPU (pooled output, loss, every
    gradient), their launches counted exactly;
13. the record-fed path: 4,096 TFRecords in 8 shards written by the port's
    writer, each the bytes of a committed JPEG fixture
    (``tests/fixtures/jpeg/``), the token pattern of its class
    (``Uint8Pairs``' 64), its label and index: each read back through
    ``TFRecordDataset(verify_crc=True)`` equal to what was written, the
    native CRC-32C of each equal to the Python table's (a process a
    shard), ``StreamingDataset`` for ranks 0-3 of world 4 disjoint and
    covering every record once in each of 2 epochs, in different orders.
    Where the host has libjpeg: 256 records decoded at 224 px on the eval
    and the train path under per-record seeds (the batch decode equal to
    the per-image decode, the train decode repeated, no failure) and the
    train path's images/s on 1, 4 and every core; then, with every count
    set to 0 before each, ``Trainer.fit`` at b256 (phase 10's protocol and
    checks, its 3 batches held to the host's own decode of the same
    records) on ``TFRecordDataset`` + ``ImageTransform(train=True,
    device_normalize=True)`` through (a) the thread ``DataLoader`` (8
    threads) and (b) the process loader (6 spawned workers), and on
    ``MaterializedDataset`` shards of the same images decoded once by
    ``materialize``, through both. Where it has none (a line says so):
    the port's decoders raise naming libjpeg, and the fits run on
    materialized uint8 records of ``Uint8Pairs`` through (a) and (b).
    Prints pairs/s, its ratio to phase 5's, ms a step, the step's wait on
    the feeder, and the host's core count; removes what it wrote;
14. the BIOSCAN-CLIP path (``bioscan_path``): the trimodal recipe of
    ``bioscan_1m.yaml`` at its widths (``projects.bioscan_clip.recipe``:
    ViT-B/16 of timm ``vit_base_patch16_224``'s geometry, the post-LN BERT
    text tower of ``prajjwal1/bert-small``'s, BarcodeBERT; LoRA r=4 on
    every tower's qkv, per-slice q/v on text and dna; three loss pairs,
    AdamW, the one-cycle schedule). First the kernels' new instances: K1 on
    the dna grid (N=133, H=12) unmasked and under a ragged key mask and on
    the text grid (N=20, H=8; the repo holds no BIOSCAN text length, so 20
    with 6-20 valid) under a ragged mask, and K2's add+LayerNorm at C=512
    and 768 at BERT's epsilon 1e-12, against their plain versions at batch
    8, then timed at b400 beside the plain version, SDPA or
    ``F.layer_norm`` and the bound. The task is built from seeded random
    state dicts under the public checkpoints' key names and shapes (timm
    ViT-B/16, ``BertModel`` with vocabulary 30,522 and 512 positions,
    ``BertForMaskedLM`` with 1,027 and 256) through the port's converters.
    One b8 step on the card against an f32 CPU copy (loss, every trainable
    gradient), both with the LoRA ``b`` factors drawn from a seed, so that
    the delta is live. ``Trainer.fit`` at b400 in bf16 under remat for 32 steps,
    two passes of 16 distinct batches of ``BioscanTriples`` (uint8 images
    through the feeder, normalized on the card; 133-token barcodes from the
    port's ``DNAProcessor``; texts with masks and token types), every count
    set to 0 first: launches a step exactly; the trainable set the JAX
    mask's by name; at step 1 every LoRA ``b`` gradient nonzero and every
    ``a`` gradient exactly 0; every frozen weight bit-equal to its start at
    the end; the loss finite and lower over the second pass than the first;
    triples/s (3 windows of 6 steps, each inside one pass), ms a step, MFU from the FLOP counter (the LoRA merges'
    products counted) and peak memory. ``TaxonomicClassification`` on the
    card over synthetic keys and queries: every accuracy equal to its f64
    evaluation on the CPU. The trained ViT-B/16 and text towers exported
    (``hf_export.export_task``, LoRA merged) to timm and HF BERT keys and
    imported again: their outputs on the card equal bit for bit.
15. the multi-task experiment through the port's CLI
    (``mmlearn_tpu_torch.cli.run.main``, the console script's function):
    1,024 NYUv2-layout pairs of smooth seeded patterns at 320x240 (PNG,
    depth in 16 bits) written by 8 spawned processes;
    ``+experiment=contrastive_ijepa`` from the searchpath
    ``pkg://mmlearn_tpu_torch.projects.multi_task.configs`` at the YAML's
    widths, batch 128, remat and bf16 (rgb ViT-B/16 and depth ViT-S/16, the
    I-JEPA auxiliary task on the shared rgb tower with its default
    predictor of 12 heads of 32), the overrides the data root, the steps,
    the checkpoint directory and cadence, ``trainer.log_mfu`` and a probe
    callback. One b8 step of the task as the CLI builds it on the card
    against the CPU (loss, every trained gradient). Run A: 24 steps, every
    count set to 0 first: launches a step exactly (K1f 90, K1b 84, K2f 180,
    K2b 84: both towers, the student on the context tokens and the remat
    recomputes, the teacher, the predictor); every trained gradient finite
    and nonzero at step 1, the predictor's among them; the teacher apart
    from the student after step 1 and equal to ``d * teacher_0 + (1 - d) *
    student_1`` computed on the CPU from the saved weights;
    ``aux_ijepa_rgb_loss`` finite at every step; pairs/s (3 windows of 6
    steps), ms a step, FLOPs, MFU, peak memory, the feeder's wait. Run B,
    resumed from run A's step-12 checkpoint: every record and weight
    bit-equal to run A's.
16. the parallel path (``parallel_phase``), on the one card: K3's ring
    instances (K3f with its f32 output at the hop grids B=1, n=4,096, H=16
    D=64 and H=8 D=128; K3f and K3b at D=128 on B=1, N=16,384, H=8, K3b's
    bits run twice) against their plain versions at K3's limits, timed
    beside SDPA and the bound; ring attention at B=1, N=16,384 through the
    list exchange (P ranks' hops on this card) at P=4 and 8, H=16 D=64 and
    H=8 D=128, causal and not, forward and backward: launches exactly P^2
    a pass (P (P + 1) / 2 causal) of K3f's f32 instance and of K3b's two
    kernels, the output and gradients against unsharded K3 and against the
    plain ring at ``RING_REL_TOL``, the ring's ms beside K3's; then the
    flagship's towers through ``cli.run`` (``build_experiment`` and
    ``run_experiment``) at world 1 over NCCL: one process started by
    ``mp_launch.run_workers`` under ``MMLEARN_MULTIHOST=1``, FSDP2 over a
    1x1 mesh, b128, 12 steps and a validation with zero-shot retrieval,
    against the same job on the undistributed trainer in this process: the
    loss of every step and every weight bit-equal (or within 1e-6 relative,
    the operation named), K1's and K2's launches phase 9's a step, the
    recall equal; for both runs each of steps 2-7 on the host clock (their
    median beside phase 9's ms), the feeder's wait and the garbage
    collector's time, and steps 8-12 under torch.profiler (the kernels'
    device time a step and the idle share). K3f's bf16-output instance at
    D=128 runs on no main path (the ring's hops write f32): its row reports
    0 launches, and its ring count is checked to be 0.
17. the tensor-parallel path (``tp_phase``), on the one card: the
    flagship's towers at full width (ViT-B/16 at 224 px, the 12-block
    causal text tower), b128, bf16, ``TP_STEPS`` steps of ``Trainer.fit``
    on ``mesh_shape`` ``data=1, fsdp=1, model=2``: two processes started by
    ``mp_launch.run_workers``, both on ``cuda:0`` over gloo (NCCL refuses
    two ranks of one communicator on one device), each running K1f/K1b on
    its 6 of the image tower's 12 heads and 4 of the text tower's 8, K2f/K2b
    on the whole rows; biases drawn from N(0, ``TP_BIAS_STD``) so that a
    bias added on both ranks shows; against the same steps of the
    undistributed trainer in this process: every step's loss and
    ``grad_norm`` (``TP_LOSS_REL``, ``TP_NORM_REL``) and every parameter
    after the steps (``TP_WEIGHT_REL``, each norm-relative); each rank's
    K1f, K1b, K2f and K2b launches equal to the undistributed run's, and no
    layer on the sharded plan's plain route; ms a step a rank (steps 2-4 on
    the host clock) against the undistributed step's, and the collectives'
    host time a step (steps 5-6 under torch.profiler). Then each rank
    splits ``TP_LAYOUTS``' attention layers, whose sharded plan says
    ``"xla"`` (the local heads of a ``model=4`` group, or a head count that
    2 does not divide): forward and backward in bf16 launch K3 on the
    rank's heads and take no plain route, within ``TP_LAYOUT_REL`` of the
    same layer unsplit.
18. the med_benchmarking experiments (``med_path``) through the port's CLI
    at the YAMLs' widths (CLIP ViT-B/16 at 224 px and the 12-block causal
    text tower at 77 tokens, bf16, remat): files written from ``SEED`` by 8
    spawned processes in the layouts of PMC-OA (jsonl, JPEG; 1,024 train
    and 640 valid pairs), ROCO (jsonl, JPEG), MIMIC-IV-CXR (jsonl with the
    report and 14 CheXpert labels, grayscale PNG) and Quilt-1M (CSV with
    ``subset``, JPEG), 1,024 pairs each at six sizes around 224, HAM10000
    (CSV, ``.jpg``), PAD-UFES-20 (CSV with empty cells, PNG) and MedMNIST+
    ``pathmnist``/``dermamnist`` (npz at 224), 256 images each; a
    CLIP-format vocabulary learned from the captions (``write_clip_vocab``:
    the byte alphabet, 600 merges, ``<|startoftext|>`` and
    ``<|endoftext|>`` the two highest ids), the readers' roots in their
    environment variables. 8 seeded rows of each reader equal to a plain
    PIL decode through the eval transform; one b8 step of
    ``baseline.yaml``'s task (two rows of each reader, MIMIC's
    ``rgb_target`` present on its rows only) on the card against the CPU
    at phase 5's limits, each row's EOS pooled where its attention mask
    ends. Run A: ``+experiment=baseline`` for one epoch (16 micro-batches of
    256, 4 optimizer steps of 4), the overrides the tokenizer's path, the
    epochs, the checkpoint directory, ``trainer.log_mfu`` and a probe,
    every count set to 0 first: launches a micro-step exactly (phase 12's
    count under remat), every trained gradient finite and nonzero at the
    first optimizer step, the validation on PMC-OA valid (padded last
    batch) with its launches exact and each recall at 10, 50 and 200 equal
    to its f64 recomputation from the gathered embeddings; pairs/s (3
    windows of one optimizer step), ms a micro-step, FLOPs, MFU, peak
    memory, the feeder's wait and the host seconds from ``main`` to the
    first step. Run B: ``+experiment=zeroshot_classification_eval`` as the
    eval job from run A's checkpoint, the six test sets whose readers need
    ``datasets`` or pandas deleted (printed with why): the weights run A's
    bit for bit, K1f's launches exact (the image tower a batch, the text
    tower a set's prompts), each top-1 accuracy equal to its f64
    recomputation, and 64 images of each set on the card against an f32 CPU
    copy (cosines >= ``MIN_COSINE``). Then ``bioscan_1m.yaml`` composed and
    its task instantiated on the card: parameter names, shapes, LoRA sites
    and trainable set equal to ``recipe.bioscan_task()``'s.

19. the artifact path (``artifact_path``): a K2f call's host time, direct
    and through its registered operator; then serving artifacts
    (``save_encoder``: a ``torch.export`` program for the card and one for
    the CPU, batch-polymorphic) of eight towers at full width, random
    weights from the seed: the flagship's image tower (224 px) and text
    tower (ragged, masked), the 448-px image tower (K3f at N=785), the
    I-JEPA ViT-B/16 encoder exported under ``MMLEARN_FUSED_ATTN_PACKED=1``
    (K1f-p at N=196), BIOSCAN-CLIP's three towers (the image tower with a
    live LoRA delta merged, bert-small with its 512->768 MLP head and key
    mask, BarcodeBERT at N=133) and the flagship image tower exported under
    ``MMLEARN_QUANT=int8_sb`` (K5). Each: the eager ``encode`` at b 1, 7
    and 256 and its b256 time against the artifact's; ``/embed`` and
    ``/search`` served from it over HTTP and in process against an index of
    its own b256 rows (each query its own rank-1, p50). Then one fresh
    process, with the port's ``modules``, ``tasks``, ``bridge`` and
    ``peft`` blocked (and JAX), loads every artifact without the model
    code and runs it at b 1, 7 and 256 from one program: each output equal
    to the eager one bit for bit, one b=7 forward's launches exact (K1f,
    K1f-p or K3f ``depth``, K2f ``2 * depth``, K5 ``4 * depth`` under
    ``int8_sb``, every other kernel 0), the graph's call targets the
    registered operators and none of the plain versions' attention or
    LayerNorm operations, its CPU program against its card program on two
    rows (cosine >= ``MIN_COSINE``).

Every main path before the seventh runs with ``MMLEARN_QUANT`` unset and
checks that K5 never launched there; so do the eighth to the eighteenth.

The packed kernels are held to their plain versions (K1's) at K1's limits,
element-wise and as a whole, at batch 8 over every case and at the lengths
where their code branches (``PACKED_LENGTHS``), and at the I-JEPA step's
grids (teacher and student at batch 256, the predictor at 1,024 rows); in
bf16 their output and dqkv also equal K1's on the same input bit for bit.
They are timed at those grids beside K1, the plain version, SDPA and their
bound; K2 is held at the predictor's width 384 too. K1 and K3 at the large
presets' head dims 80 and 88 (``HEAD_DIM_K1_CASES``: where K1's code
branches there and ``supports_fused``'s limits, N = 336 at D=80 and 208 at
D=88, held to the JAX rule; K3 at N 257 and 1,000 over its four masks;
causal or not; f32 and bf16) are held to their plain versions at batch 8,
then in bf16 at phase 12's grids (K1 at ViT-H/14's b128 and ViT-g/16's b64,
K3 on the packed projection at ViT-g/14's b64 at D=88 and 80; K2f and K2b
at the presets' widths 1280, 1024 and 1408 on those rows, K2b's sums held
to f64 and run twice for equal bits), at each kernel's limits, and timed
there beside the plain version, the library call and the bound. K3
(``mmlearn_tpu_torch/csrc/flash_attention.cu``) is held to its plain
versions at batch 8 over every case (N 785, 1,000 and 2,049; no mask,
right and left padding, a wholly masked sample; causal or not; D 32 and 64;
f32 and bf16: output, log-sum-exp, dQ, dK, dV) and, in bf16, at the 448
path's grid (B=64, H=12, N=785) and at B=1, N=16,385 (ViT-B/16 at 2,048 px,
its plain version head by head), and timed there beside its plain version,
SDPA, its bound and, at 16,385, both peak memories; and at the 448 training
grid in the step's own layout (q, k, v read as views of the packed
projection, the gradient of the projection written in place by K3b),
checked, run twice on the same input for equal bits, and timed.

The lines before the last give the card's name and power limit (from
``nvidia-smi``), the kernels' errors, times and bounds, ``encode``
throughput, ``/search`` latency, training pairs/s, eval pairs/s, and one
JSON line of per-kernel results. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")
SEED = 0
BATCH = 256  # encode / kernel-timing / training batch
N_IMAGES = 8192  # indexed corpus
SHARD_ROWS = 2048
SEARCH_K = 5
LATENCY_QUERIES = 24
PARITY_BATCH = 8  # training step held against the CPU
WARMUP_STEPS, WINDOWS, WINDOW_STEPS = 3, 3, 10
IJEPA_WINDOW_STEPS = 5  # I-JEPA: 3 warm-up steps, then WINDOWS windows of 5
HIGHRES_BATCH = 64  # the 448-px training step: 50,240 image tokens, as b256 at 224 px
PACKED_ENV = "MMLEARN_FUSED_ATTN_PACKED"
QUANT_ENV = "MMLEARN_QUANT"
# the I-JEPA step's attention: (label, batch, tokens, heads, head dim)
IJEPA_ATTENTION = (
    ("teacher N=196 H=12 D=64", 256, 196, 12, 64),
    ("student N=84 H=12 D=64", 256, 84, 12, 64),
    ("predictor N=118 H=12 D=32", 1024, 118, 12, 32),
)
# K1f-p/K1b-p at batch 8, (N, D): the I-JEPA lengths; where K1's routines
# branch (whole rows of up to 128 and 224 keys, two sweeps past 224; the
# backward's first kernel holds 96, 128 or 224 keys in f32 with the next head
# prefetched, 768 in bf16 without); both sides of every length where K1f-p's
# plan (ops.fused_attention.packed_fwd_plan: warps a block and ring buffers)
# changes; the longest that use_packed admits (768 at D=64, 512 at D=32)
PACKED_LENGTHS = (
    (118, 32), (196, 64), (84, 64),
    (64, 64), (65, 64), (96, 64), (97, 64), (128, 64), (129, 64), (160, 64), (161, 64),
    (224, 64), (225, 64), (256, 64), (257, 64), (384, 64), (385, 64), (768, 64),
    (128, 32), (129, 32), (160, 32), (161, 32), (192, 32), (193, 32), (224, 32), (225, 32),
    (288, 32), (289, 32), (352, 32), (353, 32), (480, 32), (481, 32), (512, 32),
)
# the f32 route (scalar, PR 3's) at the I-JEPA lengths and the longest
PACKED_F32_LENGTHS = ((118, 32), (196, 64), (512, 32), (768, 64))

# the flagship's block projections at batch 256: (label, rows, in, out); the
# dgrad of each is the same product with in and out swapped
INT8_SHAPES = tuple(
    (f"{tower} {name}", BATCH * tokens, c_in, c_out)
    for tower, tokens, c in (("image", 197, 768), ("text", 77, 512))
    for name, c_in, c_out in (("qkv", c, 3 * c), ("proj", c, c), ("fc1", c, 4 * c),
                              ("fc2", 4 * c, c))
)

# the H100 SXM data sheet at 700 W: memory rate, dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# its L2: a K2 grid whose operands fit is timed with L2 flushed (device_ms)
L2_BYTES = 50e6

# kernel-versus-plain tolerances, |kernel - plain| <= atol + rtol * |plain|,
# each set about 2x above the least atol a sound run reads (printed on every
# check; the readings and those of faulty copies are in PERF.md). bf16: rtol
# 2^-7 is one rounding of the output (an ulp); atol covers what a kernel
# rounds elsewhere than its plain version -- K1f rounds p / l as the plain
# version does from f32 scores that the tensor cores sum in another order,
# so a p that rounds the other way moves a row of the output by an ulp of p
# times v (reads up to 6.6e-3 over the text grid's draws; 7.4e-3 before, when
# it rounded unnormalised p); K1b takes p and ds bit for bit as the plain
# version (reads 1.8e-7: only the output's rounding of f32 sums in another
# order, near zero); the head-grouped K1f-p/K1b-p compute K1's bits (and are
# held to equal K1 exactly besides), so they take K1's limits but K1b-p's,
# which also covers longer rows under a ragged key mask than K1's checks
# hold (at N=768 K1b and K1b-p read up to 8.7e-7 over 8 draws, bit for bit
# alike: tools/k1_masked_readings.py); K2 only its output (2e-7). f32:
# summation order (reads 1.4e-6). K5 is held exact (K5_TOL): it and its
# plain version round x / sx to the same ints, sum them exactly and
# dequantize (and add the bias) in the same order.
# K3 rounds where K1f does (unnormalised p in the forward, reads 6.0e-3; p
# and ds in the backward, 2.0e-3).
BF16_ATOL = {"fused_mha_fwd": 1.3e-2, "fused_mha_bwd": 4e-7, "layernorm_fwd": 1e-4,
             "layernorm_bwd": 1e-4, "fused_mha_packed_fwd": 1.3e-2,
             "fused_mha_packed_bwd": 2e-6,
             "flash_attention_fwd": 1.2e-2, "flash_attention_bwd": 4e-3}
F32_TOL = (5e-6, 0.0)
K5_TOL = (0.0, 0.0)
# K2f's residual r = x + branch: one rounding of the f32 sum, as PyTorch's add
R_TOL = (0.0, 0.0)
# K3's f32 log-sum-exp, values up to ~15: the scores summed in another order
# (reads 3.8e-6)
LSE_TOL = (1e-5, 0.0)
# a row that sees no key is the mean of V over the N_k keys: against the f32
# mean, one rounding of the output (<= 2^-9 relative in bf16). A kernel that
# also averaged padded keys (as the TPU kernel does) is off by (N_k - padded)
# / padded, 2-6% at these lengths, which the output limit above lets through
MASKED_ROW_TOL = (1e-6, 2 ** -7)
# K3's outputs and gradients also as a whole: ||got - want|| / ||want||. The
# element limits above are 20-33% of a typical |out| (std ~0.06 at N=785), so
# an error of a few percent on many elements passes them. Reads: bf16 out
# 3.1e-3 (the output's rounding, 2^-9 at most, and p's), gradients 3.6e-4
# (rounded once from f32 sums); f32 1.3e-6 and 2.7e-7
FLASH_REL_TOL = {"flash_attention_fwd": {"bfloat16": 7e-3, "float32": 3e-6},
                 "flash_attention_bwd": {"bfloat16": 8e-4, "float32": 6e-7}}
# K1's outputs and gradients as a whole, for the same reason. Reads: bf16 out
# 1.1e-4 (p / l rounded from tensor-core sums), dqkv 9.1e-5 (the output's
# rounding of tensor-core sums); f32 3.6e-7 and 1.3e-7
K1_REL_TOL = {"fused_mha_fwd": {"bfloat16": 2.5e-4, "float32": 8e-7},
              "fused_mha_bwd": {"bfloat16": 2e-4, "float32": 3e-7}}
# K1-p's as a whole: in bf16 K1's (the same bits; reads 1.3e-4 and 8.7e-5);
# in f32 its own, as its f32 route is PR 3's scalar kernels, which sum in
# another order than K1's (reads 7.2e-7 and 2.0e-7)
K1P_REL_TOL = {"fused_mha_packed_fwd": {**K1_REL_TOL["fused_mha_fwd"], "float32": 1.5e-6},
               "fused_mha_packed_bwd": {**K1_REL_TOL["fused_mha_bwd"], "float32": 4e-7}}
# the generator of norm_batch_inputs
NORMS_SEED = SEED + 12
# draws of K1 at the text grid (k1_draws)
K1_DRAWS = 12
# K2 backward's dgamma / dbeta against the plain version at batch 8: f32
# sums over every row (1,576 here) in another order
SUM_TOL = (1e-4, 1e-4)
# and against the same sums evaluated in f64 (ln_sums_f64) and rounded once to
# f32, at every grid: one rounding of each side is up to 2^-24 of the sum, so
# the rtol is 2^-23, and the atol holds what else a sound sum may add. At batch
# 256 (tools/layernorm_sum_accuracy.py, on norm_batch_inputs) K2b reads a
# least atol up to 4.85e-5 at this rtol (dgamma at 120,832 rows: its f32 xhat),
# and a plain f32 column sum of the same products 9.2e-5, 1.48e-4 and 2.93e-4
# at the three widths (the plain version's own sums, further off there than
# SUM_TOL): this limit refuses such a sum
SUM_F64_TOL = (1e-4, 2 ** -23)
# served embeddings (bf16 kernels on the card) against the plain-version
# forward of the same artifact on the CPU: cosine of each pair
MIN_COSINE = 0.99
# self-retrieval: a bf16 embedding against its own f32 copy in the index
SELF_SCORE_ATOL = 2e-2
# the training step at batch 8, kernels on the card against plain versions
# on the CPU, both computing in bf16: the towers' activations differ by bf16
# rounding in other places and sums in other orders, so the loss agrees to
# 2e-3 relative (reads 4.5e-4) and each gradient tensor in direction
# (cosine; reads 0.9954 at the worst bias)
LOSS_RTOL = 2e-3
MIN_GRAD_COSINE = 0.99
# the same step under MMLEARN_QUANT: where the two sides' activations differ
# by a bf16 rounding, a row's int8 value can fall on the other side of a
# rounding edge, one quantization step in that element (reads 1.49e-3 on the
# loss and cosine 0.9874 at the text tower's last fc2 bias, in every mode)
QUANT_LOSS_RTOL = 3e-3
QUANT_MIN_GRAD_COSINE = 0.975
# the int8_sb step's first loss against the bf16 step's, same weights and
# batch: the quantization error of the forward alone
QUANT_FIRST_LOSS_RTOL = 2e-2


# the 224-px paths never reach the flash kernel (every N <= 197)
NO_FLASH = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
#: pairs/s of each ``fit_flagship`` run, by its label ("" for the bf16 step)
FIT_RATES: dict = {}

# the trainer path (phase 9): the flagship at micro-batches of 128 pairs,
# two a global batch of 256, 12 micro-steps, a checkpoint and a validation
# every 6; a SIGTERM at micro-step 4; accumulation held to the CPU at
# micro-batches of 8, the step parity's batch
TRAINER_MICRO_BATCH, TRAINER_ACCUMULATE, TRAINER_STEPS = 128, 2, 12
TRAINER_EVERY, TRAINER_STOP_AT, TRAINER_PASS, TRAINER_VAL_BATCHES = 6, 4, 8, 2
TRAINER_PARITY_MICRO = PARITY_BATCH
TRAINER_CLIP = 1.0
# the accumulation parity's loss, card against CPU: about 2x the largest of
# sound LayerNorms' readings on an NVIDIA H100 80GB HBM3 at 700 W, K2f
# 1.498e-03, K2f's plain version on the card 1.295e-03, F.layer_norm
# 2.471e-03 (tools/noise_limits.py), below a copy that leaves the second
# micro-batch's gradient out of the card's mean (4.526e-02)
ACCUM_LOSS_RTOL = 5e-3

# the input-fed path (phase 10): the flagship at b256 on uint8 host batches,
# 16 distinct batches a pass fetched by 8 threads; 3 batches held to the
# host's normalization; resume at 6 of 12 steps; 10 steps on f32 host data
INPUT_PASS, INPUT_WORKERS, INPUT_CLASSES, INTEGRITY_STEPS = 16, 8, 64, 3
INPUT_RESUME_STEPS, INPUT_CONTEXT_STEPS = 12, 10
INPUT_STEPS = WARMUP_STEPS + WINDOWS * WINDOW_STEPS + 1  # the main fit's

# the eval path (phase 11): 2,048 held-out pairs of phase 10's 64 classes
# and 200 of a 2-class subset (the binary path; the last batch padded),
# labels and rolls from EVAL_SEED; exports in shards of 1,024 rows; the card
# against an f32 CPU copy on 48 + 16 pairs in two batches of 32; the
# blockwise top-k at 8,192 x 262,144 (8 GiB of f32 similarities, past the
# 4 GiB budget)
EVAL_PAIRS, EVAL_BINARY_PAIRS, EVAL_BINARY_CLASSES = 2048, 200, (5, 40)
EVAL_SEED, EVAL_SHARD_ROWS, EVAL_RGB_KS = SEED + 41, 1024, [1, 5, 10]
EVAL_CPU_PAIRS, EVAL_CPU_BINARY, EVAL_CPU_BATCH = 64, 16, 32
BLOCKWISE_QUERIES, BLOCKWISE_TARGETS, TIE_RULE_QUERIES = 8192, 262144, 256
# the eval metrics of the fresh flagship (rows distinct), card (bf16,
# kernels) against the CPU copy (f32, plain versions) on those 64 pairs.
# Each recall and accuracy counts rows (64 for retrieval, 48 and 16 for the
# two sets), so it is held in rows decided the other way: sound LayerNorms
# read 0; the limit is 2. The loss and the other metrics (macro precision,
# recall, F1, AUROC) are held to about 2x the largest of sound LayerNorms'
# readings on an NVIDIA H100 80GB HBM3 at 700 W: K2f 1.301e-04 and 7.028e-03
# (AUROC over the 48), K2f's plain version on the card 1.007e-04 and
# 3.891e-03, F.layer_norm 5.258e-05 and 6.564e-03 (tools/noise_limits.py);
# K1f launched without its causal flag reads 5.467e-03, 3 rows and 0.1333
EVAL_ROWS, EVAL_OTHER_ATOL = 2, 1.4e-2
EVAL_LOSS_RTOL = 3e-4
# check 3 on the fresh flagship, the rows with the CPU rows' mean taken out:
# least cosine 0.998045 (rgb), 0.999851 (text) on one H100 at 700 W; K1f's
# image-side scale x 1.25 reads 0.968185, its output x 1.03 on half the
# batch 0.973257 (PERF.md section 6). 1 - cos at 2x the sound rgb reading.
EVAL_CENTERED_COS = 0.996


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``iters`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """The host's time a call of ``fn`` in µs: a host clock over ``iters``
    calls without a synchronise (what the launches cost the host, whatever
    the card does meanwhile)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_ms(fn, cold: bool, iters: int = 20) -> float:
    """The card's own time of ``fn`` in ms, without the host's: the calls
    are queued behind a ``torch.cuda._sleep`` that outlasts their enqueue
    (checked: the sleep is still running when the last call is queued,
    else the run is taken again behind a sleep four times as long), so
    that each starts as the last ends. Warm: events around the run of
    ``iters`` calls. ``cold``: L2 flushed (a write of twice its size)
    before each call, and events around each call alone, the mean of
    their times."""
    import torch

    flush = torch.empty(int(2 * L2_BYTES), dtype=torch.uint8, device="cuda") if cold else None
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters if cold else 2)]
    asleep = torch.cuda.Event()
    for event in (*events, asleep):  # each made, and each kernel loaded, before the run
        event.record()
    if cold:
        flush.zero_()
    sleep_us = 3 * (host_us(fn, iters=5) + (40.0 if cold else 0.0)) * iters + 1e3
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e3 * sleep_us))  # cycles at up to 2 GHz
        asleep.record()
        if cold:
            for i in range(iters):
                flush.zero_()
                events[2 * i].record()
                fn()
                events[2 * i + 1].record()
        else:
            events[0].record()
            for _ in range(iters):
                fn()
            events[1].record()
        covered = not asleep.query()
        torch.cuda.synchronize()
        if covered:
            break
        sleep_us *= 4
    check(covered, "device_ms: the enqueue outlasted every sleep")
    if cold:
        return sum(events[2 * i].elapsed_time(events[2 * i + 1]) for i in range(iters)) / iters
    return events[0].elapsed_time(events[1]) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """The least time in ms the card could take: bytes over the memory rate
    or operations over the dense peak of the inputs' type, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(b: int, n: int, mask, causal: bool) -> int:
    """(query, key) pairs the data needs: visible under the mask and the
    causal rule (a row whose every key is masked still averages all keys)."""
    import torch

    if mask is None:
        return b * (n * (n + 1) // 2 if causal else n * n)
    visible = mask.bool()[:, None, :].expand(b, n, n)
    if causal:
        visible = visible & torch.ones(n, n, dtype=torch.bool, device=mask.device).tril()
    rows = visible.sum(-1)
    return int(torch.where(rows > 0, rows, n).sum())


@contextlib.contextmanager
def environ(name: str, value: str):
    """The variable ``name`` set to ``value`` inside the block, as it was
    after: the port reads ``MMLEARN_FUSED_ATTN_PACKED`` and ``MMLEARN_QUANT``
    at every call."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def packed_attention(on: bool):
    """``MMLEARN_FUSED_ATTN_PACKED`` set to ``on`` inside the block."""
    return environ(PACKED_ENV, "1" if on else "0")


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.ops import int8_matmul as im

    for table in (fa.LAUNCHES, fn.LAUNCHES, im.LAUNCHES, fl.LAUNCHES, fl.F32_OUT_LAUNCHES):
        for key in table:
            table[key] = 0
    fa.HEAD_DIM_LAUNCHES.clear()
    fl.HEAD_DIM_LAUNCHES.clear()


def head_dim_counts() -> dict:
    """``{(kernel, head dim): launches}`` of K1 and K3 since the last
    :func:`reset_counts`."""
    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops import fused_attention as fa

    return {**fa.HEAD_DIM_LAUNCHES, **fl.HEAD_DIM_LAUNCHES}


def launch_counts() -> dict:
    """``{kernel: launches}`` since the last :func:`reset_counts`."""
    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.ops import int8_matmul as im

    return {**fa.LAUNCHES, **fn.LAUNCHES, **im.LAUNCHES, **fl.LAUNCHES}


# ----------------------------------------------------------------- kernels


def compare(name: str, got, want, tol: tuple[float, float], rel=None) -> float:
    """Check ``|got - want| <= atol + rtol |want|`` everywhere and, where
    ``rel`` is given, ``||got - want|| / ||want|| <= rel``; print the largest
    error, the least atol that this rtol would need and the relative error."""
    atol, rtol = tol
    got = got.detach()
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    max_err = float(err.max())
    least_atol = max(float((err - rtol * want.float().abs()).max()), 0.0)
    ok = bool((err <= lim).all()) and bool(got.isfinite().all())
    rel_text = ""
    if rel is not None:
        rel_err = float(err.norm() / want.float().norm())
        ok = ok and rel_err <= rel
        rel_text = f" rel_err={rel_err:.3e} (limit {rel:g})"
    print(f"{name}: max_abs_err={max_err:.3e} least_atol={least_atol:.3e}{rel_text} "
          f"(tol atol={atol:g} rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return max_err


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def tol(kernel: str, dtype_name: str) -> tuple[float, float]:
    """``(atol, rtol)`` of ``kernel``'s output in ``dtype_name``."""
    return (BF16_ATOL[kernel], 2 ** -7) if dtype_name == "bfloat16" else F32_TOL


def k1_check(tag: str, x, mask, h: int, causal: bool, out, dqkv, dout, err: dict) -> None:
    """K1f's output and K1b's dqkv for the head-major packed ``x`` against
    their plain versions (the backward's from the kernel's own output, as the
    autograd Function saves it), each element-wise and as a whole; the
    largest errors join ``err``."""
    from mmlearn_tpu_torch.ops import fused_attention as fa

    d = x.shape[-1] // (3 * h)
    scale, dn = d ** -0.5, _dtype_name(x.dtype)
    err["fused_mha_fwd"] = max(err["fused_mha_fwd"], compare(
        f"K1f fused_mha {tag}", out, fa.mha_reference(x, mask, h, scale, causal),
        tol("fused_mha_fwd", dn), K1_REL_TOL["fused_mha_fwd"][dn]))
    want_b = fa.mha_bwd_reference(x, mask, out, dout, h, scale, causal)
    err["fused_mha_bwd"] = max(err["fused_mha_bwd"], compare(
        f"K1b fused_mha dqkv {tag}", dqkv, want_b, tol("fused_mha_bwd", dn),
        K1_REL_TOL["fused_mha_bwd"][dn]))


def k1p_check(tag: str, x, mask, h: int, causal: bool, out, dqkv, dout, err: dict) -> None:
    """K1f-p's output and K1b-p's dqkv for ``x`` against their plain versions
    (K1's), element-wise and as a whole; in bf16 also against K1 on the same
    input (K1b from K1-p's output): equal bit for bit. The largest errors
    join ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import fused_attention as fa

    d = x.shape[-1] // (3 * h)
    scale, dn = d ** -0.5, _dtype_name(x.dtype)
    err["fused_mha_packed_fwd"] = max(err.get("fused_mha_packed_fwd", 0.0), compare(
        f"K1f-p fused_mha {tag}", out, fa.mha_reference(x, mask, h, scale, causal),
        tol("fused_mha_packed_fwd", dn), K1P_REL_TOL["fused_mha_packed_fwd"][dn]))
    err["fused_mha_packed_bwd"] = max(err.get("fused_mha_packed_bwd", 0.0), compare(
        f"K1b-p fused_mha dqkv {tag}", dqkv,
        fa.mha_bwd_reference(x, mask, out, dout, h, scale, causal),
        tol("fused_mha_packed_bwd", dn), K1P_REL_TOL["fused_mha_packed_bwd"][dn]))
    if dn != "bfloat16":
        return
    k1_out = fa._fused_mha_cuda(x, mask, h, scale, causal)
    k1_dqkv = fa._fused_mha_bwd_cuda(x, mask, out, dout, h, scale, causal)
    torch.cuda.synchronize()
    diff_out = float((out.float() - k1_out.float()).abs().max())
    diff_dqkv = float((dqkv.float() - k1_dqkv.float()).abs().max())
    same = diff_out == 0 and diff_dqkv == 0
    print(f"K1-p vs K1 {tag}: max |diff| out {diff_out:.3e}, dqkv {diff_dqkv:.3e} "
          f"(want 0) {'ok' if same else 'FAIL'}")
    check(same, f"K1-p {tag} is not K1 bit for bit")


def kernel_checks(device, gen) -> dict:
    """K1 against its plain version on the card at batch 8: forward and
    backward (through ``fused_mha`` and autograd) on the image and text
    attention cases (with a ragged and a left-padded mask), at the lengths
    where its bf16 code branches, and on a ``model=2`` rank's heads of each
    tower (phase 17's shapes). Returns each kernel's largest
    error (K2's at 0, for :func:`norm_checks`)."""
    import torch

    from mmlearn_tpu_torch.flagship import ragged_text_batch
    from mmlearn_tpu_torch.ops import fused_attention as fa

    b = 8
    mask = ragged_text_batch(b, gen, device)["text_attention_mask"]
    left = mask.flip(1).bool()  # left padding: early causal rows see no key
    cases = [  # (label, n, heads, head_dim, mask, causal, dtype)
        ("image", 197, 12, 64, None, False, torch.bfloat16),
        ("text causal", 77, 8, 64, None, True, torch.bfloat16),
        ("text causal+ragged mask", 77, 8, 64, mask.bool(), True, torch.bfloat16),
        ("text causal+left-pad mask", 77, 8, 64, left, True, torch.bfloat16),
        ("D=32", 197, 12, 32, None, False, torch.bfloat16),
        ("D=32 causal+mask", 77, 8, 32, mask.bool(), True, torch.bfloat16),
        ("f32 image", 197, 12, 64, None, False, torch.float32),
        ("f32 D=32 causal+mask", 77, 8, 32, mask.bool(), True, torch.float32),
        ("f32 causal+left-pad mask", 77, 8, 64, left, True, torch.float32),
    ]
    # where K1's bf16 code branches: its forward instances hold whole rows
    # of up to 128 and 224 keys, and take two sweeps past 224; and the
    # longest that supports_fused admits at each head dim (768 at D=64, 512
    # at D=32: 231,168 and 87,552 bytes of shared memory a forward block)
    lens = mask.sum(1, keepdim=True)
    for n, h, d in ((128, 2, 64), (129, 2, 64), (224, 2, 64), (225, 2, 64), (256, 2, 64),
                    (257, 2, 64), (768, 4, 64), (512, 4, 32)):
        edge_left = (torch.arange(n, device=device)[None] < (lens * n) // 77).flip(1)
        cases += [("edge", n, h, d, None, False, torch.bfloat16),
                  ("edge causal", n, h, d, None, True, torch.bfloat16),
                  ("edge causal+left-pad mask", n, h, d, edge_left, True, torch.bfloat16)]
    # phase 17's shapes: a model=2 rank's heads of the image and text towers,
    # with and without a ragged key mask, drawn from a generator of their own
    # so that the cases above keep their data
    tp_gen = torch.Generator(device=device).manual_seed(SEED + 175)
    image_mask = torch.arange(197, device=device)[None] < (lens * 197) // 77
    tp_cases = [("a model=2 rank's image heads", 197, 6, 64, None, False, torch.bfloat16),
                ("a model=2 rank's image heads+ragged mask", 197, 6, 64, image_mask, False,
                 torch.bfloat16),
                ("a model=2 rank's text heads causal", 77, 4, 64, None, True, torch.bfloat16),
                ("a model=2 rank's text heads causal+ragged mask", 77, 4, 64, mask.bool(), True,
                 torch.bfloat16)]
    err = {"fused_mha_fwd": 0.0, "fused_mha_bwd": 0.0, "layernorm_fwd": 0.0,
           "layernorm_bwd": 0.0}
    for i, (label, n, h, d, m, causal, dtype) in enumerate(cases + tp_cases):
        g = gen if i < len(cases) else tp_gen
        x = torch.randn(b, n, 3 * h * d, generator=g, device=device).to(dtype)
        dout = torch.randn(b, n, h * d, generator=g, device=device).to(dtype)
        x.requires_grad_()
        out = fa.fused_mha(x, m, num_heads=h, causal=causal)
        (dqkv,) = torch.autograd.grad(out, x, dout)
        x = x.detach()
        torch.cuda.synchronize()
        k1_check(f"{label} B={b} N={n} H={h} D={d} {_dtype_name(dtype)}", x, m, h, causal,
                 out.detach(), dqkv, dout, err)
        del x, dout, out, dqkv
    return err


def ln_sums_f64(x, dy, eps: float):
    """dgamma and dbeta of the LayerNorm backward, ``sum(dy * xhat)`` and
    ``sum(dy)`` over every row, evaluated in f64 from the inputs: what K2b's
    column sums are held to."""
    import torch

    c = x.shape[-1]
    xd, dyd = x.double().reshape(-1, c), dy.double().reshape(-1, c)
    xc = xd - xd.mean(-1, keepdim=True)
    xhat = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    return (dyd * xhat).sum(0), dyd.sum(0)


def norm_checks(device, gen, err: dict) -> None:
    """K2 forward and backward, both variants, against their plain versions
    on the card at batch 8 at the towers' widths; the largest errors join
    ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import fused_norm as fn

    b = 8
    # 384: the I-JEPA predictor's; 300: a ragged C (K2b's wide kernel, as f32
    # at 768 and 512)
    for n, c in ((197, 768), (77, 512), (118, 384), (37, 300)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = _dtype_name(dtype)
            x, br, dy, dr = (torch.randn(b, n, c, generator=gen, device=device).to(dtype)
                             for _ in range(4))
            g = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
            beta = 0.1 * torch.randn(c, generator=gen, device=device)
            leaves = [t.clone().requires_grad_() for t in (x, br, g, beta)]
            tag = f"B={b} N={n} C={c} {dn}"
            fwd_tol, bwd_tol = tol("layernorm_fwd", dn), tol("layernorm_bwd", dn)
            y = fn.fused_layernorm(leaves[0], leaves[2], leaves[3], eps=1e-6)
            gx, gg, gb = torch.autograd.grad(y, (leaves[0], leaves[2], leaves[3]), dy)
            r, y2 = fn.fused_add_layernorm(*leaves, eps=1e-5)
            ax, abr, ag, ab = torch.autograd.grad((r, y2), leaves, (dr, dy))
            wx, wg, wb = fn.ln_bwd_reference(x, g, dy, 1e-6)
            wax, wag, wab = fn.ln_bwd_reference(x + br, g, dy, 1e-5, dr)
            (eg, eb), (eag, eab) = ln_sums_f64(x, dy, 1e-6), ln_sums_f64(x + br, dy, 1e-5)
            torch.cuda.synchronize()
            err["layernorm_fwd"] = max(
                err["layernorm_fwd"],
                compare(f"K2f layernorm {tag}", y, fn.ln_reference(x, g, beta, 1e-6), fwd_tol),
                compare(f"K2f add+layernorm r {tag}", r, x + br, R_TOL),
                compare(f"K2f add+layernorm y {tag}", y2,
                        fn.ln_reference(x + br, g, beta, 1e-5), fwd_tol),
            )
            err["layernorm_bwd"] = max(
                err["layernorm_bwd"],
                compare(f"K2b layernorm dx {tag}", gx, wx, bwd_tol),
                compare(f"K2b layernorm dgamma {tag}", gg, wg, SUM_TOL),
                compare(f"K2b layernorm dbeta {tag}", gb, wb, SUM_TOL),
                compare(f"K2b add+layernorm dx {tag}", ax, wax, bwd_tol),
                compare(f"K2b add+layernorm dbranch {tag}", abr, wax, bwd_tol),
                compare(f"K2b add+layernorm dgamma {tag}", ag, wag, SUM_TOL),
                compare(f"K2b add+layernorm dbeta {tag}", ab, wab, SUM_TOL),
                compare(f"K2b layernorm dgamma {tag} against f64", gg, eg, SUM_F64_TOL),
                compare(f"K2b layernorm dbeta {tag} against f64", gb, eb, SUM_F64_TOL),
                compare(f"K2b add+layernorm dgamma {tag} against f64", ag, eag, SUM_F64_TOL),
                compare(f"K2b add+layernorm dbeta {tag} against f64", ab, eab, SUM_F64_TOL),
            )


# K2f's widths at batch 8, N=37: the towers' on the rows kernel (1408: eight
# vectors of 256 values, the last two and a half masked), 136 (one vector,
# most lanes masked), and on the wide kernel a ragged C (300) and C = 8192
K2F_ROUTE_WIDTHS = (384, 512, 768, 1024, 1280, 1408, 136, 300, 8192)


def k2f_route_checks(device, err: dict) -> None:
    """K2f on each route of its plan, both variants, against its plain
    version at its limits, at ``K2F_ROUTE_WIDTHS`` in bf16 and f32, on rows
    at 0, 1 and 4 elements past an aligned address (16-byte aligned, aligned
    to the element only, and in bf16 8-byte aligned); ``r`` bit for bit;
    the plan's route (``fused_norm.fwd_plan``) equal to its mirror
    (``fused_norm.fwd_route``). The largest error joins ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device=device).manual_seed(SEED + 200)
    b, n = 8, 37
    routes = set()
    for c in K2F_ROUTE_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            dn = _dtype_name(dtype)
            g = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
            beta = 0.1 * torch.randn(c, generator=gen, device=device)
            for offset in (0, 1, 4):
                x, br = (torch.randn(b * n * c + offset, generator=gen, device=device)
                         .to(dtype)[offset:].view(b, n, c) for _ in range(2))
                align = fn._alignment(x, br)
                route = fn.fwd_route(c, dtype, align)
                for has_add in (False, True):
                    planned = fn.fwd_plan(b * n, c, dtype, has_add, align)[:2]
                    check(planned == route, f"K2f's plan at C={c} {dn} {align}-byte aligned "
                          f"picks {planned}, its mirror fwd_route {route}")
                kind = f"rows {route[0]}-byte x{route[1]}" if route[0] else "wide"
                routes.add(f"{kind} {dn}")
                tag = f"B={b} N={n} C={c} {dn} +{offset} ({align}-byte aligned, {kind})"
                fwd_tol = tol("layernorm_fwd", dn)
                y = fn.fused_layernorm(x, g, beta, eps=1e-6)
                r, y2 = fn.fused_add_layernorm(x, br, g, beta, eps=1e-5)
                torch.cuda.synchronize()
                err["layernorm_fwd"] = max(
                    err["layernorm_fwd"],
                    compare(f"K2f layernorm {tag}", y, fn.ln_reference(x, g, beta, 1e-6),
                            fwd_tol),
                    compare(f"K2f add+layernorm r {tag}", r, x + br, R_TOL),
                    compare(f"K2f add+layernorm y {tag}", y2,
                            fn.ln_reference(x + br, g, beta, 1e-5), fwd_tol))
    print(f"K2f routes checked: {', '.join(sorted(routes))}")


def k1_draws(device, err: dict) -> None:
    """K1f and K1b at the text tower's grid (B=256, N=77, H=8, causal),
    where the early rows see few keys and p and ds are largest, over
    ``K1_DRAWS`` draws of a generator of their own, each held to K1's
    limits; the largest errors join ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    n, h, d = 77, 8, 64
    for i in range(K1_DRAWS):
        qkv = torch.randn(BATCH, n, 3 * h * d, generator=gen, device=device).bfloat16()
        dout = torch.randn(BATCH, n, h * d, generator=gen, device=device).bfloat16()
        out = fa._fused_mha_cuda(qkv, None, h, d ** -0.5, True)
        dqkv = fa._fused_mha_bwd_cuda(qkv, None, out, dout, h, d ** -0.5, True)
        torch.cuda.synchronize()
        k1_check(f"text N={n} H={h} causal B={BATCH} D={d} bf16 draw {i}", qkv, None, h, True,
                 out, dqkv, dout, err)
    reset_counts()


def print_times(rows: dict) -> None:
    for label, (ms, plain, lib, bnd, by) in rows.items():
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        at = "" if "B=" in label else f" B={BATCH}"
        print(f"time {label}{at} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib_s}, bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it)")


def kernels_at_batch(device, gen, err: dict) -> dict:
    """At batch 256, bf16, at the paths' shapes and so at the grids the
    training step launches: K1 against its plain version (its largest error
    joins ``err``), then its time beside its plain version's, that of the one
    PyTorch call that computes the same function (a yardstick the port never
    calls), and its bound. Returns ``{row: (ms, plain_ms, library_ms or
    None, bound_ms, bound_by)}``."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.flagship import ragged_text_batch
    from mmlearn_tpu_torch.ops import fused_attention as fa

    rows = {}
    text_mask = ragged_text_batch(BATCH, gen, device)["text_attention_mask"]
    for label, n, h, causal, mask in (
        ("image N=197 H=12", 197, 12, False, None),
        ("text N=77 H=8 causal", 77, 8, True, None),
        ("text N=77 H=8 causal+mask", 77, 8, True, text_mask.bool()),
    ):
        d, scale = 64, 0.125
        qkv = torch.randn(BATCH, n, 3 * h * d, generator=gen, device=device).bfloat16()
        dout = torch.randn(BATCH, n, h * d, generator=gen, device=device).bfloat16()
        out = fa._fused_mha_cuda(qkv, mask, h, scale, causal)
        dqkv = fa._fused_mha_bwd_cuda(qkv, mask, out, dout, h, scale, causal)
        torch.cuda.synchronize()
        k1_check(f"{label} B={BATCH} D={d} bf16", qkv, mask, h, causal, out, dqkv, dout, err)
        pairs = attention_pairs(BATCH, n, mask, causal)
        # the library call on the same values laid out (B, H, N, D)
        q, k, v = (t.contiguous().requires_grad_() for t in
                   qkv.view(BATCH, n, h, 3, d).permute(3, 0, 2, 1, 4).unbind(0))
        sdpa_kw = {"is_causal": True} if causal and mask is None else {}
        if mask is not None:
            keep = torch.ones(n, n, dtype=torch.bool, device=device).tril()
            sdpa_kw = {"attn_mask": mask[:, None, None, :] & keep}
        lib_out = F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
        lib_dout = dout.view(BATCH, n, h, d).transpose(1, 2).contiguous()
        rows[f"K1f {label}"] = (
            cuda_ms(lambda: fa.fused_mha(qkv, mask, num_heads=h, causal=causal)),
            cuda_ms(lambda: fa.mha_reference(qkv, mask, h, scale, causal)),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw)),
            *bound(nbytes(qkv, out, mask), 4 * h * d * pairs, "bfloat16"),
        )
        rows[f"K1b {label}"] = (
            cuda_ms(lambda: fa._fused_mha_bwd_cuda(qkv, mask, out, dout, h, scale, causal)),
            cuda_ms(lambda: fa.mha_bwd_reference(qkv, mask, out, dout, h, scale, causal),
                    iters=5),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), lib_dout,
                                                retain_graph=True)),
            *bound(nbytes(qkv, out, dout, qkv, mask), 10 * h * d * pairs, "bfloat16"),
        )
    print_times(rows)
    return rows


# the towers' norms at batch 256 and the I-JEPA predictor's (1,024 x 118 =
# 120,832 rows of 384): (label, B, N, C)
NORM_GRIDS = (("N=197 C=768", BATCH, 197, 768), ("N=77 C=512", BATCH, 77, 512),
              ("B=1024 N=118 C=384", 1024, 118, 384))
# the large presets' (phase 12's grids): ViT-H/14's image tower at b128, its
# text tower's, ViT-g/14's at b64
LARGE_NORM_GRIDS = (("B=128 N=257 C=1280", 128, 257, 1280),
                    ("B=128 N=77 C=1024", 128, 77, 1024),
                    ("B=64 N=257 C=1408", 64, 257, 1408))


def norm_batch_inputs(device, grids=NORM_GRIDS, seed: int = NORMS_SEED):
    """The inputs :func:`norms_at_batch` checks and times, from a generator
    of their own (``seed``): for each of ``grids``, ``(label, c, x, branch,
    dy, dr, gamma, beta)``, bf16 rows and f32 weights."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    for label, b, n, c in grids:
        x, br, dy, dr = (torch.randn(b, n, c, generator=gen, device=device).bfloat16()
                         for _ in range(4))
        g = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
        beta = 0.1 * torch.randn(c, generator=gen, device=device)
        yield label, c, x, br, dy, dr, g, beta


def norms_at_batch(device, err: dict, grids=NORM_GRIDS, seed: int = NORMS_SEED) -> dict:
    """K2 as :func:`kernels_at_batch` holds K1, on :func:`norm_batch_inputs`
    at ``grids``; K2b's column sums against their f64 evaluation (the plain
    version's own f32 sums are further off than the limit there), and K2b
    run twice on one input for equal bits. Returns rows as
    :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import fused_norm as fn

    def worst(kernel: str, *errors: float) -> None:
        err[kernel] = max(err[kernel], *errors)

    ln_fwd, ln_bwd = tol("layernorm_fwd", "bfloat16"), tol("layernorm_bwd", "bfloat16")
    rows = {}
    for label, c, x, br, dy, dr, g, beta in norm_batch_inputs(device, grids, seed):
        tag = f"{label} bf16" if "B=" in label else f"B={BATCH} {label} bf16"
        r, y2 = fn.fused_add_layernorm(x, br, g, beta)
        worst("layernorm_fwd",
              compare(f"K2f layernorm {tag}", fn.fused_layernorm(x, g, beta),
                      fn.ln_reference(x, g, beta, 1e-6), ln_fwd),
              compare(f"K2f add+layernorm r {tag}", r, x + br, R_TOL),
              compare(f"K2f add+layernorm y {tag}", y2,
                      fn.ln_reference(x + br, g, beta, 1e-6), ln_fwd))
        sums = ln_sums_f64(x, dy, 1e-6)
        for variant, d_r in (("layernorm", None), ("add+layernorm", dr)):
            got = fn._launch_bwd(x, g, dy, 1e-6, d_r)
            want = fn.ln_bwd_reference(x, g, dy, 1e-6, d_r)
            worst("layernorm_bwd",
                  compare(f"K2b {variant} dx {tag}", got[0], want[0], ln_bwd),
                  compare(f"K2b {variant} dgamma {tag} against f64", got[1], sums[0],
                          SUM_F64_TOL),
                  compare(f"K2b {variant} dbeta {tag} against f64", got[2], sums[1],
                          SUM_F64_TOL))
            # the column sums in a fixed order: the same bits on a second run
            again = fn._launch_bwd(x, g, dy, 1e-6, d_r)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"K2b {variant} {tag}: dx, dgamma, dbeta of two runs equal bit for bit "
                  f"{'ok' if same else 'FAIL'}")
            check(same, f"K2b {variant} {tag} differs from run to run")
        del sums
        gl, bl = g.bfloat16(), beta.bfloat16()  # F.layer_norm takes weights in x's type
        # the library's backward as one ATen call, dx, dgamma and dbeta as K2b
        # computes them. F.layer_norm's backward through autograd, on an x that
        # alone needs a gradient, computes dx only: printed beside it, with the
        # one ATen call it makes (its device time without autograd's host time)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, (c,), gl, bl, 1e-6)
        xl = x.clone().requires_grad_()
        yl = F.layer_norm(xl, (c,), gl, bl, 1e-6)
        dx_autograd = cuda_ms(lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True))
        dx_aten = cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, (c,), mean, rstd, gl, bl, (True, False, False)))
        print(f"time K2b layernorm {label}: F.layer_norm backward, dx only: through autograd "
              f"{dx_autograd:.4f} ms, its ATen call {dx_aten:.4f} ms")
        del xl, yl
        # each kernel, and its library call, in device time alone (L2 cold
        # where the row's bytes fit in it), beside the host's time a call and
        # the events over a loop of calls (cuda_ms, where the host's time can
        # show); beside the forward, a copy of x, which moves its bytes but
        # gamma's and beta's; the plain versions by cuda_ms
        for name, kernel, plain, lib, moved in (
                ("K2f layernorm", lambda: fn.fused_layernorm(x, g, beta),
                 lambda: fn.ln_reference(x, g, beta, 1e-6),
                 lambda: F.layer_norm(x, (c,), gl, bl, 1e-6), (x, x, g, beta)),
                ("K2f add+layernorm", lambda: fn.fused_add_layernorm(x, br, g, beta),
                 lambda: (lambda r: (r, fn.ln_reference(r, g, beta, 1e-6)))(x + br),
                 None,  # two PyTorch calls (add, layer_norm)
                 (x, br, x, x, g, beta)),
                ("K2b layernorm", lambda: fn._launch_bwd(x, g, dy, 1e-6),
                 lambda: fn.ln_bwd_reference(x, g, dy, 1e-6),
                 lambda: torch.ops.aten.native_layer_norm_backward(
                     dy, x, (c,), mean, rstd, gl, bl, (True, True, True)), (x, dy, x, g, g, g)),
                ("K2b add+layernorm", lambda: fn._launch_bwd(x, g, dy, 1e-6, dr),
                 lambda: fn.ln_bwd_reference(x, g, dy, 1e-6, dr),
                 None,  # the layer_norm backward and an add
                 (x, dy, dr, x, g, g, g))):
            bnd = bound(nbytes(*moved), 0, "bfloat16")
            cold = nbytes(*moved) < L2_BYTES
            ms, lib_ms = device_ms(kernel, cold), lib and device_ms(lib, cold)
            lib_s = "" if lib is None else f"; library {lib_ms:.4f} ms"
            if name == "K2f layernorm":  # the card's own pace for these bytes
                out = torch.empty_like(x)
                lib_s += f"; x copied (copy_) {device_ms(lambda: out.copy_(x), cold):.4f} ms"
                del out
            print(f"time {name} {label} device {ms:.4f} ms (L2 {'cold' if cold else 'warm'}; "
                  f"{bnd[0] / ms:.1%} of its bound){lib_s}; host {host_us(kernel):.1f} us a call; "
                  f"events over 20 calls {cuda_ms(kernel):.4f} ms")
            rows[f"{name} {label}"] = (ms, cuda_ms(plain), lib_ms, *bnd)
    print_times(rows)
    return rows


def packed_kernel_checks(device, gen, err: dict) -> None:
    """K1f-p and K1b-p, reached through ``fused_mha`` with the variable set,
    at batch 8 over every case at each of ``PACKED_LENGTHS`` in bf16 (and
    ``PACKED_F32_LENGTHS`` in f32), two head groups: no mask, a ragged key
    mask, causal, causal with a left-padded mask (early rows see no key);
    each against its plain version and, in bf16, against K1
    (:func:`k1p_check`). Their largest errors join ``err``."""
    import torch

    from mmlearn_tpu_torch.flagship import ragged_text_batch
    from mmlearn_tpu_torch.ops import fused_attention as fa

    b = 8
    cases = [(n, d, torch.bfloat16) for n, d in PACKED_LENGTHS]
    cases += [(n, d, torch.float32) for n, d in PACKED_F32_LENGTHS]
    for n, d, dtype in cases:
        lens = ragged_text_batch(b, gen, device)["text_attention_mask"].sum(1, keepdim=True)
        ragged = torch.arange(n, device=device)[None] < (lens * n) // 77
        for label, mask, causal in (("", None, False), ("mask", ragged, False),
                                    ("causal", None, True),
                                    ("causal+left-pad mask", ragged.flip(1), True)):
            dn, h = _dtype_name(dtype), 2 * fa._head_group(d)
            x = torch.randn(b, n, 3 * h * d, generator=gen, device=device).to(dtype)
            dout = torch.randn(b, n, h * d, generator=gen, device=device).to(dtype)
            reset_counts()
            with packed_attention(True):
                leaf = x.clone().requires_grad_()
                out = fa.fused_mha(leaf, mask, num_heads=h, causal=causal)
                (dqkv,) = torch.autograd.grad(out, leaf, dout)
            torch.cuda.synchronize()
            check(fa.LAUNCHES["fused_mha_packed_fwd"] == 1
                  and fa.LAUNCHES["fused_mha_packed_bwd"] == 2
                  and fa.LAUNCHES["fused_mha_fwd"] == 0 and fa.LAUNCHES["fused_mha_bwd"] == 0,
                  f"fused_mha with {PACKED_ENV}=1 launched {fa.LAUNCHES}")
            k1p_check(f"{label or 'no mask'} B={b} N={n} H={h} D={d} {dn}", x, mask, h, causal,
                      out.detach(), dqkv, dout, err)
    reset_counts()


def ijepa_attention_at_batch(device, gen, err: dict) -> dict:
    """At the I-JEPA step's attention shapes and grids, bf16: K1f-p/K1b-p
    and K1f/K1b (K1 runs there by default) against their plain version, and
    K1-p against K1 bit for bit, then the times of each beside the plain
    version's, SDPA's (a yardstick the port never calls) and the bound.
    Returns rows as :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import fused_attention as fa

    rows = {}
    for label, b, n, h, d in IJEPA_ATTENTION:
        scale = d ** -0.5
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device).bfloat16()
        dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
        want = fa.mha_reference(qkv, None, h, scale, False)
        q, k, v = (t.contiguous().requires_grad_() for t in
                   qkv.view(b, n, h, 3, d).permute(3, 0, 2, 1, 4).unbind(0))
        lib_out = F.scaled_dot_product_attention(q, k, v)
        lib_dout = dout.view(b, n, h, d).transpose(1, 2).contiguous()
        pairs = attention_pairs(b, n, None, False)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), lib_dout,
                                                      retain_graph=True))
        plain_fwd = cuda_ms(lambda: fa.mha_reference(qkv, None, h, scale, False), iters=5)
        for packed, name in ((True, "K1f-p"), (False, "K1f")):
            out = fa._fused_mha_cuda(qkv, None, h, scale, False, packed)
            dqkv = fa._fused_mha_bwd_cuda(qkv, None, out, dout, h, scale, False, packed)
            torch.cuda.synchronize()
            tag = f"{label} B={b} bf16"
            check_kernels = k1p_check if packed else k1_check
            check_kernels(tag, qkv, None, h, False, out, dqkv, dout, err)
            rows[f"{name} {label} B={b}"] = (
                cuda_ms(lambda: fa._fused_mha_cuda(qkv, None, h, scale, False, packed)),
                plain_fwd, lib_fwd,
                *bound(nbytes(qkv, out), 4 * h * d * pairs, "bfloat16"),
            )
            rows[f"{name.replace('f', 'b', 1)} {label} B={b}"] = (
                cuda_ms(lambda: fa._fused_mha_bwd_cuda(qkv, None, out, dout, h, scale, False,
                                                       packed)),
                cuda_ms(lambda: fa.mha_bwd_reference(qkv, None, out, dout, h, scale, False),
                        iters=3),
                lib_bwd,
                *bound(nbytes(qkv, out, dout, qkv), 10 * h * d * pairs, "bfloat16"),
            )
        del qkv, dout, want, q, k, v, lib_out, lib_dout, out, dqkv
        torch.cuda.empty_cache()
    for label, (ms, plain, lib, bnd, by) in rows.items():
        print(f"time {label} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it)")
    reset_counts()
    return rows


def int8_kernel_checks(device, gen, err: dict) -> None:
    """K5 against its plain version, exactly: small cases through
    ``switchback_matmul`` with a bias (its forward, the bias added in K5's
    epilogue, and its dgrad, each a K5 launch where ``supports_int8_qmm``
    routes the shape to it, the composed product and a separate add
    elsewhere; the launches of each of K5's paths are checked) at ragged M,
    N and K, in bf16 and f32, covering both paths (TMA where K is a multiple
    of 16, byte loads elsewhere) and each row block of the byte path (64, 32
    and 16 rows); then all 16 projection products of the flagship step at
    batch 256 in bf16, forward and dgrad, and image fc1's forward with its
    bias. The largest error joins ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import int8_matmul as im

    cases = [  # (m, k, n, dtype); the TMA path takes a product whose K % 16 == 0
        (8, 128, 128, torch.bfloat16),  # the least M the routing admits
        (37, 200, 160, torch.bfloat16),  # forward K % 16 != 0: byte loads
        (130, 100, 300, torch.float32),  # dgrad N = 100: composed
        (300, 96, 520, torch.float32),  # forward on TMA in f32; dgrad N = 96: composed
        (77, 3072, 768, torch.bfloat16),  # both on TMA at the largest flagship K
        (520, 3270, 130, torch.float32),  # byte path, 32-row blocks
        (40, 8190, 136, torch.bfloat16),  # byte path, 16-row blocks at K = 8190
        (40, 8192, 136, torch.bfloat16),  # TMA at the largest K
        (20, 256, 64, torch.bfloat16),  # forward N = 64: composed
    ]
    err.setdefault("int8_qmm", 0.0)
    for m, k, n, dtype in cases:
        dn = _dtype_name(dtype)
        x = torch.randn(m, k, generator=gen, device=device).to(dtype)
        w = (torch.randn(n, k, generator=gen, device=device) * k ** -0.5).to(dtype)
        b = torch.randn(n, generator=gen, device=device).to(dtype)
        g = torch.randn(m, n, generator=gen, device=device).to(dtype)
        xl, wl, bl = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone()
        bl.requires_grad_()
        reset_counts()
        y = im.switchback_matmul(xl, wl, bl)
        dx, _, _ = torch.autograd.grad(y, (xl, wl, bl), g)
        torch.cuda.synchronize()
        routed = [im.supports_int8_qmm(m, k, n), im.supports_int8_qmm(m, n, k)]
        tma = [routed[0] and k % 16 == 0, routed[1] and n % 16 == 0]
        got = (im.LAUNCHES["int8_qmm"], im.LAUNCHES["int8_qmm_bytes"])
        want = (sum(tma), sum(routed) - sum(tma))
        check(got == want, f"switchback M={m} K={k} N={n} launched K5 (TMA, bytes) {got} "
              f"times, want {want}")
        tag = f"M={m} K={k} N={n} {dn}"
        err["int8_qmm"] = max(
            err["int8_qmm"],
            compare(f"K5 int8_qmm fwd+bias {tag}", y,
                    im.int8_qmm_reference(x, *im.quantize_weight(w), b), K5_TOL),
            compare(f"K5 int8_qmm dgrad {tag}", dx,
                    im.int8_qmm_reference(g, *im.quantize_weight(w.t().contiguous())),
                    K5_TOL))
    for label, m, c_in, c_out in INT8_SHAPES:
        for way, k, n in (("fwd", c_in, c_out), ("dgrad", c_out, c_in)):
            x = torch.randn(m, k, generator=gen, device=device).bfloat16()
            qw, sw = im.quantize_weight(torch.randn(n, k, generator=gen, device=device)
                                        .mul(k ** -0.5).bfloat16())
            got = im.int8_qmm(x, qw, sw)
            err["int8_qmm"] = max(err["int8_qmm"], compare(
                f"K5 int8_qmm {label} {way} M={m} K={k} N={n} bf16", got,
                im.int8_qmm_reference(x, qw, sw), K5_TOL))
            if label == "image fc1" and way == "fwd":  # the bias epilogue at the path's shape
                b = torch.randn(n, generator=gen, device=device).bfloat16()
                err["int8_qmm"] = max(err["int8_qmm"], compare(
                    f"K5 int8_qmm {label} fwd+bias M={m} K={k} N={n} bf16",
                    im.int8_qmm(x, qw, sw, b), im.int8_qmm_reference(x, qw, sw) + b, K5_TOL))
            del x, qw, sw, got
    torch.cuda.empty_cache()
    reset_counts()


def int8_at_batch(device, gen) -> dict:
    """K5's time at the image tower's four projections and at fc1's dgrad,
    batch 256, bf16, beside its plain version's and its bound (int8
    operations over the int8 peak, or bytes). A bf16 ``F.linear`` of the
    same shape and ``torch._int_mm`` on operands quantized beforehand are
    printed beside it as context: neither computes K5's function, so the
    row's library time is none. Returns rows as :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import int8_matmul as im

    rows = {}
    shapes = [(f"{label} fwd", m, k, n) for label, m, k, n in INT8_SHAPES[:4]]
    shapes.append(("image fc1 dgrad", BATCH * 197, 4 * 768, 768))
    for label, m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device=device).bfloat16()
        w = (torch.randn(n, k, generator=gen, device=device) * k ** -0.5).bfloat16()
        qw, sw = im.quantize_weight(w)
        out = im.int8_qmm(x, qw, sw)
        qx = im.quantize_weight(x)[0]
        row = f"K5 {label} M={m} K={k} N={n}"
        rows[row] = (
            cuda_ms(lambda: im.int8_qmm(x, qw, sw)),
            cuda_ms(lambda: im.int8_qmm_reference(x, qw, sw), iters=3),
            None,
            *bound(nbytes(x, qw, sw, out), 2 * m * k * n, "int8"),
        )
        b = torch.randn(n, generator=gen, device=device).bfloat16()
        bias_ms = cuda_ms(lambda: im.int8_qmm(x, qw, sw, b))
        linear_ms = cuda_ms(lambda: F.linear(x, w))
        int_mm_ms = cuda_ms(lambda: torch._int_mm(qx, qw.t()))
        ms, plain, _, bnd, by = rows[row]
        print(f"time {row} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library none, "
              f"bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it); with the bias {bias_ms:.4f} "
              f"ms; context: bf16 F.linear {linear_ms:.4f} ms, torch._int_mm of the quantized "
              f"operands {int_mm_ms:.4f} ms")
        del x, w, b, qw, sw, out, qx
    torch.cuda.empty_cache()
    reset_counts()
    return rows


def _flash_mask(kind: str, b: int, n: int, device):
    """None; right padding (a ragged tail in sample 0); left padding (sample
    0's first third: early causal rows see no key); sample 1 wholly masked."""
    import torch

    if kind == "no mask":
        return None
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    if kind == "right pad":
        mask[0, n - n // 3:] = False
    elif kind == "left pad":
        mask[0, : n // 3] = False
    else:
        mask[1] = False
    return mask


def flash_kernel_checks(device, gen, err: dict) -> None:
    """K3f and K3b, reached through ``flash_attention`` and autograd, against
    their plain versions at batch 8 over every case: N 785, 1,000 and 2,049
    (ragged last tiles); no mask, right padding, left padding, one wholly
    masked sample; causal or not; head dim 32 and 64; f32 and bf16. Compares
    the output, the log-sum-exp, dQ, dK and dV (the output and gradients
    also as a whole); the largest errors join ``err``."""
    import torch

    from mmlearn_tpu_torch.ops import flash_attention as fl

    b, h = 8, 3
    err.setdefault("flash_attention_fwd", 0.0)
    err.setdefault("flash_attention_bwd", 0.0)
    for n in (785, 1000, 2049):
        for d in (32, 64):
            for kind in ("no mask", "right pad", "left pad", "empty sample"):
                mask = _flash_mask(kind, b, n, device)
                for causal in (False, True):
                    for dtype in (torch.bfloat16, torch.float32):
                        dn, scale = _dtype_name(dtype), d ** -0.5
                        q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=device)
                                       .to(dtype) for _ in range(4))
                        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                        reset_counts()
                        out = fl.flash_attention(*leaves, mask, causal=causal)
                        grads = torch.autograd.grad(out, leaves, do)
                        _, lse = fl._flash_fwd_cuda(q, k, v, mask, scale, causal)
                        torch.cuda.synchronize()
                        check(launch_counts()["flash_fwd"] == 2
                              and launch_counts()["flash_bwd_dq"] == 1,
                              f"flash_attention launched {launch_counts()}")
                        want, want_lse = fl.flash_fwd_reference(q, k, v, mask, scale, causal)
                        # the backward's plain version from the kernel's own
                        # output and log-sum-exp, as the autograd Function saves
                        want_b = fl.flash_bwd_reference(q, k, v, mask, out.detach(), lse, do,
                                                        scale, causal)
                        tag = (f"{kind}{' causal' if causal else ''} B={b} N={n} H={h} D={d} "
                               f"{dn}")
                        fwd_tol, bwd_tol = (tol("flash_attention_fwd", dn),
                                            tol("flash_attention_bwd", dn))
                        fwd_rel = FLASH_REL_TOL["flash_attention_fwd"][dn]
                        bwd_rel = FLASH_REL_TOL["flash_attention_bwd"][dn]
                        err["flash_attention_fwd"] = max(
                            err["flash_attention_fwd"],
                            compare(f"K3f flash out {tag}", out, want, fwd_tol, fwd_rel))
                        compare(f"K3f flash lse {tag}", lse, want_lse, LSE_TOL)
                        if kind == "empty sample":
                            mean = v[1].float().mean(dim=1, keepdim=True).expand(h, n, d)
                            compare(f"K3f flash out of the masked sample {tag}", out[1], mean,
                                    MASKED_ROW_TOL)
                        err["flash_attention_bwd"] = max(err["flash_attention_bwd"], *(
                            compare(f"K3b flash d{name} {tag}", got, w, bwd_tol, bwd_rel)
                            for name, got, w in zip("qkv", grads, want_b)))
                        del q, k, v, do, leaves, out, grads, want, want_b
    torch.cuda.empty_cache()
    reset_counts()


def flash_at_grids(device, gen, err: dict) -> dict:
    """K3 in bf16 at the grids of the 448 path: K3f at 448 ``encode``'s
    (B=256, H=12, N=785, D=64) against its plain version sample block by
    sample block, and its time beside SDPA's; K3f and K3b at the training
    step's (B=64) and at B=1, N=16,385 (ViT-B/16 at 2,048 px): forward and
    backward against their plain versions (head by head at 16,385, to bound
    their memory), then the times of each beside the plain version's,
    SDPA's (a yardstick the port never calls: its forward, its backward
    through autograd, and both) and the bound; at 16,385 the peak memory of
    a forward and backward through each. Returns rows as
    :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import flash_attention as fl

    rows = {}
    fwd_tol, bwd_tol = tol("flash_attention_fwd", "bfloat16"), tol("flash_attention_bwd",
                                                                  "bfloat16")
    fwd_rel = FLASH_REL_TOL["flash_attention_fwd"]["bfloat16"]
    bwd_rel = FLASH_REL_TOL["flash_attention_bwd"]["bfloat16"]
    b, h, n, d = BATCH, 12, 785, 64
    scale = d ** -0.5
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=device).bfloat16()
               for _ in range(3))
    out, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False)
    blocks = [slice(i, i + 32) for i in range(0, b, 32)]

    def plain_fwd():
        return [fl.flash_fwd_reference(q[s], k[s], v[s], None, scale, False) for s in blocks]

    want = plain_fwd()
    tag = f"448 encode N=785 B={b} H={h} D={d} bf16"
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], compare(
        f"K3f flash out {tag}", out, torch.cat([o for o, _ in want]), fwd_tol, fwd_rel))
    compare(f"K3f flash lse {tag}", lse, torch.cat([l for _, l in want]), LSE_TOL)
    del want
    rows["K3f encode N=785"] = (
        cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False)),
        cuda_ms(plain_fwd, iters=2, warmup=1),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        *bound(nbytes(q, k, v, out, lse), 4 * h * d * b * n * n, "bfloat16"),
    )
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    for label, b, n in (("image N=785", HIGHRES_BATCH, 785), ("N=16385", 1, 16385)):
        h, d = 12, 64
        scale = d ** -0.5
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=device).bfloat16()
                       for _ in range(4))
        out, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False)
        grads = fl._flash_bwd_cuda(q, k, v, None, out, lse, do, scale, False)
        heads = [slice(i, i + 1) for i in range(h)] if b == 1 else [slice(None)]

        def plain_fwd():
            return [fl.flash_fwd_reference(q[:, s], k[:, s], v[:, s], None, scale, False)
                    for s in heads]

        def plain_bwd():
            return [fl.flash_bwd_reference(q[:, s], k[:, s], v[:, s], None, out[:, s], lse[:, s],
                                           do[:, s], scale, False) for s in heads]

        want = plain_fwd()
        want_out = torch.cat([o for o, _ in want], 1)
        want_lse = torch.cat([l for _, l in want], 1)
        del want
        tag = f"{label} B={b} H={h} D={d} bf16"
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], compare(
            f"K3f flash out {tag}", out, want_out, fwd_tol, fwd_rel))
        compare(f"K3f flash lse {tag}", lse, want_lse, LSE_TOL)
        del want_out, want_lse
        want_b = plain_bwd()
        for i, name in enumerate("qkv"):
            err["flash_attention_bwd"] = max(err["flash_attention_bwd"], compare(
                f"K3b flash d{name} {tag}", grads[i], torch.cat([w[i] for w in want_b], 1),
                bwd_tol, bwd_rel))
        del want_b, grads
        torch.cuda.empty_cache()

        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv)
        pairs = b * n * n
        fwd_bytes = nbytes(q, k, v, out, lse)
        bwd_bytes = nbytes(q, k, v, out, do, lse, q, k, v)
        sdpa_both = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(lq, lk, lv), (lq, lk, lv), do))
        rows[f"K3f {label}"] = (
            cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False)),
            cuda_ms(plain_fwd, iters=2, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            *bound(fwd_bytes, 4 * h * d * pairs, "bfloat16"),
        )
        rows[f"K3b {label}"] = (
            cuda_ms(lambda: fl._flash_bwd_cuda(q, k, v, None, out, lse, do, scale, False)),
            cuda_ms(plain_bwd, iters=2, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do, retain_graph=True)),
            *bound(bwd_bytes, 10 * h * d * pairs, "bfloat16"),
        )
        fwd_ms, bwd_ms = rows[f"K3f {label}"][0], rows[f"K3b {label}"][0]
        print(f"time {label} B={b} bf16 forward + backward: K3 {fwd_ms + bwd_ms:.4f} ms "
              f"({14 * h * d * pairs / (fwd_ms + bwd_ms) / 1e9:.1f} TFLOP/s), SDPA through "
              f"autograd {sdpa_both:.4f} ms")
        if b == 1:
            peaks = {}
            for name, fn in (("K3", fl.flash_attention),
                             ("SDPA", F.scaled_dot_product_attention)):
                del lib_out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                lib_out = fn(lq, lk, lv)
                torch.autograd.grad(lib_out, (lq, lk, lv), do)
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated(device) - base) / 1e6
            print(f"peak memory of a forward and backward at N={n} B=1 H={h} D={d} bf16, above "
                  f"the inputs: K3 {peaks['K3']:.1f} MB, SDPA {peaks['SDPA']:.1f} MB")
        del q, k, v, do, out, lse, lq, lk, lv, lib_out
        torch.cuda.empty_cache()
    for label, (ms, plain, lib, bnd, by) in rows.items():
        print(f"time {label} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it)")
    reset_counts()
    return rows


def flash_packed_at_grid(device, gen, err: dict) -> dict:
    """K3f and K3b in the 448 training step's own layout: q, k, v as strided
    views of a packed ``(B, N, H * 3 * D)`` projection (B=64, N=785, H=12,
    D=64, bf16) through ``flash_attention_qkv`` and autograd, the gradient of
    the projection written in place by K3b; held to the plain versions on the
    same views (element-wise and as a whole). Then each kernel twice on the
    same input, which must give the same bits, once from a thread that has
    made no CUDA call before, and the times of each beside
    its plain version's, SDPA's on the same views (a yardstick the port never
    calls; its backward through autograd into the packed leaf) and the bound.
    Returns rows as :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import flash_attention as fl

    b, h, n, d = HIGHRES_BATCH, 12, 785, 64
    scale = d ** -0.5
    fwd_tol, bwd_tol = tol("flash_attention_fwd", "bfloat16"), tol("flash_attention_bwd",
                                                                  "bfloat16")
    fwd_rel = FLASH_REL_TOL["flash_attention_fwd"]["bfloat16"]
    bwd_rel = FLASH_REL_TOL["flash_attention_bwd"]["bfloat16"]
    qkv = torch.randn(b, n, h * 3 * d, generator=gen, device=device).bfloat16()
    dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
    x = qkv.clone().requires_grad_()
    reset_counts()
    out = fl.flash_attention_qkv(x, num_heads=h)
    out.backward(dout)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["flash_fwd"] == 1 and counts["flash_bwd_dq"] == 1
          and counts["flash_bwd_dkv"] == 1, f"flash_attention_qkv launched {counts}")
    q, k, v = fl.split_qkv(qkv, h)
    do = dout.view(b, n, h, d).transpose(1, 2)
    out_v = out.detach().view(b, n, h, d).transpose(1, 2)
    _, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False)
    tag = f"448 train packed qkv N={n} B={b} H={h} D={d} bf16"

    def plain_fwd():
        return fl.flash_fwd_reference(q, k, v, None, scale, False)

    def plain_bwd():
        return fl.flash_bwd_reference(q, k, v, None, out_v, lse, do, scale, False)

    want, want_lse = plain_fwd()
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], compare(
        f"K3f flash out {tag}", out_v, want, fwd_tol, fwd_rel))
    compare(f"K3f flash lse {tag}", lse, want_lse, LSE_TOL)
    del want, want_lse
    dqkv = x.grad.view(b, n, h, 3, d)
    for i, w in enumerate(plain_bwd()):
        err["flash_attention_bwd"] = max(err["flash_attention_bwd"], compare(
            f"K3b flash d{'qkv'[i]} written in place {tag}", dqkv[:, :, :, i].transpose(1, 2), w,
            bwd_tol, bwd_rel))
    del x, dqkv
    torch.cuda.empty_cache()

    # the same input twice: the same bits (no atomics in either pass)
    runs = []
    for _ in range(2):
        o, l = fl._flash_fwd_cuda(q, k, v, None, scale, False)
        grads = torch.empty(b, n, h, 3, d, dtype=qkv.dtype, device=device)
        fl._flash_bwd_cuda(q, k, v, None, o, l, do, scale, False,
                           grads=grads.permute(3, 0, 2, 1, 4).unbind(0))
        runs.append((o, l, grads))
    torch.cuda.synchronize()
    same = [torch.equal(a, z) for a, z in zip(*runs)]
    print(f"K3f and K3b twice on the same input ({tag}): out, lse and dqkv bit-equal: {same}")
    check(all(same), f"K3 is not reproducible: out, lse, dqkv equal {same}")
    del runs, o, l, grads

    # a thread that has made no CUDA call yet (as the autograd engine's, on a
    # first backward) launches both: the tensor maps need its context bound
    def fresh_thread(box: list) -> None:
        try:
            o, l = fl._flash_fwd_cuda(q, k, v, None, scale, False)
            fl._flash_bwd_cuda(q, k, v, None, o, l, do, scale, False)
            torch.cuda.synchronize()
            box.append("ok")
        except Exception as exc:  # reported by the check below
            box.append(repr(exc))

    box: list = []
    thread = threading.Thread(target=fresh_thread, args=(box,))
    thread.start()
    thread.join()
    print(f"K3f and K3b from a thread with no CUDA call before: {box[0]}")
    check(box == ["ok"], f"K3 from a new thread failed: {box}")
    torch.cuda.empty_cache()

    rows = {}
    views = torch.empty(b, n, h, 3, d, dtype=qkv.dtype, device=device)
    views = views.permute(3, 0, 2, 1, 4).unbind(0)
    lx = qkv.clone().requires_grad_()
    lq, lk, lv = fl.split_qkv(lx, h)
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    pairs = b * n * n
    rows["K3f image N=785 packed"] = (
        cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False)),
        cuda_ms(plain_fwd, iters=2, warmup=1),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        *bound(nbytes(q, k, v, out_v, lse), 4 * h * d * pairs, "bfloat16"),
    )
    rows["K3b image N=785 packed"] = (
        cuda_ms(lambda: fl._flash_bwd_cuda(q, k, v, None, out_v, lse, do, scale, False,
                                           grads=views)),
        cuda_ms(plain_bwd, iters=2, warmup=1),
        cuda_ms(lambda: torch.autograd.grad(lib_out, lx, do, retain_graph=True)),
        *bound(nbytes(q, k, v, out_v, do, lse, q, k, v), 10 * h * d * pairs, "bfloat16"),
    )
    for label, (ms, plain, lib, bnd, by) in rows.items():
        print(f"time {label} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it)")
    del qkv, dout, out, lse, views, lx, lq, lk, lv, lib_out
    torch.cuda.empty_cache()
    reset_counts()
    return rows


# ------------------------------------------------ the large presets' head dims

# K1 at batch 8, (N, H, D), where its code branches at the head dims of
# vit_huge (D=80, heads in groups of 8) and vit_giant (D=88, groups of 16):
# whole rows of up to 128 and 224 keys, two sweeps past 224, the backward's
# first kernel's 128, 224 and (D=80) 352 keys, and the longest that
# supports_fused admits (336 at D=80, 208 at D=88)
HEAD_DIM_K1_CASES = (
    (128, 8, 80), (129, 8, 80), (224, 8, 80), (225, 8, 80), (257, 8, 80), (336, 8, 80),
    (128, 16, 88), (129, 16, 88), (197, 16, 88), (208, 16, 88),
)
# K3 at batch 8: ViT-H/14's and ViT-g/14's 257 tokens and a ragged 1,000
HEAD_DIM_K3_LENGTHS = (257, 1000)
# the bf16 grids of phase 12: ViT-H/14's image attention on K1 (b128, N=257,
# 16 heads of 80), ViT-g/16's on K1 (N=197, 16 heads of 88), ViT-g/14's on
# K3 (b64, N=257, 16 heads of 88) and the same grid at D=80 on K3
LARGE_B, GIANT_B = 128, 64


def head_dim_kernel_checks(device, gen, err: dict) -> None:
    """K1 and K3 at head dims 80 and 88 against their plain versions at
    batch 8, through ``fused_mha`` / ``flash_attention`` and autograd, in
    bf16 and f32: K1 at ``HEAD_DIM_K1_CASES`` unmasked, causal and causal
    under a left-padded key mask (its forward and backward element-wise and
    as a whole, at K1's limits); K3 at ``HEAD_DIM_K3_LENGTHS`` over its four
    masks, causal or not (output, log-sum-exp, dQ, dK, dV, at K3's limits).
    The largest errors join ``err`` under ``<kernel>_d<D>``."""
    import torch

    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops import fused_attention as fa

    b = 8
    # supports_fused's limits at these head dims, the JAX package's
    for h, d, n, admits in ((8, 80, 336, True), (8, 80, 337, False), (16, 88, 208, True),
                            (16, 88, 209, False)):
        check(fa.supports_fused(h, d, n) == admits,
              f"supports_fused(H={h}, D={d}, N={n}) is not {admits}")
    for d in (80, 88):
        for key in ("fused_mha_fwd", "fused_mha_bwd", "flash_attention_fwd",
                    "flash_attention_bwd"):
            err.setdefault(f"{key}_d{d}", 0.0)
    for n, h, d in HEAD_DIM_K1_CASES:
        check(fa.supports_fused(h, d, n), f"supports_fused refuses N={n} H={h} D={d}")
        left = torch.arange(n, device=device)[None].expand(b, n) >= (n // 3)
        for label, m, causal in (("", None, False), ("causal ", None, True),
                                 ("causal+left-pad mask ", left.clone(), True)):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(b, n, 3 * h * d, generator=gen, device=device).to(dtype)
                dout = torch.randn(b, n, h * d, generator=gen, device=device).to(dtype)
                x.requires_grad_()
                out = fa.fused_mha(x, m, num_heads=h, causal=causal)
                (dqkv,) = torch.autograd.grad(out, x, dout)
                x = x.detach()
                torch.cuda.synchronize()
                part = {"fused_mha_fwd": 0.0, "fused_mha_bwd": 0.0}
                k1_check(f"{label}B={b} N={n} H={h} D={d} {_dtype_name(dtype)}", x, m, h,
                         causal, out.detach(), dqkv, dout, part)
                for key, value in part.items():
                    err[f"{key}_d{d}"] = max(err[f"{key}_d{d}"], value)
    h = 4
    for n in HEAD_DIM_K3_LENGTHS:
        for d in (80, 88):
            for kind in ("no mask", "right pad", "left pad", "empty sample"):
                mask = _flash_mask(kind, b, n, device)
                for causal in (False, True):
                    for dtype in (torch.bfloat16, torch.float32):
                        dn, scale = _dtype_name(dtype), d ** -0.5
                        q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device=device)
                                       .to(dtype) for _ in range(4))
                        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                        out = fl.flash_attention(*leaves, mask, causal=causal)
                        grads = torch.autograd.grad(out, leaves, do)
                        _, lse = fl._flash_fwd_cuda(q, k, v, mask, scale, causal)
                        torch.cuda.synchronize()
                        want, want_lse = fl.flash_fwd_reference(q, k, v, mask, scale, causal)
                        want_b = fl.flash_bwd_reference(q, k, v, mask, out.detach(), lse, do,
                                                        scale, causal)
                        tag = (f"{kind}{' causal' if causal else ''} B={b} N={n} H={h} D={d} "
                               f"{dn}")
                        err[f"flash_attention_fwd_d{d}"] = max(
                            err[f"flash_attention_fwd_d{d}"],
                            compare(f"K3f flash out {tag}", out, want,
                                    tol("flash_attention_fwd", dn),
                                    FLASH_REL_TOL["flash_attention_fwd"][dn]))
                        compare(f"K3f flash lse {tag}", lse, want_lse, LSE_TOL)
                        if kind == "empty sample":
                            mean = v[1].float().mean(dim=1, keepdim=True).expand(h, n, d)
                            compare(f"K3f flash out of the masked sample {tag}", out[1], mean,
                                    MASKED_ROW_TOL)
                        err[f"flash_attention_bwd_d{d}"] = max(
                            err[f"flash_attention_bwd_d{d}"], *(
                                compare(f"K3b flash d{name} {tag}", got, w,
                                        tol("flash_attention_bwd", dn),
                                        FLASH_REL_TOL["flash_attention_bwd"][dn])
                                for name, got, w in zip("qkv", grads, want_b)))
                        del q, k, v, do, leaves, out, grads, want, want_b
    torch.cuda.empty_cache()
    reset_counts()


def _sdpa_views(qkv, h: int):
    """q, k, v ``(B, H, N, D)`` contiguous copies of a packed projection, as
    leaves: the library call's own layout."""
    b, n, three_c = qkv.shape
    d = three_c // (3 * h)
    return tuple(t.contiguous().requires_grad_() for t in
                 qkv.view(b, n, h, 3, d).permute(3, 0, 2, 1, 4).unbind(0))


def head_dim_grids(device, gen, err: dict) -> dict:
    """K1 and K3 in bf16 at the large presets' grids (phase 12's): K1 at
    ViT-H/14's (B=128, N=257, 16 heads of 80) and at ViT-g/16's (B=64,
    N=197, 16 heads of 88); K3 on the packed projection at ViT-g/14's (B=64,
    N=257, 16 heads of 88) and at the same grid with 16 heads of 80. Each
    forward and backward against its plain version (element-wise and as a
    whole), then timed beside the plain version, SDPA (a yardstick the port
    never calls; its backward through autograd) and its bound. Returns rows
    as :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops import fused_attention as fa

    rows = {}
    for label, b, n, h, d in ((f"ViT-H/14 B={LARGE_B} N=257 H=16 D=80", LARGE_B, 257, 16, 80),
                              (f"ViT-g/16 B={GIANT_B} N=197 H=16 D=88", GIANT_B, 197, 16, 88)):
        scale = d ** -0.5
        qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device).bfloat16()
        dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
        out = fa._fused_mha_cuda(qkv, None, h, scale, False)
        dqkv = fa._fused_mha_bwd_cuda(qkv, None, out, dout, h, scale, False)
        torch.cuda.synchronize()
        part = {"fused_mha_fwd": 0.0, "fused_mha_bwd": 0.0}
        k1_check(f"{label} bf16", qkv, None, h, False, out, dqkv, dout, part)
        for key, value in part.items():
            err[f"{key}_d{d}"] = max(err[f"{key}_d{d}"], value)
        del dqkv
        q, k, v = _sdpa_views(qkv, h)
        lib_out = F.scaled_dot_product_attention(q, k, v)
        lib_dout = dout.view(b, n, h, d).transpose(1, 2).contiguous()
        pairs = b * n * n
        rows[f"K1f {label}"] = (
            cuda_ms(lambda: fa.fused_mha(qkv, None, num_heads=h)),
            cuda_ms(lambda: fa.mha_reference(qkv, None, h, scale, False), iters=5),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            *bound(nbytes(qkv, out), 4 * h * d * pairs, "bfloat16"),
        )
        rows[f"K1b {label}"] = (
            cuda_ms(lambda: fa._fused_mha_bwd_cuda(qkv, None, out, dout, h, scale, False)),
            cuda_ms(lambda: fa.mha_bwd_reference(qkv, None, out, dout, h, scale, False),
                    iters=3, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), lib_dout,
                                                retain_graph=True)),
            *bound(nbytes(qkv, out, dout, qkv), 10 * h * d * pairs, "bfloat16"),
        )
        del qkv, dout, out, q, k, v, lib_out, lib_dout
        torch.cuda.empty_cache()
    for d in (88, 80):
        b, n, h = GIANT_B, 257, 16
        label = f"ViT-g/14 B={b} N=257 H=16 D={d} packed"
        scale = d ** -0.5
        qkv = torch.randn(b, n, h * 3 * d, generator=gen, device=device).bfloat16()
        dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
        x = qkv.clone().requires_grad_()
        reset_counts()
        out = fl.flash_attention_qkv(x, num_heads=h)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts["flash_fwd"] == counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1,
              f"flash_attention_qkv launched {counts}")
        q, k, v = fl.split_qkv(qkv, h)
        do = dout.view(b, n, h, d).transpose(1, 2)
        out_v = out.detach().view(b, n, h, d).transpose(1, 2)
        _, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False)

        def plain_fwd():
            return fl.flash_fwd_reference(q, k, v, None, scale, False)

        def plain_bwd():
            return fl.flash_bwd_reference(q, k, v, None, out_v, lse, do, scale, False)

        want, want_lse = plain_fwd()
        err[f"flash_attention_fwd_d{d}"] = max(err[f"flash_attention_fwd_d{d}"], compare(
            f"K3f flash out {label} bf16", out_v, want, tol("flash_attention_fwd",
                                                                "bfloat16"),
            FLASH_REL_TOL["flash_attention_fwd"]["bfloat16"]))
        compare(f"K3f flash lse {label} bf16", lse, want_lse, LSE_TOL)
        del want, want_lse
        dqkv = x.grad.view(b, n, h, 3, d)
        for i, w in enumerate(plain_bwd()):
            err[f"flash_attention_bwd_d{d}"] = max(err[f"flash_attention_bwd_d{d}"], compare(
                f"K3b flash d{'qkv'[i]} written in place {label} bf16",
                dqkv[:, :, :, i].transpose(1, 2), w, tol("flash_attention_bwd", "bfloat16"),
                FLASH_REL_TOL["flash_attention_bwd"]["bfloat16"]))
        del x, dqkv
        views = torch.empty(b, n, h, 3, d, dtype=qkv.dtype, device=device)
        views = views.permute(3, 0, 2, 1, 4).unbind(0)
        lq, lk, lv = _sdpa_views(qkv, h)
        lib_out = F.scaled_dot_product_attention(lq, lk, lv)
        pairs = b * n * n
        rows[f"K3f {label}"] = (
            cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False)),
            cuda_ms(plain_fwd, iters=3, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv)),
            *bound(nbytes(q, k, v, out_v, lse), 4 * h * d * pairs, "bfloat16"),
        )
        rows[f"K3b {label}"] = (
            cuda_ms(lambda: fl._flash_bwd_cuda(q, k, v, None, out_v, lse, do, scale, False,
                                               grads=views)),
            cuda_ms(plain_bwd, iters=3, warmup=1),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do, retain_graph=True)),
            *bound(nbytes(q, k, v, out_v, do, lse, q, k, v), 10 * h * d * pairs, "bfloat16"),
        )
        del qkv, dout, out, lse, views, lq, lk, lv, lib_out, q, k, v, do, out_v
        torch.cuda.empty_cache()
    print_times(rows)
    reset_counts()
    return rows


# --------------------------------------------------------------- main path


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(port: int, path: str, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _start(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def write_index(task, device, index_dir: str):
    """Embed N_IMAGES synthetic images (standard-normal pixels drawn on the
    card from SEED) in batches of BATCH into ``.npz`` shards of SHARD_ROWS
    rows plus a manifest, through the port's ``EmbeddingExport`` (driven as
    the trainer's evaluation loop drives it; example ids in drawing
    order)."""
    import torch

    from mmlearn_tpu_torch.tasks import EmbeddingExport, EvalRuntime

    export = EmbeddingExport(index_dir, modalities=["rgb"], shard_size=SHARD_ROWS)
    runtime = EvalRuntime(task, device)
    export.on_evaluation_epoch_start(runtime)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    for batch_idx in range(N_IMAGES // BATCH):
        imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
        export.evaluation_step(runtime, {"rgb": imgs}, batch_idx)
    rows = export.on_evaluation_epoch_end(runtime)["export/rgb_rows"]
    check(rows == N_IMAGES, f"the index export wrote {rows} rows, want {N_IMAGES}")


def indexed_images(device, ids):
    """Redraw indexed images ``ids`` exactly as :func:`write_index` drew them
    (a numpy array, one image per id)."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    want = sorted(set(ids))
    out = {}
    for batch_start in range(0, max(want) + 1, BATCH):
        imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
        for i in want:
            if batch_start <= i < batch_start + BATCH:
                out[i] = imgs[i - batch_start].cpu().numpy()
    return np.stack([out[i] for i in ids])


def main_path(device) -> dict:
    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import flagship_task, ragged_text_batch
    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.serving import load_encoder, save_encoder
    from mmlearn_tpu_torch.serving.server import ServingState, serve

    def counts():
        return fa.LAUNCHES["fused_mha_fwd"], fn.LAUNCHES["layernorm_fwd"]

    t0 = time.perf_counter()
    task = flagship_task(device, seed=SEED)
    print(f"flagship built on {device} in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in task.parameters()) / 1e6:.1f} M params)")
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    imgs = torch.randn(BATCH, 224, 224, 3, generator=gen, device=device)
    text_batch = ragged_text_batch(BATCH, gen, device)

    # one tower forward = depth launches of K1 and 2 * depth of K2
    for modality, batch in (("rgb", {"rgb": imgs[:4]}),
                            ("text", {k: v[:4] for k, v in text_batch.items()})):
        depth = len(task.encoders[modality].blocks)
        reset_counts()
        with torch.inference_mode():
            task.encode(batch, modality, normalize=True)
        torch.cuda.synchronize()
        print(f"launches in one {modality} forward: K1 {counts()[0]}, "
              f"K2 {counts()[1]} (depth {depth})")
        check(counts() == (depth, 2 * depth),
              f"{modality} forward launched {counts()}, want ({depth}, {2 * depth})")

    # encode throughput at batch 256 (inputs already on the card)
    for modality, batch, unit in (("rgb", {"rgb": imgs}, "images"),
                                  ("text", text_batch, "texts")):
        with torch.inference_mode():
            ms = cuda_ms(lambda: task.encode(batch, modality, normalize=True),
                         iters=10, warmup=2)
        print(f"encode {modality} b{BATCH}: {ms:.2f} ms/batch = "
              f"{BATCH / ms * 1e3:.1f} {unit}/s")

    # ---- the main path: artifacts, index, two servers, requests
    reset_counts()
    rgb_art = os.path.join(WORK_DIR, "artifact_rgb")
    text_art = os.path.join(WORK_DIR, "artifact_text")
    index_dir = os.path.join(WORK_DIR, "index")
    example = {k: v[:2].cpu().numpy() for k, v in text_batch.items()}
    save_encoder(rgb_art, task, "rgb", {"rgb": imgs[:2].cpu().numpy()})
    save_encoder(text_art, task, "text", example)
    t0 = time.perf_counter()
    write_index(task, device, index_dir)
    torch.cuda.synchronize()
    print(f"indexed {N_IMAGES} images in {time.perf_counter() - t0:.1f} s")

    rgb_server = serve(rgb_art, port=0, index_dir=index_dir, device=device)
    text_server = serve(text_art, port=0, index_dir=index_dir, index_modality="rgb",
                        device=device)
    threads = [_start(rgb_server), _start(text_server)]
    results: dict = {}
    try:
        rport = rgb_server.server_address[1]
        tport = text_server.server_address[1]
        for port, modality in ((rport, "rgb"), (tport, "text")):
            status, health = _get(port, "/healthz")
            check(status == 200 and health["status"] == "ok"
                  and health["modality"] == modality and health["index_rows"] == N_IMAGES,
                  f"/healthz {modality}: {status} {health}")

        query_ids = [0, 1, 4095, N_IMAGES - 1]
        q_imgs = indexed_images(device, query_ids)
        status, out = _post(rport, "/embed", {"inputs": {"rgb": q_imgs.tolist()}})
        check(status == 200, f"/embed rgb: {status} {out}")
        rgb_emb = np.asarray(out["embeddings"], np.float32)
        status, out = _post(rport, "/search",
                            {"inputs": {"rgb": q_imgs.tolist()}, "k": SEARCH_K})
        check(status == 200, f"/search rgb: {status} {out}")
        top = np.asarray(out["example_index"])
        scores = np.asarray(out["scores"])
        check(top.shape == (4, SEARCH_K) and top[:, 0].tolist() == query_ids,
              f"/search rgb rank-1 ids {top[:, 0].tolist()}, want {query_ids}")
        check(np.all(np.abs(scores[:, 0] - 1) <= SELF_SCORE_ATOL),
              f"/search rgb self scores {scores[:, 0]}")

        texts = {k: v[:4].cpu().numpy().tolist() for k, v in text_batch.items()}
        status, out = _post(tport, "/embed", {"inputs": texts})
        check(status == 200, f"/embed text: {status} {out}")
        text_emb = np.asarray(out["embeddings"], np.float32)
        status, out = _post(tport, "/search", {"inputs": texts, "k": SEARCH_K})
        check(status == 200, f"/search text: {status} {out}")
        t_top = np.asarray(out["example_index"])
        t_scores = np.asarray(out["scores"])
        check(t_top.shape == (4, SEARCH_K) and t_top.min() >= 0
              and t_top.max() < N_IMAGES, f"/search text ids {t_top}")
        check(bool(np.all(np.diff(t_scores, axis=1) <= 0)), "text scores not sorted")
        status, out = _post(tport, "/embed", {"inputs": {"text": texts["text"]}})
        check(status == 400, f"/embed without the mask key answered {status}")

        # b=1 /search latency over HTTP, every query an indexed image
        lat_ids = [int(i) for i in np.linspace(0, N_IMAGES - 1, LATENCY_QUERIES)]
        lat_imgs = indexed_images(device, lat_ids)
        lat = []
        for i, img in zip(lat_ids, lat_imgs):
            body = {"inputs": {"rgb": img[None].tolist()}, "k": SEARCH_K}
            t0 = time.perf_counter()
            status, out = _post(rport, "/search", body)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and out["example_index"][0][0] == i
                  and abs(out["scores"][0][0] - 1) <= SELF_SCORE_ATOL,
                  f"/search b=1 image {i}: {status} {out}")
        results["http_p50_ms"] = statistics.median(lat)
        results["http_max_ms"] = max(lat)
    finally:
        for server in (rgb_server, text_server):
            server.shutdown()
            server.server_close()
        for t in threads:
            t.join(timeout=30)
    results["launches"] = counts()
    print(f"serving path launches: K1f {counts()[0]}, K2f {counts()[1]}")
    check(all(c > 0 for c in counts()), f"a kernel never launched: {counts()}")
    print(f"/search b=1 over HTTP: p50 {results['http_p50_ms']:.2f} ms, max "
          f"{results['http_max_ms']:.2f} ms ({LATENCY_QUERIES} requests, "
          f"{SEARCH_K}-NN over {N_IMAGES} images; JSON of 224x224x3 pixels)")

    # the same b=1 search in process: encode + index query, no HTTP/JSON
    state = ServingState(rgb_art, index_dir, device=device)
    lat = []
    for img in lat_imgs:
        t0 = time.perf_counter()
        state.search({"rgb": img[None]}, k=SEARCH_K)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"/search b=1 in process (encode + query): p50 "
          f"{statistics.median(lat[2:]):.2f} ms over {len(lat) - 2} queries")

    # outputs: finite, unit norm, and equal to the plain-version forward
    for modality, emb in (("rgb", rgb_emb), ("text", text_emb)):
        norms = np.linalg.norm(emb, axis=1)
        check(bool(np.isfinite(emb).all()) and emb.shape == (4, 512),
              f"{modality} embeddings {emb.shape} not finite")
        check(bool(np.all(np.abs(norms - 1) <= SELF_SCORE_ATOL)),
              f"{modality} embedding norms {norms}")
    plain = {
        "rgb": load_encoder(rgb_art, device="cpu")({"rgb": q_imgs}),
        "text": load_encoder(text_art, device="cpu")(
            {k: np.asarray(v, np.int32) for k, v in texts.items()}),
    }
    for modality, emb in (("rgb", rgb_emb), ("text", text_emb)):
        ref = plain[modality].float().numpy()
        cos = (emb * ref).sum(1) / np.linalg.norm(emb, axis=1) / np.linalg.norm(ref, axis=1)
        print(f"served {modality} embeddings vs plain-version forward on CPU: "
              f"min cosine {cos.min():.6f} (bound {MIN_COSINE})")
        check(bool(cos.min() >= MIN_COSINE), f"{modality} cosine {cos}")
    return results


# ------------------------------------------------------------ training path


class TimedBatches:
    """Yields ``batch`` without end. As a callback of the trainer, after
    the steps numbered in ``marks`` it waits for the card and notes the
    host clock, so the gaps between marks time whole training steps (the
    feeder's producer thread draws batches ahead of the steps, so the clock
    is read on the trainer's side). ``after_first``, where given, is called
    after the first step: its gradients are still in place then."""

    def __init__(self, batch, marks, after_first=None) -> None:
        self.batch, self.marks, self.times = batch, set(marks), []
        self.after_first = after_first

    def __iter__(self):
        while True:
            yield self.batch

    def on_train_start(self, trainer) -> None: ...

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        if step == 1 and self.after_first is not None:
            self.after_first()
        if step in self.marks:
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None: ...

    def on_train_end(self, trainer) -> None: ...


def _cosine(a, b) -> float:
    na, nb = float(a.norm()), float(b.norm())
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float((a * b).sum()) / (na * nb)


def step_parity(device, label: str, loss_rtol: float, min_cos: float, highres: bool = False):
    """One step of the flagship contrastive task (with ``highres``, its
    448-px variant) at batch 8 with the kernels on the card against the same
    weights and batch through the plain versions on the CPU: the loss and
    the cosine of every gradient tensor. Returns the card's task (its
    weights still the seed's)."""
    import torch

    from mmlearn_tpu_torch.flagship import (
        flagship_training_task,
        highres_batch,
        highres_training_task,
        synthetic_batch,
    )

    make_batch = highres_batch if highres else synthetic_batch
    make_task = highres_training_task if highres else flagship_training_task
    batch = make_batch(PARITY_BATCH, torch.Generator().manual_seed(SEED + 3), "cpu")
    losses, grads = {}, {}
    t0 = time.perf_counter()
    master = make_task("cpu", seed=SEED)
    print(f"{label}task built on the CPU in {time.perf_counter() - t0:.1f} s")
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        task = copy.deepcopy(master).to(dev) if where == "card" else master
        loss, _ = task.loss_fn({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()}
        if where == "card":
            card_task = task
        print(f"{label}training step b={PARITY_BATCH} on the {where}: loss "
              f"{losses[where]:.6f} ({time.perf_counter() - t0:.1f} s)")
    del task, master
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    print(f"{label}step parity b={PARITY_BATCH}, card vs CPU: loss rel diff {rel:.3e} "
          f"(tol {loss_rtol}); gradient cosine min {cos[worst]:.6f} at {worst}, "
          f"median {statistics.median(cos.values()):.6f} over {len(cos)} tensors "
          f"(bound {min_cos})")
    check(rel <= loss_rtol, f"{label}training loss on the card {losses['card']} vs CPU "
          f"{losses['cpu']}")
    check(cos[worst] >= min_cos, f"{label}gradient of {worst}: cosine {cos[worst]}")
    return card_task


def _bad_grads(named) -> tuple[list, list]:
    """Names of the tensors whose gradient is missing or not finite, and of
    those whose gradient is exactly zero."""
    bad, zero = [], []
    for n, p in named:
        if p.grad is None or not bool(p.grad.isfinite().all()):
            bad.append(n)
        elif not bool(p.grad.any()):
            zero.append(n)
    return bad, zero


def fit_flagship(task, device, label: str, want: dict, highres: bool = False,
                 first_step_grads: bool = False) -> tuple[dict, float]:
    """``Trainer.fit`` of the flagship task at batch 256 on the synthetic
    batch (with ``highres``, of its 448-px variant at batch 64 on
    ``highres_batch``), with every launch count set to 0 first: 3 warm-up
    steps, 3 timed windows of 10 steps (5 with ``highres``) and one more
    step. Checks the launches per step against ``want`` exactly, a finite,
    nonzero gradient for every parameter and a last loss below the first;
    returns the counts and the first loss.

    With ``first_step_grads`` (the ``int8_sb`` fit) the gradients are held
    nonzero at the first step, where a kernel that cuts the autograd graph
    shows, and only finite at the last: a fit on one synthetic batch may
    collapse to chance by then (loss ln 256, gradient norm near 0), and the
    int8 dgrad's 1e-6 absmax floor then rounds the deepest image blocks'
    gradients to exactly zero; their names are printed."""
    import math

    import torch

    from mmlearn_tpu_torch.flagship import highres_batch, synthetic_batch
    from mmlearn_tpu_torch.trainer import Trainer

    size, window_steps = (HIGHRES_BATCH, IJEPA_WINDOW_STEPS) if highres else (BATCH, WINDOW_STEPS)
    batch = (highres_batch if highres else synthetic_batch)(
        size, torch.Generator(device=device).manual_seed(SEED + 4), device)
    marks = [WARMUP_STEPS + i * window_steps for i in range(WINDOWS + 1)]
    steps = marks[-1] + 1  # the last mark is taken before the last step
    first = {}

    def note_first_grads():  # a warm-up step: its reads of the card are not timed
        first["bad"], first["zero"] = _bad_grads(task.named_parameters())

    loader = TimedBatches(batch, marks, note_first_grads if first_step_grads else None)
    trainer = Trainer(max_steps=steps, log_every_n_steps=steps, callbacks=[loader], device=device)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    state = trainer.fit(task, loader)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"{label}training path: {state.step} steps launched " + ", ".join(
        f"{k} {v} ({v / state.step:g} a step, want {want[k]})" for k, v in counts.items()))
    check(counts == {k: v * state.step for k, v in want.items()},
          f"{label}training launches {counts}, want {want} a step")

    n_params = sum(1 for _ in task.parameters())
    bad, zero = _bad_grads(task.named_parameters())
    if first_step_grads:
        first_bad = first["bad"] + first["zero"]
        print(f"{label}gradients of the first step: {n_params - len(first_bad)} of {n_params} "
              f"tensors finite and nonzero")
        check(not first_bad, f"missing, non-finite or zero gradients at the first step: "
              f"{first_bad[:10]}")
        print(f"{label}gradients of the last step: {n_params - len(bad)} of {n_params} tensors "
              f"finite; exactly zero: {len(zero)} {zero}")
        check(not bad, f"missing or non-finite gradients at the last step: {bad[:10]}")
    else:
        bad += zero
        print(f"gradients of the last step: {n_params - len(bad)} of {n_params} tensors "
              f"finite and nonzero")
        check(not bad, f"missing, non-finite or zero gradients: {bad[:10]}")

    hist = trainer.history
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss step 0 {first:.6f}, step {len(hist) - 1} {last:.6f}; lr {hist[0]['lr']:.4e}"
          f" -> {hist[-1]['lr']:.4e}; logit scale {hist[-1]['logit_scale']:.4f}; "
          f"grad norm {hist[0]['grad_norm']:.4f} -> {hist[-1]['grad_norm']:.4f}")
    check(math.isfinite(last) and last < first, f"loss went {first} -> {last}")

    window_s = [b - a for a, b in zip(loader.times, loader.times[1:])]
    rates = [size * window_steps / w for w in window_s]
    median = statistics.median(rates)
    FIT_RATES[label] = median
    print(f"{label}train b{size}: {median:.1f} pairs/s median of {WINDOWS} windows of "
          f"{window_steps} steps (windows {', '.join(f'{r:.1f}' for r in rates)}; spread "
          f"{(max(rates) - min(rates)) / median:.2%}), "
          f"{statistics.median(window_s) / window_steps * 1e3:.2f} ms a step, "
          f"peak memory {peak_gb:.2f} GB")
    return counts, first


def flagship_launches(task, int8_qmm: int) -> dict:
    """Launches a step of the flagship train step: per block K1 forward once
    and K1 backward's two kernels once each, K2 forward and backward twice,
    K5 ``int8_qmm`` times (on its TMA path: every projection shape)."""
    depth = sum(len(enc.blocks) for enc in task.encoders.values())
    return {"fused_mha_fwd": depth, "fused_mha_bwd": 2 * depth, "fused_mha_packed_fwd": 0,
            "fused_mha_packed_bwd": 0, "layernorm_fwd": 2 * depth, "layernorm_bwd": 2 * depth,
            "int8_qmm": int8_qmm * depth, "int8_qmm_bytes": 0, **NO_FLASH}


def training_path(device) -> tuple[dict, float]:
    """The flagship contrastive train step: parity with the CPU at batch 8,
    then ``Trainer.fit`` at batch 256 as the main path. Returns the launch
    counts and the first loss."""
    task = step_parity(device, "", LOSS_RTOL, MIN_GRAD_COSINE)
    return fit_flagship(task, device, "", flagship_launches(task, 0))


def ijepa_fit(master, device, packed: bool) -> tuple[dict, list]:
    """``Trainer.fit`` of a copy of the I-JEPA task at batch 256 on
    ``ijepa_batch``, with every launch count set to 0 first: 3 warm-up steps,
    WINDOWS timed windows of IJEPA_WINDOW_STEPS and one more step. Checks the
    launches per step exactly and the gradients, teacher and loss; returns
    the launch counts and the losses."""
    import math

    import torch

    from mmlearn_tpu_torch.flagship import ijepa_batch
    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.trainer import Trainer

    task = copy.deepcopy(master).to(device)
    batch = ijepa_batch(BATCH, torch.Generator(device=device).manual_seed(SEED + 6), device)
    marks = [WARMUP_STEPS + i * IJEPA_WINDOW_STEPS for i in range(WINDOWS + 1)]
    steps = marks[-1] + 1  # the last mark is taken before the last step
    loader = TimedBatches(batch, marks)
    trainer = Trainer(max_steps=steps, log_every_n_steps=steps, callbacks=[loader], device=device)
    teacher_before = [p.detach().clone() for p in task.teacher.parameters()]
    name = "K1f-p/K1b-p" if packed else "K1f/K1b"
    with packed_attention(packed):
        reset_counts()
        torch.cuda.reset_peak_memory_stats(device)
        state = trainer.fit(task, loader)
        torch.cuda.synchronize()
        counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    fwd = sum(len(m.blocks) for m in (task.teacher, task.encoder, task.predictor))
    bwd = len(task.encoder.blocks) + len(task.predictor.blocks)
    on = "fused_mha_packed" if packed else "fused_mha"
    # each backward is two kernels (p and ds, then the products)
    k1, k1p = (0, 1) if packed else (1, 0)
    want = {"fused_mha_fwd": k1 * fwd, "fused_mha_bwd": k1 * 2 * bwd,
            "fused_mha_packed_fwd": k1p * fwd, "fused_mha_packed_bwd": k1p * 2 * bwd,
            "layernorm_fwd": 2 * fwd, "layernorm_bwd": 2 * bwd, "int8_qmm": 0,
            "int8_qmm_bytes": 0, **NO_FLASH}
    print(f"I-JEPA path ({name}): {state.step} steps launched " + ", ".join(
        f"{k} {counts[k]} ({counts[k] / state.step:g} a step, want {v})"
        for k, v in want.items()))
    check(counts == {k: v * state.step for k, v in want.items()},
          f"I-JEPA launches {counts}, want {want} a step")
    check(fa.LAUNCHES[f"{on}_fwd"] > 0, f"{name} never launched")

    trained = [*task.encoder.named_parameters(), *task.predictor.named_parameters()]
    bad = [n for n, p in trained
           if p.grad is None or not bool(p.grad.isfinite().all()) or not bool(p.grad.any())]
    print(f"gradients of the last step: {len(trained) - len(bad)} of {len(trained)} student "
          f"and predictor tensors finite and nonzero")
    check(not bad, f"missing, non-finite or zero gradients: {bad[:10]}")
    moved = sum(not torch.equal(a, b) for a, b in zip(teacher_before, task.teacher.parameters()))
    finite = all(bool(p.isfinite().all()) for p in task.teacher.parameters())
    print(f"teacher: {moved} of {len(teacher_before)} tensors moved, all finite: {finite}")
    check(moved > 0 and finite, "the EMA teacher did not move or is not finite")
    losses = [h["loss"] for h in trainer.history]
    print(f"loss step 0 {losses[0]:.6f}, step {len(losses) - 1} {losses[-1]:.6f}")
    check(all(math.isfinite(x) for x in losses), f"I-JEPA losses {losses}")

    window_s = [b - a for a, b in zip(loader.times, loader.times[1:])]
    rates = [BATCH * IJEPA_WINDOW_STEPS / w for w in window_s]
    median = statistics.median(rates)
    print(f"I-JEPA train b{BATCH} ({name}): {median:.1f} images/s median of {WINDOWS} windows "
          f"of {IJEPA_WINDOW_STEPS} steps (windows {', '.join(f'{r:.1f}' for r in rates)}; "
          f"spread {(max(rates) - min(rates)) / median:.2%}), "
          f"{statistics.median(window_s) / IJEPA_WINDOW_STEPS * 1e3:.2f} ms a step, "
          f"peak memory {peak_gb:.2f} GB")
    del task, teacher_before, batch
    torch.cuda.empty_cache()
    return counts, losses


def ijepa_path(device) -> dict:
    """The I-JEPA train step: the host's mask time, parity with the CPU at
    batch 8, then ``Trainer.fit`` at batch 256 with K1 and with the
    head-grouped kernels. Returns the launch counts of both runs, added."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.datasets.processors import IJEPAMaskGenerator
    from mmlearn_tpu_torch.flagship import ijepa_training_task

    masks = IJEPAMaskGenerator()
    t0 = time.perf_counter()
    masks(BATCH, rng=np.random.default_rng((SEED, 0, 0)))
    print(f"host time of one b{BATCH} set of I-JEPA masks: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (the timed steps reuse one set)")

    t0 = time.perf_counter()
    master = ijepa_training_task("cpu", seed=SEED)
    n_trained = sum(p.numel() for p in master.parameters() if p.requires_grad)
    print(f"I-JEPA task built on the CPU in {time.perf_counter() - t0:.1f} s "
          f"({n_trained / 1e6:.1f} M trained params, teacher "
          f"{sum(p.numel() for p in master.teacher.parameters()) / 1e6:.1f} M)")

    # ---- one step at batch 8: kernels on the card, plain versions on the CPU
    images = torch.randn(PARITY_BATCH, 224, 224, 3,
                         generator=torch.Generator().manual_seed(SEED + 5)).bfloat16()
    batch = master.prepare_batch({"rgb": images}, step=0)
    tasks, losses, grads = {}, {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        task = tasks[where] = copy.deepcopy(master).to(dev)
        loss, _ = task.loss_fn(batch)
        loss.backward()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()
                        if p.requires_grad}
        print(f"I-JEPA step b={PARITY_BATCH} on the {where}: loss {losses[where]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    print(f"I-JEPA step parity b={PARITY_BATCH}, card vs CPU: loss rel diff {rel:.3e} "
          f"(tol {LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} at {worst}, median "
          f"{statistics.median(cos.values()):.6f} over {len(cos)} tensors "
          f"(bound {MIN_GRAD_COSINE})")
    check(rel <= LOSS_RTOL, f"I-JEPA loss on the card {losses['card']} vs CPU {losses['cpu']}")
    check(cos[worst] >= MIN_GRAD_COSINE, f"I-JEPA gradient of {worst}: cosine {cos[worst]}")
    # the teacher after one post_update, from the same student on both sides:
    # the CPU task's AdamW step, copied to the card
    opt, _ = tasks["cpu"].configure_optimizers()
    opt.step()
    tasks["card"].encoder.load_state_dict(tasks["cpu"].encoder.state_dict())
    teachers = {}
    for where, task in tasks.items():
        task.post_update(1000)
        teachers[where] = {n: p.float().cpu() for n, p in task.teacher.named_parameters()}
    t_rel = {n: float((teachers["card"][n] - t).norm() / t.norm().clamp_min(1e-30))
             for n, t in teachers["cpu"].items()}
    t_cos = {n: _cosine(teachers["card"][n], t) for n, t in teachers["cpu"].items()}
    print(f"teacher after one post_update, card vs CPU: relative diff max "
          f"{max(t_rel.values()):.3e} (tol {LOSS_RTOL}), cosine min {min(t_cos.values()):.6f}")
    check(max(t_rel.values()) <= LOSS_RTOL and min(t_cos.values()) >= MIN_GRAD_COSINE,
          "the teacher on the card differs from the CPU's after post_update")
    del tasks, task, grads, teachers, opt

    # ---- the main path: Trainer.fit at batch 256, K1 then the head-grouped kernels
    total = {}
    first = {}
    for packed in (False, True):
        counts, run_losses = ijepa_fit(master, device, packed)
        first[packed] = run_losses[0]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    rel = abs(first[True] - first[False]) / abs(first[False])
    print(f"I-JEPA first loss, K1 {first[False]:.6f} vs head-grouped {first[True]:.6f}: "
          f"rel diff {rel:.3e} (tol {LOSS_RTOL}; 0 where K1-p computes K1's bits)")
    check(rel <= LOSS_RTOL, "the two attention kernels give different I-JEPA losses")
    return total


def quant_path(device, bf16_first_loss: float) -> dict:
    """The flagship step under ``MMLEARN_QUANT``: parity with the CPU at
    batch 8 under each mode, then ``Trainer.fit`` at batch 256 under
    ``int8_sb`` as the main path (K5 for the forward and the dgrad of every
    block projection), then image ``encode`` at batch 256 under ``int8_sb``.
    Returns the launch counts of the ``int8_sb`` run."""
    import torch

    from mmlearn_tpu_torch.flagship import flagship_training_task
    from mmlearn_tpu_torch.ops import int8_matmul as im

    for mode in ("int8_sb", "int8_fwd", "int8"):
        with environ(QUANT_ENV, mode):
            step_parity(device, f"{mode} ", QUANT_LOSS_RTOL, QUANT_MIN_GRAD_COSINE)
    torch.cuda.empty_cache()

    with environ(QUANT_ENV, "int8_sb"):
        task = flagship_training_task(device, seed=SEED)
        counts, first = fit_flagship(task, device, "int8_sb ", flagship_launches(task, 8),
                                     first_step_grads=True)
        rel = abs(first - bf16_first_loss) / abs(bf16_first_loss)
        print(f"int8_sb first loss {first:.6f} vs bf16 {bf16_first_loss:.6f} from the same "
              f"weights and batch: rel diff {rel:.3e} (tol {QUANT_FIRST_LOSS_RTOL})")
        check(rel <= QUANT_FIRST_LOSS_RTOL, "the int8_sb step's first loss is off the bf16 one")

        task.eval()
        depth = len(task.encoders["rgb"].blocks)
        imgs = torch.randn(BATCH, 224, 224, 3, generator=torch.Generator(device=device)
                           .manual_seed(SEED + 7), device=device)
        with torch.inference_mode():
            before = im.LAUNCHES["int8_qmm"]
            emb = task.encode({"rgb": imgs}, "rgb", normalize=True)
            torch.cuda.synchronize()
            per_forward = im.LAUNCHES["int8_qmm"] - before
            ms = cuda_ms(lambda: task.encode({"rgb": imgs}, "rgb", normalize=True),
                         iters=10, warmup=2)
        print(f"int8_sb encode rgb b{BATCH}: {ms:.2f} ms/batch = {BATCH / ms * 1e3:.1f} "
              f"images/s; K5 {per_forward} launches a forward (want {4 * depth})")
        check(per_forward == 4 * depth, f"int8_sb encode launched K5 {per_forward} times")
        check(bool(emb.float().isfinite().all()) and emb.shape == (BATCH, 512),
              f"int8_sb embeddings {tuple(emb.shape)} not finite")
    del task, imgs, emb
    torch.cuda.empty_cache()
    return counts


def highres_path(device) -> dict:
    """The 448-px long-sequence path: with every count set to 0, image
    ``encode`` at batch 256 (launches checked exactly, a few embeddings
    against the plain versions on the CPU) and images/s; then one training
    step at batch 8 on the card against the CPU and ``Trainer.fit`` at batch
    64. Returns the launch counts of the two main-path runs, added."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import HIGHRES_IMAGE_SIZE, highres_task

    t0 = time.perf_counter()
    cpu_task = highres_task("cpu", seed=SEED)
    task = copy.deepcopy(cpu_task).to(device)
    rgb = task.encoders["rgb"]
    depth, tokens = len(rgb.blocks), rgb.pos_embed.shape[1]
    print(f"448-px towers built in {time.perf_counter() - t0:.1f} s: {tokens} image tokens, "
          f"position table interpolated from 197 rows")
    imgs = torch.randn(BATCH, HIGHRES_IMAGE_SIZE, HIGHRES_IMAGE_SIZE, 3,
                       generator=torch.Generator(device=device).manual_seed(SEED + 8),
                       device=device)
    reset_counts()
    with torch.inference_mode():
        emb = task.encode({"rgb": imgs}, "rgb", normalize=True)
    torch.cuda.synchronize()
    serving = launch_counts()
    want = {**{key: 0 for key in serving}, "flash_fwd": depth, "layernorm_fwd": 2 * depth}
    print(f"448 encode b{BATCH} launches: " + ", ".join(
        f"{key} {serving[key]} (want {want[key]})" for key in want if want[key] or serving[key]))
    check(serving == want, f"448 encode launched {serving}, want {want}")
    check(bool(emb.float().isfinite().all()) and emb.shape == (BATCH, 512),
          f"448 embeddings {tuple(emb.shape)} not finite")
    with torch.inference_mode():
        ms = cuda_ms(lambda: task.encode({"rgb": imgs}, "rgb", normalize=True), iters=5,
                     warmup=1)
    print(f"448 encode rgb b{BATCH}: {ms:.2f} ms/batch = {BATCH / ms * 1e3:.1f} images/s")
    with torch.inference_mode():
        ref = cpu_task.encode({"rgb": imgs[:2].cpu()}, "rgb", normalize=True).float().numpy()
    got = emb[:2].float().cpu().numpy()
    cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(ref, axis=1)
    print(f"448 embeddings on the card vs plain versions on the CPU: min cosine "
          f"{cos.min():.6f} (bound {MIN_COSINE})")
    check(bool(cos.min() >= MIN_COSINE), f"448 embedding cosine {cos}")
    del task, cpu_task, imgs, emb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    task = step_parity(device, "448 ", LOSS_RTOL, MIN_GRAD_COSINE, highres=True)
    want = {**flagship_launches(task, 0), "flash_fwd": depth, "flash_bwd_dkv": depth,
            "flash_bwd_dq": depth}
    text_depth = len(task.encoders["text"].blocks)  # K1 on the text tower only
    want["fused_mha_fwd"], want["fused_mha_bwd"] = text_depth, 2 * text_depth
    training, _ = fit_flagship(task, device, "448 ", want, highres=True)
    print(f"448 training path done in {time.perf_counter() - t0:.1f} s")
    del task
    torch.cuda.empty_cache()
    return {key: serving[key] + training[key] for key in serving}


class SyntheticPairs:
    """A loader of ``n`` distinct synthetic micro-batches a pass
    (:func:`~mmlearn_tpu_torch.flagship.synthetic_batch`), each drawn from
    ``(seed, epoch, index)`` by a generator on ``device``; ``set_epoch``
    picks the pass."""

    def __init__(self, n: int, batch_size: int, seed: int, device) -> None:
        self.n, self.batch_size, self.seed, self.device = n, batch_size, seed, device
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        import torch

        from mmlearn_tpu_torch.flagship import synthetic_batch

        for i in range(self.n):
            g = torch.Generator(device=self.device)
            g.manual_seed((self.seed * 1000 + self.epoch) * 1000 + i)
            yield synthetic_batch(self.batch_size, g, self.device)


class TrainerProbe:
    """A callback of phase 9: the host clock after a synchronize at the
    micro-steps in ``marks``, the validation losses, the first micro-step's
    gradient checked (``first_grads``), and SIGTERM to this process after
    micro-step ``stop_at``."""

    def __init__(self, marks=(), first_grads: bool = False, stop_at=None,
                 label: str = "trainer path") -> None:
        self.marks, self.first_grads, self.stop_at = set(marks), first_grads, stop_at
        self.label = label
        self.times: dict = {}
        self.val: dict = {}

    def on_train_start(self, trainer) -> None: ...

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        if step == 1 and self.first_grads:
            # at k > 1 the first micro-batch's gradient is the window's mean so far
            state = trainer.state
            grads = state.accumulated or [p.grad for p in state.params()]
            bad = [n for n, g in zip(state._names(), grads)
                   if g is None or not bool(g.isfinite().all()) or not bool(g.any())]
            print(f"{self.label}: gradients of the first micro-step: {len(grads) - len(bad)} "
                  f"of {len(grads)} trained tensors finite and nonzero")
            check(not bad, f"missing, non-finite or zero gradients at the first micro-step: "
                  f"{bad[:10]}")
        if step in self.marks:  # after the check: its reads are not timed
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
        if step == self.stop_at:
            os.kill(os.getpid(), signal.SIGTERM)

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None:
        self.val[step] = metrics["validation/loss"]

    def on_train_end(self, trainer) -> None: ...


def trainer_fit(master, device, ckpt_dir: str, probe, ckpt_path=None, logs=None):
    """``Trainer.fit`` of a copy of ``master`` as phase 9 runs it: 12
    micro-steps of 128 pairs, two a global batch, clipping by norm, a
    checkpoint (monitoring ``validation/loss``) and a validation of 2
    batches every 6, the LR monitor, the timer, ``log_mfu``. Returns the
    trainer, the task, the checkpoint callback and the steps ``post_update``
    was given."""
    from mmlearn_tpu_torch.trainer import (
        JSONLLogger,
        LearningRateMonitor,
        ModelCheckpoint,
        Timer,
        Trainer,
    )

    task = copy.deepcopy(master)
    calls = []
    post_update = task.post_update

    def counted(step):
        calls.append(step)
        post_update(step)

    task.post_update = counted
    ckpt = ModelCheckpoint(ckpt_dir, every_n_train_steps=TRAINER_EVERY, every_n_epochs=None,
                           monitor="validation/loss")
    trainer = Trainer(
        max_steps=TRAINER_STEPS, accumulate_grad_batches=TRAINER_ACCUMULATE,
        gradient_clip_val=TRAINER_CLIP, val_check_interval=TRAINER_EVERY,
        limit_val_batches=TRAINER_VAL_BATCHES, log_every_n_steps=TRAINER_EVERY,
        callbacks=[probe, LearningRateMonitor(), Timer(), ckpt],
        loggers=[] if logs is None else [JSONLLogger(logs)], log_mfu=True, device=device)
    loader = SyntheticPairs(TRAINER_PASS, TRAINER_MICRO_BATCH, SEED + 20, device)
    val = SyntheticPairs(TRAINER_VAL_BATCHES, TRAINER_MICRO_BATCH, SEED + 21, device)
    trainer.fit(task, loader, val, ckpt_path=ckpt_path)
    return trainer, task, ckpt, calls


def same_run(label: str, got_history, got_weights, want_history, want_weights) -> None:
    """Check a run's per-step records and final weights equal another's bit
    for bit; on a difference, name the first record and the tensors."""
    import torch

    diff_steps = [i for i, (a, b) in enumerate(zip(got_history, want_history)) if a != b]
    diff_weights = [n for n in want_weights if not torch.equal(got_weights[n], want_weights[n])]
    ok = len(got_history) == len(want_history) and not diff_steps and not diff_weights
    print(f"{label}: {len(got_history)} micro-steps' loss, grad_norm and lr and all "
          f"{len(want_weights)} weight tensors bit-equal to run A: {ok}")
    if not ok:
        if diff_steps:
            i = diff_steps[0]
            print(f"  first differing record {i}: {got_history[i]} vs {want_history[i]}")
        print(f"  {len(diff_weights)} weight tensors differ: {diff_weights[:20]}")
    check(ok, f"{label} is not bit-equal to run A")


def parity_fit(master, dev):
    """The fit of :func:`accumulation_parity` on ``dev`` from a copy of
    ``master``: ``(history, the gradients each update applied, each
    weight's update, the FLOPs counted a micro-step)``."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from mmlearn_tpu_torch.trainer import Trainer

    task = copy.deepcopy(master)
    # SGD at rate 1 and no schedule, not the task's AdamW and its
    # warmup: AdamW's first updates are about lr * sign(g) an element, so
    # an element whose gradient lies within bf16's rounding of zero moves
    # by the full rate either way (update cosine 0.967, the loss after
    # the first update 2.9e-3 apart); and at the warmup's 3e-4 a
    # LayerNorm gain near 1 moves by a few f32 ulps, so its update is
    # mostly rounding (SGD: cosine 0.942; PERF.md)
    task.optimizer_factory = functools.partial(torch.optim.SGD, lr=1.0)
    task.lr_scheduler_factory = None
    names = {p: n for n, p in task.named_parameters()}
    before = {n: p.detach().float().clone() for n, p in task.named_parameters()}
    applied = []

    def capture(optimizer, args, kwargs):
        applied.append({names[p]: p.grad.float().cpu() for g in optimizer.param_groups
                        for p in g["params"]})

    trainer = Trainer(max_steps=2 * TRAINER_ACCUMULATE,
                      accumulate_grad_batches=TRAINER_ACCUMULATE,
                      gradient_clip_val=TRAINER_CLIP, log_every_n_steps=1, log_mfu=True,
                      device=dev)
    handle = register_optimizer_step_pre_hook(capture)
    try:
        trainer.fit(task, SyntheticPairs(2 * TRAINER_ACCUMULATE, TRAINER_PARITY_MICRO,
                                         SEED + 22, "cpu"))
    finally:
        handle.remove()
    update = {n: p.detach().float().cpu() - before[n] for n, p in task.named_parameters()}
    return trainer.history, applied, update, trainer._step_flops


def accumulation_parity(master, device) -> float:
    """The trainer at k=2 on micro-batches of 8 for 2 SGD steps at rate 1
    (:func:`parity_fit`), with the kernels on the card and the plain
    versions on the CPU from the same weights and batches: each micro-step's
    loss, and the gradient each update applies and each weight's update as
    cosines; and the FLOPs the counter counts for a micro-step, which must
    be equal. Returns the counted FLOPs."""
    import torch

    runs = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        runs[where] = parity_fit(master, dev)
        print(f"trainer path: accumulation parity, {len(runs[where][0])} micro-steps of "
              f"{TRAINER_PARITY_MICRO} on the {where} in {time.perf_counter() - t0:.1f} s")
    hist, grads, update, flops = runs["card"]
    want_hist, want_grads, want_update, want_flops = runs["cpu"]

    def key_bias_out(n, t):
        # a key projection's bias has a zero gradient in exact arithmetic
        # (a softmax does not see a shift of a row's scores): its gradient
        # and AdamW update are rounding noise, so they are left out
        if n.endswith("attn.qkv.bias"):
            return t.view(-1, 3, 64)[:, [0, 2]].reshape(-1)
        return t

    rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist, want_hist)]
    rel = max(rels)
    print(f"trainer path: accumulation parity k={TRAINER_ACCUMULATE}, card vs CPU: loss rel "
          f"diff {', '.join(f'{r:.3e}' for r in rels)} over {len(hist)} micro-steps "
          f"(tol {ACCUM_LOSS_RTOL})")
    check(len(grads) == len(want_grads) == 2, f"{len(grads)} updates, want 2")
    for label, got, want in [*((f"applied gradient {i}", g, w)
                               for i, (g, w) in enumerate(zip(grads, want_grads))),
                             ("weight update", update, want_update)]:
        cos = {n: _cosine(key_bias_out(n, got[n]), key_bias_out(n, want[n])) for n in want}
        worst = min(cos, key=cos.get)
        print(f"trainer path: {label}, card vs CPU: cosine min {cos[worst]:.6f} at {worst}, "
              f"median {statistics.median(cos.values()):.6f} over {len(cos)} tensors "
              f"(bound {MIN_GRAD_COSINE}; key biases without their key part)")
        check(cos[worst] >= MIN_GRAD_COSINE, f"{label} of {worst}: cosine {cos[worst]}")
    print(f"trainer path: FLOPs a micro-step of {TRAINER_PARITY_MICRO} counted on the card "
          f"(kernels reporting) {flops:.6e}, on the CPU (plain versions) {want_flops:.6e}")
    check(flops == want_flops, "the FLOP counter counts the card's step otherwise than the CPU's")
    check(rel <= ACCUM_LOSS_RTOL, f"accumulated training loss on the card vs the CPU: {rel}")
    return flops


def trainer_path(device) -> dict:
    """Phase 9, the trainer path: runs A (twice, for determinism), B (the
    step-6 checkpoint resumed) and C (SIGTERM at micro-step 4, then
    resumed), checkpoint save and restore times, accumulation parity with
    the CPU; returns run A's launch counts."""
    import json as json_lib
    import math
    import shutil

    import torch

    from mmlearn_tpu_torch.flagship import flagship_training_task
    from mmlearn_tpu_torch.trainer import ModelCheckpoint
    from mmlearn_tpu_torch.trainer.callbacks import STATE_FILE
    from mmlearn_tpu_torch.trainer.flops import device_peak_tflops

    t0 = time.perf_counter()
    master = flagship_training_task("cpu", seed=SEED)
    print(f"trainer path: flagship task built on the CPU in {time.perf_counter() - t0:.1f} s")
    root = os.path.join(WORK_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    marks = (1, TRAINER_EVERY, TRAINER_EVERY + 1, TRAINER_STEPS)

    # run A, the main path of this phase
    t0 = time.perf_counter()
    probe = TrainerProbe(marks, first_grads=True)
    reset_counts()
    trainer, task, ckpt, calls = trainer_fit(master, device, os.path.join(root, "a"), probe,
                                             logs=os.path.join(root, "a_logs"))
    torch.cuda.synchronize()
    counts = launch_counts()
    depth = sum(len(enc.blocks) for enc in task.encoders.values())
    n_val = TRAINER_VAL_BATCHES * TRAINER_STEPS // TRAINER_EVERY  # validation forwards
    want = {k: v * TRAINER_STEPS for k, v in flagship_launches(task, 0).items()}
    want["fused_mha_fwd"] += depth * n_val
    want["layernorm_fwd"] += 2 * depth * n_val
    print(f"trainer path: {trainer.state.step} micro-steps and {n_val} validation forwards "
          "launched " + ", ".join(f"{k} {counts[k]} (want {want[k]})" for k in want))
    check(counts == want, f"trainer path launches {counts}, want {want}")
    state = trainer.state
    opt_steps = {int(s["step"]) for s in state.optimizer.state.values()}
    n_opt = TRAINER_STEPS // TRAINER_ACCUMULATE
    print(f"trainer path: {state.step} micro-steps, optimizer steps {opt_steps}, "
          f"schedule steps {state.lr_scheduler.last_epoch}, post_update calls {calls}")
    check(state.step == TRAINER_STEPS and opt_steps == {n_opt}
          and state.lr_scheduler.last_epoch == n_opt and calls == list(range(n_opt)),
          "trainer path: micro-steps, optimizer steps, schedule steps or post_update calls")
    ckpt_dir = os.path.join(root, "a")
    steps_on_disk = ckpt.all_steps()
    leftovers = [d for d in os.listdir(ckpt_dir) if ".tmp-" in d]
    print(f"trainer path: checkpoints {steps_on_disk} complete, temporary leftovers {leftovers}")
    check(steps_on_disk == [TRAINER_EVERY, TRAINER_STEPS] and not leftovers,
          "trainer path checkpoints")
    print(f"trainer path: validation losses {probe.val}")
    check(sorted(probe.val) == [TRAINER_EVERY, TRAINER_STEPS]
          and all(math.isfinite(v) for v in probe.val.values()), "trainer path validation")
    with open(os.path.join(root, "a_logs", "metrics.jsonl")) as f:
        lines = [json_lib.loads(line) for line in f]
    print(f"trainer path: {len(lines)} JSONL lines, steps {[line['step'] for line in lines]}")
    check(len(lines) == 4 and all(math.isfinite(line.get("train/loss", line.get(
        "validation/loss", math.nan))) for line in lines), "trainer path JSONL lines")
    history = trainer.history
    weights = {k: v.detach().cpu() for k, v in task.state_dict().items()}
    print(f"trainer path: run A done in {time.perf_counter() - t0:.1f} s")
    flops = trainer._step_flops
    windows = [(probe.times[TRAINER_EVERY] - probe.times[1]) / (TRAINER_EVERY - 1),
               (probe.times[TRAINER_STEPS] - probe.times[TRAINER_EVERY + 1])
               / (TRAINER_STEPS - TRAINER_EVERY - 1)]
    del trainer, task, ckpt
    torch.cuda.empty_cache()

    # run A again: the same bits
    t0 = time.perf_counter()
    probe = TrainerProbe(marks)
    trainer, task, _, _ = trainer_fit(master, device, os.path.join(root, "a2"), probe)
    same_run("run A again", trainer.history, {k: v.detach().cpu() for k, v in
                                              task.state_dict().items()}, history, weights)
    windows += [(probe.times[TRAINER_EVERY] - probe.times[1]) / (TRAINER_EVERY - 1),
                (probe.times[TRAINER_STEPS] - probe.times[TRAINER_EVERY + 1])
                / (TRAINER_STEPS - TRAINER_EVERY - 1)]

    print(f"trainer path: run A again done in {time.perf_counter() - t0:.1f} s")

    # checkpoint save and restore times, on run A again's final state
    size = os.path.getsize(os.path.join(ckpt_dir, str(TRAINER_EVERY), STATE_FILE))
    times = {}
    for kind, async_save in (("sync", False), ("async", True)):
        cb = ModelCheckpoint(os.path.join(root, f"save_{kind}"), every_n_train_steps=1,
                             every_n_epochs=None, async_save=async_save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb.on_train_batch_end(trainer, {}, trainer.state.step)
        t1 = time.perf_counter()
        cb.wait_until_finished()
        times[kind] = (t1 - t0, time.perf_counter() - t0)
    t0 = time.perf_counter()
    restored = ModelCheckpoint(os.path.join(root, "save_sync")).restore_latest(trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored == TRAINER_STEPS, f"restored step {restored}")
    del trainer, task
    torch.cuda.empty_cache()

    # run B: a fresh task resumed from run A's step-6 checkpoint
    t0 = time.perf_counter()
    b_dir = os.path.join(root, "b")
    os.makedirs(b_dir)
    shutil.copytree(os.path.join(ckpt_dir, str(TRAINER_EVERY)),
                    os.path.join(b_dir, str(TRAINER_EVERY)))
    shutil.copy(os.path.join(ckpt_dir, f"loop_position-{TRAINER_EVERY}.json"), b_dir)
    trainer, task, _, calls = trainer_fit(master, device, b_dir, TrainerProbe(), ckpt_path=b_dir)
    check(trainer.restored_step == TRAINER_EVERY, f"run B restored {trainer.restored_step}")
    same_run("run B (resumed at 6)", trainer.history,
             {k: v.detach().cpu() for k, v in task.state_dict().items()},
             history[TRAINER_EVERY:], weights)
    del trainer, task
    torch.cuda.empty_cache()

    print(f"trainer path: run B done in {time.perf_counter() - t0:.1f} s")

    # run C: SIGTERM after micro-step 4, the end checkpoint, then a resume
    t0 = time.perf_counter()
    c_dir = os.path.join(root, "c")
    trainer, task, ckpt, _ = trainer_fit(master, device, c_dir,
                                         TrainerProbe(stop_at=TRAINER_STOP_AT))
    first = trainer.history
    print(f"run C: stopped at micro-step {trainer.state.step} by SIGTERM, checkpoints "
          f"{ckpt.all_steps()}")
    check(trainer.state.step == TRAINER_STOP_AT and ckpt.all_steps() == [TRAINER_STOP_AT],
          "run C did not stop cleanly with its end checkpoint")
    del trainer, task, ckpt
    trainer, task, _, _ = trainer_fit(master, device, c_dir, TrainerProbe(), ckpt_path="last")
    same_run("run C (SIGTERM at 4, resumed)", first + trainer.history,
             {k: v.detach().cpu() for k, v in task.state_dict().items()}, history, weights)
    del trainer, task
    torch.cuda.empty_cache()
    print(f"trainer path: run C done in {time.perf_counter() - t0:.1f} s")

    parity_flops = accumulation_parity(master, device)
    del master

    ms = statistics.median(windows[0::2]) * 1e3
    TRAINER_MS["ms"] = ms
    global_batch = TRAINER_MICRO_BATCH * TRAINER_ACCUMULATE
    tflops = flops / (ms / 1e3) / 1e12
    peak = device_peak_tflops(device)
    print(f"trainer path b{TRAINER_MICRO_BATCH}x{TRAINER_ACCUMULATE}: "
          f"{ms:.2f} ms a micro-step (median of micro-steps 2-6 of runs A and A again: "
          f"{', '.join(f'{w * 1e3:.2f}' for w in windows[0::2])}; micro-steps 8-12, an async "
          f"checkpoint write in flight: {', '.join(f'{w * 1e3:.2f}' for w in windows[1::2])}), "
          f"{global_batch / (TRAINER_ACCUMULATE * ms / 1e3):.1f} pairs/s a global batch of "
          f"{global_batch}")
    print(f"trainer path: checkpoint {size} bytes; save sync {times['sync'][1]:.3f} s, async "
          f"{times['async'][0]:.3f} s to return and {times['async'][1]:.3f} s written; restore "
          f"{restore_s:.3f} s")
    print(f"trainer path: {flops:.6e} FLOPs a micro-step of {TRAINER_MICRO_BATCH} counted "
          f"(kernels included; {parity_flops:.6e} at {TRAINER_PARITY_MICRO}), "
          f"{tflops:.1f} TFLOP/s achieved, MFU "
          f"{'not in the table' if peak is None else f'{tflops / peak:.2%} of {peak:g}'}")
    print(f"trainer path: the flagship fit_flagship step (phase 5) in this run: "
          f"{FIT_RATES['']:.1f} pairs/s at b{BATCH}")
    return counts


class Uint8Pairs:
    """Phase 10's map-style source: ``BATCH * INPUT_PASS`` image-text
    pairs from ``seed``, as ``SyntheticImageText`` correlates them: class k
    of ``INPUT_CLASSES`` shows a uint8 NHWC image pattern k at 224 px,
    rolled along the width by the index (cheap on the host), and token
    pattern k ending in the end-of-text id. Fetches have no side effect
    (``all_map_style``), so a resumed epoch skips them; ``fetched`` lists
    the indices fetched."""

    all_map_style = True

    def __init__(self, seed: int) -> None:
        import numpy as np

        from mmlearn_tpu_torch.flagship import IMAGE_SIZE, TEXT_LENGTH, VOCAB_SIZE

        rng = np.random.default_rng(seed)
        self.size = BATCH * INPUT_PASS
        self.labels = rng.integers(0, INPUT_CLASSES, self.size)
        self.patterns = rng.integers(0, 256, (INPUT_CLASSES, IMAGE_SIZE, IMAGE_SIZE, 3),
                                     dtype=np.uint8)
        self.tokens = rng.integers(2, VOCAB_SIZE - 1, (INPUT_CLASSES, TEXT_LENGTH)).astype(
            np.int32)
        self.tokens[:, -1] = VOCAB_SIZE - 1  # end of text: the largest id, for EOS pooling
        self.fetched: list = []  # appended from the loader's threads (atomic)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        import numpy as np

        from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
        from mmlearn_tpu_torch.datasets.core import Example

        self.fetched.append(int(idx))
        k = self.labels[idx]
        return Example({"rgb": np.roll(self.patterns[k], int(idx) % 16, axis=1),
                        "text": self.tokens[k], EXAMPLE_INDEX_KEY: int(idx)})


class InputProbe(TrainerProbe):
    """Phase 9's probe, for phase 10: also the consumer's total wait on the
    feeder at the ``marks``, and the checks of ``integrity`` (step -> the
    tensors the step read, set by :func:`watch_inputs`) once their step has
    run, before the clock is read."""

    def __init__(self, marks=(), first_grads: bool = False, integrity=None) -> None:
        super().__init__(marks, first_grads, label="input path")
        self.integrity = integrity
        self.waits: dict = {}

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        if self.integrity is not None and step - 1 in self.integrity["device"]:
            self.integrity["check"](step - 1)
        super().on_train_batch_end(trainer, metrics, step)
        if step in self.marks:
            self.waits[step] = trainer.feeder_wait_s


def watch_inputs(task, trainer, host_steps: int = 0) -> dict:
    """Wrap ``task``'s hooks: ``prepare_batch`` (the feeder's thread) notes
    each training batch's example indices, and keeps the host images of the
    first ``host_steps`` steps; ``loss_fn`` copies, on the compute stream
    where the step reads them, the images and indices of those steps as the
    step sees them. Returns ``{"order": [...], "host": {...}, "device":
    {...}}``."""
    seen = {"order": [], "host": {}, "device": {}}
    prepare, loss_fn = task.prepare_batch, task.loss_fn

    def prepare_batch(batch, step, training=True):
        if training:
            seen["order"].append(batch["example_index"].tolist())
            if step < host_steps:
                seen["host"][step] = batch["rgb"]
        return prepare(batch, step, training)

    def watched_loss(batch):
        step = trainer.state.step
        if step < host_steps:
            seen["device"][step] = (batch["rgb"].clone(), batch["example_index"].clone())
        return loss_fn(batch)

    task.prepare_batch, task.loss_fn = prepare_batch, watched_loss
    return seen


def sampler_order(seed: int, size: int, epoch: int) -> list:
    """The indices ``RandomSampler(seed)`` gives an epoch, batch by batch."""
    from mmlearn_tpu_torch.datasets.core import RandomSampler

    sampler = RandomSampler(range(size), seed=seed)
    sampler.set_epoch(epoch)
    order = list(sampler)
    return [order[i:i + BATCH] for i in range(0, size - BATCH + 1, BATCH)]


def h2d_rates(device) -> None:
    """MB/s of one b256 uint8 batch to the card from pinned and from
    pageable host memory, 10 copies each after one warm-up."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import IMAGE_SIZE

    shape = (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    host = np.random.default_rng(SEED + 30).integers(0, 256, shape, dtype=np.uint8)
    pinned = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(torch.from_numpy(host))
    check(pinned.is_pinned(), "a pinned host buffer could not be allocated")
    dev = torch.empty(shape, dtype=torch.uint8, device=device)
    rates = {}
    for name, src in (("pinned", pinned), ("pageable", torch.from_numpy(host))):
        dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        rates[name] = 10 * host.nbytes / (time.perf_counter() - t0) / 1e6
    check(torch.equal(dev.cpu(), pinned), "the copied batch differs from the host's")
    print(f"input path: H2D of one b{BATCH} uint8 batch ({host.nbytes:,} B): pinned "
          f"{rates['pinned']:.1f} MB/s, pageable {rates['pageable']:.1f} MB/s")


def input_normalize() -> dict:
    """The trainer's ``device_normalize`` of phase 10: CLIP's statistics."""
    from mmlearn_tpu_torch.datasets.processors import CLIP_MEAN, CLIP_STD

    return {"rgb": {"mean": CLIP_MEAN, "std": CLIP_STD}}


def input_loader(dataset, workers: int = INPUT_WORKERS):
    """Phase 10's loader: b256, shuffled by ``RandomSampler(SEED)``, whole
    batches, ``workers`` fetch threads."""
    from mmlearn_tpu_torch.datasets.core import DataLoader

    return DataLoader(dataset, batch_size=BATCH, shuffle=True, seed=SEED, drop_last=True,
                      num_workers=workers)


def input_fit(master, device, loader, label: str, integrity: bool = False,
              ckpt_dir=None, reference=None) -> tuple[dict, float, object]:
    """``Trainer.fit`` of a copy of ``master`` at b256 over ``loader`` (its
    uint8 images normalized on the card), with every count set to 0
    first: 3 warm-up steps, 3 timed windows of 10, one more step. Checks
    the launches a step exactly, every gradient of the first step finite
    and nonzero and the loss finite and falling; with ``integrity``, also
    the images and example indices of the first ``INTEGRITY_STEPS`` steps
    as the step read them (the host's f32 normalization in bf16, bit for
    bit; the sampler's order) and every step's indices on the host side;
    with ``reference`` (example indices -> uint8 images, the host's own
    decode), the step's images are held to that instead of the batch the
    loader gave. Prints pairs/s, its ratio to phase 5's, ms a step, the step's wait on
    the feeder and peak memory; returns the launch counts, pairs/s and, with
    ``ckpt_dir``, the trained task, whose state a ``ModelCheckpoint`` there
    writes once the fit ends (after the timed windows), else None."""
    import math

    import numpy as np
    import torch

    from mmlearn_tpu_torch.datasets.processors import CLIP_MEAN, CLIP_STD, normalize_image
    from mmlearn_tpu_torch.trainer import Trainer

    marks = [WARMUP_STEPS + i * WINDOW_STEPS for i in range(WINDOWS + 1)]
    steps = marks[-1] + 1
    task = copy.deepcopy(master).to(device)
    trainer = Trainer(max_steps=steps, log_every_n_steps=steps, device=device,
                      device_normalize=input_normalize())
    seen = watch_inputs(task, trainer, host_steps=INTEGRITY_STEPS if integrity else 0)
    size = len(loader.dataset) if integrity else None

    def check_step(step):
        torch.cuda.synchronize()
        images, index = seen["device"].pop(step)
        x = seen["host"].pop(step)
        if reference is not None:
            x = reference(index.cpu().numpy())
        want = torch.from_numpy(normalize_image(x.astype(np.float32) / np.float32(255.0),
                                                CLIP_MEAN, CLIP_STD)).to(torch.bfloat16)
        got = images.cpu()
        differ = int((got != want).sum())
        source = "own decode" if reference else "batch"
        worst = float((got.float() - want.float()).abs().max())
        print(f"input path{label}: step {step}: the b{BATCH} images the step read equal the "
              f"host's {source} normalized in f32, cast to bf16, at {got.numel() - differ:,} of "
              f"{got.numel():,} elements (max abs diff {worst:.3e})")
        check(differ == 0, f"step {step}'s normalized images differ from the host's at "
              f"{differ} elements")
        check(index.cpu().tolist() == sampler_order(SEED, size, 0)[step],
              f"step {step}'s example indices are not the sampler's")

    probe = InputProbe(marks, first_grads=True,
                       integrity={"device": seen["device"], "check": check_step})
    trainer.callbacks.append(probe)
    if ckpt_dir is not None:
        from mmlearn_tpu_torch.trainer import ModelCheckpoint

        trainer.callbacks.append(ModelCheckpoint(ckpt_dir, every_n_epochs=None, save_last=True))
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    state = trainer.fit(task, loader)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = flagship_launches(task, 0)
    print(f"input path{label}: {state.step} steps launched " + ", ".join(
        f"{k} {v} ({v / state.step:g} a step, want {want[k]})" for k, v in counts.items()))
    check(counts == {k: v * state.step for k, v in want.items()},
          f"input path launches {counts}, want {want} a step")
    if integrity:
        check(not seen["device"], f"steps {sorted(seen['device'])} were not checked")
        passes = len(loader)
        orders = [sampler_order(SEED, size, e) for e in range(steps // passes + 1)]
        want_order = [orders[s // passes][s % passes] for s in range(steps)]
        print(f"input path: the {steps} batches' example indices in the sampler's order: "
              f"{seen['order'] == want_order}")
        check(seen["order"] == want_order, "the batches' example indices are not the sampler's")
    losses = [h["loss"] for h in trainer.history]
    tail = statistics.mean(losses[-3:])
    print(f"input path{label}: loss step 0 {losses[0]:.6f}, mean of the last 3 {tail:.6f} "
          f"(step {len(losses) - 1} {losses[-1]:.6f})")
    check(all(math.isfinite(x) for x in losses) and tail < losses[0],
          f"input path losses {losses[0]} -> {losses[-3:]}")
    window_s = [probe.times[b] - probe.times[a] for a, b in zip(marks, marks[1:])]
    waits = [probe.waits[b] - probe.waits[a] for a, b in zip(marks, marks[1:])]
    rates = [BATCH * WINDOW_STEPS / w for w in window_s]
    median = statistics.median(rates)
    print(f"input path{label} train b{BATCH} on uint8 host batches: {median:.1f} pairs/s median "
          f"of {WINDOWS} windows of {WINDOW_STEPS} steps (windows "
          f"{', '.join(f'{r:.1f}' for r in rates)}; spread {(max(rates) - min(rates)) / median:.2%}"
          f"), {statistics.median(window_s) / WINDOW_STEPS * 1e3:.2f} ms a step, "
          f"{median / FIT_RATES['']:.4f} x phase 5's {FIT_RATES['']:.1f} pairs/s; the step's "
          f"wait on the feeder {sum(waits) * 1e3:.2f} ms of {sum(window_s) * 1e3:.2f} ms timed "
          f"({sum(waits) / sum(window_s):.2%}; by window "
          f"{', '.join(f'{w * 1e3:.2f}' for w in waits)} ms; {trainer.feeder_wait_s:.3f} s over "
          f"the fit; a pass is {len(loader)} steps); peak memory {peak_gb:.2f} GB")
    del task.prepare_batch, task.loss_fn  # watch_inputs' wrappers off
    task.zero_grad(set_to_none=True)
    kept = task if ckpt_dir is not None else None
    del task, trainer, state, seen
    torch.cuda.empty_cache()
    return counts, median, kept


def input_path(device) -> dict:
    """Phase 10, the input-fed path: the flagship trained on host batches
    (``Uint8Pairs`` through ``RandomSampler``, ``DefaultDataCollator`` and
    the port's ``DataLoader``, the trainer's ``DeviceFeeder``, uint8 pixels
    normalized on the card). The H2D rates; ``Trainer.fit`` at b256 with
    every count set to 0 first (3 warm-up steps, 3 timed windows of 10, one
    more step): exact launches a step, the first step's gradients, the
    falling loss, and 3 batches read back as the step read them, equal to
    the host's normalization cast to bf16 bit for bit, in the sampler's
    order; a run resumed from step 6 of 12 bit-equal to the uninterrupted
    one, fetching no example of the skipped batches; then 10 steps on
    ``SyntheticImageText``'s f32 host batches for context. Returns the
    fit's launch counts, its trained task (for phase 11) and the directory
    of the checkpoint written at its end."""
    import math
    import shutil

    import torch

    from mmlearn_tpu_torch.datasets.builtin import SyntheticImageText
    from mmlearn_tpu_torch.flagship import flagship_training_task
    from mmlearn_tpu_torch.trainer import ModelCheckpoint, Trainer

    h2d_rates(device)
    t0 = time.perf_counter()
    master = flagship_training_task("cpu", seed=SEED)
    print(f"input path: flagship task built on the CPU in {time.perf_counter() - t0:.1f} s")
    data_seed = SEED + 31

    # the main path: Trainer.fit on uint8 host batches, its state saved at
    # the end for phase 11's eval-only job
    trained_dir = os.path.join(WORK_DIR, "input_trained")
    shutil.rmtree(trained_dir, ignore_errors=True)
    counts, _, trained = input_fit(master, device, input_loader(Uint8Pairs(data_seed)), "",
                                   integrity=True, ckpt_dir=trained_dir)

    # resume through the loader: run U, 12 steps with a checkpoint at 6; run
    # R, a fresh task resumed from it
    root = os.path.join(WORK_DIR, "input")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    half = INPUT_RESUME_STEPS // 2
    runs = {}
    for name in ("U", "R"):
        task = copy.deepcopy(master).to(device)
        trainer = Trainer(max_steps=INPUT_RESUME_STEPS, log_every_n_steps=INPUT_RESUME_STEPS,
                          device=device, device_normalize=input_normalize())
        if name == "U":
            trainer.callbacks.append(ModelCheckpoint(os.path.join(root, "u"),
                                                     every_n_train_steps=half,
                                                     every_n_epochs=None, save_last=False))
        else:
            shutil.copytree(os.path.join(root, "u", str(half)), os.path.join(root, "r", str(half)))
            shutil.copy(os.path.join(root, "u", f"loop_position-{half}.json"),
                        os.path.join(root, "r"))
        seen = watch_inputs(task, trainer)
        dataset = Uint8Pairs(data_seed)
        t0 = time.perf_counter()
        trainer.fit(task, input_loader(dataset),
                    ckpt_path=None if name == "U" else os.path.join(root, "r"))
        torch.cuda.synchronize()
        runs[name] = (trainer, task, seen["order"], dataset.fetched)
        print(f"input path: run {name}: {len(trainer.history)} steps in "
              f"{time.perf_counter() - t0:.1f} s, {len(dataset.fetched)} examples fetched")
    (tu, task_u, order_u, _), (tr, task_r, order_r, fetched_r) = runs["U"], runs["R"]
    check(tr.restored_step == half, f"run R restored step {tr.restored_step}, want {half}")
    weights_u = task_u.state_dict()
    diff = [n for n, v in task_r.state_dict().items() if not torch.equal(v, weights_u[n])]
    skipped = {i for batch in order_u[:half] for i in batch}
    fetched_skipped = len(skipped & set(fetched_r))
    ok = tr.history == tu.history[half:] and order_r == order_u[half:] and not diff
    print(f"input path: run R (resumed at {half}) bit-equal to run U's steps {half}-"
          f"{INPUT_RESUME_STEPS - 1} (records, example indices, all {len(weights_u)} weight "
          f"tensors): {ok}; {len(diff)} tensors differ; {fetched_skipped} of the {len(skipped)} "
          f"examples of the {half} skipped batches fetched")
    check(ok, "run R is not bit-equal to run U")
    check(fetched_skipped == 0, f"run R fetched {fetched_skipped} examples of skipped batches")
    del runs, tu, tr, task_u, task_r, weights_u
    torch.cuda.empty_cache()

    # context: f32 host batches of SyntheticImageText through the same path
    steps = INPUT_CONTEXT_STEPS + 1
    task = copy.deepcopy(master).to(device)
    del master
    probe = InputProbe(marks=(1, steps))
    trainer = Trainer(max_steps=steps, log_every_n_steps=steps, device=device, callbacks=[probe])
    t0 = time.perf_counter()
    synthetic = SyntheticImageText(size=BATCH * (steps + 2), seed=data_seed)
    built_s = time.perf_counter() - t0
    trainer.fit(task, input_loader(synthetic))
    window = probe.times[steps] - probe.times[1]
    wait = probe.waits[steps] - probe.waits[1]
    rate = BATCH * INPUT_CONTEXT_STEPS / window
    losses = [h["loss"] for h in trainer.history]
    check(all(math.isfinite(x) for x in losses), f"SyntheticImageText losses {losses}")
    print(f"input path, context: SyntheticImageText (f32 host images, "
          f"{BATCH * 224 * 224 * 3 * 4:,} B a batch; dataset built in {built_s:.1f} s): "
          f"{rate:.1f} pairs/s over {INPUT_CONTEXT_STEPS} steps after one, "
          f"{window / INPUT_CONTEXT_STEPS * 1e3:.2f} ms a step, {rate / FIT_RATES['']:.4f} x "
          f"phase 5; the step's wait on the feeder {wait * 1e3:.2f} ms ({wait / window:.2%})")
    del task, trainer
    torch.cuda.empty_cache()
    return counts, trained, trained_dir


# ------------------------------------------------------------ the eval path


class EvalPairs:
    """Phase 11's held-out pairs: ``size`` pairs of the classes ``classes``
    of phase 10's ``source`` (its image and token patterns, so the classes
    are the ones trained on), labels drawn from ``seed`` and each image
    rolled along the width by an offset drawn from ``seed``, distinct within
    a class (no two images alike). ``rgb_target`` is the label's position in
    ``classes``; ``id2label`` and the prompt templates are the zero-shot
    classifier's."""

    all_map_style = True

    def __init__(self, source, classes, size: int, seed: int, templates) -> None:
        import numpy as np

        from mmlearn_tpu_torch.flagship import IMAGE_SIZE

        rng = np.random.default_rng(seed)
        self.patterns, self.tokens, self.classes = source.patterns, source.tokens, list(classes)
        self.labels = rng.integers(0, len(self.classes), size)
        self.rolls = np.zeros(size, np.int64)
        for c in range(len(self.classes)):
            rows = np.flatnonzero(self.labels == c)
            self.rolls[rows] = rng.permutation(IMAGE_SIZE)[:len(rows)]
        self.id2label = {i: f"class {k}" for i, k in enumerate(self.classes)}
        self.zero_shot_prompt_templates = list(templates)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        import numpy as np

        from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
        from mmlearn_tpu_torch.datasets.core import Example

        c = int(self.labels[idx])
        k = self.classes[c]
        return Example({"rgb": np.roll(self.patterns[k], int(self.rolls[idx]), axis=1),
                        "rgb_target": c, "text": self.tokens[k], EXAMPLE_INDEX_KEY: int(idx)})


class Head:
    """The first ``n`` examples of an eval set, with its labels and
    templates (phase 11's card-against-CPU subset)."""

    all_map_style = True

    def __init__(self, dataset, n: int) -> None:
        self.dataset, self.n = dataset, n
        self.id2label = dataset.id2label
        self.zero_shot_prompt_templates = dataset.zero_shot_prompt_templates

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        return self.dataset[idx]


class PromptTokenizer:
    """Class prompts to token ids, ragged: ``'<words> class <k>.'`` takes
    class k's token pattern of phase 10 cut to ``77 - 8 * words - k % 8``
    tokens, the end-of-text id last, right-padded with 0, and the matching
    ``int32`` attention mask."""

    def __init__(self, tokens) -> None:
        self.tokens = tokens

    def __call__(self, prompts):
        import numpy as np

        from mmlearn_tpu_torch.flagship import TEXT_LENGTH, VOCAB_SIZE

        ids = np.zeros((len(prompts), TEXT_LENGTH), np.int32)
        mask = np.zeros((len(prompts), TEXT_LENGTH), np.int32)
        for i, prompt in enumerate(prompts):
            words, k = prompt.split("class ")
            k = int(k.rstrip("."))
            length = TEXT_LENGTH - 8 * len(words.split()) - k % 8
            ids[i, :length] = self.tokens[k][:length]
            ids[i, length - 1] = VOCAB_SIZE - 1
            mask[i, :length] = 1
        return {"text": ids, "text_attention_mask": mask}


def eval_sets(source) -> list:
    """Phase 11's two eval sets: all ``INPUT_CLASSES`` classes with two
    prompt templates, and a 2-class subset (the binary path)."""
    return [EvalPairs(source, range(INPUT_CLASSES), EVAL_PAIRS, EVAL_SEED,
                      ["{}.", "a photo of {}."]),
            EvalPairs(source, EVAL_BINARY_CLASSES, EVAL_BINARY_PAIRS, EVAL_SEED + 1,
                      ["a close-up of {}."])]


def eval_loader(datasets, batch: int = BATCH):
    """Phase 11's loader: the sets in one ``CombinedDataset``, in order,
    the last batch padded (``batch_validity``)."""
    from mmlearn_tpu_torch.datasets.core import CombinedDataset, DataLoader

    return DataLoader(CombinedDataset(datasets), batch_size=batch, pad_partial_batches=True,
                      num_workers=INPUT_WORKERS)


def eval_hooks(tokens, out_dir: str, exports: bool = True) -> dict:
    """The eval job's hooks: retrieval rgb->text at 1, 5, 10 and text->rgb
    at 5, classification top-1 and top-5 (ragged prompts), and with
    ``exports`` two exports of rgb and text under ``out_dir``: ``index``
    (normalized, what serving loads) and ``raw`` (un-normalized, what the
    recall metric accumulates)."""
    from mmlearn_tpu_torch.tasks import (
        ClassificationTaskSpec,
        EmbeddingExport,
        EvaluationSpec,
        RetrievalTaskSpec,
        ZeroShotClassification,
        ZeroShotCrossModalRetrieval,
    )

    hooks = {
        "retrieval": EvaluationSpec(ZeroShotCrossModalRetrieval(
            [RetrievalTaskSpec("rgb", "text", EVAL_RGB_KS), RetrievalTaskSpec("text", "rgb", [5])])),
        "classification": EvaluationSpec(ZeroShotClassification(
            [ClassificationTaskSpec("rgb", [1, 5])], tokenizer=PromptTokenizer(tokens))),
    }
    if exports:
        for name, normalize in (("index", True), ("raw", False)):
            hooks[f"export_{name}"] = EvaluationSpec(EmbeddingExport(
                os.path.join(out_dir, name), ["rgb", "text"], normalize=normalize,
                shard_size=EVAL_SHARD_ROWS))
    return hooks


def class_embeddings(task) -> dict:
    """Keep the classification hook's class embeddings (host f64) when its
    epoch ends: ``{dataset index: (classes, dim)}``, filled by the run."""
    hook = task.evaluation_tasks["classification"].task
    kept: dict = {}
    end = hook.on_evaluation_epoch_end

    def keep(runtime):
        kept.update({d: e.double().cpu().numpy() for d, e in hook._class_embeddings.items()})
        return end(runtime)

    hook.on_evaluation_epoch_end = keep
    return kept


@contextlib.contextmanager
def k1_cases():
    """K1f's launches in the block by case, ``{(masked, causal): n}``: a spy
    on the wrapper's launch (the count stays the wrapper's)."""
    import collections

    from mmlearn_tpu_torch.ops import fused_attention as fa

    cases: collections.Counter = collections.Counter()
    launch = fa._fused_mha_cuda

    def spy(qkv, mask, num_heads, scale, causal, packed=False):
        cases[(mask is not None, bool(causal))] += 1
        return launch(qkv, mask, num_heads, scale, causal, packed)

    fa._fused_mha_cuda = spy
    try:
        yield cases
    finally:
        fa._fused_mha_cuda = launch


def exported(out_dir: str, mod: str):
    """An export's rows of ``mod``: (embeddings, example index, dataset index)."""
    import numpy as np

    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    parts = [np.load(os.path.join(out_dir, name)) for name in manifest[mod]["shards"]]
    return tuple(np.concatenate([p[key] for p in parts])
                 for key in ("embeddings", "example_index", "dataset_index"))


def recall_f64(queries, targets, ks) -> tuple[dict, float]:
    """Recall@k of row i's positive target i, in f64 from the exported
    un-normalized rows, ties toward the lower target row; and the least
    nonzero distance of a score from its row's positive score."""
    import numpy as np

    q = queries.astype(np.float64)
    t = targets.astype(np.float64)
    # identical target rows score identically: each distinct row once (a
    # product's rounding may differ by a row's place in the matrix)
    t, inverse = np.unique(t, axis=0, return_inverse=True)
    sim = ((q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        t / np.linalg.norm(t, axis=1, keepdims=True)).T)[:, inverse.reshape(-1)]
    pos = np.diag(sim)[:, None]
    rows = np.arange(len(targets))[None]
    rank = (sim > pos).sum(1) + ((sim == pos) & (rows < np.arange(len(q))[:, None])).sum(1)
    gap = np.abs(sim - pos)
    return {k: float((rank < k).mean()) for k in ks}, float(gap[gap > 0].min())


def accuracy_f64(emb, classes, labels, ks) -> dict:
    """Top-k accuracies (a 2-class set: the sign of the softmax difference,
    i.e. class 1's cosine above class 0's) in f64, from un-normalized
    embeddings."""
    import numpy as np

    emb = emb.astype(np.float64)
    sim = (emb / np.linalg.norm(emb, axis=1, keepdims=True)) @ classes.T
    if classes.shape[0] == 2:
        return {0: float(((sim[:, 1] > sim[:, 0]).astype(np.int64) == labels).mean())}
    true = sim[np.arange(len(sim)), labels][:, None]
    rank = (sim > true).sum(1)
    return {k: float((rank < k).mean()) for k in ks}


def eval_metric_checks(results: dict, out_dir: str, sets, kept: dict) -> None:
    """Check 2: each R@k and each accuracy (with the class embeddings)
    recomputed in f64 from the ``raw`` export with the lower-row tie rule,
    equal to the job's."""
    import numpy as np

    q, ex, ds = exported(os.path.join(out_dir, "raw"), "rgb")
    t, ex_t, ds_t = exported(os.path.join(out_dir, "raw"), "text")
    check(np.array_equal(ex, ex_t) and np.array_equal(ds, ds_t),
          "the raw export's rgb and text rows are not the same examples")
    want = {}
    for (a, b), ks in (((q, t), EVAL_RGB_KS), ((t, q), [5])):
        recalls, gap = recall_f64(a, b, ks)
        name = "rgb_to_text" if a is q else "text_to_rgb"
        want.update({f"retrieval/{name}_R@{k}": v for k, v in recalls.items()})
        print(f"eval path: {name} f64 recall {recalls}; least nonzero distance of a score from "
              f"its positive's {gap:.3e}")
    labels = np.array([sets[d].labels[e] for d, e in zip(ds, ex)])
    for d, classes in kept.items():
        acc = accuracy_f64(q[ds == d], classes, labels[ds == d], [1, 5])
        for k, v in acc.items():
            want[f"classification/ds{d}_rgb_" + (f"top{k}_accuracy" if k else "accuracy")] = v
    differ = {k: (results[k], v) for k, v in want.items() if results[k] != v}
    print(f"eval path: {len(want)} recalls and accuracies against their f64 recomputation "
          f"from the exported shards (ties to the lower row): {len(want) - len(differ)} equal"
          + (f"; differ {differ}" if differ else ""))
    check(not differ, f"eval metrics differ from their f64 recomputation: {differ}")


def cpu_copy_f32(task):
    """``task``'s towers and weights on the CPU, computing in f32 (its
    kernels' plain versions)."""
    from mmlearn_tpu_torch.modules.encoders import TextTransformer, VisionTransformer
    from mmlearn_tpu_torch.tasks import ContrastivePretraining

    cls = {"rgb": VisionTransformer, "text": TextTransformer}
    copy_ = ContrastivePretraining({m: cls[m](**{**enc.config, "dtype": "float32"})
                                    for m, enc in task.encoders.items()})
    copy_.load_state_dict(task.state_dict())
    return copy_


def _row_cosines(a, b):
    import numpy as np

    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def _centered_agreement(card, cpu, keys) -> tuple[float, int, float]:
    """Card rows against CPU rows, the CPU rows' mean taken from both
    (unit rows): what remains is the part of each row that depends on its
    input. The least cosine of a card row to its own CPU row; the rows
    nearer another input's CPU row than their own (rows of equal ``keys``
    share their input, the same text, and are not rivals); and the least
    margin, own cosine minus the best rival's."""
    import numpy as np

    def unit(x):
        x = x.astype(np.float64)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    a, b = unit(card), unit(cpu)
    mean = b.mean(0)
    sim = unit(a - mean) @ unit(b - mean).T
    own = np.diag(sim)
    rival = np.where(keys[:, None] == keys[None, :], -np.inf, sim).max(1)
    return float(own.min()), int((own <= rival).sum()), float((own - rival).min())


def eval_card_vs_cpu(task, device, sets, weights: str) -> None:
    """Check 3: the same hooks over the first ``EVAL_CPU_PAIRS`` pairs (the
    64-class set's first and the binary set's first, two batches of
    ``EVAL_CPU_BATCH``) on the card and on an f32 CPU copy of the task with
    the plain versions: per-row cosines of the exported embeddings and of
    the class embeddings (>= ``MIN_COSINE``, the serving limit), the same
    rows with the CPU rows' mean taken out (``_centered_agreement``):
    cosines >= ``EVAL_CENTERED_COS`` and each card row nearest its own
    input's CPU row, and the metrics: the loss, each recall and accuracy in
    rows decided otherwise, the macro metrics. The image tower's rows share
    most of their direction (fresh weights: an error of 5.98e-05 in 1 - cos
    reads 1.95e-03 once centered), so only the centered rows see a fault in
    it. The ``fresh`` flagship's rows, distinct, are held to all of it; the
    ``trained`` weights (phase 10's, whose image tower is nearly collapsed:
    rows of equal bits for different images, scores whose order rounding
    decides) to the serving limit, their centered readings and metrics
    printed. Every reading is printed before any check."""
    import numpy as np

    from mmlearn_tpu_torch.trainer import Trainer

    heads = [Head(sets[0], EVAL_CPU_PAIRS - EVAL_CPU_BINARY), Head(sets[1], EVAL_CPU_BINARY)]
    root = os.path.join(WORK_DIR, "eval_cpu", weights)
    runs = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        model = task if side == "card" else cpu_copy_f32(task)
        out_dir = os.path.join(root, side)
        model.evaluation_tasks = eval_hooks(sets[0].tokens, out_dir)
        kept = class_embeddings(model)
        t0 = time.perf_counter()
        results = Trainer(device=where, device_normalize=input_normalize()).validate(
            model, eval_loader(heads, EVAL_CPU_BATCH))
        runs[side] = (results, kept, out_dir)
        print(f"eval path, {weights} weights, {side}: {EVAL_CPU_PAIRS} pairs in "
              f"{time.perf_counter() - t0:.1f} s")
        del model
    (card, card_cls, card_dir), (cpu, cpu_cls, cpu_dir) = runs["card"], runs["cpu"]
    worst, centered = {}, {}
    for mod in ("rgb", "text"):
        got, ex, ds = exported(os.path.join(card_dir, "index"), mod)
        want, ex_cpu, ds_cpu = exported(os.path.join(cpu_dir, "index"), mod)
        check(np.array_equal(ex, ex_cpu) and np.array_equal(ds, ds_cpu),
              f"card and CPU exported other {mod} rows")
        # an image is its own input; a text is its class's token pattern
        keys = (np.arange(len(ex)) if mod == "rgb" else
                np.array([sets[d].classes[sets[d].labels[e]] for d, e in zip(ds, ex)]))
        worst[mod] = _row_cosines(got, want).min()
        centered[mod] = _centered_agreement(got, want, keys)
    for d in cpu_cls:
        worst[f"classes ds{d}"] = _row_cosines(card_cls[d], cpu_cls[d]).min()
        centered[f"classes ds{d}"] = _centered_agreement(card_cls[d], cpu_cls[d],
                                                         np.arange(len(cpu_cls[d])))
    held = weights == "fresh"
    print(f"eval path, {weights} weights, card vs CPU: least row cosine " + ", ".join(
        f"{k} {v:.6f}" for k, v in worst.items()) + f" (bound {MIN_COSINE}); centered: least "
          "cosine, rows nearer another input's CPU row than their own, least margin " + ", ".join(
              f"{k} {c:.6f} {n} {m:.3e}" for k, (c, n, m) in centered.items())
          + (f" (bound {EVAL_CENTERED_COS}, 0 rows)" if held else " (printed, not held)"))
    check(sorted(card) == sorted(cpu), f"card and CPU metric keys differ: {sorted(card)} "
          f"{sorted(cpu)}")
    loss_err = abs(card["validation/loss"] - cpu["validation/loss"]) / abs(cpu["validation/loss"])
    rows_of = {"retrieval/": EVAL_CPU_PAIRS, "classification/ds0_rgb_top": heads[0].n,
               "classification/ds1_rgb_accuracy": heads[1].n}
    rows, other = {}, {}
    for k in card:
        n = next((n for prefix, n in rows_of.items() if k.startswith(prefix)), None)
        if n is not None:
            rows[k] = round(abs(card[k] - cpu[k]) * n)
        elif not k.startswith(("export/", "validation/")):
            other[k] = abs(card[k] - cpu[k])
    worst_rows, worst_other = max(rows, key=rows.get), max(other, key=other.get)
    print(f"eval path, {weights} weights, card vs CPU: loss rel diff {loss_err:.3e} (limit "
          f"{EVAL_LOSS_RTOL}); recalls and accuracies: at most {rows[worst_rows]} rows decided "
          f"otherwise ({worst_rows}; limit {EVAL_ROWS}); other metrics: largest abs diff "
          f"{other[worst_other]:.6f} ({worst_other}; limit {EVAL_OTHER_ATOL})"
          + ("" if held else " (printed, not held)") + "; card/CPU " + ", ".join(
              f"{k} {card[k]:.4f}/{cpu[k]:.4f}" for k in sorted(card) if k in rows or k in other))
    check(all(v >= MIN_COSINE for v in worst.values()),
          f"eval embeddings card vs CPU ({weights}) {worst}")
    if not held:
        return
    check(all(c >= EVAL_CENTERED_COS and n == 0 for c, n, _ in centered.values()),
          f"eval embeddings card vs CPU ({weights}), centered: {centered}")
    check(loss_err <= EVAL_LOSS_RTOL, f"eval loss card vs CPU {card['validation/loss']} "
          f"{cpu['validation/loss']}")
    check(rows[worst_rows] <= EVAL_ROWS and other[worst_other] <= EVAL_OTHER_ATOL,
          f"eval metrics card vs CPU: {worst_rows} {card[worst_rows]} {cpu[worst_rows]}, "
          f"{worst_other} {card[worst_other]} {cpu[worst_other]}")


def blockwise_checks(device) -> None:
    """Check 4 and the recall pass's times: at ``BLOCKWISE_QUERIES`` x
    ``BLOCKWISE_TARGETS`` of width 512 the top-k routes blockwise; its rows
    equal the full-axis top-k in query chunks of 1,024. The inputs are
    integers in [-2, 2] (as f32): every product is exact whatever the
    product's order, so the check holds the selection alone, and its many
    tied scores hold the lower-row rule. Then the times: that top-k, and
    ``RetrievalRecallAtK.compute_many`` (R@1, 5, 10) at 2,048^2 and at
    this size."""
    import torch

    from mmlearn_tpu_torch.modules.metrics import RetrievalRecallAtK
    from mmlearn_tpu_torch.modules.metrics import retrieval_recall as rr

    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    targets = torch.randint(-2, 3, (BLOCKWISE_TARGETS, 512), generator=gen, device=device).float()
    queries = torch.randint(-2, 3, (BLOCKWISE_QUERIES, 512), generator=gen, device=device).float()
    k = 10
    check(rr._use_blockwise_topk(BLOCKWISE_QUERIES, BLOCKWISE_TARGETS, k),
          "the blockwise route is not taken at this size")
    with torch.inference_mode():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        blocked = rr._topk_chunk(queries, targets, k)
        peak_gib = (torch.cuda.max_memory_allocated(device) - held) / 2**30
        full, ties = [], 0
        for start in range(0, BLOCKWISE_QUERIES, 1024):
            s, rows = rr._topk_scores_chunk(queries[start:start + 1024], targets, k + 1)
            full.append(rows[:, :k])
            ties += int((s[:, k - 1] == s[:, k]).sum())
        full = torch.cat(full)
        same = bool(torch.equal(blocked, full))
        # the tie rule itself: a stable descending sort keeps equal scores
        # in row order
        with rr.full_f32_matmul():
            sim = queries[:TIE_RULE_QUERIES] @ targets.T
        stable = torch.sort(sim, dim=1, descending=True, stable=True).indices[:, :k]
        lower_first = bool(torch.equal(blocked[:TIE_RULE_QUERIES], stable))
        del sim
        ms = cuda_ms(lambda: rr._topk_chunk(queries, targets, k), iters=3, warmup=1)
    print(f"eval path: top-{k} of {BLOCKWISE_QUERIES:,} x {BLOCKWISE_TARGETS:,} (width 512, "
          f"f32 sims {BLOCKWISE_QUERIES * BLOCKWISE_TARGETS * 4 / 2**30:.0f} GiB): blockwise rows "
          f"equal the full-axis top-k in chunks of 1,024: {same} ({ties} rows tie their k-th "
          f"and (k+1)-th score); the first {TIE_RULE_QUERIES} rows equal a stable descending "
          f"sort's (the lower row first among equal scores): {lower_first}; blockwise "
          f"{ms:.2f} ms, peak {peak_gib:.3f} GiB above its inputs")
    check(same, "the blockwise top-k differs from the full-axis top-k")
    check(lower_first, "the top-k does not put the lower row first among equal scores")
    for nq, nt in ((EVAL_PAIRS, EVAL_PAIRS), (BLOCKWISE_QUERIES, BLOCKWISE_TARGETS)):
        metric = RetrievalRecallAtK(top_k=k)
        metric.update(queries[:nq], targets[:nt])
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metric.compute_many([1, 5, k])
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"eval path: the recall pass (compute_many R@1/5/{k}) at {nq:,} x {nt:,}: "
              f"{statistics.median(times[1:]):.2f} ms (median of {len(times) - 1} after one)")
    del targets, queries, blocked, full
    torch.cuda.empty_cache()


def eval_path(device, trained, ckpt_dir: str) -> dict:
    """Phase 11, the eval path: the flagship's eval-only job over phase 11's
    held-out sets (``eval_sets``) at b256, uint8 images normalized on the
    card. Check 1: one eval batch's launches a tower, and the class
    prompts'. The job: ``Trainer.validate`` of the weights phase 10's fit
    left, with the retrieval, classification and two export hooks, every
    count set to 0 first (launches a tower forward exactly, K1f's cases);
    check 2 (each recall and accuracy against an f64 recomputation from the
    exports), check 5 (the exported index serves each rgb row as its own
    rank-1 neighbour); the eval-only route (``prepare_eval_state`` from
    phase 10's checkpoint, then ``Trainer.test``, equal bit for bit) with
    the fresh weights' accuracy before the restore; check 3 (card against
    an f32 CPU copy on 64 pairs) and check 4 (blockwise top-k). Returns the
    job's launch counts."""
    import shutil

    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import flagship_training_task
    from mmlearn_tpu_torch.modules.metrics.retrieval_recall import _topk_scores_chunk
    from mmlearn_tpu_torch.serving import EmbeddingIndex
    from mmlearn_tpu_torch.tasks import EmbeddingExport, EvalRuntime
    from mmlearn_tpu_torch.trainer import Trainer
    from mmlearn_tpu_torch.trainer.trainer import _to_device

    root = os.path.join(WORK_DIR, "eval")
    shutil.rmtree(root, ignore_errors=True)
    sets = eval_sets(Uint8Pairs(SEED + 31))  # phase 10's patterns
    n_pairs = sum(len(d) for d in sets)
    tokens = sets[0].tokens
    trainer = Trainer(device=device, device_normalize=input_normalize())
    depth = {m: len(enc.blocks) for m, enc in trained.encoders.items()}
    idle = {k: 0 for k in ("fused_mha_bwd", "fused_mha_packed_fwd", "fused_mha_packed_bwd",
                           "layernorm_bwd", "int8_qmm", "int8_qmm_bytes", *NO_FLASH)}

    # check 1: one eval batch, a tower at a time, then one chunk of prompts
    first = next(iter(eval_loader(sets)))
    placed = trainer._device_inputs(_to_device(first, device), torch.bfloat16)
    runtime = EvalRuntime(trained, device)
    prompts = PromptTokenizer(tokens)([t.format(f"class {k}") for k in range(32)
                                       for t in sets[0].zero_shot_prompt_templates])
    for what, batch, modality, case in (("rgb", placed, "rgb", (False, False)),
                                        ("text", placed, "text", (False, True)),
                                        ("prompts", prompts, "text", (True, True))):
        reset_counts()
        with k1_cases() as cases:
            runtime.encode(batch, modality)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {**idle, "fused_mha_fwd": depth[modality], "layernorm_fwd": 2 * depth[modality]}
        print(f"eval path: one eval batch's {what} ({modality} tower, b{BATCH}) launched K1f "
              f"{counts['fused_mha_fwd']} ({dict(cases)} by (masked, causal)), K2f "
              f"{counts['layernorm_fwd']}; the rest {sum(counts[k] for k in idle)}")
        check(counts == want and dict(cases) == {case: depth[modality]},
              f"eval {what} launches {counts} {dict(cases)}, want {want} as {case}")
    del runtime, placed, first

    # the job: validate with every hook, counts from 0
    trained.evaluation_tasks = eval_hooks(tokens, root)
    kept = class_embeddings(trained)
    forwards = {m: 0 for m in trained.encoders}
    handles = [enc.register_forward_hook(
        lambda mod, args, out, m=m: forwards.__setitem__(m, forwards[m] + 1))
        for m, enc in trained.encoders.items()]
    flush = [0.0]
    flush_fn = EmbeddingExport._flush

    def timed_flush(self, mod):
        t0 = time.perf_counter()
        flush_fn(self, mod)
        flush[0] += time.perf_counter() - t0

    EmbeddingExport._flush = timed_flush
    reset_counts()
    gc.collect()  # what earlier phases left unreferenced leaves the count
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    try:
        with k1_cases() as cases:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = trainer.validate(trained, eval_loader(sets))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        EmbeddingExport._flush = flush_fn
        for h in handles:
            h.remove()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    tower_blocks = sum(depth[m] * n for m, n in forwards.items())
    want = {**idle, "fused_mha_fwd": tower_blocks, "layernorm_fwd": 2 * tower_blocks}
    print(f"eval path: validate over {n_pairs} pairs ({len(eval_loader(sets))} batches of "
          f"{BATCH}): tower forwards {forwards}; launched K1f {counts['fused_mha_fwd']} "
          f"({dict(cases)} by (masked, causal)), K2f {counts['layernorm_fwd']}, the rest "
          f"{sum(counts[k] for k in idle)}")
    check(counts == want, f"eval job launches {counts}, want {want}")
    check(cases[(True, True)] > 0 and cases[(False, False)] > 0,
          f"the eval job's K1f cases {dict(cases)} lack masked causal or unmasked")
    written = sum(os.path.getsize(os.path.join(root, d, f)) for d in ("index", "raw")
                  for f in os.listdir(os.path.join(root, d)))
    print(f"eval path: {n_pairs / seconds:.1f} eval pairs/s at b{BATCH} ({seconds:.2f} s: "
          f"both towers, the loss, the hooks, the recall passes and the exports); export "
          f"{written / 1e6:.2f} MB in {flush[0]:.3f} s of flushes ({written / 1e6 / flush[0]:.1f} "
          f"MB/s); peak memory {peak_gb:.2f} GB ({held_gb:.2f} GB allocated before the job)")
    print("eval path: results " + json.dumps(results, sort_keys=True))
    check(all(np.isfinite(v) for v in results.values()), f"eval results {results}")
    check(results["export/rgb_rows"] == results["export/text_rows"] == n_pairs,
          f"exported rows {results['export/rgb_rows']}, {results['export/text_rows']}")

    # check 2: recall and accuracy against the exports, in f64
    eval_metric_checks(results, root, sets, kept)

    # check 5: the exported index serves each rgb row as its own rank-1
    # neighbour, or as a row of the same bits earlier in the index (ties go
    # to the lower row)
    index = EmbeddingIndex.load(os.path.join(root, "index"), modality="rgb", device=device)
    emb, ex, ds = exported(os.path.join(root, "index"), "rgb")
    _, ids = index.query(emb, k=1)
    with torch.inference_mode():
        rows = _topk_scores_chunk(index.embeddings, index.embeddings, 2)[1].cpu().numpy()
    first = np.unique(emb, axis=0, return_index=True, return_inverse=True)
    first_row = first[1][first[2].reshape(-1)]  # each row's first row of the same bits
    own = (rows[:, 0] == first_row) & (ids[:, 0] == ex[first_row])
    second = rows[:, 1]
    cos = (emb * emb[second]).sum(1) / np.linalg.norm(emb, axis=1) / np.linalg.norm(
        emb[second], axis=1)
    print(f"eval path: EmbeddingIndex over the normalized export ({len(index)} rows, "
          f"{int((first_row != np.arange(len(emb))).sum())} the same bits as an earlier row): "
          f"each row its own rank-1 neighbour (or that earlier row) at {int(own.sum())} of "
          f"{len(own)}; rank-2 cosine median {np.median(cos):.6f}, max {cos.max():.6f}")
    check(bool(own.all()) and len(index) == n_pairs, "exported rows are not their own rank-1")

    # the eval-only route, with the fresh weights' accuracy first
    chance = 1 / INPUT_CLASSES
    top1 = "classification/ds0_rgb_top1_accuracy"
    fresh = flagship_training_task("cpu", seed=SEED)
    fresh.evaluation_tasks = eval_hooks(tokens, root, exports=False)
    fresh_results = Trainer(device=device, device_normalize=input_normalize()).validate(
        fresh, eval_loader(sets))
    print(f"eval path: top-1 accuracy over {INPUT_CLASSES} classes: trained "
          f"{results[top1]:.4f}, fresh {fresh_results[top1]:.4f}, chance {chance:.4f}; "
          f"R@1 rgb->text trained {results['retrieval/rgb_to_text_R@1']:.4f}, fresh "
          f"{fresh_results['retrieval/rgb_to_text_R@1']:.4f}")
    eval_card_vs_cpu(fresh, device, sets, "fresh")  # before the restore below
    fresh.evaluation_tasks = eval_hooks(tokens, os.path.join(root, "test"))
    tester = Trainer(device=device, device_normalize=input_normalize())
    t0 = time.perf_counter()
    state = tester.prepare_eval_state(fresh, eval_loader(sets), ckpt_path=ckpt_dir)
    restore_s = time.perf_counter() - t0
    tested = tester.test(fresh, eval_loader(sets))
    same = {k.replace("test/", "validation/"): v for k, v in tested.items()} == results
    print(f"eval path: prepare_eval_state from phase 10's checkpoint (step {state.step}, "
          f"{restore_s:.1f} s), then Trainer.test: metrics equal validate's bit for bit: {same}")
    check(state.step == INPUT_STEPS and same, f"test after restore {tested} != {results}")
    del fresh, tester, state
    torch.cuda.empty_cache()

    eval_card_vs_cpu(trained, device, sets, "trained")
    blockwise_checks(device)
    return counts


# ------------------------------------------------- the large presets' path

# phase 12: OpenCLIP ViT-H/14 (vit_huge, 16 heads of 80, 257 tokens on K1)
# and ViT-g/14 (vit_giant, 16 heads of 88, 257 tokens on K3), random
# weights from SEED. The CPU comparisons keep LARGE_CPU_DEPTH blocks a
# tower at full width; the fit runs at LARGE_FIT_BATCH on Uint8Pairs through
# the DataLoader (distinct batches: 32 a pass at b128)
LARGE_CPU_DEPTH, LARGE_DROP_PATH, LARGE_FIT_BATCH, LARGE_MEM_BATCH = 4, 0.1, 128, 64
GIANT_ENCODE_BATCH, TOWER_PARITY_BATCH, TOWER_CPU_DEPTH = 64, 4, 2
LARGE_WINDOW_STEPS = 5


def large_launches(task, remat: bool) -> dict:
    """Launches a step of a pair trained on K1 (every block's attention):
    per block K1f once (twice under remat: its recompute), K1b's two kernels
    once, K2f twice (four times under remat), K2b twice."""
    depth = sum(len(enc.blocks) for enc in task.encoders.values())
    k = 2 if remat else 1
    return {"fused_mha_fwd": k * depth, "fused_mha_bwd": 2 * depth, "fused_mha_packed_fwd": 0,
            "fused_mha_packed_bwd": 0, "layernorm_fwd": 2 * k * depth,
            "layernorm_bwd": 2 * depth, "int8_qmm": 0, "int8_qmm_bytes": 0, **NO_FLASH}


def large_step(task, batch, source_seed=None):
    """``task.loss_fn(batch)`` and its backward, the masks drawn from a CPU
    source seeded ``source_seed`` (the same draws for every device; none
    without a seed). Returns the loss."""
    from mmlearn_tpu_torch.modules.layers.dropout import MaskSource, masks_from

    source = None if source_seed is None else MaskSource(source_seed, "cpu")
    with masks_from(source):
        loss, _ = task.loss_fn(batch)
    loss.backward()
    return loss


def vit_h14_parity(device) -> None:
    """Phase 12 (b): one step of the ViT-H/14 pair at b8, both towers cut to
    ``LARGE_CPU_DEPTH`` blocks at full width, under remat and drop-path 0.1
    (the same masks on both sides), on the card against the plain versions
    on the CPU: the loss and every gradient at phase 5's limits."""
    import torch

    from mmlearn_tpu_torch.flagship import synthetic_batch, vit_h14_training_task

    batch = synthetic_batch(PARITY_BATCH, torch.Generator().manual_seed(SEED + 51), "cpu")
    master = vit_h14_training_task("cpu", SEED, drop_path_rate=LARGE_DROP_PATH,
                                   image_depth=LARGE_CPU_DEPTH, text_depth=LARGE_CPU_DEPTH)
    losses, grads = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        task = copy.deepcopy(master).to(dev) if where == "card" else master
        loss = large_step(task, {k: v.to(dev) for k, v in batch.items()}, (SEED, 52))
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()}
        print(f"large path: ViT-H/14 step b={PARITY_BATCH} depth {LARGE_CPU_DEPTH}+"
              f"{LARGE_CPU_DEPTH}, remat, drop-path {LARGE_DROP_PATH}, on the {where}: loss "
              f"{losses[where]:.6f} ({time.perf_counter() - t0:.1f} s)")
    del task, master
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    print(f"large path: ViT-H/14 step parity, card vs CPU: loss rel diff {rel:.3e} (tol "
          f"{LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} at {worst}, median "
          f"{statistics.median(cos.values()):.6f} over {len(cos)} tensors (bound "
          f"{MIN_GRAD_COSINE})")
    check(rel <= LOSS_RTOL, f"ViT-H/14 loss on the card {losses['card']} vs CPU {losses['cpu']}")
    check(cos[worst] >= MIN_GRAD_COSINE, f"ViT-H/14 gradient of {worst}: cosine {cos[worst]}")


def remat_equal(task, device) -> None:
    """Phase 12 (c): the full-depth ViT-H/14 pair at b8 on the card with
    drop-path 0.1 on the image tower, one step with remat and one without on
    the same weights, batch and masks: the losses and every gradient equal
    bit for bit (the recompute runs the same kernels on the same inputs, and
    the saved products are the forward's own)."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.flagship import synthetic_batch

    batch = synthetic_batch(PARITY_BATCH, torch.Generator(device=device).manual_seed(SEED + 53),
                            device)
    blocks = task.encoders["rgb"].blocks
    rates = np.linspace(0, LARGE_DROP_PATH, len(blocks))
    for block, r in zip(blocks, rates):
        block.drop_path_rate = float(r)
    runs = {}
    for remat in (True, False):
        for enc in task.encoders.values():
            enc.blocks.remat = remat
        task.zero_grad(set_to_none=True)
        loss = large_step(task, batch, (SEED, 54))
        runs[remat] = (loss.detach().clone(),
                       {n: p.grad.clone() for n, p in task.named_parameters()})
    for block in blocks:
        block.drop_path_rate = 0.0
    for enc in task.encoders.values():
        enc.blocks.remat = True
    task.zero_grad(set_to_none=True)
    same_loss = torch.equal(runs[True][0], runs[False][0])
    differ = [n for n in runs[True][1] if not torch.equal(runs[True][1][n], runs[False][1][n])]
    print(f"large path: ViT-H/14 b{PARITY_BATCH} remat on vs off (drop-path "
          f"{LARGE_DROP_PATH}, the same masks): loss {runs[True][0].item():.6f} / "
          f"{runs[False][0].item():.6f} bit-equal {same_loss}; gradients bit-equal at "
          f"{len(runs[True][1]) - len(differ)} of {len(runs[True][1])} tensors")
    check(same_loss and not differ, f"remat changes the step: loss equal {same_loss}, "
          f"gradients differ at {differ[:10]}")


def tower_parity(make, device, label: str, images_px: int) -> dict:
    """One forward and backward of an image tower (``make(device)``, cut to
    ``TOWER_CPU_DEPTH`` blocks at full width) at ``TOWER_PARITY_BATCH`` on the
    card against the plain versions on the CPU, the loss ``sum(pooled *
    probe)`` for a fixed probe: the pooled output, the loss and every
    gradient at phase 5's limits. The card's run is counted from 0; returns
    its launches by head dim."""
    import torch

    g = torch.Generator().manual_seed(SEED + 55)
    x = torch.randn(TOWER_PARITY_BATCH, images_px, images_px, 3, generator=g).bfloat16()
    master = make("cpu")
    probe = torch.randn(master.config["proj_dim"], generator=g)
    outs, grads = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        tower = copy.deepcopy(master).to(dev).train() if where == "card" else master.train()
        if where == "card":
            reset_counts()
        pooled = tower(x.to(dev)).pooler_output
        loss = (pooled.float() * probe.to(dev)).sum()
        loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            counts = head_dim_counts()
        outs[where] = (pooled.detach().float().cpu(), loss.item())
        grads[where] = {n: p.grad.float().cpu() for n, p in tower.named_parameters()}
    del tower, master
    cos = _cosine(outs["card"][0], outs["cpu"][0])
    rel = abs(outs["card"][1] - outs["cpu"][1]) / max(abs(outs["cpu"][1]), 1e-6)
    gcos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(gcos, key=gcos.get)
    print(f"large path: {label} image tower b{TOWER_PARITY_BATCH} depth {TOWER_CPU_DEPTH}, card "
          f"vs CPU: pooled cosine {cos:.6f}, loss {outs['card'][1]:.6f} / {outs['cpu'][1]:.6f}; "
          f"gradient cosine min {gcos[worst]:.6f} at {worst} over {len(gcos)} tensors; "
          f"launches {counts}")
    check(cos >= MIN_GRAD_COSINE and gcos[worst] >= MIN_GRAD_COSINE,
          f"{label} tower card vs CPU: pooled cosine {cos}, gradient {worst} {gcos[worst]}")
    return counts


def large_fit(task, device, batch_size: int, remat: bool) -> tuple[dict, dict]:
    """Phase 12 (d, e): ``Trainer.fit`` of the ViT-H/14 pair at ``batch_size``
    with both towers' remat set to ``remat``, on ``Uint8Pairs`` through the
    ``DataLoader`` (normalized on the card), every count set to 0 first: 3
    warm-up steps, 3 timed windows of 5, one more step. Checks the launches
    a step exactly (by head dim too), every gradient of the first step
    finite and nonzero and the loss finite; prints pairs/s, ms a step, the
    peak memory of the fit (weights, gradients and AdamW's moments
    included), the counted FLOPs, TFLOP/s and MFU. Returns the launches and
    their counts by head dim."""
    import math

    import torch

    from mmlearn_tpu_torch.datasets.core import DataLoader
    from mmlearn_tpu_torch.trainer import Trainer
    from mmlearn_tpu_torch.trainer.flops import device_peak_tflops

    for enc in task.encoders.values():
        enc.blocks.remat = remat
    task.zero_grad(set_to_none=True)
    loader = DataLoader(Uint8Pairs(SEED + 56), batch_size=batch_size, shuffle=True,
                        seed=SEED, drop_last=True, num_workers=INPUT_WORKERS)
    marks = [WARMUP_STEPS + i * LARGE_WINDOW_STEPS for i in range(WINDOWS + 1)]
    steps = marks[-1] + 1
    trainer = Trainer(max_steps=steps, log_every_n_steps=steps, device=device, log_mfu=True,
                      device_normalize=input_normalize())
    probe = InputProbe(marks, first_grads=True)
    probe.label = f"large path: ViT-H/14 fit b{batch_size} remat {'on' if remat else 'off'}"
    trainer.callbacks.append(probe)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    state = trainer.fit(task, loader)
    torch.cuda.synchronize()
    counts, dims = launch_counts(), head_dim_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = large_launches(task, remat)
    k = 2 if remat else 1
    want_dims = {("fused_mha_fwd", 80): 32 * k, ("fused_mha_bwd", 80): 64,
                 ("fused_mha_fwd", 64): 24 * k, ("fused_mha_bwd", 64): 48}
    print(f"{probe.label}: {state.step} steps launched " + ", ".join(
        f"{key} {v} ({v / state.step:g} a step, want {want[key]})" for key, v in counts.items())
          + f"; by head dim {dims}")
    check(counts == {key: v * state.step for key, v in want.items()},
          f"ViT-H/14 fit launches {counts}, want {want} a step")
    check(dims == {key: v * state.step for key, v in want_dims.items()},
          f"ViT-H/14 fit launches by head dim {dims}, want {want_dims} a step")
    losses = [h["loss"] for h in trainer.history]
    check(all(math.isfinite(x) for x in losses), f"ViT-H/14 fit losses {losses}")
    window_s = [probe.times[b] - probe.times[a] for a, b in zip(marks, marks[1:])]
    rates = [batch_size * LARGE_WINDOW_STEPS / w for w in window_s]
    median = statistics.median(rates)
    ms = statistics.median(window_s) / LARGE_WINDOW_STEPS * 1e3
    flops = trainer._step_flops
    tflops = flops / (ms / 1e3) / 1e12
    peak = device_peak_tflops(device)
    print(f"{probe.label}{' (dots_no_batch)' if remat else ''}: loss step 0 {losses[0]:.6f}, "
          f"step {len(losses) - 1} {losses[-1]:.6f}; {median:.1f} pairs/s median of {WINDOWS} "
          f"windows of {LARGE_WINDOW_STEPS} steps (windows {', '.join(f'{r:.1f}' for r in rates)}"
          f"; spread {(max(rates) - min(rates)) / median:.2%}), {ms:.2f} ms a step, peak memory "
          f"{peak_gb:.2f} GB; {flops:.6e} FLOPs a step counted (any recompute included), "
          f"{tflops:.1f} TFLOP/s, MFU "
          f"{'not in the table' if peak is None else f'{tflops / peak:.2%} of {peak:g}'}")
    del trainer, state, loader
    return counts, dims


def large_path(device) -> tuple[dict, dict]:
    """Phase 12, the large presets. Returns the launch counts of its main
    runs, and their launches by (kernel, head dim)."""
    import torch

    from mmlearn_tpu_torch.flagship import (
        synthetic_batch,
        vit_g14_task,
        vit_h14_training_task,
    )

    by_dim: dict = {}
    totals: dict = {}

    def add(counts, dims):
        for key, v in counts.items():
            totals[key] = totals.get(key, 0) + v
        for key, v in dims.items():
            by_dim[key] = by_dim.get(key, 0) + v

    t0 = time.perf_counter()
    master = vit_h14_training_task("cpu", SEED)
    n_img = sum(p.numel() for p in master.encoders["rgb"].parameters())
    n_txt = sum(p.numel() for p in master.encoders["text"].parameters())
    print(f"large path: ViT-H/14 pair built on the CPU in {time.perf_counter() - t0:.1f} s: image "
          f"{n_img:,} parameters, text {n_txt:,}")
    task = master.to(device)
    del master

    # (a) one tower forward each, counted exactly
    batch = synthetic_batch(PARITY_BATCH, torch.Generator(device=device).manual_seed(SEED + 50),
                            device)
    for mod, depth, d in (("rgb", 32, 80), ("text", 24, 64)):
        reset_counts()
        with torch.no_grad():
            task.encode(batch, mod)
        torch.cuda.synchronize()
        counts, dims = launch_counts(), head_dim_counts()
        print(f"large path: one ViT-H/14 {mod} tower forward b{PARITY_BATCH} launched {counts}, "
              f"by head dim {dims}")
        check(dims == {("fused_mha_fwd", d): depth} and counts["layernorm_fwd"] == 2 * depth
              and sum(counts.values()) == 3 * depth,
              f"{mod} tower forward launched {counts} {dims}, want K1f {depth} at D={d} and "
              f"K2f {2 * depth}")
        add(counts, dims)

    # (b) card vs CPU under remat and drop-path, (c) remat on against off
    vit_h14_parity(device)
    remat_equal(task, device)

    # (d) Trainer.fit at b128 under remat on distinct host batches; (e) at b64
    # with remat off and on
    for batch_size, remat in ((LARGE_FIT_BATCH, True), (LARGE_MEM_BATCH, False),
                              (LARGE_MEM_BATCH, True)):
        add(*large_fit(task, device, batch_size, remat))
    del task
    gc.collect()
    torch.cuda.empty_cache()

    # (f) ViT-g/14: encode at b64 on K3 (D=88); ViT-g/16 and ViT-g/14 image
    # towers forward and backward against the CPU (K1 and K3 at D=88)
    t0 = time.perf_counter()
    giant = vit_g14_task(device, SEED)
    print(f"large path: ViT-g/14 pair built in {time.perf_counter() - t0:.1f} s: image "
          f"{sum(p.numel() for p in giant.encoders['rgb'].parameters()):,} parameters")
    images = torch.randn(GIANT_ENCODE_BATCH, 224, 224, 3, device=device,
                         generator=torch.Generator(device=device).manual_seed(SEED + 58)
                         ).bfloat16()
    reset_counts()
    with torch.no_grad():
        emb = giant.encode({"rgb": images}, "rgb", normalize=True)
    torch.cuda.synchronize()
    counts, dims = launch_counts(), head_dim_counts()
    print(f"large path: ViT-g/14 image encode b{GIANT_ENCODE_BATCH} launched {counts}, by head "
          f"dim {dims}")
    check(dims == {("flash_fwd", 88): 40} and counts["layernorm_fwd"] == 80
          and counts["fused_mha_fwd"] == 0 and sum(counts.values()) == 120,
          f"ViT-g/14 encode launched {counts} {dims}, want K3f 40 at D=88, K2f 80, K1 0")
    check(bool(emb.float().isfinite().all()) and emb.shape == (GIANT_ENCODE_BATCH, 1024),
          f"ViT-g/14 embeddings {tuple(emb.shape)} not finite")
    add(counts, dims)
    with torch.no_grad():
        ms_enc = cuda_ms(lambda: giant.encode({"rgb": images}, "rgb"), iters=5, warmup=1)
    print(f"large path: ViT-g/14 image encode b{GIANT_ENCODE_BATCH}: "
          f"{GIANT_ENCODE_BATCH / ms_enc * 1e3:.1f} images/s ({ms_enc:.2f} ms a batch)")
    del giant, images, emb
    gc.collect()
    torch.cuda.empty_cache()
    for label, make, px, want_dims in (
        ("ViT-g/16", lambda dev: vit_g14_task(dev, SEED, patch_size=16,
                                              image_depth=TOWER_CPU_DEPTH,
                                              text_depth=1).encoders["rgb"], 224,
         {("fused_mha_fwd", 88): TOWER_CPU_DEPTH, ("fused_mha_bwd", 88): 2 * TOWER_CPU_DEPTH}),
        ("ViT-g/14", lambda dev: vit_g14_task(dev, SEED, image_depth=TOWER_CPU_DEPTH,
                                              text_depth=1).encoders["rgb"], 224,
         {("flash_fwd", 88): TOWER_CPU_DEPTH, ("flash_bwd_dq", 88): TOWER_CPU_DEPTH,
          ("flash_bwd_dkv", 88): TOWER_CPU_DEPTH}),
        # (g) ViT-H/14 at 448 px: 1,025 tokens, past K1's limit at D=80
        ("ViT-H/14 448 px", lambda dev: vit_h14_training_task(
            dev, SEED, remat=False, image_depth=TOWER_CPU_DEPTH, text_depth=1,
            image_size=448).encoders["rgb"], 448,
         {("flash_fwd", 80): TOWER_CPU_DEPTH, ("flash_bwd_dq", 80): TOWER_CPU_DEPTH,
          ("flash_bwd_dkv", 80): TOWER_CPU_DEPTH}),
    ):
        dims = tower_parity(make, device, label, px)
        check(dims == want_dims, f"{label} tower launched {dims}, want {want_dims}")
        add(launch_counts(), dims)
        gc.collect()
        torch.cuda.empty_cache()
    reset_counts()
    return totals, by_dim


# ------------------------------------------------------------ the record path

# phase 13: RECORDS TFRecords in RECORD_SHARDS shards (contiguous: record i
# is the dataset's item i), each the JPEG bytes of a committed fixture, the
# token pattern of its class (Uint8Pairs' 64) and its label; DECODE_RECORDS
# of them decoded on both paths; the fits at b256 through the thread loader
# (INPUT_WORKERS threads) and the process loader (RECORD_PROCESSES workers)
RECORDS, RECORD_SHARDS, DECODE_RECORDS, RECORD_PROCESSES = 4096, 8, 256, 6
STREAM_WORLD, STREAM_BUFFER = 4, 256
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "jpeg")


def record_seed(idx: int) -> int:
    """The crop seed of record ``idx``: what ``decode_transform_jpeg``
    draws from ``JpegRecords``' generator."""
    import numpy as np

    return int(np.random.default_rng((SEED, idx)).integers(0, 2**63 - 1))


class JpegRecords:
    """``to_example`` of phase 13's JPEG records: the ``jpeg`` feature
    through ``decode_transform_jpeg`` and ``transform`` under the record's
    own generator (``default_rng((SEED, index))``), so that every process
    and every epoch draws the same crop; its tokens and index."""

    def __init__(self, transform) -> None:
        self.transform = transform

    def __call__(self, features):
        import numpy as np

        from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
        from mmlearn_tpu_torch.datasets.builtin.image_utils import decode_transform_jpeg
        from mmlearn_tpu_torch.datasets.core import Example

        idx = int(features["index"][0])
        rgb = decode_transform_jpeg(features["jpeg"][0], self.transform,
                                    rng=np.random.default_rng((SEED, idx)))
        return Example({"rgb": rgb, "text": features["tokens"].astype(np.int32),
                        EXAMPLE_INDEX_KEY: idx})


def _record_index(features) -> int:
    return int(features["index"][0])


def _python_crcs(path: str) -> list:
    """The pure-Python CRC-32C of each record of the shard at ``path`` (a
    worker of phase 13's process pool: the Python table runs at a few MB/s)."""
    from mmlearn_tpu_torch.datasets.core.tfrecord import _crc32c_py, read_tfrecord

    return [_crc32c_py(record) for record in read_tfrecord(path, verify_crc=False)]


def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def write_jpeg_records(out_dir: str, source) -> tuple[list, list]:
    """Phase 13's records through the port's writer: record i holds the
    bytes of fixture ``label % n_fixtures``, ``source``'s token pattern of
    its label, its label and index. Returns the shards and the JPEG bytes
    of each record."""
    import glob

    import numpy as np

    from mmlearn_tpu_torch.datasets.core.tfrecord import encode_tf_example, write_tfrecord

    fixtures = []
    for path in sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.jpg"))):
        with open(path, "rb") as f:
            fixtures.append(f.read())
    check(len(fixtures) >= 8, f"{len(fixtures)} JPEG fixtures under {FIXTURE_DIR}")
    jpegs = [fixtures[int(k) % len(fixtures)] for k in source.labels[:RECORDS]]
    per_shard = RECORDS // RECORD_SHARDS
    shards = []
    t0 = time.perf_counter()
    for s in range(RECORD_SHARDS):
        shards.append(os.path.join(out_dir, f"jpeg-{s:05d}.tfrecord"))
        write_tfrecord(shards[-1], (encode_tf_example({
            "jpeg": jpegs[i], "tokens": source.tokens[source.labels[i]],
            "label": int(source.labels[i]), "index": i})
            for i in range(s * per_shard, (s + 1) * per_shard)))
    total = sum(os.path.getsize(p) for p in shards)
    print(f"record path: {RECORDS} records of {len(fixtures)} JPEG fixtures (mean "
          f"{np.mean([len(f) for f in fixtures]):,.0f} B) written in {RECORD_SHARDS} shards, "
          f"{total:,} B, in {time.perf_counter() - t0:.1f} s")
    return shards, jpegs


def record_checks(shards: list, jpegs: list, source) -> None:
    """Every record read back through ``TFRecordDataset(verify_crc=True)``
    equal to what was written; the native CRC-32C of each record equal to
    the Python table's (computed in one process a shard); and
    ``StreamingDataset`` over the shards for ranks 0-3 of world 4: disjoint,
    covering every record once in each of 2 epochs, the epochs in
    different orders."""
    import functools
    import multiprocessing

    import numpy as np

    from mmlearn_tpu_torch import native
    from mmlearn_tpu_torch.datasets.core import StreamingDataset, TFRecordDataset
    from mmlearn_tpu_torch.datasets.core.tfrecord import read_tfrecord, tfrecord_open_shard

    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            min(RECORD_SHARDS, host_cores()),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        python_crcs = pool.map(_python_crcs, shards)
        ds = TFRecordDataset(shards, verify_crc=True)
        check(len(ds) == RECORDS, f"{len(ds)} records read back, want {RECORDS}")
        bad = []
        for i in range(RECORDS):
            ex, label = ds[i], source.labels[i]
            if not (ex["jpeg"] == [jpegs[i]] and int(ex["label"][0]) == label
                    and int(ex["index"][0]) == i
                    and np.array_equal(ex["tokens"], source.tokens[label])):
                bad.append(i)
        read_s = time.perf_counter() - t0
        native_crcs = [native.crc32c(r) for p in shards for r in read_tfrecord(p)]
        python_crcs = [c for shard in python_crcs for c in shard]
    agree = sum(a == b for a, b in zip(native_crcs, python_crcs))
    print(f"record path: {RECORDS - len(bad)} of {RECORDS} records read back through "
          f"TFRecordDataset(verify_crc=True) equal to what was written ({read_s:.1f} s); "
          f"native CRC-32C equal to the Python table's on {agree} of {len(python_crcs)} records "
          f"({time.perf_counter() - t0:.1f} s with {min(RECORD_SHARDS, host_cores())} processes)")
    check(not bad, f"records {bad[:10]} differ from what was written")
    check(len(native_crcs) == RECORDS and native_crcs == python_crcs,
          "the native CRC-32C differs from the Python table's")

    t0 = time.perf_counter()
    open_shard = functools.partial(tfrecord_open_shard, to_example=_record_index)
    epochs = []
    for epoch in range(2):
        streams = []
        for rank in range(STREAM_WORLD):
            stream = StreamingDataset(shards, open_shard, shuffle_buffer=STREAM_BUFFER, seed=SEED,
                                      rank=rank, world_size=STREAM_WORLD)
            stream.set_epoch(epoch)
            streams.append(list(stream))
        flat = [i for s in streams for i in s]
        ok = sorted(flat) == list(range(RECORDS))
        print(f"record path: StreamingDataset epoch {epoch}, ranks 0-{STREAM_WORLD - 1} of "
              f"{STREAM_WORLD}: {[len(s) for s in streams]} records, every record once: {ok}")
        check(ok, f"epoch {epoch}'s streams are not a partition of the records")
        epochs.append(streams)
    check(all(a != b for a, b in zip(*epochs)), "a rank's 2 epochs come in the same order")
    print(f"record path: the 2 epochs come in different orders on every rank "
          f"({time.perf_counter() - t0:.1f} s)")


def decode_checks(jpegs: list) -> None:
    """The first ``DECODE_RECORDS`` records at 224 px on the eval path and
    the train path under their record seeds: the batch decode equal bit for
    bit to the per-image decode, the train decode repeated under the same
    seeds, no image failed (the per-image decode raises on a failure). Then
    the train path's rate with 1 thread, 4, and every core this process may
    use."""
    import numpy as np

    from mmlearn_tpu_torch import native
    from mmlearn_tpu_torch.flagship import IMAGE_SIZE

    batch = jpegs[:DECODE_RECORDS]
    seeds = [record_seed(i) for i in range(DECODE_RECORDS)]
    cores = host_cores()
    train = native.decode_jpeg_batch_train(batch, IMAGE_SIZE, seeds, n_threads=cores)
    evals = native.decode_jpeg_batch(batch, IMAGE_SIZE, n_threads=cores)
    same_train = all(np.array_equal(train[i], native.decode_jpeg_train(d, IMAGE_SIZE, seed=s))
                     for i, (d, s) in enumerate(zip(batch, seeds)))
    same_eval = all(np.array_equal(evals[i], native.decode_jpeg(d, IMAGE_SIZE))
                    for i, d in enumerate(batch))
    again = np.array_equal(train, native.decode_jpeg_batch_train(batch, IMAGE_SIZE, seeds,
                                                                  n_threads=4))
    print(f"record path: decode of {DECODE_RECORDS} records at {IMAGE_SIZE} px: the batch "
          f"equals the per-image decode bit for bit, train {same_train}, eval {same_eval}; the "
          f"train decode repeats under the same seeds: {again}; no decode failed")
    check(same_train and same_eval and again, "the batch decode differs")
    rates = {}
    for threads in sorted({1, 4, cores}):
        native.decode_jpeg_batch_train(batch[:16], IMAGE_SIZE, seeds[:16], n_threads=threads)
        t0 = time.perf_counter()
        native.decode_jpeg_batch_train(batch, IMAGE_SIZE, seeds, n_threads=threads)
        rates[threads] = DECODE_RECORDS / (time.perf_counter() - t0)
    print(f"record path: train-path decode at {IMAGE_SIZE} px, images/s by threads: " + ", ".join(
        f"{t} {r:.1f}" for t, r in rates.items()) + f" (host cores {os.cpu_count()}, this "
          f"process may use {cores}; {BATCH / rates[1] * 1e3:.0f} ms of one core a b{BATCH} batch)")


def record_fit(master, device, dataset, reference, label: str, processes: bool):
    """``input_fit`` (phase 10's protocol and checks) on ``dataset``
    through the thread loader or, with ``processes``, the process loader;
    every process it starts is stopped at its end. Returns the launch
    counts and pairs/s."""
    from mmlearn_tpu_torch.datasets.core.grain_loader import GrainDataLoader

    if processes:
        loader = GrainDataLoader(dataset, batch_size=BATCH, shuffle=True, seed=SEED,
                                 drop_last=True, num_workers=RECORD_PROCESSES)
    else:
        loader = input_loader(dataset)
    counts, rate, _ = input_fit(master, device, loader, label, integrity=True,
                                reference=reference)
    if processes:
        import multiprocessing

        loader.close()
        gc.collect()
        alive = multiprocessing.active_children()
        check(not alive, f"{len(alive)} loader workers still run after the fit")
    return counts, rate


def record_path(device) -> dict:
    """Phase 13, the record-fed path: the flagship trained on TFRecord
    shards of JPEGs (see ``write_jpeg_records``, ``record_checks``,
    ``decode_checks``), decoded and cropped by the port's fastloader in
    ``TFRecordDataset`` + ``ImageTransform(train=True,
    device_normalize=True)``, through (a) the thread loader and (b) the
    process loader, then on ``MaterializedDataset`` shards of the same
    images decoded once by ``materialize``: each fit 3 warm-up steps and 3
    timed windows of 10 (phase 10's protocol and checks, its 3 batches held
    to the host's own decode). On a host without libjpeg the decoders
    raise (checked), and the fits run on materialized uint8 records of
    ``Uint8Pairs`` instead, as a line of the output says. Everything
    written is removed at the end. Returns the fits' launch counts."""
    import shutil

    import numpy as np

    from mmlearn_tpu_torch import native
    from mmlearn_tpu_torch.datasets import MaterializedDataset, materialize
    from mmlearn_tpu_torch.datasets.builtin import ImageTransform
    from mmlearn_tpu_torch.datasets.core import TFRecordDataset
    from mmlearn_tpu_torch.flagship import IMAGE_SIZE, flagship_training_task

    root = os.path.join(WORK_DIR, "records")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "jpeg"))
    source = Uint8Pairs(SEED + 31)  # phase 10's classes and token patterns
    check(source.size == RECORDS, f"Uint8Pairs holds {source.size} pairs, want {RECORDS}")
    shards, jpegs = write_jpeg_records(os.path.join(root, "jpeg"), source)
    record_checks(shards, jpegs, source)

    jpeg = native.has_libjpeg()
    if jpeg:
        decode_checks(jpegs)
        transform = ImageTransform(size=IMAGE_SIZE, train=True, device_normalize=True)
        fits = [("JPEG records, thread loader",
                 TFRecordDataset(shards, to_example=JpegRecords(transform)), False),
                ("JPEG records, process loader",
                 TFRecordDataset(shards, to_example=JpegRecords(transform)), True)]

        def reference(idx):
            return native.decode_jpeg_batch_train(
                [jpegs[i] for i in idx], IMAGE_SIZE, [record_seed(int(i)) for i in idx],
                scale=transform.random_crop_scale, hflip_prob=transform.hflip_prob,
                n_threads=host_cores())

        def decoded(shard_idx, start, stop):
            images = reference(np.arange(start, stop))
            for i in range(start, stop):
                yield {"rgb": images[i - start], "text": source.tokens[source.labels[i]],
                       "example_index": i}

        t0 = time.perf_counter()
        packed = materialize(output_dir=os.path.join(root, "packed"), prefix="packed",
                             shard_size=RECORDS // RECORD_SHARDS, num_samples=RECORDS,
                             samples_for_shard=decoded)
    else:
        print("record path: NO LIBJPEG on this host (g++ cannot compile and link against "
              "jpeglib.h and -ljpeg): the JPEG decode checks and the JPEG fits are not run; "
              "the fits train on materialized uint8 records of Uint8Pairs instead")
        for decode in (lambda: native.decode_jpeg(jpegs[0], IMAGE_SIZE),
                       lambda: native.decode_jpeg_batch_train(jpegs[:2], IMAGE_SIZE, [1, 2])):
            try:
                decode()
                raised = ""
            except RuntimeError as err:
                raised = str(err)
            check("libjpeg" in raised, f"the decoder did not raise naming libjpeg: {raised!r}")
        print(f"record path: the port's decoders raise RuntimeError naming libjpeg: "
              f"{raised.splitlines()[0]!r}")
        fits = []

        def reference(idx):
            return np.stack([source[int(i)]["rgb"] for i in idx])

        t0 = time.perf_counter()
        packed = materialize(source, os.path.join(root, "packed"), prefix="packed",
                             shard_size=RECORDS // RECORD_SHARDS)
    print(f"record path: materialized {packed.num_samples} decoded images into "
          f"{len(packed.shards)} shards, {packed.num_bytes:,} B, in "
          f"{time.perf_counter() - t0:.1f} s")
    fits += [("materialized records, thread loader", MaterializedDataset(packed.shards), False),
             ("materialized records, process loader", MaterializedDataset(packed.shards), True)]

    t0 = time.perf_counter()
    master = flagship_training_task("cpu", seed=SEED)
    print(f"record path: flagship task built on the CPU in {time.perf_counter() - t0:.1f} s")
    launches, rates = {}, {}
    for name, dataset, processes in fits:
        t0 = time.perf_counter()
        counts, rates[name] = record_fit(master, device, dataset, reference, f" ({name})",
                                         processes)
        print(f"record path ({name}): fit done in {time.perf_counter() - t0:.1f} s")
        for key, count in counts.items():
            launches[key] = launches.get(key, 0) + count
    print("record path: pairs/s " + "; ".join(
        f"{name} {rate:.1f} ({rate / FIT_RATES['']:.4f} x phase 5)"
        for name, rate in rates.items()) + f"; host cores {host_cores()}")
    del master
    shutil.rmtree(root)
    return launches


# ------------------------------------------------------------ the BIOSCAN-CLIP path

# phase 14: the BIOSCAN-CLIP trimodal recipe at bioscan_1m.yaml's widths
# (mmlearn_tpu_torch.projects.bioscan_clip.recipe): b400 (the YAML's), 16
# distinct batches a pass of 64 classes, two passes under remat in bf16. The
# repo holds no BIOSCAN text length: the text tower takes Lt = 20 tokens,
# 6-20 of them valid (right padding), with token types; the dna tower 133
# (CLS and the 132 5-mers of a 660-base barcode, dna_tokenizer.py:61-63 with
# dataset.py:69's max_length=660), unmasked, as the project's dataset gives
# them
BIOSCAN_BATCH, BIOSCAN_PASS, BIOSCAN_CLASSES = 400, 16, 64
BIOSCAN_TEXT, BIOSCAN_MIN_TEXT, BIOSCAN_BARCODE = 20, 6, 660
# the fit's 3 timed windows of 6 steps, each inside one pass: steps 5-10 and
# 11-16 of pass 1 after 4 warm-up steps, 21-26 of pass 2 after 4 past the
# loader's restart at its first batch (step 17)
BIOSCAN_WINDOW = 6
BIOSCAN_MARKS = ((4, 10), (10, 16), (20, 26))
BIOSCAN_STEPS = 2 * BIOSCAN_PASS  # 32: two passes
# the b factors of the step parity's copy: N(0, 0.02) from a seed, so the
# card and the CPU compute the LoRA'd forward and backward at a live delta
BIOSCAN_PARITY_B_STD = 0.02
# the kernels' new instances, checked at batch 8 and timed at b400: K1 on
# the dna tower (N=133, H=12) without and with a ragged key mask and on the
# text tower (N=20, H=8, ragged), K2's add+LayerNorm at the towers' widths
BIOSCAN_NORM_GRIDS = (("B=400 N=20 C=512", BIOSCAN_BATCH, BIOSCAN_TEXT, 512),
                      ("B=400 N=133 C=768", BIOSCAN_BATCH, 133, 768))
# the taxonomic kNN on the card: keys and two query splits of synthetic
# 768-d embeddings per modality (queries: noisy copies of keys)
BIOSCAN_KEYS, BIOSCAN_QUERIES, BIOSCAN_TOPK = 4096, 1024, (1, 5)
# bert-small's geometry as an HF config mapping, for the export round trip
BERT_SMALL = dict(vocab_size=30522, max_position_embeddings=512, hidden_size=512,
                  num_hidden_layers=4, num_attention_heads=8, intermediate_size=2048,
                  layer_norm_eps=1e-12)


def bioscan_state_dicts(seed: int) -> tuple[dict, dict, dict]:
    """Seeded random state dicts under the public checkpoints' key names and
    shapes: timm ``vit_base_patch16_224`` (its head cut to the 768-d
    projection, as the recipe's ``num_classes=projection_dim``), HF
    ``BertModel`` of ``prajjwal1/bert-small``'s geometry (vocabulary 30,522,
    512 positions, with its pooler) and ``BertForMaskedLM`` of BarcodeBERT's
    (vocabulary 1,027, 256 positions, width 768, 12 layers; the MLM decoder
    over the vocabulary)."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    def norm(sd, key, c):
        sd[f"{key}.weight"] = 1 + w(c)
        sd[f"{key}.bias"] = w(c)

    def linear(sd, key, n_out, n_in):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = w(n_out, n_in), w(n_out)

    timm = {"cls_token": w(1, 1, 768), "pos_embed": w(1, 197, 768),
            "patch_embed.proj.weight": w(768, 3, 16, 16), "patch_embed.proj.bias": w(768)}
    for i in range(12):
        p = f"blocks.{i}"
        norm(timm, f"{p}.norm1", 768)
        norm(timm, f"{p}.norm2", 768)
        linear(timm, f"{p}.attn.qkv", 3 * 768, 768)
        linear(timm, f"{p}.attn.proj", 768, 768)
        linear(timm, f"{p}.mlp.fc1", 3072, 768)
        linear(timm, f"{p}.mlp.fc2", 768, 3072)
    norm(timm, "norm", 768)
    linear(timm, "head", 768, 768)

    def bert(sd, prefix, vocab, positions, c, depth):
        sd[f"{prefix}embeddings.word_embeddings.weight"] = w(vocab, c)
        sd[f"{prefix}embeddings.position_embeddings.weight"] = w(positions, c)
        sd[f"{prefix}embeddings.token_type_embeddings.weight"] = w(2, c)
        norm(sd, f"{prefix}embeddings.LayerNorm", c)
        for i in range(depth):
            p = f"{prefix}encoder.layer.{i}"
            for name in ("query", "key", "value"):
                linear(sd, f"{p}.attention.self.{name}", c, c)
            linear(sd, f"{p}.attention.output.dense", c, c)
            norm(sd, f"{p}.attention.output.LayerNorm", c)
            linear(sd, f"{p}.intermediate.dense", 4 * c, c)
            linear(sd, f"{p}.output.dense", c, 4 * c)
            norm(sd, f"{p}.output.LayerNorm", c)
        return sd

    text = bert({}, "", 30522, 512, 512, 4)
    linear(text, "pooler.dense", 512, 512)
    mlm = bert({}, "bert.", 1027, 256, 768, 12)
    linear(mlm, "cls.predictions.transform.dense", 768, 768)
    norm(mlm, "cls.predictions.transform.LayerNorm", 768)
    linear(mlm, "cls.predictions.decoder", 1027, 768)
    return timm, text, mlm


def bioscan_master(seed: int):
    """The recipe's task on the CPU (bf16 compute, f32 weights, remat, the
    one-cycle schedule over ``BIOSCAN_STEPS``) with the towers' weights from
    :func:`bioscan_state_dicts` through the port's converters; the LoRA
    factors from the seed. The text tower has no pooler (mean pooling), so
    the checkpoint's pooler is not loaded; the dna tower's MLM decoder (over
    the vocabulary) is replaced by the projection, which keeps its
    initialisation (the reference's swap)."""
    from mmlearn_tpu_torch.hf_utils import convert_bert, convert_timm_vit, timm_vit_geometry
    from mmlearn_tpu_torch.projects.bioscan_clip import recipe
    from mmlearn_tpu_torch.projects.bioscan_clip.encoders import load_barcode_bert_checkpoint

    timm, text, mlm = bioscan_state_dicts(seed)
    geo = timm_vit_geometry(timm, num_heads=12)
    want = {k: recipe.RGB[k] for k in ("img_size", "patch_size", "embed_dim", "depth",
                                         "num_heads", "mlp_ratio")}
    check({k: geo[k] for k in want} == want, f"timm geometry {geo}, want {want}")
    task = recipe.bioscan_task(total_steps=BIOSCAN_STEPS, dtype="bfloat16", remat=True,
                               device="cpu", seed=seed)
    enc = task.encoders
    enc["rgb"].load_state_dict(convert_timm_vit(timm, num_heads=12), strict=True)
    converted = convert_bert(text, 4, num_heads=8)
    enc["text"].load_state_dict({k: v for k, v in converted.items()
                                 if not k.startswith("pooler.")}, strict=True)
    missing, unexpected = enc["dna"].load_state_dict(
        load_barcode_bert_checkpoint(mlm, 12, 768, num_heads=12), strict=False)
    check(not unexpected and sorted(missing) == ["decoder.bias", "decoder.weight"],
          f"BarcodeBERT checkpoint: missing {missing}, unexpected {unexpected}")
    return task


class BioscanTriples:
    """Phase 14's map-style source: ``BIOSCAN_BATCH * BIOSCAN_PASS``
    image-DNA-text triples from ``seed`` in ``BIOSCAN_CLASSES`` classes:
    class k's uint8 NHWC image pattern rolled along the width by the index,
    its 660-base barcode with the base at ``index % 660`` changed,
    tokenized by the port's ``DNAProcessor`` (133 tokens), and its taxonomy
    text of ``BIOSCAN_TEXT`` token ids with 6-20 valid (right padding) and
    the second half of the valid ones in segment 1."""

    all_map_style = True

    def __init__(self, seed: int) -> None:
        import numpy as np

        from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor

        rng = np.random.default_rng(seed)
        self.size = BIOSCAN_BATCH * BIOSCAN_PASS
        self.labels = rng.integers(0, BIOSCAN_CLASSES, self.size)
        self.patterns = rng.integers(0, 256, (BIOSCAN_CLASSES, 224, 224, 3), dtype=np.uint8)
        self.barcodes = ["".join(rng.choice(list("ACGT"), BIOSCAN_BARCODE))
                         for _ in range(BIOSCAN_CLASSES)]
        self.dna = DNAProcessor(max_length=BIOSCAN_BARCODE)
        lens = rng.integers(BIOSCAN_MIN_TEXT, BIOSCAN_TEXT + 1, BIOSCAN_CLASSES)
        pos = np.arange(BIOSCAN_TEXT)[None]
        self.mask = (pos < lens[:, None]).astype(np.int32)
        self.types = ((pos >= lens[:, None] // 2) & (self.mask > 0)).astype(np.int32)
        tokens = rng.integers(1000, 30522, (BIOSCAN_CLASSES, BIOSCAN_TEXT)).astype(np.int32)
        tokens[:, 0] = 101  # [CLS]
        self.tokens = np.where(self.mask > 0, tokens, 0).astype(np.int32)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        import numpy as np

        from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
        from mmlearn_tpu_torch.datasets.core import Example

        k, idx = self.labels[idx], int(idx)
        code = self.barcodes[k]
        at = idx % BIOSCAN_BARCODE
        code = code[:at] + "ACGT"[("ACGT".index(code[at]) + 1) % 4] + code[at + 1:]
        return Example({"rgb": np.roll(self.patterns[k], idx % 16, axis=1),
                        "dna": self.dna(code), "text": self.tokens[k],
                        "text_attention_mask": self.mask[k],
                        "text_token_type_ids": self.types[k], EXAMPLE_INDEX_KEY: idx})


def bioscan_kernel_checks(device, err: dict) -> dict:
    """The kernels' new instances on the BIOSCAN path: K1 forward and
    backward against their plain versions at batch 8 (the dna grid N=133,
    H=12 unmasked and under a ragged key mask of 20-133 keys; the text grid
    N=20, H=8 under a ragged mask of 6-20 keys) at K1's limits, element-wise
    and as a whole; K2's add+LayerNorm at C=512 and C=768 at BERT's epsilon
    1e-12 (forward and backward, dgamma/dbeta against f64) at batch 8; then
    each K1 instance timed at b400 beside its plain version, SDPA (the
    library call) and its bound, and K2 at b400 by :func:`norms_at_batch`.
    The largest errors join ``err``; returns the timed rows."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import fused_attention as fa
    from mmlearn_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    rows = {}

    def ragged(b, n, low):
        lens = torch.randint(low, n + 1, (b, 1), generator=gen, device=device)
        return torch.arange(n, device=device)[None] < lens

    cases = (("dna", 133, 12, None), ("dna ragged mask", 133, 12, 20),
             ("text ragged mask", BIOSCAN_TEXT, 8, BIOSCAN_MIN_TEXT))
    for b in (8, BIOSCAN_BATCH):
        for label, n, h, low in cases:
            d, scale = 64, 0.125
            mask = None if low is None else ragged(b, n, low)
            qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device).bfloat16()
            dout = torch.randn(b, n, h * d, generator=gen, device=device).bfloat16()
            out = fa._fused_mha_cuda(qkv, mask, h, scale, False)
            dqkv = fa._fused_mha_bwd_cuda(qkv, mask, out, dout, h, scale, False)
            torch.cuda.synchronize()
            if b == 8:
                k1_check(f"bioscan {label} B={b} N={n} H={h} D={d} bf16", qkv, mask, h, False,
                         out, dqkv, dout, err)
                continue
            pairs = attention_pairs(b, n, mask, False)
            q, k, v = (t.contiguous().requires_grad_() for t in
                       qkv.view(b, n, h, 3, d).permute(3, 0, 2, 1, 4).unbind(0))
            kw = {} if mask is None else {"attn_mask": mask[:, None, None, :]}
            lib_out = F.scaled_dot_product_attention(q, k, v, **kw)
            lib_dout = dout.view(b, n, h, d).transpose(1, 2).contiguous()
            tag = f"bioscan {label} B={b} N={n} H={h}"
            timed = {
                f"K1f {tag}": (
                    cuda_ms(lambda: fa.fused_mha(qkv, mask, num_heads=h)),
                    cuda_ms(lambda: fa.mha_reference(qkv, mask, h, scale, False)),
                    cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw)),
                    *bound(nbytes(qkv, out, mask), 4 * h * d * pairs, "bfloat16")),
                f"K1b {tag}": (
                    cuda_ms(lambda: fa._fused_mha_bwd_cuda(qkv, mask, out, dout, h, scale,
                                                           False)),
                    cuda_ms(lambda: fa.mha_bwd_reference(qkv, mask, out, dout, h, scale, False),
                            iters=5),
                    cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), lib_dout,
                                                        retain_graph=True)),
                    *bound(nbytes(qkv, out, dout, qkv, mask), 10 * h * d * pairs, "bfloat16")),
            }
            print_times(timed)
            rows.update(timed)
            del q, k, v, lib_out, lib_dout
    ln_fwd, ln_bwd = tol("layernorm_fwd", "bfloat16"), tol("layernorm_bwd", "bfloat16")
    for n, c in ((BIOSCAN_TEXT, 512), (133, 768)):
        x, br, dy = (torch.randn(8, n, c, generator=gen, device=device).bfloat16()
                     for _ in range(3))
        g = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
        beta = 0.1 * torch.randn(c, generator=gen, device=device)
        tag = f"bioscan add+layernorm B=8 N={n} C={c} eps=1e-12 bf16"
        r, y = fn.fused_add_layernorm(x, br, g, beta, eps=1e-12)
        got = fn._launch_bwd(r, g, dy, 1e-12, torch.zeros_like(dy))
        want = fn.ln_bwd_reference(r, g, dy, 1e-12, torch.zeros_like(dy))
        sums = ln_sums_f64(r, dy, 1e-12)
        err["layernorm_fwd"] = max(err["layernorm_fwd"],
                                   compare(f"K2f {tag} r", r, x + br, R_TOL),
                                   compare(f"K2f {tag} y", y,
                                           fn.ln_reference(x + br, g, beta, 1e-12), ln_fwd))
        err["layernorm_bwd"] = max(err["layernorm_bwd"],
                                   compare(f"K2b {tag} dx", got[0], want[0], ln_bwd),
                                   compare(f"K2b {tag} dgamma against f64", got[1], sums[0],
                                           SUM_F64_TOL),
                                   compare(f"K2b {tag} dbeta against f64", got[2], sums[1],
                                           SUM_F64_TOL))
    rows.update(norms_at_batch(device, err, BIOSCAN_NORM_GRIDS, SEED + 71))
    return rows


def bioscan_batch(dataset, indices, device, dtype):
    """The examples ``indices`` of ``dataset`` collated, the uint8 images
    normalized in f32 (CLIP's statistics) and cast to ``dtype``, on
    ``device``."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.datasets.core import DefaultDataCollator
    from mmlearn_tpu_torch.datasets.processors import CLIP_MEAN, CLIP_STD

    batch = DefaultDataCollator()([dataset[i] for i in indices])
    out = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
    x = out["rgb"].float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=device)
    std = torch.tensor(CLIP_STD, device=device)
    out["rgb"] = ((x - mean) / std).to(dtype)
    return out


def bioscan_trainable(task) -> set:
    """The names the JAX task's ``_trainable_mask`` (contrastive_pretraining.py
    :280-303) leaves trainable under the recipe's configs, by its rule: every
    LoRA factor, each LoRA'd tower's ``modules_to_save`` (the rgb tower's
    ``proj``, the dna tower's ``decoder``), the head and the logit scale
    (tests/test_torch_peft.py holds the port's sets to that mask itself)."""
    keep = ("lora.", "encoders.rgb.proj.", "encoders.dna.decoder.", "heads.")
    return {n for n, _ in task.named_parameters()
            if n.startswith(keep) or n == "log_logit_scale"}


def bioscan_step_parity(master, device) -> None:
    """One step's loss and gradients at batch 8 on the card (bf16, the
    kernels) against an f32 copy on the CPU (the plain versions), on a copy
    of ``master`` whose ``b`` factors are drawn from N(0,
    ``BIOSCAN_PARITY_B_STD``) (at init they are 0, the delta with them):
    the loss within ``LOSS_RTOL`` and every trainable tensor's gradient, each
    ``a`` factor's included, at cosine ``MIN_GRAD_COSINE``; every ``a``
    gradient nonzero on both sides."""
    import torch

    from mmlearn_tpu_torch.projects.bioscan_clip import recipe

    data = BioscanTriples(SEED + 72)
    losses, grads = {}, {}
    live = copy.deepcopy(master)
    gen = torch.Generator().manual_seed(SEED + 76)
    with torch.no_grad():
        for name, p in live.lora.named_parameters():
            if name.endswith(".b"):
                p.normal_(0.0, BIOSCAN_PARITY_B_STD, generator=gen)
        qkv = live.encoders["rgb"].blocks[0].attn.qkv
        delta = float((qkv.merged_weight() - qkv.weight).norm() / qkv.weight.norm())
    print(f"bioscan path: step parity on live LoRA deltas (b ~ N(0, {BIOSCAN_PARITY_B_STD}); "
          f"the image tower's first qkv: |delta| / |W0| = {delta:.4f})")
    cpu = recipe.bioscan_task(total_steps=BIOSCAN_STEPS, dtype="float32", device="cpu")
    cpu.load_state_dict(live.state_dict(), strict=True)
    for where, task, dev, dtype in (("card", live.to(device), device, torch.bfloat16),
                                    ("cpu", cpu, torch.device("cpu"), torch.float32)):
        t0 = time.perf_counter()
        task.train()
        loss, _ = task.loss_fn(bioscan_batch(data, range(PARITY_BATCH), dev, dtype))
        loss.backward()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()
                        if p.requires_grad}
        print(f"bioscan path: step b={PARITY_BATCH} on the {where}: loss {losses[where]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
        del task
    del live
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    a_cos = [c for n, c in cos.items() if n.startswith("lora.") and n.endswith(".a")]
    a_zero = [n for n in cos if n.startswith("lora.") and n.endswith(".a")
              and not (bool(grads["card"][n].any()) and bool(grads["cpu"][n].any()))]
    print(f"bioscan path: step parity b={PARITY_BATCH}, card (bf16) vs f32 CPU copy: loss rel "
          f"diff {rel:.3e} (tol {LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} at {worst}, "
          f"median {statistics.median(cos.values()):.6f} over {len(cos)} trainable tensors, "
          f"min {min(a_cos):.6f} over the {len(a_cos)} a factors, {len(a_zero)} of them zero "
          f"(bound {MIN_GRAD_COSINE})")
    check(rel <= LOSS_RTOL, f"bioscan loss on the card {losses['card']} vs CPU {losses['cpu']}")
    check(cos[worst] >= MIN_GRAD_COSINE, f"bioscan gradient of {worst}: cosine {cos[worst]}")
    check(a_cos and not a_zero, f"bioscan parity: a gradients zero at a live delta: {a_zero[:6]}")


def bioscan_launches(task) -> dict:
    """Launches a step under remat: per block (ViT-B/16 12, the text tower
    4, the dna tower 12) K1f twice (its forward and its recompute), K1b's
    two kernels once, K2f four times, K2b twice -- but once in the image
    tower's first block: its first norm's input (the frozen patch and
    position embeddings) and weights are all frozen, so autograd asks that
    norm for no gradient."""
    enc = task.encoders
    depth = len(enc["rgb"].blocks) + len(enc["text"].blocks) + len(enc["dna"].bert.blocks)
    return {"fused_mha_fwd": 2 * depth, "fused_mha_bwd": 2 * depth, "fused_mha_packed_fwd": 0,
            "fused_mha_packed_bwd": 0, "layernorm_fwd": 4 * depth,
            "layernorm_bwd": 2 * depth - 1, "int8_qmm": 0, "int8_qmm_bytes": 0, **NO_FLASH}


class BioscanProbe(InputProbe):
    """Phase 14's probe: phase 10's clock and feeder waits at ``marks``, and
    ``after_first`` after step 1 (its gradients still in place), before the
    clock is read."""

    def __init__(self, marks, after_first) -> None:
        super().__init__(marks)
        self.label = f"bioscan path: fit b{BIOSCAN_BATCH}"
        self.after_first = after_first

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        if step == 1:
            self.after_first()
        super().on_train_batch_end(trainer, metrics, step)


def bioscan_fit(task, device) -> dict:
    """``Trainer.fit`` of the recipe at b400 on ``BioscanTriples`` through
    the ``DataLoader`` (8 threads) and the trainer's feeder, uint8 images
    normalized on the card, every count set to 0 first: ``BIOSCAN_STEPS``
    steps (two passes), timed over the windows ``BIOSCAN_MARKS``. Checks
    the launches a step exactly, the trainable set by name, at step 1 every
    ``b`` gradient nonzero and every ``a`` gradient exactly 0, every frozen
    parameter bit-equal to its start at the end, the loss finite and its
    mean over the second pass below the first's. Prints triples/s, ms a
    step, the counted FLOPs (the LoRA merges' products included), MFU and
    peak memory. Returns the launches."""
    import math

    import torch

    from mmlearn_tpu_torch.datasets.core import DataLoader
    from mmlearn_tpu_torch.trainer import Trainer
    from mmlearn_tpu_torch.trainer.flops import device_peak_tflops

    trainable = {n for n, p in task.named_parameters() if p.requires_grad}
    want_set = bioscan_trainable(task)
    print(f"bioscan path: {len(trainable)} trainable tensors "
          f"({sum(p.numel() for p in task.parameters() if p.requires_grad):,} of "
          f"{sum(p.numel() for p in task.parameters()):,} parameters); the JAX mask's set: "
          f"{'equal' if trainable == want_set else 'DIFFERENT'}")
    check(trainable == want_set, f"trainable set differs from the JAX mask's: extra "
          f"{sorted(trainable - want_set)[:6]}, missing {sorted(want_set - trainable)[:6]}")
    frozen = {n: p.detach().clone() for n, p in task.named_parameters() if not p.requires_grad}
    first = {}

    def first_grads():
        a = {n: p.grad for n, p in task.named_parameters()
             if n.startswith("lora.") and n.endswith(".a")}
        b = {n: p.grad for n, p in task.named_parameters()
             if n.startswith("lora.") and n.endswith(".b")}
        first["a_nonzero"] = [n for n, g in a.items() if g is None or bool(g.any())]
        first["b_zero"] = [n for n, g in b.items() if g is None or not bool(g.any())]
        first["counts"] = (len(a), len(b))
        bad, zero = _bad_grads((n, p) for n, p in task.named_parameters() if p.requires_grad)
        first["bad"] = bad + [n for n in zero if not n.endswith(".a")]

    loader = DataLoader(BioscanTriples(SEED + 73), batch_size=BIOSCAN_BATCH, shuffle=True,
                        seed=SEED, drop_last=True, num_workers=INPUT_WORKERS)
    probe = BioscanProbe({m for w in BIOSCAN_MARKS for m in w}, first_grads)
    trainer = Trainer(max_steps=BIOSCAN_STEPS, log_every_n_steps=BIOSCAN_STEPS, device=device,
                      log_mfu=True, device_normalize=input_normalize(), callbacks=[probe])
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = trainer.fit(task, loader)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, dims = launch_counts(), head_dim_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = bioscan_launches(task)
    print(f"{probe.label}: {state.step} steps ({fit_s:.1f} s) launched " + ", ".join(
        f"{k} {v} ({v / state.step:g} a step, want {want[k]})" for k, v in counts.items())
          + f"; by head dim {dims}")
    check(state.step == BIOSCAN_STEPS, f"bioscan fit took {state.step} steps")
    check(counts == {k: v * state.step for k, v in want.items()},
          f"bioscan fit launches {counts}, want {want} a step")
    check(dims == {("fused_mha_fwd", 64): want["fused_mha_fwd"] * state.step,
                   ("fused_mha_bwd", 64): want["fused_mha_bwd"] * state.step},
          f"bioscan fit launches by head dim {dims}")
    n_a, n_b = first["counts"]
    print(f"bioscan path: step 1 LoRA gradients: {n_a - len(first['a_nonzero'])} of {n_a} "
          f"a factors exactly 0, {n_b - len(first['b_zero'])} of {n_b} b factors nonzero; other "
          f"trainable gradients missing, non-finite or zero: {first['bad'][:6]}")
    enc = task.encoders
    n_qkv = len(enc["rgb"].blocks) + 2 * len(enc["text"].blocks) + 2 * len(enc["dna"].bert.blocks)
    check(n_a == n_b == n_qkv and not first["a_nonzero"] and not first["b_zero"]
          and not first["bad"], f"bioscan step-1 gradients: a nonzero {first['a_nonzero'][:6]}, "
          f"b zero {first['b_zero'][:6]}, bad {first['bad'][:6]}")
    moved = [n for n, p in task.named_parameters() if not p.requires_grad
             and not torch.equal(p.detach(), frozen[n])]
    print(f"bioscan path: frozen tensors bit-equal to their start: "
          f"{len(frozen) - len(moved)} of {len(frozen)}")
    check(not moved, f"frozen weights moved: {moved[:6]}")
    losses = [h["loss"] for h in trainer.history]
    passes = [statistics.mean(losses[:BIOSCAN_PASS]), statistics.mean(losses[BIOSCAN_PASS:])]
    print(f"bioscan path: loss step 0 {losses[0]:.6f}, step {len(losses) - 1} {losses[-1]:.6f}; "
          f"mean over pass 1 {passes[0]:.6f}, pass 2 {passes[1]:.6f}; lr "
          f"{trainer.history[0]['lr']:.4e} -> {trainer.history[-1]['lr']:.4e}; logit scale "
          f"{trainer.history[-1]['logit_scale']:.4f}")
    check(all(math.isfinite(x) for x in losses) and passes[1] < passes[0],
          f"bioscan losses {losses}")
    window_s = [probe.times[b] - probe.times[a] for a, b in BIOSCAN_MARKS]
    rates = [BIOSCAN_BATCH * BIOSCAN_WINDOW / w for w in window_s]
    median = statistics.median(rates)
    ms = statistics.median(window_s) / BIOSCAN_WINDOW * 1e3
    flops = trainer._step_flops
    tflops = flops / (ms / 1e3) / 1e12
    peak = device_peak_tflops(device)
    waits = [probe.waits[b] - probe.waits[a] for a, b in BIOSCAN_MARKS]
    print(f"{probe.label} bf16 remat: {median:.1f} triples/s median of {len(BIOSCAN_MARKS)} "
          f"windows of {BIOSCAN_WINDOW} steps inside a pass (windows {', '.join(f'{r:.1f}' for r in rates)}; spread "
          f"{(max(rates) - min(rates)) / median:.2%}), {ms:.2f} ms a step, the step's wait on "
          f"the feeder {statistics.median(waits) / BIOSCAN_WINDOW * 1e3:.2f} ms a step, peak "
          f"memory {peak_gb:.2f} GB; {flops:.6e} FLOPs a step counted (the recompute and the "
          f"LoRA merges included), {tflops:.1f} TFLOP/s, MFU "
          f"{'not in the table' if peak is None else f'{tflops / peak:.2%} of {peak:g}'}")
    return counts


class _EmbeddingRuntime:
    """What :class:`TaxonomicClassification` needs of an ``EvalRuntime``: an
    ``encode`` that gives the batch's own embedding rows, L2-normalized in
    f32, on the card."""

    def encode(self, batch, modality, normalize=False):
        from mmlearn_tpu_torch.modules.layers.normalization import l2_normalize

        out = batch[modality]
        return l2_normalize(out.float()) if normalize else out


def taxonomic_checks(device) -> None:
    """``TaxonomicClassification`` on the card over synthetic embeddings:
    ``BIOSCAN_KEYS`` keys and two query splits of ``BIOSCAN_QUERIES`` (each
    query a copy of a key plus noise, taking that key's taxonomy or, for a
    quarter of them, another's) of 768-d rgb, dna and text rows, in batches
    of 400 with the splits mixed; every reported accuracy (four query/key
    combinations, top-1 and top-5, micro and macro, four levels) equal to
    its evaluation in f64 on the CPU from the same rows (ties to the lower
    key row, as the port's top-k)."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.projects.bioscan_clip.eval_task import (
        LEVELS,
        TaxonomicClassification,
        top_k_macro_accuracy,
        top_k_micro_accuracy,
    )

    rng = np.random.default_rng(SEED + 74)
    taxa = [{lv: f"{lv}{i % n}" for lv, n in zip(LEVELS, (4, 16, 64, 256))}
            for i in rng.integers(0, 1 << 20, BIOSCAN_KEYS)]
    keys = {m: rng.standard_normal((BIOSCAN_KEYS, 768)).astype(np.float32)
            for m in ("rgb", "dna", "text")}
    rows, labels, splits = {m: [keys[m]] for m in keys}, list(taxa), ["all_keys"] * BIOSCAN_KEYS
    for split in ("val_seen", "val_unseen"):
        src = rng.integers(0, BIOSCAN_KEYS, BIOSCAN_QUERIES)
        for m in keys:
            rows[m].append(keys[m][src] + 0.8 * rng.standard_normal((BIOSCAN_QUERIES, 768))
                           .astype(np.float32))
        other = rng.integers(0, BIOSCAN_KEYS, BIOSCAN_QUERIES)
        swap = rng.random(BIOSCAN_QUERIES) < 0.25
        labels += [taxa[o] if s else taxa[i] for i, o, s in zip(src, other, swap)]
        splits += [split] * BIOSCAN_QUERIES
    rows = {m: np.concatenate(v) for m, v in rows.items()}
    order = rng.permutation(len(splits))
    hook = TaxonomicClassification(
        top_k=BIOSCAN_TOPK, print_table=False,
        report_combos=(("rgb", "dna"), ("averaged", "averaged"),
                       ("concatenated", "concatenated"), ("rgb", "all_key")))
    runtime = _EmbeddingRuntime()
    hook.on_evaluation_epoch_start(runtime)
    t0 = time.perf_counter()
    for i, start in enumerate(range(0, len(order), BIOSCAN_BATCH)):
        idx = order[start:start + BIOSCAN_BATCH]
        batch = {m: torch.from_numpy(rows[m][idx]).to(device) for m in rows}
        batch["split"] = [splits[j] for j in idx]
        batch["labels"] = [labels[j] for j in idx]
        hook.evaluation_step(runtime, batch, i)
    results = hook.on_evaluation_epoch_end(runtime)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    # the f64 evaluation of the same rows, in the hook's accumulation order
    def store(split):
        sel = [j for j in order if splits[j] == split]
        emb = {m: rows[m][sel].astype(np.float64) for m in rows}
        emb = {m: v / np.linalg.norm(v, axis=1, keepdims=True) for m, v in emb.items()}
        emb["averaged"] = (emb["rgb"] + emb["dna"]) / 2
        emb["concatenated"] = np.concatenate([emb["rgb"], emb["dna"]], axis=1)
        return emb, [labels[j] for j in sel]

    key_emb, key_labels = store("all_keys")
    # all_key: each batch's keys as rgb, dna, text in turn (the hook's order)
    all_key, all_labels = [], []
    for start in range(0, len(order), BIOSCAN_BATCH):
        sel = [j for j in order[start:start + BIOSCAN_BATCH] if splits[j] == "all_keys"]
        if sel:
            for m in ("rgb", "dna", "text"):
                v = rows[m][sel].astype(np.float64)
                all_key.append(v / np.linalg.norm(v, axis=1, keepdims=True))
            all_labels += [labels[j] for j in sel] * 3
    key_emb["all_key"] = np.concatenate(all_key)
    want = {}
    k_max = max(BIOSCAN_TOPK)
    for split in ("val_seen", "val_unseen"):
        q_emb, gt = store(split)
        for q, k in hook.report_combos:
            kl = all_labels if k == "all_key" else key_labels
            t = key_emb[k] / np.linalg.norm(key_emb[k], axis=1, keepdims=True)
            qq = q_emb[q] / np.linalg.norm(q_emb[q], axis=1, keepdims=True)
            top = np.argsort(-(qq @ t.T), axis=1, kind="stable")[:, :k_max]
            preds = [{lv: [kl[i][lv] for i in row] for lv in LEVELS} for row in top]
            micro = top_k_micro_accuracy(preds, gt, BIOSCAN_TOPK)
            macro, _ = top_k_macro_accuracy(preds, gt, BIOSCAN_TOPK)
            for kk in BIOSCAN_TOPK:
                for lv in LEVELS:
                    name = f"{split}_{q}_2_{k}_top_{kk}"
                    want[f"{name}_micro_{lv}"] = micro[kk][lv]
                    want[f"{name}_macro_{lv}"] = macro[kk][lv]
    differ = [k for k in want if results.get(k) != want[k]]
    example = "val_seen_rgb_2_all_key_top_1_micro_species"
    print(f"bioscan path: TaxonomicClassification on the card over {BIOSCAN_KEYS} keys and 2 x "
          f"{BIOSCAN_QUERIES} queries ({card_s:.2f} s): {len(want) - len(differ)} of {len(want)} "
          f"accuracies equal to the f64 CPU evaluation (e.g. {example} {results.get(example)})")
    check(set(results) == set(want) and not differ,
          f"taxonomic accuracies differ from f64: {differ[:6]}")


def export_round_trip(task, device) -> None:
    """The trained recipe's ViT-B/16 and text towers through
    ``hf_export.export_task`` (LoRA merged; timm and HF BERT keys) and back
    through ``TimmViT`` and ``HFTextEncoder`` (the importers): each imported
    tower's output on the card equal to the trained tower's bit for bit, at
    batch 32."""
    import torch

    from mmlearn_tpu_torch import hf_export
    from mmlearn_tpu_torch.modules.encoders.hf_wrappers import HFTextEncoder, TimmViT

    t0 = time.perf_counter()
    out = hf_export.export_task(task, skip_unknown=True)
    check({"rgb", "text", "heads.text", "logit_scale"} <= set(out) and "dna" not in out,
          f"export_task gave {sorted(out)}")
    rgb = TimmViT(state_dict=out["rgb"], projection_dim=768, num_heads=12,
                  dtype="bfloat16").to(device).eval()
    text = HFTextEncoder(config=BERT_SMALL, state_dict=out["text"], pooling="mean",
                         dtype="bfloat16").to(device).eval()
    data = BioscanTriples(SEED + 75)
    batch = bioscan_batch(data, range(32), device, torch.bfloat16)
    task.eval()
    with torch.no_grad():
        pairs = {"rgb": (task.encoders["rgb"](batch["rgb"]).pooler_output,
                         rgb(batch["rgb"]).pooler_output),
                 "text": (task.encoders["text"](batch["text"], batch["text_attention_mask"],
                                                batch["text_token_type_ids"]).pooler_output,
                          text(batch["text"], batch["text_attention_mask"],
                               batch["text_token_type_ids"]).pooler_output)}
    task.train()
    for m, (want, got) in pairs.items():
        same = torch.equal(want, got)
        print(f"bioscan path: {m} tower exported ({len(out[m])} tensors) and imported: output "
              f"b32 bit-equal {'ok' if same else 'FAIL'} (max |diff| "
              f"{float((want.float() - got.float()).abs().max()):.3e})")
        check(same, f"the {m} tower's export round trip changes its output")
    print(f"bioscan path: export round trip {time.perf_counter() - t0:.1f} s")


def bioscan_path(device) -> tuple[dict, dict]:
    """Phase 14, the BIOSCAN-CLIP path. Returns its fit's launches and the
    kernels' new instances' timed rows."""
    import torch

    err = {"fused_mha_fwd": 0.0, "fused_mha_bwd": 0.0, "layernorm_fwd": 0.0,
           "layernorm_bwd": 0.0}
    t0 = time.perf_counter()
    rows = bioscan_kernel_checks(device, err)
    print(f"bioscan path: kernel instances checked and timed in {time.perf_counter() - t0:.1f} s "
          f"(largest errors {err})")
    t0 = time.perf_counter()
    master = bioscan_master(SEED)
    n = {m: sum(p.numel() for p in e.parameters()) for m, e in master.encoders.items()}
    print(f"bioscan path: task built on the CPU from converted state dicts in "
          f"{time.perf_counter() - t0:.1f} s: rgb {n['rgb']:,}, text {n['text']:,}, dna "
          f"{n['dna']:,} parameters, LoRA {sum(p.numel() for p in master.lora.parameters()):,}")
    t0 = time.perf_counter()
    bioscan_step_parity(master, device)
    print(f"bioscan path: step parity in {time.perf_counter() - t0:.1f} s")
    task = master.to(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"bioscan path: the fit's card: {card}")
    counts = bioscan_fit(task, device)
    taxonomic_checks(device)
    export_round_trip(task, device)
    del task, master
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    return counts, rows


# phase 15: the multi-task experiment (contrastive_ijepa.yaml: rgb ViT-B/16 and
# depth ViT-S/16 towers, I-JEPA on the shared rgb tower, batch 128, remat,
# bf16) composed and trained through the port's CLI on a NYUv2-layout tree
MT_PAIRS, MT_HW = 1024, (240, 320)  # pairs of MT_HW (h, w) PNGs
MT_STEPS, MT_RESUME_AT = 24, 12
MT_MARKS = (6, 12, 18, 24)  # 3 timed windows of 6 steps
MT_SEARCHPATH = "pkg://mmlearn_tpu_torch.projects.multi_task.configs"
MT_AUX = "ijepa_rgb"
MT_SCENES = ("bedroom", "kitchen", "living_room", "bathroom", "dining_room", "office")


def nyuv2_pair(idx: int, seed: int, hw=MT_HW):
    """Pair ``idx``: a smooth rgb pattern (uint8, three sinusoids) and its
    depth (uint16 millimetres, 0.5-9.5 m), from ``(seed, idx)``."""
    import numpy as np

    rng = np.random.default_rng((seed, idx))
    h, w = hw
    y, x = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                       np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    f, phase = rng.uniform(0.5, 4.0, (3, 2)), rng.uniform(0, 2 * np.pi, 3)
    rgb = np.stack([np.sin(2 * np.pi * (f[c, 0] * x + f[c, 1] * y) + phase[c])
                    for c in range(3)], axis=-1)
    rgb = ((rgb + 1) * 127.5).round().astype(np.uint8)
    a, b, c = rng.uniform(-1, 1, 3)
    depth = 5000 + 4500 * np.tanh(a * x + b * y + c * x * y)
    return rgb, depth.round().astype(np.uint16)


def _write_nyuv2_pairs(base: str, start: int, stop: int, seed: int, hw) -> None:
    """Pairs ``start`` to ``stop`` of :func:`write_nyuv2_tree` under the
    split directory ``base`` (a worker process's share)."""
    from PIL import Image

    for i in range(start, stop):
        rgb, depth = nyuv2_pair(i, seed, hw)
        Image.fromarray(rgb).save(os.path.join(base, "rgb", f"{i:05d}.png"), compress_level=1)
        Image.fromarray(depth).save(os.path.join(base, "depth", f"{i:05d}.png"),
                                    compress_level=1)
        with open(os.path.join(base, "scene_class", f"{i:05d}.txt"), "w") as f:
            f.write(MT_SCENES[i % len(MT_SCENES)])


def write_nyuv2_tree(root: str, n: int, seed: int = SEED, hw=MT_HW, split: str = "train",
                     processes: int = 0):
    """The original NYUv2 layout under ``root`` (``<split>.txt``,
    ``<split>/rgb/<id>.png``, ``<split>/depth/<id>.png`` in 16 bits,
    ``<split>/scene_class/<id>.txt``) with ``n`` pairs of
    :func:`nyuv2_pair`, in this process or in ``processes`` spawned ones
    (PNG encoding holds the interpreter lock). Returns the ids."""
    import multiprocessing

    ids = [f"{i:05d}" for i in range(n)]
    base = os.path.join(root, split)
    for sub in ("rgb", "depth", "scene_class"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    if processes:
        bounds = [n * k // processes for k in range(processes + 1)]
        with concurrent.futures.ProcessPoolExecutor(
                processes, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_write_nyuv2_pairs, [base] * processes, bounds[:-1], bounds[1:],
                          [seed] * processes, [hw] * processes))
    else:
        _write_nyuv2_pairs(base, 0, n, seed, hw)
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


class MultitaskProbe:
    """A callback that phase 15 adds to the experiment's trainer through the
    CLI (``+trainer.callbacks.probe``). It keeps the trainer; at the start
    of a fresh run, a CPU copy of the auxiliary teacher; after step 1, the
    names of the trained tensors whose gradient is missing, not finite or
    zero, and CPU copies of the shared tower and the teacher; after each step
    in ``marks``, the host clock (after a synchronize) and the feeder wait."""

    runs: list = []

    def __init__(self, marks=()) -> None:
        self.marks = set(marks)
        self.times, self.waits = {}, {}
        self.trainer = self.teacher0 = self.after_first = None
        MultitaskProbe.runs.append(self)

    def on_train_start(self, trainer) -> None:
        self.trainer = trainer
        if trainer.state.step == 0:
            aux = trainer.state.task.auxiliary_tasks[MT_AUX]
            self.teacher0 = {n: p.detach().float().cpu() for n, p in aux.teacher.named_parameters()}

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        if step == 1 and self.teacher0 is not None:
            task = trainer.state.task
            trained = [(n, p) for n, p in task.named_parameters() if p.requires_grad]
            bad, zero = _bad_grads(trained)
            aux = task.auxiliary_tasks[MT_AUX]
            self.after_first = {
                "n_trained": len(trained), "bad": bad + zero,
                "predictor": sum(n.startswith(f"auxiliary_tasks.{MT_AUX}.predictor.")
                                 for n, _ in trained),
                "student": {n: p.detach().float().cpu() for n, p in aux.encoder.named_parameters()},
                "teacher": {n: p.detach().float().cpu() for n, p in aux.teacher.named_parameters()},
                "decay": aux.ema.get_annealed_rate(0 + aux.ema_step_offset),
            }
        if step in self.marks:
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
            self.waits[step] = trainer.feeder_wait_s

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None: ...

    def on_train_end(self, trainer) -> None: ...


def multitask_launches(task) -> dict:
    """Launches a step of the multi-task experiment: K1f a block of the rgb
    tower twice (the contrastive pass and the I-JEPA student on the context
    tokens), of the depth tower once, of the teacher (no gradient) once and
    of the predictor once; each trained pass's blocks once more under remat
    (the recompute); K1b's two kernels a block of each trained pass; K2f and
    K2b twice as often as K1f and K1b's launches a pass."""
    rgb, depth = task.encoders["rgb"], task.encoders["depth"]
    aux = task.auxiliary_tasks[MT_AUX]
    trained = (rgb.blocks, depth.blocks, aux.encoder.blocks, aux.predictor.blocks)
    fwd = sum(len(b) * (2 if getattr(b, "remat", False) else 1) for b in trained)
    fwd += len(aux.teacher.blocks)
    bwd = sum(len(b) for b in trained)
    return {"fused_mha_fwd": fwd, "fused_mha_bwd": 2 * bwd, "fused_mha_packed_fwd": 0,
            "fused_mha_packed_bwd": 0, "layernorm_fwd": 2 * fwd, "layernorm_bwd": 2 * bwd,
            "int8_qmm": 0, "int8_qmm_bytes": 0, **NO_FLASH}


def multitask_parity(overrides, device) -> None:
    """One step of the experiment's task at batch 8 (built by the CLI's
    ``build_experiment`` and the config's ``instantiate`` from the seed, its
    first 8 pairs and step-0 masks), the kernels on the card against the
    plain versions on the CPU from the same weights: the loss and the cosine
    of every trained gradient, at phase 5's limits. Inputs in bf16, as the
    trainer casts them under ``precision: bf16``."""
    import torch

    from mmlearn_tpu_torch.cli._instantiators import instantiate_datasets
    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.conf import instantiate
    from mmlearn_tpu_torch.datasets.core import DataLoader

    cfg = build_experiment(overrides)
    torch.manual_seed(cfg["seed"])
    master = instantiate(cfg["task"])
    master.prepare_seed = cfg["seed"]
    dataset = instantiate_datasets(cfg["datasets"]["train"])
    host = master.prepare_batch(dict(next(iter(DataLoader(dataset, PARITY_BATCH)))), 0)
    losses, grads = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        task = copy.deepcopy(master).to(dev) if where == "card" else master
        batch = {k: (torch.as_tensor(v).to(dev, torch.bfloat16) if k in ("rgb", "depth")
                     else v) for k, v in host.items()}
        loss, metrics = task.loss_fn(batch)
        loss.backward()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()
                        if p.requires_grad}
        print(f"multi-task step b={PARITY_BATCH} on the {where}: loss {losses[where]:.6f} "
              f"(aux {float(metrics[f'aux_{MT_AUX}_loss']):.6f}; "
              f"{time.perf_counter() - t0:.1f} s)")
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    print(f"multi-task step parity b={PARITY_BATCH}, card vs CPU: loss rel diff {rel:.3e} "
          f"(tol {LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} at {worst}, median "
          f"{statistics.median(cos.values()):.6f} over {len(cos)} tensors "
          f"(bound {MIN_GRAD_COSINE})")
    check(rel <= LOSS_RTOL, f"multi-task loss on the card {losses['card']} vs CPU {losses['cpu']}")
    check(cos[worst] >= MIN_GRAD_COSINE, f"multi-task gradient of {worst}: cosine {cos[worst]}")


def multitask_path(device) -> dict:
    """Phase 15, the multi-task experiment through the CLI. Returns run A's
    launch counts."""
    import math
    import shutil

    import torch

    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.cli.run import main as cli_main

    # the CLI's instantiate finds the probe in this module, not a second copy
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    root = os.path.join(WORK_DIR, "multitask")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_nyuv2_tree(os.path.join(root, "nyuv2"), MT_PAIRS, processes=min(8, host_cores()))
    print(f"multi-task path: {MT_PAIRS} NYUv2-layout pairs at {MT_HW[1]}x{MT_HW[0]} written "
          f"in {time.perf_counter() - t0:.1f} s")
    data = [f"searchpath=[{MT_SEARCHPATH}]", "+experiment=contrastive_ijepa",
            f"+datasets.train.root_dir={os.path.join(root, 'nyuv2')}"]
    t0 = time.perf_counter()
    multitask_parity(data, device)
    print(f"multi-task path: step parity in {time.perf_counter() - t0:.1f} s")

    def run(name, max_steps, *extra):
        out = os.path.join(root, name)
        argv = [*data, f"trainer.max_steps={max_steps}", f"runtime.output_dir={out}",
                f"+trainer.callbacks.checkpoint.dirpath={os.path.join(out, 'checkpoints')}",
                f"+trainer.callbacks.checkpoint.every_n_train_steps={MT_RESUME_AT}",
                "+trainer.callbacks.checkpoint.every_n_epochs=null", "trainer.log_mfu=true",
                "+trainer.callbacks.probe._target_=chip_smoke.MultitaskProbe",
                f"+trainer.callbacks.probe.marks={list(MT_MARKS)}", *extra]
        t0 = time.perf_counter()
        state = cli_main(argv)
        torch.cuda.synchronize()
        print(f"multi-task path: run {name} ({state.step} steps) through the CLI in "
              f"{time.perf_counter() - t0:.1f} s")
        return state, MultitaskProbe.runs[-1]

    # run A: the experiment as its YAML gives it, MT_STEPS steps
    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    state_a, probe = run("A", MT_STEPS)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    task, trainer = state_a.task, probe.trainer
    check(state_a.step == MT_STEPS, f"run A took {state_a.step} steps")
    check(trainer.device.type == "cuda" and next(task.parameters()).is_cuda,
          "the CLI's trainer did not run on the card")
    want = multitask_launches(task)
    print(f"multi-task path: {state_a.step} steps launched " + ", ".join(
        f"{k} {counts[k]} ({counts[k] / state_a.step:g} a step, want {v})"
        for k, v in want.items() if v))
    check(counts == {k: v * state_a.step for k, v in want.items()},
          f"multi-task launches {counts}, want {want} a step")

    first = probe.after_first
    check(first is not None, "the probe saw no first step")
    print(f"multi-task path: gradients of the first step: "
          f"{first['n_trained'] - len(first['bad'])} of {first['n_trained']} trained tensors "
          f"finite and nonzero ({first['predictor']} of the predictor's)")
    check(not first["bad"] and first["predictor"] > 0,
          f"missing, non-finite or zero gradients at the first step: {first['bad'][:10]}")
    d = first["decay"]
    moved, worst = 0, 0.0
    for n, t1 in first["teacher"].items():
        s1 = first["student"][n]
        moved += not torch.equal(t1, s1)
        want_t = probe.teacher0[n].clone().mul_(float(d)).add_(s1, alpha=float(1 - d))
        worst = max(worst, float(((t1 - want_t).abs() / (want_t.abs() + 1e-6)).max()))
    print(f"multi-task path: teacher after step 1: {moved} of {len(first['teacher'])} tensors "
          f"apart from the student; against d * teacher_0 + (1 - d) * student_1 on the CPU "
          f"(d = {d}): max relative diff {worst:.3e} (tol 1e-6)")
    check(moved == len(first["teacher"]), "the teacher equals the student after step 1")
    check(worst <= 1e-6, "the teacher is not the EMA of the saved weights")

    hist = trainer.history
    aux = [h[f"aux_{MT_AUX}_loss"] for h in hist]
    print(f"multi-task path: loss step 0 {hist[0]['loss']:.6f}, step {len(hist) - 1} "
          f"{hist[-1]['loss']:.6f}; aux_{MT_AUX}_loss {aux[0]:.6f} -> {aux[-1]:.6f}; "
          f"logit scale {hist[-1]['logit_scale']:.4f}; lr {hist[0]['lr']:.4e} -> "
          f"{hist[-1]['lr']:.4e}")
    check(all(math.isfinite(x) for x in aux) and all(math.isfinite(h["loss"]) for h in hist),
          "non-finite multi-task losses")

    marks = sorted(probe.times)
    window_s = [probe.times[b] - probe.times[a] for a, b in zip(marks, marks[1:])]
    waits = [probe.waits[b] - probe.waits[a] for a, b in zip(marks, marks[1:])]
    steps = [b - a for a, b in zip(marks, marks[1:])]
    batch = build_experiment(data)["dataloader"]["train"]["batch_size"]
    rates = [batch * n / w for n, w in zip(steps, window_s)]
    median = statistics.median(rates)
    ms = statistics.median([w / n for n, w in zip(steps, window_s)]) * 1e3
    flops = trainer._step_flops or 0.0
    mfu = flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"multi-task train b{batch} through the CLI: {median:.1f} pairs/s median of "
          f"{len(rates)} windows of {steps[0]} steps (windows {', '.join(f'{r:.1f}' for r in rates)}"
          f"; spread {(max(rates) - min(rates)) / median:.2%}), {ms:.2f} ms a step, "
          f"{flops / 1e12:.3f} TFLOPs a step counted, MFU {mfu:.2%} of "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, peak memory {peak_gb:.2f} GB, the "
          f"step's wait on the feeder {statistics.median(w / n for n, w in zip(steps, waits)) * 1e3:.2f}"
          f" ms a step ({sum(waits) / sum(window_s):.2%} of the windows); card {card}")

    # run B: a fresh process state resumed from run A's step-12 checkpoint
    ckpt_a = os.path.join(root, "A", "checkpoints")
    ckpt_b = os.path.join(root, "B", "resume")
    os.makedirs(ckpt_b)
    shutil.copytree(os.path.join(ckpt_a, str(MT_RESUME_AT)), os.path.join(ckpt_b, str(MT_RESUME_AT)))
    for name in os.listdir(ckpt_a):
        if name.startswith(f"loop_position-{MT_RESUME_AT}."):
            shutil.copy(os.path.join(ckpt_a, name), ckpt_b)
    weights_a = {k: v.detach().clone() if torch.is_tensor(v) else v
                 for k, v in task.state_dict().items()}
    history_a = [dict(h) for h in hist]
    del state_a, task, trainer, probe
    gc.collect()
    state_b, probe_b = run("B", MT_STEPS, f"resume_from_checkpoint={ckpt_b}")
    check(probe_b.trainer.restored_step == MT_RESUME_AT,
          f"run B restored step {probe_b.trainer.restored_step}")
    same_run(f"multi-task run B (resumed at {MT_RESUME_AT})", probe_b.trainer.history,
             _tensors(state_b.task.state_dict()), history_a[MT_RESUME_AT:],
             _tensors(weights_a))
    check(state_b.task.state_dict()[f"auxiliary_tasks.{MT_AUX}._extra_state"]
          == weights_a[f"auxiliary_tasks.{MT_AUX}._extra_state"], "the EMA offset differs")
    del state_b, probe_b, weights_a
    MultitaskProbe.runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    return counts


# phase 16: the parallel path on the one card. The ring at full width through
# the list exchange (P ranks' hops on this card): B=1, N=16,384 at P=4 (4,096
# a rank) and P=8 (2,048, the JAX package's flash threshold), the image
# tower's width 1,024 as 16 heads of 64 and 8 of 128; then the normal entry
# (cli.run) at world 1 over NCCL under MMLEARN_MULTIHOST=1, the flagship's
# towers at b128.
RING_N, RING_P, RING_HEADS = 16384, (4, 8), ((16, 64), (8, 128))
HOP_N = 4096  # the hop grid of K3f's f32 output (P=4)
K3_D128_N, K3_D128_H = 16384, 8
# the ring against unsharded K3 on the whole sequence and against the plain
# ring (its hops the plain block math on the card), ||got - want|| / ||want||:
# about 2x a sound run's readings (out against K3 up to 2.8e-3, the gradients
# up to 2.8e-3: the ring's f32 merge against one pass's, p rounded to bf16 a
# hop; against the plain ring 3.1e-3 and 3.4e-3: the plain version rounds the
# normalized p, the kernels the unnormalized; first run on one H100)
RING_REL_TOL = {"out": 6e-3, "grad": 7e-3}
PAR_STEPS, PAR_BATCH, PAR_VAL = 12, 128, 2
# phase 16's two windows a run: steps 2 to PAR_PROF on the host clock (a
# synchronize after each; the median step), then torch.profiler over the
# steps after PAR_PROF (the kernels' device time a step)
PAR_PROF = 7
PAR_WORKERS = 8  # the train loader's fetch threads
TRAINER_MS: dict = {}  # phase 9's ms a micro-step, for phase 16


def hop_count(p: int, causal: bool) -> int:
    """Hops a ring pass computes over its P ranks."""
    return p * (p + 1) // 2 if causal else p * p


@contextlib.contextmanager
def plain_hops():
    """The ring's hops as their plain block math, on the tensors' device
    (the plain ring on the card), inside the block."""
    import mmlearn_tpu_torch.ops.ring_attention as ra

    saved = ra._hop_forward, ra._hop_backward
    ra._hop_forward = ra.block_attention_reference
    ra._hop_backward = (lambda q, k, v, do, out, delta, lse, *rest:
                        ra.block_attention_bwd_reference(q, k, v, do.float(), delta, lse, *rest))
    try:
        yield
    finally:
        ra._hop_forward, ra._hop_backward = saved


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm())


def k3_parallel_checks(device, gen, err: dict) -> dict:
    """Phase 16's K3 instances against their plain versions, with K3's
    element and norm-relative limits: K3f with its f32 output at the hop
    grids (B=1, n=4,096; H=16 D=64 and H=8 D=128), K3f and K3b at D=128 on
    B=1, N=16,384, H=8 (the plain versions head by head), K3b run twice on
    one input (equal bits); each timed beside its plain version, SDPA and
    its bound. Returns rows as :func:`kernels_at_batch`."""
    import torch
    import torch.nn.functional as F

    from mmlearn_tpu_torch.ops import flash_attention as fl

    rows = {}
    fwd_tol, bwd_tol = tol("flash_attention_fwd", "bfloat16"), tol("flash_attention_bwd",
                                                                  "bfloat16")
    fwd_rel = FLASH_REL_TOL["flash_attention_fwd"]["bfloat16"]
    bwd_rel = FLASH_REL_TOL["flash_attention_bwd"]["bfloat16"]
    err.setdefault("flash_attention_fwd_f32", 0.0)
    for h, d in RING_HEADS:
        scale = d ** -0.5
        q, k, v = (torch.randn(1, h, HOP_N, d, generator=gen, device=device).bfloat16()
                   for _ in range(3))
        out, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False, out_dtype=torch.float32)
        check(out.dtype == torch.float32, "K3f's hop output is not f32")
        want, want_lse = fl.flash_fwd_reference(q, k, v, None, scale, False,
                                                out_dtype=torch.float32)
        tag = f"hop B=1 n={HOP_N} H={h} D={d} bf16 in, f32 out"
        err["flash_attention_fwd_f32"] = max(err["flash_attention_fwd_f32"], compare(
            f"K3f f32 out {tag}", out, want, fwd_tol, fwd_rel))
        compare(f"K3f f32 lse {tag}", lse, want_lse, LSE_TOL)
        rows[f"K3f f32 hop H={h} D={d}"] = (
            cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False,
                                               out_dtype=torch.float32)),
            cuda_ms(lambda: fl.flash_fwd_reference(q, k, v, None, scale, False,
                                                   out_dtype=torch.float32), iters=2, warmup=1),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            *bound(nbytes(q, k, v, out, lse), 4 * h * d * HOP_N * HOP_N, "bfloat16"))
        del q, k, v, out, lse, want, want_lse
        torch.cuda.empty_cache()

    h, d, n = K3_D128_H, 128, K3_D128_N
    scale = d ** -0.5
    q, k, v, do = (torch.randn(1, h, n, d, generator=gen, device=device).bfloat16()
                   for _ in range(4))
    out, lse = fl._flash_fwd_cuda(q, k, v, None, scale, False)
    grads = fl._flash_bwd_cuda(q, k, v, None, out, lse, do, scale, False)
    again = fl._flash_bwd_cuda(q, k, v, None, out, lse, do, scale, False)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "K3b at D=128: two runs on one input differ")
    print(f"K3b flash N={n} H={h} D={d} bf16: dq, dk, dv of two runs equal bit for bit ok")
    heads = [slice(i, i + 1) for i in range(h)]

    def plain_fwd():
        return [fl.flash_fwd_reference(q[:, s], k[:, s], v[:, s], None, scale, False)
                for s in heads]

    def plain_bwd():
        return [fl.flash_bwd_reference(q[:, s], k[:, s], v[:, s], None, out[:, s], lse[:, s],
                                       do[:, s], scale, False) for s in heads]

    tag = f"N={n} B=1 H={h} D={d} bf16"
    want = plain_fwd()
    err["flash_attention_fwd_d128"] = compare(
        f"K3f flash out {tag}", out, torch.cat([o for o, _ in want], 1), fwd_tol, fwd_rel)
    compare(f"K3f flash lse {tag}", lse, torch.cat([l for _, l in want], 1), LSE_TOL)
    del want
    want_b = plain_bwd()
    err["flash_attention_bwd_d128"] = max(
        compare(f"K3b flash d{name} {tag}", grads[i], torch.cat([w[i] for w in want_b], 1),
                bwd_tol, bwd_rel) for i, name in enumerate("qkv"))
    del want_b, grads, again
    torch.cuda.empty_cache()
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    pairs = n * n
    rows[f"K3f N={n} H={h} D={d}"] = (
        cuda_ms(lambda: fl._flash_fwd_cuda(q, k, v, None, scale, False)),
        cuda_ms(plain_fwd, iters=2, warmup=1),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        *bound(nbytes(q, k, v, out, lse), 4 * h * d * pairs, "bfloat16"))
    rows[f"K3b N={n} H={h} D={d}"] = (
        cuda_ms(lambda: fl._flash_bwd_cuda(q, k, v, None, out, lse, do, scale, False)),
        cuda_ms(plain_bwd, iters=2, warmup=1),
        cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do, retain_graph=True)),
        *bound(nbytes(q, k, v, out, do, lse, q, k, v), 10 * h * d * pairs, "bfloat16"))
    del q, k, v, do, out, lse, lq, lk, lv, lib_out
    torch.cuda.empty_cache()
    for label, (ms, plain, lib, bnd, by) in rows.items():
        print(f"time {label} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; {bnd / ms:.1%} of it)")
    reset_counts()
    return rows


def ring_path(device, gen) -> dict:
    """Phase 16's ring at full width on the card through the list exchange:
    B=1, N=16,384 at P=4 and 8, H=16 D=64 and H=8 D=128, causal and not,
    forward and backward. Each run counted from 0: K3f (its f32 instance)
    and K3b's two kernels P^2 a pass, P (P + 1) / 2 causal; the output and
    gradients against unsharded K3 on the whole sequence and against the
    plain ring, ||got - want|| / ||want||; the ring's ms against K3's.
    Returns the launches of all the runs."""
    import torch

    from mmlearn_tpu_torch.ops import flash_attention as fl
    from mmlearn_tpu_torch.ops.ring_attention import ListExchange, sequence_sharded_attention

    total: dict = {}
    for h, d in RING_HEADS:
        q, k, v, do = (torch.randn(1, h, RING_N, d, generator=gen, device=device).bfloat16()
                       for _ in range(4))
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = fl.flash_attention(*leaves, causal=causal)
            ref_grads = torch.autograd.grad(ref, leaves, do)
            k3_fwd = cuda_ms(lambda: fl.flash_attention(q, k, v, causal=causal), iters=5)
            k3_both = cuda_ms(lambda: torch.autograd.grad(
                fl.flash_attention(*leaves, causal=causal), leaves, do), iters=5)
            for p in RING_P:
                tag = f"ring P={p} B=1 N={RING_N} H={h} D={d}{' causal' if causal else ''}"
                ex = ListExchange(p)
                reset_counts()
                out = sequence_sharded_attention(*leaves, ex, causal=causal)
                grads = torch.autograd.grad(out, leaves, do)
                torch.cuda.synchronize()
                counts, hops = launch_counts(), hop_count(p, causal)
                f32 = fl.F32_OUT_LAUNCHES["flash_fwd_f32"]
                print(f"{tag}: launched flash_fwd {counts['flash_fwd']} (f32 out {f32}), "
                      f"flash_bwd_dq {counts['flash_bwd_dq']}, flash_bwd_dkv "
                      f"{counts['flash_bwd_dkv']} (want {hops} each); hops {ex.hops}")
                check(counts["flash_fwd"] == f32 == counts["flash_bwd_dq"]
                      == counts["flash_bwd_dkv"] == hops
                      and ex.hops == {"forward": hops, "backward": hops,
                                      "skipped": 2 * (p * p - hops)},
                      f"{tag}: launches {counts}, f32 {f32}, hops {ex.hops}")
                for key, count in head_dim_counts().items():
                    total[key] = total.get(key, 0) + count
                total["flash_fwd_f32", d] = total.get(("flash_fwd_f32", d), 0) + f32
                # K3f's input-dtype instance, apart from its f32 one (0 on the ring)
                total["flash_fwd_bf16", d] = (total.get(("flash_fwd_bf16", d), 0)
                                              + counts["flash_fwd"] - f32)
                for name, got, want in (("out", out, ref), *zip(
                        ("dq", "dk", "dv"), grads, ref_grads)):
                    r = rel_err(got, want)
                    limit = RING_REL_TOL["out" if name == "out" else "grad"]
                    print(f"{tag} {name} against unsharded K3: rel_err={r:.3e} (limit {limit:g}) "
                          f"{'ok' if r <= limit else 'FAIL'}")
                    check(r <= limit and bool(got.isfinite().all()),
                          f"{tag} {name} against unsharded K3")
                with plain_hops():
                    p_out = sequence_sharded_attention(*leaves, ListExchange(p), causal=causal)
                    p_grads = torch.autograd.grad(p_out, leaves, do)
                for name, got, want in (("out", out, p_out), *zip(
                        ("dq", "dk", "dv"), grads, p_grads)):
                    r = rel_err(got, want)
                    limit = RING_REL_TOL["out" if name == "out" else "grad"]
                    print(f"{tag} {name} against the plain ring: rel_err={r:.3e} (limit "
                          f"{limit:g}) {'ok' if r <= limit else 'FAIL'}")
                    check(r <= limit, f"{tag} {name} against the plain ring")
                del p_out, p_grads, out, grads
                torch.cuda.empty_cache()
                with torch.no_grad():
                    ring_fwd = cuda_ms(lambda: sequence_sharded_attention(
                        q, k, v, ListExchange(p), causal=causal), iters=3, warmup=1)
                ring_both = cuda_ms(lambda: torch.autograd.grad(sequence_sharded_attention(
                    *leaves, ListExchange(p), causal=causal), leaves, do), iters=3, warmup=1)
                print(f"time {tag}: ring forward {ring_fwd:.3f} ms ({ring_fwd / k3_fwd:.2f} x "
                      f"unsharded K3's {k3_fwd:.3f} ms), forward + backward {ring_both:.3f} ms "
                      f"({ring_both / k3_both:.2f} x K3's {k3_both:.3f} ms)")
            del leaves, ref, ref_grads
        del q, k, v, do
        torch.cuda.empty_cache()
    reset_counts()
    return total


def parallel_argv(out_dir: str) -> list:
    """The CLI's overrides of phase 16's run: the tiny experiment's
    synthetic pairs and trainer at the flagship's towers (ViT-B/16 at 224 px,
    the 77-token text tower, bf16), b128 drawn by PAR_WORKERS threads,
    PAR_STEPS steps and a validation of PAR_VAL batches at the end, on the
    card."""
    rgb, text = "task.encoders.rgb", "task.encoders.text"
    return [
        "+experiment=tiny_clip_synthetic", f"runtime.output_dir={out_dir}",
        "trainer.device=cuda", f"trainer.max_steps={PAR_STEPS}", "trainer.log_every_n_steps=1",
        "trainer.mesh_shape.data=-1", "+trainer.mesh_shape.fsdp=1",
        "+trainer.callbacks.probe._target_=chip_smoke.ParallelProbe",
        f"datasets.train.size={PAR_STEPS * PAR_BATCH}", "datasets.train.image_size=224",
        "datasets.train.seq_len=77", "datasets.train.vocab_size=49408",
        f"datasets.val.size={PAR_VAL * PAR_BATCH}", "datasets.val.image_size=224",
        "datasets.val.seq_len=77", "datasets.val.vocab_size=49408",
        f"dataloader.train.batch_size={PAR_BATCH}", f"dataloader.val.batch_size={PAR_BATCH}",
        # the synthetic examples are drawn on the host (150,528 normals an
        # image): one thread makes a batch in about 0.3 s, more than the
        # undistributed step, so the card's 8 cores draw them
        f"+dataloader.train.num_workers={PAR_WORKERS}",
        f"{rgb}.img_size=224", f"{rgb}.patch_size=16", f"{rgb}.embed_dim=768", f"{rgb}.depth=12",
        f"{rgb}.num_heads=12", f"+{rgb}.learned_pos_embed=true", f"+{rgb}.pre_norm=true",
        f"+{rgb}.act_layer=quick_gelu", f"{rgb}.proj_dim=512", f"+{rgb}.dtype=bfloat16",
        f"{text}.vocab_size=49408", f"{text}.max_length=77", f"{text}.embed_dim=512",
        f"{text}.depth=12", f"{text}.num_heads=8", f"+{text}.causal=true",
        f"{text}.proj_dim=512", f"+{text}.dtype=bfloat16",
    ]


def profiled_kernel_ms(prof) -> float:
    """The device time of the kernels and memsets ``prof`` recorded, in ms
    (user ranges left out: they would count their kernels twice)."""
    import torch

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


class ParallelProbe:
    """Phase 16's callback: after each step, a synchronize, the host clock,
    the trainer's feeder wait and the time the garbage collector took so
    far; torch.profiler over the steps after PAR_PROF (its start-up outside
    the clock); the trainer, its history and the validation results."""

    runs: list = []

    def __init__(self) -> None:
        self.times: dict = {}
        self.waits: dict = {}
        self.gc_s: dict = {}
        self._gc = [0.0, 0.0]  # seconds in the collector, the running pass's start
        self.kernel_ms = float("nan")
        self.prof = None
        self.trainer = None
        self.val: dict = {}
        ParallelProbe.runs.append(self)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc[1] = time.perf_counter()
        else:
            self._gc[0] += time.perf_counter() - self._gc[1]

    def on_train_start(self, trainer) -> None:
        self.trainer = trainer
        gc.callbacks.append(self._on_gc)

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        torch.cuda.synchronize()
        self.times[step] = time.perf_counter()
        self.waits[step] = trainer.feeder_wait_s
        self.gc_s[step] = self._gc[0]
        if step == PAR_STEPS and self.prof is not None:
            self.prof.stop()
            self.kernel_ms = profiled_kernel_ms(self.prof) / (PAR_STEPS - PAR_PROF)
            self.prof = None
        if step == PAR_PROF:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            self.times["prof_start"] = time.perf_counter()

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None:
        self.val = dict(metrics)

    def on_train_end(self, trainer) -> None:
        gc.callbacks.remove(self._on_gc)


def parallel_run(out_dir: str) -> dict:
    """Phase 16's job through the CLI (``build_experiment`` and
    ``run_experiment``, ``main``'s two halves) with zero-shot retrieval as
    the task's evaluation: launches counted from 0, the history, the
    weights on the CPU, the validation results; the step's times: each step
    of steps 2 to PAR_PROF on the host clock, their median, the feeder wait
    over them, the wall and kernel time a step under the profiler; and what
    the process holds beside the job (threads, torch's threads, the
    allocator's retries)."""
    import torch

    from mmlearn_tpu_torch.cli.run import build_experiment, run_experiment
    from mmlearn_tpu_torch.trainer.state import full_state

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    cfg = build_experiment(parallel_argv(out_dir))
    cfg["task"]["evaluation_tasks"] = {"retrieval": {"task": {
        "_target_": "mmlearn_tpu_torch.tasks.zero_shot_retrieval.ZeroShotCrossModalRetrieval",
        "task_specs": [{"query_modality": "rgb", "target_modality": "text", "top_k": [1, 5]}]}}}
    reset_counts()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    state = run_experiment(cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    probe = ParallelProbe.runs[-1]
    weights = {k: v.detach().cpu() for k, v in full_state(state.task.state_dict()).items()
               if torch.is_tensor(v)}
    t = probe.times
    steps_ms = [(t[i] - t[i - 1]) * 1e3 for i in range(2, PAR_PROF + 1)]
    diag = {
        "steps_ms": steps_ms,
        "wait_ms": (probe.waits[PAR_PROF] - probe.waits[1]) * 1e3 / (PAR_PROF - 1),
        "gc_ms": (probe.gc_s[PAR_PROF] - probe.gc_s[1]) * 1e3 / (PAR_PROF - 1),
        "gc_objects": len(gc.get_objects()),
        "prof_wall_ms": (t[PAR_STEPS] - t["prof_start"]) * 1e3 / (PAR_STEPS - PAR_PROF),
        "kernel_ms": probe.kernel_ms,
        "threads": sorted(th.name for th in threading.enumerate()),
        "torch_threads": torch.get_num_threads(),
        "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries,
        "reserved_gb_before": reserved_gb,
    }
    return {"counts": counts, "history": probe.trainer.history, "weights": weights,
            "ms": statistics.median(steps_ms), "diag": diag,
            "val": probe.val, "step": state.step,
            "sharded": type(state.task).__name__.startswith("FSDP"),
            "depth": sum(len(enc.blocks) for enc in state.task.encoders.values())}


def parallel_worker(out_dir: str) -> None:
    """The one process of phase 16's world-1 job, started by ``run_workers``
    under ``MMLEARN_MULTIHOST=1``: the CLI joins the NCCL group from the
    environment; the results go to ``<out_dir>/result.pt``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = parallel_run(out_dir)
    result["backend"] = dist.get_backend()
    result["world"] = dist.get_world_size()
    torch.save(result, os.path.join(out_dir, "result.pt"))
    dist.destroy_process_group()


def parallel_path(device) -> None:
    """Phase 16's entry: the job at world 1 over NCCL (one process by
    ``mp_launch``, ``MMLEARN_MULTIHOST=1``) against the same job on the
    undistributed trainer in this process: the loss of every step and every
    weight bit-equal, or, where the optimizer's arithmetic differs, within
    1e-6 relative (AdamW takes its per-tensor loop over DTensor parameters
    and its multi-tensor kernels over plain ones); K1's and K2's launches a
    step phase 9's; the recall's results equal; ms a step beside phase 9's."""
    import shutil

    import torch

    from mmlearn_tpu_torch.parallel.mp_launch import run_workers

    root = os.path.join(WORK_DIR, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "nccl"))
    env = dict(os.environ, MMLEARN_MULTIHOST="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import sys, chip_smoke; "
            f"chip_smoke.parallel_worker({os.path.join(root, 'nccl')!r})")
    t0 = time.perf_counter()
    out = run_workers([[sys.executable, "-c", code]], env=env, cwd=REPO, timeout=420)
    print(f"parallel path: the world-1 NCCL job through the CLI in {time.perf_counter() - t0:.1f} "
          f"s; its last lines:\n" + "\n".join(out[0].splitlines()[-4:]))
    got = torch.load(os.path.join(root, "nccl", "result.pt"), weights_only=False)
    t0 = time.perf_counter()
    want = parallel_run(os.path.join(root, "plain"))
    print(f"parallel path: the same job on the undistributed trainer in "
          f"{time.perf_counter() - t0:.1f} s")
    check(got["backend"] == "nccl" and got["world"] == 1 and got["sharded"]
          and not want["sharded"], f"parallel path: backend {got['backend']}, world "
          f"{got['world']}, FSDP2 {got['sharded']} / {want['sharded']}")
    check(got["step"] == want["step"] == PAR_STEPS, "parallel path steps")
    per_step = {"fused_mha_fwd": got["depth"], "fused_mha_bwd": 2 * got["depth"],
                "layernorm_fwd": 2 * got["depth"], "layernorm_bwd": 2 * got["depth"]}
    # the validation: the loss's forward and the retrieval hook's encode, a batch
    n_val = 2 * PAR_VAL
    val_fwd = {"fused_mha_fwd": got["depth"] * n_val, "layernorm_fwd": 2 * got["depth"] * n_val}
    for run, counts in (("NCCL", got["counts"]), ("undistributed", want["counts"])):
        wanted = {k: v * PAR_STEPS + val_fwd.get(k, 0) for k, v in per_step.items()}
        print(f"parallel path ({run}): launched " + ", ".join(
            f"{k} {counts[k]} (want {wanted[k]}: phase 9's {per_step[k]} a step and "
            f"{n_val} validation forwards)" for k in per_step))
        check(all(counts[k] == wanted[k] for k in per_step), f"parallel path ({run}) launches")
    losses_got = [h["loss"] for h in got["history"]]
    losses_want = [h["loss"] for h in want["history"]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_got, losses_want))
    diffs = {n: rel_err(got["weights"][n], want["weights"][n]) if not torch.equal(
        got["weights"][n], want["weights"][n]) else 0.0 for n in want["weights"]}
    unequal = {n: r for n, r in diffs.items() if r}
    print(f"parallel path: losses {['%.6f' % x for x in losses_got]}; bit-equal to the "
          f"undistributed run: {losses_got == losses_want} (largest relative diff "
          f"{loss_rel:.3e}); weights bit-equal {len(diffs) - len(unequal)} of {len(diffs)}"
          f"{'' if not unequal else f', the rest within {max(unequal.values()):.3e} relative'}")
    check(loss_rel <= 1e-6 and all(r <= 1e-6 for r in unequal.values()),
          "parallel path: the world-1 job departs from the undistributed one past 1e-6")
    if unequal or losses_got != losses_want:
        print("parallel path: the bits differ where AdamW takes its per-tensor loop over "
              "FSDP2's DTensor parameters and its multi-tensor kernels over plain ones "
              "(held at 1e-6 relative)")
    keys = sorted(k for k in want["val"] if k.startswith("retrieval/"))
    print(f"parallel path: validation {got['val']}")
    check(keys and all(got["val"][k] == want["val"][k] for k in keys),
          f"parallel path: recall {got['val']} against {want['val']}")
    for run, res in (("NCCL", got), ("undistributed", want)):
        d = res["diag"]
        print(f"parallel path ({run}) steps 2-{PAR_PROF}: "
              f"{', '.join(f'{x:.2f}' for x in d['steps_ms'])} ms (median {res['ms']:.2f}); "
              f"feeder wait {d['wait_ms']:.2f} ms a step, garbage collector {d['gc_ms']:.2f} ms "
              f"a step ({d['gc_objects']} objects tracked after the run); under the profiler (steps "
              f"{PAR_PROF + 1}-{PAR_STEPS}) {d['prof_wall_ms']:.2f} ms a step, kernels "
              f"{d['kernel_ms']:.2f} ms (idle share {1 - d['kernel_ms'] / d['prof_wall_ms']:.3f}); "
              f"torch threads {d['torch_threads']}, allocator retries {d['alloc_retries']}, "
              f"reserved before {d['reserved_gb_before']:.2f} GB; {len(d['threads'])} Python "
              f"threads: {', '.join(d['threads'])}")
    print(f"parallel path train b{PAR_BATCH}: FSDP2 wrapper at world 1 over NCCL "
          f"{got['ms']:.2f} ms a step (median of steps 2-{PAR_PROF}), the undistributed "
          f"trainer {want['ms']:.2f} ms ({got['ms'] / want['ms']:.3f} x); kernels a step "
          f"{got['diag']['kernel_ms']:.2f} / {want['diag']['kernel_ms']:.2f} ms; phase 9's "
          f"{TRAINER_MS.get('ms', float('nan')):.2f} ms a micro-step")


def parallel_phase(device) -> tuple[dict, dict, dict]:
    """Phase 16: K3's new instances, the ring, the world-1 NCCL job. Returns
    the kernel rows, the ring's launches and the kernels' largest errors."""
    import torch

    t0 = time.perf_counter()
    errors: dict = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 160)
    rows = k3_parallel_checks(device, gen, errors)
    print(f"parallel path: K3 instances checked and timed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = ring_path(device, torch.Generator(device=device).manual_seed(SEED + 161))
    print(f"parallel path: the ring in {time.perf_counter() - t0:.1f} s")
    parallel_path(device)
    return rows, launches, errors


TP_STEPS = 6
TP_BATCH = 128
TP_MESH = {"data": 1, "fsdp": 1, "model": 2}
#: the spread of the biases phase 17 draws (the towers start them at 0)
TP_BIAS_STD = 0.02
#: SGD (an update linear in the gradient, as phase 9's parity and the CPU
#: tests take: AdamW's sign-like first updates turn bf16 rounding of
#: near-zero gradients into whole steps)
TP_LR = 0.1
TP_TIMED = (2, 4)  # steps 2-4 on the host clock
#: limits of phase 17 against the undistributed trainer, each relative:
#: every step's loss and ``grad_norm``; after the steps, each parameter's
#: ||got - want|| / ||want||, and over its update from the start,
#: ||got - want|| / ||want - start||: about 2x a sound run's readings on an
#: NVIDIA H100 80GB HBM3 at 700 W (6.584e-05, 8.011e-03, 1.626e-02,
#: 4.704e-02), below a copy that adds the bias on both ranks (8.473e-04,
#: 3.827e-02, 4.793e-02, 1.993e-01) or skips the all-reduce (6.586e-03,
#: 2.165, 7.184e-01, 5.311); ``tools/tp_mutants.py`` reads them. The loss
#: moves with any LayerNorm's last bits: its limit is about 2x the largest
#: of sound LayerNorms' readings, K2f 6.584e-05, K2f's plain version on the
#: card 9.154e-05, ``F.layer_norm`` 1.193e-04 (``tools/noise_limits.py``),
#: and a K2f of other last bits 1.775e-04
TP_LOSS_REL = 3.5e-4
TP_NORM_REL = 1.6e-2
TP_WEIGHT_REL = 3.5e-2
TP_UPDATE_REL = 1e-1
#: phase 17's attention layers whose sharded plan says "xla", split over
#: its model=2 group: (label, heads, head dim, tokens, causal, masked); on
#: the card each runs its local heads on K3
TP_LAYOUTS = (("ViT-B/16's 3 local heads at model=4", 6, 64, 197, False, False),
              ("ViT-H/14's 4 local heads at model=4", 8, 80, 257, False, False),
              ("3 heads, qkv gathered (H % model != 0)", 3, 64, 77, True, True))
TP_LAYOUT_BATCH = 8
#: limit of a TP_LAYOUTS layer's output and input gradient against the
#: same layer unsplit (K1 on every head there), norm-relative: about 2x a
#: sound run's largest reading on an NVIDIA H100 80GB HBM3 at 700 W
#: (4.399e-03), below the output of a copy that adds the bias on both ranks
#: (1.630e-01) or skips the all-reduce (6.959e-01)
TP_LAYOUT_REL = 9e-3
#: the profiler events phase 17 counts as the model group's collectives
TP_COMM_EVENTS = ("all_reduce", "allreduce", "all_gather", "allgather", "reduce_scatter",
                  "wait_tensor", "broadcast")


def tp_task(device):
    """Phase 17's flagship: the towers from a seed, every bias drawn from
    N(0, TP_BIAS_STD) by a generator of its own, SGD with momentum at
    TP_LR and no schedule, on ``device``."""
    import torch

    from mmlearn_tpu_torch.flagship import flagship_training_task

    task = flagship_training_task("cpu", seed=SEED + 170)
    g = torch.Generator().manual_seed(SEED + 172)
    with torch.no_grad():
        for name, p in task.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * TP_BIAS_STD)
    task.optimizer_factory = functools.partial(torch.optim.SGD, lr=TP_LR, momentum=0.9)
    task.lr_scheduler_factory = None
    return task.to(device)


class TPProbe:
    """Phase 17's callback: the host clock after a synchronize at each
    step's end, every step's loss and ``grad_norm``, and torch.profiler over
    the steps after TP_TIMED's last."""

    def __init__(self) -> None:
        self.times: dict = {}
        self.records: list = []
        self.prof = None
        self.comm_ms = float("nan")
        self.comm_calls: dict = {}

    def on_train_start(self, trainer) -> None: ...

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        torch.cuda.synchronize()
        self.times[step] = time.perf_counter()
        self.records.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if step == TP_STEPS and self.prof is not None:
            self.prof.stop()
            steps = TP_STEPS - TP_TIMED[1]
            comm = [e for e in self.prof.key_averages()
                    if any(k in e.key.lower() for k in TP_COMM_EVENTS)]
            self.comm_ms = sum(e.self_cpu_time_total for e in comm) / 1e3 / steps
            self.comm_calls = {e.key: e.count // steps for e in comm}
            self.prof = None
        if step == TP_TIMED[1] and trainer.mesh is not None:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            self.prof.start()

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None: ...

    def on_train_end(self, trainer) -> None: ...


def tp_fit(device, mesh_shape=None, task=None) -> dict:
    """TP_STEPS steps of :func:`tp_task` (or ``task``, built by it) at b128
    through ``Trainer.fit`` (on ``mesh_shape``, or undistributed), launches
    counted from 0: the records, the launches, the plain-route count, ms a
    step over TP_TIMED (median), the collectives' host time a step, and the
    weights whole on the CPU, at the start and after the steps."""
    import torch

    from mmlearn_tpu_torch.ops.fused_attention import PLAIN_ROUTE
    from mmlearn_tpu_torch.trainer import Trainer
    from mmlearn_tpu_torch.trainer.state import full_state

    task = tp_task(device) if task is None else task.to(device)
    start = {n: p.detach().float().cpu() for n, p in task.named_parameters()}
    probe = TPProbe()
    trainer = Trainer(max_steps=TP_STEPS, log_every_n_steps=1, mesh_shape=mesh_shape,
                      callbacks=[probe], device=device, seed=SEED)
    loader = SyntheticPairs(TP_STEPS, TP_BATCH, SEED + 171, device)
    reset_counts()
    PLAIN_ROUTE["xla"] = 0
    state = trainer.fit(task, loader)
    torch.cuda.synchronize()
    counts = launch_counts()
    t = probe.times
    steps_ms = [(t[i] - t[i - 1]) * 1e3 for i in range(TP_TIMED[0], TP_TIMED[1] + 1)]
    weights = {k: v.detach().float().cpu() for k, v in
               full_state({n: p for n, p in state.task.named_parameters()}).items()}
    heads = {}
    for name, mod in state.task.named_modules():
        if type(mod).__name__ == "Attention":
            heads[name.split(".")[1]] = mod.model_shard
    return {"records": probe.records, "counts": counts, "plain": PLAIN_ROUTE["xla"],
            "steps_ms": steps_ms, "ms": statistics.median(steps_ms),
            "comm_ms": probe.comm_ms, "comm_calls": probe.comm_calls, "weights": weights,
            "start": start,
            "model_shard": heads, "depth": sum(len(e.blocks) for e in state.task.encoders.values())}


def tp_layouts(device) -> dict:
    """Each ``TP_LAYOUTS`` attention layer (bf16, biases from N(0,
    ``TP_BIAS_STD``)) split over the global mesh's ``model`` group, one
    forward and backward at batch ``TP_LAYOUT_BATCH`` with launches counted
    from 0, against the same layer unsplit on the same rank: ``{label:
    {"plan", "counts", "plain", "y_rel", "dx_rel"}}``."""
    import copy

    import torch

    from mmlearn_tpu_torch.flagship import ragged_text_batch
    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.ops.fused_attention import PLAIN_ROUTE, shard_plan
    from mmlearn_tpu_torch.parallel.mesh import get_global_mesh
    from mmlearn_tpu_torch.parallel.partitioning import infer_param_specs
    from mmlearn_tpu_torch.parallel.tensor_parallel import parallelize

    mesh = get_global_mesh()
    b = TP_LAYOUT_BATCH
    results = {}
    for i, (label, h, d, n, causal, masked) in enumerate(TP_LAYOUTS):
        torch.manual_seed(SEED + 176 + i)
        attn = Attention(h * d, h, qkv_bias=True, causal=causal, dtype=torch.bfloat16)
        with torch.no_grad():
            for p in (attn.qkv.bias, attn.proj.bias):
                p.normal_(0.0, TP_BIAS_STD)
        attn = attn.to(device)
        whole = copy.deepcopy(attn)
        layer = torch.nn.ModuleDict({"attn": attn})
        parallelize(layer, mesh, infer_param_specs(layer, mesh))
        g = torch.Generator(device=device).manual_seed(SEED + 180 + i)
        x = torch.randn(b, n, h * d, generator=g, device=device)
        dy = torch.randn(b, n, h * d, generator=g, device=device).to(torch.bfloat16)
        mask = ragged_text_batch(b, g, device)["text_attention_mask"].bool() if masked else None
        reset_counts()
        PLAIN_ROUTE["xla"] = 0
        xs = x.clone().requires_grad_()
        y = attn(xs, mask)
        (dx,) = torch.autograd.grad(y, xs, dy)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        plain = PLAIN_ROUTE["xla"]
        xw = x.clone().requires_grad_()
        yw = whole(xw, mask)
        (dxw,) = torch.autograd.grad(yw, xw, dy)
        results[label] = {"plan": shard_plan(h, d, b, mesh), "counts": counts, "plain": plain,
                          "y_rel": rel_err(y, yw), "dx_rel": rel_err(dx, dxw)}
    return results


def gather_through_c10d() -> None:
    """Route the functional all-gather (``DTensor``'s gather of a shard:
    a split layer's replicated bias gradient, ``full_tensor``) through
    c10d's ``all_gather_into_tensor``, the same collective: on CUDA tensors
    gloo carries the latter (and every other collective phase 17 makes),
    while its functional all-gather ends the process (SIGSEGV, torch 2.11
    on the H100). Phase 17's two ranks share one card, which NCCL refuses,
    so gloo carries them; a job of one process a card runs NCCL and needs
    none of this."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed import distributed_c10d

    def all_gather_tensor(self, gather_dim, group, tag=""):
        pg = distributed_c10d._resolve_process_group(funcol._resolve_group_name(group, tag))
        n = pg.size()
        out = self.new_empty((n * self.shape[0], *self.shape[1:]))
        dist.all_gather_into_tensor(out, self.contiguous(), group=pg)
        return out if gather_dim == 0 else torch.cat(out.chunk(n), dim=gather_dim)

    funcol.all_gather_tensor = all_gather_tensor


def tp_worker(out_dir: str) -> None:
    """One rank of phase 17's job, started by ``run_workers``: joins the
    group over gloo on ``cuda:0`` (both ranks share the card), runs
    :func:`tp_fit` on TP_MESH and saves its result (the weights from rank 0)
    to ``<out_dir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from mmlearn_tpu_torch.parallel.mesh import init_from_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LOCAL_RANK"] = "0"  # both ranks' card
    device = init_from_env("cuda:0", backend="gloo")
    gather_through_c10d()
    result = tp_fit(device, TP_MESH)
    result["layouts"] = tp_layouts(device)
    rank = dist.get_rank()
    result.update(backend=dist.get_backend(), world=dist.get_world_size(), rank=rank)
    if rank:
        result.pop("weights")
    result.pop("start")
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def tp_phase(device) -> dict:
    """Phase 17 (see the module docstring). Returns rank 0's launches on
    the fit."""
    import shutil

    import torch

    from mmlearn_tpu_torch.parallel.mp_launch import run_workers

    root = os.path.join(WORK_DIR, "tensor_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = f"import chip_smoke; chip_smoke.tp_worker({root!r})"
    t0 = time.perf_counter()
    spawned: dict = {}

    def spawn() -> None:
        try:
            spawned["out"] = run_workers([[sys.executable, "-c", code]] * 2, env=env, cwd=REPO,
                                         timeout=420)
        except BaseException as err:  # noqa: BLE001 - raised below
            spawned["error"] = err

    thread = threading.Thread(target=spawn)
    thread.start()
    master = tp_task("cpu")  # the undistributed run's, built while the ranks run
    thread.join()
    if "error" in spawned:
        raise spawned["error"]
    print(f"tensor-parallel path: 2 ranks on one card in {time.perf_counter() - t0:.1f} s; "
          "rank 0's last lines:\n" + "\n".join(spawned["out"][0].splitlines()[-3:]))
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    t0 = time.perf_counter()
    want = tp_fit(device, task=master)
    print(f"tensor-parallel path: the undistributed trainer in {time.perf_counter() - t0:.1f} s")
    for r, got in enumerate(ranks):
        check(got["backend"] == "gloo" and got["world"] == 2 and got["rank"] == r,
              f"tensor-parallel path rank {r}: backend {got['backend']}, world {got['world']}")
        check(got["model_shard"] == {"rgb": (r, 2), "text": (r, 2)},
              f"tensor-parallel path rank {r}: heads split {got['model_shard']}")
    # launches: each rank runs every block on its heads, so the undistributed run's counts
    kernels = ("fused_mha_fwd", "fused_mha_bwd", "layernorm_fwd", "layernorm_bwd")
    per_step = {"fused_mha_fwd": want["depth"], "fused_mha_bwd": 2 * want["depth"],
                "layernorm_fwd": 2 * want["depth"], "layernorm_bwd": 2 * want["depth"]}
    for label, res in (("undistributed", want), ("rank 0", ranks[0]), ("rank 1", ranks[1])):
        counts = res["counts"]
        print(f"tensor-parallel path ({label}): launched " + ", ".join(
            f"{k} {counts[k]} (want {per_step[k] * TP_STEPS}: {per_step[k]} a step)"
            for k in kernels) + f"; the plain route {res['plain']} times")
        check(all(counts[k] == per_step[k] * TP_STEPS for k in kernels),
              f"tensor-parallel path ({label}) launches")
        check(res["plain"] == 0, f"tensor-parallel path ({label}): the sharded plan's plain "
              f"route taken {res['plain']} times")
        check(counts["int8_qmm"] == counts["int8_qmm_bytes"] == 0,
              f"K5 launched on the tensor-parallel path without {QUANT_ENV}")
    # the numbers: every step's loss and grad_norm, every parameter after the steps
    loss_rel = max(max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(res["records"],
                                                                    want["records"]))
                   for res in ranks)
    norm_rel = max(max(abs(g[1] - w[1]) / abs(w[1]) for g, w in zip(res["records"],
                                                                    want["records"]))
                   for res in ranks)
    got_w, want_w, start = ranks[0]["weights"], want["weights"], want["start"]
    check(set(got_w) == set(want_w), "tensor-parallel path: parameter names")
    weight_rel = {n: rel_err(got_w[n], want_w[n]) for n in want_w}
    update_rel = {n: float((got_w[n] - want_w[n]).norm() / (want_w[n] - start[n]).norm())
                  for n in want_w if bool((want_w[n] != start[n]).any())}
    worst = max(weight_rel, key=weight_rel.get)
    worst_update = max(update_rel, key=update_rel.get)
    print(f"tensor-parallel path: losses {['%.6f' % r[0] for r in ranks[0]['records']]} "
          f"(undistributed {['%.6f' % r[0] for r in want['records']]}); grad_norm "
          f"{['%.4f' % r[1] for r in ranks[0]['records']]} (undistributed "
          f"{['%.4f' % r[1] for r in want['records']]})")
    print(f"tensor-parallel path: largest relative difference from the undistributed run: "
          f"loss {loss_rel:.3e} (limit {TP_LOSS_REL:.1e}), grad_norm {norm_rel:.3e} (limit "
          f"{TP_NORM_REL:.1e}); after {TP_STEPS} steps ||got - want|| / ||want|| "
          f"{weight_rel[worst]:.3e} at {worst} (limit {TP_WEIGHT_REL:.1e}; median over "
          f"{len(weight_rel)} tensors {statistics.median(weight_rel.values()):.3e}), over the "
          f"update ||got - want|| / ||want - start|| {update_rel[worst_update]:.3e} at "
          f"{worst_update} (limit {TP_UPDATE_REL:.1e}; median {statistics.median(update_rel.values()):.3e})")
    for r, res in enumerate(ranks):
        calls = ", ".join(f"{k} {v}" for k, v in sorted(res["comm_calls"].items()))
        print(f"tensor-parallel path rank {r}: steps {TP_TIMED[0]}-{TP_TIMED[1]} "
              f"{', '.join(f'{x:.2f}' for x in res['steps_ms'])} ms (median {res['ms']:.2f}); "
              f"collectives' host time {res['comm_ms']:.2f} ms a step (steps "
              f"{TP_TIMED[1] + 1}-{TP_STEPS} under torch.profiler; a step's calls: {calls})")
    print(f"tensor-parallel path train b{TP_BATCH}: model=2 on one card over gloo "
          f"{ranks[0]['ms']:.2f} / {ranks[1]['ms']:.2f} ms a step a rank, the undistributed "
          f"trainer {want['ms']:.2f} ms ({ranks[0]['ms'] / want['ms']:.3f} x)")
    # the layouts whose plan says "xla": the local heads on K3, no plain route
    want_counts = {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    for label, *_ in TP_LAYOUTS:
        for r, res in enumerate(ranks):
            got = res["layouts"][label]
            print(f"tensor-parallel path rank {r}, {label}: plan {got['plan']!r}, launched "
                  f"{got['counts']}, the plain route {got['plain']} times; against the layer "
                  f"unsplit: output {got['y_rel']:.3e}, input gradient {got['dx_rel']:.3e} "
                  f"(limit {TP_LAYOUT_REL:.1e})")
            check(got["plan"] == "xla", f"tensor-parallel path, {label}: plan {got['plan']!r}")
            check(got["counts"] == want_counts and got["plain"] == 0,
                  f"tensor-parallel path rank {r}, {label}: launched {got['counts']}, the "
                  f"plain route {got['plain']} times (want {want_counts}, 0)")
            check(max(got["y_rel"], got["dx_rel"]) <= TP_LAYOUT_REL,
                  f"tensor-parallel path rank {r}, {label}: off the unsplit layer by "
                  f"{max(got['y_rel'], got['dx_rel']):.3e}")
    check(ranks[0]["records"] == ranks[1]["records"],
          "tensor-parallel path: the two ranks' records differ")
    check(loss_rel <= TP_LOSS_REL, f"tensor-parallel path: loss off by {loss_rel:.3e}")
    check(norm_rel <= TP_NORM_REL, f"tensor-parallel path: grad_norm off by {norm_rel:.3e}")
    check(weight_rel[worst] <= TP_WEIGHT_REL,
          f"tensor-parallel path: {worst} off by {weight_rel[worst]:.3e}")
    check(update_rel[worst_update] <= TP_UPDATE_REL,
          f"tensor-parallel path: {worst_update}'s update off by {update_rel[worst_update]:.3e}")
    return ranks[0]["counts"]


# phase 18: the med_benchmarking experiments through the port's CLI: the
# medical CLIP pretraining (baseline.yaml) on files in the four image-text
# readers' layouts, the zero-shot classification job
# (zeroshot_classification_eval.yaml) from its last checkpoint, and
# bioscan_1m.yaml composed on the card
MED_SEARCHPATH = "pkg://mmlearn_tpu_torch.projects.med_benchmarking.configs"
BIOSCAN_SEARCHPATH = "pkg://mmlearn_tpu_torch.projects.bioscan_clip.configs"
MED_PAIRS = 1024  # pairs of each train reader: 16 micro-batches of 256, 4 optimizer steps
MED_VALID = 640  # PMC-OA's valid split: 3 batches of 256, the last padded
MED_EVAL = 256  # images of each zero-shot test set kept on the card
#: image sizes (h, w) around 224, so that the transform resizes and crops
MED_HW = ((224, 224), (200, 264), (256, 240), (240, 320), (288, 216), (232, 208))
MED_MERGES = 600  # BPE merges learned from the captions
MED_MARKS = (4, 8, 12, 16)  # 3 timed windows of one optimizer step each
MED_PIXEL_ROWS = 8  # seeded indices of each reader held to a plain PIL decode
MED_CPU_ROWS = 64  # images of each kept test set on the card against the CPU
CLIP_VOCAB = 49408  # the text tower's vocabulary: every id of the local one below it
CHEXPERT_LABELS = 14
#: each reader's files under the phase's root and the variable its root comes from
MED_ROOTS = (("pmcoa", "PMCOA_ROOT_DIR"), ("roco", "ROCO_ROOT_DIR"),
             ("mimic", "MIMICIVCXR_ROOT_DIR"), ("quilt", "QUILT_ROOT_DIR"),
             ("ham10000", "HAM10000_ROOT_DIR"), ("pad_ufes_20", "PAD_UFES_20_ROOT_DIR"),
             ("medmnist", "MEDMNISTPLUS_ROOT_DIR"))
#: the zero-shot YAML's test sets whose readers need a package the card's
#: host lacks; they are held on the CPU (tests/test_torch_med_benchmarking.py)
MED_DROPPED = {
    "bach": "the HuggingFace hub through 'datasets'",
    "pcam": "the HuggingFace hub through 'datasets'",
    "nck_crc": "the HuggingFace hub through 'datasets'",
    "lc25000_lung": "a save_to_disk cache through 'datasets'",
    "lc25000_colon": "a save_to_disk cache through 'datasets'",
    "sicap": "xlsx partitions through pandas and openpyxl",
}
MED_MNIST = (("pathmnist", 9), ("dermamnist", 7))
MED_HAM_DX = ("nv", "mel", "bkl", "bcc", "akiec", "vasc", "df")
MED_PAD_DX = ("BCC", "MEL", "SCC", "ACK", "NEV", "SEK")
MED_WORDS = (
    "chest", "x-ray", "CT", "MRI", "axial", "coronal", "sagittal", "image", "showing", "the",
    "left", "right", "upper", "lower", "lobe", "lung", "liver", "kidney", "brain", "heart",
    "mass", "lesion", "nodule", "opacity", "effusion", "pleural", "consolidation", "edema",
    "fracture", "tumor", "carcinoma", "benign", "malignant", "tissue", "stained", "H&E",
    "histology", "biopsy", "patient", "with", "no", "evidence", "of", "acute", "chronic",
    "mild", "moderate", "severe", "enlarged", "normal", "abnormal", "arrow", "indicates",
    "figure", "panel", "(a)", "(b)", "contrast-enhanced", "ultrasound", "cells", "gland",
    "mucosa", "stroma", "cm", "mm", "in", "and", "a", "is", "seen", "at", "level",
)
MED_QUILT_SUBSETS = ("youtube", "pubmed", "twitter", "laion")


def med_caption(seed: int, tag: int, idx: int, words=(4, 40)) -> str:
    """Caption ``idx`` of set ``tag``: ``words`` seeded words of
    ``MED_WORDS``, a number now and then, commas."""
    import numpy as np

    rng = np.random.default_rng((seed, tag, idx, 1))
    out = []
    for _ in range(int(rng.integers(*words))):
        r = rng.random()
        out.append(str(round(float(rng.uniform(0.5, 30.0)), 1)) if r < 0.06 else
                   MED_WORDS[int(rng.integers(len(MED_WORDS)))] + ("," if r > 0.95 else ""))
    return " ".join(out).rstrip(",") + "."


def med_image(seed: int, tag: int, idx: int, hw) -> "np.ndarray":
    """Image ``idx`` of set ``tag``: a smooth seeded pattern (three plane
    waves and a blob, each a sum of outer products of 1-d profiles, so that
    a few thousand images take seconds), uint8 of shape ``hw + (3,)``."""
    import numpy as np

    rng = np.random.default_rng((seed, tag, idx))
    h, w = hw
    y, x = np.linspace(0, 1, h, dtype=np.float32), np.linspace(0, 1, w, dtype=np.float32)
    f, phase = rng.uniform(0.5, 6.0, (3, 2)), rng.uniform(0, 2 * np.pi, 3)
    cy, cx, r = rng.uniform(0.2, 0.8, 3)
    blob = np.outer(np.exp(-(y - cy) ** 2 / (0.05 * r)), np.exp(-(x - cx) ** 2 / (0.05 * r)))
    channels = []
    for c in range(3):
        # sin(a y + b x + p) = sin(a y + p) cos(b x) + cos(a y + p) sin(b x)
        ay, bx = 2 * np.pi * f[c, 1] * y + phase[c], 2 * np.pi * f[c, 0] * x
        channels.append(np.outer(np.sin(ay), np.cos(bx)) + np.outer(np.cos(ay), np.sin(bx))
                        + blob)
    img = np.stack(channels, axis=-1)
    return ((np.clip(img, -1, 2) + 1) * 85).round().astype(np.uint8)


def _write_med_images(jobs) -> None:
    """Write ``(path, seed, tag, idx, hw, gray)`` images (a worker's share
    of :func:`write_med_tree`): JPEG (quality 90) or PNG by the extension."""
    from PIL import Image

    for path, seed, tag, idx, hw, gray in jobs:
        pil = Image.fromarray(med_image(seed, tag, idx, hw))
        if gray:
            pil = pil.convert("L")
        if path.endswith(".jpg"):
            pil.save(path, quality=90)
        else:
            pil.save(path, compress_level=1)


def write_med_tree(root: str, pairs: int, valid: int, n_eval: int, seed: int = SEED,
                   hw=MED_HW, mnist_px: int = 224, processes: int = 0) -> dict:
    """Files in the layouts of the readers that run on the card, under
    ``root/<name>`` for each name of ``MED_ROOTS``: PMC-OA (``train.jsonl``
    with ``pairs`` and ``valid.jsonl`` with ``valid`` pairs, ``images/``,
    JPEG), ROCO (``train.jsonl``, ``images/``, JPEG), MIMIC-IV-CXR
    (``train.jsonl`` with ``report`` and the 14 CheXpert labels in {1, 0,
    -1}, grayscale PNGs under patient folders), Quilt-1M (``train.csv`` with
    ``image_path``, ``caption`` and ``subset``, ``quilt_1m/``, JPEG),
    HAM10000 (``HAM10000_metadata.csv``, ``images/<image_id>.jpg``),
    PAD-UFES-20 (``metadata.csv`` with empty cells, ``images/``, PNG), each
    of ``n_eval`` images, and MedMNIST+ ``pathmnist_224.npz`` and
    ``dermamnist_224.npz`` (``test_images`` of ``n_eval`` at ``mnist_px``).
    Captions and images from ``(seed, set, index)``; the images in this
    process or in ``processes`` spawned ones. Returns ``{name: root}``."""
    import csv
    import multiprocessing

    import numpy as np

    roots = {name: os.path.join(root, name) for name, _ in MED_ROOTS}
    jobs = []

    def image(name, sub, rel, tag, idx, gray=False):
        path = os.path.join(roots[name], sub, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, seed, tag, idx, hw[idx % len(hw)], gray))

    def jsonl(name, split, rows):
        with open(os.path.join(roots[name], f"{split}.jsonl"), "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in rows)

    for split, n, tag in (("train", pairs, 1), ("valid", valid, 2)):
        rows = []
        for i in range(n):
            rel = f"PMC{tag}{i:06d}_fig{i % 4 + 1}.jpg"
            image("pmcoa", "images", rel, tag, i)
            rows.append({"image": rel, "caption": med_caption(seed, tag, i)})
        jsonl("pmcoa", split, rows)
    rows = []
    for i in range(pairs):
        rel = f"ROCO_{i:05d}.jpg"
        image("roco", "images", rel, 3, i)
        rows.append({"image": rel, "caption": med_caption(seed, 3, i)})
    jsonl("roco", "train", rows)
    rows = []
    for i in range(pairs):
        rel = f"p1{i % 10}/p1{i:07d}/s5{i:07d}.png"
        image("mimic", "images", rel, 4, i, gray=True)
        labels = np.random.default_rng((seed, 4, i, 2)).integers(-1, 2, CHEXPERT_LABELS)
        rows.append({"image": rel, "report": "FINDINGS: " + med_caption(seed, 4, i, (8, 60))
                     + " IMPRESSION: " + med_caption(seed, 5, i, (2, 12)),
                     "label": [float(v) for v in labels]})
    jsonl("mimic", "train", rows)
    os.makedirs(roots["quilt"], exist_ok=True)
    with open(os.path.join(roots["quilt"], "train.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["image_path", "caption", "subset"])
        for i in range(pairs):
            rel = f"{i:06d}.jpg"
            image("quilt", "quilt_1m", rel, 6, i)
            out.writerow([rel, med_caption(seed, 6, i), MED_QUILT_SUBSETS[i % 4]])
    os.makedirs(roots["ham10000"], exist_ok=True)
    with open(os.path.join(roots["ham10000"], "HAM10000_metadata.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["lesion_id", "image_id", "dx", "dx_type", "age", "sex", "localization"])
        for i in range(n_eval):
            image_id = f"ISIC_{24306 + i:07d}"
            image("ham10000", "images", image_id + ".jpg", 7, i)
            out.writerow([f"HAM_{i // 2:07d}", image_id, MED_HAM_DX[(i * 5 + i // 7) % 7],
                          "histo", "" if i % 9 == 0 else 5 * (i % 17), ("male", "female")[i % 2],
                          "back"])
    os.makedirs(roots["pad_ufes_20"], exist_ok=True)
    with open(os.path.join(roots["pad_ufes_20"], "metadata.csv"), "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["patient_id", "lesion_id", "smoke", "age", "img_id", "diagnostic",
                      "biopsed"])
        for i in range(n_eval):
            img_id = f"PAT_{i // 3}_{i}_{100 + i}.png"
            image("pad_ufes_20", "images", img_id, 8, i)
            out.writerow([f"PAT_{i // 3}", i, "" if i % 4 else ("True", "False")[i % 8 // 4],
                          20 + i % 60, img_id, MED_PAD_DX[(i * 7 + i // 5) % 6],
                          ("True", "False")[i % 2]])
    os.makedirs(roots["medmnist"], exist_ok=True)
    for k, (name, classes) in enumerate(MED_MNIST):
        images = np.stack([med_image(seed, 9 + k, i, (mnist_px, mnist_px)) for i in range(n_eval)])
        labels = np.random.default_rng((seed, 9 + k)).integers(0, classes, (n_eval, 1))
        np.savez(os.path.join(roots["medmnist"], f"{name}_224.npz"), test_images=images,
                 test_labels=labels.astype(np.uint8))
    if processes:
        shares = [jobs[k::processes] for k in range(processes)]
        with concurrent.futures.ProcessPoolExecutor(
                processes, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_write_med_images, shares))
    else:
        _write_med_images(jobs)
    return roots


def clip_byte_alphabet() -> dict:
    """CLIP's (and GPT-2's) bytes-to-unicode table: each of the 256 bytes
    as a printable character."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return {b: chars[b] for b in keep + [b for b in range(256) if b not in keep]}


def write_clip_vocab(out_dir: str, texts, merges: int = MED_MERGES) -> dict:
    """A CLIP-format vocabulary under ``out_dir`` for ``HFCLIPTokenizer``:
    ``vocab.json`` (the 256 byte characters, their ``</w>`` forms, the
    tokens of ``merges`` BPE merges learned from ``texts``, then
    ``<|startoftext|>`` and ``<|endoftext|>``, the two highest ids, as in
    CLIP's vocabulary), ``merges.txt`` and ``tokenizer_config.json`` (the
    pad token ``<|endoftext|>``, as CLIP's). Returns ``{"size", "bos",
    "eos"}``."""
    import collections
    import re

    alphabet = clip_byte_alphabet()
    words: collections.Counter = collections.Counter()
    for text in texts:
        for word in re.findall(r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+|_+",
                               " ".join(text.lower().split())):
            chars = [alphabet[b] for b in word.encode("utf-8")]
            words[tuple(chars[:-1] + [chars[-1] + "</w>"])] += 1
    tokens = list(alphabet.values())
    tokens += [t + "</w>" for t in tokens]
    known, learned = set(tokens), []
    for _ in range(merges):
        pairs: collections.Counter = collections.Counter()
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        learned.append(best)
        if best[0] + best[1] not in known:
            known.add(best[0] + best[1])
            tokens.append(best[0] + best[1])
        merged: collections.Counter = collections.Counter()
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in learned))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "model_max_length": 77,
                   "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
                   "do_lower_case": True}, f)
    return {"size": len(tokens), "bos": len(tokens) - 2, "eos": len(tokens) - 1}


def med_captions(seed: int = SEED, pairs: int = MED_PAIRS, valid: int = MED_VALID) -> list:
    """Every caption and report :func:`write_med_tree` writes."""
    texts = [med_caption(seed, tag, i) for tag, n in ((1, pairs), (2, valid), (3, pairs),
                                                      (6, pairs)) for i in range(n)]
    return texts + [med_caption(seed, 4, i, (8, 60)) + " " + med_caption(seed, 5, i, (2, 12))
                    for i in range(pairs)]


def eos_positions(ids, mask) -> tuple:
    """Each row's pooled position (``input_ids.argmax(-1)``, the text
    tower's EOS pooling) and the position of its attention mask's last 1."""
    import numpy as np

    ids, mask = np.asarray(ids), np.asarray(mask)
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1] > 0, axis=1)
    return ids.argmax(-1), last


def _host(value):
    import numpy as np
    import torch

    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


@contextlib.contextmanager
def encode_spy():
    """Record what the evaluation hooks encode: each (batch, modality) once,
    its raw embeddings (f32, on the host) with the batch's dataset index,
    targets and validity where it has them, and each text batch's pooled
    and last-unmasked positions; the host clock after each call; and the
    classification hook's class
    embeddings (f64) at each epoch's end. A spy on ``EvalRuntime.encode``
    (the forward is the runtime's own: nothing is encoded twice)."""
    from mmlearn_tpu_torch.constants import DATASET_INDEX_KEY
    from mmlearn_tpu_torch.datasets.core.modalities import Modalities
    from mmlearn_tpu_torch.tasks import zero_shot_classification as zc
    from mmlearn_tpu_torch.tasks.hooks import EvalRuntime

    rec: dict = {"rows": [], "classes": [], "clock": []}
    encode, epoch_end = EvalRuntime.encode, zc.ZeroShotClassification.on_evaluation_epoch_end
    text = Modalities.get_modality("text")

    def spy(self, batch, modality, normalize=False):
        fresh = batch is not self._batch or modality not in self._encoded
        out = encode(self, batch, modality, normalize)
        rec["clock"].append(time.perf_counter())
        if fresh:
            meta = {k: _host(batch[k]) for k in (DATASET_INDEX_KEY, "rgb_target", "batch_validity")
                    if k in batch}
            if modality == "text":
                meta["eos"] = eos_positions(_host(batch[text.name]),
                                            _host(batch[text.attention_mask]))
            rec["rows"].append((modality, self._encoded[modality].float().cpu().numpy(), meta))
        return out

    def keep(self, runtime):
        rec["classes"].append({d: e.double().cpu().numpy()
                               for d, e in self._class_embeddings.items()})
        return epoch_end(self, runtime)

    EvalRuntime.encode, zc.ZeroShotClassification.on_evaluation_epoch_end = spy, keep
    try:
        yield rec
    finally:
        EvalRuntime.encode, zc.ZeroShotClassification.on_evaluation_epoch_end = encode, epoch_end


def spied_rows(rec, modality: str, with_validity: bool = True):
    """The recorded batches of ``modality`` (those with a ``batch_validity``
    only, or those without), their rows concatenated, padding dropped:
    ``(embeddings, meta)``; ``meta["eos"]`` the pooled and last-unmasked
    positions of text rows."""
    import numpy as np

    parts = [(emb, meta) for mod, emb, meta in rec["rows"]
             if mod == modality and ("batch_validity" in meta) == with_validity]
    keep = [meta.get("batch_validity", np.ones(len(emb), bool)) for emb, meta in parts]
    emb = np.concatenate([e[k] for (e, _), k in zip(parts, keep)])
    meta = {key: np.concatenate([m[key][k] for (_, m), k in zip(parts, keep)])
            for key in parts[0][1] if key not in ("batch_validity", "eos")}
    if "eos" in parts[0][1]:
        meta["eos"] = tuple(np.concatenate([m["eos"][i][k] for (_, m), k in zip(parts, keep)])
                            for i in (0, 1))
    return emb, meta


class MedProbe:
    """A callback that phase 18 adds to the experiment's trainer through the
    CLI (``+trainer.callbacks.probe``). Keeps the trainer; the host clock at
    the start of training and after the first micro-step; at the first
    optimizer step (micro-step ``accumulate_grad_batches``) the names of the
    trained tensors whose applied gradient is missing, not finite or zero;
    after each micro-step in ``marks`` the host clock (after a synchronize)
    and the feeder's wait; after the last mark the launch counts (training
    only: the validation comes after); the validation's metrics."""

    runs: list = []

    def __init__(self, marks=()) -> None:
        self.marks = sorted(marks)
        self.times, self.waits = {}, {}
        self.trainer = self.bad = self.train_counts = self.metrics = None
        self.t_start = self.t_first = None
        MedProbe.runs.append(self)

    def on_train_start(self, trainer) -> None:
        self.trainer = trainer
        self.t_start = time.perf_counter()

    def on_train_batch_end(self, trainer, metrics, step) -> None:
        import torch

        if step == 1:
            torch.cuda.synchronize()
            self.t_first = time.perf_counter()
        if step == trainer.accumulate_grad_batches:
            bad, zero = _bad_grads((n, p) for n, p in trainer.state.task.named_parameters()
                                   if p.requires_grad)
            self.bad = bad + zero
        if step in self.marks:
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
            self.waits[step] = trainer.feeder_wait_s
        if self.marks and step == self.marks[-1]:
            self.train_counts = launch_counts()

    def on_train_epoch_end(self, trainer, epoch) -> None: ...

    def on_validation_end(self, trainer, metrics, step) -> None:
        self.trainer = trainer
        self.metrics = dict(metrics)

    def on_train_end(self, trainer) -> None: ...


@contextlib.contextmanager
def med_env(roots: dict):
    """Each reader's root in the variable it reads, inside the block."""
    with contextlib.ExitStack() as stack:
        for name, var in MED_ROOTS:
            stack.enter_context(environ(var, roots[name]))
        yield


def med_pixel_checks(roots: dict) -> None:
    """For ``MED_PIXEL_ROWS`` seeded indices of each reader of the phase,
    its ``rgb`` equal bit for bit to a plain PIL decode of its file (an
    npz row for MedMNIST+) through the eval transform (CLIP's statistics,
    224 px)."""
    import numpy as np
    from PIL import Image

    from mmlearn_tpu_torch.datasets.builtin.image_utils import CLIP_MEAN, CLIP_STD, ImageTransform
    from mmlearn_tpu_torch.projects.med_benchmarking.datasets import (
        HAM10000,
        MIMICIVCXR,
        PMCOA,
        ROCO,
        MedMNISTPlus,
        PadUfes20,
        Quilt,
    )

    plain = ImageTransform(size=224, mean=CLIP_MEAN, std=CLIP_STD)
    readers = {
        "PMC-OA train": (PMCOA(split="train"), lambda d, e: os.path.join(
            roots["pmcoa"], "images", e["image"])),
        "PMC-OA valid": (PMCOA(split="valid"), lambda d, e: os.path.join(
            roots["pmcoa"], "images", e["image"])),
        "ROCO": (ROCO(), lambda d, e: os.path.join(roots["roco"], "images", e["image"])),
        "MIMIC-IV-CXR": (MIMICIVCXR(), lambda d, e: os.path.join(
            roots["mimic"], "images", e["image"])),
        "Quilt": (Quilt(), lambda d, e: os.path.join(roots["quilt"], "quilt_1m",
                                                     e["image_path"])),
    }
    rng = np.random.default_rng(SEED + 180)
    checked, fetch_s = 0, {}
    for label, (ds, path_of) in readers.items():
        for i in rng.choice(len(ds), MED_PIXEL_ROWS, replace=False):
            with Image.open(path_of(ds, ds.entries[i])) as img:
                want = plain(np.asarray(img.convert("RGB")))
            t0 = time.perf_counter()
            got = ds[int(i)]["rgb"]
            fetch_s[label] = fetch_s.get(label, 0.0) + time.perf_counter() - t0
            check(np.array_equal(got, want), f"{label} row {i}: rgb differs")
            checked += 1
    for label, ds, path_of in (
            ("HAM10000", HAM10000(), lambda ds, i: os.path.join(
                roots["ham10000"], "images", f"{ds.paths[i]}.jpg")),
            ("PAD-UFES-20", PadUfes20(), lambda ds, i: os.path.join(
                roots["pad_ufes_20"], "images", ds.paths[i]))):
        for i in rng.choice(len(ds), MED_PIXEL_ROWS, replace=False):
            with Image.open(path_of(ds, int(i))) as img:
                want = plain(np.asarray(img.convert("RGB")))
            check(np.array_equal(ds[int(i)]["rgb"], want), f"{label} row {i}: rgb differs")
            checked += 1
    for name, _ in MED_MNIST:
        ds = MedMNISTPlus(name=name, split="test")
        images = np.load(os.path.join(roots["medmnist"], f"{name}_224.npz"))["test_images"]
        for i in rng.choice(len(ds), MED_PIXEL_ROWS, replace=False):
            check(np.array_equal(ds[int(i)]["rgb"], plain(images[i])),
                  f"MedMNIST+ {name} row {i}: rgb differs")
            checked += 1
    print(f"med path: {checked} rows of {len(readers) + 4} readers equal bit for bit to a plain "
          f"PIL decode of their files through the eval transform; a train example's fetch "
          f"on one thread: " + ", ".join(f"{label} {t / MED_PIXEL_ROWS * 1e3:.2f} ms"
                                          for label, t in fetch_s.items()))


def med_parity(overrides, device) -> dict:
    """One step of ``baseline.yaml``'s task at batch 8 (built by the CLI's
    ``build_experiment`` and ``instantiate`` from the seed), two examples of
    each train reader collated by the YAML's collator (MIMIC's
    ``rgb_target`` present on its two rows only), the kernels on the card
    against the plain versions on the CPU from the same weights: the loss
    and the cosine of every trained gradient, at phase 5's limits, and each
    row's EOS pooled where its attention mask ends. Inputs in bf16, as the
    trainer casts them under ``precision: bf16``. Returns the vocabulary's
    reach (the largest id in the batch)."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.conf import instantiate

    cfg = build_experiment(overrides)
    torch.manual_seed(cfg["seed"])
    t0 = time.perf_counter()
    with torch.device(device):  # the weights drawn on the card: the CPU's fills are slow
        master = instantiate(cfg["task"]).to(device)
    master.prepare_seed = cfg["seed"]
    print(f"med step: the YAML's task built on the {device.type} in "
          f"{time.perf_counter() - t0:.1f} s")
    readers = [instantiate(node) for node in cfg["datasets"]["train"].values()]
    collate = instantiate(cfg["dataloader"]["train"]["collate_fn"])
    host = collate([ds[i] for ds in readers for i in (0, 1)])
    presence = host.get("rgb_target_presence")
    mimic = list(cfg["datasets"]["train"]).index("mimic")
    want = np.arange(PARITY_BATCH) // 2 == mimic
    check(presence is not None and np.array_equal(presence, want),
          f"MIMIC's rgb_target presence in a mixed batch {presence}, want {want}")
    check(np.array_equal(host["rgb_target"][want].reshape(2, -1),
                         np.stack([readers[mimic][i]["rgb_target"] for i in (0, 1)])),
          "MIMIC's rgb_target rows differ from the reader's")
    pooled, last = eos_positions(host["text"], host["text_attention_mask"])
    check(np.array_equal(pooled, last), f"EOS pooled at {pooled}, the masks end at {last}")
    host = master.prepare_batch(host, 0)
    tasks = {"card": master, "cpu": copy.deepcopy(master).to("cpu")}  # before any gradient
    losses, grads = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        task = tasks[where]
        batch = {k: (torch.as_tensor(v).to(dev, torch.bfloat16) if k == "rgb" else v)
                 for k, v in host.items()}
        loss, _ = task.loss_fn(batch)
        loss.backward()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu() for n, p in task.named_parameters()
                        if p.requires_grad}
        print(f"med step b={PARITY_BATCH} on the {where}: loss {losses[where]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    cos = {n: _cosine(grads["card"][n], grads["cpu"][n]) for n in grads["cpu"]}
    worst = min(cos, key=cos.get)
    print(f"med step parity b={PARITY_BATCH}, card vs CPU: loss rel diff {rel:.3e} (tol "
          f"{LOSS_RTOL}); gradient cosine min {cos[worst]:.6f} at {worst}, median "
          f"{statistics.median(cos.values()):.6f} over {len(cos)} tensors (bound "
          f"{MIN_GRAD_COSINE}); MIMIC's rgb_target on rows {np.flatnonzero(want).tolist()} "
          f"of the mixed batch; EOS pooled at the masks' ends {last.tolist()}")
    check(rel <= LOSS_RTOL, f"med loss on the card {losses['card']} vs CPU {losses['cpu']}")
    check(cos[worst] >= MIN_GRAD_COSINE, f"med gradient of {worst}: cosine {cos[worst]}")
    return int(np.asarray(host["text"]).max())


def med_train(data, device, root: str) -> tuple:
    """Run A of phase 18: ``baseline.yaml`` through ``cli.run.main`` for one
    epoch, every count set to 0 first. Returns
    (the task, the launch counts of training and of the validation, the
    checkpoint directory)."""
    import math

    import numpy as np
    import torch

    from mmlearn_tpu_torch.cli.run import main as cli_main
    from mmlearn_tpu_torch.ops.fused_attention import PLAIN_ROUTE

    out = os.path.join(root, "A")
    ckpt = os.path.join(out, "checkpoints")
    argv = [*data, "trainer.max_epochs=1", f"runtime.output_dir={out}",
            f"+trainer.callbacks.checkpoint.dirpath={ckpt}", "trainer.log_mfu=true",
            "+trainer.callbacks.probe._target_=chip_smoke.MedProbe",
            f"+trainer.callbacks.probe.marks={list(MED_MARKS)}"]
    reset_counts()
    PLAIN_ROUTE["xla"] = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with encode_spy() as rec:
        state = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    probe = MedProbe.runs[-1]
    task, trainer = state.task, probe.trainer
    k = trainer.accumulate_grad_batches
    print(f"med path: run A through the CLI in {wall:.1f} s ({state.step} micro-steps, "
          f"{state.step // k} optimizer steps of {k}); {probe.t_start - t0:.1f} s from main to "
          f"the fit's start, {probe.t_first - t0:.1f} s to the end of the first micro-step")
    check(state.step == MED_MARKS[-1] and k == 4 and trainer.max_epochs == 1,
          f"run A took {state.step} micro-steps at accumulate_grad_batches={k}")
    check(trainer.device.type == "cuda" and next(task.parameters()).is_cuda,
          "the CLI's trainer did not run on the card")
    check(all(getattr(enc.blocks, "remat", False) for enc in task.encoders.values()),
          "the towers are not under remat")
    want = large_launches(task, remat=True)
    train = probe.train_counts
    print(f"med path: {state.step} micro-steps launched " + ", ".join(
        f"{key} {train[key]} ({train[key] / state.step:g} a micro-step, want {v})"
        for key, v in want.items() if v))
    check(train == {key: v * state.step for key, v in want.items()} and PLAIN_ROUTE["xla"] == 0,
          f"med launches {train}, want {want} a micro-step; plain routes {PLAIN_ROUTE}")
    check(probe.bad is not None and not probe.bad,
          f"missing, non-finite or zero gradients at the first optimizer step: "
          f"{(probe.bad or [])[:10]}")
    print(f"med path: every trained gradient finite and nonzero at the first optimizer step")
    hist = trainer.history
    print(f"med path: loss micro-step 0 {hist[0]['loss']:.6f}, {len(hist) - 1} "
          f"{hist[-1]['loss']:.6f}; lr {hist[0]['lr']:.4e} -> {hist[-1]['lr']:.4e}")
    check(all(math.isfinite(h["loss"]) for h in hist), "non-finite med losses")

    # the validation: its launches, recalls in f64, EOS at the masks' ends
    val = {key: counts[key] - train[key] for key in counts}
    rgb, rgb_meta = spied_rows(rec, "rgb")
    text, text_meta = spied_rows(rec, "text")
    n_val = -(-MED_VALID // BATCH)
    depth = sum(len(enc.blocks) for enc in task.encoders.values())
    passes = 2 if task.compute_validation_loss else 1
    want_val = {"fused_mha_fwd": passes * depth * n_val, "layernorm_fwd": 2 * passes * depth * n_val}
    print(f"med path: validation over {len(rgb)} PMC-OA valid pairs in {n_val} batches "
          f"launched {', '.join(f'{key} {v}' for key, v in val.items() if v)} (want "
          f"{want_val}: the loss and the hooks' forwards)")
    check(val == {key: want_val.get(key, 0) for key in val}, f"validation launches {val}")
    check(len(rgb) == len(text) == MED_VALID, f"the hooks saw {len(rgb)} and {len(text)} pairs")
    pooled, last = text_meta["eos"]
    check(np.array_equal(pooled, last), "EOS not pooled where the attention mask ends")
    ks = (10, 50, 200)
    metrics, differ = probe.metrics, {}
    for name, (q, t) in (("rgb_to_text", (rgb, text)), ("text_to_rgb", (text, rgb))):
        recalls, gap = recall_f64(q, t, ks)
        for kk, v in recalls.items():
            got = metrics[f"retrieval/{name}_R@{kk}"]
            if got != v:
                differ[f"{name}_R@{kk}"] = (got, v)
        print(f"med path: {name} recall {', '.join(f'R@{kk} {v:.4f}' for kk, v in recalls.items())}"
              f" (f64 from the gathered embeddings; least nonzero distance of a score from its "
              f"positive's {gap:.3e}); validation loss {metrics.get('validation/loss', float('nan')):.6f}")
    check(not differ, f"med recalls differ from their f64 recomputation: {differ}")

    # the windows inside the epoch, while the loader's threads decode the
    # next batches; the last one after the loader has drained (its batches
    # already queued), for the step's own pace
    marks = sorted(probe.times)
    window_s = [probe.times[b] - probe.times[a] for a, b in zip(marks, marks[1:])]
    waits = [probe.waits[b] - probe.waits[a] for a, b in zip(marks, marks[1:])]
    steps = [b - a for a, b in zip(marks, marks[1:])]
    rates = [BATCH * n / w for n, w in zip(steps, window_s)]
    # the epoch's windows pooled: all their pairs over all their seconds
    inside_s, inside_steps = sum(window_s[:-1]), sum(steps[:-1])
    rate = BATCH * inside_steps / inside_s
    ms = inside_s / inside_steps * 1e3
    flops = trainer._step_flops or 0.0
    mfu = flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"med train b{BATCH} x {k} through the CLI: {rate:.1f} pairs/s over the "
          f"{len(rates) - 1} windows of {steps[0]} micro-steps inside the epoch "
          f"({BATCH * inside_steps} pairs in {inside_s:.3f} s; each window "
          f"{', '.join(f'{r:.1f}' for r in rates[:-1])}), {ms:.2f} ms a micro-step, "
          f"{flops / 1e12:.3f} TFLOPs a micro-step counted, MFU {mfu:.2%} of "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, the feeder's wait "
          f"{sum(waits[:-1]) / inside_s:.2%} of those windows; the last window, "
          f"after the loader drained: {rates[-1]:.1f} pairs/s, "
          f"{window_s[-1] / steps[-1] * 1e3:.2f} ms a micro-step, MFU "
          f"{flops / (window_s[-1] / steps[-1]) / PEAK_FLOPS['bfloat16']:.2%}; peak memory "
          f"{peak_gb:.2f} GB; card {card}")
    MedProbe.runs.clear()
    return task, train, val, ckpt


def med_eval(device, vocab_dir: str, ckpt: str, weights: dict, root: str) -> tuple:
    """Run B of phase 18: ``zeroshot_classification_eval.yaml`` as the eval
    job through ``cli.run.main`` from run A's checkpoint, the test sets
    whose readers need a package the host lacks deleted, every count set to
    0 first. Returns its launch counts and its task."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.cli.run import main as cli_main

    drops = [f"~datasets.test.{name}" for name in MED_DROPPED]
    print("med path: the eval job drops " + "; ".join(
        f"{name} (reads {why})" for name, why in MED_DROPPED.items()))
    argv = [f"searchpath=[{MED_SEARCHPATH}]", "+experiment=zeroshot_classification_eval", *drops,
            "+task.evaluation_tasks.classification.task.tokenizer."
            f"pretrained_model_name_or_path={vocab_dir}", f"resume_from_checkpoint={ckpt}",
            f"runtime.output_dir={os.path.join(root, 'B')}",
            "+trainer.callbacks.probe._target_=chip_smoke.MedProbe"]
    reset_counts()
    t0 = time.perf_counter()
    with encode_spy() as rec:
        results = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    probe = MedProbe.runs.pop()
    task, trainer = probe.trainer.state.task, probe.trainer
    check(trainer.device.type == "cuda" and next(task.parameters()).is_cuda,
          "the eval job did not run on the card")
    got = {k: v for k, v in task.state_dict().items() if hasattr(v, "shape")}
    differ = [k for k in weights if k not in got or not torch.equal(got[k].cpu(), weights[k])]
    check(sorted(got) == sorted(weights) and not differ,
          f"restored weights differ from run A's: {differ[:5]}")
    print(f"med path: the eval job restored run A's {len(weights)} tensors bit for bit")

    rgb, meta = spied_rows(rec, "rgb")
    prompts, prompt_meta = spied_rows(rec, "text", with_validity=False)
    (classes,) = rec["classes"]
    sets = ("ham10000", "pad_ufes_20", "pathmnist", "dermamnist")
    n_batches = -(-len(rgb) // BATCH)
    depth_rgb, depth_text = (len(task.encoders[m].blocks) for m in ("rgb", "text"))
    chunks = len(classes)  # each set's prompts fit one chunk of the hook's 64
    want = {"fused_mha_fwd": depth_rgb * n_batches + depth_text * chunks}
    want["layernorm_fwd"] = 2 * want["fused_mha_fwd"]
    loop_s = rec["clock"][-1] - rec["clock"][len(classes) - 1]  # from the last prompt chunk
    print(f"med path: the eval job over {len(rgb)} images of {len(sets)} sets in {n_batches} "
          f"batches and {len(prompts)} class prompts in {wall:.1f} s, its image batches "
          f"{len(rgb) / loop_s:.1f} images/s ({loop_s:.2f} s from the class embeddings to the "
          f"last batch's encode, the loader's decode on one thread included); launched "
          f"{', '.join(f'{k} {v}' for k, v in counts.items() if v)} (want {want})")
    check(len(rgb) == len(sets) * MED_EVAL and len(classes) == len(sets),
          f"the job saw {len(rgb)} images, {len(classes)} class sets")
    check(counts == {k: want.get(k, 0) for k in counts}, f"eval launches {counts}, want {want}")
    pooled, last = prompt_meta["eos"]
    check(np.array_equal(pooled, last), "a class prompt's EOS not pooled where its mask ends")
    ds, labels = meta["dataset_index"], meta["rgb_target"]
    differ = {}
    for d, name in enumerate(sets):
        acc = accuracy_f64(rgb[ds == d], classes[d], labels[ds == d].astype(np.int64), [1])
        key = f"classification/ds{d}_rgb_top1_accuracy"
        want_acc = acc.get(1, acc.get(0))
        print(f"med path: {name} top-1 accuracy {results[key]:.4f} over {(ds == d).sum()} images, "
              f"{len(classes[d])} classes (f64 {want_acc:.4f})")
        if results[key] != want_acc:
            differ[name] = (results[key], want_acc)
    check(not differ, f"zero-shot accuracies differ from their f64 recomputation: {differ}")
    return counts, task


@contextlib.contextmanager
def skipped_init():
    """``torch.nn.init``'s random fills as no-ops inside the block, for a
    copy whose every weight is loaded after it is built (on the CPU the
    fills take most of a tower's construction)."""
    import torch.nn.init as init

    saved = {name: getattr(init, name) for name in (
        "trunc_normal_", "normal_", "uniform_", "kaiming_uniform_", "xavier_uniform_")}
    for name in saved:
        setattr(init, name, lambda tensor, *args, **kwargs: tensor)
    try:
        yield
    finally:
        for name, fill in saved.items():
            setattr(init, name, fill)


def med_eval_vs_cpu(task, device, vocab_dir: str) -> None:
    """The eval job's hook over the first ``MED_CPU_ROWS`` images of each
    kept test set (the readers at their 224 px, as the YAML reads them) on
    the card and on an f32 CPU copy of the task (plain
    versions): each image's embedding and each class embedding at cosine
    >= ``MIN_COSINE`` (phase 11's limit); the centered readings printed."""
    import numpy as np

    from mmlearn_tpu_torch.datasets.processors.tokenizers import HFCLIPTokenizer
    from mmlearn_tpu_torch.projects.med_benchmarking.datasets import (
        HAM10000,
        MedMNISTPlus,
        PadUfes20,
    )
    from mmlearn_tpu_torch.tasks import ClassificationTaskSpec, EvaluationSpec, ZeroShotClassification
    from mmlearn_tpu_torch.trainer import Trainer

    heads = [Head(ds, MED_CPU_ROWS) for ds in (
        HAM10000(), PadUfes20(), MedMNISTPlus("pathmnist", split="test"),
        MedMNISTPlus("dermamnist", split="test"))]
    hook = {"classification": EvaluationSpec(ZeroShotClassification(
        [ClassificationTaskSpec("rgb", [1])], tokenizer=HFCLIPTokenizer(vocab_dir)),
        run_on_test=True)}
    out = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        if side == "card":
            model = task
        else:
            with skipped_init():
                model = cpu_copy_f32(task)
        model.compute_test_loss = False  # the YAML's: no text in a classification batch
        kept, model.evaluation_tasks = model.evaluation_tasks, hook
        t0 = time.perf_counter()
        with encode_spy() as rec:
            results = Trainer(device=where, precision="bf16" if side == "card" else None).test(
                model, eval_loader(heads))
        model.evaluation_tasks = kept
        out[side] = (spied_rows(rec, "rgb")[0], rec["classes"][0], results)
        print(f"med path, eval on the {side}: {len(heads) * MED_CPU_ROWS} images in "
              f"{time.perf_counter() - t0:.1f} s")
        del model
    (card, card_cls, card_res), (cpu, cpu_cls, cpu_res) = out["card"], out["cpu"]
    worst = {"rgb": _row_cosines(card, cpu).min()}
    worst.update({f"classes ds{d}": _row_cosines(card_cls[d], cpu_cls[d]).min() for d in cpu_cls})
    centered = _centered_agreement(card, cpu, np.arange(len(card)))
    print(f"med path, card vs f32 CPU on {MED_CPU_ROWS} images a set: least row cosine "
          + ", ".join(f"{k} {v:.6f}" for k, v in worst.items()) + f" (bound {MIN_COSINE}); "
          f"centered rgb: least cosine {centered[0]:.6f}, {centered[1]} rows nearer another "
          f"image's CPU row, least margin {centered[2]:.3e} (printed, not held); top-1 card/CPU "
          + ", ".join(f"ds{d} {card_res[k]:.4f}/{cpu_res[k]:.4f}" for d in range(len(heads))
                      for k in [f"classification/ds{d}_rgb_top1_accuracy"]))
    check(all(v >= MIN_COSINE for v in worst.values()), f"med eval card vs CPU: {worst}")


def bioscan_composed(device) -> None:
    """``bioscan_1m.yaml`` composed by the CLI's ``build_experiment`` and its
    ``task`` instantiated on the card (the host has no h5py, so its
    datasets are not built here): parameter names, shapes, LoRA sites and
    the trainable set equal to ``recipe.bioscan_task()``'s."""
    import torch

    from mmlearn_tpu_torch.cli.run import build_experiment
    from mmlearn_tpu_torch.conf import instantiate
    from mmlearn_tpu_torch.projects.bioscan_clip.recipe import bioscan_task

    t0 = time.perf_counter()
    cfg = build_experiment([f"searchpath=[{BIOSCAN_SEARCHPATH}]", "+experiment=bioscan_1m"])
    torch.manual_seed(cfg["seed"])
    with torch.device(device):
        task = instantiate(cfg["task"]).to(device)
    check(all(p.device.type == device.type for p in task.parameters()),
          f"the composed BIOSCAN task is not on {device}")
    with torch.device("meta"):
        recipe = bioscan_task(device="meta")

    def layout(t):
        return ({n: tuple(p.shape) for n, p in t.named_parameters()},
                {n for n, p in t.named_parameters() if p.requires_grad})

    (got, got_trained), (want, want_trained) = layout(task), layout(recipe)
    lora = sorted(n for n in got if "lora" in n)
    print(f"BIOSCAN: bioscan_1m.yaml composed and its task on the card in "
          f"{time.perf_counter() - t0:.1f} s: {len(got)} tensors "
          f"({sum(p.numel() for p in task.parameters()) / 1e6:.2f} M), {len(lora)} LoRA "
          f"factors, {len(got_trained)} trained; equal to recipe.bioscan_task()'s: "
          f"{got == want and got_trained == want_trained}")
    check(got == want, "the composed BIOSCAN task's parameters differ from the recipe's: "
          f"{sorted(set(got) ^ set(want))[:5]}")
    check(got_trained == want_trained and lora == sorted(n for n in want if "lora" in n),
          "the composed BIOSCAN task's LoRA sites or trainable set differ from the recipe's")


def med_path(device) -> dict:
    """Phase 18, the med_benchmarking experiments through the CLI. Returns
    the launch counts of run A (training and validation) and of the eval
    job."""
    import shutil

    import torch

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    root = os.path.join(WORK_DIR, "med")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    roots = write_med_tree(os.path.join(root, "data"), MED_PAIRS, MED_VALID, MED_EVAL,
                           processes=min(8, host_cores()))
    vocab_dir = os.path.join(root, "clip_vocab")
    vocab = write_clip_vocab(vocab_dir, med_captions())
    print(f"med path: {4 * MED_PAIRS} train pairs, {MED_VALID} valid pairs and "
          f"{4 * MED_EVAL} test images written, and a CLIP-format vocabulary of "
          f"{vocab['size']} tokens learned from the captions ({MED_MERGES} merges; "
          f"<|startoftext|> {vocab['bos']}, <|endoftext|> {vocab['eos']}), in "
          f"{time.perf_counter() - t0:.1f} s")
    check(vocab["eos"] == vocab["size"] - 1 < CLIP_VOCAB, f"vocabulary {vocab}")
    tok = f"pretrained_model_name_or_path={vocab_dir}"
    data = [f"searchpath=[{MED_SEARCHPATH}]", "+experiment=baseline",
            f"+dataloader.train.collate_fn.batch_processors.text.{tok}",
            f"+dataloader.val.collate_fn.batch_processors.text.{tok}"]
    with med_env(roots):
        t0 = time.perf_counter()
        med_pixel_checks(roots)
        top = med_parity(data, device)
        check(top == vocab["eos"], f"the largest id of the batch is {top}, not <|endoftext|>")
        print(f"med path: pixel checks and step parity in {time.perf_counter() - t0:.1f} s")
        task, train, val, ckpt = med_train(data, device, root)
        weights = {k: v.detach().cpu().clone() for k, v in task.state_dict().items()
                   if hasattr(v, "shape")}
        del task
        gc.collect()
        t0 = time.perf_counter()
        counts, task = med_eval(device, vocab_dir, ckpt, weights, root)
        del weights
        print(f"med path: eval job checked in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        med_eval_vs_cpu(task, device, vocab_dir)
        del task
        print(f"med path: eval card vs CPU in {time.perf_counter() - t0:.1f} s")
    bioscan_composed(device)
    for key, value in val.items():
        train[key] = train.get(key, 0) + value + counts.get(key, 0)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    return train


# ------------------------------------------------------- the artifact path

# phase 19: serving artifacts (torch.export programs) of every tower kind at
# full width, random weights from SEED, loaded in a fresh process without
# the port's model code and run at ARTIFACT_SIZES from one program; their
# CPU programs at ARTIFACT_CPU_ROWS rows; ARTIFACT_QUERIES b=1 searches of
# each over HTTP and in process, against an index of its own b256 rows
ARTIFACT_SIZES, ARTIFACT_CPU_ROWS, ARTIFACT_QUERIES = (1, 7, 256), 2, 3
ARTIFACT_SEED = SEED + 90
#: the port's model code, blocked in the process that loads the artifacts,
#: with JAX and the JAX package
MODEL_CODE = tuple(f"mmlearn_tpu_torch.{m}" for m in ("modules", "tasks", "bridge", "peft"))
BLOCKED = (*MODEL_CODE, "jax", "jaxlib", "flax", "optax", "mmlearn_tpu.")
#: operations of the attention's and the LayerNorm's plain versions, which
#: no program may hold: both attention versions' products are einsums, the
#: LayerNorm's rstd an rsqrt (a tower's own softmax, BarcodeBERT's pooling,
#: is neither)
PLAIN_OPS = ("aten.einsum", "aten.rsqrt")


def artifact_batch(meta: dict, vocab: int, n: int, device, seed: int) -> dict:
    """``n`` rows of an artifact's inputs (``meta["inputs"]``, in order)
    drawn on ``device`` from ``seed``: standard-normal floats, token ids in
    ``[1, vocab)``, attention masks of 2 to N valid tokens (right padding).
    Torch only, so that the process without the model code draws the same
    rows."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, info in meta["inputs"].items():
        shape = (n, *info["shape"][1:])
        if info["dtype"].startswith("float"):
            out[key] = torch.randn(shape, generator=g, device=device)
        elif key.endswith("_attention_mask"):
            lens = torch.randint(2, shape[1] + 1, (n, 1), generator=g, device=device)
            out[key] = (torch.arange(shape[1], device=device)[None] < lens).to(torch.int32)
        else:
            out[key] = torch.randint(1, vocab, shape, generator=g, device=device,
                                     dtype=torch.int32)
    return out


def artifact_worker(spec_path: str, out_dir: str, platform: str) -> None:
    """Phase 19's fresh processes (the port's model code blocked), one a
    platform, run at once. ``cuda``: each artifact's card program loaded
    and run at ``ARTIFACT_SIZES`` on rows drawn as the parent draws them
    (one forward's launches counted at b=7), and on the
    ``ARTIFACT_CPU_ROWS`` rows; its graph's call targets. ``cpu``: each
    artifact's CPU program on those rows. The outputs in ``out_dir``."""
    import numpy as np
    import torch

    from mmlearn_tpu_torch.serving.export import load_encoder

    with open(spec_path) as f:
        spec = json.load(f)
    device = torch.device(spec.pop("_device", platform))
    results = {}
    reset_counts()
    for label, art in spec.items():
        t0 = time.perf_counter()
        encode = load_encoder(art["dir"], device)
        load_s = time.perf_counter() - t0
        rows = artifact_batch(encode.meta, art["vocab"], ARTIFACT_CPU_ROWS, "cpu", art["seed"])
        outs = {"rows": encode({k: v.to(device) for k, v in rows.items()}).float().cpu().numpy()}
        results[label] = {"load_s": load_s}
        if platform == "cuda":
            for n in ARTIFACT_SIZES:
                batch = artifact_batch(encode.meta, art["vocab"], n, device, art["seed"] + n)
                before = launch_counts()
                outs[f"b{n}"] = encode(batch).float().cpu().numpy()
                if n == 7:
                    counts = {k: v - before[k] for k, v in launch_counts().items()}
            targets = sorted({str(node.target) for node in encode.program.graph.nodes
                              if node.op == "call_function"})
            results[label].update(counts=counts, targets=[
                t for t in targets if t.startswith(("mmlearn.", *PLAIN_OPS))])
        results[label]["run_s"] = time.perf_counter() - t0 - load_s
        np.savez(os.path.join(out_dir, f"{art['name']}.{platform}.npz"), **outs)
        del encode
    leaked = sorted(m for m in sys.modules if m.startswith(BLOCKED))
    with open(os.path.join(out_dir, f"results.{platform}.json"), "w") as f:
        json.dump({"artifacts": results, "launches": launch_counts(), "leaked": leaked}, f)


def _artifact_index(index_dir: str, modality: str, emb) -> None:
    """An index of the rows ``emb`` (example ids their row numbers): one
    shard and the manifest ``EmbeddingIndex.load`` reads."""
    import numpy as np

    os.makedirs(index_dir, exist_ok=True)
    name = f"{modality}_00000.npz"
    np.savez(os.path.join(index_dir, name), embeddings=emb, example_index=np.arange(len(emb)),
             dataset_index=np.zeros(len(emb), np.int64))
    with open(os.path.join(index_dir, "manifest.json"), "w") as f:
        json.dump({modality: {"shards": [name], "rows": len(emb), "dim": emb.shape[1],
                              "normalized": True}}, f)


def _same_row(emb, hit: int, i: int) -> bool:
    """Whether the rank-1 row ``hit`` is row ``i``, or a row of the same
    bits (inputs that the tower maps alike)."""
    import numpy as np

    return hit == i or bool(np.array_equal(emb[hit], emb[i]))


def _serve_artifact(label: str, art: str, modality: str, batch, emb, device):
    """``/embed`` and ``/search`` from the artifact: an index of its b256
    rows ``emb`` (the eager encode's), ``ARTIFACT_QUERIES`` of them searched
    at b=1 over HTTP and in process (each its own rank-1 neighbour);
    ``/embed`` of a row equal to the loaded artifact's ``encode`` of it.
    Returns the p50s and the server's loaded artifact."""
    from http.server import ThreadingHTTPServer

    import numpy as np

    from mmlearn_tpu_torch.serving.server import ServingState, make_handler

    index_dir = os.path.join(WORK_DIR, "artifacts", f"{label}_index")
    # the rows normalized again in f32, as an index is exported: a bf16
    # row's norm lies up to 2^-8 from 1, and fresh towers' rows lie closer
    # than that to one another
    _artifact_index(index_dir, modality, emb / np.linalg.norm(emb, axis=1, keepdims=True))
    state = ServingState(art, index_dir, modality, device=device)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = _start(server)
    ids = [int(i) for i in np.linspace(0, len(emb) - 1, ARTIFACT_QUERIES)]
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    try:
        port = server.server_address[1]
        status, out = _post(port, "/embed", {"inputs": {k: v[:1].tolist()
                                                         for k, v in host.items()}})
        want = state.encode({k: v[:1] for k, v in batch.items()}).float().cpu().numpy()
        check(status == 200 and np.array_equal(np.asarray(out["embeddings"], np.float32), want),
              f"artifact {label}: /embed {status} differs from the artifact's row")
        http = []
        for i in ids:
            body = {"inputs": {k: v[i:i + 1].tolist() for k, v in host.items()}, "k": SEARCH_K}
            t0 = time.perf_counter()
            status, out = _post(port, "/search", body)
            http.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and _same_row(emb, out["example_index"][0][0], i)
                  and abs(out["scores"][0][0] - 1) <= SELF_SCORE_ATOL,
                  f"artifact {label}: /search of row {i}: {status} {out}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    local = []
    for i in ids:
        t0 = time.perf_counter()
        found = state.search({k: v[i:i + 1] for k, v in host.items()}, k=SEARCH_K)
        local.append((time.perf_counter() - t0) * 1e3)
        check(_same_row(emb, found["example_index"][0][0], i),
              f"artifact {label}: in-process search of row {i}: {found}")
    return {"http_p50_ms": statistics.median(http),
            "local_p50_ms": statistics.median(local)}, state.encode


def _artifact_towers(device):
    """Phase 19's towers, one task built at a time: ``(label, task,
    modality, environment, inputs, vocab, attention launch key)``, the
    inputs ``{key: (shape without the batch, dtype)}``."""
    import torch

    from mmlearn_tpu_torch.flagship import (
        TEXT_LENGTH,
        VOCAB_SIZE,
        flagship_task,
        highres_task,
        ijepa_training_task,
    )
    from mmlearn_tpu_torch.projects.bioscan_clip import recipe

    rgb = {"rgb": ((224, 224, 3), "float32")}
    task = flagship_task(device, seed=SEED)
    yield ("flagship_rgb", task, "rgb", {}, rgb, 0, "fused_mha_fwd")
    yield ("flagship_text", task, "text", {},
           {"text": ((TEXT_LENGTH,), "int32"), "text_attention_mask": ((TEXT_LENGTH,), "int32")},
           VOCAB_SIZE, "fused_mha_fwd")
    yield ("flagship_rgb_int8_sb", task, "rgb", {QUANT_ENV: "int8_sb"}, rgb, 0,
           "fused_mha_fwd")
    del task
    yield ("highres_rgb", highres_task(device, seed=SEED), "rgb", {},
           {"rgb": ((448, 448, 3), "float32")}, 0, "flash_fwd")
    yield ("ijepa_rgb_packed", ijepa_training_task(device, seed=SEED).eval(), "rgb",
           {PACKED_ENV: "1"}, rgb, 0, "fused_mha_packed_fwd")
    task = recipe.bioscan_task(dtype="bfloat16", device=device, seed=SEED).eval()
    with torch.no_grad():  # a live LoRA delta: the factors' b drawn, not zero
        for i, (name, p) in enumerate(sorted(task.lora.named_parameters())):
            if name.endswith(".b"):
                p.normal_(0.0, BIOSCAN_PARITY_B_STD,
                          generator=torch.Generator(device=p.device).manual_seed(SEED + i))
    text_n = BIOSCAN_TEXT
    yield ("bioscan_rgb", task, "rgb", {}, rgb, 0, "fused_mha_fwd")
    yield ("bioscan_text", task, "text", {},
           {"text": ((text_n,), "int32"), "text_attention_mask": ((text_n,), "int32")},
           recipe.TEXT["vocab_size"], "fused_mha_fwd")
    yield ("bioscan_dna", task, "dna", {}, {"dna": ((133,), "int32")},
           recipe.DNA["vocab_size"], "fused_mha_fwd")


def artifact_path(device) -> dict:
    """Phase 19 (see the module docstring). Returns the launches of the
    fresh process's runs of the programs."""
    import shutil

    import numpy as np
    import torch

    from mmlearn_tpu_torch.modules.layers.attention import Attention
    from mmlearn_tpu_torch.ops import fused_norm as fn
    from mmlearn_tpu_torch.ops import registered  # noqa: F401 - torch.ops.mmlearn
    from mmlearn_tpu_torch.serving import save_encoder

    root = os.path.join(WORK_DIR, "artifacts")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # a K2f call's host time, direct and through its registered operator
    gen = torch.Generator(device=device).manual_seed(ARTIFACT_SEED)
    x, r = (torch.randn(BATCH * 197, 768, generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    g, b = torch.ones(768, device=device), torch.zeros(768, device=device)
    host = {"LN direct": host_us(lambda: fn.layernorm_forward(x, g, b, 1e-6)),
            "LN operator": host_us(lambda: torch.ops.mmlearn.layernorm(x, g, b, 1e-6)),
            "add+LN direct": host_us(lambda: fn.add_layernorm_forward(x, r, g, b, 1e-6)),
            "add+LN operator": host_us(lambda: torch.ops.mmlearn.add_layernorm(
                x, r, g, b, 1e-6))}
    print("artifact path: a K2f call's host time at (256·197, 768) bf16: " + ", ".join(
        f"{k} {v:.1f} µs" for k, v in host.items()) + " (eager calls launch directly; "
          "programs call the operators)")
    del x, r

    spec, eager, served, depths = {}, {}, {}, {}
    for label, task, modality, env, inputs, vocab, attention in _artifact_towers(device):
        t0 = time.perf_counter()
        meta = {"inputs": {k: {"shape": [1, *shape], "dtype": dt}
                           for k, (shape, dt) in inputs.items()}}
        seed = ARTIFACT_SEED + 10 * len(spec)
        art = os.path.join(root, label)
        with contextlib.ExitStack() as stack:
            for name, value in env.items():
                stack.enter_context(environ(name, value))
            example = artifact_batch(meta, vocab, 2, device, seed)
            save_encoder(art, task, modality, {k: v.cpu().numpy() for k, v in example.items()})
            export_s = time.perf_counter() - t0
            with torch.inference_mode():
                eager[label] = {n: task.encode(artifact_batch(meta, vocab, n, device, seed + n),
                                               modality, normalize=True).float().cpu().numpy()
                                for n in ARTIFACT_SIZES}
                big = artifact_batch(meta, vocab, BATCH, device, seed + BATCH)
                eager_ms = cuda_ms(lambda: task.encode(big, modality, normalize=True),
                                   iters=5, warmup=1)
        encoder = (task.encoders[task.encoder_keys[modality]] if hasattr(task, "encoders")
                   else task.encoder)
        depth = sum(isinstance(m, Attention) for m in encoder.modules())
        depths[label] = (depth, attention, bool(env.get(QUANT_ENV)))
        served[label], encode = _serve_artifact(label, art, modality, big,
                                                eager[label][BATCH], device)
        art_ms = cuda_ms(lambda: encode(big), iters=5, warmup=1)
        served[label].update(export_s=export_s, eager_ms=eager_ms, art_ms=art_ms,
                             mb=sum(os.path.getsize(os.path.join(art, f))
                                    for f in os.listdir(art)) / 2**20)
        spec[label] = {"dir": art, "vocab": vocab, "seed": seed, "name": label}
        del encode, big, example, task
        gc.collect()
        torch.cuda.empty_cache()
        print(f"artifact path, {label}: exported (cuda, cpu) in {export_s:.1f} s, "
              f"{served[label]['mb']:.0f} MB; encode b{BATCH} through the artifact "
              f"{BATCH / art_ms * 1e3:.1f} rows/s, eager {BATCH / eager_ms * 1e3:.1f} "
              f"({art_ms:.2f} / {eager_ms:.2f} ms); /search b=1 p50 HTTP "
              f"{served[label]['http_p50_ms']:.2f} ms, in process "
              f"{served[label]['local_p50_ms']:.2f} ms ({ARTIFACT_QUERIES} queries, each its "
              f"own rank-1 among {BATCH}); in {time.perf_counter() - t0:.1f} s")

    # the fresh processes, one a platform, the model code blocked
    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    procs = {}
    for platform in ("cuda", "cpu"):
        script = (
            "import importlib.abc, sys\n"
            f"BLOCKED = {BLOCKED!r}\n"
            "class Block(importlib.abc.MetaPathFinder):\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name == 'mmlearn_tpu' or name.startswith(BLOCKED):\n"
            "            raise ImportError(f'blocked import of {name}')\n"
            "        return None\n"
            "sys.meta_path.insert(0, Block())\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.artifact_worker({spec_path!r}, {root!r}, {platform!r})\n")
        procs[platform] = subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)
    res = {}
    for platform, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"artifact path: the fresh {platform} process exited "
              f"{proc.returncode}: {err[-3000:]}")
        with open(os.path.join(root, f"results.{platform}.json")) as f:
            res[platform] = json.load(f)
    leaked = sorted({*res["cuda"]["leaked"], *res["cpu"]["leaked"]})
    print(f"artifact path: {len(spec)} artifacts loaded and run in two fresh processes (the "
          f"card's programs, the CPU's) with {', '.join(MODEL_CODE)} blocked in "
          f"{time.perf_counter() - t0:.1f} s; model modules imported there: {leaked or 'none'}")
    check(not leaked, f"artifact path: model code imported: {leaked}")
    for label, (depth, attention, quant) in depths.items():
        got, cpu = res["cuda"]["artifacts"][label], res["cpu"]["artifacts"][label]
        outs = np.load(os.path.join(root, f"{label}.cuda.npz"))
        cpu_rows = np.load(os.path.join(root, f"{label}.cpu.npz"))["rows"]
        equal = {n: bool(np.array_equal(outs[f"b{n}"], eager[label][n])) for n in ARTIFACT_SIZES}
        diff = max(float(np.abs(outs[f"b{n}"] - eager[label][n]).max()) for n in ARTIFACT_SIZES)
        want = {k: 0 for k in got["counts"]}
        want.update({attention: depth, "layernorm_fwd": 2 * depth})
        if quant:
            want["int8_qmm"] = 4 * depth
        ops = {t for t in got["targets"] if t.startswith("mmlearn.")}
        want_ops = {f"mmlearn.{'flash_qkv' if attention == 'flash_fwd' else 'fused_mha'}.default",
                    "mmlearn.add_layernorm.default", *(["mmlearn.int8_qmm.default"] * quant)}
        plain = [t for t in got["targets"] if t.startswith(PLAIN_OPS)]
        cos = _row_cosines(outs["rows"], cpu_rows).min()
        print(f"artifact path, {label}: program vs eager encode on the card bit for bit at b "
              + ", ".join(f"{n} {'yes' if e else 'NO'}" for n, e in equal.items())
              + f" (max |diff| {diff:.3e}); one b=7 forward launched "
              + ", ".join(f"{k} {v}" for k, v in got["counts"].items() if v)
              + f" (depth {depth}); operators {sorted(ops)}; plain operations {plain or 'none'}; "
              f"cpu program vs cuda program on {ARTIFACT_CPU_ROWS} rows: least cosine {cos:.6f} "
              f"(bound {MIN_COSINE}); load and run {got['load_s']:.1f} + {got['run_s']:.1f} s, "
              f"on the CPU {cpu['load_s']:.1f} + {cpu['run_s']:.1f} s")
        check(all(equal.values()), f"artifact {label}: program differs from eager encode "
              f"({equal}, max |diff| {diff})")
        check(got["counts"] == want, f"artifact {label}: launched {got['counts']}, want {want}")
        check(want_ops <= ops and not plain, f"artifact {label}: operators {sorted(ops)}, "
              f"plain {plain}")
        check(cos >= MIN_COSINE, f"artifact {label}: cpu vs cuda cosine {cos}")
    return res["cuda"]["launches"]


def _tensors(state: dict) -> dict:
    return {k: v for k, v in state.items() if hasattr(v, "shape")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card and has nothing to run here",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    os.environ[PACKED_ENV] = "0"  # the default dispatch, whatever the caller's environment
    os.environ.pop(QUANT_ENV, None)  # unquantized until the last phase sets it

    from mmlearn_tpu_torch import _build

    # one nvcc a source, all started together
    t0 = time.perf_counter()
    sources = {"fused_attention": "K1 forward and backward",
               "fused_attention_packed": "K1f-p/K1b-p forward and backward",
               "layernorm_fwd": "K2f LayerNorm forward",
               "layernorm_bwd": "K2b LayerNorm backward",
               "int8_matmul": "K5 quantizing int8 product",
               "flash_attention": "K3 forward and backward"}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(_build.build, name) for name in sources}
        for name, what in sources.items():
            print(f"built {what} {os.path.relpath(built[name].result(), REPO)}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=device).manual_seed(SEED)
    errors = kernel_checks(device, gen)
    norm_checks(device, gen, errors)
    k2f_route_checks(device, errors)
    packed_kernel_checks(device, gen, errors)
    t0 = time.perf_counter()
    flash_kernel_checks(device, gen, errors)
    print(f"K3 checks done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    int8_kernel_checks(device, gen, errors)
    print(f"K5 checks done in {time.perf_counter() - t0:.1f} s")
    # the batch-256 grids of K1 and K2 draw from generators of their own, so
    # that cases added to the batch-8 checks do not change their data
    gen_b = torch.Generator(device=device).manual_seed(SEED + 10)
    times = kernels_at_batch(device, gen_b, errors)
    times.update(norms_at_batch(device, errors))
    k1_draws(device, errors)
    times.update(ijepa_attention_at_batch(device, gen, errors))
    times.update(int8_at_batch(device, gen))
    times.update(flash_at_grids(device, gen, errors))
    times.update(flash_packed_at_grid(device, gen, errors))
    # K1 and K3 at the large presets' head dims, from generators of their own
    t0 = time.perf_counter()
    head_dim_kernel_checks(device, torch.Generator(device=device).manual_seed(SEED + 60), errors)
    times.update(norms_at_batch(device, errors, LARGE_NORM_GRIDS, SEED + 62))
    times.update(head_dim_grids(device, torch.Generator(device=device).manual_seed(SEED + 61),
                                errors))
    print(f"K1 and K3 at D=80 and 88 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving = main_path(device)
    check(launch_counts()["int8_qmm"] == launch_counts()["int8_qmm_bytes"] == 0,
          f"K5 launched on the serving path without {QUANT_ENV}")
    print(f"serving path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, bf16_first_loss = training_path(device)
    print(f"training path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ijepa_launches = ijepa_path(device)
    print(f"I-JEPA path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quant_launches = quant_path(device, bf16_first_loss)
    print(f"int8_sb path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    highres_launches = highres_path(device)
    check(highres_launches["int8_qmm"] == highres_launches["int8_qmm_bytes"] == 0,
          f"K5 launched on the 448 path without {QUANT_ENV}")
    print(f"448 path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainer_launches = trainer_path(device)
    check(trainer_launches["int8_qmm"] == trainer_launches["int8_qmm_bytes"] == 0,
          f"K5 launched on the trainer path without {QUANT_ENV}")
    print(f"trainer path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    input_launches, trained, trained_dir = input_path(device)
    check(input_launches["int8_qmm"] == input_launches["int8_qmm_bytes"] == 0,
          f"K5 launched on the input path without {QUANT_ENV}")
    print(f"input path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_launches = eval_path(device, trained, trained_dir)
    del trained
    print(f"eval path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    large_launches_run, large_by_dim = large_path(device)
    check(large_launches_run.get("int8_qmm", 0) == large_launches_run.get("int8_qmm_bytes", 0)
          == 0, f"K5 launched on the large presets' path without {QUANT_ENV}")
    print(f"large presets' path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    record_launches = record_path(device)
    check(record_launches["int8_qmm"] == record_launches["int8_qmm_bytes"] == 0,
          f"K5 launched on the record path without {QUANT_ENV}")
    print(f"record path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bioscan_launches_run, bioscan_rows = bioscan_path(device)
    check(bioscan_launches_run["int8_qmm"] == bioscan_launches_run["int8_qmm_bytes"] == 0,
          f"K5 launched on the BIOSCAN-CLIP path without {QUANT_ENV}")
    times.update(bioscan_rows)
    print(f"BIOSCAN-CLIP path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multitask_launches_run = multitask_path(device)
    check(multitask_launches_run["int8_qmm"] == multitask_launches_run["int8_qmm_bytes"] == 0,
          f"K5 launched on the multi-task path without {QUANT_ENV}")
    print(f"multi-task path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel_rows, ring_launches, parallel_errors = parallel_phase(device)
    times.update(parallel_rows)
    errors.update(parallel_errors)
    print(f"parallel path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_launches = tp_phase(device)
    print(f"tensor-parallel path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    med_launches = med_path(device)
    check(med_launches["int8_qmm"] == med_launches["int8_qmm_bytes"] == 0,
          f"K5 launched on the med_benchmarking path without {QUANT_ENV}")
    print(f"med_benchmarking path done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    artifact_launches = artifact_path(device)
    print(f"artifact path done in {time.perf_counter() - t0:.1f} s")
    # launches on the main paths, each counted from 0: serving, CLIP
    # training, I-JEPA with K1, I-JEPA with K1f-p/K1b-p, CLIP training under
    # int8_sb, 448 encode and 448 training, the trainer path's run A, the
    # input path's fit, the eval path's validate, the large presets' runs,
    # the record path's fits, the BIOSCAN-CLIP fit, the multi-task run A,
    # the tensor-parallel fit's rank 0, the med_benchmarking run A and eval job,
    # the artifacts' programs in the process without the model code
    for counts in (ijepa_launches, quant_launches, highres_launches, trainer_launches,
                   input_launches, eval_launches, large_launches_run, record_launches,
                   bioscan_launches_run, multitask_launches_run, tp_launches, med_launches,
                   artifact_launches):
        for key, count in counts.items():
            launches[key] = launches.get(key, 0) + count
    launches["fused_mha_fwd"] += serving["launches"][0]
    launches["layernorm_fwd"] += serving["launches"][1]

    # each kernel in the JSON line: its timed row (image attention, image
    # norms, the I-JEPA predictor's attention, image fc1) and its launch
    # counts on the main paths (a backward is two device kernels)
    rows = {
        "fused_mha_fwd": ("cuda", "mmlearn_tpu_torch/csrc/fused_attention.cu",
                          "mmlearn_tpu/ops/fused_attention.py:173", "K1f image N=197 H=12",
                          ("fused_mha_fwd",)),
        "fused_mha_bwd": ("cuda", "mmlearn_tpu_torch/csrc/fused_attention.cu",
                          "mmlearn_tpu/ops/fused_attention.py:207", "K1b image N=197 H=12",
                          ("fused_mha_bwd",)),
        "layernorm_fwd": ("cuda", "mmlearn_tpu_torch/csrc/layernorm_fwd.cu",
                          "mmlearn_tpu/ops/fused_norm.py:126", "K2f add+layernorm N=197 C=768",
                          ("layernorm_fwd",)),
        "layernorm_bwd": ("cuda", "mmlearn_tpu_torch/csrc/layernorm_bwd.cu",
                          "mmlearn_tpu/ops/fused_norm.py:144", "K2b add+layernorm N=197 C=768",
                          ("layernorm_bwd",)),
        "fused_mha_packed_fwd": ("cuda", "mmlearn_tpu_torch/csrc/fused_attention_packed.cu",
                                 "mmlearn_tpu/ops/fused_attention.py:425",
                                 "K1f-p predictor N=118 H=12 D=32 B=1024",
                                 ("fused_mha_packed_fwd",)),
        "fused_mha_packed_bwd": ("cuda", "mmlearn_tpu_torch/csrc/fused_attention_packed.cu",
                                 "mmlearn_tpu/ops/fused_attention.py:448",
                                 "K1b-p predictor N=118 H=12 D=32 B=1024",
                                 ("fused_mha_packed_bwd",)),
        "int8_qmm": ("cuda", "mmlearn_tpu_torch/csrc/int8_matmul.cu",
                     "mmlearn_tpu/ops/int8_matmul.py:63", "K5 image fc1 fwd M=50432 K=768 N=3072",
                     ("int8_qmm", "int8_qmm_bytes")),
        "flash_attention_fwd": ("cuda", "mmlearn_tpu_torch/csrc/flash_attention.cu",
                                "mmlearn_tpu/ops/flash_attention.py:76",
                                "K3f image N=785 packed", ("flash_fwd",)),
        "flash_attention_bwd": ("cuda", "mmlearn_tpu_torch/csrc/flash_attention.cu",
                                "mmlearn_tpu/ops/flash_attention.py:267",
                                "K3b image N=785 packed", ("flash_bwd_dkv", "flash_bwd_dq")),
    }
    # the large presets' head dims: launches of phase 12's runs at that head dim
    for d, k1_row in ((80, f"ViT-H/14 B={LARGE_B} N=257 H=16 D=80"),
                      (88, f"ViT-g/16 B={GIANT_B} N=197 H=16 D=88")):
        k3_row = f"ViT-g/14 B={GIANT_B} N=257 H=16 D={d} packed"
        rows[f"fused_mha_fwd_d{d}"] = (
            "cuda", "mmlearn_tpu_torch/csrc/fused_attention.cu",
            "mmlearn_tpu/ops/fused_attention.py:173", f"K1f {k1_row}", (("fused_mha_fwd", d),))
        rows[f"fused_mha_bwd_d{d}"] = (
            "cuda", "mmlearn_tpu_torch/csrc/fused_attention.cu",
            "mmlearn_tpu/ops/fused_attention.py:207", f"K1b {k1_row}", (("fused_mha_bwd", d),))
        rows[f"flash_attention_fwd_d{d}"] = (
            "cuda", "mmlearn_tpu_torch/csrc/flash_attention.cu",
            "mmlearn_tpu/ops/flash_attention.py:76", f"K3f {k3_row}", (("flash_fwd", d),))
        rows[f"flash_attention_bwd_d{d}"] = (
            "cuda", "mmlearn_tpu_torch/csrc/flash_attention.cu",
            "mmlearn_tpu/ops/flash_attention.py:267", f"K3b {k3_row}",
            (("flash_bwd_dkv", d), ("flash_bwd_dq", d)))
    launches.update(large_by_dim)
    # phase 16's K3 instances: their launches on the ring's runs (its main
    # path). K3f's bf16-output instance at D=128 runs on no main path (every
    # ring hop writes f32): it is checked and timed at the kernel phase only,
    # and its ring count must stay 0
    for name, row, counts in (
            ("flash_attention_fwd_f32", "K3f f32 hop H=16 D=64", (("flash_fwd_f32", 64),)),
            ("flash_attention_fwd_f32_d128", "K3f f32 hop H=8 D=128",
             (("flash_fwd_f32", 128),)),
            ("flash_attention_fwd_d128", f"K3f N={K3_D128_N} H={K3_D128_H} D=128",
             (("flash_fwd_bf16", 128),)),
            ("flash_attention_bwd_d128", f"K3b N={K3_D128_N} H={K3_D128_H} D=128",
             (("flash_bwd_dkv", 128), ("flash_bwd_dq", 128)))):
        rows[name] = ("cuda", "mmlearn_tpu_torch/csrc/flash_attention.cu",
                      "mmlearn_tpu/ops/flash_attention.py:267" if "bwd" in name else
                      "mmlearn_tpu/ops/flash_attention.py:76", row, counts)
        ring = sum(ring_launches.get(c, 0) for c in counts)
        if name == "flash_attention_fwd_d128":
            check(ring == 0, f"{name}: {ring} launches on phase 16's ring, which writes f32")
        else:
            check(ring > 0, f"{name} was never launched on phase 16's ring")
    errors["flash_attention_fwd_f32_d128"] = errors["flash_attention_fwd_f32"]
    for key in (("flash_fwd_f32", 64), ("flash_fwd_f32", 128), ("flash_fwd_bf16", 128),
                ("flash_bwd_dkv", 128), ("flash_bwd_dq", 128)):
        launches[key] = ring_launches.get(key, 0)
    for name in rows:
        if name.endswith(("_d80", "_d88")):
            check(sum(launches.get(c, 0) for c in rows[name][4]) > 0,
                  f"{name} was never launched on phase 12's main path")
    kernels = []
    for name, (route, source, replaces, row, counts) in rows.items():
        ms, plain, lib_ms, bound_ms, bound_by = times[row]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches.get(c, 0) for c in counts), "max_abs_err": errors[name],
            "ms": ms,
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
