#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

    python3 chip_smoke.py [--phases device,build,flash,...]

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions. No usable card is an error: the script exits non-zero and
   prints no result.
2. build: compiles every kernel source in ``mxnet_tpu_torch/csrc`` with
   ``nvcc`` (all at once), and prints the build seconds and ptxas's
   register and shared-memory report; fails if the int8 GEMM, the flash
   forward's tensor-core kernel, either tensor-core backward kernel or
   the optimizer kernel spills registers.
3. flash: holds the flash-attention forward against its plain PyTorch
   version on the serving shape and on ragged, cross-attention and other
   head-dim shapes, float32 and bfloat16, causal and not, on dense
   inputs, on transposed views of (B, S, H, D) tensors (read in place),
   on a q whose rows are not 16-byte aligned (one copy) and on a v that
   alternates in sign from key to key; each case on the path its head
   dim takes (tensor cores up to D = 128, CUDA cores above), with the
   output a (B, H, S, D) view of (B, S, H, D) memory. Then it times the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it) at the serving shape by CUDA
   events (``kernel_ms``, ``library_ms``) and by the profiler's kernel
   time (``device_ms``, ``library_device_ms``), names SDPA's kernel, and
   prints both bounds (float32 rate, ``bound_ms``; the tensor cores'
   float32-accurate rate, ``bound_tc_ms``) and the forward's blocks per
   SM.
4. serve: the BERT-class classifier of
   ``examples/gluon/transformer_finetune.py`` at BERT-base width (vocab
   30522, units 768, FFN 3072, 12 heads, 12 layers, seq 128, 2 classes;
   random float32 weights from ``numpy.random.RandomState(0)``) behind
   ``ServedModel.from_block`` + ``ModelServer`` on the default bucket
   ladder. Requests of 1-8 rows come from several threads; every answer
   is checked against the same rows run alone through the block, two
   rows against a CPU copy of the model, and the flash kernel's launch
   count against 12 x batches, every one on the tensor-core path and
   with no copy of q, k or v.
5. profile: one batch per bucket on the host clock, and a
   ``torch.profiler`` window over bucket-32 batches (device time by
   kernel group, device busy share), with the buckets' CUDA graphs
   replayed; profile_eager: the same with the compile service off.
6. flash_bwd: holds the two flash-attention backward kernels (dq; dk and
   dv) against the dense float32 recompute on every case and layout of
   the flash phase (dO in q's layout): each launch on the path its head
   dim takes, inputs copied only where the layout needs it (the
   unaligned q), gradients in their inputs' memory order, and a second
   call bit-equal to the first. Then it times both kernels (dense and on
   transposed views), their plain versions and the backward of
   ``scaled_dot_product_attention`` (a yardstick) at the training shape
   by CUDA events (``ms``) and by the profiler's kernel time
   (``device_ms``; SDPA's kernels named), and prints both bounds (float32
   rate; the tensor cores' float32-accurate rate, ``dq_tc``, ``dkv_tc``)
   and each kernel's blocks per SM.
7. opt: holds the fused SGD-momentum and Adam kernels bit for bit
   (``torch.equal``) against their plain versions on the classifier's
   full parameter list and on odd sizes, with and without clip and
   weight decay, on operands 4 bytes off their 16-byte alignment (all,
   or one operand of every other tensor), and through
   ``Optimizer.fused_update_multi`` with two learning-rate groups (two
   launches an update, no table rebuilt after the first); each case with
   every tensor on the path its alignment gives (16-byte or scalar), no
   gradient copied, and the skip flag honoured. Then it times one
   multi-tensor step over the classifier's 197 tensors beside
   ``torch.optim``'s fused step (a yardstick with other semantics) by
   CUDA events (``ms``), the profiler's kernel time (``device_ms``) and
   the host's time per call (``host_us``).
8. train_check: the classifier at full width with 2 layers, one "adam"
   and one "sgd" (momentum) ``ShardedTrainer`` step on the card and on a
   CPU copy from the same weights; loss and every parameter agree, and
   each kernel of the step counts its launches.
9. train: 20 "adam" steps of the full 12-layer classifier on one batch
   of 32 (``make_task`` of the example), the step captured as one CUDA
   graph (compile site ``trainer``: the first step eager, then a
   capture and 19 replays): finite, falling loss, launch
   counts (every flash backward launch on the tensor-core path, no input
   copied; all 197 tensors of every Adam step on the 16-byte path, no
   gradient copied), median step time, tokens/s, peak memory, and a
   ``torch.profiler`` split of one step's device time.
9b. train_capture: the train phase's trainer from one synchronised
   state in four blocks of 20 steps, captured, eager
   (``compile.set_enabled(False)``), eager, captured: step ms per mode
   and per block, 20 updates per block (``_t``), each tensor after 3 and
   after 20 steps captured against eager (bit for bit, else within
   ``CAPTURE_STEP_L2`` of the update's L2 norm), launches per replayed
   step (K2 1, K3 12, K3-bwd 12 + 12), capture ms, graph pool bytes,
   peak memory of each mode and a profiled step of each (busy share).
9c. gluon_hybrid_train: ``examples/distributed_training/cifar10_dist.py
   :71-87``'s loop on one card (``hybridize()``, ``record()``,
   ``backward()``, ``gluon.Trainer`` "adam" on a ``local`` store) over
   the classifier at BERT-base width: the ``cachedop`` pair's replayed
   gradients against eager from the same weights, K3 and K3-bwd per
   replayed forward and backward, 20 steps of each mode (A B B A).
9d. dropout_capture: a hybridized Dense + Dropout(0.5) trained 5
   captured steps, twice after ``mx.random.seed(11)``: masks differ
   between replays, each drops a share within 3 sigma of 0.5, and the
   two runs draw the same masks.
10. int8_gemm: holds the int8 GEMM kernel (K4) bit for bit
    (``torch.equal``) against its plain version on every product shape
    of a served int8 batch, on ragged and tile-edge shapes and operands
    at a 1-byte offset, with and without bias and relu, per-channel and
    scalar scales, and where |acc| passes 2**24; each case at both output
    tile widths and on the path it must take (cp.async copies, or the
    staged byte loads for ragged K and unaligned operands). Then it
    times the kernel, its plain version and ``torch._int_mm`` + the
    epilogue (a yardstick only) at each shape of the path by CUDA events
    over back-to-back calls (``ms``, ``plain_ms``, ``library_ms``, as
    every kernel here), the kernel and the yardstick also by the
    profiler's sum of kernel time (``device_ms``, ``library_device_ms``:
    where a call's host work outlasts its kernels, events time the
    host), and both output tile widths at the three layer shapes.
11. serve_int8: bert_base_sst2_int8_serve. The serve phase's classifier
    with ``gluon.nn.Embedding`` (exportable) is exported, calibrated on
    the card (naive, 64 rows of ``make_task``) and quantized by
    ``quantize_model`` (channel-wise), saved with ``save_checkpoint``
    and served through ``ModelContainer.add_checkpoint`` +
    ``ModelServer`` under the serve phase's traffic. Every answer is
    checked against the int8 graph evaluated directly on the card, one
    request against a CPU copy of the int8 graph, and compared with the
    float32 block (class agreement, logit gap); the launch counts must
    be 74 int8 GEMMs per batch, all on the kernel's cp.async path, and 12
    flash forwards. Then the float32 block and the int8 graph take turns
    under the same traffic in one server (five bursts each, ABBA order),
    and a bucket-32 int8 batch is profiled (profile_int8, and
    profile_int8_eager with the compile service off). Every bucket of
    both served models runs as a CUDA graph captured at warmup; the
    paired bursts run each model captured and eager (``compile.
    set_enabled(False)``), A B B A over the four variants.
11b. capture: the served float32 and int8 models and the classifier
    block hybridized and called directly, each replay against the same
    forward run eagerly on the same inputs (bit for bit), launches per
    replayed batch (12 flash; 74 int8 GEMMs), no capture after warmup
    under a burst, a ``set_data`` that captures anew and changes the
    output, an in-place weight write that
    the next replay reads, and the hybridized block's ms per call
    captured and eager (A B B A).
11c. online_update: the cell bert_base_sst2_online_update. The train
    phase's fine-tune (a fresh "adam" ``ShardedTrainer``, batch 32, its
    step captured) publishes to a model bus in a temporary directory
    every 10 steps (``publish_to``; only the 30522 x 768 embedding rides
    int8 per row) while a second block instance of the classifier, from
    the same weights, is served by ``ServedModel.from_block`` +
    ``ModelServer(cache=True)`` on the default ladder (every bucket
    captured by ``warmup()``), subscribed with ``watch_bus(poll=0.05)``
    and behind ``HttpFrontEnd`` on 127.0.0.1. Four ``http.client``
    threads send requests of 1-8 rows in a closed loop (interactive:batch
    4:1, a deadline on the batch class, 30% of them one of 16 hot
    payloads: a smoke load chosen to drive each mechanism, not a
    measured deployment's traffic) over four windows: traffic alone, steps 1-20, steps 21-40,
    traffic alone (A B B A). After version 2 the next record is poisoned
    (``modelbus.publish:nan@1``), and the publish after it rolls back;
    then an in-process overload burst past the queue bound. Fails unless
    no request failed (deadline drops counted per class); every response
    carries 0 or an applied version, non-decreasing per client; for every
    applied version at least 4 responses (cache hits among them) equal
    the same rows run eagerly through a block loaded with
    ``decode_update`` of that version (``SERVE_TOL``) and lie more than
    ``VERSION_MARGIN`` x ``SERVE_TOL`` from the neighbouring versions'
    outputs (a rollback holds its source's values); no serving capture
    or miss after warmup; K3 12 launches per served batch and per step,
    K3-bwd 12 + 12 and K2 one per step; the poisoned version has a
    ``reject-v*`` file, is never served and a rollback follows it; cache
    hits, each an answer its version computed bit for bit; and under
    overload the batch class's answered share at most the interactive
    class's. Prints rows/s and p50/p99 by class per window, step ms with
    and without a publish and the trainer alone, per version the publish
    (device-to-host copy, encode, atomic writes) and apply (read + CRC,
    decode, finite check, staging, the flip's host and device time, lock
    wait) seconds and ``age_steps``, bytes per record, the largest gap
    between two served batches across a flip against the median gap,
    peak memory and the staging set's bytes.
12. decode: the decode-attention kernel (K5) through
    ``mx.nd.contrib.decode_attention`` at BERT-base / GPT-2-small head
    geometry (q (32, 12, 64) against a (32, 12, 1024, 64) cache, ragged
    lengths from 1 to 1024), float32 and bfloat16, against its plain
    version, and on odd shapes (S not a multiple of 128, D of 8, 128 and
    256, B*H = 1); then times the kernel, the plain version and
    ``scaled_dot_product_attention`` with a boolean mask (a yardstick).
13. twobit: the 2-bit compress and decompress kernels (K6, K7) bit for
    bit (``torch.equal``) against their plain versions: the single-tensor
    compress (the per-key path) and the decompress on 109 M elements, odd
    sizes, unaligned views and summed codes (int8 and int32); the
    multi-tensor compress and the decompress of wire ranges (the bucketed
    path) through the kvstore's flat layout on the classifier's 197
    shapes, odd sizes
    (1, 2, 3, 127, 4097), unaligned gradient views, a call over a strict
    subset of a bucket and values at +-thr and NaN, each tensor on the
    path its alignment gives and nothing outside the listed slots
    written. Then twobit_timing: one step's K6 and K7 over the 197
    tensors by the per-key route (197 launches each and the bucket
    ``torch.cat``) and by the multi-tensor route (one launch each), by
    CUDA events, the profiler's kernel time and the host's time per
    call.
14. dist_check: two worker processes on the card (this script with
    ``--worker``, given the ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_WORKERS``
    / ``MXTPU_WORKER_ID`` environment of ``tools/launch.py``) each train
    the classifier at 2 layers and narrow width through
    ``mx.kv.create("dist_sync")`` with 2-bit compression and
    ``gluon.Trainer``, 3 "sgd" (momentum) and 3 "adam" steps, and save
    what they pushed, their codes (each key's wire slot, copied after the
    step's one compress call and before the all-reduces) and residuals,
    the pulled sums and their weights. This process recomputes every
    step on the CPU with the
    plain versions: codes, residuals and pulled sums bit for bit, final
    weights to 1e-6, and both ranks' weights equal bit for bit.
15. dist_train: the same two-worker path at full width (12 layers), the
    MXNet default threshold 0.5, 10 "adam" steps per worker: step time,
    tokens/s, nonzero codes, bytes on the wire (the codes and at most
    15 bytes of padding per key), launches per step (1 multi-tensor
    compress with all 197 tensors on the 16-byte path, 1 decompress on
    the 16-byte path, no per-key K6/K7, 1 Adam per worker; no gradient
    copied into a bucket), peak memory, a finite, falling loss and equal weights
    on both ranks at the end; then one more step split on the host clock
    (forward and backward, the push call, the pull call, update) and
    gloo's all-reduce of the same int8 bytes alone.
16. resnet_check: a thumbnail resnet18_v1 (10 classes, batch 8, 32x32)
    takes 3 ``ShardedTrainer`` "sgd" steps on the card and on a CPU copy
    (TF32 off), the copy set to the card's weights, momenta and running
    statistics before each step: loss, every weight, momentum and
    running statistic within ``RESNET_CHECK_TOL``; K1 exactly 3 launches.
17. resnet50_v1_train: ``bench.py:275-303`` with BENCH_DTYPE=float32 at
    full width (resnet50_v1, 1000 classes, batch 128 of 3x224x224 from
    ``nd.random.uniform``, "sgd" lr 0.05 momentum 0.9 wd 1e-4,
    ``nan_guard=False``, TF32 off): 3 warm-up and 10 timed steps; step
    ms (median, min, max), img/s, peak memory, the loss finite and
    falling, the stem BatchNorm's running mean moved, K1 one launch a
    step over all 193 tensors (25,575,912 values) on its 16-byte path;
    one profiled step by kernel group (convolution forward, backward and
    FFT, BatchNorm, pooling, elementwise, K1, copies) and the idle share;
    K1 over the same tensors bit for bit against its plain version and
    timed beside ``torch.optim.SGD(momentum=0.9, fused=True)``. The step
    runs captured (site ``trainer``): K1 one launch per replay, the
    running statistics' storage kept over the timed steps; then eager
    beside it (one step of each from one state within
    ``CAPTURE_RESNET_STEP_L2``, A B B A step times, peak memory with the
    graph's pool at most ``CAPTURE_PEAK_RATIO`` times eager's, a profiled
    eager step) and a ``nan_guard`` trainer's replayed step on a batch
    holding a NaN, after which every weight, momentum, master and
    statistic is bit for bit as before (the bfloat16 cells as well).
18. resnet50_v1_infer_bf16: ``bench.py:199-223`` in bfloat16 (its
    default dtype): ``net.cast("bfloat16")``, ``hybridize(static_alloc=
    True, static_shape=True)`` (the forward captured as one CUDA graph),
    a batch of 128, 2 warm-up and 20 timed forwards, captured and eager
    in A B B A order, the replay against the eager forward: img/s both
    ways, peak memory; top-1 agreement and the largest logit
    gap against the float32 forward of the same weights on the same
    batch; what cuBLAS's reduced-precision bfloat16 reductions (pinned
    off in every phase) would change; three rounds of a training-mode
    forward (the op's pair) and an evaluation, which keep two entries,
    the statistics' storage and flat pools.
19. resnet50_v1_train_bf16: resnet50_v1_train with bench.py's default
    dtype, no ``multi_precision``: the same figures, the route census
    (87 bfloat16 tensors through the plain ``sgd_mom_update``, K1 one
    launch a step over the 106 float32 BatchNorm tensors) and K1's device
    time inside the profiled step beside its bound.
20. resnet50_v1_train_bf16_mp: the same with ``"multi_precision": True``:
    K1 one launch a step over all 193 float32 tensors (87 masters) on its
    16-byte path, every weight its master rounded, and the two casts
    around K1 timed alone beside their byte bound.
21. resnet_check_bf16: resnet_check in bfloat16 with
    ``multi_precision``, held to ``RESNET_CHECK_BF16_TOL``.
22. resnet_resume: the thumbnail with a ``MultiFactorScheduler`` and
    deterministic cuDNN: ``save_checkpoint`` / ``resume`` through a
    ``CheckpointManager``, the state after resume and the resumed steps
    bit for bit against the uninterrupted run, and the fallback from a
    truncated newest file to the previous checkpoint.
23. resnet50_v1_module_fit: ``python examples/image_classification/
    train_imagenet.py --benchmark 1 --network resnet50_v1`` through the
    port's ``Module.fit`` (``get_network``, ``SyntheticDataIter`` and
    ``fit.fit``'s wiring copied here, ``MODULE_FIT``): batch 128 of
    3x224x224, 1000 classes, "sgd" lr 0.1 momentum 0.9 wd 1e-4 under a
    ``MultiFactorScheduler``, a ``local`` kvstore, accuracy,
    ``Speedometer(128, 10)``; 13 batches (the cut); four fits, the
    executor captured (site ``executor``: the training pair replayed
    each batch), eager, eager, captured. The median batch
    over batches 4-13, img/s, Speedometer's img/s, peak memory, the host
    ms of ``update()`` and ``update_metric()``, launches by family (K1
    one a batch over 193 tensors on its 16-byte path, nothing else),
    a finite loss and the training accuracy, one profiled batch (kernel
    groups, the executor's gradient copies, the store's pull copies,
    SoftmaxOutput, K1, idle share) and the excess over
    resnet50_v1_train's step from the same call.
24. module_check: the thumbnail resnet18_v1 symbol through ``Module``
    on the card and on a CPU copy, synchronised before each of 3 steps
    and held to ``MODULE_CHECK_TOL``; K1 one launch a card step, and
    from the second step on bit for bit against the plain
    ``sgd_mom_update`` over the same operands (the Module's wd table,
    ``rescale_grad`` 1 / batch); ``save_checkpoint`` -> ``Module.load``
    -> two steps (the first eager, the second captured) bit for bit.
25. transformer_lm: ``examples/gluon/transformer_lm.py``'s causal LM
    rebuilt from the port (``build_lm``: ``TransformerLM``, ``LMLoss``,
    ``WithPos``, ``nd.arange`` positions, the synthetic bigram corpus of
    ``RandomState(42)``), ``ShardedTrainer`` with "adam", float32, TF32
    off. The example's defaults (``LM_DEFAULTS``) train 60 steps in four
    runs from one state (captured, eager, eager, captured): the loss at
    steps 0, 20, 40 and 59, finite and falling. Then ``LM_GPT2S`` (GPT-2
    small width: 12 layers, 768 units, 12 heads, seq 1024, batch 8,
    vocab 50257, about 163 M parameters): captured and eager in A B B A
    blocks (3 warm-ups, 4 blocks of 5 steps per mode), step ms, tokens/s,
    a profiled replayed and eager step (device ms by group, busy share),
    peak memory and the graph pool, launches per replay (K2 1, K3 12,
    K3-bwd 12 + 12), 3 captured steps against 3 eager ones from one
    state; the gradient of step 1 with ``remat=True`` (bit for bit, or
    within 1e-6 of each tensor's L2 norm) and with ``accum_steps=2``
    (within 1e-5) against the plain one from the initial weights; then 10
    captured steps of each (K3 24 a step with remat; K3 and K3-bwd 24
    and 24 + 24 with accumulation; K2 once): step ms, peak memory.
    The flash and flash_bwd phases hold K3 and K3-bwd at the LM's shape
    (8, 12, 1024, 1024, 64) causal in float32 and bfloat16 and time them
    there beside the plain versions, causal SDPA and the bounds
    (``lm_shape``).

26. native_io (runs right after build): the native IO library
    (``mxnet_tpu_torch/native``) built on this machine with ``g++``,
    ``native.status()``, held bit for bit against its plain versions on
    64 seeded images: RecordIO pack, scan and read, the normalisation,
    the PNG unfilter (every filter type) and conversion to RGB, Pillow's
    BILINEAR resample, the augmenter and the fused PNG decode. A JPEG
    payload must raise naming libjpeg where the build has none. A probe
    line for a later JPEG decoder: ``os.cpu_count()``, nvJPEG's header
    and library under the CUDA home, whether ``zlib.h`` and ``jpeglib.h``
    compile.
27. imagenet_rec: the cell resnet50_v1_module_fit_rec,
    ``train_imagenet.py --data-train <rec> --network resnet50_v1`` at the
    example's defaults: 2,560 PNG records (256 x 341 and 341 x 256
    smooth random fields with noise, 1000 classes, ``RandomState(0)``)
    packed here by ``recordio.pack_img`` (seconds, bytes a record), read
    by ``ImageRecordIter(shuffle, rand_crop, rand_mirror)`` with 4 decode
    threads and 2 batches of prefetch. The iterator alone (3 readings
    of 12 batches after 2 warm-ups, at 4 threads and at
    ``os.cpu_count()``; one of 4 batches at 1 thread, each stage's cost
    without contention): img/s and ms a batch by stage (read, draws,
    inflate, unfilter + resample + augment, normalise, the copy to the
    card). Then ``Module.fit`` with resnet50_v1_module_fit's wiring
    (executor captured), 40 batches a fit (two passes over the
    records), four fits A B B A: records, synthetic, synthetic, records:
    over batches 4-40, all images over all wall time (img/s), the mean
    batch, the share of that time ``next()`` waited (``data_wait``),
    Speedometer's img/s, K1 one launch a batch and nothing else, a
    finite loss. Then the iterator's
    ``state_dict`` after 5 batches resumes the next 3 bit for bit;
    ``ShardedTrainer.save_checkpoint``/``resume`` with ``data_iter`` on
    the ResNet thumbnail gives the same next batches and weights bit for
    bit (deterministic cuDNN); the first two card batches equal the CPU
    run over the plain versions. ``--dtype bfloat16`` is left out: a
    float32 record batch into a bfloat16 graph is refused at bind by the
    JAX Module and the port's.
28. lstm_lm_ptb_medium: ``examples/gluon/word_lm.py --vocab-size 10000
    --embed-dim 650 --hidden 650 --layers 2 --bptt 35 --batch-size 20 --lr
    20 --clip 0.25 --tied --corpus-tokens 84000`` (``WORD_LM``, the
    medium configuration of Zaremba et al. 2014; 13.3 M parameters, the
    example's dropout 0.2), its model and loop copied here
    (``word_lm_model``, ``word_lm_step``), hybridized. First the RNN op's
    cuDNN route against its per-step form at the run's shape (35, 20,
    650, 650) for every mode, 1 and 2 layers and a bidirectional GRU
    (forward within ``RNN_TOL`` element by element, gradients within it
    of each tensor's largest value), both routes timed beside
    ``torch.nn.LSTM`` with its weights in one cuDNN buffer and the flat
    vector's concat. Then one pass of 119 steps, the ``cachedop`` pair
    captured once (every RNN layer run through cuDNN, the clipped
    gradients' norm at most 0.25 x 35 x 20 at every step, perplexity over
    the last 20 steps below the first 20), 5 captured steps against 5
    eager ones from one state and seed (the same Dropout masks), the tied
    matrix's replayed gradient against its embedding and decoder parts
    computed apart, step ms captured and eager (A B B A), tokens/s, the
    host's synchronizing calls per step by call site, a profiled step of
    each mode (device ms by kernel group and, eager, by op; busy share),
    peak memory and the pair's pool.
29. lstm_ptb_bucketing: ``examples/rnn/train_ptb.py --num-embed 200
    --num-hidden 200 --vocab-size 10000 --batch-size 32 --num-sentences
    4000`` (``PTB_BUCKETING``; its ``synthetic_corpus``,
    ``BucketSentenceIter`` and ``sym_gen`` copied here):
    ``BucketingModule.fit`` with "adam", Xavier, ``Perplexity`` and
    ``Speedometer(32, 20)``, one epoch over buckets 10/20/30/40. Fails
    unless exactly 4 ``executor`` captures (each at its bucket's second
    batch, none after), one storage for every parameter, gradient and
    Adam state across the buckets, K2 one launch a batch, falling
    perplexity, and a fresh ``Module`` bound at bucket 20 with the same
    parameters giving that bucket's outputs within ``RNN_MODULE_TOL``.
    Then batch ms by bucket captured and eager (A B B A) with the
    metric's share, samples/s, a profiled batch of each bucket (K2's
    device ms), each bucket's graph pool and the total.

30. mobilenet_v2_1_0_module_fit: ``train_imagenet.py --benchmark 1
    --network mobilenet_v2_1_0`` through ``Module.fit`` with
    resnet50_v1_module_fit's wiring (``MOBILENET_FIT``: batch 128 of
    3x224x224, 1000 classes, "sgd" lr 0.1 momentum 0.9 wd 1e-4, 13
    batches a fit), four fits captured, eager, eager, captured: batch ms,
    img/s, Speedometer's img/s, peak memory, K1 one launch a batch over
    all 160 trainable tensors on its 16-byte path and nothing else, one
    capture then replays, a finite loss falling from the first batch to
    the last, a profiled batch of each mode by kernel group (PyTorch's
    depthwise forward and backward kernels, the other convolutions,
    BatchNorm, the ReLU6 clamp, K1, the rest; busy share); then a captured
    fit with ``--optimizer nag``: no K1 launch, NAG's ``_foreach`` update
    in its place.
31. bert_base_sst2_finetune_lamb: the train phase's fine-tune (BERT-base,
    batch 32, seq 128) under ``ShardedTrainer(..., "lamb")`` at the JAX
    defaults: four blocks of 20 steps from one state (captured, eager,
    eager, captured), step ms against an "adam" block of the same call,
    the loss finite and falling, one capture then replays, launches (K3
    12, K3-bwd 12 + 12 a step; LAMB's update is plain PyTorch), the
    captured state after 3 and 20 steps against the eager one, LAMB's
    kernels and device ms a step against K2's, and no host sync over 5
    replays (the guard off: its flag is the one read a step makes).
32. dcgan: ``examples/gluon/dcgan.py`` at its defaults (``DCGAN``; its
    ``build_nets`` and loop copied here): two iterations on the card and
    on a CPU copy from one set of weights and one numpy batch of images
    and noise (``DCGAN_TOL``), then 3 epochs of 16 iterations: iteration
    ms, K2 two launches an iteration (96), finite losses each epoch and 4
    finite samples.
33. zoo_check: each model-zoo family's default constructor (AlexNet,
    DenseNet-121, Inception v3 at 299, MobileNet 1.0 v1 and v2,
    SqueezeNet 1.0 and 1.1, VGG-16 with and without BatchNorm) at batch 2:
    one training forward and backward on the card and on a CPU copy from
    the same weights (Dropout at rate 0 in both), held to
    ``ZOO_CHECK_TOL``; parameter counts.
34. surface_check: every new optimizer through ``Updater.update_multi``
    (float32, and float16 under ``multi_precision``) and through
    ``ShardedTrainer``'s rules, Deconvolution (grouped, with
    ``target_shape``), CTCLoss (``torch.nn.functional.ctc_loss`` against
    the plain recursion on the card and the CPU), LRN, UpSampling,
    InstanceNorm, GroupNorm and the LeakyReLU modes, card against CPU
    (``SURFACE_TOL``); every contrib op card against CPU and captured
    with its gradient in a raw CUDA graph under
    ``set_sync_debug_mode("error")`` (``boolean_mask``, a host op,
    uncaptured in a ``compile.jit`` body), and ``foreach``,
    ``while_loop`` and ``cond`` in a hybridized block captured.
35. ssd512_resnet50_v1_module_fit: MXNet 1.x's ``example/ssd``
    ``train.py --network resnet50 --data-shape 512`` through
    ``Module.fit`` (``SSD512``): four fits captured and eager (A B B A),
    the replayed update against the eager one, a profiled batch of each
    mode (device ms by group: backbone, extra layers and heads,
    MultiBoxTarget, MultiBoxDetection with its NMS, SoftmaxOutput and
    smooth-L1, K1), no host sync in a replay, then ``deploy.py``'s
    detection graph at batch 32 captured against eager.
36. bert_base_sst2_finetune_zero: the fine-tune cell (BERT-base, "adam",
    batch 32, seq 128, float32, TF32 off) under ``ShardedTrainer(...,
    mesh=DeviceMesh({"dp": 1}), zero=True, rules=sharding_rules(...))``:
    ``warmup`` before the first batch (one capture, no replay, the state
    and the generator untouched; the first step a replay), the warmed
    trainer after 3 and 5 steps bit for bit against a cold ``zero=False``
    one, 20 steps with ``step_report()`` (step ms, the phases plus
    ``other`` summing to ``duration_ms``, ``flops`` equal to
    ``classifier_step_flops``, ``mfu_xla`` against 989.4 TFLOP/s, the
    fine-tune's launches), ``mxtpu_device_memory_peak_bytes`` against
    ``torch.cuda.max_memory_allocated()``, telemetry on against off (A B
    B A, 10 steps a block), ``donate=False`` against ``donate=True`` (A B
    B A: step ms, the peak a block adds, the trainer's persistent bytes;
    a parameter's and a state's tensor taken before a step keep their
    values), ``unshard(ctx=mx.cpu())`` and the block's CPU forward
    against the card's ``predict`` (``CPU_TOL``), then the classifier
    served behind ``HttpFrontEnd`` with tracing on: 48 requests from 4
    threads (half with the caller's ``X-Request-Id``), each answer with
    its id and five phases and equal to the block's output
    (``SERVE_TOL``), ``GET /metrics`` against ``ModelServer.stats()``
    (requests, batches, rows), K3 12 launches a batch, and
    ``trace.dump()`` a valid Chrome trace.

37. fm_criteo_row_sparse: ``examples/sparse/factorization_machine.py``
    through the port (its flow in ``sparse_fm_example``): at its defaults
    on the card (acc > 0.75 after 15 epochs; each epoch against the same
    flow on the CPU), then at the width of LIBSVM's criteo set
    (``FM_CRITEO``: 1,000,000 hashed features, 39 a row, factor 16,
    batch 1000, "sgd" on a local store) from a 100,000-row LibSVM file
    read by ``LibSVMIter`` (the CSR parts taken as they are): per batch
    the ms of the row pulls, the host math and the pushes (row union and
    lazy update), the unique rows touched, the loop's peak memory above
    the tables (below one (1e6 x 16) table), and after 100 batches ``w``
    and ``v`` bit for bit against dense tables given the same pushes by
    ``index_add_``.
38. sparse_linear_mf: ``linear_classification.py`` and
    ``matrix_factorization.py`` at their defaults on the card, their
    thresholds (acc > 0.8, RMSE < 1.5) and each epoch against the CPU
    within 1e-4.
39. dist_sparse_async: two workers on the card over gloo (this script
    with ``--worker``): the criteo-width FM under ``dist_sync`` for 20
    batches, each worker half a batch (the rows and bytes each
    row-sparse push gathers; both workers' tables bit for bit against one
    process given the summed pushes); then ``train_imagenet.py --kv-store
    dist_async --network resnet50_v1 --benchmark 1`` at batch 128 a
    worker for 13 batches (batch ms, push and pull ms, the gather's ms and
    bytes in both forms, K1 two launches a batch on each worker, the
    weights equal on both workers after every batch, and after 2 batches
    equal to one process's K1 updates with rank 0's then rank 1's
    gradients).

40. bert_base_np_finetune: the fine-tune classifier (BERT-base, batch 32,
    seq 128, ``gluon.Trainer("adam")``) under ``npx.set_np()`` with
    ``mx.np`` token ids and labels and the loss ``-npx.pick(
    npx.log_softmax(logits), label).mean()``, eager and hybridized: each
    route's loss trajectory bit for bit against the same steps in
    ``mx.nd``, ``mx.np.ndarray`` outputs and losses, no numpy fallback
    or host op, no host sync in a hybridized np step but the loss read,
    K3 12, K3-bwd 12 + 12 and K2 1 launches a step; ms a step np against
    nd (A B B A, medians of 20) and each run's peak memory.
41. np_surface: every case of ``np_cases()`` (ops/numpy_ops.py's names)
    and of the legacy ops of tests/test_op_schema.py on the card against
    the CPU (exact ops bit for bit, the others within ``NP_TOL``), then
    ``np.einsum`` at the attention scores' shape, ``np.linalg`` at
    ``LINALG_CHECK``'s batch, a boolean mask on a BERT-base activation
    and the samplers' moments over 10^7 draws.

The twobit phase also holds the single-tensor compress and the
decompress in float16 and bfloat16 bit for bit against their plain
versions (thresholds 0.5 and 0.1) and times them over 109 M elements
(``twobit_half``).

Then the ``{"kernels": [...]}`` line (the tensor-core kernels K3 and
K3-bwd with their tensor-core bound as ``bound_ms`` and the float32-rate
one as ``bound_f32_ms``; K1 with its ResNet-50 numbers, those over the
classifier beside them, its launches in the bfloat16 cells and checks, on the Module path and
on the record-fed Module path,
its device time inside the bfloat16 steps and the casts' time; K1, K2,
K3 and K3-bwd with their launches per replayed training graph, K2, K3
and K3-bwd with their launches per replayed LM step and K3 and K3-bwd
with their times at the LM's shape; K2, K3 and K3-bwd with their
launches in online_update; K2 with its launches and device ms a batch in
lstm_ptb_bucketing; K1 with its launches in the MobileNet v2 fit and
none in its NAG fit, its launches under dist_async and none in the
row-sparse FM; K2 with its launches in dcgan and none under
"lamb"; K6 and K7 with their half-precision times; K2, K3 and K3-bwd
with their launches in bert_base_sst2_finetune_zero), the
card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failure is an
exception and a non-zero exit. ``--phases`` runs a subset (device and
build always run) and then prints no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import hashlib
import json
import logging
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile as compile_service
from mxnet_tpu_torch import kernels, serving
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import build, decode_attention, flash, int8_gemm
from mxnet_tpu_torch.kernels import opt_step, twobit
from mxnet_tpu_torch.kvstore import buckets
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

BERT_BASE = {"vocab": 30522, "units": 768, "hidden": 3072, "heads": 12,
             "layers": 12, "seq_len": 128, "num_classes": 2}
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores, 700 W part
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak, 700 W part
# float32-accurate products on the tensor cores: three TF32 products each
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_BYTES_S = 3.35e12    # HBM3
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, 700 W part
F32_TOL = 2e-5  # the kernel reassociates the softmax normaliser across k tiles
BF16_TOL = 2e-2  # the plain version rounds scores and probabilities to bf16
SERVE_TOL = 1e-4  # float32 logits; cuBLAS may pick another algorithm per batch size
# online_update: how many times SERVE_TOL a response must lie from the
# output of the neighbouring versions it was not stamped with
VERSION_MARGIN = 10.0
# int8 logits, served batch vs the graph evaluated on the request alone:
# the int8 products are exact and every other op is row-independent
INT8_EVAL_TOL = 1e-5
# int8 logits, card vs CPU: float rounding differences of 1e-7 flip
# activation codes at rounding boundaries, and 12 layers carry the flips
# on: scaling one range of the CPU graph by (1 + 2**-23) moved its logits
# by 4% of their largest size (a 1e-6 change by 6%), so card and CPU are
# held to 15% of it, and to the same class where the two logits differ
# by more than that
INT8_CPU_SHARE = 0.15
CPU_TOL = 1e-3    # float32 logits after 12 layers, CPU vs card summation order
# one training step, card vs CPU copy, float32 (2 layers at BERT-base
# width): the loss to rtol 1e-4; each parameter element to 1e-5 of its
# magnitude plus 5e-2 * lr. Adam's first step moves a weight by about lr
# whatever its gradient's size, so where a gradient is rounding noise on
# both sides (the attention key biases, whose true gradient is zero, and a
# few embedding elements whose token contributions cancel) the two runs
# differ by up to a step each way: for Adam, at most 1e-5 of a tensor's
# elements (every element of a key bias) may exceed the bound, and none
# may differ by more than 2 * lr (each run moves a weight by at most lr).
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_RTOL, STEP_PARAM_LR_FRAC = 1e-5, 5e-2
ADAM_NOISE_SHARE = 1e-5
TRAIN = {"batch": 32, "steps": 20, "warmup": 3, "lr": 1e-4, "wd": 1e-4}
# training capture (compile sites trainer, executor, cachedop's pair):
# captured against eager from one synchronised state, each tensor's
# update within 1e-3 of its L2 norm (or bit for bit, which the phase
# reports); float32 ResNet-50 steps within 5% (cuDNN's weight gradients
# may sum in another order: tests/test_torch_resnet_train.py's bound),
# a captured step's memory (the graph's pool and what a replay
# allocates) at most 1.25 times what an eager step allocates beyond the
# trainer's own state
CAPTURE_STEP_L2 = 1e-3
CAPTURE_RESNET_STEP_L2 = 0.05
CAPTURE_PEAK_RATIO = 1.25
TRAIN_CAPTURE = {"steps": 20, "warmup": 3, "bit_steps": 3}
# cifar10_dist.py:71-87's loop (hybridize, record, backward, a
# gluon.Trainer) on one card at BERT-base width, Adam on a local store
GLUON_HYBRID = {"steps": 20, "lr": 1e-4, "wd": 1e-4}
DROPOUT_CAPTURE = {"units": 1024, "batch": 64, "rate": 0.5, "steps": 5,
                   "seed": 11}
# two workers on the card through dist_sync + 2-bit compression +
# gluon.Trainer (examples/distributed_training/cifar10_dist.py's path);
# each worker trains on its shard of make_task (rows rank, rank + 2, ...):
# one fixed batch of 32, so that the loss falls within a few steps
DIST_TRAIN = {"workers": 2, "batch": 32, "steps": 10, "warmup": 3,
              "threshold": 0.5, "lr": 1e-4, "wd": 1e-4, "timeout_s": 600}
# narrow width, 2 layers, a threshold at which codes of both signs fire
DIST_CHECK = {"workers": 2, "batch": 8, "steps": 3, "threshold": 0.02,
              "timeout_s": 300,
              "cfg": dict(BERT_BASE, vocab=1000, units=64, hidden=128,
                          heads=2, layers=2, seq_len=32),
              "optimizers": {"sgd": {"learning_rate": 0.05, "momentum": 0.9,
                                     "wd": 1e-4},
                             "adam": {"learning_rate": 1e-3, "wd": 1e-4}}}
DIST_WEIGHT_RTOL = 1e-6   # final weights, card workers vs CPU recompute
# the 2-bit kernels in float16 and bfloat16: thresholds the types cannot
# hold (0.1) and can (0.5)
TWOBIT_HALF_THRESHOLDS = (0.5, 0.1)
# bench.py:275-303 with BENCH_DTYPE=float32, at full width and batch
RESNET50 = {"model": "resnet50_v1", "classes": 1000, "batch": 128,
            "size": 224, "warmup": 3, "steps": 10, "lr": 0.05,
            "momentum": 0.9, "wd": 1e-4, "tensors": 193, "aux": 106,
            "values": 25575912}
# three steps of a thumbnail resnet18_v1 on the card and on a CPU copy,
# the CPU copy set to the card's weights, momenta and running statistics
# before each step. A float32 forward leaves a few ReLU inputs within
# rounding of zero, and which side they fall on differs between cuDNN
# and the CPU; each flip moves the gradients upstream of it by up to a
# few percent (tests/test_torch_resnet_train.py measured 1.94% of a
# step's L2 norm between the port and the JAX package on the CPU). So:
# the loss to rtol 1e-4 and the running statistics to 1e-4 of their
# largest magnitude (forwards, summed in other orders), every weight and
# momentum tensor within 5% of the L2 norm of the card's step for it.
RESNET_CHECK = {"model": "resnet18_v1", "classes": 10, "batch": 8,
                "size": 32, "steps": 3, "tensors": 60, "aux": 38}
RESNET_CHECK_TOL = {"loss_rtol": 1e-4, "aux": 1e-4, "step_l2": 0.05}
# bench.py's default dtype (BENCH_DTYPE=bfloat16): ``net.cast`` keeps
# BatchNorm's 106 gamma/beta tensors in float32, so 87 tensors
# (25,522,792 values: 53 convolution weights, 32 biases, the Dense pair)
# are bfloat16. Without multi_precision those take the plain
# sgd_mom_update route in bfloat16 and K1 updates the 106 float32 ones;
# with it K1 updates all 193 (87 float32 masters among them). The two
# casts around K1 move 12 B per master value.
RESNET50_BF16 = {"dtype": "bfloat16", "half": 87, "float32": 106,
                 "master_values": 25522792, "infer_warmup": 2,
                 "infer_iters": 20}
# resnet_check in bfloat16 with multi_precision, the CPU copy set to the
# card's state before each step: held to tests/test_torch_multi_
# precision.py's tolerances, which were measured there (one bfloat16 step
# differs from the float32 step of the same package by up to 59% of its
# L2 norm in a tensor; port and JAX package by up to 50%)
RESNET_CHECK_BF16_TOL = {"loss_rtol": 2e-2, "aux": 1e-2, "step_l2": 0.75}
# checkpoint and resume of the thumbnail with an lr schedule
RESNET_RESUME = {"steps": 3, "milestones": [2, 4], "factor": 0.1}
# examples/image_classification/train_imagenet.py --benchmark 1
# --network resnet50_v1 (its parser defaults, :62-68, and fit.fit's
# wiring, common/fit.py:106-163): batch 128 of 3x224x224 from
# SyntheticDataIter, 1000 classes, "sgd" lr 0.1 momentum 0.9 wd 1e-4
# with a MultiFactorScheduler at epochs 30, 60 and 80 of
# num_examples / batch_size batches, float32, TF32 off. The one cut:
# epoch_size 13 batches (3 warm-up, 10 timed) instead of 10009.
MODULE_FIT = {"network": "resnet50_v1", "num_classes": 1000, "batch": 128,
              "image_shape": (3, 224, 224), "lr": 0.1, "lr_factor": 0.1,
              "lr_step_epochs": "30,60,80", "mom": 0.9, "wd": 1e-4,
              "num_examples": 1281167, "disp_batches": 10,
              "epoch_size": 13, "warmup": 3, "tensors": 193, "aux": 106,
              "reduced": "epoch_size 13 batches (3 warm-up, 10 timed), "
                         "not num_examples // batch_size = 10009"}
# resnet50_v1_module_fit_custom: each tensor's change (weights and
# BatchNorm statistics) after the first batch with the Custom head against
# its change with SoftmaxOutput, as a share of the latter's L2 norm, on a
# floor of a thousandth of the largest tensor's change (ResNet-50 v1's
# bottleneck convolutions have biases that feed train-mode BatchNorm: their
# true gradient is 0 and rounding alone moves them). The two heads compute
# one gradient (the host's numpy softmax against the card's), so within
# 1e-3; a head that moved nothing reads 1. The 13-batch change is printed
# and not held: at lr 0.1 two SoftmaxOutput fits from one seed drift apart
# by 119-146% of a tensor's change (cuDNN's weight gradients sum in varying
# order; an H100 80GB HBM3, 700 W). The loss: the first update lowers the
# repeated batch's loss by at least a tenth (7.94 to 6.33 in every call on
# that card); the 13 batches' losses spike to about 10 and end at 6.9-8.2,
# above the first in some calls, so they are printed and not held
CUSTOM_FIT_TOL = {"first_batch": 1e-3, "floor": 1e-3,
                  "first_update_loss_drop": 0.1}
# the thumbnail of resnet_check through Module on the card and on a CPU
# copy, the copy set to the card's state before each step; held as
# resnet_check is (RESNET_CHECK's comment says why), the outputs of the
# training forward to 1e-4 (probabilities)
MODULE_CHECK = {"model": "resnet18_v1", "classes": 10, "batch": 8,
                "size": 32, "steps": 3, "tensors": 60, "aux": 38,
                "lr": 0.05, "momentum": 0.9, "wd": 1e-4}
MODULE_CHECK_TOL = {"out": 1e-4, "aux": 1e-4, "step_l2": 0.05}


# the data plane's phases. native_io holds the native IO library built on
# the card's machine against its plain versions on NATIVE_IO["images"]
# seeded images (sizes as im2rec --resize 256 leaves ImageNet photos, and
# odd ones), bit for bit. imagenet_rec is the cell
# resnet50_v1_module_fit_rec: train_imagenet.py --data-train <rec>
# --network resnet50_v1 at the example's defaults (MODULE_FIT's wiring)
# over IMAGENET_REC["images"] PNG records packed at run time by the port's
# pack_img (1000 classes; 256 x 341 landscape and 341 x 256 portrait
# smooth random fields plus noise, from RandomState(0)), read by
# ImageRecordIter(shuffle, rand_crop, rand_mirror) with the JAX package's
# defaults (4 decode threads, 2 batches of prefetch). The cut: 40 batches
# a fit (3 warm-up, 37 timed; two passes over the records, so the
# prefetched batches drain and the producer's pace shows), for the
# synthetic batch too in this phase; 40 and 12 batches (the iterator
# alone's readings) since bert_base_sst2_finetune_zero joined the script,
# which keeps its time.
NATIVE_IO = {"images": 64, "sizes": [(256, 341), (341, 256), (37, 53),
                                     (64, 48)]}
IMAGENET_REC = {"images": 2560, "classes": 1000, "landscape": (256, 341),
                "noise": 4.0, "data_shape": (3, 224, 224), "batch": 128,
                "threads": 4, "prefetch": 2, "warmup": 2, "timed": 12,
                "reps": 3, "alone_timed": 4, "fit_batches": 40,
                "plain_batches": 2, "resume_at": 5, "resume_next": 3,
                "thumbnail": {"model": "resnet18_v1", "classes": 1000,
                              "batch": 8, "size": 32, "steps": 3,
                              "after": 2},
                "reduced": "2,560 images packed at run time (not the "
                           "1,281,167 of ImageNet's train set); 40 "
                           "batches a fit (two passes over the set), "
                           "not 10009"}

# examples/gluon/transformer_lm.py's defaults, and the same LM at
# GPT-2-small width (12 layers, 768 units, 3072 FFN, 12 heads, 1024
# positions, GPT-2's 50257-token vocabulary; about 163 M parameters)
LM_DEFAULTS = {"vocab": 128, "units": 64, "hidden": 128, "layers": 2,
               "heads": 4, "seq_len": 32, "batch": 16, "lr": 3e-3,
               "steps": 60, "corpus_tokens": 20000}
LM_GPT2S = {"vocab": 50257, "units": 768, "hidden": 3072, "layers": 12,
            "heads": 12, "seq_len": 1024, "batch": 8, "lr": 3e-4,
            "corpus_tokens": 20000, "warmup": 3, "blocks": 4,
            "block_steps": 5, "bit_steps": 3, "variant_steps": 10}


def build_encoder(args, mx, nn, contrib_nn, exportable=False):
    """``examples/gluon/transformer_finetune.py:build_encoder``, verbatim;
    ``exportable`` puts ``gluon.nn.Embedding`` (a HybridBlock, same
    weight and lookup) in place of ``SparseEmbedding`` (a plain Block,
    which ``export`` cannot trace into a graph)."""
    enc = nn.HybridSequential(prefix="encoder_")
    embedding = nn.Embedding if exportable else contrib_nn.SparseEmbedding
    with enc.name_scope():
        enc.add(embedding(args.vocab, args.units))
        for _ in range(args.layers):
            enc.add(contrib_nn.TransformerEncoderCell(
                args.units, args.hidden, args.heads))
    return enc


def build_classifier(mx, cfg, exportable=False, prefix=None):
    """The example's ``Classifier`` (encoder, first-token pooling through
    ``slice_axis`` + ``Flatten``, ``Dense(tanh)``, ``Dense(classes)``)
    built from package ``mx``'s blocks; ``cfg`` holds the
    ``BERT_BASE`` keys. ``exportable``: see :func:`build_encoder` (the
    int8 flow exports the block); ``prefix`` names its parameters."""
    nn, contrib_nn = mx.gluon.nn, mx.gluon.contrib.nn
    args = type("Args", (), dict(cfg))

    class Classifier(nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = build_encoder(args, mx, nn, contrib_nn,
                                             exportable)
                self.pool = nn.Dense(args.units, activation="tanh",
                                     flatten=False)
                self.out = nn.Dense(args.num_classes)

        def hybrid_forward(self, F, tokens):
            h = self.encoder(tokens)
            # BERT-style pooling over the first position
            first = F.invoke("slice_axis", h, axis=1, begin=0, end=1)
            return self.out(self.pool(F.invoke("Flatten", first)))

    return Classifier(prefix=prefix)


def classifier_shapes(cfg):
    """Structural parameter name -> shape of ``build_classifier(cfg)``."""
    u, hdn = cfg["units"], cfg["hidden"]
    shapes = {"encoder.0.weight": (cfg["vocab"], u)}
    for i in range(1, cfg["layers"] + 1):
        c = f"encoder.{i}."
        for ln in ("ln1", "ln2"):
            shapes[c + ln + ".gamma"] = (u,)
            shapes[c + ln + ".beta"] = (u,)
        for d in ("query", "key", "value", "proj"):
            shapes[c + f"attn.{d}.weight"] = (u, u)
            shapes[c + f"attn.{d}.bias"] = (u,)
        shapes[c + "ffn1.weight"] = (hdn, u)
        shapes[c + "ffn1.bias"] = (hdn,)
        shapes[c + "ffn2.weight"] = (u, hdn)
        shapes[c + "ffn2.bias"] = (u,)
    shapes["pool.weight"] = (u, u)
    shapes["pool.bias"] = (u,)
    shapes["out.weight"] = (cfg["num_classes"], u)
    shapes["out.bias"] = (cfg["num_classes"],)
    return shapes


def random_params(cfg, seed):
    """Xavier-uniform weights, small random biases, LayerNorm gains near
    1, as float32 numpy arrays from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in classifier_shapes(cfg).items():
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rs.standard_normal(shape)
        elif len(shape) == 1:
            a = 0.02 * rs.standard_normal(shape)
        else:
            scale = math.sqrt(3.0 / ((shape[0] + shape[1]) / 2.0))
            a = rs.uniform(-scale, scale, shape)
        out[name] = a.astype(np.float32)
    return out


def lm_corpus(vocab, tokens, seed=42):
    """``examples/gluon/transformer_lm.py:66-75``'s synthetic bigram
    corpus, verbatim: Zipf-distributed tokens, each followed by a fixed
    successor with probability 0.8."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    succ = rng.permutation(vocab)
    ids = [int(rng.choice(ranks, p=probs))]
    for _ in range(tokens - 1):
        ids.append(int(succ[ids[-1]]) if rng.rand() < 0.8
                   else int(rng.choice(ranks, p=probs)))
    return np.asarray(ids, np.int32)


def lm_windows(ids, seq_len):
    """(windows, next-token labels), each ``(n, seq_len)`` (the
    example's :105-108)."""
    n_win = (len(ids) - 1) // seq_len
    return (ids[: n_win * seq_len].reshape(n_win, seq_len),
            ids[1: n_win * seq_len + 1].reshape(n_win, seq_len))


def build_lm(mx, cfg, dropout=0.0, ctx=None):
    """``examples/gluon/transformer_lm.py:78-140`` from package ``mx``'s
    blocks: ``TransformerLM`` (token and position embeddings, a stack of
    causal ``TransformerEncoderCell``s, a ``Dense`` head over the
    vocabulary), ``LMLoss`` (softmax CE over the flattened logits) and
    the ``WithPos`` adapter that feeds ``nd.arange(seq_len)`` positions.
    ``cfg`` holds ``LM_DEFAULTS``' keys; ``dropout`` goes to each cell
    (the example's cells have none). Returns ``(net, adapter, loss)``;
    the net is not initialized."""
    import importlib

    gluon, nn = mx.gluon, mx.gluon.nn
    contrib_nn = importlib.import_module(mx.__name__ + ".gluon.contrib.nn")
    vocab, seq_len = cfg["vocab"], cfg["seq_len"]
    cell_kw = {"dropout": dropout} if dropout else {}

    class TransformerLM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, cfg["units"])
                self.pos = nn.Embedding(seq_len, cfg["units"])
                self.body = nn.HybridSequential()
                for _ in range(cfg["layers"]):
                    self.body.add(contrib_nn.TransformerEncoderCell(
                        cfg["units"], cfg["hidden"], cfg["heads"],
                        causal=True, **cell_kw))
                self.head = nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, tokens, positions):
            h = self.embed(tokens) + self.pos(positions)
            return self.head(self.body(h))

    pos_nd = mx.nd.arange(seq_len, ctx=ctx)

    class LMLoss(gluon.loss.Loss):
        """Softmax CE over the flattened (B*T, V) logits."""

        def __init__(self):
            super().__init__(weight=None, batch_axis=0)
            self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def hybrid_forward(self, F, pred, label):
            return self._ce(pred.reshape((-1, vocab)), label.reshape((-1,)))

    class WithPos(gluon.HybridBlock):
        """Adapter: ShardedTrainer drives fn(x); positions are constant."""

        def __init__(self, inner, **kw):
            super().__init__(**kw)
            self.inner = inner

        def hybrid_forward(self, F, x):
            return self.inner(x, pos_nd)

    net = TransformerLM()
    return net, WithPos(net), LMLoss()


def make_task(num_samples, seq_len, vocab, num_classes, seed=0):
    """``examples/gluon/transformer_finetune.py:make_task``, verbatim:
    the class is the marker token placed somewhere in the sequence."""
    rs = np.random.RandomState(seed)
    x = rs.randint(num_classes, vocab, (num_samples, seq_len))
    y = rs.randint(0, num_classes, num_samples)
    pos = rs.randint(0, seq_len, num_samples)
    x[np.arange(num_samples), pos] = y  # marker token = class id
    return x.astype(np.float32), y.astype(np.float32)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_ATTEMPTS = 3  # windows tried before a profiled time falls back


def _caller():
    """``function:line`` of the measurement's caller, for its miss line."""
    frame = sys._getframe(1)
    while frame.f_code.co_name in ("kernel_device_us", "device_ms"):
        frame = frame.f_back
    return f"{frame.f_code.co_name}:{frame.f_lineno}"


# substrings of the hand-written kernels' names (``csrc/*.cu``): one
# wrapper launch is one launch of one of them
HANDWRITTEN_KERNELS = ("flash_fwd_", "flash_bwd_", "int8_gemm_kernel",
                       "opt_step_kernel", "twobit_", "decode_attention_kernel")


def _handwritten(name):
    return any(k in name for k in HANDWRITTEN_KERNELS)


def _wrapper_launches():
    """Launches the kernel wrappers have counted so far, all families."""
    return sum(n for k, n in kernels.launch_counts().items() if "." not in k)


def kernel_device_us(fn, iters=20, warmup=3):
    """``{kernel name: device µs per call}`` of ``fn()`` over ``iters``
    calls, from ``torch.profiler``: each kernel's summed time over the
    window divided by ``iters``, the window recorded after a warm-up
    cycle of ``iters`` calls. A window is refused and tried again, up
    to ``PROFILE_ATTEMPTS`` windows, when the profiler recorded no kernel
    at all (seen once on the H100, after the capture phases: a
    ``profiler_miss`` line) or when its recorded launch counts are not
    those of ``iters`` calls: the hand-written kernels' together must
    equal the launches their wrappers counted in the window (``iters``
    times one call's), and every kernel's must be a multiple of
    ``iters`` (a ``profiler_count`` line naming each such kernel with
    both counts). An accepted window prints a ``device_window`` line with
    each kernel's µs per call beside its recorded count. An empty dict
    if every window was refused."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        # a warm-up cycle of the profiler before the recorded one: a
        # window that starts recording cold lost its first launches on
        # the H100 (5 to 8 of 20 after the capture phases)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
            before = _wrapper_launches()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            launched = _wrapper_launches() - before
            prof.step()
        events = prof.key_averages()
        # a user annotation (``Optimizer.step#Adam.step``, from
        # ``torch.optim``'s ``record_function``) is listed as a CUDA range
        # over the kernels it holds: counting it too would count them
        # twice
        got = {e.key: (e.self_device_time_total / iters, e.count)
               for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0}
        if not got:
            emit({"phase": "profiler_miss", "at": _caller(),
                  "attempt": attempt, "events": len(events),
                  "cuda_events": sum(e.device_type == DeviceType.CUDA
                                     for e in events)})
            continue
        mine = {k: n for k, (_, n) in got.items() if _handwritten(k)}
        bad = {k: {"recorded": n, "expected": f"a multiple of {iters}"}
               for k, (_, n) in got.items() if n % iters}
        if sum(mine.values()) != launched:
            bad.update((k, {"recorded": n, "expected_all_handwritten":
                            launched, "recorded_all_handwritten":
                            sum(mine.values())}) for k, n in mine.items())
            if not mine:
                bad["hand-written kernels"] = {
                    "recorded": 0, "expected": launched}
        if bad:
            emit({"phase": "profiler_count", "at": _caller(),
                  "attempt": attempt, "iters": iters, "kernels": bad})
            continue
        emit({"phase": "device_window", "at": _caller(), "iters": iters,
              "kernels": {k: {"us": us, "count": n}
                          for k, (us, n) in got.items()}})
        return {k: us for k, (us, _) in got.items()}
    return {}


def device_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``iters`` calls: the
    summed time of the kernels it launches, from ``torch.profiler``, with
    neither host time nor the gaps between kernels. Where ``fn`` costs
    the host more than the card, ``cuda_ms`` measures the host. Where
    every profiler window missed (``kernel_device_us``), the time is
    taken by CUDA events instead and a ``profiler_fallback`` line says
    so."""
    us = sum(kernel_device_us(fn, iters, warmup).values())
    if us > 0:
        return us / 1e3
    ms = cuda_ms(fn, iters, warmup)
    emit({"phase": "profiler_fallback", "at": _caller(),
          "cuda_events_ms": ms})
    return ms


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi}
    emit({"phase": "device", **dev, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return dev


def ptxas_entries(report):
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from
    nvcc's ``-Xptxas -v`` report (mangled kernel names)."""
    entries, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            entries.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            entries[name]["spill_stores"] = int(m.group(1))
            entries[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            entries[name]["registers"] = int(m.group(1))
    return entries


def _no_spills(report, kernel, key):
    """Fail unless ptxas reported every entry of ``key`` (a substring of
    the mangled names) with no spill; returns those entries."""
    found = {n: e for n, e in ptxas_entries(report).items() if key in n}
    if not found or any("spill_stores" not in e or e["spill_stores"]
                        or e["spill_loads"] for e in found.values()):
        raise AssertionError(f"{kernel} spills registers (or ptxas gave no "
                             f"report): {found}")
    return found


def phase_build():
    t0 = time.perf_counter()
    report = build.build_all(force=True)
    wall = time.perf_counter() - t0
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
        emit({"phase": "build", "kernel": name, "seconds": r["seconds"],
              "ptxas": ptxas})
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill",
                                         report["int8_gemm"]["ptxas"])]
    if not spills or any(spills):
        raise AssertionError(f"int8_gemm spills registers (or ptxas gave "
                             f"no report): {spills}")
    mma = _no_spills(report["flash_attention"]["ptxas"], "flash_attention",
                     "flash_fwd_mma_kernel")
    emit({"phase": "build", "kernel": "flash_attention",
          "mma_kernels": mma})
    bwd = {key: _no_spills(report["flash_attention_bwd"]["ptxas"],
                           "flash_attention_bwd", key)
           for key in ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")}
    emit({"phase": "build", "kernel": "flash_attention_bwd",
          "mma_kernels": {n: e for found in bwd.values()
                          for n, e in found.items()}})
    emit({"phase": "build", "kernel": "opt_step",
          "kernels": _no_spills(report["opt_step"]["ptxas"], "opt_step",
                                "opt_step_kernel")})
    emit({"phase": "build", "kernels": sorted(report), "wall_s": wall})


def attention_bound_ms(q, k, causal, dtype_flops):
    """Least time for one attention call: each of q, k, v, o moved once
    over HBM, or the multiply-adds of the unmasked score pairs (QK^T and
    PV, 2 FLOP each) at the card's peak for the input type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * q.element_size()
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * pairs * d
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / dtype_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_tc_bound_ms(q, k, causal):
    """``bound_tc_ms``: the multiply-adds of :func:`attention_bound_ms` at
    the tensor cores' float32-accurate rate (each product as three TF32
    products, the kernel's 3xTF32 split), or the bytes, whichever takes
    longer."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * q.element_size()
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return _bound_ms(nbytes, 4 * b * h * pairs * d, H100_3XTF32_FLOPS)


# (B, H, Sq, Sk, D), dtype, causal, layout: the serving/training shape,
# ragged S, cross attention (Sq != Sk), every head-dim bucket, bfloat16;
# layout "dense" is contiguous (B, H, S, D); "bshd" transposed views of
# (B, S, H, D) tensors, as MultiHeadAttention hands them over (no copy);
# "unaligned" a q whose rows start 4 bytes off 16 (one copy); "ramp_v" a
# v that alternates in sign from key to key and grows along keys and
# columns, so that a wrong key order in the P V product changes the output
FLASH_CASES = [((32, 12, 128, 128, 64), dt, c, "dense")
               for dt in (torch.float32, torch.bfloat16) for c in (False, True)]
FLASH_CASES += [((8, 12, 100, 100, 64), torch.float32, False, "dense"),
                ((8, 12, 100, 100, 64), torch.float32, True, "dense"),
                ((4, 12, 128, 256, 64), torch.float32, False, "dense"),
                ((4, 8, 128, 128, 128), torch.float32, False, "dense"),
                ((4, 8, 128, 128, 128), torch.bfloat16, True, "dense"),
                ((2, 4, 96, 80, 40), torch.float32, True, "dense"),
                ((2, 4, 64, 64, 256), torch.float32, False, "dense"),
                ((2, 4, 48, 48, 512), torch.float32, True, "dense"),
                ((32, 12, 128, 128, 64), torch.float32, False, "bshd"),
                ((32, 12, 128, 128, 64), torch.bfloat16, True, "bshd"),
                ((4, 8, 100, 100, 128), torch.float32, True, "bshd"),
                ((2, 4, 96, 80, 40), torch.float32, False, "bshd"),
                ((2, 4, 64, 64, 256), torch.float32, True, "bshd"),
                ((4, 12, 128, 128, 64), torch.float32, False, "unaligned"),
                ((4, 12, 128, 128, 64), torch.float32, False, "ramp_v"),
                ((4, 12, 128, 128, 64), torch.float32, True, "ramp_v"),
                ((4, 8, 72, 72, 128), torch.bfloat16, False, "ramp_v")]
# transformer_lm's GPT-2-small attention, causal, in the (B, S, H, D)
# views MultiHeadAttention hands over (the slice's path)
LM_FLASH = (8, 12, 1024, 1024, 64)
FLASH_CASES += [(LM_FLASH, dt, True, "bshd")
                for dt in (torch.float32, torch.bfloat16)]


def flash_inputs(shape, dtype, layout, gen, dev):
    """q, k, v of one FLASH_CASES entry (see its comment for layouts)."""
    b, h, sq, sk, d = shape

    def rand(s):
        if layout == "bshd":
            return torch.randn((b, s, h, d), generator=gen, device=dev
                               ).to(dtype).permute(0, 2, 1, 3)
        return torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)

    q, k, v = rand(sq), rand(sk), rand(sk)
    if layout == "unaligned":
        buf = torch.empty(q.numel() + 1, dtype=dtype, device=dev)
        q = buf[1:].view(q.shape).copy_(q)
    elif layout == "ramp_v":
        keys = torch.arange(sk, device=dev, dtype=torch.float32)
        cols = torch.arange(d, device=dev, dtype=torch.float32) / d
        sign = 1.0 - 2.0 * (keys % 2)
        v = (sign * (1.0 + keys / sk))[:, None] + 0.1 * cols[None, :]
        v = v.expand(b, h, sk, d).to(dtype).contiguous()
        q = q * 2.0   # peaked rows, so that each key's weight matters
    return q, k, v


def _flash_path(d):
    return "mma" if d <= 128 else "simt"


def phase_flash():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fwd = flash.flash_forward

    slice_err = None
    for shape, dtype, causal, layout in FLASH_CASES:
        b, h, sq, sk, d = shape
        q, k, v = flash_inputs(shape, dtype, layout, gen, dev)
        scale = 1.0 / math.sqrt(d)
        path = _flash_path(d)
        before, copies = dict(fwd.launches_by_path), fwd.copies
        got = fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        took = [p for p, n in fwd.launches_by_path.items() if n != before[p]]
        copied = fwd.copies - copies
        if took != [path] or copied != (layout == "unaligned"):
            raise AssertionError(f"flash at {shape} {layout}: took {took}, "
                                 f"copied {copied} inputs; expected "
                                 f"{path} and {int(layout == 'unaligned')}")
        if got.shape != q.shape or got.dtype != dtype or \
                not got.permute(0, 2, 1, 3).is_contiguous():
            raise AssertionError(f"flash output at {shape}: {got.shape} "
                                 f"{got.dtype} strides {got.stride()}, not a "
                                 "(B, H, S, D) view of (B, S, H, D) memory")
        want = flash.flash_attention_plain(q, k, v, scale, causal)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        diff = (got.float() - want.float()).abs()
        max_abs = diff.max().item()
        max_rel = (diff / want.float().abs().clamp_min(1e-6)).max().item()
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        emit({"phase": "flash", "shape": [b, h, sq, sk, d],
              "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "layout": layout, "path": path, "copies": copied,
              "max_abs_err": max_abs, "max_rel_err": max_rel,
              "rtol_atol": tol, "ok": ok})
        if not ok:
            raise AssertionError(f"flash kernel disagrees with the plain "
                                 f"version at {(b, h, sq, sk, d)} {dtype} "
                                 f"causal={causal} {layout}: max abs err "
                                 f"{max_abs}")
        if shape == (32, 12, 128, 128, 64) and dtype == torch.float32 and \
                not causal and layout == "dense":
            slice_err = max_abs

    shape = (32, 12, 128, 128, 64)
    q, k, v = flash_inputs(shape, torch.float32, "dense", gen, dev)
    qs, ks, vs = flash_inputs(shape, torch.float32, "bshd", gen, dev)
    scale = 0.125
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = cuda_ms(lambda: fwd(q, k, v, scale, False))
    plain_ms = cuda_ms(
        lambda: flash.flash_attention_plain(q, k, v, scale, False))
    library_ms = cuda_ms(lambda: sdpa(q, k, v, scale=scale))
    kernel_bshd_ms = cuda_ms(lambda: fwd(qs, ks, vs, scale, False))
    dev_ms = device_ms(lambda: fwd(q, k, v, scale, False))
    lib_kernels = kernel_device_us(lambda: sdpa(q, k, v, scale=scale))
    bound_ms, bound_by = attention_bound_ms(q, k, False, H100_F32_FLOPS)
    bound_tc_ms, bound_tc_by = attention_tc_bound_ms(q, k, False)
    timing = {"shape": list(shape), "dtype": "float32", "causal": False,
              "kernel_ms": kernel_ms, "device_ms": dev_ms,
              "kernel_bshd_ms": kernel_bshd_ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library_device_ms": sum(lib_kernels.values()) / 1e3,
              "library_kernels": sorted(lib_kernels),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_tc_ms": bound_tc_ms, "bound_tc_by": bound_tc_by,
              "blocks_per_sm": {str(d): flash.forward_blocks_per_sm(d)
                                for d in (64, 128, 256, 512)},
              "max_abs_err": slice_err}
    timing["lm_shape"] = _flash_lm_timing(gen, dev)
    emit({"phase": "flash_timing", **timing})
    return timing


def _flash_lm_timing(gen, dev):
    """K3 at transformer_lm's shape (``LM_FLASH``, causal, float32, the
    (B, S, H, D) views the LM passes): kernel, plain version and causal
    SDPA by CUDA events, and the bounds."""
    q, k, v = flash_inputs(LM_FLASH, torch.float32, "bshd", gen, dev)
    scale = 1.0 / math.sqrt(LM_FLASH[-1])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = flash.flash_forward
    bound, by = attention_tc_bound_ms(q, k, True)
    return {"shape": list(LM_FLASH), "dtype": "float32", "causal": True,
            "layout": "bshd",
            "kernel_ms": cuda_ms(lambda: fwd(q, k, v, scale, True)),
            "plain_ms": cuda_ms(lambda: flash.flash_attention_plain(
                q, k, v, scale, True), iters=5),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                               scale=scale)),
            "bound_tc_ms": bound, "bound_tc_by": by,
            "bound_ms": attention_bound_ms(q, k, True, H100_F32_FLOPS)[0]}


def _flash_bwd_lm_timing(gen, dev):
    """K3-bwd at transformer_lm's shape (``LM_FLASH``, causal, float32,
    (B, S, H, D) views): dq and dkv, their plain versions and causal
    SDPA's backward by CUDA events, and the bounds."""
    q, k, v = flash_inputs(LM_FLASH, torch.float32, "bshd", gen, dev)
    do = flash_inputs(LM_FLASH, torch.float32, "bshd", gen, dev)[0]
    scale = 1.0 / math.sqrt(LM_FLASH[-1])
    o, lse = flash.flash_forward(q, k, v, scale, True, with_lse=True)
    dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale, True)[1]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=scale)
    bounds = flash_bwd_bounds(q, k, True)
    return {"shape": list(LM_FLASH), "dtype": "float32", "causal": True,
            "layout": "bshd",
            "ms": {"dq": cuda_ms(lambda: flash.flash_backward_dq(
                       q, k, v, o, lse, do, scale, True)),
                   "dkv": cuda_ms(lambda: flash.flash_backward_dkv(
                       q, k, v, lse, dsum, do, scale, True)),
                   "dq_plain": cuda_ms(lambda: flash.flash_backward_dq_plain(
                       q, k, v, o, lse, do, scale, True), iters=5),
                   "dkv_plain": cuda_ms(
                       lambda: flash.flash_backward_dkv_plain(
                           q, k, v, lse, dsum, do, scale, True), iters=5),
                   "library": cuda_ms(lambda: torch.autograd.grad(
                       out, leaves, do, retain_graph=True))},
            "bound_ms": {n: b[0] for n, b in bounds.items()},
            "bound_by": {n: b[1] for n, b in bounds.items()}}


def _traffic(cfg):
    """The serve phases' burst: 4 threads x 12 requests of 1-8 rows of
    random token ids, from ``RandomState(1)``."""
    rs = np.random.RandomState(1)
    return [[rs.randint(0, cfg["vocab"], (rs.randint(1, 9), cfg["seq_len"]))
             .astype(np.float32) for _ in range(12)] for _ in range(4)]


def _burst(server, model, payloads):
    """Submit every payload at once, one thread per row of payloads;
    returns the answers (same layout), the wall seconds, the launch
    counts over the burst and the model's stats. Fails unless every
    request of the burst was answered."""
    futures = [[None] * len(row) for row in payloads]
    before = server.stats()["models"][model.name]["completed"]

    def client(i):
        for j, x in enumerate(payloads[i]):
            futures[i][j] = server.submit(model.name, x)

    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("a client thread did not finish submitting")
    answers = [[f.result(timeout=300) for f in row] for row in futures]
    wall = time.perf_counter() - t_start
    counts = kernels.launch_counts()
    stats = server.stats()["models"][model.name]
    n = sum(len(row) for row in payloads)
    if stats["completed"] - before != n or stats["failed"]:
        raise AssertionError(f"not every request was answered: {stats}")
    stats["burst_latency_ms"] = [f.latency_ms() for row in futures
                                 for f in row]
    return answers, wall, counts, stats


def _pool_bytes():
    """Device bytes the caching allocator holds beyond live tensors once
    its unused cached blocks are released: with CUDA graphs captured,
    mostly their private memory pools (a dropped trainer or block frees
    its graphs at once; other unreachable cycles are collected first)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() - torch.cuda.memory_allocated()


def _eager(fn, *args):
    """``fn(*args)`` with the compile service off: the forwards run
    eagerly, op by op (the explicit eager route)."""
    prev = compile_service.set_enabled(False)
    try:
        return fn(*args)
    finally:
        compile_service.set_enabled(prev)


def _paired_bursts(models, payloads, pairs=5):
    """Alternating bursts of the same traffic through one server over
    ``models``, each model with its buckets' graphs replayed
    ("captured") and with the compile service off ("eager"), in A B B A
    order over the variants: rows/s, p50 and p99 of each burst, the
    median of each variant's bursts, and the serving site's new entries
    over all the bursts (0: every bucket was captured by warmup)."""
    from mxnet_tpu_torch.serving.metrics import percentile

    server = serving.ModelServer(serving.ModelContainer(models)).start()
    pools = _pool_bytes()
    server.warmup()
    pools = _pool_bytes() - pools
    misses = compile_service.stats()["serving"]["misses"]
    rows = sum(x.shape[0] for row in payloads for x in row)
    variants = [(m, mode) for m in models for mode in ("captured", "eager")]
    runs = {f"{m.name}/{mode}": [] for m, mode in variants}
    for i in range(pairs):
        for m, mode in (variants if i % 2 == 0 else variants[::-1]):
            if mode == "eager":
                _, wall, _, stats = _eager(_burst, server, m, payloads)
            else:
                _, wall, _, stats = _burst(server, m, payloads)
            lat = stats["burst_latency_ms"]
            runs[f"{m.name}/{mode}"].append({"rows_per_s": rows / wall,
                                             "p50_ms": percentile(lat, 50),
                                             "p99_ms": percentile(lat, 99)})
    if not server.drain(timeout=60):
        raise RuntimeError("server did not drain")
    out = {name: {"bursts": r, **{k: statistics.median(b[k] for b in r)
                                  for k in r[0]}}
           for name, r in runs.items()}
    out["serving_misses_during_bursts"] = \
        compile_service.stats()["serving"]["misses"] - misses
    out["graph_pool_bytes_added_by_warmup"] = pools
    if out["serving_misses_during_bursts"]:
        raise AssertionError(f"paired bursts captured after warmup: {out}")
    return out


def _serve_summary(stats, rows, wall, peak, before):
    return {"requests": stats["completed"], "rows": rows,
            "batches": stats["batches"],
            "bucket_census": stats["bucket_census"],
            "fill_ratio": stats["batch_fill_ratio"],
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "rows_per_s": rows / wall, "wall_s": wall,
            "memory_allocated_before": before, "max_memory_allocated": peak}


def phase_serve(smi):
    cfg = BERT_BASE
    t0 = time.perf_counter()
    weights = random_params(cfg, seed=0)
    n_params = sum(a.size for a in weights.values())
    clf = build_classifier(mx, cfg)
    clf.initialize(mx.init.Zero())          # the card: the default context
    load_jax_params(clf, weights)
    t_weights = time.perf_counter() - t0

    pools = _pool_bytes()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = serving.ServedModel.from_block("bert_base_sst2", clf,
                                           example_shape=(cfg["seq_len"],))
    server = serving.ModelServer(serving.ModelContainer([model])).start()
    warm = server.warmup()
    pools = _pool_bytes() - pools
    payloads = _traffic(cfg)
    copies = flash.flash_forward.copies
    answers, wall, counts, stats = _burst(server, model, payloads)
    copies = flash.flash_forward.copies - copies
    launches = counts["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if not server.drain(timeout=60):
        raise RuntimeError("server did not drain")

    rows = sum(x.shape[0] for row in payloads for x in row)
    want = cfg["layers"] * stats["batches"]
    if launches != want or counts["flash_attention.mma"] != want or copies:
        raise AssertionError(
            f"flash launches {launches} ({counts['flash_attention.mma']} on "
            f"the mma path), {copies} input copies; want {cfg['layers']} x "
            f"{stats['batches']} batches, all mma, no copy")

    max_err = 0.0
    for row_p, row_a in zip(payloads, answers):
        for x, got in zip(row_p, row_a):
            if got.shape != (x.shape[0], cfg["num_classes"]) or \
                    not np.isfinite(got).all():
                raise AssertionError(f"bad answer {got.shape}")
            with torch.inference_mode():
                want = clf(mx.nd.array(x)).asnumpy()
            max_err = max(max_err, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                       atol=SERVE_TOL)

    # the same model on the CPU, through the plain attention
    with mx.cpu():
        ref = build_classifier(mx, cfg)
        ref.initialize(mx.init.Zero())
        load_jax_params(ref, weights)
        x = payloads[0][0][:2]
        with torch.inference_mode():
            want = ref(mx.nd.array(x)).asnumpy()
    got = answers[0][0][:2]
    cpu_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL)

    summary = _serve_summary(stats, rows, wall, peak, before)
    emit({"phase": "serve", "card": smi, "params": int(n_params),
          "weights_s": t_weights, "warmup": warm["models"][model.name],
          "capture": model.capture_stats(), "graph_pool_bytes": pools,
          "memory_reserved_after": torch.cuda.memory_reserved(),
          **summary, "flash_launches": launches,
          "flash_launches_mma": counts["flash_attention.mma"],
          "flash_input_copies": copies,
          "max_abs_err_vs_block": max_err, "max_abs_err_vs_cpu": cpu_err})
    return dict(summary, flash_launches=launches), model


def _kernel_group(name):
    low = name.lower()
    for group, keys in (("int8_gemm", ("int8_gemm_kernel",)),
                        ("flash_attention", ("flash_fwd_",)),
                        ("flash_bwd", ("flash_bwd_",)),
                        ("optimizer", ("opt_step_kernel",)),
                        ("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas")),
                        ("layer_norm", ("layer_norm",)),
                        ("activations", ("gelu", "tanh")),
                        # the activation quantize passes (x / s, round,
                        # clip; their int8 cast counts as a copy)
                        ("quantize", ("div_true", "round", "clamp")),
                        ("copy", ("memcpy", "copy"))):
        if any(k in low for k in keys):
            return group
    return "other"


def _host_split(prof, reps, top=8):
    """Host microseconds per repetition of the ops that took the most
    host time themselves, from a ``torch.profiler`` run."""
    host = [(e.key, e.self_cpu_time_total / reps, e.count // reps)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    return [[k[:60], us, n] for k, us, n in
            sorted(host, key=lambda t: -t[1])[:top]]


def _device_split(prof, reps):
    """Device microseconds per repetition by kernel group and by kernel,
    from a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    groups, kernels_us = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        us = e.self_device_time_total / reps
        kernels_us[e.key] = kernels_us.get(e.key, 0.0) + us
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:10]
    return groups, [[k[:80], v] for k, v in top]


def phase_profile(model, smi, reps=3, phase="profile", eager=False):
    """Where a served batch's time goes: host-clock ms of one batch per
    bucket (``ServedModel.run``, which waits for the answer), then a
    ``torch.profiler`` window over ``reps`` bucket-32 batches: device
    time by kernel group and the device's busy share of the window. By
    default the buckets replay their graphs; ``eager`` runs them op by op
    (the compile service off). ``kernel_groups_seen`` says which groups
    the profiler saw (inside a replay, the graph's kernels)."""
    if eager:
        return _eager(phase_profile, model, smi, reps, phase)
    from torch.profiler import ProfilerActivity, profile

    bucket_ms = {}
    for b in model.buckets:
        x = model.host_batch(b)
        model.run(x)
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run(x)
        bucket_ms[b] = (time.perf_counter() - t0) * 1e3 / reps
    x = model.host_batch(model.max_bucket)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run(x)
        window_ms = (time.perf_counter() - t0) * 1e3
    groups, top = _device_split(prof, reps)
    device_ms = sum(groups.values()) / 1e3
    out = {"captured": compile_service.enabled(),
           "bucket_ms": bucket_ms, "bucket": model.max_bucket,
           "window_ms_per_batch": window_ms / reps,
           "device_ms_per_batch": device_ms if groups else "not measured",
           "device_busy_share": device_ms * reps / window_ms
           if groups else "not measured",
           "device_us_by_group": groups, "top_kernels_us": top,
           "kernel_groups_seen": sorted(groups),
           "top_host_ops_us_calls": _host_split(prof, reps)}
    emit({"phase": phase, "card": smi, "model": model.name, **out})
    return out


def _bound_ms(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bounds(q, k, causal):
    """Least time of the dq kernel, the dkv kernel and the whole backward:
    each input read once and each output written once over HBM, or the
    multiply-adds over the unmasked score pairs at the float32 rate (dq:
    recompute S, dP, dS k = 6 FLOP per pair and head-dim column; dkv: S,
    dP, P^T dO, dS^T q = 8; the whole backward done once: 10). ``tc``: the
    same operations of the two kernels at the tensor cores' float32-accurate
    rate (their 3xTF32 split), against the same bytes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    e = q.element_size()
    rows_q, rows_k = b * h * sq * d, b * h * sk * d
    stats = b * h * sq * 4                  # lse, D: float32 per q row
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    fl = b * h * pairs * d
    dq_bytes = (4 * rows_q + 2 * rows_k) * e + 2 * stats
    dkv_bytes = (2 * rows_q + 4 * rows_k) * e + 2 * stats
    return {
        "dq": _bound_ms(dq_bytes, 6 * fl, H100_F32_FLOPS),
        "dkv": _bound_ms(dkv_bytes, 8 * fl, H100_F32_FLOPS),
        "whole": _bound_ms((4 * rows_q + 4 * rows_k) * e, 10 * fl,
                           H100_F32_FLOPS),
        "dq_tc": _bound_ms(dq_bytes, 6 * fl, H100_3XTF32_FLOPS),
        "dkv_tc": _bound_ms(dkv_bytes, 8 * fl, H100_3XTF32_FLOPS)}


def _bwd_once(q, k, v, do, scale, causal):
    """The forward, then both backward kernels, as the autograd function
    calls them; returns (dq, dk, dv), the paths the two launches took and
    the inputs they copied."""
    fns = (flash.flash_backward_dq, flash.flash_backward_dkv)
    before = [(dict(f.launches_by_path), f.copies) for f in fns]
    o, lse = flash.flash_forward(q, k, v, scale, causal, with_lse=True)
    dq, dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale, causal)
    dk, dv = flash.flash_backward_dkv(q, k, v, lse, dsum, do, scale, causal)
    torch.cuda.synchronize()
    took = [[p for p, n in f.launches_by_path.items() if n != b[p]]
            for f, (b, _) in zip(fns, before)]
    copied = [f.copies - c for f, (_, c) in zip(fns, before)]
    return (dq, dk, dv), o, took, copied


def _same_order(g, t, copied):
    """Whether gradient ``g`` lies in memory as ``t`` does (dims ordered by
    stride alike), or, only where the wrapper ``copied`` ``t``, is
    contiguous as the copy is."""
    def order(x):
        return sorted(range(4), key=lambda i: (-x.stride(i), i))
    return order(g) == order(t) or (copied and g.is_contiguous())


def phase_flash_bwd():
    """The backward kernels against the dense float32 recompute
    (``flash_backward_plain``) on every ``FLASH_CASES`` entry and layout
    (dO in q's layout), each launch on the path its head dim takes, with
    the expected input copies, gradients in their inputs' memory order and
    a second call bit-equal to the first; then timings at the training
    shape (32, 12, 128, 64) float32."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    train_err = None
    for shape, dtype, causal, layout in FLASH_CASES:
        b, h, sq, sk, d = shape
        q, k, v = flash_inputs(shape, dtype, layout, gen, dev)
        do = flash_inputs((b, h, sq, sq, d), dtype,
                          "bshd" if layout == "bshd" else "dense", gen, dev)[0]
        scale = 1.0 / math.sqrt(d)
        grads, o, took, copied = _bwd_once(q, k, v, do, scale, causal)
        path = _flash_path(d)
        want_copies = int(layout == "unaligned")
        if took != [[path], [path]] or copied != [want_copies] * 2:
            raise AssertionError(
                f"flash backward at {shape} {layout}: took {took}, copied "
                f"{copied}; expected {path} and {want_copies} each")
        # the unaligned layout's q is the one input the wrappers copy
        for g, t, was_copied in zip(grads, (q, k, v),
                                    (layout == "unaligned", False, False)):
            if g.shape != t.shape or g.dtype != dtype or \
                    not _same_order(g, t, was_copied):
                raise AssertionError(
                    f"flash backward at {shape} {layout}: gradient "
                    f"{tuple(g.shape)} {g.dtype} strides {g.stride()} not in "
                    f"its input's order {t.stride()}")
        again = _bwd_once(q, k, v, do, scale, causal)[0]
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"flash backward at {shape} {layout}: two "
                                 "calls differ (it must be deterministic)")
        want = flash.flash_backward_plain(q, k, v, o, do, scale, causal)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            errs[name] = (g.float() - w.float()).abs().max().item()
            if not torch.allclose(g.float(), w.float(), rtol=tol, atol=tol):
                raise AssertionError(
                    f"flash backward {name} disagrees with the plain version "
                    f"at {shape} {dtype} causal={causal} {layout}: max abs "
                    f"err {errs[name]}")
        emit({"phase": "flash_bwd", "shape": list(shape),
              "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "layout": layout, "path": path, "copies": copied,
              "deterministic": True, "max_abs_err": errs, "rtol_atol": tol,
              "ok": True})
        if shape == (32, 12, 128, 128, 64) and dtype == torch.float32 and \
                not causal and layout == "dense":
            train_err = errs

    shape = (32, 12, 128, 128, 64)
    q, k, v = flash_inputs(shape, torch.float32, "dense", gen, dev)
    do = flash_inputs(shape, torch.float32, "dense", gen, dev)[0]
    qs, ks, vs = flash_inputs(shape, torch.float32, "bshd", gen, dev)
    dos = flash_inputs(shape, torch.float32, "bshd", gen, dev)[0]
    scale = 0.125
    o, lse = flash.flash_forward(q, k, v, scale, False, with_lse=True)
    dq, dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale)
    os_, lses = flash.flash_forward(qs, ks, vs, scale, False, with_lse=True)
    dsums = flash.flash_backward_dq(qs, ks, vs, os_, lses, dos, scale)[1]

    def run_dq():
        flash.flash_backward_dq(q, k, v, o, lse, do, scale)

    def run_dkv():
        flash.flash_backward_dkv(q, k, v, lse, dsum, do, scale)

    def run_bshd():
        flash.flash_backward_dq(qs, ks, vs, os_, lses, dos, scale)
        flash.flash_backward_dkv(qs, ks, vs, lses, dsums, dos, scale)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           scale=scale)

    def run_library():
        torch.autograd.grad(out, leaves, do, retain_graph=True)

    ms = {"dq": cuda_ms(run_dq), "dkv": cuda_ms(run_dkv),
          "bshd": cuda_ms(run_bshd),
          "dq_plain": cuda_ms(lambda: flash.flash_backward_dq_plain(
              q, k, v, o, lse, do, scale, False)),
          "dkv_plain": cuda_ms(lambda: flash.flash_backward_dkv_plain(
              q, k, v, lse, dsum, do, scale, False)),
          "library": cuda_ms(run_library)}
    lib_kernels = kernel_device_us(run_library)
    device = {"dq": device_ms(run_dq), "dkv": device_ms(run_dkv),
              "bshd": device_ms(run_bshd),
              "library": sum(lib_kernels.values()) / 1e3}
    bounds = flash_bwd_bounds(q, k, False)
    timing = {"shape": list(shape), "dtype": "float32", "causal": False,
              "ms": ms, "device_ms": device,
              "library_kernels_us": lib_kernels,
              "bound_ms": {n: b[0] for n, b in bounds.items()},
              "bound_by": {n: b[1] for n, b in bounds.items()},
              "blocks_per_sm": {str(d): flash.backward_blocks_per_sm(d)
                                for d in (64, 128, 256, 512)},
              "max_abs_err": {"dq": train_err["dq"],
                              "dkv": max(train_err["dk"], train_err["dv"])}}
    timing["lm_shape"] = _flash_bwd_lm_timing(gen, dev)
    emit({"phase": "flash_bwd_timing", **timing,
          "library": "scaled_dot_product_attention backward (dq, dk, dv "
                     "together) under autograd; device_ms['library'] sums "
                     "its own kernels (library_kernels_us)"})
    return timing


def _opt_inputs(shapes, gen, dev):
    """Random float32 weights, gradients and Adam/momentum state."""
    def rand(s, scale):
        return torch.randn(s, generator=gen, device=dev) * scale

    return {"w": [rand(s, 0.05) for s in shapes],
            "g": [rand(s, 0.01) for s in shapes],
            "m": [rand(s, 1e-3) for s in shapes],
            "v": [rand(s, 1e-3).square() for s in shapes]}


def _run_opt(family, fn, state, lr, wds, hyper, skip=None):
    if family == "opt_sgd":
        fn(state["w"], state["g"], state["m"], lr, wds, skip=skip, **hyper)
    else:
        fn(state["w"], state["g"], state["m"], state["v"], lr, wds,
           skip=skip, **hyper)


def _clone(state):
    return {k: [t.clone() for t in ts] for k, ts in state.items()}


def _misaligned(state, family, mixed):
    """``state`` with operands moved 4 bytes off their 16-byte alignment:
    every operand (``mixed`` False), or only operand ``(i // 2) % k`` of
    every odd tensor ``i`` (k operands), so that one list holds aligned
    tensors and tensors with one misaligned operand among aligned ones.
    Returns the state and the tensors that must take the scalar path."""
    keys = ["w", "g", "m"] + (["v"] if family == "opt_adam" else [])
    out = {k: list(ts) for k, ts in state.items()}
    scalar = 0
    for i in range(len(state["w"])):
        moved = keys if not mixed else \
            [keys[(i // 2) % len(keys)]] if i % 2 else []
        for k in moved:
            out[k][i] = _unaligned(out[k][i])
        scalar += bool(moved)
    return out, scalar


def _opt_paths(fn, before):
    return {path: n - before[path]
            for path, n in fn.tensors_by_path.items()}


class _plain_route:
    """Within the block, ``kernels.dispatch`` sends ``family`` to its
    plain version on the card too: the same caller's path, run by the
    version the kernel is held to."""

    def __init__(self, family):
        self.entry = kernels.entry(family)

    def __enter__(self):
        self.kernel = self.entry.kernel
        self.entry.kernel = self.entry.plain

    def __exit__(self, *exc):
        self.entry.kernel = self.kernel


def _opt_lr_groups(family, shapes, gen, dev, steps=3):
    """``Optimizer.fused_update_multi`` (the ``gluon.Trainer`` and
    ``Updater`` path) with two learning-rate groups (lr_mult 0.5 on every
    other tensor) for ``steps`` steps, through the kernel and through the
    plain version on copies of the same inputs. Fails unless every update
    launched the kernel twice and only the first built tables. Returns
    the inputs, both results and the kernel's launches, tables built and
    tensors by path."""
    name = "sgd" if family == "opt_sgd" else "adam"
    params = {"learning_rate": 1e-3, "wd": 1e-4}
    if name == "sgd":
        params["momentum"] = 0.9
    base = _opt_inputs(shapes, gen, dev)
    n = len(shapes)
    fn, tables = kernels.entry(family).kernel, opt_step._TABLES[family]
    out = {}
    for route in ("kernel", "plain"):
        state = _clone(base)
        opt = mx.optimizer.create(name, **params)
        opt.set_lr_mult({i: 0.5 for i in range(1, n, 2)})
        nd = mx.nd.NDArray
        weights = [nd(t) for t in state["w"]]
        grads = [nd(t) for t in state["g"]]
        states = [nd(m) for m in state["m"]] if name == "sgd" else \
            [(nd(m), nd(v)) for m, v in zip(state["m"], state["v"])]
        builds, launches = [tables.builds], [fn.launches]
        paths = dict(fn.tensors_by_path)
        with _plain_route(family) if route == "plain" else \
                contextlib.nullcontext():
            for _ in range(steps):
                opt.fused_update_multi(list(range(n)), weights, grads,
                                       states)
                builds.append(tables.builds)
                launches.append(fn.launches)
        out[route] = state
        if route == "kernel":
            per_update = np.diff(launches).tolist()
            if per_update != [2] * steps or builds[1] - builds[0] > 2 or \
                    builds[-1] != builds[1]:
                raise AssertionError(f"{family} lr groups: launches per "
                                     f"update {per_update}, tables built "
                                     f"{np.diff(builds).tolist()}")
            report = {"launches": launches[-1] - launches[0],
                      "tables_built": builds[-1] - builds[0],
                      "tensors_by_path": _opt_paths(fn, paths)}
    return base, out["kernel"], out["plain"], report


def _host_us(fn, iters=50, warmup=3):
    """Median host microseconds of one ``fn()`` call, each started on an
    idle card (after ``torch.cuda.synchronize()``): the host's work
    alone, the kernels' time excluded."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def opt_timing(plain=True):
    """K1 and K2 over the classifier's 197 tensors (109 M float32
    parameters) beside ``torch.optim``'s fused SGD and Adam over the same
    tensors: by CUDA events over back-to-back calls (``ms``), by the
    profiler's kernel time (``device_ms``) and by the host's time per call
    (``host_us``); the byte bound; the plain version by events
    (``plain``). Uses only the families' public wrappers, so that
    another tree's package can be timed with it (``tools/opt_abba.py``).
    """
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    names = list(classifier_shapes(BERT_BASE))
    full = [classifier_shapes(BERT_BASE)[n] for n in names]
    wds = [1e-4 if n.endswith(("weight", "gamma")) else 0.0 for n in names]
    n = sum(math.prod(s) for s in full)
    lr = torch.tensor(1e-3, device=dev)
    state = _opt_inputs(full, gen, dev)
    params = [torch.nn.Parameter(w.clone()) for w in state["w"]]
    for p, g in zip(params, state["g"]):
        p.grad = g.clone()
    groups = [{"params": [p for p, wd in zip(params, wds) if wd],
               "weight_decay": 1e-4},
              {"params": [p for p, wd in zip(params, wds) if not wd],
               "weight_decay": 0.0}]
    library = {"opt_adam": torch.optim.Adam(groups, lr=1e-3, fused=True),
               "opt_sgd": torch.optim.SGD(groups, lr=1e-3, momentum=0.9,
                                          fused=True)}
    timing = {}
    for family, hyper, nbytes in (
            ("opt_adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             28 * n),
            ("opt_sgd", {"momentum": 0.9}, 20 * n)):
        e = kernels.entry(family)

        def kernel(e=e, family=family, hyper=hyper):
            _run_opt(family, e.kernel, state, lr, wds, hyper)

        step = library[family].step
        t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
             "host_us": _host_us(kernel),
             "bound_ms": nbytes / H100_BYTES_S * 1e3, "bound_by": "bytes",
             "library_ms": cuda_ms(step), "library_device_ms":
             device_ms(step), "library_host_us": _host_us(step)}
        if plain:
            t["plain_ms"] = cuda_ms(
                lambda: _run_opt(family, e.plain, state, lr, wds, hyper),
                iters=5)
        timing[family] = t
    timing["params"], timing["tensors"] = n, len(full)
    return timing


def phase_opt():
    """The fused optimizer kernels bit for bit against their plain
    versions, each case on the path its alignment gives, then one timed
    multi-tensor step over the classifier's 109 M parameters beside
    ``torch.optim``'s fused step."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    names = list(classifier_shapes(BERT_BASE))
    full = [classifier_shapes(BERT_BASE)[n] for n in names]
    wds_full = [1e-4 if n.endswith(("weight", "gamma")) else 0.0
                for n in names]
    odd = [(1,), (127,), (129,), (16383,), (16385,), (1000, 1001)]
    lr = torch.tensor(1e-3, device=dev)
    sgd = {"momentum": 0.9}
    adam = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    clip = {"rescale_grad": 0.5, "clip_gradient": 0.004}
    cases = [("full", full, wds_full, "opt_sgd", sgd),
             ("full", full, wds_full, "opt_adam", adam),
             ("full+clip", full, wds_full, "opt_sgd", {**sgd, **clip}),
             ("full+clip", full, wds_full, "opt_adam", {**adam, **clip}),
             ("odd", odd, [0.0] * len(odd), "opt_sgd", sgd),
             ("odd+clip+wd", odd, [1e-2] * len(odd), "opt_adam",
              {**adam, **clip}),
             ("odd+clip+wd", odd, [1e-2] * len(odd), "opt_sgd",
              {**sgd, **clip})]
    cases += [(label, odd, [1e-2] * len(odd), family, hyper)
              for label in ("unaligned", "mixed alignment")
              for family, hyper in (("opt_sgd", {**sgd, **clip}),
                                    ("opt_adam", {**adam, **clip}))]

    def check(family, label, got, want, base):
        for key in got:
            for i, (a, b) in enumerate(zip(got[key], want[key])):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{family} {label}: {key}[{i}] {tuple(a.shape)} "
                        "differs from the plain version (max abs "
                        f"{(a - b).abs().max().item()})")
        if torch.equal(got["w"][-1], base["w"][-1]):
            raise AssertionError(f"{family} {label}: nothing was updated")

    for label, shapes, wds, family, hyper in cases:
        base = _opt_inputs(shapes, gen, dev)
        misaligned = label in ("unaligned", "mixed alignment")

        def operands(state):
            """A copy of ``base`` for the kernel, misaligned as the case
            says, and the number of tensors that must take the scalar
            path."""
            if not misaligned:
                return state, 0
            return _misaligned(state, family, mixed=label != "unaligned")

        got, scalar = operands(_clone(base))
        want = _clone(base)
        e = kernels.entry(family)
        paths, copies = dict(e.kernel.tensors_by_path), e.kernel.copies
        _run_opt(family, e.kernel, got, lr, wds, hyper)
        _run_opt(family, e.plain, want, lr, wds, hyper)
        torch.cuda.synchronize()
        check(family, label, got, want, base)
        paths = _opt_paths(e.kernel, paths)
        if paths != {"vec4": len(shapes) - scalar, "scalar": scalar} or \
                e.kernel.copies != copies:
            raise AssertionError(f"{family} {label}: tensors by path "
                                 f"{paths}, {scalar} expected scalar; "
                                 f"{e.kernel.copies - copies} copies")
        skipped, _ = operands(_clone(base))
        _run_opt(family, e.kernel, skipped, lr, wds, hyper,
                 skip=torch.ones((), device=dev))
        if not all(torch.equal(a, b) for k in base
                   for a, b in zip(skipped[k], base[k])):
            raise AssertionError(f"{family} {label}: skip flag ignored")
        emit({"phase": "opt", "family": family, "case": label,
              "tensors": len(shapes),
              "elements": sum(math.prod(s) for s in shapes),
              "hyper": hyper, "tensors_by_path": paths,
              "bitwise_equal": True, "skip_honoured": True})
    for family in ("opt_sgd", "opt_adam"):
        base, got, want, report = _opt_lr_groups(family, full, gen, dev)
        torch.cuda.synchronize()
        check(family, "two lr groups", got, want, base)
        emit({"phase": "opt", "family": family, "case": "two lr groups",
              "path": "Optimizer.fused_update_multi, lr_mult 0.5 on every "
                      "other tensor, 3 updates", "tensors": len(full),
              **report, "bitwise_equal": True})

    timing = opt_timing()
    emit({"phase": "opt_timing", **timing,
          "library": "torch.optim.Adam/SGD(fused=True) over the same "
                     "tensors; yardsticks only: Adam applies eps after "
                     "un-biasing sqrt(v) (MXNet folds the bias correction "
                     "into lr), SGD accumulates momentum on the gradient "
                     "before lr (MXNet on lr * gradient), and neither "
                     "clips"})
    return timing


def _classifier_on(ctx, cfg, weights):
    with ctx:
        clf = build_classifier(mx, cfg)
        clf.initialize(mx.init.Zero())
        load_jax_params(clf, weights)
    return clf


def phase_train_check():
    """One "adam" and one "sgd" (momentum) step of the classifier at
    BERT-base width with 2 layers, batch 4, on the card and on a CPU copy
    from the same weights. Returns the launch counts of the sgd step."""
    cfg = dict(BERT_BASE, layers=2)
    weights = random_params(cfg, seed=0)
    x, y = make_task(4, cfg["seq_len"], cfg["vocab"], cfg["num_classes"],
                     seed=7)
    runs = {}
    for opt, params in (("adam", {"learning_rate": 1e-4, "wd": 1e-4}),
                        ("sgd", {"learning_rate": 0.01, "momentum": 0.9,
                                 "wd": 1e-4})):
        losses, nets, counts = {}, {}, None
        for where in ("card", "cpu"):
            ctx = mx.gpu(0) if where == "card" else mx.cpu()
            clf = _classifier_on(ctx, cfg, weights)
            with ctx:
                st = ShardedTrainer(clf,
                                    mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                    opt, dict(params),
                                    mesh=DeviceMesh({"dp": 1}))
                kernels.reset_launch_counts()
                losses[where] = st.step(mx.nd.array(x),
                                        mx.nd.array(y)).asscalar()
                if where == "card":
                    counts = kernels.launch_counts()
            nets[where] = export_params(clf)
        layers = cfg["layers"]
        want_counts = dict.fromkeys(counts, 0)
        want_counts.update({"flash_attention": layers,
                            "flash_attention.mma": layers,
                            "flash_attention_bwd_dq": layers,
                            "flash_attention_bwd_dq.mma": layers,
                            "flash_attention_bwd_dkv": layers,
                            "flash_attention_bwd_dkv.mma": layers,
                            "opt_adam": int(opt == "adam"),
                            "opt_sgd": int(opt == "sgd")})
        if counts != want_counts:
            raise AssertionError(f"train_check {opt}: launches {counts}, "
                                 f"expected {want_counts}")
        np.testing.assert_allclose(losses["card"], losses["cpu"],
                                   rtol=STEP_LOSS_RTOL)
        lr = params["learning_rate"]
        worst, noisy = 0.0, 0
        for name, want in nets["cpu"].items():
            diff = np.abs(nets["card"][name] - want)
            over = int((diff > STEP_PARAM_RTOL * np.abs(want) +
                        STEP_PARAM_LR_FRAC * lr).sum())
            allowed = 0
            if opt == "adam":
                allowed = want.size if name.endswith("attn.key.bias") else \
                    int(ADAM_NOISE_SHARE * want.size)
            worst = max(worst, float(diff.max()) / lr)
            noisy += over
            if over > allowed or diff.max() > 2 * lr + STEP_PARAM_RTOL * \
                    np.abs(want).max():
                raise AssertionError(
                    f"train_check {opt} {name}: {over} elements beyond the "
                    f"bound (allowed {allowed}), max diff {diff.max()}")
        runs[opt] = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
                     "max_param_diff_over_lr": worst,
                     "elements_beyond_bound": noisy, "launches": counts}
    emit({"phase": "train_check", "config": cfg, "batch": 4,
          "loss_rtol": STEP_LOSS_RTOL, "param_rtol": STEP_PARAM_RTOL,
          "param_atol_over_lr": STEP_PARAM_LR_FRAC,
          "adam_noise_share": ADAM_NOISE_SHARE, **runs})
    return runs["sgd"]["launches"]


def phase_train(smi):
    """The fine-tune at full size: 20 "adam" steps on one fixed batch of
    32, then ``predict``; one more step under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    cfg, tr = BERT_BASE, TRAIN
    weights = random_params(cfg, seed=0)
    clf = _classifier_on(mx.gpu(0), cfg, weights)
    st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                        {"learning_rate": tr["lr"], "wd": tr["wd"]},
                        mesh=DeviceMesh({"dp": 1}))
    x, y = make_task(tr["batch"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    xb, yb = mx.nd.array(x), mx.nd.array(y)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    bwd_fns = (flash.flash_backward_dq, flash.flash_backward_dkv)
    copies = [f.copies for f in bwd_fns]
    adam = opt_step.opt_adam
    adam_paths, adam_copies = dict(adam.tensors_by_path), adam.copies
    losses, step_ms = [], []
    for _ in range(tr["steps"]):
        t0 = time.perf_counter()
        losses.append(st.step(xb, yb).asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    pred = st.predict(xb).asnumpy()
    # predict: a captured forward's first call (eager; the capture after
    # it launches nothing)
    predict_launches = {k: v - counts[k] for k, v in
                        kernels.launch_counts().items() if v != counts[k]}
    copies = [f.copies - c for f, c in zip(bwd_fns, copies)]
    adam_paths = _opt_paths(adam, adam_paths)
    adam_copies = adam.copies - adam_copies
    peak = torch.cuda.max_memory_allocated()
    layers, steps = cfg["layers"], tr["steps"]
    want = dict.fromkeys(counts, 0)
    # the eager first step, then a capture and 19 replays
    want.update({"flash_attention": layers * steps,
                 "flash_attention.mma": layers * steps,
                 "flash_attention_bwd_dq": layers * steps,
                 "flash_attention_bwd_dq.mma": layers * steps,
                 "flash_attention_bwd_dkv": layers * steps,
                 "flash_attention_bwd_dkv.mma": layers * steps,
                 "opt_adam": steps})
    if counts != want or copies != [0, 0]:
        raise AssertionError(f"train: launches {counts}, backward input "
                             f"copies {copies}; expected {want} and none")
    n_params = len(classifier_shapes(cfg))
    if adam_paths != {"vec4": n_params * steps, "scalar": 0} or adam_copies:
        raise AssertionError(f"train: Adam's tensors by path {adam_paths}, "
                             f"gradient copies {adam_copies}; expected all "
                             f"{n_params} a step on the 16-byte path, none "
                             "copied")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss not finite and falling: {losses}")
    if pred.shape != (tr["batch"], cfg["num_classes"]) or \
            not np.isfinite(pred).all():
        raise AssertionError(f"train: bad predictions {pred.shape}")
    if st.skipped_steps:
        raise AssertionError(f"train: {st.skipped_steps} steps skipped")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.step(xb, yb).asscalar()
        window_ms = (time.perf_counter() - t0) * 1e3
    groups, top = _device_split(prof, 1)
    device_ms = sum(groups.values()) / 1e3
    median = statistics.median(step_ms[tr["warmup"]:])
    emit({"phase": "train", "card": smi, "config": cfg, **tr,
          "losses": losses, "step_ms": step_ms, "median_step_ms": median,
          "tokens_per_s": tr["batch"] * cfg["seq_len"] / (median / 1e3),
          "memory_allocated_before": before, "max_memory_allocated": peak,
          "launches": counts, "predict_launches": predict_launches,
          "flash_bwd_input_copies": copies,
          "adam_tensors_by_path_per_step": {
              k: v / steps for k, v in adam_paths.items()},
          "adam_gradient_copies": adam_copies,
          "accuracy_on_batch": float((pred.argmax(-1) == y).mean()),
          "profiled_step_ms": window_ms,
          "device_ms_per_step": device_ms if groups else "not measured",
          "device_idle_share": 1 - device_ms / window_ms
          if groups else "not measured",
          "device_us_by_group": groups, "top_kernels_us": top,
          "flash_bwd_us": groups.get("flash_bwd", 0.0),
          "copy_us": groups.get("copy", 0.0)})
    return counts, {"st": st, "xb": xb, "yb": yb, "y": y, "weights": weights}


def _site_stats(site):
    """The compile service's statistics of ``site`` (zeros before its
    first call)."""
    return dict(compile_service.stats().get(site, {
        "hits": 0, "misses": 0, "compiles": 0, "compile_ms": 0.0,
        "captures": 0, "capture_ms": 0.0, "replays": 0}))


def _snapshot(st):
    """A copy of every tensor a trainer's step writes, and its step
    count."""
    return [t.clone() for t in st._state_tensors().values()], st._t


def _restore(st, snap):
    """Write a snapshot back in place (the step's entry stays)."""
    tensors, t = snap
    with torch.no_grad():
        for dst, src in zip(st._state_tensors().values(), tensors):
            dst.copy_(src)
    st._t = t


def _step_agreement(got, want, start, names, scales=None):
    """Per tensor, ``|got - want|`` over the L2 norm of its step (``|want
    - start|``, or ``scales[name]``): how far one run's update is from
    the other's, as a share of the update. Bit for bit where the two are
    equal."""
    shares, equal = {}, 0
    for name, g, w, s0 in zip(names, got, want, start):
        if torch.equal(g, w):
            equal += 1
            shares[name] = 0.0
            continue
        step = scales[name] if scales and name in scales else \
            float((w.float() - s0.float()).norm())
        shares[name] = float((g.float() - w.float()).norm()) / max(step,
                                                                    1e-30)
    worst = sorted(shares, key=shares.get, reverse=True)
    return {"tensors": len(shares), "bit_equal_tensors": equal,
            "bit_equal": equal == len(shares),
            "max_share": shares[worst[0]], "max_share_tensor": worst[0],
            "largest_shares": {n: shares[n] for n in worst[:6]}}


def _trainer_blocks(st, x, y, blocks, start=None, snaps=()):
    """Steps of ``st`` in blocks of ``(mode, steps)``, "captured" (the
    compile service on) or "eager" (off), each block from the snapshot
    ``start`` when given: per block the step ms (host clock to the
    loss on the host: the step's guard reads its flag, or the caller
    waits), launches, peak allocation (and the part of it the block's
    steps added), the trainer site's captures and replays, and
    ``snaps``: {step number: the state tensors after it} for each
    block's first run of its mode (whose copies then count in that
    block's peak)."""
    out, kept = [], {}
    for mode, steps in blocks:
        if start is not None:
            _restore(st, start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        site0 = _site_stats("trainer")
        prev = compile_service.set_enabled(mode == "captured")
        ms, taken, losses = [], {}, []
        try:
            for k in range(steps):
                t0 = time.perf_counter()
                losses.append(float(st.step(x, y)._data.float()))
                ms.append((time.perf_counter() - t0) * 1e3)
                if k + 1 in snaps and mode not in kept:
                    taken[k + 1] = [t.clone() for t in
                                    st._state_tensors().values()]
        finally:
            compile_service.set_enabled(prev)
        torch.cuda.synchronize()
        site = _site_stats("trainer")
        if mode not in kept:
            kept[mode] = taken
        out.append({"mode": mode, "step_ms": ms, "losses": losses,
                    "launches": {k: v for k, v in
                                 kernels.launch_counts().items() if v},
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    # the block's own peak: what its steps allocated
                    # beyond what was live when it began
                    "peak_added": torch.cuda.max_memory_allocated() - base,
                    "captures": site["captures"] - site0["captures"],
                    "capture_ms": site["capture_ms"] - site0["capture_ms"],
                    "replays": site["replays"] - site0["replays"]})
    return out, kept


def _abba_summary(blocks, warmup):
    """Median step ms per mode over its blocks (``warmup`` steps of each
    block dropped), each block's median (the spread over the pairs), and
    the captured median as a share of the eager one."""
    per = {}
    for b in blocks:
        per.setdefault(b["mode"], []).append(
            statistics.median(b["step_ms"][warmup:]))
    med = {m: statistics.median(
        [v for b in blocks if b["mode"] == m for v in b["step_ms"][warmup:]])
        for m in per}
    return {"median_step_ms": med, "block_medians_ms": per,
            "captured_over_eager": med["captured"] / med["eager"]}


def _profiled_step(st, x, y, eager):
    """One step (replayed, or eager with the service off) under
    ``torch.profiler``: its device ms by group and its busy share."""
    from torch.profiler import ProfilerActivity, profile

    prev = compile_service.set_enabled(not eager)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(st.step(x, y)._data.float())
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        compile_service.set_enabled(prev)
    groups, top = _device_split(prof, 1)
    busy = sum(groups.values()) / 1e3
    return {"window_ms": window_ms,
            "device_ms": busy if groups else "not measured",
            "busy_share": busy / window_ms if groups else "not measured",
            "device_us_by_group": groups, "top_kernels_us": top}


def phase_gluon_hybrid_train(smi, weights, xb, yb):
    """gluon_hybrid_train: ``examples/distributed_training/cifar10_dist.py
    :71-87``'s loop (``hybridize()``, ``autograd.record()``,
    ``backward()``, ``gluon.Trainer(..., "adam")``) on one card with a
    ``local`` store, over the classifier at BERT-base width from the
    train phase's weights and batch. The hybridized classifier under
    ``record()`` is the ``cachedop`` pair: its first call eager, its
    second captured, then a forward graph and a backward graph replayed
    each step; the loss and the Trainer's update stay eager. Holds each
    parameter's gradient of the first replayed step against the eager
    forward and backward from the same weights (each tensor within 1e-3
    of its L2 norm, or bit for bit), counts K3 and K3-bwd per replayed
    forward and backward, and times 20 steps of each mode in blocks of
    10, captured, eager, eager, captured."""
    cfg, g = BERT_BASE, GLUON_HYBRID
    clf = _classifier_on(mx.gpu(0), cfg, weights)
    clf.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(clf.collect_params(), "adam",
                               {"learning_rate": g["lr"], "wd": g["wd"]},
                               kvstore="local")
    batch = xb.shape[0]
    params = [(n, p) for n, p in clf._collect_params_with_structure().items()
              if p.grad_req != "null"]

    def fwd_bwd():
        with mx.autograd.record():
            out = clf(xb)
            loss = loss_fn(out, yb)
        loss.backward()
        return loss

    def step():
        loss = fwd_bwd()
        trainer.step(batch)
        return float(loss.mean().asscalar())

    def grads():
        return [p.grad()._data.clone() for _, p in params]

    site0 = _site_stats("cachedop")
    fwd_bwd()                           # the pair's eager first call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fwd_bwd()                           # captured, then replayed
    torch.cuda.synchronize()
    first_replay = {k: v for k, v in kernels.launch_counts().items() if v}
    captured = grads()
    _eager(fwd_bwd)
    eager = grads()
    site1 = _site_stats("cachedop")
    shares = {}
    top = max(float(e.norm()) for e in eager)
    for (name, _), c, e in zip(params, captured, eager):
        # the attention key biases' true gradient is zero (a bias on
        # every key shifts a whole row of scores): their norm is
        # rounding noise, so they are held to the largest gradient's
        scale = top if name.endswith("attn.key.bias") else float(e.norm())
        shares[name] = 0.0 if torch.equal(c, e) else \
            float((c - e).norm()) / max(scale, 1e-30)
    worst = max(shares, key=shares.get)
    if shares[worst] > CAPTURE_STEP_L2:
        raise AssertionError(f"gluon_hybrid_train: gradient of {worst} "
                             f"{shares[worst]} of its norm from eager's")
    layers = cfg["layers"]
    blocks = []
    per = g["steps"] // 2
    for mode in ("captured", "eager", "eager", "captured"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        c0 = _site_stats("cachedop")
        prev = compile_service.set_enabled(mode == "captured")
        ms, losses = [], []
        try:
            for _ in range(per):
                t0 = time.perf_counter()
                losses.append(step())
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            compile_service.set_enabled(prev)
        c1 = _site_stats("cachedop")
        blocks.append({"mode": mode, "step_ms": ms, "losses": losses,
                       "launches": {k: v / per for k, v in
                                    kernels.launch_counts().items() if v},
                       "replays": c1["replays"] - c0["replays"],
                       "captures": c1["captures"] - c0["captures"]})
    per_replay = blocks[0]["launches"]
    want = {"flash_attention": layers, "flash_attention.mma": layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dq.mma": layers,
            "flash_attention_bwd_dkv": layers,
            "flash_attention_bwd_dkv.mma": layers}
    if {k: per_replay.get(k) for k in want} != want or \
            blocks[0]["replays"] != 2 * per or blocks[0]["captures"] or \
            blocks[1]["replays"] or \
            site1["captures"] - site0["captures"] != 1:
        raise AssertionError(f"gluon_hybrid_train: per replayed step "
                             f"{per_replay}, blocks {blocks}")
    losses = [v for b in blocks for v in b["losses"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"gluon_hybrid_train: losses {losses}")
    out = {"phase": "gluon_hybrid_train", "card": smi,
           "source": "examples/distributed_training/cifar10_dist.py:71-87 "
                     "on one card, local store, BERT-base width",
           "config": cfg, "batch": batch, **g,
           **_abba_summary(blocks, 1),
           "abba_order": [b["mode"] for b in blocks],
           "step_ms_by_block": [b["step_ms"] for b in blocks],
           "launches_per_step_by_block": [b["launches"] for b in blocks],
           "launches_first_replayed_step": first_replay,
           "gradients_vs_eager": {
               "tensors": len(shares),
               "bit_equal_tensors": sum(v == 0.0 for v in shares.values()),
               "max_share": shares[worst], "max_share_tensor": worst,
               "tol": CAPTURE_STEP_L2},
           "losses": losses}
    emit(out)
    del clf, trainer
    torch.cuda.empty_cache()
    return out


def phase_dropout_capture(smi):
    """dropout_capture: a hybridized Dense + Dropout(0.5) block trained 5
    steps (``gluon.Trainer`` "sgd") under ``record()`` through its
    ``cachedop`` pair, twice from the same weights after
    ``mx.random.seed(11)``: each graph registers ``mx.random``'s
    generator, so every replay draws a new mask (each pair of
    consecutive masks differs), each mask drops a share within 3 sigma
    of 0.5, and the two runs draw the same 5 masks."""
    d = DROPOUT_CAPTURE
    dev = mx.gpu(0)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(d["units"], in_units=d["units"]),
                mx.gluon.nn.Dropout(d["rate"]))
    net.initialize(mx.init.Xavier(), ctx=dev,
                   generator=torch.Generator().manual_seed(0))
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(0).rand(
        d["batch"], d["units"]).astype(np.float32), ctx=dev)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.01})
    params = list(net.collect_params().values())
    start = [p.data()._data.clone() for p in params]
    site0 = _site_stats("cachedop")

    def run():
        with torch.no_grad():
            for p, w in zip(params, start):
                p.data()._data.copy_(w)
        mx.random.seed(d["seed"])
        masks = []
        for _ in range(d["steps"]):
            with mx.autograd.record():
                out = net(x)
                loss = (out * out).mean()
            loss.backward()
            trainer.step(d["batch"])
            masks.append(out._data == 0)
        torch.cuda.synchronize()
        return masks

    runs = [run(), run()]
    site = _site_stats("cachedop")
    n = runs[0][0].numel()
    sigma = math.sqrt(d["rate"] * (1 - d["rate"]) / n)
    shares = [float(m.float().mean()) for m in runs[0]]
    differ = [not torch.equal(a, b) for a, b in zip(runs[0], runs[0][1:])]
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    checks = {"masks_differ_between_replays": all(differ),
              "dropped_share_within_3_sigma": all(
                  abs(v - d["rate"]) <= 3 * sigma for v in shares),
              "seed_repeats_the_masks": all(same)}
    out = {"phase": "dropout_capture", "card": smi, **d,
           "dropped_shares": shares, "sigma": sigma,
           "consecutive_masks_differ": differ, "runs_equal_per_step": same,
           "captures": site["captures"] - site0["captures"],
           "replays": site["replays"] - site0["replays"], **checks}
    emit(out)
    if not all(checks.values()) or out["captures"] != 1:
        raise AssertionError(f"dropout_capture: {out}")
    return out


def phase_train_capture(smi, st, xb, yb, y, weights):
    """train_capture: the bert_base_sst2_finetune trainer of the train
    phase (site ``trainer``: one CUDA graph for the whole step), from one
    synchronised state (the weights and Adam's moments copied back before
    each block): four blocks of 20 steps, captured, eager
    (``compile.set_enabled(False)``), eager, captured. Holds the first
    captured block to the first eager one (20 updates each, ``_t``; each
    tensor after 3 and after 20 steps: bit for bit, else within 1e-3 of
    the update's L2 norm), launches per replayed step (K2 1, K3 12,
    K3-bwd 12 + 12), the capture's ms and graph pool bytes, the peak
    memory of each mode, and a profiled step of each mode."""
    cfg, tc = BERT_BASE, TRAIN_CAPTURE
    names = list(st._state_tensors())
    start = _snapshot(st)
    steps, bit = tc["steps"], tc["bit_steps"]
    st._step_fn.clear()      # the first captured block captures anew
    pool0 = _pool_bytes()
    blocks, kept = _trainer_blocks(
        st, xb, yb, [("captured", steps), ("eager", steps),
                     ("eager", steps), ("captured", steps)],
        start=start, snaps=(bit, steps))
    pool = _pool_bytes() - pool0
    if st._t != start[1] + steps:
        raise AssertionError(f"train_capture: _t {st._t} after {steps} "
                             f"steps from {start[1]}")
    agree = {n: _step_agreement(kept["captured"][n], kept["eager"][n],
                                start[0], names) for n in (bit, steps)}
    for n, a in agree.items():
        if a["max_share"] > CAPTURE_STEP_L2:
            raise AssertionError(f"train_capture: after {n} steps, "
                                 f"captured against eager {a}")
    layers = cfg["layers"]
    per_replay = {k: v / steps for k, v in blocks[3]["launches"].items()}
    want = {"opt_adam": 1, "flash_attention": layers,
            "flash_attention.mma": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dq.mma": layers,
            "flash_attention_bwd_dkv": layers,
            "flash_attention_bwd_dkv.mma": layers}
    if per_replay != want or blocks[3]["replays"] != steps or \
            blocks[0]["captures"] != 1 or blocks[0]["replays"] != steps - 1:
        raise AssertionError(f"train_capture: per replayed step "
                             f"{per_replay} (want {want}), blocks {blocks}")
    if blocks[1]["launches"] != blocks[0]["launches"]:
        raise AssertionError(f"train_capture: eager launches "
                             f"{blocks[1]['launches']}, captured "
                             f"{blocks[0]['launches']}")
    # the blocks without snapshots: what a step adds beyond the trainer's
    # own state, the captured one with its graph's pool
    peak = {"captured_added": blocks[3]["peak_added"],
            "captured_with_pool": blocks[3]["peak_added"] + pool,
            "eager_added": blocks[2]["peak_added"],
            "max_memory_allocated": {b["mode"] + str(i): b[
                "max_memory_allocated"] for i, b in enumerate(blocks)}}
    prof = {"captured": _profiled_step(st, xb, yb, eager=False),
            "eager": _profiled_step(st, xb, yb, eager=True)}
    pred = st.predict(xb).asnumpy()
    if not np.isfinite(pred).all():
        raise AssertionError("train_capture: predictions not finite")
    out = {"phase": "train_capture", "card": smi,
           "config": "bert_base_sst2_finetune", **tc,
           **_abba_summary(blocks, tc["warmup"]),
           "abba_order": [b["mode"] for b in blocks],
           "step_ms_by_block": [b["step_ms"] for b in blocks],
           "capture_ms": blocks[0]["capture_ms"],
           "graph_pool_bytes": pool,
           "launches_per_replayed_step": per_replay,
           "updates_captured": steps, "t_after": st._t,
           "captured_vs_eager": agree, "step_l2_tol": CAPTURE_STEP_L2,
           "peak_memory": peak,
           "peak_captured_over_eager": peak["captured_with_pool"]
           / peak["eager_added"],
           "profiled_step": prof,
           "accuracy_on_batch": float((pred.argmax(-1) == y).mean())}
    emit(out)
    return out


# (M, K, N) of every int8 product of a bucket-32 int8 batch at BERT-base
# width (seq 128, so M = 4096 tokens): per layer q, k, v, proj, ffn1,
# ffn2; then the pooler and the head on the 32 first tokens
INT8_LAYER_SHAPES = [(4096, 768, 768)] * 4 + [(4096, 768, 3072),
                                                (4096, 3072, 768)]
INT8_HEAD_SHAPES = [(32, 768, 768), (32, 768, 2)]
INT8_RAGGED = [(m, k, n) for m in (1, 17, 129) for k in (1, 5, 130)
               for n in (1, 3, 129)]
# the edges of the kernel's 128-row, 64- or 128-column and 64-byte k tiles
INT8_TILE_EDGES = [(127, 64, 129), (4095, 784, 768), (256, 3072, 3072),
                   (128, 16, 128), (128, 48, 8)]
# (M, K, N) and which operand lies at a 1-byte offset in its buffer
INT8_UNALIGNED = [((4096, 768, 768), "qx"), ((127, 64, 129), "weight")]
INT8_LAUNCHES = len(INT8_LAYER_SHAPES) * BERT_BASE["layers"] + \
    len(INT8_HEAD_SHAPES)   # 74 per served batch


def int8_bound(m, k, n):
    """Least time of one int8_gemm launch: qx, weight, scale and bias
    read once, the float32 output written once, or 2*M*N*K operations at
    the int8 tensor-core peak."""
    nbytes = m * k + n * k + 8 * n + 4 * m * n
    return _bound_ms(nbytes, 2 * m * n * k, H100_INT8_OPS)


def _int8_inputs(m, k, n, gen, dev, per_channel=True, bias=True, big=False):
    """Random int8 operands, float32 scales in [1e-5, 1e-3] and biases.
    ``big``: rows of +-127 so that |acc| passes 2**24 and its conversion
    to float32 rounds."""
    if big:
        qx = torch.full((m, k), 127, dtype=torch.int8, device=dev)
        w = torch.full((n, k), 127, dtype=torch.int8, device=dev)
        for i in range(m):
            qx[i, :i] = 126
        for j in range(n):
            w[j, :j] = -127
    else:
        qx = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
    scale = torch.rand(n if per_channel else 1, generator=gen, device=dev) \
        * 1e-3 + 1e-5
    b = torch.randn(n, generator=gen, device=dev) if bias else None
    return qx, w, scale, b


def _int_mm_epilogue(qx, w, scale, bias):
    """The library yardstick: cuBLAS's int8 GEMM (``torch._int_mm``, which
    takes N a multiple of 8: the weight is zero-padded to it) and the
    same epilogue in PyTorch. Timed only, never on the port's path."""
    n = w.shape[0]
    wp = w if n % 8 == 0 else torch.nn.functional.pad(w, (0, 0, 0, -n % 8))
    acc = torch._int_mm(qx, wp.t())[:, :n]
    return acc.to(torch.float32) * scale + bias


def _unaligned(t):
    """A copy of ``t`` that starts one element into its buffer: 1 byte
    off for int8, 4 bytes off the 16-byte alignment for float32."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_int8_gemm():
    """K4 against its plain version with ``torch.equal`` on the int8
    batch's shapes, on ragged and tile-edge shapes and on unaligned
    operands, with and without bias and relu, per-channel and scalar
    scales, and large |acc|; each case at both output tile widths, and
    each on the path it must take (cp.async or staged). Then, at each
    distinct shape of the path, CUDA-event times of the kernel, the
    plain version and ``torch._int_mm`` + epilogue, device times
    (``device_ms``) of the kernel and the yardstick, and both tile
    widths' times at the layer shapes, in the order 64, 128, 128, 64."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    e = kernels.entry("int8_gemm")
    opts3 = [{"bias": bias, "relu": relu, "per_channel": pc}
             for bias, relu, pc in ((True, False, True), (False, True, False),
                                    (True, True, True))]
    cases = [(shape, {}) for shape in sorted(set(INT8_LAYER_SHAPES))
             + INT8_HEAD_SHAPES]
    cases += [(shape, o) for shape in INT8_RAGGED + INT8_TILE_EDGES
              for o in opts3]
    cases += [(shape, dict(o, unaligned=which))
              for shape, which in INT8_UNALIGNED for o in opts3]
    cases += [((129, 3072, 65), {"big": True}),
              ((64, 3072, 64), {"big": True, "relu": True})]
    by_path = {"async": 0, "staged": 0}
    for (m, k, n), opts in cases:
        relu = opts.get("relu", False)
        qx, w, scale, b = _int8_inputs(m, k, n, gen, dev,
                                       opts.get("per_channel", True),
                                       opts.get("bias", True),
                                       opts.get("big", False))
        if opts.get("unaligned") == "qx":
            qx = _unaligned(qx)
        elif opts.get("unaligned") == "weight":
            w = _unaligned(w)
        path = "async" if k % 16 == 0 and "unaligned" not in opts \
            else "staged"
        want = e.plain(qx, w, scale, bias=b, relu=relu)
        for tile_n in (64, 128):
            before = dict(e.kernel.launches_by_path)
            got = e.kernel(qx, w, scale, bias=b, relu=relu, tile_n=tile_n)
            torch.cuda.synchronize()
            if e.kernel.launches_by_path[path] != before[path] + 1:
                raise AssertionError(f"int8_gemm at {(m, k, n)} {opts} did "
                                     f"not take the {path} path")
            if not torch.equal(got, want):
                raise AssertionError(
                    f"int8_gemm ({path}, tile 128 x {tile_n}) differs from "
                    f"the plain version at {(m, k, n)} {opts}: max abs "
                    f"{(got - want).abs().max().item()}")
            by_path[path] += 1
    emit({"phase": "int8_gemm", "cases": len(cases),
          "launches_checked": by_path, "bitwise_equal": True,
          "shapes": sorted({(m, k, n) for (m, k, n), _ in cases})})

    per_shape = {}
    for m, k, n in sorted(set(INT8_LAYER_SHAPES)) + INT8_HEAD_SHAPES:
        qx, w, scale, b = _int8_inputs(m, k, n, gen, dev)
        bound, bound_by = int8_bound(m, k, n)
        # ms, plain_ms and library_ms by CUDA events over back-to-back
        # calls, as every kernel of this script is timed; where a call's
        # host work outlasts its kernels they time the host, so the
        # profiler's sums of kernel time are reported beside them
        per_shape[(m, k, n)] = {
            "ms": cuda_ms(lambda: e.kernel(qx, w, scale, bias=b)),
            "device_ms": device_ms(lambda: e.kernel(qx, w, scale, bias=b)),
            "plain_ms": cuda_ms(lambda: e.plain(qx, w, scale, bias=b)),
            "library_ms": cuda_ms(lambda: _int_mm_epilogue(qx, w, scale, b)),
            "library_device_ms": device_ms(
                lambda: _int_mm_epilogue(qx, w, scale, b)),
            "bound_ms": bound, "bound_by": bound_by}
        extra = {"config": int8_gemm.tile_config(m, n)}
        if (m, k, n) in INT8_LAYER_SHAPES:
            # both tile widths in turns; pick_tile is held to these
            by_tile = {"128x64": [], "128x128": []}
            ev_tile = {"128x64": [], "128x128": []}
            for t in (64, 128, 128, 64):
                by_tile[f"128x{t}"].append(device_ms(
                    lambda: e.kernel(qx, w, scale, bias=b, tile_n=t)))
                ev_tile[f"128x{t}"].append(cuda_ms(
                    lambda: e.kernel(qx, w, scale, bias=b, tile_n=t)))
            extra["device_ms_by_tile"] = by_tile
            extra["ms_by_tile"] = ev_tile
            extra["blocks_per_sm_by_tile"] = {
                f"128x{t}": int8_gemm.tile_config(m, n, t)["blocks_per_sm"]
                for t in (64, 128)}
        ops = 2 * m * n * k
        t = per_shape[(m, k, n)]
        emit({"phase": "int8_gemm_timing", "shape_mkn": [m, k, n], **t,
              **extra, "kernel_tops": ops / t["device_ms"] / 1e9,
              "library_tops": ops / t["library_device_ms"] / 1e9})
    # one bucket-32 batch: 12 layers of the six products, pooler and head
    launches = [s for s in INT8_LAYER_SHAPES
                for _ in range(BERT_BASE["layers"])] + INT8_HEAD_SHAPES
    batch = {key: sum(per_shape[s][key] for s in launches)
             for key in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_device_ms", "bound_ms")}
    t_ops = sum(2 * m * n * k for m, k, n in launches) / H100_INT8_OPS
    t_bytes = sum(m * k + n * k + 8 * n + 4 * m * n
                  for m, k, n in launches) / H100_BYTES_S
    batch["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    emit({"phase": "int8_gemm_batch", "launches": len(launches), **batch,
          "ms_over_bound": batch["ms"] / batch["bound_ms"],
          "ms_over_library": batch["ms"] / batch["library_ms"],
          "device_ms_over_bound": batch["device_ms"] / batch["bound_ms"],
          "library": "torch._int_mm (cuBLAS int8, N padded to 8) + the "
                     "same epilogue in PyTorch; a yardstick only"})
    return batch


def _quantized_classifier(cfg, weights, calib_x, workdir):
    """``quantize_net``'s steps on the current context: export the
    float classifier, load the pair, ``quantize_model`` (naive
    calibration, channel-wise), ``save_checkpoint`` the int8 pair.
    Returns the float block, the int8 prefix and the int8 graph."""
    from mxnet_tpu_torch.contrib import quantization

    clf = build_classifier(mx, cfg, exportable=True)
    clf.initialize(mx.init.Zero())
    load_jax_params(clf, weights)
    clf.export(f"{workdir}/float")
    sym, args, auxs = mx.model.load_checkpoint(f"{workdir}/float", 0)
    calib = mx.io.NDArrayIter(calib_x, batch_size=32, label_name=None)
    qsym, qargs, qauxs = quantization.quantize_model(
        sym, args, auxs, data_names=("data",), calib_data=calib,
        calib_mode="naive", num_calib_examples=len(calib_x))
    mx.model.save_checkpoint(f"{workdir}/int8", 0, qsym, qargs, qauxs)
    return clf, f"{workdir}/int8", qsym, qargs


def phase_serve_int8(smi, float_serve=None):
    """bert_base_sst2_int8_serve: the classifier quantized on the card
    (calibrated on 64 rows of ``make_task`` in two batches of 32), its
    int8 checkpoint served through ``ModelContainer.add_checkpoint`` +
    ``ModelServer`` under the serve phase's traffic."""
    from mxnet_tpu_torch.contrib import quantization

    cfg = BERT_BASE
    weights = random_params(cfg, seed=0)
    calib_x, _ = make_task(64, cfg["seq_len"], cfg["vocab"],
                           cfg["num_classes"], seed=1)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as workdir:
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        clf, prefix, qsym, qargs = _quantized_classifier(cfg, weights,
                                                         calib_x, workdir)
        quant_s = time.perf_counter() - t0
        calib_counts = kernels.launch_counts()
        census = quantization.last_quantization()["ops"]
        calib = quantization.last_calibration()

        pools = _pool_bytes()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        container = serving.ModelContainer()
        model = container.add_checkpoint("bert_base_sst2_int8", prefix, 0,
                                         example_shape=(cfg["seq_len"],))
        server = serving.ModelServer(container).start()
        warm = server.warmup()
        pools = _pool_bytes() - pools
        info = server.model_info()[model.name]
        payloads = _traffic(cfg)
        answers, wall, counts, stats = _burst(server, model, payloads)
        peak = torch.cuda.max_memory_allocated()
        if not server.drain(timeout=60):
            raise RuntimeError("server did not drain")
        with mx.cpu():
            _, cpu_args, _ = mx.model.load_checkpoint(prefix, 0)
        # the float32 block and the int8 graph, same traffic, one server,
        # each captured and eager
        float_model = serving.ServedModel.from_block(
            "float32", clf, example_shape=(cfg["seq_len"],))
        paired = _paired_bursts([float_model, model], payloads)

    rows = sum(x.shape[0] for row in payloads for x in row)
    # every int8 product of every served batch on the cp.async path
    want_counts = {"int8_gemm": INT8_LAUNCHES * stats["batches"],
                   "int8_gemm.async": INT8_LAUNCHES * stats["batches"],
                   "flash_attention": cfg["layers"] * stats["batches"],
                   "flash_attention.mma": cfg["layers"] * stats["batches"]}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts or calib_counts["int8_gemm"]:
        raise AssertionError(f"serve_int8 launches {got_counts}, expected "
                             f"{want_counts}; calibration {calib_counts}")
    if census.get("_contrib_quantized_fully_connected") != INT8_LAUNCHES or \
            census.get("_contrib_quantized_embedding") != 1:
        raise AssertionError(f"quantized graph census {census}")
    if stats["weight_dtype"] != "int8" or not info["quantized"]:
        raise AssertionError(f"served weight dtype {stats['weight_dtype']}, "
                             f"{info}")

    # every answer against the int8 graph evaluated directly on the card,
    # and the float32 block on the same rows
    err_eval, agree, n_rows, gap = 0.0, 0, 0, 0.0
    float_all = []
    for row_p, row_a in zip(payloads, answers):
        for x, got in zip(row_p, row_a):
            if got.shape != (x.shape[0], cfg["num_classes"]) or \
                    not np.isfinite(got).all():
                raise AssertionError(f"bad answer {got.shape}")
            with torch.inference_mode():
                want = qsym.eval_with({"data": mx.nd.array(x)},
                                      qargs).asnumpy()
                ref = clf(mx.nd.array(x)).asnumpy()
            err_eval = max(err_eval, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, rtol=INT8_EVAL_TOL,
                                       atol=INT8_EVAL_TOL)
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            n_rows += x.shape[0]
            gap = max(gap, float(np.abs(got - ref).max()))
            float_all.append(ref)
    float_scale = float(np.abs(np.concatenate(float_all)).max())

    # a CPU copy of the int8 graph (plain int8 GEMM and attention)
    x = payloads[0][0]
    emb_max = next(n for n in cpu_args if n.endswith("weight_max"))
    nudged = dict(cpu_args)
    nudged[emb_max] = cpu_args[emb_max] * (1 + 2 ** -23)
    with mx.cpu(), torch.inference_mode():
        want = qsym.eval_with({"data": mx.nd.array(x)}, cpu_args).asnumpy()
        moved = qsym.eval_with({"data": mx.nd.array(x)}, nudged).asnumpy()
    nudge_change = float(np.abs(moved - want).max())
    got = answers[0][0]
    cpu_err = float(np.abs(got - want).max())
    tol = INT8_CPU_SHARE * float(np.abs(want).max())
    decided = np.abs(want[:, 0] - want[:, 1]) > tol
    if cpu_err > tol or not np.array_equal(
            got.argmax(-1)[decided], want.argmax(-1)[decided]):
        raise AssertionError(f"int8 card vs CPU: max abs {cpu_err} > {tol} "
                             "or an argmax differs")

    summary = _serve_summary(stats, rows, wall, peak, before)
    emit({"phase": "serve_int8", "card": smi, "config":
          "bert_base_sst2_int8_serve", "quantize_s": quant_s,
          "calibration": {"mode": calib["mode"], "examples": calib["examples"],
                          "batches": calib["batches"],
                          "tensors": len(calib["tensors"]),
                          "launches": {k: v for k, v in calib_counts.items()
                                       if v}},
          "census": census, "warmup": warm["models"][model.name],
          "capture": model.capture_stats(),
          "float32_capture": float_model.capture_stats(),
          "graph_pool_bytes": pools,
          "weight_dtype": stats["weight_dtype"], "model_info": info,
          **summary, "launches": got_counts,
          "launches_per_batch": {k: v / stats["batches"]
                                 for k, v in got_counts.items()},
          "max_abs_err_vs_eval_with": err_eval,
          "max_abs_err_vs_cpu": cpu_err, "cpu_tol": tol,
          "cpu_change_from_one_ulp_range_nudge": nudge_change,
          "cpu_rows_checked": int(x.shape[0]),
          "agreement_with_float32": agree / n_rows,
          "max_logit_gap_vs_float32": gap,
          "max_abs_float32_logit": float_scale,
          "paired_bursts": paired,
          "float32_serve": float_serve and {
              k: float_serve[k] for k in ("rows_per_s", "p50_ms", "p99_ms",
                                          "fill_ratio",
                                          "memory_allocated_before",
                                          "max_memory_allocated")}})
    return dict(summary, int8_launches=got_counts["int8_gemm"],
                paired=paired), model, float_model, clf


def _held(got, want, what):
    """A replay against the eager forward on the same inputs: bit for
    bit (the same shapes on the same card run the same kernels)."""
    if not torch.equal(got, want):
        diff = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{what}: replay differs from the eager "
                             f"forward by {diff}")
    return {"bit_equal": True}


def _launches_per_call(fn, calls=3):
    """Kernel launches of one call of ``fn`` (the mean over ``calls``)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return {k: v / calls for k, v in kernels.launch_counts().items() if v}


def _abba_ms(fns, iters=10):
    """Mean ms per call of each of ``fns`` (name -> callable), by CUDA
    events, in A B B A order (two rounds of ``iters`` calls each)."""
    times = {name: [] for name in fns}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            times[name].append(cuda_ms(fns[name], iters=iters, warmup=2))
    return {name: statistics.mean(t) for name, t in times.items()}


def phase_capture(smi, float_model, int8_model, clf):
    """The captured forwards against the same forwards run eagerly
    (``compile.set_enabled(False)``), on the same inputs: the float32 and
    int8 served models at every bucket (their graphs captured by the
    serve_int8 phase's warmups), and the classifier block hybridized and
    called directly. Bit for bit; launches per replayed batch (12 flash,
    74 int8 GEMMs); no capture after warmup under a burst; a
    ``set_data`` that captures anew in place of the old entry and
    changes the output; an in-place write the replay reads."""
    cfg = BERT_BASE
    rows, _ = make_task(32, cfg["seq_len"], cfg["vocab"], cfg["num_classes"],
                        seed=2)
    flash12 = {"flash_attention": cfg["layers"],
               "flash_attention.mma": cfg["layers"]}
    out = {"phase": "capture", "card": smi}
    for model, want in (
            (float_model, flash12),
            (int8_model,
             dict(flash12, **{"int8_gemm": INT8_LAUNCHES,
                              "int8_gemm.async": INT8_LAUNCHES}))):
        misses = compile_service.stats()["serving"]["misses"]
        held = {}
        for b in model.buckets:
            got = model.run(rows[:b])[0]
            eager = _eager(model.run, rows[:b])[0]
            held[b] = _held(torch.from_numpy(got), torch.from_numpy(eager),
                            f"{model.name} bucket {b}")
        x = model.host_batch(model.max_bucket)
        replay = _launches_per_call(lambda: model.run(x))
        eager = _launches_per_call(lambda: _eager(model.run, x))
        if replay != want or eager != want:
            raise AssertionError(f"{model.name}: launches per batch "
                                 f"{replay} replayed, {eager} eager; want "
                                 f"{want}")
        if compile_service.stats()["serving"]["misses"] != misses:
            raise AssertionError(f"{model.name}: a bucket captured anew")
        out[model.name] = {"replay_vs_eager": held,
                           "launches_per_replayed_batch": replay,
                           "capture": model.capture_stats()}

    # no capture after warmup, under a burst of each model
    server = serving.ModelServer(serving.ModelContainer(
        [float_model, int8_model])).start()
    server.warmup()
    misses = compile_service.stats()["serving"]["misses"]
    payloads = _traffic(cfg)
    for model in (float_model, int8_model):
        _, _, counts, stats = _burst(server, model, payloads)
        want = cfg["layers"] * stats["batches"]
        if counts["flash_attention"] != want:
            raise AssertionError(f"{model.name}: {counts} for "
                                 f"{stats['batches']} replayed batches")
    if not server.drain(timeout=60):
        raise RuntimeError("server did not drain")
    out["serving_misses_after_warmup_under_bursts"] = \
        compile_service.stats()["serving"]["misses"] - misses
    if out["serving_misses_after_warmup_under_bursts"]:
        raise AssertionError("a burst captured after warmup")

    # the classifier block, hybridized and called directly
    clf.hybridize()
    site0 = dict(compile_service.stats().get("cachedop", {"captures": 0}))
    block = {}
    for b in (2, 32):
        x = mx.nd.array(rows[:b])
        first, again = clf(x)._data, clf(x)._data
        eager = _eager(clf, x)._data
        block[b] = _held(first, eager, f"hybridized classifier batch {b}")
        if not torch.equal(first, again):
            raise AssertionError("two replays of one batch differ")
    x = mx.nd.array(rows)
    replay = _launches_per_call(lambda: clf(x))
    if replay != flash12:
        raise AssertionError(f"hybridized classifier: {replay} per call")
    ms = _abba_ms({"captured": lambda: clf(x),
                   "eager": lambda: _eager(clf, x)})
    st1 = dict(compile_service.stats()["cachedop"])
    y0 = clf(x)._data
    w = clf.out.weight
    w.set_data(w.data().asnumpy() * 2.0)            # a new tensor
    y1 = clf(x)._data
    st2 = dict(compile_service.stats()["cachedop"])
    rebind = _held(y1, _eager(clf, x)._data, "after set_data")
    with torch.no_grad():
        clf.pool.weight.data()._data.mul_(0.5)      # the same tensor
    y2 = clf(x)._data
    st3 = dict(compile_service.stats()["cachedop"])
    in_place = _held(y2, _eager(clf, x)._data, "after an in-place write")
    if st2["captures"] - st1["captures"] != 1 or torch.equal(y0, y1):
        raise AssertionError(f"set_data: {st1} -> {st2}")
    if st3["captures"] != st2["captures"] or torch.equal(y1, y2):
        raise AssertionError(f"in-place write: {st2} -> {st3}")
    clf.hybridize(False)
    out["hybridized_classifier"] = {
        "replay_vs_eager": block, "launches_per_call": replay,
        "ms_per_call_batch_32": ms,
        "captures": st3["captures"] - site0["captures"],
        "set_data": {"captures_added": st2["captures"] - st1["captures"],
                     **rebind},
        "in_place_write": {"captures_added": 0, "hits_added":
                           st3["hits"] - st2["hits"], **in_place}}
    out["compile_stats"] = compile_service.stats()
    emit(out)
    return out


# bert_base_sst2_online_update: bert_base_sst2_finetune's trainer (a
# fresh "adam" ShardedTrainer, batch 32, its step captured) publishes to a
# model bus every 10 steps (only the 30522 x 768 embedding rides int8 per
# row: the threshold lies between its 23,440,896 values and the FFN's
# 2,359,296) while bert_base_sst2_serve's classifier, a second block
# instance from the same RandomState(0) weights, serves HTTP traffic from
# its captured bucket ladder (ServedModel.from_block + ModelServer with the
# prediction cache, HttpFrontEnd on 127.0.0.1) and applies each version
# between batches (watch_bus, poll 0.05 s). Traffic, a smoke load chosen
# to drive each mechanism (no published trace stands behind its numbers,
# so its cache hits and per-class figures say nothing of a deployment):
# 4 http.client threads in a closed loop, requests of 1-8 rows,
# interactive:batch 4:1 with a deadline on the batch class, 30% of
# requests one of 16 hot payloads; windows A B B A (traffic alone, the
# first and second 20 steps, alone). After version 2 the next record is
# poisoned (modelbus.publish:nan@1): the watcher must quarantine it and
# the next publish roll back. Then an in-process overload burst of 200
# requests of 8 rows (4:1) past the queue bound. The cut: 40 steps on one
# fixed batch of make_task, 4 publishes.
ONLINE_UPDATE = {"batch": 32, "steps": 40, "every": 10, "lr": 1e-4,
                 "wd": 1e-4, "compress_threshold": 1 << 22, "poll": 0.05,
                 "clients": 4, "interactive_per_batch": 4, "hot": 16,
                 "hot_share": 0.3, "max_rows": 8, "deadline_ms": 100.0,
                 "poison_after": 2, "alone_s": 4.0, "checked": 4,
                 "overload_requests": 200, "overload_rows": 8,
                 "alone_steps": 10,
                 "wait_s": 120.0,
                 "reduced": "40 steps on one batch (4 publishes), not an "
                            "epoch of SST-2; 4 closed-loop clients"}


def _http_client(i, port, cfg, hot, stop, window, log):
    """One closed-loop HTTP client: requests of 1-8 rows, every
    ``interactive_per_batch + 1``-th of the batch class with a deadline,
    ``hot_share`` of them one of the hot payloads; each response logged
    (or the error that ended the thread)."""
    import http.client

    rs = np.random.RandomState(100 + i)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    path = "/v1/models/bert_base_sst2:predict"
    seq = 0
    try:
        while not stop.is_set():
            prio = "batch" if seq % (cfg["interactive_per_batch"] + 1) == \
                cfg["interactive_per_batch"] else "interactive"
            if rs.rand() < cfg["hot_share"]:
                key = int(rs.randint(len(hot)))
                x = hot[key]
            else:
                key = None
                x = rs.randint(0, BERT_BASE["vocab"], (
                    rs.randint(1, cfg["max_rows"] + 1),
                    BERT_BASE["seq_len"])).astype(np.float32)
            body = {"data": x.tolist(), "priority": prio}
            if prio == "batch":
                body["deadline_ms"] = cfg["deadline_ms"]
            win = window[0]
            t0 = time.perf_counter()
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            t1 = time.perf_counter()
            rec = {"thread": i, "seq": seq, "t0": t0, "t1": t1,
                   "window": win, "priority": prio, "rows": x.shape[0],
                   "status": resp.status, "hot": key}
            if resp.status == 200:
                rec.update(version=payload["model_version"],
                           hit=bool(payload.get("cache_hit")),
                           out=np.asarray(payload["outputs"][0],
                                          np.float32))
                if key is None:
                    rec["x"] = x
            else:
                rec.update(error=payload.get("error"),
                           dropped=bool(payload.get("dropped")))
            log.append(rec)
            seq += 1
    except Exception as e:  # reported by the phase
        log.append({"thread": i, "seq": seq, "status": "client_error",
                    "error": f"{type(e).__name__}: {e}"})
    finally:
        conn.close()


def _await(cond, what, timeout):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"online_update: {what} within {timeout} s")
        time.sleep(0.01)


class _Timed:
    """Wrap ``owner.name`` (an instance or a module attribute) so each
    call's seconds go to ``sink(seconds, result, args)`` when ``only()``
    is true (default: always); ``restore()`` puts the original back."""

    def __init__(self, owner, name, sink, only=None):
        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.had = name in vars(owner)

        def call(*args, **kw):
            t0 = time.perf_counter()
            out = self.real(*args, **kw)
            if only is None or only():
                sink(time.perf_counter() - t0, out, args)
            return out

        setattr(owner, name, call)

    def restore(self):
        if self.had:
            setattr(self.owner, self.name, self.real)
        else:
            delattr(self.owner, self.name)


def _window_stats(log, windows):
    """Per window: wall seconds, rows/s answered, and per class the
    requests, rows, deadline drops, p50 and p99 of the client-side
    latency (ms)."""
    from mxnet_tpu_torch.serving.metrics import percentile

    out = {}
    for name, (t_start, t_end) in windows.items():
        recs = [r for r in log if r.get("window") == name]
        ok = [r for r in recs if r["status"] == 200]
        by = {}
        for prio in serving.PRIORITIES:
            lat = [(r["t1"] - r["t0"]) * 1e3 for r in ok
                   if r["priority"] == prio]
            by[prio] = {"requests": sum(r["priority"] == prio
                                        for r in recs),
                        "answered": len(lat),
                        "rows": sum(r["rows"] for r in ok
                                    if r["priority"] == prio),
                        "dropped": sum(r.get("dropped", False) for r in recs
                                       if r["priority"] == prio),
                        "p50_ms": percentile(lat, 50),
                        "p99_ms": percentile(lat, 99)}
        wall = t_end - t_start
        out[name] = {"wall_s": wall,
                     "rows_per_s": sum(r["rows"] for r in ok) / wall,
                     "cache_hits": sum(r["hit"] for r in ok),
                     "by_class": by}
    return out


def _bus_work_split(log, busy):
    """p50/p99 (ms) of the B windows' answered requests that overlapped
    a publish or an apply (host clock), and of the others."""
    from mxnet_tpu_torch.serving.metrics import percentile

    out = {}
    for name, during in (("during_publish_or_apply", True),
                         ("otherwise", False)):
        lat = [(r["t1"] - r["t0"]) * 1e3 for r in log
               if r["status"] == 200 and r.get("window") in ("B1", "B2")
               and any(r["t0"] < b and r["t1"] > a for a, b in busy)
               == during]
        out[name] = {"answered": len(lat), "p50_ms": percentile(lat, 50),
                     "p99_ms": percentile(lat, 99)}
    return out


def _overload(server, cfg, rs):
    """``overload_requests`` requests of ``overload_rows`` rows submitted
    at once in process (interactive:batch 4:1, the batch class with the
    deadline): per class the rows offered, answered, dropped by deadline
    and rejected at admission, and the answered share."""
    futs, out = [], {p: {"offered_rows": 0, "answered_rows": 0,
                         "dropped": 0, "rejected": 0}
                     for p in serving.PRIORITIES}
    n_rows = cfg["overload_rows"]
    for k in range(cfg["overload_requests"]):
        prio = "batch" if k % (cfg["interactive_per_batch"] + 1) == \
            cfg["interactive_per_batch"] else "interactive"
        x = rs.randint(0, BERT_BASE["vocab"], (n_rows, BERT_BASE[
            "seq_len"])).astype(np.float32)
        out[prio]["offered_rows"] += n_rows
        try:
            futs.append((prio, server.submit(
                "bert_base_sst2", x, priority=prio,
                deadline_ms=cfg["deadline_ms"] if prio == "batch" else None)))
        except serving.DeadlineExceeded:
            out[prio]["dropped"] += 1
        except serving.ServerBusyError:
            out[prio]["rejected"] += 1
    for prio, fut in futs:
        try:
            fut.result(timeout=300)
            out[prio]["answered_rows"] += n_rows
        except serving.DeadlineExceeded:
            out[prio]["dropped"] += 1
    for st in out.values():
        st["answered_share"] = st["answered_rows"] / st["offered_rows"]
    return out


def phase_online_update(smi):
    """The cell bert_base_sst2_online_update (``ONLINE_UPDATE``'s
    comment). Fails unless every admitted request is answered (or dropped
    by its deadline: counted per class, not a failure); every response
    carries version 0 or an applied version, non-decreasing per client;
    for every applied version at least ``checked`` responses stamped with
    it (cache hits among them) equal the same rows run eagerly through a
    block loaded with ``decode_update`` of that version (SERVE_TOL); no
    serving capture or miss after warmup; K3 12 launches per served batch
    and per step, K3-bwd 12 + 12 and K2 1 per step; the poisoned version
    quarantined, never served and followed by a rollback; cache hits, none
    answered from another version; and the batch class's answered share
    under overload at most the interactive class's."""
    import shutil

    from mxnet_tpu_torch import checkpoint as _ckpt
    from mxnet_tpu_torch import faults, modelbus

    cfg, ou = BERT_BASE, ONLINE_UPDATE
    dev = mx.gpu(0)
    weights = random_params(cfg, seed=0)
    x, y = make_task(ou["batch"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    xb, yb = mx.nd.array(x), mx.nd.array(y)
    busdir = tempfile.mkdtemp(prefix="mxtt-bus-")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrapped = []
    try:
        clf_t = _classifier_on(dev, cfg, weights)
        st = ShardedTrainer(clf_t, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            "adam", {"learning_rate": ou["lr"],
                                     "wd": ou["wd"]},
                            mesh=DeviceMesh({"dp": 1}))
        bus = st.publish_to(busdir, every=ou["every"],
                            compress_threshold=ou["compress_threshold"])
        clf_s = _classifier_on(dev, cfg, weights)
        model = serving.ServedModel.from_block(
            "bert_base_sst2", clf_s, example_shape=(cfg["seq_len"],))
        del clf_s   # the model holds its own snapshot
        server = serving.ModelServer(serving.ModelContainer([model]),
                                     cache=True).start()
        warm = server.warmup()
        site0 = _site_stats("serving")
        captures0 = model.capture_stats()["captures"]
        front = serving.HttpFrontEnd(server).start()
        watcher = server.watch_bus(busdir, poll=ou["poll"])

        # measurement wrappers (the port's code is untouched): batches,
        # the watcher's applies and their parts, the publishes and theirs
        main_thread = threading.current_thread()
        batches, applies, publishes = [], {}, {}
        busy = []   # (start, end) of each publish and apply, host clock
        acc = {"apply": None, "publish": None, "d2h_s": None}

        def on_watcher():
            return threading.current_thread() is watcher._thread

        def on_main():
            return threading.current_thread() is main_thread

        def add(kind, key):
            def sink(s, out, args):
                if acc[kind] is not None:
                    acc[kind][key] = acc[kind].get(key, 0.0) + s
            return sink

        def batch_sink(s, out, args):
            t1 = time.perf_counter()
            batches.append((t1 - s, t1, out[1]))

        real_flip, real_apply, real_publish = \
            model._flip, watcher._apply, bus.publish

        def flip(staged, targets, version):
            stream = model.replay_stream
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"] \
                if stream is not None else None
            if ev:
                ev[0].record(stream)
            t0 = time.perf_counter()
            real_flip(staged, targets, version)
            acc["apply"]["flip_host_s"] = time.perf_counter() - t0
            if ev:
                ev[1].record(stream)
                acc["apply"]["flip_events"] = ev

        def apply(m):
            acc["apply"] = {}
            t0 = time.perf_counter()
            ok = real_apply(m)
            t1 = time.perf_counter()
            busy.append((t0, t1))
            applies[m["version"]] = dict(
                acc["apply"], total_s=t1 - t0, applied=bool(ok),
                step=m.get("step"), age_steps=watcher.age_steps())
            return ok

        def publish(*a, **kw):
            # the step's device-to-host copy belongs to its own record,
            # not to a rollback's re-publication before it
            acc["publish"] = {}
            if not (kw.get("meta") or {}).get("rollback_of"):
                acc["publish"]["d2h_s"] = acc["d2h_s"]
            t0 = time.perf_counter()
            version = real_publish(*a, **kw)
            t1 = time.perf_counter()
            busy.append((t0, t1))
            if version is not None:
                publishes[version] = dict(
                    acc["publish"], total_s=t1 - t0,
                    bytes=os.path.getsize(bus.payload_path(version)) +
                    os.path.getsize(bus.manifest_path(version)))
            acc["publish"] = None
            return version

        def d2h_sink(s, out, args):
            acc["d2h_s"] = s

        model._flip, watcher._apply, bus.publish = flip, apply, publish
        wrapped += [
            _Timed(model, "run_versioned", batch_sink),
            _Timed(model, "_stage_swap", add("apply", "stage_s")),
            _Timed(model, "swap_params", add("apply", "swap_s")),
            _Timed(modelbus, "decode_update", add("apply", "decode_s"),
                   on_watcher),
            _Timed(modelbus, "_is_finite", add("apply", "finite_s"),
                   on_watcher),
            _Timed(modelbus, "_encode_param", add("publish", "encode_s"),
                   on_main),
            _Timed(_ckpt, "atomic_write", add("publish", "write_s"),
                   on_main),
            _Timed(st, "_publish_host_copy", d2h_sink)]

        hot_rs = np.random.RandomState(2)
        hot = [hot_rs.randint(0, cfg["vocab"], (
            hot_rs.randint(1, ou["max_rows"] + 1), cfg["seq_len"])).astype(
                np.float32) for _ in range(ou["hot"])]
        stop, window, log = threading.Event(), ["A1"], []
        clients = [threading.Thread(
            target=_http_client, args=(i, front.port, ou, hot, stop,
                                       window, log))
            for i in range(ou["clients"])]
        trainer0 = _site_stats("trainer")
        kernels.reset_launch_counts()
        windows = {}
        t_win = time.perf_counter()
        for c in clients:
            c.start()
        time.sleep(ou["alone_s"])
        step_ms, losses, events = [], [], []
        half = ou["steps"] // 2
        for step in range(1, ou["steps"] + 1):
            if step in (1, half + 1):
                now = time.perf_counter()
                windows[window[0]] = (t_win, now)
                window[0], t_win = ("B1", now) if step == 1 else ("B2", now)
            n_pub = len(st.published_versions)
            t0 = time.perf_counter()
            losses.append(st.step(xb, yb).asscalar())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(st.published_versions) == n_pub:
                continue
            v = st.published_versions[-1]
            events.append({"step": step, "published": list(
                st.published_versions[n_pub:])})
            if step // ou["every"] == ou["poison_after"] + 1:
                faults.reset()
                _await(lambda: v in bus.quarantined(),
                       f"the poisoned version {v} quarantined",
                       ou["wait_s"])
                events[-1]["poisoned"] = v
            else:
                _await(lambda: watcher.applied_version >= v,
                       f"version {v} applied", ou["wait_s"])
            if step // ou["every"] == ou["poison_after"]:
                # in-transit poison of the next record: the watcher, not
                # the publisher's finite gate, must catch it
                faults.configure("modelbus.publish:nan@1")
        now = time.perf_counter()
        windows[window[0]] = (t_win, now)
        window[0], t_win = "A2", now
        time.sleep(ou["alone_s"])
        windows["A2"] = (t_win, time.perf_counter())
        window[0] = None
        stop.set()
        for c in clients:
            c.join(timeout=300)
            if c.is_alive():
                raise RuntimeError("an HTTP client did not finish")
        overload = _overload(server, ou, np.random.RandomState(3))
        counts = kernels.launch_counts()
        n_batches = len(batches)
        stats = server.stats()
        site1 = _site_stats("serving")
        trainer1 = _site_stats("trainer")
        peak = torch.cuda.max_memory_allocated()
        if not server.drain(timeout=120):
            raise RuntimeError("server did not drain")
        front.close()
        for w in wrapped:
            w.restore()
        wrapped = []
        del model._flip, watcher._apply, bus.publish
        torch.cuda.synchronize()
        for rec in applies.values():
            ev = rec.pop("flip_events", None)
            if ev is not None:
                rec["flip_device_ms"] = ev[0].elapsed_time(ev[1])
            if "flip_host_s" in rec:
                rec["swap_lock_wait_s"] = rec["swap_s"] - rec["stage_s"] - \
                    rec["flip_host_s"]
            # what is left of the apply: reading the payload and its CRC
            rec["read_crc_s"] = rec["total_s"] - sum(
                rec.get(k, 0.0) for k in ("decode_s", "finite_s", "swap_s"))

        # the trainer alone, publishing off, no traffic
        st._bus = None
        alone_ms = []
        for _ in range(ou["alone_steps"]):
            t0 = time.perf_counter()
            st.step(xb, yb).asscalar()
            alone_ms.append((time.perf_counter() - t0) * 1e3)

        # ---------------------------------------------------- checks --
        failures = [r for r in log if r["status"] not in (200, 504)
                    or (r["status"] == 504 and not r.get("dropped"))]
        if failures or stats["models"]["bert_base_sst2"]["failed"]:
            raise AssertionError(f"online_update: failed requests "
                                 f"{failures[:3]}")
        applied = sorted(v for v, r in applies.items() if r["applied"])
        rejected = sorted(v for v, r in applies.items() if not r["applied"])
        poisoned = [e["poisoned"] for e in events if "poisoned" in e]
        ok = [r for r in log if r["status"] == 200]
        served = {r["version"] for r in ok}
        if not served <= set(applied) | {0} or set(poisoned) & served:
            raise AssertionError(f"online_update: versions served {served}, "
                                 f"applied {applied}, poisoned {poisoned}")
        for i in range(ou["clients"]):
            seen = [r["version"] for r in sorted(
                (r for r in ok if r["thread"] == i), key=lambda r: r["seq"])]
            if seen != sorted(seen):
                raise AssertionError(f"online_update: client {i} saw "
                                     f"versions out of order: {seen}")
        if len(poisoned) != 1 or not os.path.exists(bus.reject_path(
                poisoned[0], watcher.worker)):
            raise AssertionError(f"online_update: poisoned {poisoned}, "
                                 f"rejected {rejected}")
        rollback = [m for m in bus.manifests()
                    if m["meta"].get("rollback_of") == poisoned[0]]
        if len(rollback) != 1 or rollback[0]["version"] <= poisoned[0]:
            raise AssertionError("online_update: no rollback after the "
                                 f"poisoned version {poisoned[0]}")
        if site1["captures"] != site0["captures"] or \
                site1["misses"] != site0["misses"] or \
                model.capture_stats()["captures"] != captures0:
            raise AssertionError(f"online_update: serving captured after "
                                 f"warmup: {site0} -> {site1}")
        steps = ou["steps"]
        want = dict.fromkeys(counts, 0)
        want.update({"flash_attention": cfg["layers"] * (n_batches + steps),
                     "flash_attention.mma": cfg["layers"] * (n_batches +
                                                             steps),
                     "flash_attention_bwd_dq": cfg["layers"] * steps,
                     "flash_attention_bwd_dq.mma": cfg["layers"] * steps,
                     "flash_attention_bwd_dkv": cfg["layers"] * steps,
                     "flash_attention_bwd_dkv.mma": cfg["layers"] * steps,
                     "opt_adam": steps})
        if counts != want:
            raise AssertionError(f"online_update: launches {counts} for "
                                 f"{n_batches} batches and {steps} steps; "
                                 f"want {want}")
        if trainer1["replays"] - trainer0["replays"] != steps - 1:
            raise AssertionError(f"online_update: trainer site {trainer0} "
                                 f"-> {trainer1}")
        hits = [r for r in ok if r["hit"]]
        if not hits:
            raise AssertionError("online_update: no cache hit")
        if overload["batch"]["answered_share"] > \
                overload["interactive"]["answered_share"]:
            raise AssertionError(f"online_update: overload shares "
                                 f"{overload}")

        # one batch, one version: each checked response against the same
        # rows run eagerly through a block holding that version's values,
        # and against its neighbours' values, which must lie further off
        # than SERVE_TOL by VERSION_MARGIN (else a response computed on a
        # neighbour would pass); a rollback holds its source's values
        ref = _classifier_on(dev, cfg, weights)
        ref_params = list(ref.collect_params().values())
        base = [p.data().asnumpy() for p in ref_params]
        holds = {m["version"]: m["meta"].get("source_version", m["version"])
                 for m in bus.manifests()}
        computed = {}   # (hot payload, version) -> the answers computed
        for r in ok:
            if r["hot"] is not None and not r["hit"]:
                computed.setdefault((r["hot"], r["version"]), []).append(
                    r["out"])
        seq = [0] + applied
        picks = {}
        for v in seq:
            mine = [r for r in ok if r["version"] == v]
            picks[v] = [r for r in mine if r["hit"]][:ou["checked"]] + \
                [r for r in mine if not r["hit"]][:ou["checked"]]
            if v and len(picks[v]) < ou["checked"]:
                raise AssertionError(f"online_update: {len(picks[v])} "
                                     f"responses of applied version {v}")
        max_err, min_apart = 0.0, float("inf")
        for i, u in enumerate(seq):
            vals = modelbus.decode_update(*bus.read(u))[0] if u else base
            for p, a in zip(ref_params, vals):
                p.set_data(a)
            for v in seq[max(i - 1, 0):i + 2]:
                for r in picks[v]:
                    xr = hot[r["hot"]] if r["hot"] is not None else r["x"]
                    with torch.inference_mode():
                        want_out = ref(mx.nd.array(xr)).asnumpy()
                    d = float(np.abs(r["out"] - want_out).max())
                    if holds.get(v, v) != holds.get(u, u):
                        min_apart = min(min_apart, d)
                        continue
                    max_err = max(max_err, d)
                    np.testing.assert_allclose(r["out"], want_out,
                                               rtol=SERVE_TOL, atol=SERVE_TOL)
        if not min_apart > VERSION_MARGIN * SERVE_TOL:
            raise AssertionError(
                f"online_update: a response lies {min_apart} from a "
                f"neighbouring version's output, not above "
                f"{VERSION_MARGIN} x SERVE_TOL")
        checked = {}
        for v in seq:
            mine = [r for r in ok if r["version"] == v]
            # a hit is an answer its version computed, bit for bit
            for r in mine:
                if r["hit"] and not any(np.array_equal(r["out"], c) for c in
                                        computed.get((r["hot"], v), ())):
                    raise AssertionError(
                        f"online_update: a cache hit of version {v} is no "
                        "answer that version computed")
            checked[v] = {"responses": len(mine),
                          "hits": sum(r["hit"] for r in mine),
                          "checked": len(picks[v])}

        # the largest gap between two served batches' ends (a flip's
        # lock wait falls inside the second) across a flip
        order = sorted(batches, key=lambda b: b[1])
        gaps = [(b[1] - a[1], a[2] != b[2]) for a, b in zip(order,
                                                          order[1:])]
        flip_gaps = [g for g, flipped in gaps if flipped]
        per_version = {v: {"publish": publishes.get(v),
                           "apply": applies.get(v)} for v in sorted(
                               set(publishes) | set(applies))}
        staging = model._staging
        summary = {
            "phase": "online_update", "card": smi, "config": cfg, **ou,
            "warmup": warm["models"][model.name],
            "windows": _window_stats(log, windows),
            "b_latency_by_bus_work": _bus_work_split(log, busy),
            "step_ms": step_ms, "losses": losses,
            "step_ms_median_no_publish": statistics.median(
                ms for i, ms in enumerate(step_ms, 1) if i % ou["every"]),
            "step_ms_publishing": [ms for i, ms in enumerate(step_ms, 1)
                                   if i % ou["every"] == 0],
            "step_ms_alone_median": statistics.median(alone_ms),
            "events": events, "applied": applied, "rejected": rejected,
            "poisoned": poisoned, "rollback": rollback[0]["version"],
            "per_version": per_version,
            "gap_ms_median": statistics.median(g for g, _ in gaps) * 1e3,
            "gap_ms_max_across_flip": max(flip_gaps) * 1e3
            if flip_gaps else None,
            "gap_ms_max": max(g for g, _ in gaps) * 1e3,
            "batches": n_batches, "responses": len(ok),
            "checked_by_version": checked,
            "max_abs_err_vs_block": max_err,
            "min_abs_dist_to_neighbour_version": min_apart,
            "cache": stats["models"]["bert_base_sst2"]["cache"],
            "deadline_dropped": stats["models"]["bert_base_sst2"][
                "deadline_dropped"],
            "overload": overload, "launches": counts,
            "serving_site_after_warmup": {"captures": site1["captures"] -
                                          site0["captures"],
                                          "misses": site1["misses"] -
                                          site0["misses"]},
            "trainer_replays": trainer1["replays"] - trainer0["replays"],
            "max_memory_allocated": peak,
            "staging_bytes": {
                "device": sum(t.numel() * t.element_size()
                              for t in staging[1]) if staging else 0,
                "pinned_host": sum(t.numel() * t.element_size()
                                   for t in staging[0]) if staging else 0},
            "model_bus": stats["model_bus"]}
        emit(summary)
        return {"launches": counts, "batches": n_batches, "steps": steps}
    finally:
        for w in wrapped:
            w.restore()
        faults.reset()
        shutil.rmtree(busdir, ignore_errors=True)


# (B, H, S, D), dtype: the main shape in both dtypes, then S not a
# multiple of 128, every head-dim bucket, B*H = 1
DECODE_MAIN = (32, 12, 1024, 64)
DECODE_ODD = [((4, 12, 1000, 64), torch.float32),
              ((4, 12, 1000, 64), torch.bfloat16),
              ((3, 5, 77, 8), torch.float32),
              ((2, 4, 300, 128), torch.float32),
              ((2, 4, 300, 128), torch.bfloat16),
              ((2, 2, 129, 256), torch.float32),
              ((1, 1, 1024, 64), torch.float32),
              ((1, 1, 1, 64), torch.bfloat16)]


def _decode_inputs(b, h, s, d, dtype, gen, dev):
    """q, k, v from a normal distribution and seeded ragged lengths in
    [1, s] that include 1 and s."""
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, h, d), (b, h, s, d), (b, h, s, d)))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0] = 1
    lengths[-1] = s
    return q, k, v, lengths


def _decode_check(got, want, dtype, what):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape or not torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"decode_attention disagrees with the plain "
                             f"version at {what}: max abs err {err}")
    return err, tol


def decode_bound_ms(q, k, lengths):
    """Least time of one decode call: the filled cache rows of k and v
    (sum(lengths) * H * D each), q, the lengths and the output moved once
    over HBM, or 4 * D FLOP per filled key and head (q.k and p*v) at the
    float32 rate."""
    b, h, d = q.shape
    filled = int(lengths.clamp(max=k.shape[2]).sum().item()) * h
    e = q.element_size()
    nbytes = 2 * filled * d * e + 2 * b * h * d * e + 4 * b
    return _bound_ms(nbytes, 4 * filled * d, H100_F32_FLOPS)


def phase_decode():
    """K5 through the op on the main shape (the launches counted), then
    odd shapes against the plain version, then timings."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    b, h, s, d = DECODE_MAIN
    main = {dt: _decode_inputs(b, h, s, d, dt, gen, dev)
            for dt in (torch.float32, torch.bfloat16)}
    kernels.reset_launch_counts()
    outs = {dt: mx.nd.contrib.decode_attention(
        *(mx.nd.NDArray(t) for t in args)) for dt, args in main.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["decode_attention"]
    if launches != len(main):
        raise AssertionError(f"decode: {launches} kernel launches for "
                             f"{len(main)} op calls")
    errs = {}
    for dt, (q, k, v, lengths) in main.items():
        want = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                       1.0 / math.sqrt(d))
        errs[str(dt).replace("torch.", "")] = _decode_check(
            outs[dt]._data, want, dt, (DECODE_MAIN, dt))[0]
    for (ob, oh, os_, od), dt in DECODE_ODD:
        q, k, v, lengths = _decode_inputs(ob, oh, os_, od, dt, gen, dev)
        scale = 1.0 / math.sqrt(od)
        got = decode_attention.decode_attention(q, k, v, lengths, scale)
        torch.cuda.synchronize()
        want = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                       scale)
        err, tol = _decode_check(got, want, dt, ((ob, oh, os_, od), dt))
        emit({"phase": "decode", "shape": [ob, oh, os_, od],
              "dtype": str(dt).replace("torch.", ""),
              "lengths": lengths.tolist(), "max_abs_err": err,
              "rtol_atol": tol, "ok": True})

    q, k, v, lengths = main[torch.float32]
    scale = 1.0 / math.sqrt(d)
    mask = (torch.arange(s, device=dev)[None, None, None, :]
            < lengths[:, None, None, None]).expand(b, h, 1, s)
    q4 = q.unsqueeze(2)
    timing = {
        "ms": cuda_ms(lambda: decode_attention.decode_attention(
            q, k, v, lengths, scale)),
        "plain_ms": cuda_ms(lambda: decode_attention.decode_attention_plain(
            q, k, v, lengths, scale)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(
                                  q4, k, v, attn_mask=mask, scale=scale))}
    timing["bound_ms"], timing["bound_by"] = decode_bound_ms(q, k, lengths)
    # the kernel's own time: 20 calls after the profiler's warm-up cycle
    timing["device_ms"] = device_ms(lambda: decode_attention.decode_attention(
        q, k, v, lengths, scale))
    timing["max_abs_err"] = errs["float32"]
    emit({"phase": "decode_timing", "shape": list(DECODE_MAIN),
          "dtype": "float32", "filled_keys": int(lengths.sum().item()),
          "launches": launches, "max_abs_err_by_dtype": errs, **timing,
          "library": "scaled_dot_product_attention, q (B, H, 1, D), boolean "
                     "mask (B, H, 1, S); a yardstick only"})
    return dict(timing, launches=launches)


def _bitwise_equal(a, b):
    """``torch.equal``, with NaN equal to NaN at the same positions."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0), b.masked_fill(nan, 0))


def _twobit_cases(e_c, e_d, grad, res, thr, what):
    """Compress and decompress (int8 codes, their int8 sum in [-2, 2] and
    the int32 sum) with the kernels and the plain versions, in the
    gradient's dtype: torch.equal or an AssertionError."""
    codes, new_res = e_c.kernel(grad, res, thr)
    want_codes, want_res = e_c.plain(grad, res, thr)
    summed = torch.clamp(codes.to(torch.int32) + want_codes.flip(0).to(
        torch.int32), -2, 2)
    pairs = [("codes", codes, want_codes), ("residual", new_res, want_res)]
    for label, c in (("int8", codes), ("int8 sum", summed.to(torch.int8)),
                     ("int32 sum", summed)):
        pairs.append((f"decompress {label}", e_d.kernel(c, thr, grad.dtype),
                      e_d.plain(c, thr, grad.dtype)))
    torch.cuda.synchronize()
    for label, got, want in pairs:
        if not _bitwise_equal(got, want):
            raise AssertionError(f"twobit {label} differs from the plain "
                                 f"version at {what}")
    return codes


def _twobit_plan(shapes, cap=4 << 20):
    """The dist kvstore's bucket plan of ``shapes`` (keys 0, 1, ...
    registered in order, float32, buckets of ``cap`` bytes)."""
    plan = buckets.BucketPlan(cap)
    for i, sh in enumerate(shapes):
        plan.register(i, sh, "float32")
    return plan


def _multi_case(shapes, gen, dev, thr, what, keys=None, offset=0):
    """One multi-tensor compress over ``keys`` (default: all) of a flat
    layout of ``shapes`` with random residuals, its gradients views
    ``offset`` floats into their buffers, against the plain version on
    copies of the same buffers: the whole wire and residual buffers
    torch.equal (so nothing outside the listed slots moved), every tensor
    on the path its alignment gives. Then the decompress of the wire
    (the codes and their doubled sum), whole, from its first bucket's end
    and from one code in (the scalar path). Returns the layout."""
    lay = buckets.FlatLayout(_twobit_plan(shapes), dev)
    keys = list(range(len(shapes))) if keys is None else keys
    lay.residual.copy_(torch.randn(lay.residual.shape, generator=gen,
                                   device=dev) * 0.2)
    grads = []
    for k in keys:
        n = math.prod(shapes[k])
        g = (torch.randn(n + offset, generator=gen, device=dev) *
             0.4)[offset:].view(shapes[k])
        edge = torch.tensor([thr, -thr, float("nan")], device=dev)[:min(n, 3)]
        g.view(-1)[:edge.numel()] = edge
        lay.residuals[k].view(-1)[:edge.numel()] = 0.0
        grads.append(g)
    wire, res = lay.wire.clone(), lay.residual.clone()
    want_codes = [wire[lay.offsets[k]:lay.offsets[k] + lay.codes[k].numel()]
                  for k in keys]
    want_res = [res[lay.offsets[k]:lay.offsets[k] + lay.codes[k].numel()]
                for k in keys]
    e = kernels.entry("twobit_compress_multi")
    before = dict(twobit.twobit_compress_multi.tensors_by_path)
    e.kernel(grads, [lay.residuals[k] for k in keys],
             [lay.codes[k] for k in keys], thr)
    e.plain(grads, want_res, want_codes, thr)
    torch.cuda.synchronize()
    if not (torch.equal(lay.wire, wire) and
            _bitwise_equal(lay.residual, res)):
        raise AssertionError(f"twobit_compress_multi differs from the plain "
                             f"version at {what}")
    vec = sum(g.data_ptr() % 16 == 0 for g in grads if g.numel())
    paths = {p: twobit.twobit_compress_multi.tensors_by_path[p] - before[p]
             for p in before}
    if paths != {"vec16": vec, "scalar": sum(1 for g in grads
                                             if g.numel()) - vec}:
        raise AssertionError(f"twobit_compress_multi at {what}: paths "
                             f"{paths}, {vec} aligned gradients")
    d = kernels.entry("twobit_decompress")
    summed = (lay.wire.to(torch.int32) * 2).clamp(-2, 2).to(torch.int8)
    first_hi = lay.ranges[0][1]
    for codes in (lay.wire, summed):
        for lo, path in ((0, "vec16"), (first_hi, "vec16"), (1, "scalar")):
            c = codes[lo:]
            if not c.numel():
                continue
            n0 = twobit.twobit_decompress.launches_by_path[path]
            got = d.kernel(c, thr)
            if twobit.twobit_decompress.launches_by_path[path] != n0 + 1:
                raise AssertionError(f"twobit_decompress at {what} from "
                                     f"{lo}: not on the {path} path")
            if not torch.equal(got, d.plain(c, thr)):
                raise AssertionError(f"twobit_decompress differs from "
                                     f"the plain version at {what} from {lo}")
    return lay


def phase_twobit():
    """K6 and K7 with torch.equal against the plain versions: the
    single-tensor compress (the per-key path), the multi-tensor compress
    (the bucketed path, through the kvstore's flat layout) and the
    decompress of both; then the
    timing of one step's worth of both routes (twobit_timing)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    e_c, e_d = kernels.entry("twobit_compress"), kernels.entry(
        "twobit_decompress")
    shapes = list(classifier_shapes(BERT_BASE).values())
    n_full = sum(math.prod(sh) for sh in shapes)
    thr = 0.5
    checked = []
    for n in (n_full, 1, 127, 4097):
        grad = torch.randn(n, generator=gen, device=dev) * 0.4
        res = torch.randn(n, generator=gen, device=dev) * 0.2
        # values exactly at +-thr and a NaN
        grad[: min(n, 3)] = torch.tensor([0.5, -0.5, float("nan")],
                                         device=dev)[: min(n, 3)]
        res[: min(n, 3)] = 0.0
        codes = _twobit_cases(e_c, e_d, grad, res, thr, n)
        checked.append(n)
        if n == n_full:
            share = (codes != 0).float().mean().item()
            signs = (int((codes > 0).sum()), int((codes < 0).sum()))
    del grad, res, codes
    for off in (1, 3):  # unaligned views: the scalar path
        grad = torch.randn(4097 + off, generator=gen, device=dev)[off:]
        res = torch.randn(4097 + off, generator=gen, device=dev)[off:]
        _twobit_cases(e_c, e_d, grad, res, 0.3, f"offset {off}")
        checked.append(f"4097+offset{off}")
    multi = []
    odd = [(1,), (2,), (3,), (127,), (4097,), (33, 5)]
    lay = _multi_case(shapes, gen, dev, thr, "classifier")
    plan = _twobit_plan(shapes)
    big = max(plan.buckets, key=lambda b: len(b["keys"]))
    multi.append({"case": "classifier", "tensors": len(shapes),
                  "buckets": len(plan.buckets), "wire": lay.wire.numel(),
                  "padding": lay.padding})
    del lay
    for what, kw in (
            ("odd sizes", dict(shapes=odd)),
            ("odd sizes, thr 0.3", dict(shapes=odd, thr=0.3)),
            ("unaligned gradients (+1 float)", dict(shapes=odd, offset=1)),
            ("unaligned gradients (+3 floats)", dict(shapes=shapes[:6],
                                                     offset=3)),
            ("a strict subset of a bucket", dict(
                shapes=shapes, keys=big["keys"][1:-1:2]))):
        _multi_case(kw.pop("shapes"), gen, dev, kw.pop("thr", thr), what,
                    **kw)
        multi.append(what)
    emit({"phase": "twobit", "sizes": checked, "multi_tensor": multi,
          "bitwise_equal": True, "threshold": thr,
          "nonzero_share_109M": share, "plus_minus_codes_109M": signs})
    torch.cuda.empty_cache()
    half = twobit_half(n_full, gen, dev)
    torch.cuda.empty_cache()
    return dict(twobit_timing(shapes, gen, dev, thr), half=half)


def twobit_half(n_full, gen, dev):
    """K6 and K7 in float16 and bfloat16 (fault C4): the single-tensor
    compress of a half-precision gradient and the decompress of int8
    codes, their int8 sum and an int32 sum into that dtype, torch.equal
    against the plain versions at thresholds 0.5 and 0.1 on 109 M
    elements, odd sizes and views one element off (the scalar path), with
    gradients at the threshold rounded to the dtype, at the unrounded
    one and NaN. Then each kernel by CUDA events and by the profiler's
    kernel time over 109 M elements against its byte bound: 7 bytes an
    element for the compress (two halves read, a half and a code
    written), 3 and 6 for the decompress from int8 and int32 codes."""
    e_c, e_d = kernels.entry("twobit_compress"), kernels.entry(
        "twobit_decompress")
    out = {}
    for dtype in (torch.float16, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        checked = []
        for thr in TWOBIT_HALF_THRESHOLDS:
            t = twobit.round_threshold(thr, dtype)
            for n, off in ((n_full, 0), (1, 0), (127, 0), (4097, 0),
                           (4097, 1), (4099, 3)):
                grad = (torch.randn(n + off, generator=gen, device=dev) *
                        thr).to(dtype)[off:]
                res = (torch.randn(n + off, generator=gen, device=dev) *
                       thr * 0.4).to(dtype)[off:]
                edge = torch.tensor([t, -t, thr, float("nan")],
                                    device=dev)[:min(n, 4)]
                grad[:edge.numel()] = edge.to(dtype)
                res[:edge.numel()] = 0
                _twobit_cases(e_c, e_d, grad, res, thr,
                              f"{name} n={n} offset {off} thr {thr}")
                checked.append([n, off, thr])
        del grad, res
        grad = (torch.randn(n_full, generator=gen, device=dev) * 0.5).to(
            dtype)
        res = (torch.randn(n_full, generator=gen, device=dev) * 0.2).to(
            dtype)
        codes = e_c.kernel(grad, res, 0.5)[0]
        summed = codes.to(torch.int32) * 2
        timing = {}
        for label, fn, nbytes, plain in (
                ("compress", lambda: e_c.kernel(grad, res, 0.5), 7 * n_full,
                 lambda: e_c.plain(grad, res, 0.5)),
                ("decompress_int8", lambda: e_d.kernel(codes, 0.5, dtype),
                 3 * n_full, lambda: e_d.plain(codes, 0.5, dtype)),
                ("decompress_int32", lambda: e_d.kernel(summed, 0.5, dtype),
                 6 * n_full, lambda: e_d.plain(summed, 0.5, dtype))):
            timing[label] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
                             "plain_ms": cuda_ms(plain, iters=3),
                             "bound_ms": nbytes / H100_BYTES_S * 1e3,
                             "bound_by": "bytes", "library_ms": None}
        del grad, res, codes, summed
        out[name] = timing
        emit({"phase": "twobit_half", "dtype": name, "cases": checked,
              "bitwise_equal": True, "elements": n_full, **timing})
    return out


def twobit_timing(shapes, gen, dev, thr):
    """One step's worth of K6 and K7 over the classifier's 197 tensors,
    by both routes, in this call: the per-key route (197 single-tensor
    compress launches and the 86 bucket ``torch.cat`` copies; 197
    decompress launches on the reduced buckets' slices) and the
    multi-tensor route (one compress launch into the flat wire, one
    decompress launch over it). Each by CUDA events over back-to-back
    calls (``ms``), by the profiler's kernel time (``device_ms``) and by
    the host's time per call (``host_us``); the plain versions by events;
    and the single-tensor compress and the decompress over all 109 M
    elements as one launch."""
    n_full = sum(math.prod(sh) for sh in shapes)
    plan = _twobit_plan(shapes)
    lay = buckets.FlatLayout(plan, dev)
    grads = [torch.randn(sh, generator=gen, device=dev) * 0.4 for sh in shapes]
    ress = [r.clone() for r in (torch.randn(sh, generator=gen, device=dev) *
                                0.2 for sh in shapes)]
    keys = list(range(len(shapes)))
    for k in keys:
        lay.residuals[k].copy_(ress[k])
    res_views = [lay.residuals[k] for k in keys]
    code_views = [lay.codes[k] for k in keys]
    members = [b["keys"] for b in plan.buckets]
    e_c, e_d = kernels.entry("twobit_compress"), kernels.entry(
        "twobit_decompress")
    m_c = kernels.entry("twobit_compress_multi")

    def old_push():   # kvstore.py before the flat layout: _quantize + cat
        return [torch.cat([e_c.kernel(grads[k], ress[k], thr)[0].reshape(-1)
                           for k in ks]) for ks in members]

    fused = [c.to(torch.int32).mul(2).clamp(-2, 2).to(torch.int8)
             for c in old_push()]
    slices = []
    for ks, flat in zip(members, fused):
        off = 0
        for k in ks:
            n = math.prod(shapes[k])
            slices.append(flat[off:off + n].view(shapes[k]))
            off += n

    def old_pull():   # _apply_reduced: one decompress per key
        return [e_d.kernel(c, thr) for c in slices]

    def new_push():
        m_c.kernel(grads, res_views, code_views, thr)

    def new_pull():
        return e_d.kernel(lay.wire, thr)

    def timed(fn, plain=None):
        t = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
             "host_us": _host_us(fn)}
        if plain is not None:
            t["plain_ms"] = cuda_ms(plain, iters=5)
        return t

    plain_slot = [lay.residual.clone(), lay.wire.clone()]
    p_res = [plain_slot[0][lay.offsets[k]:lay.offsets[k] + v.numel()]
             for k, v in zip(keys, code_views)]
    p_codes = [plain_slot[1][lay.offsets[k]:lay.offsets[k] + v.numel()]
               for k, v in zip(keys, code_views)]
    step = {"compress": {
        **timed(new_push, lambda: m_c.plain(grads, p_res, p_codes, thr)),
        "old_route": timed(old_push), "bytes": 13 * n_full,
        "one_launch_ms": None},
        "decompress": {
        **timed(new_pull, lambda: e_d.plain(lay.wire, thr)),
        "old_route": timed(old_pull), "bytes": 5 * n_full,
        "one_launch_ms": None}}
    big_g = torch.cat([g.reshape(-1) for g in grads])
    big_r = torch.cat([r.reshape(-1) for r in ress])
    step["compress"]["one_launch_ms"] = cuda_ms(
        lambda: e_c.kernel(big_g, big_r, thr))
    del big_g, big_r
    big_c = torch.cat([c.reshape(-1) for c in fused])
    step["decompress"]["one_launch_ms"] = cuda_ms(
        lambda: e_d.kernel(big_c, thr))
    for t in step.values():
        t["bound_ms"], t["bound_by"] = t.pop("bytes") / H100_BYTES_S * 1e3, \
            "bytes"
        t["library_ms"] = None
    emit({"phase": "twobit_timing", "tensors": len(shapes),
          "elements": n_full, "buckets": len(members),
          "wire_elements": lay.wire.numel(), "padding": lay.padding, **step,
          "library": "none: no single PyTorch call computes either "
                     "function"})
    return step


# ---- the two-worker dist_sync path -----------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_trainer(cfg, optimizer, params, thr):
    """The classifier on the card, a dist_sync store with 2-bit
    compression and a gluon.Trainer over it (cifar10_dist.py:60-87)."""
    clf = _classifier_on(mx.gpu(0), cfg, random_params(cfg, seed=0))
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": thr})
    trainer = mx.gluon.Trainer(clf.collect_params(), optimizer, dict(params),
                               kvstore=kv)
    return clf, kv, trainer


def _train_step(clf, trainer, loss_fn, x, y, batch_size):
    with mx.autograd.record():
        loss = loss_fn(clf(x), y)
    loss.backward()
    trainer.step(batch_size)
    return loss


def _host(t):
    """A host copy of ``t`` (a copy even when ``t`` is on the CPU: the
    buffers saved here are overwritten later)."""
    return t.detach().to("cpu", copy=True)


def _worker_check(rank, out_dir):
    """dist_check's worker: every push, code, residual, pulled sum and
    the weights, saved for the parent's recompute."""
    c = DIST_CHECK
    cfg, n = c["cfg"], c["workers"]
    x, y = make_task(c["batch"] * n * c["steps"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=11)
    xs, ys = x[rank::n], y[rank::n]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    records = {}
    for name, params in c["optimizers"].items():
        clf, kv, trainer = _dist_trainer(cfg, name, params, c["threshold"])
        plist = list(clf.collect_params().values())
        rec = {"initial": [_host(p.data()._data) for p in plist],
               "steps": []}
        step = {}
        push, compress = kv.push, kv._compress

        def logged_push(key, value, priority=0, _push=push, _step=step):
            for k, v in zip(key, value) if isinstance(key, list) else \
                    [(key, value)]:
                _step.setdefault("pushed", {})[k] = _host(v._data)
            return _push(key, value, priority)

        def logged_compress(keys, grads, thr, _compress=compress,
                            _step=step, _kv=kv):
            # each key's wire slot, copied before its bucket's all-reduce
            # reduces it in place
            _compress(keys, grads, thr)
            _step["compress_calls"] = _step.get("compress_calls", 0) + 1
            lay = _kv._pipeline.flat
            for k in keys:
                _step.setdefault("codes", {})[k] = _host(
                    lay.codes[k]).view(lay.residuals[k].shape)
                _step.setdefault("residuals", {})[k] = \
                    _host(_kv._residuals[k])

        kv.push, kv._compress = logged_push, logged_compress
        for t in range(c["steps"]):
            sl = slice(t * c["batch"], (t + 1) * c["batch"])
            step.clear()
            _train_step(clf, trainer, loss_fn, mx.nd.array(xs[sl]),
                        mx.nd.array(ys[sl]), c["batch"] * kv.num_workers)
            step["pulled"] = {i: _host(p.grad()._data)
                              for i, p in enumerate(plist)}
            if step.get("compress_calls") != 1 or \
                    len(step["codes"]) != len(plist):
                raise AssertionError(
                    f"dist_check worker {rank}: {step.get('compress_calls')} "
                    f"compress calls over {len(step.get('codes', ()))} of "
                    f"{len(plist)} keys in a step; expected one over all")
            rec["steps"].append(dict(step))
        rec["final"] = [_host(p.data()._data) for p in plist]
        rec["num_workers"] = kv.num_workers
        records[name] = rec
    torch.save(records, Path(out_dir) / f"rank{rank}.pt")
    return {"optimizers": list(records)}


def _worker_train(rank, out_dir):
    """dist_train's worker: full width, 10 "adam" steps, timed."""
    d, cfg = DIST_TRAIN, BERT_BASE
    clf, kv, trainer = _dist_trainer(cfg, "adam", {"learning_rate": d["lr"],
                                                   "wd": d["wd"]},
                                     d["threshold"])
    n = kv.num_workers
    x, y = make_task(d["batch"] * n, cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    xb, yb = mx.nd.array(x[rank::n]), mx.nd.array(y[rank::n])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    plist = list(clf.collect_params().values())
    elements = sum(p.data().size for p in plist)
    nonzero = torch.zeros((), dtype=torch.int64,
                          device=plist[0].data()._data.device)
    compress = kv._compress

    def counted_compress(keys, grads, thr):
        compress(keys, grads, thr)
        if len(keys) != len(plist):
            raise AssertionError(f"dist_train worker {rank}: a compress "
                                 f"call over {len(keys)} of {len(plist)} "
                                 "keys")
        # every key's codes, before the all-reduces (padding is zero)
        nonzero.add_(torch.count_nonzero(kv._pipeline.flat.wire))

    kv._compress = counted_compress
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts, wire, paths = [], [], [], [], []
    stats = kv._pipeline.stats
    copies = stats["copies"]
    for _ in range(d["steps"]):
        kernels.reset_launch_counts()
        vec = dict(twobit.twobit_compress_multi.tensors_by_path)
        sent = stats["bytes"]
        t0 = time.perf_counter()
        loss = _train_step(clf, trainer, loss_fn, xb, yb, d["batch"] * n)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(kernels.launch_counts())
        paths.append({p: twobit.twobit_compress_multi.tensors_by_path[p] -
                      vec[p] for p in vec})
        wire.append(stats["bytes"] - sent)
        losses.append(loss.mean().asscalar())
    peak = torch.cuda.max_memory_allocated()
    bucket_copies = stats["copies"] - copies
    # one more step, split on the host clock with a wait for the card
    # between its parts (not counted above): forward and backward; the
    # push call in backward order, as Trainer.allreduce_grads makes it
    # (K6 into the wire, the all-reduces started); the pull call (the
    # waits for the all-reduces, K7, the copies into the gradients); the
    # optimizer
    keys = list(range(len(plist)))
    split, t0 = {}, time.perf_counter()
    with mx.autograd.record():
        loss = loss_fn(clf(xb), yb)
    loss.backward()
    for part, fn in (
            ("forward_backward", None),
            ("push", lambda: kv.push(keys[::-1], [plist[i].grad()
                                                   for i in keys[::-1]])),
            ("pull", lambda: kv.pull(keys, [plist[i].grad() for i in keys])),
            ("update", lambda: trainer.update(d["batch"] * n))):
        if fn is not None:
            fn()
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[part] = (now - t0) * 1e3
        t0 = now
    wire_ms = _allreduce_ms(
        [sum(kv._pipeline.plan.info[k]["nelems"] for k in b["keys"])
         for b in kv._pipeline.plan.buckets], plist[0].data()._data.device)
    digest = hashlib.sha256()
    for p in plist:
        digest.update(p.data()._data.cpu().numpy().tobytes())
    median = statistics.median(step_ms[d["warmup"]:])
    return {"rank": rank, "num_workers": n, "losses": losses,
            "step_ms": step_ms, "median_step_ms": median,
            "tokens_per_s": d["batch"] * cfg["seq_len"] / (median / 1e3),
            "launches_per_step": counts, "wire_bytes_per_step": wire,
            "compress_tensors_by_path_per_step": paths,
            "bucket_copies": bucket_copies,
            "wire_padding_bytes": kv._pipeline.flat.padding,
            "f32_bytes_per_step": 4 * elements, "elements": elements,
            "nonzero_code_share": int(nonzero.item()) / (elements *
                                                         d["steps"]),
            "buckets": len(kv._pipeline.plan.buckets) if kv._pipeline else 0,
            "memory_allocated_before": before, "max_memory_allocated": peak,
            "split_step_ms": split, "allreduce_int8_ms": wire_ms,
            "weights_sha256": digest.hexdigest()}


def _allreduce_ms(bucket_elems, dev, reps=3):
    """Median host-clock ms of gloo's all-reduce of int8 zeros on the
    card with nothing else running: the buckets' sizes started together
    and waited for (the kvstore's pattern), and one tensor of the same
    total size."""
    import torch.distributed as dist

    out = {}
    for label, sizes in (("buckets", bucket_elems),
                         ("one_tensor", [sum(bucket_elems)])):
        bufs = [torch.zeros(s, dtype=torch.int8, device=dev) for s in sizes]
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for work in [dist.all_reduce(b, async_op=True) for b in bufs]:
                work.wait()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = statistics.median(times)
    return out


WORKERS = {"dist_check": _worker_check, "dist_train": _worker_train}


def dist_worker(kind, out_dir):
    """Entry of one worker process (``--worker``): no card is an error."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{kind} worker: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["MXTPU_WORKER_ID"])
    result = WORKERS[kind](rank, out_dir)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    print(f"DIST_OK {kind} {rank}", flush=True)
    return 0


def run_workers(kind, out_dir, n, timeout_s):
    """Start ``n`` workers of ``kind`` on one card with the environment of
    tools/launch.py; wait for all (killing every one on a timeout) and
    require exit 0 and the OK line from each. Returns their results."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    coord = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for rank in range(n):
        env = dict(os.environ, MXTPU_COORDINATOR=coord,
                   MXTPU_NUM_WORKERS=str(n), MXTPU_WORKER_ID=str(rank))
        log = open(Path(out_dir) / f"rank{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", kind,
             "--out", str(out_dir)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=os.path.dirname(
                os.path.abspath(__file__))))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DIST_OK {kind} {rank}" not in out:
            raise AssertionError(f"{kind} worker {rank} failed (exit "
                                 f"{p.returncode}):\n{out[-3000:]}")
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
            for r in range(n)]


def phase_dist_check():
    """Two workers at 2 layers and narrow width; every step recomputed
    here on the CPU with the plain versions of K6, K7 and the optimizer
    (ops/optimizer_op.py)."""
    c = DIST_CHECK
    thr = c["threshold"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as out_dir:
        run_workers("dist_check", out_dir, c["workers"], c["timeout_s"])
        recs = [torch.load(Path(out_dir) / f"rank{r}.pt")
                for r in range(c["workers"])]
    result = {}
    for name, params in c["optimizers"].items():
        ranks = [r[name] for r in recs]
        if any(r["num_workers"] != c["workers"] for r in ranks):
            raise AssertionError(f"dist_check {name}: workers saw "
                                 f"{[r['num_workers'] for r in ranks]}")
        initial = ranks[0]["initial"]
        for r in ranks[1:]:
            if not all(torch.equal(a, b) for a, b in zip(initial,
                                                         r["initial"])):
                raise AssertionError(f"dist_check {name}: initial weights "
                                     "differ between ranks")
        with mx.cpu():
            opt = mx.optimizer.create(name, **params)
            opt.rescale_grad = 1.0 / (c["batch"] * c["workers"])
            weights = [mx.nd.NDArray(w.clone()) for w in initial]
            states = [opt.create_state(i, w) for i, w in enumerate(weights)]
        keys = list(range(len(weights)))
        residuals = [[torch.zeros_like(w) for w in initial] for _ in ranks]
        plus = minus = 0
        for t in range(c["steps"]):
            codes_sum = []
            for key in keys:
                total = None
                for ri, r in enumerate(ranks):
                    step = r["steps"][t]
                    codes, res = twobit.twobit_compress_plain(
                        step["pushed"][key], residuals[ri][key], thr)
                    if not (torch.equal(codes, step["codes"][key]) and
                            torch.equal(res, step["residuals"][key])):
                        raise AssertionError(
                            f"dist_check {name} step {t} key {key} rank "
                            f"{ri}: codes or residual differ from the plain "
                            "recompute")
                    residuals[ri][key] = res
                    plus += int((codes > 0).sum())
                    minus += int((codes < 0).sum())
                    total = codes.to(torch.int32) if total is None else \
                        total + codes.to(torch.int32)
                codes_sum.append(total.to(torch.int8))
            pulled = [twobit.twobit_decompress_plain(cs, thr)
                      for cs in codes_sum]
            for ri, r in enumerate(ranks):
                got = r["steps"][t]["pulled"]
                if not all(torch.equal(got[k], pulled[k]) for k in keys):
                    raise AssertionError(f"dist_check {name} step {t} rank "
                                         f"{ri}: pulled sums differ from the "
                                         "plain recompute")
            with mx.cpu():
                opt.fused_update_multi(keys, weights,
                                       [mx.nd.NDArray(g) for g in pulled],
                                       states)
        finals = [r["final"] for r in ranks]
        if not all(torch.equal(a, b) for a, b in zip(*finals)):
            raise AssertionError(f"dist_check {name}: the ranks' weights "
                                 "differ")
        worst = 0.0
        for got, want in zip(finals[0], weights):
            want = want._data
            diff = (got - want).abs().max().item()
            scale = max(want.abs().max().item(), 1e-30)
            worst = max(worst, diff / scale)
            if diff > DIST_WEIGHT_RTOL * scale:
                raise AssertionError(f"dist_check {name}: weights differ "
                                     f"from the CPU recompute by {diff}")
        if not plus or not minus:
            raise AssertionError(f"dist_check {name}: codes of one sign "
                                 f"only (+{plus}, -{minus}); lower the "
                                 "threshold")
        result[name] = {"codes_plus": plus, "codes_minus": minus,
                        "max_weight_diff_rel": worst,
                        "ranks_bitwise_equal": True,
                        "codes_residuals_pulled_bitwise_equal": True}
    emit({"phase": "dist_check", "config": c["cfg"], "batch": c["batch"],
          "workers": c["workers"], "steps": c["steps"], "threshold": thr,
          "weight_rtol": DIST_WEIGHT_RTOL, **result})
    return result


def phase_dist_train(smi):
    """Two workers at full width, 10 "adam" steps each."""
    d, cfg = DIST_TRAIN, BERT_BASE
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as out_dir:
        workers = run_workers("dist_train", out_dir, d["workers"],
                              d["timeout_s"])
    n_tensors = len(classifier_shapes(cfg))
    layers = cfg["layers"]
    want = dict.fromkeys(workers[0]["launches_per_step"][0], 0)
    # one multi-tensor compress per push call and one decompress per
    # pull call; no per-key K6/K7
    want.update({"twobit_compress_multi": 1, "twobit_decompress": 1,
                 "twobit_decompress.vec16": 1, "opt_adam": 1,
                 "flash_attention": layers, "flash_attention.mma": layers,
                 "flash_attention_bwd_dq": layers,
                 "flash_attention_bwd_dq.mma": layers,
                 "flash_attention_bwd_dkv": layers,
                 "flash_attention_bwd_dkv.mma": layers})
    for w in workers:
        if w["num_workers"] != d["workers"]:
            raise AssertionError(f"dist_train: worker {w['rank']} saw "
                                 f"{w['num_workers']} workers")
        for t, counts in enumerate(w["launches_per_step"]):
            if counts != want:
                raise AssertionError(f"dist_train worker {w['rank']} step "
                                     f"{t}: launches {counts}, expected "
                                     f"{want}")
        for t, paths in enumerate(w["compress_tensors_by_path_per_step"]):
            if paths != {"vec16": n_tensors, "scalar": 0}:
                raise AssertionError(f"dist_train worker {w['rank']} step "
                                     f"{t}: compress paths {paths}")
        if w["bucket_copies"]:
            raise AssertionError(f"dist_train worker {w['rank']}: "
                                 f"{w['bucket_copies']} gradients copied "
                                 "into bucket buffers")
        codes_bytes = w["elements"]   # one int8 code per element
        if not w["wire_padding_bytes"] <= 15 * n_tensors or any(
                b != codes_bytes + w["wire_padding_bytes"]
                for b in w["wire_bytes_per_step"]):
            raise AssertionError(f"dist_train worker {w['rank']}: wire bytes "
                                 f"{w['wire_bytes_per_step']} for "
                                 f"{codes_bytes} codes and "
                                 f"{w['wire_padding_bytes']} of padding")
        losses = w["losses"]
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"dist_train worker {w['rank']}: loss not "
                                 f"finite and falling: {losses}")
    if len({w["weights_sha256"] for w in workers}) != 1:
        raise AssertionError("dist_train: the workers' final weights differ")
    totals = {f: sum(sum(c[f] for c in w["launches_per_step"])
                     for w in workers)
              for f in ("twobit_compress_multi", "twobit_decompress",
                        "opt_adam")}
    for w in workers:   # every step's launches were checked above
        w["launches_per_step"] = w["launches_per_step"][0]
        w["compress_tensors_by_path_per_step"] = \
            w["compress_tensors_by_path_per_step"][0]
    emit({"phase": "dist_train", "card": smi, "config": cfg,
          **{k: v for k, v in d.items() if k != "timeout_s"},
          "tokens_per_s_total": sum(w["tokens_per_s"] for w in workers),
          "launches_per_step_per_worker": dict.fromkeys(totals, 1),
          "wire_bytes_per_step_before_padding": workers[0]["elements"],
          "launches_total": totals, "weights_equal": True,
          "per_worker": workers})
    return totals


# ---- ResNet training ---------------------------------------------------------

def _resnet_trainer(net, ctx, nan_guard, mp=False, lr_scheduler=None):
    params = {"learning_rate": RESNET50["lr"],
              "momentum": RESNET50["momentum"], "wd": RESNET50["wd"]}
    if mp:
        params["multi_precision"] = True
    if lr_scheduler is not None:
        params["lr_scheduler"] = lr_scheduler
    return ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", params,
        mesh=DeviceMesh({"dp": 1}, devices=[ctx]), nan_guard=nan_guard)


def phase_resnet_check():
    """A thumbnail resnet18_v1 (10 classes, batch 8, 32x32), 3 "sgd" steps
    (the ResNet-50 config's lr, momentum and wd) on the card and on a CPU
    copy with TF32 off, the CPU copy set to the card's weights, momenta
    and running statistics before each step (``RESNET_CHECK``'s comment
    says why); the loss, every weight, momentum and running statistic
    held to ``RESNET_CHECK_TOL``; K1 launched exactly once a step on the
    card."""
    cfg = RESNET_CHECK
    rs = np.random.RandomState(0)
    x = rs.rand(cfg["steps"], cfg["batch"], 3, cfg["size"],
                cfg["size"]).astype(np.float32)
    y = rs.randint(0, cfg["classes"], (cfg["steps"], cfg["batch"])).astype(
        np.float32)
    nets, trainers = {}, {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        net = vision.get_model(cfg["model"], classes=cfg["classes"],
                               thumbnail=True)
        net.initialize(mx.init.Xavier(), ctx=ctx,
                       generator=torch.Generator().manual_seed(0))
        net(mx.nd.array(x[0], ctx=ctx))
        if where == "cpu":
            load_jax_params(net, export_params(nets["card"]))
        nets[where], trainers[where] = net, _resnet_trainer(net, ctx, True)
    card, cpu = trainers["card"], trainers["cpu"]
    if len(card._param_names) != cfg["tensors"] or \
            len(card._aux_names) != cfg["aux"]:
        raise AssertionError(f"resnet_check: {len(card._param_names)} "
                             f"trainable and {len(card._aux_names)} aux "
                             "tensors")
    tol = RESNET_CHECK_TOL
    before = opt_step.opt_sgd.launches
    steps = []
    for i in range(cfg["steps"]):
        for h, ch in zip(cpu._train_handles, card._train_handles):
            h._data.copy_(ch._data.cpu())
        for per, cper in zip(cpu._opt_state, card._opt_state):
            per[0].copy_(cper[0].cpu())
        for h, ch in zip(cpu._aux_handles, card._aux_handles):
            h._rebind(ch._data.cpu())
        aux0 = [h._data.clone() for h in card._aux_handles]
        got = card.step(mx.nd.array(x[i], ctx=mx.gpu(0)),
                        mx.nd.array(y[i], ctx=mx.gpu(0))).asscalar()
        want = cpu.step(mx.nd.array(x[i], ctx=mx.cpu()),
                        mx.nd.array(y[i], ctx=mx.cpu())).asscalar()
        if not abs(got - want) <= tol["loss_rtol"] * abs(want):
            raise AssertionError(f"resnet_check step {i}: loss {got} on the "
                                 f"card, {want} on the CPU")
        aux_err = 0.0
        for h, ch, old in zip(cpu._aux_handles, card._aux_handles, aux0):
            ref = h._data
            scale = max(float(ref.abs().max()), 1.0)
            err = float((ch._data.cpu() - ref).abs().max()) / scale
            aux_err = max(aux_err, err)
            if err > tol["aux"] or torch.equal(ch._data, old):
                raise AssertionError(f"resnet_check step {i}: a running "
                                     f"statistic off by {err} or unmoved")
        step_err = 0.0
        for name, h, ch, per, cper in zip(
                card._param_names, cpu._train_handles, card._train_handles,
                cpu._opt_state, card._opt_state):
            norm = float(cper[0].norm())
            for a, b in ((ch._data.cpu(), h._data),
                         (cper[0].cpu(), per[0])):
                err = float((a - b).norm()) / max(norm, 1e-30)
                step_err = max(step_err, err)
                if err > tol["step_l2"]:
                    raise AssertionError(f"resnet_check step {i}: {name} "
                                         f"off by {err} of its step")
        steps.append({"loss_card": got, "loss_cpu": want,
                      "max_aux_err": aux_err, "max_step_l2_err": step_err})
    torch.cuda.synchronize()
    launches = opt_step.opt_sgd.launches - before
    if launches != cfg["steps"]:
        raise AssertionError(f"resnet_check: {launches} K1 launches for "
                             f"{cfg['steps']} card steps")
    emit({"phase": "resnet_check", "config": cfg, "tolerance": tol,
          "tf32": False, "steps": steps, "opt_sgd_launches": launches})
    return launches


def _thumbnail_pair(cfg, dtype, mp, lr_scheduler=None):
    """The thumbnail on the card and a CPU copy of the same weights, cast
    to ``dtype``, each with its ShardedTrainer (nan_guard on)."""
    rs = np.random.RandomState(0)
    x = rs.rand(cfg["steps"], cfg["batch"], 3, cfg["size"],
                cfg["size"]).astype(np.float32)
    y = rs.randint(0, cfg["classes"], (cfg["steps"], cfg["batch"])).astype(
        np.float32)
    nets, trainers = {}, {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        net = vision.get_model(cfg["model"], classes=cfg["classes"],
                               thumbnail=True)
        net.initialize(mx.init.Xavier(), ctx=ctx,
                       generator=torch.Generator().manual_seed(0))
        net(mx.nd.array(x[0], ctx=ctx))
        if where == "cpu":
            load_jax_params(net, export_params(nets["card"]))
        nets[where] = net
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        nets[where].cast(dtype)
        trainers[where] = _resnet_trainer(nets[where], ctx, True, mp,
                                          lr_scheduler)
    return nets, trainers, x, y


def phase_resnet_check_bf16():
    """resnet_check in bfloat16 with ``multi_precision``: the thumbnail
    resnet18_v1 cast to bfloat16, 3 steps on the card and on a CPU copy,
    the copy set to the card's weights, masters, momenta and running
    statistics before each step; the loss, every float32 master and
    momentum and every running statistic held to
    ``RESNET_CHECK_BF16_TOL`` (the CPU tests' measured tolerance), every
    bfloat16 weight equal to its master rounded, K1 one launch a step over
    all 60 float32 tensors (22 masters)."""
    cfg, tol = RESNET_CHECK, RESNET_CHECK_BF16_TOL
    _, trainers, x, y = _thumbnail_pair(cfg, "bfloat16", True)
    card, cpu = trainers["card"], trainers["cpu"]
    census = card._routes.census()
    if census != {"float32": 38, "master": 22, "half": 0}:
        raise AssertionError(f"resnet_check_bf16: routes {census}")
    before = opt_step.opt_sgd.launches
    paths = dict(opt_step.opt_sgd.tensors_by_path)
    steps = []
    for i in range(cfg["steps"]):
        for h, ch in zip(cpu._train_handles, card._train_handles):
            h._data.copy_(ch._data.cpu())
        for per, cper in zip(cpu._opt_state, card._opt_state):
            for s, cs in zip(per, cper):
                s.copy_(cs.cpu())
        for h, ch in zip(cpu._aux_handles, card._aux_handles):
            h._rebind(ch._data.cpu())
        got = float(card.step(mx.nd.array(x[i], ctx=mx.gpu(0)).astype(
            "bfloat16"), mx.nd.array(y[i], ctx=mx.gpu(0)))._data.float())
        want = float(cpu.step(mx.nd.array(x[i], ctx=mx.cpu()).astype(
            "bfloat16"), mx.nd.array(y[i], ctx=mx.cpu()))._data.float())
        if not abs(got - want) <= tol["loss_rtol"] * abs(want):
            raise AssertionError(f"resnet_check_bf16 step {i}: loss {got} "
                                 f"on the card, {want} on the CPU")
        aux_err = max(
            float((ch._data.cpu() - h._data).abs().max())
            / max(float(h._data.abs().max()), 1.0)
            for h, ch in zip(cpu._aux_handles, card._aux_handles))
        if aux_err > tol["aux"]:
            raise AssertionError(f"resnet_check_bf16 step {i}: a running "
                                 f"statistic off by {aux_err}")
        step_err = 0.0
        for k, (name, per, cper) in enumerate(zip(
                card._param_names, cpu._opt_state, card._opt_state)):
            w = cper[0] if len(cper) == 2 else card._train_handles[k]._data
            w_cpu = per[0] if len(per) == 2 else cpu._train_handles[k]._data
            norm = float(cper[-1].float().norm())
            for a, b in ((w.cpu(), w_cpu), (cper[-1].cpu(), per[-1])):
                err = float((a.float() - b.float()).norm()) / max(norm,
                                                                  1e-30)
                step_err = max(step_err, err)
                if err > tol["step_l2"]:
                    raise AssertionError(f"resnet_check_bf16 step {i}: "
                                         f"{name} off by {err} of its step")
            if len(cper) == 2 and not torch.equal(
                    card._train_handles[k]._data, cper[0].to(torch.bfloat16)):
                raise AssertionError(f"resnet_check_bf16: {name} is not its "
                                     "master rounded")
        steps.append({"loss_card": got, "loss_cpu": want,
                      "max_aux_err": aux_err, "max_step_l2_err": step_err})
    torch.cuda.synchronize()
    launches = opt_step.opt_sgd.launches - before
    paths = _opt_paths(opt_step.opt_sgd, paths)
    if launches != cfg["steps"] or paths != {"vec4": 60 * cfg["steps"],
                                             "scalar": 0}:
        raise AssertionError(f"resnet_check_bf16: {launches} K1 launches, "
                             f"tensors by path {paths}, for {cfg['steps']} "
                             "card steps")
    emit({"phase": "resnet_check_bf16", "config": cfg, "tolerance": tol,
          "routes_per_step": census, "steps": steps,
          "opt_sgd_launches": launches, "k1_tensors_by_path": paths})
    return launches


def phase_resnet_resume():
    """resnet_resume: the thumbnail (bfloat16, ``multi_precision``) with a
    ``MultiFactorScheduler`` (milestones at steps 2 and 4, factor 0.1) and
    deterministic cuDNN on the card. A run takes 3 steps, checkpoints
    through a ``CheckpointManager`` (epoch 1), takes a 4th, checkpoints
    (epoch 2) and takes 2 more. A fresh net and trainer resume from the
    manager: the state equals epoch 2's bit for bit. Epoch 2's file is
    then truncated, and another fresh pair resumes: the fallback to epoch 1
    is taken, its state equals epoch 1's bit for bit, and 3 steps later
    the weights, masters, momenta, running statistics, losses and lrs
    equal the uninterrupted run's bit for bit."""
    from mxnet_tpu_torch import checkpoint, lr_scheduler

    cfg = dict(RESNET_CHECK, steps=2 * RESNET_RESUME["steps"])
    rr = RESNET_RESUME
    torch.backends.cudnn.deterministic = True
    try:
        def sched():
            return lr_scheduler.MultiFactorScheduler(rr["milestones"],
                                                     rr["factor"])

        _, trainers, x, y = _thumbnail_pair(cfg, "bfloat16", True, sched())
        run = trainers["card"]
        launches0 = opt_step.opt_sgd.launches
        dev = mx.gpu(0)

        def step(st, i):
            lr = st.learning_rate
            loss = st.step(mx.nd.array(x[i], ctx=dev).astype("bfloat16"),
                           mx.nd.array(y[i], ctx=dev))
            return lr, float(loss._data.float())

        def state(st):
            return {k: t.clone() for k, t in st._state_tensors().items()}

        def equal(a, b):
            return set(a) == set(b) and all(torch.equal(a[k], b[k])
                                            for k in a)

        with tempfile.TemporaryDirectory() as tmp:
            manager = checkpoint.CheckpointManager(tmp, keep=3)
            trace = [step(run, i) for i in range(rr["steps"])]
            run.save_checkpoint(manager, epoch=1)
            saved1 = state(run)
            trace.append(step(run, rr["steps"]))
            run.save_checkpoint(manager, epoch=2)
            saved2 = state(run)
            trace += [step(run, i) for i in range(rr["steps"] + 1,
                                                  cfg["steps"])]
            final = state(run)

            def fresh():
                _, pair, _, _ = _thumbnail_pair(cfg, "bfloat16", True,
                                                sched())
                return pair["card"]

            resumed = fresh()
            entry = resumed.resume(manager)
            if entry["epoch"] != 2 or not equal(state(resumed), saved2):
                raise AssertionError("resnet_resume: the state after resume "
                                     "differs from epoch 2's")
            newest = Path(tmp) / "ckpt-0002.states"
            newest.write_bytes(newest.read_bytes()[:1000])
            resumed = fresh()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                entry = resumed.resume(manager)
            fell_back = any("falling back to epoch 1" in str(w.message)
                            for w in caught)
            if entry["epoch"] != 1 or not fell_back or \
                    not equal(state(resumed), saved1):
                raise AssertionError(f"resnet_resume: after truncating "
                                     f"epoch 2, resume gave epoch "
                                     f"{entry['epoch']} (fallback "
                                     f"{fell_back})")
            tail = [step(resumed, i) for i in range(rr["steps"],
                                                    cfg["steps"])]
            after = state(resumed)
            launches = opt_step.opt_sgd.launches - launches0
        lrs = [t[0] for t in trace]
        want = sched()
        want.base_lr = RESNET50["lr"]
        if [t[0] for t in tail] != lrs[rr["steps"]:] or lrs != [
                want(t) for t in range(cfg["steps"])]:
            raise AssertionError(f"resnet_resume: lrs {lrs} then "
                                 f"{[t[0] for t in tail]}")
        bitwise = equal(after, final) and \
            [t[1] for t in tail] == [t[1] for t in trace[rr["steps"]:]]
        if not bitwise:
            diffs = {k: float((after[k].float() - final[k].float()).abs()
                              .max()) for k in final
                     if not torch.equal(after[k], final[k])}
            raise AssertionError(f"resnet_resume: the resumed run differs "
                                 f"from the uninterrupted one: {diffs}")
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"phase": "resnet_resume", "config": cfg, "schedule": rr,
           "lrs": lrs, "losses": [t[1] for t in trace],
           "resumed_losses": [t[1] for t in tail],
           "state_equal_after_resume": True, "fallback_taken": True,
           "bitwise_equal_to_uninterrupted": bitwise,
           "rng_key_bytes": int(resumed._state_payload()["__rng_key__"]
                                .size),
           "opt_sgd_launches": launches}
    if launches != 2 * cfg["steps"] - rr["steps"]:
        raise AssertionError(f"resnet_resume: {launches} K1 launches")
    emit(out)
    return launches


def _resnet_group(name):
    """The ResNet step's kernel groups, by kernel name."""
    low = name.lower()
    for group, keys in (
            ("k1", ("opt_step_kernel",)),
            ("batchnorm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm",
                           "welford")),
            ("conv_backward", ("dgrad", "wgrad", "backward_data",
                               "backward_filter", "bwd_data", "bwd_filter")),
            ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
            # cuDNN's FFT convolutions: complex GEMMs and the transforms,
            # forward or backward by name alone
            ("conv_fft", ("cf32", "fft")),
            ("conv_forward", ("fprop", "conv", "xmma", "implicit",
                              "winograd", "cudnn")),
            ("pooling", ("pool",)),
            ("gemm", ("gemm", "cublas", "cutlass")),
            ("copies", ("memcpy", "memset", "copy")),
            ("elementwise", ("elementwise", "reduce", "softmax",
                             "threshold", "fill", "where"))):
        if any(k in low for k in keys):
            return group
    return "other"


def _resnet_k1_timing(st):
    """K1 over the trainer's tensors (their shapes and weight decays) on
    random operands: bit for bit against the plain version, then by CUDA
    events, the profiler's kernel time and the host's time per call,
    beside ``torch.optim.SGD(momentum=0.9, fused=True)`` over the same
    tensors (the library yardstick)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    shapes = [tuple(h.shape) for h in st._train_handles]
    wds = [st._wd * m for m in st._wd_mult]
    n = sum(math.prod(sh) for sh in shapes)
    lr = torch.tensor(RESNET50["lr"], device=dev)
    hyper = {"momentum": RESNET50["momentum"]}
    e = kernels.entry("opt_sgd")
    base = _opt_inputs(shapes, gen, dev)
    got, want = _clone(base), _clone(base)
    _run_opt("opt_sgd", e.kernel, got, lr, wds, hyper)
    _run_opt("opt_sgd", e.plain, want, lr, wds, hyper)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for k in ("w", "m")
              for a, b in zip(got[k], want[k]))
    if err != 0.0:
        raise AssertionError(f"K1 at the ResNet-50 shapes differs from its "
                             f"plain version by {err}")
    params = [torch.nn.Parameter(w.clone()) for w in base["w"]]
    for p, g in zip(params, base["g"]):
        p.grad = g.clone()
    groups = [{"params": [p for p, wd in zip(params, wds) if wd],
               "weight_decay": RESNET50["wd"]},
              {"params": [p for p, wd in zip(params, wds) if not wd],
               "weight_decay": 0.0}]
    library = torch.optim.SGD(groups, lr=RESNET50["lr"],
                              momentum=RESNET50["momentum"], fused=True)

    def kernel():
        _run_opt("opt_sgd", e.kernel, got, lr, wds, hyper)

    return {"tensors": len(shapes), "values": n, "max_abs_err": err,
            "ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
            "host_us": _host_us(kernel),
            "plain_ms": cuda_ms(lambda: _run_opt(
                "opt_sgd", e.plain, want, lr, wds, hyper), iters=3),
            "bound_ms": 20 * n / H100_BYTES_S * 1e3, "bound_by": "bytes",
            "library_ms": cuda_ms(library.step),
            "library_device_ms": device_ms(library.step)}


def phase_resnet50_train(smi):
    """resnet50_v1_train: ``bench.py:275-303`` with BENCH_DTYPE=float32
    through the port's entry points, at full width: ``mx.random.seed(0)``,
    ``vision.get_model("resnet50_v1", classes=1000)``, Xavier weights on
    the card (from a seeded generator), ``nd.random.uniform`` batch of
    128 x 3 x 224 x 224 with random labels, ``ShardedTrainer`` "sgd" (lr
    0.05, momentum 0.9, wd 1e-4) on ``DeviceMesh({"dp": 1})`` with
    ``nan_guard=False``; TF32 off. 3 warm-up and 10 timed steps: step
    time (host clock to a synchronise), img/s, peak memory, the loss
    (finite and falling), the stem BatchNorm's running mean off zero, K1
    one launch a step over all 193 tensors on its 16-byte path; then one
    profiled step split by kernel group, and K1 timed over the same 193
    tensors beside ``torch.optim``'s fused SGD."""
    return _resnet50_train(smi, "resnet50_v1_train", "float32", False)


def phase_resnet50_train_bf16(smi, mp):
    """resnet50_v1_train_bf16 (``mp`` False): bench.py's default dtype,
    ``net.cast("bfloat16")`` before the first forward and ``x.astype``,
    else as resnet50_v1_train. Routes: the 87 bfloat16 tensors through
    the plain ``sgd_mom_update`` in bfloat16, K1 one launch a step over
    the 106 float32 BatchNorm tensors (the JAX package's bfloat16 step
    sends those to its Pallas ``opt_sgd`` too). resnet50_v1_train_bf16_mp
    (``mp`` True): the same with ``"multi_precision": True``: K1 one launch
    a step over all 193 float32 tensors, the 87 masters among them, and
    the two casts around it (bfloat16 gradients into float32 buffers,
    masters into the bfloat16 weights) timed alone at the same shapes."""
    phase = "resnet50_v1_train_bf16" + ("_mp" if mp else "")
    return _resnet50_train(smi, phase, "bfloat16", mp)


def _resnet50_net(cfg, dev, dtype):
    """bench.py's set-up: the seeded model, Xavier weights, cast, the
    ``nd.random.uniform`` batch (cast) and random labels."""
    mx.random.seed(0)
    net = vision.get_model(cfg["model"], classes=cfg["classes"])
    net.initialize(mx.init.Xavier(), ctx=dev,
                   generator=torch.Generator().manual_seed(0))
    if dtype != "float32":
        net.cast(dtype)
    x = mx.nd.random.uniform(shape=(cfg["batch"], 3, cfg["size"],
                                    cfg["size"]), ctx=dev)
    if dtype != "float32":
        x = x.astype(dtype)
    y = mx.nd.array(np.random.RandomState(0).randint(
        0, cfg["classes"], cfg["batch"]).astype(np.float32), ctx=dev)
    return net, x, y


def _profile_step(st, x, y):
    """One step under ``torch.profiler``: the window's host ms, device ms
    by ``_resnet_group`` and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.step(x, y)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    return {"profiled_step_ms": window_ms, **_kernel_groups(prof, window_ms)}


def _kernel_groups(prof, window_ms, group=None):
    """A profiled window's device ms by ``group`` (``_resnet_group``
    unless given), its busy and idle shares and its heaviest kernels."""
    group = group or _resnet_group
    from torch.autograd import DeviceType

    groups, top = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.self_device_time_total <= 0 or \
                getattr(ev, "is_user_annotation", False):
            continue
        g = group(ev.key)
        groups[g] = groups.get(g, 0.0) + ev.self_device_time_total / 1e3
        top[ev.key] = top.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(groups.values())
    return {"device_ms_per_step": busy if groups else "not measured",
            "device_idle_share": 1 - busy / window_ms if groups
            else "not measured",
            "device_ms_by_group": groups,
            "top_kernels_ms": [[k[:90], v, group(k)] for k, v in
                               sorted(top.items(), key=lambda kv: -kv[1])
                               [:15]]}


def _cast_timing(st):
    """The two casts around K1 of a multi-precision step, alone, on the
    trainer's own buffers: the bfloat16 gradients (random, the weights'
    shapes) into the float32 gradient buffers, and the masters into the
    bfloat16 weights (here into scratch copies), by CUDA events and the
    profiler; 6 bytes a value each."""
    masters = [st._opt_state[i][0] for i in st._routes.master]
    halves = [torch.empty_like(st._train_handles[i]._data)
              for i in st._routes.master]
    grads = [torch.randn_like(m).to(torch.bfloat16) for m in masters]
    n = sum(m.numel() for m in masters)

    def grad_cast():
        torch._foreach_copy_(st._grads32, grads)

    def weight_cast():
        torch._foreach_copy_(halves, masters)

    out = {"values": n, "bound_ms": 6 * n / H100_BYTES_S * 1e3,
           "bound_by": "bytes"}
    for name, fn in (("grad_to_float32", grad_cast),
                     ("master_to_bfloat16", weight_cast)):
        out[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
                     "kernels_us": kernel_device_us(fn)}
    return out


def _resnet50_train(smi, phase, dtype, mp):
    cfg = RESNET50
    dev = mx.gpu(0)
    net, x, y = _resnet50_net(cfg, dev, dtype)
    net(x)   # resolve the deferred shapes (eval mode: no statistics move)
    st = _resnet_trainer(net, dev, False, mp)
    n_values = sum(h.size for h in st._train_handles)
    if (len(st._param_names), len(st._aux_names), n_values) != (
            cfg["tensors"], cfg["aux"], cfg["values"]):
        raise AssertionError(f"{phase}: {len(st._param_names)} "
                             f"trainable tensors ({n_values} values), "
                             f"{len(st._aux_names)} aux")
    census = st._routes.census()
    if dtype == "float32":
        want_census = {"float32": cfg["tensors"], "master": 0, "half": 0}
    else:
        b = RESNET50_BF16
        want_census = {"float32": b["float32"], "master": b["half"] * mp,
                       "half": b["half"] * (not mp)}
    if census != want_census:
        raise AssertionError(f"{phase}: routes {census}, expected "
                             f"{want_census}")
    k1_tensors = census["float32"] + census["master"]
    stem = net.features[1].running_mean
    stem0 = stem.data()._data.clone()
    steps = cfg["warmup"] + cfg["steps"]
    pool0 = _pool_bytes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    site0 = _site_stats("trainer")
    sgd = opt_step.opt_sgd
    paths, copies = dict(sgd.tensors_by_path), sgd.copies
    routes0 = dict(st.route_counts)
    kernels.reset_launch_counts()
    losses, step_ms = [], []
    for k in range(steps):
        if k == cfg["warmup"]:
            aux_ptrs = [h._data.data_ptr() for h in st._aux_handles]
            counts_warm = kernels.launch_counts()
        t0 = time.perf_counter()
        loss = st.step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss._data.float()))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    pool = _pool_bytes() - pool0
    site = _site_stats("trainer")
    captured = {"captures": site["captures"] - site0["captures"],
                "capture_ms": site["capture_ms"] - site0["capture_ms"],
                "replays": site["replays"] - site0["replays"],
                "graph_pool_bytes": pool,
                "k1_launches_per_replay": (counts["opt_sgd"]
                                           - counts_warm["opt_sgd"])
                / cfg["steps"],
                "statistics_data_ptr_kept": [
                    h._data.data_ptr() for h in st._aux_handles]
                == aux_ptrs}
    if captured["captures"] != 1 or captured["replays"] != steps - 1 or \
            captured["k1_launches_per_replay"] != 1 or \
            not captured["statistics_data_ptr_kept"]:
        raise AssertionError(f"{phase}: captured steps {captured}")
    paths, copies = _opt_paths(sgd, paths), sgd.copies - copies
    routes = {k: v - routes0[k] for k, v in st.route_counts.items()}
    want = dict.fromkeys(counts, 0)
    want["opt_sgd"] = steps
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")
    if paths != {"vec4": k1_tensors * steps, "scalar": 0} or copies:
        raise AssertionError(f"{phase}: K1's tensors by path {paths}, "
                             f"{copies} gradient copies")
    if routes != {k: v * steps for k, v in want_census.items()}:
        raise AssertionError(f"{phase}: route counts {routes} over "
                             f"{steps} steps")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss not finite and falling: "
                             f"{losses}")
    stem_mean = stem.data()._data
    if torch.equal(stem_mean, stem0) or not bool(
            torch.isfinite(stem_mean).all()):
        raise AssertionError(f"{phase}: the stem BatchNorm's running mean "
                             "did not move")
    if mp and not all(torch.equal(st._train_handles[i]._data,
                                  st._opt_state[i][0].to(torch.bfloat16))
                      for i in st._routes.master):
        raise AssertionError(f"{phase}: a bfloat16 weight is not its "
                             "master rounded")
    prof = _profile_step(st, x, y)
    captured.update(_resnet_eager_beside(st, x, y, phase, cfg, step_ms,
                                         pool, mp))
    timed = step_ms[cfg["warmup"]:]
    median = statistics.median(timed)
    out = {"phase": phase, "card": smi, "config": cfg, "dtype": dtype,
           "multi_precision": mp, "tf32": False, "losses": losses,
           "step_ms": step_ms, "median_step_ms": median,
           "min_step_ms": min(timed), "max_step_ms": max(timed),
           "img_per_s": cfg["batch"] / (median / 1e3),
           "memory_allocated_before": before, "max_memory_allocated": peak,
           "launches": counts, "k1_tensors_by_path": paths,
           "routes_per_step": census,
           "stem_running_mean_abs_mean": float(stem_mean.abs().mean()),
           "captured": captured, **prof}
    if dtype == "float32":
        out["k1"] = _resnet_k1_timing(st)
    else:
        out["k1_in_step"] = {
            "tensors": k1_tensors, "values": sum(
                st._train_handles[i].size for i in st._routes.fused),
            "device_ms": prof["device_ms_by_group"].get("k1",
                                                        "not measured"),
            "bound_ms": 20 * sum(st._train_handles[i].size
                                 for i in st._routes.fused)
            / H100_BYTES_S * 1e3, "bound_by": "bytes"}
        out["tpu_kernels_on_path"] = (
            f"K1 over {k1_tensors} float32 tensors a step"
            + (" (87 masters and the 106 BatchNorm gamma/beta)" if mp else
               " (the BatchNorm gamma/beta; the 87 bfloat16 tensors take "
               "the plain sgd_mom_update route, which had no TPU kernel)"))
    if mp:
        out["casts"] = _cast_timing(st)
    emit(out)
    del st, net, x, y
    torch.cuda.empty_cache()
    return out


def _resnet_eager_beside(st, x, y, phase, cfg, captured_ms, pool, mp):
    """The captured ResNet-50 step beside the eager one (the compile
    service off), on the same trainer: one step of each from one state
    (each tensor within 5% of the eager update's L2 norm); eager blocks
    of 3 + 10 and 10 steps, then 10 captured (with the phase's first
    3 + 10 captured ones, A B B A); each mode's peak memory (the
    captured one's with its graph pool, at most 1.25 times eager's);
    a profiled eager step; then the guard: a second trainer
    (``nan_guard=True``) over the same network, a good step and a
    replayed step on a batch holding a NaN, after which every weight,
    momentum, master and statistic is ``torch.equal`` to before."""
    names = list(st._state_tensors())
    start = _snapshot(st)
    pair, kept = _trainer_blocks(st, x, y, [("captured", 1), ("eager", 1)],
                                 start=start, snaps=(1,))
    # a weight's step and its momentum's are held to the L2 norm of the
    # new momentum, which SGD with momentum adds to the weight
    # (tests/test_torch_resnet_train.py's measure): the momentum's own
    # change nears zero as a repeated batch's momentum settles
    want = dict(zip(names, kept["eager"][1]))
    moms = [float(want[f"s{i}_{len(per) - 1}"].float().norm())
            for i, per in enumerate(st._opt_state)]
    scales = {}
    for i, per in enumerate(st._opt_state):
        # a convolution's bias that feeds BatchNorm (the bottlenecks'
        # 1x1 convolutions) has a true gradient of zero: BatchNorm
        # subtracts the batch mean. Its step is rounding noise in either
        # run, so it is held to the largest step of any tensor
        name = st._param_names[i]
        mom = max(moms) if "conv" in name and name.endswith("bias") \
            else moms[i]
        scales[f"p{i}"] = mom
        scales.update((f"s{i}_{j}", mom) for j in range(len(per)))
    agree = _step_agreement(kept["captured"][1], kept["eager"][1], start[0],
                            names, scales)
    if agree["max_share"] > CAPTURE_RESNET_STEP_L2:
        raise AssertionError(f"{phase}: captured against eager {agree}")
    blocks, _ = _trainer_blocks(st, x, y, [
        ("eager", cfg["warmup"] + cfg["steps"]), ("eager", cfg["steps"]),
        ("captured", cfg["steps"])])
    eager_ms = blocks[0]["step_ms"][cfg["warmup"]:] + blocks[1]["step_ms"]
    captured_ms = captured_ms[cfg["warmup"]:] + blocks[2]["step_ms"]
    peak = {"captured_added": blocks[2]["peak_added"],
            "captured_with_pool": blocks[2]["peak_added"] + pool,
            "eager_added": blocks[0]["peak_added"],
            "max_memory_allocated": [b["max_memory_allocated"]
                                     for b in blocks]}
    ratio = peak["captured_with_pool"] / peak["eager_added"]
    if ratio > CAPTURE_PEAK_RATIO:
        raise AssertionError(f"{phase}: captured peak {peak}")
    eager_prof = _eager(_profile_step, st, x, y)
    guard = _resnet_trainer(st._net, mx.gpu(0), True, mp)
    guard.step(x, y)                         # eager, then captured
    bad = mx.nd.NDArray(x._data.clone())
    bad._data[3, 1, 5, 7] = float("nan")
    before = _snapshot(guard)[0]
    ptrs = [t.data_ptr() for t in guard._state_tensors().values()]
    site0 = compile_service.stats()["trainer"]["replays"]
    loss = float(guard.step(bad, y)._data.float())
    after = list(guard._state_tensors().values())
    restored = all(torch.equal(a, b) for a, b in zip(before, after)) and \
        [t.data_ptr() for t in after] == ptrs
    replayed = compile_service.stats()["trainer"]["replays"] - site0
    if math.isfinite(loss) or guard.skipped_steps != 1 or not restored \
            or replayed != 1:
        raise AssertionError(f"{phase}: the NaN step: loss {loss}, "
                             f"skipped {guard.skipped_steps}, restored "
                             f"{restored}, replays {replayed}")
    del guard, before, after, kept
    return {"vs_eager_one_step": agree, "step_l2_tol": CAPTURE_RESNET_STEP_L2,
            "median_step_ms_abba": {"captured": statistics.median(
                captured_ms), "eager": statistics.median(eager_ms)},
            "block_medians_ms": {
                "captured": [statistics.median(captured_ms[:cfg["steps"]]),
                             statistics.median(blocks[2]["step_ms"])],
                "eager": [statistics.median(blocks[0]["step_ms"][
                    cfg["warmup"]:]), statistics.median(
                        blocks[1]["step_ms"])]},
            "abba_order": ["captured", "eager", "eager", "captured"],
            "eager_step_ms": [b["step_ms"] for b in blocks[:2]],
            "captured_step_ms_last_block": blocks[2]["step_ms"],
            "peak_memory": peak, "peak_captured_over_eager": ratio,
            "eager_profiled_step": {k: eager_prof[k] for k in (
                "profiled_step_ms", "device_ms_per_step",
                "device_idle_share")},
            "nan_step": {"loss": loss, "skipped_steps": 1,
                         "restored_bit_for_bit": restored,
                         "replayed": replayed == 1}}


def _train_then_evaluate(net, x, graph_bytes, rounds=3):
    """Rounds of a training-mode forward (BatchNorm writes its running
    statistics in place) and an evaluation of the hybridized ``net``:
    the training forward is the op's pair (eager in round 0, captured in
    round 1, replayed after), the evaluation keeps its graph and replays
    with the new statistics (each replay equals the eager forward); the
    op ends with two entries, the statistics keep their storage, and the
    allocator's graph pools stay within half a graph (``graph_bytes``)
    of where they were after the pair's capture."""
    op = net._cached_op
    st0, pool0 = op.stats(), _pool_bytes()
    stats = [p.data()._data for p in net.collect_params().values()
             if p.grad_req == "null"]
    ptrs = [t.data_ptr() for t in stats]
    pool = []
    for i in range(rounds):
        with mx.autograd.train_mode():
            net(x)
        _held(net(x)._data, _eager(net, x)._data,
              f"evaluation after training round {i}")
        pool.append(_pool_bytes())
    st = op.stats()
    grew = max(pool[1:]) - pool[1]
    kept = [t.data_ptr() for t in stats] == ptrs
    if len(st["entries"]) != 2 or st["captures"] - st0["captures"] != 1 \
            or grew > graph_bytes / 2 or not kept:
        raise AssertionError(
            f"train then evaluate: {len(st['entries'])} entries, "
            f"{st['captures'] - st0['captures']} captures in {rounds} "
            f"rounds, graph pools grew by {grew} bytes after the pair's "
            f"capture (one graph: {graph_bytes}), statistics kept {kept}")
    return {"rounds": rounds, "entries": len(st["entries"]),
            "captures": st["captures"] - st0["captures"],
            "capture_ms": st["capture_ms"] - st0["capture_ms"],
            "statistics_data_ptr_kept": kept,
            "pool_bytes_before": pool0, "pool_bytes_after_each": pool}


def phase_resnet50_infer_bf16(smi):
    """resnet50_v1_infer_bf16: ``bench.py:199-223`` in bfloat16 through
    the port: the seeded model, Xavier weights, ``net.cast("bfloat16")``,
    ``hybridize(static_alloc=True, static_shape=True)``, a batch of 128
    from ``nd.random.uniform`` cast to bfloat16, 2 warm-up forwards (the
    first resolves the deferred shapes eagerly, the second captures the
    forward as one CUDA graph) and 20 timed ones (host clock to a
    synchronise): img/s and peak memory. The same 20 forwards eagerly
    (``compile.set_enabled(False)``), in A B B A order with the replays,
    and the replay against the eager forward, bit for bit. Then the same
    weights widened to float32 in a second net and the same
    (bfloat16-rounded) batch: top-1 agreement and the largest logit gap;
    one forward with cuBLAS's reduced-precision bfloat16 reductions
    allowed, against the pinned run (only the Dense product reads that
    switch: cuDNN's convolutions do not; the switch is part of the
    graph's key, so that forward runs eagerly and captures anew, and so
    does the next pinned one); and three rounds of a
    training-mode forward and an evaluation (``_train_then_evaluate``:
    one graph kept, pools flat)."""
    cfg, b = RESNET50, RESNET50_BF16
    dev = mx.gpu(0)
    net, x, _ = _resnet50_net(cfg, dev, "bfloat16")
    net.hybridize(static_alloc=True, static_shape=True)
    pools = _pool_bytes()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for _ in range(b["infer_warmup"]):
        net(x)
    peak_warmup = torch.cuda.max_memory_allocated()
    pools = _pool_bytes() - pools
    torch.cuda.reset_peak_memory_stats()
    capture = net._cached_op.stats()
    if capture["captures"] != 1:
        raise AssertionError(f"resnet50_v1_infer_bf16: {capture}")

    def timed(outs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[:] = [net(x) for _ in range(b["infer_iters"])]
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"captured": [], "eager": []}
    outs, eager_outs = [], []
    for mode in ("captured", "eager", "eager", "captured"):
        if mode == "eager":
            walls[mode].append(_eager(timed, eager_outs))
        else:
            walls[mode].append(timed(outs))
    wall = statistics.mean(walls["captured"])
    wall_eager = statistics.mean(walls["eager"])
    peak = torch.cuda.max_memory_allocated()
    logits = outs[-1]._data.float()
    held = _held(outs[-1]._data, eager_outs[-1]._data,
                 "resnet50_v1_infer_bf16")
    if tuple(logits.shape) != (cfg["batch"], cfg["classes"]) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("resnet50_v1_infer_bf16: logits not finite "
                             f"of shape {(cfg['batch'], cfg['classes'])}")
    if not all(torch.equal(o._data, outs[0]._data) for o in outs[1:]):
        raise AssertionError("resnet50_v1_infer_bf16: forwards of one "
                             "batch differ")
    net32 = vision.get_model(cfg["model"], classes=cfg["classes"])
    net32.initialize(ctx=dev)
    load_jax_params(net32, export_params(net))
    ref = net32(x.astype("float32"))._data
    del net32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        reduced = net(x)._data.float()
    finally:
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
    net(x)                      # the pinned forward, captured anew
    train_eval = _train_then_evaluate(net, x, pools)
    gap = float((logits - ref).abs().max())
    agree = float((logits.argmax(1) == ref.argmax(1)).float().mean())
    out = {"phase": "resnet50_v1_infer_bf16", "card": smi,
           "batch": cfg["batch"], "warmup": b["infer_warmup"],
           "iters": b["infer_iters"],
           "img_per_s": cfg["batch"] * b["infer_iters"] / wall,
           "ms_per_batch": wall / b["infer_iters"] * 1e3,
           "img_per_s_eager": cfg["batch"] * b["infer_iters"] / wall_eager,
           "ms_per_batch_eager": wall_eager / b["infer_iters"] * 1e3,
           "walls_s_abba": walls, "capture": capture,
           "replay_vs_eager": held, "graph_pool_bytes": pools,
           "train_then_evaluate": train_eval,
           "max_memory_allocated_warmup_and_capture": peak_warmup,
           "memory_allocated_before": before, "max_memory_allocated": peak,
           "top1_agreement_with_float32": agree,
           "max_logit_gap_vs_float32": gap,
           "max_abs_logit_float32": float(ref.abs().max()),
           "reduced_precision_reduction_max_logit_change": float(
               (reduced - logits).abs().max())}
    emit(out)
    del net, x, outs, eager_outs
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ the Module path --
class SyntheticDataIter(mx.io.DataIter):
    """``examples/image_classification/common/data.py:45-74`` over the
    port: ONE device-resident random batch yielded ``epoch_size`` times,
    so the measured img/s is the training step's with no input pipeline
    in the loop."""

    def __init__(self, num_classes, data_shape, epoch_size, dtype="float32"):
        super().__init__(batch_size=data_shape[0])
        self.batch_size = data_shape[0]
        self.epoch_size = epoch_size
        rs = np.random.RandomState(0)
        x = rs.uniform(-1, 1, data_shape).astype(np.float32)
        y = rs.randint(0, num_classes, data_shape[0]).astype(np.float32)
        self._data = mx.nd.array(x).astype(dtype)
        self._label = mx.nd.array(y)
        self._cur = 0
        self.provide_data = [mx.io.DataDesc("data", data_shape, dtype)]
        self.provide_label = [mx.io.DataDesc("softmax_label",
                                             (data_shape[0],), "float32")]

    def reset(self):
        self._cur = 0

    def next(self):
        if self._cur >= self.epoch_size:
            raise StopIteration
        self._cur += 1
        return mx.io.DataBatch(data=[self._data], label=[self._label],
                               pad=0, provide_data=self.provide_data,
                               provide_label=self.provide_label)


def export_symbol(name, num_classes, image_shape):
    """The model zoo's network ``name`` exported as a Symbol (its weights,
    from a seeded draw, are dropped: ``fit`` initializes every
    parameter)."""
    net = vision.get_model(name, classes=num_classes)
    net.initialize(mx.init.Xavier(), generator=torch.Generator().manual_seed(0))
    net(mx.nd.zeros((1,) + tuple(image_shape)))
    with tempfile.TemporaryDirectory() as d:
        net.export(os.path.join(d, "net"), 0)
        sym, _, _ = mx.model.load_checkpoint(os.path.join(d, "net"), 0)
    return sym


def get_network(name, num_classes, image_shape, heads=("SoftmaxOutput",)):
    """``examples/image_classification/train_imagenet.py:29-45`` over the
    port: the model zoo's network exported as a Symbol (its weights, from
    a seeded draw, are dropped: ``fit`` initializes every parameter) with
    a SoftmaxOutput head. With several ``heads``, ``{head: symbol}`` over
    the one exported network; ``"Custom"`` is MXNet's
    ``example/numpy-ops/custom_softmax.py`` head, ``mx.sym.Custom(net,
    op_type="softmax", name="softmax")`` (its label input the variable
    ``softmax_label``, as SoftmaxOutput's)."""
    sym = export_symbol(name, num_classes, image_shape)
    out = {}
    for head in heads:
        if head == "Custom":
            register_custom_softmax()
            out[head] = mx.sym.Custom(sym, op_type="softmax", name="softmax")
        else:
            out[head] = mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                             name="softmax")
    return out if len(heads) > 1 else out[heads[0]]


class Softmax(mx.operator.CustomOp):
    """MXNet 1.x's ``example/numpy-ops/custom_softmax.py`` operator, as
    that example writes it: numpy on the host."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
        y /= y.sum(axis=1).reshape((x.shape[0], 1))
        self.assign(out_data[0], req[0], mx.nd.array(y))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        label = in_data[1].asnumpy().ravel().astype(int)
        y = out_data[0].asnumpy()
        y[np.arange(label.shape[0]), label] -= 1.0
        self.assign(in_grad[0], req[0], mx.nd.array(y))


class SoftmaxProp(mx.operator.CustomOpProp):
    """The example's prop: a loss head (``need_top_grad=False``) with a
    label argument of shape ``(batch,)``."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        data_shape = in_shape[0]
        label_shape = (in_shape[0][0],)
        output_shape = in_shape[0]
        return [data_shape, label_shape], [output_shape], []

    def create_operator(self, ctx, shapes, dtypes):
        return Softmax()


def register_custom_softmax():
    """``mx.operator.register("softmax")`` of :class:`SoftmaxProp`."""
    mx.operator.register("softmax")(SoftmaxProp)


def _lr_scheduler(cfg):
    """``common/fit.py:20-39`` (``_get_lr_scheduler``) from epoch 0: the
    factor schedule at ``lr_step_epochs`` of ``num_examples //
    batch_size`` batches."""
    epoch_size = cfg["num_examples"] // cfg["batch"]
    steps = [epoch_size * int(e) for e in cfg["lr_step_epochs"].split(",")]
    return cfg["lr"], mx.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=cfg["lr_factor"], base_lr=cfg["lr"])


def module_fit(cfg, model, train, batch_end_callbacks):
    """``common/fit.py:106-163`` (``fit``) for ``--benchmark 1``: a
    kvstore object of ``cfg["kv_store"]`` (``local`` by default; fit.py:70
    creates ``args.kv_store``), ``cfg["optimizer"]`` ("sgd" by default; with
    momentum for sgd, nag, signum and lbsgd, as fit.py:131) and weight
    decay under the lr schedule, ``Xavier(rnd_type="gaussian", factor_type="in",
    magnitude=2)``, the "accuracy" metric, ``Speedometer(batch_size,
    disp_batches)`` (then ``batch_end_callbacks``), no checkpoint prefix,
    no validation data, ``allow_missing=True``, one epoch."""
    kv = mx.kv.create(cfg.get("kv_store", "local"))
    lr, lr_scheduler = _lr_scheduler(cfg)
    optimizer = cfg.get("optimizer", "sgd")
    optimizer_params = {"learning_rate": lr, "wd": cfg["wd"],
                        "lr_scheduler": lr_scheduler}
    if optimizer in ("sgd", "nag", "signum", "lbsgd"):
        optimizer_params["momentum"] = cfg["mom"]
    initializer = mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)
    model.fit(train, begin_epoch=0, num_epoch=1, eval_data=None,
              eval_metric=["accuracy"], kvstore=kv, optimizer=optimizer,
              optimizer_params=optimizer_params, initializer=initializer,
              arg_params=None, aux_params=None,
              batch_end_callback=[mx.callback.Speedometer(
                  cfg["batch"], cfg["disp_batches"])] + batch_end_callbacks,
              epoch_end_callback=None, allow_missing=True, monitor=None)


class _LogLines(logging.Handler):
    """The root logger's INFO lines of a run, and ``Speedometer``'s
    samples/sec among them."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines, self.speeds = [], []

    def emit(self, record):
        msg = record.getMessage()
        self.lines.append(msg)
        m = re.search(r"Speed: ([0-9.]+) samples/sec", msg)
        if m:
            self.speeds.append(float(m.group(1)))


@contextlib.contextmanager
def _captured_log():
    root, handler = logging.getLogger(), _LogLines()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield handler
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _softmax_loss(probs, label):
    """Mean cross-entropy of SoftmaxOutput's probabilities."""
    p = probs._data.gather(1, label._data.long().view(-1, 1))
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def _module_split(prof):
    """Device ms of the Module path's own work in a profiled batch, by
    the op that launched each kernel (``FunctionEvent.kernels`` and its
    ``cpu_parent`` chain): the executor's gradient copies (the
    ``_foreach_copy_`` under ``module.forward_backward``), the kvstore's
    pull copies (the ``_foreach_copy_`` under ``module.update``) and
    SoftmaxOutput (its softmax kernel and its backward node). K1 is
    launched through ctypes, outside any op the profiler records: its
    time is the ``k1`` kernel group's."""
    out = dict.fromkeys(("executor_grad_copies", "kvstore_pull_copies",
                         "softmax_output"), 0.0)
    seen = False
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        seen = True
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in kernels:
            ms = k.duration / 1e3
            if "_foreach_copy" in e.name and \
                    "module.forward_backward" in chain:
                out["executor_grad_copies"] += ms
            elif "_foreach_copy" in e.name and "module.update" in chain:
                out["kvstore_pull_copies"] += ms
            elif "softmax" in k.name.lower() or any(
                    "SoftmaxOutput" in c for c in chain):
                out["softmax_output"] += ms
    return out if seen else dict.fromkeys(out, "not measured")


def _profile_module_batch(mod, batch, metric, group=None, extra=None):
    """One Module batch (``forward_backward``, ``update``,
    ``update_metric``, the calls ``fit`` makes) under ``torch.profiler``:
    device ms by kernel group, the Module path's own work
    (``_module_split``) and the idle share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("module.forward_backward"):
            mod.forward_backward(batch)
        with record_function("module.update"):
            mod.update()
        with record_function("module.update_metric"):
            mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    groups = _kernel_groups(prof, window_ms, group)
    split = _module_split(prof)
    split["k1"] = groups["device_ms_by_group"].get("k1", "not measured")
    for name, fn in (extra or {}).items():
        split[name] = fn(prof)
    return {"profiled_batch_ms": window_ms, **groups,
            "module_path_device_ms": split}


def _module_fit_once(cfg, net, train, dev, callbacks=()):
    """One ``module_fit`` of ``cfg["epoch_size"]`` batches (the compile
    service on or off, as the caller set it): the host clock at each
    batch end (card synchronised), the host ms of ``update()`` and
    ``update_metric()``, Speedometer's samples/sec, peak memory,
    launches, K1's tensors by path, the loss at the first and last batch
    and the training accuracy; the Module and its log."""
    model = mx.mod.Module(context=dev, symbol=net)
    if (len(model._param_names), len(model._aux_names)) != (
            cfg["tensors"], cfg["aux"]):
        raise AssertionError(f"module_fit: {len(model._param_names)} "
                             f"parameters, {len(model._aux_names)} aux")
    host = {"update": [], "update_metric": []}
    for name in host:
        def timed(*a, _fn=getattr(model, name), _ms=host[name], **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(model, name, timed)
    stamps, probe = [], {}

    def stamp(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def probe_batch(param):
        if param.nbatch in (0, cfg["epoch_size"] - 1):
            probe[param.nbatch] = _softmax_loss(
                model.get_outputs()[0],
                param.locals["data_batch"].label[0])
            probe["accuracy"] = dict(
                param.eval_metric.get_global_name_value())["accuracy"]

    sgd = opt_step.opt_sgd
    paths, copies = dict(sgd.tensors_by_path), sgd.copies
    train.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    site0 = _site_stats("executor")
    kernels.reset_launch_counts()
    t_fit = time.perf_counter()
    with _captured_log() as log:
        module_fit(cfg, model, train, [stamp, probe_batch] + list(callbacks))
    fit_s = time.perf_counter() - t_fit
    site = _site_stats("executor")
    batches = cfg["epoch_size"]
    batch_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    timed = batch_ms[cfg["warmup"] - 1:]   # batches 4..13
    return model, log, {
        "batch_ms": batch_ms, "median_batch_ms": statistics.median(timed),
        "min_batch_ms": min(timed), "max_batch_ms": max(timed),
        "fit_s": fit_s, "batch_ends": len(stamps),
        "speedometer_img_per_s": log.speeds,
        "update_host_ms": statistics.median(host["update"][cfg["warmup"]:]),
        "update_metric_host_ms": statistics.median(
            host["update_metric"][cfg["warmup"]:]),
        "memory_allocated_before": before,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": kernels.launch_counts(),
        "k1_tensors_by_path": _opt_paths(sgd, paths),
        "k1_gradient_copies": sgd.copies - copies,
        "executor_site": {k: site[k] - site0[k] for k in (
            "misses", "hits", "captures", "capture_ms", "replays")},
        "losses": [probe.get(0), probe.get(batches - 1)],
        "train_accuracy": probe.get("accuracy")}


def phase_resnet50_module_fit(smi, gluon=None):
    """resnet50_v1_module_fit: ``python train_imagenet.py --benchmark 1
    --network resnet50_v1`` through the port's ``Module.fit``
    (``MODULE_FIT``; epoch_size cut to 13 batches): ``get_network``,
    ``SyntheticDataIter`` and ``fit.fit``'s wiring copied above. Four
    fits, the executor captured (site ``executor``: the training pair's
    forward and backward graphs replayed each batch), eager
    (``compile.set_enabled(False)``), eager, captured; each: the host
    clock at each batch end (card synchronised), the host ms of
    ``update()`` and of ``update_metric()`` (which waits for the batch's
    device work: the metric's one copy to the host), Speedometer's own
    samples/sec, peak memory, launches by family (K1 one a batch over
    all 193 tensors on its 16-byte path, nothing else), a finite loss
    and the training accuracy; one more batch of the first fit of each
    mode profiled. ``gluon`` (resnet50_v1_train's line, same call) gives
    the excess of the Module batch over the gluon step."""
    t_phase = time.perf_counter()
    cfg = MODULE_FIT
    dev = mx.gpu(0)
    mx.random.seed(0)
    net = get_network(cfg["network"], cfg["num_classes"], cfg["image_shape"])
    train = SyntheticDataIter(cfg["num_classes"],
                              (cfg["batch"],) + tuple(cfg["image_shape"]),
                              cfg["epoch_size"])
    batches = cfg["epoch_size"]
    runs, profs, first = [], {}, {}
    for mode in ("captured", "eager", "eager", "captured"):
        prev = compile_service.set_enabled(mode == "captured")
        try:
            mx.random.seed(0)
            model, log, run = _module_fit_once(cfg, net, train, dev)
            if mode not in profs:
                metric = mx.metric.create(["accuracy"])
                train.reset()
                profs[mode] = _profile_module_batch(model, train.next(),
                                                    metric)
        finally:
            compile_service.set_enabled(prev)
        run["mode"] = mode
        runs.append(run)
        want = dict.fromkeys(run["launches"], 0)
        want["opt_sgd"] = batches
        site = run["executor_site"]
        want_site = {"misses": 1, "hits": batches - 1, "captures": 1,
                     "replays": 2 * (batches - 1)} if mode == "captured" \
            else {"misses": 0, "hits": 0, "captures": 0, "replays": 0}
        if run["launches"] != want:
            raise AssertionError(f"module_fit {mode}: launches "
                                 f"{run['launches']}, expected {want}")
        if run["k1_tensors_by_path"] != {"vec4": cfg["tensors"] * batches,
                                         "scalar": 0} or \
                run["k1_gradient_copies"]:
            raise AssertionError(f"module_fit {mode}: K1's tensors by "
                                 f"path {run['k1_tensors_by_path']}, "
                                 f"{run['k1_gradient_copies']} copies")
        if {k: site[k] for k in want_site} != want_site:
            raise AssertionError(f"module_fit {mode}: executor site "
                                 f"{site}, expected {want_site}")
        if not (model._update_on_kvstore and
                model._kvstore.type == "local"):
            raise AssertionError("module_fit: the update did not run on "
                                 "the local kvstore")
        if model._optimizer.rescale_grad != 1.0 / cfg["batch"]:
            raise AssertionError(f"module_fit: rescale_grad "
                                 f"{model._optimizer.rescale_grad}")
        if not all(v is not None and math.isfinite(v)
                   for v in run["losses"]) or \
                run["batch_ends"] != batches or not log.speeds:
            raise AssertionError(f"module_fit {mode}: losses "
                                 f"{run['losses']}, {run['batch_ends']} "
                                 f"batch ends, Speedometer {log.speeds}")
        first.setdefault(mode, {"log_tail": log.lines[-3:],
                                "loss_first": run["losses"][0],
                                "loss_last": run["losses"][1]})
        del model
        torch.cuda.empty_cache()
    timed = {m: [v for r in runs if r["mode"] == m
                 for v in r["batch_ms"][cfg["warmup"] - 1:]]
             for m in ("captured", "eager")}
    median = statistics.median(timed["captured"])
    median_eager = statistics.median(timed["eager"])
    cap = runs[0]
    out = {"phase": "resnet50_v1_module_fit", "card": smi, "config": cfg,
           "source": "examples/image_classification/train_imagenet.py "
                     "--benchmark 1 --network resnet50_v1",
           "tf32": False, "batches": batches,
           "abba_order": [r["mode"] for r in runs],
           "median_batch_ms": median, "median_batch_ms_eager": median_eager,
           "block_medians_ms": {m: [r["median_batch_ms"] for r in runs
                                    if r["mode"] == m]
                                for m in ("captured", "eager")},
           "img_per_s": cfg["batch"] / (median / 1e3),
           "img_per_s_eager": cfg["batch"] / (median_eager / 1e3),
           "batch_ms": cap["batch_ms"],
           "min_batch_ms": cap["min_batch_ms"],
           "max_batch_ms": cap["max_batch_ms"],
           "speedometer_img_per_s": cap["speedometer_img_per_s"],
           "speedometer_img_per_s_eager": runs[1]["speedometer_img_per_s"],
           "fit_s": [r["fit_s"] for r in runs],
           "update_host_ms": cap["update_host_ms"],
           "update_metric_host_ms": cap["update_metric_host_ms"],
           "update_metric_host_ms_eager": runs[1]["update_metric_host_ms"],
           "memory_allocated_before": cap["memory_allocated_before"],
           "max_memory_allocated": cap["max_memory_allocated"],
           "max_memory_allocated_eager": runs[1]["max_memory_allocated"],
           "launches": cap["launches"],
           "k1_tensors_by_path": cap["k1_tensors_by_path"],
           "executor_site": cap["executor_site"],
           "rescale_grad": 1.0 / cfg["batch"],
           "loss_first": first["captured"]["loss_first"],
           "loss_last": first["captured"]["loss_last"],
           "train_accuracy": cap["train_accuracy"],
           "log_tail": first["captured"]["log_tail"],
           **profs["captured"],
           "eager_profiled_batch": profs["eager"],
           "phase_s": time.perf_counter() - t_phase}
    if gluon is not None:
        out["gluon_median_step_ms"] = gluon["median_step_ms"]
        out["excess_over_gluon_step_ms"] = median - gluon["median_step_ms"]
    emit(out)
    del net, train
    torch.cuda.empty_cache()
    return out


class _HostOpMeter:
    """Within the scope, the host ms of each call of ``Softmax.forward``
    and ``Softmax.backward`` (the card synchronised before and after, so
    neither the preceding device work nor the tail of its own copies is
    another call's) and the bytes their ``asnumpy()`` calls read to the
    host and their ``mx.nd.array`` calls write to the card."""

    def __init__(self):
        self.ms = {"forward": [], "backward": []}
        self.bytes = {"forward": {"to_host": 0, "to_card": 0},
                      "backward": {"to_host": 0, "to_card": 0}}
        self._in = None

    def __enter__(self):
        self._saved = (Softmax.forward, Softmax.backward,
                       mx.nd.NDArray.asnumpy, mx.nd.array)
        meter = self
        fwd, bwd, asnumpy, array = self._saved

        def timed(name, fn):
            def run(op, *args, **kwargs):
                torch.cuda.synchronize()
                meter._in = name
                t0 = time.perf_counter()
                try:
                    return fn(op, *args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    meter.ms[name].append((time.perf_counter() - t0) * 1e3)
                    meter._in = None
            return run

        def counted_asnumpy(a):
            out = asnumpy(a)
            if meter._in is not None and a._data.is_cuda:
                meter.bytes[meter._in]["to_host"] += out.nbytes
            return out

        def counted_array(source, *args, **kwargs):
            out = array(source, *args, **kwargs)
            if meter._in is not None and out._data.is_cuda:
                meter.bytes[meter._in]["to_card"] += \
                    out._data.numel() * out._data.element_size()
            return out

        Softmax.forward = timed("forward", fwd)
        Softmax.backward = timed("backward", bwd)
        mx.nd.NDArray.asnumpy = counted_asnumpy
        mx.nd.array = counted_array
        return self

    def __exit__(self, *exc):
        (Softmax.forward, Softmax.backward, mx.nd.NDArray.asnumpy,
         mx.nd.array) = self._saved

    def summary(self, skip):
        """Medians after the first ``skip`` calls, and bytes a call."""
        out = {}
        for name in ("forward", "backward"):
            ms = self.ms[name]
            out[name] = {"calls": len(ms),
                         "median_host_ms": statistics.median(ms[skip:]),
                         "bytes_per_call": {k: v // max(len(ms), 1)
                                            for k, v in
                                            self.bytes[name].items()}}
        return out


def _params_now(model):
    """Host copies of a Module's parameters and aux states by name."""
    args, auxs = model.get_params()
    return {n: a.asnumpy() for n, a in dict(args, **auxs).items()}


def _update_agreement(got, want, start, floor):
    """Per tensor, ``|got - want| / max(|want - start|, floor * the
    largest |want - start|)`` (L2 norms): how far one fit's change of
    each tensor lies from another's, on a floor for tensors that hardly
    move (a convolution's bias feeding a train-mode BatchNorm has a true
    gradient of 0, so two runs move it by rounding noise alone); the
    largest, the three worst, and the largest among tensors above the
    floor."""
    steps = {n: float(np.linalg.norm(want[n] - start[n])) for n in want}
    bar = floor * max(steps.values())
    shares = {n: float(np.linalg.norm(got[n] - want[n]))
              / max(steps[n], bar, 1e-30) for n in want}
    worst = sorted(shares, key=shares.get, reverse=True)[:3]
    moved = [shares[n] for n in want if steps[n] > bar]
    return {"max": shares[worst[0]],
            "worst": {n: [shares[n], steps[n]] for n in worst},
            "max_above_floor": max(moved) if moved else 0.0,
            "tensors_below_floor": len(want) - len(moved)}


def phase_resnet50_module_fit_custom(smi):
    """resnet50_v1_module_fit_custom: resnet50_v1_module_fit's fit
    (``MODULE_FIT``: ``train_imagenet.py --benchmark 1 --network
    resnet50_v1``, 13 batches) with the exported symbol's SoftmaxOutput
    head replaced by ``mx.sym.Custom(fc, op_type="softmax",
    name="softmax")``, whose operator is ``custom_softmax.py``'s numpy
    softmax on the host (``Softmax`` above). Four fits from one seed,
    Custom, SoftmaxOutput, SoftmaxOutput, Custom (A B B A, the compile
    service on): the median batch ms of each head; the Custom op's host
    ms forward and backward and the bytes each call copies each way
    (``_HostOpMeter``); the executor uncaptured for its named reason with
    the Custom head (no capture, no replay, 13 calls under the reason)
    and captured with SoftmaxOutput; K1 one launch a batch; the first
    update lowering the loss; each tensor's change after the first batch
    within ``CUSTOM_FIT_TOL`` of the SoftmaxOutput fit's (MXNet's custom
    softmax gradient, ``y - onehot(label)``, is SoftmaxOutput's with
    ``normalization="null"``, train_imagenet.py's default). The 13-batch
    change and losses are printed beside the two SoftmaxOutput fits' own
    agreement, and not held (``CUSTOM_FIT_TOL``'s comment)."""
    t_phase = time.perf_counter()
    cfg = MODULE_FIT
    dev = mx.gpu(0)
    nets = get_network(cfg["network"], cfg["num_classes"], cfg["image_shape"],
                       heads=("Custom", "SoftmaxOutput"))
    reason = "host op Custom(op_type='softmax')"
    if nets["Custom"].list_arguments() != \
            nets["SoftmaxOutput"].list_arguments():
        raise AssertionError("custom fit: the two heads' arguments differ")
    train = SyntheticDataIter(cfg["num_classes"],
                              (cfg["batch"],) + tuple(cfg["image_shape"]),
                              cfg["epoch_size"])
    # the weights every fit starts from (fit initializes from mx.random
    # after the same seed)
    mx.random.seed(0)
    probe = mx.mod.Module(context=dev, symbol=nets["SoftmaxOutput"])
    probe.bind(data_shapes=train.provide_data,
               label_shapes=train.provide_label)
    probe.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    start = _params_now(probe)
    del probe
    batches = cfg["epoch_size"]
    runs, finals, firsts, meters = [], {}, {}, []
    for head in ("Custom", "SoftmaxOutput", "SoftmaxOutput", "Custom"):
        uncap0 = dict(_site_stats("executor").get("uncaptured", {}))
        meter = _HostOpMeter()
        mx.random.seed(0)

        losses = []

        def after_first(param, _head=head, _losses=losses):
            model_ = param.locals["self"]
            _losses.append(_softmax_loss(
                model_.get_outputs()[0], param.locals["data_batch"].label[0]))
            if param.nbatch == 0:
                firsts.setdefault(_head, []).append(_params_now(model_))

        with meter:
            model, log, run = _module_fit_once(cfg, nets[head], train, dev,
                                               [after_first])
        uncap = dict(_site_stats("executor").get("uncaptured", {}))
        run["head"] = head
        run["uncaptured"] = {k: v - uncap0.get(k, 0)
                             for k, v in uncap.items()
                             if v - uncap0.get(k, 0)}
        finals.setdefault(head, []).append(_params_now(model))
        want = dict.fromkeys(run["launches"], 0)
        want["opt_sgd"] = batches
        if run["launches"] != want:
            raise AssertionError(f"custom fit {head}: launches "
                                 f"{run['launches']}, expected {want}")
        site = run["executor_site"]
        if head == "Custom":
            meters.append(meter.summary(cfg["warmup"]))
            ok = site["captures"] == site["replays"] == 0 and \
                run["uncaptured"] == {reason: batches}
        else:
            ok = site["captures"] == 1 and not run["uncaptured"]
        if not ok:
            raise AssertionError(f"custom fit {head}: executor site {site}, "
                                 f"uncaptured {run['uncaptured']}")
        run["batch_losses"] = losses
        # the first update lowers the one repeated batch's loss; the later
        # ones at lr 0.1 from scratch spike it (CUSTOM_FIT_TOL's comment)
        drop = CUSTOM_FIT_TOL["first_update_loss_drop"]
        if not (all(math.isfinite(v) for v in losses)
                and losses[1] < (1 - drop) * losses[0]):
            raise AssertionError(f"custom fit {head}: losses {losses}, the "
                                 f"first update lowered the loss by less "
                                 f"than {drop} of it")
        runs.append(run)
        del model
        torch.cuda.empty_cache()
    agree = {}
    floor = CUSTOM_FIT_TOL["floor"]
    for when, got in (("first_batch", firsts), ("fit", finals)):
        agree[when] = {
            "custom_vs_softmax_output": _update_agreement(
                got["Custom"][0], got["SoftmaxOutput"][0], start, floor),
            "softmax_output_vs_itself": _update_agreement(
                got["SoftmaxOutput"][1], got["SoftmaxOutput"][0], start,
                floor),
            "custom_vs_itself": _update_agreement(
                got["Custom"][1], got["Custom"][0], start, floor)}
    tol = {"first_batch": CUSTOM_FIT_TOL["first_batch"]}
    timed = {h: [v for r in runs if r["head"] == h
                 for v in r["batch_ms"][cfg["warmup"] - 1:]]
             for h in ("Custom", "SoftmaxOutput")}
    med = {h: statistics.median(v) for h, v in timed.items()}
    out = {"phase": "resnet50_v1_module_fit_custom", "card": smi,
           "config": cfg, "tf32": False, "batches": batches,
           "source": "examples/image_classification/train_imagenet.py "
                     "--benchmark 1 --network resnet50_v1, head: MXNet "
                     "1.x example/numpy-ops/custom_softmax.py",
           "abba_order": [r["head"] for r in runs],
           "median_batch_ms_custom": med["Custom"],
           "median_batch_ms_softmax_output": med["SoftmaxOutput"],
           "custom_minus_softmax_output_ms": med["Custom"]
           - med["SoftmaxOutput"],
           "block_medians_ms": {h: [r["median_batch_ms"] for r in runs
                                    if r["head"] == h] for h in med},
           "img_per_s_custom": cfg["batch"] / (med["Custom"] / 1e3),
           "custom_op_host": meters,
           "executor_site": {r["head"]: dict(r["executor_site"],
                                             uncaptured=r["uncaptured"])
                             for r in runs[:2]},
           "launches": runs[0]["launches"],
           "batch_losses": {r["head"]: r["batch_losses"] for r in runs},
           "first_losses_custom_vs_softmax_output": [
               abs(a - b) / b for a, b in zip(runs[0]["batch_losses"][:3],
                                              runs[1]["batch_losses"][:3])],
           "max_memory_allocated": {r["head"]: r["max_memory_allocated"]
                                    for r in runs[:2]},
           "update_agreement": agree, "tolerance": tol,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    bad = {w: agree[w]["custom_vs_softmax_output"] for w in tol
           if agree[w]["custom_vs_softmax_output"]["max"] > tol[w]}
    if bad:
        raise AssertionError(f"custom fit: the Custom head's updates "
                             f"differ from SoftmaxOutput's by {bad} of each "
                             f"tensor's change, beyond {tol}")
    del nets, train
    torch.cuda.empty_cache()
    return out


def _thumbnail_symbol(cfg):
    """The thumbnail of ``cfg`` exported (built on the CPU) with a
    SoftmaxOutput head, as ``get_network`` makes it."""
    net = vision.get_model(cfg["model"], classes=cfg["classes"],
                           thumbnail=True, prefix="modcheck_")
    net.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                   generator=torch.Generator().manual_seed(0))
    net(mx.nd.zeros((1, 3, cfg["size"], cfg["size"]), ctx=mx.cpu()))
    with tempfile.TemporaryDirectory() as d:
        net.export(os.path.join(d, "net"), 0)
        sym = mx.sym.load(os.path.join(d, "net-symbol.json"))
    return mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                name="softmax")


def _check_module(sym, ctx, cfg, arg_params=None, aux_params=None):
    """A Module of ``sym`` on ``ctx``, bound, initialized (Xavier from
    ``mx.random``, or the given parameters) and with the "sgd" optimizer
    on a local kvstore (``rescale_grad`` 1 / batch, the C8 default)."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (cfg["batch"], 3, cfg["size"], cfg["size"]))],
             [("softmax_label", (cfg["batch"],))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2),
                    arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(kvstore=mx.kv.create("local"), optimizer="sgd",
                       optimizer_params={"learning_rate": cfg["lr"],
                                         "momentum": cfg["momentum"],
                                         "wd": cfg["wd"]})
    return mod


def _module_state(mod):
    """The tensors a Module's step reads and writes: the bound weights,
    the store's weights, the momenta and the running statistics."""
    kv = mod._kvstore
    names = mod._param_names
    return {"w": [mod._exec.arg_dict[n]._data for n in names],
            "store": [kv._store[n]._data for n in names],
            "m": [kv._updater.states[n]._data for n in names
                  if n in kv._updater.states],
            "aux": [mod._exec.aux_dict[n]._data for n in mod._aux_names]}


def _module_batch(cfg, x, y, ctx):
    return mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)],
                           label=[mx.nd.array(y, ctx=ctx)])


def phase_module_check():
    """module_check: the thumbnail resnet18_v1 symbol through ``Module``
    on the card and on a CPU copy of its weights, ``forward_backward`` +
    ``update`` a step, the copy set to the card's state (weights,
    momenta, running statistics) before each step; the training forward's
    outputs, the running statistics and every weight and momentum held
    to ``MODULE_CHECK_TOL``; K1 one launch a card step, its result from
    the second step on (when the momenta exist) bit for bit the plain
    ``sgd_mom_update``'s over the same operands. Then
    ``save_checkpoint`` (with the optimizer states), ``Module.load`` and
    one more step resume bit for bit (deterministic cuDNN) against the
    step the saved module takes."""
    t_phase = time.perf_counter()
    cfg, tol = MODULE_CHECK, MODULE_CHECK_TOL
    rs = np.random.RandomState(0)
    x = rs.rand(cfg["steps"] + 1, cfg["batch"], 3, cfg["size"],
                cfg["size"]).astype(np.float32)
    y = rs.randint(0, cfg["classes"], (cfg["steps"] + 1, cfg["batch"])
                   ).astype(np.float32)
    sym = _thumbnail_symbol(cfg)
    mx.random.seed(0)
    card = _check_module(sym, mx.gpu(0), cfg)
    arg, aux = card.get_params()
    cpu = _check_module(sym, mx.cpu(), cfg, arg_params=arg, aux_params=aux)
    if (len(card._param_names), len(card._aux_names)) != (cfg["tensors"],
                                                          cfg["aux"]):
        raise AssertionError(f"module_check: {len(card._param_names)} "
                             f"parameters, {len(card._aux_names)} aux")
    before = opt_step.opt_sgd.launches
    steps, k1_bitwise = [], []
    for i in range(cfg["steps"]):
        st_card, st_cpu = _module_state(card), _module_state(cpu)
        with torch.no_grad():
            for k in st_card:
                for a, b in zip(st_cpu[k], st_card[k]):
                    a.copy_(b.cpu())
        aux0 = [t.clone() for t in st_card["aux"]]
        outs = []
        for mod, ctx in ((card, mx.gpu(0)), (cpu, mx.cpu())):
            mod.forward_backward(_module_batch(cfg, x[i], y[i], ctx))
            outs.append(mod.get_outputs()[0]._data.cpu())
            want = _module_k1_plain(mod) if mod is card and i > 0 else None
            mod.update()
            if want is not None:
                k1_bitwise.append(_module_k1_equal(mod, want, i))
        out_err = float((outs[0] - outs[1]).abs().max())
        if out_err > tol["out"]:
            raise AssertionError(f"module_check step {i}: outputs off by "
                                 f"{out_err}")
        st_card, st_cpu = _module_state(card), _module_state(cpu)
        aux_err = 0.0
        for a, b, old in zip(st_card["aux"], st_cpu["aux"], aux0):
            err = float((a.cpu() - b).abs().max()) / max(
                float(b.abs().max()), 1.0)
            aux_err = max(aux_err, err)
            if err > tol["aux"] or torch.equal(a, old):
                raise AssertionError(f"module_check step {i}: a running "
                                     f"statistic off by {err} or unmoved")
        step_err = 0.0
        for name, w, cw, m, cm in zip(card._param_names, st_cpu["w"],
                                      st_card["w"], st_cpu["m"],
                                      st_card["m"]):
            norm = float(cm.norm())
            for a, b in ((cw.cpu(), w), (cm.cpu(), m)):
                err = float((a - b).norm()) / max(norm, 1e-30)
                step_err = max(step_err, err)
                if err > tol["step_l2"]:
                    raise AssertionError(f"module_check step {i}: {name} "
                                         f"off by {err} of its step")
        steps.append({"max_out_err": out_err, "max_aux_err": aux_err,
                      "max_step_l2_err": step_err})
    torch.cuda.synchronize()
    launches = opt_step.opt_sgd.launches - before
    if launches != cfg["steps"]:
        raise AssertionError(f"module_check: {launches} K1 launches for "
                             f"{cfg['steps']} card steps")
    resume = _module_resume(card, sym, cfg, x[-1], y[-1])
    emit({"phase": "module_check", "config": cfg, "tolerance": tol,
          "tf32": False, "steps": steps, "opt_sgd_launches": launches,
          "k1_bitwise_vs_plain": k1_bitwise, "resume": resume,
          "phase_s": time.perf_counter() - t_phase})
    return opt_step.opt_sgd.launches - before


def _module_k1_plain(mod):
    """K1's plain version (``sgd_mom_update`` a tensor) over clones of
    the operands that ``mod.update()`` hands K1 on the store: the store's
    weights and momenta, the executor's gradients (one device, so the
    push's sum is the gradient itself), and the Module's optimizer's lr,
    wd table (``wd_mult`` 0 off the weights), ``rescale_grad`` (1 /
    batch) and clip. Returns the weights and momenta it leaves."""
    kv, opt = mod._kvstore, mod._optimizer
    names = mod._param_names
    idx = [kv._key_index(n) for n in names]
    lrs = set(opt._get_lrs(idx))
    if len(lrs) != 1 or len(kv._updater.states) != len(names):
        raise AssertionError(f"module_check: {len(lrs)} learning rates, "
                             f"{len(kv._updater.states)} momenta")
    state = {"w": [kv._store[n]._data.clone() for n in names],
             "g": [mod._exec.grad_dict[n]._data.clone() for n in names],
             "m": [kv._updater.states[n]._data.clone() for n in names]}
    lr = torch.tensor(lrs.pop(), dtype=torch.float32,
                      device=state["w"][0].device)
    _run_opt("opt_sgd", kernels.entry("opt_sgd").plain, state, lr,
             opt._get_wds(idx), {"momentum": opt.momentum,
                                 "rescale_grad": opt.rescale_grad,
                                 "clip_gradient": opt._clip()})
    return state


def _module_k1_equal(mod, want, step):
    """The store's weights and momenta after ``mod.update()`` (one K1
    launch) bit for bit against ``_module_k1_plain``'s, and the bound
    weights pulled from them."""
    kv, names = mod._kvstore, mod._param_names
    got = {"w": [kv._store[n]._data for n in names],
           "m": [kv._updater.states[n]._data for n in names],
           "pulled": [mod._exec.arg_dict[n]._data for n in names]}
    for k, ref in (("w", want["w"]), ("m", want["m"]),
                   ("pulled", want["w"])):
        if not all(torch.equal(a, b) for a, b in zip(got[k], ref)):
            raise AssertionError(f"module_check step {step}: K1's {k} "
                                 "differ from the plain sgd_mom_update's")
    wds = mod._optimizer._get_wds([kv._key_index(n) for n in names])
    return {"step": step, "bitwise_equal": True, "tensors": len(names),
            "rescale_grad": mod._optimizer.rescale_grad,
            "tensors_without_wd": sum(1 for wd in wds if not wd)}


def _module_resume(card, sym, cfg, x, y):
    """``save_checkpoint(..., save_optimizer_states=True)``, one more
    step of ``card``, then ``Module.load(..., load_optimizer_states=
    True)`` and the same step: every weight, momentum, running statistic
    and output bit for bit after two steps, with cuDNN deterministic:
    the flags are part of the training pair's key, so both modules' first
    step runs eagerly and their second is captured and replayed under
    the deterministic algorithms."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        with tempfile.TemporaryDirectory() as d:
            prefix = os.path.join(d, "module_check")
            card.save_checkpoint(prefix, cfg["steps"],
                                 save_optimizer_states=True)
            res = mx.mod.Module.load(prefix, cfg["steps"],
                                     load_optimizer_states=True,
                                     context=mx.gpu(0))
            res.bind(card.data_shapes, card.label_shapes)
            res.init_optimizer(kvstore=mx.kv.create("local"),
                               optimizer="sgd",
                               optimizer_params={
                                   "learning_rate": cfg["lr"],
                                   "momentum": cfg["momentum"],
                                   "wd": cfg["wd"]})
            got = {}
            for name, mod in (("saved", card), ("resumed", res)):
                for _ in range(2):
                    mod.forward_backward(_module_batch(cfg, x, y,
                                                       mx.gpu(0)))
                    mod.update()
                got[name] = dict(_module_state(mod),
                                 out=[mod.get_outputs()[0]._data])
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    torch.cuda.synchronize()
    counts = {k: len(v) for k, v in got["saved"].items()}
    for k, tensors in got["saved"].items():
        if len(got["resumed"][k]) != len(tensors) or not all(
                torch.equal(a, b) for a, b in zip(tensors,
                                                  got["resumed"][k])):
            raise AssertionError(f"module_check: the resumed step's {k} "
                                 "differ from the saved module's")
    return {"bitwise_equal": True, "tensors": counts}


# ---------------------------------------------------------- transformer_lm --

# ------------------------------------------------------- the data plane --

def _header_found(name, cxx="g++"):
    """Whether ``#include <name>`` compiles with the host's compiler."""
    try:
        proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o",
                               os.devnull], input=f"#include <{name}>\n",
                              text=True, capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def _nvjpeg_probe():
    """Where nvJPEG's header and library are under the CUDA home (a probe
    for a later JPEG decoder on the card; nothing here uses nvJPEG)."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    libs = sorted(str(p) for d in ("lib64", "lib", "targets")
                  for p in (home / d).rglob("libnvjpeg.so*")) \
        if home.exists() else []
    headers = sorted(str(p) for p in home.rglob("nvjpeg.h")) \
        if home.exists() else []
    return {"cuda_home": str(home), "nvjpeg_h": headers[:3],
            "libnvjpeg_so": libs[:3]}


def smooth_image(seed, h, w, noise):
    """A smooth random field (bilinear over a coarse grid of random
    colours) plus Gaussian noise: PNG compresses it as it does a
    photograph, not as white noise."""
    rs = np.random.RandomState(seed)
    gh, gw = max(2, h // 28), max(2, w // 28)
    lo = rs.uniform(0, 255, (gh, gw, 3))
    ay = np.maximum(0, 1 - np.abs(np.linspace(0, gh - 1, h)[:, None]
                                  - np.arange(gh)[None]))
    ax = np.maximum(0, 1 - np.abs(np.linspace(0, gw - 1, w)[:, None]
                                  - np.arange(gw)[None]))
    f = np.stack([ay @ lo[:, :, c] @ ax.T for c in range(3)], -1)
    f += rs.normal(0, noise, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


def _io_held(name, got, want):
    """A case of native_io: equal bit for bit, or an AssertionError."""
    same = all(np.array_equal(a, b) for a, b in zip(got, want)) \
        if isinstance(got, (list, tuple)) else np.array_equal(got, want)
    if not same:
        raise AssertionError(f"native_io: {name} differs from its plain "
                             "version")
    return name


def phase_native_io():
    """native_io: the native IO library built here (``native.status()``,
    the build seconds) held bit for bit against its plain versions on
    ``NATIVE_IO["images"]`` seeded images: RecordIO pack, scan and read;
    the float32 normalisation; the PNG unfilter (every filter type, on
    random scanlines) and conversion to RGB, from the port's encoder too;
    Pillow's BILINEAR resample; the augmenter; the fused PNG decode. A
    JPEG payload must raise on a build without libjpeg (or, with it, the
    JPEG batch decode is held against its plain version). Also a probe
    for a later PR: the CPU count, whether nvJPEG's header and library
    are under the CUDA home, and whether zlib.h and jpeglib.h compile."""
    import zlib

    from mxnet_tpu_torch import native

    t0 = time.perf_counter()
    st = native.status()
    build_s = time.perf_counter() - t0
    if not st["available"]:
        raise AssertionError(f"native_io: the library did not build: "
                             f"{st['error']}")
    cfg = NATIVE_IO
    rs = np.random.RandomState(0)
    imgs = [smooth_image(int(rs.randint(1 << 30)), *cfg["sizes"][
        i % len(cfg["sizes"])], IMAGENET_REC["noise"])
        for i in range(cfg["images"])]
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        payloads = [native.png_encode(im, i % 2) for i, im in
                    enumerate(imgs)]
        framed = native.recordio_pack(payloads)
        cases.append(_io_held(
            "recordio_pack", np.frombuffer(framed, np.uint8),
            np.frombuffer(native.recordio_pack_plain(payloads), np.uint8)))
        path = os.path.join(tmp, "x.rec")
        with open(path, "wb") as f:
            f.write(framed)
        scan = native.recordio_scan(path)
        cases.append(_io_held("recordio_scan", scan,
                              native.recordio_scan_plain(path)))
        got = native.recordio_read(path, *scan)
        if got != payloads or got != native.recordio_read_plain(path,
                                                                *scan):
            raise AssertionError("native_io: recordio_read differs")
        cases.append("recordio_read")
    crops = [im[:224, :224] for im in imgs if im.shape[0] >= 224]
    batch = np.stack(crops[:16])
    mean = np.asarray([123.68, 116.28, 103.53], np.float32)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    cases.append(_io_held("normalize",
                          native.normalize_batch(batch, mean, std),
                          native.normalize_batch_plain(batch, mean, std)))
    for i, (im, buf) in enumerate(zip(imgs, payloads)):
        info = native.png_info(buf)
        if info._replace(idat=bytes(info.idat)) != native.png_info_plain(
                buf):
            raise AssertionError("native_io: png_info differs from its "
                                 "plain version")
        raw = native.png_inflate(info)
        _io_held("png_inflate", np.frombuffer(raw, np.uint8), np.frombuffer(
            zlib.decompress(info.idat), np.uint8))
        rgb = native.png_to_rgb(raw, info)
        _io_held("png_to_rgb", rgb, native.png_to_rgb_plain(raw, info))
        _io_held("png_roundtrip", rgb, im)
        h, w = im.shape[:2]
        dh, dw = (252, 252) if h >= 224 else (h + 5, w - 3)
        oh, ow = (224, 224) if h >= 224 else (h - 4, w - 9)
        y, x, m = i % (dh - oh + 1), (3 * i) % (dw - ow + 1), i % 2
        jit = rs.uniform(0.6, 1.4, 3).astype(np.float32) if i % 3 else None
        sized = native.resample_bilinear(im, dh, dw)
        _io_held("resample_bilinear", sized,
                 native.resample_bilinear_plain(im, dh, dw))
        _io_held("augment", native.augment(sized, y, x, oh, ow, m, jit),
                 native.augment_plain(sized, y, x, oh, ow, m, jit))
        _io_held("png_decode_augment", native.png_decode_augment(
            raw, info, dh, dw, oh, ow, y, x, m, jit),
            native.augment_plain(native.resample_bilinear_plain(
                native.png_to_rgb_plain(raw, info), dh, dw), y, x, oh, ow,
                m, jit))
    cases += ["png_info", "png_inflate", "png_to_rgb", "resample_bilinear",
              "augment", "png_decode_augment"]
    # every filter type: random scanlines, each with a random filter byte
    for ct, ch in ((2, 3), (6, 4), (0, 1), (4, 2)):
        h, w = 17, 23
        raw = bytearray(rs.randint(0, 256, h * (w * ch + 1)).astype(
            np.uint8).tobytes())
        for yy in range(h):
            raw[yy * (w * ch + 1)] = yy % 5
        info = native.PngInfo(w, h, 8, ct, 0, b"", b"")
        _io_held(f"png_unfilter_color_type_{ct}", native.png_to_rgb(
            bytes(raw), info), native.png_to_rgb_plain(bytes(raw), info))
    cases.append("png_unfilter_all_filter_types")
    cases.append(_io_held(
        "png_filter_sub", np.frombuffer(native.png_filter(imgs[0], 1),
                                        np.uint8),
        np.frombuffer(native.png_filter_plain(imgs[0], 1), np.uint8)))
    jpeg = {"built": st["jpeg"]}
    fake = b"\xff\xd8\xff\xe0" + bytes(64)
    if not st["jpeg"]:
        try:
            native.decode_jpeg_batch([fake], 8, 8)
        except mx.MXNetError as e:
            if "libjpeg" not in str(e):
                raise
            jpeg["raises"] = str(e)[:120]
        else:
            raise AssertionError("native_io: a JPEG payload did not raise "
                                 "on a build without libjpeg")
    else:
        jb = native.jpeg_encode(imgs[0], 90)
        got, _ = native.decode_jpeg_batch([jb, fake], 64, 80)
        want, _ = native.decode_jpeg_batch_plain([jb, fake], 64, 80)
        cases.append(_io_held("decode_jpeg_batch", got, want))
    probe = {"cpu_count": os.cpu_count(), **_nvjpeg_probe(),
             "zlib_h": _header_found("zlib.h"),
             "jpeglib_h": _header_found("jpeglib.h"),
             "zlib_runtime": __import__("zlib").ZLIB_RUNTIME_VERSION}
    out = {"phase": "native_io", "status": st, "build_s": build_s,
           "cases": cases, "images": cfg["images"], "jpeg": jpeg,
           "probe": probe, "phase_s": time.perf_counter() - t0}
    emit(out)
    return out


def pack_imagenet_rec(path, cfg, workers=None):
    """``cfg["images"]`` PNG records from ``RandomState(0)`` through the
    port's ``recordio.pack_img`` into ``path`` (with its ``.idx``):
    seconds, bytes a record."""
    rs = np.random.RandomState(0)
    n = cfg["images"]
    seeds = rs.randint(0, 2 ** 31 - 1, n)
    labels = rs.randint(0, cfg["classes"], n)
    portrait = rs.rand(n) < 0.5
    lh, lw = cfg["landscape"]

    def encode(i):
        h, w = (lw, lh) if portrait[i] else (lh, lw)
        bgr = smooth_image(int(seeds[i]), h, w, cfg["noise"])[:, :, ::-1]
        return mx.recordio.pack_img((0, float(labels[i]), i, 0), bgr,
                                    img_fmt=".png")

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers or os.cpu_count()) as pool:
        bodies = list(pool.map(encode, range(n)))
    writer = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i, body in enumerate(bodies):
        writer.write_idx(i, body)
    writer.close()
    return {"pack_s": time.perf_counter() - t0,
            "bytes_per_record": float(np.mean([len(b) for b in bodies])),
            "raw_bytes_per_image": lh * lw * 3, "labels": labels}


def _rec_iter(path, cfg, ctx, threads=None, **over):
    kw = dict(path_imgrec=path, data_shape=cfg["data_shape"],
              batch_size=cfg["batch"], shuffle=True, rand_crop=True,
              rand_mirror=True, preprocess_threads=threads or cfg["threads"],
              prefetch_buffer=cfg["prefetch"], ctx=ctx)
    kw.update(over)
    return mx.io.ImageRecordIter(**kw)


def _stage_reading(it, first, images_per_batch, threads):
    """Stage times of the batches handed out from ``first`` on: each
    threaded stage's thread-ms an image (median over the batches), and
    ``records_wall``, ``produce`` and the copy's ms a batch (median)."""
    rows = it.stage_ms()[first:]
    med = {k: statistics.median(r.get(k, 0.0) for r in rows)
           for k in ("read", "draws", "inflate", "decode", "normalize",
                     "records_wall", "produce", "h2d")}
    per_image = {k: med[k] / images_per_batch for k in (
        "read", "draws", "inflate", "decode", "normalize")}
    return {"stage_ms_median": med, "thread_ms_per_image": per_image,
            "thread_ms_per_image_sum": sum(per_image.values()),
            "ceiling_img_per_s": threads * 1e3 / sum(per_image.values())}


def _iterator_alone(path, cfg, threads, reps, timed):
    """The iterator by itself on the card: ``reps`` readings of ``timed``
    batches each after ``warmup`` (an epoch's end resets it, as fit
    does): img/s, and each stage's ms (``_stage_reading``)."""
    it = _rec_iter(path, cfg, mx.gpu(0), threads)

    def batch():
        try:
            return it.next()
        except StopIteration:
            it.reset()
            return it.next()

    for _ in range(cfg["warmup"]):
        batch()
    readings = []
    for _ in range(reps):
        first = len(it.data_wait_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            b = batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        x = b.data[0]
        if tuple(x.shape) != (cfg["batch"],) + tuple(cfg["data_shape"]) or \
                not torch.isfinite(x._data).all():
            raise AssertionError(f"imagenet_rec: a batch of {x.shape}")
        readings.append({"img_per_s": timed * cfg["batch"] / wall,
                         "batch_ms": wall * 1e3 / timed,
                         **_stage_reading(it, first, cfg["batch"],
                                          threads)})
    it.close()
    rates = [r["img_per_s"] for r in readings]
    return {"threads": threads, "timed": timed, "img_per_s": rates,
            "img_per_s_median": statistics.median(rates),
            "readings": readings}


def _rec_resume(path, cfg):
    """An iterator's ``state_dict`` after ``resume_at`` batches, loaded
    into a new one: its next ``resume_next`` batches are the uninterrupted
    run's, bit for bit (on the card)."""
    ref = _rec_iter(path, cfg, mx.gpu(0))
    want = [ref.next().data[0]._data.clone()
            for _ in range(cfg["resume_at"] + cfg["resume_next"])]
    cut = _rec_iter(path, cfg, mx.gpu(0))
    for _ in range(cfg["resume_at"]):
        cut.next()
    state = cut.state_dict()
    fresh = _rec_iter(path, cfg, mx.gpu(0))
    fresh.load_state_dict(json.loads(json.dumps(state)))
    got = [fresh.next().data[0]._data for _ in range(cfg["resume_next"])]
    if not all(torch.equal(a, b) for a, b in zip(got, want[
            cfg["resume_at"]:])):
        raise AssertionError("imagenet_rec: the resumed iterator's batches "
                             "differ from the uninterrupted run's")
    for it in (ref, cut, fresh):
        it.close()
    return {"state": state, "batches_equal": cfg["resume_next"]}


def _trainer_resume(path, cfg):
    """``ShardedTrainer.save_checkpoint(data_iter=)`` / ``resume(data_iter=)``
    on the ResNet thumbnail over the records, deterministic cuDNN: after
    ``steps`` steps the run checkpoints and takes ``after`` more; a fresh
    trainer resumed from the manager gets the same next batch and, after
    the same steps, the same weights, bit for bit."""
    from mxnet_tpu_torch import checkpoint

    th = cfg["thumbnail"]
    shape = (3, th["size"], th["size"])
    dev = mx.gpu(0)

    def make():
        net = vision.get_model(th["model"], classes=th["classes"],
                               thumbnail=True)
        net.initialize(mx.init.Xavier(), ctx=dev,
                       generator=torch.Generator().manual_seed(0))
        net(mx.nd.zeros((1,) + shape, ctx=dev))
        it = _rec_iter(path, cfg, dev, data_shape=shape,
                       batch_size=th["batch"])
        return _resnet_trainer(net, dev, False), it

    def step(st, it):
        b = it.next()
        st.step(b.data[0], b.label[0])
        return b.data[0]._data.clone()

    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            manager = checkpoint.CheckpointManager(tmp, keep=2)
            run, it = make()
            for _ in range(th["steps"]):
                step(run, it)
            run.save_checkpoint(manager, epoch=1, data_iter=it)
            nxt = [step(run, it) for _ in range(th["after"])]
            final = {k: t.clone() for k, t in run._state_tensors().items()}
            fresh, it2 = make()
            entry = fresh.resume(manager, data_iter=it2)
            got = [step(fresh, it2) for _ in range(th["after"])]
            after = fresh._state_tensors()
            it.close()
            it2.close()
    finally:
        torch.backends.cudnn.deterministic = False
    same_batch = all(torch.equal(a, b) for a, b in zip(got, nxt))
    same_state = set(after) == set(final) and all(
        torch.equal(after[k], final[k]) for k in final)
    if not (same_batch and same_state):
        raise AssertionError(f"imagenet_rec: trainer resume with data_iter: "
                             f"batches equal {same_batch}, state equal "
                             f"{same_state}")
    return {"data_state": entry["meta"]["data_state"],
            "next_batches_equal": th["after"], "state_equal": True,
            "tensors": len(final)}


def _first_batches_equal_plain(path, cfg):
    """The card iterator's first ``plain_batches`` batches against the
    same iterator with ``ctx=mx.cpu()`` over the plain versions, bit for
    bit."""
    from mxnet_tpu_torch import native

    card = _rec_iter(path, cfg, mx.gpu(0))
    got = [card.next() for _ in range(cfg["plain_batches"])]
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in got]
    card.close()
    t0 = time.perf_counter()
    with native.plain_versions():
        cpu = _rec_iter(path, cfg, mx.cpu())
        want = [cpu.next() for _ in range(cfg["plain_batches"])]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in want]
        cpu.close()
    if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(got, want)):
        raise AssertionError("imagenet_rec: the card's first batches differ "
                             "from the CPU run over the plain versions")
    return {"batches_equal": cfg["plain_batches"],
            "plain_s": time.perf_counter() - t0}


def phase_imagenet_rec(smi):
    """imagenet_rec, the cell resnet50_v1_module_fit_rec:
    ``train_imagenet.py --data-train <rec> --network resnet50_v1`` at the
    example's defaults over PNG records packed here (``IMAGENET_REC``).
    The iterator alone (3 readings at 4 decode threads and at
    ``os.cpu_count()``, one at 1 thread): img/s and ms by stage.
    ``Module.fit`` as resnet50_v1_module_fit wires it (``MODULE_FIT``, the
    executor captured) but over ``fit_batches`` (40) batches, so that the
    two prefetched batches cannot cover the producer's pace; four fits A
    B B A: records, synthetic, synthetic, records; over batches 4-40 of
    each: all images over all wall time, the mean batch, the sum of the
    ms ``next()`` waited (``data_wait``) over the sum of batch time,
    Speedometer's img/s, launches (K1 one a batch, nothing else) and a
    finite loss. Then the iterator's ``state_dict`` resume,
    the trainer's checkpoint with ``data_iter``, and the first batches
    against the CPU run over the plain versions. The bfloat16 run is left
    out: a float32 record batch into a bfloat16 graph is refused at bind
    by the JAX Module and by the port's (tests/
    test_torch_image_record_iter.py)."""
    t_phase = time.perf_counter()
    cfg = IMAGENET_REC
    mcfg = MODULE_FIT
    dev = mx.gpu(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.rec")
        packed = pack_imagenet_rec(path, cfg)
        labels = packed.pop("labels")
        emit({"phase": "imagenet_rec_pack", **packed,
              "images": cfg["images"]})
        alone = [_iterator_alone(path, cfg, t, cfg["reps"], cfg["timed"])
                 for t in dict.fromkeys((cfg["threads"], os.cpu_count()))]
        alone.append(_iterator_alone(path, cfg, 1, 1, cfg["alone_timed"]))
        emit({"phase": "imagenet_rec_iterator", "card": smi,
              "runs": alone})
        fcfg = dict(mcfg, epoch_size=cfg["fit_batches"],
                    reduced=cfg["reduced"])
        mx.random.seed(0)
        net = get_network(fcfg["network"], fcfg["num_classes"],
                          fcfg["image_shape"])
        synthetic = SyntheticDataIter(
            fcfg["num_classes"], (fcfg["batch"],) + tuple(
                fcfg["image_shape"]), fcfg["epoch_size"])
        rec = _rec_iter(path, cfg, dev)
        records = mx.io.ResizeIter(rec, fcfg["epoch_size"])
        epoch = cfg["images"] // cfg["batch"]
        runs = []
        for source in ("records", "synthetic", "synthetic", "records"):
            train = records if source == "records" else synthetic
            waits0 = len(rec.data_wait_ms)
            mx.random.seed(0)
            model, log, run = _module_fit_once(fcfg, net, train, dev)
            want = dict.fromkeys(run["launches"], 0)
            want["opt_sgd"] = fcfg["epoch_size"]
            if run["launches"] != want or not all(
                    v is not None and math.isfinite(v)
                    for v in run["losses"]) or not log.speeds:
                raise AssertionError(f"imagenet_rec {source}: launches "
                                     f"{run['launches']}, losses "
                                     f"{run['losses']}, Speedometer "
                                     f"{log.speeds}")
            # batches warmup..end: batch_ms[k] is batch k + 1's time
            window = run["batch_ms"][fcfg["warmup"] - 1:]
            run["window_ms"] = sum(window)
            run["window_batches"] = len(window)
            run["mean_batch_ms"] = sum(window) / len(window)
            if source == "records":
                waits = rec.data_wait_ms[waits0:]
                if len(waits) != fcfg["epoch_size"]:
                    raise AssertionError(f"imagenet_rec: {len(waits)} "
                                         "waits recorded")
                run["data_wait_ms"] = waits
                run["data_wait_window_ms"] = sum(waits[fcfg["warmup"]:])
                run["data_wait_ms_epoch_starts"] = waits[epoch::epoch]
                run["stages"] = _stage_reading(
                    rec, waits0 + fcfg["warmup"], cfg["batch"],
                    cfg["threads"])
                run["producer_img_per_s"] = cfg["batch"] * 1e3 / run[
                    "stages"]["stage_ms_median"]["produce"]
            run["source"] = source
            runs.append(run)
            del model
            torch.cuda.empty_cache()
        rec.close()
        pooled = {s: [r for r in runs if r["source"] == s]
                  for s in ("records", "synthetic")}
        window = {s: sum(r["window_ms"] for r in v)
                  for s, v in pooled.items()}
        batches = {s: sum(r["window_batches"] for r in v)
                   for s, v in pooled.items()}
        mean_ms = {s: window[s] / batches[s] for s in window}
        medians = {s: statistics.median(v for r in rs for v in r[
            "batch_ms"][fcfg["warmup"] - 1:]) for s, rs in pooled.items()}
        rec_runs = pooled["records"]
        wait_ms = sum(r["data_wait_window_ms"] for r in rec_runs)
        resume = _rec_resume(path, cfg)
        trainer_resume = _trainer_resume(path, cfg)
        plain = _first_batches_equal_plain(path, cfg)
    out = {"phase": "imagenet_rec", "cell": "resnet50_v1_module_fit_rec",
           "card": smi, "config": cfg, "module_config": fcfg,
           "source": "examples/image_classification/train_imagenet.py "
                     "--data-train <packed .rec> --network resnet50_v1",
           "label_classes_present": int(len(np.unique(labels))),
           "iterator_alone": alone,
           "iterator_img_per_s_4_threads_median": alone[0][
               "img_per_s_median"],
           "fit_batches": fcfg["epoch_size"],
           "timed_batches_per_fit": rec_runs[0]["window_batches"],
           "abba_order": [r["source"] for r in runs],
           "mean_batch_ms": mean_ms["records"],
           "mean_batch_ms_synthetic": mean_ms["synthetic"],
           "record_batch_excess": mean_ms["records"]
           / mean_ms["synthetic"] - 1,
           "img_per_s": fcfg["batch"] * batches["records"]
           / (window["records"] / 1e3),
           "img_per_s_synthetic": fcfg["batch"] * batches["synthetic"]
           / (window["synthetic"] / 1e3),
           "median_batch_ms": medians["records"],
           "median_batch_ms_synthetic": medians["synthetic"],
           "block_mean_ms": {s: [r["mean_batch_ms"] for r in v]
                             for s, v in pooled.items()},
           "speedometer_img_per_s": [r["speedometer_img_per_s"]
                                     for r in runs],
           "data_wait_ms_per_batch": wait_ms / batches["records"],
           "data_wait_share": wait_ms / window["records"],
           "data_wait_ms_epoch_starts": [r["data_wait_ms_epoch_starts"]
                                         for r in rec_runs],
           "records_stages": [r["stages"] for r in rec_runs],
           "producer_img_per_s": [r["producer_img_per_s"]
                                  for r in rec_runs],
           "launches": rec_runs[0]["launches"],
           "k1_tensors_by_path": rec_runs[0]["k1_tensors_by_path"],
           "losses": [r["losses"] for r in runs],
           "max_memory_allocated": rec_runs[0]["max_memory_allocated"],
           "iterator_resume": resume, "trainer_resume": trainer_resume,
           "plain_check": plain,
           "bfloat16": "left out: refused at bind by both packages",
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del net, synthetic
    torch.cuda.empty_cache()
    return out


def _lm_build(cfg, dev, dropout=0.0):
    """``build_lm`` on ``dev``: Xavier weights from ``mx.random.seed(0)``,
    deferred shapes resolved by one forward of a single window."""
    mx.random.seed(0)
    net, adapter, loss = build_lm(mx, cfg, dropout=dropout, ctx=dev)
    net.initialize(mx.init.Xavier(), ctx=dev)
    with mx.autograd.pause():
        net(mx.nd.zeros((1, cfg["seq_len"]), ctx=dev),
            mx.nd.arange(cfg["seq_len"], ctx=dev))
    return net, adapter, loss


def _lm_batches(cfg, n, dev):
    """``n`` batches as the example draws them (``RandomState(0)``
    windows of the corpus, next-token labels), on ``dev``."""
    windows, labels = lm_windows(lm_corpus(cfg["vocab"],
                                           cfg["corpus_tokens"]),
                                 cfg["seq_len"])
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        sel = rng.randint(0, len(windows), cfg["batch"])
        out.append((mx.nd.array(windows[sel].astype(np.float32), ctx=dev),
                    mx.nd.array(labels[sel].astype(np.float32), ctx=dev)))
    return out


def _lm_trainer(cfg, adapter, loss, **kw):
    return ShardedTrainer(adapter, loss, "adam",
                          {"learning_rate": cfg["lr"]}, **kw)


def _lm_launches(layers, fwd=1, bwd=1):
    """K2, K3 and K3-bwd launches in one LM step: ``fwd`` flash forwards
    and ``bwd`` backward pairs per layer."""
    return {"opt_adam": 1, "flash_attention": fwd * layers,
            "flash_attention.mma": fwd * layers,
            "flash_attention_bwd_dq": bwd * layers,
            "flash_attention_bwd_dq.mma": bwd * layers,
            "flash_attention_bwd_dkv": bwd * layers,
            "flash_attention_bwd_dkv.mma": bwd * layers}


def _lm_group(name):
    """The LM step's kernel groups: GEMMs, flash forward and backward,
    softmax and cross-entropy over the logits, LayerNorm/GELU and other
    elementwise passes, the fused Adam step (K2)."""
    low = name.lower()
    for group, keys in (("flash", ("flash_fwd_",)),
                        ("flash_backward", ("flash_bwd_",)),
                        ("k2_adam", ("opt_step_kernel",)),
                        ("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas")),
                        ("softmax_cross_entropy", ("softmax", "nll_loss",
                                                   "cross_entropy")),
                        ("embedding", ("embedding", "index")),
                        ("layernorm_gelu_elementwise", (
                            "layer_norm", "gelu", "elementwise", "vectorized",
                            "reduce", "foreach", "fill"))):
        if any(k in low for k in keys):
            return group
    return "other"


def _lm_profiled_step(st, x, y, eager):
    """One step (replayed, or eager) under ``torch.profiler``: device ms
    by ``_lm_group``, the busy share of the window, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prev = compile_service.set_enabled(not eager)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(st.step(x, y)._data.float())
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        compile_service.set_enabled(prev)
    groups, per = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        per[e.key] = per.get(e.key, 0.0) + ms
        g = _lm_group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
    busy = sum(groups.values())
    return {"window_ms": window_ms,
            "device_ms": busy if groups else "not measured",
            "busy_share": busy / window_ms if groups else "not measured",
            "device_ms_by_group": groups,
            "top_kernels_ms": [[k[:80], v] for k, v in sorted(
                per.items(), key=lambda kv: -kv[1])[:10]]}


def _lm_defaults(dev):
    """The example's defaults, 60 steps from one state in each of four
    runs (captured, eager, eager, captured), ``mx.random.seed(0)`` and
    the example's batches each: the loss at steps 0, 20, 40 and 59,
    finite and falling, and whether the runs agree bit for bit."""
    cfg = LM_DEFAULTS
    net, adapter, loss = _lm_build(cfg, dev)
    start = [p.data()._data.clone() for p in net.collect_params().values()]
    batches = _lm_batches(cfg, cfg["steps"], dev)
    runs = []
    for mode in ("captured", "eager", "eager", "captured"):
        with torch.no_grad():
            for p, s in zip(net.collect_params().values(), start):
                p.data()._data.copy_(s)
        st = _lm_trainer(cfg, adapter, loss)
        prev = compile_service.set_enabled(mode == "captured")
        mx.random.seed(0)
        losses, ms = [], []
        try:
            for x, y in batches:
                t0 = time.perf_counter()
                losses.append(float(st.step(x, y).asscalar()))
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            compile_service.set_enabled(prev)
        runs.append({"mode": mode, "loss": losses,
                     "median_step_ms": statistics.median(ms[3:])})
        del st
    at = (0, 20, 40, cfg["steps"] - 1)
    for r in runs:
        shown = [r["loss"][i] for i in at]
        if not all(math.isfinite(v) for v in r["loss"]) or \
                not shown[0] > shown[1] > shown[3] or \
                not shown[0] > shown[2] > shown[3]:
            raise AssertionError(f"transformer_lm defaults: loss not "
                                 f"finite and falling in the {r['mode']} "
                                 f"run: steps {at}: {shown}")
    return {"config": "lm_defaults", **{k: cfg[k] for k in cfg},
            "loss_at": {m + str(i): {s: r["loss"][s] for s in at}
                        for i, (m, r) in enumerate(
                            (r["mode"], r) for r in runs)},
            "median_step_ms": {r["mode"] + str(i): r["median_step_ms"]
                               for i, r in enumerate(runs)},
            "captured_equals_eager": runs[0]["loss"] == runs[1]["loss"],
            "runs_repeat": runs[0]["loss"] == runs[3]["loss"] and
            runs[1]["loss"] == runs[2]["loss"]}


def _grad_agreement(got, want, names):
    """Per tensor ``|got - want|`` over ``|want|`` (L2 norms), and over
    all tensors together (``global_share``): bit for bit where equal. The
    attention key biases' true gradient is zero (a
    bias on every key shifts a whole row of scores, which softmax
    ignores): both runs hold rounding noise there, so their difference is
    taken over the largest gradient norm of the step instead."""
    shares, equal = {}, 0
    norms = [float(w.float().norm()) for w in want]
    diffs = [float((g.float() - w.float()).norm())
             for g, w in zip(got, want)]
    for n, g, w, norm, diff in zip(names, got, want, norms, diffs):
        if torch.equal(g, w):
            equal += 1
            shares[n] = 0.0
            continue
        scale = max(norms) if n.endswith("attn.key.bias") else norm
        shares[n] = diff / max(scale, 1e-30)
    worst = sorted(shares, key=shares.get, reverse=True)
    return {"tensors": len(shares), "bit_equal_tensors": equal,
            "global_share": math.sqrt(sum(d * d for d in diffs)
                                      / max(sum(v * v for v in norms),
                                            1e-30)),
            "bit_equal": equal == len(shares), "max_share": shares[worst[0]],
            "max_share_tensor": worst[0],
            "largest_shares": {n: shares[n] for n in worst[:5]}}


def _lm_variant(st, x, y, steps, layers, fwd, bwd):
    """``steps`` captured steps of a variant trainer (the first eager,
    then a capture and replays): step ms, peak memory, and launches per
    replay, which must be ``_lm_launches(layers, fwd, bwd)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, losses = [], []
    for i in range(steps):
        if i == 2:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(float(st.step(x, y).asscalar()))
        ms.append((time.perf_counter() - t0) * 1e3)
    per = {k: v / (steps - 2) for k, v in kernels.launch_counts().items()
           if v}
    want = _lm_launches(layers, fwd, bwd)
    if per != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"transformer_lm variant: launches per replay "
                             f"{per} (want {want}), losses {losses}")
    return {"step_ms": ms, "median_step_ms": statistics.median(ms[2:]),
            "loss": losses, "launches_per_replay": per,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "peak_added": torch.cuda.max_memory_allocated() - base}


LM_VARIANTS = {"remat": {"remat": True}, "accum_steps_2": {"accum_steps": 2}}


def _lm_step1_gradients(cfg, net, adapter, loss, st, x, y):
    """The gradient of step 1 (from the initial weights) of each variant
    trainer (``LM_VARIANTS``) against the plain trainer ``st``'s: with
    ``remat`` bit for bit or within 1e-6 of each tensor's L2 norm; with
    ``accum_steps=2`` within 1e-5 of each tensor's. (Later, after steps
    on one batch, the gradient shrinks while its bias and LayerNorm
    entries still sum 8192 tokens' terms that mostly cancel, and two
    float32 sums of 4096 round apart from one of 8192 by up to 1.8e-4 of
    such a tensor's norm.)"""
    by_param = {p: n for n, p in
                net._collect_params_with_structure().items()}
    pnames = [by_param[p] for p in st._params]
    want_loss, want = st._loss_and_grads(x._data, y._data)
    grads = {}
    for k, kw in LM_VARIANTS.items():
        got_loss, got = _lm_trainer(cfg, adapter, loss,
                                    **kw)._loss_and_grads(x._data, y._data)
        grads[k] = {"loss": float(got_loss), "plain_loss": float(want_loss),
                    **_grad_agreement(got, want, pnames)}
        del got
    del want
    acc = grads["accum_steps_2"]
    if not grads["remat"]["max_share"] <= 1e-6 or \
            not acc["max_share"] <= 1e-5:
        raise AssertionError(f"transformer_lm: step 1's gradients {grads}")
    torch.cuda.empty_cache()
    return grads


def phase_transformer_lm(smi):
    """transformer_lm: ``examples/gluon/transformer_lm.py``'s causal LM
    rebuilt from the port (``build_lm``), float32 with TF32 off. First
    the example's defaults (``_lm_defaults``). Then ``lm_gpt2s`` (GPT-2
    small width, ``LM_GPT2S``): one trainer, captured against eager in
    A B B A blocks from one state (``_trainer_blocks``; 3 warm-up steps
    and 4 blocks of 5 per mode), 3 captured steps against 3 eager ones
    from one state, a profiled replayed and eager step, launches per
    replay (K2 1, K3 12, K3-bwd 12 + 12), peak memory and the graph
    pool; the gradient of step 1 with ``remat=True`` and with
    ``accum_steps=2`` against the plain one (``_lm_step1_gradients``);
    then 10
    captured steps of each variant (K3 24 a step with remat; K3 and
    K3-bwd twice as often with accumulation; K2 once)."""
    dev = mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "transformer_lm", "card": smi,
           "defaults": _lm_defaults(dev)}
    emit({"phase": "transformer_lm_defaults", **out["defaults"]})
    torch.cuda.empty_cache()

    cfg = LM_GPT2S
    t0 = time.perf_counter()
    net, adapter, loss = _lm_build(cfg, dev)
    (x, y), = _lm_batches(cfg, 1, dev)
    build_s = time.perf_counter() - t0
    n_params = sum(p.data().size for p in net.collect_params().values())
    st = _lm_trainer(cfg, adapter, loss)
    grads = _lm_step1_gradients(cfg, net, adapter, loss, st, x, y)
    names = list(st._state_tensors())
    pool0 = _pool_bytes()
    warm, n, per = cfg["warmup"], cfg["blocks"], cfg["block_steps"]
    plan, seen = [], set()
    for mode in (["captured", "eager", "eager", "captured"] * n)[:2 * n]:
        plan.append((mode, per + (0 if mode in seen else warm)))
        seen.add(mode)
    blocks, _ = _trainer_blocks(st, x, y, plan)
    pool = _pool_bytes() - pool0
    for b in blocks:
        b["step_ms"] = b["step_ms"][-per:]
    summary = _abba_summary(blocks, 0)
    captured = [b for b in blocks if b["mode"] == "captured"]
    eager = [b for b in blocks if b["mode"] == "eager"]
    per_replay = {k: v / per for k, v in captured[-1]["launches"].items()}
    want = _lm_launches(cfg["layers"])
    if per_replay != want or captured[-1]["replays"] != per:
        raise AssertionError(f"transformer_lm: per replayed step "
                             f"{per_replay} (want {want}), blocks {blocks}")
    start = _snapshot(st)
    bit = cfg["bit_steps"]
    pair, kept = _trainer_blocks(st, x, y, [("captured", bit),
                                            ("eager", bit)],
                                 start=start, snaps=(bit,))
    agree = _step_agreement(kept["captured"][bit], kept["eager"][bit],
                            start[0], names)
    if agree["max_share"] > CAPTURE_STEP_L2:
        raise AssertionError(f"transformer_lm: captured against eager "
                             f"after {bit} steps: {agree}")
    prof = {"captured": _lm_profiled_step(st, x, y, eager=False),
            "eager": _lm_profiled_step(st, x, y, eager=True)}
    step_ms = summary["median_step_ms"]
    tokens = cfg["batch"] * cfg["seq_len"]
    gpt2s = {"config": "lm_gpt2s", **cfg, "parameters": n_params,
             "trainable_tensors": len(st._params),
             "build_s": build_s, **summary,
             "abba_order": [b["mode"] for b in blocks],
             "step_ms_by_block": [b["step_ms"] for b in blocks],
             "tokens_per_s": {m: tokens / (v / 1e3)
                              for m, v in step_ms.items()},
             "capture_ms": captured[0]["capture_ms"],
             "graph_pool_bytes": pool,
             "launches_per_replayed_step": per_replay,
             "peak_memory": {
                 "captured_max_allocated": max(
                     b["max_memory_allocated"] for b in captured),
                 "eager_max_allocated": max(
                     b["max_memory_allocated"] for b in eager),
                 "captured_added": captured[-1]["peak_added"],
                 "captured_added_with_pool": captured[-1]["peak_added"]
                 + pool,
                 "eager_added": eager[-1]["peak_added"]},
             "captured_vs_eager_3_steps": agree,
             "step_l2_tol": CAPTURE_STEP_L2,
             "profiled_step": prof}
    gpt2s["pool_over_eager_added"] = pool / max(eager[-1]["peak_added"], 1)
    emit({"phase": "transformer_lm_gpt2s", **gpt2s})

    del start, kept, pair
    del st
    torch.cuda.empty_cache()
    runs = {}
    for k, (fwd, bwd) in (("accum_steps_2", (2, 2)), ("remat", (2, 1))):
        runs[k] = _lm_variant(_lm_trainer(cfg, adapter, loss,
                                          **LM_VARIANTS[k]), x, y,
                              cfg["variant_steps"], cfg["layers"], fwd, bwd)
        torch.cuda.empty_cache()
    variants_out = {k: {**runs[k], "gradient_vs_plain": grads[k]}
                    for k in runs}
    emit({"phase": "transformer_lm_variants", **variants_out})
    out.update(gpt2s=gpt2s, variants=variants_out)
    return out


# examples/gluon/word_lm.py at the medium configuration of Zaremba et al.
# 2014 (arXiv:1409.2329; MXNet's example/gluon/word_language_model
# --emsize 650 --nhid 650 --tied): 2 LSTM layers of 650 units, 35
# unrolled steps, batch 20, PTB's 10,000 words, the example's synthetic
# bigram corpus of 84,000 tokens (one pass of 119 steps, the cut)
WORD_LM = {"vocab_size": 10000, "embed_dim": 650, "hidden": 650,
           "layers": 2, "bptt": 35, "batch_size": 20, "lr": 20.0,
           "clip": 0.25, "tied": True, "corpus_tokens": 84000,
           "dropout": 0.2, "check_steps": 5, "abba_steps": 10,
           "ppl_window": 20}
# examples/rnn/train_ptb.py at MXNet 1.x's example/rnn/bucketing/
# lstm_bucketing.py defaults (200 units, batch 32; its 2 layers cannot be
# set, train_ptb.py:118 fixes 1), one epoch of 4,000 synthetic sentences
PTB_BUCKETING = {"num_embed": 200, "num_hidden": 200, "vocab_size": 10000,
                 "batch_size": 32, "num_sentences": 4000,
                 "buckets": [10, 20, 30, 40], "lr": 0.01, "num_epochs": 1,
                 "abba_batches": 5, "ppl_window": 20}
RNN_TOL = 2e-5           # float32 rtol = atol, cuDNN against the per-step form
RNN_TIED_RTOL = 1e-5     # the tied gradient against its two parts' sum
RNN_MODULE_TOL = 1e-6    # a fresh Module against the bucket's executor
PAIR_CAPTURE_CALL = 2    # a pair's first call runs eagerly, its second captures


def word_lm_model(mx):
    """``examples/gluon/word_lm.py:29-59``'s ``RNNModel``, verbatim, over
    package ``mx``'s blocks."""
    gluon = mx.gluon
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(gluon.HybridBlock):
        """embedding -> LSTM -> dropout -> dense decoder; optional weight
        tying (decoder shares the embedding matrix)."""

        def __init__(self, vocab_size, embed_dim, hidden, layers,
                     dropout=0.2, tie_weights=False, **kwargs):
            super().__init__(**kwargs)
            self.hidden = hidden
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(vocab_size, embed_dim)
                self.rnn = rnn.LSTM(hidden, num_layers=layers,
                                    dropout=dropout, input_size=embed_dim)
                if tie_weights:
                    if embed_dim != hidden:
                        raise ValueError("weight tying needs embed_dim == "
                                         "hidden")
                    self.decoder = nn.Dense(vocab_size, flatten=False,
                                            params=self.encoder.params)
                else:
                    self.decoder = nn.Dense(vocab_size, flatten=False)

        def hybrid_forward(self, F, inputs, state):
            emb = self.drop(self.encoder(inputs))          # (T, B, E)
            out, state = self.rnn(emb, state)
            out = self.drop(out)
            return self.decoder(out), state

        def begin_state(self, batch_size, ctx):
            return self.rnn.begin_state(batch_size=batch_size, ctx=ctx)

    return RNNModel


def batchify(ids, batch_size):
    """``word_lm.py:62-66``, verbatim: the token stream folded into
    (num_steps, batch_size) columns."""
    n = len(ids) // batch_size
    ids = np.asarray(ids[: n * batch_size], np.float32)
    return ids.reshape(batch_size, n).T


def word_lm_corpus(vocab_size, corpus_tokens):
    """``word_lm.py:77-88``'s synthetic corpus, verbatim: Zipf draws, each
    followed by a fixed successor with probability 0.8."""
    rng = np.random.RandomState(42)
    ranks = np.arange(1, vocab_size)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    succ = rng.permutation(vocab_size)
    ids = [int(rng.choice(ranks, p=probs))]
    for _ in range(corpus_tokens - 1):
        if rng.rand() < 0.8:
            ids.append(int(succ[ids[-1]]))
        else:
            ids.append(int(rng.choice(ranks, p=probs)))
    return ids, vocab_size


def detach(state):
    """``word_lm.py:91-94``, verbatim."""
    if isinstance(state, (list, tuple)):
        return [detach(s) for s in state]
    return state.detach()


def word_lm_step(mx, model, trainer, loss_fn, cfg, vocab_size, x, y, state,
                 ctx, clip_check=None):
    """One pass of ``word_lm.py:138-152``'s loop body, verbatim; returns
    ``(state, nll sum, clip total, tokens)``. ``clip_check(grads)`` sees
    the clipped gradients before the trainer steps on them."""
    state = detach(state)  # truncated BPTT boundary
    with mx.autograd.record():
        out, state = model(x, state)
        loss = loss_fn(out.reshape((-1, vocab_size)), y.reshape((-1,)))
    loss.backward()
    grads = [p.grad(ctx) for p in model.collect_params().values()
             if p.grad_req != "null"]
    total = mx.gluon.utils.clip_global_norm(
        grads, cfg["clip"] * cfg["bptt"] * cfg["batch_size"])
    if clip_check is not None:
        clip_check(grads)
    trainer.step(cfg["bptt"] * cfg["batch_size"])
    return state, float(loss.sum().asscalar()), total, loss.size


def synthetic_corpus(num_sentences, vocab_size, seed):
    """``examples/rnn/train_ptb.py:38-55``, verbatim: Zipf-distributed
    token sequences with a simple bigram structure."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size)
    probs = 1.0 / ranks
    probs /= probs.sum()
    sentences = []
    for _ in range(num_sentences):
        length = int(rng.randint(5, 35))
        toks = [int(rng.choice(ranks, p=probs))]
        for _ in range(length - 1):
            # bigram: next token correlates with previous (learnable)
            prev = toks[-1]
            toks.append((prev * 7 + int(rng.choice(ranks, p=probs)))
                        % (vocab_size - 1) + 1)
        sentences.append(toks + [0])
    return sentences


def bucket_sentence_iter(mx):
    """``train_ptb.py:58-104``'s ``BucketSentenceIter``, verbatim, over
    package ``mx``: pads each sentence to its bucket length and yields
    batches tagged with ``bucket_key``."""

    class BucketSentenceIter(mx.io.DataIter):
        def __init__(self, sentences, batch_size, buckets, vocab_size):
            super().__init__(batch_size)
            self.buckets = sorted(buckets)
            self.data = {b: [] for b in self.buckets}
            for s in sentences:
                for b in self.buckets:
                    if len(s) <= b:
                        self.data[b].append(s + [0] * (b - len(s)))
                        break
            self.vocab_size = vocab_size
            self.default_bucket_key = max(self.buckets)
            # sequences feed as (tokens[:-1] -> tokens[1:]): length key-1
            self.provide_data = [mx.io.DataDesc(
                "data", (batch_size, self.default_bucket_key - 1))]
            self.provide_label = [mx.io.DataDesc(
                "softmax_label", (batch_size, self.default_bucket_key - 1))]
            self.reset()

        def reset(self):
            self._plan = []
            for b in self.buckets:
                arr = np.asarray(self.data[b], np.float32)
                for s in range(0, len(arr) - self.batch_size + 1,
                               self.batch_size):
                    self._plan.append((b, arr[s:s + self.batch_size]))
            self._cursor = 0

        def next(self):
            if self._cursor >= len(self._plan):
                raise StopIteration
            bucket, chunk = self._plan[self._cursor]
            self._cursor += 1
            data = mx.nd.array(chunk[:, :-1])
            label = mx.nd.array(chunk[:, 1:])
            batch = mx.io.DataBatch(
                data=[data], label=[label], pad=0, index=None)
            batch.bucket_key = bucket
            batch.provide_data = [mx.io.DataDesc("data", data.shape)]
            batch.provide_label = [mx.io.DataDesc("softmax_label",
                                                  label.shape)]
            return batch

    return BucketSentenceIter


def sym_gen_factory(mx, vocab_size, num_embed, num_hidden, batch_size):
    """``train_ptb.py:107-131``'s ``sym_gen_factory``, verbatim, over
    package ``mx``: one LSTM layer through ``mx.sym.RNN``."""
    def sym_gen(bucket_key):
        seq_len = bucket_key - 1  # noqa: F841 - the example's
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=vocab_size,
                                 output_dim=num_embed, name="embed")
        state = mx.sym.var("lstm_init_state", init=mx.init.Zero(),
                           shape=(1, batch_size, num_hidden))
        cell = mx.sym.var("lstm_init_cell", init=mx.init.Zero(),
                          shape=(1, batch_size, num_hidden))
        rnn_out = mx.sym.RNN(mx.sym.transpose(embed, axes=(1, 0, 2)),
                             state=state, state_cell=cell,
                             state_size=num_hidden, num_layers=1,
                             mode="lstm", name="lstm")
        flat = mx.sym.Reshape(rnn_out, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(flat, num_hidden=vocab_size,
                                     name="pred")
        lab_flat = mx.sym.Reshape(label, shape=(-1,))
        sm = mx.sym.SoftmaxOutput(pred, lab_flat, name="softmax")
        return sm, ("data",), ("softmax_label",)

    return sym_gen


def _rnn_inputs(mode, layers, bidirectional, shape, dev, seed):
    """Seeded ``(x, params, h0, c0)`` for the RNN op at ``shape`` =
    (T, B, I, H) on ``dev``, each requiring grad (``c0`` None outside
    LSTM): uniform weights of scale 1/sqrt(H), as PyTorch's RNNs draw."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    t, b, i, h = shape
    ndir = 2 if bidirectional else 1
    gen = torch.Generator().manual_seed(seed)
    dev = dev.torch_device() if isinstance(dev, mx.Context) else dev
    n = nn_ops.rnn_param_size(i, h, layers, mode, bidirectional)

    def rand(*s, scale=1.0):
        return ((torch.rand(s, generator=gen) * 2 - 1) * scale).to(dev) \
            .requires_grad_(True)

    c0 = rand(layers * ndir, b, h) if mode == "lstm" else None
    return (rand(t, b, i), rand(n, scale=h ** -0.5),
            rand(layers * ndir, b, h), c0)


def rnn_route_pair(mode, layers, bidirectional, shape, dev, seed=0):
    """The RNN op's cuDNN route and its per-step form (the plain
    version) on the same inputs: ``(outputs, gradients)`` of each, the
    gradients of a seeded weighted sum of ``out``, ``hn`` and ``cn``
    with respect to data, parameters and states."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    ins = _rnn_inputs(mode, layers, bidirectional, shape, dev, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    dev = ins[0].device
    runs = []
    for route in ("cudnn", "steps"):
        outs = nn_ops.rnn_run(route, *ins, shape[3], layers, mode,
                              bidirectional)
        outs = [o for o in outs if o is not None]
        if not runs:
            weights = [torch.randn(o.shape, generator=gen).to(dev)
                       for o in outs]
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, [t for t in ins if t is not None])
        runs.append(([o.detach() for o in outs], list(grads)))
    return runs


def _rnn_errors(got, want, per_tensor=False):
    """Largest ``|got - want|`` over tensor lists, and its largest ratio
    to the tolerance (at most 1 within it): ``atol + rtol |want|``
    element by element, or with ``per_tensor`` ``rtol max |want|`` over
    each tensor (``RNN_TOL`` both). Gradients take the second: each
    element of a weight's gradient is a float32 sum over T x B products
    whose rounding follows the tensor's largest values, not its own (the
    per-element test fails for rnn_tanh's gradients at the word LM's
    shape by 1.5x on an H100, TF32 off)."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        if per_tensor:
            r = float(d.max()) / max(RNN_TOL * float(w.abs().max()), 1e-30)
        else:
            r = float((d / (RNN_TOL + RNN_TOL * w.abs())).max())
        ratio = max(ratio, r)
    return err, ratio


RNN_ROUTE_CASES = [(m, layers, False) for m in ("lstm", "gru", "rnn_tanh",
                                                "rnn_relu")
                   for layers in (1, 2)] + [("gru", 2, True)]


def _rnn_route_checks(dev, cfg):
    """The RNN op's cuDNN route against its per-step form at the word
    LM's shape (35, 20, 650, 650) for every ``RNN_ROUTE_CASES`` case,
    forward and gradients within ``RNN_TOL``; then both routes' forward
    and forward + backward ms (CUDA events) for the LSTM of the run, the
    same LSTM through ``torch.nn.LSTM`` with its weights in one cuDNN
    buffer (a yardstick: the difference is the compaction of the views
    at each call) and the gluon layer's concat of its 16 tensors into
    the flat vector."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    shape = (cfg["bptt"], cfg["batch_size"], cfg["embed_dim"],
             cfg["hidden"])
    cases, bad = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for mode, layers, bi in RNN_ROUTE_CASES:
            (o_c, g_c), (o_s, g_s) = rnn_route_pair(mode, layers, bi, shape,
                                                    dev)
            fe, fr = _rnn_errors(o_c, o_s)
            ge, gr = _rnn_errors(g_c, g_s, per_tensor=True)
            case = {"mode": mode, "layers": layers, "bidirectional": bi,
                    "forward_max_abs_err": fe, "forward_tol_ratio": fr,
                    "grad_max_abs_err": ge, "grad_tol_ratio": gr,
                    "grad_max_abs": max(float(g.abs().max()) for g in g_s)}
            cases.append(case)
            if fr > 1 or gr > 1:
                bad.append(case)
    warned = sorted({str(w.message)[:160] for w in caught})
    x, params, h0, c0 = _rnn_inputs("lstm", cfg["layers"], False, shape,
                                    dev, 0)
    t, h = shape[0], shape[3]

    def run(route, backward):
        def go():
            out, hn, cn = nn_ops.rnn_run(route, x, params, h0, c0, h,
                                         cfg["layers"], "lstm", False)
            if backward:
                torch.autograd.grad(out.sum() + hn.sum() + cn.sum(),
                                    [x, params, h0, c0])
        return go

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        times = {f"{route}_{what}_ms": cuda_ms(run(route, bwd), iters=10)
                 for route in ("cudnn", "steps")
                 for what, bwd in (("forward", False),
                                   ("forward_backward", True))}
    lib = torch.nn.LSTM(shape[2], h, cfg["layers"]).to(x.device)
    with torch.no_grad():
        for layer, (wx, wh, bx, bh) in enumerate(nn_ops.rnn_weights(
                params, "lstm", cfg["layers"], 1, shape[2], h)):
            for name, v in (("weight_ih", wx), ("weight_hh", wh),
                            ("bias_ih", bx), ("bias_hh", bh)):
                getattr(lib, f"{name}_l{layer}").copy_(v)
    lib.flatten_parameters()

    def lib_run(backward):
        def go():
            out, (hn, cn) = lib(x, (h0, c0))
            if backward:
                torch.autograd.grad(out.sum() + hn.sum() + cn.sum(),
                                    [x, h0, c0] + list(lib.parameters()))
        return go

    times["one_buffer_forward_ms"] = cuda_ms(lib_run(False), iters=10)
    times["one_buffer_forward_backward_ms"] = cuda_ms(lib_run(True),
                                                      iters=10)
    pieces = [w.detach().clone() for layer in nn_ops.rnn_weights(
        params, "lstm", cfg["layers"], 1, shape[2], h) for w in layer]
    times["concat_ms"] = cuda_ms(lambda: torch.cat(
        [p.reshape(-1) for p in pieces]), iters=20)
    out = {"shape_tbih": list(shape), "tol": RNN_TOL, "cases": cases,
           "torch_warnings": warned, "lstm_times": times,
           "flat_vector_bytes": params.numel() * 4}
    if bad:
        raise AssertionError(f"lstm_lm_ptb_medium: the cuDNN route and the "
                             f"per-step form differ past {RNN_TOL}: {bad}")
    return out


def _rnn_group(name):
    """Kernel groups of the recurrent steps: cuDNN's RNN kernels, the
    GEMMs (cuDNN's own and the decoder's), the fused Adam step (K2),
    softmax and cross-entropy, copies (the flat vector's concat and the
    compaction of its views), other elementwise passes."""
    low = name.lower()
    for group, keys in (("k2_adam", ("opt_step_kernel",)),
                        ("cudnn_rnn", ("rnn", "lstm", "persist")),
                        ("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas")),
                        ("softmax_cross_entropy", ("softmax", "nll_loss",
                                                   "cross_entropy")),
                        ("copy_concat", ("copy", "cat", "memcpy")),
                        ("reduce_norm", ("reduce", "norm")),
                        ("elementwise", ("elementwise", "vectorized",
                                         "foreach", "fill", "index"))):
        if any(k in low for k in keys):
            return group
    return "other"


# aten ops of an eager word-LM step whose device time (their kernels')
# the profile reports: the cuDNN RNN (its forward holds the compaction
# copy), the flat vector's concat, the decoder's products, softmax-CE,
# the clip and the SGD update
_RNN_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward", "aten::cat",
            "aten::addmm", "aten::mm", "aten::matmul", "aten::_log_softmax",
            "aten::_log_softmax_backward_data", "aten::nll_loss_forward",
            "aten::nll_loss_backward", "aten::linalg_vector_norm",
            "aten::_foreach_mul_", "aten::embedding_dense_backward",
            "aten::index_select", "aten::copy_")


def _rnn_profile(fn, reps, eager):
    """``reps`` calls of ``fn`` under ``torch.profiler`` (the compile
    service on, or off with ``eager``): the window's host ms per call,
    device ms by ``_rnn_group`` and the busy share, the top kernels, and
    for an eager window the device ms of the ``_RNN_OPS`` ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prev = compile_service.set_enabled(not eager)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        compile_service.set_enabled(prev)
    groups, top, ops = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                e.self_device_time_total > 0 and \
                not getattr(e, "is_user_annotation", False):
            ms = e.self_device_time_total / 1e3 / reps
            g = _rnn_group(e.key)
            groups[g] = groups.get(g, 0.0) + ms
            top[e.key] = top.get(e.key, 0.0) + ms
        elif e.key in _RNN_OPS and e.device_time_total > 0:
            ops[e.key] = {"device_ms": e.device_time_total / 1e3 / reps,
                          "calls": e.count / reps}
    busy = sum(groups.values())
    out = {"window_ms_per_call": window_ms,
           "device_ms_per_call": busy if groups else "not measured",
           "busy_share": busy / window_ms if groups else "not measured",
           "device_ms_by_group": groups,
           "top_kernels_ms": [[k[:90], v, _rnn_group(k)] for k, v in sorted(
               top.items(), key=lambda kv: -kv[1])[:15]]}
    if eager:
        out["device_ms_by_op"] = ops
    return out


def _sync_count(fn):
    """``{file:line of the Python call: count}`` of the synchronizing
    CUDA calls ``fn()`` makes (the host waiting on the card), as
    ``torch.cuda.set_sync_debug_mode("warn")`` flags them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        # the flagged calls only: setting the mode also warns, once, that
        # the mode is a prototype ("Synchronization debug mode is ...")
        if "called a synchronizing" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def _structured_grads(model, ctx):
    """``{structural name: gradient copy}`` of the model's parameters."""
    return {n: p.grad(ctx)._data.detach().clone() for n, p in
            model._collect_params_with_structure().items()
            if p.grad_req != "null"}


def _tied_check(model, untied, cfg, vocab_size, x, y, dev):
    """The tied matrix's gradient from the captured pair (one forward and
    backward, dropout masks from ``mx.random.seed(5)``) against the sum
    of its embedding and decoder parts, computed eagerly by an untied
    copy of the same weights under the same seed."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    grads = {}
    for name, net, eager in (("tied", model, False), ("untied", untied,
                                                      True)):
        prev = compile_service.set_enabled(not eager)
        try:
            mx.random.seed(5)
            state = net.begin_state(cfg["batch_size"], dev)
            with mx.autograd.record():
                out, _ = net(x, state)
                loss = loss_fn(out.reshape((-1, vocab_size)),
                               y.reshape((-1,)))
            loss.backward()
        finally:
            compile_service.set_enabled(prev)
        grads[name] = _structured_grads(net, dev)
    tied = grads["tied"]["encoder.weight"]
    parts = grads["untied"]["encoder.weight"] + \
        grads["untied"]["decoder.weight"]
    rel = float((tied - parts).norm() / parts.norm())
    if not rel <= RNN_TIED_RTOL:
        raise AssertionError(f"lstm_lm_ptb_medium: the tied gradient is "
                             f"{rel} (relative L2) from the sum of its parts")
    return {"relative_l2": rel, "rtol": RNN_TIED_RTOL,
            "parts_norms": [float(grads["untied"][k].norm()) for k in (
                "encoder.weight", "decoder.weight")]}


def _param_tensors(model):
    return [p.data()._data for p in model.collect_params().values()]


def phase_lstm_lm_ptb_medium(smi):
    """lstm_lm_ptb_medium: ``examples/gluon/word_lm.py --vocab-size 10000
    --embed-dim 650 --hidden 650 --layers 2 --bptt 35 --batch-size 20
    --lr 20 --clip 0.25 --tied --corpus-tokens 84000`` (``WORD_LM``),
    hybridized, on the card: the RNN op's routes held against each other
    (``_rnn_route_checks``), one pass of 119 captured steps (one pair
    capture, then replays; perplexity of the last 20 steps below the
    first 20; every step's clipped gradients at most the clip norm), 5
    captured steps against 5 eager ones from one state and seed, the tied
    gradient against its parts, captured and eager blocks A B B A,
    profiled steps, host reads per step, peak memory and the pool."""
    cfg = WORD_LM
    dev = mx.gpu(0)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.ops import nn as nn_ops

    routes = _rnn_route_checks(dev, cfg)
    emit({"phase": "lstm_lm_ptb_medium_routes", "card": smi, **routes})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mx.random.seed(1)
    ids, vocab_size = word_lm_corpus(cfg["vocab_size"], cfg["corpus_tokens"])
    data = batchify(ids, cfg["batch_size"])   # (T_total, B)
    corpus_s = time.perf_counter() - t0
    RNNModel = word_lm_model(mx)
    pool0 = _pool_bytes()
    model = RNNModel(vocab_size, cfg["embed_dim"], cfg["hidden"],
                     cfg["layers"], tie_weights=cfg["tied"])
    model.initialize(mx.init.Xavier(), ctx=dev)
    model.hybridize()
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": cfg["lr"]})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    n_params = sum(p.data().size for p in model.collect_params().values())
    starts = list(range(0, data.shape[0] - 1 - cfg["bptt"], cfg["bptt"]))
    limit = cfg["clip"] * cfg["bptt"] * cfg["batch_size"]
    clipped = []

    def clip_check(grads):
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g._data) for g in grads])))
        clipped.append(norm)

    def batch(i):
        i = starts[i % len(starts)]
        return (mx.nd.array(data[i:i + cfg["bptt"]], ctx=dev),
                mx.nd.array(data[i + 1:i + 1 + cfg["bptt"]], ctx=dev))

    def run(steps, first=0, check=None, state=None, stamps=None):
        state = model.begin_state(cfg["batch_size"], dev) \
            if state is None else state
        nll, tok, totals = [], 0, []
        for k in range(first, first + steps):
            x, y = batch(k)
            state, s, total, n = word_lm_step(
                mx, model, trainer, loss_fn, cfg, vocab_size, x, y, state,
                dev, check)
            nll.append(s)
            tok = n
            totals.append(total)
            if stamps is not None:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
        return state, nll, tok, totals

    site0 = _site_stats("cachedop")
    kernels.reset_launch_counts()
    nn_ops.rnn_routes.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, nll, tok, totals = run(len(starts), check=clip_check)
    pass_s = time.perf_counter() - t0
    site = _site_stats("cachedop")
    peak = torch.cuda.max_memory_allocated()
    pool = _pool_bytes() - pool0
    steps = len(starts)
    routes_run = dict(nn_ops.rnn_routes.calls)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    pair = {k: site.get(k, 0) - site0.get(k, 0) for k in (
        "misses", "hits", "captures", "replays", "eager")}
    w = cfg["ppl_window"]
    ppl = [math.exp(sum(nll[:w]) / (w * tok)),
           math.exp(sum(nll[-w:]) / (w * tok))]
    if pair["captures"] != 1 or pair["misses"] != 1:
        raise AssertionError(f"lstm_lm_ptb_medium: the pair captured "
                             f"{pair} times over {steps} steps; want one "
                             "miss and one capture")
    if routes_run != {"cudnn": cfg["layers"] * steps, "steps": 0}:
        raise AssertionError(f"lstm_lm_ptb_medium: RNN layer runs by route "
                             f"{routes_run} over {steps} steps")
    if max(clipped) > limit * (1 + 1e-5):
        raise AssertionError(f"lstm_lm_ptb_medium: clipped gradient norm "
                             f"{max(clipped)} above {limit}")
    if not (all(math.isfinite(v) for v in nll) and ppl[1] < ppl[0]):
        raise AssertionError(f"lstm_lm_ptb_medium: perplexity {ppl}")
    emit({"phase": "lstm_lm_ptb_medium_pass", "steps": steps,
          "pass_s": pass_s, "perplexity_first_last_20": ppl,
          "clip_totals_first_last": [totals[0], totals[-1]],
          "clipped_norm_max": max(clipped), "clip_limit": limit,
          "pair": pair, "rnn_layer_runs": routes_run,
          "kernel_launches": launches})

    # 5 captured steps against 5 eager ones from one state and one seed
    start = [t.clone() for t in _param_tensors(model)]
    names = list(model.collect_params().keys())
    kept = {}
    for mode in ("captured", "eager"):
        with torch.no_grad():
            for t, s in zip(_param_tensors(model), start):
                t.copy_(s)
        prev = compile_service.set_enabled(mode == "captured")
        try:
            mx.random.seed(7)
            run(cfg["check_steps"])
        finally:
            compile_service.set_enabled(prev)
        kept[mode] = [t.clone() for t in _param_tensors(model)]
    agree = _step_agreement(kept["captured"], kept["eager"], start, names)
    if agree["max_share"] > CAPTURE_STEP_L2:
        raise AssertionError(f"lstm_lm_ptb_medium: {cfg['check_steps']} "
                             f"captured steps against eager: {agree}")
    del kept, start

    x, y = batch(0)
    untied = RNNModel(vocab_size, cfg["embed_dim"], cfg["hidden"],
                      cfg["layers"], tie_weights=False)
    untied.initialize(ctx=dev)
    src = model._collect_params_with_structure()
    for name, p in untied._collect_params_with_structure().items():
        p.set_data(src[name].data())
    tied = _tied_check(model, untied, cfg, vocab_size, x, y, dev)
    del untied
    torch.cuda.empty_cache()

    state = model.begin_state(cfg["batch_size"], dev)
    blocks, at = [], 0
    for mode in ("captured", "eager", "eager", "captured"):
        stamps = [None]
        prev = compile_service.set_enabled(mode == "captured")
        try:
            torch.cuda.synchronize()
            stamps[0] = time.perf_counter()
            state, _, _, _ = run(cfg["abba_steps"], at, state=state,
                                 stamps=stamps)
        finally:
            compile_service.set_enabled(prev)
        at += cfg["abba_steps"]
        blocks.append({"mode": mode, "step_ms": [
            (b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]})
    tokens = cfg["bptt"] * cfg["batch_size"]
    median = {m: statistics.median([v for b in blocks if b["mode"] == m
                                    for v in b["step_ms"][1:]])
              for m in ("captured", "eager")}

    holder = {"state": model.begin_state(cfg["batch_size"], dev), "k": 0}

    def one_step():
        xb, yb = batch(holder["k"])
        holder["k"] += 1
        holder["state"] = word_lm_step(mx, model, trainer, loss_fn, cfg,
                                       vocab_size, xb, yb, holder["state"],
                                       dev)[0]

    reads = _sync_count(one_step)
    prof = {"captured": _rnn_profile(one_step, 3, eager=False),
            "eager": _rnn_profile(one_step, 3, eager=True)}
    out = {"phase": "lstm_lm_ptb_medium", "card": smi,
           "config": dict(cfg), "parameters": n_params,
           "reduced": "one pass of 119 steps over the example's synthetic "
                      "84,000-token corpus (PTB's train set: 929 k tokens)",
           "corpus_s": corpus_s, "steps": steps,
           "perplexity_first_last_20": ppl,
           "captured_vs_eager_5_steps": agree,
           "step_l2_tol": CAPTURE_STEP_L2, "tied_gradient": tied,
           "abba_order": [b["mode"] for b in blocks],
           "step_ms_by_block": [b["step_ms"] for b in blocks],
           "median_step_ms": median,
           "tokens_per_s": {m: tokens / (v / 1e3) for m, v in
                            median.items()},
           "host_syncs_per_step": sum(reads.values()),
           "host_syncs_by_call": reads, "profiled_step": prof,
           "peak_memory_allocated": peak, "graph_pool_bytes": pool,
           "pair": pair, "rnn_layer_runs": routes_run,
           "kernel_launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _bucket_storage(model):
    """Whether every bucket's parameters, gradients and auxiliary states
    are the default bucket's tensors, and every bucket's updater (with
    its optimizer states) the default's; and how many of each."""
    default = model._buckets[model.default_bucket_key]
    ok, n = True, {"parameters": 0, "gradients": 0, "adam_states": 0}
    for mod in model._buckets.values():
        for key, mine, theirs in (
                ("parameters", mod._exec.arg_dict, default._exec.arg_dict),
                ("gradients", mod._exec.grad_dict, default._exec.grad_dict)):
            for name in mod._param_names:
                if name in mine:
                    ok &= mine[name]._data.data_ptr() == \
                        theirs[name]._data.data_ptr()
                    n[key] += mod is default
        ok &= mod._updater is default._updater
    for state in default._updater.states.values():
        n["adam_states"] += len(state) if isinstance(state, tuple) else 1
    return ok, n


def phase_lstm_ptb_bucketing(smi):
    """lstm_ptb_bucketing: ``examples/rnn/train_ptb.py --num-embed 200
    --num-hidden 200 --vocab-size 10000 --batch-size 32 --num-sentences
    4000`` (``PTB_BUCKETING``): ``BucketingModule.fit`` with "adam",
    Xavier, ``Perplexity`` and ``Speedometer(32, 20)`` over buckets
    10/20/30/40 for one epoch on the card, each bucket's executor pair
    captured at its second batch. Fails unless exactly 4 ``executor``
    captures (none after), one storage for every parameter, gradient and
    Adam state across the buckets, K2 one launch a batch, falling
    perplexity, and a fresh ``Module`` bound at bucket 20 with the same
    parameters giving the bucket's outputs (``RNN_MODULE_TOL``). Then
    batch ms by bucket captured and eager (A B B A), a profiled batch
    of each bucket, each bucket's graph pool."""
    cfg = PTB_BUCKETING
    dev = mx.gpu(0)
    t_phase = time.perf_counter()
    b = cfg["batch_size"]
    t0 = time.perf_counter()
    sentences = synthetic_corpus(cfg["num_sentences"], cfg["vocab_size"],
                                 seed=0)
    corpus_s = time.perf_counter() - t0
    it = bucket_sentence_iter(mx)(sentences, b, cfg["buckets"],
                                  cfg["vocab_size"])
    sym_gen = sym_gen_factory(mx, cfg["vocab_size"], cfg["num_embed"],
                              cfg["num_hidden"], b)
    model = mx.mod.BucketingModule(sym_gen,
                                   default_bucket_key=it.default_bucket_key,
                                   context=dev)
    log, last = [], {"captures": 0, "pool": _pool_bytes()}
    pools = {}

    def recorder(param):
        torch.cuda.synchronize()
        caps = _site_stats("executor")["captures"]
        m = param.eval_metric
        key = param.locals["data_batch"].bucket_key
        log.append({"bucket": key, "t": time.perf_counter(),
                    "captures": caps,
                    "nll": m.global_sum_metric + m.sum_metric,
                    "n": m.global_num_inst + m.num_inst})
        if caps != last["captures"]:
            pool = _pool_bytes()
            pools[key] = pool - last["pool"]
            last.update(captures=caps, pool=pool)

    site0 = _site_stats("executor")
    last["captures"] = site0["captures"]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _captured_log() as lines:
        model.fit(it, eval_metric=mx.metric.Perplexity(),
                  optimizer="adam",
                  optimizer_params={"learning_rate": cfg["lr"]},
                  initializer=mx.init.Xavier(),
                  num_epoch=cfg["num_epochs"],
                  batch_end_callback=[recorder, mx.callback.Speedometer(
                      b, 20)])
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    batches = len(log)
    site = _site_stats("executor")
    captures = site["captures"] - site0["captures"]
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    per_batch = [(e["nll"] - p["nll"], e["n"] - p["n"]) for p, e in zip(
        [{"nll": 0.0, "n": 0}] + log, log)]
    w = cfg["ppl_window"]
    ppl = [math.exp(sum(v for v, _ in per_batch[:w]) /
                    sum(n for _, n in per_batch[:w])),
           math.exp(sum(v for v, _ in per_batch[-w:]) /
                    sum(n for _, n in per_batch[-w:]))]
    seen, capture_at = {}, []
    prev_caps = site0["captures"]
    for i, e in enumerate(log):
        seen[e["bucket"]] = seen.get(e["bucket"], 0) + 1
        if e["captures"] != prev_caps:
            capture_at.append((e["bucket"], seen[e["bucket"]]))
            prev_caps = e["captures"]
    shared, counts = _bucket_storage(model)
    problems = []
    if captures != len(cfg["buckets"]) or sorted(capture_at) != sorted(
            (k, PAIR_CAPTURE_CALL) for k in cfg["buckets"]):
        problems.append(f"{captures} executor captures at (bucket, its "
                        f"batch) {capture_at}")
    if not shared:
        problems.append("the buckets do not share one storage")
    if launches.get("opt_adam") != batches:
        problems.append(f"K2 launches {launches} over {batches} batches")
    if not ppl[1] < ppl[0]:
        problems.append(f"perplexity {ppl}")
    if problems:
        raise AssertionError(f"lstm_ptb_bucketing: {problems}")
    emit({"phase": "lstm_ptb_bucketing_fit", "batches": batches,
          "fit_s": fit_s, "perplexity_first_last_20": ppl,
          "captures": captures, "capture_at_bucket_batch": capture_at,
          "shared_storage": counts, "launches": launches,
          "speedometer_samples_per_s": lines.speeds})

    by_bucket = {k: [] for k in cfg["buckets"]}
    it.reset()
    for batch in it:
        if len(by_bucket[batch.bucket_key]) < cfg["abba_batches"]:
            by_bucket[batch.bucket_key].append(batch)
    metric = mx.metric.Perplexity()
    abba = []
    for mode in ("captured", "eager", "eager", "captured"):
        ms = {k: [] for k in cfg["buckets"]}
        metric_ms = {k: [] for k in cfg["buckets"]}
        prev = compile_service.set_enabled(mode == "captured")
        try:
            for k in cfg["buckets"]:
                for batch in by_bucket[k]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.forward_backward(batch)
                    model.update()
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    model.update_metric(metric, batch.label)
                    t2 = time.perf_counter()
                    ms[k].append((t2 - t0) * 1e3)
                    metric_ms[k].append((t2 - t1) * 1e3)
        finally:
            compile_service.set_enabled(prev)
        abba.append({"mode": mode, "batch_ms": ms,
                     "update_metric_ms": metric_ms})

    def medians(key, mode):
        return {k: statistics.median([v for blk in abba
                                      if blk["mode"] == mode
                                      for v in blk[key][k][1:]])
                for k in cfg["buckets"]}

    median = {m: medians("batch_ms", m) for m in ("captured", "eager")}
    metric_median = {m: medians("update_metric_ms", m)
                     for m in ("captured", "eager")}
    if _site_stats("executor")["captures"] != site["captures"]:
        raise AssertionError("lstm_ptb_bucketing: a capture after the "
                             "buckets' first batches")
    cycle = [by_bucket[k][0] for k in cfg["buckets"]]
    holder = {"i": 0}

    def one_batch():
        batch = cycle[holder["i"] % len(cycle)]
        holder["i"] += 1
        model.forward_backward(batch)
        model.update()

    prof = _rnn_profile(one_batch, len(cycle), eager=False)
    k2 = prof["device_ms_by_group"].get("k2_adam", 0.0)

    check = by_bucket[20][0]
    arg, aux = model.get_params()
    sym, data_names, label_names = sym_gen(20)
    fresh = mx.mod.Module(sym, data_names=data_names,
                          label_names=label_names, context=dev)
    fresh.bind(check.provide_data, check.provide_label, for_training=False)
    fresh.init_params(arg_params=arg, aux_params=aux)
    fresh.forward(check, is_train=False)
    model.forward(check, is_train=False)
    got, want = model.get_outputs()[0]._data, fresh.get_outputs()[0]._data
    fresh_err = float((got - want).abs().max())
    if not fresh_err <= RNN_MODULE_TOL:
        raise AssertionError(f"lstm_ptb_bucketing: a fresh Module at bucket "
                             f"20 differs by {fresh_err}")
    out = {"phase": "lstm_ptb_bucketing", "card": smi, "config": cfg,
           "reduced": "one epoch of 4,000 synthetic sentences; 1 LSTM "
                      "layer (train_ptb.py:118 fixes it; "
                      "lstm_bucketing.py has 2)",
           "corpus_s": corpus_s, "batches": batches, "fit_s": fit_s,
           "batches_by_bucket": seen,
           "perplexity_first_last_20": ppl, "captures": captures,
           "capture_at_bucket_batch": capture_at,
           "shared_storage": counts,
           "launches": launches, "speedometer_samples_per_s": lines.speeds,
           "abba_order": [blk["mode"] for blk in abba],
           "batch_ms_by_block": [blk["batch_ms"] for blk in abba],
           "median_batch_ms": median,
           "median_update_metric_ms": metric_median,
           "samples_per_s": {m: {k: b / (v / 1e3) for k, v in d.items()}
                             for m, d in median.items()},
           "graph_pool_bytes_by_bucket": pools,
           "graph_pool_bytes_total": sum(pools.values()),
           "peak_memory_allocated": peak, "profiled_batches": prof,
           "k2_device_ms_per_batch": k2,
           "fresh_module_max_abs_err": fresh_err,
           "fresh_module_tol": RNN_MODULE_TOL,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del model, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the twentieth slice ------
# examples/image_classification/train_imagenet.py --benchmark 1 --network
# mobilenet_v2_1_0 at the parser's defaults (MODULE_FIT's wiring: batch 128
# of 3x224x224, 1000 classes, "sgd" lr 0.1 momentum 0.9 wd 1e-4 under the
# MultiFactorScheduler, a local kvstore, Xavier, float32, TF32 off): 160
# trainable tensors (54 convolution weights, 53 BatchNorm gammas and betas)
# and 106 running statistics. The one cut, as for ResNet-50: 13 batches a
# fit. Four fits (captured, eager, eager, captured) and one captured fit
# with --optimizer nag.
MOBILENET_FIT = dict(MODULE_FIT, network="mobilenet_v2_1_0", tensors=160,
                     aux=106, nag_fits=1)
# the train phase's fine-tune (BERT-base, batch 32, seq 128, lr 1e-4, wd
# 1e-4, 20 steps) under "lamb" at the JAX defaults (beta1 0.9, beta2 0.999,
# epsilon 1e-6, bias correction, no bounds): four blocks of 20 steps from
# one state, captured, eager, eager, captured; an "adam" block beside it;
# replays counted for host syncs with the guard off (its flag is the one
# read the step makes by design)
LAMB_TRAIN = {"steps": 20, "warmup": 3, "adam_steps": 10, "sync_replays": 5}
# examples/gluon/dcgan.py at its defaults (3 epochs of 512 // 32 = 16
# iterations, batch 32, nz 16, "adam" lr 2e-3 beta1 0.5 in two
# gluon.Trainers); the check: two iterations from one set of weights and
# one numpy batch of images and noise on the card and on a CPU copy, the
# losses to rtol 1e-4 and each parameter's change within 5% of its step's
# L2 norm (Adam's first steps move every weight by about lr whatever its
# gradient, so a gradient near zero whose rounding differs moves by up to
# 2 lr; 5% of a tensor's step is many such elements)
DCGAN = {"epochs": 3, "batch": 32, "nz": 16, "lr": 2e-3,
         "num_examples": 512, "check_iters": 2}
DCGAN_TOL = {"loss_rtol": 1e-4, "step_l2": 0.05}
# every family's default constructor at batch 2 (Inception v3 at 299, the
# rest at 224), one training forward and backward on the card and on a CPU
# copy from the same weights, TF32 off; Dropout's rate set to 0 in both
# copies for the check (the card's and the CPU's generators draw different
# masks; Dropout itself is held by dropout_capture). Logits to 1e-3 of
# their largest magnitude; each gradient within 10% of its L2 norm, or of
# a thousandth of the model's largest gradient norm where that is larger:
# at batch 2 the train-mode BatchNorm backward subtracts means over as few
# as 2 x 7 x 7 values in float32 and the cancellation grows through the
# stack (measured worst on an H100 80GB HBM3: 4.6% in Inception v3, 1.8% in
# DenseNet-121, 1.6% in MobileNet v1, 0.8% in SqueezeNet 1.0), and a bias
# or beta that feeds a train-mode BatchNorm has a true gradient of 0, so
# the card and the CPU compute rounding noise there (VGG-16-BN's conv biases,
# MobileNet v2's last beta of each non-residual bottleneck)
ZOO_CHECK = {"batch": 2, "classes": 1000,
             "models": {"alexnet": 224, "densenet121": 224,
                        "inception_v3": 299, "mobilenet1_0": 224,
                        "mobilenet_v2_1_0": 224, "squeezenet1_0": 224,
                        "squeezenet1_1": 224, "vgg16": 224, "vgg16_bn": 224},
             # MXNet 1.x's Inception v3 (fault C20 repaired in the port)
             "trainable": {"inception_v3": 23834568}}
ZOO_CHECK_TOL = {"out": 1e-3, "grad_l2": 0.1, "grad_floor": 1e-3}
# the surface held card against CPU at small shapes: values at rtol 1e-5,
# atol 1e-6 of float32 (op for op the same expressions; cuDNN and the CPU
# sum convolutions in other orders: 1e-5 there), and the gradients that
# sum over about a thousand terms or more (a deconvolution's bias and
# weight, a norm's gamma and beta) at atol 1e-4: float32 sums of 1,296
# unit terms in two orders differed by 2.3e-5 (H100 against the CPU)
# CTC's gradients (softmax less the label posterior: torch's kernel forms
# the posterior from alpha and beta, the plain recursion's comes through
# autograd of 50 log-space steps) at rtol 1e-4, atol 1e-5: they differed
# by up to 5.7e-5 of a value (on an H100). The contrib ops: values at rtol
# 1e-4, atol 1e-5 (the card contracts a bilinear sample's four products
# into FMAs: ROIAlign's outputs differed by 4.4e-6 on an H100), gradients
# at atol 1e-4 (atomic sums in the gathers' backward)
SURFACE_TOL = {"rtol": 1e-5, "atol": 1e-6, "conv_atol": 1e-5,
               "sum_atol": 1e-4, "ctc_grad_rtol": 1e-4}
# the samplers on the card and the CPU: 4 M draws each, the sample mean
# and variance within 6 standard errors of the closed form (a false alarm
# in about 1e-9 of checks); multinomial over lstm_lm_ptb_medium's decoder
# (20 rows x 10000 words, 20,000 draws a row); graphs over 65,536 draws
SAMPLER_CHECK = {"draws": 1 << 22, "sigmas": 6.0, "multinomial": (20, 10000),
                 "per_row": 20000, "capture_draws": 1 << 16}
# the linalg ops on a batch of SPD matrices (M M^T / n + I, so every
# eigenvalue lies in [1, 5]), the card against the CPU: each output
# within rtol of its largest magnitude (sums of 512 products in other
# orders, cuSOLVER's and LAPACK's algorithms); syevd and gelqf through
# their reconstructions and orthonormality, whose factors' signs differ
# between solvers; det and slogdet on 16 x 16 blocks (a 512 x 512 det
# overflows float32)
LINALG_CHECK = {"batch": 32, "n": 512, "det_n": 16,
                "rtol": {"float32": 2e-3, "float64": 1e-9}}


def _mobilenet_group(name):
    """MobileNet v2's kernel groups: PyTorch's depthwise kernels (float32
    NCHW with ``groups == channels`` does not go to cuDNN), the
    multi-tensor ``_foreach`` kernels (NAG's update), then the ResNet
    groups (every other convolution is a 1x1 pointwise one but the 3x3
    stem). ReLU6's kernels are elementwise ones among others; the eager
    batch's ``module_path_device_ms["clip"]`` attributes them by op."""
    low = name.lower()
    if "depthwise" in low:
        return "depthwise_forward" if "forward" in low else \
            "depthwise_backward"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "foreach"
    return _resnet_group(name)


_CLIP_OPS = ("aten::maximum", "aten::minimum", "MaximumBackward0",
             "MinimumBackward0")


def _clip_device_ms(prof):
    """Device ms of the kernels launched under ReLU6's ops (``clip`` is
    ``maximum`` then ``minimum``, as ``jnp.clip``, and their backward
    nodes), by each event's ``cpu_parent`` chain: an eager window only
    (a replay's kernels have no op)."""
    ms, seen = 0.0, False
    for e in prof.events():
        kern = getattr(e, "kernels", None) or []
        if not kern:
            continue
        seen = True
        p = e
        while p is not None and not any(k in p.name for k in _CLIP_OPS):
            p = p.cpu_parent
        if p is not None:
            ms += sum(k.duration for k in kern) / 1e3
    return ms if seen else "not measured"


def phase_mobilenet_module_fit(smi):
    """mobilenet_v2_1_0_module_fit: ``train_imagenet.py --benchmark 1
    --network mobilenet_v2_1_0`` through ``Module.fit`` (``MOBILENET_FIT``,
    13 batches a fit), four fits captured, eager, eager, captured, as
    resnet50_v1_module_fit: K1 one launch a batch over all 160 trainable
    tensors on its 16-byte path and nothing else, one capture then replays,
    a finite loss falling from the first to the last batch; one profiled
    batch of each mode by kernel group (depthwise forward and backward,
    pointwise and other convolutions, BatchNorm, clip, K1, the rest). Then
    one captured fit with ``--optimizer nag``: no K1 launch, NAG's
    ``_foreach`` update in K1's place (its device ms from a profiled
    batch)."""
    t_phase = time.perf_counter()
    cfg = MOBILENET_FIT
    dev = mx.gpu(0)
    mx.random.seed(0)
    net = get_network(cfg["network"], cfg["num_classes"], cfg["image_shape"])
    train = SyntheticDataIter(cfg["num_classes"],
                              (cfg["batch"],) + tuple(cfg["image_shape"]),
                              cfg["epoch_size"])
    batches = cfg["epoch_size"]
    runs, profs = [], {}
    modes = [("captured", "sgd"), ("eager", "sgd"), ("eager", "sgd"),
             ("captured", "sgd")] + [("captured", "nag")] * cfg["nag_fits"]
    for mode, optimizer in modes:
        fcfg = dict(cfg, optimizer=optimizer)
        prev = compile_service.set_enabled(mode == "captured")
        try:
            mx.random.seed(0)
            model, log, run = _module_fit_once(fcfg, net, train, dev)
            key = mode if optimizer == "sgd" else optimizer
            if key not in profs:
                train.reset()
                profs[key] = _profile_module_batch(
                    model, train.next(), mx.metric.create(["accuracy"]),
                    _mobilenet_group, {"clip": _clip_device_ms})
        finally:
            compile_service.set_enabled(prev)
        run.update(mode=mode, optimizer=optimizer)
        runs.append(run)
        want = dict.fromkeys(run["launches"], 0)
        if optimizer == "sgd":
            want["opt_sgd"] = batches
        site = run["executor_site"]
        want_site = {"misses": 1, "hits": batches - 1, "captures": 1,
                     "replays": 2 * (batches - 1)} if mode == "captured" \
            else {"misses": 0, "hits": 0, "captures": 0, "replays": 0}
        vec4 = cfg["tensors"] * batches if optimizer == "sgd" else 0
        losses = run["losses"]
        if run["launches"] != want or \
                run["k1_tensors_by_path"] != {"vec4": vec4, "scalar": 0} or \
                run["k1_gradient_copies"] or \
                {k: site[k] for k in want_site} != want_site or \
                not all(v is not None and math.isfinite(v) for v in losses) \
                or not losses[1] < losses[0] or not log.speeds:
            raise AssertionError(
                f"mobilenet fit {mode} {optimizer}: launches "
                f"{run['launches']} (expected {want}), K1 paths "
                f"{run['k1_tensors_by_path']}, executor site {site}, "
                f"losses {losses}, Speedometer {log.speeds}")
        if type(model._optimizer).__name__.lower() != optimizer:
            raise AssertionError(f"mobilenet fit: optimizer "
                                 f"{type(model._optimizer).__name__}")
        run["log_tail"] = log.lines[-2:]
        del model
        torch.cuda.empty_cache()
    sgd = [r for r in runs if r["optimizer"] == "sgd"]
    timed = {m: [v for r in sgd if r["mode"] == m
                 for v in r["batch_ms"][cfg["warmup"] - 1:]]
             for m in ("captured", "eager")}
    med = {m: statistics.median(v) for m, v in timed.items()}
    nag = [r for r in runs if r["optimizer"] == "nag"]
    nag_med = statistics.median([v for r in nag
                                 for v in r["batch_ms"][cfg["warmup"] - 1:]])
    cap = sgd[0]
    out = {"phase": "mobilenet_v2_1_0_module_fit", "card": smi,
           "config": cfg,
           "source": "examples/image_classification/train_imagenet.py "
                     "--benchmark 1 --network mobilenet_v2_1_0",
           "tf32": False, "batches": batches,
           "order": [f"{r['mode']}/{r['optimizer']}" for r in runs],
           "median_batch_ms": med["captured"],
           "median_batch_ms_eager": med["eager"],
           "img_per_s": cfg["batch"] / (med["captured"] / 1e3),
           "img_per_s_eager": cfg["batch"] / (med["eager"] / 1e3),
           "block_medians_ms": {m: [r["median_batch_ms"] for r in sgd
                                    if r["mode"] == m]
                                for m in ("captured", "eager")},
           "speedometer_img_per_s": cap["speedometer_img_per_s"],
           "speedometer_img_per_s_eager": sgd[1]["speedometer_img_per_s"],
           "max_memory_allocated": cap["max_memory_allocated"],
           "max_memory_allocated_eager": sgd[1]["max_memory_allocated"],
           "memory_allocated_before": cap["memory_allocated_before"],
           "update_host_ms": cap["update_host_ms"],
           "launches": cap["launches"],
           "k1_tensors_by_path": cap["k1_tensors_by_path"],
           "executor_site": cap["executor_site"],
           "losses": {f"{r['mode']}/{r['optimizer']}": r["losses"]
                      for r in runs},
           "train_accuracy": cap["train_accuracy"],
           "profiled_batch": profs["captured"],
           "eager_profiled_batch": profs["eager"],
           "nag": {"median_batch_ms": nag_med,
                   "launches": nag[0]["launches"],
                   "executor_site": nag[0]["executor_site"],
                   "losses": nag[0]["losses"],
                   "update_host_ms": nag[0]["update_host_ms"],
                   "profiled_batch": profs["nag"]},
           "log_tail": cap["log_tail"],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del net, train
    torch.cuda.empty_cache()
    return out


def _kernels_under(prof, label):
    """``(kernels, device ms)`` launched under the ``record_function``
    ``label`` of a profiled window."""
    n, ms = 0, 0.0
    for e in prof.events():
        kern = getattr(e, "kernels", None) or []
        if not kern:
            continue
        p = e
        while p is not None and p.name != label:
            p = p.cpu_parent
        if p is None:
            continue
        n += len(kern)
        ms += sum(k.duration for k in kern) / 1e3
    return n, ms


@contextlib.contextmanager
def _labelled_update():
    """Every ``opt_rules.apply`` under a ``record_function`` named
    ``opt_rules.apply``."""
    from torch.profiler import record_function

    from mxnet_tpu_torch.parallel import opt_rules

    real = opt_rules.apply

    def apply(*a, **k):
        with record_function("opt_rules.apply"):
            return real(*a, **k)

    opt_rules.apply = apply
    try:
        yield
    finally:
        opt_rules.apply = real


def _eager_update_profile(st, x, y):
    """One eager step under the profiler: the optimizer update's kernel
    count and device ms (the kernels a replay of the captured step runs
    for it: the graph holds the same launches), K1/K2's device ms by
    kernel name (launched through ctypes, outside any op), the step's
    window and busy share."""
    from torch.profiler import ProfilerActivity, profile

    prev = compile_service.set_enabled(False)
    try:
        torch.cuda.synchronize()
        with _labelled_update(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(st.step(x, y)._data.float())
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        compile_service.set_enabled(prev)
    n, ms = _kernels_under(prof, "opt_rules.apply")
    groups, _ = _device_split(prof, 1)
    fused = groups.get("optimizer", 0.0) / 1e3
    busy = sum(groups.values()) / 1e3
    return {"update_kernels": n, "update_device_ms": ms,
            "fused_kernel_device_ms": fused, "window_ms": window_ms,
            "device_ms": busy if groups else "not measured",
            "busy_share": busy / window_ms if groups else "not measured",
            "device_us_by_group": groups}


def phase_bert_lamb(smi):
    """bert_base_sst2_finetune_lamb: the train phase's captured
    ``ShardedTrainer`` step with "lamb" (``LAMB_TRAIN``): four blocks of 20
    steps from one state (captured, eager, eager, captured): step ms, the
    loss finite and falling, one capture then replays, launches (K3 12,
    K3-bwd 12 + 12, no K1/K2), the captured state after 3 and 20 steps
    against the eager one; LAMB's kernels and device ms per step (an eager
    step under the profiler: the same launches a replay makes) beside
    K2's in an "adam" step; the "adam" step's ms from the same call; and
    the host's synchronizing calls over 5 replays with the guard off
    (none expected)."""
    t_phase = time.perf_counter()
    cfg, tr, lt = BERT_BASE, TRAIN, LAMB_TRAIN
    weights = random_params(cfg, seed=0)
    x, y = make_task(tr["batch"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    xb, yb = mx.nd.array(x), mx.nd.array(y)

    def trainer(name, **kw):
        clf = _classifier_on(mx.gpu(0), cfg, weights)
        return ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              name, {"learning_rate": tr["lr"],
                                     "wd": tr["wd"]},
                              mesh=DeviceMesh({"dp": 1}), **kw)

    st = trainer("lamb")
    opt = st._opt
    if (opt.beta1, opt.beta2, opt.epsilon, opt.bias_correction,
            opt.lower_bound, opt.upper_bound) != (0.9, 0.999, 1e-6, True,
                                                   None, None):
        raise AssertionError("lamb: not at the JAX defaults")
    start = _snapshot(st)
    n = lt["steps"]
    blocks, kept = _trainer_blocks(
        st, xb, yb, [("captured", n), ("eager", n), ("eager", n),
                     ("captured", n)], start=start, snaps=(3, n))
    layers = cfg["layers"]
    for b in blocks:
        want = {"flash_attention": layers * n,
                "flash_attention.mma": layers * n,
                "flash_attention_bwd_dq": layers * n,
                "flash_attention_bwd_dq.mma": layers * n,
                "flash_attention_bwd_dkv": layers * n,
                "flash_attention_bwd_dkv.mma": layers * n}
        if b["launches"] != want or not all(map(math.isfinite,
                                                b["losses"])) \
                or not b["losses"][-1] < b["losses"][0]:
            raise AssertionError(f"lamb {b['mode']}: launches "
                                 f"{b['launches']}, losses {b['losses']}")
    if (blocks[0]["captures"], blocks[0]["replays"]) != (1, n - 1) or \
            (blocks[3]["captures"], blocks[3]["replays"]) != (0, n):
        raise AssertionError(f"lamb: captures/replays {blocks}")
    if st.skipped_steps:
        raise AssertionError(f"lamb: {st.skipped_steps} steps skipped")
    names = list(st._state_tensors())
    agreement = {k: _step_agreement(kept["captured"][k], kept["eager"][k],
                                    start[0], names) for k in (3, n)}
    _restore(st, start)
    lamb_prof = _eager_update_profile(st, xb, yb)
    replayed = _profiled_step(st, xb, yb, eager=False)
    del kept
    # the "adam" step of the same call, and K2's device time in it
    adam = trainer("adam")
    adam_blocks, _ = _trainer_blocks(adam, xb, yb,
                                     [("captured", lt["adam_steps"])])
    adam_prof = _eager_update_profile(adam, xb, yb)
    del adam
    torch.cuda.empty_cache()
    # host syncs over replays, the guard off
    quiet = trainer("lamb", nan_guard=False)
    for _ in range(2):   # the eager first step, then the capture
        quiet.step(xb, yb)
    torch.cuda.synchronize()
    syncs = _sync_count(lambda: [quiet.step(xb, yb)
                                 for _ in range(lt["sync_replays"])])
    torch.cuda.synchronize()
    if syncs:
        raise AssertionError(f"lamb: host syncs in replays: {syncs}")
    del quiet
    summary = _abba_summary(blocks, lt["warmup"])
    adam_ms = statistics.median(adam_blocks[0]["step_ms"][lt["warmup"]:])
    out = {"phase": "bert_base_sst2_finetune_lamb", "card": smi,
           "config": cfg, **tr, "lamb": {
               "beta1": opt.beta1, "beta2": opt.beta2,
               "epsilon": opt.epsilon, "bias_correction": True},
           "blocks": [{k: b[k] for k in (
               "mode", "step_ms", "losses", "launches",
               "max_memory_allocated", "captures", "capture_ms",
               "replays")} for b in blocks],
           **summary,
           "tokens_per_s": tr["batch"] * cfg["seq_len"] / (
               summary["median_step_ms"]["captured"] / 1e3),
           "adam_median_step_ms": adam_ms,
           "lamb_over_adam_step": summary["median_step_ms"]["captured"]
           / adam_ms,
           "lamb_update_kernels_per_step": lamb_prof["update_kernels"],
           "lamb_update_device_ms": lamb_prof["update_device_ms"],
           "adam_update_device_ms_k2": adam_prof["fused_kernel_device_ms"],
           "adam_update_kernels_per_step": adam_prof["update_kernels"],
           "trainable_tensors": len(st._param_names),
           "eager_step_profile": lamb_prof,
           "replayed_step_profile": replayed,
           "captured_vs_eager": agreement,
           "host_syncs_per_replays": syncs,
           "sync_replays": lt["sync_replays"],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del st
    torch.cuda.empty_cache()
    return out


def dcgan_nets(nn, ngf=16, ndf=16, nc=1):
    """``examples/gluon/dcgan.py:25-44`` (``build_nets``) over the port."""
    netG = nn.HybridSequential(prefix="gen_")
    with netG.name_scope():
        # latent (B, nz, 1, 1) -> (B, nc, 16, 16)
        netG.add(nn.Conv2DTranspose(ngf * 2, 4, 1, 0, use_bias=False),
                 nn.BatchNorm(), nn.Activation("relu"),
                 nn.Conv2DTranspose(ngf, 4, 2, 1, use_bias=False),
                 nn.BatchNorm(), nn.Activation("relu"),
                 nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False),
                 nn.Activation("tanh"))
    netD = nn.HybridSequential(prefix="disc_")
    with netD.name_scope():
        netD.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False),
                 nn.LeakyReLU(0.2),
                 nn.Conv2D(ndf * 2, 4, 2, 1, use_bias=False),
                 nn.BatchNorm(), nn.LeakyReLU(0.2),
                 nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return netG, netD


def dcgan_images(num_examples, rs):
    """``dcgan.py:62-69``: 16x16 gaussian bumps in [-1, 1]."""
    yy, xx = np.mgrid[0:16, 0:16] / 15.0
    centers = rs.rand(num_examples, 2)
    real = np.tanh(3.0 * np.exp(
        -(((xx[None] - centers[:, 0, None, None]) ** 2 +
           (yy[None] - centers[:, 1, None, None]) ** 2) / 0.05)) - 0.5)
    return real[:, None].astype(np.float32)


def _dcgan_iteration(mx_, netG, netD, trainerG, trainerD, bce, data, noise,
                     ones, zeros, b):
    """One iteration of ``dcgan.py:84-97``: the D step on the real and the
    detached fake batch, then the G step."""
    autograd = mx_.autograd
    fake = netG(noise)
    with autograd.record():
        out_real = netD(data).reshape((-1,))
        out_fake = netD(fake.detach()).reshape((-1,))
        lossD = bce(out_real, ones) + bce(out_fake, zeros)
    lossD.backward()
    trainerD.step(b)
    with autograd.record():
        out = netD(netG(noise)).reshape((-1,))
        lossG = bce(out, ones)
    lossG.backward()
    trainerG.step(b)
    return lossD, lossG


def _dcgan_setup(cfg, ctx, weights=None):
    nn = mx.gluon.nn
    netG, netD = dcgan_nets(nn)
    netG.initialize(mx.init.Normal(0.02), ctx=ctx,
                    generator=torch.Generator().manual_seed(1))
    netD.initialize(mx.init.Normal(0.02), ctx=ctx,
                    generator=torch.Generator().manual_seed(2))
    netD(netG(mx.nd.zeros((2, cfg["nz"], 1, 1), ctx=ctx)))
    if weights is not None:
        for net, w in zip((netG, netD), weights):
            load_jax_params(net, w)
    trainerG = mx.gluon.Trainer(netG.collect_params(), "adam",
                                {"learning_rate": cfg["lr"], "beta1": 0.5})
    trainerD = mx.gluon.Trainer(netD.collect_params(), "adam",
                                {"learning_rate": cfg["lr"], "beta1": 0.5})
    return netG, netD, trainerG, trainerD


def phase_dcgan(smi):
    """dcgan: ``examples/gluon/dcgan.py`` at its defaults (``DCGAN``),
    ``build_nets`` and the loop copied here. First two iterations from one
    set of weights and one numpy batch of images and noise on the card and
    on a CPU copy (``DCGAN_TOL``); then the example's run: 3 epochs of 16
    iterations, iteration ms, K2 two launches an iteration (the two
    trainers' steps), the D and G losses finite each epoch, 4 finite
    samples of 1x16x16."""
    t_phase = time.perf_counter()
    cfg = DCGAN
    b = cfg["batch"]
    rs = np.random.RandomState(0)
    real = dcgan_images(cfg["num_examples"], rs)
    # the check: card against a CPU copy
    check_noise = rs.randn(cfg["check_iters"], b, cfg["nz"], 1, 1).astype(
        np.float32)
    card = _dcgan_setup(cfg, mx.gpu(0))
    start = [export_params(n) for n in card[:2]]
    nets = {"card": card, "cpu": _dcgan_setup(cfg, mx.cpu(), start)}
    losses = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        netG, netD, tG, tD = nets[where]
        bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        ones, zeros = mx.nd.ones((b,), ctx=ctx), mx.nd.zeros((b,), ctx=ctx)
        losses[where] = []
        for i in range(cfg["check_iters"]):
            lD, lG = _dcgan_iteration(
                mx, netG, netD, tG, tD, bce,
                mx.nd.array(real[i * b:(i + 1) * b], ctx=ctx),
                mx.nd.array(check_noise[i], ctx=ctx), ones, zeros, b)
            losses[where].append([float(lD.mean().asscalar()),
                                  float(lG.mean().asscalar())])
    got, want = np.array(losses["card"]), np.array(losses["cpu"])
    if not np.allclose(got, want, rtol=DCGAN_TOL["loss_rtol"], atol=0):
        raise AssertionError(f"dcgan check: losses {got} on the card, "
                             f"{want} on the CPU")
    worst = 0.0
    for k, net in enumerate(("G", "D")):
        card_p = export_params(nets["card"][k])
        cpu_p = export_params(nets["cpu"][k])
        for name, s0 in start[k].items():
            step = float(np.linalg.norm(cpu_p[name] - s0))
            err = float(np.linalg.norm(card_p[name] - cpu_p[name]))
            share = err / max(step, 1e-30) if err else 0.0
            worst = max(worst, share)
            if share > DCGAN_TOL["step_l2"]:
                raise AssertionError(f"dcgan check: {net} {name} off by "
                                     f"{share} of its step")
    check = {"losses_card": losses["card"], "losses_cpu": losses["cpu"],
             "max_step_l2_share": worst}
    del nets
    # the example's run (dcgan.py:55-105), on the card
    mx.random.seed(0)
    netG, netD, trainerG, trainerD = _dcgan_setup(cfg, mx.gpu(0))
    bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = mx.nd.ones((b,)), mx.nd.zeros((b,))
    nbatch = cfg["num_examples"] // b
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    epochs, it_ms = [], []
    for epoch in range(cfg["epochs"]):
        perm = rs.permutation(cfg["num_examples"])
        d_tot = g_tot = 0.0
        for i in range(nbatch):
            t0 = time.perf_counter()
            data = mx.nd.array(real[perm[i * b:(i + 1) * b]])
            noise = mx.nd.random.normal(shape=(b, cfg["nz"], 1, 1))
            lossD, lossG = _dcgan_iteration(mx, netG, netD, trainerG,
                                            trainerD, bce, data, noise,
                                            ones, zeros, b)
            d_tot += float(lossD.mean().asscalar())
            g_tot += float(lossG.mean().asscalar())
            it_ms.append((time.perf_counter() - t0) * 1e3)
        epochs.append([d_tot / nbatch, g_tot / nbatch])
    samples = netG(mx.nd.random.normal(shape=(4, cfg["nz"], 1, 1))).asnumpy()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    iters = cfg["epochs"] * nbatch
    if launches != {"opt_adam": 2 * iters} or \
            not np.isfinite(np.array(epochs)).all() or \
            samples.shape != (4, 1, 16, 16) or \
            not np.isfinite(samples).all():
        raise AssertionError(f"dcgan: launches {launches} (expected "
                             f"opt_adam {2 * iters}), epoch losses {epochs}, "
                             f"samples {samples.shape}")
    out = {"phase": "dcgan", "card": smi, "config": cfg,
           "source": "examples/gluon/dcgan.py", "check": check,
           "tolerance": DCGAN_TOL, "iterations": iters,
           "epoch_losses": epochs,
           "median_iteration_ms": statistics.median(it_ms[nbatch:]),
           "iteration_ms_first_epoch": it_ms[:nbatch],
           "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def _no_dropout(net):
    """Dropout's rate set to 0 in every Dropout block of ``net`` (the
    names of those blocks)."""
    names = []

    def walk(block):
        if isinstance(block, mx.gluon.nn.Dropout):
            block._rate = 0.0
            names.append(block.name)
        for child in block._children.values():
            walk(child)

    walk(net)
    return names


def phase_zoo_check():
    """zoo_check: each family's default constructor (``ZOO_CHECK``), one
    training forward (BatchNorm on batch statistics) and backward of the
    summed logits times a fixed head, on the card and on a CPU copy from
    the same weights (Dropout at rate 0 in both), held to
    ``ZOO_CHECK_TOL`` (every model measured before the check fails);
    parameter counts."""
    cfg, tol = ZOO_CHECK, ZOO_CHECK_TOL
    out = {}
    for name, size in cfg["models"].items():
        t0 = time.perf_counter()
        rs = np.random.RandomState(0)
        x = rs.uniform(-1, 1, (cfg["batch"], 3, size, size)).astype(
            np.float32)
        head = rs.randn(cfg["batch"], cfg["classes"]).astype(np.float32)
        res = {}
        weights = None
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            net = vision.get_model(name, classes=cfg["classes"])
            net.initialize(mx.init.Xavier(), ctx=ctx,
                           generator=torch.Generator().manual_seed(0))
            net(mx.nd.array(x[:1], ctx=ctx))
            if weights is None:
                weights = export_params(net)
            else:
                load_jax_params(net, weights)
            dropped = _no_dropout(net)
            xs = mx.nd.array(x, ctx=ctx)
            with mx.autograd.record():
                y = net(xs)
                loss = (y * mx.nd.array(head, ctx=ctx)).sum()
            loss.backward()
            res[where] = (y.asnumpy(), {
                n: p.grad().asnumpy() for n, p in
                net._collect_params_with_structure().items()
                if p.grad_req != "null"})
            count = sum(int(np.prod(p.shape)) for p in
                        net.collect_params().values())
            trainable = sum(int(np.prod(p.shape)) for p in
                            net.collect_params().values()
                            if p.grad_req != "null")
            del net
        (yc, gc), (yh, gh) = res["card"], res["cpu"]
        out_err = float(np.abs(yc - yh).max()) / max(
            float(np.abs(yh).max()), 1e-30)
        norms = {n: float(np.linalg.norm(gh[n])) for n in gh}
        floor = tol["grad_floor"] * max(norms.values())
        shares = {n: float(np.linalg.norm(gc[n] - gh[n]))
                  / max(norms[n], floor, 1e-30) for n in gh}
        worst = sorted(shares, key=shares.get, reverse=True)[:3]
        out[name] = {"size": size, "parameters": count,
                     "trainable": trainable,
                     "tensors": len(gh), "max_logit_err": out_err,
                     "max_grad_l2_err": shares[worst[0]],
                     "worst_grads": {n: [shares[n], norms[n]]
                                     for n in worst},
                     "finite": bool(np.isfinite(yc).all()),
                     "dropout_rate_0": dropped,
                     "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    line = {"phase": "zoo_check", "config": cfg, "tolerance": tol,
            "tf32": False, "models": out}
    emit(line)
    bad = {n: (m["max_logit_err"], m["max_grad_l2_err"])
           for n, m in out.items() if m["max_logit_err"] > tol["out"]
           or m["max_grad_l2_err"] > tol["grad_l2"] or not m["finite"]}
    bad.update((n, ("trainable", out[n]["trainable"], want))
               for n, want in cfg["trainable"].items()
               if n in out and out[n]["trainable"] != want)
    if bad:
        raise AssertionError(f"zoo_check: logits and gradient errors "
                             f"{bad} beyond {tol}")
    return line


def _surface_close(what, got, want, atol=None, rtol=None):
    """``got`` (the card's) against ``want`` (the CPU's) at
    ``SURFACE_TOL``; the largest absolute difference."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(
        got, want, rtol=rtol or SURFACE_TOL["rtol"],
        atol=atol or SURFACE_TOL["atol"], msg=lambda m: f"{what}: {m}")
    return err


def _surface_rules_mp(errs):
    """Every new rule on the master route (float16 weights under
    ``multi_precision``) through ``opt_rules.apply`` itself, 3 steps from
    the same weights and gradients on the card and on the CPU: the
    float32 masters, and each weight its master rounded."""
    from mxnet_tpu_torch.optimizer import optimizer as popt
    from mxnet_tpu_torch.parallel import opt_rules

    shapes = [(64, 33), (129,), (8, 3, 3, 3)]
    rs = np.random.RandomState(4)
    w0 = [rs.randn(*sh).astype(np.float16) for sh in shapes]
    gs = [[(rs.randn(*sh) * 0.5).astype(np.float16) for sh in shapes]
          for _ in range(3)]
    names = sorted(set(opt_rules.RULES) - {"signsgd", "sgd", "adam",
                                            "sgld"})
    for name in names:
        kw = dict(wd=1e-3, clip_gradient=0.5, multi_precision=True,
                  **_SURFACE_EXTRA.get(name, {}))
        if name in _SURFACE_MOMENTUM:
            kw["momentum"] = 0.9
        res = {}
        for where, dev in (("card", mx.gpu(0).torch_device()),
                           ("cpu", torch.device("cpu"))):
            opt = popt.create(name, **kw)
            rule = opt_rules.RULES[name]
            ws = [torch.tensor(w, device=dev) for w in w0]
            routes = opt_rules.Routes([w.dtype for w in ws], True)
            states = [opt_rules.init_state(rule, opt, w, True) for w in ws]
            grads32 = [torch.empty(w.shape, device=dev) for w in ws]
            lr = torch.tensor(0.02, device=dev)
            with torch.no_grad():
                for step, g in enumerate(gs, 1):
                    opt_rules.apply(rule, opt, routes, ws, [
                        torch.tensor(x, device=dev) for x in g], states,
                        grads32, lr, [1e-3] * len(ws),
                        torch.tensor(float(step), device=dev), None)
            res[where] = [st[0] for st in states], ws
        for i, (a, b) in enumerate(zip(res["card"][0], res["cpu"][0])):
            errs[f"rule_master/{name}"] = max(
                errs.get(f"rule_master/{name}", 0.0),
                _surface_close(f"rule {name} master {i}", a, b))
        for m, w in zip(*res["card"]):
            if not torch.equal(w, m.to(w.dtype)):
                raise AssertionError(f"surface rule {name}: a float16 "
                                     "weight is not its master rounded")


# the optimizers' hyper-parameters in the surface checks beyond rate,
# decay and clip: momentum where the optimizer has one, LBSGD's warm-up
# with accumulation, RMSProp's centred form
_SURFACE_EXTRA = {"lbsgd": dict(batch_scale=2, warmup_epochs=1,
                                updates_per_epoch=2),
                  "rmsprop": dict(centered=True)}
_SURFACE_MOMENTUM = {"nag", "signum", "lars", "lbsgd", "dcasgd"}


def _surface_optimizers(errs):
    """Every optimizer of the zoo through ``Updater.update_multi`` (3
    steps; float32, and float16 under ``multi_precision``: the masters)
    and through ``ShardedTrainer`` (3 steps of a 2-layer tanh MLP), card
    against CPU."""
    from mxnet_tpu_torch.optimizer import optimizer as popt

    shapes = [(64, 33), (129,), (8, 3, 3, 3)]
    rs = np.random.RandomState(0)
    w0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rs.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    names = sorted(set(popt._ZOO) - {"sgd", "adam"})
    for name in names:
        kw = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.5,
                  rescale_grad=0.5, **_SURFACE_EXTRA.get(name, {}))
        if name in _SURFACE_MOMENTUM:
            kw["momentum"] = 0.9
        for dtype, mp in (("float32", False), ("float16", True)):
            res = {}
            for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
                mx.random.seed(3)
                up = popt.get_updater(popt.create(name, multi_precision=mp,
                                                  **kw))
                ws = [mx.nd.array(w, ctx=ctx).astype(dtype) for w in w0]
                for step in gs:
                    up.update_multi([0, 1, 2], [mx.nd.array(
                        g, ctx=ctx).astype(dtype) for g in step], ws)
                masters = [up.states[i][0] if mp else ws[i]
                           for i in range(3)]
                res[where] = [m._data for m in masters]
            if name == "sgld":
                # the noise differs by generator: its size only
                for a, b in zip(res["card"], res["cpu"]):
                    if not torch.isfinite(a).all() or float(
                            (a.cpu() - b).std()) > 3 * math.sqrt(0.05):
                        raise AssertionError("surface sgld: noise")
                continue
            for i, (a, b) in enumerate(zip(res["card"], res["cpu"])):
                errs[f"updater/{name}/{dtype}"] = max(
                    errs.get(f"updater/{name}/{dtype}", 0.0),
                    _surface_close(f"updater {name} {dtype} {i}", a, b))
    from mxnet_tpu_torch.parallel.opt_rules import RULES

    for name in sorted(set(RULES) - {"signsgd", "sgd", "adam", "sgld"}):
        kw = dict(learning_rate=0.02, wd=1e-3, clip_gradient=0.5,
                  **_SURFACE_EXTRA.get(name, {}))
        if name in _SURFACE_MOMENTUM:
            kw["momentum"] = 0.9
        res = {}
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            net = mx.gluon.nn.HybridSequential(prefix="s_")
            with net.name_scope():
                net.add(mx.gluon.nn.Dense(32, activation="tanh",
                                          in_units=16),
                        mx.gluon.nn.Dense(4, in_units=32))
            net.initialize(mx.init.Xavier(), ctx=ctx,
                           generator=torch.Generator().manual_seed(0))
            st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                name, dict(kw), mesh=DeviceMesh(
                                    {"dp": 1}, devices=[ctx]))
            rs = np.random.RandomState(1)
            for _ in range(3):
                st.step(mx.nd.array(rs.randn(8, 16).astype(np.float32),
                                    ctx=ctx),
                        mx.nd.array(rs.randint(0, 4, 8).astype(np.float32),
                                    ctx=ctx))
            res[where] = [h._data for h in st._train_handles]
        for i, (a, b) in enumerate(zip(res["card"], res["cpu"])):
            errs[f"rule/{name}"] = max(errs.get(f"rule/{name}", 0.0),
                                       _surface_close(f"rule {name} {i}",
                                                      a, b, atol=1e-5))


def _surface_op(errs, what, name, arrays, kw, argnums, atol=None,
                grad_atol=None):
    """Op ``name`` forward and the gradient of a fixed head over
    ``argnums``, card against CPU (the gradients at ``grad_atol``, else
    ``atol``)."""
    from mxnet_tpu_torch.ops import registry as reg

    res = {}
    rs = np.random.RandomState(9)
    for where, dev in (("card", mx.gpu(0).torch_device()), ("cpu", "cpu")):
        ts = [torch.tensor(a, device=dev) for a in arrays]
        for i in argnums:
            ts[i].requires_grad_(True)
        out = reg.get(name)(*ts, **kw)
        out = out[0] if isinstance(out, tuple) else out
        head = torch.tensor(rs.randn(*out.shape).astype(np.float32),
                            device=dev) if where == "card" else \
            res["card"][2].cpu()
        grads = torch.autograd.grad(out, [ts[i] for i in argnums],
                                    head) if argnums else []
        res[where] = (out, grads, head)
    errs[what] = _surface_close(what, res["card"][0], res["cpu"][0],
                                atol=atol)
    for i, (a, b) in enumerate(zip(res["card"][1], res["cpu"][1])):
        errs[what] = max(errs[what], _surface_close(
            f"{what} grad {i}", a, b, atol=grad_atol or atol))


def phase_surface_check():
    """surface_check: the slice's surface on the card against the CPU
    (``SURFACE_TOL``): every new optimizer through ``Updater.update_multi``
    and through ``ShardedTrainer``'s rules (float32 weights, and float16
    ones with float32 masters through ``opt_rules.apply``); Deconvolution (grouped, and
    with ``target_shape``); CTCLoss (the card's ``torch.nn.functional.
    ctc_loss`` against the plain recursion on the card and the CPU,
    values and gradients); LRN, UpSampling, InstanceNorm, GroupNorm and
    the LeakyReLU modes."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    t0 = time.perf_counter()
    errs = {}
    _surface_optimizers(errs)
    _surface_rules_mp(errs)
    rs = np.random.RandomState(2)
    f32 = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    conv, sums = SURFACE_TOL["conv_atol"], SURFACE_TOL["sum_atol"]
    _surface_op(errs, "deconvolution", "Deconvolution",
                [f32(4, 8, 9, 9), f32(8, 6, 4, 4), f32(6)],
                dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
                     num_filter=6, no_bias=False), (0, 1, 2), atol=conv, grad_atol=sums)
    _surface_op(errs, "deconvolution_grouped", "Deconvolution",
                [f32(4, 8, 9, 9), f32(8, 3, 3, 3)],
                dict(kernel=(3, 3), stride=(2, 2), num_filter=6,
                     num_group=2, dilate=(2, 2)), (0, 1), atol=conv, grad_atol=sums)
    _surface_op(errs, "deconvolution_target_shape", "Deconvolution",
                [f32(2, 4, 5, 5), f32(4, 3, 4, 4)],
                dict(kernel=(4, 4), stride=(2, 2), num_filter=3,
                     target_shape=(10, 9)), (0, 1), atol=conv, grad_atol=sums)
    _surface_op(errs, "lrn", "LRN", [np.abs(f32(4, 16, 7, 7)) + 0.1],
                dict(alpha=1e-2, nsize=5), (0,))
    _surface_op(errs, "upsampling_nearest", "UpSampling",
                [f32(2, 3, 5, 5)], dict(scale=2), (0,))
    _surface_op(errs, "upsampling_bilinear", "UpSampling",
                [f32(2, 3, 5, 5), f32(3, 1, 4, 4)],
                dict(scale=2, sample_type="bilinear", num_filter=3), (0,))
    _surface_op(errs, "instance_norm", "InstanceNorm",
                [f32(4, 6, 8, 8), f32(6), f32(6)], {}, (0, 1, 2),
                atol=conv, grad_atol=sums)
    _surface_op(errs, "group_norm", "GroupNorm",
                [f32(4, 6, 8, 8), f32(6), f32(6)], dict(num_groups=3),
                (0, 1, 2), atol=conv, grad_atol=sums)
    for act in ("leaky", "elu", "selu", "gelu", "rrelu"):
        _surface_op(errs, f"leaky_relu_{act}", "LeakyReLU", [f32(8, 33)],
                    dict(act_type=act, slope=0.3), (0,))
    _surface_op(errs, "leaky_relu_prelu", "LeakyReLU",
                [f32(4, 3, 5, 5), f32(3)], dict(act_type="prelu"), (0, 1))
    # CTC: the card's torch op against the recursion on the card and the
    # CPU, values and gradients (the route by device, decided up front)
    data = f32(50, 8, 20)
    label = rs.randint(1, 20, (8, 10)).astype(np.float32)
    for i, n in enumerate((10, 7, 3, 10, 1, 5, 8, 9)):
        label[i, n:] = 0
    res = {}
    for route in ("card_torch", "card_plain", "cpu_plain"):
        dev = "cpu" if route == "cpu_plain" else mx.gpu(0).torch_device()
        d = torch.tensor(data, device=dev, requires_grad=True)
        lab = torch.tensor(label, device=dev)
        if route == "card_plain":
            logp = torch.log_softmax(d, -1)
            lens = nn_ops.ctc_lengths(lab.to(torch.int64), "first")
            loss = nn_ops.ctc_plain(logp, lab.to(torch.int64), lens,
                                    torch.full((8,), 50, device=dev), 0)
        else:
            loss = mx.nd.CTCLoss(mx.nd.NDArray(d), mx.nd.NDArray(lab))._data
        (grad,) = torch.autograd.grad(loss.sum(), [d])
        res[route] = (loss, grad)
    for route in ("card_plain", "cpu_plain"):
        errs[f"ctc_torch_vs_{route}"] = max(
            _surface_close(f"ctc {route}", res["card_torch"][0],
                           res[route][0], atol=1e-4),
            _surface_close(f"ctc {route} grad", res["card_torch"][1],
                           res[route][1], atol=1e-5,
                           rtol=SURFACE_TOL["ctc_grad_rtol"]))
    # torch takes cuDNN's CTC only for int32 targets on the host; the op
    # passes int64 targets on the card, so torch's own CUDA kernel runs
    samplers = _surface_samplers()
    linalg = _surface_linalg(errs)
    _surface_function(errs)
    contrib = _surface_contrib(errs)
    contrib["control_flow"] = _surface_control_flow()
    line = {"phase": "surface_check", "tolerance": SURFACE_TOL,
            "max_abs_err": errs, "ctc_route": {
                "card": "torch.nn.functional.ctc_loss, torch's CUDA kernel",
                "cpu": "plain recursion"},
            "samplers": samplers, "linalg": linalg, "contrib": contrib,
            "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def _surface_linalg(errs):
    """The ``linalg_*`` ops and ``khatri_rao`` on ``LINALG_CHECK``'s SPD
    batch in float32 and float64, the card against the CPU, every op but
    ``linalg_syevd`` with no host sync on the card (``_sync_count``);
    ``linalg_potrf`` inside a ``compile.jit`` graph (``cholesky_ex``: no
    host sync) on a batch with one matrix that is not positive definite:
    NaN there, the others' factors; a ``compile.jit`` body holding
    ``linalg_syevd`` (a host op: eigh reads cuSOLVER's status back)
    uncaptured under its reason."""
    cfg = LINALG_CHECK
    rs = np.random.RandomState(4)
    n, bsz, dn = cfg["n"], cfg["batch"], cfg["det_n"]
    m = rs.randn(bsz, n, n)
    spd = m @ m.transpose(0, 2, 1) / n + np.eye(n)
    rhs = rs.randn(bsz, n, 64)
    out = {}
    nd = mx.nd

    def others(a, b, lam, eye):
        """Every op but ``linalg_syevd``."""
        low = nd.linalg_potrf(a)
        q, lq = nd.linalg_gelqf(a[:, :64, :])
        return {
            "potrf": low, "potri": nd.linalg_potri(low),
            "trmm": nd.linalg_trmm(low, b),
            "trsm": nd.linalg_trsm(low, b),
            "trsm_right": nd._linalg_trsm(low, b.transpose((0, 2, 1)),
                                          rightside=True, transpose=True),
            "gemm": nd.linalg_gemm(a, b, b, alpha=0.5, beta=2.0),
            "gemm2": nd.linalg_gemm2(b, b, transpose_a=True),
            "syrk": nd.linalg_syrk(b, transpose=True, alpha=0.5),
            "gelqf_reconstruction": nd.linalg_gemm2(lq, q),
            "gelqf_orthonormality": nd.linalg_gemm2(
                q, q, transpose_b=True) - eye,
            "sumlogdiag": nd.linalg_sumlogdiag(low),
            "extractdiag": nd.linalg_extractdiag(a, offset=1),
            "makediag": nd.linalg_makediag(lam[:, :32], offset=-1),
            "extracttrian": nd.linalg_extracttrian(low[:, :64, :64]),
            "maketrian": nd.linalg_maketrian(
                nd.linalg_extracttrian(low[:, :64, :64])),
            "inverse": nd.linalg_inverse(a),
            "det": nd.linalg_det(a[:, :dn, :dn]),
            "slogdet": nd.linalg_slogdet(a)[1],
            "khatri_rao": nd.khatri_rao(b[0, :8, :], b[1, :16, :])}

    op_syncs = {}
    for dtype in ("float32", "float64"):
        rtol = cfg["rtol"][dtype]
        res = {}
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            a = nd.array(spd, ctx=ctx, dtype=dtype)
            b = nd.array(rhs, ctx=ctx, dtype=dtype)
            u, lam = nd.linalg_syevd(a)
            eye = nd.array(np.eye(64), ctx=ctx, dtype=dtype)
            res[where] = dict(others(a, b, lam, eye), syevd_values=lam,
                              syevd_reconstruction=nd.linalg_gemm2(
                                  u * lam.expand_dims(2), u,
                                  transpose_a=True))
            if where == "card":
                op_syncs[dtype] = _sync_count(
                    lambda: others(a, b, lam, eye))
        worst = 0.0
        for k, got in res["card"].items():
            want = res["cpu"][k]._data
            scale = max(float(want.abs().max()), 1.0) if k.endswith(
                "orthonormality") else float(want.abs().max())
            err = float((got._data.cpu() - want).abs().max())
            errs[f"linalg_{k}_{dtype}"] = err
            worst = max(worst, err / scale)
            if not err <= rtol * scale:
                raise AssertionError(f"linalg {k} {dtype}: card against "
                                     f"CPU {err} of {scale}, beyond {rtol}")
        out[dtype] = {"max_share_of_largest": worst, "ops": len(res["card"])}
    # inside a graph: cholesky_ex reads no status back to the host
    bad = spd[:4].copy()
    bad[2] = -bad[2]
    x = torch.tensor(bad, dtype=torch.float32, device=mx.gpu(0).torch_device())
    f = compile_service.jit(lambda t: mx.nd.linalg_potrf(mx.nd.NDArray(t))
                            ._data, site="surface", token=("potrf",))
    f(x)
    got = f(x)
    syncs = _sync_count(lambda: mx.nd.linalg_potrf(mx.nd.NDArray(x)))
    want = torch.linalg.cholesky(torch.tensor(spd[[0, 1, 3]],
                                              dtype=torch.float64))
    lower = torch.ones_like(got[2], dtype=torch.bool).tril()
    nan_ok = bool(torch.equal(torch.isnan(got[2]), lower))
    good = float((got[[0, 1, 3]].double().cpu() - want).abs().max())
    if not nan_ok or good > 1e-3 or syncs:
        raise AssertionError(f"potrf in a graph: NaN factor {nan_ok}, the "
                             f"others {good} off, host syncs {syncs}")
    out["potrf_in_graph"] = {"not_positive_definite_gives_nan": nan_ok,
                             "others_max_abs_err": good, "host_syncs": syncs,
                             "captures": f.stats()["captures"]}
    if any(op_syncs.values()):
        raise AssertionError(f"linalg: the ops but syevd synced {op_syncs}")
    out["host_syncs_but_syevd"] = op_syncs
    # syevd: a host op, so a body holding it runs uncaptured
    e = compile_service.jit(lambda t: mx.nd.linalg_syevd(mx.nd.NDArray(t))[1]
                            ._data, site="surface", token=("syevd",))
    a = torch.tensor(spd[:4], dtype=torch.float32,
                     device=mx.gpu(0).torch_device())
    for _ in range(3):
        lam = e(a)
    st = e.stats()
    reasons = [x.get("reason") for x in st["entries"]]
    want = torch.linalg.eigvalsh(torch.tensor(spd[:4]))
    err = float((lam.double().cpu() - want).abs().max())
    if st["captures"] or reasons != ["host op linalg_syevd"] or \
            err > 1e-3 * float(want.abs().max()):
        raise AssertionError(f"syevd in a jit body: {st}, {err} off")
    out["syevd_in_jit"] = {"captures": st["captures"], "reasons": reasons,
                           "max_abs_err": err}
    return out


def _surface_function(errs):
    """An ``autograd.Function`` (a sigmoid with its own backward) forward
    and gradient, the card against the CPU."""
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x_np = np.random.RandomState(6).randn(64, 1000).astype(np.float32)
    res = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        x = mx.nd.array(x_np, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = Sigmoid()(x)
            loss = (y * y).sum()
        loss.backward()
        res[where] = (y._data, x.grad._data)
    errs["autograd_function"] = _surface_close(
        "autograd.Function", res["card"][0], res["cpu"][0])
    errs["autograd_function_grad"] = _surface_close(
        "autograd.Function grad", res["card"][1], res["cpu"][1])


def _contrib_cases(rs):
    """``(what, op, arrays, kwargs, differentiable input indices)`` of the
    contrib surface on the card: every op of ``ops/contrib_ops.py`` at
    moderate shapes, ties in the scores of NMS and ``MultiBoxTarget``."""
    f32 = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731

    def boxes(*lead):
        xy = rs.uniform(0, 0.7, lead + (2,))
        return np.concatenate([xy, xy + rs.uniform(0.05, 0.3, lead + (2,))],
                              -1).astype(np.float32)

    def rois(r, b, h, w):
        x1, y1 = rs.uniform(-1, w - 4, r), rs.uniform(-1, h - 4, r)
        return np.stack([rs.randint(0, b, r), x1, y1,
                         x1 + rs.uniform(1, 8, r), y1 + rs.uniform(1, 8, r)],
                        1).astype(np.float32)

    anchors = np.asarray(_contrib_prior(16), np.float32)
    n = anchors.shape[1]
    label = np.full((8, 6, 5), -1, np.float32)
    for i in range(8):
        k = rs.randint(1, 7)
        label[i, :k, 0] = rs.randint(0, 20, k)
        label[i, :k, 1:] = boxes(k)
    det = np.concatenate([rs.randint(0, 4, (8, 500, 1)),
                          np.round(rs.uniform(0, 1, (8, 500, 1)), 1),
                          boxes(8, 500)], -1).astype(np.float32)
    det[:, 1] = det[:, 0]                        # duplicate boxes and scores
    logits = f32(8, 21, n) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ys, xs = np.meshgrid(np.linspace(-1, 1, 24), np.linspace(-1, 1, 20),
                         indexing="ij")
    centres = np.stack([xs, ys])[None].repeat(4, 0).astype(np.float32)
    img = rs.randint(0, 256, (4, 48, 64, 3)).astype(np.uint8)
    bn = [f32(8, 16, 12, 12), rs.uniform(.5, 1.5, 16).astype(np.float32),
          f32(16), f32(16) * .1, rs.uniform(.5, 1.5, 16).astype(np.float32)]
    return [
        ("fft", "_contrib_fft", [f32(64, 256)], {}, (0,)),
        ("ifft", "_contrib_ifft", [f32(64, 512)], {}, (0,)),
        ("multibox_prior", "MultiBoxPrior", [f32(2, 8, 32, 32)],
         dict(sizes=(.1, .141), ratios=(1, 2, .5), clip=True), ()),
        ("box_iou", "_contrib_box_iou", [boxes(4, 100), boxes(4, 30)], {},
         (0, 1)),
        ("box_nms", "box_nms", [det],
         dict(overlap_thresh=.5, valid_thresh=.1, topk=100, id_index=0),
         (0,)),
        ("box_nms_center", "box_nms", [det],
         dict(overlap_thresh=.3, force_suppress=True, in_format="center"),
         (0,)),
        ("multibox_target", "MultiBoxTarget",
         [anchors, label, np.round(prob * 8) / 8],
         dict(negative_mining_ratio=3, negative_mining_thresh=.5), ()),
        ("multibox_detection", "MultiBoxDetection",
         [prob, f32(8, n * 4) * .2, anchors],
         dict(nms_threshold=.45, nms_topk=100), (0, 1)),
        ("box_encode", "_contrib_box_encode",
         [(rs.uniform(0, 1, (4, 64)) > .5).astype(np.float32),
          rs.randint(-1, 6, (4, 64)).astype(np.float32), boxes(4, 64),
          boxes(4, 6)], {}, (2, 3)),
        ("box_decode", "_contrib_box_decode", [f32(4, 64, 4), boxes(1, 64)],
         dict(clip=2.0), (0, 1)),
        ("bipartite_matching", "_contrib_bipartite_matching",
         [np.round(rs.uniform(0, 1, (4, 30, 20)) * 8) / 8], {}, ()),
        ("roi_pooling", "ROIPooling",
         [f32(2, 16, 32, 32), rois(64, 2, 32, 32)],
         dict(pooled_size=(7, 7), spatial_scale=1.0), (0,)),
        ("roi_align", "_contrib_ROIAlign",
         [f32(2, 16, 32, 32), rois(64, 2, 32, 32)],
         dict(pooled_size=(7, 7), sample_ratio=2), (0, 1)),
        ("grid_generator", "GridGenerator", [f32(4, 6)],
         dict(transform_type="affine", target_shape=(24, 20)), (0,)),
        ("grid_generator_warp", "GridGenerator", [f32(4, 2, 24, 20)],
         dict(transform_type="warp"), (0,)),
        ("bilinear_sampler", "BilinearSampler",
         [f32(4, 8, 24, 20), rs.uniform(-1.2, 1.2, (4, 2, 16, 16))
          .astype(np.float32)], {}, (0, 1)),
        ("bilinear_sampler_centres", "BilinearSampler",
         [f32(4, 8, 24, 20), centres], {}, (0, 1)),
        ("spatial_transformer", "SpatialTransformer",
         [f32(4, 8, 24, 20), (np.array([[.9, .1, .05, -.1, 1.1, 0]] * 4)
                              + f32(4, 6) * .05).astype(np.float32)],
         dict(target_shape=(16, 16)), (0, 1)),
        ("bilinear_resize_up", "_contrib_BilinearResize2D",
         [f32(2, 8, 16, 20)], dict(height=40, width=33), (0,)),
        ("bilinear_resize_down", "_contrib_BilinearResize2D",
         [f32(2, 8, 40, 33)], dict(height=16, width=20), (0,)),
        ("correlation", "Correlation",
         [f32(2, 16, 24, 24), f32(2, 16, 24, 24)],
         dict(max_displacement=4, stride2=2, pad_size=1), (0, 1)),
        ("index_copy", "_contrib_index_copy",
         [f32(64, 32), rs.permutation(64)[:16].astype(np.int64), f32(16, 32)],
         {}, (0, 2)),
        ("arange_like", "_contrib_arange_like", [f32(8, 30)],
         dict(axis=1, repeat=3, start=2.0, step=.5), ()),
        ("multi_all_finite", "multi_all_finite",
         [f32(100), np.array([1, np.inf], np.float32)], dict(num_arrays=2),
         ()),
        ("count_sketch", "_contrib_count_sketch",
         [f32(32, 256), rs.randint(0, 64, (1, 256)).astype(np.float32),
          np.sign(f32(1, 256))], dict(out_dim=64), (0,)),
        ("im2col", "im2col", [f32(4, 8, 20, 20)],
         dict(kernel=(3, 3), stride=(2, 2), dilate=(1, 2), pad=(1, 1)), (0,)),
        ("block_grad", "BlockGrad", [f32(64, 64)], {}, ()),
        ("interleaved_selfatt_qk", "_contrib_interleaved_matmul_selfatt_qk",
         [f32(32, 4, 3 * 8 * 16)], dict(heads=8), (0,)),
        ("interleaved_selfatt_valatt",
         "_contrib_interleaved_matmul_selfatt_valatt",
         [f32(32, 4, 3 * 8 * 16), f32(32, 32, 32)], dict(heads=8), (0, 1)),
        ("interleaved_encdec_qk", "_contrib_interleaved_matmul_encdec_qk",
         [f32(24, 4, 8 * 16), f32(32, 4, 2 * 8 * 16)], dict(heads=8),
         (0, 1)),
        ("interleaved_encdec_valatt",
         "_contrib_interleaved_matmul_encdec_valatt",
         [f32(32, 4, 2 * 8 * 16), f32(32, 24, 32)], dict(heads=8), (0, 1)),
        ("quadratic", "_contrib_quadratic", [f32(64, 64)],
         dict(a=.5, b=-2, c=1), (0,)),
        ("allclose", "_contrib_allclose", [f32(64), f32(64)],
         dict(rtol=10.0, atol=10.0), ()),
        ("index_array", "_contrib_index_array", [f32(4, 6, 8)],
         dict(axes=(2, 0)), ()),
        ("batchnorm_v1", "BatchNorm_v1", bn, dict(fix_gamma=False), (0, 1, 2)),
        ("sync_batchnorm", "_contrib_SyncBatchNorm", bn,
         dict(fix_gamma=False, ndev=1), (0, 1, 2)),
        ("image_to_tensor", "_image_to_tensor", [img], {}, ()),
        ("image_normalize", "_image_normalize", [f32(4, 3, 48, 64)],
         dict(mean=(.485, .456, .406), std=(.229, .224, .225)), (0,)),
        ("image_resize", "_image_resize", [img], dict(size=(40, 30)), ()),
        ("image_resize_nearest", "_image_resize", [img[0]],
         dict(size=(100, 70), interp=0), ()),
        ("image_crop", "_image_crop", [img], dict(x=3, y=5, width=32,
                                                   height=20), ()),
    ]


def _contrib_prior(size):
    """SSD anchors ``(1, size * size * 4, 4)`` on the CPU."""
    from mxnet_tpu_torch.ops import registry as reg

    return reg.get("MultiBoxPrior")(torch.zeros(1, 1, size, size),
                                    sizes=(.2, .3), ratios=(1, 2, .5))


def _contrib_run(name, ts, kw, argnums, heads):
    """Op ``name``'s outputs and the gradients of its differentiable
    outputs' head ``heads`` over ``argnums``, from fresh leaves over
    ``ts`` (an autograd leaf first used on another stream would make a
    capture's backward wait on that stream)."""
    from mxnet_tpu_torch.ops import registry as reg

    ts = [t.detach().requires_grad_(i in argnums) for i, t in enumerate(ts)]
    out = reg.get(name)(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if not argnums:
        return outs
    pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
    return outs + list(torch.autograd.grad(
        [o for o, _ in pairs], [ts[i] for i in argnums],
        [h for _, h in pairs], allow_unused=True))


def _surface_contrib(errs):
    """Every contrib op (``_contrib_cases``) on the card against the CPU,
    forward and gradient (``SURFACE_TOL``; sums and the atomic-add
    backward passes at ``sum_atol``), and each but the host op
    ``boolean_mask`` captured with its gradient in a raw CUDA graph under
    ``set_sync_debug_mode("error")``, the replay equal to the eager run;
    ``boolean_mask`` in a ``compile.jit`` body, which runs uncaptured under
    its reason."""
    rs = np.random.RandomState(8)
    card = mx.gpu(0).torch_device()
    captured, failed = [], {}
    for what, name, arrays, kw, argnums in _contrib_cases(rs):
        res, heads = {}, None
        for where, dev in (("card", card), ("cpu", "cpu")):
            ts = [torch.tensor(a, device=dev) for a in arrays]
            if heads is None:
                outs = _contrib_run(name, ts, kw, (), None)
                heads = [torch.tensor(np.asarray(rs.randn(*o.shape),
                                                 np.float32)) for o in outs]
            res[where] = (ts, _contrib_run(
                name, ts, kw, argnums, [h.to(dev) for h in heads]))
        errs[f"contrib_{what}"] = 0.0
        if what.startswith(("box_nms", "multibox")):
            # the discrete decisions (kept rows, class targets) agree
            a, b = res["card"][1][-1 if what == "multibox_target" else 0], \
                res["cpu"][1][-1 if what == "multibox_target" else 0]
            kept = (a.detach().cpu() == -1).all(-1) if a.ndim == 3 else \
                a.detach().cpu()
            if not torch.equal(kept, (b.detach() == -1).all(-1)
                               if b.ndim == 3 else b.detach()):
                failed[what] = "the card kept or labelled other anchors " \
                    "than the CPU"
        n_out = len(_contrib_run(name, res["cpu"][0], kw, (), None))
        for i, (a, b) in enumerate(zip(res["card"][1], res["cpu"][1])):
            if a is None:
                continue
            if not a.is_floating_point():
                # an image op's uint8 output truncates a float that the card
                # and the CPU may round to either side of an integer
                off = (a.cpu().long() - b.long()).abs().max() if a.numel() \
                    else 0
                if off > (1 if what.startswith("image_") else 0):
                    failed[what] = f"output {i}: card and CPU differ by {off}"
                continue
            try:
                errs[f"contrib_{what}"] = max(
                    errs[f"contrib_{what}"], _surface_close(
                        f"contrib {what} {i}", a, b, rtol=1e-4,
                        atol=SURFACE_TOL["conv_atol" if i < n_out
                                         else "sum_atol"]))
            except AssertionError as exc:   # named below, with the rest
                failed[what] = str(exc).splitlines()[0][:300]
        # the replay of the same work, captured with no host sync
        ts = res["card"][0]
        cheads = [h.to(card) for h in heads]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                eager = _contrib_run(name, ts, kw, argnums, cheads)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = _contrib_run(name, ts, kw, argnums, cheads)
            graph.replay()
        except RuntimeError as exc:    # named below, after every op ran
            failed[what] = str(exc).splitlines()[0][:200]
            continue
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, eager)):
            if a is not None and not torch.allclose(
                    a.float(), b.float(), rtol=1e-5, atol=1e-5,
                    equal_nan=True):
                failed[what] = f"the replay's output {i} is not the eager one"
        if what not in failed:
            captured.append(what)
    if failed:
        raise AssertionError(f"contrib ops that did not capture or replay: "
                             f"{failed}")
    # boolean_mask: a host op, uncaptured in a compile.jit body
    x = torch.tensor(rs.randn(64, 8).astype(np.float32), device=card)
    m = torch.tensor((rs.uniform(0, 1, 64) > .5).astype(np.float32),
                     device=card)
    f = compile_service.jit(lambda a, b: mx.nd.contrib.boolean_mask(
        mx.nd.NDArray(a), mx.nd.NDArray(b))._data, site="surface",
        token=("boolean_mask",))
    for _ in range(3):
        got = f(x, m)
    st = f.stats()
    reasons = [e.get("reason") for e in st["entries"]]
    if st["captures"] or reasons != ["host op _contrib_boolean_mask"] or \
            not torch.equal(got.cpu(), x.cpu()[m.cpu() > 0]):
        raise AssertionError(f"boolean_mask in a jit body: {st}")
    return {"ops_captured": captured,
            "boolean_mask": {"captures": st["captures"],
                             "reasons": reasons}}


class _ControlFlowNet(mx.gluon.HybridBlock):
    """``foreach``, ``while_loop`` and ``cond`` in one hybridized body (the
    untaken branch of ``cond`` NaN: ``sqrt`` of negative numbers)."""

    def hybrid_forward(self, F, x, w):
        def body(xi, states):
            return xi * states[0] + w, [states[0] * 0.5 + F.sum(xi)]

        outs, states = F.contrib.foreach(body, x, [F.ones_like(
            F.sum(x, axis=0))])
        loop, (i, s) = F.contrib.while_loop(
            lambda i, s: i < 3,
            lambda i, s: ([s * F.sum(x, axis=0)], [i + 1, s * 0.9]),
            [F.zeros_like(F.sum(x, axis=(0, 1), keepdims=True)[0]),
             F.ones_like(F.sum(x, axis=(0, 1), keepdims=True)[0])],
            max_iterations=5)
        neg = -F.abs(x)
        branch = F.contrib.cond(F.sum(neg) < 0, lambda: F.sum(neg * w),
                                lambda: F.sum(F.sqrt(neg)))
        return F.sum(outs * outs) + F.sum(states[0]) + F.sum(loop[0]) + \
            F.sum(s) + branch


def _surface_control_flow():
    """``_ControlFlowNet`` hybridized on the card under ``record()``: the
    pair's first call eager, then captured and replayed; the replays'
    value and gradients against the same block with the compile service
    off, and a replay with no host sync."""
    rs = np.random.RandomState(10)
    x_np = rs.uniform(0.2, 1.5, (6, 32)).astype(np.float32)
    w_np = rs.uniform(0.5, 1.5, 32).astype(np.float32)
    net = _ControlFlowNet()
    net.hybridize()
    x, w = mx.nd.array(x_np), mx.nd.array(w_np)
    x.attach_grad()
    w.attach_grad()

    def step():
        with mx.autograd.record():
            y = net(x, w)
        y.backward()
        # detached: a kept tensor that requires grad would hold an eager
        # autograd graph on the default stream while the pair captures
        return (y._data.detach().clone(), x.grad._data.clone(),
                w.grad._data.clone())

    site0 = _site_stats("cachedop")
    for _ in range(3):
        got = step()
    syncs = _sync_count(step)
    site = _site_stats("cachedop")
    want = _eager(step)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    counts = {k: site[k] - site0[k] for k in ("captures", "replays")}
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    if counts["captures"] != 1 or counts["replays"] < 6 or syncs or \
            not finite or max(errs) > 1e-4:
        raise AssertionError(f"control flow in a hybridized block: site "
                             f"{counts}, syncs {syncs}, finite {finite}, "
                             f"replay against eager {errs}")
    return {"site": counts, "host_syncs": syncs, "max_abs_err": errs}


def build_relu_lib(out_dir):
    """``examples/extensions/lib_custom_op/relu_lib.cc`` built with the
    system ``g++`` into ``out_dir`` (the source's own build line); the
    library's path."""
    src = Path(__file__).resolve().parent / "examples" / "extensions" / \
        "lib_custom_op" / "relu_lib.cc"
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "librelu_lib.so")
    subprocess.run(["g++", "-shared", "-fPIC", "-O2", "-o", out, str(src)],
                   check=True, timeout=120)
    return out


LIBRARY_OPS = {"relu": (4096, 1024), "gemm": (256, 512, 384),
               "block_calls": 3, "reps": 5}


def phase_library_ops():
    """library_ops: ``relu_lib.cc`` built with ``g++`` into
    ``build/mxnet_tpu_torch/ext`` and loaded by ``mx.library.load``;
    ``my_relu`` (on ``LIBRARY_OPS["relu"]``) and ``my_gemm`` (on
    ``["gemm"]``) on card arrays against ``torch.relu`` and a float64
    product, with the host ms a call (the copies to the host and back
    included) and the bytes each way; a hybridized block calling
    ``my_relu`` runs uncaptured, each call counted under its reason in
    ``compile.stats()["cachedop"]``."""
    cfg = LIBRARY_OPS
    t0 = time.perf_counter()
    path = build_relu_lib(os.path.join(build.BUILD_DIR, "ext"))
    info = mx.library.load(path, verbose=False)
    if info["ops"] != ["my_relu", "my_gemm"]:
        raise AssertionError(f"library_ops: loaded {info['ops']}")
    ctx = mx.gpu(0)
    rs = np.random.RandomState(8)
    x = mx.nd.array(rs.randn(*cfg["relu"]).astype(np.float32), ctx=ctx)
    m, k, n = cfg["gemm"]
    a = mx.nd.array(rs.randn(m, k).astype(np.float32), ctx=ctx)
    b = mx.nd.array(rs.randn(k, n).astype(np.float32), ctx=ctx)
    relu = mx.nd.my_relu(x)
    gemm = mx.nd.my_gemm(a, b)
    want = (a._data.double() @ b._data.double()).float()
    res = {"relu_bit_equal": bool(torch.equal(relu._data,
                                              torch.relu(x._data))),
           "relu_device": str(relu._data.device),
           "gemm_max_abs_err": float((gemm._data - want).abs().max()),
           "gemm_max_abs": float(want.abs().max())}
    if not res["relu_bit_equal"] or relu._data.device != x._data.device or \
            res["gemm_max_abs_err"] > 1e-4 * res["gemm_max_abs"]:
        raise AssertionError(f"library_ops: {res}")

    def host_ms(fn):
        times = []
        for _ in range(cfg["reps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    res["relu_host_ms"] = host_ms(lambda: mx.nd.my_relu(x))
    res["relu_torch_ms"] = cuda_ms(lambda: torch.relu(x._data))
    res["gemm_host_ms"] = host_ms(lambda: mx.nd.my_gemm(a, b))
    res["bytes_each_way"] = {
        "my_relu": {"to_host": x.size * 4, "to_card": x.size * 4},
        "my_gemm": {"to_host": (a.size + b.size) * 4, "to_card": m * n * 4}}

    class ReluBlock(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, data):
            return F.my_relu(data) * 2

    block = ReluBlock()
    block.hybridize()
    site0 = _site_stats("cachedop")
    before = dict(site0.get("uncaptured", {}))
    for _ in range(cfg["block_calls"]):
        y = block(x)
    site = _site_stats("cachedop")
    reason = "host op my_relu"
    uncaptured = site.get("uncaptured", {}).get(reason, 0) - \
        before.get(reason, 0)
    res["block"] = {"uncaptured": {reason: uncaptured},
                    "captures": site["captures"] - site0["captures"],
                    "replays": site["replays"] - site0["replays"],
                    "bit_equal": bool(torch.equal(y._data,
                                                  torch.relu(x._data) * 2))}
    if res["block"] != {"uncaptured": {reason: cfg["block_calls"]},
                        "captures": 0, "replays": 0, "bit_equal": True}:
        raise AssertionError(f"library_ops block: {res['block']}")
    line = {"phase": "library_ops", "config": cfg, "library": path,
            "ops": info["ops"], **res, "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def _moments(mean, var, kurt_excess):
    """A distribution's mean, variance and the variance of one draw's
    squared deviation (``kappa4 + 2 var**2``), for the standard errors
    of the sample mean and variance."""
    return mean, var, kurt_excess * var * var + 2 * var * var


def _sampler_cases():
    """``{name: (draw(ctx, n), closed-form moments)}`` of the eight
    samplers at the parameters the checks use."""
    nd = mx.nd.random
    a, b, lam, k, p, lo, hi, pb = 2.5, 1.5, 3.0, 4, 0.3, -3, 7, 0.2
    n_int = hi - lo
    nb_var = k * (1 - p) / p ** 2
    return {
        "gamma": (lambda c, n: nd.gamma(a, b, shape=(n,), ctx=c),
                  _moments(a * b, a * b * b, 6 / a)),
        "exponential": (lambda c, n: nd.exponential(lam, shape=(n,), ctx=c),
                        _moments(1 / lam, 1 / lam ** 2, 6.0)),
        "poisson": (lambda c, n: nd.poisson(lam, shape=(n,), ctx=c),
                    _moments(lam, lam, 1 / lam)),
        "negative_binomial": (
            lambda c, n: nd.negative_binomial(k, p, shape=(n,), ctx=c),
            _moments(k * (1 - p) / p, nb_var,
                     6 / k + p * p / (k * (1 - p)))),
        "randint": (lambda c, n: nd.randint(lo, hi, shape=(n,), ctx=c),
                    _moments((lo + hi - 1) / 2, (n_int ** 2 - 1) / 12,
                             -6 * (n_int ** 2 + 1) / (5 * (n_int ** 2 - 1)))),
        "bernoulli": (lambda c, n: nd.bernoulli(pb, shape=(n,), ctx=c),
                      _moments(pb, pb * (1 - pb),
                               (1 - 6 * pb * (1 - pb)) / (pb * (1 - pb)))),
        "uniform": (lambda c, n: nd.uniform(-1, 2, shape=(n,), ctx=c),
                    _moments(0.5, 9 / 12, -1.2)),
        "normal": (lambda c, n: nd.normal(1, 2, shape=(n,), ctx=c),
                   _moments(1.0, 4.0, 0.0)),
    }


def _held_to_moments(name, draws, moments):
    """The sample mean and variance of ``draws`` (float64) against the
    closed form, in standard errors; raises beyond
    ``SAMPLER_CHECK["sigmas"]``."""
    mean, var, var4 = moments
    x = draws.double()
    n = x.numel()
    m = float(x.mean())
    v = float(x.var(unbiased=False))
    z = {"mean": (m - mean) / math.sqrt(var / n),
         "var": (v - var) / math.sqrt(var4 / n)}
    if max(abs(t) for t in z.values()) > SAMPLER_CHECK["sigmas"]:
        raise AssertionError(f"sampler {name}: mean {m} and variance {v} "
                             f"lie {z} standard errors from {mean}, {var}")
    return {"mean": m, "var": v, "z": z}


def _surface_samplers():
    """Each sampler at ``SAMPLER_CHECK["draws"]`` draws on the card and on
    the CPU, held to its closed-form mean and variance (the two
    generators differ); on the card: the host syncs of a draw
    (``_sync_count``), and a ``compile.jit`` graph of the draw replayed
    from a generator state against the eager draw from the same state,
    bit for bit, and the next replay drawing anew; raises if a sampler
    syncs or does not capture. Multinomial over ``lstm_lm_ptb_medium``'s decoder width
    (rows of a softmax over 10000 words): each row's mean word index
    against the row's own, the log-probabilities returned with
    ``get_prob`` against the row's; shuffle of 4 M values a permutation."""
    cfg = SAMPLER_CHECK
    card = mx.gpu(0)
    gen = mx.random.generator(card)
    mx.random.seed(5)
    out = {}
    zero = torch.zeros((), device=card.torch_device())
    cases = dict(_sampler_cases())
    rows, vocab = cfg["multinomial"]
    rs = np.random.RandomState(3)
    probs_np = np.exp(rs.randn(rows, vocab).astype(np.float32))
    probs_np /= probs_np.sum(1, keepdims=True)
    probs = mx.nd.array(probs_np, ctx=card)
    cases["multinomial"] = (lambda c, n: mx.nd.random.multinomial(
        probs.as_in_context(c), shape=(cfg["per_row"],)), None)
    cases["shuffle"] = (lambda c, n: mx.nd.random.shuffle(
        mx.nd.arange(n, ctx=c)), None)
    for name, (draw, moments) in cases.items():
        res = {"takes_generator": True}
        for where, ctx in (("card", card), ("cpu", mx.cpu())):
            got = draw(ctx, cfg["draws"])._data
            if moments is not None:
                res[where] = _held_to_moments(f"{name} {where}", got, moments)
            elif name == "shuffle":
                perm = bool(torch.equal(got.sort().values, torch.arange(
                    cfg["draws"], device=got.device, dtype=got.dtype)))
                moved = float((got != torch.arange(
                    cfg["draws"], device=got.device, dtype=got.dtype)).float()
                    .mean())
                if not perm or moved < 0.99:
                    raise AssertionError(f"shuffle {where}: a permutation "
                                         f"{perm}, moved {moved}")
                res[where] = {"permutation": perm, "moved_share": moved}
            else:
                idx = torch.arange(vocab, dtype=torch.float64)
                p64 = torch.tensor(probs_np, dtype=torch.float64)
                mean = (p64 * idx).sum(1)
                var = (p64 * idx * idx).sum(1) - mean * mean
                got_m = got.double().cpu().mean(1)
                z = ((got_m - mean) / (var / cfg["per_row"]).sqrt()).abs()
                if float(z.max()) > cfg["sigmas"] or got.shape != (
                        rows, cfg["per_row"]):
                    raise AssertionError(f"multinomial {where}: shape "
                                         f"{tuple(got.shape)}, row means "
                                         f"{float(z.max())} standard errors "
                                         "off")
                res[where] = {"shape": list(got.shape),
                              "max_row_mean_z": float(z.max())}
        if name == "multinomial":
            draws, logp = mx.nd.random.multinomial(probs, shape=(64,),
                                                   get_prob=True)
            want = torch.log(probs._data).gather(1, draws._data.long())
            res["get_prob_max_abs_err"] = float(
                (logp._data - want).abs().max())
            if res["get_prob_max_abs_err"] > 1e-5:
                raise AssertionError(f"multinomial get_prob: "
                                     f"{res['get_prob_max_abs_err']}")
        n = cfg["capture_draws"]
        res["host_syncs"] = _sync_count(lambda: draw(card, n))
        res["graph"] = _sampler_graph(name, draw, n, gen, zero)
        # every sampler captures and draws with no host sync (PERF.md)
        if res["host_syncs"] or not res["graph"]["graph_safe"]:
            raise AssertionError(f"sampler {name}: host syncs "
                                 f"{res['host_syncs']}, graph {res['graph']}")
        if not res["graph"]["bit_equal"] or not \
                res["graph"]["replays_differ"]:
            raise AssertionError(f"sampler {name}: a replay from a saved "
                                 "generator state differs from the eager "
                                 "draw from it, or two replays drew the "
                                 f"same: {res['graph']}")
        out[name] = res
    emit({"phase": "surface_samplers", "draws": cfg["draws"],
          "samplers": out})
    return {k: {"graph": v["graph"].get("bit_equal"),
                "host_syncs": sum(v["host_syncs"].values())}
            for k, v in out.items()}


def _sampler_graph(name, draw, n, gen, zero):
    """A ``compile.jit`` graph of ``draw(card, n)`` (its first call
    eager, then a capture), replayed from a saved generator state against
    the eager draw from that state."""
    card = mx.gpu(0)

    def body(t):
        return draw(card, n)._data

    f = compile_service.jit(body, site="surface", token=("sampler", name))
    try:
        f(zero)
        state = gen.get_state()
        eager = body(zero)
        gen.set_state(state)
        replay = f(zero)
    except compile_service.CaptureError as e:
        return {"graph_safe": False, "error": str(e)[:300]}
    return {"graph_safe": True, "bit_equal": bool(torch.equal(eager, replay)),
            "replays_differ": bool(not torch.equal(replay, f(zero)))}


# ssd512_resnet50_v1_module_fit: MXNet 1.x's example/ssd at
# symbol/symbol_factory.py's "resnet50" config and data_shape 512
# (``SSD512``): the zoo's resnet50_v1 exported as a symbol, its last block
# outputs at strides 16 (32 x 32) and 32 (16 x 16) as the first two
# feature layers (the example's '_plus12' and '_plus15' of its resnet50),
# common.py's multi_layer_feature (1x1 + 3x3 conv-ReLU pairs, stride 2, pad
# 1: 8 x 8, 4 x 4, 2 x 2, 1 x 1) and multibox_layer (6132 anchors),
# symbol_builder.get_symbol_train's heads, train_net.py's Module.fit
# ("sgd" lr 0.002, momentum 0.9, wd 5e-4, rescale_grad 1, Xavier, the
# "local" kvstore, the lr steps at epochs 80 and 160 of 16551 VOC07+12
# images) and train/metric.py's MultiBoxMetric. The cuts: synthetic
# normalized images N(0, 1) and 1-8 boxes an image (classes 0-19, sides
# 0.1-0.6, padded to 8 with -1) from RandomState(0), one batch yielded 13
# times (3 warm-up, 10 timed), the backbone from the initializer, no frozen
# layers, Speedometer every 10 batches (train.py: 20). The example's head
# biases carry ``__lr_mult__ = 2``, which neither package's optimizer reads
# (so K1 runs one learning-rate group: one launch a batch).
SSD512 = {"network": "resnet50_v1", "data_shape": 512, "num_classes": 20,
          "batch": 32, "max_objects": 8,
          "num_filters": (-1, -1, 512, 256, 256, 128),
          "strides": (-1, -1, 2, 2, 2, 2), "pads": (-1, -1, 1, 1, 1, 1),
          "sizes": ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                    (.71, .79), (.88, .961)),
          "ratios": ((1, 2, .5), (1, 2, .5, 3, 1. / 3),
                     (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
                     (1, 2, .5), (1, 2, .5)),
          "nms_thresh": 0.45, "nms_topk": 400, "force_suppress": False,
          "lr": 0.002, "mom": 0.9, "wd": 5e-4, "lr_step_epochs": "80, 160",
          "lr_factor": 0.1, "num_examples": 16551, "frequent": 10,
          "epoch_size": 13, "warmup": 3, "anchors": 6132, "tensors": 231,
          "aux": 106, "infer_iters": 10,
          "reduced": "synthetic images and boxes; 13 batches a fit, not "
                     "16551 // 32 = 517 a epoch for 240 epochs; backbone "
                     "from the initializer; Speedometer every 10 batches"}
# the replayed update (batch 1 of a captured fit, the first replayed
# step: batch 0 runs eagerly) against batch 1 of an eager fit from the same
# seed, each tensor's change as a share of the eager change's L2 norm on a
# floor of a thousandth of the largest change (``_update_agreement``), held
# to three times the larger spread of two fits of one mode (eager against
# eager, captured against captured), and at least to 1e-3: cuDNN's weight
# gradients sum in varying order, and a BatchNorm gamma's gradient is a
# sum of 2 M terms that nearly cancel (the first layers' gammas moved
# 2.3% apart between a captured and an eager fit, call 1 of this phase); a
# replay that computed something else would differ by order one. The
# captured inference forward against the eager one at 1e-5 (same kernels,
# one order)
SSD_FIT_TOL = {"noise_factor": 3.0, "at_least": 1e-3, "floor": 1e-3,
               "infer": 1e-5}


def ssd_conv_act(m, data, name, num_filter, kernel, pad, stride):
    """``example/ssd/symbol/common.py`` conv_act_layer (no BatchNorm)."""
    conv = m.sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                             num_filter=num_filter, name=f"{name}_conv")
    return m.sym.Activation(data=conv, act_type="relu", name=f"{name}_relu")


def ssd_multi_layer_feature(m, body, from_layers, num_filters, strides, pads,
                            min_filter=128):
    """``common.py`` multi_layer_feature: a named internal output of
    ``body`` for each non-empty ``from_layers`` entry, else a 1x1 and a
    3x3 conv-ReLU pair on the previous feature layer."""
    internals = body.get_internals()
    layers = []
    for k, (from_layer, num_filter, s, p) in enumerate(
            zip(from_layers, num_filters, strides, pads)):
        if from_layer.strip():
            layers.append(internals[from_layer.strip() + "_output"])
            continue
        num_1x1 = max(min_filter, num_filter // 2)
        conv_1x1 = ssd_conv_act(m, layers[-1], f"multi_feat_{k}_conv_1x1",
                                num_1x1, (1, 1), (0, 0), (1, 1))
        layers.append(ssd_conv_act(m, conv_1x1, f"multi_feat_{k}_conv_3x3",
                                   num_filter, (3, 3), (p, p), (s, s)))
    return layers


def ssd_multibox_layer(m, from_layers, num_classes, sizes, ratios,
                       clip=False, steps=()):
    """``common.py`` multibox_layer (no normalization, no intermediate
    layer): per feature layer a 3x3 location and class prediction conv
    (bias variables as the example declares them) and its anchors (the
    example's ``Flatten``/``Reshape`` take ``data=``; both packages name
    that input ``x``, so it goes positionally);
    returns ``loc_preds (B, N * 4)``, ``cls_preds (B, classes + 1, N)``
    and ``anchor_boxes (1, N, 4)``."""
    num_classes += 1                      # background
    loc_layers, cls_layers, anchor_layers = [], [], []
    for k, layer in enumerate(from_layers):
        name = layer.name
        size, ratio = tuple(sizes[k]), tuple(ratios[k])
        num_anchors = len(size) - 1 + len(ratio)
        preds = []
        for what, width in (("loc", 4), ("cls", num_classes)):
            bias = m.sym.var(f"{name}_{what}_pred_conv_bias",
                             init=m.init.Constant(0.0),
                             attr={"__lr_mult__": "2.0"})
            pred = m.sym.Convolution(
                data=layer, bias=bias, kernel=(3, 3), stride=(1, 1),
                pad=(1, 1), num_filter=num_anchors * width,
                name=f"{name}_{what}_pred_conv")
            pred = m.sym.transpose(pred, axes=(0, 2, 3, 1))
            preds.append(m.sym.Flatten(pred))
        loc_layers.append(preds[0])
        cls_layers.append(preds[1])
        step = (steps[k], steps[k]) if steps else (-1.0, -1.0)
        anchors = m.sym.contrib.MultiBoxPrior(
            layer, sizes=size, ratios=ratio, clip=clip,
            name=f"{name}_anchors", steps=step)
        anchor_layers.append(m.sym.Flatten(anchors))
    loc_preds = m.sym.Concat(*loc_layers, num_args=len(loc_layers), dim=1,
                             name="multibox_loc_pred")
    cls_preds = m.sym.Concat(*cls_layers, num_args=len(cls_layers), dim=1)
    cls_preds = m.sym.Reshape(cls_preds, shape=(0, -1, num_classes))
    cls_preds = m.sym.transpose(cls_preds, axes=(0, 2, 1),
                                name="multibox_cls_pred")
    anchor_boxes = m.sym.Concat(*anchor_layers, num_args=len(anchor_layers),
                                dim=1)
    anchor_boxes = m.sym.Reshape(anchor_boxes, shape=(0, -1, 4),
                                 name="multibox_anchors")
    return loc_preds, cls_preds, anchor_boxes


def ssd_symbol_train(m, layers, num_classes, sizes, ratios, nms_thresh=0.5,
                     force_suppress=False, nms_topk=400):
    """``symbol_builder.py`` get_symbol_train on the feature ``layers``:
    ``Group([cls_prob, loc_loss, cls_label, det])``."""
    label = m.sym.var("label")
    loc_preds, cls_preds, anchor_boxes = ssd_multibox_layer(
        m, layers, num_classes, sizes, ratios)
    tmp = m.sym.contrib.MultiBoxTarget(
        *[anchor_boxes, label, cls_preds], overlap_threshold=.5,
        ignore_label=-1, negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = m.sym.SoftmaxOutput(
        data=cls_preds, label=cls_target, ignore_label=-1, use_ignore=True,
        grad_scale=1., multi_output=True, normalization="valid",
        name="cls_prob")
    loc_loss_ = m.sym.smooth_l1(
        name="loc_loss_", data=loc_target_mask * (loc_preds - loc_target),
        scalar=1.0)
    loc_loss = m.sym.MakeLoss(loc_loss_, grad_scale=1.,
                              normalization="valid", name="loc_loss")
    cls_label = m.sym.MakeLoss(data=cls_target, grad_scale=0,
                               name="cls_label")
    det = m.sym.contrib.MultiBoxDetection(
        *[cls_prob, loc_preds, anchor_boxes], name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
    det = m.sym.MakeLoss(data=det, grad_scale=0, name="det_out")
    return m.sym.Group([cls_prob, loc_loss, cls_label, det])


def ssd_symbol_deploy(m, layers, num_classes, sizes, ratios, nms_thresh=0.5,
                      force_suppress=False, nms_topk=400):
    """``symbol_builder.py`` get_symbol (what ``deploy.py`` saves): the
    detections alone."""
    loc_preds, cls_preds, anchor_boxes = ssd_multibox_layer(
        m, layers, num_classes, sizes, ratios)
    cls_prob = m.sym.softmax(data=cls_preds, axis=1, name="cls_prob")
    return m.sym.contrib.MultiBoxDetection(
        *[cls_prob, loc_preds, anchor_boxes], name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)


class MultiBoxMetric(mx.metric.EvalMetric):
    """``example/ssd/train/metric.py``: the cross-entropy of the valid
    class targets and the summed smooth-L1 loss, each over the count of
    valid targets, as two values (the window's, and the epoch's in
    ``get_global``)."""

    def __init__(self, eps=1e-8):
        super().__init__("MultiBox")
        self.eps = eps
        self.num = 2
        self.name = ["CrossEntropy", "SmoothL1"]
        self.reset()

    def reset(self):
        n = getattr(self, "num", None) or 1
        self.num_inst, self.sum_metric = [0] * n, [0.0] * n
        self.global_num_inst, self.global_sum_metric = [0] * n, [0.0] * n

    def reset_local(self):
        self.global_num_inst = [a + b for a, b in zip(self.global_num_inst,
                                                      self.num_inst)]
        self.global_sum_metric = [a + b for a, b in zip(
            self.global_sum_metric, self.sum_metric)]
        self.num_inst, self.sum_metric = [0] * self.num, [0.0] * self.num

    def update(self, labels, preds):
        ce, l1, valid_count = ssd_losses(preds)
        self.sum_metric[0] += ce
        self.num_inst[0] += valid_count
        self.sum_metric[1] += l1
        self.num_inst[1] += valid_count

    @staticmethod
    def _values(sums, nums):
        return [x / y if y != 0 else float("nan") for x, y in zip(sums, nums)]

    def get(self):
        return self.name, self._values(self.sum_metric, self.num_inst)

    def get_global(self):
        return self.name, self._values(
            [a + b for a, b in zip(self.global_sum_metric, self.sum_metric)],
            [a + b for a, b in zip(self.global_num_inst, self.num_inst)])


def ssd_losses(preds, eps=1e-8):
    """``MultiBoxMetric.update``'s sums from the outputs ``[cls_prob,
    loc_loss, cls_label, ...]``: the cross-entropy summed over the valid
    class targets, the summed smooth-L1 loss and the valid count."""
    cls_prob = preds[0].asnumpy()
    loc_loss = preds[1].asnumpy()
    cls_label = preds[2].asnumpy()
    valid_count = int(np.sum(cls_label >= 0))
    label = cls_label.flatten()
    mask = np.where(label >= 0)[0]
    indices = np.int64(label[mask])
    prob = cls_prob.transpose((0, 2, 1)).reshape((-1, cls_prob.shape[1]))
    prob = prob[mask, indices]
    return float((-np.log(prob + eps)).sum()), float(np.sum(loc_loss)), \
        valid_count


def ssd_loss(preds):
    """The SSD loss of one batch's outputs: the cross-entropy and the
    smooth-L1 sum, each over the valid count (``MultiBoxMetric``'s two
    values added)."""
    ce, l1, n = ssd_losses(preds)
    return (ce + l1) / max(n, 1)


def ssd_batch(batch, data_shape, num_classes, max_objects, seed=0):
    """Synthetic normalized images ``(batch, 3, S, S)`` from N(0, 1) and
    labels ``(batch, max_objects, 5)``: 1 to ``max_objects`` boxes an image,
    rows ``[class, x1, y1, x2, y2]`` (classes below ``num_classes``, sides
    0.1-0.6 of the image), padded with -1."""
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 3, data_shape, data_shape).astype(np.float32)
    label = np.full((batch, max_objects, 5), -1.0, np.float32)
    for i in range(batch):
        k = rs.randint(1, max_objects + 1)
        wh = rs.uniform(0.1, 0.6, (k, 2))
        xy = rs.uniform(0.0, 1.0, (k, 2)) * (1.0 - wh)
        label[i, :k, 0] = rs.randint(0, num_classes, k)
        label[i, :k, 1:3] = xy
        label[i, :k, 3:5] = xy + wh
    return x, label


class SSDDataIter(mx.io.DataIter):
    """One device-resident batch of :func:`ssd_batch` yielded
    ``epoch_size`` times, its label named ``label`` as ``train_net.py``'s
    iterator names it."""

    def __init__(self, cfg, seed=0):
        b, s = cfg["batch"], cfg["data_shape"]
        super().__init__(batch_size=b)
        self.batch_size = b
        self.epoch_size = cfg["epoch_size"]
        x, y = ssd_batch(b, s, cfg["num_classes"], cfg["max_objects"], seed)
        self._data, self._label = mx.nd.array(x), mx.nd.array(y)
        self._cur = 0
        self.provide_data = [mx.io.DataDesc("data", (b, 3, s, s))]
        self.provide_label = [mx.io.DataDesc("label", y.shape)]

    def reset(self):
        self._cur = 0

    def next(self):
        if self._cur >= self.epoch_size:
            raise StopIteration
        self._cur += 1
        return mx.io.DataBatch(data=[self._data], label=[self._label],
                               pad=0, provide_data=self.provide_data,
                               provide_label=self.provide_label)


def ssd_backbone(network, data_shape):
    """The zoo's ``network`` exported as a symbol, and the names of its
    last block outputs at strides 16 and 32 (the last ReLU outputs of
    stages 3 and 4), found by shape inference at ``data_shape``."""
    sym = export_symbol(network, 1000, (3, 224, 224))
    internals = sym.get_internals()
    _, shapes, _ = internals.infer_shape(data=(1, 3, data_shape, data_shape))
    ends = {}
    for name, shape in zip(internals.list_outputs(), shapes):
        if name.startswith("activation") and len(shape) == 4:
            ends[shape[2]] = name[:-len("_output")]
    return sym, [ends[data_shape // 16], ends[data_shape // 32]]


def ssd_symbols(cfg):
    """The training and the deploy symbol of ``cfg``, and the names of the
    backbone's nodes."""
    body, from_names = ssd_backbone(cfg["network"], cfg["data_shape"])
    layers = ssd_multi_layer_feature(
        mx, body, from_names + [""] * (len(cfg["num_filters"]) - 2),
        cfg["num_filters"], cfg["strides"], cfg["pads"])
    kw = dict(nms_thresh=cfg["nms_thresh"], nms_topk=cfg["nms_topk"],
              force_suppress=cfg["force_suppress"])
    train = ssd_symbol_train(mx, layers, cfg["num_classes"], cfg["sizes"],
                             cfg["ratios"], **kw)
    deploy = ssd_symbol_deploy(mx, layers, cfg["num_classes"], cfg["sizes"],
                               cfg["ratios"], **kw)
    backbone = {n["name"] for n in json.loads(
        mx.sym.Group(layers[:2]).tojson())["nodes"]}
    return train, deploy, backbone


def valid_detections(det):
    """Whether every row of ``det (B, N, 6)`` is ``[id, score, x1, y1, x2,
    y2]`` with an integer id, a score in (0, 1] and corners in [0, 1]
    (x1 <= x2, y1 <= y2), or all -1 (suppressed); and the kept rows per
    image."""
    d = det.asnumpy() if hasattr(det, "asnumpy") else det
    dropped = (d == -1).all(-1)
    k = d[~dropped]
    ok = bool(((k[:, 0] >= 0) & (k[:, 0] == np.round(k[:, 0]))
               & (k[:, 1] > 0) & (k[:, 1] <= 1)
               & (k[:, 2:] >= 0).all(-1) & (k[:, 2:] <= 1).all(-1)
               & (k[:, 2] <= k[:, 4]) & (k[:, 3] <= k[:, 5])).all())
    return ok, (~dropped).sum(-1).tolist()


def _ssd_group(backbone, ops):
    """Node name -> the phase's device-time group."""
    loss = {"SoftmaxOutput", "smooth_l1", "MakeLoss", "elemwise_mul",
            "elemwise_sub", "broadcast_mul", "broadcast_sub"}

    def group(node):
        op = ops.get(node)
        if node in backbone:
            return "backbone"
        if op == "MultiBoxTarget":
            return "multibox_target"
        if op == "MultiBoxDetection":
            return "multibox_detection_nms"
        if op in loss:
            return "softmax_output_smooth_l1"
        return "extra_layers_and_heads"

    return group


def _chain(e):
    out = []
    while e is not None:
        out.append(e)
        e = e.cpu_parent
    return out


def _ssd_split(prof, group):
    """Device ms and launches of a profiled eager batch by group: a kernel
    launched inside the evaluator's ``node:<name>`` range goes to that
    node's group, one of autograd's backward functions to the group of the
    forward op with its sequence number (a custom Function's backward,
    which has none, by its name). Kernels launched outside any op (K1,
    through ctypes) are not among them."""
    fwd = {}
    for e in prof.events():
        if e.sequence_nr is None or e.sequence_nr < 0:
            continue
        node = next((p.name[5:] for p in _chain(e)
                     if p.name.startswith("node:")), None)
        if node is not None:
            fwd[e.sequence_nr] = group(node)
    ms, launches = {}, {}
    for e in prof.events():
        for k in getattr(e, "kernels", None) or []:
            chain = _chain(e)
            node = next((p.name[5:] for p in chain
                         if p.name.startswith("node:")), None)
            back = next((p for p in chain if p.name.startswith(
                "autograd::engine::evaluate_function")), None)
            if node is not None:
                g = group(node)
            elif back is not None:
                g = fwd.get(back.sequence_nr)
                if g is None:
                    heads = ("SoftmaxOutput", "MakeLoss")
                    g = "softmax_output_smooth_l1" if any(
                        t in back.name for t in heads) \
                        else "backward_unattributed"
            elif any(p.name == "module.update" for p in chain):
                g = "update_other"
            else:
                g = "other"
            ms[g] = ms.get(g, 0.0) + k.duration / 1e3
            launches[g] = launches.get(g, 0) + 1
    return ms, launches


def _profile_ssd_batch(mod, batch, metric, group=None):
    """One Module batch (``forward_backward``, ``update``,
    ``update_metric``) under ``torch.profiler``: window ms, device busy ms
    and idle share, the kernels launched in ``forward_backward`` and in
    all, and with ``group`` (an eager batch) the device ms and launches
    by group."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("module.forward_backward"):
            mod.forward_backward(batch)
        with record_function("module.update"):
            mod.update()
        with record_function("module.update_metric"):
            mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # every kernel of the window, K1's too (launched through ctypes, it has
    # no op event to hang from)
    busy, n_all, k1 = 0.0, 0, [0.0, 0]
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.self_device_time_total <= 0:
            continue
        busy += e.self_device_time_total / 1e3
        n_all += e.count
        if "opt_step_kernel" in e.key:
            k1 = [k1[0] + e.self_device_time_total / 1e3, k1[1] + e.count]
    n_fb = sum(len(getattr(e, "kernels", None) or []) for e in prof.events()
               if any(p.name == "module.forward_backward"
                      for p in _chain(e)))
    out = {"profiled_batch_ms": window_ms,
           "device_ms": busy if n_all else "not measured",
           "device_idle_share": 1 - busy / window_ms if n_all
           else "not measured",
           "launches_forward_backward": n_fb if n_all else "not measured",
           "launches_batch": n_all if n_all else "not measured",
           "k1_device_ms": k1[0] if k1[1] else "not measured",
           "k1_launches": k1[1]}
    if group is not None:
        ms, launches = _ssd_split(prof, group)
        if k1[1]:
            ms["k1"], launches["k1"] = k1
        out["device_ms_by_group"] = ms if n_all else "not measured"
        out["launches_by_group"] = launches if n_all else "not measured"
    return out


def _uncaptured(site):
    """``{reason: calls}`` the compile service ran uncaptured at ``site``
    so far in the process."""
    return dict(compile_service.stats().get(site, {}).get("uncaptured", {}))


def _ssd_fit_once(cfg, net, train, dev):
    """One ``train_net.py`` fit of ``cfg["epoch_size"]`` batches (the
    compile service on or off, as the caller set it): the host clock at
    each batch end (card synchronised), the loss of batches 0, 1 and the
    last (one batch repeated: batch 1's is after the first update), each
    tensor's change in batch 1 (host copies after batches 0 and 1),
    launches, peak memory and the executor site's counts."""
    model = mx.mod.Module(net, label_names=("label",), context=dev)
    stamps, losses, snaps = [], {}, {}

    def stamp(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def probe(param):
        if param.nbatch in (0, 1, cfg["epoch_size"] - 1):
            losses[param.nbatch] = ssd_loss(model.get_outputs())
        if param.nbatch in (0, 1):
            snaps[param.nbatch] = _params_now(model)

    train.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    site0 = _site_stats("executor")
    unc0 = _uncaptured("executor")
    kernels.reset_launch_counts()
    t_fit = time.perf_counter()
    with _captured_log() as log:
        model.fit(train, eval_data=None, eval_metric=MultiBoxMetric(),
                  batch_end_callback=[mx.callback.Speedometer(
                      cfg["batch"], cfg["frequent"]), stamp, probe],
                  kvstore=mx.kv.create("local"), optimizer="sgd",
                  optimizer_params={
                      "learning_rate": cfg["lr"], "momentum": cfg["mom"],
                      "wd": cfg["wd"], "lr_scheduler": _lr_scheduler(cfg)[1],
                      "clip_gradient": None, "rescale_grad": 1.0},
                  begin_epoch=0, num_epoch=1, initializer=mx.init.Xavier(),
                  arg_params=None, aux_params=None, allow_missing=True,
                  monitor=None)
    fit_s = time.perf_counter() - t_fit
    site = _site_stats("executor")
    pool = _pool_bytes()    # the model's graphs alive
    batch_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    timed = batch_ms[cfg["warmup"] - 1:]
    update = {n: snaps[1][n] - snaps[0][n] for n in snaps[1]}
    return model, log, update, {
        "batch_ms": batch_ms, "median_batch_ms": statistics.median(timed),
        "fit_s": fit_s, "batch_ends": len(stamps),
        "speedometer_img_per_s": log.speeds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "graph_pool_bytes": pool,
        "launches": kernels.launch_counts(),
        "executor_site": {k: site[k] - site0[k] for k in (
            "misses", "hits", "captures", "capture_ms", "replays")},
        "uncaptured": {k: n - unc0.get(k, 0) for k, n in
                       _uncaptured("executor").items() if n != unc0.get(k, 0)},
        "losses": [losses.get(0), losses.get(1),
                   losses.get(cfg["epoch_size"] - 1)]}


def _ssd_infer(cfg, deploy, model, dev, data):
    """``deploy.py``'s graph bound for inference at the fit's batch with
    the fitted weights, its forward captured and eager (A B B A): ms a
    batch by CUDA events, the detections of each mode."""
    dmod = mx.mod.Module(deploy, label_names=None, context=dev)
    dmod.bind(data_shapes=[("data", data.shape)], for_training=False)
    arg, aux = model.get_params()
    dmod.set_params(arg, aux)
    batch = mx.io.DataBatch(data=[data], label=None, pad=0)
    ms, dets = {"captured": [], "eager": []}, {}
    site0 = _site_stats("executor")
    for mode in ("captured", "eager", "eager", "captured"):
        prev = compile_service.set_enabled(mode == "captured")
        try:
            def run():
                dmod.forward(batch, is_train=False)
                return dmod.get_outputs()[0]

            dets.setdefault(mode, run().asnumpy())
            ms[mode].append(cuda_ms(run, iters=cfg["infer_iters"], warmup=2))
            if mode == "captured" and "syncs" not in dets:
                dets["syncs"] = _sync_count(run)
        finally:
            compile_service.set_enabled(prev)
    site = _site_stats("executor")
    return ms, dets, {k: site[k] - site0[k] for k in ("captures", "replays")}


def phase_ssd512_module_fit(smi):
    """ssd512_resnet50_v1_module_fit: MXNet 1.x's ``example/ssd``
    ``train.py --network resnet50 --data-shape 512`` through the port's
    ``Module.fit`` (``SSD512``; its cuts listed there). Four fits from one
    seed, captured (site ``executor``: the training pair replayed from
    batch 1), eager, eager, captured. Each: the host clock at each batch
    end, launches by family (K1 one a batch over all 231 tensors, nothing
    else), the loss, peak memory. The first captured fit also: one more
    replayed ``forward_backward`` under ``set_sync_debug_mode`` (no host
    sync), a profiled batch (launches, busy share); the first eager fit a
    profiled batch split by group (backbone, extra layers and heads,
    MultiBoxTarget, MultiBoxDetection with its NMS, SoftmaxOutput and
    smooth-L1, K1). The replayed update of batch 1 against the eager one
    (``SSD_FIT_TOL``). Then ``deploy.py``'s graph (detections alone) at the
    same batch, captured against eager. Fails unless the executor
    captured with no uncaptured call, a replay syncs nothing, K1 launched
    once a batch, the replayed update matches, the first update lowered
    the loss and every detection row is valid."""
    t_phase = time.perf_counter()
    cfg = SSD512
    dev = mx.gpu(0)
    mx.random.seed(0)
    net, deploy, backbone = ssd_symbols(cfg)
    s = cfg["data_shape"]
    _, outs, _ = net.infer_shape(data=(cfg["batch"], 3, s, s),
                                 label=(cfg["batch"], cfg["max_objects"], 5))
    anchors = outs[3][1]
    if anchors != cfg["anchors"]:
        raise AssertionError(f"ssd: {anchors} anchors, expected "
                             f"{cfg['anchors']}")
    ops = {n["name"]: n["op"] for n in json.loads(net.tojson())["nodes"]}
    group = _ssd_group(backbone, ops)
    train = SSDDataIter(cfg)
    batches = cfg["epoch_size"]
    runs, profs, updates = [], {}, []
    extra = {}
    for mode in ("captured", "eager", "eager", "captured"):
        prev = compile_service.set_enabled(mode == "captured")
        try:
            mx.random.seed(0)
            model, log, update, run = _ssd_fit_once(cfg, net, train, dev)
            updates.append(update)
            if mode not in profs:
                train.reset()
                batch = train.next()
                if mode == "captured":
                    extra["replay_syncs"] = _sync_count(
                        lambda: model.forward_backward(batch))
                    extra["update_syncs"] = _sync_count(model.update)
                profs[mode] = _profile_ssd_batch(
                    model, batch, MultiBoxMetric(),
                    group if mode == "eager" else None)
        finally:
            compile_service.set_enabled(prev)
        run["mode"] = mode
        runs.append(run)
        want = dict.fromkeys(run["launches"], 0)
        want["opt_sgd"] = batches
        if run["launches"] != want:
            raise AssertionError(f"ssd {mode}: launches {run['launches']}, "
                                 f"expected {want}")
        if (len(model._param_names), len(model._aux_names)) != (
                cfg["tensors"], cfg["aux"]):
            raise AssertionError(f"ssd: {len(model._param_names)} "
                                 f"parameters, {len(model._aux_names)} aux")
        site = run["executor_site"]
        want_site = {"misses": 1, "hits": batches - 1, "captures": 1,
                     "replays": 2 * (batches - 1)} if mode == "captured" \
            else {"misses": 0, "hits": 0, "captures": 0, "replays": 0}
        if {k: site[k] for k in want_site} != want_site or \
                run["uncaptured"]:
            raise AssertionError(f"ssd {mode}: executor site {site}, "
                                 f"uncaptured {run['uncaptured']}, "
                                 f"expected {want_site}")
        loss0, loss1, _ = run["losses"]
        if not (loss0 is not None and loss1 is not None and
                math.isfinite(loss0) and loss1 < loss0):
            raise AssertionError(f"ssd {mode}: the first update did not "
                                 f"lower the loss: {run['losses']}")
        if run["batch_ends"] != batches:
            raise AssertionError(f"ssd {mode}: {run['batch_ends']} batches")
        if mode == "captured" and len(runs) == 4:
            last = model
        else:
            del model
        torch.cuda.empty_cache()
    if extra["replay_syncs"]:
        raise AssertionError(f"ssd: a replayed forward_backward synced the "
                             f"host: {extra['replay_syncs']}")
    zero = dict.fromkeys(updates[0], 0.0)
    agree = {name: _update_agreement(updates[a], updates[b], zero,
                                     SSD_FIT_TOL["floor"])
             for name, (a, b) in (("captured_vs_eager", (0, 1)),
                                  ("eager_vs_eager", (2, 1)),
                                  ("captured_vs_captured", (3, 0)))}
    limit = max(SSD_FIT_TOL["at_least"], SSD_FIT_TOL["noise_factor"] * max(
        agree["eager_vs_eager"]["max"], agree["captured_vs_captured"]["max"]))
    agree["limit"] = limit
    if agree["captured_vs_eager"]["max"] > limit:
        raise AssertionError(f"ssd: the replayed update differs from the "
                             f"eager one beyond the fits' spread: {agree}")
    del updates
    # deploy.py's graph at the fit's batch, with the last fit's weights
    ms, dets, infer_site = _ssd_infer(cfg, deploy, last, dev, train._data)
    infer_err = float(np.abs(dets["captured"] - dets["eager"]).max())
    valid = {m: valid_detections(dets[m]) for m in ("captured", "eager")}
    if infer_err > SSD_FIT_TOL["infer"] or not all(
            v[0] for v in valid.values()) or dets["syncs"] or \
            not infer_site["captures"]:
        raise AssertionError(f"ssd inference: captured against eager "
                             f"{infer_err}, valid {valid}, syncs "
                             f"{dets['syncs']}, site {infer_site}")
    train.reset()
    last.forward(train.next(), is_train=False)
    det_ok, det_kept = valid_detections(last.get_outputs()[3])
    if not det_ok:
        raise AssertionError("ssd: a training graph's detection row is "
                             "not valid")
    timed = {m: [v for r in runs if r["mode"] == m
                 for v in r["batch_ms"][cfg["warmup"] - 1:]]
             for m in ("captured", "eager")}
    median = {m: statistics.median(v) for m, v in timed.items()}
    cap = runs[0]
    out = {"phase": "ssd512_resnet50_v1_module_fit", "card": smi,
           "config": cfg, "tolerance": SSD_FIT_TOL, "tf32": False,
           "source": "apache/incubator-mxnet example/ssd train.py "
                     "--network resnet50 --data-shape 512 "
                     "(symbol_factory.py resnet50)",
           "anchors": anchors, "batches": batches,
           "abba_order": [r["mode"] for r in runs],
           "median_batch_ms": median["captured"],
           "median_batch_ms_eager": median["eager"],
           "img_per_s": cfg["batch"] / (median["captured"] / 1e3),
           "img_per_s_eager": cfg["batch"] / (median["eager"] / 1e3),
           "block_medians_ms": {m: [r["median_batch_ms"] for r in runs
                                    if r["mode"] == m]
                                for m in ("captured", "eager")},
           "batch_ms": cap["batch_ms"], "fit_s": [r["fit_s"] for r in runs],
           "speedometer_img_per_s": cap["speedometer_img_per_s"],
           "max_memory_allocated": cap["max_memory_allocated"],
           "max_memory_allocated_eager": runs[1]["max_memory_allocated"],
           "graph_pool_bytes": cap["graph_pool_bytes"],
           "graph_pool_bytes_eager": runs[1]["graph_pool_bytes"],
           "launches": cap["launches"], "executor_site": cap["executor_site"],
           "losses_first_second_last": {r["mode"] + str(i): r["losses"]
                                        for i, r in enumerate(runs)},
           "replay_host_syncs": extra["replay_syncs"],
           "update_host_syncs": extra["update_syncs"],
           "replayed_update_vs_eager": agree,
           "profiled_captured": profs["captured"],
           "profiled_eager": profs["eager"],
           "detections_kept_per_image": det_kept,
           "infer": {"ms_captured": ms["captured"], "ms_eager": ms["eager"],
                     "img_per_s": cfg["batch"] / (statistics.median(
                         ms["captured"]) / 1e3),
                     "captured_vs_eager_max_abs": infer_err,
                     "kept_per_image": valid["captured"][1],
                     "host_syncs": dets["syncs"], "site": infer_site},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del last, train
    torch.cuda.empty_cache()
    return out


# bert_base_sst2_finetune_zero: the fine-tune cell's trainer under the
# options of ShardedTrainer this slice ports, and the telemetry stack
FINETUNE_ZERO = {"bit_steps": 5, "warm_check": 3, "report_steps": 20,
                 "abba_steps": 10, "warmup": 2, "predict_rows": 4}
# phases plus "other" against duration_ms: each of the six is rounded to
# 1e-3 ms, so they may differ by up to 6 x 5e-4 ms
PHASE_SUM_TOL_MS = 3.5e-3
H100_BF16_TFLOPS = 989.4   # NVIDIA's dense bf16 peak of the SXM H100


def classifier_step_flops(cfg, batch):
    """The flops of one "adam" ``ShardedTrainer`` step of
    :func:`build_classifier` as the port counts them
    (``telemetry.costs``): each Dense 2·rows·in·out forward and twice
    that backward (every Dense's input gradient is needed: the encoder's
    input is the trainable embedding's output), K3 4·B·S·S·U and K3-bwd
    10·B·S·S·U a layer (the heads' B·H·S·S·D with U = H·D), K2 15 a
    parameter element. Elementwise aten ops are not counted."""
    b, s, u, h = batch, cfg["seq_len"], cfg["units"], cfg["hidden"]
    rows = b * s
    dense = cfg["layers"] * (4 * 2 * rows * u * u + 2 * 2 * rows * u * h)
    dense += 2 * b * u * u + 2 * b * u * cfg["num_classes"]
    attention = cfg["layers"] * (4 + 10) * b * s * s * u
    params = sum(int(np.prod(v)) for v in classifier_shapes(cfg).values())
    return 3 * dense + attention + 15 * params


def _states_equal(a, b):
    """Whether two trainers' weights, aux and optimizer state are equal
    bit for bit."""
    return all(torch.equal(u, v) for u, v in zip(
        a._state_tensors().values(), b._state_tensors().values()))


def _tsteps_begin_end(rec):
    """Open and close one step record shaped like ``rec`` (its phases
    and flops): the step timeline's host work alone."""
    from mxnet_tpu_torch.telemetry import steps as tsteps

    tsteps.begin_step(rec["step"] + 1)
    for name, ms in rec["phases"].items():
        if name != "other":
            tsteps.phase(name, ms)
    tsteps.end_step(flops=rec.get("flops"))


def _median_ms(st, x, y, steps):
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        float(st.step(x, y)._data.float())
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def _traced_post(port, x, rid):
    """One predict request through the HTTP front end, with
    ``X-Request-Id`` when ``rid`` is given: ``(status, body, header
    id)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        headers = {"Content-Type": "application/json"}
        if rid is not None:
            headers["X-Request-Id"] = rid
        conn.request("POST", "/v1/models/bert_base_sst2_zero:predict",
                     json.dumps({"data": x.tolist()}), headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), \
            resp.getheader("X-Request-Id")
    finally:
        conn.close()


def _scraped(text, name, **labels):
    """A metric's value in a Prometheus text, or None."""
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if all(f'{k}="{v}"' in line for k, v in labels.items()):
                return float(line.rsplit(" ", 1)[1])
    return None


def _chrome_events(path):
    """The events of a Chrome-trace JSON file, each checked for the
    fields a viewer needs."""
    with open(path) as f:
        payload = json.load(f)
    events = payload["traceEvents"]
    if payload.get("displayTimeUnit") != "ms" or not events:
        raise AssertionError(f"trace dump {path}: no events")
    for ev in events:
        if not {"name", "ph", "ts", "pid", "tid"} <= set(ev) or \
                ev["ph"] not in ("X", "i", "M") or \
                (ev["ph"] == "X" and ev["dur"] < 0):
            raise AssertionError(f"trace dump: bad event {ev}")
    return events


def _finetune_zero_serving(cfg, weights):
    """Item 8: the classifier served behind the HTTP front end, tracing
    on, 48 requests from 4 threads (half with the caller's
    ``X-Request-Id``); every answer carries its id and five phases and
    equals the block's output; ``GET /metrics`` against ``stats()``; the
    trace dump."""
    from mxnet_tpu_torch.telemetry import trace

    trace.clear()
    clf = _classifier_on(mx.gpu(0), cfg, weights)
    model = serving.ServedModel.from_block("bert_base_sst2_zero", clf,
                                           example_shape=(cfg["seq_len"],))
    server = serving.ModelServer(serving.ModelContainer([model])).start()
    front = None
    try:
        server.warmup()
        front = serving.HttpFrontEnd(server).start()
        payloads = _traffic(cfg)
        answers = [[None] * len(row) for row in payloads]
        kernels.reset_launch_counts()

        def client(i):
            for j, x in enumerate(payloads[i]):
                rid = f"zero-{i}-{j}" if j % 2 == 0 else None
                answers[i][j] = (rid,) + _traced_post(front.port, x, rid)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise RuntimeError("an HTTP client did not finish")
        launches = kernels.launch_counts()["flash_attention"]
        ids, worst = set(), 0.0
        for row_p, row_a in zip(payloads, answers):
            for x, (rid, status, body, hdr) in zip(row_p, row_a):
                phases = body.get("phases") or {}
                if status != 200 or body["request_id"] != hdr or \
                        (rid is not None and hdr != rid) or \
                        any(phases.get(k) is None
                            for k in trace.REQUEST_PHASES) or \
                        not phases.get("total_ms", 0) > 0:
                    raise AssertionError(f"finetune_zero serving: answer "
                                         f"{status} {hdr} {body.keys()} "
                                         f"{phases}")
                ids.add(hdr)
                got = np.asarray(body["outputs"][0], np.float32)
                with torch.inference_mode():
                    want = clf(mx.nd.array(x)).asnumpy()
                np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                           atol=SERVE_TOL)
                worst = max(worst, float(np.abs(got - want).max()))
        n = sum(len(row) for row in payloads)
        if len(ids) != n:
            raise AssertionError(f"{len(ids)} request ids for {n} answers")
        import urllib.request

        with urllib.request.urlopen(front.url + "/metrics",
                                    timeout=60) as resp:
            status, text = resp.status, resp.read().decode()
        stats = server.stats()["models"][model.name]
        scraped = {k: _scraped(text, name, model=model.name, **lab)
                   for k, name, lab in (
                       ("completed", "mxtpu_serving_requests_total",
                        {"outcome": "completed"}),
                       ("batches", "mxtpu_serving_batches_total", {}),
                       ("rows", "mxtpu_serving_rows_total", {}))}
        rows = sum(x.shape[0] for row in payloads for x in row)
        if status != 200 or scraped != {
                k: float(stats[k]) for k in scraped} or \
                stats["completed"] != n or stats["rows"] != rows:
            raise AssertionError(f"/metrics {status} {scraped} against "
                                 f"stats {stats}")
        if launches != cfg["layers"] * stats["batches"]:
            raise AssertionError(f"finetune_zero serving: {launches} flash "
                                 f"launches for {stats['batches']} batches")
        breakdowns = [b["phases"] for row in answers for (_, _, b, _) in row]
        with tempfile.TemporaryDirectory() as d:
            events = _chrome_events(trace.dump(os.path.join(d,
                                                            "trace.json")))
        cats = {e.get("cat") for e in events}
        if not {"trace.request", "trace.phase"} <= cats:
            raise AssertionError(f"trace dump categories {cats}")
        return {"requests": n, "rows": rows, "batches": stats["batches"],
                "scraped": scraped, "flash_launches": launches,
                "max_abs_err_vs_block": worst,
                "median_phase_ms": {k: statistics.median(
                    b[k] for b in breakdowns)
                    for k in (*trace.REQUEST_PHASES, "total_ms")},
                "trace_events": len(events), "trace_categories": sorted(
                    c for c in cats if c)}
    finally:
        if front is not None:
            front.close()
        server.drain(timeout=60)
        server.stop()


def phase_bert_finetune_zero(smi):
    """bert_base_sst2_finetune_zero: the fine-tune cell (BERT-base, "adam",
    batch 32, seq 128) under ``ShardedTrainer(..., zero=True,
    rules=sharding_rules(...))`` on ``DeviceMesh({"dp": 1})``:
    ``warmup`` (one capture, no step, the state untouched; the first step
    a replay; 3 steps bit for bit a cold trainer's), ``zero=True`` against
    ``zero=False`` (5 steps, bit for bit), 20 steps with
    ``step_report()`` (phases summing to the duration, the flops equal to
    :func:`classifier_step_flops`, ``mfu_xla`` against 989.4 TFLOP/s, the
    fine-tune's launches), the peak-memory gauge against
    ``torch.cuda.max_memory_allocated()``, ``donate=False`` against
    ``donate=True`` (A B B A: step ms, peak added, its persistent bytes; a
    tensor taken before a step keeps its values), telemetry on against off
    (A B B A), ``unshard(ctx=mx.cpu())`` and the CPU forward against the
    card's ``predict``, and the served classifier over HTTP with tracing
    on (:func:`_finetune_zero_serving`)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.parallel import sharding_rules
    from mxnet_tpu_torch.telemetry import costs, memory, registry

    t_phase = time.perf_counter()
    # the modules the flop count and aot_lower import at their first use
    # (already imported when an earlier phase made a compiled entry)
    import torch.utils.flop_counter  # noqa: F401
    import torch._subclasses.fake_tensor  # noqa: F401
    import_ms = (time.perf_counter() - t_phase) * 1e3
    cfg, tr, fz = BERT_BASE, TRAIN, FINETUNE_ZERO
    layers, steps = cfg["layers"], fz["report_steps"]
    weights = random_params(cfg, seed=0)
    x, y = make_task(tr["batch"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    xb, yb = mx.nd.array(x), mx.nd.array(y)
    mesh = DeviceMesh({"dp": 1})

    def trainer(clf=None, **kw):
        clf = clf or _classifier_on(mx.gpu(0), cfg, weights)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            "adam", {"learning_rate": tr["lr"],
                                     "wd": tr["wd"]}, mesh=mesh, **kw)
        torch.cuda.synchronize()
        return clf, st, torch.cuda.memory_allocated() - before

    # 1. warmup: one capture and no step
    clf = _classifier_on(mx.gpu(0), cfg, weights)
    rules = sharding_rules(clf.collect_params(), mesh)
    clf, st, _ = trainer(clf, zero=True, rules=rules)
    if st.topology_meta()["zero"] is not True or any(rules.values()):
        raise AssertionError("finetune_zero: zero not recorded, or a rule "
                             "that shards on one device")
    start = _snapshot(st)
    gen = mx_random.generator(st._device).get_state()
    site0 = _site_stats("trainer")
    t0 = time.perf_counter()
    report = st.warmup(xb, yb)
    warmup_ms = (time.perf_counter() - t0) * 1e3
    site1 = _site_stats("trainer")
    untouched = all(torch.equal(a, b) for a, b in zip(
        start[0], st._state_tensors().values())) and st._t == 0 and \
        torch.equal(gen, mx_random.generator(st._device).get_state())
    kernels.reset_launch_counts()
    st.step(xb, yb)
    site2 = _site_stats("trainer")
    first = {k: v for k, v in kernels.launch_counts().items() if v}
    warm = {"captures": site1["captures"] - site0["captures"],
            "replays": site1["replays"] - site0["replays"],
            "first_step_captures": site2["captures"] - site1["captures"],
            "first_step_replays": site2["replays"] - site1["replays"],
            "ms": warmup_ms, "report": report, "state_untouched": untouched,
            "first_step_launches": first}
    if (warm["captures"], warm["replays"], warm["first_step_captures"],
            warm["first_step_replays"]) != (1, 0, 0, 1) or not untouched:
        raise AssertionError(f"finetune_zero warmup: {warm}")
    # 1 and 3: against a cold zero=False trainer, bit for bit
    _, cold, cold_bytes = trainer()
    cold.step(xb, yb)
    bitwise = {}
    for k in range(2, fz["bit_steps"] + 1):
        st.step(xb, yb)
        cold.step(xb, yb)
        if k in (fz["warm_check"], fz["bit_steps"]):
            bitwise[k] = _states_equal(st, cold)
    if not all(bitwise.values()):
        raise AssertionError(f"finetune_zero: warmed zero=True against "
                             f"cold zero=False: bit for bit {bitwise}")
    del cold
    torch.cuda.empty_cache()

    # 2. twenty steps with step_report
    kernels.reset_launch_counts()
    reports = []
    for _ in range(steps):
        st.step(xb, yb)
        reports.append(st.step_report())
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want_counts = {"opt_adam": steps}
    for f in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        want_counts[f] = want_counts[f + ".mma"] = layers * steps
    flops = classifier_step_flops(cfg, tr["batch"])
    peak = costs.peak_tflops()
    sums = [abs(sum(r["phases"].values()) - r["duration_ms"])
            for r in reports]
    # mfu_xla from the unrounded duration, rounded to 5 places: 1e-5
    bad = [r for r in reports if r.get("flops") != flops or
           abs(r["mfu_xla"] - costs.mfu_xla(
               flops, 1e3 / r["duration_ms"], peak=H100_BF16_TFLOPS)) > 1e-5]
    if counts != want_counts or peak != H100_BF16_TFLOPS or bad or \
            max(sums) > PHASE_SUM_TOL_MS:
        raise AssertionError(f"finetune_zero reports: launches {counts} "
                             f"(want {want_counts}), peak {peak}, flops "
                             f"{flops}, off {bad[:1]}, phase sums {sums}")
    report_ms = [r["duration_ms"] for r in reports]

    # 5. the peak-memory gauge against the allocator's peak
    memory.sample()
    gauge = registry.get("mxtpu_device_memory_peak_bytes").series()
    torch_peak = torch.cuda.max_memory_allocated(0)
    if gauge.get(("gpu:0",)) != float(torch_peak):
        raise AssertionError(f"peak gauge {gauge} against {torch_peak}")

    # 6. telemetry on against off, A B B A over the captured step
    n = fz["abba_steps"]
    tele = []
    for on in (True, False, False, True):
        prev = telemetry.set_enabled(on)
        try:
            med, ms = _median_ms(st, xb, yb, n)
        finally:
            telemetry.set_enabled(prev)
        tele.append({"telemetry": on, "median_ms": med, "step_ms": ms})
    on_ms = [b["median_ms"] for b in tele if b["telemetry"]]
    off_ms = [b["median_ms"] for b in tele if not b["telemetry"]]
    # the hooks' parts on the host: a memory sample, and the step record
    # closed with everything else (end_step, its span, gauges, flight)
    t0 = time.perf_counter()
    for _ in range(100):
        memory.device_memory()
    memory_sample_us = (time.perf_counter() - t0) * 1e4
    last = dict(reports[-1])
    prev_every = os.environ.get("MXNET_TPU_TELEMETRY_MEMSAMPLE")
    os.environ["MXNET_TPU_TELEMETRY_MEMSAMPLE"] = "0"
    try:
        t0 = time.perf_counter()
        for _ in range(100):
            _tsteps_begin_end(last)
        record_us = (time.perf_counter() - t0) * 1e4
    finally:
        if prev_every is None:
            del os.environ["MXNET_TPU_TELEMETRY_MEMSAMPLE"]
        else:
            os.environ["MXNET_TPU_TELEMETRY_MEMSAMPLE"] = prev_every
    donate_profile = _profiled_step(st, xb, yb, eager=False)

    # 4. donate=False against donate=True, A B B A
    _, kept, kept_bytes = trainer(zero=True, donate=False)
    t0 = time.perf_counter()
    kept.warmup(xb, yb)   # a second warmup: the first one's one-time costs
    warm["second_trainer_ms"] = (time.perf_counter() - t0) * 1e3
    p_before = kept._train_handles[0]._data
    s_before = kept._opt_state[0][0]
    p_val, s_val = p_before.clone(), s_before.clone()
    kept.step(xb, yb)
    keeps = torch.equal(p_before, p_val) and torch.equal(s_before, s_val) \
        and not torch.equal(kept._train_handles[0]._data, p_val)
    del p_before, s_before, p_val, s_val
    if not keeps:
        raise AssertionError("finetune_zero: donate=False changed a tensor "
                             "taken before the step")
    donate = []
    for which, tr_ in (("donate", st), ("keep", kept), ("keep", kept),
                       ("donate", st)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        med, ms = _median_ms(tr_, xb, yb, n)
        torch.cuda.synchronize()
        donate.append({"trainer": which, "median_ms": med, "step_ms": ms,
                       "peak_added": torch.cuda.max_memory_allocated()
                       - base})
    kept_profile = _profiled_step(kept, xb, yb, eager=False)
    # donate=False's host work around the replay: the check of what was
    # handed out, and the fresh copies (allocation and enqueue only)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kept._adopt()
    adopt_us = (time.perf_counter() - t0) * 5e4
    t0 = time.perf_counter()
    for _ in range(20):
        kept._hand_out()
    hand_out_us = (time.perf_counter() - t0) * 5e4
    torch.cuda.synchronize()
    del kept
    torch.cuda.empty_cache()

    # 7. unshard, then the block's forward on the CPU against predict
    rows = mx.nd.array(x[:fz["predict_rows"]])
    card = st.predict(rows).asnumpy()
    st.unshard(ctx=mx.cpu())
    on_cpu = all(h._data.device.type == "cpu"
                 for h in st._train_handles + st._aux_handles)
    with mx.cpu(), torch.inference_mode():
        cpu = clf(mx.nd.array(x[:fz["predict_rows"]])).asnumpy()
    np.testing.assert_allclose(cpu, card, rtol=CPU_TOL, atol=CPU_TOL)
    if not on_cpu:
        raise AssertionError("finetune_zero: unshard left a handle on the "
                             "card")
    unshard_err = float(np.abs(cpu - card).max())
    n_tensors = len(st._param_names)
    del st, clf
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the served classifier over HTTP, traced
    served = _finetune_zero_serving(cfg, weights)

    med = statistics.median(report_ms[tr["warmup"]:])
    phase_med = {k: statistics.median(r["phases"][k] for r in reports)
                 for k in reports[0]["phases"]}
    out = {"phase": "bert_base_sst2_finetune_zero", "card": smi,
           "config": cfg, **tr, "zero": True, "rules": "sharding_rules",
           "trainable_tensors": n_tensors, "warmup": warm,
           "bitwise_vs_cold_zero_false": bitwise,
           "report_step_ms": report_ms, "median_step_ms": med,
           "tokens_per_s": tr["batch"] * cfg["seq_len"] / (med / 1e3),
           "median_phases_ms": phase_med, "last_report": reports[-1],
           "flops": flops, "flops_reported": reports[-1]["flops"],
           "peak_tflops": peak,
           "mfu_xla_median": statistics.median(r["mfu_xla"]
                                               for r in reports),
           "max_phase_sum_gap_ms": max(sums),
           "launches": counts, "peak_gauge_bytes": gauge[("gpu:0",)],
           "max_memory_allocated": torch_peak,
           "telemetry_abba": tele,
           "telemetry_on_minus_off_ms": statistics.mean(on_ms)
           - statistics.mean(off_ms),
           "telemetry_spread_ms": {"on": abs(on_ms[0] - on_ms[1]),
                                   "off": abs(off_ms[0] - off_ms[1])},
           "donate_abba": donate,
           "donate_false_minus_true_ms": statistics.mean(
               b["median_ms"] for b in donate if b["trainer"] == "keep")
           - statistics.mean(b["median_ms"] for b in donate
                             if b["trainer"] == "donate"),
           "donate_false_extra_bytes": kept_bytes - cold_bytes,
           "donate_false_profiled_step": kept_profile,
           "donate_true_profiled_step": donate_profile,
           "donate_false_host_us": {"adopt": adopt_us,
                                    "hand_out": hand_out_us},
           "telemetry_host_us": {"memory_sample": memory_sample_us,
                                 "step_record": record_us},
           "flop_counter_import_ms": import_ms,
           "trainer_bytes": {"donate_true": cold_bytes,
                             "donate_false": kept_bytes},
           "unshard_max_abs_err_vs_card": unshard_err,
           "serving": served, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ------------------------------------------------------- sparse phases --
# examples/sparse/'s three flows over the port, as the examples write them
# (their synthetic data copied here: the examples live beside the JAX
# package and are not imported); each returns its per-epoch numbers.


def synthetic_fm_data(num_samples, num_features, factor_size, nnz, seed=0):
    """``examples/sparse/factorization_machine.py:32-51``: sparse rows
    labelled by a planted FM."""
    rs = np.random.RandomState(seed)
    true_w = 0.5 * rs.randn(num_features).astype(np.float32)
    true_v = 0.8 * rs.randn(num_features, factor_size).astype(np.float32)
    rows, vals, labels = [], [], []
    for _ in range(num_samples):
        idx = rs.choice(num_features, nnz, replace=False)
        x = rs.rand(nnz).astype(np.float32)
        lin = float((true_w[idx] * x).sum())
        s = (x[:, None] * true_v[idx]).sum(0)
        inter = 0.5 * float((s * s).sum() -
                            ((x ** 2)[:, None] * true_v[idx] ** 2).sum())
        rows.append(idx)
        vals.append(x)
        labels.append(1.0 if lin + inter > 0 else 0.0)
    return np.stack(rows), np.stack(vals), np.asarray(labels, np.float32)


def synthetic_sparse_data(num_samples=2000, num_features=1000, nnz=12,
                          seed=0):
    """``examples/sparse/linear_classification.py:26-38``."""
    rs = np.random.RandomState(seed)
    true_w = rs.randn(num_features).astype(np.float32)
    rows, vals, labels = [], [], []
    for _ in range(num_samples):
        idx = rs.choice(num_features, nnz, replace=False)
        v = rs.rand(nnz).astype(np.float32)
        rows.append(idx)
        vals.append(v)
        labels.append(1.0 if (true_w[idx] * v).sum() > 0 else 0.0)
    return np.stack(rows), np.stack(vals), np.asarray(labels, np.float32)


def synthetic_ratings(num_users, num_items, factor, num_ratings, seed=0):
    """``examples/sparse/matrix_factorization.py:28-35``."""
    rs = np.random.RandomState(seed)
    true_u = rs.randn(num_users, factor).astype(np.float32)
    true_i = rs.randn(num_items, factor).astype(np.float32)
    users = rs.randint(0, num_users, num_ratings)
    items = rs.randint(0, num_items, num_ratings)
    ratings = (true_u[users] * true_i[items]).sum(1).astype(np.float32)
    return users, items, ratings


def _pull_rows(kv, key, uniq, width, nrows):
    """The examples' ``pull_rows``: a row-sparse ``out`` of the touched
    rows, ``row_sparse_pull``, its values on the host."""
    out = mx.nd.sparse.row_sparse_array(
        (np.zeros((len(uniq), width), np.float32), uniq.astype(np.int64)),
        shape=(nrows, width))
    kv.row_sparse_pull(key, out=out, row_ids=mx.nd.array(uniq))
    return out.data.asnumpy()


def fm_math(x, y, inv, w_rows, v_rows, w0, batch_norm):
    """The example's host math for one batch (``:130-157``): the FM's
    logits, loss and correct count, and the gradients of the touched rows
    (``gw``, ``gv``) and of ``w0``, each batch row's term divided by
    ``batch_norm``."""
    fs = v_rows.shape[1]
    wb = w_rows[inv]
    vb = v_rows[inv]
    s = (x[:, :, None] * vb).sum(1)
    lin = (x * wb).sum(1)
    inter = 0.5 * ((s * s).sum(1) -
                   ((x ** 2)[:, :, None] * vb ** 2).sum((1, 2)))
    prob = 1.0 / (1.0 + np.exp(-(w0 + lin + inter)))
    loss = float(-np.mean(y * np.log(prob + 1e-8) +
                          (1 - y) * np.log(1 - prob + 1e-8)))
    correct = int(((prob > 0.5) == (y > 0.5)).sum())
    g = (prob - y) / batch_norm
    n_rows = w_rows.shape[0]
    gw = np.zeros((n_rows,), np.float32)
    np.add.at(gw, inv.reshape(-1), (g[:, None] * x).reshape(-1))
    gv = np.zeros((n_rows, fs), np.float32)
    gv_rows = (g[:, None, None] *
               (x[:, :, None] * s[:, None, :] - (x ** 2)[:, :, None] * vb))
    np.add.at(gv, inv.reshape(-1), gv_rows.reshape(-1, fs))
    return loss, correct, gw, gv, np.array([g.sum()], np.float32)


def fm_store(nf, fs, lr, kvstore="local"):
    """The example's store (``:99-107``): ``w`` (nf, 1), ``v`` (nf, fs)
    from ``RandomState(1)``, ``w0``, and "sgd" on it."""
    rs = np.random.RandomState(1)
    kv = mx.kv.create(kvstore)
    kv.init("w", mx.nd.array(0.01 * rs.randn(nf, 1).astype(np.float32)))
    kv.init("v", mx.nd.array(0.1 * rs.randn(nf, fs).astype(np.float32)))
    kv.init("w0", mx.nd.zeros((1,)))
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=lr))
    return kv


def fm_pull(kv, uniq, nf, fs):
    """``w``'s and ``v``'s touched rows and ``w0``, on the host."""
    w_rows = _pull_rows(kv, "w", uniq, 1, nf)[:, 0]
    v_rows = _pull_rows(kv, "v", uniq, fs, nf)
    out0 = mx.nd.zeros((1,))
    kv.pull("w0", out=out0)
    return w_rows, v_rows, float(out0.asnumpy()[0])


def fm_push(kv, uniq, gw, gv, g0, nf, fs):
    idx = uniq.astype(np.int64)
    kv.push("w", mx.nd.sparse.row_sparse_array((gw[:, None], idx),
                                               shape=(nf, 1)))
    kv.push("v", mx.nd.sparse.row_sparse_array((gv, idx), shape=(nf, fs)))
    kv.push("w0", mx.nd.array(g0))


def sparse_fm_example(ctx, num_epoch=15, batch_size=64, input_size=2000,
                      factor_size=8, lr=1.0, kvstore="local",
                      num_examples=2000, nnz=10):
    """``examples/sparse/factorization_machine.py``'s ``main`` on its
    synthetic data, on ``ctx``: per epoch the training accuracy and
    logloss it prints."""
    nf, fs = input_size, factor_size
    rows, vals, labels = synthetic_fm_data(num_examples, nf, fs, nnz)
    n = rows.shape[0]
    nbatch = n // batch_size
    epochs = []
    with ctx:
        kv = fm_store(nf, fs, lr, kvstore)
        for epoch in range(num_epoch):
            perm = np.random.RandomState(epoch).permutation(n)
            total_loss, correct = 0.0, 0
            for b in range(nbatch):
                sel = perm[b * batch_size:(b + 1) * batch_size]
                idx, x, y = rows[sel], vals[sel], labels[sel]
                uniq, inv = np.unique(idx, return_inverse=True)
                inv = inv.reshape(idx.shape)
                w_rows, v_rows, w0 = fm_pull(kv, uniq, nf, fs)
                loss, ok, gw, gv, g0 = fm_math(x, y, inv, w_rows, v_rows, w0,
                                               len(sel))
                total_loss += loss
                correct += ok
                fm_push(kv, uniq, gw, gv, g0, nf, fs)
            epochs.append({"accuracy": correct / (nbatch * batch_size),
                           "logloss": total_loss / nbatch})
    return epochs


def sparse_linear_example(ctx, num_epoch=8, batch_size=64,
                          num_features=1000, lr=4.0, kvstore="local"):
    """``examples/sparse/linear_classification.py``'s ``main``: per
    epoch the accuracy and logloss it prints."""
    rows, vals, labels = synthetic_sparse_data(num_features=num_features)
    n = rows.shape[0]
    nbatch = n // batch_size
    epochs = []
    with ctx:
        kv = mx.kv.create(kvstore)
        kv.init("weight", mx.nd.zeros((num_features, 1)))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=lr))
        for epoch in range(num_epoch):
            perm = np.random.RandomState(epoch).permutation(n)
            total_loss, correct = 0.0, 0
            for b in range(nbatch):
                sel = perm[b * batch_size:(b + 1) * batch_size]
                idx, val, y = rows[sel], vals[sel], labels[sel]
                uniq = np.unique(idx)
                pulled = mx.nd.sparse.row_sparse_array(
                    (np.zeros((len(uniq), 1), np.float32),
                     uniq.astype(np.int64)), shape=(num_features, 1))
                kv.row_sparse_pull("weight", out=pulled,
                                   row_ids=mx.nd.array(uniq))
                w = np.zeros((num_features,), np.float32)
                w[np.asarray(pulled.indices.asnumpy(), np.int64)] = \
                    pulled.data.asnumpy()[:, 0]
                logits = (val * w[idx]).sum(axis=1)
                prob = 1.0 / (1.0 + np.exp(-logits))
                total_loss += float(-np.mean(
                    y * np.log(prob + 1e-8) +
                    (1 - y) * np.log(1 - prob + 1e-8)))
                correct += int(((prob > 0.5) == (y > 0.5)).sum())
                gscale = (prob - y) / len(sel)
                gw = np.zeros((num_features,), np.float32)
                np.add.at(gw, idx.reshape(-1),
                          (gscale[:, None] * val).reshape(-1))
                kv.push("weight", mx.nd.sparse.row_sparse_array(
                    (gw[uniq][:, None], uniq.astype(np.int64)),
                    shape=(num_features, 1)))
            epochs.append({"accuracy": correct / (nbatch * batch_size),
                           "logloss": total_loss / nbatch})
    return epochs


def sparse_mf_example(ctx, num_epoch=10, batch_size=128, num_users=500,
                      num_items=400, factor_size=8, num_ratings=8000,
                      lr=0.02, kvstore="local"):
    """``examples/sparse/matrix_factorization.py``'s ``main``: per epoch
    the RMSE it prints."""
    nu, ni, fs = num_users, num_items, factor_size
    users, items, ratings = synthetic_ratings(nu, ni, fs, num_ratings)
    n = len(ratings)
    nbatch = n // batch_size
    epochs = []
    with ctx:
        rs = np.random.RandomState(1)
        kv = mx.kv.create(kvstore)
        kv.init("user", mx.nd.array(0.5 * rs.randn(nu, fs).astype(
            np.float32)))
        kv.init("item", mx.nd.array(0.5 * rs.randn(ni, fs).astype(
            np.float32)))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=lr))
        for epoch in range(num_epoch):
            perm = np.random.RandomState(epoch).permutation(n)
            sq = 0.0
            for b in range(nbatch):
                sel = perm[b * batch_size:(b + 1) * batch_size]
                u, i, y = users[sel], items[sel], ratings[sel]
                uu, uinv = np.unique(u, return_inverse=True)
                ii, iinv = np.unique(i, return_inverse=True)
                U = _pull_rows(kv, "user", uu, fs, nu)  # noqa: N806
                V = _pull_rows(kv, "item", ii, fs, ni)  # noqa: N806
                err = (U[uinv] * V[iinv]).sum(1) - y
                sq += float((err ** 2).sum())
                g = err[:, None]
                gU = np.zeros_like(U)  # noqa: N806
                np.add.at(gU, uinv, g * V[iinv])
                gV = np.zeros_like(V)  # noqa: N806
                np.add.at(gV, iinv, g * U[uinv])
                kv.push("user", mx.nd.sparse.row_sparse_array(
                    (gU, uu.astype(np.int64)), shape=(nu, fs)))
                kv.push("item", mx.nd.sparse.row_sparse_array(
                    (gV, ii.astype(np.int64)), shape=(ni, fs)))
            epochs.append({"rmse": float(np.sqrt(sq / (nbatch *
                                                       batch_size)))})
    return epochs


# fm_criteo_row_sparse (b): the factorization machine at the width of
# LIBSVM's "criteo" set (1,000,000 hashed features, 39 non-zeros a row),
# factor 16, batch 1000, "sgd" at the example's lr on a local store. The
# data: 100,000 rows with synthetic_fm_data's planted-FM labels, written
# as a LibSVM file and read back by LibSVMIter. The cut: 100,000 rows and
# 100 batches, not the set's 45.8 M rows
FM_CRITEO = {"features": 1_000_000, "nnz": 39, "factor": 16, "batch": 1000,
             "rows": 100_000, "batches": 100, "lr": 1.0, "seed": 7,
             "source": "LIBSVM datasets, binary: criteo (1,000,000 hashed "
                       "features, 39 a row)",
             "reduced": "100,000 synthetic rows and 100 batches, not "
                        "45,840,617 rows"}
# dist_sparse_async (a): FM_CRITEO's width under dist_sync on two workers,
# each half of every batch; (b): train_imagenet.py --kv-store dist_async
# --network resnet50_v1 --benchmark 1 on two workers of batch 128 each
DIST_SPARSE = {"workers": 2, "fm_batches": 20, "timeout_s": 420,
               "check_batches": 2, "gather_reps": 3}
FM_EXAMPLE_TOL = 1e-4   # each epoch's number, card against the CPU


def criteo_fm_data(cfg):
    """``cfg["rows"]`` rows of ``cfg["nnz"]`` distinct features (sorted)
    of ``cfg["features"]``, values in [0, 1), labelled by a planted FM as
    ``synthetic_fm_data`` does, made vectorised: a row's features drawn
    with replacement and redrawn while any repeats (``choice(...,
    replace=False)`` would permute every feature on every row)."""
    nf, nnz, fs, n = cfg["features"], cfg["nnz"], cfg["factor"], cfg["rows"]
    rs = np.random.RandomState(cfg["seed"])
    true_w = 0.5 * rs.randn(nf).astype(np.float32)
    true_v = 0.8 * rs.randn(nf, fs).astype(np.float32)
    idx = np.sort(rs.randint(0, nf, (n, nnz)), axis=1)
    while True:
        dup = (np.diff(idx, axis=1) == 0).any(axis=1)
        if not dup.any():
            break
        idx[dup] = np.sort(rs.randint(0, nf, (int(dup.sum()), nnz)), axis=1)
    x = rs.rand(n, nnz).astype(np.float32)
    labels = np.empty(n, np.float32)
    for lo in range(0, n, 10_000):
        xi, ii = x[lo:lo + 10_000], idx[lo:lo + 10_000]
        lin = (true_w[ii] * xi).sum(1)
        tv = true_v[ii]
        s = (xi[:, :, None] * tv).sum(1)
        inter = 0.5 * ((s * s).sum(1) - ((xi ** 2)[:, :, None] *
                                         tv ** 2).sum((1, 2)))
        labels[lo:lo + 10_000] = (lin + inter > 0).astype(np.float32)
    return idx, x, labels


def criteo_libsvm(cfg):
    """The LibSVM file of :func:`criteo_fm_data` under the build
    directory (written once a run): ``<label> <idx>:<value> ...``, each
    value with 9 significant digits (a float32 read back exactly)."""
    path = build.BUILD_DIR / f"criteo_fm_{cfg['rows']}_{cfg['seed']}.libsvm"
    if path.exists():
        return path
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    idx, x, labels = criteo_fm_data(cfg)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        for lo in range(0, len(labels), 10_000):
            ii, xi = idx[lo:lo + 10_000], x[lo:lo + 10_000]
            pairs = np.char.add(np.char.add(ii.astype(str), ":"),
                                np.char.mod("%.9g", xi))
            lines = [f"{int(y)} " + " ".join(p) for y, p in
                     zip(labels[lo:lo + 10_000], pairs)]
            f.write("\n".join(lines) + "\n")
    tmp.rename(path)
    return path


def _csr_batch(csr, nnz, lo=None, hi=None):
    """A LibSVM batch's rows (``lo:hi``) as the example's ``(idx, x)``,
    read from the CSR parts (every row holds ``nnz`` values): the example
    densifies with ``csr.asnumpy()``, a (batch x 1,000,000) host array at
    this width."""
    idx = csr.indices.asnumpy().reshape(-1, nnz)
    x = csr.data.asnumpy().reshape(-1, nnz)
    return idx[lo:hi], x[lo:hi]


def _fm_table_bytes(nf, fs):
    return (nf * fs + nf + 1) * 4


def phase_fm_criteo(smi):
    """fm_criteo_row_sparse: (a) the FM example at its defaults on the
    card (acc > 0.75 after 15 epochs, each epoch's numbers against the
    same flow on the CPU); (b) at Criteo's width from a LibSVM file read
    by ``LibSVMIter``: per batch the ms of the two ``row_sparse_pull``
    and the ``w0`` pull, of the host math and of the pushes (the row
    union and the lazy update), and the unique rows touched; the loop's
    peak memory above the tables; after 100 batches ``w`` and ``v`` bit
    for bit against dense tables on the card given the same pushes by
    ``index_add_``."""
    dev = mx.gpu(0)
    t0 = time.perf_counter()
    card = sparse_fm_example(dev)
    card_s = time.perf_counter() - t0
    cpu = sparse_fm_example(mx.cpu())
    worst = max(abs(a[k] - b[k]) for a, b in zip(card, cpu) for k in a)
    if worst > FM_EXAMPLE_TOL:
        raise AssertionError(f"fm_criteo_row_sparse: the defaults' epochs "
                             f"differ card to CPU by {worst}")
    if not card[-1]["accuracy"] > 0.75:
        raise AssertionError(f"fm_criteo_row_sparse: the defaults learnt "
                             f"{card[-1]['accuracy']}, not above 0.75")
    emit({"phase": "fm_criteo_row_sparse", "part": "defaults",
          "epochs": card, "final_accuracy": card[-1]["accuracy"],
          "card_s": card_s, "card_vs_cpu_max_diff": worst,
          "tolerance": FM_EXAMPLE_TOL})

    c = FM_CRITEO
    nf, fs, nnz, bsz, lr = (c[k] for k in ("features", "factor", "nnz",
                                           "batch", "lr"))
    t0 = time.perf_counter()
    path = criteo_libsvm(c)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = mx.io.LibSVMIter(data_libsvm=str(path), data_shape=(nf,),
                          batch_size=bsz, ctx=dev)
    parse_s = time.perf_counter() - t0
    with dev:
        kv = fm_store(nf, fs, lr)
    w_ref = kv._store["w"]._data.clone()
    v_ref = kv._store["v"]._data.clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    split = {"pull": [], "math": [], "push": []}
    touched, losses, correct, launches = [], [], 0, None
    kernels.reset_launch_counts()
    with dev:
        for b, batch in enumerate(it):
            if b == c["batches"]:
                break
            t0 = time.perf_counter()
            idx, x = _csr_batch(batch.data[0], nnz)
            y = batch.label[0].asnumpy()
            uniq, inv = np.unique(idx, return_inverse=True)
            inv = inv.reshape(idx.shape)
            w_rows, v_rows, w0 = fm_pull(kv, uniq, nf, fs)
            t1 = time.perf_counter()
            loss, ok, gw, gv, g0 = fm_math(x, y, inv, w_rows, v_rows, w0,
                                           len(y))
            t2 = time.perf_counter()
            fm_push(kv, uniq, gw, gv, g0, nf, fs)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for name, (a, z) in (("pull", (t0, t1)), ("math", (t1, t2)),
                                 ("push", (t2, t3))):
                split[name].append((z - a) * 1e3)
            touched.append(len(uniq))
            losses.append(loss)
            correct += ok
            rows = torch.from_numpy(uniq).to(w_ref.device)
            w_ref.index_add_(0, rows, -lr * torch.from_numpy(
                gw[:, None]).to(w_ref.device))
            v_ref.index_add_(0, rows, -lr * torch.from_numpy(gv).to(
                v_ref.device))
    launches = kernels.launch_counts()
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    table = _fm_table_bytes(nf, fs)
    if growth >= nf * fs * 4:
        raise AssertionError(f"fm_criteo_row_sparse: the loop's peak grew "
                             f"{growth} bytes, an (nf x factor) temporary "
                             f"is {nf * fs * 4}")
    same = {k: torch.equal(kv._store[k]._data, ref)
            for k, ref in (("w", w_ref), ("v", v_ref))}
    if not all(same.values()):
        raise AssertionError(f"fm_criteo_row_sparse: the store's tables "
                             f"differ from the index_add_ reference: {same}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("fm_criteo_row_sparse: a loss is not finite")
    batches = len(touched)
    out = {"phase": "fm_criteo_row_sparse", "part": "criteo_width",
           "config": {k: v for k, v in c.items()}, "nvidia_smi": smi,
           "libsvm_write_s": write_s, "libsvm_parse_s": parse_s,
           "batches": batches,
           "ms_per_batch_median": {k: statistics.median(v)
                                   for k, v in split.items()},
           "ms_per_batch_mean": {k: statistics.fmean(v)
                                 for k, v in split.items()},
           "batch_ms_median": statistics.median(
               [sum(t) for t in zip(*split.values())]),
           "unique_rows_touched": {"median": statistics.median(touched),
                                   "min": min(touched), "max": max(touched)},
           "table_bytes": table,
           "loop_peak_growth_bytes": growth,
           "loop_peak_growth_over_table": growth / table,
           "dense_temporary_bytes": nf * fs * 4,
           "tables_bitwise_equal_index_add_reference": True,
           "loss_first_last": [losses[0], losses[-1]],
           "train_accuracy": correct / (batches * bsz),
           "launches": {k: n for k, n in launches.items() if n}}
    emit(out)
    del kv, w_ref, v_ref
    torch.cuda.empty_cache()
    return out


def phase_sparse_linear_mf(smi):
    """sparse_linear_mf: ``linear_classification.py`` and
    ``matrix_factorization.py`` at their defaults on the card, their own
    thresholds (acc > 0.8, RMSE < 1.5), and each epoch's numbers against
    the same flow on the port's CPU within ``FM_EXAMPLE_TOL``."""
    out = {}
    for name, fn, check in (
            ("linear_classification", sparse_linear_example,
             lambda e: e[-1]["accuracy"] > 0.8),
            ("matrix_factorization", sparse_mf_example,
             lambda e: e[-1]["rmse"] < 1.5)):
        t0 = time.perf_counter()
        card = fn(mx.gpu(0))
        card_s = time.perf_counter() - t0
        cpu = fn(mx.cpu())
        worst = max(abs(a[k] - b[k]) for a, b in zip(card, cpu) for k in a)
        if worst > FM_EXAMPLE_TOL or not check(card):
            raise AssertionError(f"sparse_linear_mf {name}: final "
                                 f"{card[-1]}, card to CPU {worst}")
        out[name] = {"epochs": card, "card_s": card_s,
                     "card_vs_cpu_max_diff": worst}
    emit({"phase": "sparse_linear_mf", "tolerance": FM_EXAMPLE_TOL, **out})
    return out


def _sha(tensors):
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    return digest.hexdigest()


def _worker_fm_dist(rank, out_dir):
    """dist_sparse_async (a)'s worker: FM_CRITEO's FM under dist_sync,
    half of every batch, 20 batches; its pushes and final tables saved."""
    c, d = FM_CRITEO, DIST_SPARSE
    nf, fs, nnz, bsz, lr = (c[k] for k in ("features", "factor", "nnz",
                                           "batch", "lr"))
    dev = mx.gpu(0)
    it = mx.io.LibSVMIter(data_libsvm=str(criteo_libsvm(c)),
                          data_shape=(nf,), batch_size=bsz, ctx=dev)
    with dev:
        kv = fm_store(nf, fs, lr, "dist_sync")
    n = kv.num_workers
    lo, hi = rank * bsz // n, (rank + 1) * bsz // n
    pushes, batch_ms, stats = [], [], []
    with dev:
        for b, batch in enumerate(it):
            if b == d["fm_batches"]:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx, x = _csr_batch(batch.data[0], nnz, lo, hi)
            y = batch.label[0].asnumpy()[lo:hi]
            uniq, inv = np.unique(idx, return_inverse=True)
            inv = inv.reshape(idx.shape)
            w_rows, v_rows, w0 = fm_pull(kv, uniq, nf, fs)
            # each worker's terms over the whole batch: the workers' sum
            # is the batch mean
            _, _, gw, gv, g0 = fm_math(x, y, inv, w_rows, v_rows, w0, bsz)
            before = dict(kv.sparse_stats)
            fm_push(kv, uniq, gw, gv, g0, nf, fs)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            stats.append({k: kv.sparse_stats[k] - before[k]
                          for k in before})
            pushes.append((uniq, gw, gv, g0))
    kv.barrier()
    tables = [kv._store[k]._data for k in ("w", "v", "w0")]
    torch.save({"pushes": pushes}, Path(out_dir) / f"fm_rank{rank}.pt")
    return {"rank": rank, "num_workers": n, "rows": hi - lo,
            "batch_ms": batch_ms, "push_stats": stats,
            "tables_sha256": _sha(tables),
            "tables": {k: _sha([kv._store[k]._data]) for k in
                       ("w", "v", "w0")}}


def _checksum(tensors):
    """A device checksum of the tensors' bits: the sum of their int32
    words and the sum weighted by position (mod 65521)."""
    flat = torch.cat([t.detach().reshape(-1).view(torch.int32)
                      for t in tensors]).to(torch.int64)
    pos = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
    return [int(flat.sum()), int((flat * pos).sum())]


def _allreduce_rows_ms(flat, reps):
    """The gather's other form, measured only: an ``all_reduce`` of a
    zero-filled ``(workers, n)`` buffer on the card in which this worker
    fills its row (gloo stages it through the host)."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = torch.zeros((n, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        buf[rank].copy_(flat)
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), buf.numel() * buf.element_size()


def _worker_resnet_async(rank, out_dir):
    """dist_sparse_async (b)'s worker: ``train_imagenet.py --kv-store
    dist_async`` through ``module_fit``: per batch its ms, the push and
    pull host ms, K1's launches and a checksum of the weights; the first
    two batches' gradients (and rank 0's weights before the first update
    and after the second) saved for the parent's recompute; then both
    forms of the gather over the whole model timed: the store's (pinned
    host staging, ``all_gather``) and an all-reduce of a zero-filled
    card buffer."""
    cfg = dict(MODULE_FIT, kv_store="dist_async")
    dev = mx.gpu(0)
    with dev:
        net = get_network(cfg["network"], cfg["num_classes"],
                          cfg["image_shape"])
        train = SyntheticDataIter(cfg["num_classes"],
                                  (cfg["batch"],) + tuple(cfg["image_shape"]),
                                  cfg["epoch_size"])
    model = mx.mod.Module(context=dev, symbol=net)
    names = model._param_names
    saved = {"grads": [], "names": names}
    timing = {"push": [], "pull": []}
    state = {"kv": None}

    def watch(kv):
        push, pull = kv.push, kv.pull

        def timed_push(key, value, priority=0):
            t = len(timing["push"])
            if t < DIST_SPARSE["check_batches"]:
                saved["grads"].append([v._data.detach().cpu().clone()
                                       for v in value])
            if rank == 0 and t in (0, DIST_SPARSE["check_batches"]):
                saved[f"weights_{t}"] = [model._exec.arg_dict[k]._data
                                         .detach().cpu().clone()
                                         for k in key]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            push(key, value, priority)
            torch.cuda.synchronize()
            timing["push"].append((time.perf_counter() - t0) * 1e3)

        def timed_pull(key, out=None, priority=0, ignore_sparse=True):
            t0 = time.perf_counter()
            pull(key, out=out, priority=priority)
            torch.cuda.synchronize()
            timing["pull"].append((time.perf_counter() - t0) * 1e3)

        kv.push, kv.pull = timed_push, timed_pull
        state["kv"] = kv

    create = mx.kv.create

    def creating(name):
        kv = create(name)
        watch(kv)
        return kv

    stamps, k1, sums = [], [], []

    def end(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        k1.append(kernels.launch_counts().get("opt_sgd", 0))
        sums.append(_checksum([model._exec.arg_dict[k]._data
                               for k in names]))

    mx.kv.create = creating
    try:
        kernels.reset_launch_counts()
        t_fit = time.perf_counter()
        module_fit(cfg, model, train, [end])
        fit_s = time.perf_counter() - t_fit
    finally:
        mx.kv.create = create
    kv = state["kv"]
    gathered = dict(kv.gather_stats)   # the fit's, before the timings
    torch.save(saved, Path(out_dir) / f"resnet_rank{rank}.pt")
    per_batch = [b - a for a, b in zip([0] + k1, k1)]
    flat = torch.cat([model._exec.arg_dict[k]._data.detach().reshape(-1)
                      for k in names])
    reps, times = DIST_SPARSE["gather_reps"], []
    import torch.distributed as dist

    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv._gather(flat).result()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    allreduce_ms, allreduce_bytes = _allreduce_rows_ms(flat, reps)
    n = kv.num_workers
    elems = flat.numel()
    return {"rank": rank, "num_workers": n, "fit_s": fit_s,
            "batch_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
            "push_host_ms": timing["push"], "pull_host_ms": timing["pull"],
            "k1_launches_per_batch": per_batch,
            "checksums": sums, "params": len(names), "elements": elems,
            "rescale_grad": model._optimizer.rescale_grad,
            "gather_stats": gathered,
            "pipeline_buckets": len(kv._pipeline.plan.buckets)
            if kv._pipeline else 0,
            "gather": {
                "pinned_allgather": {
                    "ms": statistics.median(times),
                    "buffer_bytes": n * elems * 4,
                    "ring_bytes_sent_per_worker": (n - 1) * elems * 4},
                "allreduce_of_rows": {
                    "ms": allreduce_ms, "buffer_bytes": allreduce_bytes,
                    "ring_bytes_sent_per_worker":
                        2 * (n - 1) * elems * 4}},
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "weights_sha256": _sha([model._exec.arg_dict[k]._data
                                    for k in names])}


WORKERS.update({"fm_dist": _worker_fm_dist,
                "resnet_async": _worker_resnet_async})


def _fm_dist_check(out_dir, workers):
    """One process's FM under the summed pushes: the tables of
    ``fm_store`` given each batch's workers' rows summed by row union in
    rank order (``sparse_add``) and applied by ``index_add_``, ``w0`` by
    the optimizer's dense update; the digests against both workers'."""
    c = FM_CRITEO
    nf, fs, lr = c["features"], c["factor"], c["lr"]
    recs = [torch.load(Path(out_dir) / f"fm_rank{r}.pt", weights_only=False)
            for r in range(len(workers))]
    dev = mx.gpu(0)
    with dev:
        kv = fm_store(nf, fs, lr)
        w, v, w0 = (kv._store[k] for k in ("w", "v", "w0"))
        opt = mx.optimizer.create("sgd", learning_rate=lr)
        for step in zip(*[r["pushes"] for r in recs]):
            for key, table, col in (("w", w, 1), ("v", v, 2)):
                agg = None
                for uniq, gw, gv, _ in step:
                    vals = gw[:, None] if col == 1 else gv
                    part = mx.nd.sparse.row_sparse_array(
                        (vals, uniq.astype(np.int64)), shape=table.shape)
                    agg = part if agg is None else \
                        mx.nd.sparse.sparse_add(agg, part)
                with torch.no_grad():
                    table._data.index_add_(0, agg.indices._data,
                                           -lr * agg.data._data)
            g0 = sum(torch.from_numpy(s[3]) for s in step)
            opt.update(0, w0, mx.nd.array(g0.numpy()), None)
    want = _sha([w._data, v._data, w0._data])
    got = [r["tables_sha256"] for r in workers]
    if any(g != want for g in got):
        raise AssertionError(f"dist_sparse_async fm: tables {got} against "
                             f"one process's {want} (by table: "
                             f"{[r['tables'] for r in workers]} against "
                             f"{[_sha([t._data]) for t in (w, v, w0)]})")
    return want


def _resnet_async_check(out_dir, workers):
    """Rank 0's weights after two batches against one process that
    applies rank 0's and then rank 1's gradients of each batch with K1
    (the Module's optimizer: "sgd" with its schedule, wd by name,
    ``rescale_grad`` 1 / batch)."""
    cfg = MODULE_FIT
    recs = [torch.load(Path(out_dir) / f"resnet_rank{r}.pt",
                       weights_only=False) for r in range(len(workers))]
    names = recs[0]["names"]
    dev = mx.gpu(0).torch_device()
    lr, sched = _lr_scheduler(cfg)
    opt = mx.optimizer.create(
        "sgd", param_idx2name=dict(enumerate(names)),
        rescale_grad=1.0 / cfg["batch"], learning_rate=lr, wd=cfg["wd"],
        momentum=cfg["mom"], lr_scheduler=sched)
    weights = [mx.nd.NDArray(t.to(dev)) for t in recs[0]["weights_0"]]
    states = [opt.create_state(i, w) for i, w in enumerate(weights)]
    before = kernels.launch_counts().get("opt_sgd", 0)
    for t in range(DIST_SPARSE["check_batches"]):
        for r in recs:
            opt.fused_update_multi(list(range(len(names))), weights,
                                   [mx.nd.NDArray(g.to(dev))
                                    for g in r["grads"][t]], states)
    torch.cuda.synchronize()
    launched = kernels.launch_counts().get("opt_sgd", 0) - before
    want = recs[0][f"weights_{DIST_SPARSE['check_batches']}"]
    bad = [n for n, a, b in zip(names, weights, want)
           if not torch.equal(a._data.cpu(), b)]
    if bad:
        raise AssertionError(f"dist_sparse_async resnet: after 2 batches "
                             f"{len(bad)} tensors differ from rank 0's then "
                             f"rank 1's K1 updates: {bad[:5]}")
    return launched


def phase_dist_sparse_async(smi):
    """dist_sparse_async: two workers on the card over gloo. (a)
    FM_CRITEO's FM under dist_sync, each worker half of every batch, 20
    batches: the row-sparse pushes' rows and bytes, and both workers'
    tables bit for bit against one process given the summed pushes. (b)
    ``train_imagenet.py --kv-store dist_async --network resnet50_v1
    --benchmark 1`` at batch 128 a worker, 13 batches: batch ms, push and
    pull ms, both forms of the gather, K1 two launches a batch on each
    worker, the weights' checksums equal on both workers after every
    batch and their digests at the end, and after 2 batches rank 0's
    weights equal to one process's K1 updates with rank 0's then rank
    1's gradients."""
    d = DIST_SPARSE
    criteo_libsvm(FM_CRITEO)   # written once, before the workers read it
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as out_dir:
        t0 = time.perf_counter()
        fm = run_workers("fm_dist", out_dir, d["workers"], d["timeout_s"])
        fm_s = time.perf_counter() - t0
        digest = _fm_dist_check(out_dir, fm)
        stats = [s for r in fm for s in r["push_stats"]]
        out["fm_dist_sync"] = {
            "workers_s": fm_s, "batches": len(fm[0]["batch_ms"]),
            "rows_per_worker": [r["rows"] for r in fm],
            "batch_ms_median": [statistics.median(r["batch_ms"])
                                for r in fm],
            "row_sparse_pushes_per_batch": fm[0]["push_stats"][0]["pushes"],
            "gathered_rows_per_batch_median": statistics.median(
                s["rows"] for s in stats),
            "gathered_bytes_per_batch_median": statistics.median(
                s["bytes"] for s in stats),
            "dense_bytes_per_batch_if_sent_densely": d["workers"] * (
                _fm_table_bytes(FM_CRITEO["features"],
                                FM_CRITEO["factor"]) - 4),
            "tables_sha256": digest,
            "tables_bitwise_equal_one_process": True}
        emit({"phase": "dist_sparse_async", "part": "fm_dist_sync",
              **out["fm_dist_sync"]})
        t0 = time.perf_counter()
        rn = run_workers("resnet_async", out_dir, d["workers"],
                         d["timeout_s"])
        rn_s = time.perf_counter() - t0
        launched = _resnet_async_check(out_dir, rn)
    if rn[0]["checksums"] != rn[1]["checksums"] or \
            rn[0]["weights_sha256"] != rn[1]["weights_sha256"]:
        raise AssertionError("dist_sparse_async resnet: the workers' "
                             "weights differ")
    for r in rn:
        if r["k1_launches_per_batch"] != [2] * MODULE_FIT["epoch_size"]:
            raise AssertionError(f"dist_sparse_async resnet: K1 launches a "
                                 f"batch {r['k1_launches_per_batch']} on "
                                 f"worker {r['rank']}")
        if r["rescale_grad"] != 1.0 / MODULE_FIT["batch"]:
            raise AssertionError("dist_sparse_async resnet: rescale_grad "
                                 f"{r['rescale_grad']}")
    warm = MODULE_FIT["warmup"]
    out["resnet50_v1_dist_async"] = {
        "workers_s": rn_s, "nvidia_smi": smi,
        "batch_ms_median": [statistics.median(r["batch_ms"][warm - 1:])
                            for r in rn],
        "push_host_ms_median": [statistics.median(r["push_host_ms"][warm:])
                                for r in rn],
        "pull_host_ms_median": [statistics.median(r["pull_host_ms"][warm:])
                                for r in rn],
        "img_per_s_per_worker": [MODULE_FIT["batch"] / (statistics.median(
            r["batch_ms"][warm - 1:]) / 1e3) for r in rn],
        "k1_launches_per_batch": rn[0]["k1_launches_per_batch"],
        "k1_launches": sum(rn[0]["k1_launches_per_batch"]),
        "gather_bytes_per_batch": rn[0]["gather_stats"]["bytes"] /
        MODULE_FIT["epoch_size"],
        "gathers_per_batch": rn[0]["gather_stats"]["gathers"] /
        MODULE_FIT["epoch_size"],
        "buckets": rn[0]["pipeline_buckets"],
        "gather_forms": [r["gather"] for r in rn],
        "elements": rn[0]["elements"], "tensors": rn[0]["params"],
        "max_memory_allocated": [r["max_memory_allocated"] for r in rn],
        "weights_checksums_equal_every_batch": True,
        "weights_sha256": rn[0]["weights_sha256"],
        "two_batches_equal_rank_order_k1": True,
        "check_k1_launches": launched}
    emit({"phase": "dist_sparse_async", "part": "resnet50_v1_dist_async",
          **out["resnet50_v1_dist_async"]})
    return out


# ------------------------------------------------------------------------
# The twenty-fifth slice: the int8 convolution on K4, AMP.

QUANTIZE_MNIST = {"num_examples": 2048, "num_val_examples": 512,
                  "batch": 64, "epochs": 3, "lr": 0.1, "calib_batches": 5,
                  "calib_mode": "entropy", "buckets": (2, 4, 8),
                  "requests": 32, "max_gap": 0.05}
# examples/quantization/quantize_mnist.py's network: conv1, fc1 and fc2
MNIST_INT8_PRODUCTS = 3


def mnist_sym(m):
    """``examples/quantization/quantize_mnist.py:build_sym`` (:32-42),
    verbatim, over package ``m``."""
    data = m.sym.var("data")
    net = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="conv1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return m.sym.SoftmaxOutput(net, m.sym.var("softmax_label"),
                               name="softmax")


def mnist_synthetic(num, sample_seed):
    """``examples/image_classification/common/data.py:_synthetic``
    (:29-42) at MNIST's shape, as ``get_mnist_iter`` (:105-123) draws it
    when no idx files are given: class centers from seed 1, training
    samples from seed 42, validation from 43."""
    centers = 0.3 * np.random.RandomState(1).randn(10, 1, 28, 28).astype(
        np.float32)
    rng = np.random.RandomState(sample_seed)
    y = rng.randint(0, 10, num).astype(np.float32)
    x = centers[y.astype(np.int32)] + \
        0.15 * rng.randn(num, 1, 28, 28).astype(np.float32)
    return x, y


def _counts():
    return {k: v for k, v in kernels.launch_counts().items() if v}


def phase_quantize_mnist(smi):
    """quantize_mnist: ``examples/quantization/quantize_mnist.py:45-139``
    at its defaults, copied (the example imports the JAX package): the
    example's synthetic MNIST (2048 / 512 examples, batch 64),
    ``Module.fit`` for 3 epochs at lr 0.1, ``quantize_model(calib_mode=
    "entropy")`` over 5 calibration batches, the int8 ``Module.score``
    (the gap to float32 under 5%), and the int8 graph's ``fc2_output``
    served by ``ModelContainer.add_symbol`` + ``ModelServer`` on buckets
    (2, 4, 8) with the example's 32 requests. Every served answer must
    equal the same graph and parameters on the CPU bit for bit: each op
    on that route is exact (the int8 products, relu, max pooling,
    flatten) or correctly rounded in the same order (quantize, the
    epilogue). K4 launches 3 times an int8 batch (conv1 through the int8
    im2col, fc1, fc2)."""
    from mxnet_tpu_torch.contrib import quantization

    cfg = QUANTIZE_MNIST
    t_phase = time.perf_counter()
    dev = mx.gpu(0)
    mx.random.seed(0)
    x, y = mnist_synthetic(cfg["num_examples"], 42)
    xv, yv = mnist_synthetic(cfg["num_val_examples"], 43)
    batch = cfg["batch"]
    with dev:
        train = mx.io.NDArrayIter(x, y, batch, shuffle=True)
        val = mx.io.NDArrayIter(xv, yv, batch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        mod = mx.mod.Module(mnist_sym(mx), context=dev)
        mod.fit(train, num_epoch=cfg["epochs"],
                initializer=mx.init.Xavier(),
                optimizer_params=(("learning_rate", cfg["lr"]),
                                  ("rescale_grad", 1.0 / batch)))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = _counts()
        fp32_acc = dict(mod.score(val, "acc"))["accuracy"]
        arg_params, aux_params = mod.get_params()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        qsym, qarg, qaux = quantization.quantize_model(
            mnist_sym(mx), arg_params, aux_params, calib_data=train,
            num_calib_examples=cfg["calib_batches"] * batch,
            calib_mode=cfg["calib_mode"])
        quantize_s = time.perf_counter() - t0
        calib = quantization.last_calibration()
        census = quantization.last_quantization()["ops"]
        qmod = mx.mod.Module(qsym, context=dev)
        qmod.bind(val.provide_data, val.provide_label, for_training=False)
        qmod.init_params(arg_params=qarg, aux_params=qaux,
                         allow_missing=False)
        kernels.reset_launch_counts()
        int8_acc = dict(qmod.score(val, "acc"))["accuracy"]
        torch.cuda.synchronize()
        score_launches = _counts()
    val_batches = cfg["num_val_examples"] // batch
    if census != {"_contrib_quantized_conv": 1,
                  "_contrib_quantized_fully_connected": 2}:
        raise AssertionError(f"quantize_mnist: census {census}")
    if score_launches.get("int8_gemm") != MNIST_INT8_PRODUCTS * val_batches:
        raise AssertionError(f"quantize_mnist: int8 score launched "
                             f"{score_launches}, expected K4 "
                             f"{MNIST_INT8_PRODUCTS} x {val_batches}")
    if not fp32_acc - int8_acc < cfg["max_gap"]:
        raise AssertionError(f"quantize_mnist: int8 accuracy {int8_acc} "
                             f"against float32 {fp32_acc}: gap over "
                             f"{cfg['max_gap']}")
    served = _serve_mnist_int8(cfg, qsym, qarg, qaux)
    out = {"phase": "quantize_mnist", "card": smi,
           "source": "examples/quantization/quantize_mnist.py:45-139 at "
                     "its defaults; data: common/data.py:105-123's "
                     "synthetic MNIST (no idx files in the repository)",
           "config": cfg, "fit_s": fit_s, "quantize_s": quantize_s,
           "fp32_accuracy": fp32_acc, "int8_accuracy": int8_acc,
           "gap": fp32_acc - int8_acc, "census": census,
           "calibration": {"mode": calib["mode"], "bins": calib["num_bins"],
                           "examples": calib["examples"],
                           "thresholds": {n: t["threshold"] for n, t in
                                          calib["tensors"].items()},
                           "seen": {n: [t["min_seen"], t["max_seen"]]
                                    for n, t in calib["tensors"].items()}},
           "fit_launches": fit_launches,
           "score_launches": score_launches,
           "k4_launches_per_int8_batch": MNIST_INT8_PRODUCTS, **served,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def _serve_mnist_int8(cfg, qsym, qarg, qaux):
    """The example's ``serve_int8_demo`` (:102-139): ``fc2_output`` of the
    int8 graph served on buckets (2, 4, 8) and the example's 32 requests
    (rows 1-8 from ``RandomState(0)``), each answer held bit for bit
    against the same graph and parameters evaluated on the CPU."""
    example_shape = (1, 28, 28)
    serve_sym = qsym.get_internals()["fc2_output"]
    container = serving.ModelContainer()
    container.add_symbol("mnist_int8", serve_sym, dict(qarg), dict(qaux),
                         example_shape=example_shape, buckets=cfg["buckets"],
                         ctx=mx.gpu(0))
    server = serving.ModelServer(container, max_wait_ms=1.0).start()
    cpu_args = {k: v.as_in_context(mx.cpu()) for k, v in qarg.items()}
    answers = []
    try:
        server.warmup()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rng = np.random.RandomState(0)
        t0 = time.perf_counter()
        for _ in range(cfg["requests"]):
            rows = int(rng.randint(1, 9))
            xr = rng.rand(rows, *example_shape).astype(np.float32)
            got = server.predict("mnist_int8", xr, timeout=30.0)
            if got.shape[0] != rows:
                raise AssertionError(f"quantize_mnist: {rows} rows in, "
                                     f"{got.shape} out")
            answers.append((xr, got))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _counts()
        stats = server.stats()["models"]["mnist_int8"]
    finally:
        if not server.drain(timeout=30.0):
            raise AssertionError("quantize_mnist: the server did not drain")
    equal = 0
    for xr, got in answers:
        want = serve_sym.eval_with({"data": mx.nd.array(xr, ctx=mx.cpu()),
                                    **cpu_args}).asnumpy()
        equal += int(np.array_equal(got, want))
        if not np.array_equal(got, want):
            raise AssertionError(
                f"quantize_mnist: a served answer of {xr.shape[0]} rows "
                f"differs from the CPU's by up to {np.abs(got - want).max()}")
    batches = sum(stats["bucket_census"].values())
    if launches.get("int8_gemm") != MNIST_INT8_PRODUCTS * batches:
        raise AssertionError(f"quantize_mnist: served {batches} batches, "
                             f"launches {launches}")
    return {"served": {"requests": len(answers), "batches": batches,
                       "equal_to_cpu": equal, "wall_s": wall,
                       "weight_dtype": stats.get("weight_dtype"),
                       "bucket_census": stats["bucket_census"],
                       "p50_ms": stats.get("p50_ms"),
                       "p99_ms": stats.get("p99_ms"),
                       "launches": launches}}


RESNET50_INT8 = {"network": "resnet50_v1", "classes": 1000,
                 "image_shape": (3, 224, 224), "batch": 32,
                 "calib_batches": 2, "calib_mode": "entropy",
                 "granularity": "channel-wise", "timed": 20, "warmup": 3,
                 "cpu_batch": 2, "convs": 53, "fcs": 1, "profiled": 5}
# card against CPU, int8 logits (ROADMAP Caveats: 15%): relative L2
RESNET50_INT8_CPU_L2 = 0.15


def _int8_products(qsym, shapes):
    """``[(node, M, K, N, groups)]`` of every K4 product of one forward
    of the int8 graph at the input ``shapes``."""
    from mxnet_tpu_torch.symbol.symbol import _topo

    known = qsym._infer({k: tuple(v) for k, v in shapes.items()})
    out = []
    for node in _topo(qsym._entries):
        if node.op == "_contrib_quantized_conv":
            c, oi = node.inputs[0]
            n, ch = known[id(c), oi][:2]
            o = known[id(node), 0]
            g = node.attrs.get("num_group", 1)
            k = (ch // g) * math.prod(node.attrs["kernel"])
            out.append((node.name, n * math.prod(o[2:]), k,
                        node.attrs["num_filter"] // g, g))
        elif node.op == "_contrib_quantized_fully_connected":
            c, oi = node.inputs[0]
            s = known[id(c), oi]
            out.append((node.name, s[0], math.prod(s[1:]),
                        node.attrs["num_hidden"], 1))
    return out


def _int_mm_padded(qx, w, scale, bias):
    """``_int_mm_epilogue`` with K zero-padded to a multiple of 8 as
    ``torch._int_mm`` needs (ResNet-50's stem has K = 147): the zeros add
    nothing to the product."""
    k = qx.shape[1]
    if k % 8:
        qx = torch.nn.functional.pad(qx, (0, -k % 8))
        w = torch.nn.functional.pad(w, (0, -k % 8))
    return qx, w, scale, bias


def _resnet_int8_products_timing(products, dev):
    """K4 and ``torch._int_mm`` + epilogue over the forward's products at
    their shapes, one call each, with random operands: each product held
    bit for bit against K4's plain version and against ``torch._int_mm``
    + epilogue (both exact int32 sums under the same float32 epilogue),
    then device ms by the profiler and ms by CUDA events, and the summed
    bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ops = []
    for _, m, k, n, g in products:
        for _ in range(g):
            ops.append(_int8_inputs(m, k, n, gen, dev))
    padded = [_int_mm_padded(*o) for o in ops]
    shapes = [(m, k, n) for _, m, k, n, g in products for _ in range(g)]
    for (m, k, n), (qx, w, s, b), o in zip(shapes, ops, padded):
        got = int8_gemm.int8_gemm(qx, w, s, bias=b)
        for what, want in (("plain", int8_gemm.int8_gemm_plain(
                qx, w, s, bias=b)), ("torch._int_mm", _int_mm_epilogue(*o))):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"resnet50_v1_int8: K4 differs from {what} at M={m} "
                    f"K={k} N={n}, max |diff| "
                    f"{(got - want).abs().max().item()}")
        del got, want

    def run_k4():
        for qx, w, s, b in ops:
            int8_gemm.int8_gemm(qx, w, s, bias=b)

    def run_lib():
        for o in padded:
            _int_mm_epilogue(*o)

    bounds = [int8_bound(m, k, n) for _, m, k, n, g in products
              for _ in range(g)]
    return {"ms": cuda_ms(run_k4, iters=5), "device_ms": device_ms(
                run_k4, iters=5),
            "library_ms": cuda_ms(run_lib, iters=5),
            "library_device_ms": sum(kernel_device_us(
                run_lib, iters=5).values()) / 1e3,
            "bound_ms": sum(b[0] for b in bounds),
            "bound_by": {"bytes": sum(b[1] == "bytes" for b in bounds),
                         "operations": sum(b[1] == "operations"
                                           for b in bounds)},
            "products": len(ops), "equal_to_plain_and_int_mm": len(ops)}


def _resnet_int8_passes_timing(qsym, shapes, dev):
    """Device ms of the activation's quantize and of the int8 im2col
    before each of the forward's convolutions, at their input shapes
    (channels-last activations, as the int8 graph hands them over; the
    stem's input as fed)."""
    from mxnet_tpu_torch.ops import quantization as q
    from mxnet_tpu_torch.ops.nn import _tuplize
    from mxnet_tpu_torch.symbol.symbol import _topo

    known = qsym._infer({k: tuple(v) for k, v in shapes.items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    convs = []
    for node in _topo(qsym._entries):
        if node.op != "_contrib_quantized_conv":
            continue
        c, oi = node.inputs[0]
        x = torch.randn(known[id(c), oi], generator=gen, device=dev)
        if not c.is_var:
            x = x.to(memory_format=torch.channels_last)
        a = node.attrs
        n = len(a["kernel"])
        convs.append((x, tuple(a["kernel"]),
                      _tuplize(a.get("stride") or 1, n),
                      _tuplize(a.get("dilate") or 1, n),
                      _tuplize(a.get("pad") or 0, n)))
    s = torch.full((), 0.05, device=dev)
    codes = [q._quantize(x, s) for x, *_ in convs]

    def run_quantize():
        for x, *_ in convs:
            q._quantize(x, s)

    def run_im2col():
        for qx, (_, kernel, stride, dilate, pad) in zip(codes, convs):
            q._im2col(qx, kernel, stride, dilate, pad)

    return {"quantize_device_ms": device_ms(run_quantize, iters=5),
            "im2col_device_ms": device_ms(run_im2col, iters=5),
            "convolutions": len(convs)}


@contextlib.contextmanager
def _conv_output_nchw():
    """The int8 convolution's output copied to contiguous NCHW in place
    of the channels-last view the op returns, for modules bound and run
    inside the block (a comparison of layouts, never the port's path)."""
    from mxnet_tpu_torch.ops import registry

    name = "_contrib_quantized_conv"
    view = registry._REGISTRY[name]

    @functools.wraps(view)
    def copied(*args, **kwargs):
        return view(*args, **kwargs).contiguous()

    registry._REGISTRY[name] = copied
    try:
        yield
    finally:
        registry._REGISTRY[name] = view


def _timed_forwards(forward, m, cfg, captured):
    """``cfg["warmup"]`` then ``cfg["timed"]`` forwards of module ``m``,
    captured or eager: their ms, the peak bytes and the launch counts of
    the timed ones."""
    prev = compile_service.set_enabled(captured)
    try:
        for _ in range(cfg["warmup"]):
            forward(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        ms = []
        for _ in range(cfg["timed"]):
            t0 = time.perf_counter()
            forward(m)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, torch.cuda.max_memory_allocated(), _counts()
    finally:
        compile_service.set_enabled(prev)


def _resnet_int8_layout_timing(forward, qmod, qsym, qargs, qauxs, shape,
                               dev, cfg):
    """The captured int8 forward with the convolution's output as the
    op's channels-last view against a contiguous NCHW copy of it, blocks
    view, copy, copy, view; and the two forwards' largest difference."""
    with _conv_output_nchw():
        nchw = _bind_inference(qsym, qargs, qauxs, shape, dev)
    blocks = []
    for layout in ("view", "copy", "copy", "view"):
        with _conv_output_nchw() if layout == "copy" else \
                contextlib.nullcontext():
            ms = _timed_forwards(forward, nchw if layout == "copy" else
                                 qmod, cfg, captured=True)[0]
        blocks.append([layout, statistics.median(ms), ms])
    prev = compile_service.set_enabled(True)
    try:
        a = forward(qmod).asnumpy()
        with _conv_output_nchw():
            b = forward(nchw).asnumpy()
    finally:
        compile_service.set_enabled(prev)
    med = {k: statistics.median([x for b_ in blocks if b_[0] == k
                                 for x in b_[2]]) for k in ("view", "copy")}
    return {"median_ms": med, "copy_over_view": med["copy"] / med["view"],
            "block_medians_ms": [b_[:2] for b_ in blocks],
            "max_abs_diff": float(np.abs(a - b).max())}


def _bind_inference(sym, args, auxs, data_shape, dev):
    m = mx.mod.Module(sym, context=dev)
    m.bind(data_shapes=[("data", data_shape)],
           label_shapes=[("softmax_label", data_shape[:1])],
           for_training=False)
    m.init_params(arg_params=args, aux_params=auxs, allow_missing=False)
    return m


def phase_resnet50_int8(smi):
    """resnet50_v1_int8: MXNet 1.x's ``example/quantization/
    imagenet_gen_qsym.py`` then ``imagenet_inference.py --benchmark``
    over the port's resnet50_v1 at full width (224 x 224, 1000 classes):
    the zoo's network initialised from a seed and exported,
    ``quantize_model(calib_mode="entropy", quantize_granularity=
    "channel-wise")`` over 2 synthetic batches of 32 (the cut: no
    ImageNet), and an int8 ``Module`` bound for inference at batch 32.
    Its forward timed captured and eager beside the float32 forward,
    blocks in the order int8 captured, int8 eager, float32 captured,
    float32 captured, int8 eager, int8 captured (median of 20 each after
    3 warm-ups); K4's 54 launches a forward split by path, its device
    time against the summed bound and ``torch._int_mm`` at the same
    products (each product held bit for bit against K4's plain version
    and ``torch._int_mm``), the quantize and im2col passes; a replay
    with no host sync, and a replayed batch-32 forward equal to eager
    bit for bit; the captured forward with the convolution's output as
    a channels-last view against an NCHW copy; the int8 logits on the
    card held against the same graph on the CPU at batch 2; int8 against
    float32 reported, not held (the weights are random)."""
    from mxnet_tpu_torch.contrib import quantization

    cfg = RESNET50_INT8
    t_phase = time.perf_counter()
    dev = mx.gpu(0)
    shape = (cfg["batch"],) + tuple(cfg["image_shape"])
    mx.random.seed(0)
    with dev:
        net = vision.get_model(cfg["network"], classes=cfg["classes"])
        net.initialize(mx.init.Xavier(),
                       generator=torch.Generator().manual_seed(0))
        net(mx.nd.zeros((1,) + tuple(cfg["image_shape"])))
        with tempfile.TemporaryDirectory() as d:
            net.export(os.path.join(d, "net"), 0)
            body, args, auxs = mx.model.load_checkpoint(
                os.path.join(d, "net"), 0)
        del net
        sym = mx.sym.SoftmaxOutput(body, mx.sym.var("softmax_label"),
                                   name="softmax")
        rs = np.random.RandomState(0)
        n_cal = cfg["batch"] * cfg["calib_batches"]
        calib = mx.io.NDArrayIter(
            rs.uniform(-1, 1, (n_cal,) + shape[1:]).astype(np.float32),
            rs.randint(0, cfg["classes"], n_cal).astype(np.float32),
            cfg["batch"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qsym, qargs, qauxs = quantization.quantize_model(
            sym, args, auxs, calib_data=calib, num_calib_examples=n_cal,
            calib_mode=cfg["calib_mode"],
            quantize_granularity=cfg["granularity"])
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        census = quantization.last_quantization()["ops"]
        thresholds = [t["threshold"] for t in
                      quantization.last_calibration()["tensors"].values()]
        gc.collect()
        torch.cuda.empty_cache()
        x = mx.nd.array(rs.uniform(-1, 1, shape).astype(np.float32))
        yl = mx.nd.array(rs.randint(0, cfg["classes"], shape[0]).astype(
            np.float32))
        batch = mx.io.DataBatch(data=[x], label=[yl])
        qmod = _bind_inference(qsym, qargs, qauxs, shape, dev)
        fmod = _bind_inference(sym, args, auxs, shape, dev)
    want = {"_contrib_quantized_conv": cfg["convs"],
            "_contrib_quantized_fully_connected": cfg["fcs"]}
    if census != want:
        raise AssertionError(f"resnet50_v1_int8: census {census}, "
                             f"expected {want}")
    products = _int8_products(qsym, {"data": shape})
    per_forward = cfg["convs"] + cfg["fcs"]
    staged = sum(1 for _, _, k, _, _ in products if k % 16)

    def forward(m):
        m.forward(batch, is_train=False)
        return m.get_outputs()[0]

    blocks = []
    for model, mode in (("int8", "captured"), ("int8", "eager"),
                        ("float32", "captured"), ("float32", "captured"),
                        ("int8", "eager"), ("int8", "captured")):
        m = qmod if model == "int8" else fmod
        ms, peak, launches = _timed_forwards(forward, m, cfg,
                                             mode == "captured")
        blocks.append({"model": model, "mode": mode, "ms": ms,
                       "peak_bytes": peak, "launches": launches})
        if model == "int8":
            want = {"int8_gemm": per_forward * cfg["timed"],
                    "int8_gemm.staged": staged * cfg["timed"],
                    "int8_gemm.async": (per_forward - staged) * cfg["timed"]}
            if {k: launches.get(k, 0) for k in want} != want:
                raise AssertionError(f"resnet50_v1_int8 {mode}: launches "
                                     f"{launches}, expected {want}")
    med = {}
    for b in blocks:
        med.setdefault(f"{b['model']}_{b['mode']}", []).extend(b["ms"])
    med = {k: statistics.median(v) for k, v in med.items()}
    counted = next(b["launches"] for b in blocks
                   if b["model"] == "int8" and b["mode"] == "captured")
    counted = {k: counted.get(k, 0) for k in
               ("int8_gemm", "int8_gemm.staged", "int8_gemm.async")}
    syncs = _sync_count(lambda: [forward(qmod) for _ in range(2)])
    if syncs:
        raise AssertionError(f"resnet50_v1_int8: a replay synchronised "
                             f"with the host at {syncs}")
    # one batch-32 forward replayed against the same forward eager
    outs = {}
    for mode in ("captured", "eager"):
        prev = compile_service.set_enabled(mode == "captured")
        try:
            outs[mode] = forward(qmod).asnumpy()
        finally:
            compile_service.set_enabled(prev)
    if not np.array_equal(outs["captured"], outs["eager"]):
        raise AssertionError(
            f"resnet50_v1_int8: the replayed forward differs from eager, "
            f"max |diff| {np.abs(outs['captured'] - outs['eager']).max()}")
    layout = _resnet_int8_layout_timing(forward, qmod, qsym, qargs, qauxs,
                                        shape, dev, cfg)
    k4_us = {k: v for k, v in kernel_device_us(
        lambda: forward(qmod), iters=cfg["profiled"], warmup=1).items()
             if "int8_gemm_kernel" in k}
    card = dev.torch_device()
    products_timing = _resnet_int8_products_timing(products, card)
    passes = _resnet_int8_passes_timing(qsym, {"data": shape}, card)
    agreement = _resnet_int8_agreement(cfg, sym, args, auxs, qsym, qargs,
                                       qauxs, x)
    out = {"phase": "resnet50_v1_int8", "card": smi,
           "source": "MXNet 1.x example/quantization/imagenet_gen_qsym.py "
                     "(entropy, channel-wise) + imagenet_inference.py "
                     "--benchmark on the zoo's resnet50_v1; cut: 2 synthetic "
                     "calibration batches, random weights from a seed",
           "config": cfg, "quantize_s": quantize_s, "census": census,
           "calibration_thresholds": {"count": len(thresholds),
                                      "min": min(thresholds),
                                      "max": max(thresholds)},
           "median_ms": med,
           "img_s": {k: cfg["batch"] / v * 1e3 for k, v in med.items()},
           "int8_over_float32_captured": med["int8_captured"] /
           med["float32_captured"],
           "peak_bytes": {f"{b['model']}_{b['mode']}": b["peak_bytes"]
                          for b in blocks},
           "block_medians_ms": [[b["model"], b["mode"],
                                 statistics.median(b["ms"])]
                                for b in blocks],
           "k4_launches_counted": {"forwards": cfg["timed"], **counted},
           "k4_launches_per_forward": counted["int8_gemm"] / cfg["timed"],
           "k4_launches_by_path_per_forward": {
               "staged": counted["int8_gemm.staged"] / cfg["timed"],
               "async": counted["int8_gemm.async"] / cfg["timed"]},
           "replay_equals_eager_batch": cfg["batch"],
           "conv_output_layout": layout,
           "k4_device_ms_per_forward": sum(k4_us.values()) / 1e3,
           "k4_products": products_timing, "passes": passes,
           "host_syncs_in_replay": syncs, **agreement,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del qmod, fmod
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _head_name(qsym):
    """The output name of the int8 graph's last fully connected node (the
    logits before SoftmaxOutput)."""
    from mxnet_tpu_torch.symbol.symbol import _topo

    fcs = [n for n in _topo(qsym._entries)
           if n.op == "_contrib_quantized_fully_connected"]
    return f"{fcs[-1].name}_output"


def _resnet_int8_agreement(cfg, sym, args, auxs, qsym, qargs, qauxs, x):
    """The int8 logits on the card against the same int8 graph on the CPU
    at batch ``cpu_batch`` (held to ``RESNET50_INT8_CPU_L2``), and the
    int8 logits against the float32 graph's on the card at the full batch
    (reported)."""
    head = _head_name(qsym)
    qhead = qsym.get_internals()[head]
    fhead = sym.get_internals()[head]
    n = cfg["cpu_batch"]
    feed = {"data": x[:n], **qargs, **qauxs}
    with torch.no_grad():
        card = qhead.eval_with(feed).asnumpy()
        cpu = qhead.eval_with({k: v.as_in_context(mx.cpu())
                               for k, v in feed.items()}).asnumpy()
        q_full = qhead.eval_with({"data": x, **qargs, **qauxs}).asnumpy()
        f_full = fhead.eval_with({"data": x, **args, **auxs}).asnumpy()
    rel = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
    if not rel <= RESNET50_INT8_CPU_L2 or not np.isfinite(card).all():
        raise AssertionError(f"resnet50_v1_int8: card logits {rel} of the "
                             f"CPU's L2 away (bound {RESNET50_INT8_CPU_L2})")
    return {"card_vs_cpu": {"rel_l2": rel, "bound": RESNET50_INT8_CPU_L2,
                            "equal_rows": int((card == cpu).all(1).sum()),
                            "rows": n,
                            "max_abs": float(np.abs(card - cpu).max())},
            "int8_vs_float32": {
                "rel_l2": float(np.linalg.norm(q_full - f_full) /
                                np.linalg.norm(f_full)),
                "top1_agreement": float((q_full.argmax(1) ==
                                         f_full.argmax(1)).mean())}}


AMP_FINETUNE = {"batch": 32, "warmup": 3, "steps": 20, "block": 10,
                "lr": 1e-4, "wd": 1e-4, "profiled": 3}


class _DtypeCensus(TorchDispatchMode):
    """The input dtypes of the watched aten ops a step runs."""

    WATCH = {"mm": "gemm", "addmm": "gemm", "bmm": "gemm",
             "native_layer_norm": "layer_norm",
             "native_layer_norm_backward": "layer_norm",
             "_log_softmax": "log_softmax",
             "_log_softmax_backward_data": "log_softmax"}

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        group = self.WATCH.get(func.overloadpacket.__name__)
        if group is not None:
            for a in args:
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    key = f"{group}:{str(a.dtype).replace('torch.', '')}"
                    self.seen[key] = self.seen.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _amp_attention_timing(dev):
    """K3 and K3-bwd in bfloat16 at the training shape (32, 12, 128, 128,
    64), by CUDA events and the profiler, against their bounds at the
    bfloat16 tensor-core peak and bfloat16 SDPA forward and backward."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    shape = (32, 12, 128, 128, 64)
    q, k, v = flash_inputs(shape, torch.bfloat16, "dense", gen, dev)
    do = flash_inputs(shape, torch.bfloat16, "dense", gen, dev)[0]
    scale = 0.125
    o, lse = flash.flash_forward(q, k, v, scale, False, with_lse=True)
    dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale)[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, scale=scale)
    runs = {"fwd": lambda: flash.flash_forward(q, k, v, scale, False),
            "dq": lambda: flash.flash_backward_dq(q, k, v, o, lse, do,
                                                  scale),
            "dkv": lambda: flash.flash_backward_dkv(q, k, v, lse, dsum, do,
                                                    scale),
            "library_fwd": lambda: sdpa(q, k, v, scale=scale),
            "library_bwd": lambda: torch.autograd.grad(out, leaves, do,
                                                       retain_graph=True)}
    bwd = flash_bwd_bounds(q, k, False)
    b, h, sq, sk, d = shape
    fl = b * h * sq * sk * d
    e = q.element_size()
    rows = b * h * sq * d
    stats = b * h * sq * 4
    peak = H100_BF16_TFLOPS * 1e12
    bounds = {"fwd": attention_bound_ms(q, k, False, peak),
              "dq": _bound_ms(6 * rows * e + 2 * stats, 6 * fl, peak),
              "dkv": _bound_ms(6 * rows * e + 2 * stats, 8 * fl, peak)}
    return {"shape": list(shape), "dtype": "bfloat16",
            "ms": {n: cuda_ms(f) for n, f in runs.items()},
            "device_ms": {n: (device_ms(f) if not n.startswith("library")
                              else sum(kernel_device_us(f).values()) / 1e3)
                          for n, f in runs.items()},
            "bound_ms": {n: bb[0] for n, bb in bounds.items()},
            "bound_by": {n: bb[1] for n, bb in bounds.items()},
            "float32_rate_bound_ms": {"dq": bwd["dq"][0],
                                      "dkv": bwd["dkv"][0]}}


def _flash_kernel_dtypes(names):
    """``{kernel: sorted dtypes}`` of the flash kernels among profiled
    kernel names (``void flash_fwd_mma_kernel<__nv_bfloat16, 64>(...)``,
    or its mangled form): "bfloat16" where the instance names it, else
    "float"."""
    out = {}
    for name in names:
        for stem in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                     "flash_bwd_dkv_mma_kernel", "flash_fwd_simt_kernel",
                     "flash_bwd_dq_simt_kernel", "flash_bwd_dkv_simt_kernel"):
            if stem in name:
                out.setdefault(stem, set()).add(
                    "bfloat16" if "bfloat16" in name else "float")
    return {k: sorted(v) for k, v in out.items()}


def phase_bert_finetune_amp(smi):
    """bert_base_sst2_finetune_amp: the classifier of ``examples/gluon/
    transformer_finetune.py`` at BERT-base width, hybridized, trained by
    ``gluon.Trainer("adam")`` as MXNet 1.x's AMP recipe wires it:
    ``amp.init()`` (bfloat16), ``amp.init_trainer``, ``with
    amp.scale_loss(...)``, ``autograd.backward``, ``amp.unscale``, then
    ``trainer.step``; batch 32, seq 128, 3 warm-ups and 20 steps with a
    falling loss. Checks: the dtypes of one eager step's GEMMs (bfloat16),
    LayerNorm and log-softmax (float32), by a dispatch-mode census; K3
    12 and K3-bwd 12 + 12 launches a replayed step, their kernels the
    bfloat16 instances (profiler names), K2 one; after
    ``amp.turn_off()`` the next steps capture anew and run K3 in float32.
    Step ms of AMP against the float32 step in the same call, blocks of
    10 (after 3 warm-ups each) in the order AMP, float32, float32, AMP.
    K3 and K3-bwd in bfloat16 at the training shape beside their bounds
    and bfloat16 SDPA."""
    from mxnet_tpu_torch import amp

    cfg, a = BERT_BASE, AMP_FINETUNE
    t_phase = time.perf_counter()
    weights = random_params(cfg, seed=0)
    x, y = make_task(a["batch"], cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    layers = cfg["layers"]
    try:
        amp.init()
        clf = _classifier_on(mx.gpu(0), cfg, weights)
        clf.hybridize()
        with mx.gpu(0):
            xb, yb = mx.nd.array(x), mx.nd.array(y)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(clf.collect_params(), "adam",
                                   {"learning_rate": a["lr"],
                                    "wd": a["wd"]}, kvstore="local")
        amp.init_trainer(trainer)

        def step():
            with mx.autograd.record():
                out = clf(xb)
                loss = loss_fn(out, yb)
                with amp.scale_loss(loss, trainer) as scaled:
                    mx.autograd.backward(scaled)
            if amp.unscale(trainer):
                raise AssertionError("bert_base_sst2_finetune_amp: an "
                                     "overflow under bfloat16")
            trainer.step(a["batch"])
            return loss

        census = _DtypeCensus()
        prev = compile_service.set_enabled(False)
        try:
            with census:
                loss0 = float(step().mean().asscalar())
        finally:
            compile_service.set_enabled(prev)
        want_dtypes = {"gemm:bfloat16", "layer_norm:float32",
                       "log_softmax:float32"}
        off = [k for k in census.seen if k not in want_dtypes]
        if off or not want_dtypes <= set(census.seen):
            raise AssertionError(f"bert_base_sst2_finetune_amp: dtype "
                                 f"census {census.seen}")
        for _ in range(a["warmup"] - 1):
            step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        s0 = _site_stats("cachedop")
        losses, ms = [], []
        for _ in range(a["steps"]):
            t0 = time.perf_counter()
            losses.append(float(step().mean().asscalar()))
            ms.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v / a["steps"] for k, v in _counts().items()}
        s1 = _site_stats("cachedop")
        want = {"flash_attention": layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers, "opt_adam": 1}
        if {k: per_step.get(k) for k in want} != want or \
                s1["replays"] - s0["replays"] != 2 * a["steps"]:
            raise AssertionError(f"bert_base_sst2_finetune_amp: launches a "
                                 f"step {per_step}, site {s0} -> {s1}")
        if not all(math.isfinite(v) for v in losses) or \
                not statistics.mean(losses[-5:]) < statistics.mean(
                    losses[:5]):
            raise AssertionError(f"bert_base_sst2_finetune_amp: losses "
                                 f"{losses}")
        bf16_kernels = _flash_kernel_dtypes(kernel_device_us(
            step, iters=a["profiled"], warmup=1))
        if set(bf16_kernels) != {"flash_fwd_mma_kernel",
                                 "flash_bwd_dq_mma_kernel",
                                 "flash_bwd_dkv_mma_kernel"} or \
                any(v != ["bfloat16"] for v in bf16_kernels.values()):
            raise AssertionError(f"bert_base_sst2_finetune_amp: flash "
                                 f"kernels under AMP {bf16_kernels}")
        blocks = []
        for mode in ("amp", "float32", "float32", "amp"):
            if mode == "amp":
                amp.init()
            else:
                amp.turn_off()
            c0 = _site_stats("cachedop")
            for _ in range(a["warmup"]):
                step()
            torch.cuda.synchronize()
            c1 = _site_stats("cachedop")
            kernels.reset_launch_counts()
            bms = []
            for _ in range(a["block"]):
                t0 = time.perf_counter()
                float(step().mean().asscalar())
                bms.append((time.perf_counter() - t0) * 1e3)
            blocks.append({"mode": mode, "step_ms": bms,
                           "captures_in_warmup": c1["captures"] -
                           c0["captures"],
                           "launches": {k: v / a["block"] for k, v in
                                        _counts().items()}})
            if blocks[-1]["captures_in_warmup"] != 1:
                raise AssertionError(f"bert_base_sst2_finetune_amp: {mode} "
                                     f"block captured "
                                     f"{blocks[-1]['captures_in_warmup']} "
                                     "times in its warm-ups, expected 1")
            if mode == "float32" and len(blocks) == 2:
                f32_kernels = _flash_kernel_dtypes(kernel_device_us(
                    step, iters=2, warmup=1))
                if any(v != ["float"] for v in f32_kernels.values()) or \
                        len(f32_kernels) != 3:
                    raise AssertionError(
                        f"bert_base_sst2_finetune_amp: flash kernels after "
                        f"turn_off {f32_kernels}")
    finally:
        amp.turn_off()
    per_mode = {}
    for b in blocks:
        per_mode.setdefault(b["mode"], []).extend(b["step_ms"])
    med = {k: statistics.median(v) for k, v in per_mode.items()}
    timing = _amp_attention_timing(torch.device("cuda", 0))
    out = {"phase": "bert_base_sst2_finetune_amp", "card": smi,
           "source": "examples/gluon/transformer_finetune.py's classifier "
                     "at BERT-base width, hybridized, gluon.Trainer('adam') "
                     "under MXNet 1.x's AMP recipe (amp.init, init_trainer, "
                     "scale_loss, unscale)",
           "config": cfg, **a, "target_dtype": "bfloat16",
           "first_loss": loss0, "losses": losses, "step_ms": ms,
           "median_step_ms_amp_run": statistics.median(ms),
           "dtype_census": census.seen,
           "launches_per_step": per_step,
           "flash_kernels_amp": bf16_kernels,
           "flash_kernels_after_turn_off": f32_kernels,
           "median_step_ms": med, "amp_over_float32": med["amp"] /
           med["float32"],
           "block_medians_ms": [[b["mode"], statistics.median(b["step_ms"])]
                                for b in blocks],
           "captures_per_block": [b["captures_in_warmup"] for b in blocks],
           "tokens_s_amp": a["batch"] * cfg["seq_len"] / med["amp"] * 1e3,
           "attention_bf16": timing,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del clf, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the NumPy frontend ------
# np_surface's cases at tests/test_numpy.py's sizes: one or more per op
# name of ops/numpy_ops.py (the 271 names the NumPy frontend registers).
# A case is (op name, input specs, keywords, family[, invariant]); a spec
# "kind:shape" makes a numpy array from a seed (np_case_inputs). Families
# and their card-against-CPU tolerance (ROADMAP.md "Numerics"): "exact"
# bit for bit (data movement, comparisons, integer and sign ops, float
# add/subtract/multiply/max/min/where/clip/floor); "ulp" rtol 1e-5 atol
# 1e-6 (transcendentals, divisions: CUDA's and the CPU's libm differ by
# an ulp or two); "reduce" rtol 1e-5 atol 1e-5 (sums in another order);
# "linalg" rtol 1e-4 atol 1e-4 on each output's invariant (QR's product,
# SVD's and eigh's reconstructions and values, eig's sorted real values:
# the factors' signs differ between solvers); "sampler" the shape and
# dtype, and a second draw under one seed bit for bit.
NP_TOL = {"exact": (0.0, 0.0), "ulp": (1e-5, 1e-6), "reduce": (1e-5, 1e-5),
          "linalg": (1e-4, 1e-4)}
_NP_UNARY_IN = {"arccosh": "g", "arcsin": "u", "arccos": "u",
                "arctanh": "u", "invert": "i", "logical_not": "b"}
_NP_UNARY_EXACT = {"negative", "absolute", "sign", "rint", "ceil", "floor",
                   "trunc", "fix", "square", "invert", "logical_not",
                   "isnan", "isinf", "isposinf", "isneginf", "isfinite",
                   "conj", "real", "imag"}
_NP_BINARY_EXACT = {"add", "subtract", "multiply", "maximum", "minimum",
                    "fmax", "fmin", "copysign", "bitwise_and",
                    "bitwise_or", "bitwise_xor", "left_shift",
                    "right_shift", "logical_and", "logical_or",
                    "logical_xor", "equal", "not_equal", "less",
                    "less_equal", "greater", "greater_equal", "gcd", "lcm"}


def np_cases():
    """The case list (see NP_TOL)."""
    cases = []
    for n in ("negative", "reciprocal", "absolute", "sign", "rint", "ceil",
              "floor", "trunc", "fix", "square", "sqrt", "cbrt", "exp",
              "expm1", "log", "log10", "log2", "log1p", "sin", "cos", "tan",
              "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
              "arcsinh", "arccosh", "arctanh", "degrees", "radians",
              "invert", "logical_not", "isnan", "isinf", "isposinf",
              "isneginf", "isfinite", "conj", "real", "imag"):
        kind = _NP_UNARY_IN.get(n, "p")
        cases.append((f"_npi_{n}", [f"{kind}:3,4"], {},
                      "exact" if n in _NP_UNARY_EXACT else "ulp"))
    for n in ("add", "subtract", "multiply", "true_divide", "floor_divide",
              "mod", "fmod", "remainder", "power", "maximum", "minimum",
              "fmax", "fmin", "hypot", "arctan2", "copysign", "logaddexp",
              "logical_and", "logical_or", "logical_xor", "equal",
              "not_equal", "less", "less_equal", "greater",
              "greater_equal"):
        cases.append((f"_npi_{n}", ["f:3,4", "p:3,4"], {},
                      "exact" if n in _NP_BINARY_EXACT else "ulp"))
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm"):
        cases.append((f"_npi_{n}", ["n:3,4", "n:3,4"], {}, "exact"))
    for n in ("left_shift", "right_shift"):
        cases.append((f"_npi_{n}", ["n:3,4", "k:3,4"], {}, "exact"))
    cases += [
        ("_npi_ldexp", ["f:3,4", "k:3,4"], {}, "exact"),
        ("_npi_matmul", ["f:3,4", "f:4,5"], {}, "reduce"),
        ("_npi_dot", ["f:3,4", "f:4,5"], {}, "reduce"),
        ("_np_dot", ["f:3,4", "f:4"], {}, "reduce"),
        ("_npi_inner", ["f:3,4", "f:5,4"], {}, "reduce"),
        ("_npi_outer", ["f:3", "f:4"], {}, "exact"),
        ("_npi_kron", ["f:2,2", "f:2,3"], {}, "exact"),
        ("_npi_cross", ["f:4,3", "f:4,3"], {}, "ulp"),
        ("_npi_vdot", ["f:3,4", "f:3,4"], {}, "reduce"),
        ("_npi_einsum", ["f:3,4", "f:4,5"], {"subscripts": "ij,jk->ik"},
         "reduce"),
        ("_npi_tensordot", ["f:2,3,4", "f:4,3,2"],
         {"axes": ((1, 2), (1, 0))}, "reduce"),
        ("_npi_tensordot_int_axes", ["f:3,4", "f:4,5"], {"axes": 1},
         "reduce")]
    for n in ("add", "subtract", "rsubtract", "multiply", "true_divide",
              "rtrue_divide", "mod", "rmod", "power", "rpower",
              "floor_divide", "rfloor_divide"):
        exact = n in ("add", "subtract", "rsubtract", "multiply")
        cases.append((f"_npi_{n}_scalar", ["p:3,4"], {"scalar": 2.5},
                      "exact" if exact else "ulp"))
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor", "lcm"):
        cases.append((f"_npi_{n}_scalar", ["n:3,4"], {"scalar": 6}, "exact"))
    for n, fam in (("sum", "reduce"), ("prod", "reduce"), ("mean", "reduce"),
                   ("max", "exact"), ("min", "exact"), ("amax", "exact"),
                   ("amin", "exact"), ("nansum", "reduce"),
                   ("nanprod", "reduce"), ("ptp", "exact")):
        for axis in (None, 1):
            cases.append((f"_npi_{n}", ["f:3,4"], {"axis": axis}, fam))
    cases += [
        ("_npi_sum", ["i:3,4"], {"axis": 0}, "exact"),
        ("_npi_sum", ["b:3,4"], {}, "exact"),
        ("_npi_std", ["f:3,4"], {"axis": 0, "ddof": 1}, "reduce"),
        ("_npi_var", ["f:3,4"], {"axis": None}, "reduce"),
        ("_npi_argmax", ["f:3,4"], {"axis": 1}, "exact"),
        ("_npi_argmin", ["f:3,4"], {"axis": None}, "exact"),
        ("_npi_any", ["b:3,4"], {"axis": 0}, "exact"),
        ("_npi_all", ["b:3,4"], {"axis": 1}, "exact"),
        ("_np_any", ["b:3,4"], {}, "exact"),
        ("_np_all", ["b:3,4"], {}, "exact"),
        ("_npi_cumsum", ["f:3,4"], {"axis": 0}, "reduce"),
        ("_np_cumsum", ["i:3,4"], {"axis": 1}, "exact"),
        ("_npi_cumprod", ["p:3,4"], {"axis": 1}, "reduce"),
        ("_npi_median", ["f:5,4"], {"axis": 0}, "exact"),
        ("_npi_quantile", ["f:25"], {"q": 0.3}, "ulp"),
        ("_npi_percentile", ["f:25"], {"q": 30.0}, "ulp"),
        ("_npi_average", ["f:3,4"], {"axis": 1}, "reduce"),
        ("_npi_count_nonzero", ["i:3,4"], {"axis": 0}, "exact"),
        ("_npi_reshape", ["f:3,4"], {"newshape": (4, 3)}, "exact"),
        ("_np_reshape", ["f:3,4"], {"newshape": (-1,)}, "exact"),
        ("_npi_transpose", ["f:2,3,4"], {"axes": (2, 0, 1)}, "exact"),
        ("_np_transpose", ["f:3,4"], {}, "exact"),
        ("_npi_swapaxes", ["f:2,3,4"], {"dim1": 0, "dim2": 2}, "exact"),
        ("_npi_moveaxis", ["f:2,3,4"], {"source": 0, "destination": 2},
         "exact"),
        ("_np_moveaxis", ["f:2,3,4"], {"source": 2, "destination": 0},
         "exact"),
        ("_npi_expand_dims", ["f:3,4"], {"axis": 1}, "exact"),
        ("_npi_squeeze", ["f:1,3,1"], {}, "exact"),
        ("_np_squeeze", ["f:1,3,1"], {"axis": 0}, "exact"),
        ("_npi_broadcast_to", ["f:1,4"], {"shape": (3, 4)}, "exact"),
        ("_npi_ravel", ["f:3,4"], {}, "exact"),
        ("_npi_flip", ["f:3,4"], {"axis": 0}, "exact"),
        ("_npi_fliplr", ["f:3,4"], {}, "exact"),
        ("_npi_flipud", ["f:3,4"], {}, "exact"),
        ("_npi_roll", ["f:3,4"], {"shift": 1, "axis": 1}, "exact"),
        ("_np_roll", ["f:3,4"], {"shift": -2}, "exact"),
        ("_npi_rot90", ["f:3,4"], {"k": 1, "axes": (0, 1)}, "exact"),
        ("_npi_tile", ["f:2,3"], {"reps": (2, 1)}, "exact"),
        ("_npi_repeat", ["f:2,3"], {"repeats": 2, "axis": 1}, "exact"),
        ("_npi_pad", ["f:3,4"], {"pad_width": ((1, 1), (2, 0))}, "exact"),
        ("_npi_pad", ["f:3,4"], {"pad_width": ((1, 2), (2, 1)),
                                 "mode": "reflect"}, "exact"),
        ("_npi_pad", ["f:3,4"], {"pad_width": ((2, 2), (2, 2)),
                                 "mode": "edge"}, "exact"),
        ("_npi_pad", ["f:3,4"], {"pad_width": ((1, 1), (3, 0)),
                                 "mode": "wrap"}, "exact"),
        ("_npi_diag", ["f:4"], {"k": 1}, "exact"),
        ("_np_diag", ["f:3,4"], {}, "exact"),
        ("_npi_diagonal", ["f:3,4"], {"offset": 1}, "exact"),
        ("_np_diagonal", ["f:2,3,3"], {"axis1": 1, "axis2": 2}, "exact"),
        ("_npi_diagflat", ["f:3"], {"k": -1}, "exact"),
        ("_np_diagflat", ["f:2,2"], {}, "exact"),
        ("_npi_tril", ["f:3,4"], {"k": 1}, "exact"),
        ("_npi_triu", ["f:3,4"], {"k": -1}, "exact"),
        ("_npi_trace", ["f:3,4"], {}, "reduce"),
        ("_np_trace", ["i:3,3"], {"offset": 1}, "exact"),
        ("_npi_concatenate", ["f:2,3", "f:2,3"], {"axis": 1}, "exact"),
        ("_npi_stack", ["f:2,3", "f:2,3"], {"axis": 1}, "exact"),
        ("_npi_vstack", ["f:2,3", "f:2,3"], {}, "exact"),
        ("_npi_hstack", ["f:2,3", "f:2,3"], {}, "exact"),
        ("_npi_dstack", ["f:2,3", "f:2,3"], {}, "exact"),
        ("_npi_column_stack", ["f:3", "f:3"], {}, "exact"),
        ("_npi_atleast_1d", ["f:"], {}, "exact"),
        ("_npi_atleast_2d", ["f:3"], {}, "exact"),
        ("_npi_atleast_3d", ["f:3,4"], {}, "exact"),
        ("_npi_split", ["f:2,6"], {"indices_or_sections": 3, "axis": 1},
         "exact"),
        ("_npi_array_split", ["f:2,7"], {"indices_or_sections": 3,
                                         "axis": 1}, "exact"),
        ("_npi_hsplit", ["f:4,6"], {"indices_or_sections": 2}, "exact"),
        ("_npi_vsplit", ["f:4,6"], {"indices_or_sections": (1, 3)},
         "exact"),
        ("_npi_dsplit", ["f:2,2,4"], {"indices_or_sections": 2}, "exact"),
        ("_split_v2", ["f:6,4"], {"indices": (2, 5), "axis": 0}, "exact"),
        ("_npi_where", ["b:3,4", "f:3,4", "f:3,4"], {}, "exact"),
        ("_npi_where_lscalar", ["b:3,4", "f:3,4"], {"scalar": 2.0},
         "exact"),
        ("_npi_where_rscalar", ["b:3,4", "f:3,4"], {"scalar": -1.0},
         "exact"),
        ("_npi_where_scalar2", ["b:3,4"], {"lscalar": 1.0, "rscalar": 0.5},
         "exact"),
        ("_npi_clip", ["f:3,4"], {"a_min": -0.5, "a_max": 0.5}, "exact"),
        ("_npi_take", ["f:3,4", "x:2"], {"axis": 1}, "exact"),
        ("_npi_take_along_axis", ["f:3,4", "x:3,1"], {"axis": 1}, "exact"),
        ("_npi_searchsorted", ["o:8", "f:5"], {"side": "right"}, "exact"),
        ("_npi_sort", ["f:3,4"], {"axis": 1}, "exact"),
        ("_npi_argsort", ["f:3,4"], {"axis": 0}, "exact"),
        ("_npi_unique", ["r:10"], {}, "exact"),
        ("_npi_nonzero", ["i:3,4"], {}, "exact"),
        ("_npx_nonzero", ["i:3,4"], {}, "exact"),
        ("_npi_bincount", ["r:10"], {"minlength": 8}, "exact"),
        ("_npi_histogram", ["f:50"], {"bins": 5}, "exact"),
        ("_npi_interp", ["f:6", "o:8", "f:8"], {}, "ulp"),
        ("_npi_nan_to_num", ["f:3,4"], {"nan": 1.0}, "exact"),
        ("_npi_round", ["f:3,4"], {"decimals": 1}, "ulp"),
        ("_npi_around", ["f:3,4"], {}, "exact"),
        ("_npi_sign_nd", ["f:3,4"], {}, "exact"),
        ("_npi_meshgrid", ["f:3", "f:4"], {"indexing": "ij"}, "exact"),
        ("_npi_tril_indices", [], {"n": 4, "k": 1}, "exact"),
        ("_npi_indices", [], {"dimensions": (2, 3)}, "exact"),
        ("_npi_diff", ["f:3,5"], {"n": 2, "axis": 1}, "exact"),
        ("_npi_ediff1d", ["f:6"], {"to_begin": 1.0}, "exact"),
        ("_npi_gradient_op", ["f:3,5"], {}, "ulp"),
        ("_npi_norm", ["f:3,4"], {}, "reduce"),
        ("_npi_norm", ["f:3,4"], {"ord": 1, "axis": 1}, "reduce"),
        ("_npi_inv", ["w:4,4"], {}, "linalg"),
        ("_npi_pinv", ["w:4,4"], {}, "linalg"),
        ("_npi_pinv_scalar_rcond", ["w:4,4"], {"rcond": 1e-6}, "linalg"),
        ("_npi_det", ["w:4,4"], {}, "linalg"),
        ("_npi_slogdet", ["w:4,4"], {}, "linalg"),
        ("_npi_matrix_rank", ["w:4,4"], {}, "exact"),
        ("_npi_svd", ["w:4,4"], {}, "linalg", "svd"),
        ("_npi_qr", ["w:4,3"], {}, "linalg", "qr"),
        ("_npi_cholesky", ["s:4,4"], {}, "linalg"),
        ("_npi_eig", ["s:4,4"], {}, "linalg", "eig"),
        ("_npi_eigvals", ["s:4,4"], {}, "linalg", "eigvals"),
        ("_npi_eigh", ["s:4,4"], {}, "linalg", "eigh"),
        ("_npi_eigvalsh", ["s:4,4"], {}, "linalg"),
        ("_npi_solve", ["w:4,4", "f:4,2"], {}, "linalg"),
        ("_npi_lstsq", ["w:6,4", "f:6,2"], {}, "linalg", "lstsq"),
        ("_npi_matrix_power", ["w:3,3"], {"n": 3}, "linalg"),
        ("_npi_multi_dot", ["f:2,3", "f:3,4", "f:4,2"], {}, "linalg"),
        ("_npi_tensorinv", ["w:6,6"], {"ind": 1}, "linalg"),
        ("_npi_tensorsolve", ["w:6,6", "f:6"], {}, "linalg"),
        ("_npi_zeros", [], {"shape": (2, 3)}, "exact"),
        ("_npi_ones", [], {"shape": (2, 3), "dtype": "int32"}, "exact"),
        ("_npi_full", [], {"shape": (2, 3), "fill_value": 1.5}, "exact"),
        ("_npi_arange", [], {"start": 1.0, "stop": 7.0, "step": 1.5},
         "exact"),
        ("_npi_linspace", [], {"start": 0.0, "stop": 1.0, "num": 9},
         "ulp"),
        ("_npi_logspace", [], {"start": 0.0, "stop": 2.0, "num": 5},
         "ulp"),
        ("_npi_eye", [], {"N": 3, "M": 4, "k": 1}, "exact"),
        ("_npi_hanning", [], {"M": 7}, "ulp"),
        ("_npi_hamming", [], {"M": 7}, "ulp"),
        ("_npi_blackman", [], {"M": 7}, "ulp"),
        ("_npi_polyval", ["f:3", "f:5"], {}, "ulp"),
        ("_npi_delete", ["f:6"], {"obj": 2}, "exact"),
        ("_npi_insert_scalar", ["f:5"], {"obj": 1, "val": 9.0}, "exact"),
        ("_npi_insert_slice", ["f:5", "f:2"], {"start": 1, "stop": 3},
         "exact"),
        ("_npi_insert_tensor", ["f:5", "x:2", "f:2"], {}, "exact"),
        ("_npi_diag_indices_from", ["f:3,3"], {}, "exact"),
        ("_npi_boolean_mask_assign_scalar", ["f:3,4", "b:3,4"],
         {"value": 0.5}, "exact"),
        ("_npi_boolean_mask_assign_tensor", ["f:3,4", "b:3,4", "f:4"], {},
         "exact"),
        ("_npx_constraint_check", ["b:3,4"], {}, "exact"),
        ("_npx_reshape", ["f:2,3,4"], {"newshape": (-3, -2)}, "exact"),
        ("_npx_reshape", ["f:6,4"], {"newshape": (-4, 2, -1, -2)}, "exact"),
        ("_npi_share_memory", ["f:3", "f:3"], {}, "exact"),
        ("_np_copy", ["f:3,4"], {}, "exact"),
        ("_npi_bitwise_not", ["i:3,4"], {}, "exact"),
        ("_npi_deg2rad", ["f:3,4"], {}, "ulp"),
        ("_npi_rad2deg", ["f:3,4"], {}, "ulp"),
        ("_unravel_index", ["r:4"], {"shape": (3, 4)}, "exact"),
        ("_ravel_multi_index", ["m:2,3"], {"shape": (3, 4)}, "exact")]
    for n, kw in (
            ("_npi_random_uniform", {"low": -1.0, "high": 2.0}),
            ("_npi_uniform", {}), ("_npi_uniform_n", {}),
            ("_npi_random_normal", {"loc": 1.0, "scale": 2.0}),
            ("_npi_normal", {}), ("_npi_normal_n", {}),
            ("_npi_random_randint", {"low": 0, "high": 7}),
            ("_npi_random_gamma", {"shape_param": 2.0}),
            ("_npi_gamma", {}), ("_npi_random_exponential", {"scale": 2.0}),
            ("_npi_exponential", {}),
            ("_npi_random_beta", {"a": 2.0, "b": 3.0}),
            ("_npi_random_poisson", {"lam": 3.0}),
            ("_npi_random_bernoulli", {"p": 0.3}), ("_npi_bernoulli", {}),
            ("_npi_pareto", {"a": 3.0}), ("_npi_weibull", {"a": 2.0}),
            ("_npi_rayleigh", {"scale": 2.0}), ("_npi_powerd", {"a": 2.0})):
        cases.append((n, [], dict(kw, size=(4, 5)), "sampler"))
    cases += [
        ("_npi_random_choice", ["f:6"], {"size": (4,)}, "sampler"),
        ("_npi_choice", ["f:6"], {"size": (3,), "replace": False},
         "sampler"),
        ("_npi_random_permutation", ["f:6"], {}, "sampler"),
        ("_npi_multinomial", [], {"pvals": (0.2, 0.3, 0.5), "n": 10,
                                  "size": (4,)}, "sampler")]
    return cases


def np_case_inputs(specs, seed):
    """numpy arrays for a case's input specs, from ``RandomState(seed)``:
    f normal, p in [0.5, 1.5), g in [1.5, 2.5), u in (-0.9, 0.9), i ints
    in [-5, 5], n ints in [1, 9], k ints in [0, 3], r ints in [0, 6), b
    bool, o sorted normal, x int indices in [0, 3), m coordinates of a
    (3, 4) grid, s symmetric positive definite, w well conditioned (all
    float32 or int32)."""
    rs = np.random.RandomState(seed)
    out = []
    for spec in specs:
        kind, _, dims = spec.partition(":")
        shape = tuple(int(d) for d in dims.split(",") if d)
        if kind == "f":
            a = rs.standard_normal(shape)
        elif kind == "p":
            a = rs.uniform(0.5, 1.5, shape)
        elif kind == "g":
            a = rs.uniform(1.5, 2.5, shape)
        elif kind == "u":
            a = rs.uniform(-0.9, 0.9, shape)
        elif kind == "o":
            a = np.sort(rs.standard_normal(shape))
        elif kind == "s":
            m = rs.standard_normal(shape)
            a = m @ m.T / shape[0] + np.eye(shape[0])
        elif kind == "w":
            a = rs.standard_normal(shape) + 4 * np.eye(*shape)
        elif kind == "b":
            out.append(rs.uniform(size=shape) > 0.5)
            continue
        else:
            lo, hi = {"i": (-5, 6), "n": (1, 10), "k": (0, 4), "r": (0, 6),
                      "x": (0, 3)}.get(kind, (0, 3))
            if kind == "m":
                a = np.stack([rs.randint(0, 3, shape[1:]),
                              rs.randint(0, 4, shape[1:])])
            else:
                a = rs.randint(lo, hi, shape)
            out.append(a.astype(np.int32))
            continue
        out.append(a.astype(np.float32))
    return out


def np_case_invariant(kind, outs):
    """The solver-independent form of a factorisation's outputs (numpy
    arrays in, numpy arrays out)."""
    if kind == "qr":
        return (outs[0] @ outs[1],)
    if kind == "svd":
        u, s, vt = outs
        return (s, (u[:, :len(s)] * s) @ vt[:len(s)])
    if kind == "eigh":
        w, v = outs
        return (w, (v * w) @ v.T)
    if kind in ("eig", "eigvals"):
        return (np.sort(np.real(outs[0])),)
    if kind == "lstsq":
        return (outs[0], outs[3])
    return outs


def np_run_case(case, ctx, seed=0):
    """The port's outputs (numpy arrays) of one case on ``ctx``."""
    name, specs, kw = case[:3]
    kw = dict(kw)
    if name == "_npi_multinomial":
        kw["pvals"] = np.asarray(kw["pvals"], np.float32)
    with ctx:
        arrays = [mx.nd.array(a, dtype=a.dtype)
                  for a in np_case_inputs(specs, seed)]
        if "pvals" in kw:
            kw["pvals"] = mx.nd.array(kw["pvals"])._data
        out = mx.nd.invoke(name, *arrays, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    host = tuple(o.asnumpy() if o._data.dtype != torch.complex64 else
                 o._data.detach().cpu().numpy() for o in outs)
    return np_case_invariant(case[4], host) if len(case) > 4 else host


def np_case_close(family, a, b):
    """Whether two outputs of a case agree within its family's
    tolerance (``NP_TOL``); samplers by shape and dtype."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if family == "sampler":
        return True
    rtol, atol = NP_TOL[family]
    if rtol == 0 and atol == 0:
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return bool(np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


# the realistic sizes of np_surface: the attention scores of BERT-base,
# np.linalg at LINALG_CHECK's batch, a boolean mask over a BERT-base
# activation, and the samplers' first two moments
NP_SURFACE = {"einsum": (32, 12, 128, 64), "activation": (32, 128, 768),
              "draws": 10_000_000, "moment_sigmas": 6.0,
              "einsum_rtol": 1e-4, "timed_iters": 20}
# np-mode fine-tune: TRAIN's settings, each mode's loss trajectory from one
# set of weights and batches; the A B B A blocks of TRAIN["steps"] steps
NP_FINETUNE = {"batch": 32, "warmup": 3, "steps": 20, "lr": 1e-4,
               "wd": 1e-4}


def _np_loss(x_mod, logits, label):
    """The fine-tune loss as an MXNet 1.x np user writes it, in either
    frontend (``npx``, or ``nd``)."""
    return -x_mod.pick(x_mod.log_softmax(logits), label).mean()


def np_mode_steps(ctx, cfg, weights, batches, np_mode, hybridize, lr, wd):
    """The classifier from ``weights`` trained one ``gluon.Trainer`` Adam
    step per batch with the loss of :func:`_np_loss`, its inputs
    ``mx.np.array`` (np_mode) or ``mx.nd.array``. Returns ``(losses,
    {"classes": (output class, loss class)}, clf, step, feed)``:
    ``step(xb, yb)`` runs one more step and returns the loss array, and
    ``feed`` holds the batches as that frontend's arrays."""
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx

    clf = _classifier_on(ctx, cfg, weights)
    if hybridize:
        clf.hybridize()
    trainer = mx.gluon.Trainer(clf.collect_params(), "adam",
                               {"learning_rate": lr, "wd": wd},
                               kvstore="local")
    m, xm = (mnp, npx) if np_mode else (mx.nd, mx.nd)
    last = {}

    def step(xb, yb):
        with mx.autograd.record():
            logits = clf(xb)
            loss = _np_loss(xm, logits, yb)
        loss.backward()
        trainer.step(1)
        last["classes"] = (type(logits).__name__, type(loss).__name__)
        return loss

    losses = []
    with ctx:
        feed = [(m.array(x), m.array(y)) for x, y in batches]
    for xb, yb in feed:
        losses.append(float(step(xb, yb).item()))
    return losses, last, clf, step, feed


def _np_blocks(routes, blocks_order, warmup, steps):
    """A B B A blocks of ``steps`` timed steps (after ``warmup``) for the
    routes ``{mode: (step, feed)}``, each step's ms on the host clock
    with its loss read."""
    blocks = []
    for mode in blocks_order:
        step, feed = routes[mode]
        for i in range(warmup):
            step(*feed[i % len(feed)])
        torch.cuda.synchronize()
        ms = []
        for i in range(steps):
            t0 = time.perf_counter()
            float(step(*feed[i % len(feed)]).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        blocks.append({"mode": mode, "step_ms": ms})
    return blocks


def phase_bert_np_finetune(smi):
    """bert_base_np_finetune: the classifier of ``examples/gluon/
    transformer_finetune.py`` at BERT-base width under ``npx.set_np()``,
    wired as an MXNet 1.x np user does: token ids and labels as
    ``mx.np.array`` on ``gpu(0)``, the loss ``-npx.pick(npx.log_softmax(
    logits), label).mean()``, ``autograd.record``, ``backward``,
    ``gluon.Trainer("adam").step``; batch 32, seq 128, 3 warm-ups and 20
    steps (``TRAIN``), eager and hybridized. Each route's np-mode loss
    trajectory equals the same phase's NDArray-mode one (``mx.nd`` arrays
    and ops) from the same weights and batches bit for bit; the output
    and loss are ``mx.np.ndarray``; no numpy fallback and no host op is
    hit; a hybridized np step makes no host sync but the loss read
    (``set_sync_debug_mode``); K3 12, K3-bwd 12 + 12 and K2 1 launches a
    step. Then ms a step, np against NDArray, in blocks of 20 in the
    order np, nd, nd, np, eager and hybridized, and each run's peak
    memory above what the runs before it hold."""
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.ops import registry

    cfg, a = BERT_BASE, NP_FINETUNE
    t_phase = time.perf_counter()
    layers = cfg["layers"]
    n = a["warmup"] + a["steps"]
    weights = random_params(cfg, seed=0)
    x, y = make_task(a["batch"] * n, cfg["seq_len"], cfg["vocab"],
                     cfg["num_classes"], seed=5)
    batches = [(x[i * a["batch"]:(i + 1) * a["batch"]],
                y[i * a["batch"]:(i + 1) * a["batch"]]) for i in range(n)]
    want = {"flash_attention": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "opt_adam": 1}
    gpu = mx.gpu(0)
    runs, routes = {}, {}
    try:
        with mnp.watching_fallbacks() as fallbacks, \
                registry.watching_host_ops() as host_ops:
            for hybrid in (False, True):
                route = "hybridized" if hybrid else "eager"
                for np_mode in (True, False):
                    if np_mode:
                        npx.set_np()
                    else:
                        npx.reset_np()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    kernels.reset_launch_counts()
                    losses, last, clf, step, feed = np_mode_steps(
                        gpu, cfg, weights, batches, np_mode, hybrid,
                        a["lr"], a["wd"])
                    torch.cuda.synchronize()
                    launches = {k: v / n for k, v in _counts().items()}
                    mode = "np" if np_mode else "nd"
                    runs[(route, mode)] = {
                        "losses": losses, "classes": last["classes"],
                        "launches_per_step": launches,
                        "peak_memory_above_earlier_runs":
                            torch.cuda.max_memory_allocated() - base}
                    routes[(route, mode)] = (step, feed, clf)
                    if {k: launches.get(k) for k in want} != want:
                        raise AssertionError(
                            f"bert_base_np_finetune: {route} {mode} "
                            f"launches a step {launches}, want {want}")
            npx.set_np()
            step_np, feed_np, _ = routes[("hybridized", "np")]
            syncs = _sync_count(lambda: step_np(*feed_np[0]))
    finally:
        npx.reset_np()
    for route in ("eager", "hybridized"):
        npl, ndl = runs[(route, "np")]["losses"], runs[(route, "nd")][
            "losses"]
        if npl != ndl:
            raise AssertionError(f"bert_base_np_finetune: {route} np-mode "
                                 f"losses {npl} differ from NDArray-mode "
                                 f"{ndl}")
        if runs[(route, "np")]["classes"] != ("ndarray", "ndarray") or \
                runs[(route, "nd")]["classes"] != ("NDArray", "NDArray"):
            raise AssertionError(f"bert_base_np_finetune: classes "
                                 f"{runs[(route, 'np')]['classes']} / "
                                 f"{runs[(route, 'nd')]['classes']}")
        if not all(math.isfinite(v) for v in npl) or \
                not statistics.mean(npl[-5:]) < statistics.mean(npl[:5]):
            raise AssertionError(f"bert_base_np_finetune: {route} losses "
                                 f"{npl}")
    if fallbacks or host_ops or syncs:
        raise AssertionError(f"bert_base_np_finetune: numpy fallbacks "
                             f"{fallbacks}, host ops {host_ops}, host "
                             f"syncs of a hybridized np step {syncs}")
    timing = {}
    for route in ("eager", "hybridized"):
        blocks = _np_blocks({m: routes[(route, m)][:2] for m in ("np",
                                                                 "nd")},
                            ("np", "nd", "nd", "np"), a["warmup"],
                            a["steps"])
        med = {m: statistics.median([v for b in blocks if b["mode"] == m
                                     for v in b["step_ms"]])
               for m in ("np", "nd")}
        timing[route] = {"block_medians_ms": [
            [b["mode"], statistics.median(b["step_ms"])] for b in blocks],
            "median_step_ms": med, "np_minus_nd_ms": med["np"] - med["nd"],
            "step_ms_by_block": [b["step_ms"] for b in blocks]}
    out = {"phase": "bert_base_np_finetune", "card": smi,
           "source": "examples/gluon/transformer_finetune.py's classifier "
                     "at BERT-base width under npx.set_np(), loss "
                     "-npx.pick(npx.log_softmax(logits), label).mean(), "
                     "gluon.Trainer('adam')",
           "config": cfg, **a,
           "losses": {f"{r}_{m}": v["losses"] for (r, m), v in
                      runs.items()},
           "np_equals_nd_bit_for_bit": True,
           "classes": {f"{r}_{m}": v["classes"] for (r, m), v in
                       runs.items()},
           "launches_per_step": {f"{r}_{m}": v["launches_per_step"]
                                 for (r, m), v in runs.items()},
           "peak_memory_above_earlier_runs": {
               f"{r}_{m}": v["peak_memory_above_earlier_runs"]
               for (r, m), v in runs.items()},
           "numpy_fallbacks": fallbacks, "host_ops": host_ops,
           "host_syncs_hybridized_np_step": syncs,
           "timing": timing,
           "tokens_s_hybridized_np": a["batch"] * cfg["seq_len"] /
           timing["hybridized"]["median_step_ms"]["np"] * 1e3,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del routes
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the legacy ops tests/test_op_schema.py exercises, card against CPU
NP_SCHEMA_CASES = [
    ("Activation", ["f:2,3,4"], {"act_type": "relu"}, "exact"),
    ("Activation", ["f:2,3,4"], {"act_type": "softsign"}, "ulp"),
    ("Pooling", ["f:2,3,8,8"], {"kernel": (2, 2), "stride": (2, 2),
                                "pool_type": "max"}, "exact"),
    ("Pooling", ["f:2,3,8,8"], {"kernel": (2, 2), "stride": (2, 2),
                                "pool_type": "avg"}, "ulp"),
    ("FullyConnected", ["f:4,8", "f:3,8", "f:3"], {"num_hidden": 3},
     "reduce"),
    ("Convolution", ["f:2,3,8,8", "f:8,3,3,3", "f:8"],
     {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1)}, "reduce"),
    ("Concat", ["f:2,3", "f:2,4"], {"dim": 1}, "exact"),
    ("Dropout", ["f:3,4"], {"p": 0.25}, "exact"),
    ("softmax", ["f:3,4"], {"axis": 0}, "ulp"),
    ("BatchNorm", ["f:2,3,4,4", "p:3", "f:3", "f:3", "p:3"],
     {"use_global_stats": True}, "ulp")]


def _draw_moments(draws):
    """Mean and variance of ``draws`` (float64 sums on the card) and the
    standard errors of both (the second from the sample's fourth central
    moment)."""
    d = draws.to(torch.float64).reshape(-1)
    n = d.numel()
    mean = d.mean()
    c = d - mean
    var = (c * c).mean()
    m4 = (c ** 4).mean()
    return (float(mean), float(var), math.sqrt(float(var) / n),
            math.sqrt(max(float(m4 - var * var), 0.0) / n))


# the samplers' analytic mean and variance at np_surface's parameters
_NP_MOMENTS = {
    "uniform": (lambda m, s: m.random.uniform(-1.0, 2.0, size=s),
                0.5, 0.75),
    "normal": (lambda m, s: m.random.normal(1.0, 2.0, size=s), 1.0, 4.0),
    "randint": (lambda m, s: m.random.randint(0, 7, size=s), 3.0, 4.0),
    "exponential": (lambda m, s: m.random.exponential(2.0, size=s),
                    2.0, 4.0),
    "gamma": (lambda m, s: m.random.gamma(2.0, 1.5, size=s), 3.0, 4.5),
    "beta": (lambda m, s: m.random.beta(2.0, 3.0, size=s), 0.4, 0.04),
    "poisson": (lambda m, s: m.random.poisson(3.0, size=s), 3.0, 3.0),
    "bernoulli": (lambda m, s: m.random.bernoulli(0.3, size=s), 0.3, 0.21),
    "pareto": (lambda m, s: m.random.pareto(5.0, size=s), 0.25,
               5.0 / 48.0),
    "weibull": (lambda m, s: m.random.weibull(2.0, size=s),
                math.gamma(1.5), 1.0 - math.gamma(1.5) ** 2),
    "rayleigh": (lambda m, s: m.random.rayleigh(2.0, size=s),
                 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4.0)}


def phase_np_surface(smi):
    """np_surface: the NumPy frontend on the card against the port on
    the CPU. At tests/test_numpy.py's sizes, every case of
    :func:`np_cases` (each of ops/numpy_ops.py's 271 names that a case
    reaches) and the legacy ops of tests/test_op_schema.py
    (``NP_SCHEMA_CASES``), each within its family's tolerance
    (``NP_TOL``: exact ops bit for bit), samplers by shape and dtype and
    repeating under one seed; a misspelt keyword raises ``OpParamError``
    on the card before any launch. At a realistic size (``NP_SURFACE``):
    ``np.einsum("bhqd,bhkd->bhqk")`` at BERT-base's attention shape
    (timed beside ``torch.matmul`` and its bound), ``np.linalg``
    cholesky/solve/svd/eigh/det at ``LINALG_CHECK``'s batch (det on
    16 x 16 blocks) against the CPU, a boolean mask read and written on
    a 32 x 128 x 768 activation (the write with no host sync), and the
    samplers' first two moments over 10^7 draws within 6 standard
    errors. Prints the names that ran, the host ops and numpy fallbacks
    hit, and the names no case reaches; a failed case raises."""
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops.schema import OpParamError

    t_phase = time.perf_counter()
    gpu, cpu = mx.gpu(0), mx.cpu()
    ran, failed = [], []
    with mnp.watching_fallbacks() as fallbacks, \
            registry.watching_host_ops() as host_ops:
        for i, case in enumerate(np_cases() + NP_SCHEMA_CASES):
            fam = case[3]
            if fam == "sampler":
                mx.random.seed(11)
                card = np_run_case(case, gpu, i)
                mx.random.seed(11)
                again = np_run_case(case, gpu, i)
                ok = all(np.array_equal(u, v) for u, v in zip(card, again))
            else:
                card, ok = np_run_case(case, gpu, i), True
            host = np_run_case(case, cpu, i)
            ok = ok and len(card) == len(host) and all(
                np_case_close(fam, u, v) for u, v in zip(card, host))
            (ran if ok else failed).append(case[0])
            if not ok:
                emit({"phase": "np_surface_case", "case": repr(case),
                      "card": [repr(u)[:400] for u in card],
                      "cpu": [repr(v)[:400] for v in host]})
    with gpu:
        kernels.reset_launch_counts()
        try:
            mx.nd.softmax(mx.nd.ones((2, 3)), axs=0)
            raise AssertionError("np_surface: a misspelt keyword passed")
        except OpParamError as e:
            schema_error = str(e)
    numpy_names = {n for n in registry.list_ops()
                   if n.startswith(("_np_", "_npi_", "_npx_"))} | {
        "_split_v2", "_unravel_index", "_ravel_multi_index"}
    reached = {c[0] for c in np_cases()}
    unreached = sorted(numpy_names - reached)
    if failed:
        raise AssertionError(f"np_surface: cases failed {failed}")
    big = _np_surface_realistic()
    out = {"phase": "np_surface", "card": smi,
           "cases": len(ran), "names_ran": sorted(set(ran)),
           "numpy_frontend_names": len(numpy_names),
           "names_no_case_reaches": unreached,
           "host_ops_hit": sorted(set(host_ops)),
           "numpy_fallbacks_hit": fallbacks,
           "schema_error_on_card": schema_error, "tolerances": NP_TOL,
           "realistic": big, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _np_surface_realistic():
    """np_surface's realistic sizes (see ``phase_np_surface``)."""
    from mxnet_tpu_torch import np as mnp

    s = NP_SURFACE
    gpu, cpu = mx.gpu(0), mx.cpu()
    rs = np.random.RandomState(3)
    out = {}
    # einsum at the attention scores' shape
    b, h, sq, d = s["einsum"]
    qh = rs.standard_normal((b, h, sq, d)).astype(np.float32)
    kh = rs.standard_normal((b, h, sq, d)).astype(np.float32)
    with gpu:
        q, k = mnp.array(qh), mnp.array(kh)
    card = mnp.einsum("bhqd,bhkd->bhqk", q, k)
    with cpu:
        ref = mnp.einsum("bhqd,bhkd->bhqk", mnp.array(qh), mnp.array(kh))
    err = float(np.abs(card.asnumpy() - ref.asnumpy()).max())
    scale = float(np.abs(ref.asnumpy()).max())
    if not err <= s["einsum_rtol"] * scale:
        raise AssertionError(f"np_surface: einsum {err} of {scale}")
    qt, kt = q._data, k._data
    nbytes = (qt.numel() + kt.numel() + b * h * sq * sq) * 4
    bound = _bound_ms(nbytes, 2 * b * h * sq * sq * d, H100_F32_FLOPS)
    out["einsum"] = {
        "shape": [b, h, sq, d], "max_abs_err": err, "scale": scale,
        "ms": cuda_ms(lambda: mnp.einsum("bhqd,bhkd->bhqk", q, k),
                      iters=s["timed_iters"]),
        "library_ms": cuda_ms(lambda: torch.matmul(qt, kt.transpose(-1, -2)),
                              iters=s["timed_iters"]),
        "bound_ms": bound[0], "bound_by": bound[1]}
    # np.linalg at LINALG_CHECK's batch, card against CPU
    nb, n = LINALG_CHECK["batch"], LINALG_CHECK["n"]
    rtol = LINALG_CHECK["rtol"]["float32"]
    m = rs.standard_normal((nb, n, n)).astype(np.float32)
    spd = (m @ m.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32))
    rhs = rs.standard_normal((nb, n, 4)).astype(np.float32)
    dn = LINALG_CHECK["det_n"]
    blocks = spd[:, :dn, :dn].copy()
    ops = {"cholesky": (lambda L, A, B, D: (L.cholesky(A),), "plain"),
           "solve": (lambda L, A, B, D: (L.solve(A, B),), "plain"),
           "svd": (lambda L, A, B, D: L.svd(A), "svd"),
           "eigh": (lambda L, A, B, D: L.eigh(A), "eigh"),
           "det": (lambda L, A, B, D: (L.det(D),), "plain")}
    out["linalg"] = {}
    for name, (fn, inv) in ops.items():
        res = {}
        for where, ctx in (("card", gpu), ("cpu", cpu)):
            with ctx:
                A, B, D = mnp.array(spd), mnp.array(rhs), mnp.array(blocks)
                [g.asnumpy() for g in fn(mnp.linalg, A, B, D)]   # warm
                t0 = time.perf_counter()
                got = fn(mnp.linalg, A, B, D)
                host = [g.asnumpy() for g in got]
                res[where] = (host, (time.perf_counter() - t0) * 1e3)
        errs = []
        for u, v in zip(*(_batched_invariant(inv, res[w][0])
                          for w in ("card", "cpu"))):
            e = float(np.abs(u - v).max() / max(np.abs(v).max(), 1e-30))
            errs.append(e)
        if not max(errs) <= rtol:
            raise AssertionError(f"np_surface: np.linalg.{name} card "
                                 f"against CPU {errs} > {rtol}")
        with gpu:
            A, B, D = mnp.array(spd), mnp.array(rhs), mnp.array(blocks)
            syncs = _sync_count(lambda: fn(mnp.linalg, A, B, D))
        out["linalg"][name] = {"relative_err": errs, "rtol": rtol,
                               "card_ms_warm_with_read": res["card"][1],
                               "cpu_ms": res["cpu"][1],
                               "host_syncs": syncs}
    # a boolean mask over a BERT-base activation
    act = rs.standard_normal(s["activation"]).astype(np.float32)
    with gpu:
        a = mnp.array(act)
    mask = a > 0.5
    picked = a[mask].asnumpy()
    if not np.array_equal(picked, act[act > 0.5]):
        raise AssertionError("np_surface: boolean mask read")

    def assign():
        c = a.copy()
        c[mask] = 0.0
        return c

    written = assign().asnumpy()
    if not np.array_equal(written, np.where(act > 0.5, 0.0, act)):
        raise AssertionError("np_surface: boolean mask assignment")
    assign_syncs = _sync_count(assign)
    if assign_syncs:
        raise AssertionError(f"np_surface: the mask assignment synced "
                             f"{assign_syncs}")
    out["boolean_mask"] = {"shape": list(s["activation"]),
                           "selected": int(picked.size),
                           "read_ms": cuda_ms(lambda: a[mask]),
                           "assign_ms": cuda_ms(assign),
                           "assign_host_syncs": assign_syncs}
    # the samplers' first two moments
    moments = {}
    mx.random.seed(0)
    for name, (draw, mean, var) in _NP_MOMENTS.items():
        with gpu:
            d = draw(mnp, (s["draws"],))._data
        got_mean, got_var, se_mean, se_var = _draw_moments(d)
        z = (abs(got_mean - mean) / se_mean, abs(got_var - var) / se_var)
        moments[name] = {"mean": got_mean, "var": got_var,
                         "want": [mean, var], "z": list(z),
                         "dtype": str(d.dtype)}
        if max(z) > s["moment_sigmas"]:
            raise AssertionError(f"np_surface: {name} moments "
                                 f"{moments[name]}")
    out["sampler_moments"] = moments
    return out


def _batched_invariant(kind, outs):
    """:func:`np_case_invariant` over a batch of matrices."""
    if kind == "svd":
        u, sv, vt = outs
        return [sv, np.einsum("bij,bj,bjk->bik", u, sv, vt)]
    if kind == "eigh":
        w, v = outs
        return [w, np.einsum("bij,bj,bkj->bik", v, w, v)]
    return outs


PHASES = ("flash", "serve", "flash_bwd", "opt", "train_check", "train",
          "train_capture", "gluon_hybrid_train", "dropout_capture",
          "int8_gemm", "serve_int8", "capture", "online_update", "decode",
          "twobit",
          "dist_check",
          "dist_train", "resnet_check", "resnet50_v1_train",
          "resnet50_v1_infer_bf16", "resnet50_v1_train_bf16",
          "resnet50_v1_train_bf16_mp", "resnet_check_bf16", "resnet_resume",
          "resnet50_v1_module_fit", "module_check", "transformer_lm",
          "native_io", "imagenet_rec", "lstm_lm_ptb_medium",
          "lstm_ptb_bucketing", "mobilenet_v2_1_0_module_fit",
          "bert_base_sst2_finetune_lamb", "dcgan", "zoo_check",
          "surface_check", "library_ops", "resnet50_v1_module_fit_custom",
          "ssd512_resnet50_v1_module_fit", "bert_base_sst2_finetune_zero",
          "fm_criteo_row_sparse", "sparse_linear_mf", "dist_sparse_async",
          "quantize_mnist", "resnet50_v1_int8",
          "bert_base_sst2_finetune_amp", "bert_base_np_finetune",
          "np_surface")


def _kernel_line(name, source, replaces, launches, err, ms, plain, bound,
                 library, **extra):
    """One kernel's entry of the ``{"kernels": [...]}`` line; ``extra``
    keys (a second bound, device and host times) follow the contract's."""
    return {"name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library, **extra}


# the phase that is running, for the warnings hook (a warning raised on
# autograd's engine thread is charged to the main thread's phase)
_RUNNING = ["startup"]
_WARNED: dict = {}   # phase -> {first line of a warning: times raised}


def _tracked(name, fn):
    def run(*args, **kwargs):
        _RUNNING.append(name)
        try:
            return fn(*args, **kwargs)
        finally:
            _RUNNING.pop()

    run.__name__ = run.__qualname__ = fn.__name__
    return run


def _record_warning(message, category, filename, lineno, file=None,
                    line=None):
    """``warnings.showwarning`` for the run: every warning counted under
    the phase that raised it; the first of each text in a phase printed
    as a ``warning`` line."""
    phase = _RUNNING[-1]
    text = str(message).strip().splitlines()[0][:240]
    seen = _WARNED.setdefault(phase, {})
    seen[text] = seen.get(text, 0) + 1
    if seen[text] == 1:
        emit({"phase": "warning", "during": phase,
              "category": category.__name__, "at": f"{filename}:{lineno}",
              "message": str(message)[:1000]})


def _watch_warnings():
    """Charge each warning of the run to its phase: every ``phase_*``
    function names itself while it runs, and every warning reaches
    :func:`_record_warning` (``always``: a warning the default filter
    would show once per place is counted each time)."""
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("phase_") and callable(fn):
            g[name] = _tracked(name[len("phase_"):], fn)
    warnings.simplefilter("always")
    warnings.showwarning = _record_warning


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--worker", choices=sorted(WORKERS),
                   help="run as one worker process of a dist phase (the "
                        "phase starts these itself)")
    p.add_argument("--out", help="the worker's output directory")
    args = p.parse_args(argv)
    if args.worker:
        return dist_worker(args.worker, args.out)
    phases = set(args.phases.split(","))
    if phases - set(PHASES):
        raise SystemExit(f"unknown phases {sorted(phases - set(PHASES))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products accumulate in float32, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _watch_warnings()
    try:
        return _run(phases)
    except BaseException:
        if _WARNED:
            _emit_warnings()
        raise


def _emit_warnings():
    emit({"phase": "warnings", "by_phase": _WARNED})


def _run(phases):
    dev = phase_device()
    smi = dev["nvidia_smi"]
    phase_build()
    done = {}
    if "native_io" in phases:
        done["native_io"] = phase_native_io()
    if "flash" in phases:
        done["flash"] = phase_flash()
    if "serve" in phases:
        done["serve"], model = phase_serve(smi)
        done["profile"] = phase_profile(model, smi)
        done["profile_eager"] = phase_profile(model, smi,
                                              phase="profile_eager",
                                              eager=True)
        del model  # its weights would count in the train phase's peak
    if "flash_bwd" in phases:
        done["flash_bwd"] = phase_flash_bwd()
    if "opt" in phases:
        done["opt"] = phase_opt()
    if "train_check" in phases:
        done["train_check"] = phase_train_check()
    if "train" in phases:
        done["train"], train_ctx = phase_train(smi)
        if "train_capture" in phases:
            done["train_capture"] = phase_train_capture(smi, **train_ctx)
        weights, xb, yb = (train_ctx[k] for k in ("weights", "xb", "yb"))
        del train_ctx
        torch.cuda.empty_cache()
        if "gluon_hybrid_train" in phases:
            done["gluon_hybrid_train"] = phase_gluon_hybrid_train(
                smi, weights, xb, yb)
        del weights
    elif {"train_capture", "gluon_hybrid_train"} & phases:
        raise SystemExit("the train_capture and gluon_hybrid_train phases "
                         "need the train phase's trainer and weights: run "
                         "them with --phases train,...")
    if "dropout_capture" in phases:
        done["dropout_capture"] = phase_dropout_capture(smi)
    if "int8_gemm" in phases:
        done["int8_gemm"] = phase_int8_gemm()
    if "serve_int8" in phases:
        done["serve_int8"], model, float_model, clf = phase_serve_int8(
            smi, done.get("serve"))
        done["profile_int8"] = phase_profile(model, smi,
                                             phase="profile_int8")
        done["profile_int8_eager"] = phase_profile(
            model, smi, phase="profile_int8_eager", eager=True)
        if "capture" in phases:
            done["capture"] = phase_capture(smi, float_model, model, clf)
        del model, float_model, clf
        torch.cuda.empty_cache()
    elif "capture" in phases:
        raise SystemExit("the capture phase needs serve_int8's models: "
                         "run it with --phases serve_int8,capture")
    if "online_update" in phases:
        done["online_update"] = phase_online_update(smi)
        gc.collect()
        torch.cuda.empty_cache()
    if "decode" in phases:
        done["decode"] = phase_decode()
    if "twobit" in phases:
        done["twobit"] = phase_twobit()
    if "dist_check" in phases:
        done["dist_check"] = phase_dist_check()
    if "dist_train" in phases:
        done["dist_train"] = phase_dist_train(smi)
    if "resnet_check" in phases:
        done["resnet_check"] = phase_resnet_check()
    if "resnet50_v1_train" in phases:
        done["resnet50_v1_train"] = phase_resnet50_train(smi)
    if "resnet50_v1_infer_bf16" in phases:
        done["resnet50_v1_infer_bf16"] = phase_resnet50_infer_bf16(smi)
    if "resnet50_v1_train_bf16" in phases:
        done["resnet50_v1_train_bf16"] = phase_resnet50_train_bf16(smi,
                                                                   False)
    if "resnet50_v1_train_bf16_mp" in phases:
        done["resnet50_v1_train_bf16_mp"] = phase_resnet50_train_bf16(smi,
                                                                      True)
    if "resnet_check_bf16" in phases:
        done["resnet_check_bf16"] = phase_resnet_check_bf16()
    if "resnet_resume" in phases:
        done["resnet_resume"] = phase_resnet_resume()
    if "resnet50_v1_module_fit" in phases:
        done["resnet50_v1_module_fit"] = phase_resnet50_module_fit(
            smi, done.get("resnet50_v1_train"))
    if "module_check" in phases:
        done["module_check"] = phase_module_check()
    if "transformer_lm" in phases:
        done["transformer_lm"] = phase_transformer_lm(smi)
    if "imagenet_rec" in phases:
        done["imagenet_rec"] = phase_imagenet_rec(smi)
    if "lstm_lm_ptb_medium" in phases:
        done["lstm_lm_ptb_medium"] = phase_lstm_lm_ptb_medium(smi)
    if "lstm_ptb_bucketing" in phases:
        done["lstm_ptb_bucketing"] = phase_lstm_ptb_bucketing(smi)
    if "mobilenet_v2_1_0_module_fit" in phases:
        done["mobilenet_v2_1_0_module_fit"] = phase_mobilenet_module_fit(smi)
    if "bert_base_sst2_finetune_lamb" in phases:
        done["bert_base_sst2_finetune_lamb"] = phase_bert_lamb(smi)
    if "dcgan" in phases:
        done["dcgan"] = phase_dcgan(smi)
    if "zoo_check" in phases:
        done["zoo_check"] = phase_zoo_check()
    if "surface_check" in phases:
        done["surface_check"] = phase_surface_check()
    if "library_ops" in phases:
        done["library_ops"] = phase_library_ops()
    if "resnet50_v1_module_fit_custom" in phases:
        done["resnet50_v1_module_fit_custom"] = \
            phase_resnet50_module_fit_custom(smi)
    if "ssd512_resnet50_v1_module_fit" in phases:
        done["ssd512_resnet50_v1_module_fit"] = phase_ssd512_module_fit(smi)
    if "bert_base_sst2_finetune_zero" in phases:
        done["bert_base_sst2_finetune_zero"] = phase_bert_finetune_zero(smi)
    if "fm_criteo_row_sparse" in phases:
        done["fm_criteo_row_sparse"] = phase_fm_criteo(smi)
    if "sparse_linear_mf" in phases:
        done["sparse_linear_mf"] = phase_sparse_linear_mf(smi)
    if "dist_sparse_async" in phases:
        done["dist_sparse_async"] = phase_dist_sparse_async(smi)
    if "quantize_mnist" in phases:
        done["quantize_mnist"] = phase_quantize_mnist(smi)
    if "resnet50_v1_int8" in phases:
        done["resnet50_v1_int8"] = phase_resnet50_int8(smi)
    if "bert_base_sst2_finetune_amp" in phases:
        done["bert_base_sst2_finetune_amp"] = phase_bert_finetune_amp(smi)
    if "bert_base_np_finetune" in phases:
        done["bert_base_np_finetune"] = phase_bert_np_finetune(smi)
    if "np_surface" in phases:
        done["np_surface"] = phase_np_surface(smi)
    _emit_warnings()
    if not set(PHASES) <= set(done):
        print(f"phases run: {sorted(done)}; no result line", flush=True)
        return 1
    fwd, bwd, opt = done["flash"], done["flash_bwd"], done["opt"]
    train, sgd_launches = done["train"], done["train_check"]
    # K3 and K4 run inside the served buckets' CUDA graphs (this slice):
    # their launches are the replays' counts
    cap = done["capture"]
    # this slice: K1, K2, K3 and K3-bwd run inside the training graphs
    # (train_capture's step, gluon_hybrid_train's pair, the ResNet-50
    # steps): their launches per replay beside the run's totals
    tcap = done["train_capture"]["launches_per_replayed_step"]
    hyb = done["gluon_hybrid_train"]["launches_per_step_by_block"][0]
    # this slice: transformer_lm's GPT-2-small step (K2 once over its
    # tensors, K3 and K3-bwd 12 each, causal) and its variants
    lm, lmv = done["transformer_lm"]["gpt2s"], \
        done["transformer_lm"]["variants"]
    lm_tensors = lm["trainable_tensors"]
    # this slice: online_update's served batches (K3) and captured
    # fine-tune steps (K3, K3-bwd, K2) beside the bus and the HTTP traffic
    ou = done["online_update"]["launches"]
    bkt = done["lstm_ptb_bucketing"]
    # this slice: the 20 reported steps of bert_base_sst2_finetune_zero
    fzl = done["bert_base_sst2_finetune_zero"]["launches"]
    # this slice: the AMP fine-tune's launches a step (K3 and K3-bwd in
    # bfloat16, K2) and the attention kernels in bfloat16 at its shape;
    # the int8 convolution's route of K4 (quantize_mnist,
    # resnet50_v1_int8)
    amp_run = done["bert_base_sst2_finetune_amp"]
    amp_step, amp_att = amp_run["launches_per_step"], \
        amp_run["attention_bf16"]
    qm, r8 = done["quantize_mnist"], done["resnet50_v1_int8"]
    # this slice: the np-mode fine-tune's launches a step, hybridized
    npf = done["bert_base_np_finetune"]["launches_per_step"][
        "hybridized_np"]

    def amp_bf16(part, library):
        return {"ms": amp_att["ms"][part],
                "device_ms": amp_att["device_ms"][part],
                "bound_ms": amp_att["bound_ms"][part],
                "bound_by": amp_att["bound_by"][part],
                "library_ms": amp_att["ms"][library],
                "library_device_ms": amp_att["device_ms"][library]}
    lines = [
        _kernel_line("flash_attention", "flash_attention.cu",
                     "mxnet_tpu/kernels/flash.py:38",
                     done["serve"]["flash_launches"],
                     fwd["max_abs_err"], fwd["kernel_ms"], fwd["plain_ms"],
                     (fwd["bound_tc_ms"], fwd["bound_tc_by"]),
                     fwd["library_ms"], bound_f32_ms=fwd["bound_ms"],
                     captured=True, launches_per_replayed_batch=cap[
                         "float32"]["launches_per_replayed_batch"][
                         "flash_attention"],
                     launches_per_replayed_train_step=tcap[
                         "flash_attention"],
                     launches_per_replayed_hybrid_forward=hyb[
                         "flash_attention"],
                     # this slice: transformer_lm at GPT-2-small width,
                     # causal, its launches per replayed step and the
                     # kernel at its shape
                     launches_per_replayed_lm_step=lm[
                         "launches_per_replayed_step"]["flash_attention"],
                     launches_per_replayed_lm_remat_step=lmv["remat"][
                         "launches_per_replay"]["flash_attention"],
                     lm_shape=fwd["lm_shape"],
                     launches_online_update=ou["flash_attention"],
                     # this slice: the fine-tune under zero=True and the
                     # traced served batches of the same phase
                     launches_finetune_zero=fzl["flash_attention"],
                     launches_finetune_zero_served=done[
                         "bert_base_sst2_finetune_zero"]["serving"][
                         "flash_launches"],
                     online_update_batches_and_steps=[
                         done["online_update"]["batches"],
                         done["online_update"]["steps"]],
                     launches_per_step_finetune_amp=amp_step[
                         "flash_attention"],
                     launches_per_step_finetune_np=npf["flash_attention"],
                     bf16_training_shape=amp_bf16("fwd", "library_fwd"))]
    # K3 and K3-bwd run every product on the tensor cores (3xTF32): their
    # bound is the tensor-core one; the float32 rate's stays beside it
    for part in ("dq", "dkv"):
        lines.append(_kernel_line(
            f"flash_attention_bwd_{part}", "flash_attention_bwd.cu",
            "mxnet_tpu/kernels/flash.py:134",
            train[f"flash_attention_bwd_{part}"], bwd["max_abs_err"][part],
            bwd["ms"][part], bwd["ms"][f"{part}_plain"],
            (bwd["bound_ms"][f"{part}_tc"], bwd["bound_by"][f"{part}_tc"]),
            bwd["ms"]["library"], bound_f32_ms=bwd["bound_ms"][part],
            launches_per_replayed_train_step=tcap[
                f"flash_attention_bwd_{part}"],
            launches_per_replayed_hybrid_backward=hyb[
                f"flash_attention_bwd_{part}"],
            launches_per_replayed_lm_step=lm["launches_per_replayed_step"][
                f"flash_attention_bwd_{part}"],
            launches_online_update=ou[f"flash_attention_bwd_{part}"],
            launches_finetune_zero=fzl[f"flash_attention_bwd_{part}"],
            launches_per_step_finetune_amp=amp_step[
                f"flash_attention_bwd_{part}"],
            launches_per_step_finetune_np=npf[f"flash_attention_bwd_{part}"],
            bf16_training_shape=amp_bf16(part, "library_bwd"),
            lm_shape={"ms": bwd["lm_shape"]["ms"][part],
                      "plain_ms": bwd["lm_shape"]["ms"][f"{part}_plain"],
                      "library_ms": bwd["lm_shape"]["ms"]["library"],
                      "bound_tc_ms": bwd["lm_shape"]["bound_ms"][
                          f"{part}_tc"],
                      "bound_ms": bwd["lm_shape"]["bound_ms"][part]}))
    # K1 on this slice's path (resnet50_v1_train: one launch a step over
    # ResNet-50's 193 tensors); its times over the classifier's 197
    # tensors and its train_check and resnet_check launches beside them
    rn = done["resnet50_v1_train"]
    k1, t = rn["k1"], opt["opt_sgd"]
    mp, bf = done["resnet50_v1_train_bf16_mp"], done["resnet50_v1_train_bf16"]
    lines.append(_kernel_line(
        "opt_sgd", "opt_step.cu", "mxnet_tpu/kernels/opt_step.py:114",
        rn["launches"]["opt_sgd"], k1["max_abs_err"], k1["ms"],
        k1["plain_ms"], (k1["bound_ms"], k1["bound_by"]), k1["library_ms"],
        device_ms=k1["device_ms"], host_us=k1["host_us"],
        library_device_ms=k1["library_device_ms"], tensors=k1["tensors"],
        values=k1["values"],
        launches_train_check=sgd_launches["opt_sgd"],
        launches_resnet_check=done["resnet_check"],
        # this slice: the bfloat16 cells (K1 over the float32 masters and
        # BatchNorm tensors with multi_precision, over the BatchNorm
        # tensors alone without), the bfloat16 check and the resume
        launches_resnet50_v1_train_bf16_mp=mp["launches"]["opt_sgd"],
        launches_resnet50_v1_train_bf16=bf["launches"]["opt_sgd"],
        launches_resnet_check_bf16=done["resnet_check_bf16"],
        launches_resnet_resume=done["resnet_resume"],
        # this slice: Module.fit (one launch a batch through the local
        # kvstore's update_multi) and the Module checks
        launches_resnet50_v1_module_fit=done["resnet50_v1_module_fit"][
            "launches"]["opt_sgd"],
        # this slice: Module.fit fed by ImageRecordIter over PNG records
        launches_resnet50_v1_module_fit_rec=done["imagenet_rec"][
            "launches"]["opt_sgd"],
        launches_module_check=done["module_check"],
        # this slice: MobileNet v2's Module.fit (one launch a batch over
        # its 160 tensors); none in the NAG fit, whose _foreach update
        # takes K1's place
        launches_mobilenet_v2_1_0_module_fit=done[
            "mobilenet_v2_1_0_module_fit"]["launches"]["opt_sgd"],
        mobilenet_v2_1_0_batches=done["mobilenet_v2_1_0_module_fit"][
            "batches"],
        launches_mobilenet_v2_1_0_nag_fit=done[
            "mobilenet_v2_1_0_module_fit"]["nag"]["launches"].get(
                "opt_sgd", 0),
        # this slice: Module.fit with MXNet's custom_softmax.py head (the
        # executor uncaptured: the Custom op runs on the host), one launch
        # a batch
        launches_resnet50_v1_module_fit_custom=done[
            "resnet50_v1_module_fit_custom"]["launches"]["opt_sgd"],
        # this slice: SSD-512 on ResNet-50 through Module.fit, one launch
        # a batch over its 231 tensors
        launches_ssd512_resnet50_v1_module_fit=done[
            "ssd512_resnet50_v1_module_fit"]["launches"]["opt_sgd"],
        # this slice: train_imagenet.py under dist_async, one launch per
        # worker's gradients (two a batch on each of two workers), on
        # worker 0; the row-sparse phases' lazy SGD launches none
        launches_resnet50_v1_dist_async=done["dist_sparse_async"][
            "resnet50_v1_dist_async"]["k1_launches"],
        launches_per_batch_resnet50_v1_dist_async=done["dist_sparse_async"][
            "resnet50_v1_dist_async"]["k1_launches_per_batch"][0],
        launches_fm_criteo_row_sparse=done["fm_criteo_row_sparse"][
            "launches"].get("opt_sgd", 0),
        # this slice: quantize_mnist's Module.fit ("sgd", no momentum)
        launches_quantize_mnist_fit=qm["fit_launches"].get("opt_sgd", 0),
        # this slice: one launch per replayed step of each ResNet-50 cell
        launches_per_replay={p: done[p]["captured"][
            "k1_launches_per_replay"] for p in (
                "resnet50_v1_train", "resnet50_v1_train_bf16",
                "resnet50_v1_train_bf16_mp")},
        bf16_mp_in_step=mp["k1_in_step"], bf16_in_step=bf["k1_in_step"],
        bf16_mp_casts={k: mp["casts"][k]["device_ms"] for k in (
            "grad_to_float32", "master_to_bfloat16")},
        bf16_mp_casts_bound_ms=mp["casts"]["bound_ms"],
        classifier_197={k: t[k] for k in (
            "ms", "device_ms", "host_us", "plain_ms", "bound_ms",
            "library_ms", "library_device_ms")}))
    t = opt["opt_adam"]
    lines.append(_kernel_line("opt_adam", "opt_step.cu",
                              "mxnet_tpu/kernels/opt_step.py:131",
                              train["opt_adam"], 0.0, t["ms"], t["plain_ms"],
                              (t["bound_ms"], t["bound_by"]),
                              t["library_ms"], device_ms=t["device_ms"],
                              host_us=t["host_us"],
                              library_device_ms=t["library_device_ms"],
                              launches_per_replayed_train_step=tcap[
                                  "opt_adam"],
                              launches_gluon_hybrid_train_per_step=hyb.get(
                                  "opt_adam", 0),
                              launches_per_replayed_lm_step=lm[
                                  "launches_per_replayed_step"]["opt_adam"],
                              lm_tensors=lm_tensors,
                              launches_online_update=ou["opt_adam"],
                              launches_finetune_zero=fzl["opt_adam"],
                              # this slice: BucketingModule.fit's Adam,
                              # one launch a batch over the buckets' one
                              # set of parameters and states
                              launches_lstm_ptb_bucketing=bkt["launches"][
                                  "opt_adam"],
                              lstm_ptb_bucketing_batches=bkt["batches"],
                              lstm_ptb_bucketing_device_ms_per_batch=bkt[
                                  "k2_device_ms_per_batch"],
                              # this slice: dcgan.py's two gluon.Trainers
                              # (two launches an iteration); none under
                              # "lamb", whose update is plain PyTorch
                              launches_dcgan=done["dcgan"]["launches"].get(
                                  "opt_adam", 0),
                              dcgan_iterations=done["dcgan"]["iterations"],
                              launches_bert_lamb=sum(
                                  b["launches"].get("opt_adam", 0)
                                  for b in done[
                                      "bert_base_sst2_finetune_lamb"][
                                      "blocks"]),
                              bert_adam_update_device_ms=done[
                                  "bert_base_sst2_finetune_lamb"][
                                  "adam_update_device_ms_k2"],
                              launches_per_step_finetune_amp=amp_step[
                                  "opt_adam"],
                              launches_per_step_finetune_np=npf[
                                  "opt_adam"]))
    k4 = done["int8_gemm"]
    lines.append(_kernel_line(
        "int8_gemm", "int8_gemm.cu", "mxnet_tpu/kernels/int8_gemm.py:86",
        done["serve_int8"]["int8_launches"], 0.0, k4["ms"], k4["plain_ms"],
        (k4["bound_ms"], k4["bound_by"]), k4["library_ms"], captured=True,
        launches_per_replayed_batch=cap["bert_base_sst2_int8"][
            "launches_per_replayed_batch"]["int8_gemm"],
        # this slice: the int8 convolution lowered to K4 (im2col, one
        # launch a group): quantize_mnist's int8 score and served batches,
        # resnet50_v1_int8's forward (53 convolutions and the FC)
        launches_quantize_mnist=qm["score_launches"]["int8_gemm"] +
        qm["served"]["launches"]["int8_gemm"],
        launches_resnet50_v1_int8_per_forward=r8["k4_launches_per_forward"],
        resnet50_v1_int8={
            "by_path_per_forward": r8["k4_launches_by_path_per_forward"],
            "device_ms_per_forward": r8["k4_device_ms_per_forward"],
            "products_ms": r8["k4_products"]["ms"],
            "products_device_ms": r8["k4_products"]["device_ms"],
            "bound_ms": r8["k4_products"]["bound_ms"],
            "library_ms": r8["k4_products"]["library_ms"],
            "library_device_ms": r8["k4_products"]["library_device_ms"]}))
    dec = done["decode"]
    lines.append(_kernel_line(
        "decode_attention", "decode_attention.cu",
        "mxnet_tpu/kernels/decode_attention.py:98", dec["launches"],
        dec["max_abs_err"], dec["ms"], dec["plain_ms"],
        (dec["bound_ms"], dec["bound_by"]), dec["library_ms"],
        device_ms=dec["device_ms"]))
    # K6 and K7 on the main path: the multi-tensor compress (one launch
    # per push call) and the decompress (one per pull call); the
    # per-key route's times from the same phase beside them
    # the float16 and bfloat16 variants (fault C4; the per-key path of a
    # half-precision key, which no cell runs) beside them
    half = done["twobit"]["half"]
    for family, part, line, parts in (
            ("twobit_compress_multi", "compress", 73, ("compress",)),
            ("twobit_decompress", "decompress", 102,
             ("decompress_int8", "decompress_int32"))):
        t = done["twobit"][part]
        lines.append(_kernel_line(
            family, "twobit.cu", f"mxnet_tpu/kernels/twobit.py:{line}",
            done["dist_train"][family], 0.0, t["ms"], t["plain_ms"],
            (t["bound_ms"], t["bound_by"]), None, device_ms=t["device_ms"],
            host_us=t["host_us"], per_key_route_ms=t["old_route"]["ms"],
            per_key_route_device_ms=t["old_route"]["device_ms"],
            half_precision={f"{dt}_{p}": half[dt][p] for dt in half
                            for p in parts}))
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
