#!/usr/bin/env python3
"""Run the PyTorch/H100 port (``sparkdl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run it from the repository's tree: it imports the package
``sparkdl_tpu_torch`` that lies beside it and builds the kernels from the
sources there. Alone, without the package, it stops in phase 1 and says so.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. device: the package imports from beside the script; a CUDA card is
   present; its name and power limit (nvidia-smi);
2. build: every kernel of the main path, from the sources in this checkout,
   one nvcc per source, all started together; each kernel's registers and
   spills (none allowed at head_dim 64) and its tensor-core products (HMMA)
   and cp.async copies (LDGSTS) in its SASS (both required in every forward
   and backward instance, and the head_dim 64 instances must be there);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at the test shapes, q/k/v as views
   of one qkv tensor; gradients through the autograd Function against
   autograd of the plain forward; the forward's and the backward kernels'
   split-TF32 products at least 10x closer to the f32 plain version than
   single TF32 products, and their errors and the plain versions' against
   float64;
4. inference slice: ViT-B/16 image-file inference at full width through
   ``TorchImageFileTransformer`` over 64 generated 224x224 images, with
   random weights in the Flax layout carried across by
   ``vit_state_dict_from_flax``; flash rows held to the dense-attention rows
   and to a CPU run on two images; the kernel's launches on that run counted;
   the same in bfloat16 (``ViT(dtype=torch.bfloat16)``), held to the dense
   bfloat16 run, its launches counted and its forward timed;
5. training slice: ``TorchImageFileEstimator.fit`` of ViT-B/16 (10 classes,
   adam, 2 epochs of 2 steps at batch 32) over the same images; the forward
   with lse, dQ and dK/dV launches counted, and the lse-free forward's on
   the fitted transformer's transform; the first step's gradients and the
   four losses held to the dense-attention fit, one step at 2 images to a
   CPU fit; the caller's module unchanged by a fit with the defaults;
6. timing: each kernel, its plain version and the PyTorch library call that
   computes the same function (in float32 and bfloat16), with CUDA events;
   the model forward and the training step with the kernels and with dense
   attention; the inference slice's images/s and the training images/s of a
   second fit;
7. CNN pipeline: the transfer-learning flow of
   ``examples/transfer_learning.py`` at full width,
   ``Pipeline([DeepImageFeaturizer(InceptionV3, 299x299, 2048-d, bfloat16),
   LogisticRegression(maxIter=30)]).fit`` over 128 generated red- or
   blue-dominant image structs in 4 partitions (one of them mixing 96x96 and
   240x320, so it resizes while packing), split 0.75/0.25 with seed 7, then
   ``transform``, the evaluator's accuracy (at least 0.75: the classes are
   apart in any features) and a ``PipelineModel`` save and load that must
   give the same predictions, accuracy and features bit for bit. Random
   InceptionV3 weights in the Flax layout (He-normal, so 94 units keep
   activations of unit order) go in through the converter. The four
   attention kernels' launches are counted over the path and must be none.
   Checks: bf16 features within 3% of the largest float32 feature on the card
   (``CNN_BF16_MAX_REL``: bf16 rounding through 94 units; the CPU tests
   measure 0.9% against Flax's bf16); float32 card features against a CPU
   run of the port at ``SLICE_TOL`` on two one-partition frames of the test
   rows, 4 uniform 96x96 images (uint8, resized in the forward) and 2 96x96
   with 2 240x320 (float32, resized while packing on the card), so that both
   resizes are held against the CPU; the LR head fitted on the
   card against a CPU fit on the same features, each leaf's change in norm
   within ``ADAM_LEAF_RTOL``; the BGR flip folded into the stem against the
   flip in the forward at 1e-4. Timed: the InceptionV3 forward per batch of
   32 in bf16 and float32 and the bf16 forward's share of the bf16 dense
   peak (operations counted from the convolutions' shapes), the
   featurizer's images/s (median of 5 transforms) with its
   ``sparkdl.decode``, ``sparkdl.resize`` and ``sparkdl.forward`` timers,
   and the LR fit.
8. CNN zoo: ``DeepImageFeaturizer`` over phase 7's 128 image structs for
   each of ResNet50, VGG16, VGG19, MobileNetV2 and Xception (224x224;
   Xception 299x299 at the registry's ``middle_width=768``, its Keras-width
   728 tree zero-padded on the way) in bf16 and float32 at batch 32, from
   seeded random weights in the Flax layout (``flax_layout_zoo_params``)
   carried across by the registry's converter; ``DeepImagePredictor`` on
   ResNet50 ("caffe", the flip in the forward) and MobileNetV2 ("tf", the
   flip folded into the stem) with the top-5 decode; Xception at both widths;
   and ``CrossValidator`` over ``Pipeline([DeepImageFeaturizer(modelWeights=
   "random"), LogisticRegression(maxIter=30)])`` with a 2x2 grid over
   ``modelName`` (ResNet50, MobileNetV2) and ``regParam`` (0, 0.01),
   ``numFolds=2``, ``parallelism=2``, on phase 7's 0.75 split. The attention
   kernels' launches over the path must be none. Checks: rows out = rows
   in, the registry's feature widths, finite features not all zero; float32
   card against CPU at ``SLICE_TOL`` on 4 uniform rows and a mixed
   partition; bf16 within ``CNN_BF16_MAX_REL`` of the largest float32
   feature; the predictors' probabilities card against CPU at
   ``PROB_TOL``, summing to 1, 5 decoded entries a row; Xception 728 (the
   tree as it is) against 768 (padded) at ``SLICE_TOL``; the sweep's
   ``avgMetrics`` equal at ``parallelism`` 1 and 2, its best model the
   grid's arg-max, its ``CrossValidatorModel`` saved and loaded giving the
   same predictions and features bit for bit. Timed per model: the forward
   at batch 32 in bf16 and float32, its operations (convolutions, depthwise
   and separable ones, Dense layers) and share of the bf16 dense peak, a
   profile, and the featurizer's images/s; both Xception widths; the sweep.
9. graph layer: InceptionV3 (299x299, 2048-d, float32 and bf16) as a
   ``TorchFunction`` (``from_list`` of the "tf" preprocessor piece, the NCHW
   permute into channels_last, ``from_module`` of the module as the stages
   build it) through ``TFImageTransformer(inputShape=(299, 299),
   channelOrder="RGB")`` over phase 7's 128 image structs (4 partitions, one
   mixed), held to ``DeepImageFeaturizer(InceptionV3)`` on the same weights
   (float32 at ``SLICE_TOL``, bf16 within ``CNN_BF16_MAX_REL``) and, in
   float32, to a CPU run of the port on 4 uniform rows and a mixed partition;
   ``outputMode="image"`` and ``channelOrder="L"`` card against CPU on 4
   rows; ViT-B/16 (224x224, ``attn_impl="flash"``, float32) as a function
   over 64 image structs, its 24 forward-kernel launches counted, held to the
   same function with dense attention; both float32 functions exported
   (``torch.export``, the batch a ``Dim``), saved, loaded and run again,
   each against its in-memory function at ``SLICE_TOL``, the loaded ViT
   program holding 12 flash-attention op nodes and launching the kernel 24
   times; ``TFTransformer`` mapping the 2048-d feature column through a
   two-output function (logits and softmax) at batch 32, against float64
   numpy; a ``PipelineModel([TFImageTransformer, TFTransformer])`` over the
   loaded functions saved and loaded, giving the same columns bit for bit.
   Timed: the export and load, the loaded programs' forward at batch 32
   against the in-memory functions', and ``TFImageTransformer`` images/s
   (bf16 function, median of 5) beside the featurizer's, with the
   ``sparkdl.*`` timers.
10. Keras half of the graph layer: InceptionV3's Keras config
   (``tests/torch_fixtures/keras_inception_v3.config.json.gz``, 313 layers,
   23.85 M weights) with seeded weights drawn as phase 7's, written as a
   ``.keras`` file by the port's own writer (no Keras, no ``h5py``), and a
   2048 -> 10 softmax head file; ``TorchFunction.from_keras`` of the file in
   float32 and bf16; ``KerasImageFileTransformer`` over 128 ``.npy`` files of
   299x299x3 floats (``np.load`` and the "tf" ``preprocess_input``) in 4
   partitions at batch 32, float32 and bf16; ``registerKerasImageUDF`` with
   ``session.sql("SELECT inception_udf(image) AS preds FROM images")`` over
   phase 7's 128 image structs; ``KerasTransformer`` and ``makeGraphUDF``
   over the head on phase 7's float32 features. Checks: rows out = rows in;
   the float32 function's probabilities against the registry's hand-written
   InceptionV3 on the same weights (read from the file through
   ``port_keras_weights``) on one preprocessed 299x299 batch at
   ``PROB_TOL``, and against a CPU run of the port on 4 images at
   ``SLICE_TOL``; bf16 within ``CNN_BF16_MAX_REL`` of the largest float32
   probability (function and stage); the stage's rows against the function
   on the same batch; the UDF's rows against the function on the same
   decoded, resized batch; the head's against float64 numpy; the function
   exported, saved and loaded; a saved ``KerasImageFileTransformer`` whose
   model file was removed giving the same rows bit for bit; no attention
   kernel launched. Timed: the file's write, read and build; the forward
   at batch 32 in float32 and bf16 beside the registry module's; a profile
   of the bf16 forward, and the host's time by operator in it beside the
   registry module's; the stage's and the UDF's images/s (bf16, median of
   5) beside the featurizer's.
11. Keras fine-tune (BASELINE.json ``configs[3]``): the configuration
   ``benchmarks/bench_finetune.py`` measures, ``Sequential([ResNet50(
   include_top=False, pooling="avg", 224x224x3), Dense(5, softmax)])``
   (``tests/torch_fixtures/keras_resnet50_head.config.json.gz``, a nested
   Functional, 23,597,957 weights) with seeded weights, written as a
   ``.keras`` file by the port's writer. Checks: one sgd(0.01) step at
   batch 64 (sparse categorical cross-entropy) on the card and on the CPU,
   TF32 off, each held to a float64 step on the CPU (the two CPU steps run
   in a child process at the lowest CPU priority beside phases 7-11, and
   are held last; the loss within 1e-4;
   each leaf's change within 1e-3 of the float64 change or within 3x the
   CPU float32 step's own error; the moving statistics card against CPU at
   ``atol=1e-5, rtol=1e-4``); the stepped weights written by
   ``write_keras_file`` read back bit for bit; a step with the base's
   ``trainable: false`` leaves all its weights and moving statistics bit for
   bit and moves the head; ``KerasImageFileEstimator.fit`` over 128
   generated 224x224 ``.npy`` files (epochs 1, batch 64) returns a
   ``KerasImageFileTransformer`` on a tuned file whose weights moved, whose
   scores on the card are finite rows summing to 1; ``fitMultiple`` over a
   ``ParamGridBuilder`` grid of two learning rates on 32 images gives two
   models on two files; no attention kernel launched. Timed: the step as
   ``bench_finetune.py`` times it (2 warm steps, then 10 chained and
   synchronized once, the median of 3, CUDA events) under PyTorch's default
   TF32 setting (cuDNN convolutions in TF32) and with TF32 off, beside its
   bound from the shapes; a profile of one step (device busy, idle share,
   kernels); the fit's images/s with ``sparkdl.load`` and ``estimator.step``;
   the fitted transformer's images/s; the sweep's seconds a fit and each
   model's training accuracy by argmax.

12. the estimators' remainder. (a) ViT-B/16 at full width (phase 5's
   setup: 64 generated 224x224 images, 10 classes, adam, batch 32, 2 steps
   an epoch): two uninterrupted ``fit(epochs=2)`` compared bit for bit
   first (if they differ, deterministic algorithms go on and the two must
   then agree, and every later comparison of (a) runs under them);
   ``fit(epochs=1)`` with a ``checkpointDir``, then a fresh estimator's
   ``fit(epochs=2)`` on the directory, which must log its resume from epoch
   1, equal the uninterrupted fit bit for bit (weights and last loss) and
   launch the forward with lse, dQ and dK/dV 24 times each (12 blocks x 2
   steps); its fitted transformer's transform launches the lse-free forward
   24 times; ``fit(epochs=1)`` again returns epoch 1's weights bit for bit
   with no launch; a fit under ``FaultPlan().add("estimator.step",
   preempt=True, at=3)`` raises ``Preempted`` with epoch 1 alone committed,
   and the re-fit equals the uninterrupted fit. (b) The ResNet50 head of
   phase 11 over 128 ``.npy`` files at batch 64, sgd: the same determinism
   check; a ``streaming=True`` fit equal to the in-memory fit bit for bit;
   fit(1) with a checkpoint then fit(2) equal to the uninterrupted fit; for
   each of rmsprop, adagrad, nadam, lamb and lion, three updates of the
   head's 23.5 M trainable weights with seeded gradients on the card and on
   the CPU within ``OPT_CHANGE_RTOL`` of the largest change, then a fit with
   it (finite losses, moved weights); no attention kernel launched over (b).
   Timed: each save's dispatch and background commit, the bytes an epoch,
   the restore, the step time of a checkpointed fit beside the
   uncheckpointed one's, the in-memory and streaming fits' images/s with
   ``sparkdl.load``, ``sparkdl.load_wait`` and ``estimator.step``. The
   checkpoints go to a temporary directory, removed afterwards.
13. the ported paths' remainder. (a) ViT-B/16 fine-tuning in bfloat16
   (``ViT(dtype=torch.bfloat16)``, phase 5's setup: 64 generated 224x224
   images, 10 classes, adam, 2 epochs of 2 steps at batch 32): the first
   step's gradients held to the dense-attention bf16 ones and, at 2 images,
   to a CPU bf16 run, each tensor within ``BF16_FIT_GRAD_RTOL`` of its norm
   (the share of elements outside ``BF16_GRAD_TOL`` printed beside); the
   fit's forward with lse, dQ and dK/dV launches counted (48 each), its
   float32 weights and gradients, its losses within ``BF16_TOL`` of the
   dense bf16 fit's; one step at 2 images, card against CPU, by loss
   (``BF16_TOL``) and the stepped model's rows (``BF16_SLICE_TOL``). Timed:
   the bf16 step on a resident batch beside the dense bf16 step and phase
   5's float32 step, a profile of it, and the same step with Python's
   cyclic collector off. (b) The fitted bf16 transformer saved and loaded,
   and a ``PipelineModel`` holding it: rows bit for bit equal to the
   in-memory transformer's, the loaded one launching the lse-free forward
   24 times; timed save and load. (c) Its weights through ``export_vit_npz``
   and ``port_vit_npz``: the same ``state_dict`` and rows bit for bit.
   (d) ``DeepImageFeaturizer(InceptionV3, modelWeights="imagenet")`` under
   a temporary ``HOME`` whose Keras cache holds phase 10's InceptionV3
   weights as Keras's weights-only ``.h5`` (written by the port, no Keras,
   no ``h5py``): features bit for bit equal to the registry module's on the
   same weights, no attention launch. (e) ``DeepImageFeaturizer``,
   ``KerasImageFileTransformer`` and the bf16 ViT transformer at
   ``SPARKDL_DISPATCH_DEPTH`` 0-3 and under ``SPARKDL_SERIAL_INFERENCE=1``,
   over frames of 4 partitions (one chunk a call) and of 1 partition: the
   same bytes in every mode; images/s over 2 rounds (``P13_DEPTH_ROUNDS``)
   that take the modes in turn, with ``sparkdl.load``, ``sparkdl.decode``, ``sparkdl.forward``,
   ``sparkdl.serve`` and ``data.device_stall_ms``.
14. the engine and online serving, in a temporary compile-cache directory.
   Its AOTInductor programs ((a)'s slot block, (c)'s, (d)'s ladder) are
   compiled by a second process (``ServingPrecompile``, at the lowest CPU
   priority, started after phase 6, so that its minutes of compiling run
   beside phases 7-12); this process loads them.
   (a) ViT-B/16 in bf16 (phase 5's seeded weights, flash attention) served
   through ``ModelServer.from_torch_function`` with
   ``ServingConfig(max_batch=32, max_wait_ms=2)`` and a durable
   fingerprint: the second process's ``warmup()`` compiles the slot-block
   program with AOTInductor (``ExecutionEngine``), this one's loads it,
   then 256 single 224x224 images from 16 threads. Checks: each row within
   3% of the largest value of the float32 plain forward (dense attention,
   one image at a time); ``serving.compiles`` unchanged after warmup; at
   most 64 blocks; the lse-free forward launched 12 times a dispatched
   block. (b) The warm start: this process's warmup loaded the package from
   disk (``engine.cache_hit``, no ``engine.compile``), and the loaded
   program's output on one full block equals the compiling process's bit
   for bit. (c) Phase 10's ``.keras`` InceptionV3 through
   ``registerKerasImageUDF`` and ``ModelServer.from_registered_udf``, 128
   299x299 image structs decoded by the client, from 8 threads: the
   program loaded from disk, not compiled; rows against the UDF's SQL rows
   and the plain forward at ``SLICE_TOL``, no attention launch. (d)
   ``SPARKDL_RAGGED=0`` on the ViT endpoint at ``max_batch=4``: the
   ladder's three programs loaded (compiled by the second process), 32 requests from 4
   threads held as in (a), and 3 requests at once (tried until one batch
   pads: bucket 4 with a pad row) held the same; then 16 decode streams of 4-16 steps admitted
   mid-flight into 8 slots of a torch step compiled through the engine,
   each equal to its closed form. (e) The InceptionV3 UDF endpoint's
   compiled slot-block program called straight through
   ``ExecutionEngine.program`` (a memory hit: no batcher, no compile) with
   the Keras model's kernels in their own non-contiguous layout: rows
   within ``SLICE_TOL`` of the plain forward (the engine's runner makes
   every tensor leaf contiguous). Timed: each warmup (compile or load),
   requests/s and p50/p99 latency per endpoint, the decode run; measured:
   the card memory of the ViT endpoint's weights, of its slot-block
   program and of the ladder's three programs, and the package's size.
15. the data pipeline and streaming inference, while phase 14's ViT
   endpoint is still open. (a) Phase 4's 64 images as ``.npy`` files
   through ``Dataset.from_files -> map(np.load, 8 workers) -> batch(32,
   cyclic) -> prefetch -> prefetch_to_device`` (pinned buffers, a
   side-stream copy) into the eager bf16 flash ViT-B/16 (phase 5's
   weights): rows bit for bit those of the same batches placed with
   ``.to()``, 12 launches of #1 a batch; images/s of both in turns and
   ``data.device_stall_ms``. (b) ``StreamRunner.from_server`` over the
   endpoint: phase 14's 256 images from a ``QueueSource`` in micro-batches
   of 32 into a ``JsonlSink``, tracing on: every offset once, each row
   within 3% of the float32 plain forward's largest value, no compile, 12
   launches a served block, the run's poll, epoch and commit spans and
   the request and batch spans, ``metrics_text()`` with the ``serving.*``
   and ``streaming.*`` series; records/s, the epochs and
   ``streaming.record_latency_ms``. (c) Exactly once on the card: a worker
   process scores ``FileTailSource`` records of the 64 URIs with the eager
   ViT, uninterrupted; another, beside it, is killed by a
   ``SPARKDL_FAULT_PLAN`` rule at ``streaming.commit`` 2 (exit 9) and
   restarted: each offset once, the
   replayed epoch bit for bit its payload, rows within the bf16 bound of
   the uninterrupted run; then an in-process preemption
   (``request_preemption``) flushes and a second runner resumes.
16. the replica plane, still inside phase 14. (a) ``ReplicaSupervisor``
   spawns two replica processes from
   ``ReplicaSpec(factory="chip_smoke:vit_replica_server")``: each builds
   ``ModelServer()`` on the card with an eager bf16 flash ViT-B/16 (phase
   5's weights, ``max_batch=32``) and phase 14 (d)'s decode step in 8
   slots, and raises unless its first block launched #1 12 times; tracing
   on in the router and the replicas. (b) Phase 14's 256 images through
   ``router.route`` from 16 threads: rows within 3% of the float32 plain
   forward's largest value, both replicas served (the spans' per-replica
   counts); requests/s and p50/p99 beside phase 14 (a)'s. (c) The images
   again with 16 decode streams of 4-16 steps, replica 0 SIGKILLed a third
   of the way: every request answered within the bound, every stream its
   closed form (a stream torn by the kill fails typed and is sent again),
   replica 0 back at a higher generation, then 32 requests served by both;
   the kill-to-live time. (d) SIGTERM of replica 1 with requests in flight:
   every request answered, the replica exits 0, then revived. (e)
   ``start_telemetry()``: each replica's ``/healthz`` and ``/metrics``, the
   fleet collector's merged series, ``/slo``. (f) 64 images on the other
   wire lane (shm or tcp) through a second router. ``diagnose_paths`` over
   the router's and the replicas' span files attributes (b)'s latency.
17. rollout and parallelism. (a) Inside phase 16's supervisor, before it
   closes: ``RolloutController`` deploys v2 (one replica of the bf16 ViT-B/16
   with seed-3 weights) beside the two v1 replicas, shifts the router's
   weights through 25%, 50%, 100% with 3 s bakes on phase 16 (e)'s SLO
   engine (``rollout_slos("v2")``) while 8 client threads keep sending,
   promotes and drains v1; then v3 (seed-2 weights) rolls back on an
   ``inject`` rule at ``rollout.bake``. Every answer within the bf16 bound of
   one seed's float32 rows, those sent after the promotion and after the
   rollback v2's, none lost; the spawn, shift, promotion, detection and
   rollback seconds, the ``rollout.*`` metrics. (b) In a child process (no
   process that touched CUDA forks), an NCCL process group of one on the
   card (``runner.initialize()``): the bf16 ViT-B/16 fit of phase 5's
   weights without the group and with it (DP), with
   ``shardingRules=VIT_TP_RULES, meshShape=(1, 1)`` and with
   ``attn_impl=pad_tokens_for_sp(mesh, impl="ulysses-flash")`` (#2-#4 12 a
   step, through Ulysses' all-to-alls for the last): each fit's losses and
   weights equal to the fit without the group bit for bit, the Ulysses-flash stage's transform (#1 12 a batch) against
   the flash stage of the same weights, ``ring`` and ``ulysses`` at one rank
   against ``full_attention`` (float32, ``F32_TOL``), and a
   ``CrossValidator(partitionDevices=True)`` sweep with one slice against the
   unpartitioned one; each fit's step ms. The child prints its launch counts,
   which join the kernel records (``phase17_launches``).
18. SQL and continuous SQL, inside phase 14 after phase 16, on phase 14's
   256 images: phase 5's weights as an eager bf16 flash ViT-B/16 endpoint
   ``vit_top`` on a new ``ModelServer`` (``compile=False``: one scalar a
   row, the largest logit), registered before any query binds, and a
   registered UDF ``vit_top`` that scores through it (its function in
   ``session.sql``, its ``_serving_endpoint`` hook in a continuous query).
   (a) ``SELECT id, label, vit_top(image) AS s FROM frames`` into a view,
   then one query: a JOIN with a 4-row labels view over a derived table
   ranked by ``ROW_NUMBER() OVER (PARTITION BY label ORDER BY s DESC)``,
   ``WHERE rk <= 16``, ``GROUP BY``, ``HAVING``, ``ORDER BY``: keys and
   counts exact, each label's max, mean and least of its top 16 within the
   bf16 bound (3% of the largest value) of numpy's over the float32 plain
   forward. (b) ``session.sqlStream`` of ``count``, ``max`` and ``p95`` of
   ``vit_top(image)`` over ``GROUP BY WINDOW(ts, '2s'), label`` on a
   ``QueueSource`` of the images (ts = 50 ms x i) and 2 late records,
   traced: each closed window once with exact counts, ``top`` and ``p95``
   within the bf16 bound of numpy's, the late rows in the side output and
   ``csql.late_rows``, the ``csql.query``, ``csql.window_close`` and
   ``csql.recover`` spans; records/s and ``csql.emit_latency_ms`` p50/p99.
   #1 launches 12 a served block in (a) and (b); ``serving.compiles`` does
   not move. (c) Worker processes (``P18_WORKER``, fresh interpreters) run
   the query over a ``FileTailSource`` of image indices into 64 images on
   the card: uninterrupted (its windows against numpy's), killed at
   ``streaming.window_commit`` and restarted (the replayed epoch's lines
   equal its payload bit for bit, every window once, within the bf16 bound
   of the uninterrupted run), killed at ``csql.plan`` (nothing left behind);
   the three first runs side by side, the restart after its kill.
   (a)'s and (b)'s launches join the kernel records (``phase18_launches``).
19. the C++ batch packer, inside phase 13 (``batch_packer``'s docstring).
20. the native second stack, last (after phase 17 (b)): (a) the C++
   AOTInductor runner library (``native/aoti_runner.cpp``) and
   ``aoti_tool`` build from the checkout's sources; (b)
   ``export_featurizer`` exports phase 7's InceptionV3 weights in bf16 at
   batch 32 from 299x299 sources for the card (compile s, package and
   ``params.bin`` MiB); (a) and (b) run in a child process at nice 19,
   started after phase 6, so that the compile runs beside phases 7-12,
   and joined before phase 13
   (``NativeExport``); (c)
   ``NativeDeepImageFeaturizer`` over 128 299x299 rows against the Python
   bf16 ``DeepImageFeaturizer`` within ``CNN_BF16_MAX_REL`` of the largest
   float32 feature, and over phase 7's frame (resized on the card, rounded
   to uint8) against the Python stage given the same rounded rows, rows
   in order; (d) ``aoti_tool`` in a fresh process over the same batches,
   against (c)'s rows at the bound, bit for bit or not, its load s beside
   the in-process runner's and ``aoti_load_package``'s; (e) ``stream()``
   bit for bit a loop of ``__call__``; (f) both stages' images/s on both
   frames; (g) no attention launch (``phase20_launches``).
21. the fleet simulator and the profiler, last (after phase 20). (a) Phase
   16 (b)'s 256 routed requests as replay records (``records_from_spans``
   over the router's span file), written with ``write_trace`` and loaded
   back: one record a request, each with a ``forward`` phase, every phase a
   replayed or emergent one; replayed (``FleetReplay``) twice under the live
   fleet's knobs (2 replicas, ``max_batch=32``, ``max_wait_ms=2``, queue 256,
   seed 0) to one event log (its sha256 printed) whose times never
   decrease, every request counted; ``tune(budget=8, seed=0)`` twice to one
   artifact. Printed: virtual and wall seconds, the fidelity rows (live
   against replayed p50/p99 at 15% or 0.25 ms: a reading, since a
   closed-loop burst replays open loop) and the tuned knobs' burn against
   the default's. (b) In a child process (a capture late in a long process
   loses its first kernels: PERF.md §6), ``SPARKDL_PROFILE_DIR`` set
   for a transform of 32 images through the bf16 InceptionV3
   ``DeepImageFeaturizer``, then for 32 through the bf16 flash ViT-B/16
   ``TorchImageFileTransformer`` (seeded random weights): each
   directory holds a ``torch.profiler`` trace with CUDA kernel events, the
   ViT trace's ``flash_fwd_kernel`` events equal the wrapper's count (12),
   the featurizer's trace holds convolution kernels and no flash kernel, the
   profiled rows equal the unprofiled ones bit for bit; each trace's kernel
   count, kernel time and five costliest kernels printed
   (``phase21_launches``).

The last lines are the card's name and power limit, one JSON object of
kernel records, and ``{"ok": true, "device": {...}}``. Float32 matrix
products and convolutions run in full float32 (TF32 off) throughout, but
for phase 11's timing under the library's default.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): float32 on
# the CUDA cores, bf16 on the tensor cores, float32 done as split TF32 on the
# tensor cores (three TF32 products per f32 product at 495 TFLOP/s), and HBM3.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "split_tf32": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12

F32_TOL = dict(atol=2e-4, rtol=2e-4)    # tests/test_ops.py's flash tolerance
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)   # tests/test_ops.py's flash-gradient tolerance
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output rounding
# bf16 gradients: one bf16 rounding of the value (the kernels accumulate in
# float32 as the plain backward does, and round once at the store)
BF16_GRAD_TOL = dict(atol=1e-3, rtol=8e-3)
SLICE_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
# bf16 ViT-B/16 rows, flash against dense attention, both bf16 on the card:
# the flash kernel keeps scores, P and the sums in float32 and rounds once at
# its output, the dense path rounds its scores and probabilities to bf16, so
# the two part by bf16 roundings (2**-9) compounded through 12 blocks:
# tests/test_torch_vit.py's bf16 bound, about 50 roundoffs at unit scale plus
# 2% of the value
BF16_SLICE_TOL = dict(atol=0.1, rtol=2e-2)
# flash vs dense training on the card, both float32: each gradient tensor to
# 1e-4 of its norm (of at least 1e-3 of the largest norm: the key bias's
# gradient is exactly zero, so float noise); the losses of 4 adam steps to
# 1e-4 relative (adam turns float noise in near-zero gradients into weight
# moves of up to lr); the weights as check_adam_step says, each leaf's change
# to 1e-2 of its norm
GRAD_NORM_RTOL = 1e-4
LOSS_RTOL = 1e-4
ADAM_LEAF_RTOL = 1e-2

# the CNN pipeline (phase 7): bf16 InceptionV3 features against float32 ones
# on the card, within 3% of the largest feature: the bf16 run rounds each
# conv, BN and pool output to bf16 (2**-9) through 94 units. Measured: 0.47%
# on an H100 at these inputs; the port's bf16 module against Flax's bf16 on
# the CPU, 0.9% at 75x75 (tests/test_torch_inception.py)
CNN_BF16_MAX_REL = 3e-2
# the BGR flip folded into the stem against the flip in the forward, both
# float32: the same sums in the stem's other channel order, float rounding
# (tests/test_models.py's Keras-oracle bound)
CNN_FOLD_TOL = dict(atol=1e-4, rtol=1e-4)
# a float32 predictor's probabilities, card against CPU: the logits'
# float32 roundoff (~1e-6 of each) carried through the softmax, relative to
# each probability (1000 classes average 1e-3, so SLICE_TOL's absolute 5e-4
# would hide an error of half a typical value)
PROB_TOL = dict(atol=1e-6, rtol=1e-4)
# red- against blue-dominant images, linearly apart in any features: the
# fitted head must do better than chance
CNN_MIN_ACCURACY = 0.75
CNN_IMAGES = 128
CNN_BATCH = 32

VIT_SHAPE = (32, 197, 12, 64)  # ViT-B/16 at 224, batch 32: (b, s, h, d)
N_IMAGES = 64
BATCH = 32
N_CLASSES = 10
TRAIN_LR = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


_STARTED = time.perf_counter()
_STARTED_EPOCH = time.time()


def mark(phase: str) -> None:
    """Log the script's seconds so far at the end of ``phase``."""
    log(f"time: {phase} ended at {time.perf_counter() - _STARTED:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype_name: str, products: int = 2,
                       tensors: int = 4, rows: int = 0, rate: str = None):
    """Least time for one attention kernel: the larger of its bytes over HBM
    bandwidth and its operations over the peak rate for the type (or for
    ``rate``, a key of PEAK_FLOPS).

    ``products`` (b*h) x (s x s x d) matrix products of 2*s^2*d operations
    each; ``tensors`` (b, s, h, d) tensors in the input type and ``rows``
    (b, h, s) float32 vectors each read or written once. The forward: QK^T
    and PV, q/k/v read and o written (2, 4, 0). dQ: QK^T, dO V^T, dS K, with
    q/k/v/dO read, dQ written, lse and delta read (3, 5, 2). dK/dV: QK^T,
    dO V^T, P^T dO, dS^T Q, with q/k/v/dO read, dK and dV written, lse and
    delta read (4, 6, 2)."""
    b, s, h, d = shape
    itemsize = 4 if dtype_name == "float32" else 2
    nbytes = tensors * b * s * h * d * itemsize + rows * b * h * s * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = products * 2 * b * h * s * s * d / PEAK_FLOPS[rate or dtype_name] * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def fused_qkv(shape, dtype, seed):
    """One random (b, s, 3*h*d) projection on the card."""
    import torch

    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)


def views(fused, shape):
    return [t.reshape(shape) for t in fused.chunk(3, dim=-1)]


def qkv_views(shape, dtype, seed):
    """q, k, v as views into one fused projection, as ViT passes them."""
    return views(fused_qkv(shape, dtype, seed), shape)


def cotangent(shape, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_backward(shape, dtype, kwargs, seed):
    """The backward kernels, reached through the autograd Function with q/k/v
    as views of one qkv leaf, against flash_attention_bwd_reference on the
    same inputs, out and lse; and, in float32, against autograd through the
    plain forward. Returns the max abs errors of (dQ, dK, dV)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    fused = fused_qkv(shape, dtype, seed)
    q, k, v = views(fused, shape)
    do = cotangent(shape, dtype, seed)
    leaf = fused.clone().requires_grad_()
    flash_attention(*views(leaf, shape), **kwargs).backward(do)
    got = views(leaf.grad, shape)
    # the plain backward from the kernel's own out and lse, as the Function saves them
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, **kwargs)
    torch.cuda.synchronize()
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    errs = []
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **tol)
        errs.append((g.float() - w.float()).abs().max().item())
    line = (f"  {str(dtype):15s} {str(shape):20s} {str(kwargs):16s} "
            f"dq/dk/dv max_abs_err={errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
    if dtype == torch.float32:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(
            flash_attention_reference(*leaves, **kwargs), leaves, do
        )
        auto_err = 0.0
        for g, w in zip(got, auto):
            torch.testing.assert_close(g, w, **GRAD_TOL)
            auto_err = max(auto_err, (g - w).abs().max().item())
        line += f"; vs autograd of plain forward {auto_err:.3e}"
    log(line)
    return errs


def check_split_tf32(shape, seed):
    """The backward kernels compute each f32 product as three TF32 products
    (operands split in a TF32 value and its TF32 remainder). With inputs x4
    (a peaked softmax) their gradients must be at least 10x closer to the
    f32 plain backward than that plain backward run with TF32 products.
    Returns the kernels' max abs errors of (dQ, dK, dV)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
    )

    fused = fused_qkv(shape, torch.float32, seed) * 4
    q, k, v = views(fused, shape)
    do = cotangent(shape, torch.float32, seed)
    leaf = fused.clone().requires_grad_()
    flash_attention(*views(leaf, shape)).backward(do)
    got = views(leaf.grad, shape)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = flash_attention_bwd_reference(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = []
    for name, g, w, one in zip("qkv", got, want, single):
        err = (g - w).abs().max().item()
        single_err = (one - w).abs().max().item()
        log(f"  d{name}: kernels {err:.3e}, plain backward in TF32 {single_err:.3e} "
            f"({single_err / max(err, 1e-30):.0f}x)")
        if not 10 * err <= single_err:
            raise AssertionError(f"d{name}: split-TF32 error {err:.3e} is not 10x "
                                 f"under single TF32's {single_err:.3e}")
        errs.append(err)
    return errs


def check_split_tf32_forward(shape, seed):
    """The forward kernel computes each f32 product as three TF32 products.
    With inputs x4 (a peaked softmax) its output and lse must be at least
    10x closer to the f32 plain forward than that plain forward run with
    TF32 products. Returns the kernel's max abs errors of (out, lse)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = views(fused_qkv(shape, torch.float32, seed) * 4, shape)
    got = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_reference(q, k, v, return_lse=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = flash_attention_reference(q, k, v, return_lse=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = []
    for name, g, w, one in zip(("out", "lse"), got, want, single):
        err = (g - w).abs().max().item()
        single_err = (one - w).abs().max().item()
        log(f"  {name}: kernel {err:.3e}, plain forward in TF32 {single_err:.3e} "
            f"({single_err / max(err, 1e-30):.0f}x)")
        if not 10 * err <= single_err:
            raise AssertionError(f"{name}: split-TF32 error {err:.3e} is not 10x "
                                 f"under single TF32's {single_err:.3e}")
        errs.append(err)
    return errs


def forward_float64_errors(shape, seed):
    """The forward kernel and the plain f32 forward against a float64
    forward of the same f32 inputs: the output's relative error in norm and
    its bias (the mean error along the sign of each value, over the mean
    magnitude: below 0 where the output shrinks), the lse's max abs error
    and its mean error, for each. Logged, not held to a limit."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = qkv_views(shape, torch.float32, seed)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q64 * shape[3] ** -0.5, k64)
    lse64 = torch.logsumexp(logits, dim=-1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(logits - lse64[..., None]), v64)
    errs = {}
    for name, (out, lse) in (("kernel", flash_attention(q, k, v, return_lse=True)),
                             ("plain f32", flash_attention_reference(q, k, v, return_lse=True))):
        diff, lse_diff = out.double() - out64, lse.double() - lse64
        errs[name] = ((diff.norm() / out64.norm()).item(),
                      ((diff * out64.sign()).mean() / out64.abs().mean()).item(),
                      lse_diff.abs().max().item(), lse_diff.mean().item())
        log(f"  {name}: out relative error {errs[name][0]:.3e}, bias {errs[name][1]:.3e}; "
            f"lse max abs error {errs[name][2]:.3e}, mean error {errs[name][3]:.3e}")
    return errs


def float64_errors(shape, seed):
    """The backward kernels and the plain f32 backward against a float64
    backward of the same f32 inputs (its own softmax, out and delta):
    relative errors in norm of (dQ, dK, dV) for each. Logged, not held to a
    limit: it shows how near f32 the split-TF32 products come."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
    )

    q, k, v = qkv_views(shape, torch.float32, seed)
    do = cotangent(shape, torch.float32, seed)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    out, lse = flash_attention(q, k, v, return_lse=True)
    plain = flash_attention_bwd_reference(q, k, v, out, lse, do)
    scale = shape[3] ** -0.5
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q64 * scale, k64), dim=-1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", p, v64)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64)
    ds = p * (dp - (do64 * out64).sum(-1).transpose(1, 2)[..., None])
    exact = (torch.einsum("bhqk,bkhd->bqhd", ds, k64) * scale,
             torch.einsum("bhqk,bqhd->bkhd", ds, q64 * scale),
             torch.einsum("bhqk,bqhd->bkhd", p, do64))
    errs = {name: [((g.double() - w).norm() / w.norm()).item() for g, w in zip(grads, exact)]
            for name, grads in (("kernels", got), ("plain f32", plain))}
    for name, e in errs.items():
        log(f"  {name}: dq/dk/dv relative error {e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e}")
    return errs


def check_kernel(shape, dtype, kwargs, seed):
    """Kernel vs plain version on the card; returns the max abs errs of the
    output and of the lse."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = qkv_views(shape, dtype, seed)
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    log(f"  {str(dtype):15s} {str(shape):20s} {str(kwargs):16s} "
        f"max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}")
    return err, lse_err


def flax_layout_vit_params(seed: int, classes: int = 1000):
    """Random ViT-B/16 weights in the Flax layout (kernels (in, out), conv
    HWIO, LayerNorm scale/bias), scaled like Flax's initialisers so the
    activations stay of unit order; the head has ``classes`` outputs."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in ** -0.5),
                "bias": normal((n_out,), 0.02)}

    def norm(dim):
        return {"scale": 1.0 + normal((dim,), 0.1), "bias": normal((dim,), 0.1)}

    patch, dim, depth, mlp = 16, 768, 12, 3072
    params = {
        "patch_embed": {"kernel": normal((patch, patch, 3, dim), (patch * patch * 3) ** -0.5),
                        "bias": normal((dim,), 0.02)},
        "cls_token": normal((1, 1, dim), 0.02),
        "pos_embed": normal((1, 197, dim), 0.02),
        "ln_final": norm(dim),
        "head": dense(dim, classes),
    }
    for i in range(depth):
        params[f"block_{i}"] = {
            "ln_1": norm(dim), "qkv": dense(dim, 3 * dim), "proj": dense(dim, dim),
            "ln_2": norm(dim), "mlp_up": dense(dim, mlp), "mlp_down": dense(mlp, dim),
        }
    return {"params": params}


def load_npy(uri):
    return np.load(uri)


def run_slice(image_dir: Path, state_dict, attn_impl: str, device: str, uris=None,
              dtype=None):
    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.sql.session import TorchSession

    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="features", imageLoader=load_npy,
        module=ViT(variant="ViT-B/16", attn_impl=attn_impl, dtype=dtype),
        state_dict=state_dict, batchSize=BATCH, device=device,
    )
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    uris = uris or sorted(str(p) for p in image_dir.glob("*.npy"))
    df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
    return stage, df


def rows_array(rows) -> np.ndarray:
    return np.stack([r["features"].toArray() for r in rows])


def train_estimator(module, train_params, **kw):
    from sparkdl_tpu_torch.estimators import TorchImageFileEstimator

    args = dict(
        inputCol="uri", outputCol="features", labelCol="label",
        imageLoader=load_npy, module=module, optimizer="adam",
        fitParams={"epochs": 2, "batch_size": BATCH,
                   "learning_rate": TRAIN_LR, "seed": 0},
        initialVariables=train_params, device="cuda",
    )
    args.update(kw)
    return TorchImageFileEstimator(**args)


def training_df(uris):
    from sparkdl_tpu_torch.sql.session import TorchSession

    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    return session.createDataFrame(
        [{"uri": u, "label": i % N_CLASSES} for i, u in enumerate(uris)],
        numPartitions=1,
    )


def ce_per_sample(module, batch):
    import torch.nn.functional as F

    return F.cross_entropy(module(batch["x"]), batch["y"].long(), reduction="none")


def first_step_grads(state_dict, attn_impl, x, y):
    """Gradients of the first training step (mean CE over one batch)."""
    import torch

    from sparkdl_tpu_torch.models.vit import ViT

    model = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl=attn_impl)
    model.load_state_dict(state_dict, strict=True)
    model.cuda().train()
    loss = ce_per_sample(model, {"x": x, "y": y}).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def check_adam_step(got, want, start, steps):
    """Weights after ``steps`` adam steps from ``start`` in two runs: each
    within ``2 * steps * lr`` (adam moves a weight by about lr whatever its
    gradient's size, so where float noise flips the sign of a near-zero
    gradient the two runs step apart by up to 2 lr); and in every leaf, the
    key bias (the middle third of a qkv bias, whose gradient is exactly
    zero) split off, the change from ``start`` within ADAM_LEAF_RTOL of the
    other run's change in norm, so a leaf left unmoved or moved wrongly
    fails. Returns the largest difference and the worst leaf's error."""
    worst = 0.0
    worst_leaf = (0.0, "")
    for name, w in want.items():
        g = got[name].float().cpu()
        w = w.float().cpu()
        s = start[name].float().cpu()
        diff = (g - w).abs().max().item()
        if diff > 2 * steps * TRAIN_LR * 1.001:
            raise AssertionError(f"{name}: {diff:.3e} apart after {steps} adam steps")
        worst = max(worst, diff)
        parts = {name: slice(None)}
        if name.endswith("qkv.bias"):
            third = w.shape[-1] // 3
            parts = {f"{name}[q]": slice(0, third), f"{name}[v]": slice(2 * third, None)}
        for part, sl in parts.items():
            moved, other = (g - s)[..., sl], (w - s)[..., sl]
            err = ((moved - other).norm() / other.norm()).item()
            if not err <= ADAM_LEAF_RTOL:
                raise AssertionError(f"{part}: change differs by {err:.3e} of its norm")
            worst_leaf = max(worst_leaf, (err, part))
    return worst, worst_leaf


def flax_layout_inception_params(seed: int):
    """Random InceptionV3 weights (1000 classes) in the Flax layout, made
    from the shapes of the port's module through the inverse converter:
    conv kernels He-normal (std sqrt(2 / fan_in)), BN variances 1 + 0.1|n|,
    means and biases 0.1 n, the Dense at 1/sqrt(in). Unscaled, 94 units
    drive the activations to inf or 0."""
    from sparkdl_tpu_torch.models.convert import inception_flax_from_state_dict
    from sparkdl_tpu_torch.models.inception_v3 import InceptionV3

    rng = np.random.default_rng(seed)
    state = {}
    for name, t in InceptionV3().state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(".var"):
            state[name] = 1 + 0.1 * np.abs(rng.standard_normal(shape, dtype=np.float32))
            continue
        if len(shape) == 4:
            std = (2.0 / np.prod(shape[1:])) ** 0.5
        elif len(shape) == 2:
            std = shape[1] ** -0.5
        else:
            std = 0.1
        state[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return inception_flax_from_state_dict(state)


def cnn_image_rows(n: int, seed: int):
    """``n`` image-struct rows of two classes, as
    ``examples/transfer_learning.py::make_dataset`` makes them: label 0
    red-dominant, label 1 blue-dominant, stored BGR, 96x96; in the last
    quarter of the rows (the last of 4 partitions) every other pair is
    240x320, so that partition mixes sizes and resizes while packing."""
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        label = i % 2
        hw = (240, 320) if i >= 3 * n // 4 and i % 4 >= 2 else (96, 96)
        bgr = rng.randint(0, 80, (*hw, 3)).astype(np.uint8)
        bgr[..., 0 if label else 2] += 120
        rows.append({"image": imageArrayToStruct(bgr, origin=f"flower_{i}"),
                     "label": label})
    return rows


def conv_flops(module, x) -> float:
    """Operations of one featurizing forward of ``module`` on ``x``: 2 per
    multiply-add, counted from the shapes of what ran: every convolution
    (``weight[0].numel()`` multiply-adds per output, right for grouped and
    depthwise ones), every separable convolution (its depthwise and its
    pointwise parts, per output pixel) and every Dense (``nn.Linear``, such
    as VGG's fc1 and fc2)."""
    import torch

    from sparkdl_tpu_torch.models.layers import Conv, SeparableConv

    total = [0.0]

    def hook(mod, _inp, out):
        if isinstance(mod, SeparableConv):
            pixels = out.numel() // out.shape[1]
            dw, pw = mod.depthwise_kernel, mod.pointwise_kernel
            total[0] += 2.0 * pixels * (dw.numel() + pw.numel())
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * mod.in_features
        else:
            total[0] += 2.0 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (Conv, SeparableConv, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            module(x, features_only=True)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def profile_forward(fn, wall_ms: float):
    """One call of ``fn`` under ``torch.profiler``: the device's busy time
    (the sum of its kernels' times) and idle share of ``wall_ms`` (the same
    call timed by CUDA events), the kernels run, and the operators whose
    kernels took the most device time. Logged; "not measured" when the
    profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        log("  profile: the profiler saw no device time (not measured)")
        return None
    ops = [e for e in events
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    log(f"  profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms (idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), {sum(e.count for e in kernels)} "
        "kernels; by operator: "
        + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                    for e in top))
    return busy_ms


def lr_leaf_errors(got, want):
    """LR weights after the same adam steps from zeros in two runs, as
    check_adam_step holds them: each leaf (weights, bias) within
    ADAM_LEAF_RTOL of the other run's change in norm. Returns the errors."""
    errs = {}
    for name in ("weights", "bias"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        errs[name] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not errs[name] <= ADAM_LEAF_RTOL:
            raise AssertionError(f"LR {name}: change differs by {errs[name]:.3e} of its norm")
    return errs


def nchw(t):
    """NHWC -> NCHW in channels_last memory, as the stages feed the CNNs."""
    import torch

    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def cnn_forward_times(name: str, state, x, card: str):
    """The named CNN's featurizing forward at batch ``CNN_BATCH`` on the
    card, built by ``build_module`` from ``state`` as the stages build it, on
    ``x`` (RGB NHWC float32 at the input size, on the card) after the
    entry's preprocessing: bf16 and float32 times (CUDA events, TF32 off),
    the operations (``conv_flops``), the bf16 bound (the larger of the
    operations at the bf16 dense peak and the weights, input and output,
    each moved once, at the HBM rate), the share of the bf16 peak, and a
    profile of the bf16 forward, all logged."""
    import torch

    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.transformers.named_image import build_module

    entry = get_keras_application_model(name)
    dev = torch.device("cuda")
    xb = nchw(entry.preprocess(x))
    xb16 = xb.to(torch.bfloat16)
    f32 = build_module(name, state, torch.float32, dev)
    bf16 = build_module(name, state, torch.bfloat16, dev)
    flops = conv_flops(bf16, xb16)
    with torch.inference_mode():
        fwd_bf16 = time_ms(lambda: bf16(xb16, features_only=True), iters=10)
        fwd_f32 = time_ms(lambda: f32(xb, features_only=True), iters=5)
    weight_bytes = sum(t.numel() * t.element_size() for t in bf16.state_dict().values())
    moved = weight_bytes + xb16.numel() * 2 + CNN_BATCH * entry.feature_size * 2
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    share = flops / (fwd_bf16 * 1e-3) / PEAK_FLOPS["bfloat16"]
    h, w = entry.input_size
    log(f"{name} forward at batch {CNN_BATCH}, {h}x{w}, features ({card}): bf16 "
        f"{fwd_bf16:.3f} ms, float32 {fwd_f32:.3f} ms; {flops / CNN_BATCH / 1e9:.3f} GFLOP "
        f"per image, {moved / 1e6:.1f} MB moved; bf16 bound {bound_ms:.4f} ms ({bound_by}; "
        f"operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
        f"{100 * share:.2f}% of the bf16 dense peak")
    with torch.inference_mode():
        profile_forward(lambda: bf16(xb16, features_only=True), fwd_bf16)
    del f32, bf16
    torch.cuda.empty_cache()


def images_per_s(run, n: int, what: str, label: str, card: str) -> None:
    """``run()`` (a transform or query, collected) over ``n`` images, warm:
    5 runs, each logged (as ``what``), their median, and the ``sparkdl.*``
    timers over the 5."""
    from sparkdl_tpu_torch.utils.metrics import metrics

    run()
    walls = []
    metrics.reset()
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    median = n / float(np.median(walls))
    log(f"{what} images/s ({label}, batch {CNN_BATCH}, {n} images, {card}): "
        + ", ".join(f"{n / w:.1f}" for w in walls) + f"; median {median:.1f}")
    log("  " + ", ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.snapshot("sparkdl.").items())))


def featurizer_rate(stage, df, label: str, card: str, what: str = "featurizer") -> None:
    """Images through ``stage.transform(df).collect()`` per second, module
    cached and decode paths warm (:func:`images_per_s`)."""
    images_per_s(lambda: stage.transform(df).collect(), df.count(), what,
                 f"{label}, {df.getNumPartitions()} partitions, one mixed", card)


def cnn_pipeline(card: str, counted):
    """Phase 7: the transfer-learning pipeline on the card, InceptionV3
    (299x299, 2048-d features, bf16) -> LogisticRegression in a Pipeline,
    fitted, scored, evaluated, saved and reloaded, with the checks of the
    docstring; then its times. ``counted`` is the (reset, read) pair of the
    kernels' launch counts."""
    import torch

    from sparkdl_tpu_torch import (
        DeepImageFeaturizer,
        LogisticRegression,
        MulticlassClassificationEvaluator,
        Pipeline,
        PipelineModel,
    )
    from sparkdl_tpu_torch.models.convert import inception_state_dict_from_flax
    from sparkdl_tpu_torch.models.registry import fold_bgr_flip_into_stem, preprocess_input
    from sparkdl_tpu_torch.ml.classification import train_logistic_regression
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.named_image import build_module

    tree = flax_layout_inception_params(seed=3)
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    df = session.createDataFrame(cnn_image_rows(CNN_IMAGES, seed=0), numPartitions=4)
    train, test = df.randomSplit([0.75, 0.25], seed=7)
    featurize = dict(inputCol="image", outputCol="features", modelName="InceptionV3",
                     modelWeights=tree, batchSize=CNN_BATCH)
    evaluator = MulticlassClassificationEvaluator(labelCol="label", predictionCol="prediction",
                                                  metricName="accuracy")

    # the main path, counted
    counted[0]()
    t0 = time.perf_counter()
    model = Pipeline(stages=[
        DeepImageFeaturizer(**featurize, computeDtype="bfloat16"),
        LogisticRegression(featuresCol="features", labelCol="label", maxIter=30),
    ]).fit(train)
    scored = model.transform(test)
    pred = scored.collect()
    accuracy = evaluator.evaluate(scored)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counted[1]()
    if any(launches.values()):
        raise AssertionError(f"the CNN path launched attention kernels: {launches}")
    feats = rows_array(pred)
    norms = np.linalg.norm(feats, axis=1)
    log(f"CNN pipeline: InceptionV3 bf16 -> LogisticRegression(maxIter=30), "
        f"{train.count()} train / {len(pred)} test rows in 4 partitions, accuracy "
        f"{accuracy:.4f}, first fit + transform {first_s:.2f} s; attention launches "
        f"{launches} (none on this path); feature norms {norms.min():.3f}-{norms.max():.3f}")
    if feats.shape != (len(pred), 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"bad CNN features: shape {feats.shape}")
    if not (1.0 < norms.min() and norms.max() < 1e4):
        raise AssertionError(f"CNN feature norms out of range: {norms.min()}, {norms.max()}")
    if not accuracy >= CNN_MIN_ACCURACY:
        raise AssertionError(f"accuracy {accuracy} under {CNN_MIN_ACCURACY}")

    # the fitted PipelineModel, saved and loaded
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cnn-") as tmp:
        model.write().overwrite().save(tmp)
        reloaded = PipelineModel.load(tmp)
        re_scored = reloaded.transform(test)
        re_pred = re_scored.collect()
        re_accuracy = evaluator.evaluate(re_scored)
    if [r["prediction"] for r in re_pred] != [r["prediction"] for r in pred]:
        raise AssertionError("the reloaded pipeline predicts otherwise")
    if re_accuracy != accuracy or not np.array_equal(rows_array(re_pred), feats):
        raise AssertionError("the reloaded pipeline's features or accuracy differ")
    log(f"  save/load: the reloaded PipelineModel gives the same predictions, accuracy "
        f"{re_accuracy:.4f} and features bit for bit")

    # bf16 against f32 features on the card, f32 card against f32 CPU
    f32 = rows_array(DeepImageFeaturizer(**featurize, computeDtype="float32")
                     .transform(test).collect())
    bf16_err = np.abs(feats - f32).max()
    log(f"  bf16 vs float32 features: max abs err {bf16_err:.3e} "
        f"({bf16_err / np.abs(f32).max():.3e} of the largest; bound {CNN_BF16_MAX_REL})")
    if not bf16_err <= CNN_BF16_MAX_REL * np.abs(f32).max():
        raise AssertionError(f"bf16 features {bf16_err:.3e} from float32")
    # card against CPU on two one-partition frames: one uniform (uint8 at
    # source size, resized in the forward) and one mixing 96x96 with
    # 240x320 (float32, resized while packing), so both resizes are held
    small = [r for r in pred if r["image"]["height"] == 96]
    large = [r for r in pred if r["image"]["height"] == 240]
    if len(small) < 4 or len(large) < 2:
        raise AssertionError(f"the test split holds {len(small)} 96x96 and {len(large)} "
                             "240x320 rows; the card-vs-CPU check needs 4 and 2")
    f32_stage = DeepImageFeaturizer(**featurize, computeDtype="float32")
    cpu_stage = DeepImageFeaturizer(**featurize, computeDtype="float32", device="cpu")
    for what, picked in (("uniform 96x96", small[:4]),
                         ("mixed 96x96 + 240x320", small[:2] + large[:2])):
        few = session.createDataFrame([{"image": r["image"]} for r in picked],
                                      numPartitions=1)
        on_card = rows_array(f32_stage.transform(few).collect())
        on_cpu = rows_array(cpu_stage.transform(few).collect())
        np.testing.assert_allclose(on_card, on_cpu, **SLICE_TOL)
        log(f"  float32 features, card vs CPU ({len(picked)} images, one {what} "
            f"partition): max abs err {np.abs(on_card - on_cpu).max():.3e}")

    # the LR head fitted on the card against a CPU fit of the same features
    feature_df = model.stages[0].transform(train)
    cpu_head = LogisticRegression(featuresCol="features", labelCol="label", maxIter=30,
                                  device="cpu").fit(feature_df)
    leaf = lr_leaf_errors(model.stages[1], cpu_head)
    log(f"  LR head on the card vs CPU on one feature matrix: change in norm "
        f"weights {leaf['weights']:.3e}, bias {leaf['bias']:.3e} (bound {ADAM_LEAF_RTOL})")

    # the BGR flip folded into the stem against the flip in the forward
    state = {k: v for k, v in inception_state_dict_from_flax(tree).items()
             if not k.startswith("predictions")}
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (CNN_BATCH, 299, 299, 3)).astype(np.float32)).to(dev)
    plain = build_module("InceptionV3", state, torch.float32, dev)
    folded = build_module("InceptionV3", fold_bgr_flip_into_stem(state, "tf"),
                          torch.float32, dev)

    with torch.inference_mode():
        want = plain(nchw(preprocess_input(x.flip(-1), "tf")), features_only=True)
        got = folded(nchw(preprocess_input(x, "tf")), features_only=True)
    fold_err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **CNN_FOLD_TOL)
    log(f"  BGR flip folded into the stem vs flipped in the forward: max abs err {fold_err:.3e}")

    # times on the card (CUDA events; TF32 off)
    cnn_forward_times("InceptionV3", state, x, card)
    featurizer_rate(DeepImageFeaturizer(**featurize, computeDtype="bfloat16"), df,
                    "InceptionV3 bf16", card)
    fit_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        LogisticRegression(featuresCol="features", labelCol="label", maxIter=30
                           ).fit(feature_df)
        fit_walls.append(time.perf_counter() - t0)
    xs = torch.from_numpy(rows_array(feature_df.collect()).astype(np.float32)).to(dev)
    ys = torch.tensor([r["label"] for r in feature_df.collect()], device=dev)
    train_ms = time_ms(lambda: train_logistic_regression(xs, ys, 2, 30, 0.0, 0.1),
                       iters=5, warmup=2)
    log(f"LogisticRegression fit ({xs.shape[0]} x 2048, 30 adam steps, {card}): fit "
        f"{1e3 * float(np.median(fit_walls)):.2f} ms (median of 3, collect included), "
        f"the 30 steps {train_ms:.2f} ms")


ZOO = ("ResNet50", "VGG16", "VGG19", "MobileNetV2", "Xception")
# the batch norms that end a residual branch: ResNet50's _3_bn, Xception's
# middle-flow sepconv3_bn, MobileNetV2's _project_BN
RESIDUAL_END = re.compile(r"(_3_bn|sepconv3_bn|_project_BN)$")
# the stem kernels of the "caffe" models (ResNet50, VGG16, VGG19)
CAFFE_STEMS = ("conv1_conv.weight", "block1_conv1.weight")


def flax_layout_zoo_params(name: str, seed: int):
    """Random weights (1000 classes) of a zoo model in the Flax layout, made
    from the shapes of the port's module through the inverse converter (for
    Xception at Keras's 728, so that the registry's 768-wide module pads
    it): conv kernels He-normal (a separable
    conv's depthwise kernel at gain 1: no relu comes before its pointwise
    conv), BN scales and variances 1 + 0.1|n| (not a 0.1-wide draw: 50 units
    of scale ~0.1 drive the features to 0), means and biases 0.1 n, the
    Dense at 1/sqrt(in). The batch norm that ends a residual branch
    (``RESIDUAL_END``) has a fifth of that scale: with it near 1 the residual
    sums double the variance block after block, ResNet50's features reach
    3e3 and Xception's 8e5, and MobileNetV2's bf16 features part from its
    float32 ones by 16% of the largest in the JAX package and the port alike
    (tests/test_torch_zoo.py). A "caffe" model's stem kernel (``CAFFE_STEMS``)
    is at 1/128 of He's, as if its inputs (+-128 after the mean) were scaled
    to unit order like "tf" ones: otherwise its features reach 900
    (ResNet50) and 500 (VGG19), and float32 rounding at 1e-6 of that is above
    ``SLICE_TOL``'s absolute 5e-4."""
    import torch

    from sparkdl_tpu_torch.models.convert import cnn_flax_from_state_dict
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.models.xception import Xception

    rng = np.random.default_rng(seed)
    entry = get_keras_application_model(name)
    caffe = entry.preprocess_mode == "caffe"
    with torch.device("meta"):
        module = (Xception(middle_width=728) if name == "Xception"
                  else entry.make_module())
    state = {}
    for key, t in module.state_dict().items():
        layer, leaf = key.rsplit(".", 1)
        shape = tuple(t.shape)
        if leaf in ("var", "scale"):
            v = 1 + 0.1 * np.abs(rng.standard_normal(shape, dtype=np.float32))
            state[key] = v * np.float32(0.2) if leaf == "scale" and RESIDUAL_END.search(layer) else v
            continue
        if len(shape) == 4:
            std = ((1.0 if leaf == "depthwise_kernel" else 2.0) / np.prod(shape[1:])) ** 0.5
            if caffe and key in CAFFE_STEMS:
                std /= 128
        elif len(shape) == 2:
            std = shape[1] ** -0.5
        else:
            std = 0.1
        state[key] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return cnn_flax_from_state_dict(state)


def cnn_zoo(card: str, counted):
    """Phase 8: the rest of the CNN zoo on the card. For each of ResNet50,
    VGG16, VGG19, MobileNetV2 and Xception, ``DeepImageFeaturizer`` over
    phase 7's 128 image structs (4 partitions, one mixed) at batch 32 in
    bf16 and float32, from a seeded Flax-layout tree carried across by the
    registry's converter (Xception's at Keras's 728, padded to the
    registry's 768); ``DeepImagePredictor`` on ResNet50 ("caffe") and
    MobileNetV2 ("tf", flip folded into the stem); Xception at both widths;
    and a ``CrossValidator`` sweep over the backbone. Checks: rows out =
    rows in, the registry's feature width, finite features not all zero;
    float32 card against a CPU run at ``SLICE_TOL`` on 4 uniform rows and a
    mixed partition; bf16 within ``CNN_BF16_MAX_REL`` of the largest float32
    feature; probabilities card against CPU at ``PROB_TOL``, rows summing
    to 1, 5 decoded entries; the two Xception widths at ``SLICE_TOL``; the
    sweep's ``avgMetrics`` equal at ``parallelism`` 2 and 1, its best model
    the grid's arg-max, its save and load equal bit for bit; no attention
    launch over the path. Times: each forward (bf16, float32, share of the
    bf16 peak, profile), the featurizer's images/s, both Xception widths,
    the sweep's fit. ``counted`` is the (reset, read) pair of the kernels'
    launch counts."""
    import torch

    from sparkdl_tpu_torch import (
        CrossValidator,
        CrossValidatorModel,
        DeepImageFeaturizer,
        DeepImagePredictor,
        LogisticRegression,
        MulticlassClassificationEvaluator,
        ParamGridBuilder,
        Pipeline,
    )
    from sparkdl_tpu_torch.models.convert import cnn_state_dict_from_flax
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.models.xception import Xception
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.named_image import load_module

    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    rows = cnn_image_rows(CNN_IMAGES, seed=0)
    df = session.createDataFrame(rows, numPartitions=4)
    images = [r["image"] for r in rows]
    small = [im for im in images if im["height"] == 96]
    large = [im for im in images if im["height"] == 240]
    frames = {what: session.createDataFrame([{"image": im} for im in picked], numPartitions=1)
              for what, picked in (("uniform 96x96", small[:4]),
                                   ("mixed 96x96 + 240x320", small[:2] + large[:2]))}
    trees = {name: flax_layout_zoo_params(name, seed=10 + i) for i, name in enumerate(ZOO)}

    # the main path, counted: each backbone's bf16 featurizer over the 128
    # rows, the two predictors and the sweep
    counted[0]()
    bf16_feats = {}
    for name in ZOO:
        entry = get_keras_application_model(name)
        stage = DeepImageFeaturizer(inputCol="image", outputCol="features", modelName=name,
                                    modelWeights=trees[name], batchSize=CNN_BATCH)
        t0 = time.perf_counter()
        out = stage.transform(df).collect()
        first_s = time.perf_counter() - t0
        feats = rows_array(out)
        if len(out) != CNN_IMAGES or feats.shape != (CNN_IMAGES, entry.feature_size):
            raise AssertionError(f"{name}: {len(out)} rows of {feats.shape} for {CNN_IMAGES}")
        if not np.isfinite(feats).all() or not np.abs(feats).max() > 0:
            raise AssertionError(f"{name}: features not finite or all zero")
        bf16_feats[name] = feats
        log(f"zoo {name} bf16 featurizer: {len(out)} rows x {feats.shape[1]}, first transform "
            f"(module built) {first_s:.2f} s, largest |feature| {np.abs(feats).max():.3f}")

    for name in ("ResNet50", "MobileNetV2"):
        args = dict(inputCol="image", outputCol="preds", modelName=name,
                    modelWeights=trees[name], batchSize=CNN_BATCH)
        few = frames["uniform 96x96"]
        on_card = np.stack([r["preds"].toArray() for r in DeepImagePredictor(
            **args, computeDtype="float32").transform(few).collect()])
        on_cpu = np.stack([r["preds"].toArray() for r in DeepImagePredictor(
            **args, computeDtype="float32", device="cpu").transform(few).collect()])
        np.testing.assert_allclose(on_card, on_cpu, **PROB_TOL)
        np.testing.assert_allclose(on_card.sum(axis=1), 1.0, rtol=1e-5)
        decoded = DeepImagePredictor(**args, decodePredictions=True, topK=5).transform(df).collect()
        if len(decoded) != CNN_IMAGES or any(len(r["preds"]) != 5 for r in decoded):
            raise AssertionError(f"{name}: the bf16 top-5 decode gave other rows")
        log(f"zoo {name} predictor: float32 probabilities card vs CPU (4 images) max abs err "
            f"{np.abs(on_card - on_cpu).max():.3e}, rows sum to 1 within "
            f"{np.abs(on_card.sum(axis=1) - 1).max():.1e}; bf16 top-5 decode of {len(decoded)} "
            f"rows, first {decoded[0]['preds'][0]['description']!r}")

    train, test = df.randomSplit([0.75, 0.25], seed=7)
    featurizer = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="ResNet50", modelWeights="random",
                                     batchSize=CNN_BATCH)
    lr = LogisticRegression(featuresCol="features", labelCol="label", maxIter=30)
    grid = (ParamGridBuilder().addGrid(featurizer.modelName, ["ResNet50", "MobileNetV2"])
            .addGrid(lr.regParam, [0.0, 0.01]).build())
    evaluator = MulticlassClassificationEvaluator(labelCol="label", predictionCol="prediction",
                                                  metricName="accuracy")
    cv = CrossValidator(estimator=Pipeline(stages=[featurizer, lr]), estimatorParamMaps=grid,
                        evaluator=evaluator, numFolds=2, parallelism=2, seed=7)
    t0 = time.perf_counter()
    cv_model = cv.fit(train)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    scored = cv_model.transform(test)
    pred = scored.collect()
    accuracy = evaluator.evaluate(scored)
    launches = counted[1]()
    if any(launches.values()):
        raise AssertionError(f"the CNN zoo launched attention kernels: {launches}")
    best = int(np.argmax(cv_model.avgMetrics))
    best_name = cv_model.bestModel.stages[0].getModelName()
    log(f"zoo sweep: CrossValidator(Pipeline([DeepImageFeaturizer(random), "
        f"LogisticRegression(maxIter=30)]), modelName x regParam 2x2, numFolds=2, "
        f"parallelism=2) on {train.count()} rows in {sweep_s:.2f} s ({card}); avgMetrics "
        f"{cv_model.avgMetrics}, best {best} ({best_name}), test accuracy {accuracy:.4f} on "
        f"{len(pred)} rows; attention launches over phase 8's path {launches} (none)")
    if best_name != grid[best][featurizer.modelName]:
        raise AssertionError(f"best model {best_name} is not the grid's arg-max {grid[best]}")
    t0 = time.perf_counter()
    serial = cv.copy({cv.parallelism: 1}).fit(train)
    serial_s = time.perf_counter() - t0
    if serial.avgMetrics != cv_model.avgMetrics:
        raise AssertionError(f"parallelism 1 gives {serial.avgMetrics}, "
                             f"2 gives {cv_model.avgMetrics}")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cv-") as tmp:
        cv_model.write().overwrite().save(tmp)
        re_pred = CrossValidatorModel.load(tmp).transform(test).collect()
    if [r["prediction"] for r in re_pred] != [r["prediction"] for r in pred] or \
            not np.array_equal(rows_array(re_pred), rows_array(pred)):
        raise AssertionError("the reloaded CrossValidatorModel predicts otherwise")
    log(f"  parallelism=1 gives the same avgMetrics in {serial_s:.2f} s; the reloaded "
        "CrossValidatorModel gives the same predictions and features bit for bit")

    # each backbone: float32 on the card against bf16 and against the CPU,
    # then its times
    dev = torch.device("cuda")
    for name in ZOO:
        entry = get_keras_application_model(name)
        args = dict(inputCol="image", outputCol="features", modelName=name,
                    modelWeights=trees[name], batchSize=CNN_BATCH, computeDtype="float32")
        f32 = rows_array(DeepImageFeaturizer(**args).transform(df).collect())
        bf16_err = np.abs(bf16_feats[name] - f32).max()
        if not bf16_err <= CNN_BF16_MAX_REL * np.abs(f32).max():
            raise AssertionError(f"{name}: bf16 features {bf16_err:.3e} from float32")
        errs = []
        for what, few in frames.items():
            on_card = rows_array(DeepImageFeaturizer(**args).transform(few).collect())
            on_cpu = rows_array(DeepImageFeaturizer(**args, device="cpu").transform(few)
                                .collect())
            np.testing.assert_allclose(on_card, on_cpu, **SLICE_TOL)
            errs.append(f"{what} {np.abs(on_card - on_cpu).max():.3e}")
        log(f"zoo {name}: bf16 vs float32 features max abs err {bf16_err:.3e} "
            f"({bf16_err / np.abs(f32).max():.3e} of the largest, {np.abs(f32).max():.3f}; "
            f"bound {CNN_BF16_MAX_REL}); float32 card vs CPU (4 images): " + ", ".join(errs))
        h, w = entry.input_size
        x = torch.from_numpy(np.random.default_rng(4).uniform(
            0, 255, (CNN_BATCH, h, w, 3)).astype(np.float32)).to(dev)
        cnn_forward_times(name, entry.state_dict_from_flax(trees[name]), x, card)
        featurizer_rate(DeepImageFeaturizer(**{**args, "computeDtype": "bfloat16"}), df,
                        f"{name} bf16", card)

    # Xception at Keras's 728 (the tree as it is) against the registry's 768
    # (the tree zero-padded): the same features, two times
    with torch.device("meta"):
        narrow = Xception(middle_width=728)
    states = {728: cnn_state_dict_from_flax(trees["Xception"], narrow),
              768: get_keras_application_model("Xception").state_dict_from_flax(trees["Xception"])}
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (CNN_BATCH, 299, 299, 3)).astype(np.float32)).to(dev)
    outs, times = {}, {}
    for width, state in states.items():
        for dtype in (torch.float32, torch.bfloat16):
            with torch.device("meta"):
                module = Xception(middle_width=width, dtype=dtype)
            module = load_module(module, state, dtype, dev)
            xin = nchw(x).to(dtype)
            with torch.inference_mode():
                outs[width, dtype] = module(xin, features_only=True).float().cpu().numpy()
                times[width, dtype] = time_ms(lambda: module(xin, features_only=True),
                                              iters=10 if dtype == torch.bfloat16 else 5)
            del module
    np.testing.assert_allclose(outs[728, torch.float32], outs[768, torch.float32], **SLICE_TOL)
    log(f"zoo Xception widths ({card}): float32 features 728 vs 768 (padded) max abs err "
        f"{np.abs(outs[728, torch.float32] - outs[768, torch.float32]).max():.3e}; forward at "
        f"batch {CNN_BATCH} bf16 728 {times[728, torch.bfloat16]:.3f} ms, 768 "
        f"{times[768, torch.bfloat16]:.3f} ms; float32 728 {times[728, torch.float32]:.3f} ms, "
        f"768 {times[768, torch.float32]:.3f} ms")
    torch.cuda.empty_cache()


# phase 9: the graph layer
VIT_IMAGES = 64
HEAD_CLASSES = 10


def struct_rows(images):
    """Image-struct rows (column ``image``) of stored-BGR uint8 arrays."""
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct

    return [{"image": imageArrayToStruct(img, origin=f"img_{i}")} for i, img in enumerate(images)]


def inception_function(state, dtype, device):
    """InceptionV3's 2048-d features as a TorchFunction over float RGB NHWC
    batches in 0-255: the "tf" preprocessor piece, the NCHW permute into
    channels_last in ``dtype``, the module built as the stages build it,
    then float32."""
    import torch

    from sparkdl_tpu_torch.graph import TorchFunction, pieces
    from sparkdl_tpu_torch.transformers.named_image import build_module

    module = build_module("InceptionV3", state, dtype, torch.device(device))
    return TorchFunction.from_list([
        pieces.build_preprocessor("tf"),
        TorchFunction.from_callable(lambda x: nchw(x).to(dtype)),
        TorchFunction.from_module(module, features_only=True),
        TorchFunction.from_callable(lambda y: y.float()),
    ], name=f"inception_v3_{str(dtype).removeprefix('torch.')}")


def vit_function(state, attn_impl: str):
    """ViT-B/16 (224x224, 1000 classes, float32) on the card as a
    TorchFunction over float RGB NHWC batches in 0-255."""
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.models.vit import ViT

    module = ViT(variant="ViT-B/16", attn_impl=attn_impl)
    module.load_state_dict(state, strict=True)
    return TorchFunction.from_list([
        TorchFunction.from_callable(lambda x: x / 255.0),
        TorchFunction.from_module(module.cuda()),
    ], name=f"vit_b16_{attn_impl}")


def vectors(rows, col: str) -> np.ndarray:
    return np.stack([r[col].toArray() for r in rows])


def saved_and_loaded(fn, spec, tmp: Path):
    """``fn`` saved to a directory under ``tmp`` (exported on its params'
    device) and loaded back; with the export's and the load's seconds."""
    from sparkdl_tpu_torch.graph import TorchFunction

    path = tmp / fn.name
    t0 = time.perf_counter()
    fn.save(str(path), spec)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = TorchFunction.load(str(path))
    load_s = time.perf_counter() - t0
    size = (path / "function.pt2").stat().st_size
    log(f"  {fn.name}: export and save {export_s:.2f} s ({size / 1e6:.1f} MB), load "
        f"{load_s:.2f} s; fingerprint {loaded.fingerprint[:16]}...")
    return loaded


def graph_layer(card: str, counted):
    """Phase 9: the graph layer on the card (see the docstring). Returns the
    lse-free forward kernel's launches on the ViT function's run."""
    import torch

    from sparkdl_tpu_torch import (
        DeepImageFeaturizer,
        PipelineModel,
        TFImageTransformer,
        TFTransformer,
    )
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.ml.util import load_stage
    from sparkdl_tpu_torch.models.convert import (
        inception_state_dict_from_flax,
        vit_state_dict_from_flax,
    )
    from sparkdl_tpu_torch.sql.session import TorchSession

    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    df = session.createDataFrame(cnn_image_rows(CNN_IMAGES, seed=0), numPartitions=4)
    tree = flax_layout_inception_params(seed=3)
    state = {k: v for k, v in inception_state_dict_from_flax(tree).items()
             if not k.startswith("predictions")}
    stage_args = dict(inputCol="image", outputCol="features", inputShape=(299, 299),
                      channelOrder="RGB", batchSize=CNN_BATCH)
    fns = {dtype: inception_function(state, dtype, "cuda")
           for dtype in (torch.float32, torch.bfloat16)}

    # the CNN function through TFImageTransformer, against the featurizer
    feats = {}
    for dtype, fn in fns.items():
        stage = TFImageTransformer(graph=fn, **stage_args)
        counted[0]()
        rows = stage.transform(df).collect()
        launches = counted[1]()
        feats[dtype] = vectors(rows, "features")
        if len(rows) != CNN_IMAGES or feats[dtype].shape != (CNN_IMAGES, 2048) \
                or not np.isfinite(feats[dtype]).all():
            raise AssertionError(f"bad TFImageTransformer rows: {feats[dtype].shape}")
        if any(launches.values()):
            raise AssertionError(f"the CNN function launched attention kernels: {launches}")
        name = str(dtype).removeprefix("torch.")
        want = vectors(DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="InceptionV3",
            modelWeights=tree, batchSize=CNN_BATCH, computeDtype=name,
        ).transform(df).collect(), "features")
        err = np.abs(feats[dtype] - want).max()
        if dtype == torch.float32:
            np.testing.assert_allclose(feats[dtype], want, **SLICE_TOL)
        elif not err <= CNN_BF16_MAX_REL * np.abs(want).max():
            raise AssertionError(f"bf16 function vs bf16 featurizer {err:.3e}")
        log(f"graph: TFImageTransformer(InceptionV3 {name} function) over {len(rows)} rows "
            f"in 4 partitions (one mixed) vs DeepImageFeaturizer(InceptionV3, {name}): "
            f"max abs err {err:.3e} ({err / np.abs(want).max():.3e} of the largest)")
    bf16_err = np.abs(feats[torch.bfloat16] - feats[torch.float32]).max()
    if not bf16_err <= CNN_BF16_MAX_REL * np.abs(feats[torch.float32]).max():
        raise AssertionError(f"bf16 function {bf16_err:.3e} from float32")
    log(f"  bf16 vs float32 function: max abs err {bf16_err:.3e} "
        f"({bf16_err / np.abs(feats[torch.float32]).max():.3e} of the largest)")

    # float32 card against the CPU: 4 uniform rows, and the mixed partition
    test_rows = df.collect()
    small = [r for r in test_rows if r["image"]["height"] == 96]
    large = [r for r in test_rows if r["image"]["height"] == 240]
    on_card_stage = TFImageTransformer(graph=fns[torch.float32], **stage_args)
    on_cpu_stage = TFImageTransformer(graph=fns[torch.float32], device="cpu", **stage_args)
    for what, picked in (("uniform 96x96", small[:4]),
                         ("mixed 96x96 + 240x320", small[:2] + large[:2])):
        few = session.createDataFrame([{"image": r["image"]} for r in picked],
                                      numPartitions=1)
        on_card = vectors(on_card_stage.transform(few).collect(), "features")
        on_cpu = vectors(on_cpu_stage.transform(few).collect(), "features")
        np.testing.assert_allclose(on_card, on_cpu, **SLICE_TOL)
        log(f"  float32 function, card vs CPU ({len(picked)} images, one {what} "
            f"partition): max abs err {np.abs(on_card - on_cpu).max():.3e}")

    # outputMode="image" and channelOrder="L", card against CPU
    few = session.createDataFrame([{"image": r["image"]} for r in small[:2] + large[:2]],
                                  numPartitions=1)
    halve = TorchFunction.from_callable(lambda x: x * 0.5, name="halve")
    chan_mean = TorchFunction.from_callable(lambda x: x.mean(dim=(1, 2)), name="chan_mean")
    for label, args in (("image", dict(graph=halve, outputMode="image", inputShape=(64, 48))),
                        ("L", dict(graph=chan_mean, channelOrder="L", inputShape=(64, 48)))):
        got = [TFImageTransformer(inputCol="image", outputCol="out", device=device, **args)
               .transform(few).collect() for device in (None, "cpu")]
        if label == "image":
            from sparkdl_tpu_torch.image.imageIO import imageStructToArray

            arrays = [np.stack([imageStructToArray(r["out"]) for r in rows]) for rows in got]
            if arrays[0].shape != (4, 64, 48, 3):
                raise AssertionError(f"image mode gave {arrays[0].shape}")
        else:
            arrays = [vectors(rows, "out") for rows in got]
            if arrays[0].shape != (4, 1):
                raise AssertionError(f"channelOrder='L' gave {arrays[0].shape}")
        np.testing.assert_allclose(arrays[0], arrays[1], **SLICE_TOL)
        log(f"  {label}: card vs CPU on 4 rows (one mixed partition), max abs err "
            f"{np.abs(arrays[0] - arrays[1]).max():.3e}")

    # the ViT function, through the forward kernel, against dense attention
    vit_state = vit_state_dict_from_flax(flax_layout_vit_params(seed=0))
    rng = np.random.RandomState(2)
    vit_df = session.createDataFrame(
        struct_rows(rng.randint(0, 256, (VIT_IMAGES, 224, 224, 3), dtype=np.uint8)),
        numPartitions=1)
    vit_args = dict(inputCol="image", outputCol="logits", inputShape=(224, 224),
                    batchSize=BATCH)
    vit_fn = vit_function(vit_state, "flash")
    counted[0]()
    vit_rows = TFImageTransformer(graph=vit_fn, **vit_args).transform(vit_df).collect()
    vit_launches = counted[1]()
    expected = 12 * (VIT_IMAGES // BATCH)
    log(f"graph: TFImageTransformer(ViT-B/16 flash function) over {len(vit_rows)} rows, "
        f"launches {vit_launches} (expected {expected} lse-free: 12 blocks x "
        f"{VIT_IMAGES // BATCH} chunks)")
    if list(vit_launches.values()) != [expected, 0, 0, 0]:
        raise AssertionError(f"ViT function launches {vit_launches}")
    logits = vectors(vit_rows, "logits")
    if logits.shape != (VIT_IMAGES, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"bad ViT function rows: {logits.shape}")
    dense_fn = vit_function(vit_state, "full")
    dense = vectors(TFImageTransformer(graph=dense_fn, **vit_args).transform(vit_df)
                    .collect(), "logits")
    np.testing.assert_allclose(logits, dense, **SLICE_TOL)
    log(f"  flash vs dense attention: max abs err {np.abs(logits - dense).max():.3e}")
    del dense_fn

    # export: save, load, the loaded program against the in-memory function
    with tempfile.TemporaryDirectory(prefix="chip-smoke-graph-") as tmp:
        tmp = Path(tmp)
        log("graph: export (torch.export, batch as a Dim, params frozen in):")
        loaded_cnn = saved_and_loaded(fns[torch.float32], ((2, 299, 299, 3), torch.float32), tmp)
        loaded_vit = saved_and_loaded(vit_fn, ((2, 224, 224, 3), torch.float32), tmp)
        vit_ops = [str(n.target) for n in loaded_vit.exported_program.graph.nodes]
        if vit_ops.count("sparkdl_tpu_torch.flash_attention_fwd.default") != 12:
            raise AssertionError("the exported ViT program lost its flash-attention op nodes")
        cnn_loaded = vectors(TFImageTransformer(graph=loaded_cnn, **stage_args)
                             .transform(df).collect(), "features")
        np.testing.assert_allclose(cnn_loaded, feats[torch.float32], **SLICE_TOL)
        counted[0]()
        vit_loaded = vectors(TFImageTransformer(graph=loaded_vit, **vit_args)
                             .transform(vit_df).collect(), "logits")
        loaded_launches = counted[1]()
        if list(loaded_launches.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"the loaded ViT program launched {loaded_launches}")
        np.testing.assert_allclose(vit_loaded, logits, **SLICE_TOL)
        log(f"  loaded vs in-memory: InceptionV3 float32 max abs err "
            f"{np.abs(cnn_loaded - feats[torch.float32]).max():.3e}; ViT-B/16 flash "
            f"{np.abs(vit_loaded - logits).max():.3e}, launches {loaded_launches}")

        # the loaded program's forward at batch 32 against the in-memory one's
        dev = torch.device("cuda")
        for label, fn, loaded, hw in (("InceptionV3 float32", fns[torch.float32], loaded_cnn, 299),
                                      ("ViT-B/16 flash", vit_fn, loaded_vit, 224)):
            x = torch.from_numpy(np.random.default_rng(4).uniform(
                0, 255, (CNN_BATCH, hw, hw, 3)).astype(np.float32)).to(dev)
            with torch.inference_mode():
                eager_ms = time_ms(lambda: fn.apply(fn.params, x), iters=10)
                program_ms = time_ms(lambda: loaded.apply({}, x), iters=10)
            log(f"  forward at batch {CNN_BATCH}, {label} ({card}): in-memory "
                f"{eager_ms:.3f} ms, loaded program {program_ms:.3f} ms")
        # the holder's own cost on a launch-bound forward: the bf16 function
        # against the same ops on its module called alone
        from sparkdl_tpu_torch.models.registry import preprocess_input
        from sparkdl_tpu_torch.transformers.named_image import build_module

        bare = build_module("InceptionV3", state, torch.bfloat16, dev)
        bf16_fn = fns[torch.bfloat16]
        x = torch.from_numpy(np.random.default_rng(4).uniform(
            0, 255, (CNN_BATCH, 299, 299, 3)).astype(np.float32)).to(dev)
        with torch.inference_mode():
            bare_ms = time_ms(lambda: bare(nchw(preprocess_input(x, "tf")).to(torch.bfloat16),
                                           features_only=True).float(), iters=10)
            fn_ms = time_ms(lambda: bf16_fn.apply(bf16_fn.params, x), iters=10)
        log(f"  forward at batch {CNN_BATCH}, InceptionV3 bf16 ({card}): the module alone "
            f"{bare_ms:.3f} ms, as a TorchFunction {fn_ms:.3f} ms ({len(bare.state_dict())} "
            "tensors swapped in by functional_call a call)")
        del bare

        # tensor columns: a two-output head over the 2048-d features
        rng = np.random.default_rng(6)
        w = (rng.standard_normal((2048, HEAD_CLASSES)) / np.sqrt(2048)).astype(np.float32)
        b = (0.1 * rng.standard_normal(HEAD_CLASSES)).astype(np.float32)
        head = TorchFunction.from_callable(
            lambda p, f: (f @ p["w"] + p["b"], torch.softmax(f @ p["w"] + p["b"], dim=-1)),
            params={"w": w, "b": b}, takes_params=True, input_names=("features",),
            output_names=("logits", "probs"), name="head")
        feature_df = session.createDataFrame(
            [{"features": v} for v in feats[torch.float32]], numPartitions=4)
        tensor_stage = TFTransformer(
            tfInputGraph=head, inputMapping={"features": "features"},
            outputMapping={"logits": "logits", "probs": "probs"}, batchSize=CNN_BATCH)
        scored = tensor_stage.transform(feature_df).collect()
        got_logits = np.stack([r["logits"] for r in scored])
        got_probs = np.stack([r["probs"] for r in scored])
        want_logits = feats[torch.float32].astype(np.float64) @ w + b
        z = np.exp(want_logits - want_logits.max(axis=1, keepdims=True))
        want_probs = z / z.sum(axis=1, keepdims=True)
        if got_logits.shape != (CNN_IMAGES, HEAD_CLASSES):
            raise AssertionError(f"TFTransformer gave {got_logits.shape}")
        np.testing.assert_allclose(got_logits, want_logits, **SLICE_TOL)
        np.testing.assert_allclose(got_probs, want_probs, **PROB_TOL)
        log(f"graph: TFTransformer(logits, softmax) over {len(scored)} rows of 2048-d "
            f"features at batch {CNN_BATCH}: logits max abs err "
            f"{np.abs(got_logits - want_logits).max():.3e}, probabilities "
            f"{np.abs(got_probs - want_probs).max():.3e} against float64 numpy")

        # persistence: a PipelineModel of both stages, over the loaded
        # functions, saved and loaded
        head.input_specs = [((2, 2048), torch.float32)]
        loaded_head = saved_and_loaded(head, ((2, 2048), torch.float32), tmp)
        model = PipelineModel(stages=[
            TFImageTransformer(graph=loaded_cnn, **stage_args),
            TFTransformer(tfInputGraph=loaded_head, inputMapping={"features": "features"},
                          outputMapping={"logits": "logits", "probs": "probs"},
                          batchSize=CNN_BATCH),
        ])
        first = model.transform(df).collect()
        model.write().overwrite().save(str(tmp / "pipeline"))
        again = load_stage(str(tmp / "pipeline")).transform(df).collect()
        for col in ("logits", "probs"):
            if not np.array_equal(np.stack([r[col] for r in first]),
                                  np.stack([r[col] for r in again])):
                raise AssertionError(f"the reloaded PipelineModel's {col} differ")
        if not np.array_equal(vectors(first, "features"), vectors(again, "features")):
            raise AssertionError("the reloaded PipelineModel's features differ")
        log("  save/load: the reloaded PipelineModel([TFImageTransformer, TFTransformer]) "
            "gives the same features, logits and probabilities bit for bit")
        del loaded_cnn, loaded_vit, model

    # times: the stage's images/s beside the featurizer's
    featurizer_rate(TFImageTransformer(graph=fns[torch.bfloat16], **stage_args), df,
                    "TFImageTransformer, InceptionV3 bf16 function", card,
                    what="TFImageTransformer")
    featurizer_rate(DeepImageFeaturizer(inputCol="image", outputCol="features",
                                        modelName="InceptionV3", modelWeights=tree,
                                        batchSize=CNN_BATCH, computeDtype="bfloat16"),
                    df, "InceptionV3 bf16, beside it", card)
    del fns, vit_fn
    torch.cuda.empty_cache()
    return vit_launches["flash_attention_fwd"] + loaded_launches["flash_attention_fwd"]


# phase 10: the Keras half of the graph layer
KERAS_CONFIG = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / \
    "keras_inception_v3.config.json.gz"
KERAS_HEAD_IN = 2048


def load_npy_tf(uri):
    """The Keras files' imageLoader: a float32 299x299x3 array in 0-255
    from ``.npy``, through the "tf" ``preprocess_input`` (to [-1, 1]), in
    place."""
    x = np.load(uri)
    x /= np.float32(127.5)
    x -= np.float32(1.0)
    return x


def keras_inception_weights(config, seed: int):
    """Random weights for InceptionV3's Keras config, layer name -> arrays
    in Keras's variable order, drawn as phase 7 draws them: conv kernels
    He-normal, BN moving variances 1 + 0.1|n|, means and betas 0.1 n, the
    Dense at 1/sqrt(in). Shapes from each layer's ``build_config``."""
    rng = np.random.default_rng(seed)
    weights = {}
    for layer in config["config"]["layers"]:
        cfg, cls = layer["config"], layer["class_name"]
        cin = (layer.get("build_config") or {}).get("input_shape", [None])[-1]
        if cls == "Conv2D":
            kh, kw = cfg["kernel_size"]
            kernel = rng.standard_normal((kh, kw, cin, cfg["filters"]), dtype=np.float32)
            weights[cfg["name"]] = [kernel * np.float32((2.0 / (kh * kw * cin)) ** 0.5)]
            if cfg["use_bias"]:
                weights[cfg["name"]].append(np.zeros(cfg["filters"], np.float32))
        elif cls == "BatchNormalization":
            assert not cfg["scale"] and cfg["center"], cfg["name"]
            beta, mean = (0.1 * rng.standard_normal(cin, dtype=np.float32) for _ in range(2))
            var = 1 + 0.1 * np.abs(rng.standard_normal(cin, dtype=np.float32))
            weights[cfg["name"]] = [beta, mean, var]
        elif cls == "Dense":
            kernel = rng.standard_normal((cin, cfg["units"]), dtype=np.float32)
            weights[cfg["name"]] = [kernel * np.float32(cin ** -0.5),
                                    0.1 * rng.standard_normal(cfg["units"], dtype=np.float32)]
    return weights


def keras_head_config(units: int):
    """A Sequential Keras config: a ``KERAS_HEAD_IN``-wide input, one Dense
    of ``units`` with softmax, as Keras 3 writes it."""
    return {"module": "keras", "class_name": "Sequential", "config": {
        "name": "head", "layers": [
            {"module": "keras.layers", "class_name": "InputLayer", "config": {
                "name": "input_layer", "batch_shape": [None, KERAS_HEAD_IN],
                "dtype": "float32"}},
            {"module": "keras.layers", "class_name": "Dense", "config": {
                "name": "dense", "units": units, "activation": "softmax",
                "use_bias": True, "dtype": {"module": "keras", "class_name": "DTypePolicy",
                                            "config": {"name": "float32"}}}},
        ]}}


def keras_file_view(path):
    """A Keras file as ``models/keras_port.py::port_keras_weights`` reads a
    built model, duck-typed (``keras_port.keras_layers_view``)."""
    from sparkdl_tpu_torch.models.keras_model import read_keras_file
    from sparkdl_tpu_torch.models.keras_port import keras_layers_view

    return keras_layers_view(*read_keras_file(path))


def host_ops(label: str, fn) -> None:
    """The host's time by ATen operator of one call of ``fn`` (a forward
    that the host's launches bound), under ``torch.profiler`` with CPU
    activity only: the self times summed, the calls counted, the six
    largest. Logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]
    log(f"  host ({label}): ATen self time {sum(e.self_cpu_time_total for e in ops) / 1e3:.3f} "
        f"ms over {sum(e.count for e in ops)} calls; "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in top))


def keras_half(card: str, counted):
    """Phase 10: InceptionV3 from a ``.keras`` file at full width on the
    card, through ``TorchFunction.from_keras``, ``KerasImageFileTransformer``
    and ``registerKerasImageUDF`` + ``session.sql``, and a Dense head through
    ``KerasTransformer`` and ``makeGraphUDF``, with the checks and times of
    the docstring."""
    import gzip
    import shutil

    import torch

    from sparkdl_tpu_torch import (
        DeepImageFeaturizer,
        KerasImageFileTransformer,
        KerasTransformer,
        makeGraphUDF,
        registerKerasImageUDF,
    )
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.models.keras_model import (
        KerasModel,
        read_keras_file,
        write_keras_file,
    )
    from sparkdl_tpu_torch.models.keras_port import port_keras_weights
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.named_image import build_module
    from sparkdl_tpu_torch.transformers.utils import decode_image_batch

    dev = torch.device("cuda")
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    counted[0]()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-keras-") as tmp:
        tmp = Path(tmp)
        # the files, made without Keras
        config = json.loads(gzip.decompress(KERAS_CONFIG.read_bytes()))
        weights = keras_inception_weights(config, seed=11)
        n_weights = sum(a.size for arrays in weights.values() for a in arrays)
        path = str(tmp / "inception_v3.keras")
        t0 = time.perf_counter()
        write_keras_file(path, config, weights)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        file_config, file_weights = read_keras_file(path)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        KerasModel(file_config, file_weights)
        build_s = time.perf_counter() - t0
        size_mb = Path(path).stat().st_size / 1e6
        log(f"keras: InceptionV3 .keras ({len(config['config']['layers'])} layers, "
            f"{n_weights} weights, {size_mb:.1f} MB) written in {write_s:.2f} s, read in "
            f"{read_s:.2f} s, built in {build_s:.2f} s")
        if n_weights != 23_851_784:
            raise AssertionError(f"InceptionV3 holds {n_weights} weights")
        rng = np.random.default_rng(12)
        head_w = (rng.standard_normal((KERAS_HEAD_IN, HEAD_CLASSES)) / np.sqrt(KERAS_HEAD_IN)
                  ).astype(np.float32)
        head_b = (0.1 * rng.standard_normal(HEAD_CLASSES)).astype(np.float32)
        head_path = str(tmp / "head.keras")
        write_keras_file(head_path, keras_head_config(HEAD_CLASSES), {"dense": [head_w, head_b]})

        # the weights carried across, float32 and bf16
        t0 = time.perf_counter()
        fns = {name: TorchFunction.from_keras(path, compute_dtype=name)
               for name in ("float32", "bfloat16")}
        log(f"  TorchFunction.from_keras, float32 and bf16: {time.perf_counter() - t0:.2f} s; "
            f"input_hw {fns['float32'].input_hw}, fingerprint "
            f"{fns['float32'].fingerprint.rsplit(':', 3)[-3:]}")
        if fns["float32"].input_hw != (299, 299):
            raise AssertionError(f"input_hw {fns['float32'].input_hw}")

        # the config-built graph against the registry's hand-written
        # InceptionV3 on the same weights and the same preprocessed batch
        x = torch.from_numpy(rng.uniform(0, 255, (CNN_BATCH, 299, 299, 3))
                             .astype(np.float32)).to(dev)
        xp = x / 127.5 - 1.0
        f32 = fns["float32"]
        f32_params = f32.placed_params(dev)
        with torch.inference_mode():
            probs = f32.apply(f32_params, xp)[0]
        entry = get_keras_application_model("InceptionV3")
        state = entry.state_dict_from_flax(port_keras_weights(keras_file_view(path)))
        hand = {dtype: build_module("InceptionV3", state, dtype, dev)
                for dtype in (torch.float32, torch.bfloat16)}
        with torch.inference_mode():
            want = torch.softmax(hand[torch.float32](nchw(xp)), dim=-1)
        err = (probs - want).abs().max().item()
        log(f"  float32 function vs the registry's InceptionV3 (hand-written) on the same "
            f"weights, {CNN_BATCH} preprocessed 299x299 images: max abs err {err:.3e} "
            f"(largest probability {want.max().item():.3e})")
        torch.testing.assert_close(probs, want, **PROB_TOL)

        # the function on the card against a CPU run of the port, 4 rows
        on_cpu = f32(xp[:4].cpu(), device="cpu")
        cpu_err = (probs[:4].cpu() - on_cpu).abs().max().item()
        log(f"  float32 function, card vs CPU (4 images): max abs err {cpu_err:.3e}")
        torch.testing.assert_close(probs[:4].cpu(), on_cpu, **SLICE_TOL)
        with torch.inference_mode():
            probs16 = fns["bfloat16"].apply(fns["bfloat16"].placed_params(dev), xp)[0].float()
        bf16_err = (probs16 - probs).abs().max().item()
        log(f"  bf16 vs float32 function: max abs err {bf16_err:.3e} "
            f"({bf16_err / probs.abs().max().item():.3e} of the largest)")
        if not bf16_err <= CNN_BF16_MAX_REL * probs.abs().max().item():
            raise AssertionError(f"bf16 function {bf16_err:.3e} from float32")

        # KerasImageFileTransformer over 128 .npy files
        uri_dir = tmp / "npy"
        uri_dir.mkdir()
        pixels = np.random.RandomState(13).randint(0, 256, (CNN_IMAGES, 299, 299, 3))
        uris = []
        for i, img in enumerate(pixels.astype(np.float32)):
            uris.append(str(uri_dir / f"img_{i:03d}.npy"))
            np.save(uris[-1], img)
        uri_df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=4)
        stage_args = dict(inputCol="uri", outputCol="preds", modelFile=path,
                          imageLoader=load_npy_tf, batchSize=CNN_BATCH)
        rows = {}
        for dtype in ("float32", "bfloat16"):
            out = KerasImageFileTransformer(computeDtype=dtype, **stage_args
                                            ).transform(uri_df).collect()
            rows[dtype] = vectors(out, "preds")
            if len(out) != CNN_IMAGES or rows[dtype].shape != (CNN_IMAGES, 1000) \
                    or not np.isfinite(rows[dtype]).all():
                raise AssertionError(f"bad KerasImageFileTransformer rows: {rows[dtype].shape}")
        batch = torch.from_numpy(np.stack([load_npy_tf(u) for u in uris[:CNN_BATCH]])).to(dev)
        with torch.inference_mode():
            direct = f32.apply(f32_params, batch)[0].cpu().numpy()
        np.testing.assert_allclose(rows["float32"][:CNN_BATCH], direct, **PROB_TOL)
        stage_bf16_err = np.abs(rows["bfloat16"] - rows["float32"]).max()
        log(f"keras: KerasImageFileTransformer over {CNN_IMAGES} .npy files in 4 partitions: "
            f"float32 rows vs the function on the same batch max abs err "
            f"{np.abs(rows['float32'][:CNN_BATCH] - direct).max():.3e}; bf16 vs float32 "
            f"{stage_bf16_err:.3e}")
        if not stage_bf16_err <= CNN_BF16_MAX_REL * np.abs(rows["float32"]).max():
            raise AssertionError(f"bf16 stage rows {stage_bf16_err:.3e} from float32")

        # registerKerasImageUDF in session.sql over phase 7's image structs
        image_df = session.createDataFrame(cnn_image_rows(CNN_IMAGES, seed=0), numPartitions=4)
        image_df.createOrReplaceTempView("images")
        registerKerasImageUDF("inception_udf", path, batchSize=CNN_BATCH)
        query = "SELECT inception_udf(image) AS preds FROM images"
        udf_rows = session.sql(query).collect()
        preds = vectors(udf_rows, "preds")
        if preds.shape != (CNN_IMAGES, 1000) or not np.isfinite(preds).all():
            raise AssertionError(f"bad UDF rows: {preds.shape}")
        images = [r["image"] for r in image_df.collect()]
        resized = decode_image_batch(images, (299, 299), always_resize=True, device=dev,
                                     to_rgb=True)
        want = np.concatenate([
            f32.apply(f32_params, torch.from_numpy(resized[i:i + CNN_BATCH]).to(dev))[0]
            .cpu().numpy() for i in range(0, CNN_IMAGES, CNN_BATCH)])
        np.testing.assert_allclose(preds, want, **SLICE_TOL)
        log(f"keras: registerKerasImageUDF + session.sql over {len(udf_rows)} image structs "
            f"(4 partitions, one mixed) vs the function on the same decoded, resized batch: "
            f"max abs err {np.abs(preds - want).max():.3e}")

        # the head: KerasTransformer and makeGraphUDF against float64 numpy
        feats = rows_array(DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="InceptionV3",
            modelWeights=flax_layout_inception_params(seed=3), batchSize=CNN_BATCH,
            computeDtype="float32").transform(image_df).collect())
        logits = feats.astype(np.float64) @ head_w + head_b
        z = np.exp(logits - logits.max(axis=1, keepdims=True))
        head_want = z / z.sum(axis=1, keepdims=True)
        feature_df = session.createDataFrame([{"features": v} for v in feats.astype(np.float32)],
                                             numPartitions=4)
        head_rows = KerasTransformer(inputCol="features", outputCol="probs",
                                     modelFile=head_path, batchSize=CNN_BATCH
                                     ).transform(feature_df).collect()
        head_got = np.stack([r["probs"] for r in head_rows])
        np.testing.assert_allclose(head_got, head_want, **PROB_TOL)
        makeGraphUDF(TorchFunction.from_keras(head_path), "head_udf", batchSize=CNN_BATCH)
        feature_df.createOrReplaceTempView("features")
        udf_probs = vectors(session.sql("SELECT head_udf(features) AS probs FROM features")
                            .collect(), "probs")
        np.testing.assert_allclose(udf_probs, head_want, **PROB_TOL)
        log(f"keras: the 2048 -> {HEAD_CLASSES} head over {len(head_rows)} rows of phase 7's "
            f"features: KerasTransformer max abs err {np.abs(head_got - head_want).max():.3e}, "
            f"makeGraphUDF {np.abs(udf_probs - head_want).max():.3e} against float64 numpy")
        launches = counted[1]()
        if any(launches.values()):
            raise AssertionError(f"the Keras path launched attention kernels: {launches}")
        log(f"  attention launches over the phase's path: {launches} (none)")

        # export, and a saved stage whose model file is gone
        loaded = saved_and_loaded(f32, ((2, 299, 299, 3), torch.float32), tmp)
        with torch.inference_mode():
            again = loaded.apply({}, xp)[0]
        torch.testing.assert_close(again, probs, **SLICE_TOL)
        log(f"  the .keras function exported, saved, loaded: max abs err "
            f"{(again - probs).abs().max().item():.3e} against the in-memory function")
        own_copy = str(tmp / "stage_model.keras")
        shutil.copy(path, own_copy)
        stage = KerasImageFileTransformer(**{**stage_args, "modelFile": own_copy})
        first = vectors(stage.transform(uri_df).collect(), "preds")
        stage.write().overwrite().save(str(tmp / "stage"))
        Path(own_copy).unlink()
        reloaded = KerasImageFileTransformer.load(str(tmp / "stage"))
        if not np.array_equal(vectors(reloaded.transform(uri_df).collect(), "preds"), first):
            raise AssertionError("the reloaded KerasImageFileTransformer's rows differ")
        log("  save/load: the reloaded KerasImageFileTransformer, its model file removed, "
            "gives the same rows bit for bit")
        del loaded, reloaded, stage

        # times
        for dtype, module in hand.items():
            name = str(dtype).removeprefix("torch.")
            fn = fns[name]
            params = fn.placed_params(dev)
            with torch.inference_mode():
                fn_ms = time_ms(lambda: fn.apply(params, xp), iters=10)
                hand_ms = time_ms(lambda: module(nchw(xp).to(dtype)), iters=10)
            log(f"keras: forward at batch {CNN_BATCH}, InceptionV3 {name} ({card}): the .keras "
                f"function {fn_ms:.3f} ms, the registry's module {hand_ms:.3f} ms")
        bf16_params = fns["bfloat16"].placed_params(dev)
        with torch.inference_mode():
            wall = time_ms(lambda: fns["bfloat16"].apply(bf16_params, xp), iters=10)
            profile_forward(lambda: fns["bfloat16"].apply(bf16_params, xp), wall)
            host_ops("bf16, the .keras function", lambda: fns["bfloat16"].apply(bf16_params, xp))
            host_ops("bf16, the registry's module",
                     lambda: hand[torch.bfloat16](nchw(xp).to(torch.bfloat16)))
        del hand
        images_per_s(lambda: KerasImageFileTransformer(computeDtype="bfloat16", **stage_args)
                     .transform(uri_df).collect(), CNN_IMAGES, "KerasImageFileTransformer",
                     "InceptionV3 bf16, .npy files, 4 partitions", card)
        registerKerasImageUDF("inception_udf_bf16", path, batchSize=CNN_BATCH,
                              computeDtype="bfloat16")
        images_per_s(lambda: session.sql("SELECT inception_udf_bf16(image) AS preds "
                                         "FROM images").collect(),
                     CNN_IMAGES, "registerKerasImageUDF",
                     "InceptionV3 bf16, image structs, 4 partitions, one mixed", card)
        featurizer_rate(DeepImageFeaturizer(inputCol="image", outputCol="features",
                                            modelName="InceptionV3",
                                            modelWeights=flax_layout_inception_params(seed=3),
                                            batchSize=CNN_BATCH, computeDtype="bfloat16"),
                        image_df, "InceptionV3 bf16, beside them", card)
    del fns
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 11: the Keras fine-tune, BASELINE.json configs[3]
# ----------------------------------------------------------------------
RESNET_HEAD_CONFIG = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / \
    "keras_resnet50_head.config.json.gz"
FT_BATCH = 64           # benchmarks/bench_finetune.py's shape
FT_CLASSES = 5
FT_IMAGE = 224
FT_STEPS = 10
FT_LR = 0.01
FT_FIT_IMAGES = 128
FT_SWEEP_IMAGES = 32
# one sgd step of the ResNet50 head on the card (TF32 off) and on the CPU,
# both held to a float64 step on the CPU: the loss to 1e-4 relative; each
# trainable leaf's change (of at least 1e-3 of the largest change in norm:
# the conv biases before each batch norm take a gradient that is zero but
# for float noise) within 1e-3 of the float64 change, or within 3x the CPU
# float32 step's own error where float32 cannot do better (a batch norm's
# gamma gradient sums 64 x 14 x 14 terms that nearly cancel); each moving
# statistic to atol=1e-5, rtol=1e-4 of the CPU float32 step's
FT_LOSS_RTOL = 1e-4
FT_CHANGE_RTOL = 1e-3
FT_CHANGE_CPU_FACTOR = 3.0
FT_STAT_TOL = dict(atol=1e-5, rtol=1e-4)
# PyTorch's defaults, under which the step is timed: cuDNN convolutions in
# TF32, matrix products in full float32 (the script sets both off for its
# checks)
LIBRARY_TF32 = (True, False)


def resnet_head_weights(config, seed: int):
    """Seeded weights for the ResNet50-head config, in the nested form
    ``read_keras_file`` gives: He-normal conv kernels, zero biases, batch
    norm gamma 1, beta 0, moving mean 0 and variance 1, the Dense at
    1/sqrt(in). Shapes from each layer's ``build_config``. The batch norm
    that ends each residual branch (``_3_bn``) takes gamma 0.2, as phase 8's
    zoo weights do: at gamma 1 the residual sums double the variance each
    block, and the head's softmax saturates at inference, where the clipped
    cross-entropy has no gradient."""
    rng = np.random.default_rng(seed)

    def draw(layers):
        weights = {}
        for layer in layers:
            cfg, cls = layer["config"], layer["class_name"]
            if cls == "Functional":
                weights[cfg["name"]] = draw(cfg["layers"])
                continue
            shape = (layer.get("build_config") or {}).get("input_shape")
            if cls == "Conv2D":
                kh, kw = cfg["kernel_size"]
                cin, cout = shape[-1], cfg["filters"]
                kernel = rng.standard_normal((kh, kw, cin, cout), dtype=np.float32)
                weights[cfg["name"]] = [kernel * np.float32((2.0 / (kh * kw * cin)) ** 0.5),
                                        np.zeros(cout, np.float32)]
            elif cls == "BatchNormalization":
                c = shape[cfg["axis"][0] if isinstance(cfg["axis"], list) else cfg["axis"]]
                gamma = np.float32(0.2 if cfg["name"].endswith("_3_bn") else 1.0)
                weights[cfg["name"]] = [np.full(c, gamma), np.zeros(c, np.float32),
                                        np.zeros(c, np.float32), np.ones(c, np.float32)]
            elif cls == "Dense":
                cin = shape[-1]
                kernel = rng.standard_normal((cin, cfg["units"]), dtype=np.float32)
                weights[cfg["name"]] = [kernel * np.float32(cin ** -0.5),
                                        np.zeros(cfg["units"], np.float32)]
        return weights

    return draw(config["config"]["layers"])


def flat_weights(tree, prefix=""):
    """A nested weights mapping as ``{"layer/i" or "model/layer/i": array}``."""
    out = {}
    for name, arrays in tree.items():
        if isinstance(arrays, dict):
            out.update(flat_weights(arrays, f"{prefix}{name}/"))
        else:
            out.update({f"{prefix}{name}/{i}": a for i, a in enumerate(arrays)})
    return out


def keras_step(path, device, batch, frozen_base: bool = False, float64: bool = False):
    """A ``KerasModel`` of the file on ``device`` and its one-step sgd
    state and step: ``(module, state, step, batch on the device)``.
    ``float64`` runs every layer in float64 (the reference step)."""
    import torch

    from sparkdl_tpu_torch.estimators.losses import get_optimizer, get_per_sample_loss_fn
    from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file
    from sparkdl_tpu_torch.parallel.keras_train import (
        init_keras_train_state,
        make_keras_train_step,
    )

    config, weights = read_keras_file(path)
    if frozen_base:
        config["config"]["layers"][1]["config"]["trainable"] = False
    module = KerasModel(config, weights).to(device)
    if float64:
        module.double()
        for layer in module.modules():
            if hasattr(layer, "layer_name"):
                layer.dtype = torch.float64
    state = init_keras_train_state(module, get_optimizer("sgd", FT_LR))
    step = make_keras_train_step(get_per_sample_loss_fn("sparse_categorical_crossentropy"),
                                 weighted=True)
    placed = {k: v.to(device) for k, v in batch.items()}
    return module, state, step, placed


def keras_train_flops(module, x) -> float:
    """Operations of one training step of ``module`` on ``x``: the forward's
    convolutions and Dense layers, 2 per multiply-add, counted from the
    shapes of what ran, times 3 (the backward takes two products per
    forward product: the input's gradient and the weight's)."""
    import torch

    from sparkdl_tpu_torch.models.layers import Conv

    total = [0.0]

    def hook(mod, _inp, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * mod.in_features
        else:
            total[0] += 2.0 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, (Conv, torch.nn.Linear))]
    module.eval()  # the moving statistics stay as they are
    try:
        with torch.inference_mode():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return 3 * total[0]


def finetune_batch() -> dict:
    """Phase 11's batch: 64 seeded 224x224 images, labels and weights (CPU
    tensors)."""
    import torch

    rng = np.random.default_rng(22)
    return {"x": torch.from_numpy(rng.uniform(0, 1, (FT_BATCH, FT_IMAGE, FT_IMAGE, 3))
                                  .astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, FT_CLASSES, FT_BATCH).astype(np.int32)),
            "w": torch.ones(FT_BATCH)}


P11_CPU_TIMEOUT_S = 600.0
# phase 11's two CPU steps (float32, and the float64 reference) in a child
# process at the lowest CPU priority; its last line is each step's loss and
# seconds, as JSON after the marker, and each step's weights are pickled
# beside the model file
P11_CPU_STEPS = """
import json, os, pickle, sys, time
os.nice(19)
sys.path.insert(0, {root!r})
import chip_smoke as cs
out = {{}}
for label, wide in (("cpu", False), ("float64", True)):
    module, state, step, placed = cs.keras_step({path!r}, "cpu", cs.finetune_batch(),
                                                float64=wide)
    t0 = time.perf_counter()
    state, loss = step(state, placed)
    weights = cs.flat_weights(module.keras_weights())
    out[label] = {{"loss": float(loss), "seconds": time.perf_counter() - t0}}
    with open(os.path.join({dir!r}, label + ".pkl"), "wb") as fh:
        pickle.dump(weights, fh)
    del module, state, placed, weights
print("P11_CPU_STEPS " + json.dumps(out), flush=True)
"""


class NicedChild:
    """A Python child process that runs ``code`` (``args`` are its
    ``sys.argv[1:]``; the code lowers its own priority with ``os.nice(19)``),
    its output in the file ``log_path``, its result the JSON after
    ``marker`` on its last line. :meth:`wait` joins it; :meth:`stop` kills it
    if it still runs."""

    def __init__(self, code: str, marker: str, log_path, args=(), env=None):
        self.marker = marker + " "
        self.log = open(log_path, "w+")
        self.result = None
        self.proc = subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                                     stdout=self.log, stderr=subprocess.STDOUT)

    def wait(self, timeout: float, what: str):
        """The child's result once it has ended; raises, naming ``what``,
        with its output's end if it failed."""
        if self.result is None:
            rc = self.proc.wait(timeout=timeout)
            self.log.seek(0)
            text = self.log.read()
            lines = [line for line in text.splitlines() if line.startswith(self.marker)]
            if rc != 0 or not lines:
                raise AssertionError(f"{what} failed (exit {rc}):\n{text[-4000:]}")
            self.result = json.loads(lines[-1][len(self.marker):])
        return self.result

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


class FineTuneReference:
    """Phase 11's ``.keras`` file of the ResNet50 head, written here, and its
    two CPU steps (``P11_CPU_STEPS``) in a child process at the lowest CPU
    priority, started after phase 6 so that their minute of CPU work runs
    beside phases 7-11's card work and not in phase 11. :meth:`wait` joins
    it; :meth:`close` stops it if it still runs and removes its files."""

    def __init__(self):
        import gzip
        import os

        from sparkdl_tpu_torch.models.keras_model import write_keras_file

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-finetune-")
        self.path = os.path.join(self.dir, "resnet50_head.keras")
        config = json.loads(gzip.decompress(RESNET_HEAD_CONFIG.read_bytes()))
        weights = resnet_head_weights(config, seed=21)
        t0 = time.perf_counter()
        write_keras_file(self.path, config, weights)
        self.write_s = time.perf_counter() - t0
        self.result = None
        code = P11_CPU_STEPS.format(root=str(Path(__file__).resolve().parent),
                                    path=self.path, dir=self.dir)
        self.child = NicedChild(code, "P11_CPU_STEPS", os.path.join(self.dir, "cpu_steps.log"))

    def wait(self) -> dict:
        """``{"cpu": (loss, weights, seconds), "float64": (...)}`` of the two
        steps once the child has ended; raises with its output's end if it
        failed."""
        import os
        import pickle

        if self.result is None:
            t0 = time.perf_counter()
            steps = self.child.wait(P11_CPU_TIMEOUT_S, "phase 11's CPU steps")
            waited = time.perf_counter() - t0
            self.result = {}
            for label, step in steps.items():
                with open(os.path.join(self.dir, label + ".pkl"), "rb") as fh:
                    self.result[label] = step["loss"], pickle.load(fh), step["seconds"]
            log(f"finetune: the CPU steps ran in a child process beside phases 7-11; phase "
                f"11 waited {waited:.2f} s for them")
        return self.result

    def close(self) -> None:
        import shutil

        self.child.stop()
        shutil.rmtree(self.dir, ignore_errors=True)


def keras_fine_tune(card: str, counted, reference: FineTuneReference):
    """Phase 11: ``KerasImageFileEstimator`` fine-tuning the ResNet50 head
    of BASELINE.json ``configs[3]`` at full width, with the checks and
    times of the docstring; the model file and the two CPU steps are
    ``reference``'s."""
    import gzip

    import torch

    from sparkdl_tpu_torch import (
        KerasImageFileEstimator,
        KerasImageFileTransformer,
        ParamGridBuilder,
    )
    from sparkdl_tpu_torch.models.keras_model import read_keras_file, write_keras_file
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.utils.metrics import metrics

    dev = torch.device("cuda")
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    counted[0]()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-finetune-") as tmp:
        tmp = Path(tmp)
        config = json.loads(gzip.decompress(RESNET_HEAD_CONFIG.read_bytes()))
        start = flat_weights(resnet_head_weights(config, seed=21))
        n_weights = sum(a.size for a in start.values())
        path = reference.path
        log(f"finetune: the ResNet50 head .keras (nested Functional of "
            f"{len(config['config']['layers'][1]['config']['layers'])} layers + Dense "
            f"{FT_CLASSES}, {n_weights} weights, {Path(path).stat().st_size / 1e6:.1f} MB) "
            f"written in {reference.write_s:.2f} s")
        if n_weights != 23_597_957:
            raise AssertionError(f"the ResNet50 head holds {n_weights} weights")
        batch = finetune_batch()

        # 1. one sgd step on the card, TF32 off, held (after 5., once the
        # CPU's two steps have ended beside this phase) to a float64 step on
        # the CPU, and the CPU's float32 step beside it
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        module, state, step, placed = keras_step(path, "cuda", batch)
        t0 = time.perf_counter()
        state, loss = step(state, placed)
        card_loss = float(loss)
        got = flat_weights(module.keras_weights())
        card_s = time.perf_counter() - t0
        trainable = {n for n, p in module.named_parameters() if p.requires_grad}
        del module, state, placed
        torch.cuda.empty_cache()

        # the weights written back: the port's file reads back bit for bit
        module, state, step, placed = keras_step(path, dev, batch)
        state, _ = step(state, placed)
        tuned = module.keras_weights()
        write_keras_file(str(tmp / "tuned.keras"), config, tuned)
        back = flat_weights(read_keras_file(str(tmp / "tuned.keras"))[1])
        if not all(np.array_equal(a, back[k]) for k, a in flat_weights(tuned).items()):
            raise AssertionError("the tuned .keras file does not read back bit for bit")
        log("  the stepped module's weights written by write_keras_file read back bit for bit")

        # 2. a frozen base: bit for bit unchanged; the head moves
        fmodule, fstate, fstep, fplaced = keras_step(path, dev, batch, frozen_base=True)
        fstate, _ = fstep(fstate, fplaced)
        frozen = flat_weights(fmodule.keras_weights())
        base = [k for k in start if k.startswith("resnet50/")]
        moved = [k for k in base if not np.array_equal(frozen[k], start[k])]
        head_moved = [k for k in start if k.startswith("dense/")
                      and not np.array_equal(frozen[k], start[k])]
        log(f"  frozen base (trainable: false): {len(base) - len(moved)} of {len(base)} base "
            f"arrays bit for bit unchanged, {len(head_moved)} of 2 head arrays moved; "
            f"{len(fstate.opt_state.param_groups[0]['params'])} tensors optimized")
        if moved or len(head_moved) != 2:
            raise AssertionError(f"frozen base moved {moved[:3]}, head moved {head_moved}")
        del fmodule, fstate, fplaced

        # 3. the step time, bench_finetune.py's way: 2 warm steps, then 10
        # chained and synchronized once; the median of 3, CUDA events
        setting = (f"the library's default: cudnn.allow_tf32={LIBRARY_TF32[0]}, "
                   f"matmul.allow_tf32={LIBRARY_TF32[1]}")
        flops = keras_train_flops(module, placed["x"])
        nbytes = 4 * (3 * n_weights + placed["x"].numel())
        ops_ms, bytes_ms = (flops / PEAK_FLOPS["float32"] * 1e3,
                            nbytes / PEAK_BYTES_PER_S * 1e3)
        tf32_ms = flops / 495e12 * 1e3

        def steps(k):
            nonlocal state
            for _ in range(k):
                state, _ = step(state, placed)

        times = {}
        for label, flags in (("default", LIBRARY_TF32), ("TF32 off", (False, False))):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            steps(2)
            torch.cuda.reset_peak_memory_stats()
            times[label] = sorted(time_ms(lambda: steps(FT_STEPS), iters=1, warmup=0)
                                  / FT_STEPS for _ in range(3))
        ms = times["default"][1]
        log(f"finetune: ResNet50 head training step at batch {FT_BATCH}, {FT_IMAGE}x"
            f"{FT_IMAGE}, {FT_CLASSES} classes, sgd, all layers trainable ({card}): "
            f"{ms:.3f} ms/step median of "
            + ", ".join(f"{t:.3f}" for t in times["default"])
            + f" ({setting}); TF32 off: " + ", ".join(f"{t:.3f}" for t in times["TF32 off"])
            + f" ms; {FT_BATCH / ms * 1e3:.1f} images/s; {flops / 1e12:.3f} TFLOP a step "
            f"from the shapes, bound {max(ops_ms, bytes_ms):.3f} ms at the float32 peak "
            f"({tf32_ms:.3f} ms at the TF32 peak, bytes {bytes_ms:.4f} ms); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = LIBRARY_TF32
        profile_forward(lambda: steps(1), ms)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        del module, state, placed
        torch.cuda.empty_cache()

        # 4. KerasImageFileEstimator.fit over 128 .npy files, epochs 1, batch 64
        uri_dir = tmp / "npy"
        uri_dir.mkdir()
        pixels = np.random.RandomState(23).uniform(0, 1, (FT_FIT_IMAGES, FT_IMAGE, FT_IMAGE, 3))
        rows = []
        for i, img in enumerate(pixels.astype(np.float32)):
            # the class lifts one channel, so the labels are in the pixels
            label = i % FT_CLASSES
            img[..., label % 3] += 0.5 * (label / FT_CLASSES)
            rows.append({"uri": str(uri_dir / f"img_{i:03d}.npy"), "label": label})
            np.save(rows[-1]["uri"], img)
        df = session.createDataFrame(rows, numPartitions=4)
        est = KerasImageFileEstimator(
            inputCol="uri", outputCol="probs", labelCol="label", imageLoader=load_npy,
            modelFile=path, kerasOptimizer="sgd", kerasLoss="sparse_categorical_crossentropy",
            kerasFitParams={"epochs": 1, "batch_size": FT_BATCH, "learning_rate": FT_LR})
        metrics.reset()
        t0 = time.perf_counter()
        fitted = est.fit(df)
        fit_s = time.perf_counter() - t0
        snap = metrics.snapshot()
        if not isinstance(fitted, KerasImageFileTransformer) or \
                len(fitted._training_losses) != FT_FIT_IMAGES // FT_BATCH \
                or not np.isfinite(fitted._training_losses).all():
            raise AssertionError(f"bad fit: {getattr(fitted, '_training_losses', None)}")
        log(f"finetune: KerasImageFileEstimator.fit, {FT_FIT_IMAGES} .npy files "
            f"{FT_IMAGE}x{FT_IMAGE}, epochs 1, batch {FT_BATCH} ({card}): {fit_s:.2f} s, "
            f"{FT_FIT_IMAGES / fit_s:.1f} images/s; sparkdl.load "
            f"{snap.get('sparkdl.load.seconds', 0.0):.3f} s, estimator.step "
            f"{snap.get('estimator.step.seconds', 0.0):.3f} s over "
            f"{snap.get('estimator.steps', 0.0):.0f} steps; losses "
            + ", ".join(f"{v:.4f}" for v in fitted._training_losses))
        tuned_file = flat_weights(read_keras_file(fitted.getModelFile())[1])
        if set(tuned_file) != set(start) or all(np.array_equal(tuned_file[k], start[k])
                                                for k in start):
            raise AssertionError("the tuned file holds other weights or none moved")
        scored = fitted.transform(df).collect()
        probs = vectors(scored, "probs")
        if probs.shape != (FT_FIT_IMAGES, FT_CLASSES) or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"bad scores of the fitted model: {probs.shape}")
        images_per_s(lambda: fitted.transform(df).collect(), FT_FIT_IMAGES,
                     "fitted KerasImageFileTransformer", "ResNet50 head float32, .npy files",
                     card)

        # 5. the sweep: fitMultiple over two learning rates, 32 images
        grid = ParamGridBuilder().addGrid(est.kerasFitParams, [
            {"epochs": 1, "batch_size": 16, "learning_rate": lr} for lr in (1e-2, 1e-3)
        ]).build()
        small = session.createDataFrame(rows[:FT_SWEEP_IMAGES], numPartitions=2)
        labels = np.array([r["label"] for r in rows[:FT_SWEEP_IMAGES]])
        t0 = time.perf_counter()
        models = [None] * len(grid)
        for index, model in est.fitMultiple(small, grid):
            models[index] = model
        sweep_s = time.perf_counter() - t0
        accuracy = [float((vectors(m.transform(small).collect(), "probs").argmax(axis=1)
                           == labels).mean()) for m in models]
        log(f"finetune: sweep, fitMultiple over kerasFitParams learning_rate (1e-2, 1e-3), "
            f"{FT_SWEEP_IMAGES} images, epochs 1, batch 16 ({card}): {sweep_s:.2f} s, "
            f"{sweep_s / len(grid):.2f} s a fit; training accuracy by argmax {accuracy}")
        if len({m.getModelFile() for m in models}) != 2:
            raise AssertionError("the sweep's models share a file")

        # 1., its checks
        (cpu_loss, want, cpu_s), (loss64, ref, ref_s) = [reference.wait()[k]
                                                         for k in ("cpu", "float64")]
        bn_names = {layer["config"]["name"] for layer
                    in config["config"]["layers"][1]["config"]["layers"]
                    if layer["class_name"] == "BatchNormalization"}
        stats = [k for k in start if k.split("/")[-1] in ("2", "3")
                 and k.split("/")[-2] in bn_names]
        changes = {k: ref[k] - start[k] for k in start if k not in stats}
        floor = 1e-3 * max(np.linalg.norm(c) for c in changes.values())

        def change_errors(weights):
            return {k: float(np.linalg.norm((weights[k] - start[k]) - c)
                             / max(np.linalg.norm(c), floor)) for k, c in changes.items()}

        card_errs, cpu_errs = change_errors(got), change_errors(want)
        bad = [k for k in changes if not card_errs[k] <= max(
            FT_CHANGE_RTOL, FT_CHANGE_CPU_FACTOR * cpu_errs[k])]
        worst = sorted(card_errs, key=lambda k: -card_errs[k])[:3]
        stat_errs = {k: float(np.abs(got[k] - want[k]).max()) for k in stats}
        log(f"finetune: one sgd({FT_LR}) step at batch {FT_BATCH}, {FT_IMAGE}x{FT_IMAGE}, "
            f"TF32 off: loss card {card_loss:.7f}, CPU {cpu_loss:.7f}, float64 {loss64:.7f}; "
            f"{len(trainable)} trainable tensors, {len(changes)} weight leaves; change errors "
            f"against float64, card (CPU float32): median "
            f"{np.median(list(card_errs.values())):.3e} ({np.median(list(cpu_errs.values())):.3e}), "
            f"worst " + ", ".join(f"{k} {card_errs[k]:.3e} ({cpu_errs[k]:.3e})" for k in worst)
            + f"; {sum(card_errs[k] > FT_CHANGE_RTOL for k in changes)} leaves past "
            f"{FT_CHANGE_RTOL:g}; {len(stats)} moving statistics, card vs CPU max abs err "
            f"{max(stat_errs.values()):.3e}; card step {card_s:.2f} s (first), CPU "
            f"{cpu_s:.2f} s, float64 {ref_s:.2f} s")
        for other in (card_loss, cpu_loss):
            if not abs(other - loss64) <= FT_LOSS_RTOL * abs(loss64):
                raise AssertionError(f"fine-tune loss {other} vs float64 {loss64}")
        if bad:
            raise AssertionError("fine-tune weight changes differ: " + ", ".join(
                f"{k} {card_errs[k]:.3e} (CPU {cpu_errs[k]:.3e})" for k in bad[:5]))
        for k in stats:
            np.testing.assert_allclose(got[k], want[k], **FT_STAT_TOL, err_msg=k)
        if all(np.array_equal(got[k], start[k]) for k in stats):
            raise AssertionError("no moving statistic moved")
        del got, want, ref

        launches = counted[1]()
        if any(launches.values()):
            raise AssertionError(f"the fine-tune path launched attention kernels: {launches}")
        log(f"  attention launches over the phase's path: {launches} (none)")
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 12: the estimators' remainder: checkpoint and resume, preemption,
# streaming, the optax optimizers
# ----------------------------------------------------------------------

# the five optimizers, card against CPU over three updates of the same
# weights and gradients (float32 both): the largest difference within 1e-4
# of the largest change. rsqrt, sqrt and lamb's norms round differently on
# the two devices, a few ulps of each update; a sign that parts in lion, or
# a state that is not carried, moves a weight by a whole update
OPT_CHANGE_RTOL = 1e-4
OPTAX_NAMES = ("rmsprop", "adagrad", "nadam", "lamb", "lion")


def differing(a, b) -> list:
    """Names of the entries of two ``{name: tensor or array}`` that are not
    equal bit for bit (or missing from one)."""
    import torch

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x.cpu(), y.cpu())
        return np.array_equal(x, y)

    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not same(a[k], b[k])]


def deterministic_pair(label: str, fit, weights_of):
    """Two uninterrupted fits, compared bit for bit. Equal: returns the
    first fit and "default". Not equal: deterministic algorithms on
    (cuBLAS's workspace setting, ``torch.use_deterministic_algorithms``,
    ``cudnn.deterministic``), two fits again, which must then be equal."""
    import os

    import torch
    from sparkdl_tpu_torch.utils.metrics import metrics

    def step_ms():
        return 1e3 * metrics.timer("estimator.step").seconds / metrics.counter(
            "estimator.steps").value

    def two():
        # the step time of the second fit, warm
        first = fit()
        metrics.reset()
        second = fit()
        return first, differing(weights_of(first), weights_of(second)), step_ms()

    first, bad, default_ms = two()
    if not bad:
        log(f"{label}: two uninterrupted fits bit for bit equal under the default "
            f"algorithms ({default_ms:.3f} ms a step in the second)")
        return first, "default"
    log(f"{label}: two uninterrupted fits differ in {len(bad)} tensors ({bad[:4]}): "
        f"deterministic algorithms on")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    first, bad, det_ms = two()
    if bad:
        raise AssertionError(f"{label}: two fits differ under deterministic algorithms: {bad[:4]}")
    log(f"{label}: bit for bit equal under deterministic algorithms; a step of the "
        f"second fit {det_ms:.3f} ms against {default_ms:.3f} ms under the default ones")
    return first, "deterministic"


def checkpoint_times(label: str, card: str) -> None:
    """The ``estimator.checkpoint*`` metrics since the last reset: each
    save's dispatch and background commit, the bytes, the restore."""
    from sparkdl_tpu_torch.utils.metrics import metrics

    dispatch = metrics.histogram("estimator.checkpoint_ms").values()
    commit = metrics.histogram("estimator.checkpoint_commit_ms").values()
    nbytes = metrics.counter("estimator.checkpoint_bytes").value
    log(f"  {label} checkpoints ({card}): save dispatch "
        + ", ".join(f"{v:.1f}" for v in dispatch) + " ms; background commit "
        + ", ".join(f"{v:.1f}" for v in commit) + f" ms; "
        f"{nbytes / max(len(commit), 1) / 1e9:.4f} GB an epoch; restore "
        f"{1e3 * metrics.timer('estimator.restore').seconds:.1f} ms")


def vit_checkpoint_resume(card: str, counted, train_params) -> dict:
    """Phase 12 (a): ViT-B/16 checkpoint, resume and preemption at full
    width through kernels #1-#4. Returns the launches of the resumed fit
    and of its fitted transform."""
    import logging

    import torch

    from sparkdl_tpu_torch.estimators import checkpointing
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.resilience import FaultPlan, Preempted, active_plan
    from sparkdl_tpu_torch.utils.metrics import metrics

    reset, read = counted
    # an epoch of 64 images at batch 32, and a transform at the default
    # batch 32: 12 blocks x 2 batches
    expected = 12 * (N_IMAGES // BATCH)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(tmp / f"img_{i:03d}.npy", rng.random((224, 224, 3), dtype=np.float32))
        uris = sorted(str(p) for p in tmp.glob("*.npy"))
        df = training_df(uris)

        def estimator(epochs, ckpt=None):
            return train_estimator(
                ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash"),
                train_params, checkpointDir=ckpt,
                fitParams={"epochs": epochs, "batch_size": BATCH,
                           "learning_rate": TRAIN_LR, "seed": 0})

        def weights(fitted):
            return {n: t.detach().cpu() for n, t in fitted.module.state_dict().items()}

        straight, mode = deterministic_pair(
            "checkpoint (ViT-B/16, 2 epochs of 2 steps, adam)",
            lambda: estimator(2).fit(df), weights)
        want = weights(straight)

        # fit(1) with a checkpoint, then a fresh estimator's fit(2) resumes
        ckpt = str(tmp / "ckpt")
        metrics.reset()
        one = estimator(1, ckpt).fit(df)
        one_weights = weights(one)
        records = []

        class Catch(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        catch = Catch()
        est_logger = logging.getLogger("sparkdl_tpu_torch.estimators.checkpointing")
        est_logger.addHandler(catch)
        est_logger.setLevel(logging.INFO)
        try:
            reset()
            resumed = estimator(2, ckpt).fit(df)
            torch.cuda.synchronize()
            fit_counts = read()
        finally:
            est_logger.removeHandler(catch)
        if not any("resuming from checkpoint epoch 1" in r for r in records):
            raise AssertionError(f"the resumed fit did not log its resume: {records}")
        bad = differing(weights(resumed), want)
        log(f"checkpoint: fit(1) then a fresh fit(2) resumed from epoch 1 ({mode} algorithms): "
            f"launches {fit_counts} (expected {expected} with lse, dQ and dK/dV: 12 "
            f"blocks x 2 steps); {len(want) - len(bad)} of {len(want)} tensors bit for bit "
            f"the uninterrupted fit's; last loss {resumed._training_loss!r} vs "
            f"{straight._training_loss!r}")
        if list(fit_counts.values()) != [0, expected, expected, expected]:
            raise AssertionError(f"resumed fit launches {fit_counts}")
        if bad or resumed._training_loss != straight._training_loss:
            raise AssertionError(f"the resumed fit differs from the uninterrupted one: {bad[:4]}")
        epoch_dir = checkpointing.epoch_path(ckpt, estimator(2, ckpt)._ckpt_namespace(), 1)
        on_disk = sum(f.stat().st_size for f in Path(epoch_dir).iterdir())
        checkpoint_times("ViT-B/16", card)
        log(f"  epoch_1 on disk: {on_disk / 1e9:.4f} GB")

        # the fitted transformer of the resumed fit, through the lse-free kernel
        reset()
        tuned = vectors(resumed.transform(df).collect(), "features")
        tuned_counts = read()
        log(f"  the resumed fit's transform: {len(tuned)} rows, launches {tuned_counts}")
        if list(tuned_counts.values()) != [expected, 0, 0, 0] or not np.isfinite(tuned).all():
            raise AssertionError(f"the resumed fit's transform: launches {tuned_counts}")

        # fit(1) again: epoch 1 from disk, no training
        reset()
        again = estimator(1, ckpt).fit(df)
        again_counts = read()
        bad = differing(weights(again), one_weights)
        log(f"  fit(1) again on the directory: {len(one_weights) - len(bad)} of "
            f"{len(one_weights)} tensors bit for bit epoch 1's, launches {again_counts}")
        if bad or any(again_counts.values()):
            raise AssertionError(f"fit(1) again: {bad[:4]}, launches {again_counts}")
        del one, again

        # preempted at global step 3 (epoch 2's first), raised at the next
        # step boundary; epoch 1 committed; the re-fit equals fit(2)
        pre = str(tmp / "preempt")
        est = estimator(2, pre)
        try:
            with active_plan(FaultPlan().add("estimator.step", preempt=True, at=3)):
                est.fit(df)
        except Preempted as exc:
            log(f"  preempted: {exc}")
        else:
            raise AssertionError("the planned preemption did not stop the fit")
        committed = checkpointing.committed_epochs(pre, est._ckpt_namespace())
        refit = estimator(2, pre).fit(df)
        bad = differing(weights(refit), want)
        log(f"  after the preemption: committed epochs {committed}; the re-fit "
            f"{len(want) - len(bad)} of {len(want)} tensors bit for bit the uninterrupted fit's")
        if committed != [1] or bad:
            raise AssertionError(f"preemption: committed {committed}, differing {bad[:4]}")
        del refit, resumed

        # a checkpointed 2-epoch fit from scratch: the second save waits for
        # the first commit where the commit outlasts the epoch's steps
        metrics.reset()
        t0 = time.perf_counter()
        timed = estimator(2, str(tmp / "timed")).fit(df)
        fit_s = time.perf_counter() - t0
        steps = metrics.counter("estimator.steps").value
        log(f"  checkpointed fit(2) from scratch ({card}): {fit_s:.3f} s, "
            f"{1e3 * metrics.timer('estimator.step').seconds / steps:.3f} ms a step "
            f"({int(steps)} steps)")
        checkpoint_times("ViT-B/16 fit(2)", card)
        if differing(weights(timed), want):
            raise AssertionError("the checkpointed fit differs from the uninterrupted one")
        del timed, straight
    if mode == "deterministic":
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return {"fit": fit_counts, "transform": tuned_counts}


def optax_updates(module, name: str, device: str, grads) -> dict:
    """Three updates of ``module``'s trainable weights by the optimizer
    ``name`` on ``device`` with the gradients ``grads``; the weights after."""
    import copy

    import torch

    from sparkdl_tpu_torch.estimators.losses import get_optimizer

    module = copy.deepcopy(module).to(device)
    params = [p for p in module.parameters() if p.requires_grad]
    opt = get_optimizer(name)(params)
    for step in grads:
        for p, g in zip(params, step):
            p.grad = g.to(device)
        opt.step()
    return {i: p.detach().cpu() for i, p in enumerate(params)}


def keras_remainder(card: str, counted) -> None:
    """Phase 12 (b): the ResNet50-head fine-tune with checkpoints,
    streaming and the five optax optimizers; no attention kernel."""
    import gzip

    import torch

    from sparkdl_tpu_torch import KerasImageFileEstimator
    from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file, write_keras_file
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.utils.metrics import metrics

    counted[0]()
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-keras-ckpt-") as tmp:
        tmp = Path(tmp)
        config = json.loads(gzip.decompress(RESNET_HEAD_CONFIG.read_bytes()))
        start_tree = resnet_head_weights(config, seed=21)
        start = flat_weights(start_tree)
        path = str(tmp / "resnet50_head.keras")
        write_keras_file(path, config, start_tree)
        pixels = np.random.RandomState(23).uniform(0, 1, (FT_FIT_IMAGES, FT_IMAGE, FT_IMAGE, 3))
        rows = []
        for i, img in enumerate(pixels.astype(np.float32)):
            label = i % FT_CLASSES
            img[..., label % 3] += 0.5 * (label / FT_CLASSES)
            rows.append({"uri": str(tmp / f"img_{i:03d}.npy"), "label": label})
            np.save(rows[-1]["uri"], img)
        df = session.createDataFrame(rows, numPartitions=4)

        def estimator(epochs, ckpt=None, optimizer="sgd", **extra):
            params = {"epochs": epochs, "batch_size": FT_BATCH, "seed": 0, **extra}
            if optimizer == "sgd":
                params["learning_rate"] = FT_LR
            return KerasImageFileEstimator(
                inputCol="uri", outputCol="probs", labelCol="label", imageLoader=load_npy,
                modelFile=path, kerasOptimizer=optimizer,
                kerasLoss="sparse_categorical_crossentropy", kerasFitParams=params,
                checkpointDir=ckpt)

        def weights(fitted):
            return flat_weights(read_keras_file(fitted.getModelFile())[1])

        def rate(label, fit):
            metrics.reset()
            t0 = time.perf_counter()
            fitted = fit()
            wall = time.perf_counter() - t0
            snap = metrics.snapshot()
            log(f"  {label} fit, {FT_FIT_IMAGES} images x 2 epochs, batch {FT_BATCH} ({card}): "
                f"{wall:.3f} s, {2 * FT_FIT_IMAGES / wall:.1f} images/s; sparkdl.load "
                f"{snap.get('sparkdl.load.seconds', 0.0):.3f} s, sparkdl.load_wait "
                f"{snap.get('sparkdl.load_wait.seconds', 0.0):.3f} s, estimator.step "
                f"{snap.get('estimator.step.seconds', 0.0):.3f} s over "
                f"{snap.get('estimator.steps', 0.0):.0f} steps")
            return fitted

        straight, mode = deterministic_pair(
            f"keras: ResNet50 head, 2 epochs of {FT_FIT_IMAGES // FT_BATCH} steps, sgd",
            lambda: estimator(2).fit(df), weights)
        want = weights(straight)
        rate(f"in-memory ({mode} algorithms)", lambda: estimator(2).fit(df))
        streamed = rate(f"streaming ({mode} algorithms)",
                        lambda: estimator(2, streaming=True).fit(df))
        bad = differing(weights(streamed), want)
        log(f"  streaming fit: {len(want) - len(bad)} of {len(want)} arrays bit for bit the "
            f"in-memory fit's")
        if bad:
            raise AssertionError(f"the streaming fit differs: {bad[:4]}")
        if mode == "deterministic":
            # the same two rates under the default algorithms, for what
            # determinism costs a fit
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            rate("in-memory (default algorithms)", lambda: estimator(2).fit(df))
            rate("streaming (default algorithms)", lambda: estimator(2, streaming=True).fit(df))
            torch.use_deterministic_algorithms(True)
            torch.backends.cudnn.deterministic = True

        ckpt = str(tmp / "ckpt")
        metrics.reset()
        estimator(1, ckpt).fit(df)
        resumed = estimator(2, ckpt).fit(df)
        bad = differing(weights(resumed), want)
        log(f"keras: fit(1) then fit(2) resumed from epoch 1 ({mode} algorithms): "
            f"{len(want) - len(bad)} of {len(want)} arrays bit for bit the uninterrupted fit's")
        if bad or resumed._training_loss != straight._training_loss:
            raise AssertionError(f"the resumed Keras fit differs: {bad[:4]}")
        checkpoint_times("ResNet50 head", card)

        # the five optimizers: three updates of the head's trainable
        # weights on the card and on the CPU, the same seeded gradients
        module = KerasModel(config, start_tree)
        gen = torch.Generator().manual_seed(24)
        shapes = [p.shape for p in module.parameters() if p.requires_grad]
        grads = [[torch.randn(s, generator=gen) * 1e-2 for s in shapes] for _ in range(3)]
        before = {i: p.detach().clone() for i, p in
                  enumerate(p for p in module.parameters() if p.requires_grad)}
        for name in OPTAX_NAMES:
            on_card = optax_updates(module, name, "cuda", grads)
            on_cpu = optax_updates(module, name, "cpu", grads)
            diff = max((on_card[i] - on_cpu[i]).abs().max().item() for i in on_cpu)
            change = max((on_cpu[i] - before[i]).abs().max().item() for i in on_cpu)
            log(f"keras: {name}, 3 updates of {sum(p.numel() for p in before.values())} "
                f"weights in {len(before)} tensors, card vs CPU: largest difference "
                f"{diff:.3e}, largest change {change:.3e}")
            if not (change > 0 and diff <= OPT_CHANGE_RTOL * change):
                raise AssertionError(f"{name}: card and CPU part by {diff:.3e} of {change:.3e}")
            fitted = estimator(1, optimizer=name).fit(df)
            tuned = weights(fitted)
            if not np.isfinite(fitted._training_losses).all() or \
                    all(np.array_equal(tuned[k], start[k]) for k in start):
                raise AssertionError(f"{name}: losses {fitted._training_losses}, or no weight moved")
            log(f"  a fit with {name}: losses "
                + ", ".join(f"{v:.4f}" for v in fitted._training_losses))
        del module, grads
        launches = counted[1]()
        if any(launches.values()):
            raise AssertionError(f"the Keras remainder launched attention kernels: {launches}")
        log(f"  attention launches over phase 12 (b): {launches} (none)")
    if mode == "deterministic":
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 13: the ported paths' remainder
# ----------------------------------------------------------------------

# a bf16 fit against the dense bf16 fit, both on the card: the first
# step's gradients, each tensor to BF16_FIT_GRAD_RTOL of its norm (floored
# at 1e-3 of the largest norm). The flash kernels keep scores, P and their
# sums in float32 and round once, the dense path rounds scores and P to
# bf16: the two differ by bf16 roundings (2**-9) carried through 12 blocks
# and back. Elementwise, the gradients are also logged against
# BF16_GRAD_TOL (the kernels' own bound).
BF16_FIT_GRAD_RTOL = 5e-2
P13_VARIANT = "ViT-B/16"
P13_IMAGE = 224
P13_DEVICE = "cuda"
P13_DEPTH_ROUNDS = 2     # (e): images/s rounds, each taking every mode
DISPATCH_MODES = (("SPARKDL_DISPATCH_DEPTH", "0"), ("SPARKDL_DISPATCH_DEPTH", "1"),
                  ("SPARKDL_DISPATCH_DEPTH", "2"), ("SPARKDL_DISPATCH_DEPTH", "3"),
                  ("SPARKDL_SERIAL_INFERENCE", "1"))


class scoped_env:
    """Set environment variables for a ``with`` block and put back what
    was there (or take them out) after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def grads_of(state_dict, attn_impl, dtype, x, y, device):
    """The first step's loss and gradients (the estimator's per-sample CE,
    mean over the batch) of a ViT computing in ``dtype``."""
    from sparkdl_tpu_torch.estimators import TorchImageFileEstimator
    from sparkdl_tpu_torch.models.vit import ViT

    model = ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl=attn_impl,
                dtype=dtype, image_size=P13_IMAGE)
    model.load_state_dict(state_dict, strict=True)
    model.to(device).train()
    per = TorchImageFileEstimator(device=device)._per_sample_loss()(model, {"x": x, "y": y})
    loss = per.mean()
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in model.named_parameters()}


def grad_errors(got, want):
    """The worst per-tensor relative norm error (floored at 1e-3 of the
    largest norm) and the share of elements outside BF16_GRAD_TOL."""
    import torch

    norms = {n: g.norm().item() for n, g in want.items()}
    floor = 1e-3 * max(norms.values())
    worst = max(((got[n] - g).norm().item() / max(norms[n], floor), n) for n, g in want.items())
    outside = sum(int((~torch.isclose(got[n], g, **BF16_GRAD_TOL)).sum()) for n, g in want.items())
    total = sum(g.numel() for g in want.values())
    return worst, outside / total


def bf16_fit(card: str, counted, train_params, uris, f32_step_ms: float):
    """Phase 13 (a): ViT-B/16 fine-tuning in bfloat16 through kernels #2-#4.
    Returns the fitted transformer, its launches and the fit's."""
    import torch

    from sparkdl_tpu_torch.estimators.losses import get_optimizer
    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step

    reset, read = counted
    dev = torch.device(P13_DEVICE)
    bf16 = torch.bfloat16
    state = vit_state_dict_from_flax(train_params)
    n = len(uris)
    labels = np.arange(n) % N_CLASSES
    images = np.stack([load_npy(u) for u in uris])
    first = np.random.RandomState(0).permutation(n)[:BATCH]
    xb = torch.from_numpy(images[first]).to(dev)
    yb = torch.from_numpy(labels[first]).to(dev)

    # the first step's gradients, flash against dense, both bf16
    flash_loss, flash_grads = grads_of(state, "flash", bf16, xb, yb, dev)
    full_loss, full_grads = grads_of(state, "full", bf16, xb, yb, dev)
    (rel, rel_name), outside = grad_errors(flash_grads, full_grads)
    log(f"bf16 training: first-step gradients flash vs full, both bf16 on the card: worst "
        f"relative norm error {rel:.3e} ({rel_name}); {100 * outside:.4f}% of the elements "
        f"outside BF16_GRAD_TOL {BF16_GRAD_TOL}; loss {flash_loss:.6f} vs {full_loss:.6f}")
    if not rel <= BF16_FIT_GRAD_RTOL:
        raise AssertionError(f"bf16 first-step gradients differ by {rel:.3e} ({rel_name})")
    np.testing.assert_allclose(flash_loss, full_loss, **BF16_TOL)
    dtypes = {g.dtype for g in flash_grads.values()}
    del flash_grads, full_grads

    # the fit, counted: 12 blocks x 2 epochs x 2 steps of #2, #3, #4
    df = training_df(uris)
    steps = 2 * (n // BATCH)
    module = ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl="flash", dtype=bf16,
                 image_size=P13_IMAGE)
    estimator = train_estimator(module, train_params, device=P13_DEVICE)
    reset()
    t0 = time.perf_counter()
    fitted = estimator.fit(df)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read()
    expected = 12 * steps
    log(f"  bf16 fit of {steps} steps: launches {fit_counts} (expected {expected} with lse, "
        f"dQ and dK/dV, 0 lse-free), {fit_s:.2f} s")
    if list(fit_counts.values()) != [0, expected, expected, expected]:
        raise AssertionError(f"bf16 training launches {fit_counts}")
    master = {p.dtype for p in fitted.module.parameters()}
    if master != {torch.float32} or dtypes != {torch.float32}:
        raise AssertionError(f"bf16 fit holds {master} weights, {dtypes} gradients")
    losses = np.array(fitted._training_losses)
    full_fit = train_estimator(
        ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl="full", dtype=bf16,
            image_size=P13_IMAGE), train_params, device=P13_DEVICE).fit(df)
    full_losses = np.array(full_fit._training_losses)
    log(f"  losses bf16 flash {losses.tolist()} vs bf16 full {full_losses.tolist()}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"bad bf16 training losses {losses}")
    np.testing.assert_allclose(losses, full_losses, **BF16_TOL)
    del full_fit

    # 2 images, card against CPU, both bf16: the first step's gradients,
    # then one step of a fit (adam moves each weight by about lr on the sign
    # of its gradient, which bf16 roundings decide where it is near zero, so
    # the fits compare by loss and by the stepped model's rows)
    x2, y2 = xb[:2], yb[:2]
    card_loss, card_grads = grads_of(state, "flash", bf16, x2, y2, dev)
    cpu_loss, cpu_grads = grads_of(state, "flash", bf16, x2.cpu(), y2.cpu(), torch.device("cpu"))
    (rel2, rel2_name), outside2 = grad_errors({n: g.cpu() for n, g in card_grads.items()},
                                              cpu_grads)
    log(f"  first-step gradients at 2 images, bf16 flash, card vs CPU: worst relative norm "
        f"error {rel2:.3e} ({rel2_name}); {100 * outside2:.4f}% of the elements outside "
        f"BF16_GRAD_TOL; loss {card_loss:.6f} vs {cpu_loss:.6f}")
    if not rel2 <= BF16_FIT_GRAD_RTOL:
        raise AssertionError(f"bf16 gradients card vs CPU differ by {rel2:.3e} ({rel2_name})")
    del card_grads, cpu_grads
    small_df = training_df(uris[:2])
    small = {"fitParams": {"epochs": 1, "batch_size": 2, "learning_rate": TRAIN_LR, "seed": 0}}
    fits = {}
    for where in (P13_DEVICE, "cpu"):
        fits[where] = train_estimator(
            ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl="flash", dtype=bf16,
                image_size=P13_IMAGE), train_params, device=where, **small).fit(small_df)
    card_fit, cpu_fit = fits[P13_DEVICE], fits["cpu"]
    np.testing.assert_allclose(card_fit._training_losses, cpu_fit._training_losses, **BF16_TOL)
    card_rows = rows_array(card_fit.transform(small_df).collect())
    cpu_rows = rows_array(cpu_fit.transform(small_df).collect())
    log(f"  one bf16 step at 2 images, card vs CPU: loss {card_fit._training_losses} vs "
        f"{cpu_fit._training_losses}; the stepped models' rows "
        f"max_abs_err={np.abs(card_rows - cpu_rows).max():.3e}")
    np.testing.assert_allclose(card_rows, cpu_rows, **BF16_SLICE_TOL)
    del fits, card_fit, cpu_fit

    # the step alone on one resident batch: bf16 flash, bf16 dense
    import gc

    step_ms = {}
    gc.collect()
    tracked = len(gc.get_objects())
    for impl in ("flash", "full"):
        model = ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl=impl, dtype=bf16,
                    image_size=P13_IMAGE)
        model.load_state_dict(state, strict=True)
        model.to(dev).train()
        train = init_train_state(model, get_optimizer("adam", TRAIN_LR))
        step = make_train_step(ce_per_sample)
        batch = {"x": xb, "y": yb, "w": torch.ones(BATCH, device=dev)}
        step_ms[impl] = time_ms(lambda: step(train, batch), iters=5, warmup=2)
        if impl == "flash" and dev.type == "cuda":
            # device busy and idle share of the bf16 step: is it the host's?
            # and the same step with Python's cyclic collector off
            profile_forward(lambda: step(train, batch), step_ms[impl])
            gc.disable()
            try:
                no_gc_ms = time_ms(lambda: step(train, batch), iters=5, warmup=2)
            finally:
                gc.enable()
            log(f"  bf16 flash step with the cyclic collector off: {no_gc_ms:.3f} ms "
                f"({tracked} objects tracked by the collector)")
        del model, train
    log(f"ViT-B/16 training step at batch {BATCH}, adam ({card}): bf16 flash "
        f"{step_ms['flash']:.3f} ms, bf16 full {step_ms['full']:.3f} ms, float32 flash "
        f"{f32_step_ms:.3f} ms (phase 5); bf16 flash / float32 flash "
        f"{step_ms['flash'] / f32_step_ms:.3f}")
    return fitted, fit_counts


def vit_persistence(card: str, counted, fitted, uris) -> int:
    """Phase 13 (b) and (c): the fitted bf16 transformer saved and loaded,
    alone and in a PipelineModel, and its weights through the ViT
    checkpoint import; each gives the in-memory rows bit for bit. Returns
    the loaded transformer's forward launches."""
    import torch

    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.ml.pipeline import PipelineModel
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.models.vit_port import export_vit_npz, port_vit_npz

    reset, read = counted
    df = training_df(uris)
    want = rows_array(fitted.transform(df).collect())
    expected = 12 * -(-len(uris) // fitted.batchSize)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-persist-") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fitted.write().overwrite().save(str(tmp / "vit"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = TorchImageFileTransformer.load(str(tmp / "vit"))
        load_s = time.perf_counter() - t0
        reset()
        got = rows_array(loaded.transform(df).collect())
        launches = read()
        size_mb = (tmp / "vit" / "torch_model.pt").stat().st_size / 1e6
        log(f"persistence: fitted bf16 ViT-B/16 transformer saved ({size_mb:.1f} MB) in "
            f"{save_s:.2f} s, loaded in {load_s:.2f} s; loaded transform launches {launches} "
            f"(expected {expected} lse-free)")
        if list(launches.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"loaded transformer launches {launches}")
        if loaded.device != fitted.device or not np.array_equal(got, want):
            raise AssertionError("the loaded transformer's rows differ")
        PipelineModel([fitted]).write().overwrite().save(str(tmp / "pm"))
        model = PipelineModel.load(str(tmp / "pm"))
        if not np.array_equal(rows_array(model.transform(df).collect()), want):
            raise AssertionError("the loaded PipelineModel's rows differ")
        log("  loaded transformer and PipelineModel: rows bit for bit equal to the "
            f"in-memory transformer's ({want.shape[0]} rows)")

        # the ViT checkpoint import: .npz out and back in
        state = {k: v.detach().cpu() for k, v in fitted.module.state_dict().items()}
        t0 = time.perf_counter()
        export_vit_npz(state, str(tmp / "vit.npz"))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ported = port_vit_npz(str(tmp / "vit.npz"))
        import_s = time.perf_counter() - t0
        bad = differing(ported, state)
        if bad:
            raise AssertionError(f"the .npz round trip changed {bad[:4]}")
        stage = TorchImageFileTransformer(
            inputCol="uri", outputCol="features", imageLoader=load_npy,
            module=ViT(variant=P13_VARIANT, num_classes=N_CLASSES, attn_impl="flash",
                       dtype=fitted.module.dtype, image_size=P13_IMAGE),
            state_dict=ported, device=P13_DEVICE)
        reset()
        if not np.array_equal(rows_array(stage.transform(df).collect()), want):
            raise AssertionError("the .npz-imported weights give other rows")
        launches_npz = read()
        log(f"  ViT checkpoint import: export_vit_npz {export_s:.2f} s, port_vit_npz "
            f"{import_s:.2f} s, {len(state)} tensors bit for bit; its transformer's rows bit "
            f"for bit ({launches_npz['flash_attention_fwd']} lse-free launches)")
    return launches["flash_attention_fwd"] + launches_npz["flash_attention_fwd"]


def imagenet_from_cache(card: str, counted):
    """Phase 13 (d): ``modelWeights="imagenet"`` read from Keras's cache
    file (written by the port, without Keras, under a temporary HOME),
    against the registry module on the same weights, bit for bit. Returns
    what (e) reuses: the Keras config and weights."""
    import gzip

    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.models.keras_model import write_legacy_weights
    from sparkdl_tpu_torch.models.keras_port import keras_layers_view, port_keras_weights
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.named_image import IMAGENET_FILES

    reset, read = counted
    config = json.loads(gzip.decompress(KERAS_CONFIG.read_bytes()))
    weights = keras_inception_weights(config, seed=11)
    state = get_keras_application_model("InceptionV3").state_dict_from_flax(
        port_keras_weights(keras_layers_view(config, weights)))
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    df = session.createDataFrame(cnn_image_rows(CNN_IMAGES, seed=0), numPartitions=4)
    args = dict(inputCol="image", outputCol="features", modelName="InceptionV3",
                computeDtype="float32", batchSize=CNN_BATCH, device=P13_DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-home-") as home:
        cache = Path(home) / ".keras" / "models"
        cache.mkdir(parents=True)
        path = cache / IMAGENET_FILES["InceptionV3"]
        t0 = time.perf_counter()
        write_legacy_weights(str(path), config, weights)
        write_s = time.perf_counter() - t0
        size_mb = path.stat().st_size / 1e6
        with scoped_env(HOME=home):
            reset()
            t0 = time.perf_counter()
            got = rows_array(DeepImageFeaturizer(modelWeights="imagenet", **args)
                             .transform(df).collect())
            first_s = time.perf_counter() - t0
            launches = read()
    want = rows_array(DeepImageFeaturizer(modelWeights=state, **args).transform(df).collect())
    log(f"imagenet from Keras's cache: {path.name} ({size_mb:.1f} MB) written by the "
        f"port in {write_s:.2f} s; DeepImageFeaturizer(InceptionV3, "
        f"\"imagenet\") read, ported and ran {len(got)} rows in {first_s:.2f} s; attention "
        f"launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the imagenet featurizer launched attention kernels: {launches}")
    if got.shape != (CNN_IMAGES, 2048) or not np.array_equal(got, want):
        raise AssertionError("imagenet features differ from the registry module's")
    log("  features bit for bit equal to the registry module's on the same weights")
    return config, weights


def dispatch_depths(card: str, counted, config, weights, vit_stage, vit_uris) -> int:
    """Phase 13 (e): ``DeepImageFeaturizer``, ``KerasImageFileTransformer``
    and the ViT transformer at ``SPARKDL_DISPATCH_DEPTH`` 0-3 and under
    ``SPARKDL_SERIAL_INFERENCE=1``, each over a frame of 4 partitions (a
    call of one chunk: 128 / 4 / 32, 64 / 2 / 32) and of 1 partition (a call
    of 4, 4 and 2 chunks for the prefetch and the window to overlap): the
    same bytes in every mode, and images/s over ``P13_DEPTH_ROUNDS``
    rounds that take the modes in turn, with the loop's timers. Returns the
    ViT transformer's launches."""
    from sparkdl_tpu_torch import DeepImageFeaturizer, KerasImageFileTransformer
    from sparkdl_tpu_torch.models.keras_model import write_keras_file
    from sparkdl_tpu_torch.models.keras_port import keras_layers_view, port_keras_weights
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.utils.metrics import metrics

    reset, read = counted
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    state = get_keras_application_model("InceptionV3").state_dict_from_flax(
        port_keras_weights(keras_layers_view(config, weights)))
    timers = ("sparkdl.load.seconds", "sparkdl.decode.seconds", "sparkdl.forward.seconds",
              "sparkdl.serve.seconds", "data.device_stall_ms.sum",
              "data.device_stall_ms.count")
    vit_launches = 0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-depth-") as tmp:
        tmp = Path(tmp)
        path = str(tmp / "inception_v3.keras")
        write_keras_file(path, config, weights)
        pixels = np.random.RandomState(13).randint(0, 256, (CNN_IMAGES, 299, 299, 3))
        uris = []
        for i, img in enumerate(pixels.astype(np.float32)):
            uris.append(str(tmp / f"img_{i:03d}.npy"))
            np.save(uris[-1], img)
        featurizer = DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="InceptionV3",
            modelWeights=state, computeDtype="bfloat16", batchSize=CNN_BATCH,
            device=P13_DEVICE)
        keras_stage = KerasImageFileTransformer(
            inputCol="uri", outputCol="features", modelFile=path, imageLoader=load_npy_tf,
            computeDtype="bfloat16", batchSize=CNN_BATCH, device=P13_DEVICE)
        image_rows = cnn_image_rows(CNN_IMAGES, seed=0)
        vit_rows = [{"uri": u, "label": i % N_CLASSES} for i, u in enumerate(vit_uris)]
        cases = {}
        for parts in (4, 1):
            vit_parts = min(parts, len(vit_uris) // BATCH)
            cases[f"DeepImageFeaturizer, {parts} partition(s)"] = (
                featurizer, session.createDataFrame(image_rows, numPartitions=parts))
            cases[f"KerasImageFileTransformer, {parts} partition(s)"] = (
                keras_stage, session.createDataFrame([{"uri": u} for u in uris],
                                                     numPartitions=parts))
            cases[f"ViT-B/16 bf16 transformer, {vit_parts} partition(s)"] = (
                vit_stage, session.createDataFrame(vit_rows, numPartitions=vit_parts))
        modes = [("serial" if env == "SPARKDL_SERIAL_INFERENCE" else f"depth {value}",
                  {env: value}) for env, value in DISPATCH_MODES]

        # the bytes, in every mode; the first transforms warm each path
        first = {}
        for mode, env in modes:
            with scoped_env(**env):
                for label, (stage, df) in cases.items():
                    reset()
                    rows = vectors(stage.transform(df).collect(), "features")
                    vit_launches += read()["flash_attention_fwd"]
                    if label not in first:
                        first[label] = rows
                    elif not np.array_equal(rows, first[label]):
                        raise AssertionError(f"{label} at {mode}: other bytes")
        log(f"dispatch depth: the same bytes at depths 0-3 and serial for each of "
            f"{len(cases)} frames")

        # rounds, each taking every mode in turn
        walls = {(mode, label): [] for mode, _ in modes for label in cases}
        sums = {key: dict.fromkeys(timers, 0.0) for key in walls}
        for _ in range(P13_DEPTH_ROUNDS):
            for mode, env in modes:
                with scoped_env(**env):
                    for label, (stage, df) in cases.items():
                        before = metrics.snapshot()
                        reset()
                        t0 = time.perf_counter()
                        stage.transform(df).collect()
                        walls[mode, label].append(time.perf_counter() - t0)
                        vit_launches += read()["flash_attention_fwd"]
                        after = metrics.snapshot()
                        for key in timers:
                            sums[mode, label][key] += after.get(key, 0.0) - before.get(key, 0.0)
        for label, (_, df) in cases.items():
            n = df.count()
            for mode, _ in modes:
                w, t = walls[mode, label], sums[mode, label]
                log(f"dispatch {mode}: {label}, images/s ({n} images, {card}): "
                    + ", ".join(f"{n / x:.1f}" for x in w)
                    + f"; median {n / float(np.median(w)):.1f}; over the {len(w)}: sparkdl.load "
                    f"{t['sparkdl.load.seconds']:.4f} s, sparkdl.decode "
                    f"{t['sparkdl.decode.seconds']:.4f} s, sparkdl.forward "
                    f"{t['sparkdl.forward.seconds']:.4f} s, sparkdl.serve "
                    f"{t['sparkdl.serve.seconds']:.4f} s, data.device_stall_ms "
                    f"{t['data.device_stall_ms.sum']:.1f} over "
                    f"{int(t['data.device_stall_ms.count'])} waits")
    return vit_launches


P19_ROUNDS = 2           # images/s rounds, each taking every mode and both packs
P19_DECODE_CALLS = 50    # decode_image_batch calls timed per chunk and pack


def pack_rows_for_bytes():
    """Phase 19 (b)'s rows: ``(label, rows, decode_image_batch kwargs)`` for
    uniform uint8 (the uint8 pack, in stored order and flipped), uniform
    float32 and one-channel uint8 at source size, and mixed sizes through
    the device resize."""
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct

    rng = np.random.RandomState(19)
    u8 = [imageArrayToStruct(rng.randint(0, 256, (299, 299, 3)).astype(np.uint8))
          for _ in range(CNN_BATCH)]
    f32 = [imageArrayToStruct((rng.rand(299, 299, 3) * 255).astype(np.float32))
           for _ in range(8)]
    gray = [imageArrayToStruct(rng.randint(0, 256, (299, 299)).astype(np.uint8))
            for _ in range(8)]
    mixed = [r["image"] for r in cnn_image_rows(CNN_IMAGES, seed=0)[-CNN_BATCH:]]
    size = (299, 299)
    return [
        ("uniform uint8 299x299, uint8 pack", u8, dict(prefer_uint8=True)),
        ("uniform uint8 299x299, uint8 pack, BGR->RGB", u8,
         dict(prefer_uint8=True, to_rgb=True)),
        ("uniform uint8 299x299, float32 pack", u8, {}),
        ("uniform float32 299x299", f32, {}),
        ("one-channel uint8 299x299, uint8 pack", gray,
         dict(prefer_uint8=True, n_channels=1)),
        ("uniform uint8 299x299 to one channel (luminance)", u8, dict(n_channels=1)),
        ("mixed 96x96 and 240x320, device resize to 299x299", mixed,
         dict(target_hw=size, always_resize=True)),
    ]


def batch_packer(card: str, counted, config, weights) -> None:
    """Phase 19: the C++ batch packer (``sparkdl_tpu_torch/native``) behind
    the featurizer's decode.

    (a) the packer builds from the checkout's ``native/batchpack.cpp`` and
        loads; the phase fails without it (no numpy stand-in on the card);
    (b) on phase 19's rows the packer's batch equals the numpy pack's
        (``SPARKDL_NO_NATIVE=1``) bit for bit: dtype, shape and bytes;
    (c) the ``sparkdl.decode`` timer per image, ``decode_image_batch`` alone
        on chunks of 32, with the packer and without it;
    (d) ``DeepImageFeaturizer(InceptionV3)`` in bf16 over phase 13 (e)'s
        frames (4 partitions and 1) at ``SPARKDL_DISPATCH_DEPTH`` 0-3 and
        serial, with the packer and without it: the same feature bytes, the
        packer called, no attention kernel launched, and images/s over
        ``P19_ROUNDS`` rounds that take the modes and the packs in turn."""
    from sparkdl_tpu_torch import DeepImageFeaturizer, native
    from sparkdl_tpu_torch.models.keras_port import keras_layers_view, port_keras_weights
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.utils import decode_image_batch
    from sparkdl_tpu_torch.utils.metrics import metrics

    reset, read = counted
    # (a)
    t0 = time.perf_counter()
    if not native.is_available():
        raise AssertionError("the native batch packer did not build or load on this machine")
    import os

    log(f"batch packer: {Path(native._library_path()).name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (CXX={native.compiler()!r}); CPUs: "
        f"{len(os.sched_getaffinity(0))} to this process of os.cpu_count() {os.cpu_count()}")
    packs = (("the packer", {}), ("numpy", {"SPARKDL_NO_NATIVE": "1"}))

    # (b)
    byte_cases = pack_rows_for_bytes()
    for label, rows, kw in byte_cases:
        got = decode_image_batch(rows, device=P13_DEVICE, **kw)
        with scoped_env(SPARKDL_NO_NATIVE="1"):
            want = decode_image_batch(rows, device=P13_DEVICE, **kw)
        if (got.dtype, got.shape) != (want.dtype, want.shape) or \
                got.tobytes() != want.tobytes():
            raise AssertionError(f"batch packer: {label}: other bytes than the numpy pack")
        log(f"batch packer: {label}: {got.dtype} {got.shape}, bit for bit the numpy pack's")

    # (c)
    chunks = [("phase 13 (e)'s uniform 96x96 uint8", dict(prefer_uint8=True),
               [r["image"] for r in cnn_image_rows(CNN_IMAGES, seed=0)[:CNN_BATCH]]),
              ("299x299 uint8", dict(prefer_uint8=True), byte_cases[0][1]),
              ("299x299 float32 pack of uint8 rows", {}, byte_cases[0][1])]
    for label, kw, rows in chunks:
        per_image = {}
        for pack, env in packs:
            with scoped_env(**env):
                decode_image_batch(rows, device=P13_DEVICE, **kw)
                before = metrics.snapshot().get("sparkdl.decode.seconds", 0.0)
                for _ in range(P19_DECODE_CALLS):
                    decode_image_batch(rows, device=P13_DEVICE, **kw)
                after = metrics.snapshot().get("sparkdl.decode.seconds", 0.0)
            per_image[pack] = (after - before) * 1e3 / (P19_DECODE_CALLS * len(rows))
        # the pack call alone: on the calling thread (the default at source
        # size), on a resize's threads for its output's size, and on the
        # library's own rule (one a row up to hardware_concurrency, the JAX
        # package's)
        u8 = bool(kw.get("prefer_uint8"))
        pack = native.pack_image_rows_u8 if u8 else native.pack_image_rows
        hw = (int(rows[0]["height"]), int(rows[0]["width"]))
        sized = native.threads_for(len(rows), len(rows) * hw[0] * hw[1] * 3 * (1 if u8 else 4))
        call_ms = {}
        for n_threads in (None, sized, 0):
            pack(rows, hw, 3, n_threads=n_threads)
            t0 = time.perf_counter()
            for _ in range(P19_DECODE_CALLS):
                pack(rows, hw, 3, n_threads=n_threads)
            call_ms[n_threads] = (time.perf_counter() - t0) * 1e3 / P19_DECODE_CALLS
        log(f"batch packer: sparkdl.decode per image, {label}, chunks of {len(rows)} "
            f"({card}): {per_image['the packer']:.5f} ms with the packer, "
            f"{per_image['numpy']:.5f} ms with numpy "
            f"({per_image['numpy'] / per_image['the packer']:.2f}x); the pack call "
            f"{call_ms[None]:.4f} ms on the calling thread, {call_ms[sized]:.4f} ms on "
            f"{sized} (a resize's count for this output), {call_ms[0]:.4f} ms on one a "
            f"row up to hardware_concurrency")

    # (d)
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    state = get_keras_application_model("InceptionV3").state_dict_from_flax(
        port_keras_weights(keras_layers_view(config, weights)))
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        modelWeights=state, computeDtype="bfloat16", batchSize=CNN_BATCH,
        device=P13_DEVICE)
    image_rows = cnn_image_rows(CNN_IMAGES, seed=0)
    frames = {f"{parts} partition(s)": session.createDataFrame(image_rows, numPartitions=parts)
              for parts in (4, 1)}
    modes = [("serial" if env == "SPARKDL_SERIAL_INFERENCE" else f"depth {value}",
              {env: value}) for env, value in DISPATCH_MODES]
    calls = []
    packers = {name: getattr(native, name) for name in ("pack_image_rows", "pack_image_rows_u8")}
    first = {}
    try:
        for name, fn in packers.items():
            setattr(native, name,
                    lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
        for mode, env in modes:
            for pack, pack_env in packs:
                with scoped_env(**env, **pack_env):
                    for label, df in frames.items():
                        reset()
                        rows = vectors(featurizer.transform(df).collect(), "features")
                        launches = read()
                        if any(launches.values()):
                            raise AssertionError(f"the featurizer launched attention "
                                                 f"kernels: {launches}")
                        if label not in first:
                            first[label] = rows
                        elif not np.array_equal(rows, first[label]):
                            raise AssertionError(f"batch packer: {label} at {mode} with "
                                                 f"{pack}: other feature bytes")
    finally:
        for name, fn in packers.items():
            setattr(native, name, fn)
    if not {"pack_image_rows", "pack_image_rows_u8"} <= set(calls):
        raise AssertionError(f"the featurizer did not reach both packs: {sorted(set(calls))}")
    log(f"batch packer: DeepImageFeaturizer(InceptionV3, bf16) gives the same features "
        f"at depths 0-3 and serial with the packer and with numpy, for {len(frames)} "
        f"frames; packer calls {len(calls)} ({calls.count('pack_image_rows_u8')} uint8)")

    walls = {(mode, pack, label): [] for mode, _ in modes for pack, _ in packs
             for label in frames}
    decode_s = dict.fromkeys(walls, 0.0)
    for _ in range(P19_ROUNDS):
        for mode, env in modes:
            for pack, pack_env in packs:
                with scoped_env(**env, **pack_env):
                    for label, df in frames.items():
                        before = metrics.snapshot().get("sparkdl.decode.seconds", 0.0)
                        t0 = time.perf_counter()
                        featurizer.transform(df).collect()
                        walls[mode, pack, label].append(time.perf_counter() - t0)
                        decode_s[mode, pack, label] += (
                            metrics.snapshot().get("sparkdl.decode.seconds", 0.0) - before)
    for label, df in frames.items():
        n = df.count()
        for mode, _ in modes:
            parts = []
            for pack, _ in packs:
                w = walls[mode, pack, label]
                parts.append(
                    f"{pack} " + ", ".join(f"{n / x:.1f}" for x in w)
                    + f" (median {n / float(np.median(w)):.1f}; sparkdl.decode "
                    f"{decode_s[mode, pack, label] * 1e3 / (n * len(w)):.5f} ms/image)")
            log(f"batch packer: {mode}: DeepImageFeaturizer, {label}, images/s "
                f"({n} images, {card}): " + "; ".join(parts))


P20_BATCH = 32            # the exported program's static batch
P20_SOURCE = (299, 299)   # its source size: InceptionV3's input, so no resize inside
P20_EXPORT_TIMEOUT_S = 900.0
# phase 20 (a) and (b) in a child process: the runner library and the tool
# built, then phase 7's InceptionV3 weights exported; its last line is the
# seconds of each, as JSON after the marker
P20_EXPORT = """
import json, os, sys, time
os.nice(19)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from sparkdl_tpu_torch.native import aoti, featurizer
t0 = time.perf_counter()
aoti._load()
runner_s = time.perf_counter() - t0
t0 = time.perf_counter()
featurizer.build_tool()
tool_s = time.perf_counter() - t0
t0 = time.perf_counter()
featurizer.export_featurizer(
    "InceptionV3", batch_size=chip_smoke.P20_BATCH, out_dir=sys.argv[2],
    source_hw=chip_smoke.P20_SOURCE,
    model_weights=chip_smoke.flax_layout_inception_params(seed=3), compute_dtype="bfloat16")
print("P20_EXPORT " + json.dumps({"runner_s": runner_s, "tool_s": tool_s,
                                  "export_s": time.perf_counter() - t0,
                                  "ended": time.time()}), flush=True)
"""


class NativeExport:
    """Phase 20's builds and export (``P20_EXPORT``) in a child process at
    the lowest CPU priority (nice 19), started after phase 6 so that its
    minutes of compiling run beside phases 7-12, and not after them.
    :meth:`wait`, before phase 13, joins it, so that no reading of phases
    13-19 (host-bound rates, compile seconds, card memory) is taken beside
    it. :meth:`close` stops it if it still runs and removes its files."""

    def __init__(self):
        import os

        self.dir = tempfile.mkdtemp(prefix="chip-smoke-native-")
        self.program = os.path.join(self.dir, "inception_v3")
        self.started = time.perf_counter() - _STARTED
        self.result = None
        self.child = NicedChild(P20_EXPORT, "P20_EXPORT", os.path.join(self.dir, "export.log"),
                                args=(str(Path(__file__).resolve().parent), self.program))

    def wait(self) -> dict:
        """The child's seconds (``runner_s``, ``tool_s``, ``export_s``) once
        it has ended, with when it ran on the script's clock; raises with its
        output's end if it failed."""
        if self.result is None:
            t0 = time.perf_counter()
            self.result = self.child.wait(P20_EXPORT_TIMEOUT_S, "phase 20's build and export")
            waited = time.perf_counter() - t0
            log(f"native: the build and export ran in a child process from "
                f"{self.started:.1f} s to {self.result['ended'] - _STARTED_EPOCH:.1f} s of the "
                f"script; phase 13 waited {waited:.2f} s for it")
        return self.result

    def close(self) -> None:
        import shutil

        self.child.stop()
        shutil.rmtree(self.dir, ignore_errors=True)


def cnn_rows_at(n: int, hw, seed: int):
    """``n`` image-struct rows at ``hw``, red- or blue-dominant as
    :func:`cnn_image_rows` makes them."""
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        bgr = rng.randint(0, 80, (*hw, 3)).astype(np.uint8)
        bgr[..., 0 if i % 2 else 2] += 120
        rows.append({"image": imageArrayToStruct(bgr, origin=f"frame_{i}"), "label": i % 2})
    return rows


def native_stack(card: str, counted, export: NativeExport) -> dict:
    """Phase 20: the native second stack, InceptionV3 bf16 through the C++
    AOTInductor runner and ``aoti_tool`` on phase 7's weights.

    (a) the runner library and ``aoti_tool`` build from the checkout's
        sources (the phase fails without them: nothing stands in), in
        ``export``'s child process, and load here;
    (b) ``export_featurizer`` at batch 32 from 299x299 sources in bf16 on
        the card, in that process beside phases 7-12: compile seconds,
        the package's and ``params.bin``'s MiB;
    (c) ``NativeDeepImageFeaturizer`` against the Python bf16
        ``DeepImageFeaturizer``: 128 rows at 299x299 (4 partitions) within
        ``CNN_BF16_MAX_REL`` of the largest float32 Python feature; phase
        7's frame (96x96 and 240x320, resized on the card and rounded to
        uint8) against the Python stage over the same rounded rows, at the
        same bound; rows in input order;
    (d) ``aoti_tool`` in a fresh process over (c)'s batches at 299x299:
        against (c)'s rows at the same bound, bit for bit or not, its load
        seconds beside the in-process runner's and ``aoti_load_package``'s;
    (e) ``stream()`` bit for bit a loop of ``__call__``;
    (f) images/s of both stages on both frames (5 rounds each, medians);
    (g) no attention kernel launched in the phase."""
    import os

    import torch

    from sparkdl_tpu_torch import DeepImageFeaturizer, NativeDeepImageFeaturizer
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch import native
    from sparkdl_tpu_torch.native import aoti, featurizer
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.transformers.native_image import uint8_batch

    reset, read = counted
    reset()
    t_phase = time.perf_counter()
    # (a), (b)
    built = export.wait()
    t0 = time.perf_counter()
    aoti._load()
    tool = featurizer.build_tool()
    log(f"native: runner library {Path(aoti.library_path()).name} built in "
        f"{built['runner_s']:.2f} s, aoti_tool in {built['tool_s']:.2f} s "
        f"(CXX={native.compiler()!r}), in the export's process; both loaded here in "
        f"{time.perf_counter() - t0:.2f} s")
    prog_dir = export.program
    log(f"native: export_featurizer(InceptionV3, batch {P20_BATCH}, "
        f"{P20_SOURCE[0]}x{P20_SOURCE[1]}, bf16) {built['export_s']:.2f} s in a child process "
        f"at nice 19 beside phases 7-12; "
        f"program.pt2 {os.path.getsize(os.path.join(prog_dir, 'program.pt2')) / 2**20:.3f} "
        f"MiB, params.bin {os.path.getsize(os.path.join(prog_dir, 'params.bin')) / 2**20:.3f} MiB")

    tree = flax_layout_inception_params(seed=3)  # phase 7's weights
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    tmp = export.dir
    # (c)
    featurize = dict(inputCol="image", outputCol="features", modelName="InceptionV3")
    native = NativeDeepImageFeaturizer(**featurize, programDir=prog_dir)
    python = DeepImageFeaturizer(**featurize, modelWeights=tree, batchSize=CNN_BATCH,
                                 computeDtype="bfloat16")
    python_f32 = DeepImageFeaturizer(**featurize, modelWeights=tree, batchSize=CNN_BATCH,
                                     computeDtype="float32")
    at_size = cnn_rows_at(CNN_IMAGES, P20_SOURCE, seed=20)
    phase7 = cnn_image_rows(CNN_IMAGES, seed=0)
    device = torch.device("cuda")
    rounded = uint8_batch([r["image"] for r in phase7], P20_SOURCE, device).cpu().numpy()
    rounded_rows = [{"image": imageArrayToStruct(img, origin=r["image"]["origin"]),
                     "label": r["label"]} for img, r in zip(rounded, phase7)]
    frames = {
        "299x299": (session.createDataFrame(at_size, numPartitions=4),) * 2,
        "phase 7's, resized": (session.createDataFrame(phase7, numPartitions=4),
                               session.createDataFrame(rounded_rows, numPartitions=4)),
    }
    native_rows = {}
    for label, (df, python_df) in frames.items():
        got = native.transform(df).collect()
        want = python.transform(python_df).collect()
        scale = np.abs(vectors(python_f32.transform(python_df).collect(), "features")).max()
        order = [r["image"]["origin"] for r in df.collect()]
        if [r["image"]["origin"] for r in got] != order or len(got) != CNN_IMAGES:
            raise AssertionError(f"native: {label}: rows out of order or missing")
        g, w = vectors(got, "features"), vectors(want, "features")
        err = np.abs(g - w).max()
        log(f"native: NativeDeepImageFeaturizer vs DeepImageFeaturizer (bf16), {label} "
            f"frame, {len(got)} rows in order: max abs err {err:.4e} = {err / scale:.4e} "
            f"of the largest float32 feature {scale:.4f} (bound {CNN_BF16_MAX_REL})")
        if g.shape != (CNN_IMAGES, 2048) or not np.isfinite(g).all():
            raise AssertionError(f"native: {label}: bad features {g.shape}")
        if not err <= CNN_BF16_MAX_REL * scale:
            raise AssertionError(f"native: {label}: {err:.4e} from the Python stage")
        native_rows[label] = g

    # (d) the tool over (c)'s 299x299 batches: one partition is one batch
    batches = np.stack([uint8_batch([r["image"] for r in at_size[i:i + P20_BATCH]],
                                    P20_SOURCE, device).cpu().numpy()
                        for i in range(0, CNN_IMAGES, P20_BATCH)])
    in_path, out_path = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.bin")
    batches.tofile(in_path)
    t0 = time.perf_counter()
    proc = subprocess.run([tool, prog_dir, in_path, out_path], capture_output=True,
                          text=True, timeout=600)
    tool_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"aoti_tool failed ({proc.returncode}): {proc.stderr[-3000:]}")
    stats = dict(kv.split("=", 1) for kv in proc.stderr.split() if "=" in kv)
    cli = np.fromfile(out_path, np.float32).reshape(CNN_IMAGES, -1)
    err = np.abs(cli - native_rows["299x299"]).max()
    scale = np.abs(native_rows["299x299"]).max()
    t0 = time.perf_counter()
    prog = aoti.NativeProgram(prog_dir)
    runner_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch._inductor.aoti_load_package(os.path.join(prog_dir, "program.pt2"))
    package_load_s = time.perf_counter() - t0
    log(f"native: aoti_tool (a fresh process, no Python) over {len(batches)} batches of "
        f"{P20_BATCH}: {tool_wall:.2f} s in all, load {float(stats['load_s']):.3f} s, run "
        f"{float(stats['run_s']):.3f} s; against the in-process rows max abs err "
        f"{err:.4e} ({'bit for bit' if np.array_equal(cli, native_rows['299x299']) else 'not bit for bit'}); "
        f"in-process NativeProgram load {runner_load_s:.3f} s, "
        f"aoti_load_package {package_load_s:.3f} s")
    if not err <= CNN_BF16_MAX_REL * scale:
        raise AssertionError(f"aoti_tool's features {err:.4e} from the in-process ones")

    # (e)
    on_card = [torch.from_numpy(b).to(device) for b in batches]
    called = [prog(b)[0] for b in on_card]
    streamed = [out[0] for out in prog.stream(iter(on_card))]
    if not all(np.array_equal(a, b) for a, b in zip(streamed, called)) or \
            len(streamed) != len(called) or prog.live_buffers != 0:
        raise AssertionError("native: stream() is not bit for bit the loop of __call__")
    log(f"native: stream() over {len(on_card)} batches bit for bit a loop of __call__; "
        f"live buffers after: {prog.live_buffers}")
    prog.close()

    # (f)
    for label, (df, python_df) in frames.items():
        for what, stage, frame in (("native featurizer", native, df),
                                   ("Python bf16 featurizer", python, python_df)):
            images_per_s(lambda s=stage, f=frame: s.transform(f).collect(), CNN_IMAGES, what,
                         f"{label} frame, 4 partitions", card)

    # (g)
    launches = read()
    if any(launches.values()):
        raise AssertionError(f"the native stack launched attention kernels: {launches}")
    log(f"native: attention launches over phase 20: {launches} (none); phase 20 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def ported_paths_remainder(card: str, counted, train_params, f32_step_ms: float) -> dict:
    """Phase 13: the bf16 fit, the fitted transformer's persistence and the
    ViT checkpoint import, imagenet weights from Keras's cache, and the
    dispatch depths; then phase 19, the batch packer, on (e)'s weights.
    Returns the main path's launches of each kernel."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bf16-") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(tmp / f"img_{i:03d}.npy",
                    rng.random((P13_IMAGE, P13_IMAGE, 3), dtype=np.float32))
        uris = sorted(str(p) for p in tmp.glob("*.npy"))
        fitted, fit_counts = bf16_fit(card, counted, train_params, uris, f32_step_ms)
        persisted = vit_persistence(card, counted, fitted, uris)
        config, weights = imagenet_from_cache(card, counted)
        depth = dispatch_depths(card, counted, config, weights, fitted, uris)
        batch_packer(card, counted, config, weights)
    launches = dict(fit_counts)
    launches["flash_attention_fwd"] += persisted + depth
    return launches


# ---------------------------------------------------------------------------
# phase 14: the engine and online serving
# ---------------------------------------------------------------------------
P14_VARIANT = "ViT-B/16"
P14_IMAGE = 224
P14_DEVICE = "cuda"
P14_REQUESTS = 256      # (a): single-image requests ...
P14_THREADS = 16        # ... from this many threads
P14_UDF_REQUESTS = 128  # (c)
P14_UDF_THREADS = 8
P14_PADDED_REQUESTS = 32  # (d), from 4 threads
P14_PAD_TRIES = 5       # (d): rounds of 3 requests at once, until a batch pads
P14_STREAMS = 16        # (d): decode streams ...
P14_SLOTS = 8           # ... into this many slots
P14_FINGERPRINT = "chip-smoke:vit-b16:flax-seed2:bf16"
#: code the precompiling processes and the worker processes run after
#: importing this script as ``cs`` (a scratch harness that shrinks phase 14
#: for the CPU shrinks it there too)
P14_CHILD_PRELUDE = ""
P14_PRECOMPILE_TIMEOUT_S = 900.0
#: phase 14's AOTInductor programs, one child process each
P14_PARTS = ("vit", "udf", "ladder")
# one part of phase 14's AOTInductor programs compiled in a child process at
# the lowest CPU priority into the compile cache that phase 14 then loads
# from: "vit", (a)'s ragged ViT-B/16 slot block (and its rows of (b)'s
# block); "udf", (c)'s Keras UDF slot block; "ladder", (d)'s padded ladder;
# its last line is the server's warmup report, as JSON after the marker
P14_PRECOMPILE = """
import json, os, sys, time
os.nice(19)
import numpy as np, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
{prelude}
from sparkdl_tpu_torch import registerKerasImageUDF
from sparkdl_tpu_torch.ops.flash_attention import FLASH_FWD
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.utils.metrics import metrics
part = {part!r}


def warmed(server):
    before = server.status()["program_cache"]["persistent"]["bytes"]
    compiled = metrics.timer("engine.compile").seconds
    t0 = time.perf_counter()
    server.warmup()
    status = server.status()["program_cache"]
    report = {{"seconds": time.perf_counter() - t0, "warmup": status["warmup"],
              "compile_s": metrics.timer("engine.compile").seconds - compiled,
              "bytes": status["persistent"]["bytes"] - before, "ended": time.time()}}
    return server, report


if part == "udf":
    with cs.scoped_env(SPARKDL_RAGGED="1"):
        session = TorchSession.builder.appName("chip_smoke").getOrCreate()
        registerKerasImageUDF("inception_serving", {keras!r}, session=session,
                              device=cs.P14_DEVICE)
        server, report = warmed(ModelServer.from_registered_udf(
            "inception_serving", session=session,
            config=ServingConfig(max_batch=32, max_wait_ms=2.0)))
        server.close()
else:
    FLASH_FWD.build()
    params = cs.flax_layout_vit_params(seed=2, classes=cs.N_CLASSES)
    with cs.scoped_env(SPARKDL_RAGGED="1" if part == "vit" else "0"):
        server, report = warmed(cs.vit_server(params, 32 if part == "vit" else 4))
        if part == "vit":
            ep = server._endpoints["vit"]
            block = torch.from_numpy(np.load({block!r})).to(cs.P14_DEVICE)
            mask = torch.ones(block.shape[0], dtype=torch.bool, device=cs.P14_DEVICE)
            np.save({rows!r}, ep._ragged_program()(ep._params, block, mask).cpu().numpy())
        server.close()
print("P14_PRECOMPILE " + json.dumps(report), flush=True)
"""


def p14_images(n: int):
    """Phase 14's first ``n`` images (its generator's first draw)."""
    return np.random.default_rng(14).random((n, P14_IMAGE, P14_IMAGE, 3), dtype=np.float32)


class ServingPrecompile:
    """Phase 14's programs (``P14_PRECOMPILE``) compiled in three child
    processes at once (``P14_PARTS``), each at the lowest CPU priority
    (nice 19), started after phase 6 so that their minutes of compiling run
    beside phases 7-12 and not in phase 14, as :class:`NativeExport`'s do.
    It holds the compile-cache directory, (c)'s ``.keras`` file and (b)'s
    block, which it writes before it starts the children. :meth:`wait`,
    before phase 13, joins them; phase 14 loads what they compiled.
    :meth:`close` stops those still running and removes the files."""

    def __init__(self):
        import gzip
        import os

        from sparkdl_tpu_torch.models.keras_model import write_keras_file

        self.dir = Path(tempfile.mkdtemp(prefix="chip-smoke-serving-"))
        self.programs = str(self.dir / "programs")
        self.keras = str(self.dir / "inception_v3.keras")
        self.block = str(self.dir / "block.npy")
        self.rows = str(self.dir / "rows.npy")
        config = json.loads(gzip.decompress(KERAS_CONFIG.read_bytes()))
        write_keras_file(self.keras, config, keras_inception_weights(config, seed=11))
        np.save(self.block, p14_images(32))
        self.started = time.perf_counter() - _STARTED
        self.result = None
        env = dict(os.environ, SPARKDL_COMPILE_CACHE=self.programs)
        self.children = {part: NicedChild(
            P14_PRECOMPILE.format(root=str(Path(__file__).resolve().parent),
                                  prelude=P14_CHILD_PRELUDE, part=part, block=self.block,
                                  rows=self.rows, keras=self.keras),
            "P14_PRECOMPILE", self.dir / f"precompile-{part}.log", env=env)
            for part in P14_PARTS}

    def wait(self) -> dict:
        """Each part's warmup report (``vit``, ``udf``, ``ladder``: seconds,
        ``engine.compile`` seconds, package bytes, each program's source,
        the end on the wall clock) once every child has ended; raises with a
        failed child's output's end."""
        if self.result is None:
            t0 = time.perf_counter()
            deadline = t0 + P14_PRECOMPILE_TIMEOUT_S
            result = {part: child.wait(max(1.0, deadline - time.perf_counter()),
                                       f"phase 14's {part} compile")
                      for part, child in self.children.items()}
            waited = time.perf_counter() - t0
            self.result = result
            log(f"serving: phase 14's programs compiled in {len(result)} child processes from "
                f"{self.started:.1f} s of the script, ended at "
                + ", ".join(f"{part} {r['ended'] - _STARTED_EPOCH:.1f} s"
                            for part, r in result.items())
                + f"; phase 13 waited {waited:.2f} s for them")
        return self.result

    def close(self) -> None:
        import shutil

        for child in self.children.values():
            child.stop()
        shutil.rmtree(self.dir, ignore_errors=True)


def bf16_vit(train_params):
    """Phase 5's seeded weights in an eager bf16 flash ViT-B/16 on the card
    (phases 14 and 15)."""
    import torch

    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.models.vit import ViT

    module = ViT(variant=P14_VARIANT, num_classes=N_CLASSES, image_size=P14_IMAGE,
                 attn_impl="flash", dtype=torch.bfloat16)
    module.load_state_dict(vit_state_dict_from_flax(train_params), strict=True)
    return module.to(P14_DEVICE).eval()


def vit_server(train_params, max_batch: int):
    """Phase 14's ViT-B/16 endpoint: phase 5's seeded weights in a bf16
    flash ViT, served through ``ModelServer.from_torch_function`` with a
    durable fingerprint (a warm start in another process loads it)."""
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

    fn = TorchFunction.from_module(bf16_vit(train_params))
    fn.fingerprint = P14_FINGERPRINT
    fn.input_specs = [((1, P14_IMAGE, P14_IMAGE, 3), np.float32)]
    return ModelServer.from_torch_function(
        fn, model_id="vit", config=ServingConfig(max_batch=max_batch, max_wait_ms=2.0),
        device=P14_DEVICE)


def serve_from_threads(server, items, n_threads: int):
    """Each of ``n_threads`` threads sends its share of ``items`` one request
    at a time (item i by thread i % n_threads) and waits for each result.
    Returns the results in item order, each request's latency (ms, the
    client's clock) and the wall seconds of the whole."""
    import threading

    out, lat = [None] * len(items), [0.0] * len(items)
    barrier = threading.Barrier(n_threads + 1)
    errors = []

    def client(t):
        barrier.wait()
        try:
            for i in range(t, len(items), n_threads):
                t0 = time.perf_counter()
                out[i] = server.predict(items[i], timeout=600)
                lat[i] = 1e3 * (time.perf_counter() - t0)
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return np.stack(out), lat, wall


def serving_line(label: str, n: int, lat, wall: float, card: str) -> str:
    p50, p99 = np.percentile(lat, [50, 99])
    return (f"{label}: {n} requests in {wall:.3f} s = {n / wall:.1f} requests/s, latency "
            f"p50 {p50:.2f} ms, p99 {p99:.2f} ms ({card})")


def vit_plain_f32(train_params, images):
    """The float32 plain forward, unbatched: ViT-B/16 with dense attention
    on each image alone."""
    import torch

    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.models.vit import ViT

    module = ViT(variant=P14_VARIANT, num_classes=N_CLASSES, image_size=P14_IMAGE,
                 attn_impl="full")
    module.load_state_dict(vit_state_dict_from_flax(train_params), strict=True)
    module = module.to(P14_DEVICE).eval()
    with torch.inference_mode():
        return np.stack([module(torch.from_numpy(x[None]).to(P14_DEVICE))[0].cpu().numpy()
                         for x in images])


def check_bf16_rows(label: str, got, want, against: str = "the float32 plain forward") -> float:
    err = float(np.abs(got - want).max())
    bound = CNN_BF16_MAX_REL * float(np.abs(want).max())
    log(f"  {label}: max_abs_err {err:.4e} against {against} "
        f"(bound {bound:.4e}: 3% of its largest value)")
    if got.shape != want.shape or not np.isfinite(got).all() or err > bound:
        raise AssertionError(f"{label}: rows off {against} by {err}")
    return err


def device_used() -> int:
    """Bytes in use on the card as its driver counts them (so a loaded
    program's own allocations count too), the caching allocator's free
    blocks released first."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return total - free


def mib(n: float) -> str:
    return f"{n / 2**20:.1f} MiB"


def udf_program_repair(udf_server, fn, items, plain) -> None:
    """Phase 14 (e), the repair of a package given non-contiguous weights:
    the UDF endpoint's compiled slot-block program called straight through
    ``ExecutionEngine.program`` (a memory hit, no batcher, no compile) with
    the Keras model's weights in their own layout (``fn.placed_params``:
    the kernels are transposed views), its rows held to the plain forward
    at ``SLICE_TOL``."""
    import torch

    from sparkdl_tpu_torch.utils.metrics import metrics

    ep = udf_server._endpoints[next(iter(udf_server._endpoints))]
    raw = fn.placed_params(P14_DEVICE)
    strided = sum(not v.is_contiguous() for v in raw.values() if isinstance(v, torch.Tensor))
    if not strided:
        raise AssertionError("(e) the Keras kernels are all contiguous: nothing to repair")
    compiles = metrics.timer("engine.compile").entries
    hits = metrics.counter("engine.cache_hit").value
    n = ep._pool.n_slots
    block, mask = ep._place(np.stack(items[:n]).astype(ep._dtype), np.ones(n, bool))
    repaired = ep._ragged_program()(raw, block, mask).cpu().numpy()
    if metrics.timer("engine.compile").entries != compiles or \
            metrics.counter("engine.cache_hit").value != hits:
        raise AssertionError("(e) resolving the UDF's program did not hit memory")
    err = float(np.abs(repaired - plain[:n]).max())
    log(f"  (e) the UDF's compiled program called through the engine with {strided} "
        f"non-contiguous kernels of {len(raw)} weights: {n} rows max_abs_err {err:.3e} "
        f"against the plain forward (SLICE_TOL {SLICE_TOL}), no compile")
    np.testing.assert_allclose(repaired, plain[:n], **SLICE_TOL)


def online_serving(card: str, counted, train_params, precompiled: ServingPrecompile,
                   then=None) -> int:
    """Phase 14: ``ModelServer`` on the card through ``ExecutionEngine``
    (AOTInductor programs in a persistent cache, compiled by
    ``precompiled``'s child process and loaded here): (a) a ViT-B/16 bf16
    endpoint through #1, (b) its warm start: this process loads the
    program another compiled, (c) the Keras InceptionV3 UDF endpoint, (e)
    its compiled program called straight through the engine with the Keras
    model's non-contiguous kernels, (d) the padded ladder and the decode
    plane. ``then(server,
    images, want, serving_a)`` runs last, with (a)'s endpoint still open and
    its programs in memory (phase 15 streams through it; phase 16 sets its
    routed requests/s beside ``serving_a``, (a)'s line). Returns the
    lse-free forward's launches of (a) and (d)."""
    import torch

    from sparkdl_tpu_torch import registerKerasImageUDF
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct, imageStructToArray
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
    from sparkdl_tpu_torch.sql.functions import col
    from sparkdl_tpu_torch.sql.session import TorchSession
    from sparkdl_tpu_torch.utils.metrics import metrics

    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS

    reset, read = counted
    blocks = VIT_VARIANTS[P14_VARIANT][2]  # flash launches a forward: one per block
    launches = 0
    compiled = precompiled.wait()

    def child_sources(label):
        return [r["source"] for r in
                next(iter(compiled[label]["warmup"].values())).values()]

    with scoped_env(SPARKDL_COMPILE_CACHE=precompiled.programs, SPARKDL_RAGGED="1"):
        rng = np.random.default_rng(14)
        images = rng.random((P14_REQUESTS, P14_IMAGE, P14_IMAGE, 3), dtype=np.float32)
        if images[:32].tobytes() != np.load(precompiled.block).tobytes():
            raise AssertionError("(b)'s block is not phase 14's first 32 images")
        want = vit_plain_f32(train_params, images)

        # (a) the ViT-B/16 endpoint, ragged, through the flash forward: the
        # child compiled its slot-block program, this process loads it
        metrics.reset()
        used0 = device_used()
        server = vit_server(train_params, 32)
        used1 = device_used()
        t0 = time.perf_counter()
        assert server.warmup() == {"vit": ("ragged",)}
        warm_s = time.perf_counter() - t0
        used2 = device_used()
        report = server.status()["program_cache"]["warmup"]["vit"]["ragged"]
        weights = sum(t.numel() * t.element_size()
                      for t in server._endpoints["vit"]._params.values())
        cold = compiled["vit"]
        log(f"serving (a): ViT-B/16 bf16 slot block of 32, compiled in the child in "
            f"{cold['seconds']:.2f} s (engine.compile {cold['compile_s']:.2f} s), loaded here: "
            f"warmup {warm_s:.2f} s ({report['source']}) ({card})")
        log(f"  (a) card memory: the endpoint's weights {mib(used1 - used0)} ({mib(weights)} of "
            f"params), its slot-block program {mib(used2 - used1)} more; the package on disk "
            f"{mib(cold['bytes'])}")
        if child_sources("vit") != ["compile"]:
            raise AssertionError(f"the child's warmup did not compile: {cold}")
        compiles = metrics.counter("serving.compiles").value
        batches0 = metrics.counter("serving.batches").value
        reset()
        got, lat, wall = serve_from_threads(server, images, P14_THREADS)
        counts = read()
        batches = metrics.counter("serving.batches").value - batches0
        serving_a = serving_line(f"(a) {P14_THREADS} threads", P14_REQUESTS, lat, wall, card)
        log("  " + serving_a)
        snap = metrics.snapshot("serving.")
        log(f"  (a) {batches:.0f} blocks, occupancy mean {snap['serving.batch_occupancy.mean']:.3f}; "
            f"server-side latency p50 {snap['serving.latency_ms.p50']:.2f} ms, p99 "
            f"{snap['serving.latency_ms.p99']:.2f} ms; launches {counts}")
        check_bf16_rows("(a) served rows", got, want)
        if metrics.counter("serving.compiles").value != compiles:
            raise AssertionError("serving compiled after warmup")
        if batches > P14_REQUESTS // 4:
            raise AssertionError(f"{P14_REQUESTS} requests took {batches} blocks")
        if list(counts.values()) != [blocks * batches, 0, 0, 0]:
            raise AssertionError(f"(a) launches {counts}, expected {blocks} x {batches} "
                                 "dispatched blocks")
        launches += counts["flash_attention_fwd"]

        # (b) the warm start: (a)'s warmup in this process loaded from disk
        # what the child compiled, and the two programs agree bit for bit on
        # one full block
        block_dev = torch.from_numpy(images[:32]).to(P14_DEVICE)
        mask = torch.ones(32, dtype=torch.bool, device=P14_DEVICE)
        ep = server._endpoints["vit"]
        warm_out = ep._ragged_program()(ep._params, block_dev, mask).cpu().numpy()
        del ep  # the endpoint stays open for phase 15, its programs in memory
        cold_out = np.load(precompiled.rows)
        warm = metrics.snapshot("engine.")
        log(f"serving (b): warm start, the child's program in this process: "
            f"{report['source']}, warmup {warm_s:.2f} s (of it engine.cache_load "
            f"{warm.get('engine.cache_load.seconds', 0.0):.2f} s), engine.cache_hit "
            f"{warm.get('engine.cache_hit', 0):.0f}, engine.compile "
            f"{warm.get('engine.compile.seconds', 0.0):.2f} s; block of 32 bit for bit "
            f"{warm_out.tobytes() == cold_out.tobytes()} ({card})")
        if report["source"] != "disk" or warm.get("engine.cache_miss", 0) or \
                warm.get("engine.compile.seconds", 0.0):
            raise AssertionError(f"the warm start compiled: {report}, {warm}")
        if warm_out.tobytes() != cold_out.tobytes():
            raise AssertionError("the loaded program's block differs from the compiled one's")

        # (c) the Keras InceptionV3 UDF endpoint (its program the child's)
        path = precompiled.keras
        session = TorchSession.builder.appName("chip_smoke").getOrCreate()
        udf = registerKerasImageUDF("inception_serving", path, session=session,
                                    device=P14_DEVICE)
        bgr = rng.integers(0, 256, (P14_UDF_REQUESTS, 299, 299, 3), dtype=np.uint8)
        structs = [imageArrayToStruct(a, origin=f"img_{i}") for i, a in enumerate(bgr)]
        # a client decodes each struct (stored BGR) to the model's RGB floats
        items = [imageStructToArray(s)[..., ::-1].astype(np.float32) for s in structs]
        metrics.reset()
        udf_server = ModelServer.from_registered_udf(
            "inception_serving", session=session,
            config=ServingConfig(max_batch=32, max_wait_ms=2.0))
        t0 = time.perf_counter()
        udf_server.warmup()
        udf_s = time.perf_counter() - t0
        sources = [r["source"] for r in next(iter(
            udf_server.status()["program_cache"]["warmup"].values())).values()]
        log(f"serving (c): Keras InceptionV3 UDF endpoint, float32 slot block of 32, compiled "
            f"in the child in {compiled['udf']['seconds']:.2f} s, loaded here: warmup "
            f"{udf_s:.2f} s ({', '.join(sources)}) ({card})")
        if child_sources("udf") != ["compile"] or sources != ["disk"] or \
                metrics.timer("engine.compile").entries:
            raise AssertionError(f"(c): the child's warmup {compiled['udf']}, this one's "
                                 f"{sources}")
        reset()
        got, lat, wall = serve_from_threads(udf_server, items, P14_UDF_THREADS)
        counts = read()
        log(serving_line(f"  (c) {P14_UDF_THREADS} threads", P14_UDF_REQUESTS, lat, wall, card)
            + f"; {metrics.counter('serving.batches').value:.0f} blocks; launches {counts}")
        if any(counts.values()):
            raise AssertionError(f"the Keras endpoint launched attention kernels: {counts}")
        df = session.createDataFrame([{"i": i, "image": s} for i, s in enumerate(structs)],
                                     numPartitions=4)
        rows = sorted(df.select(col("i"), udf("image").alias("p")).collect(),
                      key=lambda r: r["i"])
        sql = np.stack([np.asarray(r["p"]) for r in rows])
        fn = TorchFunction.from_keras(path)
        plain = np.concatenate([fn(np.stack(items[i:i + 32]), device=P14_DEVICE).cpu().numpy()
                                for i in range(0, len(items), 32)])
        np.testing.assert_allclose(got, sql, **SLICE_TOL)
        np.testing.assert_allclose(got, plain, **SLICE_TOL)
        log(f"  (c) served rows against the UDF's SQL rows max_abs_err "
            f"{np.abs(got - sql).max():.3e}, against the plain forward "
            f"{np.abs(got - plain).max():.3e}")

        udf_program_repair(udf_server, fn, items, plain)
        udf_server.close()

        # (d) the padded ladder, and the decode plane
        with scoped_env(SPARKDL_RAGGED="0"):
            metrics.reset()
            padded = vit_server(train_params, 4)
            used0 = device_used()
            t0 = time.perf_counter()
            warmed = padded.warmup()
            ladder_s = time.perf_counter() - t0
            ladder_mem = device_used() - used0
            # the child compiled the three programs, this process loads them
            if warmed != {"vit": (1, 2, 4)} or child_sources("ladder") != ["compile"] * 3 \
                    or metrics.counter("serving.compiles").value \
                    or metrics.counter("serving.cache_load").value != 3:
                raise AssertionError(f"the padded ladder warmed {warmed}: the child's "
                                     f"{compiled['ladder']}")
            report = padded.status()["program_cache"]["warmup"]["vit"]
            built = compiled["ladder"]["warmup"]["vit"]
            log(f"serving (d): padded ladder (1, 2, 4) compiled in the child in "
                f"{compiled['ladder']['seconds']:.2f} s: "
                + ", ".join(f"bucket {b} {r['seconds']:.2f} s" for b, r in built.items())
                + f"; loaded here: warmup {ladder_s:.2f} s: "
                + ", ".join(f"bucket {b} {r['seconds']:.2f} s" for b, r in report.items())
                + f"; the three programs {mib(ladder_mem)} of card memory beside the weights"
                + f" ({card})")
            batches0 = metrics.counter("serving.batches").value
            reset()
            got, lat, wall = serve_from_threads(padded, images[:P14_PADDED_REQUESTS], 4)
            # three requests at once fill bucket 4 with a pad row (tried
            # until a batch padded: the threads' batches may all fit a bucket)
            for _ in range(P14_PAD_TRIES):
                futures = [padded.submit(x) for x in images[:3]]
                check_bf16_rows("(d) rows of a padded batch",
                                np.stack([f.result(timeout=600) for f in futures]), want[:3])
                pad_rows = (metrics.counter("batcher.rows_computed").value
                            - metrics.counter("batcher.rows_real").value)
                if pad_rows:
                    break
            else:
                raise AssertionError(f"(d): no batch padded in {P14_PAD_TRIES} tries")
            counts = read()
            batches = metrics.counter("serving.batches").value - batches0
            padded.close()
        log(serving_line("  (d) padded, 4 threads", P14_PADDED_REQUESTS, lat, wall, card)
            + f"; {batches:.0f} batches (with the padded ones), {pad_rows:.0f} pad rows; "
            f"launches {counts}")
        check_bf16_rows("(d) padded rows", got, want[:P14_PADDED_REQUESTS])
        if list(counts.values()) != [blocks * batches, 0, 0, 0]:
            raise AssertionError(f"(d) launches {counts}, expected {blocks} x {batches} "
                                 "batches")
        launches += counts["flash_attention_fwd"]

        def step(carries):
            return carries + 1.0, carries[:, 0].clone()

        def init(prompt):
            return np.asarray([float(np.sum(prompt)), 0.0], np.float32)

        metrics.reset()
        decoder = ModelServer(device=P14_DEVICE)
        decoder.register_decode("dec", step, init, max_steps=64, n_slots=P14_SLOTS,
                                fingerprint="chip-smoke:counting-step")
        # the first stream binds the carry shape and compiles the step
        if decoder.decode([0.0], max_steps=2, timeout=600).tolist() != [0.0, 1.0]:
            raise AssertionError("the first decode stream is not the closed form")
        decode_compile_s = metrics.timer("engine.compile").seconds
        source = decoder.warmup()["dec"]
        t0 = time.perf_counter()
        reqs = [decoder.submit_decode([float(i)], max_steps=4 + 3 * (i % 5))
                for i in range(P14_STREAMS)]
        outs = [r.future.result(timeout=300) for r in reqs]
        decode_s = time.perf_counter() - t0
        decoder.close()
        for i, out in enumerate(outs):
            if out.tolist() != [float(i + k) for k in range(4 + 3 * (i % 5))]:
                raise AssertionError(f"decode stream {i} gave {out.tolist()}")
        log(f"  (d) decode: {P14_STREAMS} streams into {P14_SLOTS} slots; the step compiled "
            f"in {decode_compile_s:.2f} s (then {source[0]}); "
            f"{int(metrics.counter('decode.tokens').value)} tokens in "
            f"{int(metrics.counter('decode.steps').value)} fused steps, {decode_s:.3f} s; "
            f"every stream the closed form")
        if then is not None:
            then(server, images, want, serving_a)
        server.close()
    return launches


P15_IMAGES = 64          # (a): phase 4's images, from .npy files ...
P15_BATCH = 32           # ... in batches of this many
P15_MAP_WORKERS = 8
P15_ROUNDS = 3           # (a): pipeline and plain placement, in turns
P15_STREAM_BATCH = 32    # (b): StreamRunner micro-batch over phase 14's 256 images
P15_WORKER_BATCH = 16    # (c): the worker's micro-batch over the URI records
P15_KILL_AT = 2          # (c): the streaming.commit call the worker dies at
P15_WORKER = """
import json, os, sys
import numpy as np, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
{prelude}
from sparkdl_tpu_torch.ops.flash_attention import FLASH_FWD
from sparkdl_tpu_torch.streaming import FileTailSource, JsonlSink, StreamRunner
FLASH_FWD.build()
module = cs.bf16_vit(cs.flax_layout_vit_params(seed=2, classes=cs.N_CLASSES))
workdir = {workdir!r}
runner = StreamRunner(FileTailSource(os.path.join(workdir, "in.jsonl")), cs.uri_scorer(module),
                      JsonlSink(os.path.join(workdir, "out.jsonl")), os.path.join(workdir, "log"),
                      config=cs.worker_config(), pack=False)
summary = runner.run(idle_timeout_s=1.0)
print(json.dumps({{"summary": summary, "launches": FLASH_FWD.launches}}))
"""


def uri_scorer(module):
    """Phase 15 (c)'s scoring function: a micro-batch of ``{"uri": path}``
    records loaded and stacked on the host, then the eager bf16 ViT on the
    card; the runner takes the result through its dispatch window."""
    import torch

    def score(values):
        x = torch.from_numpy(np.stack([np.load(v["uri"]) for v in values]))
        with torch.inference_mode():
            return module(x.to(P14_DEVICE))

    return score


class WorkerRun:
    """A worker process (``python -c code``) started now, its output read by
    a thread, so that several run at once (phases 15 (c) and 18 (c) run
    their independent workers side by side). :meth:`result` waits for it:
    ``(CompletedProcess with text stdout and stderr, its seconds)``; past
    ``timeout`` it is killed (its exit then -9)."""

    def __init__(self, code: str, env, timeout: float = 600.0):
        import threading

        self.started = time.perf_counter()
        self.popen = subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.done = None
        self.thread = threading.Thread(target=self._wait, args=(timeout,), daemon=True)
        self.thread.start()

    def _wait(self, timeout: float) -> None:
        try:
            out, err = self.popen.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.popen.kill()
            out, err = self.popen.communicate()
        self.done = (subprocess.CompletedProcess(self.popen.args, self.popen.returncode, out,
                                                 err), time.perf_counter() - self.started)

    def result(self):
        self.thread.join()
        return self.done


def worker_config():
    from sparkdl_tpu_torch.streaming import StreamConfig

    # a queue of one micro-batch: a preemption flushes what was admitted,
    # and the resumed run has the rest to do
    return StreamConfig(max_batch=P15_WORKER_BATCH, max_wait_ms=20.0,
                        poll_batch=P15_WORKER_BATCH, poll_interval_ms=2.0,
                        queue_capacity=P15_WORKER_BATCH)


def sink_rows(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.endswith("\n")]


def exactly_once(label: str, rows, n: int) -> dict:
    """The sink's rows by offset; raises unless offsets 1..n each appear
    once (FileTailSource offsets are byte positions: then their count and
    uniqueness)."""
    offsets = [r["offset"] for r in rows]
    if len(offsets) != n or len(set(offsets)) != n:
        raise AssertionError(f"{label}: {len(offsets)} rows, {len(set(offsets))} distinct "
                             f"offsets for {n} records")
    return {r["offset"]: r for r in rows}


def streaming_inference(card: str, counted, train_params, server, images, want) -> int:
    """Phase 15: the data pipeline and streaming inference on the card. (a)
    ``Dataset.from_files`` over phase 4's images, a threaded load, cyclic
    batches of 32, ``prefetch`` and ``prefetch_to_device`` (a pinned buffer
    and a side-stream copy) into the eager bf16 flash ViT-B/16: rows bit for
    bit those of the same batches placed by ``.to()``. (b)
    ``StreamRunner.from_server`` over phase 14's endpoint, 256 records into a
    ``JsonlSink``, tracing on: each offset once, within the bf16 bound of the
    float32 plain forward, no compile. (c) exactly-once on the card: a
    worker process scoring ``FileTailSource`` URI records, uninterrupted,
    then killed at ``streaming.commit`` and restarted; then an in-process
    preemption flushed and resumed. Returns #1's launches of (a), (b) and
    (c)'s in-process runs."""
    import io
    import os

    import torch

    from sparkdl_tpu_torch.data import Dataset
    from sparkdl_tpu_torch.obs import JsonlTraceSink, tracer
    from sparkdl_tpu_torch.resilience import preempt
    from sparkdl_tpu_torch.streaming import (
        CommitLog,
        JsonlSink,
        QueueSource,
        StreamConfig,
        StreamRunner,
    )
    from sparkdl_tpu_torch.utils.metrics import metrics

    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS

    reset, read = counted
    blocks = VIT_VARIANTS[P14_VARIANT][2]
    launches = 0
    module = bf16_vit(train_params)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(1)  # phase 4's images
        uris = []
        for i in range(P15_IMAGES):
            uris.append(str(tmp / f"img_{i:03d}.npy"))
            np.save(uris[-1], rng.random((P14_IMAGE, P14_IMAGE, 3), dtype=np.float32))

        # (a) the pipeline, against the same batches placed plainly
        def load(pair):
            return np.load(io.BytesIO(pair[1]))

        def batches():
            return (Dataset.from_files(uris).map(load, num_workers=P15_MAP_WORKERS)
                    .batch(P15_BATCH, pad="cyclic"))

        def run(pipelined: bool):
            source = batches().prefetch(2).prefetch_to_device(device=P14_DEVICE) \
                if pipelined else batches()
            rows = []
            with torch.inference_mode():
                for b in source:
                    x = b.items if pipelined else torch.from_numpy(b.items).to(P14_DEVICE)
                    rows.append(module(x).float()[:b.n_real])
            return torch.cat(rows).cpu().numpy()

        plain = run(False)
        metrics.reset()
        reset()
        piped = run(True)
        counts = read()
        n_batches = -(-P15_IMAGES // P15_BATCH)
        if list(counts.values()) != [blocks * n_batches, 0, 0, 0]:
            raise AssertionError(f"(a) launches {counts}, expected {blocks} x {n_batches}")
        launches += counts["flash_attention_fwd"]
        if piped.tobytes() != plain.tobytes():
            raise AssertionError(f"(a) prefetch_to_device rows differ from plain placement by "
                                 f"{np.abs(piped - plain).max()}")
        walls = {True: [], False: []}
        for _ in range(P15_ROUNDS):
            for pipelined in (True, False):
                t0 = time.perf_counter()
                run(pipelined)
                walls[pipelined].append(time.perf_counter() - t0)
        snap = metrics.snapshot("data.")
        log(f"stream (a): Dataset.from_files -> map({P15_MAP_WORKERS} workers) -> "
            f"batch({P15_BATCH}, cyclic) -> prefetch -> prefetch_to_device, {P15_IMAGES} "
            f"images into the eager bf16 flash ViT-B/16: rows bit for bit those of plain "
            f"placement; launches {counts} ({card})")
        log(f"  (a) images/s, prefetch_to_device: "
            + ", ".join(f"{P15_IMAGES / w:.1f}" for w in walls[True])
            + "; plain .to(): " + ", ".join(f"{P15_IMAGES / w:.1f}" for w in walls[False])
            + f"; data.device_stall_ms mean {snap.get('data.device_stall_ms.mean', 0.0):.3f} "
            f"ms, p99 {snap.get('data.device_stall_ms.p99', 0.0):.3f} ms over "
            f"{snap.get('data.device_stall_ms.count', 0):.0f} waits; data.rows_out "
            f"{snap.get('data.rows_out', 0):.0f}")

        # (b) StreamRunner.from_server over phase 14's endpoint, traced
        compiles = metrics.timer("engine.compile").entries
        served_compiles = metrics.counter("serving.compiles").value
        batches0 = metrics.counter("serving.batches").value
        spans = JsonlTraceSink(capacity=1 << 16)
        tracer.enable(spans)
        try:
            src = QueueSource()
            src.put_all(list(images))
            src.end()
            runner = StreamRunner.from_server(
                src, server, JsonlSink(str(tmp / "served.jsonl")), str(tmp / "served_log"),
                model_id="vit",
                config=StreamConfig(max_batch=P15_STREAM_BATCH, max_wait_ms=5.0,
                                    poll_batch=64, poll_interval_ms=2.0),
                encode=lambda rec, out: {"offset": int(rec.offset),
                                         "output": np.asarray(out).tolist()})
            reset()
            t0 = time.perf_counter()
            summary = runner.run()
            wall = time.perf_counter() - t0
            counts = read()
            text = server.metrics_text()
        finally:
            tracer.disable()
        served = metrics.counter("serving.batches").value - batches0
        by_offset = exactly_once("(b)", sink_rows(tmp / "served.jsonl"), len(images))
        if sorted(by_offset) != list(range(1, len(images) + 1)):
            raise AssertionError("(b) the sink's offsets are not the source's")
        got = np.stack([np.asarray(by_offset[i + 1]["output"], np.float32)
                        for i in range(len(images))])
        check_bf16_rows("(b) streamed rows", got, want)
        if metrics.timer("engine.compile").entries != compiles or \
                metrics.counter("serving.compiles").value != served_compiles:
            raise AssertionError("(b) the stream compiled a program")
        if list(counts.values()) != [blocks * served, 0, 0, 0]:
            raise AssertionError(f"(b) launches {counts}, expected {blocks} x {served} blocks")
        launches += counts["flash_attention_fwd"]
        names = {sp["name"] for sp in spans.spans()}
        missing = {"streaming.run", "streaming.poll", "streaming.epoch", "streaming.commit",
                   "serving.request", "serving.batch"} - names
        if missing or spans.dropped:
            raise AssertionError(f"(b) spans missing {missing} (dropped {spans.dropped})")
        for series in ("serving_requests", "serving_batches", "serving_latency_ms",
                       "streaming_records_in", "streaming_epochs_committed",
                       "streaming_record_latency_ms"):
            if series not in text:
                raise AssertionError(f"(b) metrics_text() lacks {series}")
        lat = metrics.snapshot("streaming.record_latency_ms")
        log(f"stream (b): StreamRunner.from_server over phase 14's endpoint, {len(images)} "
            f"records in {wall:.3f} s = {len(images) / wall:.1f} records/s, "
            f"{summary['epochs']} epochs, {served:.0f} served blocks, "
            f"streaming.record_latency_ms p50 {lat['streaming.record_latency_ms.p50']:.2f} ms, "
            f"p99 {lat['streaming.record_latency_ms.p99']:.2f} ms; engine.compile 0; "
            f"launches {counts}; {len(spans)} spans ({len(names)} names), metrics_text "
            f"{len(text.splitlines())} lines ({card})")
        # where an epoch's time goes, from the spans: the score call (the
        # rows submitted to the endpoint, their futures awaited) and the
        # commit (payload, sink and marker, each written and fsync-ed)
        for name in ("streaming.epoch", "streaming.commit", "serving.batch"):
            ms = np.array([sp["duration_ms"] for sp in spans.find(name)])
            log(f"  (b) {name} spans: {len(ms)}, mean {ms.mean():.2f} ms, max {ms.max():.2f} "
                f"ms, sum {ms.sum():.1f} ms")

        # (c) exactly-once on the card: a worker process, killed and restarted
        records = [{"uri": u} for u in uris]

        def workdir(name):
            path = tmp / name
            path.mkdir()
            with open(path / "in.jsonl", "w") as fh:
                fh.writelines(json.dumps(r) + "\n" for r in records)
            return path

        def worker(path, plan=None):
            env = dict(os.environ)
            env.pop("SPARKDL_FAULT_PLAN", None)
            if plan is not None:
                env["SPARKDL_FAULT_PLAN"] = json.dumps(plan)
            return WorkerRun(P15_WORKER.format(root=str(Path(__file__).resolve().parent),
                                               prelude=P14_CHILD_PRELUDE, workdir=str(path)),
                             env)

        # the uninterrupted worker and the one killed run side by side; the
        # restart follows the kill
        t_c = time.perf_counter()
        clean_dir, killed_dir = workdir("clean"), workdir("killed")
        clean_run = worker(clean_dir)
        killed_run = worker(killed_dir, [{"site": "streaming.commit", "kill": True,
                                          "at": P15_KILL_AT}])
        proc, clean_s = clean_run.result()
        if proc.returncode != 0:
            raise AssertionError(f"(c) the uninterrupted worker failed:\n{proc.stderr[-3000:]}")
        clean_launches = json.loads(proc.stdout.strip().splitlines()[-1])["launches"]
        clean = exactly_once("(c) uninterrupted", sink_rows(clean_dir / "out.jsonl"), len(records))
        proc, killed_s = killed_run.result()
        if proc.returncode != 9:
            raise AssertionError(f"(c) the killed worker exited {proc.returncode}, not 9:\n"
                                 f"{proc.stderr[-3000:]}")
        log_dir = CommitLog(str(killed_dir / "log"))
        pending = log_dir.pending()
        if not pending:
            raise AssertionError("(c) the kill left no payload without its marker")
        payloads = {e: log_dir.payload(e)["records"] for e in pending}
        proc, restart_s = worker(killed_dir).result()
        if proc.returncode != 0:
            raise AssertionError(f"(c) the restarted worker failed:\n{proc.stderr[-3000:]}")
        restarted = json.loads(proc.stdout.strip().splitlines()[-1])["summary"]
        if restarted["replayed"] != len(pending) or log_dir.pending():
            raise AssertionError(f"(c) the restart replayed {restarted['replayed']} of "
                                 f"{len(pending)} pending epochs")
        rows = sink_rows(killed_dir / "out.jsonl")
        resumed = exactly_once("(c) killed and restarted", rows, len(records))
        if set(resumed) != set(clean):
            raise AssertionError("(c) the restarted sink holds other offsets")
        for epoch, recs in payloads.items():
            lines = [{k: v for k, v in r.items() if k != "epoch"} for r in rows
                     if r["epoch"] == epoch]
            if json.dumps(lines) != json.dumps(recs):
                raise AssertionError(f"(c) replayed epoch {epoch} differs from its payload")
        by_uri = {r["input"]["uri"]: np.asarray(r["output"], np.float32) for r in clean.values()}
        got = np.stack([np.asarray(r["output"], np.float32) for r in resumed.values()])
        ref = np.stack([by_uri[r["input"]["uri"]] for r in resumed.values()])
        check_bf16_rows("(c) restarted rows", got, ref, against="the uninterrupted run")

        # ... and an in-process preemption: flushed, then resumed
        src = QueueSource()
        src.put_all(records)
        sink_path = tmp / "preempted.jsonl"
        score = uri_scorer(module)
        scored = []

        def scored_then_preempted(values):
            # the first micro-batch asks for a preemption, as SIGTERM would:
            # the loop stops at its next check and flushes what was admitted
            if not scored:
                preempt.request_preemption("chip smoke preemption")
            scored.append(len(values))
            return score(values)

        runner = StreamRunner(src, scored_then_preempted, JsonlSink(str(sink_path)),
                              str(tmp / "preempted_log"), config=worker_config(), pack=False)
        reset()
        summary = runner.run()
        src.end()
        second = StreamRunner(src, uri_scorer(module), JsonlSink(str(sink_path)),
                              str(tmp / "preempted_log"), config=worker_config(),
                              pack=False).run()
        counts = read()
        launches += counts["flash_attention_fwd"]
        preempted = exactly_once("(c) preempted and resumed", sink_rows(sink_path),
                                 len(records))
        got = np.stack([np.asarray(r["output"], np.float32) for r in preempted.values()])
        ref = np.stack([by_uri[r["input"]["uri"]] for r in preempted.values()])
        check_bf16_rows("(c) preempted rows", got, ref, against="the uninterrupted run")
        if summary["stop_reason"] != "preempted" or second["stop_reason"] != "source_finished":
            raise AssertionError(f"(c) preemption: {summary['stop_reason']}, then "
                                 f"{second['stop_reason']}")
        log(f"stream (c): worker processes over {len(records)} FileTailSource URI records: "
            f"uninterrupted {clean_s:.1f} s ({clean_launches} launches), killed at "
            f"streaming.commit {P15_KILL_AT} (exit 9) {killed_s:.1f} s, restarted "
            f"{restart_s:.1f} s replaying epochs {sorted(payloads)} bit for bit from their "
            f"payloads; every offset once; preempted in process after "
            f"{summary['epochs']} epochs, resumed for {second['epochs']}; (c) in all "
            f"{time.perf_counter() - t_c:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the replica plane
# ---------------------------------------------------------------------------
P16_REPLICAS = 2
P16_THREADS = 16         # (b), (c): client threads of the one-shot waves
P16_STREAMS = 16         # (c): decode streams of 4-16 steps ...
P16_STREAM_THREADS = 4   # ... from this many threads
P16_AFTER = 32           # (c): requests after the restart
P16_DRAIN = 64           # (d): requests in flight across the drain
P16_OTHER_LANE = 64      # (f)
P16_SPAWN_TIMEOUT_S = 300.0


def vit_replica_server():
    """Phase 16's replica factory (``chip_smoke:vit_replica_server``, run in
    each replica process): ``ModelServer()`` on the card with two eager
    endpoints, phase 5's seeded weights as a bf16 flash ViT-B/16 at full
    width (``vit``, ``ServingConfig(max_batch=32, max_wait_ms=2)``) and
    phase 14 (d)'s torch decode step in 8 slots (``dec``). Eager, because a
    fresh process's first program load costs tens of seconds. Before it
    returns, one request through the server must launch #1 once a block."""
    return vit_replica(seed=2)


def vit_replica_server_v2():
    """Phase 17 (a)'s second version (``chip_smoke:vit_replica_server_v2``):
    :func:`vit_replica_server` with the weights of another seed."""
    return vit_replica(seed=P17_V2_SEED)


def vit_replica(seed: int):
    """The replica server of :func:`vit_replica_server`, its ViT-B/16
    weights drawn from ``seed``."""
    import torch

    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS
    from sparkdl_tpu_torch.ops.flash_attention import FLASH_FWD
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module = bf16_vit(flax_layout_vit_params(seed=seed, classes=N_CLASSES))
    server = ModelServer(ServingConfig(max_batch=32, max_wait_ms=2.0))

    def forward(x):
        with torch.inference_mode():
            return module(x)

    def step(carries):
        return carries + 1.0, carries[:, 0].clone()

    def init(prompt):
        return np.asarray([float(np.sum(prompt)), 0.0], np.float32)

    server.register("vit", forward, item_shape=(P14_IMAGE, P14_IMAGE, 3), compile=False)
    server.register_decode("dec", step, init, max_steps=64, n_slots=P14_SLOTS, compile=False)
    blocks = VIT_VARIANTS[P14_VARIANT][2]
    before = FLASH_FWD.launches
    row = server.predict(np.zeros((P14_IMAGE, P14_IMAGE, 3), np.float32), model_id="vit",
                         timeout=600)
    if FLASH_FWD.launches - before != blocks or not np.isfinite(row).all():
        raise RuntimeError(f"the replica's first block launched #1 "
                           f"{FLASH_FWD.launches - before} times, not {blocks}")
    return server


class RoutedClient:
    """``serve_from_threads``' view of a router: ``predict`` is one routed
    request of the ViT endpoint."""

    def __init__(self, router, on_answer=None):
        self.router = router
        self.on_answer = on_answer

    def predict(self, item, timeout=None):
        out = self.router.route(item, model_id="vit", timeout_s=timeout)
        if self.on_answer is not None:
            self.on_answer()
        return out


def http_get(url: str):
    """(status, body) of one GET, an error status included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def routed_stream(router, prompt: float, steps: int):
    """One decode stream through the router, re-sent whole after a typed
    transient or connection-shaped failure (the router retries a stream only
    before its first token; a stream torn by a replica's death fails typed,
    never spliced). Returns (tokens, times re-sent)."""
    from sparkdl_tpu_torch.resilience.errors import is_transient

    for resent in range(4):
        try:
            reply = router.route_stream([prompt], model_id="dec", max_steps=steps,
                                        timeout_s=120.0)
            return reply["result"].tolist(), resent
        except Exception as exc:  # noqa: BLE001 - re-raised unless typed
            if not (isinstance(exc, (ConnectionError, OSError)) or is_transient(exc)):
                raise
    raise AssertionError(f"the stream of prompt {prompt} failed four times")


def replica_plane(card: str, images, want, serving_a: str) -> list:
    """Phase 16: ``ReplicaSupervisor`` over two replica processes of
    :func:`vit_replica_server` behind the ``Router``, tracing on in the
    router and the replicas. (a) start, (b) phase 14's 256 images from 16
    threads, (c) a second wave with 16 decode streams and a SIGKILL of
    replica 0 a third of the way, (d) SIGTERM of replica 1 with requests in
    flight, (e) the telemetry plane, (f) the other wire lane. #1's launches
    are checked in the replicas (12 a block, in the factory); the parent
    counts none. Returns (b)'s replay records (``records_from_spans`` over
    the router's ``router.request`` spans), which phase 21 (a) replays."""
    import os
    import threading

    from sparkdl_tpu_torch.obs import JsonlTraceSink, diagnose, diagnose_paths, tracer
    from sparkdl_tpu_torch.serving import ReplicaSpec, ReplicaSupervisor
    from sparkdl_tpu_torch.serving.router import Router
    from sparkdl_tpu_torch.sim import records_from_spans
    from sparkdl_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    spec = ReplicaSpec(factory="chip_smoke:vit_replica_server", pythonpath=(root,))
    metrics.reset()
    sink = JsonlTraceSink(capacity=1 << 16)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-replicas-") as tmp, \
            scoped_env(SPARKDL_TRACE_OUT=os.path.join(tmp, "replica_spans.jsonl"),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (root, os.environ.get("PYTHONPATH")) if p)):
        tracer.enable(sink)
        sup = ReplicaSupervisor(spec, replicas=P16_REPLICAS, spawn_timeout_s=P16_SPAWN_TIMEOUT_S,
                                monitor_interval_s=0.1)
        try:
            # (a) start: the replicas spawn one after another
            t0 = time.perf_counter()
            sup.start()
            if not sup.wait_live(P16_REPLICAS, P16_SPAWN_TIMEOUT_S):
                raise AssertionError(f"(a) replicas not live: {sup.status()}")
            start_s = time.perf_counter() - t0
            spawn = metrics.timer("supervisor.spawn_seconds")
            lanes = sup.router.lanes()
            log(f"replicas (a): {P16_REPLICAS} replica processes of the bf16 flash ViT-B/16 "
                f"and the decode endpoint live in {start_s:.2f} s, {spawn.seconds / spawn.entries:.2f} "
                f"s a replica (spawn to ready line: import, CUDA context, weights, one block "
                f"of 12 launches of #1); lanes {lanes} ({card})")

            # (b) load: phase 14's images through router.route from 16 threads
            got, lat, wall = serve_from_threads(RoutedClient(sup.router), images, P16_THREADS)
            log(serving_line(f"replicas (b): routed, {P16_THREADS} threads", len(images), lat,
                             wall, card) + f"; in process, phase 14 {serving_a.strip()}")
            check_bf16_rows("(b) routed rows", got, want)
            served = diagnose(sink.spans(), record_metrics=False)["per_replica"]
            router_spans = os.path.join(tmp, "router_spans.jsonl")
            sink.flush(router_spans)
            # phase 21 (a) replays these: one record per routed request,
            # built from the span file before the directory goes
            with open(router_spans) as fh:
                routed = records_from_spans(json.loads(line) for line in fh)
            if len(served) != P16_REPLICAS or not all(v["requests"] for v in served.values()):
                raise AssertionError(f"(b) not every replica served: {served}")
            log("  (b) requests per replica: " + ", ".join(
                f"{name} {v['requests']}" for name, v in served.items()))

            # (c) kill: a second wave with decode streams, replica 0 killed
            answered, killed = [0], {}
            lock = threading.Lock()

            def on_answer():
                with lock:
                    answered[0] += 1
                    if answered[0] == len(images) // 3 and not killed:
                        killed["pid"] = sup.kill_replica(0)
                        killed["t"] = time.perf_counter()

            streams = [None] * P16_STREAMS

            def stream_client(t):
                for i in range(t, P16_STREAMS, P16_STREAM_THREADS):
                    streams[i] = routed_stream(sup.router, float(i), 4 + (i % 13))
                    time.sleep(0.05)

            stream_threads = [threading.Thread(target=stream_client, args=(t,))
                              for t in range(P16_STREAM_THREADS)]
            generation = sup.handles()[0].generation
            for t in stream_threads:
                t.start()
            got, lat, wall = serve_from_threads(RoutedClient(sup.router, on_answer),
                                                images[::-1], P16_THREADS)
            for t in stream_threads:
                t.join()
            if not killed:
                raise AssertionError("(c) the kill never fired")
            check_bf16_rows("(c) rows across the kill", got, want[::-1])
            resent = 0
            for i, (tokens, n) in enumerate(streams):
                resent += n
                if tokens != [float(i + k) for k in range(4 + (i % 13))]:
                    raise AssertionError(f"(c) stream {i} gave {tokens}")
            if not sup.wait_live(P16_REPLICAS, P16_SPAWN_TIMEOUT_S) or \
                    sup.handles()[0].generation <= generation:
                raise AssertionError(f"(c) replica 0 did not come back: {sup.status()}")
            kill_to_live = time.perf_counter() - killed["t"]
            log(serving_line(f"replicas (c): {len(images)} requests and {P16_STREAMS} decode "
                             f"streams, replica 0 (pid {killed['pid']}) SIGKILLed after "
                             f"{len(images) // 3}", len(images), lat, wall, card)
                + f"; every row answered, every stream its closed form ({resent} re-sent "
                f"after a typed failure); kill to live again {kill_to_live:.2f} s, "
                f"generation {generation} -> {sup.handles()[0].generation}; "
                f"router.retries {metrics.counter('router.retries').value:.0f}")
            sink.clear()
            got, lat, wall = serve_from_threads(RoutedClient(sup.router), images[:P16_AFTER], 4)
            check_bf16_rows("(c) rows after the restart", got, want[:P16_AFTER])
            after = diagnose(sink.spans(), record_metrics=False)["per_replica"]
            if len(after) != P16_REPLICAS or not all(v["requests"] for v in after.values()):
                raise AssertionError(f"(c) not every replica served after the restart: {after}")
            log(f"  (c) {P16_AFTER} requests after the restart: " + ", ".join(
                f"{name} {v['requests']}" for name, v in after.items()))

            # (d) drain: SIGTERM replica 1 with requests in flight; the
            # stop blocks through the drain, so it runs on a thread of its own
            drain = threading.Thread(target=sup.stop_replica, args=(1,),
                                     kwargs={"graceful": True})
            drained = {}

            def drain_at_a_quarter():
                with lock:
                    answered[0] += 1
                    if answered[0] == P16_DRAIN // 4:
                        drained["t"] = time.perf_counter()
                        drain.start()

            answered[0] = 0
            got, lat, wall = serve_from_threads(RoutedClient(sup.router, drain_at_a_quarter),
                                                images[:P16_DRAIN], P16_THREADS)
            drain.join(timeout=120)
            if drain.is_alive():
                raise AssertionError("(d) the drain did not end")
            check_bf16_rows("(d) rows across the drain", got, want[:P16_DRAIN])
            handle = sup.handles()[1]
            if handle.state != "stopped" or handle.last_exit != 0:
                raise AssertionError(f"(d) replica 1 {handle.state}, exit {handle.last_exit}")
            drain_s = time.perf_counter() - drained["t"]
            t0 = time.perf_counter()
            sup.revive(1)
            if not sup.wait_live(P16_REPLICAS, P16_SPAWN_TIMEOUT_S):
                raise AssertionError(f"(d) replica 1 did not come back: {sup.status()}")
            log(f"replicas (d): SIGTERM of replica 1 after {P16_DRAIN // 4} of {P16_DRAIN} "
                f"answers: every request answered, the replica drained and exited 0 in "
                f"{drain_s:.2f} s; revived in {time.perf_counter() - t0:.2f} s ({card})")

            # (e) the telemetry plane
            obs = sup.start_telemetry(sample_interval_s=0.2, slo_interval_s=0.5,
                                      fleet_interval_s=0.5)
            serve_from_threads(RoutedClient(sup.router), images[:P16_AFTER], 4)
            for h in sup.handles():
                status, body = http_get(h.obs_url() + "/healthz")
                if status != 200 or not json.loads(body)["healthy"]:
                    raise AssertionError(f"(e) {h.name} /healthz {status}: {body[:300]}")
                status, body = http_get(h.obs_url() + "/metrics")
                series = [ln for ln in body.splitlines() if ln.startswith("serving_")]
                if status != 200 or not series:
                    raise AssertionError(f"(e) {h.name} /metrics {status} holds no serving.* "
                                         "series")
                log(f"  (e) {h.name} /healthz 200 healthy; /metrics {len(series)} serving "
                    f"lines, e.g. {series[0][:80]!r}")
            deadline = time.perf_counter() + 30
            fleet = []
            while time.perf_counter() < deadline and not fleet:
                time.sleep(0.5)
                status, body = http_get(obs.url + "/debug/timeseries")
                fleet = [name for name in json.loads(body)["series"]
                         if name.startswith("fleet.")] if status == 200 else []
            if not fleet:
                raise AssertionError(f"(e) the fleet collector merged no series: "
                                     f"{sup.fleet_collector.snapshot()}")
            status, body = http_get(obs.url + "/slo")
            if status != 200:
                raise AssertionError(f"(e) /slo {status}: {body[:300]}")
            states = {o["name"]: o["state"] for o in json.loads(body)["slos"]}
            if set(states) != {"router.latency", "router.errors"}:
                raise AssertionError(f"(e) /slo holds {states}")
            log(f"replicas (e): the fleet collector merged {len(fleet)} fleet.* series "
                f"(e.g. {sorted(fleet)[:3]}); /slo {states}")

            # (f) the other lane, through a second router over the same replicas
            used = set(sup.router.lanes().values())
            other = "tcp" if used == {"shm"} else "shm"
            with scoped_env(SPARKDL_WIRE_TRANSPORT=other):
                router = Router()
                for h in sup.handles():
                    router.add(h.name, h.spec.host, h.port, lanes=h.lanes)
                try:
                    got, lat, wall = serve_from_threads(RoutedClient(router),
                                                        images[:P16_OTHER_LANE], P16_THREADS)
                    other_lanes = router.lanes()
                finally:
                    router.close()
            if set(other_lanes.values()) != {other}:
                raise AssertionError(f"(f) asked for {other}, got {other_lanes}")
            check_bf16_rows(f"(f) rows on the {other} lane", got, want[:P16_OTHER_LANE])
            log(serving_line(f"replicas (f): the {other} lane ({used} before), "
                             f"{P16_THREADS} threads", P16_OTHER_LANE, lat, wall, card)
                + f"; wire.shm.fallback {metrics.counter('wire.shm.fallback').value:.0f}")

            # phase 17 (a): a second version rolled out over this fleet and
            # promoted, then a third rolled back by an injected fault
            rollout(card, sup, spec, root, images[:P17_ROLLOUT_IMAGES],
                    want[:P17_ROLLOUT_IMAGES])
        finally:
            sup.close()
            tracer.disable()
        report = diagnose_paths([router_spans, os.path.join(tmp, "replica_spans.jsonl")],
                                record_metrics=False)
    attribution = report["attribution"]
    log(f"replicas (b) latency attribution (diagnose over the router's and the replicas' "
        f"span files: {report['spans']} spans, {report['requests']} requests, "
        f"{report['stitched_requests']} stitched): e2e p50 {attribution['e2e_p50_ms']:.2f} ms, "
        f"p99 {attribution['e2e_p99_ms']:.2f} ms; " + ", ".join(
            f"{name} p50 {v['p50_ms']:.2f} p99 {v['p99_ms']:.2f}"
            for name, v in attribution["phases"].items())
        + f" ms; coverage of p50 {attribution['coverage_p50']:.3f} ({card})")
    log(f"replicas: phase 16 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return routed


# ---------------------------------------------------------------------------
# phase 17: the rollout controller over phase 16's fleet, and parallelism
# ---------------------------------------------------------------------------
P17_V2_SEED = 3
P17_ROLLOUT_IMAGES = 64    # (a): phase 14's first images, cycled by ...
P17_ROLLOUT_THREADS = 8    # ... this many client threads
P17_STAGES = (0.25, 0.5, 1.0)
P17_BAKE_S = 3.0
P17_LATENCY_MS = 5000.0    # the canary's p99 objective: a smoke, not a load bound
P17_TIMEOUT_S = 600.0
P17_CHILD_TIMEOUT_S = 420.0
P17_CV_ROWS = 48


class RolloutTraffic:
    """Client threads that route phase 14's images round and round while a
    rollout moves the fleet. Each answer is held to the rows of one of the
    versions' weights (the float32 plain forward of each seed, at the bf16
    bound of :func:`check_bf16_rows`) and recorded with the time its request
    left; a failed request is counted lost."""

    def __init__(self, router, images, wants):
        import threading

        self.router = router
        self.images = images
        self.wants = wants
        self.answers = []   # (sent at, weights' label, max abs error)
        self.lost = []
        self.worst = {label: 0.0 for label in wants}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._client, args=(t,), daemon=True)
                         for t in range(P17_ROLLOUT_THREADS)]

    def _client(self, t: int) -> None:
        i = t
        while not self._stop.is_set():
            k = i % len(self.images)
            sent = time.monotonic()
            try:
                row = np.asarray(self.router.route(self.images[k], model_id="vit",
                                                   timeout_s=120.0), np.float32)
            except Exception as exc:  # noqa: BLE001 - counted, then failed on
                with self._lock:
                    self.lost.append(repr(exc))
                i += P17_ROLLOUT_THREADS
                continue
            errs = {label: float(np.abs(row - want[k]).max())
                    for label, want in self.wants.items()}
            label = min(errs, key=errs.get)
            bound = CNN_BF16_MAX_REL * float(np.abs(self.wants[label]).max())
            with self._lock:
                if not np.isfinite(row).all() or errs[label] > bound:
                    self.lost.append(f"image {k}: no version's rows ({errs})")
                self.answers.append((sent, label, errs[label]))
                self.worst[label] = max(self.worst[label], errs[label])
            i += P17_ROLLOUT_THREADS

    def start(self) -> "RolloutTraffic":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=180)

    def served(self, after: float = float("-inf"), before: float = float("inf")):
        """Answers per weights' label for requests sent in [after, before)."""
        with self._lock:
            out = {}
            for sent, label, _ in self.answers:
                if after <= sent < before:
                    out[label] = out.get(label, 0) + 1
            return out


def rollout_seconds(events, first: str, last: str) -> float:
    """Seconds from the first ``first`` event to the first ``last`` event."""
    at = {}
    for e in events:
        at.setdefault(e["state"], e["at"])
    return at[last] - at[first]


def rollout(card: str, sup, spec, root: str, images, want) -> None:
    """Phase 17 (a), inside phase 16's supervisor: ``RolloutController``
    deploys version v2 (the bf16 ViT-B/16 replica with seed-3 weights,
    :func:`vit_replica_server_v2`) as one replica next to the two v1
    replicas, shifts the router's weights through ``P17_STAGES`` while
    client threads keep sending, bakes each stage on the SLO engine of
    phase 16 (e) with ``rollout_slos("v2")``, promotes (``set_primary``,
    v1 drained); then a v3 (seed-2 weights again) whose first bake meets an
    ``inject`` rule at ``rollout.bake`` rolls back to v2. Every answer is
    one version's rows; requests sent after the promotion are v2's, and so
    are those sent after the rollback; no request is lost."""
    import os

    from sparkdl_tpu_torch.obs import blackbox
    from sparkdl_tpu_torch.obs.slo import rollout_slos
    from sparkdl_tpu_torch.resilience import inject
    from sparkdl_tpu_torch.serving import ReplicaSpec, RolloutController
    from sparkdl_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    spec_v2 = ReplicaSpec(factory="chip_smoke:vit_replica_server_v2", pythonpath=(root,))
    want_v2 = vit_plain_f32(flax_layout_vit_params(seed=P17_V2_SEED, classes=N_CLASSES),
                            images)
    engine = sup.slo_engine
    engine.add(*rollout_slos("v2", latency_threshold_ms=P17_LATENCY_MS))
    engine.add(*rollout_slos("v3", latency_threshold_ms=P17_LATENCY_MS))
    dumps = tempfile.mkdtemp(prefix="chip-smoke-blackbox-")
    with scoped_env(SPARKDL_BLACKBOX_DIR=dumps):
        recorder = blackbox.enable_from_env()
    traffic = RolloutTraffic(sup.router, images, {"seed 2": want, "seed 3": want_v2}).start()
    try:
        # promote v2
        ctl = RolloutController(sup, engine, "v2", spec_v2, replicas=1, stages=P17_STAGES,
                                bake_s=P17_BAKE_S, interval_s=0.2,
                                spawn_timeout_s=P16_SPAWN_TIMEOUT_S).start()
        state = ctl.wait(timeout_s=P17_TIMEOUT_S)
        ctl.close()
        report = ctl.report()
        events = ctl.events()
        if state != "done" or report["verdict"] != "promoted":
            raise AssertionError(f"(a) the v2 rollout ended {state}: {report}")
        if set(report["old_exits"].values()) != {0} or sup.primary_version != "v2" \
                or sup.live_count("v1") != 0 or sup.live_count("v2") != 1:
            raise AssertionError(f"(a) after the promotion: {report['old_exits']}, "
                                 f"{sup.status()}")
        done_at = events[-1]["at"]
        during = traffic.served(before=done_at)
        spawn_s = rollout_seconds(events, "spawning", "shifting")
        shift_s = rollout_seconds(events, "shifting", "promoting")
        promote_s = rollout_seconds(events, "promoting", "done")
        # requests sent after the promotion: v2's rows only
        time.sleep(2.0)
        after = traffic.served(after=done_at)
        if set(after) != {"seed 3"}:
            raise AssertionError(f"(a) after the promotion the answers were {after}")
        log(f"rollout (a): v1 (2 replicas) -> v2 (1 replica, seed {P17_V2_SEED}) through "
            f"stages {P17_STAGES}, bake {P17_BAKE_S} s each: spawn {spawn_s:.2f} s, shifts and "
            f"bakes {shift_s:.2f} s, promotion with v1's drain {promote_s:.2f} s (exits "
            f"{report['old_exits']}); answers while it ran {during}, after it {after} ({card})")

        # roll v3 back: the first bake meets an injected fault
        plan = inject.FaultPlan().add("rollout.bake", error="transient", at=1)
        with inject.active_plan(plan):
            ctl3 = RolloutController(sup, engine, "v3", spec, replicas=1, stages=(0.5, 1.0),
                                     bake_s=P17_BAKE_S, interval_s=0.2,
                                     spawn_timeout_s=P16_SPAWN_TIMEOUT_S).start()
            state3 = ctl3.wait(timeout_s=P17_TIMEOUT_S)
            ctl3.close()
        report3 = ctl3.report()
        events3 = ctl3.events()
        if state3 != "rolled_back" or "baking" not in (report3["reason"] or ""):
            raise AssertionError(f"(a) the v3 rollout ended {state3}: {report3}")
        if sup.primary_version != "v2" or sup.live_count("v3") != 0 \
                or sup.live_count("v2") != 1:
            raise AssertionError(f"(a) after the rollback: {sup.status()}")
        back_at = events3[-1]["at"]
        rollback_s = rollout_seconds(events3, "rolling_back", "rolled_back")
        time.sleep(2.0)
        traffic.stop()
        after3 = traffic.served(after=back_at)
        if set(after3) != {"seed 3"}:
            raise AssertionError(f"(a) after the rollback the answers were {after3}")
        if traffic.lost:
            raise AssertionError(f"(a) {len(traffic.lost)} requests lost: {traffic.lost[:3]}")
        dump = [f for f in os.listdir(dumps) if f.endswith(".json")]
        log(f"rollout (a): v2 -> v3 (seed 2) rolled back by a fault at rollout.bake: "
            f"detection {report3['detection_s']:.2f} s after the shift to "
            f"{report3['stages'][0]}, rollback (weights back, v3 drained) {rollback_s:.2f} s; "
            f"answers after it {after3}; {len(traffic.answers)} requests in all, "
            f"{len(traffic.lost)} lost; rows within {traffic.worst} of their version; "
            f"flight-recorder dumps {len(dump)} ({card})")
        log("  rollout metrics: " + ", ".join(
            f"{name}={metrics.snapshot(name).get(name, 0):.0f}" for name in (
                "rollout.state", "rollout.weight", "rollout.shifts", "rollout.rollbacks",
                "rollout.promotions")))
        log(f"rollout: phase 17 (a) in {time.perf_counter() - t_phase:.1f} s ({card})")
    finally:
        traffic.stop()
        if recorder is not None:
            recorder.stop()
            recorder.disarm()


def child_launches(function: str, marker: str, timeout_s: float) -> dict:
    """``chip_smoke.<function>()`` in a fresh process (no process that
    touched CUDA forks). Its log lines are passed on; it fails the script by
    exiting non-zero. Returns the launch counts it printed after
    ``marker``."""
    import os

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.{function}())"],
        cwd=root, env=env, stdout=subprocess.PIPE, text=True, timeout=timeout_s)
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith(marker + " "):
            launches = json.loads(line.split(" ", 1)[1])
        else:
            log(line)
    if proc.returncode != 0 or launches is None:
        raise AssertionError(f"{function}: the child exited {proc.returncode}")
    return launches


def parallel_phase(card: str) -> dict:
    """Phase 17 (b): :func:`parallel_child` in a fresh process, which brings
    up an NCCL group of one on the card. Returns the launches of #1-#4 it
    counted."""
    t0 = time.perf_counter()
    launches = child_launches("parallel_child", "PHASE17_LAUNCHES", P17_CHILD_TIMEOUT_S)
    log(f"parallel: phase 17 (b) in {time.perf_counter() - t0:.1f} s, launches "
        f"{launches} ({card})")
    return launches


def parallel_child() -> int:
    """Phase 17 (b), in a process of its own: the parallel layer in an NCCL
    process group of one on the card (``runner.initialize()``), through the
    same collectives and kernels as a larger group. Raises on any failure.

    1. a bf16 ViT-B/16 ``TorchImageFileEstimator`` fit at full width (phase
       5's weights and images, batch 32, 2 epochs of 2 steps, flash) without
       a group, then the same fit with the group up (DP: the all-reduce of
       every gradient), held to it;
    2. the same fit with ``shardingRules=VIT_TP_RULES, meshShape=(1, 1)``
       (DTensor column and row parallel layers, qkv split by head group),
       held to the DP fit;
    3. the fit and a transform with ``attn_impl=pad_tokens_for_sp(mesh,
       impl="ulysses-flash")``: the all-to-alls around the port's flash
       kernels, #2-#4 in the fit and #1 in the transform, each 12 a step
       or a batch; held to the DP flash fit and to the flash transform of
       the same weights;
    4. ``make_sp_attention`` ``ring`` and ``ulysses`` at one rank against
       ``full_attention`` on the card, float32 at ``VIT_SHAPE``;
    5. ``CrossValidator(partitionDevices=True)`` over ``LogisticRegression``
       with one slice (``parallelism=1``): its ``avgMetrics`` equal the
       unpartitioned sweep's.

    Each fit in 1-3 equals the fit without the group bit for bit (losses
    and weights): at one rank the collectives copy, and every fit computes
    the same sums in the same order (the card's readings, PERF.md).
    Prints ``PHASE17_LAUNCHES {...}``: the launches of each kernel in 1-3."""
    compiler = host_build_env()
    import torch

    if not import_package():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.estimators import TorchImageFileEstimator
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
        FLASH_FWD_LSE,
    )
    from sparkdl_tpu_torch.parallel import runner
    from sparkdl_tpu_torch.parallel.context import (
        full_attention,
        make_sp_attention,
        pad_tokens_for_sp,
    )
    from sparkdl_tpu_torch.parallel.tp import VIT_TP_RULES
    from sparkdl_tpu_torch.utils.metrics import metrics

    log(f"parallel (b): child process, {compiler}")
    kernels = (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)

    def counts():
        return {k.symbol + ("+lse" if k is FLASH_FWD_LSE else ""): k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    total = {key: 0 for key in counts()}

    def add(got):
        for key, n in got.items():
            total[key] += n

    train_params = flax_layout_vit_params(seed=2, classes=N_CLASSES)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-parallel-") as tmp:
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(Path(tmp) / f"img_{i:03d}.npy",
                    rng.random((224, 224, 3), dtype=np.float32))
        uris = sorted(str(p) for p in Path(tmp).glob("img_*.npy"))
        df = training_df(uris)
        steps = 2 * (N_IMAGES // BATCH)

        def fit(attn_impl="flash", **kw):
            est = train_estimator(ViT(variant="ViT-B/16", num_classes=N_CLASSES,
                                      attn_impl=attn_impl, dtype=torch.bfloat16),
                                  train_params, device="cuda", **kw)
            reset()
            metrics.reset()
            t0 = time.perf_counter()
            fitted = est.fit(df)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = counts()
            losses = np.array(fitted._training_losses)
            if len(losses) != steps or not np.isfinite(losses).all():
                raise AssertionError(f"bad losses {losses}")
            # the fit profiler's steps end in the card's synchronize
            step_ms = 1e3 * metrics.timer("estimator.step").seconds / \
                metrics.counter("estimator.steps").value
            return fitted, losses, got, f"{seconds:.2f} s, {step_ms:.3f} ms a step"

        def weights_apart(a, b) -> float:
            """The largest difference of two fits' weights, relative to the
            largest weight of the tensor."""
            sa, sb = a.module.state_dict(), b.module.state_dict()
            return max(float((sa[n] - sb[n]).abs().max() / sa[n].abs().max().clamp_min(1e-12))
                       for n in sa)

        def same_fit(label, a, a_losses, b, b_losses):
            """Fit ``a`` equals fit ``b`` bit for bit: losses and weights."""
            np.testing.assert_array_equal(a_losses, b_losses, err_msg=f"{label} fit's losses")
            apart = weights_apart(a, b)
            if apart != 0.0:
                raise AssertionError(f"the {label} fit's weights are {apart:.3e} apart")

        from sparkdl_tpu_torch.models.vit import VIT_VARIANTS

        blocks = VIT_VARIANTS["ViT-B/16"][2]  # one launch of each kernel a block
        fit()  # a first fit pays the process's warm-up: not the one compared
        alone, alone_losses, _, alone_s = fit()
        device = runner.initialize()
        log(f"parallel (b): a process group of one: rank {runner.process_index()} of "
            f"{runner.process_count()} on {device}, backend "
            f"{torch.distributed.get_backend()}")
        try:
            # 1. DP: the same fit with the group up
            dp, dp_losses, dp_counts, dp_s = fit()
            add(dp_counts)
            expected = blocks * steps
            if list(dp_counts.values()) != [0, expected, expected, expected]:
                raise AssertionError(f"DP fit launches {dp_counts}")
            log(f"parallel (b) 1: bf16 ViT-B/16 fit, {steps} steps at batch {BATCH}: DP in the "
                f"group {dp_s}, without {alone_s}; losses {dp_losses.tolist()} vs "
                f"{alone_losses.tolist()}; weights apart {weights_apart(dp, alone):.3e} "
                f"(relative); launches {dp_counts}")
            same_fit("DP", dp, dp_losses, alone, alone_losses)

            # 2. DP x TP on a (1, 1) mesh
            tp, tp_losses, tp_counts, tp_s = fit(shardingRules=VIT_TP_RULES, meshShape=(1, 1))
            add(tp_counts)
            if list(tp_counts.values()) != [0, expected, expected, expected]:
                raise AssertionError(f"TP fit launches {tp_counts}")
            log(f"parallel (b) 2: the fit with VIT_TP_RULES, meshShape (1, 1): {tp_s}; "
                f"losses {tp_losses.tolist()}; weights apart from DP "
                f"{weights_apart(tp, dp):.3e}; launches {tp_counts}")
            same_fit("TP", tp, tp_losses, dp, dp_losses)

            # 3. Ulysses-flash: the all-to-alls around the flash kernels
            mesh = runner.make_global_mesh(("seq",))
            sp = pad_tokens_for_sp(mesh, "seq", impl="ulysses-flash")
            uly, uly_losses, uly_counts, uly_s = fit(attn_impl=sp)
            add(uly_counts)
            if list(uly_counts.values()) != [0, expected, expected, expected]:
                raise AssertionError(f"Ulysses-flash fit launches {uly_counts}")
            log(f"parallel (b) 3: the fit with attn_impl=pad_tokens_for_sp(impl="
                f"'ulysses-flash'): {uly_s}; losses {uly_losses.tolist()}; weights "
                f"apart from the flash fit {weights_apart(uly, dp):.3e}; launches {uly_counts}")
            same_fit("Ulysses-flash", uly, uly_losses, dp, dp_losses)
            flash_stage = type(uly)(inputCol="uri", outputCol="features", imageLoader=load_npy,
                                    module=ViT(variant="ViT-B/16", num_classes=N_CLASSES,
                                               attn_impl="flash", dtype=torch.bfloat16),
                                    state_dict=uly.module.state_dict(), device="cuda")
            reset()
            t0 = time.perf_counter()
            uly_rows = rows_array(uly.transform(df).collect())
            transform_s = time.perf_counter() - t0
            tr_counts = counts()
            add(tr_counts)
            from sparkdl_tpu_torch.transformers.utils import DEFAULT_BATCH_SIZE

            batches = -(-N_IMAGES // DEFAULT_BATCH_SIZE)
            if list(tr_counts.values()) != [blocks * batches, 0, 0, 0]:
                raise AssertionError(f"Ulysses-flash transform launches {tr_counts}")
            flash_rows = rows_array(flash_stage.transform(df).collect())
            if uly_rows.shape != (N_IMAGES, N_CLASSES) or not np.isfinite(uly_rows).all():
                raise AssertionError(f"bad Ulysses-flash rows {uly_rows.shape}")
            np.testing.assert_allclose(uly_rows, flash_rows, **BF16_SLICE_TOL)
            log(f"parallel (b) 3: its transform of {N_IMAGES} images {transform_s:.2f} s, "
                f"launches {tr_counts}; rows against the flash stage's of the same weights "
                f"max_abs_err={np.abs(uly_rows - flash_rows).max():.3e}")

            # 4. ring and Ulysses at one rank against dense attention
            gen = torch.Generator(device="cuda").manual_seed(7)
            q, k, v = torch.randn((3,) + VIT_SHAPE, generator=gen, device="cuda").unbind(0)
            want = full_attention(q, k, v)
            for impl in ("ring", "ulysses"):
                fn = make_sp_attention(mesh, "seq", impl=impl)
                got = fn(q, k, v)
                err = float((got - want).abs().max())
                torch.testing.assert_close(got, want, **F32_TOL)
                ms = time_ms(lambda fn=fn: fn(q, k, v), iters=5)
                log(f"parallel (b) 4: {impl} at one rank, {VIT_SHAPE} float32: "
                    f"max_abs_err={err:.3e} against full_attention; {ms:.3f} ms "
                    f"(full_attention {time_ms(lambda: full_attention(q, k, v), iters=5):.3f} ms)")
        finally:
            runner.shutdown()

    # 5. the trial-parallel sweep over one slice of the one card
    cv_launches = counts()
    metrics_of = {}
    for partition in (False, True):
        metrics_of[partition] = cv_sweep(partition)
    if metrics_of[True] != metrics_of[False]:
        raise AssertionError(f"partitioned sweep {metrics_of[True]} vs {metrics_of[False]}")
    if counts() != cv_launches:
        raise AssertionError("the LR sweep launched an attention kernel")
    log(f"parallel (b) 5: CrossValidator(partitionDevices=True, parallelism=1) over "
        f"LogisticRegression: avgMetrics {metrics_of[True]}, equal to the unpartitioned sweep's")
    print("PHASE17_LAUNCHES " + json.dumps(total), flush=True)
    return 0


def cv_sweep(partition: bool) -> list:
    """A 2-point ``LogisticRegression`` sweep on the card over
    ``P17_CV_ROWS`` seeded vectors, 2 folds, one trial thread."""
    from sparkdl_tpu_torch.ml.classification import LogisticRegression
    from sparkdl_tpu_torch.ml.evaluation import MulticlassClassificationEvaluator
    from sparkdl_tpu_torch.ml.linalg import DenseVector
    from sparkdl_tpu_torch.ml.tuning import CrossValidator, ParamGridBuilder
    from sparkdl_tpu_torch.sql.session import TorchSession

    rng = np.random.RandomState(17)
    x = rng.randn(P17_CV_ROWS, 8)
    rows = [{"features": DenseVector(v), "label": float(v[0] + v[1] > 0)} for v in x]
    df = TorchSession.builder.getOrCreate().createDataFrame(rows)
    lr = LogisticRegression(maxIter=20, stepSize=0.1)
    grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.5]).build()
    cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
                        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
                        numFolds=2, parallelism=1, partitionDevices=partition, seed=3)
    return [float(m) for m in cv.fit(df).avgMetrics]


# ---------------------------------------------------------------------------
# phase 18: the SQL dialect and continuous SQL
# ---------------------------------------------------------------------------
P18_LABELS = 4            # label = i % 4, joined to a 4-row labels view
P18_TOP_K = 16            # (a): ROW_NUMBER() <= this many rows of each label
P18_TS_MS = 50.0          # (b), (c): record i's event time is i x this
P18_WINDOW = "2s"         # ... in tumbling windows of 40 records
P18_LATE_AFTER = {100: 100.0, 200: 3000.0}  # (b): after record i, one with this stale time
P18_STREAM_BATCH = 32     # (b): the query's micro-batch
P18_WORKER_IMAGES = 64    # (c): phase 14's first images, held on the card ...
P18_WORKER_RECORDS = 128  # ... indexed by this many records (idx = i % 64)
P18_WORKER_BATCH = 16     # (c): the worker's micro-batch (and poll and queue)
P18_KILL_AT = 3           # (c): the streaming.window_commit call the worker dies at
P18_QUERY = ("SELECT label, count(*) AS n, max(vit_top({arg})) AS top, "
             "p95(vit_top({arg})) AS p95 FROM frames "
             f"GROUP BY WINDOW(ts, '{P18_WINDOW}'), label")
P18_BOUNDED = (
    "SELECT l.name AS name, count(*) AS n, max(r.s) AS top, avg(r.s) AS mean_top, "
    "min(r.s) AS kth, max(r.rk) AS last_rank "
    "FROM (SELECT id, label, s, ROW_NUMBER() OVER (PARTITION BY label ORDER BY s DESC) "
    "AS rk FROM scored) r JOIN labels l ON r.label = l.label "
    f"WHERE r.rk <= {P18_TOP_K} GROUP BY l.name HAVING count(*) >= {P18_TOP_K} "
    "ORDER BY name")
P18_WORKER = """
import json, os, sys
import numpy as np, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
{prelude}
from sparkdl_tpu_torch.ops.flash_attention import FLASH_FWD
from sparkdl_tpu_torch.sql import TorchSession
from sparkdl_tpu_torch.streaming import FileTailSource, JsonlSink, StreamConfig
from sparkdl_tpu_torch.utils.metrics import metrics
FLASH_FWD.build()
workdir = {workdir!r}
images = torch.from_numpy(np.load(os.path.join(workdir, "images.npy"))).to(cs.P14_DEVICE)
module = cs.bf16_vit(cs.flax_layout_vit_params(seed=2, classes=cs.N_CLASSES))
session = TorchSession.builder.getOrCreate()
server = cs.vit_top_endpoint(session, module, gather=images)
session.readStream("frames", FileTailSource(os.path.join(workdir, "in.jsonl"),
                                            event_time_field="ts"))
query = session.sqlStream(
    cs.P18_QUERY.format(arg="idx"), JsonlSink(os.path.join(workdir, "out.jsonl")),
    os.path.join(workdir, "log"), late_sink=JsonlSink(os.path.join(workdir, "late.jsonl")),
    server=server,
    config=StreamConfig(max_batch=cs.P18_WORKER_BATCH, max_wait_ms=500.0,
                        poll_batch=cs.P18_WORKER_BATCH, poll_interval_ms=2.0,
                        queue_capacity=cs.P18_WORKER_BATCH))
summary = query.run(idle_timeout_s=1.0)
query.close()
server.close()
print(json.dumps({{"summary": summary, "launches": FLASH_FWD.launches,
                   "batches": metrics.counter("serving.batches").value}}))
"""


def vit_top_endpoint(session, module, gather=None):
    """Phase 18's endpoint: ``module`` (the eager bf16 flash ViT-B/16)
    served as ``vit_top`` on a new ``ModelServer``, one scalar a row, the
    largest logit; registered before any query binds, eagerly
    (``compile=False``: the phase compiles nothing). With ``gather``, a
    tensor of images on the card, an item is an index into it. The UDF
    ``vit_top`` in ``session`` scores through the endpoint on both paths:
    its function submits each value of a partition (``session.sql``), and
    its ``_serving_endpoint`` hook routes a continuous query's scoring."""
    import torch

    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
    from sparkdl_tpu_torch.sql.functions import UserDefinedFunction

    def forward(batch):
        with torch.inference_mode():
            x = gather[batch.long()] if gather is not None else batch
            return module(x).float().amax(dim=-1)

    item_shape = () if gather is not None else (P14_IMAGE, P14_IMAGE, 3)
    server = ModelServer(config=ServingConfig(max_batch=32, max_wait_ms=2.0),
                         device=P14_DEVICE)
    server.register("vit_top", forward, item_shape=item_shape, compile=False)

    def score(values):
        futures = [server.submit(np.asarray(v, np.float32), model_id="vit_top")
                   for v in values]
        return [float(f.result(timeout=600)) for f in futures]

    udf = UserDefinedFunction(score, name="vit_top", vectorized=True)
    udf._serving_endpoint = {"model_id": "vit_top", "forward": forward,
                             "item_shape": item_shape, "dtype": np.float32,
                             "fingerprint": None}
    session.udf.register("vit_top", udf)._serving_endpoint = udf._serving_endpoint
    return server


def window_aggregates(rows) -> dict:
    """Emitted window rows by (window_start, label): (n, top, p95)."""
    return {(r["window_start"], r["label"]): (r["n"], r["top"], r["p95"]) for r in rows}


def expected_windows(scores, labels, ts) -> dict:
    """numpy's window aggregates of ``scores`` (float32 plain forward) over
    the windows a watermark at the largest event time has closed: per
    (window_start, label), the count, max and linear 95th percentile."""
    from sparkdl_tpu_torch.sql.window_state import parse_duration_ms

    size = parse_duration_ms(P18_WINDOW)
    out: dict = {}
    closed_before = np.floor(max(ts) / size) * size
    for start in np.arange(0.0, closed_before, size):
        for label in sorted(set(labels)):
            sel = [s for s, lab, t in zip(scores, labels, ts)
                   if lab == label and start <= t < start + size]
            out[(float(start), label)] = (len(sel), float(np.max(sel)),
                                          float(np.percentile(sel, 95.0)))
    return out


def check_windows(label: str, got: dict, want: dict, bound: float) -> float:
    """Every window of ``want`` emitted once in ``got`` with its exact
    count; top and p95 within ``bound``. Returns the largest error."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: windows {sorted(got)} against {sorted(want)}")
    err = 0.0
    for key, (n, top, p95) in want.items():
        g = got[key]
        if g[0] != n:
            raise AssertionError(f"{label}: window {key} counted {g[0]} rows, not {n}")
        err = max(err, abs(g[1] - top), abs(g[2] - p95))
    log(f"  {label}: {len(want)} windows once each, counts exact; top and p95 max_abs_err "
        f"{err:.4e} (bound {bound:.4e})")
    if not np.isfinite(err) or err > bound:
        raise AssertionError(f"{label}: aggregates off by {err}")
    return err


def continuous_sql(card: str, counted, train_params, images, want) -> int:
    """Phase 18: the SQL dialect and continuous SQL over an eager bf16 flash
    ViT-B/16 endpoint (``vit_top``, phase 5's weights). (a) ``session.sql``
    scores phase 14's 256 images into a view, then one query joins a labels
    view, ranks each label's rows with ``ROW_NUMBER()``, groups, filters with
    HAVING and orders. (b) A standing query over a ``QueueSource`` of the
    same images (2 late records among them), traced. (c) Exactly once on
    the card: worker processes over a ``FileTailSource``, uninterrupted,
    killed at ``streaming.window_commit`` and restarted, killed at
    ``csql.plan``. Aggregates within the bf16 bound of numpy's over the
    float32 plain forward. Returns #1's launches of (a) and (b)."""
    import os

    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS
    from sparkdl_tpu_torch.obs import JsonlTraceSink, tracer
    from sparkdl_tpu_torch.sql import TorchSession
    from sparkdl_tpu_torch.streaming import CommitLog, JsonlSink, QueueSource, StreamConfig
    from sparkdl_tpu_torch.utils.metrics import metrics

    reset, read = counted
    blocks = VIT_VARIANTS[P14_VARIANT][2]
    launches = 0
    scores = want.max(axis=1)  # the float32 plain forward's largest logits
    bound = CNN_BF16_MAX_REL * float(np.abs(scores).max())
    labels = [i % P18_LABELS for i in range(len(images))]
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    server = vit_top_endpoint(session, bf16_vit(train_params))
    compiles = metrics.counter("serving.compiles").value
    engine_compiles = metrics.timer("engine.compile").entries
    with tempfile.TemporaryDirectory(prefix="chip-smoke-csql-") as tmp:
        tmp = Path(tmp)

        # (a) the bounded dialect: score into a view, then join, rank, group
        session.createDataFrame([{"id": i, "label": labels[i], "image": images[i]}
                                 for i in range(len(images))]).createOrReplaceTempView("frames")
        session.createDataFrame([(k, f"class_{k}") for k in range(P18_LABELS)],
                                ["label", "name"]).createOrReplaceTempView("labels")
        batches0 = metrics.counter("serving.batches").value
        reset()
        t0 = time.perf_counter()
        scored = session.sql("SELECT id, label, vit_top(image) AS s FROM frames")
        scored_rows = scored.collect()
        score_s = time.perf_counter() - t0
        counts = read()
        served = metrics.counter("serving.batches").value - batches0
        scored.createOrReplaceTempView("scored")
        t0 = time.perf_counter()
        rows = session.sql(P18_BOUNDED).collect()
        query_s = time.perf_counter() - t0
        if list(counts.values()) != [blocks * served, 0, 0, 0]:
            raise AssertionError(f"(a) launches {counts}, expected {blocks} x {served} blocks")
        launches += counts["flash_attention_fwd"]
        if sorted(r["id"] for r in scored_rows) != list(range(len(images))):
            raise AssertionError("(a) the scored view lost or repeated rows")
        check_bf16_rows("(a) vit_top(image) scores",
                        np.array([r["s"] for r in sorted(scored_rows, key=lambda r: r["id"])]),
                        scores)
        err = 0.0
        for k, r in enumerate(rows):
            top = np.sort(scores[np.arange(len(images)) % P18_LABELS == k])[::-1][:P18_TOP_K]
            if (r["name"], r["n"], r["last_rank"]) != (f"class_{k}", P18_TOP_K, P18_TOP_K):
                raise AssertionError(f"(a) row {k}: {r}")
            err = max(err, abs(r["top"] - top.max()), abs(r["mean_top"] - top.mean()),
                      abs(r["kth"] - top.min()))
        if len(rows) != P18_LABELS or not np.isfinite(err) or err > bound:
            raise AssertionError(f"(a) {len(rows)} groups, aggregates off by {err}")
        log(f"csql (a): session.sql scored {len(scored_rows)} images through vit_top "
            f"({served:.0f} served blocks, launches {counts}) in {score_s:.3f} s = "
            f"{len(scored_rows) / score_s:.1f} rows/s; the JOIN / ROW_NUMBER() / GROUP BY / "
            f"HAVING / ORDER BY query {1e3 * query_s:.1f} ms: {P18_LABELS} groups of "
            f"{P18_TOP_K}, keys and counts exact, max/avg/min of each label's top "
            f"{P18_TOP_K} max_abs_err {err:.4e} against numpy over the float32 plain forward "
            f"(bound {bound:.4e}) ({card})")
        for view in ("frames", "scored", "labels"):
            session.catalog.dropTempView(view)

        # (b) a standing windowed query over the same images, traced
        src = QueueSource()
        late_ts = []
        for i, image in enumerate(images):
            src.put({"image": image, "label": labels[i], "ts": i * P18_TS_MS})
            if i in P18_LATE_AFTER:
                late_ts.append(P18_LATE_AFTER[i])
                src.put({"image": images[len(late_ts) - 1], "label": 0,
                         "ts": P18_LATE_AFTER[i]})
        src.end()
        session.readStream("frames", src)
        late0 = metrics.counter("csql.late_rows").value
        batches0 = metrics.counter("serving.batches").value
        spans = JsonlTraceSink(capacity=1 << 16)
        tracer.enable(spans)
        try:
            query = session.sqlStream(
                P18_QUERY.format(arg="image"), JsonlSink(str(tmp / "windows.jsonl")),
                str(tmp / "log"), late_sink=JsonlSink(str(tmp / "late.jsonl")), server=server,
                config=StreamConfig(max_batch=P18_STREAM_BATCH, max_wait_ms=5.0,
                                    poll_batch=64, poll_interval_ms=2.0))
            reset()
            t0 = time.perf_counter()
            try:
                summary = query.run()
            finally:
                query.close()
            wall = time.perf_counter() - t0
            counts = read()
        finally:
            tracer.disable()
            session.catalog.dropStreamTable("frames")
        served = metrics.counter("serving.batches").value - batches0
        if summary["stop_reason"] != "source_finished":
            raise AssertionError(f"(b) stopped by {summary['stop_reason']}")
        if list(counts.values()) != [blocks * served, 0, 0, 0]:
            raise AssertionError(f"(b) launches {counts}, expected {blocks} x {served} blocks")
        launches += counts["flash_attention_fwd"]
        emitted = sink_rows(tmp / "windows.jsonl")
        got = window_aggregates(emitted)
        if len(got) != len(emitted):
            raise AssertionError("(b) a window was emitted twice")
        ts = [i * P18_TS_MS for i in range(len(images))]
        check_windows("(b) emitted windows", got, expected_windows(scores, labels, ts), bound)
        late = sink_rows(tmp / "late.jsonl")
        late_rows = metrics.counter("csql.late_rows").value - late0
        if sorted(r["event_time_ms"] for r in late) != sorted(late_ts) or \
                late_rows != len(late_ts) or summary["late_rows"] != len(late_ts):
            raise AssertionError(f"(b) late rows: side output {len(late)}, csql.late_rows "
                                 f"{late_rows}, summary {summary['late_rows']}")
        names = {sp["name"] for sp in spans.spans()}
        missing = {"csql.query", "csql.window_close", "csql.recover"} - names
        if missing or spans.dropped:
            raise AssertionError(f"(b) spans missing {missing} (dropped {spans.dropped})")
        lat = metrics.snapshot("csql.emit_latency_ms")
        n_in = len(images) + len(late_ts)
        log(f"csql (b): standing query over {n_in} records ({len(late_ts)} late) in "
            f"{wall:.3f} s = {n_in / wall:.1f} records/s, {summary['epochs']} epochs, "
            f"{served:.0f} served blocks, csql.emit_latency_ms p50 "
            f"{lat['csql.emit_latency_ms.p50']:.2f} ms, p99 {lat['csql.emit_latency_ms.p99']:.2f} "
            f"ms; late rows {len(late)} in the side output and csql.late_rows; launches "
            f"{counts}; spans {len(spans.spans())} ({card})")
        server.close()
        if metrics.counter("serving.compiles").value != compiles or \
                metrics.timer("engine.compile").entries != engine_compiles:
            raise AssertionError("(a)/(b) compiled a program")

        # (c) exactly once on the card: worker processes, killed and restarted
        np.save(tmp / "images.npy", np.ascontiguousarray(images[:P18_WORKER_IMAGES]))
        records = [{"idx": i % P18_WORKER_IMAGES, "label": i % P18_LABELS,
                    "ts": i * P18_TS_MS} for i in range(P18_WORKER_RECORDS)]

        def workdir(name):
            path = tmp / name
            path.mkdir()
            os.link(tmp / "images.npy", path / "images.npy")
            with open(path / "in.jsonl", "w") as fh:
                fh.writelines(json.dumps(r) + "\n" for r in records)
            return path

        def worker(path, plan=None):
            env = dict(os.environ)
            env.pop("SPARKDL_FAULT_PLAN", None)
            if plan is not None:
                env["SPARKDL_FAULT_PLAN"] = json.dumps(plan)
            return WorkerRun(P18_WORKER.format(root=str(Path(__file__).resolve().parent),
                                               prelude=P14_CHILD_PRELUDE, workdir=str(path)),
                             env)

        def worker_result(label, proc):
            if proc.returncode != 0:
                raise AssertionError(f"(c) the {label} worker failed:\n{proc.stderr[-3000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            if out["launches"] != blocks * out["batches"]:
                raise AssertionError(f"(c) the {label} worker launched {out['launches']} for "
                                     f"{out['batches']} blocks")
            return out

        # the uninterrupted worker and the two killed run side by side; the
        # restart follows the kill at streaming.window_commit
        t_c = time.perf_counter()
        clean_dir, killed_dir, plan_dir = workdir("clean"), workdir("killed"), workdir("plan")
        clean_run = worker(clean_dir)
        killed_run = worker(killed_dir, [{"site": "streaming.window_commit", "kill": True,
                                          "at": P18_KILL_AT}])
        plan_run = worker(plan_dir, [{"site": "csql.plan", "kill": True, "at": 1}])
        proc, clean_s = clean_run.result()
        clean_out = worker_result("uninterrupted", proc)
        clean_rows = sink_rows(clean_dir / "out.jsonl")
        clean = window_aggregates(clean_rows)
        if len(clean) != len(clean_rows):
            raise AssertionError("(c) the uninterrupted run emitted a window twice")
        idx = [r["idx"] for r in records]
        check_windows("(c) uninterrupted worker", clean,
                      expected_windows(scores[idx], [r["label"] for r in records],
                                       [r["ts"] for r in records]), bound)
        proc, killed_s = killed_run.result()
        if proc.returncode != 9:
            raise AssertionError(f"(c) the killed worker exited {proc.returncode}, not 9:\n"
                                 f"{proc.stderr[-3000:]}")
        commit_log = CommitLog(str(killed_dir / "log"))
        pending = commit_log.pending()
        payloads = {e: commit_log.payload(e)["closed"] for e in pending}
        if not pending or not any(payloads.values()):
            raise AssertionError(f"(c) the kill left pending epochs {pending} with no windows")
        proc, restart_s = worker(killed_dir).result()
        restarted = worker_result("restarted", proc)["summary"]
        if restarted["replayed"] != len(pending) or commit_log.pending():
            raise AssertionError(f"(c) the restart replayed {restarted['replayed']} of "
                                 f"{len(pending)} pending epochs")
        rows = sink_rows(killed_dir / "out.jsonl")
        for epoch, recs in payloads.items():
            lines = [{k: v for k, v in r.items() if k != "epoch"} for r in rows
                     if r["epoch"] == epoch]
            if json.dumps(lines) != json.dumps(recs):
                raise AssertionError(f"(c) replayed epoch {epoch} differs from its payload")
        resumed = window_aggregates(rows)
        if len(resumed) != len(rows):
            raise AssertionError("(c) the restarted run emitted a window twice")
        check_windows("(c) killed and restarted worker", resumed, clean, bound)
        proc, plan_s = plan_run.result()
        if proc.returncode != 9:
            raise AssertionError(f"(c) the worker killed at csql.plan exited {proc.returncode}")
        left = sorted(p.name for p in plan_dir.iterdir())
        if left != ["images.npy", "in.jsonl"]:
            raise AssertionError(f"(c) the kill at csql.plan left {left}")
        log(f"csql (c): worker processes over {len(records)} FileTailSource records: "
            f"uninterrupted {clean_s:.1f} s ({clean_out['launches']} launches, "
            f"{clean_out['batches']:.0f} blocks), killed at streaming.window_commit "
            f"{P18_KILL_AT} (exit 9) {killed_s:.1f} s, restarted {restart_s:.1f} s replaying "
            f"epochs {sorted(payloads)} bit for bit from their payloads; killed at csql.plan "
            f"(exit 9) {plan_s:.1f} s, nothing left behind; (c) in all "
            f"{time.perf_counter() - t_c:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# phase 21: the fleet simulator on phase 16 (b)'s routed traffic, and the
# profiler through SPARKDL_PROFILE_DIR
# ---------------------------------------------------------------------------
# (a): the live fleet's knobs: two replicas of vit_replica_server, whose
# ServingConfig(max_batch=32, max_wait_ms=2.0) keeps the default queue of 256;
# the router's hedging and retry budget are at their defaults in both
P21_CONFIG = {"replicas": P16_REPLICAS, "max_batch": 32, "max_wait_ms": 2.0,
              "queue_capacity": 256}
P21_SEED = 0
P21_TUNE_BUDGET = 8
P21_IMAGES = 32          # (b): images a profiled transform, one batch ...
P21_BATCH = 32           # ... of this many
# (b): convolution kernels by name: cuDNN's and the implicit-GEMM kernels
# (xmma, cutlass) a convolution may run as
P21_CONV_KERNEL = re.compile(r"conv|cudnn|fprop|implicit|xmma|cutlass|winograd", re.I)
P21_FLASH_KERNEL = "flash_fwd_kernel"   # #1's __global__ in flash_attention_fwd.cu
P21_CHILD_TIMEOUT_S = 300.0


def fleet_replay(card: str, routed) -> None:
    """Phase 21 (a): phase 16 (b)'s routed requests as a trace (written with
    ``write_trace``, loaded back with ``load_trace``), replayed twice under
    the live fleet's knobs (``P21_CONFIG``) to the same event log, its
    fidelity against the live run printed (a reading, not a check), and
    ``tune`` twice to the same artifact."""
    import hashlib
    import os

    from sparkdl_tpu_torch.sim import (
        FleetReplay,
        fidelity_report,
        load_trace,
        summarize,
        write_trace,
    )
    from sparkdl_tpu_torch.sim.trace import EMERGENT_PHASES, REPLAYED_PHASES
    from sparkdl_tpu_torch.sim.tune import tune

    with tempfile.TemporaryDirectory(prefix="chip-smoke-sim-") as tmp:
        path = os.path.join(tmp, "routed_trace.jsonl")
        write_trace(path, {"benchmark": "chip_smoke phase 16 (b)", "replicas": P16_REPLICAS,
                           "threads": P16_THREADS, "live": summarize(routed)}, routed)
        meta, records = load_trace(path)
    if len(records) != P14_REQUESTS:
        raise AssertionError(f"(a) {len(records)} records of {P14_REQUESTS} routed requests")
    no_forward = [r.to_json() for r in records if not r.phases.get("forward", 0.0) > 0.0]
    if no_forward:
        raise AssertionError(f"(a) {len(no_forward)} records without a forward phase, e.g. "
                             f"{no_forward[0]}")
    names = {name for r in records for name in r.phases}
    unknown = names - set(REPLAYED_PHASES) - set(EMERGENT_PHASES)
    if unknown:
        raise AssertionError(f"(a) phases the simulator does not know: {sorted(unknown)}")
    log(f"sim (a): {len(records)} records from phase 16 (b)'s router.request spans, "
        f"phases {sorted(names)}; outcomes "
        f"{sorted({r.outcome for r in records})}")

    runs = []
    for _ in range(2):
        replay = FleetReplay(records, config=P21_CONFIG, seed=P21_SEED)
        runs.append((replay, replay.run()))
    (first, report), (second, _) = runs
    log_bytes = first.event_log_bytes()
    if second.event_log_bytes() != log_bytes:
        raise AssertionError("(a) two replays of one trace and seed gave different event logs")
    times = [row["t"] for row in first.event_log]
    if any(b < a for a, b in zip(times, times[1:])):
        raise AssertionError("(a) the event log's times decrease")
    if report["requests"] != len(records):
        raise AssertionError(f"(a) the replay counted {report['requests']} requests")
    if report["ok"] + report["shed"] + report["expired"] > report["requests"]:
        raise AssertionError(f"(a) ok {report['ok']} + shed {report['shed']} + expired "
                             f"{report['expired']} > {report['requests']} requests")
    log(f"sim (a): two replays, one event log: sha256 "
        f"{hashlib.sha256(log_bytes).hexdigest()}, {len(first.event_log)} events "
        f"({report['events']} handled), {len(log_bytes)} bytes; requests {report['requests']}, "
        f"ok {report['ok']}, shed {report['shed']}, expired {report['expired']}; virtual "
        f"{report['virtual_s']} s in wall {report['wall_s']} s, ratio {report['speedup']} "
        f"(the card's host CPU)")
    fidelity = fidelity_report(meta["live"], report, tolerance=0.15, floor_ms=0.25)
    rows = fidelity["rows"]
    passed = sum(1 for row in rows.values() if row["ok"])
    log(f"sim (a): fidelity, live (phase 16 (b), {P16_THREADS} threads closed loop, "
        f"{card}) against replayed (open loop), bound 15% or 0.25 ms: {passed} of "
        f"{len(rows)} rows pass")
    for label, row in rows.items():
        log(f"  {label}: live {row['live']} ms, replayed {row['sim']} ms, bound "
            f"{row['bound']} ms, {'ok' if row['ok'] else 'miss'}")

    artifacts = [tune(records, budget=P21_TUNE_BUDGET, seed=P21_SEED) for _ in range(2)]
    texts = [json.dumps(a, sort_keys=True) for a in artifacts]
    if texts[0] != texts[1]:
        raise AssertionError("(a) two tune() runs gave different artifacts")
    art = artifacts[0]
    rec, default = art["recommended"], art["default"]
    log(f"sim (a): tune(budget={P21_TUNE_BUDGET}, seed={P21_SEED}, stress "
        f"{art['time_scale']}x) twice, one artifact (sha256 "
        f"{hashlib.sha256(texts[0].encode()).hexdigest()[:16]}, {len(art['trials'])} "
        f"trials): recommended {rec['config']}, burn {rec['burn_integral']} (score "
        f"{rec['score']}, p99 {rec['p99_ms']} ms) against the default's "
        f"{default['burn_integral']} (score {default['score']}, p99 "
        f"{default['p99_ms']} ms)")


def kernel_events(log_dir: str, label: str) -> list:
    """The CUDA kernel events of the one ``*.pt.trace.json`` under
    ``log_dir``; raises if there is none, or no kernel event."""
    traces = sorted(Path(log_dir).rglob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"(b) {label}: {len(traces)} traces in {log_dir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"(b) {label}: the trace holds no CUDA kernel events (CUPTI "
                             f"gave none); categories "
                             f"{sorted({str(e.get('cat')) for e in events})}")
    return kernels


def kernel_summary(kernels) -> str:
    """Count, summed time and the five costliest kernels by summed time."""
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    total_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"{len(kernels)} kernel events, {total_ms:.3f} ms of kernel time; costliest: "
            + "; ".join(f"{name[:90]} {us / 1e3:.3f} ms" for name, us in top))


def profiled_transforms(card: str, counted) -> dict:
    """Phase 21 (b): ``SPARKDL_PROFILE_DIR`` set to a fresh directory for a
    transform of 32 images through the bf16 InceptionV3
    ``DeepImageFeaturizer``, then to another for 32 images through the bf16
    flash ViT-B/16 ``TorchImageFileTransformer`` (both with seeded random
    weights: the readings are the traces); each stage is run once
    unprofiled first, and the profiled rows must equal those bit for bit.
    Returns the launches of the four kernels over (b)."""
    import os

    import torch

    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.sql.session import TorchSession

    reset_counts, counts = counted
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        modelWeights="random", computeDtype="bfloat16", batchSize=P21_BATCH)
    cnn_df = session.createDataFrame(cnn_image_rows(P21_IMAGES, seed=21), numPartitions=1)
    torch.manual_seed(21)
    vit_stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="features", imageLoader=load_npy,
        module=ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash",
                   dtype=torch.bfloat16),
        batchSize=P21_BATCH)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-profile-") as tmp:
        rng = np.random.default_rng(21)
        uris = []
        for i in range(P21_IMAGES):
            uris.append(os.path.join(tmp, f"img_{i:02d}.npy"))
            np.save(uris[-1], rng.random((224, 224, 3), dtype=np.float32))
        vit_df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
        reset_counts()
        for label, stage, df, classes in (("featurizer", featurizer, cnn_df, 2048),
                                          ("vit", vit_stage, vit_df, N_CLASSES)):
            plain = rows_array(stage.transform(df).collect())
            before = counts()
            log_dir = os.path.join(tmp, f"trace_{label}")
            t0 = time.perf_counter()
            with scoped_env(SPARKDL_PROFILE_DIR=log_dir):
                traced = rows_array(stage.transform(df).collect())
            traced_s = time.perf_counter() - t0
            during = {k: v - before[k] for k, v in counts().items()}
            if traced.shape != (P21_IMAGES, classes) or not np.isfinite(traced).all():
                raise AssertionError(f"(b) {label}: rows of shape {traced.shape}")
            if not np.array_equal(traced, plain):
                raise AssertionError(f"(b) {label}: the profiled rows differ from the "
                                     f"unprofiled ones by {np.abs(traced - plain).max():.3e}")
            kernels = kernel_events(log_dir, label)
            flash = [e for e in kernels if P21_FLASH_KERNEL in e["name"]]
            conv = [e for e in kernels if P21_CONV_KERNEL.search(e["name"])]
            if label == "vit":
                want = during["flash_attention_fwd"]
                if want != 12 * (P21_IMAGES // P21_BATCH) or len(flash) != want:
                    raise AssertionError(f"(b) the ViT trace holds {len(flash)} {P21_FLASH_KERNEL} "
                                         f"events; the wrapper counted {during}")
            else:
                if flash or any(during.values()):
                    raise AssertionError(f"(b) the featurizer's trace holds {len(flash)} flash "
                                         f"kernels; the wrappers counted {during}")
                if not conv:
                    raise AssertionError("(b) the featurizer's trace holds no convolution "
                                         "kernel: " + kernel_summary(kernels))
            log(f"profile (b) {label}: {P21_IMAGES} images under SPARKDL_PROFILE_DIR in "
                f"{traced_s:.2f} s, rows bit for bit the unprofiled ones; "
                + kernel_summary(kernels)
                + f"; {len(flash)} {P21_FLASH_KERNEL} events (the wrapper counted "
                f"{during['flash_attention_fwd']}), {len(conv)} convolution kernels ({card})")
    return counts()


def profiler_child() -> int:
    """Phase 21 (b), in a process of its own: :func:`profiled_transforms`.
    Prints ``PHASE21_LAUNCHES {...}``."""
    host_build_env()
    import torch

    if not import_package():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
        FLASH_FWD_LSE,
    )

    kernels = (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {k.symbol + ("+lse" if k is FLASH_FWD_LSE else ""): k.launches for k in kernels}

    launches = profiled_transforms(card_line(), (reset, counts))
    print("PHASE21_LAUNCHES " + json.dumps(launches), flush=True)
    return 0


def sim_and_profiler(card: str, routed) -> dict:
    """Phase 21: (a) :func:`fleet_replay`, (b) :func:`profiler_child` in a
    fresh process. A capture late in a long process loses its first kernels
    (the profiler places the card's events before the capture's start as
    the process ages: PERF.md §6), so (b) captures in a process of
    its own, as a user who wants every kernel would. Returns (b)'s
    launches."""
    t0 = time.perf_counter()
    fleet_replay(card, routed)
    launches = child_launches("profiler_child", "PHASE21_LAUNCHES", P21_CHILD_TIMEOUT_S)
    log(f"sim and profiler: phase 21 in {time.perf_counter() - t0:.1f} s, launches "
        f"{launches} ({card})")
    return launches


def import_package() -> bool:
    """Phase 1's first check: the port's package imports from beside this
    script. Says so plainly, naming the package and the directory, if not."""
    here = Path(__file__).resolve().parent
    if str(here) not in sys.path:
        sys.path.insert(0, str(here))
    try:
        import sparkdl_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the package sparkdl_tpu_torch from {here} "
              f"({exc}); run this script from the repository's tree, where "
              f"sparkdl_tpu_torch/ lies beside it", file=sys.stderr)
        return False
    return True


def start_cpu_isa_probes():
    """A process's first AOTInductor load asks Inductor which vector
    instruction sets the CPU has (``pick_vec_isa``): it builds a probe for
    each of a few and loads it in a Python process that imports torch, ~25 s
    on the card's host, and keeps the answer for the process. This asks on
    a thread, which mostly waits for those processes, so that the probes run
    beside phases 7-12 and not in phase 14's first load. Returns the thread;
    its ``seconds`` is set when it has asked."""
    import threading

    import torch._inductor.cpu_vec_isa as cpu_vec_isa

    def probe():
        t0 = time.perf_counter()
        cpu_vec_isa.pick_vec_isa()
        thread.seconds = time.perf_counter() - t0

    thread = threading.Thread(target=probe, name="cpu-isa-probes", daemon=True)
    thread.seconds = None
    thread.start()
    return thread


def host_build_env() -> str:
    """The environment of this script's own AOTInductor builds and loads,
    set for it and the processes it starts, before torch is imported
    (Inductor reads these variables when its config is imported):

    - ``CXX``: a package's C++ must link OpenMP, and a ``CXX`` that is a
      wrapper with search paths of its own may not find OpenMP's link
      spec, so the script builds with the ``g++`` on ``PATH``, the host
      compiler ``nvcc`` takes;
    - ``TORCHINDUCTOR_VEC_ISA_OK=1``: the first compile or load in a
      process probes the CPU's vector instruction sets by starting a
      Python process that imports torch for each; the variable trusts the
      CPU's flags for most of them, which pays where starting torch is
      slow (a check or two that does not read it still probes);
    - ``TORCHINDUCTOR_COMPILE_THREADS=1``: each compiling process compiles
      its Triton kernels itself instead of starting a pool of workers, each
      of which imports torch; on the card's host that takes a compile of
      phase 14's programs less CPU at about the same wall time
      (``chip_compile_cost.py``), and the script's compiling processes run
      beside each other and beside card work, so CPU is what they share.

    Returns a line that says what was set."""
    import os
    import shutil

    before = os.environ.get("CXX")
    gxx = shutil.which("g++")
    if gxx is not None:
        os.environ["CXX"] = gxx
    os.environ.setdefault("TORCHINDUCTOR_VEC_ISA_OK", "1")
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    return (f"host build environment: CXX={os.environ.get('CXX')!r} (was {before!r}), "
            f"TORCHINDUCTOR_VEC_ISA_OK={os.environ['TORCHINDUCTOR_VEC_ISA_OK']}, "
            f"TORCHINDUCTOR_COMPILE_THREADS={os.environ['TORCHINDUCTOR_COMPILE_THREADS']}")


def main() -> int:
    compiler = host_build_env()
    import torch

    # phase 1: the package, the device
    if not import_package():
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(compiler)

    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
        FLASH_FWD_LSE,
        attention_delta,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step
    from sparkdl_tpu_torch.estimators.losses import get_optimizer
    from sparkdl_tpu_torch.utils.metrics import metrics

    kernels = (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)

    def reset_counts():
        for kernel in kernels:
            kernel.launches = 0

    def counts():
        return {k.symbol + ("+lse" if k is FLASH_FWD_LSE else ""): k.launches
                for k in kernels}

    # phase 2: build, one nvcc per source, all started together; the
    # launchers then load the libraries from the build directory
    from sparkdl_tpu_torch.ops.cuda_build import build_library, ptxas_usage, sass_opcodes

    t0 = time.perf_counter()
    sources = sorted({kernel.source for kernel in kernels})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(build_library, sources))
    for kernel in kernels:
        kernel.build()
    log(f"build: {', '.join(src.name for src in sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    # registers and spills from nvcc's -Xptxas -v (empty for a cached
    # build), tensor-core products and cp.async copies from the SASS
    found = set()
    for library, build_log in built:
        usage = ptxas_usage(build_log)
        opcodes = sass_opcodes(library, ("HMMA", "LDGSTS", ""))
        found.update(opcodes)
        for kname in sorted(opcodes):
            u = usage.get(kname, {})
            log(f"  {kname}: {u.get('registers', '?')} registers, spill stores/loads "
                f"{u.get('spill_stores', '?')}/{u.get('spill_loads', '?')} bytes; "
                f"SASS HMMA {opcodes[kname]['HMMA']}, LDGSTS {opcodes[kname]['LDGSTS']} "
                f"of {opcodes[kname]['']} instructions")
            if kname.startswith(("flash_fwd_", "flash_bwd_")):
                if not (opcodes[kname]["HMMA"] and opcodes[kname]["LDGSTS"]):
                    raise AssertionError(f"{kname}: no tensor-core products or cp.async copies")
                if kname.endswith(",64>") and u.get("spill_stores", 0) + u.get("spill_loads", 0):
                    raise AssertionError(f"{kname} spills at head_dim 64: {u}")
    for kname in (f"{k}<{t},64>" for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                           "flash_bwd_dkv_kernel")
                  for t in ("f32", "bf16")):
        if kname not in found:
            raise AssertionError(f"no {kname} in the built libraries")

    # phase 3: kernel vs plain (forward f32 2e-4 and gradients f32 1e-3 as
    # tests/test_ops.py; bf16 forward 2e-2, bf16 gradients 8e-3 relative)
    test_shapes = [
        ((2, 197, 3, 64), {}), ((1, 128, 2, 32), {}), ((2, 300, 4, 128), {}),
        ((1, 197, 2, 64), {"causal": True}), ((1, 256, 2, 64), {"kv_len": 200}),
    ]
    log("kernel vs plain (flash_attention_fwd, with and without lse):")
    fwd_err, lse_err = check_kernel(VIT_SHAPE, torch.float32, {}, seed=0)
    check_kernel(VIT_SHAPE, torch.bfloat16, {}, seed=1)
    for shape, kwargs in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(shape, dtype, kwargs, seed=2)
    log("kernel vs plain (flash_attention_bwd_dq, flash_attention_bwd_dkv):")
    dq_err, dk_err, dv_err = check_backward(VIT_SHAPE, torch.float32, {}, seed=0)
    check_backward(VIT_SHAPE, torch.bfloat16, {}, seed=1)
    for shape, kwargs in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            check_backward(shape, dtype, kwargs, seed=3)
    log(f"split TF32 vs single TF32 (forward kernel, inputs x4, {VIT_SHAPE} float32):")
    check_split_tf32_forward(VIT_SHAPE, seed=5)
    log(f"split TF32 vs single TF32 (backward kernels, inputs x4, {VIT_SHAPE} float32):")
    check_split_tf32(VIT_SHAPE, seed=5)
    log(f"against a float64 forward ({VIT_SHAPE} float32 inputs):")
    forward_float64_errors(VIT_SHAPE, seed=6)
    log(f"against a float64 backward ({VIT_SHAPE} float32 inputs):")
    float64_errors(VIT_SHAPE, seed=6)

    # phase 4: the inference slice, ViT-B/16 at full width
    state = vit_state_dict_from_flax(flax_layout_vit_params(seed=0))
    train_params = flax_layout_vit_params(seed=2, classes=N_CLASSES)
    train_state = vit_state_dict_from_flax(train_params)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        image_dir = Path(tmp)
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(image_dir / f"img_{i:03d}.npy",
                    rng.random((224, 224, 3), dtype=np.float32))

        flash_stage, df = run_slice(image_dir, state, "flash", "cuda")
        reset_counts()
        t0 = time.perf_counter()
        flash_rows = flash_stage.transform(df).collect()
        first_s = time.perf_counter() - t0
        serve_counts = counts()
        expected = 12 * (N_IMAGES // BATCH)
        log(f"slice: {len(flash_rows)} rows, launches {serve_counts} "
            f"(expected {expected} lse-free: 12 blocks x {N_IMAGES // BATCH} batches), "
            f"first transform {first_s:.2f} s")
        if list(serve_counts.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"inference launches {serve_counts}")
        flash = rows_array(flash_rows)
        if flash.shape != (N_IMAGES, 1000) or not np.isfinite(flash).all():
            raise AssertionError(f"bad slice output: shape {flash.shape}")

        full_stage, full_df = run_slice(image_dir, state, "full", "cuda")
        full = rows_array(full_stage.transform(full_df).collect())
        np.testing.assert_allclose(flash, full, **SLICE_TOL)
        log(f"  flash vs full on the card: max_abs_err={np.abs(flash - full).max():.3e}")

        uris = [r["uri"] for r in flash_rows]
        cpu_stage, cpu_df = run_slice(image_dir, state, "full", "cpu", uris=uris[:2])
        cpu = rows_array(cpu_stage.transform(cpu_df).collect())
        np.testing.assert_allclose(flash[:2], cpu, **SLICE_TOL)
        log(f"  flash on the card vs full on the CPU (2 images): "
            f"max_abs_err={np.abs(flash[:2] - cpu).max():.3e}")

        # slice throughput, steady state (weights resident, kernel built):
        # host wall time per transform, and the loop's own metrics
        walls = []
        metrics.reset()
        for _ in range(5):
            t0 = time.perf_counter()
            flash_stage.transform(df).collect()
            walls.append(time.perf_counter() - t0)
        log(f"slice images/s (ViT-B/16, batch {BATCH}, {N_IMAGES} images, {card}): "
            + ", ".join(f"{N_IMAGES / w:.1f}" for w in walls)
            + f"; median {N_IMAGES / float(np.median(walls)):.1f}"
            + f"; sparkdl.serve rate {metrics.images_per_sec():.1f}")
        log("  " + ", ".join(f"{k}={v:.4f}" for k, v in
                             sorted(metrics.snapshot("sparkdl.").items())))

        # the same slice in bfloat16, through the bf16 forward kernel
        bf16_stage, _ = run_slice(image_dir, state, "flash", "cuda", dtype=torch.bfloat16)
        reset_counts()
        t0 = time.perf_counter()
        bf16 = rows_array(bf16_stage.transform(df).collect())
        bf16_first_s = time.perf_counter() - t0
        bf16_counts = counts()
        log(f"slice in bfloat16: {len(bf16)} rows, launches {bf16_counts} (expected "
            f"{expected} lse-free), first transform {bf16_first_s:.2f} s")
        if list(bf16_counts.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"bf16 inference launches {bf16_counts}")
        if bf16.shape != (N_IMAGES, 1000) or not np.isfinite(bf16).all():
            raise AssertionError(f"bad bf16 slice output: shape {bf16.shape}")
        full_bf16_stage, _ = run_slice(image_dir, state, "full", "cuda", dtype=torch.bfloat16)
        full_bf16 = rows_array(full_bf16_stage.transform(df).collect())
        np.testing.assert_allclose(bf16, full_bf16, **BF16_SLICE_TOL)
        log(f"  bf16 flash vs bf16 full on the card: "
            f"max_abs_err={np.abs(bf16 - full_bf16).max():.3e}; bf16 flash vs f32 "
            f"flash max_abs_err={np.abs(bf16 - flash).max():.3e}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            bf16_stage.transform(df).collect()
            walls.append(time.perf_counter() - t0)
        log(f"slice images/s in bfloat16 (ViT-B/16, batch {BATCH}, {N_IMAGES} images, "
            f"{card}): " + ", ".join(f"{N_IMAGES / w:.1f}" for w in walls))

        # the model forward alone, on one resident batch
        images = np.stack([load_npy(u) for u in uris])
        x = torch.from_numpy(images[:BATCH]).cuda()
        with torch.inference_mode():
            forward_ms = {
                impl: time_ms(lambda m=stage.module: m(x), iters=10)
                for impl, stage in (("flash", flash_stage), ("full", full_stage),
                                    ("flash_bf16", bf16_stage),
                                    ("full_bf16", full_bf16_stage))
            }
        del flash_stage, full_stage, cpu_stage, bf16_stage, full_bf16_stage

        # phase 5: the training slice, ViT-B/16 at full width, 10 classes
        labels = np.arange(N_IMAGES) % N_CLASSES
        train_df = training_df(uris)
        steps = 2 * (N_IMAGES // BATCH)

        # the first step's batch, as fit draws it, through flash and dense
        first = np.random.RandomState(0).permutation(N_IMAGES)[:BATCH]
        xb = torch.from_numpy(images[first]).cuda()
        yb = torch.from_numpy(labels[first]).cuda()
        flash_loss0, flash_grads = first_step_grads(train_state, "flash", xb, yb)
        full_loss0, full_grads = first_step_grads(train_state, "full", xb, yb)
        norms = {n: g.norm().item() for n, g in full_grads.items()}
        floor = 1e-3 * max(norms.values())
        grad_err = max((flash_grads[n] - g).norm().item() / max(norms[n], floor)
                       for n, g in full_grads.items())
        log(f"training: first-step gradients flash vs full on the card, largest "
            f"relative norm error {grad_err:.3e} (floor {floor:.3e}); loss "
            f"{flash_loss0:.6f} vs {full_loss0:.6f}")
        if grad_err > GRAD_NORM_RTOL:
            raise AssertionError(f"first-step gradients differ by {grad_err:.3e}")
        del flash_grads, full_grads

        caller_module = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash")
        before = {n: t.clone() for n, t in caller_module.state_dict().items()}
        estimator = train_estimator(caller_module, train_params)
        reset_counts()
        t0 = time.perf_counter()
        fitted = estimator.fit(train_df)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        fit_counts = counts()
        expected = 12 * steps
        log(f"training: fit of {steps} steps, launches {fit_counts} (expected "
            f"{expected} with lse, dQ and dK/dV: 12 blocks x {steps} steps; "
            f"0 lse-free), first fit {first_fit_s:.2f} s")
        if list(fit_counts.values()) != [0, expected, expected, expected]:
            raise AssertionError(f"training launches {fit_counts}")
        for n, t in caller_module.state_dict().items():
            if not torch.equal(t, before[n]):
                raise AssertionError(f"fit changed the caller's module: {n}")

        full_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="full"),
            train_params,
        ).fit(train_df)
        losses = np.array(fitted._training_losses)
        full_losses = np.array(full_fit._training_losses)
        log(f"  losses flash {losses.tolist()} vs full {full_losses.tolist()}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"bad training losses {losses}")
        np.testing.assert_allclose(losses, full_losses, rtol=LOSS_RTOL)
        adam_diff, adam_leaf = check_adam_step(
            fitted.module.state_dict(), full_fit.module.state_dict(), train_state, steps
        )
        log(f"  weights flash vs full after {steps} adam steps: largest "
            f"difference {adam_diff:.3e}; worst leaf change error "
            f"{adam_leaf[0]:.3e} ({adam_leaf[1]})")
        del full_fit

        reset_counts()
        tuned_rows = rows_array(fitted.transform(df).collect())
        tuned_counts = counts()
        log(f"  fitted transformer: {len(tuned_rows)} rows, launches {tuned_counts}")
        # the fitted transformer batches at the default transform batch size
        from sparkdl_tpu_torch.transformers.utils import DEFAULT_BATCH_SIZE

        if list(tuned_counts.values()) != [12 * -(-N_IMAGES // DEFAULT_BATCH_SIZE), 0, 0, 0]:
            raise AssertionError(f"fitted transform launches {tuned_counts}")
        if tuned_rows.shape != (N_IMAGES, N_CLASSES) or not np.isfinite(tuned_rows).all():
            raise AssertionError(f"bad fitted rows: shape {tuned_rows.shape}")

        # one step at 2 images, on the card and on the CPU
        small_df = training_df(uris[:2])
        small = {"fitParams": {"epochs": 1, "batch_size": 2,
                               "learning_rate": TRAIN_LR, "seed": 0}}
        card_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash"),
            train_params, **small,
        ).fit(small_df)
        cpu_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash"),
            train_params, device="cpu", **small,
        ).fit(small_df)
        np.testing.assert_allclose(card_fit._training_losses,
                                   cpu_fit._training_losses, rtol=LOSS_RTOL)
        cpu_diff, cpu_leaf = check_adam_step(
            card_fit.module.state_dict(), cpu_fit.module.state_dict(), train_state, 1
        )
        card_rows = rows_array(card_fit.transform(small_df).collect())
        cpu_rows = rows_array(cpu_fit.transform(small_df).collect())
        np.testing.assert_allclose(card_rows, cpu_rows, **SLICE_TOL)
        log(f"  one step at 2 images, card vs CPU: loss {card_fit._training_losses} "
            f"vs {cpu_fit._training_losses}; weights largest difference "
            f"{cpu_diff:.3e}, worst leaf change error {cpu_leaf[0]:.3e} "
            f"({cpu_leaf[1]}); rows "
            f"max_abs_err={np.abs(card_rows - cpu_rows).max():.3e}")
        del card_fit, cpu_fit

        # a fit with the defaults (weights drawn from the seed) leaves the
        # caller's module as it was
        default_module = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash")
        before = {n: t.clone() for n, t in default_module.state_dict().items()}
        from sparkdl_tpu_torch.estimators import TorchImageFileEstimator

        TorchImageFileEstimator(
            inputCol="uri", outputCol="features", labelCol="label",
            imageLoader=load_npy, module=default_module,
        ).fit(train_df)
        for n, t in default_module.state_dict().items():
            if not torch.equal(t, before[n]):
                raise AssertionError(f"a default fit changed the caller's module: {n}")
        log("  a fit with the defaults left the caller's module unchanged")

        # training images/s, steady state: a second fit
        metrics.reset()
        t0 = time.perf_counter()
        estimator.fit(train_df)
        fit_s = time.perf_counter() - t0
        step_s = metrics.timer("estimator.step").seconds
        n_steps = metrics.counter("estimator.steps").value
        log(f"training images/s (ViT-B/16, adam, batch {BATCH}, {steps} steps, {card}): "
            f"fit {2 * N_IMAGES / fit_s:.1f} ({fit_s:.3f} s, loading and copies "
            f"included); estimator.step {n_steps * BATCH / step_s:.1f} "
            f"({int(n_steps)} steps, {1e3 * step_s / n_steps:.3f} ms each)")

        # the training step alone, on one resident batch
        step_ms = {}
        for impl in ("flash", "full"):
            model = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl=impl)
            model.load_state_dict(train_state, strict=True)
            model.cuda().train()
            train = init_train_state(model, get_optimizer("adam", TRAIN_LR))
            step = make_train_step(ce_per_sample)
            batch = {"x": xb, "y": yb, "w": torch.ones(BATCH, device="cuda")}
            step_ms[impl] = time_ms(lambda: step(train, batch), iters=5, warmup=2)
            del model, train

    # phase 6: timing at the main path's shape (f32, q/k/v views of one qkv)
    records = []
    q, k, v = qkv_views(VIT_SHAPE, torch.float32, seed=0)
    b, s, h, d = VIT_SHAPE
    scale = d ** -0.5
    ms = time_ms(lambda: flash_attention(q, k, v), iters=20)
    lse_ms = time_ms(lambda: flash_attention(q, k, v, return_lse=True), iters=20)
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: sdpa(qt, kt, vt), iters=20)
    # the least time: f32 work as split TF32 on the tensor cores, as the
    # kernels do it; beside it the bound on the CUDA cores (67 TFLOP/s f32)
    bound_ms, bound_by = attention_bound_ms(VIT_SHAPE, "float32", rate="split_tf32")
    core_bound_ms = attention_bound_ms(VIT_SHAPE, "float32")[0]
    log(f"forward timing at {VIT_SHAPE} float32 ({card}): kernel {ms:.4f} ms "
        f"(with lse {lse_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms split TF32 ({bound_by}; {core_bound_ms:.4f} ms CUDA cores)")
    log(f"ViT-B/16 forward at batch {BATCH} float32 ({card}): "
        f"flash {forward_ms['flash']:.3f} ms, full {forward_ms['full']:.3f} ms; "
        f"12 kernel launches {12 * ms:.3f} ms = "
        f"{100 * 12 * ms / forward_ms['flash']:.1f}% of the flash forward")
    qb, kb, vb = qkv_views(VIT_SHAPE, torch.bfloat16, seed=1)
    bf16_ms = time_ms(lambda: flash_attention(qb, kb, vb), iters=20)
    bf16_lse_ms = time_ms(lambda: flash_attention(qb, kb, vb, return_lse=True), iters=20)
    qbt, kbt, vbt = (t.transpose(1, 2) for t in (qb, kb, vb))
    bf16_library_ms = time_ms(lambda: sdpa(qbt, kbt, vbt), iters=20)
    bf16_bound, bf16_by = attention_bound_ms(VIT_SHAPE, "bfloat16")
    log(f"forward timing at {VIT_SHAPE} bfloat16 ({card}): kernel {bf16_ms:.4f} ms "
        f"(with lse {bf16_lse_ms:.4f} ms), scaled_dot_product_attention "
        f"{bf16_library_ms:.4f} ms, bound {bf16_bound:.4f} ms ({bf16_by})")
    bf16_share = 12 * bf16_ms / forward_ms["flash_bf16"]
    log(f"ViT-B/16 forward at batch {BATCH} bfloat16 ({card}): "
        f"flash {forward_ms['flash_bf16']:.3f} ms, full {forward_ms['full_bf16']:.3f} ms; "
        f"12 kernel launches {12 * bf16_ms:.3f} ms = {100 * bf16_share:.1f}% of the "
        f"flash forward")

    out, lse = flash_attention(q, k, v, return_lse=True)
    do = cotangent(VIT_SHAPE, torch.float32, seed=0)
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta, False, scale, s)
    dq_ms = time_ms(lambda: flash_attention_bwd_dq(*args), iters=20)
    dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(*args), iters=20)
    delta_ms = time_ms(lambda: attention_delta(out, do), iters=20)
    bwd_plain_ms = time_ms(
        lambda: flash_attention_bwd_reference(q, k, v, out, lse, do), iters=5
    )
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    flash_out = flash_attention(*leaves)
    bwd_ms = time_ms(
        lambda: torch.autograd.grad(flash_out, leaves, do, retain_graph=True), iters=20
    )
    t_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    sdpa_out = sdpa(*t_leaves)
    do_t = do.transpose(1, 2)
    bwd_library_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out, t_leaves, do_t, retain_graph=True), iters=20
    )
    dq_bound, dq_by = attention_bound_ms(VIT_SHAPE, "float32", 3, 5, 2, "split_tf32")
    dkv_bound, dkv_by = attention_bound_ms(VIT_SHAPE, "float32", 4, 6, 2, "split_tf32")
    dq_core = attention_bound_ms(VIT_SHAPE, "float32", 3, 5, 2)[0]
    dkv_core = attention_bound_ms(VIT_SHAPE, "float32", 4, 6, 2)[0]
    log(f"backward timing at {VIT_SHAPE} float32 ({card}): dQ kernel {dq_ms:.4f} ms "
        f"(bound {dq_bound:.4f} ms split TF32, {dq_by}; {dq_core:.4f} ms CUDA cores), "
        f"dK/dV kernel {dkv_ms:.4f} ms (bound {dkv_bound:.4f} ms split TF32, {dkv_by}; "
        f"{dkv_core:.4f} ms CUDA cores), delta {delta_ms:.4f} ms; "
        f"backward through autograd {bwd_ms:.4f} ms vs scaled_dot_product_attention's "
        f"backward {bwd_library_ms:.4f} ms; plain backward {bwd_plain_ms:.4f} ms")
    ob, lseb = flash_attention(qb, kb, vb, return_lse=True)
    dob = cotangent(VIT_SHAPE, torch.bfloat16, seed=1)
    bf16_args = (qb, kb, vb, dob, lseb, attention_delta(ob, dob), False, scale, s)
    dq_bf16 = time_ms(lambda: flash_attention_bwd_dq(*bf16_args), iters=20)
    dkv_bf16 = time_ms(lambda: flash_attention_bwd_dkv(*bf16_args), iters=20)
    leaves_bf16 = [t.detach().requires_grad_() for t in (qb, kb, vb)]
    flash_out_bf16 = flash_attention(*leaves_bf16)
    bwd_bf16_ms = time_ms(
        lambda: torch.autograd.grad(flash_out_bf16, leaves_bf16, dob, retain_graph=True),
        iters=20,
    )
    t_leaves_bf16 = [t.detach().transpose(1, 2).requires_grad_() for t in (qb, kb, vb)]
    sdpa_out_bf16 = sdpa(*t_leaves_bf16)
    dob_t = dob.transpose(1, 2)
    bwd_library_bf16_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out_bf16, t_leaves_bf16, dob_t, retain_graph=True),
        iters=20,
    )
    log(f"backward timing at {VIT_SHAPE} bfloat16 ({card}): dQ {dq_bf16:.4f} ms "
        f"(bound {attention_bound_ms(VIT_SHAPE, 'bfloat16', 3, 5, 2)[0]:.4f} ms), "
        f"dK/dV {dkv_bf16:.4f} ms "
        f"(bound {attention_bound_ms(VIT_SHAPE, 'bfloat16', 4, 6, 2)[0]:.4f} ms); "
        f"backward through autograd {bwd_bf16_ms:.4f} ms vs "
        f"scaled_dot_product_attention's backward {bwd_library_bf16_ms:.4f} ms")
    kernel_ms = 12 * (lse_ms + dq_ms + dkv_ms)
    log(f"ViT-B/16 training step at batch {BATCH} float32, adam ({card}): flash "
        f"{step_ms['flash']:.3f} ms, full {step_ms['full']:.3f} ms; 12 x (forward "
        f"with lse + dQ + dK/dV) = {kernel_ms:.3f} ms = "
        f"{100 * kernel_ms / step_ms['flash']:.1f}% of the flash step")

    source = "sparkdl_tpu_torch/ops/csrc/flash_attention_{}.cu"
    common = {"route": "cuda"}
    # bound_ms: split TF32 on the tensor cores, as the kernels compute;
    # cuda_core_bound_ms: the same work on the CUDA cores; bf16_ms and
    # bf16_library_ms: the kernel and the library call on bf16 inputs
    records.append({
        "name": "flash_attention_fwd", **common, "source": source.format("fwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:284",
        # the lse-free launches: inference (f32 and bf16), the fitted
        # transform, and phase 9's ViT function (in memory and loaded)
        "launches": (serve_counts["flash_attention_fwd"] + bf16_counts["flash_attention_fwd"]
                     + tuned_counts["flash_attention_fwd"]),
        "max_abs_err": fwd_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "cuda_core_bound_ms": core_bound_ms,
        "library_ms": library_ms, "bf16_ms": bf16_ms, "bf16_library_ms": bf16_library_ms,
    })
    records.append({
        "name": "flash_attention_fwd_lse", **common, "source": source.format("fwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:259",
        "launches": fit_counts["flash_attention_fwd+lse"],
        "max_abs_err": max(fwd_err, lse_err), "ms": lse_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "cuda_core_bound_ms": core_bound_ms,
        "library_ms": library_ms, "bf16_ms": bf16_lse_ms, "bf16_library_ms": bf16_library_ms,
    })
    # no single library call computes dQ or dK/dV alone: library_ms is the
    # backward of scaled_dot_product_attention, set against dQ + dK/dV + delta
    # (the line above); plain_ms is flash_attention_bwd_reference, which
    # computes all three gradients
    records.append({
        "name": "flash_attention_bwd_dq", **common, "source": source.format("bwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:317",
        "launches": fit_counts["flash_attention_bwd_dq"], "max_abs_err": dq_err,
        "ms": dq_ms, "plain_ms": bwd_plain_ms, "bound_ms": dq_bound,
        "bound_by": dq_by, "cuda_core_bound_ms": dq_core, "library_ms": bwd_library_ms,
        "bf16_ms": dq_bf16, "bf16_library_ms": bwd_library_bf16_ms,
    })
    records.append({
        "name": "flash_attention_bwd_dkv", **common, "source": source.format("bwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:340",
        "launches": fit_counts["flash_attention_bwd_dkv"],
        "max_abs_err": max(dk_err, dv_err), "ms": dkv_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": dkv_bound, "bound_by": dkv_by, "cuda_core_bound_ms": dkv_core,
        "library_ms": bwd_library_ms, "bf16_ms": dkv_bf16,
        "bf16_library_ms": bwd_library_bf16_ms,
    })

    mark("phases 1-6")
    # from here on child processes at the lowest CPU priority run beside
    # phases 7-12: phase 14's compiles (phase 14 loads what they compile),
    # phase 20's builds and export, and phase 11's two CPU steps; and so do
    # the CPU-ISA probes of this process's first AOTInductor load, on a
    # thread; phase 13 waits for them all, so that phases 13-19 run alone;
    # phase 20 runs last
    precompiled = ServingPrecompile()
    native_export = reference = None
    try:
        native_export = NativeExport()
        reference = FineTuneReference()
        isa_probes = start_cpu_isa_probes()

        # phase 7: the CNN transfer-learning pipeline at full width
        cnn_pipeline(card, counted=(reset_counts, counts))
        mark("phase 7")

        # phase 8: the rest of the CNN zoo at full width, and the sweep over it
        cnn_zoo(card, counted=(reset_counts, counts))
        mark("phase 8")

        # phase 9: the graph layer: TorchFunction, TFImageTransformer,
        # TFTransformer, export, persistence
        records[0]["launches"] += graph_layer(card, counted=(reset_counts, counts))
        mark("phase 9")

        # phase 10: the Keras half of the graph layer: a .keras InceptionV3
        # through TorchFunction.from_keras, KerasImageFileTransformer, the UDFs
        keras_half(card, counted=(reset_counts, counts))
        mark("phase 10")

        # phase 11: KerasImageFileEstimator fine-tuning the ResNet50 head
        # (BASELINE.json configs[3]) and its sweep
        keras_fine_tune(card, counted=(reset_counts, counts), reference=reference)
        mark("phase 11")

        # phase 12: checkpoint, resume and preemption of the ViT fit through
        # the four kernels; the Keras fine-tune's checkpoints, streaming and
        # optax optimizers
        resumed = vit_checkpoint_resume(card, (reset_counts, counts), train_params)
        records[0]["launches"] += resumed["transform"]["flash_attention_fwd"]
        for record, key in zip(records[1:], ("flash_attention_fwd+lse", "flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv")):
            record["launches"] += resumed["fit"][key]
        keras_remainder(card, counted=(reset_counts, counts))
        mark("phase 12")

        native_export.wait()
        precompiled.wait()
        isa_probes.join()
        log("engine: this process's CPU-ISA probes (its first AOTInductor load's) ran on a "
            "thread beside phases 7-12: " + (f"{isa_probes.seconds:.1f} s"
                                             if isa_probes.seconds is not None else "failed"))
        phases_13_to_21(card, (reset_counts, counts), train_params, step_ms["flash"],
                        records, native_export, precompiled)
    finally:
        for child in (native_export, reference, precompiled):
            if child is not None:
                child.close()

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def phases_13_to_21(card: str, counted, train_params, f32_step_ms: float, records,
                    native_export, precompiled) -> None:
    """Phases 13 (with 19), 14-18, 17 (b), 20 and 21, in that order; the
    launches of each kernel join ``records``."""
    reset_counts, counts = counted
    # phase 13: the ported paths' remainder: the bf16 fit through #2-#4,
    # the fitted transformer's persistence and the .npz import (#1),
    # imagenet from Keras's cache, the dispatch depths; then phase 19: the
    # C++ batch packer behind the featurizer's decode (no attention kernel)
    remainder = ported_paths_remainder(card, (reset_counts, counts), train_params, f32_step_ms)
    mark("phases 13 and 19")
    for record, key in zip(records, ("flash_attention_fwd", "flash_attention_fwd+lse",
                                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        record["launches"] += remainder[key]

    # phase 14: the engine and online serving: the ViT-B/16 endpoint through
    # #1 (ragged and padded), its warm start (every program but the decode
    # step compiled beside phases 7-12 by ``precompiled``), the Keras UDF endpoint and its
    # program given non-contiguous weights, decode; then phase 15 (the data
    # pipeline with device prefetch and streaming inference, exactly once)
    # while phase 14's ViT endpoint is still open
    # phase 16: the replica plane, two replica processes behind the router
    # (#1's launches checked in the replicas, not counted here)
    # phase 18: the SQL dialect and continuous SQL through an eager bf16 ViT-B/16
    # endpoint (#1), on phase 14's images and their float32 plain rows
    streamed, csql, routed = [], [], []

    def then(server, images, want, serving_a):
        streamed.append(streaming_inference(card, (reset_counts, counts), train_params,
                                            server, images, want))
        routed.extend(replica_plane(card, images, want, serving_a))
        csql.append(continuous_sql(card, (reset_counts, counts), train_params, images, want))

    records[0]["launches"] += online_serving(card, (reset_counts, counts), train_params,
                                             precompiled, then=then)
    records[0]["launches"] += streamed[0] + csql[0]
    records[0]["phase18_launches"] = csql[0]
    mark("phases 14-18")

    # phase 17 (b): parallelism in an NCCL group of one, in a child process:
    # the DP, DP x TP and Ulysses-flash ViT fits (#2-#4) and the
    # Ulysses-flash transform (#1), counted there
    parallel = parallel_phase(card)
    for record, key in zip(records, ("flash_attention_fwd", "flash_attention_fwd+lse",
                                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        record["launches"] += parallel[key]
        record["phase17_launches"] = parallel[key]
    mark("phase 17 (b)")

    # phase 20: the native second stack, InceptionV3 through the C++
    # AOTInductor runner and aoti_tool (no attention kernel)
    native = native_stack(card, (reset_counts, counts), native_export)
    for record, key in zip(records, ("flash_attention_fwd", "flash_attention_fwd+lse",
                                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        record["phase20_launches"] = native[key]
    mark("phase 20")

    # phase 21: the fleet simulator over phase 16 (b)'s routed requests (no
    # device work), then, in a child process, the profiler through
    # SPARKDL_PROFILE_DIR over the bf16 featurizer and the bf16 flash ViT
    # (#1), last, so that the profiler's CUPTI state touches no earlier
    # reading
    profiled = sim_and_profiler(card, routed)
    for record, key in zip(records, ("flash_attention_fwd", "flash_attention_fwd+lse",
                                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        record["launches"] += profiled[key]
        record["phase21_launches"] = profiled[key]
    mark("phase 21")


if __name__ == "__main__":
    sys.exit(main())
