#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from a checkout of the repository, with one Hopper card (sm_90a) and
the CUDA toolkit's ``nvcc``::

    python3 chip_smoke.py            # the full check
    python3 chip_smoke.py --depth 32  # phases 4 and 16, uncut
    python3 chip_smoke.py --train-depth 8  # the Llama training leg, cut
    python3 chip_smoke.py --worker-depth 32  # the Llama worker leg, uncut
    python3 chip_smoke.py --slice-depth 32  # phases 24, 26 and 29, uncut

The Llama legs run at widths of Llama-3-8B's and, to keep the call's
time, at cut depths unless told otherwise: phases 4 and 16 (serving,
bf16 and int8) at 4 of 32 (``--depth``; 8 before phase 30 was added),
phases 24, 26 and 29 at 2 (``--slice-depth``; 16 before phases 27-28,
8 before phase 30), the worker leg (phase 18) at 2 (``--worker-depth``;
4 before phase 30); the training leg runs at 32 (``--train-depth``).

ViT-B/16 and BERT-base always run at full width and depth.

Phases; each raises on failure, so the script exits non-zero:

1. Device and build: the card's name and power limit, TF32 off, every
   ``rafiki_tpu_torch/csrc/*.cu`` built with ``nvcc`` (in parallel, timed,
   with ptxas's register/shared-memory report parsed per kernel: phases
   5, 9 and 10 print B3's, B4's, B5's, B6's and B7's).
2. B1/B2 against their plain versions at Llama-3-8B attention shapes
   (8 slots, 32 query / 8 kv heads, head dim 128, page 16, bf16 pools,
   max_len 2048): each element within 1e-3 + 2^-8·|plain| of the plain
   version run in f32, a window of one and a second call bit-identical,
   the split plan (splits, blocks), kernel / plain / library times, the
   least time the card could take, the rate (GB/s) and share of it. Then
   the same for their int8 instances (``paged_attention_int8.cu``) over
   the pools quantized row by row (int8 rows, one f32 scale each): bf16
   queries held to the bf16 tolerance and timed beside SDPA on the K/V
   gathered and dequantized to bf16, f32 queries to 1e-5 + 1e-5·|plain|,
   a second call bit-identical, and ptxas's registers and spills of the
   int8 bodies (those at d 64 and 128 must not spill). Then B2 at
   speculative-verify shapes: windows of s = 2, 4 and 8 tokens, six live
   slots' windows (one crossing a page) and two idle lanes repeating one
   position over scratch page 0, bf16 and int8 pools, each against its
   plain version; s = 4 (bf16) timed beside its bound and SDPA.
3. f32 exactness: the full-width Llama at depth 2 in f32 (random weights
   from a seed, nonzero LoRA) behind a paged ``DecodeEngine`` must emit
   exactly the tokens of ``greedy_generate`` over a contiguous cache.
4. Serving, the main path: Llama-3-8B (bf16, depth 4 unless
   ``--depth`` says otherwise, rope
   theta 500000, LoRA rank 16, random weights) behind ``DecodeEngine`` +
   ``TextDecodeEngine`` with a paged pool; 8 text requests of 64..1024
   prompt tokens, 64 new tokens each, submitted over the first steps.
   The kernels' launch counters are zeroed just before and read just
   after; both kernels must have launched. One decode-only engine call
   runs under ``torch.profiler``: its device busy share and top kernels.
   Phase 16 runs right after it, once phase 4's model is freed.

5. Flash kernels against their plain versions at Llama-3-8B attention
   shapes (b 4, 32 heads with K/V repeated from 8, s 1024, head dim 128,
   bf16, causal, kv_lens 1024/700/1/0): the errors of out, lse, dq, dk
   and dv against the plain versions run in f32, kernel / plain /
   library times, the least time; B3's, B5's and B6's plans (tensor-core
   or FMA body, padded head dim, copy width, stages), ptxas registers
   and spills (the bf16 B5/B6 at d 64 and 128 must not spill) and a
   second call bit-identical; B3, B5 and B6 again on full-length rows
   beside SDPA's forward and backward with ``is_causal=True`` (the second
   yardstick); plus an f32 case at head dim 16.
6. f32 training exactness: the full-width Llama at depth 2 in f32
   (nonzero LoRA) takes 4 functional train steps through the kernels,
   then the same 4 steps from the same weights with the attention bound
   to the plain version: per-step losses within 1e-4 relative.
7. Training, the main path of the training slice: Llama-3-8B (bf16
   compute, f32 trainable leaves, depth 32 unless ``--train-depth`` cuts
   it, LoRA rank 16) takes 4 steps on one 4 x 1024-token batch. The
   flash kernels' counters are zeroed just before and read just after:
   each must have launched depth x steps times; the loss must fall.
8. The ``LlamaLoRA`` template end to end at its largest knobs: train on
   a seeded ``.jsonl`` corpus, evaluate, dump, reload, evaluate, predict.
9. B7 (``matmul_bias``) against its plain version at ViT-B/16's serving
   shape, (64·196, 768) x (768, 768) + (768,), bf16 and f32; kernel /
   plain / ``torch.addmm`` times and the least time; the plan (body,
   tile, copy width, blocks), ptxas registers, a second call
   bit-identical.
10. The flash kernels on the classifier paths: B3/B5/B6 non-causal at
    ViT-B/16's shape (b 64, 12 heads, s 197, d 64, bf16) with times, and
    with BERT's padded keys (s 128), B5/B6 timed there beside SDPA's
    masked backward; B4 at block_h 4 on the ViT shape
    against its plain version and bit for bit against B3, a second call
    bit-identical, its time beside B3's in the same (no-LSE) call, both
    plans and ptxas registers; B3/B5/B6 at
    every compiled head dim (8 .. 192) on a small ragged shape, f32 and
    bf16, causal and not.
11. f32 exactness of a small ViT (head dim 96) and a small BERT (head dim
    24) through the kernels against the plain attention and plain
    ``matmul_bias``: logits and 4 AdamW steps' losses within 1e-5
    relative.
12. ViT-B/16 serving (bf16, random weights from a seed, 1000 classes):
    ``ViTBase16.predict`` over 256 seeded 224 x 224 x 3 images (4 buckets
    of 64; B7 = 4 and B3 = 48 launches), the p50 latency of a 1-image
    predict, then the same with the ``block_h`` default at 4 (B4 = 48, B3
    = 0, the same probabilities), then dump → reload → predict.
13. ViT-B/16 training: ``ViTBase16.train`` on a seeded 512-image npz,
    batch 64, one epoch of 8 steps (B7 = 8; B3, B5, B6 = 96); step time,
    images/s, peak memory, one profiled step's device-time split; the
    loss must fall; dump → reload → predict.
14. BERT-base (vocab 32768, ``max_len`` 128, bf16): ``BertClassifier``
    trains 8 steps at batch 64 on a seeded corpus (B3, B5, B6 = 96), then
    predicts 256 texts (B3 = 48); the loss must fall; dump → reload →
    predict.
15. Paged serving at the smallest head dim: a head-dim-8 Llama (hidden
    32, 4 heads, 2 kv heads, ``max_len`` 32, f32, random weights from a
    seed) behind ``DecodeEngine`` at pages 8 and 4 on the card must emit
    exactly the tokens of the same model and requests on the CPU; B1 and
    B2 must launch.
16. int8 serving (``quantize_int8`` + ``kv_cache_int8``): phase 4's model
    and request mix with int8 base kernels (per-channel f32 scales) and an
    int8 KV pool (one f32 scale per row); every request must complete and
    both int8 kernels launch. Reports decode tokens/s, TTFT, the weight
    and pool bytes beside a bf16 deployment's, and the device time of the
    per-forward int8 -> bf16 weight converts.
17. Phase 15's model and requests with int8 base kernels and an int8 KV
    pool, f32 queries through the int8 kernels: token-identical to the
    CPU at pages 8 and 4.
18. The inference worker, Llama: ``LlamaLoRA`` at Llama-3-8B widths
    (hidden 4096, 32 heads, kv_ratio 4, MLP 4 x hidden, vocab 128256, rope
    theta 500000, LoRA rank 16, bf16, max_len 2048, depth 2 unless
    ``--worker-depth`` says otherwise) from a seeded f32 blob written
    through the port's param-store codec to a ``mem://`` store (encode,
    decode and boot timed, host peak RSS); an ``InferenceWorker``
    (decode loop, 8 slots, 64 new tokens, 4 steps a sync, page 16)
    serves phase 4's 8 texts, 4 streaming, queued on the port's
    ``InProcQueueHub`` before its loop starts. Every reply without error, stream deltas a prefix of the
    final text, B1/B2 launched, and the texts token-identical to a direct
    ``make_decode_engine`` run of the same template and requests; TTFT
    p50/p95 (worker histograms; client clock for streams), output and
    decode-only tokens/s, requests/s and the loop's share outside
    ``engine.step``, beside the direct engine's.
19. The inference worker, ViT-B/16 (phase 12's blob): 256 seeded images
    in 4 messages of 64 through the micro-batcher, identical to
    ``ViTBase16.predict`` (B7 = 4, B3 = 48 launches); then 3 rounds of
    closed-loop 1-image requests: p50/p95 at concurrency 1 beside the
    direct 1-image ``predict`` of the same round, requests/s at
    concurrency 16 with the messages in each micro-batch, beside phase
    12's direct ``predict``.
20. Phase 15's head-dim-8 Llama in f32 as ``LlamaLoRA`` knobs, served
    paged at page 8 by a worker on the card and one on the CPU: the same
    messages give identical texts and identical ``engine_*`` counters in
    the published stats; B1/B2 launch.

21. A ViT-B/16 tuning job at full width: the port's ``TrainWorker`` with
    BOHB (``make_advisor("auto")``, seed 0) runs 8 trials over the ViT
    knob space with patch 16, hidden 768, depth 12, 12 heads and bf16
    pinned (the advisor searches learning rate, weight decay, warmup,
    batch size and the policies) on a seeded 512-image train npz and a
    256-image val npz, with a sqlite ``MetaStore`` and a ``file://`` param
    store. Every trial must complete, B7/B3/B5/B6 launch, the winner
    (``get_best_trials_of_train_job``) show a falling per-epoch loss; an
    ``InferenceWorker`` serves the winner's blob: the 256 val images'
    probabilities equal to ``predict``, accuracy within 1 % of the trial's
    score, B7/B3 launched. Per trial: knobs, budget, warm start, score,
    train / eval / save seconds and the worker's time outside them. Then
    trial 0 runs again alone under ``profile_dir``, and its
    ``torch.profiler`` trace splits its train around the steps.
22. A ``LlamaLoRA`` tuning job at its knob space's largest point (hidden
    512, depth 8, max_len 128, 8 heads, batch 32, bf16; 3 trials, BOHB)
    with train admission live (each trial's ``estimate_device_budget``
    beside its measured peak); every trial must complete, no trial's peak
    rise above its estimate, and B3/B5/B6 launch. The winner is served
    by an ``InferenceWorker`` decode loop (page 16): texts token-identical
    to a direct engine over the same blob, B1/B2 launched, and the
    serving estimate's ``params`` term equal to the bytes the served
    model holds (printed beside ``torch.cuda.memory_allocated()``, as in
    phase 18).

23. The stack: a ViT-B/16 train -> tune -> deploy -> predict job through
    the port's own control plane, every service a real process. The port's
    kvd, ``ServicesManager(platform=None)`` over the card the device probe
    finds (one slot), ``Admin``, ``AdminApp`` and a port ``Client`` over
    HTTP; phase 21's pins, images and BOHB, 4 trials (8 until phase 32
    joined the call), with ``profile`` on;
    every trial must complete and B7/B3/B5/B6 launch in the spawned train
    worker (counted in its traces); the finalized job frees the slot for
    the inference worker; phase 19's 256 images through the Predictor's
    ``/predict`` must equal a direct ``predict`` of the best trial's
    parameters from the param store; closed-loop 1-image clients at
    concurrency 1 and 16 over HTTP beside phase 19's; B7/B3 must launch in
    the spawned inference worker (its published ``kernel_launches``); then
    no child process may be left alive and the slot must be free. Prints
    the job's wall time and trials per hour, the first proposal beside
    phase 21's, per trial wall and train seconds, worker boot and deploy
    seconds, the Predictor's requests/s and p50 / p95, and the kvd's
    ``STATS``.
30. (inside phase 23, before its teardown; ``recovery_phase``) Crash
    recovery of the deployed job under 4 closed-loop 1-image HTTP
    clients, each request counted as answered (and equal to its image's
    row of the direct ``predict``), a structured 503 (by kind) or
    failed: (a) the admin, whose lease TTL is 2 s, stops its
    monitor, heartbeat and server and drops its handles without stopping
    a child; a second ``ServicesManager`` (device probe included) +
    ``Admin`` + ``AdminApp`` over the same MetaStore takes the lease over
    and ``reconcile()``s: the kvd, the Predictor and the inference worker
    adopted with their pids, nothing crashed, no request failed, a third
    manager's ``acquire_lease`` refused (``LeaseHeldError``); (b)
    ``POST /inference_jobs/<id>/rolling_restart``: the worker's sidecar
    answers ``/health`` through its ``obs_port_file``, the worker drains
    through it and exits 0, a replacement boots on the freed slot, no
    request fails or hangs; (c) SIGKILL on the kvd: the monitor respawns
    it on its port with WAL replay, the best trial's blob reads back
    bit-equal, the clients go on; (d) ``POST /system/backup`` opens as a
    MetaStore with the live rows, and ``python -m rafiki_tpu_torch.cli
    doctor --workdir`` finds no drift. After each of (a)-(c) phase 19's
    first 64 images through ``/predict`` equal the direct ``predict``. The
    handover's, drain's, replacement's, replay's (seconds and bytes),
    backup's and doctor's seconds are printed; B7/B3 must launch in the
    replacement (the ``recovery`` path). Phase 23's teardown then stops
    the new admin's stack: no recorded pid may stay alive.

24. Llama serving as its users run it, at phase 18's widths (bf16,
    depth 2 unless ``--slice-depth`` says otherwise): a byte-BPE
    artifact of exactly 128256 ids (merges trained on a seeded corpus,
    then seeded merges of an existing id and a byte); a seeded HF-layout
    checkpoint
    written by ``export_llama_safetensors`` in shards of 4 blocks with
    ``model.safetensors.index.json`` and a ``config.json`` (rope theta
    500000; the disk's free space checked first); ``LlamaLoRA``
    (``tokenizer_path``, ``pretrained_path``, ``adapters_only``) trains
    one epoch of two batches of 1 x 2048 from it: B3/B5/B6 must launch,
    every frozen leaf must equal the checkpoint's tensor (write and
    import seconds and GB/s, host peak RSS). Then its
    ``make_decode_engine`` (paged, page 16, 8 slots, max_len 2048): 8
    greedy requests, then the same prompts sampled (temperature 0.8,
    top-k 50, top-p 0.95, seeds 0-7), decode tokens/s of each; the
    card's ``_select_next`` on one captured step's f32 logits must pick
    the plain CPU sampler's tokens (its device time per step beside an
    argmax's); 8 background requests of 128 new tokens fill the slots
    and 2 interactive ones arrive two calls later: ``preemptions`` >= 1
    and equal to the ``preempted`` spans, every request its full token
    count, the interactive TTFT beside an idle engine's; one request
    resumed (``forced_prefix``) from the text a stream had delivered
    halfway: its output must begin with it and spend its budget. B1/B2
    must launch on every serving leg (the ``llama_slice_*`` paths).
25. Phase 15's head-dim-8 f32 Llama as ``LlamaLoRA`` knobs with a
    512-id byte-BPE tokenizer, paged at page 8 on the card and on the
    CPU: seeded sampling, a preemption (greedy and sampled), a stream
    resume, phase 26's modes (prompt lookup, the target as its own
    draft, a prefix registered and one imported, two adapters) and phase
    29's at this size (the host tier with a pool of 5 usable pages and 24
    host pages in f32, with an int8 KV pool and in bf16, and one KV
    shipment through the param-store codec) must give identical tokens,
    texts and counters (the bf16 tier's tokens are reported, and each
    tiered run must equal its untiered engine's); B1/B2 must launch.
26. (inside phase 24, before its model is freed) The decode modes on
    phase 24's fine-tuned model (bf16, paged, page 16, 8 slots):
    prompt-lookup speculation (``speculate_k`` 4) and draft-model
    speculation (a seeded ``LlamaLoRA`` at Llama-3.2-1B's shape: hidden
    2048, 16 layers, 32 / 8 kv heads, MLP 8192, the same tokenizer) on
    phase 24's 8 greedy requests, tokens equal to the greedy leg's and
    verify windows through B2; a 512-token system prefix registered and
    8 requests extending it, tokens equal to a no-prefix engine's, then
    exported through the param-store codec and imported into a fresh
    engine, the same tokens (blob bytes, TTFT with and without); two
    adapters in one engine (the fine-tune and a seeded variant), 8
    requests alternating, each equal to its adapter's solo engine.

29. (inside phase 24, after phase 26, before its model is freed) The
    host KV tier and disaggregated prefill/decode on phase 24's model
    (``tier_disagg_phase``): (a) 6 greedy requests of 1984 down to 512
    prompt tokens, 64 new each, 8 slots, through ``make_decode_engine``
    with a pool of half the pages they reserve and ``host_kv_pages`` for
    the rest, beside an untiered engine with the full pool, in bf16 and
    again on an f32 twin of the model (tokens equal to the untiered
    engine's: gated in f32, reported in bf16, where a schedule's chunk
    widths and split plans round apart), every page the tier restores
    bit-equal to the page it evicted (gated in both), parks, evictions
    and unparks > 0 (the ``kv_tier`` path: the two tiered runs), with the
    evictions, prefetch hits and misses, GB moved each way and the rate
    of the tier's side-stream copies, the step thread's wait on the tier,
    decode tokens/s and TTFT beside the untiered engine's; (b) a
    ``prefill`` and a ``decode`` ``InferenceWorker`` on the same card over
    the in-process hub; 4 texts of 1024 tokens streamed at once through
    the port's ``Predictor``, first with the decode worker alone in its
    pool (it serves them unified), then with both: texts equal, 4
    shipments sent and installed, no fallback (the ``disagg`` path), with
    the blob bytes, ship -> install seconds and TTFT beside the unified
    run's. B1/B2 must launch on both paths.

27. BASELINE #2 at ImageNet widths (``resnet_phase``): ``ResNetClassifier``
    (resnet50, width 64, bf16, batch 256, 224 x 224 x 3, 1000 classes)
    trains one epoch of 16 steps (``budget_scale`` 0.2) from a seeded
    617 MB ``.npy`` zip that streams by the template's own size rule
    (``data/stream.py``: worker-thread decode, flip + crop): step time,
    images/s, the wait on the loader, the card's busy share (one step
    profiled), peak memory, the step's FLOPs from the conv and dense
    shapes and its ``mfu`` against 989 TFLOP/s; finite losses, every
    ``batch_stats`` leaf moved; ``evaluate`` on 512 images, ``predict``
    of 256 and of 1. Then f32, TF32 off: resnet18 / resnet50 at width 16
    on 64 x 64 (the ImageNet stem), vgg11 and densenet-s on 32 x 32, on
    the card and on the CPU from one blob: logits, two SGD steps' losses
    and ``batch_stats``.
28. The BASELINE jobs (``cnn_tuning_phase``): BOHB ``tune_model`` over
    ``ResNetClassifier`` (variant pinned to resnet50, 4 trials) on a
    seeded 32 x 32 x 3 npz, the winner served by an ``InferenceWorker``
    (256 images equal to ``predict``, closed-loop clients at 1 and 16);
    ``python -m rafiki_tpu_torch.cli tune JaxFeedForward`` over
    FashionMNIST-layout PNG zips (2048 / 512) as a subprocess on the
    card; one epoch each of ``VGGClassifier`` and ``DenseNetClassifier``.
    No port kernel lies on these paths: their launch counts must stay 0
    (the ``resnet50_training`` and ``cnn_tuning`` paths).

31. The gang engine (``gang_phase``, after 28): (a) BOHB over
    ``JaxFeedForward`` on phase 28's FashionMNIST-layout zips, once as a
    16-lane gang through ``tune_model(gang_size=16)`` and once through
    the engine's ``mode="sequential"`` (each trial the template's own
    ``train`` / ``evaluate``) with the same advisor seed: the same
    trials, promotions and culls, every score equal but at most
    ``GANG_FF_UNEQUAL``, those within ``GANG_FF_TOL``; (b)
    ``LlamaLoRA`` at Llama-3-8B widths, depth 4, bf16, ``max_len``
    1024: 4 lanes of batch 2 with distinct ``learning_rate`` and
    ``lora_scale`` through the engine's executor, each lane's losses
    within ``GANG_LLAMA_TOL`` of a sequential run of its own knobs on
    the same batches, and a planted fault (``GANG_LLAMA_FAULT``: lanes
    0 and 1 trade learning rates) read above that gate; B3, B5 and B6
    launched ``depth`` times per gang step, the gang estimator's total
    beside the peak memory; (c) a
    head-dim-8 f32 ``LlamaLoRA`` job through ``TrainWorker.run_gang(2)``
    over a sqlite MetaStore, its winner and a sequentially trained twin
    served by one multi-adapter engine (paged: B1/B2), token for token
    equal. Paths ``gang_feedforward`` (no port kernel), ``gang_llama``
    and ``gang_worker``.
32. Scale-out on one card (``scaleout_phase``, after 23): its own stack
    with two slots over the one card (``ServicesManager(platform=
    "cuda", devices=[card] * 2)``). (a) ViT-B/16 (bf16, phase 19's blob
    under a trial row) deployed with one worker, scaled to two by
    ``Client.scale_inference_job`` (the second joins the published pool
    once its obs port reports), a rolling restart of the two-worker
    pool and the scale back to one, under closed-loop 1-image HTTP
    clients whose every answer must equal the direct ``predict``: no
    failed request, no 503 in the restart; requests/s at 16 and p50 at
    1 with one worker and with two. (b) A head-dim-8 f32 ``LlamaLoRA``
    deployed with ``AUTOSCALE`` (``SCALE_BUDGET``) under
    ``SCALE_STREAMS`` HTTP streams: the admin's monitor grows the pool
    on admission stalls, the new worker (armed by ``RAFIKI_CHAOS=
    kill_after_tokens``, in the admin's environment only until that
    scale-up spawned) dies with its streams in flight, the manager takes
    it out of the published pool, the Predictor fails its streams over
    with forced prefixes, the monitor respawns it and it rejoins once
    booted, and once the load stops the monitor shrinks the pool back to
    one through the drain path; every stream's text equal to a direct
    ``make_decode_engine`` run. B7/B3 (a) and B1/B2 (b) read from every worker's ``/metrics``;
    paths ``scaleout_vit`` and ``scaleout_llama``.
33. The rest of the zoo (``zoo_phase``, after 31): (a) ``JaxTabularMLP``
    at its widest knobs (4 x 256 units, batch 256, dropout 0.3) on a
    seeded table of UCI Covertype's shape (54 features, 7 classes,
    65536 / 16384 rows): its first 32 steps on the card against the
    same steps on the CPU from one state (at ``ZOO_EXACT_LR``, within
    ``ZOO_MLP_TOL``), then 2
    epochs, ``evaluate``, ``predict`` of 256 rows and the blob through
    the codec; (b) BOHB over it at ``tests/test_tuning.py``'s pins on
    8192 / 2048 rows, an 8-lane gang through ``tune_model`` against the
    engine's ``mode="sequential"``: the same trials, promotions and
    culls, scores gated as phase 31 (a)'s; (c) ``BiLSTMTagger`` at its
    widest knobs on a seeded corpus of the Penn Treebank WSJ tag set's
    shape (45 tags, 4096 words, 8192 / 1024 sentences): 8 steps card
    against CPU (``ZOO_LSTM_TOL``), one epoch, its blob behind an
    ``InferenceWorker`` (256 sentences, some empty and some past
    ``max_len``, equal to ``predict``; sentences/s at concurrency 16);
    (d) in a process of its own beside (a)-(c), which first writes (c)'s
    corpus: ``BigramHMM`` on that corpus, ``SklearnDecisionTree`` and
    ``SklearnGBDT`` on 4096 / 1024 rows and ``SklearnSVM`` on 2048 / 512
    rows of the table's shape, fitted without scikit-learn, each above
    its JAX test's accuracy bar and equal through the codec. No port
    kernel lies on these paths (``zoo_tabular``, ``zoo_gang_tabular``,
    ``zoo_pos``, ``zoo_host``): their launch counts must stay 0.

34. The image formats (``image_formats_phase``, right after 13): (a)
    every file under ``tests/fixtures/torch_images/`` (one per PNG colour
    type, depth and interlace, one per JPEG decoder branch) decoded by
    ``data/image.py`` on this host, bit-equal in dtype, shape and value
    to PIL's arrays recorded beside them (the card's machine has no
    PIL); (b) ``generate_streaming_image_zip(fmt="jpeg")`` for the
    recorded (n, shape, seed) cases, every member's SHA-256 equal to the
    digest recorded from JAX's generator; (c) the loader at ImageNet's
    shape: ``FORMAT_IMAGES`` seeded 224 x 224 x 3 images written as JPEG
    (the port's encoder), PNG and ``.npy`` zips (encode seconds each),
    then one epoch of ``StreamingImageDataset.iter_batches`` at batch
    ``FORMAT_BATCH`` with the template's worker count (flip + crop):
    images/s per format beside the card's name and power limit, no gate
    on speed; (d) ViT-B/16 trains from a JPEG zip: phase 13's knobs and
    512 images, encoded by the port and loaded whole by
    ``ViTBase16.train`` through ``load_image_classification_dataset``,
    batch 64, 8 steps: launch counts equal phase 13's (the
    ``vit_jpeg_training`` path), finite and falling losses, dump →
    reload → predict identical.

Phase 25 runs after 17. The worker phases run in the order 20, 19, 21,
22, 23, 32, 27, 28, 31, 33, then 24 and 18: phases 24 and 18 hold the most
host memory (phase 24's f32 tree, phase 18's blob), and run last.

Each path's launch counts are zeroed just before it and read just after;
the ``kernels`` line gives each kernel's sum over the paths and the
per-path counts. The last lines are the ``kernels`` JSON line and then the device line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing a result.
"""

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
VOCAB = 128256  # Llama-3-8B's vocabulary
#: H100 SXM, published peaks (dense): memory rate and bf16 / f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SOURCES = {
    "paged_decode_attention": "rafiki_tpu_torch/csrc/paged_attention.cu",
    "paged_window_attention": "rafiki_tpu_torch/csrc/paged_attention.cu",
    "paged_decode_attention_int8":
        "rafiki_tpu_torch/csrc/paged_attention_int8.cu",
    "paged_window_attention_int8":
        "rafiki_tpu_torch/csrc/paged_attention_int8.cu",
    "flash_attention_fwd": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_fwd_mh": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "rafiki_tpu_torch/csrc/flash_attention.cu",
    "matmul_bias": "rafiki_tpu_torch/csrc/patch_embed.cu",
}
REPLACES = {
    "paged_decode_attention": "rafiki_tpu/ops/paged_attention.py:177",
    "paged_window_attention": "rafiki_tpu/ops/paged_attention.py:337",
    # the quantized=True branch of the same Pallas kernels
    "paged_decode_attention_int8": "rafiki_tpu/ops/paged_attention.py:177",
    "paged_window_attention_int8": "rafiki_tpu/ops/paged_attention.py:337",
    "flash_attention_fwd": "rafiki_tpu/ops/attention.py:98",
    "flash_attention_fwd_mh": "rafiki_tpu/ops/attention.py:156",
    "flash_attention_bwd_dq": "rafiki_tpu/ops/attention.py:222",
    "flash_attention_bwd_dkv": "rafiki_tpu/ops/attention.py:275",
    "matmul_bias": "rafiki_tpu/ops/patch_embed.py:19",
}
FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")


#: the script's start on the host clock; each phase line carries its
#: seconds since (``t_s``), so a call's time splits by phase
T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    print(json.dumps(obj), flush=True)


def build_kernels(build):
    """One nvcc per source, all started together; returns the sources,
    the wall time and ptxas's per-kernel resources
    (:func:`ptxas_resources`)."""
    sources = sorted(build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            lambda s: build.build(s.stem, extra_flags=("-Xptxas", "-v")),
            sources))
    seconds = time.perf_counter() - t0
    return [s.name for s in sources], seconds, ptxas_resources(
        "\n".join(logs))


def ptxas_resources(log):
    """``-Xptxas -v``'s report, per compiled kernel: its mangled name,
    registers per thread, spill stores and loads (bytes) and static
    shared memory (bytes; a kernel's dynamic shared memory is its plan's,
    set at launch)."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"mangled": ln.split("'")[1], "registers": None,
                   "spill_bytes": None, "static_smem": 0}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["spill_bytes"] = nums[1] + nums[2]  # stores + loads
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                cur["static_smem"] = int(words[words.index("smem") - 2])
    return out


def kernel_resources(ptxas, mangled_part):
    """The ptxas entries whose mangled name contains ``mangled_part``
    (e.g. ``16flash_fwd_kernelI13__nv_bfloat16Li64E``: the B3 bf16 body at
    d = 64)."""
    return [{k: v for k, v in e.items() if k != "mangled"}
            for e in ptxas if mangled_part in e["mangled"]]


#: the mangled-name parts of the kernels phases 2, 5, 9 and 10 report
#: (int8_t is ``signed char``, mangled ``a``; ``q`` is ``f`` or the bf16)
PAGED_INT8 = "19paged_{kind}_kernelI{q}aLi{d}E"
B3_BF16 = "16flash_fwd_kernelI13__nv_bfloat16Li{d}E"
B4_BF16 = "19flash_fwd_mh_kernelI13__nv_bfloat16Li{d}E"
B5_BF16 = "23flash_bwd_dq_mma_kernelILi{d}E"
B6_BF16 = "24flash_bwd_dkv_mma_kernelILi{d}E"
B7_MMA = "22matmul_bias_mma_kernelILb1EE"


#: clock cycles (~1 ms on an H100) the card spins before each timed call:
#: longer than the host takes to enqueue the call, so the timing events
#: bracket device work only, not the card waiting on the host
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, iters=10):
    """Median device time of one call, each launch timed by its own CUDA
    events with a 64 MB write in between, so every call finds the L2
    cache (50 MB) cold, as a layer's call does in a decode step. A spin
    kernel keeps the card busy while the host enqueues the call: without
    it a call shorter than its own host enqueue (a few tens of us of
    Python and launch overhead) would be timed with the card idle."""
    fn()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def bound_ms(n_bytes, flops, dtype_name):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate for the type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_resources(ptxas, dims=(64, 128)):
    """ptxas's registers and spills of the int8 instances of B1 and B2 at
    head dims ``dims``, both query types, both key-group counts."""
    out = {}
    for d in dims:
        for qname, qm in (("bf16", "13__nv_bfloat16"), ("f32", "f")):
            for kind in ("decode", "window"):
                out[f"{kind} {qname} d{d}"] = kernel_resources(
                    ptxas, PAGED_INT8.format(kind=kind, q=qm, d=d))
    return out


def kernel_phase(torch, np, F, pa, ll, dev, ptxas=()):
    """Phase 2: B1 and B2 against their plain versions, each element
    within its own tolerance (``FLASH_TOL``), a window of one and a second
    call bit-identical to the first, and each launch's split plan, rate
    and share of its bound; then the same for their int8 instances, on
    the pools quantized row by row (bf16 queries, timed, beside SDPA on
    the K/V gathered and dequantized to bf16; and f32 queries, held to
    the f32 tolerance), with ptxas's registers and spills of the int8
    bodies (those at d 64 and 128 must not spill)."""
    b, n_heads, n_kv, dh, page, max_len = 8, 32, 8, 128, 16, 2048
    rng = np.random.default_rng(SEED)
    last = np.array([0, 17, 300, 555, 1023, 1500, 1900, 2047], np.int32)
    n_live = last // page + 1
    width = 1
    while width < n_live.max():  # the engine's live-width slice
        width *= 2
    width = min(width, max_len // page)
    n_pages = 1 + b * (max_len // page)
    tables = np.zeros((b, width), np.int32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    used = 0
    for i, n in enumerate(n_live):
        tables[i, :n] = perm[used:used + n]
        used += n

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    bf16 = torch.bfloat16
    shape = (n_pages, page, n_kv, dh)
    k_pool = put(rng.standard_normal(shape, np.float32), bf16)
    v_pool = put(rng.standard_normal(shape, np.float32), bf16)
    k_pool[0] = put(1e3 * rng.standard_normal(shape[1:], np.float32), bf16)
    v_pool[0] = put(1e3 * rng.standard_normal(shape[1:], np.float32), bf16)
    tab = put(tables)
    sm = 1.0 / float(np.sqrt(dh))
    kv_token_bytes = n_kv * dh * 2 * 2  # K and V rows, bf16
    floor, rel = FLASH_TOL["bfloat16"]

    # gathered logical K/V for the library yardstick (not timed)
    length = width * page
    kl = k_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    vl = v_pool[tab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
    k_pos = torch.arange(length, device=dev)

    def measure(kernel, plain, library, ref, got, n_bytes, flops, plan):
        again = kernel()
        torch.cuda.synchronize()
        err, over = elementwise_err(got, ref, floor, rel)
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        ms = time_ms(torch, kernel)
        # one warm call under the profiler: the split kernel's and the
        # merge's device time
        split = _profile_call(torch, kernel).get("kernels_ms", {})
        return dict(
            profiled_warm_us={k: v * 1e3 for k, v in split.items() if v},
            max_abs_err=err, err_over_tol=over,
            tol="per element: 1e-3 + 2^-8 * |plain|",
            bit_identical_second_call=bool(torch.equal(again, got)),
            ms=ms, plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library),
            library_covers="SDPA on K/V gathered beforehand (the gather "
                           "not timed), with the same mask",
            bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
            gb_per_s=n_bytes / (ms * 1e-3) / 1e9, bytes=n_bytes,
            flops=flops, plan=plan._asdict())

    results = {}
    # --- B1: one query token per slot
    q = put(rng.standard_normal((b, n_heads, dh), np.float32), bf16)
    pos = put(last)
    out = pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm)
    ref = pa._paged_attention_reference(q.float(), k_pool.float(),
                                        v_pool.float(), tab, pos, sm)
    win1 = pa.paged_window_attention(q[:, None], k_pool, v_pool, tab,
                                     pos[:, None], sm)[:, 0]
    torch.cuda.synchronize()
    window_of_one_identical = bool(torch.equal(win1, out))
    mask1 = (k_pos[None, :] <= pos[:, None].long())[:, None, None, :]
    keys = (last.astype(np.int64) + 1)
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * q.numel() * 2
    flops = 4 * n_heads * dh * int(keys.sum())
    results["paged_decode_attention"] = measure(
        lambda: pa.paged_decode_attention(q, k_pool, v_pool, tab, pos, sm),
        lambda: pa._paged_attention_reference(q, k_pool, v_pool, tab, pos,
                                              sm),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kl, vl, attn_mask=mask1, scale=sm,
            enable_gqa=True),
        ref, out, n_bytes, flops,
        pa._launch_plan(b, 1, n_heads, n_kv, width, page, bf16, dh))
    results["paged_decode_attention"]["shapes"] = (
        f"q ({b}, {n_heads}, {dh}) bf16; pool {shape} bf16; table ({b}, "
        f"{width}); positions {last.tolist()}")

    # --- B2: a 32-token window per slot: 31 real tokens ending at the
    # slot's position, then one overhang row repeating the last
    c = 32
    wpos = np.maximum(0, last[:, None] - np.arange(c - 2, -1, -1)[None, :])
    wpos = np.concatenate([wpos, wpos[:, -1:]], axis=1).astype(np.int32)
    qw = put(rng.standard_normal((b, c, n_heads, dh), np.float32), bf16)
    wp = put(wpos)
    outw = pa.paged_window_attention(qw, k_pool, v_pool, tab, wp, sm)
    refw = pa._paged_window_reference(qw.float(), k_pool.float(),
                                      v_pool.float(), tab, wp, sm)
    mask2 = (k_pos[None, None, :] <= wp[:, :, None].long())[:, None]
    keys = wpos[:, -1].astype(np.int64) + 1  # the tile's page horizon
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * qw.numel() * 2
    flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
    results["paged_window_attention"] = measure(
        lambda: pa.paged_window_attention(qw, k_pool, v_pool, tab, wp, sm),
        lambda: pa._paged_window_reference(qw, k_pool, v_pool, tab, wp, sm),
        lambda: F.scaled_dot_product_attention(
            qw.transpose(1, 2), kl, vl, attn_mask=mask2, scale=sm,
            enable_gqa=True),
        refw, outw, n_bytes, flops,
        pa._launch_plan(b, c, n_heads, n_kv, width, page, bf16, dh))
    results["paged_window_attention"]["shapes"] = (
        f"q ({b}, {c}, {n_heads}, {dh}) bf16; pool {shape} bf16; table "
        f"({b}, {width}); window ends {last.tolist()}")
    # --- the int8 instances: the same shapes over the pools quantized
    # row by row as the model's cache write does (scratch page 0's 1e3
    # garbage included), 264 bytes a token and kv head (two 128-byte
    # rows, two f32 scales)
    kq, ks = ll._quantize_int8(k_pool, -1)
    vq, vs = ll._quantize_int8(v_pool, -1)
    kl8 = (kq[tab.long()].float() * ks[tab.long()][..., None]).to(bf16) \
        .reshape(b, length, n_kv, dh).transpose(1, 2)
    vl8 = (vq[tab.long()].float() * vs[tab.long()][..., None]).to(bf16) \
        .reshape(b, length, n_kv, dh).transpose(1, 2)
    kv_token_bytes = n_kv * (2 * dh + 2 * 4)
    i8 = (kq, vq, tab)
    win1_8 = pa.paged_window_attention(q[:, None], kq, vq, tab, pos[:, None],
                                       sm, ks, vs)[:, 0]
    out8 = pa.paged_decode_attention(q, *i8, pos, sm, ks, vs)
    ref8 = pa._paged_attention_reference(q.float(), *i8, pos, sm, ks, vs)
    torch.cuda.synchronize()
    window_of_one_identical_int8 = bool(torch.equal(win1_8, out8))
    keys = (last.astype(np.int64) + 1)
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * q.numel() * 2
    flops = 4 * n_heads * dh * int(keys.sum())
    results["paged_decode_attention_int8"] = measure(
        lambda: pa.paged_decode_attention(q, *i8, pos, sm, ks, vs),
        lambda: pa._paged_attention_reference(q, *i8, pos, sm, ks, vs),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kl8, vl8, attn_mask=mask1, scale=sm,
            enable_gqa=True),
        ref8, out8, n_bytes, flops,
        pa._launch_plan(b, 1, n_heads, n_kv, width, page, bf16, dh))
    outw8 = pa.paged_window_attention(qw, *i8, wp, sm, ks, vs)
    refw8 = pa._paged_window_reference(qw.float(), *i8, wp, sm, ks, vs)
    keys = wpos[:, -1].astype(np.int64) + 1
    n_bytes = int(keys.sum()) * kv_token_bytes + 2 * qw.numel() * 2
    flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
    results["paged_window_attention_int8"] = measure(
        lambda: pa.paged_window_attention(qw, *i8, wp, sm, ks, vs),
        lambda: pa._paged_window_reference(qw, *i8, wp, sm, ks, vs),
        lambda: F.scaled_dot_product_attention(
            qw.transpose(1, 2), kl8, vl8, attn_mask=mask2, scale=sm,
            enable_gqa=True),
        refw8, outw8, n_bytes, flops,
        pa._launch_plan(b, c, n_heads, n_kv, width, page, bf16, dh))
    lib_covers = ("SDPA on K/V gathered and dequantized to bf16 beforehand "
                  "(gather and dequantization not timed), with the same "
                  "mask")
    resources = int8_resources(ptxas)
    for name, kind in (("paged_decode_attention_int8", "decode"),
                       ("paged_window_attention_int8", "window")):
        r = results[name]
        r["library_covers"] = lib_covers
        r["ptxas"] = {k: v for k, v in resources.items()
                      if k.startswith(kind)}
        r["shapes"] = results[name[:-5]]["shapes"].replace(
            "bf16; table", "int8 + f32 scales (n_pages, page, n_kv); table")
    # f32 queries over the same int8 pools: the exactness legs' body
    q32, qw32 = q.float(), qw.float()
    f32_floor, f32_rel = FLASH_TOL["float32"]
    f32_int8 = {}
    for name, kernel, plain in (
            ("paged_decode_attention_int8",
             lambda: pa.paged_decode_attention(q32, *i8, pos, sm, ks, vs),
             lambda: pa._paged_attention_reference(q32, *i8, pos, sm, ks,
                                                   vs)),
            ("paged_window_attention_int8",
             lambda: pa.paged_window_attention(qw32, *i8, wp, sm, ks, vs),
             lambda: pa._paged_window_reference(qw32, *i8, wp, sm, ks,
                                                vs))):
        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err, over = elementwise_err(got, ref, f32_floor, f32_rel)
        f32_int8[name] = {"max_abs_err": err, "err_over_tol": over,
                          "tol": "per element: 1e-5 + 1e-5 * |plain|",
                          "bit_identical_second_call":
                              bool(torch.equal(got, again)),
                          "ms": time_ms(torch, kernel)}
        results[name]["f32_queries"] = f32_int8[name]
    results["paged_window_attention"]["verify_windows"] = verify_windows(
        torch, np, F, pa, measure, put, k_pool, v_pool, (kq, vq, ks, vs),
        tab, last, sm, dev)
    emit({"phase": "kernels",
          "window_of_one_identical": window_of_one_identical,
          "window_of_one_identical_int8": window_of_one_identical_int8,
          **results})
    verify = results["paged_window_attention"]["verify_windows"]
    for name, r in list(results.items()) + [
            (f"{n} (f32 queries)", r) for n, r in f32_int8.items()] + [
            (f"B2 verify window {k}", r) for k, r in verify.items()]:
        if not r["err_over_tol"] <= 1.0:
            raise AssertionError(
                f"{name} disagrees with its plain version: max abs error "
                f"{r['max_abs_err']}, {r['err_over_tol']} x its element's "
                f"tolerance")
        if not r["bit_identical_second_call"]:
            raise AssertionError(f"{name}: a second call on the same inputs "
                                 f"gave other bits")
    if not (window_of_one_identical and window_of_one_identical_int8):
        raise AssertionError("a window of one is not bit-identical to the "
                             "decode kernel")
    spills = {k: e["spill_bytes"] for k, es in resources.items() for e in es
              if e["spill_bytes"]}
    if spills or not all(resources.values()):
        raise AssertionError(f"the int8 B1/B2 bodies at d 64/128 spill or "
                             f"were not reported: {spills or resources}")
    return results


def verify_windows(torch, np, F, pa, measure, put, k_pool, v_pool, int8,
                   tab, last, sm, dev):
    """B2 as speculative verify calls it, on phase 2's pools: windows of
    s = speculate_k in {2, 4, 8} tokens, six live slots' windows ending
    at their positions (slot 1's, at 17, crosses a page at s >= 4) and
    two idle lanes as the engine makes them, a free slot's position 0
    repeated s times over a table row of scratch page 0; bf16 and int8
    pools, bf16 queries. Each against its plain version with a second
    call bit-identical, and each row beside the decode kernel (B1) at its
    position; the s = 4 bf16 case timed beside its bound and SDPA on the
    same K/V gathered (the B2 row at the verify shape)."""
    kq, vq, ks, vs = int8
    b, page = len(last), k_pool.shape[1]
    n_heads, n_kv, dh = 32, k_pool.shape[2], k_pool.shape[3]
    live = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    vtab = tab.clone()
    vtab[put(~live)] = 0
    floor, rel = FLASH_TOL["bfloat16"]
    out = {}
    for s_k in (2, 4, 8):
        offs = np.arange(s_k)[None, :]
        wpos = np.where(live[:, None],
                        np.minimum(np.maximum(0, last[:, None] - s_k + 1)
                                   + offs, last[:, None]),
                        0).astype(np.int32)
        wp = put(wpos)
        q = put(np.random.default_rng(SEED + s_k).standard_normal(
            (b, s_k, n_heads, dh), np.float32), torch.bfloat16)
        for pool, args, plain_args in (
                ("bfloat16", (k_pool, v_pool, vtab, wp, sm),
                 (k_pool.float(), v_pool.float(), vtab, wp, sm)),
                ("int8", (kq, vq, vtab, wp, sm, ks, vs),
                 (kq, vq, vtab, wp, sm, ks, vs))):
            got = pa.paged_window_attention(q, *args)
            again = pa.paged_window_attention(q, *args)
            ref = pa._paged_window_reference(q.float(), *plain_args)
            steps = torch.stack([pa.paged_decode_attention(
                q[:, j], args[0], args[1], vtab, wp[:, j], sm, *args[5:])
                for j in range(s_k)], dim=1)
            torch.cuda.synchronize()
            err, over = elementwise_err(got, ref, floor, rel)
            out[f"s{s_k}_{pool}"] = {
                "max_abs_err": err, "err_over_tol": over,
                "bit_identical_second_call": bool(torch.equal(got, again)),
                "rows_equal_decode_kernel": bool(torch.equal(got, steps)),
                "positions": wpos.tolist()}
        if s_k != 4:
            continue
        length = vtab.shape[1] * page
        kl = k_pool[vtab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
        vl = v_pool[vtab.long()].reshape(b, length, n_kv, dh).transpose(1, 2)
        k_pos = torch.arange(length, device=dev)
        mask = (k_pos[None, None, :] <= wp[:, :, None].long())[:, None]
        # the bytes the function must read: each lane's visible keys (an
        # idle lane's one), q read and the output written
        keys = wpos[:, -1].astype(np.int64) + 1
        n_bytes = int(keys.sum()) * n_kv * dh * 2 * 2 + 2 * q.numel() * 2
        flops = 4 * n_heads * dh * int((wpos.astype(np.int64) + 1).sum())
        ref = pa._paged_window_reference(q.float(), k_pool.float(),
                                         v_pool.float(), vtab, wp, sm)
        got = pa.paged_window_attention(q, k_pool, v_pool, vtab, wp, sm)
        timed = measure(
            lambda: pa.paged_window_attention(q, k_pool, v_pool, vtab, wp,
                                              sm),
            lambda: pa._paged_window_reference(q, k_pool, v_pool, vtab, wp,
                                               sm),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kl, vl, attn_mask=mask, scale=sm,
                enable_gqa=True),
            ref, got, n_bytes, flops,
            pa._launch_plan(b, s_k, n_heads, n_kv, vtab.shape[1], page,
                            torch.bfloat16, dh))
        timed["shapes"] = (f"q ({b}, {s_k}, {n_heads}, {dh}) bf16; pool "
                           f"{tuple(k_pool.shape)} bf16; table ({b}, "
                           f"{vtab.shape[1]}); 6 live windows ending at "
                           f"{last[live].tolist()}, 2 idle lanes at 0")
        out["s4_timed"] = timed
    return out


def randomize_lora_b(model, gen):
    """Nonzero adapters, so the LoRA path does real work."""
    for name, p in model.named_parameters():
        if name.endswith("lora_b"):
            p.normal_(0.0, 0.02, generator=gen)


def exactness_phase(torch, np, ll, de, dev):
    """Phase 3: paged engine (kernels) vs greedy_generate (contiguous),
    full width, depth 2, f32: token-identical."""
    max_len, page, max_new = 128, 16, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = ll.Llama(vocab_size=128256, max_len=max_len, depth=2,
                     lora_rank=16, rope_theta=500000.0, device=dev,
                     generator=gen)
    randomize_lora_b(model, gen)
    rng = np.random.default_rng(SEED + 1)
    lens = np.array([40, 75, 20, 100], np.int32)
    ids = np.zeros((4, int(lens.max())), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, 128256, size=n)
    want = ll.greedy_generate(model, ids, lens, max_new).cpu().numpy()
    eng = de.DecodeEngine(model.with_kv_layout(page, 1 + 4 * max_len // page),
                          max_slots=4, max_len=max_len, steps_per_sync=4,
                          prefill_chunk=32, device=dev)
    for i, n in enumerate(lens):
        eng.submit(i, ids[i, :n], max_new)
    got = {}
    for _ in range(1000):
        eng.step()
        got.update(dict(eng.poll()))
        if len(got) == len(lens):
            break
    mismatches = []
    for i in range(len(lens)):
        row = np.asarray(got.get(i, []))
        if len(row) == max_new and np.array_equal(row, want[i]):
            continue
        j = next((j for j in range(max_new)
                  if j >= len(row) or row[j] != want[i, j]), 0)
        seq = np.concatenate([ids[i, :lens[i]], want[i, :j]])
        logits = model(torch.from_numpy(seq[None]).long().to(dev),
                       cache=model.init_cache(1))[0, -1].float()
        top2 = torch.topk(logits, 2).values
        mismatches.append({"request": i, "step": int(j),
                           "top2_gap": float(top2[0] - top2[1])})
    emit({"phase": "f32_exactness", "requests": len(lens),
          "max_new": max_new, "token_identical": not mismatches,
          "mismatches": mismatches, "engine": eng.stats_snapshot()})
    if mismatches:
        raise AssertionError(f"paged engine diverged from greedy_generate: "
                             f"{mismatches}")
    del eng, model


def int8_bytes(model, cache):
    """The int8 deployment's device bytes beside a bf16 one's of the same
    widths: the weights (int8 base kernels and their f32 scales, against
    bf16 kernels; embedding, norms and adapters as they are) and the KV
    pool (int8 rows and f32 scales, against bf16 rows)."""
    weights = bf16_weights = 0
    for name, p in model.named_parameters():
        n = p.numel() * p.element_size()
        weights += n
        leaf = name.rsplit(".", 1)[-1]
        bf16_weights += (p.numel() * 2 if leaf == "qkernel"
                         else 0 if leaf == "qscale" else n)
    pool = sum(t.numel() * t.element_size() for c in cache
               for t in c.values())
    bf16_pool = sum(c[k].numel() * 2 for c in cache for k in ("k", "v"))
    return {"weight_bytes": weights, "bf16_weight_bytes": bf16_weights,
            "weight_share_of_bf16": weights / bf16_weights,
            "pool_bytes": pool, "bf16_pool_bytes": bf16_pool,
            "pool_share_of_bf16": pool / bf16_pool}


def serving_phase(torch, np, ll, de, pa, HashTokenizer, depth, dev,
                  int8=False):
    """Phase 4, the main path: Llama-3-8B widths behind the engines; with
    ``int8``, phase 16: the same with int8 base kernels and an int8 KV
    pool (``quantize_int8`` + ``kv_cache_int8``), whose launches count as
    the int8 kernels'."""
    vocab, max_len, page, slots, max_new = 128256, 2048, 16, 8, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ll.Llama(vocab_size=vocab, max_len=max_len, depth=depth,
                     lora_rank=16, dtype=torch.bfloat16,
                     rope_theta=500000.0, kv_page_size=page,
                     kv_pages=1 + slots * (max_len // page), device=dev,
                     generator=gen, quantized=int8, kv_int8=int8)
    randomize_lora_b(model, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = HashTokenizer(vocab)

    def encode(text):
        row, n = tok.encode(str(text), max_len)
        return np.asarray(row[:max(1, int(n))], np.int32)

    def detok(ids):
        return " ".join(f"<{int(t)}>" for t in ids)

    core = de.DecodeEngine(model, max_slots=slots, max_len=max_len,
                           steps_per_sync=4, prefill_chunk=32, device=dev)
    eng = de.TextDecodeEngine(core, encode, detok, max_new=max_new)
    rng = np.random.default_rng(SEED + 2)
    plens = rng.integers(64, 1025, size=slots)
    texts = [" ".join(f"w{int(w)}" for w in rng.integers(0, 10**6,
                                                         size=n - 1))
             for n in plens]  # n - 1 words + the leading CLS = n tokens

    pa.paged_decode_attention.launches = 0
    pa.paged_window_attention.launches = 0
    t_submit, t_first, done = {}, {}, {}
    decode_s = decode_tokens = prefill_s = 0.0
    n_steps = 0
    profiled, last_decode_only = None, False
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while len(done) < slots:
        if n_steps < slots:  # one arrival per step: mid-flight admission
            eng.submit(n_steps, texts[n_steps])
            t_submit[n_steps] = time.perf_counter()
        # one decode-only call (every request past its first token) under
        # the profiler; the profiler lengthens it, so it stays out of the
        # decode totals
        profile_now = (profiled is None and n_steps >= slots
                       and last_decode_only and len(t_first) == slots)
        before = core.stats_snapshot()
        s0 = time.perf_counter()
        if profile_now:
            profiled = _profile_call(torch, eng.step)
        else:
            eng.step()
        s1 = time.perf_counter()
        after = core.stats_snapshot()
        last_decode_only = after["prefill_calls"] == before["prefill_calls"]
        if profile_now:
            profiled.update(decode_only=last_decode_only, call_s=s1 - s0,
                            tokens=(after["tokens_generated"]
                                    - before["tokens_generated"]))
        elif last_decode_only:
            decode_s += s1 - s0
            decode_tokens += (after["tokens_generated"]
                              - before["tokens_generated"])
        else:
            prefill_s += s1 - s0
        for rid, _delta in eng.poll_partial():
            t_first.setdefault(rid, s1)
        for rid, text in eng.poll():
            done[rid] = text
            t_first.setdefault(rid, s1)
        n_steps += 1
        if n_steps > 10000:
            raise AssertionError(f"serving did not drain: {core.stats}")
    torch.cuda.synchronize()
    # the profiled call (the profiler's start and trace processing
    # included) is left out of the wall time and of its tokens
    wall = time.perf_counter() - t_start - (profiled or {}).get("call_s", 0)
    suffix = "_int8" if int8 else ""
    launches = {
        "paged_decode_attention" + suffix:
            pa.paged_decode_attention.launches,
        "paged_window_attention" + suffix:
            pa.paged_window_attention.launches}
    stats = core.stats_snapshot()
    n_tokens = {rid: len(text.split()) for rid, text in done.items()}
    ids_ok = all(0 <= int(t[1:-1]) < vocab
                 for text in done.values() for t in text.split())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra = {}
    if int8:
        # what each forward's int8 -> bf16 weight converts cost on the
        # device: every quantized kernel converted once and dropped, as
        # one decode step's forward does; its bound reads each int8
        # kernel once and writes its bf16 copy once
        qkernels = [m.qkernel for m in model.modules()
                    if isinstance(m, ll.LoRADense) and m.quantized]

        def convert_all():
            for k in qkernels:
                k.to(torch.bfloat16)

        n_elems = sum(k.numel() for k in qkernels)
        extra = dict(int8_bytes(model, core._cache),
                     weight_convert_ms_per_forward=time_ms(
                         torch, convert_all, iters=5),
                     weight_convert_bound_ms=bound_ms(
                         3 * n_elems, 0, "bfloat16")[0],
                     quantized_kernels=len(qkernels))
    emit({"phase": "int8_serving" if int8 else "serving",
          "model": "Llama-3-8B widths", "depth": depth,
          "dtype": "bfloat16", "kv_cache": "int8" if int8 else "bfloat16",
          "weights": "int8" if int8 else "bfloat16",
          "init_s": init_s, "requests": slots,
          "prompt_tokens": [int(n) for n in plens], "max_new": max_new,
          "engine_calls": n_steps, "wall_s": wall,
          "calls_with_prefill_s": prefill_s, "decode_only_calls_s": decode_s,
          "output_tok_per_s": (stats["tokens_generated"] - (
              profiled or {}).get("tokens", 0)) / wall,
          "decode_tok_per_s": (decode_tokens / decode_s if decode_s
                               else None),
          "mean_ttft_s": float(np.mean([t_first[r] - t_submit[r]
                                        for r in t_submit])),
          "launches": launches, "peak_mem_gb": peak_gb, "engine": stats,
          **extra})
    if profiled is not None:
        if "device_idle_share" in profiled:
            profiled["device_busy_share"] = 1 - profiled["device_idle_share"]
        emit({"phase": f"{'int8_' if int8 else ''}serving_decode_profile",
              "steps_per_call": core.K, **profiled})
    if sorted(done) != list(range(slots)) or any(
            n != max_new for n in n_tokens.values()) or not ids_ok:
        raise AssertionError(f"bad completions: {n_tokens}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if stats["kv_pages_used"] != 0:
        raise AssertionError(f"pages leaked: {stats['kv_pages_used']}")
    return launches


#: (floor, relative) of the per-element tolerance |kernel - plain(f32)|
#: <= floor + relative * |plain|. bf16: one rounding of the output to bf16
#: (at most 2^-8 of the element's magnitude) plus 1e-3 for the f32 sums
#: taken in another order; f32: those sums alone. Each element is held to
#: its own magnitude: a key that every row sees (the kv_len = 1 example's
#: key 0 sums 1024 rows of dO into dv) must not loosen the check on the
#: softmax-weighted entries, which are two to three orders smaller.
FLASH_TOL = {"bfloat16": (1e-3, 2.0 ** -8), "float32": (1e-5, 1e-5)}

#: max |kernel - plain| of a live row's LSE (f32 out of f32 sums over up
#: to 1024 keys, taken in another order; LSE is about 7..10 here)
LSE_TOL = 1e-4


def elementwise_err(got, ref, floor, rel):
    """(max |got - ref|, max over elements of |got - ref| / (floor +
    rel * |ref|)): the second is at most 1 when every element is within
    its own tolerance."""
    diff = (got.float() - ref).abs()
    return (diff.max().item(),
            (diff / (floor + rel * ref.abs())).max().item())


def visible_pairs(lens, s):
    """(query, key) pairs a causal call computes for one head: row i of
    example b sees keys < min(i + 1, lens[b])."""
    return sum(sum(min(i + 1, int(n)) for i in range(s)) for n in lens)


def flash_case(torch, fa, q, k, v, do, lens, sm, causal=True):
    """Run B3, B5 and B6 once and their plain versions in f32 on the same
    inputs; B5/B6 take the plain forward's lse and delta, so each kernel
    is held alone. Returns, per output, (max abs error, largest error
    over its element's tolerance), whether the rows with no visible key
    are exact, and the plain lse and delta."""
    f32 = [t.float() for t in (q, k, v, do)]
    ref_o, ref_lse = fa._flash_fwd_reference(*f32[:3], lens, sm, causal)
    delta = fa._delta(f32[3], ref_o)
    ref_dq = fa._flash_bwd_dq_reference(*f32, ref_lse, delta, lens, sm,
                                        causal)
    ref_dk, ref_dv = fa._flash_bwd_dkv_reference(*f32, ref_lse, delta,
                                                 lens, sm, causal)
    out, lse = fa.flash_attention_fwd(q, k, v, lens, sm, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, lens, sm,
                                   causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, lens,
                                        sm, causal)
    torch.cuda.synchronize()
    floor, rel = FLASH_TOL[str(q.dtype).split(".")[-1]]
    live = ref_lse < 1e29
    errs = {name: elementwise_err(got, ref, floor, rel)
            for name, got, ref in (("out", out, ref_o), ("dq", dq, ref_dq),
                                   ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    errs["lse"] = (lse_err, lse_err / LSE_TOL)
    empty = (lens == 0).nonzero().flatten().tolist()
    masked_exact = all(
        bool(torch.all(lse[i] == fa.LSE_MASKED)) and all(
            bool(torch.all(t[i] == 0)) for t in (out, dq, dk, dv))
        for i in empty)
    return errs, masked_exact, ref_lse, delta


def flash_phase(torch, np, F, fa, dev, shape=(4, 32, 8, 1024, 128),
                ptxas=()):
    """Phase 5: B3, B5 and B6 against their plain versions at Llama-3-8B
    attention shapes (b, heads, kv heads, s, head dim), and an f32 case
    at a template head dim; ``ptxas`` is the build's report."""
    b, h, n_kv, s, d = shape
    lens_np = np.array([s, s * 700 // 1024, 1, 0], np.int32)
    rng = np.random.default_rng(SEED + 5)

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    bf16 = torch.bfloat16
    q = rand((b, h, s, d), bf16)
    k = rand((b, n_kv, s, d), bf16).repeat_interleave(h // n_kv, dim=1)
    v = rand((b, n_kv, s, d), bf16).repeat_interleave(h // n_kv, dim=1)
    do = rand((b, h, s, d), bf16)
    lens = torch.from_numpy(lens_np).to(dev)
    sm = 1.0 / math.sqrt(d)
    errs, masked_exact, lse, delta = flash_case(torch, fa, q, k, v, do,
                                                lens, sm)

    # the f32 case at head dim 16 (a template width), ragged s
    lens16 = torch.tensor([300, 123], dtype=torch.int32, device=dev)
    small = [rand((2, 4, 300, 16), torch.float32) for _ in range(4)]
    errs16, masked16, _, _ = flash_case(torch, fa, *small, lens16, 0.25)

    pairs = h * visible_pairs(lens_np, s)
    # bytes the function must move: the keys below kv_len of K and V, the
    # rows of q / dO (and their f32 lse / delta) that see a key (every row
    # of an example with kv_len > 0, none of one with 0), read once; out,
    # lse, dq, dk and dv written in full
    kv_in = h * int(np.minimum(lens_np, s).sum()) * d * 2  # K or V, bf16
    q_rows = h * s * int((lens_np > 0).sum())
    q_in, row_in = q_rows * d * 2, q_rows * 4  # q or dO; lse or delta
    full, rows = b * h * s * d * 2, b * h * s * 4  # outputs
    work = {
        "flash_attention_fwd": (q_in + 2 * kv_in + full + rows,
                                4 * d * pairs),
        "flash_attention_bwd_dq": (2 * q_in + 2 * kv_in + 2 * row_in + full,
                                   6 * d * pairs),
        "flash_attention_bwd_dkv": (2 * q_in + 2 * kv_in + 2 * row_in
                                    + 2 * full, 8 * d * pairs),
    }
    kernel_calls = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, lens, sm, True),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, lens, sm, True),
    }
    plain_calls = {
        "flash_attention_fwd": lambda: fa._flash_fwd_reference(
            q, k, v, lens, sm, True),
        "flash_attention_bwd_dq": lambda: fa._flash_bwd_dq_reference(
            q, k, v, do, lse, delta, lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa._flash_bwd_dkv_reference(
            q, k, v, do, lse, delta, lens, sm, True),
    }
    # the library yardstick: SDPA with the same mask, forward and its
    # autograd backward (dq, dk and dv in one call: B5 + B6)
    mask = fa._visible(s, s, lens, True)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           scale=sm)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    library = {"flash_attention_fwd": lib_fwd,
               "flash_attention_bwd_dq": lib_bwd,
               "flash_attention_bwd_dkv": None}
    # B6's line carries whichever of dk and dv is nearer its tolerance
    worst_kv = max(("dk", "dv"), key=lambda n: errs[n][1])
    checked = {"flash_attention_fwd": errs["out"],
               "flash_attention_bwd_dq": errs["dq"],
               "flash_attention_bwd_dkv": errs[worst_kv]}
    shapes = (f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16 (K/V repeated from "
              f"{n_kv} heads), causal, kv_lens {lens_np.tolist()}")
    results = {}
    for name in FLASH:
        n_bytes, flops = work[name]
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        results[name] = dict(
            max_abs_err=checked[name][0],
            tol="per element: 1e-3 + 2^-8 * |plain|",
            err_over_tol=checked[name][1],
            ms=time_ms(torch, kernel_calls[name]),
            plain_ms=time_ms(torch, plain_calls[name]),
            library_ms=library[name], bound_ms=bnd, bound_by=by,
            bytes=n_bytes, flops=flops, visible_pairs=pairs, shapes=shapes)
    results["flash_attention_bwd_dq"]["library_covers"] = \
        "SDPA backward: dq, dk and dv in one call (B5 + B6)"
    # B3's plan and resources at this head dim, and a second call's bits
    first = fa.flash_attention_fwd(q, k, v, lens, sm, True)
    second = fa.flash_attention_fwd(q, k, v, lens, sm, True)
    torch.cuda.synchronize()
    b3_same = all(torch.equal(a, b) for a, b in zip(first, second))
    results["flash_attention_fwd"].update(
        plan=fa._flash_plan(d, q.dtype)._asdict(),
        ptxas=kernel_resources(ptxas, B3_BF16.format(d=d)),
        bit_identical_second_call=b3_same)
    del first, second
    # B5's and B6's plans and resources, and a second call's bits
    bwd_plan = fa._flash_bwd_plan(d, q.dtype)
    bwd_same = {}
    for name in FLASH[1:]:
        first = kernel_calls[name]()
        second = kernel_calls[name]()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        bwd_same[name] = all(torch.equal(a, b_)
                             for a, b_ in zip(first, second))
        del first, second
    for name, part, mangled in (("flash_attention_bwd_dq", "dq", B5_BF16),
                                ("flash_attention_bwd_dkv", "dkv",
                                 B6_BF16)):
        results[name].update(
            plan=getattr(bwd_plan, part)._asdict(),
            ptxas=kernel_resources(ptxas, mangled.format(d=d)),
            bit_identical_second_call=bwd_same[name])
    spills = {f"{name} d{d_}": e["spill_bytes"]
              for d_ in (64, 128)
              for name, mangled in (("B5", B5_BF16), ("B6", B6_BF16))
              for e in kernel_resources(ptxas, mangled.format(d=d_))
              if e["spill_bytes"]}

    # the second library yardstick: SDPA with is_causal=True on
    # full-length rows (every kv_len s), forward and backward, B3, B5 and
    # B6 on the same inputs
    full_lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    out_f, lse_f = fa.flash_attention_fwd(q, k, v, full_lens, sm, True)
    delta_f = fa._delta(do, out_f)
    del out_f
    lib_causal_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sm))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=sm)
    lib_causal = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    pairs_f = b * h * s * (s + 1) // 2
    rows_f = b * h * s
    full_work = {  # every row and key live: bytes and operations
        "flash_attention_fwd": (rows_f * d * 2 * 4 + rows_f * 4,
                                4 * d * pairs_f),
        "flash_attention_bwd_dq": (rows_f * d * 2 * 5 + rows_f * 4 * 2,
                                   6 * d * pairs_f),
        "flash_attention_bwd_dkv": (rows_f * d * 2 * 6 + rows_f * 4 * 2,
                                    8 * d * pairs_f)}
    full_calls = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(
            q, k, v, full_lens, sm, True),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse_f, delta_f, full_lens, sm, True),
        "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse_f, delta_f, full_lens, sm, True)}
    full_library = {
        "flash_attention_fwd": (lib_causal_fwd, "SDPA forward, "
                                "is_causal=True, no mask"),
        "flash_attention_bwd_dq": (lib_causal, "SDPA backward, "
                                   "is_causal=True, no mask: dq, dk and dv "
                                   "in one call (B5 + B6)"),
        "flash_attention_bwd_dkv": (None, "in B5's line (one SDPA backward "
                                    "call covers B5 + B6)")}
    for name, call in full_calls.items():
        bnd, by = bound_ms(*full_work[name], "bfloat16")
        results[name]["full_length"] = dict(
            ms=time_ms(torch, call), bound_ms=bnd, bound_by=by,
            library_ms=full_library[name][0],
            library_covers=full_library[name][1],
            shapes=f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16, causal, every "
                   f"kv_len {s}")
    del lse_f, delta_f

    def named(e):
        return {n: {"max_abs_err": a, "err_over_tol": r}
                for n, (a, r) in e.items()}

    emit({"phase": "flash_kernels", "errors": named(errs),
          "tol": f"per element: 1e-3 + 2^-8 * |plain|; lse {LSE_TOL}",
          "masked_rows_exact": masked_exact,
          "f32_d16": {"errors": named(errs16),
                      "tol": f"per element: 1e-5 + 1e-5 * |plain|; lse "
                             f"{LSE_TOL}",
                      "masked_rows_exact": masked16},
          **results})
    for case, e in (("bf16 d128", errs), ("f32 d16", errs16)):
        for what, (err, over) in e.items():
            if not over <= 1.0:
                raise AssertionError(
                    f"{case} {what} disagrees with the plain version: max "
                    f"abs error {err}, {over} x its element's tolerance")
    if not (masked_exact and masked16):
        raise AssertionError("a row with no visible key is not exactly "
                             "zero / LSE_MASKED")
    if not b3_same:
        raise AssertionError("B3: a second call on the same inputs gave "
                             "other bits")
    if not all(bwd_same.values()):
        raise AssertionError(f"B5/B6: a second call on the same inputs gave "
                             f"other bits: {bwd_same}")
    if any(results[n]["plan"]["body"] != "wgmma" for n in FLASH[1:]):
        raise AssertionError("B5/B6 bf16 did not plan the tensor-core body")
    if spills:
        raise AssertionError(f"the bf16 B5/B6 spill: {spills}")
    return results


def flash_launches(fa):
    return {name: getattr(fa, name).launches for name in FLASH}


def zero_flash_launches(fa):
    for name in FLASH:
        getattr(fa, name).launches = 0


def train_exactness_phase(torch, np, ll, fa, dev):
    """Phase 6: 4 functional train steps, f32, full width, depth 2,
    through the kernels and again from the same weights with the
    attention bound to the plain version."""
    depth, steps, lr, b, s = 2, 4, 1e-4, 2, 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = ll.Llama(vocab_size=VOCAB, max_len=s, depth=depth,
                     lora_rank=16, rope_theta=500000.0, device=dev,
                     generator=gen)
    randomize_lora_b(model, gen)
    trainable = ll.make_trainable(model, ll.lora_trainable_names(model))
    init = {n: p.detach().clone() for n, p in trainable.items()}
    rng = np.random.default_rng(SEED + 6)
    batch = ll.batch_to_device(
        {"ids": rng.integers(2, VOCAB, size=(b, s)).astype(np.int32),
         "lens": rng.integers(s // 2, s + 1, size=b).astype(np.int32)}, dev)

    def run():
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(init[n])
        state, hp = ll.lane_init(trainable, lr)
        losses = [float(ll.lane_train_step(model, state, hp, batch)[1])
                  for _ in range(steps)]
        return losses, {n: p.detach().clone() for n, p in trainable.items()}

    def plain_attention(q, k, v, sm_scale=None, causal=False, kv_lens=None,
                        block_h=None):
        scale = sm_scale or 1.0 / math.sqrt(q.shape[-1])
        return fa._attention_reference(q, k, v, scale, causal, kv_lens)

    zero_flash_launches(fa)
    k_losses, k_params = run()
    k_launches = flash_launches(fa)
    kernel_attention = ll.flash_attention
    ll.flash_attention = plain_attention  # rebinding local to this check
    try:
        p_losses, p_params = run()
    finally:
        ll.flash_attention = kernel_attention
    plain_launches = {n: c - k_launches[n]
                      for n, c in flash_launches(fa).items()}
    rel = [abs(a - b_) / abs(b_) for a, b_ in zip(k_losses, p_losses)]
    max_abs = max((k_params[n] - p_params[n]).abs().max().item()
                  for n in init)
    num = sum(float(((k_params[n] - p_params[n]) ** 2).sum()) for n in init)
    den = sum(float(((p_params[n] - init[n]) ** 2).sum()) for n in init)
    update_rel = math.sqrt(num / den)
    emit({"phase": "train_f32_exactness", "depth": depth, "steps": steps,
          "batch": [b, s], "kernel_losses": k_losses,
          "plain_losses": p_losses, "max_loss_rel": max(rel),
          "leaf_max_abs_diff": max_abs, "update_rel_diff": update_rel,
          "kernel_launches": k_launches, "plain_run_launches":
              plain_launches})
    if max(rel) > 1e-4:
        raise AssertionError(f"kernel and plain losses differ: {rel}")
    # the trained leaves: their updates (trained - init) agree to 1e-3 in
    # norm; Adam divides each gradient by its own root-mean-square, so a
    # leaf entry whose gradient is at noise level may move differently
    if update_rel > 1e-3:
        raise AssertionError(f"trained leaves differ: {update_rel}")
    if min(k_launches.values()) != depth * steps or \
            max(plain_launches.values()) != 0:
        raise AssertionError(f"launch counts: {k_launches}, "
                             f"{plain_launches}")
    del model, trainable, init, k_params, p_params


#: the port's kernels by their CUDA function names (a profiler row's name)
KERNEL_FUNCTIONS = {
    "paged_decode_attention": "paged_decode_kernel",
    "paged_window_attention": "paged_window_kernel",
    "paged_merge": "paged_merge_kernel",
    "flash_attention_fwd": "flash_fwd_kernel",
    "flash_attention_fwd_mh": "flash_fwd_mh_kernel",
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel",
                               "flash_bwd_dq_mma_kernel"),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",
                                "flash_bwd_dkv_mma_kernel"),
    "matmul_bias": ("matmul_bias_mma_kernel", "matmul_bias_fma_kernel"),
}


def _kernel_time_split(torch, prof):
    """Device time by class from a profiler run, in ms, over the device's
    kernel rows only (a CPU operator's row, and a ``record_function``
    range drawn on the device, repeat the time of the kernels under
    them): the total, each port kernel's, cuBLAS's, the rest, and the
    largest rows."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    total = sum(t for _, t in rows)
    ours = {name: sum(t for n, t in rows if any(
        f + "<" in n or f + "(" in n or n.endswith(f)
        for f in ((fn,) if isinstance(fn, str) else fn)))
        for name, fn in KERNEL_FUNCTIONS.items()}
    mm = sum(t for n, t in rows if any(w in n.lower() for w in (
        "gemm", "xmma", "nvjet", "cutlass", "cublas")))
    top = sorted(rows, key=lambda r: -r[1])[:12]
    return {"device_ms": total, "kernels_ms": ours, "cublas_ms": mm,
            "other_ms": total - sum(ours.values()) - mm,
            "top_kernels": [(n[:90], t) for n, t in top]}


def training_phase(torch, np, ll, fa, depth, dev):
    """Phase 7, the training main path: Llama-3-8B widths, bf16 compute,
    f32 trainable leaves, 4 steps on one repeated batch."""
    vocab, s, steps, lr = VOCAB, 1024, 4, 1e-4
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(2, vocab, size=(4, s)).astype(np.int32)
    lens = rng.integers(512, s + 1, size=4).astype(np.int32)
    cuts = []

    def attempt(b, depth):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        model = ll.Llama(vocab_size=vocab, max_len=s, depth=depth,
                         lora_rank=16, dtype=torch.bfloat16,
                         rope_theta=500000.0, device=dev, generator=gen)
        randomize_lora_b(model, gen)
        trainable = ll.make_trainable(model, ll.lora_trainable_names(model))
        state, hp = ll.lane_init(trainable, lr)
        batch = ll.batch_to_device({"ids": ids[:b], "lens": lens[:b]}, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        zero_flash_launches(fa)
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(float(ll.lane_train_step(
                model, state, hp, batch)[1]))  # syncs
            step_s.append(time.perf_counter() - t)
        launches = flash_launches(fa)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one more step under the profiler: device time by kernel class.
        # Only the profiler's own failures are recorded and passed over;
        # an error of the step itself (a kernel's launch) propagates.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            float(ll.lane_train_step(model, state, hp, batch)[1])
            prof_wall = (time.perf_counter() - t) * 1e3
        try:
            split = _kernel_time_split(torch, prof)
            attn = sum(split["kernels_ms"].values())
            profile_line = {"wall_ms": prof_wall,
                            "device_ms": split["device_ms"],
                            "flash_ms": attn, "matmul_ms": split["cublas_ms"],
                            "other_ms": split["other_ms"],
                            "device_idle_share":
                                1 - split["device_ms"] / prof_wall,
                            "top_kernels": split["top_kernels"]}
        except Exception as exc:  # reading the trace: a measurement
            profile_line = {"failed": repr(exc)}
        return dict(b=b, depth=depth, init_s=init_s, losses=losses,
                    step_s=step_s, launches=launches, peak_mem_gb=peak,
                    profile=profile_line)

    b = 4
    while True:
        try:
            r = attempt(b, depth)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        torch.cuda.empty_cache()
        if b > 1:
            b //= 2
            cuts.append(f"out of memory: batch cut to {b}")
        elif depth > 1:
            depth //= 2
            cuts.append(f"out of memory: depth cut to {depth}")
        else:
            raise AssertionError("the training leg does not fit")
        print(f"chip_smoke: {cuts[-1]}", flush=True)
    tokens = r["b"] * s
    steady = r["step_s"][1:]
    emit({"phase": "training", "model": "Llama-3-8B widths",
          "depth": r["depth"], "dtype": "bfloat16 compute, f32 trainable",
          "batch": [r["b"], s], "lens": lens[:r["b"]].tolist(),
          "steps": steps, "lr": lr, "init_s": r["init_s"],
          "losses": r["losses"], "step_s": r["step_s"],
          "tokens_per_step": tokens, "real_tokens_per_step":
              int(lens[:r["b"]].sum()),
          "train_tok_per_s": tokens * len(steady) / sum(steady),
          "peak_mem_gb": r["peak_mem_gb"], "launches": r["launches"],
          "cuts": cuts, "profiled_step": r["profile"]})
    want = r["depth"] * steps
    if any(n != want for n in r["launches"].values()):
        raise AssertionError(f"flash launches {r['launches']} != depth x "
                             f"steps = {want}")
    if not all(math.isfinite(x) for x in r["losses"]):
        raise AssertionError(f"non-finite loss: {r['losses']}")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"the loss did not fall: {r['losses']}")
    return r["launches"]


def write_corpus(np, path, n, seed, vocab=500, n_classes=4, max_words=120):
    """A learnable ``.jsonl`` text corpus: class-conditional unigram
    mixtures over ``tok<i>`` words, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    dists = np.random.default_rng(7 + vocab).dirichlet(
        np.ones(vocab) * 0.05, size=n_classes)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"n_classes": n_classes}) + "\n")
        for _ in range(n):
            c = int(rng.integers(0, n_classes))
            words = rng.choice(vocab, size=int(rng.integers(5, max_words)),
                               p=dists[c])
            f.write(json.dumps({"text": " ".join(f"tok{w}" for w in words),
                                "label": c}) + "\n")
    return str(path)


def template_phase(torch, np, ll, TrainContext, dev):
    """Phase 8: the LlamaLoRA template at its largest knobs, train →
    evaluate → dump → reload → evaluate → predict."""
    knobs = {"max_epochs": 2, "vocab_size": 1 << 14, "hidden_dim": 512,
             "depth": 8, "n_heads": 4, "kv_ratio": 2, "lora_rank": 16,
             "max_len": 128, "model_parallel": 1, "learning_rate": 3e-3,
             "lora_scale": 1.0, "batch_size": 32, "bf16": True}
    work = ROOT / "build" / "chip_smoke"
    train = write_corpus(np, work / "train.jsonl", 512, SEED + 8)
    val = write_corpus(np, work / "val.jsonl", 128, SEED + 9)
    m = ll.LlamaLoRA(device=dev, **knobs)
    ctx = TrainContext()
    t0 = time.perf_counter()
    m.train(train, ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    score = m.evaluate(val)
    blob = m.dump_parameters()
    fresh = ll.LlamaLoRA(device=dev, **knobs)
    fresh.load_parameters(blob)
    reloaded = fresh.evaluate(val)
    preds = fresh.predict(["tok1 tok5 tok9", "tok3"], max_new_tokens=8)
    emit({"phase": "template", "knobs": knobs, "train_s": train_s,
          "epoch_losses": ctx.logger.get_values("loss"), "score": score,
          "reloaded_score": reloaded, "predictions": preds})
    if not 0.0 < score <= 1.0:
        raise AssertionError(f"score {score} is not in (0, 1]")
    if reloaded != score:
        raise AssertionError(f"reloaded score {reloaded} != {score}")
    if len(preds) != 2 or any(len(p.split()) != 8 for p in preds):
        raise AssertionError(f"bad predictions: {preds}")


# ---------------------------------------------------------------- ViT / BERT

#: training knobs: one epoch of 8 steps, the first two warming up (step
#: 0 at lr 0, as optax's schedule gives). At lr 3e-4 without warmup the
#: ViT-B/16 leg diverged from its random weights (loss 3.0 -> 6.0 by
#: step 3 on an H100); these rates with the warmup make both losses fall
VIT_KNOBS = {"patch_size": 16, "hidden_dim": 768, "depth": 12,
             "n_heads": 12, "batch_size": 64, "max_epochs": 1,
             "learning_rate": 5e-5, "weight_decay": 1e-4,
             "warmup_frac": 0.25, "bf16": True, "remat": False,
             "quick_train": False, "share_params": False}
BERT_KNOBS = {"vocab_size": 32768, "hidden_dim": 768, "depth": 12,
              "n_heads": 12, "max_len": 128, "batch_size": 64,
              "max_epochs": 1, "learning_rate": 2e-5, "weight_decay": 1e-4,
              "warmup_frac": 0.25, "bf16": True, "quick_train": False,
              "share_params": False}
VIT_IMAGE = (224, 224, 3)
#: per-element tolerance of B7 against its plain version run in f32:
#: bf16, one rounding of the output plus 1e-3; f32, the sums alone
MATMUL_TOL = FLASH_TOL


def matmul_bias_phase(torch, np, pe, dev, ptxas=()):
    """Phase 9: B7 against its plain version at ViT-B/16's serving shape,
    (64·196, 768) x (768, 768) + (768,), in bf16 and f32; ``ptxas`` is the
    build's report."""
    p, n = VIT_KNOBS["patch_size"], VIT_KNOBS["hidden_dim"]
    rng = np.random.default_rng(SEED + 9)
    images = torch.from_numpy(rng.uniform(-1, 1, (64, *VIT_IMAGE)).astype(
        np.float32)).to(dev)
    x32 = pe.extract_patches(images, p)
    x32 = x32.reshape(-1, x32.shape[-1]).contiguous()
    m, k = x32.shape
    w32 = torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k))
                           .astype(np.float32)).to(dev)
    b32 = torch.from_numpy(0.02 * rng.standard_normal(n).astype(
        np.float32)).to(dev)
    errs = {}
    for name, dt in (("bfloat16", torch.bfloat16),
                     ("float32", torch.float32)):
        x, w, b = (t.to(dt) for t in (x32, w32, b32))
        got = pe.matmul_bias(x, w, b)
        ref = pe._matmul_bias_reference(x.float(), w.float(), b.float())
        torch.cuda.synchronize()
        errs[name] = elementwise_err(got, ref, *MATMUL_TOL[name])
    x, w, b = (t.to(torch.bfloat16) for t in (x32, w32, b32))
    first = pe.matmul_bias(x, w, b)
    second = pe.matmul_bias(x, w, b)
    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    del first, second
    n_bytes = 2 * (m * k + k * n + n + m * n)
    flops = 2 * m * n * k
    bnd, by = bound_ms(n_bytes, flops, "bfloat16")
    result = dict(
        max_abs_err=errs["bfloat16"][0], err_over_tol=errs["bfloat16"][1],
        tol="per element: 1e-3 + 2^-8 * |plain|",
        ms=time_ms(torch, lambda: pe.matmul_bias(x, w, b)),
        plain_ms=time_ms(torch, lambda: pe._matmul_bias_reference(x, w, b)),
        library_ms=time_ms(torch, lambda: torch.addmm(b, x, w)),
        library_covers="torch.addmm in bf16 (cuBLAS)",
        bound_ms=bnd, bound_by=by, bytes=n_bytes, flops=flops,
        plan=pe._matmul_plan(m, n, k, torch.bfloat16)._asdict(),
        ptxas=kernel_resources(ptxas, B7_MMA),
        bit_identical_second_call=same,
        shapes=f"x ({m}, {k}) bf16 (64 ViT-B/16 images' patches), "
               f"w ({k}, {n}), b ({n},)")
    emit({"phase": "matmul_bias", "errors": {
        dt: {"max_abs_err": a, "err_over_tol": r}
        for dt, (a, r) in errs.items()},
        "tol": "per element: bf16 1e-3 + 2^-8 * |plain|, f32 1e-5 + "
               "1e-5 * |plain|", **result})
    for dt, (err, over) in errs.items():
        if not over <= 1.0:
            raise AssertionError(f"B7 {dt} disagrees with its plain version:"
                                 f" max abs error {err}, {over} x tolerance")
    if not same:
        raise AssertionError("B7: a second call on the same inputs gave "
                             "other bits")
    return {"matmul_bias": result}


def classifier_flash_phase(torch, np, F, fa, dev, vit_shape=(64, 12, 197, 64),
                           bert_shape=(64, 12, 128, 64), ptxas=()):
    """Phase 10: the flash kernels on the ViT and BERT paths. B3/B5/B6
    non-causal at ViT-B/16's shape (b 64, 12 heads, s 197, d 64, bf16) and
    with BERT's padded keys (s 128); B4 at block_h 4 on the ViT shape
    against its plain version and against B3 (bit-identical); B3/B5/B6 at
    every compiled head dim on a small ragged shape, f32 and bf16;
    ``ptxas`` is the build's report."""
    rng = np.random.default_rng(SEED + 10)

    def rand(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)

    bf16 = torch.bfloat16
    b, h, s, d = vit_shape
    q, k, v, do = (rand((b, h, s, d), bf16) for _ in range(4))
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    sm = 1.0 / math.sqrt(d)
    vit_errs, vit_exact, lse, delta = flash_case(torch, fa, q, k, v, do,
                                                 full, sm, causal=False)

    # B4 at block_h 4: the serving forward (no LSE) and the training one
    out3, lse3 = fa.flash_attention_fwd(q, k, v, full, sm, False)
    out4, lse4 = fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4)
    ref_o, _ = fa._flash_fwd_reference(q.float(), k.float(), v.float(), full,
                                       sm, False)
    again4, _ = fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4)
    torch.cuda.synchronize()
    b4_err = elementwise_err(out4, ref_o, *FLASH_TOL["bfloat16"])
    b4_identical = bool(torch.equal(out4, out3) and torch.equal(lse4, lse3))
    b4_same = bool(torch.equal(again4, out4))
    del again4

    pairs = b * h * s * s
    qkv_bytes = b * h * s * d * 2  # one of q / k / v / out / dO, bf16
    rows = b * h * s * 4           # one f32 per row: lse or delta
    work = {
        "flash_attention_fwd": (4 * qkv_bytes + rows, 4 * d * pairs),
        "flash_attention_fwd_mh": (4 * qkv_bytes, 4 * d * pairs),
        "flash_attention_bwd_dq": (5 * qkv_bytes + 2 * rows, 6 * d * pairs),
        "flash_attention_bwd_dkv": (6 * qkv_bytes + 2 * rows,
                                    8 * d * pairs),
    }
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, full, sm, False),
            lambda: fa._flash_fwd_reference(q, k, v, full, sm, False)),
        "flash_attention_fwd_mh": (
            lambda: fa.flash_attention_fwd_mh(q, k, v, full, sm, False, 4,
                                              with_lse=False),
            lambda: fa._flash_fwd_reference(q, k, v, full, sm, False)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, full,
                                              sm, False),
            lambda: fa._flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                               full, sm, False)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, full,
                                               sm, False),
            lambda: fa._flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                full, sm, False)),
    }
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, scale=sm))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=sm)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True))
    del o_lib, leaves
    library = {"flash_attention_fwd": lib_fwd,
               "flash_attention_fwd_mh": lib_fwd,
               "flash_attention_bwd_dq": lib_bwd,
               "flash_attention_bwd_dkv": None}
    worst_kv = max(("dk", "dv"), key=lambda n: vit_errs[n][1])
    checked = {"flash_attention_fwd": vit_errs["out"],
               "flash_attention_fwd_mh": b4_err,
               "flash_attention_bwd_dq": vit_errs["dq"],
               "flash_attention_bwd_dkv": vit_errs[worst_kv]}
    shapes = f"q/k/v/dO ({b}, {h}, {s}, {d}) bf16, non-causal, no mask"
    vit = {}
    for name, (kern, plain) in calls.items():
        n_bytes, flops = work[name]
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        vit[name] = dict(
            max_abs_err=checked[name][0], err_over_tol=checked[name][1],
            tol="per element: 1e-3 + 2^-8 * |plain|",
            ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
            library_ms=library[name], bound_ms=bnd, bound_by=by,
            bytes=n_bytes, flops=flops, shapes=shapes)
    # B3 at the same shape and the same (serving, no-LSE) forward: what
    # the head tile buys
    plan = fa._flash_plan(d, bf16)._asdict()
    vit["flash_attention_fwd_mh"].update(
        shapes=shapes + ", block_h 4, no LSE (the serving forward)",
        identical_to_b3=b4_identical, bit_identical_second_call=b4_same,
        b3_same_call_ms=time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, full, sm, False, with_lse=False)),
        plan=plan, ptxas=kernel_resources(ptxas, B4_BF16.format(d=d)))
    vit["flash_attention_fwd"].update(
        plan=plan, ptxas=kernel_resources(ptxas, B3_BF16.format(d=d)))
    vit["flash_attention_bwd_dq"]["library_covers"] = \
        "SDPA backward: dq, dk and dv in one call (B5 + B6)"
    for name, part in (("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        vit[name].update(plan=getattr(fa._flash_bwd_plan(d, bf16),
                                      part)._asdict())
    del q, k, v, do, lse, delta, out3, out4, lse3, lse4, ref_o

    # BERT-base's padded keys: b 64, 12 heads, s 128, d 64
    bb, _, bs, bd = bert_shape
    lens_np = rng.integers(6, bs + 1, size=bb).astype(np.int32)
    lens_np[:2] = (bs, 1)
    bert_in = [rand(bert_shape, bf16) for _ in range(4)]
    blens = torch.from_numpy(lens_np).to(dev)
    bsm = 1.0 / math.sqrt(bd)
    bert_errs, bert_exact, blse, bdelta = flash_case(
        torch, fa, *bert_in, blens, bsm, causal=False)
    # B5 and B6 at BERT's shape beside SDPA's backward with the same mask
    bmask = fa._visible(bs, bs, blens, False)
    leaves = [t.detach().clone().requires_grad_() for t in bert_in[:3]]
    o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=bmask,
                                           scale=bsm)
    bert_bwd = {
        "flash_attention_bwd_dq": time_ms(
            torch, lambda: fa.flash_attention_bwd_dq(
                *bert_in, blse, bdelta, blens, bsm, False)),
        "flash_attention_bwd_dkv": time_ms(
            torch, lambda: fa.flash_attention_bwd_dkv(
                *bert_in, blse, bdelta, blens, bsm, False)),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, bert_in[3], retain_graph=True)),
        "library_covers": "SDPA backward with the same boolean mask: dq, "
                          "dk and dv in one call (B5 + B6)",
        "shapes": f"q/k/v/dO {tuple(bert_shape)} bf16, non-causal, kv_lens "
                  f"{bs}, 1 and 6..{bs}"}
    del bert_in, o_lib, leaves, blse, bdelta
    # their least time there: each input read once (K and V only up to
    # each example's kv_len), each output written once; every row sees
    # its example's kv_len keys
    bh = bert_shape[1]
    rows_b = bb * bh * bs * bd * 2           # q, dO, dq, dk or dv, bf16
    kv_vis = int(lens_np.sum()) * bh * bd * 2  # the visible K (or V) rows
    bpairs = bh * bs * int(lens_np.sum())
    for name, n_bytes, flops in (
            ("flash_attention_bwd_dq", 3 * rows_b + 2 * kv_vis
             + 2 * bb * bh * bs * 4, 6 * bd * bpairs),
            ("flash_attention_bwd_dkv", 4 * rows_b + 2 * kv_vis
             + 2 * bb * bh * bs * 4, 8 * bd * bpairs)):
        bnd, by = bound_ms(n_bytes, flops, "bfloat16")
        bert_bwd[name + "_bound"] = {"bound_ms": bnd, "bound_by": by,
                                     "bytes": n_bytes, "flops": flops}

    # every compiled head dim: b 2 (kv_lens 150 and 0, or 1), 3 heads,
    # s 150, both masks
    sweep = {}
    for d_ in fa.HEAD_DIMS:
        for dt in ("float32", "bfloat16"):
            for causal in (False, True):
                lens = torch.tensor([150, 0 if causal else 1],
                                    dtype=torch.int32, device=dev)
                ins = [rand((2, 3, 150, d_), getattr(torch, dt))
                       for _ in range(4)]
                e, exact, _, _ = flash_case(torch, fa, *ins, lens,
                                            1.0 / math.sqrt(d_), causal)
                sweep[f"d{d_} {dt} {'causal' if causal else 'full'}"] = (
                    max(r for _, r in e.values()), exact)

    def named(e):
        return {n: {"max_abs_err": a, "err_over_tol": r}
                for n, (a, r) in e.items()}

    emit({"phase": "classifier_flash_kernels",
          "vit": {"errors": named(vit_errs), "masked_rows_exact": vit_exact,
                  "b4": {"max_abs_err": b4_err[0],
                         "err_over_tol": b4_err[1],
                         "identical_to_b3": b4_identical}, **vit},
          "bert": {"errors": named(bert_errs), "kv_lens": lens_np.tolist(),
                   "masked_rows_exact": bert_exact,
                   "backward_ms": bert_bwd},
          "head_dim_sweep_worst_err_over_tol": {
              key: r for key, (r, _) in sweep.items()},
          "tol": f"per element: bf16 1e-3 + 2^-8 * |plain|, f32 1e-5 + "
                 f"1e-5 * |plain|; lse {LSE_TOL}"})
    failed = [f"vit {w}" for w, (_, r) in vit_errs.items() if r > 1.0]
    failed += [f"bert {w}" for w, (_, r) in bert_errs.items() if r > 1.0]
    failed += [key for key, (r, exact) in sweep.items()
               if r > 1.0 or not exact]
    if b4_err[1] > 1.0:
        failed.append("b4")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    if not b4_identical:
        raise AssertionError("B4 is not bit-identical to B3")
    if not b4_same:
        raise AssertionError("B4: a second call on the same inputs gave "
                             "other bits")
    if not bert_exact:
        raise AssertionError("a BERT row with no visible key is not exact")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        vit[name]["bert_ms"] = bert_bwd[name]
        vit[name]["bert_bound"] = bert_bwd[name + "_bound"]
    vit["flash_attention_bwd_dq"]["bert_library_ms"] = bert_bwd["library_ms"]
    return vit


def all_launches(fa, pe):
    out = flash_launches(fa)
    out["flash_attention_fwd_mh"] = fa.flash_attention_fwd_mh.launches
    out["matmul_bias"] = pe.matmul_bias.launches
    return out


def zero_all_launches(fa, pe):
    zero_flash_launches(fa)
    fa.flash_attention_fwd_mh.launches = 0
    pe.matmul_bias.launches = 0


def classifier_exactness_phase(torch, np, vit, bert, fa, pe, lp, optim, dev):
    """Phase 11: a small ViT (head dim 96) and a small BERT (head dim 24)
    in f32 through the kernels, against the same modules with the plain
    attention and plain matmul_bias: logits, then the per-step losses of
    4 AdamW steps from the same weights, within 1e-5 relative."""
    rng = np.random.default_rng(SEED + 11)
    steps = 4

    def plain_attention(q, k, v, sm_scale=None, causal=False, kv_lens=None,
                        block_h=None):
        scale = sm_scale or 1.0 / math.sqrt(q.shape[-1])
        return fa._attention_reference(q, k, v, scale, causal, kv_lens)

    cases = {
        "vit": (lambda gen: vit.ViT(
            patch_size=16, hidden_dim=384, depth=2, n_heads=4, mlp_dim=1536,
            n_classes=10, image_shape=(64, 64, 3), device=dev,
            generator=gen),
            (torch.from_numpy(rng.uniform(-1, 1, (8, 64, 64, 3)).astype(
                np.float32)).to(dev),)),
        "bert": (lambda gen: bert.Bert(
            vocab_size=1024, max_len=64, hidden_dim=192, depth=2, n_heads=8,
            mlp_dim=768, n_classes=4, device=dev, generator=gen),
            (torch.from_numpy(rng.integers(2, 1024, (8, 64))).to(dev),
             torch.tensor([64, 1, 30, 5, 64, 17, 2, 50], dtype=torch.int32,
                          device=dev))),
    }
    y = torch.from_numpy(rng.integers(0, 4, 8)).to(dev)
    mask = torch.ones(8, device=dev)
    report = {}
    for name, (make, inputs) in cases.items():
        model = make(torch.Generator(device=dev).manual_seed(SEED))
        init = {n: p.detach().clone() for n, p in model.state_dict().items()}

        def run():
            model.load_state_dict(init)
            with torch.no_grad():
                logits = model(*inputs)
            opt, sched = optim.adamw(model.parameters(), 3e-5, 1, steps,
                                     1e-4)
            losses = []
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = lp.masked_ce(model(*inputs), y, mask)
                loss.backward()
                opt.step()
                sched.step()
                losses.append(float(loss.detach()))
            return logits, losses

        zero_all_launches(fa, pe)
        k_logits, k_losses = run()
        k_launches = all_launches(fa, pe)
        saved = (vit.flash_attention, bert.flash_attention, pe.matmul_bias)
        vit.flash_attention = bert.flash_attention = plain_attention
        pe.matmul_bias = pe._matmul_bias_reference  # local to this check
        try:
            p_logits, p_losses = run()
        finally:
            vit.flash_attention, bert.flash_attention, pe.matmul_bias = saved
        plain_launches = {n: c - k_launches[n]
                          for n, c in all_launches(fa, pe).items()}
        logit_rel = ((k_logits - p_logits).abs().max()
                     / p_logits.abs().max()).item()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses,
                                                           p_losses))
        report[name] = {"logits_max_rel": logit_rel,
                        "kernel_losses": k_losses, "plain_losses": p_losses,
                        "max_loss_rel": loss_rel,
                        "kernel_launches": k_launches,
                        "plain_run_launches": plain_launches}
        del model, init
    emit({"phase": "classifier_f32_exactness", "steps": steps,
          "vit": "patch 16, 64x64x3, hidden 384, 4 heads (d 96), depth 2",
          "bert": "hidden 192, 8 heads (d 24), depth 2, s 64, padded keys",
          **report})
    for name, r in report.items():
        if r["logits_max_rel"] > 1e-5 or r["max_loss_rel"] > 1e-5:
            raise AssertionError(f"{name}: kernels and plain versions "
                                 f"differ: {r}")
        want = {"flash_attention_fwd": 2 + 2 * steps,  # eval + train
                "flash_attention_bwd_dq": 2 * steps,
                "flash_attention_bwd_dkv": 2 * steps,
                "matmul_bias": (1 + steps) if name == "vit" else 0,
                "flash_attention_fwd_mh": 0}
        if r["kernel_launches"] != want or \
                max(r["plain_run_launches"].values()) != 0:
            raise AssertionError(f"{name} launch counts: {r}, want {want}")


def vit_blob(torch, vit, store, dev, n_classes):
    """A seeded ViT-B/16 as a template blob (random weights, seed 0)."""
    k = VIT_KNOBS
    net = vit.ViT(patch_size=k["patch_size"], hidden_dim=k["hidden_dim"],
                  depth=k["depth"], n_heads=k["n_heads"],
                  mlp_dim=4 * k["hidden_dim"], n_classes=n_classes,
                  image_shape=VIT_IMAGE, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    blob = {"params": store.params_to_jax(net.state_dict()),
            "meta": {"n_classes": n_classes, "image_shape": list(VIT_IMAGE),
                     "prep_version": 2}}
    del net
    return blob


def _profile_call(torch, fn):
    """``fn()`` once under ``torch.profiler``: its wall time, the device
    time by class and the device's idle share of the call. Only reading
    the trace is guarded; an error of ``fn`` propagates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    try:
        split = _kernel_time_split(torch, prof)
        return dict(wall_ms=wall, **split,
                    device_idle_share=1 - split["device_ms"] / wall)
    except Exception as exc:  # reading the trace: a measurement
        return {"wall_ms": wall, "failed": repr(exc)}


def _serve(torch, np, m, queries, fa, pe):
    """One timed ``predict`` over ``queries`` with the launch counts zeroed
    just before and read just after."""
    torch.cuda.synchronize()
    zero_all_launches(fa, pe)
    t0 = time.perf_counter()
    probs = np.asarray(m.predict(queries))
    wall = time.perf_counter() - t0
    return probs, wall, all_launches(fa, pe)


def vit_serving_phase(torch, np, vit, store, fa, pe, dev):
    """Phase 12, the ViT serving path: ViT-B/16 (bf16, random weights
    from seed 0, 1000 classes) behind ``ViTBase16.predict``: 256 seeded
    224 x 224 x 3 images (4 buckets of 64), the p50 latency of a 1-image
    predict over 20 calls, then the same 256 with the block_h default at
    4 (B4), then dump → reload → predict."""
    n_img, buckets = 256, 4
    m = vit.ViTBase16(device=dev, **VIT_KNOBS)
    m.load_parameters(vit_blob(torch, vit, store, dev, 1000))
    rng = np.random.default_rng(SEED + 12)
    images = list(rng.integers(0, 256, (n_img, *VIT_IMAGE), dtype=np.uint8))
    m.warmup()  # builds the serving net; one bucket
    torch.cuda.reset_peak_memory_stats()
    probs, wall, launches = _serve(torch, np, m, images, fa, pe)
    peak = torch.cuda.max_memory_allocated() / 1e9
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        m.predict([images[i]])
        lat.append(time.perf_counter() - t0)
    profiled = _profile_call(torch, lambda: m.predict(images[:64]))
    DIRECT_VIT.update(images_per_s=n_img / wall,
                      p50_latency_1_image_s=float(np.median(lat)))
    try:
        fa.ATTN_BLOCK_H = 4  # the fleet-wide default, as the env sets it
        probs4, wall4, launches4 = _serve(torch, np, m, images, fa, pe)
    finally:
        fa.ATTN_BLOCK_H = 1
    fresh = vit.ViTBase16(device=dev, **VIT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(images[:64]))
    del fresh
    emit({"phase": "vit_serving", "model": "ViT-B/16", "dtype": "bfloat16",
          "images": n_img, "buckets": buckets, "wall_s": wall,
          "images_per_s": n_img / wall,
          "p50_latency_1_image_s": float(np.median(lat)),
          "latencies_1_image_s": lat, "peak_mem_gb": peak,
          "launches": launches, "profiled_64_images": profiled,
          "block_h4": {"wall_s": wall4, "images_per_s": n_img / wall4,
                       "launches": launches4,
                       "probs_identical": bool(np.array_equal(probs4,
                                                              probs)),
                       "probs_max_abs_diff":
                           float(np.abs(probs4 - probs).max())},
          "reload_identical": bool(np.array_equal(reloaded, probs[:64]))})
    if probs.shape != (n_img, 1000) or not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"bad probabilities: {probs.shape}")
    depth = VIT_KNOBS["depth"]
    if launches["matmul_bias"] != buckets or \
            launches["flash_attention_fwd"] != depth * buckets or \
            launches["flash_attention_fwd_mh"] != 0:
        raise AssertionError(f"ViT serving launches {launches}")
    if launches4["flash_attention_fwd_mh"] != depth * buckets or \
            launches4["flash_attention_fwd"] != 0 or \
            launches4["matmul_bias"] != buckets:
        raise AssertionError(f"block_h 4 launches {launches4}")
    if not np.array_equal(probs4, probs):
        raise AssertionError("block_h 4 changed the probabilities")
    if not np.array_equal(reloaded, probs[:64]):
        raise AssertionError("dump → reload → predict differs")
    return {"vit_serving": launches, "vit_serving_block_h4": launches4}


def write_images(np, path, n, seed, n_classes=10):
    """A learnable ``.npz`` image set: each class a fixed low-frequency
    7 x 7 x 3 pattern upsampled to 224 x 224, plus noise, as uint8."""
    rng = np.random.default_rng(seed)
    coarse = np.random.default_rng(7).normal(0, 1, (n_classes, 7, 7, 3))
    h, w, _ = VIT_IMAGE
    reps = -(-max(h, w) // 7)
    templates = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)[
        :, :h, :w].astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int64)
    x = templates[labels]
    x += 0.5 * rng.standard_normal(x.shape, dtype=np.float32)
    images = np.clip((x + 4.5) * (255 / 9.0), 0, 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, images=images, labels=labels,
             n_classes=np.asarray(n_classes))
    return str(path), images


def _train_timed(torch, template, path, ctx, lp, fa, pe, profile_step):
    """``template.train(path)`` with every step timed (synchronized) and
    its loss read, the host's wait for each batch timed
    (``loader_wait_s``), one step under ``torch.profiler``, and the
    launch counts zeroed just before and read just after.
    ``train_epoch`` is rebound for this run only."""
    from torch.profiler import ProfilerActivity, profile

    losses, step_s, wait_s, prof_line = [], [], [], {}
    real_epoch = lp.train_epoch

    def timed_batches(batches):
        it = iter(batches)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            wait_s.append(time.perf_counter() - t)
            yield batch

    def timed_epoch(step, state, batches):
        def timed(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if len(losses) == profile_step:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, loss = step(state, batch)
                    value = float(loss)  # syncs
                wall = (time.perf_counter() - t) * 1e3
                try:
                    split = _kernel_time_split(torch, prof)
                    prof_line.update(wall_ms=wall, **split,
                                     device_idle_share=1 - split["device_ms"]
                                     / wall)
                except Exception as exc:  # reading the trace only
                    prof_line.update(failed=repr(exc))
            else:
                state, loss = step(state, batch)
                value = float(loss)
            step_s.append(time.perf_counter() - t)
            losses.append(value)
            return state, loss
        return real_epoch(timed, state, timed_batches(batches))

    lp.train_epoch = timed_epoch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_all_launches(fa, pe)
        t0 = time.perf_counter()
        template.train(path, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches(fa, pe)
    finally:
        lp.train_epoch = real_epoch
    return dict(losses=losses, step_s=step_s, loader_wait_s=wait_s,
                wall_s=wall, launches=launches, profiled_step=prof_line,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _idle(r, steady):
    """1 - the profiled step's device time over the mean steady step's
    wall time (the profiler lengthens the step it records)."""
    device_ms = r["profiled_step"].get("device_ms")
    if device_ms is None:
        return None
    return 1 - device_ms / (1e3 * float(sum(steady) / len(steady)))


def _check_training(name, r, want):
    """Launch counts, finite losses, and a falling loss: each step sees a
    new batch, so the mean of the last two steps must be below that of
    the first two."""
    if r["launches"] != want:
        raise AssertionError(f"{name} launches {r['launches']} != {want}")
    losses = r["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if not sum(losses[-2:]) < sum(losses[:2]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")


def vit_training_phase(torch, np, vit, lp, TrainContext, fa, pe, dev):
    """Phase 13, the ViT training path: ``ViTBase16.train`` at ViT-B/16
    (bf16 compute, f32 params) on a seeded 512-image npz, batch 64, one
    epoch of 8 steps; step 7 under the profiler; then dump → reload →
    predict."""
    steps, batch = 8, VIT_KNOBS["batch_size"]
    path, images = write_images(np, ROOT / "build" / "chip_smoke" /
                                "vit_train.npz", steps * batch, SEED + 13)
    m = vit.ViTBase16(device=dev, **VIT_KNOBS)
    ctx = TrainContext()
    r = _train_timed(torch, m, path, ctx, lp, fa, pe, profile_step=steps - 1)
    steady = r["step_s"][1:-1]  # not the first, not the profiled one
    queries = list(images[:64])
    probs = np.asarray(m.predict(queries))
    fresh = vit.ViTBase16(device=dev, **VIT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(queries))
    del fresh, m
    emit({"phase": "vit_training", "model": "ViT-B/16",
          "dtype": "bfloat16 compute, f32 params", "batch": batch,
          "steps": steps, "knobs": VIT_KNOBS, "losses": r["losses"],
          "epoch_loss": ctx.logger.get_values("loss"), "step_s": r["step_s"],
          "steady_step_s": float(np.mean(steady)),
          "images_per_s": batch / float(np.mean(steady)),
          "wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
          "launches": r["launches"], "profiled_step": r["profiled_step"],
          "device_idle_share_of_steady_step": _idle(r, steady),
          "reload_identical": bool(np.array_equal(reloaded, probs))})
    depth = VIT_KNOBS["depth"]
    _check_training("ViT", r, {
        "flash_attention_fwd": depth * steps,
        "flash_attention_bwd_dq": depth * steps,
        "flash_attention_bwd_dkv": depth * steps,
        "flash_attention_fwd_mh": 0, "matmul_bias": steps})
    if not np.array_equal(reloaded, probs):
        raise AssertionError("ViT dump → reload → predict differs")
    return {"vit_training": r["launches"]}


def bert_phase(torch, np, bert, lp, TrainContext, fa, pe, dev):
    """Phase 14, the BERT path: ``BertClassifier`` at BERT-base (bf16
    compute, f32 params, vocab 32768, max_len 128) trains one epoch of 8
    steps at batch 64 on a seeded corpus, then predicts 256 texts (4
    buckets); dump → reload → predict."""
    steps, batch = 8, BERT_KNOBS["batch_size"]
    work = ROOT / "build" / "chip_smoke"
    train = write_corpus(np, work / "bert_train.jsonl", steps * batch,
                         SEED + 14, max_words=200)
    val = write_corpus(np, work / "bert_val.jsonl", 256, SEED + 15,
                       max_words=200)
    m = bert.BertClassifier(device=dev, **BERT_KNOBS)
    ctx = TrainContext()
    r = _train_timed(torch, m, train, ctx, lp, fa, pe, profile_step=steps - 1)
    steady = r["step_s"][1:-1]
    with open(val) as f:
        texts = [json.loads(line)["text"] for line in list(f)[1:]]
    probs, wall, launches = _serve(torch, np, m, texts, fa, pe)
    score = m.evaluate(val)
    fresh = bert.BertClassifier(device=dev, **BERT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(texts))
    _, lens = m._encode(texts)
    del fresh, m
    emit({"phase": "bert", "model": "BERT-base", "dtype":
          "bfloat16 compute, f32 params", "batch": batch, "steps": steps,
          "knobs": BERT_KNOBS, "losses": r["losses"], "step_s": r["step_s"],
          "steady_step_s": float(np.mean(steady)),
          "train_examples_per_s": batch / float(np.mean(steady)),
          "train_peak_mem_gb": r["peak_mem_gb"],
          "train_launches": r["launches"],
          "profiled_step": r["profiled_step"],
          "device_idle_share_of_steady_step": _idle(r, steady),
          "predict_texts": len(texts),
          "predict_wall_s": wall, "texts_per_s": len(texts) / wall,
          "predict_launches": launches, "mean_len": float(lens.mean()),
          "val_accuracy": score,
          "reload_identical": bool(np.array_equal(reloaded, probs))})
    depth = BERT_KNOBS["depth"]
    _check_training("BERT", r, {
        "flash_attention_fwd": depth * steps,
        "flash_attention_bwd_dq": depth * steps,
        "flash_attention_bwd_dkv": depth * steps,
        "flash_attention_fwd_mh": 0, "matmul_bias": 0})
    if launches["flash_attention_fwd"] != depth * 4 or \
            sum(launches.values()) != depth * 4:
        raise AssertionError(f"BERT serving launches {launches}")
    if probs.shape != (256, 4) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities {probs.shape}")
    if not np.array_equal(reloaded, probs):
        raise AssertionError("BERT dump → reload → predict differs")
    return {"bert_training": r["launches"], "bert_serving": launches}


def hd8_serving_phase(torch, np, ll, de, pa, dev, int8=False):
    """Phase 15: a head-dim-8 Llama (hidden 32, 4 heads, 2 kv heads,
    max_len 32, f32, LoRA rank 4 with nonzero adapters, random weights
    from a seed: the LlamaLoRA knob grid's smallest head dim) served
    paged through ``DecodeEngine`` on the card at pages 8 and 4 must give
    exactly the tokens of the same model and requests served on the CPU
    (the plain versions); B1 and B2 must launch. With ``int8``, phase 17:
    the same model with int8 base kernels and an int8 KV pool, through
    the int8 kernels with f32 queries."""
    knobs = dict(vocab_size=1024, max_len=32, hidden_dim=32, depth=2,
                 n_heads=4, n_kv_heads=2, mlp_dim=128, lora_rank=4,
                 quantized=int8, kv_int8=int8)
    suffix = "_int8" if int8 else ""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    host = ll.Llama(device=cpu, generator=gen, **knobs)
    randomize_lora_b(host, gen)
    card = ll.Llama(device=dev, **knobs)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(SEED + 16)
    reqs = [(i, rng.integers(1, 1024, size=int(rng.integers(2, 15)))
             .astype(np.int32), 8) for i in range(8)]

    def serve(model, device, page):
        """Half the requests, two steps, the rest (admission mid-flight),
        then steps until every request is done."""
        eng = de.DecodeEngine(model.with_kv_layout(page, 1 + 4 * 32 // page),
                              max_slots=4, max_len=32, steps_per_sync=4,
                              prefill_chunk=8, device=device)
        done = {}
        for n in range(600):
            for rid, prompt, max_new in reqs[:4] if n == 0 else \
                    reqs[4:] if n == 2 else ():
                eng.submit(rid, prompt, max_new)
            eng.step()
            done.update({rid: [int(t) for t in toks]
                         for rid, toks in eng.poll()})
            if len(done) == len(reqs):
                break
        return done

    out, total = {}, {"paged_decode_attention" + suffix: 0,
                      "paged_window_attention" + suffix: 0}
    for page in (8, 4):
        want = serve(host, cpu, page)
        torch.cuda.synchronize()
        pa.paged_decode_attention.launches = 0
        pa.paged_window_attention.launches = 0
        got = serve(card, dev, page)
        torch.cuda.synchronize()
        launches = {"paged_decode_attention" + suffix:
                        pa.paged_decode_attention.launches,
                    "paged_window_attention" + suffix:
                        pa.paged_window_attention.launches}
        for name, n in launches.items():
            total[name] += n
        out[f"page_{page}"] = {
            "requests": len(reqs), "completed": len(got),
            "token_identical": got == want and len(got) == len(reqs),
            "mismatched_requests": sorted(r for r in want
                                          if got.get(r) != want[r]),
            "launches": launches}
    emit({"phase": f"hd8{suffix}_paged_serving", "knobs": knobs,
          "dtype": "float32", **out})
    for page, r in out.items():
        if not r["token_identical"]:
            raise AssertionError(f"head-dim-8 paged serving at {page} "
                                 f"differs from the CPU: {r}")
        if min(r["launches"].values()) <= 0:
            raise AssertionError(f"a paged kernel never launched at {page}: "
                                 f"{r['launches']}")
    return total


# ---- the inference worker (phases 18-20): the port's own hub and wire,
# ---- as the unchanged predictor drives them

def _nest(state):
    """A ``state_dict`` as the JAX nested-dict params tree, its tensors
    left where they are (the codec copies each to the host as it writes
    it)."""
    tree = {}
    for key, t in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _client(hub, unpack, mid, out, timeout=900.0):
    """Collect message ``mid``'s replies off the hub: stream deltas (the
    client clock of the first one) and the final predictions."""
    deltas, t_first = {}, None
    while True:
        raw = hub.pop_prediction(mid, timeout)
        if raw is None:
            out[mid] = {"error": "no reply"}
            return
        msg = unpack(raw)
        if "delta" in msg:
            t_first = t_first or time.perf_counter()
            for qi, d in msg["delta"].items():
                deltas[qi] = deltas.get(qi, "") + d
            continue
        out[mid] = dict(msg, t_done=time.perf_counter(), t_first=t_first,
                        deltas=deltas)
        return


def _serve_messages(hub, queues, worker, msgs):
    """Push every message, then start the worker's loop: its first
    iteration admits them in push order. Returns the replies by id, the
    loop's start and end on the host clock."""
    import threading

    for m in msgs:
        hub.push_query(worker.worker_id, queues.pack_message(m))
    out = {}
    clients = [threading.Thread(target=_client,
                                args=(hub, queues.unpack_message, m["id"],
                                      out)) for m in msgs]
    for c in clients:
        c.start()
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    t_run = time.perf_counter()
    loop.start()
    for c in clients:
        c.join()
    t_end = time.perf_counter()
    worker.stop()
    loop.join()
    return out, t_run, t_end


def _time_steps(eng):
    """Wrap ``eng.step`` to record each call's seconds, whether it ran a
    prefill chunk, and the tokens it generated; returns the record."""
    rec, step = [], eng.step

    def timed():
        before = eng.stats_snapshot()
        t0 = time.perf_counter()
        n = step()
        dt = time.perf_counter() - t0
        after = eng.stats_snapshot()
        rec.append((dt, after["prefill_calls"] > before["prefill_calls"],
                    after["tokens_generated"] - before["tokens_generated"]))
        return n

    eng.step = timed
    return rec


def _decode_tok_per_s(rec):
    """Tokens over seconds of the calls that ran no prefill chunk."""
    s = sum(dt for dt, pre, _ in rec if not pre)
    return sum(n for _, pre, n in rec if not pre) / s if s else None


def _first_diff(a, b):
    """First differing token position of two detokenized texts."""
    ta, tb = a.split(), b.split()
    return next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                min(len(ta), len(tb)) if len(ta) != len(tb) else None)


def _peak_rss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


#: phase 18's LlamaLoRA widths: Llama-3-8B's, MLP 4 x hidden as the
#: template builds it
WORKER_LLAMA = {"vocab_size": VOCAB, "hidden_dim": 4096, "n_heads": 32,
                "kv_ratio": 4, "lora_rank": 16, "max_len": 2048}


def llama_worker_phase(torch, np, ll, ps, queues, wi, pa, depth, dev):
    """Phase 18: Llama-3-8B widths (LlamaLoRA knobs: hidden 4096, 32
    heads, kv_ratio 4, MLP 4 x hidden, vocab 128256, rope theta 500000,
    LoRA rank 16, bf16, max_len 2048) served by an ``InferenceWorker``
    from a seeded f32 param-store blob: decode loop, 8 slots, 64 new
    tokens, 4 steps a sync, page 16. Phase 4's 8 texts, 4 of them
    streaming, are queued before the loop starts; every reply must come
    without error, each stream's deltas must join to a prefix of its final
    text (the predictor emits the rest as the tail), B1 and B2 must
    launch, and the texts must equal a direct
    ``make_decode_engine`` run of the same template and requests."""
    import gc

    w = WORKER_LLAMA
    slots, max_new, hidden = 8, 64, w["hidden_dim"]
    knobs = dict(w, depth=depth, bf16=True, rope_theta=500000.0)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    net = ll.Llama(vocab_size=w["vocab_size"], max_len=w["max_len"],
                   hidden_dim=hidden, depth=depth, n_heads=w["n_heads"],
                   n_kv_heads=w["n_heads"] // w["kv_ratio"],
                   mlp_dim=4 * hidden, lora_rank=w["lora_rank"],
                   dtype=torch.float32, rope_theta=500000.0, device=dev,
                   generator=gen)
    randomize_lora_b(net, gen)
    n_params = sum(p.numel() for p in net.parameters())
    tree = {"params": _nest(net.state_dict()), "meta": {"id2tok": {}}}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    store = ps.ParamStore.from_uri("mem://")
    t0 = time.perf_counter()
    store.save("llama8b", tree)
    encode_s = time.perf_counter() - t0
    del net, tree
    gc.collect()
    torch.cuda.empty_cache()
    blob = store.backend.get("llama8b")
    t0 = time.perf_counter()
    decoded = ps.params_from_bytes(blob)
    decode_s = time.perf_counter() - t0
    del decoded, blob

    hub = queues.InProcQueueHub()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    worker = wi.InferenceWorker(
        ll.LlamaLoRA, "llama8b", knobs, store, hub, "w0", decode_loop=True,
        max_slots=slots, max_new_tokens=max_new, steps_per_sync=4,
        kv_page_size=16, device=dev)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    estimate = worker.model.estimate_serving_device_bytes(
        max_slots=slots, kv_page_size=16)
    serving_memory = {
        "estimate_params_gb": estimate["params"] / 1e9,
        "held_params_gb": sum(
            t.numel() * t.element_size() for t in worker.model
            ._serving_module_params().state_dict().values()) / 1e9,
        "estimate_kv_cache_gb": estimate["kv_cache"] / 1e9,
        "estimate_total_gb": estimate["total"] / 1e9,
        "allocated_after_boot_gb": torch.cuda.memory_allocated() / 1e9,
        "allocated_before_boot_gb": before / 1e9}
    rng = np.random.default_rng(SEED + 2)  # phase 4's texts
    plens = rng.integers(64, 1025, size=slots)
    texts = [" ".join(f"w{int(w)}" for w in rng.integers(0, 10**6,
                                                         size=n - 1))
             for n in plens]
    msgs = [{"id": f"m{i}", "queries": [t], "stream": i % 2 == 0,
             "trace_id": f"t{i}"} for i, t in enumerate(texts)]
    steps = _time_steps(worker.engine)
    pa.paged_decode_attention.launches = 0
    pa.paged_window_attention.launches = 0
    out, t_run, t_end = _serve_messages(hub, queues, worker, msgs)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_window_attention": pa.paged_window_attention.launches}
    wall = t_end - t_run
    stats = hub.get_worker_stats("w0")
    step_s = worker._h_step.sum
    via = {
        "wall_s": wall, "requests_per_s": slots / wall,
        "output_tok_per_s": stats["engine_tokens_generated"] / wall,
        "decode_tok_per_s": _decode_tok_per_s(steps),
        "ttft_p50_s": worker._h_ttft.quantile(0.5),
        "ttft_p95_s": worker._h_ttft.quantile(0.95),
        "stream_ttft_client_s": sorted(
            r["t_first"] - t_run for r in out.values() if r.get("t_first")),
        "engine_step_s": step_s,
        "share_outside_step": 1 - step_s / wall,
        "engine": {k[7:]: v for k, v in stats.items()
                   if k.startswith("engine_")}}
    got = {m["id"]: (out[m["id"]].get("predictions") or [None])[0]
           for m in msgs}
    errors = {mid: r["error"] for mid, r in out.items() if r.get("error")}
    # the predictor's contract: deltas arrive append-only ahead of the
    # final message, which carries the tail a slot finished with
    streams_ok = all(
        set(out[m["id"]]["deltas"]) == {"0"}
        and (got[m["id"]] or "").startswith(out[m["id"]]["deltas"]["0"])
        for m in msgs if m["stream"])

    # the direct engine over the same template, the worker's engine freed
    model = worker.model
    del worker
    gc.collect()
    torch.cuda.empty_cache()
    eng = model.make_decode_engine(max_slots=slots, max_new_tokens=max_new,
                                   steps_per_sync=4, kv_page_size=16)
    steps = _time_steps(eng)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for m in msgs:
        eng.submit((m["id"], 0), m["queries"][0])
    done, t_first = {}, {}
    while len(done) < slots:
        eng.step()
        now = time.perf_counter()
        for (mid, _), _d in eng.poll_partial():
            t_first.setdefault(mid, now)
        for (mid, _), text in eng.poll():
            done[mid] = text
            t_first.setdefault(mid, now)
    direct_wall = time.perf_counter() - t_start
    dstats = eng.stats_snapshot()
    ttfts = np.array([t_first[m["id"]] - t_start for m in msgs])
    direct = {"wall_s": direct_wall, "requests_per_s": slots / direct_wall,
              "output_tok_per_s": dstats["tokens_generated"] / direct_wall,
              "decode_tok_per_s": _decode_tok_per_s(steps),
              "ttft_p50_s": float(np.percentile(ttfts, 50)),
              "ttft_p95_s": float(np.percentile(ttfts, 95))}
    mismatched = {mid: _first_diff(got[mid] or "", done[mid])
                  for mid in done if got[mid] != done[mid]}
    del eng, model
    emit({"phase": "llama_worker", "model": "Llama-3-8B widths (LlamaLoRA)",
          "depth": depth, "params": n_params, "blob_bytes":
          len(store.backend.get("llama8b")), "init_s": init_s,
          "encode_s": encode_s, "decode_s": decode_s, "boot_s": boot_s,
          "host_peak_rss_gb": _peak_rss_gb(),
          "serving_memory": serving_memory, "requests": slots,
          "streams": sum(m["stream"] for m in msgs),
          "prompt_tokens": [int(n) for n in plens], "max_new": max_new,
          "through_worker": via, "direct_engine": direct,
          "launches": launches, "errors": errors,
          "streams_join_to_final": streams_ok,
          "token_identical_to_direct": not mismatched,
          "first_differing_token": mismatched})
    if errors or any(v is None for v in got.values()):
        raise AssertionError(f"worker replies failed: {errors}")
    if not streams_ok:
        raise AssertionError("stream deltas do not join to a prefix of "
                             "the final text")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the worker path never "
                             f"launched: {launches}")
    if mismatched:
        raise AssertionError(f"worker texts differ from the direct engine "
                             f"(first differing token): {mismatched}")
    return launches


def _closed_loop(hub, queues, worker, images, n_clients, per_client,
                 batches):
    """``n_clients`` closed-loop clients, each sending ``per_client``
    1-image requests one after another: every request's latency (push to
    reply, host clock), the wall time, the replies' class counts, the
    worker's mean time a served message spent in its batch (unpacked to
    replied: ``request_seconds``), and the messages in each micro-batch
    the worker served meanwhile (``batches`` is appended to by the
    worker's wrapped ``_serve_batch``)."""
    import threading

    wid, e2e = worker.worker_id, worker._h_e2e
    n0, s0, b0 = e2e.count, e2e.sum, len(batches)
    lat, widths = [], []

    def client(c):
        for j in range(per_client):
            mid = f"c{n0}_{c}_{j}"
            img = images[(c * per_client + j) % len(images)]
            t0 = time.perf_counter()
            hub.push_query(wid, queues.pack_message(
                {"id": mid, "queries": img[None]}))
            reply = queues.unpack_message(hub.pop_prediction(mid, 300.0))
            lat.append(time.perf_counter() - t0)
            widths.append(len(reply["predictions"][0]))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    in_batch = (e2e.sum - s0) / max(1, e2e.count - n0)
    return lat, wall, widths, in_batch, batches[b0:]


#: phase 12's direct predict figures, reported beside phase 19's
DIRECT_VIT = {}

#: phase 19's closed-loop figures, reported beside phase 23's
VIT_WORKER = {}

#: phase 19's closed-loop rounds: each times the worker at concurrency 1
#: and 16 and the direct 1-image ``predict``, so the spread on the host
#: shows beside every figure
VIT_WORKER_ROUNDS = 3


def vit_worker_phase(torch, np, vit, store_params, ps, queues, wi, fa, pe,
                     dev):
    """Phase 19: ViT-B/16 (1000 classes, bf16, phase 12's seeded blob)
    served by an ``InferenceWorker`` through the micro-batcher: 256
    seeded images in 4 messages of 64, queued before the loop starts,
    must give exactly ``ViTBase16.predict``'s probabilities on the same
    images (B7 and B3 must launch); then ``VIT_WORKER_ROUNDS`` rounds of
    closed-loop 1-image requests, p50/p95 latency at concurrency 1 and
    requests/s at concurrency 16 with the messages in each micro-batch,
    and the direct 1-image ``predict`` while the worker's loop idles,
    beside phase 12's direct ``predict``."""
    import threading

    store = ps.ParamStore.from_uri("mem://")
    store.save("vit", vit_blob(torch, vit, store_params, dev, 1000))
    hub = queues.InProcQueueHub()
    t0 = time.perf_counter()
    worker = wi.InferenceWorker(vit.ViTBase16, "vit", VIT_KNOBS, store,
                                hub, "v0", decode_loop=False, device=dev)
    boot_s = time.perf_counter() - t0
    batches, serve_batch = [], worker._serve_batch

    def counted(messages):
        batches.append(len(messages))
        return serve_batch(messages)

    worker._serve_batch = counted
    rng = np.random.default_rng(SEED + 19)
    images = rng.integers(0, 256, (256, *VIT_IMAGE), dtype=np.uint8)
    msgs = [{"id": f"v{i}", "queries": images[64 * i:64 * (i + 1)]}
            for i in range(4)]
    for m in msgs:
        hub.push_query("v0", queues.pack_message(m))
    torch.cuda.synchronize()
    zero_all_launches(fa, pe)
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    t0 = time.perf_counter()
    loop.start()
    replies = [queues.unpack_message(hub.pop_prediction(m["id"], 600.0))
               for m in msgs]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = all_launches(fa, pe)
    got = np.concatenate([np.asarray(r["predictions"], np.float32)
                          for r in replies])
    in_batch_256 = worker._h_e2e.sum / max(1, worker._h_e2e.count)
    batches_256 = list(batches)
    rounds, widths = [], set()
    for _ in range(VIT_WORKER_ROUNDS):
        lat1, _, w1, in_batch1, b1 = _closed_loop(hub, queues, worker,
                                                  images, 1, 40, batches)
        lat16, wall16, w16, in_batch16, b16 = _closed_loop(
            hub, queues, worker, images, 16, 16, batches)
        widths |= set(w1) | set(w16)
        # the same 1-image predict, called directly while the loop idles
        direct1 = []
        for i in range(20):
            t1 = time.perf_counter()
            worker.model.predict([images[i]])
            direct1.append(time.perf_counter() - t1)
        p50_1, direct_p50 = np.percentile(lat1, 50), np.median(direct1)
        rounds.append({
            "concurrency_1": {"requests": len(lat1), "p50_s": float(p50_1),
                              "p95_s": float(np.percentile(lat1, 95)),
                              "in_batch_mean_s": in_batch1,
                              "batch_msgs_max": max(b1)},
            "direct_1_image_p50_s": float(direct_p50),
            "worker_minus_direct_p50_s": float(p50_1 - direct_p50),
            "concurrency_16": {"requests": len(lat16), "wall_s": wall16,
                               "requests_per_s": len(lat16) / wall16,
                               "p50_s": float(np.percentile(lat16, 50)),
                               "p95_s": float(np.percentile(lat16, 95)),
                               "in_batch_mean_s": in_batch16,
                               "batches": len(b16),
                               "batch_msgs_mean": float(np.mean(b16)),
                               "batch_msgs_max": max(b16)}})
    worker.stop()
    loop.join()
    VIT_WORKER["rounds"] = rounds
    want = np.asarray(worker.model.predict(list(images)), np.float32)
    over = [r["worker_minus_direct_p50_s"] for r in rounds]
    emit({"phase": "vit_worker", "model": "ViT-B/16", "dtype": "bfloat16",
          "boot_s": boot_s, "images": len(images), "messages": len(msgs),
          "wall_256_s": wall, "images_per_s": len(images) / wall,
          "in_batch_256_s": in_batch_256, "batches_256": batches_256,
          "identical_to_predict": bool(np.array_equal(got, want)),
          "max_abs_diff": float(np.abs(got - want).max()),
          "launches": launches, "rounds": rounds,
          "worker_minus_direct_p50_s_range": [min(over), max(over)],
          "direct_predict_phase_12": DIRECT_VIT,
          "errors": [r["error"] for r in replies if r.get("error")]})
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("worker ViT predictions differ from predict")
    if widths != {1000}:
        raise AssertionError(f"closed-loop replies malformed: {widths}")
    depth = VIT_KNOBS["depth"]
    if launches["matmul_bias"] != 4 or \
            launches["flash_attention_fwd"] != 4 * depth:
        raise AssertionError(f"ViT worker launches {launches}")
    return launches


def worker_exactness_phase(torch, np, ll, store_params, ps, queues, wi, pa,
                           dev):
    """Phase 20: phase 15's head-dim-8 Llama (f32, as LlamaLoRA knobs)
    from one blob, served paged at page 8 by a worker on the card and one
    on the CPU (the plain versions): the same messages must give
    identical texts and identical engine_* counters in the published
    stats; B1 and B2 must launch on the card."""
    knobs = dict(vocab_size=1024, hidden_dim=32, depth=2, n_heads=4,
                 kv_ratio=2, lora_rank=4, max_len=32, bf16=False)
    gen = torch.Generator().manual_seed(SEED)
    net = ll.Llama(vocab_size=1024, max_len=32, hidden_dim=32, depth=2,
                   n_heads=4, n_kv_heads=2, mlp_dim=128, lora_rank=4,
                   device="cpu", generator=gen)
    randomize_lora_b(net, gen)
    store = ps.ParamStore.from_uri("mem://")
    store.save("hd8", {"params": store_params.params_to_jax(
        net.state_dict()), "meta": {"id2tok": {}}})
    rng = np.random.default_rng(SEED + 20)
    msgs = [{"id": f"h{i}", "stream": i % 2 == 1, "queries": [
        " ".join(f"w{int(w)}" for w in rng.integers(
            0, 10**6, size=int(rng.integers(1, 14))))
        for _ in range(1 + i % 2)]} for i in range(8)]
    res = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        hub = queues.InProcQueueHub()
        worker = wi.InferenceWorker(
            ll.LlamaLoRA, "hd8", knobs, store, hub, name, decode_loop=True,
            max_slots=4, max_new_tokens=8, steps_per_sync=4,
            kv_page_size=8, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
            pa.paged_decode_attention.launches = 0
            pa.paged_window_attention.launches = 0
        out, _, _ = _serve_messages(hub, queues, worker, msgs)
        stats = hub.get_worker_stats(name)
        res[name] = {"texts": {mid: r.get("predictions")
                               for mid, r in out.items()},
                     "engine": {k: v for k, v in stats.items()
                                if k.startswith("engine_")}}
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_window_attention": pa.paged_window_attention.launches}
    same_texts = res["card"]["texts"] == res["cpu"]["texts"]
    same_engine = res["card"]["engine"] == res["cpu"]["engine"]
    emit({"phase": "worker_f32_exactness", "knobs": knobs, "page": 8,
          "messages": len(msgs), "texts_identical": same_texts,
          "engine_counters_identical": same_engine,
          "engine": res["card"]["engine"], "launches": launches})
    if not same_texts or any(v is None for v in res["card"]["texts"]
                             .values()):
        raise AssertionError(f"card and CPU workers differ: {res}")
    if not same_engine:
        raise AssertionError(f"engine counters differ: {res}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a paged kernel never launched: {launches}")
    return launches


# ------------------------------------------------------------ tuning legs

#: phase 21's pins: ViT-B/16 itself; the advisor searches learning_rate,
#: weight_decay, warmup_frac, batch_size and the policies
VIT_TUNE_PINS = {"patch_size": 16, "hidden_dim": 768, "depth": 12,
                 "n_heads": 12, "bf16": True}
VIT_TUNE_TRIALS = 8
#: phase 23's job through the stack: 4 trials since phase 32 joined the
#: call (8 before; its trials, their traces and the kvd replay of their
#: blobs in phase 30 cost ~110 s of the call)
STACK_TUNE_TRIALS = 4
VIT_TUNE_IMAGES = (512, 256)  # train, val
#: phase 21's job time and first proposal, reported beside phase 23's
VIT_TUNING = {}
#: phase 22's pins: LlamaLoRA's knob space at its largest point; the
#: sharded and rematerialized train paths (model_parallel > 1,
#: remat_policy) are a later slice, so they are pinned off
LLAMA_TUNE_PINS = {"hidden_dim": 512, "depth": 8, "max_len": 128,
                   "n_heads": 8, "batch_size": 32, "bf16": True,
                   "model_parallel": 1, "remat_policy": "none"}
LLAMA_TUNE_TRIALS = 3
LLAMA_TUNE_TEXTS = (512, 128)  # train, val


def _tuning_job(torch, ms, ps, adv, wt, template, name, pins, trials,
                train, val, work, dev, on_train=None, max_trials=None,
                profile_dir=None):
    """One tuning job through the port's ``TrainWorker``: BOHB
    (``make_advisor("auto")``, seed 0, ``trials`` in its budget) over
    ``template``'s knob space with ``pins`` as the job's knob overrides,
    a sqlite ``MetaStore`` and a ``file://`` param store under ``work``;
    the worker stops after ``max_trials`` and, with ``profile_dir``,
    records each trial's train with ``torch.profiler``. Every trial's
    train and evaluate are timed (synchronized), as are its wall time in
    ``run_trial`` and its parameter save. Returns the worker's trial
    count, the per-trial records, the meta store, the store and the train
    job's id."""
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    meta = ms.MetaStore(str(work / "meta.db"))
    job = meta.create_train_job("smoke", name, 1, "TUNING",
                                {"TRIAL_COUNT": trials}, "train", "val")
    sub = meta.create_sub_train_job(job["id"], name)["id"]
    store = ps.ParamStore.from_uri(f"file://{work / 'params'}")
    records, cur = [], [None]

    def timed(fn, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cur[0][key] = time.perf_counter() - t0
        return out

    class Timed(template):
        def train(self, dataset_path, ctx=None):
            cur[0]["warm_start"] = bool(ctx.shared_params is not None
                                        and self.knobs.get("share_params"))
            if on_train is not None:
                on_train(self, cur[0])
            timed(lambda: template.train(self, dataset_path, ctx),
                  "train_s")
            if on_train is not None:
                on_train(self, cur[0])
            cur[0]["epochs"] = len(ctx.logger.get_values("loss"))

        def evaluate(self, dataset_path):
            return timed(lambda: template.evaluate(self, dataset_path),
                         "eval_s")

    Timed.__name__ = template.__name__
    real_save = store.save

    def timed_save(key, params):
        if key.startswith("ckpt-") or cur[0] is None:
            return real_save(key, params)
        return timed(lambda: real_save(key, params), "save_s")

    store.save = timed_save
    worker = wt.TrainWorker(
        Timed, adv.make_advisor(template.get_knob_config(), "auto",
                                total_trials=trials, seed=0),
        train, val, param_store=store, meta_store=meta,
        sub_train_job_id=sub, model_id=name, worker_id="tw0",
        knob_overrides=pins, profile_dir=profile_dir, device=dev)
    real_run_trial = worker.run_trial

    def timed_run_trial(proposal):
        cur[0] = {"trial_no": proposal.trial_no,
                  "budget_scale": proposal.budget_scale,
                  "warm_start_trial": proposal.warm_start_trial_id}
        records.append(cur[0])
        t0 = time.perf_counter()
        score = real_run_trial(proposal)
        cur[0]["trial_s"] = time.perf_counter() - t0
        cur[0]["score"] = score
        return score

    worker.run_trial = timed_run_trial
    n = worker.run(max_trials=max_trials)
    cur[0] = None
    searched = {k for k, knob in template.get_knob_config().items()
                if not knob.is_constant and k not in pins}
    for rec, row in zip(records, meta.get_trials_of_sub_train_job(sub)):
        rec["status"] = row["status"]
        rec["searched"] = {k: v for k, v in row["knobs"].items()
                           if k in searched}
        rec["outside_train_eval_s"] = rec["trial_s"] - rec.get(
            "train_s", 0.0) - rec.get("eval_s", 0.0)
        if row["status"] != "COMPLETED":
            rec["error"] = (row["error"] or "")[-400:]
    return n, records, meta, store, job["id"]


def _busy_s(intervals):
    """Seconds covered by the union of (start, end) microsecond
    intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def train_trace_split(path):
    """Where a profiled trial's ``train`` went, from its
    ``torch.profiler`` Chrome trace (``profiled_train``'s ``train`` range,
    ``fit``'s ``fit.step`` ranges): the time before the first step, and
    of it the time inside torch operators (the module's build and
    weights; the rest is Python and numpy: the dataset's load and
    prep); the first step's host time beside the later steps' mean; the
    time after the last step (the epoch-end loss read, which waits for
    the queued steps, and the trained weights' copy to the host); and
    the card's busy time (kernels, copies, fills) over the whole train
    and before the first step, or None where the trace holds no device
    events."""
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]

    def ranges(name):
        return sorted((e for e in spans if e.get("name") == name and
                       e.get("cat") == "user_annotation"),
                      key=lambda e: e["ts"])

    train, steps = ranges("train"), ranges("fit.step")
    if len(train) != 1 or not steps:
        raise AssertionError(f"{path}: {len(train)} train ranges, "
                             f"{len(steps)} fit.step ranges")
    t0 = train[0]["ts"]
    t1 = t0 + train[0]["dur"]
    s0 = steps[0]["ts"]
    s1 = steps[-1]["ts"] + steps[-1]["dur"]
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in spans
           if e.get("cat") == "cpu_op" and t0 <= e["ts"] < s0]
    gpu = [(e["ts"], e["ts"] + e["dur"]) for e in spans
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and t0 <= e["ts"] < t1]
    later = [e["dur"] / 1e6 for e in steps[1:]]
    return {"train_s": (t1 - t0) / 1e6, "steps": len(steps),
            "before_first_step_s": (s0 - t0) / 1e6,
            "torch_ops_before_first_step_s": _busy_s(ops),
            "first_step_host_s": steps[0]["dur"] / 1e6,
            "later_step_host_s_mean": (sum(later) / len(later)
                                       if later else None),
            "after_last_step_s": (t1 - s1) / 1e6,
            "device_busy_s": _busy_s(gpu) if gpu else None,
            "device_busy_before_first_step_s":
                _busy_s([(a, min(b, s0)) for a, b in gpu if a < s0])
                if gpu else None}


def vit_tuning_phase(torch, np, vit, ms, ps, adv, wt, queues, wi, fa, pe,
                     dev):
    """Phase 21: a ViT-B/16 tuning job at full width, then its winner
    served. ``TrainWorker`` runs ``VIT_TUNE_TRIALS`` trials (BOHB, seed 0,
    ``VIT_TUNE_PINS`` over every proposal) on a seeded learnable 512-image
    train npz and a 256-image val npz (224 x 224 x 3, 10 classes, phase
    13's generator); every trial must complete and B7, B3, B5 and B6
    launch. The best trial, taken from the meta store as the JAX admin's
    deploy takes it (``get_best_trials_of_train_job``), must show a
    falling per-epoch loss; an ``InferenceWorker`` boots from its blob and
    answers the 256 val images in 4 messages of 64: probabilities equal
    to ``ViTBase16.predict`` after ``load_parameters`` of the same blob,
    accuracy within 1 % (2 of 256) of the trial's score, B7 and B3
    launched. Last, the job's first trial runs again alone under
    ``profile_dir``: its ``torch.profiler`` trace splits the trial's
    train into the time before the first step, the steps and the time
    after them (``train_trace_split``)."""
    import threading

    work = ROOT / "build" / "chip_smoke" / "vit_tuning"
    n_train, n_val = VIT_TUNE_IMAGES
    data = ROOT / "build" / "chip_smoke"
    train, _ = write_images(np, data / "vit_tune_train.npz", n_train,
                            SEED + 21)
    val, val_images = write_images(np, data / "vit_tune_val.npz", n_val,
                                   SEED + 22)
    labels = np.load(val)["labels"]
    zero_all_launches(fa, pe)
    t0 = time.perf_counter()
    n, records, meta, store, job = _tuning_job(
        torch, ms, ps, adv, wt, vit.ViTBase16, "vit-b16", VIT_TUNE_PINS,
        VIT_TUNE_TRIALS, train, val, work, dev)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    tuning = all_launches(fa, pe)
    for rec in records:
        if rec.get("train_s"):
            rec["train_images_per_s"] = rec["epochs"] * n_train / \
                rec["train_s"]
    best = meta.get_best_trials_of_train_job(job, 1)[0]
    losses = [r["data"]["loss"] for r in meta.get_trial_logs(best["id"])
              if "loss" in r["data"]]
    blob_bytes = len(store.backend.get(best["id"]))
    VIT_TUNING.update(job_s=job_s, first_knobs=meta.get_trials_of_train_job(
        job)[0]["knobs"])

    hub = queues.InProcQueueHub()
    t0 = time.perf_counter()
    worker = wi.InferenceWorker(vit.ViTBase16, best["id"], best["knobs"],
                                store, hub, "tv0", decode_loop=False,
                                device=dev)
    boot_s = time.perf_counter() - t0
    msgs = [{"id": f"tv{i}", "queries": val_images[64 * i:64 * (i + 1)]}
            for i in range(n_val // 64)]
    for m in msgs:
        hub.push_query("tv0", queues.pack_message(m))
    torch.cuda.synchronize()
    zero_all_launches(fa, pe)
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    loop.start()
    replies = [queues.unpack_message(hub.pop_prediction(m["id"], 600.0))
               for m in msgs]
    torch.cuda.synchronize()
    serving = all_launches(fa, pe)
    worker.stop()
    loop.join()
    got = np.concatenate([np.asarray(r["predictions"], np.float32)
                          for r in replies])
    direct = vit.ViTBase16(device=dev, **best["knobs"])
    direct.load_parameters(store.load(best["id"]))
    want = np.asarray(direct.predict(list(val_images)), np.float32)
    accuracy = float(np.mean(np.argmax(got, -1) == labels))
    errored = [r for r in records if r["status"] != "COMPLETED"]
    # the same advisor's first proposal (trial 0's knobs and budget), run
    # alone with the profiler on; its times are not the job's
    prof_work = work.parent / "vit_tuning_profiled"
    pn, prof_records, _, _, _ = _tuning_job(
        torch, ms, ps, adv, wt, vit.ViTBase16, "vit-b16", VIT_TUNE_PINS,
        VIT_TUNE_TRIALS, train, val, prof_work, dev, max_trials=1,
        profile_dir=str(prof_work / "traces"))
    traces = sorted((prof_work / "traces").rglob("trace.json"))
    profiled = {"trial": prof_records[0] if prof_records else None,
                "trace_bytes": traces[0].stat().st_size if traces else 0,
                "split": train_trace_split(traces[0]) if len(traces) == 1
                else None}
    emit({"phase": "vit_tuning", "model": "ViT-B/16", "pins": VIT_TUNE_PINS,
          "advisor": "bohb", "trials": n, "images": [n_train, n_val],
          "job_s": job_s, "per_trial": records,
          "outside_train_eval_s": sum(r["outside_train_eval_s"]
                                      for r in records),
          "train_eval_s": sum(r.get("train_s", 0) + r.get("eval_s", 0)
                              for r in records),
          "blob_bytes": blob_bytes,
          "save_s": [r.get("save_s") for r in records],
          "winner": {"trial_no": best["trial_no"], "score": best["score"],
                     "knobs": records[best["trial_no"]]["searched"],
                     "epoch_losses": losses},
          "tuning_launches": tuning, "serving_launches": serving,
          "served": {"boot_s": boot_s, "accuracy": accuracy,
                     "identical_to_predict": bool(np.array_equal(got,
                                                                 want)),
                     "errors": [r["error"] for r in replies
                                if r.get("error")]},
          "profiled_trial": profiled})
    if errored or n != VIT_TUNE_TRIALS:
        raise AssertionError(f"tuning trials did not complete: {errored}")
    if pn != 1 or prof_records[0]["status"] != "COMPLETED" or \
            profiled["split"] is None:
        raise AssertionError(f"the profiled trial: {pn} run, "
                             f"{len(traces)} traces: {prof_records}")
    for name in ("matmul_bias", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if tuning[name] <= 0:
            raise AssertionError(f"{name} never launched while tuning: "
                                 f"{tuning}")
    if serving["matmul_bias"] <= 0 or serving["flash_attention_fwd"] <= 0:
        raise AssertionError(f"the served winner launched {serving}")
    if not losses or not losses[-1] < losses[0]:
        raise AssertionError(f"the winner's loss did not fall: {losses}")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("the served winner differs from predict")
    if abs(accuracy - best["score"]) > 0.01:
        raise AssertionError(f"served accuracy {accuracy} != trial score "
                             f"{best['score']}")
    return {"vit_tuning": tuning, "vit_tuned_worker": serving}


def llama_tuning_phase(torch, np, ll, ms, ps, adv, wt, queues, wi, fa, pa,
                       dev):
    """Phase 22: a ``LlamaLoRA`` tuning job at the knob space's largest
    point (``LLAMA_TUNE_PINS``: hidden 512, depth 8, max_len 128, 8 heads,
    batch 32, bf16), ``LLAMA_TUNE_TRIALS`` trials (BOHB, seed 0) on phase
    8's corpus generator, with train admission live: each trial's
    ``estimate_device_budget(1)`` beside its measured peak. Every trial
    must complete, no trial's peak may rise above its estimate, and B3,
    B5 and B6 must launch. The winner is served by an ``InferenceWorker`` decode
    loop (paged, page 16, 8 slots, 16 new tokens): its texts must be
    token-identical to a direct ``make_decode_engine`` run of the same
    blob, B1 and B2 launched; the serving estimate's ``params`` term is
    printed beside the bytes the served model holds and
    ``torch.cuda.memory_allocated()`` after boot."""
    work = ROOT / "build" / "chip_smoke" / "llama_tuning"
    data = ROOT / "build" / "chip_smoke"
    n_train, n_val = LLAMA_TUNE_TEXTS
    train = write_corpus(np, data / "tune_train.jsonl", n_train, SEED + 8)
    val = write_corpus(np, data / "tune_val.jsonl", n_val, SEED + 9)

    def memory(model, rec):
        if "estimate" not in rec:  # before train
            rec["estimate"] = model.estimate_device_budget(1)
            rec["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        else:
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    zero_flash_launches(fa)
    t0 = time.perf_counter()
    n, records, meta, store, job = _tuning_job(
        torch, ms, ps, adv, wt, ll.LlamaLoRA, "llama-lora",
        LLAMA_TUNE_PINS, LLAMA_TUNE_TRIALS, train, val, work, dev,
        on_train=memory)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    tuning = flash_launches(fa)
    for rec in records:
        if "estimate" in rec:
            rec["estimate_gb"] = {k: v / 1e9
                                  for k, v in rec.pop("estimate").items()}
        if "peak_gb" in rec:
            rec["peak_increase_gb"] = rec["peak_gb"] - \
                rec["allocated_before_gb"]
    best = meta.get_best_trials_of_train_job(job, 1)[0]
    knobs = best["knobs"]

    rng = np.random.default_rng(SEED + 22)
    with open(val) as f:
        rows = [json.loads(line) for line in f][1:]
    texts = [" ".join(rows[int(i)]["text"].split()[:40])
             for i in rng.choice(len(rows), 8, replace=False)]
    msgs = [{"id": f"tl{i}", "queries": [t]} for i, t in enumerate(texts)]
    slots, max_new = 8, 16
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    hub = queues.InProcQueueHub()
    t0 = time.perf_counter()
    worker = wi.InferenceWorker(
        ll.LlamaLoRA, best["id"], knobs, store, hub, "tl0",
        decode_loop=True, max_slots=slots, max_new_tokens=max_new,
        steps_per_sync=4, kv_page_size=16, device=dev)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    estimate = worker.model.estimate_serving_device_bytes(
        max_slots=slots, kv_page_size=16)
    held = sum(t.numel() * t.element_size() for t in
               worker.model._serving_module_params().state_dict().values())
    after_boot = torch.cuda.memory_allocated()
    pa.paged_decode_attention.launches = 0
    pa.paged_window_attention.launches = 0
    out, t_run, t_end = _serve_messages(hub, queues, worker, msgs)
    torch.cuda.synchronize()
    serving = {"paged_decode_attention": pa.paged_decode_attention.launches,
               "paged_window_attention": pa.paged_window_attention.launches}
    got = {m["id"]: (out[m["id"]].get("predictions") or [None])[0]
           for m in msgs}
    del worker
    direct_model = ll.LlamaLoRA(device=dev, **knobs)
    direct_model.load_parameters(store.load(best["id"]))
    eng = direct_model.make_decode_engine(max_slots=slots,
                                          max_new_tokens=max_new,
                                          steps_per_sync=4, kv_page_size=16)
    for m in msgs:
        eng.submit((m["id"], 0), m["queries"][0])
    done = {}
    while len(done) < len(msgs):
        eng.step()
        done.update({mid: text for (mid, _), text in eng.poll()})
    mismatched = {mid: _first_diff(got[mid] or "", done[mid])
                  for mid in done if got[mid] != done[mid]}
    del eng, direct_model
    errors = {mid: r["error"] for mid, r in out.items() if r.get("error")}
    emit({"phase": "llama_tuning", "model": "LlamaLoRA", "pins":
          LLAMA_TUNE_PINS, "advisor": "bohb", "trials": n, "texts":
          [n_train, n_val], "job_s": job_s, "per_trial": records,
          "winner": {"trial_no": best["trial_no"], "score": best["score"],
                     "knobs": records[best["trial_no"]]["searched"]},
          "tuning_launches": tuning, "serving_launches": serving,
          "served": {"boot_s": boot_s, "wall_s": t_end - t_run,
                     "requests": len(msgs), "max_new": max_new,
                     "errors": errors,
                     "token_identical_to_direct": not mismatched,
                     "first_differing_token": mismatched},
          "serving_memory": {
              "estimate_params_gb": estimate["params"] / 1e9,
              "held_params_gb": held / 1e9,
              "estimate_kv_cache_gb": estimate["kv_cache"] / 1e9,
              "estimate_total_gb": estimate["total"] / 1e9,
              "allocated_after_boot_gb": after_boot / 1e9,
              "allocated_before_boot_gb": before / 1e9}})
    errored = [r for r in records if r["status"] != "COMPLETED"]
    if errored or n != LLAMA_TUNE_TRIALS:
        raise AssertionError(f"tuning trials did not complete: {errored}")
    over = [r for r in records
            if r["peak_increase_gb"] > r["estimate_gb"]["total"]]
    if over:
        raise AssertionError(f"a trial's peak rose above its train "
                             f"estimate: {over}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        if tuning[name] <= 0:
            raise AssertionError(f"{name} never launched while tuning: "
                                 f"{tuning}")
    if min(serving.values()) <= 0:
        raise AssertionError(f"a paged kernel never launched: {serving}")
    if errors or any(v is None for v in got.values()):
        raise AssertionError(f"worker replies failed: {errors}")
    if mismatched:
        raise AssertionError(f"served texts differ from the direct engine: "
                             f"{mismatched}")
    if estimate["params"] != held:
        raise AssertionError(f"params term {estimate['params']} != the "
                             f"{held} bytes the served model holds")
    return {"llama_tuning": tuning, "llama_tuned_worker": serving}


# ---- the stack (phase 23): the port's own control plane on the card

#: phase 23's closed-loop rounds over HTTP, as phase 19's rounds (1
#: since phase 29 joined the call: a round takes ~25 s of the 600 s)
STACK_ROUNDS = 1
#: the kernels a ViT-B/16 trial runs, by wrapper name
STACK_TRAIN_KERNELS = ("matmul_bias", "flash_attention_fwd",
                       "flash_attention_fwd_mh", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")


def trace_kernel_launches(path):
    """Each port kernel's launches in a ``torch.profiler`` Chrome trace:
    its device kernel events, matched by CUDA function name
    (``KERNEL_FUNCTIONS``)."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "kernel"]
    out = {}
    for name in STACK_TRAIN_KERNELS:
        fn = KERNEL_FUNCTIONS[name]
        fns = (fn,) if isinstance(fn, str) else fn
        out[name] = sum(1 for n in names if any(
            f + "<" in n or f + "(" in n or n.endswith(f) for f in fns))
    return out


def _exact_loop(np, Client, url, images, want, n_clients, per_client):
    """``n_clients`` closed-loop 1-image ``/predict`` clients over HTTP,
    ``per_client`` requests each, every answer held against its image's
    row of the direct ``predict`` (``want``) bit for bit: requests/s,
    p50 / p95, answers differing, requests failed (a structured 503
    counted apart)."""
    import threading

    from rafiki_tpu_torch.utils.http import HttpStatusError

    lat, differing, failed, rejected = [], [], [], []
    lock = threading.Lock()

    def client(c):
        cli = Client(timeout=120.0)
        for j in range(per_client):
            idx = (c * per_client + j) % len(images)
            t0 = time.perf_counter()
            try:
                got = cli.predict(url, [images[idx]], retry_on_503=False)
            except HttpStatusError as e:
                with lock:
                    (rejected if e.status == 503 else failed).append(
                        repr(e)[:200])
                continue
            except Exception as e:  # counted, and the phase's gate
                with lock:
                    failed.append(repr(e)[:200])
                continue
            dt = time.perf_counter() - t0
            same = np.array_equal(np.asarray(got[0], np.float32),
                                  want[idx])
            with lock:
                lat.append(dt)
                differing.append(not same)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return {"clients": n_clients, "requests": len(lat), "wall_s": wall,
            "requests_per_s": len(lat) / wall,
            "p50_s": float(np.percentile(lat, 50)) if lat else None,
            "p95_s": float(np.percentile(lat, 95)) if lat else None,
            "differing": sum(differing), "failed": len(failed),
            "rejected_503": len(rejected),
            "failures": (failed + rejected)[:3]}


def _alive(pid):
    """True while ``pid`` is a live (not zombie) process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except OSError:
        return False


#: phase 23's admin lease TTL: short, so phase 30's handover waits out
#: the dead admin's lease in seconds
STACK_LEASE_TTL_S = 2.0
#: phase 30's closed-loop HTTP clients
RECOVERY_CLIENTS = 4


class _Traffic:
    """``n_clients`` closed-loop 1-image ``/predict`` clients over HTTP,
    each through its own port ``Client`` with the SDK's retry of a
    structured 503 turned off, so each request is counted once: answered
    (its reply held against the direct ``predict`` of its image, ``want``),
    rejected by a structured 503 (by its error: a draining worker, every
    breaker open or draining, the data plane down, a shed), or failed
    (any other error, a timeout included). After a rejection a client
    waits the reply's ``retry_after_s`` (at most 2 s) before its next
    request, as the reply asks. ``ViTBase16.predict`` pads every batch
    to a bucket of 64 images, so each answer must equal its image's row
    of the direct ``predict`` bit for bit."""

    def __init__(self, np, Client, url, images, want,
                 n_clients=RECOVERY_CLIENTS):
        import threading

        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.answered, self.differing, self.lat = 0, 0, []
        self.max_abs_diff = 0.0
        self.rejected, self.failed = {}, []
        self._threads = [threading.Thread(
            target=self._client, args=(np, Client, url, images, want, c),
            daemon=True) for c in range(n_clients)]

    def _client(self, np, Client, url, images, want, c):
        from rafiki_tpu_torch.utils.http import HttpStatusError

        cli = Client(timeout=120.0)
        j = 0
        while not self._stop.is_set():
            idx = (c * 97 + j) % len(images)
            img = images[idx]
            j += 1
            t0 = time.perf_counter()
            try:
                preds = cli.predict(url, [img], retry_on_503=False)
            except HttpStatusError as e:
                if e.status != 503 or e.retry_after_s is None:
                    with self._lock:
                        self.failed.append(repr(e)[:300])
                    continue
                err = str(e.payload.get("error", ""))
                kind = ("draining" if "draining" in err else
                        "data_plane_down" if e.data_plane_down else
                        "shed" if e.shed else
                        "breakers" if "no worker available" in err
                        else err[:80])
                with self._lock:
                    self.rejected[kind] = self.rejected.get(kind, 0) + 1
                self._stop.wait(min(2.0, e.retry_after_s))
                continue
            except Exception as e:  # counted, and the phase's gate
                with self._lock:
                    self.failed.append(repr(e)[:300])
                continue
            diff = float(np.abs(np.asarray(preds[0], np.float32)
                                - want[idx]).max())
            with self._lock:
                self.answered += 1
                self.differing += diff != 0.0
                self.max_abs_diff = max(self.max_abs_diff, diff)
                self.lat.append(time.perf_counter() - t0)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=180)
        self.hung = sum(t.is_alive() for t in self._threads)

    def counts(self):
        lat = sorted(self.lat)
        return {"answered": self.answered,
                "answers_differing_from_predict": self.differing,
                "max_abs_diff": self.max_abs_diff,
                "rejected": dict(self.rejected),
                "failed": len(self.failed), "failures": self.failed[:3],
                "hung_clients": self.hung,
                "p50_s": lat[len(lat) // 2] if lat else None}


#: phase 30's checks after (a)-(c): phase 19's first images through
#: ``/predict`` (256 before phase 31 joined the call; each check of 256
#: took 23-29 s of the serving host path)
RECOVERY_CHECK_IMAGES = 64


def _served_equal(np, client, url, images, want):
    """``images`` through ``/predict`` in requests of 64, against the
    direct ``predict`` rows ``want``: equal, and the wall seconds."""
    t0 = time.perf_counter()
    served = []
    for i in range(0, len(images), 64):
        served += client.predict(url, list(images[i:i + 64]))
    got = np.asarray(served, np.float32)
    return {"identical_to_predict": bool(got.shape == want.shape and
                                         np.array_equal(got, want)),
            "wall_s": time.perf_counter() - t0}


def recovery_phase(torch, np, st, images, want, ijob_id, wid):
    """Phase 30, inside phase 23's stack before its teardown: crash
    recovery of the deployed ViT-B/16 job, under closed-loop 1-image
    HTTP clients at concurrency 4 (``_Traffic``), whose every answer
    must equal the direct ``predict``.

    (a) Admin handover: the admin stops its monitor and lease heartbeat,
    stops serving and drops its handles without stopping a child (an
    admin killed); a second ``ServicesManager`` (the device probe
    included) + ``Admin`` + ``AdminApp`` over the same MetaStore waits
    out the lease, takes it over and ``reconcile()``s: it must adopt the
    kvd (same pid), the Predictor and the inference worker (same pids)
    and crash nothing; no request may fail; a third manager's
    ``acquire_lease`` must raise ``LeaseHeldError``.
    (b) Rolling restart through ``POST /inference_jobs/<id>/rolling_
    restart``: the worker's sidecar (its ``obs_port_file``) answers
    ``/health`` first; the worker drains through it and exits 0, and a
    replacement spawns on the freed slot; every request is answered or
    gets a structured 503 (counted by kind), none fails or hangs; B7 and
    B3 launch in the replacement (its published ``kernel_launches``:
    the ``recovery`` path).
    (c) SIGKILL on the kvd: the new admin's monitor respawns it on its
    recorded port with WAL replay (``kvd_respawns`` 1; replay seconds
    and the bytes of the files replayed); the best trial's parameter
    blob reads back bit-equal to the one read before the kill; the
    worker and the Predictor reconnect (requests counted).
    (d) ``POST /system/backup``: the file opens as a MetaStore with the
    live store's service, job and trial rows; ``python -m
    rafiki_tpu_torch.cli doctor --workdir`` on the live workdir reports
    no drift.
    After each of (a)-(c) phase 19's first ``RECOVERY_CHECK_IMAGES``
    images through ``/predict`` must equal the direct ``predict``. ``st`` holds the live ``meta``,
    ``manager``, ``admin``, ``app``, ``client`` and ``url``; the admin
    of (a) replaces them there, for phase 23's teardown. Returns the
    phase's record and the ``recovery`` path's launches."""
    import hashlib
    import os
    import signal
    import threading

    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.app import AdminApp
    from rafiki_tpu_torch.admin.services_manager import LeaseHeldError
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.serving.queues import KVQueueHub
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.store.param_store import ParamStore
    from rafiki_tpu_torch.utils.http import json_request

    Manager = st["Manager"]
    meta, manager, url = st["meta"], st["manager"], st["url"]
    workdir = manager.workdir
    rec = {"phase": "recovery", "model": "ViT-B/16",
           "clients": RECOVERY_CLIENTS, "lease_ttl_s": STACK_LEASE_TTL_S}
    checks = {}

    def services_by_type():
        return {r["service_type"]: r for r in meta.get_services("RUNNING")}

    # ---- (a) admin handover
    before = services_by_type()
    pids_before = {k: int(r["pid"]) for k, r in before.items()}
    # this process spawned them: their Popen handles read the drained
    # worker's exit code and reap the killed kvd
    old_worker = next(s.proc for s in manager.services.values()
                      if s.service_type == "INFERENCE_WORKER")
    old_kv = manager._kv_server
    with _Traffic(np, Client, url, images, want) as traffic:
        time.sleep(1.0)
        t_dead = time.perf_counter()
        st["admin"]._monitor_stop.set()
        st["admin"]._monitor.join(timeout=30)
        manager._stop_lease_heartbeat()
        st["app"].http.stop()
        manager._drop_handles()
        meta2 = MetaStore(meta._db_path)
        manager2 = Manager(meta2, str(workdir), platform=None, slot_size=1,
                           slot_timeout=300.0)
        t_probe = time.perf_counter()
        while True:
            try:
                lease = manager2.acquire_lease(ttl_s=STACK_LEASE_TTL_S)
                break
            except LeaseHeldError:
                if time.perf_counter() - t_dead > 60:
                    raise
                time.sleep(0.05)
        t_lease = time.perf_counter()
        manager2.start_lease_heartbeat()
        recovered = manager2.reconcile()
        t_reconcile = time.perf_counter()
        manager2.start_data_plane()
        admin2 = Admin(meta2, manager2)
        admin2.start_monitor(interval_s=0.3)
        app2 = AdminApp(admin2)
        host, port = app2.start()
        client2 = Client(f"http://{host}:{port}", timeout=600.0)
        client2.login("superadmin@rafiki", "rafiki")
        handover_s = time.perf_counter() - t_dead
        st.update(meta=meta2, manager=manager2, admin=admin2, app=app2,
                  client=client2)
        third = Manager(MetaStore(meta._db_path),
                        str(workdir.parent / "third"),
                        platform="cuda", devices=manager2.devices)
        try:
            third.acquire_lease(ttl_s=STACK_LEASE_TTL_S)
            fenced = False
        except LeaseHeldError:
            fenced = True
        time.sleep(1.0)
    adopted = {s.service_type: s.proc.pid
               for s in manager2.services.values() if s.adopted}
    rec["handover"] = {
        "seconds": handover_s, "probe_s": t_probe - t_dead,
        "lease_wait_s": t_lease - t_probe,
        "reconcile_s": t_reconcile - t_lease,
        "lease_generation": lease["generation"],
        "took_over": bool(lease.get("took_over")),
        "recovery": {k: recovered[k] for k in (
            "services_adopted", "kv_adopted", "services_crashed",
            "orphans_reaped")},
        "same_pids": {
            "kvd": manager2._kv_proc.pid == pids_before.get("DATA_PLANE"),
            "predictor": adopted.get("PREDICTOR") ==
            pids_before.get("PREDICTOR"),
            "inference_worker": adopted.get("INFERENCE_WORKER") ==
            pids_before.get("INFERENCE_WORKER")},
        "third_admin_fenced": fenced, "traffic": traffic.counts()}
    checks["a"] = _served_equal(
        np, client2, url, images[:RECOVERY_CHECK_IMAGES],
        want[:RECOVERY_CHECK_IMAGES])
    h = rec["handover"]
    if not (all(h["same_pids"].values()) and fenced and
            recovered["services_adopted"] + recovered["kv_adopted"] >= 3
            and recovered["services_crashed"] == 0 and h["took_over"]
            and not h["traffic"]["failed"] and not traffic.hung
            and not traffic.differing):
        emit(rec)
        raise AssertionError(f"admin handover: {h}")
    print(f"recovery: (a) handover {handover_s:.2f} s", flush=True)

    # ---- (b) rolling restart through the sidecar
    worker_row = services_by_type()["INFERENCE_WORKER"]
    obs_file = Path(worker_row["spawn_spec"]["config"]["obs_port_file"])
    obs_port = int(obs_file.read_text())
    sidecar = json_request("GET", f"http://127.0.0.1:{obs_port}/health",
                           timeout=10)
    hub = KVQueueHub(manager2.kv_host, manager2.kv_port)
    with _Traffic(np, Client, url, images, want) as traffic:
        time.sleep(1.0)
        out = {}
        # the call returns once the replacement reported its obs port:
        # the old worker's exit splits the drain from the boot
        restart = threading.Thread(target=lambda: out.update(
            client2.rolling_restart_inference_job(ijob_id,
                                                  drain_timeout=120.0)))
        t0 = time.perf_counter()
        restart.start()
        drain_rc = old_worker.wait(timeout=180)
        t_drained = time.perf_counter()
        t_published = time.time()
        restart.join(timeout=600)
        while True:
            stats = hub.get_worker_stats(wid) or {}
            if stats.get("published_at", 0) > t_published - 1.0 and \
                    not stats.get("draining") and \
                    stats.get("obs_port") not in (None, obs_port):
                break
            if time.perf_counter() - t_drained > 600:
                raise AssertionError("the replacement never came up")
            time.sleep(0.1)
        t_up = time.perf_counter()
        time.sleep(3.0)  # the clients go on against the replacement
    new_row = services_by_type()["INFERENCE_WORKER"]
    rec["rolling_restart"] = {
        "sidecar_health": sidecar, "restarted": out.get("restarted"),
        "drained_rc": drain_rc, "drain_s": t_drained - t0,
        "replacement_boot_s": t_up - t_drained,
        "old_pid": pids_before["INFERENCE_WORKER"],
        "new_pid": int(new_row["pid"]),
        "slot": new_row["devices"], "traffic": traffic.counts(),
        "rolling_restarts_done":
            manager2.respawn_stats()["rolling_restarts_done"]}
    checks["b"] = _served_equal(
        np, client2, url, images[:RECOVERY_CHECK_IMAGES],
        want[:RECOVERY_CHECK_IMAGES])
    r = rec["rolling_restart"]
    if not (sidecar == {"ok": True} and drain_rc == 0 and
            len(out.get("restarted") or []) == 1
            and out["restarted"][0]["drained"]
            and r["new_pid"] != r["old_pid"]
            and not r["traffic"]["failed"] and not traffic.hung
            and not traffic.differing):
        emit(rec)
        raise AssertionError(f"rolling restart: {r}")
    print(f"recovery: (b) drain {r['drain_s']:.2f} s, "
          f"replacement {r['replacement_boot_s']:.2f} s", flush=True)

    # ---- (c) the kvd killed
    best_id = st["best_id"]
    store = ParamStore.from_uri(manager2.param_store_uri)
    blob = store.backend.get(best_id)
    digest = hashlib.sha256(blob).hexdigest()
    data_dir = Path(manager2._kv_data_dir)
    kv_pid, kv_port = manager2._kv_proc.pid, manager2.kv_port
    with _Traffic(np, Client, url, images, want) as traffic:
        time.sleep(1.0)
        replay_bytes = sum(f.stat().st_size for f in (
            data_dir / "snapshot.wal", data_dir / "wal") if f.exists())
        t_kill = time.perf_counter()
        os.kill(kv_pid, signal.SIGKILL)
        old_kv._proc.wait()
        while manager2.recovery["kvd_respawns"] < 1:
            if time.perf_counter() - t_kill > 300:
                raise AssertionError("the kvd was never respawned")
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        time.sleep(3.0)  # the clients go on against the new kvd
    blob2 = ParamStore.from_uri(manager2.param_store_uri).backend.get(
        best_id)
    rec["kvd_kill"] = {
        "respawn_s": respawn_s,
        "replay_s": float(manager2.recovery["kvd_replay_seconds"]),
        "replay_bytes": replay_bytes, "old_pid": kv_pid,
        "new_pid": manager2._kv_proc.pid,
        "same_port": manager2.kv_port == kv_port,
        "kvd_respawns": manager2.recovery["kvd_respawns"],
        "blob_bytes": len(blob), "blob_sha256": digest,
        "blob_bit_equal": blob2 == blob, "traffic": traffic.counts()}
    del blob, blob2
    checks["c"] = _served_equal(
        np, client2, url, images[:RECOVERY_CHECK_IMAGES],
        want[:RECOVERY_CHECK_IMAGES])
    k = rec["kvd_kill"]
    if not (k["kvd_respawns"] == 1 and k["same_port"] and
            k["blob_bit_equal"] and k["new_pid"] != kv_pid
            and not traffic.hung and not traffic.differing):
        emit(rec)
        raise AssertionError(f"kvd respawn: {k}")
    print(f"recovery: (c) kvd respawned in {respawn_s:.2f} s (replay "
          f"{k['replay_s']:.2f} s over {replay_bytes} bytes)", flush=True)

    # ---- (d) backup and doctor
    backup_path = workdir.parent / "backup.db"
    t0 = time.perf_counter()
    got = client2.backup(str(backup_path))
    backup_s = time.perf_counter() - t0
    copy = MetaStore(str(backup_path))

    def rows(m):
        jobs = [(j["id"], j["status"]) for j in m._all(
            "SELECT * FROM train_jobs ORDER BY id")]
        trials = [(t["id"], t["status"], t["score"]) for t in m._all(
            "SELECT * FROM trials ORDER BY id")]
        services = sorted((r["id"], r["status"], r["pid"])
                          for r in m.get_services())
        return {"train_jobs": jobs, "trials": trials,
                "services": services,
                "inference_jobs": [(j["id"], j["status"]) for j in
                                   m.get_inference_jobs()]}

    live_rows, copy_rows = rows(meta2), rows(copy)
    import rafiki_tpu_torch

    env = dict(os.environ, PYTHONPATH=str(
        Path(rafiki_tpu_torch.__file__).resolve().parent.parent))
    t0 = time.perf_counter()
    doc = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.cli", "doctor",
         "--workdir", str(workdir), "--json"], capture_output=True,
        text=True, timeout=600, env=env)
    doctor_s = time.perf_counter() - t0
    try:
        report = json.loads(doc.stdout)
    except ValueError:
        report = {"ok": False, "drift": [doc.stdout[-500:],
                                         doc.stderr[-1500:]]}
    rec["backup"] = {"bytes": got.get("bytes"), "seconds": backup_s,
                     "rows_equal": live_rows == copy_rows,
                     "rows": {k: len(v) for k, v in copy_rows.items()}}
    rec["doctor"] = {"rc": doc.returncode, "seconds": doctor_s,
                     "ok": report.get("ok"), "drift": report.get("drift"),
                     "services": len(report.get("services") or []),
                     "data_plane_replay": {
                         k: (report.get("data_plane") or {}).get(
                             "replay", {}).get(k)
                         for k in ("ok", "replayable_records",
                                   "restored_keys")}}
    # the replacement's launches since it booted (warmup and phase 30's
    # requests), as it last published them: the recovery path
    stats = hub.get_worker_stats(wid) or {}
    launches = {n: int((stats.get("kernel_launches") or {}).get(n, 0))
                for n in ("matmul_bias", "flash_attention_fwd")}
    rec["replacement_launches"] = launches
    rec["served_after"] = checks
    emit(rec)
    print(f"recovery: (d) backup {got.get('bytes')} bytes in "
          f"{backup_s:.3f} s; doctor {doctor_s:.1f} s, drift "
          f"{report.get('drift')}", flush=True)
    if not (got.get("ok") and rec["backup"]["rows_equal"]):
        raise AssertionError(f"backup: {rec['backup']}")
    if doc.returncode != 0 or not report.get("ok"):
        raise AssertionError(f"doctor: {rec['doctor']}")
    bad = [s for s, c in checks.items() if not c["identical_to_predict"]]
    if bad:
        raise AssertionError(f"/predict differs from the direct predict "
                             f"after step(s) {bad}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels that never launched in the "
                             f"replacement worker: {launches}")
    return launches


def stack_phase(torch, np, vit, dev):
    """Phase 23: a ViT-B/16 train -> tune -> deploy -> predict job through
    the port's own control plane. The stack boots on the card: the port's
    kvd, ``ServicesManager(platform=None)`` over the card the device probe
    finds (one slot), the admin lease, ``Admin`` with its monitor,
    ``AdminApp``, and a port ``Client`` over HTTP. The client logs in,
    uploads ``ViTBase16`` and phase 21's seeded 512 / 256 images as
    datasets, and creates a train job with phase 21's pins (full-width
    ViT-B/16, bf16), BOHB (``"advisor": "auto"``, the service's seed 0),
    ``TRIAL_COUNT`` ``STACK_TUNE_TRIALS`` (4) and ``profile`` on: the
    admin spawns an advisor service and a train worker onto the slot.
    Every trial must complete;
    each trial's ``torch.profiler`` trace gives its train seconds and
    its kernels' launches (B7, B3, B5 and B6 must launch in the train
    worker). The monitor finalizes the job and frees the slot; the best
    trial is deployed (``create_inference_job``: an inference worker on
    the slot and a Predictor), phase 19's 256 seeded images go through
    ``/predict`` in 4 requests of 64 and must equal a direct ``predict``
    of the same trial's parameters, loaded from the param store, on the
    card. Then ``STACK_ROUNDS`` rounds of closed-loop 1-image clients at
    concurrency 1 and 16 over HTTP (every answer equal to the direct
    ``predict``), beside phase 19's worker-only figures. The inference worker's published stats must show B7 and B3
    launched. Last, the inference job and the stack stop: no child
    process may be left alive and the slot must be free."""
    import shutil

    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.app import AdminApp
    from rafiki_tpu_torch.admin.services_manager import ServicesManager
    from rafiki_tpu_torch.advisor import make_advisor
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.model.knob import FixedKnob
    from rafiki_tpu_torch.serving.queues import KVQueueHub
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.store.param_store import ParamStore

    work = ROOT / "build" / "chip_smoke" / "stack"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n_train, n_val = VIT_TUNE_IMAGES
    train, _ = write_images(np, work / "train.npz", n_train, SEED + 21)
    val, _ = write_images(np, work / "val.npz", n_val, SEED + 22)
    # phase 19's seeded images
    images = np.random.default_rng(SEED + 19).integers(
        0, 256, (256, *VIT_IMAGE), dtype=np.uint8)

    t_phase = time.perf_counter()

    def progress(step):
        print(f"stack: {step} at {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    t0 = time.perf_counter()
    # the store lives in the manager's workdir, as `stack start` lays it
    # out, so phase 30's `doctor --workdir` audits the live stack
    (work / "stack").mkdir()
    meta = MetaStore(str(work / "stack" / "meta.db"))
    manager = ServicesManager(meta, str(work / "stack"), platform=None,
                              slot_size=1, slot_timeout=300.0)
    manager.acquire_lease(ttl_s=STACK_LEASE_TTL_S)
    manager.start_lease_heartbeat()
    manager.start_data_plane()
    admin = Admin(meta, manager)
    admin.start_monitor(interval_s=0.3)
    app = AdminApp(admin)
    host, port = app.start()
    stack_boot_s = time.perf_counter() - t0
    client = Client(f"http://{host}:{port}", timeout=600.0)
    progress("booted")
    rec = {"phase": "stack", "model": "ViT-B/16", "pins": VIT_TUNE_PINS,
           "advisor": "bohb", "images": [n_train, n_val],
           "platform": manager.platform,
           "devices": [d.name for d in manager.devices],
           "slots": manager.allocator.n_slots, "stack_boot_s": stack_boot_s}
    launches = {name: 0 for name in STACK_TRAIN_KERNELS}
    recovery_launches = {}
    stopped = False
    # the live admin: phase 30's handover replaces it
    st = {"Manager": ServicesManager, "meta": meta, "manager": manager,
          "admin": admin, "app": app, "client": client}
    try:
        client.login("superadmin@rafiki", "rafiki")
        model = client.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                                    vit.ViTBase16)
        ds_tr = client.create_dataset("train", "IMAGE_CLASSIFICATION",
                                      train)
        ds_va = client.create_dataset("val", "IMAGE_CLASSIFICATION", val)
        t0 = time.perf_counter()
        job = client.create_train_job(
            "smoke-stack", "IMAGE_CLASSIFICATION", ds_tr["id"],
            ds_va["id"], budget={"TRIAL_COUNT": STACK_TUNE_TRIALS},
            model_ids=[model["id"]],
            train_args={"advisor": "auto", "knob_overrides": VIT_TUNE_PINS,
                        "profile": True})
        progress("train job created")
        job = client.wait_until_train_job_finished(job["id"], timeout=900,
                                                   poll_s=0.25)
        job_s = time.perf_counter() - t0
        progress(f"train job {job['status']}")
        trials = client.get_trials_of_train_job(job["id"])
        free_after_train = manager.allocator.free_count()
        workers = [r for r in meta.get_services()
                   if r["service_type"] == "TRAIN_WORKER"]
        per_trial = []
        for t in trials:
            traces = sorted((work / "stack" / "profiles").rglob(
                f"{t['id']}/**/trace.json"))
            split = train_trace_split(traces[0]) if traces else None
            counts = trace_kernel_launches(traces[0]) if traces else {}
            for name, n in counts.items():
                launches[name] += n
            per_trial.append({
                "trial_no": t["trial_no"], "status": t["status"],
                "budget_scale": t["budget_scale"], "score": t["score"],
                "wall_s": (t["stopped_at"] or 0) - (t["started_at"] or 0),
                "train_s": split["train_s"] if split else None,
                "steps": split["steps"] if split else None,
                "launches": counts,
                "error": (t["error"] or "")[-400:] or None})
        train_launches = dict(launches)
        space = {k: (FixedKnob(VIT_TUNE_PINS[k]) if k in VIT_TUNE_PINS
                     else knob)
                 for k, knob in vit.ViTBase16.get_knob_config().items()}
        expected_first = make_advisor(space, "auto",
                                      total_trials=STACK_TUNE_TRIALS,
                                      seed=0).propose().knobs
        first = trials[0]["knobs"] if trials else None
        rec.update(
            job_s=job_s, trials=len(trials),
            trials_per_hour=len(trials) * 3600.0 / job_s,
            phase_21_job_s=VIT_TUNING.get("job_s"),
            train_worker_boot_s=(
                min(t["started_at"] for t in trials) - workers[0][
                    "created_at"] if trials and workers else None),
            first_proposal=first,
            first_proposal_phase_21=VIT_TUNING.get("first_knobs"),
            first_equals_phase_21=first == VIT_TUNING.get("first_knobs"),
            first_equals_the_advisor_over_the_pinned_space=(
                first == expected_first),
            per_trial=per_trial, train_worker_launches=train_launches,
            free_slots_after_train=free_after_train)

        progress("traces read")
        best = client.get_best_trials_of_train_job(job["id"], 1)[0]
        t0 = time.perf_counter()
        ijob = client.create_inference_job(job["id"], max_workers=1)
        create_s = time.perf_counter() - t0
        url = ijob["predictor_url"]
        wid = f"iw-{ijob['id'][:8]}-0"
        hub = KVQueueHub(manager.kv_host, manager.kv_port)
        while hub.get_worker_stats(wid) is None:
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the inference worker never came up")
            time.sleep(0.05)
        worker_boot_s = time.perf_counter() - t0
        client.predict(url, [images[0]])
        deploy_s = time.perf_counter() - t0
        progress("deployed")
        t0 = time.perf_counter()
        served = []
        for i in range(4):
            served += client.predict(url, list(images[64 * i:64 * (i + 1)]))
        wall_256 = time.perf_counter() - t0
        progress("256 images served")
        got = np.asarray(served, np.float32)
        direct = vit.ViTBase16(device=dev, **best["knobs"])
        direct.load_parameters(ParamStore.from_uri(
            manager.param_store_uri).load(best["id"]))
        want = np.asarray(direct.predict(list(images)), np.float32)
        del direct
        torch.cuda.empty_cache()
        rounds = [{"concurrency_1": _exact_loop(np, Client, url, images,
                                                want, 1, 40),
                   "concurrency_16": _exact_loop(np, Client, url, images,
                                                 want, 16, 16)}
                  for _ in range(STACK_ROUNDS)]
        http_errors = [f for r in rounds for c in r.values()
                       for f in c["failures"]]
        differing = sum(c["differing"] for r in rounds for c in r.values())
        t_end = time.time()
        progress("closed loops done")
        # the worker republishes its stats within 50 loop iterations
        deadline = time.perf_counter() + 120
        while True:
            stats = hub.get_worker_stats(wid) or {}
            if stats.get("published_at", 0) > t_end or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.5)
        worker_launches = {k: int(v) for k, v in
                           (stats.get("kernel_launches") or {}).items()}
        for name in STACK_TRAIN_KERNELS:
            launches[name] += worker_launches.get(name, 0)
        health = client.get_inference_job_health(ijob["id"])
        kvd_stats = manager.kvd_stats(max_age_s=0.0)
        progress("phase 30")
        st.update(url=url, best_id=best["id"])
        recovery_launches = recovery_phase(torch, np, st, images, want,
                                           ijob["id"], wid)
        meta, manager, app, client = (st["meta"], st["manager"],
                                      st["app"], st["client"])
        progress("phase 30 done")
        rec.update(
            deploy={"create_inference_job_s": create_s,
                    "worker_boot_s": worker_boot_s,
                    "first_answer_s": deploy_s},
            served={"images": len(images), "requests": 4,
                    "wall_s": wall_256,
                    "images_per_s": len(images) / wall_256,
                    "identical_to_predict": bool(
                        got.shape == want.shape and np.array_equal(got,
                                                                   want)),
                    "max_abs_diff": float(np.abs(got - want).max())
                    if got.shape == want.shape else None},
            rounds=rounds, phase_19_rounds=VIT_WORKER.get("rounds"),
            http_errors=http_errors[:5],
            answers_differing_from_predict=differing,
            inference_worker_launches=worker_launches,
            predictor={k: health.get(k) for k in (
                "requests_served", "queries_served", "latency_p50_s",
                "latency_p95_s", "e2e_hist_p50_s", "e2e_hist_p95_s")},
            kvd_stats=kvd_stats)
        client.stop_inference_job(ijob["id"])
        rec["free_slots_after_stop"] = manager.allocator.free_count()
    finally:
        from rafiki_tpu_torch.admin.proc import terminate_pid

        meta, app = st["meta"], st["app"]
        rows = [r for r in meta.get_services() if r["pid"]]
        pids = [int(r["pid"]) for r in rows]
        app.stop()
        stopped = True
        alive_after_stop = [p for p in pids if _alive(p)]
        # what an admin that failed mid-handover no longer holds
        for r in rows:
            terminate_pid(int(r["pid"]), float(r["start_time"] or 0))
    rec["children"] = len(pids)
    rec["children_alive_after_stop"] = alive_after_stop
    rec["launches"] = launches
    emit(rec)
    errored = [t for t in per_trial if t["status"] != "COMPLETED"]
    if errored or len(per_trial) != STACK_TUNE_TRIALS:
        raise AssertionError(f"stack trials did not complete: {errored}")
    if not rec["served"]["identical_to_predict"]:
        raise AssertionError("the Predictor's replies differ from the "
                             "direct predict of the best trial")
    if http_errors or differing:
        raise AssertionError(f"closed-loop requests failed: "
                             f"{http_errors[:3]}, {differing} answers "
                             "differing from predict")
    missing = [n for n in ("matmul_bias", "flash_attention_fwd",
                           "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")
               if train_launches.get(n, 0) <= 0]
    missing += [f"{n} (inference worker)" for n in ("matmul_bias",
                                                    "flash_attention_fwd")
                if worker_launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels that never launched in the stack's "
                             f"workers: {missing}")
    if rec["children_alive_after_stop"] or not stopped:
        raise AssertionError(f"children left alive: "
                             f"{rec['children_alive_after_stop']}")
    manager = st["manager"]
    if rec["free_slots_after_stop"] != manager.allocator.n_slots or \
            manager.allocator.free_count() != manager.allocator.n_slots:
        raise AssertionError("a device slot was not freed")
    return {"stack": launches, "recovery": recovery_launches}


# ---- phase 32: scale-out on one card: a pool that grows and shrinks
# ---- between two slots of the card, the autoscaler, fault injection

#: phase 32 (b)'s model: phase 20's head-dim-8 f32 Llama at max_len 128
SCALE_LLAMA = dict(vocab_size=1024, hidden_dim=32, depth=2, n_heads=4,
                   kv_ratio=2, lora_rank=4, max_len=128, bf16=False)
#: phase 32 (b)'s deployment: the autoscaler between one and two workers,
#: a page pool of 48 usable 8-token pages (six requests of up to 64
#: tokens at a time, so 16 streams stall one worker's admission and
#: still stall two), and a short cooldown between scale actions
SCALE_BUDGET = {"AUTOSCALE": 1, "MIN_WORKERS": 1, "MAX_WORKERS": 2,
                "AUTOSCALE_COOLDOWN_S": 15.0, "KV_PAGE_SIZE": 8,
                "KV_PAGES": 49, "MAX_NEW_TOKENS": 48}
#: phase 32 (b)'s closed-loop stream clients and distinct prompts
SCALE_STREAMS = 16
SCALE_PROMPTS = 48
#: the scaled-up worker's RAFIKI_CHAOS: it dies after this many tokens.
#: The Predictor sends every new stream to it until it stalls (the first
#: worker stalls all along), and it stalls only past six streams, so its
#: first 400 tokens end with at least four streams seated there: fewer
#: than four seated make at most 3 tokens a step, and the first worker's
#: six seated streams each end within 48 of its steps
SCALE_KILL_AFTER = 400
#: phase 32 (a)'s closed loops: (clients, requests per client), phase
#: 23's sizes
SCALE_LOOP_16 = (16, 16)
SCALE_LOOP_1 = (1, 40)


def _worker_metrics(workdir, wid):
    """A live worker's ``/metrics`` gauges, through the obs port in its
    ``obs_port_file``: ``{name: value}`` (empty when it does not
    answer)."""
    import urllib.request

    try:
        port = int((workdir / f"{wid}.obs_port").read_text().strip())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10.0) as r:
            text = r.read().decode()
    except (OSError, ValueError):
        return {}
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, _, value = line.partition(" ")
            try:
                out[name] = float(value)
            except ValueError:
                pass
    return out


def _launches_of(metrics):
    return {k[len("kernel_launches_"):]: int(v) for k, v in metrics.items()
            if k.startswith("kernel_launches_")}


class _StreamLoad:
    """``n_clients`` closed-loop ``/predict_stream`` clients over HTTP,
    each through its own port ``Client`` (no automatic resume), cycling
    over ``prompts``: each stream's whole text (the final predictions
    and the accumulated deltas) held against ``want[prompt]``, its
    failovers, and the longest gap between two of its events; a
    failed-over stream keeps its events' times and its trace id
    (:meth:`failover_split` reads the Predictor's traces of them)."""

    def __init__(self, Client, url, prompts, want, n_clients):
        import threading

        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.done, self.differing, self.failed = 0, [], []
        self.failed_over, self.failover_gaps = 0, []
        #: (trace id, its events' seconds after the request was sent)
        self.failover_streams = []
        self._threads = [threading.Thread(
            target=self._client, args=(Client, url, prompts, want, c),
            daemon=True) for c in range(n_clients)]

    def _client(self, Client, url, prompts, want, c):
        cli = Client(timeout=120.0)
        k = 0
        while not self._stop.is_set():
            prompt = prompts[(c + k * len(self._threads)) % len(prompts)]
            k += 1
            acc, final, gap, times = "", {}, 0.0, []
            t_start = last = time.perf_counter()
            try:
                for ev in cli.predict_stream(url, [prompt], timeout=300.0,
                                             auto_resume=0):
                    now = time.perf_counter()
                    gap, last = max(gap, now - last), now
                    times.append(now - t_start)
                    if not isinstance(ev, dict):  # StreamInterrupted
                        final = {"error": repr(ev)[:200]}
                        break
                    if "delta" in ev:
                        acc += "".join(ev["delta"].values())
                    elif "replace" in ev:
                        acc = "".join(ev["replace"].values())
                    if ev.get("done"):
                        final = ev
            except Exception as e:  # counted, and the phase's gate
                final = {"error": repr(e)[:200]}
            with self._lock:
                if final.get("error") or not final.get("done"):
                    self.failed.append(str(final.get("error"))[:200])
                    continue
                text = (final.get("predictions") or [None])[0]
                self.done += 1
                if not (text == acc == want[prompt]):
                    self.differing.append({"prompt": prompt,
                                           "got": text, "deltas": acc,
                                           "want": want[prompt]})
                if (final.get("info") or {}).get("failovers"):
                    self.failed_over += 1
                    self.failover_gaps.append(gap)
                    self.failover_streams.append(
                        (final["info"].get("trace_id"), times))

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=400)
        self.hung = sum(t.is_alive() for t in self._threads)

    def failover_split(self, url):
        """Each failed-over stream's reason (the Predictor's
        ``worker_lost`` span, timed against the trace's first span) and
        the silence around it split in two: from the stream's last event
        before it to it (``detect_s``), and from it to the next event
        (``resume_s``: the re-submission's wait and prefill on the
        survivor)."""
        import urllib.request

        with urllib.request.urlopen(f"{url}/debug/requests?n=512",
                                    timeout=30.0) as r:
            traces = {t.get("trace_id"): t
                      for t in json.loads(r.read())["requests"]}
        reasons, detect, resume = {}, [], []
        with self._lock:
            streams = list(self.failover_streams)
        for tid, times in streams:
            spans = (traces.get(tid) or {}).get("spans") or []
            lost = [sp for sp in spans if sp.get("name") == "worker_lost"]
            if not spans or not lost:
                reasons["untraced"] = reasons.get("untraced", 0) + 1
                continue
            why = str(lost[0].get("reason"))
            reasons[why] = reasons.get(why, 0) + 1
            at = lost[0]["t"] - spans[0]["t"]
            before = [t for t in times if t <= at]
            after = [t for t in times if t > at]
            if before and after:
                detect.append(at - before[-1])
                resume.append(after[0] - at)
        return {"reasons": reasons,
                "detect_s": [round(x, 3) for x in sorted(detect)],
                "resume_s": [round(x, 3) for x in sorted(resume)]}

    def counts(self):
        with self._lock:
            return {"streams_done": self.done,
                    "differing": len(self.differing),
                    "first_difference": self.differing[:1],
                    "failed": len(self.failed),
                    "failures": self.failed[:3],
                    "failed_over": self.failed_over,
                    "longest_failover_silence_s": max(
                        self.failover_gaps, default=None)}


def _wait(cond, timeout, what, poll=0.05):
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 32: {what} within {timeout:.0f} s")
        time.sleep(poll)


def scaleout_phase(torch, np, vit, ll, store_params, HashTokenizer, dev):
    """Phase 32 (after 23): one inference job's pool grows and shrinks
    between two slots of the one card. The phase boots its own stack:
    the port's kvd, ``ServicesManager(platform="cuda", devices=[card
    0's DeviceSpec] * 2)``, the admin lease, ``Admin`` with its monitor,
    ``AdminApp`` and a port ``Client`` over HTTP. No training: each
    leg's trial is a seeded blob put into the stack's param store under
    a completed trial row.

    (a) ViT-B/16, bf16, 1000 classes (phase 19's blob), under
    closed-loop 1-image HTTP clients, every answer equal to the direct
    ``predict`` on the card bit for bit: one worker's requests/s at 16
    clients and p50 at 1; ``Client.scale_inference_job(job, 2)`` (the
    second worker on the card's second slot joins the published pool
    once its obs port reports; the call's seconds); requests/s at 16
    with two workers, each worker's kernel launches growing; a rolling
    restart of the two-worker pool under 4 clients (no failed request,
    no 503); ``scale_inference_job(job, 1)`` under 4 clients (the newest
    worker drains, membership first; the drain's seconds), its slot
    free.
    (b) ``SCALE_LLAMA`` (head dim 8, f32) as ``LlamaLoRA`` with
    ``SCALE_BUDGET`` (``AUTOSCALE`` between 1 and 2 workers), under
    ``SCALE_STREAMS`` closed-loop HTTP streams whose every text must
    equal a direct ``make_decode_engine`` run of the same prompts on the
    card: the admin's monitor grows the pool on admission stalls (never
    forced); ``RAFIKI_CHAOS=kill_after_tokens=SCALE_KILL_AFTER`` is in
    the admin's environment from the load's start until that scale-up
    has spawned, so it arms the new worker only, which dies with its
    streams in flight; the Predictor fails them over with forced
    prefixes, and the monitor respawns the worker under its budget
    (the job not degraded); the load stops and the monitor shrinks the
    pool back to one through the drain path.
    Each worker's launches come from its ``/metrics``; B7 and B3 (a),
    B1 and B2 (b) must launch in every worker read. Last the jobs and
    the stack stop: no child left, both slots free. Returns the paths
    ``scaleout_vit`` and ``scaleout_llama``."""
    import os
    import shutil
    import threading

    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.app import AdminApp
    from rafiki_tpu_torch.admin.proc import terminate_pid
    from rafiki_tpu_torch.admin.services_manager import (ServicesManager,
                                                         probe_devices)
    from rafiki_tpu_torch.client import Client
    from rafiki_tpu_torch.parallel.mesh import DeviceSpec
    from rafiki_tpu_torch.serving.queues import KVQueueHub
    from rafiki_tpu_torch.store.meta_store import MetaStore
    from rafiki_tpu_torch.store.param_store import ParamStore

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "scaleout"
    shutil.rmtree(work, ignore_errors=True)
    (work / "stack").mkdir(parents=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = DeviceSpec.from_probe(probe_devices()["devices"][0])
    meta = MetaStore(str(work / "stack" / "meta.db"))
    manager = ServicesManager(meta, str(work / "stack"), platform="cuda",
                              devices=[card] * 2, slot_size=1,
                              slot_timeout=300.0)
    manager.acquire_lease(ttl_s=STACK_LEASE_TTL_S)
    manager.start_lease_heartbeat()
    manager.start_data_plane()
    admin = Admin(meta, manager)
    admin.start_monitor(interval_s=0.3)
    app = AdminApp(admin)
    host, port = app.start()
    client = Client(f"http://{host}:{port}", timeout=600.0)
    hub = KVQueueHub(manager.kv_host, manager.kv_port)
    store = ParamStore.from_uri(manager.param_store_uri)
    wd = manager.workdir
    rec = {"phase": "scaleout", "card": smi,
           "slots": [[d.id for d in s.devices]
                     for s in manager.allocator._slots]}
    launches = {"scaleout_vit": {}, "scaleout_llama": {}}
    read = {}  # worker -> its kernel launches when read
    os.environ.pop("RAFIKI_CHAOS", None)

    def progress(step):
        print(f"scaleout: {step} at {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    def trial_of(model, name, knobs, blob):
        """A completed trial row of ``model`` with ``blob`` in the
        stack's param store; returns its train job."""
        tj = meta.create_train_job("smoke", name, 1, model["task"], {},
                                   "none", "none")
        sub = meta.create_sub_train_job(tj["id"], model["id"])
        t = meta.create_trial(sub["id"], 0, model["id"], knobs)
        store.save(t["id"], blob)
        meta.mark_trial_completed(t["id"], 1.0, True)
        return tj

    def read_launches(path, wid, need):
        m = _worker_metrics(wd, wid)
        got = _launches_of(m)
        read[f"{path}:{wid}:{len(read)}"] = got
        for k, v in got.items():
            launches[path][k] = launches[path].get(k, 0) + v
        missing = [k for k in need if got.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase 32: {missing} never launched in "
                                 f"worker {wid} ({got})")
        return m

    try:
        client.login("superadmin@rafiki", "rafiki")
        # ---- (a) ViT-B/16, one worker and two on one card
        images = np.random.default_rng(SEED + 19).integers(
            0, 256, (256, *VIT_IMAGE), dtype=np.uint8)
        vmodel = client.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                                     vit.ViTBase16)
        vmodel = meta.get_model(vmodel["id"])
        blob = vit_blob(torch, vit, store_params, dev, 1000)
        vjob = trial_of(vmodel, "scaleout-vit", VIT_KNOBS, blob)
        direct = vit.ViTBase16(device=dev, **VIT_KNOBS)
        direct.load_parameters(blob)
        want = np.asarray(direct.predict(list(images)), np.float32)
        del direct, blob
        torch.cuda.empty_cache()
        progress("vit blob stored")
        t0 = time.perf_counter()
        ij = client.create_inference_job(vjob["id"], max_workers=1)
        url, vid = ij["predictor_url"], ij["id"]
        w0 = f"iw-{vid[:8]}-0"
        _wait(lambda: (wd / f"{w0}.obs_port").exists(), 300,
              "the ViT worker came up")
        client.predict(url, [images[0]])
        a = {"deploy_s": time.perf_counter() - t0}
        progress("vit deployed")
        a["one_worker"] = {
            "at_16": _exact_loop(np, Client, url, images, want,
                                 *SCALE_LOOP_16),
            "at_1": _exact_loop(np, Client, url, images, want,
                                *SCALE_LOOP_1)}
        before = _launches_of(_worker_metrics(wd, w0))
        t0 = time.perf_counter()
        out = client.scale_inference_job(vid, 2, drain_timeout=120.0)
        a["scale_up"] = {"seconds_to_published_pool":
                         time.perf_counter() - t0, **out,
                         "published": hub.get_pool_members(vid)["workers"],
                         "free_slots": manager.allocator.free_count()}
        w1 = out["scaled_up"][0] if out.get("scaled_up") else None
        progress("vit scaled to 2")
        # the call returned once the Predictor routes over both workers
        client.predict(url, [images[0]])
        a["two_workers"] = {"at_16": _exact_loop(
            np, Client, url, images, want, *SCALE_LOOP_16)}
        a["gain_at_16"] = (a["two_workers"]["at_16"]["requests_per_s"]
                           / a["one_worker"]["at_16"]["requests_per_s"])
        progress("vit two-worker loop")
        # the two original workers, read just before the restart ends
        # them: both served the two-worker loop
        after = {w: read_launches("scaleout_vit", w,
                                  ("matmul_bias", "flash_attention_fwd"))
                 for w in (w0, w1)}
        a["two_workers"]["served_by_both"] = bool(
            _launches_of(after[w0]).get("matmul_bias", 0)
            > before.get("matmul_bias", 0)
            and _launches_of(after[w1]).get("matmul_bias", 0) > 0)
        with _Traffic(np, Client, url, images, want) as traffic:
            time.sleep(1.0)
            t0 = time.perf_counter()
            rr = client.rolling_restart_inference_job(
                vid, drain_timeout=120.0)
            a["rolling_restart_s"] = time.perf_counter() - t0
            time.sleep(1.0)
        a["rolling_restart"] = {**traffic.counts(),
                                "restarted": rr["restarted"]}
        progress("vit rolling restart")
        # the replacement of w1 before the scale-down drains it; w0's
        # after it
        read_launches("scaleout_vit", w1,
                      ("matmul_bias", "flash_attention_fwd"))
        with _Traffic(np, Client, url, images, want) as traffic:
            time.sleep(1.0)
            t0 = time.perf_counter()
            out = client.scale_inference_job(vid, 1, drain_timeout=120.0)
            a["drain_s"] = time.perf_counter() - t0
            time.sleep(1.0)
        a["scale_down"] = {**traffic.counts(), **out,
                           "published": hub.get_pool_members(vid)["workers"]}
        _wait(lambda: manager.allocator.free_count() == 1, 60,
              "the drained worker's slot came free")
        a["scale_down"]["free_slots"] = manager.allocator.free_count()
        read_launches("scaleout_vit", w0,
                      ("matmul_bias", "flash_attention_fwd"))
        client.stop_inference_job(vid)
        _wait(lambda: manager.allocator.free_count() == 2, 60,
              "both slots came free after the ViT job")
        rec["vit"] = a
        progress("vit done")

        # ---- (b) LlamaLoRA head dim 8, the monitor's autoscaler, a kill
        k = SCALE_LLAMA
        gen = torch.Generator().manual_seed(SEED + 32)
        net = ll.Llama(vocab_size=k["vocab_size"], max_len=k["max_len"],
                       hidden_dim=k["hidden_dim"], depth=k["depth"],
                       n_heads=k["n_heads"],
                       n_kv_heads=k["n_heads"] // k["kv_ratio"],
                       mlp_dim=4 * k["hidden_dim"],
                       lora_rank=k["lora_rank"], device="cpu",
                       generator=gen)
        randomize_lora_b(net, gen)
        with torch.no_grad():
            # PAD and BOS never win the argmax, and every other id has a
            # word that hashes back to it: a delivered text re-encodes to
            # its own ids, which a failover's forced prefix relies on
            net.lm_head.kernel[:, :2] = 0.0
        hash_tok = HashTokenizer(k["vocab_size"])
        id2tok = {}
        for i in range(20000):
            id2tok.setdefault(hash_tok.token_id(f"w{i}"), f"w{i}")
        lblob = {"params": store_params.params_to_jax(net.state_dict()),
                 "meta": {"id2tok": {str(i): w for i, w in
                                     id2tok.items()}}}
        del net
        lmodel = client.create_model("llama-hd8", "LANGUAGE_MODELING",
                                     ll.LlamaLoRA)
        lmodel = meta.get_model(lmodel["id"])
        ljob = trial_of(lmodel, "scaleout-llama", SCALE_LLAMA, lblob)
        rng = np.random.default_rng(SEED + 32)
        prompts = [" ".join(f"w{int(w)}" for w in rng.integers(
            0, 20000, size=int(rng.integers(6, 15))))
            for _ in range(SCALE_PROMPTS)]
        ref = ll.LlamaLoRA(device=dev, **SCALE_LLAMA)
        ref.load_parameters(lblob)
        eng = ref.make_decode_engine(
            max_slots=8, max_new_tokens=SCALE_BUDGET["MAX_NEW_TOKENS"],
            kv_page_size=SCALE_BUDGET["KV_PAGE_SIZE"])
        for i, p in enumerate(prompts):
            eng.submit(i, p)
        texts = {}
        for _ in range(20000):
            if not eng.busy:
                break
            eng.step()
            texts.update(dict(eng.poll()))
        lwant = {prompts[i]: t for i, t in texts.items()}
        del eng, ref
        if len(lwant) != len(prompts) or any("<" in t for t in
                                             lwant.values()):
            raise AssertionError("phase 32: the reference texts do not "
                                 "re-encode to their own ids")
        torch.cuda.empty_cache()
        b = {"reference_texts": len(lwant)}
        # (a)'s manual scale counted too: (b) reads the counters' growth
        base = manager.scaling.snapshot()
        t0 = time.perf_counter()
        ij = client.create_inference_job(ljob["id"], max_workers=1,
                                         budget=dict(SCALE_BUDGET))
        lurl, lid = ij["predictor_url"], ij["id"]
        l0, l1 = f"iw-{lid[:8]}-0", f"iw-{lid[:8]}-1"
        _wait(lambda: (wd / f"{l0}.obs_port").exists(), 300,
              "the Llama worker came up")
        b["deploy_s"] = time.perf_counter() - t0
        progress("llama deployed")
        marks = {}

        def watch(stop):
            """Stamp the first stall, the scale-up, the new worker's
            first pick; take RAFIKI_CHAOS out of the admin's env once
            the scale-up has spawned."""
            while not stop.is_set():
                now = time.perf_counter()
                s0 = hub.get_worker_stats(l0) or {}
                if "stall" not in marks and \
                        s0.get("engine_admission_stalls", 0) > 0:
                    marks["stall"] = now
                if "up" not in marks and \
                        manager.scaling["autoscale_ups"] > \
                        base["autoscale_ups"]:
                    marks["up"] = now
                    os.environ.pop("RAFIKI_CHAOS", None)
                if "up" in marks and "pick" not in marks:
                    m1 = _worker_metrics(wd, l1)
                    if m1.get("tokens_generated", 0) > 0:
                        marks["pick"] = now
                if "respawn" not in marks and \
                        manager.respawn_stats()["respawns_done"] >= 1:
                    # the killed worker's stand-in is booting: the pool
                    # the Predictor is told routes around it
                    marks["respawn"] = now
                    marks["pool_while_respawning"] = \
                        hub.get_pool_members(lid)["workers"]
                stop.wait(0.05)

        stop_watch = threading.Event()
        watcher = threading.Thread(target=watch, args=(stop_watch,),
                                   daemon=True)
        os.environ["RAFIKI_CHAOS"] = f"kill_after_tokens={SCALE_KILL_AFTER}"
        t_load = time.perf_counter()
        watcher.start()
        with _StreamLoad(Client, lurl, prompts, lwant,
                         SCALE_STREAMS) as load:
            _wait(lambda: "up" in marks, 120, "the monitor scaled up")
            progress("llama scaled up")
            _wait(lambda: manager.respawn_stats()["respawns_done"] >= 1,
                  180, "the chaos-killed worker was respawned")
            progress("llama worker respawned")
            _wait(lambda: load.counts()["failed_over"] >= 1
                  and _worker_metrics(wd, l1).get("requests_done", 0) > 0,
                  180, "the streams failed over and the respawned "
                       "worker served")
            health = client.get_inference_job_health(lid)
            b["router_while_two"] = (health.get("router") or {})
            m0, m1 = (_worker_metrics(wd, w) for w in (l0, l1))
            b["requests_done_while_two"] = {
                l0: m0.get("requests_done"), l1: m1.get("requests_done")}
            for w in (l0, l1):
                read_launches("scaleout_llama", w,
                              ("paged_decode_attention",
                               "paged_window_attention"))
            time.sleep(1.0)
        stop_watch.set()
        watcher.join(timeout=10)
        os.environ.pop("RAFIKI_CHAOS", None)
        b["downs_under_load"] = (manager.scaling["autoscale_downs"]
                                 - base["autoscale_downs"])
        b["load"] = load.counts()
        b["load"]["hung_clients"] = load.hung
        # the reading of the dead worker's routing: why each stream
        # failed over, and how its silence splits
        b["failover_split"] = load.failover_split(lurl)
        b["load_s"] = time.perf_counter() - t_load
        progress("llama load stopped")
        t0 = time.perf_counter()
        _wait(lambda: manager.scaling["autoscale_downs"]
              > base["autoscale_downs"]
              and manager.scaleout_status(lid)["victim"] is None
              and manager.allocator.free_count() == 1, 120,
              "the monitor shrank the pool back to one")
        b["shrink_s"] = time.perf_counter() - t0
        b["scaling"] = {k: v - base[k] for k, v in
                        manager.scaling.snapshot().items()}
        b["status"] = manager.scaleout_status(lid)
        b["published"] = hub.get_pool_members(lid)["workers"]
        b["respawns"] = manager.respawn_stats()
        b["job_status"] = meta.get_inference_job(lid)["status"]
        b["seconds_stall_to_up"] = marks["up"] - marks.get("stall",
                                                           marks["up"])
        b["pool_while_respawning"] = marks.get("pool_while_respawning")
        b["seconds_stall_to_first_pick"] = (
            marks["pick"] - marks.get("stall", marks["up"])
            if "pick" in marks else None)
        client.stop_inference_job(lid)
        _wait(lambda: manager.allocator.free_count() == 2, 60,
              "both slots came free after the Llama job")
        rec["llama"] = b
        progress("llama done")
    finally:
        os.environ.pop("RAFIKI_CHAOS", None)
        rows = [r for r in meta.get_services() if r["pid"]]
        pids = [int(r["pid"]) for r in rows]
        app.stop()
        alive = [p for p in pids if _alive(p)]
        for r in rows:
            terminate_pid(int(r["pid"]), float(r["start_time"] or 0))
    rec["children"] = len(pids)
    rec["children_alive_after_stop"] = alive
    rec["free_slots_after_stop"] = manager.allocator.free_count()
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)

    errs = []
    a, b = rec["vit"], rec["llama"]
    steps = {"one_worker_16": a["one_worker"]["at_16"],
             "one_worker_1": a["one_worker"]["at_1"],
             "two_workers_16": a["two_workers"]["at_16"]}
    for name, r in steps.items():
        if r["failed"] or r["rejected_503"] or r["differing"]:
            errs.append(f"(a) {name}: {r}")
    for name in ("rolling_restart", "scale_down"):
        r = a[name]
        if r["failed"] or r["answers_differing_from_predict"] or \
                r["hung_clients"]:
            errs.append(f"(a) {name}: {r}")
    if a["rolling_restart"]["rejected"]:
        errs.append(f"(a) 503s in the two-worker rolling restart: "
                    f"{a['rolling_restart']['rejected']}")
    if a["scale_up"]["published"] != [w0, w1] or \
            a["scale_down"]["published"] != [w0]:
        errs.append(f"(a) pool memberships: {a['scale_up']['published']} "
                    f"{a['scale_down']['published']}")
    if not a["two_workers"]["served_by_both"]:
        errs.append("(a) the two-worker loop was not served by both")
    if b["load"]["failed"] or b["load"]["differing"] or \
            b["load"]["hung_clients"]:
        errs.append(f"(b) streams: {b['load']}")
    if b["load"]["failed_over"] < 4:
        errs.append(f"(b) fewer than 4 streams were in flight on the "
                    f"killed worker: {b['load']['failed_over']}")
    if b["scaling"]["autoscale_ups"] < 1 or \
            b["scaling"]["autoscale_downs"] < 1 or b["downs_under_load"]:
        errs.append(f"(b) the monitor did not scale up under the load "
                    f"and down after it: {b['scaling']}, "
                    f"{b['downs_under_load']} down under the load")
    # the policy drains the member with the fewest live pages (ties to
    # the newest), so either worker may be the one left
    if len(b["published"]) != 1 or b["published"][0] not in (l0, l1) or \
            b["job_status"] != "RUNNING" or b["respawns"]["degraded_jobs"]:
        errs.append(f"(b) pool {b['published']}, job {b['job_status']}, "
                    f"{b['respawns']}")
    if not all((b["requests_done_while_two"].get(w) or 0) > 0
               for w in (l0, l1)):
        errs.append(f"(b) picks on both workers: "
                    f"{b['requests_done_while_two']}")
    if alive or rec["free_slots_after_stop"] != 2:
        errs.append(f"children left {alive}, free slots "
                    f"{rec['free_slots_after_stop']}")
    if errs:
        raise AssertionError("phase 32: " + "; ".join(errs))
    return launches


# ---- Llama serving as its users run it (phases 24-25): a byte-BPE
# ---- tokenizer, an HF-layout pretrained base, seeded sampling, SLO
# ---- preemption and stream resume

#: phase 24's LlamaLoRA knobs: phase 18's widths, fine-tuned from the
#: checkpoint with only the adapters training
SLICE_KNOBS = dict(WORKER_LLAMA, bf16=True, rope_theta=500000.0,
                   batch_size=1, max_epochs=1, learning_rate=1e-3,
                   adapters_only=True)
#: phase 24's sampled requests: Llama-3's common serving settings
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
#: the trained merges before phase 24 extends the table to VOCAB
BPE_TRAIN_VOCAB = 1024


def _texts(path):
    with open(path) as f:
        return [rec["text"] for line in f if line.strip()
                for rec in [json.loads(line)] if "text" in rec]


def slice_tokenizer(np, bpe, work, vocab, seed):
    """A byte-BPE artifact of exactly ``vocab`` ids: merges trained on a
    seeded corpus (``write_corpus``), then seeded merges of an existing id
    with a byte id (distinct pairs, so every token stays short) until the
    table holds ``vocab - 259`` merges. Returns (path, train seconds, the
    corpus texts)."""
    texts = _texts(write_corpus(np, work / "bpe_corpus.jsonl", 256, seed))
    t0 = time.perf_counter()
    merges = list(bpe.ByteBPETokenizer.train(
        texts, BPE_TRAIN_VOCAB, native=False).merges)
    train_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    seen = set(merges)
    first = bpe.N_SPECIAL + 256
    while first + len(merges) < vocab:
        pair = (int(rng.integers(bpe.N_SPECIAL, first + len(merges))),
                int(rng.integers(bpe.N_SPECIAL, first)))
        if pair not in seen:
            seen.add(pair)
            merges.append(pair)
    path = work / "bpe.json"
    bpe.ByteBPETokenizer(merges, native=False).save(str(path))
    return str(path), train_s, texts


def _block_tree(torch, k, gen, dev, hidden, kv, mlp):
    """One decoder block's base leaves (no adapters) as the params tree
    lays them out, bf16 on the card, drawn from ``gen``."""
    def w(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(0.02).to(
                               torch.bfloat16)

    def norm():
        return (1.0 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
                ).to(torch.bfloat16)

    return {"attn": {"wq": {"kernel": w(hidden, hidden)},
                     "wk": {"kernel": w(hidden, kv)},
                     "wv": {"kernel": w(hidden, kv)},
                     "wo": {"kernel": w(hidden, hidden)}},
            "gate": {"kernel": w(hidden, mlp)}, "up": {"kernel": w(hidden,
                                                                   mlp)},
            "down": {"kernel": w(mlp, hidden)},
            "RMSNorm_0": {"scale": norm()}, "RMSNorm_1": {"scale": norm()}}


def write_checkpoint(torch, conv, sio, path, depth, vocab, dev,
                     blocks_per_shard=4):
    """A seeded HF-layout Llama checkpoint at phase 24's widths, bf16,
    written by the port's ``export_llama_safetensors`` shard by shard
    (``model-0000i-of-0000n.safetensors``, the embedding in the first,
    the final norm and LM head in the last) with HF's
    ``model.safetensors.index.json`` and a ``config.json`` carrying
    ``rope_theta``. Each shard's leaves are drawn on the card and freed
    after writing. Raises before writing when the disk lacks the room.
    Returns (bytes written, seconds)."""
    import shutil

    w = WORKER_LLAMA
    hidden = w["hidden_dim"]
    kv = hidden // w["kv_ratio"]
    mlp = 4 * hidden
    per_block = 2 * (2 * hidden * hidden + 2 * hidden * kv
                     + 3 * hidden * mlp + 2 * hidden)
    need = depth * per_block + 2 * (2 * vocab * hidden + hidden)
    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    if free < need + (1 << 30):
        raise RuntimeError(
            f"phase 24 needs {need / 1e9:.2f} GB (+1 GB) free under {path} "
            f"for its checkpoint, has {free / 1e9:.2f} GB: short by "
            f"{(need + (1 << 30) - free) / 1e9:.2f} GB; cut --slice-depth")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    groups = [list(range(i, min(i + blocks_per_shard, depth)))
              for i in range(0, depth, blocks_per_shard)]
    n = len(groups)
    weight_map = {}
    t0 = time.perf_counter()
    for g, blocks in enumerate(groups):
        tree = {f"block_{i}": _block_tree(torch, i, gen, dev, hidden, kv,
                                          mlp) for i in blocks}
        if g == 0:
            tree["tok_embed"] = {"embedding": torch.randn(
                vocab, hidden, generator=gen, device=dev).mul_(0.02).to(
                    torch.bfloat16)}
        if g == n - 1:
            tree["final_norm"] = {"scale": torch.ones(
                hidden, device=dev, dtype=torch.bfloat16)}
            tree["lm_head"] = {"kernel": torch.randn(
                hidden, vocab, generator=gen, device=dev).mul_(0.02).to(
                    torch.bfloat16)}
        fname = f"model-{g + 1:05d}-of-{n:05d}.safetensors"
        conv.export_llama_safetensors(tree, str(path / fname))
        del tree
        weight_map.update({name: fname for name in
                           sio.SafeFile(str(path / fname)).keys()})
    nbytes = sum((path / f).stat().st_size for f in set(weight_map.values()))
    with open(path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": nbytes},
                   "weight_map": weight_map}, f)
    with open(path / "config.json", "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "hidden_size": hidden, "intermediate_size": mlp,
                   "num_hidden_layers": depth,
                   "num_attention_heads": w["n_heads"],
                   "num_key_value_heads": w["n_heads"] // w["kv_ratio"],
                   "vocab_size": vocab, "rope_theta": 500000.0,
                   "torch_dtype": "bfloat16"}, f)
    return nbytes, time.perf_counter() - t0


class RssPeak:
    """The process's largest resident set between :meth:`start` and
    :meth:`stop`, sampled from ``/proc/self/statm`` every 50 ms on a
    thread (``gb`` is None where that file cannot be read; ``getrusage``
    gives only the peak over the process's whole life)."""

    def start(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.gb, self._stop = None, threading.Event()
        self._t = threading.Thread(target=self._sample, daemon=True)
        self._t.start()
        return self

    def _sample(self):
        while True:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * self.page / 1e9
                self.gb = max(self.gb or 0.0, rss)
            except (OSError, ValueError, IndexError):
                return
            if self._stop.wait(0.05):
                return

    def stop(self):
        self._stop.set()
        self._t.join()


def _prompt_ids(np, tok, text, max_len):
    """A text's BOS-led ids, as the template's engine encodes them."""
    row, n = tok.encode(text, max_len)
    return np.asarray(row[:max(1, int(n))], np.int32)


def _paged_counts(pa):
    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            "paged_window_attention": pa.paged_window_attention.launches}


def _zero_paged(pa):
    pa.paged_decode_attention.launches = 0
    pa.paged_window_attention.launches = 0


def _run_engine(core, submits, on_step=None, limit=20000):
    """Submit ``(rid, ids, max_new, kwargs)`` requests to a core engine
    and step it until they are done (``on_step(n)`` may submit more);
    returns {rid: ids} of every request done, the steps' (seconds, ran a
    prefill, tokens), and each submitted request's seconds to its first
    token on the host clock."""
    t_sub, t_first, done, steps = {}, {}, {}, []
    for rid, ids, max_new, kw in submits:
        core.submit(rid, ids, max_new, **kw)
        t_sub[rid] = time.perf_counter()
    while not set(t_sub) <= set(done):
        before = core.stats_snapshot()
        t0 = time.perf_counter()
        core.step()
        t1 = time.perf_counter()
        after = core.stats_snapshot()
        steps.append((t1 - t0, after["prefill_calls"] > before[
            "prefill_calls"], after["tokens_generated"]
            - before["tokens_generated"]))
        for rid, _ids in core.poll_partial():
            t_first.setdefault(rid, t1)
        for rid, ids in core.poll():
            done[rid] = [int(t) for t in ids]
            t_first.setdefault(rid, t1)
        if on_step is not None:
            on_step(len(steps))
        if len(steps) > limit:
            raise AssertionError(f"engine did not drain: {core.stats}")
    return done, steps, {rid: t_first[rid] - t_sub[rid] for rid in t_sub}


def slice_phase(torch, np, ll, de, pa, fa, conv, sio, bpe, ps, sp, depth,
                dev):
    """Phase 24: Llama serving as its users run it, at phase 18's widths
    (bf16, hidden 4096, 32 / 8 heads, MLP 4 x hidden, vocab 128256, LoRA
    rank 16, rope theta 500000; depth ``--slice-depth``): a byte-BPE
    artifact of exactly 128256 ids; a seeded HF-layout checkpoint written
    by ``export_llama_safetensors`` (sharded, ``index.json``,
    ``config.json``); ``LlamaLoRA(tokenizer_path=, pretrained_path=,
    adapters_only=True).train`` over one epoch of two batches (B3/B5/B6
    must launch; every frozen leaf must equal the checkpoint's tensor);
    then its ``make_decode_engine`` (paged, page 16, 8 slots, max_len
    2048): 8 greedy and 8 sampled requests (temperature 0.8, top-k 50,
    top-p 0.95, seeds 0-7; the card's ``_select_next`` on one step's
    logits must pick the CPU's tokens), 8 long background requests
    preempted by 2 interactive ones (``preemptions`` >= 1, equal to the
    ``preempted`` spans, every request its full token count; TTFT beside
    an idle engine's), and one request resumed from half its delivered
    text (its output must begin with it and have its budget). B1/B2 must
    launch on every serving leg."""
    import gc
    import shutil

    from rafiki_tpu_torch.model.base import TrainContext

    work = ROOT / "build" / "chip_smoke" / "slice"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec = {"phase": "llama_slice", "depth": depth,
           "widths": dict(WORKER_LLAMA, mlp_dim=4 * WORKER_LLAMA[
               "hidden_dim"])}
    paths = {}
    rss = RssPeak().start()
    try:
        # 1. the tokenizer
        t0 = time.perf_counter()
        tok_path, bpe_train_s, bpe_texts = slice_tokenizer(
            np, bpe, work, VOCAB, SEED + 24)
        tok = bpe.ByteBPETokenizer.load(tok_path)
        loop = bpe.ByteBPETokenizer.load(tok_path, native=False)
        rec["tokenizer"] = {"vocab": tok.vocab_size,
                            "trained_merges": BPE_TRAIN_VOCAB - 259,
                            "train_s": bpe_train_s,
                            "artifact_s": time.perf_counter() - t0}
        if tok.vocab_size != VOCAB:
            raise AssertionError(f"BPE vocab {tok.vocab_size} != {VOCAB}")
        # 2. the checkpoint
        ckpt = work / "ckpt"
        nbytes, write_s = write_checkpoint(torch, conv, sio, ckpt, depth,
                                           VOCAB, dev)
        rec["checkpoint"] = {"bytes": nbytes, "write_s": write_s,
                             "write_gb_per_s": nbytes / write_s / 1e9,
                             "shards": len(list(ckpt.glob("*.safetensors")))}
        torch.cuda.empty_cache()
        # 3. the fine-tune: two texts, batch 1
        train = work / "train.jsonl"
        write_corpus(np, train, 2, SEED + 25)
        knobs = dict(SLICE_KNOBS, depth=depth, tokenizer_path=tok_path,
                     pretrained_path=str(ckpt))
        m = ll.LlamaLoRA(device=dev, **knobs)
        timed = {}
        real_import = ll.import_llama_safetensors

        def timed_import(path, params):
            s0 = time.perf_counter()
            out = real_import(path, params)
            timed["import_s"] = time.perf_counter() - s0
            return out

        ll.import_llama_safetensors = timed_import
        zero_flash_launches(fa)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            ctx = TrainContext()
            m.train(str(train), ctx)
        finally:
            ll.import_llama_safetensors = real_import
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_launches = flash_launches(fa)
        paths["llama_slice_finetune"] = train_launches
        # every frozen (base) leaf against the file, tensor by tensor
        files = conv._resolve_checkpoint(str(ckpt))
        handles, frozen, unequal = {}, 0, []
        for path, leaf in conv._flatten(m._params):
            mapped = conv.hf_name_for(path)
            if mapped is None:
                continue
            name, transpose = mapped
            sf = handles.setdefault(files[name], sio.SafeFile(files[name]))
            frozen += 1
            if not np.array_equal(conv._read(sf, name, transpose), leaf):
                unequal.append(name)
        rec["finetune"] = {
            "train_s": train_s, "frozen_check_s": time.perf_counter() - t0,
            "import_s": timed.get("import_s"),
            "import_gb_per_s": nbytes / timed["import_s"] / 1e9
            if timed.get("import_s") else None,
            "losses": ctx.logger.get_values("loss"),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": train_launches, "frozen_leaves": frozen,
            "frozen_unequal": unequal}
        if min(train_launches.values()) <= 0:
            raise AssertionError(f"a flash kernel never launched in the "
                                 f"fine-tune: {train_launches}")
        if unequal or not frozen:
            raise AssertionError(f"frozen leaves differ from the "
                                 f"checkpoint: {unequal}")
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # 4. serving
        slots, max_len = 8, int(knobs["max_len"])
        eng = m.make_decode_engine(max_slots=slots, max_new_tokens=64,
                                   steps_per_sync=4, kv_page_size=16)
        core = eng.engine
        texts = _texts(write_corpus(np, work / "serve.jsonl", 32,
                                    SEED + 26))
        t0 = time.perf_counter()
        prompts = [_prompt_ids(np, tok, t, max_len) for t in texts]
        encode_s = time.perf_counter() - t0
        loop_ids = [_prompt_ids(np, loop, t, max_len) for t in texts]
        rec["tokenizer"].update(
            encode_ms_per_prompt=encode_s / len(texts) * 1e3,
            prompt_tokens=[len(p) for p in prompts[:16]],
            native_equals_python_loop=all(
                np.array_equal(a, b) for a, b in zip(prompts, loop_ids)))
        if not rec["tokenizer"]["native_equals_python_loop"]:
            raise AssertionError("native BPE ids differ from the loop's")

        # 4a. greedy, then sampled (seeds 0-7), same prompts
        captured = []
        real_select = de._select_next

        def capture(*args):
            if not captured:
                captured.append([a.detach().clone() for a in args])
            return real_select(*args)

        legs = {}
        for leg in ("greedy", "sampled"):
            kw = [dict(SAMPLING, seed=i) if leg == "sampled" else {}
                  for i in range(slots)]
            _zero_paged(pa)
            de._select_next = capture
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                done, steps, ttft = _run_engine(
                    core, [(f"{leg}{i}", prompts[i], 64, kw[i])
                           for i in range(slots)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                de._select_next = real_select
            launches = _paged_counts(pa)
            paths[f"llama_slice_{leg}"] = launches
            legs[leg] = {
                "wall_s": wall,
                "output_tok_per_s": sum(map(len, done.values())) / wall,
                "decode_tok_per_s": _decode_tok_per_s(steps),
                "mean_ttft_s": float(np.mean(list(ttft.values()))),
                "complete": all(len(v) == 64 for v in done.values()),
                "launches": launches}
            legs[leg]["tokens"] = done
        sampled_differ = sum(legs["sampled"]["tokens"][f"sampled{i}"]
                             != legs["greedy"]["tokens"][f"greedy{i}"]
                             for i in range(slots))
        greedy_tokens = legs["greedy"]["tokens"]
        for leg in legs.values():
            del leg["tokens"]
        # the card's sampler against the plain CPU one, one step's logits
        args = captured[0]
        card_pick = de._select_next(*args).cpu()
        cpu_pick = de._select_next(*(a.cpu() for a in args))
        sampler_ms = time_ms(torch, lambda: de._select_next(*args))
        greedy_ms = time_ms(torch, lambda: args[0].argmax(-1))
        rec["sampling"] = dict(
            legs, settings=SAMPLING, seeds=list(range(slots)),
            sampled_requests_unlike_greedy=int(sampled_differ),
            sampler_card_equals_cpu=bool(torch.equal(card_pick, cpu_pick)),
            sampler_ms_per_step=sampler_ms, argmax_ms_per_step=greedy_ms,
            logits_shape=list(args[0].shape))
        if not rec["sampling"]["sampler_card_equals_cpu"]:
            raise AssertionError(f"the card's sampler picked {card_pick}, "
                                 f"the CPU's {cpu_pick}")
        if not all(leg["complete"] for leg in legs.values()):
            raise AssertionError(f"a sampling-leg request was cut: {legs}")

        # 4b. preemption: 8 long background requests fill the slots, 2
        # interactive ones arrive two calls later; their TTFT (submit to
        # the first_token span, host clock) beside an idle engine's
        events = []
        core.span_sink = lambda ev, rid, attrs: events.append(
            (ev, rid, time.perf_counter()))
        bg = [(f"bg{i}", prompts[8 + i], 128, {"slo": "background"})
              for i in range(slots)]
        ia = [(f"ia{i}", prompts[16 + i], 32, {"slo": "interactive"})
              for i in range(2)]
        t_ia = {}

        def arrive(n_steps):
            if n_steps == 2:
                for rid, ids, max_new, kw in ia:
                    core.submit(rid, ids, max_new, **kw)
                    t_ia[rid] = time.perf_counter()

        def ttft(since):
            return {rid: next(t for ev, r, t in events
                              if ev == "first_token" and r == rid)
                    - since[rid] for rid in since}

        _zero_paged(pa)
        core.reset_stats()
        t0 = time.perf_counter()
        done, _steps, _t = _run_engine(core, bg, on_step=arrive)
        while len(done) < len(bg) + len(ia):
            core.step()
            done.update({rid: list(ids) for rid, ids in core.poll()})
        wall = time.perf_counter() - t0
        stats = core.stats_snapshot()
        n_spans = sum(ev == "preempted" for ev, _r, _t in events)
        contended = ttft(t_ia)
        events.clear()
        t_idle, idle_done = {}, {}
        for rid, ids, max_new, kw in ia:
            core.submit(rid, ids, max_new, **kw)
            t_idle[rid] = time.perf_counter()
        while len(idle_done) < len(ia):
            core.step()
            idle_done.update({rid: list(ids) for rid, ids in core.poll()})
        idle = ttft(t_idle)
        core.span_sink = None
        launches = _paged_counts(pa)
        paths["llama_slice_preempt"] = launches
        full = all(len(done[rid]) == n for rid, _i, n, _k in bg + ia)
        rec["preemption"] = {
            "background": {"requests": slots, "max_new": 128},
            "interactive": {"requests": 2, "max_new": 32,
                            "arrive_after_calls": 2},
            "wall_s": wall, "preemptions": stats["preemptions"],
            "preempted_spans": n_spans,
            "admission_stalls": stats["admission_stalls"],
            "interactive_ttft_s": contended,
            "interactive_ttft_idle_s": idle,
            "every_request_full": full,
            "interactive_equal_idle": all(
                done[r] == idle_done[r] for r in idle_done),
            "launches": launches}
        if stats["preemptions"] < 1 or stats["preemptions"] != n_spans:
            raise AssertionError(f"preemptions {stats['preemptions']}, "
                                 f"preempted spans {n_spans}")
        if not full:
            raise AssertionError("a preemption-leg request was cut")

        # 4c. stream resume: the text a stream had delivered halfway
        # (after k of 48 tokens, k <= 24 the largest whose text re-encodes
        # to fewer than 48 tokens: byte-BPE re-tokenizes generated bytes
        # into more ids than were generated) as the forced prefix
        text, budget = texts[24], 48
        _zero_paged(pa)
        whole, _s, _t = _run_engine(core, [
            ("whole", _prompt_ids(np, tok, text, max_len), budget, {})])
        ids = whole["whole"]
        n_text = len(tok.encode_ids(text))
        for k in range(budget // 2, 0, -1):
            prefix = m._detok(ids[:k]).rstrip("\ufffd")
            covered = len(tok.encode_ids(text + " " + prefix)) - n_text
            if prefix and covered < budget:
                break
        before = core.stats_snapshot()["tokens_generated"]
        eng.submit("resumed", text, max_new=budget, forced_prefix=prefix)
        resumed = {}
        while not resumed:
            eng.step()
            resumed.update(dict(eng.poll()))
        generated = core.stats_snapshot()["tokens_generated"] - before
        launches = _paged_counts(pa)
        paths["llama_slice_resume"] = launches
        out = resumed["resumed"]
        rec["resume"] = {"delivered_tokens": k, "prefix_chars": len(prefix),
                         "prefix_tokens": covered, "generated": generated,
                         "budget": budget,
                         "starts_with_prefix": out.startswith(prefix),
                         "has_its_budget": covered + generated == budget,
                         "equals_uninterrupted": out == m._detok(ids),
                         "launches": launches}
        if not (out.startswith(prefix) and covered + generated == budget):
            raise AssertionError(f"resume failed: {rec['resume']}")
        for name, counts in paths.items():
            if name != "llama_slice_finetune" and min(counts.values()) <= 0:
                raise AssertionError(f"a paged kernel never launched on "
                                     f"{name}: {counts}")
        emit(dict(rec, host_peak_rss_gb=rss.gb))
        # 5. phase 26 on the same fine-tuned model
        del eng, core
        gc.collect()
        torch.cuda.empty_cache()
        paths.update(decode_modes_phase(
            torch, np, ll, pa, conv, ps, sp, m, tok, prompts, texts,
            greedy_tokens, depth, dev))
        # 6. phase 29 on the same fine-tuned model
        paths.update(tier_disagg_phase(torch, np, ll, de, pa, m, tok,
                                       texts, depth, dev))
        del m
    finally:
        rss.stop()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "llama_slice_memory", "host_peak_rss_gb": rss.gb,
          "process_peak_rss_gb": _peak_rss_gb()})
    return paths


#: phase 26's draft model: Llama-3.2-1B's published shape (hidden 2048,
#: 16 layers, 32 heads over 8 kv heads, head dim 64, MLP 8192 = 4 x
#: hidden; its tied embedding untied, as the template builds it), phase
#: 24's BPE artifact and max_len
DRAFT_LLAMA = {"hidden_dim": 2048, "depth": 16, "n_heads": 32,
               "kv_ratio": 4, "lora_rank": 16}
#: phase 26's verify window width, system-prompt tokens and the new
#: tokens of its prefix leg
SPEC_K = 4
PREFIX_TOKENS = 512
PREFIX_NEW = 32


def variant_tree(np, tree, seed):
    """``tree`` (a params tree, its other leaves shared) with every
    ``lora_b`` leaf a fresh seeded N(0, 0.02^2) f32 array: a second
    fine-tune of the same base."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (0.02 * rng.standard_normal(np.shape(v))).astype(
                    np.float32) if k == "lora_b" else v
                for k, v in node.items()}

    return walk(tree)


def _first_diffs(got, want):
    """{rid: first differing token index} of the requests whose tokens
    differ."""
    return {rid: next((i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                       if a != b), min(len(got[rid]), len(want[rid])))
            for rid in want if got.get(rid) != want[rid]}


def _leg(torch, np, pa, core, submits):
    """Run ``submits`` on ``core`` with the paged counters zeroed: its
    tokens, wall seconds, decode tokens/s, mean TTFT (host clock), the
    engine's counters and the launches."""
    _zero_paged(pa)
    core.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps, ttft = _run_engine(core, submits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tokens": done, "wall_s": wall,
            "decode_tok_per_s": _decode_tok_per_s(steps),
            "mean_ttft_s": float(np.mean(list(ttft.values()))),
            "stats": core.stats_snapshot(), "launches": _paged_counts(pa)}


def decode_modes_phase(torch, np, ll, pa, conv, ps, sp, m, tok, prompts,
                       texts, greedy, depth, dev):
    """Phase 26: the decode modes Llama's users switch on, through phase
    24's fine-tuned model (bf16, paged, page 16, 8 slots, max_len 2048):

    (a) prompt-lookup speculation (``speculate_k`` 4) on phase 24's 8
        greedy requests: tokens equal to the greedy leg's; B2 launched at
        least ``spec_calls`` x depth times;
    (b) draft-model speculation with a seeded ``LlamaLoRA`` at
        Llama-3.2-1B's shape (``DRAFT_LLAMA``, the same BPE artifact and
        max_len): tokens equal to the greedy leg's;
    (d) a 512-token system prefix registered, 8 requests extending it:
        tokens equal to a no-prefix engine's on the same full prompts,
        ``prefix_hits`` 8; then ``export_prefix`` through the param-store
        codec into a fresh engine's ``import_prefix``: the same tokens;
    (c) multi-adapter serving, N = 2 (adapter 0 the fine-tune, adapter 1
        the same tree with seeded ``lora_b``): the 8 requests alternate
        adapters in one engine and each equals its solo single-adapter
        engine's (adapter 0: the greedy leg; adapter 1: the fine-tune's
        engine with the variant's adapters swapped in). The fine-tune's
        own serving model is freed before the stacked one is built.

    B1/B2 must launch on every leg (the ``llama_modes_*`` paths)."""
    import gc

    t_phase = time.perf_counter()
    slots, max_len, max_new = 8, int(m.knobs["max_len"]), 64
    kw = dict(max_slots=slots, max_new_tokens=max_new, steps_per_sync=4,
              kv_page_size=16)
    reqs = [(f"greedy{i}", prompts[i], max_new, {}) for i in range(slots)]
    rec = {"phase": "llama_decode_modes", "depth": depth,
           "draft_shape": DRAFT_LLAMA, "speculate_k": SPEC_K}
    paths = {}

    def summary(leg, **extra):
        st = leg["stats"]
        out = {k: leg[k] for k in ("wall_s", "decode_tok_per_s",
                                   "mean_ttft_s", "launches")}
        out.update({k: st[k] for k in (
            "spec_calls", "spec_drafted", "spec_accepted",
            "spec_draft_model_calls", "draft_resyncs", "prefix_hits",
            "prefix_tokens", "kv_imports", "steps", "prefill_calls")})
        out["acceptance"] = (st["spec_accepted"] / st["spec_drafted"]
                             if st["spec_drafted"] else None)
        out.update(extra)
        return out

    def free(*objs):
        del objs
        gc.collect()
        torch.cuda.empty_cache()

    # (a) prompt lookup
    eng = m.make_decode_engine(speculate_k=SPEC_K, **kw)
    leg = _leg(torch, np, pa, eng.engine, reqs)
    paths["llama_modes_prompt_lookup"] = leg["launches"]
    spec_calls = leg["stats"]["spec_calls"]
    rec["prompt_lookup"] = summary(
        leg, tokens_equal_greedy=leg["tokens"] == greedy,
        first_diffs=_first_diffs(leg["tokens"], greedy),
        verify_window_launches_at_least=spec_calls * depth)
    free(eng)
    if leg["tokens"] != greedy:
        raise AssertionError(f"prompt-lookup tokens differ from greedy: "
                             f"{rec['prompt_lookup']}")
    if spec_calls < 1 or leg["launches"]["paged_window_attention"] < \
            spec_calls * depth:
        raise AssertionError(f"verify windows did not run through B2: "
                             f"{rec['prompt_lookup']}")

    # (b) a draft model at Llama-3.2-1B's shape
    t0 = time.perf_counter()
    dknobs = dict(m.knobs, pretrained_path="", **DRAFT_LLAMA)
    draft = ll.LlamaLoRA(device=dev, **dknobs)
    net = draft._module()
    randomize_lora_b(net, torch.Generator(device=dev).manual_seed(SEED + 26))
    draft._set_params(sp.params_to_jax(net.state_dict()), own=True)
    draft_params = sum(int(np.prod(np.shape(leaf)))
                       for _path, leaf in conv._flatten(draft._params))
    del net
    build_s = time.perf_counter() - t0
    eng = m.make_decode_engine(speculate_k=SPEC_K, draft_model=draft, **kw)
    leg = _leg(torch, np, pa, eng.engine, reqs)
    paths["llama_modes_draft"] = leg["launches"]
    rec["draft_model"] = summary(
        leg, tokens_equal_greedy=leg["tokens"] == greedy,
        first_diffs=_first_diffs(leg["tokens"], greedy),
        draft_params=draft_params, draft_build_s=build_s)
    free(eng, draft)
    if leg["tokens"] != greedy or leg["stats"][
            "spec_draft_model_calls"] < 1:
        raise AssertionError(f"draft-model speculation: "
                             f"{rec['draft_model']}")

    # (d) a 512-token system prefix
    bos = _prompt_ids(np, tok, texts[0], max_len)[:1]
    prefix = np.concatenate([bos] + [tok.encode_ids(t) for t in texts])[
        :PREFIX_TOKENS].astype(np.int32)
    full = [np.concatenate([prefix, tok.encode_ids(texts[i])]).astype(
        np.int32)[:max_len - PREFIX_NEW] for i in range(slots)]
    preq = [(f"p{i}", full[i], PREFIX_NEW, {}) for i in range(slots)]
    kwp = dict(kw, max_new_tokens=PREFIX_NEW)
    eng = m.make_decode_engine(**kwp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.engine.register_prefix(prefix)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    with_prefix = _leg(torch, np, pa, eng.engine, preq)
    blob = eng.engine.export_prefix()
    t0 = time.perf_counter()
    wire = ps.params_from_bytes(ps.params_to_bytes(blob))
    codec_s = time.perf_counter() - t0
    free(eng)
    eng = m.make_decode_engine(**kwp)
    without = _leg(torch, np, pa, eng.engine, preq)
    free(eng)
    eng = m.make_decode_engine(**kwp)
    t0 = time.perf_counter()
    eng.engine.import_prefix(wire)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    kv_imports = eng.engine.stats["kv_imports"]
    imported = _leg(torch, np, pa, eng.engine, preq)
    free(eng, wire)
    paths["llama_modes_prefix"] = with_prefix["launches"]
    paths["llama_modes_prefix_import"] = imported["launches"]
    rec["system_prefix"] = {
        "prefix_tokens": int(len(prefix)), "new_tokens": PREFIX_NEW,
        "prompt_tokens": [int(len(f)) for f in full],
        "register_s": register_s, "blob_bytes": blob["nbytes"],
        "kv_imports": kv_imports,
        "blob_leaves": len(blob["leaves"]), "codec_s": codec_s,
        "import_s": import_s,
        "with_prefix": summary(with_prefix),
        "without_prefix": summary(without),
        "imported": summary(imported),
        "tokens_equal_no_prefix": with_prefix["tokens"] == without[
            "tokens"],
        "first_diffs": _first_diffs(with_prefix["tokens"],
                                    without["tokens"]),
        "imported_tokens_equal": imported["tokens"] == without["tokens"]}
    if not (rec["system_prefix"]["tokens_equal_no_prefix"]
            and rec["system_prefix"]["imported_tokens_equal"]
            and with_prefix["stats"]["prefix_hits"] == slots
            and imported["stats"]["prefix_hits"] == slots
            and kv_imports == 1):
        raise AssertionError(f"system prefix: {rec['system_prefix']}")

    # (c) two adapters in one engine; the variant's solo run first
    variant = variant_tree(np, m._params, SEED + 27)
    model = m._float_model()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                node = variant
                for part in name.split("."):
                    node = node[part]
                p.copy_(torch.from_numpy(node))
    del model
    eng = m.make_decode_engine(**kw)
    solo1 = _leg(torch, np, pa, eng.engine, reqs)["tokens"]
    free(eng)
    t0 = time.perf_counter()
    eng = m.make_multi_adapter_engine([m._params, variant], **kw)
    torch.cuda.synchronize()
    multi_build_s = time.perf_counter() - t0
    mreq = [(f"greedy{i}", prompts[i], max_new, {"adapter_id": i % 2})
            for i in range(slots)]
    leg = _leg(torch, np, pa, eng.engine, mreq)
    paths["llama_modes_multi_adapter"] = leg["launches"]
    want = {rid: (greedy if i % 2 == 0 else solo1)[rid]
            for i, (rid, *_r) in enumerate(mreq)}
    rec["multi_adapter"] = summary(
        leg, n_adapters=2, build_s=multi_build_s,
        tokens_equal_solo=leg["tokens"] == want,
        first_diffs=_first_diffs(leg["tokens"], want),
        adapters_differ=sum(greedy[r] != solo1[r] for r in greedy))
    free(eng, variant)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    if leg["tokens"] != want:
        raise AssertionError(f"multi-adapter tokens differ from the solo "
                             f"engines': {rec['multi_adapter']}")
    for name, counts in paths.items():
        if min(counts.values()) <= 0:
            raise AssertionError(f"a paged kernel never launched on {name}:"
                                 f" {counts}")
    return paths


#: phase 29's tier leg: requests (6: 16 and then 8 took the call past
#: 600 s; 4 took phase 29 as long as 6, the lanes waiting on the pool),
#: their prompt lengths (evenly spaced, the longest first), new tokens
#: each
TIER_REQUESTS = 6
TIER_PROMPTS = (1984, 512)
TIER_NEW = 64
#: phase 29's disaggregated leg: requests, prompt tokens, and how long the
#: decode worker waits for a shipment before re-prefilling
DISAGG_REQUESTS = 4  # 8 took the call past 600 s
DISAGG_PROMPT = 1024
DISAGG_WAIT_S = 120.0


def _long_prompts(np, tok, texts, lengths, max_len):
    """BOS-led prompts of the given token lengths: the corpus texts' ids,
    cycled, each prompt from its own offset."""
    bos = _prompt_ids(np, tok, texts[0], max_len)[:1]
    ids = np.concatenate([tok.encode_ids(t) for t in texts]).astype(np.int32)
    return [np.concatenate([bos, np.resize(
        np.roll(ids, -997 * i), int(n) - 1)]).astype(np.int32)
        for i, n in enumerate(lengths)]


def tier_leg(torch, np, pa, make, prompts, max_len, page, new):
    """Phase 29 (a): ``prompts`` (``new`` tokens each, greedy) through an
    untiered core engine with the full pool, then through one whose pool
    holds half the pages the requests reserve, ``host_kv_pages`` the rest;
    ``make(kv_pages, host_kv_pages)`` builds each (kv_pages 0: the full
    pool). The tiered run also holds every page the tier brings back
    against the page it took out, bit for bit, in the same run: the
    gathered pages are cloned on the step's stream as they are handed
    to the tier, and the pool's pages are compared with the clones just
    after their install (device-side counts, read once at the end).
    Returns the record, the tiered run's launches and whether the tier
    engaged (parks, evictions, unparks), every page came back unchanged
    and B1/B2 launched."""
    import gc

    from rafiki_tpu_torch.serving.kv_transfer import cache_leaves

    def witness(core):
        """Wrap ``core``'s eviction hand-off and install so that each
        restored page is compared with its evicted bytes; returns the
        (pages checked, device mismatch counts) it fills."""
        saved, checked, bad = {}, [0], []
        real_evict = core.tier.evict_submit
        real_apply = core._apply_unpark_installs

        def evict_submit(host_ids, leaves, ready=None):
            kept = [a.clone() for a in leaves]
            for j, h in enumerate(host_ids):
                saved[int(h)] = (kept, j)
            return real_evict(host_ids, leaves, ready)

        def apply(installs):
            real_apply(installs)
            for _lane, _rec, pool_ids, host_ids, _staged in installs:
                idx = torch.tensor(pool_ids, device=core.device)
                was = [saved.pop(int(h)) for h in host_ids]
                for li, c in enumerate(cache_leaves(core._cache)):
                    want = torch.stack([kept[li][j] for kept, j in was])
                    got = c.index_select(0, idx)
                    bad.append((got.view(torch.uint8)
                                != want.view(torch.uint8)).sum())
                checked[0] += len(host_ids)

        core.tier.evict_submit = evict_submit
        core._apply_unpark_installs = apply
        return checked, bad

    reserve = [(min(len(p) - 1 + new, max_len) - 1) // page + 1
               for p in prompts]
    pool = sum(reserve) // 2
    host = sum(reserve) - pool
    reqs = [(f"t{i}", p, new, {}) for i, p in enumerate(prompts)]
    eng = make(0, 0)
    full = _leg(torch, np, pa, eng, reqs)
    full_pages = eng.n_pages - 1
    page_bytes = sum(c[0].numel() * c[0].element_size()
                     for c in cache_leaves(eng._cache))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    core = make(pool + 1, host)
    spans = []
    core.span_sink = lambda ev, rid, attrs: spans.append(ev)
    checked, bad = witness(core)
    try:
        tiered = _leg(torch, np, pa, core, reqs)
        tier = core.tier
        moved, secs = dict(tier.copy_bytes), dict(tier.copy_s)
        wait_s = tier.wait_s
        mismatched = int(torch.stack(bad).sum()) if bad else 0
    finally:
        core.span_sink = None
        core.close()
    del core
    gc.collect()
    torch.cuda.empty_cache()
    st = tiered["stats"]
    rec = {
        "requests": len(prompts), "new_tokens": new,
        "prompt_tokens": [int(len(p)) for p in prompts],
        "reserved_pages": int(sum(reserve)), "pool_pages": pool,
        "host_pages": host, "untiered_pool_pages": full_pages,
        "page_bytes": page_bytes,
        "tokens_equal_untiered": tiered["tokens"] == full["tokens"],
        "first_diffs": _first_diffs(tiered["tokens"], full["tokens"]),
        "pages_restored_checked": checked[0],
        "restored_bytes_differing": mismatched,
        "parked_spans": spans.count("parked"),
        "unparked_spans": spans.count("unparked"),
        **{k: st[k] for k in (
            "kv_evictions_total", "kv_unparks_total", "kv_prefetch_hits",
            "kv_prefetch_misses", "kv_transfer_bytes_total",
            "max_concurrent", "admission_stalls", "kv_pages_high_water")},
        "gb_moved": {d: moved[d] / 1e9 for d in moved},
        "copy_gb_per_s": {d: moved[d] / secs[d] / 1e9 if secs[d] else None
                          for d in moved},
        "copy_device_s": secs,
        "step_thread_tier_wait_s": wait_s,
        "tiered": {k: tiered[k] for k in ("wall_s", "decode_tok_per_s",
                                          "mean_ttft_s", "launches")},
        "untiered": {k: full[k] for k in ("wall_s", "decode_tok_per_s",
                                          "mean_ttft_s", "launches")}}
    ok = (rec["parked_spans"] > 0 and st["kv_evictions_total"] > 0
          and st["kv_unparks_total"] > 0 and checked[0] > 0
          and mismatched == 0 and min(tiered["launches"].values()) > 0)
    return rec, tiered["launches"], ok


def disagg_leg(torch, np, ll, pa, m, tok, texts, slots, page, new, dev):
    """Phase 29 (b): a ``prefill`` and a ``decode`` ``InferenceWorker``
    (``kv_wait_s`` ``DISAGG_WAIT_S``) on the same card over the in-process
    hub; ``DISAGG_REQUESTS`` texts of ``DISAGG_PROMPT`` tokens streamed at
    once through the port's ``Predictor``: first with the decode worker
    alone in the Predictor's pool (no prefill worker to place a leg on, so
    it prefills and decodes them itself: the unified reference), then
    with both. Returns the record, the second run's launches and whether
    it passed its gates."""
    import gc
    import threading

    from rafiki_tpu_torch.serving.predictor import Predictor
    from rafiki_tpu_torch.serving.queues import InProcQueueHub
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    max_len = int(m.knobs["max_len"])
    ids = _long_prompts(np, tok, texts[1:], [DISAGG_PROMPT]
                        * DISAGG_REQUESTS, max_len)
    queries = [tok.decode(int(t) for t in p[1:]) for p in ids]

    def frozen(node):
        """Read-only views of the tree's arrays: the template keeps such
        leaves as they are (as it keeps a param-store blob's)."""
        if isinstance(node, dict):
            return {k: frozen(v) for k, v in node.items()}
        if isinstance(node, np.ndarray):
            view = node.view()
            view.flags.writeable = False
            return view
        return node

    dump = frozen(m.dump_parameters())

    class Store:
        """The param store's ``load``, over the fine-tune's tree in memory
        (the codec's cost is phase 18's to measure)."""

        def load(self, trial_id):
            return dump

    def boot(wid, **kw):
        t0 = time.perf_counter()
        w = InferenceWorker(ll.LlamaLoRA, "slice", m.knobs, Store(), hub,
                            wid, decode_loop=True, max_slots=slots,
                            max_new_tokens=new, steps_per_sync=4,
                            kv_page_size=page, device=dev, **kw)
        torch.cuda.synchronize()
        return w, time.perf_counter() - t0

    def stream(pool):
        pred = Predictor(hub, pool, gather_timeout=600.0)
        pred._refresh_load_signals()
        placed = pred.router.select_prefill()
        out = {}

        def client(i):
            t0 = time.perf_counter()
            first, acc, final = None, "", None
            for ev in pred.predict_stream([queries[i]], timeout=600.0):
                if ev.get("delta"):
                    first = first or time.perf_counter()
                    acc += ev["delta"]["0"]
                elif ev.get("done"):
                    final = ev
            out[i] = {"ttft_s": (first or time.perf_counter()) - t0,
                      "text": (final.get("predictions") or [None])[0],
                      "error": final.get("error"),
                      "deltas_join": bool(final.get("predictions")) and
                      final["predictions"][0].startswith(acc)}

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out, time.perf_counter() - t0, placed

    hub = InProcQueueHub()
    dec, dec_boot = boot("w-dec", role="decode", kv_wait_s=DISAGG_WAIT_S)
    pre, pre_boot = boot("w-pre", role="prefill")
    shipped, installed = {}, {}
    real_poll, real_install = pre.engine.poll_kv, dec.engine.engine._install_kv

    def poll_kv():
        done = real_poll()
        now = time.perf_counter()
        for rid, _blob in done:
            shipped[rid] = now
        return done

    def install_kv(i, blob):
        installed[dec.engine.engine._slots[i].request_id] = (
            time.perf_counter(), int(blob["nbytes"]))
        return real_install(i, blob)

    pre.engine.poll_kv = poll_kv
    dec.engine.engine._install_kv = install_kv
    loops = [threading.Thread(target=w.run, kwargs={"poll_timeout": 0.01})
             for w in (dec, pre)]
    for t in loops:
        t.start()
    try:
        while not (hub.get_worker_stats("w-dec")
                   and hub.get_worker_stats("w-pre")):
            time.sleep(0.01)
        unified, uni_wall, _ = stream(["w-dec"])
        _zero_paged(pa)
        split, split_wall, placed = stream(["w-dec", "w-pre"])
        torch.cuda.synchronize()
        launches = _paged_counts(pa)
    finally:
        for w in (dec, pre):
            w.stop()
        for t in loops:
            t.join()
    stats = {"decode": dec.stats.snapshot(), "prefill": pre.stats.snapshot()}
    for w in (dec, pre):
        w.engine.close()
    del dec, pre
    gc.collect()
    torch.cuda.empty_cache()
    latency = [installed[rid][0] - shipped[rid] for rid in installed
               if rid in shipped]
    equal = all(split[i]["text"] == unified[i]["text"] is not None
                for i in unified)
    rec = {
        "requests": len(queries), "new_tokens": new,
        "prompt_tokens": [int(len(tok.encode_ids(q))) + 1
                          for q in queries],
        "kv_wait_s": DISAGG_WAIT_S, "prefill_placed_on": placed,
        "texts_equal_unified": equal,
        "first_differing": {i: _first_diff(split[i]["text"] or "",
                                           unified[i]["text"] or "")
                            for i in unified
                            if split[i]["text"] != unified[i]["text"]},
        "deltas_join": all(r["deltas_join"] for r in split.values()),
        "errors": {i: r["error"] for i, r in split.items() if r["error"]},
        "kv_ships_sent": stats["prefill"]["kv_ships_sent"],
        "kv_imports_installed": stats["decode"]["kv_imports_installed"],
        "kv_wait_timeouts": stats["decode"]["kv_wait_timeouts"],
        "kv_import_fallbacks": stats["decode"]["kv_import_fallbacks"],
        "blob_bytes": sorted({n for _t, n in installed.values()}),
        "ship_to_install_s": sorted(latency),
        "ttft_s": {"disaggregated": sorted(r["ttft_s"]
                                           for r in split.values()),
                   "unified": sorted(r["ttft_s"]
                                     for r in unified.values())},
        "wall_s": {"disaggregated": split_wall, "unified": uni_wall},
        "boot_s": {"decode": dec_boot, "prefill": pre_boot},
        "launches": launches}
    n = len(queries)
    ok = (equal and rec["deltas_join"] and not rec["errors"]
          and placed == "w-pre"
          and rec["kv_ships_sent"] == rec["kv_imports_installed"] == n
          and rec["kv_import_fallbacks"] == 0
          and min(launches.values()) > 0)
    return rec, launches, ok


def tier_disagg_phase(torch, np, ll, de, pa, m, tok, texts, depth, dev):
    """Phase 29: the host KV tier and disaggregated prefill/decode on phase
    24's fine-tuned model (bf16, paged, page 16, 8 slots, max_len 2048):

    (a) ``TIER_REQUESTS`` greedy requests of ``TIER_PROMPTS`` prompt
        tokens, ``TIER_NEW`` new each, through ``make_decode_engine`` with
        a pool of half the pages they reserve plus ``host_kv_pages`` for
        the rest, beside an untiered engine with the full pool: parks,
        evictions and unparks > 0, every restored page bit-equal to the
        page evicted (:func:`tier_leg`'s witness), B1/B2 launched (path
        ``kv_tier``: the tiered runs' launches only).
        Reports the evictions, prefetch hits and misses, the GB moved
        each way and the rate of the side-stream copies (their device
        time), the step thread's wait on the tier, and decode tokens/s
        and TTFT beside the untiered engine's. In bf16 the tokens of two
        schedules may part (a chunk's width and the kernels' split plans
        follow the batch, and bf16 rounds their sums apart), so the
        equality is reported there and gated on an f32 twin of the model
        (its weights upcast on the card, core engines over it, the same
        traffic): tokens equal to its untiered engine's. The page witness
        is gated in both, so a fault in the tier's bf16 copies cannot
        hide behind the schedule's rounding;
    (b) :func:`disagg_leg`: texts equal to the unified run's, every
        shipment installed, none fallen back, B1/B2 launched (path
        ``disagg``); blob bytes, ship -> install latency, TTFT beside the
        unified run's."""
    import gc

    t_phase = time.perf_counter()
    slots, page, max_len = 8, 16, int(m.knobs["max_len"])
    lengths = np.linspace(TIER_PROMPTS[0], TIER_PROMPTS[1],
                          TIER_REQUESTS).astype(int)
    prompts = _long_prompts(np, tok, texts, lengths, max_len)
    kw = dict(max_slots=slots, steps_per_sync=4, kv_page_size=page)

    def bf16(kv_pages, host):
        return m.make_decode_engine(max_new_tokens=TIER_NEW,
                                    kv_pages=kv_pages, host_kv_pages=host,
                                    **kw).engine

    tier, tier_launches, tier_ok = tier_leg(
        torch, np, pa, bf16, prompts, max_len, page, TIER_NEW)
    # the f32 twin: the fine-tune's weights upcast on the card
    twin = ll.LlamaLoRA(device=dev, **dict(m.knobs, bf16=False))._module()
    twin.load_state_dict(m._float_model().state_dict())

    def f32(kv_pages, host):
        return de.DecodeEngine(
            twin.with_kv_layout(page, kv_pages
                                or 1 + max_len // page * slots),
            max_slots=slots, max_len=max_len, steps_per_sync=4,
            host_kv_pages=host, device=dev)

    exact, f32_launches, f32_ok = tier_leg(
        torch, np, pa, f32, prompts, max_len, page, TIER_NEW)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    tier_ok = tier_ok and f32_ok and exact["tokens_equal_untiered"]
    tier_launches = {k: tier_launches[k] + f32_launches[k]
                     for k in tier_launches}
    tier = {"bf16": tier, "f32": exact}
    t_tier = time.perf_counter() - t_phase
    disagg, disagg_launches, disagg_ok = disagg_leg(
        torch, np, ll, pa, m, tok, texts, slots, page, TIER_NEW, dev)
    rec = {"phase": "kv_tier_disagg", "depth": depth, "tier": tier,
           "disagg": disagg, "tier_s": t_tier,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not tier_ok:
        raise AssertionError(f"host KV tier leg failed: {tier}")
    if not disagg_ok:
        raise AssertionError(f"disaggregated leg failed: {disagg}")
    return {"kv_tier": tier_launches, "disagg": disagg_launches}


def slice_exactness_phase(torch, np, ll, de, pa, ps, bpe, dev):
    """Phase 25: phase 15's head-dim-8 Llama (hidden 32, 4 heads, 2 kv
    heads, max_len 32, f32, random weights from a seed, nonzero
    adapters) as ``LlamaLoRA`` knobs with a byte-BPE tokenizer (512 ids),
    served paged at page 8 on the card and on the CPU: seeded sampling,
    a preemption (one slot, a background request evicted by an
    interactive one, greedy and sampled), a stream resume, and phase
    26's decode modes (prompt-lookup speculation, the target as its own
    draft, a prefix registered and one exported and imported, two
    adapters in one engine) must give identical tokens, texts and
    counters; the self-drafted windows must be accepted (at least 90 %
    of the drafts); B1 and B2 must launch."""
    work = ROOT / "build" / "chip_smoke" / "slice_hd8"
    work.mkdir(parents=True, exist_ok=True)
    texts = _texts(write_corpus(np, work / "corpus.jsonl", 64, SEED + 27))
    tok = bpe.ByteBPETokenizer.train(texts, 512)
    tok_path = str(work / "bpe.json")
    tok.save(tok_path)
    knobs = {"hidden_dim": 32, "depth": 2, "n_heads": 4, "kv_ratio": 2,
             "lora_rank": 4, "max_len": 32, "bf16": False,
             "tokenizer_path": tok_path}
    cpu = torch.device("cpu")
    host = ll.LlamaLoRA(device=cpu, **knobs)
    gen = torch.Generator().manual_seed(SEED)
    net = host._module()
    randomize_lora_b(net, gen)
    blob = {"params": _nest({k: t.detach().numpy().copy()
                             for k, t in net.state_dict().items()}),
            "meta": {"id2tok": {}, "bpe_merges": [list(m) for m in
                                                  tok.merges]}}
    prompts = [_prompt_ids(np, tok, t, 16) for t in texts[:8]]

    def serve(device):
        m = ll.LlamaLoRA(device=device, **knobs)
        m.load_parameters(blob)
        out = {}
        eng = m.make_decode_engine(max_slots=4, max_new_tokens=10,
                                   steps_per_sync=2, kv_page_size=8)
        core = eng.engine
        done, _s, _t = _run_engine(core, [
            (f"s{i}", prompts[i], 10, dict(SAMPLING, seed=i))
            for i in range(4)] + [(f"g{i}", prompts[4 + i], 10, {})
                                  for i in range(4)])
        out["sampled"] = done
        for mode in ("greedy", "sampled"):
            kw = dict(SAMPLING, seed=3) if mode == "sampled" else {}
            one = de.DecodeEngine(core.module, max_slots=1, max_len=32,
                                  steps_per_sync=2, device=device)
            one.submit("bg", prompts[0], 12, slo="background", **kw)
            one.step()
            one.step()
            one.submit("ia", prompts[1], 6, slo="interactive", **kw)
            done = {}
            while len(done) < 2:
                one.step()
                done.update({r: [int(t) for t in ids]
                             for r, ids in one.poll()})
            out[f"preempt_{mode}"] = (done, one.stats["preemptions"])
        whole = {}
        eng.submit("w", texts[9], max_new=10)
        while not whole:
            eng.step()
            whole.update(dict(eng.poll()))
        prefix = whole["w"][:len(whole["w"]) // 2]
        eng.submit("r", texts[9], max_new=10, forced_prefix=prefix)
        res = {}
        while not res:
            eng.step()
            res.update(dict(eng.poll()))
        out["resume"] = (whole["w"], prefix, res["r"])
        out.update(modes(m, device))
        out.update(tier_modes(m, device))
        return out

    spec_keys = ("spec_calls", "spec_drafted", "spec_accepted",
                 "spec_draft_model_calls", "draft_resyncs", "prefix_hits",
                 "prefix_tokens", "kv_imports")

    def modes(m, device):
        """Phase 26's four modes at this size: prompt lookup, the target
        itself as its draft (every verify row live and accepted), two
        adapters in one engine, a registered prefix exported and
        imported."""
        # 12 new tokens: three whole windows of SPEC_K, so a self-drafted
        # window is never cut at a request's stop
        greedy = [(f"k{i}", prompts[i], 12, {}) for i in range(4)]
        kw = dict(max_slots=4, max_new_tokens=12, steps_per_sync=2,
                  kv_page_size=8)
        out = {}

        def run(eng, submits):
            done = _run_engine(eng.engine, submits)[0]
            st = eng.engine.stats_snapshot()
            return done, {k: st[k] for k in spec_keys}

        out["prompt_lookup"] = run(
            m.make_decode_engine(speculate_k=SPEC_K, **kw), greedy)
        twin = ll.LlamaLoRA(device=device, **knobs)
        twin.load_parameters(blob)
        out["self_draft"] = run(m.make_decode_engine(
            speculate_k=SPEC_K, draft_model=twin, **kw), greedy)
        pre = prompts[0][:6]
        preq = [(f"p{i}", np.concatenate([pre, prompts[1 + i][1:]])[:20],
                 8, {}) for i in range(4)]
        eng = m.make_decode_engine(**kw)
        eng.engine.register_prefix(pre)
        out["prefix"] = run(eng, preq)
        wire = ps.params_from_bytes(ps.params_to_bytes(
            eng.engine.export_prefix()))
        eng = m.make_decode_engine(**kw)
        eng.engine.import_prefix(wire)
        out["prefix_imported"] = run(eng, preq)
        eng = m.make_multi_adapter_engine(
            [blob["params"], variant_tree(np, blob["params"], SEED + 28)],
            **kw)
        out["multi_adapter"] = run(eng, [
            (f"a{i}", prompts[i], 10, {"adapter_id": i % 2})
            for i in range(4)])
        return out

    bf16_tokens = []  # the CPU's, then the card's

    def tier_modes(m, device):
        """Phase 29 at this size: the host tier (a pool of 6 pages of 8,
        24 host pages) in f32, with an int8 KV pool (f32 queries) and in
        bf16, each beside the same engine untiered; and one KV shipment
        (f32) from a prefill-only engine through the param-store codec
        into a decode engine. Tokens, tier counters and whether each
        tiered (or shipped) run equals the untiered one; the bf16 tokens
        are kept aside (``bf16_tokens``)."""
        reqs = [(f"h{i}", prompts[i], 10, {}) for i in range(8)]
        kw = dict(max_slots=4, max_new_tokens=10, steps_per_sync=2,
                  kv_page_size=8)
        keys = ("kv_evictions_total", "kv_unparks_total",
                "kv_parked_slots", "kv_host_pages_used", "max_concurrent")
        out = {}
        for name, extra in (("f32", {}), ("int8_kv", {"kv_cache_int8":
                                                      True}),
                            ("bf16", {"bf16": True})):
            lm = m
            if extra:
                lm = ll.LlamaLoRA(device=device, **dict(knobs, **extra))
                lm.load_parameters(blob)
            want = _run_engine(lm.make_decode_engine(**kw).engine, reqs)[0]
            eng = lm.make_decode_engine(kv_pages=6, host_kv_pages=24, **kw)
            try:
                got = _run_engine(eng.engine, reqs)[0]
                st = eng.engine.stats_snapshot()
            finally:
                eng.close()
            counters = {k: st[k] for k in keys}
            if name == "bf16":
                bf16_tokens.append(got)
                out["tier_bf16"] = (got == want, counters)
            else:
                out[f"tier_{name}"] = (got, got == want, counters)
        pre = m.make_decode_engine(**kw).engine
        for rid, ids, max_new, _kw in reqs:
            pre.submit(rid, ids, max_new, prefill_only=True)
        blobs = {}
        while len(blobs) < len(reqs):
            pre.step()
            blobs.update(dict(pre.poll_kv()))
        wire = {rid: ps.params_from_bytes(ps.params_to_bytes(b))
                for rid, b in blobs.items()}
        dec = m.make_decode_engine(**kw).engine
        got = _run_engine(dec, [(rid, ids, max_new, {"kv_import": wire[rid]})
                                for rid, ids, max_new, _kw in reqs])[0]
        out["ship"] = (got, got == out["tier_f32"][0],
                       dec.stats_snapshot()["kv_imports"],
                       sorted(b["nbytes"] for b in blobs.values()))
        return out

    want = serve(cpu)
    torch.cuda.synchronize()
    _zero_paged(pa)
    got = serve(dev)
    torch.cuda.synchronize()
    launches = _paged_counts(pa)
    same = {k: got[k] == want[k] for k in want}
    rec = {"phase": "slice_hd8_exactness", "knobs": knobs,
           "bpe_vocab": tok.vocab_size, "identical": same,
           "preemptions": {k: got[k][1] for k in got
                           if k.startswith("preempt")},
           "mode_counters": {k: got[k][1] for k in (
               "prompt_lookup", "self_draft", "prefix", "prefix_imported",
               "multi_adapter")},
           "resume_starts_with_prefix": got["resume"][2].startswith(
               got["resume"][1]),
           "tier": {k: got[k][-1] for k in ("tier_f32", "tier_int8_kv",
                                            "tier_bf16")},
           "tier_equals_untiered": {k: got[k][-2] for k in (
               "tier_f32", "tier_int8_kv", "tier_bf16")},
           "tier_bf16_card_equals_cpu": bf16_tokens[1] == bf16_tokens[0],
           "shipped": {"equals_untiered": got["ship"][1],
                       "kv_imports": got["ship"][2],
                       "blob_bytes": got["ship"][3]},
           "launches": launches}
    emit(rec)
    if not all(same.values()):
        raise AssertionError(f"card and CPU differ: {same}")
    if not (all(rec["tier_equals_untiered"].values())
            and got["ship"][1] and got["ship"][2] == 8
            and all(c["kv_evictions_total"] > 0 and c["kv_unparks_total"]
                    > 0 for c in rec["tier"].values())):
        raise AssertionError(f"head-dim-8 tier / shipment: "
                             f"{rec['tier_equals_untiered']}, "
                             f"{rec['tier']}, {rec['shipped']}")
    drafted = got["self_draft"][1]
    if not (drafted["spec_draft_model_calls"] > 0 and drafted[
            "spec_accepted"] >= 0.9 * drafted["spec_drafted"] > 0
            and got["prefix"][1]["prefix_hits"] == 4
            and got["prefix_imported"][1]["kv_imports"] == 1):
        raise AssertionError(f"decode modes: {rec['mode_counters']}")
    if min(v for k, v in rec["preemptions"].items()) < 1:
        raise AssertionError(f"no preemption: {rec['preemptions']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a paged kernel never launched: {launches}")
    return launches


# ---- BASELINE #1 and #2 (phases 27-28): the CNN templates, the streaming
# loader, the feed-forward template and the port's CLI

#: the CNN template of each family module
CNN_TEMPLATES = {"resnet": "ResNetClassifier", "vgg": "VGGClassifier",
                 "densenet": "DenseNetClassifier"}
#: the main paths of phases 27-28, which launch no port kernel
CNN_PATHS = ("resnet50_training", "cnn_tuning")
#: phase 27's ResNet-50: BASELINE #2's widths (never cut), bf16 compute,
#: one epoch of ``RESNET_STEPS`` steps through ``budget_scale`` 0.2
RESNET_KNOBS = {"variant": "resnet50", "width_mult": 1.0,
                "batch_size": 256, "bf16": True, "max_epochs": 5,
                "learning_rate": 0.1, "weight_decay": 1e-4,
                "quick_train": False, "share_params": False}
RESNET_IMAGE = (224, 224, 3)
RESNET_CLASSES = 1000
RESNET_STEPS = 16
#: phase 27's card-against-CPU leg: (template module, knobs, image side)
CNN_EXACT = (("resnet", {"variant": "resnet18", "width_mult": 0.25}, 64),
             ("resnet", {"variant": "resnet50", "width_mult": 0.25}, 64),
             ("vgg", {"variant": "vgg11", "width_mult": 0.25}, 32),
             ("densenet", {"variant": "densenet-s", "growth": 8}, 32))
#: the leg's SGD step: the second step's statistics are those of weights
#: moved by a gradient summed in another order on each device, so the
#: difference grows with the step (on an H100 at 0.05, vgg11's were 2.1 x
#: the bound)
CNN_EXACT_LR = 0.01
#: the bound on the first step's update, card against CPU: each leaf's
#: largest difference in ``p1 - p0`` over its largest CPU update. Readings
#: on an H100 (700 W): 1.4e-4 resnet18, 2.8e-5 resnet50, 1.3e-3 vgg11,
#: 4.5e-3 densenet-s; a step without Nesterov's look-ahead is 0.47 off
CNN_EXACT_UPDATE_TOL = 2e-2
#: phase 28's jobs: BOHB over ResNetClassifier with the variant pinned,
#: on a 32 x 32 x 3 npz; the feed-forward job through the CLI on
#: FashionMNIST-layout PNG zips
CNN_TUNE_PINS = {"variant": "resnet50"}
CNN_TUNE_TRIALS = 4
CNN_TUNE_IMAGES = (1024, 256)
FASHION_IMAGES = (2048, 512)
FF_TRIALS = 4
#: phase 28 (c): one epoch of each of the other CNN families
CNN_RECIPE = {"max_epochs": 5, "learning_rate": 0.05, "weight_decay": 1e-4,
              "bf16": True, "quick_train": False, "share_params": False}
CNN_EPOCH_KNOBS = {
    "vgg": {"variant": "vgg11", "width_mult": 1.0, "batch_size": 128},
    "densenet": {"variant": "densenet-s", "growth": 12, "batch_size": 128}}


def write_stream_zip(np, path, n, n_classes, seed):
    """The streamable layout at ImageNet's shape: ``n`` seeded uint8
    224 x 224 x 3 ``.npy`` members and a ``labels.csv`` whose labels cover
    every one of ``n_classes`` classes (``n >= n_classes``)."""
    import io
    import zipfile

    rng = np.random.default_rng(seed)
    labels = rng.permutation(np.arange(n) % n_classes)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        rows = ["path,label"]
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 256, RESNET_IMAGE, np.uint8),
                    allow_pickle=False)
            zf.writestr(f"img{i:06d}.npy", buf.getvalue())
            rows.append(f"img{i:06d}.npy,c{int(labels[i])}")
        zf.writestr("labels.csv", "\n".join(rows))
    return str(path)


def forward_flops(torch, layers, net, image_shape):
    """2 x the multiply-adds of one image's forward through ``net``'s
    ``Conv`` and ``Dense`` layers, from their output and kernel shapes (a
    forward hook on each during one forward of a zero image)."""
    total = [0]

    def on_conv(m, _inp, out):
        total[0] += 2 * out.numel() * m.kernel[0].numel()

    def on_dense(m, _inp, out):
        total[0] += 2 * out.numel() * m.kernel.shape[0]

    hooks = [m.register_forward_hook(
        on_conv if isinstance(m, layers.Conv) else on_dense)
        for m in net.modules() if isinstance(m, (layers.Conv, layers.Dense))]
    try:
        with torch.no_grad():
            net(torch.zeros((1, *image_shape),
                            device=next(net.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def cnn_exactness_leg(torch, np, cnn, store_params, optim, dev):
    """Phase 27's f32 leg: each ``CNN_EXACT`` network (random weights from
    a seed) on the card and on the CPU from one blob, TF32 off: eval
    logits of one seeded batch of 16 within 1e-4 relative + 1e-5, then two
    SGD-Nesterov steps (the recipe's optimizer at ``CNN_EXACT_LR``, train
    mode) on two batches: the losses within 1e-4 relative, the first
    step's update of every parameter within ``CNN_EXACT_UPDATE_TOL`` of the
    leaf's largest CPU update, and every ``batch_stats`` leaf within 1e-5
    relative + 1e-5 of its largest entry. Before the nets: the template's
    uint8 pixels, scaled on the card, equal numpy's ``astype(float32) /
    255`` bit for bit."""
    out = []
    rng = np.random.default_rng(SEED + 27)
    t = cnn["resnet"].ResNetClassifier(device=dev, **RESNET_KNOBS)
    pixels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = t._device_images(pixels).cpu().numpy()
    if not np.array_equal(got, pixels.astype(np.float32) / 255.0):
        raise AssertionError("uint8 pixels scaled on the card differ from "
                             "numpy's division by 255")
    for mod_name, knobs, side in CNN_EXACT:
        template = getattr(cnn[mod_name], CNN_TEMPLATES[mod_name])
        shape = (side, side, 3)
        full = {**RESNET_KNOBS, **knobs, "bf16": False}
        nets = {}
        for where in ("cpu", dev):
            t = template(device=where, **full)
            t._n_classes, t._image_shape = 10, list(shape)
            nets[str(where)] = t._module()
        blob = store_params.cnn_params_to_jax(nets["cpu"].state_dict())
        nets[str(dev)].load_state_dict(store_params.cnn_params_from_jax(blob))
        xs = [rng.uniform(0, 1, (16, *shape)).astype(np.float32)
              for _ in range(3)]
        ys = [rng.integers(0, 10, 16) for _ in range(2)]
        res = {}
        for where, net in nets.items():
            net.eval()
            with torch.no_grad():
                logits = net(torch.from_numpy(xs[0]).to(where)).cpu().numpy()
            net.train()
            opt, sched = optim.sgd_nesterov(net.named_parameters(),
                                            CNN_EXACT_LR, 2, 1e-4)
            p0 = {k: v.detach().cpu().numpy().copy()
                  for k, v in net.named_parameters()}
            losses = []
            for x, y in zip(xs[1:], ys):
                opt.zero_grad(set_to_none=True)
                loss = torch.nn.functional.cross_entropy(
                    net(torch.from_numpy(x).to(where)),
                    torch.from_numpy(y).to(where))
                loss.backward()
                opt.step()
                sched.step()
                losses.append(loss.item())
                if len(losses) == 1:
                    update = {k: v.detach().cpu().numpy() - p0[k]
                              for k, v in net.named_parameters()}
            stats = _flat_tree(store_params.cnn_params_to_jax(
                net.state_dict())["batch_stats"])
            res[where] = (logits, losses, stats, update)
        (lc, sc, stc, uc), (lg, sg, stg, ug) = res["cpu"], res[str(dev)]
        # a leaf that stays put on the CPU (behind a zero-initialised BN
        # scale, exempt from decay) must stay put on the card too
        update_err = max(float(np.abs(ug[k] - uc[k]).max()
                               / max(float(np.abs(uc[k]).max()), 1e-30))
                         for k in uc)
        logit_err = float(np.max(np.abs(lg - lc) / (1e-5 + 1e-4 * np.abs(lc))))
        stat_err = max(float(np.max(np.abs(stg[k] - stc[k]) / (
            1e-5 * np.abs(stc[k]).max() + 1e-5 * np.abs(stc[k]))))
            for k in stc)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(sg, sc))
        out.append({"net": f"{template.__name__}:{knobs}", "image": side,
                    "logits_err_over_tol": logit_err,
                    "logits_max_abs_diff": float(np.abs(lg - lc).max()),
                    "losses_cpu": sc, "losses_card": sg,
                    "loss_rel_err": loss_err,
                    "step1_update_rel_err": update_err,
                    "batch_stats_err_over_tol": stat_err})
        if not (logit_err <= 1 and stat_err <= 1 and loss_err <= 1e-4
                and update_err <= CNN_EXACT_UPDATE_TOL):
            raise AssertionError(f"card vs CPU: {out[-1]}")
        del nets
    return out


def resnet_phase(torch, np, cnn, layers, stream, store_params, optim, lp,
                 TrainContext, fa, pe, pa, dev):
    """Phase 27, BASELINE #2 at ImageNet widths: ``ResNetClassifier``
    (resnet50, width 64, bf16, batch 256, the 7 x 7 / 2 stem and SAME
    max-pool, 1000 classes) trains one epoch (``budget_scale`` 0.2 of 5)
    of ``RESNET_STEPS`` steps from a seeded ``.npy`` zip of 224 x 224 x 3
    images over every class, large enough to stream by the template's
    own rule (``should_stream``, no force switch). Each step is timed
    (synchronized), as is the wait on the loader; one step runs under
    ``torch.profiler`` (the card's busy share); peak device memory; the
    FLOPs of a step counted from the module's conv and dense shapes
    (forward + 2 x for the backward) over its time and 989 TFLOP/s. Every
    loss must be finite and every ``batch_stats`` leaf moved. Then
    ``evaluate`` on 512 seeded images, ``predict`` of 256 and of 1 (p50
    of 20), and the f32 card-against-CPU leg (``cnn_exactness_leg``). No
    port kernel lies on this path: every launch count, zeroed before
    ``train`` and read after the last ``predict``, must stay 0."""
    import os

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "resnet"
    n = RESNET_STEPS * RESNET_KNOBS["batch_size"]
    t0 = time.perf_counter()
    path = write_stream_zip(np, work / "imagenet_shape.zip", n,
                            RESNET_CLASSES, SEED + 27)
    data_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 2 ** 20
    if os.environ.get("RAFIKI_FORCE_STREAMING") == "1" or \
            not stream.should_stream(path):
        raise AssertionError(f"{size_mb:.0f} MiB does not stream by the "
                             f"{stream.STREAM_THRESHOLD_MB} MiB rule")
    m = cnn["resnet"].ResNetClassifier(device=dev, **RESNET_KNOBS)
    ctx = TrainContext(budget_scale=0.2)
    _zero_paged(pa)
    r = _train_timed(torch, m, path, ctx, lp, fa, pe,
                     profile_step=RESNET_STEPS - 2)
    steady = r["step_s"][1:-2]  # not the first, not the profiled one
    step_s = float(np.median(steady))
    batch = RESNET_KNOBS["batch_size"]
    net = m._serving_net()
    flops = 3 * batch * forward_flops(torch, layers, net, RESNET_IMAGE)
    dump = m.dump_parameters()
    stats = _flat_tree(dump["batch_stats"])
    unmoved = [k for k, v in stats.items()
               if np.array_equal(v, np.zeros_like(v) if k.endswith("mean")
                                 else np.ones_like(v))]
    # evaluate and predict, on images of the same distribution
    rng = np.random.default_rng(SEED + 270)
    val_labels = np.arange(512) % RESNET_CLASSES
    val_images = rng.integers(0, 256, (512, *RESNET_IMAGE), np.uint8)
    val = work / "val.npz"
    np.savez(val, images=val_images, labels=val_labels,
             n_classes=np.asarray(RESNET_CLASSES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = m.evaluate(str(val))
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probs = np.asarray(m.predict(list(val_images[:256])))
    predict_s = time.perf_counter() - t0
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        m.predict([val_images[i]])
        lat.append(time.perf_counter() - t0)
    # zeroed just before train: these cover train, evaluate and predict
    launches = {**all_launches(fa, pe), **_paged_counts(pa)}
    del m, net
    torch.cuda.empty_cache()
    rec = {"phase": "resnet50_training", "model": "ResNet-50",
           "knobs": RESNET_KNOBS, "image": list(RESNET_IMAGE),
           "classes": RESNET_CLASSES, "archive_mib": size_mb,
           "archive_write_s": data_s, "streamed": True,
           "steps": len(r["losses"]), "losses": r["losses"],
           "epoch_loss": ctx.logger.get_values("loss"),
           "step_s": r["step_s"], "median_step_s": step_s,
           "images_per_s": batch / step_s,
           "loader_wait_s": r["loader_wait_s"],
           "median_loader_wait_s": float(np.median(
               r["loader_wait_s"][1:])),
           "wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
           "profiled_step": r["profiled_step"],
           "device_busy_share_of_steady_step": (
               None if _idle(r, steady) is None else 1 - _idle(r, steady)),
           "step_flops": flops, "mfu": flops / step_s / PEAK_FLOPS[
               "bfloat16"],
           "batch_stats_leaves": len(stats), "batch_stats_unmoved": unmoved,
           "evaluate": {"images": 512, "score": score, "wall_s": eval_s,
                        "images_per_s": 512 / eval_s},
           "predict_256": {"wall_s": predict_s,
                           "images_per_s": 256 / predict_s},
           "predict_1_image_p50_s": float(np.median(lat)),
           "launches": launches}
    emit(rec)
    if len(r["losses"]) != RESNET_STEPS or \
            not all(math.isfinite(x) for x in r["losses"]):
        raise AssertionError(f"ResNet-50 losses: {r['losses']}")
    if unmoved:
        raise AssertionError(f"batch_stats did not move: {unmoved[:4]}")
    if probs.shape != (256, RESNET_CLASSES) or \
            not np.isfinite(probs).all() or \
            np.abs(probs.sum(-1) - 1).max() > 1e-3:
        raise AssertionError(f"bad probabilities: {probs.shape}")
    if any(launches.values()):
        raise AssertionError(f"a port kernel ran on the CNN path: "
                             f"{launches}")
    exact = cnn_exactness_leg(torch, np, cnn, store_params, optim, dev)
    emit({"phase": "cnn_card_vs_cpu_f32", "nets": exact,
          "seconds_phase_27": time.perf_counter() - t_phase})
    return {"resnet50_training": launches}


def _fashion_cli(np, dataset, work, dev):
    """Phase 28 (b): ``python -m rafiki_tpu_torch.cli tune JaxFeedForward
    train.zip val.zip --trials FF_TRIALS --device cuda`` as a subprocess
    on the card (``dev``), over FashionMNIST-layout zips from the port's
    generator."""
    import os

    n_train, n_val = FASHION_IMAGES
    train, val = str(work / "fashion_train.zip"), str(work / "fashion_val.zip")
    t0 = time.perf_counter()
    dataset.generate_fashion_archive(train, n_train, seed=SEED)
    dataset.generate_fashion_archive(val, n_val, seed=SEED + 1)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.cli", "tune",
         "JaxFeedForward", train, val, "--trials", str(FF_TRIALS),
         "--device", dev.type],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(
            Path(dataset.__file__).resolve().parents[2])), cwd=str(work))
    wall = time.perf_counter() - t0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    if r.returncode != 0 or not last.startswith("best_score="):
        raise AssertionError(f"the CLI job failed (rc {r.returncode}): "
                             f"{r.stderr[-1500:]}")
    return {"images": [n_train, n_val], "archives_write_s": data_s,
            "trials": FF_TRIALS, "wall_s": wall,
            "best_score": float(last.split()[0].split("=")[1]),
            "best_line": last[:300]}


def cnn_tuning_phase(torch, np, cnn, dataset, dev_mod, ps, queues, wi, fa,
                     pe, pa, TrainContext, dev):
    """Phase 28, the two BASELINE jobs: (a) ``tune_model`` with BOHB over
    ``ResNetClassifier`` (``CNN_TUNE_PINS``, ``CNN_TUNE_TRIALS`` trials)
    on a seeded 32 x 32 x 3 npz of 10 classes; its winner served by an
    ``InferenceWorker``: 256 images in 4 messages equal to ``predict``,
    then closed-loop 1-image clients at concurrency 1 and 16; (b) the
    feed-forward job through the port's CLI (``_fashion_cli``); (c) one
    epoch each of ``VGGClassifier`` and ``DenseNetClassifier`` on (a)'s
    data. No port kernel may launch."""
    import threading

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "cnn_tuning"
    work.mkdir(parents=True, exist_ok=True)
    n_train, n_val = CNN_TUNE_IMAGES
    train, val = str(work / "train.npz"), str(work / "val.npz")
    dataset.generate_image_classification_dataset(
        train, n_train, image_size=32, n_channels=3, n_classes=10, seed=SEED)
    vds = dataset.generate_image_classification_dataset(
        val, n_val, image_size=32, n_channels=3, n_classes=10,
        seed=SEED + 1)
    zero_all_launches(fa, pe)
    _zero_paged(pa)
    t0 = time.perf_counter()
    result = dev_mod.tune_model(
        cnn["resnet"].ResNetClassifier, train, val,
        total_trials=CNN_TUNE_TRIALS, advisor_type="bohb", seed=SEED,
        knob_overrides=CNN_TUNE_PINS, device=dev)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    trials = [{"knobs": {k: t.knobs[k] for k in ("width_mult", "batch_size",
                                                  "bf16", "learning_rate")},
               "score": t.score, "losses": t.logger.get_values("loss")}
              for t in result.trials]
    store = ps.ParamStore.from_uri("mem://")
    store.save("best", result.best_params)
    hub = queues.InProcQueueHub()
    t0 = time.perf_counter()
    worker = wi.InferenceWorker(cnn["resnet"].ResNetClassifier, "best",
                                result.best_knobs, store, hub, "r0",
                                decode_loop=False, device=dev)
    boot_s = time.perf_counter() - t0
    images = vds.images[:256]
    msgs = [{"id": f"r{i}", "queries": images[64 * i:64 * (i + 1)]}
            for i in range(len(images) // 64)]
    for msg in msgs:
        hub.push_query("r0", queues.pack_message(msg))
    batches, serve_batch = [], worker._serve_batch

    def counted(messages):
        batches.append(len(messages))
        return serve_batch(messages)

    worker._serve_batch = counted
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    t0 = time.perf_counter()
    loop.start()
    try:
        replies = [queues.unpack_message(hub.pop_prediction(msg["id"],
                                                            600.0))
                   for msg in msgs]
        wall256 = time.perf_counter() - t0
        errors = [r["error"][-800:] for r in replies if r.get("error")]
        if errors:
            raise AssertionError(f"the served ResNet winner: {errors}")
        got = np.concatenate([np.asarray(r["predictions"], np.float32)
                              for r in replies])
        lat1, _, w1, in1, _ = _closed_loop(hub, queues, worker, images, 1,
                                           40, batches)
        lat16, wall16, w16, in16, b16 = _closed_loop(hub, queues, worker,
                                                     images, 16, 16,
                                                     batches)
    finally:
        worker.stop()
        loop.join()
    want = np.asarray(worker.model.predict(list(images)), np.float32)
    served = {"boot_s": boot_s, "wall_256_s": wall256,
              "images_per_s": 256 / wall256,
              "identical_to_predict": bool(np.array_equal(got, want)),
              "accuracy": float(np.mean(np.argmax(got, -1) ==
                                        vds.labels[:len(images)])),
              "concurrency_1": {"requests": len(lat1),
                                "p50_s": float(np.percentile(lat1, 50)),
                                "p95_s": float(np.percentile(lat1, 95)),
                                "in_batch_mean_s": in1},
              "concurrency_16": {"requests": len(lat16),
                                 "requests_per_s": len(lat16) / wall16,
                                 "p50_s": float(np.percentile(lat16, 50)),
                                 "p95_s": float(np.percentile(lat16, 95)),
                                 "in_batch_mean_s": in16,
                                 "batch_msgs_max": max(b16)}}
    del worker
    torch.cuda.empty_cache()
    cli = _fashion_cli(np, dataset, work, dev)
    epochs = {}
    for name, knobs in CNN_EPOCH_KNOBS.items():
        template = getattr(cnn[name], CNN_TEMPLATES[name])
        m = template(device=dev, **CNN_RECIPE, **knobs)
        ctx = TrainContext(budget_scale=0.2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(train, ctx)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        epochs[name] = {"knobs": knobs, "train_s": train_s,
                        "images_per_s": n_train / train_s,
                        "epoch_loss": ctx.logger.get_values("loss"),
                        "score": m.evaluate(val)}
        del m
    launches = {**all_launches(fa, pe), **_paged_counts(pa)}
    emit({"phase": "cnn_tuning", "resnet_job": {
              "advisor": "bohb", "pins": CNN_TUNE_PINS,
              "images": [n_train, n_val], "job_s": job_s,
              "trials": trials, "best_score": result.best_score,
              "best_knobs": result.best_knobs, "served": served},
          "feed_forward_cli": cli, "one_epoch": epochs,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if len(result.trials) != CNN_TUNE_TRIALS:
        raise AssertionError(f"{len(result.trials)} of {CNN_TUNE_TRIALS} "
                             "ResNet trials completed")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("the served ResNet winner differs from predict")
    if set(w1) | set(w16) != {10}:
        raise AssertionError("closed-loop replies malformed")
    if not all(math.isfinite(x) for e in epochs.values()
               for x in e["epoch_loss"]):
        raise AssertionError(f"VGG/DenseNet epochs: {epochs}")
    if any(launches.values()):
        raise AssertionError(f"a port kernel ran on the CNN jobs: "
                             f"{launches}")
    return {"cnn_tuning": launches}


# ---- the gang engine (phase 31)

#: phase 31 (a): the advisor, trials and lanes (docs/tuning.md's
#: setting) over FeedForward at its documented pins
GANG_FF_PINS = {"hidden_layer_count": 2, "hidden_layer_units": 64,
                "batch_size": 64}
GANG_FF_TRIALS = 32
GANG_FF_LANES = 16
#: (a)'s score gate: masked accuracy over 512 images. The gang's bmm and
#: the sequential trial's mm round apart in f32, and Adam carries that as
#: a ±lr step wherever a gradient sits at noise level (see
#: tests/test_torch_mlp.py), so a trial can end some images apart: the
#: H100 calls of this phase saw at most one trial (23) apart, by 10
#: images. So all scores must be equal but at most GANG_FF_UNEQUAL, and
#: those within GANG_FF_TOL. The trials, promotions and culls themselves
#: must be equal
GANG_FF_UNEQUAL = 1
GANG_FF_TOL = 12 / 512
#: phase 31 (b): Llama-3-8B widths at depth 4, 4 lanes of batch 2
GANG_LLAMA = dict(WORKER_LLAMA, max_len=1024, depth=4, batch_size=2,
                  bf16=True, adapters_only=False, quick_train=True,
                  max_epochs=6, remat=False, remat_policy="none")
GANG_LLAMA_HP = ((1e-4, 1.0), (3e-4, 0.5), (1e-3, 2.0), (3e-3, 0.25))
GANG_LLAMA_STEPS = 3
#: (b)'s loss tolerance (relative): bf16, the gang's row counts and
#: bmm against the sequential step's mm. The H100 calls saw <= 1.03e-4; a
#: planted fault (lanes 0 and 1 trading learning rates, GANG_LLAMA_FAULT)
#: must read above it
GANG_LLAMA_TOL = 1e-3
GANG_LLAMA_FAULT = (GANG_LLAMA_HP[1][0], GANG_LLAMA_HP[0][1]), \
    (GANG_LLAMA_HP[0][0], GANG_LLAMA_HP[1][1])
#: phase 31 (c): head dim 8, f32, adapters only (multi-adapter serving)
GANG_WORKER_PINS = {"hidden_dim": 64, "depth": 2, "n_heads": 8,
                    "kv_ratio": 2, "lora_rank": 4, "max_len": 128,
                    "batch_size": 8, "bf16": False, "adapters_only": True,
                    "quick_train": True, "model_parallel": 1,
                    "remat_policy": "none", "share_params": False}
GANG_PATHS = ("gang_feedforward",)


def _gang_feedforward(torch, np, dataset, dev_mod, tuning, ff, dev):
    """Phase 31 (a)."""
    from rafiki_tpu_torch.advisor import make_advisor

    work = ROOT / "build" / "chip_smoke" / "cnn_tuning"
    train, val = str(work / "fashion_train.zip"), str(work / "fashion_val.zip")
    if not (Path(train).exists() and Path(val).exists()):
        work.mkdir(parents=True, exist_ok=True)
        dataset.generate_fashion_archive(train, FASHION_IMAGES[0], seed=SEED)
        dataset.generate_fashion_archive(val, FASHION_IMAGES[1],
                                         seed=SEED + 1)
    engines = []
    real = tuning.GangEngine

    class Recorded(real):  # the engine tune_model builds, for its results
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    runs = {}
    for mode in ("gang", "sequential"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "gang":
            tuning.GangEngine = Recorded
            try:
                dev_mod.tune_model(
                    ff.JaxFeedForward, train, val,
                    total_trials=GANG_FF_TRIALS, advisor_type="bohb",
                    seed=SEED, gang_size=GANG_FF_LANES,
                    knob_overrides=GANG_FF_PINS, device=dev)
            finally:
                tuning.GangEngine = real
            results = engines[0].results
        else:
            adv = make_advisor(ff.JaxFeedForward.get_knob_config(), "bohb",
                               total_trials=GANG_FF_TRIALS, seed=SEED)
            results = real(
                ff.JaxFeedForward, adv, train, val, gang_size=GANG_FF_LANES,
                mode="sequential", knob_overrides=GANG_FF_PINS,
                device=dev).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode] = {"wall_s": wall, "trials": len(results),
                      "trials_per_hour": len(results) / wall * 3600.0,
                      "results": [((r.trial_no, r.knobs, r.budget_scale,
                                    r.meta.get("rung"),
                                    r.meta.get("parent_trial_no")),
                                   r.score) for r in results]}
    return runs


def _gang_llama(torch, np, ll, fa, dev):
    """Phase 31 (b): the gang steps, then each lane's sequential twin."""
    from rafiki_tpu_torch.tuning.gang import _LaneExec

    work = ROOT / "build" / "chip_smoke" / "gang"
    knobs = dict(GANG_LLAMA, learning_rate=GANG_LLAMA_HP[0][0],
                 lora_scale=GANG_LLAMA_HP[0][1])
    k, depth = len(GANG_LLAMA_HP), int(knobs["depth"])
    n = int(knobs["batch_size"]) * GANG_LLAMA_STEPS
    train = write_corpus(np, work / "train.jsonl", n, SEED, max_words=1100)
    val = write_corpus(np, work / "val.jsonl", 2, SEED + 1)
    est = ll.LlamaLoRA(device=dev, **knobs).estimate_device_budget(
        1, gang_size=k)
    print(f"chip_smoke: phase 31 (b) gang estimate "
          f"{est['total'] / 1e9:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = ll.LlamaLoRA.make_gang_spec(knobs, train, val, device=dev)
    ex = _LaneExec(spec, k, dev)
    batches = list(spec.epoch_batches(0))[:GANG_LLAMA_STEPS]

    def run(hps):
        for i, (lr, scale) in enumerate(hps):
            ex.fill_lane(i, dict(knobs, learning_rate=lr, lora_scale=scale),
                         None)
        losses, secs, per_step = [], [], []
        for batch in batches:
            stacked = {key: np.stack([v] * k) for key, v in batch.items()}
            before = flash_launches(fa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.state, out = spec.train_lanes(ex.state, ex.hp, stacked)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = flash_launches(fa)
            per_step.append({name: after[name] - before[name]
                             for name in after})
            losses.append([float(x) for x in out])
        return np.asarray(losses).T, secs, per_step  # (lanes, steps)

    zero_flash_launches(fa)
    gang, gang_s, per_step = run(GANG_LLAMA_HP)
    launches = flash_launches(fa)
    peak = torch.cuda.max_memory_allocated()
    # the gate's witness: the same run with a planted lane mix-up
    fault, _, _ = run((*GANG_LLAMA_FAULT, *GANG_LLAMA_HP[2:]))
    del ex
    torch.cuda.empty_cache()
    twin_losses, twin_s = [], []
    for lr, scale in GANG_LLAMA_HP:
        hp = {"learning_rate": torch.tensor(lr, device=dev),
              "lora_scale": torch.tensor(scale, device=dev)}
        twin = spec.init_lane(None, hp)
        row = []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            twin, loss = spec.train_step(twin, hp, batch)
            torch.cuda.synchronize()
            twin_s.append(time.perf_counter() - t0)
            row.append(float(loss))
        twin_losses.append(row)
        del twin
    del spec
    torch.cuda.empty_cache()
    twin = np.asarray(twin_losses)
    rel = float(np.max(np.abs(gang - twin) / np.abs(twin)))
    fault_rel = float(np.max(np.abs(fault - twin) / np.abs(twin)))
    steady = gang_s[1:] or gang_s
    k_seq = [sum(twin_s[i * GANG_LLAMA_STEPS + j] for i in range(k))
             for j in range(GANG_LLAMA_STEPS)]
    return {"lanes": k, "depth": depth, "knobs": {
                key: knobs[key] for key in ("hidden_dim", "n_heads",
                                            "kv_ratio", "lora_rank",
                                            "max_len", "batch_size",
                                            "vocab_size")},
            "hp": GANG_LLAMA_HP, "gang_losses": gang.tolist(),
            "twin_losses": twin.tolist(), "max_rel_loss_diff": rel,
            "tol": GANG_LLAMA_TOL,
            "fault": {"hp": GANG_LLAMA_FAULT, "losses": fault.tolist(),
                      "max_rel_loss_diff": fault_rel},
            "launches_per_step": per_step,
            "gang_step_s": gang_s, "k_sequential_steps_s": k_seq,
            "gang_step_median_s": float(np.median(steady)),
            "k_sequential_median_s": float(np.median(k_seq[1:] or k_seq)),
            "estimate_gb": {key: v / 1e9 for key, v in est.items()},
            "peak_gb": peak / 1e9}, launches


def _gang_worker(torch, np, ll, ms, ps, adv, wt, TrainContext, dev):
    """Phase 31 (c)."""
    import shutil

    work = ROOT / "build" / "chip_smoke" / "gang_worker"
    shutil.rmtree(work, ignore_errors=True)
    train = write_corpus(np, work / "train.jsonl", 32, SEED)
    val = write_corpus(np, work / "val.jsonl", 8, SEED + 1)
    meta = ms.MetaStore(str(work / "meta.db"))
    job = meta.create_train_job("smoke", "gang", 1, "TUNING",
                                {"TRIAL_COUNT": 2}, "train", "val")
    sub = meta.create_sub_train_job(job["id"], "gang")["id"]
    store = ps.ParamStore.from_uri(f"file://{work / 'params'}")
    worker = wt.TrainWorker(
        ll.LlamaLoRA, adv.make_advisor(ll.LlamaLoRA.get_knob_config(),
                                       "random", total_trials=2, seed=SEED),
        train, val, param_store=store, meta_store=meta,
        sub_train_job_id=sub, model_id="gang", worker_id="gw0",
        knob_overrides=GANG_WORKER_PINS, checkpoint_interval_s=0,
        device=dev)
    t0 = time.perf_counter()
    n = worker.run_gang(2)
    job_s = time.perf_counter() - t0
    rows = meta.get_trials_of_sub_train_job(sub)
    best = max(rows, key=lambda r: r["score"] or -1.0)
    twin = ll.LlamaLoRA(device=dev, **best["knobs"])
    twin.train(train, TrainContext())
    served = ll.LlamaLoRA(device=dev, **best["knobs"])
    served.load_parameters(store.load(best["id"]))
    multi = served.make_multi_adapter_engine(
        [served._params, twin._params], max_slots=4, max_new_tokens=16,
        kv_page_size=16)
    prompts = ["tok1 tok2 tok3", "tok7 tok8 tok9 tok10 tok11"]
    for i, p in enumerate(prompts):
        multi.submit(f"gang{i}", p, adapter_id=0)
        multi.submit(f"seq{i}", p, adapter_id=1)
    got = {}
    for _ in range(2000):
        if not multi.busy:
            break
        multi.step()
        got.update(dict(multi.poll()))
    torch.cuda.synchronize()
    return {"trials": n, "rows": [r["status"] for r in rows],
            "job_s": job_s, "best_score": best["score"],
            "texts": got, "engines": len(worker.gang_engine._execs),
            "equal": len(got) == 2 * len(prompts) and all(
                got[f"gang{i}"] == got[f"seq{i}"]
                for i in range(len(prompts)))}


def gang_phase(torch, np, ll, fa, pa, ff, dataset, dev_mod, tuning, ms, ps,
               adv, wt, TrainContext, dev):
    """Phase 31, the gang engine: (a) FeedForward, a 16-lane gang
    against the sequential schedule; (b) Llama-3-8B-width LoRA lanes
    against their sequential twins; (c) a gang job through the train
    worker, its winner served beside its twin."""
    t_phase = time.perf_counter()
    zero_flash_launches(fa)
    _zero_paged(pa)
    ff_runs = _gang_feedforward(torch, np, dataset, dev_mod, tuning, ff, dev)
    ff_launches = {**flash_launches(fa), **_paged_counts(pa)}
    t_b = time.perf_counter()
    llama, llama_launches = _gang_llama(torch, np, ll, fa, dev)
    b_s = time.perf_counter() - t_b
    torch.cuda.empty_cache()
    zero_flash_launches(fa)
    _zero_paged(pa)
    t_c = time.perf_counter()
    worker = _gang_worker(torch, np, ll, ms, ps, adv, wt, TrainContext, dev)
    worker_launches = {**flash_launches(fa), **_paged_counts(pa)}
    c_s = time.perf_counter() - t_c
    gang, seq = ff_runs["gang"]["results"], ff_runs["sequential"]["results"]
    ff_diffs = [abs(a[1] - b[1]) for a, b in zip(gang, seq)]
    ff_diff = max(ff_diffs, default=0.0)
    ff_unequal = sum(d != 0.0 for d in ff_diffs)
    same_trials = [a[0] for a in gang] == [b[0] for b in seq]
    emit({"phase": "gang",
          "feed_forward": {
              "pins": GANG_FF_PINS, "lanes": GANG_FF_LANES,
              "advisor": "bohb", **{mode: {key: r[key] for key in (
                  "wall_s", "trials", "trials_per_hour")}
                  for mode, r in ff_runs.items()},
              "same_trials": same_trials, "max_score_diff": ff_diff,
              "unequal_scores": ff_unequal, "tol": GANG_FF_TOL,
              "unequal_allowed": GANG_FF_UNEQUAL,
              "promotions": sum(a[0][4] is not None for a in gang),
              "culled": sum(a[0][2] < 1.0 - 1e-9 for a in gang),
              "trials_run": [{"trial_no": a[0][0], "budget": a[0][2],
                              "rung": a[0][3], "parent": a[0][4],
                              "learning_rate": a[0][1]["learning_rate"],
                              "gang_score": a[1], "sequential_score": b[1]}
                             for a, b in zip(gang, seq)]},
          "llama": llama, "llama_s": b_s,
          "worker": {**worker, "seconds": c_s,
                     "launches": worker_launches},
          "seconds": time.perf_counter() - t_phase})
    if not same_trials or len(gang) != GANG_FF_TRIALS:
        raise AssertionError("the FeedForward gang's trials, promotions or "
                             "culls differ from the sequential schedule's")
    if ff_unequal > GANG_FF_UNEQUAL or ff_diff > GANG_FF_TOL:
        raise AssertionError(f"{ff_unequal} FeedForward gang scores differ, "
                             f"by up to {ff_diff}")
    if any(ff_launches.values()):
        raise AssertionError(f"a port kernel ran on FeedForward: "
                             f"{ff_launches}")
    if not llama["max_rel_loss_diff"] <= GANG_LLAMA_TOL:
        raise AssertionError(f"Llama lanes left their sequential twins: "
                             f"{llama['max_rel_loss_diff']}")
    if not llama["fault"]["max_rel_loss_diff"] > GANG_LLAMA_TOL:
        raise AssertionError(f"the lane gate passed a planted fault: "
                             f"{llama['fault']}")
    want = {"flash_attention_fwd": llama["depth"],
            "flash_attention_bwd_dq": llama["depth"],
            "flash_attention_bwd_dkv": llama["depth"]}
    for step in llama["launches_per_step"]:
        if {name: step[name] for name in want} != want:
            raise AssertionError(f"a gang step launched {step}, not "
                                 f"{want}")
    if worker["trials"] != 2 or worker["engines"] != 1 or \
            set(worker["rows"]) != {"COMPLETED"}:
        raise AssertionError(f"run_gang: {worker}")
    if not worker["equal"]:
        raise AssertionError(f"the gang winner and its twin served "
                             f"{worker['texts']}")
    for name in ("paged_decode_attention", "paged_window_attention"):
        if not worker_launches.get(name):
            raise AssertionError(f"{name} did not launch serving the "
                                 "gang winner")
    return {"gang_feedforward": ff_launches, "gang_llama": llama_launches,
            "gang_worker": worker_launches}


# ---- the rest of the zoo (phase 33)

#: (a), (b), (d): the table at UCI Covertype's shape, 54 features and 7
#: classes (the generator's depth-3 teacher over them)
ZOO_FEATURES, ZOO_CLASSES = 54, 7
ZOO_TABLE_ROWS = (65536, 16384)  # train, val
#: (a): the MLP at its knob space's widest point; a budget of 0.2 is 2
#: of its fixed 10 epochs
ZOO_MLP_KNOBS = {"max_epochs": 10, "hidden_layer_count": 4,
                 "hidden_layer_units": 256, "dropout": 0.3,
                 "learning_rate": 1e-3, "batch_size": 256,
                 "quick_train": False, "share_params": False}
ZOO_MLP_BUDGET = 0.2
ZOO_MLP_STEPS = 32
#: (a)'s gate: each of the first 32 steps' losses on the card within
#: this of the CPU's, relative (f32 matmuls, TF32 off; the dropout masks
#: are the same integer threefry bits on both), at ZOO_EXACT_LR, the
#: knob's floor. At 1e-3 the H100 read 2.3e-4: steps 0-15 within 2e-7,
#: then Adam's steps on gradients at noise level carry the two GEMMs'
#: f32 rounding into the trajectory (on the CPU alone a 1e-7 nudge of the
#: initial weights reads 1.4e-5 by step 29 at 1e-3, 2.4e-7 at 1e-4)
ZOO_MLP_TOL = 1e-4
ZOO_EXACT_LR = 1e-4
ZOO_PREDICT_ROWS = 256
#: (a)'s accuracy bar after its 2 epochs, the JAX test's
#: (tests/test_models_pos_tabular.py)
ZOO_MLP_BAR = 0.7
#: (b): BOHB over tests/test_tuning.py's TAB_PINS on 8192 / 2048 rows
ZOO_GANG_ROWS = (8192, 2048)
ZOO_GANG_PINS = {"hidden_layer_count": 2, "hidden_layer_units": 32,
                 "batch_size": 128}
ZOO_GANG_TRIALS = 8
ZOO_GANG_LANES = 8
#: (b)'s score gate (masked accuracy over 2048 rows), as phase 31 (a)'s:
#: the gang's bmm and the sequential mm round apart in f32, so at most
#: ZOO_GANG_UNEQUAL trials may end apart, by at most ZOO_GANG_TOL; the
#: trials, promotions and culls must be equal
ZOO_GANG_UNEQUAL = 1
ZOO_GANG_TOL = 24 / 2048
#: (c): the Penn Treebank WSJ tag set's shape (45 tags), a 4096-word
#: vocabulary, sentences up to 32 tokens; 8192 / 1024 sentences, not the
#: WSJ split's 39832 (the generator draws token by token in Python)
ZOO_CORPUS = {"vocab_size": 4096, "n_tags": 45, "max_len": 32}
ZOO_SENTENCES = (8192, 1024)
#: (c): the tagger at its widest point; a budget of 0.1 is one epoch
ZOO_LSTM_KNOBS = {"max_epochs": 10, "vocab_size": 4096, "embed_dim": 128,
                  "hidden_dim": 256, "learning_rate": 1e-3,
                  "batch_size": 64, "max_len": 32, "quick_train": False,
                  "share_params": False}
ZOO_LSTM_BUDGET = 0.1
ZOO_LSTM_STEPS = 8
#: (c)'s gate: each of the first 8 steps' losses on the card within this
#: of the CPU's, relative (cuDNN's LSTM in f32, TF32 off)
ZOO_LSTM_TOL = 1e-4
ZOO_SERVE_SENTENCES = 256
ZOO_SERVE_CLIENTS = 16
#: (d): the host templates, their knobs, rows and the accuracy bar of
#: their JAX tests (tests/test_models_pos_tabular.py)
ZOO_HOST = (
    ("BigramHMM", {"emission_k": 0.01, "transition_k": 0.1,
                   "min_word_count": 1}, "corpus", 0.7),
    ("SklearnDecisionTree", {"max_depth": 16, "min_samples_split": 2,
                             "min_impurity_decrease": 1e-6,
                             "criterion": "gini"}, (4096, 1024), 0.8),
    ("SklearnGBDT", {"n_estimators": 25, "learning_rate_gb": 0.1,
                     "max_depth": 3, "subsample": 0.8}, (4096, 1024), 0.8),
    ("SklearnSVM", {"C": 1.0, "kernel": "rbf", "gamma_scale": 1.0},
     (2048, 512), 0.6))
ZOO_PATHS = ("zoo_tabular", "zoo_gang_tabular", "zoo_pos", "zoo_host")


def _zoo_counts(fa, pa, pe):
    return {**all_launches(fa, pe), **_paged_counts(pa)}


def _zoo_zero(fa, pa, pe):
    zero_all_launches(fa, pe)
    _zero_paged(pa)


def _tree_to(tree, dev):
    """A nested dict of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _rel_diffs(got, want):
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]


def _zoo_tabular(torch, np, dataset, loader, tab, ps, TrainContext, fa, pa,
                 pe, work, dev):
    """Phase 33 (a)."""
    import itertools

    train, val = str(work / "table_train.npz"), str(work / "table_val.npz")
    t0 = time.perf_counter()
    for path, rows, seed in ((train, ZOO_TABLE_ROWS[0], SEED),
                             (val, ZOO_TABLE_ROWS[1], SEED + 1)):
        dataset.generate_tabular_dataset(path, rows, ZOO_FEATURES,
                                         ZOO_CLASSES, seed=seed)
    gen_s = time.perf_counter() - t0
    ds, vds = dataset.load_tabular_dataset(train), \
        dataset.load_tabular_dataset(val)
    knobs = ZOO_MLP_KNOBS
    mean, std = tab.JaxTabularMLP._stats(ds.features)
    x = ((ds.features - mean) / std).astype(np.float32)
    # card against CPU: the template's own lane step from one state
    init = tab.JaxTabularMLP._lane_functions(
        knobs, ZOO_FEATURES, ZOO_CLASSES, torch.device("cpu"))[0](
            torch.Generator().manual_seed(SEED), {})
    losses = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        step = tab.JaxTabularMLP._lane_functions(knobs, ZOO_FEATURES,
                                                 ZOO_CLASSES, d)[1]
        state = _tree_to(init, d)
        hp = {"dropout": torch.tensor(float(knobs["dropout"]), device=d),
              "learning_rate": torch.tensor(ZOO_EXACT_LR, device=d)}
        out = []
        for b in itertools.islice(loader.batch_iterator(
                {"x": x, "y": ds.labels}, knobs["batch_size"], seed=0),
                ZOO_MLP_STEPS):
            state, loss = step(state, hp, b)
            out.append(loss)
        losses[name] = [float(v) for v in out]
    rel = _rel_diffs(losses["card"], losses["cpu"])
    # the template on the card: 2 epochs, evaluate, predict, the codec
    torch.cuda.synchronize()
    _zoo_zero(fa, pa, pe)
    m = tab.JaxTabularMLP(device=dev, **knobs)
    ctx = TrainContext(budget_scale=ZOO_MLP_BUDGET)
    t0 = time.perf_counter()
    m.train(train, ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    epochs = ctx.logger.get_values("loss")
    t0 = time.perf_counter()
    acc = m.evaluate(val)
    eval_s = time.perf_counter() - t0
    queries = list(vds.features[:ZOO_PREDICT_ROWS])
    t0 = time.perf_counter()
    probs = np.asarray(m.predict(queries))
    predict_s = time.perf_counter() - t0
    counts = _zoo_counts(fa, pa, pe)
    again = tab.JaxTabularMLP(device=dev, **knobs)
    again.load_parameters(ps.params_from_bytes(
        ps.params_to_bytes(m.dump_parameters())))
    steps = len(epochs) * math.ceil(ZOO_TABLE_ROWS[0] / knobs["batch_size"])
    return {"rows": ZOO_TABLE_ROWS, "features": ZOO_FEATURES,
            "classes": ZOO_CLASSES, "knobs": knobs, "generate_s": gen_s,
            "first_steps": {"card": losses["card"], "cpu": losses["cpu"],
                            "learning_rate": ZOO_EXACT_LR,
                            "max_rel_diff": max(rel), "tol": ZOO_MLP_TOL},
            "epoch_losses": epochs, "train_s": train_s, "steps": steps,
            "step_ms": 1e3 * train_s / steps,
            "rows_per_s": ZOO_TABLE_ROWS[0] * len(epochs) / train_s,
            "accuracy": acc, "evaluate_s": eval_s,
            "predict_rows": len(queries), "predict_s": predict_s,
            "probs_shape": list(probs.shape),
            "reloaded_equal": bool(np.array_equal(
                np.asarray(again.predict(queries)), probs))}, counts


def _zoo_gang(torch, np, dataset, dev_mod, tuning, tab, fa, pa, pe, work,
              dev):
    """Phase 33 (b)."""
    from rafiki_tpu_torch.advisor import make_advisor

    train, val = str(work / "gang_train.npz"), str(work / "gang_val.npz")
    for path, rows, seed in ((train, ZOO_GANG_ROWS[0], SEED + 2),
                             (val, ZOO_GANG_ROWS[1], SEED + 3)):
        dataset.generate_tabular_dataset(path, rows, ZOO_FEATURES,
                                         ZOO_CLASSES, seed=seed)
    engines, real = [], tuning.GangEngine

    class Recorded(real):  # the engine tune_model builds, for its results
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    tmpl = tab.JaxTabularMLP
    runs = {}
    torch.cuda.synchronize()
    _zoo_zero(fa, pa, pe)
    for mode in ("gang", "sequential"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "gang":
            tuning.GangEngine = Recorded
            try:
                dev_mod.tune_model(
                    tmpl, train, val, total_trials=ZOO_GANG_TRIALS,
                    advisor_type="bohb", seed=SEED,
                    gang_size=ZOO_GANG_LANES, knob_overrides=ZOO_GANG_PINS,
                    device=dev)
            finally:
                tuning.GangEngine = real
            results = engines[0].results
        else:
            adv = make_advisor(tmpl.get_knob_config(), "bohb",
                               total_trials=ZOO_GANG_TRIALS, seed=SEED)
            results = real(tmpl, adv, train, val, gang_size=ZOO_GANG_LANES,
                           mode="sequential", knob_overrides=ZOO_GANG_PINS,
                           device=dev).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode] = {"wall_s": wall, "trials": len(results),
                      "results": [((r.trial_no, r.budget_scale,
                                    r.meta.get("rung"),
                                    r.meta.get("parent_trial_no")),
                                   r.score, r.knobs) for r in results]}
    counts = _zoo_counts(fa, pa, pe)
    gang, seq = runs["gang"]["results"], runs["sequential"]["results"]
    diffs = [abs(a[1] - b[1]) for a, b in zip(gang, seq)]
    return {"rows": ZOO_GANG_ROWS, "pins": ZOO_GANG_PINS,
            "lanes": ZOO_GANG_LANES, "advisor": "bohb",
            **{mode: {"wall_s": r["wall_s"], "trials": r["trials"]}
               for mode, r in runs.items()},
            "same_trials": [a[0] for a in gang] == [b[0] for b in seq]
            and len(gang) == ZOO_GANG_TRIALS,
            "max_score_diff": max(diffs, default=0.0),
            "unequal_scores": sum(d != 0.0 for d in diffs),
            "tol": ZOO_GANG_TOL, "unequal_allowed": ZOO_GANG_UNEQUAL,
            "promotions": sum(a[0][3] is not None for a in gang),
            "culled": sum(a[0][1] < 1.0 - 1e-9 for a in gang),
            "trials_run": [{"trial_no": a[0][0], "budget": a[0][1],
                            "parent": a[0][3],
                            "dropout": a[2]["dropout"],
                            "learning_rate": a[2]["learning_rate"],
                            "gang_score": a[1], "sequential_score": b[1]}
                           for a, b in zip(gang, seq)]}, counts


def _zoo_sentences(corpus, n):
    """``n`` validation sentences for serving, among them empty ones and
    ones longer than ``max_len``."""
    out = []
    for i in range(n):
        toks = list(corpus.sentences[i % len(corpus.sentences)][0])
        if i % 16 == 5:
            toks = []
        elif i % 16 == 11:
            toks = toks * (ZOO_CORPUS["max_len"] // max(len(toks), 1) + 2)
        out.append(toks)
    return out


def _zoo_pos(torch, np, dataset, loader, pos, ps, queues, wi,
             TrainContext, fa, pa, pe, work, dev):
    """Phase 33 (c)."""
    import itertools
    import threading

    ds = dataset.CorpusDataset.load(str(work / "corpus_train.jsonl"))
    vds = dataset.CorpusDataset.load(str(work / "corpus_val.jsonl"))
    knobs = ZOO_LSTM_KNOBS
    tags = list(ds.tag_names)
    cpu = pos.BiLSTMTagger(device="cpu", **knobs)
    cpu._tags = tags
    blob0 = pos._to_jax(cpu._module().state_dict())
    t0 = time.perf_counter()
    batches = list(itertools.islice(loader.batch_iterator(
        cpu._arrays(ds), knobs["batch_size"], seed=0), ZOO_LSTM_STEPS))
    encode_s = time.perf_counter() - t0
    losses = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        t = pos.BiLSTMTagger(device=d, **knobs)
        t._tags = tags
        step = pos.BiLSTMTagger._step_fn(t._net(blob0),
                                         knobs["learning_rate"], d)
        losses[name] = [float(step(b)) for b in batches]
    rel = _rel_diffs(losses["card"], losses["cpu"])
    torch.cuda.synchronize()
    _zoo_zero(fa, pa, pe)
    m = pos.BiLSTMTagger(device=dev, **knobs)
    ctx = TrainContext(budget_scale=ZOO_LSTM_BUDGET)
    t0 = time.perf_counter()
    m.train(str(work / "corpus_train.jsonl"), ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    acc = m.evaluate(str(work / "corpus_val.jsonl"))
    steps = math.ceil(ZOO_SENTENCES[0] / knobs["batch_size"])
    # the blob served by a worker
    store = ps.ParamStore.from_uri("mem://")
    store.save("bilstm", m.dump_parameters())
    hub = queues.InProcQueueHub()
    worker = wi.InferenceWorker(pos.BiLSTMTagger, "bilstm", knobs, store,
                                hub, "p0", decode_loop=False, device=dev)
    sents = _zoo_sentences(vds, ZOO_SERVE_SENTENCES)
    msgs = [{"id": f"s{i}", "queries": sents[32 * i:32 * (i + 1)]}
            for i in range(len(sents) // 32)]
    for msg in msgs:
        hub.push_query("p0", queues.pack_message(msg))
    loop = threading.Thread(target=worker.run,
                            kwargs={"poll_timeout": 0.01})
    t0 = time.perf_counter()
    loop.start()
    replies = [queues.unpack_message(hub.pop_prediction(msg["id"], 300.0))
               for msg in msgs]
    wall = time.perf_counter() - t0
    served = [p for r in replies for p in r["predictions"]]
    per_client = ZOO_SERVE_SENTENCES // ZOO_SERVE_CLIENTS
    lat = []

    def client(c):
        for j in range(per_client):
            mid = f"c{c}_{j}"
            t1 = time.perf_counter()
            hub.push_query("p0", queues.pack_message(
                {"id": mid, "queries": [sents[c * per_client + j]]}))
            queues.unpack_message(hub.pop_prediction(mid, 300.0))
            lat.append(time.perf_counter() - t1)

    clients = [threading.Thread(target=client, args=(c,))
               for c in range(ZOO_SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    wall16 = time.perf_counter() - t0
    worker.stop()
    loop.join()
    counts = _zoo_counts(fa, pa, pe)
    direct = m.predict(sents)
    again = pos.BiLSTMTagger(device=dev, **knobs)
    again.load_parameters(ps.params_from_bytes(
        ps.params_to_bytes(m.dump_parameters())))
    return {"sentences": ZOO_SENTENCES, "corpus": ZOO_CORPUS,
            "knobs": knobs, "encode_8_batches_s": encode_s,
            "first_steps": {"card": losses["card"], "cpu": losses["cpu"],
                            "max_rel_diff": max(rel), "tol": ZOO_LSTM_TOL},
            "epoch_losses": ctx.logger.get_values("loss"),
            "train_s": train_s, "steps": steps,
            "step_ms": 1e3 * train_s / steps,
            "sentences_per_s_train": ZOO_SENTENCES[0] / train_s,
            "accuracy": acc, "served": len(served),
            "empty": sum(not s for s in sents),
            "over_max_len": sum(len(s) > ZOO_CORPUS["max_len"]
                                for s in sents),
            "served_equal_predict": served == direct,
            "wall_256_s": wall, "sentences_per_s_256": len(sents) / wall,
            "concurrency_16": {"requests": len(lat), "wall_s": wall16,
                               "sentences_per_s": len(lat) / wall16,
                               "p50_s": float(np.percentile(lat, 50)),
                               "p95_s": float(np.percentile(lat, 95))},
            "reloaded_equal": again.predict(sents) == direct,
            "errors": [r["error"] for r in replies if r.get("error")]}, \
        counts


def zoo_host_main(work):
    """Phase 33's host leg, (d), in a process of its own beside the card
    legs: it writes (c)'s corpus first (``corpus.ready`` marks it), then
    fits and serves the host templates and writes ``host.json``."""
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from rafiki_tpu_torch.data import dataset
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.ops import paged_attention as pa
    from rafiki_tpu_torch.ops import patch_embed as pe
    from rafiki_tpu_torch.models import get_model_template
    from rafiki_tpu_torch.store import param_store as ps

    t_leg = time.perf_counter()
    corpus = {}
    for split, n, seed in (("train", ZOO_SENTENCES[0], SEED),
                           ("val", ZOO_SENTENCES[1], SEED + 1)):
        path = work / f"corpus_{split}.jsonl"
        dataset.generate_corpus_dataset(str(path), n, seed=seed,
                                        **ZOO_CORPUS)
        corpus[split] = str(path)
    corpus_s = time.perf_counter() - t_leg
    (work / "corpus.ready").write_text(str(corpus_s))
    t0 = time.perf_counter()
    tables = {}
    for rows in {r for _, _, r, _ in ZOO_HOST if r != "corpus"}:
        paths = []
        for split, n, seed in (("train", rows[0], SEED + 4),
                               ("val", rows[1], SEED + 5)):
            path = work / f"host_{rows[0]}_{split}.npz"
            dataset.generate_tabular_dataset(str(path), n, ZOO_FEATURES,
                                             ZOO_CLASSES, seed=seed)
            paths.append(str(path))
        tables[rows] = paths
    tables_s = time.perf_counter() - t0
    _zoo_zero(fa, pa, pe)
    results = []
    for name, knobs, rows, bar in ZOO_HOST:
        train, val = ((corpus["train"], corpus["val"]) if rows == "corpus"
                      else tables[rows])
        cls = get_model_template(name)
        m = cls(**knobs)
        t0 = time.perf_counter()
        m.train(train)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = m.evaluate(val)
        eval_s = time.perf_counter() - t0
        if rows == "corpus":
            queries = [toks for toks, _ in
                       dataset.CorpusDataset.load(val).sentences[:64]]
        else:
            queries = dataset.load_tabular_dataset(val).features[
                :64].tolist()
        want = m.predict(queries)
        again = cls(**knobs)
        blob = ps.params_to_bytes(m.dump_parameters())
        again.load_parameters(ps.params_from_bytes(blob))
        results.append({"template": name, "knobs": knobs,
                        "rows": rows if rows == "corpus" else list(rows),
                        "train_s": train_s, "evaluate_s": eval_s,
                        "accuracy": acc, "bar": bar,
                        "blob_bytes": len(blob),
                        "reloaded_equal": again.predict(queries) == want})
    out = {"corpus_s": corpus_s, "tables_s": tables_s, "results": results,
           "launches": _zoo_counts(fa, pa, pe),
           "seconds": time.perf_counter() - t_leg}
    (work / "host.json").write_text(json.dumps(out))
    return 0


def zoo_phase(torch, np, dataset, loader, dev_mod, tuning, tab, pos, ps,
              queues, wi, TrainContext, fa, pa, pe, dev):
    """Phase 33, the rest of the zoo: (a) ``JaxTabularMLP`` on the card,
    (b) its gang against the sequential schedule, (c) ``BiLSTMTagger`` on
    the card and behind a worker, (d) the host templates, fitted without
    scikit-learn in a process of their own while (a)-(c) run."""
    import os
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "zoo"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--zoo-host",
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        t0 = time.perf_counter()
        tabular, tab_counts = _zoo_tabular(torch, np, dataset, loader, tab,
                                           ps, TrainContext, fa, pa, pe,
                                           work, dev)
        tabular["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gang, gang_counts = _zoo_gang(torch, np, dataset, dev_mod, tuning,
                                      tab, fa, pa, pe, work, dev)
        gang["seconds"] = time.perf_counter() - t0
        t_wait = time.perf_counter()
        while not (work / "corpus.ready").exists():
            if child.poll() is not None:
                raise AssertionError("the host leg ended before writing "
                                     "the corpus: " + child.stdout.read())
            time.sleep(0.05)
        corpus_wait_s = time.perf_counter() - t_wait
        t0 = time.perf_counter()
        pos_res, pos_counts = _zoo_pos(torch, np, dataset, loader, pos, ps,
                                       queues, wi, TrainContext, fa, pa, pe,
                                       work, dev)
        pos_res["seconds"] = time.perf_counter() - t0
        t_wait = time.perf_counter()
        child_out, _ = child.communicate(timeout=600)
        host_wait_s = time.perf_counter() - t_wait
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"the host leg failed:\n{child_out[-4000:]}")
    host = json.loads((work / "host.json").read_text())
    host_counts = host.pop("launches")
    emit({"phase": "zoo", "tabular": tabular, "gang_tabular": gang,
          "pos": pos_res, "host": host, "corpus_wait_s": corpus_wait_s,
          "host_wait_s": host_wait_s,
          "launches": {"zoo_tabular": tab_counts,
                       "zoo_gang_tabular": gang_counts,
                       "zoo_pos": pos_counts, "zoo_host": host_counts},
          "seconds": time.perf_counter() - t_phase})
    first = tabular["first_steps"]
    if not first["max_rel_diff"] <= ZOO_MLP_TOL:
        raise AssertionError(f"the MLP's card steps left the CPU's: "
                             f"{first}")
    if not (tabular["reloaded_equal"] and tabular["accuracy"] > ZOO_MLP_BAR
            and tabular["probs_shape"] == [ZOO_PREDICT_ROWS, ZOO_CLASSES]
            and tabular["epoch_losses"][-1] < tabular["epoch_losses"][0]):
        raise AssertionError(f"the MLP on the card: {tabular}")
    if not gang["same_trials"]:
        raise AssertionError("the tabular gang's trials, promotions or "
                             "culls differ from the sequential schedule's")
    if gang["unequal_scores"] > ZOO_GANG_UNEQUAL or \
            gang["max_score_diff"] > ZOO_GANG_TOL:
        raise AssertionError(f"{gang['unequal_scores']} tabular gang scores "
                             f"differ, by up to {gang['max_score_diff']}")
    if not pos_res["first_steps"]["max_rel_diff"] <= ZOO_LSTM_TOL:
        raise AssertionError(f"the BiLSTM's card steps left the CPU's: "
                             f"{pos_res['first_steps']}")
    if not (pos_res["served_equal_predict"] and pos_res["reloaded_equal"]
            and pos_res["served"] == ZOO_SERVE_SENTENCES
            and pos_res["empty"] and pos_res["over_max_len"]
            and not pos_res["errors"]
            and pos_res["epoch_losses"][0] < math.log(ZOO_CORPUS["n_tags"])):
        raise AssertionError(f"the BiLSTM on the card: {pos_res}")
    for r in host["results"]:
        if not (r["accuracy"] > r["bar"] and r["reloaded_equal"]):
            raise AssertionError(f"host template {r['template']}: {r}")
    for path, counts in (("zoo_tabular", tab_counts),
                         ("zoo_gang_tabular", gang_counts),
                         ("zoo_pos", pos_counts), ("zoo_host", host_counts)):
        if any(counts.values()):
            raise AssertionError(f"a port kernel ran on {path}: {counts}")
    return {"zoo_tabular": tab_counts, "zoo_gang_tabular": gang_counts,
            "zoo_pos": pos_counts, "zoo_host": host_counts}


# ---- the image formats (phase 34)

#: phase 34's fixtures: one small file per decoder branch, PIL's arrays
#: for them (``pil_arrays.npz``) and JAX's generator digests
#: (``generator_digests.json``), written by ``tests/test_torch_images.py``
IMAGE_FIXTURES = ROOT / "tests" / "fixtures" / "torch_images"
#: phase 34 (c): the loader leg at ImageNet's shape
FORMAT_IMAGES = 2048
FORMAT_BATCH = 256
FORMATS = ("jpeg", "png", "npy")


def _image_fixtures(np, image):
    """Phase 34 (a): every fixture decoded here against PIL's array."""
    with np.load(IMAGE_FIXTURES / "pil_arrays.npz") as z:
        want = {name: z[name] for name in z.files}
    names = sorted(p.name for p in IMAGE_FIXTURES.iterdir()
                   if p.suffix in (".png", ".jpg"))
    if names != sorted(want):
        raise AssertionError(f"fixtures {names} against arrays "
                             f"{sorted(want)}")
    unequal = []
    t0 = time.perf_counter()
    for name in names:
        got = image.decode_image((IMAGE_FIXTURES / name).read_bytes())
        ref = want[name]
        if got.dtype != ref.dtype or got.shape != ref.shape or \
                not np.array_equal(got, ref):
            unequal.append(name)
    return {"files": len(names), "unequal": unequal,
            "seconds": time.perf_counter() - t0}


def _zip_digests(path):
    import hashlib
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {name: hashlib.sha256(z.read(name)).hexdigest()
                for name in z.namelist()}


def _generator_digests(stream, work):
    """Phase 34 (b): the port's generator against JAX's digests."""
    cases = json.loads((IMAGE_FIXTURES / "generator_digests.json")
                       .read_text())
    unequal, members = [], 0
    t0 = time.perf_counter()
    for case in cases:
        path = work / f"generator_{case['seed']}.zip"
        stream.generate_streaming_image_zip(
            str(path), case["n"], tuple(case["shape"]), seed=case["seed"],
            fmt=case["fmt"])
        got = _zip_digests(path)
        members += len(got)
        if got != case["sha256"]:
            unequal.append(case)
    return {"cases": len(cases), "members": members, "unequal": unequal,
            "seconds": time.perf_counter() - t0}


def _write_zip(path, names, blobs, labels):
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, blob in zip(names, blobs):
            zf.writestr(name, blob)
        zf.writestr("labels.csv", "\n".join(
            ["path,label"] + [f"{n},c{int(y)}" for n, y in zip(names,
                                                              labels)]))


def _encode_all(np, fmt, images, jpeg, png):
    """Each image's file bytes, on worker threads (zlib and the native
    codec release the GIL)."""
    import io
    import os

    def npy(img):
        buf = io.BytesIO()
        np.save(buf, img, allow_pickle=False)
        return buf.getvalue()

    encoder = {"jpeg": jpeg.encode_jpeg, "png": png.encode_png,
               "npy": npy}[fmt]
    with ThreadPoolExecutor(os.cpu_count() or 8) as ex:
        return list(ex.map(encoder, images))


def _loader_leg(np, stream, jpeg, png, work):
    """Phase 34 (c): one epoch of the streaming loader per format."""
    rng = np.random.default_rng(SEED + 34)
    labels = rng.integers(0, 4, FORMAT_IMAGES)
    # the streaming generator's picture: noise under one bright quadrant
    images = rng.integers(0, 96, (FORMAT_IMAGES,) + RESNET_IMAGE,
                          dtype=np.uint8)
    half = RESNET_IMAGE[0] // 2
    for label in range(4):
        top, left = (label // 2) * half, (label % 2) * half
        images[labels == label, top:top + half, left:left + half] += 140
    out = {}
    for fmt in FORMATS:
        names = [f"img{i:06d}.{fmt}" for i in range(FORMAT_IMAGES)]
        t0 = time.perf_counter()
        blobs = _encode_all(np, fmt, images, jpeg, png)
        encode_s = time.perf_counter() - t0
        path = work / f"loader_{fmt}.zip"
        _write_zip(path, names, blobs, labels)
        ds = stream.StreamingImageDataset(str(path))
        first = next(ds.iter_batches(1, shuffle=False))["x"][0]
        t0 = time.perf_counter()
        seen = 0
        for b in ds.iter_batches(FORMAT_BATCH, epoch=0, shuffle=True,
                                 seed=0, augment=True):
            if b["x"].shape != (FORMAT_BATCH,) + RESNET_IMAGE:
                raise AssertionError(f"{fmt}: a batch of {b['x'].shape}")
            seen += int(b["mask"].sum())
        epoch_s = time.perf_counter() - t0
        if seen != FORMAT_IMAGES:
            raise AssertionError(f"{fmt}: {seen} images in the epoch")
        err = np.abs(first.astype(np.int16) - images[0]).mean()
        if fmt != "jpeg" and err:
            raise AssertionError(f"{fmt} does not give its pixels back")
        out[fmt] = {"encode_s": encode_s,
                    "mb": sum(map(len, blobs)) / 2 ** 20,
                    "epoch_s": epoch_s, "images_per_s": seen / epoch_s,
                    "first_image_mean_abs_err": float(err),
                    "workers": ds.n_workers,
                    "prefetch_batches": ds.prefetch_batches}
        path.unlink()
    return out


def image_formats_phase(torch, np, vit, lp, TrainContext, stream, image,
                        jpeg, png, fa, pe, dev, smi):
    """Phase 34, the image formats: (a) the fixtures against PIL's
    arrays, (b) the generator against JAX's digests, (c) the loader's
    images/s by format, (d) ViT-B/16 trained from a JPEG zip."""
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "image_formats"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fixtures = _image_fixtures(np, image)
    generator = _generator_digests(stream, work)
    t0 = time.perf_counter()
    loader = _loader_leg(np, stream, jpeg, png, work)
    loader_s = time.perf_counter() - t0
    # (d): phase 13's images and labels, as JPEG members
    steps, batch = 8, VIT_KNOBS["batch_size"]
    npz, images = write_images(np, work / "vit_train.npz", steps * batch,
                               SEED + 13)
    with np.load(npz) as z:
        labels = z["labels"]
    t0 = time.perf_counter()
    blobs = _encode_all(np, "jpeg", images, jpeg, png)
    vit_encode_s = time.perf_counter() - t0
    path = work / "vit_train_jpeg.zip"
    _write_zip(path, [f"img{i:06d}.jpg" for i in range(len(blobs))], blobs,
               labels)
    if len(set(labels.tolist())) != 10:
        raise AssertionError("the JPEG set lacks a class")
    m = vit.ViTBase16(device=dev, **VIT_KNOBS)
    ctx = TrainContext()
    r = _train_timed(torch, m, str(path), ctx, lp, fa, pe, profile_step=-1)
    queries = [jpeg.decode_jpeg(b) for b in blobs[:64]]
    probs = np.asarray(m.predict(queries))
    fresh = vit.ViTBase16(device=dev, **VIT_KNOBS)
    fresh.load_parameters(m.dump_parameters())
    reloaded = np.asarray(fresh.predict(queries))
    del fresh, m
    jpeg_err = float(np.mean([np.abs(q.astype(np.int16) - img).mean()
                              for q, img in zip(queries, images)]))
    steady = r["step_s"][1:]
    vit_leg = {"model": "ViT-B/16", "images": len(blobs), "batch": batch,
               "steps": steps, "encode_s": vit_encode_s,
               "zip_mb": path.stat().st_size / 2 ** 20,
               "decoded_mean_abs_err": jpeg_err, "losses": r["losses"],
               "step_s": r["step_s"],
               "steady_step_s": float(np.mean(steady)),
               "wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
               "launches": r["launches"],
               "reload_identical": bool(np.array_equal(reloaded, probs))}
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "image_formats", "card": smi, "fixtures": fixtures,
          "generator": generator, "loader": loader, "loader_s": loader_s,
          "vit_jpeg": vit_leg, "seconds": time.perf_counter() - t_phase})
    if fixtures["unequal"]:
        raise AssertionError(f"fixtures decoded unlike PIL: "
                             f"{fixtures['unequal']}")
    if generator["unequal"]:
        raise AssertionError(f"generator members unlike JAX's: "
                             f"{generator['unequal']}")
    depth = VIT_KNOBS["depth"]
    _check_training("ViT from JPEG", r, {
        "flash_attention_fwd": depth * steps,
        "flash_attention_bwd_dq": depth * steps,
        "flash_attention_bwd_dkv": depth * steps,
        "flash_attention_fwd_mh": 0, "matmul_bias": steps})
    if not vit_leg["reload_identical"]:
        raise AssertionError("ViT (JPEG) dump → reload → predict differs")
    return {"vit_jpeg_training": r["launches"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=4,
                    help="decoder depth of the serving legs, phases 4 "
                         "and 16 (widths are never cut; 4 of 32 by "
                         "default, for the call's time)")
    ap.add_argument("--train-depth", type=int, default=32,
                    help="decoder depth of the training leg (widths are "
                         "never cut)")
    ap.add_argument("--worker-depth", type=int, default=2,
                    help="decoder depth of the Llama worker leg, phase 18 "
                         "(widths are never cut; 2 of 32 by default, for "
                         "the call's time)")
    ap.add_argument("--slice-depth", type=int, default=2,
                    help="decoder depth of phase 24's checkpoint, "
                         "fine-tune and serving legs and of phases 26 "
                         "and 29 "
                         "(widths are never cut; 2 of 32 by default, for "
                         "the call's time)")
    ap.add_argument("--zoo-host", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "rafiki_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(rafiki_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    if args.zoo_host:  # phase 33 (d), started by phase 33
        return zoo_host_main(Path(args.zoo_host))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from rafiki_tpu_torch import advisor as adv
    from rafiki_tpu_torch.model import loop as lp
    from rafiki_tpu_torch.model import optim
    from rafiki_tpu_torch.data import bpe
    from rafiki_tpu_torch.data import dataset
    from rafiki_tpu_torch.data import image, jpeg, png
    from rafiki_tpu_torch.data import loader
    from rafiki_tpu_torch.data import stream
    from rafiki_tpu_torch.model import dev as dev_mod
    from rafiki_tpu_torch.model.base import TrainContext
    from rafiki_tpu_torch.models import bert
    from rafiki_tpu_torch.models import convert as conv
    from rafiki_tpu_torch.models import densenet, layers, resnet, vgg
    from rafiki_tpu_torch.models import llama_lora as ll
    from rafiki_tpu_torch.models import mlp
    from rafiki_tpu_torch.models import pos_tagging as pos
    from rafiki_tpu_torch.models import tabular as tab
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.models.bert import HashTokenizer
    from rafiki_tpu_torch.ops import _build
    from rafiki_tpu_torch.ops import attention as fa
    from rafiki_tpu_torch.ops import paged_attention as pa
    from rafiki_tpu_torch.ops import patch_embed as pe
    from rafiki_tpu_torch.serving import decode_engine as de
    from rafiki_tpu_torch.serving import queues
    from rafiki_tpu_torch.store import meta_store as ms
    from rafiki_tpu_torch.store import param_store as ps
    from rafiki_tpu_torch.store import params as store_params
    from rafiki_tpu_torch.store import safetensors_io as sio
    from rafiki_tpu_torch import tuning
    from rafiki_tpu_torch.worker import inference as wi
    from rafiki_tpu_torch.worker import train as wt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    sources, build_s, ptxas = build_kernels(_build)
    emit({"phase": "build", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sources": sources,
          "build_s": build_s, "kernels_compiled": len(ptxas),
          "spilling": [e["mangled"] for e in ptxas if e["spill_bytes"]],
          "most_registers": max((e["registers"] or 0) for e in ptxas)})
    depths = {"serving": args.depth, "training": args.train_depth,
              "worker": args.worker_depth, "slice": args.slice_depth}
    cut = {leg: d for leg, d in depths.items() if d != 32}
    if cut:
        print("chip_smoke: Llama legs cut to depth " + ", ".join(
            f"{d} ({leg})" for leg, d in cut.items()) + " of 32",
            flush=True)

    dev = torch.device("cuda")
    # the paths' launch counts assume the per-head forward (B3) whatever
    # RAFIKI_ATTN_BLOCK_H says; the ViT serving leg sets 4 for its B4 run
    fa.ATTN_BLOCK_H = 1
    paths = {}  # main path -> {kernel: launches}
    kres = kernel_phase(torch, np, F, pa, ll, dev, ptxas)
    exactness_phase(torch, np, ll, de, dev)
    torch.cuda.empty_cache()
    paths["llama_serving"] = serving_phase(torch, np, ll, de, pa,
                                           HashTokenizer, args.depth, dev)
    torch.cuda.empty_cache()  # phase 4's model is gone: free its memory
    paths["llama_int8_serving"] = serving_phase(
        torch, np, ll, de, pa, HashTokenizer, args.depth, dev, int8=True)
    torch.cuda.empty_cache()
    kres.update(flash_phase(torch, np, F, fa, dev, ptxas=ptxas))
    torch.cuda.empty_cache()
    train_exactness_phase(torch, np, ll, fa, dev)
    torch.cuda.empty_cache()
    paths["llama_training"] = training_phase(torch, np, ll, fa,
                                             args.train_depth, dev)
    torch.cuda.empty_cache()
    template_phase(torch, np, ll, TrainContext, dev)
    torch.cuda.empty_cache()
    kres.update(matmul_bias_phase(torch, np, pe, dev, ptxas))
    classifier = classifier_flash_phase(torch, np, F, fa, dev, ptxas=ptxas)
    kres["flash_attention_fwd_mh"] = classifier["flash_attention_fwd_mh"]
    lib_vit = classifier["flash_attention_bwd_dq"]["library_ms"]
    lib_bert = classifier["flash_attention_bwd_dq"]["bert_library_ms"]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        c = classifier[name]
        kres[name]["classifier_shapes"] = {
            "vit": {"ms": c["ms"], "bound_ms": c["bound_ms"],
                    "library_ms": lib_vit, "shapes": c["shapes"]},
            "bert": {"ms": c["bert_ms"], "library_ms": lib_bert,
                     **c["bert_bound"]},
            "library_covers": "SDPA backward: dq, dk and dv in one call"}
    torch.cuda.empty_cache()
    classifier_exactness_phase(torch, np, vit, bert, fa, pe, lp, optim, dev)
    torch.cuda.empty_cache()
    paths.update(vit_serving_phase(torch, np, vit, store_params, fa, pe,
                                   dev))
    torch.cuda.empty_cache()
    paths.update(vit_training_phase(torch, np, vit, lp, TrainContext, fa,
                                    pe, dev))
    torch.cuda.empty_cache()
    paths.update(image_formats_phase(torch, np, vit, lp, TrainContext,
                                     stream, image, jpeg, png, fa, pe, dev,
                                     smi))
    torch.cuda.empty_cache()
    paths.update(bert_phase(torch, np, bert, lp, TrainContext, fa, pe, dev))
    torch.cuda.empty_cache()
    paths["llama_hd8_serving"] = hd8_serving_phase(torch, np, ll, de, pa,
                                                   dev)
    paths["llama_hd8_int8_serving"] = hd8_serving_phase(
        torch, np, ll, de, pa, dev, int8=True)
    paths["llama_slice_hd8"] = slice_exactness_phase(torch, np, ll, de, pa,
                                                     ps, bpe, dev)
    torch.cuda.empty_cache()
    # phase 18 runs last, so its 35 GB of host memory cannot weigh on the
    # other phases' host-clock timings
    paths["llama_hd8_worker"] = worker_exactness_phase(
        torch, np, ll, store_params, ps, queues, wi, pa, dev)
    paths["vit_worker"] = vit_worker_phase(torch, np, vit, store_params, ps,
                                           queues, wi, fa, pe, dev)
    torch.cuda.empty_cache()
    paths.update(vit_tuning_phase(torch, np, vit, ms, ps, adv, wt, queues,
                                  wi, fa, pe, dev))
    torch.cuda.empty_cache()
    paths.update(llama_tuning_phase(torch, np, ll, ms, ps, adv, wt, queues,
                                    wi, fa, pa, dev))
    torch.cuda.empty_cache()
    paths.update(stack_phase(torch, np, vit, dev))
    torch.cuda.empty_cache()
    paths.update(scaleout_phase(torch, np, vit, ll, store_params,
                                HashTokenizer, dev))
    torch.cuda.empty_cache()
    cnn = {"resnet": resnet, "vgg": vgg, "densenet": densenet}
    paths.update(resnet_phase(torch, np, cnn, layers, stream, store_params,
                              optim, lp, TrainContext, fa, pe, pa, dev))
    torch.cuda.empty_cache()
    paths.update(cnn_tuning_phase(torch, np, cnn, dataset, dev_mod, ps,
                                  queues, wi, fa, pe, pa, TrainContext, dev))
    torch.cuda.empty_cache()
    paths.update(gang_phase(torch, np, ll, fa, pa, mlp, dataset, dev_mod,
                            tuning, ms, ps, adv, wt, TrainContext, dev))
    torch.cuda.empty_cache()
    paths.update(zoo_phase(torch, np, dataset, loader, dev_mod, tuning, tab,
                           pos, ps, queues, wi, TrainContext, fa, pa, pe,
                           dev))
    torch.cuda.empty_cache()
    paths.update(slice_phase(torch, np, ll, de, pa, fa, conv, sio, bpe, ps,
                             store_params, args.slice_depth, dev))
    torch.cuda.empty_cache()
    paths["llama_worker"] = llama_worker_phase(
        torch, np, ll, ps, queues, wi, pa, args.worker_depth, dev)

    # the CNN, FeedForward-gang and zoo paths launch no port kernel:
    # their zeros are listed too
    by_path = {name: {path: counts.get(name, 0)
                      for path, counts in paths.items()
                      if counts.get(name) or path in CNN_PATHS
                      or path in GANG_PATHS or path in ZOO_PATHS}
               for name in kres}
    for name in ("paged_decode_attention", "paged_window_attention"):
        kres[name]["int8_launches_by_path"] = by_path[name + "_int8"]
    emit({"phase": "done", "seconds_after_start": time.perf_counter()
          - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": r["max_abs_err"], "tol": r["tol"], "ms": r["ms"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "card": smi, "shapes": r["shapes"],
         **{key: r[key] for key in ("err_over_tol", "library_covers",
                                    "identical_to_b3", "plan", "gb_per_s",
                                    "bound_share", "b3_same_call_ms",
                                    "ptxas", "bit_identical_second_call",
                                    "full_length", "classifier_shapes",
                                    "f32_queries", "int8_launches_by_path",
                                    "verify_windows")
            if key in r}}
        for name, r in kres.items()]})
    missing = [name for name in kres if not sum(by_path[name].values())]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
