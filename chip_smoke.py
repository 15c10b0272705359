#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them, and
when run from a directory that does not hold the repository's ``src/``.
Imports nothing of JAX or of the JAX package.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for every fp32 matmul and convolution;
2. builds the eight kernel sources from ``src/repro_torch/kernels/csrc``
   (five crossbar kernels, the k-means assignment, flash attention on the
   tensor cores for bf16 and on the CUDA cores for fp32; one nvcc per
   source, all started together; dw, pulse and the fused kernel's update
   blocks share the batch walk of ``outer_product.cuh``, the forward and
   the fused kernel's dx and y blocks the register-tiled walks of
   ``row_product.cuh``, which the error backprop's two walks share) and
   prints the build time and ptxas' register/spill report, and per dw,
   pulse, forward, fused, bwd and k-means instance its registers, spills
   and shared memory (a spill fails the run);
3. kernel phases: hold each CUDA kernel against its plain PyTorch version
   on the card — the forward at every mnist_class and isolet_class
   recognition stage shape (M = 16 and 4096), a ragged shape, a chip-axis
   (4-D) case and the fused activation + 3-bit ADC epilogue; the error
   backprop, weight gradient and pulse update at every training stage
   stack (M = 1, 64 and 4096), a ragged shape (K = 300, N = 26), a
   chip-axis case and the int8 error-code path of bwd and dw; the fused
   training kernel at every training stage stack (M = 1, 64, 4096), the
   ragged zero-padded stacks and int8 codes of the reference's megakernel
   sweep and a chip-axis case, with the forward on, and off with the update
   copied in place — held against its plain version and BIT FOR BIT
   against the four-call sequence (fwd without activation, bwd, pulse on
   the dequantized error) — and time each kernel, its plain version and
   ``torch.bmm`` for the same contraction at M = 4096 beside the bound
   (also by device time, a CUDA graph of 20 calls replayed, for the
   kernel and for ``torch.bmm``, per launch); the dw and pulse
   kernels' bit pins, which tie them and the fused kernel to one summation
   order: (a) dw on int8 codes with a scale equals dw on ``codes.float() *
   scale``, (b) pulse_update equals the plain pulse epilogue applied to the
   dw kernel's product, both bit for bit at every training stage stack (M =
   1, 64, 4096), mnist's four layers and the ragged shapes, and every tile
   of ``OUTER_PRODUCT_TILES`` equal to the picked one (fp32, int8 and
   int32 codes, pulse) on ragged shapes and operands whose addresses are
   not 16-byte aligned; a sweep of every tile's device time at the main
   paths' dw and pulse launches beside the tile the wrapper picks; every
   tile of ``ROW_PRODUCT_TILES`` equal to the picked forward tile, bit for
   bit, at every recognition stage shape (M = 16, 4096), mnist's four
   layers with the activation and 3-bit ADC epilogue (M = 16, 4096; N = 10
   included) and ragged and unaligned operands, and a sweep of every
   forward tile's device time at one mnist wave (M = 4096), one isolet wave
   (M = 256) and mnist's layers beside the pick; every tile of
   ``CROSSBAR_BWD_TILES`` (runs 1 and 3 where N <= 128) equal to the
   picked bwd launch, bit for bit, at every training stage stack (M = 1,
   64, 4096), mnist's four layers (M = 64, 4096; N = 300 and 200 through
   the ring walk), the ragged (3, 37, 300, 26), unaligned operands and a
   chip-axis case, on fp32 errors and int8 and int32 codes (codes equal to
   their values), the fused kernel's dx equal to the bwd launch on the same
   codes, and a sweep of every bwd tile and run's device time at one mnist
   step's stacks (M = 4096), isolet's (M = 256) and mnist's layers on int8
   codes (M = 64, 4096) beside ``torch.bmm`` and the pick; and the k-means
   assignment kernel at the clustering
   path's shape (n = 2048, d = 20, k = 10), n = 60000, k = 26, the
   hardware core's 32 x 32,
   the TPU tile limit 128 x 128 (n = 65536), a ragged n, k = 1 and
   duplicated centers (exact ties go to the lowest index), every tile of
   ``KMEANS_TILES`` equal to the chain-order plain version exactly, timed
   (and every tile by device time) beside its plain version,
   ``torch.cdist(p=1).argmin`` and the bound; both wrappers' host time (CUDA
   events against device time, and a host clock per call); and the flash
   attention kernels at qwen2-0.5b's prefill shape (B=4, S=2048, 14 heads
   on 2, hd 64) in bf16 and fp32, the yi-6b head shape (1, 4096, 32 on 4,
   hd 128), a ragged S = 1000, non-causal 384, MHA, the reference test's
   four shapes, each in both of the reference's functions
   (``semantics="chunked"``, the LM prefill's, and ``"pallas"``) against
   the matching plain version, the bf16 chunked function also against the
   plain version at the kernel's own 64-key tiles, and each bf16
   function's mean distance to its own plain version at most a quarter of
   its distance to the other function's; and strided views (through
   ``ops.flash_attention``, the model's wrapper: fp32 read through their
   strides, bf16 aligned views uncopied, a misaligned one copied and
   counted), timed beside the plain version,
   ``scaled_dot_product_attention`` (never called by the port) and the
   bound (both products, four for the Pallas function in bf16, at the
   bf16 tensor-core rate for bf16 operands, at the fp32 rate for fp32;
   the exponentials' co-bound printed beside), with each instance's
   registers, spills and shared memory; then the flash window phase, both
   sources (bf16 and fp32) with a window and at hd 256: recurrentgemma-9b's
   local layer (B=2, S=4096, 16 heads on 1, hd 256, window 2048), hd 256
   without a window in both functions, a ragged S = 1000 with window 100
   and window 1, under the same bars (the banded plain versions), timed
   beside the plain version, SDPA with a boolean band mask (kv heads
   expanded) and the bound over the band's pairs; and a window of S or
   10^6 bit for bit the causal kernel; the hd-256 instances' registers,
   spills and shared memory; then the flash cross phase, both sources
   non-causal (``ENCDEC_FLASH_CASES``): seamless-m4t-medium's
   bidirectional and cross-attention shape (B=4, 2048 queries on 2048
   keys, 16 heads on 16, hd 64), 512 queries on 1500 keys and 1500 on
   1000 (8 heads on 2), ragged key tiles, each in both functions under
   the same bars, timed beside the plain version, SDPA and the bound;
4. eager recognition path (``compiled=False``): ``build_chip`` for
   mnist_class at full width (784-300-200-100-10, 13 cores) runs
   ``infer_stream`` on 16 samples and on a 4096-sample wave, isolet_class
   (160 cores) one 256-sample wave, with the forward kernel's launch count
   set to 0 before and read after (5 launches per mnist wave, 9 per isolet
   wave).  Outputs are held against the port's plain ``mlp_forward`` and,
   stage by stage, against the plain product on the chip's own stage
   inputs; ``mlp_forward(use_kernel=True)`` against its plain version; the
   counters against ``hw_model`` within 1 % and the beat against Table
   IV's 0.77 us;
5. compiled recognition path (the chip's default): the same three waves,
   each twice (the first call captures the CUDA graph, the second
   replays it), counts at 0 before and read after: 4 forward launches per
   mnist wave, 5 per isolet wave, one capture per (program, shape); each
   replay equals its first run, is held like step 4 and against the eager
   chip's output on the same conductances;
6. eager training path (``compiled=False``): with every count set to 0,
   mnist_class takes 3 ``train_step``s at batch 1 and 2 at batch 4096, and
   isolet_class one at batch 256.  Each stage's backward phase must be one
   bwd launch and its update one pulse launch (4 + 4 per mnist step, 5 + 5
   per isolet step); every stage's dx and new conductances are held
   against the plain versions on the chip's own stage inputs, each whole
   step against the port's plain ``paper_backprop_step`` on the same
   layers and data, and ``compare_hw`` within 1 % on all six keys;
7. compiled training path: the same six steps on compiled chips, the lr
   halved before the third batch-1 step (no new capture), counts at 0
   before and read after: 4 forward + 4 fused launches per mnist step, 5 +
   5 per isolet step, one capture per batch; the envelope's address does
   not move.  Every stage is held against the plain versions on its own
   inputs (read back from the graph's memory after each replay), and each
   step against the eager chip's step from the same conductances;
8. ``crossbar_apply(use_kernel=True)`` path: the gradients of a
   squared-error loss through mnist's four layers at M = 64 and 4096, with
   8-bit error quantization, through ``crossbar_matmul`` (one bwd and one
   dw launch per layer), held layer by layer against the plain
   ``_xbar_matmul`` path on the same inputs;
9. paper-apps path at full width, the k-means launch count set to 0
   before and read after: ``mnist_like(2048)`` through ``pretrain_stack``
   on Table I's mnist_dimred (784-300-200-100-20, PAPER_SPEC, 2 epochs;
   depth not cut), ``encode`` to 20-d features, ``init_plusplus(k=10)`` and
   ``kmeans_fit(epochs=15, use_kernel=True)`` (one launch), one more
   ``assign(use_kernel=True)`` (one launch, equal to the first); the
   kernel's assignment held against the plain ``assign``, inertia never
   rising; then ``kdd_like(4096, 1024)`` through ``pretrain_layer`` on
   kdd_anomaly (41-15-41, 3 epochs) and ``reconstruction_error`` on normal
   and attack traffic, printing detection at 4 % FPR and AUC beside the
   paper's 96.6 %, and each stage's time (CUDA events);
10. LM prefill path, the flash counts set to 0 before and read after:
    ``build_model`` for the full qwen2-0.5b config on ``cuda``, parameters
    from ``init`` with seed 0, ``prefill_fn`` on 4 x 2048 tokens drawn from
    seed 0: exactly 24 flash launches (one per layer), all on the
    tensor-core kernel in ``chunked_attention``'s function, logits (4, 2048,
    152064) finite with the 128 pad columns at -1e30; its time (CUDA
    events), tokens/s and a profile; then the same in float32 compute
    (``compute_dtype="float32"``, the same parameters), its counts set to
    0 before and read after: 24 launches, all on the CUDA-core kernel in
    the chunked function, and its time;
11. LM decode against prefill at full width: ``BatchedServer(batch=4,
    max_len=256)``, its decode step one captured CUDA graph (the warm-up
    call runs it on a side stream and captures it, every later step
    replays it), serves ``launch/serve.py``'s 8-token prompts with
    ``max_new=32`` (39 steps, 128 tokens), its decode logits recorded and
    its flash launches counted (0: the server only decodes, and decode
    attention is plain); ``prefill_fn`` on each slot's prompt + generated
    tokens (a check: its 24 launches are not the path's) must give the same logits at every step within 0.125 in bf16
    and 1e-3 in float32 compute with a float32 cache (its prefill on the
    fp32 kernel, also in the chunked function), and every generated
    token must be the prefill argmax except where its top-2 gap lies within
    that bar (counted); decode ms per step, tokens/s and a profiled step.
    Then, per compute and cache dtype, ``graph_session``: (a) the same
    session on a server decoding eagerly (``server.decode =
    model.decode_fn``) must equal
    the captured one bit for bit — every step's logits (all columns),
    every generated token and the cache after the session; (b) a second
    ``generate`` on the captured server replays without a new capture
    (one capture a server across both calls); (c) ms per step and
    tokens/s by CUDA events, eager beside captured (the captured first
    session, with its warm-up and capture, apart); (d) one replay under
    the profiler (span, device busy time, idle share) and the graph's
    private pool size.  (e) The crossbar kernel mode (``crossbar=True,
    xbar_use_kernel=True``, bf16) serves the same prompts through the
    captured step: 168 ``crossbar_fwd`` launches a replay (7 projections
    x 24 layers; the tied head plain), 39 x 168 in each session and no
    bwd, dw or flash launch, layer 0's 7 warm-up launches held against
    their plain versions within 1e-5 of sum_k |x_k||w_k| and timed at the
    decode shapes, logits finite, and (a)-(d) as above (no decode-vs-
    prefill bar: the activations' fake-quant scale is one per call);
12. faulted chip: ``build_chip("mnist_class", faults=MemristorFaults(
    stuck_on=0.0025, stuck_off=0.01, variation_sigma=0.05, seed=0))``
    (``compiled=True`` asked for): its injected stacks equal the plain
    overlay of the masks and per-core scales on the clean placement, bit
    for bit; one 4096-sample wave (counts at 0 before, read after: 5
    forward launches) held like step 4 on the faulted layers; two
    ``train_step``s at batch 4096 (counts at 0 before, read after: 5
    forward + 4 bwd + 4 pulse launches a step, no capture — the eager
    path), each stage held against the plain versions and each step
    against the plain ``paper_backprop_step`` followed by the plain
    re-application of the stuck masks; every stuck cell exactly 0 or
    w_max after injection and after each step; its step time;
13. farm training: ``build_farm("mnist_class", 4)`` at global batch 4096
    (1024 a chip), two compiled steps (counts at 0 before, read after: 4
    forward + 4 bwd + 4 dw launches a step over every chip's cores, one
    capture) and the same two steps eager from the same conductances
    (counts at 0 before, read after: 5 + 4 + 4 a step); every launch held
    against its plain version on its own operands (the chip axis folded
    into the core stack), its conductances the envelope's own contiguous
    (C, T_s) block; compiled against eager step by step; the first step
    against a serial compiled ``VirtualChip`` step on the same data (the
    error within 1e-6, conductances within 1e-6 but the cells whose
    unrounded pulse count lies within 1e-4 of k + 1/2, counted and
    printed); the replicas bit for bit in lockstep, also after one
    ``reconcile="int8"`` step; ``report()`` within 1 % of ``farm_cost``;
    the compiled, eager and serial steps' times, samples/s and the
    compiled step's idle share;
14. farm serving: ``FarmServer`` on that farm, 256 requests of 16 samples
    (counts at 0 before, read after): the compiled session is one program
    of S - 1 + 64 beats, one forward launch a beat; an eager server on a
    fresh farm holding the same conductances launches 2 a beat; both give
    equal outputs and equal stats (beat 0.77 us within 1 %), held against
    the compiled chip wave of the same conductances and through it against
    ``mlp_forward`` under the 3-bit rule; the session's time (events),
    host time a beat, device samples/s and idle share;
    Step 13 also times the farm step's 4 local dw launches alone (their
    recorded operands, by device time) beside ``torch.bmm``'s, the plain
    version's and the bound;
15. pipeline training: ``build_pipeline("isolet_class")`` at the default
    144-core budget splits into 2 chips, stages (0, 1) and (2, 3, 4) with
    130 + 30 cores (asserted).  Two compiled ``train_step``s at batch 256
    (counts at 0 before, read after: 5 forward + 5 fused launches a step;
    the first step captures 4 programs, each slice's ``chip_forward`` and
    ``chip_backward``, the second none), the same two steps on an eager
    pipeline from the same conductances (9 forward, 5 of them stages and
    4 aggregations, + 5 bwd + 5 pulse a step, no capture); each step bit
    for bit the serial compiled ``VirtualChip`` step on the same data
    (errors and conductances) and compiled bit for bit eager;
    ``report().compare_hw()`` within 1 % of ``pipeline_cost``; then
    mnist_class split 3 ways (1/1/2 stages) takes two compiled steps at
    batch 4096, the second with ``n_micro=2`` (4 + 4 launches a step), bit
    for bit the serial compiled chip.  Its kernels run the serial chip's
    stage shapes (step 7 holds those against plain).  Step times and
    samples/s beside the serial chip's, the compiled step's idle share;
16. pipeline serving: ``PipelineServer`` on that isolet pipeline, 64
    requests of 16 (counts at 0 before, read after): the compiled session
    is one program of S - 1 + 64 beats, one forward launch a beat; an
    eager server on a fresh eager pipeline holding the same conductances
    launches what the owner map gives (per beat, each chip holding a
    request 1, + 1 where its slice aggregates); equal outputs and stats
    (beat 0.77 us within 1 %, latency S beats), held against the compiled
    chip wave of the same conductances and through it against
    ``mlp_forward``; the session's time, host time a beat, samples/s and
    idle share;
17. the farm of pipelines: ``PipelineFarm`` of 2 replicas of mnist_class
    split over 2 chips at 2 x 1024, two compiled steps (counts at 0 before,
    read after: the farm's 4 forward + 4 bwd + 4 dw a step, one capture),
    every launch of the first held against its plain version on the
    envelope's own blocks; replicas bit for bit in lockstep; the first
    step within 1e-6 of the serial compiled chip's, one pulse excused
    within 1e-4 of k + 1/2 (counted); its link bits equal to
    ``pipeline_cost``'s; its step time;
18. the LM training path at qwen2-0.5b's full width (24 layers, d 896,
    vocab 151936, tied head): (a) ``Trainer`` on cuda, bf16 compute,
    remat "full", adamw on the launcher's cosine schedule, ``TokenStream(
    151936, 2048, 4, seed=0)``, 3 steps with a checkpoint at step 2, the
    flash counts at 0 before and read after (48 a step: 24 forward + 24
    recomputed, all wgmma/chunked), loss and grad norm finite (the first
    loss beside ln 151936), then a fresh ``Trainer`` on the same directory
    resumes at step 2 and its step-3 parameters equal the uninterrupted
    run's bit for bit; the step's time (CUDA events), tokens/s, a profile
    with the idle share and one layer's attention backward (plain
    ``flash_attention_vjp``) by CUDA events; (b) the crossbar kernel mode
    (``crossbar=True, xbar_use_kernel=True``) with pulse_sgd at 4 x 1024
    tokens, 2 ``make_train_step`` steps, the counts at 0 before and read
    after (a step: 7 projections x 24 layers x 2 (remat) ``crossbar_fwd``,
    168 ``crossbar_bwd`` and 168 ``crossbar_dw`` on int8 error codes,
    48 flash); layer 0's 21 launches of the first step held against their
    plain versions on their own operands within 1e-5 of sum_k |x_k||w_k|;
    every conductance within [0, 4] after each step; its time, tokens/s,
    the crossbar kernels' share of the device time, and each kernel at
    each LM shape (kernel, plain, ``torch.bmm``, the bound); (c) one
    reduced qwen2-0.5b ``make_train_step`` step in float32 compute on the
    card against the same step on the CPU, standard and kernel mode
    (counts checked: 28 + 14 + 14 crossbar, 8 fp32 flash launches), the
    gradients within 1e-4 of each leaf's largest, a kernel-mode miss
    excused only next to a quantizer code boundary (counted); and the
    flash backward's yardsticks at 4 x 2048 in bf16: its bound (five
    products at the bf16 peak) and SDPA's backward (never called by the
    port);
19. the hybrid family at recurrentgemma-9b's full width (38 layers: 12
    (rec, rec, local) periods and a (rec, rec) suffix, d 4096, hd 256,
    window 2048, 10.4 G fp32 parameters from ``init`` at seed 0, after
    step 18's memory is freed): (a) ``prefill_fn`` on 2 x 4096 tokens in
    bf16, the flash counts at 0 before and read after: 12 launches, one
    per local layer, all wgmma/chunked with the window; logits finite, pad
    columns -1e30; the peak memory, the time of one call (CUDA events),
    tokens/s and a profile with the idle share; (b) ``BatchedServer(
    batch=4)`` serving the CLI's 8-token prompts with ``max_new=16`` (23
    steps, the local layers' rolling buffers of 64 slots), its decode
    logits held against ``prefill_fn`` on the same tokens (12 windowed
    launches, a check): in float32 compute and cache within 1e-3, in bf16
    within the bf16 computation's own noise, max(0.125, max |bf16 prefill
    - float32 prefill|) (at this width one bf16 rounding carried by the
    recurrence can move a logit past 0.125; both distances printed at the
    first position, where decode and prefill compute the same thing);
    tokens the prefill argmax but at near-ties (counted); ms per step and
    a profiled bf16 step; (c) the
    reduced config (2 local layers, window 32, hd 16): 48 decode steps past
    the 32-slot rolling cache against a 48-token prefill (the windowed
    kernel at Sq > window, 2 launches: wgmma in bf16 within 0.125, simt in
    float32 within 1e-3), and in float32 the same run on the CPU, each
    output within 1e-4 of its largest |value|; the step's seconds;
20. the MoE family at full width with the depth cut (moonshot-v1-16b-a3b
    to 18 layers, its dense first layer and 17 moe layers, 10.75 G fp32
    parameters; qwen3-moe-30b-a3b to 16 moe layers, 10.59 G; from
    ``init`` at seed 0, one after the other, after step 19's memory is
    freed), each: (a) ``prefill_fn`` on 4 x 2048 tokens in bf16 at the
    configured capacity (groups of 1024), the flash counts at 0 before and
    read after: one launch per layer, all wgmma/chunked; logits finite,
    pad columns -1e30; each moe layer's share of choices dropped
    (``layers.moe.ROUTING``, read once after the call); the peak memory,
    the time of one call (CUDA events), tokens/s, a profile with the idle
    share, and one moe layer's one-hot dispatch and combine products by
    device time beside its experts' products; (b) ``BatchedServer(
    batch=4)`` serving the CLI's 8-token prompts (``max_new`` 16 for
    moonshot, 8 for qwen3-moe), its decode logits and routing held
    against ``prefill_fn`` on the same tokens (a check), both at the
    no-drop capacity (capacity_factor = E / k): in float32 compute and
    cache within 1e-3 where no routing flip reached, a flip only at a
    near-tie (margin below 1e-6, counted); in bf16 the logits' relative
    distance within twice the reference's own bf16-vs-float32 distance on
    its reduced config (MOE_BF16_DIST, a fixed figure from the CPU: two
    bf16 computations, each that near the float32 result), the flips
    counted; tokens the prefill argmax but at near-ties or where a flip
    reached (counted); ms per step and a profiled bf16 step; (d) the
    reduced config on the card against the CPU: a float32 prefill of 2 x
    64 tokens at the configured capacity (choices drop) and 8 decode
    steps, routing equal but at counted near-ties, each output within 1e-4
    of its largest |value|; and step 18 (c)'s ``make_train_step`` check
    in standard and crossbar kernel mode (the loss, its aux term, every
    gradient leaf; the crossbar and fp32 flash launches counted).  No
    full-width training: adamw's moments would double the parameters;
21. the SSM family at mamba2-130m's full width and full depth (24 ssd
    layers, d 768, 24 heads of 64, N 128, chunk 256, 129,100,224 fp32
    parameters from ``init`` at seed 0, after step 20's memory is freed),
    attention-free: (a) ``prefill_fn`` on 4 x 2048 tokens in bf16 (8
    chunks a layer), the flash and crossbar counts at 0 before and read
    after (all 0); logits finite, pad columns -1e30; the peak memory, the
    time of one call (CUDA events), tokens/s and a profile with the idle
    share and the cuBLAS products beside the rest (the scan's elementwise
    passes); then one 1 x 32768 prefill (128 chunks a layer, the
    reference's prefill_32k length): its time, tokens/s and peak memory;
    (b) ``BatchedServer(batch=4)`` serving the CLI's 8-token prompts with
    ``max_new=16`` (23 steps), its decode logits held against
    ``prefill_fn`` on the same tokens: in float32 compute within 1e-3; in
    bf16 the logits' relative distance within twice the reference's own
    reduced-config bf16-vs-float32 distance (SSM_BF16_DIST, a fixed
    figure from the CPU); tokens the prefill argmax but at near-ties
    (counted); no kernel launch; ms per step and a profiled bf16 step;
    (c) full-width training, ``make_train_step`` at 4 x 2048 tokens, bf16,
    remat "full": 3 adamw steps (losses finite, no kernel launch), then
    crossbar kernel mode (``crossbar=True, xbar_use_kernel=True``) with
    pulse_sgd, 2 steps, the counts at 0 before and read after (a step: 96
    ``crossbar_fwd``, 2 a layer twice under remat, 48 ``crossbar_bwd`` and
    48 ``crossbar_dw``), layer 0's ``in_proj`` and ``out_proj`` launches
    of the first step held against their plain versions within 1e-5 of
    sum_k |x_k||w_k| and re-timed on their operands (kernel, plain,
    ``torch.bmm``, the bound), conductances in [0, 4]; each run's step
    ms, tokens/s, peak memory and idle share; (d) the reduced config on
    the card against the CPU: a float32 prefill of 2 x 64 tokens (2
    chunks of 32) and 8 decode steps, each output within 1e-4 of its
    largest |value|, and step 18 (c)'s ``make_train_step`` check in
    standard and kernel mode, the crossbar launches counted;
22. the encoder-decoder family at seamless-m4t-medium's full width and
    full depth (12 encoder and 12 decoder layers, d 1024, 16 heads of
    64, relu MLP of 4096, layernorm, 878,309,376 fp32 parameters from
    ``init`` at seed 0, after step 21's memory is freed): (a)
    ``prefill_fn`` on 4 x 2048 target tokens over 2048 source frames
    (uniform, seeded) in bf16, the counts at 0 before and read after: 36
    flash launches, all wgmma/chunked, their (causal, Sq, Skv) in the
    order ``encdec_flash_calls`` gives (12 bidirectional, then 12 causal
    and 12 cross interleaved; recorded by ``FlashRecorder``, which adds
    no count), no crossbar launch; logits finite, pad columns -1e30; the
    peak memory, the time of one more call (CUDA events), tokens/s and a
    profile with the idle share and the flash kernels' share; (b)
    ``BatchedServer(batch=4)`` with its cross cache filled by ``encode``
    and ``fill_cross_cache`` from the same frames, serving the CLI's
    8-token prompts with ``max_new=16`` (23 steps, no flash launch), its
    decode logits held against ``prefill_fn`` on the same frames and
    tokens: in float32 compute with float32 self and cross caches within
    1e-3; in bf16 the logits' relative distance within twice
    ENCDEC_BF16_DIST (the reference's reduced-config bf16-vs-float32
    distance, a fixed figure from the CPU); tokens the prefill argmax
    but at near-ties (counted); ms per step and a profiled bf16 step;
    (c) training, ``make_train_step`` at 4 x 2048 (frames and tokens),
    bf16, remat "full": 3 adamw steps (losses finite, 72 flash launches
    a step: the forward's 36 and their recomputation), then crossbar
    kernel mode with pulse_sgd, 2 steps (a step: 192 projections a
    forward, 6 an encoder layer and 10 a decoder layer, twice under
    remat: 384 ``crossbar_fwd``, 192 ``crossbar_bwd`` and 192
    ``crossbar_dw``), encoder layer 0's 6 launches of the first step
    held against their plain versions within 1e-5 of sum_k |x_k||w_k|
    and re-timed on their operands (kernel, plain, ``torch.bmm``, the
    bound), conductances in [0, 4]; each run's step ms, tokens/s, peak
    memory and idle share; (d) the reduced config on the card against
    the CPU: a float32 prefill of 2 x 64 target tokens on 96 frames (6
    simt launches, the cross-attention at Sq != Skv) and 8 decode steps
    over float32 caches, each output within 1e-4 of its largest |value|,
    and step 18 (c)'s ``make_train_step`` check in standard and kernel
    mode (a kernel-mode miss held within twice the CPU's own spread,
    ``cpu_spread``);
23. the VLM family at qwen2-vl-72b's full width with the depth cut (d
    8192, 64 heads on 8 of 128, M-RoPE sections (16, 24, 24), MLP of
    29568, vocab 152064, 256 stub patches; parameters from ``init`` at
    seed 0, after step 22's memory is freed): (a) at 8 layers
    (9,580,011,520 fp32 parameters; 80 do not fit one card)
    ``prefill_fn`` on 2 x 2048 tokens with 256 patch embeddings (uniform,
    seeded) merged by the patch merger, bf16, the counts at 0 before and
    read after: 8 flash launches, all wgmma/chunked, no crossbar launch;
    logits finite; the same call without the patches finite and apart at
    every patch position; the peak memory, the time of one more call
    (CUDA events), tokens/s and a profile with the idle share and the
    flash kernels' share; (b) ``BatchedServer(batch=4)`` serving the
    CLI's 8-token prompts with ``max_new=16`` (23 steps, text only, M-RoPE
    at text positions), its decode logits held against ``prefill_fn`` on
    the same tokens: in float32 compute and cache within 1e-3; in bf16
    the logits' relative distance within twice VLM_BF16_DIST (the
    reference's reduced-config bf16-vs-float32 distance, a fixed figure
    from the CPU); tokens the prefill argmax but at near-ties (counted);
    no flash launch; ms per step and a profiled bf16 step; (c) training at
    full width and 1 layer (3,436,218,368 parameters: adamw's fp32
    master, gradient and two moments, 16 bytes each, are 55 GB),
    ``make_train_step`` at 2 x 2048 tokens with the patches, bf16, remat
    "full", no profile: 3 adamw steps (losses finite, 2 flash launches a
    step), then crossbar kernel mode with pulse_sgd, 2 steps (a step: 14
    ``crossbar_fwd``, 7 projections twice under remat, 7 ``crossbar_bwd``
    and 7 ``crossbar_dw`` at (M, K, N) of (4096, 8192, 8192), (4096,
    8192, 1024), (4096, 8192, 29568) and (4096, 29568, 8192); the head,
    the embedding and the patch merger stay plain), layer 0's launches of
    the first step held against their plain versions within 1e-5 of
    sum_k |x_k||w_k| and re-timed on their operands (kernel, plain,
    ``torch.bmm``, the bound), conductances in [0, 4]; each run's step
    ms, tokens/s and peak memory; (d) the reduced config on the card
    against the CPU: a float32 prefill of 2 x 64 tokens with 8 patches
    merged and 8 decode steps, each output within 1e-4 of its largest
    |value|, and step 18 (c)'s ``make_train_step`` check with the
    config's ``grad_accum`` of 4 and the patches, in standard and kernel
    mode (a kernel-mode miss held within twice the CPU's own spread);
    the flash vlm phase, run among the flash phases, holds both sources
    at qwen2-vl's prefill shape (2 x 2048, 64 on 8, hd 128, causal) and
    times them beside SDPA and the bound;
24. ``dist/`` on one card at qwen2-0.5b's full width (494,147,456 fp32
    parameters from ``init`` at seed 0, after step 23's memory is freed;
    ``TokenStream(151936, 2048, 4, seed=0)``, bf16 compute, remat
    "full"): (a) ``dp_train_step_fn`` on ``make_host_mesh()`` (one
    shard), compression "none", 2 adamw steps at 4 x 2048 on the
    launcher's schedule, its parameters, adamw state and losses equal to
    ``make_train_step``'s bit for bit (48 flash launches a step each);
    (b) compression "int8" on ``make_host_mesh(shape=(4, 1))`` folded onto
    the card, ``adamw(3e-3)``, 4 steps of four 1 x 2048 shards (192 flash
    launches a step), the last loss below the first (the statement of the
    reference's ``test_dp_train_step_with_compression_decreases_loss``);
    each step's ms and tokens/s beside (a)'s, the compression's ms by
    CUDA events, a profile of each with the idle share; (c)
    ``pipeline_apply`` over a 4-stage ("pipe",) mesh, a stage 6 decoder
    layers in bf16 run one (1, 2048, 896) microbatch at a time, 8
    microbatches of embedded tokens: (8 + 4 - 1) x 24 = 264 flash
    launches, against 192 for ``serial_reference``, whose result it
    equals bit for bit; both timed (CUDA events), the pipeline profiled;
    (d) ``Trainer(mesh=make_host_mesh())`` 2 steps equal to ``Trainer()``'s
    bit for bit (parameters, adamw state, losses), its checkpoint at step
    2 restored by a fresh meshed Trainer onto the shardings (every leaf on
    the card) and its step 3 equal to the uninterrupted run's bit for
    bit; (e) ``python -m repro_torch.launch.train --arch qwen2-0.5b
    --reduced --mesh host`` runs 4 steps on the card;
25. the analysis tools and the autotuner, after step 24's memory is
    freed: (a) at three shapes (``AUTOTUNE_SHAPES``: an eager mnist
    wave's first stage, the farm step's stacked first stage over 4 chips
    (``fold=4``), qwen2-0.5b's (4096, 896, 4864) projection on int8
    codes) the wrappers run with ``autotune=True``, which times every
    candidate tile of the forward, bwd, dw, pulse and fused kernel (N <=
    128) by CUDA events into a temporary ``REPRO_TORCH_AUTOTUNE_TABLE``;
    the tuned tile's outputs equal the decision-list tile's bit for bit,
    both are timed; the table, reloaded, gives the same picks without a
    timing pass; (b) ``launch/dryrun``'s trace of qwen2-0.5b's prefill
    and adamw step at 4 x 2048 bf16 on ``make_host_mesh(device="cuda")``
    against the same cells run on the card: the predicted
    ``memory.argument`` equals the bytes of the parameters, adamw state
    and batch the run holds (plus the step scalar), the measured time is
    at least ``t_bound``, the traced FLOPs at least
    ``model_flops_estimate``, and ``dryrun.HBM_PER_CHIP`` is the card's
    ``total_memory``; the predicted per-device bytes are printed beside
    ``torch.cuda.max_memory_allocated()``;
    Steps 19-23 (b) serve through the captured server as step 11 does,
    their decode-vs-prefill bars unchanged, and run ``graph_session``
    ((a)-(d) of step 11) per compute and cache dtype; in the encoder-
    decoder the cross cache is set on each server after it is built, and
    after the profiled replay set again with halved values: the next
    step captures again (2 captures) and it and the replay after it equal
    eager decode on a copy of the cache bit for bit; in the MoE family every step's routing is held too (a
    replay appends clones of the records its capture made: one
    ``Routing`` a moe layer a step);
26. the training steps as captured CUDA graphs, after step 25's memory
    is freed (``Trainer``'s ``TrainStep`` and ``make_paper_train_step``'s
    ``PaperTrainStep``): (a) for each of ``GRAPH_CASES`` (qwen2-0.5b at
    full width, 4 x 2048, bf16, adamw, remat "full"; its crossbar kernel
    mode with pulse_sgd at 4 x 1024; qwen3-moe-30b-a3b at full width cut
    to 1 layer, 2 x 1024, routing under capture; mamba2-130m whole, 4 x
    2048) a captured and an eager ``Trainer`` from seed 0 (the eager one's
    ``train_step = step.fn``) take 3 steps of the launcher's optimizer on
    the same batches, and after each their parameters, optimizer state
    and metrics are equal bit for bit; one capture, and the captured
    steps launch the port's kernels as often as the eager ones (counts
    at 0 before, read after); pulse_sgd's stochastic rounding from a CUDA
    generator registered with the graph equals the eager draws over 3
    steps (reduced qwen2-0.5b, crossbar mode), or, where the card's torch
    cannot register a generator, a ``TrainStep`` refuses one; (b)
    mamba2-130m's captured run saved at step 2, restored by a fresh
    ``Trainer``, which captures again and whose step 3 equals the eager
    run's bit for bit; (c) the paper's scan step (``PAPER_SPEC``,
    ``use_kernel=True``, four 512 x 512 layers at batch 256) captured
    against ``paper_backprop_step_scan`` run eagerly, 5 steps, stacks and
    errors bit for bit, one capture, 4 fwd + 4 bwd + 4 pulse_update a
    step in each; (d) each case's captured and eager step ms by CUDA
    events (2 steps each), tokens/s (samples/s), one profiled replay's
    idle share and the graph's pool, beside the card and its limit;
27. prints the wave and training-step times (CUDA events), compiled beside
    eager, ``torch.profiler`` breakdowns of the waves and steps with the
    device's idle share, the kernels of one profiled replay (the port's
    kernels and only those; where the profiler records no device
    activity, the idle shares are not measured and the replay is checked
    by the counts its capture recorded) — all taken before steps 18-26
    run, which come last of the paths, so that their large allocations
    and long profiles disturb nothing else —, one ``{"kernels": [...]}``
    line with eight entries (the fp32 flash kernel as
    ``flash_attention_simt``; the crossbar kernels' ``launches`` include
    steps 11 (e), 12-18, 20-23 and 26, broken down in
    ``launches_decode``
    (``crossbar_fwd``, with ``decode_launches_per_replay``,
    ``decode_layer0_rel_err`` and ``decode_shapes``),
    ``launches_faults_and_farm``,
    ``launches_pipeline``, ``launches_lm_train``, ``launches_moe``,
    ``launches_ssm``, ``launches_encdec``, ``launches_vlm`` and
    ``launches_train_graphs``, with
    mamba2's, seamless's and qwen2-vl's projection shapes in
    ``ssm_shapes``, ``encdec_shapes`` and ``vlm_shapes``; the flash
    kernels' steps 18-24 in ``launches_lm_train``, ``launches_hybrid``,
    ``launches_moe``, ``launches_ssm`` (0), ``launches_encdec``,
    ``launches_vlm``, ``launches_dist`` and ``launches_train_graphs``
    (step 26), with the local layer's, hd 256's, seamless's
    non-causal and qwen2-vl's prefill timings, the cross phase's rows and
    the backward's yardsticks beside; ``crossbar_dw`` carries
    ``farm_step_local_dw``; the crossbar kernels carry step 25's
    ``autotune`` picks and times), the run's seconds, and last
    ``{"ok": true, "device": {...}}``.

Tolerances: fp32 values agree within 1e-5 absolute plus 1e-5 relative (the
repo's kernel bar; the two sides sum in different orders).  Quantized
activations are compared as 3-bit codes; a code may differ only where the
value before the ADC lies within 1e-6 of a half-step boundary — and then
only the samples downstream of such a flip may differ end to end.  Pulse
counts may differ by one only where the plain unrounded count lies within
1e-4 of a half-integer; there a conductance may differ by one half pulse
(u/2 = 1.95e-4), everywhere else by at most 1e-6.  The fused kernel and
the four-call sequence must agree exactly, as must every bwd tile and
run with the picked one.  k-means assignments equal the chain-order plain
version exactly, and the plain version except where the two smallest
distances of a sample (recomputed in float64) lie within 1e-5 relative of
each other.  Flash attention in
fp32 within 2e-5 absolute plus relative (the reference's kernel bar); in
bf16, the Pallas function within one bf16 step of the plain result (the
spacing of bf16 at the larger magnitude, plus 1e-6: both sides round an
fp32 value once), the chunked function within one bf16 step plus 2^-8 of
the plain side's sum_j p_j |v_j| / l against the plain version at the
reference's 512-key chunks (``check_flash``), and within one bf16 step
plus 2^-7 max_j p_j |v_j| / l against the plain version at the kernel's
64-key tiles (``check_chunked_tile`` derives both).  Any failure raises.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402

ATOL = 1e-5              # fp32 agreement, kernel vs plain (summation order)
BOUNDARY = 1e-6          # ADC code flips allowed only this close to a boundary
PULSE_BOUNDARY = 1e-4    # pulse-count flips allowed only this close to k + 1/2
G_ATOL = 1e-6            # conductances away from a pulse boundary
ADC_BITS, ADC_RANGE = 3, 0.5
MAX_DW, LEVELS, W_MAX = 0.05, 128, 1.0   # PAPER_SPEC's pulse rule
LR = 0.1                 # the CLI's default learning rate
FP32_FLOPS = 67e12       # H100 SXM fp32 peak outside the tensor cores
BF16_FLOPS = 989e12      # H100 SXM bf16 tensor-core peak (dense)
EXP_RATE = 3.9e12        # H100 SXM special-function (exp) rate, per second
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3 bandwidth
SEED = 0

# Stage shapes (T cores, K fan-in lines, N columns) of one recognition wave,
# one entry per launch, in launch order (core/mapping.map_network, 400x100).
WAVE_SHAPES = {
    "mnist_class": [(6, 400, 100), (3, 200, 100), (2, 400, 100),
                    (1, 400, 100), (1, 400, 100)],
    "isolet_class": [(40, 400, 100), (20, 200, 100), (60, 400, 100),
                     (10, 600, 100), (15, 400, 100), (5, 300, 100),
                     (6, 400, 100), (3, 200, 100), (1, 400, 100)],
}
# Stage stacks (T, K, N) of one training step, in layer order: each is one
# bwd and one pulse launch (the aggregation cores take no part).
TRAIN_SHAPES = {
    "mnist_class": [(6, 400, 100), (2, 400, 100), (1, 400, 100),
                    (1, 400, 100)],
    "isolet_class": [(40, 400, 100), (60, 400, 100), (15, 400, 100),
                     (6, 400, 100), (1, 400, 100)],
}
# (K, N) of mnist's four layers: crossbar_apply(use_kernel=True) shapes
MNIST_LAYERS = [(784, 300), (300, 200), (200, 100), (100, 10)]
KERNELS = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
           "crossbar_train", "kmeans_assign", "flash_attention",
           "flash_attention_tc")
# (chip, batch, lr) of the training main path, in order
STEPS = ([("mnist_class", 1, LR)] * 2 + [("mnist_class", 1, LR / 2)]
         + [("mnist_class", 4096, LR)] * 2 + [("isolet_class", 256, LR)])


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def uniform(shape, lo, hi, gen) -> torch.Tensor:
    """Uniform [lo, hi) fp32 on the card, drawn from the CUDA generator."""
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: one CUDA graph of ``calls`` calls,
    replayed ``reps`` times between two events after a warm-up, so the
    host's cost of a call (checks, allocation, launch) is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def bound(T, M, K, N, kernel: str = "crossbar_fwd",
          dy_bytes: int = 4, in_bytes: int = 4) -> tuple[float, float]:
    """(ms at the fp32 rate, ms at the HBM rate) for one launch: each input
    byte read once and each output byte written once.  ``dy_bytes`` is the
    size of one error element (1 for int8 codes); ``in_bytes`` that of one
    x and g± element as the forward's wrapper receives them (2 for bf16
    operands, which the wrapper widens to fp32 before the launch)."""
    if kernel == "crossbar_fwd":
        flops = 2.0 * T * M * K * N + T * K * N    # products + delta
        nbytes = T * (M * K * in_bytes + M * N * 4 + 2 * K * N * in_bytes)
    elif kernel == "crossbar_bwd":
        flops = 2.0 * T * M * K * N + T * K * N
        nbytes = T * (M * K * 4 + M * N * dy_bytes + 2 * K * N * 4)
    elif kernel == "crossbar_dw":
        flops = 2.0 * T * M * K * N
        nbytes = T * (M * K * 4 + M * N * dy_bytes + K * N * 4)
    elif kernel == "crossbar_train":   # dx + dw products, delta, epilogue
        flops = 4.0 * T * M * K * N + 11.0 * T * K * N
        nbytes = T * (2 * M * K * 4 + M * N * dy_bytes + 4 * K * N * 4)
    else:   # pulse_update: product + a 10-operation epilogue per cell
        flops = 2.0 * T * M * K * N + 10.0 * T * K * N
        nbytes = 4.0 * T * (M * K + M * N + 4 * K * N)
    return flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3


def close(got: torch.Tensor, want: torch.Tensor, what) -> float:
    """Raise unless |got - want| <= ATOL + ATOL |want| everywhere; returns
    the largest absolute difference."""
    err = (got - want).abs()
    if not bool((err <= ATOL + ATOL * want.abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def near_half(counts: torch.Tensor) -> torch.Tensor:
    """Cells whose unrounded pulse count lies within PULSE_BOUNDARY of a
    half-integer, where a last-bit difference rounds the other way."""
    return (counts - torch.floor(counts) - 0.5).abs() < PULSE_BOUNDARY


def check_conductances(got, want, counts, what) -> int:
    """Hold new conductances (g+, g-) against the plain ones: within G_ATOL,
    except cells next to a pulse boundary of the plain unrounded ``counts``,
    which may differ by one half pulse.  Returns the cells that differ."""
    near = near_half(counts)
    half_u = 0.5 * MAX_DW / LEVELS
    flipped = torch.zeros_like(near)
    for g, w in zip(got, want):
        d = (g - w).abs()
        if bool((d[~near] > G_ATOL).any()) or \
                bool((d[near] > half_u + G_ATOL).any()):
            raise AssertionError(
                f"{what}: conductances differ by {float(d.max())} "
                f"({int((d > G_ATOL).sum())} cells, "
                f"{int(((d > G_ATOL) & ~near).sum())} off a pulse boundary)")
        flipped |= d > G_ATOL
    return int(flipped.sum())


def check_pulse_counts(gp, gm, got, want, counts, what) -> int:
    """Pulse counts as integers, read back from unclipped conductances:
    equal, or one apart where the plain count is next to a half-integer.
    Returns the number of flipped counts."""
    half_u = 0.5 * MAX_DW / LEVELS
    near = near_half(counts)
    n_flip = 0
    for g, new, ref in ((gp, got[0], want[0]), (gm, got[1], want[1])):
        kc = torch.round((new - g) / half_u)
        pc = torch.round((ref - g) / half_u)
        diff = (kc - pc).abs()
        if bool((diff > 1).any()) or bool(((diff > 0) & ~near).any()):
            raise AssertionError(f"{what}: {int((diff > 0).sum())} pulse "
                                 f"counts differ, max by {float(diff.max())}")
        n_flip += int((diff > 0).sum())
    check_conductances(got, want, counts, what)
    return n_flip


def code_flips(pre: torch.Tensor, got: torch.Tensor,
               want: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample flags of 3-bit ADC codes of ``got`` that differ from the
    codes of the reference value ``pre`` (taken before the ADC), or from
    ``want``, the reference's own ADC output, where given (at a half-step
    the ADC may round ``pre`` other than this function would).  Raises if
    a code differs where ``pre`` is not within BOUNDARY of a half-step
    boundary."""
    scale = 2.0 * ADC_RANGE / (2 ** ADC_BITS - 1)
    u = (pre.clamp(-ADC_RANGE, ADC_RANGE) + ADC_RANGE) / scale
    flip = (torch.round(u) != torch.round((got + ADC_RANGE) / scale)
            if want is None else want != got)
    dist = (u - torch.floor(u) - 0.5).abs() * scale
    bad = flip & (dist > BOUNDARY)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ADC codes differ away from "
                             f"a rounding boundary")
    return flip.reshape(-1, flip.shape[-1]).any(dim=-1)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(xbk, ops, gen) -> tuple[float, list[dict]]:
    """Kernel vs plain version on the card; returns (max |err|, timing rows
    at the M = 4096 wave shapes)."""
    cases = []
    for app, shapes in WAVE_SHAPES.items():
        for M in (16, 4096):
            cases += [dict(app=app, shape=(T, M, K, N))
                      for T, K, N in dict.fromkeys(shapes)]
    cases += [dict(app="ragged", shape=(5, 3, 37, 11)),
              dict(app="chip-axis", shape=(3, 7, 45, 13), chips=2),
              dict(app="epilogue", shape=(6, 16, 400, 100), activation=True,
                   adc_bits=ADC_BITS),
              dict(app="epilogue", shape=(1, 4096, 784, 300),
                   activation=True, adc_bits=ADC_BITS)]
    max_err, rows, flips = 0.0, [], 0
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        act, bits = case.get("activation", False), case.get("adc_bits")
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        gp = uniform(lead + (T, K, N), 0.0, 0.02, gen)
        gm = uniform(lead + (T, K, N), 0.0, 0.02, gen)
        if lead:
            y = ops.crossbar_fwd_stacked(xs, gp, gm, activation=act,
                                         adc_bits=bits)
            y, xs, gp, gm = (a.reshape((-1,) + a.shape[2:])
                             for a in (y, xs, gp, gm))
        else:
            y = xbk.crossbar_fwd_kernel(xs, gp, gm, activation=act,
                                        adc_bits=bits)
        ref = xbk.crossbar_fwd_plain(xs, gp, gm, activation=act,
                                     adc_bits=bits)
        torch.cuda.synchronize()
        keep = torch.ones_like(y, dtype=torch.bool)
        if bits is not None:
            pre = xbk.crossbar_fwd_plain(xs, gp, gm, activation=act)
            scale = 2.0 * ADC_RANGE / (2 ** bits - 1)
            code_flips(pre, y)
            keep = (torch.round((y + ADC_RANGE) / scale)
                    == torch.round((ref + ADC_RANGE) / scale))
            flips += int((~keep).sum())
        err = float((y - ref).abs()[keep].max())
        if not err <= ATOL:
            raise AssertionError(f"kernel vs plain {case}: max |err| {err}")
        max_err = max(max_err, err)
        if M == 4096 and case["app"] in WAVE_SHAPES:
            rows.append(time_shape(xbk, case["app"], xs, gp, gm))
    print(f"kernel phase: {len(cases)} cases, max |kernel - plain| "
          f"{max_err:.3e} (atol {ATOL}), {flips} ADC code flips at "
          f"boundaries")
    return max_err, rows


def time_shape(xbk, app, xs, gp, gm, iters: int = 20,
               device: bool = True, in_bytes: int = 4) -> dict:
    """``time_row`` of the forward on ``xs``, ``gp``, ``gm`` (fp32, as the
    launch gets them); ``in_bytes`` as in ``bound``, recorded in the row."""
    T, M, K = xs.shape
    N = gp.shape[2]
    return with_device_ms(time_row("crossbar_fwd", T, M, K, N, {
        "ms": lambda: xbk.crossbar_fwd_kernel(xs, gp, gm, activation=False),
        "plain_ms": lambda: xbk.crossbar_fwd_plain(xs, gp, gm,
                                                   activation=False),
        "library_ms": lambda: torch.bmm(xs, gp - gm),
    }, iters=iters, in_bytes=in_bytes, app=app), lambda: xbk.crossbar_fwd_kernel(
        xs, gp, gm, activation=False),
        lambda: torch.bmm(xs, gp - gm), xbk.row_product_tile(T, M, K, N),
        device)


def train_kernel_cases() -> list[dict]:
    """Training-kernel cases: every stage stack at M = 1, 64, 4096; a
    ragged shape; a chip axis; the int8 error-code path."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [dict(shape=(T, M, K, N)) for T, K, N in stacks
             for M in (1, 64, 4096)]
    cases += [dict(shape=(3, 37, 300, 26)),
              dict(shape=(3, 7, 45, 13), chips=2),
              dict(shape=(6, 4096, 400, 100), codes=True),
              dict(shape=(3, 37, 300, 26), codes=True),
              dict(shape=(3, 7, 45, 13), chips=2, codes=True)]
    return cases


def train_kernel_phase(xbk, ops, gen) -> tuple[dict, list[dict]]:
    """bwd, dw and pulse kernels vs their plain versions on the card;
    returns ({kernel: max |err|}, timing rows at M = 4096)."""
    max_err = {k: 0.0 for k in ("crossbar_bwd", "crossbar_dw",
                                "pulse_update")}
    rows, flips = [], 0
    cases = train_kernel_cases()
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        ds = uniform(lead + (T, M, N), -0.05, 0.05, gen)
        # mid-range conductances: no pulse clips, so counts read back
        gp = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        gm = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        scale = None
        dys = ds
        if case.get("codes"):
            dys = torch.randint(-127, 128, lead + (T, M, N), generator=gen,
                                dtype=torch.int8, device="cuda")
            scale = torch.tensor(0.05 / 127, device="cuda")
        lr = 0.25 / M ** 0.5         # spreads counts over several levels
        rule = dict(lr=lr, max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
        if lead:   # through the stacked wrappers' chip-axis fold
            dx = ops.crossbar_bwd_stacked(dys, gp, gm, dy_scale=scale)
            dw = ops.crossbar_dw_stacked(xs, dys, dy_scale=scale)
            new = ops.pulse_update_stacked(gp, gm, xs, ds, **rule)
            dx, dw, dys, xs, ds, gp, gm = (
                a.reshape((-1,) + a.shape[2:])
                for a in (dx, dw, dys, xs, ds, gp, gm))
            new = tuple(a.reshape((-1,) + a.shape[2:]) for a in new)
        else:
            dx = xbk.crossbar_bwd_kernel(dys, gp, gm, dy_scale=scale)
            dw = xbk.crossbar_dw_kernel(xs, dys, dy_scale=scale)
            new = xbk.pulse_update_kernel(gp, gm, xs, ds, **rule)
        torch.cuda.synchronize()
        what = f"{case} lr={lr:.4g}"
        max_err["crossbar_bwd"] = max(max_err["crossbar_bwd"], close(
            dx, xbk.crossbar_bwd_plain(dys, gp, gm, dy_scale=scale),
            f"bwd {what}"))
        max_err["crossbar_dw"] = max(max_err["crossbar_dw"], close(
            dw, xbk.crossbar_dw_plain(xs, dys, dy_scale=scale),
            f"dw {what}"))
        want = xbk.pulse_update_plain(gp, gm, xs, ds, **rule)
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        flips += check_pulse_counts(gp, gm, new, want, counts,
                                    f"pulse {what}")
        max_err["pulse_update"] = max(max_err["pulse_update"], max(
            float((a - b).abs().max()) for a, b in zip(new, want)))
        if M == 4096 and not lead and not case.get("codes"):
            rows += time_train_shape(xbk, xs, ds, gp, gm, rule)
    for K, N in MNIST_LAYERS:   # crossbar_apply's shapes, int8 codes
        xs = uniform((1, 4096, K), -0.5, 0.5, gen)
        codes = torch.randint(-127, 128, (1, 4096, N), generator=gen,
                              dtype=torch.int8, device="cuda")
        scale = torch.tensor(0.05 / 127, device="cuda")
        gp = uniform((1, K, N), 0.3, 0.7, gen)
        gm = uniform((1, K, N), 0.3, 0.7, gen)
        close(xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
              xbk.crossbar_dw_plain(xs, codes, dy_scale=scale),
              f"dw codes (1, 4096, {K}, {N})")
        max_err["crossbar_bwd"] = max(max_err["crossbar_bwd"], close(
            xbk.crossbar_bwd_kernel(codes, gp, gm, dy_scale=scale),
            xbk.crossbar_bwd_plain(codes, gp, gm, dy_scale=scale),
            f"bwd codes (1, 4096, {K}, {N})"))
        rows.append(time_dw_codes(xbk, xs, codes, scale))
        rows.append(time_bwd_codes(xbk, codes, scale, gp, gm))
    print(f"train kernel phase: {len(cases) + len(MNIST_LAYERS)} cases, max "
          f"|kernel - plain| " + json.dumps(max_err) + f" (atol {ATOL} + "
          f"rtol {ATOL}; pulse: conductances), {flips} pulse counts one "
          f"apart at a half-integer (within {PULSE_BOUNDARY})")
    return max_err, rows


def time_row(kernel, T, M, K, N, fns, dy_bytes=4, iters: int = 20,
             in_bytes: int = 4, **extra) -> dict:
    """CUDA-event times of ``fns`` (name -> callable) over ``iters`` calls
    beside the bound."""
    flop_ms, byte_ms = bound(T, M, K, N, kernel, dy_bytes, in_bytes)
    row = {"kernel": kernel, "T": T, "M": M, "K": K, "N": N, **extra}
    if in_bytes != 4:
        row["in_bytes"] = in_bytes
    row.update({k: cuda_ms(f, iters=iters, warmup=min(3, iters))
                for k, f in fns.items()})
    row.update(bound_ms=max(flop_ms, byte_ms),
               bound_by="operations" if flop_ms >= byte_ms else "bytes")
    return row


def time_train_shape(xbk, xs, ds, gp, gm, rule) -> list[dict]:
    """Kernel / plain / ``torch.bmm`` times of bwd, dw and pulse on one
    stage stack (pulse's bmm is its product alone, without the epilogue)."""
    T, M, K = xs.shape
    N = ds.shape[2]
    xt = xs.transpose(1, 2)
    return [
        with_device_ms(time_row("crossbar_bwd", T, M, K, N, {
            "ms": lambda: xbk.crossbar_bwd_kernel(ds, gp, gm),
            "plain_ms": lambda: xbk.crossbar_bwd_plain(ds, gp, gm),
            "library_ms": lambda: torch.bmm(ds, (gp - gm).transpose(1, 2)),
        }), lambda: xbk.crossbar_bwd_kernel(ds, gp, gm),
            lambda: torch.bmm(ds, (gp - gm).transpose(1, 2)),
            "/".join(map(str, xbk._pick_bwd(None, None, T, M, K, N, 4)))),
        with_device_ms(time_row("crossbar_dw", T, M, K, N, {
            "ms": lambda: xbk.crossbar_dw_kernel(xs, ds),
            "plain_ms": lambda: xbk.crossbar_dw_plain(xs, ds),
            "library_ms": lambda: torch.bmm(xt, ds),
        }), lambda: xbk.crossbar_dw_kernel(xs, ds),
            lambda: torch.bmm(xt, ds), xbk.outer_product_tile(T, M, K, N, 4)),
        with_device_ms(time_row("pulse_update", T, M, K, N, {
            "ms": lambda: xbk.pulse_update_kernel(gp, gm, xs, ds, **rule),
            "plain_ms": lambda: xbk.pulse_update_plain(gp, gm, xs, ds,
                                                       **rule),
            "library_ms": lambda: torch.bmm(xt, ds),
        }, library="bmm without the pulse epilogue"),
            lambda: xbk.pulse_update_kernel(gp, gm, xs, ds, **rule),
            lambda: torch.bmm(xt, ds), xbk.outer_product_tile(T, M, K, N, 4)),
    ]


def with_device_ms(row: dict, kernel, library, tile,
                   device: bool = True) -> dict:
    """Add the kernel's and the library call's device times (``graph_ms``;
    None unless ``device``) and the tile the wrapper picked (bwd:
    "tile/run") to a row."""
    row.update(ms_device=graph_ms(kernel) if device else None,
               library_ms_device=graph_ms(library) if device else None)
    if tile is not None:
        row["tile"] = tile
    return row


def time_dw_codes(xbk, xs, codes, scale, iters: int = 20,
                  device: bool = True) -> dict:
    T, M, K = xs.shape
    N = codes.shape[2]
    dys = codes.float() * scale
    return with_device_ms(time_row("crossbar_dw", T, M, K, N, {
        "ms": lambda: xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
        "plain_ms": lambda: xbk.crossbar_dw_plain(xs, codes,
                                                  dy_scale=scale),
        "library_ms": lambda: torch.bmm(xs.transpose(1, 2), dys),
    }, dy_bytes=1, iters=iters, codes="int8"),
        lambda: xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
        lambda: torch.bmm(xs.transpose(1, 2), dys),
        xbk.outer_product_tile(T, M, K, N, 1), device)


def time_bwd_codes(xbk, codes, scale, gp, gm, iters: int = 20,
                   device: bool = True) -> dict:
    T, M, N = codes.shape
    K = gp.shape[1]
    dys = codes.float() * scale
    return with_device_ms(time_row("crossbar_bwd", T, M, K, N, {
        "ms": lambda: xbk.crossbar_bwd_kernel(codes, gp, gm, dy_scale=scale),
        "plain_ms": lambda: xbk.crossbar_bwd_plain(codes, gp, gm,
                                                   dy_scale=scale),
        "library_ms": lambda: torch.bmm(dys, (gp - gm).transpose(1, 2)),
    }, dy_bytes=1, iters=iters, codes="int8"),
        lambda: xbk.crossbar_bwd_kernel(codes, gp, gm, dy_scale=scale),
        lambda: torch.bmm(dys, (gp - gm).transpose(1, 2)),
        "/".join(map(str, xbk._pick_bwd(None, None, T, M, K, N, 1))),
        device)


def outer_product_cases() -> list[tuple[int, int, int, int]]:
    """(T, M, K, N) of the bit pins: every training stage stack at M = 1, 64
    and 4096, crossbar_apply's mnist layers at M = 4096, and the train
    phase's ragged shapes (its chip-axis case folded: 2 x 3 cores)."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [(T, M, K, N) for T, K, N in stacks for M in (1, 64, 4096)]
    cases += [(1, 4096, K, N) for K, N in MNIST_LAYERS]
    return cases + [(3, 37, 300, 26), (6, 7, 45, 13)]


def offset_copy(t: torch.Tensor, elements: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``elements`` elements into its
    buffer, so that its address is not 16-byte aligned."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


def differing(a: torch.Tensor, b: torch.Tensor) -> str:
    return f"{int((a != b).sum())} of {a.numel()} values differ"


def outer_product_phase(xbk, gen) -> dict:
    """Bit pins that tie the dw and pulse kernels (and, through the fused
    phase, crossbar_train.cu) to one summation order, at every
    ``outer_product_cases`` shape:
    (a) dw on int8 codes with a scale equals dw on ``codes.float() *
        scale``;
    (b) pulse_update equals the plain pulse epilogue
        (``pulse_epilogue_plain``: round(fp32(2 lr) dw / fp32(u)), clamp,
        0.5 (c u), g± ± half, clamp) applied to the dw kernel's product.
    Then every tile of ``OUTER_PRODUCT_TILES`` gives the picked tile's bits
    for dw (fp32, int8 and int32 codes) and pulse, on ragged shapes, on
    operands whose addresses are not 16-byte aligned, and at the largest
    main-path shape; the picked tile is held against the plain versions.
    Returns the pin counts.  Launches here are not counted."""
    rule = dict(max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    scale = torch.tensor(0.05 / 127, device="cuda")
    pins = {"a": 0, "b": 0, "tiles": 0}
    for T, M, K, N in outer_product_cases():
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        codes = torch.randint(-127, 128, (T, M, N), generator=gen,
                              dtype=torch.int8, device="cuda")
        got = xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale)
        want = xbk.crossbar_dw_kernel(xs, codes.float() * scale)
        if not torch.equal(got, want):
            raise AssertionError(f"pin (a) at {(T, M, K, N)}: dw on codes "
                                 f"vs dequantized, {differing(got, want)}")
        d = uniform((T, M, N), -0.05, 0.05, gen)
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        lr = 0.25 / M ** 0.5
        got = xbk.pulse_update_kernel(gp, gm, xs, d, lr=lr, **rule)
        want = xbk.pulse_epilogue_plain(
            gp, gm, xbk.crossbar_dw_kernel(xs, d), lr=lr, **rule)
        for name, a, b in zip(("g+", "g-"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"pin (b) at {(T, M, K, N)}: pulse vs "
                                     f"epilogue(dw) {name}, "
                                     f"{differing(a, b)}")
        pins["a"] += 1
        pins["b"] += 1
    for T, M, K, N, off in ((3, 37, 300, 26, 1), (2, 70, 17, 9, 3),
                            (6, 100, 400, 100, 2), (1, 4096, 784, 300, 0)):
        xs = offset_copy(uniform((T, M, K), -0.5, 0.5, gen), off)
        d = offset_copy(uniform((T, M, N), -0.05, 0.05, gen), off)
        c8 = offset_copy(torch.randint(-127, 128, (T, M, N), generator=gen,
                                       dtype=torch.int8, device="cuda"),
                         5 * off)
        c32 = offset_copy(c8.to(torch.int32), off)
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        lr = 0.25 / M ** 0.5
        runs = {
            "dw fp32": lambda t: (xbk.crossbar_dw_kernel(xs, d, tile=t),),
            "dw int8": lambda t: (xbk.crossbar_dw_kernel(
                xs, c8, dy_scale=scale, tile=t),),
            "dw int32": lambda t: (xbk.crossbar_dw_kernel(
                xs, c32, dy_scale=scale, tile=t),),
            "pulse": lambda t: xbk.pulse_update_kernel(
                gp, gm, xs, d, lr=lr, tile=t, **rule),
        }
        ref = {k: f(None) for k, f in runs.items()}
        what = f"{(T, M, K, N)} offset {off}"
        close(ref["dw fp32"][0], xbk.crossbar_dw_plain(xs, d),
              f"dw {what}")
        close(ref["dw int8"][0], xbk.crossbar_dw_plain(xs, c8,
                                                        dy_scale=scale),
              f"dw int8 {what}")
        if not torch.equal(ref["dw int8"][0], ref["dw int32"][0]):
            raise AssertionError(f"dw int8 vs int32 codes {what}")
        counts = xbk.pulse_counts_plain(xs, d, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        check_pulse_counts(gp, gm, ref["pulse"],
                           xbk.pulse_update_plain(gp, gm, xs, d, lr=lr,
                                                  **rule),
                           counts, f"pulse {what}")
        for t in range(len(xbk.OUTER_PRODUCT_TILES)):
            for name, run in runs.items():
                for a, b in zip(run(t), ref[name]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} {what}: tile {t} vs "
                                             f"the picked tile, "
                                             f"{differing(a, b)}")
                pins["tiles"] += 1
    torch.cuda.synchronize()
    print(f"outer-product pins: (a) dw(codes, scale) == dw(codes * scale) "
          f"and (b) pulse == epilogue(dw), bit for bit, at {pins['a']} "
          f"shapes; every tile == the picked tile at {pins['tiles']} "
          f"(kernel, shape, tile) triples")
    return pins


def tile_sweep(xbk, gen) -> list[dict]:
    """Device time (``graph_ms``) of every tile at the main paths' dw and
    pulse launches: crossbar_apply's 4 mnist layers on int8 codes at M =
    4096, one eager mnist step's stacks at M = 4096 and isolet's at M =
    256; beside the tile the wrapper picks."""
    rule = dict(lr=LR, max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    scale = torch.tensor(0.05 / 127, device="cuda")
    shapes = [("crossbar_dw", 1, 4096, K, N) for K, N in MNIST_LAYERS]
    shapes += [("pulse_update", T, M, K, N) for app, M in
               (("mnist_class", 4096), ("isolet_class", 256))
               for T, K, N in dict.fromkeys(TRAIN_SHAPES[app])]
    rows = []
    for kernel, T, M, K, N in shapes:
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        if kernel == "crossbar_dw":
            codes = torch.randint(-127, 128, (T, M, N), generator=gen,
                                  dtype=torch.int8, device="cuda")
            def run(t):
                return xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale,
                                              tile=t)
        else:
            d = uniform((T, M, N), -0.05, 0.05, gen)
            gp = uniform((T, K, N), 0.3, 0.7, gen)
            gm = uniform((T, K, N), 0.3, 0.7, gen)
            def run(t):
                return xbk.pulse_update_kernel(gp, gm, xs, d, tile=t, **rule)
        ms = [graph_ms(lambda: run(t)) for t in
              range(len(xbk.OUTER_PRODUCT_TILES))]
        picked = xbk.outer_product_tile(T, M, K, N, 1 if kernel ==
                                        "crossbar_dw" else 4)
        rows.append({"kernel": kernel, "T": T, "M": M, "K": K, "N": N,
                     "picked": picked, "best": ms.index(min(ms)),
                     "ms_by_tile": [round(v, 5) for v in ms]})
    return rows


def row_product_cases() -> list[dict]:
    """Forward cases of the tile pins: every recognition stage shape at M =
    16 and 4096, mnist's four layers (crossbar_apply's and
    mlp_forward(use_kernel=True)'s shapes, N = 10 included) at M = 16 and
    4096 with the activation and 3-bit ADC epilogue, and ragged and
    unaligned operands (cp.async paths: K = 37, 45; N = 11, 13, 9)."""
    cases = [dict(shape=(T, M, K, N)) for M in (16, 4096)
             for T, K, N in dict.fromkeys(s for v in WAVE_SHAPES.values()
                                          for s in v)]
    cases += [dict(shape=(1, M, K, N), activation=True, adc_bits=ADC_BITS)
              for M in (16, 4096) for K, N in MNIST_LAYERS]
    cases += [dict(shape=(5, 3, 37, 11)), dict(shape=(6, 7, 45, 13)),
              dict(shape=(3, 37, 300, 26), offset=1),
              dict(shape=(2, 70, 17, 9), offset=3),
              dict(shape=(6, 100, 400, 100), offset=2)]
    return cases


def row_product_phase(xbk, gen) -> int:
    """Every tile of ``ROW_PRODUCT_TILES`` gives the picked tile's bits for
    the forward kernel at every ``row_product_cases`` shape (the epilogue
    included); the picked tile is held against the plain version (3-bit
    codes: flips only at a boundary).  Returns the (shape, tile) pairs
    pinned.  Launches here are not counted."""
    pins = 0
    for case in row_product_cases():
        T, M, K, N = case["shape"]
        off = case.get("offset", 0)
        act, bits = case.get("activation", False), case.get("adc_bits")
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        gp = uniform((T, K, N), 0.0, 0.02, gen)
        gm = uniform((T, K, N), 0.0, 0.02, gen)
        if off:
            xs, gp, gm = (offset_copy(a, off) for a in (xs, gp, gm))
        def run(t):
            return xbk.crossbar_fwd_kernel(xs, gp, gm, activation=act,
                                           adc_bits=bits, tile=t)
        ref = run(None)
        want = xbk.crossbar_fwd_plain(xs, gp, gm, activation=act,
                                      adc_bits=bits)
        what = f"fwd {case}"
        if bits is None:
            close(ref, want, what)
        else:
            code_flips(xbk.crossbar_fwd_plain(xs, gp, gm, activation=act),
                       ref)
        for t in range(len(xbk.ROW_PRODUCT_TILES)):
            got = run(t)
            if not torch.equal(got, ref):
                raise AssertionError(f"{what}: tile {t} vs the picked tile, "
                                     f"{differing(got, ref)}")
            pins += 1
    torch.cuda.synchronize()
    print(f"row-product pins: every forward tile == the picked tile, bit "
          f"for bit, at {pins} (shape, tile) pairs "
          f"({len(row_product_cases())} shapes)")
    return pins


def fwd_tile_sweep(xbk, gen) -> list[dict]:
    """Device time (``graph_ms``) of every forward tile at the main paths'
    launches: one mnist_class wave at M = 4096, one isolet_class wave at M
    = 256 and mnist's four layers at M = 4096; beside the tile the wrapper
    picks."""
    shapes = [(T, M, K, N) for app, M in (("mnist_class", 4096),
                                          ("isolet_class", 256))
              for T, K, N in dict.fromkeys(WAVE_SHAPES[app])]
    shapes += [(1, 4096, K, N) for K, N in MNIST_LAYERS]
    rows = []
    for T, M, K, N in shapes:
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        gp = uniform((T, K, N), 0.0, 0.02, gen)
        gm = uniform((T, K, N), 0.0, 0.02, gen)
        ms = [graph_ms(lambda: xbk.crossbar_fwd_kernel(
            xs, gp, gm, activation=False, tile=t))
            for t in range(len(xbk.ROW_PRODUCT_TILES))]
        rows.append({"kernel": "crossbar_fwd", "T": T, "M": M, "K": K,
                     "N": N, "picked": xbk.row_product_tile(T, M, K, N),
                     "best": ms.index(min(ms)),
                     "ms_by_tile": [round(v, 5) for v in ms]})
    return rows


def bwd_pin_cases() -> list[dict]:
    """Cases of the bwd tile pins: every training stage stack at M = 1, 64
    and 4096; mnist's four layers (crossbar_apply's; N = 300 and 200 go
    through the ring walk) at M = 64 and 4096; the ragged (3, 37, 300,
    26); operands whose addresses are not 16-byte aligned (cp.async paths,
    the ring walk's among them); a chip-axis case.  ``codes``: also int8
    and int32 error codes."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [dict(shape=(T, M, K, N)) for T, K, N in stacks
             for M in (1, 64, 4096)]
    cases += [dict(shape=(1, M, K, N), codes=True) for K, N in MNIST_LAYERS
              for M in (64, 4096)]
    cases += [dict(shape=(3, 37, 300, 26), codes=True),
              dict(shape=(6, 64, 400, 100), codes=True),
              dict(shape=(3, 37, 300, 26), offset=1, codes=True),
              dict(shape=(2, 70, 17, 9), offset=3, codes=True),
              dict(shape=(2, 33, 150, 301), offset=2, codes=True),
              dict(shape=(3, 7, 45, 13), chips=2, codes=True)]
    return cases


def bwd_pin_phase(xbk, ops, gen) -> int:
    """Every tile of ``CROSSBAR_BWD_TILES``, at runs 1 and 3 where N <= 128,
    gives the picked launch's bits at every ``bwd_pin_cases`` case, for
    fp32 errors and, where marked, int8 and int32 codes; codes give the
    bits of their values (``codes.float() * scale``); the picked launch is
    held against the plain version.  Returns the (case, error type, tile,
    run) launches pinned.  Launches here are not counted."""
    scale = torch.tensor(0.05 / 127, device="cuda")
    pins = 0
    for case in bwd_pin_cases():
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        off = case.get("offset", 0)
        d = uniform(lead + (T, M, N), -0.05, 0.05, gen)
        gp = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        gm = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        c8 = torch.randint(-127, 128, lead + (T, M, N), generator=gen,
                           dtype=torch.int8, device="cuda")
        c32 = c8.to(torch.int32)
        if off:
            d, gp, gm, c32 = (offset_copy(a, off) for a in (d, gp, gm, c32))
            c8 = offset_copy(c8, 5 * off)
        kinds = {"fp32": (d, None)}
        if case.get("codes"):
            kinds.update(int8=(c8, scale), int32=(c32, scale))
        for kind, (dd, sc) in kinds.items():
            what = f"bwd {case} {kind}"
            g_p, g_m = gp, gm
            if lead:   # through the stacked wrapper's chip-axis fold
                ref = ops.crossbar_bwd_stacked(dd, g_p, g_m, dy_scale=sc)
                ref, dd, g_p, g_m = (a.reshape((-1,) + a.shape[2:])
                                     for a in (ref, dd, g_p, g_m))
            else:
                ref = xbk.crossbar_bwd_kernel(dd, g_p, g_m, dy_scale=sc)
            close(ref, xbk.crossbar_bwd_plain(dd, g_p, g_m, dy_scale=sc),
                  what)
            if sc is not None and not torch.equal(
                    ref, xbk.crossbar_bwd_kernel(dd.float() * sc, g_p, g_m)):
                raise AssertionError(f"{what}: codes vs their values")
            runs = (1, 3) if N <= xbk.MAX_N_DX_WALK else (1,)
            for t in range(len(xbk.CROSSBAR_BWD_TILES)):
                for r in runs:
                    got = xbk.crossbar_bwd_kernel(dd, g_p, g_m, dy_scale=sc,
                                                  tile=t, run=r)
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{what}: tile {t} run {r} vs "
                                             f"the picked launch, "
                                             f"{differing(got, ref)}")
                    pins += 1
    torch.cuda.synchronize()
    print(f"bwd pins: every tile (runs 1 and 3 where N <= 128) == the "
          f"picked launch, bit for bit, at {pins} (case, error type, tile, "
          f"run) launches ({len(bwd_pin_cases())} cases); codes == their "
          f"values; the pick within {ATOL} of plain")
    return pins


def bwd_tile_sweep(xbk, gen) -> list[dict]:
    """Device time (``graph_ms``) of every bwd tile and run at the main
    paths' bwd launches: one eager mnist step's stacks at M = 4096 (fp32),
    isolet's at M = 256 and crossbar_apply's four mnist layers on int8
    codes at M = 64 and 4096; beside ``torch.bmm`` of the same contraction
    (on the dequantized errors) and the picked tile and run."""
    scale = torch.tensor(0.05 / 127, device="cuda")
    shapes = [(T, M, K, N, False) for app, M in (("mnist_class", 4096),
                                                 ("isolet_class", 256))
              for T, K, N in dict.fromkeys(TRAIN_SHAPES[app])]
    shapes += [(1, M, K, N, True) for M in (64, 4096)
               for K, N in MNIST_LAYERS]
    rows = []
    for T, M, K, N, codes in shapes:
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        if codes:
            d = torch.randint(-127, 128, (T, M, N), generator=gen,
                              dtype=torch.int8, device="cuda")
            sc, dv = scale, d.float() * scale
        else:
            d = dv = uniform((T, M, N), -0.05, 0.05, gen)
            sc = None
        runs = (1, 2, 3, 4, 6, 8) if N <= xbk.MAX_N_DX_WALK else (1,)
        ms = {f"{t}/{r}": round(graph_ms(lambda: xbk.crossbar_bwd_kernel(
            d, gp, gm, dy_scale=sc, tile=t, run=r)), 5)
            for t in range(len(xbk.CROSSBAR_BWD_TILES)) for r in runs}
        tile, run = xbk._pick_bwd(None, None, T, M, K, N, d.element_size())
        rows.append({"kernel": "crossbar_bwd", "T": T, "M": M, "K": K,
                     "N": N, "codes": "int8" if codes else None,
                     "picked": f"{tile}/{run}",
                     "picked_ms": graph_ms(lambda: xbk.crossbar_bwd_kernel(
                         d, gp, gm, dy_scale=sc)),
                     "best": min(ms, key=ms.get),
                     "bmm_ms": graph_ms(lambda: torch.bmm(
                         dv, (gp - gm).transpose(1, 2))),
                     "ms_by_tile_run": ms})
    return rows


def row_product_ptxas(report: dict[str, dict]) -> dict[str, list]:
    """Registers, spill bytes (stores + loads) and dynamic shared memory of
    every forward instance (by ROW_PRODUCT_TILES index) and every fused
    instance (by the update walk's OUTER_PRODUCT_TILES index and the error
    type; shared memory at N = 100 without the forward, the compiled
    step's launch); raises on a spill."""
    import re
    from repro_torch.kernels import crossbar as xbk
    out = {}
    num = r"ELi".join([r"ILi(\d+)"] + [r"(\d+)"] * 5)
    fwd = re.compile(r"crossbar_fwdIN11row_product4Tile" + num + r"EEE")
    train = re.compile(r"crossbar_trainIN13outer_product4Tile" + num
                       + r"EEE([afi])E")
    for key, v in report.items():
        spills = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        m = fwd.search(key)
        if m:
            dims = tuple(map(int, m.groups()))
            tm, tc, ntc, ntm, br, stages = dims
            bm, bc = tm * ntm, tc * ntc
            stage = (-(-4 * bm * (br + 4) // 128) * 128
                     + 2 * -(-4 * br * bc // 128) * 128)
            name = f"crossbar_fwd[{xbk.ROW_PRODUCT_TILES.index(dims)}]"
            smem = stages * stage + 24 * stages
        else:
            m = train.search(key)
            if not m:
                continue
            tile = xbk.OUTER_PRODUCT_TILES.index(
                tuple(map(int, m.groups()[:6])))
            td = {"f": "f32", "a": "int8", "i": "int32"}[m.group(7)]
            name = f"crossbar_train[{tile}] {td}"
            smem = train_smem(tile, td, 100)
        if spills:
            raise AssertionError(f"{key}: {spills} bytes of register spills")
        out[name] = [v.get("registers"), spills, smem]
    want = len(xbk.ROW_PRODUCT_TILES) + 3 * len(xbk.OUTER_PRODUCT_TILES)
    if len(out) != want:
        raise AssertionError(f"ptxas report: {len(out)} fwd/train instances, "
                             f"expected {want}")
    return dict(sorted(out.items()))


def train_smem(tile: int, td: str, N: int) -> int:
    """Dynamic shared memory of a fused launch without the forward: the
    larger of the update walk's ring (outer_product.cuh) and the dx walk's
    B and ring (row_product.cuh), as the launcher computes them."""
    from repro_torch.kernels import crossbar as xbk
    tk, tn, wk, wn, bm, stages = xbk.OUTER_PRODUCT_TILES[tile]
    bk, bn = 8 * tk * wk, 4 * tn * wn
    raw = bm * ((bn + 15) // 16 * 16 + 16) if td == "int8" else 0
    update = stages * (-(-(4 * bm * (bk + bn) + raw) // 128) * 128 + 16)
    dbm, dbc = xbk.train_dx_dims(tile)
    p = (N + 3) // 4 * 4
    p += 0 if p // 4 % 2 else 4
    ring = -(-4 * dbm * p // 128) * 128
    if td == "int8":
        ring += -(-dbm * ((p + 15) // 16 * 16 + 16) // 128) * 128
    dx = -(-4 * N * (dbc + 4) // 128) * 128 + 3 * ring + 16 * 3
    return max(update, dx)


def outer_product_ptxas(report: dict[str, dict]) -> dict[str, list]:
    """Registers, spill bytes (stores + loads) and dynamic shared memory of
    every dw and pulse instance, by kernel, tile and dy type; raises on a
    spill."""
    import re
    from repro_torch.kernels import crossbar as xbk
    out = {}
    pat = re.compile(r"(crossbar_dw|pulse_update)IN13outer_product4Tile"
                     + r"ELi".join([r"ILi(\d+)"] + [r"(\d+)"] * 5)
                     + r"EEE?([afi]?)")
    for key, v in report.items():
        m = pat.search(key)
        if not m:
            continue
        tk, tn, wk, wn, bm, stages = map(int, m.groups()[1:7])
        td = {"": "f32", "f": "f32", "a": "int8", "i": "int32"}[m.group(8)]
        bk, bn = 8 * tk * wk, 4 * tn * wn
        raw = bm * ((bn + 15) // 16 * 16 + 16) if td == "int8" else 0
        tile = xbk.OUTER_PRODUCT_TILES.index((tk, tn, wk, wn, bm, stages))
        spills = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        if spills:
            raise AssertionError(f"{key}: {spills} bytes of register spills")
        stage = -(-(4 * bm * (bk + bn) + raw) // 128) * 128
        out[f"{m.group(1)}[{tile}] {td}"] = [
            v.get("registers"), spills, stages * (stage + 16)]
    if len(out) != 4 * len(xbk.OUTER_PRODUCT_TILES):
        raise AssertionError(f"ptxas report: {len(out)} dw/pulse instances")
    return dict(sorted(out.items()))


def bwd_ptxas(report: dict[str, dict]) -> dict[str, list]:
    """Registers, spill bytes (stores + loads) and dynamic shared memory of
    every bwd instance, by CROSSBAR_BWD_TILES index, error type and walk
    (dx_walk's shared memory at N = 100, the chip stages'; the ring walk's
    for any N > 128); raises on a spill."""
    import re
    from repro_torch.kernels import crossbar as xbk
    pat = re.compile(r"crossbar_bwdIN11row_product4Tile"
                     + r"ELi".join([r"ILi(\d+)"] + [r"(\d+)"] * 5)
                     + r"EEE([afi])Lb([01])E")
    out = {}
    for key, v in report.items():
        m = pat.search(key)
        if not m:
            continue
        tile = xbk.CROSSBAR_BWD_TILES.index(tuple(map(int, m.groups()[:6])))
        td = {"f": "f32", "a": "int8", "i": "int32"}[m.group(7)]
        ring = m.group(8) == "1"
        spills = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        if spills:
            raise AssertionError(f"{key}: {spills} bytes of register spills")
        out[f"crossbar_bwd[{tile}] {td} {'ring' if ring else 'dx_walk'}"] = [
            v.get("registers"), spills,
            xbk.bwd_smem(tile, 300 if ring else 100,
                         1 if td == "int8" else 4)]
    if len(out) != 6 * len(xbk.CROSSBAR_BWD_TILES):
        raise AssertionError(f"ptxas report: {len(out)} bwd instances")
    return dict(sorted(out.items()))


def kmeans_ptxas(report: dict[str, dict]) -> dict[str, list]:
    """Registers, spill bytes and dynamic shared memory of every k-means
    instance, by KMEANS_TILES index; raises on a spill."""
    import re
    from repro_torch.kernels import kmeans as kmk
    pat = re.compile(r"kmeans_assignINS_5KTileILi(\d+)ELi(\d+)ELi(\d+)"
                     r"ELi(\d+)E")
    out = {}
    for key, v in report.items():
        m = pat.search(key)
        if not m:
            continue
        tile = kmk.KMEANS_TILES.index(tuple(map(int, m.groups())))
        spills = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        if spills:
            raise AssertionError(f"{key}: {spills} bytes of register spills")
        out[f"kmeans_assign[{tile}]"] = [v.get("registers"), spills,
                                         kmk.kmeans_smem(tile)]
    if len(out) != len(kmk.KMEANS_TILES):
        raise AssertionError(f"ptxas report: {len(out)} k-means instances")
    return dict(sorted(out.items()))


def fused_kernel_cases() -> list[dict]:
    """Fused-kernel cases: every training stage stack at M = 1, 64, 4096,
    and tests/test_compiled_step.py's megakernel shapes (ragged stacks with
    zeroed trailing cores, int8 codes), a chip axis, codes at full size."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [dict(shape=(T, M, K, N)) for T, K, N in stacks
             for M in (1, 64, 4096)]
    cases += [dict(shape=(1, 2, 17, 9)), dict(shape=(3, 4, 41, 15)),
              dict(shape=(4, 2, 400, 100), ragged=2),
              dict(shape=(3, 4, 41, 15), codes=True),
              dict(shape=(5, 3, 129, 101), codes=True, ragged=3),
              dict(shape=(3, 7, 45, 13), chips=2, codes=True),
              dict(shape=(6, 4096, 400, 100), codes=True)]
    return cases


def fused_kernel_phase(xbk, ops, gen) -> tuple[float, list[dict]]:
    """The fused training kernel against the four-call sequence (bit for
    bit) and against its plain version; returns (max |kernel - plain| of
    ys and dxs, timing rows at M = 4096)."""
    max_err, rows, flips = 0.0, [], 0
    cases = fused_kernel_cases()
    rule = dict(max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        gp = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        gm = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        scale = None
        if case.get("codes"):
            dys = torch.randint(-127, 128, lead + (T, M, N), generator=gen,
                                dtype=torch.int8, device="cuda")
            scale = torch.tensor(0.05 / 127, device="cuda")
        else:
            dys = uniform(lead + (T, M, N), -0.05, 0.05, gen)
        if case.get("ragged"):   # the envelope's zeroed trailing cores
            for a in (xs, gp, gm, dys):
                a[..., T - case["ragged"]:, :, :] = 0
        d = dys if scale is None else dys.float() * scale
        lr = 0.25 / M ** 0.5
        lr_t = torch.full((1,), lr, device="cuda")
        gpi, gmi = gp.clone(), gm.clone()
        if lead:   # through the wrapper's chip-axis fold
            got = ops.crossbar_train_stacked(gp, gm, xs, dys, lr=lr_t,
                                             dy_scale=scale, compute_y=True,
                                             **rule)
            dxi = ops.crossbar_train_stacked(gpi, gmi, xs, dys, lr=lr_t,
                                             dy_scale=scale, inplace=True,
                                             **rule)[1]
            got = [a.reshape((-1,) + a.shape[2:]) for a in got]
            dxi, xs, d, dys, gp, gm, gpi, gmi = (
                a.reshape((-1,) + a.shape[2:])
                for a in (dxi, xs, d, dys, gp, gm, gpi, gmi))
        else:
            got = xbk.crossbar_train_kernel(gp, gm, xs, dys, lr=lr_t,
                                            dy_scale=scale, compute_y=True,
                                            **rule)
            dxi = ops.crossbar_train_stacked(gpi, gmi, xs, dys, lr=lr_t,
                                             dy_scale=scale, inplace=True,
                                             **rule)[1]
        four = (xbk.crossbar_fwd_kernel(xs, gp, gm, activation=False),
                xbk.crossbar_bwd_kernel(d, gp, gm),
                *xbk.pulse_update_kernel(gp, gm, xs, d, lr=lr, **rule))
        torch.cuda.synchronize()
        what = f"fused {case} lr={lr:.4g}"
        for name, a, b in zip(("ys", "dxs", "g+", "g-"), got, four):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"four-call sequence")
        if scale is not None:   # the picked bwd launch on the codes
            dxc = xbk.crossbar_bwd_kernel(dys, gp, gm, dy_scale=scale)
            if not torch.equal(dxc, got[1]):
                raise AssertionError(f"{what}: dxs differs from the bwd "
                                     f"kernel on the codes")
        for name, a, b in (("in-place dxs", dxi, four[1]),
                           ("in-place g+", gpi, four[2]),
                           ("in-place g-", gmi, four[3])):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"four-call sequence")
        want = xbk.crossbar_train_plain(gp, gm, xs, dys, lr=lr,
                                        dy_scale=scale, compute_y=True,
                                        **rule)
        max_err = max(max_err, close(got[0], want[0], f"{what} ys"),
                      close(got[1], want[1], f"{what} dxs"))
        counts = xbk.pulse_counts_plain(xs, d, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        flips += check_pulse_counts(gp, gm, got[2:], want[2:], counts, what)
        if M == 4096 and not lead and scale is None:
            rows.append(time_fused_shape(xbk, xs, d, gp, gm, lr))
    print(f"fused kernel phase: {len(cases)} cases x (forward on; forward "
          f"off, copied in place), bit for bit equal to the "
          f"four-call sequence; max |kernel - plain| {max_err:.3e} (ys, "
          f"dxs), {flips} pulse counts one apart at a half-integer")
    return max_err, rows


def time_fused_shape(xbk, xs, ds, gp, gm, lr) -> dict:
    """Kernel (forward off, as in the compiled step) / plain / ``torch.bmm``
    for dx plus ``torch.bmm`` for dw, on one stage stack."""
    T, M, K = xs.shape
    N = ds.shape[2]
    lr_t = torch.full((1,), lr, device="cuda")
    xt = xs.transpose(1, 2)
    tile = xbk.outer_product_tile(T, M, K, N, 4)
    row = with_device_ms(time_row("crossbar_train", T, M, K, N, {
        "ms": lambda: xbk.crossbar_train_kernel(gp, gm, xs, ds, lr=lr_t),
        "plain_ms": lambda: xbk.crossbar_train_plain(gp, gm, xs, ds, lr=lr),
        "library_ms": lambda: (torch.bmm(ds, (gp - gm).transpose(1, 2)),
                               torch.bmm(xt, ds)),
    }, library="bmm for dx + bmm for dw, without the pulse epilogue"),
        lambda: xbk.crossbar_train_kernel(gp, gm, xs, ds, lr=lr_t),
        lambda: (torch.bmm(ds, (gp - gm).transpose(1, 2)),
                 torch.bmm(xt, ds)), tile)
    row["dx_run"] = xbk.train_dx_run(M, tile)
    return row


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def check_chip_wave(chip, x, out, mlp_forward, spec) -> int:
    """Hold a chip wave against the plain product stage by stage (on the
    chip's own stage inputs) and end to end against plain ``mlp_forward``.
    Returns the number of samples downstream of a boundary code flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    from repro_torch.core.quantization import adc_quantize_ste
    acts, dps, wave_out = chip.forward_wave(x, count=False)
    if not torch.equal(wave_out, out):
        raise AssertionError("forward_wave and infer_stream disagree")
    layers = chip.layers()
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s, p in enumerate(layers):
        dp_ref = acts[s] @ (p["g_plus"] - p["g_minus"])
        err = float((dps[s] - dp_ref).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"stage {s}: dp max |err| {err}")
        if s + 1 < len(layers):
            pre = hard_sigmoid(dp_ref)
            flipped |= code_flips(pre, acts[s + 1],
                                  adc_quantize_ste(pre, spec.adc_bits))
    err = float((out - hard_sigmoid(dp_ref)).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"chip output vs last stage: max |err| {err}")
    # the plain path may round a code the other way at a boundary of its
    # own values: mlp_forward over the first s + 1 layers leaves its last
    # output before the ADC, which it then applies as above
    for s in range(len(layers) - 1):
        keep = ~flipped
        pre = mlp_forward(layers[:s + 1], x, spec, device="cuda")[keep]
        flipped[keep] = code_flips(pre, acts[s + 1][keep],
                                   adc_quantize_ste(pre, spec.adc_bits))
    ref = mlp_forward(layers, x, spec, device="cuda")
    off = ((out - ref).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError("chip output differs from mlp_forward on a "
                             "sample with no boundary code flip")
    return int(flipped.sum())


def check_mlp_kernel(layers, x, spec, ops, mlp_forward) -> int:
    """``mlp_forward(use_kernel=True)`` against its plain version, layer by
    layer on the kernel path's own inputs and end to end."""
    from repro_torch.core.crossbar import hard_sigmoid
    launches0 = ops.crossbar_fwd.launches
    out = mlp_forward(layers, x, spec, use_kernel=True, device="cuda")
    if ops.crossbar_fwd.launches - launches0 != len(layers):
        raise AssertionError("mlp_forward(use_kernel=True) did not launch "
                             "the kernel once per layer")
    h = x
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for li, p in enumerate(layers):
        bits = ADC_BITS if li < len(layers) - 1 else None
        hk = ops.crossbar_fwd(h, p["g_plus"], p["g_minus"], activation=True,
                              adc_bits=bits)
        pre = hard_sigmoid(h @ (p["g_plus"] - p["g_minus"]))
        if bits is None:
            err = float((hk - pre).abs().max())
            if not err <= ATOL:
                raise AssertionError(f"layer {li}: max |err| {err}")
        else:
            flipped |= code_flips(pre, hk)
        h = hk
    if not torch.equal(h, out):
        raise AssertionError("mlp_forward(use_kernel=True) is not "
                             "deterministic")
    ref = mlp_forward(layers, x, spec, device="cuda")
    off = ((out - ref).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError("mlp_forward kernel path differs from plain on "
                             "a sample with no boundary code flip")
    return int(flipped.sum())


def run_wave(chip, x, ops, expected: int):
    before = ops.crossbar_fwd_stacked.launches
    out, stats = chip.infer_stream(x)
    torch.cuda.synchronize()
    got = ops.crossbar_fwd_stacked.launches - before
    if got != expected:
        raise AssertionError(f"{chip.name}: {got} kernel launches in a wave "
                             f"of {x.shape[0]}, expected {expected}")
    if tuple(out.shape) != (x.shape[0], chip.placement.dims[-1]) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{chip.name}: bad output {tuple(out.shape)}")
    return out, stats


def check_report(chip, hw) -> dict:
    cmp_ = chip.report().compare_hw(
        hw.network_cost(chip.name, list(chip.placement.dims)))
    bad = {k: v for k, v in cmp_.items() if not v <= 0.01}
    if bad or set(cmp_) != {"infer_time", "infer_energy", "infer_io"}:
        raise AssertionError(f"{chip.name}: hw_model cross-validation {cmp_}")
    ref = hw.PAPER_TABLE_IV[chip.name]["time_us"]
    if not abs(chip.beat_us - ref) / ref <= 0.01:
        raise AssertionError(f"{chip.name}: beat {chip.beat_us} us")
    return cmp_


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for ``kernels.ops`` inside ``sim.chip`` and records the
    arguments and results of the stacked bwd and pulse wrappers, so every
    stage can be held against the plain versions on its own inputs.  It
    launches nothing itself: the real wrappers count their launches."""

    NAMES = ("crossbar_bwd_stacked", "pulse_update_stacked")

    def __init__(self, ops):
        self._ops = ops
        self.calls = {n: [] for n in self.NAMES}

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name not in self.NAMES:
            return fn

        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            # copies of the new stacks: a faulted chip re-asserts its
            # stuck masks into them in place after the update
            kept = tuple(t.clone() for t in out) \
                if isinstance(out, tuple) else out
            self.calls[name].append((args, kwargs, kept))
            return out
        return record


def plain_rule(layers, x, target, spec, lr) -> list[dict]:
    """Per layer, what the plain paper rule computes inside a step: the
    unrounded pulse counts 2 lr (a^T local) / (B u), the local error, and
    |delta| / scale before the 8-bit error rounding."""
    from repro_torch.core import quantization as q
    from repro_torch.core.crossbar import hard_sigmoid, hard_sigmoid_deriv
    acts, dps, h = [], [], x
    for li, p in enumerate(layers):
        if li > 0 and spec.transport_quant:
            h = q.adc_quantize(h, spec.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = hard_sigmoid(dps[-1])
    delta = target - h
    unit = spec.max_update / spec.update_levels
    out = [None] * len(layers)
    for li in reversed(range(len(layers))):
        qt = q.error_quantize(delta, spec.err_bits)
        ratio = delta.abs() / qt.scale
        if spec.error_quant:
            delta = qt.dequantize()
        local = delta * hard_sigmoid_deriv(dps[li])
        acc = (acts[li].T @ local).double()
        out[li] = {"counts": 2.0 * lr * acc / x.shape[0] / unit,
                   "local": local, "ratio": ratio}
        w = layers[li]["g_plus"] - layers[li]["g_minus"]
        delta = local @ w.T
    return out


def untile(stack: torch.Tensor, st) -> torch.Tensor:
    """(r*c, rows, cols) core stack -> the (fan_in, fan_out) layer."""
    r, c = st.row_tiles, st.col_tiles
    full = (stack.reshape(r, c, st.rows, st.cols).permute(0, 2, 1, 3)
            .reshape(r * st.rows, c * st.cols))
    return full[1:st.lmap.fan_in + 1, :st.lmap.fan_out]


def chip_stage_inputs(chip, entries) -> list[dict]:
    """Per layer, the chip's own stage inputs read back from its update
    launches — ``entries`` holds each stage's (core inputs xs, core errors
    ds, lr), last stage first: input activations (core i*c holds fan-in
    tile i), local errors (core j holds fan-out tile j) and the unrounded
    pulse counts of the plain rule on them."""
    from repro_torch.kernels import crossbar as xbk
    out = [None] * len(chip.placement.stages)
    for (xs, ds, lr), st in zip(entries, reversed(chip.placement.stages)):
        r, c = st.row_tiles, st.col_tiles
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        out[st.index] = {
            "act": torch.cat([xs[i * c] for i in range(r)],
                             dim=1)[:, 1:st.lmap.fan_in + 1],
            "local": torch.cat([ds[j] for j in range(c)],
                               dim=1)[:, :st.lmap.fan_out],
            "counts": untile(counts, st).double(),
        }
    return out


def clone_layers(chip) -> list[dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in p.items()} for p in chip.layers()]


def check_train_step(chip, rec, n, layers0, layers1, x, target, err, spec,
                     paper_backprop_step, lr) -> dict:
    """Hold one chip step stage by stage (plain versions on the chip's own
    stage inputs) and whole (the port's plain ``paper_backprop_step`` on
    the same layers and data).  Returns counts of boundary flips.

    Where the chip's own inputs legitimately differ from the plain step's
    — a 3-bit activation code within BOUNDARY of a half-step, or an 8-bit
    error code whose plain |delta|/scale lies within 1e-3 of a half-integer
    (the codes' own rounding boundary; a last-bit difference upstream moves
    it by ~1e-5) — a pulse count may also differ by one where the plain
    counts on the two sides' inputs round apart."""
    from repro_torch.core.crossbar import hard_sigmoid
    from repro_torch.kernels import crossbar as xbk
    S = len(chip.placement.stages)
    bwd = rec.calls["crossbar_bwd_stacked"][n:n + S]
    pulse = rec.calls["pulse_update_stacked"][n:n + S]
    stage_flips = 0
    for (bargs, bkw, dx), (pargs, pkw, new) in zip(bwd, pulse):
        close(dx, xbk.crossbar_bwd_plain(*bargs, **bkw),
              f"{chip.name} stage dx")
        want = xbk.pulse_update_plain(*pargs, **pkw)
        counts = xbk.pulse_counts_plain(pargs[2], pargs[3], lr=pkw["lr"],
                                        max_dw=pkw["max_dw"],
                                        levels=pkw["levels"])
        stage_flips += check_conductances(new, want, counts,
                                          f"{chip.name} stage g±")
    ours = chip_stage_inputs(chip, [(a[2], a[3], kw["lr"])
                                    for a, kw, _ in pulse])
    plain = plain_rule(layers0, x, target, spec, lr)
    # forward codes on the chip's own stage inputs
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(1, S):
        p = layers0[s - 1]
        pre = hard_sigmoid(ours[s - 1]["act"] @ (p["g_plus"] - p["g_minus"]))
        flipped |= code_flips(pre, ours[s]["act"])
    # error codes: the first layer (from the output) whose local error
    # differs must differ at a code boundary; what lies below follows it
    err_flips = 0
    for s in reversed(range(S)):
        off = (ours[s]["local"] - plain[s]["local"]).abs() > ATOL
        off &= ~flipped[:, None]
        if bool(off.any()):
            r = plain[s]["ratio"][off]
            if bool(((r - torch.floor(r) - 0.5).abs() > 1e-3).any()):
                raise AssertionError(f"{chip.name}: layer {s} local error "
                                     f"differs off an 8-bit code boundary")
            err_flips = int(off.sum())
            break
    # the whole step against the plain rule on the same layers and data
    want_layers, want_err = paper_backprop_step(layers0, x, target, spec,
                                                lr)
    off = ((err - want_err).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip.name}: step error differs from "
                             f"paper_backprop_step off a code flip")
    inputs_differ = bool(flipped.any()) or err_flips > 0
    step_flips = 0
    for li, (got, want) in enumerate(zip(layers1, want_layers)):
        counts = plain[li]["counts"]
        if inputs_differ:   # excuse cells the two sides' inputs round apart
            apart = torch.round(ours[li]["counts"]) != torch.round(counts)
            counts = torch.where(apart, torch.full_like(counts, 0.5),
                                 counts)
        step_flips += check_conductances(
            (got["g_plus"], got["g_minus"]),
            (want["g_plus"], want["g_minus"]), counts,
            f"{chip.name} step layer {li} vs paper_backprop_step")
    return {"stage_pulse_flips": stage_flips, "step_pulse_flips": step_flips,
            "fwd_code_flip_samples": int(flipped.sum()),
            "err_code_flips": err_flips}


def train_path(ops, chip_mod, build_chip, spec, paper_backprop_step, hw,
               gen) -> dict:
    """The training main path (see the module docstring, step 5)."""
    mnist = build_chip("mnist_class", seed=SEED, device="cuda",
                       compiled=False)
    isolet = build_chip("isolet_class", seed=SEED, device="cuda",
                        compiled=False)
    # one counted recognition wave each, so compare_hw has its infer keys
    mnist.infer(uniform((4, 784), -0.5, 0.5, gen))
    isolet.infer(uniform((4, 617), -0.5, 0.5, gen))
    steps = ([(mnist, 1)] * 3 + [(mnist, 4096)] * 2 + [(isolet, 256)])
    data = [(chip, uniform((B, chip.placement.dims[0]), -0.5, 0.5, gen),
             uniform((B, chip.placement.dims[-1]), -0.5, 0.5, gen))
            for chip, B in steps]
    initial = {c.name: clone_layers(c) for c in (mnist, isolet)}
    rec = Recorder(ops)
    names = ("crossbar_fwd_stacked", "crossbar_bwd_stacked",
             "pulse_update_stacked")
    chip_mod.kernel_ops = rec
    try:
        for n in names:
            getattr(ops, n).launches = 0
        snaps, errs = [None], []
        for chip, x, t in data:
            errs.append(chip.train_step(x, t, lr=LR))
            snaps.append(clone_layers(chip))
        torch.cuda.synchronize()
        launches = {n: getattr(ops, n).launches for n in names}
    finally:
        chip_mod.kernel_ops = ops
    expect = 4 * 5 + 5 * 1
    if launches["crossbar_bwd_stacked"] != expect or \
            launches["pulse_update_stacked"] != expect:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expect} bwd and {expect} pulse")
    print(f"training path: launches {json.dumps(launches)} (bwd + pulse: "
          f"4 + 4 per mnist step x 5, 5 + 5 per isolet step x 1)")
    flips, n = [], 0
    for i, ((chip, x, t), err) in enumerate(zip(data, errs)):
        if tuple(err.shape) != tuple(t.shape) or \
                not bool(torch.isfinite(err).all()):
            raise AssertionError(f"{chip.name}: bad step error")
        before = snaps[i] if i and data[i - 1][0] is chip \
            else initial[chip.name]
        flips.append(check_train_step(chip, rec, n, before, snaps[i + 1], x,
                                      t, err, spec, paper_backprop_step, LR))
        n += len(chip.placement.stages)
    print("training steps held against plain (batch 1 x3, 4096 x2 mnist; "
          "256 isolet): " + json.dumps(flips))
    keys = {"infer_time", "infer_energy", "infer_io", "train_time",
            "train_energy", "train_io"}
    for chip in (mnist, isolet):
        cmp_ = chip.report().compare_hw(
            hw.network_cost(chip.name, list(chip.placement.dims)))
        if set(cmp_) != keys or not all(v <= 0.01 for v in cmp_.values()):
            raise AssertionError(f"{chip.name}: hw_model cross-validation "
                                 f"{cmp_}")
        print(f"{chip.name} after training: hw_model rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    return launches


# ---------------------------------------------------------------------------
# Compiled paths (the chip's default: one captured CUDA graph per shape)
# ---------------------------------------------------------------------------

WRAPPERS = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
            "crossbar_fwd_stacked", "crossbar_bwd_stacked",
            "crossbar_dw_stacked", "pulse_update_stacked",
            "crossbar_train_stacked")


def zero_counts(ops, csim) -> None:
    """Every wrapper's launch count and the capture count to 0."""
    for n in WRAPPERS:
        getattr(ops, n).launches = 0
    csim.reset_capture_counts()


def read_counts(ops) -> dict[str, int]:
    return {n: getattr(ops, n).launches for n in WRAPPERS
            if getattr(ops, n).launches}


def per_replay(chips: dict) -> dict[str, dict]:
    """Each built program's kernel launches per replay, by chip and key."""
    return {f"{app} {key[0]} {key[2]}": prog.per_replay
            for app, chip in chips.items()
            for key, prog in chip._get_stacks().programs.items()}


def check_against_eager(chip_c, chip_e, x, out_c, out_e) -> int:
    """A compiled wave against the eager chip's on the same conductances:
    stage inputs as 3-bit codes (a flip only at a boundary), dot products
    and outputs within ATOL on every sample not past a flip.  Returns the
    samples past a flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    ac, dc, _ = chip_c.forward_wave(x, count=False)
    ae, de, _ = chip_e.forward_wave(x, count=False)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(len(dc)):
        if s:
            flipped |= code_flips(hard_sigmoid(de[s - 1]), ac[s])
        off = ((dc[s] - de[s]).abs() > ATOL).any(dim=-1)
        if bool((off & ~flipped).any()):
            raise AssertionError(f"{chip_c.name}: stage {s} dot products "
                                 f"differ from eager off a code flip")
    off = ((out_c - out_e).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip_c.name}: compiled output differs from "
                             f"eager on a sample with no boundary flip")
    return int(flipped.sum())


def compiled_recognition(ops, csim, build_chip, mlp_forward, hw, eager,
                         waves) -> tuple[dict, dict]:
    """The compiled recognition path (module docstring, step 5): each wave
    of ``waves`` ((app, x, eager output)) twice on a compiled chip.
    Returns (chips, launch counts)."""
    chips = {app: build_chip(app, seed=SEED, device="cuda")
             for app in ("mnist_class", "isolet_class")}
    zero_counts(ops, csim)
    outs = []
    for app, x, _ in waves:
        first, _ = chips[app].infer_stream(x)     # capture
        outs.append((first, chips[app].infer_stream(x)[0]))   # replay
    torch.cuda.synchronize()
    launches, captures = read_counts(ops), csim.capture_counts()
    if launches != {"crossbar_fwd_stacked": 2 * (4 + 4 + 5)}:
        raise AssertionError(f"compiled recognition launches {launches}, "
                             f"expected 4 per mnist wave and 5 per isolet "
                             f"wave, 2 waves per shape")
    if len(captures) != len(waves) or set(captures.values()) != {1}:
        raise AssertionError(f"captures {captures}: expected one per shape")
    replays = per_replay(chips)
    for name, got in replays.items():
        want = 4 if name.startswith("mnist") else 5
        if got != {"crossbar_fwd_stacked": want}:
            raise AssertionError(f"{name}: {got} per replay")
    flips = {}
    for (app, x, out_e), (first, replay) in zip(waves, outs):
        if not torch.equal(first, replay):
            raise AssertionError(f"{app}: a replay differs from its first "
                                 f"run")
        what = f"{app} x{x.shape[0]}"
        flips[f"{what} vs plain"] = check_chip_wave(
            chips[app], x, replay, mlp_forward, chips[app].spec)
        flips[f"{what} vs eager"] = check_against_eager(
            chips[app], eager[app], x, replay, out_e)
    print(f"compiled recognition path: launches {json.dumps(launches)} "
          f"(4 per mnist wave x 4, 5 per isolet wave x 2), "
          f"{len(captures)} captures, one per (program, shape); per replay "
          + json.dumps(replays))
    print("compiled waves held against plain and eager (samples after a "
          "boundary code flip): " + json.dumps(flips))
    for chip in chips.values():
        cmp_ = check_report(chip, hw)
        print(f"{chip.name} compiled: beat {chip.beat_us:.4f} us, hw_model "
              "rel err " + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    return chips, launches


class GraphRecorder:
    """Stands in for ``kernels.ops`` inside ``sim.compiled`` and keeps what
    the fused wrapper read and wrote: (xs, ds, lr, dxs) per stage.  A
    program's first call runs the stage loop for real (its entries hold
    that call's values); its capture's entries are the graph's own memory,
    which every replay rewrites, so after a replay they hold that replay's
    stage inputs.  It launches nothing itself."""

    def __init__(self, ops):
        self._ops = ops
        self.run, self.captured = [], []

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name != "crossbar_train_stacked":
            return fn

        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            capturing = torch.cuda.is_current_stream_capturing()
            (self.captured if capturing else self.run).append(
                (args[2], args[3], kwargs["lr"], out[1]))
            return out
        return record


def stage_stacks(chip) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(st.g_plus.clone(), st.g_minus.clone())
            for st in chip.placement.stages]


def stacks_to_layers(stacks, chip) -> list[dict[str, torch.Tensor]]:
    return [{"g_plus": untile(gp, st), "g_minus": untile(gm, st)}
            for (gp, gm), st in zip(stacks, chip.placement.stages)]


def check_compiled_step(chip, ours_c, ours_e, layers0, layers_c, layers_e,
                        x, target, err_c, err_e, spec, lr) -> dict:
    """Hold a compiled step against the eager chip's step from the same
    conductances, under the tolerances of ``check_train_step``: forward
    codes and 8-bit error codes may flip only at their boundaries, and a
    pulse count may differ by one next to a half-integer or where the two
    sides' own inputs round apart downstream of such a flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    S = len(layers0)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(1, S):
        w = layers0[s - 1]["g_plus"] - layers0[s - 1]["g_minus"]
        for ours in (ours_c, ours_e):
            flipped |= code_flips(hard_sigmoid(ours[s - 1]["act"] @ w),
                                  ours[s]["act"])
    plain = plain_rule(layers0, x, target, spec, lr)
    err_flips = 0
    for s in reversed(range(S)):
        off = (ours_c[s]["local"] - ours_e[s]["local"]).abs() > ATOL
        off &= ~flipped[:, None]
        if bool(off.any()):
            r = plain[s]["ratio"][off]
            if bool(((r - torch.floor(r) - 0.5).abs() > 1e-3).any()):
                raise AssertionError(f"{chip.name}: layer {s} local error "
                                     f"differs off an 8-bit code boundary")
            err_flips = int(off.sum())
            break
    off = ((err_c - err_e).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip.name}: compiled step error differs "
                             f"from eager off a code flip")
    differ = bool(flipped.any()) or err_flips > 0
    step_flips = 0
    for li in range(S):
        counts = ours_e[li]["counts"]
        if differ:
            apart = (torch.round(ours_c[li]["counts"])
                     != torch.round(counts))
            counts = torch.where(apart, torch.full_like(counts, 0.5), counts)
        step_flips += check_conductances(
            (layers_c[li]["g_plus"], layers_c[li]["g_minus"]),
            (layers_e[li]["g_plus"], layers_e[li]["g_minus"]), counts,
            f"{chip.name} compiled step layer {li} vs eager")
    return {"step_pulse_flips": step_flips,
            "fwd_code_flip_samples": int(flipped.sum()),
            "err_code_flips": err_flips}


def compiled_train_path(ops, csim, chip_mod, build_chip, spec, hw,
                        gen) -> dict:
    """The compiled training path (module docstring, step 7)."""
    from repro_torch.kernels import crossbar as xbk
    apps = ("mnist_class", "isolet_class")
    chips = {a: build_chip(a, seed=SEED, device="cuda") for a in apps}
    eager = {a: build_chip(a, seed=SEED, device="cuda", compiled=False)
             for a in apps}
    for chip in (*chips.values(), *eager.values()):
        # one counted wave each, so compare_hw has its infer keys
        chip.infer(uniform((4, chip.placement.dims[0]), -0.5, 0.5, gen))
    data = [(app, uniform((B, chips[app].placement.dims[0]), -0.5, 0.5, gen),
             uniform((B, chips[app].placement.dims[-1]), -0.5, 0.5, gen),
             lr) for app, B, lr in STEPS]
    ptrs = {a: (c._get_stacks().g_plus.data_ptr(),
                c._get_stacks().g_minus.data_ptr())
            for a, c in chips.items()}
    rec = GraphRecorder(ops)
    graphs, records = {}, []
    csim.kernel_ops = rec
    try:
        zero_counts(ops, csim)
        for app, x, t, lr in data:
            chip = chips[app]
            S = len(chip.placement.stages)
            before, n_run, n_cap = stage_stacks(chip), len(rec.run), \
                len(rec.captured)
            err = chip.train_step(x, t, lr=lr)
            if len(rec.run) > n_run:    # this call built its program
                entries = rec.run[n_run:n_run + S]
                graphs[(app, x.shape[0])] = rec.captured[n_cap:n_cap + S]
            else:                       # a replay: read the graph's memory
                entries = graphs[(app, x.shape[0])]
            entries = [tuple(a.clone() for a in e) for e in entries]
            records.append((app, x, t, lr, before, entries, err.clone(),
                            stage_stacks(chip)))
        torch.cuda.synchronize()
        launches, captures = read_counts(ops), csim.capture_counts()
    finally:
        csim.kernel_ops = ops
    expect = 4 * 5 + 5
    if launches != {"crossbar_fwd_stacked": expect,
                    "crossbar_train_stacked": expect}:
        raise AssertionError(f"compiled training launches {launches}, "
                             f"expected {expect} fwd and {expect} fused")
    if sorted(k[2] for k in captures) != [(1, 784), (256, 617),
                                          (4096, 784)] \
            or set(captures.values()) != {1}:
        raise AssertionError(f"captures {captures}: expected one per batch "
                             f"(the lr change must not recapture)")
    after = {a: (c._get_stacks().g_plus.data_ptr(),
                 c._get_stacks().g_minus.data_ptr())
             for a, c in chips.items()}
    if after != ptrs:
        raise AssertionError(f"the envelope moved: {ptrs} -> {after}")
    replays = {k: v for k, v in per_replay(chips).items() if "train" in k}
    print(f"compiled training path: launches {json.dumps(launches)} (4 + 4 "
          f"per mnist step x 5, 5 + 5 per isolet step), captures "
          + json.dumps({f"{k[0]} {k[2]}": v for k, v in captures.items()})
          + " (lr halved before the third batch-1 step), per replay "
          + json.dumps(replays) + f"; envelope data_ptr (g+, g-) before "
          f"{json.dumps(ptrs)} after {json.dumps(after)}")
    # stage by stage and against eager, outside the counted run
    erec = Recorder(ops)
    chip_mod.kernel_ops = erec
    results, stage_flips = [], 0
    try:
        for app, x, t, lr, before, entries, err, after_st in records:
            chip, ech = chips[app], eager[app]
            for (xs, ds, lr_t, dxs), st in zip(
                    entries, reversed(chip.placement.stages)):
                gp0, gm0 = before[st.index]
                close(dxs, xbk.crossbar_bwd_plain(ds, gp0, gm0),
                      f"{app} compiled stage {st.index} dx")
                want = xbk.pulse_update_plain(
                    gp0, gm0, xs, ds, lr=lr_t, max_dw=MAX_DW,
                    levels=LEVELS, w_max=W_MAX)
                counts = xbk.pulse_counts_plain(xs, ds, lr=lr_t,
                                                max_dw=MAX_DW, levels=LEVELS)
                stage_flips += check_conductances(
                    after_st[st.index], want, counts,
                    f"{app} compiled stage {st.index} g±")
            for s, (gp, gm) in enumerate(before):
                ech.placement.set_stage_stacks(s, gp.clone(), gm.clone())
            n = len(erec.calls["pulse_update_stacked"])
            err_e = ech.train_step(x, t, lr=lr)
            pulse = erec.calls["pulse_update_stacked"][n:]
            ours_e = chip_stage_inputs(ech, [(a[2], a[3], kw["lr"])
                                             for a, kw, _ in pulse])
            ours_c = chip_stage_inputs(chip, [e[:3] for e in entries])
            results.append(check_compiled_step(
                chip, ours_c, ours_e, stacks_to_layers(before, chip),
                stacks_to_layers(after_st, chip), clone_layers(ech), x, t,
                err, err_e, spec, lr))
        torch.cuda.synchronize()
    finally:
        chip_mod.kernel_ops = ops
    print(f"compiled training steps held against plain per stage "
          f"({stage_flips} pulse counts one apart at a half-integer) and "
          f"against eager (batch 1 x3, 4096 x2 mnist; 256 isolet): "
          + json.dumps(results))
    keys = {"infer_time", "infer_energy", "infer_io", "train_time",
            "train_energy", "train_io"}
    for chip in chips.values():
        cmp_ = chip.report().compare_hw(
            hw.network_cost(chip.name, list(chip.placement.dims)))
        if set(cmp_) != keys or not all(v <= 0.01 for v in cmp_.values()):
            raise AssertionError(f"{chip.name}: hw_model cross-validation "
                                 f"{cmp_}")
        print(f"{chip.name} compiled, after training: hw_model rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    return launches


def apply_grads(layers, x, target, spec, use_kernel: bool):
    """Gradients of a squared-error loss through ``crossbar_apply``; returns
    (leaf params, per-layer inputs, per-layer dot products with .grad)."""
    from repro_torch.core.crossbar import crossbar_apply, hard_sigmoid
    params = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in layers]
    ins, dps, h = [], [], x
    for li, p in enumerate(params):
        ins.append(h.detach())
        dp = crossbar_apply(p, h, spec, activation=False,
                            use_kernel=use_kernel, transport_in=li > 0)
        dp.retain_grad()
        dps.append(dp)
        h = hard_sigmoid(dp)
    ((h - target) ** 2).sum().backward()
    return params, ins, dps


def layer_vjp(p, a, g, spec, li, use_kernel):
    from repro_torch.core.crossbar import crossbar_apply
    leaves = [a.clone().requires_grad_(),
              p["g_plus"].detach().clone().requires_grad_(),
              p["g_minus"].detach().clone().requires_grad_()]
    y = crossbar_apply({"g_plus": leaves[1], "g_minus": leaves[2]},
                       leaves[0], spec, activation=False,
                       use_kernel=use_kernel, transport_in=li > 0)
    return torch.autograd.grad(y, leaves, g)


def apply_path(ops, layers, spec, gen) -> tuple[dict, float]:
    """crossbar_apply(use_kernel=True) gradients (module docstring, step
    6); returns (launch counts, max |kernel - plain|)."""
    names = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw")
    runs = []
    for n in names:
        getattr(ops, n).launches = 0
    for M in (64, 4096):
        x = uniform((M, 784), -0.5, 0.5, gen)
        t = uniform((M, 10), -0.5, 0.5, gen)
        runs.append(apply_grads(layers, x, t, spec, use_kernel=True))
    torch.cuda.synchronize()
    launches = {n: getattr(ops, n).launches for n in names}
    if launches != {n: 8 for n in names}:
        raise AssertionError(f"crossbar_apply(use_kernel=True) launches "
                             f"{launches}, expected 4 per run of 4 layers")
    max_err = 0.0
    for params, ins, dps in runs:
        for li, (p, a, dp) in enumerate(zip(params, ins, dps)):
            got = layer_vjp(p, a, dp.grad, spec, li, use_kernel=True)
            want = layer_vjp(p, a, dp.grad, spec, li, use_kernel=False)
            if not (torch.equal(got[1], p["g_plus"].grad)
                    and torch.equal(got[2], p["g_minus"].grad)):
                raise AssertionError("crossbar_matmul's gradients are not "
                                     "deterministic")
            for name, g, w in zip(("x", "g_plus", "g_minus"), got, want):
                max_err = max(max_err, close(
                    g, w, f"crossbar_apply layer {li} d/d{name} "
                          f"M={a.shape[0]}"))
    print(f"crossbar_apply(use_kernel=True) path: launches "
          f"{json.dumps(launches)} (M = 64 and 4096, 4 layers each), "
          f"gradients vs plain _xbar_matmul layer by layer: max |err| "
          f"{max_err:.3e}")
    return launches, max_err


# ---------------------------------------------------------------------------
# k-means kernel phase and the paper-apps path (autoencoder dimensionality
# reduction -> k-means -> anomaly detection)
# ---------------------------------------------------------------------------

FP32_INSTR_S = 33.5e12   # fp32 adds per second: half the 67 TFLOP/s FMA rate
NEAR_TIE = 1e-5          # argmin flips allowed only where two distances are
                         # this close (relative, recomputed in float64)
# (n, d, k, what) of the kernel phase
KMEANS_CASES = [
    (2048, 20, 10, "clustering path (mnist_dimred features)"),
    (60000, 20, 10, "MNIST training-set size"),
    (2048, 20, 26, "isolet's 26 classes"),
    (65536, 32, 32, "the hardware core's 32 x 32 limit"),
    (65536, 128, 128, "the TPU tile limit"),
    (513, 10, 5, "ragged"),
    (4096, 20, 1, "k = 1"),
    (4096, 20, 30, "duplicated centers (10 centers 3 times)"),
]
APPS_PRETRAIN_EPOCHS = 2   # mnist_dimred pretraining (depth not cut)
APPS_ANOMALY_EPOCHS = 3    # kdd_anomaly pretraining


def kmeans_bound(n, d, k) -> tuple[float, float]:
    """(ms at the fp32 add rate, ms at the HBM rate) of one assignment:
    2 n k d operations (subtract, add with |.| as a modifier); x, centers
    read once, the int32 assignment written once."""
    return (2.0 * n * k * d / FP32_INSTR_S * 1e3,
            4.0 * (n * d + k * d + n) / HBM_BYTES_S * 1e3)


def near_tie_flips(x, c, got, want, what) -> int:
    """Assignments equal, except where the two smallest distances of a
    sample (float64) lie within NEAR_TIE relative and each side picked
    one of those two centers.  Returns the number of such samples."""
    off = torch.nonzero(got.long() != want.long()).flatten()
    if off.numel() == 0:
        return 0
    d = (x[off, None, :].double() - c[None, :, :].double()).abs().sum(-1)
    two = torch.sort(d, dim=1).values[:, :2]
    gap = (two[:, 1] - two[:, 0]) / two[:, 1].clamp(min=1e-30)
    rows = torch.arange(off.numel(), device=x.device)
    picked_ok = all(bool((d[rows, a[off].long()] <= two[:, 1]).all())
                    for a in (got, want))
    if bool((gap > NEAR_TIE).any()) or not picked_ok:
        raise AssertionError(f"{what}: {off.numel()} assignments differ, "
                             f"largest relative gap {float(gap.max()):.3e}")
    return int(off.numel())


def kmeans_kernel_phase(kmk, ops, gen) -> tuple[int, list[dict]]:
    """The k-means kernel at KMEANS_CASES: every tile of ``KMEANS_TILES``
    equal to the chain-order plain version (``kmeans_assign_chain``, the
    kernel's own sums) exactly, the picked tile against
    ``kmeans_assign_plain`` except at near-ties; timed through
    ``ops.kmeans_assign`` by CUDA events and by device time (``graph_ms``)
    beside the plain version, ``torch.cdist(p=1).argmin`` and the bound,
    with every tile's device time.  Returns (near-tie flips, rows).
    Launches here are not counted."""
    flips, rows, pins = 0, [], 0
    for n, d, k, what in KMEANS_CASES:
        x = uniform((n, d), -0.5, 0.5, gen)
        if what.startswith("duplicated"):
            c = x[:10].repeat(3, 1).contiguous()   # exact ties, rows of x
        else:
            c = uniform((k, d), -0.5, 0.5, gen)
        got = kmk.kmeans_assign_kernel(x, c)
        want = kmk.kmeans_assign_plain(x, c)
        chain = kmk.kmeans_assign_chain(x, c)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != (n,):
            raise AssertionError(f"kmeans_assign {what}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        for t in range(len(kmk.KMEANS_TILES)):
            a = kmk.kmeans_assign_kernel(x, c, tile=t)
            if not torch.equal(a, chain):
                raise AssertionError(f"kmeans_assign {what}: tile {t} vs the "
                                     f"chain-order plain version, "
                                     f"{differing(a, chain)}")
            pins += 1
        case_flips = near_tie_flips(x, c, got, want,
                                    f"kmeans_assign {what}")
        if what.startswith("duplicated") and bool((got >= 10).any()):
            raise AssertionError("kmeans_assign: an exact tie did not go to "
                                 "the lowest index")
        if k == 1 and bool((got != 0).any()):
            raise AssertionError("kmeans_assign: k = 1 gave a nonzero index")
        flips += case_flips
        op_ms, byte_ms = kmeans_bound(n, d, k)
        by_tile = [round(graph_ms(lambda: kmk.kmeans_assign_kernel(
            x, c, tile=t)), 5) for t in range(len(kmk.KMEANS_TILES))]
        rows.append({
            "kernel": "kmeans_assign", "n": n, "d": d, "k": k, "case": what,
            "near_tie_flips": case_flips, "tile": kmk.kmeans_tile(n, d, k),
            "ms": cuda_ms(lambda: ops.kmeans_assign(x, c), iters=200),
            "ms_device": graph_ms(lambda: ops.kmeans_assign(x, c)),
            "plain_ms": cuda_ms(lambda: kmk.kmeans_assign_plain(x, c)),
            "library_ms": cuda_ms(
                lambda: torch.cdist(x, c, p=1).argmin(1)),
            "library_ms_device": graph_ms(
                lambda: torch.cdist(x, c, p=1).argmin(1)),
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "ms_device_by_tile": by_tile})
    print(f"kmeans kernel phase: {len(KMEANS_CASES)} cases, every tile "
          f"equal to the chain-order plain version ({pins} (case, tile) "
          f"pairs); the pick equal to plain except {flips} near-tie flips "
          f"(two distances within {NEAR_TIE} relative); exact ties to the "
          f"lowest index")
    return flips, rows


def host_us(fn, calls: int = 500) -> float:
    """Host time per call of ``fn`` in microseconds: a host clock around
    ``calls`` calls that do not wait for the card (at a shape the card
    finishes sooner, the enqueue is what is timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def wrapper_host_phase(xbk, ops, gen) -> dict:
    """The bwd and k-means wrappers (``ops.crossbar_bwd_stacked``,
    ``ops.kmeans_assign``) by CUDA events against device time: the eager
    mnist step's four bwd stacks at M = 4096 and the clustering path's
    (2048, 20, 10); and each wrapper's host time per call at a shape the
    card finishes sooner ((1, 64, 400, 100); (2048, 20, 10))."""
    out = {"bwd mnist step 4 stacks events ms": 0.0,
           "bwd mnist step 4 stacks device ms": 0.0}
    for T, K, N in TRAIN_SHAPES["mnist_class"]:
        d = uniform((T, 4096, N), -0.05, 0.05, gen)
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        out["bwd mnist step 4 stacks events ms"] += cuda_ms(
            lambda: ops.crossbar_bwd_stacked(d, gp, gm))
        out["bwd mnist step 4 stacks device ms"] += graph_ms(
            lambda: ops.crossbar_bwd_stacked(d, gp, gm))
    d = uniform((1, 64, 100), -0.05, 0.05, gen)
    gp = uniform((1, 400, 100), 0.3, 0.7, gen)
    gm = uniform((1, 400, 100), 0.3, 0.7, gen)
    out["bwd (1, 64, 400, 100) events us"] = 1e3 * cuda_ms(
        lambda: ops.crossbar_bwd_stacked(d, gp, gm), iters=200)
    out["bwd (1, 64, 400, 100) device us"] = 1e3 * graph_ms(
        lambda: ops.crossbar_bwd_stacked(d, gp, gm))
    out["bwd host us per call"] = host_us(
        lambda: ops.crossbar_bwd_stacked(d, gp, gm))
    x, c = uniform((2048, 20), -0.5, 0.5, gen), uniform((10, 20), -0.5, 0.5,
                                                        gen)
    out["kmeans (2048, 20, 10) events us"] = 1e3 * cuda_ms(
        lambda: ops.kmeans_assign(x, c), iters=200)
    out["kmeans (2048, 20, 10) device us"] = 1e3 * graph_ms(
        lambda: ops.kmeans_assign(x, c))
    out["kmeans host us per call"] = host_us(lambda: ops.kmeans_assign(x, c))
    return out


def purity(assign: torch.Tensor, labels: torch.Tensor, k: int) -> float:
    a, lab = assign.long().cpu(), labels.long().cpu()
    return sum(int(torch.bincount(lab[a == c]).max())
               for c in range(k) if bool((a == c).any())) / len(lab)


def paper_apps_path(ops) -> dict:
    """The paper-apps path at full width (module docstring, step 9):
    mnist_dimred pretraining -> encode -> k-means++ -> kmeans_fit on the
    kernel, then kdd_anomaly scoring.  Draws come from a CPU generator
    (``SEED``), the same on every device.  Returns the launch count, the
    stage times and the path's numbers."""
    from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
    from repro_torch.core import anomaly, autoencoder as ae, kmeans
    from repro_torch.data import synthetic as syn

    g = torch.Generator().manual_seed(SEED)
    x, labels = syn.mnist_like(g, 2048, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ops.kmeans_assign.launches = 0
    marks[0].record()
    enc_layers, curves = ae.pretrain_stack(
        g, x, NETWORKS["mnist_dimred"], PAPER_SPEC, lr=0.05,
        epochs=APPS_PRETRAIN_EPOCHS, batch=16)
    marks[1].record()
    feats = ae.encode(enc_layers, x, PAPER_SPEC)
    marks[2].record()
    init = kmeans.init_plusplus(g, feats, 10)
    centers, assign, inertia = kmeans.kmeans_fit(feats, init, epochs=15,
                                                 use_kernel=True)
    marks[3].record()
    fit_launches = ops.kmeans_assign.launches
    again = kmeans.assign(feats, centers, use_kernel=True)
    normal, attack = syn.kdd_like(g, 4096, 1024, device="cuda")
    enc, dec, ae_losses = ae.pretrain_layer(
        g, normal, *NETWORKS["kdd_anomaly"][:2], PAPER_SPEC, lr=0.03,
        epochs=APPS_ANOMALY_EPOCHS, batch=16)
    s_n = anomaly.reconstruction_error([enc, dec], normal, PAPER_SPEC)
    s_a = anomaly.reconstruction_error([enc, dec], attack, PAPER_SPEC)
    marks[4].record()
    torch.cuda.synchronize()
    launches = ops.kmeans_assign.launches
    if (fit_launches, launches) != (1, 2):
        raise AssertionError(f"kmeans_assign launches: {fit_launches} in "
                             f"kmeans_fit, {launches} in all; expected one "
                             f"per kernel-routed call (1, 2)")
    if feats.shape != (2048, 20) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"features {tuple(feats.shape)} not finite")
    if not torch.equal(again, assign):
        raise AssertionError("two launches on the same inputs differ")
    flips = near_tie_flips(feats, centers, assign,
                           kmeans.assign(feats, centers), "kmeans_fit")
    rises = torch.diff(inertia)
    if bool((rises > 1e-3).any()):
        raise AssertionError(f"inertia rose by {float(rises.max())}")
    for what, t in (("pretraining losses", torch.cat(curves)),
                    ("anomaly losses", ae_losses), ("normal scores", s_n),
                    ("attack scores", s_a), ("centers", centers)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"paper-apps path: {what} not finite")
    det = anomaly.detection_at_fpr(s_n, s_a, max_fpr=0.04)
    auc = anomaly.auc(s_n, s_a)
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]
    out = {
        "kmeans_assign launches": launches, "near_tie_flips": flips,
        "purity": purity(assign, labels, 10),
        "inertia first, last": [float(inertia[0]), float(inertia[-1])],
        "pretrain loss per layer, first -> last epoch": [
            [float(c[0]), float(c[-1])] for c in curves],
        "anomaly detection at 4% FPR": det, "anomaly AUC": auc,
        "ms": {"pretrain_stack 784-300-200-100-20": ms[0],
               "encode": ms[1], "init_plusplus + kmeans_fit": ms[2],
               "assign + kdd_anomaly draw, pretrain, scoring": ms[3]}}
    print(f"paper-apps path: kmeans_assign launches {launches} (1 in "
          f"kmeans_fit(use_kernel=True), 1 in assign(use_kernel=True)); "
          f"kernel vs plain assign on the fitted centers: {flips} near-tie "
          f"flips; inertia non-increasing; purity {out['purity']:.4f}; "
          f"detection at 4% FPR {det * 100:.2f}% (paper: 96.6%), AUC "
          f"{auc:.4f}")
    print("paper-apps path: " + json.dumps(out))
    return out


# -- the LM serving path (qwen2-0.5b at full width) and the flash kernel ----

FA_TOL = 2e-5            # fp32 kernel vs plain: the reference's kernel bar
# (B, S, H, K, hd, causal, dtype, what) of the flash kernel phase
FLASH_CASES = [
    (4, 2048, 14, 2, 64, True, "bfloat16", "qwen2-0.5b prefill"),
    (4, 2048, 14, 2, 64, True, "float32", "qwen2-0.5b prefill, fp32"),
    (1, 4096, 32, 4, 128, True, "bfloat16", "yi-6b heads"),
    (2, 1000, 14, 2, 64, True, "bfloat16", "ragged S = 1000"),
    (2, 384, 8, 2, 64, False, "float32", "non-causal"),
    (2, 512, 8, 8, 64, True, "float32", "MHA (G = 1)"),
    (2, 64, 4, 2, 16, True, "float32", "test_kernels shape 1"),
    (1, 128, 2, 1, 32, True, "float32", "test_kernels shape 2"),
    (2, 64, 4, 4, 16, False, "float32", "test_kernels shape 3"),
    (1, 256, 2, 2, 64, True, "float32", "test_kernels shape 4"),
]
LM_ARCH = "qwen2-0.5b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SERVE_BATCH, SERVE_MAX_LEN, SERVE_NEW = 4, 256, 32
# decode logits against prefill logits at full width: bf16 compute and
# cache, every product's output rounded to bf16 (a step of 2^-6 at
# |logit| in [2, 4)) and summed in other orders through 24 layers: 8 such
# steps.  float32 compute and cache, TF32 off: summation order only.
LOGIT_BAR = {"bfloat16": 0.125, "float32": 1e-3}


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_flash(got, want, dtype, what, semantics="pallas",
                wam=None) -> float:
    """Hold a flash kernel's output against its plain version; raises
    unless every |got - want| is within the bar, returns the largest.

    fp32: FA_TOL (1 + |want|), the reference's kernel bar.  bf16, the
    Pallas function: one bf16 step at max(|got|, |want|), plus 1e-6: both
    sides hold p to 24 bits (the tensor-core kernel as three bf16 terms)
    and round an fp32 value once.

    bf16, the chunked function against the plain version at 512-key
    chunks: one bf16 step at max(|got|, |want|) plus 2^-8 wam, wam =
    sum_j p_j |v_j| / l from the plain side in fp32.  Both sides compute
    o = sum_j bf16(p~_j) v_j / l with p~_j = exp(s_j - m'), m' the running
    max when key j's block is reached.  The kernel's block is 64 keys and
    this plain version's chunk 512, so m' and with it the rounding of p~_j
    differ; each rounding is within half a bf16 step, at most 2^-8 p~_j,
    so after the exact rescaling to the final max the two p_j differ by
    at most 2^-7 p_j.  Those errors have independent signs from key to
    key, so the two fp32 outputs differ by far less than 2^-7 wam; the
    run prints the largest excess over one step as a share of wam (the
    margin under 2^-8).  Each side then rounds to bf16, at most half a
    step at its own magnitude: one step at the larger, in all.  Random
    inputs make |o| small beside wam, so a bar in steps of |o| alone would
    be wrong.  This bar cannot tell the two functions apart (rounding p
    moves o by about as much); ``check_chunked_tile`` and
    ``check_functions`` do."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == "float32":
        bar = FA_TOL + FA_TOL * want.abs()
    elif semantics == "chunked":
        bar = bf16_step(torch.maximum(got.abs(), want.abs())) + 2.0 ** -8 * wam
    else:
        bar = bf16_step(torch.maximum(got.abs(), want.abs())) + 1e-6
    if not bool(torch.isfinite(got).all()) or not bool((err <= bar).all()):
        raise AssertionError(f"flash_attention {what} ({semantics}): max "
                             f"|err| {float(err.max())}")
    return float(err.max())


def flash_bound(B, Sq, Skv, H, K, hd, causal, dtype, semantics,
                window=None) -> tuple[float, float, float]:
    """(ms at the products' peak, ms at the HBM rate, ms of the
    exponentials at the special-function rate) of one call.  Per (query,
    visible key) pair: 2 B H hd FLOPs in each product and one exp; a
    causal call has sum_i min(i + 1, Skv, window) pairs.  bf16
    operands run the products on the tensor cores (989 TFLOP/s): two for
    the chunked function, four for the Pallas one (p . v as p_hi . v +
    p_mid . v + p_lo . v); fp32 operands run both at the fp32 rate.  q,
    k, v read once and the output written once."""
    limit = Skv if window is None else min(Skv, window)
    pairs = (sum(min(i + 1, limit) for i in range(Sq)) if causal
             else Sq * Skv)
    product = 2.0 * B * H * hd * pairs
    if dtype == torch.bfloat16:
        n = 2 if semantics == "chunked" else 4
        op_s = n * product / BF16_FLOPS
    else:
        op_s = 2 * product / FP32_FLOPS
    moved = (torch.finfo(dtype).bits // 8) * (2 * B * Sq * H * hd
                                              + 2 * B * Skv * K * hd)
    return (op_s * 1e3, moved / HBM_BYTES_S * 1e3,
            B * H * pairs / EXP_RATE * 1e3)


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spills and static shared memory of each kernel instance
    in a build log (``nvcc -Xptxas -v``), by mangled name."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return out


def flash_instance(report, dtype, hd, semantics) -> dict:
    """The ptxas numbers and the dynamic shared memory of the kernel
    instance a call runs: ``flash_tc_fwd<hd, chunked>`` for bf16 (two q
    tiles and two stages of k and v), ``flash_fwd<ceil(hd/16), chunked>``
    for fp32 (1, 2, 4, 8 or 16 accumulator columns)."""
    chunked = int(semantics == "chunked")
    if dtype == torch.bfloat16:
        key, smem = f"flash_tc_fwdILi{hd}ELb{chunked}E", 6 * 64 * hd * 2
    else:
        dc = next(d for d in (1, 2, 4, 8, 16) if hd <= 16 * d)
        key = f"flash_fwdILi{dc}ELb{chunked}E"
        smem = 4 * ((64 + 64) * (hd | 1) + 64 * 16 * dc + 64 * (64 + 16))
    found = [v for k, v in report.items() if key in k]
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} instances match "
                             f"{key}")
    return {**found[0], "dynamic_smem": smem}


def weighted_abs_mean(fak, q, k, v, scale, causal,
                      window=None) -> torch.Tensor:
    """sum_j p_j |v_j| / l in fp32, p the plain (Pallas) softmax; with a
    window the chunked function in fp32 (where rounding p to v's dtype is
    a no-op), banded."""
    if window is not None:
        return fak.chunked_attention_plain(
            q.float(), k.float(), v.float().abs(), scale=scale,
            causal=causal, window=window)
    return fak.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     scale=scale, causal=causal)


def plain_attention(fak, semantics, q, k, v, scale, causal, kv_chunk=512,
                    window=None):
    """The plain version of ``semantics``: the chunked function at
    ``kv_chunk`` x ``kv_chunk`` chunks (the reference's 512 unless given),
    banded to ``window`` if given, or the Pallas function."""
    if semantics == "chunked":
        return fak.chunked_attention_plain(q, k, v, scale=scale,
                                           causal=causal, q_chunk=kv_chunk,
                                           kv_chunk=kv_chunk, window=window)
    return fak.flash_attention_plain(q, k, v, scale=scale, causal=causal)


def max_weighted_term(q, k, v, scale, causal, block=64,
                      window=None) -> torch.Tensor:
    """max_j p_j |v_j| / l of each output in fp32, p the plain softmax
    (banded to ``window`` if given); ``block`` queries at a time."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kf = k.float()
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    keys = torch.arange(Skv, device=q.device)[None, :]
    out = torch.empty((B, Sq, H, hd), device=q.device)
    for i0 in range(0, Sq, block):
        qb = q[:, i0:i0 + block].float()
        n = qb.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs",
                         qb.reshape(B, n, K, H // K, hd), kf) * scale
        rows = i0 + torch.arange(n, device=q.device)[:, None]
        if causal:
            s = s.masked_fill(keys > rows, -1e30)
        if window is not None:
            s = s.masked_fill(keys <= rows - window, -1e30)
        p = torch.softmax(s, dim=-1)                   # (B, K, G, n, Skv)
        t = (p[..., None] * va).amax(dim=-2)           # (B, K, G, n, hd)
        out[:, i0:i0 + n] = t.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd)
    return out


def check_chunked_tile(fak, got, q, k, v, scale, causal, what,
                       window=None):
    """Hold the bf16 kernel's chunked function against the plain chunked
    function at the kernel's own 64-key tiles; raises unless every
    |got - want| <= one bf16 step at max(|got|, |want|) + 1e-6 + 2^-7
    max_j p_j |v_j| / l, returns (max |err|, the plain output).

    With the same tiles both sides round each p~_j against the same
    running max; only their fp32 scores differ (q . k summed in other
    orders), in the last bit.  A p~_j at a bf16 rounding boundary may then
    round one bf16 step (at most 2^-7 p~_j) apart, which moves the output
    by at most 2^-7 p_j |v_j| / l, and each side rounds the output once.
    The Pallas function, whose p is not rounded, lies up to 2^-8 p_j |v_j|
    / l away at every key, not at a few, and fails this bar on short rows
    (tests/test_torch_chunked_attention.py shows it on the CPU);
    ``check_functions`` tells the two apart at every shape."""
    want = plain_attention(fak, "chunked", q, k, v, scale, causal,
                           kv_chunk=64, window=window)
    g, w = got.float(), want.float()
    bar = (bf16_step(torch.maximum(g.abs(), w.abs())) + 1e-6
           + 2.0 ** -7 * max_weighted_term(q, k, v, scale, causal,
                                           window=window))
    err = (g - w).abs()
    if not bool((err <= bar).all()):
        raise AssertionError(f"flash_attention {what} (chunked, 64-key "
                             f"tiles): max |err| {float(err.max())}, "
                             f"{int((err > bar).sum())} outputs past the bar")
    return float(err.max()), want


def check_functions(got, want, what) -> dict:
    """Each bf16 kernel function nearer its own plain version than the
    other function's: the mean |kernel - plain| of ``got[sem]`` against
    ``want[sem]`` at most a quarter of that against the other function's
    plain version, for both functions; raises otherwise, returns the four
    means.  Rounding p to bf16 moves an output by about one step as often
    as not, while the same function on both sides differs only where an
    fp32 last bit moves a rounding: so a kernel that computed the other
    function, or a semantics flag wired backwards, fails."""
    mean = {f"{a} vs plain {b}": float((got[a].float() - want[b].float()
                                        ).abs().mean())
            for a in ("chunked", "pallas") for b in ("chunked", "pallas")}
    for a, b in (("chunked", "pallas"), ("pallas", "chunked")):
        if not 4 * mean[f"{a} vs plain {a}"] <= mean[f"{a} vs plain {b}"]:
            raise AssertionError(f"flash_attention {what}: the {a} kernel "
                                 f"is not nearer its own function: {mean}")
    return mean


def device_ms(fn, name: str) -> tuple[float, str]:
    """Device time per call of the kernel ``name`` in ``fn`` and how it was
    taken: "profiler" (``profile_device``), or "events" (``cuda_ms`` over
    back-to-back calls) where the profiler records no device activity."""
    prof = profile_device(fn, reps=5)
    if prof["device_busy_ms"] is None:
        return cuda_ms(fn, iters=10), "events"
    found = [t["ms"] for t in prof["top"] if f"::{name}<" in t["kernel"]]
    if len(found) != 1:
        raise AssertionError(f"the profile of {name} shows {prof['top']}")
    return found[0], "profiler"


def flash_case(fak, gen, report, B, Sq, Skv, H, K, hd, causal, dt,
               what) -> tuple[float, list[dict]]:
    """One shape of a flash phase: q (B, Sq, H, hd), k and v (B, Skv, K,
    hd) from ``gen``, each of the reference's two functions launched and
    held against its plain version (``check_flash``; bf16 also
    ``check_chunked_tile`` and ``check_functions``), timed (CUDA events,
    and the device time by ``device_ms``) beside the plain version,
    ``scaled_dot_product_attention`` on (B, H, S, hd) transposes made
    outside the timed region, and the bound.  Returns (max |err|, one row
    per function).  Launches here are not counted."""
    import torch.nn.functional as F
    dtype = getattr(torch, dt)
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, K, hd), generator=gen, device="cuda"
                    ).to(dtype)
    v = torch.randn((B, Skv, K, hd), generator=gen, device="cuda"
                    ).to(dtype)
    scale = hd ** -0.5
    wam = (weighted_abs_mean(fak, q, k, v, scale, causal)
           if dtype == torch.bfloat16 else None)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True),
        iters=10)
    name = "flash_tc_fwd" if dtype == torch.bfloat16 else "flash_fwd"
    worst, rows, outs, plains = 0.0, [], {}, {}
    for sem in ("chunked", "pallas"):
        def run():
            return fak.flash_attention_kernel(q, k, v, scale=scale,
                                              causal=causal, semantics=sem)
        got = outs[sem] = run()
        want = plain_attention(fak, sem, q, k, v, scale, causal)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != (B, Sq, H, hd):
            raise AssertionError(f"flash_attention {what}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        err = check_flash(got, want, dt, what, sem, wam)
        worst = max(worst, err)
        checks = {}
        if dtype == torch.bfloat16 and sem == "chunked":
            over = ((got.float() - want.float()).abs()
                    - bf16_step(torch.maximum(got.float().abs(),
                                              want.float().abs())))
            checks["excess over one step / wam, 512-key plain"] = float(
                (over / wam).max())
            tile_err, plains["chunked"] = check_chunked_tile(
                fak, got, q, k, v, scale, causal, what)
            checks["max_abs_err, 64-key plain"] = tile_err
            worst = max(worst, tile_err)
        elif dtype == torch.bfloat16:
            plains["pallas"] = want
        op_ms, byte_ms, exp_ms = flash_bound(B, Sq, Skv, H, K, hd, causal,
                                             dtype, sem)
        dev_ms, dev_by = device_ms(run, name)
        rows.append({
            "kernel": "flash_attention", "B": B, "S": Sq, "Skv": Skv,
            "H": H, "K": K, "hd": hd, "causal": causal, "dtype": dt,
            "case": what, "semantics": sem, "route": fak.route(dtype),
            "max_abs_err": err,
            "ms": cuda_ms(run, iters=10),
            "device_ms": dev_ms, "device_ms_by": dev_by,
            "plain_ms": cuda_ms(lambda: plain_attention(
                fak, sem, q, k, v, scale, causal), iters=5),
            "library_ms": library_ms,
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "exp_bound_ms": exp_ms,
            **checks,
            **flash_instance(report, dtype, hd, sem)})
        del got, want
    if dtype == torch.bfloat16:
        means = check_functions(outs, plains, what)
        for r in rows:
            r["mean |err| by function"] = means
    return worst, rows


def print_flash_rows(rows: list[dict]) -> None:
    for r in rows:
        print(f"  {r['case']:<28} {r['semantics']:<8} {r['route']:<6} "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} by "
              f"{r['device_ms_by']}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), exp co-bound "
              f"{r['exp_bound_ms']:.4f}, plain {r['plain_ms']:.3f}, SDPA "
              f"{r['library_ms']:.4f}; {r['registers']} registers, "
              f"{r['spill_stores']}/{r['spill_loads']} B spilled, "
              f"{r['dynamic_smem']} B dynamic shared memory")
        if "max_abs_err, 64-key plain" in r:
            print(f"    chunked: max |err| against 64-key tiles "
                  f"{r['max_abs_err, 64-key plain']:.3e}; largest excess "
                  f"over one step against 512-key chunks "
                  f"{r['excess over one step / wam, 512-key plain']:.3e} "
                  f"of sum p|v|/l (bar 2^-8); mean |err| by function "
                  + json.dumps(r["mean |err| by function"]))


def flash_kernel_phase(fak, ops, gen, report) -> tuple[float, list[dict]]:
    """The flash kernels against their plain versions at FLASH_CASES, each
    row in both of the reference's functions (and, on strided views,
    through the model's wrapper ``ops.flash_attention``), timed (CUDA
    events, and the device time by ``device_ms``) beside the plain
    version, ``scaled_dot_product_attention`` on (B, H, S, hd) transposes
    made outside the timed region, and the bound; bf16 rows also go
    through ``check_chunked_tile`` and ``check_functions``.  Returns (max
    |err|, rows).  Launches here are not counted."""
    worst, rows = 0.0, []
    for B, S, H, K, hd, causal, dt, what in FLASH_CASES:
        err, case_rows = flash_case(fak, gen, report, B, S, S, H, K, hd,
                                    causal, dt, what)
        worst = max(worst, err)
        rows += case_rows
    # strided operands through the model's wrapper: q, k, v as (B, S,
    # heads, hd) views of (B, heads, S, hd) buffers.  fp32 goes to its
    # kernel as it is, read through the strides; bf16 views with 16-byte
    # aligned rows go uncopied, a view whose rows are not 16-byte aligned
    # is copied contiguous and counted on operand_copies.
    views = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        qb = torch.randn((2, 14, 300, 64), generator=gen, device="cuda")
        kb = torch.randn((2, 2, 300, 64), generator=gen, device="cuda")
        vb = torch.randn((2, 2, 300, 64), generator=gen, device="cuda")
        views[dt] = [t.to(dtype).transpose(1, 2) for t in (qb, kb, vb)]
    wide = torch.randn((2, 300, 2, 68), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    views["bfloat16, k heads 136 bytes apart"] = [
        views["bfloat16"][0], wide[..., :64], views["bfloat16"][2]]
    for what, (q, k, v) in views.items():
        dt = "float32" if q.dtype == torch.float32 else "bfloat16"
        for sem in ("chunked", "pallas"):
            before = ops.flash_attention.launches
            copies = fak.flash_attention_kernel.operand_copies
            got = ops.flash_attention(q, k, v, scale=0.125, semantics=sem)
            if ops.flash_attention.launches != before + 1:
                raise AssertionError("ops.flash_attention did not launch "
                                     "the kernel on strided CUDA views")
            copied = fak.flash_attention_kernel.operand_copies - copies
            if copied != (1 if "136 bytes" in what else 0):
                raise AssertionError(f"strided views ({what}): {copied} "
                                     f"operands copied")
            want = plain_attention(fak, sem, q.contiguous(), k.contiguous(),
                                   v.contiguous(), 0.125, True)
            wam = (weighted_abs_mean(fak, q, k, v, 0.125, True)
                   if dt == "bfloat16" else None)
            worst = max(worst, check_flash(got, want, dt,
                                           f"strided views, {what}", sem,
                                           wam))
    print(f"flash kernel phase: {len(FLASH_CASES)} shapes x 2 functions + "
          f"strided views within their bars (fp32 {FA_TOL} abs + rel; "
          f"bf16 Pallas one bf16 step at the larger |value| + 1e-6; bf16 "
          f"chunked one step + 2^-8 sum p|v|/l, and against 64-key tiles "
          f"one step + 2^-7 max p|v|/l; each bf16 function at most a "
          f"quarter as far from its own plain version on average as from "
          f"the other's); max |err| {worst:.3e}")
    print_flash_rows(rows)
    return worst, rows


# (B, Sq, Skv, H, K, hd, dtype, what) of the non-causal flash phase: the
# seamless encoder's bidirectional self-attention and its decoder's
# cross-attention at their prefill shape (4 x 2048 on 2048 source frames,
# 16 heads on 16, hd 64), and query and key lengths apart, with a ragged
# Skv (not a multiple of the 64-key tile) and GQA, in both sources
ENCDEC_FLASH_CASES = [
    (4, 2048, 2048, 16, 16, 64, "bfloat16", "seamless enc / cross"),
    (4, 2048, 2048, 16, 16, 64, "float32", "seamless enc / cross, fp32"),
    (2, 512, 1500, 8, 8, 64, "bfloat16", "Sq < Skv = 1500"),
    (2, 512, 1500, 8, 8, 64, "float32", "Sq < Skv = 1500, fp32"),
    (2, 1500, 1000, 8, 2, 64, "bfloat16", "Sq > Skv = 1000, GQA"),
    (2, 1500, 1000, 8, 2, 64, "float32", "Sq > Skv = 1000, GQA, fp32"),
]


def flash_cross_phase(fak, gen, report) -> tuple[float, list[dict]]:
    """Both flash sources non-causal at ENCDEC_FLASH_CASES (``flash_case``
    at Sq and Skv apart, the rows' ``Skv``): the seamless shape beside
    SDPA and the bound, Sq < Skv and Sq > Skv with ragged key tiles, each
    in both functions under the flash phase's bars.  Returns (max |err|,
    rows).  Launches here are not counted."""
    worst, rows = 0.0, []
    for B, Sq, Skv, H, K, hd, dt, what in ENCDEC_FLASH_CASES:
        err, case_rows = flash_case(fak, gen, report, B, Sq, Skv, H, K, hd,
                                    False, dt, what)
        worst = max(worst, err)
        rows += case_rows
    print(f"flash cross phase: {len(ENCDEC_FLASH_CASES)} non-causal shapes "
          f"(Sq = Skv at seamless's prefill, Sq < Skv and Sq > Skv with "
          f"ragged key tiles) x 2 functions within the flash phase's bars; "
          f"max |err| {worst:.3e}")
    print_flash_rows(rows)
    return worst, rows


# (B, S, H, K, hd, window, dtype, what) of the windowed and hd-256 flash
# phase: recurrentgemma-9b's local layer (16 heads on 1, hd 256, window
# 2048) at its prefill shape, hd 256 without a window (both functions),
# a ragged S with a window, window 1
HYBRID_FLASH_CASES = [
    (2, 4096, 16, 1, 256, 2048, "bfloat16", "recurrentgemma local layer"),
    (2, 4096, 16, 1, 256, 2048, "float32",
     "recurrentgemma local layer, fp32"),
    (1, 4096, 16, 1, 256, None, "bfloat16", "hd 256, no window"),
    (1, 4096, 16, 1, 256, None, "float32", "hd 256, no window, fp32"),
    (2, 1000, 14, 2, 64, 100, "bfloat16", "ragged S = 1000, window 100"),
    (2, 1000, 14, 2, 64, 100, "float32",
     "ragged S = 1000, window 100, fp32"),
    (1, 512, 8, 2, 128, 1, "bfloat16", "window 1"),
    (1, 512, 8, 2, 128, 1, "float32", "window 1, fp32"),
]
WINDOW_AT_LEAST_S = (2, 1000, 16, 1, 256)   # (B, S, H, K, hd)


def band_mask(S: int, window: int | None) -> torch.Tensor:
    """(S, S) bool, True where query i sees key j: j <= i, and i - window
    < j with a window."""
    i = torch.arange(S, device="cuda")
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    return mask


def flash_window_phase(fak, gen, report) -> tuple[float, list[dict]]:
    """Both flash sources with a window and at hd 256 (HYBRID_FLASH_CASES),
    causal, against their plain versions under the phase's bars (a window
    in the chunked function only; hd 256 without one in both functions),
    timed beside the plain version, ``scaled_dot_product_attention`` with
    a boolean band mask on (B, H, S, hd) transposes with the kv heads
    expanded (made outside the timed region; the port never calls it) and
    the bound over the band's pairs; then a window of S and of 10^6 bit
    for bit the causal kernel, in bf16 and fp32.  Returns (max |err|,
    rows).  Launches here are not counted."""
    import torch.nn.functional as F
    worst, rows = 0.0, []
    for B, S, H, K, hd, window, dt, what in HYBRID_FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda"
                               ).to(dtype) for n in (H, K, K))
        scale = hd ** -0.5
        bf16 = dtype == torch.bfloat16
        wam = (weighted_abs_mean(fak, q, k, v, scale, True, window)
               if bf16 else None)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        mask = band_mask(S, window)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), iters=5, warmup=1)
        name = "flash_tc_fwd" if bf16 else "flash_fwd"
        sems = ("chunked",) if window is not None else ("chunked", "pallas")
        outs, plains = {}, {}
        for sem in sems:
            def run():
                return fak.flash_attention_kernel(
                    q, k, v, scale=scale, causal=True, semantics=sem,
                    window=window)
            got = outs[sem] = run()
            want = plain_attention(fak, sem, q, k, v, scale, True,
                                   window=window)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (B, S, H, hd):
                raise AssertionError(f"flash_attention {what}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = check_flash(got, want, dt, what, sem, wam)
            worst = max(worst, err)
            checks = {}
            if bf16 and sem == "chunked":
                tile_err, plains["chunked"] = check_chunked_tile(
                    fak, got, q, k, v, scale, True, what, window)
                checks["max_abs_err, 64-key plain"] = tile_err
                worst = max(worst, tile_err)
            elif bf16:
                plains["pallas"] = want
            op_ms, byte_ms, exp_ms = flash_bound(B, S, S, H, K, hd, True,
                                                 dtype, sem, window)
            dev_ms, dev_by = device_ms(run, name)
            rows.append({
                "kernel": "flash_attention", "B": B, "S": S, "H": H,
                "K": K, "hd": hd, "window": window, "dtype": dt,
                "case": what, "semantics": sem, "route": fak.route(dtype),
                "max_abs_err": err,
                "ms": cuda_ms(run, iters=10),
                "device_ms": dev_ms, "device_ms_by": dev_by,
                "plain_ms": cuda_ms(lambda: plain_attention(
                    fak, sem, q, k, v, scale, True, window=window),
                    iters=3, warmup=1),
                "library_ms": library_ms,
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "exp_bound_ms": exp_ms,
                **checks,
                **flash_instance(report, dtype, hd, sem)})
            del got, want
        if bf16 and len(sems) == 2:
            means = check_functions(outs, plains, what)
            for r in rows[-2:]:
                r["mean |err| by function"] = means
        del q, k, v, qt, kt, vt, mask, wam, outs, plains
    B, S, H, K, hd = WINDOW_AT_LEAST_S
    for dt in ("bfloat16", "float32"):
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda"
                               ).to(getattr(torch, dt)) for n in (H, K, K))
        causal = fak.flash_attention_kernel(q, k, v, scale=hd ** -0.5,
                                            semantics="chunked")
        for window in (S, 10 ** 6):
            got = fak.flash_attention_kernel(q, k, v, scale=hd ** -0.5,
                                             semantics="chunked",
                                             window=window)
            if not torch.equal(got, causal):
                raise AssertionError(f"flash_attention {dt}, window "
                                     f"{window} >= S = {S}: not the causal "
                                     f"kernel's output bit for bit")
    print(f"flash window phase: {len(HYBRID_FLASH_CASES)} shapes (windows "
          f"2048, 100, 1 in the chunked function; hd 256 without a window "
          f"in both functions) within the phase's bars; windows {S} and "
          f"10^6 at (B, S, H, K, hd) = {WINDOW_AT_LEAST_S} bit for bit the "
          f"causal kernel in bf16 and fp32; max |err| {worst:.3e}")
    for r in rows:
        print(f"  {r['case']:<34} {r['semantics']:<8} {r['route']:<6} "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} by "
              f"{r['device_ms_by']}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), exp co-bound "
              f"{r['exp_bound_ms']:.4f}, plain {r['plain_ms']:.3f}, SDPA "
              f"(band mask) {r['library_ms']:.4f}; {r['registers']} "
              f"registers, {r['spill_stores']}/{r['spill_loads']} B "
              f"spilled, {r['dynamic_smem']} B dynamic shared memory")
    return worst, rows


def zero_flash_counts(ops) -> None:
    from repro_torch.kernels import flash_attention as fak
    ops.flash_attention.launches = 0
    fak.flash_attention_kernel.windowed = 0
    for key in fak_routes():
        fak_routes()[key] = 0


def check_flash_counts(ops, n: int, route: str, what: str) -> None:
    """Raise unless the flash wrapper launched exactly ``n`` times since
    the counts were set to 0, all on ``route`` in the chunked function."""
    routes = fak_routes()
    want = {key: (n if key == f"{route}/chunked" else 0) for key in routes}
    if ops.flash_attention.launches != n or routes != want:
        raise AssertionError(f"{what} ran flash_attention "
                             f"{ops.flash_attention.launches} times, routes "
                             f"{routes}; expected {want}")


def check_prefill_logits(logits, cfg, B: int, L: int) -> tuple:
    """Raise unless ``logits`` are (B, L, padded vocab) fp32, finite over
    the vocabulary and -1e30 in the pad columns; returns that shape."""
    want_shape = (B, L, cfg.padded_vocab)
    if logits.shape != want_shape or logits.dtype != torch.float32:
        raise AssertionError(f"{cfg.name} prefill logits "
                             f"{tuple(logits.shape)} {logits.dtype}, "
                             f"expected {want_shape}")
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{cfg.name} prefill logits not finite")
    if not bool((logits[..., cfg.vocab_size:] == -1e30).all()):
        raise AssertionError(f"{cfg.name} prefill pad columns are not "
                             f"-1e30")
    return want_shape


def lm_prefill_path(ops, model, params, route: str,
                    profile: bool = True) -> dict:
    """qwen2-0.5b ``prefill_fn`` at full width on 4 x 2048 tokens drawn
    from SEED, the flash counts set to 0 before and read after: 24
    launches (one per layer), all on ``route`` (``wgmma``, the tensor-core
    kernel, for bf16 compute; ``simt`` for float32) in the chunked
    function; logits (4, 2048, 152064) finite, pad columns -1e30.  Times
    the call (CUDA events) and, if ``profile``, profiles one."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}
    zero_flash_counts(ops)
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    routes = dict(fak_routes())
    check_flash_counts(ops, cfg.n_layers, route, f"prefill ({route})")
    want_shape = check_prefill_logits(logits, cfg, PREFILL_BATCH,
                                      PREFILL_LEN)
    del logits
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=3,
                 warmup=1)
    out = {"compute": cfg.compute_dtype,
           "flash_attention launches": launches,
           "flash_attention routes": routes,
           "prefill ms": ms,
           "prefill tokens/s": PREFILL_BATCH * PREFILL_LEN / ms * 1e3}
    pad = cfg.padded_vocab - cfg.vocab_size
    print(f"prefill path ({cfg.compute_dtype} compute): {LM_ARCH} at full "
          f"width, {PREFILL_BATCH} x {PREFILL_LEN} tokens: {launches} "
          f"flash_attention launches (one per layer, all {route}/chunked: "
          f"the {'tensor' if route == 'wgmma' else 'CUDA'}-core kernel in "
          f"chunked_attention's function), logits {want_shape} finite, "
          f"{pad} pad columns -1e30; {ms:.3f} ms per call, "
          f"{out['prefill tokens/s']:.0f} tokens/s")
    if profile:
        out["profile"] = profile_device(
            lambda: model.prefill_fn(params, batch), reps=1)
        print("prefill profile (profiler on): "
              + json.dumps(out["profile"]))
    return out


def fak_routes() -> dict[str, int]:
    """The flash kernels' launch counts by route and function."""
    from repro_torch.kernels import flash_attention as fak
    return fak.flash_attention_kernel.routes


def decode_against_prefill(ops, model, params, BatchedServer,
                           compute: str) -> dict:
    """``BatchedServer`` (its captured decode step) serves the CLI's
    prompts (39 steps, 128 tokens), recording each step's logits; then
    ``prefill_fn`` on every slot's prompt + generated tokens.  The decode
    logits at each of the 39 positions must equal the prefill logits
    within LOGIT_BAR[compute], and each generated token the prefill
    argmax, except where the prefill's top-2 gap lies within the bar
    (counted).  ``compute`` float32 runs a float32 cache.  Then
    ``graph_session``: the captured session equal to an eager one bit for
    bit, one capture across two ``generate`` calls, both timed, a
    profiled replay.  Returns the numbers, with decode times."""
    cfg = model.cfg
    dtype = getattr(torch, compute)
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]      # launch/serve.py's prompts

    def serve():
        return serve_session(model, params, BatchedServer, prompts,
                             SERVE_NEW, SERVE_MAX_LEN, dtype)

    serve()                          # warm-up (a server and capture apart)
    zero_flash_counts(ops)
    run = serve()
    server, outs, total_ms = run["server"], run["outs"], run["ms"]
    serve_launches = ops.flash_attention.launches   # decode only: 0
    steps, toks = server.stats.steps, server.stats.tokens_out
    if (steps, toks) != (8 + SERVE_NEW - 1, SERVE_BATCH * SERVE_NEW):
        raise AssertionError(f"server: {steps} steps, {toks} tokens; "
                             f"expected 39 and 128")
    seqs = torch.tensor([p + o for p, o in zip(prompts, outs)],
                        dtype=torch.int32, device="cuda")
    zero_flash_counts(ops)
    full = model.prefill_fn(params, {"tokens": seqs})
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    route = "wgmma" if compute == "bfloat16" else "simt"
    check_flash_counts(ops, cfg.n_layers, route, "the check's prefill")
    dec = run["dec_all"]                                 # (B, 39, V)
    pre = full[:, :steps]
    err = (dec - pre).abs()[..., :cfg.vocab_size]
    bar = LOGIT_BAR[compute]
    if not bool(torch.isfinite(dec[..., :cfg.vocab_size]).all()) or \
            float(err.max()) > bar:
        raise AssertionError(f"decode vs prefill ({compute}): max |Δ| "
                             f"{float(err.max())} > {bar}")
    top2 = torch.topk(pre[:, 7:], 2, dim=-1).values      # generating steps
    gap = top2[..., 0] - top2[..., 1]
    got = torch.tensor(outs, device="cuda")
    off = got != pre[:, 7:].argmax(-1)
    if bool((off & (gap > bar)).any()):
        raise AssertionError(f"decode ({compute}): a generated token is "
                             f"not the prefill argmax away from a near-tie")
    graph = graph_session(run, BatchedServer, f"{LM_ARCH}, {compute}")
    # one more eager decode step of the served batch under the profiler:
    # where a step's time goes (it appends to the served cache, which has
    # room)
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out = {"compute": compute, "captured decode": graph,
           "max |decode - prefill| logit":
           float(err.max()), "bar": bar,
           "tokens excused as near-ties": int(off.sum()),
           "positions with a top-2 gap within the bar": int(
               (gap <= bar).sum()),
           "flash_attention launches in the check's prefill": launches,
           "flash_attention route in the check's prefill":
               f"{route}/chunked",
           "flash_attention launches in BatchedServer.generate":
               serve_launches,
           "steps": steps, "tokens_out": toks,
           "decode ms per step": total_ms / steps,
           "decode tokens/s": toks / total_ms * 1e3,
           "decode step profile": prof}
    print(f"decode vs prefill ({compute} compute and cache): {steps} "
          f"steps, {toks} tokens; max |decode - prefill| logit "
          f"{out['max |decode - prefill| logit']:.3e} (bar {bar}); "
          f"{out['tokens excused as near-ties']} generated tokens differ "
          f"from the prefill argmax, all at near-ties; "
          f"{out['decode ms per step']:.3f} ms per step (the captured "
          f"server's first session), "
          f"{out['decode tokens/s']:.1f} tokens/s; {serve_launches} "
          f"flash_attention launches while serving (decode attention is "
          f"plain); one eager step under the "
          f"profiler: {prof['span_ms']:.3f} ms span, device busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    return out


# ---------------------------------------------------------------------------
# The captured decode step (steps 11 and 19-23): one CUDA graph a server
# ---------------------------------------------------------------------------

def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` hold the same bits: dtype, shape and every
    byte."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.reshape(-1).view(torch.uint8)
         == b.reshape(-1).view(torch.uint8)).all())


def cache_snapshot(server) -> list[torch.Tensor]:
    """A server's cache leaves, cloned (``tree_map``'s order)."""
    from repro_torch.dist.sharding import tree_leaves
    return [t.clone() for t in tree_leaves(server.cache)]


def record_steps(server, rec: list, routes: list | None = None) -> None:
    """Wrap the server's own decode step (its captured graph, or its eager
    step): each step's last-position logits are cloned into ``rec`` (a
    replay's output buffer is overwritten by the next), and with
    ``routes`` the step's ``layers.moe.ROUTING`` records appended to it
    (one ``Routing`` a moe layer)."""
    from repro_torch.layers import moe
    step = server.decode

    def recording(p, cache, batch):
        if routes is None:
            logits, cache = step(p, cache, batch)
        else:
            moe.ROUTING = []
            try:
                logits, cache = step(p, cache, batch)
                routes.append(moe.ROUTING)
            finally:
                moe.ROUTING = None
        rec.append(logits[:, -1].clone())
        return logits, cache

    server.decode = recording


def timed_generate(server, prompts, new: int) -> tuple[list, float]:
    """``server.generate(prompts, new)`` and its ms (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = server.generate(prompts, new)
    end.record()
    end.synchronize()
    return outs, start.elapsed_time(end)


def serve_session(model, params, BatchedServer, prompts, new: int,
                  max_len: int, dtype, prepare=None,
                  routing: bool = False, eager: bool = False) -> dict:
    """One served session on a new ``BatchedServer`` (its captured decode
    step; with ``eager``, ``server.decode = model.decode_fn``;
    ``prepare(server)`` first, as filling a cross cache): its steps'
    logits (all columns), routing, tokens, ms, and its cache after the
    session.  The shared record of steps 11 and 19-23, which
    ``graph_session`` holds against an eager run."""
    server = BatchedServer(model, params, batch=SERVE_BATCH, max_len=max_len,
                           cache_dtype=dtype)
    if eager:
        server.decode = model.decode_fn
    if prepare is not None:
        prepare(server)
    rec, routes = [], ([] if routing else None)
    record_steps(server, rec, routes)
    outs, ms = timed_generate(server, prompts, new)
    return {"server": server, "outs": outs, "ms": ms,
            "dec_all": torch.stack(rec, dim=1), "dec_routes": routes,
            "cache_after": cache_snapshot(server),
            "session": dict(model=model, params=params, prompts=prompts,
                            new=new, max_len=max_len, dtype=dtype,
                            prepare=prepare, routing=routing)}


def graph_session(run: dict, BatchedServer, what: str) -> dict:
    """The captured server of ``run`` (``serve_session``) against eager
    decode: (a) a second session on a new server decoding eagerly
    (``server.decode = model.decode_fn``), the same inputs, must equal
    the captured one bit for bit — every
    step's logits (all columns), every token, the cache after the session
    and, for a MoE model, every step's routing; (b) a second ``generate``
    on the captured server replays without a new capture: one capture a
    server across both calls; (c) ms per step and tokens/s (CUDA events
    around ``generate``) of the eager session, the captured first session
    (warm-up and capture included) and the captured second (replays
    only); (d) one replay under the profiler: span, device busy time and
    idle share; and the bytes of the graph's private memory pool.  Then,
    where ``prepare`` replaced cache leaves (the encoder-decoder's cross
    cache), it replaces them again with other values (new tensors, half
    the old): the next call captures again and the replay after it equals
    eager decode on a copy of the cache bit for bit, so the graph reads
    the new leaves, never stale ones.  A difference or a capture more than
    these raises."""
    from repro_torch.kernels import ops as kops
    sess, server = run["session"], run["server"]
    if server.captures != 1:
        raise AssertionError(f"{what}: {server.captures} captures in the "
                             f"first session, expected 1")
    eager = serve_session(**sess, BatchedServer=BatchedServer, eager=True)
    if eager["server"].captures != 0:
        raise AssertionError(f"{what}: the eager server captured")
    diffs = []
    steps = run["dec_all"].shape[1]
    for t in range(steps):
        if not bits_equal(run["dec_all"][:, t], eager["dec_all"][:, t]):
            diffs.append(f"logits of step {t}")
            break
    if run["outs"] != eager["outs"]:
        diffs.append("tokens")
    bad = [i for i, (a, b) in enumerate(zip(run["cache_after"],
                                            eager["cache_after"]))
           if not bits_equal(a, b)]
    if bad or len(run["cache_after"]) != len(eager["cache_after"]):
        diffs.append(f"cache leaves {bad}")
    if sess["routing"]:
        for t, (got, want) in enumerate(zip(run["dec_routes"],
                                            eager["dec_routes"])):
            if len(got) != len(want) or not all(
                    bits_equal(getattr(a, f), getattr(b, f))
                    for a, b in zip(got, want)
                    for f in ("top_i", "margin", "kept")):
                diffs.append(f"routing of step {t}")
                break
    if diffs:
        raise AssertionError(f"{what}: the captured session differs from "
                             f"the eager one in {diffs}")
    # (b), (c): a second session on the captured server, replays only
    server.decode = server.step
    rec2, routes2 = [], ([] if sess["routing"] else None)
    record_steps(server, rec2, routes2)
    counts0 = {n: getattr(kops, n).launches for n in XB_NAMES}
    outs2, ms2 = timed_generate(server, sess["prompts"], sess["new"])
    launches2 = {n: getattr(kops, n).launches - counts0[n]
                 for n in XB_NAMES}
    captures = server.captures
    if captures != 1:
        raise AssertionError(f"{what}: {captures} captures across two "
                             f"generate calls, expected 1")
    if routes2 is not None and any(len(r) != len(run["dec_routes"][0])
                                   for r in routes2):
        raise AssertionError(f"{what}: a replay left "
                             f"{[len(r) for r in routes2]} routing records"
                             f" a step, expected one a moe layer")
    if not bool(torch.isfinite(torch.stack(rec2)[..., :sess[
            "model"].cfg.vocab_size]).all()):
        raise AssertionError(f"{what}: replayed logits not finite")
    # (d): one replay under the profiler
    step_batch = {"tokens": torch.tensor(outs2, dtype=torch.int32,
                                         device="cuda")[:, -1:],
                  "length": torch.full((), steps, dtype=torch.int32,
                                       device="cuda")}
    prof = profile_device(lambda: server.step(sess["params"], server.cache,
                                              step_batch), reps=1)
    pool = server.step.pool_bytes()
    replaced = None
    if sess["prepare"] is not None:
        replaced = replaced_leaves_read(server, sess, steps + 1, what)
    toks = len(sess["prompts"]) * sess["new"]
    out = {"captures across two generate calls": captures,
           "captured == eager bit for bit":
               f"{steps} steps' logits, tokens, "
               f"{len(run['cache_after'])} cache leaves"
               + (", routing" if sess["routing"] else ""),
           "steps": steps,
           "eager ms per step": eager["ms"] / steps,
           "eager tokens/s": toks / eager["ms"] * 1e3,
           "captured ms per step (first session: warm-up, capture, "
           "replays)": run["ms"] / steps,
           "captured ms per step": ms2 / steps,
           "captured tokens/s": toks / ms2 * 1e3,
           "speed-up (eager / captured)": eager["ms"] / ms2,
           "crossbar launches in the second session": launches2,
           "launches per replay": dict(server.step.graph.per_replay),
           "graph pool GB": None if pool is None else pool / 1e9,
           "replay profile": prof}
    if replaced is not None:
        out["replaced cache leaves"] = replaced
    print(f"captured decode ({what}): {captures} capture across two "
          f"generate calls; captured == eager bit for bit "
          f"({out['captured == eager bit for bit']}); ms per step: "
          f"captured {out['captured ms per step']:.3f} (first session "
          f"{run['ms'] / steps:.3f}), eager "
          f"{out['eager ms per step']:.3f}; tokens/s captured "
          f"{out['captured tokens/s']:.1f}, eager "
          f"{out['eager tokens/s']:.1f}; one replay under the profiler: "
          f"{prof['span_ms']:.3f} ms span, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}; graph pool "
          f"{ms3(out['graph pool GB'])} GB [{card_line()}]"
          + ("" if replaced is None else
             f"; {replaced['leaves']} cache leaves replaced: "
             f"{replaced['captures']} captures, the replays after equal "
             f"eager bit for bit"))
    return out


def replaced_leaves_read(server, sess, length: int, what: str) -> dict:
    """``graph_session``'s last check: ``prepare(server)`` replaces its
    cache leaves with new tensors, halved here so a stale read would
    show; two decode steps (lengths ``length`` and ``length + 1``) through the captured
    step — the first captures again, the second replays — each equal bit
    for bit to ``decode_fn`` on a copy of the cache."""
    from repro_torch.dist.sharding import tree_leaves, tree_map
    before = tree_leaves(server.cache)
    sess["prepare"](server)
    new = [t for t, b in zip(tree_leaves(server.cache), before)
           if t is not b]
    for t in new:
        t.mul_(0.5)
    eager = tree_map(torch.clone, server.cache)
    tokens = torch.arange(1, SERVE_BATCH + 1, dtype=torch.int32,
                          device="cuda")[:, None]
    captures = []
    for t in range(2):
        batch = {"tokens": tokens + t,
                 "length": torch.full((), length + t, dtype=torch.int32,
                                      device="cuda")}
        want, eager = sess["model"].decode_fn(sess["params"], eager, batch)
        got, server.cache = server.step(sess["params"], server.cache, batch)
        captures.append(server.captures)
        if not bits_equal(got, want):
            raise AssertionError(f"{what}: after {len(new)} cache leaves "
                                 f"were replaced, step {t} differs from "
                                 f"eager decode")
    if captures != [2, 2]:
        raise AssertionError(f"{what}: captures {captures} after the "
                             f"replaced leaves, expected [2, 2]")
    if not new or any(not bits_equal(a, b) for a, b in zip(
            tree_leaves(server.cache), tree_leaves(eager))):
        raise AssertionError(f"{what}: {len(new)} leaves replaced, or the "
                             f"cache differs from eager decode's")
    return {"leaves": len(new), "captures": server.captures,
            "steps equal to eager bit for bit": 2}


def lm_decode_kernel_mode(ops, xbk, BatchedServer) -> dict:
    """Step 11 (e): qwen2-0.5b at full width in the crossbar kernel mode
    (``crossbar=True, xbar_use_kernel=True``), bf16 compute and cache:
    every projection of a decode step runs the hand-written
    ``crossbar_fwd`` (7 a layer, 168 a step; the tied head stays plain).
    The captured server serves the CLI's prompts (39 steps), the counts
    at 0 before and read after: the capture records 168 ``crossbar_fwd``
    launches a replay, the session 39 x 168 (the warm-up's and 38
    replays'), no bwd, dw or flash launch; logits finite, pad columns
    -1e30.  The warm-up's layer-0 launches (its first 7) are held against
    their plain versions within XB_BAR of sum_k |x_k||w_k| and timed at
    the decode shapes (kernel, plain, ``torch.bmm``, the bound); then
    ``graph_session``, whose second session must launch 39 x 168 again.
    No decode-vs-prefill bar: the activations' fake-quant scale is one per
    call, a prefill's over the whole sequence, a decode step's over its
    batch of tokens, so the two quantize differently by design."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(LM_ARCH, crossbar=True, xbar_use_kernel=True)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]
    per_step = XB_PROJECTIONS * cfg.n_layers
    zero_lm_counts(ops)
    with Layer0Recorder(xbk, XB_PROJECTIONS) as rec:
        run = serve_session(model, params, BatchedServer, prompts,
                            SERVE_NEW, SERVE_MAX_LEN, torch.bfloat16)
    launches = {n: getattr(ops, n).launches for n in XB_NAMES}
    steps = run["dec_all"].shape[1]
    per_replay = dict(run["server"].step.graph.per_replay)
    want = {"crossbar_fwd": steps * per_step, "crossbar_bwd": 0,
            "crossbar_dw": 0}
    if per_replay != {"crossbar_fwd": per_step} or launches != want or \
            ops.flash_attention.launches:
        raise AssertionError(f"kernel-mode decode: {per_replay} a replay, "
                             f"{launches} in {steps} steps (and "
                             f"{ops.flash_attention.launches} flash), "
                             f"expected {per_step} crossbar_fwd a replay, "
                             f"{want}")
    dec = run["dec_all"]
    if not bool(torch.isfinite(dec[..., :cfg.vocab_size]).all()) or \
            not bool((dec[..., cfg.vocab_size:] == -1e30).all()):
        raise AssertionError("kernel-mode decode logits not finite, or pad "
                             "columns not -1e30")
    errs = check_layer0_launches(xbk, rec)
    # the wrapper receives x and g± in the compute dtype (bf16) and widens
    # them to fp32 before the launch: the function's bound counts them at
    # the compute dtype's size
    rows = lm_crossbar_rows(xbk, rec, in_bytes=torch.finfo(
        getattr(torch, cfg.compute_dtype)).bits // 8)
    del rec
    graph = graph_session(run, BatchedServer,
                          f"{LM_ARCH}, crossbar kernel mode, bfloat16")
    second = graph["crossbar launches in the second session"]
    if second != want:
        raise AssertionError(f"kernel-mode decode, second session: "
                             f"{second}, expected {want}")
    out = {"launches": launches, "crossbar_fwd launches per replay":
           per_replay["crossbar_fwd"], "steps": steps,
           "launches in step 11 (e)": {n: getattr(ops, n).launches
                                       for n in XB_NAMES},
           "layer-0 launches vs plain, max |err| / sum |x||w|": errs,
           "captured decode": graph, "rows": rows}
    print(f"decode in crossbar kernel mode ({LM_ARCH} full width, bf16 "
          f"compute and cache): {per_replay['crossbar_fwd']} crossbar_fwd "
          f"launches a replay ({XB_PROJECTIONS} projections x "
          f"{cfg.n_layers} layers), {json.dumps(launches)} in {steps} "
          f"steps, the second session {json.dumps(second)}; layer 0's "
          f"launches vs plain (max |err| / sum |x||w|, bar {XB_BAR}) "
          f"{json.dumps(errs)}")
    print_crossbar_rows(rows)
    return out


def lm_path(ops, xbk) -> dict:
    """The LM serving path (module docstring, steps 11-12)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    model = build_model(get_config(LM_ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    model32 = build_model(get_config(LM_ARCH, compute_dtype="float32"),
                          "cuda")
    out = {"prefill": lm_prefill_path(ops, model, params, "wgmma"),
           "prefill fp32": lm_prefill_path(ops, model32, params, "simt",
                                           profile=False)}
    out["decode bf16"] = decode_against_prefill(ops, model, params,
                                                BatchedServer, "bfloat16")
    out["decode fp32"] = decode_against_prefill(ops, model32, params,
                                                BatchedServer, "float32")
    out["flash_attention launches serving"] = sum(
        out[d]["flash_attention launches in BatchedServer.generate"]
        for d in ("decode bf16", "decode fp32"))
    del model, model32, params
    out["decode kernel mode"] = lm_decode_kernel_mode(ops, xbk,
                                                      BatchedServer)
    return out


# ---------------------------------------------------------------------------
# Faulted chip, farm training and farm serving
# ---------------------------------------------------------------------------

FAULTS = dict(stuck_on=0.0025, stuck_off=0.01, variation_sigma=0.05, seed=0)
FARM_CHIPS, FARM_BATCH = 4, 4096
SERVE_REQUESTS, SERVE_M = 256, 16
# the farm's launches and their plain versions: (kernel, default kwargs)
FARM_PLAIN = {"crossbar_fwd_stacked": ("crossbar_fwd", {"activation": False}),
              "crossbar_bwd_stacked": ("crossbar_bwd", {}),
              "crossbar_dw_stacked": ("crossbar_dw", {})}


def plain_overlay(g, on, off, scales) -> torch.Tensor:
    """The fault overlay in plain PyTorch: the per-core scale clipped to
    the conductance range, then stuck-on cells to w_max and stuck-off
    cells (which win an overlap) to 0."""
    g = torch.clamp(g * scales[:, None, None], 0.0, W_MAX)
    g = torch.where(on, torch.full_like(g, W_MAX), g)
    return torch.where(off, torch.zeros_like(g), g)


def stage_masks(faults, st) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(on, off) masks of stage ``st``'s g+ and g- stacks, on the card."""
    return [tuple(m.cuda() for m in faults.masks(tuple(g.shape),
                                                 2 * st.index + side))
            for side, g in enumerate((st.g_plus, st.g_minus))]


def faulted_rule(faults, chip, paper_backprop_step):
    """The plain paper rule followed by the plain re-application of the
    chip's stuck masks, on (fan_in, fan_out) layers."""
    masks = [[tuple(untile(m, st) for m in side)
              for side in stage_masks(faults, st)]
             for st in chip.placement.stages]

    def rule(layers, x, target, spec, lr):
        want, err = paper_backprop_step(layers, x, target, spec, lr)
        for p, sides in zip(want, masks):
            for k, (on, off) in zip(("g_plus", "g_minus"), sides):
                g = torch.where(on, torch.full_like(p[k], W_MAX), p[k])
                p[k] = torch.where(off, torch.zeros_like(g), g)
        return want, err
    return rule, masks


def check_stuck(layers, masks, what) -> int:
    """Every stuck cell of ``layers`` reads exactly 0 or w_max; returns
    the number of stuck cells."""
    n = 0
    for li, (p, sides) in enumerate(zip(layers, masks)):
        for k, (on, off) in zip(("g_plus", "g_minus"), sides):
            if not (bool((p[k][off] == 0.0).all())
                    and bool((p[k][on] == W_MAX).all())):
                raise AssertionError(f"{what}: layer {li} {k}: a stuck "
                                     f"cell moved")
            n += int(on.sum()) + int(off.sum())
    return n


def faulted_chip_path(ops, csim, chip_mod, build_chip, spec, mlp_forward,
                      paper_backprop_step, gen) -> dict:
    """The faulted chip (module docstring, step 12)."""
    from repro_torch.runtime.faults import MemristorFaults
    faults = MemristorFaults(**FAULTS)
    chip = build_chip("mnist_class", seed=SEED, device="cuda",
                      faults=faults)
    clean = build_chip("mnist_class", seed=SEED, device="cuda",
                       compiled=False)
    if not chip.compiled or chip._compiled_active():
        raise AssertionError("a faulted chip must run its eager path")
    for st, cst in zip(chip.placement.stages, clean.placement.stages):
        for side, (g, g0) in enumerate(((st.g_plus, cst.g_plus),
                                        (st.g_minus, cst.g_minus))):
            salt = 2 * st.index + side
            on, off = (m.cuda() for m in faults.masks(tuple(g0.shape),
                                                      salt))
            scales = faults.core_scales(g0.shape[0], salt).cuda()
            if not torch.equal(g, plain_overlay(g0, on, off, scales)):
                raise AssertionError(f"stage {st.index}: injected stacks "
                                     f"differ from the plain overlay")
    rule, masks = faulted_rule(faults, chip, paper_backprop_step)
    stuck = check_stuck(chip.layers(), masks, "injected")
    x = uniform((FARM_BATCH, 784), -0.5, 0.5, gen)
    data = [(uniform((FARM_BATCH, 784), -0.5, 0.5, gen),
             uniform((FARM_BATCH, 10), -0.5, 0.5, gen)) for _ in range(2)]
    # recognition: counts at 0, one wave, read
    zero_counts(ops, csim)
    out, _ = chip.infer_stream(x)
    torch.cuda.synchronize()
    wave = read_counts(ops)
    if wave != {"crossbar_fwd_stacked": 5}:
        raise AssertionError(f"faulted wave launches {wave}, expected 5")
    flips = {f"wave x{FARM_BATCH}": check_chip_wave(chip, x, out,
                                                     mlp_forward, spec)}
    # training: counts at 0, two steps at batch 4096, read
    rec = Recorder(ops)
    chip_mod.kernel_ops = rec
    try:
        zero_counts(ops, csim)
        snaps, errs = [clone_layers(chip)], []
        for xs, ts in data:
            errs.append(chip.train_step(xs, ts, lr=LR))
            snaps.append(clone_layers(chip))
        torch.cuda.synchronize()
        steps, captures = read_counts(ops), csim.capture_counts()
    finally:
        chip_mod.kernel_ops = ops
    if steps != {"crossbar_fwd_stacked": 10, "crossbar_bwd_stacked": 8,
                 "pulse_update_stacked": 8} or captures:
        raise AssertionError(f"faulted steps launched {steps}, captured "
                             f"{captures}: expected the eager path, 5 + 4 "
                             f"+ 4 per step and no capture")
    S = len(chip.placement.stages)
    for i, ((xs, ts), err) in enumerate(zip(data, errs)):
        flips[f"step {i}"] = check_train_step(
            chip, rec, i * S, snaps[i], snaps[i + 1], xs, ts, err, spec,
            rule, LR)
        check_stuck(snaps[i + 1], masks, f"after step {i}")
    step_ms = cuda_ms(lambda: chip.train_step(data[0][0], data[0][1],
                                              lr=LR), iters=3, warmup=1)
    print(f"faulted chip (mnist_class, {json.dumps(FAULTS)}): {stuck} stuck "
          f"cells exact after injection and each step; launches: wave "
          f"{json.dumps(wave)}, 2 steps {json.dumps(steps)} (eager although "
          f"compiled=True, no capture); held against plain (flips): "
          + json.dumps(flips))
    print(f"faulted chip train_step mnist_class x{FARM_BATCH} "
          f"[{card_line()}]: {step_ms} ms")
    return {"fwd": 5 + 10, "bwd": 8, "pulse": 8,
            "step_ms": step_ms, "stuck_cells": stuck}


class LaunchRecorder:
    """Stands in for ``kernels.ops`` inside ``sim.compiled`` or
    ``sim.cluster`` and keeps, for every launch of the named wrappers made
    outside a graph capture, copies of its operands (taken before the
    launch: an update may write them later), its keyword arguments, its
    result, and each operand's address and contiguity.  It launches
    nothing itself."""

    def __init__(self, ops, names):
        self._ops, self.names, self.calls = ops, names, []

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name not in self.names:
            return fn

        def record(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            seen = [(a.data_ptr(), a.is_contiguous()) for a in args]
            inputs = [a.clone() for a in args]
            out = fn(*args, **kwargs)
            self.calls.append((name, inputs, kwargs, out.clone(), seen))
            return out
        return record


def check_launches(xbk, calls, what) -> dict[str, float]:
    """Hold every recorded launch against its kernel's plain version on
    the same operands (the chip axis folded into the core stack).
    Returns the largest difference per kernel."""
    errs: dict[str, float] = {}
    for name, args, kwargs, out, _ in calls:
        base, defaults = FARM_PLAIN[name]
        fold = [a.reshape(-1, *a.shape[2:]) if a.dim() == 4 else a
                for a in args]
        want = getattr(xbk, f"{base}_plain")(*fold, **{**defaults, **kwargs})
        err = close(out.reshape(want.shape), want,
                    f"{what} {name} {tuple(args[0].shape)}")
        errs[base] = max(errs.get(base, 0.0), err)
    return errs


def envelope(farm) -> tuple[torch.Tensor, torch.Tensor]:
    return farm._stacks.g_plus.clone(), farm._stacks.g_minus.clone()


def check_in_envelope(farm, calls, aggregation: int, what) -> None:
    """The conductance operands of every recorded fwd/bwd launch but the
    ``aggregation`` launches are a stage's (C, T_s) block of the farm's
    envelope itself, contiguous — never a copy."""
    st = farm._stacks
    blocks = {st.g_plus[s, :st.chips * m.T].data_ptr()
              for s, m in enumerate(st.stage_maps)}
    blocks |= {st.g_minus[s, :st.chips * m.T].data_ptr()
               for s, m in enumerate(st.stage_maps)}
    hits = sum(1 for name, _, _, _, seen in calls
               if name != "crossbar_dw_stacked"
               and all(p in blocks and c for p, c in seen[1:3]))
    expected = sum(1 for c in calls
                   if c[0] != "crossbar_dw_stacked") - aggregation
    if hits != expected or not hits:
        raise AssertionError(f"{what}: {hits} fwd/bwd launches on the "
                             f"envelope's own blocks, expected {expected}")


def farm_train_path(ops, csim, cluster, build_chip, gen) -> dict:
    """Farm training (module docstring, step 13)."""
    from repro_torch.kernels import crossbar as xbk
    C, B = FARM_CHIPS, FARM_BATCH
    farm = cluster.build_farm("mnist_class", C, seed=SEED, device="cuda")
    eager = cluster.build_farm("mnist_class", C, seed=SEED, device="cuda",
                               compiled=False)
    serial = build_chip("mnist_class", seed=SEED, device="cuda")
    S = len(farm.placement.stages)
    names = tuple(FARM_PLAIN)
    data = [(uniform((B, 784), -0.5, 0.5, gen),
             uniform((B, 10), -0.5, 0.5, gen)) for _ in range(2)]
    # compiled: counts at 0, two steps, read
    crec = LaunchRecorder(ops, names)
    befores, afters, errs_c = [], [], []
    csim.kernel_ops = crec
    try:
        zero_counts(ops, csim)
        for x, t in data:
            befores.append(envelope(farm))
            errs_c.append(farm.train_step(x, t, lr=LR))
            afters.append(envelope(farm))
        torch.cuda.synchronize()
        launches_c, captures = read_counts(ops), csim.capture_counts()
    finally:
        csim.kernel_ops = ops
    want_c = {"crossbar_fwd_stacked": 2 * S, "crossbar_bwd_stacked": 2 * S,
              "crossbar_dw_stacked": 2 * S}
    if launches_c != want_c or list(captures.values()) != [1] \
            or next(iter(captures))[2:] != ((C, B // C, 784), "none"):
        raise AssertionError(f"compiled farm steps launched {launches_c}, "
                             f"captured {captures}: expected {want_c} and "
                             f"one capture")
    # eager: counts at 0, the same two steps from the same conductances
    erec = LaunchRecorder(ops, names)
    errs_e, afters_e = [], []
    cluster.kernel_ops = erec
    try:
        zero_counts(ops, csim)
        for (x, t), (gp, gm) in zip(data, befores):
            eager._stacks.g_plus.copy_(gp)
            eager._stacks.g_minus.copy_(gm)
            errs_e.append(eager.train_step(x, t, lr=LR))
            afters_e.append(envelope(eager))
        torch.cuda.synchronize()
        launches_e = read_counts(ops)
    finally:
        cluster.kernel_ops = ops
    want_e = dict(want_c, crossbar_fwd_stacked=2 * (S + 1))
    if launches_e != want_e:
        raise AssertionError(f"eager farm steps launched {launches_e}, "
                             f"expected {want_e}")
    # every launch against its plain version; on the envelope itself
    errs = check_launches(xbk, crec.calls, "compiled farm")
    for k, v in check_launches(xbk, erec.calls, "eager farm").items():
        errs[k] = max(errs.get(k, 0.0), v)
    check_in_envelope(farm, crec.calls, 0, "compiled farm")
    check_in_envelope(eager, erec.calls, 2, "eager farm")
    # compiled against eager, step by step from the same conductances
    unit = MAX_DW / LEVELS
    dws = [r[3] for r in erec.calls if r[0] == "crossbar_dw_stacked"]
    ce_cells, ce_err = 0, 0.0
    for i in range(2):
        ce_err = max(ce_err, float((errs_c[i] - errs_e[i]).abs().max()))
        for j, m in enumerate(reversed(farm._stacks.stage_maps)):
            s = S - 1 - j
            counts = (2.0 * LR / B * dws[i * S + j].double().sum(0)
                      / unit).repeat(C, 1, 1)
            n = C * m.T
            ce_cells += check_conductances(
                (afters[i][0][s, :n], afters[i][1][s, :n]),
                (afters_e[i][0][s, :n], afters_e[i][1][s, :n]), counts,
                f"compiled farm step {i} stage {s} vs eager")
    if not ce_err <= G_ATOL:
        raise AssertionError(f"compiled farm error vs eager: {ce_err}")
    local_dw = farm_dw_rows(xbk, [c for c in erec.calls
                                  if c[0] == "crossbar_dw_stacked"][:S])
    # the farm against the serial compiled chip on the first step
    grec = GraphRecorder(ops)
    csim.kernel_ops = grec
    try:
        err_s = serial.train_step(data[0][0], data[0][1], lr=LR)
    finally:
        csim.kernel_ops = ops
    serial_err = float((errs_c[0] - err_s).abs().max())
    if not serial_err <= G_ATOL:
        raise AssertionError(f"farm error vs serial chip: {serial_err}")
    excused = 0
    for (xs, ds, lr_t, _), st in zip(grec.run[:S],
                                     reversed(serial.placement.stages)):
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr_t, max_dw=MAX_DW,
                                        levels=LEVELS)
        T = counts.shape[0]
        excused += check_conductances(
            (afters[0][0][st.index, :T], afters[0][1][st.index, :T]),
            (st.g_plus, st.g_minus), counts,
            f"farm vs serial chip stage {st.index}")
    if not (farm.replicas_in_sync() and eager.replicas_in_sync()):
        raise AssertionError("farm replicas out of lockstep")
    farm.train_step(data[1][0], data[1][1], lr=LR, reconcile="int8")
    if not farm.replicas_in_sync():
        raise AssertionError("int8 reconciliation broke the lockstep")
    rep = farm.report()
    cmp_ = {**rep.compare_chip_sum(), **rep.compare_hw()}
    if not {"train_step_time", "train_energy", "reconcile_bits",
            "train_lockstep"} <= set(cmp_) \
            or not all(v <= 0.01 for v in cmp_.values()):
        raise AssertionError(f"farm report vs farm_cost: {cmp_}")
    times = {
        "compiled farm step ms": cuda_ms(
            lambda: farm.train_step(data[0][0], data[0][1], lr=LR),
            iters=5, warmup=2),
        "eager farm step ms": cuda_ms(
            lambda: eager.train_step(data[0][0], data[0][1], lr=LR),
            iters=3, warmup=1),
        "serial compiled chip step ms": cuda_ms(
            lambda: serial.train_step(data[0][0], data[0][1], lr=LR),
            iters=5, warmup=2)}
    times.update({k.replace(" ms", " samples/s"): B / v * 1e3
                  for k, v in list(times.items())})
    prof = profile_device(lambda: farm.train_step(data[0][0], data[0][1],
                                                  lr=LR))
    print(f"farm training (mnist_class, {C} chips, batch {B}): launches "
          f"compiled {json.dumps(launches_c)} + 1 capture, eager "
          f"{json.dumps(launches_e)} (2 steps each); every launch held "
          f"against plain {json.dumps(errs)}, on the envelope's own "
          f"blocks; compiled vs eager: max |err| {ce_err}, {ce_cells} cells "
          f"one pulse apart; vs the serial compiled chip: max |err| "
          f"{serial_err}, {excused} excused cells (count within 1e-4 of "
          f"k + 1/2); replicas in sync (int8 too); report vs farm_cost "
          + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    print(f"farm training times [{card_line()}]: " + json.dumps(times))
    print(f"farm step's {S} local dw launches ({C} chips x {B // C}) "
          f"[{card_line()}]: " + json.dumps(local_dw))
    print(f"profile, compiled farm train_step mnist_class {C} chips x "
          f"{B // C} (profiler on): " + json.dumps(prof))
    return {"farm": farm, "fwd": launches_c["crossbar_fwd_stacked"]
            + launches_e["crossbar_fwd_stacked"],
            "bwd": 4 * S, "dw": 4 * S, "errs": errs, "local_dw": local_dw,
            "excused": excused, **times,
            "idle_share": prof["device_idle_share"]}


def farm_dw_rows(xbk, calls) -> dict:
    """One farm step's local dw launches (recorded operands, the chip axis
    folded into the core stack): the kernel's and ``torch.bmm``'s device
    time (``graph_ms``), the plain version's time and the bound, per
    launch and summed."""
    rows = []
    for _, (xs, ds), _, _, _ in calls:
        xs, ds = xs.reshape(-1, *xs.shape[2:]), ds.reshape(-1, *ds.shape[2:])
        T, M, K = xs.shape
        N = ds.shape[2]
        xt = xs.transpose(1, 2)
        flop_ms, byte_ms = bound(T, M, K, N, "crossbar_dw")
        rows.append({
            "T": T, "M": M, "K": K, "N": N,
            "ms_device": graph_ms(lambda: xbk.crossbar_dw_kernel(xs, ds)),
            "plain_ms": cuda_ms(lambda: xbk.crossbar_dw_plain(xs, ds)),
            "library_ms_device": graph_ms(lambda: torch.bmm(xt, ds)),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"})
    out = {k: sum(r[k] for r in rows) for k in
           ("ms_device", "plain_ms", "library_ms_device", "bound_ms")}
    return {**out, "rows": rows}


def farm_serve_path(ops, csim, cluster, farm, mlp_forward, spec,
                    gen) -> dict:
    """Farm serving (module docstring, step 14)."""
    from repro_torch.runtime.serve_loop import RequestQueue
    C, Q, m = FARM_CHIPS, SERVE_REQUESTS, SERVE_M
    S = len(farm.placement.stages)
    x = uniform((Q * m, 784), -0.5, 0.5, gen)
    reqs = list(x.reshape(Q, m, 784))

    def session(f):
        queue = RequestQueue(reqs)
        stats = cluster.FarmServer(f).run(queue)
        return torch.stack(queue.results()), stats
    beats = S - 1 + Q // C
    zero_counts(ops, csim)
    out_c, stats_c = session(farm)
    torch.cuda.synchronize()
    launches_c, captures = read_counts(ops), csim.capture_counts()
    if launches_c != {"crossbar_fwd_stacked": beats} \
            or list(captures.values()) != [1] \
            or next(iter(captures))[0] != "serve_scan":
        raise AssertionError(f"compiled session launched {launches_c}, "
                             f"captured {captures}: expected one launch a "
                             f"beat ({beats}) and one program")
    eager = cluster.build_farm("mnist_class", C, seed=SEED, device="cuda",
                               compiled=False)
    eager._stacks.g_plus.copy_(farm._stacks.g_plus)
    eager._stacks.g_minus.copy_(farm._stacks.g_minus)
    zero_counts(ops, csim)
    out_e, stats_e = session(eager)
    torch.cuda.synchronize()
    launches_e = read_counts(ops)
    if launches_e != {"crossbar_fwd_stacked": 2 * beats}:
        raise AssertionError(f"eager server launched {launches_e}, "
                             f"expected 2 a beat ({2 * beats})")
    if not torch.equal(out_c, out_e) or stats_c != stats_e:
        raise AssertionError(f"compiled session and eager server differ: "
                             f"{float((out_c - out_e).abs().max())}, "
                             f"{stats_c} vs {stats_e}")
    if stats_c["beats"] != beats or stats_c["retired"] != Q * m \
            or not abs(stats_c["beat_us"] - 0.77) <= 0.0077:
        raise AssertionError(f"serving stats {stats_c}")
    chip0 = farm.extract_chip(0)
    wave = chip0.infer(x, count=False)
    flips = check_chip_wave(chip0, x, wave, mlp_forward, spec)
    served = out_c.reshape(Q * m, -1)
    serve_err = close(served, wave, "served outputs vs the chip's wave")
    t0 = time.perf_counter()
    session(farm)
    torch.cuda.synchronize()
    host_beat_us = (time.perf_counter() - t0) / beats * 1e6
    times = {"compiled session ms": cuda_ms(lambda: session(farm), iters=5,
                                            warmup=1),
             "eager session ms": cuda_ms(lambda: session(eager), iters=2,
                                         warmup=1),
             "compiled session host us per beat": host_beat_us}
    times["compiled session device samples/s"] = \
        Q * m / times["compiled session ms"] * 1e3
    prof = profile_device(lambda: session(farm))
    print(f"farm serving (mnist_class, {C} chips, {Q} requests of {m}): "
          f"{beats} beats, launches compiled {json.dumps(launches_c)} (1 a "
          f"beat, one program), eager {json.dumps(launches_e)} (2 a beat); "
          f"outputs and stats equal; vs the chip's wave max |err| "
          f"{serve_err}, vs mlp_forward {flips} samples after a boundary "
          f"flip; stats " + json.dumps(stats_c))
    print(f"farm serving times [{card_line()}]: " + json.dumps(times))
    print("profile, compiled farm serving session (profiler on): "
          + json.dumps(prof))
    return {"fwd": launches_c["crossbar_fwd_stacked"]
            + launches_e["crossbar_fwd_stacked"], "err": serve_err,
            **times, "idle_share": prof["device_idle_share"]}


# ---------------------------------------------------------------------------
# Pipeline fabric: training, serving and the farm of pipelines
# ---------------------------------------------------------------------------

PIPE_APP, PIPE_BATCH = "isolet_class", 256
PIPE_GROUPS, PIPE_CORES = ((0, 1), (2, 3, 4)), [130, 30]
RAGGED_BATCH = 4096            # mnist_class split 3 ways (1/1/2 stages)
PIPE_REQUESTS = 64             # serving: 64 requests of SERVE_M samples
PF_PIPELINES, PF_CHIPS, PF_BATCH = 2, 2, 2048


def layers_equal(a, b) -> bool:
    return all(torch.equal(p[k], q[k]) for p, q in zip(a, b)
               for k in ("g_plus", "g_minus"))


def pipeline_train_path(ops, csim, fabric, build_chip, hw, gen) -> dict:
    """Pipeline training (module docstring, step 15)."""
    B = PIPE_BATCH
    pipe = fabric.build_pipeline(PIPE_APP, seed=SEED, device="cuda")
    eager = fabric.build_pipeline(PIPE_APP, seed=SEED, device="cuda",
                                  compiled=False)
    serial = build_chip(PIPE_APP, seed=SEED, device="cuda")
    cores = [c.placement.n_cores for c in pipe.chips]
    if pipe.groups != PIPE_GROUPS or cores != PIPE_CORES:
        raise AssertionError(f"{PIPE_APP} split {pipe.groups} with cores "
                             f"{cores}, expected {PIPE_GROUPS} {PIPE_CORES}")
    S = len(pipe.placement.stages)
    dims = pipe.placement.dims
    data = [(uniform((B, dims[0]), -0.5, 0.5, gen),
             uniform((B, dims[-1]), -0.5, 0.5, gen)) for _ in range(2)]
    if not layers_equal(pipe.layers(), serial.layers()):
        raise AssertionError("build_pipeline and build_chip drew different "
                             "conductances from one seed")
    # compiled: counts at 0, two steps, read
    zero_counts(ops, csim)
    errs_c, layers_c, caps = [], [], []
    for x, t in data:
        errs_c.append(pipe.train_step(x, t, lr=LR))
        layers_c.append(clone_layers(pipe))
        caps.append(csim.capture_counts())
    torch.cuda.synchronize()
    launches_c = read_counts(ops)
    want_c = {"crossbar_fwd_stacked": 2 * S, "crossbar_train_stacked": 2 * S}
    progs = sorted(k[0] for k in caps[0])
    if launches_c != want_c or caps[1] != caps[0] \
            or progs != ["chip_backward"] * 2 + ["chip_forward"] * 2 \
            or set(caps[0].values()) != {1}:
        raise AssertionError(f"compiled pipeline steps launched "
                             f"{launches_c}, captured {caps}: expected "
                             f"{want_c}, 4 programs in the first step and "
                             f"none in the second")
    # eager: counts at 0, the same two steps from the same conductances
    zero_counts(ops, csim)
    errs_e, layers_e = [], []
    for x, t in data:
        errs_e.append(eager.train_step(x, t, lr=LR))
        layers_e.append(clone_layers(eager))
    torch.cuda.synchronize()
    launches_e, caps_e = read_counts(ops), csim.capture_counts()
    aggs = sum(st.row_tiles > 1 for st in pipe.placement.stages)
    want_e = {"crossbar_fwd_stacked": 2 * (S + aggs),
              "crossbar_bwd_stacked": 2 * S, "pulse_update_stacked": 2 * S}
    if launches_e != want_e or caps_e:
        raise AssertionError(f"eager pipeline steps launched {launches_e}, "
                             f"captured {caps_e}: expected {want_e}")
    # compiled == eager == the serial compiled chip, bit for bit
    for i, (x, t) in enumerate(data):
        err_s = serial.train_step(x, t, lr=LR)
        if not (torch.equal(errs_c[i], errs_e[i])
                and layers_equal(layers_c[i], layers_e[i])):
            raise AssertionError(f"pipeline step {i}: compiled and eager "
                                 f"differ")
        if not (torch.equal(errs_c[i], err_s)
                and layers_equal(layers_c[i], serial.layers())):
            raise AssertionError(f"pipeline step {i}: differs from the "
                                 f"serial compiled chip")
    # why the eager backward folds its fan-out tiles in order: the
    # device's sum over them may reassociate (elements that differ from
    # in-order adds, at this pipeline's (fan-in, fan-out) tile counts)
    fold_order = {}
    for st in pipe.placement.stages[1:]:
        r, c = st.row_tiles, st.col_tiles
        d = uniform((r, c, B, st.rows), -1.0, 1.0, gen)
        seq = d[:, 0]
        for j in range(1, c):
            seq = seq + d[:, j]
        fold_order[f"{r}x{c}"] = int((d.sum(dim=1) != seq).sum())
    cmp_ = pipe.report().compare_hw()
    if not {"train_step_time", "train_energy", "train_link_bits_fwd",
            "train_link_bits_bwd", "span"} <= set(cmp_) \
            or not all(v <= 0.01 for v in cmp_.values()):
        raise AssertionError(f"pipeline report vs pipeline_cost: {cmp_}")
    # the ragged 3-way split of mnist_class, two steps, the second
    # microbatched, locked to the serial compiled chip
    ragged = fabric.build_pipeline("mnist_class", n_chips=3, seed=SEED,
                                   device="cuda")
    rserial = build_chip("mnist_class", seed=SEED, device="cuda")
    if sorted(len(g) for g in ragged.groups) != [1, 1, 2]:
        raise AssertionError(f"mnist 3-way split {ragged.groups}")
    rdata = [(uniform((RAGGED_BATCH, 784), -0.5, 0.5, gen),
              uniform((RAGGED_BATCH, 10), -0.5, 0.5, gen))
             for _ in range(2)]
    zero_counts(ops, csim)
    rsteps = []
    for step, (x, t) in enumerate(rdata):
        rsteps.append((ragged.train_step(x, t, lr=LR,
                                         n_micro=2 if step else 1),
                       clone_layers(ragged)))
    torch.cuda.synchronize()
    launches_r = read_counts(ops)
    for step, ((x, t), (err, after)) in enumerate(zip(rdata, rsteps)):
        if not (torch.equal(err, rserial.train_step(x, t, lr=LR))
                and layers_equal(after, rserial.layers())):
            raise AssertionError(f"ragged pipeline step {step} differs "
                                 f"from the serial compiled chip")
    if launches_r != {"crossbar_fwd_stacked": 8,
                      "crossbar_train_stacked": 8}:
        raise AssertionError(f"ragged pipeline launched {launches_r}")
    x, t = data[0]
    times = {
        "compiled pipeline step ms": cuda_ms(
            lambda: pipe.train_step(x, t, lr=LR), iters=5, warmup=2),
        "eager pipeline step ms": cuda_ms(
            lambda: eager.train_step(x, t, lr=LR), iters=3, warmup=1),
        "serial compiled chip step ms": cuda_ms(
            lambda: serial.train_step(x, t, lr=LR), iters=5, warmup=2)}
    times.update({k.replace(" ms", " samples/s"): B / v * 1e3
                  for k, v in list(times.items())})
    prof = profile_device(lambda: pipe.train_step(x, t, lr=LR))
    print(f"pipeline training ({PIPE_APP}, chips {list(PIPE_GROUPS)} with "
          f"{PIPE_CORES} cores, batch {B}): launches compiled "
          f"{json.dumps(launches_c)} + 4 captures in the first step, none "
          f"in the second; eager {json.dumps(launches_e)} (2 steps each); "
          f"compiled == eager == the serial compiled chip bit for bit; "
          f"mnist_class split {list(ragged.groups)} at {RAGGED_BATCH} "
          f"(second step n_micro 2) bit for bit the serial chip, launches "
          f"{json.dumps(launches_r)}; torch.sum over fan-out tiles vs "
          f"in-order adds, elements apart by (r x c) "
          f"{json.dumps(fold_order)} of r x {B} x 400; report vs "
          f"pipeline_cost "
          + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    print(f"pipeline training times [{card_line()}]: " + json.dumps(times))
    print(f"profile, compiled pipeline train_step {PIPE_APP} x {B} "
          f"(profiler on): " + json.dumps(prof))
    fwd = (launches_c["crossbar_fwd_stacked"]
           + launches_e["crossbar_fwd_stacked"]
           + launches_r["crossbar_fwd_stacked"])
    return {"pipe": pipe, "fwd": fwd,
            "train": launches_c["crossbar_train_stacked"]
            + launches_r["crossbar_train_stacked"],
            "bwd": launches_e["crossbar_bwd_stacked"],
            "pulse": launches_e["pulse_update_stacked"], **times,
            "idle_share": prof["device_idle_share"]}


def pipeline_serve_path(ops, csim, fabric, chip_mod, pipe, mlp_forward,
                        spec, gen) -> dict:
    """Pipeline serving (module docstring, step 16)."""
    from repro_torch.runtime.serve_loop import RequestQueue
    Q, m = PIPE_REQUESTS, SERVE_M
    S = len(pipe.placement.stages)
    D = pipe.placement.dims[0]
    x = uniform((Q * m, D), -0.5, 0.5, gen)
    reqs = list(x.reshape(Q, m, D))

    def session(p):
        queue = RequestQueue(reqs)
        stats = fabric.PipelineServer(p).run(queue)
        return torch.stack(queue.results()), stats
    beats = S - 1 + Q
    zero_counts(ops, csim)
    out_c, stats_c = session(pipe)
    torch.cuda.synchronize()
    launches_c, captures = read_counts(ops), csim.capture_counts()
    if launches_c != {"crossbar_fwd_stacked": beats} \
            or list(captures.values()) != [1] \
            or next(iter(captures))[0] != "serve_scan":
        raise AssertionError(f"compiled pipeline session launched "
                             f"{launches_c}, captured {captures}: expected "
                             f"one launch a beat ({beats}) and one program")
    layers = clone_layers(pipe)
    eager = fabric.ChipPipeline(layers, spec, name=PIPE_APP, device="cuda",
                                compiled=False)
    # eager launches from the owner map: per beat, each chip holding a
    # request runs one launch, and one more when its slice aggregates
    want_e = 0
    for b in range(beats):
        for g in eager.groups:
            if any(0 <= b - s < Q for s in g):
                want_e += 1 + any(eager.placement.stages[s].row_tiles > 1
                                  for s in g)
    zero_counts(ops, csim)
    out_e, stats_e = session(eager)
    torch.cuda.synchronize()
    launches_e = read_counts(ops)
    if launches_e != {"crossbar_fwd_stacked": want_e}:
        raise AssertionError(f"eager pipeline server launched "
                             f"{launches_e}, expected {want_e} from the "
                             f"owner map")
    if not torch.equal(out_c, out_e) or stats_c != stats_e:
        raise AssertionError(f"compiled session and eager server differ: "
                             f"{float((out_c - out_e).abs().max())}, "
                             f"{stats_c} vs {stats_e}")
    beat = stats_c["beat_us"]
    if stats_c["beats"] != beats or stats_c["retired"] != Q * m \
            or not abs(beat - 0.77) <= 0.0077 \
            or stats_c["latency_us"] != S * beat:
        raise AssertionError(f"pipeline serving stats {stats_c}")
    chip = chip_mod.VirtualChip(layers, spec, name=PIPE_APP, device="cuda")
    wave = chip.infer(x, count=False)
    flips = check_chip_wave(chip, x, wave, mlp_forward, spec)
    serve_err = close(out_c.reshape(Q * m, -1), wave,
                      "pipeline served outputs vs the chip's wave")
    t0 = time.perf_counter()
    session(pipe)
    torch.cuda.synchronize()
    host_beat_us = (time.perf_counter() - t0) / beats * 1e6
    times = {"compiled session ms": cuda_ms(lambda: session(pipe), iters=5,
                                            warmup=1),
             "eager session ms": cuda_ms(lambda: session(eager), iters=2,
                                         warmup=1),
             "compiled session host us per beat": host_beat_us}
    times["compiled session device samples/s"] = \
        Q * m / times["compiled session ms"] * 1e3
    prof = profile_device(lambda: session(pipe))
    print(f"pipeline serving ({PIPE_APP}, {pipe.n_chips} chips, {Q} "
          f"requests of {m}): {beats} beats, launches compiled "
          f"{json.dumps(launches_c)} (1 a beat, one program), eager "
          f"{json.dumps(launches_e)} (from the owner map); outputs and "
          f"stats equal; vs the chip's wave max |err| {serve_err}, vs "
          f"mlp_forward {flips} samples after a boundary flip; stats "
          + json.dumps(stats_c))
    print(f"pipeline serving times [{card_line()}]: " + json.dumps(times))
    print("profile, compiled pipeline serving session (profiler on): "
          + json.dumps(prof))
    return {"fwd": launches_c["crossbar_fwd_stacked"]
            + launches_e["crossbar_fwd_stacked"], "err": serve_err,
            **times, "idle_share": prof["device_idle_share"]}


def pipeline_farm_path(ops, csim, fabric, build_chip, hw, gen) -> dict:
    """The farm of pipelines (module docstring, step 17)."""
    from repro_torch.kernels import crossbar as xbk
    C, B = PF_PIPELINES, PF_BATCH
    serial = build_chip("mnist_class", seed=SEED, device="cuda")
    pf = fabric.PipelineFarm(clone_layers(serial), n_pipelines=C,
                             n_chips=PF_CHIPS, name="mnist_class",
                             device="cuda")
    S = len(serial.placement.stages)
    data = [(uniform((B, 784), -0.5, 0.5, gen),
             uniform((B, 10), -0.5, 0.5, gen)) for _ in range(2)]
    rec = LaunchRecorder(ops, tuple(FARM_PLAIN))
    csim.kernel_ops = rec
    afters, errs_f = [], []
    try:
        zero_counts(ops, csim)
        for x, t in data:
            errs_f.append(pf.train_step(x, t, lr=LR))
            afters.append(envelope(pf.farm))
        torch.cuda.synchronize()
        launches, captures = read_counts(ops), csim.capture_counts()
    finally:
        csim.kernel_ops = ops
    want = {"crossbar_fwd_stacked": 2 * S, "crossbar_bwd_stacked": 2 * S,
            "crossbar_dw_stacked": 2 * S}
    if launches != want or list(captures.values()) != [1]:
        raise AssertionError(f"pipeline farm steps launched {launches}, "
                             f"captured {captures}: expected {want} and "
                             f"one capture")
    errs = check_launches(xbk, rec.calls, "pipeline farm")
    check_in_envelope(pf.farm, rec.calls, 0, "pipeline farm")
    if not pf.replicas_in_sync():
        raise AssertionError("pipeline farm replicas out of lockstep")
    grec = GraphRecorder(ops)
    csim.kernel_ops = grec
    try:
        err_s = serial.train_step(data[0][0], data[0][1], lr=LR)
    finally:
        csim.kernel_ops = ops
    serial_err = float((errs_f[0] - err_s).abs().max())
    if not serial_err <= G_ATOL:
        raise AssertionError(f"pipeline farm error vs serial chip: "
                             f"{serial_err}")
    excused = 0
    for (xs, ds, lr_t, _), st in zip(grec.run[:S],
                                     reversed(serial.placement.stages)):
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr_t, max_dw=MAX_DW,
                                        levels=LEVELS)
        T = counts.shape[0]
        for c in range(C):
            excused += check_conductances(
                (afters[0][0][st.index, c * T:(c + 1) * T],
                 afters[0][1][st.index, c * T:(c + 1) * T]),
                (st.g_plus, st.g_minus), counts,
                f"pipeline farm replica {c} vs serial chip stage "
                f"{st.index}")
    frep, plink = pf.report()
    pc = hw.pipeline_cost("mnist_class", list(serial.placement.dims),
                          n_chips=PF_CHIPS, batch=B)
    if (plink["link_bits_fwd"], plink["link_bits_bwd"]) != \
            (pc.link_bits_fwd, pc.link_bits_bwd):
        raise AssertionError(f"pipeline farm link bits {plink} vs "
                             f"pipeline_cost {pc.link_bits_fwd}, "
                             f"{pc.link_bits_bwd}")
    cmp_ = {**frep.compare_chip_sum(), **frep.compare_hw()}
    if not all(v <= 0.01 for v in cmp_.values()):
        raise AssertionError(f"pipeline farm report vs farm_cost: {cmp_}")
    step_ms = cuda_ms(lambda: pf.train_step(data[0][0], data[0][1], lr=LR),
                      iters=5, warmup=2)
    print(f"pipeline farm (mnist_class, {C} pipelines x {pf.groups}, "
          f"batch {C} x {B // C}): launches {json.dumps(launches)} + 1 "
          f"capture (2 steps); every launch held against plain "
          f"{json.dumps(errs)}; replicas in sync; vs the serial compiled "
          f"chip: max |err| {serial_err}, {excused} excused cells (count "
          f"within 1e-4 of k + 1/2); link bits {json.dumps(plink)} == "
          f"pipeline_cost; step {step_ms:.4f} ms [{card_line()}]")
    return {"fwd": launches["crossbar_fwd_stacked"],
            "bwd": launches["crossbar_bwd_stacked"],
            "dw": launches["crossbar_dw_stacked"], "errs": errs,
            "excused": excused, "step ms": step_ms}


# ---------------------------------------------------------------------------
# The LM training path (qwen2-0.5b at full width): standard and crossbar
# kernel modes, and the reduced step on the card against the CPU
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 2048, 3
XB_BATCH, XB_LEN, XB_STEPS = 4, 1024, 2
XB_PROJECTIONS = 7       # wq, wk, wv, wo, wi, wg, wo of the MLP, per layer
XB_NAMES = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw")
XB_BAR = 1e-5            # kernel vs plain, relative to sum_k |x_k| |w_k|
CPU_STEP_BAR = 1e-4      # card vs CPU gradients, of each leaf's largest
QUANT_NEAR = 1e-4        # a quantizer input this close to a code boundary


def zero_lm_counts(ops) -> None:
    """The flash and crossbar counts at 0."""
    zero_flash_counts(ops)
    for n in XB_NAMES:
        getattr(ops, n).launches = 0


def launch_train_config(cfg, optimizer: str, steps: int):
    """The optimizer ``launch/train.py`` builds: ``make_optimizer(name,
    cosine_schedule(3e-3, max(steps // 20, 1), steps))``."""
    from repro_torch.optim import cosine_schedule, make_optimizer
    lr = cosine_schedule(3e-3, warmup_steps=max(steps // 20, 1),
                         total_steps=steps)
    return make_optimizer(optimizer, lr)


def attention_bwd_ms(fak, cfg, B: int, S: int) -> float:
    """Device time of one layer's attention backward at (B, S) in bf16
    (``flash_attention_vjp``: the chunked function recomputed under
    autograd over the config's 512 x 512 chunks), CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hd = cfg.head_dim

    def rnd(heads):
        return torch.randn((B, S, heads, hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(cfg.n_heads), rnd(cfg.n_kv_heads), \
        rnd(cfg.n_kv_heads), rnd(cfg.n_heads)
    return cuda_ms(lambda: fak.flash_attention_vjp(
        q, k, v, do, scale=hd ** -0.5, causal=True, semantics="chunked",
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk), iters=3, warmup=1)


def attention_bwd_yardsticks(cfg, B: int, S: int) -> dict:
    """The flash backward's bound and library time at (B, S), causal, bf16:
    five products (S recomputed, dV, dP, dQ, dK) of 2 B H hd sum_i min(i +
    1, S) FLOPs each at the bf16 tensor-core peak, against q, k, v, o, dO
    read and dQ, dK, dV written once; and the backward alone of
    ``scaled_dot_product_attention`` (``enable_gqa``; the port never calls
    it) by CUDA events, its forward made outside the timed region."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rnd(heads, grad=True):
        return torch.randn((B, heads, S, hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(grad)

    q, k, v = rnd(H), rnd(K), rnd(K)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         scale=hd ** -0.5, enable_gqa=True)
    do = rnd(H, grad=False)
    ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                             retain_graph=True),
                 iters=5, warmup=1)
    pairs = S * (S + 1) // 2
    op_ms = 5 * 2.0 * B * H * hd * pairs / BF16_FLOPS * 1e3
    byte_ms = 2 * (4 * B * S * H * hd + 4 * B * S * K * hd) \
        / HBM_BYTES_S * 1e3
    return {"library ms (SDPA backward)": ms,
            "bound ms": max(op_ms, byte_ms),
            "bound by": "operations" if op_ms >= byte_ms else "bytes"}


def params_equal(a, b) -> tuple[bool, float]:
    from repro_torch.dist.sharding import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    same = all(torch.equal(x, y) for x, y in zip(la, lb))
    return same, max((float((x - y).abs().max()) for x, y in zip(la, lb)),
                     default=0.0)


def lm_train_standard(ops, fak) -> dict:
    """Step 18 (a): ``Trainer`` for the full qwen2-0.5b config on cuda (bf16
    compute, remat "full"), adamw on the launcher's cosine schedule,
    ``TokenStream(151936, 2048, 4, seed=0)``, 3 steps with a checkpoint at
    step 2, the flash counts at 0 before and read after (per step 24
    forward launches + 24 recomputed, all wgmma/chunked); a fresh Trainer
    on the same directory resumes at step 2 and its step-3 parameters equal
    the uninterrupted run's bit for bit.  Both Trainers step through their
    captured graph (one capture each); the step alone is then timed
    eagerly (``make_train_step``)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.runtime import Trainer, make_train_step
    cfg = get_config(LM_ARCH)
    stream = TokenStream(cfg.vocab_size, TRAIN_LEN, TRAIN_BATCH, seed=SEED)
    per_step = 2 * cfg.n_layers
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(cfg, launch_train_config(cfg, "adamw",
                                                   TRAIN_STEPS),
                          ckpt_dir=d, ckpt_every=2, seed=SEED,
                          device="cuda")
        zero_flash_counts(ops)
        t0 = time.perf_counter()
        state, hist = trainer.run(stream, TRAIN_STEPS, log_every=1)
        run_s = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        routes = dict(fak_routes())
        check_flash_counts(ops, per_step * TRAIN_STEPS, "wgmma",
                           f"{TRAIN_STEPS} training steps")
        for h in hist:
            if not (math.isfinite(h["loss"]) and math.isfinite(
                    h["grad_norm"])):
                raise AssertionError(f"training step {h['step']}: loss "
                                     f"{h['loss']}, grad norm "
                                     f"{h['grad_norm']}")
        resumed = Trainer(cfg, launch_train_config(cfg, "adamw",
                                                   TRAIN_STEPS),
                          ckpt_dir=d, ckpt_every=2, seed=SEED,
                          device="cuda")
        r_state = resumed.restore_or_init()
        if r_state.step != 2:
            raise AssertionError(f"resumed at step {r_state.step}, not 2")
        r_state, r_hist = resumed.run(stream, TRAIN_STEPS, log_every=1)
        same, diff = params_equal(r_state.params, state.params)
        if not same:
            raise AssertionError(f"resumed step-3 parameters differ from the "
                                 f"uninterrupted run's by up to {diff}")
        if (trainer.step.captures, resumed.step.captures) != (1, 1):
            raise AssertionError(f"captures {trainer.step.captures} and "
                                 f"{resumed.step.captures}, not one each")
        if r_hist[-1]["loss"] != hist[-1]["loss"]:
            raise AssertionError("resumed step-3 loss differs")
    del r_state, resumed
    gc_collect()                # the resumed Trainer's graph and its pool
    # the step alone: CUDA events over 2 steps after the run's warm-up
    step = make_train_step(trainer.model, trainer.opt)
    batch = {k: v.cuda() for k, v in stream.batch_at(0).items()}
    p, o = state.params, state.opt_state
    ms = cuda_ms(lambda: step(p, o, batch, 0), iters=2, warmup=0)
    prof = profile_device(lambda: step(p, o, batch, 0), reps=1)
    bwd_ms = attention_bwd_ms(fak, cfg, TRAIN_BATCH, TRAIN_LEN)
    bwd_yard = attention_bwd_yardsticks(cfg, TRAIN_BATCH, TRAIN_LEN)
    tokens = TRAIN_BATCH * TRAIN_LEN
    out = {"steps": TRAIN_STEPS, "flash_attention launches": launches,
           "flash_attention routes": routes,
           "first loss": hist[0]["loss"], "ln vocab": math.log(
               cfg.vocab_size),
           "losses": [h["loss"] for h in hist],
           "grad norms": [h["grad_norm"] for h in hist],
           "run s (3 steps, checkpoint at 2)": run_s,
           "resumed at step 2, step-3 parameters bit for bit": True,
           "step ms": ms, "tokens/s": tokens / ms * 1e3,
           "attention backward ms per layer": bwd_ms,
           "attention backward ms per step": bwd_ms * cfg.n_layers,
           "attention backward yardsticks": bwd_yard,
           "profile": prof}
    print(f"LM training, standard (qwen2-0.5b full width, bf16 compute, "
          f"remat full, {TRAIN_BATCH} x {TRAIN_LEN} tokens, adamw): "
          f"{launches} flash_attention launches in {TRAIN_STEPS} steps "
          f"({per_step} a step: {cfg.n_layers} forward + {cfg.n_layers} "
          f"recomputed, all wgmma/chunked); first loss "
          f"{hist[0]['loss']:.4f} (ln {cfg.vocab_size} = "
          f"{math.log(cfg.vocab_size):.4f}), losses "
          f"{[round(h['loss'], 4) for h in hist]}, grad norms finite; "
          f"resumed at step 2, step-3 parameters bit for bit; step "
          f"{ms:.3f} ms, {out['tokens/s']:.0f} tokens/s; attention backward "
          f"{bwd_ms:.3f} ms a layer ({bwd_ms * cfg.n_layers:.3f} ms a step; "
          f"bound {bwd_yard['bound ms']:.4f} ms, SDPA's backward "
          f"{bwd_yard['library ms (SDPA backward)']:.4f} ms); "
          f"profile span {prof['span_ms']:.3f} ms, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])} [{card_line()}]")
    print("profile of the standard step (profiler on): "
          + json.dumps(prof))
    return out


class Layer0Recorder:
    """Keeps the operands and outputs of chosen kernel launches while the
    main path runs: the first ``keep`` forward launches and the last
    ``keep`` bwd and dw launches (layer 0's, in a step's forward and
    backward), by wrapping the launchers that ``ops`` dispatches to.
    With ``offload`` they are kept in host memory until ``to_device``
    (a full-width layer's fp32 conductance copies would not fit beside
    the step)."""

    def __init__(self, xbk, keep: int, offload: bool = False):
        import collections
        self.xbk, self.keep, self.offload = xbk, keep, offload
        self.orig = {n: getattr(xbk, f"{n}_kernel")
                     for n in ("crossbar_fwd", "crossbar_bwd",
                               "crossbar_dw")}
        self.fwd: list = []
        self.bwd = collections.deque(maxlen=keep)
        self.dw = collections.deque(maxlen=keep)

    def __enter__(self):
        def wrap(name, store, first):
            fn = self.orig[name]

            def rec(*args, **kwargs):
                out = fn(*args, **kwargs)
                if not first or len(store) < self.keep:
                    entry = (args, kwargs, out)
                    store.append(_moved(entry, "cpu") if self.offload
                                 else entry)
                return out
            setattr(self.xbk, f"{name}_kernel", rec)
        wrap("crossbar_fwd", self.fwd, True)
        wrap("crossbar_bwd", self.bwd, False)
        wrap("crossbar_dw", self.dw, False)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.xbk, f"{n}_kernel", fn)
        return False

    def to_device(self) -> None:
        """The offloaded launches back on the card."""
        for store in (self.fwd, self.bwd, self.dw):
            entries = [_moved(e, "cuda") for e in store]
            store.clear()
            store.extend(entries)


def _moved(tree, device: str):
    """``tree`` (tuples, dicts, tensors, other leaves) with its tensors
    copied to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree


def check_relative(got, want, mag, what) -> float:
    """Raise unless |got - want| <= XB_BAR * mag everywhere (``mag`` the
    sum of the terms' magnitudes); returns max |got - want| / mag."""
    err = (got - want).abs()
    if not bool((err <= XB_BAR * mag + 1e-30).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())}, "
                             f"relative {float((err / mag).max())}")
    return float((err / mag.clamp_min(1e-30)).max())


def check_layer0_launches(xbk, rec) -> dict:
    """Each recorded launch against its plain version on its own operands,
    within XB_BAR of sum_k |x_k| |w_k| (fp32 sums of up to 4864 terms in
    other orders)."""
    worst = {"crossbar_fwd": 0.0, "crossbar_bwd": 0.0, "crossbar_dw": 0.0}

    def plain(kw):      # the plain versions have no tile
        return {k: v for k, v in kw.items() if k not in ("tile", "run")}

    for (xs, gp, gm), kw, y in rec.fwd:
        want = xbk.crossbar_fwd_plain(xs, gp, gm, **plain(kw))
        mag = torch.matmul(xs.abs(), (gp - gm).abs())
        worst["crossbar_fwd"] = max(worst["crossbar_fwd"], check_relative(
            y, want, mag, f"layer-0 fwd {tuple(xs.shape)} x "
                          f"{tuple(gp.shape)}"))
    for (dys, gp, gm), kw, dx in rec.bwd:
        want = xbk.crossbar_bwd_plain(dys, gp, gm, **plain(kw))
        d = xbk._dequant(dys, kw.get("dy_scale"))
        mag = torch.matmul(d.abs(), (gp - gm).abs().transpose(1, 2))
        worst["crossbar_bwd"] = max(worst["crossbar_bwd"], check_relative(
            dx, want, mag, f"layer-0 bwd {tuple(dys.shape)} {dys.dtype}"))
    for (xs, dys), kw, dw in rec.dw:
        want = xbk.crossbar_dw_plain(xs, dys, **plain(kw))
        d = xbk._dequant(dys, kw.get("dy_scale"))
        mag = torch.matmul(xs.abs().transpose(1, 2), d.abs())
        worst["crossbar_dw"] = max(worst["crossbar_dw"], check_relative(
            dw, want, mag, f"layer-0 dw {tuple(xs.shape)} {dys.dtype}"))
    return worst


def lm_crossbar_rows(xbk, rec, app: str = "qwen2-0.5b", iters: int = 20,
                     device: bool = True, in_bytes: int = 4) -> list[dict]:
    """Kernel / plain / ``torch.bmm`` times over ``iters`` calls (and,
    with ``device``, device times) of the recorded layer-0 launches at
    each distinct LM shape, beside the bound (the forward's with x and g±
    at ``in_bytes`` each, as its wrapper received them)."""
    rows, seen = [], set()
    for (xs, gp, gm), _, _ in rec.fwd:
        key = ("crossbar_fwd",) + tuple(xs.shape) + (gp.shape[2],)
        if key not in seen:
            seen.add(key)
            rows.append(time_shape(xbk, app, xs, gp, gm, iters, device,
                                   in_bytes))
    for (dys, gp, gm), kw, _ in rec.bwd:
        key = ("crossbar_bwd",) + tuple(dys.shape) + (gp.shape[1],)
        if key not in seen:
            seen.add(key)
            rows.append(time_bwd_codes(xbk, dys, kw["dy_scale"], gp, gm,
                                       iters, device))
    for (xs, dys), kw, _ in rec.dw:
        key = ("crossbar_dw",) + tuple(xs.shape) + (dys.shape[2],)
        if key not in seen:
            seen.add(key)
            rows.append(time_dw_codes(xbk, xs, dys, kw["dy_scale"], iters,
                                      device))
    return rows


def print_crossbar_rows(rows: list[dict]) -> None:
    def ms4(x):
        return "not measured" if x is None else f"{x:.4f}"
    for r in rows:
        print(f"  {r['kernel']} (M, K, N) = ({r['M']}, {r['K']}, {r['N']})"
              f"{' int8 codes' if r.get('codes') else ''}: {r['ms']:.4f} ms "
              f"(device {ms4(r['ms_device'])}), plain {r['plain_ms']:.4f}, "
              f"torch.bmm {r['library_ms']:.4f} (device "
              f"{ms4(r['library_ms_device'])}), bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")


def lm_train_crossbar(ops, xbk) -> dict:
    """Step 18 (b): the full config with ``crossbar=True,
    xbar_use_kernel=True`` and pulse_sgd (the launcher's schedule) at
    XB_BATCH x XB_LEN tokens (M = 4096), XB_STEPS steps of
    ``make_train_step``, the crossbar counts at 0 before and read after:
    per step 7 projections x 24 layers forward launches, twice (remat
    "full"), and as many bwd and dw; layer 0's launches of the first step
    held against plain; every conductance in [0, 4] after each step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.dist.sharding import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.runtime import make_train_step
    from repro_torch.runtime.checkpoint import _walk
    cfg = get_config(LM_ARCH, crossbar=True, xbar_use_kernel=True)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    opt = launch_train_config(cfg, "pulse_sgd", XB_STEPS)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    stream = TokenStream(cfg.vocab_size, XB_LEN, XB_BATCH, seed=SEED)
    per_pass = XB_PROJECTIONS * cfg.n_layers
    zero_lm_counts(ops)
    metrics, ranges = [], []
    for s in range(XB_STEPS):
        batch = {k: v.cuda() for k, v in stream.batch_at(s).items()}
        if s == 0:
            with Layer0Recorder(xbk, XB_PROJECTIONS) as rec:
                params, opt_state, m = step(params, opt_state, batch, s)
        else:
            params, opt_state, m = step(params, opt_state, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
        g = [t for path, t in _walk(params)
             if any(k in ("g_plus", "g_minus") for k in path)]
        lo, hi = min(float(t.min()) for t in g), max(float(t.max())
                                                     for t in g)
        ranges.append((lo, hi))
        if lo < 0.0 or hi > cfg.xbar_w_max:
            raise AssertionError(f"crossbar step {s}: conductances in "
                                 f"[{lo}, {hi}], outside [0, 4]")
    launches = {n: getattr(ops, n).launches for n in XB_NAMES}
    want = {"crossbar_fwd": 2 * per_pass * XB_STEPS,
            "crossbar_bwd": per_pass * XB_STEPS,
            "crossbar_dw": per_pass * XB_STEPS}
    if launches != want:
        raise AssertionError(f"crossbar kernel mode ran {launches}, "
                             f"expected {want}")
    flash = ops.flash_attention.launches
    check_flash_counts(ops, 2 * cfg.n_layers * XB_STEPS, "wgmma",
                       "crossbar-mode steps")
    for mt in metrics:
        if not (math.isfinite(mt["loss"]) and math.isfinite(
                mt["grad_norm"])):
            raise AssertionError(f"crossbar step: {mt}")
    errs = check_layer0_launches(xbk, rec)
    rows = lm_crossbar_rows(xbk, rec)
    del rec
    batch = {k: v.cuda() for k, v in stream.batch_at(0).items()}
    ms = cuda_ms(lambda: step(params, opt_state, batch, 0), iters=2,
                 warmup=0)
    prof = profile_device(lambda: step(params, opt_state, batch, 0),
                          reps=1, match=r"crossbar_(fwd|bwd|dw)")
    share = (None if prof["device_busy_ms"] is None
             else prof["matched_ms"] / prof["device_busy_ms"])
    tokens = XB_BATCH * XB_LEN
    out = {"steps": XB_STEPS, "launches": launches,
           "flash_attention launches": flash,
           "layer-0 launches vs plain, max |err| / sum |x||w|": errs,
           "conductance range after each step": ranges,
           "losses": [m["loss"] for m in metrics],
           "grad norms": [m["grad_norm"] for m in metrics],
           "step ms": ms, "tokens/s": tokens / ms * 1e3,
           "crossbar kernels' share of device time": share,
           "profile": prof, "rows": rows,
           "params": sum(t.numel() for t in tree_leaves(params))}
    print(f"LM training, crossbar kernel mode (qwen2-0.5b full width, "
          f"pulse_sgd, {XB_BATCH} x {XB_LEN} tokens, M = {tokens}): "
          f"launches {json.dumps(launches)} in {XB_STEPS} steps "
          f"({2 * per_pass} fwd, {per_pass} bwd, {per_pass} dw a step), "
          f"{flash} flash launches; layer 0's launches vs plain (max |err| "
          f"/ sum |x||w|, bar {XB_BAR}) {json.dumps(errs)}; conductances in "
          f"{ranges}; losses {[round(m['loss'], 4) for m in metrics]}; step "
          f"{ms:.3f} ms, {out['tokens/s']:.0f} tokens/s, crossbar kernels "
          f"{ms3(share)} of {ms3(prof['device_busy_ms'])} ms busy, idle "
          f"share {ms3(prof['device_idle_share'])} [{card_line()}]")
    print("profile of the crossbar-mode step (profiler on): "
          + json.dumps(prof))
    print_crossbar_rows(rows)
    return out


def count_near_boundaries(tq) -> tuple[dict, callable]:
    """Wrap the port's activation and error quantizers to count inputs
    within QUANT_NEAR of a code boundary; returns (counter, restore)."""
    seen = {"n": 0}
    fq, eq = tq.fake_quant, tq.error_quantize

    def near(x, bits):
        x = x.detach().double()
        scale = x.abs().max() / (2 ** (bits - 1) - 1)
        if float(scale) > 0:
            r = (x / scale).abs()
            seen["n"] += int(((r - torch.floor(r) - 0.5).abs()
                              < QUANT_NEAR).sum())

    def counted_fq(x, bits, *a, **kw):
        near(x, bits)
        return fq(x, bits, *a, **kw)

    def counted_eq(x, bits=tq.ERROR_BITS, *a, **kw):
        near(x, bits)
        return eq(x, bits, *a, **kw)

    tq.fake_quant, tq.error_quantize = counted_fq, counted_eq

    def restore():
        tq.fake_quant, tq.error_quantize = fq, eq
    return seen, restore


def xbar_projections(params) -> tuple[int, int]:
    """The crossbar products one forward launches, as (outside the
    periods, inside them): the paired (g_plus, g_minus) projections, a
    stacked one once per period (or per encoder and decoder layer); the
    head's product and ``src_proj``'s are plain and are not counted.
    Remat recomputes only the stacked layers' in the backward."""
    from repro_torch.dist.sharding import tree_leaves

    def walk(tree, mult):
        if isinstance(tree, dict):
            if "g_plus" in tree:
                return mult
            return sum(walk(v, mult) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return sum(walk(v, mult) for v in tree)
        return 0
    # the stacked layers: the LM's periods, an encoder-decoder's stacks
    stacked = [k for k in ("stack", "encoder", "decoder") if k in params]
    outside = sum(walk(v, 1) for k, v in params.items()
                  if k not in stacked + ["lm_head"])
    inside = sum(walk(params[k], tree_leaves(params[k])[0].shape[0])
                 for k in stacked)
    return outside, inside


def lm_train_card_vs_cpu(ops, arch: str = LM_ARCH) -> dict:
    """Step 18 (c), 20 (d), 21 (d), 22 (d) and 23 (d): one reduced
    ``make_train_step`` step of ``arch`` (sgd 0.1, float32 compute; an
    encoder-decoder's batch carries 96 source frames, a VLM's its
    ``patch_embeds`` and the config's ``grad_accum`` of 4 microbatches) on
    the card against the same step on the CPU, from the same parameters
    and batch, in standard and
    kernel mode, the counts at 0 before and read after.  The loss, its
    aux term and the grad norm within 1e-5 relative, each gradient leaf
    within CPU_STEP_BAR of its largest magnitude, each new parameter
    within 1e-6 (1 + |p|) + 0.1 x that; a miss is excused only where the
    card's quantizers (kernel mode) saw an input within QUANT_NEAR of a
    code boundary or its MoE routers a near-tie (margin below
    MOE_NEAR_TIE), counted: then the loss within 1e-4 and each leaf
    within 10 % in the norm.  An encoder-decoder's kernel mode is chaotic
    at this size (its reduced attention projections' gradients move ~9 %
    in the norm when the CPU step starts from parameters perturbed in the
    last bit): a miss there, and in a VLM's kernel mode, is held within
    twice the CPU's own spread (``cpu_spread``) where that exceeds those
    bars."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import quantization as tq
    from repro_torch.data import TokenStream
    from repro_torch.dist.sharding import tree_leaves, tree_map
    from repro_torch.layers import moe
    from repro_torch.models import build_model
    from repro_torch.models.lm import stack_layout
    from repro_torch.optim import Optimizer, sgd
    from repro_torch.runtime import make_train_step
    out = {}
    outside = inside = 0
    zero_lm_counts(ops)
    for mode, kw in (("standard", {}),
                     ("kernel", dict(crossbar=True, xbar_use_kernel=True))):
        cfg = get_reduced_config(arch, compute_dtype="float32", **kw)
        p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(
            SEED))
        batch = TokenStream(cfg.vocab_size, 64, 4, seed=SEED).batch_at(0)
        if cfg.family == "encdec":
            batch = {"src_frames": encdec_batch(
                cfg, 4, 96, 1, torch.Generator().manual_seed(SEED),
                device="cpu")["src_frames"],
                "tgt_tokens": batch["tokens"], "labels": batch["labels"]}
        if cfg.vlm_patches:
            batch["patch_embeds"] = uniform_patches(
                cfg, 4, torch.Generator().manual_seed(SEED), "cpu")
        accum = cfg.grad_accum if cfg.family == "vlm" else 1

        def step_on(dev, p0=p0, cfg=cfg, batch=batch, mode=mode,
                    accum=accum):
            """One sgd step on ``dev`` from ``p0``: (metrics, gradients,
            new parameters, near-boundary inputs or near-ties)."""
            nonlocal outside, inside
            base, seen_g = sgd(0.1), []

            def update(grads, state, params, step=0, **kw):
                seen_g.append([g.cpu() for g in tree_leaves(grads)])
                return base.update(grads, state, params, step=step, **kw)

            opt = Optimizer(base.init, update, "sgd", base.scalars)
            params = tree_map(lambda t: t.to(dev, copy=True), p0)
            if mode == "kernel":
                outside, inside = xbar_projections(params)
            seen, restore = count_near_boundaries(tq)
            moe.ROUTING = []
            try:
                params, _, m = make_train_step(
                    build_model(cfg, dev), opt, grad_accum=accum)(
                    params, opt.init(params),
                    {k: v.to(dev) for k, v in batch.items()}, 0)
                ties = sum(int((r.margin < MOE_NEAR_TIE).sum())
                           for r in moe.ROUTING)
            finally:
                restore()
                moe.ROUTING = None
            return ({k: float(v) for k, v in m.items()}, seen_g[0],
                    [t.cpu() for t in tree_leaves(params)],
                    seen["n"] + ties)

        runs = {dev: step_on(dev) for dev in ("cuda", "cpu")}
        (mc, gc, pc, near), (mp, gp, pp, _) = runs["cuda"], runs["cpu"]
        err = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(gc, gp))
        perr = max(float(((a - b).abs() - 1e-6 * (1 + b.abs())).max()
                         / (0.1 * g.abs().max()).clamp_min(1e-30))
                   for a, b, g in zip(pc, pp, gp))
        loss_rel = abs(mc["loss"] - mp["loss"]) / abs(mp["loss"])
        gn_rel = abs(mc["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
        aux_c, aux_p = mc.get("aux", 0.0), mp.get("aux", 0.0)  # encdec: none
        aux_rel = abs(aux_c - aux_p) / max(abs(aux_p), 1e-30)
        strict = (err <= CPU_STEP_BAR and perr <= CPU_STEP_BAR
                  and loss_rel <= 1e-5 and gn_rel <= 1e-5
                  and aux_rel <= 1e-5)
        spread = None
        if not strict:
            nrel = [float(torch.linalg.norm(a - b) / torch.linalg.norm(
                b).clamp_min(1e-30)) for a, b in zip(gc, gp)]
            loss_bar, leaf_bar = 1e-4, [0.1] * len(nrel)
            if cfg.family in ("encdec", "vlm") and mode == "kernel":
                spread = cpu_spread(step_on, p0, mp["loss"], gp)
                loss_bar = max(loss_bar, 2 * spread["loss rel"])
                leaf_bar = [max(0.1, 2 * x) for x in spread["leaf nrel"]]
            if near == 0 or loss_rel > loss_bar or any(
                    n > b for n, b in zip(nrel, leaf_bar)):
                raise AssertionError(f"card vs CPU ({arch} {mode}): "
                                     f"gradient {err}, parameters {perr}, "
                                     f"loss {loss_rel}, aux {aux_rel}, "
                                     f"grad norm {gn_rel}, {near} "
                                     f"near-boundary inputs or near-ties; "
                                     f"leaf nrel {max(nrel)}, spread "
                                     f"{spread}")
        out[mode] = {"max |grad err| / max |grad|": err,
                     "new params, err over the bar's step part": perr,
                     "loss rel": loss_rel, "grad norm rel": gn_rel,
                     "aux": aux_c, "aux rel": aux_rel,
                     "strict": strict,
                     "quantizer inputs near a boundary or routing "
                     "near-ties (card)": near}
        if spread is not None:
            out[mode]["CPU spread (loss rel, max leaf nrel)"] = [
                spread["loss rel"], max(spread["leaf nrel"])]
            out[mode]["card vs CPU max leaf nrel"] = max(nrel)
    launches = {n: getattr(ops, n).launches for n in XB_NAMES}
    rcfg = get_reduced_config(arch)
    accum = rcfg.grad_accum if rcfg.family == "vlm" else 1

    def attention(kinds):       # the blocks that launch the flash kernel
        return sum(k not in ("rec", "ssd") for k in kinds)
    # a step: the forward, and the periods' (an encoder-decoder's every
    # layer's) launches again under remat, once a microbatch
    if rcfg.family == "encdec":
        flash = 2 * (rcfg.encoder_layers + 2 * rcfg.n_layers)
    else:
        lay = stack_layout(rcfg)
        flash = accum * (attention(lay.prefix) + attention(lay.suffix)
                         + 2 * lay.periods * attention(lay.pattern))
    want = {"crossbar_fwd": accum * (outside + 2 * inside),  # remat: twice
            "crossbar_bwd": accum * (outside + inside),
            "crossbar_dw": accum * (outside + inside)}
    if launches != want:
        raise AssertionError(f"card vs CPU kernel mode ran {launches}, "
                             f"expected {want}")
    out["launches"] = launches
    out["flash_attention launches"] = ops.flash_attention.launches
    check_flash_counts(ops, 2 * flash, "simt", "card vs CPU steps")
    print(f"LM training, card vs CPU (reduced {arch}, float32 compute, "
          f"one sgd step each in standard and kernel mode, bar "
          f"{CPU_STEP_BAR} of each leaf's largest gradient): "
          + json.dumps(out))
    return out


SPREAD_SEEDS = 3          # perturbed CPU steps of ``cpu_spread``


def cpu_spread(step_on, p0, loss, grads) -> dict:
    """The CPU step's own spread: SPREAD_SEEDS steps from ``p0`` with each
    parameter multiplied by 1 + u, u uniform in [-2^-23, 2^-23) (a
    last-bit perturbation, what summation order leaves behind), against
    the unperturbed step's ``loss`` and ``grads``: the largest relative
    loss difference and, leaf by leaf, the largest relative distance in
    the norm."""
    from repro_torch.dist.sharding import tree_map
    loss_rel, leaf = 0.0, [0.0] * len(grads)
    for seed in range(SPREAD_SEEDS):
        gen = torch.Generator().manual_seed(1000 + seed)
        pp = tree_map(lambda t: t * (1 + (torch.rand(
            t.shape, generator=gen) * 2 - 1) * 2.0 ** -23), p0)
        m, g, _, _ = step_on("cpu", pp)
        loss_rel = max(loss_rel, abs(m["loss"] - loss) / abs(loss))
        leaf = [max(x, float(torch.linalg.norm(a - b) / torch.linalg.norm(
            b).clamp_min(1e-30))) for x, a, b in zip(leaf, g, grads)]
    return {"loss rel": loss_rel, "leaf nrel": leaf}


def lm_train_path(ops, xbk, fak) -> dict:
    """The LM training path (module docstring, step 18)."""
    return {"standard": lm_train_standard(ops, fak),
            "crossbar": lm_train_crossbar(ops, xbk),
            "card vs cpu": lm_train_card_vs_cpu(ops)}


# -- the hybrid family (recurrentgemma-9b at full width) ---------------------

HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_BATCH, HYBRID_LEN = 2, 4096       # past the 2048-key window
HYBRID_SERVE_MAX_LEN, HYBRID_SERVE_NEW = 64, 16
REDUCED_STEPS = 48                       # past the reduced 32-slot window
CARD_VS_CPU_BAR = 1e-4                   # of each output's largest |value|


def check_windowed_counts(ops, n: int, route: str, what: str) -> None:
    """``check_flash_counts``, and every one of the ``n`` launches with a
    window."""
    from repro_torch.kernels import flash_attention as fak
    check_flash_counts(ops, n, route, what)
    if fak.flash_attention_kernel.windowed != n:
        raise AssertionError(f"{what}: {fak.flash_attention_kernel.windowed}"
                             f" of {n} flash launches had a window")


def hybrid_prefill(ops, model, params) -> dict:
    """Step 19 (a): ``prefill_fn`` at full width on HYBRID_BATCH x
    HYBRID_LEN tokens from SEED, the flash counts at 0 before and read
    after: one launch per local layer (12), all wgmma/chunked with the
    window; logits finite, pad columns -1e30; peak memory, the time of
    one more call (CUDA events) and a profile."""
    cfg = model.cfg
    n_local = cfg.layer_kinds().count("local")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(ops)
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    check_windowed_counts(ops, n_local, "wgmma", f"{HYBRID_ARCH} prefill")
    want_shape = check_prefill_logits(logits, cfg, HYBRID_BATCH,
                                      HYBRID_LEN)
    peak = torch.cuda.max_memory_allocated()
    del logits
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=1, warmup=0)
    prof = profile_device(lambda: model.prefill_fn(params, batch), reps=1)
    out = {"flash_attention launches": launches, "windowed": launches,
           "route": "wgmma/chunked", "peak GB": peak / 1e9,
           "prefill ms": ms,
           "prefill tokens/s": HYBRID_BATCH * HYBRID_LEN / ms * 1e3,
           "profile": prof}
    print(f"hybrid prefill ({HYBRID_ARCH} full width, "
          f"{cfg.param_count():,} parameters, bf16 compute, {HYBRID_BATCH} "
          f"x {HYBRID_LEN} tokens): {launches} flash_attention launches "
          f"(one per local layer, all wgmma/chunked with window "
          f"{cfg.window}), logits {want_shape} finite; peak "
          f"{peak / 1e9:.2f} GB; {ms:.3f} ms, "
          f"{out['prefill tokens/s']:.0f} tokens/s; profile span "
          f"{prof['span_ms']:.3f} ms, busy {ms3(prof['device_busy_ms'])} "
          f"ms, idle share {ms3(prof['device_idle_share'])}")
    print("hybrid prefill profile (profiler on): " + json.dumps(prof))
    return out


def hybrid_serve(ops, model, params, BatchedServer) -> dict:
    """``BatchedServer(batch=4)`` (its captured decode step,
    ``serve_session``) serves ``launch/serve.py``'s 8-token prompts with
    ``max_new=16`` (23 steps, the local layers' rolling buffers of 64
    slots) in the model's compute dtype and a cache of it, its decode
    logits recorded; then ``prefill_fn`` on each slot's prompt
    + generated tokens (a check: its launches, one an attention layer,
    the local layers' windowed, are not the path's).  Returns the decode
    and prefill logits (vocab columns), the sequences, the generated
    tokens, the server, its time and launches.  Serves the hybrid, SSM
    and VLM families (a VLM's prompts are text, as the CLI's)."""
    from repro_torch.kernels import flash_attention as fak
    cfg = model.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]
    zero_flash_counts(ops)
    run = serve_session(model, params, BatchedServer, prompts,
                        HYBRID_SERVE_NEW, HYBRID_SERVE_MAX_LEN, dtype)
    server, outs = run["server"], run["outs"]
    launches = ops.flash_attention.launches
    steps, toks = server.stats.steps, server.stats.tokens_out
    if (steps, toks) != (8 + HYBRID_SERVE_NEW - 1,
                         SERVE_BATCH * HYBRID_SERVE_NEW):
        raise AssertionError(f"server: {steps} steps, {toks} tokens")
    seqs = torch.tensor([p + o for p, o in zip(prompts, outs)],
                        dtype=torch.int32, device="cuda")
    zero_flash_counts(ops)
    full = model.prefill_fn(params, {"tokens": seqs})[..., :cfg.vocab_size]
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    check_flash_counts(ops, sum(k not in ("rec", "ssd") for k in kinds),
                       route, f"the check's prefill ({cfg.compute_dtype})")
    windowed = fak.flash_attention_kernel.windowed
    if windowed != kinds.count("local"):
        raise AssertionError(f"the check's prefill: {windowed} windowed "
                             f"flash launches")
    return {**run, "dec": run["dec_all"][..., :cfg.vocab_size],
            "pre": full[:, :steps], "seqs": seqs, "steps": steps,
            "tokens": toks, "launches": launches}


def check_decode(run: dict, bar: float, what: str) -> dict:
    """Decode logits within ``bar`` of the prefill's at every step, and
    every generated token the prefill argmax except where its top-2 gap
    lies within ``bar`` (counted); raises otherwise."""
    dec, pre = run["dec"], run["pre"]
    err = float((dec - pre).abs().max())
    if not bool(torch.isfinite(dec).all()) or not err <= bar:
        raise AssertionError(f"{what}: decode vs prefill max |Δ| {err} > "
                             f"{bar}")
    top2 = torch.topk(pre[:, 7:], 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    off = torch.tensor(run["outs"], device="cuda") != pre[:, 7:].argmax(-1)
    if bool((off & (gap > bar)).any()):
        raise AssertionError(f"{what}: a generated token is not the prefill "
                             f"argmax away from a near-tie")
    return {"max |decode - prefill| logit": err, "bar": bar,
            "tokens excused as near-ties": int(off.sum()),
            "steps": run["steps"], "tokens_out": run["tokens"],
            "decode ms per step": run["ms"] / run["steps"],
            "decode tokens/s": run["tokens"] / run["ms"] * 1e3,
            "flash_attention launches in BatchedServer.generate":
                run["launches"]}


def hybrid_decode(ops, model, model32, params, BatchedServer) -> dict:
    """Step 19 (b): ``hybrid_serve`` in float32 compute (float32 cache),
    its decode within LOGIT_BAR float32 of its prefill: the whole path
    (rolling caches, the rec blocks' step against the scan) at full
    width; then in bf16 compute (bf16 cache), its decode within the bf16
    computation's own noise: max(LOGIT_BAR bf16, max |bf16 prefill -
    float32 prefill| on the same tokens).  At this width one bf16
    rounding carried by the recurrence can move the logits past
    qwen2-0.5b's 0.125 bar; the run prints both distances at the first
    position, where decode and prefill compute the same thing.  ms per
    step and a profiled bf16 step."""
    cfg = model.cfg
    out = {}
    run32 = hybrid_serve(ops, model32, params, BatchedServer)
    out["float32"] = check_decode(run32, LOGIT_BAR["float32"],
                                  f"{HYBRID_ARCH} float32")
    out["float32"]["captured decode"] = graph_session(
        run32, BatchedServer, f"{HYBRID_ARCH}, float32")
    del run32
    run = hybrid_serve(ops, model, params, BatchedServer)
    graph = graph_session(run, BatchedServer, f"{HYBRID_ARCH}, bfloat16")
    zero_flash_counts(ops)
    pre32 = model32.prefill_fn(params, {"tokens": run["seqs"]})[
        :, :run["steps"], :cfg.vocab_size]
    check_windowed_counts(ops, cfg.layer_kinds().count("local"), "simt",
                          "the float32 prefill of the bf16 sequences")
    noise = float((run["pre"] - pre32).abs().max())
    out["bfloat16"] = check_decode(run, max(LOGIT_BAR["bfloat16"], noise),
                                   f"{HYBRID_ARCH} bf16")
    out["bfloat16"]["captured decode"] = graph
    out["bfloat16"]["max |bf16 prefill - float32 prefill| logit"] = noise
    out["bfloat16"]["max |bf16 decode - float32 prefill| logit"] = float(
        (run["dec"] - pre32).abs().max())
    out["bfloat16"]["max |logit|"] = float(pre32.abs().max())
    out["bfloat16"]["first position: max |decode - prefill|"] = float(
        (run["dec"][:, 0] - run["pre"][:, 0]).abs().max())
    out["bfloat16"]["first position: max |bf16 - float32 prefill|"] = float(
        (run["pre"][:, 0] - pre32[:, 0]).abs().max())
    del pre32
    server, seqs, steps = run["server"], run["seqs"], run["steps"]
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out["bfloat16"]["decode step profile"] = prof
    for compute, r in out.items():
        print(f"hybrid decode vs prefill ({HYBRID_ARCH}, {compute} compute "
              f"and cache): {r['steps']} steps, {r['tokens_out']} tokens; "
              f"max |decode - prefill| logit "
              f"{r['max |decode - prefill| logit']:.3e} (bar "
              f"{r['bar']:.3e}); {r['tokens excused as near-ties']} "
              f"generated tokens differ from the prefill argmax, all at "
              f"near-ties; {r['decode ms per step']:.3f} ms per step, "
              f"{r['decode tokens/s']:.1f} tokens/s")
    first = {k: v for k, v in out["bfloat16"].items()
             if k.startswith("first position")}
    print(f"  bf16: max |bf16 prefill - float32 prefill| "
          f"{noise:.3e}, max |logit| {out['bfloat16']['max |logit|']:.3f}; "
          f"{json.dumps(first)}; "
          f"one step under the profiler: {prof['span_ms']:.3f} ms span, "
          f"device busy {ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    return out


def hybrid_reduced(ops) -> dict:
    """Step 19 (c): the reduced config (2 local layers, window 32, hd 16)
    on the card: ``prefill_fn`` on 2 x REDUCED_STEPS tokens (the windowed
    kernel at Sq > window: 2 launches, wgmma for bf16, simt for float32)
    and REDUCED_STEPS decode steps over the 32-slot rolling cache, held
    against that prefill (LOGIT_BAR); in float32 compute (a float32 cache)
    also the same run on the CPU from the same parameters, each output
    within CARD_VS_CPU_BAR of its largest |value|."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.dist.sharding import tree_map
    from repro_torch.models import build_model
    out = {}
    for compute in ("bfloat16", "float32"):
        cfg = get_reduced_config(HYBRID_ARCH, compute_dtype=compute)
        dtype = getattr(torch, compute)
        route = "wgmma" if compute == "bfloat16" else "simt"
        p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
        tokens = torch.randint(0, cfg.vocab_size, (2, REDUCED_STEPS),
                               generator=torch.Generator().manual_seed(SEED),
                               dtype=torch.int32)
        runs = {}
        for dev in ("cuda", "cpu") if compute == "float32" else ("cuda",):
            model = build_model(cfg, dev)
            params = tree_map(lambda t: t.to(dev, copy=True), p0)
            tok = tokens.to(dev)
            zero_flash_counts(ops)
            pre = model.prefill_fn(params, {"tokens": tok})
            launches = ops.flash_attention.launches
            if dev == "cuda":
                check_windowed_counts(ops, cfg.layer_kinds().count("local"),
                                      route, f"reduced {compute} prefill")
            cache = model.init_cache(2, 64, dtype)
            if cache["stack"]["b2_local"]["k"].shape[2] != cfg.window:
                raise AssertionError("the local cache is not window-sized")
            dec = []
            for step in range(REDUCED_STEPS):
                logits, cache = model.decode_fn(
                    params, cache, {"tokens": tok[:, step:step + 1],
                                    "length": step})
                dec.append(logits)
            dec = torch.cat(dec, dim=1)
            err = float((dec - pre).abs()[..., :cfg.vocab_size].max())
            if not err <= LOGIT_BAR[compute]:
                raise AssertionError(f"reduced {compute} on {dev}: decode "
                                     f"vs prefill {err}")
            runs[dev] = (pre.cpu(), dec.cpu(), err, launches)
        res = {"decode vs prefill, card": runs["cuda"][2],
               "flash launches (prefill, card)": runs["cuda"][3],
               "bar": LOGIT_BAR[compute]}
        if "cpu" in runs:
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(runs["cuda"][:2], runs["cpu"][:2]))
            if not rel <= CARD_VS_CPU_BAR:
                raise AssertionError(f"reduced float32: card vs CPU {rel}")
            res["card vs cpu, of each output's largest"] = rel
        out[compute] = res
    print(f"hybrid reduced ({HYBRID_ARCH} reduced, window 32, hd 16): "
          f"{REDUCED_STEPS} decode steps past the 32-slot rolling cache "
          f"against a {REDUCED_STEPS}-token prefill (2 windowed launches "
          f"each: wgmma in bf16, simt in float32): " + json.dumps(out))
    return out


def hybrid_path(ops) -> dict:
    """The hybrid family (module docstring, step 19)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    model = build_model(get_config(HYBRID_ARCH), "cuda")
    model32 = build_model(get_config(HYBRID_ARCH, compute_dtype="float32"),
                          "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"init s": time.perf_counter() - t0,
           "parameters": model.cfg.param_count()}
    out["prefill"] = hybrid_prefill(ops, model, params)
    out["decode"] = hybrid_decode(ops, model, model32, params,
                                  BatchedServer)
    del params
    torch.cuda.empty_cache()
    out["reduced"] = hybrid_reduced(ops)
    return out


# -- the MoE family (moonshot-v1-16b-a3b, qwen3-moe-30b-a3b, depth cut) ------

# full width, the depth cut to fit 80 GB with fp32 parameters at rest:
# moonshot keeps its dense first layer and 17 moe layers, qwen3-moe 16
MOE_ARCHS = {"moonshot-v1-16b-a3b": 18, "qwen3-moe-30b-a3b": 16}
MOE_SERVE_NEW = {"moonshot-v1-16b-a3b": 16, "qwen3-moe-30b-a3b": 8}
MOE_SERVE_MAX_LEN = 64
MOE_NEAR_TIE = 1e-6      # fp32: routing may differ only below this margin
# bf16 decode against bf16 prefill, relative Frobenius distance of the
# logits: d, the reference's own bf16-vs-float32 distance on its reduced
# config, the largest over 8 batches of 4 x 16 tokens from numpy seeds
# 0-7 at the no-drop capacity (each batch's is one count of routing flips:
# 0.013-0.052 for moonshot, 0.010-0.086 for qwen3-moe), measured on the
# CPU; tests/test_torch_moe.py computes it again and holds these figures
# to it.  Decode and prefill are two bf16 computations of one function:
# each as near the float32 result as the reference's bf16 lies within d
# of it, so the two lie within 2 d of each other
MOE_BF16_DIST = {"moonshot-v1-16b-a3b": 0.05215,
                 "qwen3-moe-30b-a3b": 0.08575}


def moe_no_drop(cfg):
    """``cfg`` at capacity_factor = E / k: C = the group, nothing drops, so
    a prefill computes what decode steps compute."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def moe_product_ms(cfg, tokens: int) -> dict:
    """Device time (CUDA events) of one moe layer's products at a prefill
    of ``tokens`` tokens in groups of ``moe_group_size``, bf16, on random
    operands of the path's shapes: the one-hot dispatch and combine, and
    the experts' three products; with their FLOPs."""
    from repro_torch.layers.moe import _capacity
    m = cfg.moe()
    s = min(m.group_size, tokens)
    G, E, C, d, f = tokens // s, m.n_experts, _capacity(m, s), m.d_model, \
        m.d_expert
    bf = torch.bfloat16
    oh = torch.rand(G, s, E, C, device="cuda").lt(1 / E).to(bf)
    xt = torch.randn(G, s, d, device="cuda", dtype=bf)
    xe = torch.randn(G, E, C, d, device="cuda", dtype=bf)
    h = torch.randn(G, E, C, f, device="cuda", dtype=bf)
    wi = torch.randn(E, d, f, device="cuda", dtype=bf)
    wo = torch.randn(E, f, d, device="cuda", dtype=bf)
    out = {
        "dispatch ms": cuda_ms(lambda: torch.einsum("gsec,gsd->gecd", oh,
                                                    xt), iters=5),
        "combine ms": cuda_ms(lambda: torch.einsum("gsec,gecd->gsd", oh,
                                                   xe), iters=5),
        "experts ms (wg, wi, wo)": 2 * cuda_ms(
            lambda: torch.einsum("gecd,edf->gecf", xe, wi), iters=5)
        + cuda_ms(lambda: torch.einsum("gecf,efd->gecd", h, wo), iters=5),
        "one-hot products TFLOP": 2 * 2 * G * s * E * C * d / 1e12,
        "expert products TFLOP": 3 * 2 * G * E * C * d * f / 1e12,
        "groups x group x experts x capacity": [G, s, E, C]}
    return out


def moe_prefill(ops, model, params) -> dict:
    """Step 20 (a): ``prefill_fn`` at full width (depth cut) on
    PREFILL_BATCH x PREFILL_LEN tokens from SEED in bf16, at the
    configured capacity (groups of 1024), the flash counts at 0 before and
    read after: one launch per layer, all wgmma/chunked; logits finite,
    pad columns -1e30; each moe layer's share of choices dropped, read
    once after the call; the peak memory, the time of one more call (CUDA
    events), tokens/s, a profile with the idle share, and one moe layer's
    one-hot and expert products by device time."""
    from repro_torch.layers import moe
    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device=model.device,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(ops)
    moe.ROUTING = []
    try:
        logits = model.prefill_fn(params, batch)
        routing = moe.ROUTING
    finally:
        moe.ROUTING = None
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    check_flash_counts(ops, cfg.n_layers, "wgmma", f"{cfg.name} prefill")
    n_moe = cfg.layer_kinds().count("moe")
    if len(routing) != n_moe:
        raise AssertionError(f"{len(routing)} moe calls, expected {n_moe}")
    want_shape = check_prefill_logits(logits, cfg, PREFILL_BATCH,
                                      PREFILL_LEN)
    dropped = [round(v, 5) for v in torch.stack(
        [1 - r.kept.float().mean() for r in routing]).tolist()]
    peak = torch.cuda.max_memory_allocated()
    del logits, routing
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=1, warmup=0)
    prof = profile_device(lambda: model.prefill_fn(params, batch), reps=1)
    products = moe_product_ms(cfg, PREFILL_BATCH * PREFILL_LEN)
    one_hot = products["dispatch ms"] + products["combine ms"]
    out = {"layers": cfg.n_layers, "parameters": cfg.param_count(),
           "flash_attention launches": launches, "route": "wgmma/chunked",
           "share of choices dropped by moe layer": dropped,
           "mean share dropped": sum(dropped) / len(dropped),
           "peak GB": peak / 1e9, "prefill ms": ms,
           "prefill tokens/s": PREFILL_BATCH * PREFILL_LEN / ms * 1e3,
           "one moe layer's products": products,
           "one-hot products, all moe layers, ms": n_moe * one_hot,
           "one-hot products, share of the prefill": n_moe * one_hot / ms,
           "profile": prof}
    print(f"moe prefill ({cfg.name}, full width cut to {cfg.n_layers} "
          f"layers, {out['parameters']:,} parameters, bf16 compute, "
          f"{PREFILL_BATCH} x {PREFILL_LEN} tokens, groups of "
          f"{cfg.moe_group_size}): {launches} flash_attention launches (one "
          f"per layer, all wgmma/chunked), logits {want_shape} finite; "
          f"choices dropped by layer {dropped}; peak {peak / 1e9:.2f} GB; "
          f"{ms:.3f} ms, {out['prefill tokens/s']:.0f} tokens/s; one-hot "
          f"dispatch + combine {one_hot:.3f} ms a layer against the "
          f"experts' {products['experts ms (wg, wi, wo)']:.3f} ms "
          f"({out['one-hot products, share of the prefill']:.3f} of the "
          f"prefill); profile span {prof['span_ms']:.3f} ms, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    print(f"moe prefill profile ({cfg.name}, profiler on): "
          + json.dumps(prof))
    return out


def moe_serve(ops, model, params, BatchedServer, new: int) -> dict:
    """``BatchedServer(batch=4)`` (its captured decode step,
    ``serve_session``) serves ``launch/serve.py``'s 8-token prompts with
    ``max_new=new`` in the model's compute dtype and a cache of it, its
    decode logits and routing recorded step by step (a replay appends
    clones of the records its capture made); then
    ``prefill_fn`` on each slot's prompt + generated tokens (a check: its
    launches are not the path's), its routing recorded."""
    from repro_torch.layers import moe
    cfg = model.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]
    zero_flash_counts(ops)
    run = serve_session(model, params, BatchedServer, prompts, new,
                        MOE_SERVE_MAX_LEN, dtype, routing=True)
    server, outs = run["server"], run["outs"]
    launches = ops.flash_attention.launches
    steps, toks = server.stats.steps, server.stats.tokens_out
    if (steps, toks) != (8 + new - 1, SERVE_BATCH * new):
        raise AssertionError(f"server: {steps} steps, {toks} tokens")
    seqs = torch.tensor([p + o for p, o in zip(prompts, outs)],
                        dtype=torch.int32, device=model.device)
    zero_flash_counts(ops)
    moe.ROUTING = []
    try:
        full = model.prefill_fn(params, {"tokens": seqs})[
            ..., :cfg.vocab_size]
        pre_routes = moe.ROUTING
    finally:
        moe.ROUTING = None
    torch.cuda.synchronize()
    check_flash_counts(ops, cfg.n_layers, route,
                       f"the check's prefill ({cfg.compute_dtype})")
    return {**run, "dec": run["dec_all"][..., :cfg.vocab_size],
            "pre": full[:, :steps], "pre_routes": pre_routes,
            "seqs": seqs, "steps": steps, "tokens": toks,
            "launches": launches}


def moe_flips(run: dict, near: float | None) -> tuple[torch.Tensor, dict]:
    """Decode routing against the check's prefill routing, step by step
    and layer by layer: a flip (other experts) at a (slot, step) reaches
    the slot's later steps.  With ``near``, a flip that no earlier flip
    reached must lie at a near-tie of the prefill's routing (margin below
    ``near``).  Returns the reached (slot, step) mask on the host and the
    counts."""
    steps, B = run["steps"], SERVE_BATCH
    dec = torch.stack([torch.stack([r.top_i.reshape(B, -1) for r in step])
                       for step in run["dec_routes"]])     # (steps, l, B, k)
    pre = torch.stack([r.top_i.reshape(B, -1, r.top_i.shape[-1])[:, :steps]
                       for r in run["pre_routes"]])        # (l, B, steps, k)
    margin = torch.stack([r.margin.reshape(B, -1)[:, :steps]
                          for r in run["pre_routes"]])     # (l, B, steps)
    flip = (dec.permute(1, 2, 0, 3) != pre).any(-1).cpu()  # (l, B, steps)
    margin = margin.cpu()
    reached = torch.zeros(B, steps, dtype=torch.bool)
    roots, root_margins = 0, []
    for t in range(steps):
        for layer in range(flip.shape[0]):
            root = flip[layer, :, t] & ~reached[:, t]
            if bool(root.any()):
                m = margin[layer, :, t][root]
                if near is not None and bool((m >= near).any()):
                    raise AssertionError(f"decode routing differs from the "
                                         f"prefill's at margins {m.tolist()}"
                                         f" (near-tie bar {near})")
                roots += int(root.sum())
                root_margins += m.tolist()
            for b in torch.nonzero(flip[layer, :, t]).flatten().tolist():
                reached[b, t:] = True
    return reached, {"routing flips at a fresh position": roots,
                     "their prefill margins": root_margins,
                     "(slot, step) positions reached": int(reached.sum())}


def moe_check_decode(run: dict, compute: str, arch: str) -> dict:
    """float32: decode logits within LOGIT_BAR of the prefill's at every
    (slot, step) no routing flip reached, flips only at near-ties
    (MOE_NEAR_TIE); bf16: the logits' relative Frobenius distance within
    2 x MOE_BF16_DIST[arch], the flips counted.  Either way every generated
    token is the prefill argmax but at a top-2 gap within LOGIT_BAR or
    where a flip reached its slot (counted)."""
    dec, pre = run["dec"], run["pre"]
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{arch} {compute}: decode logits not finite")
    reached, flips = moe_flips(run, MOE_NEAR_TIE if compute == "float32"
                               else None)
    ok = ~reached.to(dec.device)
    err = float((dec - pre).abs()[ok].max()) if bool(ok.any()) else 0.0
    rel = float(torch.linalg.norm(dec - pre) / torch.linalg.norm(pre))
    bar = LOGIT_BAR[compute]
    if compute == "float32" and not err <= bar:
        raise AssertionError(f"{arch} float32: decode vs prefill max |Δ| "
                             f"{err} > {bar} where no routing flip reached")
    if compute == "bfloat16" and not rel <= 2 * MOE_BF16_DIST[arch]:
        raise AssertionError(f"{arch} bf16: decode vs prefill relative "
                             f"distance {rel} > 2 x {MOE_BF16_DIST[arch]}")
    top2 = torch.topk(pre[:, 7:], 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    off = torch.tensor(run["outs"], device=pre.device) != \
        pre[:, 7:].argmax(-1)
    if bool((off & (gap > bar) & ok[:, 7:]).any()):
        raise AssertionError(f"{arch} {compute}: a generated token is not "
                             f"the prefill argmax away from a near-tie or "
                             f"a routing flip")
    return {"max |decode - prefill| logit where no flip reached": err,
            "relative distance ||decode - prefill|| / ||prefill||": rel,
            "bar": bar if compute == "float32" else 2 * MOE_BF16_DIST[arch],
            **flips,
            "tokens excused (near-tie or flip)": int(off.sum()),
            "steps": run["steps"], "tokens_out": run["tokens"],
            "decode ms per step": run["ms"] / run["steps"],
            "decode tokens/s": run["tokens"] / run["ms"] * 1e3,
            "flash_attention launches in BatchedServer.generate":
                run["launches"]}


def moe_decode(ops, arch, model, model32, params, BatchedServer) -> dict:
    """Step 20 (b): ``moe_serve`` at the no-drop capacity in float32
    compute (float32 cache), then in bf16 (bf16 cache), each held by
    ``moe_check_decode``; ms per step and one profiled bf16 step."""
    out = {}
    for compute, m in (("float32", model32), ("bfloat16", model)):
        run = moe_serve(ops, m, params, BatchedServer, MOE_SERVE_NEW[arch])
        out[compute] = moe_check_decode(run, compute, arch)
        out[compute]["captured decode"] = graph_session(
            run, BatchedServer, f"{arch} at {m.cfg.n_layers} layers, "
            f"{compute}")
        if compute == "bfloat16":
            server, seqs, steps = run["server"], run["seqs"], run["steps"]
            step_batch = {"tokens": seqs[:, -1:], "length": steps}
            out[compute]["decode step profile"] = profile_device(
                lambda: m.decode_fn(params, server.cache, step_batch))
        del run
    for compute, r in out.items():
        err = r["max |decode - prefill| logit where no flip reached"]
        rel = r["relative distance ||decode - prefill|| / ||prefill||"]
        print(f"moe decode vs prefill ({arch}, {compute} compute and cache, "
              f"no-drop capacity): {r['steps']} steps, {r['tokens_out']} "
              f"tokens; max |decode - prefill| where no flip reached "
              f"{err:.3e}, relative distance {rel:.3e} (bar {r['bar']}); "
              f"{r['routing flips at a fresh position']} routing flips; "
              f"{r['tokens excused (near-tie or flip)']} generated tokens "
              f"differ from the prefill argmax; "
              f"{r['decode ms per step']:.3f} ms per step, "
              f"{r['decode tokens/s']:.1f} tokens/s")
    prof = out["bfloat16"]["decode step profile"]
    print(f"  one bf16 step under the profiler: {prof['span_ms']:.3f} ms "
          f"span, device busy {ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    return out


def moe_reduced_serving(ops, arch) -> dict:
    """Step 20 (d), serving: the reduced config in float32 compute at its
    configured capacity, ``prefill_fn`` on 2 x 64 tokens (two groups of
    64, where choices drop) and 8 decode steps (a float32 cache), on the
    card and on the CPU from the same parameters: routing equal (experts
    and keep masks) but at near-ties (MOE_NEAR_TIE, counted; their groups
    then left out), each output within CARD_VS_CPU_BAR of its largest
    |value|; the card's prefill runs the fp32 flash kernel, one launch a
    layer."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.dist.sharding import tree_map
    from repro_torch.layers import moe
    from repro_torch.models import build_model
    cfg = get_reduced_config(arch, compute_dtype="float32")
    p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(SEED),
                           dtype=torch.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        tok = tokens.to(dev)
        zero_flash_counts(ops)
        moe.ROUTING = []
        try:
            pre = model.prefill_fn(params, {"tokens": tok})
            pre_routes = [(r.top_i.cpu(), r.kept.cpu(), r.margin.cpu())
                          for r in moe.ROUTING]
            if dev == "cuda":
                check_flash_counts(ops, cfg.n_layers, "simt",
                                   f"reduced {arch} float32 prefill")
            cache = model.init_cache(2, 16, torch.float32)
            dec = []
            for step in range(8):
                logits, cache = model.decode_fn(
                    params, cache, {"tokens": tok[:, step:step + 1],
                                    "length": step})
                dec.append(logits)
        finally:
            moe.ROUTING = None
        runs[dev] = (pre.cpu(), torch.cat(dec, dim=1).cpu(), pre_routes)
    (pc, dc, rc), (pp, dp, rp) = runs["cuda"], runs["cpu"]
    ties, groups_out = 0, torch.zeros(2, dtype=torch.bool)
    for (ti, ki, mi), (tj, kj, _) in zip(rc, rp):
        flip = (ti != tj).any(-1) | (ki != kj).any(1)       # (G, s)
        if bool((mi[flip] >= MOE_NEAR_TIE).any()):
            raise AssertionError(f"reduced {arch}: card and CPU route "
                                 f"otherwise away from a near-tie")
        ties += int(flip.sum())
        groups_out |= flip.any(-1)
    keep = ~groups_out                     # a group of 64 is one row here
    rel = max(float((a[keep] - b[keep]).abs().max() / b[keep].abs().max())
              if bool(keep.any()) else 0.0 for a, b in ((pc, pp), (dc, dp)))
    if not rel <= CARD_VS_CPU_BAR:
        raise AssertionError(f"reduced {arch} float32: card vs CPU {rel}")
    dropped = sum(int((~k).sum()) for _, k, _ in rc)
    out = {"card vs cpu, of each output's largest": rel,
           "routing near-ties": ties, "choices dropped (prefill)": dropped,
           "flash launches (prefill, card)": cfg.n_layers}
    print(f"moe reduced serving ({arch} reduced, float32, 2 x 64 prefill at "
          f"C = {moe._capacity(cfg.moe(), 64)} and 8 decode steps, card vs "
          f"CPU): " + json.dumps(out))
    return out


def moe_path(ops) -> dict:
    """The MoE family (module docstring, step 20)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    out = {}
    for arch, layers in MOE_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch, n_layers=layers)
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        res = {"init s": time.perf_counter() - t0}
        res["prefill"] = moe_prefill(ops, model, params)
        res["decode"] = moe_decode(
            ops, arch, build_model(moe_no_drop(cfg), "cuda"),
            build_model(moe_no_drop(cfg.replace(compute_dtype="float32")),
                        "cuda"), params, BatchedServer)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        res["reduced serving"] = moe_reduced_serving(ops, arch)
        res["reduced training"] = lm_train_card_vs_cpu(ops, arch)
        res["s"] = time.perf_counter() - t0
        out[arch] = res
    return out


# -- the SSM family (mamba2-130m at full width and full depth) ---------------

SSM_ARCH = "mamba2-130m"
SSM_LONG = 32768                # the reference's prefill_32k length
SSM_TRAIN_STEPS, SSM_XB_STEPS = 3, 2
SSM_PROJECTIONS = 2             # in_proj and out_proj, per layer
# bf16 decode against bf16 prefill, relative Frobenius distance of the
# logits: d, the reference's own bf16-vs-float32 distance on its reduced
# config, the largest over 8 batches of 4 x 24 tokens from numpy seeds 0-7
# (0.0107-0.0116), measured on the CPU; tests/test_torch_ssd.py computes
# it again and holds this figure to it.  Decode and prefill are two bf16
# computations of one function, each as near the float32 result as the
# reference's bf16 lies within d of it, so the two lie within 2 d
SSM_BF16_DIST = 0.01157
# the cuBLAS products' kernels, by name, in a profile
GEMM_KERNELS = r"gemm|gemv|nvjet|xmma|cutlass"


def check_no_launches(ops, what: str) -> None:
    """Raise unless no flash or crossbar kernel launched since the counts
    were set to 0 (an attention-free model in standard mode)."""
    check_flash_counts(ops, 0, "wgmma", what)
    got = {n: getattr(ops, n).launches for n in XB_NAMES}
    if any(got.values()):
        raise AssertionError(f"{what} launched {got}")


def ssm_prefill_call(ops, model, params, B: int, L: int) -> dict:
    """One ``prefill_fn`` on B x L tokens from SEED, the counts at 0 before
    and read after (none: mamba2 is attention-free); logits finite, pad
    columns -1e30; its peak memory and the time of one more call (CUDA
    events)."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, L),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts(ops)
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    check_no_launches(ops, f"{SSM_ARCH} prefill {B} x {L}")
    check_prefill_logits(logits, cfg, B, L)
    peak = torch.cuda.max_memory_allocated()
    del logits
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=1, warmup=0)
    return {"batch": batch, "peak GB": peak / 1e9, "ms": ms,
            "tokens/s": B * L / ms * 1e3}


def ssm_prefill(ops, model, params) -> dict:
    """Step 21 (a): ``prefill_fn`` on PREFILL_BATCH x PREFILL_LEN tokens in
    bf16 (8 chunks of 256 a layer) with a profile (the cuBLAS products
    beside the rest: the scan's elementwise passes), then one prefill of
    1 x SSM_LONG tokens (128 chunks a layer)."""
    run = ssm_prefill_call(ops, model, params, PREFILL_BATCH, PREFILL_LEN)
    batch = run.pop("batch")
    prof = profile_device(lambda: model.prefill_fn(params, batch), reps=1,
                          match=GEMM_KERNELS)
    del batch
    long = ssm_prefill_call(ops, model, params, 1, SSM_LONG)
    del long["batch"]
    gemm = prof["matched_ms"]
    out = {"flash and crossbar launches": 0, "peak GB": run["peak GB"],
           "prefill ms": run["ms"], "prefill tokens/s": run["tokens/s"],
           "cuBLAS products ms (profiler)": gemm,
           "the rest ms (profiler)": (None if gemm is None
                                      else prof["device_busy_ms"] - gemm),
           "profile": prof,
           f"1 x {SSM_LONG}": long}
    print(f"ssm prefill ({SSM_ARCH} full width and depth, "
          f"{model.cfg.param_count():,} parameters, bf16 compute, "
          f"{PREFILL_BATCH} x {PREFILL_LEN} tokens, chunk "
          f"{model.cfg.ssm_chunk}): no flash or crossbar launch, logits "
          f"finite, pad columns -1e30; peak {run['peak GB']:.2f} GB; "
          f"{run['ms']:.3f} ms, {run['tokens/s']:.0f} tokens/s; profile "
          f"span {prof['span_ms']:.3f} ms, busy "
          f"{ms3(prof['device_busy_ms'])} ms (cuBLAS products {ms3(gemm)} "
          f"ms), idle share {ms3(prof['device_idle_share'])}; 1 x "
          f"{SSM_LONG}: {long['ms']:.3f} ms, {long['tokens/s']:.0f} "
          f"tokens/s, peak {long['peak GB']:.2f} GB")
    print("ssm prefill profile (profiler on): " + json.dumps(prof))
    return out


def ssm_decode(ops, model, model32, params, BatchedServer) -> dict:
    """Step 21 (b): ``hybrid_serve`` (the CLI's prompts, ``max_new=16``,
    23 steps) in float32 compute, its decode within LOGIT_BAR float32 of
    its prefill; then in bf16, the logits' relative Frobenius distance
    within 2 x SSM_BF16_DIST, and every generated token the prefill
    argmax but where its top-2 gap is within twice the position's largest
    |decode - prefill| (a near-tie, counted); no crossbar launch; ms per
    step and a profiled bf16 step."""
    out = {}
    for n in XB_NAMES:
        getattr(ops, n).launches = 0
    run32 = hybrid_serve(ops, model32, params, BatchedServer)
    out["float32"] = check_decode(run32, LOGIT_BAR["float32"],
                                  f"{SSM_ARCH} float32")
    out["float32"]["captured decode"] = graph_session(
        run32, BatchedServer, f"{SSM_ARCH}, float32")
    del run32
    run = hybrid_serve(ops, model, params, BatchedServer)
    out["bfloat16"] = check_decode_in_norm(run, SSM_BF16_DIST,
                                           f"{SSM_ARCH} bf16")
    out["bfloat16"]["captured decode"] = graph_session(
        run, BatchedServer, f"{SSM_ARCH}, bfloat16")
    check_no_launches(ops, f"{SSM_ARCH} serving")
    server, seqs, steps = run["server"], run["seqs"], run["steps"]
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out["bfloat16"]["decode step profile"] = prof
    r32, r = out["float32"], out["bfloat16"]
    rel = r["relative distance ||decode - prefill|| / ||prefill||"]
    print(f"ssm decode vs prefill ({SSM_ARCH}): float32 {r32['steps']} "
          f"steps, max |decode - prefill| "
          f"{r32['max |decode - prefill| logit']:.3e} (bar {r32['bar']}), "
          f"{r32['tokens excused as near-ties']} tokens at near-ties, "
          f"{r32['decode ms per step']:.3f} ms per step; bf16 relative "
          f"distance {rel:.3e} (bar {2 * SSM_BF16_DIST}), max |Δ| "
          f"{r['max |decode - prefill| logit']:.3e} of max |logit| "
          f"{r['max |logit|']:.3f}, {r['tokens excused as near-ties']} "
          f"tokens at near-ties, {r['decode ms per step']:.3f} ms per step, "
          f"{r['decode tokens/s']:.1f} tokens/s; one bf16 step under the "
          f"profiler: {prof['span_ms']:.3f} ms span, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    return out


def ssm_train(ops, xbk) -> dict:
    """Step 21 (c): the full config trains, bf16 compute, remat "full":
    SSM_TRAIN_STEPS adamw steps (no kernel launch), then crossbar kernel
    mode with pulse_sgd, SSM_XB_STEPS steps (a step: 2 projections x 24
    layers x 2 (remat) ``crossbar_fwd``, 48 ``crossbar_bwd`` and 48
    ``crossbar_dw``), layer 0's launches of its first step held against
    their plain versions within XB_BAR of sum_k |x_k||w_k| and re-timed
    on their operands (kernel, plain, ``torch.bmm``, the bound);
    conductances in [0, 4]."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.runtime.checkpoint import _walk
    cfg = get_config(SSM_ARCH)
    stream = TokenStream(cfg.vocab_size, PREFILL_LEN, PREFILL_BATCH,
                         seed=SEED)

    def batches(steps):
        return [{k: v.cuda() for k, v in stream.batch_at(s).items()}
                for s in range(steps)]
    std = train_run(ops, cfg, "adamw", batches(SSM_TRAIN_STEPS), 0)
    del std["params"], std["rec"]
    if any(std["launches"].values()):
        raise AssertionError(f"standard training launched "
                             f"{std['launches']}")
    xcfg = get_config(SSM_ARCH, crossbar=True, xbar_use_kernel=True)
    xb = train_run(ops, xcfg, "pulse_sgd", batches(SSM_XB_STEPS), 0,
                   SSM_PROJECTIONS, xbk)
    per_pass = SSM_PROJECTIONS * xcfg.n_layers
    want = {"crossbar_fwd": 2 * per_pass * SSM_XB_STEPS,
            "crossbar_bwd": per_pass * SSM_XB_STEPS,
            "crossbar_dw": per_pass * SSM_XB_STEPS}
    if xb["launches"] != want:
        raise AssertionError(f"crossbar kernel mode ran {xb['launches']}, "
                             f"expected {want}")
    g = [t for path, t in _walk(xb.pop("params"))
         if any(k in ("g_plus", "g_minus") for k in path)]
    lo, hi = min(float(t.min()) for t in g), max(float(t.max()) for t in g)
    if lo < 0.0 or hi > xcfg.xbar_w_max:
        raise AssertionError(f"conductances in [{lo}, {hi}], outside "
                             f"[0, {xcfg.xbar_w_max}]")
    rec = xb.pop("rec")
    xb["layer-0 launches vs plain, max |err| / sum |x||w|"] = \
        check_layer0_launches(xbk, rec)
    xb["rows"] = lm_crossbar_rows(xbk, rec, SSM_ARCH)
    del rec
    prof = xb["profile"]
    xb["conductance range"] = [lo, hi]
    xb["crossbar kernels' share of device time"] = (
        None if prof["device_busy_ms"] is None
        else prof["matched_ms"] / prof["device_busy_ms"])
    for what, r in (("standard, adamw", std),
                    ("crossbar kernel mode, pulse_sgd", xb)):
        print(f"ssm training ({SSM_ARCH} full width and depth, bf16 "
              f"compute, remat full, {PREFILL_BATCH} x {PREFILL_LEN} "
              f"tokens, {what}): launches {json.dumps(r['launches'])}, "
              f"{r['flash']} flash; losses "
              f"{[round(v, 4) for v in r['losses']]}; step "
              f"{r['step ms']:.3f} ms, {r['tokens/s']:.0f} tokens/s, peak "
              f"{r['peak GB']:.2f} GB; profile busy "
              f"{ms3(r['profile']['device_busy_ms'])} ms of "
              f"{r['profile']['span_ms']:.3f}, idle share "
              f"{ms3(r['profile']['device_idle_share'])} [{card_line()}]")
    print(f"  layer 0's launches vs plain (max |err| / sum |x||w|, bar "
          f"{XB_BAR}): " + json.dumps(
              xb["layer-0 launches vs plain, max |err| / sum |x||w|"])
          + f"; conductances in [{lo}, {hi}]; crossbar kernels "
          f"{ms3(prof['matched_ms'])} ms of the busy time")
    print_crossbar_rows(xb["rows"])
    print("ssm training profiles (profiler on): " + json.dumps(
        {"standard": std["profile"], "crossbar": prof}))
    return {"standard": std, "crossbar": xb}


def ssm_reduced(ops) -> dict:
    """Step 21 (d), serving: the reduced config in float32 compute,
    ``prefill_fn`` on 2 x 64 tokens (2 chunks of 32) and 8 decode steps,
    on the card and on the CPU from the same parameters, each output
    within CARD_VS_CPU_BAR of its largest |value|; no kernel launch."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.dist.sharding import tree_map
    from repro_torch.models import build_model
    cfg = get_reduced_config(SSM_ARCH, compute_dtype="float32")
    p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(SEED),
                           dtype=torch.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        tok = tokens.to(dev)
        zero_lm_counts(ops)
        pre = model.prefill_fn(params, {"tokens": tok})
        cache, dec = model.init_cache(2, 16), []
        for step in range(8):
            logits, cache = model.decode_fn(
                params, cache, {"tokens": tok[:, step:step + 1],
                                "length": step})
            dec.append(logits)
        if dev == "cuda":
            check_no_launches(ops, f"reduced {SSM_ARCH} serving")
        runs[dev] = (pre.cpu(), torch.cat(dec, dim=1).cpu(),
                     cache["stack"]["b0_ssd"]["state"].cpu())
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(runs["cuda"], runs["cpu"]))
    if not rel <= CARD_VS_CPU_BAR:
        raise AssertionError(f"reduced {SSM_ARCH} float32: card vs CPU "
                             f"{rel}")
    out = {"card vs cpu, of each output's largest (prefill, decode, "
           "state)": rel}
    print(f"ssm reduced serving ({SSM_ARCH} reduced, float32, 2 x 64 "
          f"prefill and 8 decode steps, card vs CPU): " + json.dumps(out))
    return out


def ssm_path(ops, xbk) -> dict:
    """The SSM family (module docstring, step 21)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    t0 = time.perf_counter()
    model = build_model(get_config(SSM_ARCH), "cuda")
    model32 = build_model(get_config(SSM_ARCH, compute_dtype="float32"),
                          "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"init s": time.perf_counter() - t0,
           "parameters": model.cfg.param_count()}
    out["prefill"] = ssm_prefill(ops, model, params)
    out["decode"] = ssm_decode(ops, model, model32, params, BatchedServer)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = ssm_train(ops, xbk)
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced serving"] = ssm_reduced(ops)
    out["reduced training"] = lm_train_card_vs_cpu(ops, SSM_ARCH)
    out["s"] = time.perf_counter() - t0
    return out


# -- the encoder-decoder family (seamless-m4t-medium at full width) ---------

ENCDEC_ARCH = "seamless-m4t-medium"
# bf16 decode against bf16 prefill, relative Frobenius distance of the
# logits: d, the reference's own bf16-vs-float32 distance of its prefill
# logits on its reduced config, the largest over 8 batches of 4 x 24
# tokens on 32 source frames from numpy seeds 0-7 (0.0080-0.0092),
# measured on the CPU; tests/test_torch_encdec.py computes it again and
# holds this figure to it
ENCDEC_BF16_DIST = 0.009219
ENCDEC_TRAIN_STEPS, ENCDEC_XB_STEPS = 3, 2
# crossbar projections a layer: the encoder's wq, wk, wv, wo, wi, wo; the
# decoder's self and cross q, k, v, o, wi, wo (src_proj and the head stay
# plain)
ENCDEC_PROJECTIONS = {"encoder": 6, "decoder": 10}
ENCDEC_SERVE_MAX_LEN, ENCDEC_SERVE_NEW = 64, 16
FLASH_KERNELS = r"flash_tc_fwd|flash_fwd"


class FlashRecorder:
    """Records (causal, Sq, Skv) of each ``ops.flash_attention`` launch
    while the main path runs, by wrapping the autograd function it
    dispatches to on the card; adds no count."""

    def __init__(self, ops):
        self.ops, self.calls = ops, []

    def __enter__(self):
        orig, calls = self.ops._FlashAttention, self.calls
        self.orig = orig

        class Recording:
            @staticmethod
            def apply(q, k, v, scale, causal, *rest):
                calls.append((bool(causal), q.shape[1], k.shape[1]))
                return orig.apply(q, k, v, scale, causal, *rest)
        self.ops._FlashAttention = Recording
        return self

    def __exit__(self, *exc):
        self.ops._FlashAttention = self.orig
        return False


def encdec_flash_calls(cfg, S: int, L: int) -> list[tuple]:
    """The flash launches of one forward, in order: each encoder layer's
    bidirectional self-attention (S on S), then each decoder layer's
    causal self-attention (L on L) and its cross-attention (L on S)."""
    return ([(False, S, S)] * cfg.encoder_layers
            + [(True, L, L), (False, L, S)] * cfg.n_layers)


def encdec_batch(cfg, B: int, S: int, L: int, gen, device="cuda",
                 labels: bool = False) -> dict:
    """S source frames (B, S, d), uniform in [-1, 1), and L target tokens
    (and labels) drawn from ``gen`` on ``device``."""
    batch = {"src_frames": torch.rand((B, S, cfg.d_model), generator=gen,
                                      device=device) * 2 - 1}
    names = ("tgt_tokens", "labels") if labels else ("tgt_tokens",)
    for name in names:
        batch[name] = torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                                    device=device, dtype=torch.int32)
    return batch


def encdec_prefill(ops, model, params) -> dict:
    """Step 22 (a): ``prefill_fn`` on PREFILL_BATCH x PREFILL_LEN target
    tokens over as many source frames, bf16, the counts at 0 before and
    read after: 36 flash launches, all wgmma/chunked, in the order
    ``encdec_flash_calls`` gives (12 bidirectional, then 12 causal and 12
    cross interleaved), no crossbar launch; logits finite, pad columns
    -1e30; the peak memory, the time of one more call (CUDA events),
    tokens/s and a profile with the flash kernels' share."""
    cfg = model.cfg
    B, S = PREFILL_BATCH, PREFILL_LEN
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = encdec_batch(cfg, B, S, S, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts(ops)
    with FlashRecorder(ops) as fr:
        logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    n = cfg.encoder_layers + 2 * cfg.n_layers
    check_flash_counts(ops, n, "wgmma", f"{ENCDEC_ARCH} prefill")
    if fr.calls != encdec_flash_calls(cfg, S, S):
        raise AssertionError(f"{ENCDEC_ARCH} prefill launched (causal, Sq, "
                             f"Skv) {fr.calls}")
    xb = {k: getattr(ops, k).launches for k in XB_NAMES}
    if any(xb.values()):
        raise AssertionError(f"{ENCDEC_ARCH} prefill launched {xb}")
    want_shape = check_prefill_logits(logits, cfg, B, S)
    peak = torch.cuda.max_memory_allocated()
    del logits
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=1, warmup=0)
    prof = profile_device(lambda: model.prefill_fn(params, batch), reps=1,
                          match=FLASH_KERNELS)
    out = {"flash_attention launches": n,
           "bidirectional, causal, cross": [
               sum(c == (False, S, S) for c in fr.calls[:cfg.encoder_layers]),
               sum(c[0] for c in fr.calls),
               sum(not c[0] for c in fr.calls[cfg.encoder_layers:])],
           "route": "wgmma/chunked", "peak GB": peak / 1e9,
           "prefill ms": ms, "prefill tokens/s": B * S / ms * 1e3,
           "flash kernels ms (profiler)": prof["matched_ms"],
           "profile": prof, "batch": batch}
    print(f"encdec prefill ({ENCDEC_ARCH} full width and depth, "
          f"{cfg.param_count():,} parameters, bf16 compute, {B} x {S} "
          f"target tokens on {S} source frames): {n} flash_attention "
          f"launches (bidirectional, causal, cross "
          f"{out['bidirectional, causal, cross']}, all wgmma/chunked), "
          f"logits {want_shape} finite, pad columns -1e30; peak "
          f"{peak / 1e9:.2f} GB; {ms:.3f} ms, "
          f"{out['prefill tokens/s']:.0f} target tokens/s; profile span "
          f"{prof['span_ms']:.3f} ms, busy {ms3(prof['device_busy_ms'])} "
          f"ms (flash kernels {ms3(prof['matched_ms'])} ms), idle share "
          f"{ms3(prof['device_idle_share'])}")
    print("encdec prefill profile (profiler on): " + json.dumps(prof))
    return out


def encdec_serve(ops, model, params, frames, BatchedServer) -> dict:
    """``BatchedServer(batch=4)`` serving ``launch/serve.py``'s 8-token
    prompts with ``max_new=ENCDEC_SERVE_NEW`` (23 steps) in the model's
    compute dtype and a cache of it, its cross cache filled by ``encode``
    (one flash launch an encoder layer) and ``fill_cross_cache`` from
    ``frames``, its decode logits recorded; then ``prefill_fn`` on the
    same frames and each slot's prompt + generated tokens (a check: its
    launches are not the path's).  Returns the decode and prefill logits
    (vocab columns), the sequences, the generated tokens, the server, its
    time and launches."""
    from repro_torch.dist.sharding import tree_map
    from repro_torch.models import encdec as ed
    cfg = model.cfg
    dtype = getattr(torch, cfg.compute_dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]
    zero_flash_counts(ops)
    with torch.no_grad():
        enc = ed.encode(cfg, params, frames)
    cross = ed.fill_cross_cache(cfg, params, enc, dtype)
    check_flash_counts(ops, cfg.encoder_layers, route,
                       f"encode for the cross cache ({cfg.compute_dtype})")
    encode_launches = ops.flash_attention.launches
    del enc

    def fill(server):
        # as a caller replaces a cache leaf after building the server
        server.cache["cross"] = tree_map(torch.clone, cross)

    zero_flash_counts(ops)
    run = serve_session(model, params, BatchedServer, prompts,
                        ENCDEC_SERVE_NEW, ENCDEC_SERVE_MAX_LEN, dtype,
                        prepare=fill)
    server, outs = run["server"], run["outs"]
    launches = ops.flash_attention.launches
    steps, toks = server.stats.steps, server.stats.tokens_out
    if (steps, toks) != (8 + ENCDEC_SERVE_NEW - 1,
                         SERVE_BATCH * ENCDEC_SERVE_NEW):
        raise AssertionError(f"server: {steps} steps, {toks} tokens")
    seqs = torch.tensor([p + o for p, o in zip(prompts, outs)],
                        dtype=torch.int32, device="cuda")
    zero_flash_counts(ops)
    full = model.prefill_fn(params, {"src_frames": frames,
                                     "tgt_tokens": seqs})[
        ..., :cfg.vocab_size]
    torch.cuda.synchronize()
    check_flash_counts(ops, cfg.encoder_layers + 2 * cfg.n_layers, route,
                       f"the check's prefill ({cfg.compute_dtype})")
    return {**run, "dec": run["dec_all"][..., :cfg.vocab_size],
            "pre": full[:, :steps], "seqs": seqs, "steps": steps,
            "tokens": toks, "launches": launches,
            "encode launches": encode_launches}


def check_decode_in_norm(run: dict, dist: float, what: str) -> dict:
    """bf16 decode against bf16 prefill: the logits' relative Frobenius
    distance within 2 ``dist`` (two bf16 computations of one function,
    each within ``dist`` of the float32 result), and every generated
    token the prefill argmax but where its top-2 gap is within twice the
    position's largest |decode - prefill| (a near-tie, counted); raises
    otherwise."""
    dec, pre = run["dec"], run["pre"]
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{what}: decode logits not finite")
    rel = float(torch.linalg.norm(dec - pre) / torch.linalg.norm(pre))
    if not rel <= 2 * dist:
        raise AssertionError(f"{what}: decode vs prefill relative "
                             f"distance {rel} > 2 x {dist}")
    top2 = torch.topk(pre[:, 7:], 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    near = 2 * (dec - pre)[:, 7:].abs().amax(-1)
    off = torch.tensor(run["outs"], device="cuda") != pre[:, 7:].argmax(-1)
    if bool((off & (gap > near)).any()):
        raise AssertionError(f"{what}: a generated token is not the "
                             f"prefill argmax away from a near-tie")
    return {"relative distance ||decode - prefill|| / ||prefill||": rel,
            "bar": 2 * dist,
            "max |decode - prefill| logit": float((dec - pre).abs().max()),
            "max |logit|": float(pre.abs().max()),
            "tokens excused as near-ties": int(off.sum()),
            "steps": run["steps"], "tokens_out": run["tokens"],
            "decode ms per step": run["ms"] / run["steps"],
            "decode tokens/s": run["tokens"] / run["ms"] * 1e3,
            "flash_attention launches in BatchedServer.generate":
                run["launches"]}


def encdec_decode(ops, model, model32, params, frames,
                  BatchedServer) -> dict:
    """Step 22 (b): ``encdec_serve`` in float32 compute with a float32
    self and cross cache, its decode within LOGIT_BAR float32 of its
    prefill; then in bf16 (bf16 caches), within 2 x ENCDEC_BF16_DIST in
    norm (``check_decode_in_norm``); no flash launch while serving (a
    decode step attends through plain ``decode_attention``); ms per step
    and a profiled bf16 step."""
    out = {}
    run32 = encdec_serve(ops, model32, params, frames, BatchedServer)
    out["float32"] = check_decode(run32, LOGIT_BAR["float32"],
                                  f"{ENCDEC_ARCH} float32")
    out["float32"]["flash launches (encode)"] = run32["encode launches"]
    out["float32"]["captured decode"] = graph_session(
        run32, BatchedServer, f"{ENCDEC_ARCH}, float32")
    del run32
    run = encdec_serve(ops, model, params, frames, BatchedServer)
    out["bfloat16"] = check_decode_in_norm(run, ENCDEC_BF16_DIST,
                                           f"{ENCDEC_ARCH} bf16")
    out["bfloat16"]["flash launches (encode)"] = run["encode launches"]
    zero_flash_counts(ops)
    out["bfloat16"]["captured decode"] = graph_session(
        run, BatchedServer, f"{ENCDEC_ARCH}, bfloat16")
    check_flash_counts(ops, 0, "wgmma", f"{ENCDEC_ARCH} captured and "
                       f"eager serving")
    for compute, r in out.items():
        if r["flash_attention launches in BatchedServer.generate"]:
            raise AssertionError(f"{ENCDEC_ARCH} {compute}: serving "
                                 f"launched the flash kernel")
    server, seqs, steps = run["server"], run["seqs"], run["steps"]
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out["bfloat16"]["decode step profile"] = prof
    r32, r = out["float32"], out["bfloat16"]
    print(f"encdec decode vs prefill ({ENCDEC_ARCH}, cross cache from "
          f"encode + fill_cross_cache on the prefill's {PREFILL_LEN} "
          f"frames): float32 {r32['steps']} steps, max |decode - prefill| "
          f"{r32['max |decode - prefill| logit']:.3e} (bar {r32['bar']}), "
          f"{r32['tokens excused as near-ties']} tokens at near-ties, "
          f"{r32['decode ms per step']:.3f} ms per step; bf16 relative "
          f"distance "
          f"{r['relative distance ||decode - prefill|| / ||prefill||']:.3e}"
          f" (bar {r['bar']}), max |Δ| "
          f"{r['max |decode - prefill| logit']:.3e} of max |logit| "
          f"{r['max |logit|']:.3f}, {r['tokens excused as near-ties']} "
          f"tokens at near-ties, {r['decode ms per step']:.3f} ms per step, "
          f"{r['decode tokens/s']:.1f} tokens/s; one bf16 step under the "
          f"profiler: {prof['span_ms']:.3f} ms span, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])}")
    return out


def train_run(ops, cfg, optimizer: str, batches: list[dict], flash: int,
              keep: int = 0, xbk=None, profile: bool = True,
              offload: bool = False) -> dict:
    """``make_train_step`` for ``cfg`` on cuda, one step of ``optimizer``
    on the launcher's schedule per batch of ``batches`` (on the card), the
    counts at 0 before and read after: ``flash`` flash launches, all
    wgmma/chunked; each loss and grad norm finite; with ``xbk``, the
    first ``keep`` forward and last ``keep`` bwd and dw crossbar launches
    of the first step recorded (layer 0's; in host memory with
    ``offload``).  Then the step's time (CUDA events, 2 more steps on the
    first batch), peak memory, a profile (None unless ``profile``) and the
    seconds each part took."""
    from repro_torch.models import build_model
    from repro_torch.runtime import make_train_step
    steps = len(batches)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    opt = launch_train_config(cfg, optimizer, steps)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    part_s = {"init": time.perf_counter() - t0}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts(ops)
    metrics, rec = [], None
    for s, batch in enumerate(batches):
        if s == 0 and xbk is not None:
            with Layer0Recorder(xbk, keep, offload) as rec:
                params, opt_state, m = step(params, opt_state, batch, s)
        else:
            params, opt_state, m = step(params, opt_state, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
        if not (math.isfinite(metrics[-1]["loss"])
                and math.isfinite(metrics[-1]["grad_norm"])):
            raise AssertionError(f"{cfg.name} step {s}: {metrics[-1]}")
    launches = {n: getattr(ops, n).launches for n in XB_NAMES}
    check_flash_counts(ops, flash, "wgmma", f"{cfg.name} training")
    peak = torch.cuda.max_memory_allocated()
    part_s["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: step(params, opt_state, batches[0], 0), iters=2,
                 warmup=0)
    part_s["timed steps"] = time.perf_counter() - t0
    prof = None
    if profile:
        t0 = time.perf_counter()
        prof = profile_device(lambda: step(params, opt_state, batches[0],
                                           0),
                              reps=1, match=r"crossbar_(fwd|bwd|dw)")
        part_s["profiled step"] = time.perf_counter() - t0
    tokens = next(v for k, v in batches[0].items()
                  if k in ("tokens", "tgt_tokens")).numel()
    return {"params": params, "rec": rec, "launches": launches, "s": part_s,
            "flash": flash, "losses": [m["loss"] for m in metrics],
            "grad norms": [m["grad_norm"] for m in metrics],
            "peak GB": peak / 1e9, "step ms": ms,
            "tokens/s": tokens / ms * 1e3, "profile": prof}


def encdec_train(ops, xbk) -> dict:
    """Step 22 (c): the full config trains, bf16 compute, remat "full":
    ENCDEC_TRAIN_STEPS adamw steps, then crossbar kernel mode with
    pulse_sgd, ENCDEC_XB_STEPS steps (a step: 192 projections a forward,
    6 an encoder layer and 10 a decoder layer, run twice under remat:
    384 ``crossbar_fwd``, 192 ``crossbar_bwd`` and 192 ``crossbar_dw``),
    encoder layer 0's launches of its first step held against their plain
    versions within XB_BAR of sum_k |x_k||w_k| and re-timed on their
    operands (kernel, plain, ``torch.bmm``, the bound); conductances in
    [0, 4]."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.checkpoint import _walk
    cfg = get_config(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def batches(steps):
        return [encdec_batch(cfg, PREFILL_BATCH, PREFILL_LEN, PREFILL_LEN,
                             gen, labels=True) for _ in range(steps)]

    def flash(steps):     # the forward's launches and their recomputation
        return 2 * len(encdec_flash_calls(cfg, 1, 1)) * steps
    std = train_run(ops, cfg, "adamw", batches(ENCDEC_TRAIN_STEPS),
                    flash(ENCDEC_TRAIN_STEPS))
    del std["params"], std["rec"]
    if any(std["launches"].values()):
        raise AssertionError(f"standard training launched "
                             f"{std['launches']}")
    gc_collect()
    xcfg = get_config(ENCDEC_ARCH, crossbar=True, xbar_use_kernel=True)
    xb = train_run(ops, xcfg, "pulse_sgd", batches(ENCDEC_XB_STEPS),
                   flash(ENCDEC_XB_STEPS), ENCDEC_PROJECTIONS["encoder"],
                   xbk)
    per_pass = (ENCDEC_PROJECTIONS["encoder"] * xcfg.encoder_layers
                + ENCDEC_PROJECTIONS["decoder"] * xcfg.n_layers)
    want = {"crossbar_fwd": 2 * per_pass * ENCDEC_XB_STEPS,
            "crossbar_bwd": per_pass * ENCDEC_XB_STEPS,
            "crossbar_dw": per_pass * ENCDEC_XB_STEPS}
    if xb["launches"] != want:
        raise AssertionError(f"crossbar kernel mode ran {xb['launches']}, "
                             f"expected {want}")
    g = [t for path, t in _walk(xb.pop("params"))
         if any(k in ("g_plus", "g_minus") for k in path)]
    lo, hi = min(float(t.min()) for t in g), max(float(t.max()) for t in g)
    if lo < 0.0 or hi > xcfg.xbar_w_max:
        raise AssertionError(f"conductances in [{lo}, {hi}], outside "
                             f"[0, {xcfg.xbar_w_max}]")
    del g
    rec = xb.pop("rec")
    t0 = time.perf_counter()
    xb["layer-0 launches vs plain, max |err| / sum |x||w|"] = \
        check_layer0_launches(xbk, rec)
    xb["rows"] = lm_crossbar_rows(xbk, rec, ENCDEC_ARCH)
    xb["s"]["layer-0 checks and rows"] = time.perf_counter() - t0
    del rec
    prof = xb["profile"]
    xb["projections a forward"] = per_pass
    xb["conductance range"] = [lo, hi]
    xb["crossbar kernels' share of device time"] = (
        None if prof["device_busy_ms"] is None
        else prof["matched_ms"] / prof["device_busy_ms"])
    for what, r in (("standard, adamw", std),
                    ("crossbar kernel mode, pulse_sgd", xb)):
        print(f"encdec training ({ENCDEC_ARCH} full width and depth, bf16 "
              f"compute, remat full, {PREFILL_BATCH} x {PREFILL_LEN} "
              f"target tokens on {PREFILL_LEN} frames, {what}): launches "
              f"{json.dumps(r['launches'])}, {r['flash']} flash; losses "
              f"{[round(v, 4) for v in r['losses']]}; step "
              f"{r['step ms']:.3f} ms, {r['tokens/s']:.0f} tokens/s, peak "
              f"{r['peak GB']:.2f} GB; profile busy "
              f"{ms3(r['profile']['device_busy_ms'])} ms of "
              f"{r['profile']['span_ms']:.3f}, idle share "
              f"{ms3(r['profile']['device_idle_share'])} [{card_line()}]; "
              f"seconds {json.dumps(r['s'])}")
    print(f"  encoder layer 0's launches vs plain (max |err| / sum |x||w|, "
          f"bar {XB_BAR}): " + json.dumps(
              xb["layer-0 launches vs plain, max |err| / sum |x||w|"])
          + f"; conductances in [{lo}, {hi}]; crossbar kernels "
          f"{ms3(prof['matched_ms'])} ms of the busy time")
    print_crossbar_rows(xb["rows"])
    print("encdec training profiles (profiler on): " + json.dumps(
        {"standard": std["profile"], "crossbar": prof}))
    return {"standard": std, "crossbar": xb}


def encdec_reduced(ops) -> dict:
    """Step 22 (d), serving: the reduced config in float32 compute,
    ``prefill_fn`` on 2 x 64 target tokens over 96 source frames (the
    cross-attention at Sq != Skv: 6 simt launches) and 8 decode steps over
    float32 caches (the cross cache from ``encode``, 2 launches, and
    ``fill_cross_cache``), on the card and on the CPU from the same
    parameters and inputs, each output within CARD_VS_CPU_BAR of its
    largest |value|."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.dist.sharding import tree_map
    from repro_torch.models import build_model
    from repro_torch.models import encdec as ed
    cfg = get_reduced_config(ENCDEC_ARCH, compute_dtype="float32")
    p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    batch0 = encdec_batch(cfg, 2, 96, 64, torch.Generator().manual_seed(
        SEED), device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        batch = {k: v.to(dev) for k, v in batch0.items()}
        zero_lm_counts(ops)
        pre = model.prefill_fn(params, batch)
        if dev == "cuda":
            check_flash_counts(ops, cfg.encoder_layers + 2 * cfg.n_layers,
                               "simt", f"reduced {ENCDEC_ARCH} prefill")
        cache = model.init_cache(2, 16, torch.float32, src_len=96)
        with torch.no_grad():
            enc = ed.encode(cfg, params, batch["src_frames"])
        cache["cross"] = ed.fill_cross_cache(cfg, params, enc,
                                             torch.float32)
        tok, dec = batch["tgt_tokens"], []
        for step in range(8):
            logits, cache = model.decode_fn(
                params, cache, {"tokens": tok[:, step:step + 1],
                                "length": step})
            dec.append(logits)
        runs[dev] = (pre.cpu(), torch.cat(dec, dim=1).cpu(),
                     cache["self"]["k"].cpu())
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(runs["cuda"], runs["cpu"]))
    if not rel <= CARD_VS_CPU_BAR:
        raise AssertionError(f"reduced {ENCDEC_ARCH} float32: card vs CPU "
                             f"{rel}")
    out = {"card vs cpu, of each output's largest (prefill, decode, self "
           "k cache)": rel,
           "flash launches (prefill, card)": cfg.encoder_layers
           + 2 * cfg.n_layers}
    print(f"encdec reduced serving ({ENCDEC_ARCH} reduced, float32, 2 x 64 "
          f"prefill on 96 frames and 8 decode steps, card vs CPU): "
          + json.dumps(out))
    return out


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def encdec_path(ops, xbk) -> dict:
    """The encoder-decoder family (module docstring, step 22)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    t0 = time.perf_counter()
    model = build_model(get_config(ENCDEC_ARCH), "cuda")
    model32 = build_model(get_config(ENCDEC_ARCH, compute_dtype="float32"),
                          "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"init s": time.perf_counter() - t0,
           "parameters": model.cfg.param_count(), "part s": {}}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        out["part s"][name] = time.perf_counter() - t

    part("prefill", encdec_prefill, ops, model, params)
    frames = out["prefill"].pop("batch")["src_frames"]
    part("decode", encdec_decode, ops, model, model32, params, frames,
         BatchedServer)
    del params, frames
    gc_collect()
    part("train", encdec_train, ops, xbk)
    gc_collect()
    part("reduced serving", encdec_reduced, ops)
    part("reduced training", lm_train_card_vs_cpu, ops, ENCDEC_ARCH)
    out["s"] = time.perf_counter() - t0
    print(f"encdec path parts (s): " + json.dumps(out["part s"]))
    return out


# -- the VLM family (qwen2-vl-72b at full width, the depth cut) -------------

VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 8            # serving depth: 9,580,011,520 fp32 parameters
VLM_TRAIN_LAYERS = 1      # training depth: 3,436,218,368
VLM_BATCH = 2             # prefill and training: 2 x 2048 tokens
# bf16 decode against bf16 prefill, relative Frobenius distance of the
# logits: d, the reference's own bf16-vs-float32 distance of its prefill
# logits on its reduced config, the largest over 8 batches of 4 x 24 text
# tokens from numpy seeds 0-7 (0.0109-0.0130), measured on the CPU;
# tests/test_torch_vlm.py computes it again and holds this figure to it
VLM_BF16_DIST = 0.012994
VLM_TRAIN_STEPS, VLM_XB_STEPS = 3, 2
# (B, Sq, Skv, H, K, hd, dtype, what) of the VLM flash phase: qwen2-vl's
# prefill attention (64 heads on 8, hd 128, causal) in both sources
VLM_FLASH_CASES = [
    (VLM_BATCH, PREFILL_LEN, PREFILL_LEN, 64, 8, 128, "bfloat16",
     "qwen2-vl prefill"),
    (VLM_BATCH, PREFILL_LEN, PREFILL_LEN, 64, 8, 128, "float32",
     "qwen2-vl prefill, fp32"),
]


def flash_vlm_phase(fak, gen, report) -> tuple[float, list[dict]]:
    """Both flash sources causal at VLM_FLASH_CASES (``flash_case``):
    qwen2-vl's prefill shape beside SDPA and the bound, in both functions
    under the flash phase's bars.  Returns (max |err|, rows).  Launches
    here are not counted."""
    worst, rows = 0.0, []
    for B, Sq, Skv, H, K, hd, dt, what in VLM_FLASH_CASES:
        err, case_rows = flash_case(fak, gen, report, B, Sq, Skv, H, K, hd,
                                    True, dt, what)
        worst = max(worst, err)
        rows += case_rows
    print(f"flash vlm phase: qwen2-vl's prefill shape ({VLM_BATCH} x "
          f"{PREFILL_LEN}, 64 heads on 8, hd 128, causal) in both sources "
          f"x 2 functions within the flash phase's bars; max |err| "
          f"{worst:.3e}")
    print_flash_rows(rows)
    return worst, rows


def uniform_patches(cfg, B: int, gen, device="cuda") -> torch.Tensor:
    """Stub patch embeddings (B, vlm_patches, d_model), uniform in [-1,
    1), drawn from ``gen`` on ``device``."""
    return torch.rand((B, cfg.vlm_patches, cfg.d_model), generator=gen,
                      device=device) * 2 - 1


def vlm_batch(cfg, B: int, L: int, gen, labels: bool = False) -> dict:
    """L tokens (and labels) and the config's patch embeddings for B rows,
    drawn from ``gen`` on the card."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, L),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "patch_embeds": uniform_patches(cfg, B, gen)}
    if labels:
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, L),
                                        generator=gen, device="cuda",
                                        dtype=torch.int32)
    return batch


def vlm_prefill(ops, model, params) -> dict:
    """Step 23 (a): ``prefill_fn`` on VLM_BATCH x PREFILL_LEN tokens with
    the config's 256 patch embeddings merged, bf16, the counts at 0 before
    and read after: one flash launch a layer, all wgmma/chunked, no
    crossbar launch; logits finite; the same call without the patches (a
    check, not counted) finite and apart at every patch position; the
    peak memory, the time of one more call (CUDA events), tokens/s and a
    profile with the idle share and the flash kernels' share."""
    cfg = model.cfg
    B, S, P = VLM_BATCH, PREFILL_LEN, cfg.vlm_patches
    batch = vlm_batch(cfg, B, S, torch.Generator(device="cuda").manual_seed(
        SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts(ops)
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    check_flash_counts(ops, cfg.n_layers, "wgmma", f"{VLM_ARCH} prefill")
    xb = {k: getattr(ops, k).launches for k in XB_NAMES}
    if any(xb.values()):
        raise AssertionError(f"{VLM_ARCH} prefill launched {xb}")
    want_shape = check_prefill_logits(logits, cfg, B, S)
    peak = torch.cuda.max_memory_allocated()
    plain = model.prefill_fn(params, {"tokens": batch["tokens"]})
    check_prefill_logits(plain, cfg, B, S)
    apart = (logits[:, :P] != plain[:, :P]).any(-1)
    if not bool(apart.all()):
        raise AssertionError(f"{VLM_ARCH} prefill: merged and unmerged "
                             f"logits equal at a patch position")
    diff = float((logits - plain).abs().max())
    del logits, plain
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=1, warmup=0)
    prof = profile_device(lambda: model.prefill_fn(params, batch), reps=1,
                          match=FLASH_KERNELS)
    out = {"layers": cfg.n_layers, "parameters": cfg.param_count(),
           "flash_attention launches": cfg.n_layers,
           "route": "wgmma/chunked", "peak GB": peak / 1e9,
           "max |merged - unmerged| logit": diff,
           "prefill ms": ms, "prefill tokens/s": B * S / ms * 1e3,
           "flash kernels ms (profiler)": prof["matched_ms"],
           "profile": prof}
    print(f"vlm prefill ({VLM_ARCH} full width, {cfg.n_layers} layers, "
          f"{cfg.param_count():,} parameters, bf16 compute, {B} x {S} "
          f"tokens, {P} patches merged): {cfg.n_layers} flash_attention "
          f"launches (all wgmma/chunked), logits {want_shape} finite, "
          f"apart from the unmerged call's at every patch position (max "
          f"|Δ| {diff:.3e}); peak {peak / 1e9:.2f} GB; {ms:.3f} ms, "
          f"{out['prefill tokens/s']:.0f} tokens/s; profile span "
          f"{prof['span_ms']:.3f} ms, busy {ms3(prof['device_busy_ms'])} "
          f"ms (flash kernels {ms3(prof['matched_ms'])} ms), idle share "
          f"{ms3(prof['device_idle_share'])} [{card_line()}]")
    print("vlm prefill profile (profiler on): " + json.dumps(prof))
    return out


def vlm_decode(ops, model, model32, params, BatchedServer) -> dict:
    """Step 23 (b): ``hybrid_serve`` (the CLI's text prompts, 23 steps) in
    float32 compute with a float32 cache, its decode within LOGIT_BAR
    float32 of its prefill; then in bf16 (a bf16 cache), within 2 x
    VLM_BF16_DIST in norm (``check_decode_in_norm``); no flash launch
    while serving; ms per step and a profiled bf16 step."""
    out = {}
    run32 = hybrid_serve(ops, model32, params, BatchedServer)
    out["float32"] = check_decode(run32, LOGIT_BAR["float32"],
                                  f"{VLM_ARCH} float32")
    out["float32"]["captured decode"] = graph_session(
        run32, BatchedServer, f"{VLM_ARCH} at {model.cfg.n_layers} layers, "
        f"float32")
    del run32
    run = hybrid_serve(ops, model, params, BatchedServer)
    out["bfloat16"] = check_decode_in_norm(run, VLM_BF16_DIST,
                                           f"{VLM_ARCH} bf16")
    out["bfloat16"]["captured decode"] = graph_session(
        run, BatchedServer, f"{VLM_ARCH} at {model.cfg.n_layers} layers, "
        f"bfloat16")
    for compute, r in out.items():
        if r["flash_attention launches in BatchedServer.generate"]:
            raise AssertionError(f"{VLM_ARCH} {compute}: serving launched "
                                 f"the flash kernel")
    server, seqs, steps = run["server"], run["seqs"], run["steps"]
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out["bfloat16"]["decode step profile"] = prof
    r32, r = out["float32"], out["bfloat16"]
    print(f"vlm decode vs prefill ({VLM_ARCH}, {model.cfg.n_layers} "
          f"layers, text prompts, M-RoPE at text positions): float32 "
          f"{r32['steps']} steps, max |decode - prefill| "
          f"{r32['max |decode - prefill| logit']:.3e} (bar {r32['bar']}), "
          f"{r32['tokens excused as near-ties']} tokens at near-ties, "
          f"{r32['decode ms per step']:.3f} ms per step; bf16 relative "
          f"distance "
          f"{r['relative distance ||decode - prefill|| / ||prefill||']:.3e}"
          f" (bar {r['bar']}), max |Δ| "
          f"{r['max |decode - prefill| logit']:.3e} of max |logit| "
          f"{r['max |logit|']:.3f}, {r['tokens excused as near-ties']} "
          f"tokens at near-ties, {r['decode ms per step']:.3f} ms per step, "
          f"{r['decode tokens/s']:.1f} tokens/s; one bf16 step under the "
          f"profiler: {prof['span_ms']:.3f} ms span, busy "
          f"{ms3(prof['device_busy_ms'])} ms, idle share "
          f"{ms3(prof['device_idle_share'])} [{card_line()}]")
    return out


def vlm_train(ops, xbk) -> dict:
    """Step 23 (c): the config at full width and VLM_TRAIN_LAYERS layer
    trains on VLM_BATCH x PREFILL_LEN tokens with the 256 patches merged,
    bf16 compute, remat "full", no profile: VLM_TRAIN_STEPS adamw steps (2
    flash launches a step, the forward's and its recomputation), then
    crossbar kernel mode with pulse_sgd, VLM_XB_STEPS steps (a step: 7
    projections a layer, run twice under remat: 14 ``crossbar_fwd``, 7
    ``crossbar_bwd`` and 7 ``crossbar_dw``; the head, the embedding and
    the patch merger stay plain), layer 0's launches of the first step
    (kept in host memory while the steps run) held against their plain
    versions within XB_BAR of sum_k |x_k||w_k| after the steps' memory is
    freed, and re-timed on their operands over 3 calls (kernel, plain,
    ``torch.bmm``, the bound; no device-time graphs at tens of ms a
    launch); conductances in [0, 4]."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.checkpoint import _walk
    cfg = get_config(VLM_ARCH, n_layers=VLM_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def batches(steps):
        return [vlm_batch(cfg, VLM_BATCH, PREFILL_LEN, gen, labels=True)
                for _ in range(steps)]

    std = train_run(ops, cfg, "adamw", batches(VLM_TRAIN_STEPS),
                    2 * cfg.n_layers * VLM_TRAIN_STEPS, profile=False)
    del std["params"], std["rec"]
    if any(std["launches"].values()):
        raise AssertionError(f"standard training launched "
                             f"{std['launches']}")
    gc_collect()
    xcfg = cfg.replace(crossbar=True, xbar_use_kernel=True)
    xb = train_run(ops, xcfg, "pulse_sgd", batches(VLM_XB_STEPS),
                   2 * cfg.n_layers * VLM_XB_STEPS, XB_PROJECTIONS, xbk,
                   profile=False, offload=True)
    per_pass = XB_PROJECTIONS * xcfg.n_layers
    want = {"crossbar_fwd": 2 * per_pass * VLM_XB_STEPS,
            "crossbar_bwd": per_pass * VLM_XB_STEPS,
            "crossbar_dw": per_pass * VLM_XB_STEPS}
    if xb["launches"] != want:
        raise AssertionError(f"crossbar kernel mode ran {xb['launches']}, "
                             f"expected {want}")
    g = [t for path, t in _walk(xb.pop("params"))
         if any(k in ("g_plus", "g_minus") for k in path)]
    lo, hi = min(float(t.min()) for t in g), max(float(t.max()) for t in g)
    if lo < 0.0 or hi > xcfg.xbar_w_max:
        raise AssertionError(f"conductances in [{lo}, {hi}], outside "
                             f"[0, {xcfg.xbar_w_max}]")
    del g
    gc_collect()
    rec = xb.pop("rec")
    t0 = time.perf_counter()
    rec.to_device()
    xb["layer-0 launches vs plain, max |err| / sum |x||w|"] = \
        check_layer0_launches(xbk, rec)
    xb["rows"] = lm_crossbar_rows(xbk, rec, VLM_ARCH, iters=3, device=False)
    xb["s"]["layer-0 checks and rows"] = time.perf_counter() - t0
    del rec
    xb["projections a forward"] = per_pass
    xb["conductance range"] = [lo, hi]
    for what, r in (("standard, adamw", std),
                    ("crossbar kernel mode, pulse_sgd", xb)):
        print(f"vlm training ({VLM_ARCH} full width, {cfg.n_layers} layer, "
              f"{cfg.param_count():,} parameters, bf16 compute, remat full, "
              f"{VLM_BATCH} x {PREFILL_LEN} tokens with {cfg.vlm_patches} "
              f"patches, {what}): launches {json.dumps(r['launches'])}, "
              f"{r['flash']} flash; losses "
              f"{[round(v, 4) for v in r['losses']]}; step "
              f"{r['step ms']:.3f} ms, {r['tokens/s']:.0f} tokens/s, peak "
              f"{r['peak GB']:.2f} GB (not profiled) [{card_line()}]; "
              f"seconds {json.dumps(r['s'])}")
    print(f"  layer 0's launches vs plain (max |err| / sum |x||w|, bar "
          f"{XB_BAR}): " + json.dumps(
              xb["layer-0 launches vs plain, max |err| / sum |x||w|"])
          + f"; conductances in [{lo}, {hi}]")
    print_crossbar_rows(xb["rows"])
    return {"standard": std, "crossbar": xb}


def vlm_reduced(ops) -> dict:
    """Step 23 (d), serving: the reduced config in float32 compute,
    ``prefill_fn`` on 2 x 64 tokens with its 8 patch embeddings merged (2
    simt launches) and 8 decode steps over a float32 cache, on the card
    and on the CPU from the same parameters and inputs, each output within
    CARD_VS_CPU_BAR of its largest |value|."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.dist.sharding import tree_map
    from repro_torch.models import build_model
    cfg = get_reduced_config(VLM_ARCH, compute_dtype="float32")
    p0 = build_model(cfg, "cpu").init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED)
    batch0 = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                      generator=gen, dtype=torch.int32),
              "patch_embeds": uniform_patches(cfg, 2, gen, "cpu")}
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        batch = {k: v.to(dev) for k, v in batch0.items()}
        zero_lm_counts(ops)
        pre = model.prefill_fn(params, batch)
        if dev == "cuda":
            check_flash_counts(ops, cfg.n_layers, "simt",
                               f"reduced {VLM_ARCH} prefill")
        cache = model.init_cache(2, 16, torch.float32)
        tok, dec = batch["tokens"], []
        for step in range(8):
            logits, cache = model.decode_fn(
                params, cache, {"tokens": tok[:, step:step + 1],
                                "length": step})
            dec.append(logits)
        runs[dev] = (pre.cpu(), torch.cat(dec, dim=1).cpu(),
                     cache["stack"]["b0_attn"]["k"].cpu())
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(runs["cuda"], runs["cpu"]))
    if not rel <= CARD_VS_CPU_BAR:
        raise AssertionError(f"reduced {VLM_ARCH} float32: card vs CPU "
                             f"{rel}")
    out = {"card vs cpu, of each output's largest (prefill, decode, k "
           "cache)": rel,
           "flash launches (prefill, card)": cfg.n_layers}
    print(f"vlm reduced serving ({VLM_ARCH} reduced, float32, 2 x 64 "
          f"prefill with {cfg.vlm_patches} patches and 8 decode steps, card "
          f"vs CPU): " + json.dumps(out))
    return out


def vlm_path(ops, xbk) -> dict:
    """The VLM family (module docstring, step 23)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    t0 = time.perf_counter()
    model = build_model(get_config(VLM_ARCH, n_layers=VLM_LAYERS), "cuda")
    model32 = build_model(get_config(VLM_ARCH, n_layers=VLM_LAYERS,
                                     compute_dtype="float32"), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"init s": time.perf_counter() - t0,
           "parameters": model.cfg.param_count(), "part s": {}}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        out["part s"][name] = time.perf_counter() - t

    part("prefill", vlm_prefill, ops, model, params)
    part("decode", vlm_decode, ops, model, model32, params, BatchedServer)
    del params
    gc_collect()
    part("train", vlm_train, ops, xbk)
    gc_collect()
    part("reduced serving", vlm_reduced, ops)
    part("reduced training", lm_train_card_vs_cpu, ops, VLM_ARCH)
    out["s"] = time.perf_counter() - t0
    print(f"vlm path parts (s): " + json.dumps(out["part s"]))
    return out


DIST_ARCH = "qwen2-0.5b"     # the dense config step 18 trains, full width
DIST_STEPS = 2               # (a) and (d): steps held bit for bit
DIST_INT8_STEPS = 4          # (b): the int8 steps whose loss must fall
DIST_INT8_SHAPE = (4, 1)     # (b): make_host_mesh(shape=) folded onto the card
PIPE_STAGES, PIPE_MICRO = 4, 8   # (c): 4 stages of 6 layers, 8 x (1, 2048)


class CompressionTimer:
    """Wraps ``dist.collectives.compressed_grad_mean`` while a step runs and
    times each call by CUDA events (restored on exit)."""

    def __init__(self):
        from repro_torch.dist import collectives as coll
        self.coll, self.orig, self.events = coll, coll.compressed_grad_mean, []

    def __enter__(self):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        self.coll.compressed_grad_mean = timed
        return self

    def __exit__(self, *exc):
        self.coll.compressed_grad_mean = self.orig
        return False

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def timed_steps(step, state: dict, batches: list[dict], *extra) -> list:
    """Run ``step(params, opt_state, batch, i, *extra)`` over ``batches``,
    writing ``state`` in place; each step's ms by CUDA events and its
    third output."""
    out = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state["params"], state["opt"], r = step(
            state["params"], state["opt"], batch, i, *extra)
        end.record()
        end.synchronize()
        out.append((start.elapsed_time(end), r))
    return out


def trees_equal(a, b, what: str) -> None:
    same, diff = params_equal(a, b)
    if not same:
        raise AssertionError(f"{what}: differ by up to {diff}")


def dist_dp(ops, model, stream) -> dict:
    """Step 24 (a) and (b): ``dp_train_step_fn`` at full width."""
    from repro_torch.dist.collectives import dp_train_step_fn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import make_train_step
    cfg = model.cfg
    tokens = TRAIN_BATCH * TRAIN_LEN
    per_pass = 2 * cfg.n_layers          # a forward and its recomputation
    gen = torch.Generator(device="cuda")

    def fresh(opt) -> dict:
        params = model.init(gen.manual_seed(SEED))
        return {"params": params, "opt": opt.init(params)}

    batches = [{k: v.cuda() for k, v in stream.batch_at(s).items()}
               for s in range(DIST_INT8_STEPS)]
    t0 = time.perf_counter()
    # (a) one shard, mode "none", against make_train_step
    host = make_host_mesh()
    if host.size != 1:
        raise AssertionError(f"make_host_mesh() is {host.shape}, not one "
                             f"device")
    opt = launch_train_config(cfg, "adamw", DIST_STEPS)
    ref = fresh(opt)
    zero_flash_counts(ops)
    ref_runs = timed_steps(make_train_step(model, opt), ref,
                           batches[:DIST_STEPS])
    dp = fresh(opt)
    dp_step = dp_train_step_fn(model.loss_fn, opt, host, compression="none")
    with CompressionTimer() as ct:
        dp_runs = timed_steps(dp_step, dp, batches[:DIST_STEPS])
    check_flash_counts(ops, 2 * per_pass * DIST_STEPS, "wgmma",
                       "(a): the train step's and the dp step's steps")
    trees_equal(dp["params"], ref["params"], "(a) dp step params vs "
                "make_train_step's")
    trees_equal(dp["opt"], ref["opt"], "(a) dp step adamw state vs "
                "make_train_step's")
    losses = [float(r) for _, r in dp_runs]
    if losses != [float(r["loss"]) for _, r in ref_runs]:
        raise AssertionError(f"(a) dp losses {losses} differ")
    a = {"mesh": host.shape, "losses": losses,
         "step ms (dp, second step)": dp_runs[-1][0],
         "step ms (make_train_step, second step)": ref_runs[-1][0],
         "compression ms (none)": ct.ms()[-1],
         "flash launches": 2 * per_pass * DIST_STEPS,
         "params and adamw state bit for bit": True}
    a["tokens/s (dp)"] = tokens / a["step ms (dp, second step)"] * 1e3
    t = time.perf_counter()
    a["profile"] = profile_device(
        lambda: dp_step(dp["params"], dp["opt"], batches[0], 0), reps=1,
        cpu=False)
    a["profile s"] = time.perf_counter() - t
    a["s"] = time.perf_counter() - t0
    del ref, dp
    gc_collect()
    t0 = time.perf_counter()
    # (b) mode "int8" on (4, 1) folded onto the card
    mesh = make_host_mesh(shape=DIST_INT8_SHAPE)
    opt = adamw(3e-3)
    st = fresh(opt)
    step = dp_train_step_fn(model.loss_fn, opt, mesh, compression="int8")
    noise = torch.Generator(device="cuda").manual_seed(SEED)
    zero_flash_counts(ops)
    with CompressionTimer() as ct:
        runs = timed_steps(step, st, batches, noise)
    n_flash = mesh.size * per_pass * DIST_INT8_STEPS
    check_flash_counts(ops, n_flash, "wgmma", "(b): the int8 dp steps")
    losses = [float(r) for _, r in runs]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"(b) int8 dp losses {losses}: the last is "
                             f"not below the first")
    step_ms = [ms for ms, _ in runs]
    b = {"mesh": mesh.shape, "losses": losses, "step ms": step_ms,
         "step ms (steps 2..)": sum(step_ms[1:]) / len(step_ms[1:]),
         "compression ms": ct.ms(), "flash launches": n_flash}
    b["compression ms (steps 2..)"] = sum(b["compression ms"][1:]) / len(
        b["compression ms"][1:])
    b["tokens/s"] = tokens / b["step ms (steps 2..)"] * 1e3
    t = time.perf_counter()
    b["profile"] = profile_device(
        lambda: step(st["params"], st["opt"], batches[0], 0, noise), reps=1,
        cpu=False)
    b["profile s"] = time.perf_counter() - t
    b["s"] = time.perf_counter() - t0
    del st
    gc_collect()
    for what, r, ms in (("(a) 1 shard, none", a,
                         a["step ms (dp, second step)"]),
                        ("(b) 4 shards, int8", b, b["step ms (steps 2..)"])):
        print(f"dist dp step {what} ({DIST_ARCH} full width, "
              f"{TRAIN_BATCH} x {TRAIN_LEN} tokens, bf16, adamw): losses "
              f"{[round(v, 4) for v in r['losses']]}; step {ms:.3f} ms, "
              f"{tokens / ms * 1e3:.0f} tokens/s; profile span "
              f"{r['profile']['span_ms']:.3f} ms, busy "
              f"{ms3(r['profile']['device_busy_ms'])} ms, idle share "
              f"{ms3(r['profile']['device_idle_share'])} [{card_line()}]")
    print(f"  (a) make_train_step "
          f"{a['step ms (make_train_step, second step)']:.3f} ms beside; "
          f"params and adamw state bit for bit; compression (none) "
          f"{a['compression ms (none)']:.3f} ms; (b) compression (int8, "
          f"{mesh.size} shards) {b['compression ms (steps 2..)']:.3f} ms a "
          f"step by CUDA events; seconds (a) {a['s']:.1f} (profile "
          f"{a['profile s']:.1f}), (b) {b['s']:.1f} (profile "
          f"{b['profile s']:.1f})")
    return {"one shard": a, "int8": b}


def dist_pipeline(ops, model, stream) -> dict:
    """Step 24 (c): ``pipeline_apply`` of 6-layer qwen2-0.5b stages over a
    4-stage ("pipe",) mesh, 8 microbatches of 1 x 2048, bf16."""
    from repro_torch.dist.pipeline import pipeline_apply, serial_reference
    from repro_torch.dist.sharding import Mesh, cast_for_compute, tree_map
    from repro_torch.layers.linear import XbarMode
    from repro_torch.models.lm import block_apply, embed_inputs
    cfg = model.cfg
    bf16 = torch.bfloat16
    per_stage = cfg.n_layers // PIPE_STAGES
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    stages = tree_map(lambda a: a.reshape((PIPE_STAGES, per_stage)
                                          + tuple(a.shape[1:])),
                      params["stack"])
    xbar = XbarMode.from_config(cfg)
    positions = torch.arange(TRAIN_LEN, device="cuda")[None, :]

    def stage(p, h):
        """The stage's layers, one (1, 2048, d) microbatch at a time."""
        if h.dim() == 4:
            return torch.stack([stage(p, hi) for hi in h])
        for i in range(per_stage):
            pi = cast_for_compute(tree_map(lambda a: a[i], p), bf16)
            h, _, _ = block_apply(cfg, "attn", pi["b0_attn"], h,
                                  positions=positions, cache=None,
                                  xbar=xbar, compute_dtype=bf16)
        return h

    with torch.no_grad():
        tokens = torch.cat([stream.batch_at(s)["tokens"]
                            for s in range(PIPE_MICRO // TRAIN_BATCH)])
        x = embed_inputs(cfg, params, {"tokens": tokens.cuda()}, bf16)
        x = x.reshape(PIPE_MICRO, 1, TRAIN_LEN, cfg.d_model)
        mesh = Mesh((PIPE_STAGES,), ("pipe",), "cuda")
        zero_flash_counts(ops)
        got = pipeline_apply(stage, stages, x, mesh=mesh, axis_name="pipe")
        n_pipe = (PIPE_MICRO + PIPE_STAGES - 1) * cfg.n_layers
        check_flash_counts(ops, n_pipe, "wgmma", "(c) pipeline_apply")
        zero_flash_counts(ops)
        want = serial_reference(stage, stages, x)
        n_serial = PIPE_MICRO * cfg.n_layers
        check_flash_counts(ops, n_serial, "wgmma", "(c) serial_reference")
        if not torch.isfinite(got.float()).all():
            raise AssertionError("(c) pipeline output not finite")
        if not torch.equal(got, want):
            raise AssertionError(
                f"(c) pipeline_apply differs from serial_reference by up to "
                f"{float((got.float() - want.float()).abs().max())}")
        pipe_ms = cuda_ms(lambda: pipeline_apply(stage, stages, x, mesh=mesh,
                                                 axis_name="pipe"),
                          iters=2, warmup=0)
        serial_ms = cuda_ms(lambda: serial_reference(stage, stages, x),
                            iters=2, warmup=0)
        prof = profile_device(lambda: pipeline_apply(
            stage, stages, x, mesh=mesh, axis_name="pipe"), reps=1,
            cpu=False)
    out = {"stages": PIPE_STAGES, "layers a stage": per_stage,
           "microbatches": PIPE_MICRO, "flash launches (pipeline)": n_pipe,
           "flash launches (serial)": n_serial, "bit for bit": True,
           "pipeline ms": pipe_ms, "serial ms": serial_ms,
           "tokens/s (pipeline)": PIPE_MICRO * TRAIN_LEN / pipe_ms * 1e3,
           "profile": prof}
    print(f"dist pipeline ({DIST_ARCH}: {PIPE_STAGES} stages of {per_stage} "
          f"layers, {PIPE_MICRO} microbatches of 1 x {TRAIN_LEN}, bf16): "
          f"{n_pipe} flash launches ((8 + 4 - 1) x 24), serial {n_serial}; "
          f"equal to serial_reference bit for bit; pipeline {pipe_ms:.3f} "
          f"ms, serial {serial_ms:.3f} ms; profile span "
          f"{prof['span_ms']:.3f} ms, busy {ms3(prof['device_busy_ms'])} "
          f"ms, idle share {ms3(prof['device_idle_share'])} "
          f"[{card_line()}]")
    return out


def dist_trainer(ops, cfg, stream) -> dict:
    """Step 24 (d): ``Trainer(mesh=make_host_mesh())`` against
    ``Trainer()``, then a restore onto the shardings and one more step."""
    import tempfile
    from repro_torch.dist.sharding import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import Trainer

    def trainer(**kw):
        return Trainer(cfg, launch_train_config(cfg, "adamw", DIST_STEPS + 1),
                       seed=SEED, **kw)

    per_pass = 2 * cfg.n_layers
    zero_flash_counts(ops)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        meshed = trainer(mesh=make_host_mesh(), ckpt_dir=d,
                         ckpt_every=DIST_STEPS)
        m_state, m_hist = meshed.run(stream, DIST_STEPS, log_every=1)
        plain = trainer(device="cuda")
        u_state, u_hist = plain.run(stream, DIST_STEPS, log_every=1)
        trees_equal(m_state.params, u_state.params, "(d) meshed Trainer "
                    "params vs Trainer()'s")
        trees_equal(m_state.opt_state, u_state.opt_state, "(d) meshed "
                    "Trainer adamw state vs Trainer()'s")
        if [h["loss"] for h in m_hist] != [h["loss"] for h in u_hist]:
            raise AssertionError("(d) meshed losses differ")
        del m_state, meshed
        gc_collect()
        resumed = trainer(mesh=make_host_mesh(), ckpt_dir=d,
                          ckpt_every=DIST_STEPS)
        r_state, r_hist = resumed.run(stream, DIST_STEPS + 1, log_every=1)
    if [h["step"] for h in r_hist] != [DIST_STEPS + 1]:
        raise AssertionError(f"(d) resumed at {r_hist}")
    if any(t.device.type != "cuda" for t in tree_leaves(
            (r_state.params, r_state.opt_state))):
        raise AssertionError("(d) a restored leaf is not on the card")
    batch = tree_map(lambda a: a.to("cuda"), stream.batch_at(DIST_STEPS))
    params, opt_state, metrics = plain.train_step(
        u_state.params, u_state.opt_state, batch, DIST_STEPS)
    trees_equal(r_state.params, params, "(d) resumed step params vs the "
                "uninterrupted run's")
    trees_equal(r_state.opt_state, opt_state, "(d) resumed adamw state vs "
                "the uninterrupted run's")
    if r_hist[-1]["loss"] != float(metrics["loss"]):
        raise AssertionError("(d) resumed loss differs")
    n_flash = per_pass * (2 * DIST_STEPS + 2)
    check_flash_counts(ops, n_flash, "wgmma", "(d) the Trainer runs")
    out = {"losses": [h["loss"] for h in u_hist] + [r_hist[-1]["loss"]],
           "meshed == unmeshed, 2 steps, bit for bit": True,
           "restored onto shardings, resumed step bit for bit": True,
           "flash launches": n_flash, "s": time.perf_counter() - t0}
    print(f"dist trainer ({DIST_ARCH} full width, {TRAIN_BATCH} x "
          f"{TRAIN_LEN}, adamw): Trainer(mesh=make_host_mesh()) == Trainer() "
          f"over {DIST_STEPS} steps bit for bit; checkpoint at step "
          f"{DIST_STEPS} restored onto the shardings, step "
          f"{DIST_STEPS + 1} bit for bit; losses "
          f"{[round(v, 4) for v in out['losses']]}; {out['s']:.1f} s")
    return out


def dist_cli() -> dict:
    """Step 24 (e): ``python -m repro_torch.launch.train --mesh host`` on
    the reduced config, on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         DIST_ARCH, "--reduced", "--mesh", "host", "--steps", "4",
         "--batch", "4", "--seq", "64"],
        capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    if p.returncode != 0 or not last.startswith("final step 4: loss "):
        raise AssertionError(f"--mesh host exited {p.returncode}: {last!r}"
                             f"\n{p.stderr[-2000:]}")
    out = {"last line": last, "s": time.perf_counter() - t0}
    print(f"dist cli (launch.train --arch {DIST_ARCH} --reduced --mesh host "
          f"on cuda): {last} ({out['s']:.1f} s)")
    return out


def dist_path(ops) -> dict:
    """The data-parallel step, the pipeline, the meshed Trainer and its
    restore, and the meshed CLI (module docstring, step 24)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    cfg = get_config(DIST_ARCH)
    model = build_model(cfg, "cuda")
    stream = TokenStream(cfg.vocab_size, TRAIN_LEN, TRAIN_BATCH, seed=SEED)
    out = {"part s": {}}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        out["part s"][name] = time.perf_counter() - t
        gc_collect()

    part("dp", dist_dp, ops, model, stream)
    part("pipeline", dist_pipeline, ops, model, stream)
    part("trainer", dist_trainer, ops, cfg, stream)
    part("cli", dist_cli)
    out["s"] = time.perf_counter() - t0
    print(f"dist path parts (s): " + json.dumps(out["part s"]))
    return out


# (T, M, K, N, fold, codes) of the autotuner's shapes (step 25 (a)): an
# eager mnist wave's first stage (its step's first stack too), the farm
# step's stacked first stage over 4 chips (4 x 6 cores at 4 x 1024, the
# chip axis folded), qwen2-0.5b's (4096, 896, 4864) projection in the
# crossbar kernel mode (one core, int8 error codes; the fused kernel
# holds at most 128 columns, so it is not tuned there)
AUTOTUNE_SHAPES = {
    "mnist wave, first stage": (6, 4096, 400, 100, None, False),
    "farm step, first stage, 4 chips": (6, 1024, 400, 100, 4, False),
    "qwen2-0.5b projection (4096, 896, 4864)": (1, 4096, 896, 4864, None,
                                                True),
}


def autotune_shape(ops, xbk, gen, T, M, K, N, fold, codes) -> dict:
    """Time every candidate tile of the forward, bwd, dw, pulse and (N <=
    128) the fused kernel through the wrappers with ``autotune=True``;
    hold the tuned tile's outputs to the decision-list tile's bit for bit
    and time both."""
    lead = (fold, T) if fold else (T,)
    x = uniform(lead + (M, K), -0.5, 0.5, gen)
    gp = uniform(lead + (K, N), 0.0, 1.0, gen)
    gm = uniform(lead + (K, N), 0.0, 1.0, gen)
    d = uniform(lead + (M, N), -0.05, 0.05, gen)
    scale = torch.full((), 0.05 / 127, device="cuda")
    if codes:
        d = torch.randint(-127, 128, lead + (M, N), generator=gen,
                          device="cuda", dtype=torch.int8)
    err = {"dy_scale": scale} if codes else {}
    flat = [t.reshape((-1,) + t.shape[-2:]) for t in (x, gp, gm, d)]
    Tf = flat[0].shape[0]
    if fold or T > 1:
        calls = {
            "crossbar_fwd": ("fwd_stacked", lambda: ops.crossbar_fwd_stacked(
                x, gp, gm, autotune=True)),
            "crossbar_bwd": ("bwd_stacked", lambda: ops.crossbar_bwd_stacked(
                d, gp, gm, autotune=True, **err)),
            "crossbar_dw": ("dw_stacked", lambda: ops.crossbar_dw_stacked(
                x, d, autotune=True, **err)),
            "pulse_update": ("pulse_stacked", lambda: ops.pulse_update_stacked(
                gp, gm, x, d, lr=LR, autotune=True)),
            "crossbar_train": ("train_stacked",
                               lambda: ops.crossbar_train_stacked(
                                   gp, gm, x, d, lr=LR, autotune=True,
                                   **err))}
    else:       # the LM projection: the 2-D wrappers crossbar_matmul takes
        calls = {
            "crossbar_fwd": ("fwd", lambda: ops.crossbar_fwd(
                x[0], gp[0], gm[0], activation=False, autotune=True)),
            "crossbar_bwd": ("bwd", lambda: ops.crossbar_bwd(
                d[0], gp[0], gm[0], autotune=True, **err)),
            "crossbar_dw": ("dw", lambda: ops.crossbar_dw(
                x[0], d[0], autotune=True, **err))}
    if codes:
        calls.pop("pulse_update", None)
    if N > xbk.MAX_N_TRAIN:
        calls.pop("crossbar_train", None)
    kernels = {
        "crossbar_fwd": lambda c: xbk.crossbar_fwd_kernel(
            flat[0], flat[1], flat[2], activation=False, tile=c[0]),
        "crossbar_bwd": lambda c: xbk.crossbar_bwd_kernel(
            flat[3], flat[1], flat[2], tile=c[0], run=c[1], **err),
        "crossbar_dw": lambda c: xbk.crossbar_dw_kernel(
            flat[0], flat[3], tile=c[0], **err),
        "pulse_update": lambda c: xbk.pulse_update_kernel(
            flat[1], flat[2], flat[0], flat[3], lr=LR, tile=c[0]),
        "crossbar_train": lambda c: xbk.crossbar_train_kernel(
            flat[1], flat[2], flat[0], flat[3], lr=LR, tile=c[0], **err)}
    out = {}
    for name, (op, call) in calls.items():
        call()
        d_bytes = 4 if name in ("crossbar_fwd", "pulse_update") \
            else flat[3].element_size()
        key = ((op, Tf, M, K, N, d_bytes) if fold is None
               else (op, fold, Tf, M, K, N, d_bytes))
        if key not in ops._TUNED_KEYS:
            raise AssertionError(f"autotune: {name} at {key} was not timed")
        tuned = ops._BLOCK_CACHE[key]
        default = ops.default_tile(op, Tf, M, K, N, d_bytes)
        a, b = kernels[name](default), kernels[name](tuned)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(u, v):
                raise AssertionError(f"autotune: {name} at {key}: tile "
                                     f"{tuned} differs from {default}")
        out[name] = {
            "op": op, "default": list(default), "tuned": list(tuned),
            "candidates": len(ops.tile_candidates(op, Tf, M, K, N,
                                                  d_bytes)),
            "default_ms": cuda_ms(lambda: kernels[name](default)),
            "tuned_ms": cuda_ms(lambda: kernels[name](tuned))}
    return out


def autotune_phase(ops, xbk, gen) -> dict:
    """Step 25 (a): the autotuner on the card, its table round trip."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp(prefix="autotune-")
    table = os.path.join(tmp, "autotune.json")
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = table
    try:
        ops._BLOCK_CACHE.clear()
        ops._TUNED_KEYS.clear()
        res = {what: autotune_shape(ops, xbk, gen, *shape)
               for what, shape in AUTOTUNE_SHAPES.items()}
        tuned = {k: ops._BLOCK_CACHE[k] for k in ops._TUNED_KEYS}
        with open(table) as f:
            saved = json.load(f)
        ops._BLOCK_CACHE.clear()
        ops._TUNED_KEYS.clear()
        n = ops.load_autotune_table()

        def no_timing(*_):
            raise AssertionError("autotune: a reloaded entry was re-timed")
        again = {k: ops.block_config(
            k[0], *k[-5:-1], d_bytes=k[-1],
            fold=k[1] if len(k) == 7 else None, autotune=True,
            time_fn=no_timing) for k in tuned}
        if n != len(tuned) or len(saved) != n or again != tuned:
            raise AssertionError(f"autotune table round trip: saved "
                                 f"{len(saved)}, loaded {n}, picks equal "
                                 f"{again == tuned}")
        res["table entries"] = n
    finally:
        del os.environ["REPRO_TORCH_AUTOTUNE_TABLE"]
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    return res


def dryrun_vs_card(ops, gen) -> dict:
    """Step 25 (b): the dry run's trace of qwen2-0.5b's prefill and adamw
    step at 4 x 2048 bf16 on a one-card mesh, held against the same cell
    run for real on the card."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun, roofline as rl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step
    total = torch.cuda.get_device_properties(0).total_memory
    if dryrun.HBM_PER_CHIP != total:
        raise AssertionError(f"dryrun.HBM_PER_CHIP {dryrun.HBM_PER_CHIP} != "
                             f"the card's total_memory {total}")
    cfg = get_config(LM_ARCH)
    mesh = make_host_mesh(device="cuda")
    rules = shd.make_rules(mesh)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    B, L = PREFILL_BATCH, PREFILL_LEN
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                           device="cuda", dtype=torch.int32)
    opt = adamw(3e-4)
    step = make_train_step(model, opt, grad_accum=cfg.grad_accum)
    state = {}

    def nbytes(*trees):
        return sum(t.nbytes for tree in trees for t in shd.tree_leaves(tree))

    def run_prefill():
        model.prefill_fn(params, {"tokens": tokens})

    def run_train():
        step(params, state["opt"], {"tokens": tokens, "labels": labels}, 0)

    out = {}
    for kind, run in (("prefill", run_prefill), ("train", run_train)):
        trace, secs = dryrun._lower_one(cfg, kind, L, B, mesh, rules)
        model_flops = rl.model_flops_estimate(cfg, kind, L, B)
        roof = rl.analyze(trace, mesh.size, model_flops)
        if kind == "train":
            state["opt"] = opt.init(params)
            held = nbytes(params, state["opt"]) + tokens.nbytes \
                + labels.nbytes + 4             # + the step scalar
        else:
            held = nbytes(params) + tokens.nbytes
        if trace["argument"] != held:
            raise AssertionError(f"dry run {kind}: memory.argument "
                                 f"{trace['argument']} != the {held} bytes "
                                 f"the run holds")
        run()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, iters=1 if kind == "train" else 3, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        if ms < roof.t_bound * 1e3:
            raise AssertionError(f"dry run {kind}: {ms:.3f} ms on the card "
                                 f"beats t_bound {roof.t_bound * 1e3:.3f}")
        if trace["flops"] < model_flops:
            raise AssertionError(f"dry run {kind}: traced FLOPs "
                                 f"{trace['flops']} < model FLOPs "
                                 f"{model_flops}")
        temp = trace["temp_bytes"] // mesh.size
        out[kind] = {
            "trace s": secs, "ms": ms, "t_bound ms": roof.t_bound * 1e3,
            "bottleneck": roof.bottleneck,
            "t_compute ms": roof.t_compute * 1e3,
            "t_memory ms": roof.t_memory * 1e3,
            "traced flops": trace["flops"], "model flops": model_flops,
            "useful_flops_ratio": roof.useful_flops_ratio,
            "traced bytes": trace["bytes"],
            "argument bytes (predicted = held)": trace["argument"],
            "predicted per-device bytes": trace["argument"] + temp
            + trace["output"] - trace["alias"],
            "memory_allocated before, bytes": before,
            "max_memory_allocated, bytes": peak}
    out["HBM_PER_CHIP"] = total
    del params, state
    gc_collect()
    return out


def analysis_path(ops, xbk, gen) -> dict:
    """The analysis tools and the autotuner on the card (module
    docstring, step 25)."""
    t = time.perf_counter()
    out = {"autotune": autotune_phase(ops, xbk, gen)}
    out["autotune s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["dry run"] = dryrun_vs_card(ops, gen)
    out["dry run s"] = time.perf_counter() - t
    return out


def profiled_kernels(fn, reps: int = 1, cpu: bool = True):
    """The device events of ``reps`` calls of ``fn`` under
    ``torch.profiler`` as ``key_averages`` rows, and the span of the calls
    in ms per call (CUDA events inside the profiled window, so profiler
    start-up is not counted; host-side profiling overhead is).  With
    ``cpu=False`` only the device's activity is recorded: no host-side
    operator events, whose processing takes most of a long profile.  A profile
    that records no device activity at all is taken once more; if that
    one records none either, the rows are None: the profiler does not see
    the card in this process, and what it would measure is reported as not
    measured."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU] * cpu
                     + [ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
        span_ms = start.elapsed_time(end) / reps
        rows = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        if rows:
            return rows, span_ms
    if not PROFILER_BLIND:
        PROFILER_BLIND.append(True)
        print("torch.profiler recorded no device activity in two profiles: "
              "device busy time and idle share are not measured in this "
              "run; kernel device times are taken with CUDA events")
    return None, span_ms


PROFILER_BLIND: list[bool] = []


def profile_device(fn, reps: int = 3, match: str | None = None,
                   cpu: bool = True) -> dict:
    """Device time per kernel over ``reps`` calls of ``fn``
    (``profiled_kernels``, host events too unless ``cpu`` is False), and
    the device's busy share of their span.  With ``match`` (a regular
    expression), also the device ms of the kernels whose names match.
    Where the profiler sees no device activity the times are None."""
    import re
    events, span_ms = profiled_kernels(fn, reps, cpu)
    if events is None:
        out = {"span_ms": span_ms, "device_busy_ms": None,
               "device_idle_share": None, "top": [],
               "profiler": "recorded no device activity"}
        if match is not None:
            out["matched_ms"] = None
        return out
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
         for e in events if e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    out = {"span_ms": span_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / span_ms,
           "top": [{"kernel": k[:70], "ms": ms, "per_call": n}
                   for k, ms, n in kernels[:8]]}
    if match is not None:
        out["matched_ms"] = sum(ms for k, ms, _ in kernels
                                if re.search(match, k))
    return out


def ms3(x: float | None) -> str:
    """``x`` to three decimals, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.3f}"


def replay_kernels(fn) -> dict[str, int] | None:
    """The port's kernels, by name and launch count, in one profiled call
    of ``fn`` (after one unprofiled call, so a compiled ``fn`` replays);
    None where the profiler sees no device activity."""
    import re
    events, _ = profiled_kernels(fn)
    if events is None:
        return None
    pattern = re.compile(r"::(" + "|".join(KERNELS) + r")[(<]")
    found: dict[str, int] = {}
    for e in events:
        m = pattern.search(e.key)
        if m:
            found[m.group(1)] = found.get(m.group(1), 0) + e.count
    return found


# -- the training steps as captured CUDA graphs (step 26) -------------------

GRAPH_STEPS = 3          # (a): steps held bit for bit, captured vs eager
GRAPH_TIMED = 2          # (d): steps timed by CUDA events in each mode
GRAPH_MOE_ARCH = "qwen3-moe-30b-a3b"
GRAPH_CASES = (
    # (case, arch, config overrides, optimizer, batch, length, resume)
    (LM_ARCH, LM_ARCH, {}, "adamw", TRAIN_BATCH, TRAIN_LEN, False),
    (f"{LM_ARCH} crossbar kernel mode", LM_ARCH,
     {"crossbar": True, "xbar_use_kernel": True}, "pulse_sgd", XB_BATCH,
     XB_LEN, False),
    (f"{GRAPH_MOE_ARCH} at 1 layer", GRAPH_MOE_ARCH, {"n_layers": 1},
     "adamw", 2, 1024, False),
    (SSM_ARCH, SSM_ARCH, {}, "adamw", TRAIN_BATCH, TRAIN_LEN, True),
)
PAPER_GRAPH_DIMS = [512] * 5     # four equal-shaped 512 x 512 layers
PAPER_GRAPH_BATCH = 256          # isolet_class's training batch (steps 15-17)
PAPER_GRAPH_STEPS = 5
PAPER_GRAPH_LR = 0.1


def metrics_vector(m: dict) -> torch.Tensor:
    """A step's metrics stacked in name order: one fp32 tensor, a copy out
    of a graph's output buffers."""
    return torch.stack([m[k].float() for k in sorted(m)])


def graph_counts(ops) -> dict[str, int]:
    return {"flash_attention": ops.flash_attention.launches,
            **{n: getattr(ops, n).launches for n in XB_NAMES}}


def graph_case(ops, name, arch, overrides, optimizer, B, S,
               resume) -> dict:
    """Step 26 (a), (b) and (d) for one configuration: a captured and an
    eager ``Trainer`` (``train_step = step.fn``) from seed 0 take
    GRAPH_STEPS steps of the launcher's optimizer on the same batches;
    after each, parameters, optimizer state and metrics are equal bit for
    bit.  With ``resume``, the captured run's state at step 2 is saved
    and a fresh ``Trainer`` restores it, captures again and its step 3
    equals the eager run's.  Then GRAPH_TIMED more steps of each by CUDA
    events, a profiled replay and the graph's pool."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.runtime import Trainer, TrainState
    cfg = get_config(arch, **overrides)
    stream = TokenStream(cfg.vocab_size, S, B, seed=SEED)
    t0 = time.perf_counter()
    ckpt = tempfile.TemporaryDirectory()

    def trainer(**kw):
        return Trainer(cfg, launch_train_config(cfg, optimizer, GRAPH_STEPS),
                       seed=SEED, device="cuda", **kw)

    cap, eag = trainer(ckpt_dir=ckpt.name), trainer()
    eag.train_step = eag.step.fn
    sc, se = cap.init_state(), eag.init_state()
    pc, oc, pe, oe = sc.params, sc.opt_state, se.params, se.opt_state
    torch.cuda.synchronize()
    zero_lm_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    by_mode = {"captured": {}, "eager": {}}
    for s in range(GRAPH_STEPS):
        batch = {k: v.cuda() for k, v in stream.batch_at(s).items()}
        c0 = graph_counts(ops)
        pc, oc, mc = cap.train_step(pc, oc, batch, s)
        mc = metrics_vector(mc)
        c1 = graph_counts(ops)
        pe, oe, me = eag.train_step(pe, oe, batch, s)
        losses.append(float(me["loss"]))
        me = metrics_vector(me)
        c2 = graph_counts(ops)
        for mode, a, b in (("captured", c0, c1), ("eager", c1, c2)):
            for k in a:
                by_mode[mode][k] = by_mode[mode].get(k, 0) + b[k] - a[k]
        what = f"(a) {name}, step {s + 1}"
        trees_equal(pc, pe, f"{what}: captured parameters vs eager")
        trees_equal(oc, oe, f"{what}: captured {optimizer} state vs eager")
        if not torch.equal(mc, me) or not torch.isfinite(mc).all():
            raise AssertionError(f"{what}: captured metrics {mc.tolist()} "
                                 f"vs eager {me.tolist()}")
        if resume and s == 1:
            cap.save(TrainState(pc, oc, 2))
    counts = graph_counts(ops)
    if cap.step.captures != 1 or by_mode["captured"] != by_mode["eager"]:
        raise AssertionError(f"(a) {name}: {cap.step.captures} captures, "
                             f"launches {by_mode}")
    out = {"steps": GRAPH_STEPS, "losses": losses,
           "captured == eager, bit for bit": True, "launches": counts,
           "captures": cap.step.captures,
           "peak GB (both trainers)": torch.cuda.max_memory_allocated()
           / 1e9}
    if resume:
        resumed = trainer(ckpt_dir=ckpt.name)
        r_state, r_hist = resumed.run(stream, GRAPH_STEPS, log_every=100)
        if [h["step"] for h in r_hist] != [GRAPH_STEPS]:
            raise AssertionError(f"(b) {name}: resumed at {r_hist}")
        trees_equal(r_state.params, pe, f"(b) {name}: resumed captured "
                    f"parameters vs eager")
        trees_equal(r_state.opt_state, oe, f"(b) {name}: resumed captured "
                    f"state vs eager")
        if resumed.step.captures != 1 or r_hist[-1]["loss"] != losses[-1]:
            raise AssertionError(f"(b) {name}: {resumed.step.captures} "
                                 f"captures, loss {r_hist[-1]['loss']} vs "
                                 f"{losses[-1]}")
        out["resumed from step 2: captures, step 3 bit for bit"] = 1
        del resumed, r_state
    ckpt.cleanup()
    batch = {k: v.cuda() for k, v in stream.batch_at(0).items()}
    ms_c = cuda_ms(lambda: cap.train_step(pc, oc, batch, GRAPH_STEPS),
                   iters=GRAPH_TIMED, warmup=0)
    ms_e = cuda_ms(lambda: eag.train_step(pe, oe, batch, GRAPH_STEPS),
                   iters=GRAPH_TIMED, warmup=0)
    prof = profile_device(lambda: cap.train_step(pc, oc, batch,
                                                 GRAPH_STEPS), reps=1)
    tokens = B * S
    out.update({
        "captured ms": ms_c, "eager ms": ms_e,
        "captured tokens/s": tokens / ms_c * 1e3,
        "eager tokens/s": tokens / ms_e * 1e3,
        "graph pool GB": cap.step.pool_bytes() / 1e9,
        "profile (one replay)": prof, "s": time.perf_counter() - t0})
    print(f"captured training step ({name}, {B} x {S}, {optimizer}): "
          f"captured == eager bit for bit over {GRAPH_STEPS} steps "
          f"(parameters, state, metrics), {cap.step.captures} capture"
          + ("; resumed from its step-2 checkpoint: 1 capture, step 3 bit "
             "for bit" if resume else "")
          + f"; launches {counts}; captured {ms_c:.3f} ms "
          f"({out['captured tokens/s']:.0f} tokens/s), eager {ms_e:.3f} ms "
          f"({out['eager tokens/s']:.0f} tokens/s); one replay busy "
          f"{ms3(prof['device_busy_ms'])} ms of {prof['span_ms']:.3f}, idle "
          f"share {ms3(prof['device_idle_share'])}; graph pool "
          f"{out['graph pool GB']:.3f} GB; peak {out['peak GB (both '
          f'trainers)']:.2f} GB [{card_line()}]")
    del cap, eag, pc, oc, pe, oe, sc, se
    gc_collect()
    return out


def stochastic_pulse_graph(ops) -> dict:
    """Step 26 (a'): pulse_sgd's stochastic rounding under capture, on the
    reduced qwen2-0.5b in crossbar mode: a ``TrainStep`` drawing from a
    CUDA generator registered with its graph against the eager step
    drawing from an equal generator, GRAPH_STEPS steps bit for bit.  Where
    the card's torch cannot register a generator with a graph, the
    ``TrainStep`` must refuse it (the stated limit)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import pulse_sgd
    from repro_torch.runtime import TrainStep, make_train_step
    cfg = get_reduced_config(LM_ARCH, crossbar=True)
    model = build_model(cfg, "cuda")
    opt = pulse_sgd(0.5)
    stream = TokenStream(cfg.vocab_size, 64, 4, seed=SEED)

    def fresh():
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        return params, opt.init(params)

    def draws():
        return torch.Generator(device="cuda").manual_seed(SEED + 7)
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        try:
            TrainStep(model, opt, generator=draws())
        except ValueError as e:
            print(f"stochastic pulse_sgd under capture: refused ({e})")
            return {"registered generator": False, "refused": True}
        raise AssertionError("a TrainStep took a generator it cannot "
                             "register")
    cap = TrainStep(model, opt, generator=draws())
    eager = make_train_step(model, opt, generator=draws())
    (pc, oc), (pe, oe) = fresh(), fresh()
    for s in range(GRAPH_STEPS):
        batch = {k: v.cuda() for k, v in stream.batch_at(s).items()}
        pc, oc, mc = cap(pc, oc, batch, s)
        pe, oe, me = eager(pe, oe, batch, s)
        trees_equal(pc, pe, f"(a') stochastic pulse_sgd, step {s + 1}: "
                    f"captured parameters vs eager")
        if not torch.equal(metrics_vector(mc), metrics_vector(me)):
            raise AssertionError(f"(a') step {s + 1}: metrics differ")
    nearest = make_train_step(model, opt)
    pn, on = fresh()
    for s in range(GRAPH_STEPS):
        batch = {k: v.cuda() for k, v in stream.batch_at(s).items()}
        pn, on, _ = nearest(pn, on, batch, s)
    same, _ = params_equal(pc, pn)
    if same or cap.captures != 1:
        raise AssertionError(f"(a') stochastic rounding drew nothing "
                             f"({cap.captures} captures)")
    print(f"stochastic pulse_sgd under capture (reduced {LM_ARCH}, crossbar "
          f"mode, a registered CUDA generator): captured == eager bit for "
          f"bit over {GRAPH_STEPS} steps, 1 capture; round-to-nearest "
          f"differs")
    return {"registered generator": True, "captured == eager": True}


def paper_graph(ops) -> dict:
    """Step 26 (c): ``make_paper_train_step(PAPER_SPEC, lr,
    use_kernel=True)`` captured against ``paper_backprop_step_scan`` run
    eagerly, PAPER_GRAPH_STEPS steps on equal-shaped stacked layers at a
    paper application's batch, stacks and errors bit for bit after each
    step; the counts at 0 before and read after (a step: 4 fwd, 4 bwd,
    4 pulse_update); then both timed."""
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core import crossbar as xb
    from repro_torch.runtime import make_paper_train_step
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dims = PAPER_GRAPH_DIMS
    layers = [xb.init_conductances(a, b, PAPER_SPEC, generator=gen)
              for a, b in zip(dims[:-1], dims[1:])]
    B, L = PAPER_GRAPH_BATCH, len(dims) - 1
    batches = [{"x": torch.rand((B, dims[0]), generator=gen, device="cuda"),
                "target": torch.rand((B, dims[-1]), generator=gen,
                                     device="cuda")}
               for _ in range(PAPER_GRAPH_STEPS)]
    cap_stack = xb.stack_layers(layers)
    eager_stack = {k: v.clone() for k, v in cap_stack.items()}
    step = make_paper_train_step(PAPER_SPEC, PAPER_GRAPH_LR, use_kernel=True)
    names = ("crossbar_fwd", "crossbar_bwd", "pulse_update")
    for n in names:
        getattr(ops, n).launches = 0
    for s, b in enumerate(batches):
        got, err = step(cap_stack, b)
        err = err.clone()
        _, want = xb.paper_backprop_step_scan(
            eager_stack, b["x"], b["target"], PAPER_SPEC, PAPER_GRAPH_LR,
            True)
        if got is not cap_stack or not torch.equal(err, want) or not all(
                torch.equal(cap_stack[k], eager_stack[k])
                for k in cap_stack):
            raise AssertionError(f"(c) paper scan step {s + 1}: captured "
                                 f"differs from eager")
    counts = {n: getattr(ops, n).launches for n in names}
    want = {n: 2 * L * PAPER_GRAPH_STEPS for n in names}
    if counts != want or step.captures != 1:
        raise AssertionError(f"(c) paper scan: {counts} launches (want "
                             f"{want}), {step.captures} captures")
    b = batches[0]
    ms_c = cuda_ms(lambda: step(cap_stack, b), iters=20, warmup=0)
    ms_e = cuda_ms(lambda: xb.paper_backprop_step_scan(
        eager_stack, b["x"], b["target"], PAPER_SPEC, PAPER_GRAPH_LR, True),
        iters=20, warmup=0)
    prof = profile_device(lambda: step(cap_stack, b), reps=1)
    graph = next(iter(step.graphs.values()))[0]
    out = {"layers": L, "batch": B, "steps": PAPER_GRAPH_STEPS,
           "captured == eager, bit for bit": True, "launches": counts,
           "captured ms": ms_c, "eager ms": ms_e,
           "captured samples/s": B / ms_c * 1e3,
           "eager samples/s": B / ms_e * 1e3,
           "graph pool GB": graph.pool_bytes() / 1e9,
           "profile (one replay)": prof}
    print(f"captured paper scan step ({L} layers of {dims[0]} x {dims[1]}, "
          f"batch {B}, PAPER_SPEC, use_kernel): captured == eager bit for "
          f"bit over {PAPER_GRAPH_STEPS} steps (stacks, errors), 1 capture, "
          f"launches {counts}; captured {ms_c:.4f} ms "
          f"({out['captured samples/s']:.0f} samples/s), eager {ms_e:.4f} "
          f"ms; one replay busy {ms3(prof['device_busy_ms'])} ms of "
          f"{prof['span_ms']:.3f}, idle share "
          f"{ms3(prof['device_idle_share'])}; graph pool "
          f"{out['graph pool GB']:.4f} GB [{card_line()}]")
    return out


def train_graph_path(ops) -> dict:
    """Step 26: the training steps as captured CUDA graphs (module
    docstring)."""
    out = {}
    for case in GRAPH_CASES:
        out[case[0]] = graph_case(ops, *case)
    out["stochastic pulse_sgd"] = stochastic_pulse_graph(ops)
    out["paper scan step"] = paper_graph(ops)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core import hw_model as hw
    from repro_torch.core.crossbar import mlp_forward, paper_backprop_step
    from repro_torch.kernels import _build, crossbar as xbk, kmeans as kmk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops
    from repro_torch.launch.chipsim import build_chip
    from repro_torch.sim import chip as chip_mod, cluster, fabric
    from repro_torch.sim import compiled as csim

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.load_all(list(KERNELS))
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s "
          f"wall (one nvcc each, in parallel)")
    for lib in libs:
        print(f"  {lib.path.name}: nvcc {lib.build_s:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    report = ptxas_report("\n".join(lib.log for lib in libs))
    print("ptxas, dw and pulse instances [registers, spill bytes, dynamic "
          "shared memory]: " + json.dumps(outer_product_ptxas(report)))
    print("ptxas, forward and fused instances [registers, spill bytes, "
          "dynamic shared memory (fused: N = 100, forward off)]: "
          + json.dumps(row_product_ptxas(report)))
    print("ptxas, bwd instances [registers, spill bytes, dynamic shared "
          "memory (dx_walk: N = 100)]: " + json.dumps(bwd_ptxas(report)))
    print("ptxas, k-means instances [registers, spill bytes, dynamic shared "
          "memory]: " + json.dumps(kmeans_ptxas(report)))

    phase_s = {"build": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    max_err, rows = kernel_phase(xbk, ops, gen)
    train_err, train_rows = train_kernel_phase(xbk, ops, gen)
    pins = outer_product_phase(xbk, gen)
    sweep = tile_sweep(xbk, gen)
    print(f"dw and pulse device ms by tile [{card}]: " + json.dumps(sweep))
    pins["fwd tiles"] = row_product_phase(xbk, gen)
    print(f"forward device ms by tile [{card}]: "
          + json.dumps(fwd_tile_sweep(xbk, gen)))
    pins["bwd tiles"] = bwd_pin_phase(xbk, ops, gen)
    print(f"bwd device ms by tile/run [{card}]: "
          + json.dumps(bwd_tile_sweep(xbk, gen)))
    fused_err, fused_rows = fused_kernel_phase(xbk, ops, gen)
    phase_s["kernel phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    km_flips, km_rows = kmeans_kernel_phase(kmk, ops, gen)
    host = wrapper_host_phase(xbk, ops, gen)
    print(f"wrapper host time [{card}]: " + json.dumps(host))
    phase_s["kmeans kernel phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fa_err, fa_rows = flash_kernel_phase(fak, ops, gen, report)
    phase_s["flash kernel phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("ptxas, flash instances at hd 256 (bf16, wgmma) and hd 129-256 "
          "(fp32) [registers, spill bytes, dynamic shared memory]: "
          + json.dumps({f"{dt} {sem}": [
              (i := flash_instance(report, getattr(torch, dt), 256, sem))[
                  "registers"], i["spill_stores"], i["dynamic_smem"]]
              for dt in ("bfloat16", "float32")
              for sem in ("chunked", "pallas")}))
    fw_err, fw_rows = flash_window_phase(fak, gen, report)
    phase_s["flash window phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fx_err, fx_rows = flash_cross_phase(fak, gen, report)
    phase_s["flash cross phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fv_err, fv_rows = flash_vlm_phase(fak, gen, report)
    phase_s["flash vlm phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- eager recognition path: the counts start at 0 and are read after
    mnist = build_chip("mnist_class", seed=SEED, device="cuda",
                       compiled=False)
    isolet = build_chip("isolet_class", seed=SEED, device="cuda",
                        compiled=False)
    x16 = uniform((16, 784), -0.5, 0.5, gen)
    x4096 = uniform((4096, 784), -0.5, 0.5, gen)
    x_iso = uniform((256, 617), -0.5, 0.5, gen)
    ops.crossbar_fwd_stacked.launches = 0
    ops.crossbar_fwd.launches = 0
    out16, _ = run_wave(mnist, x16, ops, 5)
    out4096, stream = run_wave(mnist, x4096, ops, 5)
    out_iso, stream_iso = run_wave(isolet, x_iso, ops, 9)
    launches = ops.crossbar_fwd_stacked.launches + ops.crossbar_fwd.launches
    print(f"eager recognition path: {launches} kernel launches (mnist 5 + "
          f"5, isolet 9)")

    # -- correctness of what came out
    flips = {
        "mnist x16": check_chip_wave(mnist, x16, out16, mlp_forward,
                                     PAPER_SPEC),
        "mnist x4096": check_chip_wave(mnist, x4096, out4096, mlp_forward,
                                       PAPER_SPEC),
        "isolet x256": check_chip_wave(isolet, x_iso, out_iso, mlp_forward,
                                       PAPER_SPEC),
        "mlp_forward(use_kernel) x16": check_mlp_kernel(
            mnist.layers(), x16, PAPER_SPEC, ops, mlp_forward),
        "mlp_forward(use_kernel) x4096": check_mlp_kernel(
            mnist.layers(), x4096, PAPER_SPEC, ops, mlp_forward),
    }
    print("held against plain (samples after a boundary code flip): "
          + json.dumps(flips))
    for chip in (mnist, isolet):
        cmp_ = check_report(chip, hw)
        print(f"{chip.name}: beat {chip.beat_us:.4f} us, hw_model rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    phase_s["eager recognition path"] = time.perf_counter() - t0

    # -- compiled recognition path
    t0 = time.perf_counter()
    rec_chips, rec_launches = compiled_recognition(
        ops, csim, build_chip, mlp_forward, hw,
        {"mnist_class": mnist, "isolet_class": isolet},
        [("mnist_class", x16, out16), ("mnist_class", x4096, out4096),
         ("isolet_class", x_iso, out_iso)])
    phase_s["compiled recognition path"] = time.perf_counter() - t0

    # -- training paths and crossbar_apply(use_kernel=True) path
    t0 = time.perf_counter()
    train_launches = train_path(ops, chip_mod, build_chip, PAPER_SPEC,
                                paper_backprop_step, hw, gen)
    phase_s["eager training path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctrain_launches = compiled_train_path(ops, csim, chip_mod, build_chip,
                                          PAPER_SPEC, hw, gen)
    phase_s["compiled training path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_launches, apply_err = apply_path(ops, mnist.layers(), PAPER_SPEC,
                                           gen)
    phase_s["crossbar_apply path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apps = paper_apps_path(ops)
    phase_s["paper-apps path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = lm_path(ops, xbk)
    phase_s["LM serving path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    faulted = faulted_chip_path(ops, csim, chip_mod, build_chip, PAPER_SPEC,
                                mlp_forward, paper_backprop_step, gen)
    phase_s["faulted chip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    farm_tr = farm_train_path(ops, csim, cluster, build_chip, gen)
    phase_s["farm training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    farm_sv = farm_serve_path(ops, csim, cluster, farm_tr.pop("farm"),
                              mlp_forward, PAPER_SPEC, gen)
    phase_s["farm serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe_tr = pipeline_train_path(ops, csim, fabric, build_chip, hw, gen)
    phase_s["pipeline training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe_sv = pipeline_serve_path(ops, csim, fabric, chip_mod,
                                  pipe_tr.pop("pipe"), mlp_forward,
                                  PAPER_SPEC, gen)
    phase_s["pipeline serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe_farm = pipeline_farm_path(ops, csim, fabric, build_chip, hw, gen)
    phase_s["pipeline farm"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- wave and step times (device events, after warm-up), compiled
    # beside eager in this one run
    t4096 = uniform((4096, 10), -0.5, 0.5, gen)
    t_iso = uniform((256, 26), -0.5, 0.5, gen)
    times = {}
    for mode, chips in (("eager", {"mnist_class": mnist,
                                   "isolet_class": isolet}),
                        ("compiled", rec_chips)):
        times[f"{mode} wave mnist_class x4096 ms"] = cuda_ms(
            lambda: chips["mnist_class"].infer(x4096, count=False), iters=10)
        times[f"{mode} wave isolet_class x256 ms"] = cuda_ms(
            lambda: chips["isolet_class"].infer(x_iso, count=False),
            iters=10)
    steppers = {
        mode: {app: build_chip(app, seed=SEED, device="cuda",
                               compiled=mode == "compiled")
               for app in ("mnist_class", "isolet_class")}
        for mode in ("eager", "compiled")}
    for mode, st in steppers.items():
        times[f"{mode} step mnist_class x4096 ms"] = cuda_ms(
            lambda: st["mnist_class"].train_step(x4096, t4096, lr=LR),
            iters=5, warmup=2)
        times[f"{mode} step isolet_class x256 ms"] = cuda_ms(
            lambda: st["isolet_class"].train_step(x_iso, t_iso, lr=LR),
            iters=5, warmup=2)
    t1 = time.perf_counter()
    mnist.infer_stream(x16)
    torch.cuda.synchronize()
    times["eager infer_stream mnist_class x16 host wall ms"] = \
        (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    rec_chips["mnist_class"].infer_stream(x16)
    torch.cuda.synchronize()
    times["compiled infer_stream mnist_class x16 host wall ms"] = \
        (time.perf_counter() - t1) * 1e3
    print(f"times [{card}]: " + json.dumps(times))
    print(f"samples/s: mnist wave x4096 eager "
          f"{4096 / times['eager wave mnist_class x4096 ms'] * 1e3:.0f}, "
          f"compiled "
          f"{4096 / times['compiled wave mnist_class x4096 ms'] * 1e3:.0f};"
          f" mnist step x4096 eager "
          f"{4096 / times['eager step mnist_class x4096 ms'] * 1e3:.0f}, "
          f"compiled "
          f"{4096 / times['compiled step mnist_class x4096 ms'] * 1e3:.0f}")
    print("kernel shapes (M=4096): "
          + json.dumps(rows + train_rows + fused_rows))
    print(f"kmeans_assign shapes [{card}]: " + json.dumps(km_rows))
    print(f"flash_attention shapes [{card}]: " + json.dumps(fa_rows))
    print(f"LM serving path [{card}]: " + json.dumps(
        {k: v for k, v in lm.items() if k != "prefill"}, default=str))
    cstep = steppers["compiled"]["mnist_class"]
    kernels = replay_kernels(
        lambda: cstep.train_step(x4096, t4096, lr=LR))
    seen_by = "profiled"
    if kernels is None:
        # the profiler is blind: the wrappers' counts a replay adds, which
        # the graph's capture recorded from the launches it captured
        seen_by = "counted (profiler blind)"
        ops.crossbar_fwd_stacked.launches = 0
        ops.crossbar_train_stacked.launches = 0
        cstep.train_step(x4096, t4096, lr=LR)
        kernels = {"crossbar_fwd": ops.crossbar_fwd_stacked.launches,
                   "crossbar_train": ops.crossbar_train_stacked.launches}
    if kernels != {"crossbar_fwd": 4, "crossbar_train": 4}:
        raise AssertionError(f"a {seen_by} replay of the compiled mnist step "
                             f"ran the port's kernels {kernels}, expected "
                             f"4 crossbar_fwd + 4 crossbar_train")
    print(f"{seen_by} replay of one compiled mnist_class step: port kernels "
          + json.dumps(kernels))
    for what, fn in (
            ("eager mnist_class 4096-sample wave",
             lambda: mnist.infer(x4096, count=False)),
            ("compiled mnist_class 4096-sample wave",
             lambda: rec_chips["mnist_class"].infer(x4096, count=False)),
            ("eager mnist_class train_step at batch 4096",
             lambda: steppers["eager"]["mnist_class"].train_step(
                 x4096, t4096, lr=LR)),
            ("compiled mnist_class train_step at batch 4096",
             lambda: cstep.train_step(x4096, t4096, lr=LR))):
        print(f"profile, {what} (profiler on): "
              + json.dumps(profile_device(fn)))
    phase_s["timing and profiles"] = time.perf_counter() - t0

    # -- the LM training path (step 18), after the chip paths' timings and
    # profiles: its allocations and long profiles come last
    t0 = time.perf_counter()
    lm_train = lm_train_path(ops, xbk, fak)
    print(f"LM training path [{card}]: " + json.dumps(
        {part: {k: v for k, v in out.items() if k not in ("profile",
                                                           "rows")}
         for part, out in lm_train.items()}))
    phase_s["LM training path"] = time.perf_counter() - t0

    # -- the hybrid family (step 19): step 18's memory freed first, its
    # 42 GB of parameters allocated last of all
    t0 = time.perf_counter()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the hybrid path: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    hybrid = hybrid_path(ops)
    phase_s["hybrid path"] = time.perf_counter() - t0
    print(f"hybrid path [{card}], {phase_s['hybrid path']:.1f} s: "
          + json.dumps({part: ({k: v for k, v in out.items()
                                if "profile" not in k}
                               if isinstance(out, dict) else out)
                        for part, out in hybrid.items()}))

    # -- the MoE family (step 20): step 19's memory freed first, each
    # configuration's 42-43 GB of parameters freed before the next
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the moe path: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    moe_res = moe_path(ops)
    phase_s["moe path"] = time.perf_counter() - t0
    print(f"moe path [{card}], {phase_s['moe path']:.1f} s: " + json.dumps(
        {arch: {part: ({k: v for k, v in out.items() if "profile" not in k}
                       if isinstance(out, dict) else out)
                for part, out in res.items()}
         for arch, res in moe_res.items()}))

    # -- the SSM family (step 21): step 20's memory freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the ssm path: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    ssm = ssm_path(ops, xbk)
    phase_s["ssm path"] = time.perf_counter() - t0
    print(f"ssm path [{card}], {phase_s['ssm path']:.1f} s: " + json.dumps(
        {part: ({k: (v if not isinstance(v, dict) else
                     {kk: vv for kk, vv in v.items()
                      if "profile" not in kk and kk != "rows"})
                 for k, v in out.items()
                 if "profile" not in k and k != "rows"}
                if isinstance(out, dict) else out)
         for part, out in ssm.items()}))

    # -- the encoder-decoder family (step 22): step 21's memory freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the encdec path: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    encdec = encdec_path(ops, xbk)
    phase_s["encdec path"] = time.perf_counter() - t0
    print(f"encdec path [{card}], {phase_s['encdec path']:.1f} s: "
          + json.dumps(
              {part: ({k: (v if not isinstance(v, dict) else
                           {kk: vv for kk, vv in v.items()
                            if "profile" not in kk and kk != "rows"})
                       for k, v in out.items()
                       if "profile" not in k and k != "rows"}
                      if isinstance(out, dict) else out)
               for part, out in encdec.items()}))

    # -- the VLM family (step 23): step 22's memory freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the vlm path: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    vlm = vlm_path(ops, xbk)
    phase_s["vlm path"] = time.perf_counter() - t0
    print(f"vlm path [{card}], {phase_s['vlm path']:.1f} s: " + json.dumps(
        {part: ({k: (v if not isinstance(v, dict) else
                     {kk: vv for kk, vv in v.items()
                      if "profile" not in kk and kk != "rows"})
                 for k, v in out.items()
                 if "profile" not in k and k != "rows"}
                if isinstance(out, dict) else out)
         for part, out in vlm.items()}))

    # -- dist/ on one card (step 24): step 23's memory freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before the dist path: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    dist = dist_path(ops)
    phase_s["dist path"] = time.perf_counter() - t0
    print(f"dist path [{card}], {phase_s['dist path']:.1f} s: " + json.dumps(
        {part: ({k: v for k, v in out.items() if k != "profile"}
                if isinstance(out, dict) else out)
         for part, out in dist.items()}, default=str))

    # -- the analysis tools and the autotuner (step 25): step 24's memory
    # freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    analysis = analysis_path(ops, xbk, gen)
    phase_s["analysis path"] = time.perf_counter() - t0
    print(f"analysis path [{card}], {phase_s['analysis path']:.1f} s: "
          + json.dumps(analysis))

    # -- the training steps as captured CUDA graphs (step 26): step 25's
    # memory freed first
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    graphs_res = train_graph_path(ops)
    phase_s["train graph path"] = time.perf_counter() - t0
    print(f"train graph path [{card}], {phase_s['train graph path']:.1f} s: "
          + json.dumps({case: ({k: v for k, v in out.items()
                                if "profile" not in k}
                               if isinstance(out, dict) else out)
                        for case, out in graphs_res.items()}))

    fwd_rows = {(r["T"], r["K"], r["N"]): r for r in rows
                if r["app"] == "mnist_class"}
    by_kernel = {
        "crossbar_fwd": ([fwd_rows[s] for s in WAVE_SHAPES["mnist_class"]],
                         "the 5 launches of one eager mnist_class wave at "
                         "M=4096"),
        "crossbar_bwd": (step_rows(train_rows, "crossbar_bwd"),
                         "the 4 launches of one eager mnist_class training "
                         "step at M=4096"),
        "pulse_update": (step_rows(train_rows, "pulse_update"),
                         "the 4 launches of one eager mnist_class training "
                         "step at M=4096"),
        "crossbar_dw": ([r for r in train_rows if r.get("codes")
                         and r["kernel"] == "crossbar_dw"],
                        "the 4 launches of crossbar_apply(use_kernel=True)'s "
                        "backward through mnist's layers at M=4096, int8 "
                        "codes"),
        "crossbar_train": (step_rows(fused_rows, "crossbar_train"),
                           "the 4 launches of one compiled mnist_class "
                           "training step at M=4096"),
    }
    # the faulted chip's, the farm's and the farm server's launches
    farm_counted = {
        "crossbar_fwd": {"faulted chip": faulted["fwd"],
                         "farm training": farm_tr["fwd"],
                         "farm serving": farm_sv["fwd"]},
        "crossbar_bwd": {"faulted chip": faulted["bwd"],
                         "farm training": farm_tr["bwd"]},
        "crossbar_dw": {"farm training": farm_tr["dw"]},
        "pulse_update": {"faulted chip": faulted["pulse"]},
    }
    counted = {
        "crossbar_fwd": launches + train_launches["crossbar_fwd_stacked"]
        + apply_launches["crossbar_fwd"]
        + rec_launches["crossbar_fwd_stacked"]
        + ctrain_launches["crossbar_fwd_stacked"],
        "crossbar_bwd": train_launches["crossbar_bwd_stacked"]
        + apply_launches["crossbar_bwd"],
        "crossbar_dw": apply_launches["crossbar_dw"],
        "pulse_update": train_launches["pulse_update_stacked"],
        "crossbar_train": ctrain_launches["crossbar_train_stacked"],
    }
    # the pipeline fabric's launches: training (compiled, eager and the
    # ragged mnist split), serving (compiled and eager), the farm of
    # pipelines
    pipe_counted = {
        "crossbar_fwd": {"pipeline training": pipe_tr["fwd"],
                         "pipeline serving": pipe_sv["fwd"],
                         "pipeline farm": pipe_farm["fwd"]},
        "crossbar_bwd": {"pipeline training": pipe_tr["bwd"],
                         "pipeline farm": pipe_farm["bwd"]},
        "crossbar_dw": {"pipeline farm": pipe_farm["dw"]},
        "pulse_update": {"pipeline training": pipe_tr["pulse"]},
        "crossbar_train": {"pipeline training": pipe_tr["train"]},
    }
    # the LM training path's launches: the crossbar kernel mode at full
    # width and the reduced kernel-mode step held against the CPU
    lm_counted = {
        name: {"crossbar kernel mode (full width)":
               lm_train["crossbar"]["launches"][name],
               "card vs CPU (reduced)":
               lm_train["card vs cpu"]["launches"][name]}
        for name in XB_NAMES}
    # the kernel-mode decode's (step 11 (e)): the captured sessions, the
    # eager one and the profiled replays
    decode_counted = {
        "crossbar_fwd": {f"{LM_ARCH} crossbar kernel mode decode":
                         lm["decode kernel mode"]["launches in step 11 (e)"][
                             "crossbar_fwd"]}}
    # the MoE path's: the reduced kernel-mode training steps (step 20 (d))
    moe_counted = {
        name: {f"{arch} reduced, card vs CPU": res["reduced training"][
            "launches"][name] for arch, res in moe_res.items()}
        for name in XB_NAMES}
    # the SSM path's: the full-width kernel-mode steps (step 21 (c)) and
    # the reduced kernel-mode step held against the CPU (step 21 (d))
    ssm_counted = {
        name: {f"{SSM_ARCH} crossbar kernel mode (full width)":
               ssm["train"]["crossbar"]["launches"][name],
               f"{SSM_ARCH} reduced, card vs CPU":
               ssm["reduced training"]["launches"][name]}
        for name in XB_NAMES}
    # the encoder-decoder path's: the full-width kernel-mode steps (step 22
    # (c)) and the reduced kernel-mode step held against the CPU (22 (d))
    encdec_counted = {
        name: {f"{ENCDEC_ARCH} crossbar kernel mode (full width)":
               encdec["train"]["crossbar"]["launches"][name],
               f"{ENCDEC_ARCH} reduced, card vs CPU":
               encdec["reduced training"]["launches"][name]}
        for name in XB_NAMES}
    # the VLM path's: the full-width kernel-mode steps (step 23 (c)) and
    # the reduced kernel-mode step held against the CPU (step 23 (d))
    vlm_counted = {
        name: {f"{VLM_ARCH} crossbar kernel mode (full width, "
               f"{VLM_TRAIN_LAYERS} layer)":
               vlm["train"]["crossbar"]["launches"][name],
               f"{VLM_ARCH} reduced, card vs CPU":
               vlm["reduced training"]["launches"][name]}
        for name in XB_NAMES}
    # the training graphs' (step 26): qwen2-0.5b's kernel-mode steps,
    # captured and eager, and the paper scan step's, captured and eager
    graphs_counted = {
        name: {f"{LM_ARCH} crossbar kernel mode, captured and eager":
               graphs_res[f"{LM_ARCH} crossbar kernel mode"]["launches"][
                   name]}
        for name in XB_NAMES}
    for name in ("crossbar_fwd", "crossbar_bwd", "pulse_update"):
        graphs_counted.setdefault(name, {})[
            "paper scan step, captured and eager"] = graphs_res[
                "paper scan step"]["launches"][name]
    for name, paths in (*farm_counted.items(), *pipe_counted.items(),
                        *lm_counted.items(), *decode_counted.items(),
                        *moe_counted.items(),
                        *ssm_counted.items(), *encdec_counted.items(),
                        *vlm_counted.items(), *graphs_counted.items()):
        counted[name] += sum(paths.values())
    errs = {"crossbar_fwd": max_err, **train_err,
            "crossbar_train": fused_err}
    errs["crossbar_bwd"] = max(errs["crossbar_bwd"], apply_err)
    errs["crossbar_dw"] = max(errs["crossbar_dw"], apply_err)
    for name, err in (*farm_tr["errs"].items(),
                      *pipe_farm["errs"].items()):
        errs[name] = max(errs[name], err)
    # layer 0's launches of the crossbar-mode step are held relative to
    # sum |x||w|: their absolute errors, from the same checks, are not kept
    lm_rel_err = lm_train["crossbar"][
        "layer-0 launches vs plain, max |err| / sum |x||w|"]
    replaces = {"crossbar_fwd": 84, "crossbar_bwd": 145, "crossbar_dw": 207,
                "pulse_update": 403, "crossbar_train": 308}
    entries = []
    for name, (timed, what) in by_kernel.items():
        flop_ms = sum(bound(r["T"], r["M"], r["K"], r["N"], name,
                            1 if r.get("codes") else 4)[0] for r in timed)
        byte_ms = sum(bound(r["T"], r["M"], r["K"], r["N"], name,
                            1 if r.get("codes") else 4)[1] for r in timed)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/crossbar.py:{replaces[name]}",
            "launches": counted[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in timed),
            "timed": what,
        })
        entries[-1]["timed"] += (
            "; *_ms_device: the same launches by device time (a CUDA graph "
            "of 20 calls replayed), the kernel's and the library's, in sum "
            "and per launch")
        entries[-1].update(
            ms_device=sum(r["ms_device"] for r in timed),
            library_ms_device=sum(r["library_ms_device"] for r in timed),
            ms_device_per_launch=[r["ms_device"] for r in timed],
            library_ms_device_per_launch=[r["library_ms_device"]
                                          for r in timed])
        entries[-1]["timed"] += (
            "; tiles: the ROW_PRODUCT_TILES (fwd), CROSSBAR_BWD_TILES "
            "\"tile/run\" (bwd) or OUTER_PRODUCT_TILES (dw, pulse, the "
            "fused kernel's update walk) index each launch took; bit_pins: "
            "shapes of pins (a) and (b), (kernel, shape, tile) triples of dw "
            "and pulse, (shape, tile) pairs of fwd and (case, error type, "
            "tile, run) launches of bwd equal to the picked launch")
        entries[-1].update(tiles=[r["tile"] for r in timed], bit_pins=pins)
        if name == "crossbar_bwd":
            entries[-1]["host"] = {k: v for k, v in host.items()
                                   if k.startswith("bwd")}
            entries[-1]["apply_layers_int8"] = [
                {k: r[k] for k in ("K", "N", "ms", "ms_device", "plain_ms",
                                   "library_ms", "library_ms_device",
                                   "bound_ms", "tile")}
                for r in train_rows
                if r["kernel"] == "crossbar_bwd" and r.get("codes")]
        if name == "crossbar_train":
            entries[-1]["dx_runs"] = [r["dx_run"] for r in timed]
        entries[-1]["autotune"] = {
            what: res[name] for what, res in analysis["autotune"].items()
            if isinstance(res, dict) and name in res}
        if name in farm_counted:
            entries[-1]["launches_faults_and_farm"] = farm_counted[name]
        entries[-1]["launches_pipeline"] = pipe_counted[name]
        if name in moe_counted:
            entries[-1]["launches_moe"] = moe_counted[name]
        if name in graphs_counted:
            entries[-1]["launches_train_graphs"] = graphs_counted[name]
        if name in ssm_counted:
            entries[-1]["launches_ssm"] = ssm_counted[name]
            entries[-1]["ssm_train_layer0_rel_err"] = ssm["train"][
                "crossbar"]["layer-0 launches vs plain, max |err| / sum "
                "|x||w|"][name]
            entries[-1]["ssm_shapes"] = [
                {k: r[k] for k in ("M", "K", "N", "ms", "ms_device",
                                   "plain_ms", "library_ms",
                                   "library_ms_device", "bound_ms",
                                   "bound_by", "tile")}
                for r in ssm["train"]["crossbar"]["rows"]
                if r["kernel"] == name]
        if name in encdec_counted:
            entries[-1]["launches_encdec"] = encdec_counted[name]
            entries[-1]["encdec_train_layer0_rel_err"] = encdec["train"][
                "crossbar"]["layer-0 launches vs plain, max |err| / sum "
                "|x||w|"][name]
            entries[-1]["encdec_shapes"] = [
                {k: r[k] for k in ("M", "K", "N", "ms", "ms_device",
                                   "plain_ms", "library_ms",
                                   "library_ms_device", "bound_ms",
                                   "bound_by", "tile")}
                for r in encdec["train"]["crossbar"]["rows"]
                if r["kernel"] == name]
        if name in vlm_counted:
            entries[-1]["launches_vlm"] = vlm_counted[name]
            entries[-1]["vlm_train_layer0_rel_err"] = vlm["train"][
                "crossbar"]["layer-0 launches vs plain, max |err| / sum "
                "|x||w|"][name]
            entries[-1]["vlm_shapes"] = [
                {k: r[k] for k in ("M", "K", "N", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "tile")}
                for r in vlm["train"]["crossbar"]["rows"]
                if r["kernel"] == name]
        if name in decode_counted:
            dk = lm["decode kernel mode"]
            entries[-1]["launches_decode"] = decode_counted[name]
            entries[-1]["decode_launches_per_replay"] = dk[
                "crossbar_fwd launches per replay"]
            entries[-1]["decode_layer0_rel_err"] = dk[
                "layer-0 launches vs plain, max |err| / sum |x||w|"][name]
            entries[-1]["decode_shapes"] = [
                {k: r[k] for k in ("M", "K", "N", "in_bytes", "ms",
                                   "ms_device", "plain_ms", "library_ms",
                                   "library_ms_device", "bound_ms",
                                   "bound_by", "tile")}
                for r in dk["rows"] if r["kernel"] == name]
        if name in lm_counted:
            entries[-1]["launches_lm_train"] = lm_counted[name]
            entries[-1]["lm_train_layer0_rel_err"] = lm_rel_err[name]
            entries[-1]["lm_shapes"] = [
                {k: r[k] for k in ("M", "K", "N", "ms", "ms_device",
                                   "plain_ms", "library_ms",
                                   "library_ms_device", "bound_ms",
                                   "bound_by", "tile")}
                for r in lm_train["crossbar"]["rows"] if r["kernel"] == name]
    dw_entry = next(e for e in entries if e["name"] == "crossbar_dw")
    dw_entry["fp32_mnist_step_ms_device"] = [
        r["ms_device"] for r in step_rows(train_rows, "crossbar_dw")]
    dw_entry["farm_step_local_dw"] = farm_tr["local_dw"]
    km = km_rows[0]     # the clustering path's own shape
    entries.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans.py:26",
        "launches": apps["kmeans_assign launches"],
        "max_abs_err": km_flips + apps["near_tie_flips"],
        "ms": km["ms"], "plain_ms": km["plain_ms"],
        "bound_ms": km["bound_ms"], "bound_by": km["bound_by"],
        "library_ms": km["library_ms"], "ms_device": km["ms_device"],
        "library_ms_device": km["library_ms_device"], "tile": km["tile"],
        "ms_device_at_65536x128x128": next(
            r["ms_device"] for r in km_rows if r["d"] == r["k"] == 128),
        "host": {k: v for k, v in host.items() if k.startswith("kmeans")},
        "timed": "one ops.kmeans_assign call at the clustering path's "
                 "shape (n=2048, d=20, k=10), by CUDA events (host "
                 "included) and by device time (ms_device: a CUDA graph of "
                 "20 calls replayed); max_abs_err counts assignments that "
                 "differ from plain (near-ties only; every tile equals the "
                 "chain-order plain version exactly)"})
    def fa_row(dt, sem):    # the prefill path's own shape
        return next(r for r in fa_rows if r["case"].startswith(
            "qwen2-0.5b prefill") and r["dtype"] == dt
            and r["semantics"] == sem)
    lm_flash = {
        "flash_attention": {
            "standard steps": lm_train["standard"][
                "flash_attention launches"],
            "crossbar kernel mode steps": lm_train["crossbar"][
                "flash_attention launches"]},
        "flash_attention_simt": {
            "card vs CPU steps (reduced, float32)": lm_train[
                "card vs cpu"]["flash_attention launches"]}}
    # the hybrid path's launches (step 19), all with the window
    hybrid_flash = {
        "flash_attention": {
            f"{HYBRID_ARCH} prefill": hybrid["prefill"][
                "flash_attention launches"],
            "reduced prefill (bf16)": hybrid["reduced"]["bfloat16"][
                "flash launches (prefill, card)"]},
        "flash_attention_simt": {
            "reduced prefill (float32)": hybrid["reduced"]["float32"][
                "flash launches (prefill, card)"]}}
    # the MoE path's launches (step 20): the full-width prefills, and the
    # reduced float32 prefills and training steps on the fp32 kernel
    moe_flash = {
        "flash_attention": {
            f"{arch} prefill ({MOE_ARCHS[arch]} layers)": res["prefill"][
                "flash_attention launches"]
            for arch, res in moe_res.items()},
        "flash_attention_simt": {
            f"{arch} reduced, {part}": n
            for arch, res in moe_res.items()
            for part, n in (
                ("prefill (float32)", res["reduced serving"][
                    "flash launches (prefill, card)"]),
                ("training steps vs CPU", res["reduced training"][
                    "flash_attention launches"]))}}
    # the encoder-decoder path's launches (step 22): the bf16 prefill, the
    # encode that fills the served cross cache, the training steps; on the
    # fp32 kernel the float32 serving's encode and the reduced prefill and
    # training steps held against the CPU
    encdec_flash = {
        "flash_attention": {
            f"{ENCDEC_ARCH} prefill": encdec["prefill"][
                "flash_attention launches"],
            "encode for the served cross cache (bf16)": encdec["decode"][
                "bfloat16"]["flash launches (encode)"],
            "standard training steps": encdec["train"]["standard"]["flash"],
            "crossbar kernel mode steps": encdec["train"]["crossbar"][
                "flash"]},
        "flash_attention_simt": {
            "encode for the served cross cache (float32)": encdec[
                "decode"]["float32"]["flash launches (encode)"],
            "reduced prefill (float32)": encdec["reduced serving"][
                "flash launches (prefill, card)"],
            "reduced training steps vs CPU": encdec["reduced training"][
                "flash_attention launches"]}}
    # the VLM path's launches (step 23): the bf16 prefill at the cut
    # depth, the training steps; on the fp32 kernel the reduced float32
    # prefill and training steps held against the CPU
    vlm_flash = {
        "flash_attention": {
            f"{VLM_ARCH} prefill ({VLM_LAYERS} layers)": vlm["prefill"][
                "flash_attention launches"],
            "standard training steps": vlm["train"]["standard"]["flash"],
            "crossbar kernel mode steps": vlm["train"]["crossbar"][
                "flash"]},
        "flash_attention_simt": {
            "reduced prefill (float32)": vlm["reduced serving"][
                "flash launches (prefill, card)"],
            "reduced training steps vs CPU": vlm["reduced training"][
                "flash_attention launches"]}}
    # the dist path's launches (step 24): the one-shard dp step and the
    # train step beside it, the int8 dp steps, the pipeline and its serial
    # reference, the Trainer runs; all bf16
    dist_flash = {
        "flash_attention": {
            "dp step, one shard, and make_train_step (a)": dist["dp"][
                "one shard"]["flash launches"],
            "int8 dp steps, 4 shards (b)": dist["dp"]["int8"][
                "flash launches"],
            "pipeline_apply (c)": dist["pipeline"][
                "flash launches (pipeline)"],
            "serial_reference (c)": dist["pipeline"][
                "flash launches (serial)"],
            "meshed and unmeshed Trainer, resumed step (d)": dist[
                "trainer"]["flash launches"]},
        "flash_attention_simt": {}}
    # the training graphs' launches (step 26): each case's captured and
    # eager steps, all bf16
    graphs_flash = {
        "flash_attention": {
            f"{case}, captured and eager": res["launches"][
                "flash_attention"]
            for case, res in graphs_res.items()
            if "flash_attention" in res.get("launches", {})},
        "flash_attention_simt": {}}
    bwd_yard = lm_train["standard"]["attention backward yardsticks"]

    def fw_row(dt, case):
        return next(r for r in fw_rows if r["dtype"] == dt
                    and r["case"] == case and r["semantics"] == "chunked")
    for name, dt, source, launches, what in (
            ("flash_attention", "bfloat16", "flash_attention_tc.cu",
             lm["prefill"]["flash_attention launches"],
             "launches: the bf16 prefill path, one prefill_fn call (24, "
             "one per layer, all wgmma/chunked), and the LM training "
             "path (launches_lm_train: 24 a forward, 24 more recomputed "
             "under remat, all wgmma/chunked), and the hybrid path "
             "(launches_hybrid: recurrentgemma-9b's prefill, 12, one per "
             "local layer, and the reduced bf16 prefill, 2, all "
             "wgmma/chunked with the window), and the MoE path "
             "(launches_moe: one prefill of each MoE configuration, one "
             "launch a layer, all wgmma/chunked), and the encoder-decoder "
             "path (launches_encdec: seamless-m4t-medium's prefill, 36, "
             "the encode of its served cross cache, 12, and its training "
             "steps, 72 a step, all wgmma/chunked), and the VLM path "
             "(launches_vlm: qwen2-vl-72b's prefill at 8 layers, 8, and "
             "its 1-layer training steps, 2 a step, all wgmma/chunked), and "
             "the dist path (launches_dist: qwen2-0.5b's data-parallel, "
             "pipeline and meshed Trainer runs, all wgmma/chunked; the "
             "--mesh host CLI runs in a process of its own, not counted), "
             "and the training graphs (launches_train_graphs: each case's "
             "captured and eager steps, all wgmma/chunked)"),
            ("flash_attention_simt", "float32", "flash_attention.cu",
             lm["prefill fp32"]["flash_attention launches"],
             "launches: the float32 prefill path, one prefill_fn call (24, "
             "one per layer, all simt/chunked), the reduced float32 "
             "training steps held against the CPU (launches_lm_train) and "
             "the hybrid path's reduced float32 prefill (launches_hybrid: "
             "2, simt/chunked with the window) and the MoE path's reduced "
             "float32 prefills and training steps held against the CPU "
             "(launches_moe) and the encoder-decoder path's float32 "
             "encode, reduced prefill and training steps "
             "(launches_encdec) and the VLM path's reduced float32 "
             "prefill and training steps (launches_vlm)")):
        fa = fa_row(dt, "chunked")
        launches += sum(lm_flash[name].values())
        launches += sum(hybrid_flash[name].values())
        launches += sum(moe_flash[name].values())
        launches += sum(encdec_flash[name].values())
        launches += sum(vlm_flash[name].values())
        launches += sum(dist_flash[name].values())
        launches += sum(graphs_flash[name].values())
        qwen2_vl = next(r for r in fv_rows if r["dtype"] == dt
                        and r["semantics"] == "chunked")
        seamless = next(r for r in fx_rows if r["dtype"] == dt
                        and r["case"].startswith("seamless")
                        and r["semantics"] == "chunked")
        local = fw_row(dt, "recurrentgemma local layer"
                       + (", fp32" if dt == "float32" else ""))
        hd256 = fw_row(dt, "hd 256, no window"
                       + (", fp32" if dt == "float32" else ""))
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "launches": launches,
            "launches_serving_path": lm["flash_attention launches serving"],
            "max_abs_err": max(max(r["max_abs_err"],
                                   r.get("max_abs_err, 64-key plain", 0.0))
                               for r in fa_rows + fw_rows + fx_rows
                               + fv_rows if r["dtype"] == dt),
            "ms": fa["ms"], "plain_ms": fa["plain_ms"],
            "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
            "library_ms": fa["library_ms"],
            "pallas_ms": fa_row(dt, "pallas")["ms"],
            "launches_lm_train": lm_flash[name],
            "launches_hybrid": hybrid_flash[name],
            "launches_moe": moe_flash[name],
            "launches_ssm": {f"{SSM_ARCH} prefill, decode and training "
                             f"(attention-free)": 0},
            "launches_encdec": encdec_flash[name],
            "launches_vlm": vlm_flash[name],
            "launches_dist": dist_flash[name],
            "launches_train_graphs": graphs_flash[name],
            "vlm_prefill_shape": {k: qwen2_vl[k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "registers", "spill_stores")},
            "encdec_non_causal": {k: seamless[k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "registers", "spill_stores")},
            "non_causal_cases": [
                {k: r[k] for k in ("case", "B", "S", "Skv", "H", "K",
                                   "semantics", "max_abs_err", "ms",
                                   "plain_ms", "library_ms", "bound_ms")}
                for r in fx_rows if r["dtype"] == dt],
            "hybrid_local_layer": {k: local[k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "registers", "spill_stores")},
            "hd256_no_window": {k: hd256[k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "registers", "spill_stores")},
            "lm_train_backward_ms_per_layer": (
                lm_train["standard"]["attention backward ms per layer"]
                if dt == "bfloat16" else None),
            "lm_train_backward_bound_ms": (
                bwd_yard["bound ms"] if dt == "bfloat16" else None),
            "lm_train_backward_library_ms": (
                bwd_yard["library ms (SDPA backward)"]
                if dt == "bfloat16" else None),
            "timed": f"one launch at qwen2-0.5b's prefill shape (B=4, "
                     f"S=2048, H=14, K=2, hd=64, causal, {dt}) in "
                     f"chunked_attention's function (pallas_ms: the Pallas "
                     f"function); {what}; launches_serving_path: "
                     f"BatchedServer.generate, bf16 and fp32 (decode only, "
                     f"plain attention); bound: both products at the "
                     f"{'bf16 tensor-core' if dt == 'bfloat16' else 'fp32'}"
                     f" rate; library: scaled_dot_product_attention in "
                     f"{dt}; hybrid_local_layer: one launch at "
                     f"recurrentgemma-9b's local layer (B=2, S=4096, H=16, "
                     f"K=1, hd=256, window 2048, chunked), bound over the "
                     f"band's pairs, library SDPA with a boolean band mask "
                     f"and the kv heads expanded; hd256_no_window: (1, "
                     f"4096, 16 on 1, hd 256, causal, chunked); "
                     f"encdec_non_causal: seamless's bidirectional and "
                     f"cross-attention shape (4 x 2048 on 2048, 16 on 16, "
                     f"hd 64, non-causal, chunked); non_causal_cases: the "
                     f"flash cross phase's rows; vlm_prefill_shape: "
                     f"qwen2-vl's prefill shape (2 x 2048, 64 on 8, hd "
                     f"128, causal, chunked)"
                     + ("; lm_train_backward_bound_ms: five products at "
                        "the bf16 peak; lm_train_backward_library_ms: "
                        "SDPA's backward at (4, 2048, 14 on 2, hd 64)"
                        if dt == "bfloat16" else "")})
    print("phase seconds: " + json.dumps(
        {k: round(v, 2) for k, v in phase_s.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def step_rows(rows: list[dict], kernel: str) -> list[dict]:
    """The timing rows of one mnist_class training step's launches."""
    by_shape = {(r["T"], r["K"], r["N"]): r for r in rows
                if r["kernel"] == kernel and not r.get("codes")}
    return [by_shape[s] for s in TRAIN_SHAPES["mnist_class"]]


if __name__ == "__main__":
    sys.exit(main())
