#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

Run from the root of a checkout, on a machine with the card, ``nvcc`` and
PyTorch built for CUDA::

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit code):

1. Set-up: build the CUDA kernels from ``src/repro_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all started together),
   print the card's name and power limit, check that the footprints
   the planner and the schedules read agree with the launchers', and
   that ``ptxas`` reports no spills and no serialised ``wgmma`` for the
   builds that train recurrentgemma-9b (the RG-LRU scan's anchors and
   backward, flash attention's logsumexp at head_dim 256), for every
   build of the flash backward (its dK/dV kernel with 128-key tiles at
   head_dim 64 and 128, with 64-key tiles at 128 and 256; its dQ kernel
   at every head dim and tile height; D's rows; the splits' sum) and for
   the mLSTM backward's prep, gradient and gate kernels; its state pass
   (four builds, the forward scan's shape) is held to no serialised
   ``wgmma`` and prints its spills, as the mLSTM forward's serving and
   training builds do, which are not gated (the serving build spilled
   before the training build was added).
2. Kernels against their plain PyTorch versions, in bf16 at the serving
   paths' shapes: max |difference| against the stated tolerance, and each
   kernel's time (CUDA events, median of 20 launches, L2 flushed before
   each) beside its roofline bound, its plain version's time and, where
   one exists, the time of the one PyTorch call that computes the same
   function.  Each fused-MLP case prints its schedule (M tile, F slice,
   hidden chunk, ring stages, grid), checks two launches bit-identical,
   and times the other M-tile height and the unfused cuBLAS chain
   (``unfused_ms``, a yardstick the port never calls).  Each ``gemm``
   and ``gemm_act`` case prints the tile loop its schedule runs (``tma``,
   ``tma+splitk=N`` or ``mma.sync``) and, on the TMA route, its time at
   the other tile width.  ``gemm`` is held at the served projections and
   at granite-20b's down projection at M = 2048 and 128; ``gemm_act``
   is held at granite-20b's up projection (M = 2048 and 128), at the
   paper's ViT-B op and at a ragged shape; granite's whole MLP is timed
   through the fused-MLP kernel and through the partial schedule, beside
   the planner's modelled traffic for each.  Flash attention is held at
   llama's GQA 24/8 (T = 1024 and 200), granite's MQA 48/1 (T = 2048),
   recurrentgemma's MQA 16/1 at head_dim 256 with its 2048 window (T =
   4096 and 1024) and whisper-base's cross-attention (head_dim 64, 448
   queries over 1500 keys, not causal), each case printing its schedule
   (tile height, key tile, ring stages, grid) and its time at the other
   tile height.  The RG-LRU scan is held, h and its fp32 h_T, at
   recurrentgemma-9b's widest prefill (1, 4096, 4096), four slots at T =
   1024, a ragged (2, 1000, 4000) and the served buckets 128 and 2048,
   each with and without h0: each case prints its schedule (channel tile,
   chunk, grid) and its time at the other chunk length, and is checked
   bit for bit against ``chunked_model`` (the kernel's arithmetic in
   plain PyTorch) and against a second launch, and timed again in its
   training build, which also writes the unit anchors (``anchors_ms``).
   The RG-LRU backward is held (dx, da, dh0; dh ~ N(0, 1)) against
   ``ref.rg_lru_bwd`` at the train path's (1, 3072, 4096), (1, 4096,
   4096), (4, 1024, 4096), the ragged (2, 1000, 4000) and once with h0
   and a cotangent on h_T, each bit for bit against
   ``chunked_bwd_model`` and a second launch.  The mLSTM scan is held, h and
   its final fp32 state, at xlstm-1.3b's prefill (B = 1, H = 4, T = 2048,
   Dh = 1024, with and without state), four slots at T = 512, a ragged
   (2, 2, 1000, 128), and a right-padded scan whose state is taken below T
   against the unpadded scan's (bit for bit); each case prints its
   schedule (chunk length, ring stages, grids) and its time in the
   training build (``states_ms``), two launches are checked
   bit-identical, and each row keeps three bounds apart: the function's
   (which the kernel is held to), the work this design does (split-bf16
   products, the Q K^T scratch) and the step-by-step fp32 recurrence's.
   The mLSTM backward (``csrc/mlstm_bwd.cu``) is held against
   ``ref.mlstm_bwd`` on the kernel's own sides of the denominator's max
   (its saved ``den``: where the max's arguments tie within rounding the
   two scans may take different sides, whose gradients differ) (dq, dk,
   dv in bf16 by the rule above; di, df in fp32 within 1e-3 (max|plain|
   + |plain|)) on NaN-filled outputs at the train path's (16, 4, 128,
   1024), (4, 4, 512, 1024), (1, 4, 2048, 1024), a ragged (2, 2, 1000,
   128) and (1, 4, 600, 1024), two launches bit-identical (100 at (4, 4,
   512, 1024)), beside the function's bound, the bound with the saved states read once, the
   design's, and the training forward's time; each row prints its
   schedule (the state pass's grid and ring stages, the gradient grid)
   and is profiled by kernel with each call prepared as it is timed
   (prep, the state pass, the gradients, the gates), with the device's
   idle time between them and the host's time to enqueue a call.
   The flash forward is held where a causal window
   meets more queries than keys (Tq 128 over Tk 16 at head_dim 256,
   window 2; Tq 200 over Tk 64 at 128, window 17), at both tile
   heights.  The flash forward
   rows are timed again with the row logsumexp a training forward writes
   (``lse_ms``).  The flash backward kernels are held against
   ``ref.attention_bwd`` (dQ, dK, dV; dO ~ N(0, 1)) at llama's 24/8 at
   the train path's 2 x 1024, at T = 2048 with and without a 512 window,
   granite's MQA 48/1 at T = 2048, a ragged (2, 24/8, 1000),
   whisper-base's cross-attention and recurrentgemma-9b's MQA 16/1 at
   head_dim 256 (the train path's T = 3072 and T = 4096 with the 2048
   window, T = 1024 causal, a ragged T = 1000 with a 256 window), two
   launches bit-identical, each beside SDPA's backward; each row prints
   its schedule (the dK/dV kernel's key tile, ring stages, grid and
   splits, the dQ kernel's query tile, ring stages and grid, from
   ``kernels/flash_attention.py:bwd_schedule``); the train path's row is
   profiled by kernel (``kernels_ms``: D's rows, dK/dV, dQ, the splits'
   sum).
3. Serve llama3.2-3b at full width (28 layers, bf16, random weights from a
   seed) with ``ftl_mode='fused'`` on the ``h100`` planning target: 8
   requests, 4 slots, paged KV.  The launch counters are set to 0 just
   before this run and read just after; every kernel of the path must
   have launched and must show in the profiler's device-kernel list.  A
   second, unprofiled run gives the serving times.
4. llama3.2-3b's served path against the plain path: one 256-token prompt
   prefilled with ``ftl_mode='fused'`` and ``'off'``.
4a. Serve qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed
   experts of 1408 top-4 and a 5632-wide shared MLP in each, bf16,
   14,315,735,040 random parameters from a seed, loaded after
   llama3.2-3b's are freed) with ``ftl_mode='fused'``: 8 requests of
   128-960 tokens, 4 slots, paged KV, ``max_seq`` 1024.  Every prefill
   launches flash attention 24 times (MHA 16/16), every prefill and
   every decode step the fused MLP 24 times (the shared experts, at M =
   the bucket or the 4 slots); the routed experts are batched einsums,
   the projections plain matmuls, so ``gemm`` must not launch, and the
   plan (reported, with ``cuda_gemm`` bound) is not executed.
4b. qwen2-moe-a2.7b's checks: on a 512-token prompt, every layer on the
   plain stream's own input served against plain (the same routing; the
   attention's and the MoE's deltas, without the residual, within phase
   2's rule); then ``forward`` end to end routed freely, each layer's
   routing recorded and the (token, slot) pairs that differ held to a
   share set before the first run, and routed as the plain path chose,
   the logits of all 512 tokens compared; the engine's greedy tokens for
   a 1,000-token prompt (bucket 1024, the same capacity, 88 slots an
   expert, as the prompt's own) against the model's own loop on the
   unpadded prompt and on the padded bucket.
5. Serve recurrentgemma-9b at full width (38 layers, bf16, random weights
   from a seed) the same way: 8 requests of 128-3072 tokens, 4 slots,
   dense per-slot cache, ``max_seq`` 4096.  Its path runs four kernels:
   the RG-LRU scan in every recurrent layer's prefill (26 launches a
   prefill, checked), flash attention at
   head_dim 256 in every local layer's prefill, the fused MLP in both
   phases, and the GEMM in ``execute_block_plan``.
6. recurrentgemma-9b's served path against the plain path (a 2,500-token
   prefill, fused against ``'off'``) and the engine against the model:
   the engine's first 8 greedy tokens for a 2,500-token prompt (bucket
   4096, past the 2048 window) equal the model's own ``prefill`` +
   ``decode_step`` loop on the unpadded prompt.
7. Serve granite-20b at full width (52 layers, bf16, 40.6 GB of random
   weights from a seed, loaded after recurrentgemma-9b's are freed) the
   same way with ``ftl_mode='auto'``: 8 requests of 128-1920 tokens,
   4 slots, paged KV, ``max_seq`` 2048.  The planner's ``partial`` MLP
   schedule binds ``cuda_partial_mlp``, so every prefill runs
   ``gemm_act`` (the up projection) and ``gemm`` (the down projection),
   and flash attention at MQA 48/1.
8. granite-20b's served path against the plain path: a 256-token
   prefill, ``'auto'`` against ``'off'``.
9. Serve xlstm-1.3b at full width, its depth cut to 24 layers = 3 x (7
   mLSTM + 1 sLSTM) to keep the script's time (its sLSTM's Python loop
   and the profiler's tally of its kernels took a third of it at 48;
   phase 13 trains all 48), bf16, 2.2 GB of random weights from a seed,
   loaded after granite-20b's are freed, the same way: 8 requests of
   128-1920 tokens, 4 slots, a dense per-slot state of 353 MB a slot,
   ``max_seq`` 2048.  No block is plannable; every mLSTM layer's prefill
   runs the mLSTM kernel with its final state (21 launches a prefill).
10. xlstm-1.3b's checks (with ``ftl_mode='off'`` a served-against-plain
   prefill would run the same kernel on both sides): end to end on the
   stack's first period (7 mLSTM + 1 sLSTM layers, the served weights),
   ``prefill`` (the kernel with state) + 4 ``decode_step``s (the plain
   recurrence) against the stateless ``forward`` (the kernel without);
   every layer of the 24 on the forward's own inputs, the block with
   state and 4 decode steps against the block without, and the state at a
   length below T against the unpadded state; the engine's greedy tokens
   for a 1,000-token prompt (bucket 1024) against the model's own loop on
   the unpadded prompt and on the padded bucket; one ``forward`` on a
   2 x 2048 batch, timed.  The end-to-end difference on all 24 layers and
   the residual streams of two forwards of different length are printed,
   not gated: the random-weight stack carries a difference 1.3-1.9 times
   further each layer, in the JAX reference as in the port
   (``tests/test_torch_xlstm_growth.py``), so GEMMs of other shapes part
   by O(1) logits after 24 layers.
10a. Serve whisper-base at full width and depth (6 encoder + 6 decoder
   layers, bf16, 97,250,304 random parameters from a seed, loaded after
   xlstm-1.3b's are freed) with ``ftl_mode='auto'``: 8 requests with
   decoder prompts of 4-224 tokens, 4 slots, a dense cache (``self`` KV
   of ``max_seq`` 448, whisper's decoder context, and the ``cross`` K and
   V of the 1500 frames), one (1, 1500, 512) N(0, 1) frame set from a
   numpy seed shared by every request as the engine's ``extras``.  The
   MLP bindings are printed: the decoder's at M = 1 and every bucket bind
   ``cuda_partial_mlp``; the encoder's at M = 1500 binds
   ``torch_unfused_mlp`` on the ``h100`` target, so it runs no kernel.
   From them every prefill launches flash attention 18 times (6 encoder
   layers, 6 decoder self- and 6 cross-attentions) and ``gemm_act`` and
   ``gemm`` 6 times each, every decode step ``gemm_act`` and ``gemm`` 6
   times and flash none (a decode step's attention, the cross-attention's
   too, is the plain masked attention, as in the reference).  The model
   plans no encoder-decoder block, so the block plan is not executed.
10b. whisper-base's checks, by phase 2's rule against the plain path
   (``ftl_mode='off'`` with ``ops.attention``'s plain version) on a
   200-token prompt: the encoder's output; each encoder and decoder
   layer's attention (the decoder's self- and cross-attention) and MLP
   deltas, without the residual, on the plain stream's own input.  The
   prefill's logits are held by ``_logits_agree``, as every served
   path's (by phase 2's rule they read 1.27 of it on the card).  Then the
   engine's greedy tokens for the 200-token prompt (bucket 256) against
   the model's own loop on the unpadded prompt and on the padded bucket
   (each engine slot decodes at its own position; the reference's engine
   decodes encoder-decoder slots at the largest one).
10c. Serve llama-3.2-vision-90b at full width, its depth cut to 10
   layers (two periods of 4 self-attention + 1 cross-attention layers;
   10,657,898,498 parameters, 21.3 GB of bf16, loaded after whisper's are
   freed), ``ftl_mode='fused'``: 8 requests of 128-960 tokens, 4 slots, a
   dense cache (cross layers cannot page), ``max_seq`` 1024, one (1, 1600,
   8192) N(0, 1) image-embedding set from a seed as ``extras``.  Every
   cross layer's ``xgate`` is set to 1.0 for the whole phase: at the
   reference's zero init ``tanh(0) o = 0`` would hide any
   cross-attention fault from every check.  Every prefill launches flash
   attention 10 times (8 causal self-attentions, 2 cross-attentions over
   the 1600 image tokens), every prefill and decode step the fused MLP 10
   times, and the serving run launches no ``gemm`` (its projections are
   plain matmuls; the block plan's execution launches it apart).
10d. The VLM's checks: each cross layer's ungated output on the plain
   stream's own input, the flash kernel's against the plain attention's,
   by phase 2's rule; a 256-token prefill's logits against the plain
   path's; the engine's greedy tokens for a 200-token prompt against the
   model's own loop on the unpadded prompt and on the padded bucket.
11. Train llama3.2-3b at full width (3,212,749,824 parameters, bf16
   weights, fp32 AdamW moments, random weights from a seed, loaded after
   xlstm-1.3b's are freed) through ``repro_torch.launch.train.build``: 4
   steps of 4 x 1024 bigram tokens in 2 microbatches, ``cfg.remat`` on,
   ``ftl_mode='off'`` (projections and MLP are ``torch.matmul``; the
   attention core is the flash kernel and its backward).  The launch
   counters are set to 0 just before the run and read just after: 2 x 28
   x 2 forward launches a step (remat runs each layer's forward again),
   28 x 2 backward launches, no other kernel.  Losses and gradient norms
   must be finite.  Then one profiled step (device busy share), one
   microbatch's gradients through the kernels against the plain
   Function's (``backend='ref'``), leaf by leaf within
   2e-2 relative, and a step under ``ftl_mode='fused'``, which must raise
   (the fused MLP and the GEMM have no backward kernel yet).
12. Train recurrentgemma-9b at full width the same way, after llama's
   state is freed, its depth cut to 6 layers (two periods of rec, rec,
   local; 3,410,153,472 parameters): 4 steps of 2 x 3072 tokens in 2
   microbatches.  A step launches the flash forward 2 x 2 x 2 times and
   its backward 2 x 2 times (head_dim 256, MQA 16/1, window 2048), the
   RG-LRU forward 2 x 4 x 2 times and its backward 4 x 2 times, and no
   other kernel; the gradient check forces both ``ops.attention`` and
   ``ops.rg_lru`` to ``backend='ref'``.
13. Train xlstm-1.3b at full width and depth the same way (48 layers, 42
   mLSTM and 6 sLSTM, 1,944,285,520 parameters, ``mlstm_chunk`` 64): 4
   steps of 32 x 128 tokens in 2 microbatches (T cut from 512: the
   sLSTM's Python loop took 32 s a step there).  A step launches the
   mLSTM scan's training build 42 x 2 x 2 times and its backward 42 x 2
   times, and no other kernel.  The gradient check forces ``ops.mlstm``
   to ``backend='ref'`` (the chunked plain scan, checkpointed, under
   autograd) layer by layer, on each mLSTM layer's own input and a
   random cotangent (the random-weight stack carries a difference
   1.3-1.9 times further each layer, so a whole-stack comparison parts
   by the loss itself): every leaf and the scan's own gradients at the
   initial weights, the scans' after the steps (whose leaves, through
   the bf16 block's ill-conditioned backward, are printed).  xLSTM plans
   no block, so no step under ``ftl_mode='fused'`` is tried.
14. Planner tooling on the card (``repro_torch.calib``, ``sim``,
   ``tune``, ``obs``), with llama3.2-3b at full width: (a)
   ``calib.microbench_sweep`` on the ``h100`` preset in bf16 (GEMMs
   through the GEMM kernel at the served projections' shapes and 4096^3,
   each launching it; activations; in-place copy-throughs of buffers the
   preset homes whole in its L2 or whole in HBM; every row's sample is
   ``calib.measure.CUDA_CALLS_PER_SAMPLE`` calls in one CUDA graph
   replay), then ``calibrate``: every
   fitted constant beside the preset's, each rate finite, positive and
   within 5% of its datasheet peak; (b) ``calib.measure_block`` of the
   full-width block at 1024 tokens (``ftl_mode='fused'``, the kernels),
   held out of the fit and printed with its modeled/measured ratio on
   the preset and on the fit, then the base and calibrated geomeans and
   ``drift_gate``'s verdict; (c) ``plan_block`` of the full-width block
   at 64 tokens with ``autotune=AutotuneConfig()`` (cuts, tiles, depths,
   analytic and simulated runtimes), every stage bound to a CUDA
   executor under ``'fused'`` (under ``'auto'`` a gated MLP planned
   ``partial`` must raise), run through ``run_block`` with the launch
   counters from 0 and held against the plain block by phase 2's rule;
   (d) ``serve.main`` in-process (4 requests of 100-200 tokens, 33 new
   each, ``max_seq`` 256, the weights of phase 3's seed) with ``--obs
   --obs-trace --obs-metrics --trace``: the counters from 0 before it,
   the block plan's execution (the drift probe, which runs the block's
   projections on ``gemm``) and the warm-up counted apart from the
   serving run, flash attention and the fused MLP launched in the
   serving run, ``gemm`` in the probe; both traces parse and hold the
   modeled lane (pid 0) and live ``serve:*`` spans (pid 1); the
   Prometheus decode-step count equals ``stats['decode_steps']``; the
   drift status is finite, and the full-width block's drift ratio is
   printed on the preset and on the fit.  It ends with ``obs.disable()``
   and the metrics registry cleared.
15. The distributed layer on the one card (``repro_torch.distributed``,
   ``launch/mesh.py``): (a) a one-rank NCCL group and a 1 x 1 ``data`` x
   ``model`` mesh, its backend printed; (b) llama3.2-3b at full width:
   ``init_train_state(..., mesh=)`` bit-identical leaf by leaf to the
   unsharded init of the same seed, then 2 x 256-token prefills and 8
   decode steps through ``make_prefill_step`` and ``make_decode_step``
   with the mesh under ``serving_ftl_mode`` (``"fused"``), their logits
   bit-identical to the mesh-less steps' with the same launches (flash
   and the fused MLP, counted from 0 before each run); (c) phase 11's
   trainer flags plus ``--mesh 1x1 --compress``: each step makes phase
   11's launches and no other, step 1's loss equals phase 11's bit for
   bit, losses and the error-feedback state's norm finite, the state not
   zero, the peak memory and step time printed beside phase 11's, and
   the EF pass (``compression.ef_compress_``) timed alone on the device
   beside its bound; (d) ``compressed_psum`` over the group equal to
   ``dequantize(quantize(x))`` for a (4096, 3072) bf16 tensor, and
   ``pipeline_forward`` over a one-stage ``pipe`` mesh (8 ``tanh(a @
   w)`` layers at d = 3072, 4 microbatches) equal to the sequential
   chain, both bit for bit.  The group is destroyed at the end.  (e)
   The tensor-parallel path as one rank of a 1 x 4 ``data`` x ``model``
   mesh over a fake process group on the card (``launch.dryrun.
   fake_mesh`` on ``"cuda"``): llama3.2-3b at full width, its weights the
   rank's ``model`` shards, two train steps of 4 x 1024 tokens in 2
   microbatches under ``"off"`` (flash at 6/2 heads, forward and
   backward, the same launches a step as the 1 x 1 mesh), then one
   1,024-token prefill and 4 decode steps under ``"fused"`` (flash at
   6/2 heads, the fused MLP at 3072 -> 2048, the KV cache split by
   sequence); the per-rank step times, peak memory and launches printed
   beside the 1 x 1 mesh step's.  The fake group's collectives move no
   data, so these numbers are one rank's compute at the split shapes and
   are not compared; they are held finite.  Each layer's attention and
   MLP outputs through the kernels are held against their plain versions
   on the same input by phase 2's rule, and each layer's gradients
   through the flash kernels against the plain Function's within 2e-2.
   Over the same group, the recurrent mixers split over ``model``:
   recurrentgemma-9b at full width as rank 0 (the RG-LRU at W = 1,024,
   heads 4/1, ``d_ff`` 3,072, vocab 64,000), a 1,024-token prefill and 4
   decode steps at full depth under ``"fused"`` and 2 train steps of 2 x
   3,072 tokens at phase 13's 6 layers under ``"off"`` (the scan's
   training build and backward at (1, 3072, 1024), phase 13's launches a
   step, each layer's gradients against the plain Functions' within
   2e-2; the fake group's reduce-scatter is replaced by one that keeps
   this rank's own part, as its all-reduce does), and xlstm-1.3b at 24
   layers, a 1,024-token prefill and 4 decode steps (the mLSTM scan whole
   on q, k and v gathered from 256 columns a head); for each every
   recurrent layer against its plain version by phase 2's rule, every
   decode-state leaf of ``cache_pspecs``' shard shape, no gather over
   ``model`` of a weight or a cache leaf, launches counted from 0.
16. The dry-run and the roofline (``repro_torch.launch.dryrun``,
   ``roofline/{analysis,op_cost}.py``): (a) the dry-run CLI, one process
   a cell, all started together, on llama3.2-3b's ``train_4k``,
   ``prefill_32k`` and ``decode_32k`` on the 16 x 16 mesh and
   ``train_4k`` on 2 x 16 x 16, qwen2-moe-a2.7b's ``prefill_32k`` with
   ``--opt`` and xlstm-1.3b's ``long_500k``, and both MoE configs' and
   recurrentgemma-9b's ``train_4k`` (their ``useful_flops_ratio`` printed
   beside llama's, the counts of the split over ``model``): each record ``ok``, planned
   and priced for the detected ``h100`` (memory term at 3.35 TB/s),
   ``mfu_bound <= 1``, and each cell's per-chip FLOPs and bytes,
   collectives by kind, three terms, dominant term, peak bytes and
   whether they fit 80 GB printed; (b) llama3.2-3b at full width, one
   4,096-token prefill through ``make_prefill_step`` under ``"fused"``
   on the card under ``op_cost``: its peak live bytes within 5% of
   ``torch.cuda.max_memory_allocated()`` over the same call, flash and
   the fused MLP launched once a layer, the same step's peak on fake CPU
   tensors (the plain path) beside it, and the model-FLOPs share of the
   card's bf16 peak (at most 1); (c) ``ref.attention_blockwise`` at
   llama's GQA 24/8, T = 8192, causal, against the flash kernel and the
   naive plain version by phase 2's rule, timed beside flash and SDPA.
17. One JSON line for the kernels, then the result line.

Phase 1 also holds the fused MLP's footprint at the MoE configs' shared
experts (2048 -> 5632 and 2048 -> 2816, gated) and at
llama-3.2-vision-90b's MLP (8192 -> 28672, gated), and the mLSTM scan's
at its ring depth, a multiple of its four owner warpgroups.  Phase 2
also holds flash attention at qwen2-moe-a2.7b's MHA 16/16 (T = 1024),
at whisper-base's encoder (8/8, 1500 x 1500, head_dim 64, not causal)
and at llama-3.2-vision-90b's cross-attention (64/8, 1024 queries over
1600 image tokens, head_dim 128, not causal) and causal self-attention
(T = 1024) beside SDPA, the fused MLP at qwen2-moe-a2.7b's shared
experts' 2048 -> 5632 -> 2048 (M = 1024, 256, 4) and at the VLM's 8192
-> 28672 -> 8192 (M = 1024, 4) beside the unfused chain, ``gemm_act``
and ``gemm`` at whisper-base's MLP (512 -> 2048 -> 512, M = 256 and 4),
and launches the mLSTM scan 100 times with state at (4, 4, 512, 1024) in
each build, each the first's bits.  The ``kernels`` line keeps each
kernel's headline on the path it had before phases 10a-10d were added;
their launches are in ``launches_by_path``.

It exits non-zero, printing no result, when no CUDA device is visible,
and when it stands alone without the rest of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# dense bf16 tensor-core FLOP/s and fp32 FLOP/s outside the tensor cores,
# at the 700 W power limit
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# repro.models.model.count_params of the served configs
N_PARAMS = {"qwen2-moe-a2.7b": 14_315_735_040,
            "recurrentgemma-9b": 10_444_984_320,
            "granite-20b": 20_318_651_392,
            "xlstm-1.3b": 1_944_285_520,
            "whisper-base": 97_250_304}

# kernel vs plain version, elementwise: |k - p| <= ATOL + RTOL * |p| (the
# JAX kernel tests' bf16 tolerance: both round fp32 sums to bf16, in
# different orders)
ATOL = RTOL = 2e-2
# the mLSTM scan's fp32 state, kernel vs plain version: the same recurrence
# over up to 2048 steps, its products fused and its sums taken in another
# order
STATE_ATOL = STATE_RTOL = 1e-3

LLAMA, MOE, RG, GRANITE, XLSTM = ("llama3.2-3b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "granite-20b",
                                  "xlstm-1.3b")
# the encoder–decoder and the cross-attention VLM, served after them
WHISPER, VLM = "whisper-base", "llama-3.2-vision-90b"
# llama-3.2-vision-90b at full width, its depth cut to two periods of (4
# self-attention + 1 cross-attention) layers: 21.3 GB of bf16 weights (100
# layers would be 175 GB); count_params of that config
VLM_SERVE_LAYERS = 10
VLM_SERVE_PARAMS = 10_657_898_498
# every cross layer's gate, tanh(xgate), for the whole VLM phase: at the
# reference's zero init tanh(0) o = 0 would hide any cross-attention fault
# from every check downstream of it
VLM_XGATE = 1.0
# qwen2-moe-a2.7b's served path against its plain path, end to end.
# Layer 0 routes the same input on both sides; after it the shared
# experts' bf16 rounding (the kernel rounds once from fp32, the plain
# chain after each product) moves the residual by about an ulp, the
# router's logits by a few thousandths, and the 4th and 5th of 60 logits
# lie about 0.1 apart, so some of the tokens still routed alike part at
# each layer; a parted token's later choices follow its own residual,
# and the tokens attending to it drift further.  On the card 6.6% part
# at layer 1 and 11-50% of the rest at each later layer: no token of 512
# is routed alike in all 24.  So the logits are compared with the served
# path routed as the plain path chose, and each layer's deltas on the
# same input.  The limit on the share of all (token, slot) pairs that
# differ over the 24 layers, routed freely, was set before the first run
# on the card
MOE_SWAP_LIMIT = 0.5
# the paper's own op (benchmarks/bench_paper_mlp.py): ViT-B's first MLP
# half, 3072 tokens, 768 -> 3072, gelu + bias; on no serving path
VIT_B = "vit-b (paper op)"
# whisper-base's cross-attention (head_dim 64, Tq != Tk, not causal) at
# its decoder's whole context, 448 queries (its served prefills are a
# bucket of queries over the 1500 frames)
WHISPER_X = "whisper-base (cross-attention)"
# the training path: llama3.2-3b at full width through the trainer
TRAIN = "llama3.2-3b (train)"
# repro.models.model.count_params of llama3.2-3b
LLAMA_PARAMS = 3_212_749_824
# the second training path: recurrentgemma-9b at full width, its depth cut
# to two periods of (rec, rec, local) so that the bf16 weights, fp32
# moments and gradients fit one 80 GB card (38 layers would need about
# 188 GB); repro.models.model.count_params of that config
RG_TRAIN = "recurrentgemma-9b (train)"
RG_TRAIN_LAYERS = 6
RG_TRAIN_PARAMS = 3_410_153_472
# xlstm-1.3b is served at full width with its depth cut to three periods
# of (7 mLSTM + 1 sLSTM), to keep the script's time; count_params of that
# config
XLSTM_SERVE_LAYERS = 24
XLSTM_SERVE_PARAMS = 1_075_167_400
# the third: xlstm-1.3b at full width and depth (48 layers) through the
# trainer, every mLSTM layer's scan and its gradient on the kernels
XLSTM_TRAIN = "xlstm-1.3b (train)"
# the mLSTM backward's fp32 di and df against the plain gradient:
# |kernel - plain| <= GATE_SHARE * (max|plain| + |plain|), the row dots and
# the reverse cumulative sum taken in another order than autograd's
GATE_SHARE = 1e-3
# the train path's gradients through the kernels against the plain
# Functions', leaf by leaf: |g_kernel - g_plain| / |g_plain| (norms over
# the leaf).  Both take bf16 products in another order, and the flash
# backward rounds dS to bf16 before dQ's product
GRAD_RTOL = 2e-2

N_TIMED = 20
# profiles taken of one call pattern while the profiler reports fewer of
# its kernels than wanted: it drops a few of the first launches in a
# profile, and in one run dropped every launch of one profile
PROFILE_TRIES = 3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call: CUDA events around it, the L2 flushed
    before it, and a device-side wait in front so that the host has
    enqueued the whole call before the start event fires."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def ms(self, fn, n: int = N_TIMED) -> float:
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS
             ) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BPS, flops / peak
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# phase 1: the builds this slice added
# ---------------------------------------------------------------------------

# entries (mangled names) of the builds added for training: the RG-LRU
# forward with its anchors and its backward, the flash forward with its
# row logsumexp at head_dim 256 (both tile heights), and every build of
# the flash backward's TMA + wgmma rebuild (with how many of each, where
# it is fixed), one build a head dim: its dK/dV kernel in rows (128 keys,
# head_dim 64 and 128) and in columns (64 keys, head_dim 256), its dQ
# kernel (64 rows at head_dim 64 and 256, 128 at 128), D's rows and the
# splits' sum
NEW_BUILDS = {
    "rg_lru_scan, anchors": (r"rg_lru_kernelILb[01]ELb1E", None),
    "rg_lru_scan_bwd": (r"rg_lru_bwd_kernel", None),
    "flash_attention, lse, D=256":
        (r"flash_kernelILi256ELi(64|128)ELb1E", None),
    "flash_attention_bwd dK/dV, rows": (r"dkdv_kernelILi(64|128)ELb0E", 2),
    "flash_attention_bwd dK/dV, columns": (r"dkdv_kernelILi256ELb1E", 1),
    "flash_attention_bwd dQ": (r"dq_kernelILi(64|128|256)ELi(64|128)E", 3),
    "flash_attention_bwd D rows": (r"dsum_kernelILi", 3),
    "flash_attention_bwd, splits' sum": (r"split_sum_kernel", 1),
    "mlstm_scan_bwd prep": (r"mlstm_bwd_prep_kernel", 1),
    "mlstm_scan_bwd gradients": (r"mlstm_bwd_grad_kernel", 1),
    "mlstm_scan_bwd gates": (r"mlstm_bwd_gate_kernel", 1),
}
# the mLSTM forward's builds spill already in serving (about 200 bytes a
# thread at Dh = 1024); the training builds' spills are printed beside
# theirs, not gated
FORWARD_BUILDS = r"mlstm_scan_kernelILi64ELi(\d)ELb([01])E"
# the mLSTM backward's state pass has the forward scan's shape (768
# threads at 80 registers a thread, moved by setmaxnreg): its four builds,
# one per tile count an owner holds, are held to no serialised wgmma, and
# their spills are printed, as the forward's are, not gated
STATE_PASS_BUILDS = r"mlstm_bwd_state_kernelILi(\d)E"


def check_new_builds(log: str) -> None:
    """``ptxas``'s report on :data:`NEW_BUILDS`: each has its entries,
    none spills, and none has its ``wgmma`` serialised (C7515/C7520); on
    :data:`STATE_PASS_BUILDS`: four, none serialised (C7515/C7520), their
    spills and any C7512 (registers too few for the wgmma) printed."""
    spills, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            spills[entry] = int(m.group(1)) + int(m.group(2))
    serialised = " ".join(line for line in log.splitlines()
                          if "C7515" in line or "C7520" in line)
    for what, (pattern, builds) in NEW_BUILDS.items():
        hits = {e: n for e, n in spills.items() if re.search(pattern, e)}
        check(len(hits) == builds if builds else bool(hits),
              f"{len(hits)} ptxas report(s) for {what}, "
              f"{builds or 'some'} expected")
        check(all(n == 0 for n in hits.values()),
              f"{what} spills: {hits}")
        check(not any(e in serialised for e in hits),
              f"{what}: ptxas serialised its wgmma")
        print(f"  ptxas: {what}: {len(hits)} build(s), no spills, no "
              f"serialised wgmma")
    state = {e: n for e, n in spills.items()
             if re.search(STATE_PASS_BUILDS, e)}
    check(len(state) == 4, f"{len(state)} ptxas report(s) for the "
          f"mlstm_scan_bwd state pass, 4 expected")
    check(not any(e in serialised for e in state),
          "mlstm_scan_bwd state pass: ptxas serialised its wgmma")
    short = " ".join(line for line in log.splitlines() if "C7512" in line)
    for e, n in sorted(spills.items()):
        m = re.search(FORWARD_BUILDS, e)
        if m:
            print(f"  ptxas: mlstm_scan, {int(m.group(1))} tiles an owner, "
                  f"{'training' if m.group(2) == '1' else 'serving'} build: "
                  f"{n} bytes of spill stores and loads")
        m = re.search(STATE_PASS_BUILDS, e)
        if m:
            print(f"  ptxas: mlstm_scan_bwd state pass, {m.group(1)} tiles "
                  f"an owner: no serialised wgmma, {n} bytes of spill "
                  f"stores and loads"
                  + (", C7512 (too few registers)" if e in short else ""))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(out: torch.Tensor, want: torch.Tensor, label: str, *,
            atol: float = ATOL, rtol: float = RTOL) -> float:
    """Max |out - want|, checked elementwise against atol + rtol * |want|."""
    check(out.shape == want.shape and out.dtype == want.dtype,
          f"{label}: {tuple(out.shape)}/{out.dtype} vs "
          f"{tuple(want.shape)}/{want.dtype}")
    o, w = out.float(), want.float()
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    err = (o - w).abs()
    share = float((err / (atol + rtol * w.abs())).max())
    ok = share <= 1.0
    max_err = float(err.max())
    print(f"  {label}: max|kernel - plain| {max_err} (tolerance "
          f"{atol} + {rtol}*|plain|, mean|plain| {float(w.abs().mean())}, "
          f"max|plain| {float(w.abs().max())}; largest share of the "
          f"tolerance used {share}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version")
    return max_err


def normal_bf16(dev, seed: int):
    """``randn(*shape, scale=1.0)``: N(0, scale^2) bf16 tensors from one
    generator seeded ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    return randn


def kernel_cases(dev, timer):
    from repro_torch.kernels import gemm, ref

    randn = normal_bf16(dev, 1234)

    results = {"gemm": [], "flash_attention": [],
               "flash_attention_bwd": [], "fused_mlp": [],
               "rg_lru_scan": [], "rg_lru_scan_bwd": [], "gemm_act": [],
               "mlstm_scan": [], "mlstm_scan_bwd": []}

    # execute_block_plan's projections: llama's at m=1024, and
    # recurrentgemma-9b's (wq/wo 4096 wide, MQA wk/wv 256 wide) at m=4096;
    # granite-20b's down projection inside the partial MLP (every prefill
    # layer) at its longest and shortest prefill bucket, and its
    # projections (wq/wo 6144 wide, MQA wk/wv one tile 128 wide) at m=2048
    for path, (m, k, n) in ((LLAMA, (1024, 3072, 3072)),
                            (LLAMA, (1024, 3072, 1024)),
                            (RG, (4096, 4096, 4096)),
                            (RG, (4096, 4096, 256)),
                            (GRANITE, (2048, 24576, 6144)),
                            (GRANITE, (128, 24576, 6144)),
                            (GRANITE, (2048, 6144, 6144)),
                            (GRANITE, (2048, 6144, 128)),
                            # whisper-base's partial MLP's down projection
                            # at a prefill bucket and at the 4 decode slots
                            (WHISPER, (256, 2048, 512)),
                            (WHISPER, (4, 2048, 512))):
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        label = f"gemm ({m}x{k})@({k}x{n})"
        sched = tile_loop(label, x, w)
        err = compare(gemm.gemm(x, w), ref.gemm(x, w), label)
        b, why = bound_ms(2 * (m * k + k * n + m * n), 2 * m * n * k)
        results["gemm"].append(dict(
            path=path, shape=[m, k, n], max_abs_err=err, **sched,
            ms=timer.ms(lambda: gemm.gemm(x, w)),
            other_width_ms=other_width_ms(
                timer, x, w, lambda s: gemm.run_schedule(x, w, s)),
            plain_ms=timer.ms(lambda: ref.gemm(x, w)),
            library_ms=timer.ms(lambda: torch.matmul(x, w)),
            bound_ms=b, bound_by=why))

    results["flash_attention"] = flash_cases(dev, timer, randn)
    flash_window_cases(dev, randn)
    results["flash_attention_bwd"] = flash_bwd_cases(dev, timer, randn)
    results["fused_mlp"] += fused_mlp_cases(
        dev, timer, randn, 3072, 8192, 3072, "silu", (1024, 256, 4), LLAMA)
    # qwen2-moe-a2.7b's shared experts: one gated MLP on every token
    # routed together (a prefill bucket, or the four decode slots)
    results["fused_mlp"] += fused_mlp_cases(
        dev, timer, randn, 2048, 5632, 2048, "silu", (1024, 256, 4), MOE)
    results["fused_mlp"] += fused_mlp_cases(
        dev, timer, randn, 4096, 12288, 4096, "gelu", (4096, 1024, 4), RG)
    # llama-3.2-vision-90b's MLP: its largest prefill bucket and the four
    # decode slots (1.41 GB of weights)
    results["fused_mlp"] += fused_mlp_cases(
        dev, timer, randn, 8192, 28672, 8192, "silu", (1024, 4), VLM)
    results["rg_lru_scan"] = rg_lru_cases(dev, timer, randn)
    results["rg_lru_scan_bwd"] = rg_lru_bwd_cases(dev, timer, randn)
    results["gemm_act"] = gemm_act_cases(dev, timer, randn)
    partial_vs_fused(dev, timer, randn)
    results["mlstm_scan"] = mlstm_cases(dev, timer, randn)
    results["mlstm_scan_bwd"] = mlstm_bwd_cases(dev, timer, randn)

    for name, cases in results.items():
        for c in cases:
            lib = ("" if c["library_ms"] is None
                   else f", one PyTorch call {c['library_ms']} ms")
            work = ("" if "work_bound_ms" not in c
                    else f", the design's work {c['work_bound_ms']} ms "
                         f"({c['work_bound_by']})")
            if c.get("lse_ms") is not None:
                work += f", with the row logsumexp {c['lse_ms']} ms"
            if c.get("anchors_ms") is not None:
                work += f", with the unit anchors {c['anchors_ms']} ms"
            if c.get("states_ms") is not None:
                work += (f", the training forward (saved states) "
                         f"{c['states_ms']} ms")
            print(f"  {name} {c['shape']}: kernel {c['ms']} ms, bound "
                  f"{c['bound_ms']} ms ({c['bound_by']}){work}, plain "
                  f"{c['plain_ms']} ms{lib}")
    return results


def flash_cases(dev, timer, randn):
    """Flash attention against its plain version: llama's GQA 24/8,
    qwen2-moe-a2.7b's MHA 16/16 and granite-20b's MQA 48/1 at head_dim
    128, causal; recurrentgemma-9b's
    local attention (MQA 16/1, head_dim 256, window 2048) at T = 4096 and
    1024; whisper-base's cross-attention (8/8 heads, head_dim 64, not
    causal, 448 queries over 1500 keys) and its encoder (1500 over 1500,
    not causal); llama-3.2-vision-90b's cross-attention (64/8 heads, a
    1024 bucket over 1600 image tokens, not causal) and self-attention
    (T = 1024, causal).  Each row prints its schedule and its time at the
    other tile height.  The
    one PyTorch call is SDPA: causal where the window is at least T (the
    same function), with a boolean window mask at T = 4096."""
    from repro_torch.kernels import flash_attention, ref

    out = []
    win = 2048
    rows = [(LLAMA, (1, 24, 8, 1024, 1024, 128), dict(causal=True), 1.0),
            (LLAMA, (1, 24, 8, 200, 200, 128), dict(causal=True), 1.0),
            # qwen2-moe-a2.7b's MHA 16/16 at its largest served bucket
            (MOE, (1, 16, 16, 1024, 1024, 128), dict(causal=True), 1.0),
            (GRANITE, (1, 48, 1, 2048, 2048, 128), dict(causal=True), 1.0),
            # q and k at 1.5 give scores of std 2.25, so that a row's
            # output is not the near-zero mean of ~2048 values (|o| ~ 0.04
            # at unit scale) and one key more or less at the window's edge
            # shows far beyond the tolerance
            (RG, (1, 16, 1, 4096, 4096, 256), dict(causal=True, window=win),
             1.5),
            (RG, (1, 16, 1, 1024, 1024, 256), dict(causal=True, window=win),
             1.5),
            (WHISPER_X, (1, 8, 8, 448, 1500, 64), dict(causal=False), 1.0),
            # whisper-base's encoder over its 1500 frames
            (WHISPER, (1, 8, 8, 1500, 1500, 64), dict(causal=False), 1.0),
            # llama-3.2-vision-90b's cross-attention (a 1024 bucket over
            # the 1600 image tokens) and its causal self-attention
            (VLM, (1, 64, 8, 1024, 1600, 128), dict(causal=False), 1.0),
            (VLM, (1, 64, 8, 1024, 1024, 128), dict(causal=True), 1.0)]
    for path, (b_, hq, hk, tq, tk, dh), kw, sc in rows:
        q, kk, v = (randn(b_, hq, tq, dh, scale=sc),
                    randn(b_, hk, tk, dh, scale=sc), randn(b_, hk, tk, dh))
        kw = {"window": None, "q_offset": 0, **kw}
        label = (f"flash_attention B={b_} Hq={hq} Hk={hk} Tq={tq} Tk={tk} "
                 f"D={dh} {'causal' if kw['causal'] else 'not causal'}"
                 f"{'' if kw['window'] is None else ' window=%d' % win}")
        s = flash_attention.plan(q, kk, **kw)
        print(f"  {label}: schedule {s.label}, {s.smem_bytes} B of shared "
              f"memory")
        err = compare(flash_attention.flash_attention(q, kk, v, **kw),
                      ref.attention(q, kk, v, **kw), label)
        mask = window_mask(dev, tq, tk, kw["causal"], kw["window"])
        pairs = int(mask.sum())           # unmasked (query, key) pairs
        bd, why = bound_ms(2 * (2 * q.numel() + 2 * kk.numel()),
                           4 * b_ * hq * dh * pairs)
        if kw["window"] is None or win >= tk:
            lib_name = f"SDPA, is_causal={kw['causal']}"
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kk, v, is_causal=kw["causal"], enable_gqa=True)
        else:
            lib_name = "SDPA, boolean window mask"
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, kk, v, attn_mask=mask, enable_gqa=True)
        other = flash_attention.schedule(
            b_, hq, hk, tq, tk, dh, kw["causal"], kw["window"], 0,
            sms=flash_attention.sm_count(dev.index),
            block_q={64: 128, 128: 64}[s.block_q])
        other_ms = timer.ms(lambda: flash_attention.run_schedule(
            q, kk, v, other, **kw))
        print(f"    at the other tile height, {other.label}: {other_ms} ms")
        out.append(dict(
            path=path, shape=[b_, hq, hk, tq, tk, dh], causal=kw["causal"],
            window=kw["window"], max_abs_err=err, block_q=s.block_q,
            block_k=s.block_k, stages=s.stages, grid=s.grid,
            ms=timer.ms(lambda: flash_attention.flash_attention(
                q, kk, v, **kw)),
            other_height_ms=other_ms,
            # with the row logsumexp a training forward writes
            lse_ms=timer.ms(lambda: flash_attention._forward(
                q, kk, v, with_lse=True, **kw)),
            plain_ms=timer.ms(lambda: ref.attention(q, kk, v, **kw)),
            library=lib_name, library_ms=timer.ms(lib),
            bound_ms=bd, bound_by=why))
    return out


def flash_window_cases(dev, randn):
    """The flash forward where a causal window meets more queries than
    keys, at both tile heights: the rows' last key can lie past every key
    tile, and before its span was clamped the kernel's masked loop waited
    on a tile it never loaded.  Each must finish and match plain."""
    from repro_torch.kernels import flash_attention, ref

    for b_, hq, hk, tq, tk, dh, win in ((1, 2, 1, 128, 16, 256, 2),
                                        (1, 2, 1, 200, 64, 128, 17)):
        q = randn(b_, hq, tq, dh)
        kk, v = randn(b_, hk, tk, dh), randn(b_, hk, tk, dh)
        kw = dict(causal=True, window=win, q_offset=0)
        for bq in flash_attention.BLOCK_Q:
            s = flash_attention.schedule(
                b_, hq, hk, tq, tk, dh, True, win, 0,
                sms=flash_attention.sm_count(dev.index), block_q=bq)
            label = (f"flash_attention B={b_} Hq={hq} Hk={hk} Tq={tq} "
                     f"Tk={tk} D={dh} causal window={win}, {s.label}")
            got = flash_attention.run_schedule(q, kk, v, s, **kw)
            torch.cuda.synchronize()
            compare(got, ref.attention(q, kk, v, **kw), label)


def window_mask(dev, tq: int, tk: int, causal: bool,
                window: int | None) -> torch.Tensor:
    """The (Tq, Tk) boolean mask of the keys each query sees."""
    qi = torch.arange(tq, device=dev)[:, None]
    ki = torch.arange(tk, device=dev)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def sdpa_backend(q, k, v, mask, causal: bool) -> str:
    """The backend SDPA picks for these operands (PyTorch's own choice
    function, where this PyTorch has it)."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not reported by this PyTorch"
    code = choose(q, k, v, attn_mask=mask,
                  is_causal=causal and mask is None, enable_gqa=True)
    return {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}.get(
        int(code), f"backend {int(code)}")


def flash_bwd_cases(dev, timer, randn):
    """The flash backward kernels against ``ref.attention_bwd`` on the
    forward kernel's o and lse, dO ~ N(0, 1), in bf16 with phase 2's
    rule: llama's GQA 24/8 at the train path's microbatch (2 x 1024), at
    T = 2048, and at T = 2048 with a 512 window; granite-20b's MQA 48/1 at
    T = 2048; a ragged (2, 24/8, 1000); whisper-base's cross-attention
    (8/8, 448 over 1500 keys, head_dim 64, not causal); and
    recurrentgemma-9b's local attention at head_dim 256, MQA 16/1: the
    train path's (1, 3072) with its 2048 window, (1, 4096) with the
    window, (1, 1024) causal, and a ragged (1, 1000) with a 256 window.
    Each row prints the backward's schedule (``bwd_schedule``: the dK/dV
    kernel's key tile, stages, grid and splits of a group's q heads, the
    dQ kernel's query tile, stages and grid).  Two launches must give the
    same bits.  The one PyTorch call
    is SDPA's backward, through ``torch.autograd.grad`` on a saved graph,
    with ``is_causal`` where the window does not bind and the window as a
    boolean mask where it does (the backend it lands on is printed); the
    bound counts 10 Dh operations for each unmasked (query, key) pair of
    each head."""
    from repro_torch.kernels import flash_attention, ref

    out = []
    rows = [(TRAIN, (2, 24, 8, 1024, 1024, 128), True, None, 1.0),
            (LLAMA, (1, 24, 8, 2048, 2048, 128), True, None, 1.0),
            (GRANITE, (1, 48, 1, 2048, 2048, 128), True, None, 1.0),
            (LLAMA, (2, 24, 8, 1000, 1000, 128), True, None, 1.0),
            (WHISPER_X, (1, 8, 8, 448, 1500, 64), False, None, 1.0),
            (LLAMA, (1, 24, 8, 2048, 2048, 128), True, 512, 1.0),
            # q and k at 1.5, as in the forward rows at head_dim 256
            (RG_TRAIN, (1, 16, 1, 3072, 3072, 256), True, 2048, 1.5),
            (RG, (1, 16, 1, 4096, 4096, 256), True, 2048, 1.5),
            (RG, (1, 16, 1, 1024, 1024, 256), True, None, 1.5),
            ("ragged", (1, 16, 1, 1000, 1000, 256), True, 256, 1.5)]
    for path, (b_, hq, hk, tq, tk, dh), causal, win, sc in rows:
        q, kk, v = (randn(b_, hq, tq, dh, scale=sc),
                    randn(b_, hk, tk, dh, scale=sc), randn(b_, hk, tk, dh))
        do = randn(b_, hq, tq, dh)
        kw = dict(causal=causal, window=win, q_offset=0)
        sched = flash_attention.bwd_plan(q, kk, **kw)
        label = (f"flash_attention_bwd B={b_} Hq={hq} Hk={hk} Tq={tq} "
                 f"Tk={tk} D={dh} {'causal' if causal else 'not causal'}"
                 f"{'' if win is None else ' window=%d' % win}")
        print(f"  {label}: schedule {sched.label}, {sched.kv_smem_bytes} "
              f"and {sched.q_smem_bytes} B of shared memory")
        o, lse = flash_attention._forward(q, kk, v, with_lse=True, **kw)
        got = flash_attention.flash_attention_bwd(q, kk, v, o, lse, do, **kw)
        want = ref.attention_bwd(q, kk, v, o, lse, do, **kw)
        err = max(compare(g, w, f"{label} {n}")
                  for n, g, w in zip(("dq", "dk", "dv"), got, want))
        again = flash_attention.flash_attention_bwd(q, kk, v, o, lse, do,
                                                    **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"  {label}: two launches bit-identical: {same}")
        check(same, f"{label}: two launches differ")
        del got, want, again
        mask = window_mask(dev, tq, tk, causal, win)
        pairs = int(mask.sum())           # unmasked (query, key) pairs
        nbytes = (2 * 4 * q.numel() + 2 * 4 * kk.numel()
                  + 4 * lse.numel())
        bd, why = bound_ms(nbytes, 10 * b_ * hq * dh * pairs)
        split = None
        if path == TRAIN:
            split = bwd_kernel_split(flash_attention, q, kk, v, o, lse, do,
                                     kw)
            print(f"  {label}: device ms a call by kernel (profiler, mean of "
                  f"5): {split}")
        binds = win is not None and win < tk
        lib_mask = mask if binds else None
        ts = [t.detach().clone().requires_grad_() for t in (q, kk, v)]
        sdpa = F.scaled_dot_product_attention(
            *ts, attn_mask=lib_mask, is_causal=causal and not binds,
            enable_gqa=True)
        backend = sdpa_backend(*ts, lib_mask, causal)
        out.append(dict(
            path=path, shape=[b_, hq, hk, tq, tk, dh], causal=causal,
            window=win, block_k=sched.block_k, block_q=sched.block_q,
            stages=[sched.kv_stages, sched.q_stages],
            grid=[sched.kv_grid, sched.q_grid], splits=sched.splits,
            max_abs_err=err, bit_identical=same, kernels_ms=split,
            ms=timer.ms(lambda: flash_attention.flash_attention_bwd(
                q, kk, v, o, lse, do, **kw)),
            plain_ms=timer.ms(lambda: ref.attention_bwd(
                q, kk, v, o, lse, do, **kw)),
            library=(f"SDPA backward ({backend}), "
                     + ("boolean window mask" if binds
                        else f"is_causal={causal}")),
            library_ms=timer.ms(lambda: torch.autograd.grad(
                sdpa, ts, do, retain_graph=True)),
            bound_ms=bd, bound_by=why))
        del sdpa, ts, mask
        torch.cuda.empty_cache()
    return out


def bwd_kernel_split(flash_attention, q, k, v, o, lse, do, kw) -> dict:
    """Device ms a call of the flash backward's kernels (D's rows, dK/dV,
    dQ on the side stream, the splits' sum), the mean of 5 calls under
    the profiler: what holds the call back."""
    flash_attention.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            # a wait first: the events the profiler drops are the first
            torch.cuda._sleep(2_000_000)
            for _ in range(5):
                flash_attention.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw)
            torch.cuda.synchronize()
        split = {}
        for name, (_, ms) in _device_kernels(prof).items():
            m = re.search(r"(dsum|dkdv|split_sum|dq)_kernel", name)
            if m:
                split[m.group(1)] = split.get(m.group(1), 0.0) + ms / 5
        if set(split) >= {"dsum", "dkdv", "dq"}:
            break
    check(set(split) >= {"dsum", "dkdv", "dq"},
          f"flash backward kernels missing from the profile: {split}")
    return split


def tile_loop(label, x, w) -> dict:
    """The GEMM tile loop's schedule for ``x @ w`` (kernels/gemm.py:plan),
    printed on the case's own line: ``tma``, ``tma+splitk=N`` or
    ``mma.sync``, the tile width and the grid."""
    from repro_torch.kernels import gemm

    s = gemm.plan(x, w)
    print(f"  {label}: tile loop {s.label}, 128 x {s.block_n} tiles, "
          f"grid {s.grid}, workspace {s.workspace_bytes} B")
    return dict(tile_loop=s.label, block_n=s.block_n, split_k=s.split_k,
                grid=s.grid)


def other_width_ms(timer, x, w, run) -> float | None:
    """The TMA route's time at the tile width its schedule did not pick
    (with that width's own split), for the record; None on mma.sync."""
    from repro_torch.kernels import gemm

    s = gemm.plan(x, w)
    if s.route != "tma":
        return None
    m, k = x.shape
    n = w.shape[1]
    other = gemm.schedule(m, n, k, sms=gemm.sm_count(x.device.index),
                          block_n={128: 256, 256: 128}[s.block_n])
    t = timer.ms(lambda: run(other))
    print(f"    at the other tile width, {other.label} 128 x "
          f"{other.block_n}: {t} ms")
    return t


def fused_mlp_cases(dev, timer, randn, k_, f_, n_, act, ms, path):
    """The gated fused MLP at widths K -> F -> N against its plain version
    at each M of ``ms``: its schedule (M tile, F slice, hidden chunk, ring
    stages, grid), two launches checked bit-identical, its time at the
    other M-tile height, and the unfused cuBLAS chain (two torch.matmul,
    the activation and the gate, torch.matmul) timed beside it as a
    yardstick the port never calls."""
    from repro_torch.kernels import fused_mlp, ref

    out = []
    w1, wg = randn(k_, f_, scale=k_ ** -0.5), randn(k_, f_, scale=k_ ** -0.5)
    w2 = randn(f_, n_, scale=f_ ** -0.5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    act_fn = {"silu": F.silu,
              "gelu": lambda t: F.gelu(t, approximate="tanh")}[act]
    for m in ms:
        x = randn(m, k_)
        label = f"fused_mlp M={m} {k_}->{f_}->{n_} {act} gated"
        s = fused_mlp.schedule(m, k_, f_, n_, True, n_sm)
        y1 = fused_mlp.fused_mlp(x, w1, w2, wg, act=act)
        y2 = fused_mlp.fused_mlp(x, w1, w2, wg, act=act)
        torch.cuda.synchronize()
        check(torch.equal(y1, y2), f"{label}: two launches differ")
        err = compare(y1, ref.mlp(x, w1, w2, wg, act=act), label)
        b, why = bound_ms(2 * (m * k_ + 2 * k_ * f_ + f_ * n_ + m * n_),
                          2 * m * k_ * f_ * 2 + 2 * m * f_ * n_)
        other = fused_mlp.schedule(m, k_, f_, n_, True, n_sm,
                                   block_m={64: 128, 128: 64}[s.block_m])
        t_other = timer.ms(lambda: fused_mlp.run_schedule(
            x, w1, w2, wg, None, None, act, other))
        t_unfused = timer.ms(lambda: torch.matmul(
            act_fn(torch.matmul(x, w1)) * torch.matmul(x, wg), w2))
        print(f"  {label}: schedule {s.label}, {s.partial_bytes} B of fp32 "
              f"partials; two launches bit-identical; at the other M-tile "
              f"height ({other.label}) {t_other} ms; the unfused cuBLAS "
              f"chain {t_unfused} ms")
        out.append(dict(
            path=path, shape=[m, k_, f_, n_], max_abs_err=err,
            schedule=s.label, block_m=s.block_m, block_f=s.block_f,
            hidden_chunk=s.hidden_chunk, stages=s.stages, grid=s.grid,
            ms=timer.ms(lambda: fused_mlp.fused_mlp(x, w1, w2, wg,
                                                     act=act)),
            other_height_ms=t_other,
            plain_ms=timer.ms(lambda: ref.mlp(x, w1, w2, wg, act=act)),
            library_ms=None, unfused_ms=t_unfused, bound_ms=b,
            bound_by=why))
    return out


def rg_lru_cases(dev, timer, randn):
    """The RG-LRU scan against its plain version: recurrentgemma-9b's
    widest prefill (B=1, T=W=4096), four slots, a ragged shape and the
    served buckets 128 and 2048, each with and without h0.  Each case
    prints its schedule (channel tile, chunk, grid, from
    ``kernels/rg_lru.py:schedule``) and its time at the other chunk length
    (``other_chunk_ms``); h and h_T are checked bit for bit against
    ``chunked_model`` (the kernel's arithmetic in plain PyTorch) and two
    launches bit-identical.  No single PyTorch call runs a recurrence with
    a per-step decay, so there is no library time."""
    from repro_torch.kernels import ref, rg_lru

    out = []
    gen = torch.Generator(device=dev).manual_seed(99)
    for b, t, w in ((1, 4096, 4096), (4, 1024, 4096), (2, 1000, 4000),
                    (1, 128, 4096), (1, 2048, 4096)):
        x = randn(b, t, w, scale=0.5)
        a = (0.79 + 0.2 * torch.rand((b, t, w), generator=gen, device=dev)
             ).to(torch.bfloat16)
        sched = rg_lru.schedule(b, t, w)
        other_chunk = sched.chunk // 2 if sched.chunk > rg_lru.UNIT \
            else 2 * sched.chunk
        other = rg_lru.schedule(b, t, w, other_chunk, sched.channel_tile)
        for h0 in (None, torch.randn((b, w), generator=gen, device=dev)):
            label = (f"rg_lru_scan B={b} T={t} W={w} "
                     f"{'h0' if h0 is not None else 'no h0'}")
            print(f"  {label}: schedule {sched.label}, {sched.smem_bytes} B "
                  f"of shared memory, {sched.scratch_bytes} B of scratch")
            h, h_t = rg_lru.rg_lru_scan(x, a, h0)
            want, want_t = ref.rg_lru_scan(x, a, h0)
            err = max(compare(h, want, label + " h"),
                      compare(h_t, want_t, label + " h_T (fp32)",
                              atol=1e-4, rtol=1e-4))
            again, again_t = rg_lru.rg_lru_scan(x, a, h0)
            model, model_t = rg_lru.chunked_model(x, a, h0, sched=sched)
            torch.cuda.synchronize()
            check(torch.equal(h, again) and torch.equal(h_t, again_t),
                  f"{label}: two launches differ")
            check(torch.equal(h, model) and torch.equal(h_t, model_t),
                  f"{label}: not the chunked model's bits")
            print(f"  {label}: two launches bit-identical, and equal to "
                  f"chunked_model bit for bit")
            # x, a read and h written in bf16, h_T written (h0 read) in fp32
            nbytes = 6 * b * t * w + 4 * b * w * (2 if h0 is not None else 1)
            bd, why = bound_ms(nbytes, 2 * b * t * w, FP32_FLOPS)
            t_other = timer.ms(lambda: rg_lru.run_schedule(x, a, h0, other))
            print(f"    at the other chunk length, {other.label}: "
                  f"{t_other} ms")
            out.append(dict(
                path=RG if w == 4096 else "ragged", shape=[b, t, w],
                h0=h0 is not None, schedule=sched.label,
                channel_tile=sched.channel_tile, chunk=sched.chunk,
                grid=sched.grid, max_abs_err=err,
                ms=timer.ms(lambda: rg_lru.rg_lru_scan(x, a, h0)),
                # the training build, which also writes the unit anchors
                anchors_ms=timer.ms(lambda: rg_lru._forward(
                    x, a, h0, with_anchors=True)),
                other_chunk_ms=t_other,
                # a Python loop over T: three launches a step
                plain_ms=timer.ms(lambda: ref.rg_lru_scan(x, a, h0), n=3),
                library_ms=None, bound_ms=bd, bound_by=why))
    return out


def rg_lru_bwd_cases(dev, timer, randn):
    """The RG-LRU backward kernel against ``ref.rg_lru_bwd`` (dx, da in
    bf16 by phase 2's rule, dh0 in fp32 within 1e-4 + 1e-4·|dh0|), dh ~
    N(0, 1), on the anchors of the forward kernel's training build: the
    train path's (1, 3072, 4096), (1, 4096, 4096), four rows at T = 1024,
    the ragged (2, 1000, 4000), and (1, 3072, 4096) again with h0 and a
    cotangent on h_T.  Each case is checked bit for bit against
    ``chunked_bwd_model`` (the kernel's arithmetic in plain PyTorch) and
    against a second launch.  The bound counts what the function must
    move: dh, a and x read and dx, da written in bf16, the anchors (and
    h0's, dh_T's and dh0's fp32) once; 5 fp32 operations an element.  No
    single PyTorch call computes this function."""
    from repro_torch.kernels import ref, rg_lru

    out = []
    gen = torch.Generator(device=dev).manual_seed(98)
    for path, (b, t, w), state in ((RG_TRAIN, (1, 3072, 4096), False),
                                   (RG, (1, 4096, 4096), False),
                                   (RG, (4, 1024, 4096), False),
                                   ("ragged", (2, 1000, 4000), False),
                                   (RG_TRAIN, (1, 3072, 4096), True)):
        x = randn(b, t, w, scale=0.5)
        a = (0.79 + 0.2 * torch.rand((b, t, w), generator=gen, device=dev)
             ).to(torch.bfloat16)
        dh = randn(b, t, w)
        h0 = torch.randn((b, w), generator=gen, device=dev) if state \
            else None
        dh_t = torch.randn((b, w), generator=gen, device=dev) if state \
            else None
        sched = rg_lru.schedule(b, t, w, backward=True)
        label = (f"rg_lru_scan_bwd B={b} T={t} W={w} "
                 f"{'h0, dh_T' if state else 'no h0, no dh_T'}")
        print(f"  {label}: schedule {sched.label}, {sched.smem_bytes} B "
              f"of shared memory, {sched.scratch_bytes} B of scratch")
        _, _, anchors = rg_lru._forward(x, a, h0, with_anchors=True)
        got = rg_lru.rg_lru_scan_bwd(x, a, anchors, dh, dh_t)
        want = ref.rg_lru_bwd(x, a, h0, dh, dh_t)
        err = max(compare(got[0], want[0], label + " dx"),
                  compare(got[1], want[1], label + " da"),
                  compare(got[2], want[2], label + " dh0 (fp32)",
                          atol=1e-4, rtol=1e-4))
        again = rg_lru.rg_lru_scan_bwd(x, a, anchors, dh, dh_t)
        model = rg_lru.chunked_bwd_model(x, a, dh, dh_t, h0, sched=sched)
        torch.cuda.synchronize()
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"{label}: two launches differ")
        check(all(torch.equal(p, q) for p, q in zip(got, model)),
              f"{label}: not the chunked model's bits")
        print(f"  {label}: two launches bit-identical, and equal to "
              f"chunked_bwd_model bit for bit")
        del got, want, again, model
        fp32 = 4 * b * w * (1 + 2 * state)      # dh0, and h0 and dh_T
        nbytes = 10 * b * t * w + 4 * anchors.numel() + fp32
        bd, why = bound_ms(nbytes, 5 * b * t * w, FP32_FLOPS)
        out.append(dict(
            path=path, shape=[b, t, w], h0=state, dh_t=state,
            schedule=sched.label, channel_tile=sched.channel_tile,
            chunk=sched.chunk, grid=sched.grid, max_abs_err=err,
            ms=timer.ms(lambda: rg_lru.rg_lru_scan_bwd(
                x, a, anchors, dh, dh_t)),
            # a Python loop over T: about six launches a step
            plain_ms=timer.ms(lambda: ref.rg_lru_bwd(x, a, h0, dh, dh_t),
                              n=3),
            library="none: no one call runs this recurrence's gradient",
            library_ms=None, bound_ms=bd, bound_by=why))
    return out


def gemm_act_cases(dev, timer, randn):
    """``act(x @ w + b)`` against its plain version: granite-20b's up
    projection at a long and a short prefill bucket, the paper's ViT-B
    op, a ragged case (no dimension a multiple of 8, relu, no bias) and
    whisper-base's up projection at M = 256 and 4.  The one PyTorch call
    that computes the same function is cuBLASLt's bias + activation epilogue (``torch._addmm_activation``:
    gelu in the tanh form, or relu)."""
    from repro_torch.kernels import gemm_act, ref

    out = []
    for path, (m, k, n), act, bias in (
            (GRANITE, (2048, 6144, 24576), "gelu", True),
            (GRANITE, (128, 6144, 24576), "gelu", True),
            (VIT_B, (3072, 768, 3072), "gelu", True),
            ("ragged", (1001, 1003, 3005), "relu", False),
            # whisper-base's partial MLP's up projection at a prefill
            # bucket and at the 4 decode slots
            (WHISPER, (256, 512, 2048), "gelu", True),
            (WHISPER, (4, 512, 2048), "gelu", True)):
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        b = randn(n, scale=0.5) if bias else None
        label = (f"gemm_act ({m}x{k})@({k}x{n}) {act} "
                 f"{'+ bias' if bias else 'no bias'}")
        sched = tile_loop(label, x, w)
        err = compare(gemm_act.gemm_act(x, w, b, act=act),
                      ref.gemm_act(x, w, b, act=act), label)
        nbytes = 2 * (m * k + k * n + m * n + (n if bias else 0))
        bd, why = bound_ms(nbytes, 2 * m * n * k)
        # relu(x @ w) as the same epilogue on a zero bias
        lib_b = b if bias else torch.zeros(n, dtype=x.dtype, device=dev)
        out.append(dict(
            path=path, shape=[m, k, n], act=act, bias=bias, max_abs_err=err,
            **sched,
            ms=timer.ms(lambda: gemm_act.gemm_act(x, w, b, act=act)),
            other_width_ms=other_width_ms(
                timer, x, w,
                lambda s: gemm_act.run_schedule(x, w, b, act, s)),
            plain_ms=timer.ms(lambda: ref.gemm_act(x, w, b, act=act)),
            library_ms=timer.ms(lambda: torch._addmm_activation(
                lib_b, x, w, use_gelu=act == "gelu")),
            library_call="torch._addmm_activation", bound_ms=bd,
            bound_by=why))
    return out


def partial_vs_fused(dev, timer, randn):
    """granite-20b's whole MLP (6144 -> 24576 -> 6144, gelu, biases) at
    M = 2048 and M = 128 through both kernel executors: the fused MLP on
    its schedule, and the partial schedule (gemm_act, then gemm) that the
    planner picks on the h100 target.  Measured only; printed beside the
    planner's modelled traffic for each schedule and the fused kernel's
    fp32 partial bytes."""
    from repro_torch.core import hw
    from repro_torch.core.ftl import graph, partition, registry
    from repro_torch.kernels import fused_mlp, ref

    k_, f_ = 6144, 24576
    w1, w2 = randn(k_, f_, scale=k_ ** -0.5), randn(f_, k_, scale=f_ ** -0.5)
    b1, b2 = randn(f_, scale=0.1), randn(k_, scale=0.1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fused = registry.get("cuda_fused_mlp").run
    part = registry.get("cuda_partial_mlp").run
    for m in (2048, 128):
        x = randn(m, k_)
        g = graph.mlp_graph(m=m, d_model=k_, d_ff=f_, gated=False,
                            act="gelu")
        chosen = partition.plan_chain(g, target=hw.H100)
        whole = partition.plan_fixed(g, (), target=hw.H100)
        sched = fused_mlp.schedule(m, k_, f_, k_, False, n_sm)
        want = ref.mlp(x, w1, w2, None, b1, b2, act="gelu")
        for name, fn in (("fused", fused), ("partial", part)):
            compare(fn(x, w1, w2, None, b1, b2, act="gelu", target=hw.H100),
                    want, f"granite MLP M={m} through cuda_{name}_mlp")
        t_f = timer.ms(lambda: fused(x, w1, w2, None, b1, b2, act="gelu",
                                     target=hw.H100))
        t_p = timer.ms(lambda: part(x, w1, w2, None, b1, b2, act="gelu"))
        t_ref = timer.ms(lambda: ref.mlp(x, w1, w2, None, b1, b2,
                                         act="gelu"))
        print(f"  granite MLP M={m}: plain {t_ref} ms; "
              f"cuda_fused_mlp ({sched.label}) {t_f} ms, fp32 partials move "
              f"{2 * sched.partial_bytes} B; cuda_partial_mlp {t_p} ms, h "
              f"moves {2 * 2 * m * f_} B; "
              f"the planner on h100 picks {chosen.schedule} (cuts "
              f"{list(chosen.cuts())}, modelled traffic "
              f"{chosen.traffic_bytes} B, {chosen.modeled_runtime_s} s) over "
              f"fused (modelled traffic {whole.traffic_bytes} B, "
              f"{whole.modeled_runtime_s} s); on the card "
              f"{'partial' if t_p < t_f else 'fused'} is faster")


def mlstm_cases(dev, timer, randn):
    """The mLSTM scan, h and its final fp32 state, against its plain
    version: xlstm-1.3b's prefill at the largest bucket (B = 1, H = 4,
    T = 2048, Dh = 1024) with and without state, four slots at T = 512, a
    ragged case at the reduced config's head dim, and a scan padded on the
    right whose state is taken at a length below T (gates -inf / +inf
    past it, as ``mlstm_block(length=)`` masks them) against the unpadded
    scan's.  The forget gate is shifted by 3, as the model shifts it.
    Each case prints its schedule (chunk length, ring stages, grids) and
    its time in the training build, which also writes the chunks' start
    states, the fp32 h and the denominators (``states_ms``); two launches
    of the first case are checked bit-identical.  Three bounds are kept
    apart: ``bound_ms``, the function's own work, which the kernel is held
    to: the chunkwise form's 4 Dh^2 + 4 L Dh operations a step and head at
    the bf16 rate, or the bytes every input read once and every output
    written once must move; ``work_bound_ms``, the work this design adds
    on top: the split-bf16 products' 8 Dh^2 + 6 L Dh operations and the
    Q K^T scratch written and read; and ``fp32_bound_ms``, the step-by-step
    recurrence's 5 (Dh^2 + Dh) fp32 operations a step and head at the
    fp32 rate, the bound of a step-by-step kernel.  No single PyTorch
    call runs this recurrence, so there is no library time."""
    from repro_torch.kernels import mlstm, ref

    out = []
    gen = torch.Generator(device=dev).manual_seed(77)

    def gates(b, h, t):
        return (torch.randn((b, h, t), generator=gen, device=dev),
                torch.randn((b, h, t), generator=gen, device=dev) + 3.0)

    def bounds(b, h, t, dh, state, sched):
        # q, k, v read and h written in bf16, the gates read in fp32, the
        # state written in fp32
        nbytes = 8 * b * h * t * dh + 8 * b * h * t
        if state:
            nbytes += 4 * b * h * (dh * dh + dh + 1)
        steps, L = b * h * t, sched.chunk
        fn = bound_ms(nbytes, steps * (4 * dh * dh + 4 * L * dh))
        # the design's own: the split products, the scratch written and read
        work = bound_ms(nbytes + 2 * sched.scratch_bytes,
                        steps * (8 * dh * dh + 6 * L * dh))
        fp32 = bound_ms(nbytes, 5 * steps * (dh * dh + dh), FP32_FLOPS)
        return fn, work, fp32

    def states_ms(args, state, sched):
        saved = {n: torch.empty(s, dtype=torch.float32, device=dev)
                 for n, s in mlstm.saved_shapes(*args[0].shape).items()}
        return timer.ms(lambda: mlstm.run_schedule(
            *args, sched, return_state=state, saved=saved))

    def many_launches(args, sched, label, n=100):
        """n launches with state in the serving build and in the training
        build (its saved tensors too), each the first's bits: the ring
        holds one owner's tiles a slot (``mlstm.stages_for``); a ring
        whose slots changed owner gave the backward's state pass, this
        kernel's shape, other bits now and then, then a launch failure."""
        for train in (False, True):
            def run():
                saved = ({n_: torch.empty(s_, dtype=torch.float32,
                                          device=dev)
                          for n_, s_ in mlstm.saved_shapes(
                              *args[0].shape).items()} if train else None)
                o, st = mlstm.run_schedule(*args, sched, return_state=True,
                                           saved=saved)
                return [o, *st.values(), *(saved.values() if train else ())]

            first = run()
            for _ in range(n - 1):
                again = run()
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(first, again)),
                      f"{label} ({'training' if train else 'serving'} "
                      f"build): launches differ")
            print(f"  {label}: {n} launches of the "
                  f"{'training' if train else 'serving'} build "
                  f"bit-identical ({sched.stages} ring stages)")

    def state_err(got, want, label):
        return max(compare(got[n], want[n], f"{label} {n} (fp32)",
                           atol=STATE_ATOL, rtol=STATE_RTOL)
                   for n in ("C", "n", "m"))

    for b, h, t, dh, state in ((1, 4, 2048, 1024, True),
                               (1, 4, 2048, 1024, False),
                               (4, 4, 512, 1024, True),
                               (2, 2, 1000, 128, True)):
        q, k, v = randn(b, h, t, dh), randn(b, h, t, dh), randn(b, h, t, dh)
        ig, fg = gates(b, h, t)
        args = (q, k, v, ig, fg)
        label = (f"mlstm_scan B={b} H={h} T={t} Dh={dh} "
                 f"{'with' if state else 'no'} state")
        sched = mlstm.schedule(b, h, t, dh)
        print(f"  {label}: schedule {sched.label}, {sched.smem_bytes} B of "
              f"shared memory, {sched.scratch_bytes} B of Q K^T scratch")
        got = mlstm.mlstm_scan(*args, return_state=state)
        want = ref.mlstm_scan(*args, return_state=state)
        case = dict(path=XLSTM if dh == 1024 else "ragged",
                    shape=[b, h, t, dh], state=state, schedule=sched.label,
                    chunk=sched.chunk, stages=sched.stages,
                    grid=list(sched.grid), qk_grid=sched.qk_grid)
        if state:
            case["max_abs_err"] = compare(got[0], want[0], label + " h")
            case["state_max_abs_err"] = state_err(got[1], want[1], label)
        else:
            case["max_abs_err"] = compare(got, want, label + " h")
        if not out:
            again = mlstm.mlstm_scan(*args, return_state=state)
            torch.cuda.synchronize()
            check(torch.equal(got[0], again[0]) and all(
                torch.equal(got[1][n], again[1][n]) for n in got[1]),
                f"{label}: two launches differ")
            print(f"  {label}: two launches bit-identical")
        if (b, t) == (4, 512):
            many_launches(args, sched, label)
        (bd, why), (wb, wwhy), (fb, fwhy) = bounds(b, h, t, dh, state,
                                                   sched)
        out.append(dict(
            case, ms=timer.ms(lambda: mlstm.mlstm_scan(
                *args, return_state=state)),
            states_ms=states_ms(args, state, sched),
            # a Python loop over T: about 15 launches a step
            plain_ms=timer.ms(lambda: ref.mlstm_scan(
                *args, return_state=state), n=3),
            library_ms=None, bound_ms=bd, bound_by=why,
            work_bound_ms=wb, work_bound_by=wwhy,
            fp32_bound_ms=fb, fp32_bound_by=fwhy))

    # padded: T = 600, the state taken at 437
    b, h, t, n, dh = 1, 4, 600, 437, 1024
    q, k, v = randn(b, h, t, dh), randn(b, h, t, dh), randn(b, h, t, dh)
    ig, fg = gates(b, h, t)
    pad = torch.arange(t, device=dev) >= n
    igp = ig.masked_fill(pad, float("-inf"))
    fgp = fg.masked_fill(pad, float("inf"))
    label = f"mlstm_scan B={b} H={h} T={t} Dh={dh} padded past {n}"
    sched = mlstm.schedule(b, h, t, dh)
    print(f"  {label}: schedule {sched.label}")
    got_h, got = mlstm.mlstm_scan(q, k, v, igp, fgp, return_state=True)
    cut = [x[:, :, :n].contiguous() for x in (q, k, v, ig, fg)]
    kern_h, kern = mlstm.mlstm_scan(*cut, return_state=True)
    check(all(torch.equal(got[x], kern[x]) for x in ("C", "n", "m"))
          and torch.equal(got_h[:, :, :n], kern_h),
          f"{label}: the padded scan's state differs from the kernel's "
          f"unpadded one")
    check(bool(torch.isfinite(got_h.float()).all()),
          f"{label}: non-finite h on the padded steps")
    want_h, want = ref.mlstm_scan(*cut, return_state=True)
    print(f"  {label}: state and h equal the kernel's unpadded scan's, "
          f"bit for bit")
    err = compare(got_h[:, :, :n], want_h, label + " h")
    serr = state_err(got, want, label + " against the plain unpadded scan")
    (bd, why), (wb, wwhy), (fb, fwhy) = bounds(b, h, t, dh, True, sched)
    padded = (q, k, v, igp, fgp)
    out.append(dict(
        path=XLSTM, shape=[b, h, t, dh], state=True, padded_from=n,
        schedule=sched.label, chunk=sched.chunk, stages=sched.stages,
        grid=list(sched.grid), qk_grid=sched.qk_grid,
        max_abs_err=err, state_max_abs_err=serr,
        ms=timer.ms(lambda: mlstm.mlstm_scan(*padded, return_state=True)),
        states_ms=states_ms(padded, True, sched),
        plain_ms=timer.ms(lambda: ref.mlstm_scan(*padded,
                                                 return_state=True), n=3),
        library_ms=None, bound_ms=bd, bound_by=why, work_bound_ms=wb,
        work_bound_by=wwhy, fp32_bound_ms=fb, fp32_bound_by=fwhy))
    return out


def mlstm_bwd_cases(dev, timer, randn):
    """The mLSTM backward kernels (``csrc/mlstm_bwd.cu``) against
    ``ref.mlstm_bwd`` (autograd through the plain scan, in checkpointed
    chunks, each step's denominator on the side the kernel's forward took:
    ``saved['den']``) on the training forward's saved tensors, dh ~ N(0,
    1), the
    outputs NaN-filled first: dq, dk, dv in bf16 by phase 2's rule, di
    and df in fp32 within GATE_SHARE * (max|plain| + |plain|), the
    largest share printed; two launches bit-identical (100 at (4, 4, 512,
    1024)).  Shapes: the train
    path's microbatch (16, 4, 128, 1024), four sequences of 512 (4, 4,
    512, 1024), xlstm-1.3b's widest prefill (1, 4, 2048, 1024), a ragged
    (2, 2, 1000, 128) and (1, 4, 600, 1024), not a multiple of the
    chunk.  Three bounds: ``bound_ms`` the function's
    own, 8 Dh^2 + 10 L Dh operations a step and head at the bf16 rate or
    the bytes of its inputs and outputs; ``states_bound_ms`` with the
    saved states read once beside them; ``work_bound_ms`` this design's,
    the split products' 16 Dh^2 + 16 L Dh operations and the state
    gradient of every chunk but the last written once and read once.
    ``states_ms`` is the training forward's time at the shape.  Each row
    is profiled by kernel (``kernels_ms``, each call prepared as for
    ``ms``); ``gap_ms`` is ``ms`` less the kernels' sum, ``span_ms`` a
    call's first kernel start to last kernel end, ``idle_ms`` the
    device's idle time inside it (the three None where the profiler,
    asked up to PROFILE_TRIES times, reported none or no whole call),
    ``host_ms`` the host's time to enqueue a call.  No single PyTorch
    call computes this gradient."""
    from repro_torch.kernels import mlstm, ref

    out = []
    gen = torch.Generator(device=dev).manual_seed(79)
    nan = float("nan")
    for path, (b, h, t, dh) in ((XLSTM_TRAIN, (16, 4, 128, 1024)),
                                (XLSTM, (4, 4, 512, 1024)),
                                (XLSTM, (1, 4, 2048, 1024)),
                                ("ragged", (2, 2, 1000, 128)),
                                (XLSTM, (1, 4, 600, 1024))):
        q, k, v = randn(b, h, t, dh), randn(b, h, t, dh), randn(b, h, t, dh)
        ig = torch.randn((b, h, t), generator=gen, device=dev)
        fg = torch.randn((b, h, t), generator=gen, device=dev) + 3.0
        args = (q, k, v, ig, fg)
        dy = randn(b, h, t, dh)
        sched = mlstm.bwd_schedule(b, h, t, dh)
        label = f"mlstm_scan_bwd B={b} H={h} T={t} Dh={dh}"
        print(f"  {label}: schedule {sched.label}, shared memory "
              f"{sched.prep_smem_bytes}/{sched.state_smem_bytes}/"
              f"{sched.grad_smem_bytes} B, {sched.scratch_bytes} B of "
              f"scratch ({sched.grad_state_bytes} B of end-gradients)")
        _, saved = mlstm._forward(*args, return_state=False, train=True)
        grads = tuple(torch.full_like(x, nan) for x in args)
        scratch = torch.full((sched.scratch_bytes // 4,), nan, device=dev)
        got = mlstm.mlstm_scan_bwd(*args, saved, dy, grads=grads,
                                   scratch=scratch)
        want = ref.mlstm_bwd(*args, dy, branch=saved["den"][..., 1])
        # where a gradient breaks the rule: its (b, h, t) rows by chunk and
        # head
        for j, n in enumerate("qkv"):
            over = ((got[j].float() - want[j].float()).abs() > ATOL + RTOL
                    * want[j].float().abs()).any(-1).nonzero()
            if len(over):
                print(f"  {label} d{n}: the rule broken in {len(over)} "
                      f"(b, h, t) rows: chunks "
                      f"{sorted(set((over[:, 2] // sched.chunk).tolist()))}"
                      f", heads {sorted(set(over[:, 1].tolist()))}, "
                      f"batches {sorted(set(over[:, 0].tolist()))}")
        err = max(compare(got[j], want[j], f"{label} d{n}")
                  for j, n in enumerate("qkv"))
        gate_err = max(compare(
            got[j], want[j], f"{label} d{n} (fp32)",
            atol=GATE_SHARE * float(want[j].abs().max()), rtol=GATE_SHARE)
            for j, n in ((3, "i"), (4, "f")))
        del want
        # at the (4, 4, 512, 1024) row 100 launches (the state pass's
        # buffers and ring cycled many times: a ring race once showed as
        # other bits now and then), elsewhere two
        launches = 100 if (b, t) == (4, 512) else 2
        for _ in range(launches - 1):
            again = mlstm.mlstm_scan_bwd(*args, saved, dy)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{label}: launches differ")
        print(f"  {label}: {launches} launches bit-identical")
        del got, again, scratch
        steps, L, nc = b * h * t, sched.chunk, sched.n_chunks
        # q, k, v, dh read and dq, dk, dv written in bf16, the gates read
        # and their gradients written in fp32
        io = 14 * steps * dh + 16 * steps
        states = 4 * b * h * nc * (dh + 1) * dh
        fn = bound_ms(io, steps * (8 * dh * dh + 10 * L * dh))
        st = bound_ms(io + states + 4 * steps * dh + 8 * steps,
                      steps * (8 * dh * dh + 10 * L * dh))
        work = bound_ms(io + states + 4 * steps * dh + 8 * steps
                        + 2 * sched.grad_state_bytes,
                        steps * (16 * dh * dh + 16 * L * dh))
        ms = timer.ms(lambda: mlstm.mlstm_scan_bwd(*args, saved, dy))
        split, span, idle, host = mlstm_bwd_kernel_split(
            mlstm, timer, args, saved, dy)
        # not measured (None) where the profiler reported no launch of
        # one of the four kernels
        gap = ms - sum(split.values()) if len(split) == 4 else None
        print(f"  {label}: {ms} ms a call; device ms by kernel (profiler, "
              f"each call as timed, mean of 5): {split}; ms less their sum "
              f"{gap}; a call's span {span} ms, the device idle inside it "
              f"{idle} ms; the host enqueues a call in {host:.4f} ms "
              f"(behind the timer's device-side wait)")
        out.append(dict(
            path=path, shape=[b, h, t, dh], schedule=sched.label,
            max_abs_err=err, gate_max_abs_err=gate_err, bit_identical=True,
            kernels_ms=split, gap_ms=gap, span_ms=span, idle_ms=idle,
            host_ms=host,
            ms=ms,
            states_ms=timer.ms(lambda: mlstm._forward(
                *args, return_state=False, train=True)),
            # autograd through a Python loop over T: up to 10 s a call,
            # so one timed call after the warm-up
            plain_ms=timer.ms(lambda: ref.mlstm_bwd(*args, dy), n=1),
            library="none: no one call runs this recurrence's gradient",
            library_ms=None, bound_ms=fn[0], bound_by=fn[1],
            states_bound_ms=st[0], states_bound_by=st[1],
            work_bound_ms=work[0], work_bound_by=work[1]))
        del saved
        torch.cuda.empty_cache()
    return out


def mlstm_bwd_kernel_split(mlstm, timer, args, saved, dy):
    """The mLSTM backward's four kernels under the profiler, 5 calls each
    prepared as :meth:`Timer.ms` prepares one (the L2 flushed, then a
    device-side wait while the host enqueues): device ms by kernel (the
    mean over the launches the profiler reports: it drops a few of the
    20, and has once dropped them all, so a profile with no whole call is
    taken again, up to :data:`PROFILE_TRIES` times); a call's span, first
    kernel's start to last kernel's end, and the device's idle ms inside
    it (means over the calls whose four kernels it reports, told apart by
    the wait between calls; None where no profile held a whole call); the
    host's ms to enqueue a call (median)."""
    mlstm.mlstm_scan_bwd(*args, saved, dy)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_TRIES + 1):
        host = []
        with torch.profiler.profile(activities=acts) as prof:
            # a wait first: the events the profiler drops are the first
            torch.cuda._sleep(2_000_000)
            for _ in range(5):
                timer.flush.zero_()
                torch.cuda._sleep(2_000_000)
                t0 = time.perf_counter()
                mlstm.mlstm_scan_bwd(*args, saved, dy)
                host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        durs, spans = {}, []
        for ev in prof.profiler.kineto_results.events():
            m = re.search(r"mlstm_bwd_(\w+?)_kernel", ev.name())
            if ev.device_type() == torch.autograd.DeviceType.CUDA and m:
                durs.setdefault(m.group(1), []).append(
                    ev.duration_ns() / 1e6)
                spans.append((ev.start_ns(),
                              ev.start_ns() + ev.duration_ns()))
        spans.sort()
        # a call's kernels follow each other within microseconds; calls
        # are a millisecond's wait apart
        calls = []
        for sp in spans:
            if not calls or sp[0] - calls[-1][-1][1] > 300_000:
                calls.append([])
            calls[-1].append(sp)
        whole = [c for c in calls if len(c) == 4]
        print(f"    profiler (profile {attempt}): {len(spans)} of 20 "
              f"kernels reported, {len(whole)} of 5 calls whole")
        if whole:
            break
    split = {k: statistics.mean(v) for k, v in durs.items()}
    if not whole:
        print(f"    profiler: no whole call in {PROFILE_TRIES} profiles: "
              f"span and idle not measured")
        return split, None, None, statistics.median(host)
    span = statistics.mean(c[-1][1] - c[0][0] for c in whole) / 1e6
    idle = statistics.mean(sum(b[0] - a[1] for a, b in zip(c, c[1:]))
                           for c in whole) / 1e6
    return split, span, idle, statistics.median(host)


# ---------------------------------------------------------------------------
# phases 3, 4a, 5, 7 and 9: serve a model at full width
# ---------------------------------------------------------------------------

KERNEL_RE = {"gemm": r"(^|::)gemm_kernel\b",
             "flash_attention": r"(^|::)flash_kernel\b",
             # one call: D = rowsum(dO o), then dK/dV and the splits' sum
             # (MQA) beside dQ
             "flash_attention_bwd":
                 r"(^|::)(dsum|dkdv|split_sum|dq)_kernel\b",
             "fused_mlp": r"(^|::)fused_mlp_kernel\b",
             "rg_lru_scan": r"(^|::)rg_lru_kernel\b",
             "rg_lru_scan_bwd": r"(^|::)rg_lru_bwd_kernel\b",
             "gemm_act": r"(^|::)gemm_act_kernel\b",
             # one call: the Q K^T kernel, then the chunkwise scan
             "mlstm_scan": r"(^|::)mlstm_(qk|scan)_kernel\b",
             # one call: prep, the state pass (dV), the gradients (dQ,
             # dK), the gates
             "mlstm_scan_bwd":
                 r"(^|::)mlstm_bwd_(prep|state|grad|gate)_kernel\b"}
# the prefill plan's executors on each path: the gated MLPs are served
# with ftl_mode="fused", granite's ungated one with "auto", where the
# planner's partial schedule binds the partial-MLP kernels
_PREFILL = {"gemm": "cuda_gemm", "attention": "cuda_flash_attention"}
# (xlstm-1.3b has no plannable block: no plan, no executors)
WANT_EXECUTORS = {LLAMA: {**_PREFILL, "mlp": "cuda_fused_mlp"},
                  # the report of qwen2-moe-a2.7b's plan: its MoE layers run
                  # no planned segment (the model takes a plan only for a
                  # layer with an MLP), so the bound GEMM never launches
                  MOE: {**_PREFILL, "mlp": "cuda_fused_mlp"},
                  RG: {**_PREFILL, "mlp": "cuda_fused_mlp"},
                  GRANITE: {**_PREFILL, "mlp": "cuda_partial_mlp"},
                  XLSTM: None,
                  # the report of whisper-base's plan (its decoder block):
                  # the model plans no encoder–decoder block, as the
                  # reference, and each MLP resolves its own executor
                  WHISPER: {**_PREFILL, "mlp": "cuda_partial_mlp"},
                  VLM: {**_PREFILL, "mlp": "cuda_fused_mlp"}}
# launches each prefill and each decode step must make, where the path
# fixes the count: qwen2-moe-a2.7b's 24 attention layers at prefill and
# its shared experts, one fused MLP a layer, at prefill and decode; one
# RG-LRU scan in each of recurrentgemma-9b's 26 recurrent layers and one
# mLSTM scan in each of the served xlstm-1.3b's 21 mLSTM layers at
# prefill; the served llama-3.2-vision-90b's 8 self- and 2 cross-attention
# layers at prefill (a decode step's attention is the plain masked one)
# and its 10 MLPs at prefill and decode; whisper-base's follow from its
# MLP bindings (encdec_launches)
PER_CALL = {MOE: {"flash_attention": (24, 0), "fused_mlp": (24, 24)},
            RG: {"rg_lru_scan": (26, 0)}, XLSTM: {"mlstm_scan": (21, 0)},
            VLM: {"flash_attention": (10, 0), "fused_mlp": (10, 10)}}
# kernels a path's serving run must not launch: qwen2-moe-a2.7b and
# llama-3.2-vision-90b run their projections as plain matmuls (a prefill
# takes the plan for an MLP alone), and neither has a GEMM in its MLP
ABSENT = {MOE: ("gemm",), VLM: ("gemm",)}


def requests(cfg, lens_range, seed: int = 0):
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(lens_range[0], lens_range[1] + 1, size=8)
    return [Request(i, rng.integers(2, cfg.vocab_size, size=int(n))
                    .astype(np.int32), 32) for i, n in enumerate(lens)]


def load_model(arch: str, dev, mode: str, **cut):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), ftl_mode=mode, **cut)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in M.tree_leaves(params))
    width = (f"mLSTM head_dim {cfg.xlstm_expand * cfg.d_model // cfg.n_heads}"
             if cfg.family == "ssm" else f"head_dim {cfg.resolved_head_dim}")
    ffn = (f"{cfg.n_experts} experts of {cfg.moe_d_ff}, top-"
           f"{cfg.n_experts_per_token}, shared MLP {cfg.shared_d_ff}"
           if cfg.is_moe else f"d_ff {cfg.d_ff}")
    print(f"  {arch}: {cfg.n_layers} layers {M.period_kinds(cfg)}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, {width}, "
          f"{ffn} ({cfg.mlp_act}), vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters "
          f"({n_bytes / 1e9} GB) initialised in "
          f"{time.perf_counter() - t0} s")
    return cfg, params, n_params


def serve_phase(dev, cfg, params, modules, *, max_seq: int, lens_range,
                want: dict | None, per_call: dict | None = None,
                absent: dict | None = None, extras: dict | None = None):
    """Serve 8 requests (4 slots, 32 new tokens each) twice: under the
    profiler with every launch counter of ``modules`` and ``absent`` set
    to 0 just before and read just after, then unprofiled for the serving
    times.  ``want``: the prefill plan's executors (None: no plannable
    block); ``per_call``: launches each prefill and each decode step must
    make, by kernel, as (prefill, decode step), counted after the block
    plan's execution; ``absent``: kernels whose launch counter must stay
    0 in the serving run (the block plan's execution aside); ``extras``:
    the model inputs every request shares (frames, image embeddings).  The
    block plan is executed once in each run, as the serve CLI does, where
    the model runs the plan: not a MoE (a MoE layer takes no plan; the
    model plans only a layer with an MLP) and not an encoder–decoder (it
    plans no block, as the reference: each MLP resolves its own
    executor), whose plans would launch GEMMs their paths never run.
    Returns the launches the gates read: the path's kernels' over the
    whole window, the absent kernels' in the serving run."""
    from repro_torch.core import hw
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import model as M

    eng = ServeEngine(cfg, params, batch_slots=4, max_seq=max_seq,
                      block_size=16, target=hw.H100, eos_id=-1, device=dev)
    kv = eng.kv.pool if eng.paged else eng.cache
    kv_bytes = sum(t.numel() * t.element_size() for t in M.tree_leaves(kv))
    print(f"  engine: 4 slots, max_seq {max_seq}, "
          f"{'paged KV pool' if eng.paged else 'dense per-slot cache'} "
          f"{kv_bytes / 1e9} GB, buckets {list(eng.buckets)}")
    rep = eng.plan_report()
    for phase in ("prefill", "decode"):
        e = rep[phase]
        if e is None:
            print(f"  plan {phase}: no plannable block")
            continue
        print(f"  plan {phase} @ m={e['m']} on {rep['target']}: schedule "
              f"{e['schedule']}, cuts {e['cuts']}, executors "
              f"{e['executors']}")
    got = rep["prefill"] and rep["prefill"]["executors"]
    check(got == want, f"prefill executors {got} != {want}")
    t0 = time.perf_counter()
    eng.warmup_compile(extras)
    print(f"  warm-up (every bucket's prefill, one decode step) "
          f"{time.perf_counter() - t0} s")

    # --- the main path: counters from 0, under the profiler -------------
    absent = absent or {}
    runs_plan = not (cfg.is_moe or cfg.is_encoder_decoder)
    for mod in (*modules.values(), *absent.values()):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    s0 = dict(eng.stats)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        blk = eng.execute_block_plan() if runs_plan else None
        in_plan = {n: mod.launches
                   for n, mod in (*modules.items(), *absent.items())}
        done = eng.run(requests(cfg, lens_range), extras)
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = {n: mod.launches for n, mod in modules.items()}
    gone = {n: mod.launches - in_plan[n] for n, mod in absent.items()}
    prefills = eng.stats["prefills"] - s0["prefills"]
    steps = eng.stats["decode_steps"] - s0["decode_steps"]
    print(f"  main path launches: {launches} (the block plan's execution "
          f"{in_plan})" + (f"; kernels off the path, in the serving run: "
                           f"{gone}" if absent else ""))
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(not any(gone.values()), f"a kernel off the path launched: {gone}")
    for name, (pre, step) in (per_call or {}).items():
        served = launches[name] - in_plan[name]
        check(served == pre * prefills + step * steps,
              f"{name}: {served} launches in {prefills} prefills and "
              f"{steps} decode steps, not {pre} a prefill and {step} a "
              f"decode step")
    if want is None:
        check(blk is None, f"a block plan ran without a plannable block: "
              f"{blk}")
    elif not runs_plan:
        print(f"  the plan is reported ({got}) but the model runs no "
              f"plan: execute_block_plan not called")
    else:
        check(blk is not None and blk["finite"] and blk["executors"] == want,
              f"block plan execution: {blk}")
    check(len(done) == 8 and all(len(r.out) == 32 for r in done),
          "every request must return 32 tokens: "
          f"{[(r.rid, len(r.out)) for r in done]}")
    print(f"  prompt lengths {sorted(len(r.prompt) for r in done)}, buckets "
          f"{sorted(r.bucket for r in done)}")

    # the profiler's raw events: building its event tree over xlstm-1.3b's
    # 1.7 million device kernels (and their host events) takes a quarter
    # of an hour
    kern = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            k = kern.setdefault(ev.name(), [0, 0.0])
            k[0] += 1
            k[1] += ev.duration_ns() / 1e6
    check(bool(kern), "the profiler recorded no device kernel")
    # (where the block plan's execution launched an absent kernel, its
    # counter alone tells the serving run's launches apart)
    for name in absent:
        check(in_plan[name] > 0 or not any(re.search(KERNEL_RE[name], n)
                                           for n in kern),
              f"{name} kernel in the profiler's device-kernel list")
    for name in modules:
        hits = [n for n in kern if re.search(KERNEL_RE[name], n)]
        check(bool(hits), f"{name} kernel missing from the profiler's "
              f"device-kernel list")
        print(f"  profiler: {name}: {sum(kern[h][0] for h in hits)} "
              f"launches, {sum(kern[h][1] for h in hits)} ms on the device")
    busy = sum(v[1] for v in kern.values())
    print("  profiler: top device kernels (ms, count): " + "; ".join(
        f"{n[:60]} {v[1]} ms x{v[0]}" for n, v in
        sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]))
    print(f"  profiler: device kernel time {busy} ms of {prof_wall_ms} ms "
          f"wall in the profiled run: device busy {busy / prof_wall_ms}")
    print(f"  profiler: {sum(v[0] for v in kern.values())} device kernels "
          f"launched in the profiled run ({'one' if blk else 'no'} "
          f"execute_block_plan call, {prefills} prefills, "
          f"{eng.stats['decode_steps'] - s0['decode_steps']} decode steps)")
    del prof

    # --- serving times, unprofiled ---------------------------------------
    blk = eng.execute_block_plan() if runs_plan else None
    s0 = dict(eng.stats)
    t0 = time.perf_counter()
    done = eng.run(requests(cfg, lens_range, seed=1), extras)
    wall = time.perf_counter() - t0
    check(len(done) == 8 and all(len(r.out) == 32 for r in done),
          "timed run: every request must return 32 tokens")
    tokens = sum(len(r.out) for r in done)
    steps = eng.stats["decode_steps"] - s0["decode_steps"]
    step_ms = 1e3 * (eng.stats["decode_s"] - s0["decode_s"]) / steps
    ttft = statistics.median(r.ttft_s for r in done)
    if blk is not None:
        print(f"  block plan executed @ m={max_seq}: {blk['ms']} ms, "
              f"executors {blk['executors']}")
    print(f"  served 8 requests, {tokens} tokens in {wall} s: "
          f"{tokens / wall} tokens/s; time to first token p50 "
          f"{1e3 * ttft} ms; {steps} decode steps, {step_ms} ms each; "
          f"{eng.stats['prefills'] - s0['prefills']} "
          f"prefills in {eng.stats['prefill_s'] - s0['prefill_s']} s")
    print(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9}"
          f" GB")
    pc = eng.plans.counters()
    print(f"  plan cache {pc}; decode replans {eng.stats['replans']}; "
          f"non-finite logits rows {eng.stats['nonfinite_logits']}")
    check(eng.stats["replans"] == 0 and pc["misses_after_warmup"] == 0,
          "steady state replanned")
    check(eng.stats["nonfinite_logits"] == 0, "non-finite logits")
    return {**launches, **gone}


# ---------------------------------------------------------------------------
# phases 4, 4b, 6, 8 and 10: the served path against the plain path, the
# engine against the model, xlstm-1.3b's forward against its decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_vs_plain(cfg, params, dev, n_tokens: int,
                    extras: dict | None = None):
    from repro_torch.models import model as M

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        size=(1, n_tokens)), device=dev)
    batch = {"tokens": toks, **(extras or {})}
    served, _ = M.prefill(cfg, params, batch)
    plain, _ = M.prefill(dataclasses.replace(cfg, ftl_mode="off"), params,
                         batch)
    _logits_agree(served, plain, f"prefill {n_tokens} tokens, "
                  f"{cfg.ftl_mode} against plain")


@torch.no_grad()
def _model_greedy(cfg, params, dev, tokens: np.ndarray, n_new: int,
                  max_seq: int, last_pos: int | None = None,
                  extras: dict | None = None):
    """The model's own greedy prefill + decode_step loop on one prompt:
    (tokens, top-2 logit gaps).  The token is ``torch.argmax``'s, the
    first of equal logits, as the engine (and the JAX reference's engine)
    picks it; ``torch.topk`` leaves the order of equal values open."""
    from repro_torch.models import model as M

    t = torch.as_tensor(tokens, device=dev)[None].long()
    logits, cache = M.prefill(cfg, params, {"tokens": t, **(extras or {})},
                              max_seq=max_seq, last_pos=last_pos)
    pos = len(tokens) if last_pos is None else last_pos + 1
    out, gaps = [], []
    for i in range(n_new):
        top2 = torch.topk(logits[0, -1].float(), 2)
        out.append(int(torch.argmax(logits[0, -1])))
        gaps.append(float(top2.values[0] - top2.values[1]))
        if i + 1 < n_new:
            logits, cache = M.decode_step(
                cfg, params, torch.tensor([[out[-1]]], device=dev), cache,
                torch.tensor(pos + i, device=dev))
    return out, gaps


@torch.no_grad()
def engine_vs_model(cfg, params, dev, n_prompt: int, n_new: int = 8, *,
                    max_seq: int = 4096, padded_loop: bool = False,
                    extras: dict | None = None):
    """The engine's greedy tokens for one prompt (padded to its bucket)
    against the model's own prefill + decode_step loop on the unpadded
    prompt.  ``padded_loop`` (xlstm-1.3b) also holds them against the
    model's loop on the padded bucket with ``last_pos``, which runs the
    engine's GEMM shapes: the random-weight stack amplifies a GEMM's
    rounding difference about 1.3 times a layer (PERF.md), so that gate
    holds the engine's slot plumbing apart from any rounding.  ``extras``:
    the model inputs the engine shares with every request (frames, image
    embeddings), given to the loop's prefill too."""
    from repro_torch.core import hw
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import model as M

    rng = np.random.default_rng(11)
    prompt = rng.integers(2, cfg.vocab_size, size=n_prompt).astype(np.int32)
    eng = ServeEngine(cfg, params, batch_slots=1, max_seq=max_seq,
                      target=hw.H100, eos_id=-1, device=dev)
    check(n_prompt not in eng.buckets, f"{n_prompt} is a bucket length")
    got = eng.run([Request(0, prompt, n_new)], extras)[0].out
    bucket = M.bucket_m(n_prompt, eng.buckets)
    want, gaps = _model_greedy(cfg, params, dev, prompt, n_new, max_seq,
                               extras=extras)
    print(f"  {n_prompt}-token prompt (bucket {bucket}, window "
          f"{cfg.local_window}): engine {got}, model loop on the unpadded "
          f"prompt {want} ({'equal' if got == want else 'DIFFER'}); the "
          f"loop's top-2 logit gaps {gaps}")
    if padded_loop:
        padded = np.zeros(bucket, np.int32)
        padded[:n_prompt] = prompt
        on_pad, _ = _model_greedy(cfg, params, dev, padded, n_new, max_seq,
                                  last_pos=n_prompt - 1, extras=extras)
        print(f"  model loop on the padded bucket, last_pos "
              f"{n_prompt - 1}: {on_pad} "
              f"({'equal' if got == on_pad else 'DIFFER'})")
        check(got == on_pad, "the engine's greedy tokens differ from the "
              "model's own loop on the padded prompt")
    check(got == want, "the engine's greedy tokens differ from the model's "
          "own prefill + decode loop on the unpadded prompt")


def _route_spy(moe, rec: list):
    """``moe.route`` that appends each call's choices and whether each
    slot was kept, (tokens, k, 2), to ``rec``."""
    real = moe.route

    def spy(cfg_, p, xf):
        probs, gate, idx = real(cfg_, p, xf)
        g, n, k = idx.shape
        _, _, keep, _ = moe._slots(idx.reshape(g, n * k), cfg_.n_experts,
                                   moe.capacity(n, cfg_))
        rec.append(torch.stack([idx, keep.view(g, n, k).long()], -1)
                   .reshape(g * n, k, 2))
        return probs, gate, idx

    return spy


def _route_replay(moe, rec: list):
    """``moe.route`` that takes each call's choices from ``rec`` (a
    ``_route_spy`` record, in call order) and its gate values from this
    path's own router at those choices, renormalised as ``route`` does:
    the kept slots follow from the choices, so they are ``rec``'s too."""
    real = moe.route
    calls = iter(rec)

    def replay(cfg_, p, xf):
        probs, _, _ = real(cfg_, p, xf)
        idx = next(calls)[..., 0].reshape(*probs.shape[:-1], -1)
        gate = probs.gather(-1, idx)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

    return replay


@torch.no_grad()
def moe_served_vs_plain(cfg, params, dev, n_tokens: int):
    """qwen2-moe-a2.7b's served path (its shared experts on the fused-MLP
    kernel) against the plain path (``ftl_mode='off'``) on one prompt.

    Layer by layer on the plain stream's own input: the attention's delta
    on the layer's input (the flash kernel on both paths: ``ftl_mode``
    picks the MLP's executor only), then the MoE's delta (routed experts
    and the shared MLP) on the plain path's attention output, each within
    phase 2's rule of the plain delta, with no residual in either; both
    paths must route that input alike.  Then ``forward`` end to end twice.
    Routed freely, a near tie in the fp32 router may fall either way
    after layer 0: the (token, slot) pairs that differ over every layer
    (the expert chosen or whether the slot was kept) are counted and
    their share held to MOE_SWAP_LIMIT.  Routed as the plain path chose
    (``_route_replay``), the served logits of every token must agree with
    the plain ones as ``_logits_agree`` has it."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        size=(1, n_tokens)), device=dev)
    positions = torch.arange(n_tokens, device=dev)
    off = dataclasses.replace(cfg, ftl_mode="off")

    worst = {"attention": 0.0, "moe": 0.0}
    for kind, p, x_in, _, _ in M.layer_stream(off, params, toks):
        mix = [M._apply_mixer(c, p, kind, x_in, positions=positions)
               for c in (cfg, off)]
        h = x_in + mix[1]
        ffn = []
        for c in (cfg, off):
            rec = []
            with mock.patch.object(moe, "route", _route_spy(moe, rec)):
                d, _ = M._apply_ffn(c, p, h)
            ffn.append((d, rec[0]))
        check(torch.equal(ffn[0][1], ffn[1][1]), "a layer routes the same "
              "input differently on the served and the plain path")
        worst["attention"] = max(worst["attention"], rule_share(*mix))
        worst["moe"] = max(worst["moe"], rule_share(ffn[0][0], ffn[1][0]))
    print(f"  every layer on the plain stream's input: the same routing on "
          f"both paths; largest share of {ATOL} + {RTOL}|plain delta| used "
          f"by the served delta {worst}")
    check(max(worst.values()) <= 1.0, "a layer's served delta differs from "
          "its plain delta beyond tolerance")

    def routed(c, route):
        rec = []
        with mock.patch.object(moe, "route", route(moe, rec)):
            logits, aux = M.forward(c, params, {"tokens": toks})
        return logits[0], aux, rec

    plain, aux_p, rp = routed(off, _route_spy)
    _, aux_s, rs = routed(cfg, _route_spy)
    check(len(rs) == len(rp) == cfg.n_layers,
          f"{len(rs)} and {len(rp)} routed layers, not {cfg.n_layers}")
    diff = torch.stack([(a != b).any(-1) for a, b in zip(rs, rp)])
    per_layer = diff.float().mean((1, 2)).tolist()
    swapped = float(diff.float().mean())
    print(f"  forward of {n_tokens} tokens routed freely, {cfg.ftl_mode} "
          f"against plain: (token, slot) routing pairs that differ, by "
          f"layer: {[round(x, 5) for x in per_layer]}; over all {swapped} "
          f"(limit {MOE_SWAP_LIMIT}); the summed router aux {float(aux_s)} "
          f"against {float(aux_p)}")
    check(per_layer[0] == 0.0, "layer 0 routes the same input differently")
    check(swapped <= MOE_SWAP_LIMIT, f"routing differs in {swapped} of the "
          f"(token, slot) pairs")
    served, aux_r, _ = routed(cfg, lambda m, _: _route_replay(m, rp))
    print(f"  forward routed as the plain path chose: the summed router aux "
          f"{float(aux_r)} against {float(aux_p)}")
    _logits_agree(served, plain, f"forward of {n_tokens} tokens, "
                  f"{cfg.ftl_mode} against plain, routed alike")


def rule_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest share of phase 2's rule, ATOL + RTOL * |want|, that
    |got - want| uses."""
    d = (got.float() - want.float()).abs()
    return float((d / (ATOL + RTOL * want.float().abs())).max())


def model_extras(cfg, dev) -> dict:
    """The stub frontends' inputs every request shares, N(0, 1) from a
    numpy seed, batch 1: whisper's frame embeddings, the VLM's image
    embeddings."""
    rng = np.random.default_rng(3)
    if cfg.is_encoder_decoder:
        name, n = "frames", cfg.encoder_seq
    elif cfg.family == "vlm":
        name, n = "image_embeds", cfg.n_image_tokens
    else:
        return {}
    x = rng.standard_normal((1, n, cfg.d_model), dtype=np.float32)
    return {name: torch.from_numpy(x).to(dev, torch.bfloat16)}


def encdec_launches(cfg, dev, buckets) -> dict:
    """whisper-base's launches a prefill and a decode step, from the MLP
    bindings its layers resolve (the model plans no encoder–decoder
    block, as the reference: each MLP resolves its executor at its own M
    under the config's mode on the default target).  Flash attention runs
    every encoder layer and each decoder layer's self- and
    cross-attention at prefill; a decode step's attention is the plain
    masked attention (the cross-attention's too, as in the reference).
    The partial MLP (``gemm_act``, then ``gemm``) runs in each layer
    whose M binds ``cuda_partial_mlp``: every decoder layer (checked at
    M = 1 and every bucket), and the encoder's only if its M does."""
    from repro_torch.core import hw
    from repro_torch.core.ftl import registry

    def bound(m):
        return registry.mlp_executor(
            cfg.ftl_mode, m=m, d_model=cfg.d_model, d_ff=cfg.d_ff,
            dtype=cfg.dtype, gated=cfg.mlp_gated, act=cfg.mlp_act,
            device=dev).name

    dec = {m: bound(m) for m in (1, *buckets)}
    enc = bound(cfg.encoder_seq)
    print(f"  MLP bindings on {hw.default_target().name} under "
          f"ftl_mode={cfg.ftl_mode}: the encoder's (M = {cfg.encoder_seq}) "
          f"{enc}; the decoder's by M {dec}")
    check(set(dec.values()) == {"cuda_partial_mlp"},
          f"a decoder MLP binds no partial MLP: {dec}")
    n, n_enc = cfg.n_layers, cfg.n_encoder_layers
    pre = n + (n_enc if enc == "cuda_partial_mlp" else 0)
    return {"flash_attention": (n_enc + 2 * n, 0), "gemm_act": (pre, n),
            "gemm": (pre, n)}


@torch.no_grad()
def encdec_served_vs_plain(cfg, params, dev, frames, n_tokens: int):
    """whisper-base's served path (``cfg.ftl_mode``) against the plain
    path on one prompt padded to its bucket, as the engine prefills it
    (the planner binds the partial MLP at a bucket's M, and the unfused
    chain at 200), by phase 2's rule.  The encoder's output against the
    plain path's (``ftl_mode='off'`` with ``ops.attention``'s plain
    version; the encoder's MLP binds the unfused chain under both modes,
    so this holds its six flash attentions).  Each layer's MLP delta,
    without the residual, on the plain stream's own input against
    ``ftl_mode='off'``'s.  Each attention on that stream, every encoder
    layer's and each decoder layer's self- and cross-attention (to the
    plain encoder's output), against ``ops.attention``'s plain version.
    The prefill's logits at the prompt's last token are held by
    ``_logits_agree``, as every served path's: six decoder layers carry
    the MLP's rounding (each delta within 0.16 of the rule) to 1.27 of it
    at a logit of 0.23 on the card (0.031 apart), so the rule's share is
    printed, not gated."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention_layer, norm

    rng = np.random.default_rng(7)
    bucket = M.bucket_m(n_tokens)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n_tokens] = rng.integers(2, cfg.vocab_size, size=n_tokens)
    toks = torch.as_tensor(padded, device=dev)
    off = dataclasses.replace(cfg, ftl_mode="off")
    enc = M._encode(cfg, params, frames)
    with plain_ops(("attention",)):
        enc_p = M._encode(off, params, frames)
    compare(enc, enc_p, f"encoder output over {frames.shape[1]} frames, "
            f"{cfg.n_encoder_layers} layers, {cfg.ftl_mode} against plain")
    pos_f = torch.arange(frames.shape[1], device=dev)
    pos_t = torch.arange(bucket, device=dev)
    worst = {}

    def walk(stack, x, steps):
        """Each layer's steps on the plain stream from ``x``: (name, delta
        fn, is the attention)."""
        for pp in M._periods(stack):
            p = pp["pos0"]
            for name, fn, attn in steps:
                want = fn(off, p, x)
                if attn:
                    with plain_ops(("attention",)):
                        got, want = want, fn(off, p, x)
                else:
                    got = fn(cfg, p, x)
                worst[name] = max(worst.get(name, 0.0),
                                  rule_share(got, want))
                x = x + (got if attn else want)

    x = frames + M._sinusoid(frames.shape[1], cfg.d_model,
                             device=dev).to(frames.dtype)
    walk(params["enc_layers"], x, (
        ("encoder attention, kernel against plain",
         lambda c, p, x: attention_layer(
             c, p["attn"], norm(p["ln1"], x, c.norm), positions=pos_f,
             causal=False, use_rope=False), True),
        (f"encoder MLP, {cfg.ftl_mode} against off",
         lambda c, p, x: M._apply_ffn(c, p, x)[0], False)))
    walk(params["layers"], M._dec_embed(off, params, toks), (
        ("self-attention, kernel against plain",
         lambda c, p, x: M._dec_self(c, p, x, pos_t), True),
        ("cross-attention, kernel against plain",
         lambda c, p, x: M._dec_cross(c, p, x, enc_p, pos_t), True),
        (f"decoder MLP, {cfg.ftl_mode} against off",
         lambda c, p, x: M._apply_ffn(c, p, x)[0], False)))
    print(f"  every layer on the plain stream's input ({n_tokens}-token "
          f"prompt padded to {bucket}): largest share of {ATOL} + "
          f"{RTOL}|plain delta| used by the served delta {worst}")
    check(max(worst.values()) <= 1.0, "a layer's served delta differs "
          "from its plain delta beyond tolerance")
    batch = {"tokens": toks, "frames": frames}
    served, _ = M.prefill(cfg, params, batch, last_pos=n_tokens - 1)
    want, _ = M.prefill(off, params, batch, last_pos=n_tokens - 1)
    print(f"  the logits' largest share of phase 2's rule "
          f"{rule_share(served, want)} (not gated)")
    _logits_agree(served, want, f"prefill of {n_tokens} tokens in bucket "
                  f"{bucket}, {cfg.ftl_mode} against off")


@torch.no_grad()
def cross_vs_plain(cfg, params, dev, image, n_tokens: int):
    """The VLM's cross layers on the plain stream's own input (``forward``
    under ``ftl_mode='off'`` with ``ops.attention``'s plain version): each
    layer's ungated output o, the flash kernel's against the plain
    attention's, by phase 2's rule."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention_layer, norm

    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        size=(1, n_tokens)), device=dev)
    positions = torch.arange(n_tokens, device=dev)
    off = dataclasses.replace(cfg, ftl_mode="off")

    def o(p, x):
        return attention_layer(cfg, p["attn"], norm(p["ln1"], x, cfg.norm),
                               positions=positions, causal=False,
                               kv_source=image, use_rope=False)

    shares = []
    with plain_ops(("attention",)):
        inputs = [(p, x_in) for kind, p, x_in, _, _ in M.layer_stream(
            off, params, toks, ctx=image) if kind == "cross"]
        want = [o(p, x) for p, x in inputs]
    for (p, x), w in zip(inputs, want):
        shares.append(rule_share(o(p, x), w))
    print(f"  each of the {len(shares)} cross layers on the plain stream's "
          f"input ({n_tokens} tokens over {image.shape[1]} image tokens): "
          f"largest share of {ATOL} + {RTOL}|plain o| used by the kernel's "
          f"ungated o {shares}")
    check(len(shares) == cfg.n_layers // cfg.cross_attn_every
          and max(shares) <= 1.0, "a cross layer's output differs from its "
          "plain version beyond tolerance")


def _logits_agree(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Max |got - want| within a quarter of ``want``'s spread (every
    layer's bf16 products rounded in different places: the kernels round
    once from fp32, the plain path after every product), and in every
    row (the last axis) the same top-1 token or two whose ``want`` logits
    differ by less than twice the row's measured difference (a tie within
    rounding).  Returns the difference."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    check(bool(torch.isfinite(g).all() and torch.isfinite(w).all()),
          f"{what}: non-finite logits")
    rowd = (g - w).abs().amax(-1)
    d = float(rowd.max())
    tol = 0.25 * float(w.std())
    tg, tw = g.argmax(-1), w.argmax(-1)
    gap = (w.gather(-1, tw[:, None]) - w.gather(-1, tg[:, None]))[:, 0]
    tie = (tg != tw) & (gap <= 2 * rowd)
    top = (f"top-1 {int(tg[0])} against {int(tw[0])}" if len(tg) == 1 else
           f"top-1 equal in {int((tg == tw).sum())} of {len(tg)} rows")
    print(f"  {what}: {top}, tied within rounding in {int(tie.sum())}; "
          f"max|dlogit| {d} (tolerance {tol} = 0.25 x std)")
    check(d <= tol, f"{what}: logits differ beyond tolerance")
    check(bool(((tg == tw) | tie).all()), f"{what}: different top-1 tokens")
    return d


def _prefill_decode_vs_forward(cfg, params, toks, s: int):
    """``prefill`` of the first s tokens and one ``decode_step`` for each
    token after them, against ``forward`` on all of them: the logits at
    s - 1 ... end, as (served, forward) rows."""
    from repro_torch.models import model as M

    t = toks.shape[1]
    full, _ = M.forward(cfg, params, {"tokens": toks})
    logits, cache = M.prefill(cfg, params, {"tokens": toks[:, :s]},
                              max_seq=t)
    got = [logits[0, -1]]
    for j in range(s, t):
        logits, cache = M.decode_step(cfg, params, toks[:, j:j + 1], cache,
                                      torch.tensor(j, device=toks.device))
        got.append(logits[0, -1])
    return torch.stack(got), full[0, s - 1:]


@torch.no_grad()
def forward_vs_decode(cfg, params, dev, s: int, n_dec: int = 4):
    """xlstm-1.3b's three uses of its recurrences, held against each other:
    the stateless ``forward`` (the mLSTM kernel without state), ``prefill``
    (the kernel with its final state) and ``decode_step`` (the plain fp32
    recurrence on that state).

    1. ``prefill`` against ``forward`` on the same s tokens: the logits at
       s - 1.  Both run the same GEMM shapes and the same kernel body, with
       and without the state write, so this tells the kernel's two modes
       apart only by that write and checks the prefill's plumbing.
    2. Every layer on the forward's own inputs (teacher-forced): the block
       without state on s + 4 tokens against the block with state on the
       first s, then 4 decode steps on that state; and the state of the
       block run on all s + 4 tokens with ``length=s`` (the 4 extra tokens
       masked as a bucket's padding) against the state of the first s.
    3. For the record, not gated: after each layer, the forward's residual
       stream over s + 4 tokens against the one over s (only the GEMMs' M
       differs), and ``prefill`` of s tokens + 4 ``decode_step``s against
       ``forward`` on s + 4, end to end.  The random-weight stack carries a
       difference about 1.2 times further each layer, in the JAX reference
       as in the port on the same weights (``tests/test_torch_xlstm_growth
       .py``), so one rounding step in an early layer parts the logits by
       O(1) after 24 layers; 2 holds each layer without that.

    Tolerances: logits and layer outputs within a quarter of the forward's
    spread (bf16 products rounded in different places, as for a
    served-against-plain prefill); states within STATE_ATOL +
    STATE_RTOL |·|."""
    from repro_torch.models import model as M

    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        size=(1, s + n_dec)), device=dev)
    fwd, _ = M.forward(cfg, params, {"tokens": toks[:, :s]})
    logits, _ = M.prefill(cfg, params, {"tokens": toks[:, :s]})
    _logits_agree(logits[0, -1], fwd[0, -1],
                  f"prefill of {s} tokens against forward on the same "
                  f"tokens")

    worst = {"mlstm": [0.0, 0.0], "slstm": [0.0, 0.0]}  # output, state
    drift = []
    for (kind, p, x, x_out, _), (_, _, _, x_short, _) in zip(
            M.layer_stream(cfg, params, toks),
            M.layer_stream(cfg, params, toks[:, :s])):
        dx = (x_out[:, :s].float() - x_short.float()).abs().max()
        drift.append(f"{kind[0]}:{float(dx):.3g}")
        mix = M.MIXERS[kind]
        y = mix.block(cfg, p["mix"], x)
        y_pre, st = mix.block(cfg, p["mix"], x[:, :s], return_state=True)
        _, st_len = mix.block(cfg, p["mix"], x, return_state=True, length=s)
        for name in st:
            w, g = st[name], st_len[name]
            share = float(((g - w).abs() / (STATE_ATOL + STATE_RTOL
                                            * w.abs())).max())
            worst[kind][1] = max(worst[kind][1], share)
        got = [y_pre[:, -1]]
        for j in range(n_dec):
            yj, st = mix.decode(cfg, p["mix"], x[:, s + j:s + j + 1], st)
            got.append(yj[:, 0])
        want = y[:, s - 1:s + n_dec].float()
        d = float((torch.stack(got, 1).float() - want).abs().max())
        worst[kind][0] = max(worst[kind][0], d / (0.25 * float(want.std())))
    for kind, (out_share, st_share) in worst.items():
        print(f"  every {kind} layer, teacher-forced: the block with state "
              f"+ {n_dec} decode steps against the block without, largest "
              f"share of the tolerance (0.25 x std of its outputs) used "
              f"{out_share}; the state at length {s} of {s + n_dec} "
              f"tokens against that of {s}, largest share of "
              f"{STATE_ATOL} + {STATE_RTOL}|state| used {st_share}")
        check(out_share <= 1.0, f"{kind}: decode steps differ from the "
              f"stateless block beyond tolerance")
        check(st_share <= 1.0, f"{kind}: the state at length differs from "
              f"the unpadded state")

    got, want = _prefill_decode_vs_forward(cfg, params, toks, s)
    diffs = (got.float() - want.float()).abs().amax(-1).tolist()
    agree = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"  for the record (not gated): after each layer, max|dx| between "
          f"the forward's residual stream over {s + n_dec} tokens and the "
          f"one over {s}, on the first {s}: {' '.join(drift)}")
    print(f"  for the record (not gated): all {cfg.n_layers} layers, "
          f"prefill of {s} + {n_dec} decode steps against forward on "
          f"{s + n_dec} tokens: max|dlogit| {diffs} at positions "
          f"{s - 1} ... {s + n_dec - 1} (std of the forward logits "
          f"{float(want.float().std())}), same top-1 {agree}")


@torch.no_grad()
def forward_timed(cfg, params, dev, b: int = 2, s: int = 2048):
    """One stateless ``forward`` on a (b, s) batch, timed on the host
    around a device sync after one warm-up call: what a train step's
    forward runs."""
    from repro_torch.kernels import mlstm
    from repro_torch.models import model as M

    rng = np.random.default_rng(17)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(b, s)),
                           device=dev)
    M.forward(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = mlstm.launches
    t0 = time.perf_counter()
    logits, _ = M.forward(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(tuple(logits.shape) == (b, s, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"forward on {b} x {s}: logits {tuple(logits.shape)}, not finite "
          f"or of the wrong shape")
    print(f"  forward on {b} x {s} tokens: {1e3 * dt} ms "
          f"({b * s / dt} tokens/s), {mlstm.launches - before} mLSTM "
          f"launches; its peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9} GB")


# ---------------------------------------------------------------------------
# phase 11: train llama3.2-3b at full width through the trainer
# ---------------------------------------------------------------------------

def _device_kernels(prof) -> dict:
    """{kernel name: [launches, device ms]} from the profiler's raw
    events."""
    kern = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            k = kern.setdefault(ev.name(), [0, 0.0])
            k[0] += 1
            k[1] += ev.duration_ns() / 1e6
    return kern


@dataclasses.dataclass(frozen=True)
class TrainPath:
    """One training run through the trainer: the model, the trainer's
    flags, the config fields it replaces (a depth cut, the remat chunk),
    the reference's parameter count, the launches each step must make
    (every other counter stays 0), the ops forced to ``backend='ref'``
    for the gradient check, whether that check runs layer by layer
    (:func:`layer_grads`) instead of through the whole stack, and whether
    a step under ``ftl_mode='fused'`` must raise (a model with a
    plannable MLP block, whose fused kernel has no backward yet; xLSTM
    plans nothing)."""
    arch: str
    label: str
    argv: tuple[str, ...]
    overrides: dict
    n_params: int
    per_step: dict
    plain: tuple[str, ...]
    layerwise: bool = False
    fused_raises: bool = True


TRAIN_PATHS = (
    # 4 x 1024 tokens a step in 2 microbatches; remat runs each layer's
    # forward again in the backward pass
    TrainPath(LLAMA, TRAIN, ("--arch", LLAMA, "--steps", "4", "--batch", "4",
                             "--seq", "1024", "--accum", "2"),
              {}, LLAMA_PARAMS,
              {"flash_attention": 2 * 28 * 2, "flash_attention_bwd": 28 * 2},
              ("attention",)),
    # 2 x 3072 tokens in 2 microbatches; 6 layers, two periods of (rec,
    # rec, local): 4 recurrent and 2 local-attention layers
    TrainPath(RG, RG_TRAIN, ("--arch", RG, "--steps", "4", "--batch", "2",
                             "--seq", "3072", "--accum", "2"),
              {"n_layers": RG_TRAIN_LAYERS}, RG_TRAIN_PARAMS,
              {"flash_attention": 2 * 2 * 2, "flash_attention_bwd": 2 * 2,
               "rg_lru_scan": 2 * 4 * 2, "rg_lru_scan_bwd": 4 * 2},
              ("attention", "rg_lru")),
    # 32 x 128 tokens in 2 microbatches (4,096 a step; T cut from 512,
    # where the sLSTM's Python loop under remat took 32 s a step); 48
    # layers, 42 of them mLSTM; the chunked remat scan on, so that the
    # plain side of the gradient check keeps only chunk boundaries.  The
    # random-weight stack carries a difference 1.3-1.9 times further each
    # layer (tests/test_torch_xlstm_growth.py), so the check goes layer
    # by layer
    TrainPath(XLSTM, XLSTM_TRAIN, ("--arch", XLSTM, "--steps", "4",
                                   "--batch", "32", "--seq", "128",
                                   "--accum", "2"),
              {"mlstm_chunk": 64}, N_PARAMS[XLSTM],
              {"mlstm_scan": 42 * 2 * 2, "mlstm_scan_bwd": 42 * 2},
              ("mlstm",), layerwise=True, fused_raises=False),
)


def train_phase(dev, card: str, counters: dict, path: TrainPath
                ) -> tuple[dict, dict]:
    """``path``'s model at full width (bf16, random weights from a seed;
    its depth cut where ``path`` says) through
    ``repro_torch.launch.train.build``: the steps and microbatches of
    ``path.argv``, bigram data, ``cfg.remat`` on, ``ftl_mode='off'``, no
    checkpoint directory.  Every launch counter is set to 0 just before
    the run and read just after: each kernel must have launched
    ``path.per_step`` times a step, and no other kernel.  Then one
    profiled step for the device's busy share, one microbatch's gradients
    through the kernels against the plain Functions' (``path.plain`` ops
    with ``backend='ref'``; through the whole stack, or with
    ``path.layerwise`` each layer's on the same input and cotangent),
    and, where ``path.fused_raises``, a step under
    ``ftl_mode='fused'``, which must raise.  Returns the main path's
    launches and its losses, steady step seconds and peak GB."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    args = train.parser().parse_args(
        [*path.argv, "--data", "bigram", "--log-every", "1"])
    steps, batch, seq, accum = args.steps, args.batch, args.seq, args.accum
    cfg = dataclasses.replace(get_config(path.arch), **path.overrides)
    check(cfg.remat and cfg.ftl_mode == "off",
          f"{path.label} trains with remat on and ftl_mode 'off', got "
          f"{cfg.remat}, {cfg.ftl_mode!r}")
    t0 = time.perf_counter()
    loop = train.build(args, cfg)
    torch.cuda.synchronize()
    leaves = M.tree_leaves(loop.state.params)
    n_params = sum(t.numel() for t in leaves)
    state_gb = sum(t.numel() * t.element_size() for t in
                   M.tree_leaves(loop.state.params)
                   + M.tree_leaves(loop.state.opt)) / 1e9
    print(f"  {path.label}: {cfg.n_layers} layers {M.period_kinds(cfg)}, "
          f"{n_params} parameters, {state_gb} GB of bf16 weights and fp32 "
          f"moments, built in {time.perf_counter() - t0} s")
    check(n_params == path.n_params, f"{n_params} parameters, the "
          f"reference counts {path.n_params}")

    # --- xLSTM: gradients layer by layer on the first microbatch, before
    # the steps move the weights ------------------------------------------
    if path.layerwise:
        first = loop.make_batch(0)["tokens"][:2]
        by_leaf, by_scan = layer_grads(cfg, loop.state.params, first,
                                       path.plain)
        print(f"  gradients layer by layer, kernels against the plain "
              f"Functions ({', '.join(path.plain)}), initial weights, 2 x "
              f"{first.shape[1]} tokens of the first microbatch: worst leaf "
              f"{_worst(by_leaf)}, worst scan gradient {_worst(by_scan)} "
              f"(tolerance {GRAD_RTOL}); every leaf: {by_leaf}; every scan: "
              f"{by_scan}")
        check(all(np.isfinite(v) and v <= GRAD_RTOL
                  for v in (*by_leaf.values(), *by_scan.values())),
              "gradients through the kernels disagree with the plain "
              "Functions' at the initial weights")

    # --- the main path: counters from 0 ----------------------------------
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    print(f"  main path launches: {launches}")
    for name, n in launches.items():
        want = path.per_step.get(name, 0) * steps
        check(n == want, f"{name} launched {n} times in {steps} steps, "
              f"not {path.per_step.get(name, 0)} a step")
    log = loop.metrics_log
    check(len(log) == steps and all(
        np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        for m in log), f"non-finite loss or grad norm: {log}")
    secs = [st.seconds for st in loop.monitor.history]
    step_s = statistics.median(secs[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    mem = torch.cuda.memory_stats(dev)
    print(f"  {steps} steps in {wall} s, losses "
          f"{[m['loss'] for m in log]}, step seconds {secs}; steady step "
          f"(median of steps 2-{steps}) {step_s} s: {batch * seq / step_s} "
          f"training tokens/s; peak device memory {peak} GB; the caching "
          f"allocator's retries {mem['num_alloc_retries']}, device "
          f"allocations {mem['num_device_alloc']} and frees "
          f"{mem['num_device_free']} [{card}]")

    # --- one profiled step: the device's busy share ------------------------
    # (device activity only: xLSTM's step makes about half a million host
    # operators, whose events the profiler would take minutes to tally)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    data = loop.make_batch(steps)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop.state, m = loop.step_fn(loop.state, data)
        float(m["loss"])
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    kern = _device_kernels(prof)
    del prof
    for name in path.per_step:
        hits = [n for n in kern if re.search(KERNEL_RE[name], n)]
        check(bool(hits), f"{name} kernel missing from the profiler's "
              f"device-kernel list")
        print(f"  profiler: {name}: {sum(kern[h][0] for h in hits)} "
              f"launches, {sum(kern[h][1] for h in hits)} ms on the device")
    busy = sum(v[1] for v in kern.values())
    print("  profiler: top device kernels (ms, count): " + "; ".join(
        f"{n[:60]} {v[1]} ms x{v[0]}" for n, v in
        sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]))
    print(f"  profiler: one train step, device kernel time {busy} ms of "
          f"{prof_ms} ms wall: device busy {busy / prof_ms} [{card}]")

    # --- gradients through the kernels against the plain Functions ---------
    mb = {"tokens": data["tokens"][:batch // accum]}
    if path.layerwise:
        # after the steps the gates have grown, and the bf16 block's
        # backward carries the scans' small differences much further into
        # its leaves, about as far from a float64 block's for the plain
        # scan as for the kernel (PERF.md §6): the scans are held, the
        # leaves shown
        by_leaf, by_scan = layer_grads(cfg, loop.state.params,
                                       mb["tokens"][:2], path.plain)
        over = {k: v for k, v in by_leaf.items() if v > GRAD_RTOL}
        print(f"  gradients layer by layer after {steps + 1} steps, 2 x "
              f"{seq} tokens of one microbatch: worst scan gradient "
              f"{_worst(by_scan)} (tolerance {GRAD_RTOL}); every scan: "
              f"{by_scan}; leaves (shown, not held): worst "
              f"{_worst(by_leaf)}, {len(over)} of {len(by_leaf)} over "
              f"{GRAD_RTOL}: {over}")
        check(all(np.isfinite(v) and v <= GRAD_RTOL
                  for v in by_scan.values()),
              "the scans' gradients through the kernels disagree with the "
              "plain Functions'")
    loss_fn = S.make_loss_fn(cfg)

    def grads():
        loss, _ = loss_fn(loop.state.params, mb)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    if not path.layerwise:
        lk, gk = grads()
        # the model's attention core (models/layers.py:_attend) and RG-LRU
        # scan (models/recurrent.py:rec_block) through the same autograd
        # Functions, their plain passes
        with plain_ops(path.plain):
            lp, gp = grads()
        names = [n for n, _ in _flat_names(loop.state.params)]
        rel = {name: _rel(a, b) for name, a, b in zip(names, gk, gp)}
        del gk, gp
        worst = max(rel, key=rel.get)
        print(f"  gradients, kernels against the plain Functions "
              f"({', '.join(path.plain)}) on one microbatch: loss {lk} "
              f"against {lp}; worst leaf {worst} |g_kernel - g_plain| / "
              f"|g_plain| = {rel[worst]} (tolerance {GRAD_RTOL}); every "
              f"leaf: {rel}")
        check(all(np.isfinite(v) for v in rel.values())
              and rel[worst] <= GRAD_RTOL, "gradients through the kernels "
              "disagree with the plain Functions'")

    # --- a kernel with no backward refuses to train -----------------------
    if path.fused_raises:
        step = S.make_train_step(dataclasses.replace(cfg, ftl_mode="fused"),
                                 None, OptConfig())
        try:
            step(loop.state, mb)
        except NotImplementedError as e:
            print(f"  a step under ftl_mode='fused' raises: {e}")
            check("no backward kernel yet" in str(e),
                  f"unexpected error: {e}")
        else:
            check(False, "a CUDA step under ftl_mode='fused' did not raise")
        del step
    del loop, leaves
    torch.cuda.empty_cache()
    return launches, {"losses": [m["loss"] for m in log], "step_s": step_s,
                      "peak_gb": peak}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b|, norms over the whole tensor (0 where both are 0)."""
    diff = float(torch.linalg.vector_norm(a.float() - b.float()))
    base = float(torch.linalg.vector_norm(b.float()))
    return diff / base if base else (0.0 if diff == 0 else float("inf"))


@contextlib.contextmanager
def plain_ops(names):
    """``ops``'s ``names`` forced to ``backend='ref'`` (the models call
    them through the module, so the patch reaches every layer)."""
    from repro_torch.kernels import ops

    with contextlib.ExitStack() as stack:
        for op in names:
            stack.enter_context(mock.patch.object(ops, op, functools.partial(
                getattr(ops, op), backend="ref")))
        yield


def layer_grads(cfg, params, tokens, plain) -> tuple[dict, dict]:
    """Each mLSTM layer's gradients through the kernels against the plain
    Functions' (``plain`` ops with ``backend='ref'``), on the layer's
    input from one forward through the kernels and one random cotangent
    of its output: |g_kernel - g_plain| / |g_plain| for the layer's input
    and every parameter (the leaves), and for the scan's own dq, dk, dv,
    di and df on the q, k, v, gates and cotangent the layer hands it (the
    scans).  The plain side scans in checkpointed chunks of 16 steps (the
    same values as any chunk), so that its recomputed chunk fits beside
    the training state.  The sLSTM layers run the same plain code on
    both sides and are left out."""
    from repro_torch.kernels import mlstm, ops, ref
    from repro_torch.models import model as M

    chk = dataclasses.replace(cfg, mlstm_chunk=16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    with torch.no_grad():
        xs = [x for _, _, x, _, _ in M.layer_stream(chk, params, tokens)]
    for t in M.tree_leaves(params):     # as the train step marks them
        t.requires_grad_(True)
    gen = torch.Generator(device=tokens.device).manual_seed(5)
    leaves, scans = {}, {}
    for i, ((kind, p, _), x_in) in enumerate(zip(M._layers(chk, params), xs)):
        if kind != "mlstm":
            continue
        named = list(_flat_names(p))
        x = x_in.detach().requires_grad_()
        layer = functools.partial(M._apply_layer, chk, p, kind,
                                  positions=positions, plan=None)
        cap, real = {}, ops.mlstm

        def grab(*a, cap=cap, real=real, **kw):
            out = real(*a, **kw)
            cap["args"] = [t.detach().contiguous() for t in a]
            out.register_hook(lambda g: cap.__setitem__(
                "dh", g.detach().contiguous()))
            return out

        with mock.patch.object(ops, "mlstm", grab):
            y, _ = layer(x)
        cot = torch.randn(y.shape, generator=gen, device=y.device
                          ).to(y.dtype)
        gk = torch.autograd.grad(y, [x, *(v for _, v in named)], cot)
        del y
        with plain_ops(plain):
            y, _ = layer(x)
            gp = torch.autograd.grad(y, [x, *(v for _, v in named)], cot)
        del y
        for name, a, b in zip(["input", *(n for n, _ in named)], gk, gp):
            leaves[f"{i}/{name}"] = _rel(a, b)
        del gk, gp
        args = cap["args"]
        _, saved = mlstm._forward(*args, return_state=False, train=True)
        got = mlstm.mlstm_scan_bwd(*args, saved, cap["dh"])
        want = ref.mlstm_bwd(*args, cap["dh"])
        for name, a, b in zip("qkvif", got, want):
            scans[f"{i}/d{name}"] = _rel(a, b)
        del cap, args, saved, got, want
    return leaves, scans


def _worst(rel: dict) -> str:
    k = max(rel, key=rel.get)
    return f"{k} {rel[k]}"


def _flat_names(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{pre}{k}/")
        else:
            yield pre + k, v


# ---------------------------------------------------------------------------
# phase 14: planner tooling on the card
# ---------------------------------------------------------------------------

# the calibration sweep on the h100 preset, through repro_torch.calib in
# bf16: GEMMs at the served projections' shapes and at 4096^3 through the
# GEMM kernel; activations; in-place copy-throughs of buffers the
# preset's first fit homes whole in its 50 MB L2 (1, 8 and 16 MiB) or
# whole in HBM (64, 128 and 256 MiB), so that each level gets three rows
# of its own.  Each sample is calib.measure.CUDA_CALLS_PER_SAMPLE calls
# in one CUDA graph replay: one call takes a few µs to tens of µs, under
# the host's launch and synchronize (about 30 µs a sample), and one-call
# L2 rows fitted an L2 rate of 1.9e13 B/s on an NVIDIA H100 80GB HBM3 at
# 700 W
CALIB_GEMMS = ((256, 3072, 3072), (1024, 3072, 3072), (1024, 3072, 8192),
               (4096, 4096, 4096))
CALIB_ACTS = (1 << 20, 1 << 22, 1 << 23)
CALIB_DMA = (1 << 20, 8 << 20, 16 << 20, 64 << 20, 128 << 20, 256 << 20)
CALIB_REPEATS, CALIB_WARMUP = 20, 2
# each fitted rate is held under its datasheet peak, within 5%: the bf16
# tensor cores' for the GEMM, fp32 outside them for the activations
# (PyTorch computes a bf16 activation in fp32), HBM's for HBM; the data
# sheet gives no L2 rate, so the preset's order-of-magnitude figure
# stands for it
PEAK_SLACK = 1.05
# the simulator-scored search replays every candidate plan in Python
# (about 30 s at 64 tokens on one CPU core, 72 s at 128), so the tuned
# full-width block is planned at the 64-token prefill bucket
TUNE_M = 64
# the block held out of the fit, at the llama serving phase's max_seq
BLOCK_M = 1024
TOOLING = "llama3.2-3b (planner tooling)"


def _preset_constant(base, name: str) -> float:
    """The preset's value of a fitted constant (``rate:<engine>:<kind>``,
    ``bw:<level>``, ``dma_setup:<level>``): the engine-less ``h100``
    prices every kind at ``flops``."""
    kind, *rest = name.split(":")
    if kind == "rate":
        return base.flops
    lv = {lv.name: lv for lv in base.levels}[rest[0]]
    return lv.bw_bytes_per_s if kind == "bw" else lv.dma_setup_s


@contextlib.contextmanager
def launches_in(cls, methods, kernels: dict):
    """Within: the launches of ``kernels`` made inside the calls of each
    of ``cls``'s ``methods``, summed by method (the counters count at
    launch, on the host)."""
    made = {name: dict.fromkeys(kernels, 0) for name in methods}

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            before = {k: mod.launches for k, mod in kernels.items()}
            try:
                return fn(*args, **kw)
            finally:
                for k, mod in kernels.items():
                    made[name][k] += mod.launches - before[k]
        return call

    with contextlib.ExitStack() as stack:
        for name in methods:
            stack.enter_context(mock.patch.object(
                cls, name, counted(name, getattr(cls, name))))
        yield made


@torch.no_grad()
def tooling_phase(dev, kernels: dict) -> dict:
    """Phase 14: (a) the calibration sweep and fit, (b) the held-out
    full-width block, (c) the tuned full-width block against the plain
    block, (d) ``serve.main`` with every obs flag.  Returns the serving
    run's launches of the path's kernels (flash attention and the fused
    MLP; llama's prefill runs its projections as plain matmuls), counted
    from 0 before ``serve.main``, less the block plan's execution and the
    warm-up inside it."""
    from repro_torch import calib, obs
    from repro_torch.configs import get_config
    from repro_torch.core import hw
    from repro_torch.core.ftl import executor_block, registry
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.tune import AutotuneConfig

    base = hw.H100
    gemm = kernels["gemm"]

    # --- (a) the sweep and the fit ----------------------------------------
    t0 = time.perf_counter()
    before = gemm.launches
    ms = calib.microbench_sweep(
        base=base, gemm_shapes=CALIB_GEMMS, elementwise_sizes=CALIB_ACTS,
        dma_sizes=CALIB_DMA, repeats=CALIB_REPEATS, warmup=CALIB_WARMUP,
        dtype=torch.bfloat16, device=dev)
    # one launch outside each row's graph, its sample's calls inside it
    calls = calib.measure.CUDA_CALLS_PER_SAMPLE
    want = len(CALIB_GEMMS) * (1 + calls)
    check(gemm.launches - before == want, f"the GEMM rows launched the "
          f"kernel {gemm.launches - before} times, not {want}")
    check(all(m.segments[0].repeat == calls for m in ms),
          f"a row's sample is not {calls} calls")
    for m in ms:
        seg = m.segments[0]
        print(f"  {m.name}: {1e6 * m.measured_s} us (min of "
              f"{CALIB_REPEATS}; {seg.repeat} calls, "
              f"{1e6 * m.measured_s / seg.repeat} us each); bytes a call "
              f"{dict(seg.bytes_by_level)}, FLOPs {dict(seg.flops_by_kind)}")
    print(f"  sweep {time.perf_counter() - t0} s")

    # --- (b) the full-width block, held out of the fit --------------------
    cfg = get_config(LLAMA)
    mode = serve.serving_ftl_mode(cfg)
    t0 = time.perf_counter()
    blocks = calib.measure_block(LLAMA, BLOCK_M, base=base, repeats=10,
                                 warmup=2, dtype=torch.bfloat16, device=dev,
                                 reduced=False, ftl_mode=mode)
    print(f"  measure_block({LLAMA}, m={BLOCK_M}, full width, ftl_mode="
          f"{mode}) {time.perf_counter() - t0} s")

    res = calib.calibrate(ms + blocks, base=base)
    print("  " + res.summary().replace("\n", "\n  "))
    peaks = {"rate:core:gemm": BF16_FLOPS,
             "rate:core:elementwise": FP32_FLOPS,
             "bw:hbm": HBM_BPS,
             "bw:l2": _preset_constant(base, "bw:l2")}
    for name, val in res.fitted:
        preset = _preset_constant(base, name)
        print(f"  fitted {name}: {val} (preset {preset}; x{val / preset})")
        check(math.isfinite(val), f"{name} = {val} is not finite")
        if name.startswith("dma_setup:"):
            check(val >= 0, f"{name} = {val} is negative")
            continue
        check(val > 0, f"{name} = {val} is not positive")
        check(name in peaks, f"no datasheet peak known for {name}")
        check(val <= PEAK_SLACK * peaks[name], f"{name} = {val} is above "
              f"{PEAK_SLACK} x its peak {peaks[name]}")
    for r in res.residuals:
        if not r.in_fit:
            print(f"  held out {r.name}: measured {1e3 * r.measured_s} ms, "
                  f"modeled/measured {r.base_ratio} on {base.name}, "
                  f"{r.calibrated_ratio} on {res.target.name}")
    print(f"  geomean modeled/measured {res.base_geomean_ratio} "
          f"({base.name}) -> {res.geomean_ratio} ({res.target.name})")
    print(f"  drift_gate: {json.dumps(calib.drift_gate(res))}")

    # --- (c) the tuned full-width block against the plain block -----------
    t0 = time.perf_counter()
    plan = registry.plan_block(dataclasses.replace(cfg, ftl_mode="auto"),
                               m=TUNE_M, target=base,
                               autotune=AutotuneConfig(), device=dev)
    tune = plan.tune
    check(tune is not None, "plan_block(autotune=) returned no tune")
    print(f"  {tune.summary()} ({time.perf_counter() - t0} s)")
    print(f"  tuned: schedule {plan.schedule} (MLP {plan.mlp_schedule}, "
          f"attention {plan.attention_schedule}), cuts {plan.chain.cuts()}, "
          f"depths {[(lv.name, lv.buffer_depth) for lv in plan.target.levels]}"
          f", analytic {1e3 * plan.chain.modeled_runtime_s} ms, simulated "
          f"{1e3 * tune.sim_runtime_s} ms (analytic-best plan simulated "
          f"{1e3 * tune.baseline_sim_runtime_s} ms)")
    for seg, b in zip(plan.chain.segments, plan.bindings):
        print(f"    [{seg.lo}:{seg.hi}] x{seg.repeat} {b.kind} -> "
              f"{b.executor}: tiles {dict(seg.plan.tiles)}")
    execs = executor_block.resolved_executors(plan, m=TUNE_M, ftl_mode=mode)
    print(f"  on the card under ftl_mode={mode}: {execs}")
    check(all(registry.get(e).backend == "cuda" for e in execs.values()),
          f"the tuned plan binds no CUDA executor for a stage: {execs}")
    bcfg = dataclasses.replace(cfg, ftl_mode=mode)
    params = M._init_layer(bcfg, torch.Generator(device=dev).manual_seed(0),
                           "attn", dev)
    x = normal_bf16(dev, 14)(1, TUNE_M, cfg.d_model)
    positions = torch.arange(TUNE_M, device=dev)
    if cfg.mlp_gated and plan.mlp_schedule == "partial":
        try:
            registry.run_block(plan, params, x, positions=positions,
                               ftl_mode="auto")
        except ValueError as e:
            print(f"  under ftl_mode=auto the gated MLP planned partial "
                  f"raises: {e}")
        else:
            check(False, "a gated MLP planned partial ran under 'auto'")
    for mod in kernels.values():
        mod.launches = 0
    y = registry.run_block(plan, params, x, positions=positions,
                           ftl_mode=mode)
    torch.cuda.synchronize()
    ran = {n: mod.launches for n, mod in kernels.items()}
    print(f"  tuned block launches: {ran}")
    check(all(v > 0 for v in ran.values()),
          f"a kernel of the tuned block never launched: {ran}")
    with plain_ops(("attention",)):
        plain = layers.block_layer(dataclasses.replace(cfg, ftl_mode="off"),
                                   params, x, positions=positions)
    compare(y, plain, f"tuned block (m={TUNE_M}) against the plain block")
    del params, x, y, plain

    # --- (d) serve.main with every obs flag -------------------------------
    out = ROOT / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    paths = {k: out / f"{k}" for k in ("obs_trace.json", "trace.json",
                                       "metrics.prom")}
    # the exported metrics describe this serving run alone
    obs.metrics.REGISTRY.reset()
    for mod in kernels.values():
        mod.launches = 0
    with launches_in(serve.ServeEngine,
                     ("execute_block_plan", "warmup_compile"),
                     kernels) as made:
        eng = serve.main([
            "--arch", LLAMA, "--requests", "4", "--slots", "4",
            "--prompt-len", "200", "--max-new", "33", "--max-seq", "256",
            "--block-size", "16", "--target", base.name, "--obs",
            "--obs-trace", str(paths["obs_trace.json"]),
            "--obs-metrics", str(paths["metrics.prom"]),
            "--trace", str(paths["trace.json"])])
    torch.cuda.synchronize()
    total = {n: mod.launches for n, mod in kernels.items()}
    probe, warm = made["execute_block_plan"], made["warmup_compile"]
    served = {n: total[n] - probe[n] - warm[n] for n in kernels}
    print(f"  launches in serve.main --obs: {total}; the block plan's "
          f"execution (drift probe) {probe}, the warm-up {warm}, the "
          f"serving run {served}")
    check(probe["gemm"] > 0, f"the block plan's execution launched no "
          f"gemm: {probe}")
    launches = {n: served[n] for n in ("flash_attention", "fused_mlp")}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched in the serving run: "
          f"{launches}")
    for name in ("obs_trace.json", "trace.json"):
        doc = json.loads(paths[name].read_text())
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        modeled = [e for e in xs if e["pid"] == 0]
        live = [e for e in xs if e["pid"] == 1]
        print(f"  {name}: {len(modeled)} modeled events (pid 0), "
              f"{len(live)} live spans (pid 1), "
              f"{len(doc['otherData']['metrics'])} metrics")
        check(bool(modeled) and any(e["name"].startswith("serve:")
                                    for e in live),
              f"{name} lacks the modeled lane or live serve:* spans")
    text = paths["metrics.prom"].read_text()
    (line,) = [ln for ln in text.splitlines()
               if ln.startswith("serve_decode_step_seconds_count")]
    steps = eng.stats["decode_steps"]
    print(f"  {line}; stats decode_steps {steps}")
    check(float(line.split()[-1]) == steps,
          "the Prometheus decode-step count is not the engine's")
    st = eng.drift.status()
    print(f"  drift: {json.dumps(st)}")
    check(math.isfinite(st["geomean_ratio"]), "drift geomean not finite")
    row = [m for m in eng.drift.measurements() if m.name == "block_exec"][-1]
    ratio = eng.stats["block_exec"]["drift_ratio"]
    check(math.isfinite(ratio) and ratio > 0, f"block drift ratio {ratio}")
    print(f"  full-width block (m=256) drift ratio modeled/measured: "
          f"{ratio} on {base.name}, "
          f"{calib.modeled_measurement_s(res.target, row) / row.measured_s}"
          f" on {res.target.name} (measured {1e3 * row.measured_s} ms)")
    del eng
    obs.disable()
    obs.metrics.REGISTRY.clear()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: the distributed layer on one card
# ---------------------------------------------------------------------------

# llama3.2-3b served and trained through the mesh steps: phase 11's
# trainer flags with a 1 x 1 data x model mesh and int8 error feedback,
# the same launches a step
MESH_SERVE = "llama3.2-3b (serve, mesh 1x1)"
MESH_TRAIN = "llama3.2-3b (train, --mesh 1x1 --compress)"
MESH_TRAIN_PATH = dataclasses.replace(
    TRAIN_PATHS[0], label=MESH_TRAIN,
    argv=(*TRAIN_PATHS[0].argv, "--mesh", "1x1", "--compress"))
# the mesh serving check: B prompts of PROMPT tokens, then DECODE steps
MESH_B, MESH_PROMPT, MESH_DECODE = 2, 256, 8
# the pipeline check: 8 tanh(a @ w) layers at d = 3072, 4 microbatches
PIPE_LAYERS, PIPE_D, PIPE_M, PIPE_MB = 8, 3072, 4, 256


def _zero(counters: dict) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters: dict) -> dict:
    return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}


def mesh_phase(dev, card: str, counters: dict, train11: dict) -> dict:
    """Phase 15: (a) a one-rank NCCL group and a 1 x 1 ``data`` x
    ``model`` mesh; (b) llama3.2-3b at full width: the sharded init
    against the unsharded one leaf by leaf, and the mesh prefill and
    decode steps against the mesh-less ones under ``"fused"`` (logits
    and launches); (c) phase 11's training with ``--mesh 1x1 --compress``
    through the trainer: the same launches a step, step 1's loss equal to
    phase 11's, the error-feedback state finite and not zero, the peak
    and step time beside phase 11's, the EF pass's device time; (d)
    ``compressed_psum`` and ``pipeline_forward`` on the group.  Returns
    the serving and training runs' launches."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import compression
    from repro_torch.distributed.pipeline import (pipeline_forward,
                                                  stage_params)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serving_ftl_mode
    from repro_torch.models import model as M
    from repro_torch.train import steps as S

    # --- (a) the group and the mesh ---------------------------------------
    check(not dist.is_initialized(), "a process group is up before phase 15")
    mesh = make_mesh((1, 1), ("data", "model"))
    print(f"  process group: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}; {mesh}")
    check(dist.get_backend() == "nccl", f"the card's mesh runs over "
          f"{dist.get_backend()}, not NCCL")

    # --- (b) llama3.2-3b: the sharded init and the serving steps ------------
    cfg = get_config(LLAMA)
    cfg = dataclasses.replace(cfg, ftl_mode=serving_ftl_mode(cfg))
    t0 = time.perf_counter()
    state = S.init_train_state(cfg, 0, device=dev, mesh=mesh)
    whole = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    dts = C.paths_and_leaves(state.params)
    check(len(dts) == len(M.tree_leaves(whole)) and all(
        isinstance(t, DTensor) and torch.equal(t.to_local(), w)
        for t, w in zip(dts.values(), M.tree_leaves(whole))),
        "the sharded init differs from the unsharded init")
    print(f"  init_train_state(mesh=): {len(dts)} DTensor leaves, "
          f"{sum(t.numel() for t in dts.values())} parameters, bit-identical "
          f"to init_params leaf by leaf ({time.perf_counter() - t0} s for "
          f"both, with the fp32 moments)")
    params = state.params
    del state, dts
    gen = torch.Generator(device=dev).manual_seed(15)
    toks = torch.randint(2, cfg.vocab_size, (MESH_B, MESH_PROMPT
                                             + MESH_DECODE),
                         generator=gen, device=dev)

    def serve(prefill, decode, p):
        _zero(counters)
        logits, cache = prefill(p, {"tokens": toks[:, :MESH_PROMPT]})
        out = [logits]
        for i in range(MESH_PROMPT, MESH_PROMPT + MESH_DECODE):
            lg, cache = decode(p, cache, toks[:, i:i + 1],
                               torch.tensor(i, device=dev))
            out.append(lg)
        torch.cuda.synchronize()
        return out, _read(counters)

    max_seq = MESH_PROMPT + MESH_DECODE
    plain, plain_n = serve(S.make_prefill_step(cfg, None, max_seq=max_seq),
                           S.make_decode_step(cfg, None), whole)
    meshed, mesh_n = serve(S.make_prefill_step(cfg, mesh, max_seq=max_seq),
                           S.make_decode_step(cfg, mesh), params)
    same = [torch.equal(a, b) for a, b in zip(meshed, plain)]
    print(f"  {MESH_B} x {MESH_PROMPT}-token prefill and {MESH_DECODE} "
          f"decode steps under {cfg.ftl_mode!r}: logits bit-identical "
          f"mesh vs mesh-less {same}; launches mesh {mesh_n}, mesh-less "
          f"{plain_n}")
    check(all(same), "the mesh serving steps' logits differ from the "
          "mesh-less steps'")
    check(mesh_n == plain_n and mesh_n["flash_attention"] > 0
          and mesh_n["fused_mlp"] > 0, "the mesh serving steps launch "
          "other kernels than the mesh-less steps, or no flash or fused MLP")
    del params, whole, plain, meshed
    torch.cuda.empty_cache()

    # --- (c) phase 11's training with --mesh 1x1 --compress ----------------
    path = MESH_TRAIN_PATH
    args = train.parser().parse_args(
        [*path.argv, "--data", "bigram", "--log-every", "1"])
    loop = train.build(args, get_config(path.arch))
    check(loop.mesh is not None and loop.state.ef_error is not None,
          "the trainer built no mesh or no error-feedback state")
    _zero(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    loop.run()
    torch.cuda.synchronize()
    train_n = _read(counters)
    for name, n in train_n.items():
        want = path.per_step.get(name, 0) * args.steps
        check(n == want, f"{name} launched {n} times in {args.steps} mesh "
              f"steps, not {path.per_step.get(name, 0)} a step")
    log = loop.metrics_log
    losses = [m["loss"] for m in log]
    secs = [st.seconds for st in loop.monitor.history]
    step_s = statistics.median(secs[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    efs = M.tree_leaves(C.local_tree(loop.state.ef_error))
    ef_norm = math.sqrt(sum(float(torch.sum(e.double() ** 2))
                            for e in efs))
    retries = torch.cuda.memory_stats(dev)["num_alloc_retries"]
    print(f"  main path launches: {train_n}")
    print(f"  {args.steps} steps with --mesh 1x1 --compress: losses "
          f"{losses} (phase 11: {train11['losses']}); step seconds {secs}, "
          f"steady {step_s} s (phase 11: {train11['step_s']} s); peak "
          f"device memory {peak} GB (phase 11: {train11['peak_gb']} GB), "
          f"the caching allocator's retries {retries}; error-feedback "
          f"state {sum(e.numel() for e in efs)} fp32 elements, norm "
          f"{ef_norm} [{card}]")
    check(len(log) == args.steps and all(
        math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        for m in log), f"non-finite loss or grad norm: {log}")
    check(losses[0] == train11["losses"][0], f"step 1's loss {losses[0]} "
          f"is not phase 11's {train11['losses'][0]}")
    check(math.isfinite(ef_norm) and ef_norm > 0,
          f"error-feedback state norm {ef_norm}")
    # the EF pass alone, on gradients of the run's scale, timed on the card
    grads = [torch.randn(e.shape, generator=gen, device=dev).mul_(1e-4)
             for e in efs]
    ef_ms = Timer(dev).ms(lambda: compression.ef_compress_(
        grads, efs, reduce_max=True), n=5)
    n_ef = sum(e.numel() for e in efs)
    ef_bound, ef_by = bound_ms(4 * 4 * n_ef, 0)
    print(f"  the EF pass (ef_compress_, {n_ef} fp32 elements, in place "
          f"leaf by leaf): {ef_ms} ms on the device, bound {ef_bound} ms "
          f"({ef_by}: g and e read and written once) [{card}]")
    del grads, efs, loop
    torch.cuda.empty_cache()
    mesh11 = {"step_s": step_s, "peak_gb": peak,
              "per_step": {k: v // args.steps for k, v in train_n.items()}}

    # --- (d) the collectives on NCCL ---------------------------------------
    x = torch.randn((4096, 3072), generator=gen, device=dev
                    ).to(torch.bfloat16)
    got = compression.compressed_psum(x, "data", mesh=mesh)
    q, s = compression.quantize(x)
    want = compression.dequantize(q, s).to(x.dtype)
    print(f"  compressed_psum over the one-rank group, (4096, 3072) bf16: "
          f"bit-identical to dequantize(quantize(x)) "
          f"{torch.equal(got, want)}")
    check(torch.equal(got, want), "compressed_psum over one rank differs "
          "from dequantize(quantize(x))")
    pipe = make_mesh((1,), ("pipe",))
    ws = [(torch.randn((PIPE_D, PIPE_D), generator=gen, device=dev)
           / math.sqrt(PIPE_D)).to(torch.bfloat16)
          for _ in range(PIPE_LAYERS)]
    xs = torch.randn((PIPE_M, PIPE_MB, PIPE_D), generator=gen, device=dev
                     ).to(torch.bfloat16)

    def stage_fn(p, a):
        for w in p["w"]:
            a = torch.tanh(a @ w)
        return a

    out = pipeline_forward(stage_fn, stage_params([{"w": w} for w in ws], 1),
                           xs, mesh=pipe)
    chain = torch.stack([stage_fn({"w": ws}, xs[i]) for i in range(PIPE_M)])
    torch.cuda.synchronize()
    print(f"  pipeline_forward, one stage of {PIPE_LAYERS} tanh(a @ w) "
          f"layers at d = {PIPE_D}, {PIPE_M} microbatches of {PIPE_MB}: "
          f"bit-identical to the sequential chain {torch.equal(out, chain)}")
    check(torch.equal(out, chain), "pipeline_forward differs from the "
          "sequential chain")
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 15")
    torch.cuda.empty_cache()
    return {MESH_SERVE: mesh_n, MESH_TRAIN: train_n}, mesh11


# ---------------------------------------------------------------------------
# phase 15 (e): one rank of a tensor-parallel mesh on the card
# ---------------------------------------------------------------------------

# llama3.2-3b as rank 0 of a 1 x 4 data x model mesh over a fake group:
# its 24/8 heads split to 6/2, its MLP's 8192 to 2048, its vocab to 32,064.
# The fake group's all-reduce adds no other rank's part, so a token
# outside rank 0's quarter of the vocab would embed to a zero row, and the
# RMS norms of a zero row (1 / sqrt(eps) each) overflow its gradient over
# 28 layers (4 layers stay finite): the tokens are drawn from rank 0's
# quarter, whose rows are their whole embeddings
TP_RANK = "llama3.2-3b (tp-rank, mesh 1x4)"
TP_SHAPE = (1, 4)
TP_STEPS, TP_BATCH, TP_SEQ, TP_ACCUM = 2, 4, 1024, 2
TP_PROMPT, TP_DECODE = 1024, 4


def _spy_attention(shapes: list):
    """``ops.attention`` recording each call's q and k shapes."""
    from repro_torch.kernels import ops

    real = ops.attention

    def spy(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    return mock.patch.object(ops, "attention", spy)


def tp_phase(dev, card: str, counters: dict, mesh11: dict) -> dict:
    """Phase 15 (e): llama3.2-3b at full width as rank 0 of a 1 x 4 mesh
    over a fake process group on the card: train steps under ``"off"``
    and a prefill and decode steps under ``"fused"`` at the split shapes,
    launches counted from 0 before each and held to the path's; each
    layer held against its plain version on the same input.  Then, over
    the same group, the recurrent mixers split over ``model``
    (:func:`tp_recurrent`).  Returns each path's launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.act_sharding import use_policy
    from repro_torch.distributed.sharding import make_activation_policy
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention_layer, mlp_layer, norm
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    check(not dist.is_initialized(), "a process group is up before 15 (e)")
    cfg = dataclasses.replace(get_config(LLAMA), ftl_mode="off", remat=True)
    scfg = dataclasses.replace(cfg, ftl_mode="fused")
    gen = torch.Generator(device=dev).manual_seed(16)
    layers = cfg.n_layers
    with fake_mesh(TP_SHAPE, ("data", "model"), device="cuda") as mesh:
        probe = torch.full((4 * 3,), float("nan"), device=dev)
        C._all_gather(probe, torch.arange(3.0, device=dev),
                      group=mesh.get_group(1))
        print(f"  fake process group ({dist.get_backend()}, world size "
              f"{dist.get_world_size()}), rank 0 of {mesh}; its all-gather "
              f"on the card gives {probe.tolist()} for rank 0's [0, 1, 2] "
              f"(no rank's data moves: the numbers below are one rank's "
              f"compute at the split shapes, not compared, held finite; "
              f"tokens from rank 0's quarter of the vocab)")
        state = S.init_train_state(cfg, 0, device=dev, mesh=mesh)
        local = C.local_tree(state.params)
        w1 = local["layers"]["pos0"]["mlp"]["w1"]["w"]
        print(f"  rank 0's shards: {sum(t.numel() for t in M.tree_leaves(local))} "
              f"of {LLAMA_PARAMS} parameters; wq {tuple(local['layers']['pos0']['attn']['wq']['w'].shape[1:])}, "
              f"w1 {tuple(w1.shape[1:])}, embed {tuple(local['embed']['tok'].shape)}")
        check(tuple(w1.shape[1:]) == (cfg.d_model, cfg.d_ff // 4),
              f"w1's shard is {tuple(w1.shape)}")

        # --- train steps under "off" -----------------------------------
        step = S.make_train_step(cfg, mesh, OptConfig(), accum=TP_ACCUM)
        vocab = cfg.vocab_size // TP_SHAPE[1]       # rank 0's rows
        toks = torch.randint(2, vocab, (TP_BATCH, TP_SEQ), generator=gen,
                             device=dev)
        _zero(counters)
        torch.cuda.reset_peak_memory_stats(dev)
        secs, metrics = [], []
        for i in range(TP_STEPS):
            # the last step profiled: the device's busy share of its wall
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) \
                if i == TP_STEPS - 1 else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                state, m = step(state, {"tokens": toks})
                metrics.append({k: float(v) for k, v in m.items()})
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        train_n = _read(counters)
        kern = _device_kernels(prof)
        busy = sum(v[1] for v in kern.values())
        print(f"  profiler, the last train step: device kernel time {busy} "
              f"ms of {1e3 * secs[-1]} ms wall, busy {busy / (1e3 * secs[-1])}"
              f"; top kernels (ms, count): " + "; ".join(
                  f"{n[:50]} {v[1]} x{v[0]}" for n, v in sorted(
                      kern.items(), key=lambda kv: -kv[1][1])[:5]))
        del prof
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        per_step = {k: v // TP_STEPS for k, v in train_n.items()}
        print(f"  {TP_STEPS} train steps of {TP_BATCH} x {TP_SEQ} tokens in "
              f"{TP_ACCUM} microbatches under 'off': step seconds {secs} "
              f"(the 1 x 1 mesh's steady step {mesh11['step_s']} s); peak "
              f"device memory {peak} GB (1 x 1: {mesh11['peak_gb']} GB); "
              f"launches a step {per_step} (1 x 1: {mesh11['per_step']}); "
              f"loss {[m['loss'] for m in metrics]}, grad norm "
              f"{[m['grad_norm'] for m in metrics]} [{card}]")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in metrics), f"non-finite train metrics {metrics}")
        want = {"flash_attention": 2 * layers * TP_ACCUM,
                "flash_attention_bwd": layers * TP_ACCUM}
        check(all(per_step.get(k, 0) == want.get(k, 0) for k in per_step),
              f"a tensor-parallel step launched {per_step}, not {want}")
        check(per_step == {k: mesh11["per_step"].get(k, 0)
                           for k in per_step},
              "the tensor-parallel step launches other kernels than the "
              "1 x 1 mesh step")

        # --- each layer's gradients through flash against the plain -----
        dparams = state.params
        del state, step
        torch.cuda.empty_cache()
        params = C.local_tree(dparams)
        positions = torch.arange(TP_SEQ, device=dev)
        x = (torch.randn((2, TP_SEQ, cfg.d_model), generator=gen,
                         device=dev) * 0.5).to(torch.bfloat16)
        rel, heads = {}, []
        for t in M.tree_leaves(params):
            t.requires_grad_(True)
        with use_policy(make_activation_policy(mesh, cfg)):
            for i, (kind, p, _) in enumerate(M._layers(cfg, params)):
                named = list(_flat_names(p))
                xi = x.detach().requires_grad_()
                cot = torch.randn(x.shape, generator=gen, device=dev
                                  ).to(x.dtype)
                wrt = [xi, *(v for _, v in named)]
                with _spy_attention(heads):
                    y = M._apply_layer(cfg, p, kind, xi,
                                       positions=positions)[0]
                    gk = torch.autograd.grad(y, wrt, cot)
                with plain_ops(("attention",)):
                    y = M._apply_layer(cfg, p, kind, xi,
                                       positions=positions)[0]
                    gp = torch.autograd.grad(y, wrt, cot)
                for name, a, b in zip(["input", *(n for n, _ in named)], gk,
                                      gp):
                    rel[f"{i}/{name}"] = _rel(a, b)
                del y, gk, gp
        for t in M.tree_leaves(params):
            t.requires_grad_(False)
        print(f"  each layer's gradients on rank 0's shards through the "
              f"flash kernels (q, k at {sorted(set(heads))}) against the "
              f"plain Function's, 2 x {TP_SEQ} tokens: worst "
              f"{_worst(rel)} (tolerance {GRAD_RTOL})")
        check(set(heads) == {((2, 6, TP_SEQ, 128), (2, 2, TP_SEQ, 128))},
              f"flash ran at {set(heads)}, not 6/2 heads")
        check(all(np.isfinite(v) and v <= GRAD_RTOL for v in rel.values()),
              "a layer's gradients through the kernels disagree with the "
              "plain Function's")
        del x

        # --- a prefill and decode steps under "fused" -------------------
        prefill = S.make_prefill_step(scfg, mesh,
                                      max_seq=TP_PROMPT + TP_DECODE)
        decode = S.make_decode_step(scfg, mesh)
        toks = torch.randint(2, vocab, (1, TP_PROMPT + TP_DECODE),
                             generator=gen, device=dev)
        _zero(counters)
        t0 = time.perf_counter()
        logits, cache = prefill(dparams, {"tokens": toks[:, :TP_PROMPT]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, dec_s = [logits], []
        for i in range(TP_PROMPT, TP_PROMPT + TP_DECODE):
            t0 = time.perf_counter()
            lg, cache = decode(dparams, cache, toks[:, i:i + 1],
                               torch.tensor(i, device=dev))
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
            out.append(lg)
        serve_n = _read(counters)
        kv = next(t for p, t in C.paths_and_leaves(cache).items()
                  if p[-1] == "k")
        print(f"  one {TP_PROMPT}-token prefill {prefill_s} s and "
              f"{TP_DECODE} decode steps {dec_s} s under 'fused'; logits "
              f"{tuple(logits.shape)} (the vocab's 4 slices gathered); KV "
              f"cache {tuple(kv.shape)} placed {kv.placements}, rank 0 "
              f"holding {tuple(kv.to_local().shape)}; launches {serve_n} "
              f"[{card}]")
        check(all(tuple(t.shape) == (1, 1, cfg.vocab_size)
                  and bool(torch.isfinite(t.float()).all()) for t in out),
              "the tensor-parallel serving steps' logits are not finite "
              "(1, 1, vocab)")
        check(tuple(kv.to_local().shape)[2] == (TP_PROMPT + TP_DECODE) // 4,
              "the KV cache is not split by sequence over model")
        want = {"flash_attention": layers,
                "fused_mlp": layers * (1 + TP_DECODE)}
        check(all(serve_n.get(k, 0) == want.get(k, 0) for k in serve_n),
              f"the tensor-parallel serving run launched {serve_n}, not "
              f"{want}")
        del cache, out, logits

        # --- each layer against its plain version on the same input -----
        heads.clear()
        shares = {"attention": [], "mlp": []}
        prompt = toks[:, :TP_PROMPT]
        positions = torch.arange(TP_PROMPT, device=dev)
        with torch.no_grad(), use_policy(make_activation_policy(mesh, scfg)):
            with plain_ops(("attention",)):
                inputs = [(p, x) for _, p, x, _, _ in
                          M.layer_stream(cfg, params, prompt)]
            for p, x in inputs:
                h = norm(p["ln1"], x, cfg.norm)
                with _spy_attention(heads):
                    a = attention_layer(scfg, p["attn"], h,
                                        positions=positions)
                with plain_ops(("attention",)):
                    a_p = attention_layer(scfg, p["attn"], h,
                                          positions=positions)
                shares["attention"].append(rule_share(a, a_p))
                h = norm(p["ln2"], x + a_p, cfg.norm)
                shares["mlp"].append(rule_share(mlp_layer(scfg, p["mlp"], h),
                                                mlp_layer(cfg, p["mlp"], h)))
        print(f"  each of the {len(inputs)} layers on the plain stream's "
              f"input ({TP_PROMPT} tokens): largest share of {ATOL} + "
              f"{RTOL}|plain| used by flash (q, k at "
              f"{sorted(set(heads))}) {max(shares['attention'])} and by the "
              f"fused MLP ({cfg.d_model} -> {cfg.d_ff // 4} on rank 0) "
              f"{max(shares['mlp'])}")
        check(len(inputs) == layers and max(shares["attention"]) <= 1.0
              and max(shares["mlp"]) <= 1.0, "a layer's output through the "
              "kernels at the split shapes differs from its plain version")
        check(set(heads) == {((1, 6, TP_PROMPT, 128),
                              (1, 2, TP_PROMPT, 128))},
              f"flash ran at {set(heads)}, not 6/2 heads")
        del dparams, params, inputs
        torch.cuda.empty_cache()
        out = {TP_RANK: {n: train_n.get(n, 0) + serve_n.get(n, 0)
                         for n in {**train_n, **serve_n}}}
        out.update(tp_recurrent(dev, card, counters, mesh))
    check(not dist.is_initialized(), "the fake group outlived 15 (e)")
    torch.cuda.empty_cache()
    return out


# the recurrent mixers split over model, as rank 0 of the same 1 x 4 mesh:
# recurrentgemma-9b's RG-LRU at W = 4096 / 4 = 1024 a rank (its 16/1 heads
# to 4/1, d_ff 12288 to 3072, vocab 256,000 to 64,000) and xlstm-1.3b's
# mLSTM (up 8192 to 2048 columns, q, k, v 1024 to 256 columns of each of
# its 4 heads, gathered whole for the scan; the gates' heads 4 to 1) and
# sLSTM (D 2048 to 512 columns, one whole head of 4).  Served: a prompt
# and decode steps, recurrentgemma at full depth under "fused", xlstm at
# the serving phase's 24 layers; trained: recurrentgemma at phase 13's
# 6 layers under "off", its microbatches as phase 13's
RG_TP = "recurrentgemma-9b (tp-rank, mesh 1x4)"
XLSTM_TP = "xlstm-1.3b (tp-rank, mesh 1x4)"
TP_REC_PROMPT, TP_REC_DECODE = 1024, 4
TP_RG_STEPS, TP_RG_BATCH, TP_RG_SEQ, TP_RG_ACCUM = 2, 2, 3072, 2


@contextlib.contextmanager
def _spy_model_gathers(seen: list):
    """``collectives.gather_full`` recording the shape of each tensor it
    gathers over a ``model`` dim of size > 1: a weight's (the steps'
    gatherer) or a cache leaf's (a decode step's)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import collectives as C

    real = C.gather_full

    def spy(x, placements, mesh, only=None):
        for i, (name, n) in enumerate(zip(mesh.mesh_dim_names, mesh.shape)):
            if name == "model" and n > 1 and isinstance(placements[i], Shard) \
                    and (only is None or i in only):
                seen.append(tuple(x.shape))
        return real(x, placements, mesh, only)

    with mock.patch.object(C, "gather_full", spy):
        yield


def _spy_op(name: str, shapes: list):
    """``ops.<name>`` recording its first argument's shape at each call."""
    from repro_torch.kernels import ops

    real = getattr(ops, name)

    def spy(*a, **kw):
        shapes.append(tuple(a[0].shape))
        return real(*a, **kw)

    return mock.patch.object(ops, name, spy)


@contextlib.contextmanager
def _own_reduce_scatter():
    """The fake group's reduce-scatter leaves its output unwritten (the
    sLSTM's output gate sums its row-parallel product through one, and
    the RG-LRU's gathered conv output sends its gradient back through
    one); in its place each call keeps this rank's chunk of its own
    input: the sum with every other rank's part missing, as the fake
    all-reduce leaves a tensor as it is."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    def own(out, src, group=None):
        n = dist.get_world_size(group)
        out.copy_(src.chunk(n)[dist.get_rank(group)])

    with mock.patch.object(C, "_reduce_scatter", own):
        yield


def _tp_serve(dev, card: str, counters: dict, mesh, cfg, label: str,
              op: str, op_shape: tuple, want: dict, seed: int) -> dict:
    """``cfg`` served as rank 0 of ``mesh``: the sharded init, one
    prompt of TP_REC_PROMPT tokens from rank 0's quarter of the vocab and
    TP_REC_DECODE decode steps through the mesh serving steps, launches
    counted from 0 before and held to ``want``; ``op``'s kernel at
    ``op_shape``; no gather over ``model`` of a weight or a cache leaf;
    each cache leaf's local shard of ``cache_pspecs``' shard shape; the
    logits finite.  Then every layer on the plain stream's input, each
    of its parts through a kernel against its plain version by phase 2's
    rule: the recurrent mixer (``op`` at ``op_shape``), the attention
    (flash at this rank's heads) and the MLP (fused, at this rank's
    d_ff).  Returns the launches."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.act_sharding import use_policy
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  cache_pspecs,
                                                  make_activation_policy)
    from repro_torch.models import model as M
    from repro_torch.models.layers import attention_layer, mlp_layer, norm
    from repro_torch.train import steps as S

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    dparams = S._init_sharded_params(cfg, gen, dev, mesh)
    torch.cuda.synchronize()
    local = C.local_tree(dparams)
    mix = local["layers"]["pos0"]["mix"]
    print(f"  {label}: {cfg.n_layers} layers {M.period_kinds(cfg)}, rank "
          f"0's shards {sum(t.numel() for t in M.tree_leaves(local))} "
          f"parameters, initialised in {time.perf_counter() - t0} s; "
          f"pos0's mixer: " + ", ".join(
              f"{k} {tuple(v.shape[1:])}" for k, v in
              C.paths_and_leaves(mix).items() if v.ndim > 2))
    n, d = TP_REC_PROMPT, TP_REC_DECODE
    toks = torch.randint(2, cfg.vocab_size // TP_SHAPE[1], (1, n + d),
                         generator=gen, device=dev)
    prefill = S.make_prefill_step(cfg, mesh, max_seq=n + d)
    decode = S.make_decode_step(cfg, mesh)
    seen, shapes = [], []
    _zero(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    with _own_reduce_scatter(), _spy_model_gathers(seen), \
            _spy_op(op, shapes):
        t0 = time.perf_counter()
        logits, cache = prefill(dparams, {"tokens": toks[:, :n]})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, dec_s = [logits], []
        for i in range(n, n + d):
            t0 = time.perf_counter()
            lg, cache = decode(dparams, cache, toks[:, i:i + 1],
                               torch.tensor(i, device=dev))
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
            out.append(lg)
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    leaves = C.paths_and_leaves(cache)
    specs = C.paths_and_leaves(cache_pspecs(M.tree_map(
        lambda t: torch.empty(t.shape, device="meta"), cache), mesh, cfg))
    local_shapes = {p: (tuple(t.to_local().shape),
                        NamedSharding(mesh, specs[p]).shard_shape(
                            tuple(t.shape))) for p, t in leaves.items()}
    state = {"/".join(p[1:]): v[0] for p, v in local_shapes.items()
             if p[-1] not in ("k", "v")}
    print(f"  one {n}-token prefill {prefill_s} s and {d} decode steps "
          f"{dec_s} s; peak device memory {peak} GB; {op} at "
          f"{sorted(set(shapes))}; launches {launches}; decode state on "
          f"rank 0 (local shards): {state}; gathers over model of a weight "
          f"or a cache leaf: {len(seen)} [{card}]")
    check(all(tuple(t.shape) == (1, 1, cfg.vocab_size)
              and bool(torch.isfinite(t.float()).all()) for t in out),
          f"{label}: the serving steps' logits are not finite (1, 1, "
          f"vocab)")
    check(all(a == b for a, b in local_shapes.values()),
          f"{label}: cache leaves whose local shard is not cache_pspecs' "
          f"shard shape: {[(p, a, b) for p, (a, b) in local_shapes.items() if a != b]}")
    check(seen == [], f"{label}: {len(seen)} gathers over model of a weight "
          f"or a cache leaf: {seen[:4]}")
    check(all(launches.get(k, 0) == want.get(k, 0) for k in launches),
          f"{label}: the serving run launched {launches}, not {want}")
    check(set(shapes) == {op_shape},
          f"{label}: the serving run's {op} ran at {set(shapes)}, not "
          f"{op_shape}")
    del cache, out, logits

    # --- every layer's parts against their plain versions -----------------
    ocfg = dataclasses.replace(cfg, ftl_mode="off")
    scfg = dataclasses.replace(cfg, ftl_mode="fused")
    prompt = toks[:, :n]
    positions = torch.arange(n, device=dev)
    m = TP_SHAPE[1]
    shares: dict = {}
    heads = []
    shapes.clear()
    with torch.no_grad(), _own_reduce_scatter(), \
            use_policy(make_activation_policy(mesh, cfg)):
        with plain_ops(("attention", op)):
            stream = [(kind, p, x) for kind, p, x, _, _ in
                      M.layer_stream(ocfg, local, prompt)]
        for kind, p, x in stream:
            if kind in M.MIXERS:
                with _spy_op(op, shapes):
                    y = M.MIXERS[kind].block(cfg, p["mix"], x)
                with plain_ops((op,)):
                    y_p = M.MIXERS[kind].block(cfg, p["mix"], x)
            else:
                h = norm(p["ln1"], x, cfg.norm)
                win = M._window(cfg, kind)
                with _spy_attention(heads):
                    y = attention_layer(cfg, p["attn"], h,
                                        positions=positions, window=win)
                with plain_ops(("attention",)):
                    y_p = attention_layer(cfg, p["attn"], h,
                                          positions=positions, window=win)
                kind = "attention"
            shares.setdefault(kind, []).append(rule_share(y, y_p))
            if "mlp" in p:
                h = norm(p["ln2"], x + y_p, cfg.norm)
                shares.setdefault("mlp", []).append(rule_share(
                    mlp_layer(scfg, p["mlp"], h),
                    mlp_layer(ocfg, p["mlp"], h)))
    print(f"  every layer on the plain stream's input ({n} tokens), {op} "
          f"at {sorted(set(shapes))}" + (
              f", flash (q, k) at {sorted(set(heads))}" if heads else "") + (
              f", the fused MLP at {cfg.d_model} -> {cfg.d_ff // m}"
              if "mlp" in shares else "") + f": largest "
          f"share of {ATOL} + {RTOL}|plain| used, by part: "
          f"{ {k: max(v) for k, v in shares.items()} } "
          f"({ {k: len(v) for k, v in shares.items()} } layers)")
    check(sum(len(v) for k, v in shares.items() if k != "mlp")
          == cfg.n_layers and all(v <= 1.0 for vs in shares.values()
                                  for v in vs),
          f"{label}: a layer's part at the split shapes differs from its "
          f"plain version")
    check(set(shapes) == {op_shape},
          f"{label}: {op} ran at {set(shapes)}, not {op_shape}")
    n_attn = len(shares.get("attention", []))
    hd = cfg.head_dim
    check(n_attn == 0 or set(heads) == {
        ((1, cfg.n_heads // m, n, hd),
         (1, max(1, cfg.n_kv_heads // m), n, hd))},
        f"{label}: flash ran at {set(heads)}, not "
        f"{cfg.n_heads // m}/{max(1, cfg.n_kv_heads // m)} heads")
    check(len(shares.get("mlp", [])) == (cfg.n_layers if want.get(
        "fused_mlp") else 0), f"{label}: not every layer's MLP was held "
        f"against its plain version")
    del dparams, local, stream
    torch.cuda.empty_cache()
    return launches


def _tp_train_rg(dev, card: str, counters: dict, mesh) -> dict:
    """recurrentgemma-9b at phase 13's depth as rank 0 of ``mesh``: the
    sharded train state, TP_RG_STEPS steps of TP_RG_BATCH x TP_RG_SEQ
    tokens in TP_RG_ACCUM microbatches under ``"off"``, each making
    phase 13's launches; the RG-LRU scan and its backward at W = 1024;
    no gather over ``model``; each layer's gradients through the kernels
    against the plain Functions' within GRAD_RTOL.  Returns the
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.device import torch_dtype
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.act_sharding import use_policy
    from repro_torch.distributed.sharding import make_activation_policy
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as S

    cfg = dataclasses.replace(get_config(RG), ftl_mode="off", remat=True,
                              n_layers=RG_TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(18)
    state = S.init_train_state(cfg, 0, device=dev, mesh=mesh)
    step = S.make_train_step(cfg, mesh, OptConfig(), accum=TP_RG_ACCUM)
    toks = torch.randint(2, cfg.vocab_size // TP_SHAPE[1],
                         (TP_RG_BATCH, TP_RG_SEQ), generator=gen, device=dev)
    seen, shapes, secs, metrics = [], [], [], []
    _zero(counters)
    torch.cuda.reset_peak_memory_stats(dev)
    with _own_reduce_scatter(), _spy_model_gathers(seen), \
            _spy_op("rg_lru", shapes):
        for _ in range(TP_RG_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": toks})
            metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = {k: v // TP_RG_STEPS for k, v in launches.items()}
    want = next(t for t in TRAIN_PATHS if t.label == RG_TRAIN).per_step
    print(f"  {RG} at {cfg.n_layers} layers, {TP_RG_STEPS} train steps of "
          f"{TP_RG_BATCH} x {TP_RG_SEQ} tokens in {TP_RG_ACCUM} microbatches "
          f"under 'off': step seconds {secs}; peak device memory {peak} GB; "
          f"launches a step {per_step} (phase 13's {want}); rg_lru at "
          f"{sorted(set(shapes))}; loss {[m['loss'] for m in metrics]}, "
          f"grad norm {[m['grad_norm'] for m in metrics]}; gathers over "
          f"model {len(seen)} [{card}]")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in metrics), f"non-finite train metrics {metrics}")
    check(all(per_step.get(k, 0) == want.get(k, 0) for k in per_step),
          f"a tensor-parallel recurrentgemma step launched {per_step}, not "
          f"{want}")
    check(set(shapes) == {(TP_RG_BATCH // TP_RG_ACCUM, TP_RG_SEQ,
                           cfg.lru_width // TP_SHAPE[1])},
          f"rg_lru ran at {set(shapes)}")
    check(seen == [], f"{len(seen)} gathers over model in the train steps")

    # --- each layer's gradients through the kernels against the plain ----
    dparams = state.params
    del state, step
    torch.cuda.empty_cache()
    params = C.local_tree(dparams)
    positions = torch.arange(TP_RG_SEQ, device=dev)
    x = (torch.randn((1, TP_RG_SEQ, cfg.d_model), generator=gen,
                     device=dev) * 0.5).to(torch_dtype(cfg.dtype))
    rel = {}
    for t in M.tree_leaves(params):
        t.requires_grad_(True)
    with _own_reduce_scatter(), \
            use_policy(make_activation_policy(mesh, cfg)):
        for i, (kind, p, _) in enumerate(M._layers(cfg, params)):
            named = list(_flat_names(p))
            xi = x.detach().requires_grad_()
            cot = torch.randn(x.shape, generator=gen, device=dev
                              ).to(x.dtype)
            wrt = [xi, *(v for _, v in named)]
            y = M._apply_layer(cfg, p, kind, xi, positions=positions)[0]
            gk = torch.autograd.grad(y, wrt, cot)
            with plain_ops(("attention", "rg_lru")):
                y = M._apply_layer(cfg, p, kind, xi, positions=positions)[0]
                gp = torch.autograd.grad(y, wrt, cot)
            for name, a, b in zip(["input", *(n for n, _ in named)], gk, gp):
                rel[f"{i}/{name}"] = _rel(a, b)
            del y, gk, gp
    for t in M.tree_leaves(params):
        t.requires_grad_(False)
    print(f"  each layer's gradients on rank 0's shards through the flash "
          f"and RG-LRU kernels against the plain Functions', 1 x "
          f"{TP_RG_SEQ} tokens: worst {_worst(rel)} (tolerance "
          f"{GRAD_RTOL})")
    check(all(np.isfinite(v) and v <= GRAD_RTOL for v in rel.values()),
          "a recurrentgemma layer's gradients through the kernels disagree "
          "with the plain Functions' at the split shapes")
    del dparams, params, x
    torch.cuda.empty_cache()
    return launches


def tp_recurrent(dev, card: str, counters: dict, mesh) -> dict:
    """The recurrent mixers as rank 0 of ``mesh`` (15 (e), after llama):
    recurrentgemma-9b served at full depth and trained at phase 13's,
    xlstm-1.3b served at 24 layers.  Returns each path's launches."""
    from repro_torch.configs import get_config

    out = {}
    rg = dataclasses.replace(get_config(RG), ftl_mode="fused")
    w = rg.lru_width // TP_SHAPE[1]
    print(f"  the recurrent mixers split over model: {RG} (W {w} a rank)")
    n_rec = sum(k == "rec" for k in _kinds(rg))
    n_attn = rg.n_layers - n_rec
    serve = _tp_serve(dev, card, counters, mesh, rg, RG_TP, "rg_lru",
                      (1, TP_REC_PROMPT, w),
                      {"rg_lru_scan": n_rec, "flash_attention": n_attn,
                       "fused_mlp": rg.n_layers * (1 + TP_REC_DECODE)}, 19)
    train = _tp_train_rg(dev, card, counters, mesh)
    out[RG_TP] = {k: serve.get(k, 0) + train.get(k, 0)
                  for k in {**serve, **train}}
    xl = dataclasses.replace(get_config(XLSTM), ftl_mode="off",
                             n_layers=XLSTM_SERVE_LAYERS)
    print(f"  {XLSTM} at {xl.n_layers} layers")
    e = xl.xlstm_expand * xl.d_model
    out[XLSTM_TP] = _tp_serve(
        dev, card, counters, mesh, xl, XLSTM_TP, "mlstm",
        (1, xl.n_heads, TP_REC_PROMPT, e // xl.n_heads),
        {"mlstm_scan": sum(k == "mlstm" for k in _kinds(xl))}, 20)
    return out


def _kinds(cfg) -> list:
    """Every layer's mixer kind, in order."""
    from repro_torch.models import model as M

    kinds, n, rem = M._layer_split(cfg)
    return kinds * n + rem


# ---------------------------------------------------------------------------
# phase 16: the dry-run and the roofline, and the memory count on the card
# ---------------------------------------------------------------------------

# the dry-run's cells on the card, each one CLI call in its own process
# (its fake process group never meets phase 15's NCCL group), all started
# together: (arch, shape, extra flags)
DRYRUN_CELLS = (
    (LLAMA, "train_4k", ()),
    (LLAMA, "train_4k", ("--multi-pod",)),
    (LLAMA, "prefill_32k", ()),
    (LLAMA, "decode_32k", ()),
    (MOE, "prefill_32k", ("--opt",)),
    (XLSTM, "long_500k", ()),
    # the counts of the split over model for both MoE configs and the
    # RG-LRU
    (MOE, "train_4k", ()),
    ("moonshot-v1-16b-a3b", "train_4k", ()),
    (RG, "train_4k", ()),
)
DRYRUN_TIMEOUT_S = 600
# the card's HBM: the memory term's rate and the capacity a cell must fit
H100_HBM_BYTES = 80e9
# the memory count on the card: op_cost's peak live bytes (the step's
# arguments and what it makes) against torch.cuda.max_memory_allocated()
# over the same call, relative to the latter; set before the first run
MEM_COUNT_RTOL = 0.05
MEM_PREFILL_T = 4096
# the blockwise plain attention against flash and the naive plain version:
# llama's GQA 24/8 at T = 8192, head_dim 128, causal, bf16
BLOCKWISE_SHAPE = (1, 24, 8, 8192, 128)
MEMCOUNT = "llama3.2-3b (prefill under op_cost)"


def start_dryrun(out: Path) -> list:
    """Start one ``python -m repro_torch.launch.dryrun`` a cell; returns
    (cell, process, log path) for each."""
    import os

    out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "FTL_TARGET"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = []
    for arch, shape, flags in DRYRUN_CELLS:
        log = out / f"{arch}__{shape}{''.join(flags)}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, *flags, "--out", str(out)]
        procs.append(((arch, shape, flags),
                      subprocess.Popen(cmd, cwd=ROOT, env=env,
                                       stdout=log.open("w"),
                                       stderr=subprocess.STDOUT), log))
    return procs


def finish_dryrun(procs: list, out: Path, card: str, t0: float) -> None:
    """Phase 16 (a): wait for every cell's process and check its record:
    ``ok``, planned and priced for ``h100`` (detected), the memory term at
    3.35 TB/s, ``mfu_bound <= 1``; print what each cell found."""
    for (arch, shape, flags), proc, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for _, p, _ in procs:
                p.kill()
            raise RuntimeError(f"chip_smoke: the dry-run of {arch} {shape} "
                               f"took over {DRYRUN_TIMEOUT_S} s")
        check(rc == 0, f"dry-run {arch} {shape} {flags} exited {rc}: "
              f"{log.read_text()[-3000:]}")
    print(f"  {len(procs)} dry-run processes done in "
          f"{time.perf_counter() - t0} s ({card})")
    ratios = {}
    for (arch, shape, flags), _, _ in procs:
        mesh = "2x16x16" if "--multi-pod" in flags else "16x16"
        rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
        roof, cost, mem = rec["roofline"], rec["cost"], rec["memory"]
        check(rec["status"] == "ok", f"dry-run {arch} {shape} {mesh}: "
              f"{rec['status']}")
        check(rec["ftl_target"] == "h100" and roof["target"] == "h100",
              f"dry-run {arch} {shape}: planned for {rec['ftl_target']}, "
              f"priced for {roof['target']}, not the detected h100")
        t_mem = cost["bytes_per_chip"] / HBM_BPS
        check(abs(roof["t_memory_s"] - t_mem) <= 1e-6 + 1e-6 * t_mem,
              f"dry-run {arch} {shape}: t_memory {roof['t_memory_s']} s is "
              f"not its bytes at {HBM_BPS} B/s ({t_mem} s)")
        check(roof["mfu_bound"] <= 1, f"dry-run {arch} {shape}: mfu_bound "
              f"{roof['mfu_bound']} > 1")
        coll = {k: v for k, v in rec["collectives"]["by_kind"].items() if v}
        opt = " --opt" if "--opt" in flags else ""
        print(f"  [{mesh}] {arch} {shape}{opt}: traced in "
              f"{rec['lower_s']} s; per chip "
              f"{cost['flops_per_chip']} FLOPs ({cost['matmul_flops_per_chip']}"
              f" in matmuls), {cost['bytes_per_chip']} bytes; collectives "
              f"{rec['collectives']['count']} ops, bytes by kind {coll}; "
              f"t_compute {roof['t_compute_s']} s, t_memory "
              f"{roof['t_memory_s']} s, t_collective {roof['t_collective_s']}"
              f" s, dominant {roof['dominant']}, model_flops "
              f"{roof['model_flops']}, useful_flops_ratio "
              f"{roof['useful_flops_ratio']}, mfu_bound {roof['mfu_bound']}; "
              f"peak {mem['peak_bytes']} B (arguments "
              f"{mem['argument_size_in_bytes']}, temporaries "
              f"{mem['temp_size_in_bytes']}), fits {H100_HBM_BYTES:.0e}: "
              f"{mem['peak_bytes'] <= H100_HBM_BYTES}")
        if shape == "train_4k" and mesh == "16x16":
            ratios[arch] = (cost["flops_per_chip"],
                            roof["useful_flops_ratio"])
    print(f"  train_4k on 16 x 16, split over model: (FLOPs a chip, "
          f"useful_flops_ratio) {ratios}")


def memory_count(dev, card: str, counters: dict) -> dict:
    """Phase 16 (b): llama3.2-3b at full width, one 4096-token prefill
    through ``make_prefill_step`` (no mesh) under ``serving_ftl_mode``,
    under ``op_cost`` on the card's tensors: its peak live bytes against
    ``torch.cuda.max_memory_allocated()`` over the same call, flash and
    the fused MLP launched once a layer; the same step traced on fake CPU
    tensors (the plain path); the model-FLOPs share of the card's peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.serve import serving_ftl_mode
    from repro_torch.models import model as M
    from repro_torch.roofline import model_flops
    from repro_torch.roofline.op_cost import analyze_step
    from repro_torch.train import steps as S

    mode = serving_ftl_mode(get_config(LLAMA))
    cfg, params, _ = load_model(LLAMA, dev, mode)
    gen = torch.Generator(device=dev).manual_seed(16)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (1, MEM_PREFILL_T),
                                     generator=gen, device=dev)}
    step = S.make_prefill_step(cfg)
    step(params, batch)                      # warm-up: cuBLAS, the plans
    torch.cuda.synchronize()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    res = analyze_step(step, params, batch)
    torch.cuda.synchronize()
    n = _read(counters)
    measured = torch.cuda.max_memory_allocated()
    args = res["argument_size_in_bytes"]
    # what the allocator held before the call that is not an argument
    # (nothing else of the script is alive here) counts on both sides
    other = base - args
    counted = res["peak_bytes"] + other
    gap = (counted - measured) / measured
    print(f"  {cfg.name} prefill, 1 x {MEM_PREFILL_T} tokens, ftl_mode "
          f"{mode!r}, under op_cost on the card ({card}): arguments "
          f"{args} B, temporaries {res['temp_size_in_bytes']} B, peak "
          f"{res['peak_bytes']} B; allocated before the call {base} B "
          f"({other} B besides the arguments); max_memory_allocated "
          f"{measured} B (temporaries {measured - base} B); counted peak "
          f"{counted} B, gap {gap} (limit {MEM_COUNT_RTOL}); launches {n}")
    check(abs(gap) <= MEM_COUNT_RTOL, f"op_cost's peak {counted} B is not "
          f"within {MEM_COUNT_RTOL} of max_memory_allocated {measured} B")
    check(n["flash_attention"] == cfg.n_layers
          and n["fused_mlp"] == cfg.n_layers,
          f"the prefill under op_cost launched {n}, not flash and the fused "
          f"MLP once a layer")
    # the step's time, with no mode around it
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    secs = statistics.median(times)
    mf = model_flops(cfg, ShapeSpec("smoke", "prefill", MEM_PREFILL_T, 1))
    share = mf / (secs * BF16_FLOPS)
    print(f"  the prefill takes {secs} s (median of 3: {times}); "
          f"model_flops {mf}, {share} of {BF16_FLOPS:.3e} FLOP/s ({card})")
    check(share <= 1, f"model-FLOPs share {share} > 1")
    del params, batch
    torch.cuda.empty_cache()
    # the same step on fake CPU tensors: the plain path, naive attention
    shapes = M.param_shapes(cfg)
    with FakeTensorMode():
        fparams = M.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="cpu"), shapes)
        ftoks = torch.empty((1, MEM_PREFILL_T), dtype=torch.int64,
                            device="cpu")
        t0 = time.perf_counter()
        plain = analyze_step(step, fparams, {"tokens": ftoks})
    print(f"  the same step on fake CPU tensors (the plain path: naive "
          f"attention, the hidden tensor written), traced in "
          f"{time.perf_counter() - t0} s: peak {plain['peak_bytes']} B "
          f"(temporaries {plain['temp_size_in_bytes']} B) against the "
          f"card's counted {res['peak_bytes']} B (temporaries "
          f"{res['temp_size_in_bytes']} B), {plain['peak_bytes'] / res['peak_bytes']}x; "
          f"FLOPs {plain['flops']} plain, {res['flops']} on the card's "
          f"path (its kernels' work is not counted: op_cost sees the ops "
          f"around them)")
    return {MEMCOUNT: n}


def blockwise_vs_flash(dev, card: str, timer) -> None:
    """Phase 16 (c): ``ref.attention_blockwise`` on the card at llama's
    GQA 24/8, T = 8192, against the flash kernel and the naive plain
    version by phase 2's rule; its time beside flash's and SDPA's."""
    from repro_torch.kernels import flash_attention, ref

    b, hq, hk, t, d = BLOCKWISE_SHAPE
    randn = normal_bf16(dev, 161)
    q, k, v = randn(b, hq, t, d), randn(b, hk, t, d), randn(b, hk, t, d)
    blk = ref.attention_blockwise(q, k, v, causal=True, block_k=1024)
    flash = flash_attention.flash_attention(q, k, v, causal=True)
    naive = ref.attention(q, k, v, causal=True)
    compare(blk, flash, f"blockwise plain attention ({b}, {hq}/{hk}, {t}, "
            f"{d}), causal, block 1024, against the flash kernel")
    compare(blk, naive, "the same against the naive plain version")
    del naive
    torch.cuda.empty_cache()
    ms = {"blockwise": timer.ms(lambda: ref.attention_blockwise(
              q, k, v, causal=True, block_k=1024), n=5),
          "flash": timer.ms(lambda: flash_attention.flash_attention(
              q, k, v, causal=True)),
          "sdpa": timer.ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True, enable_gqa=True)),
          "naive": timer.ms(lambda: ref.attention(q, k, v, causal=True),
                            n=3)}
    print(f"  ms (CUDA events, median, L2 flushed; {card}): blockwise "
          f"{ms['blockwise']}, flash kernel {ms['flash']}, SDPA "
          f"{ms['sdpa']}, naive plain {ms['naive']}; blockwise / flash "
          f"{ms['blockwise'] / ms['flash']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import (_build, flash_attention, fused_mlp,
                                     gemm, gemm_act, mlstm, rg_lru)
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _default_buckets, serving_ftl_mode
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== set-up")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    card = gpu_line()
    print(card)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"  built {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0} s")
    # the fused MLP's schedule sizes the ring and the slice from
    # fused_mlp.smem_bytes; it must be the footprint the CUDA launcher asks
    # for, at every schedule the served widths and the buckets give
    from repro_torch.models.model import PREFILL_BUCKETS
    for k_, f_, gated in ((3072, 8192, True), (4096, 12288, True),
                          (6144, 24576, False),
                          # the MoE configs' shared experts: qwen2-moe's
                          # and moonshot's
                          (2048, 5632, True), (2048, 2816, True),
                          # llama-3.2-vision-90b's MLP
                          (8192, 28672, True)):
        for m in (4, *PREFILL_BUCKETS):
            s = fused_mlp.schedule(m, k_, f_, k_, gated)
            got = _build.lib().rt_fused_mlp_smem_bytes(
                s.block_m, s.block_f, s.hidden_chunk, s.stages, int(gated))
            check(got == s.smem_bytes, f"fused_mlp footprint at {s.label}: "
                  f"Python {s.smem_bytes}, CUDA {got}")
    # the registry binds the GEMM kernels from gemm.SMEM_BYTES; it must be
    # the footprint the CUDA launcher asks for
    check(_build.lib().rt_gemm_smem_bytes() == gemm.SMEM_BYTES,
          f"gemm footprint: Python {gemm.SMEM_BYTES}, CUDA "
          f"{_build.lib().rt_gemm_smem_bytes()}")
    # and flash attention's footprint at every head dim and tile height
    for dh in flash_attention.HEAD_DIMS:
        for bq in flash_attention.BLOCK_Q:
            got = _build.lib().rt_flash_smem_bytes(
                dh, bq, flash_attention.stages_for(dh, bq))
            check(got == flash_attention.smem_bytes_for(dh, bq),
                  f"flash_attention footprint at D={dh}, BQ={bq}: Python "
                  f"{flash_attention.smem_bytes_for(dh, bq)}, CUDA {got}")
    # and the flash backward's, at the tile each head dim builds and every
    # ring depth
    for dh in flash_attention.HEAD_DIMS:
        for kern, tiles in ((0, flash_attention.BWD_BLOCK_K),
                            (1, flash_attention.BWD_BLOCK_Q)):
            for tile in (tiles[dh],):
                for st in range(2, flash_attention.MAX_STAGES + 1):
                    got = _build.lib().rt_flash_bwd_smem_bytes(
                        kern, dh, tile, st)
                    want = flash_attention.bwd_smem_bytes(
                        ("dkdv", "dq")[kern], dh, tile, st)
                    check(got == want, f"flash_attention_bwd footprint "
                          f"(kernel {kern}, D={dh}, tile {tile}, {st} "
                          f"stages): Python {want}, CUDA {got}")
    # and the mLSTM scan's, and its backward's at every head dim
    st = mlstm.stages_for()
    got = (_build.lib().rt_mlstm_smem_bytes(st),
           _build.lib().rt_mlstm_qk_smem_bytes())
    want = (mlstm.smem_bytes_for(st), mlstm.qk_smem_bytes())
    check(got == want, f"mlstm_scan footprints: Python {want}, CUDA {got}")
    for dh in range(32, mlstm.MAX_HEAD_DIM + 1, 32):
        s = mlstm.bwd_schedule(1, 1, 64, dh)
        got = [_build.lib().rt_mlstm_bwd_smem_bytes(k, dh) for k in range(3)]
        want = [s.prep_smem_bytes, s.state_smem_bytes, s.grad_smem_bytes]
        check(got == want, f"mlstm_scan_bwd footprints at Dh={dh}: Python "
              f"{want}, CUDA {got}")
    print(f"  mlstm_scan_bwd footprints (prep, state pass, gradients) at "
          f"Dh=1024: {want} B, as the launcher's")
    # and the RG-LRU scan's and its backward's, at every tile and chunk
    # their schedule picks
    for ct, chunk in rg_lru.LADDER:
        got = (_build.lib().rt_rg_lru_smem_bytes(ct, chunk),
               _build.lib().rt_rg_lru_bwd_smem_bytes(ct, chunk))
        want = (rg_lru.smem_bytes(ct, chunk),
                rg_lru.bwd_smem_bytes(ct, chunk))
        check(got == want, f"rg_lru_scan footprints (forward, backward) "
              f"at tile {ct}, chunk {chunk}: Python {want}, CUDA {got}")
    build_log = (lib.parent / "build.log").read_text()
    for line in build_log.splitlines():
        if line.startswith("==") or "Compiling entry" in line \
                or "Used" in line or "spill" in line:
            print("  ptxas:" + line.split("ptxas info    :")[-1])
    check_new_builds(build_log)

    print("== kernels against their plain versions (bf16)")
    results = kernel_cases(dev, Timer(dev))

    kernels = {"gemm": gemm, "flash_attention": flash_attention,
               "fused_mlp": fused_mlp, "rg_lru_scan": rg_lru,
               "gemm_act": gemm_act, "mlstm_scan": mlstm}
    # every launch counter: the serving kernels', and the backward kernels'
    counters = {**{n: (m, "launches") for n, m in kernels.items()},
                "flash_attention_bwd": (flash_attention, "bwd_launches"),
                "rg_lru_scan_bwd": (rg_lru, "bwd_launches"),
                "mlstm_scan_bwd": (mlstm, "bwd_launches")}
    # each model's weights load after the one before is freed: granite-20b's
    # 40.6 GB after recurrentgemma-9b's, xlstm-1.3b's 2.2 GB last
    paths = {LLAMA: (("gemm", "flash_attention", "fused_mlp"),
                     dict(max_seq=1024, lens_range=(128, 960)), 256),
             MOE: (("flash_attention", "fused_mlp"),
                   dict(max_seq=1024, lens_range=(128, 960)), 512),
             RG: (("gemm", "flash_attention", "fused_mlp", "rg_lru_scan"),
                  dict(max_seq=4096, lens_range=(128, 3072)), 2500),
             GRANITE: (("gemm", "flash_attention", "gemm_act"),
                       dict(max_seq=2048, lens_range=(128, 1920)), 256),
             XLSTM: (("mlstm_scan",),
                     dict(max_seq=2048, lens_range=(128, 1920)), 1000),
             # whisper's decoder context is 448 tokens
             WHISPER: (("gemm", "flash_attention", "gemm_act"),
                       dict(max_seq=448, lens_range=(4, 224)), 200),
             VLM: (("flash_attention", "fused_mlp"),
                   dict(max_seq=1024, lens_range=(128, 960)), 256)}
    # served at full width with the depth cut: (layers, count_params there)
    cuts = {XLSTM: (XLSTM_SERVE_LAYERS, XLSTM_SERVE_PARAMS),
            VLM: (VLM_SERVE_LAYERS, VLM_SERVE_PARAMS)}
    launches = {}
    for arch, (names, serve_kw, n_plain) in paths.items():
        mode = serving_ftl_mode(get_config(arch))
        cut = {"n_layers": cuts[arch][0]} if arch in cuts else {}
        print(f"== serve {arch}, full width"
              + (f", {cut['n_layers']} layers" if cut else "")
              + f", ftl_mode={mode} (at {time.perf_counter() - t_start} s)")
        cfg, params, n_params = load_model(arch, dev, mode, **cut)
        want_params = cuts[arch][1] if cut else N_PARAMS.get(arch)
        if want_params is not None:
            check(n_params == want_params, f"{n_params} parameters, the "
                  f"reference counts {want_params}")
        extras = model_extras(cfg, dev)
        per_call = PER_CALL.get(arch)
        if cfg.is_encoder_decoder:
            print(f"  encoder {cfg.n_encoder_layers} layers over "
                  f"{cfg.encoder_seq} frames, frames N(0, 1) from a seed")
            per_call = encdec_launches(cfg, dev, _default_buckets(
                serve_kw["max_seq"], 16))
        if cfg.family == "vlm":
            for key, kind in zip(params["layers"], M.period_kinds(cfg)):
                if kind == "cross":
                    params["layers"][key]["xgate"].fill_(VLM_XGATE)
            print(f"  xgate set to {VLM_XGATE} in every cross layer for this "
                  f"phase (tanh {float(np.tanh(VLM_XGATE))}); image "
                  f"embeddings ({cfg.n_image_tokens}, {cfg.d_model}) N(0, 1) "
                  f"from a seed")
        launches[arch] = serve_phase(
            dev, cfg, params, {n: kernels[n] for n in names},
            want=WANT_EXECUTORS[arch], per_call=per_call,
            absent={n: kernels[n] for n in ABSENT.get(arch, ())},
            extras=extras, **serve_kw)
        if cfg.is_encoder_decoder:
            print(f"== {arch}: served path against the plain path, engine "
                  f"against model at the bucket (at "
                  f"{time.perf_counter() - t_start} s)")
            encdec_served_vs_plain(cfg, params, dev, extras["frames"],
                                   n_plain)
            engine_vs_model(cfg, params, dev, n_plain,
                            max_seq=serve_kw["max_seq"], padded_loop=True,
                            extras=extras)
        elif cfg.family == "vlm":
            print(f"== {arch}: cross layers and logits against the plain "
                  f"path, engine against model at the bucket (at "
                  f"{time.perf_counter() - t_start} s)")
            cross_vs_plain(cfg, params, dev, extras["image_embeds"], n_plain)
            served_vs_plain(cfg, params, dev, n_plain, extras)
            engine_vs_model(cfg, params, dev, 200,
                            max_seq=serve_kw["max_seq"], padded_loop=True,
                            extras=extras)
        elif cfg.is_moe:
            print(f"== {arch}: served path against the plain path, engine "
                  f"against model at the bucket (at "
                  f"{time.perf_counter() - t_start} s)")
            moe_served_vs_plain(cfg, params, dev, n_plain)
            engine_vs_model(cfg, params, dev, 1000,
                            max_seq=serve_kw["max_seq"], padded_loop=True)
        elif cfg.family == "ssm":
            print(f"== {arch}: forward against decode, engine against model "
                  f"(at {time.perf_counter() - t_start} s)")
            forward_vs_decode(cfg, params, dev, 256)
            engine_vs_model(cfg, params, dev, n_plain,
                            max_seq=serve_kw["max_seq"], padded_loop=True)
            forward_timed(cfg, params, dev)
        else:
            print(f"== {arch}: served path against the plain path (at "
                  f"{time.perf_counter() - t_start} s)")
            served_vs_plain(cfg, params, dev, n_plain)
        if cfg.family == "hybrid":
            engine_vs_model(cfg, params, dev, n_plain)
        del params
        torch.cuda.empty_cache()
    # each model's training state after the one before is freed
    trained = {}
    for path in TRAIN_PATHS:
        print(f"== train {path.label}, full width, through the trainer (at "
              f"{time.perf_counter() - t_start} s)")
        launches[path.label], trained[path.label] = train_phase(
            dev, card, counters, path)
    print(f"== planner tooling on the card (at "
          f"{time.perf_counter() - t_start} s)")
    launches[TOOLING] = tooling_phase(
        dev, {n: kernels[n] for n in ("gemm", "flash_attention",
                                      "fused_mlp")})
    print(f"== the distributed layer on one card: a one-rank NCCL mesh (at "
          f"{time.perf_counter() - t_start} s)")
    mesh_n, mesh11 = mesh_phase(dev, card, counters, trained[TRAIN])
    launches.update(mesh_n)
    print(f"== 15 (e): one rank of a 1 x 4 tensor-parallel mesh over a fake "
          f"group (at {time.perf_counter() - t_start} s)")
    launches.update(tp_phase(dev, card, counters, mesh11))
    print(f"== the dry-run and the roofline at full width, the memory count "
          f"on the card (at {time.perf_counter() - t_start} s)")
    t16 = time.perf_counter()
    dry_out = ROOT / "build" / "dryrun"
    procs = start_dryrun(dry_out)
    print("  (b) the memory count")
    launches.update(memory_count(dev, card, counters))
    print("  (c) the blockwise plain attention")
    blockwise_vs_flash(dev, card, Timer(dev))
    print("  (a) the dry-run")
    finish_dryrun(procs, dry_out, card, t16)
    print(f"  phase 16 took {time.perf_counter() - t16} s")
    print(f"  total {time.perf_counter() - t_start} s")

    meta = {
        "gemm": ("src/repro_torch/csrc/gemm.cu",
                 "src/repro/kernels/gemm.py:34"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:82"),
        "flash_attention_bwd": (
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            "the gradient of src/repro/kernels/flash_attention.py:82"),
        "fused_mlp": ("src/repro_torch/csrc/fused_mlp.cu",
                      "src/repro/kernels/fused_mlp.py:75"),
        "rg_lru_scan": ("src/repro_torch/csrc/rg_lru.cu",
                        "src/repro/kernels/rg_lru.py:51"),
        "rg_lru_scan_bwd": ("src/repro_torch/csrc/rg_lru_bwd.cu",
                            "the gradient of src/repro/kernels/rg_lru.py:51"),
        "gemm_act": ("src/repro_torch/csrc/gemm_act.cu",
                     "src/repro/kernels/gemm_gelu.py:51"),
        "mlstm_scan": ("src/repro_torch/csrc/mlstm.cu",
                       "src/repro/kernels/mlstm.py:68"),
        "mlstm_scan_bwd": ("src/repro_torch/csrc/mlstm_bwd.cu",
                           "the gradient of src/repro/kernels/mlstm.py:68"),
    }
    # each kernel's headline is the last of the first five served paths
    # that runs it (the paths served since keep the headlines where they
    # were): "launches" is that path's main-path count and the headline
    # numbers its first case; "launches_by_path" gives every path's own
    # count, "cases" every shape
    head_path = {n: arch for arch, (names, _, _) in paths.items()
                 if arch in (LLAMA, MOE, RG, GRANITE, XLSTM) for n in names}
    head_path["flash_attention_bwd"] = TRAIN
    head_path["rg_lru_scan_bwd"] = RG_TRAIN
    head_path["mlstm_scan_bwd"] = XLSTM_TRAIN
    head = {name: next(c for c in cases if c["path"] == head_path[name])
            for name, cases in results.items()}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[head_path[name]][name],
         "headline_path": head_path[name],
         "launches_by_path": {arch: n[name] for arch, n in launches.items()
                              if name in n},
         **{k: head[name][k] for k in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "work_bound_ms", "states_bound_ms", "library_ms", "lse_ms",
             "anchors_ms", "states_ms", "shape", "tile_loop")
            if k in head[name]},
         "cases": results[name]}
        for name, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
