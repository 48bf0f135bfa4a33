#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch / H100 port runs.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. header: the card's name and power limit, torch / CUDA versions (and
   Triton's, where installed: the port runs no Triton kernel);
2. build: one ``nvcc`` per CUDA source, all started together, into build/
   (a library built earlier, by a test or an earlier run, is reused with
   the compiler log kept beside it); each kernel's registers and spills
   from ptxas; for flash_star's bf16 tensor-core kernel
   (``flash_star_mma_kernel``, 12 instantiations: head dims 8-256, D 256
   with Q's fragments from shared memory and 32-row KV tiles) 0 spill
   bytes and bf16 HMMA instructions in its SASS (``cuobjdump -sass``); for
   its float32 kernel (``flash_star_tf32_kernel``, 12: head dims 8-256, D
   256 at 32 q rows a CTA) 0 spill bytes and tf32 HMMA, for the int8 P.V
   kernel (``flash_star_pv_int8_kernel``, 24: float32 and bf16 q/k) 0 spill
   bytes, s8 IMMA and tf32 / bf16 HMMA, for its V pre-pass
   (``flash_star_quantize_v_kernel``, 2) 0 spill bytes, for the block route
   (``flash_star_blocked_kernel``, 12: float32 and bf16) 0 spill bytes and
   tf32 / bf16 HMMA; for the split-KV paged kernels (144
   ``paged_split_kernel``: head dims 8-256, the one-pass kernel and the
   block route's two modes, 4 ``paged_combine_kernel`` and 1
   ``paged_scan_kernel`` instantiations) 0 spill bytes; for the SSD scan's three kernels (5
   instantiations) 0 spill bytes, and tf32 HMMA in the SASS of the chunk
   state and chunk scan kernels; for the crossbar (8 tensor-core and 2
   scalar instantiations) 0 spill bytes, s8 IMMA in the clean and bf16 HMMA
   in the faulty tensor-core ones; for the STAR softmax (8) 0 spill bytes;
3. parity at main-path shapes: each kernel against its plain PyTorch
   version on the same inputs on the card, bfloat16 and float32, with the
   tolerances below; kernel, plain and library times (CUDA events, median
   of 20 launches, warm L2: the host's time to enqueue a call included).
   flash_star also at the chunked-prefill append shape (a 128-row chunk at
   q_offset 256 over a 512-row staging cache with 384 valid rows), SDPA
   timed there for the exact variant with a boolean mask; each of its
   variants names the kernel that ran it (bf16: mma.sync, float32: mma.sync
   tf32 as 3xTF32) with its device time from ``torch.profiler`` (SDPA's
   too, float32 beside float32), the achieved TFLOP/s and its share of the
   bound (float32: the tf32 products as issued, the FP32-FMA bound beside
   it); in bf16 it also counts the
   output elements that differ from the plain version at all.  Then the
   bf16 STAR kernel with its LUT in shared memory (the default format)
   against the same kernel reading a 13-bit format's LUT from global
   memory: the same outputs bit for bit, both device times.  The paged
   kernels (split-KV + combine) over bf16 / float32 pools and over int8 and
   fp8_e4m3 pools (codes and scales from ``kvquant.quantize_blocks``; the
   second entry, ``paged_attention_quant``), bf16 and float32 q, STAR and
   exact, at three shapes of S 4, Hq 32, Hkv 8, D 128, bs 16: the smoke
   shape (lens 0/1/17/600), the full-width decode tick's (lens
   514/386/258/130, W 34) and short contexts (lens 0/1/17/30, W 2: one
   split, no combine); each with its device time split into the split and
   the combine kernel, its bound (the live K/V bytes, or operations at the
   FP32 peak) and share of it; at the tick shape also slot 0 alone under
   its narrowest table bit-equal to slot 0 in the batch, and at the short
   shape each slot (one split: the split kernel writes the output itself)
   bit-equal to the same slot in a batch under the tick's table width (9
   splits, through the combine).  The STAR softmax, one cluster kernel
   for every mode (its cluster size and slice printed per shape, device
   time from ``torch.profiler``): clean ``gather`` (counted as
   ``star_softmax``) at the sampling shapes [4, 49152] and [8, 50688],
   ``onehot`` bit-equal to it; clean ``histogram`` and the mild fault in
   every mode (counted as ``star_softmax_lut``) at [4, 49152], float32 and
   bfloat16, and the histogram at [8, 50688]; the fault
   realization's bits on the card equal the CPU's.  flash_star's int8 P.V
   variant (``flash_star_pv_int8``) at the granite prefill shape and ragged
   (Tk 500, kv_valid 450), block_k 128, its device time split into the V
   pre-pass and the attention kernel, the bf16 time also as a multiple of
   the bf16 flash_star kernel's at the same shape; the SSD chunk scan (``ssd_scan``) at
   the Mamba2 serve's prefill shape (xdt [8, 2048, 24, 64], B/C [8, 2048,
   128] as slices of one conv output, bf16 and float32, chunk 128) and at a
   ragged T = 2000, with the device time of each of its three kernels and
   two bounds (its FLOP on FP32 FMAs, and as three tf32 tensor-core products
   each; the share is taken against the lower).  flash_star at the dense
   decode shapes (``Tq = 1``): q [4, 32, 1, 128] over the [4, 8, 544, 128]
   pool row with kv_valid 515/387/259/131 and ``causal=False`` (the dense
   tick), and at q_offset 512, ``causal=True``, kv_valid 513 (the lockstep
   step), bf16 and float32, STAR and exact, with the bound of the live K/V
   rows and SDPA at ``Tq = 1`` with a boolean mask (library time only).
   The STAR softmax at the MoE router's shapes (ROUTER_SHAPES: [512, 32],
   [4, 32] and [64, 4]), float32 and bfloat16: one CTA a row, the
   probabilities bit-equal to the plain version's (which adds a row in the
   kernel's order) and the CPU's, the top-k experts equal, device time and
   the bound of its bytes.  This slice's shapes, each against its plain
   version with device times, SDPA's beside the exact variants and the
   bound (``parity_flash_new``, ``parity_paged_new``): flash_star at
   qwen2-vl-7b's prefill (q [1, 28, 768, 128] causal over Hkv 4: 256 patch
   rows and 512 tokens, a GQA group of 7) and its dense decode (q [4, 28, 1,
   128] over [4, 4, 800, 128] pool rows, kv_valid VLM_DECODE_VALID), and at
   head_dim 8 (G 7 and G 4, 256 causal rows: float32, bf16 and the int8
   P.V variant); the paged kernel at qwen2-vl's tick (S 4, Hq 28, Hkv 4, D
   128, W 50, bf16 pages) and at D 8 (G 7 and G 4, the smoke shape's lens)
   over float32, bf16, int8 and fp8_e4m3 pages; the STAR softmax in gather
   mode at the sampling shapes, qwen2-vl's [4, 152064] among them, each
   bit-equal to its plain version; and the paged kernel at D 256 (S 4, Hq
   10, Hkv 1: recurrentgemma's G 10, bs 16, lens HYBRID_PAGED_LENS past 2048,
   through ``ops.paged_attention``) over the same four page types.  Then
   (``parity_flash_d256``) flash_star at head_dim 256, STAR and exact, at
   recurrentgemma-2b's prefill (q [1, 10, 3072, 256] causal over one KV
   head, window 2048: the window masks) and its ring decode (q [4, 10, 1,
   256] over a full [4, 1, 2048, 256] ring): the bf16 and float32 kernels,
   SDPA in the same type and with the same boolean mask beside each exact
   variant, and the int8 P.V variant (block_k 128, bf16 and float32 q/k);
   the int8 P.V variant over blocks of 256 rows at granite's q [1, 32, 512,
   128]; and the STAR softmax
   at the two new sampling shapes, [4, 256000] and [4, 256512] (306 padded
   columns at -1e30), bit-equal.  Then (``parity_flash_bert``) the float32
   flash_star kernel at bert-base-star's shape, q [8, 12, 512, 64] causal,
   one q head a KV head (phase 13's eval and prefill), STAR and exact, SDPA
   float32 beside the exact variant;
4. small-input reference: the granite-8b smoke config served greedy on the
   card (kernels) and on the CPU (plain versions) with the same weights
   must give the same tokens (the config computes in float32, so every
   prefill on the card runs flash_star's float32 kernel at D 16: its
   launches are counted and must be > 0): once over an fp32 pool, then over int8 and
   fp8_e4m3 pools with the prefix cache, 8-token prefill chunks, prompts
   sharing a prefix and a pool small enough to force a preemption, then
   under the mild fault (histogram mode, faulty attention on the
   materialized ``reference`` path).  Then the smoke config at temperature
   0.8 on the card in clean ``onehot`` and ``histogram`` mode: that mode's
   softmax kernel launches for every sampled batch, and the probabilities of
   the first request's first sample equal the CPU plain version's.  Then the
   mamba2-130m smoke config on the lockstep engine, greedy, card == CPU.
   Every continuous engine here decodes by CUDA graph replay (on the CPU the
   same tick runs eagerly): one capture per engine and route, one replay per
   tick, the paged kernel once per layer of every tick counted through the
   replays; the lockstep engine captures its decode step once per generate.
   Every engine above names the paged layout.  Then the dense layout and
   rings, card == CPU greedy tokens: the dense continuous engine (flash_star
   once per layer of every prefill and every tick, the paged kernel never),
   dense with 8-token chunks, the lockstep engine on granite (flash_star
   once per layer of the prefill and of each replay), and the
   ``sliding_window=16`` ring on the dense and the paged layout and on the
   lockstep engine.  Then the MoE family, card == CPU greedy tokens:
   granite-moe-1b-a400m's and mixtral-8x22b's smoke configs (mixtral's
   window of 16: every path a ring) on the dense, paged and chunked
   (``prefix_cache=True``, which a MoE arch declines) continuous paths and
   the lockstep engine, the router's softmax kernel once per layer of every
   prefill or chunk and of every tick.  Then the VLM family: qwen2-vl-7b's
   smoke config (M-RoPE, 16 stub patches of 32), every request with its own
   patch embeddings, on the dense, paged, int8 paged and chunked + prefix
   continuous paths (text-only requests with a common prefix beside the VLM
   ones: the text-only ones share, the card's trie counters equal the
   CPU's) and the lockstep engine; and the last three dense archs at their
   smoke configs, qwen2-72b (D 16), deepseek-coder-33b (D 8, G 7) and
   llama3-405b (D 8, G 4), on the dense, paged and lockstep paths, the two
   D-8 configs also over an int8 paged pool (rows of 8 one-byte codes):
   card == CPU tokens, flash_star once per layer of every prefill (and of
   every dense tick), the paged kernel once per layer of every paged tick;
   and the hybrid and enc-dec families on the lockstep engine (the only one
   either runs on): recurrentgemma-2b's smoke config (prompts of 20 past
   its window of 16: the ring wraps) and seamless-m4t-large-v2's (64 stub
   frames a row), card == CPU greedy tokens, flash_star once per attention
   block of the prefill and of each replay (seamless: 6 a prefill, 4 a
   step); and requests that stop at their EOS token: granite-8b's smoke
   config on the paged engine, greedy, an ``eos_id`` picked from a no-EOS
   run (a token a request samples for the first time after its first and
   before its last): card == CPU tokens, each the no-EOS output cut at its
   first ``eos_id``, one request at least stopped early;
5. serve: granite-8b at its published widths and all 36 layers, random
   weights drawn on the card from a seed and cast to bf16 once
   (``compute_params``, shared by every engine after it), the
   continuous-batching engine over the paged KV cache (block size 16), 8
   requests on 4 slots, prompts of 128-512 tokens, 16-32 new tokens each,
   temperature 0.8, with the attention (flash_star), paged decode and STAR
   sampling softmax kernels; every tick is one CUDA graph replay (decode over
   the pool and the sampling softmax), one capture in all.  Launch counters
   are zeroed just before and read just after; each kernel must have
   launched, the paged kernel once per layer of every tick, the softmax once
   per admission and per tick (counted through the replays; the capture's
   warm-up launches are printed apart).  The serve is traced
   (``repro_torch.obs``): its Chrome trace goes to build/serve_fp_trace.json
   and the share of wall time in the prefill and decode spans, and of a
   steady tick in its decode span, is printed, with the bytes the engine
   moved up and down.  Then one full-width prefill through the kernels is
   held against the same prefill through the plain ``reference`` impls,
   and the longest prompt's prefill is traced with ``torch.profiler``
   (device time by kernel group).  One steady decode tick by replay is
   traced (wall, device busy, idle share, groups; no copy/cast kernel as
   long as the cast of the smallest weight, WEIGHT_CAST_BOUND_US), its bytes
   up (the [4, 1] int32 inputs, no table row) and down (the sampled tokens)
   checked, the replay held against the eager tick from a copy of the same
   state (greedy tokens equal, the logits' max_abs difference printed) and
   timed with CUDA events.  Then the int8 P.V
   path: one full-width prefill whose attention spec sets ``pv_int8``
   (counters zeroed just before: the variant launches once per layer),
   held against the float P.V prefill, and traced (the V pre-pass and the
   attention kernel in one group);
5b. dense serve: the same weights and traffic on the dense per-slot pool
   (544 rows a slot).  Counters zeroed just before and read just after:
   flash_star once per layer of every prefill and of every tick (counted
   through the replays), the STAR softmax once per admission and per tick,
   the paged kernel never; tok/s with and without the capture, TTFT p50,
   peak memory.  One steady dense tick traced as in phase 5 (its replay
   bit-equal to the eager tick, 16 bytes up and 16 down).  Then a lockstep
   ``generate`` of 4 x 512-token prompts and 32 tokens at temperature 0.8:
   flash_star once per layer of the prefill and of each of its 31 replays,
   the softmax once per step; tok/s with and without the capture, peak
   memory;
5c. eos serve: phase 5's and 5b's serves again (the same weights, plan,
   temperature and seed), each request stopping at ``eos_id``, the token at
   index 4 of request 0's no-EOS output.  On both pools every output must
   equal its no-EOS output (from phases 5 and 5b) cut after the first
   ``eos_id``, bit for bit, though stopped requests free their slots
   earlier and the later requests meet other co-tenants at other ticks;
   the graphs captured are the no-EOS run's.  Counters zeroed just before
   and read just after: flash_star once per layer of every prefill (and of
   every dense tick), the paged kernel once per layer of every paged tick,
   the STAR softmax once per admission and per tick; the ticks with and
   without EOS are printed;
6. quantized serve: the same weights over an int8 page pool with the
   prefix cache and 128-token prefill chunks, 8 requests of a common
   256-token system prefix plus their own 64-256-token suffix, 16-32 new
   tokens, temperature 0.8, on a pool sized to force preemption.  Counters
   zeroed just before and read just after: the quantized paged kernel must
   launch for every layer of every tick and flash_star for every layer of
   every chunk; prefix hits and preemptions must both occur.  Then one
   full-width decode step over the int8 pool through the kernel is held
   against the same step through the ``reference`` paged impl, and one
   int8 decode tick (the same per-tick checks as phase 5) and one 128-token
   prefill chunk are traced.  Its ticks run by replay too (one capture);
   the table rows flushed (dirty rows from admissions, block growth,
   finishes and preemptions) and the bytes moved are printed;
7. degraded-RRAM serve: the same weights with a seeded ``FaultModel`` in
   the config's softmax spec (attention ``xla``, so faulty rows take the
   materialized ``reference`` path; sampling softmax ``pallas``), 4 requests
   on 4 slots, prompts of 128-256 tokens, 16 new tokens, temperature 0.8,
   under the accuracy guard: decode by replay (one capture), the guarded
   sampling eagerly after it.  7a: the mild fault in ``histogram`` mode with
   a non-latching guard: the LUT kernel launches for every sampled batch and
   the guard checks every one.  7b: a severe fault in ``gather`` mode with
   a latching guard: it trips, falls back and latches; the kernel
   ran before the trip and not after (its budget: twice the clean engine's
   error on the same traffic, logged).  Then ``ops.matmul(impl="hwmodel")``
   at granite-8b's q and MLP-up projection widths (layer 0's weights) under
   a guard, clean and under the mild fault (the crossbar kernel must
   launch), and the crossbar kernel against its plain version at those
   shapes (clean bit-exact; faulty equal but for ADC codes within 1e-3 LSB
   of a half-step, at most 1e-4 of the outputs), with its device time and
   that of the same instantiation without the ADC epilogue (the epilogue's
   share), its CTA tile and grid;
8. Mamba2 serve: mamba2-130m at its published widths and all 24 layers,
   random weights drawn on the card from a seed, on the lockstep engine:
   8 prompts of 2048 tokens, 32 new tokens, temperature 0.8, sampling
   softmax ``pallas``.  Counters zeroed just before and read just after:
   ``ssd_scan`` once per layer of the prefill, the STAR softmax once per
   sampled step (counted through the replays: ``generate`` captures its
   decode step once and replays it 31 times).  Tok/s with and without the
   graph's warm-up and capture, time to first token (the engine's ``begin``:
   a prefill and its sample, timed alone), the engine's own decode step by
   replay (``decode``: its wall time, one step traced for device busy, a
   step by CUDA events) and peak memory.  One
   full-width prefill through the kernel is held against the same prefill
   under ``ops.use(ssd_scan="reference")``, in bf16 and in float32 compute;
   32 greedy tokens from each route's prefill are compared, and where a row
   parts, the reference's top-2 margin at that step must stay within
   SSD_DIVERGENCE_FACTOR x the bf16 prefill logits' max_abs difference; one
   prefill is traced;
9. MoE serve: granite-moe-1b-a400m at its published widths and all 24
   layers (32 experts, top-8), random weights drawn on the card from a seed
   and cast to bf16 once, after granite-8b's weights are freed.  The phase
   5 traffic on the dense pool, then on the paged pool in 128-token chunks
   with ``prefix_cache=True``.  Counters zeroed just before and read just
   after: the STAR softmax once per layer of every prefill or chunk and of
   every tick (the router) plus once per admission and per tick (sampling),
   counted through the replays; flash_star and the paged kernel as in
   phases 5 and 5b.  Tok/s with and without the capture, TTFT p50, peak
   memory.  One 512-token prefill: each layer's router probabilities from
   the kernel bit-equal to the plain version's on the same logits, the
   top-8 experts equal.  4 x 512-token greedy lockstep generations of 32
   tokens with ``softmax`` ``pallas`` and ``reference``: the same tokens.
   One steady dense and one steady paged tick traced as in phase 5 (replay
   bit-equal to the eager tick, device time by group);
10. VLM serve: qwen2-vl-7b at its published widths and all 28 layers
   (d_model 3584, 28 q / 4 kv heads: D 128, G 7; vocab 152064; M-RoPE
   sections (16, 24, 24)), 7.62 B random float32 weights drawn on the card
   from a seed and cast to bf16 once, after granite-moe's weights are
   freed.  Phase 5's 8 requests on the dense pool (800 rows a slot), each
   with its own [1, 256, 1280] patch embeddings; then on the paged pool in
   128-token chunks with ``prefix_cache=True``, four VLM requests
   interleaved with four text-only ones of a common 256-token prefix (the
   text-only ones share: prefix hits are required).  Counters zeroed just
   before and read just after: flash_star once per layer of every prefill
   or chunk and of every dense tick, the paged kernel once per layer of
   every paged tick, the STAR softmax once per admission and per tick.
   Tok/s with and without the capture, TTFT p50, peak memory.  One steady
   dense and one steady paged tick with VLM requests traced as in phase 5
   (replay bit-equal to the eager tick); a 4 x (256 patches + 512 tokens)
   greedy lockstep generate of 32 tokens (flash_star once per layer of the
   prefill and of each replay); one prefill (256 patches + 128 tokens)
   through the kernels against ``ops.use(attention="reference")`` within
   rel_l2 < 3e-2, its cache's ``len`` / ``pos`` = 384 / 144;
11. hybrid serve: recurrentgemma-2b at its published widths and all 26
   layers (8 periods of two RG-LRU blocks and a local-attention block, a
   2-layer RG-LRU tail; D 256, 10 q heads over 1 KV head; window 2048;
   vocab 256000), ~3.5 B random weights cast to bf16 once (the RG-LRU
   gates' weights stay float32), after qwen2-vl's are freed, on the
   lockstep engine: 4 x 512-token prompts, 32 new tokens, sampled at T 0.8,
   then greedy; then 4 x 3072-token prompts, greedy, 32 tokens (the window
   masks the prefill, the 2048-row rings wrap).  Counters zeroed just
   before and read just after each: flash_star 8 times a prefill and 8 a
   step, the STAR softmax once a sampled step (counted through the 31
   replays).  Tok/s with and without the capture, peak memory, the time to
   first token, a steady step's wall, device busy and CUDA-event time; the
   replayed step against the eager step from a copy of its state (output
   and every cache leaf bit-equal); one 3072-token prefill against
   ``ops.use(attention="reference")`` within rel_l2 < 3e-2.  11b: the same
   model computing in float32 (the weights as drawn), attention through
   flash_star's float32 kernel at D 256: the 4 x 512 and 4 x 3072 greedy
   generates (flash_star 8 a prefill and 8 a step), the 4 x 512 greedy
   tokens against the float32 reference attention's (a row that parts must
   part at a near-tie, as 13d), one 3072-token prefill against
   ``ops.use(attention="reference")`` within rel_l2 < 3e-2 beside the two
   plain routes' distance; then the weights cast to bf16 once and a
   3072-token prefill through the int8 P.V variant (8
   ``flash_star_pv_int8`` launches) within rel_l2 < 3e-2 of its plain
   version's and as far from the float P.V kernel's as the plain version
   (the variant's own distance, in float32 compute, within 3e-2);
12. enc-dec serve: seamless-m4t-large-v2 at its published widths (24 + 24
   layers, d_model 1024, 16 heads: D 64, vocab 256206 padded to 256512),
   random weights cast to bf16 once, on the lockstep engine: 4 x 256-token
   prompts with [4, 64, 1024] stub frames, 32 new tokens, sampled at T 0.8
   and greedy: flash_star 72 times a prefill (24 encoder, 24 self, 24
   cross) and 48 a step, the STAR softmax once a sampled step; the same
   measurements and checks as phase 11 (a 4 x 256 prefill against the
   reference attention);
13. train: bert-base-star at its published widths (12 layers, d_model 768,
   12 heads: D 64, vocab 30522 padded to 30720, ~132 M float32 parameters,
   the STAR softmax in histogram mode at ``"auto:cnews"``), from the port's
   own seeded init.  13a: ``run_train`` on the card, 20 steps of 8 x 512
   synthetic tokens with the ``TrainConfig`` the train launcher builds
   (lr 3e-4, warmup 2, cosine), float32 with TF32 off, checkpoints every 10
   steps in build/: every loss finite, the mean of the last 5 below the
   mean of the first 5; the step time (median, host clock: the loop reads
   each step's metrics back), peak memory, one more step traced (device busy
   share, time by group).  13b: an injected failure at step 8 of a 12-step
   run checkpointing every 5 steps, resumed from step 5, against an
   uninterrupted run: the final loss within RESUME_LOSS_RTOL, every
   parameter within RESUME_PARAM_FRAC x the peak lr (bit-equality printed).
   13c: ``make_eval_step`` on an unseen batch of the trained state through
   flash_star's float32 kernel (``ops.use(attention="pallas")``: 12
   launches at q [8, 12, 512, 64], G 1) and through the plain ``xla``
   route, the losses within EVAL_LOSS_RTOL, the logits' distance printed
   (the kernel at that shape is held to its plain version in phase 3).
   13d: the step-20 checkpoint restored and served on the
   lockstep engine with the kernels: 4 x 256-token prompts, 32 new tokens,
   sampled at T 0.8 and greedy, counters zeroed just before and read just
   after (flash_star 12 a prefill and 12 a step, the STAR softmax in
   histogram mode once a sampled step, through the replays); the greedy
   tokens against ``ops.use(attention="reference")``, a parting row's step
   and the reference's top-2 margin printed (a margin over
   GREEDY_MARGIN_FACTOR x the routes' logit difference fails); the STAR
   softmax at [4, 30720] (198 padded columns at -1e30, the engine's
   sampling row) and [4, 30522], histogram mode, bit-equal to its plain
   version;
14. the mesh on one card: a one-rank NCCL process group on a ``HashStore``
   and a ``(1, 1)`` ``("data", "model")`` mesh.  14a: bert-base-star at full
   width trained MESH_STEPS steps of TRAIN_BATCH x TRAIN_SEQ under the mesh
   (every state leaf a DTensor) against the same steps without it, each
   step's loss within MESH_LOSS_RTOL (bit-equality printed), the step time
   and peak memory of both; 14b: its eval under the mesh through
   flash_star's float32 kernel on each rank's shard (12 launches), within
   EVAL_LOSS_RTOL of the eval of the unsharded run's state; 14c: the
   sharded state checkpointed and restored without the mesh, bit for bit;
   14d: granite-moe-1b-a400m at full width with ``moe_style="ep"`` (experts
   over "model"), a MESH_MOE_TOKENS forward under the mesh with the STAR
   router on the kernel (24 launches) and flash_star (24), logits against
   the same forward without the mesh (the bf16 tolerance below, bit-equality
   printed); 14e: ``compressed_grad_allreduce`` on one rank, ``mean +
   new_err == g`` within MESH_REC_ATOL; 14f: ``pipeline_apply`` with one
   stage bit-equal to the sequential loop; 14g: every family's smoke config
   (MESH_FAMILY_ARCHS) trained MESH_FAMILY_STEPS steps under the mesh, its
   losses within MESH_LOSS_RTOL of those without it.  The group is torn
   down at the end.  Sharded runs across cards wait for a four-card machine (a line
   says so); the CPU tests hold 4 gloo ranks at ``(2, 2)`` against the
   reference;
15. the dry-run tools and the mesh paths they reach.  The three dry-run
   cells of 15c start first, as subprocesses, and run beside 15a, 15b and
   15d.  15a: ``python3 tools/mesh_seq_parallel.py`` (a forward with
   ``seq_parallel_activations`` under a one-rank mesh, every attention
   route) exits 0: the projections of a tensor with two sharded leading
   dims run on the shards on the card's torch; 15b: granite-8b's smoke
   config with ``impl="pallas"`` decodes KVSEQ_STEPS tokens on a one-rank
   NCCL ``(1, 1)`` mesh, its cache a DTensor placed by "kv_seq" (rows over
   a size-1 dim: whole, so the kernel route serves it), counters zeroed just
   before and read just after: flash_star once per layer of every step; the
   logits against the same decode without the mesh (the float32 tolerance
   below, bit-equality printed); 15c: ``python -m repro_torch.launch.dryrun``
   on three cells on the card's torch, each with a DRYRUN_CELL_TIMEOUT time
   limit, each record's summary line printed: ``mamba2_130m decode_32k``
   (the reference's own regression cell), ``granite_8b decode_32k`` (the
   row-sharded cache: its record counts no all-gather of a cache leaf) and
   ``qwen2_vl_7b train_4k`` (sequence parallelism on the fake 256-rank
   mesh); 15d: the accounting held to the card: bert-base-star's
   TRAIN_BATCH x TRAIN_SEQ train step traced on fake tensors on a one-rank
   fake mesh against the real step on the card, its FLOPs equal to
   ``FlopCounterMode``'s on the real step and its peak live bytes beside
   ``torch.cuda.max_memory_allocated`` of that step (a gap over
   ACCOUNT_PEAK_GAP is printed as a finding, not a failure);
16. examples: ``examples/torch_quickstart.py`` on the card in its own
   process, its last line "OK";
17. formats: the paper's swept softmax formats, 9 bits down to 2
   (SWEPT_FORMATS).  At 2 to 5 bits the STAR online softmax depends on its
   block schedule (the LUT clamps at its last level), so there flash_star
   and the paged kernel run their block routes (``flash_star_blocked``,
   ``paged_attention_blocked``), which follow the TPU kernels' schedule.
   Each against its plain version at the 8 formats, with the tolerances
   and ambiguous-row rule below: flash_star bf16 and float32 at granite's
   prefill (q [1, 32, 512, 128] causal, block_k 128) and the dense ``Tq =
   1`` decode, the int8 P.V variant (bf16) at both; the paged kernel
   at the full-width tick over float32 and bf16 pages and int8 / fp8_e4m3
   codes; the STAR softmax at [4, 49152] in every mode.  Device times of
   the block routes at u2 and u3 beside the one-pass kernels' at u8 (the
   same shapes).  Then the granite-8b smoke config at 3 bits (2i.1f) on
   the paged continuous engine, card == CPU greedy tokens, counters zeroed
   just before and read just after: the block routes once per layer of
   every prefill and tick, the one-pass kernels never (these counts are
   the two new entries' ``launches``).  Then
   ``examples/torch_precision_sweep.py`` on the card in its own process:
   the reference's table, exact >= 90 %, 7 to 9 bits within 2 points of
   exact, 2 bits more than 2 points under, and its printed launches;
18. the summary line (``serve_eos`` among its keys) and the
   ``{"kernels": [...]}`` line (``launches`` from the phase 5 serve,
   each path's own count under ``launches_by_path``: every serve phase
   (11b's float32 and pv_int8 paths among them), phase 13's eval and serves, phase 14's and 15b's mesh paths and the
   phase 4 smoke paths; the block routes' from phase 17) and, last, the
   device line.  Each phase's wall
   seconds are printed as it ends (``phase <name>: <s>``) and gathered
   under ``phase_seconds``.

Tolerances.  float32 outputs: |kernel - plain| <= 5e-5 + 1e-4 |plain|;
bfloat16 outputs: <= 1e-2 + 8e-3 |plain| (two bf16 ulps: both round one
float32 value after summing in different orders).  Under STAR a score
within float32 summation error of a grid half-step may snap to the
neighbouring level in one of the two; a row outside tolerance passes only
if it holds such an ambiguous score (within 1e-3 grid units of a half-step,
from a float64 recomputation), and such rows must stay below 1e-4 of the
live scores.  flash_star's bf16 output also differs from the plain
version's in at most BF16_DIFF_BOUND of its elements: P.V on three bf16
pieces of P only reorders float32 sums, which moves a bf16 rounding in
about 0.02 % of them, where a kernel that rounds P to bf16 once moves
about a third.  The int8 P.V variant holds to the same tolerances, a row
outside them passing only if it holds an ambiguous code: a score near a grid
half-step (STAR) or a p near a half-step of 1/127 (exact), counted and
bounded the same way.  ssd_scan: y and the final state within SSD_RTOL of
their largest magnitude (float32 sums in another order).  The star softmax
kernels snap their input themselves, so
their indices are identical and they hold to 1e-5 |plain| + 1e-9 (the LUT
kernel's faulty histogram divides by the ADC gain after the row, the plain
version before: an ulp).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_INT8_OPS = 1979e12
FLIP_DELTA = 1e-3  # grid units (and ADC LSBs)
FLIP_BOUND = 1e-4  # flipped rows per live score (and ADC flips per output)
BF16_DIFF_BOUND = 1e-2  # flash_star bf16: output elements unequal to the plain version's
FLASH_DESIGNS = {"bfloat16": "mma.sync bf16, P in three bf16 pieces",
                 "float32": "mma.sync tf32, every product as 3xTF32"}
PV_INT8_DESIGN = "V codes once per block (pre-pass), QK^T bf16 / 3xTF32 mma.sync, P.V s8 mma.sync"
PV_INT8_KERNELS = ("flash_star_quantize_v_kernel", "flash_star_pv_int8_kernel")
PV_INT8_BF16_BAR = 2.0  # pv_int8 bf16 device time per the bf16 flash_star kernel's, same shape
# 11b: the pv_int8 kernel's and its plain version's distances from the float
# P.V agree within this fraction of the plain version's
PV_INT8_SAME_DISTANCE = 0.1
SSD_RTOL = 1e-5  # ssd_scan: max |kernel - plain| per max |plain| (float32 sums reordered)
SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
SSD_DESIGN = ("chunk state + state pass + chunk scan; mma.sync tf32, float32 operands as 3xTF32, "
              "bf16 B/C exact")
SSD_DIVERGENCE_FACTOR = 10  # a greedy divergence fails above this x the prefill logits' max_abs diff
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
SEVERE = dict(stuck_on_rate=0.6, stuck_off_rate=0.2, seed=3)
# sampling (rows, columns, padded columns at -1e30 as ``unembed`` masks
# them): granite-8b's 4 slots, Mamba2's 8 rows, qwen2-vl-7b's 4 slots,
# recurrentgemma-2b's 4 rows and seamless-m4t-large-v2's (256206 padded to
# 256512)
SOFTMAX_SHAPES = ((4, 49152, 0), (8, 50688, 0), (4, 152064, 0), (4, 256000, 0),
                  (4, 256512, 256512 - 256206))
# the MoE router's rows, experts and top-k: granite-moe-1b-a400m's 512-token
# prefill and 4-slot tick, and mixtral's smoke config over a 64-token prefill
ROUTER_SHAPES = ((512, 32, 8), (4, 32, 8), (64, 4, 2))
MOE_ARCH = "granite_moe_1b_a400m"
SOFTMAX_DESIGN = ("one thread-block cluster a row (up to 8 CTAs, 16-byte slices in registers), "
                  "row max and denominator through distributed shared memory")
CROSSBAR_DESIGN = ("128 x 32/64 CTA tiles, cp.async stage; clean s8 mma.sync into int32; faulty "
                   "float32 weights as three bf16 pieces on bf16 mma.sync")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS = {}  # phase -> wall seconds, printed as each phase ends
CARD = None  # nvidia-smi's name and power limit, set by main
# phase 5's and 5b's outputs, ticks and captured graphs without EOS, by
# pool: phase 5c's oracle
NO_EOS = {}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f}s")


# ---------------------------------------------------------------------------
# measurement helpers


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20):
    """Device time of one call of ``fn``: the self time of every kernel it
    launches, from ``torch.profiler``, averaged over ``reps`` calls.  Unlike
    ``time_ms`` it leaves out the host's time to enqueue the call.  None
    where the profiler records no device time."""
    by_kernel = device_ms_by_kernel(fn, reps)
    return sum(by_kernel.values()) if by_kernel else None


def device_ms_by_kernel(fn, reps: int = 20, per_call=None):
    """``device_ms`` by kernel name: {name: ms per call}, empty where the
    profiler records no device time.

    The profiler now and then loses the records of the first or the last
    calls of a window (their kernels ran: the CUDA-event time of the same
    calls is whole), which would understate the time.  So every kernel must
    show a record count that is a multiple of ``reps``, and where
    ``per_call`` ({name part: launches per call}) is given, exactly
    ``reps`` x that; a window that records nothing or falls short is
    profiled again.  Records are lost, never added: a part with more
    records than ``reps`` x its launches per call fails at once; still
    short after PROFILE_TRIES windows, the device time is not measured
    ({}, logged; callers then report None and use the CUDA-event time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for ev in prof.key_averages():
            us = _self_device_us(ev) if ev.device_type == torch.autograd.DeviceType.CUDA else 0
            if us > 0:
                out[ev.key] = out.get(ev.key, 0.0) + us / reps / 1e3
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
        short = {k: c for k, c in counts.items() if c % reps}
        for part, n in (per_call or {}).items():
            got = sum(c for k, c in counts.items() if part in k)
            check(got <= n * reps, f"profiler: {got} {part} records of {reps} calls, over "
                                   f"the {n} launches a call makes")
            if got != n * reps:
                short[part] = got
        if out and not short:
            return out
        PROFILES_RETAKEN.append(short or "no records")
        log(f"profiler: records short of {reps} calls ({short or 'none at all'}); "
            f"profiling again")
    log(f"profiler: kernel records still short of {reps} calls after {PROFILE_TRIES} "
        f"windows ({short or 'none at all'}); device time not measured")
    return {}


def device_ms_per_launch(fn, part: str, reps: int = 20) -> float:
    """Device time of one launch of the kernels whose name holds ``part``:
    their self time from ``torch.profiler`` over ``reps`` calls of ``fn``,
    divided by the launch records the profiler kept.  Where it kept fewer
    than ``reps`` (it loses records now and then, the kernel ran: see
    ``device_ms_by_kernel``) the shortfall is logged and the average over
    the records it has stands if they are at least half; otherwise the
    window is profiled again, and still short after PROFILE_TRIES windows,
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and part in ev.key:
                total += _self_device_us(ev)
                count += ev.count
        if count != reps:
            PROFILES_RETAKEN.append({part: f"{count} of {reps} records"})
            log(f"profiler: {count} {part} records of {reps} calls")
        if 2 * count >= reps:
            return total / count / 1e3
    check(False, f"profiler: under {reps // 2} {part} records of {reps} calls in each of "
                 f"{PROFILE_TRIES} windows")


def device_ms_each_once(fn, reps: int = 20):
    """Device time of one call of ``fn`` whose kernels each launch once a
    call: the sum over its kernels of their self time from
    ``torch.profiler``, from a window that kept every record.  Late in a
    long run the profiler loses records, and in a window that lost some the
    durations it kept can be short too (half of their neighbours' here), so
    a short window is profiled again; after 2 x PROFILE_TRIES short windows
    (each is 20 short calls) the time is None (not measured), logged with
    what each window kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(2 * PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for ev in prof.key_averages():
            us = _self_device_us(ev) if ev.device_type == torch.autograd.DeviceType.CUDA else 0
            if us > 0:
                total[ev.key] = total.get(ev.key, 0.0) + us
                count[ev.key] = count.get(ev.key, 0) + ev.count
        if count and all(c == reps for c in count.values()):
            return sum(total.values()) / reps / 1e3
        kept.append(min(count.values()) if count else 0)
    PROFILES_RETAKEN.append({"device_ms_each_once": kept})
    log(f"profiler: no window of {reps} calls kept every record (fewest kept per window: "
        f"{kept}); device time not measured")
    return None


PROFILE_TRIES = 4  # profiler windows taken before a short count is not measured
PROFILES_RETAKEN = []  # the profiler windows taken again, with what fell short


def _self_device_us(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def tolerance(dtype):
    import torch

    if dtype == torch.bfloat16:
        return 1e-2, 8e-3
    return 5e-5, 1e-4


def near_half_step(x):
    """Entries of a float64 tensor within FLIP_DELTA of a rounding half-step."""
    return (x - x.floor() - 0.5).abs() < FLIP_DELTA


def compare_rows(name, got, ref, dtype, scores64=None, live=None, scale=None, amb=None):
    """Hold ``got`` to ``ref`` row by row (last axis = features).  A row out
    of tolerance must hold an ambiguous live entry: ``amb`` when given, else a
    score near a grid half-step.  Returns (max abs error outside flipped
    rows, flipped rows)."""
    atol, rtol = tolerance(dtype)
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bad_rows = (err > atol + rtol * r.abs()).any(dim=-1)
    n_bad = int(bad_rows.sum())
    if n_bad:
        check(amb is not None or scores64 is not None,
              f"{name}: {n_bad} rows out of tolerance (max err "
              f"{float(err.max()):.3e}) with no grid to explain them")
        if amb is None:
            amb = near_half_step(scores64 * scale) & live
        else:
            amb = amb & live
        unexplained = bad_rows & ~amb.any(dim=-1)
        check(not bool(unexplained.any()),
              f"{name}: {int(unexplained.sum())} rows out of tolerance hold no score "
              f"near a grid half-step (max err {float(err.max()):.3e})")
        n_live = int(live.sum())
        check(n_bad <= FLIP_BOUND * n_live,
              f"{name}: {n_bad} flipped rows exceed {FLIP_BOUND} of {n_live} live scores")
    max_err = float(err[~bad_rows].max()) if bool((~bad_rows).any()) else 0.0
    return max_err, n_bad


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the bf16 flash_star kernel


def ptxas_by_function(text):
    """``nvcc -Xptxas -v`` output as {kernel: [registers line, spill line]}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [])
        elif cur and ("spill" in line or "Used" in line):
            out[cur].append(line.replace("ptxas info    :", "").strip())
    return out


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(found):
        return found
    import triton

    found = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    check(found.exists(), "cuobjdump not found (CUDA toolkit or Triton's copy)")
    return str(found)


def sass_hmma(library):
    """{kernel: [tensor-core instruction kind per instruction]} from the SASS
    of a built library: HMMA (float inputs, e.g. ``.16816.F32.BF16``) and
    IMMA (integer inputs, e.g. ``IMMA.16832.S8.S8``)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    hmma, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
        elif cur and "HMMA" in line:
            hmma.setdefault(cur, []).append(line.split("HMMA")[1].split()[0])
        elif cur and "IMMA" in line:
            hmma.setdefault(cur, []).append("IMMA" + line.split("IMMA")[1].split()[0])
    return hmma


def check_mma_build(ptxas_log, library):
    """The bf16 flash_star kernel runs on the tensor cores and spills
    nothing: each instantiation's ptxas line (0 spill bytes) and its count
    of HMMA instructions in the SASS of the built library."""
    mma = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
           if "flash_star_mma_kernel" in f}
    check(len(mma) == 12, f"expected 12 flash_star_mma_kernel instantiations (D 8-256), "
                          f"ptxas shows {len(mma)}")
    hmma = sass_hmma(library)
    for func, lines in sorted(mma.items()):
        m = re.search(r"ILi(\d+)ELb([01])E", func)
        tag = f"D={m.group(1)} {'star' if m.group(2) == '1' else 'exact'}" if m else func
        ops = hmma.get(func, [])
        kinds = sorted(set(ops))
        log(f"flash_star_mma_kernel {tag}: ptxas {'; '.join(lines)}; SASS HMMA x {len(ops)} {kinds}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"flash_star_mma_kernel {tag} spills: {lines}")
        check(any(".BF16" in k for k in kinds), f"flash_star_mma_kernel {tag}: no bf16 HMMA in its SASS")


def check_tc_build(ptxas_log, library):
    """flash_star's float32 and int8 P.V kernels run on the tensor cores and
    spill nothing: ``flash_star_tf32_kernel`` (6 head dims, 8 to 256, x
    STAR / exact) with tf32 HMMA in its SASS, ``flash_star_pv_int8_kernel``
    (float32 and bf16 q/k: 24) with s8 IMMA (its P.V) and tf32 / bf16 HMMA
    (its QK^T), the two ``flash_star_quantize_v_kernel`` instantiations
    (its V pre-pass, float32 and bf16 V), and ``flash_star_blocked_kernel``
    (the block route at 2 to 5 bits, float32 and bf16 q/k/v: 12) with tf32
    / bf16 HMMA; each one's ptxas line is printed."""
    names = ("flash_star_tf32_kernel", "flash_star_blocked_kernel", *PV_INT8_KERNELS)
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if any(k in f for k in names)}
    n = {k: sum(k in f for f in funcs) for k in names}
    check(n == {"flash_star_tf32_kernel": 12, "flash_star_blocked_kernel": 12,
                "flash_star_quantize_v_kernel": 2, "flash_star_pv_int8_kernel": 24},
          f"expected 12 tf32, 12 blocked, 2 quantize_v and 24 pv_int8 instantiations, "
          f"ptxas shows {n}")
    mma = sass_hmma(library)
    for func, lines in sorted(funcs.items()):
        name = next(k for k in names if k in func)
        m = re.search(r"Li(\d+)ELb([01])E", func) or re.search(r"Li(\d+)E+v", func)
        tag = name + (" bf16" if "nv_bfloat16" in func else " f32") + (
            "" if not m else f" D={m.group(1)}" if m.lastindex == 1 else
            f" D={m.group(1)} {'star' if m.group(2) == '1' else 'exact'}")
        ops = mma.get(func, [])
        kinds = sorted(set(ops))
        log(f"{tag}: ptxas {'; '.join(lines)}; SASS HMMA/IMMA x {len(ops)} {kinds}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"{tag} spills: {lines}")
        if name == "flash_star_quantize_v_kernel":
            continue
        qk = ".BF16" if "nv_bfloat16" in func else "TF32"
        check(any(qk in k for k in kinds), f"{tag}: no {qk} HMMA in its SASS")
        if name == "flash_star_pv_int8_kernel":
            check(any(k.startswith("IMMA") and "S8" in k for k in kinds),
                  f"{tag}: no s8 IMMA (its P.V) in its SASS")


def check_ssd_build(ptxas_log, library):
    """The SSD scan's three kernels spill nothing (2 + 1 + 2 instantiations:
    float32 and bf16 B/C for the two chunk kernels), and the two chunk
    kernels' products run on the tensor cores: tf32 HMMA in their SASS."""
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if any(k in f for k in SSD_KERNELS)}
    check(len(funcs) == 5, f"expected 5 ssd_scan kernel instantiations, ptxas shows {len(funcs)}")
    hmma = sass_hmma(library)
    for func, lines in sorted(funcs.items()):
        name = next(k for k in SSD_KERNELS if k in func)
        tag = name + (" bf16" if "nv_bfloat16" in func else " f32" if "IfE" in func else "")
        ops = hmma.get(func, [])
        kinds = sorted(set(ops))
        log(f"{tag}: ptxas {'; '.join(lines)}; SASS HMMA x {len(ops)} {kinds}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"{tag} spills: {lines}")
        if name != "ssd_state_pass_kernel":
            check(any("TF32" in k for k in kinds), f"{tag}: no tf32 HMMA in its SASS")


def check_paged_build(ptxas_log):
    """Every instantiation of the paged split kernel (2 q types x 3 pool
    types for the fp entry and the two code types, 6 head dims, 8 to 256,
    STAR and exact: 72; and the block route's scores and weights modes, STAR
    only: 72 more), of its combine (4) and of the block route's page scan
    (1) spills nothing."""
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if any(k in f for k in ("paged_split_kernel", "paged_combine_kernel",
                                     "paged_scan_kernel"))}
    n_split = sum("paged_split_kernel" in f for f in funcs)
    check(n_split == 144 and len(funcs) == 149,
          f"expected 144 paged_split_kernel, 4 paged_combine_kernel and 1 paged_scan_kernel "
          f"instantiations, ptxas shows {n_split} and {len(funcs) - n_split}")
    for func, lines in sorted(funcs.items()):
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"paged kernel {func} spills: {lines}")
    log(f"paged kernels: {len(funcs)} instantiations, 0 spill bytes in each")


def check_crossbar_build(ptxas_log, library):
    """The crossbar's tensor-core instantiations (clean / faulty x BN 32 / 64
    x with / without the ADC epilogue: 8) and its two scalar int32-code ones
    spill nothing; the clean ones hold s8 IMMA in their SASS, the faulty ones
    bf16 HMMA."""
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if "crossbar_tc_kernel" in f or "crossbar_scalar_kernel" in f}
    n_tc = sum("crossbar_tc_kernel" in f for f in funcs)
    check(n_tc == 8 and len(funcs) == 10,
          f"expected 8 crossbar_tc_kernel and 2 crossbar_scalar_kernel instantiations, "
          f"ptxas shows {n_tc} and {len(funcs) - n_tc}")
    mma = sass_hmma(library)
    for func, lines in sorted(funcs.items()):
        m = re.search(r"crossbar_tc_kernelILb([01])ELi(\d+)ELb([01])E", func)
        tag = (f"crossbar_tc_kernel {'faulty' if m.group(1) == '1' else 'clean'} BN={m.group(2)}"
               f"{'' if m.group(3) == '1' else ' (no ADC: timing probe)'}" if m
               else "crossbar_scalar_kernel " + ("int32 x float32" if "IifE" in func else
                                                 "int32 x int32"))
        ops = mma.get(func, [])
        kinds = sorted(set(ops))
        log(f"{tag}: ptxas {'; '.join(lines)}; SASS HMMA/IMMA x {len(ops)} {kinds}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"{tag} spills: {lines}")
        if m and m.group(1) == "1":
            check(any(".BF16" in k for k in kinds), f"{tag}: no bf16 HMMA in its SASS")
        elif m:
            check(any(k.startswith("IMMA") and "S8" in k for k in kinds),
                  f"{tag}: no s8 IMMA in its SASS")


def check_softmax_build(ptxas_log):
    """The STAR softmax kernel's 8 instantiations (float32 / bf16 x gather /
    histogram x vector / element loads) spill nothing."""
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if "star_softmax_lut_kernel" in f}
    check(len(funcs) == 8, f"expected 8 star_softmax_lut_kernel instantiations, "
                           f"ptxas shows {len(funcs)}")
    for func, lines in sorted(funcs.items()):
        m = re.search(r"star_softmax_lut_kernelI(13__nv_bfloat16|f)Lb([01])ELb([01])E", func)
        tag = (f"star_softmax_lut_kernel {'bf16' if 'bfloat16' in m.group(1) else 'f32'} "
               f"{'histogram' if m.group(2) == '1' else 'gather'} "
               f"{'16-byte' if m.group(3) == '1' else 'element'} loads") if m else func
        log(f"{tag}: ptxas {'; '.join(lines)}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"{tag} spills: {lines}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def _flash_variants(label, base, info, live, sdpa=None, shape=None, pv_int8_block=None,
                    causal=True, window=None, dtypes=None):
    """flash_star against its plain version on ``base`` (q, k, v float32)
    in bf16 and f32, STAR and exact; ``sdpa`` times the library call for
    the exact variant.  With ``pv_int8_block`` the int8 P.V variant over
    KV blocks of that many rows, whose flips are counted as ambiguous codes
    (``_pv_int8_ambiguous``).  Each variant also records the kernel it ran
    (``design``), its device time from the profiler (pv_int8: the V
    pre-pass and the attention kernel apart), and the achieved TFLOP/s and
    share of its bound at that time.  The bound: bytes q + out + the K/V
    rows some row of each batch sees, at 3.35 TB/s, or the products as the kernel issues
    them, 2 x live scores x D for QK^T and as much for P.V: bf16 at the bf16
    tensor-core peak, float32 as three tf32 products each at the tf32 peak
    (the FP32-FMA bound beside it), pv_int8's P.V at the int8 peak.
    ``window``: the sliding window (``live`` must mask it too); ``dtypes``:
    the types to run (default bfloat16 and float32)."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.flash_star import kernel as fk

    b, hq, hkv, d = base[0].shape[0], base[0].shape[1], base[1].shape[1], base[0].shape[3]
    n_live = int(live.sum())
    kv_rows = int(live.any(dim=2).any(dim=1).sum())  # summed over the batch
    flips_key = "grid_flip_rows" if pv_int8_block is None else "code_flip_rows"
    variants = []
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in base)
        kr = k.double().repeat_interleave(hq // hkv, dim=1)
        scores64 = (q.double() @ kr.transpose(-1, -2)) * d ** -0.5
        for fmt in (FMT, None):
            mode = "star" if fmt is not None else "exact"
            name = f"{label} {mode} {dtype}"
            kw = dict(fmt=fmt, causal=causal, sliding_window=window)
            amb = None
            if pv_int8_block is not None:
                kw.update(block_k=pv_int8_block, pv_int8=True)
                amb = _pv_int8_ambiguous(scores64, live, pv_int8_block, fmt)
            got = fk.flash_star_attention(q, k, v, info, **kw)
            ref = fk.flash_star_ref(q, k, v, info, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
            n_diff = None
            if dtype == torch.bfloat16 and pv_int8_block is None:
                n_diff = int((got != ref).sum())
                log(f"{name}: {n_diff} of {got.numel()} bf16 output elements differ "
                    f"from the plain version (at most {BF16_DIFF_BOUND:g} of them may)")
            err, flips = compare_rows(name, got, ref, dtype, scores64, live,
                                      fmt.scale if fmt else None, amb=amb)
            if n_diff is not None:
                check(n_diff <= BF16_DIFF_BOUND * got.numel(),
                      f"{name}: {n_diff} of {got.numel()} bf16 output elements differ from "
                      f"the plain version, over {BF16_DIFF_BOUND:g} of them: is P rounded "
                      f"to bf16 before P.V?")
            ms = time_ms(lambda: fk.flash_star_attention(q, k, v, info, **kw))
            plain_ms = time_ms(lambda: fk.flash_star_ref(q, k, v, info, **kw))
            lib_ms = lib_dev = None
            if fmt is None and sdpa is not None:  # SDPA computes the exact softmax
                lib_err = float((sdpa(q, k, v).float() - ref.float()).abs().max())
                lib_ms = time_ms(lambda: sdpa(q, k, v))
                lib_dev = device_ms(lambda: sdpa(q, k, v))
            variant = dict(dtype=str(dtype).split(".")[-1], mode=mode,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
            variant[flips_key] = flips
            if n_diff is not None:
                variant["bf16_diff_elems"] = n_diff
            call = lambda: fk.flash_star_attention(q, k, v, info, **kw)  # noqa: E731
            flops = 4 * n_live * d
            nbytes = (2 * q.numel() + 2 * hkv * kv_rows * d) * q.element_size() + 4 * info.numel()
            bf16 = dtype == torch.bfloat16
            t_qk = flops / 2 / (H100_BF16_FLOPS if bf16 else H100_TF32_FLOPS / 3)
            if pv_int8_block is None:
                dev = device_ms(call)
                t_pv = t_qk
                design = FLASH_DESIGNS[variant["dtype"]]
            else:
                by_kernel = device_ms_by_kernel(call, per_call={k: 1 for k in PV_INT8_KERNELS})
                parts = {k: sum(t for key, t in by_kernel.items() if k in key)
                         for k in PV_INT8_KERNELS}
                dev = sum(parts.values()) if by_kernel else None
                variant.update(prepass_device_ms=parts[PV_INT8_KERNELS[0]],
                               attention_device_ms=parts[PV_INT8_KERNELS[1]])
                t_pv = flops / 2 / H100_INT8_OPS
                design = PV_INT8_DESIGN
            bound = max(nbytes / H100_BYTES_PER_S, t_qk + t_pv) * 1e3
            at = dev if dev is not None else ms
            variant.update(design=design, device_ms=dev, library_device_ms=lib_dev,
                           bound_ms=bound, tflops=flops / (at * 1e-3) / 1e12,
                           share_of_bound=bound / at)
            extra = (f" device_ms={dev} library_device_ms={lib_dev} bound_ms={bound:.5f} "
                     f"tflops={variant['tflops']:.2f} share_of_bound={bound / at:.4f} "
                     f"[{design}]")
            if not bf16:
                fma = max(nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS) * 1e3
                variant["bound_fp32_fma_ms"] = fma
                extra += f" bound_fp32_fma_ms={fma:.5f}"
            if pv_int8_block is not None:
                extra += (f" prepass_device_ms={variant['prepass_device_ms']} "
                          f"attention_device_ms={variant['attention_device_ms']}")
            if lib_ms is not None:
                extra += f" sdpa_vs_plain_max_abs={lib_err:.3e}"
            if shape is not None:
                variant["shape"] = shape
            variants.append(variant)
            log(f"{name}: max_abs_err={err:.3e} {flips_key}={flips} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms}{extra}")
    return variants


def parity_flash(results):
    import torch
    import torch.nn.functional as F

    b, hq, hkv, t, d = 1, 32, 8, 512, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, hq, t, t)
    n_live = int(live[0, 0].sum()) * hq * b

    def sdpa(q, k, v):
        try:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        except TypeError:  # torch without enable_gqa: one call on repeated heads
            g = hq // hkv
            return F.scaled_dot_product_attention(
                q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), is_causal=True)

    variants = _flash_variants("flash_star", base, info, live, sdpa=sdpa)
    variants += parity_flash_append()
    variants += parity_flash_decode()
    elem = 2  # bf16, the main path's type
    bytes_moved = (2 * b * hq * t * d + 2 * b * hkv * t * d) * elem + info.numel() * 4
    flops = 2 * 2 * n_live * d  # QK^T and P.V over the live (causal) scores
    main = variants[0]
    results.append(_entry(
        "flash_star", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:216", main, bytes_moved, flops,
        H100_BF16_FLOPS, variants, shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal"))
    results[-1]["design"] = FLASH_DESIGNS
    results[-1]["lut_route"] = flash_lut_route(base, info)


def flash_lut_route(base, info):
    """bf16 STAR at the smoke shape with the default format, whose 256-level
    LUT the kernel holds in shared memory, against a format of the same
    scale with 13 bits (8192 levels, read from global memory).  Their
    entries agree up to the default's top index, beyond which no score
    difference of these inputs reaches: the same outputs bit for bit.
    Device time of both."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.kernels.flash_star import kernel as fk

    wide = FixedPointFormat(int_bits=13 - FMT.frac_bits, frac_bits=FMT.frac_bits)
    q, k, v = (x.to(torch.bfloat16) for x in base)
    out, dev = {}, {}
    for route, fmt in (("shared", FMT), ("global", wide)):
        out[route] = fk.flash_star_attention(q, k, v, info, fmt=fmt)
        dev[route] = device_ms(lambda: fk.flash_star_attention(q, k, v, info, fmt=fmt))
    torch.cuda.synchronize()
    check(torch.equal(out["shared"], out["global"]),
          "flash_star: the LUT in shared and in global memory give different outputs")
    row = {"levels": {"shared": FMT.num_levels, "global": wide.num_levels},
           "device_ms": dev}
    log(f"flash_star bf16 STAR LUT route: shared memory ({FMT.num_levels} levels) "
        f"device_ms={dev['shared']}, global memory ({wide.num_levels} levels) "
        f"device_ms={dev['global']}; outputs bit-equal")
    return row


def parity_flash_append():
    """flash_star at the chunked-prefill append shape: a 128-row q chunk at
    q_offset 256 over a 512-row staging cache whose first 384 rows are
    valid (the rest zero, as the staging buffer holds them)."""
    import torch

    b, hq, hkv, tq, tk, d, q_off, valid = 1, 32, 8, 128, 512, 128, 256, 384
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q0 = torch.randn((b, hq, tq, d), device=dev, generator=gen)
    k0, v0 = (torch.randn((b, hkv, tk, d), device=dev, generator=gen) for _ in range(2))
    k0[:, :, valid:] = 0
    v0[:, :, valid:] = 0
    info = torch.tensor([q_off, valid], dtype=torch.int32, device=dev)
    rows = q_off + torch.arange(tq, device=dev)
    cols = torch.arange(tk, device=dev)
    live = ((cols[None, :] <= rows[:, None]) & (cols[None, :] < valid))[None, None]

    def sdpa(q, k, v):  # a boolean mask: is_causal aligns top-left, so cannot offset q
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=live, enable_gqa=True)

    return _flash_variants(
        "flash_star append", (q0, k0, v0), info, live.expand(b, hq, tq, tk), sdpa=sdpa,
        shape=f"append q[{b},{hq},{tq},{d}] at q_offset {q_off}, "
              f"kv[{b},{hkv},{tk},{d}] valid {valid}")


DECODE_VALID = (515, 387, 259, 131)  # the full-width dense tick's slots, after the write
DECODE_ROWS = 512 + 32  # the dense pool's rows: max_len of the phase 5 traffic


def parity_flash_decode():
    """flash_star at the dense decode shapes (``Tq = 1``): q ``[4, 32, 1,
    128]`` over the ``[4, 8, 544, 128]`` pool row, every row filled (a
    pool's rows past a slot's length hold stale data).  The dense tick:
    ``causal=False`` with per-slot kv_valid ``DECODE_VALID``; the lockstep
    step: ``q_offset`` 512, ``causal=True``, kv_valid 513 each.  SDPA is
    timed at ``Tq = 1`` with a boolean mask (library time only: no path
    calls it)."""
    import torch

    b, hq, hkv, tk, d = 4, 32, 8, DECODE_ROWS, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    base = (torch.randn((b, hq, 1, d), device=dev, generator=gen),
            *(torch.randn((b, hkv, tk, d), device=dev, generator=gen) for _ in range(2)))
    cols = torch.arange(tk, device=dev)
    variants = []
    for label, q_off, valid, causal in (("dense decode", 0, DECODE_VALID, False),
                                        ("lockstep decode", 512, (513,) * b, True)):
        info = torch.tensor([q_off, *valid], dtype=torch.int32, device=dev)
        live = cols[None, :] < info[1:, None]
        if causal:
            live &= cols[None, :] <= q_off
        live = live[:, None, None, :]  # [B, 1, 1, Tk]

        def sdpa(q, k, v, live=live):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=live, enable_gqa=True)

        variants += _flash_variants(
            f"flash_star {label}", base, info, live.expand(b, hq, 1, tk), sdpa=sdpa,
            causal=causal,
            shape=f"{label} q[{b},{hq},1,{d}] over kv[{b},{hkv},{tk},{d}], q_offset {q_off}, "
                  f"kv_valid {list(valid)}, causal={causal}")
    return variants


def _pv_int8_ambiguous(scores64, live, bk, fmt):
    """Live entries whose int8 code may differ between two float32
    computations: under STAR a score near a grid half-step (its grid index,
    and with it the row's max, may flip); under the exact softmax a p near a
    half-step of 1/127, p taken against the running max after each block of
    ``bk`` columns, as the variant quantizes it."""
    import torch

    if fmt is not None:
        return near_half_step(scores64 * fmt.scale) & live
    tk = scores64.shape[-1]
    s = scores64.masked_fill(~live, float("-inf"))
    nb = -(-tk // bk)
    sp = torch.nn.functional.pad(s, (0, nb * bk - tk), value=float("-inf"))
    m_run = torch.cummax(sp.reshape(*s.shape[:-1], nb, bk).amax(-1), dim=-1).values
    p = torch.exp(s - m_run.repeat_interleave(bk, dim=-1)[..., :tk])
    return near_half_step(p * 127.0) & live


def parity_pv_int8(results):
    """The int8 P.V variant at the granite prefill shape (q [1, 32, 512,
    128], kv [1, 8, 512, 128], causal, block_k 128), then ragged: Tk 500
    with kv_valid 450 (the rows past it and the 12 zero rows that pad the
    last block count in its V absmax)."""
    import torch

    b, hq, hkv, d, bk = 1, 32, 8, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    variants = []
    for t, valid in ((512, 512), (500, 450)):
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
        info = torch.tensor([0, valid], dtype=torch.int32, device=dev)
        rows = torch.arange(t, device=dev)
        live = ((rows[None, :] <= rows[:, None]) & (rows[None, :] < valid))
        live = live[None, None].expand(b, hq, t, t)
        shape = f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] valid {valid} causal block_k {bk}"
        variants += _flash_variants(f"flash_star_pv_int8 T={t}", base, info, live,
                                    shape=shape, pv_int8_block=bk)
    # the bar: bf16 pv_int8 at the smoke shape within PV_INT8_BF16_BAR x the
    # bf16 flash_star kernel's device time (measured, not enforced)
    flash = next(e for e in results if e["name"] == "flash_star")["variants"]
    for mode in ("star", "exact"):
        ref_dev = next(x["device_ms"] for x in flash if x["dtype"] == "bfloat16"
                       and x["mode"] == mode and "append" not in x.get("shape", ""))
        got = next(x for x in variants if x["dtype"] == "bfloat16" and x["mode"] == mode)
        if ref_dev and got["device_ms"]:
            got["per_bf16_flash_star"] = got["device_ms"] / ref_dev
            log(f"flash_star_pv_int8 bf16 {mode}: {got['device_ms']:.5f} ms device = "
                f"{got['per_bf16_flash_star']:.2f}x the bf16 flash_star kernel's {ref_dev:.5f} "
                f"(bar {PV_INT8_BF16_BAR:g}x)")
    t = 512
    n_live = b * hq * t * (t + 1) // 2
    bytes_moved = (2 * b * hq * t * d + 2 * b * hkv * t * d) * 2 + (1 + b) * 4
    # QK^T at the bf16 tensor-core peak, P.V at the int8 peak (twice as fast):
    # counted as bf16-equivalent operations
    ops = 2 * n_live * d * (1 + H100_BF16_FLOPS / H100_INT8_OPS)
    results.append(_entry(
        "flash_star_pv_int8", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:129", variants[0], bytes_moved, ops,
        H100_BF16_FLOPS, variants, shape=variants[0]["shape"]))


def _ssd_work(b, t, h, p, n, q, bc_bytes):
    """(bytes, FLOP by product) of one SSD chunk scan: each input read once,
    each output written once; the live (causal) triangle of every chunk's
    scores.  The products: the scores C.B^T (shared by the heads), and per
    head the decayed S.x, C.h_in and the state B^T.(w x)."""
    bytes_moved = 4 * (2 * b * t * h * p + b * t * h + b * h * n * p) + 2 * bc_bytes * b * t * n
    flops = dict(scores=0, s_x=0, c_h=0, state=0)
    for t0 in range(0, t, q):
        nv = min(q, t - t0)
        pairs = nv * (nv + 1) // 2
        flops["scores"] += b * 2 * n * pairs
        flops["s_x"] += b * h * 2 * p * pairs
        flops["c_h"] += b * h * 2 * nv * n * p
        flops["state"] += b * h * 2 * nv * n * p
    return bytes_moved, flops


def _ssd_tf32_products(flops, bc_exact):
    """tf32 tensor-core FLOP of the kernel's products: three (3xTF32) where
    both operands are float32, two where one is a bf16 value (exact in tf32:
    its lo is 0 and those products are not issued), one where both are."""
    pieces = (dict(scores=1, s_x=3, c_h=2, state=2) if bc_exact
              else dict(scores=3, s_x=3, c_h=3, state=3))
    return sum(pieces[k] * f for k, f in flops.items())


def parity_ssd_scan(results):
    """The SSD chunk-scan kernel against its plain version at the Mamba2
    serve's prefill shape: xdt [8, 2048, 24, 64], a [8, 2048, 24], B and C
    [8, 2048, 128] as slices of one conv output (as the mixer passes them),
    in bf16 and in float32, chunk 128; then a ragged T = 2000.  Device time
    from the profiler, with each of the three kernels apart."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    b, h, p, n, q = 8, 24, 64, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    variants = []
    for t in (2048, 2000):
        xdt = torch.randn((b, t, h, p), device=dev, generator=gen)
        a = -(torch.randn((b, t, h), device=dev, generator=gen) * 0.1).abs()
        conv = torch.randn((b, t, h * p + 2 * n), device=dev, generator=gen) * 0.3
        for dtype in (torch.bfloat16, torch.float32):
            cv = conv.to(dtype)
            bm, cm = cv[..., h * p:h * p + n], cv[..., h * p + n:]
            name = f"ssd_scan T={t} B/C {dtype}"
            y, hout = ssk.ssd_scan(xdt, a, bm, cm, chunk=q)
            y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=q)
            torch.cuda.synchronize()
            errs = {}
            for label, got, ref in (("y", y, y0), ("hout", hout, h0)):
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite {label}")
                scale = float(ref.abs().max())
                errs[label] = float((got - ref).abs().max())
                check(errs[label] <= SSD_RTOL * scale,
                      f"{name}: {label} max err {errs[label]:.3e} > {SSD_RTOL} x "
                      f"max |plain| {scale:.3e}")
            ms = time_ms(lambda: ssk.ssd_scan(xdt, a, bm, cm, chunk=q))
            plain_ms = time_ms(lambda: ssd_scan_ref(xdt, a, bm, cm, chunk=q))
            by_kernel = device_ms_by_kernel(lambda: ssk.ssd_scan(xdt, a, bm, cm, chunk=q),
                                            per_call={k: 1 for k in SSD_KERNELS})
            parts = {k: sum(v for key, v in by_kernel.items() if k in key) for k in SSD_KERNELS}
            dev_ms = sum(parts.values()) if by_kernel else None
            # the kernels run back to back, so the device time is most of the
            # CUDA-event time; far less means the profiler lost records
            check(dev_ms is None or dev_ms >= 0.5 * ms,
                  f"{name}: device time {dev_ms} ms under half the CUDA-event {ms:.4f} ms")
            bytes_moved, by_product = _ssd_work(b, t, h, p, n, q, cv.element_size())
            flops = sum(by_product.values())
            # two bounds: the FLOP on FP32 FMAs, and the tf32 tensor-core
            # products as the kernel issues them (3xTF32 for two float32
            # operands, fewer with bf16 B/C), the lower one
            tf32_ops = _ssd_tf32_products(by_product, dtype == torch.bfloat16)
            t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
            t_tc = tf32_ops / H100_TF32_FLOPS * 1e3
            bound_fp32 = max(t_bytes, flops / H100_FP32_FLOPS * 1e3)
            bound = max(t_bytes, t_tc)
            at = dev_ms if dev_ms is not None else ms
            variants.append(dict(
                dtype=str(dtype).split(".")[-1], shape=f"T={t}", design=SSD_DESIGN,
                max_abs_err=errs["y"], y_rel_err=errs["y"] / float(y0.abs().max()),
                hout_max_abs_err=errs["hout"], ms=ms, device_ms=dev_ms,
                device_ms_by_kernel=parts if by_kernel else None, plain_ms=plain_ms,
                library_ms=None, bytes=bytes_moved, ops=flops, tf32_ops=tf32_ops, bound_ms=bound,
                bound_fp32_ms=bound_fp32, bound_by="bytes" if t_bytes >= t_tc else "operations",
                share_of_bound=bound / at))
            log(f"{name}: y max_abs_err={errs['y']:.3e} (rel {variants[-1]['y_rel_err']:.3e}) "
                f"hout max_abs_err={errs['hout']:.3e} ms={ms:.4f} device_ms={dev_ms} "
                f"({ {k.split('_kernel')[0]: round(v, 5) for k, v in parts.items()} }) "
                f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} (tf32 products "
                f"{tf32_ops / 1e9:.2f} GFLOP; FP32 FMA {bound_fp32:.4f}) "
                f"share_of_bound={bound / at:.4f}")
    main = variants[0]  # T 2048, bf16 B/C: the serve's call
    results.append(_entry(
        "ssd_scan", "cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:97", main, main["bytes"], main["tf32_ops"],
        H100_TF32_FLOPS, variants,
        shape=f"xdt[{b},2048,{h},{p}] a[{b},2048,{h}] B/C[{b},2048,{n}] chunk {q}; "
              "main variant bf16 B/C"))


PAGED_DESIGN = "split-KV, L = 64 rows a split, + combine"
PAGED_SHAPES = {  # name: (kv_valid per slot, table width W in blocks of 16)
    "smoke": ([0, 1, 17, 600], 38),
    # a decode tick of the fp serve's traced window: prompts of 512, 384,
    # 256 and 128 tokens after two decode steps, tables of (512 + 32) / 16
    "tick": ([514, 386, 258, 130], 34),
    # short contexts under a table of 32 rows: one split, no combine launch
    "short": ([0, 1, 17, 30], 2),
}


def _paged_work(q, lens, w, hkv, pool_elem, pages_scaled=0):
    """Bytes (q and out once, the live K/V rows once, tables, kv_valid and
    the live pages' two scales) and FP32 operations (QK^T and P.V) of one
    paged decode call."""
    s, hq, d = q.shape
    live_rows = sum(lens)
    nbytes = (2 * live_rows * hkv * d * pool_elem + 2 * q.numel() * q.element_size()
              + 4 * (s * w + s) + 2 * pages_scaled * hkv * 4)
    return nbytes, 4 * live_rows * hq * d


def _paged_variant(name, fn, ref_fn, got_dtype, scores64, live, fmt, nbytes, flops, extra):
    """One paged variant: parity against the plain version, CUDA-event time,
    device time of the split and combine kernels, bound and share."""
    import torch

    got, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    err, flips = compare_rows(name, got, ref, got_dtype, scores64, live,
                              fmt.scale if fmt else None)
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn)
    by_kernel = device_ms_by_kernel(fn)
    split_ms = sum(t for k, t in by_kernel.items() if "paged_split_kernel" in k)
    combine_ms = sum(t for k, t in by_kernel.items() if "paged_combine_kernel" in k)
    dev = (split_ms + combine_ms) if by_kernel else None
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    at = dev if dev is not None else ms
    variant = dict(extra, max_abs_err=err, grid_flip_rows=flips, ms=ms, device_ms=dev,
                   split_device_ms=split_ms if by_kernel else None,
                   combine_device_ms=combine_ms if by_kernel else None, plain_ms=plain_ms,
                   library_ms=None, bytes=nbytes, ops=flops, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   share_of_bound=bound / at)
    log(f"{name}: max_abs_err={err:.3e} grid_flip_rows={flips} ms={ms:.4f} device_ms={dev} "
        f"(split {variant['split_device_ms']}, combine {variant['combine_device_ms']}) "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.5f} share_of_bound={bound / at:.4f}")
    return got, variant


def parity_paged(results):
    """The paged kernels (split-KV + combine) against their plain version at
    the smoke shape and at the full-width decode tick's shape (S 4, Hq 32,
    Hkv 8, D 128, bs 16): bf16 and float32 q over pools of q's type and over
    int8 / fp8_e4m3 pools, STAR and exact.  At the tick shape also a slot's
    output alone against the same slot in the batch under a wider table, and
    at the short shape (one split, no combine) each slot against the same
    slot in a batch under the tick's table width (combine): bit-equal."""
    import torch

    from repro_torch.core import kvquant
    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import gather_pages

    hq, hkv, d, bs = 32, 8, 128, 16
    dev = torch.device("cuda")
    variants, qvariants, splits = [], [], {}
    for shape, (lens, w) in PAGED_SHAPES.items():
        s = len(lens)
        n = s * w + 1
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 if shape == "smoke" else SEED + 8)
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((s, hq, d), (n, bs, hkv, d), (n, bs, hkv, d))]
        tables = (torch.randperm(n - 1, device=dev, generator=gen)[: s * w] + 1)
        tables = tables.reshape(s, w).to(torch.int32).contiguous()
        valid = torch.tensor(lens, dtype=torch.int32, device=dev)
        cols = torch.arange(w * bs, device=dev)
        live = (cols[None, :] < valid[:, None])[:, None, :].expand(s, hq, w * bs)
        splits[shape] = pk.num_splits(w, bs)
        live_pages = sum(-(-x // bs) for x in lens)
        pools = {"bf16": None}
        for kv_dtype in ("int8", "fp8_e4m3"):
            kc, ks = kvquant.quantize_blocks(base[1], kv_dtype)
            vc, vs = kvquant.quantize_blocks(base[2], kv_dtype)
            pools[kv_dtype] = (kc, vc, dict(k_scale=ks, v_scale=vs))
        for pool, coded in pools.items():
            if coded is not None:  # K as the kernel dequantizes it
                kp, vp, kw_pages = coded
                kdq = kvquant.decode(kp, kw_pages["k_scale"][:, None, :, None])
                k64 = gather_pages(kdq, kdq, tables)[0].double().repeat_interleave(hq // hkv, 2)
                elem, scaled = 1, live_pages
            for dtype in (torch.bfloat16, torch.float32):
                q = base[0].to(dtype)
                if coded is None:  # a pool of q's type
                    kp, vp = base[1].to(dtype), base[2].to(dtype)
                    kw_pages, elem, scaled = {}, q.element_size(), 0
                    k64 = gather_pages(kp, vp, tables)[0].double().repeat_interleave(hq // hkv, 2)
                scores64 = torch.einsum("shd,sthd->sht", q.double(), k64) * d ** -0.5
                nbytes, flops = _paged_work(q, lens, w, hkv, elem, scaled)
                for fmt in (FMT, None):
                    mode = "star" if fmt is not None else "exact"
                    tag = "paged" if coded is None else f"paged_quant {pool}"
                    name = f"{tag} {shape} {mode} {dtype}"
                    kw = dict(fmt=fmt, **kw_pages)
                    extra = dict(shape=shape, dtype=str(dtype).split(".")[-1], mode=mode,
                                 splits=splits[shape], split_rows=pk.SPLIT_ROWS)
                    if coded is not None:
                        extra["kv_dtype"] = pool
                    got, variant = _paged_variant(
                        name, lambda: pk.paged_flash_attention(q, kp, vp, tables, valid, **kw),
                        lambda: pk.paged_attention_ref(q, kp, vp, tables, valid, **kw),
                        dtype, scores64, live, fmt, nbytes, flops, extra)
                    check(not bool(got[valid == 0].any()), f"{name}: free slot not zero")
                    (variants if coded is None else qvariants).append(variant)
                    if shape == "short":
                        # the direct route against the combine: the same slots
                        # under the tick's width, slot 0 made long
                        w_wide = PAGED_SHAPES["tick"][1]
                        wide_tables = torch.cat([tables, torch.zeros(
                            s, w_wide - w, dtype=torch.int32, device=dev)], 1).contiguous()
                        wide_valid = valid.clone()
                        wide_valid[0] = PAGED_SHAPES["tick"][0][0]
                        wide = pk.paged_flash_attention(q, kp, vp, wide_tables, wide_valid, **kw)
                        check(torch.equal(got[1:], wide[1:]),
                              f"{name}: slots of one split (W {w}, no combine) differ from "
                              f"the same slots under W {w_wide} (combine)")
                        log(f"{name}: slots of lens {lens[1:]} alone (W {w}, 1 split, no "
                            f"combine) bit-equal under W {w_wide} "
                            f"({pk.num_splits(w_wide, bs)} splits, combine)")
                    if shape != "tick" or dtype != torch.bfloat16 or fmt is None:
                        continue
                    w0 = -(-lens[0] // bs)
                    alone = pk.paged_flash_attention(q[:1].contiguous(), kp, vp,
                                                     tables[:1, :w0].contiguous(), valid[:1], **kw)
                    check(torch.equal(alone[0], got[0]),
                          f"{name}: slot 0 alone (W {w0}) differs from slot 0 in the batch (W {w})")
                    log(f"{name}: slot 0 alone (W {w0}, {pk.num_splits(w0, bs)} splits) "
                        f"bit-equal to slot 0 in the batch (W {w}, {splits[shape]} splits)")
    desc = (f"S=4 Hq={hq} Hkv={hkv} D={d} bs={bs}; "
            + ", ".join(f"{k} lens {lens} W {w}" for k, (lens, w) in PAGED_SHAPES.items())
            + "; main variant: tick, bf16 q, STAR")
    for name, replaces, vs_, suffix in (
            ("paged_attention", "src/repro/kernels/paged_attention/kernel.py:222", variants, ""),
            ("paged_attention_quant", "src/repro/kernels/paged_attention/kernel.py:230", qvariants,
             " over int8 pages + [N,Hkv] scales (fp8_e4m3 too)")):
        main = next(v for v in vs_ if v["shape"] == "tick" and v["dtype"] == "bfloat16"
                    and v["mode"] == "star" and v.get("kv_dtype", "int8") == "int8")
        results.append(_entry(
            name, "cuda", "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            replaces, main, main["bytes"], main["ops"], H100_FP32_FLOPS, vs_,
            shape=desc + suffix))
        results[-1].update(design=PAGED_DESIGN, splits=splits, device_ms=main["device_ms"])


VLM_ARCH = "qwen2_vl_7b"
VLM_MAX_LEN = 256 + 512 + 32  # the phase 10 pool's rows: 256 patch rows + the phase 5 traffic
VLM_DECODE_VALID = (771, 643, 515, 387)  # a phase 10 tick's slots (patches + prompt + 3)
# head_dim 8: deepseek-coder-33b's smoke group (7 q heads over 1 KV head) and
# llama3-405b's (8 over 2)
D8_GROUPS = ((7, 1), (8, 2))
D8_PAGED_LENS = ([0, 1, 17, 600], 38)  # the smoke shape's lens and table width


def _causal_sdpa(q, k, v):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def parity_flash_new(results):
    """flash_star at this slice's shapes, as variants of the ``flash_star``
    and ``flash_star_pv_int8`` entries: qwen2-vl-7b's prefill, q [1, 28,
    768, 128] causal over Hkv 4 (256 patch rows and 512 tokens, G 7), and its
    dense decode, q [4, 28, 1, 128] over [4, 4, 800, 128] pool rows
    (kv_valid VLM_DECODE_VALID, not causal), SDPA timed beside each exact
    variant; head_dim 8 at the two smoke groups (q [1, 7, 256, 8] over [1,
    1, 256, 8], q [1, 8, 256, 8] over [1, 2, 256, 8], causal; SDPA beside
    the exact variant), and its int8 P.V variant there (block_k 128)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    variants, pv_variants = [], []
    b, hq, hkv, t, d = 1, 28, 4, 768, 128
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, hq, t, t)
    variants += _flash_variants(
        "flash_star qwen2-vl prefill", base, info, live, sdpa=_causal_sdpa,
        shape=f"qwen2-vl prefill q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal")

    s, tk = 4, VLM_MAX_LEN
    base = (torch.randn((s, hq, 1, d), device=dev, generator=gen),
            *(torch.randn((s, hkv, tk, d), device=dev, generator=gen) for _ in range(2)))
    info = torch.tensor([0, *VLM_DECODE_VALID], dtype=torch.int32, device=dev)
    cols = torch.arange(tk, device=dev)
    live = (cols[None, :] < info[1:, None])[:, None, None, :]

    def sdpa_decode(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=live, enable_gqa=True)

    variants += _flash_variants(
        "flash_star qwen2-vl dense decode", base, info, live.expand(s, hq, 1, tk),
        sdpa=sdpa_decode, causal=False,
        shape=f"qwen2-vl dense decode q[{s},{hq},1,{d}] over kv[{s},{hkv},{tk},{d}], "
              f"kv_valid {list(VLM_DECODE_VALID)}, causal=False")

    t, d = 256, 8
    rows = torch.arange(t, device=dev)
    for hq8, hkv8 in D8_GROUPS:
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((1, hq8, t, d), (1, hkv8, t, d), (1, hkv8, t, d))]
        info = torch.tensor([0, t], dtype=torch.int32, device=dev)
        live = (rows[None, :] <= rows[:, None])[None, None].expand(1, hq8, t, t)
        shape = f"D 8, G {hq8 // hkv8}: q[1,{hq8},{t},{d}] kv[1,{hkv8},{t},{d}] causal"
        variants += _flash_variants(f"flash_star D8 G{hq8 // hkv8}", base, info, live,
                                    sdpa=_causal_sdpa, shape=shape)
        pv_variants += _flash_variants(f"flash_star_pv_int8 D8 G{hq8 // hkv8}", base, info,
                                       live, shape=shape + " block_k 128", pv_int8_block=128)
    for name, new in (("flash_star", variants), ("flash_star_pv_int8", pv_variants)):
        next(e for e in results if e["name"] == name)["variants"] += new


HYBRID_ARCH = "recurrentgemma_2b"
ENCDEC_ARCH = "seamless_m4t_large_v2"
HYBRID_PREFILL = 3072  # phase 11's long prompts: past the window, so it masks and the ring wraps
HYBRID_WINDOW = 2048
HYBRID_PAGED_LENS = (2048, 2080, 2100, 2300)  # paged decode at D 256: slots past the window


def parity_flash_d256(results):
    """flash_star at head_dim 256, as variants of the ``flash_star`` and
    ``flash_star_pv_int8`` entries: recurrentgemma-2b's prefill, q [1, 10,
    3072, 256] causal over one KV head with its window of 2048 (rows past
    2048 see a window, not the whole prefix), and its ring decode, q [4, 10,
    1, 256] over [4, 1, 2048, 256] (a full ring, not causal); the bf16 and
    the float32 kernel at both, SDPA beside each exact variant in the same
    type with the same boolean mask; the int8 P.V variant at both (bf16 and
    float32 q/k, block_k 128); and the int8 P.V variant over blocks of 256
    rows at granite's prefill shape, q [1, 32, 512, 128] causal over Hkv 8
    (two blocks: each block's P against the running max after all 256 of
    its rows)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    b, hq, hkv, t, d, w = 1, 10, 1, HYBRID_PREFILL, 256, HYBRID_WINDOW
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    mask = (rows[None, :] <= rows[:, None]) & (rows[None, :] > rows[:, None] - w)

    def sdpa_window(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    live = mask[None, None].expand(b, hq, t, t)
    shape = (f"recurrentgemma prefill q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal, "
             f"window {w}")
    variants = _flash_variants("flash_star recurrentgemma prefill D256", base, info, live,
                               sdpa=sdpa_window, window=w, shape=shape)
    pv_variants = _flash_variants("flash_star_pv_int8 recurrentgemma prefill D256", base, info,
                                  live, window=w, pv_int8_block=128,
                                  shape=shape + " block_k 128")
    s = 4
    base = (torch.randn((s, hq, 1, d), device=dev, generator=gen),
            *(torch.randn((s, hkv, w, d), device=dev, generator=gen) for _ in range(2)))
    info = torch.tensor([0] + [w] * s, dtype=torch.int32, device=dev)
    live = torch.ones((s, hq, 1, w), dtype=torch.bool, device=dev)

    def sdpa_ring(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True)

    shape = (f"recurrentgemma ring decode q[{s},{hq},1,{d}] over kv[{s},{hkv},{w},{d}], "
             f"a full ring, causal=False")
    variants += _flash_variants("flash_star recurrentgemma ring decode D256", base, info, live,
                                sdpa=sdpa_ring, causal=False, shape=shape)
    pv_variants += _flash_variants("flash_star_pv_int8 recurrentgemma ring decode D256", base,
                                   info, live, causal=False, pv_int8_block=128,
                                   shape=shape + " block_k 128")
    b, hq, hkv, t, d, bk = 1, 32, 8, 512, 128, 256
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, hq, t, t)
    pv_variants += _flash_variants(
        f"flash_star_pv_int8 block_k {bk}", base, info, live, pv_int8_block=bk,
        shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal block_k {bk}")
    for name, new in (("flash_star", variants), ("flash_star_pv_int8", pv_variants)):
        next(e for e in results if e["name"] == name)["variants"] += new


def parity_flash_bert(results):
    """flash_star's float32 kernel at the shape phase 13 gives it, as
    variants of the ``flash_star`` entry: bert-base-star's eval and its
    lockstep prefill, q [8, 12, 512, 64] causal over as many KV heads (D 64,
    G 1), STAR and exact, SDPA float32 beside the exact variant."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    b, h, t, d = TRAIN_BATCH, 12, TRAIN_SEQ, 64
    base = [torch.randn((b, h, t, d), device=dev, generator=gen) for _ in range(3)]
    info = torch.tensor([0] + [t] * b, dtype=torch.int32, device=dev)
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, h, t, t)
    next(e for e in results if e["name"] == "flash_star")["variants"] += _flash_variants(
        "flash_star bert-base-star D64 G1", base, info, live, sdpa=_causal_sdpa,
        dtypes=(torch.float32,),
        shape=f"bert-base-star q[{b},{h},{t},{d}] kv[{b},{h},{t},{d}] causal, float32")


def parity_paged_new(results):
    """The paged kernels at this slice's shapes, as variants of the
    ``paged_attention`` / ``paged_attention_quant`` entries: qwen2-vl-7b's
    tick (S 4, Hq 28, Hkv 4: G 7, D 128, bs 16, lens VLM_DECODE_VALID, W
    50) over bf16 pages, bf16 q; and D 8 at G 7 and G 4 (S 4, bs 16, lens
    0/1/17/600, W 38) over float32 and bf16 pages (q of the pool's type)
    and over int8 and fp8_e4m3 pages (float32 q, as the smoke configs
    compute: rows of 8 one-byte codes), STAR and exact; and D 256 at
    recurrentgemma-2b's heads (S 4, Hq 10, Hkv 1: G 10, bs 16, lens
    HYBRID_PAGED_LENS past a 2048-row window, W 144) over the same four page
    types, held through ``ops`` dispatch (``ops.paged_attention`` with
    ``impl="pallas_paged"``: no engine reaches it, since the continuous
    engine refuses the hybrid family, as the reference's does)."""
    import torch

    from repro_torch.core import kvquant
    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import gather_pages

    dev = torch.device("cuda")
    bs = 16
    cases = [("qwen2-vl tick", 28, 4, 128, list(VLM_DECODE_VALID), VLM_MAX_LEN // bs,
              (("bf16", torch.bfloat16),))]
    all_pools = (("fp32", torch.float32), ("bf16", torch.bfloat16),
                 ("int8", torch.float32), ("fp8_e4m3", torch.float32))
    for hq, hkv in D8_GROUPS:
        cases.append((f"D8 G{hq // hkv}", hq, hkv, 8, *D8_PAGED_LENS, all_pools))
    cases.append(("recurrentgemma D256 G10", 10, 1, 256, list(HYBRID_PAGED_LENS),
                  -(-max(HYBRID_PAGED_LENS) // bs), all_pools))
    fp, quant = [], []
    for label, hq, hkv, d, lens, w, pools in cases:
        s, n = len(lens), len(lens) * w + 1
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((s, hq, d), (n, bs, hkv, d), (n, bs, hkv, d))]
        tables = (torch.randperm(n - 1, device=dev, generator=gen)[: s * w] + 1)
        tables = tables.reshape(s, w).to(torch.int32).contiguous()
        valid = torch.tensor(lens, dtype=torch.int32, device=dev)
        cols = torch.arange(w * bs, device=dev)
        live = (cols[None, :] < valid[:, None])[:, None, :].expand(s, hq, w * bs)
        live_pages = sum(-(-x // bs) for x in lens)
        for pool, qdtype in pools:
            q = base[0].to(qdtype)
            if pool in ("fp32", "bf16"):
                kp, vp = base[1].to(qdtype), base[2].to(qdtype)
                kw_pages, elem, scaled, kdq = {}, q.element_size(), 0, kp
            else:
                (kp, ks), (vp, vs) = (kvquant.quantize_blocks(x, pool) for x in base[1:])
                kw_pages, elem, scaled = dict(k_scale=ks, v_scale=vs), 1, live_pages
                kdq = kvquant.decode(kp, ks[:, None, :, None])
            k64 = gather_pages(kdq, kdq, tables)[0].double().repeat_interleave(hq // hkv, 2)
            scores64 = torch.einsum("shd,sthd->sht", q.double(), k64) * d ** -0.5
            nbytes, flops = _paged_work(q, lens, w, hkv, elem, scaled)
            for fmt in (FMT, None):
                mode = "star" if fmt is not None else "exact"
                tag = "paged" if not kw_pages else f"paged_quant {pool}"
                name = f"{tag} {label} {mode} {qdtype}"
                kw = dict(fmt=fmt, **kw_pages)
                extra = dict(shape=f"{label}: S={s} Hq={hq} Hkv={hkv} D={d} bs={bs} lens {lens} "
                                   f"W {w}", dtype=str(qdtype).split(".")[-1], mode=mode,
                             pool=pool, splits=pk.num_splits(w, bs), split_rows=pk.SPLIT_ROWS)
                call = lambda: pk.paged_flash_attention(q, kp, vp, tables, valid, **kw)  # noqa: E731
                if d == 256:  # through the ops layer, as a model's decode would reach it
                    call = _paged_via_ops(q, kp, vp, tables, valid, fmt, pool, kw_pages)
                    extra["via"] = "ops.paged_attention(impl='pallas_paged')"
                before = (pk.LAUNCHES_QUANT if kw_pages else pk.LAUNCHES).count
                got, variant = _paged_variant(
                    name, call, lambda: pk.paged_attention_ref(q, kp, vp, tables, valid, **kw),
                    qdtype, scores64, live, fmt, nbytes, flops, extra)
                check((pk.LAUNCHES_QUANT if kw_pages else pk.LAUNCHES).count > before,
                      f"{name}: the paged kernel did not launch")
                check(not bool(got[valid == 0].any()), f"{name}: free slot not zero")
                (quant if kw_pages else fp).append(variant)
    for name, new in (("paged_attention", fp), ("paged_attention_quant", quant)):
        next(e for e in results if e["name"] == name)["variants"] += new


def _paged_via_ops(q, kp, vp, tables, valid, fmt, pool, kw_pages):
    """A paged decode call through ``ops.paged_attention`` with the
    gather-free kernel (``impl="pallas_paged"``): q ``[S, Hq, D]`` as one
    decode row a slot, the pool's scale pages as ``kv_scales``."""
    from repro_torch import ops

    spec = ops.PagedAttentionSpec(
        impl="pallas_paged", kv_dtype=pool if kw_pages else "fp32",
        softmax=ops.SoftmaxSpec() if fmt is not None else ops.SoftmaxSpec(kind="exact"))
    scales = (kw_pages["k_scale"], kw_pages["v_scale"]) if kw_pages else None
    return lambda: ops.paged_attention(q[:, None], kp, vp, tables, spec, kv_valid_len=valid,
                                       kv_scales=scales)[:, 0]


def _softmax_variant(name, fn, ref_fn, x, extra):
    """One STAR softmax variant: parity against the plain version (rtol
    1e-5, atol 1e-9), CUDA-event and device time, the cluster it ran on."""
    import torch

    from repro_torch.kernels.star_softmax import kernel as sk

    got, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    err = float((got - ref).abs().max())
    check(bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-9)),
          f"{name}: max err {err:.3e} out of tolerance")
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn)
    dev = device_ms_per_launch(fn, "star_softmax_lut_kernel")
    d = x.shape[-1]
    cluster, slice_ = sk.cluster_size(d), sk.slice_len(d, sk.cluster_size(d))
    t_bytes = extra["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = 16 * x.numel() / H100_FP32_FLOPS * 1e3  # as the star_softmax entry counts them
    bound = max(t_bytes, t_ops)
    log(f"{name}: cluster {cluster} CTAs a row ({x.shape[0] * cluster} CTAs, slices of "
        f"{slice_}) max_abs_err={err:.3e} ms={ms:.4f} device_ms={dev} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.6f}")
    return dict(extra, shape=str(list(x.shape)), cluster=cluster, slice=slice_,
                max_abs_err=err, grid_flip_rows=0, ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def parity_softmax(results):
    """The STAR softmax kernel in clean ``gather`` mode at the sampling
    shapes (granite [4, 49152], Mamba2 [8, 50688], qwen2-vl [4, 152064],
    recurrentgemma [4, 256000], seamless [4, 256512] with its 306 padded
    columns at -1e30), bit-equal to the plain version (which adds a row in
    the kernel's order), ``-inf`` columns saturating as the plain version
    does, ``onehot`` bit-equal to it."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.star_softmax import kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    variants = []
    for rows, d, pad in SOFTMAX_SHAPES:
        x = torch.randn(rows, d, device=dev, generator=gen) * 4
        x[:, d - pad:] = -1e30  # the vocabulary's padding columns, as unembed masks them
        variants.append(_softmax_variant(
            f"star_softmax gather clean float32 [{rows}, {d}]"
            + (f" ({pad} columns at -1e30)" if pad else ""),
            lambda: sk.star_softmax_kernel(x, FMT), lambda: sk.star_softmax_ref(x, FMT), x,
            dict(dtype="float32", mode="gather", fault=None, bytes=2 * x.numel() * 4)))
        got, ref = sk.star_softmax_kernel(x, FMT), sk.star_softmax_ref(x, FMT)
        check(torch.equal(got, ref), f"star_softmax [{rows}, {d}]: {int((got != ref).sum())} "
              f"probabilities differ from the plain version's")
        variants[-1]["bit_equal"] = True
        log(f"star_softmax gather [{rows}, {d}] f32: bit-equal to the plain version")
        xi = x.clone()
        xi[:, :512] = -float("inf")  # saturates to the last level, never wraps
        gi = sk.star_softmax_kernel(xi, FMT)
        check(bool(torch.allclose(gi, sk.star_softmax_ref(xi, FMT), rtol=1e-5, atol=1e-9)),
              f"star_softmax [{rows}, {d}]: -inf columns disagree with the plain version")
        onehot = sk.star_softmax_kernel(x, FMT, mode="onehot")
        check(torch.equal(onehot, sk.star_softmax_kernel(x, FMT)),
              f"star_softmax [{rows}, {d}]: onehot mode is not bit-equal to gather")
        log(f"star_softmax onehot [{rows}, {d}] f32: bit-equal to gather (the same launch)")
    main = variants[0]
    ops = 16 * 4 * 49152  # per element: grid snap ~12, index 2, sum 1, divide 1
    results.append(_entry(
        "star_softmax", "cuda", "src/repro_torch/kernels/star_softmax/csrc/star_softmax_lut.cu",
        "src/repro/kernels/star_softmax/kernel.py:177", main, main["bytes"],
        ops, H100_FP32_FLOPS, variants,
        shape="[4, 49152] f32 (main); [8, 50688], [4, 152064], [4, 256000] and [4, 256512] "
              "in variants"))
    results[-1].update(design=SOFTMAX_DESIGN, device_ms=main["device_ms"])


def parity_softmax_lut(results):
    """The same kernel under the ``star_softmax_lut`` counter: clean
    histogram and the mild fault in every mode, float32 and bfloat16, at the
    sampling shape [4, 49152], and the histogram at [8, 50688], against the
    plain version (the reference engine with the same realization)."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.kernels.star_softmax import kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    base = torch.randn(4, 49152, device=dev, generator=gen) * 4
    wide = torch.randn(8, 50688, device=dev, generator=gen) * 4
    mild = FaultModel(**MILD)
    cases = [(base.to(dtype), mode, fault) for dtype in (torch.float32, torch.bfloat16)
             for mode, fault in (("histogram", None), ("histogram", mild), ("gather", mild),
                                 ("onehot", mild))]
    cases += [(wide, "histogram", None), (wide, "histogram", mild)]
    variants = []
    for x, mode, fault in cases:
        dtype = str(x.dtype).split(".")[-1]
        name = (f"star_softmax_lut {mode} {'mild fault' if fault else 'clean'} {dtype} "
                f"{list(x.shape)}")
        variants.append(_softmax_variant(
            name, lambda: sk.star_softmax_kernel(x, FMT, mode=mode, fault=fault),
            lambda: sk.star_softmax_ref(x, FMT, mode=mode, fault=fault), x,
            dict(dtype=dtype, mode=mode, fault="mild" if fault else None,
                 bytes=x.numel() * (x.element_size() + 4) + 3 * FMT.num_levels * 4)))
    main = variants[1]  # the faulty histogram in float32: the degraded serve's call
    ops = 16 * base.numel() + 2 * FMT.num_levels  # per element as star_softmax, plus the VMM
    results.append(_entry(
        "star_softmax_lut", "cuda", "src/repro_torch/kernels/star_softmax/csrc/star_softmax_lut.cu",
        "src/repro/kernels/star_softmax/kernel.py:201", main, main["bytes"], ops,
        H100_FP32_FLOPS, variants, shape="[4, 49152]; main variant f32 histogram, mild fault"))
    results[-1]["also_replaces"] = "src/repro/kernels/star_softmax/kernel.py:177 (use_histogram)"
    results[-1].update(design=SOFTMAX_DESIGN, device_ms=main["device_ms"])


def parity_softmax_router():
    """The STAR softmax kernel at the MoE router's shapes (ROUTER_SHAPES),
    float32 and bfloat16: one CTA a row (``cluster_size(d) == 1``), the
    probabilities bit-equal to the plain version's (which adds a row in the
    kernel's order) and to the CPU plain version's, the top-k experts equal;
    device time per launch and the bound of its bytes.  Returns the
    variants, kept under the ``star_softmax`` entry."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.star_softmax import kernel as sk
    from repro_torch.models.layers import top_k

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    variants = []
    for rows, d, k in ROUTER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(rows, d, device=dev, generator=gen) * 4).to(dtype)
            name = f"star_softmax router {str(dtype).split('.')[-1]} [{rows}, {d}] top-{k}"
            got, ref = sk.star_softmax_kernel(x, FMT), sk.star_softmax_ref(x, FMT)
            torch.cuda.synchronize()
            check(sk.cluster_size(d) == 1, f"{name}: cluster of {sk.cluster_size(d)} CTAs")
            check(torch.equal(got, ref), f"{name}: {int((got != ref).sum())} probabilities "
                  f"differ from the plain version (max {float((got - ref).abs().max()):.3e})")
            check(torch.equal(got.cpu(), sk.star_softmax_ref(x.cpu(), FMT)),
                  f"{name}: the cpu plain version differs")
            check(torch.equal(top_k(got, k)[1], top_k(ref, k)[1]), f"{name}: top-{k} differ")
            fn = lambda: sk.star_softmax_kernel(x, FMT)  # noqa: E731
            ms, plain_ms = time_ms(fn), time_ms(lambda: sk.star_softmax_ref(x, FMT))
            dev_ms = device_ms_per_launch(fn, "star_softmax_lut_kernel")
            nbytes = x.numel() * (x.element_size() + 4) + 3 * FMT.num_levels * 4
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = 16 * x.numel() / H100_FP32_FLOPS * 1e3
            log(f"{name}: 1 CTA a row ({rows} CTAs), bit-equal to the plain version and to "
                f"the cpu plain version, top-{k} experts equal; ms={ms:.4f} device_ms={dev_ms} "
                f"plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.6f} (bytes {nbytes})")
            variants.append(dict(shape=str([rows, d]), dtype=str(dtype).split(".")[-1],
                                 top_k=k, cluster=1, bit_equal=True, max_abs_err=0.0, ms=ms,
                                 device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                                 bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                                 bound_by="bytes" if t_bytes >= t_ops else "operations"))
    return variants


def realization_bits() -> None:
    """A fault realization is the same bits on the card and on the CPU: the
    softmax tables, the tile offsets, and the weight-cell factor and masks
    (the first 64 rows of the q projection's [4096, 4096] realization against
    a CPU draw of [64, 4096]: element i hashes counter i whatever the shape)."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.hwmodel import faults as tf

    mild = tf.FaultModel(**MILD)
    for tag in ("softmax/lut", "softmax/vmm"):
        check(torch.equal(tf.faulty_exp_lut(FMT, mild, tag, device="cuda").cpu(),
                          tf.faulty_exp_lut(FMT, mild, tag, device="cpu")),
              f"realization {tag}: card and cpu differ")
    check(torch.equal(tf.cam_remap(FMT, mild, device="cuda").cpu(), tf.cam_remap(FMT, mild)),
          "realization softmax/cam: card and cpu differ")
    check(torch.equal(tf.adc_tile_offsets(mild, (32, 112), device="cuda").cpu(),
                      tf.adc_tile_offsets(mild, (32, 112))),
          "realization matmul/adc: card and cpu differ")
    card = tf._cell_realization(mild, "matmul/w", (4096, 4096), "cuda:0")
    cpu = tf._cell_realization(mild, "matmul/w", (64, 4096), "cpu")
    for name, a, b in zip(("factor", "stuck_on", "stuck_off"), card, cpu):
        check(torch.equal(a[:64].cpu(), b), f"realization matmul/w {name}: card and cpu differ "
              f"in {int((a[:64].cpu() != b).sum())} of {b.numel()} elements")
    log("fault realization: softmax/lut, softmax/vmm, softmax/cam, matmul/adc and matmul/w "
        "bits identical on card and cpu")


def _entry(name, route, source, replaces, main, bytes_moved, ops, peak, variants, shape):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": main["library_ms"], "shape": shape, "variants": variants,
    }


# ---------------------------------------------------------------------------
# phase 4: small-input reference (card kernels vs CPU plain versions)


def small_reference():
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.star_softmax import kernel as sk
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    devices = (("cuda", params_gpu), ("cpu", params_cpu))

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    outs = {}
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            eng = ContinuousBatchingEngine(
                cfg, params, ContinuousConfig(num_slots=2, max_len=40, kv_layout="paged",
                                              kv_block_size=4),
                device=dev)
            reset_launch_counts()
            outs[dev] = eng.serve(prompts, gens)
            check_graphs(eng, f"smoke serve on {dev}")
            if dev == "cuda":  # float32 compute: every prefill runs the tf32 kernel
                f32_launches = launch_counts().get("flash_star", 0)
                check(launch_counts().get("paged_attention", 0) == cfg.num_layers * eng.ticks,
                      f"smoke serve: paged_attention launched "
                      f"{launch_counts().get('paged_attention', 0)} times for {eng.ticks} "
                      f"ticks of {cfg.num_layers} layers")
    check(outs["cuda"] == outs["cpu"],
          f"smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    check(cfg.compute_dtype == "float32" and f32_launches > 0,
          f"smoke card run: flash_star launched {f32_launches} times in "
          f"{cfg.compute_dtype} compute")
    log(f"small reference: greedy smoke tokens identical on card and cpu "
        f"({sum(gens)} tokens, 5 requests); the float32 flash_star kernel "
        f"(flash_star_tf32_kernel, D {cfg.resolved_head_dim}) launched {f32_launches} times on the card")

    # quantized pools, prefix cache, chunked prefill and preemption: prompts
    # share a 9-token prefix; 7 blocks of 4 rows cannot hold both slots
    rng = np.random.default_rng(SEED)
    pre = rng.integers(0, cfg.vocab_size, (9,))
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (n,))])
               for n in (3, 7, 2, 11, 5)]
    gens = [6, 4, 7, 5, 3]
    for kv_dtype in ("int8", "fp8_e4m3"):
        cb = ContinuousConfig(num_slots=2, max_len=40, kv_layout="paged", kv_block_size=4,
                              kv_pool_blocks=7, kv_dtype=kv_dtype, prefix_cache=True,
                              prefill_chunk_tokens=8)
        outs, stats = {}, {}
        with ops.use(softmax="pallas"):
            for dev, params in devices:
                eng = ContinuousBatchingEngine(cfg, params, cb, device=dev)
                outs[dev] = eng.serve(prompts, gens)
                check_graphs(eng, f"smoke serve {kv_dtype} on {dev}")
                stats[dev] = (eng.preemptions, eng.kv_stats()["prefix"]["hits"])
        check(outs["cuda"] == outs["cpu"],
              f"{kv_dtype} smoke greedy tokens differ card vs cpu: "
              f"{outs['cuda']} vs {outs['cpu']}")
        check(stats["cuda"] == stats["cpu"], f"{kv_dtype}: (preemptions, prefix hits) "
              f"differ card vs cpu: {stats}")
        preempted, hits = stats["cuda"]
        check(preempted >= 1 and hits >= 1,
              f"{kv_dtype}: expected a preemption and a prefix hit, got {stats['cuda']}")
        log(f"small reference {kv_dtype}: greedy tokens identical on card and cpu "
            f"({sum(gens)} tokens, prefix cache + 8-token chunks, {preempted} "
            f"preemptions, {hits} prefix hits)")

    # the mild fault in histogram mode: every attention row faulty (attention
    # xla -> the materialized reference path), the realization made on each
    # device; greedy decoding takes the argmax, so no sampling kernel runs
    base = get_smoke_config("granite_8b")
    fcfg = dataclasses.replace(base, softmax=dataclasses.replace(
        base.softmax_spec, fault=FaultModel(**MILD), mode="histogram"))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    outs = {}
    for dev, params in devices:
        eng = ContinuousBatchingEngine(
            fcfg, params, ContinuousConfig(num_slots=2, max_len=40, kv_layout="paged",
                                           kv_block_size=4), device=dev)
        outs[dev] = eng.serve(prompts, gens)
        check_graphs(eng, f"smoke serve mild fault on {dev}")
    check(outs["cuda"] == outs["cpu"],
          f"mild-fault smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    log(f"small reference mild fault (histogram, faulty attention): greedy tokens identical on "
        f"card and cpu ({sum(gens)} tokens)")

    # temperature 0.8 on the card: the mode's sampling kernel launches for
    # every sampled batch (an admission or a tick)
    for mode, kernel, other in (("onehot", "star_softmax", "star_softmax_lut"),
                                ("histogram", "star_softmax_lut", "star_softmax")):
        mcfg = dataclasses.replace(cfg, softmax_mode=mode)
        with ops.use(softmax="pallas"):
            eng = ContinuousBatchingEngine(
                mcfg, params_gpu, ContinuousConfig(num_slots=2, max_len=40, kv_layout="paged",
                                                   kv_block_size=4, temperature=0.8),
                device="cuda", seed=SEED)
            reset_launch_counts()
            out = eng.serve(prompts, gens)
            counts = launch_counts()
            check_graphs(eng, f"smoke serve T=0.8 {mode}")
            tokens = torch.as_tensor(prompts[0], device="cuda")[None]
            logits, _ = build_model(mcfg).prefill(params_gpu, tokens, 40)
            scaled = logits[0, -1].float() / 0.8
            probs = ops.softmax(scaled, mcfg.softmax_spec)
        batches = len(prompts) + eng.ticks
        check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for o in out for t in o),
              f"smoke T=0.8 {mode}: bad output {out}")
        check(counts.get(kernel, 0) == batches and counts.get(other, 0) == 0,
              f"smoke T=0.8 {mode}: {kernel} launched {counts.get(kernel, 0)} times for "
              f"{batches} sampled batches ({other}: {counts.get(other, 0)})")
        plain = sk.star_softmax_ref(scaled.cpu(), mcfg.softmax_spec.fmt, mode=mode)
        err = float((probs.cpu() - plain).abs().max())
        check(bool(torch.allclose(probs.cpu(), plain, rtol=1e-5, atol=1e-9)),
              f"smoke T=0.8 {mode}: first sample's probabilities differ from the cpu plain "
              f"version (max err {err:.3e})")
        log(f"small reference T=0.8 {mode}: {kernel} launched {counts[kernel]} times for "
            f"{batches} sampled batches; first sample's probabilities vs cpu plain version "
            f"max_abs_err={err:.3e}")
    return f32_launches


def small_reference_dense():
    """Phase 4, the dense layout and rings: greedy smoke tokens on the card
    (kernels) equal the CPU's (plain versions) for the dense continuous
    engine, monolithic (flash_star once per layer of every prefill and of
    every tick, counted through the replays) and with 8-token chunks, the
    lockstep engine on granite, and the ``sliding_window=16`` ring on the
    dense and the paged layout and on the lockstep engine.  Returns the
    dense engine's flash_star launches on the card."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import (
        ContinuousBatchingEngine,
        ContinuousConfig,
        ServeConfig,
        ServeEngine,
    )

    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    ring = dataclasses.replace(cfg, sliding_window=16)
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    ring_prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (6, 23, 13, 30)]
    ring_gens = [14, 9, 12, 5]
    lock_prompts = rng.integers(0, cfg.vocab_size, (3, 9))
    ring_lock = rng.integers(0, cfg.vocab_size, (2, 23))
    continuous = {
        "dense": (cfg, dict(kv_layout="dense"), prompts, gens),
        "dense, 8-token chunks": (cfg, dict(kv_layout="dense", prefill_chunk_tokens=8),
                                  prompts, gens),
        "dense ring": (ring, dict(kv_layout="dense"), ring_prompts, ring_gens),
        "paged ring": (ring, dict(kv_layout="paged", kv_block_size=4), ring_prompts, ring_gens),
    }
    dense_launches = None
    with ops.use(softmax="pallas"):
        for label, (c, kw, ps, gs) in continuous.items():
            outs = {}
            for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
                eng = ContinuousBatchingEngine(c, params, ContinuousConfig(
                    num_slots=2, max_len=40, **kw), device=dev)
                reset_launch_counts()
                outs[dev] = eng.serve(ps, gs)
                check_graphs(eng, f"smoke serve {label} on {dev}")
                if dev == "cuda" and label == "dense":
                    dense_launches = launch_counts().get("flash_star", 0)
                    want = c.num_layers * (len(ps) + eng.ticks)
                    check(dense_launches == want and not launch_counts().get("paged_attention"),
                          f"smoke serve dense: flash_star launched {dense_launches} times, "
                          f"expected {want} (one per layer of {len(ps)} prefills and "
                          f"{eng.ticks} ticks), paged_attention "
                          f"{launch_counts().get('paged_attention', 0)}")
            check(outs["cuda"] == outs["cpu"],
                  f"smoke {label} greedy tokens differ card vs cpu: {outs['cuda']} vs "
                  f"{outs['cpu']}")
            log(f"small reference {label}: greedy tokens identical on card and cpu "
                f"({sum(gs)} tokens, {len(ps)} requests)")
        for label, c, ps, n in (("lockstep", cfg, lock_prompts, 12),
                                ("lockstep ring", ring, ring_lock, 9)):
            outs = {}
            for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
                eng = ServeEngine(c, params, ServeConfig(max_len=40), device=dev)
                reset_launch_counts()
                outs[dev], info = eng.generate(ps, n)
                if dev == "cuda":
                    got = launch_counts().get("flash_star", 0)
                    check(got == c.num_layers * n and eng.graphs.replays == n - 1,
                          f"smoke {label}: flash_star launched {got} times, expected "
                          f"{c.num_layers * n} (prefill and {n - 1} replays)")
            check(bool((outs["cuda"].cpu() == outs["cpu"]).all()),
                  f"smoke {label} greedy tokens differ card vs cpu: {outs['cuda'].tolist()} vs "
                  f"{outs['cpu'].tolist()}")
            log(f"small reference {label}: greedy tokens identical on card and cpu "
                f"({tuple(outs['cpu'].shape)}, cache_len {info['cache_len']})")
    log(f"small reference dense: flash_star (float32 kernel, D {cfg.resolved_head_dim}) "
        f"launched {dense_launches} times on the card")
    return dense_launches


def small_reference_moe():
    """Phase 4, the MoE family: greedy smoke tokens on the card (kernels)
    equal the CPU's (plain versions) for granite-moe-1b-a400m on the dense,
    paged and chunked (paged, 8-token chunks, ``prefix_cache=True``: MoE
    opts out) continuous paths and the lockstep engine, and for mixtral's
    smoke config (a window of 16 under ``max_len`` 40: every path a ring)
    on the same paths.  On the card the router's STAR softmax kernel
    launches once per layer of every prefill or chunk and of every tick
    (counted through the replays)."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import (
        ContinuousBatchingEngine,
        ContinuousConfig,
        ServeConfig,
        ServeEngine,
    )

    paths = {"dense": dict(kv_layout="dense"),
             "paged": dict(kv_layout="paged", kv_block_size=4),
             "chunked": dict(kv_layout="paged", kv_block_size=4, prefill_chunk_tokens=8,
                             prefix_cache=True)}
    plans = (("granite_moe_1b_a400m", (5, 11, 8, 3, 19), [4, 2, 5, 3, 6]),
             ("mixtral_8x22b", (20, 11, 18, 3), [14, 9, 12, 5]))
    for arch, lens, gens in plans:
        cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="pallas")
        nl = cfg.num_layers
        params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
        params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
        rng = np.random.default_rng(SEED + 4)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
        lock = rng.integers(0, cfg.vocab_size, (3, 9))
        with ops.use(softmax="pallas"):
            for label, kw in paths.items():
                outs = {}
                for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
                    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
                        num_slots=2, max_len=40, **kw), device=dev)
                    reset_launch_counts()
                    outs[dev] = eng.serve(prompts, gens)
                    check_graphs(eng, f"smoke {arch} {label} on {dev}")
                    check(eng.prefix is None, f"smoke {arch} {label}: a MoE arch kept a "
                          f"prefix cache")
                    if dev == "cuda":
                        calls = int(eng.metrics.counter("serve.prefill.calls").value())
                        got = launch_counts().get("star_softmax", 0)
                        check(got == nl * (calls + eng.ticks),
                              f"smoke {arch} {label}: star_softmax launched {got} times, "
                              f"expected {nl * (calls + eng.ticks)} (one per layer of {calls} "
                              f"prefills or chunks and {eng.ticks} ticks)")
                check(outs["cuda"] == outs["cpu"],
                      f"smoke {arch} {label} greedy tokens differ card vs cpu: {outs['cuda']} "
                      f"vs {outs['cpu']}")
                log(f"small reference {arch} {label}{' (rings)' if eng._ring else ''}: greedy "
                    f"tokens identical on card and cpu ({sum(gens)} tokens, {len(prompts)} "
                    f"requests)")
            outs = {}
            for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
                eng = ServeEngine(cfg, params, ServeConfig(max_len=40), device=dev)
                reset_launch_counts()
                outs[dev], info = eng.generate(lock, 12)
                if dev == "cuda":
                    got = launch_counts().get("star_softmax", 0)
                    check(got == nl * 12 and eng.graphs.replays == 11,
                          f"smoke {arch} lockstep: star_softmax launched {got} times, expected "
                          f"{nl * 12} (the prefill and 11 replays)")
            check(bool((outs["cuda"].cpu() == outs["cpu"]).all()),
                  f"smoke {arch} lockstep greedy tokens differ card vs cpu")
            log(f"small reference {arch} lockstep: greedy tokens identical on card and cpu "
                f"({tuple(outs['cpu'].shape)}, cache_len {info['cache_len']})")


def cut_at_eos(tokens, eos_id):
    """``tokens`` up to and including the first ``eos_id``."""
    return tokens[:tokens.index(eos_id) + 1] if eos_id in tokens else tokens


def small_reference_eos():
    """Phase 4, requests that stop at their EOS token: granite-8b's smoke
    config on the paged continuous engine, greedy.  The EOS token is the
    first token of the no-EOS run that a request samples for the first time
    after its first token and before its last; with it every request stops at its first
    occurrence (one at least early), and the tokens on the card equal the
    CPU's and the no-EOS tokens cut there.  Returns the card's counts."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg, devices = _smoke_pair("granite_8b")
    rng = np.random.default_rng(SEED + 30)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [8, 6, 9, 7, 5]
    cb = ContinuousConfig(num_slots=2, max_len=40, kv_layout="paged", kv_block_size=4)
    full, outs, engines, counts = {}, {}, {}, None
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            full[dev] = ContinuousBatchingEngine(cfg, params, cb, device=dev).serve(
                prompts, gens)
        check(full["cuda"] == full["cpu"], f"smoke eos: the no-EOS tokens differ card vs "
              f"cpu: {full['cuda']} vs {full['cpu']}")
        eos = next((t for o in full["cpu"] for i, t in enumerate(o[:-1])
                    if i >= 1 and t not in o[:i]), None)
        check(eos is not None, f"smoke eos: no token to stop a request early in {full['cpu']}")
        for dev, params in devices:
            eng = engines[dev] = ContinuousBatchingEngine(cfg, params, cb, device=dev)
            reset_launch_counts()
            outs[dev] = eng.serve(prompts, gens, eos_id=eos)
            check_graphs(eng, f"smoke eos serve on {dev}")
            if dev == "cuda":
                counts = launch_counts()
    want = [cut_at_eos(o, eos) for o in full["cpu"]]
    check(outs["cuda"] == outs["cpu"] == want,
          f"smoke eos {eos}: tokens card {outs['cuda']}, cpu {outs['cpu']}, the no-EOS tokens "
          f"cut at it {want}")
    stopped = sum(len(o) < g for o, g in zip(want, gens))
    check(stopped >= 1, f"smoke eos {eos}: no request stopped early")
    eng = engines["cuda"]
    check(counts.get("paged_attention", 0) == cfg.num_layers * eng.ticks,
          f"smoke eos: paged_attention launched {counts.get('paged_attention', 0)} times for "
          f"{eng.ticks} ticks of {cfg.num_layers} layers")
    log(f"small reference eos: eos_id {eos} stops {stopped} of {len(prompts)} requests early; "
        f"greedy tokens identical on card and cpu and equal to the no-EOS tokens cut at it "
        f"({sum(map(len, want))} of {sum(gens)} tokens, {eng.ticks} ticks against "
        f"{engines['cpu'].ticks} on the cpu); launches {counts}")
    return counts


def _smoke_pair(arch):
    """A smoke config on the kernels' route (``attn_impl="pallas"``) with
    weights drawn on the CPU from the seed and copied to the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="pallas")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    return cfg, (("cuda", tree_map(lambda x: x.cuda(), params_cpu)), ("cpu", params_cpu))


def _smoke_card_vs_cpu(label, cfg, devices, kw, requests, waves=1):
    """``requests`` (prompt, new tokens, frontend kwargs) through the
    continuous engine on the card and on the CPU (``waves``: submitted in
    that many groups, each drained before the next), greedy: the tokens must
    be equal.  On the card the launches are counted and checked: flash_star
    once per layer of every prefill or chunk (and of every dense tick), the
    paged kernel (fp or quantized) once per layer of every paged tick.
    Returns the card's counts and engine."""
    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    outs, engines, counts = {}, {}, None
    per = -(-len(requests) // waves)
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
                num_slots=2, max_len=48, **kw), device=dev)
            reset_launch_counts()
            out = []
            for i in range(0, len(requests), per):
                uids = [eng.submit(p, g, **fe) for p, g, fe in requests[i:i + per]]
                done = eng.run()
                out += [done[u] for u in uids]
            outs[dev], engines[dev] = out, eng
            check_graphs(eng, f"smoke {label} on {dev}")
            if dev == "cuda":
                counts = launch_counts()
    eng = engines["cuda"]
    check(outs["cuda"] == outs["cpu"],
          f"smoke {label} greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    nl = cfg.num_layers
    calls = int(eng.metrics.counter("serve.prefill.calls").value())
    paged = eng.kv_layout == "paged"
    quant = kw.get("kv_dtype", "fp32") != "fp32"
    want = {"flash_star": nl * (calls + (0 if paged else eng.ticks)),
            "paged_attention": nl * eng.ticks if paged and not quant else 0,
            "paged_attention_quant": nl * eng.ticks if quant else 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n,
              f"smoke {label}: {name} launched {counts.get(name, 0)} times, expected {n} "
              f"({calls} prefills or chunks, {eng.ticks} ticks of {nl} layers)")
    log(f"small reference {label}: greedy tokens identical on card and cpu "
        f"({sum(len(o) for o in outs['cpu'])} tokens, {len(requests)} requests); launches "
        f"{counts}")
    return counts, eng, engines["cpu"]


def _smoke_lockstep(label, cfg, devices, prompts, n, flash=None, **frontend):
    """A greedy lockstep ``generate`` on the card and the CPU: equal tokens,
    flash_star ``flash`` = (launches a prefill, a step) times: once per
    layer of the prefill and of each replay unless given."""
    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    per_prefill, per_step = flash or (cfg.num_layers, cfg.num_layers)
    want = per_prefill + per_step * (n - 1)
    outs = {}
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            eng = ServeEngine(cfg, params, ServeConfig(max_len=48), device=dev)
            reset_launch_counts()
            outs[dev], info = eng.generate(prompts, n, **frontend)
            if dev == "cuda":
                counts = launch_counts()
                check(counts.get("flash_star", 0) == want and eng.graphs.replays == n - 1,
                      f"smoke {label}: flash_star launched {counts.get('flash_star', 0)} times, "
                      f"expected {want} (the prefill and {n - 1} replays)")
    check(bool((outs["cuda"].cpu() == outs["cpu"]).all()),
          f"smoke {label} greedy tokens differ card vs cpu")
    log(f"small reference {label}: greedy tokens identical on card and cpu "
        f"({tuple(outs['cpu'].shape)}, cache_len {info['cache_len']})")
    return counts


def small_reference_vlm():
    """Phase 4, the VLM family: qwen2-vl-7b's smoke config (M-RoPE, 16 stub
    patches of 32, D 16) greedy on the card (kernels) and on the CPU (plain
    versions) with the same weights, each request with its own patch
    embeddings: the dense, paged, chunked + prefix (paged, 8-token chunks;
    text-only requests with a common prefix beside the VLM ones, in two
    waves: the text-only ones share, the VLM ones never look up) and int8
    paged continuous paths, and the lockstep engine; card == CPU tokens and
    trie counters.  Returns the card's launch counts by path."""
    import numpy as np

    cfg, devices = _smoke_pair(VLM_ARCH)
    rng = np.random.default_rng(SEED + 5)

    def patches():
        return {"patch_embeds": rng.standard_normal(
            (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}

    vlm = [(rng.integers(0, cfg.vocab_size, (n,)), g, patches())
           for n, g in ((5, 4), (11, 2), (8, 5), (3, 3))]
    pre = rng.integers(0, cfg.vocab_size, (12,))
    text = [(np.concatenate([pre, rng.integers(0, cfg.vocab_size, (n,))]), g, {})
            for n, g in ((3, 4), (5, 3), (2, 5))]
    paths = {
        "qwen2-vl dense": (dict(kv_layout="dense"), vlm, 1),
        "qwen2-vl paged": (dict(kv_layout="paged", kv_block_size=4), vlm, 1),
        "qwen2-vl int8 paged": (dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8"),
                                vlm, 1),
        "qwen2-vl chunked + prefix": (dict(kv_layout="paged", kv_block_size=4,
                                           prefill_chunk_tokens=8, prefix_cache=True),
                                      [text[0], vlm[0], text[1], vlm[1], text[2]], 2),
    }
    by_path = {}
    for label, (kw, reqs, waves) in paths.items():
        by_path[label], eng, cpu = _smoke_card_vs_cpu(label, cfg, devices, kw, reqs, waves)
        if kw.get("prefix_cache"):
            st, st_cpu = eng.kv_stats()["prefix"], cpu.kv_stats()["prefix"]
            check(st == st_cpu and st["hits"] >= 1,
                  f"smoke {label}: trie counters {st} (cpu {st_cpu}); the text-only requests "
                  f"must share")
    lock = rng.integers(0, cfg.vocab_size, (2, 9))
    pe = rng.standard_normal((2, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    by_path["qwen2-vl lockstep"] = _smoke_lockstep("qwen2-vl lockstep", cfg, devices, lock, 12,
                                                   patch_embeds=pe)
    return by_path


def small_reference_archs():
    """Phase 4, the last three dense archs at their smoke configs: qwen2-72b
    (D 16, G 2), deepseek-coder-33b (D 8, G 7) and llama3-405b (D 8, G 4)
    greedy on the dense and paged continuous paths and the lockstep engine,
    and the two D-8 configs over an int8 paged pool (rows of 8 one-byte
    codes); card == CPU tokens.  Returns the card's launch counts by path."""
    import numpy as np

    by_path = {}
    for arch in ("qwen2_72b", "deepseek_coder_33b", "llama3_405b"):
        cfg, devices = _smoke_pair(arch)
        rng = np.random.default_rng(SEED + 6)
        reqs = [(rng.integers(0, cfg.vocab_size, (n,)), g, {})
                for n, g in ((5, 4), (11, 2), (8, 5), (3, 3), (19, 6))]
        paths = {"dense": dict(kv_layout="dense"),
                 "paged": dict(kv_layout="paged", kv_block_size=4)}
        if cfg.resolved_head_dim == 8:
            paths["int8 paged"] = dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8")
        for label, kw in paths.items():
            by_path[f"{arch} {label}"] = _smoke_card_vs_cpu(
                f"{arch} {label} (D {cfg.resolved_head_dim})", cfg, devices, kw, reqs)[0]
        by_path[f"{arch} lockstep"] = _smoke_lockstep(
            f"{arch} lockstep", cfg, devices, rng.integers(0, cfg.vocab_size, (3, 9)), 12)
    return by_path


def small_reference_hybrid_encdec():
    """Phase 4, the hybrid and enc-dec families on the lockstep engine (the
    only engine either runs on): recurrentgemma-2b's smoke config (window
    16, prompts of 20: the ring wraps; one attention block, so flash_star
    once a prefill and once a step) and seamless-m4t-large-v2's (2 + 2
    layers, [2, 64, 32] stub frames: flash_star 6 times a prefill, 2
    encoder, 2 self and 2 cross, and 4 times a step) greedy on the card and
    the CPU, equal tokens.  Returns the card's launch counts by path."""
    import numpy as np

    by_path = {}
    rng = np.random.default_rng(SEED + 8)
    cfg, devices = _smoke_pair(HYBRID_ARCH)
    attn = sum(k == "attention" for k in cfg.block_pattern)
    by_path["recurrentgemma lockstep"] = _smoke_lockstep(
        "recurrentgemma lockstep (ring of 16)", cfg, devices,
        rng.integers(0, cfg.vocab_size, (3, 20)), 12, flash=(attn, attn))
    cfg, devices = _smoke_pair(ENCDEC_ARCH)
    src = rng.standard_normal((2, 64, cfg.frontend_dim)).astype(np.float32)
    nd = cfg.num_decoder_layers
    by_path["seamless lockstep"] = _smoke_lockstep(
        "seamless lockstep (64 stub frames)", cfg, devices,
        rng.integers(0, cfg.vocab_size, (2, 9)), 12, flash=(cfg.num_layers + 2 * nd, 2 * nd),
        src_embeds=src)
    return by_path


# ---------------------------------------------------------------------------
# phase 5: serve granite-8b at full width and depth


def serve_requests(eng, prompts, gens, frontends=None, eos_id=None):
    """``eng.serve(prompts, gens, eos_id=eos_id)``, keeping each request:
    returns the outputs and the exact TTFT p50 over the requests (nearest
    rank; the ``serve.ttft_s`` histogram's p50 follows the reference's
    bucket rule, 5 buckets a decade, and reads a bucket edge).
    ``frontends``: per request the keyword arguments of its frontend (a
    VLM's ``patch_embeds``)."""
    import math

    uids, reqs = [], []
    for i, (prompt, gen) in enumerate(zip(prompts, gens)):
        uids.append(eng.submit(prompt, int(gen), eos_id=eos_id,
                               **(frontends[i] if frontends else {})))
        reqs.append(eng.scheduler.pending[-1])
    done = eng.run()
    ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
    return [done[u] for u in uids], ttfts[math.ceil(len(ttfts) / 2) - 1]


def check_graphs(eng, label) -> None:
    """A continuous engine's ticks ran by replay: one capture for its one
    route, one replay per tick."""
    check(eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks,
          f"{label}: {eng.graph_entries()} graphs captured, {eng.graphs.replays} replays for "
          f"{eng.ticks} ticks (expected 1 and one a tick)")


def host_spans(tracer, wall_s):
    """Where a serve's host time goes, from its Chrome trace: the share of
    the serve's wall time inside ``serve.prefill`` / ``serve.prefill_chunk``
    spans, inside ``serve.decode`` spans and outside both; and per steady
    tick (an engine step that ran no prefill) its wall time (between the
    ``serve.sched`` samples that close each step) and the ``serve.decode``
    span's share of it."""
    evs = tracer.events
    prefill = sum(e.dur for e in evs if e.ph == "X" and e.name.startswith("serve.prefill"))
    begins = [e.ts for e in evs if e.name == "serve.decode" and e.ph == "B"]
    ends = [e.ts for e in evs if e.name == "serve.decode" and e.ph == "E"]
    decode = sum(b - a for a, b in zip(begins, ends))
    sched = [e.ts for e in evs if e.name == "serve.sched"]
    steady, spans = [], []
    for t0, t1 in zip(sched, sched[1:]):
        inside = [e for e in evs if t0 < e.ts < t1]
        if any(e.name.startswith("serve.prefill") for e in inside):
            continue
        b = [e.ts for e in inside if e.name == "serve.decode" and e.ph == "B"]
        en = [e.ts for e in inside if e.name == "serve.decode" and e.ph == "E"]
        if b and en:
            steady.append(t1 - t0)
            spans.append(en[0] - b[0])
    total = wall_s * 1e6
    out = {"prefill_share": prefill / total, "decode_share": decode / total,
           "outside_share": 1 - (prefill + decode) / total, "steady_ticks": len(steady),
           "steady_tick_ms": statistics.median(steady) / 1e3 if steady else None,
           "decode_span_ms": statistics.median(spans) / 1e3 if spans else None,
           "events": len(evs), "dropped": tracer.dropped}
    if steady:
        out["decode_span_share_of_tick"] = statistics.median(
            [d / t for d, t in zip(spans, steady)])
    return out


def serve_plan(vocab):
    """The phase 5 traffic: 8 requests, prompts of 128-512 tokens, 16-32 new
    tokens each."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, (int(n),)) for n in rng.integers(128, 513, 8)]
    return prompts, [int(g) for g in rng.integers(16, 33, 8)]


def serve(results):
    import numpy as np
    import torch

    from repro_torch import obs, ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import compute_params, count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    torch.cuda.synchronize()
    log(f"serve: granite-8b {cfg.num_layers}L d={cfg.d_model} {count_params(model.param_specs()) / 1e9:.2f}B "
        f"params ({cfg.param_dtype}, compute {cfg.compute_dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    # the engines' tree: weights cast to bf16 once, shared by every engine
    # below; the float32 tree stays for ops.matmul(impl="hwmodel") (phase 7)
    t0 = time.perf_counter()
    cparams = compute_params(params, cfg)
    torch.cuda.synchronize()
    log(f"serve: weights cast to {cfg.compute_dtype} once in {time.perf_counter() - t0:.2f}s, "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts, gens = serve_plan(cfg.vocab_size)
    cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, kv_layout="paged",
                          kv_block_size=16)
    tracer = obs.enable_tracing()  # before the engine: it binds the tracer when built
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg, cparams, cb, device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, ttft_p50 = serve_requests(eng, prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    obs.disable_tracing()
    toks = [t for seq in out for t in seq]
    check([len(s) for s in out] == gens, f"serve: generated lengths {[len(s) for s in out]} != {gens}")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve: a token outside the vocabulary")
    check_graphs(eng, "serve")
    ttft = eng.metrics.histogram("serve.ttft_s")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
        f"{len(toks)} tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s "
        f"({len(toks) / (wall - eng.graphs.capture_seconds):.2f} tok/s without the warm-up "
        f"and capture, {eng.graphs.capture_seconds:.3f}s of the serve's wall), "
        f"{eng.ticks} decode ticks by graph replay ({eng.graph_entries()} capture), "
        f"ttft p50={1e3 * ttft_p50:.1f}ms (histogram p50 {1e3 * ttft.percentile(50):.1f}ms), "
        f"max_memory_allocated={peak / 2**30:.2f} GiB")
    log(f"serve: launches {counts}; the capture's warm-up (not counted) "
        f"{eng.graphs.warmup_launches()}")
    need = {"flash_star": cfg.num_layers * len(prompts), "star_softmax": eng.ticks}
    for name, least in need.items():
        check(counts.get(name, 0) >= least,
              f"serve: {name} launched {counts.get(name, 0)} times, expected >= {least}")
    check(counts.get("paged_attention", 0) == cfg.num_layers * eng.ticks,
          f"serve: paged_attention launched {counts.get('paged_attention', 0)} times, not "
          f"once per layer of each of {eng.ticks} ticks")
    check(counts.get("star_softmax", 0) == len(prompts) + eng.ticks,
          f"serve: star_softmax launched {counts.get('star_softmax', 0)} times for "
          f"{len(prompts)} admissions and {eng.ticks} ticks")
    for entry in results:
        entry["launches"] = counts.get(entry["name"], 0)
        entry["launches_by_path"] = {"serve_fp": entry["launches"]}
    NO_EOS["paged"] = {"outputs": out, "ticks": eng.ticks, "graphs": eng.graph_entries()}
    trace_path = ROOT / "build" / "serve_fp_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    tracer.export_chrome(str(trace_path))
    spans = host_spans(tracer, wall)
    log(f"serve: Chrome trace {trace_path.relative_to(ROOT)} ({spans['events']} events, "
        f"{spans['dropped']} dropped); host time: {spans}")
    moved = {n: eng.metrics.counter(n).value()
             for n in ("serve.bytes.h2d", "serve.bytes.d2h", "kv.gather.bytes",
                       "serve.tables.rows_flushed")}
    log(f"serve: transfers {moved}")

    # one full-width prefill through the kernels vs the plain reference impls
    tokens = torch.as_tensor(prompts[0][:128], device="cuda")[None]
    with torch.no_grad():
        got, _ = model.prefill(cparams, tokens, 128)
        with ops.use(attention="reference"):
            ref, _ = model.prefill(cparams, tokens, 128)
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "full-width prefill: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"full-width prefill logits, kernels vs reference impls: rel_l2={rel:.3e} "
        f"max_abs={float((got - ref).abs().max()):.3e}")
    check(rel < 3e-2, f"full-width prefill logits differ from the reference: rel_l2={rel:.3e}")
    longest = torch.as_tensor(max(prompts, key=len), device="cuda")[None]
    with torch.no_grad():
        prefill_prof = profile_window(f"one full-width prefill, {longest.shape[1]} tokens",
                                      lambda: model.prefill(cparams, longest, 512))
    tick = profile_tick(cfg, cparams)
    pv_int8 = prefill_pv_int8(results, cfg, cparams, max(prompts, key=len)[:512])
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "ticks": eng.ticks, "ttft_p50_s": ttft_p50,
            "ttft_p50_histogram_s": ttft.percentile(50),
            "max_memory_allocated": peak, "capture_s": eng.graphs.capture_seconds,
            "tok_per_s_without_capture": len(toks) / (wall - eng.graphs.capture_seconds),
            "host_spans": spans, "transfers": moved,
            "tick": tick, "prefill_profile": prefill_prof,
            "prefill_pv_int8": pv_int8}, params, cparams


def serve_dense(results, cparams):
    """Phase 5b: full-width granite-8b on the dense per-slot pool, the phase
    5 traffic and weights (cast once).  Counters zeroed just before and read
    just after: flash_star once per layer of every prefill and of every tick
    (counted through the replays), the STAR softmax once per admission and
    per tick, the paged kernel never.  Then one steady dense tick traced
    (``profile_tick``: its replay bit-equal to the eager tick from a copy of
    its state, 16 bytes up and down), and a lockstep ``generate`` of 4 x
    512-token prompts and 32 tokens (flash_star once per layer of the
    prefill and of each of its 31 replays)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import (
        ContinuousBatchingEngine,
        ContinuousConfig,
        ServeConfig,
        ServeEngine,
    )

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    prompts, gens = serve_plan(cfg.vocab_size)
    cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, kv_layout="dense")
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg, cparams, cb, device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, ttft_p50 = serve_requests(eng, prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for seq in out for t in seq]
    check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for t in toks),
          f"dense serve: bad output lengths {[len(o) for o in out]} or a token outside the "
          f"vocabulary")
    check_graphs(eng, "dense serve")
    peak = torch.cuda.max_memory_allocated()
    capture = eng.graphs.capture_seconds
    want = {"flash_star": cfg.num_layers * (len(prompts) + eng.ticks),
            "star_softmax": len(prompts) + eng.ticks, "paged_attention": 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n,
              f"dense serve: {name} launched {counts.get(name, 0)} times, expected {n} "
              f"({len(prompts)} prefills, {eng.ticks} ticks of {cfg.num_layers} layers)")
    st = eng.kv_stats()
    log(f"dense serve: {len(prompts)} requests, {len(toks)} tokens in {wall:.3f}s = "
        f"{len(toks) / wall:.2f} tok/s ({len(toks) / (wall - capture):.2f} tok/s without the "
        f"warm-up and capture, {capture:.3f}s), {eng.ticks} decode ticks by graph replay "
        f"({eng.graph_entries()} capture), ttft p50={1e3 * ttft_p50:.1f}ms, "
        f"max_memory_allocated={peak / 2**30:.2f} GiB, kv pinned "
        f"{st['kv_bytes_in_use'] / 2**30:.3f} GiB; launches {counts} (warm-up, not counted: "
        f"{eng.graphs.warmup_launches()})")
    for entry in results:
        entry["launches_by_path"]["serve_dense"] = counts.get(entry["name"], 0)
    NO_EOS["dense"] = {"outputs": out, "ticks": eng.ticks, "graphs": eng.graph_entries()}
    tick = profile_tick(cfg, cparams, kv_layout="dense")
    check(tick["logits_bit_equal"], "dense tick: the replay is not bit-equal to the eager tick")

    lock_prompts = np.random.default_rng(SEED + 10).integers(0, cfg.vocab_size, (4, 512))
    n = 32
    with ops.use(softmax="pallas"):
        lock = ServeEngine(cfg, cparams, ServeConfig(max_len=512 + 32, temperature=0.8),
                           device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, info = lock.generate(lock_prompts, n)
        torch.cuda.synchronize()
        lwall = time.perf_counter() - t0
        lcounts = launch_counts()
    lcap = lock.graphs.capture_seconds
    check(tuple(got.shape) == (4, n) and bool(((got >= 0) & (got < cfg.vocab_size)).all()),
          f"lockstep granite: bad output {tuple(got.shape)}")
    check(lcounts.get("flash_star", 0) == cfg.num_layers * n and lock.graphs.replays == n - 1,
          f"lockstep granite: flash_star launched {lcounts.get('flash_star', 0)} times, "
          f"expected {cfg.num_layers * n}; {lock.graphs.replays} replays")
    check(lcounts.get("star_softmax", 0) == n, f"lockstep granite: star_softmax launched "
          f"{lcounts.get('star_softmax', 0)} times for {n} sampled steps")
    lpeak = torch.cuda.max_memory_allocated()
    log(f"lockstep granite: 4 x {lock_prompts.shape[1]}-token prompts, {4 * n} tokens in "
        f"{lwall:.3f}s = {4 * n / lwall:.2f} tok/s ({4 * n / (lwall - lcap):.2f} tok/s without "
        f"the warm-up and capture, {lcap:.3f}s), cache_len {info['cache_len']}, "
        f"max_memory_allocated={lpeak / 2**30:.2f} GiB; launches {lcounts}")
    for entry in results:
        entry["launches_by_path"]["lockstep_granite"] = lcounts.get(entry["name"], 0)
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "capture_s": capture, "tok_per_s_without_capture": len(toks) / (wall - capture),
            "ticks": eng.ticks, "ttft_p50_s": ttft_p50, "max_memory_allocated": peak,
            "kv_bytes_pinned": st["kv_bytes_in_use"], "launches": counts, "tick": tick,
            "lockstep": {"tokens": 4 * n, "wall_s": lwall, "tok_per_s": 4 * n / lwall,
                         "capture_s": lcap, "tok_per_s_without_capture": 4 * n / (lwall - lcap),
                         "max_memory_allocated": lpeak, "launches": lcounts}}


def serve_eos(results, cparams):
    """Phase 5c: phase 5's and 5b's serves again, each request stopping at
    an EOS token: the token at index 4 of request 0's no-EOS output.  The
    oracle: every output equals its no-EOS output cut after the first
    ``eos_id``, bit for bit, though a stopped request's slot is refilled
    earlier and later requests meet other co-tenants at other ticks (a
    request's tokens depend on neither: its prefill runs alone, the tick's
    shapes are fixed and it samples from its own generator).  The graphs
    captured are those of the no-EOS run.  Counters zeroed just before and
    read just after: flash_star once per layer of every prefill (and of
    every dense tick), the paged kernel once per layer of every paged tick,
    the STAR softmax once per admission and per tick."""
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    prompts, gens = serve_plan(cfg.vocab_size)
    nl, summary = cfg.num_layers, {}
    for layout, kw in (("paged", dict(kv_layout="paged", kv_block_size=16)),
                       ("dense", dict(kv_layout="dense"))):
        base = NO_EOS[layout]
        full = base["outputs"]
        eos = full[0][4]
        cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, **kw)
        with ops.use(softmax="pallas"):
            eng = ContinuousBatchingEngine(cfg, cparams, cb, device="cuda", seed=SEED)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out, ttft_p50 = serve_requests(eng, prompts, gens, eos_id=eos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        want = [cut_at_eos(o, eos) for o in full]
        differ = [i for i, (o, w) in enumerate(zip(out, want)) if o != w]
        for i in differ:
            at = next((j for j, (a, b) in enumerate(zip(out[i], want[i])) if a != b),
                      min(len(out[i]), len(want[i])))
            log(f"eos serve {layout}: request {i} parts from the cut no-EOS output at index "
                f"{at}: got {out[i]}, want {want[i]}")
        check(not differ, f"eos serve {layout}: requests {differ} differ from their no-EOS "
              f"outputs cut at eos_id {eos}")
        check(eng.graph_entries() == base["graphs"],
              f"eos serve {layout}: {eng.graph_entries()} graphs captured, "
              f"{base['graphs']} without EOS")
        check_graphs(eng, f"eos serve {layout}")
        stopped = [i for i, (o, g) in enumerate(zip(out, gens)) if len(o) < g]
        check(0 in stopped, f"eos serve {layout}: request 0 did not stop at eos_id {eos}")
        want_counts = {"flash_star": nl * (len(prompts) + (eng.ticks if layout == "dense" else 0)),
                       "paged_attention": nl * eng.ticks if layout == "paged" else 0,
                       "star_softmax": len(prompts) + eng.ticks}
        for name, n in want_counts.items():
            check(counts.get(name, 0) == n,
                  f"eos serve {layout}: {name} launched {counts.get(name, 0)} times, expected "
                  f"{n} ({len(prompts)} prefills, {eng.ticks} ticks of {nl} layers)")
        toks = sum(map(len, out))
        log(f"eos serve {layout}: eos_id {eos} stops requests {stopped} early; {toks} of "
            f"{sum(gens)} tokens in {wall:.3f}s, {eng.ticks} ticks against {base['ticks']} "
            f"without EOS, {eng.graph_entries()} capture(s) as without, every output the "
            f"no-EOS output cut at eos_id; ttft p50={1e3 * ttft_p50:.1f}ms; launches {counts}")
        for entry in results:
            entry["launches_by_path"][f"serve_eos_{layout}"] = counts.get(entry["name"], 0)
        summary[layout] = {"eos_id": eos, "stopped": stopped, "tokens": toks,
                           "tokens_without_eos": sum(gens), "ticks": eng.ticks,
                           "ticks_without_eos": base["ticks"],
                           "graph_entries": eng.graph_entries(), "wall_s": wall,
                           "launches": {k: counts.get(k, 0) for k in want_counts}}
    return summary


def prefill_pv_int8(results, cfg, params, prompt):
    """The int8 P.V path: a full-width granite-8b prefill whose attention
    spec sets ``pv_int8`` (``ops.attention(..., pv_int8=True)`` in every
    layer), counters zeroed just before and read just after; its logits held
    against the same prefill through the float P.V kernel."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model

    icfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, pv_int8=True))
    check(icfg.attention_spec.pv_int8 and icfg.attention_spec.impl == "pallas",
          f"pv_int8 config resolves to {icfg.attention_spec}")
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    with torch.no_grad():
        ref, _ = build_model(cfg).prefill(params, tokens, tokens.shape[1])
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, _ = build_model(icfg).prefill(params, tokens, tokens.shape[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "pv_int8 prefill: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"pv_int8 prefill: granite-8b, {tokens.shape[1]} tokens, {wall:.3f}s, launches {counts}; "
        f"logits vs the float P.V kernel rel_l2={rel:.3e}")
    check(counts.get("flash_star_pv_int8", 0) == cfg.num_layers and
          counts.get("flash_star", 0) == 0,
          f"pv_int8 prefill: launches {counts}, expected flash_star_pv_int8 x {cfg.num_layers}")
    check(rel < 3e-2, f"pv_int8 prefill logits differ from the float P.V: rel_l2={rel:.3e}")
    for e in results:
        e["launches_by_path"]["prefill_pv_int8"] = counts.get(e["name"], 0)
        if e["name"] == "flash_star_pv_int8":
            e["launches"] = counts["flash_star_pv_int8"]
    with torch.no_grad():
        profile_window(f"one full-width pv_int8 prefill, {tokens.shape[1]} tokens",
                       lambda: build_model(icfg).prefill(params, tokens, tokens.shape[1]))
    return {"tokens": int(tokens.shape[1]), "wall_s": wall, "logits_rel_l2": rel}


def _kernel_group(name: str) -> str:
    name = name.lower()
    if "paged_split_kernel" in name or "paged_combine_kernel" in name:
        return "paged_attention"  # the fp and the quantized kernels alike
    if any(k in name for k in PV_INT8_KERNELS):  # V pre-pass + attention
        return "flash_star_pv_int8"
    if "flash_star" in name:  # flash_star_tf32_kernel (f32), flash_star_mma_kernel (bf16)
        return "flash_star"
    if any(k in name for k in SSD_KERNELS):
        return "ssd_scan"
    if "star_softmax_lut_kernel" in name:  # every mode, clean or faulty: one kernel
        return "star_softmax"
    if "crossbar_tc_kernel" in name or "crossbar_scalar_kernel" in name:
        return "crossbar_matmul"
    if "sort" in name:  # the MoE router's top-k (a stable sort)
        return "sort"
    if any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "gemm"
    if "copy" in name or "cast" in name or "convert" in name:
        return "copy/cast"
    return "other"


def profile_window(label, fn):
    """Device time of ``fn`` by kernel group, from ``torch.profiler``, with
    its wall time (host clock, synchronized), device busy and idle share,
    each group's kernel records and the longest single copy/cast kernel.
    Where the profiler records no device time the breakdown is reported as
    not measured (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups, records = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = _kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + _self_device_us(ev)
        records[group] = records.get(group, 0) + ev.count
    longest_cast = max((_self_device_us(ev) for ev in prof.events()
                        if ev.device_type == torch.autograd.DeviceType.CUDA
                        and _kernel_group(ev.name) == "copy/cast"), default=0.0)
    busy = sum(groups.values())
    if busy <= 0:
        log(f"profile: {label}: wall {wall_us / 1e3:.2f} ms; the profiler recorded no device "
            f"time (breakdown not measured)")
        return None
    shares = {g: round(us / busy, 4) for g, us in sorted(groups.items(), key=lambda x: -x[1])}
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "groups_ms": {g: us / 1e3 for g, us in groups.items()}, "records": records,
           "longest_cast_us": longest_cast}
    log(f"profile: {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%} of wall, idle {1 - busy / wall_us:.1%}); "
        f"device time by group (ms): { {g: round(us / 1e3, 3) for g, us in groups.items()} }; "
        f"shares {shares}; kernel records {records}; longest copy/cast kernel "
        f"{longest_cast:.2f} us")
    return out


def tick_vs_eager(eng):
    """One decode tick by graph replay against the eager tick from a copy
    of the same state (pool, token inputs, tables): the last-position
    logits' max_abs difference (expected 0: the same kernels in the same
    order) and the greedy tokens of each.  The replay advances the engine's
    pool without its bookkeeping, so it is the engine's last use."""
    import torch

    from repro_torch.models.param import tree_map

    eng._upload_tick_inputs()
    state = [None if t is None else tree_map(torch.clone, t) for t in eng._tick_state()]
    _, eager = eng._tick_body(*state)
    replays = eng.graphs.replays
    _, replay = eng._decode()
    torch.cuda.synchronize()
    check(eng.graphs.replays == replays + 1 and eng.graph_entries() == 1,
          "tick vs eager: the tick did not replay its one graph")
    diff = float((replay.float() - eager.float()).abs().max())
    same = torch.equal(torch.argmax(replay, -1), torch.argmax(eager, -1))
    check(same, "tick vs eager: the replayed tick's greedy tokens differ from the eager tick's")
    return diff, bool(torch.equal(replay, eager))


# the longest copy/cast kernel a tick on the paged kernel may hold: the
# cast of the smallest weight at full width (wk or wv, [4096, 1024] float32
# read, bfloat16 written: 25.17 MB) takes at least 25.17 MB / 3.35 TB/s =
# 7.51 us, so a weight still cast at use shows as a kernel this long or
# longer.  (The gather adapters' materialized attention permutes float32
# K/V windows in copy kernels longer than that: there only the structural
# check below holds.)
WEIGHT_CAST_BOUND_US = 25.17e6 / 3.35e12 * 1e6


def check_cast_once(eng, label) -> None:
    """Every leaf the layers read through ``.to(compute_dtype)`` is in the
    compute dtype already (no weight is cast at use), and every leaf they
    read in float32 (an RG-LRU block's ``wa`` / ``wi`` / ``lam``, the norms)
    is still float32 (``param.casts_once``, which goes by the leaf's
    place)."""
    import torch

    from repro_torch.models.param import casts_once

    dtype = getattr(torch, eng.cfg.compute_dtype)

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, path + (k,)) if isinstance(v, dict)
                        else [(path + (k,), tree, v)])

    wrong = sorted({"/".join(path) for path, parent, v in leaves(eng.params)
                    if (v.dtype == dtype) != casts_once(path[-1], parent) and v.is_floating_point()
                    and dtype != torch.float32})
    check(not wrong, f"{label}: weights {wrong[:8]} are not in the dtype they are read in "
                     f"({dtype} if cast once, else float32)")


def profile_tick(cfg, params, kv_dtype="fp32", guard=None, label="", kv_layout="paged",
                 max_len=512 + 32, frontend=None):
    """One full-width decode tick with 4 active slots, by graph replay, from
    a steady state (no block opens): traced (device busy by group; on the
    paged kernel, or on flash_star over the dense pool, no copy/cast kernel
    as long as ``WEIGHT_CAST_BOUND_US``),
    then the next one timed alone (wall time, host clock after a
    synchronize: the profiler's own start and stop inflate the traced
    window's wall), the bytes of each (the ``[S, 1]`` int32 inputs and no
    table row up, the sampled tokens and the guard's error per check down),
    the replay held against the eager tick from a copy of its state, and the
    replay timed with CUDA events.  ``frontend(rng)``, where given, makes
    each request's frontend kwargs (a VLM's patch embeddings)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cb = ContinuousConfig(num_slots=4, max_len=max_len, temperature=0.8, kv_layout=kv_layout,
                          kv_block_size=16, kv_dtype=kv_dtype, guard=guard)
    eng = ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)
    check_cast_once(eng, "profile tick")
    rng = np.random.default_rng(SEED + 3)
    for n in (512, 384, 256, 128):  # the first tick opens a block; the next ones none
        eng.submit(rng.integers(0, cfg.vocab_size, (n,)), 8,
                   **(frontend(rng) if frontend else {}))
    h2d, d2h = (eng.metrics.counter(n) for n in ("serve.bytes.h2d", "serve.bytes.d2h"))
    name = f"one decode tick by replay, 4 slots, {kv_layout} {kv_dtype} pool{label}"
    moved = []

    def steady(step):
        checks = eng.guard.checks if guard is not None else 0
        before = (h2d.value(), d2h.value())
        out = step()
        up, down = h2d.value() - before[0], d2h.value() - before[1]
        checks = (eng.guard.checks if guard is not None else 0) - checks
        check(up == 4 * 4 and down == 4 * 4 + 4 * checks,
              f"{name}: {up} bytes up, {down} down; a steady tick moves the [4, 1] int32 "
              f"inputs up and 4 sampled tokens (+ {checks} guard errors) down")
        moved.append((up, down))
        return out

    with ops.use(softmax="pallas"):
        eng.step()  # admissions and the first tick (its capture), outside the trace
        prof = steady(lambda: profile_window(name, eng.step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steady(eng.step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks == 3,
              f"{name}: {eng.graph_entries()} graphs, {eng.graphs.replays} replays, "
              f"{eng.ticks} ticks")
        on_kernel = (cfg.paged_attention_spec.impl == "pallas_paged" if eng.kv_layout == "paged"
                     else cfg.attention_spec.impl == "pallas")
        if prof is not None and on_kernel:
            check(prof["longest_cast_us"] < WEIGHT_CAST_BOUND_US,
                  f"{name}: a copy/cast kernel of {prof['longest_cast_us']:.2f} us: a weight is "
                  f"still cast at use (bound {WEIGHT_CAST_BOUND_US:.2f} us)")
        diff, bit_equal = tick_vs_eager(eng)
        replay_ms = time_ms(eng._decode)
    busy = prof["busy_ms"] if prof is not None else None
    log(f"{name}: wall {wall_ms:.2f} ms untraced (device busy "
        f"{'not measured' if busy is None else f'{busy:.2f} ms, idle {1 - busy / wall_ms:.1%}'}); "
        f"bytes up / down per tick {moved}; replay vs eager tick: logits max_abs {diff:.3e} "
        f"(bit-equal {bit_equal}), greedy tokens equal; replay {replay_ms:.3f} ms (CUDA "
        f"events, median of 20)" + ("" if on_kernel else "; copy/cast kernel bound not "
                                    "applied (materialized attention)"))
    return {"profile": prof, "wall_ms": wall_ms,
            "idle_share": None if busy is None else 1 - busy / wall_ms,
            "bytes_up_down": moved, "logits_max_abs_vs_eager": diff,
            "logits_bit_equal": bit_equal, "replay_ms_events": replay_ms,
            "warmup_launches": eng.graphs.warmup_launches()}


def profile_chunk(cfg, model, params) -> None:
    """One full-width 128-token ``prefill_extend`` chunk at q_offset 256,
    traced: the unit of work chunked prefill repeats."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 6)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 384)), device="cuda")
    with torch.no_grad():
        _, cache = model.prefill(params, tokens[:, :256], 512)
        profile_window("one 128-token prefill chunk at q_offset 256",
                       lambda: model.prefill_extend(params, cache, tokens[:, 256:]))


# ---------------------------------------------------------------------------
# phase 6: quantized serve at full width (int8 pool, prefix cache, chunks)

QUANT_POOL_BLOCKS = 80  # forces preemptions for the plan below (4 slots want ~116)


def quant_serve_plan(vocab):
    """8 requests: a common 256-token system prefix (16 full blocks) plus
    each request's own 64-256-token suffix, 16-32 new tokens.  Lengths are
    drawn before tokens, so they do not depend on the vocabulary."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    suffix = [int(n) for n in rng.integers(64, 257, 8)]
    gens = [int(g) for g in rng.integers(16, 33, 8)]
    system = rng.integers(0, vocab, (256,))
    prompts = [np.concatenate([system, rng.integers(0, vocab, (n,))]) for n in suffix]
    return prompts, gens


def serve_quant(results, params):
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    model = build_model(cfg)
    prompts, gens = quant_serve_plan(cfg.vocab_size)
    cb = ContinuousConfig(num_slots=4, max_len=256 + 256 + 32, temperature=0.8,
                          kv_layout="paged", kv_block_size=16, kv_pool_blocks=QUANT_POOL_BLOCKS,
                          kv_dtype="int8", prefix_cache=True, prefill_chunk_tokens=128)
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, ttft_p50 = serve_requests(eng, prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for seq in out for t in seq]
    check([len(s) for s in out] == gens,
          f"serve int8: generated lengths {[len(s) for s in out]} != {gens}")
    check_graphs(eng, "serve int8")
    moved = {n: eng.metrics.counter(n).value()
             for n in ("serve.bytes.h2d", "serve.bytes.d2h", "kv.gather.bytes",
                       "serve.tables.rows_flushed")}
    # every table edit (an admission's fresh blocks, a block a decode write
    # opens, a slot cleared by a finish or a preemption) marks its row
    # dirty; the next tick uploads each dirty row once, W int32 entries
    check(moved["serve.tables.rows_flushed"] >= eng.preemptions + 1,
          f"serve int8: {moved['serve.tables.rows_flushed']} table rows flushed for "
          f"{eng.preemptions} preemptions")
    log(f"serve int8: {eng.ticks} ticks by graph replay; transfers {moved} "
        f"({eng._slot_blocks} entries a table row)")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve int8: a token outside the vocabulary")
    st = eng.kv_stats()
    prefills = int(eng.metrics.counter("serve.prefill.calls").value())
    ttft = eng.metrics.histogram("serve.ttft_s")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve int8: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
        f"{len(toks)} tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s, "
        f"{eng.ticks} decode ticks, {prefills} prefill chunks, "
        f"ttft p50={1e3 * ttft_p50:.1f}ms (histogram p50 {1e3 * ttft.percentile(50):.1f}ms), "
        f"max_memory_allocated={peak / 2**30:.2f} GiB, "
        f"{eng.preemptions} preemptions, prefix {st['prefix']}, "
        f"kv bytes/token {st['kv_bytes_per_token']:.1f}")
    log(f"serve int8: launches {counts}")
    check(st["prefix"]["hits"] >= 1, "serve int8: no prefix-cache hit")
    check(eng.preemptions >= 1, "serve int8: the pool forced no preemption")
    check(counts.get("paged_attention_quant", 0) == cfg.num_layers * eng.ticks,
          f"serve int8: paged_attention_quant launched {counts.get('paged_attention_quant', 0)} "
          f"times, expected {cfg.num_layers * eng.ticks}")
    check(counts.get("flash_star", 0) == cfg.num_layers * prefills,
          f"serve int8: flash_star launched {counts.get('flash_star', 0)} times for "
          f"{prefills} chunks of {cfg.num_layers} layers")
    check(counts.get("star_softmax", 0) >= eng.ticks,
          f"serve int8: star_softmax launched {counts.get('star_softmax', 0)} times")
    check(counts.get("paged_attention", 0) == 0, "serve int8: the fp paged kernel ran")
    for entry in results:
        n = counts.get(entry["name"], 0)
        entry["launches_by_path"]["serve_int8"] = n
        if entry["name"] == "paged_attention_quant":
            entry["launches"] = n
    rel = quant_decode_step(cfg, model, params, prompts[:4])
    tick = profile_tick(cfg, params, kv_dtype="int8")
    profile_chunk(cfg, model, params)
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "ticks": eng.ticks, "prefill_chunks": prefills, "transfers": moved, "tick": tick,
            "ttft_p50_s": ttft_p50, "ttft_p50_histogram_s": ttft.percentile(50),
            "max_memory_allocated": peak,
            "preemptions": eng.preemptions, "prefix": st["prefix"],
            "decode_step_logits_rel_l2": rel}


def quant_decode_step(cfg, model, params, prompts) -> float:
    """One full-width decode step over an int8 pool through the kernel,
    held against the same step through the ``reference`` paged impl (the
    gather + dequant plain path) on a copy of the same pool."""
    import torch

    from repro_torch import ops
    from repro_torch.models.param import tree_map

    bs, rows = 16, 256
    w = rows // bs + 1
    pool = model.init_paged_cache(len(prompts) * w + 1, bs, len(prompts), device="cuda",
                                  kv_dtype="int8")
    tables = torch.arange(1, len(prompts) * w + 1, dtype=torch.int32,
                          device="cuda").reshape(len(prompts), w)
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            tokens = torch.as_tensor(p[:rows - 16 * slot], device="cuda")[None]
            _, cache = model.prefill(params, tokens, w * bs)
            model.write_slot_paged(pool, cache, slot, tables[slot])
        nxt = torch.as_tensor([[int(p[-1])] for p in prompts], device="cuda")
        pool_ref = tree_map(lambda t: t.clone(), pool)
        got, _ = model.decode_step_paged(params, pool, nxt, tables, cache_t=w * bs)
        with ops.use(paged_attention="reference"):
            ref, _ = model.decode_step_paged(params, pool_ref, nxt, tables, cache_t=w * bs)
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "int8 decode step: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"full-width int8 decode step logits, kernel vs reference paged impl: rel_l2={rel:.3e} "
        f"max_abs={float((got - ref).abs().max()):.3e}")
    check(rel < 3e-2, f"int8 decode step logits differ from the reference: rel_l2={rel:.3e}")
    return rel


# ---------------------------------------------------------------------------
# phase 7: serve on a degraded RRAM device, the crossbar MatMul engine


def _degraded_engine(params, fault_kw, mode, guard):
    from repro_torch.configs import get_config
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = get_config("granite_8b")  # attention xla: faulty rows -> the reference path
    cfg = dataclasses.replace(cfg, softmax=dataclasses.replace(
        cfg.softmax_spec, fault=FaultModel(**fault_kw), mode=mode))
    cb = ContinuousConfig(num_slots=4, max_len=256 + 16, temperature=0.8, kv_layout="paged",
                          kv_block_size=16, guard=guard)
    return cfg, ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)


def degraded_serve(results, params, cparams):
    import warnings

    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts

    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED + 8)
    lens = [int(n) for n in rng.integers(128, 257, 4)]
    prompts = [rng.integers(0, get_config("granite_8b").vocab_size, (n,)) for n in lens]
    gens = [16] * 4
    by_name = {e["name"]: e for e in results}
    summary = {}

    # 7a: the mild fault, histogram mode, a guard that checks every call and
    # never latches, so the LUT kernel serves every sampled batch
    with ops.use(softmax="pallas"):
        cfg, eng = _degraded_engine(cparams, MILD, "histogram", ops.GuardConfig(latch=False))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ops.GuardTripWarning)
            out, ttft = serve_requests(eng, prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for o in out for t in o]
    g = eng.stats()["guard"]
    batches = len(prompts) + eng.ticks
    peak = torch.cuda.max_memory_allocated()
    log(f"degraded 7a (mild fault, histogram, guard latch=False): prompts {lens}, {len(toks)} "
        f"tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s, {eng.ticks} ticks, ttft "
        f"p50={1e3 * ttft:.1f}ms, max_memory_allocated={peak / 2**30:.2f} GiB, guard {g}, "
        f"launches {counts}")
    check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for t in toks),
          "degraded 7a: bad output")
    check_graphs(eng, "degraded 7a")
    check(eng._eager_sampling, "degraded 7a: sampling under the guard is not eager")
    check(g["calls"] == batches and g["checks"] == g["calls"],
          f"degraded 7a: guard calls/checks {g['calls']}/{g['checks']}, {batches} sampled batches")
    check(counts.get("star_softmax_lut", 0) == batches,
          f"degraded 7a: star_softmax_lut launched {counts.get('star_softmax_lut', 0)} times for "
          f"{batches} sampled batches")
    check(counts.get("flash_star", 0) == 0 and counts.get("paged_attention", 0) == 0,
          "degraded 7a: an attention kernel ran on a faulty spec")
    by_name["star_softmax_lut"]["launches"] = counts["star_softmax_lut"]
    for e in results:
        e["launches_by_path"]["degraded_mild"] = counts.get(e["name"], 0)
    summary["mild_histogram"] = {"tokens": len(toks), "wall_s": wall,
                                 "tok_per_s": len(toks) / wall, "ticks": eng.ticks,
                                 "ttft_p50_s": ttft, "max_memory_allocated": peak, "guard": g}
    summary["mild_histogram"]["tick"] = profile_tick(
        cfg, cparams, guard=ops.GuardConfig(latch=False), label=", mild fault")

    # 7b: a severe fault, gather mode, a latching guard: the kernel runs until
    # the first check trips, then the clean path serves.  The format's
    # provable bound e^r - 1 (0.284) is absolute, and over a 49152-token
    # vocabulary the sampling distribution of random weights is flat (largest
    # probability ~1e-3 at T=0.8), so no fault can exceed it there; the
    # budget is twice the clean engine's own error on the first prompt's
    # sampling logits instead
    from repro_torch.models.registry import build_model

    clean_cfg = get_config("granite_8b")
    with torch.no_grad():
        tokens = torch.as_tensor(prompts[0], device="cuda")[None]
        logits, _ = build_model(clean_cfg).prefill(cparams, tokens, 256 + 16)
    scaled = logits[0, -1].float() / 0.8
    clean_err = float((ops.softmax(scaled, ops.SoftmaxSpec(impl="pallas"))
                       - torch.softmax(scaled, dim=-1)).abs().max())
    budget = 2 * clean_err
    log(f"degraded 7b: clean STAR sampling error on the first prompt {clean_err:.3e} "
        f"(largest exact probability {float(torch.softmax(scaled, -1).max()):.3e}); "
        f"guard tolerance {budget:.3e}")
    with ops.use(softmax="pallas"):
        cfg, eng = _degraded_engine(cparams, SEVERE, "gather", ops.GuardConfig(tolerance=budget))
        reqs = []
        for p in prompts:
            eng.submit(p, 16)
            reqs.append(eng.scheduler.pending[-1])
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        history = []
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            while not eng.scheduler.done():
                eng.step()
                history.append((launch_counts().get("star_softmax_lut", 0), eng.guard.tripped))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    g = eng.stats()["guard"]
    trips = [w for w in rec if issubclass(w.category, ops.GuardTripWarning)]
    toks = [t for o in eng.scheduler.finished.values() for t in o]
    ttft = sorted(r.first_token_time - r.submit_time for r in reqs)[len(reqs) // 2 - 1]
    peak = torch.cuda.max_memory_allocated()
    log(f"degraded 7b (severe fault, gather, latching guard): {len(toks)} tokens in {wall:.3f}s "
        f"= {len(toks) / wall:.2f} tok/s, {eng.ticks} ticks, ttft p50={1e3 * ttft:.1f}ms, "
        f"max_memory_allocated={peak / 2**30:.2f} GiB, guard {g}, {len(trips)} GuardTripWarning, "
        f"kernel launches by step {[n for n, _ in history]}")
    check(g["trips"] >= 1 and g["tripped"] and g["fallbacks"] >= 1 and trips,
          f"degraded 7b: the guard did not trip and latch: {g}")
    first = next(i for i, (_, tripped) in enumerate(history) if tripped)
    at_trip = history[first][0]
    check(at_trip >= 1, "degraded 7b: the LUT kernel did not run before the trip")
    check(all(n == at_trip for n, _ in history[first:]),
          "degraded 7b: the LUT kernel launched after the guard latched")
    check(counts["star_softmax_lut"] == g["calls"] - g["fallbacks"] + g["trips"],
          f"degraded 7b: {counts['star_softmax_lut']} launches for guard {g}")
    check(all(0 <= t < cfg.vocab_size for t in toks) and len(toks) == sum(gens),
          "degraded 7b: bad output")
    check_graphs(eng, "degraded 7b")
    for e in results:
        e["launches_by_path"]["degraded_severe"] = counts.get(e["name"], 0)
    summary["severe_gather"] = {"tokens": len(toks), "wall_s": wall,
                                "tok_per_s": len(toks) / wall, "ticks": eng.ticks,
                                "ttft_p50_s": ttft, "max_memory_allocated": peak, "guard": g,
                                "lut_launches": counts["star_softmax_lut"]}

    # the crossbar MatMul engine at granite-8b's q and MLP-up projection
    # widths (layer 0's weights), under a guard that checks every call
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn(256, 4096, device="cuda", generator=gen)
    weights = {"q_proj": params["blocks"]["attn"]["wq"][0],
               "mlp_up": params["blocks"]["mlp"]["wi"][0]}
    guard = ops.AccuracyGuard(ops.GuardConfig(latch=False))
    mm = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ops.GuardTripWarning)
        for name, w in weights.items():
            for label, fault in (("clean", None), ("mild", ops.FaultModel(**MILD))):
                t0 = time.perf_counter()
                out = ops.matmul(x, w, ops.MatmulSpec(impl="hwmodel", fault=fault), guard=guard)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()), f"matmul {name} {label}: non-finite")
                mm[f"{name} {label}"] = {"rel_max_abs_err": guard.last_error,
                                         "wall_s": time.perf_counter() - t0}
    counts = launch_counts()
    log(f"matmul hwmodel [256, 4096] @ layer 0 q_proj [4096, 4096] / mlp_up [4096, 14336]: "
        f"{mm}; guard {guard.stats()}; launches {counts}")
    check(counts.get("crossbar_matmul", 0) == 4,
          f"matmul hwmodel: crossbar_matmul launched {counts.get('crossbar_matmul', 0)} times, "
          "expected 4")
    summary["matmul_hwmodel"] = {"calls": mm, "guard": guard.stats()}
    parity_crossbar(results, x, weights, counts["crossbar_matmul"])
    return summary


def _crossbar_products(xq, wq, step, off):
    """The kernel's products and staging without its ADC epilogue (the
    library's timing probe; its output is not the crossbar's)."""
    import torch

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.crossbar_matmul import ref as xr

    lib = _cuda.load(xk.SOURCE, xk._bind)
    lib.crossbar_matmul_products_launch.argtypes = lib.crossbar_matmul_launch.argtypes
    lib.crossbar_matmul_products_launch.restype = lib.crossbar_matmul_launch.restype
    out = torch.empty((xq.shape[0], wq.shape[1]), dtype=torch.float32, device=xq.device)
    rc = lib.crossbar_matmul_products_launch(
        xq.data_ptr(), wq.data_ptr(), step.data_ptr(),
        off.data_ptr() if off is not None else None, out.data_ptr(), xq.shape[0], xq.shape[1],
        wq.shape[1], 0, xk.W_TYPES[wq.dtype], xr.DEFAULT_SPEC.adc_levels,
        _cuda.stream_handle(xq.device))
    _cuda.check(lib, rc, "crossbar_matmul_products")
    return out


def parity_crossbar(results, x, weights, launches):
    """The crossbar kernel against its plain version at the projection
    shapes: clean outputs bit-exact; faulty ones equal but for ADC codes
    within FLIP_DELTA LSB of a half-step, at most FLIP_BOUND of the outputs.
    Times: CUDA events and the kernel's device time (int8 operands handed to
    it as the wrapper passes them), and the device time of the same
    instantiation without its ADC epilogue: the epilogue's share."""
    import torch

    from repro_torch.hwmodel import faults as tf
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.crossbar_matmul import ref as xr

    variants = []
    for name, w in weights.items():
        for label, fault in (("clean", None), ("mild", tf.FaultModel(**MILD))):
            xq, wq, step, off, _ = xr.prepare_operands(x, w, fault=fault)
            xq = xq.to(torch.int8)  # the kernel's operand types, as the wrapper casts them
            wq = wq if fault is not None else wq.to(torch.int8)
            got = xk.crossbar_matmul(xq, wq, step, off)
            ref = xr.crossbar_accumulate_ref(xq, wq, step, off)
            torch.cuda.synchronize()
            tag = f"crossbar {name} {label}"
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
            differ = got != ref
            flips = int(differ.sum())
            if fault is None:
                check(flips == 0, f"{tag}: {flips} outputs differ from the plain version")
            elif flips:
                kt = xq.shape[1] // 128
                xd, wd = xq.double(), wq.double()
                near = torch.zeros_like(differ)
                for i in range(kt):
                    code = (xd[:, i * 128:(i + 1) * 128] @ wd[i * 128:(i + 1) * 128]) / \
                        step[i].double().repeat_interleave(128)
                    if off is not None:
                        code = code + off[i].double().repeat_interleave(128)
                    near |= (code - code.floor() - 0.5).abs() < FLIP_DELTA
                check(not bool((differ & ~near).any()),
                      f"{tag}: outputs differ with no ADC code near a half-step")
                check(flips <= FLIP_BOUND * got.numel(),
                      f"{tag}: {flips} ADC flips exceed {FLIP_BOUND} of {got.numel()} outputs")
            err = float((got - ref).abs()[~differ].max()) if bool((~differ).any()) else 0.0
            call = lambda: xk.crossbar_matmul(xq, wq, step, off)  # noqa: E731
            ms = time_ms(call)
            plain_ms = time_ms(lambda: xr.crossbar_accumulate_ref(xq, wq, step, off))
            dev = device_ms_per_launch(call, "crossbar_tc_kernel")
            prod = device_ms_per_launch(lambda: _crossbar_products(xq, wq, step, off),
                                        "crossbar_tc_kernel")
            m, k = xq.shape
            n = wq.shape[1]
            # the kernel reads int8 codes, and float32 weights under a fault
            bytes_moved = (m * k + k * n * (4 if fault is not None else 1)
                           + step.numel() * 4 * (1 if off is None else 2) + m * n * 4)
            t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
            if fault is None:  # s8 products at the int8 peak
                t_ops = 2 * m * n * k / H100_INT8_OPS * 1e3
            else:  # three bf16 products as issued at the bf16 peak
                t_ops = 3 * 2 * m * n * k / H100_BF16_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            at = dev
            bn = 64 if -(-m // 128) * (n // 64) >= torch.cuda.get_device_properties(0) \
                .multi_processor_count else 32
            variants.append(dict(
                shape=f"[{m}, {k}] @ {name} [{k}, {n}]", fault=label, max_abs_err=err,
                adc_flips=flips, ms=ms, device_ms=dev, products_device_ms=prod,
                adc_share=1 - prod / dev, plain_ms=plain_ms,
                library_ms=None, bytes=bytes_moved, ops=2 * m * n * k, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                fp32_fma_bound_ms=2 * m * n * k / H100_FP32_FLOPS * 1e3 if fault else None,
                share_of_bound=bound / at, cta_tile=f"128 x {bn}",
                ctas=-(-m // 128) * (n // bn)))
            log(f"{tag}: [{m}, {k}] @ [{k}, {n}] max_abs_err={err:.3e} adc_flips={flips} "
                f"ms={ms:.4f} device_ms={dev} (without the ADC epilogue {prod}) "
                f"plain_ms={plain_ms:.4f} bound_ms={bound:.5f} ({variants[-1]['bound_by']}) "
                f"share_of_bound={bound / at:.4f} tiles 128 x {bn}, "
                f"{variants[-1]['ctas']} CTAs")
    main = variants[2]  # mlp_up, clean
    entry = _entry("crossbar_matmul", "cuda",
                   "src/repro_torch/kernels/crossbar_matmul/csrc/crossbar_matmul.cu",
                   "src/repro/kernels/crossbar_matmul/kernel.py:69", main, main["bytes"],
                   main["ops"], H100_INT8_OPS, variants,
                   shape=f"{main['shape']}, clean int8 (main); faulty float32 weights in variants")
    entry["launches"] = launches
    entry["launches_by_path"] = {"matmul_hwmodel": launches}
    entry.update(design=CROSSBAR_DESIGN, device_ms=main["device_ms"])
    results.append(entry)


# ---------------------------------------------------------------------------
# phase 8: Mamba2 on the lockstep engine


def small_reference_mamba():
    """The mamba2-130m smoke config served greedy on the card (the kernels)
    and on the CPU (their plain versions) with the same weights: the same
    tokens.  The prompts (21 tokens) are ragged against the chunk (16)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_smoke_config("mamba2_130m")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    prompts = np.random.default_rng(SEED + 11).integers(0, cfg.vocab_size, (3, 21))
    outs, counts = {}, {}
    with ops.use(softmax="pallas"):
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            reset_launch_counts()
            eng = ServeEngine(cfg, params, ServeConfig(max_len=64), device=dev)
            toks, _ = eng.generate(prompts, 8)
            torch.cuda.synchronize()
            outs[dev], counts[dev] = toks.cpu().tolist(), launch_counts()
            check((eng.graphs.entries(), eng.graphs.replays) == (1, 7),
                  f"mamba2 smoke on {dev}: {eng.graphs.entries()} captures, "
                  f"{eng.graphs.replays} replays for 7 decode steps")
    check(outs["cuda"] == outs["cpu"],
          f"mamba2 smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    check(counts["cuda"].get("ssd_scan", 0) == cfg.num_layers,
          f"mamba2 smoke: ssd_scan launched {counts['cuda'].get('ssd_scan', 0)} times on the "
          f"card for {cfg.num_layers} layers")
    log(f"small reference mamba2: greedy smoke tokens identical on card and cpu "
        f"(3 x 8 tokens, prompts of 21, chunk {cfg.ssm_chunk}); card launches {counts['cuda']}")


def mamba_greedy_divergence(cfg, model, params, tokens, max_len, steps, noise):
    """Greedy tokens from the kernel's prefill and from the plain chunk
    scan's (``ops.use(ssd_scan="reference")``), ``steps`` of them per row;
    decode never calls ssd_scan, so the routes differ only in the prefill's
    state.  For each row whose tokens part, the first step that differs, the
    reference's top-2 logit margin there and the two routes' logit
    difference there (logged only).  A divergence fails where that margin
    exceeds SSD_DIVERGENCE_FACTOR x ``noise``, the prefill logits' max_abs
    difference: then the routes part on a token that their float32
    differences cannot explain."""
    import torch

    from repro_torch import ops

    runs = {}
    for route in ("pallas", "reference"):
        toks, lasts = [], []
        with ops.use(ssd_scan=route), torch.no_grad():
            logits, cache = model.prefill(params, tokens, max_len)
            for step in range(steps):
                last = logits[:, -1].float()
                nxt = torch.argmax(last, dim=-1).to(torch.int32)  # sample_token's greedy
                toks.append(nxt)
                lasts.append(last[:, :cfg.vocab_size])
                if step + 1 < steps:
                    logits, cache = model.decode_step(params, cache, nxt[:, None])
        runs[route] = (torch.stack(toks, 1), torch.stack(lasts, 1))  # [B, steps], [B, steps, V]
    (tk, lk), (tr, lr) = runs["pallas"], runs["reference"]
    differs = (tk != tr).cpu()
    divergences = []
    for row in range(tk.shape[0]):
        where = torch.nonzero(differs[row]).flatten()
        if where.numel() == 0:
            continue
        step = int(where[0])
        top2 = lr[row, step].topk(2).values
        margin = float(top2[0] - top2[1])
        diff = float((lk[row, step] - lr[row, step]).abs().max())
        d = dict(row=row, step=step, kernel_token=int(tk[row, step]),
                 reference_token=int(tr[row, step]), reference_top2_margin=margin,
                 logit_diff=diff, kernel_tokens=tk[row].tolist(), reference_tokens=tr[row].tolist())
        divergences.append(d)
        log(f"mamba2 greedy: row {row} parts at step {step}: kernel {d['kernel_token']} vs "
            f"reference {d['reference_token']}, reference top-2 margin {margin:.4e}, logit "
            f"difference there {diff:.4e} (prefill {noise:.4e})")
        check(margin <= SSD_DIVERGENCE_FACTOR * noise,
              f"mamba2 greedy row {row} parts at step {step} with a reference top-2 margin "
              f"{margin:.4e} above {SSD_DIVERGENCE_FACTOR} x the prefill logits' max_abs "
              f"difference {noise:.4e}")
    log(f"mamba2 greedy, {tk.shape[0]} rows x {steps} tokens, kernel vs reference prefill: "
        f"{tk.shape[0] - len(divergences)} rows identical"
        + (f", {len(divergences)} part (within {SSD_DIVERGENCE_FACTOR} x the prefill's max_abs)"
           if divergences else ""))
    return {"rows": int(tk.shape[0]), "steps": steps,
            "rows_identical": int(tk.shape[0]) - len(divergences), "divergences": divergences}


def lockstep_decode_step(eng, prompts, steps=8, label="mamba2 decode step by replay, batch 8",
                         **frontend):
    """The engine's own decode step (``ServeEngine.decode``: its graph's
    replay, the draws outside it, the token copy) from a full-width
    ``begin``: the time to first token (``begin``: the prefill and the first
    sample, host clock after a synchronize), the wall time of a step over
    ``steps`` after the capturing one (host clock, synchronized), one step
    traced (device busy, idle share) and a step by CUDA events."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.begin(prompts, **frontend)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    eng.decode(state)  # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    prof = profile_window(label, lambda: eng.decode(state))
    event_ms = time_ms(lambda: eng.decode(state))
    check(eng.graphs.entries() == 1, f"{label}: {eng.graphs.entries()} captures")
    return ttft, {"wall_ms": wall_ms, "busy_ms": prof["busy_ms"] if prof else None,
                  "profile": prof, "step_ms_events": event_ms}


def serve_mamba(results):
    """mamba2-130m at its published widths and all 24 layers, random weights
    drawn on the card from the seed, on the lockstep engine: 8 prompts of
    2048 tokens, 32 new tokens each, temperature 0.8, sampling softmax
    ``pallas``.  Counters zeroed just before the serve and read just after:
    ``ssd_scan`` once per layer of the prefill, the STAR softmax once per
    sampled step (the first sample's eager launch and one a replay).  Then
    one full-width prefill through the kernel against the same prefill under
    ``ops.use(ssd_scan="reference")``, 32 greedy tokens from each route's
    prefill (``mamba_greedy_divergence``), and one prefill and one decode
    step traced."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("mamba2_130m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    torch.cuda.synchronize()
    log(f"serve mamba2: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
        f"{count_params(model.param_specs()) / 1e6:.1f}M params ({cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}) drawn in {time.perf_counter() - t0:.1f}s")
    b, t, gen = 8, 2048, 32
    prompts = np.random.default_rng(SEED + 12).integers(0, cfg.vocab_size, (b, t))
    tokens = torch.as_tensor(prompts, device="cuda")
    sc = ServeConfig(max_len=t + gen, temperature=0.8)
    with ops.use(softmax="pallas"), torch.no_grad():
        eng = ServeEngine(cfg, params, sc, device="cuda", seed=SEED)
        eng.generate(prompts[:, :256], 2)  # warm-up: the sampling kernel at this vocabulary
        ttft, step = lockstep_decode_step(eng, prompts)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, info = eng.generate(prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    capture = eng.graphs.capture_seconds
    out = toks.cpu().numpy()
    check(out.shape == (b, gen) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"serve mamba2: bad output {out.shape}")
    check(info["cache_len"] == t + gen - 1, f"serve mamba2: cache_len {info['cache_len']}")
    check((eng.graphs.entries(), eng.graphs.replays) == (1, gen - 1),
          f"serve mamba2: {eng.graphs.entries()} captures, {eng.graphs.replays} replays for "
          f"{gen - 1} decode steps")
    log(f"serve mamba2: {b} x {t}-token prompts, {b * gen} tokens in {wall:.3f}s = "
        f"{b * gen / wall:.2f} tok/s ({b * gen / (wall - capture):.2f} tok/s without the "
        f"warm-up and capture, {capture:.3f}s of the generate's wall); ttft (begin: prefill "
        f"+ first sample) {1e3 * ttft:.1f}ms, decode step by replay {step['wall_ms']:.2f}ms "
        f"wall (device busy "
        f"{step['busy_ms'] if step['busy_ms'] is None else round(step['busy_ms'], 3)} ms, "
        f"{step['step_ms_events']:.3f} ms by CUDA events), "
        f"max_memory_allocated={peak / 2**30:.2f} GiB, cache_len {info['cache_len']}; "
        f"{gen - 1} decode steps by replay of {eng.graphs.entries()} capture")
    log(f"serve mamba2: launches {counts}")
    check(counts.get("ssd_scan", 0) == cfg.num_layers,
          f"serve mamba2: ssd_scan launched {counts.get('ssd_scan', 0)} times, "
          f"expected {cfg.num_layers} (one per layer of the prefill)")
    check(counts.get("star_softmax", 0) == gen,
          f"serve mamba2: star_softmax launched {counts.get('star_softmax', 0)} times for "
          f"{gen} sampled steps (counted through {eng.graphs.replays} replays)")
    for e in results:
        e["launches_by_path"]["serve_mamba2"] = counts.get(e["name"], 0)
        if e["name"] == "ssd_scan":
            e["launches"] = counts["ssd_scan"]

    # one full-width prefill through the kernel vs the plain chunk scan, in
    # the serve's bf16 compute and in float32 compute (where no bf16
    # rounding of the mixer output can absorb the scans' float32 differences)
    rels, max_abs = {}, {}
    for dtype in ("bfloat16", "float32"):
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        dmodel = build_model(dcfg)
        with torch.no_grad():
            reset_launch_counts()
            got, _ = dmodel.prefill(params, tokens, t + gen)
            n_kernel = launch_counts().get("ssd_scan", 0)
            with ops.use(ssd_scan="reference"):
                ref, _ = dmodel.prefill(params, tokens, t + gen)
            n_ref = launch_counts().get("ssd_scan", 0) - n_kernel
        check(n_kernel == cfg.num_layers and n_ref == 0,
              f"mamba2 prefill {dtype}: ssd_scan launched {n_kernel} times on the kernel "
              f"route and {n_ref} times on the reference route")
        # the vocabulary's own columns: the padding columns hold -1e30
        got, ref = got[..., :cfg.vocab_size].float(), ref[..., :cfg.vocab_size].float()
        check(bool(torch.isfinite(got).all()), f"mamba2 prefill {dtype}: non-finite logits")
        rels[dtype] = float((got - ref).norm() / ref.norm())
        max_abs[dtype] = float((got - ref).abs().max())
        log(f"full-width mamba2 prefill logits [8, 2048], {dtype} compute, kernel vs reference "
            f"chunk scan: rel_l2={rels[dtype]:.3e} max_abs={max_abs[dtype]:.3e}")
        check(rels[dtype] < 3e-2,
              f"mamba2 prefill {dtype} logits differ from the reference: rel_l2={rels[dtype]:.3e}")
        del got, ref
    rel = rels["bfloat16"]
    greedy = mamba_greedy_divergence(cfg, model, params, tokens, t + gen, gen, max_abs["bfloat16"])
    with torch.no_grad():
        profile_window("mamba2 prefill, 8 x 2048 tokens",
                       lambda: model.prefill(eng.params, tokens, t + gen))
    return {"batch": b, "prompt_len": t, "gen": gen, "tokens": b * gen, "wall_s": wall,
            "tok_per_s": b * gen / wall, "capture_s": capture,
            "tok_per_s_without_capture": b * gen / (wall - capture), "ttft_s": ttft,
            "decode_step": step,
            "max_memory_allocated": peak, "prefill_logits_rel_l2": rel,
            "prefill_logits_rel_l2_f32_compute": rels["float32"],
            "prefill_logits_max_abs": max_abs, "greedy_kernel_vs_reference": greedy}


# ---------------------------------------------------------------------------
# phase 9: granite-moe-1b-a400m at full width, the STAR router on every layer


def serve_once(cfg, cparams, cb, prompts, gens, label, frontends=None):
    """One continuous serve of a traffic (``frontends``: per request its
    frontend kwargs) under ``ops.use(softmax="pallas")``, counters zeroed
    just before and read just after: a MoE model's router STAR softmax once
    per layer of every prefill (or chunk) and of every tick, and the sampling
    softmax once per admission and per tick (ticks counted through the
    replays); flash_star once per layer of every prefill or chunk and, on the
    dense pool, of every tick; the paged kernel once per layer of every tick
    on the paged pool, else never."""
    import torch

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousBatchingEngine

    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg, cparams, cb, device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, ttft_p50 = serve_requests(eng, prompts, gens, frontends)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for seq in out for t in seq]
    check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for t in toks),
          f"{label}: bad output lengths {[len(o) for o in out]} or a token outside the "
          f"vocabulary")
    check_graphs(eng, label)
    moe = cfg.family == "moe"
    check(eng.prefix is None or not moe, f"{label}: a MoE arch kept a prefix cache")
    nl = cfg.num_layers
    calls = int(eng.metrics.counter("serve.prefill.calls").value())
    admitted = int(eng.metrics.counter("serve.requests.admitted").value())
    paged = eng.kv_layout == "paged"
    routers = nl * (calls + eng.ticks) if moe else 0
    want = {"star_softmax": routers + admitted + eng.ticks,
            "flash_star": nl * calls + (0 if paged else nl * eng.ticks),
            "paged_attention": nl * eng.ticks if paged else 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n,
              f"{label}: {name} launched {counts.get(name, 0)} times, expected {n} ({calls} "
              f"prefills or chunks, {admitted} admissions, {eng.ticks} ticks of {nl} layers)")
    peak = torch.cuda.max_memory_allocated()
    capture = eng.graphs.capture_seconds
    log(f"{label}: {len(prompts)} requests, {len(toks)} tokens in {wall:.3f}s = "
        f"{len(toks) / wall:.2f} tok/s ({len(toks) / (wall - capture):.2f} tok/s without the "
        f"warm-up and capture, {capture:.3f}s), {calls} prefills or chunks, {eng.ticks} decode "
        f"ticks by graph replay ({eng.graph_entries()} capture), ttft p50={1e3 * ttft_p50:.1f}ms, "
        f"max_memory_allocated={peak / 2**30:.2f} GiB; launches {counts} (warm-up, not "
        f"counted: {eng.graphs.warmup_launches()})")
    summary = {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
               "capture_s": capture, "tok_per_s_without_capture": len(toks) / (wall - capture),
               "prefill_calls": calls, "ticks": eng.ticks, "ttft_p50_s": ttft_p50,
               "max_memory_allocated": peak, "launches": counts}
    if eng.prefix is not None:
        summary["prefix"] = eng.kv_stats()["prefix"]
    return counts, summary


def serve_moe(results):
    """Phase 9: granite-moe-1b-a400m at its published widths and all 24
    layers (32 experts, top-8), random weights drawn on the card from the
    seed and cast to bf16 once; the phase 5 traffic on the dense pool, then
    as a paged serve in 128-token chunks with ``prefix_cache=True`` (a MoE
    arch opts out of sharing: chunked, no trie); one 512-token prefill whose
    router probabilities from the kernel equal the plain version's bit for
    bit with equal top-8 experts, in all 24 layers; 4 x 512-token greedy
    lockstep generations of 32 tokens with the router on the kernel
    (``softmax`` ``pallas``) and on ``reference``, token for token; one
    steady tick on each layout traced (device time by group, its replay
    bit-equal to the eager tick)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.star_softmax import kernel as sk
    from repro_torch.models import layers as L
    from repro_torch.models.param import compute_params, count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousConfig, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_impl="pallas")
    model = build_model(cfg)
    nl = cfg.num_layers
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    cparams = compute_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"moe serve: {MOE_ARCH} {nl}L d={cfg.d_model} {cfg.num_experts} experts top-"
        f"{cfg.top_k} {count_params(model.param_specs()) / 1e9:.3f}B params drawn and cast to "
        f"{cfg.compute_dtype} once in {time.perf_counter() - t0:.3f}s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompts, gens = serve_plan(cfg.vocab_size)
    plans = {
        "moe serve dense": ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8,
                                            kv_layout="dense"),
        "moe serve paged, 128-token chunks": ContinuousConfig(
            num_slots=4, max_len=512 + 32, temperature=0.8, kv_layout="paged",
            kv_block_size=16, prefix_cache=True, prefill_chunk_tokens=128),
    }
    summary = {}
    for (label, cb), key in zip(plans.items(), ("moe_dense", "moe_paged_chunked")):
        counts, summary[key] = serve_once(cfg, cparams, cb, prompts, gens, label)
        for entry in results:
            entry["launches_by_path"][key] = counts.get(entry["name"], 0)

    # one 512-token prefill: every layer's router probabilities from the
    # kernel against the plain version on the same logits
    fmt = cfg.softmax_spec.fmt
    routers = []
    real_softmax = ops.softmax

    def spy(x, spec=None, **kw):
        out = real_softmax(x, spec, **kw)
        routers.append((x, out))
        return out

    tokens = torch.as_tensor(max(prompts, key=len)[:512], device="cuda")[None]
    ops.softmax = spy
    try:
        with torch.no_grad(), ops.use(softmax="pallas"):
            reset_launch_counts()
            model.prefill(cparams, tokens, 512 + 32)
            torch.cuda.synchronize()
            pre_counts = launch_counts()
    finally:
        ops.softmax = real_softmax
    check(len(routers) == nl and pre_counts.get("star_softmax", 0) == nl,
          f"moe prefill: {len(routers)} router softmax calls, {pre_counts.get('star_softmax', 0)} "
          f"kernel launches, expected {nl} of each")
    unequal = 0
    for i, (x, probs) in enumerate(routers):
        check(tuple(x.shape) == (1, tokens.shape[1], cfg.num_experts) and x.dtype == torch.float32,
              f"moe prefill layer {i}: router logits {tuple(x.shape)} {x.dtype}")
        plain = sk.star_softmax_ref(x, fmt)
        unequal += int((probs != plain).sum())
        check(torch.equal(L.top_k(probs, cfg.top_k)[1], L.top_k(plain, cfg.top_k)[1]),
              f"moe prefill layer {i}: top-{cfg.top_k} experts differ kernel vs plain")
    check(unequal == 0, f"moe prefill: {unequal} router probabilities differ from the plain "
          f"version's")
    log(f"moe prefill, {tokens.shape[1]} tokens: the router kernel's probabilities bit-equal to "
        f"the plain version's in all {nl} layers ([1, {tokens.shape[1]}, {cfg.num_experts}] each), "
        f"top-{cfg.top_k} experts equal")
    for entry in results:
        entry["launches_by_path"]["moe_prefill_512"] = pre_counts.get(entry["name"], 0)

    # greedy lockstep: the router on the kernel vs on the reference impl
    lock_prompts = np.random.default_rng(SEED + 12).integers(0, cfg.vocab_size, (4, 512))
    n = 32
    gens_by, lock = {}, {}
    for impl in ("pallas", "reference"):
        with ops.use(softmax=impl):
            eng = ServeEngine(cfg, cparams, ServeConfig(max_len=512 + 32), device="cuda")
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got, info = eng.generate(lock_prompts, n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        gens_by[impl] = got.cpu()
        cap = eng.graphs.capture_seconds
        lock[impl] = {"tokens": 4 * n, "wall_s": wall, "tok_per_s": 4 * n / wall,
                      "capture_s": cap, "tok_per_s_without_capture": 4 * n / (wall - cap),
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": counts}
        want = nl * n if impl == "pallas" else 0
        check(counts.get("star_softmax", 0) == want and eng.graphs.replays == n - 1,
              f"moe lockstep ({impl}): star_softmax launched {counts.get('star_softmax', 0)} "
              f"times, expected {want}; {eng.graphs.replays} replays")
        log(f"moe lockstep greedy, softmax {impl}: 4 x 512-token prompts, {4 * n} tokens in "
            f"{wall:.3f}s = {4 * n / wall:.2f} tok/s ({4 * n / (wall - cap):.2f} without the "
            f"warm-up and capture), cache_len {info['cache_len']}; launches {counts}")
        if impl == "pallas":
            for entry in results:
                entry["launches_by_path"]["moe_lockstep"] = counts.get(entry["name"], 0)
    same = torch.equal(gens_by["pallas"], gens_by["reference"])
    check(same, f"moe lockstep: greedy tokens under the router kernel differ from the "
          f"reference impl's in {int((gens_by['pallas'] != gens_by['reference']).sum())} of "
          f"{4 * n}")
    log(f"moe lockstep: {4 * n} greedy tokens under softmax pallas equal those under reference")

    ticks = {}
    for layout in ("dense", "paged"):
        tick = profile_tick(cfg, cparams, kv_layout=layout, label=f", {MOE_ARCH}")
        check(tick["logits_bit_equal"], f"moe {layout} tick: the replay is not bit-equal to "
              f"the eager tick")
        ticks[layout] = tick
    summary.update(lockstep=lock, ticks=ticks, params_b=count_params(model.param_specs()) / 1e9)
    del cparams
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 10: qwen2-vl-7b at full width, M-RoPE and the stub patch prefix


def vlm_plan(cfg):
    """Phase 10's traffic.  Dense: phase 5's 8 requests, each with its own
    [1, 256, 1280] patch embeddings.  Paged: 4 of those VLM requests
    interleaved with 4 text-only ones of a common 256-token prefix plus
    64-256 tokens of their own (the later two admitted after the first two
    have written their blocks, so they share); 16-32 new tokens each."""
    import numpy as np

    prompts, gens = serve_plan(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 23)
    frontends = [{"patch_embeds": rng.standard_normal(
        (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)} for _ in prompts]
    pre = rng.integers(0, cfg.vocab_size, (256,))
    text = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (int(n),))])
            for n in rng.integers(64, 257, 4)]
    mixed = [None] * 8
    mixed[0::2] = [(prompts[i], gens[i], frontends[i]) for i in range(4)]
    mixed[1::2] = [(text[i], gens[4 + i], {}) for i in range(4)]
    return (prompts, gens, frontends), tuple(zip(*mixed))


def serve_vlm(results):
    """Phase 10: qwen2-vl-7b at its published widths and all 28 layers
    (d_model 3584, 28 q / 4 kv heads: D 128, a GQA group of 7; d_ff 18944;
    vocab 152064; M-RoPE sections (16, 24, 24)), 7.62 B random float32
    weights drawn on the card from the seed and cast to bf16 once, after
    granite-moe's weights are freed.  A dense serve of ``vlm_plan``'s VLM
    traffic (4 slots, 800 rows a slot, temperature 0.8), then the mixed
    traffic on the paged pool in 128-token chunks with ``prefix_cache=True``
    (the text-only requests share, the VLM ones never look up); counters
    zeroed just before and read just after (``serve_once``).  One steady
    dense and one steady paged tick with VLM requests traced
    (``profile_tick``: replay bit-equal to the eager tick, device time by
    group); a 4 x (256 patches + 512 tokens) greedy lockstep generate of 32
    tokens (flash_star once per layer of the prefill and of each of its 31
    replays); one prefill with patches, kernels against
    ``ops.use(attention="reference")``, within rel_l2 < 3e-2."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import compute_params, count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousConfig, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="pallas")
    model = build_model(cfg)
    nl = cfg.num_layers
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    cparams = compute_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = count_params(model.param_specs())
    log(f"vlm serve: {VLM_ARCH} {nl}L d={cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"D {cfg.resolved_head_dim} vocab {cfg.vocab_size} {n_params / 1e9:.3f}B params drawn "
        f"and cast to {cfg.compute_dtype} once in {time.perf_counter() - t0:.3f}s, memory "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    (prompts, gens, frontends), (mprompts, mgens, mfront) = vlm_plan(cfg)
    plans = {
        "vlm_dense": ("vlm serve dense", ContinuousConfig(
            num_slots=4, max_len=VLM_MAX_LEN, temperature=0.8, kv_layout="dense"),
            prompts, gens, frontends),
        "vlm_paged_chunked": ("vlm serve paged, 128-token chunks, prefix cache", ContinuousConfig(
            num_slots=4, max_len=VLM_MAX_LEN, temperature=0.8, kv_layout="paged",
            kv_block_size=16, prefix_cache=True, prefill_chunk_tokens=128),
            list(mprompts), list(mgens), list(mfront)),
    }
    summary = {"params_b": n_params / 1e9}
    for key, (label, cb, ps, gs, fes) in plans.items():
        counts, summary[key] = serve_once(cfg, cparams, cb, ps, gs, label, frontends=fes)
        for entry in results:
            entry.setdefault("launches_by_path", {})[key] = counts.get(entry["name"], 0)
    prefix = summary["vlm_paged_chunked"]["prefix"]
    check(prefix["hits"] >= 1, f"vlm paged serve: the text-only requests shared nothing "
          f"through the trie: {prefix}")
    log(f"vlm paged serve: prefix cache {prefix} (text-only requests only)")

    def patches(rng):
        return {"patch_embeds": rng.standard_normal(
            (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}

    ticks = {}
    for layout in ("dense", "paged"):
        tick = profile_tick(cfg, cparams, kv_layout=layout, label=f", {VLM_ARCH} with patches",
                            max_len=VLM_MAX_LEN, frontend=patches)
        check(tick["logits_bit_equal"], f"vlm {layout} tick: the replay is not bit-equal to "
              f"the eager tick")
        ticks[layout] = tick

    rng = np.random.default_rng(SEED + 24)
    lock_prompts = rng.integers(0, cfg.vocab_size, (4, 512))
    lock_pe = rng.standard_normal((4, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    n = 32
    with ops.use(softmax="pallas"):
        lock = ServeEngine(cfg, cparams, ServeConfig(max_len=VLM_MAX_LEN), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, info = lock.generate(lock_prompts, n, patch_embeds=lock_pe)
        torch.cuda.synchronize()
        lwall = time.perf_counter() - t0
        lcounts = launch_counts()
    lcap = lock.graphs.capture_seconds
    check(tuple(got.shape) == (4, n) and bool(((got >= 0) & (got < cfg.vocab_size)).all()),
          f"vlm lockstep: bad output {tuple(got.shape)}")
    check(lcounts.get("flash_star", 0) == nl * n and lock.graphs.replays == n - 1,
          f"vlm lockstep: flash_star launched {lcounts.get('flash_star', 0)} times, expected "
          f"{nl * n}; {lock.graphs.replays} replays")
    check(info["cache_len"] == cfg.num_patches + 512 + n - 1,
          f"vlm lockstep: cache_len {info['cache_len']}")
    lpeak = torch.cuda.max_memory_allocated()
    log(f"vlm lockstep greedy: 4 x ({cfg.num_patches} patches + 512 tokens), {4 * n} tokens in "
        f"{lwall:.3f}s = {4 * n / lwall:.2f} tok/s ({4 * n / (lwall - lcap):.2f} without the "
        f"warm-up and capture, {lcap:.3f}s), cache_len {info['cache_len']}, "
        f"max_memory_allocated={lpeak / 2**30:.2f} GiB; launches {lcounts}")
    for entry in results:
        entry.setdefault("launches_by_path", {})["vlm_lockstep"] = lcounts.get(entry["name"], 0)

    tokens = torch.as_tensor(prompts[0][:128], device="cuda")[None]
    pe = frontends[0]["patch_embeds"]
    with torch.no_grad():
        reset_launch_counts()
        kern, cache = model.prefill(cparams, tokens, VLM_MAX_LEN, patch_embeds=pe)
        pcounts = launch_counts()
        with ops.use(attention="reference"):
            ref, _ = model.prefill(cparams, tokens, VLM_MAX_LEN, patch_embeds=pe)
    kern, ref = kern.float(), ref.float()
    check(bool(torch.isfinite(kern).all()), "vlm prefill: non-finite logits")
    check(pcounts.get("flash_star", 0) == nl, f"vlm prefill: flash_star launched "
          f"{pcounts.get('flash_star', 0)} times, expected {nl}")
    side = int(cfg.num_patches ** 0.5)
    check((int(cache["len"]), int(cache["pos"])) == (cfg.num_patches + 128, side + 128),
          f"vlm prefill: cache len / pos {int(cache['len'])} / {int(cache['pos'])}")
    rel = float((kern - ref).norm() / ref.norm())
    log(f"vlm prefill ({cfg.num_patches} patches + 128 tokens) logits, kernels vs reference "
        f"impls: rel_l2={rel:.3e} max_abs={float((kern - ref).abs().max()):.3e}; cache len "
        f"{int(cache['len'])}, pos {int(cache['pos'])}")
    check(rel < 3e-2, f"vlm prefill logits differ from the reference: rel_l2={rel:.3e}")
    summary.update(ticks=ticks, prefill_rel_l2=rel,
                   lockstep={"tokens": 4 * n, "wall_s": lwall, "tok_per_s": 4 * n / lwall,
                             "capture_s": lcap,
                             "tok_per_s_without_capture": 4 * n / (lwall - lcap),
                             "max_memory_allocated": lpeak, "launches": lcounts})
    del cparams
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phases 11 and 12: the hybrid and enc-dec families on the lockstep engine


def _never():
    raise AssertionError("the step's graph was captured already: no capture expected here")


def lockstep_run(label, eng, prompts, n, want, **frontend):
    """One lockstep ``generate`` of ``n`` tokens, the launch counters zeroed
    just before and read just after: each of ``want`` ({kernel: launches})
    exactly, ``n - 1`` replays of one capture, tokens in the vocabulary.
    Returns (summary, counts): tok/s with and without the graph's warm-up
    and capture, peak memory."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got, info = eng.generate(prompts, n, **frontend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cap = eng.graphs.capture_seconds
    b = got.shape[0]
    check(tuple(got.shape) == (len(prompts), n)
          and bool(((got >= 0) & (got < eng.cfg.vocab_size)).all()),
          f"{label}: bad output {tuple(got.shape)}")
    check((eng.graphs.entries(), eng.graphs.replays) == (1, n - 1),
          f"{label}: {eng.graphs.entries()} captures, {eng.graphs.replays} replays for "
          f"{n - 1} decode steps")
    for name, k in want.items():
        check(counts.get(name, 0) == k, f"{label}: {name} launched {counts.get(name, 0)} times, "
                                        f"expected {k}")
    log(f"{label}: {b} x {np.shape(prompts)[1]}-token prompts, {b * n} tokens in {wall:.3f}s = "
        f"{b * n / wall:.2f} tok/s ({b * n / (wall - cap):.2f} without the warm-up and capture, "
        f"{cap:.3f}s), cache_len {info['cache_len']}, max_memory_allocated={peak / 2**30:.2f} "
        f"GiB; launches {counts} [{CARD}]")
    return {"batch": b, "prompt_len": int(np.shape(prompts)[1]), "gen": n, "tokens": b * n,
            "wall_s": wall, "tok_per_s": b * n / wall, "capture_s": cap,
            "tok_per_s_without_capture": b * n / (wall - cap), "cache_len": info["cache_len"],
            "max_memory_allocated": peak, "launches": counts}, counts


def lockstep_replay_vs_eager(eng, state, label):
    """One decode step by replay of the engine's captured graph against the
    eager step from a copy of the same state (cache and token buffer): the
    step's output (greedy tokens or the sampling distribution) and every
    cache leaf after it bit-equal.  The replay advances ``state`` without
    its token buffer, so it is the state's last use."""
    import torch

    from repro_torch.models.param import tree_map

    def leaves(tree):
        for k in sorted(tree):
            yield from leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]]

    cache, tokens = tree_map(torch.clone, state.cache), state.tokens.clone()
    with torch.no_grad():
        eager = eng._step(cache, tokens, state.temperature)
        replays = eng.graphs.replays
        replay = eng.graphs.run(state.route, _never, _never)
    torch.cuda.synchronize()
    check(eng.graphs.replays == replays + 1 and eng.graphs.entries() == 1,
          f"{label}: the step did not replay its one graph")
    same_out = bool(torch.equal(replay, eager))
    same_cache = all(torch.equal(a, b) for a, b in zip(leaves(state.cache), leaves(cache)))
    diff = float((replay.float() - eager.float()).abs().max())
    log(f"{label}: replayed step vs eager step from a copy of its state: output bit-equal "
        f"{same_out} (max_abs {diff:.3e}), every cache leaf bit-equal {same_cache}")
    check(same_out and same_cache, f"{label}: the replayed step is not bit-equal to the eager "
                                   f"step (output {same_out}, cache {same_cache})")
    return same_out and same_cache


def prefill_vs_reference(label, model, cparams, tokens, max_len, want_flash, **frontend):
    """One prefill through the kernels (flash_star ``want_flash`` times)
    against the same prefill under ``ops.use(attention="reference")``:
    finite logits within rel_l2 < 3e-2 over the vocabulary's columns.
    Beside it, the same distance between two plain routes (``xla``, the
    online-blocked loop, against ``reference``): how far bf16 compute
    carries a difference in the order of attention's float32 sums through
    the model.  Returns both."""
    import torch

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts

    with torch.no_grad():
        reset_launch_counts()
        kern, _ = model.prefill(cparams, tokens, max_len, **frontend)
        pcounts = launch_counts()
        with ops.use(attention="reference"):
            ref, _ = model.prefill(cparams, tokens, max_len, **frontend)
        with ops.use(attention="xla"):
            plain, _ = model.prefill(cparams, tokens, max_len, **frontend)
    v = model.cfg.vocab_size
    kern, ref, plain = (x[..., :v].float() for x in (kern, ref, plain))
    check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
    check(pcounts.get("flash_star", 0) == want_flash, f"{label}: flash_star launched "
          f"{pcounts.get('flash_star', 0)} times, expected {want_flash}")
    rel = float((kern - ref).norm() / ref.norm())
    floor = float((plain - ref).norm() / ref.norm())
    log(f"{label}: logits, kernels vs reference attention: rel_l2={rel:.3e} "
        f"max_abs={float((kern - ref).abs().max()):.3e}; two plain routes (xla vs reference): "
        f"rel_l2={floor:.3e}")
    check(rel < 3e-2, f"{label}: logits differ from the reference: rel_l2={rel:.3e}")
    return rel, floor


def _full_width(arch):
    """The arch at its published widths on the kernels' route, its random
    float32 weights drawn on the card from the seed and cast once
    (``compute_params``; the float32 tree freed)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.param import compute_params, count_params, materialize
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    cparams = compute_params(params, cfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = count_params(model.param_specs())
    log(f"{cfg.name}: d={cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads} heads D "
        f"{cfg.resolved_head_dim} vocab {cfg.vocab_size} {n_params / 1e9:.3f}B params drawn and "
        f"cast once in {time.perf_counter() - t0:.3f}s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, model, cparams, n_params


def _note_paths(results, key, counts):
    for entry in results:
        entry.setdefault("launches_by_path", {})[key] = counts.get(entry["name"], 0)


def serve_hybrid(results):
    """Phase 11: recurrentgemma-2b at its published widths (26 layers: 8
    periods of (RG-LRU, RG-LRU, local attention) and 2 RG-LRU; d_model
    2560, 10 q heads over 1 KV head: D 256, G 10; window 2048; vocab
    256000), random weights cast to bf16 once (the RG-LRU gates' ``wa`` /
    ``wi`` / ``lam`` kept float32), after qwen2-vl's are freed, on the
    lockstep engine with the kernels.  4 x 512-token prompts, 32 new
    tokens, sampled at T 0.8 (the STAR softmax over 256000 columns once a
    step), then greedy; then a 4 x 3072-token greedy generate of 32 tokens
    (the window masks the prefill, the 2048-row rings wrap).  Counters
    zeroed just before and read just after each: flash_star 8 times a
    prefill and 8 a step (counted through the replays).  The sampled
    engine's time to first token, its steady step (wall, device busy, CUDA
    events), its replayed step bit-equal to the eager one; one 3072-token
    prefill against ``ops.use(attention="reference")`` within rel_l2 <
    3e-2."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, model, cparams, n_params = _full_width(HYBRID_ARCH)
    attn = model.num_periods * sum(k == "attention" for k in cfg.block_pattern) + sum(
        model._kind(i) == "attention" for i in range(model.tail))
    check(cfg.resolved_head_dim == 256 and attn == 8,
          f"recurrentgemma: D {cfg.resolved_head_dim}, {attn} attention blocks")
    rng = np.random.default_rng(SEED + 32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 512))
    long_prompts = rng.integers(0, cfg.vocab_size, (4, HYBRID_PREFILL))
    n = 32
    summary = {"params_b": n_params / 1e9, "card": CARD}
    with ops.use(softmax="pallas"), torch.no_grad():
        sc = ServeConfig(max_len=512 + n + 8, temperature=0.8)
        eng = ServeEngine(cfg, cparams, sc, device="cuda", seed=SEED)
        check_cast_once(eng, "recurrentgemma lockstep")
        eng.generate(prompts[:, :64], 2)  # warm-up: cuBLAS, the sampling kernel at this vocabulary
        ttft, step = lockstep_decode_step(
            eng, prompts, label="recurrentgemma decode step by replay, batch 4")
        summary["sampled"], counts = lockstep_run(
            "recurrentgemma lockstep 4 x 512 sampled T 0.8", eng, prompts, n,
            {"flash_star": attn * n, "star_softmax": n})
        summary["sampled"].update(ttft_s=ttft, decode_step=step)
        _note_paths(results, "hybrid_lockstep_sampled", counts)
        state = eng.begin(prompts)
        eng.decode(state)  # the capture
        summary["replay_bit_equal"] = lockstep_replay_vs_eager(
            eng, state, "recurrentgemma sampled step")
        greedy = ServeEngine(cfg, cparams, ServeConfig(max_len=512 + n + 8), device="cuda")
        summary["greedy"], counts = lockstep_run(
            "recurrentgemma lockstep 4 x 512 greedy", greedy, prompts, n,
            {"flash_star": attn * n, "star_softmax": 0})
        _note_paths(results, "hybrid_lockstep_greedy", counts)
        max_len = HYBRID_PREFILL + n + 8
        check(model.cache_len(max_len) == HYBRID_WINDOW, "recurrentgemma: the ring is not 2048 rows")
        longe = ServeEngine(cfg, cparams, ServeConfig(max_len=max_len), device="cuda")
        summary["long"], counts = lockstep_run(
            f"recurrentgemma lockstep 4 x {HYBRID_PREFILL} greedy (window {HYBRID_WINDOW} masks, "
            f"the ring wraps)", longe, long_prompts, n, {"flash_star": attn * n})
        _note_paths(results, "hybrid_lockstep_3072", counts)
    summary["prefill_rel_l2"], summary["prefill_rel_l2_plain_routes"] = prefill_vs_reference(
        f"recurrentgemma prefill 1 x {HYBRID_PREFILL}", model, cparams,
        torch.as_tensor(long_prompts[:1], device="cuda"), max_len, attn)
    del cparams, eng, greedy, longe
    torch.cuda.empty_cache()
    return summary


def serve_hybrid_f32(results):
    """Phase 11b: recurrentgemma-2b at its published widths computing in
    float32 (``compute_dtype="float32"``: the weights as drawn, no cast),
    attention ``pallas``: flash_star's float32 kernel at D 256 on the
    lockstep engine, after phase 11's bf16 weights are freed.  A 4 x 512
    greedy generate of 32 tokens and a 4 x 3072 one (the window of 2048
    masks the prefill, the 2048-row rings wrap), the counters zeroed just
    before and read just after each: flash_star 8 times a prefill and 8 a
    step, counted through the replays.  The 4 x 512 greedy tokens against
    the same generate under the float32 reference attention
    (``greedy_vs_reference``: a row that parts is recorded with its logit
    margin and fails unless at a near-tie).  One 1 x 3072 prefill against
    ``ops.use(attention="reference")`` within rel_l2 < 3e-2, the two plain
    routes' distance beside it: what phase 11's bf16 prefill (2.9e-2 from
    the reference, plain routes 2.8e-2 apart) becomes in float32.  Then the
    int8 P.V variant (``pv_int8=True`` in every attention layer): the 1 x
    3072 prefill in float32 within rel_l2 < 3e-2 of the float P.V kernel's
    (the variant's own error); then the weights cast to bf16 once and the
    bf16 prefill through it (8 ``flash_star_pv_int8`` launches, no
    ``flash_star``) against the float P.V kernel and against the int8 P.V's
    plain version (``plain_kernels``): within rel_l2 < 3e-2 of the plain
    version, and as far from the float P.V as the plain version is (within
    PV_INT8_SAME_DISTANCE of it)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import compute_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), attn_impl="pallas",
                              compute_dtype="float32")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    cparams = compute_params(params, cfg)
    torch.cuda.synchronize()
    attn = model.num_periods * sum(k == "attention" for k in cfg.block_pattern) + sum(
        model._kind(i) == "attention" for i in range(model.tail))
    check(cfg.resolved_head_dim == 256 and attn == 8 and
          all(t.dtype == torch.float32 for t in _leaves(cparams)),
          f"recurrentgemma float32: D {cfg.resolved_head_dim}, {attn} attention blocks")
    log(f"recurrentgemma float32: weights drawn in {time.perf_counter() - t0:.3f}s, memory "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED + 32)  # phase 11's prompts
    prompts = rng.integers(0, cfg.vocab_size, (4, 512))
    long_prompts = rng.integers(0, cfg.vocab_size, (4, HYBRID_PREFILL))
    n = 32
    summary = {"card": CARD, "compute_dtype": "float32"}
    with torch.no_grad():
        greedy = ServeEngine(cfg, cparams, ServeConfig(max_len=512 + n + 8), device="cuda")
        summary["greedy"], counts = lockstep_run(
            "recurrentgemma float32 lockstep 4 x 512 greedy", greedy, prompts, n,
            {"flash_star": attn * n, "flash_star_pv_int8": 0})
        _note_paths(results, "hybrid_f32_lockstep_greedy", counts)
        got, _ = greedy.generate(prompts, n)
        with ops.use(attention="reference"):
            ref_eng = ServeEngine(cfg, cparams, ServeConfig(max_len=512 + n + 8), device="cuda")
            want, _ = ref_eng.generate(prompts, n)
        max_len = HYBRID_PREFILL + n + 8
        longe = ServeEngine(cfg, cparams, ServeConfig(max_len=max_len), device="cuda")
        summary["long"], counts = lockstep_run(
            f"recurrentgemma float32 lockstep 4 x {HYBRID_PREFILL} greedy (window "
            f"{HYBRID_WINDOW} masks, the ring wraps)", longe, long_prompts, n,
            {"flash_star": attn * n})
        _note_paths(results, "hybrid_f32_lockstep_3072", counts)
    del greedy, ref_eng, longe
    summary["greedy_vs_reference"] = greedy_vs_reference(
        "recurrentgemma float32", model, cparams, prompts, got, want, cfg.vocab_size)
    tokens = torch.as_tensor(long_prompts[:1], device="cuda")
    summary["prefill_rel_l2"], summary["prefill_rel_l2_plain_routes"] = prefill_vs_reference(
        f"recurrentgemma float32 prefill 1 x {HYBRID_PREFILL}", model, cparams, tokens,
        max_len, attn)

    # the int8 P.V variant in float32 compute: its own distance from the float
    # P.V, with no bf16 drift on top
    icfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention_spec,
                                                                  pv_int8=True))
    check(icfg.attention_spec.pv_int8 and icfg.attention_spec.impl == "pallas",
          f"pv_int8 config resolves to {icfg.attention_spec}")
    with torch.no_grad():
        ref, _ = model.prefill(cparams, tokens, max_len)
        got, _ = build_model(icfg).prefill(cparams, tokens, max_len)
    v = cfg.vocab_size
    rel32 = _rel_l2(got[..., :v], ref[..., :v])
    log(f"recurrentgemma pv_int8 prefill, float32 compute: logits vs the float P.V kernel "
        f"rel_l2={rel32:.3e}")
    summary["prefill_pv_int8_float32_rel_l2"] = rel32
    del cparams, ref, got
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bicfg = dataclasses.replace(icfg, compute_dtype="bfloat16")
    bparams = compute_params(params, bcfg)
    del params
    torch.cuda.empty_cache()
    with torch.no_grad():
        ref, _ = build_model(bcfg).prefill(bparams, tokens, max_len)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, _ = build_model(bicfg).prefill(bparams, tokens, max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with plain_kernels():  # the same prefill through the int8 P.V's plain version
            plain, _ = build_model(bicfg).prefill(bparams, tokens, max_len)
    got, ref, plain = (x[..., :v].float() for x in (got, ref, plain))
    check(bool(torch.isfinite(got).all()), "recurrentgemma pv_int8 prefill: non-finite logits")
    rel, rel_plain, rel_kp = _rel_l2(got, ref), _rel_l2(plain, ref), _rel_l2(got, plain)
    log(f"recurrentgemma pv_int8 prefill: bf16, {HYBRID_PREFILL} tokens, {wall:.3f}s, launches "
        f"{counts}; logits vs the float P.V kernel rel_l2={rel:.3e} (the int8 P.V's plain "
        f"version: {rel_plain:.3e}; the kernel vs its plain version: {rel_kp:.3e})")
    check(counts.get("flash_star_pv_int8", 0) == attn and counts.get("flash_star", 0) == 0,
          f"recurrentgemma pv_int8 prefill: launches {counts}, expected flash_star_pv_int8 x "
          f"{attn}")
    # The int8 P.V's own distance from the float P.V is taken in float32
    # compute (rel32); in bf16 it adds to bf16's drift, which alone moves two
    # plain float routes ~2.8e-2 apart (phase 11), and the int8 P.V's plain
    # version lands as far as the kernel does.  So the kernel is held to its
    # plain version within the bound of every full-width kernel route here,
    # and to the same distance from the float P.V as its plain version.
    check(rel32 < 3e-2, f"recurrentgemma pv_int8 prefill (float32) differs from the float "
                        f"P.V: rel_l2={rel32:.3e}")
    check(rel_kp < 3e-2, f"recurrentgemma pv_int8 prefill: the kernel differs from its plain "
                         f"version: rel_l2={rel_kp:.3e}")
    check(abs(rel - rel_plain) <= PV_INT8_SAME_DISTANCE * rel_plain,
          f"recurrentgemma pv_int8 prefill: the kernel sits {rel:.3e} from the float P.V, its "
          f"plain version {rel_plain:.3e}")
    if rel >= 3e-2:
        log(f"recurrentgemma pv_int8 prefill, bf16: {rel:.3e} from the float P.V kernel, over "
            f"3e-2 (the int8 P.V's plain version: {rel_plain:.3e}; float32 compute: "
            f"{rel32:.3e}): a property of the int8 P.V in bf16 compute, not of the kernel")
    _note_paths(results, "hybrid_prefill_pv_int8", counts)
    summary["prefill_pv_int8"] = {"tokens": HYBRID_PREFILL, "wall_s": wall,
                                  "logits_rel_l2": rel, "plain_logits_rel_l2": rel_plain,
                                  "kernel_vs_plain_rel_l2": rel_kp}
    del bparams
    torch.cuda.empty_cache()
    return summary


def _rel_l2(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm())


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper runs its plain version on the card's tensors (as
    it does on CPU tensors) inside the block: the same path with no kernel."""
    from repro_torch.kernels import _cuda

    on_card = _cuda.on_card
    _cuda.on_card = lambda t: False
    try:
        yield
    finally:
        _cuda.on_card = on_card


def _leaves(tree):
    for k in sorted(tree):
        yield from _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]]


def serve_encdec(results):
    """Phase 12: seamless-m4t-large-v2 at its published widths (24 encoder
    and 24 decoder layers, d_model 1024, 16 / 16 heads: D 64; GELU MLP of
    8192; vocab 256206 padded to 256512), random weights cast to bf16 once,
    on the lockstep engine with the kernels: 4 x 256-token prompts, each
    row with [64, 1024] stub frames, 32 new tokens, sampled at T 0.8 (the
    STAR softmax over 256512 columns, 306 of them masked, once a step), then
    greedy.  Counters zeroed just before and read just after: flash_star 72
    times a prefill (24 encoder, 24 self, 24 cross) and 48 a step (self and
    cross).  The sampled engine's time to first token, its steady step, its
    replayed step bit-equal to the eager one; one prefill against
    ``ops.use(attention="reference")`` within rel_l2 < 3e-2."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, model, cparams, n_params = _full_width(ENCDEC_ARCH)
    ne, nd = cfg.num_layers, cfg.num_decoder_layers
    rng = np.random.default_rng(SEED + 33)
    prompts = rng.integers(0, cfg.vocab_size, (4, 256))
    src = rng.standard_normal((4, 64, cfg.frontend_dim)).astype(np.float32)
    n = 32
    per_prefill, per_step = ne + 2 * nd, 2 * nd
    want = per_prefill + per_step * (n - 1)
    summary = {"params_b": n_params / 1e9, "card": CARD}
    max_len = 256 + n + 8
    with ops.use(softmax="pallas"), torch.no_grad():
        eng = ServeEngine(cfg, cparams, ServeConfig(max_len=max_len, temperature=0.8),
                          device="cuda", seed=SEED)
        check_cast_once(eng, "seamless lockstep")
        eng.generate(prompts[:, :16], 2, src_embeds=src)  # warm-up
        ttft, step = lockstep_decode_step(
            eng, prompts, label="seamless decode step by replay, batch 4", src_embeds=src)
        summary["sampled"], counts = lockstep_run(
            "seamless lockstep 4 x 256 (+ 64 frames) sampled T 0.8", eng, prompts, n,
            {"flash_star": want, "star_softmax": n}, src_embeds=src)
        summary["sampled"].update(ttft_s=ttft, decode_step=step)
        _note_paths(results, "encdec_lockstep_sampled", counts)
        state = eng.begin(prompts, src_embeds=src)
        eng.decode(state)  # the capture
        summary["replay_bit_equal"] = lockstep_replay_vs_eager(eng, state, "seamless sampled step")
        greedy = ServeEngine(cfg, cparams, ServeConfig(max_len=max_len), device="cuda")
        summary["greedy"], counts = lockstep_run(
            "seamless lockstep 4 x 256 (+ 64 frames) greedy", greedy, prompts, n,
            {"flash_star": want, "star_softmax": 0}, src_embeds=src)
        _note_paths(results, "encdec_lockstep_greedy", counts)
    summary["prefill_rel_l2"], summary["prefill_rel_l2_plain_routes"] = prefill_vs_reference(
        "seamless prefill 4 x 256 (+ 64 frames)", model, cparams,
        torch.as_tensor(prompts, device="cuda"), max_len, per_prefill, src_embeds=src)
    del cparams, eng, greedy
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 13: train bert-base-star at its published widths


TRAIN_ARCH = "bert_base_star"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 512, 3e-4
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# 13b: a resumed run against an uninterrupted one.  Both runs do the same
# operations on the same data; where a device reduction adds in another order
# the results part by float32 rounding, so the final loss holds to
# RESUME_LOSS_RTOL and each parameter to RESUME_PARAM_FRAC x the peak lr (the
# CPU tests' bound for one Adam step; bit-equality is printed beside it)
RESUME_LOSS_RTOL = 1e-5
RESUME_PARAM_FRAC = 0.05
# 13c: the eval loss through flash_star's float32 kernel (3xTF32 products,
# another order of sums; a grid flip at a half-step moves one probability by
# a LUT step) against the plain route, relative
EVAL_LOSS_RTOL = 1e-4
# 13d: a greedy row of the kernel route that parts from the reference
# attention's must part at a near-tie: the reference's top-2 logit margin at
# that step at most this many times the two routes' largest logit difference
GREEDY_MARGIN_FACTOR = 10
TRAIN_SERVE_PROMPT, TRAIN_SERVE_GEN = 256, 32


def _train_config(steps):
    """The ``TrainConfig`` the train launcher runs for ``--steps``."""
    from repro_torch.launch.train import train_config

    return train_config(steps, TRAIN_LR)


def _device_batch(cfg, batch, seq, step):
    import torch

    from repro_torch.data.synthetic import make_batch

    return {k: torch.from_numpy(v).cuda() for k, v in
            make_batch(cfg, batch=batch, seq_len=seq, step=step).items()}


def train_full_width(cfg, model):
    """13a: ``run_train`` on the card, TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens, checkpoints every 10 steps into build/.  Every loss
    finite and the mean of the last 5 below the mean of the first 5 (the
    reference's ``test_loss_decreases``).  The step time (median over the
    steps after the first, host clock: the loop reads each step's metrics
    back), the first step apart, peak memory, and one more step traced
    (device busy share, time by kernel group).  Returns (summary, state)."""
    import numpy as np
    import torch

    from repro_torch.train.loop import LoopConfig, run_train
    from repro_torch.train.step import make_train_step

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_train(cfg, _train_config(TRAIN_STEPS),
                    LoopConfig(num_steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               ckpt_dir=str(TRAIN_CKPT / "a"), ckpt_every=10, log_every=5),
                    device="cuda", log_fn=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"bert train: {len(hist)} steps, losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"bert train: the loss did not fall (first 5 {first:.4f}, last 5 "
                        f"{last:.4f})")
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"bert-base-star train {TRAIN_STEPS} x {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{[round(x, 4) for x in losses]}; mean of the first 5 {first:.4f}, of the last 5 "
        f"{last:.4f}; step median {step_s * 1e3:.2f} ms (first step {hist[0]['seconds']:.3f} s) "
        f"= {tokens / step_s:.0f} tokens/s; run wall {wall:.2f}s with 2 checkpoints; "
        f"max_memory_allocated={peak / 2**30:.2f} GiB; tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}; "
        f"stragglers {len(res['stragglers'])} [{CARD}]")
    state = res["state"]
    step_fn = make_train_step(model, _train_config(TRAIN_STEPS))
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    prof = profile_window("bert train step (8 x 512, float32)", lambda: step_fn(state, batch))
    return {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses,
            "first5_mean": first, "last5_mean": last, "step_ms_median": step_s * 1e3,
            "first_step_s": hist[0]["seconds"], "tokens_per_s": tokens / step_s,
            "run_wall_s": wall, "max_memory_allocated": peak,
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "stragglers": res["stragglers"], "step_profile": prof}, state


def train_resume(cfg):
    """13b: a FailureInjector failure at step 8 of a 12-step run that
    checkpoints every 5 steps, then a resume from step 5, against an
    uninterrupted run: the final loss within RESUME_LOSS_RTOL and every
    parameter within RESUME_PARAM_FRAC x the peak lr (bit-equality
    printed)."""
    import torch

    from repro_torch.checkpoint import checkpointer
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.models.param import named_leaves
    from repro_torch.train.loop import LoopConfig, run_train

    n = 12
    tc = _train_config(n)
    lc = LoopConfig(num_steps=n, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    ckpt_dir=str(TRAIN_CKPT / "b"), ckpt_every=5, log_every=100)
    quiet = dict(device="cuda", log_fn=lambda *_: None)
    ref = run_train(cfg, tc, dataclasses.replace(lc, ckpt_dir=None), **quiet)
    try:
        run_train(cfg, tc, lc, failure_injector=FailureInjector(fail_at_step=8), **quiet)
        check(False, "bert resume: the injected failure did not fire")
    except RuntimeError as exc:
        check("injected failure at step 8" in str(exc), f"bert resume: {exc}")
    check(checkpointer.latest_step(lc.ckpt_dir) == 5, "bert resume: no checkpoint at step 5")
    logs = []
    t0 = time.perf_counter()
    res = run_train(cfg, tc, lc, device="cuda", log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check("[loop] resumed from step 5" in logs and res["final_step"] == n
          and len(res["history"]) == n - 5, f"bert resume: {logs[:2]}, {res['final_step']}")
    got, want = res["history"][-1]["loss"], ref["history"][-1]["loss"]
    pairs = list(zip(named_leaves(res["state"]["params"]), named_leaves(ref["state"]["params"])))
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in pairs)
    bitwise = got == want and all(torch.equal(a, b) for (_, a), (_, b) in pairs)
    log(f"bert resume: crash at step 8, resumed from step 5 (7 steps and 2 checkpoints in "
        f"{wall:.2f}s): final loss {got:.6f} vs uninterrupted {want:.6f} (|diff| "
        f"{abs(got - want):.3e}), parameters max |diff| {worst:.3e}; bit-equal {bitwise}")
    check(abs(got - want) <= RESUME_LOSS_RTOL * abs(want),
          f"bert resume: final loss {got} vs {want}")
    check(worst <= RESUME_PARAM_FRAC * TRAIN_LR, f"bert resume: parameters differ by {worst}")
    shutil.rmtree(TRAIN_CKPT / "b", ignore_errors=True)
    return {"final_loss": got, "uninterrupted_loss": want, "param_max_abs_diff": worst,
            "bit_equal": bitwise, "resume_wall_s": wall}


def train_eval(results, cfg, model, state):
    """13c: ``make_eval_step`` on one unseen batch of the trained state
    through flash_star's float32 kernel (``ops.use(attention="pallas")``,
    12 launches at q [8, 12, 512, 64]) and through the plain ``xla`` route:
    the losses within EVAL_LOSS_RTOL, the logits' distance printed.  (The
    kernel at that shape against its plain version, with its device time,
    bound and SDPA's: ``parity_flash_bert`` in phase 3.)"""
    import torch

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.step import make_eval_step

    eval_step = make_eval_step(model)
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS + 1)
    reset_launch_counts()
    with ops.use(attention="pallas"):
        kern = float(eval_step(state, batch))
    counts = launch_counts()
    plain = float(eval_step(state, batch))
    check(counts.get("flash_star", 0) == cfg.num_layers,
          f"bert eval: flash_star launched {counts.get('flash_star', 0)} times, expected "
          f"{cfg.num_layers}")
    with torch.no_grad():  # the logits behind the two losses
        with ops.use(attention="pallas"):
            lk = model.forward(state["params"], batch["tokens"])[..., :cfg.vocab_size]
        lp = model.forward(state["params"], batch["tokens"])[..., :cfg.vocab_size]
        rel = float((lk - lp).norm() / lp.norm())
        gap = float((lk - lp).abs().max())
    del lk, lp
    log(f"bert eval 8 x 512: loss through flash_star (float32 kernel) {kern:.6f}, plain xla "
        f"route {plain:.6f}, |diff| {abs(kern - plain):.3e} (bound {EVAL_LOSS_RTOL:g} x loss); "
        f"logits rel_l2 {rel:.3e} max_abs {gap:.3e}; launches {counts}")
    check(abs(kern - plain) <= EVAL_LOSS_RTOL * abs(plain),
          f"bert eval: kernel loss {kern} vs plain {plain}")
    _note_paths(results, "train_eval", counts)
    return {"loss_kernel": kern, "loss_plain": plain, "logits_rel_l2": rel,
            "logits_max_abs": gap, "launches": counts}


def greedy_vs_reference(label, model, params, prompts, got, want, vocab):
    """Greedy tokens of the kernel route (``got``) against the same generate
    under ``ops.use(attention="reference")`` (``want``): where a row parts,
    the step and the reference's top-2 logit margin there, which must stay
    within GREEDY_MARGIN_FACTOR x the two routes' largest logit difference
    at that position (a near-tie; anything else is a fault).  Returns the
    rows equal and the partings."""
    import numpy as np
    import torch

    from repro_torch import ops

    got, want = got.cpu().numpy(), want.cpu().numpy()
    parted = []
    for row in range(got.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size == 0:
            continue
        s = int(diff[0])
        seq = torch.as_tensor(np.concatenate([prompts[row], want[row, :s]])[None], device="cuda")
        with torch.no_grad():
            with ops.use(attention="reference"):
                lr_ = model.forward(params, seq)[0, -1, :vocab].float()
            with ops.use(attention="pallas"):
                lk = model.forward(params, seq)[0, -1, :vocab].float()
        top2 = torch.topk(lr_, 2).values
        margin, gap = float(top2[0] - top2[1]), float((lk - lr_).abs().max())
        parted.append({"row": row, "step": s, "ref_top2_margin": margin,
                       "logit_max_abs_diff": gap})
        log(f"{label} greedy row {row} parts from the reference attention at step {s}: the "
            f"reference's top-2 margin {margin:.3e}, the routes' largest logit difference "
            f"{gap:.3e}")
        check(margin <= GREEDY_MARGIN_FACTOR * gap,
              f"{label} greedy row {row}: parts at step {s} with a top-2 margin {margin:.3e} "
              f"over {GREEDY_MARGIN_FACTOR} x the logit difference {gap:.3e}")
    log(f"{label} greedy tokens, kernels vs reference attention: {got.shape[0] - len(parted)} "
        f"of {got.shape[0]} rows equal over {got.shape[1]} tokens")
    return {"rows_equal": got.shape[0] - len(parted), "rows": got.shape[0], "parted": parted}


def train_serve(results, cfg):
    """13d: the trained weights restored from 13a's last checkpoint, served
    on the lockstep engine with the kernels (attention ``pallas``: the
    float32 flash_star kernel at D 64; softmax ``pallas``: the STAR softmax
    in histogram mode, the config's): 4 x TRAIN_SERVE_PROMPT-token prompts
    of unseen synthetic data, TRAIN_SERVE_GEN new tokens, sampled at T 0.8,
    then greedy.  Counters zeroed just before and read just after:
    flash_star 12 a prefill and 12 a step, the STAR softmax once a sampled
    step.  The greedy tokens against the same generate under
    ``ops.use(attention="reference")``: where a row parts, the step and the
    reference's top-2 logit margin there, which must stay within
    GREEDY_MARGIN_FACTOR x the two routes' largest logit difference at that
    position.  The STAR softmax at the sampling row, [4, 30720] with its 198
    padded columns at -1e30, and at [4, 30522], histogram mode, bit-equal
    to its plain version."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.checkpoint import checkpointer
    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.star_softmax import kernel as sk
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train.state import state_specs

    scfg = dataclasses.replace(cfg, attn_impl="pallas")
    model = build_model(scfg)
    t0 = time.perf_counter()
    state, step = checkpointer.restore(str(TRAIN_CKPT / "a"), state_specs(model.param_specs()),
                                       device="cuda")
    torch.cuda.synchronize()
    log(f"bert serve: restored the step-{step} checkpoint in {time.perf_counter() - t0:.2f}s")
    check(step == TRAIN_STEPS, f"bert serve: restored step {step}")
    params = state["params"]
    del state
    from repro_torch.data.synthetic import make_batch

    prompts = make_batch(scfg, batch=4, seq_len=TRAIN_SERVE_PROMPT, step=10_000)["tokens"]
    n, layers = TRAIN_SERVE_GEN, cfg.num_layers
    max_len = TRAIN_SERVE_PROMPT + n + 8
    summary = {"restored_step": step}
    with ops.use(softmax="pallas"), torch.no_grad():
        eng = ServeEngine(scfg, params, ServeConfig(max_len=max_len, temperature=0.8),
                          device="cuda", seed=SEED)
        eng.generate(prompts[:, :16], 2)  # warm-up
        ttft, stepm = lockstep_decode_step(eng, prompts,
                                           label="bert-base-star decode step by replay, batch 4")
        summary["sampled"], counts = lockstep_run(
            f"bert-base-star lockstep 4 x {TRAIN_SERVE_PROMPT} sampled T 0.8", eng, prompts, n,
            {"flash_star": layers * n, "star_softmax_lut": n})
        summary["sampled"].update(ttft_s=ttft, decode_step=stepm)
        _note_paths(results, "train_serve_sampled", counts)
        greedy = ServeEngine(scfg, params, ServeConfig(max_len=max_len), device="cuda")
        summary["greedy"], counts = lockstep_run(
            f"bert-base-star lockstep 4 x {TRAIN_SERVE_PROMPT} greedy", greedy, prompts, n,
            {"flash_star": layers * n, "star_softmax_lut": 0})
        _note_paths(results, "train_serve_greedy", counts)
        got, _ = greedy.generate(prompts, n)
        with ops.use(attention="reference"):
            ref_eng = ServeEngine(scfg, params, ServeConfig(max_len=max_len), device="cuda")
            want, _ = ref_eng.generate(prompts, n)
    summary["greedy_vs_reference"] = greedy_vs_reference(
        "bert", model, params, prompts, got, want, cfg.vocab_size)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    variants = []
    for cols, pad in ((cfg.padded_vocab, cfg.padded_vocab - cfg.vocab_size), (cfg.vocab_size, 0)):
        x = torch.randn(4, cols, device=dev, generator=gen) * 4
        if pad:
            x[:, cols - pad:] = -1e30
        variants.append(_softmax_variant(
            f"star_softmax_lut histogram clean float32 [4, {cols}]"
            + (f" ({pad} columns at -1e30)" if pad else ""),
            lambda: sk.star_softmax_kernel(x, FMT, mode="histogram"),
            lambda: sk.star_softmax_ref(x, FMT, mode="histogram"), x,
            dict(dtype="float32", mode="histogram", fault=None,
                 bytes=x.numel() * (x.element_size() + 4) + 3 * FMT.num_levels * 4)))
        same = torch.equal(sk.star_softmax_kernel(x, FMT, mode="histogram"),
                           sk.star_softmax_ref(x, FMT, mode="histogram"))
        check(same, f"star_softmax histogram [4, {cols}]: not bit-equal to the plain version")
        variants[-1]["bit_equal"] = True
        log(f"star_softmax histogram [4, {cols}] f32: bit-equal to the plain version")
    next(e for e in results if e["name"] == "star_softmax_lut")["variants"] += variants
    del params, eng, greedy, ref_eng
    return summary


def train_bert(results):
    """Phase 13: bert-base-star trained at its published widths on the card
    (13a), a crashed and resumed run (13b), its eval through flash_star's
    float32 kernel (13c), and its restored weights served (13d)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.param import count_params
    from repro_torch.models.registry import build_model

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    n_params = count_params(model.param_specs())
    log(f"{cfg.name}: {cfg.num_layers} layers d={cfg.d_model} {cfg.num_heads} heads D "
        f"{cfg.resolved_head_dim} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}) "
        f"{n_params / 1e6:.1f}M float32 params, softmax {cfg.softmax_spec.kind} "
        f"{cfg.softmax_spec.mode} {cfg.softmax_spec.precision} = "
        f"{cfg.softmax_spec.fmt.short_name()}, attention {cfg.attention_spec.impl}, remat "
        f"{cfg.remat}")
    summary = {"params_m": n_params / 1e6, "card": CARD}
    summary["train"], state = train_full_width(cfg, model)
    summary["resume"] = train_resume(cfg)
    summary["eval"] = train_eval(results, cfg, model, state)
    del state
    torch.cuda.empty_cache()
    summary["serve"] = train_serve(results, cfg)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 14: the mesh on one card


MESH_STEPS = 5
# 14a: on one rank every shard is the whole tensor and every op runs on the
# same values, but DTensor may decompose an op otherwise (another order of
# float32 sums), so each step's loss holds to MESH_LOSS_RTOL relative (the
# resume bound; bit-equality printed)
MESH_LOSS_RTOL = RESUME_LOSS_RTOL
MESH_MOE_TOKENS = (4, 256)
MESH_REC_ATOL = 1e-6  # 14e: mean + new_err against g (the reference test's bound)
MESH_CKPT = ROOT / "build" / "mesh_ckpt"
# 14g: one smoke config of each family
MESH_FAMILY_ARCHS = ("granite_8b", "granite_moe_1b_a400m", "qwen2_vl_7b", "mamba2_130m",
                     "recurrentgemma_2b", "seamless_m4t_large_v2")
MESH_FAMILY_STEPS = 3


def _mesh_train(results, mesh):
    """14a-c: bert-base-star under the mesh against the same run without it,
    its eval through flash_star on the shards, its checkpoint restored
    without the mesh."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, is_dtensor, sharding_of, use_mesh_rules)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import named_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run_train
    from repro_torch.train.state import state_specs
    from repro_torch.train.step import make_eval_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    tc = _train_config(MESH_STEPS)
    lc = LoopConfig(num_steps=MESH_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, log_every=100)
    runs = {}
    for name, kw in (("plain", {"device": "cuda"}), ("mesh", {"mesh": mesh})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_train(cfg, tc, lc, log_fn=lambda *_: None, **kw)
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
    (plain, wall_p, peak_p), (sharded, wall_m, peak_m) = runs["plain"], runs["mesh"]
    lp = [h["loss"] for h in plain["history"]]
    lm = [h["loss"] for h in sharded["history"]]
    check(len(lm) == MESH_STEPS and all(np.isfinite(lm)), f"mesh train: losses {lm}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(lm, lp))
    step_p = statistics.median(h["seconds"] for h in plain["history"][1:])
    step_m = statistics.median(h["seconds"] for h in sharded["history"][1:])
    state = sharded["state"]
    leaves = named_leaves(state)
    check(all(is_dtensor(leaf) for _, leaf in leaves), "mesh train: a state leaf is no DTensor")
    log(f"mesh train bert-base-star {MESH_STEPS} x {TRAIN_BATCH} x {TRAIN_SEQ} on a (1, 1) mesh "
        f"({torch.distributed.get_backend()}, {len(leaves)} DTensor leaves): losses {lm}; without the mesh {lp}; max rel "
        f"diff {worst:.3e} (bound {MESH_LOSS_RTOL:g}), bit-equal {lm == lp}; step median "
        f"{step_m * 1e3:.2f} ms under the mesh vs {step_p * 1e3:.2f} ms without (first steps "
        f"{sharded['history'][0]['seconds']:.3f} / {plain['history'][0]['seconds']:.3f} s); "
        f"run wall {wall_m:.2f} / {wall_p:.2f} s; max_memory_allocated {peak_m / 2**30:.2f} / "
        f"{peak_p / 2**30:.2f} GiB [{CARD}]")
    check(worst <= MESH_LOSS_RTOL, f"mesh train: losses {lm} vs {lp}")
    summary = {"losses": lm, "losses_no_mesh": lp, "max_rel_diff": worst,
               "bit_equal": lm == lp, "step_ms_median": step_m * 1e3,
               "step_ms_median_no_mesh": step_p * 1e3, "run_wall_s": wall_m,
               "run_wall_s_no_mesh": wall_p, "max_memory_allocated": peak_m,
               "max_memory_allocated_no_mesh": peak_p}

    eval_step = make_eval_step(model)
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, MESH_STEPS + 1)
    dbatch = {k: sharding_of(("batch",) + (None,) * (v.ndim - 1), v.shape, DEFAULT_RULES, mesh)
              .place(v) for k, v in batch.items()}
    with ops.use(attention="pallas"):
        want = float(eval_step(plain["state"], batch))
        with use_mesh_rules(mesh):
            reset_launch_counts()
            got = eval_step(state, dbatch)
            counts = launch_counts()
    got = float(got.full_tensor())
    log(f"mesh eval {TRAIN_BATCH} x {TRAIN_SEQ} through flash_star (float32 kernel) on the shards: loss {got:.6f}, "
        f"the unsharded run's {want:.6f}, |diff| {abs(got - want):.3e} (bound "
        f"{EVAL_LOSS_RTOL:g} x loss); launches {counts}")
    check(counts.get("flash_star", 0) == cfg.num_layers,
          f"mesh eval: flash_star launched {counts.get('flash_star', 0)} times")
    check(abs(got - want) <= EVAL_LOSS_RTOL * abs(want), f"mesh eval: loss {got} vs {want}")
    _note_paths(results, "mesh_eval", counts)
    summary["eval"] = {"loss": got, "loss_no_mesh": want, "launches": counts}

    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    checkpointer.save(str(MESH_CKPT), MESH_STEPS, state)
    restored, step = checkpointer.restore(str(MESH_CKPT), state_specs(model.param_specs()),
                                          device="cuda")
    same = step == MESH_STEPS and all(
        not is_dtensor(b) and torch.equal(a.full_tensor(), b)
        for (_, a), (_, b) in zip(leaves, named_leaves(restored)))
    log(f"mesh checkpoint: saved under the mesh, restored without it: bit-equal {same}")
    check(same, "mesh checkpoint: the restored state differs from the sharded one")
    summary["checkpoint_bit_equal"] = same
    shutil.rmtree(MESH_CKPT, ignore_errors=True)
    return summary


def _mesh_moe(results, mesh):
    """14d: granite-moe-1b-a400m at full width, experts over "model", a
    forward under the mesh with the router and attention on the kernels."""
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, distribute, param_shardings, sharding_of, use_mesh_rules)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import materialize
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_impl="pallas", moe_style="ep")
    model = build_model(cfg)
    nl = cfg.num_layers
    specs = model.param_specs()
    params = materialize(specs, SEED, "cuda")
    dparams = distribute(params, param_shardings(specs, DEFAULT_RULES, mesh))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    toks = torch.randint(0, cfg.vocab_size, MESH_MOE_TOKENS, generator=gen, device="cuda")
    dtoks = sharding_of(("batch", "seq"), toks.shape, DEFAULT_RULES, mesh).place(toks)
    wi = dparams["blocks"]["moe"]["wi"]
    with torch.no_grad(), ops.use(softmax="pallas", attention="pallas"):
        want = model.forward(params, toks)
        with use_mesh_rules(mesh):
            reset_launch_counts()
            got = model.forward(dparams, dtoks)
            counts = launch_counts()
    got = got.full_tensor()
    atol, rtol = tolerance(want.dtype)
    err = float((got.float() - want.float()).abs().max())
    bad = int(((got.float() - want.float()).abs() > atol + rtol * want.float().abs()).sum())
    log(f"mesh moe ep: {MOE_ARCH} {nl}L {cfg.num_experts} experts top-{cfg.top_k}, wi "
        f"{tuple(wi.shape)} placed {[str(p) for p in wi.placements]}; forward "
        f"{list(MESH_MOE_TOKENS)} under the mesh: launches {counts}; logits {want.dtype} vs the "
        f"forward without the mesh max_abs {err:.3e}, {bad} outside |d| <= {atol:g} + {rtol:g} "
        f"|ref|, bit-equal {torch.equal(got, want)}")
    check(counts.get("star_softmax", 0) == nl,
          f"mesh moe: the router kernel launched {counts.get('star_softmax', 0)} times, not {nl}")
    check(counts.get("flash_star", 0) == nl,
          f"mesh moe: flash_star launched {counts.get('flash_star', 0)} times, not {nl}")
    check(bad == 0 and bool(got.isfinite().all()), f"mesh moe: {bad} logits outside tolerance")
    _note_paths(results, "mesh_moe_ep", counts)
    return {"launches": counts, "logits_max_abs": err, "bit_equal": bool(torch.equal(got, want))}


def _mesh_families(mesh):
    """14g: every family's smoke config trains MESH_FAMILY_STEPS steps under
    the mesh, each loss within MESH_LOSS_RTOL of the same steps without it
    (bit-equality printed): the ops that run on shards (the SSD and RG-LRU
    scans, the causal conv, the MoE block, cross-attention) on the card's
    torch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import LoopConfig, run_train

    tc = _train_config(MESH_FAMILY_STEPS)
    lc = LoopConfig(num_steps=MESH_FAMILY_STEPS, batch=4, seq_len=32, log_every=100)
    out = {}
    for arch in MESH_FAMILY_ARCHS:
        cfg = get_smoke_config(arch)
        runs = [[h["loss"] for h in run_train(cfg, tc, lc, log_fn=lambda *_: None, **kw)
                 ["history"]] for kw in ({"mesh": mesh}, {"device": "cuda"})]
        worst = max(abs(a - b) / abs(b) for a, b in zip(*runs))
        out[arch] = {"losses": runs[0], "losses_no_mesh": runs[1], "max_rel_diff": worst}
        check(worst <= MESH_LOSS_RTOL, f"mesh {arch}: losses {runs[0]} vs {runs[1]}")
    log(f"mesh smoke training, {MESH_FAMILY_STEPS} steps of 4 x 32 a family under the mesh vs "
        f"without: " + "; ".join(f"{a} max rel diff {v['max_rel_diff']:.3e} bit-equal "
                                 f"{v['losses'] == v['losses_no_mesh']}" for a, v in out.items()))
    return out


def mesh_one_card(results):
    """Phase 14: the mesh on one card (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import compressed_grad_allreduce, init_error_state
    from repro_torch.distributed.pipeline_parallel import pipeline_apply
    from repro_torch.launch.mesh import init_process_group, make_mesh

    log("mesh: one card, one rank; a mesh across cards waits for a four-card machine (not run "
        "here: the CPU tests run 4 gloo ranks at (2, 2) against the reference)")
    init_process_group("cuda", store=dist.HashStore())
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        check(dist.get_backend() == "nccl", f"mesh: backend {dist.get_backend()}")
        summary = {"card": CARD, "backend": dist.get_backend()}
        summary["train"] = _mesh_train(results, mesh)
        torch.cuda.empty_cache()
        summary["moe_ep"] = _mesh_moe(results, mesh)
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        g = {"wq": torch.randn(12, 768, 768, device="cuda", generator=gen) * 1e-2,
             "table": torch.randn(30720, 768, device="cuda", generator=gen) * 1e-3}
        mean, err = compressed_grad_allreduce(g, init_error_state(g), mesh, axis="data")
        rec = max(float((mean[k] + err[k] - g[k]).abs().max()) for k in g)
        log(f"mesh compressed all-reduce, one rank: max |mean + new_err - g| {rec:.3e} (bound "
            f"{MESH_REC_ATOL:g})")
        check(rec <= MESH_REC_ATOL, f"mesh all-reduce: reconstruction {rec}")
        summary["allreduce_reconstruction"] = rec

        smesh = make_mesh((1,), ("stage",), "cuda")
        w = torch.randn(1, 1024, 1024, device="cuda", generator=gen) * 0.03
        x = torch.randn(4, 8, 1024, device="cuda", generator=gen)
        out = pipeline_apply(lambda h, wt: torch.tanh(h @ wt), w, x, smesh, axis="stage")
        seq = torch.stack([torch.tanh(x[t] @ w[0]) for t in range(x.shape[0])])
        same = bool(torch.equal(out, seq))
        log(f"mesh pipeline, one stage, 4 microbatches [8, 1024]: bit-equal to the sequential "
            f"loop {same}")
        check(same, "mesh pipeline: one stage differs from the sequential loop")
        summary["pipeline_bit_equal"] = same
        summary["families"] = _mesh_families(mesh)
    finally:
        dist.destroy_process_group()
    return summary


# ---------------------------------------------------------------------------
# phase 15: the dry-run tools, decode over a row-sharded cache, the
# sequence-parallel projection


DRYRUN_CELLS = (("mamba2_130m", "decode_32k"), ("granite_8b", "decode_32k"),
                ("qwen2_vl_7b", "train_4k"))
DRYRUN_CELL_TIMEOUT = 420  # seconds a dry-run cell may take
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"
KVSEQ_ARCH = "granite_8b"
KVSEQ_PROMPT, KVSEQ_MAX_LEN, KVSEQ_STEPS = (4, 96), 128, 4
ACCOUNT_PEAK_GAP = 0.25  # 15d: a larger gap is a finding, printed


def dryrun_cells_start():
    """15c: every dry-run cell started as its own subprocess, its output
    written to files (a pipe nobody reads until later could fill and stall
    the cell)."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "single", "--out", str(DRYRUN_OUT)]
        with open(DRYRUN_OUT / f"{arch}_{shape}.out", "w") as so, \
                open(DRYRUN_OUT / f"{arch}_{shape}.err", "w") as se:
            procs[(arch, shape)] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=so,
                                                     stderr=se), time.perf_counter())
    return procs


def dryrun_cells_finish(procs):
    """15c: each cell's record, its summary line printed; a cell that fails
    or passes its time limit fails the phase (every process is ended)."""
    out, failed = {}, []
    for (arch, shape), (proc, t0) in procs.items():
        try:
            proc.wait(timeout=max(1.0, DRYRUN_CELL_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failed.append(f"{arch} {shape}: over {DRYRUN_CELL_TIMEOUT}s")
            continue
        lines = (DRYRUN_OUT / f"{arch}_{shape}.out").read_text().strip().splitlines()
        if proc.returncode != 0 or not lines:
            err = (DRYRUN_OUT / f"{arch}_{shape}.err").read_text().strip().splitlines()
            failed.append(f"{arch} {shape}: rc {proc.returncode}: {(err or ['?'])[-1][:300]}")
            continue
        with open(DRYRUN_OUT / f"{arch}_{shape}_single.json") as f:
            rec = json.load(f)
        log(f"dryrun {arch} {shape} ({rec['wall_s']:.1f}s): {lines[-1]}")
        out[f"{arch}/{shape}"] = {k: rec.get(k) for k in (
            "chips", "step", "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
            "peak_bytes_per_dev", "dominant", "cache_all_gathers", "compile_s", "torch")}
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
    check(not failed, f"dryrun: {failed}")
    gathers = out["granite_8b/decode_32k"]["cache_all_gathers"]
    log(f"dryrun granite_8b decode_32k over the kv_seq-sharded cache: {gathers} all-gathers "
        f"of a cache leaf")
    check(gathers == 0, f"dryrun granite decode gathered its cache {gathers} times")
    for key, rec in out.items():
        check(rec["chips"] == 256 and rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0,
              f"dryrun {key}: {rec}")
    return out


def kv_seq_decode_one_card(results):
    """15b: the decode over a "kv_seq"-placed cache on a one-rank mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, distribute, param_shardings, sharding_of, use_mesh_rules)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model

    init_process_group("cuda", store=dist.HashStore())
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        cfg = get_smoke_config(KVSEQ_ARCH)
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention,
                                                                     impl="pallas"))
        model = build_model(cfg)
        specs = model.param_specs()
        params = materialize(specs, SEED, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        b, t = KVSEQ_PROMPT
        toks = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device="cuda")
        steps = torch.randint(0, cfg.vocab_size, (KVSEQ_STEPS, b, 1), generator=gen,
                              device="cuda")
        with torch.no_grad():
            _, cache = model.prefill(params, toks, KVSEQ_MAX_LEN)
            dcache = distribute(tree_map(torch.clone, cache),
                                param_shardings(model.cache_spec(b, KVSEQ_MAX_LEN),
                                                DEFAULT_RULES, mesh))
            want = torch.stack([model.decode_step(params, cache, s)[0] for s in steps])
            dparams = distribute(params, param_shardings(specs, DEFAULT_RULES, mesh))
            with use_mesh_rules(mesh, DEFAULT_RULES):
                dsteps = [sharding_of(("batch", None), s.shape, DEFAULT_RULES, mesh).place(s)
                          for s in steps]
                reset_launch_counts()
                got = [model.decode_step(dparams, dcache, s)[0] for s in dsteps]
                counts = launch_counts()
            got = torch.stack([g.full_tensor() for g in got])
        placed = [str(p) for p in dcache["layers"]["k"].placements]
        atol, rtol = tolerance(want.dtype)
        err = float((got - want).abs().max())
        bad = int(((got - want).abs() > atol + rtol * want.abs()).sum())
        kv_err = float((dcache["layers"]["k"].full_tensor() - cache["layers"]["k"]).abs().max())
        n = KVSEQ_STEPS * cfg.num_layers
        log(f"kv_seq decode: {cfg.name} impl pallas, cache {list(cache['layers']['k'].shape)} "
            f"placed {placed} on a (1, 1) mesh, {KVSEQ_STEPS} steps: launches {counts} "
            f"(flash_star {n} wanted); logits vs the decode without the mesh max_abs {err:.3e}, "
            f"{bad} outside |d| <= {atol:g} + {rtol:g} |ref|, bit-equal "
            f"{torch.equal(got, want)}; cache k max_abs {kv_err:.3e} [{CARD}]")
        check(placed == ["S(1)", "S(2)"], f"kv_seq decode: cache placed {placed}")
        check(counts.get("flash_star", 0) == n,
              f"kv_seq decode: flash_star launched {counts.get('flash_star', 0)}, not {n}")
        check(bad == 0 and kv_err <= atol, f"kv_seq decode: {bad} logits outside tolerance")
        _note_paths(results, "kv_seq_decode_mesh", counts)
        return {"launches": counts, "logits_max_abs": err, "cache_k_max_abs": kv_err,
                "bit_equal": bool(torch.equal(got, want))}
    finally:
        dist.destroy_process_group()


def accounting_on_card():
    """15d: the fake trace's FLOPs and peak against the real step's."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch.dryrun import fake_mesh, trace_cell
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    state = init_state(model.param_specs(), SEED, device="cuda")
    batch = _device_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    step = make_train_step(model, TrainConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    real_flops = fc.get_total_flops()
    del out, state, batch
    torch.cuda.empty_cache()
    try:
        mesh = fake_mesh((1, 1), ("data", "model"), "cuda")
        t = trace_cell(cfg, ShapeConfig("bert_train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
                       DEFAULT_RULES, "cuda")
    finally:
        dist.destroy_process_group()
    fake_peak = t["argument_size_in_bytes"] + t["counter"].peak
    gap = fake_peak / peak - 1.0
    log(f"accounting: {cfg.name} train step {TRAIN_BATCH} x {TRAIN_SEQ}: FLOPs fake "
        f"{t['counter'].flops} vs FlopCounterMode on the card {real_flops} (equal "
        f"{t['counter'].flops == real_flops}); peak live bytes fake {fake_peak} "
        f"({t['argument_size_in_bytes']} arguments + {t['counter'].peak} temporaries) vs "
        f"max_memory_allocated {peak}: gap {gap * 100:+.1f}% [{CARD}]")
    if abs(gap) > ACCOUNT_PEAK_GAP:
        log(f"accounting: finding: the fake peak is {gap * 100:+.1f}% off the card's, over the "
            f"{ACCOUNT_PEAK_GAP:.0%} the dry-run's memory column is read with")
    check(t["counter"].flops == real_flops,
          f"accounting: fake FLOPs {t['counter'].flops} != card {real_flops}")
    return {"flops_fake": t["counter"].flops, "flops_card": real_flops,
            "peak_fake": fake_peak, "peak_card": peak, "peak_gap": gap,
            "bytes_fake": t["counter"].bytes, "trace_s": t["trace_s"]}


def dryrun_phase(results):
    """Phase 15 (see the module docstring)."""
    procs = dryrun_cells_start()
    summary = {"card": CARD}
    try:
        r = subprocess.run([sys.executable, str(ROOT / "tools" / "mesh_seq_parallel.py")],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        for line in r.stdout.strip().splitlines():
            log(f"seq-parallel tool: {line}")
        check(r.returncode == 0, f"tools/mesh_seq_parallel.py rc {r.returncode}: "
                                 f"{r.stderr.strip()[-600:]}")
        summary["seq_parallel_tool"] = r.stdout.strip().splitlines()
        summary["kv_seq_decode"] = kv_seq_decode_one_card(results)
        import torch

        torch.cuda.empty_cache()
        summary["accounting"] = accounting_on_card()
        summary["dryrun"] = dryrun_cells_finish(procs)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
    return summary


EXAMPLE_TIMEOUT = 300  # seconds the quickstart may take


def examples_on_card():
    """Phase 16: ``examples/torch_quickstart.py`` run on the card as a user
    runs it (its own process, the kernels' libraries already built); it
    must exit 0 with "OK" as its last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
                          capture_output=True, text=True, env=env, cwd=str(ROOT),
                          timeout=EXAMPLE_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log(f"  torch_quickstart: {line}")
    check(proc.returncode == 0 and lines and lines[-1] == "OK",
          f"torch_quickstart.py on the card: exit {proc.returncode}, last line "
          f"{lines[-1] if lines else None!r}; stderr {proc.stderr[-2000:]}")
    log(f"examples/torch_quickstart.py on the card: OK in {wall:.1f}s")
    return {"torch_quickstart": {"ok": True, "wall_s": wall}}


# ---------------------------------------------------------------------------
# phase 17: the paper's swept formats (9 bits down to 2)

SWEPT_FORMATS = ((6, 3), (6, 2), (5, 2), (5, 1), (4, 1), (3, 1), (2, 1), (1, 1))
# the block route (2 to 5 bits) timed at these beside the one-pass route at 8 bits
ROUTE_TIMED = ((1, 1), (2, 1), (6, 2))
BLOCKED_DESIGN = {
    "flash_star_blocked": "KV blocks of block_k rows from row 0, each walked twice (its max, "
                          "then P and P.V); QK^T and P.V as the one-pass kernel of the type",
    "paged_attention_blocked": "grid indices (K only), a scan over the pages (M_p, R_p), the "
                               "weighted split P.V (V only), the combine at r = 1"}
SWEEP_CLAIMS = dict(exact_min=90.0, near_points=2.0)  # accuracy_bitwidth.main's assertions


def _route_device_ms(call, fmt, times):
    """Device ms of ``call`` where ``fmt`` is one of ROUTE_TIMED (None otherwise)."""
    if fmt is None or (fmt.int_bits, fmt.frac_bits) not in ROUTE_TIMED:
        return None
    dev = device_ms_each_once(call)
    times[fmt.short_name()] = dev
    return dev


def formats_flash(results):
    """flash_star bf16 and float32 at granite's prefill (q [1, 32, 512, 128]
    causal) and the dense `Tq = 1` decode, and the int8 P.V variant (bf16,
    block_k 128) at both, each at the 8 swept formats against its
    plain version (chip_smoke's tolerances and ambiguous-row rule).  At 2 to
    5 bits the wrapper runs the block route, counted as
    ``flash_star_blocked``; its device times at u2 and u3 beside the
    one-pass kernel's at u8."""
    import torch

    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.lut import clamp_is_negligible
    from repro_torch.kernels.flash_star import kernel as fk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    shapes = {}
    b, hq, hkv, t, d = 1, 32, 8, 512, 128
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, hq, t, t)
    shapes["prefill"] = (base, torch.tensor([0, t], dtype=torch.int32, device=dev), live, True)
    tk = DECODE_ROWS
    dbase = [torch.randn(sh, device=dev, generator=gen) for sh in
             ((4, hq, 1, d), (4, hkv, tk, d), (4, hkv, tk, d))]
    dinfo = torch.tensor([0, *DECODE_VALID], dtype=torch.int32, device=dev)
    cols = torch.arange(tk, device=dev)
    dlive = (cols[None, :] < dinfo[1:, None])[:, None, None, :].expand(4, hq, 1, tk)
    shapes["decode"] = (dbase, dinfo, dlive, False)
    variants, times = [], {}
    for label, (sbase, info, slive, causal) in shapes.items():
        n_live = int(slive.sum())
        kv_rows = int(slive.any(dim=2).any(dim=1).sum())
        for dtype, pv8 in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)):
            q, k, v = (x.to(dtype) for x in sbase)
            kr = k.double().repeat_interleave(hq // hkv, dim=1)
            scores64 = (q.double() @ kr.transpose(-1, -2)) * d ** -0.5
            for bits in SWEPT_FORMATS:
                fmt = FixedPointFormat(*bits)
                kw = dict(fmt=fmt, causal=causal, block_k=128, pv_int8=pv8)
                blocked = not pv8 and not clamp_is_negligible(fmt, k.shape[2])
                name = (f"formats flash_star{' pv_int8' if pv8 else ''} {label} "
                        f"{str(dtype).split('.')[-1]} {fmt.short_name()}")
                counter = (fk.PV_INT8_LAUNCHES if pv8 else
                           fk.BLOCKED_LAUNCHES if blocked else fk.LAUNCHES)
                before = counter.count
                got = fk.flash_star_attention(q, k, v, info, **kw)
                check(counter.count == before + 1,
                      f"{name}: expected one {counter.name} launch")
                ref = fk.flash_star_ref(q, k, v, info, **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
                amb = _pv_int8_ambiguous(scores64, slive, 128, fmt) if pv8 else None
                err, flips = compare_rows(name, got, ref, dtype, scores64, slive, fmt.scale,
                                          amb=amb)
                call = lambda: fk.flash_star_attention(q, k, v, info, **kw)  # noqa: E731
                variant = dict(shape=label, dtype=str(dtype).split(".")[-1], pv_int8=pv8,
                               format=fmt.short_name(), route="block" if blocked else "one-pass",
                               max_abs_err=err, flip_rows=flips)
                if not pv8:
                    variant["device_ms"] = _route_device_ms(call, fmt, times.setdefault(
                        f"{label} {variant['dtype']}", {}))
                if blocked and label == "prefill" and dtype == torch.bfloat16 and bits == (2, 1):
                    variant.update(ms=time_ms(call),
                                   plain_ms=time_ms(lambda: fk.flash_star_ref(q, k, v, info, **kw)),
                                   library_ms=None)
                    flops = 4 * n_live * d
                    nbytes = (2 * q.numel() + 2 * hkv * kv_rows * d) * q.element_size() + 4 * info.numel()
                    main = (variant, nbytes, flops)
                variants.append(variant)
                log(f"{name}: route={variant['route']} max_abs_err={err:.3e} flip_rows={flips} "
                    f"device_ms={variant.get('device_ms')}")
    for key, by_fmt in times.items():
        log(f"formats flash_star {key} device ms by format (block route at u2 / u3, one-pass "
            f"at u8): {by_fmt}")
    variant, nbytes, flops = main
    results.append(_entry(
        "flash_star_blocked", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:216", variant, nbytes, flops, H100_BF16_FLOPS,
        variants, shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal, block_k 128, "
                        f"u3 (2i.1f), bf16; and the Tq = 1 dense decode"))
    results[-1].update(design=BLOCKED_DESIGN["flash_star_blocked"], device_ms_by_format=times,
                       device_ms=variant.get("device_ms"))


def formats_paged(results):
    """The paged kernel at the full-width tick's shape (S 4, Hq 32, Hkv 8, D
    128, bs 16, lens 514/386/258/130, W 34) over float32 and bf16 pages of
    q's type and int8 / fp8_e4m3 codes (bf16 q), at the 8 swept formats
    against its plain version.  At 2 to 5 bits it runs the block route,
    counted as ``paged_attention_blocked``; device times of both routes."""
    import torch

    from repro_torch.core import kvquant
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.lut import clamp_is_negligible
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import gather_pages

    hq, hkv, d, bs = 32, 8, 128, 16
    lens, w = PAGED_SHAPES["tick"]
    s = len(lens)
    n = s * w + 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((s, hq, d), (n, bs, hkv, d), (n, bs, hkv, d))]
    tables = (torch.randperm(n - 1, device=dev, generator=gen)[: s * w] + 1)
    tables = tables.reshape(s, w).to(torch.int32).contiguous()
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    cols = torch.arange(w * bs, device=dev)
    live = (cols[None, :] < valid[:, None])[:, None, :].expand(s, hq, w * bs)
    live_pages = sum(-(-x // bs) for x in lens)
    pools = {}
    for pool, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        pools[pool] = (dtype, base[1].to(dtype), base[2].to(dtype), {}, dtype.itemsize, 0)
    for kv_dtype in ("int8", "fp8_e4m3"):
        kc, ks = kvquant.quantize_blocks(base[1], kv_dtype)
        vc, vs = kvquant.quantize_blocks(base[2], kv_dtype)
        pools[kv_dtype] = (torch.bfloat16, kc, vc, dict(k_scale=ks, v_scale=vs), 1, live_pages)
    variants, times, main = [], {}, None
    for pool, (dtype, kp, vp, kw_pages, elem, scaled) in pools.items():
        q = base[0].to(dtype)
        kdq = kvquant.decode(kp, kw_pages["k_scale"][:, None, :, None]) if kw_pages else kp
        k64 = gather_pages(kdq, kdq, tables)[0].double().repeat_interleave(hq // hkv, 2)
        scores64 = torch.einsum("shd,sthd->sht", q.double(), k64) * d ** -0.5
        nbytes, flops = _paged_work(q, lens, w, hkv, elem, scaled)
        for bits in SWEPT_FORMATS:
            fmt = FixedPointFormat(*bits)
            blocked = not clamp_is_negligible(fmt, w * bs)
            name = f"formats paged {pool} pages tick {fmt.short_name()}"
            kw = dict(fmt=fmt, **kw_pages)
            counter = (pk.BLOCKED_LAUNCHES if blocked else
                       pk.LAUNCHES_QUANT if kw_pages else pk.LAUNCHES)
            before = counter.count
            call = lambda: pk.paged_flash_attention(q, kp, vp, tables, valid, **kw)  # noqa: E731
            got = call()
            check(counter.count == before + 1, f"{name}: expected one {counter.name} launch")
            ref = pk.paged_attention_ref(q, kp, vp, tables, valid, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
            err, flips = compare_rows(name, got, ref, dtype, scores64, live, fmt.scale)
            variant = dict(pool=pool, dtype=str(dtype).split(".")[-1], format=fmt.short_name(),
                           route="block" if blocked else "one-pass", max_abs_err=err,
                           flip_rows=flips)
            if bits in ROUTE_TIMED:
                variant["device_ms"] = _route_device_ms(call, fmt, times.setdefault(pool, {}))
            if blocked and pool == "bfloat16" and bits == (2, 1):
                variant.update(ms=time_ms(call), library_ms=None,
                               plain_ms=time_ms(lambda: pk.paged_attention_ref(
                                   q, kp, vp, tables, valid, **kw)))
                main = (variant, nbytes, flops)
            variants.append(variant)
            log(f"{name}: route={variant['route']} max_abs_err={err:.3e} flip_rows={flips} "
                f"device_ms={variant.get('device_ms')}")
    for pool, by_fmt in times.items():
        log(f"formats paged {pool} pages device ms by format (block route at u2 / u3, one-pass "
            f"at u8): {by_fmt}")
    variant, nbytes, flops = main
    results.append(_entry(
        "paged_attention_blocked", "cuda",
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:222", variant, nbytes, flops,
        H100_FP32_FLOPS, variants,
        shape=f"S={s} Hq={hq} Hkv={hkv} D={d} bs={bs} lens {lens} W {w}; main: bf16 pages, u3"))
    results[-1].update(design=BLOCKED_DESIGN["paged_attention_blocked"],
                       device_ms_by_format=times, device_ms=variant.get("device_ms"))


def formats_softmax():
    """The STAR softmax kernel at [4, 49152] float32 (300 columns at -inf),
    every mode, at the 8 swept formats: within 1e-5 |plain| + 1e-9 of its
    plain version (the softmax takes no block schedule: two passes)."""
    import torch

    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.kernels.star_softmax import kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    x = torch.randn(4, 49152, device="cuda", generator=gen) * 4
    x[:, :300] = -float("inf")
    worst = {}
    for mode in ("gather", "onehot", "histogram"):
        for bits in SWEPT_FORMATS:
            fmt = FixedPointFormat(*bits)
            got = sk.star_softmax_kernel(x, fmt, mode=mode)
            ref = sk.star_softmax_ref(x, fmt, mode=mode)
            err = (got - ref).abs()
            check(bool((err <= 1e-5 * ref.abs() + 1e-9).all()),
                  f"formats star_softmax {mode} {fmt.short_name()}: max err {float(err.max()):.3e}")
            worst[f"{mode} {fmt.short_name()}"] = float(err.max())
    log(f"formats star_softmax [4, 49152] every mode at the 8 formats: max errors {worst}")
    return worst


def formats_smoke_serve():
    """The granite-8b smoke config at 3 bits (2i.1f) on the paged continuous
    engine, card vs CPU greedy tokens.  Counters zeroed just before and read
    just after on the card: the block routes only (``flash_star_blocked``
    once per layer of every prefill, ``paged_attention_blocked`` once per
    layer of every tick, counted through the replays), never the one-pass
    kernels."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg, devices = _smoke_pair("granite_8b")
    cfg = dataclasses.replace(cfg, softmax_int_bits=2, softmax_frac_bits=1)
    rng = np.random.default_rng(SEED + 43)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in (19, 10, 27, 6)]
    gens = [6, 8, 5, 7]
    outs, counts, card = {}, None, None
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
                num_slots=2, max_len=48, kv_layout="paged", kv_block_size=4), device=dev)
            reset_launch_counts()
            outs[dev] = eng.serve(prompts, gens)
            if dev == "cuda":
                counts, card = launch_counts(), eng
    check(outs["cuda"] == outs["cpu"],
          f"formats smoke u3: greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    nl = cfg.num_layers
    calls = int(card.metrics.counter("serve.prefill.calls").value())
    want = {"flash_star_blocked": nl * calls, "paged_attention_blocked": nl * card.ticks,
            "flash_star": 0, "paged_attention": 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"formats smoke u3: {name} launched "
              f"{counts.get(name, 0)} times, expected {n}")
    log(f"formats smoke granite u3 paged serve: greedy tokens identical on card and cpu "
        f"({sum(len(o) for o in outs['cpu'])} tokens); launches {counts}")
    return counts


def formats_sweep():
    """``examples/torch_precision_sweep.py`` on the card: the reference's
    table (exact >= 90 %, 7-9 bits within 2 points of exact, 2 bits more
    than 2 points under) and the sweep's launches (the block route at 2 to
    5 bits, the one-pass float32 kernel at 6 to 9 and exact)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_precision_sweep.py")],
                          capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log(f"  torch_precision_sweep: {line}")
    check(proc.returncode == 0, f"torch_precision_sweep.py on the card: exit {proc.returncode}; "
                                f"stderr {proc.stderr[-2000:]}")
    acc = {}
    for line in lines:
        m = re.fullmatch(r"\s*(exact|\d+b \(\d+i\.\d+f\))\s+([\d.]+)%\s+([\d.]+)", line)
        if m:
            acc[m.group(1)] = float(m.group(2))
    check(len(acc) == 9, f"torch_precision_sweep: expected 9 table rows, got {acc}")
    exact = acc["exact"]
    check(exact >= SWEEP_CLAIMS["exact_min"], f"torch_precision_sweep: exact {exact} %")
    for name in ("7b (5i.2f)", "8b (6i.2f)", "9b (6i.3f)"):
        check(acc[name] >= exact - SWEEP_CLAIMS["near_points"],
              f"torch_precision_sweep: {name} {acc[name]} % vs exact {exact} %")
    check(acc["2b (1i.1f)"] < exact - SWEEP_CLAIMS["near_points"],
          f"torch_precision_sweep: 2b {acc['2b (1i.1f)']} % is not under exact {exact} %")
    launches = json.loads(lines[-1].split("launches: ", 1)[1])
    for name in ("flash_star_blocked", "flash_star", "star_softmax"):
        check(launches.get(name, 0) > 0, f"torch_precision_sweep: no {name} launch ({launches})")
    log(f"examples/torch_precision_sweep.py on the card: {acc}, launches {launches}, "
        f"{wall:.1f}s")
    return {"accuracy_pct": acc, "launches": launches, "wall_s": wall}


def formats_phase(results):
    formats_flash(results)
    formats_paged(results)
    softmax = formats_softmax()
    counts = formats_smoke_serve()
    for entry in results[-2:]:
        entry["launches"] = counts.get(entry["name"], 0)
        entry["launches_by_path"] = {"smoke_u3_paged_serve": entry["launches"]}
    sweep = formats_sweep()
    results[-2]["launches_by_path"]["precision_sweep"] = sweep["launches"].get(
        "flash_star_blocked", 0)
    return {"softmax_max_err": softmax, "smoke_u3_launches": counts, "sweep": sweep}


def main() -> int:
    src = ROOT / "src" / "repro_torch"
    if not src.is_dir():
        print(f"chip_smoke: {src} not found: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CARD
    card = CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    try:  # only for the header: the port runs no Triton kernel
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton_version} device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.flash_star import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.kernels.star_softmax import kernel as sk

    with phase("2 build"):
        t0 = time.perf_counter()
        logs = _cuda.build([fk.SOURCE, pk.SOURCE, sk.LUT_SOURCE, xk.SOURCE, ssk.SOURCE])
        log(f"build: {time.perf_counter() - t0:.1f}s (nvcc, all five sources at once)")
        for path, text in logs.items():
            for func, lines in ptxas_by_function(text).items():
                log(f"  {path.name} {func}: {'; '.join(lines)}")
        check_mma_build(logs[fk.SOURCE], _cuda.library_path(fk.SOURCE))
        check_tc_build(logs[fk.SOURCE], _cuda.library_path(fk.SOURCE))
        check_paged_build(logs[pk.SOURCE])
        check_ssd_build(logs[ssk.SOURCE], _cuda.library_path(ssk.SOURCE))
        check_crossbar_build(logs[xk.SOURCE], _cuda.library_path(xk.SOURCE))
        check_softmax_build(logs[sk.LUT_SOURCE])

    results = []
    with phase("3 parity"):
        parity_flash(results)
        parity_pv_int8(results)
        parity_flash_new(results)
        parity_flash_d256(results)
        parity_flash_bert(results)
        parity_paged(results)
        parity_paged_new(results)
        parity_softmax(results)
        parity_softmax_lut(results)
        router = parity_softmax_router()
        next(e for e in results if e["name"] == "star_softmax")["router_variants"] = router
        parity_ssd_scan(results)
        realization_bits()
    with phase("4 small reference"):
        f32_launches = small_reference()
        flash = next(e for e in results if e["name"] == "flash_star")
        flash["launches_float32_smoke"] = f32_launches
        flash["launches_float32_smoke_dense"] = small_reference_dense()
        small_reference_mamba()
        small_reference_moe()
        smoke_paths = {**small_reference_vlm(), **small_reference_archs(),
                       **small_reference_hybrid_encdec(), "eos": small_reference_eos()}
    with phase("5 serve"):
        summary, params, cparams = serve(results)
    for entry in results:
        entry["launches_by_path"].update(
            {f"smoke {k}": v.get(entry["name"], 0) for k, v in smoke_paths.items()})
    with phase("5b dense serve"):
        summary_dense = serve_dense(results, cparams)
    with phase("5c eos serve"):
        summary_eos = serve_eos(results, cparams)
    with phase("6 int8 serve"):
        summary_quant = serve_quant(results, cparams)
    with phase("7 degraded serve"):
        summary_degraded = degraded_serve(results, params, cparams)
    del params, cparams
    torch.cuda.empty_cache()
    with phase("8 mamba2 serve"):
        summary_mamba = serve_mamba(results)
    with phase("9 moe serve"):
        summary_moe = serve_moe(results)
    with phase("10 vlm serve"):
        summary_vlm = serve_vlm(results)
    with phase("11 hybrid serve"):
        summary_hybrid = serve_hybrid(results)
    with phase("11b hybrid float32 serve"):
        summary_hybrid["float32"] = serve_hybrid_f32(results)
    with phase("12 encdec serve"):
        summary_encdec = serve_encdec(results)
    with phase("13 train"):
        summary_train = train_bert(results)
    with phase("14 mesh"):
        summary_mesh = mesh_one_card(results)
    with phase("15 dryrun"):
        summary_dryrun = dryrun_phase(results)
    with phase("16 examples"):
        summary_examples = examples_on_card()
    with phase("17 formats"):
        summary_formats = formats_phase(results)
    for entry in results:
        check(entry["launches"] > 0, f"{entry['name']} never launched on the main path")
    log(f"profiler: {len(PROFILES_RETAKEN)} windows profiled again for lost records: "
        f"{PROFILES_RETAKEN}")
    log(json.dumps({"serve": summary, "serve_dense": summary_dense, "serve_eos": summary_eos,
                    "serve_int8": summary_quant,
                    "serve_degraded": summary_degraded, "serve_mamba2": summary_mamba,
                    "serve_moe": summary_moe, "serve_vlm": summary_vlm,
                    "serve_hybrid": summary_hybrid, "serve_encdec": summary_encdec,
                    "train": summary_train, "mesh": summary_mesh, "dryrun": summary_dryrun,
                    "examples": summary_examples, "formats": summary_formats,
                    "phase_seconds": PHASE_SECONDS, "card": card}))
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(3)
