#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) into build/kernels/.
  2. kernels — hold each kernel against its plain PyTorch version on the card:
               the fused dequant-GEMM (f32 activations: relative error
               <= 2e-5, f32 summation order; bf16: <= 2^-7 * max|y|, one
               bf16 ulp at the max) at Qwen2-7B's shapes and the main
               paths' row counts (1 to 8 rows, the Server's buckets and
               chunks, the Engine's prefill; the decode GEMV also at 3, 5
               and 6 bits), both GEMVs' (every width on the tensor cores in
               bf16; qmatmul.cu's GEMV, TF32 on the tensor cores, on bf16 x
               whose scale blocks split a group of 4 codes and on f32 x at
               every width, 1 to 8 rows, rows as stored with word tails and
               odd blocks, kernel_bench's and Qwen2-7B's shapes, each case
               gated on its launch, and a row bit-identical alone and among
               8 rows) and
               the tensor-core GEMM's edges (3 to 8 bits) and split-K
               shapes and the paper sweep's shapes, the KV dequant
               (bit-exact: one leaf, a layer's K and V in one launch, and
               through a page map), the blockwise encode (bit-exact codes
               and scale bits at blocks of 1 to 2048, on midpoints, ±0 and
               subnormals), the encode to the stored form (bit-exact words
               and scale bits) and the fused decode attention over the
               packed cache (<= 2^-6 * max|out| per row and head), also at
               a position a row with idle rows (exactly 0), and over a paged
               cache (pages of 8, 16 and 64, a shuffled page map with shared
               pages, holes and idle rows): bit-identical to the unpaged
               kernel on the same cache gathered into rows; the routed read
               (the shapes kv_attention.fused_takes refuses: head dims 56
               and 120, a 40,960-slot cache at Qwen2-7B's heads) within the
               same 2^-6, idle rows 0, paged bit-identical to rows, one KV
               dequant launch each and the fused wrapper raising first;
               the routed read over a wrapped 4096-slot ring and window
               (kv4 and kv8, h2o-danube-3-4b's Dh 120 and gemma2-27b's Dh
               128 with its soft-cap, a shared position and a position a
               row, an idle row exactly 0) and the fused attention at
               gemma2's global layers' shape; B1 and the encode to the
               stored form at the windows and ssm phases' matrices and row
               counts (mamba2's in_proj of 3352 rows, off the GEMV's
               16-column blocks; jamba's in_proj, out_proj, MLP and head);
               the expert-batched GEMV at the MoE archs' expert shapes,
               jamba's 16 experts of 14336 x 4096 and 4096 x 14336 among
               them; B1 and the encode to the stored form at the seq2seq
               phase's matrices (seamless-m4t-large-v2's 1024 x 1024, 1024 x
               8192, 8192 x 1024 and its 256,206-row head) at 1, 4 and 8
               rows (GEMV) and 9, 260 and 4096 rows (GEMM).
  3. serve   — Qwen2-7B at full width and depth, seeded random weights
               quantized on the card (4-bit float, block 64; one
               quantize_pack launch per quantized matrix), Engine with a
               kv4 cache: 4 prompts x 256 tokens, 32 greedy tokens, each
               decode step a replay of the captured step.  Checks the
               captured step's tokens against eager lm.decode_step calls
               at kv16, kv8 and kv4 (identical), sampled tokens and the
               generator's state against eager steps from the same seed
               (identical; one captured step for every temperature), no
               host sync inside the captured body, finite logits and the
               kernel launches of one eager decode step and of one replay
               (every GEMV on the tensor cores, qgemv_sm90; one fused
               attention a layer and no standalone KV dequant).  A replay
               adds its kernels' launches to the wrappers' counters.
  3f. windows — (run right after the kernels phase, on an empty card)
               h2o-danube-3-4b at full width and depth (24 layers, a 4096
               window on every one, head dim 120) and gemma2-27b (46 layers
               alternating local and global, sandwich norms, soft-caps 50
               and 30, a tied 256,000-token head), seeded bf16 weights
               quantized on the card (4-bit float, block 64; one
               quantize_pack an item): the Engine on 2 prompts of 4160
               tokens (the prefill wraps every ring) in caches of 4224,
               graph tokens = eager ones, rings of 4096 slots, one replay's
               launches (danube kv4: 169 GEMVs, 24 KV dequants, 0 fused;
               gemma2: 322 GEMVs, 23 fused attentions, 23 KV dequants), the
               step on the card and by the host clock, prefill s,
               quantize_s and peak memory; danube's ring gate (kv16,
               dequant_einsum, decode steps past the window against
               lm.backbone_seq's logits: over the rings at most 0.08 further
               off than over the same K/V in linear caches); danube's Server (kv4, 4
               slots of 4352, 12 requests of 64-4200 tokens at exact
               length, two classes, a wrapped ring preempted and restored
               bit for bit, each request within 0.08 of the per-request
               Engine, paged and prefill_chunk refused before a launch);
               gemma2's fused vs dequant_einsum gap and its tied head's
               share of the step.
  3g. moe    — (right after the windows phase, on an empty card)
               moonshot-v1-16b-a3b at full width and depth (48 layers, d
               2048, 64 experts of width 1408, top-6, vocab 163,840), seeded
               bf16 weights quantized on the card an expert matrix at a time
               (9,409 quantize_pack launches; init and quantize peaks, the
               expert stacks' 35 GB f32 draws made a layer at a time): the
               Engine at kv4 on 4 prompts of 256 (16 dispatch groups a
               prefill, a prefill GEMM an expert that holds a token), 32 new:
               graph tokens = eager ones, no host sync, one replay 144
               expert-batched GEMVs + 193 GEMVs + 48 fused attentions, the
               experts that hold a token a layer, the step on the card and by
               the host clock, one step's expert GEMVs beside their bound, the
               plain version and torch.bmm over the active experts' bf16
               weights; fused vs dequant_einsum logits within 0.5 with the
               router flips counted (held on same-route logits where flips
               alone break it); the Server at kv4 on 8 slots of 576 over 16
               requests (bucketed prefills with the router pad mask, one
               prompt of 320 that runs 16 dispatch groups at its exact
               length), and on pages of 16 (the same tokens): each request's
               decode logits equal to the per-request Engine's (gap 0.0)
               where its exact-length prefill runs one dispatch group, the
               grouped request's gap reported.  phi3.5-moe at full width,
               depth 8 of 32: the Engine at kv4 on 2 x 256, 16 new, graph =
               eager, and fused vs dequant_einsum.  The kernels phase holds
               the expert-batched GEMV at both archs' expert shapes (4 and 3
               bits, experts of 0, 1 and 8 rows) bit-identical to per-expert
               launches of the tensor-core GEMV and within a bf16 ulp of its
               plain version.
  3h. ssm    — (right after the moe phase, on an empty card)
               mamba2-130m at full width and depth (24 SSM layers, d 768,
               d_inner 1536, 24 SSD heads of 64, state 128, SSD chunks of
               256, a tied 50,280-row head), seeded bf16 weights quantized on
               the card (48 quantize_pack launches): the Engine on 4 prompts
               of 1024 (4 SSD chunks each), 32 new: graph tokens = eager
               ones, no host sync, one replay 48 tensor-core GEMVs, 0 fused
               attentions and 0 KV dequants (the tied head a dense product in
               column pieces), the step on the card and by the host clock and
               its GEMVs alone beside their bound, prefill s, quantize_s and
               peaks; each SSM layer's decode steps against its sequence mode
               on the same f32 input (within 3e-2, state and conv 2e-2, the
               reference's bars); the model's decode-vs-forward gap
               (reported) and fused vs dequant_einsum within 0.5; the Server
               on 8 slots of 1344 over 16 requests at exact length (16-256
               tokens and 512, 768, 1024: the SSD chunk rule), then two
               classes with preemption (the same tokens, each spilled state
               and conv restored bit for bit), paged and prefill_chunk
               refused before a launch, each request's decode logits within
               0.08 of the per-request Engine's (gap reported).
               jamba-v0.1-52b at full width, depth 8 of 32 (one period:
               attention with an MLP, seven SSM layers, MoE at 1, 3, 5 and
               7), its init and quantize peaks; the Engine at kv4 on 2 x
               1024, 16 new: graph = eager, one replay 31 GEMVs, 12
               expert-batched GEMVs and 1 fused attention, the experts that
               hold a token; fused vs dequant_einsum as the moe phase gates.
  3i. seq2seq — (right after the ssm phase, on an empty card)
               seamless-m4t-large-v2 at full width and depth (24 encoder and
               24 decoder layers, d 1024, 16 heads of 64, a gated-GELU MLP of
               8192, LayerNorm, an untied 256,206-row head) through
               models/seq2seq.py, seeded bf16 weights quantized on the card
               (434 quantize_pack launches and nothing else): 4 sources of
               1024 stub frames, a decoder prefix of 2 tokens, 64 greedy
               tokens, each step seq2seq.decode_step at a 0-d device
               position.  Gates the prefill's launches (217 tensor-core
               GEMMs: the encoder's 169 and the cross K/V's 48 at 4096
               rows; 217 tensor-core GEMVs: the decoder's 216 at 8 rows and
               the head at 4) and a decode step's (217 GEMVs, nothing else:
               no fused attention, no KV dequant: the bf16 caches go through
               the plain partials, as the reference's); one step captured
               with serving.engine.capture_graph, no host sync in its body,
               its replay's logits equal to the eager step's bit for bit and
               its launches the step's; finite logits, tokens in range;
               teacher-forced fused vs dequant_einsum logits within 0.5; the
               decode-vs-forward gap (the prefill and decode steps against
               decoder_seq + logits_from_hidden over the same tokens) with
               both stacks cut to 2, 4 and 8 layers within the reference's
               0.05 of the reference's own gap at that depth and width (on
               the CPU, scripts/seq2seq_gaps_reference.py), the full depth's
               reported.  Reports the prefill and the step on
               the card and by the host clock, the step's GEMVs alone beside
               their bound and its attention reads' share, init and
               quantize times and peaks.
  3a. bits   — the serve phase's Engine at 3, 5 and 6 bits (the same seeded
               weights quantized at each width in turn, each freed before the
               next): captured-step tokens identical to eager ones, one replay
               197 tensor-core GEMVs, 0 CUDA-core ones and 28 fused
               attentions, fused vs dequant_einsum logits within 0.5; each
               width's step of GEMVs timed beside its bound, the CUDA-core
               GEMV on the same operands and torch.matmul on the bf16 weights,
               and its prefill's GEMMs as the path runs them (K padded to
               whole words at every call) beside rows padded beforehand and
               that copy alone.
  3k. audit  — (run last, after the times phase, so that its captures
               come after every other phase's; on the serve phase's tree)
               reprolint's captured-graph auditor
               (src/repro_torch/analysis/audit.py): tiny-160k at kv16, kv8
               and kv4 through the Engine (two batch sizes), the slot
               Server with a forced preemption, the chunked and the paged
               Server (a remap sweep with preemptions) and the 4-bit float
               b64 fused slot Server, then Qwen2-7B: the Engine's batch-4
               decode graph and the Server's pool graph (8 slots, a forced
               preemption).  Each captured step is dumped as DOT
               (build/audit/) and gated: no host node and no host memcpy,
               no host sync while capturing, every buffer at its
               capture-time address after the workload and no growth over
               50 replays, the eager spill, restore and page wipe in the
               pool's own storage with peak memory under one slot's rows,
               each hand-written kernel's nodes equal to its recorded
               launches (Qwen2-7B: 197 tensor-core GEMVs and 28 fused
               attentions a graph), one capture a Server and a batch size.
               Prints every verdict, the full-width graphs' kernel nodes by
               family and the phase's seconds.
  3b. server — the continuous-batching Server on the same weights with a kv4
               cache and 8 slots: 24 requests of 16-512 prompt tokens and
               16-64 new tokens with staggered arrivals, plain, with
               prefill chunks of 128 and with two priority classes and
               preemption.  Checks every request answered, slot invariants
               at every token, chunked and preempted tokens identical to
               the plain run's, spill and restore bit-exact, each request
               teacher-forced through the Engine's step at batch 1 (logits
               within 0.08, a differing greedy token a near-tie) and one
               decode step over the pool's launches.
  3j. profile — the step profiler (serving/profiler.py, utils/cost.py) on
               the serve phase's Qwen2-7B tree: the Engine with
               Telemetry(profiler=StepProfiler()) on the same 4 x 256
               prompts, 32 greedy tokens, three generates: tokens and the
               launches of a generate equal to the unprofiled run's, one
               replay's launches the unprofiled step's, rows for
               prefill[4x256] and decode_step[4]; every row's roofline_frac
               in (0, 1], decode_step[4]'s bytes at least the stored bytes
               of its 197 matrices, prefill[4x256]'s dot FLOPs the analytic
               2·M·N·K sum of its matrices plus its causal attention; the
               server phase's 24 requests through a profiled Server, plain
               and in chunks of 128: tokens the unprofiled run's, a plain
               run's launches the server phase's, one replay's the step's,
               rows for prefill[*], prefill_chunk[*], chunk_commit[*] and
               decode_step; tiny-10m's prefill and decode step at kv4 (the
               routed read) costed on the CPU and on the card: flops,
               dot_flops and the charged share equal, hbm_bytes within 1 %;
               compress_tree on a gradient tree of tiny-160k on the card
               (two steps, the error fed back) bit-identical to its plain
               version on the CPU, one flat-encode launch a leaf of 1,024
               values or more, and tiny-650k trained 150 steps (batch 32,
               sequence 128) with 8-bit gradient compression, its loss down
               by MIN_LOSS_DROP; python -m repro_torch.examples.quickstart
               exits 0.  Prints each row and the phase's seconds.
  3c. paged  — the same Server on the paged pool (pages of 16): the server
               phase's 24 requests at kv4, the first 8 at kv8 and kv16, and
               the two classes with preemption, tokens identical to the slot
               pool's, every restore bit-exact, no page left after a drain,
               197 GEMVs and 28 fused attentions a replay, no host sync in
               the captured step; then 16 requests over two shared 512-token
               prefixes on fewer pages than 8 unshared residents need: 8
               residents at once, COW hits, the slot pool's tokens.
  3d. routed — tiny-10m (head dim 56, which the fused attention does not
               take), its weights quantized on the card, at kv4 and kv8:
               the Engine's captured-step tokens identical to eager ones,
               whose logits equal those of the plain read bit for bit,
               one KV dequant launch a layer and step and no fused
               attention, no host sync in the captured step,
               kv_oracle_logit_gap (gated at kv8; kv4 reported), the step's and its
               routed reads' device times; the Server on 4 slots and on
               pages of 16 over 12 requests: pages give the slots' tokens,
               each request within 0.08 of the Engine's step at batch 1.
  3l. mesh   — serving on a 1x1 ("data", "model") mesh: a world of one rank
               (NCCL, a file:// rendezvous) and Sharder(make_mesh(1, 1),
               replicate_params_below=0) on the serve phase's Qwen2-7B tree.
               The sharded Engine at kv16, kv8 and kv4 (4 x 256, 32 greedy
               tokens): prefill and decode logits and tokens equal bit for
               bit the unsharded prefill and lm.decode_step reading every
               layer through the routed read (the combine's correction is
               exp(0) = 1 and the collectives of one rank copy), graph
               tokens = those eager ones; kv16 tokens = the unsharded
               Engine's; kv8 and kv4's teacher-forced gap to the bf16
               oracle over 16 steps reported beside KV_LOGIT_TOL.  The sharded Server on
               8 kv4 slots of 576 over the server phase's first 8 requests:
               each request's tokens = the sharded batch-1 Engine's.
               `torch.distributed.run --standalone --nproc-per-node 1 -m
               repro_torch.launch.serve --mesh 1x1 --kv-bits 4` exits 0.
               The sharded captured step through analysis/audit.py: no
               host node, no host memcpy, no host sync, 197 GEMV and 28 KV
               dequant nodes, NCCL's kernel and copy nodes counted.
               Prints the step's device and host ms beside the unsharded
               one's (fused attention) and the unsharded step over the
               routed read, its nodes, prefill s, the Server's tokens/s
               and TTFT.  Preemption: the sharded Server on 4 kv4 slots
               with max_preemptions 2 over the server phase's first 4
               background and first 4 urgent requests (its two priority
               classes): at least one preemption, each request's tokens =
               the unsharded preempted Server's (its step over the routed
               read) and the sharded batch-1 Engine's, kv_spill_bytes_total
               = the unsharded Server's (a whole row a spill).  The step
               profiler: the sharded Engine and the sharded 8-slot Server
               with Telemetry(profiler=StepProfiler()), tokens as
               unprofiled, every roofline_frac in (0, 1], each program's dot
               FLOPs = the unsharded program's the profile phase costed
               (decode_step[4], prefill[4x256], the Server's decode_step and
               prefill buckets); FLOPs, bytes and collective bytes printed
               beside the unsharded ones.
  3m. train mesh — training on a 1x1 mesh (a world of one rank, NCCL;
               Sharder(make_mesh(1, 1), replicate_params_below=0), the
               train state stored FSDP's way): Qwen2-7B at full width cut to
               depth 4 (2.02 B parameters), bf16 master weights, remat, 8-bit
               gradient compression, 2 steps of 4 x 512 random tokens in 2
               microbatches, unsharded and then sharded from the same seeded
               init (the state donated): loss, grad norm and every parameter
               after each step equal bit for bit (at one rank every
               collective is a copy or nothing); the sharded steps'
               flat-encode launches = steps x compressed leaves.  tiny-650k
               trained 150 steps on the mesh with 8-bit compression (loss
               down by MIN_LOSS_DROP, a flat encode a compressed leaf and
               step), its sharded state saved through CheckpointManager
               (gathered whole, rank 0 writing) and read back into an
               unsharded TrainState, through launch/elastic.remesh_state and
               onto the mesh: each equal to the saved state bit for bit.
               (Qwen2-7B's 28.3 GB state took ~180 s through the manager on
               an H100 machine's host, past the phase's time: PERF.md.)  Prints
               each step's device ms (CUDA events around it) and host ms,
               sharded and unsharded.
  3n. moe/ssm mesh — mixture-of-experts, SSM and hybrid decoders on a 1x1
               mesh (a world of one rank, NCCL; Sharder(make_mesh(1, 1),
               cfg, replicate_params_below=0)), seeded bf16 weights quantized
               on the card: moonshot-v1-16b-a3b at full width cut to depth 8
               of 48 (4 x 256, 32 new tokens, kv4), mamba2-130m at full
               width and depth (the ssm phase's 4 x 1024 prompts, 32 new) and
               jamba-v0.1-52b at full width cut to depth 8 (2 x 1024, 16 new,
               kv4).  Each sharded Engine: no host sync in its captured step,
               one replay's launches (3 expert-batched GEMVs an MoE layer, the
               GEMVs of the attention, SSM, MLP projections and head, a KV
               dequant an attention layer: a mesh reads the routed way),
               prefill and decode logits and the prefill's caches (the SSM
               state and conv too) bit for bit the unsharded prefill's and
               lm.decode_step's over the routed read, graph tokens = those
               eager ones (mamba2: = the unsharded Engine's), the step's
               device and host ms sharded and unsharded, the captured step
               through analysis/audit.audit_generate (no host node, memcpy
               or sync).  The sharded Server on 8 kv4 slots over the first 8
               of the moe phase's one-group requests (moonshot) and on 8
               slots over the ssm phase's first 8 (mamba2): each request's
               tokens = the sharded batch-1 Engine's.  Training moonshot at
               full width cut to depth 2 and mamba2 at full depth as 3m
               trains (bf16 masters, remat, 8-bit compression, 2 steps of 4 x
               512 in 2 microbatches), unsharded then sharded from one init:
               loss, grad norm and every parameter equal bit for bit; the
               sharded steps' flat encodes = steps x compressed leaves.
               The kernels phase also holds the expert-batched GEMV on a
               rank's slice of moonshot's expert stack (experts 16-31 of 64,
               their own storage, local counts) bit for bit against the
               whole-stack launch: the launch a "model" axis of 4 makes.
  3o. encdec mesh — the encoder-decoder on a 1x1 mesh (a world of one
               rank, NCCL; Sharder(make_mesh(1, 1), cfg,
               replicate_params_below=0)): seamless-m4t-large-v2 at full
               width and depth (24 + 24 layers, d 1024, vocab 256,206),
               seeded bf16 weights quantized on the card (434 quantize_pack
               launches), the seq2seq phase's traffic (4 sources of 1024
               stub frames, the prefix of 2, 64 greedy tokens): the sharded
               seq2seq.prefill and decode_step (the sharder's constrain,
               q_pad, decode_attn_fn and cross_attn_fn; the caches placed by
               shard_caches) launch what the seq2seq phase's do (217 GEMMs
               + 217 GEMVs, then 217 GEMVs a step) and equal the unsharded
               ones bit for bit: logits, tokens, the self and the cross
               caches.  The step captured sharded (through
               analysis/audit.py: no host node or sync, 217 GEMV nodes,
               NCCL's kernel and copy nodes counted; replay = eager bit for
               bit) and unsharded: device and host ms, timed in turn
               (sharded, unsharded, twice).
               Training: the tree cut to 2 encoder and 2 decoder layers at
               full width (bf16 masters, remat, 8-bit compression, 2
               microbatches), one batch's gradients unsharded and on the
               mesh bit for bit, then 2 steps of 4 x (1024 frames, 256
               tokens) unsharded and on the mesh: loss, grad norm and every
               parameter after each step bit for bit, the sharded steps'
               flat encodes = steps x compressed leaves.  Prints each step's
               device and host ms, sharded and unsharded.
  3p. dryrun — the dry-run (launch/specs.py, launch/dryrun.py) in a
               subprocess of its own (the parent holds NCCL worlds; no card:
               CUDA_VISIBLE_DEVICES empty), started after the build and
               read after the audit phase, DRYRUN_TIMEOUT seconds at most,
               a nonzero exit failing the run.  On a fake 1x1 world it
               builds 3l's two profiled programs as the Engine builds them
               (Qwen2-7B kv4, bf16 weights quantized to 4-bit shells,
               replicate_params_below=0; decode_step[4] over 288 slots read
               through decode_attn_fn(4, 288) at a 0-d position tensor,
               prefill[4x256] reserving 288 slots and cutting its caches by
               shard_caches) and costs them on fake tensors: dot FLOPs, the
               kernels' charged FLOPs and bytes (B1's GEMV and GEMM, the KV
               dequant of the routed read) and decode_step[4]'s collective
               bytes equal 3l's profile of the real programs, the parameter
               and cache bytes equal the real sharded tree's and caches' on
               the card, the argument bytes those plus the tokens and the
               position; FLOPs and HBM bytes beside 3l's as a ratio, FLOPs
               within DRYRUN_FLOPS_REL of 1, HBM bytes within
               DRYRUN_HBM_RATIO either way.  Then Qwen2-7B's production cells
               on the fake 16x16 world (train_4k, prefill_32k and
               decode_32k ok, long_500k skipped with the reference's
               reason): their roofline terms, bottleneck and seconds.
  3e. plan  — mixed precision on the same Qwen2-7B (seeded bf16 weights, full
               width and depth): precision.build_plan on the card at the
               uniform-4 budget with KL probes (a Zipf-Markov batch over the
               first PROBE_VOCAB ids): the winner measures no worse than
               uniform-4 and fits the budget, the plan survives its JSON; then
               a fixed plan of every candidate width and a dense unit
               (FIXED_PLAN_BITS) through Engine(plan=) at kv4 (quantized at
               load, 169 quantize_pack launches; captured tokens identical to
               eager ones, one replay 169 tensor-core GEMVs, 0 CUDA-core ones
               and 28 fused attentions, no host sync, fused vs dequant_einsum
               within 0.5) and Server(plan=): the 24 requests on the slot pool
               (each within 0.08 of the per-request Engine, a differing greedy
               token a near-tie), with Telemetry(kv_probe_every=4) (the same
               tokens, kv_append_qerr_max finite and above 0, quant_unit_bits
               for every unit) and on pages of 16 (the same tokens).
  4. modes   — teacher-forced logits, fused kernel vs dequant_einsum.
  5. kv_tol  — kv_oracle_logit_gap on tiny-650k, kernels in the loop.
  6. paper   — the paper's bit-level sweep: trains the tiny ladder on the
               card (paper.common.TRAIN_RECIPE) into a fresh checkpoint
               cache under build/, encodes every checkpoint
               through the encode kernels and reads perplexity through the
               fused GEMM (fig2: k in {3,4,5,6,8,16}; fig3 data types and
               block sizes); gates training progress and 8-bit perplexity,
               and records the flat encodes' inputs for the times phase.
  6b. paper_rest — the paper's remaining experiments on the same ladder,
               through paper/*.run: fig4 (proxy quantization), appb
               (centering), table1 (GPTQ against zero-shot float).  Restores
               the ladder from phase 6's cache (every parameter and the loss
               history bit for bit) and gates: every perplexity finite;
               each configuration's bits_report equal to
               core/bits.quantized_bits_per_param over its matrices (proxy
               p * (16 - k) more with p = n_out / d a matrix, centering
               16 / B more); the routes by launch counts (proxy and
               centered evaluations no fused GEMM or GEMV, centered encodes
               one flat encode an item and no quantize_pack, proxy encodes
               one quantize_pack an item, each plain baseline holding a
               row-structured matrix at least one GEMM launch); one GPTQ
               matrix of tiny-650k on the card within 1e-12 of the same on
               the CPU.  Prints fig4's fractions, appb's mean delta,
               table1's table, each suite's seconds and the cache's times.
  6c. plan_suites — ``paper.run --only figmix,plan`` on the ladder restored
               from phase 6's cache: the mixed-vs-uniform frontier and the
               gates (h2o-danube-3-4b and mamba2-130m at reduced() shapes,
               the reference's: the mixed plan's KL at or below uniform-4's
               at no more bits, ok=1), and the plans under artifacts/plans/
               (the gate archs' and tiny-2.6m's); then ``python -m
               repro_torch.launch.serve --arch tiny-2.6m --plan <the plan
               suite's JSON> --kv-bits 4 --kv-probe-every 2`` with both
               telemetry sinks as a subprocess: exit 0, its trace validates,
               quant_unit_bits for every unit of the plan.
  6a. bench  — paper/kernel_bench.py through its entry point (gate off, as
               the suite runner calls it, with its kernel smoke): f32 x, M,
               K, N = 8, 2048, 2048 at int3, int4, float4 and int8, block
               64; every fused call one launch of qmatmul.cu's GEMV
               (qmatmul_gemv_simt) and no other kernel, the smoke within
               2e-5 of the oracle; prints each row's us and the speedups.
  6e. ledger — (right after bench, while the serve phase's tree is alive)
               the bench tooling (paper/ledger.py, paper/bench_diff.py,
               paper/serve_bench.py): the pinned records (tiny-160k,
               ledger.SERVE_ARGS and PAGED_ARGS; the kernel record from
               the bench phase's kernel_bench output) diffed with the port's
               bench_diff CLI against the reference's committed
               BENCH_SERVE.json and BENCH_KERNELS.json: both exit 0 (every
               virtual series within its tol: step counts, byte ratios and
               weight bytes exact), the weight bytes 2,228,224 (float4,
               int4), 1,808,793 (int3) and 4,325,376 (int8); the pinned
               serve record run a second time: its virtual series equal the
               first's exactly and their diff exits 0.  Then
               serve_bench.run on the serve phase's Qwen2-7B tree (full width
               and depth, 4-bit float b64): kv16/8/4, 8 slots, 24 requests,
               rate 4.0, budgets of 8-48, seed 0, prompts from the first
               serve_bench.WORKLOAD_VOCAB = 4096 ids (the workload's sampler
               holds a vocab x vocab matrix: 92 GB at 152,064), with the
               reference's gates
               (static = continuous tokens at kv16, kv4 at least 3x fewer KV
               bytes); kv8 and kv4 held to static = continuous tokens
               (kv_gate="tokens"), their logit gaps reported: at Qwen2-7B's
               random weights they exceed KV_LOGIT_TOL, as the reference's do
               from qwen2-7b's reduced() shapes up
               (scripts/kv_gap_reference.py); prints tokens/s,
               TTFT and ITL p50/p99 and batch fill a precision, the static
               tokens/s and the speedup, beside the card's name and power
               limit, and the phase's seconds.
  7. times   — each kernel at the main path's shapes beside its plain
               version, its bound and a PyTorch library call, each timed
               as device time: captured in a CUDA graph and replayed; B1
               also per shape, beside torch.matmul per shape, and the
               decode GEMV beside qmatmul.cu's GEMV on the same operands,
               and qmatmul.cu's GEMV on f32 x (what it serves) at 1, 4 and 8
               rows, each beside torch.matmul on the same f32 operands and
               its bound (bytes, or 3xTF32's products); the f32 GEMM at the
               paper sweep's shapes beside torch.matmul in f32;
               the encode beside the chain it replaced, the fused attention
               beside the path it replaced at 288 and 4096 slots, and there
               paged (pages of 16) beside unpaged at a position a row; the
               KV dequant over a step's caches and a 40,960-slot cache, and
               the flat encode over the sweep's flat items (its share of the
               suites' seconds).
Then the kernels line, the card's name and power limit, and the result.
Needs no network, imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()   # a phase line's elapsed_s counts from here
SEED = 0
ARCH = "qwen2-7b"
BATCH, PROMPT, NEW_TOKENS, KV_BITS = 4, 256, 32, 4
# H100 SXM data-sheet rates: HBM bytes/s, dense bf16 tensor-core FLOP/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
F32_REL_TOL = 2e-5          # tests/test_qmatmul_parity.py REL_TOL: f32 summation order
BF16_REL_TOL = 2.0 ** -7    # one bf16 ulp at max|y|
# the fused decode attention against its plain version, per (batch row,
# head): two bf16 ulps at the row's max; only f32 summation order differs,
# which can flip the bf16 rounding of a p or of the output
ATT_REL_TOL = 2.0 ** -6
LONG_CONTEXT = 4096          # the fused attention's second timing point
ONE_TILE = 16                # its fixed cost: one 16-slot tile, on one CTA of a cluster
# a logit soft-cap that bends the random scores of check_attention (about
# N(0, 1)); gemma2's 50 would leave them nearly straight
SOFTCAP = 5.0
MULTI_ROUND = 16384          # slots past one shared-memory round of the fused attention
# fused vs dequant_einsum multiply the same bf16-rounded weights and differ
# only in the order (and, on the tensor cores, the grouping) of their f32
# sums.  That flips single bf16 roundings of activations, which carry through
# 28 layers of random weights into ~155M logits of size ~6, where a bf16 ulp
# is 0.03.  Such a gap stays a few ulps; a gap near KV_LOGIT_TOL[4] = 1.0
# would mean the two paths multiply different weights.  The gate is half of
# that tolerance.
MODE_GAP_TOL = 0.5
# the paper finds 8-bit weights indistinguishable from 16-bit (the
# reference's own ladder, trained on the CPU, sits within 0.11 % of it), so a
# model whose 8-bit perplexity is more than 1 % off its 16-bit one has a
# broken encode or GEMM
PPL_K8_REL_TOL = 0.01
# training must have learnt: the last loss at least this many nats below the first
MIN_LOSS_DROP = 1.0
# the dryrun phase: its subprocess's time limit (it runs beside the card's
# phases, on one host core) and the bounds on the fake programs' FLOPs and
# HBM bytes over the card's.  Only the counted ops between the kernels'
# units differ (utils/cost.py), the sampling of the Engine's step among
# them: on an H100 80GB HBM3 at 700.00 W (PERF.md, section 6) the FLOPs came to
# 1.000056 (decode_step[4]) and 1.000051 (prefill[4x256]) of the card's, the
# HBM bytes to 1.0037 and 1.1221
DRYRUN_TIMEOUT = 900
DRYRUN_FLOPS_REL = 1e-3        # |fake / card - 1| at most this
DRYRUN_HBM_RATIO = 1.25        # fake / card within this either way
# the server phase: the pool, its traffic and the chunk size
SERVER_SLOTS, SERVER_REQUESTS, SERVER_CHUNK = 8, 24, 128
SERVER_PROMPT_LENS, SERVER_NEW_TOKENS = (16, 512), (16, 64)
# Server against the per-request Engine at batch 1: the decode-consistency
# bar of tests/test_decode_consistency.py (M = 8 and M = 1 may take
# different GEMV plans, so tokens are held to it, not to identity)
SERVER_LOGIT_TOL = 0.08
# the paged phase: its page size, the page sizes the kernel checks cover
# (the reference's tests use 8), and the shared-prefix run: 16 requests
# over two 512-token prefixes with 32-token suffixes, on 8 slots.  The
# workload's Zipf-Markov process keeps a vocab x vocab transition matrix
# (92 GB of f32 at Qwen2-7B's vocabulary), so its prompts draw from the
# first SHARED_VOCAB token ids, all valid Qwen2-7B tokens
PAGE_SIZE, PAGED_CHECK_SIZES = 16, (8, 16, 64)
SHARED_REQUESTS, SHARED_PREFIX, SHARED_SUFFIX, SHARED_VOCAB = 16, 512, 32, 4096
# the short kv8 and kv16 paged runs: the first requests of the server phase
PAGED_SHORT_REQUESTS = 8
# the bits phase: the widths below 8 other than 4 (the paper sweeps 3 to 8
# bits; the reference's mixed-precision planner proposes 3, 5 and 6)
LOW_BITS = (3, 5, 6)
# the audit phase: decode steps of the Engine on the serve phase's prompts
AUDIT_NEW_TOKENS = 8
# the routed phase: the paper ladder's largest model, whose head dim of 56
# the fused attention does not take, through the Engine (4 prompts of 64
# tokens, 32 new) and the Server (4 slots of 256, 12 requests of 16-200
# prompt tokens and 8-32 new ones, pages of 16)
ROUTED_ARCH = "tiny-10m"
ROUTED_BATCH, ROUTED_PROMPT, ROUTED_NEW = 4, 64, 32
ROUTED_SLOTS, ROUTED_LEN, ROUTED_REQUESTS = 4, 256, 12
ROUTED_PROMPT_LENS, ROUTED_NEW_TOKENS = (16, 200), (8, 32)
# the first power-of-two cache the fused attention refuses at Qwen2-7B's
# heads (its shared memory holds 39,808 slots at kv4): read by the route
LONG_ROUTED = 40960
# 3xTF32: three TF32 products for each f32 one, on the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3
# the plan phase: a fixed mixed plan over Qwen2-7B's eight units that
# covers every candidate width of the planner (precision/plan.py
# CANDIDATE_BITS) and one dense unit, and the probe batch's vocabulary (a
# Zipf-Markov process keeps a vocab x vocab matrix: its first PROBE_VOCAB
# ids, all valid Qwen2-7B tokens, as the paged phase's shared prefixes)
FIXED_PLAN_BITS = {"mixer/wq": 3, "mixer/wk": 16, "mixer/wv": 5, "mixer/wo": 6,
                   "ffn/w_gate": 4, "ffn/w_up": 4, "ffn/w_down": 8, "lm_head": 4}
PROBE_VOCAB = 4096
PLAN_KV_PROBE_EVERY = 4
# the windows phase: h2o-danube-3-4b and gemma2-27b at full width, 2 prompts
# of 4160 tokens (the prefill wraps each 4096-slot ring) in caches of 4224
# positions; the Server on 4 slots of 4352 over 12 requests: 4 longer than
# the ring, 4 that cross the window while decoding, 4 short; gemma2's
# fused-vs-dequant_einsum gap on the prompt's last 256 rows
WIN_BATCH, WIN_PROMPT, WIN_NEW, WIN_CACHE = 2, 4160, 64, 4224
WIN_SLOTS, WIN_SLOT_LEN = 4, 4352
WIN_LONG_PROMPTS = [4200, 4110, 4150, 4180]
WIN_CROSSING_PROMPTS = [4083, 4087, 4090, 4094]
WIN_SHORT_PROMPTS = [64, 700, 2000, 3300]
GEMMA_DEPTH, GEMMA_NEW, GEMMA_MODE_ROWS = 46, 32, 256
WIN_TIMED_STEPS = 10
# decode past the window against the full forward: the reference's own
# bar (tests/test_decode_consistency.py, test_sliding_window_ring_cache_
# evicts_correctly), held at reduced() shapes by tests/test_torch_windows.py.
# At full width and depth any decode differs from the full forward by more:
# the same steps over linear caches (no ring) and from a 2048-token prompt
# (the window never reached) were 0.18 off on the card, because the
# summation order (decode rows in pieces of 16, the forward's of 128; one
# softmax pass against 1024-key chunks) flips bf16 roundings that 24 layers
# of random weights amplify.  So the ring's share is gated: the ring's gap
# at most this much over the linear caches'
RING_LOGIT_TOL = 0.08
# the moe phase: moonshot-v1-16b-a3b at full width and depth (48 layers, d
# 2048, 64 experts of width 1408, top-6), kv4.  The Engine on 4 prompts of
# 256 (16 dispatch groups a prefill) and 32 new tokens; the Server on 8
# slots of 576 over 16 requests of 16-512 prompt tokens (one of 320: >= 256
# and a multiple of 16, so its exact-length prefill runs 16 dispatch groups)
# and 16-64 new ones, on slots and on pages of 16; phi3.5-moe at full width
# (32 heads over 8 KV heads, 16 experts of width 6400, top-2) at depth 8 of
# 32, on 2 prompts of 256 and 16 new tokens
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_NEW = "moonshot-v1-16b-a3b", 4, 256, 32
MOE_SLOTS, MOE_SLOT_LEN, MOE_REQUESTS, MOE_GROUPED_PROMPT = 8, 576, 16, 320
MOE_TIMED_STEPS = 10
PHI_ARCH, PHI_DEPTH, PHI_BATCH, PHI_PROMPT, PHI_NEW = "phi3.5-moe-42b-a6.6b", 8, 2, 256, 16
# the expert-batched GEMV's checks: (N, K) of moonshot's and phi3.5's expert
# matrices (gate/up, down), and the rows its 8 experts hold (empty ones, 1,
# 8 = its row limit)
MOE_GEMV_SHAPES = ((1408, 2048), (2048, 1408), (6400, 4096), (4096, 6400))
MOE_GEMV_COUNTS = (0, 1, 8, 3, 0, 5, 8, 2)
# the ssm phase: mamba2-130m at full width and depth (24 SSM layers, d 768,
# d_inner 1536, 24 heads of 64, state 128, SSD chunks of 256, a tied
# 50,280-row head; no attention, so kv16).  The Engine on 4 prompts of 1024
# (4 SSD chunks a prompt) and 32 new tokens; the per-layer decode gate: T
# decode steps of each SSM layer against its sequence mode on the same f32
# input, within the reference's 3e-2 (outputs) and 2e-2 (final state and
# conv) of tests/test_ssm_moe.py; the whole model's decode-vs-forward gap
# over SSM_GAP_STEPS teacher-forced steps (reported only); the Server on 8
# slots of 1344 over 16 requests whose prompts keep the SSD chunk rule
# (16-256 tokens, and 512, 768 and 1024), 16-64 new ones.  jamba-v0.1-52b at
# full width, depth 8 of 32 (one period: attention with an MLP, then seven
# SSM layers, MoE at 1, 3, 5 and 7), kv4, on 2 prompts of 1024 and 16 new
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_NEW = "mamba2-130m", 4, 1024, 32
SSM_SLOTS, SSM_SLOT_LEN, SSM_REQUESTS = 8, 1344, 16
SSM_SHORT_PROMPTS, SSM_LONG_PROMPTS = (16, 256), (512, 768, 1024)
SSM_GATE_BATCH, SSM_GATE_STEPS = 2, 16
SSM_GATE_Y_TOL, SSM_GATE_STATE_TOL = 3e-2, 2e-2
SSM_GAP_PREFILL, SSM_GAP_STEPS = 768, 255
SSM_MODE_ROWS = 256
JAMBA_ARCH, JAMBA_DEPTH, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_NEW = "jamba-v0.1-52b", 8, 2, 1024, 16
# the expert-batched GEMV's checks at jamba's expert matrices (gate/up,
# down): 16 experts, empty ones, 1 row and 8
JAMBA_GEMV_SHAPES = ((14336, 4096), (4096, 14336))
JAMBA_GEMV_COUNTS = (0, 1, 8, 3, 0, 5, 8, 2, 1, 0, 8, 4, 6, 0, 7, 1)
# the seq2seq phase: seamless-m4t-large-v2 at full width and depth, 4 sources
# of 1024 stub frames (N(0, 1) draws), a decoder prefix of two fixed ids
# standing for a start token and a target-language tag, 64 greedy tokens;
# its decode-vs-forward bar is the reference's own
# (tests/test_decode_consistency.py, test_seq2seq_prefill_decode_matches_full)
S2S_ARCH, S2S_BATCH, S2S_FRAMES, S2S_NEW = "seamless-m4t-large-v2", 4, 1024, 64
S2S_PREFIX = (2, 256047)
S2S_GAP_TOL = 0.05
S2S_TIMED_STEPS = 20
# at full width the reference's own decode is further than its 0.05 from its
# forward, more so the deeper the stacks: its gap on the CPU with both
# stacks cut to a depth (scripts/seq2seq_gaps_reference.py: 4-bit weights,
# 2 sources of 256 frames, a prefix of 2, 16 steps, compiled without excess
# precision), by depth.  The card's gap with the stacks cut to each of these
# depths may be at most the reference's own plus its bar S2S_GAP_TOL; the
# gap at full depth is reported beside them
S2S_REF_GAPS = {2: 0.03179931640625, 4: 0.0546875, 8: 0.078125}
# the launcher subprocess: tiny-2.6m served per the plan suite's JSON
LAUNCH_ARCH, LAUNCH_REQUESTS, LAUNCH_MAX_NEW = "tiny-2.6m", 12, 16


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the repository root",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(["qgemv_sm90", "qmatmul", "qgemm_sm90", "kv_dequant", "quantize",
                           "quantize_pack", "kv_decode_attention"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()}})

    dryrun_child = start_dryrun()
    errs = check_kernels(torch, dev)
    windows = windows_path(torch, dev)
    experts = moe_path(torch, dev)
    _memory_note(torch, "moe")
    ssm_counts = ssm_path(torch, dev)
    _memory_note(torch, "ssm")
    s2s_counts = seq2seq_path(torch, dev)
    _memory_note(torch, "seq2seq")
    run = serve_main_path(torch, dev)
    low_bits = serve_low_bits(torch, dev, run)
    _memory_note(torch, "bits")
    server_path(torch, dev, run)
    profile_path(torch, dev, run)
    paged_path(torch, dev, run)
    _memory_note(torch, "paged")
    routed_path(torch, dev, run)
    mesh_path(torch, dev, run)
    train_mesh = train_mesh_path(torch, dev)
    moe_ssm_mesh = moe_ssm_mesh_path(torch, dev)
    encdec_mesh = encdec_mesh_path(torch, dev)
    plan_path(torch, dev, run)
    mode_parity(torch, dev, run)
    kv_tolerance(torch, dev)
    paper = paper_path(torch, dev)
    rest = paper_rest(torch, dev, paper)
    suites = plan_suites(torch, dev, paper)
    bench = bench_path(torch, dev)
    ledger = ledger_path(torch, dev, run, bench)
    times = time_kernels(torch, dev, run, paper)
    audit_path(torch, dev, run)
    dryrun_path(dryrun_child, run)
    main_counts = (run["server_counts"], run["profile_counts"], run["paged_counts"],
                   run["routed_counts"], run["mesh_counts"], train_mesh, moe_ssm_mesh,
                   encdec_mesh, run["plan_counts"],
                   windows,
                   experts["launches"], ssm_counts, s2s_counts,
                   bench["launches"], rest["launches"], suites["launches"], ledger)
    del run

    kernels = []
    swept = dict(paper["launches"])
    swept["gemm"] -= swept["gemm_simt"]   # the tensor-core GEMM's share
    for name, key, count in (("qmatmul_gemv", "gemv", "gemv_tc"),
                             ("qmatmul_gemv_simt", "gemv_simt", "gemv_simt"),
                             ("qmatmul_gemm", "gemm", "gemm"),
                             ("qgemm_simt", "gemm_simt", "gemm_simt"),
                             ("kv_dequant", "kv", "kv"), ("kv_decode_attention", "attn", "attn"),
                             ("quantize_blocks", "b3", "b3"), ("quantize_pack", "pack", "pack")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": t["source"], "replaces": t["replaces"],
            # the main paths' launches: serving Qwen2-7B through the Engine
            # (its quantization included), through the Server on the slot
            # pool and on pages, the profile phase (the profiled Engine and
            # Servers, gradient compression and its training run),
            # tiny-10m's routed read (Engine and Server), the 1x1 mesh's
            # sharded Engines and Servers (Qwen2-7B: plain, preempted and
            # profiled), its sharded train steps (Qwen2-7B at depth 4,
            # tiny-650k's run), the 1x1 mesh's MoE, SSM and hybrid loads,
            # Engines, Servers and train steps, the encoder-decoder's load,
            # sharded prefill, decode steps and train steps on it,
            # the mixed-precision plans (the planner, Engine and Servers),
            # h2o-danube-3-4b and gemma2-27b (their loads, Engines and Server),
            # moonshot-v1 and phi3.5-moe (their loads, Engines and Servers),
            # mamba2-130m and jamba (their loads, Engines and mamba2's
            # Servers), seamless-m4t-large-v2 (its load, prefill, decode
            # steps, captured step and teacher-forced forward), kernel_bench,
            # the paper's sweep, its remaining experiments and the figmix and
            # plan suites, and the ledger phase's serves (the pinned records
            # and Qwen2-7B's sweep)
            "launches": t["launches"] + sum(c[count] for c in main_counts) + swept[count],
            "max_abs_err": errs[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    t = experts["gemv_experts"]
    kernels.append({
        "name": "qmatmul_gemv_experts", "route": "cuda",
        "source": "src/repro_torch/csrc/qgemv_sm90.cu",
        "replaces": "src/repro/kernels/qmatmul.py:97",
        # the moe phase (moonshot-v1's and phi3.5-moe's Engines and
        # moonshot-v1's Servers), the ssm phase (jamba's Engine) and the
        # moe/ssm mesh phase (moonshot-v1's and jamba's sharded Engines and
        # moonshot-v1's sharded Server), 3 an MoE layer and decode step
        "launches": sum(c["gemv_moe"] for c in main_counts), "max_abs_err": errs["gemv_moe"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    for bits in LOW_BITS:
        t = low_bits[bits]
        kernels.append({
            "name": f"qmatmul_gemv_{bits}bit", "route": "cuda",
            "source": "src/repro_torch/csrc/qgemv_sm90.cu",
            "replaces": "src/repro/kernels/qmatmul.py:97",
            # the bits phase's Engine at this width: its prefill's head, the
            # capture's warm-up step and the replays
            "launches": t["launches"]["gemv_tc"], "max_abs_err": errs[f"gemv{bits}"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels})
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _memory_note(torch, after: str) -> None:
    """The card's allocated and reserved bytes after a phase, on stderr."""
    print(f"chip_smoke: after {after}: {torch.cuda.memory_allocated()} bytes allocated, "
          f"{torch.cuda.memory_reserved()} reserved", file=sys.stderr, flush=True)


def _gen(torch, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


#: the tensor-core GEMV's odd scale blocks by width (kernels/qmatmul.py:
#: tc_gemv_block_ok takes them all)
ODD_TC_BLOCKS = {3: (12, 20, 40), 4: (16, 24, 40), 5: (12, 20, 44), 6: (4, 12, 20),
                 7: (8, 12, 20), 8: (8, 12, 20)}


#: scale blocks that split a group of 4 codes (at 4 bits a word of 8) by
#: width, which send bf16 x to the CUDA-core GEMV
SIMT_BF16_BLOCKS = {3: (6, 10), 4: (12, 20), 5: (6, 10), 6: (6, 10), 7: (6, 10), 8: (6, 10)}
#: the f32 GEMV's scale blocks: whole groups of its runs at some widths (16,
#: 32, 64: the scale factored out of a group's products), blocks that its
#: groups or words straddle, and odd ones (x rows off 16 bytes)
F32_GEMV_BLOCKS = (16, 32, 64, 6, 10, 12, 20)
#: the f32 GEMV's row counts at Qwen2-7B's shapes (times phase: the same)
F32_GEMV_MS = (1, BATCH, 8)


def _odd_k(bits: int, block: int) -> int:
    """K = 200 at 4, 7 and 8 bits (rows of words off whole uint4s at the
    blocks above); at 3, 5 and 6 bits the first whole multiple of
    lcm(cpw, block) from 200 on whose word count is not a multiple of 4,
    where there is one below 4000 (at 6 bits there is none)."""
    if bits in (4, 7, 8):
        return 200
    cpw = 32 // bits
    bk = cpw * block // math.gcd(cpw, block)
    first = -(-200 // bk) * bk
    return next((K for K in range(first, 4000, bk) if (K // cpw) % 4), first)


def check_kernels(torch, dev) -> dict:
    """Phase 2: every kernel against its plain version on the same inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels import quantize as quantk
    from repro_torch.paper import kernel_bench as kb

    g = _gen(torch, dev, SEED + 1)
    worst = {"gemv": 0.0, "gemv_simt": 0.0, "gemm": 0.0, "gemm_simt": 0.0, "kv": 0.0,
             "attn": 0.0, "routed": 0.0, "b3": 0.0, "pack": 0.0, "gemv_moe": 0.0,
             **{f"gemv{b}": 0.0 for b in LOW_BITS}}
    n_checks = 0

    def check_b1(Ms, K, N, bits, dtype, block, xdt, main_path, launch=None):
        """One weight, x of each row count in Ms: `launch` (default the
        kernel qmatmul_cuda picks) against the plain version."""
        nonlocal n_checks
        w = torch.randn((K, N), generator=g, device=dev) * 0.05
        op = ops.prepare_operand(w, bits=bits, dtype=dtype, block_size=block)
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            xp, packed, scales = ops.pad_for_kernel(x, op)
            kw = dict(bits=bits, block_size=block)
            y_k = (launch or qk.qmatmul_cuda)(xp, packed, scales, op.codebook, **kw).float()
            y_p = qk.qmatmul_plain(xp, packed, scales, op.codebook, **kw).float()
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            ref = float(y_p.abs().max())
            tol = (F32_REL_TOL if xdt == torch.float32 else BF16_REL_TOL) * ref
            require(bool(torch.isfinite(y_k).all()) and err <= tol,
                    f"qmatmul M={M} K={K} N={N} bits={bits} {dtype} b{block} {xdt}: "
                    f"max|err| {err} > {tol}")
            if main_path:
                key = "gemv" if xp.shape[0] <= qk.GEMV_MAX_M else "gemm"
                if key == "gemv" and bits in LOW_BITS:
                    key = f"gemv{bits}"
                worst[key] = max(worst[key], err)
            elif launch is None:   # the CUDA-core routes, off the main paths
                if M <= qk.GEMV_MAX_M and qk.gemv_route(xdt, bits, block) == "simt":
                    worst["gemv_simt"] = max(worst["gemv_simt"], err)
                elif M > qk.GEMV_MAX_M and xdt == torch.float32:
                    worst["gemm_simt"] = max(worst["gemm_simt"], err)
            n_checks += 1

    # odd word tails and scale blocks that words straddle; the GEMVs at 1, 2,
    # 4 and 8 rows (3 and 5 mask rows), the tiled kernels past 8 rows
    for bits in (3, 4, 5, 6, 7, 8):
        for dtype in ("int", "float", "dynamic"):
            for xdt in (torch.float32, torch.bfloat16):
                for block in (16, 32):
                    check_b1((1, 2, 3, 5, 37), 200, 70, bits, dtype, block, xdt, False)
    # bf16 x whose scale blocks split a group of 4 codes (at 4 bits a word):
    # gemv_route sends them to the CUDA-core GEMV, every row count to 8
    before_simt = qk.qmatmul_gemv_simt.launches
    n_simt = 0
    for bits, blocks in SIMT_BF16_BLOCKS.items():
        for dtype in ("int", "float", "dynamic"):
            for block in blocks:
                require(qk.gemv_route(torch.bfloat16, bits, block) == "simt",
                        f"bf16 x at {bits} bits, B {block} is not routed to the CUDA cores")
                check_b1((1, 2, 3, 5, 8), 200, 70, bits, dtype, block, torch.bfloat16, False)
                n_simt += 5
    require(qk.qmatmul_gemv_simt.launches - before_simt == n_simt,
            "the CUDA-core GEMV's bf16 cases did not launch it once per case")
    # f32 x, the GEMV of qmatmul.cu on every route it has: every width and
    # row count to 8, rows as stored with word tails and x rows off 16
    # bytes, blocks of whole groups (the scale factored out) and blocks that
    # groups or words straddle; then kernel_bench's shape
    before_simt = qk.qmatmul_gemv_simt.launches
    n_simt = 0
    for bits in range(3, 9):
        for block in F32_GEMV_BLOCKS:
            for dtype in ("int", "float", "dynamic"):
                check_b1(tuple(range(1, qk.GEMV_MAX_M + 1)), 200, 70, bits, dtype, block,
                         torch.float32, False)
                n_simt += qk.GEMV_MAX_M
            check_b1((1, 8), 1000, 17, bits, "float", block, torch.float32, False)
            n_simt += 2
    for bits, dtype in kb.TAGS:   # kernel_bench's weights, rows as stored
        check_b1((1, 4, kb.M), kb.K, kb.N, bits, dtype, 64, torch.float32, False)
        n_simt += 3
    require(qk.qmatmul_gemv_simt.launches - before_simt == n_simt,
            "the f32 GEMV cases did not launch qmatmul_gemv_simt once per case")
    # the tensor-core GEMV's edges: every row count it instantiates nothing
    # for (it always multiplies 8), column tails around its 16-column
    # blocks, K tails off its chunks of 16 words (n_words % 16 != 0), at
    # every width over three data types and blocks; then rows of words not a
    # multiple of 4, which it reads a word at a time, and odd scale blocks (a
    # word count that is not a power of two at 4, 7 and 8 bits; at 3, 5 and
    # 6 bits runs that meet more than two blocks, or blocks that are not a
    # power of two)
    before_tc = qk.qmatmul_gemv_tc.launches
    for bits in qk.TC_GEMV_BITS:
        for dtype in ("int", "float", "dynamic"):
            for block in (16, 32, 64):
                for i, N in enumerate((8, 16, 17, 70, 512)):
                    check_b1((1, 2, 3, 4, 5, 8), (200, 328, 1000)[i % 3], N, bits, dtype,
                             block, torch.bfloat16, False, qk.qmatmul_gemv_tc)
        for block in ODD_TC_BLOCKS[bits]:
            check_b1((1, 4, 8), _odd_k(bits, block), 70, bits, "float", block, torch.bfloat16,
                     False, qk.qmatmul_gemv_tc)
    require(qk.qmatmul_gemv_tc.launches - before_tc
            == len(qk.TC_GEMV_BITS) * (3 * 3 * 5 * 6 + 3 * 3),
            "the tensor-core GEMV's edge grid did not launch once per case")
    cfg = get_arch(ARCH)
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    shapes = [(D, D), (D, KD), (D, F), (F, D), (D, V)]
    # the row counts of the main paths: the Server's admission head (1), the
    # Engine's and the pool's decode steps (BATCH, SERVER_SLOTS), the
    # Server's bucketed prefills (16-512) and chunks, the Engine's prefill
    server_ms = sorted({1 << i for i in range(4, SERVER_PROMPT_LENS[1].bit_length())}
                       | {SERVER_CHUNK})
    before_simt = qk.qmatmul_gemv_simt.launches
    for K, N in shapes:
        check_b1((1, BATCH, SERVER_SLOTS, *server_ms, BATCH * PROMPT), K, N, 4, "float", 64,
                 torch.bfloat16, True)
        check_b1(F32_GEMV_MS, K, N, 4, "float", 64, torch.float32, False)
        for bits in LOW_BITS:   # the bits phase's decode GEMVs and prefill
            check_b1((1, BATCH, BATCH * PROMPT), K, N, bits, "float", 64, torch.bfloat16, True)
    require(qk.qmatmul_gemv_simt.launches - before_simt == len(shapes) * len(F32_GEMV_MS),
            "Qwen2-7B's shapes with f32 x did not launch qmatmul_gemv_simt once per case")
    # the windows phase's matrices: its decode steps (the Engine's rows, the
    # Server's pool and admission head) and prefills (the Server's longest
    # prompt, the Engine's two)
    for items in _window_items().values():
        for rows, cols, _ in items:
            check_b1((1, WIN_BATCH, WIN_SLOTS, WIN_LONG_PROMPTS[0], WIN_BATCH * WIN_PROMPT),
                     cols, rows, 4, "float", 64, torch.bfloat16, True)
    # the ssm phase's matrices (mamba2's in_proj has 3352 rows, off the
    # GEMVs' 16-column blocks): its decode steps (the Engines' rows, the
    # Server's pool) and prefills (the Server's shortest and longest exact
    # lengths, the Engines' prompts)
    for items in _ssm_items().values():
        for rows, cols, _ in items:
            check_b1((1, JAMBA_BATCH, SSM_BATCH, SSM_SLOTS, SSM_SHORT_PROMPTS[0],
                      SSM_LONG_PROMPTS[-1], JAMBA_BATCH * JAMBA_PROMPT, SSM_BATCH * SSM_PROMPT),
                     cols, rows, 4, "float", 64, torch.bfloat16, True)
    # the seq2seq phase's matrices (the head's 256,206 rows: N % 8 = 6): its
    # decode steps (1 and 4 rows), the prefill's decoder products (8) and
    # head (4), a GEMM just past the GEMV (9), the teacher-forced forward
    # over the 65 tokens and the encoder's and cross K/V's GEMMs (4096)
    for rows, cols, _ in _s2s_items():
        check_b1((1, S2S_BATCH, 2 * S2S_BATCH, 9, S2S_BATCH * (len(S2S_PREFIX) + S2S_NEW - 1),
                  S2S_BATCH * S2S_FRAMES), cols, rows, 4, "float", 64, torch.bfloat16, True)
        torch.cuda.empty_cache()
    # a row's result does not depend on the rows sharing the call: row 0 of
    # an 8-row call equals the 1-row call bit for bit, on every f32 route
    for (K, N), bits, dtype, block in ([(kn, 4, "float", 64) for kn in shapes]
                                       + [((kb.K, kb.N), b, dt, 64) for b, dt in kb.TAGS]
                                       + [((200, 70), b, "int", 6) for b in (3, 4, 6)]):
        w = torch.randn((K, N), generator=g, device=dev) * 0.05
        op = ops.prepare_operand(w, bits=bits, dtype=dtype, block_size=block)
        x8 = torch.randn((qk.GEMV_MAX_M, op.k_dim), generator=g, device=dev)
        kw = dict(bits=bits, block_size=block)
        y8 = qk.qmatmul_gemv_simt(x8, op.packed, op.scales, op.codebook, **kw)
        y1 = qk.qmatmul_gemv_simt(x8[:1].contiguous(), op.packed, op.scales, op.codebook, **kw)
        torch.cuda.synchronize()
        require(torch.equal(y8[:1], y1), f"f32 GEMV {K}x{N} {dtype}{bits} b{block}: row 0 "
                                         f"differs alone and among {qk.GEMV_MAX_M} rows")
        n_checks += 1
    # the tensor-core kernel's edges: rows around its 64-row slabs and its
    # 128- and 256-row tiles, columns around its 128-column tiles and off
    # 16-byte rows, every bit width with blocks that words straddle; the
    # Qwen2-7B k/v shape at M = 1024 splits K
    for bits, block in ((3, 16), (4, 32), (5, 64), (6, 16), (7, 16), (8, 32)):
        for N in (8, 70, 136, 512):
            check_b1((9, 63, 64, 65, 129), 200, N, bits, "int", block, torch.bfloat16, False)
            check_b1((1024,), 640, N, bits, "int", block, torch.bfloat16, False)
    # the paper sweep's matrices at its perplexity batch (M = 1024): fig2's
    # bit widths, fig3dt's data types and fig3bs's blocks that divide a row
    from repro_torch.configs.tiny import TINY_FAMILY

    for tcfg in TINY_FAMILY.values():
        Dt, Ft = tcfg.d_model, tcfg.d_ff
        for K, N in ((Dt, Dt), (Dt, Ft), (Ft, Dt)):
            cases = [(b, "float", 64) for b in (3, 4, 5, 6, 8)]
            cases += [(4, dt, 64) for dt in ("int", "dynamic", "quantile")]
            cases += [(b, "float", B) for b in (4, 8) for B in (32, 128, 256, 1024) if K % B == 0]
            for bits, dtype, block in cases:
                check_b1((1024,), K, N, bits, dtype, block, torch.bfloat16, True)

    rows = BATCH * (PROMPT + NEW_TOKENS)
    tiny_feat = get_arch(ROUTED_ARCH).n_kv_heads * get_arch(ROUTED_ARCH).head_dim

    def same(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    for bits in (4, 8):
        for dtype in ("int", "float", "dynamic"):
            # the main paths' rows (Qwen2-7B's step, tiny-10m's), a short
            # row, and 6-wide blocks that words straddle: one leaf, a layer's
            # K and V in one launch, and both through a shuffled page map
            for R, feat, block in ((rows, KD, 64), (4 * ROUTED_LEN, tiny_feat, 64), (3, 64, 64),
                                   (5, 48, 6)):
                spec = kvd.KVQuantSpec(bits=bits, block_size=block, dtype_name=dtype)
                leaves = [kvd.encode_rows(torch.randn((R, feat), generator=g, device=dev)
                                          .to(torch.bfloat16), spec) for _ in range(2)]
                plain = [kvd.dequant_rows_ref(p, s, spec, feat) for p, s in leaves]
                out_k = kvd.dequant_rows_cuda(*leaves[0], spec, feat)
                both = kvd.dequant_kv_cuda(leaves, spec, feat)
                pages = [(p.reshape(R, 1, -1), s.reshape(R, 1, -1)) for p, s in leaves]
                page_map = torch.randperm(R, generator=g, device=dev).to(torch.int32)
                page_map = page_map[: R - R % 2].reshape(2, -1).contiguous()
                paged = kvd.dequant_kv_cuda(pages, spec, feat, page_map)
                ids = page_map.reshape(-1).long()
                torch.cuda.synchronize()
                require(same(out_k, plain[0]) and all(same(a, b) for a, b in zip(both, plain))
                        and all(same(a.reshape(-1, feat), b[ids]) for a, b in zip(paged, plain)),
                        f"kv_dequant kv{bits} {dtype} R={R} feat={feat} b{block} not bit-exact")
                n_checks += 3
    def check_b3(xb, cb, what):
        nonlocal n_checks
        kc, ks = quantk.quantize_blocks_cuda(xb, cb)
        pc, ps = quantk.quantize_blocks_plain(xb, cb)
        torch.cuda.synchronize()
        require(torch.equal(kc, pc) and torch.equal(ks.view(torch.int32), ps.view(torch.int32)),
                f"quantize_blocks {what}: codes or scale bits differ")
        worst["b3"] = max(worst["b3"], float((kc - pc).abs().max()),
                          float((ks - ps).abs().max()))
        n_checks += 1

    # blocks holding codebook values and exact midpoints (absmax a power of
    # two, so x / scale is exact), blocks of +0, -0 and subnormals, then
    # random blocks and a partial last block; blocks the vector body takes
    # (B % 4 == 0 up to 1024: the sweep's 32-1024, 16, 48 and 100, a group
    # of 25 lanes) and the one-warp body (1, 3, 2048)
    for bits in (3, 4, 5, 6, 8):
        for dtype in ("int", "float", "dynamic", "quantile"):
            base = torch.randn((4096,), generator=g, device=dev)
            cb = make_codebook(dtype, bits, tensor=base)
            special = torch.cat([cb, (cb[:-1] + cb[1:]) / 2.0])
            special = torch.cat([special, -special])
            for block in (1, 3, 16, 32, 48, 64, 100, 128, 256, 1024, 2048):
                chunks = special.split(block - 1) if block > 1 else ()
                heads = torch.ones((len(chunks), 1), device=dev)
                rows = torch.nn.utils.rnn.pad_sequence(list(chunks), batch_first=True) \
                    if chunks else torch.zeros((0, 0), device=dev)
                rows = torch.nn.functional.pad(rows, (0, block - 1 - rows.shape[1]))
                scale = 2.0 ** torch.randint(-6, 3, (len(chunks), 1), generator=g, device=dev)
                tiny = 1e-40 * torch.arange(1, block + 1, device=dev)
                signed = torch.stack([torch.zeros(block, device=dev),
                                      -torch.zeros(block, device=dev), tiny, -tiny])
                exact = torch.cat([special if block == 1 else
                                   (torch.cat([heads, rows], dim=1) * scale).reshape(-1),
                                   signed.reshape(-1)])
                n_rand = 300 * block + block // 2 + 1
                rand = torch.randn((n_rand,), generator=g, device=dev) * torch.exp(
                    2 * torch.randn((n_rand // block + 1, 1), generator=g, device=dev)
                ).expand(-1, block).reshape(-1)[:n_rand]
                x = torch.cat([exact, rand])
                n_blocks = -(-x.numel() // block)
                xb = torch.nn.functional.pad(x, (0, n_blocks * block - x.numel()))
                check_b3(xb.reshape(n_blocks, block), cb, f"{bits}-bit {dtype} b{block}")
    # the main path's items: each Qwen2-7B matrix shape as the encode sees it
    cb = make_codebook("float", 4, device=dev)
    for rows, cols in _qwen_items(cfg):
        w = torch.randn((rows, cols), generator=g, device=dev).to(torch.bfloat16)
        check_b3(w.reshape(-1).float().reshape(-1, 64), cb, f"Qwen2-7B item {rows}x{cols}")
        del w
    n_checks += check_pack(torch, dev, g, cfg, worst)
    n_checks += check_attention(torch, dev, g, cfg, worst)
    n_checks += check_routed(torch, dev, g, cfg, worst)
    n_checks += check_ring(torch, dev, g, worst)
    n_checks += check_moe_gemv(torch, dev, g, worst)
    n_checks += check_moe_gemv_slice(torch, dev, g)
    emit({"phase": "kernels", "checks": n_checks, "max_abs_err_main_shapes": worst,
          "tolerance": {"f32_rel": F32_REL_TOL, "bf16_rel_to_max": BF16_REL_TOL,
                        "kv_dequant": "bit-exact", "quantize_blocks": "bit-exact",
                        "quantize_pack": "bit-exact",
                        "kv_decode_attention_rel_to_row_max": ATT_REL_TOL,
                        "routed_read_rel_to_row_max": ATT_REL_TOL,
                        "gemv_experts": "bit-identical to per-expert launches; "
                                        "bf16_rel_to_max of the plain version"}})
    return worst


def check_moe_gemv(torch, dev, g, worst) -> int:
    """The expert-batched GEMV at the MoE archs' expert shapes, 4 bits and 3
    (rows as stored, ceil(K / 10) words), block 64: moonshot-v1's and
    phi3.5-moe's with 8 experts holding MOE_GEMV_COUNTS rows, jamba's with
    16 holding JAMBA_GEMV_COUNTS, of a buffer of 9 rows an expert (the MoE
    path's capacity buffers, an overflow row each), one launch; each
    expert's rows bit-identical to a qmatmul_gemv_tc launch on that expert
    alone, and within one bf16 ulp at max|y| of the plain version.  Returns
    the checks."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import qmatmul as qk

    n_checks = 0
    cases = [(nk, MOE_GEMV_COUNTS) for nk in MOE_GEMV_SHAPES]
    cases += [(nk, JAMBA_GEMV_COUNTS) for nk in JAMBA_GEMV_SHAPES]
    for (N, K), expert_rows in cases:
        E = len(expert_rows)
        counts = torch.tensor(expert_rows, dtype=torch.int32, device=dev)
        for bits in (4, 3):
            block, cpw = 64, 32 // bits
            kw = dict(bits=bits, block_size=block)
            packed = torch.randint(-2**31, 2**31 - 1, (E, N, -(-K // cpw)), generator=g,
                                   device=dev, dtype=torch.int32)
            scales = (torch.rand((E, N, K // block), generator=g, device=dev) * 0.04
                      + 0.01).to(torch.bfloat16)
            cb = make_codebook("float", bits, device=dev).expand(E, -1).contiguous()
            buf = torch.randn((E, qk.GEMV_MAX_M + 1, K), generator=g, device=dev).to(torch.bfloat16)
            x = buf[:, :qk.GEMV_MAX_M]
            before = qk.qmatmul_gemv_experts.launches
            y = qk.qmatmul_gemv_experts(x, packed, scales, cb, counts, **kw)
            plain = qk.qmatmul_experts_plain(x, packed, scales, cb, counts, **kw)
            torch.cuda.synchronize()
            require(qk.qmatmul_gemv_experts.launches == before + 1,
                    f"expert GEMV {N}x{K} {bits}-bit: not one launch")
            for e, c in enumerate(expert_rows):
                if not c:
                    continue
                one = qk.qmatmul_gemv_tc(x[e, :c].contiguous(), packed[e], scales[e], cb[e], **kw)
                torch.cuda.synchronize()
                require(torch.equal(y[e, :c].view(torch.int16), one.view(torch.int16)),
                        f"expert GEMV {N}x{K} {bits}-bit: expert {e}'s {c} rows differ from "
                        "its own launch")
                ref = plain[e, :c].float()
                err = float((y[e, :c].float() - ref).abs().max())
                require(err <= BF16_REL_TOL * float(ref.abs().max()),
                        f"expert GEMV {N}x{K} {bits}-bit expert {e}: {err} from the plain version")
                if bits == 4:
                    worst["gemv_moe"] = max(worst["gemv_moe"], err)
                n_checks += 2
            del packed, scales, buf, x, y, plain
            torch.cuda.empty_cache()
    return n_checks


def check_moe_gemv_slice(torch, dev, g) -> int:
    """The expert-batched GEMV on a rank's slice of an expert stack, the
    launch a "model" axis of 4 makes: moonshot-v1's 64 experts (gate/up
    and down shapes, 4-bit, block 64) of capacity buffers of 9 rows, one
    launch over all 64, then experts 16-31 alone: their words, scales and
    codebooks copied to their own storage, their buffers a view of the whole
    one's (as models/moe.py slices them), their counts the local ones.  Its
    rows equal those experts' rows of the whole-stack launch bit for bit.
    Returns the checks."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import qmatmul as qk

    E, e0, El = 64, 16, 16
    n_checks = 0
    for N, K in MOE_GEMV_SHAPES[:2]:
        bits, block = 4, 64
        kw = dict(bits=bits, block_size=block)
        counts = torch.randint(0, qk.GEMV_MAX_M + 1, (E,), generator=g, device=dev,
                               dtype=torch.int32)
        packed = torch.randint(-2**31, 2**31 - 1, (E, N, K // 8), generator=g, device=dev,
                               dtype=torch.int32)
        scales = (torch.rand((E, N, K // block), generator=g, device=dev) * 0.04
                  + 0.01).to(torch.bfloat16)
        cb = make_codebook("float", bits, device=dev).expand(E, -1).contiguous()
        buf = torch.randn((E, qk.GEMV_MAX_M + 1, K), generator=g, device=dev).to(torch.bfloat16)
        whole = qk.qmatmul_gemv_experts(buf[:, :qk.GEMV_MAX_M], packed, scales, cb, counts, **kw)
        mine = [t[e0:e0 + El].clone() for t in (packed, scales, cb)]
        before = qk.qmatmul_gemv_experts.launches
        part = qk.qmatmul_gemv_experts(buf[e0:e0 + El, :qk.GEMV_MAX_M], *mine,
                                       counts[e0:e0 + El].clone(), **kw)
        torch.cuda.synchronize()
        require(qk.qmatmul_gemv_experts.launches == before + 1,
                f"expert GEMV on a slice {N}x{K}: not one launch")
        for e in range(El):
            c = int(counts[e0 + e])
            require(torch.equal(part[e, :c].view(torch.int16),
                                whole[e0 + e, :c].view(torch.int16)),
                    f"expert GEMV on a slice {N}x{K}: expert {e0 + e}'s {c} rows differ from "
                    "the whole-stack launch")
            n_checks += 1
        del packed, scales, buf, whole, part, mine
        torch.cuda.empty_cache()
    return n_checks


def _pack_rows(torch, dev, g, cb, rows, cols, block):
    """[rows, cols] f32: blocks that hold the codebook's values and exact
    midpoints (absmax a power of two, so x / scale is exact), an all-zero
    row, then random rows of mixed scale."""
    special = torch.cat([cb, (cb[:-1] + cb[1:]) / 2.0])
    special = torch.cat([special, -special])
    chunks = special.split(block - 1)
    blocks = []
    for c in chunks:
        head = torch.ones(1, device=dev)
        blk = torch.nn.functional.pad(torch.cat([head, c]), (0, block - 1 - c.numel()))
        blocks.append(blk * 2.0 ** int(torch.randint(-6, 3, (1,), generator=g, device=dev)))
    flat = torch.cat(blocks)
    flat = torch.nn.functional.pad(flat, (0, -(-flat.numel() // cols) * cols - flat.numel()))
    exact = flat.reshape(-1, cols)[: rows // 2]
    rand = torch.randn((rows, cols), generator=g, device=dev) * torch.exp(
        2 * torch.randn((rows, 1), generator=g, device=dev))
    rand[: exact.shape[0]] = exact
    rand[rows - 1] = 0.0
    return rand


def check_pack(torch, dev, g, cfg, worst) -> int:
    """The encode to the stored form against its plain version: bit-exact
    words and scale bits over 3 to 8 bits, blocks 16 to 1024, the four data
    types, bf16 and f32 items, both layouts, odd row counts and word tails;
    then Qwen2-7B's five item shapes as the serve phase stores them."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as quantk

    n = 0

    def one(stored, cb, bits, block, transposed, what):
        nonlocal n
        kp, ks = quantk.quantize_pack_cuda(stored, cb, bits=bits, block_size=block,
                                           transposed=transposed)
        pp, ps = quantk.quantize_pack_plain(stored, cb, bits=bits, block_size=block,
                                            transposed=transposed)
        torch.cuda.synchronize()
        require(torch.equal(kp, pp) and torch.equal(ks.view(torch.int16), ps.view(torch.int16)),
                f"quantize_pack {what}: words or scale bits differ")
        worst["pack"] = max(worst["pack"], float((kp.long() - pp.long()).abs().max()),
                            float((ks.float() - ps.float()).abs().max()))
        n += 1

    for bits in range(3, 9):
        for dtype in ("int", "float", "dynamic", "quantile"):
            base = torch.randn((4096,), generator=g, device=dev)
            cb = make_codebook(dtype, bits, tensor=base)
            for block in (16, 32, 64, 128, 1024):
                rows, cols = (37, 3 * block) if block < 1024 else (9, 2 * block)
                w = _pack_rows(torch, dev, g, cb, rows, cols, block)
                for xdt in (torch.float32, torch.bfloat16):
                    x = w.to(xdt)
                    for transposed in (False, True):
                        stored = x.T.contiguous() if transposed else x
                        one(stored, cb, bits, block, transposed,
                            f"{bits}-bit {dtype} b{block} {xdt} transposed={transposed}")
    cb = make_codebook("float", 4, device=dev)
    for rows, cols in _qwen_items(cfg):
        transposed = rows != cfg.vocab_size
        shape = (cols, rows) if transposed else (rows, cols)
        stored = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        one(stored, cb, 4, 64, transposed, f"Qwen2-7B item {rows}x{cols}")
        del stored
        torch.cuda.empty_cache()
    # the windows, ssm and seq2seq phases' items (out, in), each as its layer
    # stores it
    for name, items in itertools.chain(_window_items().items(), _ssm_items().items(),
                                       [(S2S_ARCH, _s2s_items())]):
        for rows, cols, transposed in items:
            shape = (cols, rows) if transposed else (rows, cols)
            stored = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            one(stored, cb, 4, 64, transposed, f"{name} item {rows}x{cols}")
            del stored
            torch.cuda.empty_cache()
    return n


def _ssm_items() -> dict:
    """{arch: [(out, in, stored transposed)]} over the distinct matrices of
    the ssm phase's models: the SSM mixers' in_proj and out_proj, and
    jamba's wq, wk/wv, wo, w_gate/w_up, w_down and untied lm_head (its
    experts: check_moe_gemv)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm

    out = {}
    for name in (SSM_ARCH, JAMBA_ARCH):
        c = get_arch(name)
        D, F = c.d_model, c.d_ff
        out[name] = [(ssm.in_proj_dim(c), D, True), (D, c.d_inner, True)]
        if c.n_heads:
            QD, KD = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
            out[name] += [(QD, D, True), (KD, D, True), (D, QD, True), (F, D, True),
                          (D, F, True)]
        if not c.tie_embeddings:
            out[name].append((c.vocab_size, D, False))
    return out


def _s2s_items() -> list:
    """[(out, in, stored transposed)] over the distinct matrices of the
    seq2seq phase's model: frame_proj and the attention projections, the
    MLP's gate/up and down, and the untied lm_head."""
    from repro_torch.configs import get_arch

    c = get_arch(S2S_ARCH)
    D, F = c.d_model, c.d_ff
    return [(D, D, True), (F, D, True), (D, F, True), (c.vocab_size, D, False)]


def _window_items() -> dict:
    """{arch: [(out, in, stored transposed)]} over the distinct matrices of
    the windows phase's models: wq, wk/wv, wo, w_gate/w_up, w_down and an
    untied lm_head."""
    from repro_torch.configs import get_arch

    out = {}
    for name in ("h2o-danube-3-4b", "gemma2-27b"):
        c = get_arch(name)
        D, F = c.d_model, c.d_ff
        QD, KD = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        out[name] = [(QD, D, True), (KD, D, True), (D, QD, True), (F, D, True), (D, F, True)]
        if not c.tie_embeddings:
            out[name].append((c.vocab_size, D, False))
    return out


def _random_cache(torch, dev, g, spec, B, S, feat, n_holes=0):
    """A packed cache of S slots, every slot written, n_holes of them
    marked empty (pos -1)."""
    from repro_torch.kernels import kv_dequant as kvd

    cache = {}
    for name in ("k", "v"):
        x = torch.randn((B, S, feat), generator=g, device=dev).to(torch.bfloat16)
        cache[f"{name}_packed"], cache[f"{name}_scales"] = kvd.encode_rows(x, spec)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    if n_holes:
        holes = torch.randperm(S, generator=g, device=dev)[:n_holes]
        pos[holes] = -1
    cache["pos"] = pos
    return cache


def check_attention(torch, dev, g, cfg, worst) -> int:
    """The fused decode attention against its plain version, per (batch
    row, head) within ATT_REL_TOL of the row's max: kv4 and kv8, 1 to 4096
    slots, empty slots and pos short of the last slot, batch 1 and 4, at
    Qwen2-7B's heads and at tiny-650k's (kv_tol's model); a cache of
    MULTI_ROUND slots, whose CTA shares take more than one round of the
    kernel's shared memory; a logit soft-cap at 17 and 288 slots; and the
    Server's form, a [B] position over a [B, S] position array, with idle
    rows that must come out exactly 0."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    n = 0
    tiny = get_arch("tiny-650k")
    for c in (cfg, tiny):
        K, Dh, H = c.n_kv_heads, c.head_dim, c.n_heads
        for bits in (4, 8):
            spec = kvd.KVQuantSpec(bits=bits, block_size=c.kv_block_size, dtype_name="float")
            for S, batches, caps in ((1, (1, 4), (0.0,)), (17, (1, 4), (0.0, SOFTCAP)),
                                     (288, (1, 4), (0.0, SOFTCAP)),
                                     (LONG_CONTEXT, (1, 4), (0.0,)), (MULTI_ROUND, (1,), (0.0,))):
                for B, cap in itertools.product(batches, caps):
                    cache = _random_cache(torch, dev, g, spec, B, S, K * Dh, n_holes=S // 5)
                    q = torch.randn((B, H, Dh), generator=g, device=dev).to(torch.bfloat16)
                    for pos in sorted({S - 1, max(0, S - 3)}):
                        out = kat.decode_attention_packed_cuda(q, cache, pos, spec,
                                                               cap=cap).float()
                        ref = kat.decode_attention_packed_plain(q, cache, pos, spec,
                                                                cap=cap).float()
                        torch.cuda.synchronize()
                        gap = (out - ref).abs().amax(-1)
                        lim = ATT_REL_TOL * ref.abs().amax(-1)
                        require(bool(torch.isfinite(out).all()) and bool((gap <= lim).all()),
                                f"kv_decode_attention {c.name} kv{bits} S={S} B={B} pos={pos} "
                                f"cap={cap}: max gap {float(gap.max())} over the row's "
                                f"2^-6 * max")
                        if c is cfg:
                            worst["attn"] = max(worst["attn"], float(gap.max()))
                        n += 1
            # the Server's decode: a position a row over a position array a
            # row, each row its own length, rows 1 and 5 idle (pos -1)
            for S in (17, 288, SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]):
                B = SERVER_SLOTS
                cache = _random_cache(torch, dev, g, spec, B, S, K * Dh)
                lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
                ar = torch.arange(S, device=dev)
                cache["pos"] = torch.where(ar[None, :] < lens[:, None], ar[None, :],
                                           torch.full_like(ar, -1)[None, :]).to(torch.int32)
                pos = (lens - 1).to(torch.int32)
                pos[1] = -1
                pos[5] = -1
                q = torch.randn((B, H, Dh), generator=g, device=dev).to(torch.bfloat16)
                out = kat.decode_attention_packed_cuda(q, cache, pos, spec).float()
                ref = kat.decode_attention_packed_plain(q, cache, pos, spec).float()
                torch.cuda.synchronize()
                gap = (out - ref).abs().amax(-1)
                lim = ATT_REL_TOL * ref.abs().amax(-1)
                require(bool(torch.isfinite(out).all()) and bool((gap <= lim).all()),
                        f"kv_decode_attention {c.name} kv{bits} S={S} at a position a row: max "
                        f"gap {float(gap.max())} over the row's 2^-6 * max")
                require(not bool(out[[1, 5]].abs().any()) and not bool(ref[[1, 5]].abs().any()),
                        f"kv_decode_attention {c.name} kv{bits} S={S}: idle rows not exactly 0")
                if c is cfg:
                    worst["attn"] = max(worst["attn"], float(gap.max()))
                n += 1
    n += check_paged_attention(torch, dev, g, cfg, worst)
    return n


def _paged_from_rows(torch, dev, g, cache, page_size, spare=3):
    """The [B, S] rows of a per-row cache laid out in pages of page_size
    under a shuffled page map [B, S / page_size]: (page-major cache with
    `spare` unused pages and the empty trash page 0, page map)."""
    B, S = cache["pos"].shape
    P = S // page_size
    n_pages = B * P + 1 + spare
    ids = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * P] + 1).to(torch.int32)
    page_map = ids.reshape(B, P).contiguous()
    paged = {}
    for key, leaf in cache.items():
        out = torch.zeros((n_pages, page_size) + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                          device=dev)
        if key == "pos":
            out.fill_(-1)
        out[page_map.reshape(-1).long()] = leaf.reshape((B * P, page_size)
                                                         + tuple(leaf.shape[2:]))
        paged[key] = out
    return paged, page_map


def check_paged_attention(torch, dev, g, cfg, worst) -> int:
    """The fused attention over a paged cache, at Qwen2-7B's heads, kv4 and
    kv8, pages of PAGED_CHECK_SIZES: the Server's form (a position a row,
    rows 2 and 5 idle, rows of their own lengths) at the pool's length, and
    4 rows at LONG_CONTEXT; a shuffled page map whose row 1 shares row 0's
    first page (its positions then row 0's) and whose row 3 points its last
    entry at the trash page.  Gates: bit-identical to the unpaged kernel on
    the same cache gathered into rows (the same bytes in the same order),
    within ATT_REL_TOL of each row's max of the paged plain version, idle
    rows exactly 0."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    K, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    n = 0
    for bits, ps in itertools.product((4, 8), PAGED_CHECK_SIZES):
        spec = kvd.KVQuantSpec(bits=bits, block_size=cfg.kv_block_size, dtype_name="float")
        for B, S in ((SERVER_SLOTS, SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]),
                     (4, LONG_CONTEXT)):
            rows = _random_cache(torch, dev, g, spec, B, S, K * Dh)
            lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
            ar = torch.arange(S, device=dev)
            rows["pos"] = torch.where(ar[None, :] < lens[:, None], ar[None, :],
                                      torch.full_like(ar, -1)[None, :]).to(torch.int32)
            holes = torch.rand((B, S), generator=g, device=dev) < 0.1
            rows["pos"][holes] = -1
            cache, page_map = _paged_from_rows(torch, dev, g, rows, ps)
            page_map[1, 0] = page_map[0, 0]
            page_map[3, -1] = 0
            pos = (lens - 1).to(torch.int32)
            idle = [2, 5] if B > 5 else [2]
            pos[idle] = -1
            q = torch.randn((B, H, Dh), generator=g, device=dev).to(torch.bfloat16)
            out = kat.decode_attention_packed_cuda(q, cache, pos, spec, page_map=page_map,
                                                   page_size=ps)
            gathered = {key: kvd.gather_pages(leaf, page_map).contiguous()
                        for key, leaf in cache.items()}
            unpaged = kat.decode_attention_packed_cuda(q, gathered, pos, spec)
            ref = kat.decode_attention_packed_plain(q, cache, pos, spec, page_map=page_map,
                                                    page_size=ps).float()
            torch.cuda.synchronize()
            gap = (out.float() - ref).abs().amax(-1)
            lim = ATT_REL_TOL * ref.abs().amax(-1)
            where = f"kv_decode_attention paged kv{bits} ps={ps} B={B} S={S}"
            require(bool(torch.equal(out.view(torch.int16), unpaged.view(torch.int16))),
                    f"{where}: differs from the unpaged kernel on the gathered cache")
            require(bool(torch.isfinite(out).all()) and bool((gap <= lim).all()),
                    f"{where}: max gap {float(gap.max())} over the row's 2^-6 * max")
            require(not bool(out[idle].abs().any()), f"{where}: idle rows not exactly 0")
            worst["attn"] = max(worst["attn"], float(gap.max()))
            n += 1
    return n


def check_routed(torch, dev, g, cfg, worst) -> int:
    """The routed read (kv_attention.decode_attention_packed on shapes that
    fused_takes refuses: the KV dequant, then the models' partials) against
    its plain version, per (batch row, head) within ATT_REL_TOL of the row's
    max: tiny-10m's heads (Dh 56, G 1) and h2o-danube-3-4b's head dim (Dh
    120, G 8) at kv4 and kv8 in the Server's form (a position a row, rows 2
    and 5 idle, exactly 0), and a LONG_ROUTED-slot cache at Qwen2-7B's heads;
    each paged (pages of 16) bit-identical to its rows.  Each call launches
    the KV dequant once and the fused attention never, whose wrapper raises
    on the same call before any launch."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    n = 0
    for bits, B, S, K, G, Dh in ((4, SERVER_SLOTS, ROUTED_LEN, 8, 1, 56),
                                 (8, SERVER_SLOTS, ROUTED_LEN, 8, 1, 56),
                                 (4, SERVER_SLOTS, 288, 2, 8, 120), (8, 2, 160, 2, 8, 120),
                                 (4, 1, LONG_ROUTED, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                                  cfg.head_dim)):
        spec = kvd.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
        feat = K * Dh
        require(not kat.fused_takes(B, K * G, Dh, S, spec, feat),
                f"the fused attention takes Dh {Dh}, G {G}, {S} slots")
        cache = _random_cache(torch, dev, g, spec, B, S, feat)
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        ar = torch.arange(S, device=dev)
        cache["pos"] = torch.where(ar[None, :] < lens[:, None], ar[None, :],
                                   torch.full_like(ar, -1)[None, :]).to(torch.int32)
        pos = (lens - 1).to(torch.int32)
        idle = [i for i in (2, 5) if i < B]
        pos[idle] = -1
        q = torch.randn((B, K * G, Dh), generator=g, device=dev).to(torch.bfloat16)
        before = _counts()
        out = kat.decode_attention_packed(q, cache, pos, spec)
        paged, page_map = _paged_from_rows(torch, dev, g, cache, PAGE_SIZE)
        out_p = kat.decode_attention_packed(q, paged, pos, spec, page_map=page_map,
                                            page_size=PAGE_SIZE)
        after = _counts()
        ref = kat.decode_attention_packed_plain(q, cache, pos, spec).float()
        torch.cuda.synchronize()
        where = f"routed read kv{bits} B={B} S={S} K={K} G={G} Dh={Dh}"
        require(after["kv"] - before["kv"] == 2 and after["attn"] == before["attn"],
                f"{where}: {after} launches after {before}")
        gap = (out.float() - ref).abs().amax(-1)
        require(bool(torch.isfinite(out).all())
                and bool((gap <= ATT_REL_TOL * ref.abs().amax(-1)).all()),
                f"{where}: max gap {float(gap.max())} over the row's 2^-6 * max")
        require(not bool(out[idle].abs().any()), f"{where}: idle rows not exactly 0")
        require(torch.equal(out_p.view(torch.int16), out.view(torch.int16)),
                f"{where}: paged differs from rows")
        try:
            kat.decode_attention_packed_cuda(q, cache, pos, spec)
            raised = False
        except ValueError:
            raised = True
        require(raised and _counts() == after,
                f"{where}: the fused attention's wrapper did not raise before a launch")
        worst["routed"] = max(worst["routed"], float(gap.max()))
        n += 2
        del cache, paged
    return n


def _ring_cache(torch, dev, g, spec, B, S, feat, ends):
    """A packed ring of S slots a row whose row b holds positions up to
    ends[b] at slot p % S (the oldest S of them; a row that has not wrapped
    keeps its unwritten slots at -1), rows at ends[b] < 0 idle and empty."""
    cache = _random_cache(torch, dev, g, spec, B, S, feat)
    slot = torch.arange(S, device=dev)[None, :]
    end = ends[:, None].to(torch.int64)
    # the position in each slot: the latest p <= end with p % S == slot
    pos = end - ((end - slot) % S)
    cache["pos"] = torch.where((pos >= 0) & (end >= 0), pos, -1).to(torch.int32)
    return cache


def check_ring(torch, dev, g, worst) -> int:
    """The routed read over ring caches (a sliding window: the fused
    attention refuses it) against its plain version, within ATT_REL_TOL of
    each row's max: kv4 and kv8 at h2o-danube-3-4b's heads (Dh 120, K 8,
    G 4) and gemma2-27b's (Dh 128, K 16, G 2, soft-cap 50), a 4096-slot ring
    and window, a shared position past the ring (wrapped: slot order is not
    position order) and a position a row (wrapped, not yet wrapped, idle
    rows exactly 0); one KV dequant launch a call, no fused attention, its
    wrapper raising first.  Then the fused attention at gemma2's global
    layers' shape (4224 slots, soft-cap 50), as the windows phase calls it."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    n, S = 0, 4096
    W = S   # a ring as long as the window, as the windowed layers keep it
    for bits, K, G, Dh, cap in ((4, 8, 4, 120, 0.0), (8, 8, 4, 120, 0.0), (4, 16, 2, 128, 50.0),
                                (8, 16, 2, 128, 50.0)):
        spec = kvd.KVQuantSpec(bits=bits, block_size=64, dtype_name="float")
        feat = K * Dh
        for B, ends in ((WIN_BATCH, [S + 700] * WIN_BATCH),
                        (WIN_SLOTS, [S + 37, -1, S // 2, 2 * S + 5])):
            ends = torch.tensor(ends, dtype=torch.int32, device=dev)
            cache = _ring_cache(torch, dev, g, spec, B, S, feat, ends)
            shared = len(set(ends.tolist())) == 1
            if shared:
                cache["pos"] = cache["pos"][0].contiguous()
                pos = ends[0].clone()
            else:
                pos = ends.clone()
            q = torch.randn((B, K * G, Dh), generator=g, device=dev).to(torch.bfloat16)
            require(not kat.fused_takes(B, K * G, Dh, S, spec, feat, W),
                    "the fused attention takes a window")
            before = _counts()
            out = kat.decode_attention_packed(q, cache, pos, spec, cap=cap, window=W)
            after = _counts()
            ref = kat.decode_attention_packed_plain(q, cache, pos, spec, cap=cap,
                                                    window=W).float()
            torch.cuda.synchronize()
            where = (f"ring read kv{bits} Dh={Dh} K={K} G={G} S={S} "
                     f"{'shared' if shared else 'per-row'} positions {ends.tolist()}")
            require(after["kv"] - before["kv"] == 1 and after["attn"] == before["attn"],
                    f"{where}: {after} launches after {before}")
            gap = (out.float() - ref).abs().amax(-1)
            require(bool(torch.isfinite(out).all())
                    and bool((gap <= ATT_REL_TOL * ref.abs().amax(-1)).all()),
                    f"{where}: max gap {float(gap.max())} over the row's 2^-6 * max")
            idle = (ends < 0).nonzero().flatten().tolist()
            require(not bool(out[idle].abs().any()), f"{where}: idle rows not exactly 0")
            try:
                kat.decode_attention_packed_cuda(q, cache, pos, spec, cap=cap, window=W)
                raised = False
            except ValueError:
                raised = True
            require(raised and _counts() == after,
                    f"{where}: the fused attention's wrapper did not raise before a launch")
            worst["routed"] = max(worst["routed"], float(gap.max()))
            n += 1
        if K == 16:   # gemma2's global layers: the fused kernel, full cache, soft-cap
            cache = _random_cache(torch, dev, g, spec, WIN_BATCH, WIN_CACHE, feat, n_holes=64)
            q = torch.randn((WIN_BATCH, K * G, Dh), generator=g, device=dev).to(torch.bfloat16)
            pos = WIN_CACHE - 1
            out = kat.decode_attention_packed_cuda(q, cache, pos, spec, cap=cap).float()
            ref = kat.decode_attention_packed_plain(q, cache, pos, spec, cap=cap).float()
            torch.cuda.synchronize()
            gap = (out - ref).abs().amax(-1)
            require(bool(torch.isfinite(out).all())
                    and bool((gap <= ATT_REL_TOL * ref.abs().amax(-1)).all()),
                    f"kv_decode_attention gemma2 global kv{bits}: max gap {float(gap.max())}")
            worst["attn"] = max(worst["attn"], float(gap.max()))
            n += 1
    return n


def _qwen_items(cfg) -> dict:
    """{(rows, cols): encodes in one whole-model quantization} over the
    distinct shapes of Qwen2-7B's quantized matrices as stored (out, in):
    wq/wo, wk/wv, w_gate/w_up, w_down, lm_head."""
    D, F, KD, V = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim, cfg.vocab_size
    L = cfg.n_layers
    return {(D, D): 2 * L, (KD, D): 2 * L, (F, D): 2 * L, (D, F): L,
            (V, D): 0 if cfg.tie_embeddings else 1}


#: chip_smoke's names for the kernels' launch counters, in the order of
#: kernels/launches.snapshot()
_COUNT_KEYS = ("gemv", "gemv_tc", "gemv_simt", "gemm", "gemm_simt", "kv", "attn", "b3", "pack",
               "gemv_moe")


def _counts():
    from repro_torch.kernels import launches

    return dict(zip(_COUNT_KEYS, launches.snapshot(), strict=True))


def _reset_counts():
    from repro_torch.kernels import launches

    launches.add([-n for n in launches.snapshot()])


def serve_main_path(torch, dev) -> dict:
    """Phase 3: Qwen2-7B served by Engine through the kernels."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import Engine

    cfg = get_arch(ARCH).with_kv_quant(KV_BITS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _reset_counts()
    # the quantization's own peak (the init's transients peak higher)
    init_peak_bytes = torch.cuda.max_memory_allocated()
    params_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64),
                              cfg, device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    quantize_peak_bytes = torch.cuda.max_memory_allocated()
    per_layer = 7   # wq, wk, wv, wo, w_gate, w_up, w_down
    quant_counts = _counts()
    n_items = per_layer * cfg.n_layers + (0 if cfg.tie_embeddings else 1)   # + lm_head
    require(quant_counts == {**dict.fromkeys(_COUNT_KEYS, 0), "pack": n_items},
            f"quantize_params launched {quant_counts}, want {n_items} quantize_pack launches")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=_gen(torch, dev, SEED + 2),
                            device=dev)
    engine = Engine(qparams, cfg, max_seq_len=PROMPT + NEW_TOKENS, device=dev)
    n_steps = NEW_TOKENS - 1
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = cfg.n_layers   # one fused attention a layer

    # the main path: a fresh Engine's generate.  Its first decode step
    # captures the step: the capture's warm-up call launches one step, the
    # recording launches nothing and each replay launches one step
    _reset_counts()
    with _capture_guard(torch) as syncs:
        tokens = engine.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    counts = _counts()
    require(not syncs, f"the captured decode step syncs with the host: {syncs[:5]}")
    require(tuple(tokens.shape) == (BATCH, NEW_TOKENS), f"tokens shape {tuple(tokens.shape)}")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "tokens out of range")
    require(counts["gemm"] == per_layer * cfg.n_layers,
            f"prefill: {counts['gemm']} tiled qmatmul launches")
    require(counts["gemv"] == 1 + NEW_TOKENS * b1_step,
            f"{counts['gemv']} GEMV launches, want 1 (the prefill's head) + {NEW_TOKENS} x "
            f"{b1_step} (the capture's warm-up and {n_steps} replays)")
    require(counts["gemv_tc"] == counts["gemv"],
            f"{counts['gemv_tc']} of {counts['gemv']} GEMV launches on the tensor cores")
    require(counts["attn"] == NEW_TOKENS * b2_step and counts["kv"] == 0,
            f"{counts['attn']} fused attention and {counts['kv']} kv dequant launches, want "
            f"{NEW_TOKENS} x {b2_step} and 0")

    # prefill alone (and the first token), then the whole run again: each
    # decode step a replay of the graph captured above
    engine.generate(prompts, 1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    engine.generate(prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t3
    t4 = time.perf_counter()
    again = engine.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t4
    require(torch.equal(again, tokens), "a second generate gave other tokens")
    # the same steps eagerly: the same kernels at the same shapes, so the
    # same tokens, at kv16, kv8 and kv4 with 4-bit weights
    eager, eager_ms = _eager_generate(torch, qparams, cfg, prompts)
    identical = {KV_BITS: bool(torch.equal(eager, tokens))}
    for kv in (16, 8):
        c = cfg.with_kv_quant(kv)
        graph_toks = Engine(qparams, c, max_seq_len=PROMPT + NEW_TOKENS,
                            device=dev).generate(prompts, NEW_TOKENS)
        identical[kv] = bool(torch.equal(_eager_generate(torch, qparams, c, prompts)[0],
                                         graph_toks))
    require(all(identical.values()), f"graph tokens differ from eager ones: {identical}")
    # sampling inside the captured step: the tokens and the generator state
    # that eager steps give from the same seed, at two temperatures that
    # replay the batch's one captured step
    for temperature, seed in ((0.7, SEED + 3), (1.3, SEED + 4)):
        mine, theirs = _gen(torch, dev, seed), _gen(torch, dev, seed)
        sampled = engine.generate(prompts, NEW_TOKENS, temperature=temperature, generator=mine)
        eager_s = _eager_generate(torch, qparams, cfg, prompts, temperature, theirs)[0]
        require(torch.equal(sampled, eager_s) and not torch.equal(sampled, tokens)
                and torch.equal(mine.get_state(), theirs.get_state()),
                f"sampled graph tokens at temperature {temperature} differ from eager ones")
    require(list(engine._graphs) == [BATCH], f"captured steps {list(engine._graphs)}")
    peak_bytes = max(init_peak_bytes, torch.cuda.max_memory_allocated())

    # one more prefill and decode step with logits in hand
    logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=PROMPT + NEW_TOKENS)
    _reset_counts()
    step_logits, _ = lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg)
    torch.cuda.synchronize()
    step_counts = _counts()
    require(bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all()),
            "non-finite logits")
    require(step_counts == {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": b1_step,
                            "gemv_tc": b1_step, "attn": b2_step},
            f"one decode step launched {step_counts}")
    _reset_counts()
    engine._graphs[BATCH].step.replay()   # the static state is reloaded by each generate
    torch.cuda.synchronize()
    require(_counts() == step_counts, f"one replay launched {_counts()}")
    # the same step's device time alone: replayed from a CUDA graph, without
    # the host's eager PyTorch overhead that the step above includes
    step_device_ms = _time_ms(
        torch, lambda: lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg), 5)
    del caches, logits, step_logits
    emit({"phase": "serve", "arch": ARCH, "depth": cfg.n_layers, "width": cfg.d_model,
          "weights": "4-bit float b64", "kv_bits": KV_BITS, "batch": BATCH,
          "prompt_len": PROMPT, "new_tokens": NEW_TOKENS,
          "init_s": t1 - t0, "quantize_s": t2 - t1, "prefill_s": prefill_s,
          "decode_ms_per_step": (total_s - prefill_s) / n_steps * 1e3,
          "decode_ms_per_step_eager": eager_ms,
          "decode_step_device_ms": step_device_ms,
          "graph_tokens_equal_eager": {f"kv{k}": v for k, v in identical.items()},
          "host_syncs_in_captured_step": len(syncs),
          "tokens_per_s": BATCH * NEW_TOKENS / total_s, "generate_s": total_s,
          "max_memory_allocated_bytes": peak_bytes,
          "quantize_peak_bytes": quantize_peak_bytes,
          "quantize_peak_over_bf16_params_bytes": quantize_peak_bytes - params_bytes,
          "launches": counts, "launches_per_decode_step": step_counts,
          "launches_quantize": quant_counts})
    require(counts["b3"] == counts["pack"] == 0, f"generate launched encodes: {counts}")
    generate_counts = dict(counts)
    counts["b3"], counts["pack"] = quant_counts["b3"], quant_counts["pack"]
    return {"cfg": cfg, "qparams": qparams, "prompts": prompts, "counts": counts,
            "tokens": tokens, "generate_counts": generate_counts, "step_counts": step_counts}


def _capture_guard(torch):
    """The capture guard of reprolint's auditor
    (``repro_torch.analysis.audit._capture_guard``): records every host sync
    of a CUDA tensor inside the bodies the port captures, while open."""
    from repro_torch.analysis.audit import _capture_guard as guard

    return guard(torch)


def audit_path(torch, dev, run) -> None:
    """Phase 3k: reprolint's captured-graph auditor (analysis/audit.py):
    tiny-160k's grid at kv16, kv8 and kv4 (the Engine, the slot Server with
    a forced preemption, the chunked and the paged Server, the 4-bit fused
    slot Server), then the serve phase's Qwen2-7B tree: the Engine's batch
    decode graph and the Server's pool graph (SERVER_SLOTS slots, a forced
    preemption), each 0 host nodes, 0 host memcpys, 0 host syncs, one
    capture, 197 tensor-core GEMV and 28 fused-attention nodes."""
    from repro_torch.analysis import audit

    t0 = time.perf_counter()
    dots = ROOT / "build" / "audit"
    report = audit.run_audit(device=dev, dot_dir=dots)
    audit.audit_full(report, run["qparams"], run["cfg"], device=dev, dot_dir=dots,
                     batch=BATCH, prompt_len=PROMPT, new_tokens=AUDIT_NEW_TOKENS,
                     num_slots=SERVER_SLOTS,
                     slot_len=SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    full = {p: {"kernel_nodes": sum(f.values()), "families": dict(f.most_common())}
            for p, f in report.families.items() if ARCH in p}
    emit({"phase": "audit", "seconds": seconds, "checks": len(report.checks),
          "failed": [c.render() for c in report.failures()],
          "verdicts": {f"{c.program} {c.check}": ("ok " if c.ok else "FAIL ") + c.detail
                       for c in report.checks},
          "full_width_graphs": full,
          "tiny_kernel_nodes": {p: sum(f.values()) for p, f in report.families.items()
                                if ARCH not in p}})
    require(report.ok, f"audit: {len(report.failures())} checks failed: "
            + "; ".join(c.render() for c in report.failures()[:5]))
    require(len(full) == 2, f"audit: full-width graphs {sorted(full)}")


def _eager_generate(torch, qparams, cfg, prompts, temperature=0.0, generator=None):
    """Tokens of eager lm.decode_step calls (no graph), sampled as
    Engine.generate samples, and the host clock's ms a step."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import sample_token

    with torch.inference_mode():
        logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=PROMPT + NEW_TOKENS)
        tok = sample_token(logits, generator, temperature)
        out = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, NEW_TOKENS):
            logits, caches = lm.decode_step(qparams, tok, caches, PROMPT + t - 1, cfg)
            tok = sample_token(logits, generator, temperature)
            out.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (NEW_TOKENS - 1) * 1e3
    return torch.stack(out, dim=1), ms


def serve_low_bits(torch, dev, run) -> dict:
    """Phase 3a: the serve phase's Engine, prompts and kv4 cache with the same
    seeded weights quantized at each of LOW_BITS (4-bit float's sibling
    widths, block 64), one width at a time.  Per width: the main path's run
    (a fresh Engine's generate, its counts set to 0 just before and read
    just after), captured tokens against eager ones, one replay's launches,
    fused vs dequant_einsum logits, and the step's GEMVs timed."""
    from repro_torch.configs import QuantConfig
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import Engine

    cfg, prompts = run["cfg"], run["prompts"]
    b1_step, b2_step = 7 * cfg.n_layers + 1, cfg.n_layers
    step_counts = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": b1_step, "gemv_tc": b1_step,
                   "attn": b2_step}
    g = _gen(torch, dev, SEED + 6)
    params = lm.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    out = {}
    for bits in LOW_BITS:
        t0 = time.perf_counter()
        qparams = quantize_params(params, QuantConfig(bits=bits, dtype="float", block_size=64),
                                  cfg, device=dev)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        engine = Engine(qparams, cfg, max_seq_len=PROMPT + NEW_TOKENS, device=dev)
        _reset_counts()
        with _capture_guard(torch) as syncs:
            tokens = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        counts = _counts()
        require(not syncs, f"{bits} bits: the captured step syncs with the host: {syncs[:5]}")
        require(tuple(tokens.shape) == (BATCH, NEW_TOKENS)
                and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                f"{bits} bits: tokens of shape {tuple(tokens.shape)} or out of range")
        require(counts["gemv"] == counts["gemv_tc"] == 1 + NEW_TOKENS * b1_step
                and counts["gemv_simt"] == 0 and counts["attn"] == NEW_TOKENS * b2_step
                and counts["kv"] == 0,
                f"{bits} bits: generate launched {counts}, want every GEMV on the tensor cores")
        engine.generate(prompts, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.generate(prompts, 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        again = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t2
        eager, eager_ms = _eager_generate(torch, qparams, cfg, prompts)
        require(torch.equal(again, tokens) and torch.equal(eager, tokens),
                f"{bits} bits: graph tokens differ from eager ones")
        _reset_counts()
        engine._graphs[BATCH].step.replay()
        torch.cuda.synchronize()
        replay = _counts()
        require(replay == step_counts, f"{bits} bits: one replay launched {replay}")
        modes = _mode_gap(torch, qparams, cfg, prompts)
        del engine
        times = _time_step_gemvs(torch, dev, cfg, qparams, g)
        prefill_gemms = _time_prefill_gemms(torch, dev, cfg, qparams, g)
        out[bits] = {**times, "launches": counts}
        emit({"phase": "bits", "arch": ARCH, "weights": f"{bits}-bit float b64",
              "kv_bits": KV_BITS, "batch": BATCH, "prompt_len": PROMPT, "new_tokens": NEW_TOKENS,
              "quantize_s": quantize_s, "prefill_s": prefill_s,
              "decode_ms_per_step": (generate_s - prefill_s) / (NEW_TOKENS - 1) * 1e3,
              "decode_ms_per_step_eager": eager_ms, "graph_tokens_equal_eager": True,
              "host_syncs_in_captured_step": len(syncs), "launches": counts,
              "launches_per_replay": replay, "modes": modes, "gemv_step": times,
              "prefill_gemms": prefill_gemms})
        del qparams
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def _server_requests(cfg):
    """SERVER_REQUESTS requests from a seed: prompts of uniform random tokens
    (16-512), budgets of 16-64 new tokens.  The first SERVER_SLOTS arrive
    at step 0 and fill the pool (class 1, background); the rest arrive one
    every two steps from step 4 (class 0, urgent), while the pool is busy."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    reqs = []
    for i in range(SERVER_REQUESTS):
        L = int(rng.integers(SERVER_PROMPT_LENS[0], SERVER_PROMPT_LENS[1] + 1))
        background = i < SERVER_SLOTS
        reqs.append({"prompt": rng.integers(0, cfg.vocab_size, L),
                     "max_new": int(rng.integers(SERVER_NEW_TOKENS[0], SERVER_NEW_TOKENS[1] + 1)),
                     "arrival_time": 0.0 if background else float(4 + 2 * (i - SERVER_SLOTS)),
                     "priority": 1 if background else 0})
    return reqs


def _checked_server(torch):
    """The port's Server with two checks chip_smoke adds: each decode step's
    logits rows of the decoding requests are kept (for the teacher-forced
    comparison), and every restore of a spilled slot is read back (a slot
    row; paged, its private pages) and held bit for bit against the
    spill."""
    from repro_torch.models import lm
    from repro_torch.serving import Server
    from repro_torch.serving.engine import sample_token

    class Checked(Server):
        def __init__(self, *args, **kwargs):
            self.kept = {}       # request id -> logits rows, one a decode step
            self.restores = 0
            super().__init__(*args, **kwargs)

        def _decode_body(self):
            logits, _ = lm.decode_step(self.params, self._tok, self.pool.caches,
                                       self.pool._pos_dev, self.cfg,
                                       decode_attn=self._decode_attn)
            if not hasattr(self, "logits"):
                self.logits = torch.empty_like(logits)   # allocated by the warm-up call
            self.logits.copy_(logits)
            self._nxt.copy_(sample_token(logits, self._gen, self._temps_dev))

        def _decode_once(self):
            rows = {slot: req.id for slot, req in self.scheduler.running.items()
                    if slot not in self._chunking}
            n = super()._decode_once()
            for slot, rid in rows.items():
                self.kept.setdefault(rid, []).append(self.logits[slot].clone())
            return n

        def _resume(self, req, slot):
            spill = self._spilled[req.id]
            super()._resume(req, slot)
            again = (self.pool.private_rows(slot) if self._paged
                     else self.pool.spill_slot(slot)["rows"])
            same = all(torch.equal(a[k].view(torch.int16) if a[k].dtype == torch.bfloat16
                                   else a[k],
                                   b[k].view(torch.int16) if b[k].dtype == torch.bfloat16
                                   else b[k])
                       for a, b in zip(again, spill["rows"]) for k in a)
            require(same and self.pool.next_pos[slot] == spill["next_pos"],
                    f"request {req.id}: the restored slot {slot} differs from its spill")
            self.restores += 1

    return Checked


def _drive_server(torch, srv, traffic, *, classes=False):
    """Submit ``traffic`` to a Server, run it until drained and check it as
    it serves: every token in range, the pool's busy slots the scheduler's
    running ones, positions inside a row; then every request answered within
    its budget and the pool whole again (a paged pool: every page free, no
    reference, nothing retained or sealed).  Returns (ids, tokens, wall
    seconds, peak): the most residents at once and, paged, the pages in use
    at that peak."""
    pool, n_slots = srv.pool, srv.pool.num_slots
    peak = {"residents": 0, "pages": 0}

    def check(_rid, tok):
        require(0 <= tok < srv.cfg.vocab_size, f"token {tok} out of range")
        require(pool.n_free + pool.n_active == n_slots, "slots leaked")
        busy = [s for s in range(n_slots) if pool.active[s]]
        require(sorted(srv.scheduler.running) == busy, "running slots != active slots")
        require(all(0 <= pool.next_pos[s] <= pool.cache_len for s in busy
                    if s not in srv._chunking), "a slot's position out of its row")
        n = len(busy)
        if srv._paged and n >= peak["residents"]:
            used = pool.allocator.n_usable - pool.allocator.n_free
            peak["pages"] = used if n > peak["residents"] else max(peak["pages"], used)
        peak["residents"] = max(peak["residents"], n)

    ids = [srv.submit(r["prompt"], r["max_new"], arrival_time=r["arrival_time"],
                      priority=r["priority"] if classes else 0, on_token=check)
           for r in traffic]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [res[i] for i in ids]
    require(all(1 <= len(t) <= r["max_new"] for t, r in zip(toks, traffic)),
            "a request went unanswered or past its budget")
    require(pool.n_free == n_slots and srv.scheduler.drained, "pool not drained")
    if srv._paged:
        a = pool.allocator
        require(a.n_free == a.n_usable and not a.ref and not a.retained and not a.prefix_index,
                "pages left after the drain")
    return ids, toks, wall, peak


def server_path(torch, dev, run) -> dict:
    """Phase 3b: the continuous-batching Server on Qwen2-7B at full width
    and depth, 4-bit weights, a kv4 cache, SERVER_SLOTS slots."""
    from repro_torch.serving import Server, Telemetry

    cfg, qparams = run["cfg"], run["qparams"]
    reqs = _server_requests(cfg)
    cache_len = SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]
    per_layer = 7
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = cfg.n_layers
    Checked = _checked_server(torch)

    def serve(cls, *, classes=False, **kw):
        srv = cls(qparams, cfg, num_slots=SERVER_SLOTS, max_seq_len=cache_len, device=dev,
                  **kw)
        ids, toks, wall, _ = _drive_server(torch, srv, reqs, classes=classes)
        return srv, ids, toks, wall

    # the main path: a fresh Server (its construction captures the step: the
    # warm-up launches one step, each replay one more) serving the traffic
    with torch.inference_mode():
        tel = Telemetry()
        _reset_counts()
        with _capture_guard(torch) as syncs:
            srv, ids, plain, wall = serve(Server, telemetry=tel)
        counts = _counts()
        require(not syncs, f"the Server's captured step syncs with the host: {syncs[:5]}")
        reg = tel.registry
        admissions = int(reg.counter("serve_prefills_total").value)
        steps = int(reg.counter("serve_decode_steps_total").value)
        require(admissions == SERVER_REQUESTS, f"{admissions} admissions")
        require(counts["attn"] == (1 + steps) * b2_step and counts["kv"] == 0,
                f"server: {counts['attn']} fused attentions, want (1 + {steps}) x {b2_step} "
                f"(the warm-up and {steps} replays)")
        require(counts["gemm"] == per_layer * cfg.n_layers * admissions
                and counts["gemv"] == counts["gemv_tc"] == (1 + steps) * b1_step + admissions,
                f"server launches {counts} for {admissions} admissions and {steps} steps")
        # one decode step over the (now idle) pool, eagerly: its launches
        _reset_counts()
        srv._decode_body()
        torch.cuda.synchronize()
        step_counts = _counts()
        require(step_counts == {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": b1_step,
                                "gemv_tc": b1_step, "attn": b2_step},
                f"one decode step over the pool launched {step_counts}")
        _reset_counts()
        srv._graph.replay()
        torch.cuda.synchronize()
        require(_counts() == step_counts, f"one replay over the pool launched {_counts()}")
        step_device_ms = _time_graph(torch, srv._graph, 10)
        ttft = reg.histogram("serve_ttft_seconds")
        step_s = reg.histogram("serve_decode_step_seconds")
        prefill_s = reg.histogram("serve_prefill_seconds")
        n_tokens = sum(len(t) for t in plain)
        del srv

        # the same traffic: logits kept, then chunked, then two classes with
        # preemption; every request's tokens as in the plain run
        srv_r, rec_ids, kept_toks, _ = serve(Checked)
        require(kept_toks == plain, "the Server gave other tokens on the same traffic")
        tel_c = Telemetry()
        srv_c, _, chunked, _ = serve(Server, telemetry=tel_c, prefill_chunk=SERVER_CHUNK)
        n_chunks = int(tel_c.registry.counter("serve_prefill_chunks_total").value)
        require(n_chunks > 0, "no prefill chunk ran")
        require(chunked == plain, "chunked prefill changed tokens: "
                f"{sum(a != b for a, b in zip(chunked, plain))} requests differ")
        del srv_c
        srv_p, _, preempted, _ = serve(Checked, classes=True, max_preemptions=2)
        n_pre = srv_p.scheduler.n_preemptions
        require(n_pre >= 1, "the two-class traffic forced no preemption")
        require(srv_p.restores == n_pre, "a preempted request was not restored")
        require(preempted == plain, "preemption changed tokens: "
                f"{sum(a != b for a, b in zip(preempted, plain))} requests differ")
        del srv_p

        # each request teacher-forced on the Server's tokens through the
        # Engine's step at batch 1, against the Server's kept logits
        worst, ties, first_ties = _teacher_forced(torch, qparams, cfg, reqs, plain,
                                                  [srv_r.kept[i] for i in rec_ids], cache_len)
        del srv_r
    emit({"phase": "server", "arch": ARCH, "depth": cfg.n_layers, "width": cfg.d_model,
          "weights": "4-bit float b64", "kv_bits": cfg.kv_bits, "num_slots": SERVER_SLOTS,
          "requests": SERVER_REQUESTS, "prompt_lens": SERVER_PROMPT_LENS,
          "new_tokens": SERVER_NEW_TOKENS, "tokens": n_tokens, "serve_s": wall,
          "tokens_per_s": n_tokens / wall, "decode_steps": steps,
          "decode_ms_per_step_median": step_s.percentile(50) * 1e3,
          "decode_ms_per_step_p90": step_s.percentile(90) * 1e3,
          "decode_step_device_ms": step_device_ms,
          "ttft_s_median": ttft.percentile(50), "ttft_s_p90": ttft.percentile(90),
          "prefill_s_median": prefill_s.percentile(50),
          "admissions": admissions, "prefill_chunk": SERVER_CHUNK, "chunks": n_chunks,
          "preemptions": n_pre, "chunked_tokens_identical": True,
          "preempted_tokens_identical": True, "spill_restore_bit_exact": True,
          "engine_b1_max_logit_gap": worst, "engine_b1_logit_tol": SERVER_LOGIT_TOL,
          "engine_b1_greedy_near_ties": ties, "engine_b1_first_token_near_ties": first_ties,
          "host_syncs_in_captured_step": len(syncs),
          "launches": counts, "launches_per_decode_step": step_counts})
    run["server_counts"] = counts
    run["server_plain"] = plain
    return counts


#: the profile phase: the roofline share is a fraction of the measured time,
#: so above 0, and at most 1 unless the cost counts work the card did not do
#: or the time is wrong; the CPU and the card may differ in hbm_bytes by
#: the counted ops between charged units (the card's decode partials go a
#: row at a time and are concatenated), at most this share
PROFILE_BYTES_REL_TOL = 0.01
PROFILE_GENERATES = 3
# gradient compression on the card: the smallest ladder model's gradients,
# and a training run as the reference's examples train (150 steps, batch
# 32, sequence 128) on tiny-650k
GC_ARCH, GC_TRAIN_ARCH, GC_STEPS, GC_BATCH, GC_SEQ = "tiny-160k", "tiny-650k", 150, 32, 128


def _profile_rows(prof) -> list:
    return [{k: r[k] for k in ("program", "calls", "fastest_half_ms", "flops", "dot_flops",
                               "hbm_bytes", "achieved_gflops_s", "achieved_hbm_gbps",
                               "roofline_frac", "cost_s")} for r in prof.summary()]


def _prefill_dots(cfg, B: int, S: int) -> int:
    """The analytic dot FLOPs of a dense decoder's prefill of B x S: every
    row through each layer's q, k, v, o and FFN matrices, the causal
    attention counted over the whole S x S square (as the reference's
    masked attention multiplies it), the head on each prompt's last row."""
    D, H, K, Dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_row = D * H * Dh + 2 * D * K * Dh + H * Dh * D + 3 * D * F
    return cfg.n_layers * (2 * B * S * per_row + 4 * B * H * S * S * Dh) \
        + 2 * B * D * cfg.vocab_size


def _tiny_costs(torch, device):
    """tiny-10m's prefill and decode step at kv4 costed on ``device``
    (weights seeded and quantized there: a cost reads shapes only)."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.utils import cost

    cfg = get_arch(ROUTED_ARCH).with_kv_quant(4)
    params = quantize_params(lm.init_params(cfg, seed=SEED, device=device),
                             QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                             device=device)
    prompts = torch.randint(0, cfg.vocab_size, (ROUTED_BATCH, ROUTED_PROMPT),
                            generator=_gen(torch, "cpu", SEED + 9)).to(device)
    cache_len = ROUTED_PROMPT + ROUTED_NEW
    with torch.inference_mode():
        pf = cost.measure("prefill", lambda: lm.prefill(params, prompts, cfg,
                                                         cache_len=cache_len))
        _, caches = lm.prefill(params, prompts, cfg, cache_len=cache_len)
        tok = prompts[:, -1].to(torch.int32)
        ds = cost.measure("decode_step", lambda: lm.decode_step(params, tok, caches,
                                                               ROUTED_PROMPT, cfg))
    return {"prefill": pf, "decode_step": ds}


def _grad_compress_on_card(torch, dev) -> dict:
    """compress_tree on tiny-160k's gradients on the card against its plain
    version on the CPU, two steps with the error fed back; then tiny-650k
    trained with 8-bit compression.  Returns the launches and the run."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.optim import grad_compress as gc
    from repro_torch.train import loop
    from repro_torch.train import step as step_mod
    from repro_torch.tree import leaves, tree_map, unflatten

    cfg = get_arch(GC_ARCH)
    params = step_mod.init_state(cfg, seed=SEED, device=dev).params
    batch = next(synthetic.batches(cfg.vocab_size, GC_BATCH, GC_SEQ, seed=SEED, device=dev))
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = lm.loss_fn(unflatten(params, flat), batch["tokens"], batch["labels"], cfg,
                      loss_chunk=GC_SEQ)
    grads = unflatten(params, list(torch.autograd.grad(loss, flat)))
    n_big = sum(g.numel() >= gc.MIN_ELEMENTS for g in leaves(grads))
    _reset_counts()
    g1, e1 = gc.compress_tree(grads, None)
    g2, e2 = gc.compress_tree(grads, e1)
    torch.cuda.synchronize()
    counts = _counts()
    require(counts == {**dict.fromkeys(_COUNT_KEYS, 0), "b3": 2 * n_big},
            f"compress_tree twice over {n_big} leaves of >= {gc.MIN_ELEMENTS} launched {counts}")
    cpu = tree_map(lambda t: t.detach().cpu(), grads)
    p1, q1 = gc.compress_tree(cpu, None)
    p2, q2 = gc.compress_tree(cpu, q1)
    for card, plain in ((g1, p1), (e1, q1), (g2, p2), (e2, q2)):
        require(all(torch.equal(a.cpu(), b) for a, b in zip(leaves(card), leaves(plain),
                                                            strict=True)),
                "compress_tree on the card differs from its plain version")
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = loop.train(get_arch(GC_TRAIN_ARCH), steps=GC_STEPS, batch=GC_BATCH,
                             seq_len=GC_SEQ, grad_compress_bits=8, log=lambda *_: None,
                             device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = _counts()
    n_train = sum(e.numel() >= gc.MIN_ELEMENTS for e in leaves(state.err))
    require(train_counts == {**dict.fromkeys(_COUNT_KEYS, 0), "b3": GC_STEPS * n_train},
            f"{GC_STEPS} compressed steps launched {train_counts}, want {n_train} flat "
            f"encodes a step")
    require(hist[0] - hist[-1] >= MIN_LOSS_DROP,
            f"compressed training: loss {hist[0]:.3f} -> {hist[-1]:.3f}")
    return {"leaves": len(leaves(grads)), "compressed_leaves": n_big,
            "launches": {k: counts[k] + train_counts[k] for k in _COUNT_KEYS},
            "train_arch": GC_TRAIN_ARCH, "train_steps": GC_STEPS, "train_s": train_s,
            "loss_first": hist[0], "loss_last": hist[-1]}


def profile_path(torch, dev, run) -> dict:
    """Phase 3j: the step profiler on the serve phase's Qwen2-7B tree, in
    the Engine and the Server; tiny-10m's costs on the CPU and on the card;
    gradient compression on the card; the quickstart example."""
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.serving import Engine, Server, StepProfiler, Telemetry
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    cfg, qparams, prompts = run["cfg"], run["qparams"], run["prompts"]
    phase_counts = dict.fromkeys(_COUNT_KEYS, 0)

    def bounded(rows, what):
        for r in rows:
            require(0.0 < r["roofline_frac"] <= 1.0,
                    f"{what} {r['program']}: roofline_frac {r['roofline_frac']}")

    # the Engine: tokens and launches as unprofiled, rows for both programs
    tel = Telemetry(profiler=StepProfiler())
    engine = Engine(qparams, cfg, max_seq_len=PROMPT + NEW_TOKENS, telemetry=tel, device=dev)
    for i in range(PROFILE_GENERATES):
        _reset_counts()
        tokens = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        counts = _counts()
        require(torch.equal(tokens, run["tokens"]), "profiled Engine tokens differ")
        if i == 0:
            require(counts == run["generate_counts"],
                    f"a profiled generate launched {counts}, unprofiled "
                    f"{run['generate_counts']}")
        phase_counts = {k: phase_counts[k] + counts[k] for k in _COUNT_KEYS}
    _reset_counts()
    engine._graphs[BATCH].step.replay()
    torch.cuda.synchronize()
    require(_counts() == run["step_counts"], f"a profiled replay launched {_counts()}")
    phase_counts = {k: phase_counts[k] + n for k, n in _counts().items()}
    engine_rows = _profile_rows(tel.profiler)
    names = {r["program"] for r in engine_rows}
    pf_name, ds_name = f"prefill[{BATCH}x{PROMPT}]", f"decode_step[{BATCH}]"
    require(names == {pf_name, ds_name}, f"Engine rows {names}")
    bounded(engine_rows, "Engine")
    (session,) = tel.profiler.sessions
    matrices = [t for t in leaves(qparams) if isinstance(t, QuantizedTensor)]
    stored = sum(t.packed.numel() * 4 + t.scales.numel() * t.scales.element_size()
                 for t in matrices)
    step_cost, prefill_cost = session.costs[ds_name], session.costs[pf_name]
    n_matrices = sum(math.prod(t.packed.shape[:-2]) for t in matrices)   # stacked layers
    require(n_matrices == 7 * cfg.n_layers + 1 and step_cost.hbm_bytes >= stored,
            f"decode_step[{BATCH}]: {step_cost.hbm_bytes} bytes, the {n_matrices} "
            f"matrices store {stored}")
    analytic = _prefill_dots(cfg, BATCH, PROMPT)
    require(prefill_cost.dot_flops == analytic,
            f"{pf_name}: {prefill_cost.dot_flops} dot FLOPs, analytic {analytic}")
    del engine

    # the Server: the server phase's traffic, plain and chunked
    reqs = _server_requests(cfg)
    cache_len = SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]
    server_rows = {}
    with torch.inference_mode():
        for label, kw in (("plain", {}), ("chunked", {"prefill_chunk": SERVER_CHUNK})):
            tel_s = Telemetry(profiler=StepProfiler())
            _reset_counts()
            srv = Server(qparams, cfg, num_slots=SERVER_SLOTS, max_seq_len=cache_len,
                         device=dev, telemetry=tel_s, **kw)
            _, toks, _, _ = _drive_server(torch, srv, reqs)
            torch.cuda.synchronize()
            counts = _counts()
            require(toks == run["server_plain"], f"the profiled {label} Server gave other "
                    f"tokens: {sum(a != b for a, b in zip(toks, run['server_plain']))} "
                    "requests differ")
            if label == "plain":
                require(counts == run["server_counts"],
                        f"the profiled Server launched {counts}, unprofiled "
                        f"{run['server_counts']}")
            _reset_counts()
            srv._graph.replay()
            torch.cuda.synchronize()
            require(_counts() == run["step_counts"],
                    f"a profiled Server replay launched {_counts()}")
            phase_counts = {k: phase_counts[k] + counts[k] + n
                            for k, n in zip(_COUNT_KEYS, _counts().values())}
            rows = _profile_rows(tel_s.profiler)
            bounded(rows, f"Server ({label})")
            server_rows[label] = rows
            if label == "plain":
                server_costs = dict(tel_s.profiler.sessions[0].costs)
            del srv
    for label, prefixes in (("plain", ("prefill[", "decode_step")),
                            ("chunked", ("prefill[", "prefill_chunk[", "chunk_commit[",
                                         "decode_step"))):
        names = {r["program"] for r in server_rows[label]}
        require(all(any(n.startswith(p) for n in names) for p in prefixes),
                f"Server ({label}) rows {sorted(names)}")

    # tiny-10m's costs: the same on the CPU and on the card
    cpu, card = _tiny_costs(torch, torch.device("cpu")), _tiny_costs(torch, dev)
    tiny = {}
    for name in ("prefill", "decode_step"):
        a, b = cpu[name], card[name]
        rel = abs(b.hbm_bytes - a.hbm_bytes) / a.hbm_bytes
        require((a.flops, a.dot_flops, a.kernel_flops, a.kernel_bytes)
                == (b.flops, b.dot_flops, b.kernel_flops, b.kernel_bytes)
                and rel <= PROFILE_BYTES_REL_TOL,
                f"tiny-10m {name}: CPU {a}, card {b}")
        tiny[name] = {"flops": b.flops, "dot_flops": b.dot_flops,
                      "kernel_flops": b.kernel_flops, "kernel_bytes": b.kernel_bytes,
                      "hbm_bytes_cpu": a.hbm_bytes, "hbm_bytes_card": b.hbm_bytes,
                      "hbm_bytes_rel_diff": rel}

    gcomp = _grad_compress_on_card(torch, dev)
    phase_counts = {k: phase_counts[k] + gcomp["launches"][k] for k in _COUNT_KEYS}

    t0 = time.perf_counter()
    quick = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart"],
                           cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                           capture_output=True, text=True, timeout=300)
    quick_s = time.perf_counter() - t0
    require(quick.returncode == 0 and "fused 4-bit dequant-matmul" in quick.stdout,
            f"examples.quickstart exited {quick.returncode}: {quick.stderr[-2000:]}")
    emit({"phase": "profile", "arch": ARCH, "kv_bits": cfg.kv_bits,
          "peak_flops": StepProfiler().peak_flops, "hbm_bw": StepProfiler().hbm_bw,
          "engine_rows": engine_rows, "engine_generates": PROFILE_GENERATES,
          "decode_step_stored_matrix_bytes": stored, "prefill_analytic_dot_flops": analytic,
          "server_rows": server_rows, "server_requests": len(reqs),
          "tiny10m_cpu_vs_card": tiny,
          "grad_compress": {k: v for k, v in gcomp.items() if k != "launches"},
          "quickstart_s": quick_s, "quickstart_tail": quick.stdout.strip().splitlines()[-2:],
          "tokens_identical": True, "launches": phase_counts,
          "seconds": time.perf_counter() - t_phase})
    run["profile_counts"] = phase_counts
    # the unsharded programs' costs, which the 1x1 mesh's are held to (3l)
    run["profile_costs"] = {"engine": dict(session.costs), "server": server_costs}
    return phase_counts


def paged_path(torch, dev, run) -> dict:
    """Phase 3c: the paged pool (Server(paged=True), pages of PAGE_SIZE) on
    the server phase's weights, pool and traffic.  The 24 requests at kv4
    (the main path: launches counted, no host sync in the captured step,
    one replay's launches), the first PAGED_SHORT_REQUESTS at kv8 and kv16,
    and the two-class traffic with preemption: every token the slot pool's.
    Then the shared-prefix workload on a pool of fewer pages than 8 unshared
    residents need: 8 residents at once, COW hits, the tokens of a slot
    pool with a row a request.  No page left after any drain."""
    from repro_torch.data import synthetic
    from repro_torch.serving import Server, Telemetry

    cfg, qparams, plain = run["cfg"], run["qparams"], run["server_plain"]
    reqs = _server_requests(cfg)
    cache_len = SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]
    per_layer = 7
    b1_step = per_layer * cfg.n_layers + 1
    b2_step = cfg.n_layers
    Checked = _checked_server(torch)
    paged_kw = {"paged": True, "page_size": PAGE_SIZE}

    def serve(cls, c, traffic, *, classes=False, num_slots=SERVER_SLOTS, **kw):
        srv = cls(qparams, c, num_slots=num_slots, max_seq_len=cache_len, device=dev, **kw)
        _, toks, wall, peak = _drive_server(torch, srv, traffic, classes=classes)
        return srv, toks, wall, peak

    def differ(a, b):
        return sum(x != y for x, y in zip(a, b))

    with torch.inference_mode():
        # the main path: a fresh paged Server (its construction captures the
        # step) serving the server phase's traffic at kv4
        tel = Telemetry()
        _reset_counts()
        with _capture_guard(torch) as syncs:
            srv, toks, wall, peak = serve(Server, cfg, reqs, telemetry=tel, **paged_kw)
        counts = _counts()
        require(not syncs, f"the paged Server's captured step syncs with the host: {syncs[:5]}")
        require(toks == plain, f"paged kv4 tokens differ from the slot pool's in "
                f"{differ(toks, plain)} requests")
        reg = tel.registry
        admissions = int(reg.counter("serve_prefills_total").value)
        steps = int(reg.counter("serve_decode_steps_total").value)
        require(admissions == SERVER_REQUESTS, f"{admissions} admissions")
        require(counts["attn"] == (1 + steps) * b2_step and counts["kv"] == 0,
                f"paged: {counts['attn']} fused attentions, want (1 + {steps}) x {b2_step}")
        require(counts["gemm"] == per_layer * cfg.n_layers * admissions
                and counts["gemv"] == counts["gemv_tc"] == (1 + steps) * b1_step + admissions,
                f"paged launches {counts} for {admissions} admissions and {steps} steps")
        _reset_counts()
        srv._decode_body()
        torch.cuda.synchronize()
        step_counts = _counts()
        require(step_counts == {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": b1_step,
                                "gemv_tc": b1_step, "attn": b2_step},
                f"one paged decode step launched {step_counts}")
        _reset_counts()
        srv._graph.replay()
        torch.cuda.synchronize()
        require(_counts() == step_counts, f"one paged replay launched {_counts()}")
        step_device_ms = _time_graph(torch, srv._graph, 10)
        ttft = reg.histogram("serve_ttft_seconds")
        step_s = reg.histogram("serve_decode_step_seconds")
        page_bytes = srv.pool.kv_bytes()["total"] / srv.pool.n_pages
        main = {"tokens": sum(len(t) for t in toks), "serve_s": wall,
                "tokens_per_s": sum(len(t) for t in toks) / wall, "decode_steps": steps,
                "decode_ms_per_step_median": step_s.percentile(50) * 1e3,
                "decode_ms_per_step_p90": step_s.percentile(90) * 1e3,
                "decode_step_device_ms": step_device_ms,
                "ttft_s_median": ttft.percentile(50), "ttft_s_p90": ttft.percentile(90),
                "peak_residents": peak["residents"], "pages_in_use_at_peak": peak["pages"],
                "cow_hits": srv.pool.allocator.cow_hits,
                "page_alloc_events": sum(e["name"] == "page_alloc" for e in tel.tracer.events),
                "page_release_events": sum(e["name"] == "page_release"
                                           for e in tel.tracer.events)}
        pages_per_row = srv.pool.pages_per_seq
        del srv

        # kv8 and kv16 on a shorter run, against the slot pool at each
        short = {}
        for kv in (8, 16):
            c = cfg.with_kv_quant(kv)
            _, slot_toks, _, _ = serve(Server, c, reqs[:PAGED_SHORT_REQUESTS])
            _, paged_toks, _, _ = serve(Server, c, reqs[:PAGED_SHORT_REQUESTS], **paged_kw)
            require(paged_toks == slot_toks, f"paged kv{kv} tokens differ from the slot "
                    f"pool's in {differ(paged_toks, slot_toks)} requests")
            short[f"kv{kv}"] = True

        # two classes with preemption: private pages spilled and restored
        srv_p, preempted, _, _ = serve(Checked, cfg, reqs, classes=True, max_preemptions=2,
                                       **paged_kw)
        n_pre = srv_p.scheduler.n_preemptions
        require(n_pre >= 1, "the two-class traffic forced no paged preemption")
        require(srv_p.restores == n_pre, "a preempted request was not restored")
        require(preempted == plain, f"paged preemption changed tokens in "
                f"{differ(preempted, plain)} requests")
        del srv_p

        # the shared-prefix workload on fewer pages than 8 unshared residents
        # need: room for both prefixes once and every resident's private pages
        shared = synthetic.shared_prefix_workload(
            SHARED_VOCAB, SHARED_REQUESTS, n_prefixes=2, prefix_len=SHARED_PREFIX,
            suffix_len=SHARED_SUFFIX, seed=SEED, device="cpu")
        need = max(-(-(len(r["prompt"]) + r["max_new"] - 1) // PAGE_SIZE) for r in shared)
        private = need - SHARED_PREFIX // PAGE_SIZE
        n_pages = 2 * need + (SERVER_SLOTS - 2) * private + 1
        require(n_pages - 1 < SERVER_SLOTS * need, "the shared-prefix pool is not short")
        tel_s = Telemetry()
        srv_s, shared_toks, shared_wall, shared_peak = serve(
            Server, cfg, shared, telemetry=tel_s, n_pages=n_pages, **paged_kw)
        cow = srv_s.pool.allocator.cow_hits
        ttft_s = tel_s.registry.histogram("serve_ttft_seconds")
        step_ss = tel_s.registry.histogram("serve_decode_step_seconds")
        prefill_ss = tel_s.registry.histogram("serve_prefill_seconds")
        shared_steps = int(tel_s.registry.counter("serve_decode_steps_total").value)
        del srv_s
        # the slot pool with a row a request, and with the rows that the
        # paged pool's bytes buy (whole rows of pages_per_row pages)
        slot_runs = {}
        for rows in (SERVER_SLOTS, (n_pages - 1) // pages_per_row):
            tel_r = Telemetry()
            _, slot_toks, slot_wall, _ = serve(Server, cfg, shared, num_slots=rows,
                                               telemetry=tel_r)
            slot_runs[rows] = {
                "tokens_per_s": sum(len(t) for t in slot_toks) / slot_wall,
                "decode_steps": int(tel_r.registry.counter("serve_decode_steps_total").value),
                "ttft_s_median": tel_r.registry.histogram("serve_ttft_seconds").percentile(50),
                "prefill_s_median":
                    tel_r.registry.histogram("serve_prefill_seconds").percentile(50)}
            if rows == SERVER_SLOTS:
                slot_shared = slot_toks
        require(shared_peak["residents"] == SERVER_SLOTS,
                f"the shared-prefix run held {shared_peak['residents']} residents at once, "
                f"want {SERVER_SLOTS}")
        require(cow > 0, "the shared-prefix run made no COW hit")
        require(shared_toks == slot_shared, f"shared-prefix paged tokens differ from the slot "
                f"pool's in {differ(shared_toks, slot_shared)} requests")
        n_shared_tokens = sum(len(t) for t in shared_toks)

    slot_row_bytes = page_bytes * pages_per_row
    out = {"phase": "paged", "arch": ARCH, "depth": cfg.n_layers, "width": cfg.d_model,
           "weights": "4-bit float b64", "kv_bits": cfg.kv_bits, "page_size": PAGE_SIZE,
           "num_slots": SERVER_SLOTS, "cache_len": cache_len, "requests": SERVER_REQUESTS,
           **main, "host_syncs_in_captured_step": len(syncs),
           "tokens_identical_to_slot_pool": {"kv4": True, **short},
           "preemptions": n_pre, "preempted_tokens_identical": True,
           "spill_restore_bit_exact": True,
           "kv_bytes_per_page": page_bytes, "slot_pool_kv_bytes_per_row": slot_row_bytes,
           "shared_prefix": {
               "requests": SHARED_REQUESTS, "prefix_len": SHARED_PREFIX,
               "suffix_len": SHARED_SUFFIX, "vocab": SHARED_VOCAB, "n_pages": n_pages,
               "pages_8_unshared_residents_need": SERVER_SLOTS * need,
               "slot_pool_rows_as_pages": SERVER_SLOTS * pages_per_row,
               "peak_residents": shared_peak["residents"],
               "pages_in_use_at_peak": shared_peak["pages"],
               "kv_bytes_per_resident_at_peak": (shared_peak["pages"] * page_bytes
                                                 / shared_peak["residents"]),
               "cow_hits": cow, "tokens": n_shared_tokens, "serve_s": shared_wall,
               "tokens_per_s": n_shared_tokens / shared_wall, "decode_steps": shared_steps,
               "slot_pool_by_rows": slot_runs,
               "decode_ms_per_step_median": step_ss.percentile(50) * 1e3,
               "prefill_s_median": prefill_ss.percentile(50),
               "ttft_s_median": ttft_s.percentile(50), "ttft_s_p90": ttft_s.percentile(90),
               "tokens_identical_to_slot_pool": True},
           "launches": counts, "launches_per_decode_step": step_counts}
    emit(out)
    run["paged_counts"] = counts
    return out


def _routed_requests(cfg):
    """ROUTED_REQUESTS requests from a seed: prompts of uniform random tokens
    (ROUTED_PROMPT_LENS), budgets of ROUTED_NEW_TOKENS; the first
    ROUTED_SLOTS arrive at step 0, the rest one every two steps."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    return [{"prompt": rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(ROUTED_PROMPT_LENS[0],
                                                     ROUTED_PROMPT_LENS[1] + 1))),
             "max_new": int(rng.integers(ROUTED_NEW_TOKENS[0], ROUTED_NEW_TOKENS[1] + 1)),
             "arrival_time": 0.0 if i < ROUTED_SLOTS else float(2 * (i - ROUTED_SLOTS + 1)),
             "priority": 0}
            for i in range(ROUTED_REQUESTS)]


def routed_path(torch, dev, run) -> dict:
    """Phase 3d: the routed read on its main path.  tiny-10m (head dim 56,
    which the fused attention does not take), seeded random weights
    quantized on the card (4-bit float, block 64), at kv4 and kv8: the
    Engine's generate (its counts set to 0 just before and read just
    after: one KV dequant a layer and step, no fused attention, no host
    sync in the captured step), its tokens against eager steps', whose
    logits equal bit for bit those of the same steps reading the cache
    through the plain version, one replay's launches, the step's device
    time and that of its routed reads alone, kv_oracle_logit_gap (within
    KV_LOGIT_TOL at kv8; at kv4 reported: the reference's own gap on
    tiny-10m at random weights is above it); then the Server on
    ROUTED_SLOTS slots and on pages of PAGE_SIZE serving ROUTED_REQUESTS
    requests: pages give the slots' tokens, every request teacher-forced
    through the Engine's step at batch 1 within SERVER_LOGIT_TOL."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.models import lm
    from repro_torch.models.blocks import take
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import KV_LOGIT_TOL, Engine, kv_oracle_logit_gap

    base = get_arch(ROUTED_ARCH)
    routed_read = kat.decode_attention_packed
    qparams = quantize_params(lm.init_params(base, seed=SEED, device=dev, dtype=torch.bfloat16),
                              QuantConfig(bits=4, dtype="float", block_size=64), base,
                              device=dev)
    prompts = torch.randint(0, base.vocab_size, (ROUTED_BATCH, ROUTED_PROMPT),
                            generator=_gen(torch, dev, SEED + 7), device=dev)
    n_layers, cache_len = base.n_layers, ROUTED_PROMPT + ROUTED_NEW
    total = dict.fromkeys(_COUNT_KEYS, 0)
    engine_runs = {}
    for kv in (4, 8):
        cfg = base.with_kv_quant(kv)
        spec = kvd.kv_spec(cfg)
        feat = cfg.n_kv_heads * cfg.head_dim
        require(not kat.fused_takes(ROUTED_BATCH, cfg.n_heads, cfg.head_dim, cache_len, spec,
                                    feat), f"the fused attention takes {ROUTED_ARCH} at kv{kv}")
        engine = Engine(qparams, cfg, max_seq_len=cache_len, device=dev)
        _reset_counts()
        with _capture_guard(torch) as syncs:
            tokens = engine.generate(prompts, ROUTED_NEW)
        torch.cuda.synchronize()
        counts = _counts()
        for key in total:
            total[key] += counts[key]
        require(not syncs, f"{ROUTED_ARCH} kv{kv}: the captured step syncs with the host: "
                f"{syncs[:5]}")
        require(counts["kv"] == ROUTED_NEW * n_layers and counts["attn"] == 0,
                f"{ROUTED_ARCH} kv{kv}: generate launched {counts}, want {ROUTED_NEW} x "
                f"{n_layers} KV dequants (the capture's warm-up and the replays) and no fused "
                f"attention")
        require(tuple(tokens.shape) == (ROUTED_BATCH, ROUTED_NEW)
                and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                f"{ROUTED_ARCH} kv{kv}: tokens {tuple(tokens.shape)} or out of range")
        def eager_steps(feed=None):
            """(tokens, logits, caches) of eager steps, each fed its own
            greedy token or feed's."""
            logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=cache_len)
            toks, logs = [torch.argmax(logits, -1).to(torch.int32)], [logits]
            for t in range(1, ROUTED_NEW):
                prev = toks[-1] if feed is None else feed[:, t - 1]
                logits, caches = lm.decode_step(qparams, prev, caches, ROUTED_PROMPT + t - 1,
                                                cfg)
                toks.append(torch.argmax(logits, -1).to(torch.int32))
                logs.append(logits)
            return torch.stack(toks, 1), torch.stack(logs, 1), caches

        eager, routed_logits, caches = eager_steps()
        require(torch.equal(eager, tokens),
                f"{ROUTED_ARCH} kv{kv}: graph tokens differ from eager ones")
        # the same steps reading the cache through the plain version: the KV
        # dequant is bit-exact and the rest the same PyTorch, so the logits
        # are the same bits
        kat.decode_attention_packed = kat.decode_attention_packed_plain
        try:
            _, plain_logits, _ = eager_steps(feed=tokens)
        finally:
            kat.decode_attention_packed = routed_read
        require(torch.equal(plain_logits.view(torch.int16), routed_logits.view(torch.int16)),
                f"{ROUTED_ARCH} kv{kv}: the routed read's logits differ from the plain "
                f"version's")
        tok = tokens[:, -1].contiguous()
        _reset_counts()
        engine._graphs[ROUTED_BATCH].step.replay()   # reloaded by each generate
        torch.cuda.synchronize()
        replay = _counts()
        require(replay["kv"] == n_layers and replay["attn"] == 0,
                f"{ROUTED_ARCH} kv{kv}: one replay launched {replay}")
        # the step's device time, and its routed reads alone, over the
        # cache the eager run filled (every slot written)
        step_ms = _time_ms(torch, lambda: lm.decode_step(qparams, tok, caches, cache_len - 1,
                                                         cfg), 10)
        q = torch.randn((ROUTED_BATCH, cfg.n_heads, cfg.head_dim), generator=_gen(torch, dev, kv),
                        device=dev).to(torch.bfloat16)
        pos = torch.full((), cache_len - 1, dtype=torch.int32, device=dev)
        layers = [take(caches[0], i) for i in range(n_layers)]   # the stack's layers
        reads_ms = _time_ms(torch, lambda: [kat.decode_attention_packed(q, c, pos, spec)
                                            for c in layers], 20)
        dequant_ms = _time_ms(torch, lambda: [kvd.dequant_kv(c, spec, feat) for c in layers], 20)
        # each layer's packed leaves read once and its bf16 K and V written once
        kv_bytes = n_layers * (sum(layers[0][k].numel() * layers[0][k].element_size()
                                   for k in ("k_packed", "k_scales", "v_packed", "v_scales"))
                               + 2 * ROUTED_BATCH * cache_len * feat * 2)
        # the reference's own gap on tiny-10m at random weights exceeds its
        # kv4 tolerance (1.39 > 1.0 on the CPU; the port's plain path 1.22-
        # 1.34): kv4's is reported, held by the bit-identity above; kv8's gated
        gap, agree = kv_oracle_logit_gap(qparams, cfg, prompts[:, :16], 8, device=dev)
        require(kv == 4 or gap <= KV_LOGIT_TOL[kv],
                f"{ROUTED_ARCH} kv{kv} logit gap {gap} > {KV_LOGIT_TOL[kv]}")
        engine_runs[f"kv{kv}"] = {
            "launches": counts, "launches_per_replay": replay,
            "graph_tokens_equal_eager": True, "logits_equal_plain_read": True,
            "host_syncs_in_captured_step": len(syncs),
            "decode_step_device_ms": step_ms, "routed_reads_ms": reads_ms,
            "kv_dequant_ms": dequant_ms, "kv_dequant_bound_ms": _bound(kv_bytes, 0.0)[0],
            "kv_oracle_logit_gap": gap, "kv_oracle_greedy_agreement": agree,
            "kv_logit_tol": KV_LOGIT_TOL[kv], "kv_logit_tol_gated": kv != 4}
        del engine, caches, layers

    # the Server on slots and on pages (kv4): the slots' tokens, and each
    # request against the Engine's step at batch 1
    cfg = base.with_kv_quant(4)
    reqs = _routed_requests(cfg)
    Checked = _checked_server(torch)
    served = {}
    with torch.inference_mode():
        for name, kw in (("slots", {}), ("pages", {"paged": True, "page_size": PAGE_SIZE})):
            _reset_counts()
            srv = Checked(qparams, cfg, num_slots=ROUTED_SLOTS, max_seq_len=ROUTED_LEN,
                          device=dev, **kw)
            ids, toks, wall, _ = _drive_server(torch, srv, reqs)
            counts = _counts()
            for key in total:
                total[key] += counts[key]
            require(counts["kv"] > 0 and counts["attn"] == 0,
                    f"{ROUTED_ARCH} Server on {name} launched {counts}")
            served[name] = (toks, [srv.kept[i] for i in ids], counts, wall)
            del srv
        require(served["pages"][0] == served["slots"][0],
                f"{ROUTED_ARCH}: paged tokens differ from the slot pool's")
        worst, ties, first_ties = _teacher_forced(torch, qparams, cfg, reqs, served["slots"][0],
                                                  served["slots"][1], ROUTED_LEN)
    n_tokens = sum(len(t) for t in served["slots"][0])
    emit({"phase": "routed", "arch": ROUTED_ARCH, "depth": base.n_layers,
          "width": base.d_model, "head_dim": base.head_dim, "weights": "4-bit float b64",
          "batch": ROUTED_BATCH, "prompt_len": ROUTED_PROMPT, "new_tokens": ROUTED_NEW,
          "engine": engine_runs,
          "server": {"num_slots": ROUTED_SLOTS, "max_seq_len": ROUTED_LEN,
                     "requests": ROUTED_REQUESTS, "tokens": n_tokens,
                     "tokens_per_s_slots": n_tokens / served["slots"][3],
                     "tokens_per_s_pages": n_tokens / served["pages"][3],
                     "paged_tokens_identical": True, "engine_b1_max_logit_gap": worst,
                     "engine_b1_logit_tol": SERVER_LOGIT_TOL,
                     "engine_b1_greedy_near_ties": ties,
                     "engine_b1_first_token_near_ties": first_ties,
                     "launches_slots": served["slots"][2], "launches_pages": served["pages"][2]},
          "launches": total})
    run["routed_counts"] = total
    del qparams
    torch.cuda.empty_cache()
    return total


# the mesh phase: the server phase's first requests on the sharded Server;
# the audit's decode steps; the launcher's traffic (tiny-650k, 4 heads)
MESH_REQUESTS = 8
MESH_LAUNCH_ARCH = "tiny-650k"
# the teacher-forced kv8 / kv4 gaps over the first steps of the serve
# phase's traffic (reported, not gated: at random weights Qwen2-7B misses
# KV_LOGIT_TOL, as the reference's family does; PERF.md §7 question 8)
MESH_GAP_STEPS = 16
# preemption on the mesh: 4 kv4 slots of 576 over the server phase's first
# 4 background requests and its first 4 urgent ones (its two priority
# classes), the urgent ones evicting background ones
MESH_PREEMPT_SLOTS, MESH_PREEMPTIONS = 4, 2


def _routed_server(torch):
    """The port's Server whose pool step reads every layer the routed way
    (``_routed_oracle_read``), as a 1x1 mesh's step reads: the unsharded
    Server the sharded one is held to bit for bit."""
    from repro_torch.models import lm
    from repro_torch.serving import Server
    from repro_torch.serving.engine import sample_token

    class Routed(Server):
        def _decode_program(self, caches):
            logits, _ = lm.decode_step(self.params, self._tok, caches, self.pool._pos_dev,
                                       self.cfg, decode_attn=_routed_oracle_read)
            return sample_token(logits, self._gen, self._temps_dev)

    return Routed


def _mesh_preemption(torch, dev, qparams, cfg, sharder, slot_len, solo, counted) -> dict:
    """The 1x1 sharded Server at kv4 with preemption (phase 3l) over the
    server phase's two priority classes, counted: at least one preemption,
    each request's tokens = the unsharded preempted Server's (over the
    routed read) and the sharded batch-1 Engine's (``solo``), the spilled
    bytes = the unsharded Server's."""
    from repro_torch.serving import Server, Telemetry

    both = _server_requests(cfg)
    reqs = both[:MESH_PREEMPT_SLOTS] + both[SERVER_SLOTS:SERVER_SLOTS + MESH_PREEMPT_SLOTS]
    out = {}
    for label, cls, sh in (("sharded", Server, sharder), ("unsharded", _routed_server(torch),
                                                          None)):
        tel = Telemetry()

        def serve(cls=cls, sh=sh, tel=tel):
            with torch.inference_mode(), _capture_guard(torch) as syncs:
                srv = cls(qparams, cfg, num_slots=MESH_PREEMPT_SLOTS, max_seq_len=slot_len,
                          sharder=sh, max_preemptions=MESH_PREEMPTIONS, telemetry=tel,
                          device=dev)
                _, toks, wall, _ = _drive_server(torch, srv, reqs, classes=True)
            require(not syncs, f"mesh preemption ({label}): the captured step syncs with "
                    f"the host: {syncs[:5]}")
            return toks, wall, srv.scheduler.n_preemptions

        toks, wall, n_pre = counted(serve) if sh is not None else serve()
        reg = tel.registry
        out[label] = {"tokens": toks, "serve_s": wall, "preemptions": n_pre,
                      "spill_bytes": {k: reg.counter("kv_spill_bytes_total", kind=k).value
                                      for k in ("packed", "logical", "per_device")},
                      "resumes": int(reg.counter("serve_resumes_total").value)}
    mine, plain = out["sharded"], out["unsharded"]
    require(mine["preemptions"] >= 1 and mine["preemptions"] == plain["preemptions"]
            and mine["resumes"] == mine["preemptions"],
            f"mesh preemption: {mine['preemptions']} preemptions ({mine['resumes']} resumes), "
            f"unsharded {plain['preemptions']}")
    alone = counted(lambda: [
        solo.generate(torch.as_tensor(r["prompt"], device=dev)[None], len(t))[0].tolist()
        for r, t in zip(reqs, mine["tokens"])])
    require(mine["tokens"] == plain["tokens"] == alone,
            "mesh preemption: tokens differ from the unsharded preempted Server's on "
            f"{sum(a != b for a, b in zip(mine['tokens'], plain['tokens']))} requests, from "
            f"the sharded batch-1 Engine's on "
            f"{sum(a != b for a, b in zip(mine['tokens'], alone))}")
    require(mine["spill_bytes"]["packed"] == plain["spill_bytes"]["packed"] > 0
            and mine["spill_bytes"]["per_device"] == mine["spill_bytes"]["packed"],
            f"mesh preemption: spilled {mine['spill_bytes']}, unsharded {plain['spill_bytes']}")
    return {"num_slots": MESH_PREEMPT_SLOTS, "requests": len(reqs),
            "max_preemptions": MESH_PREEMPTIONS, "preemptions": mine["preemptions"],
            "spill_bytes": mine["spill_bytes"], "serve_s": mine["serve_s"],
            "unsharded_serve_s": plain["serve_s"],
            "tokens_equal_unsharded_preempted_server": True,
            "tokens_equal_sharded_engine_b1": True}


def _mesh_profile(torch, dev, qparams, cfg, prompts, sharder, reqs, slot_len, want_tokens,
                  want_served, costs, counted) -> dict:
    """The step profiler on the 1x1 mesh (phase 3l): the sharded Engine and
    Server with ``Telemetry(profiler=StepProfiler())``, counted: tokens as
    unprofiled, every roofline_frac in (0, 1], each program's dot FLOPs
    those of the unsharded program the profile phase costed (``costs``: at
    one rank every slice is whole); its FLOPs, bytes and collective bytes
    reported beside them."""
    from repro_torch.serving import Engine, Server, StepProfiler, Telemetry

    tel = Telemetry(profiler=StepProfiler())
    engine = Engine(qparams, cfg, max_seq_len=PROMPT + NEW_TOKENS, sharder=sharder,
                    telemetry=tel, device=dev)
    tokens = counted(lambda: engine.generate(prompts, NEW_TOKENS))
    require(torch.equal(tokens, want_tokens), "mesh profile: the profiled sharded Engine's "
            "tokens differ from the unprofiled one's")
    tel_s = Telemetry(profiler=StepProfiler())
    with torch.inference_mode():
        srv = counted(lambda: Server(qparams, cfg, num_slots=SERVER_SLOTS, max_seq_len=slot_len,
                                     sharder=sharder, telemetry=tel_s, device=dev))
        _, served, _, _ = counted(lambda: _drive_server(torch, srv, reqs))
    require(served == want_served, "mesh profile: the profiled sharded Server's tokens differ "
            "from the unprofiled one's")
    del engine, srv
    out = {}
    for who, t in (("engine", tel), ("server", tel_s)):
        rows = {r["program"]: r for r in t.profiler.summary()}
        for name, r in rows.items():
            require(0.0 < r["roofline_frac"] <= 1.0,
                    f"mesh profile {who} {name}: roofline_frac {r['roofline_frac']}")
        got = t.profiler.sessions[0].costs
        shared = sorted(set(got) & set(costs[who]))
        require(shared and any(n.startswith("decode_step") for n in shared)
                and any(n.startswith("prefill[") for n in shared),
                f"mesh profile {who}: programs {sorted(got)}, unsharded {sorted(costs[who])}")
        for name in shared:
            a, b = got[name], costs[who][name]
            require(a.dot_flops == b.dot_flops and a.collective_bytes > 0
                    and b.collective_bytes == 0,
                    f"mesh profile {who} {name}: dot FLOPs {a.dot_flops}, unsharded "
                    f"{b.dot_flops}; collective bytes {a.collective_bytes}")
        out[who] = {name: {"flops": got[name].flops, "dot_flops": got[name].dot_flops,
                           "hbm_bytes": got[name].hbm_bytes,
                           "collective_bytes": got[name].collective_bytes,
                           "kernel_flops": got[name].kernel_flops,
                           "kernel_bytes": got[name].kernel_bytes,
                           "unsharded_flops": costs[who][name].flops,
                           "unsharded_hbm_bytes": costs[who][name].hbm_bytes,
                           "roofline_frac": rows[name]["roofline_frac"] if name in rows
                           else None,
                           "fastest_half_ms": rows[name]["fastest_half_ms"] if name in rows
                           else None}
                    for name in shared}
    return out


def _routed_oracle_read(q, k_new, v_new, cache, pos, *, cap=0.0, window=0, kvq=None):
    """The unsharded decode read the 1x1 mesh is held to: the token written
    by attention.write_cache_decode, then every cache read the routed way
    (kv_attention.decode_attention_packed_routed: the KV dequant and the
    partials) and a bf16 cache through the same partials."""
    from repro_torch.kernels import kv_attention
    from repro_torch.models import attention

    attention.write_cache_decode(cache, k_new, v_new, pos, window=window, kvq=kvq)
    if kvq is not None and "k_packed" in cache:
        return kv_attention.decode_attention_packed_routed(q, cache, pos, kvq, cap=cap,
                                                           window=window)
    B, H, Dh = q.shape
    m, l, pv = attention.decode_attention_partial(q, cache["k"], cache["v"], cache["pos"], pos,
                                                  cap=cap, window=window)
    return attention.combine_partials(m, l, pv).reshape(B, H, Dh).to(q.dtype)


def _rollout(torch, params, cfg, prompts, cache_len, *, engine=None, feed=None,
             new_tokens=NEW_TOKENS, with_caches=False):
    """(tokens [B, new_tokens], logits [B, new_tokens, V]) of eager steps:
    a sharded Engine's prefill and step (its placement, decode read and
    constrain), or without one the unsharded prefill and lm.decode_step over
    the routed oracle read; each step fed its own greedy token or feed's.
    ``with_caches`` also returns the prefill's caches (cloned before the
    steps write them)."""
    from repro_torch.models import lm

    with torch.inference_mode():
        if engine is not None:
            logits, caches = engine._prefill(prompts)
            kw = dict(decode_attn=engine._decode_attn(prompts.shape[0]),
                      constrain=engine.constrain)
        else:
            logits, caches = lm.prefill(params, prompts, cfg, cache_len=cache_len)
            kw = dict(decode_attn=_routed_oracle_read)
        after_prefill = [{k: v.clone() for k, v in c.items()} for c in caches] \
            if with_caches else None
        toks, logs = [torch.argmax(logits, -1).to(torch.int32)], [logits]
        for t in range(1, new_tokens):
            prev = toks[-1] if feed is None else feed[:, t - 1]
            logits, caches = lm.decode_step(params, prev, caches, prompts.shape[1] + t - 1, cfg,
                                            **kw)
            toks.append(torch.argmax(logits, -1).to(torch.int32))
            logs.append(logits)
    out = torch.stack(toks, 1), torch.stack(logs, 1)
    return out + (after_prefill,) if with_caches else out


def _mesh_launcher():
    """launch/serve.py on a 1x1 mesh through torchrun (torch.distributed.run,
    --standalone: its rendezvous on this host), continuous mode at kv4,
    started in the background: (the process, its start time)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "repro_torch.launch.serve", "--arch", MESH_LAUNCH_ARCH, "--mesh", "1x1",
           "--kv-bits", "4", "--num-requests", "6", "--num-slots", "2", "--max-new", "8"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), time.perf_counter()


def _mesh_launcher_result(proc, t0) -> dict:
    """Wait for the launcher and check it exited 0 and served."""
    out, err = proc.communicate(timeout=300)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"launch/serve.py --mesh 1x1 exited {proc.returncode}: "
            f"{err[-2000:]}")
    served = [ln for ln in out.splitlines() if ln.startswith("served ")]
    require(len(served) == 1 and "mesh: {'data': 1, 'model': 1}" in out,
            f"launch/serve.py --mesh 1x1 printed {out[-1000:]}")
    return {"exit": proc.returncode, "seconds": seconds, "served": served[0]}


def mesh_path(torch, dev, run) -> dict:
    """Phase 3l: serving on a 1x1 mesh (module docstring).  Its counts are
    set to 0 before the sharded Engines and Server run and read after
    (the oracles', the kv gap's, the unsharded Engines' and the audit's
    launches are not counted)."""
    import torch.distributed as dist

    from repro_torch.analysis import audit
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import Sharder
    from repro_torch.serving import KV_LOGIT_TOL, Engine, Server, Telemetry, kv_oracle_logit_gap
    from repro_torch.utils import cost

    base, qparams, prompts = run["cfg"], run["qparams"], run["prompts"]
    t_phase = time.perf_counter()
    cache_len = PROMPT + NEW_TOKENS
    per_layer, n_layers = 7, base.n_layers
    b1_step = per_layer * n_layers + 1
    total = dict.fromkeys(_COUNT_KEYS, 0)

    def counted(fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        for key, n in _counts().items():
            total[key] += n
        return out

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as rdv:
        init_world("cuda", rank=0, world=1, init_file=os.path.join(rdv, "rendezvous"))
        # the launcher's process runs beside the gates below, before anything is timed
        proc, t_launch = _mesh_launcher()
        try:
            mesh = make_mesh(1, 1, "cuda")
            engines, kv_runs, kv_tokens = {}, {}, {}
            for kv in (16, 8, 4):
                cfg = base.with_kv_quant(kv)
                sharder = Sharder(mesh, cfg, replicate_params_below=0)
                engine = Engine(qparams, cfg, max_seq_len=cache_len, sharder=sharder, device=dev)
                require(engine.max_seq_len == cache_len,
                        f"a 1x1 mesh padded the cache to {engine.max_seq_len}")
                _reset_counts()
                with _capture_guard(torch) as syncs:
                    tokens = engine.generate(prompts, NEW_TOKENS)
                torch.cuda.synchronize()
                counts = _counts()
                for key in total:
                    total[key] += counts[key]
                require(not syncs, f"mesh kv{kv}: the sharded captured step syncs with the "
                        f"host: {syncs[:5]}")
                kv_dequants = NEW_TOKENS * n_layers if kv < 16 else 0
                require(counts["gemm"] == per_layer * n_layers
                        and counts["gemv"] == counts["gemv_tc"] == 1 + NEW_TOKENS * b1_step
                        and counts["kv"] == kv_dequants and counts["attn"] == 0,
                        f"mesh kv{kv}: generate launched {counts}, want {per_layer * n_layers} "
                        f"GEMMs, 1 + {NEW_TOKENS} x {b1_step} GEMVs, {kv_dequants} KV "
                        "dequants, no fused attention")
                mine, mine_logits = counted(lambda: _rollout(torch, engine.params, cfg, prompts,
                                                             cache_len, engine=engine))
                oracle, oracle_logits = _rollout(torch, qparams, cfg, prompts, cache_len)
                require(torch.equal(mine_logits.view(torch.int16),
                                    oracle_logits.view(torch.int16))
                        and torch.equal(mine, oracle) and torch.equal(tokens, oracle),
                        f"mesh kv{kv}: the 1x1 sharded logits or tokens differ from the "
                        "unsharded routed read's")
                run_kv = {"launches": counts, "host_syncs_in_captured_step": len(syncs),
                          "logits_equal_unsharded_routed": True,
                          "graph_tokens_equal_eager": True}
                if kv == 16:
                    plain = Engine(qparams, cfg, max_seq_len=cache_len, device=dev)
                    require(torch.equal(plain.generate(prompts, NEW_TOKENS), tokens),
                            "mesh kv16: tokens differ from the unsharded Engine's")
                    run_kv["tokens_equal_unsharded_engine"] = True
                    del plain
                else:
                    # not counted: the gap's bf16 oracle runs unsharded
                    gap, agree = kv_oracle_logit_gap(qparams, cfg, prompts, MESH_GAP_STEPS,
                                                     device=dev, sharder=sharder)
                    run_kv.update(kv_oracle_logit_gap=gap, kv_oracle_greedy_agreement=agree,
                                  kv_logit_tol=KV_LOGIT_TOL[kv], kv_logit_tol_gated=False)
                kv_runs[f"kv{kv}"] = run_kv
                engines[kv] = engine
                kv_tokens[kv] = tokens

            launcher = _mesh_launcher_result(proc, t_launch)

            # the kv4 step: its device time beside the unsharded Engine's
            # (one step at the prompt's end, captured anew and replayed,
            # CUDA events) and both by the host clock over generate
            engine = engines[KV_BITS]
            plain = Engine(qparams, base, max_seq_len=cache_len, device=dev)
            plain.generate(prompts, NEW_TOKENS)
            times = {}
            for name, e in (("sharded", engine), ("unsharded", plain)):
                e.generate(prompts, 1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.generate(prompts, 1)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                e.generate(prompts, NEW_TOKENS)
                torch.cuda.synchronize()
                total_s = time.perf_counter() - t0
                with torch.inference_mode():
                    _, caches = e._prefill(prompts)
                    tok, read = tokens[:, 0].contiguous(), e._decode_attn(BATCH)   # kv4's

                    def step(e=e, caches=caches, tok=tok, read=read):
                        lm.decode_step(e.params, tok, caches, PROMPT, base, decode_attn=read)

                    device_ms = _time_ms(torch, step, 10)
                times[name] = {"prefill_s": prefill_s,
                               "decode_ms_per_step": (total_s - prefill_s) / (NEW_TOKENS - 1) * 1e3,
                               "decode_step_device_ms": device_ms}
                del caches
            # the unsharded step over the same read as the mesh's (the
            # routed read): what of the mesh's step the read is and what
            # the mesh machinery
            with torch.inference_mode():
                _, caches = lm.prefill(qparams, prompts, base, cache_len=cache_len)
                times["unsharded_routed"] = {"decode_step_device_ms": _time_ms(
                    torch, lambda: lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, base,
                                                  decode_attn=_routed_oracle_read), 10)}
                del caches
            del plain

            # the audit: the sharded kv4 step captured with its node list
            report = audit.AuditReport()
            with audit.CaptureLog() as log, _capture_guard(torch) as syncs:
                Engine(qparams, base, max_seq_len=cache_len, sharder=engine.sharder,
                       device=dev).generate(prompts, AUDIT_NEW_TOKENS)
            torch.cuda.synchronize()
            require(len(log.steps) == 1, f"mesh audit: {len(log.steps)} captures")
            nodes = audit.audit_graph(
                report, f"{ARCH} mesh-1x1 engine kv4", log.steps[0],
                ROOT / "build" / "audit" / "qwen2-7b_mesh_engine_kv4.dot",
                expect={"qmatmul_gemv.launches": b1_step,
                        "dequant_kv_cuda.launches": n_layers,
                        "decode_attention_packed_cuda.launches": 0})
            audit._syncs_check(report, f"{ARCH} mesh-1x1 engine kv4", syncs)
            require(report.ok, "mesh audit: " + "; ".join(c.render()
                                                          for c in report.failures()[:5]))
            nccl = audit.collective_nodes(nodes)

            # the Server on the mesh: 8 kv4 slots of 576, each request's
            # tokens against the sharded Engine at batch 1
            reqs = _server_requests(base)[:MESH_REQUESTS]
            slot_len = SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]
            tel = Telemetry()
            with torch.inference_mode(), _capture_guard(torch) as srv_syncs:
                srv = counted(lambda: Server(qparams, base, num_slots=SERVER_SLOTS,
                                             max_seq_len=slot_len, sharder=engine.sharder,
                                             telemetry=tel, device=dev))
                ids, served, wall, _ = counted(lambda: _drive_server(torch, srv, reqs))
            require(not srv_syncs, f"mesh Server: its captured step syncs with the host: "
                    f"{srv_syncs[:5]}")
            solo = Engine(qparams, base, max_seq_len=slot_len, sharder=engine.sharder, device=dev)
            alone = counted(lambda: [
                solo.generate(torch.as_tensor(r["prompt"], device=dev)[None],
                              len(t))[0].tolist() for r, t in zip(reqs, served)])
            require(alone == served, "mesh Server: tokens differ from the sharded batch-1 "
                    f"Engine's on {sum(a != b for a, b in zip(alone, served))} requests")
            reg = tel.registry
            ttft = reg.histogram("serve_ttft_seconds")
            n_tokens = sum(len(t) for t in served)
            del srv
            preemption = _mesh_preemption(torch, dev, qparams, base, engine.sharder, slot_len,
                                          solo, counted)
            profile = _mesh_profile(torch, dev, qparams, base, prompts, engine.sharder, reqs,
                                    slot_len, kv_tokens[KV_BITS], served, run["profile_costs"],
                                    counted)
            # the dryrun phase's reference: the kv4 Engine's tree and prefill
            # caches as placed on the card, and its profiled programs
            with torch.inference_mode():
                _, caches = engine._prefill(prompts)
            run["mesh_dryrun"] = {"profile": profile["engine"],
                                  "params_bytes": cost.storage_bytes(engine.params),
                                  "caches_bytes": cost.storage_bytes(caches)}
            del caches
            del solo, engines, engine, e, step, log
        finally:
            proc.kill()
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    emit({"phase": "mesh", "arch": ARCH, "mesh": "1x1", "backend": "nccl",
          "depth": base.n_layers, "width": base.d_model, "weights": "4-bit float b64",
          "batch": BATCH, "prompt_len": PROMPT, "new_tokens": NEW_TOKENS,
          "engine": kv_runs, "step_kv4": times,
          "step_kernel_nodes": sum(report.families[f"{ARCH} mesh-1x1 engine kv4"].values()),
          "step_nccl": nccl, "audit": {c.check: c.detail for c in report.checks},
          "server": {"num_slots": SERVER_SLOTS, "max_seq_len": slot_len,
                     "requests": MESH_REQUESTS, "tokens": n_tokens, "serve_s": wall,
                     "tokens_per_s": n_tokens / wall,
                     "ttft_s_median": ttft.percentile(50), "ttft_s_p90": ttft.percentile(90),
                     "tokens_equal_sharded_engine_b1": True,
                     "host_syncs_in_captured_step": len(srv_syncs)},
          "launcher": launcher, "preemption": preemption, "profile": profile,
          "card": smi.stdout.strip(), "launches": total,
          "seconds": time.perf_counter() - t_phase})
    run["mesh_counts"] = total
    return total


def start_dryrun():
    """Phase 3p's subprocess, started in the background: (the process, its
    start time).  It sees no card and is stopped when this process exits."""
    import atexit

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_child()"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def dryrun_child() -> None:
    """Phase 3p's subprocess (module docstring): 3l's two programs on a fake
    1x1 world, then Qwen2-7B's production cells on the fake 16x16 one; one
    line ``DRYRUN {json}`` on stdout."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, specs
    from repro_torch.utils import cost

    torch.set_num_threads(1)   # fake tensors compute nothing
    os.nice(10)                # the card's phases come first on the host
    t0 = time.perf_counter()
    mesh = dryrun.fake_mesh(mesh_shape=(1, 1))
    cfg = get_arch(ARCH).with_kv_quant(KV_BITS)
    slots = PROMPT + NEW_TOKENS   # the Engine's max_seq_len (a 1x1 mesh pads nothing)
    kw = dict(cfg=cfg, sharder_kw=dict(replicate_params_below=0))
    engine = dict(cache_len=slots, param_dtype=torch.bfloat16)
    programs = {}
    for name, shape in (
            (f"decode_step[{BATCH}]", specs.EngineShape("decode_step", slots, BATCH, "decode",
                                                         **engine)),
            (f"prefill[{BATCH}x{PROMPT}]", specs.EngineShape("prefill", PROMPT, BATCH,
                                                              "prefill", **engine))):
        t = time.perf_counter()
        cell = specs.build_cell(ARCH, shape, mesh, **kw)
        pc = dryrun.measure_cell(cell)
        args = cell["args"]
        programs[name] = {**{k: v for k, v in dataclasses.asdict(pc).items() if k != "name"},
                          "params_bytes": cost.storage_bytes(args[0]),
                          "caches_bytes": cost.storage_bytes(args[2]) if len(args) > 2 else 0,
                          "other_bytes": cost.storage_bytes(args[1:2] + args[3:]),
                          "seconds": time.perf_counter() - t}
        del cell
    programs_s = time.perf_counter() - t0
    cells = []
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        t = time.perf_counter()
        rec = dryrun.run_cell(ARCH, shape, save=False)
        cells.append({**{k: rec.get(k) for k in ("shape", "mesh", "status", "reason", "kind",
                                                  "roofline", "hlo_cost", "memory")},
                      "seconds": time.perf_counter() - t})
    print("DRYRUN " + json.dumps({"programs": programs, "programs_seconds": programs_s,
                                  "cells": cells, "seconds": time.perf_counter() - t0}),
          flush=True)


def dryrun_path(started, run) -> dict:
    """Phase 3p: the dry-run's subprocess read and held to 3l's profile of
    the real programs on the card (module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, shape_applicable

    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: the dry-run ran past {DRYRUN_TIMEOUT} s")
    require(proc.returncode == 0, f"the dry-run exited {proc.returncode}: {err[-3000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
    require(len(line) == 1, f"the dry-run printed {out[-2000:]}")
    got = json.loads(line[0][len("DRYRUN "):])
    card = run["mesh_dryrun"]
    programs = {}
    for name, fake in got["programs"].items():
        real = card["profile"][name]
        for key in ("dot_flops", "kernel_flops", "kernel_bytes"):
            require(fake[key] == real[key], f"dryrun {name}: {key} {fake[key]} on fake "
                    f"tensors, {real[key]} on the card")
        require(fake["params_bytes"] == card["params_bytes"],
                f"dryrun {name}: parameter bytes {fake['params_bytes']}, the card's tree "
                f"{card['params_bytes']}")
        if name.startswith("decode_step"):
            require(fake["collective_bytes"] == real["collective_bytes"] > 0,
                    f"dryrun {name}: collective bytes {fake['collective_bytes']}, the card's "
                    f"{real['collective_bytes']}")
            require(fake["caches_bytes"] == card["caches_bytes"],
                    f"dryrun {name}: cache bytes {fake['caches_bytes']}, the card's "
                    f"{card['caches_bytes']}")
        require(fake["argument_bytes"] == fake["params_bytes"] + fake["caches_bytes"]
                + fake["other_bytes"], f"dryrun {name}: argument bytes {fake['argument_bytes']}")
        ratios = {k: fake[k] / real[k] for k in ("flops", "hbm_bytes")}
        require(abs(ratios["flops"] - 1) <= DRYRUN_FLOPS_REL,
                f"dryrun {name}: FLOPs on fake tensors {ratios['flops']:.6f} x the card's")
        require(1 / DRYRUN_HBM_RATIO <= ratios["hbm_bytes"] <= DRYRUN_HBM_RATIO,
                f"dryrun {name}: HBM bytes on fake tensors {ratios['hbm_bytes']:.4f} x the "
                "card's")
        programs[name] = {"fake": {k: fake[k] for k in (
            "flops", "dot_flops", "hbm_bytes", "collective_bytes", "kernel_flops",
            "kernel_bytes", "argument_bytes", "output_bytes", "alias_bytes", "temp_bytes")},
            "card": real, "ratio_fake_over_card": ratios, "seconds": fake["seconds"]}
    cfg = get_arch(ARCH)
    for cell in got["cells"]:
        ok, why = shape_applicable(cfg, SHAPES[cell["shape"]])
        want = "ok" if ok else "skipped"
        require(cell["status"] == want and (ok or cell["reason"] == why),
                f"dryrun {ARCH} x {cell['shape']}: {cell['status']} {cell.get('reason')}")
        if ok:
            rl = cell["roofline"]
            require(all(math.isfinite(rl[k]) and rl[k] > 0
                        for k in ("compute_ms", "memory_ms", "collective_ms")),
                    f"dryrun {ARCH} x {cell['shape']}: terms {rl}")
    phase = {"phase": "dryrun", "arch": ARCH, "programs_1x1": programs,
             "params_bytes_card": card["params_bytes"], "caches_bytes_card": card["caches_bytes"],
             "flops_rel_bound": DRYRUN_FLOPS_REL, "hbm_ratio_bound": DRYRUN_HBM_RATIO, "programs_seconds": got["programs_seconds"],
             "cells_pod16x16": [{k: c[k] for k in ("shape", "status", "reason", "roofline",
                                                   "memory", "seconds") if k in c}
                                for c in got["cells"]],
             "child_seconds": got["seconds"], "seconds": time.perf_counter() - t0}
    emit(phase)
    return phase


# the train mesh phase: Qwen2-7B at full width, depth 4, bf16 masters, 2
# steps of 4 x 512 tokens in 2 microbatches, 8-bit gradient compression
TRAIN_MESH_DEPTH, TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 4, 4, 512
TRAIN_MESH_MICRO, TRAIN_MESH_STEPS, TRAIN_MESH_BITS = 2, 2, 8


def _bits_equal(torch, a, b) -> bool:
    """Two tensors of one dtype equal bit for bit (-0 is not 0 here)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = (t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
                for t in (a, b))
    return torch.equal(a, b)


def _free(torch) -> None:
    """Free what the last train run held: the first checkpointed forward in a
    process imports torch._dynamo, whose import keeps the calling frames
    (and so a train state) in a reference cycle until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _train_steps(torch, dev, cfg, sharder, batches, want=None):
    """TRAIN_MESH_STEPS train steps of ``cfg`` from the seeded bf16 init, the
    state donated: (per step {loss, grad_norm, device_ms, host_ms}, the
    params after each step, the final state).  With ``want`` (another run's
    params after each step) each step's params are held to them instead of
    kept: equal bit for bit, and the largest gap over each leaf's max |p|."""
    from repro_torch.train import step as step_mod
    from repro_torch.tree import leaves

    state = step_mod.init_state(cfg, seed=SEED, device=dev, grad_compress_bits=TRAIN_MESH_BITS,
                                param_dtype=torch.bfloat16)
    step = step_mod.make_train_step(cfg, sharder=sharder, grad_compress_bits=TRAIN_MESH_BITS,
                                    microbatches=TRAIN_MESH_MICRO, loss_chunk=TRAIN_MESH_SEQ,
                                    donate=True)
    rows, kept = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, b)
        end.record()
        torch.cuda.synchronize()
        rows.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                     "device_ms": start.elapsed_time(end),
                     "host_ms": (time.perf_counter() - t0) * 1e3})
        params = leaves(state.params)
        if want is None:
            kept.append([p.clone() for p in params])
            continue
        rows[-1]["params_equal"] = all(_bits_equal(torch, a, w)
                                       for a, w in zip(params, want[i], strict=True))
        rows[-1]["params_gap"] = max(
            ((a.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30)).item()
            for a, w in zip(params, want[i], strict=True))
    return rows, kept, state


def _run_gap(rows, want_rows) -> dict:
    """The largest differences of a run held to another (_train_steps'
    ``want``): loss, grad norm, and params over each leaf's max |p|."""
    return {"loss": max(abs(a["loss"] - b["loss"]) for a, b in zip(rows, want_rows)),
            "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                             for a, b in zip(rows, want_rows)),
            "params_rel": max(r["params_gap"] for r in rows)}


def train_mesh_path(torch, dev) -> dict:
    """Phase 3m: training on a 1x1 mesh (module docstring).  Its counts are
    set to 0 before the sharded steps and before tiny-650k's run, and read
    after each (the unsharded steps' launches are not counted)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import elastic
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import grad_compress as gcomp
    from repro_torch.train import loop

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=TRAIN_MESH_DEPTH)
    g = _gen(torch, dev, SEED)
    batches = []
    for _ in range(TRAIN_MESH_STEPS):
        t = torch.randint(0, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ + 1),
                          generator=g, device=dev)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    total = dict.fromkeys(_COUNT_KEYS, 0)

    def counted(fn, want_b3, what):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _counts()
        require(counts == {**dict.fromkeys(_COUNT_KEYS, 0), "b3": want_b3},
                f"train mesh: {what} launched {counts}, want {want_b3} flat encodes")
        for key in total:
            total[key] += counts[key]
        return out

    _free(torch)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        init_world("cuda", rank=0, world=1, init_file=os.path.join(work, "rendezvous"))
        try:
            sharder = Sharder(make_mesh(1, 1, "cuda"), cfg, replicate_params_below=0)
            n_big = sum(math.prod(n) >= gcomp.MIN_ELEMENTS
                        for n in sharder.train_placement().shapes)
            # the unsharded steps first (not counted; their first step also
            # takes this process's first train-step costs), then the same
            # steps on the mesh from the same init, held to them step by step
            plain, plain_params, state = _train_steps(torch, dev, cfg, None, batches)
            del state
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            sharded, _, state = counted(
                lambda: _train_steps(torch, dev, cfg, sharder, batches, want=plain_params),
                TRAIN_MESH_STEPS * n_big, f"{TRAIN_MESH_STEPS} sharded steps")
            peak = torch.cuda.max_memory_allocated()
            _memory_note(torch, "train mesh: sharded steps")
            del state
            _free(torch)
            same = ([(r["loss"], r["grad_norm"]) for r in sharded]
                    == [(r["loss"], r["grad_norm"]) for r in plain]
                    and all(r["params_equal"] for r in sharded))
            spread = None
            if not same:
                # the unsharded step's own spread run to run, measured and printed
                again, _, state = _train_steps(torch, dev, cfg, None, batches, want=plain_params)
                del state
                _free(torch)
                spread, gap = _run_gap(again, plain), _run_gap(sharded, plain)
                require(all(gap[k] <= spread[k] for k in gap),
                        f"train mesh: the 1x1 steps differ from the unsharded ones by {gap}, "
                        f"beyond the unsharded step's own spread {spread}")
            del plain_params
            _free(torch)

            # tiny-650k on the mesh, compressed, as the profile phase trains it;
            # its sharded state through a checkpoint: gathered whole (a copy
            # at one rank), written by rank 0, read back unsharded, re-placed
            # by launch/elastic.remesh_state and restored onto the mesh
            tiny = get_arch(GC_TRAIN_ARCH)
            tiny_sharder = Sharder(sharder.mesh, tiny, replicate_params_below=0)
            n_tiny = sum(math.prod(n) >= gcomp.MIN_ELEMENTS
                         for n in tiny_sharder.train_placement().shapes)
            t0 = time.perf_counter()
            state, hist = counted(
                lambda: loop.train(tiny, steps=GC_STEPS, batch=GC_BATCH, seq_len=GC_SEQ,
                                   grad_compress_bits=8, sharder=tiny_sharder,
                                   log=lambda *_: None, device=dev),
                GC_STEPS * n_tiny, f"{GC_STEPS} compressed steps of {GC_TRAIN_ARCH}")
            tiny_s = time.perf_counter() - t0
            require(hist[0] - hist[-1] >= MIN_LOSS_DROP,
                    f"train mesh: {GC_TRAIN_ARCH} loss {hist[0]:.3f} -> {hist[-1]:.3f}")
            mgr = CheckpointManager(os.path.join(work, "ckpt"))
            mgr.save(GC_STEPS, state, sharder=tiny_sharder, block=True)
            _, whole, _ = mgr.restore(state)
            remeshed, _ = elastic.remesh_state(whole, tiny, sharder.mesh, sharder=tiny_sharder)
            _, restored, _ = mgr.restore(state, sharder=tiny_sharder)
            for got, what in ((whole, "into an unsharded TrainState"),
                              (remeshed, "through launch/elastic.remesh_state"),
                              (restored, "onto the mesh")):
                require(_same_leaves(torch, got, state), f"train mesh: the checkpoint read "
                        f"back {what} differs from the saved state")
            del state, whole, remeshed, restored, got
        finally:
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    emit({"phase": "train_mesh", "arch": ARCH, "mesh": "1x1", "backend": "nccl",
          "depth": cfg.n_layers, "width": cfg.d_model, "params": cfg.param_count(),
          "param_dtype": "bfloat16", "remat": True, "grad_compress_bits": TRAIN_MESH_BITS,
          "batch": TRAIN_MESH_BATCH, "seq_len": TRAIN_MESH_SEQ,
          "microbatches": TRAIN_MESH_MICRO, "steps": {"sharded": sharded, "unsharded": plain},
          "bit_identical": same, "unsharded_spread": spread,
          "compressed_leaves": n_big, "peak_bytes": peak,
          "tiny": {"arch": GC_TRAIN_ARCH, "steps": GC_STEPS, "train_s": tiny_s,
                   "loss_first": hist[0], "loss_last": hist[-1],
                   "checkpoint_round_trip_equal": True},
          "card": smi.stdout.strip(), "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


def _same_leaves(torch, a, b) -> bool:
    """Two trees' leaves equal bit for bit, in leaves order."""
    from repro_torch.tree import leaves

    return all(_bits_equal(torch, x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


# the moe/ssm mesh phase: on a 1x1 mesh, moonshot-v1-16b-a3b at full width
# cut to depth 8 of 48 (4 x 256, 32 new tokens, kv4) with 8 slots over the
# first 8 of the moe phase's requests whose exact-length prefill runs one
# dispatch group (its grouped request's prefill is not the bucketed one's);
# mamba2-130m at full width and depth (the ssm phase's 4 x 1024 prompts,
# 32 new tokens) with 8 slots over the ssm phase's first 8 requests;
# jamba-v0.1-52b at full width cut to depth 8 (2 x 1024, 16 new tokens,
# kv4); training moonshot at depth 2 and mamba2 at full depth as the train
# mesh phase trains Qwen2-7B
MESH_MOE_DEPTH, MESH_JAMBA_DEPTH, MESH_MOE_TRAIN_DEPTH = 8, 8, 2
MESH_TIMED_STEPS = 10


def _mesh_step_times(torch, engine, B: int, S: int) -> dict:
    """An Engine's captured step for B rows: its device time (CUDA events
    around replays) and its host time (the host clock over replays), each
    over MESH_TIMED_STEPS replays from position S."""
    g = engine._graphs[B]
    with torch.inference_mode():   # the graph's buffers are inference tensors
        g.pos.fill_(S)
        g.col.fill_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TIMED_STEPS):
            g.step.graph.replay()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / MESH_TIMED_STEPS * 1e3
        g.pos.fill_(S)
        g.col.fill_(1)
        device_ms = _time_graph(torch, g.step.graph, MESH_TIMED_STEPS)
    return {"decode_step_device_ms": device_ms, "decode_ms_per_step": host_ms}


def _mesh_engine(torch, dev, qparams, cfg, prompts, new_tokens, mesh, total, want_step,
                 report) -> tuple:
    """One arch's sharded Engine on the 1x1 mesh (phase 3n): generate (its
    launches counted, no host sync in its capture), one replay's launches =
    ``want_step``, the sharded eager steps' logits and the prefill's caches
    (K/V, or the SSM state and conv) equal bit for bit to the unsharded
    prefill's and steps' over the routed read, graph tokens = those eager
    ones; the step's device and host ms beside the unsharded Engine's, and
    the sharded captured step audited (analysis/audit.audit_generate).
    Returns (sharder, report)."""
    from repro_torch.analysis import audit
    from repro_torch.models.sharding import Sharder
    from repro_torch.serving import Engine

    B, S = prompts.shape
    cache_len = S + new_tokens
    sharder = Sharder(mesh, cfg, replicate_params_below=0)
    engine = Engine(qparams, cfg, max_seq_len=cache_len, sharder=sharder, device=dev)
    require(engine.max_seq_len == cache_len, f"{cfg.name}: a 1x1 mesh padded the cache to "
            f"{engine.max_seq_len}")
    _reset_counts()
    with _capture_guard(torch) as syncs:
        tokens = engine.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    counts = _counts()
    for key in total:
        total[key] += counts[key]
    require(not syncs, f"{cfg.name} mesh: the sharded captured step syncs with the host: "
            f"{syncs[:5]}")
    g = engine._graphs[B]
    with torch.inference_mode():
        g.pos.fill_(S)
        g.col.fill_(1)
        _reset_counts()
        g.step.replay()
        torch.cuda.synchronize()
        per_replay = _counts()
    want = {**dict.fromkeys(_COUNT_KEYS, 0), **want_step}
    require(per_replay == want, f"{cfg.name} mesh: one replay launched {per_replay}, want {want}")
    mine, mine_logits, mine_caches = _rollout(torch, engine.params, cfg, prompts, cache_len,
                                              engine=engine, new_tokens=new_tokens,
                                              with_caches=True)
    oracle, oracle_logits, oracle_caches = _rollout(torch, qparams, cfg, prompts, cache_len,
                                                    new_tokens=new_tokens, with_caches=True)
    require(all(_bits_equal(torch, a[k], b[k]) for a, b in zip(mine_caches, oracle_caches,
                                                                strict=True) for k in a),
            f"{cfg.name} mesh: the sharded prefill's caches differ from the unsharded ones")
    require(torch.equal(mine_logits.view(torch.int16), oracle_logits.view(torch.int16))
            and torch.equal(mine, oracle) and torch.equal(tokens, oracle),
            f"{cfg.name} mesh: the 1x1 sharded logits or tokens differ from the unsharded "
            "ones over the routed read")
    del mine_caches, oracle_caches, mine_logits, oracle_logits
    plain = Engine(qparams, cfg, max_seq_len=cache_len, device=dev)
    plain_tokens = plain.generate(prompts, new_tokens)
    has_attn = any(m.startswith("attn") for m, _ in cfg.layer_schedule())
    if not has_attn:   # no decode read to differ: the unsharded Engine's own tokens
        require(torch.equal(plain_tokens, tokens),
                f"{cfg.name} mesh: tokens differ from the unsharded Engine's")
    times = {"sharded": _mesh_step_times(torch, engine, B, S),
             "unsharded": _mesh_step_times(torch, plain, B, S)}
    del plain, engine, g
    gc.collect()
    torch.cuda.empty_cache()
    program = f"{cfg.name} mesh-1x1 engine kv{cfg.kv_bits}"
    names = {"gemv": "qmatmul_gemv.launches", "gemv_moe": "qmatmul_gemv_experts.launches",
             "kv": "dequant_kv_cuda.launches", "attn": "decode_attention_packed_cuda.launches"}
    nodes = audit.audit_generate(
        report, Engine(qparams, cfg, max_seq_len=cache_len, sharder=sharder, device=dev),
        prompts, AUDIT_NEW_TOKENS, program,
        ROOT / "build" / "audit" / f"{cfg.name}_mesh_engine.dot",
        expect={name: want[key] for key, name in names.items()})
    require(report.ok, f"{cfg.name} mesh audit: " + "; ".join(
        c.render() for c in report.failures()[:5]))
    gc.collect()
    torch.cuda.empty_cache()
    return sharder, {
        "batch": B, "prompt_len": S, "new_tokens": new_tokens, "kv_bits": cfg.kv_bits,
        "launches": counts, "launches_per_replay": per_replay,
        "host_syncs_in_captured_step": len(syncs),
        "logits_and_prefill_caches_equal_unsharded_routed": True,
        "graph_tokens_equal_eager": True,
        "tokens_equal_unsharded_engine": bool(torch.equal(plain_tokens, tokens)),
        "step": times, "step_kernel_nodes": sum(report.families[program].values()),
        "step_nccl": audit.collective_nodes(nodes)}


def _mesh_server(torch, dev, qparams, cfg, reqs, slot_len, sharder, total) -> dict:
    """The sharded Server on MESH_SERVER_SLOTS slots over ``reqs`` (its
    captured step no host sync) and each request's tokens against the
    sharded batch-1 Engine's, both counted."""
    from repro_torch.serving import Engine, Server, Telemetry

    tel = Telemetry()
    _reset_counts()
    with torch.inference_mode(), _capture_guard(torch) as syncs:
        srv = Server(qparams, cfg, num_slots=SERVER_SLOTS, max_seq_len=slot_len,
                     sharder=sharder, telemetry=tel, device=dev)
        ids, served, wall, peak = _drive_server(torch, srv, reqs)
    require(not syncs, f"{cfg.name} mesh Server: its captured step syncs with the host: "
            f"{syncs[:5]}")
    solo = Engine(qparams, cfg, max_seq_len=slot_len, sharder=sharder, device=dev)
    alone = [solo.generate(torch.as_tensor(r["prompt"], device=dev)[None], len(t))[0].tolist()
             for r, t in zip(reqs, served)]
    torch.cuda.synchronize()
    for key, n in _counts().items():
        total[key] += n
    require(alone == served, f"{cfg.name} mesh Server: tokens differ from the sharded "
            f"batch-1 Engine's on {sum(a != b for a, b in zip(alone, served))} requests")
    n_tokens = sum(len(t) for t in served)
    ttft = tel.registry.histogram("serve_ttft_seconds")
    del srv, solo
    return {"num_slots": SERVER_SLOTS, "max_seq_len": slot_len, "requests": len(reqs),
            "prompt_lens": [len(r["prompt"]) for r in reqs], "tokens": n_tokens,
            "serve_s": wall, "tokens_per_s": n_tokens / wall,
            "ttft_s_median": ttft.percentile(50), "peak_residents": peak["residents"],
            "tokens_equal_sharded_engine_b1": True, "host_syncs_in_captured_step": len(syncs)}


def _mesh_train(torch, dev, cfg, mesh, total) -> dict:
    """The train mesh phase's two steps (bf16 masters, remat, 8-bit
    compression, TRAIN_MESH_BATCH x TRAIN_MESH_SEQ in TRAIN_MESH_MICRO
    microbatches) of ``cfg``, unsharded and then on the mesh from the same
    init: loss, grad norm and every parameter equal bit for bit (or, where
    the unsharded step is not itself reproducible, within its own spread),
    the sharded steps' flat encodes = steps x compressed leaves."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import grad_compress as gcomp

    g = _gen(torch, dev, SEED + 31)
    batches = []
    for _ in range(TRAIN_MESH_STEPS):
        t = torch.randint(0, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ + 1),
                          generator=g, device=dev)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    sharder = Sharder(mesh, cfg, replicate_params_below=0)
    n_big = sum(math.prod(n) >= gcomp.MIN_ELEMENTS for n in sharder.train_placement().shapes)
    _free(torch)
    plain, plain_params, state = _train_steps(torch, dev, cfg, None, batches)
    del state
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    sharded, _, state = _train_steps(torch, dev, cfg, sharder, batches, want=plain_params)
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "b3": TRAIN_MESH_STEPS * n_big}
    require(counts == want, f"{cfg.name} train mesh: the sharded steps launched {counts}, "
            f"want {want}")
    for key in total:
        total[key] += counts[key]
    peak = torch.cuda.max_memory_allocated()
    del state
    _free(torch)
    same = ([(r["loss"], r["grad_norm"]) for r in sharded]
            == [(r["loss"], r["grad_norm"]) for r in plain]
            and all(r["params_equal"] for r in sharded))
    spread = None
    if not same:
        again, _, state = _train_steps(torch, dev, cfg, None, batches, want=plain_params)
        del state
        _free(torch)
        spread, gap = _run_gap(again, plain), _run_gap(sharded, plain)
        require(all(gap[k] <= spread[k] for k in gap),
                f"{cfg.name} train mesh: the 1x1 steps differ from the unsharded ones by "
                f"{gap}, beyond the unsharded step's own spread {spread}")
    del plain_params
    _free(torch)
    return {"depth": cfg.n_layers, "width": cfg.d_model, "params": cfg.param_count(),
            "steps": {"sharded": sharded, "unsharded": plain}, "bit_identical": same,
            "unsharded_spread": spread, "compressed_leaves": n_big, "peak_bytes": peak,
            "launches": counts}


def moe_ssm_mesh_path(torch, dev) -> dict:
    """Phase 3n: mixture-of-experts, SSM and hybrid decoders on a 1x1 mesh
    (module docstring).  Its counts are set to 0 before the sharded
    Engines, Servers and train steps (and the loads) and read after; the
    oracles', the unsharded runs', the replays' and the audits' launches
    are not counted."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.analysis import audit
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    out = {"phase": "moe_ssm_mesh", "mesh": "1x1", "backend": "nccl",
           "weights": "4-bit float b64"}
    report = audit.AuditReport()
    gc.collect()
    _free(torch)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as rdv:
        init_world("cuda", rank=0, world=1, init_file=os.path.join(rdv, "rendezvous"))
        try:
            mesh = make_mesh(1, 1, "cuda")

            # -- moonshot-v1-16b-a3b at full width, depth 8 --------------------
            base = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MESH_MOE_DEPTH)
            qparams, load = _load_quantized(torch, dev, base, total)
            cfg = base.with_kv_quant(4)
            n_l = cfg.n_layers
            prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                                    generator=_gen(torch, dev, SEED + 14), device=dev)
            sharder, eng = _mesh_engine(
                torch, dev, qparams, cfg, prompts, MOE_NEW, mesh, total,
                {"gemv": 4 * n_l + 1, "gemv_tc": 4 * n_l + 1, "gemv_moe": 3 * n_l, "kv": n_l},
                report)
            reqs = [r for r in _moe_requests(cfg)
                    if moe._n_groups(len(r["prompt"])) == 1][:MESH_REQUESTS]
            out[MOE_ARCH] = {"depth": n_l, "full_depth": get_arch(MOE_ARCH).n_layers,
                             "width": cfg.d_model, "experts": cfg.n_experts,
                             "top_k": cfg.top_k, "vocab": cfg.vocab_size, **load,
                             "engine_kv4": eng,
                             "server": _mesh_server(torch, dev, qparams, cfg, reqs,
                                                    MOE_SLOT_LEN, sharder, total)}
            del qparams, sharder
            _free(torch)

            # -- mamba2-130m at full width and depth ---------------------------
            cfg = get_arch(SSM_ARCH)
            qparams, load = _load_quantized(torch, dev, cfg, total)
            n_l = cfg.n_layers
            prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                                    generator=_gen(torch, dev, SEED + 19), device=dev)
            sharder, eng = _mesh_engine(torch, dev, qparams, cfg, prompts, SSM_NEW, mesh,
                                        total, {"gemv": 2 * n_l, "gemv_tc": 2 * n_l}, report)
            out[SSM_ARCH] = {"depth": n_l, "width": cfg.d_model, "ssm_heads": cfg.n_ssm_heads,
                             **load, "engine": eng,
                             "server": _mesh_server(torch, dev, qparams, cfg,
                                                    _ssm_requests(cfg)[:MESH_REQUESTS],
                                                    SSM_SLOT_LEN, sharder, total)}
            del qparams, sharder
            _free(torch)

            # -- jamba-v0.1-52b at full width, depth 8 -------------------------
            base = dataclasses.replace(get_arch(JAMBA_ARCH), n_layers=MESH_JAMBA_DEPTH)
            qparams, load = _load_quantized(torch, dev, base, total)
            cfg = base.with_kv_quant(4)
            sched = cfg.layer_schedule()
            n_attn = sum(m == "attn" for m, _ in sched)
            n_gemv = (4 * n_attn + 2 * sum(m == "ssm" for m, _ in sched)
                      + 3 * sum(f == "mlp" for _, f in sched) + 1)
            prompts = torch.randint(0, cfg.vocab_size, (JAMBA_BATCH, JAMBA_PROMPT),
                                    generator=_gen(torch, dev, SEED + 20), device=dev)
            _, eng = _mesh_engine(
                torch, dev, qparams, cfg, prompts, JAMBA_NEW, mesh, total,
                {"gemv": n_gemv, "gemv_tc": n_gemv,
                 "gemv_moe": 3 * sum(f == "moe" for _, f in sched), "kv": n_attn}, report)
            out[JAMBA_ARCH] = {"depth": cfg.n_layers, "full_depth": get_arch(JAMBA_ARCH).n_layers,
                               "width": cfg.d_model, **load, "engine_kv4": eng}
            del qparams
            _free(torch)

            # -- training: moonshot at depth 2, mamba2 at full depth -----------
            out["train"] = {
                MOE_ARCH: _mesh_train(torch, dev, dataclasses.replace(
                    get_arch(MOE_ARCH), n_layers=MESH_MOE_TRAIN_DEPTH), mesh, total),
                SSM_ARCH: _mesh_train(torch, dev, get_arch(SSM_ARCH), mesh, total)}
        finally:
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    out.update(audit={f"{c.program}: {c.check}": c.detail for c in report.checks},
               card=smi.stdout.strip(), launches=total, seconds=time.perf_counter() - t_phase)
    emit(out)
    return total


# the encoder-decoder mesh phase: the seq2seq phase's traffic on a 1x1 mesh
# (seamless-m4t-large-v2 at full width and depth), then its tree cut to 2
# encoder and 2 decoder layers trained 2 steps of 4 x (1024 frames, 256
# tokens) as the train mesh phase trains Qwen2-7B
S2S_MESH_TRAIN_DEPTH, S2S_MESH_TRAIN_TOKENS = 2, 256


def _s2s_mesh_rollout(torch, qparams, cfg, frames, prefix, sharder=None):
    """(tokens [B, S2S_NEW], logits [B, S2S_NEW, V], the caches after, the
    params, the step's read keywords) of ``seq2seq.prefill`` and S2S_NEW - 1
    greedy ``decode_step``s at a 0-d device position; sharded: the params
    cut by ``sharder``, the prefill under its ``constrain`` and ``q_pad``,
    the caches placed by ``shard_caches`` and both reads its own."""
    from repro_torch.models import seq2seq

    B, P = prefix.shape
    params, kw, step_kw = qparams, {}, {}
    if sharder is not None:
        params = sharder.shard_params(qparams)
        kw = dict(constrain=sharder.constrain, q_pad=sharder.head_pad())
        step_kw = dict(constrain=sharder.constrain,
                       decode_attn=sharder.decode_attn_fn(B, cfg.decoder_cache_len),
                       cross_attn=sharder.cross_attn_fn(B, frames.shape[1]))
    with torch.inference_mode():
        logits, caches = seq2seq.prefill(params, frames, prefix, cfg, **kw)
        if sharder is not None:
            caches = sharder.shard_caches(caches, B)
        toks, logs = [logits.argmax(-1).to(torch.int32)], [logits]
        pos = torch.full((), P, dtype=torch.int32, device=frames.device)
        for _ in range(S2S_NEW - 1):
            logits, caches = seq2seq.decode_step(params, toks[-1], caches, pos, cfg, **step_kw)
            toks.append(logits.argmax(-1).to(torch.int32))
            logs.append(logits)
            pos.add_(1)
    return torch.stack(toks, 1), torch.stack(logs, 1), caches, params, step_kw


def _s2s_captured_step(torch, dev, params, cfg, caches, tok, pos, step_kw, *, debug=False):
    """One ``seq2seq.decode_step`` at ``pos`` captured (``capture_graph``),
    its replay's logits = the eager call's bit for bit, no host sync in it.
    Returns the step."""
    from repro_torch.models import seq2seq
    from repro_torch.serving import engine as engine_mod

    box = {}

    def body():
        lg, _ = seq2seq.decode_step(params, tok, caches, pos, cfg, **step_kw)
        if "out" not in box:
            box["out"] = torch.empty_like(lg)   # allocated by the warm-up call
        box["out"].copy_(lg)

    with torch.inference_mode():
        with _capture_guard(torch) as syncs:
            step = engine_mod.capture_graph(body, dev, debug=debug)
        require(not syncs, f"encdec mesh: the captured step syncs with the host: {syncs[:5]}")
        step.replay()
        eager, _ = seq2seq.decode_step(params, tok, caches, pos, cfg, **step_kw)
        torch.cuda.synchronize()
        require(torch.equal(box["out"].view(torch.int16), eager.view(torch.int16)),
                "encdec mesh: the replayed step's logits differ from the eager step's")
    return step


def _replay_ms(torch, step) -> dict:
    """A captured step's host ms (the host clock over S2S_TIMED_STEPS
    replays) and device ms (``_time_graph``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(S2S_TIMED_STEPS):
        step.graph.replay()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / S2S_TIMED_STEPS * 1e3
    return {"decode_step_device_ms": _time_graph(torch, step.graph, S2S_TIMED_STEPS),
            "decode_ms_per_step": host_ms}


def _s2s_mesh_train(torch, dev, cfg, mesh, total) -> dict:
    """Phase 3o's training: ``cfg`` (seamless cut in depth) from the seeded
    bf16 init, the gradients of one batch unsharded and on the mesh equal bit
    for bit, then the train mesh phase's two steps (``_train_steps``: bf16
    masters, remat, 8-bit compression, 2 microbatches) unsharded and on the
    mesh from one init: loss, grad norm and every parameter after each step
    equal bit for bit, the sharded steps' flat encodes = steps x compressed
    leaves."""
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import grad_compress as gcomp
    from repro_torch.train import step as step_mod
    from repro_torch.tree import leaves

    g = _gen(torch, dev, SEED + 41)
    batches = []
    for _ in range(TRAIN_MESH_STEPS):
        t = torch.randint(0, cfg.vocab_size, (TRAIN_MESH_BATCH, S2S_MESH_TRAIN_TOKENS + 1),
                          generator=g, device=dev)
        frames = torch.randn((TRAIN_MESH_BATCH, S2S_FRAMES, cfg.d_model), generator=g,
                             device=dev).to(torch.bfloat16)
        batches.append({"frames": frames, "tokens": t[:, :-1], "labels": t[:, 1:]})
    sharder = Sharder(mesh, cfg, replicate_params_below=0)
    n_big = sum(math.prod(n) >= gcomp.MIN_ELEMENTS for n in sharder.train_placement().shapes)
    _free(torch)
    # one batch's gradients (remat), unsharded and on the mesh
    params = step_mod.init_state(cfg, seed=SEED, device=dev, param_dtype=torch.bfloat16).params
    grads = {}
    for label, sh in (("unsharded", None), ("sharded", sharder)):
        fn = step_mod.make_train_step(cfg, sharder=sh, microbatches=TRAIN_MESH_MICRO)
        _reset_counts()
        loss, flat = fn.grads(params, batches[0])
        torch.cuda.synchronize()
        require(_counts() == dict.fromkeys(_COUNT_KEYS, 0),
                f"encdec train mesh: the {label} gradients launched {_counts()}")
        grads[label] = (loss, flat)
    (l0, g0), (l1, g1) = grads["unsharded"], grads["sharded"]
    grads_equal = _bits_equal(torch, l0, l1) and all(
        _bits_equal(torch, a, b) for a, b in zip(g0, g1, strict=True))
    require(grads_equal, "encdec train mesh: the 1x1 gradients differ from the unsharded ones")
    n_leaves = len(leaves(params))
    del params, grads, g0, g1
    _free(torch)
    plain, plain_params, state = _train_steps(torch, dev, cfg, None, batches)
    del state
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    sharded, _, state = _train_steps(torch, dev, cfg, sharder, batches, want=plain_params)
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "b3": TRAIN_MESH_STEPS * n_big}
    require(counts == want, f"encdec train mesh: the sharded steps launched {counts}, want "
            f"{want}")
    for key in total:
        total[key] += counts[key]
    peak = torch.cuda.max_memory_allocated()
    del state, plain_params
    _free(torch)
    same = ([(r["loss"], r["grad_norm"]) for r in sharded]
            == [(r["loss"], r["grad_norm"]) for r in plain]
            and all(r["params_equal"] for r in sharded))
    require(same, f"encdec train mesh: the 1x1 steps differ from the unsharded ones: "
            f"{_run_gap(sharded, plain)}")
    return {"encoder_depth": cfg.n_encoder_layers, "decoder_depth": cfg.n_layers,
            "width": cfg.d_model, "params": cfg.param_count(), "param_dtype": "bfloat16",
            "remat": True, "grad_compress_bits": TRAIN_MESH_BITS, "batch": TRAIN_MESH_BATCH,
            "frames": S2S_FRAMES, "tokens": S2S_MESH_TRAIN_TOKENS,
            "microbatches": TRAIN_MESH_MICRO, "leaves": n_leaves, "gradients_equal": True,
            "steps": {"sharded": sharded, "unsharded": plain}, "bit_identical": True,
            "compressed_leaves": n_big, "peak_bytes": peak, "launches": counts}


def encdec_mesh_path(torch, dev) -> dict:
    """Phase 3o: the encoder-decoder on a 1x1 mesh (module docstring).  Its
    counts are set to 0 before the load, the sharded prefill and decode
    steps and the sharded train steps and read after; the unsharded runs',
    the captures' and the timings' launches are not counted."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.analysis import audit
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.sharding import Sharder

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    none = dict.fromkeys(_COUNT_KEYS, 0)
    gc.collect()
    _free(torch)
    cfg = get_arch(S2S_ARCH)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    B, S, P = S2S_BATCH, S2S_FRAMES, len(S2S_PREFIX)
    step_gemvs = 9 * n_dec + 1
    want_step = {**none, "gemv": step_gemvs, "gemv_tc": step_gemvs}
    want_prefill = {**none, "gemm": 1 + 7 * n_enc + 2 * n_dec, "gemv": step_gemvs,
                    "gemv_tc": step_gemvs}
    want_main = {k: want_prefill[k] + (S2S_NEW - 1) * want_step[k] for k in none}
    out = {"phase": "encdec_mesh", "arch": S2S_ARCH, "mesh": "1x1", "backend": "nccl",
           "weights": "4-bit float b64"}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as rdv:
        init_world("cuda", rank=0, world=1, init_file=os.path.join(rdv, "rendezvous"))
        try:
            mesh = make_mesh(1, 1, "cuda")
            qparams, load = _load_quantized(torch, dev, cfg, total)
            frames = torch.from_numpy(np.random.default_rng(SEED + 22).standard_normal(
                (B, S, cfg.d_model), dtype=np.float32)).to(dev).to(torch.bfloat16)
            prefix = torch.tensor([S2S_PREFIX] * B, dtype=torch.int64, device=dev)
            plain_toks, plain_logits, plain_caches, _, _ = _s2s_mesh_rollout(
                torch, qparams, cfg, frames, prefix)
            sharder = Sharder(mesh, cfg, replicate_params_below=0)
            _reset_counts()
            toks, logits, caches, params, step_kw = _s2s_mesh_rollout(
                torch, qparams, cfg, frames, prefix, sharder)
            torch.cuda.synchronize()
            counts = _counts()
            for key in total:
                total[key] += counts[key]
            require(counts == want_main, f"encdec mesh: the sharded prefill and decode steps "
                    f"launched {counts}, want {want_main}")
            require(tuple(toks.shape) == (B, S2S_NEW)
                    and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
                    and bool(torch.isfinite(logits.float()).all()),
                    "encdec mesh: tokens out of range or non-finite logits")
            caches_equal = all(_bits_equal(torch, a[k], b[k]) for a, b in
                               zip(caches, plain_caches, strict=True) for k in a)
            require(torch.equal(logits.view(torch.int16), plain_logits.view(torch.int16))
                    and torch.equal(toks, plain_toks) and caches_equal,
                    "encdec mesh: the 1x1 sharded logits, tokens or self and cross caches "
                    "differ from the unsharded prefill's and decode steps'")
            del logits, plain_logits
            # the step captured at the next position, sharded (its node list
            # audited) and unsharded, from each run's own caches, then timed
            # in turn: sharded, unsharded, sharded, unsharded
            pos = torch.full((), P + S2S_NEW - 1, dtype=torch.int32, device=dev)
            tok = toks[:, -1].contiguous()
            report = audit.AuditReport()
            program = f"{S2S_ARCH} mesh-1x1 decode_step"
            steps = {"sharded": _s2s_captured_step(torch, dev, params, cfg, caches, tok, pos,
                                                   step_kw, debug=True)}
            nodes = audit.audit_graph(
                report, program, steps["sharded"],
                ROOT / "build" / "audit" / "seamless_mesh_step.dot",
                expect={"qmatmul_gemv.launches": step_gemvs, "dequant_kv_cuda.launches": 0,
                        "decode_attention_packed_cuda.launches": 0})
            require(report.ok, "encdec mesh audit: " + "; ".join(
                c.render() for c in report.failures()[:5]))
            steps["unsharded"] = _s2s_captured_step(torch, dev, qparams, cfg, plain_caches,
                                                    tok, pos, {})
            times = {name: [] for name in steps}
            for _ in range(2):
                for name, step in steps.items():
                    times[name].append(_replay_ms(torch, step))
            del steps, step, caches, plain_caches, params, step_kw
            out["serve"] = {
                "encoder_depth": n_enc, "decoder_depth": n_dec, "width": cfg.d_model,
                "vocab": cfg.vocab_size, **load, "sources": B, "frames": S,
                "prefix": list(S2S_PREFIX), "new_tokens": S2S_NEW,
                "launches": counts, "logits_tokens_caches_equal_unsharded": True,
                "replay_equals_eager": True,
                "step": times,
                "step_kernel_nodes": sum(report.families[program].values()),
                "step_nccl": audit.collective_nodes(nodes),
                "audit": {c.check: c.detail for c in report.checks}}
            del qparams
            _free(torch)
            out["train"] = _s2s_mesh_train(
                torch, dev, dataclasses.replace(cfg, n_layers=S2S_MESH_TRAIN_DEPTH,
                                                n_encoder_layers=S2S_MESH_TRAIN_DEPTH),
                mesh, total)
        finally:
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    out.update(card=smi.stdout.strip(), launches=total, seconds=time.perf_counter() - t_phase)
    emit(out)
    return total


def _window_requests(cfg):
    """WIN_REQUESTS requests for the windows phase's Server, prompts of seeded
    random tokens: the first WIN_SLOTS longer than the 4096-slot ring (the
    prefill wraps it; class 1, at step 0, filling the pool), then four that
    cross the window while decoding and four short ones (class 0, one every
    two steps from step 2, while the pool is busy), 16-64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    lens = WIN_LONG_PROMPTS + WIN_CROSSING_PROMPTS + WIN_SHORT_PROMPTS
    reqs = []
    for i, L in enumerate(lens):
        background = i < WIN_SLOTS
        reqs.append({"prompt": rng.integers(0, cfg.vocab_size, L),
                     "max_new": int(rng.integers(SERVER_NEW_TOKENS[0], SERVER_NEW_TOKENS[1] + 1)),
                     "arrival_time": 0.0 if background else float(2 * (i - WIN_SLOTS + 1)),
                     "priority": 1 if background else 0})
    return reqs


def _unrolled(torch, caches, length: int):
    """Ring caches (shared positions) as linear ones of ``length`` slots:
    each stored position p at slot p, the slots no position holds empty
    (pos -1), so a decode step writes position t at slot t and masks by the
    window alone."""
    out = []
    for group in caches:
        pos = group["pos"]   # [n_periods, S_c]
        lin = {}
        for key, leaf in group.items():
            if key == "pos":
                lin[key] = torch.full(pos.shape[:1] + (length,), -1, dtype=pos.dtype,
                                      device=pos.device)
            else:
                lin[key] = torch.zeros(leaf.shape[:2] + (length,) + leaf.shape[3:],
                                       dtype=leaf.dtype, device=leaf.device)
            for i in range(pos.shape[0]):
                held = pos[i] >= 0
                slots = pos[i][held].long()
                if key == "pos":
                    lin[key][i, slots] = pos[i][held]
                else:
                    lin[key][i][:, slots] = leaf[i][:, held]
        out.append(lin)
    return tuple(out)


def _window_engine(torch, dev, qparams, cfg, prompts, new_tokens, total):
    """One Engine run over ring caches: generate (its counts set to 0 just
    before and read just after, no host sync in the captured step), its
    tokens against eager steps' (whose prefill is timed), the rings'
    lengths, one replay's launches, the captured step's time on the card
    and by the host clock (replays of the Engine's own graph), and the
    step's attention reads alone (every layer's cache read through
    ``attention.decode_attention``, captured).  Returns (tokens, report)."""
    from repro_torch.kernels.kv_dequant import kv_spec
    from repro_torch.models import attention, blocks, lm
    from repro_torch.serving import Engine
    from repro_torch.serving.engine import sample_token

    engine = Engine(qparams, cfg, max_seq_len=WIN_CACHE, device=dev)
    B, S = prompts.shape
    _reset_counts()
    with _capture_guard(torch) as syncs:
        tokens = engine.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    counts = _counts()
    for key in total:
        total[key] += counts[key]
    require(not syncs, f"{cfg.name} kv{cfg.kv_bits}: the captured step syncs with the host: "
            f"{syncs[:5]}")
    require(tuple(tokens.shape) == (B, new_tokens)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{cfg.name}: tokens {tuple(tokens.shape)} or out of range")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=WIN_CACHE)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [sample_token(logits, None, 0.0)]
        t0 = time.perf_counter()
        for t in range(1, new_tokens):
            logits, caches = lm.decode_step(qparams, out[-1], caches, S + t - 1, cfg)
            out.append(sample_token(logits, None, 0.0))
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / (new_tokens - 1) * 1e3
    require(torch.equal(torch.stack(out, 1), tokens),
            f"{cfg.name} kv{cfg.kv_bits}: graph tokens differ from eager ones")
    del caches, logits
    g = engine._graphs[B]
    sched = blocks.stack_schedule(cfg)
    rings = {}
    for (mixer, _), group in zip(sched, g.caches):
        rings[mixer] = group["pos"].shape[-1]
        w = blocks.mixer_window(mixer, cfg)
        require(rings[mixer] == (min(WIN_CACHE, w) if w else WIN_CACHE),
                f"{cfg.name}: the {mixer} cache holds {rings[mixer]} slots")
    with torch.inference_mode():   # the graph's buffers are inference tensors
        g.pos.fill_(S)   # the replays below write inside the cache budget
        g.col.fill_(1)
        _reset_counts()
        g.step.replay()
        torch.cuda.synchronize()
        replay = _counts()
        t0 = time.perf_counter()
        for _ in range(WIN_TIMED_STEPS):
            g.step.graph.replay()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / WIN_TIMED_STEPS * 1e3
        device_ms = _time_graph(torch, g.step.graph, WIN_TIMED_STEPS)
        # the step's attention reads alone, over the graph's filled caches
        q = torch.randn((B, cfg.n_heads, cfg.head_dim), generator=_gen(torch, dev, S),
                        device=dev).to(torch.bfloat16)
        pos = torch.full((), S, dtype=torch.int32, device=dev)
        layers = [(blocks.take(group, i), blocks.mixer_window(mixer, cfg))
                  for (mixer, _), group in zip(sched, g.caches)
                  for i in range(cfg.n_layers // len(sched))]
        kvq = kv_spec(cfg)
        reads_ms = _time_ms(torch, lambda: [attention.decode_attention(
            q, c, pos, cap=cfg.attn_logit_softcap, window=w, kvq=kvq) for c, w in layers], 10)
    del engine, g, layers
    torch.cuda.empty_cache()
    return tokens, {"launches": counts, "launches_per_replay": replay,
                    "graph_tokens_equal_eager": True, "ring_slots": rings,
                    "host_syncs_in_captured_step": len(syncs), "prefill_s": prefill_s,
                    "decode_ms_per_step": host_ms, "decode_ms_per_step_eager": eager_ms,
                    "decode_step_device_ms": device_ms, "attention_reads_ms": reads_ms}


def _encode_items(cfg) -> int:
    """quantize_pack launches of a whole-model 4-bit quantization: a layer's
    four attention projections or its SSM mixer's in_proj and out_proj, its
    MLP's three matrices or its three expert stacks an expert at a time (no
    FFN: none), and an untied lm_head.  An encoder-decoder: frame_proj, 7 an
    encoder layer (attention and MLP), 11 a decoder layer (self and cross
    attention, MLP) and its lm_head."""
    from repro_torch.models import blocks

    if cfg.encoder_decoder:
        return 1 + 7 * cfg.n_encoder_layers + 11 * cfg.n_layers + 1
    mixer = {"attn": 4, "attn_local": 4, "attn_global": 4, "ssm": 2}
    ffn = {"mlp": 3, "moe": 3 * cfg.n_experts, None: 0}
    sched = blocks.stack_schedule(cfg)
    per_period = sum(mixer[m] + ffn[f] for m, f in sched)
    return per_period * (cfg.n_layers // len(sched)) + (0 if cfg.tie_embeddings else 1)


def _load_quantized(torch, dev, cfg, total):
    """Seeded bf16 weights of ``cfg`` quantized on the card (4-bit float,
    block 64), one quantize_pack launch an item (``_encode_items``; an
    expert stack's item is one expert's matrix): (qparams, report)."""
    from repro_torch.configs import QuantConfig
    from repro_torch.models import lm, seq2seq
    from repro_torch.models.quantize import quantize_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = seq2seq.init_params if cfg.encoder_decoder else lm.init_params
    params = init(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    params_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t1 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=4, dtype="float", block_size=64), cfg,
                              device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    for key in total:
        total[key] += counts[key]
    n_items = _encode_items(cfg)
    require(counts == {**dict.fromkeys(_COUNT_KEYS, 0), "pack": n_items},
            f"{cfg.name}: quantize_params launched {counts}, want {n_items} quantize_pack")
    return qparams, {"init_s": t1 - t0, "quantize_s": t2 - t1, "quantize_launches": counts,
                     "init_peak_bytes": init_peak, "bf16_params_bytes": params_bytes,
                     "quantize_peak_bytes": torch.cuda.max_memory_allocated(),
                     "quantized_params_bytes": torch.cuda.memory_allocated()}


def windows_path(torch, dev) -> dict:
    """Phase 3f: the sliding-window and local/global decoders at full width.
    h2o-danube-3-4b (24 layers, a 4096 window on each, Dh 120): the Engine
    at kv4 and kv16 from prompts that wrap every ring in the prefill, one
    replay 169 GEMVs and a KV dequant a layer (the routed read; kv16
    none), graph tokens equal to eager ones; the ring gate (kv16,
    dequant_einsum: decode steps past the window against lm.backbone_seq's
    logits, over the rings at most RING_LOGIT_TOL further off than over the
    same K/V in linear caches); the Server on WIN_SLOTS slots serving
    WIN_REQUESTS requests at exact length, two classes with a wrapped ring
    preempted and restored bit for bit, each request within
    SERVER_LOGIT_TOL of the Engine's step at batch 1, paged and chunked
    refused before any launch.  gemma2-27b (46 layers alternating local and
    global, sandwich norms, soft-caps, a tied 256,000-token head): the
    Engine at kv4, one replay 322 GEMVs, 23 fused attentions (global) and
    23 KV dequants (local), fused vs dequant_einsum within MODE_GAP_TOL,
    the step's device time and the tied head's share of it."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.serving import Server, Telemetry

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    out = {"phase": "windows"}

    # -- h2o-danube-3-4b ------------------------------------------------
    base = get_arch("h2o-danube-3-4b")
    qparams, load = _load_quantized(torch, dev, base, total)
    prompts = torch.randint(0, base.vocab_size, (WIN_BATCH, WIN_PROMPT),
                            generator=_gen(torch, dev, SEED + 12), device=dev)
    danube = {"depth": base.n_layers, "width": base.d_model, "head_dim": base.head_dim,
              "window": base.sliding_window, **load}
    n_l = base.n_layers
    for kv in (4, 16):
        cfg = base.with_kv_quant(kv)
        tokens, rep = _window_engine(torch, dev, qparams, cfg, prompts, WIN_NEW, total)
        want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": 7 * n_l + 1, "gemv_tc": 7 * n_l + 1,
                "kv": n_l if kv < 16 else 0}
        require(rep["launches_per_replay"] == want,
                f"danube kv{kv}: one replay launched {rep['launches_per_replay']}, want {want}")
        danube[f"engine_kv{kv}"] = rep
        if kv == 16:
            tokens16 = tokens
    # the ring gate: teacher-forced decode steps past the window (kv16,
    # dequant_einsum) against the full forward's logits, over the rings and
    # over the same K/V unrolled into linear caches (no slot reused, the
    # window masking alone): the ring may add at most RING_LOGIT_TOL to the
    # decode path's own gap to the full forward
    cfg_e = base.with_kv_quant(16).with_matmul_mode("dequant_einsum")
    seq = torch.cat([prompts, tokens16], dim=1)[:, :WIN_CACHE]
    with torch.inference_mode():
        h, _ = lm.backbone_seq(qparams, seq, cfg_e)
        full = lm.logits_from_hidden(qparams, h[:, WIN_PROMPT - 1:WIN_CACHE - 1], cfg_e).float()
        del h
        logits, rings = lm.prefill(qparams, seq[:, :WIN_PROMPT], cfg_e, cache_len=WIN_CACHE)
        steps = {"ring": [logits.float()], "linear": [logits.float()]}
        caches = {"ring": rings, "linear": _unrolled(torch, rings, WIN_CACHE)}
        for t in range(WIN_PROMPT, WIN_CACHE - 1):
            for kind in steps:
                step_logits, _ = lm.decode_step(qparams, seq[:, t], caches[kind], t, cfg_e)
                steps[kind].append(step_logits.float())
        steps = {k: torch.stack(v, 1) for k, v in steps.items()}
        require(all(c["pos"].shape[-1] == base.sliding_window for c in rings),
                f"danube's prefill rings: {[c['pos'].shape for c in rings]}")
        ring_gap = float((steps["ring"] - full).abs().max())
        linear_gap = float((steps["linear"] - full).abs().max())
        ring_vs_linear = float((steps["ring"] - steps["linear"]).abs().max())
        max_logit = float(full.abs().max())
        del caches, rings, full, steps, logits, step_logits
    require(ring_gap <= linear_gap + RING_LOGIT_TOL,
            f"danube ring gate: decode over the rings {ring_gap} off the full forward, over "
            f"linear caches {linear_gap}: the ring adds more than {RING_LOGIT_TOL}")
    danube["ring_gate"] = {"ring_vs_full": ring_gap, "linear_vs_full": linear_gap,
                           "ring_vs_linear": ring_vs_linear, "ring_extra_tol": RING_LOGIT_TOL,
                           "max_abs_logit": max_logit,
                           "positions": [WIN_PROMPT - 1, WIN_CACHE - 2]}

    # the Server at kv4: exact-length prefills, preemption of a wrapped ring
    cfg = base.with_kv_quant(4)
    reqs = _window_requests(cfg)
    Checked = _checked_server(torch)
    with torch.inference_mode():
        tel = Telemetry()
        _reset_counts()
        with _capture_guard(torch) as syncs:
            srv = Checked(qparams, cfg, num_slots=WIN_SLOTS, max_seq_len=WIN_SLOT_LEN,
                          telemetry=tel, device=dev)
            ids, plain, wall, _ = _drive_server(torch, srv, reqs)
        counts = _counts()
        for key in total:
            total[key] += counts[key]
        require(not syncs, f"danube Server: the captured step syncs with the host: {syncs[:5]}")
        reg = tel.registry
        admissions = int(reg.counter("serve_prefills_total").value)
        steps = int(reg.counter("serve_decode_steps_total").value)
        require(admissions == len(reqs) and counts["attn"] == 0
                and counts["kv"] == (1 + steps) * n_l
                and counts["gemv"] == counts["gemv_tc"] == (1 + steps) * (7 * n_l + 1) + admissions,
                f"danube Server launched {counts} for {admissions} admissions, {steps} steps")
        spans = [e["attrs"] for e in tel.tracer.events if e["name"] == "prefill"]
        require(len(spans) == admissions
                and all(a["padded_len"] == a["prompt_len"] for a in spans),
                f"danube Server: a prefill was padded: {spans}")
        kept = [srv.kept[i] for i in ids]
        ttft, step_s = reg.histogram("serve_ttft_seconds"), reg.histogram(
            "serve_decode_step_seconds")
        n_tokens = sum(len(t) for t in plain)
        del srv
        srv_p = Checked(qparams, cfg, num_slots=WIN_SLOTS, max_seq_len=WIN_SLOT_LEN,
                        max_preemptions=1, device=dev)
        spilled = []   # the next position of each preempted row
        real_preempt = srv_p._preempt
        srv_p._preempt = lambda slot, by: (spilled.append(int(srv_p.pool.next_pos[slot]))
                                           or real_preempt(slot, by))
        _reset_counts()
        _, preempted, _, _ = _drive_server(torch, srv_p, reqs, classes=True)
        for key, n in _counts().items():
            total[key] += n
        n_pre = srv_p.scheduler.n_preemptions
        wrapped = sum(p > base.sliding_window for p in spilled)
        require(n_pre >= 1 and srv_p.restores == n_pre and wrapped >= 1,
                f"danube Server: {n_pre} preemptions, {srv_p.restores} restores, {wrapped} "
                "wrapped rings spilled")
        require(preempted == plain, "danube Server: preemption changed tokens")
        del srv_p
        refused = {}
        for name, kw in (("paged", {"paged": True}), ("prefill_chunk", {"prefill_chunk": 128})):
            before = _counts()
            try:
                Server(qparams, cfg, num_slots=WIN_SLOTS, max_seq_len=WIN_SLOT_LEN, device=dev,
                       **kw)
                refused[name] = None
            except ValueError as e:
                refused[name] = str(e)
            require(refused[name] is not None and _counts() == before,
                    f"danube Server({name}) did not refuse before a launch: {refused[name]}")
        _reset_counts()
        worst, ties, first_ties = _teacher_forced(torch, qparams, cfg, reqs, plain, kept,
                                                  WIN_SLOT_LEN)
        for key, n in _counts().items():
            total[key] += n
    danube["server"] = {
        "kv_bits": 4, "num_slots": WIN_SLOTS, "max_seq_len": WIN_SLOT_LEN,
        "requests": len(reqs), "prompt_lens": [len(r["prompt"]) for r in reqs],
        "tokens": n_tokens, "serve_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_steps": steps, "ttft_s_median": ttft.percentile(50),
        "ttft_s_p90": ttft.percentile(90),
        "decode_ms_per_step_median": step_s.percentile(50) * 1e3,
        "exact_length_prefills": admissions, "preemptions": n_pre,
        "wrapped_rings_spilled": wrapped, "spill_restore_bit_exact": True,
        "preempted_tokens_identical": True, "engine_b1_max_logit_gap": worst,
        "engine_b1_logit_tol": SERVER_LOGIT_TOL, "engine_b1_greedy_near_ties": ties,
        "engine_b1_first_token_near_ties": first_ties, "refused": refused,
        "host_syncs_in_captured_step": len(syncs), "launches": counts}
    del qparams
    torch.cuda.empty_cache()
    out["h2o-danube-3-4b"] = danube

    # -- gemma2-27b -------------------------------------------------------
    base = dataclasses.replace(get_arch("gemma2-27b"), n_layers=GEMMA_DEPTH)
    qparams, load = _load_quantized(torch, dev, base, total)
    n_l, n_global = base.n_layers, base.n_layers // 2
    gemma = {"depth": n_l, "width": base.d_model, "window": base.sliding_window,
             "vocab": base.vocab_size, **load}
    cfg = base.with_kv_quant(4)
    tokens, rep = _window_engine(torch, dev, qparams, cfg, prompts, GEMMA_NEW, total)
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": 7 * n_l, "gemv_tc": 7 * n_l,
            "kv": n_l - n_global, "attn": n_global}
    require(rep["launches_per_replay"] == want,
            f"gemma2 kv4: one replay launched {rep['launches_per_replay']}, want {want}")
    gemma["engine_kv4"] = rep
    # fused vs dequant_einsum on the whole prompt, logits of its last rows
    # (all 4160 x 256,000 would be 8.5 GB a mode)
    logit_rows = {}
    with torch.inference_mode():
        for mode in ("fused", "dequant_einsum"):
            c = cfg.with_matmul_mode(mode)
            h, _ = lm.backbone_seq(qparams, prompts, c)
            logit_rows[mode] = lm.logits_from_hidden(qparams, h[:, -GEMMA_MODE_ROWS:], c).float()
            del h
        mode_gap = float((logit_rows["fused"] - logit_rows["dequant_einsum"]).abs().max())
        finite = bool(torch.isfinite(logit_rows["fused"]).all())
        del logit_rows
        x = torch.randn((WIN_BATCH, base.d_model), generator=_gen(torch, dev, SEED + 13),
                        device=dev).to(torch.bfloat16)
        head_ms = _time_ms(torch, lambda: lm.logits_from_hidden(qparams, x, cfg), 10)
    require(finite and mode_gap <= MODE_GAP_TOL,
            f"gemma2: fused vs dequant_einsum logit gap {mode_gap} > {MODE_GAP_TOL}")
    gemma["mode_gap"] = {"max_abs_logit_gap": mode_gap, "gate": MODE_GAP_TOL,
                         "rows": GEMMA_MODE_ROWS}
    gemma["tied_head_ms"] = head_ms
    gemma["tied_head_share"] = head_ms / rep["decode_step_device_ms"]
    gemma["peak_bytes"] = max(load["init_peak_bytes"], torch.cuda.max_memory_allocated())
    del qparams
    torch.cuda.empty_cache()
    out["gemma2-27b"] = gemma
    out["batch"], out["prompt_len"], out["max_seq_len"] = WIN_BATCH, WIN_PROMPT, WIN_CACHE
    out["weights"] = "4-bit float b64"
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = total
    emit(out)
    return total


class _expert_calls:
    """Within the block, records each expert-batched product (the
    arguments of kernels/qmatmul.qmatmul_experts), each router's decision
    (models/moe.route: its expert ids and renormalised gates) and, with
    ``inputs``, each MoE layer's arguments (models/moe.moe_ffn), in call
    order.  ``force``: an earlier run's decisions, which the block's routers
    take instead of their own: the ids, with their gates renormalised from
    their own probabilities, or with ``gates`` the gates too, so two runs
    route alike."""

    def __init__(self, torch, force=None, *, gates=False, inputs=False):
        self.torch = torch
        self.force = force
        self.force_gates = gates
        self.keep_inputs = inputs
        self.products = []
        self.routes = []
        self.inputs = []

    def __enter__(self):
        from repro_torch.kernels import qmatmul as qk
        from repro_torch.models import moe

        self.saved = (qk.qmatmul_experts, moe.route, moe.moe_ffn)
        real_product, real_route, real_ffn = self.saved
        calls = self

        def product(*args, **kwargs):
            calls.products.append((args, kwargs))
            return real_product(*args, **kwargs)

        def route(params, xt, cfg):
            probs, gates, idx = real_route(params, xt, cfg)
            if calls.force is not None:
                idx, forced_gates = calls.force[len(calls.routes)]
                picked = calls.torch.gather(probs, -1, idx)
                gates = forced_gates if calls.force_gates else picked / picked.sum(-1, keepdim=True)
            calls.routes.append((idx, gates))
            return probs, gates, idx

        def ffn(*args, **kwargs):
            if calls.keep_inputs:
                calls.inputs.append((args, kwargs))
            return real_ffn(*args, **kwargs)

        qk.qmatmul_experts, moe.route, moe.moe_ffn = product, route, ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import qmatmul as qk
        from repro_torch.models import moe

        qk.qmatmul_experts, moe.route, moe.moe_ffn = self.saved
        return False


def _moe_requests(cfg):
    """MOE_REQUESTS requests from a seed: prompts of uniform random tokens
    (16-512; request 1's MOE_GROUPED_PROMPT), budgets of 16-64 new tokens;
    the first MOE_SLOTS at step 0, then one every two steps."""
    import numpy as np

    rng = np.random.default_rng(SEED + 15)
    reqs = []
    for i in range(MOE_REQUESTS):
        L = int(rng.integers(SERVER_PROMPT_LENS[0], SERVER_PROMPT_LENS[1] + 1))
        L = MOE_GROUPED_PROMPT if i == 1 else L
        reqs.append({"prompt": rng.integers(0, cfg.vocab_size, L),
                     "max_new": int(rng.integers(SERVER_NEW_TOKENS[0], SERVER_NEW_TOKENS[1] + 1)),
                     "arrival_time": 0.0 if i < MOE_SLOTS else float(2 * (i - MOE_SLOTS + 1)),
                     "priority": 0})
    return reqs


def _dequant_experts(torch, packed, scales, codebook, bits: int, block: int, K: int):
    """[A, N, n_words] words, [A, N, K / B] scales and [A, 2^bits] codebooks
    -> the experts' bf16 weights [A, N, K] (the plain version's weight)."""
    from repro_torch.core import packing

    codes = packing.unpack(packed, bits, K).long()
    A, N = codes.shape[:2]
    vals = torch.gather(codebook.to(torch.float32), 1, codes.reshape(A, -1)).reshape(A, N, K)
    w = vals.reshape(A, N, K // block, block) * scales.to(torch.float32)[..., None]
    return w.reshape(A, N, K).to(torch.bfloat16)


def _time_expert_products(torch, products) -> dict:
    """One decode step's expert-batched products (``_expert_calls``'s
    records of it): their device time through the kernel (captured and
    replayed), the bound of the bytes the active experts need (each active
    expert's words, scales and codebook, its rows of x and y) and of their
    operations, the plain version's time (eager, CUDA events around the
    whole run) and the library's: one torch.bmm a product over the active
    experts' dequantized bf16 weights."""
    from repro_torch.kernels import qmatmul as qk

    kernel_ms = _time_ms(torch, lambda: [qk.qmatmul_gemv_experts(*a, **k)
                                         for a, k in products], 10)
    nbytes = flops = 0
    active = []
    for (x, packed, scales, cb, counts), kw in products:
        rows = torch.clamp(counts, max=x.shape[1])
        on = rows > 0
        a, r = int(on.sum()), int(rows.sum())
        N, n_words = packed.shape[1:]
        K = x.shape[2]
        nbytes += a * (N * (4 * n_words + 2 * scales.shape[2]) + 4 * cb.shape[1]) \
            + 2 * r * (K + N) + 4 * counts.numel()
        flops += 2 * r * N * K
        active.append(a)
    bound_ms, bound_by = _bound(nbytes, flops)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for a, k in products:
        qk.qmatmul_experts_plain(*a, **k)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    lib = []
    for (x, packed, scales, cb, counts), kw in products:
        ids = torch.nonzero(counts).flatten()
        w = _dequant_experts(torch, packed[ids], scales[ids], cb[ids], kw["bits"],
                             kw["block_size"], x.shape[2])
        lib.append((x[ids].contiguous(), w.transpose(1, 2)))
    library_ms = _time_ms(torch, lambda: [torch.bmm(xa, wa) for xa, wa in lib], 10)
    del lib
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "products": len(products),
            "active_experts_mean": sum(active) / len(active), "bytes": nbytes}


def _moe_engine(torch, dev, qparams, cfg, prompts, new_tokens, total, *, timed=True):
    """One Engine run: generate (its counts set to 0 just before and read
    just after, no host sync in the captured step), its tokens against
    eager steps' (whose prefill is timed), one replay's launches, and with
    ``timed`` the captured step's time on the card and by the host clock
    and the peak memory; where the arch has MoE layers, the mean experts
    that hold a token a layer and step and, timed, one step's expert
    products timed alone (``_time_expert_products``).  Returns (tokens,
    report)."""
    from repro_torch.models import lm
    from repro_torch.serving import Engine
    from repro_torch.serving.engine import sample_token

    B, S = prompts.shape
    engine = Engine(qparams, cfg, max_seq_len=S + new_tokens, device=dev)
    _reset_counts()
    with _capture_guard(torch) as syncs:
        tokens = engine.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    counts = _counts()
    for key in total:
        total[key] += counts[key]
    require(not syncs, f"{cfg.name}: the captured step syncs with the host: {syncs[:5]}")
    require(tuple(tokens.shape) == (B, new_tokens)
            and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{cfg.name}: tokens {tuple(tokens.shape)} or out of range")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(qparams, prompts, cfg, cache_len=S + new_tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = [sample_token(logits, None, 0.0)]
        with _expert_calls(torch) as calls:
            t0 = time.perf_counter()
            for t in range(1, new_tokens):
                logits, caches = lm.decode_step(qparams, out[-1], caches, S + t - 1, cfg)
                out.append(sample_token(logits, None, 0.0))
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) / (new_tokens - 1) * 1e3
    require(torch.equal(torch.stack(out, 1), tokens),
            f"{cfg.name} kv{cfg.kv_bits}: graph tokens differ from eager ones")
    per_step = 3 * sum(f == "moe" for _, f in cfg.layer_schedule())
    require(len(calls.products) == per_step * (new_tokens - 1),
            f"{cfg.name}: {len(calls.products)} expert products in {new_tokens - 1} eager steps")
    rep = {"launches": counts, "graph_tokens_equal_eager": True,
           "host_syncs_in_captured_step": len(syncs), "prefill_s": prefill_s,
           "decode_ms_per_step_eager": eager_ms}
    if per_step:
        # a layer's three products share their counts: the gate's say how
        # many experts hold a token
        active = torch.stack([(a[4] > 0).sum() for a, _ in calls.products[::3]]).float()
        rep["active_experts_per_layer_mean"] = float(active.mean())
        rep["active_experts_per_layer_min_max"] = [int(active.min()), int(active.max())]
    del caches, logits
    g = engine._graphs[B]
    with torch.inference_mode():   # the graph's buffers are inference tensors
        g.pos.fill_(S)   # the replays below write inside the cache budget
        g.col.fill_(1)
        _reset_counts()
        g.step.replay()
        torch.cuda.synchronize()
        rep["launches_per_replay"] = _counts()
        if timed:
            t0 = time.perf_counter()
            for _ in range(MOE_TIMED_STEPS):
                g.step.graph.replay()
            torch.cuda.synchronize()
            rep["decode_ms_per_step"] = (time.perf_counter() - t0) / MOE_TIMED_STEPS * 1e3
            g.pos.fill_(S)   # back inside the cache budget for the timed replays
            g.col.fill_(1)
            rep["decode_step_device_ms"] = _time_graph(torch, g.step.graph, MOE_TIMED_STEPS)
            rep["peak_bytes"] = torch.cuda.max_memory_allocated()
            if per_step:
                rep["expert_products"] = _time_expert_products(torch,
                                                               calls.products[-per_step:])
    del engine, g, calls
    torch.cuda.empty_cache()
    return tokens, rep


def _moe_mode_gap(torch, qparams, cfg, prompts) -> dict:
    """Fused vs dequant_einsum logits over the prompts (every row).  Free
    running, the routers' top-k sets differ between the modes at some
    (layer, token) pairs (router flips, near-ties that the modes' last-bit
    differences tip), and a flip moves the token's and, through capacity,
    its group's outputs.  With the fused run's expert ids forced on the
    dequant_einsum run the gates still differ: the router's logits are
    rounded to bf16, and a last-bit change of its input moves a logit by a
    bf16 step (~0.8 % of a gate).  Gated: each MoE layer's output on the
    fused run's input, through dequant_einsum with the fused run's routing,
    within two bf16 ulps of its row's max (ATT_REL_TOL; the expert products
    alone), and the logits of a dequant_einsum run given the fused run's
    router decisions (ids and gates) within MODE_GAP_TOL; the free-running
    and same-experts gaps and the flips are reported beside them."""
    from repro_torch.models import lm, moe

    logits = {}

    def run(mode, **kw):
        c = cfg.with_matmul_mode(mode)
        with _expert_calls(torch, **kw) as calls:
            h, _ = lm.backbone_seq(qparams, prompts, c)
            logits[mode if "force" not in kw else
                   ("same_router" if kw.get("gates") else "same_experts")] = \
                lm.logits_from_hidden(qparams, h, c).float()
        return calls

    with torch.inference_mode():
        fused = run("fused", inputs=True)
        free = run("dequant_einsum")
        flips_a_layer = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                         for (a, _), (b, _) in zip(fused.routes, free.routes)]
        run("dequant_einsum", force=fused.routes)
        run("dequant_einsum", force=fused.routes, gates=True)
        # each MoE layer alone on the fused run's input, both modes routed alike
        layer_gap = 0.0
        c = cfg.with_matmul_mode("dequant_einsum")
        for i, (args, kw) in enumerate(fused.inputs):
            with _expert_calls(torch, force=[fused.routes[i]], gates=True):
                y, _ = moe.moe_ffn(args[0], args[1], c, *args[3:], **kw)
            with _expert_calls(torch, force=[fused.routes[i]], gates=True):
                yf, _ = moe.moe_ffn(*args, **kw)
            gap = (yf.float() - y.float()).abs().amax(-1) / y.float().abs().amax(-1).clamp(
                min=1e-30)
            layer_gap = max(layer_gap, float(gap.max()))
        del fused, free
        gaps = {k: float((logits["fused"] - v).abs().max()) for k, v in logits.items()
                if k != "fused"}
        finite = bool(torch.isfinite(logits["fused"]).all())
        rep = {"max_abs_logit_gap": gaps["same_router"], "gate": MODE_GAP_TOL,
               "free_running_max_abs_logit_gap": gaps["dequant_einsum"],
               "same_experts_max_abs_logit_gap": gaps["same_experts"],
               "router_flips": sum(flips_a_layer),
               "tokens_routed": len(flips_a_layer) * prompts.numel(),
               "first_flip_layer": next((i for i, f in enumerate(flips_a_layer) if f), None),
               "flips_first_layers": flips_a_layer[:4],
               "moe_layer_max_rel_gap": layer_gap, "moe_layer_gate": ATT_REL_TOL,
               "max_abs_logit": float(logits["fused"].abs().max())}
        del logits
    require(finite, f"{cfg.name}: non-finite fused logits")
    require(layer_gap <= ATT_REL_TOL,
            f"{cfg.name}: an MoE layer's fused output {layer_gap} of its row's max off "
            f"dequant_einsum's on the same input ({rep})")
    require(gaps["same_router"] <= MODE_GAP_TOL,
            f"{cfg.name}: fused vs dequant_einsum logit gap {gaps['same_router']} > "
            f"{MODE_GAP_TOL} with the same router decisions ({rep})")
    return rep


def _engine_gaps(torch, qparams, cfg, reqs, tokens, kept, cache_len):
    """Each request alone (batch 1) through the Engine's path: a prefill at
    its exact length, then the decode step (lm.decode_step over a cache of
    the pool's length, captured once and replayed) fed the Server's tokens.
    Returns, a request each, (the largest logit gap over its decode steps to
    the Server's kept logits (0.0 where it had none), the margin of the
    Engine's argmax over the Server's first token (None where they agree),
    the margins of the decode tokens that differ from the Engine's
    argmax)."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import capture_graph

    dev = qparams["embed"].device
    caches = lm.init_caches(cfg, 1, cache_len, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    box = {}

    def body():
        logits, _ = lm.decode_step(qparams, tok, caches, pos, cfg)
        if "out" not in box:
            box["out"] = torch.empty_like(logits)   # allocated by the warm-up call
        box["out"].copy_(logits)
        pos.add_(1)

    graph = capture_graph(body, dev)
    out = []
    for r, toks, rows in zip(reqs, tokens, kept):
        prompt = torch.as_tensor(r["prompt"], device=dev)[None]
        logits, cc = lm.prefill(qparams, prompt, cfg, cache_len=cache_len)
        first = logits[0].float()
        top = int(first.argmax())
        first_margin = None if top == toks[0] else float(first[top] - first[toks[0]])
        for mine, theirs in zip(caches, cc):
            for key in mine:
                mine[key].copy_(theirs[key])
        pos.fill_(prompt.shape[1])
        require(len(rows) == len(toks) - 1, f"{len(rows)} kept steps for {len(toks)} tokens")
        eng = []
        for t in toks[:-1]:
            tok.fill_(t)
            graph.replay()
            eng.append(box["out"][0].float())
        if not eng:
            out.append((0.0, first_margin, []))
            continue
        eng = torch.stack(eng)
        srv = torch.stack(rows).float()
        nxt = torch.tensor(toks[1:], device=dev)
        arg = eng.argmax(-1)
        diff = arg != nxt
        idx = torch.arange(len(nxt), device=dev)
        margins = (eng[idx, arg] - eng[idx, nxt])[diff].tolist()
        out.append((float((eng - srv).abs().max()), first_margin, margins))
    del graph
    return out


def _moe_server(torch, dev, qparams, cfg, reqs, Checked, total, **kw):
    """The Server over ``reqs`` (bucketed prefills with the router pad mask,
    no host sync in its captured step), its launches checked against its
    admissions and steps.  Returns (server, ids, tokens, report)."""
    from repro_torch.models import moe
    from repro_torch.serving import Telemetry

    n_l = cfg.n_layers
    tel = Telemetry()
    _reset_counts()
    with torch.inference_mode():
        with _capture_guard(torch) as syncs:
            srv = Checked(qparams, cfg, num_slots=MOE_SLOTS, max_seq_len=MOE_SLOT_LEN,
                          telemetry=tel, device=dev, **kw)
            ids, toks, wall, peak = _drive_server(torch, srv, reqs)
    counts = _counts()
    for key in total:
        total[key] += counts[key]
    require(not syncs, f"{cfg.name} Server: the captured step syncs with the host: {syncs[:5]}")
    reg = tel.registry
    admissions = int(reg.counter("serve_prefills_total").value)
    steps = int(reg.counter("serve_decode_steps_total").value)
    b1 = 4 * n_l + 1
    require(admissions == len(reqs) and counts["gemv_moe"] == (1 + steps) * 3 * n_l
            and counts["gemv"] == counts["gemv_tc"] == (1 + steps) * b1 + admissions
            and counts["attn"] == (1 + steps) * n_l and counts["kv"] == 0,
            f"{cfg.name} Server launched {counts} for {admissions} admissions, {steps} steps")
    spans = [e["attrs"] for e in tel.tracer.events if e["name"] == "prefill"]
    padded = [(a["prompt_len"], a["padded_len"]) for a in spans]
    require(len(padded) == admissions and any(p != L for L, p in padded),
            f"{cfg.name} Server: no bucket-padded prefill: {padded}")
    n_tokens = sum(len(t) for t in toks)
    ttft, step_s = reg.histogram("serve_ttft_seconds"), reg.histogram("serve_decode_step_seconds")
    return srv, ids, toks, {
        "tokens": n_tokens, "serve_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_steps": steps, "admissions": admissions, "peak_residents": peak["residents"],
        "ttft_s_median": ttft.percentile(50), "ttft_s_p90": ttft.percentile(90),
        "decode_ms_per_step_median": step_s.percentile(50) * 1e3,
        "bucketed_prefills": sum(p != L for L, p in padded),
        "single_group_prompts": sum(moe._n_groups(L) == 1 for L, _ in padded),
        "host_syncs_in_captured_step": len(syncs), "launches": counts}


def moe_path(torch, dev) -> dict:
    """Phase 3g: the mixture-of-experts decoders at full width.
    moonshot-v1-16b-a3b (48 layers, 64 experts of width 1408, top-6) at
    kv4: seeded bf16 weights quantized on the card (an expert at a time),
    the Engine on 4 prompts of 256 (16 dispatch groups a prefill): graph
    tokens = eager ones, no host sync, one replay 144 expert-batched GEMVs
    (3 a layer), 193 GEMVs of the attention and the head and 48 fused
    attentions, the experts that hold a token, the step and its expert
    products beside their bound; fused vs dequant_einsum within MODE_GAP_TOL
    with the router flips; the Server on 8 slots and on pages of 16 over 16
    requests (bucketed with the router pad mask), pages = slots, and the
    per-request Engine's logits exactly (gap 0.0) for each request whose
    exact-length prefill runs one dispatch group (the grouped request's gap
    reported).  phi3.5-moe at full width, depth PHI_DEPTH: the Engine at
    kv4 (graph = eager, 3 expert GEMVs a layer a replay) and fused vs
    dequant_einsum."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels.kv_dequant import kv_spec
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    out = {"phase": "moe"}
    # what the phases before left in reference cycles (a Server whose
    # _preempt is a lambda over itself) goes before the loads' peaks
    gc.collect()

    # -- moonshot-v1-16b-a3b ---------------------------------------------
    base = get_arch(MOE_ARCH)
    qparams, load = _load_quantized(torch, dev, base, total)
    cfg = base.with_kv_quant(4)
    n_l = cfg.n_layers
    shot = {"depth": n_l, "width": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.top_k,
            "expert_width": cfg.moe_d_ff, "vocab": cfg.vocab_size, "kv_bits": 4,
            "encode_items": "one quantize_pack an expert matrix", **load}
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=_gen(torch, dev, SEED + 14), device=dev)
    G = moe._n_groups(MOE_BATCH * MOE_PROMPT)
    fused = kat.fused_takes(MOE_BATCH, cfg.n_heads, cfg.head_dim, MOE_PROMPT + MOE_NEW,
                            kv_spec(cfg), cfg.n_kv_heads * cfg.head_dim)
    shot["fused_attention_takes_every_layer"] = fused
    if not fused:
        shot["fused_attention_refusal"] = kat.fused_refusal(
            MOE_BATCH, cfg.n_heads, cfg.head_dim, MOE_PROMPT + MOE_NEW, kv_spec(cfg),
            cfg.n_kv_heads * cfg.head_dim)
    _, rep = _moe_engine(torch, dev, qparams, cfg, prompts, MOE_NEW, total)
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": 4 * n_l + 1, "gemv_tc": 4 * n_l + 1,
            "gemv_moe": 3 * n_l, ("attn" if fused else "kv"): n_l}
    require(rep["launches_per_replay"] == want,
            f"moonshot kv4: one replay launched {rep['launches_per_replay']}, want {want}")
    shot["engine_kv4"] = {"batch": MOE_BATCH, "prompt_len": MOE_PROMPT,
                          "dispatch_groups_a_prefill": G,
                          "capacity_a_group": moe.capacity(MOE_BATCH * MOE_PROMPT // G, cfg),
                          "new_tokens": MOE_NEW, **rep}
    shot["mode_gap"] = _moe_mode_gap(torch, qparams, cfg, prompts)

    # the Server: slots, then pages of 16 (as many pages as the slot pool)
    reqs = _moe_requests(cfg)
    Checked = _checked_server(torch)
    srv, ids, plain, slots = _moe_server(torch, dev, qparams, cfg, reqs, Checked, total)
    kept = [srv.kept[i] for i in ids]
    del srv
    srv_p, _, paged, pages = _moe_server(torch, dev, qparams, cfg, reqs, Checked, total,
                                         paged=True, page_size=PAGE_SIZE)
    del srv_p
    require(paged == plain, f"{cfg.name}: the paged Server's tokens differ from the slot pool's")
    _reset_counts()
    with torch.inference_mode():
        gaps = _engine_gaps(torch, qparams, cfg, reqs, plain, kept, MOE_SLOT_LEN)
    for key, n in _counts().items():
        total[key] += n
    one_group = [moe._n_groups(len(r["prompt"])) == 1 for r in reqs]
    exact = [g for g, one in zip(gaps, one_group) if one]
    require(all(g == 0.0 and first is None and not m for g, first, m in exact),
            f"{cfg.name} Server vs the per-request Engine on one-group prompts: "
            f"{[g for g in exact if g[0] or g[1] is not None or g[2]]}")
    grouped = [(len(r["prompt"]), g) for r, g, one in zip(reqs, gaps, one_group) if not one]
    require(any(L >= 256 and L % 16 == 0 for L, _ in grouped),
            f"{cfg.name} Server: no prompt runs 16 dispatch groups: {grouped}")
    shot["server"] = {
        "kv_bits": 4, "num_slots": MOE_SLOTS, "max_seq_len": MOE_SLOT_LEN,
        "requests": len(reqs), "prompt_lens": [len(r["prompt"]) for r in reqs],
        "slots": slots, "pages": {"page_size": PAGE_SIZE, **pages},
        "paged_tokens_equal_slots": True,
        "engine_b1_gap_one_group": max(g for g, _, _ in exact),
        "engine_b1_one_group_requests": len(exact),
        "engine_b1_grouped": [{"prompt_len": L, "max_abs_logit_gap": g,
                               "first_token_margin": first, "decode_token_margins": m}
                              for L, (g, first, m) in grouped]}
    shot["peak_bytes"] = max(load["init_peak_bytes"], torch.cuda.max_memory_allocated())
    out[MOE_ARCH] = shot
    del qparams
    torch.cuda.empty_cache()

    # -- phi3.5-moe at full width, cut depth -------------------------------
    base = dataclasses.replace(get_arch(PHI_ARCH), n_layers=PHI_DEPTH)
    qparams, load = _load_quantized(torch, dev, base, total)
    cfg = base.with_kv_quant(4)
    prompts = torch.randint(0, cfg.vocab_size, (PHI_BATCH, PHI_PROMPT),
                            generator=_gen(torch, dev, SEED + 16), device=dev)
    _, rep = _moe_engine(torch, dev, qparams, cfg, prompts, PHI_NEW, total, timed=False)
    fused = kat.fused_takes(PHI_BATCH, cfg.n_heads, cfg.head_dim, PHI_PROMPT + PHI_NEW,
                            kv_spec(cfg), cfg.n_kv_heads * cfg.head_dim)
    n_l = cfg.n_layers
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": 4 * n_l + 1, "gemv_tc": 4 * n_l + 1,
            "gemv_moe": 3 * n_l, ("attn" if fused else "kv"): n_l}
    require(rep["launches_per_replay"] == want,
            f"phi3.5 kv4: one replay launched {rep['launches_per_replay']}, want {want}")
    out[PHI_ARCH] = {"depth": n_l, "full_depth": get_arch(PHI_ARCH).n_layers,
                     "width": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.top_k,
                     "expert_width": cfg.moe_d_ff, **load,
                     "engine_kv4": {"batch": PHI_BATCH, "prompt_len": PHI_PROMPT,
                                    "new_tokens": PHI_NEW, **rep},
                     "mode_gap": _moe_mode_gap(torch, qparams, cfg, prompts)}
    del qparams
    # the phase's objects gone and the cache handed back before the phases
    # after it capture their steps
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["memory_allocated_after_bytes"] = torch.cuda.memory_allocated()
    out["weights"] = "4-bit float b64"
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = total
    emit(out)
    return {"launches": total,
            "gemv_experts": out[MOE_ARCH]["engine_kv4"]["expert_products"]}


def _ssm_requests(cfg):
    """SSM_REQUESTS requests from a seed whose prompts keep the SSD chunk rule
    (``ssm.ssd_chunked``: at most one chunk, or whole chunks): uniform random
    tokens, 16-256 of them, and requests 1, 4 and 9 of SSM_LONG_PROMPTS'
    lengths; budgets of 16-64 new tokens.  The first SSM_SLOTS arrive at
    step 0 and fill the pool (class 1, background); the rest arrive one
    every two steps from step 4 (class 0, urgent), while the pool is busy."""
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    long = dict(zip((1, 4, 9), SSM_LONG_PROMPTS))
    reqs = []
    for i in range(SSM_REQUESTS):
        L = long.get(i, int(rng.integers(SSM_SHORT_PROMPTS[0], SSM_SHORT_PROMPTS[1] + 1)))
        background = i < SSM_SLOTS
        reqs.append({"prompt": rng.integers(0, cfg.vocab_size, L),
                     "max_new": int(rng.integers(SERVER_NEW_TOKENS[0], SERVER_NEW_TOKENS[1] + 1)),
                     "arrival_time": 0.0 if background else float(4 + 2 * (i - SSM_SLOTS)),
                     "priority": 1 if background else 0})
    return reqs


def _time_ssm_gemvs(torch, dev, qparams, cfg, B) -> dict:
    """The decode step's B1 GEMVs alone (every layer's in_proj and out_proj
    on B rows, the step's operands), captured and replayed, beside the bound
    of their bytes (each layer's words, scales and codebook, x and y):
    the step's time less this is its plain-PyTorch SSM work."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import dense

    g = _gen(torch, dev, SEED + 21)
    mixers = [p["mixer"] for p, *_ in blocks._layers(qparams["stack"], cfg)]
    xs = {K: torch.randn((B, K), generator=g, device=dev).to(torch.bfloat16)
          for K in (cfg.d_model, cfg.d_inner)}
    nbytes = flops = 0
    for mp in mixers:
        for key, K in (("in_proj", cfg.d_model), ("out_proj", cfg.d_inner)):
            w = mp[key]["w"]
            nbytes += (w.packed.numel() * 4 + w.scales.numel() * 2 + w.codebook.numel() * 4
                       + 2 * B * (K + w.quant_shape[0]))
            flops += 2 * B * K * w.quant_shape[0]

    def gemvs():
        for mp in mixers:
            dense(mp["in_proj"], xs[cfg.d_model], mode=cfg.matmul_mode)
            dense(mp["out_proj"], xs[cfg.d_inner], mode=cfg.matmul_mode)

    with torch.inference_mode():
        ms = _time_ms(torch, gemvs, 10)
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"gemvs": 2 * len(mixers), "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes}


def _ssm_layer_gate(torch, dev, qparams, cfg) -> dict:
    """Each SSM layer of the model on the card: SSM_GATE_STEPS decode steps
    (``ssm.ssm_block_decode`` from an empty f32 cache) against its sequence
    mode (``ssm.ssm_block``) on the same f32 input (0.5 N(0, 1), as
    tests/test_ssm_moe.py), the layer's own 4-bit weights: the outputs within
    SSM_GATE_Y_TOL, the final state and conv within SSM_GATE_STATE_TOL."""
    from repro_torch.models import blocks, ssm

    g = _gen(torch, dev, SEED + 18)
    B, T = SSM_GATE_BATCH, SSM_GATE_STEPS
    worst = {"y": 0.0, "state": 0.0, "conv": 0.0}
    n = 0
    with torch.inference_mode():
        for p, _, _, mixer, _, _ in blocks._layers(qparams["stack"], cfg):
            if mixer != "ssm":
                continue
            u = 0.5 * torch.randn((B, T, cfg.d_model), generator=g, device=dev)
            y_seq, tail = ssm.ssm_block(p["mixer"], u, cfg)
            cache = ssm.init_ssm_cache(cfg, B, dtype=torch.float32, device=dev)
            y_dec = torch.stack([ssm.ssm_block_decode(p["mixer"], u[:, t], cache, cfg)
                                 for t in range(T)], dim=1)
            for key, a, b in (("y", y_seq, y_dec), ("state", tail["state"], cache["state"]),
                              ("conv", tail["conv"], cache["conv"])):
                worst[key] = max(worst[key], float((a.float() - b.float()).abs().max()))
            n += 1
    require(n and worst["y"] <= SSM_GATE_Y_TOL and worst["state"] <= SSM_GATE_STATE_TOL
            and worst["conv"] <= SSM_GATE_STATE_TOL,
            f"{cfg.name}: an SSM layer's decode steps are off its sequence mode: {worst}")
    return {"layers": n, "batch": B, "steps": T, "input": "f32, 0.5 N(0, 1)",
            "max_abs_gap": worst, "tol": {"y": SSM_GATE_Y_TOL, "state_conv": SSM_GATE_STATE_TOL}}


def _ssm_model_gaps(torch, qparams, cfg, prompts) -> dict:
    """The whole model on the card: (a) the decode path against the full
    forward: a prefill of SSM_GAP_PREFILL tokens, then SSM_GAP_STEPS decode
    steps fed the prompt's next tokens, against lm.backbone_seq's logits at
    the same positions (reported: depth amplifies it in both packages, C3);
    (b) fused vs dequant_einsum logits over the prompts' last SSM_MODE_ROWS
    rows, gated at MODE_GAP_TOL."""
    from repro_torch.models import lm

    P, n = SSM_GAP_PREFILL, SSM_GAP_STEPS
    seq = prompts[:, :P + n + 1]
    out = {}
    with torch.inference_mode():
        h, _ = lm.backbone_seq(qparams, seq, cfg)
        full = lm.logits_from_hidden(qparams, h[:, P - 1:P + n], cfg).float()
        del h
        logits, caches = lm.prefill(qparams, seq[:, :P], cfg, cache_len=P + n)
        steps = [logits.float()]
        for t in range(P, P + n):
            logits, caches = lm.decode_step(qparams, seq[:, t], caches, t, cfg)
            steps.append(logits.float())
        dec = torch.stack(steps, 1)
        out["decode_vs_forward"] = {"max_abs_logit_gap": float((dec - full).abs().max()),
                                    "max_abs_logit": float(full.abs().max()),
                                    "prefill": P, "decode_steps": n, "gated": False}
        del full, dec, steps, caches
        rows = {}
        for mode in ("fused", "dequant_einsum"):
            c = cfg.with_matmul_mode(mode)
            h, _ = lm.backbone_seq(qparams, prompts, c)
            rows[mode] = lm.logits_from_hidden(qparams, h[:, -SSM_MODE_ROWS:], c).float()
            del h
        gap = float((rows["fused"] - rows["dequant_einsum"]).abs().max())
        finite = bool(torch.isfinite(rows["fused"]).all())
        del rows
    require(finite and gap <= MODE_GAP_TOL,
            f"{cfg.name}: fused vs dequant_einsum logit gap {gap} > {MODE_GAP_TOL}")
    out["mode_gap"] = {"max_abs_logit_gap": gap, "gate": MODE_GAP_TOL, "rows": SSM_MODE_ROWS}
    return out


def ssm_path(torch, dev) -> dict:
    """Phase 3h: the state-space and hybrid decoders at full width.
    mamba2-130m (24 SSM layers, no attention, a tied head) at full width and
    depth, seeded bf16 weights quantized on the card: the Engine on 4 prompts
    of 1024 (4 SSD chunks each), graph tokens = eager ones, no host sync, one
    replay 48 tensor-core GEMVs (in_proj and out_proj a layer; the tied head a
    dense product in column pieces), 0 fused attentions and 0 KV dequants,
    the step, prefill s and peaks; the per-layer decode gate; the whole
    model's decode-vs-forward gap (reported) and fused vs dequant_einsum
    within MODE_GAP_TOL; the Server on SSM_SLOTS slots over SSM_REQUESTS
    requests at exact length, then two classes with preemption (the same
    tokens, each spilled state and conv restored bit for bit), paged and
    prefill_chunk refused before a launch, each request's decode logits
    against the per-request Engine's within SERVER_LOGIT_TOL.  jamba-v0.1-52b
    at full width, depth JAMBA_DEPTH: its init and quantize peaks, the Engine
    at kv4 on 2 prompts of 1024 (graph = eager; one replay 31 GEMVs, 12
    expert-batched GEMVs and one attention), and fused vs dequant_einsum as
    the moe phase gates MoE.  Returns the phase's launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels.kv_dequant import kv_spec
    from repro_torch.models import ssm
    from repro_torch.serving import Server, Telemetry

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    out = {"phase": "ssm"}
    gc.collect()

    # -- mamba2-130m -------------------------------------------------------
    cfg = get_arch(SSM_ARCH)
    qparams, load = _load_quantized(torch, dev, cfg, total)
    n_l = cfg.n_layers
    mamba = {"depth": n_l, "width": cfg.d_model, "d_inner": cfg.d_inner,
             "ssm_heads": cfg.n_ssm_heads, "head_dim": cfg.ssm_head_dim,
             "state": cfg.ssm_state, "ssd_chunk": cfg.ssm_chunk, "vocab": cfg.vocab_size,
             "in_proj": [ssm.in_proj_dim(cfg), cfg.d_model], "kv_bits": cfg.kv_bits, **load}
    prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                            generator=_gen(torch, dev, SEED + 19), device=dev)
    torch.cuda.reset_peak_memory_stats()
    _, rep = _moe_engine(torch, dev, qparams, cfg, prompts, SSM_NEW, total)
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": 2 * n_l, "gemv_tc": 2 * n_l}
    require(rep["launches_per_replay"] == want,
            f"mamba2: one replay launched {rep['launches_per_replay']}, want {want}")
    mamba["engine"] = {"batch": SSM_BATCH, "prompt_len": SSM_PROMPT, "new_tokens": SSM_NEW,
                       "ssd_chunks_a_prompt": SSM_PROMPT // cfg.ssm_chunk, **rep,
                       "step_gemvs": _time_ssm_gemvs(torch, dev, qparams, cfg, SSM_BATCH)}
    mamba["layer_decode_gate"] = _ssm_layer_gate(torch, dev, qparams, cfg)
    mamba.update(_ssm_model_gaps(torch, qparams, cfg, prompts))

    # the Server: exact-length prefills, then two classes with preemption
    reqs = _ssm_requests(cfg)
    Checked = _checked_server(torch)
    with torch.inference_mode():
        tel = Telemetry()
        _reset_counts()
        with _capture_guard(torch) as syncs:
            srv = Checked(qparams, cfg, num_slots=SSM_SLOTS, max_seq_len=SSM_SLOT_LEN,
                          telemetry=tel, device=dev)
            ids, plain, wall, peak = _drive_server(torch, srv, reqs)
        counts = _counts()
        for key in total:
            total[key] += counts[key]
        require(not syncs, f"mamba2 Server: the captured step syncs with the host: {syncs[:5]}")
        reg = tel.registry
        admissions = int(reg.counter("serve_prefills_total").value)
        steps = int(reg.counter("serve_decode_steps_total").value)
        require(admissions == len(reqs) and counts["attn"] == counts["kv"] == 0
                and counts["gemv_moe"] == 0
                and counts["gemv"] == counts["gemv_tc"] == (1 + steps) * 2 * n_l,
                f"mamba2 Server launched {counts} for {admissions} admissions, {steps} steps")
        spans = [e["attrs"] for e in tel.tracer.events if e["name"] == "prefill"]
        require(len(spans) == admissions
                and all(a["padded_len"] == a["prompt_len"] for a in spans),
                f"mamba2 Server: a prefill was padded: {spans}")
        kept = [srv.kept[i] for i in ids]
        ttft, step_s = reg.histogram("serve_ttft_seconds"), reg.histogram(
            "serve_decode_step_seconds")
        n_tokens = sum(len(t) for t in plain)
        del srv
        srv_p = Checked(qparams, cfg, num_slots=SSM_SLOTS, max_seq_len=SSM_SLOT_LEN,
                        max_preemptions=1, device=dev)
        _reset_counts()
        _, preempted, _, _ = _drive_server(torch, srv_p, reqs, classes=True)
        for key, n in _counts().items():
            total[key] += n
        n_pre = srv_p.scheduler.n_preemptions
        require(n_pre >= 1 and srv_p.restores == n_pre,
                f"mamba2 Server: {n_pre} preemptions, {srv_p.restores} restores")
        require(preempted == plain, "mamba2 Server: preemption changed tokens")
        del srv_p
        refused = {}
        for name, kw in (("paged", {"paged": True}), ("prefill_chunk", {"prefill_chunk": 128})):
            before = _counts()
            try:
                Server(qparams, cfg, num_slots=SSM_SLOTS, max_seq_len=SSM_SLOT_LEN, device=dev,
                       **kw)
                refused[name] = None
            except ValueError as e:
                refused[name] = str(e)
            require(refused[name] is not None and _counts() == before,
                    f"mamba2 Server({name}) did not refuse before a launch: {refused[name]}")
        _reset_counts()
        gaps = _engine_gaps(torch, qparams, cfg, reqs, plain, kept, SSM_SLOT_LEN)
        for key, n in _counts().items():
            total[key] += n
    worst = max(g for g, _, _ in gaps)
    require(worst <= SERVER_LOGIT_TOL,
            f"mamba2 Server vs the per-request Engine: logit gap {worst} > {SERVER_LOGIT_TOL}")
    mamba["server"] = {
        "kv_bits": cfg.kv_bits, "num_slots": SSM_SLOTS, "max_seq_len": SSM_SLOT_LEN,
        "requests": len(reqs), "prompt_lens": [len(r["prompt"]) for r in reqs],
        "tokens": n_tokens, "serve_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_steps": steps, "peak_residents": peak["residents"],
        "ttft_s_median": ttft.percentile(50), "ttft_s_p90": ttft.percentile(90),
        "decode_ms_per_step_median": step_s.percentile(50) * 1e3,
        "exact_length_prefills": admissions, "preemptions": n_pre,
        "spill_restore_bit_exact": True, "preempted_tokens_identical": True,
        "engine_b1_max_logit_gap": worst, "engine_b1_logit_tol": SERVER_LOGIT_TOL,
        "engine_b1_gaps": [g for g, _, _ in gaps],
        "engine_b1_first_token_margins": [f for _, f, _ in gaps if f is not None],
        "engine_b1_decode_token_margins": [m for _, _, ms in gaps for m in ms],
        "refused": refused, "host_syncs_in_captured_step": len(syncs), "launches": counts}
    mamba["peak_bytes"] = max(load["init_peak_bytes"], torch.cuda.max_memory_allocated())
    out[SSM_ARCH] = mamba
    del qparams
    gc.collect()
    torch.cuda.empty_cache()

    # -- jamba-v0.1-52b at full width, cut depth ----------------------------
    base = dataclasses.replace(get_arch(JAMBA_ARCH), n_layers=JAMBA_DEPTH)
    qparams, load = _load_quantized(torch, dev, base, total)
    cfg = base.with_kv_quant(4)
    prompts = torch.randint(0, cfg.vocab_size, (JAMBA_BATCH, JAMBA_PROMPT),
                            generator=_gen(torch, dev, SEED + 20), device=dev)
    torch.cuda.reset_peak_memory_stats()
    _, rep = _moe_engine(torch, dev, qparams, cfg, prompts, JAMBA_NEW, total)
    fused = kat.fused_takes(JAMBA_BATCH, cfg.n_heads, cfg.head_dim, JAMBA_PROMPT + JAMBA_NEW,
                            kv_spec(cfg), cfg.n_kv_heads * cfg.head_dim)
    sched = cfg.layer_schedule()
    n_attn = sum(m == "attn" for m, _ in sched)
    n_ssm = sum(m == "ssm" for m, _ in sched)
    n_mlp = sum(f == "mlp" for _, f in sched)
    n_moe = sum(f == "moe" for _, f in sched)
    n_gemv = 4 * n_attn + 2 * n_ssm + 3 * n_mlp + 1
    want = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": n_gemv, "gemv_tc": n_gemv,
            "gemv_moe": 3 * n_moe, ("attn" if fused else "kv"): n_attn}
    require(rep["launches_per_replay"] == want,
            f"jamba kv4: one replay launched {rep['launches_per_replay']}, want {want}")
    out[JAMBA_ARCH] = {"depth": cfg.n_layers, "full_depth": get_arch(JAMBA_ARCH).n_layers,
                       "width": cfg.d_model, "d_inner": cfg.d_inner, "state": cfg.ssm_state,
                       "experts": cfg.n_experts, "top_k": cfg.top_k,
                       "expert_width": cfg.moe_d_ff, "fused_attention_takes": fused, **load,
                       "engine_kv4": {"batch": JAMBA_BATCH, "prompt_len": JAMBA_PROMPT,
                                      "new_tokens": JAMBA_NEW, **rep},
                       "mode_gap": _moe_mode_gap(torch, qparams, cfg, prompts)}
    del qparams
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["memory_allocated_after_bytes"] = torch.cuda.memory_allocated()
    out["weights"] = "4-bit float b64"
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = total
    emit(out)
    return total


def _s2s_step_gemvs(torch, dev, qparams, cfg, B) -> dict:
    """A decode step's B1 GEMVs alone (each decoder layer's nine products and
    the head, on B rows, the step's operands), captured and replayed, beside
    the bound of their bytes (words, scales, codebook, x and y)."""
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.models.blocks import take

    names = [("self_attn", "wq"), ("self_attn", "wk"), ("self_attn", "wv"),
             ("self_attn", "wo"), ("cross_attn", "wq"), ("cross_attn", "wo"),
             ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
    stack = qparams["dec_stack"]
    qts = [take(stack, i)[a][b]["w"] for i in range(cfg.n_layers) for a, b in names]
    qts.append(qparams["lm_head"])
    calls, _, nbytes, flops = _b1_launches(torch, dev, qts, B, _gen(torch, dev, SEED + 23))
    with torch.inference_mode():
        ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_gemv), 10)
    del calls
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"gemvs": len(qts), "rows": B, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "weights": sum(math.prod(qt.quant_shape) for qt in qts)}


def _s2s_decode_gap(torch, qparams, cfg, frames, seq, P) -> float:
    """The largest logit gap between ``seq2seq.prefill`` over seq[:, :P] then
    teacher-forced ``decode_step``s over the rest of seq, and the forward
    (``decoder_seq`` + ``logits_from_hidden``) at the same positions."""
    from repro_torch.models import lm, seq2seq

    h, _ = seq2seq.decoder_seq(qparams, seq, seq2seq.encode(qparams, frames, cfg), cfg)
    full = lm.logits_from_hidden(qparams, h[:, P - 1:], cfg).float()
    del h
    logits, caches = seq2seq.prefill(qparams, frames, seq[:, :P], cfg)
    gap = float((logits.float() - full[:, 0]).abs().max())
    pos = torch.full((), P, dtype=torch.int32, device=seq.device)
    for t in range(P, seq.shape[1]):
        logits, caches = seq2seq.decode_step(qparams, seq[:, t], caches, pos, cfg)
        gap = max(gap, float((logits.float() - full[:, t - P + 1]).abs().max()))
        pos.add_(1)
    return gap


def seq2seq_path(torch, dev) -> dict:
    """Phase 3i: the encoder-decoder with frame inputs at full width and depth.
    seamless-m4t-large-v2 (24 + 24 layers, d 1024, an untied 256,206-row
    head), seeded bf16 weights quantized on the card (434 quantize_pack
    launches).  The main path: ``seq2seq.prefill`` over S2S_BATCH sources of
    S2S_FRAMES stub frames and the S2S_PREFIX tokens (217 tensor-core GEMMs
    and 217 tensor-core GEMVs, nothing else), then S2S_NEW - 1 greedy
    ``seq2seq.decode_step``s at a 0-d device position (217 GEMVs each,
    nothing else): its counts set to 0 just before, read just after.  One
    step captured with ``capture_graph`` from the same caches: no host sync
    in its body, its logits the eager step's bit for bit, its replay's
    launches the step's.  Gated: finite logits, tokens in range, the
    teacher-forced fused vs dequant_einsum logits within MODE_GAP_TOL (no B1
    launch under dequant_einsum), the decode path's gap to the forward with
    both stacks cut to each depth of S2S_REF_GAPS at most the reference's own
    gap there plus S2S_GAP_TOL (the full depth's reported).  Timed: the
    prefill and its encoder, the step (replayed and eager), its GEMVs alone
    and its attention reads alone.  Returns the phase's launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import attention, blocks, lm, seq2seq
    from repro_torch.serving import engine as engine_mod

    t_phase = time.perf_counter()
    total = dict.fromkeys(_COUNT_KEYS, 0)
    gc.collect()
    cfg = get_arch(S2S_ARCH)
    qparams, load = _load_quantized(torch, dev, cfg, total)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    out = {"phase": "seq2seq", "arch": S2S_ARCH, "encoder_depth": n_enc, "decoder_depth": n_dec,
           "width": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": lm.count_params(cfg), **load}
    B, S, P = S2S_BATCH, S2S_FRAMES, len(S2S_PREFIX)
    frames = torch.from_numpy(np.random.default_rng(SEED + 22).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)).to(dev).to(torch.bfloat16)
    prefix = torch.tensor([S2S_PREFIX] * B, dtype=torch.int64, device=dev)
    none = dict.fromkeys(_COUNT_KEYS, 0)
    step_gemvs = 9 * n_dec + 1
    want_step = {**none, "gemv": step_gemvs, "gemv_tc": step_gemvs}
    want_prefill = {**none, "gemm": 1 + 7 * n_enc + 2 * n_dec, "gemv": step_gemvs,
                    "gemv_tc": step_gemvs}
    torch.cuda.reset_peak_memory_stats()

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    with torch.inference_mode():
        # the main path: the prefill, then the greedy decode steps
        torch.cuda.synchronize()
        e0, e1 = events()
        _reset_counts()
        t0 = time.perf_counter()
        e0.record()
        logits, caches = seq2seq.prefill(qparams, frames, prefix, cfg)
        e1.record()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_device_s = e0.elapsed_time(e1) / 1e3
        pre = _counts()
        toks, step_logits = [logits.argmax(-1).to(torch.int32)], [logits]
        pos = torch.full((), P, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for t in range(S2S_NEW - 1):
            logits, caches = seq2seq.decode_step(qparams, toks[-1], caches, pos, cfg)
            if t == 0:
                first = {k: n - pre[k] for k, n in _counts().items()}
            toks.append(logits.argmax(-1).to(torch.int32))
            step_logits.append(logits)
            pos.add_(1)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / (S2S_NEW - 1) * 1e3
        main = _counts()
        for key in total:
            total[key] += main[key]
        require(pre == want_prefill, f"seq2seq prefill launched {pre}, want {want_prefill}")
        require(first == want_step, f"seq2seq decode step launched {first}, want {want_step}")
        want_main = {k: want_prefill[k] + (S2S_NEW - 1) * want_step[k] for k in none}
        require(main == want_main, f"seq2seq prefill + decode launched {main}, want {want_main}")
        tokens = torch.stack(toks, 1)
        dec = torch.stack(step_logits, 1).float()
        del step_logits
        require(tuple(tokens.shape) == (B, S2S_NEW)
                and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
                and bool(torch.isfinite(dec).all()),
                f"seq2seq: tokens {tuple(tokens.shape)} out of range or non-finite logits")
        self_c, cross = caches
        require(self_c["k"].dtype == torch.bfloat16
                and tuple(self_c["k"].shape) == (n_dec, B, cfg.decoder_cache_len, cfg.n_kv_heads,
                                                 cfg.head_dim)
                and tuple(cross["k"].shape) == (n_dec, B, S, cfg.n_kv_heads, cfg.head_dim),
                f"seq2seq caches: self {tuple(self_c['k'].shape)} {self_c['k'].dtype}, "
                f"cross {tuple(cross['k'].shape)}")

        # one step captured from the same caches: the replay against the
        # eager step, bit for bit
        snap = {k: v.clone() for k, v in self_c.items()}
        tok_s, pos_s = toks[-1].clone(), pos.clone()
        box = {}

        def body():
            lg, _ = seq2seq.decode_step(qparams, tok_s, caches, pos_s, cfg)
            if "out" not in box:
                box["out"] = torch.empty_like(lg)   # allocated by the warm-up call
            box["out"].copy_(lg)

        def reload():
            for k, v in snap.items():
                self_c[k].copy_(v)

        before = _counts()
        with _capture_guard(torch) as syncs:
            step = engine_mod.capture_graph(body, dev)
        warm = {k: n - before[k] for k, n in _counts().items()}
        require(not syncs, f"seq2seq: the captured step syncs with the host: {syncs[:5]}")
        reload()
        _reset_counts()
        step.replay()
        torch.cuda.synchronize()
        replay = _counts()
        graph_logits = box["out"].clone()
        reload()
        eager_logits, _ = seq2seq.decode_step(qparams, tok_s, caches, pos_s, cfg)
        torch.cuda.synchronize()
        for key in total:
            total[key] += warm[key] + replay[key]
        require(warm == replay == want_step,
                f"seq2seq captured step: warm-up {warm}, replay {replay}, want {want_step}")
        require(torch.equal(graph_logits.view(torch.int16), eager_logits.view(torch.int16)),
                "seq2seq: the replayed step's logits differ from the eager step's")
        del graph_logits, eager_logits
        t0 = time.perf_counter()
        for _ in range(S2S_TIMED_STEPS):
            step.graph.replay()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / S2S_TIMED_STEPS * 1e3
        device_ms = _time_graph(torch, step.graph, S2S_TIMED_STEPS)
        reload()
        # the step's attention reads alone: each layer's self read over its
        # 4096 slots at the step's position and cross read over the source
        q = torch.randn((B, cfg.n_heads, cfg.head_dim), generator=_gen(torch, dev, SEED + 24),
                        device=dev).to(torch.bfloat16)
        every = S + 1
        reads_ms = _time_ms(torch, lambda: [
            (attention.decode_attention(q, blocks.take(self_c, i), pos_s),
             attention.decode_attention(q, blocks.take(cross, i), every))
            for i in range(n_dec)], 10)
        del step, snap, caches, self_c, cross, box
        torch.cuda.empty_cache()
        # the prefill again, warm (the first one above paid the phase's
        # first launches), and its encoder alone
        e0, e1 = events()
        t0 = time.perf_counter()
        e0.record()
        seq2seq.prefill(qparams, frames, prefix, cfg)
        e1.record()
        torch.cuda.synchronize()
        warm_prefill_s, warm_prefill_device_s = time.perf_counter() - t0, e0.elapsed_time(e1) / 1e3
        e0, e1 = events()
        e0.record()
        seq2seq.encode(qparams, frames, cfg)
        e1.record()
        torch.cuda.synchronize()
        encode_device_s = e0.elapsed_time(e1) / 1e3

        # teacher-forced on the greedy tokens: the forward's logits at the
        # positions the prefill and the decode steps predicted from, fused
        # and dequant_einsum
        seq = torch.cat([prefix, tokens[:, :-1].long()], 1)
        full = {}
        for mode in ("fused", "dequant_einsum"):
            c = cfg.with_matmul_mode(mode)
            _reset_counts()
            h, _ = seq2seq.decoder_seq(qparams, seq, seq2seq.encode(qparams, frames, c), c)
            full[mode] = lm.logits_from_hidden(qparams, h[:, P - 1:], c).float()
            del h
            torch.cuda.synchronize()
            counts = _counts()
            for key in total:
                total[key] += counts[key]
            if mode == "dequant_einsum":
                require(counts == none, f"seq2seq dequant_einsum launched {counts}")
        mode_gap = float((full["fused"] - full["dequant_einsum"]).abs().max())
        require(bool(torch.isfinite(full["dequant_einsum"]).all()) and mode_gap <= MODE_GAP_TOL,
                f"seq2seq: fused vs dequant_einsum logit gap {mode_gap} > {MODE_GAP_TOL}")
        gap = float((dec - full["fused"]).abs().max())
        max_logit = float(full["fused"].abs().max())
        del full, dec
        # the same gap with both stacks cut to the depths the reference was
        # measured at (the first layers of the same tree, the same tokens)
        cut_gaps = {}
        for d in S2S_REF_GAPS:
            c = dataclasses.replace(cfg, n_layers=d, n_encoder_layers=d)
            _reset_counts()
            cut_gaps[d] = _s2s_decode_gap(torch, qparams, c, frames, seq, P)
            for key, n in _counts().items():
                total[key] += n
    bars = {d: S2S_REF_GAPS[d] + S2S_GAP_TOL for d in S2S_REF_GAPS}
    require(all(cut_gaps[d] <= bars[d] for d in bars),
            f"seq2seq: decode-vs-forward gaps by depth {cut_gaps}, bars (the reference's own "
            f"gap + {S2S_GAP_TOL}) {bars}")
    out.update({
        "sources": B, "frames": S, "prefix": list(S2S_PREFIX), "new_tokens": S2S_NEW,
        "kv_cache": f"bf16, {cfg.decoder_cache_len} self slots; cross K/V over {S} frames",
        "launches_prefill": pre, "launches_per_step": first, "launches_per_replay": replay,
        "host_syncs_in_captured_step": len(syncs), "replay_equals_eager": True,
        "prefill_s": prefill_s, "prefill_device_s": prefill_device_s,
        "prefill_s_warm": warm_prefill_s, "prefill_device_s_warm": warm_prefill_device_s,
        "encode_device_s": encode_device_s,
        "decode_ms_per_step": host_ms, "decode_step_device_ms": device_ms,
        "decode_ms_per_step_eager": eager_ms,
        "step_gemvs": _s2s_step_gemvs(torch, dev, qparams, cfg, B),
        "attention_reads_ms": reads_ms, "attention_reads_share": reads_ms / device_ms,
        "mode_gap": {"max_abs_logit_gap": mode_gap, "gate": MODE_GAP_TOL,
                     "positions": S2S_NEW},
        "decode_vs_forward": {"max_abs_logit_gap": gap, "gated": False,
                              "max_abs_logit": max_logit, "positions": S2S_NEW,
                              "by_depth": cut_gaps, "reference_cpu_by_depth": S2S_REF_GAPS,
                              "bars_by_depth": bars},
        "peak_bytes": max(load["init_peak_bytes"], torch.cuda.max_memory_allocated())})
    del qparams
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["memory_allocated_after_bytes"] = torch.cuda.memory_allocated()
    out["weights"] = "4-bit float b64"
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = total
    emit(out)
    return total


def _fixed_plan(cfg, base):
    """FIXED_PLAN_BITS over the unit names of Qwen2-7B's tree."""
    import dataclasses

    from repro_torch.precision import PrecisionPlan

    return PrecisionPlan(arch=cfg.name, default=dataclasses.asdict(base),
                         assignments={(u if u == "lm_head" else f"stack/0/{u}"): {"bits": b}
                                      for u, b in FIXED_PLAN_BITS.items()})


def plan_path(torch, dev, run) -> dict:
    """Phase 3e: mixed precision on Qwen2-7B at full width and depth, seeded
    bf16 weights.  build_plan on the card (profile, KL probes, measured
    selection), the plan through JSON and back; then FIXED_PLAN_BITS served
    through Engine(plan=) (the main path: captured tokens equal to eager
    ones, one replay's launches, fused vs dequant_einsum), Server(plan=) on
    the slot pool (each request against the per-request Engine) and on
    pages of PAGE_SIZE, and with Telemetry(kv_probe_every=...): every
    token the slot pool's."""
    import dataclasses

    from repro_torch.configs import QuantConfig
    from repro_torch.models import lm
    from repro_torch.precision import PrecisionPlan, build_plan, probe_tokens, profile_units
    from repro_torch.serving import Engine, Server, Telemetry

    cfg, prompts = run["cfg"], run["prompts"]
    base = QuantConfig(bits=4, dtype="float", block_size=64)
    n_dense = sum(b >= 16 for u, b in FIXED_PLAN_BITS.items() if u != "lm_head")
    b1_step = (7 - n_dense) * cfg.n_layers + 1   # the quantized matrices of a step
    b2_step = cfg.n_layers
    step_counts = {**dict.fromkeys(_COUNT_KEYS, 0), "gemv": b1_step, "gemv_tc": b1_step,
                   "attn": b2_step}
    reqs = _server_requests(cfg)
    cache_len = SERVER_PROMPT_LENS[1] + SERVER_NEW_TOKENS[1]
    t_phase = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    lines = []

    # the planner at full width: the dense tree is its teacher
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    probe = probe_tokens(dataclasses.replace(cfg, vocab_size=PROBE_VOCAB), device=dev)
    t0 = time.perf_counter()
    profiles = profile_units(params, cfg, base=base, probe_toks=probe, log=lines.append)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan = build_plan(params, cfg, base=base, equal_avg_bits=4, probe_toks=probe,
                      profiles=profiles, log=lines.append)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    plan_counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    meta = plan.meta
    require(meta["measured_kl"] and all(math.isfinite(v) for v in meta["measured_kl"].values()),
            f"build_plan measured no candidate: {meta['measured_kl']}")
    require(meta["cost_bits"] <= meta["budget_bits"] + 1e-6,
            f"the plan costs {meta['cost_bits']} bits over the budget {meta['budget_bits']}")
    require(meta["measured_kl"][meta["winner"]] <= meta["measured_kl"]["uniform4"] + 1e-12,
            f"the winner {meta['winner']} measures worse than uniform4: {meta['measured_kl']}")
    path = ROOT / "build" / "plans" / f"{cfg.name}.json"
    plan.save(path)
    again = PrecisionPlan.load(path)
    require(again.assignments == plan.assignments and again.default == plan.default,
            "the plan changed through its JSON")
    out = {"winner": meta["winner"], "describe": plan.describe(),
           "assignments": {u: a["bits"] for u, a in plan.assignments.items()},
           "predicted": meta["predicted"], "measured_kl": meta["measured_kl"],
           "avg_bits_per_param": meta["avg_bits_per_param"],
           "probe_kl": {u: p.probe_kl for u, p in profiles.items()},
           "qerr": {u: p.qerr for u, p in profiles.items()},
           "profile_s": t1 - t0, "plan_s": t2 - t1,
           "peak_bytes": peak, "peak_over_params_bytes": peak - before,
           "launches": plan_counts, "json_round_trip": True}
    del profiles, plan, again

    fixed = _fixed_plan(cfg, base)
    counts = {}
    with torch.inference_mode():
        # the main path: Engine(plan=) quantizes the raw tree at load, then
        # a generate whose first decode step captures the step
        _reset_counts()
        t0 = time.perf_counter()
        engine = Engine(params, cfg, max_seq_len=PROMPT + NEW_TOKENS, plan=fixed, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load = _counts()
        require(load == {**dict.fromkeys(_COUNT_KEYS, 0), "pack": b1_step},
                f"Engine(plan=) quantized with {load}, want {b1_step} quantize_pack launches")
        qparams = engine.params
        _reset_counts()
        with _capture_guard(torch) as syncs:
            tokens = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        gen = _counts()
        require(not syncs, f"the plan's captured step syncs with the host: {syncs[:5]}")
        require(gen["gemv"] == gen["gemv_tc"] == 1 + NEW_TOKENS * b1_step
                and gen["gemv_simt"] == 0 and gen["attn"] == NEW_TOKENS * b2_step
                and gen["kv"] == 0 and gen["gemm"] == (b1_step - 1),
                f"Engine(plan=) generate launched {gen}")
        eager, eager_ms = _eager_generate(torch, qparams, cfg, prompts)
        require(torch.equal(eager, tokens), "the plan's graph tokens differ from eager ones")
        _reset_counts()
        engine._graphs[BATCH].step.replay()
        torch.cuda.synchronize()
        replay = _counts()
        require(replay == step_counts, f"one replay of the plan's step launched {replay}")
        # the step's device time alone, replayed from a graph of its own
        _, caches = lm.prefill(qparams, prompts, cfg, cache_len=PROMPT + NEW_TOKENS)
        step_device_ms = _time_ms(
            torch, lambda: lm.decode_step(qparams, tokens[:, 0], caches, PROMPT, cfg), 5)
        del caches
        modes = _mode_gap(torch, qparams, cfg, prompts)
        del engine
        counts["engine"] = {k: load[k] + gen[k] for k in _COUNT_KEYS}
        out["engine"] = {"load_s": load_s, "launches_load": load, "launches": gen,
                         "launches_per_replay": replay, "graph_tokens_equal_eager": True,
                         "host_syncs_in_captured_step": len(syncs),
                         "decode_ms_per_step_eager": eager_ms,
                         "decode_step_device_ms": step_device_ms, "modes": modes}
        del qparams
        torch.cuda.empty_cache()

        # Server(plan=) on the slot pool, logits kept: each request against
        # the Engine's step at batch 1
        Checked = _checked_server(torch)
        _reset_counts()
        with _capture_guard(torch) as syncs:
            srv = Checked(params, cfg, num_slots=SERVER_SLOTS, max_seq_len=cache_len, plan=fixed,
                          device=dev)
            ids, plain, wall, _ = _drive_server(torch, srv, reqs)
        counts["server"] = _counts()
        require(not syncs, f"the plan Server's captured step syncs with the host: {syncs[:5]}")
        require(counts["server"]["gemv"] == counts["server"]["gemv_tc"]
                and counts["server"]["gemv_simt"] == 0 and counts["server"]["kv"] == 0,
                f"the plan Server launched {counts['server']}")
        _reset_counts()
        srv._graph.replay()
        torch.cuda.synchronize()
        require(_counts() == step_counts, f"one replay of the plan Server launched {_counts()}")
        worst, ties, first_ties = _teacher_forced(torch, srv.params, cfg, reqs, plain,
                                                  [srv.kept[i] for i in ids], cache_len)
        n_tokens = sum(len(t) for t in plain)
        del srv
        torch.cuda.empty_cache()

        # the same traffic with the kv probe on: the same tokens
        tel = Telemetry(kv_probe_every=PLAN_KV_PROBE_EVERY)
        _reset_counts()
        srv = Server(params, cfg, num_slots=SERVER_SLOTS, max_seq_len=cache_len, plan=fixed,
                     telemetry=tel, device=dev)
        _, probed, _, _ = _drive_server(torch, srv, reqs)
        counts["probe"] = _counts()
        del srv
        reg = tel.registry
        require(probed == plain, "the kv probe changed tokens: "
                f"{sum(a != b for a, b in zip(probed, plain))} requests differ")
        qmax = reg.gauge("kv_append_qerr_max").value
        qrms = reg.gauge("kv_append_qerr_rms").value
        probe_rows = reg.counter("kv_probe_rows_total").value
        require(math.isfinite(qmax) and qmax > 0 and 0 < qrms <= qmax,
                f"kv probe gauges max {qmax}, rms {qrms}")
        bits = {k.split("=", 1)[1]: v["value"]
                for k, v in reg.as_dict()["quant_unit_bits"].items()}
        require(set(bits) == set(fixed.assignments)
                and all((bits[u] == 16.0) == (a["bits"] >= 16) for u, a in fixed.assignments.items()),
                f"quant_unit_bits {bits}")

        # pages of PAGE_SIZE: the slot pool's tokens
        _reset_counts()
        with _capture_guard(torch) as syncs_p:
            srv = Server(params, cfg, num_slots=SERVER_SLOTS, max_seq_len=cache_len, plan=fixed,
                         paged=True, page_size=PAGE_SIZE, device=dev)
            _, paged, paged_wall, _ = _drive_server(torch, srv, reqs)
        counts["paged"] = _counts()
        del srv
        require(not syncs_p, f"the plan's paged step syncs with the host: {syncs_p[:5]}")
        require(paged == plain, "paged tokens differ from the slot pool's under the plan: "
                f"{sum(a != b for a, b in zip(paged, plain))} requests differ")
    del params
    torch.cuda.empty_cache()
    out["server"] = {"requests": SERVER_REQUESTS, "tokens": n_tokens, "serve_s": wall,
                     "tokens_per_s": n_tokens / wall, "paged_tokens_per_s": n_tokens / paged_wall,
                     "paged_tokens_identical": True, "probe_tokens_identical": True,
                     "engine_b1_max_logit_gap": worst, "engine_b1_logit_tol": SERVER_LOGIT_TOL,
                     "engine_b1_greedy_near_ties": ties,
                     "engine_b1_first_token_near_ties": first_ties,
                     "host_syncs_in_captured_step": len(syncs) + len(syncs_p),
                     "kv_probe_every": PLAN_KV_PROBE_EVERY, "kv_append_qerr_max": qmax,
                     "kv_append_qerr_rms": qrms, "kv_probe_rows": probe_rows,
                     "quant_unit_bits": bits, "launches": counts}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "plan", "arch": ARCH, "depth": cfg.n_layers, "width": cfg.d_model,
          "kv_bits": cfg.kv_bits, "probe_tokens": list(probe.shape),
          "probe_vocab": PROBE_VOCAB, "fixed_plan": FIXED_PLAN_BITS, **out})
    total = dict(plan_counts)
    for c in counts.values():
        for k in _COUNT_KEYS:
            total[k] += c[k]
    run["plan_counts"] = total
    return out



def _time_graph(torch, graph, reps: int) -> float:
    """Median device time of reps replays of a captured graph (CUDA events)."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _teacher_forced(torch, qparams, cfg, reqs, tokens, kept, cache_len):
    """Each request alone (batch 1) through the Engine's path: a prefill at
    its exact length, then the decode step (lm.decode_step over a cache of
    the pool's length, captured once and replayed) fed the Server's tokens.
    Returns the largest logit gap to the Server's kept logits (gated at
    SERVER_LOGIT_TOL) and how many greedy tokens, decode and first, differ
    from the Server's; each must be a near-tie within SERVER_LOGIT_TOL."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import capture_graph

    dev = qparams["embed"].device
    caches = lm.init_caches(cfg, 1, cache_len, device=dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    box = {}

    def body():
        logits, _ = lm.decode_step(qparams, tok, caches, pos, cfg)
        if "out" not in box:
            box["out"] = torch.empty_like(logits)   # allocated by the warm-up call
        box["out"].copy_(logits)
        pos.add_(1)

    graph = capture_graph(body, dev)
    worst, ties, first_ties = 0.0, 0, 0
    for r, toks, rows in zip(reqs, tokens, kept):
        prompt = torch.as_tensor(r["prompt"], device=dev)[None]
        logits, cc = lm.prefill(qparams, prompt, cfg, cache_len=cache_len)
        first = logits[0].float()
        top = int(first.argmax())
        if top != toks[0]:
            margin = float(first[top] - first[toks[0]])
            require(margin <= SERVER_LOGIT_TOL,
                    f"first token {toks[0]} against the Engine's {top}: margin {margin}")
            first_ties += 1
        for mine, theirs in zip(caches, cc):
            for key in mine:
                mine[key].copy_(theirs[key])
        pos.fill_(prompt.shape[1])
        require(len(rows) == len(toks) - 1, f"{len(rows)} kept steps for {len(toks)} tokens")
        eng = []
        for t in toks[:-1]:
            tok.fill_(t)
            graph.replay()
            eng.append(box["out"][0].float())
        if not eng:
            continue
        eng = torch.stack(eng)
        srv = torch.stack(rows).float()
        worst = max(worst, float((eng - srv).abs().max()))
        nxt = torch.tensor(toks[1:], device=dev)
        arg = eng.argmax(-1)
        diff = arg != nxt
        if bool(diff.any()):
            idx = torch.arange(len(nxt), device=dev)
            margins = (eng[idx, arg] - eng[idx, nxt])[diff]
            require(float(margins.max()) <= SERVER_LOGIT_TOL,
                    f"a greedy token differs from the Engine's by a margin of "
                    f"{float(margins.max())}")
            ties += int(diff.sum())
    require(worst <= SERVER_LOGIT_TOL,
            f"Server vs per-request Engine logit gap {worst} > {SERVER_LOGIT_TOL}")
    del graph
    return worst, ties, first_ties


def _mode_gap(torch, qparams, cfg, prompts) -> dict:
    """Teacher-forced logits of the prompts, fused kernel vs dequant_einsum,
    gated at MODE_GAP_TOL."""
    from repro_torch.models import lm

    out = {}
    with torch.inference_mode():
        for mode in ("fused", "dequant_einsum"):
            c = cfg.with_matmul_mode(mode)
            h, _ = lm.backbone_seq(qparams, prompts, c)
            out[mode] = lm.logits_from_hidden(qparams, h, c).float()
    gap = float((out["fused"] - out["dequant_einsum"]).abs().max())
    require(bool(torch.isfinite(out["fused"]).all()), "non-finite fused logits")
    require(gap <= MODE_GAP_TOL, f"fused vs dequant_einsum logit gap {gap} > {MODE_GAP_TOL}")
    return {"max_abs_logit_gap": gap, "gate": MODE_GAP_TOL,
            "max_abs_logit": float(out["fused"].abs().max()),
            "argmax_agreement": float((out["fused"].argmax(-1) == out["dequant_einsum"].argmax(-1))
                                      .float().mean())}


def mode_parity(torch, dev, run) -> float:
    """Phase 4: teacher-forced logits, fused kernel vs dequant_einsum."""
    res = _mode_gap(torch, run["qparams"], run["cfg"], run["prompts"])
    emit({"phase": "modes", **res})
    return res["max_abs_logit_gap"]


def kv_tolerance(torch, dev) -> dict:
    """Phase 5: the reference's stated KV tolerance on tiny-650k."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import lm
    from repro_torch.models.quantize import quantize_params
    from repro_torch.serving import KV_LOGIT_TOL, kv_oracle_logit_gap

    cfg = get_arch("tiny-650k")
    params = quantize_params(lm.init_params(cfg, seed=SEED, device=dev),
                             QuantConfig(bits=4), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 10), generator=_gen(torch, dev, SEED + 3),
                            device=dev)
    gaps = {}
    for bits in (8, 4):
        before = _counts()["attn"]
        gap, agree = kv_oracle_logit_gap(params, cfg.with_kv_quant(bits), prompts, 8, device=dev)
        require(_counts()["attn"] > before, "fused decode attention not in the loop")
        require(gap <= KV_LOGIT_TOL[bits], f"kv{bits} logit gap {gap} > {KV_LOGIT_TOL[bits]}")
        gaps[bits] = {"gap": gap, "greedy_agreement": agree, "tol": KV_LOGIT_TOL[bits]}
    emit({"phase": "kv_tol", "arch": "tiny-650k", "weights": "4-bit float b64", "kv": gaps})
    return gaps


def paper_path(torch, dev) -> dict:
    """Phase 6: the paper's sweep on the card, through the port's own entry
    points: train the tiny ladder, then fig2, fig3 data types and fig3 block
    sizes on it (every encode through the kernel, every quantized matmul
    through the fused GEMM)."""
    import math

    from repro_torch.data.synthetic import ZipfMarkov
    from repro_torch.paper import common, fig2_bitlevel, fig3_blocksize, fig3_datatypes

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    # a fresh cache: this phase trains, never reads a ladder an earlier run left
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build"))
    _reset_counts()
    t0 = time.perf_counter()
    family = common.trained_family(log=log, device=dev, cache_dir=cache_dir)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with flat_encodes() as flat:
        _, fig2 = fig2_bitlevel.run(family, log=log)
        _, ranking = fig3_datatypes.run(family, log=log)
        _, block_effect = fig3_blocksize.run(family, log=log)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    require(len(flat) == counts["b3"], f"{len(flat)} flat encodes recorded, {counts['b3']} "
            f"launched")

    models = {}
    for name, t in family.items():
        models[name] = {"first_loss": t.history[0], "last_loss": t.history[-1],
                        "steps": len(t.history),
                        "entropy_floor": ZipfMarkov(t.cfg.vocab_size, device=dev).entropy_floor()}
        require(all(math.isfinite(v) for v in t.history), f"{name}: non-finite training loss")
        require(t.history[-1] <= t.history[0] - MIN_LOSS_DROP,
                f"{name}: loss {t.history[0]} -> {t.history[-1]}, not {MIN_LOSS_DROP} nat lower")
    ppl = {}
    for o in fig2["observations"]:
        ppl.setdefault(o["model"], {})[o["precision"]] = math.exp(o["log_ppl"])
    for name, by_k in ppl.items():
        require(all(math.isfinite(v) for v in by_k.values()), f"{name}: non-finite perplexity")
        rel = abs(by_k[8] / by_k[16] - 1.0)
        require(rel <= PPL_K8_REL_TOL, f"{name}: 8-bit perplexity {by_k[8]} is {rel:.4f} "
                                        f"off 16-bit {by_k[16]}")
    require(counts["pack"] > 0 and counts["gemm"] > 0,
            f"the sweep did not run through the encode kernel and the fused GEMM: {counts}")
    emit({"phase": "paper", "recipe": common.TRAIN_RECIPE, "models": models,
          "fig2_ppl": ppl, "fig2_optimal_precision": fig2["optimal_precision"],
          "fig2_wins": fig2["wins"], "fig3dt_ranking": ranking,
          "fig3bs_mean_degradation": block_effect, "launches": counts,
          "train_s": t1 - t0, "sweep_s": t2 - t1, "seconds": t2 - t0,
          "gates": {"min_loss_drop_nats": MIN_LOSS_DROP, "ppl_k8_rel": PPL_K8_REL_TOL}})
    return {"launches": counts, "sweep_s": t2 - t1, "flat_items": flat, "family": family,
            "cache_dir": cache_dir, "train_s": t1 - t0}


# GPTQ in float64 on the card against the same on the CPU: the inverse and
# the Cholesky factor come from other libraries, ~1e-16 apart; a weight
# would have to lie that close to a rounding midpoint to flip its code
GPTQ_CARD_REL_TOL = 1e-12
# bits_report against the accounting recomputed from the matrices' shapes
BITS_REL_TOL = 1e-12


def _expected_bits(params, qcfg) -> float:
    """Average bits per parameter of ``params`` under ``qcfg`` by the paper's
    accounting, from the tree's shapes alone: every stacked matrix {"w":
    [..., In, Out]} pays quantized_bits_per_param with its own outlier
    share p = max(1, round(In * pct)) / In, everything else 16 bits."""
    from repro_torch.core.bits import quantized_bits_per_param

    q_bits = n = 0.0

    def walk(tree, key=None):
        nonlocal q_bits, n
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        else:
            numel = tree.numel()
            n += numel
            if key == "w" and tree.ndim >= 2:
                d = tree.shape[-2]
                n_out = max(1, round(d * qcfg.outlier_pct)) if qcfg.outlier_pct > 0 else 0
                q_bits += numel * quantized_bits_per_param(
                    qcfg.bits, qcfg.block_size, centering=qcfg.centering,
                    outlier_pct=n_out / d).ideal_bits_per_param
            else:
                q_bits += numel * 16.0

    walk(params)
    return q_bits / n


class _RouteLog:
    """While open, wraps ``paper.common``'s quantize_params and perplexity
    (what its evaluate_quant calls) to record, per evaluation, the
    configuration, the encode's and the evaluation's launch counts, the
    quantized tree's bits_report and the accounting of ``_expected_bits``."""

    def __enter__(self):
        from repro_torch.core.qtensor import QuantizedTensor
        from repro_torch.models.quantize import bits_report
        from repro_torch.paper import common
        from repro_torch.tree import leaves

        self.common, self.events, pending = common, [], {}
        self.real_q, self.real_p = common.quantize_params, common.perplexity

        def quantize(params, qcfg, cfg, **kw):
            c0 = _counts()
            qp = self.real_q(params, qcfg, cfg, **kw)
            c1 = _counts()
            qts = [x for x in leaves(qp) if isinstance(x, QuantizedTensor)]
            pending.update(
                qcfg=qcfg, model=cfg.name, encode={k: c1[k] - c0[k] for k in c1},
                items=sum(math.prod(q.batch_shape) for q in qts),
                structured=any(q.structured for q in qts),
                bits=bits_report(qp)["avg_bits_per_param"],
                expected_bits=_expected_bits(params, qcfg))
            return qp

        def perplexity(params, cfg, toks, **kw):
            c0 = _counts()
            ppl = self.real_p(params, cfg, toks, **kw)
            c1 = _counts()
            ev = dict(pending) if pending else {"qcfg": None, "model": cfg.name}
            pending.clear()
            ev.update(ppl=ppl, eval={k: c1[k] - c0[k] for k in c1})
            self.events.append(ev)
            return ppl

        common.quantize_params, common.perplexity = quantize, perplexity
        return self.events

    def __exit__(self, *exc):
        self.common.quantize_params, self.common.perplexity = self.real_q, self.real_p
        return False


def _check_routes(events) -> dict:
    """Gate each recorded evaluation's route and bits; returns counts of the
    evaluations by kind."""
    kinds = {"proxy": 0, "centered": 0, "plain": 0, "dense": 0}
    for ev in events:
        q = ev["qcfg"]
        what = f"{ev['model']} {q.describe() if q else 'dense'}"
        require(math.isfinite(ev["ppl"]), f"{what}: non-finite perplexity {ev['ppl']}")
        fused = ev["eval"]["gemv"] + ev["eval"]["gemm"]
        if q is None:
            kinds["dense"] += 1
            require(fused == 0, f"{what}: a dense evaluation launched {fused} fused matmuls")
            continue
        require(abs(ev["bits"] / ev["expected_bits"] - 1) <= BITS_REL_TOL,
                f"{what}: bits_report {ev['bits']} != accounting {ev['expected_bits']}")
        enc = ev["encode"]
        if q.outlier_pct > 0 or q.centering:
            require(fused == 0, f"{what}: {fused} fused GEMM/GEMV launches on means or "
                                f"outliers (dequant_einsum expected)")
        if q.centering:
            kinds["centered"] += 1
            require(enc["b3"] >= ev["items"] and enc["pack"] == 0,
                    f"{what}: centered encode {enc} for {ev['items']} items")
        elif q.outlier_pct > 0:
            kinds["proxy"] += 1
            require(enc["pack"] == ev["items"] and enc["b3"] == 0,
                    f"{what}: proxy encode {enc} for {ev['items']} items")
        else:
            kinds["plain"] += 1
            require((ev["eval"]["gemm"] > 0) == ev["structured"],
                    f"{what}: {ev['eval']['gemm']} GEMM launches, row-structured "
                    f"matrices: {ev['structured']}")
    return kinds


def paper_rest(torch, dev, paper) -> dict:
    """Phase 6b: fig4, appb and table1 on phase 6's ladder, restored from its
    checkpoint cache, through the port's entry points."""
    from repro_torch.core import gptq
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.models.layers import norm
    from repro_torch.paper import appb_centering, common, fig4_proxy, table1_gptq
    from repro_torch.tree import leaves

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    trained = paper["family"]
    # the cache round trip: every model restored, bit for bit, with its losses
    lines = []
    t0 = time.perf_counter()
    family = common.trained_family(log=lines.append, device=dev, cache_dir=paper["cache_dir"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(all(line.startswith("[cache]") for line in lines) and len(lines) == len(trained),
            f"the ladder was not restored from the cache: {lines}")
    for name, t in trained.items():
        a, b = leaves(t.params), leaves(family[name].params)
        require(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y) for x, y in zip(a, b)),
            f"{name}: restored parameters differ from the trained ones")
        require(family[name].history == t.history, f"{name}: restored loss history differs")

    _reset_counts()
    seconds = {}
    with _RouteLog() as events:
        t0 = time.perf_counter()
        _, fig4 = fig4_proxy.run(family, log=log)
        torch.cuda.synchronize()
        seconds["fig4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, appb = appb_centering.run(family, log=log)
        torch.cuda.synchronize()
        seconds["appb"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, table1 = table1_gptq.run(family, log=log)
        torch.cuda.synchronize()
        seconds["table1"] = time.perf_counter() - t0
    counts = _counts()
    kinds = _check_routes(events)
    require(kinds["proxy"] == 2 * len(family) and kinds["centered"] == 2 * len(family),
            f"evaluations by kind: {kinds}")
    for name, entry in table1.items():
        vals = [v for bs in table1_gptq.BLOCKS for v in entry[bs].values()]
        require(all(math.isfinite(v) for v in vals + [entry["gptq3_noblock"]]),
                f"table1 {name}: non-finite perplexity {entry}")

    # one GPTQ matrix of tiny-650k on the card and on the CPU, the same inputs
    t = family["tiny-650k"]
    calib = common.eval_tokens(t.cfg, n_seqs=8, seed=777, device=dev)[:, :128]
    layer0 = {k: v[0] for k, v in t.params["stack"][0]["mixer_norm"].items()}
    h = norm(layer0, t.params["embed"].to(torch.bfloat16)[calib], t.cfg.norm_type)
    w = t.params["stack"][0]["mixer"]["wq"]["w"][0]
    H = gptq.hessian_from_inputs(h.to(torch.float32).reshape(-1, w.shape[0]))
    cb = make_codebook("int", 2, device=dev)
    t0 = time.perf_counter()
    q_card = gptq.gptq_quantize(w, H, cb, block_size=64)
    torch.cuda.synchronize()
    gptq_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_cpu = gptq.gptq_quantize(w.cpu(), H.cpu(), cb.cpu(), block_size=64)
    gptq_cpu_s = time.perf_counter() - t0
    gptq_rel = float((q_card.cpu() - q_cpu).abs().max() / q_cpu.abs().max())
    require(gptq_rel <= GPTQ_CARD_REL_TOL,
            f"GPTQ on the card is {gptq_rel:.3e} off the CPU's (> {GPTQ_CARD_REL_TOL})")

    emit({"phase": "paper_rest", "models": sorted(family),
          "fig4_proxy_helps_3bit_frac": fig4["proxy_helps_3bit_frac"],
          "fig4_proxy3bit_beats_4bit_frac": fig4["proxy3bit_beats_4bit_frac"],
          "fig4_ppl": fig4["ppl"], "fig4_bits": fig4["bits"],
          "appb_mean_logppl_delta": appb["mean_delta"], "appb": appb["models"],
          "table1": table1, "seconds": seconds, "evaluations": kinds, "launches": counts,
          "cache": {"train_s": paper["train_s"], "restore_s": restore_s},
          "gptq_card_vs_cpu_rel": gptq_rel,
          "gptq_matrix": {"model": "tiny-650k", "unit": "stack/0/mixer/wq", "layer": 0,
                          "shape": list(w.shape), "bits": 2, "block": 64,
                          "card_s": gptq_card_s, "cpu_s": gptq_cpu_s},
          "gates": {"gptq_card_rel": GPTQ_CARD_REL_TOL, "bits_rel": BITS_REL_TOL}})
    return {"launches": counts}


def plan_suites(torch, dev, paper) -> dict:
    """Phase 6c: ``paper.run --only figmix,plan`` on phase 6's ladder,
    restored from its checkpoint cache (the frontier; the gates and the
    plans at random init), every gate row ok=1; then the serving launcher
    as a subprocess on the card, serving the plan suite's tiny-2.6m JSON with
    the kv probe and both telemetry sinks: exit 0, a trace that validates,
    quant_unit_bits for every unit of the plan."""
    import contextlib
    import io
    import os
    import shutil

    from repro_torch.paper import run as paper_run
    from repro_torch.precision import PrecisionPlan
    from repro_torch.serving.trace import validate_jsonl

    rows_out, logs = io.StringIO(), io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(rows_out), contextlib.redirect_stderr(logs):
        paper_run.main(["--only", "figmix,plan", "--cache-dir", str(paper["cache_dir"])])
    torch.cuda.synchronize()
    suites_s = time.perf_counter() - t0
    counts = _counts()
    shutil.rmtree(paper["cache_dir"], ignore_errors=True)
    print(logs.getvalue(), file=sys.stderr, flush=True)
    cached = [ln for ln in logs.getvalue().splitlines() if ln.startswith("[cache]")]
    require(len(cached) == len(paper["family"]),
            f"figmix did not restore the ladder from the cache: {cached}")
    rows = {name: derived for name, _, derived in
            (ln.split(",", 2) for ln in rows_out.getvalue().splitlines()[1:])}
    gates = {n: d for n, d in rows.items() if n.startswith("figmix/gate/")}
    require(len(gates) == 2 and all(d.endswith("ok=1") for d in gates.values()),
            f"figmix gate rows {gates}")
    plan_file = ROOT / "artifacts" / "plans" / f"{LAUNCH_ARCH}.json"
    plan = PrecisionPlan.load(plan_file)

    out_dir = ROOT / "build" / "launch"
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics, trace = out_dir / "metrics.prom", out_dir / "trace.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LAUNCH_ARCH,
           "--plan", str(plan_file), "--kv-bits", "4", "--num-requests", str(LAUNCH_REQUESTS),
           "--max-new", str(LAUNCH_MAX_NEW), "--metrics-out", str(metrics),
           "--trace-out", str(trace), "--kv-probe-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    launch_s = time.perf_counter() - t0
    print(res.stdout, res.stderr[-4000:], sep="\n", file=sys.stderr, flush=True)
    require(res.returncode == 0, f"launch/serve.py exited {res.returncode}: {res.stderr[-2000:]}")
    stats = validate_jsonl(trace)
    require(stats["requests"] == LAUNCH_REQUESTS, f"the launcher's trace: {stats}")
    prom = metrics.read_text()
    missing = [u for u in plan.assignments if f'quant_unit_bits{{unit="{u}"}}' not in prom]
    require(not missing, f"the launcher's metrics lack quant_unit_bits for {missing}")
    require("kv_append_qerr_max" in prom, "the launcher's metrics lack the kv probe")
    served = [ln for ln in res.stdout.splitlines() if ln.startswith(("quantized", "served"))]
    emit({"phase": "plan_suites", "suites_s": suites_s, "rows": rows, "launches": counts,
          "launch": {"cmd": cmd[1:], "exit": res.returncode, "seconds": launch_s,
                     "trace": stats, "stdout": served,
                     "plan": {u: a["bits"] for u, a in plan.assignments.items()}}})
    return {"launches": counts, "seconds": suites_s + launch_s}



def bench_path(torch, dev) -> dict:
    """Phase 6a: paper/kernel_bench.py on the card through its entry point,
    gate=False as the suite runner calls it, with its kernel smoke.  Each of
    its fused calls must be one launch of the f32 GEMV (qmatmul_gemv_simt)
    and no other kernel, each dequant_einsum call none, and the smoke within
    its 2e-5 (kernel_bench asserts it)."""
    from repro_torch.paper import kernel_bench as kb

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    real, calls = kb.linear, []

    def counted(x, w, bias=None, *, mode="dequant_einsum"):
        before = _counts()
        y = real(x, w, bias, mode=mode)
        after = _counts()
        calls.append((mode, {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        return y

    _reset_counts()
    kb.linear = counted
    t0 = time.perf_counter()
    try:
        rows, out = kb.run(log=log, smoke=True, gate=False, device=dev)
    finally:
        kb.linear = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    fused = [d for mode, d in calls if mode == "fused"]
    # a warm-up and 30 timed calls a weight at least (common.timed_robust)
    require(len(fused) >= 31 * len(kb.TAGS)
            and all(d == {"gemv": 1, "gemv_simt": 1} for d in fused),
            f"kernel_bench's fused calls are not one qmatmul_gemv_simt launch each: "
            f"{[d for d in fused if d != {'gemv': 1, 'gemv_simt': 1}][:3]}")
    require(all(not d for mode, d in calls if mode != "fused"),
            "a dequant_einsum call of kernel_bench launched a GEMV")
    require(counts["gemv_simt"] == len(fused) + 1 and counts["gemv_tc"] == 0,
            f"kernel_bench (and its smoke) launched {counts}")
    names = [r[0] for r in rows]
    tags = [f"{dt}{b}" for b, dt in kb.TAGS]
    require(names == ["kernel/dense_f32"] + [f"kernel/{k}_{t}" for t in tags
                                             for k in ("dequant_einsum", "fused")]
            + ["kernel/cuda_kernel_smoke"], f"kernel_bench's rows: {names}")
    smoke = out["kernel_smoke"]
    require(smoke["ok"] and smoke["rel_err"] < kb.SMOKE_REL_TOL,
            f"kernel_bench's kernel smoke: {smoke}")
    emit({"phase": "bench", "shape": out["shape"], "weights_block": 64,
          "us_per_call": {r[0]: r[1] for r in rows},
          "speedup": {t: out["fused"][t]["speedup"] for t in tags},
          "kernel_smoke": smoke, "fused_calls": len(fused), "launches": counts,
          "seconds": seconds, "meta": out["meta"]})
    return {"launches": counts, "out": out}


#: the ledger phase's full-width sweep: Qwen2-7B through serve_bench.run
LEDGER_FULL = dict(num_slots=8, n_requests=24, rate=4.0, max_new_range=(8, 48), seed=0,
                   kv_gate="tokens")
#: the reference's committed weight bytes (BENCH_KERNELS.json)
LEDGER_WEIGHT_BYTES = {"float4": 2228224, "int4": 2228224, "int3": 1808793, "int8": 4325376}


def _bench_diff(baseline, new, report) -> int:
    """The port's bench_diff CLI on two ledgers, its report on stderr and
    in ``report``; returns its exit code."""
    import contextlib

    from repro_torch.paper import bench_diff

    with contextlib.redirect_stdout(sys.stderr):
        return bench_diff.main(["--baseline", str(baseline), "--new", str(new),
                                "--report", str(report)])


def ledger_path(torch, dev, run, bench) -> dict:
    """Phase 6e: the bench tooling on the card (see the module docstring).
    Returns the launches of its serves."""
    from repro_torch.paper import ledger, serve_bench
    from repro_torch.serving import KV_LOGIT_TOL

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "ledger"
    _reset_counts()
    _, recs = ledger.run(log=log, device=dev, kernel_out=bench["out"])
    rcs = {suite: _bench_diff(base, ledger.candidate_path(suite), out_dir / f"{suite}.txt")
           for suite, base in (("serve", ledger.REFERENCE_SERVE_LEDGER),
                               ("kernels", ledger.REFERENCE_KERNEL_LEDGER))}
    require(rcs == {"serve": 0, "kernels": 0},
            f"bench_diff against the reference's ledgers exited {rcs}: "
            + " | ".join((out_dir / f"{s}.txt").read_text()[-600:] for s in rcs if rcs[s]))
    series = recs["serve"]["series"]
    kseries = recs["kernels"]["series"]
    weight_bytes = {t: kseries[f"kernel.{t}_weight_bytes"]["value"] for t in LEDGER_WEIGHT_BYTES}
    require(weight_bytes == LEDGER_WEIGHT_BYTES, f"weight bytes {weight_bytes}")
    # the pinned serve record again, in this process: the same virtual series
    second = ledger.serve_record(log, device=dev)
    pinned_counts = _counts()

    def virtual(rec):
        return {k: v["value"] for k, v in rec["series"].items() if v["clock"] == "virtual"}

    require(virtual(second) == virtual(recs["serve"]),
            f"the pinned serve record's virtual series differ between two runs: "
            f"{virtual(recs['serve'])} vs {virtual(second)}")
    again = out_dir / "BENCH_SERVE.again.json"
    ledger.write(again, "serve", [second])
    rc_again = _bench_diff(ledger.candidate_path("serve"), again, out_dir / "again.txt")
    require(rc_again == 0, f"bench_diff of two pinned serve runs exited {rc_again}")
    pinned_s = time.perf_counter() - t0

    # full width: Qwen2-7B's tree from the serve phase
    _reset_counts()
    t1 = time.perf_counter()
    _, stats = serve_bench.run(log, arch=ARCH, params=run["qparams"], device=dev,
                               **LEDGER_FULL)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t1
    full_counts = _counts()
    require(stats["kv4_ratio"] >= 3.0, f"kv4 cut KV bytes {stats['kv4_ratio']}x")
    require(full_counts["gemv_tc"] > 0 and full_counts["gemm"] > 0 and full_counts["attn"] > 0,
            f"Qwen2-7B's sweep launched {full_counts}")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    per_kv = {f"kv{b}": {"tokens_per_s": stats[f"tok_s_kv{b}"],
                         "ttft_p50_ms": stats[f"kv{b}_ttft_p50_ms"],
                         "ttft_p99_ms": stats[f"kv{b}_ttft_p99_ms"],
                         "itl_p50_ms": stats[f"kv{b}_itl_p50_ms"],
                         "itl_p99_ms": stats[f"kv{b}_itl_p99_ms"],
                         "batch_fill": stats[f"kv{b}_batch_fill"],
                         "engine_steps": stats[f"kv{b}_steps"],
                         "kv_mb": stats[f"kv{b}_mb"]}
              for b in (16, 8, 4)}
    for b in (8, 4):
        require(stats[f"kv{b}_static_equals_continuous"],
                f"kv{b}: static and continuous tokens not compared")
        per_kv[f"kv{b}"].update(bytes_ratio=stats[f"kv{b}_ratio"],
                                logit_gap=stats[f"kv{b}_logit_gap"],
                                oracle_greedy_agree=stats[f"kv{b}_greedy_agree"],
                                logit_tol=KV_LOGIT_TOL[b], gate=stats[f"kv{b}_gate"],
                                static_equals_continuous=True)
    emit({"phase": "ledger", "seconds": time.perf_counter() - t0,
          "pinned": {"seconds": pinned_s, "bench_diff_rc": {**rcs, "second_run": rc_again},
                     "virtual": virtual(recs["serve"]), "weight_bytes": weight_bytes,
                     "bytes_vs_bf16": {t: kseries[f"kernel.{t}_bytes_vs_bf16"]["value"]
                                       for t in LEDGER_WEIGHT_BYTES},
                     "wall": {k: v["value"] for k, v in series.items()
                              if v["clock"] == "wall"},
                     "launches": pinned_counts},
          "full_width": {"arch": ARCH, "weights": "4-bit float b64", **LEDGER_FULL,
                         "seconds": full_s, "static_equals_continuous_kv16": True,
                         "tokens_per_s_static": stats["tok_s_static"],
                         "speedup": stats["speedup"], "per_kv": per_kv,
                         "launches": full_counts},
          "card": smi, "diff_reports": str(out_dir)})
    return {k: pinned_counts[k] + full_counts[k] for k in _COUNT_KEYS}


class flat_encodes:
    """Records (x_blocks, codebook) of every flat-item encode on the card
    (kernels/quantize.quantize_blocks, which core/blockwise.encode and
    kernels/ops call) while open; yields the list."""

    def __enter__(self):
        from repro_torch.kernels import quantize as quantk

        self.mod, self.real, self.items = quantk, quantk.quantize_blocks, []

        def record(x_blocks, codebook):
            if x_blocks.device.type == "cuda":
                self.items.append((x_blocks, codebook))
            return self.real(x_blocks, codebook)

        quantk.quantize_blocks = record
        return self.items

    def __exit__(self, *exc):
        self.mod.quantize_blocks = self.real
        return False


def flat_encode_run(torch, items, lib, takes_codebook=True):
    """The launches of `items` through the C entry quantize_blocks of `lib`
    (a build of csrc/quantize.cu), each the kernel alone: it takes the
    codebook, or (`takes_codebook` false: the first design's entry) the
    midpoints, computed beforehand."""
    from repro_torch.core.codebooks import codebook_boundaries

    calls = []
    for xb, cb in items:
        cb = cb.to(torch.float32).contiguous()
        table = cb if takes_codebook else codebook_boundaries(cb).contiguous()
        calls.append((xb, table, torch.empty(xb.shape, dtype=torch.int32, device=xb.device),
                      torch.empty(xb.shape[:1], dtype=torch.float32, device=xb.device)))

    def go():
        stream = torch.cuda.current_stream().cuda_stream
        for xb, table, codes, scales in calls:
            require(lib.quantize_blocks(xb.data_ptr(), table.data_ptr(), codes.data_ptr(),
                                        scales.data_ptr(), xb.shape[0], xb.shape[1],
                                        table.numel(), stream) == 0, "quantize_blocks launch")
    return go


def _time_ms(torch, fn, reps: int) -> float:
    """Device time of one call of fn (a sequence of launches): fn runs once,
    is captured in a CUDA graph, and the median of reps graph replays is
    taken by CUDA events.  Replaying the graph leaves the host's Python and
    launch overhead out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    torch.cuda.empty_cache()
    times.sort()
    return times[len(times) // 2]


def _bound(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _b1_calls(torch, dev, qparams, cfg, M, with_head, g):
    """One decode step's (with the lm_head) or one prefill's B1 launches over
    the model's quantized matrices, x of M random bf16 rows a K: [(x padded,
    packed, scales, operand, x)], the matrices, and the bytes (packed words,
    scales, codebook, x in and y out) and operations of the launches."""
    from repro_torch.models.blocks import take

    names = [("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
             ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
    stack = qparams["stack"][0]
    qts = [take(stack, i)[a][b]["w"] for i in range(cfg.n_layers) for a, b in names]
    qts += [qparams["lm_head"]] if with_head else []
    return _b1_launches(torch, dev, qts, M, g)


def _b1_launches(torch, dev, qts, M, g):
    """``_b1_calls``' launches over the matrices ``qts``."""
    from repro_torch.kernels import ops

    xs, calls = {}, []
    nbytes = flops = 0.0
    for qt in qts:
        op = ops.operand_from_qtensor(qt)
        N, K = qt.quant_shape
        if K not in xs:
            xs[K] = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xp, packed, scales = ops.pad_for_kernel(xs[K], op)
        calls.append((xp, packed, scales, op, xs[K]))
        nbytes += (packed.numel() * 4 + scales.numel() * 2 + op.codebook.numel() * 4
                   + M * K * 2 + M * N * 2)
        flops += 2.0 * M * N * K
    return calls, qts, nbytes, flops


def _pad_words(xp, packed, scales, op):
    """The operands with K padded to whole packed words and scale blocks
    (kernels/qmatmul.pad_k to lcm(cpw, B)): a copy of the weight at 3, 5 and
    6 bits, none at 4 bits, block 64."""
    from repro_torch.kernels import qmatmul as qk

    return qk.pad_k(xp, packed, scales, math.lcm(32 // op.bits, op.block_size), bits=op.bits,
                    block_size=op.block_size)


def _whole_words(calls):
    """The same launches with K padded to whole packed words beforehand
    (``_pad_words``), so that their times hold no copy of the weight."""
    return [(*_pad_words(xp, packed, scales, op), op, x) for xp, packed, scales, op, x in calls]


def _b1_run(calls, fn):
    """The launches of `calls` through fn (a qmatmul launcher)."""
    def go():
        for xp, packed, scales, op, _ in calls:
            fn(xp, packed, scales, op.codebook, bits=op.bits, block_size=op.block_size)
    return go


def _lib_run(torch, calls, dense):
    """torch.matmul of each call's x with its matrix dequantized (dense)."""
    def go():
        for (_, _, _, _, x), w in zip(calls, dense):
            torch.matmul(x, w.T)
    return go


def _time_step_gemvs(torch, dev, cfg, qparams, g) -> dict:
    """A decode step's GEMVs (BATCH rows, 197 launches) through the routed
    GEMV, the CUDA-core GEMV on the same operands, the plain version and
    torch.matmul on the bf16 weights."""
    from repro_torch.core.qtensor import dequantize_tensor
    from repro_torch.kernels import qmatmul as qk

    calls, qts, nbytes, flops = _b1_calls(torch, dev, qparams, cfg, BATCH, True, g)
    ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_gemv), 10)
    simt_ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_gemv_simt), 5)
    plain_ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_plain), 2)
    dense = [dequantize_tensor(qt, out_dtype=torch.bfloat16) for qt in qts]
    library_ms = _time_ms(torch, _lib_run(torch, calls, dense), 10)
    del calls, dense
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "cuda_core_gemv_ms": simt_ms, "bytes": nbytes,
            "per": f"decode step ({len(qts)} launches, M = {BATCH})"}


def _time_prefill_gemms(torch, dev, cfg, qparams, g) -> dict:
    """A prefill's GEMMs (BATCH * PROMPT bf16 rows, 196 launches) as the
    path runs them (rows as stored in; the launcher pads K to whole words,
    a copy of each weight at 3, 5 and 6 bits), beside the same launches on
    rows padded beforehand (no copy in the time) and that copy alone
    (``_pad_words`` over the 196 weights)."""
    from repro_torch.kernels import qmatmul as qk

    calls, _, _, _ = _b1_calls(torch, dev, qparams, cfg, BATCH * PROMPT, False, g)
    path_ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_gemm), 3)

    def copy():
        for xp, packed, scales, op, _ in calls:
            _pad_words(xp, packed, scales, op)

    copy_ms = _time_ms(torch, copy, 3)
    padded = _whole_words(calls)
    padded_ms = _time_ms(torch, _b1_run(padded, qk.qmatmul_gemm), 3)
    del calls, padded
    torch.cuda.empty_cache()
    return {"ms": path_ms, "padded_ms": padded_ms, "copy_ms": copy_ms,
            "per": f"prefill (196 launches, M = {BATCH * PROMPT})"}


def time_kernels(torch, dev, run, paper) -> dict:
    """Phase 7: the kernels at the main path's shapes, one decode step's and
    one prefill's worth of launches over the real quantized layers; the KV
    dequant also over a LONG_ROUTED-slot cache, and the flat encode also
    over the sweep's flat items."""
    from repro_torch.core.qtensor import dequantize_tensor
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels import quantize as quantk

    cfg, qparams, counts = run["cfg"], run["qparams"], run["counts"]
    g = _gen(torch, dev, SEED + 4)
    out = {}
    shapes_ms = {}
    rep_b1 = "src/repro/kernels/qmatmul.py:97"
    # the decode GEMV routes every serving operand to the tensor cores; the
    # CUDA-core GEMV (qmatmul_gemv_simt) is timed beside it on the same ones
    for name, src_b1, M, with_head, fn, old, reps in (
            ("qmatmul_gemv", "src/repro_torch/csrc/qgemv_sm90.cu", BATCH, True, qk.qmatmul_gemv,
             qk.qmatmul_gemv_simt, 10),
            ("qmatmul_gemm", "src/repro_torch/csrc/qgemm_sm90.cu", BATCH * PROMPT, False,
             qk.qmatmul_gemm, None, 3)):
        calls, qts, nbytes, flops = _b1_calls(torch, dev, qparams, cfg, M, with_head, g)
        ms = _time_ms(torch, _b1_run(calls, fn), reps)
        old_ms = _time_ms(torch, _b1_run(calls, old), reps) if old else None
        plain_ms = _time_ms(torch, _b1_run(calls, qk.qmatmul_plain), 2)
        dense = [dequantize_tensor(qt, out_dtype=torch.bfloat16) for qt in qts]
        library_ms = _time_ms(torch, _lib_run(torch, calls, dense), reps)
        bound_ms, bound_by = _bound(nbytes, flops)
        out[name] = {"source": src_b1, "replaces": rep_b1,
                     "launches": (counts["gemv_tc"] if name == "qmatmul_gemv"
                                  else counts["gemm"] - counts["gemm_simt"]),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "cuda_core_gemv_ms": old_ms,
                     "per": "decode step (197 launches)" if with_head
                     else "prefill (196 launches)", "M": M, "bytes": nbytes, "flops": flops}
        per_shape = shapes_ms.setdefault(f"{name}_M{M}", {})
        for K, N in sorted({(c[3].k_dim, c[1].shape[0]) for c in calls}):
            pick = [i for i, c in enumerate(calls) if c[3].k_dim == K and c[1].shape[0] == N]
            sub = [calls[i] for i in pick]
            sub_ms = _time_ms(torch, _b1_run(sub, fn), reps) / len(sub)
            sub_lib = _time_ms(torch, _lib_run(torch, sub, [dense[i] for i in pick]),
                               reps) / len(sub)
            sb = sub[0][1].numel() * 4 + sub[0][2].numel() * 2 + M * K * 2 + M * N * 2
            per_shape[f"{K}x{N}"] = {"ms_per_call": sub_ms, "library_ms_per_call": sub_lib,
                                     "bound_ms_per_call": _bound(sb, 2.0 * M * N * K)[0],
                                     "calls": len(sub)}
            if old:
                per_shape[f"{K}x{N}"]["cuda_core_gemv_ms_per_call"] = (
                    _time_ms(torch, _b1_run(sub, old), reps) / len(sub))
        del calls, dense
        torch.cuda.empty_cache()
    out["qmatmul_gemv_simt"] = _time_gemv_f32(torch, dev, cfg, qparams, counts["gemv_simt"], g)

    out["kv_dequant"] = _time_kv_dequant(torch, dev, cfg, counts["kv"], g)
    out["kv_decode_attention"] = _time_attention(torch, dev, cfg, counts["attn"], g)
    out["qgemm_simt"] = _time_gemm_simt(torch, dev, counts["gemm_simt"], g)
    out["quantize_blocks"], out["quantize_pack"], shapes_ms["encode_B64"] = _time_encode(
        torch, dev, cfg, counts, g)
    flat = paper["flat_items"]
    flat_ms = _time_ms(torch, flat_encode_run(torch, flat, quantk._lib()), 10)
    out["quantize_blocks"]["sweep_flat_items"] = {
        "launches": len(flat), "ms": flat_ms,
        "values": sum(xb.numel() for xb, _ in flat),
        "share_of_suites": flat_ms / (paper["sweep_s"] * 1e3), "suites_s": paper["sweep_s"],
        "blocks": sorted({xb.shape[1] for xb, _ in flat})}
    emit({"phase": "times", "card_rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                                           "bf16_flop_per_s": BF16_FLOP_PER_S,
                                           "f32_flop_per_s": F32_FLOP_PER_S},
          "kernels": out, "per_shape": shapes_ms,
          "library_note": {"qmatmul": "torch.matmul on the pre-dequantized weight",
                           "kv_dequant": "no single PyTorch call computes it",
                           "kv_decode_attention": "no single PyTorch call computes it",
                           "quantize": "no single PyTorch call computes either encode"}})
    return out


def _kv_layers(torch, dev, g, spec, B, S, feat, n):
    """n layers' packed K and V leaves of B x S random slots."""
    from repro_torch.kernels import kv_dequant as kvd

    out = []
    for _ in range(n):
        c = {}
        for name in ("k", "v"):
            x = torch.randn((B, S, feat), generator=g, device=dev).to(torch.bfloat16)
            c[f"{name}_packed"], c[f"{name}_scales"] = kvd.encode_rows(x, spec)
        out.append(c)
    return out


def _time_kv_dequant(torch, dev, cfg, launches, g) -> dict:
    """The KV dequant over one decode step's caches (one launch a layer for
    K and V) at the serve phase's slots, beside its plain version and the
    bytes bound, and at LONG_ROUTED slots, batch 1 (the route's long
    cache)."""
    from repro_torch.kernels import kv_dequant as kvd

    spec = kvd.kv_spec(cfg)
    feat = cfg.n_kv_heads * cfg.head_dim
    by_slots = {}
    for B, S in ((BATCH, PROMPT + NEW_TOKENS), (1, LONG_ROUTED)):
        layers = _kv_layers(torch, dev, g, spec, B, S, feat, cfg.n_layers)
        c0 = layers[0]
        nbytes = cfg.n_layers * (sum(t.numel() * t.element_size() for t in c0.values())
                                 + 2 * B * S * feat * 2 + 4 * 2 ** spec.bits)
        bound_ms, bound_by = _bound(nbytes, 0.0)
        by_slots[S] = {
            "batch": B, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": _time_ms(torch, lambda: [kvd.dequant_kv(c, spec, feat) for c in layers], 20)}
        if S != LONG_ROUTED:
            by_slots[S]["plain_ms"] = _time_ms(
                torch, lambda: [kvd.dequant_kv_plain(c, spec, feat) for c in layers], 5)
        del layers
        torch.cuda.empty_cache()
    main = by_slots[PROMPT + NEW_TOKENS]
    return {"source": "src/repro_torch/csrc/kv_dequant.cu",
            "replaces": "src/repro/kernels/kv_dequant.py:159", "launches": launches,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "per": f"a Qwen2-7B decode step's caches ({cfg.n_layers} launches, K and V in "
                   f"one, {PROMPT + NEW_TOKENS} slots)", "by_slots": by_slots}


def _time_gemv_f32(torch, dev, cfg, qparams, launches, g) -> dict:
    """qmatmul.cu's GEMV on what it serves, f32 x (gemv_route sends every
    bf16 serving operand to qgemv_sm90.cu): a decode step's 197 matrices
    (4-bit float, block 64, rows as stored) at each of F32_GEMV_MS rows,
    beside its plain version, torch.matmul on the same f32 operands (the
    weights dequantized to f32) and its bound: the bytes, or the products
    at 3xTF32's rate."""
    from repro_torch.core.qtensor import dequantize_tensor
    from repro_torch.kernels import qmatmul as qk

    dense, by_rows = None, {}
    for M in F32_GEMV_MS:
        calls, qts, nbytes, flops = _b1_calls(torch, dev, qparams, cfg, M, True, g)
        calls = [(xp.float(), packed, scales, op, x.float()) for xp, packed, scales, op, x in calls]
        # x in and y out are f32: twice the bf16 plan's bytes
        nbytes += sum(M * (c[3].k_dim + c[1].shape[0]) * 2 for c in calls)
        if dense is None:
            dense = [dequantize_tensor(qt, out_dtype=torch.float32) for qt in qts]
        bound_ms, bound_by = _bound(nbytes, flops, TF32X3_FLOP_PER_S)
        by_rows[M] = {"ms": _time_ms(torch, _b1_run(calls, qk.qmatmul_gemv_simt), 5),
                      "plain_ms": _time_ms(torch, _b1_run(calls, qk.qmatmul_plain), 2),
                      "library_ms": _time_ms(torch, _lib_run(torch, calls, dense), 5),
                      "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                      "flops": flops}
        del calls
    del dense
    torch.cuda.empty_cache()
    main = by_rows[BATCH]
    return {"source": "src/repro_torch/csrc/qmatmul.cu",
            "replaces": "src/repro/kernels/qmatmul.py:97", "launches": launches,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "per": f"a decode step's matrices with f32 x ({7 * cfg.n_layers + 1} launches, "
                   f"M = {BATCH})", "by_rows": by_rows,
            "rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "tf32x3_flop_per_s": TF32X3_FLOP_PER_S}}


def _time_attention(torch, dev, cfg, launches, g):
    """The fused decode attention over one decode step (one launch a layer,
    each layer its own random packed cache, batch 4, every slot valid) at
    the serve phase's slots and at LONG_CONTEXT, and at ONE_TILE for its
    fixed cost a launch (what does not grow with slots), beside the path it replaced
    (two standalone KV dequant launches a layer and the eager attention) and
    its plain version."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd
    from repro_torch.models import attention as attn

    spec = kvd.kv_spec(cfg)
    shape = (BATCH, -1, cfg.n_kv_heads, cfg.head_dim)
    K, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    by_slots = {}
    for S in (ONE_TILE, PROMPT + NEW_TOKENS, LONG_CONTEXT):
        caches = [_random_cache(torch, dev, g, spec, BATCH, S, K * Dh)
                  for _ in range(cfg.n_layers)]
        q = torch.randn((BATCH, H, Dh), generator=g, device=dev).to(torch.bfloat16)
        # the position in device memory, as the decode step passes it (an int
        # would add a fill kernel to every launch)
        pos = torch.full((), S - 1, dtype=torch.int32, device=dev)

        def step(fn):
            def go():
                for c in caches:
                    fn(c)
            return go

        def replaced(c):
            k = kvd.dequant_rows(c["k_packed"], c["k_scales"], spec, K * Dh).reshape(shape)
            v = kvd.dequant_rows(c["v_packed"], c["v_scales"], spec, K * Dh).reshape(shape)
            m, l, pv = attn.decode_attention_partial(q, k, v, c["pos"], S - 1)
            return attn.combine_partials(m, l, pv).reshape(q.shape).to(q.dtype)

        c0 = caches[0]
        nbytes = cfg.n_layers * (sum(t.numel() * t.element_size() for t in c0.values())
                                 + 2 * q.numel() * 2 + 4 * 2 ** spec.bits)
        flops = cfg.n_layers * 4.0 * BATCH * H * S * Dh
        bound_ms, bound_by = _bound(nbytes, flops)
        by_slots[S] = {
            "ms": _time_ms(torch, step(lambda c: kat.decode_attention_packed_cuda(
                q, c, pos, spec)), 20),
            "replaced_ms": _time_ms(torch, step(replaced), 5),
            "plain_ms": _time_ms(torch, step(lambda c: kat.decode_attention_packed_plain(
                q, c, pos, spec)), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        if S != ONE_TILE:
            by_slots[S].update(_time_paged_attention(torch, dev, cfg, caches, q, g))
        del caches
        torch.cuda.empty_cache()
    main = by_slots[PROMPT + NEW_TOKENS]
    return {"source": "src/repro_torch/csrc/kv_decode_attention.cu",
            "replaces": "src/repro/kernels/kv_dequant.py:159", "launches": launches,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "per": f"decode step ({cfg.n_layers} launches, {PROMPT + NEW_TOKENS} slots)",
            "replaced_ms": main["replaced_ms"], "by_slots": by_slots}


def _time_paged_attention(torch, dev, cfg, caches, q, g) -> dict:
    """The fused attention over the same caches as the Server reads them: a
    position a row, unpaged over [B, S] rows and paged (pages of PAGE_SIZE,
    a shuffled page map), beside the paged read's bound."""
    from repro_torch.kernels import kv_attention as kat
    from repro_torch.kernels import kv_dequant as kvd

    spec = kvd.kv_spec(cfg)
    B, S = q.shape[0], caches[0]["k_packed"].shape[1]
    rows = [{**c, "pos": c["pos"].expand(B, S).contiguous()} for c in caches]
    paged = [_paged_from_rows(torch, dev, g, r, PAGE_SIZE) for r in rows]
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    rows_ms = _time_ms(torch, lambda: [kat.decode_attention_packed_cuda(q, r, pos, spec)
                                       for r in rows], 20)
    paged_ms = _time_ms(torch, lambda: [kat.decode_attention_packed_cuda(
        q, c, pos, spec, page_map=m, page_size=PAGE_SIZE) for c, m in paged], 20)
    r0, m0 = rows[0], paged[0][1]
    nbytes = len(caches) * (sum(t.numel() * t.element_size() for t in r0.values())
                            + m0.numel() * 4 + 2 * q.numel() * 2 + 4 * 2 ** spec.bits)
    bound_ms, bound_by = _bound(nbytes, len(caches) * 4.0 * B * cfg.n_heads * S * cfg.head_dim)
    return {"rows_ms": rows_ms, "paged_ms": paged_ms, "paged_bound_ms": bound_ms,
            "paged_bound_by": bound_by, "paged_bytes": nbytes}


def _time_gemm_simt(torch, dev, launches, g):
    """B1's f32 CUDA-core GEMM (qgemm_simt) at the sweep's GEMM shapes: each
    tiny-ladder matrix once at M = 1024 (4-bit float, block 64) with f32 x,
    beside its plain version and torch.matmul on the same f32 operands (the
    weight dequantized to f32); bound by f32 operations outside the tensor
    cores or by bytes.  Then the same shapes at 3, 5 and 6 bits on rows as
    stored, which it reads, beside rows padded to whole words beforehand
    (``_pad_words``)."""
    from repro_torch.configs.tiny import TINY_FAMILY
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as qk
    from repro_torch.kernels.ref import dequantize_operand

    M = 1024
    weights = [torch.randn((K, N), generator=g, device=dev) * 0.05
               for tcfg in TINY_FAMILY.values()
               for K, N in ((tcfg.d_model, tcfg.d_model), (tcfg.d_model, tcfg.d_ff),
                            (tcfg.d_ff, tcfg.d_model))]
    xs = {K: torch.randn((M, K), generator=g, device=dev) for K in {w.shape[0] for w in weights}}

    def operands(bits):
        out = []
        for w in weights:
            op = ops.prepare_operand(w, bits=bits, dtype="float", block_size=64)
            out.append((*ops.pad_for_kernel(xs[w.shape[0]], op), op))
        return out

    calls = [(*c, dequantize_operand(c[3])) for c in operands(4)]
    nbytes = sum(c[1].numel() * 4 + c[2].numel() * 2 + c[0].numel() * 4
                 + M * c[1].shape[0] * 4 for c in calls)
    flops = sum(2.0 * M * c[1].shape[0] * c[0].shape[1] for c in calls)

    def run(fn, calls=calls):
        def go():
            for xp, packed, scales, op, *_ in calls:
                fn(xp, packed, scales, op.codebook, bits=op.bits, block_size=op.block_size)
        return go

    by_bits = {}
    for bits in LOW_BITS:
        stored = operands(bits)
        padded = [(*_pad_words(xp, packed, scales, op), op) for xp, packed, scales, op in stored]
        by_bits[bits] = {"stored_ms": _time_ms(torch, run(qk.qmatmul_gemm, stored), 5),
                         "padded_ms": _time_ms(torch, run(qk.qmatmul_gemm, padded), 5)}

    def lib():
        for xp, _, _, _, wd in calls:
            torch.matmul(xp, wd.T)

    bound_ms, bound_by = _bound(nbytes, flops, F32_FLOP_PER_S)
    return {"source": "src/repro_torch/csrc/qmatmul.cu", "replaces": "src/repro/kernels/qmatmul.py:97",
            "launches": launches, "ms": _time_ms(torch, run(qk.qmatmul_gemm), 5),
            "plain_ms": _time_ms(torch, run(qk.qmatmul_plain), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": _time_ms(torch, lib, 5),
            "per": f"the sweep's {len(calls)} GEMM shapes once each, M = {M}, f32 x",
            "bytes": nbytes, "flops": flops, "rows_as_stored_by_bits": by_bits}


def _peak_extra(torch, fn) -> int:
    """Peak device memory fn takes above what is allocated when it starts."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _old_encode_chain(view, cb, bits: int, block: int):
    """The route quantize_pack replaced, from a 2-D item to its stored
    form: blockwise.encode (a copy to padded f32 blocks, the old encode
    kernel, casts), packing.pack of the flat codes, then to_structured's row
    repack (an unpack and a second pack where rows end inside a word)."""
    from repro_torch.core import blockwise, packing

    rows, cols = view.shape
    q = blockwise.encode(view, cb, block)
    words = packing.pack(q.codes.reshape(-1), bits)
    if cols % packing.codes_per_word(bits):
        words = packing.pack(packing.unpack(words, bits, rows * cols).reshape(rows, cols), bits)
    return words.reshape(rows, -1), q.scales.reshape(rows, cols // block)


def _time_encode(torch, dev, cfg, counts, g):
    """Both encode kernels at each Qwen2-7B item shape (4-bit float, block
    64), per launch and summed over one whole-model encode (one launch per
    quantized matrix: 7 per layer and the lm_head): quantize_blocks on its
    f32 blocks (its contract), quantize_pack from the stored bf16 weight
    beside the chain it replaced (_old_encode_chain: copies, casts and
    packing around the old kernel), which must store the same words."""
    from repro_torch.core.codebooks import make_codebook
    from repro_torch.kernels import quantize as quantk

    cb = make_codebook("float", 4, device=dev)
    per_shape = {}
    keys = ("b3_ms", "b3_plain_ms", "b3_bound_ms", "b3_bytes", "ms", "plain_ms", "chain_ms",
            "bound_ms", "bytes")
    peaks = {"peak_extra_bytes": 0, "chain_peak_extra_bytes": 0}   # largest item's
    tot = dict.fromkeys(keys, 0.0)
    for (rows, cols), n in _qwen_items(cfg).items():
        transposed = rows != cfg.vocab_size   # the matrices are stored [In, Out]
        stored = torch.randn((cols, rows) if transposed else (rows, cols), generator=g,
                             device=dev).to(torch.bfloat16)
        view = stored.T if transposed else stored
        xb = view.reshape(-1).float().reshape(-1, 64)
        r = {"b3_ms": _time_ms(torch, lambda: quantk.quantize_blocks_cuda(xb, cb), 10),
             "b3_plain_ms": _time_ms(torch, lambda: quantk.quantize_blocks_plain(xb, cb), 3),
             # its contract's bytes: 4 in and 4 of code per value, 4 of scale per block
             "b3_bytes": xb.numel() * 8 + xb.shape[0] * 4 + cb.numel() * 4}
        del xb
        kw = dict(bits=4, block_size=64, transposed=transposed)
        r["ms"] = _time_ms(torch, lambda: quantk.quantize_pack_cuda(stored, cb, **kw), 10)
        r["plain_ms"] = _time_ms(torch, lambda: quantk.quantize_pack_plain(stored, cb, **kw), 2)
        old = _old_encode_chain(view, cb, 4, 64)
        new = quantk.quantize_pack_cuda(stored, cb, **kw)
        require(all(torch.equal(a, b) for a, b in zip(old, new)),
                f"quantize_pack and the chain it replaced store different words at {rows}x{cols}")
        del old, new
        r["chain_ms"] = _time_ms(torch, lambda: _old_encode_chain(view, cb, 4, 64), 2)
        # device memory one call takes beyond its input, outputs included
        r["peak_extra_bytes"] = _peak_extra(torch, lambda: quantk.quantize_pack_cuda(
            stored, cb, **kw))
        r["chain_peak_extra_bytes"] = _peak_extra(torch, lambda: _old_encode_chain(
            view, cb, 4, 64))
        # 2 bytes in, a packed word per 8 codes and a bf16 scale per block out
        r["bytes"] = rows * cols * 2 + rows * (cols // 8) * 4 + rows * (cols // 64) * 2 \
            + cb.numel() * 4
        r["b3_bound_ms"] = _bound(r["b3_bytes"], 0.0)[0]
        r["bound_ms"] = _bound(r["bytes"], 0.0)[0]
        per_shape[f"{rows}x{cols}"] = {**r, "per_model_encode": n, "transposed": transposed}
        for k in keys:
            tot[k] += n * r[k]
        for k in peaks:
            peaks[k] = max(peaks[k], r[k])
        del stored, view
        torch.cuda.empty_cache()
    n_items = sum(_qwen_items(cfg).values())
    common = {"bound_by": "bytes", "library_ms": None,
              "per": f"one Qwen2-7B encode ({n_items} launches)"}
    return ({"source": "src/repro_torch/csrc/quantize.cu",
             "replaces": "src/repro/kernels/quantize.py:33", "launches": counts["b3"],
             "ms": tot["b3_ms"], "plain_ms": tot["b3_plain_ms"], "bound_ms": tot["b3_bound_ms"],
             "bytes": tot["b3_bytes"], **common},
            {"source": "src/repro_torch/csrc/quantize_pack.cu",
             "replaces": "src/repro/kernels/quantize.py:33", "launches": counts["pack"],
             "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
             "bytes": tot["bytes"], "replaced_chain_ms": tot["chain_ms"], **peaks, **common},
            per_shape)


if __name__ == "__main__":
    sys.exit(main())
