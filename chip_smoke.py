#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card — requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build — compiles every kernel of ``src/repro_torch/kernels/**/csrc`` with
   ``nvcc`` (one process per source, all started together) and prints the
   build time and, per source, the compiler's report: kernels, the most
   registers a thread, and each kernel that spills (a K2 kernel that spills
   fails the run);
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving paths give it (flash attention on compact GQA K/V
   — KV 8 at the llama shapes, g = 5, hd 112, fully masked rows, kv_len at
   and around a 64-key tile edge, Sk not a multiple of 64, an 8192-key
   decode split over blocks, and the many-row split path — 64 or 256 query
   rows over 20 000 keys, causal, at a q offset and non-causal; zamba2's
   shared attention, hd 112 with one query head per KV head: a decode step
   B4 over 2080 keys with kv_len 2048/2049/2079/2080 and a causal prefill
   B4 S2048; moonshot-v1-16b-a3b's attention, hd 128 with one query head
   per KV head (H 16): the same decode step and prefill, and its training
   shape, causal B2 S4096 in bf16; whisper-tiny's (H = KV 6, hd 64): the
   encoder's non-causal B16 S1500, the cross-attention's non-causal prefill
   B16 Sq4 Sk1500, training shape B32 Sq448 Sk1500 and split-K decode B16
   Sq1 Sk1500, and the decoder's self decode B16 Sq1 Sk448 at per-slot
   kv_len; internvl2-26b's (H 48 over KV 8, g = 6, hd 128): the prefill
   B8 S1280, a decode step B8 Sq1 Sk1344 at per-slot kv_len and the
   training shape B2 S4096; zamba2's training shape B2 S2048 at hd 112;
   the parallel rigs' ranks (phase 25: llama at tp 2 and dp 2; phase 26:
   moonshot at B1 S4096 H16 under ep 2 and dp 2, B2 S4096 H8 under tp 2;
   phase 29: a cp rank's ring at llama3.2-1b-long's heads, step 0 causal
   B1 S8192 at rank 0's zig-zag positions of 16 384, the later steps
   non-causal B1 Sq8192 Sk4096 and Sq4096 Sk8192; phase 30: the same ring
   inside a pipeline stage at S 8 192, step 0 causal B1 S4096, later steps
   B1 Sq4096 Sk2048 and Sq2048 Sk4096): fp32 1e-4,
   bf16 3e-2, residuals 1e-5, and per (b, s, h) row against the fp32 plain
   version 1e-4 (fp32) or 2^-6 (bf16) of the row's largest |value|, which
   holds rows over thousands of keys, whose values are ~1e-2; the llama
   training shape q 2x4096x32x64,
   k/v 2x4096x8x64 causal bf16, timed; its yardstick is the faster of SDPA
   with ``enable_gqa`` on the compact heads and SDPA on expanded heads (the
   case's boolean mask; ``is_causal`` where that mask is the plain causal
   one, no mask where the case is non-causal); the autograd
   ``flash_attention`` on the split path (S 20 000, fp32), non-causal at
   whisper's cross training shape, at zamba2's training shape (hd 112) and
   at internvl2's heads (g = 6) against autograd through the plain
   version, 2e-3 of scale; RMSNorm (K2; fp32 1e-5, bf16
   2e-2 — the JAX kernel tests' tolerances): the forward at every template
   (1 to 8 packs of 16 bytes a thread, the two-pass loop, the scalar
   template on an odd width and on misaligned views; each case logs its
   template), the decode rows, the training shape 8192 x 2048, the
   layer norms of mamba2 (8192 x 2560) and zamba2 (8192 x 3584),
   whisper's at width 384 (24 000 and 16 rows serving, 48 000 training),
   internvl2's at width 6144 (10 240 rows serving, 8192 training) and the
   Mamba2 training microbatch's 4096 rows at widths 2560, 5120, 3584 and
   7168 in bf16 timed; the gated forward ``rmsnorm(x * silu(z))`` in bf16 and fp32 at
   8192 and 4 rows of 5120 and 7168, an odd width and a misaligned gate,
   the bf16 rows timed beside the unfused composition (no library call
   computes the gate); the backward kernel (dx at the forward's
   tolerances, an fp32 dscale at 1e-4 of its scale, bitwise equal over two
   calls) at 8192 x 2048 (bf16 x with fp32 scale, and fp32), 8192 x 3584,
   32768 x 128, 48 000 x 384, 8192 x 6144, 4096 x 5120, 4096 x 7168, an odd
   width and a misaligned view, timed against the plain
   backward and ``F.rms_norm``'s backward; the split-row form (phase 27's
   gate norms, 4096 rows of 5120 and 7168 split over two halves, an odd
   width, a misaligned view; bf16 and fp32): each half's passes, the row
   statistics summed by hand, against the plain passes and, concatenated,
   against the whole-row K2 and its backward, the bf16 halves' forward and
   backward pairs timed beside the whole-row K2 at the same width; SSD scan: max |err| <= 1e-3 *
   max(1, max |plain|) for
   y and the final state, plus one bf16 step (2^-7 |y|) for a bf16 y, at
   the mamba2 prefill shape, a ragged S, G = 2 and zamba2's prefill (112
   heads over G 2, N 64), each in fp32 and in bf16
   (the dtype the model passes; the tensor-core template), and against the
   step-by-step scan; each template's shared memory per block and blocks
   per SM at N 128, P 64 are logged); the scan under autograd
   (``ssd_autograd``: K3 forward, fp32 recompute backward) at mamba2's and
   zamba2's training shapes (B2 S2048), a ragged S 1 000 and a phase 27
   rank's local heads (mamba2 H40, zamba2 H56 on one group): y and the five
   grads against autograd through ``ssd_chunked``, 1e-3 * max(1, max
   |plain|) in fp32, no further from fp32 than twice the plain route's in
   bf16, the forward and backward timed; then each case's median
   device time, the plain version's, and one PyTorch library call's as a
   yardstick (``library_ms``; the port never calls it; none computes the
   SSD scan), beside the least time the card could take (``bound_ms``, from
   this run's inputs);
4. llama serve — full-width llama3.2-1b (random weights from a seed) through
   ``repro_torch.serving.build``, whose scheduler replays CUDA graphs of its
   decode step (all 8 lanes) and prefill step (one chunk), K1 and K2
   launched inside them: 8 requests of 512 prompt tokens, 32 new tokens
   each, 8 slots, page 16, prefill chunk 256; launch counters are zeroed
   just before and read just after, and K1 and K2 must have run; the same
   traffic through the eager scheduler (``compiled=False``, the same
   weights) gives identical greedy bf16 tokens and equal launches over equal
   ticks; TTFT, TPOT and tok/s of both, the graphs' capture time and pool
   bytes; then 8 graphed and 8 eager decode ticks (8 slots) under
   ``torch.profiler``: device time by kernel group and the device's busy
   share of the wall-clock window, and the decode graph's replay timed with
   CUDA events;
5. llama parity — a reduced llama3.2-1b served in fp32 with
   ``impl="kernel"`` and ``impl="ref"`` gives identical greedy tokens; at
   full width the first prefill chunk's bf16 logits of the two paths differ
   by at most 3e-2 of the logit scale, and the kernel path is no further
   than twice the plain bf16 path's own error from the plain path in fp32;
6. mamba2 serve — full-width mamba2-2.7b (random bf16 weights from seed 0)
   through ``serving.step_engine(...).greedy_generate``: 4 prompts of 2048
   tokens, 32 new tokens; launch counters zeroed just before and read just
   after, each pinned (``step_engine_launches``): exactly 64 SSD launches
   (one per layer of the prefill), 129 x 32 RMSNorm launches (129 per
   forward), of them 64 x 32 gated (the gate norm), no K2 backward and no
   flash attention; TTFT, TPOT, tok/s and peak memory; then
   one prefill and 4 decode steps under ``torch.profiler``, device time by
   kernel group and the busy share; 6b. the same traffic with its 31 decode
   steps through ``jit_decode_step(donate=True)`` (a CUDA graph; the prefill
   eager), after a warm-up run that captures it: launches pinned as above,
   tokens identical to the eager run's, TTFT and TPOT beside the eager
   run's, capture time and pool bytes, 4 graphed steps profiled and the
   graph's replay timed with CUDA events (``graphed_serve``);
7. mamba2 parity — a reduced mamba2 in fp32 gives identical greedy tokens
   with ``impl="kernel"`` and ``impl="ref"``; the full-width bf16 prefill
   logits of the kernel path are finite and no further from the plain fp32
   path than twice the plain bf16 path's own error, and in fp32 the kernel
   path is within 1e-3 of the logit scale of the plain path; 7b. the reduced
   mamba2's ``jit_prefill_step()`` — K3 captured in the graph — bitwise (or
   within 1e-6 of scale) the eager prefill in bf16 on two batches of ragged
   prompts, K3 launched once per layer a replay;
8. zamba2 serve — phase 6 at full-width zamba2-7b (81 Mamba layers, d 3584,
   the shared attention block at 13 sites, hd 112, H = KV = 32): exactly 81
   SSD, 13 x 32 = 416 flash attention and 189 x 32 = 6048 RMSNorm launches,
   81 x 32 = 2592 of them gated; 8b. the same traffic through
   ``jit_prefill_step()`` (K3 81 times, K1 at the 13 sites and K2 inside
   one graph) and 31 ``jit_decode_step(donate=True)`` calls (the nested
   ``{"mamba", "attn"}`` cache donated), as phase 6b;
9. zamba2 parity — phase 7 for zamba2, its reduced model with 7 layers (3
   sites and a trailing Mamba layer);
10. train — full-width llama3.2-1b (16 layers, random fp32 master weights
   from seed 0) through ``construct_hybrid_parallel_model(model, plan)
   .train_step``: 8 x 4096 tokens a step in 4 microbatches under each
   remat policy, fresh state each: 3 steps of selective, 2 of full and of
   none (3 until phase 30 came); losses (finite,
   the first within 1 of ln V), grad norms, median step time, tokens/s,
   peak memory and MFU against the model FLOPs the script reckons; K1, K2
   and K2-backward launches per step pinned (``TRAIN_LAUNCHES``: the
   backward 33 x 4 under every policy); one selective step under
   ``torch.profiler`` by group (K1, K2, K2's backward, the attention
   backward's recompute, matmuls, elementwise, the optimizer, copies);
   CUDA-event times of one
   attention backward and one AdamW update; kernel path against plain path
   at full width with 2 layers, 2 x 1024 tokens: fp32 loss 1e-4, grads and
   updated params 2e-3 of scale; bf16 loss 3e-2, the kernel path's grads
   no further from fp32 than twice the plain bf16 path's;
11. planner — Galvatron's loop on the card through the port's entry points:
   ``launch.profile`` measures two full-width llama3.2-1b blocks (S 1024 and
   4096, microbatch 2, bf16; forward, grad and full-remat grad, each a CUDA
   graph as JAX jits them, through K1, K2 and K2's backward, whose launches
   are pinned: ``profile_launches``) into a fresh profile cache, each cell
   logged beside the same cell measured eagerly (``compiled=False``),
   and a second call measures nothing; one cell again with a random input in
   place of zeros; the fitted calibration; ``SearchEngine(cfg,
   cluster=H100_1)`` at S 4096 and global batch 8 with the analytic and the
   calibrated coefficients (plan, predicted step and memory, ``check_plan``);
   3 full-width steps of the calibrated plan (median step, tokens/s, MFU,
   peak memory, K1/K2 launches per step, K2's backward pinned at 33 per
   microbatch, GALV070 against both predictions);
   then ``python -m repro_torch.launch.train`` (selective, grad_accum 4, the
   measured cache) as a subprocess, whose median step must be within 5 % of
   phase 10's selective median (or of the spread of phase 10's own selective
   steps, when the host makes that wider);
12. moonshot serve — phase 6 at full-width, full-depth moonshot-v1-16b-a3b
   (48 layers, d 2048, 16 = KV heads at hd 128, 64 experts of ff 1408,
   top-6, capacity factor 1.25, a shared expert of ff 2816, untied vocab
   163 840; 28.89 G parameters, 57.8 GB in bf16, drawn piece by piece):
   exactly 48 x 32 = 1536 flash attention and 97 x 32 = 3104 RMSNorm
   launches, none gated, no K3; the profiled prefill and decode steps group
   the MoE FFN's kernels by its profiler spans (routing, dispatch gather,
   expert products, combine gather); 12b. the same traffic through
   ``jit_prefill_step()`` (capacity 960 at T = 8192) and 31
   ``jit_decode_step(donate=True)`` calls (capacity 8 at T = 4), full depth,
   as phase 6b, the graph pool freed before phase 13;
13. moonshot parity — (a) the reduced moonshot in fp32: identical greedy
   tokens with ``impl="kernel"`` and ``impl="ref"``; (b) full depth in
   bf16: the two paths' last-position logits, their top-1 agreement, the
   share of (token, layer, choice) routing decisions on which they agree,
   and the prefill's capacity-drop share, logged; (c) full width cut to 4
   layers (the served weights' first 4; fp32 at full depth would be
   115 GB) under phase 7's rules, the routing agreement logged in each
   dtype;
14. moonshot train — full width cut to 2 layers (fp32 masters, grads and
   AdamW state for 48 would be ~462 GB): 3 steps of 8 x 4096 tokens in 4
   microbatches under ``selective`` from fresh state; losses, aux (finite
   and positive), step time, tokens/s, peak memory and MFU; K1 16, K2 36
   and K2-backward 20 launches a step pinned; phase 10's kernel-vs-plain
   parity on one microbatch of 2 x 4096, the routing agreement logged;
   after phase 13 the caching allocator is reported (``allocator_report``:
   what stays reserved once the phases' objects are gone, and which active
   blocks keep segments);
15. whisper serve — full-width, full-depth whisper-tiny (4 encoder and 4
   decoder layers, d 384, 6 = KV heads at hd 64, gelu ff 1536, 1500
   frames, untied vocab 51 865; random bf16 weights from seed 0): 16
   windows of standard normal bf16 frames from a seeded generator on the
   card, a 4-token prompt and 224 new tokens in a 448-token cache, through
   the engine's own steps, ``prefill_step(params, tokens, {"frames": f})``
   then ``decode_step``; TTFT (the encoder included), TPOT, tok/s, peak
   memory; K1 12 and K2 22 launches a prefill, 8 and 13 a decode step,
   pinned; one prefill and 4 decode steps profiled; 15b. the same traffic
   through ``jit_prefill_step()`` (the frames fed, the encoder inside the
   graph) and 223 ``jit_decode_step(donate=True)`` calls (the nested
   ``{"self", "cross"}`` cache donated, the cross cache read only), as
   phase 6b, launches pinned by ``whisper_launches``;
16. whisper parity — at full width and depth on the served weights: fp32
   (weights and frames cast) on 4 windows, the kernel path's prefill logits
   within 1e-3 of the plain path's scale and its greedy tokens over 32
   steps identical; phase 7's bf16 rule on the served batch;
17. whisper train — full width and depth, 3 steps of 256 windows x (448
   tokens + 1500 frames) in 8 microbatches (the family applies no remat
   policy) from fresh state: losses (the first within 1 of ln V), median
   step, decoder tokens/s and frames/s, peak memory, MFU against
   ``whisper_train_flops``; K1 12, K2 22 and K2-backward 22 launches a
   microbatch pinned; one step profiled; phase 10's kernel-vs-plain parity
   on 2 windows;
18. internvl2 serve — full-width, full-depth internvl2-26b (48 layers, d
   6144, 48/8 heads at hd 128, swiglu ff 16 384, untied vocab 92 553; the
   InternLM2 backbone, 19.86 G parameters, 39.7 GB in bf16; random weights
   from seed 0): 8 turns of one image tile (256 seeded standard normal bf16
   patch embeddings) and 1 024 text tokens, 64 new tokens in a 1 344-row
   cache, through ``prefill_step(params, tokens, {"vis_embeds": v})`` then
   ``decode_step`` at ``cache_index = 256 + 1024 + i``; TTFT, TPOT, tok/s,
   peak memory; K1 48 and K2 97 launches a forward pinned; one prefill and
   4 decode steps profiled; 18b. the same traffic through
   ``jit_prefill_step()`` and 63 ``jit_decode_step(donate=True)`` calls
   (CUDA graphs of the full-width prefill and decode, K1 at g = 6 and K2
   inside them), as phase 6b;
19. internvl2 parity — full width cut to 4 layers (the served weights'
   first 4; fp32 at full depth would be 79 GB), the served prefix: fp32
   logits within 1e-3 of the plain path's scale, 32 greedy tokens
   identical; phase 7's bf16 rule;
20. internvl2 train — full width cut to 2 layers (~318 GB of fp32 state at
   48), 3 steps of 8 x (256 + 3 840) positions in 4 microbatches under
   ``selective``, the state donated (updated in place); K1 16, K2 36 and
   K2-backward 20 launches a step pinned; phase 10's kernel-vs-plain
   parity on one microbatch with seeded non-zero patch embeddings;
21. mamba2 train — mamba2-2.7b at full width cut to 8 of 64 layers
   (``MAMBA2_TRAIN_LAYERS``: the whole run's time limit; 16 until phase 29
   came),
   3 steps of 8 x 2048 tokens in 4 microbatches under ``selective``, the
   state donated: K3 under autograd (64 launches a step: the forward and
   the selective recompute), K2 132 and K2-backward 68 pinned; MFU with the scan's
   FLOPs (``ssm_train_flops``); one step profiled with the ``ssd_vjp`` and
   ``optimizer`` spans; phase 10's kernel-vs-plain parity at 2 layers;
22. zamba2 train — full width cut to 13 layers (two shared-block sites and
   a trailing Mamba layer), the mamba2 traffic, no remat policy (the
   hybrid takes none, as in JAX), the state donated: K3 52, K1 8, K2 and
   K2-backward 124 launches a step pinned;
23. moe planner — phase 11's loop for moonshot-v1-16b-a3b, after phase 14:
   ``launch.profile`` measures two full-width moonshot blocks (64 experts
   of ff 1408, top-6, a shared expert of 2816, hd 128; S 1024 and 4096,
   microbatch 2, bf16) as CUDA graphs, launches pinned, each cell beside
   its eager measurement, a second pass measures nothing; the calibration
   from that cache alone (the fitted bwd / fwd and remat ratios against
   their clips); ``SearchEngine(cfg, H100_1)`` at 8 x 4096 finds no plan at
   48 layers, analytic or calibrated; cut to 2 layers the analytic search
   finds one (its cost is its prediction, ``check_plan`` passes) and the
   calibrated one none (its ``mem_scale``, the peak over the predicted
   activations with the expert weights in the peak, prices the cut past
   the card); the analytic search over grad_accum 4 and 8
   (``MOE_PLAN_GRAD_ACCUM``: its unconstrained plan, grad_accum 2, runs
   out of memory) gives the plan trained, 3 steps twice, with the cyclic
   collector on and off (K1/K2/K2-backward launches pinned by
   ``train_launches``, peaks within 1 %), beside both predictions of step
   and peak and GALV070's verdict; ``python -m repro_torch.launch.train
   --arch moonshot-v1-16b-a3b --seq 4096 --batch 8 --grad-accum 4 --remat
   selective --validate-only`` exits 1 on GALV020;
25. the parallel runtime (run after phase 22, before the results) —
   llama3.2-1b at full width cut to 2 of 16 layers (``PAR_LAYERS``: the
   whole run's time limit; 4 until phase 29 came) on two ranks sharing the
   card: NCCL
   refuses two ranks on one device, so they join over gloo (a
   ``FileStore``), each a ``chip_smoke.py --parallel-rank`` process that
   loads the library the parent built, on the mesh ``train_mesh_spec(2)``
   = (data 1, model 2); each trains 1 step (2 until phase 30 came) of
   4 x 4096 tokens (bf16
   compute, fp32 masters) under (a) tp 2 + sp, ZeRO-1, selective, (b) tp 1
   (dp 2 through the absorbed model axis), ZeRO-3, selective, (c) the
   search's plan for a 2-card H100 cluster at half a card per rank; the
   losses within 5e-2 of one rank's ``mesh=None`` step on the same seed-0
   weights and batches (computed here while the ranks start), each rank's
   K1 / K2 / K2-backward launches per step pinned (``par_launches``), K1 at
   16 query and 4 KV heads under (a); then (a) and (b) in fp32 at 2 layers:
   the loss within 1e-4 relative, every updated param within 2e-3 of its
   leaf's update scale; logs per-rank peaks against the card, step times
   (no interconnect measured) and the collectives called by name and
   dtype;
26. the MoE family on a mesh (run after phase 25, before the results) —
   moonshot-v1-16b-a3b at full width cut to 1 layer (``MPAR_LAYERS``: the
   whole run's time limit) on two ranks sharing
   the card over gloo (``chip_smoke.py --moe-parallel-rank``, as phase 25):
   first the routing of 8 192 seeded fp32 router logits split over the
   ranks (``moe.distributed_slots`` from the all-gathered counts) against
   one rank's ``assign_slots``, integer-exact; then 1 step (2 until phase
   30 came) of 4 x 4096 in
   2 microbatches (bf16 compute, fp32 masters; C = 960 a global
   microbatch) under (a) (data 2, model 1), ep 2, ZeRO-1, selective (the
   expert exchange), (b) (1, 2), tp 2 + sp, ZeRO-1, selective, (c) (1, 2),
   tp 1 (dp 2), ZeRO-3, no remat; the losses within 5e-2 of one rank's
   ``mesh=None`` step on the same seed-0 weights and batches (computed
   here while the ranks start), each rank's K1 / K2 / K2-backward launches
   per step pinned and K1's local heads checked; the kept share per layer
   against one rank's, the exchange's bytes, peaks and step times (no
   interconnect measured); then (a)'s and (b)'s fp32 ``value_and_grad`` at
   2 x 1024 (``MPAR_FP32_PLANS``; (c)'s repeat cut for phase 29) against
   one rank's (``mesh=None``, on each rank): the loss within 1e-4 relative,
   every grad's shards within 2e-3 of its leaf's scale,
   each layer's routing decisions that differ from one rank's logged;
27. tensor parallelism in the SSM, hybrid and audio families (run after
   phase 26, before the results) — two ranks sharing the card over gloo
   (``chip_smoke.py --ssm-parallel-rank``, as phase 25) on mesh (data 1,
   model 2), 1 step each (2 until phase 30 came) in 2 microbatches (bf16
   compute, fp32 masters):
   (a) mamba2-2.7b at full width cut to 4 layers, tp 2 without SP, ZeRO-1,
   selective, 4 x 2048 a step (K3 at 40 heads, the split K2 at 2560 of
   5120 columns); (b) zamba2-7b at full width cut to 6 layers (one
   shared-block site), tp 2 + sp, ZeRO-1, 4 x 2048 (K3 at 56 heads on one
   of the 2 groups, K1 at 16 heads, hd 112); (c) whisper-tiny at full
   width and depth, tp 2 + sp, ZeRO-1, 64 windows x 448 tokens and 1500
   seeded frames (K1 at 3 heads: encoder, cross- and self-attention); the
   losses within 5e-2 of one rank's ``mesh=None`` step on the same seed-0
   weights and batches (computed here while the ranks start), every
   launch per rank a step pinned (``ssm_par_launches``: K1, K2, its
   backward, the split K2's four passes, K3) and the shapes each kernel
   sees checked; then each case in fp32 (mamba2 at 2 layers and zamba2 at
   6, 2 x 512; whisper at 4 windows): the loss within 1e-4 relative of one
   rank's and every grad's shards within 2e-3 of its leaf's scale; peaks
   per rank and their sum against the card, step times (no interconnect
   measured) and the collectives called;
28. pipeline parallelism (run after phase 27, before the results) — two
   pipeline stages sharing the card over gloo (``chip_smoke.py --pp-rank``,
   as phase 25; every hop staged through pinned host buffers) on
   ``train_mesh_spec(2, pp=2)`` = (pod 2, data 1, model 1), through
   ``runtime.train_pp.PipelineTrainer``, 1 step each (2 until phase 30
   came) of 8 sequences in 4
   microbatches (bf16 compute, fp32 masters, ``selective``): llama3.2-1b
   at full width cut to 4 layers (``PP_LAYERS``), 8 x 4096, under (a)
   gpipe, (b) 1f1b (2 windows of 2), (c) interleaved v 2 (stage 0 holds
   layers 0 and 2); (d) mamba2-2.7b at full width cut to 4 layers, 8 x
   2048, 1f1b (K3 under autograd in both stages); the losses within 5e-2
   of one rank's full-batch loss on the same seed-0 weights and batches
   (computed here while the stages start), each stage's K1 / K2 /
   K2-backward / K3 launches a step pinned (``pp_launches``), the shapes K1
   and K3 see (the llama and mamba2 training rows), ``max_in_flight`` (4
   under gpipe, at most 2 otherwise); peaks against the card, boundary
   bytes, step times (gloo, no interconnect) and collectives logged; then
   (a), (c) and (d) in fp32 at 8 x 256 (``PP_FP32_CASES``; (b)'s repeat cut
   for phase 29) against one rank's ``value_and_grad`` at
   grad_accum 1: the loss within 1e-4 relative, every grad's shards within
   2e-3 of its leaf's scale;
29. context parallelism (run after phase 28, before the results) — two
   ranks of the cp ring sharing the card over gloo (``chip_smoke.py
   --cp-rank``, as phase 25; every hop staged through pinned host buffers)
   on ``train_mesh_spec(2, cp=2)`` = (cp 2, data 1, model 1), through
   ``construct_hybrid_parallel_model``: llama3.2-1b-long at full width cut
   to 2 layers (``CP_LAYERS``), 1 step (2 until phase 30 came) of 2 x
   16 384 tokens in 2
   microbatches (each rank a microbatch's zig-zag half, 8 192 tokens; 32 768
   would double each rank's fp32 head), bf16 compute, fp32 masters, ZeRO-1
   (states over dp·cp), ``selective``; the losses within 5e-2 of one rank's
   full-sequence loss on the same seed-0 weights and batches (computed
   before the ranks train, and freed), each rank's K1 / K2 / K2-backward
   launches a step pinned (``cp_launches``: K1 once a ring step, in the
   forward and the recompute), the shapes K1 sees (phase 3's ring rows,
   ``cp_ring_rows``), the ring's bytes a step (``cp_ring_bytes``); peaks
   against the card, step times (gloo, no interconnect) and collectives
   logged; then fp32 at 2 x 1024 against one rank's ``value_and_grad`` at
   grad_accum 1: the loss within 1e-4 relative, every grad's shards within
   2e-3 of its leaf's scale.  Paid for by cuts in depth (phase 21's mamba2
   from 16 to 8 layers, phase 25's llama from 4 to 2) and of three fp32
   repeats (phase 25's (c), phase 26's (c), phase 28's (b));
30. pipeline x context parallelism (run after phase 29, before the
   results) — four ranks sharing the card over gloo (``chip_smoke.py
   --ppcp-rank``, as phase 25; every hop staged through pinned host
   buffers) on ``train_mesh_spec(4, pp=2, cp=2)`` = (pod 2, cp 2, data 1,
   model 1), through ``runtime.train_pp.PipelineTrainer`` with the cp ring
   inside every stage: llama3.2-1b-long at full width cut to 4 layers
   (``PPCP_LAYERS``; 2 a stage), 2 steps of 4 x 8 192 tokens in 4
   microbatches (each rank a microbatch's zig-zag half, 4 096 tokens: two
   last-stage ranks each hold one microbatch's fp32 head), bf16 compute,
   fp32 masters, ZeRO-1 (states over dp·cp), ``selective``, under (e)
   1f1b (2 windows of 2) and (f) interleaved v 2 (stage 0 holds layers 0
   and 2); the losses within 5e-2 of one rank's full-batch loss on the
   same seed-0 weights and batches (computed before the ranks train, and
   freed), each rank's K1 / K2 / K2-backward launches a step pinned
   (``ppcp_launches``: K1 once a ring step in the forward and the
   recompute, 32 a rank), the shapes K1 sees (phase 3's
   ``pipeline_context`` rows), ``max_in_flight`` at most 2, the ring's
   bytes a step and the stage hop's boundary bytes, which must be the cost
   model's ``pipeline_boundary_bytes`` (32 MiB a microbatch a hop) times
   the hops (``ppcp_boundary_bytes``); peaks per rank and their sum
   against the card, step times (gloo, no interconnect) and collectives
   logged; then (e) in fp32 at 4 x 512 against one rank's
   ``value_and_grad`` at grad_accum 1: the loss within 1e-4 relative,
   every grad's shards within 2e-3 of its leaf's scale.  Paid for by cuts
   in steps: phases 25-29 run one step a plan or case where they ran two
   (``PAR_STEPS``, ``PP_STEPS``, ``CP_STEPS``), phase 10's full and none
   policies two where they ran three (``TRAIN_POLICY_STEPS``);
31. checkpointing (run after phase 30, before the results) — llama3.2-1b
   at full width cut to 2 layers (``CKPT_LAYERS``: the canonical state is
   384 M parameters x 12 bytes of fp32 params, m and v, 4.6 GB) trained
   under ``selective`` on 4 x 4096 tokens a step in 2 microbatches (K1 and
   K2 under autograd, K2's backward kernel), every step donated: (a) 3
   steps straight; (b) 2 steps from the same seed, then (c) a synchronous
   ``checkpoint.save`` of the step-2 state (codec ``raw``, format v2),
   then ``CheckpointWriter.save_async`` of it into a second directory,
   step 3 run in place while the writer works (its snapshot is pinned host
   copies queued ahead of the step), ``close()``; a fresh model and trainer
   restore (b)'s step 2 and run step 3.  Both step-3 results — (b)'s in
   place and the restored one — must be bitwise (a)'s: the loss and every
   leaf of params, m and v.  (c)'s index, MANIFEST and blobs must be
   byte-identical to (b)'s, and the async ``blocked_seconds`` below the
   sync save's time.  Logs the bytes written, the sync save's GB/s and
   seconds, the async blocked seconds and the writer's drain, the restore
   time; K1, K2 and K2-backward launches pinned (``train_launches`` at 2
   layers, grad_accum 2, 7 steps); both directories deleted;
24. a ``{"kernels": [...]}`` line (``rmsnorm``, ``rmsnorm_gated``,
   ``rmsnorm_bwd``, ``rmsnorm_split_fwd`` and ``rmsnorm_split_bwd`` rows for
   K2, ``ssd`` and ``ssd_autograd`` for K3; a row phase 28's stages also
   run stands again for each ``pipeline_*`` path with its launches; the
   ring's K1 rows under the path ``context_parallel``, with phase 29's
   launches, and under ``pipeline_context``, with phase 30's; the llama
   training rows stand again for the path ``checkpoint`` with phase 31's
   launches), then the device line last.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
#: phase 28's llama stages (cases a-c) see phase 3's llama training rows
PP_LLAMA_PATHS = ("pipeline_a", "pipeline_b", "pipeline_c")
#: ... and so do phase 10's steps and phase 31's (a 2 x 4096 microbatch)
LLAMA_TRAIN_PATHS = ("train",) + PP_LLAMA_PATHS + ("checkpoint",)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# per (b, s, h) row of K1's output: the largest error against the fp32 plain
# version over the row's head_dim, relative to that row's largest |value| —
# 2 bf16 epsilons (2^-7 each) in bf16, so the rule scales with rows of many
# keys, whose outputs are ~1e-2
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
RESIDUAL_TOL = 1e-5
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_TOL = 1e-3                                  # x max(1, max |plain|)
SSD_CHUNK = 64
INT32_MAX = 2**31 - 1


T_START = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """Log where the run stands as a phase begins (seconds since the start)."""
    log(f"phase {phase}: begins at {time.perf_counter() - T_START:.1f} s")


def launch_counters(flash_ops, rms_ops, ssd_ops) -> dict:
    """Each kernel's launch counter: name -> (the wrapper holding it, its
    attribute).  A gated K2 call counts on ``rmsnorm`` and ``rmsnorm_gated``;
    a K2 backward call (two launches: rows, column sums) on ``rmsnorm_bwd``;
    a K3 launch of ``ssd_autograd``'s forward on ``ssd`` and
    ``ssd_autograd``."""
    return {"flash_attention_fwd": (flash_ops.flash_attention_fwd, "launches"),
            "rmsnorm": (rms_ops.rmsnorm, "launches"),
            "rmsnorm_gated": (rms_ops.rmsnorm, "gated_launches"),
            "rmsnorm_bwd": (rms_ops.rmsnorm, "backward_launches"),
            "ssd": (ssd_ops.ssd, "launches"),
            "ssd_autograd": (ssd_ops.ssd_autograd, "launches")}


def zero_counts(counters: dict) -> None:
    for obj, attr in counters.values():
        setattr(obj, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in counters.items()}


def build_report(text: str) -> tuple[list[str], list[str]]:
    """The compiler's report (``-Xptxas -v``) per source: kernels compiled,
    the most registers one uses, and every kernel that spills.  Returns the
    summary lines and the spilling kernels of K2's sources."""
    import re

    per: dict[str, list] = {}
    src = fn = None
    for line in text.splitlines():
        if line.startswith("== "):
            src = line[3:].split(" (rc")[0]
            per[src] = [0, 0, []]
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and src:
            fn = m.group(1)
            per[src][0] += 1
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and src and fn and (int(m.group(1)) or int(m.group(2))):
            per[src][2].append(f"{fn}: {m.group(0)}")
        m = re.search(r"Used (\d+) registers", line)
        if m and src:
            per[src][1] = max(per[src][1], int(m.group(1)))
    lines, k2_spills = [], []
    for src, (n, regs, spills) in per.items():
        lines.append(f"{src}: {n} kernels, at most {regs} registers a thread, "
                     f"{len(spills)} spilling")
        lines += [f"  spills: {x}" for x in spills]
        if "rmsnorm" in src:
            k2_spills += spills
    return lines, k2_spills


# ---------------------------------------------------------------- timing

def device_ms(fn, torch, inner: int = 10, reps: int = 15) -> float:
    """Median device time of one call of ``fn``.  The launches are queued
    behind a device-side sleep longer than their enqueue time, so the CUDA
    events bracket back-to-back device work, not host overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2.0 * host_s, 2e-4) * 2.0e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 3

def flash_case(torch, gen, *, B, Sq, Sk, H, hd, dtype, KV=None, q_off=None, kv_len=None,
               causal=True, k_shift=None, path="llama"):
    """Inputs of one flash-attention call, as the model's dispatch builds
    them: compact k/v with ``KV`` heads (default H); with ``q_off``/``kv_len``
    the decode positions (``q_pos = q_off + arange(Sq)``, keys at or past
    ``kv_len`` at INT32_MAX); with ``k_shift`` index positions whose keys sit
    ``k_shift`` later, so the first ``k_shift`` rows see no key."""
    KV = KV or H
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    q_pos = k_pos = None
    if q_off is not None:
        q_pos = (q_off.reshape(-1, 1) + torch.arange(Sq, device="cuda")).to(torch.int32)
        q_pos = q_pos.expand(B, Sq).contiguous()
        k_pos = torch.arange(Sk, dtype=torch.int32, device="cuda").expand(B, Sk)
        k_pos = torch.where(torch.arange(Sk, device="cuda")[None] < kv_len[:, None], k_pos,
                            torch.full((), INT32_MAX, dtype=torch.int32, device="cuda"))
        k_pos = k_pos.contiguous()
    elif k_shift is not None:
        q_pos = torch.arange(Sq, dtype=torch.int32, device="cuda")
        k_pos = torch.arange(Sk, dtype=torch.int32, device="cuda") + k_shift
    return dict(q=q, k=k, v=v, causal=causal, q_pos=q_pos, k_pos=k_pos, path=path)


def flash_mask(torch, c):
    """The boolean (B, 1, Sq, Sk) mask of a case (True = attend)."""
    B, Sq = c["q"].shape[:2]
    Sk = c["k"].shape[1]
    if not c["causal"]:
        return torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device="cuda")
    if c["q_pos"] is None:
        qp = torch.arange(Sq, device="cuda").expand(B, Sq)
        kp = torch.arange(Sk, device="cuda").expand(B, Sk)
    else:
        qp = c["q_pos"].long().expand(B, Sq)
        kp = c["k_pos"].long().expand(B, Sk)
    return (kp[:, None, :] <= qp[:, :, None])[:, None]


def flash_bound(torch, c) -> tuple[float, str]:
    """Bytes: q and out once, positions once, and the compact K/V rows (KV
    heads, as the kernel is given them) that some row of the batch attends
    to; operations: 4·hd per unmasked (row, key) pair and query head — what
    this run's data needs."""
    q = c["q"]
    B, Sq, H, hd = q.shape
    KV = c["k"].shape[2]
    e = q.element_size()
    mask = flash_mask(torch, c)[:, 0]                      # (B, Sq, Sk)
    keys_needed = int(mask.any(dim=1).sum())
    pairs = int(mask.sum())
    nbytes = 2 * B * Sq * H * hd * e + 2 * keys_needed * KV * hd * e
    if c["q_pos"] is not None:
        nbytes += 4 * (c["q_pos"].numel() + c["k_pos"].numel())
    flops = 4.0 * hd * H * pairs
    return bound(nbytes, flops, str(q.dtype).replace("torch.", ""))


def flash_row_err(out, ref32) -> float:
    """The largest per-row error of ``out`` against ``ref32`` (both
    (B, S, H, hd)), each row's error over the row's largest |ref32|."""
    err = (out.float() - ref32).abs().amax(dim=-1)
    return float((err / ref32.abs().amax(dim=-1).clamp_min(1e-30)).max())


def check_flash(torch, flash_ops, flash_ref, gen):
    """Every flash-attention case against the plain version; returns the
    JSON rows of the timed bf16 cases: the two llama serving shapes (compact
    KV = 8), the g = 5 / hd 112 check shapes, the llama training shape,
    zamba2's and moonshot's serving shapes and moonshot's training shape,
    whisper's, and internvl2's (g = 6) serving and training shapes,
    zamba2's training shape, and each rank's shape in the parallel rig
    (phase 25): tp 2 (16 query and 4 KV heads, a microbatch's 2 sequences)
    and dp 2 (32 and 8 heads, 1 sequence); a moonshot rank's in phase 26:
    ep 2 and dp 2 (16 heads, 1 sequence), tp 2 (8 heads, 2 sequences); a
    rank's in phase 27: zamba2's shared block at 16 heads (b), whisper's
    encoder, cross- and self-attention at 3 heads over 32 windows (c); a
    rank's three K1 calls in phase 29's cp ring (``cp_ring_rows``), the
    causal one at the rank's zig-zag positions, and in phase 30's ring
    inside a pipeline stage (path ``pipeline_context``)."""
    rows = []
    cases = [("train causal B2 S4096 H32 KV8 hd64 bfloat16", True, flash_case(
        torch, gen, B=2, Sq=4096, Sk=4096, H=32, KV=8, hd=64, dtype=torch.bfloat16,
        path=LLAMA_TRAIN_PATHS))]
    # the many-row split path: past 256 key tiles, blocks of 64 rows split too
    long_kv = torch.tensor([20000], device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for Sq in (64, 256):
            cases.append((f"many-row split causal B1 Sq{Sq} Sk20000 H32 KV8 hd64 {name}", False,
                          flash_case(torch, gen, B=1, Sq=Sq, Sk=20000, H=32, KV=8, hd=64,
                                     dtype=dtype)))
        cases.append((f"many-row split q offset 19744 B1 Sq256 Sk20000 H32 KV8 hd64 {name}",
                      False, flash_case(torch, gen, B=1, Sq=256, Sk=20000, H=32, KV=8, hd=64,
                                        dtype=dtype, q_off=long_kv - 256, kv_len=long_kv)))
        cases.append((f"many-row split non-causal B1 Sq64 Sk20000 H32 KV8 hd64 {name}", False,
                      flash_case(torch, gen, B=1, Sq=64, Sk=20000, H=32, KV=8, hd=64,
                                 dtype=dtype, causal=False)))
    kv = torch.tensor([768], device="cuda")
    lens = torch.randint(1, 1026, (8,), generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        cases.append((f"prefill chunk B1 Sq256 Sk1280 H32 KV8 hd64 {name}", True,
                      flash_case(torch, gen, B=1, Sq=256, Sk=1280, H=32, KV=8, hd=64,
                                 dtype=dtype, q_off=torch.tensor([512], device="cuda"),
                                 kv_len=kv)))
        cases.append((f"decode B8 Sq1 Sk1025 H32 KV8 hd64 {name}", True, flash_case(
            torch, gen, B=8, Sq=1, Sk=1025, H=32, KV=8, hd=64, dtype=dtype, q_off=lens - 1,
            kv_len=lens)))
        cases.append((f"causal B1 S256 H32 KV8 hd64 {name}", False, flash_case(
            torch, gen, B=1, Sq=256, Sk=256, H=32, KV=8, hd=64, dtype=dtype)))
        cases.append((f"non-causal B2 Sq200 Sk333 H4 hd128 {name}", False, flash_case(
            torch, gen, B=2, Sq=200, Sk=333, H=4, hd=128, dtype=dtype, causal=False)))
        # g = 5 (qwen3-14b heads) and hd 112 (zamba2-7b's shared attention)
        g5 = torch.randint(1, 1026, (8,), generator=gen, device="cuda")
        cases.append((f"g5 decode B8 Sq1 Sk1025 H40 KV8 hd128 {name}", True, flash_case(
            torch, gen, B=8, Sq=1, Sk=1025, H=40, KV=8, hd=128, dtype=dtype, q_off=g5 - 1,
            kv_len=g5)))
        cases.append((f"hd112 causal B1 S512 H32 KV32 {name}", True, flash_case(
            torch, gen, B=1, Sq=512, Sk=512, H=32, hd=112, dtype=dtype)))
        # edges: fully masked rows, kv_len 1 and a 64-key tile edge +-1, Sk % 64 != 0,
        # and a long decode whose keys split over many blocks
        cases.append((f"masked rows B2 Sq16 Sk90 H8 KV2 hd32 {name}", False, flash_case(
            torch, gen, B=2, Sq=16, Sk=90, H=8, KV=2, hd=32, dtype=dtype, k_shift=5)))
        edge = torch.tensor([1, 63, 64, 65, 127, 128, 129, 0], device="cuda")
        cases.append((f"kv_len 1/63/64/65/127/128/129/0 B8 Sq1 Sk130 H32 KV8 hd64 {name}",
                      False, flash_case(torch, gen, B=8, Sq=1, Sk=130, H=32, KV=8, hd=64,
                                       dtype=dtype, q_off=edge - 1, kv_len=edge)))
        cases.append((f"ragged causal B2 Sq37 Sk100 H40 KV8 hd128 {name}", False, flash_case(
            torch, gen, B=2, Sq=37, Sk=100, H=40, KV=8, hd=128, dtype=dtype,
            q_off=torch.tensor([63, 10], device="cuda"),
            kv_len=torch.tensor([100, 47], device="cuda"))))
        long_len = torch.tensor([5000], device="cuda")
        cases.append((f"split-K decode B1 Sq1 Sk8192 H32 KV8 hd64 kv_len 5000 {name}", False,
                      flash_case(torch, gen, B=1, Sq=1, Sk=8192, H=32, KV=8, hd=64, dtype=dtype,
                                 q_off=long_len - 1, kv_len=long_len)))
    # zamba2-7b's shared attention: hd 112, one query head per KV head; the
    # decode rows' kv_len at and around the 2048-key tile edge
    z_len = torch.tensor([2048, 2049, 2079, 2080], device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        cases.append((f"zamba2 decode B4 Sq1 Sk2080 H32 KV32 hd112 kv_len 2048/2049/2079/2080 "
                      f"{name}", True, flash_case(torch, gen, B=4, Sq=1, Sk=2080, H=32, hd=112,
                                                  dtype=dtype, q_off=z_len - 1, kv_len=z_len,
                                                  path="zamba2")))
        cases.append((f"zamba2 prefill causal B4 S2048 H32 KV32 hd112 {name}", True, flash_case(
            torch, gen, B=4, Sq=2048, Sk=2048, H=32, hd=112, dtype=dtype, path="zamba2")))
    # moonshot-v1-16b-a3b: hd 128 with one query head per KV head, its decode
    # (kv_len at and around the 2048-key tile edge), prefill and training shapes
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        cases.append((f"moonshot decode B4 Sq1 Sk2080 H16 KV16 hd128 kv_len 2048/2049/2079/2080 "
                      f"{name}", True, flash_case(torch, gen, B=4, Sq=1, Sk=2080, H=16, hd=128,
                                                  dtype=dtype, q_off=z_len - 1, kv_len=z_len,
                                                  path="moonshot")))
        cases.append((f"moonshot prefill causal B4 S2048 H16 KV16 hd128 {name}", True,
                      flash_case(torch, gen, B=4, Sq=2048, Sk=2048, H=16, hd=128, dtype=dtype,
                                 path="moonshot")))
    cases.append(("moonshot train causal B2 S4096 H16 KV16 hd128 bfloat16", True, flash_case(
        torch, gen, B=2, Sq=4096, Sk=4096, H=16, hd=128, dtype=torch.bfloat16,
        path="moonshot_train")))
    # whisper-tiny (H = KV 6, hd 64) at its serving and training shapes: the
    # encoder's non-causal self-attention over 1 500 frames (23 key tiles and
    # a ragged 28), the cross-attention (Sq != Sk, no mask) at prefill, in
    # training and at decode (split-K, no positions), and the decoder's self
    # decode over a 448-key cache at per-slot kv_len
    w_len = torch.randint(5, 229, (WHISPER_BATCH,), generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for label, B, Sq, Sk, path in (("encoder", WHISPER_BATCH, 1500, 1500, "whisper"),
                                       ("cross prefill", WHISPER_BATCH, 4, 1500, "whisper"),
                                       ("cross train", WHISPER_MICRO, 448, 1500,
                                        "whisper_train"),
                                       ("cross decode", WHISPER_BATCH, 1, 1500, "whisper")):
            cases.append((f"whisper {label} non-causal B{B} Sq{Sq} Sk{Sk} H6 KV6 hd64 {name}",
                          True, flash_case(torch, gen, B=B, Sq=Sq, Sk=Sk, H=6, hd=64,
                                           dtype=dtype, causal=False, path=path)))
        cases.append((f"whisper self decode B{WHISPER_BATCH} Sq1 Sk448 H6 KV6 hd64 per-slot "
                      f"kv_len {name}", True, flash_case(
                          torch, gen, B=WHISPER_BATCH, Sq=1, Sk=WHISPER_CTX, H=6, hd=64,
                          dtype=dtype, q_off=w_len - 1, kv_len=w_len, path="whisper")))
    # internvl2-26b (48 query heads over 8 KV heads, g = 6, hd 128): the
    # prefill of 8 turns of 256 prefix + 1 024 text positions (a 64-row tile
    # spans 10 2/3 positions), a decode step over the 1 344-row cache at the
    # serve run's per-slot kv_len, and the training shape; zamba2's training
    # shape (hd 112, one query head per KV head)
    v_len = torch.randint(VLM_PREFIX + VLM_TEXT + 1, VLM_CTX + 1, (VLM_BATCH,), generator=gen,
                          device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        S = VLM_PREFIX + VLM_TEXT
        cases.append((f"internvl2 prefill causal B{VLM_BATCH} S{S} H48 KV8 hd128 {name}", True,
                      flash_case(torch, gen, B=VLM_BATCH, Sq=S, Sk=S, H=48, KV=8, hd=128,
                                 dtype=dtype, path="internvl2")))
        cases.append((f"internvl2 decode B{VLM_BATCH} Sq1 Sk{VLM_CTX} H48 KV8 hd128 per-slot "
                      f"kv_len {name}", True, flash_case(
                          torch, gen, B=VLM_BATCH, Sq=1, Sk=VLM_CTX, H=48, KV=8, hd=128,
                          dtype=dtype, q_off=v_len - 1, kv_len=v_len, path="internvl2")))
    cases.append((f"internvl2 train causal B2 S{TRAIN_SEQ} H48 KV8 hd128 bfloat16", True,
                  flash_case(torch, gen, B=2, Sq=TRAIN_SEQ, Sk=TRAIN_SEQ, H=48, KV=8, hd=128,
                             dtype=torch.bfloat16, path="internvl2_train")))
    cases.append((f"zamba2 train causal B2 S{SSM_TRAIN_SEQ} H32 KV32 hd112 bfloat16", True,
                  flash_case(torch, gen, B=2, Sq=SSM_TRAIN_SEQ, Sk=SSM_TRAIN_SEQ, H=32, hd=112,
                             dtype=torch.bfloat16, path="zamba2_train")))
    for par, B, H, KV in (("tp2", 2, 16, 4), ("dp2", 1, 32, 8)):
        cases.append((f"parallel {par} causal B{B} S{PAR_SEQ} H{H} KV{KV} hd64 bfloat16", True,
                      flash_case(torch, gen, B=B, Sq=PAR_SEQ, Sk=PAR_SEQ, H=H, KV=KV, hd=64,
                                 dtype=torch.bfloat16, path=f"parallel_{par}")))
    # phase 26: a moonshot rank's local heads, (a) ep 2 and (c) dp 2 / (b) tp 2
    for par, B, H in (("ep2/dp2", 1, 16), ("tp2", 2, 8)):
        cases.append((f"moe parallel {par} causal B{B} S{PAR_SEQ} H{H} KV{H} hd128 bfloat16",
                      True, flash_case(torch, gen, B=B, Sq=PAR_SEQ, Sk=PAR_SEQ, H=H, hd=128,
                                       dtype=torch.bfloat16,
                                       path="moe_parallel_b1" if B == 1 else "moe_parallel_tp2")))
    # phase 27: a rank's local heads at tp 2, (b) zamba2's shared block and
    # (c) whisper's encoder, cross- and decoder self-attention
    cases.append((f"ssm parallel (b) causal B2 S{SSM_TRAIN_SEQ} H16 KV16 hd112 bfloat16", True,
                  flash_case(torch, gen, B=2, Sq=SSM_TRAIN_SEQ, Sk=SSM_TRAIN_SEQ, H=16, hd=112,
                             dtype=torch.bfloat16, path="ssm_parallel_b")))
    for part, Sq, Sk, causal in (("encoder non-causal", SPAR_FRAMES, SPAR_FRAMES, False),
                                 ("cross non-causal", SPAR_TEXT, SPAR_FRAMES, False),
                                 ("self causal", SPAR_TEXT, SPAR_TEXT, True)):
        cases.append((f"ssm parallel (c) whisper {part} B{WHISPER_MICRO} Sq{Sq} Sk{Sk} H3 KV3 "
                      "hd64 bfloat16", True, flash_case(
                          torch, gen, B=WHISPER_MICRO, Sq=Sq, Sk=Sk, H=3, hd=64,
                          dtype=torch.bfloat16, causal=causal, path="ssm_parallel_c")))
    # phase 29: a rank's K1 calls in the cp ring at llama3.2-1b-long's heads,
    # step 0 at rank 0's zig-zag positions over the 16 384-token sequence
    from repro_torch.parallel.context import zigzag_positions

    for B, Sq, Sk, causal in cp_ring_rows():
        c = flash_case(torch, gen, B=B, Sq=Sq, Sk=Sk, H=32, KV=8, hd=64, dtype=torch.bfloat16,
                       causal=causal, path="context_parallel")
        what = "step 0 causal at zig-zag positions" if causal else "later step non-causal"
        if causal:
            c["q_pos"] = c["k_pos"] = zigzag_positions(CP_SEQ, CP_MESH[0][0], 0, "cuda")
        cases.append((f"context parallel {what} B{B} Sq{Sq} Sk{Sk} H32 KV8 hd64 bfloat16",
                      True, c))
    # phase 30: a rank's K1 calls in the ring inside a pipeline stage, step 0
    # at rank 0's zig-zag positions over the 8 192-token sequence
    for B, Sq, Sk, causal in cp_ring_rows(PPCP_SEQ, PPCP_BATCH // PPCP_ACCUM):
        c = flash_case(torch, gen, B=B, Sq=Sq, Sk=Sk, H=32, KV=8, hd=64, dtype=torch.bfloat16,
                       causal=causal, path="pipeline_context")
        what = "step 0 causal at zig-zag positions" if causal else "later step non-causal"
        if causal:
            c["q_pos"] = c["k_pos"] = zigzag_positions(PPCP_SEQ, PPCP_MESH[0][1], 0, "cuda")
        cases.append((f"pipeline context {what} B{B} Sq{Sq} Sk{Sk} H32 KV8 hd64 bfloat16",
                      True, c))
    for label, timed, c in cases:
        name = str(c["q"].dtype).replace("torch.", "")
        kw = dict(causal=c["causal"], q_pos=c["q_pos"], k_pos=c["k_pos"])
        out, m, l = flash_ops.flash_attention_fwd(c["q"], c["k"], c["v"], **kw,
                                                  return_residuals=True)
        ref, rm, rl = flash_ref.flash_attention_fwd(c["q"], c["k"], c["v"], **kw,
                                                    return_residuals=True)
        ref32 = ref.float() if name == "float32" else flash_ref.flash_attention_fwd(
            c["q"].float(), c["k"].float(), c["v"].float(), **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[name]
        ok = bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))
        row_err = flash_row_err(out, ref32)
        res_ok = bool(torch.allclose(m, rm, atol=RESIDUAL_TOL, rtol=RESIDUAL_TOL)
                      and torch.allclose(l, rl, atol=RESIDUAL_TOL, rtol=RESIDUAL_TOL))
        log(f"K1 flash_attention_fwd [{label}] max_abs_err {err:.3e} (tol {tol}) "
            f"row err vs fp32 plain {row_err:.3e} of the row's max (tol "
            f"{FLASH_ROW_TOL[name]:.3e}) residuals {'ok' if res_ok else 'MISMATCH'}")
        require(ok, f"flash attention disagrees with its plain version: {label}")
        require(row_err <= FLASH_ROW_TOL[name],
                f"flash attention rows disagree with the fp32 plain version: {label}")
        require(res_ok, f"flash attention residuals disagree: {label}")
        del ref32
        if not (timed and name == "bfloat16"):
            continue
        q, k, v = c["q"], c["k"], c["v"]
        ms = device_ms(lambda: flash_ops.flash_attention_fwd(q, k, v, **kw), torch)
        # the plain version at 3 calls a group, 7 groups: it takes up to 43 ms a call
        plain = device_ms(lambda: flash_ref.flash_attention_fwd(q, k, v, **kw), torch, inner=3,
                          reps=7)
        # a plain causal mask (the training shape, a full prefill) is SDPA's
        # own ``is_causal`` and a non-causal case takes no mask (both reach
        # its flash backend); the other rows pass the case's boolean mask
        plain_causal = c["causal"] and c["q_pos"] is None and q.shape[1] == k.shape[1]
        sdpa_kw = (dict(is_causal=True) if plain_causal else
                   dict(attn_mask=flash_mask(torch, c)) if c["causal"] else {})
        g = q.shape[2] // k.shape[2]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ke, ve = (t.repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
        lib_gqa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_kw), torch)
        lib_exp = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, ke, ve, **sdpa_kw), torch)
        b_ms, b_by = flash_bound(torch, c)
        log(f"K1 [{label}] kernel {ms:.5f} ms  plain {plain:.4f} ms  sdpa (compact, "
            f"enable_gqa) {lib_gqa:.5f} ms  sdpa (expanded heads) {lib_exp:.5f} ms  "
            f"bound {b_ms:.6f} ms ({b_by})")
        rows.append(dict(label=label, path=c["path"], max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=min(lib_gqa, lib_exp), bound_ms=b_ms, bound_by=b_by))
        del q, k, v, qt, kt, vt, ke, ve
    cases.clear()
    torch.cuda.empty_cache()
    return rows


def check_flash_autograd(torch, flash_ops, flash_ref, gen):
    """``flash_attention`` under autograd (K1 forward, block-by-block
    recompute backward) against autograd through K1's plain version, in
    fp32: out, dq, dk, dv within 2e-3 of their scale.  Cases: the many-row
    split path (causal, S 20 000), whisper's cross-attention at its
    training shape (non-causal, Sq 448 over Sk 1 500, whose recompute walks
    two key blocks, the second ragged), zamba2's shared block at its
    training shape (hd 112) and internvl2's heads (g = 6, hd 128); a
    phase 27 rank's (path ``ssm_parallel_b`` / ``_c``): zamba2's shared
    block at 16 heads, whisper's encoder and cross-attention at 3."""
    for label, B, Sq, Sk, H, KV, hd, causal in (
            ("split path causal", 1, 20000, 20000, 2, 1, 64, True),
            ("whisper cross train non-causal", WHISPER_MICRO, 448, 1500, 6, 6, 64, False),
            ("zamba2 train causal", 2, SSM_TRAIN_SEQ, SSM_TRAIN_SEQ, 32, 32, 112, True),
            ("internvl2 heads causal", 1, 1024, 1024, 48, 8, 128, True),
            ("ssm_parallel_b: zamba2 rank causal", 2, SSM_TRAIN_SEQ, SSM_TRAIN_SEQ, 16, 16, 112,
             True),
            ("ssm_parallel_c: whisper rank encoder non-causal", WHISPER_MICRO, SPAR_FRAMES,
             SPAR_FRAMES, 3, 3, 64, False),
            ("ssm_parallel_c: whisper rank cross non-causal", WHISPER_MICRO, SPAR_TEXT,
             SPAR_FRAMES, 3, 3, 64, False)):
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
        k, v = (torch.randn((B, Sk, KV, hd), generator=gen, device="cuda") for _ in "kv")
        cot = torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
        results = []
        for fn in (flash_ops.flash_attention, flash_ref.flash_attention_fwd):
            tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(tq, tk, tv, causal=causal)
            results.append((out, *torch.autograd.grad(out, (tq, tk, tv), cot)))
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dq", "dk", "dv"), *results):
            a, b = a.detach(), b.detach()
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            log(f"K1 flash_attention autograd [{label} B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} "
                f"float32] {name} max_abs_err {err:.3e} (tol 2e-3 x {scale:.3e})")
            require(err <= 2e-3 * scale, f"autograd flash_attention {name} disagrees with the "
                    f"plain version: {label}")
        del results, q, k, v, cot
        torch.cuda.empty_cache()


def misaligned_view(torch, t):
    """``t``'s values in a view one element past a 16-byte boundary (the
    layout ``x.flatten()[1:]`` gives): K2 takes its scalar template."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def _rms_template(rms_ops, x, scale, *more, **kw) -> str:
    """The K2 template a call takes (a fresh output is 16-byte aligned)."""
    return rms_ops._template(x.shape[-1], x.dtype, x.data_ptr(), scale.data_ptr(),
                             *(t.data_ptr() for t in more), **kw).describe()


def _rms_close(torch, out, ref, tol) -> tuple[float, bool]:
    err = float((out.float() - ref.float()).abs().max())
    return err, bool(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol))


def check_rmsnorm(torch, rms_ops, rms_ref, gen):
    """K2's forward at every template — vector packs from 1 to 8 a thread,
    rows per warp to rows over warps, the two-pass loop, the scalar template
    on an odd width and on misaligned views — against its plain version; the
    timed bf16 rows carry the path they belong to (llama: decode 8 x 2048,
    prefill chunk 256 x 2048; mamba2: the layer norms at prefill 8192 x 2560
    and decode 4 x 2560; train: a microbatch of 2 x 4096 rows x 2048;
    zamba2: the prefill's layer norms 8192 x 3584; whisper: the encoder's
    norms at prefill, 16 windows x 1500 frames x 384, and a decode step's
    16 x 384; whisper_train: a microbatch's encoder norms, 32 x 1500 rows
    x 384; internvl2: its norms at prefill, 8 x 1 280 rows x 6 144;
    internvl2_train: a microbatch of 2 x 4 096 rows x 6 144; mamba2_train
    and zamba2_train: a microbatch's 2 x 2 048 rows at the layer norm's
    width and at the gate norm's, which training runs ungated, composed
    under autograd; parallel: a rank's 4 096 rows x 2048 in the parallel
    rig, sequence-sharded under tp 2 + sp or a dp 2 rank's sequence, with
    the fp32 master scale the model passes); "check" rows are timed
    and logged but belong to no path (the gate norms' widths 5120 and 7168,
    which the models now run gated)."""
    rows = []
    shapes = [((8, 2048), "llama"), ((256, 2048), "llama"), ((8192, 2560), "mamba2"),
              ((4, 2560), "mamba2"), ((8192, 2048), LLAMA_TRAIN_PATHS),
              ((8192, 3584), "zamba2"),
              ((24000, 384), "whisper"), ((16, 384), "whisper"), ((48000, 384), "whisper_train"),
              ((10240, 6144), "internvl2"), ((8192, 6144), "internvl2_train"),
              ((4096, 2560), ("mamba2_train", "pipeline_d")),
              ((4096, 5120), ("mamba2_train", "pipeline_d")),
              ((4096, 3584), "zamba2_train"), ((4096, 7168), "zamba2_train"),
              ((4096, 2048, "fp32 scale"), "parallel"), ((8192, 5120), "check"),
              ((8192, 7168), "check"), ((8192, 64), None),
              ((32768, 128), None), ((64, 14336), None), ((6, 40000), None), ((7, 333), None),
              ((8192, 3584, "misaligned"), None), ((300, 1000, "misaligned"), None)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for shape, path in shapes:
            mis, f32_scale = shape[-1] == "misaligned", shape[-1] == "fp32 scale"
            shape = shape[:2]
            x = (3.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            scale = torch.randn(shape[-1:], generator=gen, device="cuda").to(
                torch.float32 if f32_scale else dtype)
            if mis:
                x = misaligned_view(torch, x)
            out = rms_ops.rmsnorm(x, scale, 1e-5)
            ref = rms_ref.rmsnorm_reference(x, scale, 1e-5)
            torch.cuda.synchronize()
            tol = RMSNORM_TOL[name]
            err, ok = _rms_close(torch, out, ref, tol)
            label = (f"{shape[0]}x{shape[1]} {name}{' misaligned view' if mis else ''}"
                     f"{' scale float32' if f32_scale else ''}")
            log(f"K2 rmsnorm [{label}] template {_rms_template(rms_ops, x, scale)} "
                f"max_abs_err {err:.3e} (tol {tol})")
            require(ok, f"rmsnorm disagrees with its plain version: {label}")
            if not (path and name == "bfloat16"):
                continue
            ms = device_ms(lambda: rms_ops.rmsnorm(x, scale, 1e-5), torch)
            plain = device_ms(lambda: rms_ref.rmsnorm_reference(x, scale, 1e-5), torch)
            lib = device_ms(lambda: torch.nn.functional.rms_norm(
                x, shape[-1:], weight=scale, eps=1e-5), torch)
            e = x.element_size()
            b_ms, b_by = bound(2 * x.numel() * e + scale.numel() * scale.element_size(),
                               4.0 * x.numel(), name)
            log(f"K2 [{label}] kernel {ms:.5f} ms  plain {plain:.4f} ms  "
                f"F.rms_norm {lib:.5f} ms  bound {b_ms:.6f} ms ({b_by}, {100 * b_ms / ms:.1f} %)")
            if path == "check":
                continue
            rows.append(dict(label=label, path=path, max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_rmsnorm_gated(torch, rms_ops, rms_ref, gen):
    """K2's gated forward ``rmsnorm(x * silu(z))`` against
    ``gated_rmsnorm_reference`` in bf16 and fp32 at the Mamba2 gate norm's
    shapes (mamba2 d_inner 5120, zamba2 7168; prefill 8192 rows, decode 4),
    an odd width and a misaligned gate.  Timed bf16 rows: no single PyTorch
    call computes the gate (``library_ms`` null); the unfused composition
    the model ran before (``F.silu``, the product, K2: three launches) is
    timed beside them."""
    F = torch.nn.functional
    rows = []
    shapes = [((8192, 5120), "mamba2"), ((8192, 7168), "zamba2"), ((4, 5120), "mamba2"),
              ((4, 7168), "zamba2"), ((7, 333), None), ((4096, 5120, "misaligned"), None)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for shape, path in shapes:
            mis = shape[-1] == "misaligned"
            shape = shape[:2]
            x = (2.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            z = (2.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            scale = (1 + 0.3 * torch.randn(shape[-1:], generator=gen, device="cuda")).to(dtype)
            if mis:
                z = misaligned_view(torch, z)
            out = rms_ops.rmsnorm(x, scale, 1e-5, gate=z)
            ref = rms_ref.gated_rmsnorm_reference(x, z, scale, 1e-5)
            torch.cuda.synchronize()
            tol = RMSNORM_TOL[name]
            err, ok = _rms_close(torch, out, ref, tol)
            label = f"{shape[0]}x{shape[1]} {name}{' misaligned gate' if mis else ''}"
            log(f"K2 rmsnorm gated [{label}] template "
                f"{_rms_template(rms_ops, x, scale, z, gated=True)} max_abs_err {err:.3e} "
                f"(tol {tol})")
            require(ok, f"gated rmsnorm disagrees with its plain version: {label}")
            if not (path and name == "bfloat16"):
                continue
            ms = device_ms(lambda: rms_ops.rmsnorm(x, scale, 1e-5, gate=z), torch)
            plain = device_ms(lambda: rms_ref.gated_rmsnorm_reference(x, z, scale, 1e-5), torch)
            unfused = device_ms(lambda: rms_ops.rmsnorm(x * F.silu(z), scale, 1e-5), torch)
            e = x.element_size()
            b_ms, b_by = bound(3 * x.numel() * e + scale.numel() * e, 9.0 * x.numel(), name)
            log(f"K2 gated [{label}] kernel {ms:.5f} ms  plain {plain:.4f} ms  unfused "
                f"(F.silu, product, K2) {unfused:.5f} ms  bound {b_ms:.6f} ms ({b_by}, "
                f"{100 * b_ms / ms:.1f} %)")
            rows.append(dict(label=label, path=path, max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def check_rmsnorm_backward(torch, rms_ops, rms_ref, gen):
    """K2's backward kernel against ``rmsnorm_backward_reference`` on the
    same inputs: dx at the forward's tolerances of its scale, an fp32 dscale
    within 1e-4 of its scale, dscale and dx bitwise equal over two calls.
    Cases: the training shape 8192 x 2048 (bf16 x, fp32 master scale; and
    fp32), 8192 x 3584, qk-norm rows 32768 x 128, whisper's encoder rows of
    a microbatch 48000 x 384, internvl2's 8192 x 6144, mamba2's layer norm
    and the Mamba2 gate norms of a training microbatch (4096 x 2560, 4096 x
    5120 and 4096 x 7168), a parallel-rig rank's 4096 x 2048 (phase 25),
    the pipeline's final norms on the fp32 boundary output (8192 x 2048 and
    4096 x 2560 fp32: the latter takes the fp32 two-pass template), an odd
    width, a misaligned view (the scalar two-pass template).  Timed rows
    (each with its paths; a row of a path carries that path's launches, as
    every row does): the plain
    backward (``plain_ms``) and, as ``library_ms``, the backward of
    ``F.rms_norm`` on the same inputs through ``torch.autograd.grad``."""
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    cases = [((8192, 2048), bf16, f32, False, LLAMA_TRAIN_PATHS),
             ((8192, 3584), bf16, f32, False, "train"), ((32768, 128), bf16, f32, False, "train"),
             ((48000, 384), bf16, f32, False, "whisper_train"),
             ((8192, 6144), bf16, f32, False, "internvl2_train"),
             ((4096, 2560), bf16, f32, False, ("mamba2_train", "pipeline_d")),
             ((4096, 5120), bf16, f32, False, ("mamba2_train", "pipeline_d")),
             ((4096, 7168), bf16, f32, False, "zamba2_train"),
             ((4096, 2048), bf16, f32, False, "parallel"),
             ((8192, 2048), f32, f32, False, PP_LLAMA_PATHS),
             ((4096, 2560), f32, f32, False, "pipeline_d"), ((300, 333), f32, f32, False, None),
             ((8192, 2048), bf16, f32, True, None)]
    for shape, dtype, sdtype, mis, path in cases:
        name = str(dtype).replace("torch.", "")
        x = (3.0 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
        scale = (1 + 0.3 * torch.randn(shape[-1:], generator=gen, device="cuda")).to(sdtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if mis:
            x, g = misaligned_view(torch, x), misaligned_view(torch, g)
        dx, ds = rms_ops.rmsnorm_backward(x, scale, g, 1e-5)
        dx2, ds2 = rms_ops.rmsnorm_backward(x, scale, g, 1e-5)
        rdx, rds = rms_ref.rmsnorm_backward_reference(x, scale, g, 1e-5)
        torch.cuda.synchronize()
        err_dx = float((dx.float() - rdx.float()).abs().max())
        err_ds = float((ds.float() - rds.float()).abs().max())
        tol_dx = RMSNORM_TOL[name] * max(1.0, float(rdx.float().abs().max()))
        tol_ds = 1e-4 * float(rds.float().abs().max())
        same = bool(torch.equal(ds, ds2) and torch.equal(dx, dx2))
        label = (f"{shape[0]}x{shape[1]} x {name} scale {str(sdtype).replace('torch.', '')}"
                 f"{' misaligned view' if mis else ''}")
        tpl = rms_ops._template(shape[-1], dtype, x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                                backward=True)
        grid = rms_ops._bwd_grid(x.device.index, shape[0], shape[-1],
                                 rms_ops._DTYPE_CODES[dtype], rms_ops._DTYPE_CODES[sdtype], tpl)
        log(f"K2 rmsnorm backward [{label}] template {tpl.describe()}, {grid} blocks "
            f"(dscale partial rows): dx max_abs_err {err_dx:.3e} (tol {tol_dx:.3e}) dscale "
            f"{err_ds:.3e} (tol {tol_ds:.3e}); two calls bitwise equal: {same}")
        require(err_dx <= tol_dx and err_ds <= tol_ds,
                f"rmsnorm backward disagrees with its plain version: {label}")
        require(same, f"rmsnorm backward is not deterministic: {label}")
        if path is None:
            continue
        ms = device_ms(lambda: rms_ops.rmsnorm_backward(x, scale, g, 1e-5), torch)
        plain = device_ms(lambda: rms_ref.rmsnorm_backward_reference(x, scale, g, 1e-5), torch,
                          inner=3, reps=7)
        libs = {}
        for wname, w in (("same inputs", scale), ("weight in x's dtype", scale.to(dtype))):
            xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
            y = F.rms_norm(xr, shape[-1:], weight=wr, eps=1e-5)
            libs[wname] = device_ms(lambda: torch.autograd.grad(y, (xr, wr), g,
                                                                retain_graph=True),
                                    torch, inner=3, reps=7)
            del xr, wr, y
        e, es = x.element_size(), scale.element_size()
        b_ms, b_by = bound(3 * x.numel() * e + 2 * scale.numel() * es, 10.0 * x.numel(), name)
        lib, fused = libs["same inputs"], libs["weight in x's dtype"]
        log(f"K2 backward [{label}] kernel {ms:.5f} ms  plain {plain:.4f} ms  F.rms_norm "
            f"backward {lib:.5f} ms (weight in x's dtype, fused: {fused:.5f} ms)  bound "
            f"{b_ms:.6f} ms ({b_by}, {100 * b_ms / ms:.1f} %)")
        rows.append(dict(label=label, path=path, max_abs_err=max(err_dx, err_ds), ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by))
        del x, g, dx, dx2, rdx
    torch.cuda.empty_cache()
    return rows


def check_rmsnorm_split(torch, rms_ops, rms_ref, gen):
    """K2's split-row form (phase 27's gate norms: 4096 rows of mamba2's
    d_inner 5120 and zamba2's 7168, split over two ranks) in bf16 and fp32,
    no process group: each half's pass 1, the two sums added by hand, each
    half's pass 2, against the plain passes (fp32 1e-5, bf16 2e-2, atol
    and rtol, as the forward) and, concatenated, against the whole-row K2 and
    its backward on the whole row (dx at the forward's tolerances of its
    scale, dscale within 1e-4 of its scale in fp32 and 2e-2 in bf16);
    dx and dscale bitwise equal over two calls; an odd width and a
    misaligned view take the scalar template.  Timed (bf16 x, fp32 scale,
    one rank's half): the forward's two passes and the backward's two
    passes beside their plain versions and the whole-row K2 (and its
    backward) at the same local width; ``library_ms`` null: no PyTorch call
    takes an external row statistic."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    cases = [((4096, 5120), bf16, "ssm_parallel_a"), ((4096, 7168), bf16, "ssm_parallel_b"),
             ((4096, 5120), f32, None), ((4096, 7168), f32, None), ((300, 666), f32, None),
             ((300, 666), bf16, None), ((512, 1024, "misaligned"), bf16, None)]
    for shape, dtype, path in cases:
        mis = shape[-1] == "misaligned"
        R, W = shape[:2]
        name = str(dtype).replace("torch.", "")
        tol = RMSNORM_TOL[name]
        x = (3.0 * torch.randn((R, W), generator=gen, device="cuda")).to(dtype)
        g = torch.randn((R, W), generator=gen, device="cuda").to(dtype)
        scale = 1 + 0.3 * torch.randn((W,), generator=gen, device="cuda")
        halves = [t.contiguous() for t in x.chunk(2, -1)]
        g_halves = [t.contiguous() for t in g.chunk(2, -1)]
        if mis:
            halves = [misaligned_view(torch, t) for t in halves]
            g_halves = [misaligned_view(torch, t) for t in g_halves]
        s_halves = list(scale.chunk(2))

        def forward(plain=False):
            sumsq = rms_ref.rmsnorm_split_sumsq_reference if plain else rms_ops.rmsnorm_split_sumsq
            fwd = rms_ref.rmsnorm_split_reference if plain else rms_ops.rmsnorm_split
            stat = sumsq(halves[0]) + sumsq(halves[1])
            return stat, [fwd(h, s, stat, W) for h, s in zip(halves, s_halves)]

        def backward(stat, plain=False):
            dot_fn = rms_ref.rmsnorm_split_dot_reference if plain else rms_ops.rmsnorm_split_dot
            bwd = (rms_ref.rmsnorm_split_backward_reference if plain
                   else rms_ops.rmsnorm_split_backward)
            dot = sum(dot_fn(h, s, q, stat, W) for h, s, q in zip(halves, s_halves, g_halves))
            return [bwd(h, s, q, stat, dot, W) for h, s, q in zip(halves, s_halves, g_halves)]

        stat, outs = forward()
        rstat, routs = forward(plain=True)
        grads, grads2 = backward(stat), backward(stat)
        rgrads = backward(rstat, plain=True)
        whole = rms_ops.rmsnorm(x, scale, 1e-5)
        wdx, wds = rms_ops.rmsnorm_backward(x, scale, g, 1e-5)
        torch.cuda.synchronize()
        closes = [_rms_close(torch, o, r, tol) for o, r in zip(outs, routs)]
        err_f, ok_f = max(e for e, _ in closes), all(ok for _, ok in closes)
        err_w, ok_w = _rms_close(torch, torch.cat(outs, -1), whole, tol)
        dx, ds = torch.cat([a for a, _ in grads], -1), torch.cat([b for _, b in grads])
        rdx, rds = torch.cat([a for a, _ in rgrads], -1), torch.cat([b for _, b in rgrads])
        tol_dx = tol * max(1.0, float(rdx.float().abs().max()))
        tol_ds = (1e-4 if dtype == f32 else tol) * float(rds.abs().max())
        err_dx = float((dx.float() - rdx.float()).abs().max())
        err_ds = float((ds - rds).abs().max())
        werr_dx = float((dx.float() - wdx.float()).abs().max())
        werr_ds = float((ds - wds).abs().max())
        same = all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(grads, grads2))
        label = f"{R}x{W // 2} of {W} {name}{' misaligned view' if mis else ''}"
        tpl_f = _rms_template(rms_ops, halves[0], s_halves[0])
        tpl_b = _rms_template(rms_ops, halves[0], s_halves[0], g_halves[0], backward=True)
        log(f"K2 split [{label}] templates {tpl_f} / {tpl_b}: forward max_abs_err {err_f:.3e} "
            f"vs plain, {err_w:.3e} vs the whole-row K2 (atol and rtol {tol}, as the forward's "
            f"check); backward dx {err_dx:.3e} / {werr_dx:.3e} (tol {tol_dx:.3e}), dscale "
            f"{err_ds:.3e} / {werr_ds:.3e} (tol {tol_ds:.3e}); two calls bitwise equal: {same}")
        require(ok_f and ok_w, f"split rmsnorm forward disagrees: {label}")
        require(max(err_dx, werr_dx) <= tol_dx and max(err_ds, werr_ds) <= tol_ds,
                f"split rmsnorm backward disagrees: {label}")
        require(same, f"split rmsnorm backward is not deterministic: {label}")
        if path is None:
            continue
        h, sc, q = halves[0], s_halves[0], g_halves[0]

        def fwd_pair(plain=False):
            if plain:
                st = rms_ref.rmsnorm_split_sumsq_reference(h)
                return rms_ref.rmsnorm_split_reference(h, sc, st, W)
            return rms_ops.rmsnorm_split(h, sc, rms_ops.rmsnorm_split_sumsq(h), W)

        def bwd_pair(plain=False):
            if plain:
                dot = rms_ref.rmsnorm_split_dot_reference(h, sc, q, stat, W)
                return rms_ref.rmsnorm_split_backward_reference(h, sc, q, stat, dot, W)
            dot = rms_ops.rmsnorm_split_dot(h, sc, q, stat, W)
            return rms_ops.rmsnorm_split_backward(h, sc, q, stat, dot, W)

        e = h.element_size()
        for kind, fn, nbytes, flops, whole_fn, err in (
                ("forward", fwd_pair, 2 * h.numel() * e + 4 * sc.numel() + 8 * R, 4.0 * h.numel(),
                 lambda: rms_ops.rmsnorm(h, sc, 1e-5), max(err_f, err_w)),
                ("backward", bwd_pair, 3 * h.numel() * e + 8 * sc.numel() + 12 * R,
                 10.0 * h.numel(), lambda: rms_ops.rmsnorm_backward(h, sc, q, 1e-5),
                 max(err_dx, werr_dx, err_ds, werr_ds))):
            ms = device_ms(fn, torch)
            plain = device_ms(lambda: fn(plain=True), torch, inner=3, reps=7)
            whole_ms = device_ms(whole_fn, torch)
            b_ms, b_by = bound(nbytes, flops, name)
            log(f"K2 split {kind} [{label}, fp32 scale] two passes {ms:.5f} ms  plain "
                f"{plain:.4f} ms  the whole-row K2 {kind} at the same {W // 2} columns "
                f"{whole_ms:.5f} ms  bound {b_ms:.6f} ms ({b_by}, {100 * b_ms / ms:.1f} %); "
                "library: none (no PyTorch call takes an external row statistic)")
            rows.append(dict(label=f"{label} {kind}, two passes", path=path, kind=kind,
                             max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by, whole_ms=whole_ms))
        del x, g, halves, g_halves, outs, routs, grads, grads2, rgrads, whole, wdx
    torch.cuda.empty_cache()
    return rows


def ssd_bound(x, dt, A, B) -> tuple[float, str]:
    """Bytes: x, dt, A, B and C read once, y and the fp32 final state
    written once.  Operations: per chunk of 64, 2·N per unmasked (i >= j)
    pair for C·Bᵀ once per group, 2·P per pair per head for M·x, and 4·N·P
    per position per head for the inter-chunk product and the state update."""
    Bs, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    e = x.element_size()
    nbytes = 2 * x.numel() * e + 2 * B.numel() * e + 4 * (dt.numel() + A.numel()) \
        + 4 * Bs * H * N * P
    full, rem = divmod(S, SSD_CHUNK)
    pairs = full * SSD_CHUNK * (SSD_CHUNK + 1) // 2 + rem * (rem + 1) // 2
    flops = 2.0 * N * pairs * Bs * G + 2.0 * P * pairs * Bs * H + 4.0 * S * N * P * Bs * H
    return bound(nbytes, flops, str(x.dtype).replace("torch.", ""))


def check_ssd(torch, ssd_ops, ssd_ref, gen):
    """The SSD scan kernel against its plain versions; every case timed."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, B, S, H, P, G, N, dtype, plain, path)
        ("mamba2 prefill B4 S2048 H80 P64 G1 N128 float32", 4, 2048, 80, 64, 1, 128, f32,
         "chunked", "mamba2"),
        ("ragged B1 S1000 H80 P64 G1 N128 float32", 1, 1000, 80, 64, 1, 128, f32, "chunked",
         "mamba2"),
        ("groups B2 S512 H16 P64 G2 N64 float32", 2, 512, 16, 64, 2, 64, f32, "chunked",
         "mamba2"),
        ("mamba2 prefill B4 S2048 H80 P64 G1 N128 bfloat16", 4, 2048, 80, 64, 1, 128, bf16,
         "chunked", "mamba2"),
        ("ragged B1 S1000 H80 P64 G1 N128 bfloat16", 1, 1000, 80, 64, 1, 128, bf16, "chunked",
         "mamba2"),
        ("groups B2 S512 H16 P64 G2 N64 bfloat16", 2, 512, 16, 64, 2, 64, bf16, "chunked",
         "mamba2"),
        ("B2 S1024 H80 P64 G1 N128 bfloat16", 2, 1024, 80, 64, 1, 128, bf16, "chunked",
         "mamba2"),
        ("small B2 S200 H4 P32 G1 N16 float32 vs naive", 2, 200, 4, 32, 1, 16, f32, "naive",
         "mamba2"),
        # zamba2-7b: 112 heads over 2 groups (56 heads read each group's B/C)
        ("zamba2 prefill B4 S2048 H112 P64 G2 N64 bfloat16", 4, 2048, 112, 64, 2, 64, bf16,
         "chunked", "zamba2"),
        ("zamba2 prefill B4 S2048 H112 P64 G2 N64 float32", 4, 2048, 112, 64, 2, 64, f32,
         "chunked", "zamba2"),
    ]
    for dtype in (f32, bf16):
        smem, blocks = ssd_ops.occupancy(dtype, 128, 64)
        log(f"K3 ssd {str(dtype).replace('torch.', '')} at N 128, P 64: {smem} bytes of "
            f"shared memory per block, {blocks} blocks per SM")
        require(blocks >= 1, "the ssd kernel fits no block on an SM")
        require(smem == ssd_ops._smem_bytes(128, 64, dtype),
                f"ssd_ops._smem_bytes disagrees with the kernel's {smem} bytes")
    rows = []
    for label, Bs, S, H, P, G, N, dtype, plain, path in cases:
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = rn(Bs, S, H, P).to(dtype)
        dt = torch.nn.functional.softplus(rn(Bs, S, H))
        A = -torch.exp(0.3 * rn(H))
        B = (0.3 * rn(Bs, S, G, N)).to(dtype)
        C = (0.3 * rn(Bs, S, G, N)).to(dtype)
        plain_fn = ssd_ref.ssd_chunked if plain == "chunked" else ssd_ref.ssd_naive
        y, st = ssd_ops.ssd(x, dt, A, B, C)
        ry, rs = plain_fn(x, dt, A, B, C)
        torch.cuda.synchronize()
        err_y = float((y.float() - ry.float()).abs().max())
        err_s = float((st - rs).abs().max())
        tol_y = SSD_TOL * max(1.0, float(ry.float().abs().max()))
        tol_s = SSD_TOL * max(1.0, float(rs.abs().max()))
        # a bf16 y is one rounding of an fp32 sum on both sides, so the two
        # may also differ by one bf16 step of the element (2^-7 of |y|)
        rtol_y = 2.0 ** -7 if dtype == bf16 else 0.0
        y_ok = bool(((y.float() - ry.float()).abs()
                     <= tol_y + rtol_y * ry.float().abs()).all())
        log(f"K3 ssd [{label}] max_abs_err y {err_y:.3e} (tol {tol_y:.3e}"
            f"{' + 2^-7 |y|' if rtol_y else ''}) state {err_s:.3e} (tol {tol_s:.3e})")
        require(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                f"ssd produced non-finite values: {label}")
        require(y_ok and err_s <= tol_s, f"ssd disagrees with its plain version: {label}")
        ms = device_ms(lambda: ssd_ops.ssd(x, dt, A, B, C), torch)
        plain_ms = device_ms(lambda: plain_fn(x, dt, A, B, C), torch,
                             inner=2 if plain == "naive" else 10, reps=5)
        b_ms, b_by = ssd_bound(x, dt, A, B)
        log(f"K3 [{label}] kernel {ms:.4f} ms  plain ({plain}) {plain_ms:.4f} ms  "
            f"bound {b_ms:.6f} ms ({b_by})")
        rows.append(dict(label=label, path=path, max_abs_err=max(err_y, err_s), ms=ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del x, dt, A, B, C, y, st, ry, rs
    torch.cuda.empty_cache()
    return rows


def check_ssd_autograd(torch, ssd_ops, ssd_ref, gen):
    """K3 under autograd (``ssd_autograd``: the kernel forward, the fp32
    recompute backward through ``ssd_chunked``) against
    ``torch.autograd.grad`` through the plain ``ssd_chunked`` on the same
    inputs and cotangent, at the training shapes (mamba2 B2 S2048 H80 P64
    G1 N128, zamba2 B2 S2048 H112 P64 G2 N64), a ragged S 1 000, and a
    phase 27 rank's local heads and group (H40 G1 N128, H56 G1 N64).  fp32
    inputs: y, dx, ddt, dA, dB, dC within 1e-3 · max(1, max |plain|); bf16
    x/B/C (the fp32 inputs rounded): each no further from the fp32 plain
    grads than twice the plain bf16 route's.  Timed (bf16): the forward
    plus backward beside the plain autograd's."""
    f32, bf16 = torch.float32, torch.bfloat16
    names = ("y", "dx", "ddt", "dA", "dB", "dC")
    rows = []
    for label, Bs, S, H, P, G, N, path in (
            ("mamba2 train B2 S2048 H80 P64 G1 N128", 2, SSM_TRAIN_SEQ, 80, 64, 1, 128,
             ("mamba2_train", "pipeline_d")),
            ("zamba2 train B2 S2048 H112 P64 G2 N64", 2, SSM_TRAIN_SEQ, 112, 64, 2, 64,
             "zamba2_train"),
            ("ragged B1 S1000 H80 P64 G1 N128", 1, 1000, 80, 64, 1, 128, None),
            # phase 27: a tp 2 rank's heads, and the one group they read
            ("ssm parallel (a) rank B2 S2048 H40 P64 G1 N128", 2, SSM_TRAIN_SEQ, 40, 64, 1, 128,
             "ssm_parallel_a"),
            ("ssm parallel (b) rank B2 S2048 H56 P64 G1 N64", 2, SSM_TRAIN_SEQ, 56, 64, 1, 64,
             "ssm_parallel_b")):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = rn(Bs, S, H, P)
        dt = torch.nn.functional.softplus(rn(Bs, S, H))
        A = -torch.exp(0.3 * rn(H))
        B, C = 0.3 * rn(Bs, S, G, N), 0.3 * rn(Bs, S, G, N)
        dy = rn(Bs, S, H, P)

        def leaves(dtype):             # x, B, C in ``dtype``; dt and A fp32
            return [t.detach().to(dtype if i in (0, 3, 4) else f32).requires_grad_()
                    for i, t in enumerate((x, dt, A, B, C))]

        def run(fn, ins):
            y, _ = fn(*ins)
            return [y.detach()] + list(torch.autograd.grad(y, ins, dy.to(y.dtype)))

        k32, r32 = run(ssd_ops.ssd_autograd, leaves(f32)), run(ssd_ref.ssd_chunked, leaves(f32))
        kbf = run(ssd_ops.ssd_autograd, leaves(bf16))
        rbf = run(ssd_ref.ssd_chunked, leaves(bf16))
        torch.cuda.synchronize()
        errs = []
        for name, a, b, kb, rb in zip(names, k32, r32, kbf, rbf):
            scale = max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max())
            err_k = float((kb.float() - b).abs().max())
            err_r = float((rb.float() - b).abs().max())
            log(f"K3 ssd_autograd [{label}] {name}: fp32 max_abs_err {err:.3e} (tol 1e-3 x "
                f"{scale:.3e}); bf16 vs fp32 plain: kernel route {err_k:.3e}, plain route "
                f"{err_r:.3e} (rule: <= 2x); dtype {kb.dtype}")
            require(bool(torch.isfinite(a).all() and torch.isfinite(kb).all()),
                    f"ssd_autograd produced non-finite {name}: {label}")
            require(err <= SSD_TOL * scale, f"ssd_autograd {name} in fp32 disagrees with "
                    f"autograd through the plain version: {label}")
            require(err_k <= 2.0 * err_r, f"ssd_autograd {name} in bf16 is further from fp32 "
                    f"than twice the plain bf16 route's: {label}")
            errs.append(err)
        if path is None:
            continue
        ins_k, ins_r = leaves(bf16), leaves(bf16)
        dyb = dy.to(bf16)
        fwd_bwd = lambda fn, ins: torch.autograd.grad(fn(*ins)[0], ins, dyb)
        ms = device_ms(lambda: fwd_bwd(ssd_ops.ssd_autograd, ins_k), torch, inner=2, reps=5)
        plain_ms = device_ms(lambda: fwd_bwd(ssd_ref.ssd_chunked, ins_r), torch, inner=2, reps=5)
        b_ms, b_by = ssd_vjp_bound(*ins_k[:4])
        log(f"K3 ssd_autograd [{label} bfloat16] forward + backward {ms:.4f} ms  plain autograd "
            f"{plain_ms:.4f} ms  bound {b_ms:.6f} ms ({b_by})")
        rows.append(dict(label=f"{label} bfloat16 forward + backward", path=path,
                         max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by))
        del ins_k, ins_r, k32, r32, kbf, rbf
    torch.cuda.empty_cache()
    return rows


def ssd_vjp_bound(x, dt, A, B) -> tuple[float, str]:
    """The forward and backward of the scan: x, dt, A, B, C and the
    cotangent of y read once, y and the five grads (each its input's size
    and dtype) written once; operations 3x the forward's (``ssd_bound``)."""
    Bs, S, H, P = x.shape
    N = B.shape[3]
    e = x.element_size()
    inputs = x.numel() * e + 2 * B.numel() * e + 4 * (dt.numel() + A.numel())
    nbytes = 2 * inputs + 2 * x.numel() * e
    full, rem = divmod(S, SSD_CHUNK)
    pairs = full * SSD_CHUNK * (SSD_CHUNK + 1) // 2 + rem * (rem + 1) // 2
    G = B.shape[2]
    flops = 3.0 * (2.0 * N * pairs * Bs * G + 2.0 * P * pairs * Bs * H
                   + 4.0 * S * N * P * Bs * H)
    return bound(nbytes, flops, str(x.dtype).replace("torch.", ""))


# ---------------------------------------------------------------- phases 4-5

def serve_full_width(torch, np, serving, counters):
    """Phase 4: the same traffic through the graphed scheduler
    (``serving.build``: CUDA graphs of the decode and prefill steps) and the
    eager one (``compiled=False``), each after a warm-up request (which
    captures the graphs); tokens identical, launches equal."""
    from repro_torch.runtime.scheduler import ContinuousBatchingScheduler

    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=False, device="cuda",
        cache=serving.CacheConfig(max_context=1024, page_size=16),
        scheduler=serving.SchedulerConfig(num_slots=8, prefill_chunk=256))
    finite = []

    def greedy(logits, request, rng):
        finite.append(bool(np.isfinite(logits).all()))
        return int(np.argmax(logits))

    t0 = time.perf_counter()
    session = serving.build(config, sample_fn=greedy)
    torch.cuda.synchronize()
    log(f"serve: built full-width {config.model_config().name} in "
        f"{time.perf_counter() - t0:.3f} s")
    eager = serving.ServeSession(config, ContinuousBatchingScheduler(
        session.model, session.params, config.cache_config(),
        prefill_chunk=config.scheduler.prefill_chunk, dtype=torch.bfloat16, sample_fn=greedy,
        compiled=False), session.model, session.params)
    vocab = config.model_config().vocab_size
    rng = np.random.default_rng(0)
    warm = rng.integers(0, vocab, 300, dtype=np.int32)
    prompts = rng.integers(0, vocab, (8, 512), dtype=np.int32)
    runs = {}
    for mode, s in (("graphed", session), ("eager", eager)):
        # warm-up request (graph captures, cuBLAS handles, allocator); not measured
        t0 = time.perf_counter()
        s.submit(serving.Request(prompt=warm, max_new=3))
        s.run_until_drained()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        zero_counts(counters)
        finite.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()        # the serve run's own peak, not phase 3's
        t0 = time.perf_counter()
        reqs = [s.submit(serving.Request(prompt=p, max_new=32)).request for p in prompts]
        ticks = 0
        while not all(r.done for r in reqs):
            s.tick()
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
        require(all(len(r.tokens) == 32 for r in reqs),
                f"{mode}: a request did not return max_new tokens")
        require(len(finite) == 8 * 32 and all(finite), f"{mode}: non-finite logits in the serve run")
        require(launches["flash_attention_fwd"] > 0 and launches["rmsnorm"] > 0,
                f"{mode}: a kernel of the path never launched in the serve run: {launches}")
        tokens = sum(len(r.tokens) for r in reqs)
        ttft = statistics.median(r.ttft_s for r in reqs)
        tpot = statistics.median(r.tpot_s for r in reqs)
        log(f"serve ({mode}): {tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s)  "
            f"ttft p50 {ttft * 1e3:.1f} ms  tpot p50 {tpot * 1e3:.2f} ms  {ticks} ticks  "
            f"launches {launches} (K1 {launches['flash_attention_fwd'] / ticks:.2f}, K2 "
            f"{launches['rmsnorm'] / ticks:.2f} a tick)  warm-up request {warm_s:.3f} s  "
            f"peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        runs[mode] = ([list(r.tokens) for r in reqs], launches, ticks)
    sched = session.scheduler
    log(f"serve (graphed): capture (2 warm-up calls + capture) decode step "
        f"{sched._decode_fn.capture_s:.3f} s, prefill step {sched._prefill_fn.capture_s:.3f} s; "
        f"graph pool {(sched._decode_fn.pool_bytes + sched._prefill_fn.pool_bytes) / 2**20:.1f} "
        f"MiB (decode {sched._decode_fn.pool_bytes / 2**20:.1f}, prefill "
        f"{sched._prefill_fn.pool_bytes / 2**20:.1f})")
    require(runs["graphed"][0] == runs["eager"][0],
            "the graphed scheduler's greedy bf16 tokens differ from the eager scheduler's")
    require(runs["graphed"][1:] == runs["eager"][1:],
            f"launches per tick differ: graphed {runs['graphed'][1:]}, eager {runs['eager'][1:]}")
    log("serve: graphed and eager schedulers: greedy bf16 tokens identical (8 x 32), equal "
        "launches over equal ticks")
    return session, eager, prompts, runs["graphed"][1]


def graph_vs_eager(torch, got, want, what: str) -> str:
    """A graph replay's output against the eager call's: bitwise, or (if
    cuBLAS picked another algorithm under capture) within 1e-6 of the eager
    values' scale.  Returns which."""
    if torch.equal(got, want):
        return "bitwise equal"
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    require(err <= 1e-6 * scale, f"{what}: graph replay {err:.3e} from eager on a scale of "
            f"{scale:.3e}")
    return f"not bitwise, max |diff| {err:.3e} on a scale of {scale:.3e}"


def _kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_attention"
    if "rmsnorm_bwd_kernel" in name or "rmsnorm_colsum_kernel" in name:
        return "rmsnorm_bwd"
    if "rmsnorm_kernel" in name:        # the gated template's last argument is true
        return "rmsnorm_gated" if ", true>" in name else "rmsnorm"
    if "ssd_kernel" in name:
        return "ssd"
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def device_groups(prof, spans: dict, name_group=_kernel_group):
    """Device time (ms) and launches by group over a profiled window: a
    kernel inside the device-timeline range of one of ``spans`` (profiler
    span name -> group label) takes that label, any other
    ``name_group(its name)``.  Returns (ms by group, launches by group, ms
    by kernel name, whether every span showed on the device timeline)."""
    import bisect

    from torch.autograd import DeviceType

    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    ranges = {n: sorted((ev.time_range.start, ev.time_range.end) for ev in dev if ev.name == n)
              for n in spans}
    starts = {n: [r[0] for r in rs] for n, rs in ranges.items()}

    def span_of(start, end):
        for n, label in spans.items():
            i = bisect.bisect_right(starts[n], start) - 1
            if i >= 0 and end <= ranges[n][i][1]:
                return label
        return None

    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    by_name: dict[str, float] = {}
    for ev in dev:
        if ev.name in spans:
            continue
        g = span_of(ev.time_range.start, ev.time_range.end) or name_group(ev.name)
        ms = ev.time_range.elapsed_us() / 1e3
        groups[g] = groups.get(g, 0.0) + ms
        counts[g] = counts.get(g, 0) + 1
        by_name[ev.name[:70]] = by_name.get(ev.name[:70], 0.0) + ms
    return groups, counts, by_name, all(ranges.values())


def report_profile(prof, wall: float, steps: int, what: str, unit: str,
                   spans: dict | None = None) -> None:
    """Device time of a profiled window by group (``device_groups``: the
    kernels inside ``spans``, then by kernel name), per ``unit`` (one of
    ``steps``), and the device's busy share of the host-clock window."""
    groups, counts, by_name, seen = device_groups(prof, spans or {})
    if spans and not seen:
        log(f"profile: {what}: the device timeline shows none of the spans {sorted(spans)}; "
            "their kernels fall into the name groups")
    busy = sum(groups.values())
    if busy == 0.0:
        log(f"profile: {what}: device time not measured (the profiler saw no kernels)")
        return
    per = {g: round(t / steps, 4) for g, t in sorted(groups.items(), key=lambda x: -x[1])}
    log(f"profile: {what}: wall {wall * 1e3 / steps:.3f} ms/{unit}, device busy "
        f"{busy / steps:.3f} ms/{unit} ({100 * busy / (wall * 1e3):.1f}% of wall); device "
        f"ms/{unit} by group {per}; launches/{unit} "
        f"{ {g: n // steps for g, n in counts.items()} }")
    for name, ms in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
        log(f"profile:   {ms / steps:9.4f} ms/{unit}  {name}")


def profile_decode(torch, np, serving, session, ticks: int = 8):
    """Where a full-width decode tick's time goes: 8 slots in the decode
    phase, ``ticks`` ticks under torch.profiler; device time by kernel group
    and the device's busy share of the host-clock window.  On the graphed
    scheduler the decode graph's replay is also timed with CUDA events (it
    rewrites the last tick's k/v, the same values, at the same positions)."""
    from torch.profiler import ProfilerActivity, profile

    mode = "graphed" if session.scheduler.compiled else "eager"
    vocab = session.config.model_config().vocab_size
    rng = np.random.default_rng(1)
    reqs = [session.submit(serving.Request(
        prompt=rng.integers(0, vocab, 512, dtype=np.int32), max_new=2 * 8 + ticks + 8)).request
        for _ in range(8)]
    while any(r.state != "decoding" for r in reqs):
        session.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            session.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, ticks, f"{ticks} {mode} decode ticks x 8 slots", "tick")
    if session.scheduler.compiled:
        entry = next(iter(session.scheduler._decode_fn.entries.values()))
        graph_ms = device_ms(entry.graph.replay, torch)
        log(f"profile: the decode graph's replay: {graph_ms:.4f} ms of device time (CUDA "
            f"events), {100 * graph_ms / (wall * 1e3 / ticks):.1f}% of the profiled tick's "
            f"{wall * 1e3 / ticks:.3f} ms wall")
    session.run_until_drained()


def parity(torch, np, serving, build_model, session, prompts):
    from repro_torch.models.common import cast_tree

    # (a) reduced llama3.2-1b, fp32: kernel path and plain path, same tokens
    config = serving.ServeConfig(
        arch="llama3.2-1b", reduced=True, device="cuda",
        cache=serving.CacheConfig(max_context=64, page_size=16),
        scheduler=serving.SchedulerConfig(num_slots=2, prefill_chunk=16))
    cfg = config.model_config()
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = build_model(cfg, device="cuda").init(gen, torch.float32)
    rng = np.random.default_rng(3)
    reduced_prompts = rng.integers(0, cfg.vocab_size, (4, 40), dtype=np.int32)
    tokens = {}
    for impl in ("kernel", "ref"):
        s = serving.build(config, model=build_model(cfg, impl=impl, device="cuda"),
                          params=params, dtype=torch.float32)
        reqs = [s.submit(serving.Request(prompt=p, max_new=12)).request
                for p in reduced_prompts]
        s.run_until_drained()
        tokens[impl] = [list(r.tokens) for r in reqs]
    require(tokens["kernel"] == tokens["ref"],
            f"fp32 greedy tokens differ: kernel {tokens['kernel']} ref {tokens['ref']}")
    log(f"parity: reduced fp32 greedy tokens identical over 4 requests x 12 "
        f"({tokens['kernel'][0][:6]}...)")

    # (b) full width: the first prefill chunk's logits (the scheduler's first
    # forward_decode call), kernel path vs plain path in bf16, both held
    # against the plain path in fp32 on the same (bf16-valued) weights
    model_k = session.model
    model_r = build_model(model_k.cfg, impl="ref", device="cuda")
    chunk = torch.from_numpy(prompts[:1, :256].astype(np.int64)).cuda()
    kv_len = torch.tensor([256], device="cuda")
    params32 = cast_tree(session.params, torch.float32)
    out = {}
    for name, model, params, dtype in (
            ("kernel", model_k, session.params, torch.bfloat16),
            ("ref", model_r, session.params, torch.bfloat16),
            ("ref32", model_r, params32, torch.float32)):
        cache = model.init_cache(1, 1024 + 256, dtype)
        logits, _ = model.forward_decode(params, chunk, cache, 0, kv_len=kv_len, dtype=dtype)
        out[name] = logits
    torch.cuda.synchronize()
    err = float((out["kernel"] - out["ref"]).abs().max())
    scale = float(out["ref32"].abs().max())
    err_k = float((out["kernel"] - out["ref32"]).abs().max())
    err_r = float((out["ref"] - out["ref32"]).abs().max())
    top1 = float((out["kernel"].argmax(-1) == out["ref"].argmax(-1)).float().mean())
    log(f"parity: full-width first-chunk logits (256 x {out['ref'].shape[-1]}): "
        f"kernel-vs-plain bf16 max_abs_err {err:.3e} (max |logit| {scale:.3f}); vs fp32 "
        f"plain: kernel {err_k:.3e}, plain bf16 {err_r:.3e}; top-1 agreement {top1:.4f}")
    require(err <= 3e-2 * scale,
            "full-width bf16 logits differ by more than 3e-2 of the logit scale")
    require(err_k <= 2.0 * err_r,
            "the kernel path is further from fp32 than the plain bf16 path's own error x2")


# ---------------------------------------------------------------- phases 6-9

STATIC_BATCH, STATIC_PROMPT, STATIC_NEW = 4, 2048, 32


def step_engine_launches(model, new: int) -> dict:
    """The kernel launches of one static batch through the step engine: K3
    once per Mamba layer of the prefill; per forward (the prefill and
    ``new - 1`` decode steps) K2 twice per Mamba layer (the layer norm, and
    the gate norm — gated, one launch that also counts on
    ``rmsnorm_gated``), twice per attention block and once for the final
    norm, and K1 once per attention block: a hybrid's ``n_apps`` sites, none
    in mamba2, every layer of an MoE or VLM decoder; no K2 backward."""
    cfg = model.cfg
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = cfg.num_layers if cfg.family in ("moe", "vlm") else getattr(model, "n_apps", 0)
    return {"ssd": mamba, "rmsnorm": (2 * mamba + 2 * attn + 1) * new,
            "rmsnorm_gated": mamba * new, "rmsnorm_bwd": 0,
            "flash_attention_fwd": attn * new, "ssd_autograd": 0}


def describe(model) -> str:
    """The full-width model's shape, for the log."""
    cfg = model.cfg
    parts = [f"{cfg.num_layers} layers", f"d {cfg.d_model}"]
    if getattr(model, "n_apps", 0):
        parts.append(f"{model.n_apps} shared-attention sites")
    if cfg.family == "moe":
        parts += [f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}",
                  f"{cfg.num_experts} experts of ff {cfg.d_ff}, top-{cfg.experts_per_token}, "
                  f"capacity factor {cfg.moe_capacity_factor}",
                  f"shared expert ff {cfg.shared_expert_ff}"]
    return ", ".join(parts + [f"vocab {cfg.vocab_size}"])


def serve_step_engine(torch, np, serving, build_model, get_config, counters, arch: str):
    """Full-width ``arch`` (random bf16 weights from seed 0) through the step
    engine: STATIC_BATCH prompts of STATIC_PROMPT tokens, STATIC_NEW new
    tokens each, after a warm-up; every kernel's launches pinned
    (``step_engine_launches``).  Returns (engine, params, prompts, launches,
    (tokens, TTFT s, the decode steps' s))."""
    from repro_torch.models.common import tree_leaves

    cfg = get_config(arch)
    label = cfg.name.split("-")[0]
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    engine = serving.step_engine(model, serving.single_device_plan(cfg), batch=STATIC_BATCH,
                                 max_len=STATIC_PROMPT + STATIC_NEW)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"{label}: built full-width {cfg.name} ({describe(model)}; {n_params} parameters, "
        f"{n_params * 2 / 1e9:.2f} GB in bf16) in {time.perf_counter() - t0:.3f} s")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (STATIC_BATCH, STATIC_PROMPT), dtype=np.int64)
    # warm-up (cuBLAS handles, allocator); not part of the measured run
    engine.greedy_generate(params, prompts[:, :96], 3, 128)
    torch.cuda.synchronize()
    for k in engine.latencies:
        engine.latencies[k].clear()

    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.greedy_generate(params, prompts, STATIC_NEW, STATIC_PROMPT + STATIC_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)

    require(tuple(out.shape) == (STATIC_BATCH, STATIC_NEW),
            f"{label} tokens shape {tuple(out.shape)}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{label} token out of the vocab")
    expected = step_engine_launches(model, STATIC_NEW)
    require(launches == expected, f"{label} launched {launches}, expected {expected}")
    ttft = engine.latencies["prefill_s"][0]
    tpot = statistics.median(engine.latencies["decode_s"])
    tokens = STATIC_BATCH * STATIC_NEW
    log(f"{label} serve: {STATIC_BATCH} x ({STATIC_PROMPT} + {STATIC_NEW}) tokens in {wall:.3f} "
        f"s ({tokens / wall:.1f} tok/s)  prefill (ttft) {ttft * 1e3:.1f} ms  "
        f"decode (tpot) p50 {tpot * 1e3:.2f} ms  launches {launches}  "
        f"peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"{label} serve: tokens[0][:8] {out[0, :8].tolist()}")
    return (engine, params, prompts, launches,
            (out, ttft, list(engine.latencies["decode_s"])))


#: the MoE FFN's profiler spans (``models/moe.py``) -> profile groups
MOE_SPANS = {"moe_route": "MoE routing (router product, softmax, top-k, slot cumsum, "
                          "scatter-min)",
             "moe_dispatch": "MoE dispatch gather",
             "moe_experts": "MoE expert products (bmm) and SwiGLU",
             "moe_combine": "MoE combine gather and gate sum"}


def profile_step_engine(torch, engine, params, prompts, steps: int = 4, extras=None,
                        prefix: int = 0):
    """Where a full-width prefill's and decode step's device time goes: one
    prefill (given ``extras``, the encoder-decoder's frames or the VLM's
    patch embeddings, whose ``prefix`` positions precede the prompt in the
    cache), then ``steps`` decode steps, each window under torch.profiler;
    device time by group (an MoE model's FFN by its spans, ``MOE_SPANS``)
    and busy share."""
    from torch.profiler import ProfilerActivity, profile

    label = engine.model.cfg.name.split("-")[0]
    spans = MOE_SPANS if engine.model.cfg.family == "moe" else None
    tokens = torch.from_numpy(prompts).cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = engine.prefill_step(params, tokens, extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()), f"non-finite {label} prefill logits")
    report_profile(prof, wall, 1, f"{label} prefill {tuple(tokens.shape)}", "prefill", spans)
    S = prefix + tokens.shape[1]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    engine.decode_step(params, tok, cache, S)                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = engine.decode_step(params, tok, cache, S + 1 + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()), f"non-finite {label} decode logits")
    report_profile(prof, wall, steps, f"{label} {steps} decode steps x {tokens.shape[0]} rows",
                   "step", spans)


def graphed_serve(torch, engine, params, prompts, extras, new: int, eager, counters, *,
                  prefix: int = 0, prefill_graph: bool = False, profile_steps: int = 4) -> dict:
    """Phases 6b, 8b, 12b, 15b and 18b: the step engine's compiled steps on
    the served weights and traffic.  The prefill (``jit_prefill_step()``
    where ``prefill_graph``, else the eager ``prefill_step``), then ``new -
    1`` ``jit_decode_step(donate=True)`` calls, after a 3-token warm-up run
    that captures the graphs; launches pinned as the eager run's
    (``whisper_launches`` for the encoder-decoder, else
    ``step_engine_launches``) and the tokens held to the eager run's
    (``eager``: tokens, TTFT s, decode step seconds) token for token.  Logs
    TTFT, TPOT, the capture time and the pool bytes beside the eager run's,
    then ``profile_steps`` graphed decode steps under torch.profiler
    (rewriting the first positions; kv_len masks the rest) and the decode
    graph's replay timed with CUDA events (device time over the graphed
    TPOT: the busy share).  Returns the graphed run's launches."""
    from torch.profiler import ProfilerActivity, profile

    model = engine.model
    label = model.cfg.name.split("-")[0]
    decode = engine.jit_decode_step(donate=True)
    prefill = engine.jit_prefill_step() if prefill_graph else engine.prefill_step
    tokens = torch.from_numpy(prompts).cuda()
    B, S = tokens.shape
    t0 = time.perf_counter()
    generate_with_extras(torch, engine, params, tokens, extras, 3, prefix, prefill=prefill,
                         decode=decode)                                       # captures
    warm_s = time.perf_counter() - t0
    steps_c = [decode.compiled] + (list(prefill.compiled.values()) if prefill_graph else [])
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, ttft, steps, cache = generate_with_extras(torch, engine, params, tokens, extras, new,
                                                      prefix, prefill=prefill, decode=decode)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    expected = (whisper_launches(model.cfg, new) if model.cfg.family == "audio"
                else step_engine_launches(model, new))
    require(launches == expected, f"{label} graphed: launched {launches}, expected {expected}")
    eager_tokens, eager_ttft, eager_steps = eager
    same = out.tolist() == eager_tokens.tolist()
    require(same, f"{label}: graphed tokens differ from the eager run's: {out[:, :8].tolist()} "
            f"vs {eager_tokens[:, :8].tolist()}")
    tpot, eager_tpot = statistics.median(steps), statistics.median(eager_steps)
    n_tok = B * new
    log(f"{label} graphed serve: {B} x ({prefix + S} + {new}) in {wall:.3f} s "
        f"({n_tok / wall:.1f} tok/s)  prefill (ttft, "
        f"{'graphed' if prefill_graph else 'eager'}) {ttft * 1e3:.2f} ms [eager "
        f"{eager_ttft * 1e3:.2f}]  decode (tpot) p50 {tpot * 1e3:.3f} ms [eager "
        f"{eager_tpot * 1e3:.3f}]; tokens identical to the eager run's ({new} x {B}); launches "
        f"{launches} (pinned as eager); warm-up run {warm_s:.3f} s, of it capture "
        f"(2 warm-up calls + capture) {sum(c.capture_s for c in steps_c):.3f} s; graph pool "
        f"{sum(c.pool_bytes for c in steps_c) / 2**20:.1f} MiB (decode "
        f"{decode.compiled.pool_bytes / 2**20:.1f}); peak mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(profile_steps):
            pos = prefix + S + i
            kv_len = torch.full((B,), pos + 1, device="cuda") if prefix else None
            logits, cache = decode(params, out[:, i:i + 1], cache, pos, kv_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(bool(torch.isfinite(logits).all()), f"non-finite {label} graphed decode logits")
    report_profile(prof, wall, profile_steps,
                   f"{label} {profile_steps} graphed decode steps x {B} rows", "step")
    graph_ms = device_ms(next(iter(decode.compiled.entries.values())).graph.replay, torch)
    log(f"profile: {label} decode graph's replay: {graph_ms:.4f} ms of device time (CUDA "
        f"events), {100 * graph_ms / (tpot * 1e3):.1f}% of the graphed tpot, "
        f"{100 * graph_ms / (eager_tpot * 1e3):.1f}% of the eager tpot")
    return launches


def graphed_prefill_check(torch, np, serving, build_model, small_cfg, counters) -> None:
    """Phase 7b: a reduced mamba2's ``jit_prefill_step()`` — K3 inside the
    graph — against the eager ``prefill_step`` in bf16 on two batches of 4
    ragged prompts (S 1000): logits and every cache leaf bitwise (or within
    1e-6 of scale), and each replay launches K3 once per layer."""
    model = build_model(small_cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(7), torch.bfloat16)
    engine = serving.step_engine(model, serving.single_device_plan(small_cfg), batch=4)
    prefill = engine.jit_prefill_step()
    rng = np.random.default_rng(11)
    for i in range(2):
        toks = torch.from_numpy(rng.integers(0, small_cfg.vocab_size, (4, 1000))).cuda()
        want, want_cache = engine.prefill_step(params, toks)
        zero_counts(counters)
        got, got_cache = prefill(params, toks)
        launches = read_counts(counters)
        runs = 1 if i else 3                  # the first call: 2 warm-up calls and the replay
        require(launches["ssd"] == runs * small_cfg.num_layers,
                f"reduced mamba2 prefill graph: {launches['ssd']} K3 launches")
        seen = [graph_vs_eager(torch, got, want, "reduced mamba2 prefill logits")]
        seen += [graph_vs_eager(torch, got_cache[k], want_cache[k], f"reduced mamba2 cache {k}")
                 for k in want_cache]
        log(f"graphed prefill: reduced mamba2 ({small_cfg.num_layers} layers) bf16, 4 x 1000 "
            f"(call {i + 1}): logits and cache {sorted(set(seen))}; K3 {launches['ssd']} "
            f"launches")


class RoutingLog:
    """While active, records every MoE layer's routing: the expert indices
    of ``route`` (T, k) and the kept choices of ``assign_slots`` (T, k), by
    wrapping the two functions of ``repro_torch.models.moe``, which
    ``moe_ffn_apply`` looks up at each call.  A model without MoE layers
    records nothing."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.idx, self.keep = moe, [], []
        self.saved = route, assign = moe.route, moe.assign_slots

        def rec_route(*a):
            out = route(*a)
            self.idx.append(out[1])
            return out

        def rec_assign(idx, E, C):
            out = assign(idx, E, C)
            self.keep.append(out[1])
            return out

        moe.route, moe.assign_slots = rec_route, rec_assign
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.assign_slots = self.saved

    def agreement(self, other: "RoutingLog") -> float:
        """The share of (token, layer, choice) routing decisions equal in
        both logs."""
        same = sum(int((a == b).sum()) for a, b in zip(self.idx, other.idx))
        return same / max(sum(a.numel() for a in self.idx), 1)

    def drop_share(self) -> float:
        """The share of (token, layer, choice) choices past capacity."""
        kept = sum(int(k.sum()) for k in self.keep)
        return 1.0 - kept / max(sum(k.numel() for k in self.keep), 1)


def parity_reduced(torch, np, serving, build_model, small_cfg, label: str) -> None:
    """``small_cfg`` (a reduced model of a family) in fp32 gives identical
    greedy tokens with ``impl="kernel"`` and ``impl="ref"`` through the step
    engine."""
    small = build_model(small_cfg).init(torch.Generator(device="cuda").manual_seed(7),
                                        torch.float32)
    small_prompts = np.random.default_rng(3).integers(0, small_cfg.vocab_size, (4, 100))
    tokens = {}
    for impl in ("kernel", "ref"):
        eng = serving.step_engine(build_model(small_cfg, impl=impl),
                                  serving.single_device_plan(small_cfg), dtype=torch.float32)
        tokens[impl] = eng.greedy_generate(small, small_prompts, 12, 112).tolist()
    require(tokens["kernel"] == tokens["ref"],
            f"{label} fp32 greedy tokens differ: kernel {tokens['kernel']} ref {tokens['ref']}")
    log(f"parity: reduced {label} ({small_cfg.num_layers} layers) fp32 greedy tokens identical "
        f"over 4 prompts of 100 x 12 ({tokens['kernel'][0][:6]}...)")


def parity_prefill(torch, label: str, model_k, model_r, params, toks, what: str,
                   extras=None) -> None:
    """The prefill's last-position logits of the kernel path and the plain
    path in bf16 and in fp32 (``params`` cast), all held against the plain
    path in fp32 on the same (bf16-valued) weights: the kernel bf16 path no
    further from it than twice the plain bf16 path, the kernel fp32 path
    within 1e-3 of the logit scale.  ``extras`` (the encoder-decoder's
    frames) go to every pass; the model casts them to the pass's dtype.  An
    MoE model also logs the share of routing decisions on which the two
    paths agree, in each dtype."""
    from repro_torch.models.common import cast_tree

    params32 = cast_tree(params, torch.float32)
    out, routes = {}, {}
    for name, model, p, dtype in (("kernel", model_k, params, torch.bfloat16),
                                  ("ref", model_r, params, torch.bfloat16),
                                  ("kernel32", model_k, params32, torch.float32),
                                  ("ref32", model_r, params32, torch.float32)):
        with RoutingLog() as routes[name]:
            logits, cache = model.forward_prefill(p, toks, dtype=dtype, **(extras or {}))
        out[name] = logits[:, -1]
        del logits, cache
        torch.cuda.empty_cache()
    del params32
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(v).all()) for v in out.values()),
            f"non-finite {what} {label} logits")
    err = float((out["kernel"] - out["ref"]).abs().max())
    scale = float(out["ref32"].abs().max())
    err_k = float((out["kernel"] - out["ref32"]).abs().max())
    err_r = float((out["ref"] - out["ref32"]).abs().max())
    err_32 = float((out["kernel32"] - out["ref32"]).abs().max())
    top1 = float((out["kernel"].argmax(-1) == out["ref32"].argmax(-1)).float().mean())
    routing = ""
    if routes["kernel"].idx:
        routing = (f"; routing agreement kernel vs plain: bf16 "
                   f"{routes['kernel'].agreement(routes['ref']):.6f}, fp32 "
                   f"{routes['kernel32'].agreement(routes['ref32']):.6f} of "
                   f"{sum(a.numel() for a in routes['kernel'].idx)} (token, layer, choice) "
                   f"decisions; dropped past capacity: {routes['kernel32'].drop_share():.4f}")
    log(f"parity: {what} {label} prefill logits ({tuple(out['ref'].shape)}): kernel-vs-plain "
        f"bf16 max_abs_err {err:.3e} (max |logit| {scale:.3f}); vs fp32 plain: kernel bf16 "
        f"{err_k:.3e}, plain bf16 {err_r:.3e}, kernel fp32 {err_32:.3e}; kernel bf16 top-1 "
        f"agreement with fp32 {top1:.4f}{routing}")
    require(err_k <= 2.0 * err_r,
            f"the {label} kernel path is further from fp32 than the plain bf16 path's error x2")
    require(err_32 <= SSD_TOL * max(1.0, scale),
            f"the {label} kernel path in fp32 differs from the plain path in fp32 by more than "
            "1e-3 of the logit scale")


def parity_step_engine(torch, np, serving, build_model, small_cfg, engine, params, prompts):
    """(a) ``parity_reduced`` on ``small_cfg``; (b) ``parity_prefill`` at
    full width on the served weights and prompts."""
    label = engine.model.cfg.name.split("-")[0]
    parity_reduced(torch, np, serving, build_model, small_cfg, label)
    model_r = build_model(engine.model.cfg, impl="ref")
    parity_prefill(torch, label, engine.model, model_r, params,
                   torch.from_numpy(prompts).cuda(), "full-width")


# ---------------------------------------------------------------- phase 10

TRAIN_ARCH = "llama3.2-1b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 8, 4, 3
TRAIN_POLICIES = ("selective", "full", "none")
#: steps under each policy: selective's TRAIN_STEPS give phase 11 its
#: median and spread; full and none took 3 until phase 30 came
TRAIN_POLICY_STEPS = {"selective": TRAIN_STEPS, "full": 2, "none": 2}


def train_launches(layers: int, policy: str, accum: int = TRAIN_ACCUM) -> dict:
    """Kernel launches per step of a decoder of ``layers`` layers (dense or
    MoE FFN) in ``accum`` microbatches.  A forward launches K1 once per
    layer and K2 twice per layer plus once for the final norm (16, 33 at 16
    layers); a recomputing policy reruns each layer's forward in its
    backward up to the FFN's last product, both norms and the attention
    included (16, 32 more).  The backward runs K2's backward kernel once per
    norm (33; the non-reentrant recompute reruns forwards, not backwards)
    under every policy; K1's backward is plain torch.  No gated K2, no K3."""
    again = policy != "none"
    return {"flash_attention_fwd": layers * (1 + again) * accum,
            "rmsnorm": (2 * layers + 1 + 2 * layers * again) * accum, "rmsnorm_gated": 0,
            "rmsnorm_bwd": (2 * layers + 1) * accum, "ssd": 0, "ssd_autograd": 0}


#: llama3.2-1b's (16 layers): per step K1 64 / 128, K2 132 / 260, K2's backward 132
TRAIN_LAUNCHES = {policy: train_launches(16, policy) for policy in TRAIN_POLICIES}
#: profiler spans of the training step, innermost first
TRAIN_SPANS = {"attention_vjp": "attention backward (recompute)", "optimizer": "optimizer"}
#: the Mamba2 family's: K3's backward recompute in place of attention's
SSM_TRAIN_SPANS = {"ssd_vjp": "SSD backward (recompute)", "optimizer": "optimizer"}


def train_flops(cfg, batch: int, seq: int) -> tuple[int, float, float]:
    """(matmul parameters, their FLOPs, attention FLOPs) of one step: 6 x
    the parameters of the matrix products a token goes through (q/k/v/out
    projections, FFN — for an MoE FFN the router, its top-k experts and the
    shared expert —, LM head; not the embedding gather or the norms) x
    tokens, plus causal attention at 3 (forward, and twice that backward) x
    layers x 4·B·H·S²·hd / 2.  The capacity slots an MoE layer computes
    empty or past its tokens are not model FLOPs."""
    L, d, H, KV, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)
    n_ffn = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    ffn = n_ffn * d * cfg.d_ff
    if cfg.num_experts:
        ffn = d * cfg.num_experts + cfg.experts_per_token * ffn \
            + n_ffn * d * cfg.shared_expert_ff
    matmul_params = L * (d * (H + 2 * KV) * hd + H * hd * d + ffn) + cfg.vocab_size * d
    dense = 6.0 * matmul_params * batch * seq
    attn = 3.0 * L * 4.0 * batch * cfg.num_heads * seq * seq * hd / 2.0
    return matmul_params, dense, attn


def _uniform_plan(cfg, policy: str):
    from repro_torch.core.strategy import LayerStrategy, uniform_plan

    return uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat=policy), grad_accum=TRAIN_ACCUM)


def _train_bundle(torch, cfg, plan, *, impl: str = "kernel", seed: int = 0):
    from repro_torch.models import build_model
    from repro_torch.runtime import train as train_rt

    hp = train_rt.construct_hybrid_parallel_model(build_model(cfg, impl=impl), plan)
    params = hp.init_params(torch.Generator(device="cuda").manual_seed(seed))
    return hp, params


def train_plan(torch, counters, label: str, plan, steps: int, flops: float, cfg=None, *,
               seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, donate: bool = False):
    """``steps`` train steps of ``cfg`` (full-width llama3.2-1b by default)
    under ``plan`` from fresh state, ``batch`` x ``seq`` tokens a step;
    ``donate`` updates the state in place (``train_step(..., donate=True)``:
    one copy of the fp32 state, not two); returns the record of the run and
    (hp, params, opt, ds) for the profile."""
    import functools
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.data import SyntheticDataset

    cfg = cfg or get_config(TRAIN_ARCH)
    hp, params = _train_bundle(torch, cfg, plan)
    opt = hp.init_opt_state(params)
    ds = SyntheticDataset(cfg, seq_len=seq, global_batch=batch, seed=0)
    batches = [ds.batch(i) for i in range(steps)]
    step_fn = functools.partial(hp.train_step, donate=True) if donate else hp.jit_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    times, losses, gnorms, auxes = [], [], [], []
    for data in batches:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times)
    tokens = batch * seq
    mfu = flops / (step_s * PEAK_FLOPS["bfloat16"])
    log(f"train [{label}]: {steps} steps of {batch} x {seq} tokens "
        f"(grad_accum {plan.grad_accum}): losses {[round(x, 5) for x in losses]}  grad_norm "
        f"{[round(x, 5) for x in gnorms]}  aux (last microbatch) {[round(x, 5) for x in auxes]}  "
        f"step times {[round(t, 4) for t in times]} s, "
        f"median {step_s:.4f} s  {tokens / step_s:.1f} tokens/s  peak mem {peak / 1e9:.2f} GB  "
        f"MFU {100 * mfu:.2f} %  launches per step K1 {launches['flash_attention_fwd'] / steps:g}, "
        f"K2 {launches['rmsnorm'] / steps:g}, K2 backward {launches['rmsnorm_bwd'] / steps:g}")
    require(all(math.isfinite(x) for x in losses + gnorms), f"non-finite train metrics: "
            f"{label} {losses} {gnorms}")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"first loss {losses[0]} is not near ln(vocab) {math.log(cfg.vocab_size):.3f}")
    record = dict(label=label, losses=losses, grad_norms=gnorms, auxes=auxes, times=times,
                  step_s=step_s, tokens_per_s=tokens / step_s, peak_bytes=peak, mfu=mfu,
                  launches=launches)
    return record, (hp, params, opt, ds)


def train_policy(torch, counters, policy: str, steps: int, flops: float):
    """``train_plan`` under one remat policy at grad_accum 4, its kernel
    launches per step pinned (``TRAIN_LAUNCHES``)."""
    from repro_torch.configs.registry import get_config

    plan = _uniform_plan(get_config(TRAIN_ARCH), policy)
    record, bundle = train_plan(torch, counters, policy, plan, steps, flops)
    expected = {name: n * steps for name, n in TRAIN_LAUNCHES[policy].items()}
    require(record["launches"] == expected, f"train [{policy}] launched "
            f"{record['launches']}, expected {expected}")
    return record, bundle


def profile_train_step(torch, hp, params, opt, batch,
                       what: str = f"[selective] ({TRAIN_BATCH} x {TRAIN_SEQ} tokens)",
                       donate: bool = False, spans: dict = TRAIN_SPANS) -> None:
    """One train step under torch.profiler (``donate``: the state updated in
    place): device time by group — K1, K2, K2's backward, K3, the attention
    backward's (or, with ``SSM_TRAIN_SPANS``, the SSD backward's) recompute
    and the optimizer (kernels inside ``spans`` on the device timeline),
    then matmuls, elementwise and copies by kernel name — and the busy
    share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = hp.train_step(params, opt, batch, donate=donate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(all(bool(torch.isfinite(v).all()) for v in out[2].values()),
            "non-finite metrics in the profiled train step")
    del out
    rename = {"flash_attention": "K1 flash_attention_fwd", "rmsnorm": "K2 rmsnorm",
              "rmsnorm_bwd": "K2 rmsnorm backward", "ssd": "K3 ssd", "other": "elementwise"}
    groups, counts, _, seen = device_groups(
        prof, spans, lambda name: rename.get(_kernel_group(name), _kernel_group(name)))
    if not seen:
        log(f"profile: train step: the device timeline lacks one of the spans {sorted(spans)}; "
            "its kernels fall into the name groups (see the timed components)")
    busy = sum(groups.values())
    if busy == 0.0:
        log("profile: train step: device time not measured (the profiler saw no kernels)")
        return
    per = {g: round(t, 4) for g, t in sorted(groups.items(), key=lambda x: -x[1])}
    share = {g: round(100 * t / busy, 1) for g, t in per.items()}
    log(f"profile: train step {what}: wall "
        f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% "
        f"of wall); device ms by group {per}; % of busy {share}; launches {counts}")


def time_train_components(torch, cfg, params, opt) -> None:
    """CUDA-event times of the step's two plain-torch components at full
    width: one layer's attention backward (the recompute through
    ``chunked_attention``, 16 x 4 per step) and one AdamW update of the
    whole fp32 state (the params stand in for the grads)."""
    from repro_torch.models.attention import chunked_attention_vjp
    from repro_torch.runtime import optimizer as opt_lib

    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S = TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, g = (torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16() for _ in "qg")
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device="cuda").bfloat16() for _ in "kv")
    vjp_ms = device_ms(lambda: chunked_attention_vjp(q, k, v, g, causal=True), torch,
                       inner=1, reps=3)
    calls = cfg.num_layers * TRAIN_ACCUM
    cfg = opt_lib.AdamWConfig()
    adam_ms = device_ms(lambda: opt_lib.adamw_update(params, params, opt, cfg), torch,
                        inner=1, reps=3)
    log(f"train components: attention backward recompute {vjp_ms:.3f} ms per layer call "
        f"(B{B} S{S} H{H} KV{KV} hd{hd} bf16) x {calls} per step = {vjp_ms * calls:.1f} ms; "
        f"AdamW update of the full fp32 state {adam_ms:.3f} ms per step")
    del q, g, k, v


def parity_train(torch, cfg=None, seq: int = 1024, batch: int = 2) -> None:
    """Kernel path against plain path on ``cfg`` (full-width llama3.2-1b
    cut to 2 layers by default), ``batch`` x ``seq`` tokens, same weights.
    fp32: loss within 1e-4 relative, every grad and every parameter after
    one AdamW step within 2e-3 of its leaf's largest magnitude.  bf16: loss
    within 3e-2 relative, and the kernel path's grads no further from the
    fp32 plain path than twice the bf16 plain path's.  An MoE model also
    logs the share of routing decisions on which the paths agree; a VLM's
    batch gets seeded standard normal patch embeddings in place of the
    dataset's zeros."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.runtime import optimizer as opt_lib
    from repro_torch.runtime.data import SyntheticDataset

    cfg = cfg or dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2)
    data = SyntheticDataset(cfg, seq_len=seq, global_batch=batch, seed=1).batch(0)
    if "vis_embeds" in data:    # the dataset's prefix is zeros, as JAX's: compare a real one
        gen = torch.Generator().manual_seed(2)
        data["vis_embeds"] = torch.randn(data["vis_embeds"].shape, generator=gen).to(
            data["vis_embeds"].dtype)
    paths = None

    def rel_err(a_leaves, b_leaves):
        """The largest error / leaf scale, and its leaf's path."""
        errs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(a_leaves, b_leaves)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], "/".join(paths[i])

    out, ref = {}, None
    for name, impl, dtype in (("ref32", "ref", torch.float32),
                              ("kernel32", "kernel", torch.float32),
                              ("kernel", "kernel", torch.bfloat16),
                              ("ref", "ref", torch.bfloat16)):
        hp, params = _train_bundle(torch, cfg, _uniform_plan(cfg, "selective"), impl=impl,
                                   seed=1)
        with RoutingLog() as routes:
            loss, _, grads = hp.value_and_grad(params, data, dtype)
        new = None
        if dtype == torch.float32:
            new, _, _ = opt_lib.adamw_update(params, grads, hp.init_opt_state(params),
                                             hp.opt_cfg)
        routes.idx = routes.idx[:cfg.num_layers]       # the forward's, not the recompute's
        paths = paths or [p for p, _ in tree_paths(grads)]
        if ref is None:
            ref = (float(loss), tree_leaves(grads), tree_leaves(new), routes)
        else:
            out[name] = (float(loss), rel_err(tree_leaves(grads), ref[1]),
                         new and rel_err(tree_leaves(new), ref[2]), routes.agreement(ref[3]))
        del hp, params, grads, new, routes
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    l32 = ref[0]
    lk32, (gerr32, gpath), (perr32, ppath), agree32 = out["kernel32"]
    lerr32 = abs(lk32 - l32) / abs(l32)
    lerr = abs(out["kernel"][0] - out["ref"][0]) / abs(out["ref"][0])
    (err_k, kpath), (err_r, rpath) = out["kernel"][1], out["ref"][1]
    routing = ""
    if ref[3].idx:
        routing = (f"; routing agreement with the fp32 plain path: kernel fp32 {agree32:.6f}, "
                   f"kernel bf16 {out['kernel'][3]:.6f}, plain bf16 {out['ref'][3]:.6f} of "
                   f"{sum(a.numel() for a in ref[3].idx)} (token, layer, choice) decisions")
    log(f"parity: train, {cfg.name} full width x {cfg.num_layers} layers, {batch} x {seq} "
        f"tokens: fp32 loss {lk32:.6f} vs {l32:.6f} (rel {lerr32:.2e}, tol 1e-4); grads max "
        f"err / leaf scale {gerr32:.2e} ({gpath}), params after AdamW {perr32:.2e} ({ppath}) "
        f"(tol 2e-3); bf16 loss rel {lerr:.2e} (tol 3e-2); bf16 grads vs fp32 plain (err / "
        f"leaf scale): kernel {err_k:.3e} ({kpath}), plain {err_r:.3e} ({rpath}){routing}")
    require(lerr32 <= 1e-4, "fp32 train loss: kernel path differs from the plain path")
    require(gerr32 <= 2e-3 and perr32 <= 2e-3,
            "fp32 grads or updated params: kernel path differs from the plain path")
    require(lerr <= 3e-2, "bf16 train loss: kernel path differs from the plain path")
    require(err_k <= 2.0 * err_r,
            "bf16 grads: the kernel path is further from fp32 than the plain bf16 path x2")
    del out, ref
    torch.cuda.empty_cache()


def train_phase(torch, counters) -> tuple[dict, float]:
    """Phase 10: the three remat policies at full width, the selective step's
    profile and components, and kernel-vs-plain parity.  Returns the
    selective run's launches (the train path's counts) and step times."""
    import gc

    from repro_torch.configs.registry import get_config

    cfg = get_config(TRAIN_ARCH)
    n_params, dense, attn = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    flops = dense + attn
    log(f"train: {cfg.name} full width ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, tied); model FLOPs per step = 6 x {n_params} matmul params "
        f"x {TRAIN_BATCH * TRAIN_SEQ} tokens ({dense:.4e}) + 3 x {cfg.num_layers} layers x "
        f"4·B·H·S²·hd/2 causal attention ({attn:.4e}) = {flops:.4e}; bound at the bf16 peak "
        f"{flops / PEAK_FLOPS['bfloat16']:.4f} s")
    launches = selective = None
    for policy in TRAIN_POLICIES:
        record, (hp, params, opt, ds) = train_policy(torch, counters, policy,
                                                     TRAIN_POLICY_STEPS[policy], flops)
        if policy == "selective":
            launches = record["launches"]
            selective = record["times"]
            profile_train_step(torch, hp, params, opt, ds.batch(TRAIN_STEPS))
            time_train_components(torch, cfg, params, opt)
        del hp, params, opt, ds
        gc.collect()
        torch.cuda.empty_cache()
    parity_train(torch)
    return launches, selective


# ---------------------------------------------------------------- phase 11

PROFILE_SEQS, PROFILE_MB, PROFILE_ITERS = (1024, 4096), 2, 3
PLAN_PROFILE_ARGS = ["--full", "--seq", ",".join(map(str, PROFILE_SEQS)), "--dtype", "bf16",
                     "--microbatch", str(PROFILE_MB)]
LAUNCHER_ARGS = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                 "--grad-accum", str(TRAIN_ACCUM), "--remat", "selective",
                 "--steps", str(TRAIN_STEPS)]
#: the launcher's median step against phase 10's selective median: 5 %, or
#: the spread of phase 10's own selective steps (max / min - 1) when the
#: card's host makes that wider — a difference inside it is not resolved
LAUNCHER_STEP_TOL = 0.05


def _src_env() -> dict:
    """This environment with the checkout's ``src`` first on PYTHONPATH, for
    the launchers run as subprocesses."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def _run_captured(fn, argv) -> tuple[int, str]:
    """``fn(argv)``'s return code and standard output (also logged)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return rc, out


def profile_launches(graphed: bool) -> dict:
    """Kernel launches of ``launch.profile`` measuring the ``PROFILE_SEQS``
    cells of a decoder block (dense or MoE FFN).  Each of a cell's three
    steps is called once untimed, then ``PROFILE_ITERS`` times: eagerly
    that is 1 + iters calls; graphed, the first call runs
    ``compiled.WARMUP`` eager calls, captures, and replays, so WARMUP + 1 +
    iters calls' launches.  Per call the forward
    launches K1 once and K2 twice; the grad adds K2's backward for both
    norms; the full-remat grad reruns the forward in its backward (K1 2, K2
    4).  Two eager forwards more read the peak (the first one warms the
    current stream)."""
    from repro_torch.runtime.compiled import WARMUP

    cells = len(PROFILE_SEQS)
    calls = (WARMUP + 1 if graphed else 1) + PROFILE_ITERS
    return {"flash_attention_fwd": cells * (calls * (1 + 1 + 2) + 2),
            "rmsnorm": cells * (calls * (2 + 2 + 4) + 4), "rmsnorm_gated": 0,
            "rmsnorm_bwd": cells * calls * (2 + 2), "ssd": 0, "ssd_autograd": 0}


def profile_and_calibrate(counters, cfg, cache_path: str, label: str):
    """``launch.profile`` over ``cfg``'s two full-width cells (S 1024 and
    4096, microbatch 2, bf16) into a fresh cache, each step a CUDA graph:
    the launches pinned (``profile_launches``); per cell the graphed times
    beside the same cell measured eagerly (``compiled=False``), the peak,
    TFLOP/s against the analytic FLOPs and peak over predicted activations;
    a second pass measures nothing; the calibration fitted from the cache.
    Returns (cache entries by seq, calibration)."""
    from repro_torch.core import calibrate as cal
    from repro_torch.core import profile_cache as pcache
    from repro_torch.core.profiler_model import measure_block
    from repro_torch.launch import profile as profile_cli

    argv = ["--arch", cfg.name, *PLAN_PROFILE_ARGS, "--cache", cache_path]
    zero_counts(counters)
    t0 = time.perf_counter()
    rc, out = _run_captured(profile_cli.main, argv)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    require(rc == 0 and f"profile: {len(PROFILE_SEQS)} cell(s) measured" in out,
            f"the profile launcher did not measure {cfg.name}'s {len(PROFILE_SEQS)} cells")
    expected = profile_launches(graphed=True)
    log(f"{label}: profiling ({wall:.1f} s) launched K1 {launches['flash_attention_fwd']}, K2 "
        f"{launches['rmsnorm']} and K2's backward {launches['rmsnorm_bwd']} times (graphed: "
        f"expected {expected}; eager would launch {profile_launches(graphed=False)})")
    require(launches == expected, f"profiling {cfg.name} launched {launches}, not the "
            f"graphed steps' {expected}")
    cache = pcache.ProfileCache.load(cache_path)
    entries = {e.key.seq: e for e in cache.entries.values()}
    for seq in PROFILE_SEQS:
        e = entries[seq]
        eager = measure_block(cfg, seq, batch=PROFILE_MB, iters=PROFILE_ITERS, compiled=False)
        log(f"{label}: cell {e.key.id()}: graphed | eager: fwd {e.fwd_time_s * 1e3:.4f} | "
            f"{eager.fwd_time_s * 1e3:.4f} ms  bwd {e.bwd_time_s * 1e3:.4f} | "
            f"{eager.bwd_time_s * 1e3:.4f} ms  remat extra {e.remat_extra_s * 1e3:.4f} | "
            f"{eager.remat_extra_s * 1e3:.4f} ms (remat extra / fwd "
            f"{e.remat_extra_s / e.fwd_time_s:.3f} | {eager.remat_extra_s / eager.fwd_time_s:.3f}; "
            f"bwd / fwd "
            f"{e.bwd_time_s / e.fwd_time_s:.3f} | {eager.bwd_time_s / eager.fwd_time_s:.3f})  "
            f"peak {e.peak_bytes / 1e9:.4f} GB  (analytic fwd FLOPs {e.flops_fwd:.4e}, "
            f"{e.flops_fwd / e.fwd_time_s / 1e12:.1f} | "
            f"{e.flops_fwd / eager.fwd_time_s / 1e12:.1f} TFLOP/s; predicted activations "
            f"{e.act_bytes_pred / 1e9:.4f} GB, peak / predicted "
            f"{e.peak_bytes / e.act_bytes_pred:.3f})")
        require(e.fwd_time_s > 0 and e.bwd_time_s > 0 and e.peak_bytes > 0,
                f"a measured cell is not positive: {e.key.id()}")
    zero_counts(counters)
    rc, out = _run_captured(profile_cli.main, argv)
    require(rc == 0 and "profile: 0 cell(s) measured" in out,
            "the second profiling pass measured again")
    require(not any(read_counts(counters).values()), "the second profiling pass launched kernels")
    calibration = cal.load_calibration(cache_path)
    require(calibration.source == "measured" and calibration.throughput.get("bf16", 0) > 0,
            "the calibration fitted no bf16 throughput")
    log(f"{label}: calibration\n" + calibration.format_table())
    return entries, calibration


def plan_cost(cfg, plan, calibration) -> tuple[float, float]:
    """(step seconds, bytes per device) the cost and memory models predict
    for ``plan`` on one H100 under ``calibration``: the search's own sum
    over layers plus the head (one device: no transitions, no pipeline)."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import memory_model as mm
    from repro_torch.core.cluster import H100_1
    from repro_torch.core.profiler_model import profile_model

    profile = profile_model(cfg, TRAIN_SEQ, causal_frac=0.5)
    env = cm.CostEnv(cluster=H100_1, devices=1, pp=1, micro_batch=TRAIN_BATCH // plan.grad_accum,
                     grad_accum=plan.grad_accum, calibration=calibration)
    t = sum(cm.layer_step_time(lp, s, env)
            for lp, s in zip(profile.layers, plan.layer_strategies))
    t += cm.head_time(profile, plan.default_strategy, env)
    mem = mm.plan_memory(profile, list(plan.layer_strategies), env,
                         fixed_strategy=plan.default_strategy)
    return t, mem


def _plan_summary(plan) -> str:
    policies = sorted({s.remat for s in plan.layer_strategies})
    zeros = sorted({s.zero for s in plan.layer_strategies})
    return (f"grad_accum {plan.grad_accum}, remat {policies} over {len(plan.layer_strategies)} "
            f"layers, zero {zeros}, strategies {[s.short() for s in dict.fromkeys(plan.layer_strategies)]}")


def planner_phase(torch, counters, selective: list) -> None:
    """Phase 11: profile two dense blocks on the card into a fresh cache,
    calibrate, search the one-H100 plan analytically and calibrated, train
    the calibrated plan for 3 full-width steps, and run the train launcher
    as a user would."""
    import gc
    import os
    import re
    import tempfile

    from repro_torch.analysis import plan_check
    from repro_torch.configs.registry import get_config
    from repro_torch.core import calibrate as cal
    from repro_torch.core.cluster import H100_1
    from repro_torch.core.profiler_model import measure_block, profile_model
    from repro_torch.core.search import SearchEngine

    cfg = get_config(TRAIN_ARCH)
    _, dense, attn = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    with tempfile.TemporaryDirectory() as tmp:
        cache_path = os.path.join(tmp, "cuda.json")

        # 1. profile (graphed, beside eager), calibrate
        entries, calibration = profile_and_calibrate(counters, cfg, cache_path, "planner")
        zeros = entries[TRAIN_SEQ]
        rnd = measure_block(cfg, TRAIN_SEQ, batch=PROFILE_MB, input_seed=0)
        log(f"planner: the s{TRAIN_SEQ} mb2 cell with x ~ N(0, 1) in place of zeros: fwd "
            f"{rnd.fwd_time_s * 1e3:.4f} ms (zeros {zeros.fwd_time_s * 1e3:.4f})  bwd "
            f"{rnd.bwd_time_s * 1e3:.4f} ms (zeros {zeros.bwd_time_s * 1e3:.4f})  remat extra "
            f"{rnd.remat_extra_s * 1e3:.4f} ms (zeros {zeros.remat_extra_s * 1e3:.4f})")
        del rnd
        gc.collect()
        torch.cuda.empty_cache()

        # 2. search, analytic and calibrated
        profile = profile_model(cfg, TRAIN_SEQ, causal_frac=0.5)
        plans = {}
        for name, c in (("analytic", cal.DEFAULT_CALIBRATION), ("calibrated", calibration)):
            res = SearchEngine(cfg, cluster=H100_1, calibration=c).search(
                TRAIN_SEQ, TRAIN_BATCH, arch=cfg.name, shape_name="train_4k")
            require(res.feasible, f"the {name} search found no feasible plan")
            plan = res.plan
            step_pred, mem_pred = plan_cost(cfg, plan, c)
            require(abs(step_pred - plan.predicted_step_time) <= 1e-9 * step_pred,
                    f"the {name} plan's cost ({step_pred}) is not its prediction "
                    f"({plan.predicted_step_time})")
            report = plan_check.check_plan(plan, H100_1, cfg, seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH, profile=profile,
                                           calibration=c)
            log(f"planner: {name} search ({res.evaluated} combos, {res.search_seconds:.3f} s, "
                f"rejections {res.rejections}): {_plan_summary(plan)}; predicted step "
                f"{plan.predicted_step_time:.6f} s, memory {mem_pred / 1e9:.4f} GB "
                f"(memory_model.plan_memory); check_plan: {report.codes() or 'no diagnostics'}")
            require(report.ok(), f"the {name} plan fails check_plan: {report.error_codes()}")
            plans[name] = plan

        # 3. train the calibrated plan (an out-of-memory error is not caught)
        plan = plans["calibrated"]
        record, bundle = train_plan(torch, counters, "calibrated plan", plan, TRAIN_STEPS,
                                    dense + attn)
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
        launches = record["launches"]
        norms = 2 * cfg.num_layers + 1
        require(launches["flash_attention_fwd"] > 0 and launches["rmsnorm"] > 0,
                f"the calibrated plan's steps did not run K1 and K2: {launches}")
        require(launches["rmsnorm_bwd"] == norms * plan.grad_accum * TRAIN_STEPS,
                f"the calibrated plan ran K2's backward {launches['rmsnorm_bwd']} times, "
                f"expected {norms} per microbatch")
        for name, c in (("analytic", cal.DEFAULT_CALIBRATION), ("calibrated", calibration)):
            step_pred, mem_pred = plan_cost(cfg, plan, c)
            timed = dataclasses.replace(plan, predicted_step_time=step_pred)
            drift = plan_check.check_plan(timed, H100_1, cfg, seq_len=TRAIN_SEQ,
                                          measured_step_time=record["step_s"])
            log(f"planner: calibrated plan, {name} prediction: step {step_pred:.6f} s vs "
                f"measured {record['step_s']:.6f} s (x{record['step_s'] / step_pred:.3f}); "
                f"memory {mem_pred / 1e9:.4f} GB vs peak {record['peak_bytes'] / 1e9:.4f} GB "
                f"(x{record['peak_bytes'] / mem_pred:.3f}); GALV070: "
                + ("; ".join(map(str, drift.diagnostics)) or "within the band"))
        log(f"planner: calibrated plan: median step {record['step_s']:.4f} s, "
            f"{record['tokens_per_s']:.1f} tokens/s, MFU {100 * record['mfu']:.2f} %, peak "
            f"{record['peak_bytes'] / 1e9:.2f} GB, launches per step K1 "
            f"{launches['flash_attention_fwd'] / TRAIN_STEPS:g}, K2 "
            f"{launches['rmsnorm'] / TRAIN_STEPS:g}, K2 backward "
            f"{launches['rmsnorm_bwd'] / TRAIN_STEPS:g}")

        # 4. the train launcher, as a user runs it
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCHER_ARGS,
               "--log-every", "1", "--profile-cache", cache_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=_src_env(), capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"  | {line}")
        require(proc.returncode == 0, f"the train launcher exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        times = [float(x) / 1e3 for x in
                 re.findall(r"^step \d+ loss \S+ grad_norm \S+ step_time (\S+) ms",
                            proc.stdout, re.MULTILINE)]
        require(len(times) == TRAIN_STEPS, f"the launcher logged {len(times)} steps")
        median = statistics.median(times)
        selective_s = statistics.median(selective)
        gap = median / selective_s - 1.0
        tol = max(LAUNCHER_STEP_TOL, max(selective) / min(selective) - 1.0)
        log(f"planner: launcher ({wall:.1f} s of wall) steps {[round(x, 4) for x in times]} s, "
            f"median {median:.4f} s vs phase 10's selective {selective_s:.4f} s (steps "
            f"{[round(x, 4) for x in selective]}): {100 * gap:+.2f} %, tol {100 * tol:.2f} % "
            f"(5 % or phase 10's own spread)")
        require(abs(gap) <= tol, "the launcher's step differs from phase 10's selective step "
                "by more than the tolerance")
        for prefix in ("plan[", "predicted (", "GALV070:"):
            require(any(line.startswith(prefix) for line in proc.stdout.splitlines()),
                    f"the launcher printed no {prefix!r} line")


# ---------------------------------------------------------------- phases 12-14

MOE_ARCH = "moonshot-v1-16b-a3b"
#: full width cut in depth where the full model does not fit the card: the
#: fp32 parity (115 GB at 48 layers) and training (fp32 masters, grads and
#: AdamW state: ~462 GB at 48 layers)
MOE_PARITY_LAYERS, MOE_TRAIN_LAYERS = 4, 2


def moe_serve_phase(torch, np, serving, build_model, get_config, counters) -> dict:
    """Phases 12-13: full-width, full-depth moonshot served through the step
    engine (``serve_step_engine``: K1 48 and K2 97 launches per forward
    pinned), profiled, served again through its compiled prefill and decode
    steps (12b, ``graphed_serve``), then ``parity_moe``; frees its weights.
    Returns the serve run's launches."""
    engine, params, prompts, launches, eager = serve_step_engine(
        torch, np, serving, build_model, get_config, counters, MOE_ARCH)
    profile_step_engine(torch, engine, params, prompts)
    graphed_serve(torch, engine, params, prompts, None, STATIC_NEW, eager, counters,
                  prefill_graph=True)
    gc.collect()                    # the graphs' pool goes before the full-depth parity
    torch.cuda.empty_cache()
    parity_moe(torch, np, serving, build_model, get_config(MOE_ARCH).reduced(), engine, params,
               prompts)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_train_phase(torch, counters) -> dict:
    """Phase 14: moonshot at full width cut to ``MOE_TRAIN_LAYERS`` layers
    trained ``TRAIN_STEPS`` steps of 8 x 4096 tokens (grad_accum 4,
    ``selective``) from fresh state: losses, aux (finite, > 0), step time,
    tokens/s, peak memory, MFU; K1/K2/K2-backward launches per step pinned
    (``train_launches``); then ``parity_train`` on one microbatch (2 x
    4096).  Returns the run's launches."""
    import gc
    import math

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    n_params, dense, attn = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log(f"train: {cfg.name} full width cut to {cfg.num_layers} layers (cuts: depth 48 -> "
        f"{cfg.num_layers}, global batch 8 x {TRAIN_SEQ}); model FLOPs per step = 6 x {n_params} "
        f"active matmul params x {TRAIN_BATCH * TRAIN_SEQ} tokens ({dense:.4e}) + causal "
        f"attention ({attn:.4e}); bound at the bf16 peak "
        f"{(dense + attn) / PEAK_FLOPS['bfloat16']:.4f} s; the card holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    plan = _uniform_plan(cfg, "selective")
    record, bundle = train_plan(torch, counters, f"{cfg.name.split('-')[0]} selective", plan,
                                TRAIN_STEPS, dense + attn, cfg)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    expected = {name: n * TRAIN_STEPS
                for name, n in train_launches(cfg.num_layers, "selective").items()}
    require(record["launches"] == expected,
            f"moonshot train launched {record['launches']}, expected {expected}")
    require(all(math.isfinite(a) and a > 0.0 for a in record["auxes"]),
            f"moonshot aux loss not finite and positive: {record['auxes']}")
    parity_train(torch, cfg, seq=TRAIN_SEQ, batch=TRAIN_BATCH // TRAIN_ACCUM)
    return record["launches"]


def parity_moe(torch, np, serving, build_model, small_cfg, engine, params, prompts) -> None:
    """(a) the reduced moonshot in fp32: identical greedy tokens on both
    paths; (b) full width and depth in bf16: the kernel path's and the plain
    path's last-position logits, their top-1 agreement, the share of routing
    decisions on which they agree and the prefill's capacity-drop share; (c)
    full width cut to ``MOE_PARITY_LAYERS`` layers (the served weights'
    first layers: fp32 at full depth would be 115 GB) under
    ``parity_prefill``'s rules.  Frees the served weights before (c)."""
    import gc

    from repro_torch.models.common import tree_map
    from repro_torch.models.moe import _capacity

    cfg = engine.model.cfg
    parity_reduced(torch, np, serving, build_model, small_cfg, "moonshot")
    model_k = engine.model
    model_r = build_model(cfg, impl="ref")
    toks = torch.from_numpy(prompts).cuda()
    out, routes = {}, {}
    for name, model in (("kernel", model_k), ("ref", model_r)):
        with RoutingLog() as routes[name]:
            logits, cache = model.forward_prefill(params, toks, dtype=torch.bfloat16)
        out[name] = logits[:, -1]
        del logits, cache
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(v).all()) for v in out.values()),
            "non-finite full-depth moonshot logits")
    require(len(routes["kernel"].idx) == cfg.num_layers, "a MoE layer was not routed")
    err = float((out["kernel"] - out["ref"]).abs().max())
    scale = float(out["ref"].abs().max())
    top1 = float((out["kernel"].argmax(-1) == out["ref"].argmax(-1)).float().mean())
    per_layer = [float((a == b).float().mean())
                 for a, b in zip(routes["kernel"].idx, routes["ref"].idx)]
    log(f"parity: full-depth moonshot bf16 prefill logits {tuple(out['ref'].shape)}: "
        f"kernel-vs-plain max_abs_err {err:.3e} (max |logit| {scale:.3f}), top-1 agreement "
        f"{top1:.4f}; routing agreement {routes['kernel'].agreement(routes['ref']):.6f} of "
        f"{sum(a.numel() for a in routes['kernel'].idx)} (token, layer, choice) decisions "
        f"(first layer {per_layer[0]:.6f}, last {per_layer[-1]:.6f}); dropped past capacity "
        f"(C {_capacity(cfg, toks.numel())} slots an expert): kernel "
        f"{routes['kernel'].drop_share():.4f}, plain "
        f"{routes['ref'].drop_share():.4f}")
    del out, routes

    # (c) the first layers' weights, cloned so the rest can go
    L = MOE_PARITY_LAYERS
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": tree_map(lambda x: x[:L].clone(), params["blocks"])}
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg_cut = dataclasses.replace(cfg, num_layers=L)
    parity_prefill(torch, "moonshot", build_model(cfg_cut), build_model(cfg_cut, impl="ref"),
                   cut, toks, f"full-width {L}-layer")
    del cut
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 23

#: the searched moonshot plan is trained at full width cut to 2 layers, as
#: phase 14 trains (fp32 masters, grads and AdamW state for 48: ~462 GB)
MOE_PLAN_LAYERS = 2
MOE_VALIDATE_ARGS = ["--arch", MOE_ARCH, "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                     "--grad-accum", str(TRAIN_ACCUM), "--remat", "selective", "--validate-only"]
#: the microbatch counts the trained plan is searched over.  The plan of
#: the unconstrained search, grad_accum 2 (tp1-z0, predicted 73.52 GB, no
#: diagnostic), asks for 69.93 GiB allocated + a 10.00 GiB request (the
#: fp32 logits' grad) = 85.8 GB in its first backward, past the card's
#: 79.18 GiB; the cost model prices grad_accum 2 and 4 alike on one card
#: (0.1824 s), so the search takes the smaller count of the tie
MOE_PLAN_GRAD_ACCUM = [4, 8]
#: the trained plan's peak with the cyclic collector off against on
COLLECTOR_PEAK_TOL = 0.01


def moe_planner_phase(torch, counters) -> dict:
    """Phase 23: Galvatron's loop for the MoE family.  ``launch.profile``
    measures two full-width moonshot blocks as CUDA graphs (beside eager),
    the calibration is fitted from that cache alone, the one-H100 search
    finds no plan at full depth (analytic and calibrated) and, cut to
    ``MOE_PLAN_LAYERS`` layers, the analytic one finds a plan (its cost,
    ``check_plan``) while the calibrated one finds none: its ``mem_scale``
    (peak over predicted activations, the peak counting the block's 1.18 GB
    of expert weights) prices the cut past the card.  The analytic search
    over ``MOE_PLAN_GRAD_ACCUM`` gives the plan that trains ``TRAIN_STEPS``
    steps twice, with the cyclic collector on and off
    (launches pinned, peaks equal, both predictions against the measured
    step and peak, GALV070), and ``launch.train --validate-only`` refuses
    the full model through ``plan_check`` (GALV020, exit 1).  Returns the
    trained plan's launches."""
    import tempfile

    from repro_torch.analysis import plan_check
    from repro_torch.configs.registry import get_config
    from repro_torch.core import calibrate as cal
    from repro_torch.core import profile_cache as pcache
    from repro_torch.core.cluster import H100_1
    from repro_torch.core.profiler_model import profile_model
    from repro_torch.core.search import SearchEngine

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    cut = dataclasses.replace(cfg, num_layers=MOE_PLAN_LAYERS)

    # 1. profile (graphed, beside eager), calibrate
    with tempfile.TemporaryDirectory() as tmp:
        entries, calibration = profile_and_calibrate(
            counters, cfg, os.path.join(tmp, "cuda.json"), "moe planner")
    gc.collect()
    torch.cuda.empty_cache()
    mk = pcache.model_key(cfg)
    cells = list(entries.values())
    k_fit, k_r2 = cal._origin_fit([e.fwd_time_s for e in cells], [e.bwd_time_s for e in cells])
    r_fit, r_r2 = cal._origin_fit([e.fwd_time_s for e in cells],
                                  [e.remat_extra_s for e in cells])
    log(f"moe planner: bwd / fwd fitted {k_fit:.4f} (R2 {k_r2:.4g}); the calibration keeps "
        f"{calibration.bwd_factor(mk):.4f} (_BWD_RANGE {cal._BWD_RANGE}); remat extra / fwd "
        f"fitted {r_fit:.4f} (R2 {r_r2:.4g}), kept {calibration.remat_overhead:.4f} "
        f"(_REMAT_RANGE {cal._REMAT_RANGE}); mem_scale {calibration.mem_scale:.4f}")

    # 2. search: no plan at full depth; cut to MOE_PLAN_LAYERS layers, the
    # analytic one (the calibrated mem_scale prices the cut past the card),
    # then the analytic one over MOE_PLAN_GRAD_ACCUM, the plan trained
    trained = None
    for name, c, model, accum in (
            ("analytic", cal.DEFAULT_CALIBRATION, cfg, None),
            ("analytic", cal.DEFAULT_CALIBRATION, cut, None),
            ("calibrated", calibration, cfg, None),
            ("calibrated", calibration, cut, None),
            ("analytic", cal.DEFAULT_CALIBRATION, cut, MOE_PLAN_GRAD_ACCUM)):
        res = SearchEngine(model, cluster=H100_1, calibration=c).search(
            TRAIN_SEQ, TRAIN_BATCH, arch=model.name, shape_name="train_4k",
            grad_accum_options=accum)
        plan = res.plan
        step_pred, mem_pred = plan_cost(model, plan, c)
        report = plan_check.check_plan(plan, H100_1, model, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH,
                                       profile=profile_model(model, TRAIN_SEQ,
                                                             causal_frac=0.5),
                                       calibration=c)
        log(f"moe planner: {name} search at {model.num_layers} layers"
            f"{f', grad_accum {accum}' if accum else ''} ({res.evaluated} "
            f"combos, {res.search_seconds:.3f} s, rejections {res.rejections}): feasible "
            f"{res.feasible}; {'plan' if res.feasible else 'best candidate'} "
            f"{_plan_summary(plan)}; predicted step {plan.predicted_step_time} s; its cost "
            f"{step_pred:.6f} s and memory {mem_pred / 1e9:.4f} GB (on "
            f"{H100_1.hbm_bytes / 1e9:.2f} GB); check_plan: "
            f"{report.codes() or 'no diagnostics'}")
        if model is cfg or name == "calibrated":
            require(not res.feasible and mem_pred > H100_1.hbm_bytes,
                    f"the {name} search fits {model.num_layers}-layer moonshot on one card")
            continue
        require(res.feasible, f"the {name} search found no plan for {MOE_PLAN_LAYERS} layers")
        require(abs(step_pred - plan.predicted_step_time) <= 1e-9 * step_pred,
                f"the {name} plan's cost ({step_pred}) is not its prediction "
                f"({plan.predicted_step_time})")
        require(report.ok(), f"the {name} plan fails check_plan: {report.error_codes()}")
        if accum:
            trained = plan

    # 3. train the searched plan, the collector on then off (an
    # out-of-memory error is not caught)
    plan = trained
    _, dense, attn = train_flops(cut, TRAIN_BATCH, TRAIN_SEQ)
    policies = {s.remat for s in plan.layer_strategies}
    require(len(policies) == 1, f"the plan mixes remat policies {policies}")
    expected = {name: n * TRAIN_STEPS for name, n in train_launches(
        len(plan.layer_strategies), policies.pop(), plan.grad_accum).items()}
    records = {}
    for collector in ("on", "off"):
        gc.collect()
        torch.cuda.empty_cache()
        if collector == "off":
            gc.disable()
        try:
            record, bundle = train_plan(torch, counters, f"moonshot plan, collector {collector}",
                                        plan, TRAIN_STEPS, dense + attn, cut)
        finally:
            gc.enable()
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
        require(record["launches"] == expected, f"the moonshot plan launched "
                f"{record['launches']}, expected {expected}")
        records[collector] = record
    on, off = records["on"]["peak_bytes"], records["off"]["peak_bytes"]
    log(f"moe planner: peak with the cyclic collector on {on / 1e9:.4f} GB, off "
        f"{off / 1e9:.4f} GB (difference {(off - on) / 1e9:+.4f} GB, tol "
        f"{100 * COLLECTOR_PEAK_TOL:g} %)")
    require(abs(off - on) <= COLLECTOR_PEAK_TOL * on,
            "the train step's peak depends on the cyclic collector")
    record = records["on"]
    for name, c in (("analytic", cal.DEFAULT_CALIBRATION), ("calibrated", calibration)):
        step_pred, mem_pred = plan_cost(cut, plan, c)
        timed = dataclasses.replace(plan, predicted_step_time=step_pred)
        drift = plan_check.check_plan(timed, H100_1, cut, seq_len=TRAIN_SEQ,
                                      measured_step_time=record["step_s"])
        log(f"moe planner: the searched plan, {name} prediction: step {step_pred:.6f} s vs "
            f"measured {record['step_s']:.6f} s (x{record['step_s'] / step_pred:.3f}); memory "
            f"{mem_pred / 1e9:.4f} GB vs peak {record['peak_bytes'] / 1e9:.4f} GB "
            f"(x{record['peak_bytes'] / mem_pred:.3f}, collector on); GALV070: "
            + ("; ".join(map(str, drift.diagnostics)) or "within the band"))

    # 4. the launcher refuses the full model through plan_check
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *MOE_VALIDATE_ARGS]
    proc = subprocess.run(cmd, cwd=ROOT, env=_src_env(), capture_output=True, text=True,
                          timeout=300)
    for line in proc.stdout.splitlines():
        log(f"  | {line}")
    require(proc.returncode == 1 and "GALV020" in proc.stdout,
            f"launch.train --validate-only exited {proc.returncode} without GALV020: "
            f"{proc.stderr[-2000:]}")
    log(f"moe planner: phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return record["launches"]


# ---------------------------------------------------------------- phases 15-17

WHISPER_ARCH = "whisper-tiny"
#: serving: 16 windows of 1 500 frames (30 s of audio each), a 4-token
#: prompt and Whisper's default sample length, n_text_ctx // 2 = 224 new
#: tokens, in a cache of its decoder context n_text_ctx = 448
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW, WHISPER_CTX = 16, 4, 224, 448
#: training: Whisper's published batch of 256 segments x 448 decoder tokens
#: (+ 1 500 frames each), in 8 microbatches of 32
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_ACCUM = 256, 8
WHISPER_MICRO = WHISPER_TRAIN_BATCH // WHISPER_TRAIN_ACCUM
#: the fp32 parity's windows and greedy steps
WHISPER_PARITY_BATCH, WHISPER_PARITY_NEW = 4, 32


def whisper_launches(cfg, new: int) -> dict:
    """The kernel launches of one prefill and ``new - 1`` decode steps of the
    encoder-decoder: a prefill launches K1 once per encoder layer and twice
    per decoder layer (self and cross: 12 for whisper-tiny) and K2 twice per
    encoder layer, once for ``enc_norm``, three times per decoder layer and
    once for ``final_norm`` (22); a decode step K1 twice and K2 three times
    per decoder layer, plus ``final_norm`` (8 and 13)."""
    E, L = cfg.enc_layers, cfg.num_layers
    return {"flash_attention_fwd": E + 2 * L + (new - 1) * 2 * L,
            "rmsnorm": 2 * E + 3 * L + 2 + (new - 1) * (3 * L + 1), "rmsnorm_gated": 0,
            "rmsnorm_bwd": 0, "ssd": 0, "ssd_autograd": 0}


def whisper_train_flops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(matmul FLOPs, attention FLOPs) of one encoder-decoder train step: 6
    x the weights each position goes through x positions — an encoder
    frame through q/k/v/out and the FFN of each encoder layer, a decoder
    token through self q/k/v/out, cross q/out, the FFN and the head, and a
    frame once more through each decoder layer's cross k/v — plus attention
    at 3 x (forward) 4·H·hd per (row, key) pair: the encoder's F² per layer,
    the decoder's causal S²/2 and cross S·F per layer."""
    E, L, d, H, KV, hd = (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
                          cfg.num_kv_heads, cfg.resolved_head_dim)
    F = cfg.enc_frames
    n_ffn = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    ffn = n_ffn * d * cfg.d_ff
    self_attn = d * (H + 2 * KV) * hd + H * hd * d
    enc = F * E * (self_attn + ffn)
    dec = seq * (L * (self_attn + 2 * H * hd * d + ffn) + cfg.vocab_size * d)
    cross_kv = F * L * 2 * d * KV * hd
    dense = 6.0 * batch * (enc + dec + cross_kv)
    pairs = E * F * F + L * (seq * seq / 2.0 + seq * F)
    return dense, 3.0 * 4.0 * H * hd * batch * pairs


def stub_embeds(torch, batch: int, rows: int, width: int, seed: int):
    """``batch`` x ``rows`` stub embeddings of ``width`` (whisper's frames,
    internvl2's patch embeddings), standard normal from a seeded generator
    on the card, in bf16 (``SyntheticDataset``'s dtype)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, rows, width), generator=gen, device="cuda").to(torch.bfloat16)


def generate_with_extras(torch, engine, params, prompts, extras: dict, new: int,
                         prefix: int = 0, prefill=None, decode=None):
    """Greedy serving of side inputs through the engine's own steps:
    ``prefill_step(params, prompts, extras)``, then ``new - 1``
    ``decode_step`` calls, each fenced.  ``prefix`` positions (a VLM's patch
    embeddings) precede the prompt in the cache: step i writes at ``prefix
    + S + i`` with ``kv_len`` one past it, as JAX's loop passes it; frames
    take no decoder positions (``prefix`` 0, no ``kv_len``).  ``prefill``
    and ``decode`` replace the engine's steps (its ``jit_*`` steps).
    Returns (tokens (B, new), the prefill's last-position logits, its fenced
    seconds, each decode step's, the last cache)."""
    B, S = prompts.shape
    prefill = prefill or engine.prefill_step
    decode = decode or engine.decode_step
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, extras)
    first = logits[:, -1]
    out = [first.argmax(-1)]
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    steps = []
    for i in range(new - 1):
        t0 = time.perf_counter()
        pos = prefix + S + i
        kv_len = torch.full((B,), pos + 1, device=prompts.device) if prefix else None
        logits, cache = decode(params, out[-1][:, None], cache, pos, kv_len)
        out.append(logits[:, -1].argmax(-1))
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return torch.stack(out, dim=1), first, ttft, steps, cache


def whisper_serve_phase(torch, np, serving, build_model, get_config, counters):
    """Phase 15: full-width, full-depth whisper-tiny (random bf16 weights
    from seed 0) serving ``WHISPER_BATCH`` windows of real frames through
    ``generate_with_extras`` after a warm-up; launches pinned
    (``whisper_launches``).  Returns (engine, params, frames, prompts,
    launches, (tokens, TTFT s, the decode steps' s))."""
    from repro_torch.models.common import tree_leaves

    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    engine = serving.step_engine(model, serving.single_device_plan(cfg), batch=WHISPER_BATCH,
                                 max_len=WHISPER_CTX)
    frames = stub_embeds(torch, WHISPER_BATCH, cfg.enc_frames, cfg.d_model, 1)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (WHISPER_BATCH, WHISPER_PROMPT))
    tokens = torch.from_numpy(prompts).cuda()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"whisper: built full-width {cfg.name} ({cfg.enc_layers} encoder + {cfg.num_layers} "
        f"decoder layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, gelu ff {cfg.d_ff}, {cfg.enc_frames} frames, vocab "
        f"{cfg.vocab_size}, untied; {n_params} parameters, {n_params * 2 / 1e9:.3f} GB in bf16) "
        f"in {time.perf_counter() - t0:.3f} s")
    generate_with_extras(torch, engine, params, tokens, {"frames": frames}, 3)         # warm-up
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, ttft, steps, _ = generate_with_extras(torch, engine, params, tokens,
                                                  {"frames": frames}, WHISPER_NEW)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    require(tuple(out.shape) == (WHISPER_BATCH, WHISPER_NEW), f"whisper tokens shape "
            f"{tuple(out.shape)}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "whisper token out of the vocab")
    expected = whisper_launches(cfg, WHISPER_NEW)
    require(launches == expected, f"whisper launched {launches}, expected {expected}")
    tpot = statistics.median(steps)
    n_tok = WHISPER_BATCH * WHISPER_NEW
    log(f"whisper serve: {WHISPER_BATCH} windows x {cfg.enc_frames} frames, ({WHISPER_PROMPT} + "
        f"{WHISPER_NEW}) tokens in {wall:.3f} s ({n_tok / wall:.1f} tok/s)  prefill (ttft, the "
        f"encoder included) {ttft * 1e3:.2f} ms  decode (tpot) p50 {tpot * 1e3:.3f} ms  "
        f"launches {launches} (K1 {cfg.enc_layers + 2 * cfg.num_layers} a prefill, "
        f"{2 * cfg.num_layers} a decode step; K2 {2 * cfg.enc_layers + 3 * cfg.num_layers + 2} "
        f"a prefill, {3 * cfg.num_layers + 1} a decode step)  peak mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"whisper serve: tokens[0][:8] {out[0, :8].tolist()}")
    return engine, params, frames, prompts, launches, (out, ttft, steps)


def parity_whisper(torch, serving, build_model, engine, params, frames, prompts) -> None:
    """Phase 16, at full width and depth on the served weights: (a) in fp32
    (the weights and frames cast) on ``WHISPER_PARITY_BATCH`` windows, the
    kernel path's prefill logits within 1e-3 of the plain path's scale and
    its greedy tokens over ``WHISPER_PARITY_NEW`` steps identical; (b)
    ``parity_prefill`` on the served batch with its frames: the bf16 kernel
    path no further from fp32 than twice the plain bf16 path."""
    from repro_torch.models.common import cast_tree

    cfg = engine.model.cfg
    n = WHISPER_PARITY_BATCH
    params32 = cast_tree(params, torch.float32)
    toks = torch.from_numpy(prompts[:n]).cuda()
    f32 = frames[:n].float()
    out = {}
    for impl in ("kernel", "ref"):
        eng = serving.step_engine(build_model(cfg, impl=impl), serving.single_device_plan(cfg),
                                  batch=n, max_len=WHISPER_PROMPT + WHISPER_PARITY_NEW,
                                  dtype=torch.float32)
        out[impl] = generate_with_extras(torch, eng, params32, toks, {"frames": f32},
                                         WHISPER_PARITY_NEW)[:2]
    del params32
    torch.cuda.empty_cache()
    (tk, lk), (tr, lr) = out["kernel"], out["ref"]
    err = float((lk - lr).abs().max())
    scale = float(lr.abs().max())
    same = tk.tolist() == tr.tolist()
    log(f"parity: full-width whisper fp32, {n} windows: prefill logits kernel-vs-plain "
        f"max_abs_err {err:.3e} (tol 1e-3 x {scale:.3f}); greedy tokens over "
        f"{WHISPER_PARITY_NEW} steps {'identical' if same else 'DIFFER'} "
        f"({tk[0, :6].tolist()}...)")
    require(bool(torch.isfinite(lk).all()), "non-finite whisper fp32 logits")
    require(err <= 1e-3 * scale, "whisper fp32 logits: kernel path differs from the plain path")
    require(same, f"whisper fp32 greedy tokens differ: kernel {tk.tolist()} ref {tr.tolist()}")
    parity_prefill(torch, "whisper", engine.model, build_model(cfg, impl="ref"), params,
                   torch.from_numpy(prompts).cuda(), "full-width", extras={"frames": frames})


def whisper_train_phase(torch, counters) -> dict:
    """Phase 17: full-width, full-depth whisper-tiny trained ``TRAIN_STEPS``
    steps of ``WHISPER_TRAIN_BATCH`` windows x 448 tokens (grad_accum 8;
    the family applies no remat policy) from fresh state: losses, median
    step, decoder tokens/s and frames/s, peak memory, MFU; K1/K2/K2-backward
    launches per step pinned; one step profiled; then ``parity_train`` on 2
    windows.  Returns the run's launches."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import LayerStrategy, uniform_plan

    cfg = get_config(WHISPER_ARCH)
    B, S, F = WHISPER_TRAIN_BATCH, WHISPER_CTX, cfg.enc_frames
    dense, attn = whisper_train_flops(cfg, B, S)
    log(f"train: {cfg.name} full width and depth, {B} windows x ({S} tokens + {F} frames) a "
        f"step in {WHISPER_TRAIN_ACCUM} microbatches; model FLOPs per step: matmuls "
        f"{dense:.4e} + attention {attn:.4e} = {dense + attn:.4e}; bound at the bf16 peak "
        f"{(dense + attn) / PEAK_FLOPS['bfloat16']:.4f} s")
    plan = uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        LayerStrategy(remat="none"), grad_accum=WHISPER_TRAIN_ACCUM)
    record, (hp, params, opt, ds) = train_plan(torch, counters, "whisper", plan, TRAIN_STEPS,
                                               dense + attn, cfg, seq=S, batch=B)
    E, L = cfg.enc_layers, cfg.num_layers
    norms = 2 * E + 3 * L + 2
    expected = {"flash_attention_fwd": (E + 2 * L) * WHISPER_TRAIN_ACCUM * TRAIN_STEPS,
                "rmsnorm": norms * WHISPER_TRAIN_ACCUM * TRAIN_STEPS, "rmsnorm_gated": 0,
                "rmsnorm_bwd": norms * WHISPER_TRAIN_ACCUM * TRAIN_STEPS, "ssd": 0,
                "ssd_autograd": 0}
    require(record["launches"] == expected,
            f"whisper train launched {record['launches']}, expected {expected}")
    step_s = record["step_s"]
    log(f"train [whisper]: median step {step_s:.4f} s, {B * S / step_s:.1f} decoder tokens/s, "
        f"{B * F / step_s:.1f} frames/s, peak mem {record['peak_bytes'] / 1e9:.2f} GB, MFU "
        f"{100 * record['mfu']:.2f} %; launches per step K1 {E + 2 * L} x {WHISPER_TRAIN_ACCUM}, "
        f"K2 and K2 backward {norms} x {WHISPER_TRAIN_ACCUM}")
    profile_train_step(torch, hp, params, opt, ds.batch(TRAIN_STEPS),
                       what=f"[whisper] ({B} x ({S} tokens + {F} frames))")
    del hp, params, opt, ds
    gc.collect()
    torch.cuda.empty_cache()
    parity_train(torch, cfg, seq=S, batch=2)
    return record["launches"]


# ---------------------------------------------------------------- phases 18-20

VLM_ARCH = "internvl2-26b"
#: serving: 8 image-grounded chat turns, each one image tile (the config's
#: 256 stub patch embeddings) + 1 024 text tokens, 64 new tokens, in a cache
#: of prefix + text + new rows (the prefix takes decoder positions)
VLM_BATCH, VLM_PREFIX, VLM_TEXT, VLM_NEW = 8, 256, 1024, 64
VLM_CTX = VLM_PREFIX + VLM_TEXT + VLM_NEW
#: full width cut in depth where the full model does not fit the card: the
#: fp32 parity (79 GB at 48 layers) and training (fp32 masters, grads and
#: AdamW state: ~318 GB at 48 layers); the fp32 parity's greedy steps
VLM_PARITY_LAYERS, VLM_TRAIN_LAYERS, VLM_PARITY_NEW = 4, 2, 32


def vlm_serve_phase(torch, np, serving, build_model, get_config, counters):
    """Phase 18: full-width, full-depth internvl2-26b (random bf16 weights
    from seed 0) serving ``VLM_BATCH`` turns of one image tile (seeded
    standard normal patch embeddings) and ``VLM_TEXT`` tokens through
    ``generate_with_extras`` after a warm-up; K1 48 and K2 97 launches a
    forward pinned (``step_engine_launches``).  Returns (engine, params,
    vis_embeds, prompts, launches, (tokens, TTFT s, the decode steps' s))."""
    from repro_torch.models.common import tree_leaves

    cfg = get_config(VLM_ARCH)
    require(cfg.vis_tokens == VLM_PREFIX, f"{cfg.name} has {cfg.vis_tokens} prefix positions")
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    engine = serving.step_engine(model, serving.single_device_plan(cfg), batch=VLM_BATCH,
                                 max_len=VLM_CTX)
    vis = stub_embeds(torch, VLM_BATCH, VLM_PREFIX, cfg.d_model, 1)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT))
    tokens = torch.from_numpy(prompts).cuda()
    extras = {"vis_embeds": vis}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"internvl2: built full-width {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, {cfg.mlp_type} "
        f"ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied, {cfg.vis_tokens} prefix positions; "
        f"{n_params} parameters, {n_params * 2 / 1e9:.2f} GB in bf16) in "
        f"{time.perf_counter() - t0:.3f} s")
    generate_with_extras(torch, engine, params, tokens, extras, 3, prefix=VLM_PREFIX)  # warm-up
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, ttft, steps, _ = generate_with_extras(torch, engine, params, tokens, extras,
                                                  VLM_NEW, prefix=VLM_PREFIX)
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    require(tuple(out.shape) == (VLM_BATCH, VLM_NEW), f"internvl2 tokens shape "
            f"{tuple(out.shape)}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "internvl2 token out of the vocab")
    expected = step_engine_launches(model, VLM_NEW)
    require(launches == expected, f"internvl2 launched {launches}, expected {expected}")
    tpot = statistics.median(steps)
    n_tok = VLM_BATCH * VLM_NEW
    log(f"internvl2 serve: {VLM_BATCH} x ({VLM_PREFIX} patch embeddings + {VLM_TEXT} + "
        f"{VLM_NEW}) in {wall:.3f} s ({n_tok / wall:.1f} tok/s)  prefill (ttft) "
        f"{ttft * 1e3:.2f} ms  decode (tpot) p50 {tpot * 1e3:.3f} ms  launches {launches} "
        f"(K1 {cfg.num_layers}, K2 {2 * cfg.num_layers + 1} a forward)  peak mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"internvl2 serve: tokens[0][:8] {out[0, :8].tolist()}")
    return engine, params, vis, prompts, launches, (out, ttft, steps)


def parity_vlm(torch, serving, build_model, engine, params, vis, prompts) -> None:
    """Phase 19, at full width cut to ``VLM_PARITY_LAYERS`` layers (the
    served weights' first layers, cloned; the rest freed: fp32 at full
    depth would be 79 GB), with the served batch's patch embeddings: (a) in
    fp32, the kernel path's prefill logits within 1e-3 of the plain path's
    scale and its greedy tokens over ``VLM_PARITY_NEW`` steps identical;
    (b) ``parity_prefill``: the bf16 kernel path no further from fp32 than
    twice the plain bf16 path."""
    import gc

    from repro_torch.models.common import cast_tree, tree_map

    L = VLM_PARITY_LAYERS
    cut = {"embed": params["embed"], "final_norm": params["final_norm"],
           "blocks": tree_map(lambda x: x[:L].clone(), params["blocks"])}
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(engine.model.cfg, num_layers=L)
    toks = torch.from_numpy(prompts).cuda()
    params32 = cast_tree(cut, torch.float32)
    out = {}
    for impl in ("kernel", "ref"):
        eng = serving.step_engine(build_model(cfg, impl=impl), serving.single_device_plan(cfg),
                                  batch=VLM_BATCH, max_len=VLM_PREFIX + VLM_TEXT + VLM_PARITY_NEW,
                                  dtype=torch.float32)
        out[impl] = generate_with_extras(torch, eng, params32, toks,
                                         {"vis_embeds": vis.float()}, VLM_PARITY_NEW,
                                         prefix=VLM_PREFIX)[:2]
        torch.cuda.empty_cache()
    del params32
    torch.cuda.empty_cache()
    (tk, lk), (tr, lr) = out["kernel"], out["ref"]
    err = float((lk - lr).abs().max())
    scale = float(lr.abs().max())
    same = tk.tolist() == tr.tolist()
    log(f"parity: internvl2 full width x {L} layers fp32, {VLM_BATCH} turns of {VLM_PREFIX} + "
        f"{VLM_TEXT}: prefill logits kernel-vs-plain max_abs_err {err:.3e} (tol 1e-3 x "
        f"{scale:.3f}); greedy tokens over {VLM_PARITY_NEW} steps "
        f"{'identical' if same else 'DIFFER'} ({tk[0, :6].tolist()}...)")
    require(bool(torch.isfinite(lk).all()), "non-finite internvl2 fp32 logits")
    require(err <= 1e-3 * scale, "internvl2 fp32 logits: kernel path differs from the plain path")
    require(same, f"internvl2 fp32 greedy tokens differ: kernel {tk.tolist()} ref {tr.tolist()}")
    parity_prefill(torch, "internvl2", build_model(cfg), build_model(cfg, impl="ref"), cut, toks,
                   f"full-width {L}-layer", extras={"vis_embeds": vis})
    del cut
    gc.collect()
    torch.cuda.empty_cache()


def vlm_train_phase(torch, counters) -> dict:
    """Phase 20: internvl2 at full width cut to ``VLM_TRAIN_LAYERS`` layers
    trained ``TRAIN_STEPS`` steps of 8 x 4 096 positions (256 prefix + 3 840
    text; grad_accum 4, ``selective``; the state donated) from fresh state:
    losses, step time, text tokens/s, peak memory, MFU (the prefix positions
    counted through the layers and the head, as ``forward_train`` computes
    them); K1/K2/K2-backward launches per step pinned; then
    ``parity_train`` on one microbatch with seeded non-zero patch
    embeddings.  Returns the run's launches."""
    import gc

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_TRAIN_LAYERS)
    n_params, dense, attn = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    text = TRAIN_SEQ - cfg.vis_tokens
    log(f"train: {cfg.name} full width cut to {cfg.num_layers} layers (cuts: depth 48 -> "
        f"{cfg.num_layers}, global batch 8 x {TRAIN_SEQ} positions = {cfg.vis_tokens} prefix + "
        f"{text} text); model FLOPs per step = 6 x {n_params} matmul params x "
        f"{TRAIN_BATCH * TRAIN_SEQ} positions ({dense:.4e}) + causal attention ({attn:.4e}); "
        f"bound at the bf16 peak {(dense + attn) / PEAK_FLOPS['bfloat16']:.4f} s")
    plan = _uniform_plan(cfg, "selective")
    record, bundle = train_plan(torch, counters, "internvl2 selective", plan, TRAIN_STEPS,
                                dense + attn, cfg, donate=True)
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    expected = {name: n * TRAIN_STEPS
                for name, n in train_launches(cfg.num_layers, "selective").items()}
    require(record["launches"] == expected,
            f"internvl2 train launched {record['launches']}, expected {expected}")
    log(f"train [internvl2]: median step {record['step_s']:.4f} s, "
        f"{TRAIN_BATCH * text / record['step_s']:.1f} text tokens/s, peak mem "
        f"{record['peak_bytes'] / 1e9:.2f} GB, MFU {100 * record['mfu']:.2f} %")
    parity_train(torch, cfg, seq=TRAIN_SEQ, batch=TRAIN_BATCH // TRAIN_ACCUM)
    return record["launches"]


# ---------------------------------------------------------------- phases 21-22

#: the Mamba2 paper's training context; the step of 8 sequences in 4
#: microbatches, as the llama train traffic
SSM_TRAIN_SEQ = 2048
#: zamba2 at full width cut to 13 layers (two shared-block sites and one
#: trailing Mamba layer): 81 layers' fp32 state would be ~109 GB
ZAMBA2_TRAIN_LAYERS = 13
#: mamba2's kernel-vs-plain training parity: full width cut to 2 layers
SSM_PARITY_LAYERS = 2
#: mamba2 trained at full width cut to 8 of its 64 layers, to keep the
#: whole run inside its time limit on a slow host (16 from phase 27's
#: arrival, 8 since phase 29's)
MAMBA2_TRAIN_LAYERS = 8


def ssm_train_flops(cfg, batch: int, seq: int) -> tuple[int, float, float, float]:
    """(matmul parameters, their FLOPs, SSD FLOPs, attention FLOPs) of one
    Mamba2-family train step.  Matmuls: 6 x the parameters of the products a
    token goes through (each Mamba layer's z, x, B, C, dt and out
    projections; the shared block's q/k/v/out and FFN at each site; the
    head) x tokens.  SSD: the chunked scan's products, 3 x (forward) per
    position and head 2·Q·N (C·Bᵀ) + 2·Q·P (the masked quadratic form times
    x) + 2·N·P (the chunk's state) + 2·N·P (C times the carried state), Q
    the chunk of 64.  Attention: ``train_flops``' causal term at the sites."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H, G, N, P = d_inner // cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    mamba = 2 * d * d_inner + 2 * d * G * N + d * H + d_inner * d
    sites = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    shared, attn = 0, 0.0
    if sites:
        shared, _, attn = train_flops(dataclasses.replace(cfg, num_layers=sites, vocab_size=0),
                                      batch, seq)
    n_params = cfg.num_layers * mamba + shared + cfg.vocab_size * d
    ssd = 3.0 * cfg.num_layers * batch * seq * H * (2 * SSD_CHUNK * (N + P) + 4 * N * P)
    return n_params, 6.0 * n_params * batch * seq, ssd, attn


def ssm_train_launches(cfg, policy: str, accum: int = TRAIN_ACCUM) -> dict:
    """Kernel launches per step of a Mamba2-family model in ``accum``
    microbatches.  A forward launches K3 (under ``ssd_autograd``) once per
    Mamba layer, K2 twice per Mamba layer (the layer norm and the gate norm,
    composed under autograd: not the gated template) and twice per shared
    block site, plus the final norm, and K1 once per site; a recomputing
    policy reruns each Mamba layer's forward in its backward (K3 and both
    norms; mamba2 only: the hybrid takes no runner, as in JAX); the
    backward runs K2's backward once per norm."""
    L = cfg.num_layers
    sites = L // cfg.attn_every if cfg.family == "hybrid" else 0
    again = int(policy != "none" and cfg.family == "ssm")
    norms = 2 * L + 2 * sites + 1
    return {"flash_attention_fwd": sites * accum, "rmsnorm": (norms + 2 * L * again) * accum,
            "rmsnorm_gated": 0, "rmsnorm_bwd": norms * accum,
            "ssd": L * (1 + again) * accum, "ssd_autograd": L * (1 + again) * accum}


def ssm_train_phase(torch, counters, arch: str, policy: str, layers=None,
                    profile: bool = False) -> dict:
    """Phases 21-22: ``arch`` at full width (cut to ``layers`` when given)
    trained ``TRAIN_STEPS`` steps of 8 x ``SSM_TRAIN_SEQ`` tokens
    (grad_accum 4, ``policy``; the state donated: mamba2's two copies of the
    fp32 state would not fit) from fresh state: losses (the first within 1
    of ln V), median step, tokens/s, peak memory, MFU; every launch per
    step pinned (``ssm_train_launches``); with ``profile``, one step
    profiled by group (the ``ssd_vjp`` span among them) and
    ``parity_train`` at ``SSM_PARITY_LAYERS`` layers.  Returns the run's
    launches."""
    import gc

    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    full = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    n_params, dense, ssd, attn = ssm_train_flops(cfg, TRAIN_BATCH, SSM_TRAIN_SEQ)
    flops = dense + ssd + attn
    label = cfg.name.split("-")[0]
    cut = f"cut to {cfg.num_layers} of {full} layers" if layers else "full depth"
    log(f"train: {cfg.name} full width, {cut}, {TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens a step "
        f"in {TRAIN_ACCUM} microbatches, {policy}; model FLOPs per step = 6 x {n_params} "
        f"matmul params x {TRAIN_BATCH * SSM_TRAIN_SEQ} tokens ({dense:.4e}) + SSD ({ssd:.4e})"
        f" + attention ({attn:.4e}) = {flops:.4e}; bound at the bf16 peak "
        f"{flops / PEAK_FLOPS['bfloat16']:.4f} s")
    plan = _uniform_plan(cfg, policy)
    record, (hp, params, opt, ds) = train_plan(
        torch, counters, f"{label} {policy}", plan, TRAIN_STEPS, flops, cfg, seq=SSM_TRAIN_SEQ,
        donate=True)
    expected = {name: n * TRAIN_STEPS for name, n in ssm_train_launches(cfg, policy).items()}
    require(record["launches"] == expected,
            f"{label} train launched {record['launches']}, expected {expected}")
    log(f"train [{label}]: median step {record['step_s']:.4f} s, "
        f"{record['tokens_per_s']:.1f} tokens/s, peak mem {record['peak_bytes'] / 1e9:.2f} GB, "
        f"MFU {100 * record['mfu']:.2f} %; launches per step "
        f"{ {k: v // TRAIN_STEPS for k, v in record['launches'].items()} }")
    if profile:
        profile_train_step(torch, hp, params, opt, ds.batch(TRAIN_STEPS),
                           what=f"[{label} {policy}] ({TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens)",
                           donate=True, spans=SSM_TRAIN_SPANS)
    del hp, params, opt, ds
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        parity_train(torch, dataclasses.replace(cfg, num_layers=SSM_PARITY_LAYERS),
                     seq=SSM_TRAIN_SEQ, batch=TRAIN_BATCH // TRAIN_ACCUM)
    return record["launches"]


# ---------------------------------------------------------------- main

def allocator_report(torch, label: str) -> None:
    """The caching allocator once a phase's objects are gone and its cache
    emptied: what stays allocated and reserved, and each segment that an
    active block keeps from being released (its size, the bytes active in
    it, the sizes of its largest active blocks)."""
    gc.collect()
    torch.cuda.empty_cache()
    segments = torch.cuda.memory_snapshot()
    kept = sorted(((s["total_size"], s["allocated_size"],
                    sorted((b["size"] for b in s["blocks"] if b["state"] == "active_allocated"),
                           reverse=True)) for s in segments), reverse=True)
    reserved = sum(t for t, _, _ in kept)
    allocated = sum(a for _, a, _ in kept)
    log(f"allocator after {label}: {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved in {len(kept)} segments "
        f"({(reserved - allocated) / 2**20:.1f} MiB of them free but kept by active blocks); "
        f"allocator settings {os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')!r}")
    for total, active, blocks in kept[:8]:
        log(f"allocator:   segment {total / 2**20:.1f} MiB, {active / 2**20:.3f} MiB active in "
            f"{len(blocks)} blocks (largest {[round(b / 2**20, 3) for b in blocks[:4]]} MiB)")


# --------------------------------------------------------------------------
# 25. the parallel runtime: two ranks sharing the card over gloo
# --------------------------------------------------------------------------

#: one step a plan in phases 25-27 (2 until phase 30 came: the run's time
#: limit; phase 25's fp32 check holds the sharded update)
PAR_SEQ, PAR_BATCH, PAR_ACCUM, PAR_STEPS = 4096, 4, 2, 1
#: llama3.2-1b at full width cut to 2 of its 16 layers, to keep the whole
#: run inside its time limit on a slow host (4 from phase 27's arrival, 2
#: since phase 29's)
PAR_LAYERS = 2
PAR_MESH = ((1, 2), ("data", "model"))          # launch.mesh.train_mesh_spec(2)
PAR_LOSS_TOL = 5e-2            # JAX's bf16 bound on a sharded step (tests/test_parallel_mp.py:53)
PAR_FP32_LAYERS = 2
#: the plans checked again in fp32: (c)'s repeat (the searched plan, tp 1
#: ZeRO-2, as the CPU tests hold) was cut to pay for phase 29
PAR_FP32_PLANS = ("a", "b")
PAR_FP32_BATCH = 2             # x PAR_SEQ tokens, one microbatch: a row per rank under (b)
PAR_FP32_LOSS_RTOL = 1e-4
PAR_FP32_UPDATE_TOL = 2e-3     # x the largest |update| of the leaf on one rank
PAR_FP32_GRAD_TOL = 2e-3       # x the largest |grad| of the leaf on one rank
# AdamW eps of the fp32 update check: the first step's update of an element
# is lr·g/(|g| + eps), whose slope in g is up to lr/eps, so at 1e-8 a grad
# element near 1e-10 that two summation orders round differently moves its
# update by a whole lr (tests/test_torch_parallel_mp.py); the grads, which
# do not read eps, are held beside the update
PAR_FP32_EPS = 1e-4
PAR_TIMEOUT = 600
NO_INTERCONNECT = "gloo through the host on one card: no interconnect measured"


def par_launches(plan, layers: int) -> dict:
    """Kernel launches per step of one rank under ``plan``: each layer's
    forward (K1 once, K2 twice), again in its backward where its group
    recomputes, the final norm, and K2's backward once per norm; every
    rank runs every layer (at its local heads or rows) for every
    microbatch."""
    strategies = plan.layer_strategies or [plan.default_strategy] * layers
    again = [s.remat != "none" for s in strategies]
    k = plan.grad_accum
    return {"flash_attention_fwd": k * sum(1 + a for a in again),
            "rmsnorm": k * (1 + sum(2 + 2 * a for a in again)), "rmsnorm_gated": 0,
            "rmsnorm_bwd": k * (2 * layers + 1), "ssd": 0, "ssd_autograd": 0}


def par_plans(cfg) -> dict:
    """label -> (plan, what it is): (a) tp 2 + sp, ZeRO-1; (b) tp 1 (dp 2
    through the absorbed model axis), ZeRO-3; both ``selective`` at
    grad_accum 2; (c) the plan the search picks on the 2-card H100 cluster
    at each rank's share of the card, the memory the two ranks really have
    (the same search on a whole card per rank is logged beside it)."""
    from repro_torch.core.cluster import H100_NODE8
    from repro_torch.core.search import SearchEngine
    from repro_torch.core.strategy import LayerStrategy, uniform_plan

    shape, axes = PAR_MESH
    fixed = lambda s: uniform_plan(cfg.name, "train_4k", shape, axes, cfg.num_layers, s,
                                   grad_accum=PAR_ACCUM)
    cluster = dataclasses.replace(H100_NODE8, chips=2, intra_size=2)
    search = lambda c: SearchEngine(cfg, cluster=c).search(
        PAR_SEQ, PAR_BATCH, mesh_shape=shape, mesh_axes=axes, pp_options=[1], arch=cfg.name)
    whole = search(cluster)
    share = search(dataclasses.replace(cluster, hbm_bytes=cluster.hbm_bytes / 2))
    require(share.feasible, "the search found no plan at half an H100 per rank")
    log(f"parallel: the search on {cluster.name} x2 (a whole card per rank): "
        f"{_plan_summary(whole.plan)}, {whole.plan.predicted_memory / 1e9:.2f} GB per "
        f"device predicted; at half a card per rank: {_plan_summary(share.plan)}, "
        f"{share.plan.predicted_memory / 1e9:.2f} GB")
    return {"a": (fixed(LayerStrategy(tp=2, sp=True, zero=1, remat="selective")),
                  "tp 2 + sp, ZeRO-1, selective"),
            "b": (fixed(LayerStrategy(tp=1, zero=3, remat="selective")),
                  "tp 1 (dp 2), ZeRO-3, selective"),
            "c": (share.plan, "searched: " + _plan_summary(share.plan))}


def _fp32_plan(plan, layers: int):
    """``plan``'s strategy over ``layers`` layers, one microbatch."""
    from repro_torch.core.strategy import uniform_plan

    return uniform_plan(plan.arch, plan.shape, plan.mesh_shape, plan.mesh_axes, layers,
                        plan.default_strategy)


def parallel_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One rank of phase 25 (``chip_smoke.py --parallel-rank RANK WORLD DIR``):
    device 0, gloo over a ``FileStore`` in DIR; waits for DIR/payload.json,
    trains each plan of the payload for ``PAR_STEPS`` steps at full width,
    then the fp32 runs at ``PAR_FP32_LAYERS`` layers (``value_and_grad``,
    then ``apply_grads``: one ``train_step`` at one microbatch; the grads and
    the updated params, each gathered to the canonical tree, held by rank 0
    to the one-rank reference), and writes its record to DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import ExecutionPlan
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    # the collectives the runtime calls, by name, device and dtype
    used = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def counted(out, *a, _run=getattr(dist, name), _name=name, **kw):
            used[f"{_name} {out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
            return _run(out, *a, **kw)
        setattr(dist, name, counted)
    # the head counts K1 sees under autograd
    k1_heads = set()
    autograd_k1 = flash_ops.flash_attention

    def seen(q, k, v, causal=True):
        k1_heads.add((q.shape[2], k.shape[2]))
        return autograd_k1(q, k, v, causal=causal)

    flash_ops.flash_attention = seen
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=PAR_LAYERS)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*PAR_MESH, device=dev, backend="gloo")
    ds = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_BATCH, seed=0)
    ds32 = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_FP32_BATCH, seed=0)
    record = {"runs": {}, "fp32": {}, "ready": time.perf_counter() - T_START}
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    payload = json.loads((tmp / "payload.json").read_text())
    for label, text in payload["plans"].items():
        t_plan = time.perf_counter()
        plan = ExecutionPlan.from_json(text)
        hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
        params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
        opt = hp.init_opt_state(params)
        local = dict(tree_paths(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        used.clear()
        k1_heads.clear()
        run = {"losses": [], "grad_norms": [], "times": [], "launches": []}
        for step in range(PAR_STEPS):
            batch = ds.batch(step)
            zero_counts(counters)
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = hp.train_step(params, opt, batch)
            torch.cuda.synchronize()
            run["times"].append(time.perf_counter() - t0)
            run["launches"].append(read_counts(counters))
            run["losses"].append(float(m["loss"]))
            run["grad_norms"].append(float(m["grad_norm"]))
        wq = next(v for p, v in local.items() if p[-2:] == ("attn", "wq"))
        wk = next(v for p, v in local.items() if p[-2:] == ("attn", "wk"))
        run.update(peak=torch.cuda.max_memory_allocated(), ops=dict(used),
                   seconds=time.perf_counter() - t_plan,
                   k1_heads=sorted(k1_heads), local_wq=list(wq.shape), local_wk=list(wk.shape))
        record["runs"][label] = run
        del hp, params, opt, m, local, wq, wk
        gc.collect()
        torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=PAR_FP32_LAYERS)
    ref = torch.load(tmp / "fp32_ref.pt", map_location=dev) if rank == 0 else None
    for label in payload["fp32"]:
        t_run = time.perf_counter()
        plan = _fp32_plan(ExecutionPlan.from_json(payload["plans"][label]), PAR_FP32_LAYERS)
        hp = construct_hybrid_parallel_model(build_model(cfg2), plan, mesh,
                                             AdamWConfig(eps=PAR_FP32_EPS))
        params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
        loss, _, grads = hp.value_and_grad(params, ds32.batch(0), torch.float32)
        new, _, _ = hp.apply_grads(params, grads, hp.init_opt_state(params))
        grads, new = hp.gather_params(grads, hp.grad_specs), hp.gather_params(new)
        out = {"loss": float(loss)}
        if rank == 0:
            worst = worst_g = 0.0
            for (path, a), b, p0, g, rg in zip(
                    tree_paths(new), tree_leaves(ref["new"]), tree_leaves(ref["init"]),
                    tree_leaves(grads), tree_leaves(ref["grads"])):
                scale = float((b - p0).abs().max())
                worst = max(worst, float((a - b).abs().max()) / max(scale, 1e-30))
                g_scale = float(rg.abs().max())
                worst_g = max(worst_g, float((g - rg).abs().max()) / max(g_scale, 1e-30))
            out.update(update_err=worst, grad_err=worst_g)
        out["seconds"] = time.perf_counter() - t_run
        record["fp32"][label] = out
        del hp, params, grads, new
        gc.collect()
        torch.cuda.empty_cache()
    record["fp32_seconds"] = time.perf_counter() - t_fp32
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def parallel_phase(torch) -> dict:
    """Phase 25: the parallel runtime at full llama3.2-1b width cut to
    ``PAR_LAYERS`` layers on two ranks sharing the card over gloo
    (``par_plans``), held to one rank's
    ``mesh=None`` step on the same seed-0 weights and batches: bf16 losses
    within ``PAR_LOSS_TOL``, and, for each of ``PAR_FP32_PLANS``, at
    ``PAR_FP32_LAYERS``
    layers in fp32 the loss within ``PAR_FP32_LOSS_RTOL`` relative, every
    grad within ``PAR_FP32_GRAD_TOL`` of its leaf's grad scale and every
    updated param within ``PAR_FP32_UPDATE_TOL`` of its leaf's update
    scale.  Each rank's K1, K2 and K2-backward launches per step are pinned
    (``par_launches``), and under (a) K1 sees 16 query and 4 KV heads.  Logs
    each rank's peak memory and their sum against the card, the step times
    (labelled: no interconnect is measured) and the collectives called on
    CUDA tensors.  Returns each plan's launches in rank 0's last step."""
    import math
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=PAR_LAYERS)
    plans = par_plans(cfg)
    ds = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_BATCH, seed=0)
    ds32 = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_FP32_BATCH, seed=0)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # the ranks start (imports, the card, the process group, the mesh)
        # while this process runs the one-rank oracle; they wait for the payload
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--parallel-rank", str(r), "2", str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            # the one-rank oracle: mesh=None on the same weights and batches
            one = uniform_plan(cfg.name, "train_4k", (1,), ("data",), cfg.num_layers,
                               LayerStrategy(remat="selective"), grad_accum=PAR_ACCUM)
            hp = construct_hybrid_parallel_model(build_model(cfg), one)
            params = hp.init_params(gen())
            opt = hp.init_opt_state(params)
            ref_losses, ref_times = [], []
            for step in range(PAR_STEPS):
                t0 = time.perf_counter()
                params, opt, m = hp.train_step(params, opt, ds.batch(step))
                torch.cuda.synchronize()
                ref_times.append(time.perf_counter() - t0)
                ref_losses.append(float(m["loss"]))
            del hp, params, opt, m
            cfg2 = dataclasses.replace(cfg, num_layers=PAR_FP32_LAYERS)
            hp = construct_hybrid_parallel_model(
                build_model(cfg2), _fp32_plan(one, PAR_FP32_LAYERS), None,
                AdamWConfig(eps=PAR_FP32_EPS))
            init = hp.init_params(gen())
            loss, _, grads = hp.value_and_grad(init, ds32.batch(0), torch.float32)
            new, _, _ = hp.apply_grads(init, grads, hp.init_opt_state(init))
            ref32_loss = float(loss)
            torch.save({"new": new, "init": init, "grads": grads}, tmp / "fp32_ref.pt")
            del hp, init, grads, new, loss
            gc.collect()
            torch.cuda.empty_cache()
            log(f"parallel: one rank (mesh=None, selective, grad_accum {PAR_ACCUM}): losses "
                f"{ref_losses}, step times {[round(t, 4) for t in ref_times]} s; fp32 at "
                f"{PAR_FP32_LAYERS} layers, {PAR_FP32_BATCH} x {PAR_SEQ}: loss {ref32_loss}")
            (tmp / "payload.tmp").write_text(json.dumps({
                "plans": {k: p.to_json() for k, (p, _) in plans.items()},
                "fp32": list(PAR_FP32_PLANS)}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"parallel rank {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        log(f"parallel: the oracle {t_ranks - t_phase:.1f} s, beside the ranks' start "
            f"(rank 0 ready {ranks[0]['ready']:.1f} s after its process began); each plan "
            f"(init and {PAR_STEPS} steps) "
            f"{[round(run['seconds'], 1) for run in ranks[0]['runs'].values()]} s, the fp32 "
            f"runs {ranks[0]['fp32_seconds']:.1f} s "
            f"({[round(run['seconds'], 1) for run in ranks[0]['fp32'].values()]}); the ranks "
            f"{time.perf_counter() - t_ranks:.1f} s after the payload")

    card = torch.cuda.get_device_properties(0).total_memory
    for label, (plan, what) in plans.items():
        runs = [rk["runs"][label] for rk in ranks]
        want = par_launches(plan, cfg.num_layers)
        losses = runs[0]["losses"]
        require(all(math.isfinite(x) for x in losses), f"parallel ({label}): losses {losses}")
        require(runs[0]["losses"] == runs[1]["losses"],
                f"parallel ({label}): the ranks report different losses")
        delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
        require(delta <= PAR_LOSS_TOL, f"parallel ({label}): losses {losses} vs one rank "
                f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
        for r, run in enumerate(runs):
            for step, got in enumerate(run["launches"]):
                require(got == want, f"parallel ({label}) rank {r} step {step}: launches "
                        f"{got}, expected {want}")
        peaks = [run["peak"] for run in runs]
        log(f"parallel ({label}) {what}: losses {losses} (one rank {ref_losses}, |delta| "
            f"{delta:.4g}), grad norms {runs[0]['grad_norms']}; step times rank 0 "
            f"{[round(t, 4) for t in runs[0]['times']]} s, rank 1 "
            f"{[round(t, 4) for t in runs[1]['times']]} s ({NO_INTERCONNECT}); peak memory "
            f"{[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} of "
            f"{card / 2**30:.2f} GiB; launches per rank per step K1 "
            f"{want['flash_attention_fwd']}, K2 {want['rmsnorm']}, K2 backward "
            f"{want['rmsnorm_bwd']}; K1 heads (query, KV) {runs[0]['k1_heads']}, local wq "
            f"{runs[0]['local_wq']} wk {runs[0]['local_wk']}; collectives per rank over "
            f"{PAR_STEPS} steps {runs[0]['ops']}")
        if label == "a":
            require(all(run["k1_heads"] == [[16, 4]] for run in runs),
                    f"parallel (a): K1 heads {[run['k1_heads'] for run in runs]}, not 16 / 4")
    for label in PAR_FP32_PLANS:
        got = ranks[0]["fp32"][label]
        rel = abs(got["loss"] - ref32_loss) / abs(ref32_loss)
        err, g_err = got["update_err"], got["grad_err"]
        log(f"parallel fp32 ({label}, {PAR_FP32_LAYERS} layers, AdamW eps {PAR_FP32_EPS}): "
            f"loss {got['loss']} vs one rank {ref32_loss} (relative {rel:.3g}); largest "
            f"grad error {g_err:.3g} and update error {err:.3g} of its leaf's scale")
        require(rel <= PAR_FP32_LOSS_RTOL, f"parallel fp32 ({label}): loss relative {rel}")
        require(g_err <= PAR_FP32_GRAD_TOL, f"parallel fp32 ({label}): grad error {g_err}")
        require(err <= PAR_FP32_UPDATE_TOL, f"parallel fp32 ({label}): update error {err}")
    seconds = time.perf_counter() - t_phase
    log(f"parallel: phase 25 took {seconds:.1f} s")
    return {label: ranks[0]["runs"][label]["launches"][-1] for label in plans}


# --------------------------------------------------------------------------
# 26. the MoE family on a mesh: two ranks sharing the card over gloo
# --------------------------------------------------------------------------

# phase 25's steps, batch and sequence (PAR_*), over moonshot's layers
#: moonshot at full width cut to 1 layer (phases 14 and 23 keep 2), to keep
#: the whole run inside its time limit on a slow host
MPAR_LAYERS = 1
MPAR_FP32_SEQ, MPAR_FP32_BATCH = 1024, 2     # one microbatch: C = 240
#: the plans checked again in fp32: (c)'s repeat (dp 2 ZeRO-3, whose MoE
#: grads the CPU tests hold in fp32) was cut to pay for phase 29
MPAR_FP32_PLANS = ("a", "b")


def moe_par_plans(cfg) -> dict:
    """label -> (plan, what it is), each over ``MPAR_LAYERS`` layers at
    grad_accum ``PAR_ACCUM``: (a) mesh (data 2, model 1), ep 2, ZeRO-1,
    ``selective``: the expert exchange and global routing; (b)
    ``train_mesh_spec(2)`` = (1, 2), tp 2 + sp, ZeRO-1, ``selective``: the
    experts' ff halved, the routing replicated over tp; (c) (1, 2), tp 1
    (dp 2 through the absorbed model axis), ZeRO-3, no remat: global
    routing with no EP, the experts gathered per layer."""
    from repro_torch.core.strategy import LayerStrategy, uniform_plan

    plan = lambda shape, s: uniform_plan(cfg.name, "train_4k", shape, ("data", "model"),
                                         MPAR_LAYERS, s, grad_accum=PAR_ACCUM)
    return {"a": (plan((2, 1), LayerStrategy(ep=2, zero=1, remat="selective")),
                  "(data 2, model 1), ep 2, ZeRO-1, selective"),
            "b": (plan((1, 2), LayerStrategy(tp=2, sp=True, zero=1, remat="selective")),
                  "(1, 2), tp 2 + sp, ZeRO-1, selective"),
            "c": (plan((1, 2), LayerStrategy(zero=3)), "(1, 2), tp 1 (dp 2), ZeRO-3, none")}


def route_check(torch, mesh) -> dict:
    """The routing with no model: global fp32 router logits (seeded, the
    whole ``PAR_ACCUM``-th of a step's tokens, E experts), this rank's
    half routed by ``moe.route`` and placed by ``moe.distributed_slots``
    from the all-gathered counts, gathered back: integer-exact against one
    rank's ``assign_slots`` on the whole, at the layer's capacity and at a
    quarter of it (where choices drop)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.parallel import collectives

    cfg = get_config(MOE_ARCH)
    group = mesh.group(("data", "model"))
    T = PAR_BATCH // PAR_ACCUM * PAR_SEQ
    C = moe._capacity(cfg, T)
    gen = torch.Generator(device="cuda").manual_seed(1)
    logits = torch.randn(T, cfg.num_experts, generator=gen, device="cuda")
    mine = logits.chunk(group.size)[group.index]
    _, idx, aux = moe.route(mine, cfg, group, T)
    counts = collectives.all_gather(moe.choice_counts(idx, cfg.num_experts)[None], 0, group)
    _, one_idx, one_aux = moe.route(logits, cfg)
    out = {"tokens": T, "capacity": C, "kept": [], "aux": float(aux), "one_aux": float(one_aux),
           "idx": bool(torch.equal(collectives.all_gather(idx, 0, group), one_idx)),
           "slots": True, "keep": True}
    for cap in (C, C // 4):
        slots, keep, _ = moe.distributed_slots(idx, counts, group.index, cap)
        got = [collectives.all_gather(t, 0, group) for t in (slots, keep.to(torch.int64))]
        one_slots, one_keep = moe.assign_slots(one_idx, cfg.num_experts, cap)
        out["kept"].append(float(one_keep.float().mean()))
        out["slots"] &= bool(torch.equal(got[0], one_slots))
        out["keep"] &= bool(torch.equal(got[1].bool(), one_keep))
    return out


def moe_parallel_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One rank of phase 26 (``chip_smoke.py --moe-parallel-rank RANK WORLD
    DIR``): device 0, gloo over a ``FileStore`` in DIR, both meshes; the
    routing check, then, once DIR/payload.json is there, each plan trained
    ``PAR_STEPS`` steps (losses, times, launches, K1 heads, exchange bytes,
    peak, the first microbatch's routing); then each rank runs one rank's
    fp32 ``value_and_grad`` (``mesh=None``) at ``MPAR_FP32_SEQ`` and every
    plan runs its own, each rank holding its shards of the grads to the
    same shards of one rank's; writes its record and routings to DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    # the exchange's bytes (sent and received) and the collectives by name
    moved = collections.Counter()
    real_a2a = dist.all_to_all_single

    def a2a(out, x, *a, **kw):
        moved["bytes"] += (out.numel() + x.numel()) * out.element_size()
        moved["calls"] += 1
        moved[f"{out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
        return real_a2a(out, x, *a, **kw)

    dist.all_to_all_single = a2a
    k1_heads = set()
    autograd_k1 = flash_ops.flash_attention

    def seen(q, k, v, causal=True):
        k1_heads.add((q.shape[0], q.shape[2], k.shape[2]))
        return autograd_k1(q, k, v, causal=causal)

    flash_ops.flash_attention = seen
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    dev = torch.device("cuda", 0)
    meshes = {shape: make_mesh(shape, ("data", "model"), device=dev, backend="gloo")
              for shape in ((2, 1), (1, 2))}
    record = {"runs": {}, "fp32": {}, "ready": time.perf_counter() - T_START,
              "route": route_check(torch, meshes[(2, 1)])}
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MPAR_LAYERS)
    ds = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_BATCH, seed=0)
    ds32 = SyntheticDataset(cfg, seq_len=MPAR_FP32_SEQ, global_batch=MPAR_FP32_BATCH, seed=0)
    routes = {}                 # each run's forward routing, layer by layer
    first = lambda log: [idx.cpu() for idx in log.idx[:MPAR_LAYERS]]
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    payload = json.loads((tmp / "payload.json").read_text())
    for label, text in payload["plans"].items():
        t_plan = time.perf_counter()
        plan = ExecutionPlan.from_json(text)
        mesh = meshes[tuple(plan.mesh_shape)]
        hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
        params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
        opt = hp.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"losses": [], "auxes": [], "grad_norms": [], "times": [], "launches": [],
               "bytes": []}
        k1_heads.clear()
        for step in range(PAR_STEPS):
            zero_counts(counters)
            moved.clear()
            dist.barrier()
            t0 = time.perf_counter()
            with RoutingLog() as rlog:
                params, opt, m = hp.train_step(params, opt, ds.batch(step))
            torch.cuda.synchronize()
            run["times"].append(time.perf_counter() - t0)
            run["launches"].append(read_counts(counters))
            run["bytes"].append(moved["bytes"])
            run["losses"].append(float(m["loss"]))
            run["auxes"].append(float(m["aux"]))
            run["grad_norms"].append(float(m["grad_norm"]))
            if step == 0:
                routes[label] = first(rlog)
        run.update(peak=torch.cuda.max_memory_allocated(), k1_heads=sorted(k1_heads),
                   a2a={k: v for k, v in moved.items() if k != "bytes"},
                   seconds=time.perf_counter() - t_plan)
        record["runs"][label] = run
        del hp, params, opt, m
        gc.collect()
        torch.cuda.empty_cache()
    # one rank's fp32 step on the same weights and batch, on each rank
    t_fp32 = time.perf_counter()
    batch32 = ds32.batch(0)
    one = uniform_plan(cfg.name, "t", (1,), ("data",), MPAR_LAYERS,
                       LayerStrategy(remat="selective"))
    hp = construct_hybrid_parallel_model(build_model(cfg), one)
    params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
    with RoutingLog() as rlog:
        loss, _, ref_grads = hp.value_and_grad(params, batch32, torch.float32)
    ref_loss = float(loss)
    routes["fp32_one"] = first(rlog)
    del hp, params, loss
    record["fp32_ref_seconds"] = time.perf_counter() - t_fp32
    for label in MPAR_FP32_PLANS:
        t_run = time.perf_counter()
        full = ExecutionPlan.from_json(payload["plans"][label])
        plan = uniform_plan(cfg.name, "t", full.mesh_shape, full.mesh_axes, MPAR_LAYERS,
                            full.default_strategy)
        mesh = meshes[tuple(plan.mesh_shape)]
        hp = construct_hybrid_parallel_model(build_model(cfg), plan, mesh)
        params = hp.init_params(torch.Generator(device=dev).manual_seed(0))
        dist.barrier()
        with RoutingLog() as rlog:
            loss, _, grads = hp.value_and_grad(params, batch32, torch.float32)
        routes[f"fp32_{label}"] = first(rlog)
        # each rank's shards of every grad against the same shards of one
        # rank's, over that leaf's whole scale; the worst over the ranks
        errs = []
        for g, rg, spec in zip(tree_leaves(grads), tree_leaves(ref_grads),
                               tree_leaves(hp.grad_specs)):
            mine = shd.shard_leaf(rg, spec, mesh)
            errs.append(float((g - mine).abs().max()) / max(float(rg.abs().max()), 1e-30))
        worst = torch.tensor(errs, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        k = int(worst.argmax())
        out = {"loss": float(loss), "ref_loss": ref_loss, "grad_err": float(worst[k]),
               "grad_err_leaf": ".".join(tree_paths(grads)[k][0]),
               "seconds": time.perf_counter() - t_run}
        record["fp32"][label] = out
        del hp, params, grads, loss
        gc.collect()
        torch.cuda.empty_cache()
    record["fp32_seconds"] = time.perf_counter() - t_fp32
    torch.save(routes, tmp / f"routes{rank}.pt")
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def kept_shares(cfg, routes: list, tokens: int) -> list:
    """Per layer: the share of (token, choice) choices JAX's ``assign_slots``
    keeps on the global microbatch ``routes`` (T, k) of ``tokens`` tokens."""
    from repro_torch.models import moe

    C = moe._capacity(cfg, tokens)
    return [float(moe.assign_slots(idx, cfg.num_experts, C)[1].float().mean())
            for idx in routes]


def moe_parallel_phase(torch) -> dict:
    """Phase 26: moonshot at full width cut to ``MPAR_LAYERS`` layers on two
    ranks sharing the card over gloo (``moe_par_plans``), held to one rank's
    ``mesh=None`` step on the same seed-0 weights and batches: bf16 losses
    within ``PAR_LOSS_TOL``; at ``MPAR_FP32_SEQ`` in fp32 the loss within
    ``PAR_FP32_LOSS_RTOL`` relative and every grad (each rank's shards of
    it) within ``PAR_FP32_GRAD_TOL`` of its leaf's grad scale, each layer's routing
    decisions that differ from one rank's logged beside them; the routing
    of global logits split over the ranks integer-exact (``route_check``).
    Each rank's K1, K2 and K2-backward launches per step are pinned
    (``par_launches``) and K1's local heads checked.  Logs the kept share
    per layer against one rank's, the exchange's bytes, each rank's peak
    and their sum against the card, and the step times (labelled: no
    interconnect is measured).  Returns each plan's launches in rank 0's
    last step."""
    import math
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MPAR_LAYERS)
    plans = moe_par_plans(cfg)
    ds = SyntheticDataset(cfg, seq_len=PAR_SEQ, global_batch=PAR_BATCH, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--moe-parallel-rank", str(r), "2", str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            one = uniform_plan(cfg.name, "train_4k", (1,), ("data",), MPAR_LAYERS,
                               LayerStrategy(remat="selective"), grad_accum=PAR_ACCUM)
            hp = construct_hybrid_parallel_model(build_model(cfg), one)
            params = hp.init_params(torch.Generator(device="cuda").manual_seed(0))
            opt = hp.init_opt_state(params)
            ref_losses, ref_times, ref_auxes = [], [], []
            for step in range(PAR_STEPS):
                t0 = time.perf_counter()
                with RoutingLog() as rlog:
                    params, opt, m = hp.train_step(params, opt, ds.batch(step))
                torch.cuda.synchronize()
                ref_times.append(time.perf_counter() - t0)
                ref_losses.append(float(m["loss"]))
                ref_auxes.append(float(m["aux"]))
                if step == 0:           # the first microbatch's forward, layer by layer
                    ref_routes = [idx.cpu() for idx in rlog.idx[:MPAR_LAYERS]]
                del rlog
            ref_peak = torch.cuda.max_memory_allocated()
            del hp, params, opt, m
            gc.collect()
            torch.cuda.empty_cache()
            log(f"moe parallel: one rank (mesh=None, selective, grad_accum {PAR_ACCUM}, "
                f"{PAR_BATCH} x {PAR_SEQ}): losses {ref_losses}, aux {ref_auxes}, step times "
                f"{[round(t, 4) for t in ref_times]} s, peak {ref_peak / 2**30:.2f} GiB")
            (tmp / "payload.tmp").write_text(json.dumps(
                {"plans": {k: p.to_json() for k, (p, _) in plans.items()}}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"moe parallel rank {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
        routes = [torch.load(tmp / f"routes{r}.pt") for r in range(2)]
        log(f"moe parallel: the oracle {t_ranks - t_phase:.1f} s beside the ranks' start "
            f"(rank 0 ready {ranks[0]['ready']:.1f} s after its process began); each plan "
            f"(init and {PAR_STEPS} steps) "
            f"{[round(run['seconds'], 1) for run in ranks[0]['runs'].values()]} s; fp32 "
            f"{ranks[0]['fp32_seconds']:.1f} s (one rank's reference "
            f"{ranks[0]['fp32_ref_seconds']:.1f}); the ranks {time.perf_counter() - t_ranks:.1f} "
            f"s after the payload")

    rc = ranks[0]["route"]
    log(f"moe parallel: routing of {rc['tokens']} seeded fp32 logits split over 2 ranks "
        f"(C {rc['capacity']} and a quarter of it: {rc['kept']} of choices kept): expert indices "
        f"{'exact' if rc['idx'] else 'DIFFER'}, slots {'exact' if rc['slots'] else 'DIFFER'}, "
        f"keep {'exact' if rc['keep'] else 'DIFFER'}; aux {rc['aux']} vs one rank "
        f"{rc['one_aux']}")
    require(all(rk["route"][k] for rk in ranks for k in ("idx", "slots", "keep")),
            f"moe parallel: distributed routing differs from one rank's: {rc}")
    require(abs(rc["aux"] - rc["one_aux"]) <= 1e-5 * abs(rc["one_aux"]),
            f"moe parallel: the routing check's aux {rc['aux']} vs {rc['one_aux']}")
    card = torch.cuda.get_device_properties(0).total_memory
    tokens = PAR_BATCH // PAR_ACCUM * PAR_SEQ
    one_kept = kept_shares(cfg, ref_routes, tokens)
    for label, (plan, what) in plans.items():
        runs = [rk["runs"][label] for rk in ranks]
        want = par_launches(plan, MPAR_LAYERS)
        losses = runs[0]["losses"]
        require(all(math.isfinite(x) for x in losses + runs[0]["auxes"]),
                f"moe parallel ({label}): losses {losses}, aux {runs[0]['auxes']}")
        require(runs[0]["losses"] == runs[1]["losses"],
                f"moe parallel ({label}): the ranks report different losses")
        delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
        require(delta <= PAR_LOSS_TOL, f"moe parallel ({label}): losses {losses} vs one rank "
                f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
        for r, run in enumerate(runs):
            for step, got in enumerate(run["launches"]):
                require(got == want, f"moe parallel ({label}) rank {r} step {step}: launches "
                        f"{got}, expected {want}")
        s = plan.default_strategy
        heads = ([[PAR_BATCH // PAR_ACCUM, 8, 8]] if s.tp == 2 else [[1, 16, 16]])
        require(all(run["k1_heads"] == heads for run in runs),
                f"moe parallel ({label}): K1 (batch, heads, KV heads) "
                f"{[run['k1_heads'] for run in runs]}, expected {heads}")
        # the first microbatch's routing, the ranks' tokens in batch order
        ranked = routes[0][label] if s.tp == 2 else [
            torch.cat([routes[0][label][i], routes[1][label][i]]) for i in range(MPAR_LAYERS)]
        kept = kept_shares(cfg, ranked, tokens)
        peaks = [run["peak"] for run in runs]
        log(f"moe parallel ({label}) {what}: losses {losses} (one rank {ref_losses}, |delta| "
            f"{delta:.4g}), aux {runs[0]['auxes']} (one rank {ref_auxes}), grad norms "
            f"{runs[0]['grad_norms']}; kept share per layer {[round(x, 4) for x in kept]} (one "
            f"rank {[round(x, 4) for x in one_kept]}); exchange bytes a rank a step (sent and "
            f"received) {runs[0]['bytes']} / {runs[1]['bytes']}, all_to_all calls "
            f"{runs[0]['a2a']}; step times rank 0 {[round(t, 4) for t in runs[0]['times']]} s, "
            f"rank 1 {[round(t, 4) for t in runs[1]['times']]} s ({NO_INTERCONNECT}); peak "
            f"memory {[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} "
            f"of {card / 2**30:.2f} GiB; launches per rank per step K1 "
            f"{want['flash_attention_fwd']}, K2 {want['rmsnorm']}, K2 backward "
            f"{want['rmsnorm_bwd']}; K1 (batch, heads, KV heads) {runs[0]['k1_heads']}")
        require(sum(peaks) <= card, f"moe parallel ({label}): peaks {peaks} past the card")
        if s.ep > 1:
            require(all(run["bytes"][0] > 0 for run in runs),
                    f"moe parallel ({label}): no expert exchange under ep {s.ep}")
    one_fp32 = routes[0]["fp32_one"]
    for label in MPAR_FP32_PLANS:
        plan = plans[label][0]
        got = ranks[0]["fp32"][label]
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        tp = plan.default_strategy.tp == 2
        ranked = routes[0][f"fp32_{label}"] if tp else [
            torch.cat([routes[0][f"fp32_{label}"][i], routes[1][f"fp32_{label}"][i]])
            for i in range(MPAR_LAYERS)]
        flips = [int((a != b).sum()) for a, b in zip(ranked, one_fp32)]
        log(f"moe parallel fp32 ({label}, {MPAR_LAYERS} layers, {MPAR_FP32_BATCH} x "
            f"{MPAR_FP32_SEQ}): loss {got['loss']} vs one rank {got['ref_loss']} (relative "
            f"{rel:.3g}); largest grad error {got['grad_err']:.3g} of its leaf's scale "
            f"({got['grad_err_leaf']}); routing decisions that differ from one rank's per layer "
            f"{flips} of {one_fp32[0].numel()}")
        require(rel <= PAR_FP32_LOSS_RTOL, f"moe parallel fp32 ({label}): loss relative {rel}")
        require(got["grad_err"] <= PAR_FP32_GRAD_TOL,
                f"moe parallel fp32 ({label}): grad error {got['grad_err']}")
    seconds = time.perf_counter() - t_phase
    log(f"moe parallel: phase 26 took {seconds:.1f} s")
    return {label: ranks[0]["runs"][label]["launches"][-1] for label in plans}


# --------------------------------------------------------------------------
# 27. tensor parallelism in the SSM, hybrid and audio families: two ranks
#     sharing the card over gloo
# --------------------------------------------------------------------------

SPAR_SEQ = 2048                 # mamba2 and zamba2: PAR_BATCH x 2048 tokens a step
SPAR_WINDOWS, SPAR_TEXT, SPAR_FRAMES = 64, 448, 1500    # whisper: 64 windows a step
SPAR_FP32_SEQ = 512             # mamba2 and zamba2 in fp32: 2 x 512, one microbatch
SPAR_FP32_BATCH = 2
SPAR_FP32_WINDOWS = 4


def ssm_par_cases() -> dict:
    """label -> (arch, layers (None: full depth), strategy, global batch,
    sequence, fp32 layers, fp32 batch, what): (a) mamba2-2.7b cut to 4
    layers, tp 2 without SP (what the search proposes for the ssm family),
    ZeRO-1, ``selective``; (b) zamba2-7b cut to 6 layers (one shared-block
    site, the least depth that has one), tp 2 + sp, ZeRO-1, no remat (the
    family takes no runner); (c) whisper-tiny at full depth, tp 2 + sp,
    ZeRO-1.  Each on mesh (data 1, model 2) at grad_accum ``PAR_ACCUM``."""
    from repro_torch.core.strategy import LayerStrategy

    return {"a": ("mamba2-2.7b", 4, LayerStrategy(tp=2, zero=1, remat="selective"),
                  PAR_BATCH, SPAR_SEQ, 2, SPAR_FP32_BATCH,
                  "mamba2-2.7b cut to 4 layers, tp 2, ZeRO-1, selective"),
            "b": ("zamba2-7b", 6, LayerStrategy(tp=2, sp=True, zero=1), PAR_BATCH, SPAR_SEQ,
                  6, SPAR_FP32_BATCH,
                  "zamba2-7b cut to 6 layers (one shared-block site), tp 2 + sp, ZeRO-1"),
            "c": ("whisper-tiny", None, LayerStrategy(tp=2, sp=True, zero=1), SPAR_WINDOWS,
                  SPAR_TEXT, None, SPAR_FP32_WINDOWS,
                  "whisper-tiny at full depth, tp 2 + sp, ZeRO-1")}


def ssm_par_config(arch: str, layers):
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def ssm_par_plan(cfg, strategy, mesh: bool, grad_accum: int = PAR_ACCUM):
    """The case's plan on (data 1, model 2), or one rank's (tp 1, no SP, no
    ZeRO, the same remat)."""
    from repro_torch.core.strategy import uniform_plan

    if mesh:
        return uniform_plan(cfg.name, "train", PAR_MESH[0], PAR_MESH[1], cfg.num_layers,
                            strategy, grad_accum=grad_accum)
    return uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                        dataclasses.replace(strategy, tp=1, sp=False, zero=0),
                        grad_accum=grad_accum)


def split_counters(rms_ops) -> dict:
    """K2's split-row passes' launch counters, beside ``launch_counters``'."""
    return {"rmsnorm_split_sumsq": (rms_ops.rmsnorm_split_sumsq, "launches"),
            "rmsnorm_split": (rms_ops.rmsnorm_split, "launches"),
            "rmsnorm_split_dot": (rms_ops.rmsnorm_split_dot, "launches"),
            "rmsnorm_split_backward": (rms_ops.rmsnorm_split_backward, "launches")}


def ssm_par_launches(cfg, strategy) -> dict:
    """Kernel launches per step of one rank under a phase 27 plan.  A
    Mamba2 layer's forward launches the whole-row K2 once (its layer norm),
    the split K2's two forward passes once each (its gate norm) and K3 once,
    and a recomputing policy reruns them in the backward (the ssm family
    alone: the hybrid and audio families take no runner); its backward runs
    K2's backward once and the split backward's two passes once each.  A
    shared-block site: K1 once, K2 and its backward twice.  Whisper: K1 per
    encoder layer and twice per decoder layer, K2 and its backward per norm
    (``whisper_train_phase``).  The final norm: K2 and its backward once."""
    k = PAR_ACCUM
    zero = {name: 0 for name in ("flash_attention_fwd", "rmsnorm", "rmsnorm_gated",
                                 "rmsnorm_bwd", "ssd", "ssd_autograd", "rmsnorm_split_sumsq",
                                 "rmsnorm_split", "rmsnorm_split_dot", "rmsnorm_split_backward")}
    if cfg.family == "audio":
        norms = 2 * cfg.enc_layers + 3 * cfg.num_layers + 2
        return {**zero, "flash_attention_fwd": k * (cfg.enc_layers + 2 * cfg.num_layers),
                "rmsnorm": k * norms, "rmsnorm_bwd": k * norms}
    L = cfg.num_layers
    sites = L // cfg.attn_every if cfg.family == "hybrid" else 0
    again = int(strategy.remat != "none" and cfg.family == "ssm")
    fwd = k * L * (1 + again)
    return {**zero, "flash_attention_fwd": k * sites,
            "rmsnorm": k * (L * (1 + again) + 2 * sites + 1),
            "rmsnorm_bwd": k * (L + 2 * sites + 1),
            "ssd": fwd, "ssd_autograd": fwd, "rmsnorm_split_sumsq": fwd, "rmsnorm_split": fwd,
            "rmsnorm_split_dot": k * L, "rmsnorm_split_backward": k * L}


def ssm_par_shapes(cfg, batch: int, seq: int) -> dict:
    """What a tp 2 rank's kernels see: K1's (batch, Sq, Sk, heads, KV
    heads), K3's (batch, S, heads, groups) and the split K2's (rows,
    columns, width)."""
    mb = batch // PAR_ACCUM
    if cfg.family == "audio":
        F, h = cfg.enc_frames, cfg.num_heads // 2
        return {"k1": sorted([[mb, F, F, h, h], [mb, seq, F, h, h], [mb, seq, seq, h, h]]),
                "k3": [], "split": []}
    d_inner = cfg.ssm_expand * cfg.d_model
    H, G = d_inner // cfg.ssm_head_dim, cfg.ssm_groups
    k1 = ([[mb, seq, seq, cfg.num_heads // 2, cfg.num_kv_heads // 2]]
          if cfg.family == "hybrid" else [])
    return {"k1": k1, "k3": [[mb, seq, H // 2, max(G // 2, 1)]],
            "split": [[mb * seq, d_inner // 2, d_inner]]}


def ssm_parallel_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One rank of phase 27 (``chip_smoke.py --ssm-parallel-rank RANK WORLD
    DIR``): device 0, gloo over a ``FileStore`` in DIR; once DIR/payload.json
    is there (the parent's oracle done), each case of ``ssm_par_cases``
    trained ``PAR_STEPS`` steps (losses, times, launches, the shapes K1, K3
    and the split K2 see, the collectives by name, peak); then each case in
    fp32 at its reduced size: one rank's ``value_and_grad`` (``mesh=None``)
    and the plan's on the same weights and batch, each rank holding its
    shards of the grads to the same shards of one rank's; writes its record
    to DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.models.mamba2 import local_groups
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    used = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def counted(out, *a, _run=getattr(dist, name), _name=name, **kw):
            used[f"{_name} {out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
            return _run(out, *a, **kw)
        setattr(dist, name, counted)
    # what the kernels see: hooks on functions that hold no counter
    seen = {"k1": set(), "k3": set(), "split": set()}
    autograd_k1, ssd_kernel = flash_ops.flash_attention, ssd_ops._ssd_kernel
    check_stat, check_width = rms_ops._check_stat, rms_ops._check_width

    def k1(q, k, v, causal=True):
        seen["k1"].add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2]))
        return autograd_k1(q, k, v, causal=causal)

    def k3(x, dt, A, B, C, **kw):
        seen["k3"].add((x.shape[0], x.shape[1], x.shape[2], B.shape[2]))
        return ssd_kernel(x, dt, A, B, C, **kw)

    last = {}

    def stat_hook(name, x, *stats):
        last["rows"] = x.numel() // x.shape[-1]
        return check_stat(name, x, *stats)

    def width_hook(name, D, width):
        if name == "rmsnorm split":
            seen["split"].add((last["rows"], D, width))
        return check_width(name, D, width)

    flash_ops.flash_attention, ssd_ops._ssd_kernel = k1, k3
    rms_ops._check_stat, rms_ops._check_width = stat_hook, width_hook
    counters = {**launch_counters(flash_ops, rms_ops, ssd_ops), **split_counters(rms_ops)}
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*PAR_MESH, device=dev, backend="gloo")
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    record = {"runs": {}, "fp32": {}, "ready": time.perf_counter() - T_START,
              "groups": local_groups(112, 2, 2, rank)}
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    for label, (arch, layers, strategy, batch, seq, _, _, _) in ssm_par_cases().items():
        t_plan = time.perf_counter()
        cfg = ssm_par_config(arch, layers)
        ds = SyntheticDataset(cfg, seq_len=seq, global_batch=batch, seed=0)
        hp = construct_hybrid_parallel_model(build_model(cfg), ssm_par_plan(cfg, strategy, True),
                                             mesh)
        params = hp.init_params(gen())
        opt = hp.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        used.clear()
        for v in seen.values():
            v.clear()
        run = {"losses": [], "grad_norms": [], "times": [], "launches": []}
        for step in range(PAR_STEPS):
            b = ds.batch(step)
            zero_counts(counters)
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = hp.train_step(params, opt, b)
            torch.cuda.synchronize()
            run["times"].append(time.perf_counter() - t0)
            run["launches"].append(read_counts(counters))
            run["losses"].append(float(m["loss"]))
            run["grad_norms"].append(float(m["grad_norm"]))
        run.update(peak=torch.cuda.max_memory_allocated(), ops=dict(used),
                   seconds=time.perf_counter() - t_plan,
                   **{k: sorted(list(t) for t in v) for k, v in seen.items()})
        record["runs"][label] = run
        del hp, params, opt, m, b
        gc.collect()
        torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    for label, (arch, layers, strategy, _, seq, layers32, batch32, _) in ssm_par_cases().items():
        t_run = time.perf_counter()
        cfg = ssm_par_config(arch, layers32)
        batch = SyntheticDataset(cfg, seq_len=seq if cfg.family == "audio" else SPAR_FP32_SEQ,
                                 global_batch=batch32, seed=0).batch(0)
        one = construct_hybrid_parallel_model(build_model(cfg),
                                              ssm_par_plan(cfg, strategy, False, 1))
        ref_loss, _, ref_grads = one.value_and_grad(one.init_params(gen()), batch,
                                                    torch.float32)
        del one
        hp = construct_hybrid_parallel_model(build_model(cfg),
                                             ssm_par_plan(cfg, strategy, True, 1), mesh)
        dist.barrier()
        loss, _, grads = hp.value_and_grad(hp.init_params(gen()), batch, torch.float32)
        errs = []
        for g, rg, spec in zip(tree_leaves(grads), tree_leaves(hp.group(ref_grads)),
                               tree_leaves(hp.grad_specs)):
            mine = shd.shard_leaf(rg, spec, mesh)
            errs.append(float((g - mine).abs().max()) / max(float(rg.abs().max()), 1e-30))
        worst = torch.tensor(errs, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        i = int(worst.argmax())
        record["fp32"][label] = {"loss": float(loss), "ref_loss": float(ref_loss),
                                 "grad_err": float(worst[i]),
                                 "grad_err_leaf": ".".join(tree_paths(grads)[i][0]),
                                 "layers": cfg.num_layers, "seconds": time.perf_counter() - t_run}
        del hp, grads, ref_grads, loss, ref_loss
        gc.collect()
        torch.cuda.empty_cache()
    record["fp32_seconds"] = time.perf_counter() - t_fp32
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def ssm_parallel_phase(torch) -> dict:
    """Phase 27: tensor parallelism in the SSM, hybrid and audio families on
    two ranks sharing the card over gloo (``ssm_par_cases``), each held to
    one rank's ``mesh=None`` step on the same seed-0 weights and batches
    (computed here while the ranks start): bf16 losses within
    ``PAR_LOSS_TOL``; in fp32 at the reduced sizes the loss within
    ``PAR_FP32_LOSS_RTOL`` relative and every grad's shards within
    ``PAR_FP32_GRAD_TOL`` of its leaf's grad scale.  Each rank's launches
    per step of K1, K2, K2's backward, the split K2's four passes and K3 are
    pinned (``ssm_par_launches``), and the shapes K1, K3 and the split K2
    see are a tp 2 rank's (``ssm_par_shapes``: zamba2's K3 on one of the
    two groups, rank 0 on group 0 and rank 1 on group 1).  Logs each rank's
    peak and their sum against the card, the step times (labelled: no
    interconnect is measured) and the collectives called.  Returns each
    case's launches in rank 0's last step."""
    import math
    import tempfile

    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cases = ssm_par_cases()
    oracle = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--ssm-parallel-rank", str(r), "2", str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            for label, (arch, layers, strategy, batch, seq, _, _, _) in cases.items():
                cfg = ssm_par_config(arch, layers)
                ds = SyntheticDataset(cfg, seq_len=seq, global_batch=batch, seed=0)
                hp = construct_hybrid_parallel_model(build_model(cfg),
                                                     ssm_par_plan(cfg, strategy, False))
                params = hp.init_params(torch.Generator(device="cuda").manual_seed(0))
                opt = hp.init_opt_state(params)
                torch.cuda.reset_peak_memory_stats()
                losses, times = [], []
                for step in range(PAR_STEPS):
                    t0 = time.perf_counter()
                    params, opt, m = hp.train_step(params, opt, ds.batch(step))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
                oracle[label] = (losses, times, torch.cuda.max_memory_allocated())
                del hp, params, opt, m
                gc.collect()
                torch.cuda.empty_cache()
            (tmp / "payload.tmp").write_text(json.dumps({"go": True}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"ssm parallel rank {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    log(f"ssm parallel: the oracle {t_ranks - t_phase:.1f} s beside the ranks' start (rank 0 "
        f"ready {ranks[0]['ready']:.1f} s after its process began); each case (init and "
        f"{PAR_STEPS} steps) {[round(run['seconds'], 1) for run in ranks[0]['runs'].values()]} "
        f"s; fp32 {ranks[0]['fp32_seconds']:.1f} s; the ranks "
        f"{time.perf_counter() - t_ranks:.1f} s after the payload")
    require([rk["groups"] for rk in ranks] == [[0, 1], [1, 2]],
            f"ssm parallel: zamba2's groups at tp 2 {[rk['groups'] for rk in ranks]}")
    card = torch.cuda.get_device_properties(0).total_memory
    for label, (arch, layers, strategy, batch, seq, _, _, what) in cases.items():
        cfg = ssm_par_config(arch, layers)
        runs = [rk["runs"][label] for rk in ranks]
        want = ssm_par_launches(cfg, strategy)
        shapes = ssm_par_shapes(cfg, batch, seq)
        ref_losses, ref_times, ref_peak = oracle[label]
        losses = runs[0]["losses"]
        require(all(math.isfinite(x) for x in losses), f"ssm parallel ({label}): losses {losses}")
        require(runs[0]["losses"] == runs[1]["losses"],
                f"ssm parallel ({label}): the ranks report different losses")
        delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
        require(delta <= PAR_LOSS_TOL, f"ssm parallel ({label}): losses {losses} vs one rank "
                f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
        for r, run in enumerate(runs):
            for step, got in enumerate(run["launches"]):
                require(got == want, f"ssm parallel ({label}) rank {r} step {step}: launches "
                        f"{got}, expected {want}")
            got_shapes = {k: run[k] for k in shapes}
            require(got_shapes == shapes, f"ssm parallel ({label}) rank {r}: kernel shapes "
                    f"{got_shapes}, expected {shapes}")
        peaks = [run["peak"] for run in runs]
        log(f"ssm parallel ({label}) {what}, {batch} x {seq} a step in {PAR_ACCUM} "
            f"microbatches: losses {losses} (one rank {ref_losses}, |delta| {delta:.4g}), grad "
            f"norms {runs[0]['grad_norms']}; step times rank 0 "
            f"{[round(t, 4) for t in runs[0]['times']]} s, rank 1 "
            f"{[round(t, 4) for t in runs[1]['times']]} s ({NO_INTERCONNECT}; one rank "
            f"{[round(t, 4) for t in ref_times]} s, peak {ref_peak / 2**30:.2f} GiB); peak "
            f"memory {[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} "
            f"of {card / 2**30:.2f} GiB; launches per rank per step "
            f"{ {k: v for k, v in want.items() if v} }; kernel shapes {shapes}; collectives "
            f"per rank over {PAR_STEPS} steps {runs[0]['ops']}")
        require(sum(peaks) <= card, f"ssm parallel ({label}): peaks {peaks} past the card")
    for label in cases:
        got = ranks[0]["fp32"][label]
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        log(f"ssm parallel fp32 ({label}, {got['layers']} layers): loss {got['loss']} vs one "
            f"rank {got['ref_loss']} (relative {rel:.3g}); largest grad error "
            f"{got['grad_err']:.3g} of its leaf's scale ({got['grad_err_leaf']})")
        require(rel <= PAR_FP32_LOSS_RTOL, f"ssm parallel fp32 ({label}): loss relative {rel}")
        require(got["grad_err"] <= PAR_FP32_GRAD_TOL,
                f"ssm parallel fp32 ({label}): grad error {got['grad_err']}")
    seconds = time.perf_counter() - t_phase
    log(f"ssm parallel: phase 27 took {seconds:.1f} s")
    return {label: ranks[0]["runs"][label]["launches"][-1] for label in cases}


# --------------------------------------------------------------------------
# 28. pipeline parallelism: two stages sharing the card over gloo
# --------------------------------------------------------------------------

#: llama3.2-1b and mamba2-2.7b at full width cut to 4 layers (2 a stage),
#: 8 sequences a step in 4 microbatches of 2, 1 step a case (2 until phase
#: 30 came, whose two steps hold a staged update)
PP_LAYERS, PP_BATCH, PP_ACCUM, PP_STEPS = 4, 8, 4, 1
PP_MESH = ((2, 1, 1), ("pod", "data", "model"))   # launch.mesh.train_mesh_spec(2, pp=2)
PP_FP32_SEQ = 256              # the fp32 checks: 8 x 256 a step, grad_accum 4
#: the cases checked again in fp32: (b)'s repeat (1f1b, whose grads the CPU
#: tests hold in fp32) was cut to pay for phase 29
PP_FP32_CASES = ("a", "c", "d")


def pp_cases() -> dict:
    """label -> (arch, schedule, interleave, sequence, what): llama3.2-1b
    under (a) gpipe, (b) 1f1b (2 windows of 2), (c) interleaved v 2 (stage
    0 holds layers 0 and 2, stage 1 layers 1 and 3), at 4096 tokens a
    sequence; (d) mamba2-2.7b under 1f1b at 2048, K3 under autograd in both
    stages; every case ``selective``."""
    return {"a": ("llama3.2-1b", "gpipe", 1, TRAIN_SEQ, "llama3.2-1b, gpipe"),
            "b": ("llama3.2-1b", "1f1b", 1, TRAIN_SEQ, "llama3.2-1b, 1f1b (2 windows of 2)"),
            "c": ("llama3.2-1b", "interleaved", 2, TRAIN_SEQ,
                  "llama3.2-1b, interleaved v 2 (stage 0: layers 0 and 2)"),
            "d": ("mamba2-2.7b", "1f1b", 1, SSM_TRAIN_SEQ, "mamba2-2.7b, 1f1b")}


def pp_config(arch: str):
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch), num_layers=PP_LAYERS)


def pp_plan(cfg, schedule: str, interleave: int, mesh: bool = True):
    """A phase 28 plan on ``PP_MESH`` (pp 2, ``selective``, grad_accum
    ``PP_ACCUM``), or one rank's (``mesh=False``: the same remat and
    microbatches, no pipeline)."""
    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan

    strategy = LayerStrategy(remat="selective")
    if not mesh:
        return uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers, strategy,
                            grad_accum=PP_ACCUM)
    shape, axes = PP_MESH
    return ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=axes, mesh_shape=shape,
                         pp=shape[0], pp_schedule=schedule, pp_interleave=interleave,
                         grad_accum=PP_ACCUM, layer_strategies=[strategy] * cfg.num_layers,
                         default_strategy=strategy)


def pp_launches(cfg, plan, stage: int) -> dict:
    """Kernel launches per step of one stage: each of its layers in every
    microbatch — a llama layer's forward K1 once and K2 twice, again in its
    backward (``selective`` recomputes them), K2's backward twice; a
    mamba2 layer's K3 (under ``ssd_autograd``) once and K2 twice (the
    layer norm and the gate norm, composed under autograd), again in its
    backward, K2's backward twice — and on the last stage the final norm's
    K2 and its backward once a microbatch."""
    M = max(plan.grad_accum, plan.pp)
    Ls = cfg.num_layers // plan.pp
    again = int(plan.default_strategy.remat != "none")
    last = int(stage == plan.pp - 1)
    ssm = cfg.family == "ssm"
    return {"flash_attention_fwd": 0 if ssm else M * Ls * (1 + again),
            "rmsnorm": M * (2 * Ls * (1 + again) + last), "rmsnorm_gated": 0,
            "rmsnorm_bwd": M * (2 * Ls + last),
            "ssd": M * Ls * (1 + again) if ssm else 0,
            "ssd_autograd": M * Ls * (1 + again) if ssm else 0}


def pp_shapes(cfg, seq: int) -> dict:
    """What a stage's kernels see: K1's (batch, Sq, Sk, heads, KV heads) —
    the llama training row — and K3's (batch, S, heads, groups) — mamba2's
    training row — at a microbatch of ``PP_BATCH / PP_ACCUM`` sequences."""
    mb = PP_BATCH // PP_ACCUM
    if cfg.family == "ssm":
        H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        return {"k1": [], "k3": [[mb, seq, H, cfg.ssm_groups]]}
    return {"k1": [[mb, seq, seq, cfg.num_heads, cfg.num_kv_heads]], "k3": []}


def pipeline_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One stage of phase 28 (``chip_smoke.py --pp-rank RANK WORLD DIR``):
    device 0, gloo over a ``FileStore`` in DIR; once DIR/payload.json is
    there (the parent's oracle done), each case of ``pp_cases`` trained
    ``PP_STEPS`` steps through ``PipelineTrainer`` (losses, times, launches,
    the shapes K1 and K3 see, ``max_in_flight``, the boundary bytes, the
    collectives by name, peak); then each of ``PP_FP32_CASES`` in fp32 at ``PP_FP32_SEQ``:
    ``value_and_grad`` on the same seed-0 weights, its grad shards against
    the same shards of the parent's one-rank grads; writes its record to
    DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train_pp import PipelineTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    used = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def counted(out, *a, _run=getattr(dist, name), _name=name, **kw):
            used[f"{_name} {out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
            return _run(out, *a, **kw)
        setattr(dist, name, counted)
    seen = {"k1": set(), "k3": set()}
    autograd_k1, ssd_kernel = flash_ops.flash_attention, ssd_ops._ssd_kernel

    def k1(q, k, v, causal=True):
        seen["k1"].add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2]))
        return autograd_k1(q, k, v, causal=causal)

    def k3(x, dt, A, B, C, **kw):
        seen["k3"].add((x.shape[0], x.shape[1], x.shape[2], B.shape[2]))
        return ssd_kernel(x, dt, A, B, C, **kw)

    flash_ops.flash_attention, ssd_ops._ssd_kernel = k1, k3
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*PP_MESH, device=dev, backend="gloo")
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    record = {"runs": {}, "fp32": {}, "ready": time.perf_counter() - T_START}
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    for label, (arch, schedule, v, seq, _) in pp_cases().items():
        t_case = time.perf_counter()
        cfg = pp_config(arch)
        ds = SyntheticDataset(cfg, seq_len=seq, global_batch=PP_BATCH, seed=0)
        tr = PipelineTrainer(build_model(cfg), pp_plan(cfg, schedule, v), mesh)
        params = tr.init_params(gen())
        opt = tr.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        used.clear()
        for x in seen.values():
            x.clear()
        run = {"losses": [], "grad_norms": [], "times": [], "launches": [], "in_flight": []}
        for step in range(PP_STEPS):
            b = ds.batch(step)
            zero_counts(counters)
            tr.hop.bytes.update(sent=0, received=0, host_copies=0)
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = tr.train_step(params, opt, b)
            torch.cuda.synchronize()
            run["times"].append(time.perf_counter() - t0)
            run["launches"].append(read_counts(counters))
            run["losses"].append(float(m["loss"]))
            run["grad_norms"].append(float(m["grad_norm"]))
            run["in_flight"].append(tr.max_in_flight)
        run.update(peak=torch.cuda.max_memory_allocated(), ops=dict(used), stage=tr.stage,
                   hop=dict(tr.hop.bytes), seconds=time.perf_counter() - t_case,
                   **{k: sorted(list(t) for t in x) for k, x in seen.items()})
        record["runs"][label] = run
        del tr, params, opt, m, b
        gc.collect()
        torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    for label in PP_FP32_CASES:
        arch, schedule, v, _, _ = pp_cases()[label]
        t_run = time.perf_counter()
        cfg = pp_config(arch)
        batch = SyntheticDataset(cfg, seq_len=PP_FP32_SEQ, global_batch=PP_BATCH,
                                 seed=0).batch(0)
        ref = torch.load(tmp / f"fp32_{arch}.pt", map_location=dev)
        tr = PipelineTrainer(build_model(cfg), pp_plan(cfg, schedule, v), mesh)
        loss, _, grads = tr.value_and_grad(tr.init_params(gen()), batch, torch.float32)
        errs = []
        for g, rg, spec in zip(tree_leaves(grads), tree_leaves(tr.group(ref["grads"])),
                               tree_leaves(tr.grad_specs)):
            mine = shd.shard_leaf(rg, spec, mesh)
            errs.append(float((g - mine).abs().max()) / max(float(rg.abs().max()), 1e-30))
        worst = torch.tensor(errs, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        i = int(worst.argmax())
        record["fp32"][label] = {"loss": float(loss), "ref_loss": float(ref["loss"]),
                                 "grad_err": float(worst[i]),
                                 "grad_err_leaf": ".".join(tree_paths(grads)[i][0]),
                                 "seconds": time.perf_counter() - t_run}
        del tr, grads, ref, loss
        gc.collect()
        torch.cuda.empty_cache()
    record["fp32_seconds"] = time.perf_counter() - t_fp32
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def pipeline_phase(torch) -> dict:
    """Phase 28: ``PipelineTrainer`` on two stages sharing the card over
    gloo (``pp_cases``), each case held to one rank's full-batch loss on
    the same seed-0 weights and batches, computed here while the stages
    start (``mesh=None`` at the same 4 microbatches: the batch masks no
    label, so the mean of the microbatch means is the token mean): bf16
    losses within ``PAR_LOSS_TOL``; in fp32 at ``PP_FP32_SEQ`` the loss
    within ``PAR_FP32_LOSS_RTOL`` relative and every grad's shards within
    ``PAR_FP32_GRAD_TOL`` of its leaf's scale, against one rank's
    ``value_and_grad`` at grad_accum 1.  Each stage's K1, K2, K2-backward
    and K3 launches per step are pinned (``pp_launches``), the shapes K1
    and K3 see are the training rows (``pp_shapes``), and ``max_in_flight``
    is M under gpipe and at most S otherwise.  Logs each stage's peak and
    their sum against the card, the boundary bytes, the step times
    (labelled: gloo through the host, no interconnect) and the collectives
    called.  Returns each case's launches, both stages' last step summed."""
    import math
    import tempfile

    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cases = pp_cases()
    oracle = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--pp-rank", str(r), "2", str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            gen = lambda: torch.Generator(device="cuda").manual_seed(0)
            for arch, seq in {(c[0], c[3]) for c in cases.values()}:
                cfg = pp_config(arch)
                ds = SyntheticDataset(cfg, seq_len=seq, global_batch=PP_BATCH, seed=0)
                hp = construct_hybrid_parallel_model(build_model(cfg),
                                                     pp_plan(cfg, "gpipe", 1, mesh=False))
                params = hp.init_params(gen())
                opt = hp.init_opt_state(params)
                torch.cuda.reset_peak_memory_stats()
                losses, times = [], []
                for step in range(PP_STEPS):
                    b = ds.batch(step)
                    valid = (b["labels"] >= 0).reshape(PP_ACCUM, -1).sum(axis=1)
                    require(len(set(valid.tolist())) == 1,
                            f"pipeline oracle: microbatch token counts {valid.tolist()}")
                    t0 = time.perf_counter()
                    params, opt, m = hp.train_step(params, opt, b)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
                oracle[arch] = (losses, times, torch.cuda.max_memory_allocated())
                del hp, params, opt, m
                one = dataclasses.replace(pp_plan(cfg, "gpipe", 1, mesh=False), grad_accum=1)
                hp = construct_hybrid_parallel_model(build_model(cfg), one)
                loss, _, grads = hp.value_and_grad(
                    hp.init_params(gen()), SyntheticDataset(
                        cfg, seq_len=PP_FP32_SEQ, global_batch=PP_BATCH, seed=0).batch(0),
                    torch.float32)
                torch.save({"loss": float(loss), "grads": grads}, tmp / f"fp32_{arch}.pt")
                del hp, loss, grads
                gc.collect()
                torch.cuda.empty_cache()
            (tmp / "payload.tmp").write_text(json.dumps({"go": True}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"pipeline stage {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    log(f"pipeline: the oracle {t_ranks - t_phase:.1f} s beside the stages' start (rank 0 "
        f"ready {ranks[0]['ready']:.1f} s after its process began); each case (init and "
        f"{PP_STEPS} steps) {[round(run['seconds'], 1) for run in ranks[0]['runs'].values()]} "
        f"s; fp32 {ranks[0]['fp32_seconds']:.1f} s; the stages "
        f"{time.perf_counter() - t_ranks:.1f} s after the payload")
    card = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for label, (arch, schedule, v, seq, what) in cases.items():
        cfg = pp_config(arch)
        plan = pp_plan(cfg, schedule, v)
        runs = [rk["runs"][label] for rk in ranks]
        ref_losses, ref_times, ref_peak = oracle[arch]
        losses = runs[0]["losses"]
        require(all(math.isfinite(x) for x in losses), f"pipeline ({label}): losses {losses}")
        require(runs[0]["losses"] == runs[1]["losses"],
                f"pipeline ({label}): the stages report different losses")
        delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
        require(delta <= PAR_LOSS_TOL, f"pipeline ({label}): losses {losses} vs one rank "
                f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
        shapes = pp_shapes(cfg, seq)
        M, S = max(plan.grad_accum, plan.pp), plan.pp
        for run in runs:
            want = pp_launches(cfg, plan, run["stage"])
            for step, got in enumerate(run["launches"]):
                require(got == want, f"pipeline ({label}) stage {run['stage']} step {step}: "
                        f"launches {got}, expected {want}")
            got_shapes = {k: run[k] for k in shapes}
            require(got_shapes == shapes, f"pipeline ({label}) stage {run['stage']}: kernel "
                    f"shapes {got_shapes}, expected {shapes}")
            most = max(run["in_flight"])
            require(most == M if schedule == "gpipe" else most <= S,
                    f"pipeline ({label}) stage {run['stage']}: {most} microbatches in flight")
        peaks = [run["peak"] for run in runs]
        require(sum(peaks) <= card, f"pipeline ({label}): peaks {peaks} past the card")
        log(f"pipeline ({label}) {what}, full width cut to {PP_LAYERS} layers, {PP_BATCH} x "
            f"{seq} a step in {M} microbatches, selective: losses {losses} (one rank "
            f"{ref_losses}, |delta| {delta:.4g}), grad norms {runs[0]['grad_norms']}; step "
            f"times stage 0 {[round(t, 4) for t in runs[0]['times']]} s, stage 1 "
            f"{[round(t, 4) for t in runs[1]['times']]} s ({NO_INTERCONNECT}; one rank "
            f"{[round(t, 4) for t in ref_times]} s, peak {ref_peak / 2**30:.2f} GiB); in "
            f"flight {[max(run['in_flight']) for run in runs]}; boundary bytes a step "
            f"(stage 0, stage 1) {[run['hop'] for run in runs]}; peak memory "
            f"{[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} of "
            f"{card / 2**30:.2f} GiB; launches per step stage 0 "
            f"{ {k: n for k, n in pp_launches(cfg, plan, 0).items() if n} }, stage 1 "
            f"{ {k: n for k, n in pp_launches(cfg, plan, 1).items() if n} }; kernel shapes "
            f"{shapes}; collectives per stage over {PP_STEPS} steps "
            f"{[run['ops'] for run in runs]}")
        out[label] = {k: runs[0]["launches"][-1][k] + runs[1]["launches"][-1][k]
                      for k in runs[0]["launches"][-1]}
    for label in PP_FP32_CASES:
        got = ranks[0]["fp32"][label]
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        log(f"pipeline fp32 ({label}, {PP_LAYERS} layers, {PP_BATCH} x {PP_FP32_SEQ}, "
            f"grad_accum {PP_ACCUM}): loss {got['loss']} vs one rank at grad_accum 1 "
            f"{got['ref_loss']} (relative {rel:.3g}); largest grad error {got['grad_err']:.3g} "
            f"of its leaf's scale ({got['grad_err_leaf']})")
        require(rel <= PAR_FP32_LOSS_RTOL, f"pipeline fp32 ({label}): loss relative {rel}")
        require(got["grad_err"] <= PAR_FP32_GRAD_TOL,
                f"pipeline fp32 ({label}): grad error {got['grad_err']}")
    log(f"pipeline: phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# 29. context parallelism: two ranks of the cp ring sharing the card
# --------------------------------------------------------------------------

#: llama3.2-1b-long (the config that exists for cp) at full width cut to 2
#: layers, 2 sequences of 16 384 tokens a step in 2 microbatches of 1 (each
#: rank 8 192 tokens of each: train_32k's 32 768 would double each rank's
#: fp32 head), 1 step (2 until phase 30 came)
CP_ARCH = "llama3.2-1b-long"
CP_LAYERS, CP_SEQ, CP_BATCH, CP_ACCUM, CP_STEPS = 2, 16384, 2, 2, 1
CP_MESH = ((2, 1, 1), ("cp", "data", "model"))     # launch.mesh.train_mesh_spec(2, cp=2)
CP_FP32_SEQ = 1024             # the fp32 checks: 2 x 1024, one microbatch


def cp_ring_rows(seq: int = CP_SEQ, mb: int = CP_BATCH // CP_ACCUM, cp: int = 2) -> list:
    """(batch, Sq, Sk, causal) of each K1 call of a cp 2 rank's ring over
    microbatches of ``mb`` sequences of ``seq`` tokens (phase 29's by
    default: 8 192 tokens a rank): step 0, causal at the rank's zig-zag
    positions over its shard; a later step non-causal, the whole shard
    against an earlier rank's early chunk (8 192 x 4 096) or the late chunk
    against a later rank's whole shard (4 096 x 8 192)."""
    Sl = seq // cp
    return [(mb, Sl, Sl, True), (mb, Sl, Sl // 2, False), (mb, Sl // 2, Sl, False)]


def cp_plan(cfg, mesh: bool = True, grad_accum: int = CP_ACCUM):
    """Phase 29's plan on ``CP_MESH`` (cp 2, ZeRO-1: states over dp·cp,
    ``selective``), or one rank's (``mesh=False``: the same remat and
    microbatches, the whole sequence)."""
    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy, uniform_plan

    if not mesh:
        return uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                            LayerStrategy(remat="selective"), grad_accum=grad_accum)
    shape, axes = CP_MESH
    strategy = LayerStrategy(cp=shape[0], zero=1, remat="selective")
    return ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=axes, mesh_shape=shape,
                         grad_accum=grad_accum, layer_strategies=[strategy] * cfg.num_layers,
                         default_strategy=strategy)


def cp_launches(plan, layers: int) -> dict:
    """Kernel launches per step of one rank: phase 25's count
    (``par_launches``: K2 twice a layer and again in its recompute, the
    final norm, K2's backward once a norm) with K1 once for each of the
    ring's cp steps, in every layer's forward and again in its recompute
    (the ring's backward is plain torch)."""
    cp = plan.default_strategy.cp
    out = par_launches(plan, layers)
    out["flash_attention_fwd"] *= cp
    return out


def cp_ring_bytes(cfg, plan, seq: int, batch: int, layers=None) -> int:
    """The bytes a rank's ring sends a step: per layer it runs (``layers``,
    all of ``cfg``'s by default) and microbatch its bf16 K and V block once
    in the forward and once in the recompute, then in the backward K and V
    with their fp32 dk / dv, and the dk / dv home (cp = 2: one hop each)."""
    cp = plan.default_strategy.cp
    M = max(plan.grad_accum, plan.pp)
    kv = (batch // M) * (seq // cp) * cfg.num_kv_heads * cfg.resolved_head_dim
    hops = cp - 1
    per = hops * (2 * 2 * kv + 2 * 2 * kv + (2 * 2 * kv + 2 * 4 * kv)) + 2 * 4 * kv
    return M * (cfg.num_layers if layers is None else layers) * per


def cp_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One rank of phase 29 (``chip_smoke.py --cp-rank RANK WORLD DIR``):
    device 0, gloo over a ``FileStore`` in DIR; once DIR/payload.json is
    there (the parent's oracle done), ``CP_STEPS`` bf16 steps of
    ``cp_plan`` (losses, times, launches, the K1 calls' shapes, the ring's
    bytes a step, the collectives by name, peak), then fp32
    ``value_and_grad`` at ``CP_FP32_SEQ`` on the same seed-0 weights, its
    grad shards against the same shards of the parent's one-rank grads;
    writes its record to DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.parallel import context
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    used = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def counted(out, *a, _run=getattr(dist, name), _name=name, **kw):
            used[f"{_name} {out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
            return _run(out, *a, **kw)
        setattr(dist, name, counted)
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    # the shapes of the ring's K1 calls, one per step
    seen = set()
    step_partial = context._flash_partial

    def recorded(impl):
        partial = step_partial(impl)

        def call(q, k, v, causal, pos=None):
            seen.add((q.shape[0], q.shape[1], k.shape[1], bool(causal)))
            return partial(q, k, v, causal, pos)
        return call

    context._flash_partial = recorded
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*CP_MESH, device=dev, backend="gloo")
    hop = mesh.hop("cp")
    cfg = dataclasses.replace(get_config(CP_ARCH), num_layers=CP_LAYERS)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    record = {"ready": time.perf_counter() - T_START}
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    t_run = time.perf_counter()
    ds = SyntheticDataset(cfg, seq_len=CP_SEQ, global_batch=CP_BATCH, seed=0)
    hp = construct_hybrid_parallel_model(build_model(cfg), cp_plan(cfg), mesh)
    params = hp.init_params(gen())
    opt = hp.init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = {"losses": [], "grad_norms": [], "times": [], "launches": [], "ring": []}
    for step in range(CP_STEPS):
        b = ds.batch(step)
        zero_counts(counters)
        hop.bytes.update(sent=0, received=0, host_copies=0)
        dist.barrier()
        t0 = time.perf_counter()
        params, opt, m = hp.train_step(params, opt, b)
        torch.cuda.synchronize()
        run["times"].append(time.perf_counter() - t0)
        run["launches"].append(read_counts(counters))
        run["ring"].append(dict(hop.bytes))
        run["losses"].append(float(m["loss"]))
        run["grad_norms"].append(float(m["grad_norm"]))
    run.update(peak=torch.cuda.max_memory_allocated(), ops=dict(used), index=hop.stage,
               k1=sorted(list(s) for s in seen), seconds=time.perf_counter() - t_run)
    del hp, params, opt, m, b
    gc.collect()
    torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    batch = SyntheticDataset(cfg, seq_len=CP_FP32_SEQ, global_batch=CP_BATCH,
                             seed=0).batch(0)
    ref = torch.load(tmp / "fp32.pt", map_location=dev)
    hp = construct_hybrid_parallel_model(build_model(cfg), cp_plan(cfg, grad_accum=1), mesh)
    loss, _, grads = hp.value_and_grad(hp.init_params(gen()), batch, torch.float32)
    errs = []
    for g, rg, spec in zip(tree_leaves(grads), tree_leaves(hp.group(ref["grads"])),
                           tree_leaves(hp.grad_specs)):
        mine = shd.shard_leaf(rg, spec, mesh)
        errs.append(float((g - mine).abs().max()) / max(float(rg.abs().max()), 1e-30))
    worst = torch.tensor(errs, device=dev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    i = int(worst.argmax())
    run["fp32"] = {"loss": float(loss), "ref_loss": float(ref["loss"]),
                   "grad_err": float(worst[i]),
                   "grad_err_leaf": ".".join(tree_paths(grads)[i][0]),
                   "seconds": time.perf_counter() - t_fp32}
    record["run"] = run
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def cp_phase(torch) -> dict:
    """Phase 29: ``construct_hybrid_parallel_model`` on ``CP_MESH``, two
    ranks of the cp ring sharing the card over gloo (``chip_smoke.py
    --cp-rank``; every hop staged through pinned host buffers), held to one
    rank's full-sequence loss on the same seed-0 weights and batches,
    computed here before the ranks train and freed (``mesh=None`` at the
    same microbatches): bf16 losses within ``PAR_LOSS_TOL``; in fp32 at
    ``CP_FP32_SEQ`` the loss within ``PAR_FP32_LOSS_RTOL`` relative and
    every grad's shards within ``PAR_FP32_GRAD_TOL`` of its leaf's scale,
    against one rank's ``value_and_grad`` at grad_accum 1.  Each rank's
    K1, K2 and K2-backward launches per step are pinned (``cp_launches``),
    the shapes K1 sees are phase 3's ring rows (``cp_ring_rows``), and the
    ring's bytes a step are ``cp_ring_bytes``.  Logs each rank's peak and
    their sum against the card, the step times (labelled: gloo through the
    host, no interconnect) and the collectives called.  Returns both
    ranks' last-step launches summed."""
    import math
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(CP_ARCH), num_layers=CP_LAYERS)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--cp-rank", str(r), "2", str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            ds = SyntheticDataset(cfg, seq_len=CP_SEQ, global_batch=CP_BATCH, seed=0)
            hp = construct_hybrid_parallel_model(build_model(cfg), cp_plan(cfg, mesh=False))
            params = hp.init_params(gen())
            opt = hp.init_opt_state(params)
            torch.cuda.reset_peak_memory_stats()
            ref_losses, ref_times = [], []
            for step in range(CP_STEPS):
                b = ds.batch(step)
                valid = (b["labels"] >= 0).reshape(CP_ACCUM, -1).sum(axis=1)
                require(len(set(valid.tolist())) == 1,
                        f"cp oracle: microbatch token counts {valid.tolist()}")
                t0 = time.perf_counter()
                params, opt, m = hp.train_step(params, opt, b)
                torch.cuda.synchronize()
                ref_times.append(time.perf_counter() - t0)
                ref_losses.append(float(m["loss"]))
            ref_peak = torch.cuda.max_memory_allocated()
            del hp, params, opt, m
            hp = construct_hybrid_parallel_model(build_model(cfg),
                                                 cp_plan(cfg, mesh=False, grad_accum=1))
            loss, _, grads = hp.value_and_grad(
                hp.init_params(gen()), SyntheticDataset(
                    cfg, seq_len=CP_FP32_SEQ, global_batch=CP_BATCH, seed=0).batch(0),
                torch.float32)
            torch.save({"loss": float(loss), "grads": grads}, tmp / "fp32.pt")
            del hp, loss, grads
            gc.collect()
            torch.cuda.empty_cache()
            (tmp / "payload.tmp").write_text(json.dumps({"go": True}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"cp rank {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        runs = [json.loads((tmp / f"rank{r}.json").read_text())["run"] for r in range(2)]
    log(f"context parallel: the oracle {t_ranks - t_phase:.1f} s beside the ranks' start; "
        f"the ranks' runs {[round(run['seconds'], 1) for run in runs]} s, fp32 "
        f"{[round(run['fp32']['seconds'], 1) for run in runs]} s; the ranks "
        f"{time.perf_counter() - t_ranks:.1f} s after the payload")
    card = torch.cuda.get_device_properties(0).total_memory
    plan = cp_plan(cfg)
    losses = runs[0]["losses"]
    require(all(math.isfinite(x) for x in losses), f"context parallel: losses {losses}")
    require(runs[0]["losses"] == runs[1]["losses"],
            "context parallel: the ranks report different losses")
    delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
    require(delta <= PAR_LOSS_TOL, f"context parallel: losses {losses} vs one rank "
            f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
    want = cp_launches(plan, cfg.num_layers)
    ring = cp_ring_bytes(cfg, plan, CP_SEQ, CP_BATCH)
    rows = cp_ring_rows()
    for run in runs:
        for step, (got, hop) in enumerate(zip(run["launches"], run["ring"])):
            require(got == want, f"context parallel rank {run['index']} step {step}: "
                    f"launches {got}, expected {want}")
            require(hop["sent"] == hop["received"] == ring
                    and hop["host_copies"] == 2 * ring,
                    f"context parallel rank {run['index']} step {step}: ring bytes {hop}, "
                    f"expected {ring} each way")
        # step 0 on every rank; rank 0's later step sees rank 1's shard (its
        # late rows), rank 1's sees rank 0's early chunk
        mine = sorted([list(rows[0]), list(rows[2 if run["index"] == 0 else 1])])
        require(run["k1"] == mine, f"context parallel rank {run['index']}: K1 shapes "
                f"(batch, Sq, Sk, causal) {run['k1']}, expected {mine}")
    peaks = [run["peak"] for run in runs]
    require(sum(peaks) <= card, f"context parallel: peaks {peaks} past the card")
    log(f"context parallel {CP_ARCH}, full width cut to {CP_LAYERS} layers, cp 2 on "
        f"{dict(zip(CP_MESH[1], CP_MESH[0]))}, ZeRO-1, selective, {CP_BATCH} x {CP_SEQ} a "
        f"step in {CP_ACCUM} microbatches: losses {losses} (one rank {ref_losses}, |delta| "
        f"{delta:.4g}), grad norms {runs[0]['grad_norms']}; step times rank 0 "
        f"{[round(t, 4) for t in runs[0]['times']]} s, rank 1 "
        f"{[round(t, 4) for t in runs[1]['times']]} s ({NO_INTERCONNECT}; one rank "
        f"{[round(t, 4) for t in ref_times]} s, peak {ref_peak / 2**30:.2f} GiB); ring bytes "
        f"a rank a step {runs[0]['ring'][-1]}; peak memory "
        f"{[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} of "
        f"{card / 2**30:.2f} GiB; launches per rank per step "
        f"{ {k: n for k, n in want.items() if n} }; K1 (batch, Sq, Sk, causal) rank 0 "
        f"{runs[0]['k1']}, rank 1 {runs[1]['k1']}; collectives per rank over {CP_STEPS} "
        f"steps {runs[0]['ops']}")
    got = runs[0]["fp32"]
    rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
    log(f"context parallel fp32 ({CP_LAYERS} layers, {CP_BATCH} x {CP_FP32_SEQ}, grad_accum "
        f"1): loss {got['loss']} vs one rank {got['ref_loss']} (relative {rel:.3g}); largest "
        f"grad error {got['grad_err']:.3g} of its leaf's scale ({got['grad_err_leaf']})")
    require(rel <= PAR_FP32_LOSS_RTOL, f"context parallel fp32: loss relative {rel}")
    require(got["grad_err"] <= PAR_FP32_GRAD_TOL,
            f"context parallel fp32: grad error {got['grad_err']}")
    log(f"context parallel: phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return {k: runs[0]["launches"][-1][k] + runs[1]["launches"][-1][k]
            for k in runs[0]["launches"][-1]}


# --------------------------------------------------------------------------
# 30. pipeline x context parallelism: four ranks sharing the card
# --------------------------------------------------------------------------

#: llama3.2-1b-long at full width cut to 4 layers (2 a stage; interleaved
#: v 2 needs L % 4 == 0), 4 sequences of 8 192 tokens a step in 4
#: microbatches of 1 (each rank a microbatch's zig-zag half, 4 096 tokens:
#: a last-stage rank holds one microbatch's fp32 head at that length, and
#: two of them share the card with two first-stage ranks), 2 steps a case
PPCP_LAYERS, PPCP_SEQ, PPCP_BATCH, PPCP_ACCUM, PPCP_STEPS = 4, 8192, 4, 4, 2
#: launch.mesh.train_mesh_spec(4, pp=2, cp=2)
PPCP_MESH = ((2, 2, 1, 1), ("pod", "cp", "data", "model"))
PPCP_FP32_SEQ = 512            # the fp32 check of case (e): 4 x 512, grad_accum 4


def ppcp_cases() -> dict:
    """label -> (schedule, interleave, what): (e) 1f1b in two windows of 2,
    (f) interleaved v 2 (stage 0 holds layers 0 and 2); both ZeRO-1 (states
    over dp·cp) and ``selective``."""
    return {"e": ("1f1b", 1, "1f1b (2 windows of 2)"),
            "f": ("interleaved", 2, "interleaved v 2 (stage 0: layers 0 and 2)")}


def ppcp_config():
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(CP_ARCH), num_layers=PPCP_LAYERS)


def ppcp_plan(cfg, schedule: str, interleave: int):
    """A phase 30 plan on ``PPCP_MESH``: pp 2 under ``schedule``, cp 2,
    ZeRO-1, ``selective``, grad_accum ``PPCP_ACCUM``."""
    from repro_torch.core.strategy import ExecutionPlan, LayerStrategy

    shape, axes = PPCP_MESH
    strategy = LayerStrategy(cp=shape[1], zero=1, remat="selective")
    return ExecutionPlan(arch=cfg.name, shape="train", mesh_axes=axes, mesh_shape=shape,
                         pp=shape[0], pp_schedule=schedule, pp_interleave=interleave,
                         grad_accum=PPCP_ACCUM, layer_strategies=[strategy] * cfg.num_layers,
                         default_strategy=strategy)


def ppcp_launches(cfg, plan, stage: int) -> dict:
    """Kernel launches per step of one rank: its stage's (``pp_launches``:
    its layers' K2 twice and again in the recompute, K2's backward, the
    final norm on the last stage, each microbatch) with K1 once for each
    of the ring's cp steps, in the forward and again in the recompute."""
    out = pp_launches(cfg, plan, stage)
    out["flash_attention_fwd"] *= plan.default_strategy.cp
    return out


def ppcp_boundary_bytes(cfg, plan) -> tuple[int, int]:
    """(the cost model's bytes of one microbatch's boundary block a rank,
    the bytes a rank's stage hop sends a step, and receives): each
    microbatch crosses S·v - 1 chunk boundaries forward and as many back,
    each a send on one stage, shared evenly by the S stages (S = 2: a
    rank sends and receives one block a microbatch under 1f1b, three
    under interleaved v 2)."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.cluster import H100_NODE8
    from repro_torch.core.profiler_model import profile_model

    S = plan.pp
    v = plan.pp_interleave if plan.pp_schedule == "interleaved" else 1
    M = max(plan.grad_accum, S)
    devices = math.prod(plan.mesh_shape) // S
    env = cm.CostEnv(cluster=H100_NODE8, devices=devices, pp=S, micro_batch=PPCP_BATCH // M,
                     grad_accum=M, pp_schedule=plan.pp_schedule, pp_interleave=v)
    block = int(cm.pipeline_boundary_bytes(profile_model(cfg, PPCP_SEQ), env,
                                           plan.default_strategy))
    return block, block * M * 2 * (S * v - 1) // S


def ppcp_rank(rank: int, world: int, tmp: pathlib.Path) -> None:
    """One rank of phase 30 (``chip_smoke.py --ppcp-rank RANK WORLD DIR``):
    device 0, gloo over a ``FileStore`` in DIR; once DIR/payload.json is
    there (the parent's oracle done), each case of ``ppcp_cases`` trained
    ``PPCP_STEPS`` steps through ``PipelineTrainer`` (losses, times,
    launches, the K1 calls' shapes, ``max_in_flight``, the stage hop's and
    the ring's bytes a step, the collectives by name, peak); then case (e)
    in fp32 at ``PPCP_FP32_SEQ``: ``value_and_grad`` on the same seed-0
    weights, its grad shards against the same shards of the parent's
    one-rank grads; writes its record to DIR."""
    import collections

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_paths
    from repro_torch.parallel import context
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train_pp import PipelineTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    used = collections.Counter()
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def counted(out, *a, _run=getattr(dist, name), _name=name, **kw):
            used[f"{_name} {out.device.type} {str(out.dtype).split('.')[-1]}"] += 1
            return _run(out, *a, **kw)
        setattr(dist, name, counted)
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    seen = set()                 # the shapes of the ring's K1 calls
    step_partial = context._flash_partial

    def recorded(impl):
        partial = step_partial(impl)

        def call(q, k, v, causal, pos=None):
            seen.add((q.shape[0], q.shape[1], k.shape[1], bool(causal)))
            return partial(q, k, v, causal, pos)
        return call

    context._flash_partial = recorded
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*PPCP_MESH, device=dev, backend="gloo")
    ring = mesh.hop("cp")
    cfg = ppcp_config()
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    record = {"runs": {}, "ready": time.perf_counter() - T_START, "index": ring.stage}
    while not (tmp / "payload.json").is_file():     # the parent's oracle runs meanwhile
        time.sleep(0.05)
    for label, (schedule, v, _) in ppcp_cases().items():
        t_case = time.perf_counter()
        ds = SyntheticDataset(cfg, seq_len=PPCP_SEQ, global_batch=PPCP_BATCH, seed=0)
        tr = PipelineTrainer(build_model(cfg), ppcp_plan(cfg, schedule, v), mesh)
        params = tr.init_params(gen())
        opt = tr.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        used.clear()
        seen.clear()
        run = {"losses": [], "grad_norms": [], "times": [], "launches": [], "in_flight": [],
               "hop": [], "ring": []}
        for step in range(PPCP_STEPS):
            b = ds.batch(step)
            zero_counts(counters)
            for hop in (tr.hop, ring):
                hop.bytes.update(sent=0, received=0, host_copies=0)
            dist.barrier()
            t0 = time.perf_counter()
            params, opt, m = tr.train_step(params, opt, b)
            torch.cuda.synchronize()
            run["times"].append(time.perf_counter() - t0)
            run["launches"].append(read_counts(counters))
            run["hop"].append(dict(tr.hop.bytes))
            run["ring"].append(dict(ring.bytes))
            run["losses"].append(float(m["loss"]))
            run["grad_norms"].append(float(m["grad_norm"]))
            run["in_flight"].append(tr.max_in_flight)
        run.update(peak=torch.cuda.max_memory_allocated(), ops=dict(used), stage=tr.stage,
                   k1=sorted(list(x) for x in seen), seconds=time.perf_counter() - t_case)
        record["runs"][label] = run
        del tr, params, opt, m, b
        gc.collect()
        torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    batch = SyntheticDataset(cfg, seq_len=PPCP_FP32_SEQ, global_batch=PPCP_BATCH,
                             seed=0).batch(0)
    ref = torch.load(tmp / "fp32.pt", map_location=dev)
    schedule, v, _ = ppcp_cases()["e"]
    tr = PipelineTrainer(build_model(cfg), ppcp_plan(cfg, schedule, v), mesh)
    loss, _, grads = tr.value_and_grad(tr.init_params(gen()), batch, torch.float32)
    errs = []
    for g, rg, spec in zip(tree_leaves(grads), tree_leaves(tr.group(ref["grads"])),
                           tree_leaves(tr.grad_specs)):
        mine = shd.shard_leaf(rg, spec, mesh)
        errs.append(float((g - mine).abs().max()) / max(float(rg.abs().max()), 1e-30))
    worst = torch.tensor(errs, device=dev)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    i = int(worst.argmax())
    record["fp32"] = {"loss": float(loss), "ref_loss": float(ref["loss"]),
                      "grad_err": float(worst[i]),
                      "grad_err_leaf": ".".join(tree_paths(grads)[i][0]),
                      "seconds": time.perf_counter() - t_fp32}
    (tmp / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def ppcp_phase(torch) -> dict:
    """Phase 30: ``PipelineTrainer`` on ``PPCP_MESH``, four ranks sharing the
    card over gloo (``chip_smoke.py --ppcp-rank``; every hop staged through
    pinned host buffers), two stages each running the cp ring, held to one
    rank's full-batch loss on the same seed-0 weights and batches, computed
    here before the ranks train and freed (``mesh=None`` at the same 4
    microbatches): bf16 losses within ``PAR_LOSS_TOL``; case (e) in fp32 at
    ``PPCP_FP32_SEQ`` the loss within ``PAR_FP32_LOSS_RTOL`` relative and
    every grad's shards within ``PAR_FP32_GRAD_TOL`` of its leaf's scale,
    against one rank's ``value_and_grad`` at grad_accum 1.  Each rank's K1,
    K2 and K2-backward launches per step are pinned (``ppcp_launches``),
    the shapes K1 sees are phase 3's ``pipeline_context`` rows, the most
    microbatches in flight is at most S, the ring's bytes a step are
    ``cp_ring_bytes`` over the stage's layers, and the stage hop's are the
    cost model's ``pipeline_boundary_bytes`` (``ppcp_boundary_bytes``).
    Logs each rank's peak and their sum against the card, the step times
    (labelled: gloo through the host, no interconnect) and the collectives
    called.  Returns both cases' last-step launches summed over the ranks."""
    import tempfile

    from repro_torch.core.strategy import LayerStrategy, uniform_plan
    from repro_torch.models import build_model
    from repro_torch.runtime.data import SyntheticDataset
    from repro_torch.runtime.train import construct_hybrid_parallel_model

    t_phase = time.perf_counter()
    cfg = ppcp_config()
    world = math.prod(PPCP_MESH[0])
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    one = lambda ga: uniform_plan(cfg.name, "train", (1,), ("data",), cfg.num_layers,
                                  LayerStrategy(remat="selective"), grad_accum=ga)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--ppcp-rank", str(r), str(world), str(tmp)],
                                  env=dict(os.environ), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        try:
            ds = SyntheticDataset(cfg, seq_len=PPCP_SEQ, global_batch=PPCP_BATCH, seed=0)
            hp = construct_hybrid_parallel_model(build_model(cfg), one(PPCP_ACCUM))
            params = hp.init_params(gen())
            opt = hp.init_opt_state(params)
            torch.cuda.reset_peak_memory_stats()
            ref_losses, ref_times = [], []
            for step in range(PPCP_STEPS):
                b = ds.batch(step)
                valid = (b["labels"] >= 0).reshape(PPCP_ACCUM, -1).sum(axis=1)
                require(len(set(valid.tolist())) == 1,
                        f"pp x cp oracle: microbatch token counts {valid.tolist()}")
                t0 = time.perf_counter()
                params, opt, m = hp.train_step(params, opt, b)
                torch.cuda.synchronize()
                ref_times.append(time.perf_counter() - t0)
                ref_losses.append(float(m["loss"]))
            ref_peak = torch.cuda.max_memory_allocated()
            del hp, params, opt, m
            hp = construct_hybrid_parallel_model(build_model(cfg), one(1))
            loss, _, grads = hp.value_and_grad(
                hp.init_params(gen()), SyntheticDataset(
                    cfg, seq_len=PPCP_FP32_SEQ, global_batch=PPCP_BATCH, seed=0).batch(0),
                torch.float32)
            torch.save({"loss": float(loss), "grads": grads}, tmp / "fp32.pt")
            del hp, loss, grads
            gc.collect()
            torch.cuda.empty_cache()
            (tmp / "payload.tmp").write_text(json.dumps({"go": True}))
            os.replace(tmp / "payload.tmp", tmp / "payload.json")
            t_ranks = time.perf_counter()
            outs = [p.communicate(timeout=PAR_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"pp x cp rank {r} exited {p.returncode}:\n"
                    + "\n".join(out.splitlines()[-40:]))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    log(f"pp x cp: the oracle {t_ranks - t_phase:.1f} s beside the ranks' start (rank 0 ready "
        f"{ranks[0]['ready']:.1f} s after its process began); each case (init and "
        f"{PPCP_STEPS} steps) {[round(run['seconds'], 1) for run in ranks[0]['runs'].values()]}"
        f" s; fp32 {ranks[0]['fp32']['seconds']:.1f} s; the ranks "
        f"{time.perf_counter() - t_ranks:.1f} s after the payload")
    card = torch.cuda.get_device_properties(0).total_memory
    rows = cp_ring_rows(PPCP_SEQ, PPCP_BATCH // PPCP_ACCUM)
    out = {}
    for label, (schedule, v, what) in ppcp_cases().items():
        plan = ppcp_plan(cfg, schedule, v)
        runs = [rk["runs"][label] for rk in ranks]
        losses = runs[0]["losses"]
        require(all(math.isfinite(x) for x in losses), f"pp x cp ({label}): losses {losses}")
        require(all(run["losses"] == losses for run in runs),
                f"pp x cp ({label}): the ranks report different losses")
        delta = max(abs(a - b) for a, b in zip(losses, ref_losses))
        require(delta <= PAR_LOSS_TOL, f"pp x cp ({label}): losses {losses} vs one rank "
                f"{ref_losses} (|delta| {delta:.4g} > {PAR_LOSS_TOL})")
        block, hop_bytes = ppcp_boundary_bytes(cfg, plan)
        ring_bytes = cp_ring_bytes(cfg, plan, PPCP_SEQ, PPCP_BATCH,
                                   layers=cfg.num_layers // plan.pp)
        for rk, run in zip(ranks, runs):
            who = f"pp x cp ({label}) stage {run['stage']} cp {rk['index']}"
            want = ppcp_launches(cfg, plan, run["stage"])
            for step, got in enumerate(run["launches"]):
                require(got == want, f"{who} step {step}: launches {got}, expected {want}")
            for step, (hop, rh) in enumerate(zip(run["hop"], run["ring"])):
                require(hop["sent"] == hop["received"] == hop_bytes
                        and hop["host_copies"] == 2 * hop_bytes,
                        f"{who} step {step}: boundary bytes {hop}, expected {hop_bytes} each "
                        f"way ({block} a microbatch a hop, the cost model's)")
                require(rh["sent"] == rh["received"] == ring_bytes
                        and rh["host_copies"] == 2 * ring_bytes,
                        f"{who} step {step}: ring bytes {rh}, expected {ring_bytes} each way")
            # step 0 on every rank; cp rank 0's later step sees rank 1's shard
            # (its late rows), cp rank 1's sees rank 0's early chunk
            mine = sorted([list(rows[0]), list(rows[2 if rk["index"] == 0 else 1])])
            require(run["k1"] == mine, f"{who}: K1 shapes (batch, Sq, Sk, causal) "
                    f"{run['k1']}, expected {mine}")
            most = max(run["in_flight"])
            require(most <= plan.pp, f"{who}: {most} microbatches in flight")
        peaks = [run["peak"] for run in runs]
        require(sum(peaks) <= card, f"pp x cp ({label}): peaks {peaks} past the card")
        M = max(plan.grad_accum, plan.pp)
        log(f"pp x cp ({label}) {CP_ARCH}, {what}, full width cut to {PPCP_LAYERS} layers, pp "
            f"2 x cp 2 on {dict(zip(PPCP_MESH[1], PPCP_MESH[0]))}, ZeRO-1, selective, "
            f"{PPCP_BATCH} x {PPCP_SEQ} a step in {M} microbatches: losses {losses} (one rank "
            f"{ref_losses}, |delta| {delta:.4g}), grad norms {runs[0]['grad_norms']}; step "
            f"times by rank {[[round(t, 4) for t in run['times']] for run in runs]} s "
            f"({NO_INTERCONNECT}; one rank {[round(t, 4) for t in ref_times]} s, peak "
            f"{ref_peak / 2**30:.2f} GiB); in flight {[max(run['in_flight']) for run in runs]}; "
            f"boundary bytes a rank a step {runs[0]['hop'][-1]} (the cost model's block "
            f"{block} x {M} microbatches x {hop_bytes // (block * M)} hops each way); ring "
            f"bytes a rank a step {runs[0]['ring'][-1]}; peak memory by rank "
            f"{[round(x / 2**30, 2) for x in peaks]} GiB, sum {sum(peaks) / 2**30:.2f} of "
            f"{card / 2**30:.2f} GiB; launches per step stage 0 "
            f"{ {k: n for k, n in ppcp_launches(cfg, plan, 0).items() if n} }, stage 1 "
            f"{ {k: n for k, n in ppcp_launches(cfg, plan, 1).items() if n} }; K1 (batch, Sq, "
            f"Sk, causal) by rank {[run['k1'] for run in runs]}; collectives by rank over "
            f"{PPCP_STEPS} steps {[run['ops'] for run in runs]}")
        out[label] = {k: sum(run["launches"][-1][k] for run in runs)
                      for k in runs[0]["launches"][-1]}
    got = ranks[0]["fp32"]
    rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
    log(f"pp x cp fp32 (e, {PPCP_LAYERS} layers, {PPCP_BATCH} x {PPCP_FP32_SEQ}, grad_accum "
        f"{PPCP_ACCUM}): loss {got['loss']} vs one rank at grad_accum 1 {got['ref_loss']} "
        f"(relative {rel:.3g}); largest grad error {got['grad_err']:.3g} of its leaf's scale "
        f"({got['grad_err_leaf']})")
    require(all(rk["fp32"]["loss"] == got["loss"] for rk in ranks),
            "pp x cp fp32: the ranks report different losses")
    require(rel <= PAR_FP32_LOSS_RTOL, f"pp x cp fp32: loss relative {rel}")
    require(got["grad_err"] <= PAR_FP32_GRAD_TOL, f"pp x cp fp32: grad error {got['grad_err']}")
    log(f"pp x cp: phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return {k: out["e"][k] + out["f"][k] for k in out["e"]}


# ---------------------------------------------------------------- phase 31

CKPT_LAYERS = 2
CKPT_SEQ, CKPT_BATCH, CKPT_ACCUM = 4096, 4, 2
#: the steps of the phase: (a) 3, (b) 3, the restored trainer's step 3
CKPT_STEPS = 7


def _file_digests(directory: pathlib.Path) -> dict:
    """{relative path: SHA-256 of its bytes} of every file under
    ``directory``, read by 8 threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    files = [f for f in sorted(directory.rglob("*")) if f.is_file()]

    def digest(f):
        with open(f, "rb") as fh:
            return hashlib.file_digest(fh, "sha256").hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip((str(f.relative_to(directory)) for f in files), pool.map(digest, files)))


def checkpoint_phase(torch, counters) -> dict:
    """Phase 31 (see the module note): (a) 3 donated steps straight; (b) 2
    steps, (c) a sync ``save`` of step 2, an async save of it with step 3
    run in place while the writer works, and a fresh trainer's restore of
    step 2 and its step 3; both step 3s bitwise (a)'s, (c)'s files
    byte-identical to (b)'s, async blocking below the sync save.  Returns
    the phase's launches."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.data import SyntheticDataset

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=CKPT_LAYERS)
    plan = dataclasses.replace(_uniform_plan(cfg, "selective"), grad_accum=CKPT_ACCUM)
    ds = SyntheticDataset(cfg, seq_len=CKPT_SEQ, global_batch=CKPT_BATCH, seed=0)
    batches = [ds.batch(i) for i in range(3)]
    flat = lambda p, o: ckpt._flatten((p, o))

    def steps(hp, params, opt, which):
        for i in which:
            params, opt, metrics = hp.train_step(params, opt, batches[i], donate=True)
        torch.cuda.synchronize()
        return params, opt, metrics

    def bitwise(label, loss, state, want_loss, want):
        differ = [k for k in want if not torch.equal(state[k], want[k])]
        log(f"checkpoint: {label} step 3 loss {float(loss)!r} vs (a) {float(want_loss)!r}; "
            f"{len(want) - len(differ)} of {len(want)} leaves bitwise (a)'s"
            + (f"; differing: {differ[:8]}" if differ else ""))
        require(torch.equal(loss, want_loss) and not differ,
                f"checkpoint: {label} step 3 is not bitwise the uninterrupted run's")

    zero_counts(counters)
    # (a) the uninterrupted run
    hp, params = _train_bundle(torch, cfg, plan)
    params, opt, metrics = steps(hp, params, hp.init_opt_state(params), range(3))
    want_loss, want = metrics["loss"], flat(params, opt)
    nbytes = sum(x.numel() * x.element_size() for x in want.values())
    del hp, params, opt, metrics

    root = pathlib.Path(tempfile.mkdtemp(prefix="ckpt-phase-"))
    free = shutil.disk_usage(root).free
    log(f"checkpoint: canonical state {len(want)} leaves, {nbytes / 1e9:.3f} GB; "
        f"{free / 1e9:.1f} GB free under {root}; (a) took {time.perf_counter() - t_phase:.1f} s")
    require(free > 3 * nbytes, f"checkpoint: {free} bytes free under {root}, the two "
            f"directories need {2 * nbytes}")
    try:
        # (b) 2 steps; (c) the sync save of step 2; the async save, step 3 in place
        hp, params = _train_bundle(torch, cfg, plan)
        params, opt, _ = steps(hp, params, hp.init_opt_state(params), range(2))
        t0 = time.perf_counter()
        ckpt.save(root / "sync", 2, *hp.checkpoint_state(params, opt), plan, codec="raw")
        sync_s = time.perf_counter() - t0
        writer = ckpt.CheckpointWriter()
        t0 = time.perf_counter()
        writer.save_async(root / "async", 2, *hp.checkpoint_state(params, opt), plan,
                          codec="raw")
        params, opt, metrics = hp.train_step(params, opt, batches[2], donate=True)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        writer.close()
        drain_s = time.perf_counter() - t0
        bitwise("(b) in place", metrics["loss"], flat(params, opt), want_loss, want)
        del hp, params, opt, metrics
        written = sum(f.stat().st_size for f in (root / "async").rglob("*") if f.is_file())
        log(f"checkpoint: sync save {sync_s:.3f} s for {written} bytes "
            f"({written / sync_s / 1e9:.3f} GB/s); async blocked {writer.blocked_seconds:.3f} s, "
            f"step 3 done {step_s:.3f} s and the writer drained {drain_s:.3f} s after "
            f"save_async")
        require(writer.blocked_seconds < sync_s, f"checkpoint: async blocked "
                f"{writer.blocked_seconds} s, not below the sync save's {sync_s} s")
        t0 = time.perf_counter()
        files = _file_digests(root / "sync")
        require(files == _file_digests(root / "async"),
                "checkpoint: the sync and async directories differ")
        log(f"checkpoint: (c)'s {len(files)} files byte-identical to (b)'s (compared in "
            f"{time.perf_counter() - t0:.1f} s)")

        # a fresh model and trainer restore (b)'s step 2 and run step 3
        hp, params = _train_bundle(torch, cfg, plan, seed=1)
        opt = hp.init_opt_state(params)
        t0 = time.perf_counter()
        out = ckpt.restore(root / "async", 2, **dict(zip(("params_like", "opt_like"),
                                                          hp.checkpoint_state(params, opt))))
        del params, opt
        params, opt = hp.place_params(out["params"]), hp.place_opt_state(out["opt"])
        del out
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        params, opt, metrics = steps(hp, params, opt, [2])
        bitwise("restored", metrics["loss"], flat(params, opt), want_loss, want)
        log(f"checkpoint: restore {restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s)")
        del hp, params, opt, metrics
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = read_counts(counters)
    expected = {k: n * CKPT_STEPS
                for k, n in train_launches(CKPT_LAYERS, "selective", CKPT_ACCUM).items()}
    require(launches == expected, f"checkpoint launched {launches}, expected {expected}")
    log(f"checkpoint: phase 31 took {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: n for k, n in launches.items() if n} } over {CKPT_STEPS} steps")
    return launches


def main() -> int:
    # growable segments, for every phase: moonshot's training (phase 14)
    # runs out of memory without them, asking for its 5 GiB of fp32 logits
    # in the first backward with 38.8 GiB allocated and 35.1 GiB cached in
    # split segments; the phases before it leave 64 MiB allocated (two
    # 32 MiB workspaces), so the fragments are the training step's own
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs one CUDA GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import serving
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    mark("2")
    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    report = _build.BUILD_DIR / "build.log"
    if report.is_file():        # absent when an earlier call built the library
        lines, k2_spills = build_report(report.read_text())
        for line in lines:
            log("  " + line)
        require(not k2_spills, f"a K2 kernel spills registers: {k2_spills}")

    mark("3")
    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = check_flash(torch, flash_ops, flash_ref, gen)
    check_flash_autograd(torch, flash_ops, flash_ref, gen)
    rms_rows = check_rmsnorm(torch, rms_ops, rms_ref, gen)
    gated_rows = check_rmsnorm_gated(torch, rms_ops, rms_ref, gen)
    bwd_rows = check_rmsnorm_backward(torch, rms_ops, rms_ref, gen)
    split_rows = check_rmsnorm_split(torch, rms_ops, rms_ref, gen)
    ssd_rows = check_ssd(torch, ssd_ops, ssd_ref, gen)
    ssd_grad_rows = check_ssd_autograd(torch, ssd_ops, ssd_ref, gen)

    mark("4")
    # 4. the llama path at full width
    counters = launch_counters(flash_ops, rms_ops, ssd_ops)
    session, eager_session, prompts, llama_launches = serve_full_width(torch, np, serving,
                                                                       counters)
    profile_decode(torch, np, serving, session)
    profile_decode(torch, np, serving, eager_session)
    del eager_session

    mark("5")
    # 5. llama kernel path against plain path
    parity(torch, np, serving, build_model, session, prompts)
    del session
    torch.cuda.empty_cache()

    mark("6-9")
    # 6-9. the mamba2 and zamba2 paths at full width through the step
    # engine, each followed by its kernel path against its plain path
    static_launches = {}
    for arch, small_cfg in (
            ("mamba2-2.7b", get_config("mamba2-2.7b").reduced()),
            # a remainder: 3 sites of the shared block, then 1 trailing layer
            ("zamba2-7b", dataclasses.replace(get_config("zamba2-7b").reduced(), num_layers=7))):
        engine, params, s_prompts, launches, eager = serve_step_engine(
            torch, np, serving, build_model, get_config, counters, arch)
        static_launches[arch.split("-")[0]] = launches
        profile_step_engine(torch, engine, params, s_prompts)
        # 6b. mamba2's decode steps graphed; 8b. zamba2's prefill and decode
        graphed_serve(torch, engine, params, s_prompts, None, STATIC_NEW, eager, counters,
                      prefill_graph=arch == "zamba2-7b")
        parity_step_engine(torch, np, serving, build_model, small_cfg, engine, params, s_prompts)
        if arch == "mamba2-2.7b":                   # 7b. K3 inside a prefill graph
            graphed_prefill_check(torch, np, serving, build_model, small_cfg, counters)
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()

    mark("10")
    # 10. the dense training step at full width
    train_launches, selective = train_phase(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()

    mark("11")
    # 11. the planner: profile, calibrate, search, train the plan, the launcher
    planner_phase(torch, counters, selective)
    gc.collect()
    torch.cuda.empty_cache()

    mark("12-13")
    # 12-13. the MoE family: moonshot served at full width and depth, its parity
    moe_launches = moe_serve_phase(torch, np, serving, build_model, get_config, counters)
    allocator_report(torch, "the moonshot serve and parity phases")

    mark("14")
    # 14. moonshot trained at full width, cut to 2 layers
    moe_train_launches = moe_train_phase(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()

    mark("23")
    # 23. the planner for the MoE family: profile (graphs), calibrate,
    # search, check, train the plan, the launcher's refusal
    moe_planner_phase(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()

    mark("15-16")
    # 15-16. the encoder-decoder: whisper served at full width and depth with
    # real frames, profiled, and its kernel path against its plain path
    engine, w_params, w_frames, w_prompts, whisper_serve_launches, eager = whisper_serve_phase(
        torch, np, serving, build_model, get_config, counters)
    profile_step_engine(torch, engine, w_params, w_prompts, extras={"frames": w_frames})
    # 15b. the same traffic through the compiled prefill (the encoder inside)
    # and decode steps
    graphed_serve(torch, engine, w_params, w_prompts, {"frames": w_frames}, WHISPER_NEW, eager,
                  counters, prefill_graph=True)
    parity_whisper(torch, serving, build_model, engine, w_params, w_frames, w_prompts)
    del engine, w_params, w_frames
    gc.collect()
    torch.cuda.empty_cache()

    mark("17")
    # 17. whisper trained at full width and depth
    whisper_train_launches = whisper_train_phase(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()

    mark("18-19")
    # 18-19. the VLM: internvl2 served at full width and depth with an image
    # prefix, profiled, and its kernel path against its plain path at 4 layers
    engine, v_params, v_vis, v_prompts, vlm_launches, eager = vlm_serve_phase(
        torch, np, serving, build_model, get_config, counters)
    profile_step_engine(torch, engine, v_params, v_prompts, extras={"vis_embeds": v_vis},
                        prefix=VLM_PREFIX)
    # 18b. the same traffic through the compiled prefill and decode steps
    graphed_serve(torch, engine, v_params, v_prompts, {"vis_embeds": v_vis}, VLM_NEW, eager,
                  counters, prefix=VLM_PREFIX, prefill_graph=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    parity_vlm(torch, serving, build_model, engine, v_params, v_vis, v_prompts)
    del engine, v_params, v_vis
    gc.collect()
    torch.cuda.empty_cache()

    mark("20")
    # 20. internvl2 trained at full width, cut to 2 layers
    vlm_train_launches = vlm_train_phase(torch, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # 21. mamba2 trained at full width, cut to 16 layers, through K3 under autograd
    mark("21")
    mamba2_train_launches = ssm_train_phase(torch, counters, "mamba2-2.7b", "selective",
                                            layers=MAMBA2_TRAIN_LAYERS,
                                            profile=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("22")
    # 22. zamba2 trained at full width, cut to 13 layers
    zamba2_train_launches = ssm_train_phase(torch, counters, "zamba2-7b", "none",
                                            layers=ZAMBA2_TRAIN_LAYERS)

    mark("25")
    # 25. the parallel runtime: two ranks sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    par = parallel_phase(torch)
    par_launches = {"parallel_tp2": par["a"], "parallel_dp2": par["b"],
                    "parallel": {k: sum(run[k] for run in par.values()) for k in par["a"]}}

    mark("26")
    # 26. the MoE family on a mesh: two ranks sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    mpar = moe_parallel_phase(torch)
    par_launches.update({"moe_parallel_tp2": mpar["b"], "moe_parallel_b1": {
        k: mpar["a"][k] + mpar["c"][k] for k in mpar["a"]}})

    mark("27")
    # 27. tensor parallelism in the SSM, hybrid and audio families: two ranks
    # sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    spar = ssm_parallel_phase(torch)
    for label, n in spar.items():     # a row of the split K2 counts both its passes
        par_launches[f"ssm_parallel_{label}"] = {
            **n, "rmsnorm_split_fwd": n["rmsnorm_split_sumsq"] + n["rmsnorm_split"],
            "rmsnorm_split_bwd": n["rmsnorm_split_dot"] + n["rmsnorm_split_backward"]}

    mark("28")
    # 28. pipeline parallelism: two stages sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    for label, n in pipeline_phase(torch).items():
        par_launches[f"pipeline_{label}"] = n

    mark("29")
    # 29. context parallelism: two ranks of the cp ring sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    par_launches["context_parallel"] = cp_phase(torch)

    mark("30")
    # 30. pipeline x context parallelism: four ranks sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    par_launches["pipeline_context"] = ppcp_phase(torch)

    mark("31")
    # 31. checkpointing: save, async save under a donated step, restore
    gc.collect()
    torch.cuda.empty_cache()
    par_launches["checkpoint"] = checkpoint_phase(torch, counters)

    mark("24")
    # 24. results
    kernels = []
    for rows, name, source, replaces in (
            (flash_rows, "flash_attention_fwd",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:110"),
            (rms_rows, "rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:24"),
            (gated_rows, "rmsnorm_gated", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:24"),
            (bwd_rows, "rmsnorm_bwd", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
             "src/repro/models/norms.py:24"),
            (ssd_rows, "ssd", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/kernel.py:74"),
            (ssd_grad_rows, "ssd_autograd", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/kernel.py:74"),
            ([r for r in split_rows if r["kind"] == "forward"], "rmsnorm_split_fwd",
             "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:24"),
            ([r for r in split_rows if r["kind"] == "backward"], "rmsnorm_split_bwd",
             "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
             "src/repro/models/norms.py:24")):
        for r in rows:
            # a row measured once may stand for several paths (the pipeline's
            # stages see the training rows): one entry each, launches its own
            paths = r["path"] if isinstance(r["path"], tuple) else (r["path"],)
            for path in paths:
                launches = {"llama": llama_launches, "train": train_launches,
                            "moonshot": moe_launches, "moonshot_train": moe_train_launches,
                            "whisper": whisper_serve_launches,
                            "whisper_train": whisper_train_launches, "internvl2": vlm_launches,
                            "internvl2_train": vlm_train_launches,
                            "mamba2_train": mamba2_train_launches,
                            "zamba2_train": zamba2_train_launches, **par_launches,
                            **static_launches}[path]
                label = r["label"] if path == paths[0] else f"{r['label']}, {path}"
                kernels.append({"name": f"{name} [{label}]", "route": "cuda",
                                "source": source, "replaces": replaces,
                                "launches": launches[name], "max_abs_err": r["max_abs_err"],
                                "ms": r["ms"], "plain_ms": r["plain_ms"],
                                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                                "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] == ["--moe-parallel-rank"]:
        moe_parallel_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] == ["--ssm-parallel-rank"]:
        ssm_parallel_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] == ["--pp-rank"]:
        pipeline_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] == ["--cp-rank"]:
        cp_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] == ["--ppcp-rank"]:
        ppcp_rank(int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
