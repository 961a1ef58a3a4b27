"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the port from ``src/`` with nvcc,
   one process per source, in parallel, and print ptxas's register and
   spill report;
3. kernels: each kernel against its plain PyTorch version on the card:
   flash attention on the cases of ``tests/test_kernels.py`` (FLASH_CASES
   and the MLA 48/32 case), on edge cases, on bfloat16 cases of the
   wgmma path (head dims 64, 128, 256 and one no multiple of 8, ragged Sq,
   Sq < Sk, window 1) and at deepseek-v3-671b's MLA prefill (128 heads, key
   head dim 192, value head dim 128, explicit scale; S = 1711 and 128: bits
   on two launches and across a batch of 3, timed beside SDPA as
   dispatched), on float32 cases of the 3xTF32 path (head dims 16
   to 256, one no multiple of 4, walks cut into pieces), on the demo
   model's prefill shapes and at recurrentgemma-9b's head dim 256 (MQA,
   window 2048, float32 and bfloat16), each case logging the path that
   served it and the share of its tolerance used; each path gives the
   same bits on two launches and for a batch row alone as within a batch
   of 3 (bfloat16 at head dim 256, float32 at the demo's heads and at head
   dim 256 with window 2048); the float32 rows also time SDPA's
   memory-efficient backend and the wrapper's host time a call, and print
   the bound on the tensor cores in 3xTF32 beside the one on the CUDA
   cores; the cached-decode attention kernel at the demo's and the
   hybrid's decode shapes and the tests' smoke widths (each case logging
   the share of its tolerance it used, the timed ones their device time a
   call), the same bits on two launches and for a slot alone as within a
   batch of 4; the RG-LRU scan
   at recurrentgemma-9b's prefill and decode shapes and the edges of its
   two kernels (ring and step), every case bit for bit against its plain
   version and logging its path, the same bits on two launches and for a
   batch row alone as within a batch of 4 on each path; WKV6 on the cases
   of ``tests/test_kernels.py`` (WKV_CASES), a ragged T, rwkv6-7b's prefill
   and decode shapes and the edges of its two kernels (chunk and stream),
   each case logging the path that served it; each WKV6 path gives the
   same bits on two launches and for a batch row alone as within a batch
   of 4; the wrapper's host cost a decode call. The flash backward (float32,
   3xTF32) against its plain version on the float32 cases of FLASH_CASES,
   edge cases (MLA head dims, a window with Sq < Sk, Sq > Sk without a mask,
   head dim 128, window 1, Sq and Sk no multiples of the wgmma path's 128-row
   blocks, a walk of one tile, head dims no multiple of 4) and the demo's
   train shape (4, 12, 4096, 64) at BWD_TOL, each case logging the path that
   served it (wgmma or mma.sync) and the share of BWD_TOL used and checking the
   forward's output and logsumexp against their plain versions (the output's
   bits unchanged by asking for the logsumexp); its
   bits equal on two launches and for B = 1 against row 0 of B = 4; at the
   train shape the forward with and without the logsumexp timed, and the
   backward (each launch's device time) against its plain version, SDPA's
   memory-efficient backward, its bound and the tensor-core floor of the seven
   products it runs at the probed TF32 rates. The bfloat16 backward
   (``csrc/flash_attention_bwd_bf16.cu``: wgmma fed by a TMA ring, whose walk
   kernels, up to head dim 128 and in the split builds above it, the build
   phase holds to no spills and no wgmma serialized in ptxas's report) against
   its plain version on the
   cases of ``tests/test_torch_flash_bwd_bf16.py``, edges, qwen3-1.7b's
   train shape (2, 16, 4096, 128) and granite-moe-3b-a800m's (1, 24, 4096, 64:
   GQA group 3) at BWD_BF16_TOL of each gradient's largest
   entry, each case holding the bfloat16 forward's logsumexp against the plain
   one and its output bits unchanged by asking for it; its bits equal on two
   launches and for B = 1 against row 0 of B = 4 at groups 2 and 3; at both train
   shapes its time (and the forward's, with and without the logsumexp) against
   its plain version, SDPA's flash-backend backward and its bound, and
   its error against float64 at most twice SDPA's; the float32 backward at
   head dim 128 timed at that shape. The bfloat16 backward at head dim 256 (the
   split builds: each key tile's dK/dV walk cut into the parts of
   ``flash_attention.bwd_split_plan``, their partials summed in order by a
   reduction kernel; S and dP computed once a tile) on recurrentgemma-9b's
   train shape (1, 16, 4096, 256) with MQA and window 2048 and on edges (Dv 256
   and 128, ragged Sq and Sk, Sq < Sk, a window crossing tile edges, groups 16,
   3 and 1, Sq = 1, chunks wholly past D or Dv, parts cut unevenly or empty),
   with the forward's logsumexp at 256 held against the plain one; its bits on
   two launches and for B = 1 against row 0 of B = 4; the dK/dV grid (blocks,
   parts, the busiest SM's walk tiles in the planner's model); its time and
   each launch's beside the earlier split builds', its plain version's, SDPA's
   backward with the window as a mask and the bound, and the float64
   yardstick. At deepseek-v3-671b's train shape (1, 128, 4096, 192/128, a group
   of 1, explicit scale) the forward with the logsumexp and the bf16 backward's
   split build <4, 2> at one part a key tile, and an edge at the MTP layer's
   ragged 4,094 rows, against the plain versions (the backward also against
   ``ref.flash_attention_bwd_split_ref``); bits on two launches and for B = 1
   against row 0 of B = 2; each launch's device time, the split plain version's
   time, SDPA's as dispatched for Dv != D, the bounds, the split design's floors,
   the dS^T scratch's bytes, the float64 yardstick. The RG-LRU backward
   (``csrc/rglru_bwd.cu``) against ``ref.rglru_bwd_ref`` bit for bit at the
   hybrid's train shape (1, 4096, 4096) in bf16 and f32, with and without h0,
   at T = 1 and 32, ragged W, and the a = 1 edge; its bits on two launches and
   for a row alone as within a batch of 4; its time beside its bound. The WKV6
   backward (``csrc/wkv6_bwd.cu``) against ``ref.wkv6_bwd_ref`` at TOL of each
   gradient's largest entry: rwkv6-7b's train shape (1, 64, 4096, 64) in
   bfloat16 with and without h0 and dS_T, the float32 cases of WKV_CASES, T =
   17, and log w in U(-4, -3.9), where every entry is finite and autodiff
   through the plain chunked form is not; its bits on two launches and for B =
   1 against row 0 of B = 4; at the train shape its time beside its plain
   version's and the bound; on every float32 case its error against float64
   autograd through ``ref.wkv6_ref`` at most twice the plain version's. The
   dense family's and granite-moe's prefill and decode
   shapes are among the flash and decode-attention cases, and so are the
   prefill and decode shapes of seamless-m4t-large-v2's decoder and
   internvl2-2b, each timed. The bfloat16 flash forward without a mask at
   seamless-m4t-large-v2's encoder (4, 16, 4096, 64), its decode step's
   cross-attention (one query row against 4,096 keys) and a ragged prefill's
   (37 rows against 1,000): bits on two launches and for batch row 0 alone,
   timed beside SDPA as dispatched; edges at Sq != Sk (1 against 333, 100
   against 40); each of these held within SCALED_RTOL |want| + TOL times the
   output's RMS, and each shown to fail a planted fault (a dropped last key
   tile, padding keys folded into the softmax). The bfloat16 backward without
   a mask at head dim 64, group 1: seamless-m4t-large-v2's encoder and
   cross-attention at its train shape (1, 16, 4096, 64) and the cross-attention
   of the encdec train phase's ragged steps (1,000 rows against 4,000 keys,
   4,000 against 1,000, 37 against 1,000 at B = 2), on the forward's output in
   float32 as training passes it: dQ, dK and dV against float64 autograd of
   dense attention on the card within 2^-7 |want| + 2^-5 times the
   gradient's RMS and a lean of 2^-10, each row shown to fail planted faults (a dropped
   last key tile, padding keys folded in, the last query tile dropped from dK
   and dV), bits on two launches, timed by part beside SDPA's backward as
   dispatched; the forward with the logsumexp and the float32 output at the
   train shape (its float32 output rounding to its bfloat16 one bit for bit).
   Every bfloat16 backward case is also run on the plain forward's float32
   output. Each timed case prints the kernel's time, its plain version's, one
   PyTorch library call's where one computes the same function, and the least
   time the card could take;
4. demo: ``serpytor-demo-100m`` at full width and depth serves 8 requests
   through ``ContinuousBatcher(slots=4, max_len=1536)``; tokens equal
   sequential greedy decoding, the flash kernel ran in every prefill
   layer and the decode-attention kernel in every layer of every decode
   step, and prefill logits agree with the port's CPU path within 1e-4;
4b. gateway: the same model, params and prompts through the Gateway / HTTP
   worker route (``repro_torch.launch.gateway_serve``: two ``WorkerServer``s
   on 127.0.0.1 sharing the one param tree, their ``WorkerClient``s, a
   ``Gateway`` with context-affinity allocation; each request a batch-1
   greedy ``generate`` task): round 1 submits all 8 requests at once, their
   tokens equal the demo phase's sequential ones, the flash kernel launched
   8 layers x 8 prefills times and the decode-attention kernel 8 x 8 x 32,
   both workers served; then r0 alone through the same route (the cost of
   one generation with nothing beside it); both heartbeats report the card;
   the HTTP bodies of one ``generate`` through w0's ``run_task``; every
   round logs the process's cores busy;
   round 2 crashes w1's application (its heartbeat answers, its app does
   not) and w0 serves 4 more requests with the same tokens. Logs tok/s
   beside the batcher's, each request's latency, the gateway's allocation
   µs and per-worker stats and the heartbeat probe;
5. train, in a process of its own (this file run with ``--train``, which
   sets ``CUBLAS_WORKSPACE_CONFIG`` before importing torch; the other phases
   run without it): the same model at full width and depth takes 3 AdamW
   steps (``make_train_step``: forward, loss, backward, clip, AdamW as
   ``examples/train_lm.py`` sets it) on ``TokenSource(seed=0)`` batches of
   4 x 4096 tokens under ``torch.use_deterministic_algorithms(True)``; every layer
   ran the flash forward and backward kernels (24 launches each); step 0 run
   again from the same state gives the same ``payload_digest`` of metrics,
   params and AdamW state; step 0 with ``attn_impl="ref"`` (plain attention
   and autograd) agrees in loss, grad norm and every gradient leaf within
   TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL and TRAIN_GRAD_TOL; step ms, tokens/s,
   peak memory, and a profiled step's device time by kind and busy share;
   the AdamW is the train CLI's for 3 steps (``repro_torch.launch.train.opt_config``);
5b. durable train, through the train CLI in processes of their own (``python -m
   repro_torch.launch.train --arch serpytor-demo-100m --full --layers 2 --batch 4
   --seq 4096 --steps 3 --checkpoint-every 2``: the demo's full width at 2 of its 8
   layers, DEMO_CUT_LAYERS): run A journals rounds [0, 2) and [2, 3) with
   checkpoints ``step00000002`` and ``step00000003``, its heartbeat polled once
   while it runs; each step's journaled metrics digest equals that of a direct step
   at the same depth, which the train phase runs after its own, and the process ran
   6 flash forward and 6 backward launches. Then the crash between the two halves of the last
   checkpoint (``step00000003-opt`` deleted), and run B, the same command: it
   recovers from ``step00000002`` on the card, re-executes step 2 through the
   out-of-place verify twin against the journal, re-saves ``step00000003`` with
   A's content digests, reports 1 step and 2 + 2 flash launches. Logs the steps'
   ms through the trainer against the direct steps', each checkpoint save's
   seconds (params sync, ``-opt`` async), the restore's, the journal's size and
   the heartbeat's report. Checkpoint shards are raw frames (the npz after a 0x00 tag);
5c. distributed train, in a process of its own (this file run with
   ``--distributed``, set up as ``--train``): ``DistributedTrainer`` trains the
   demo at 2 layers data-parallel through a ``ClusterExecutor`` over a ``Gateway`` of 2
   in-process workers of capacity 1, 4 ``grad_shard`` tasks of 2 x 4096 tokens a
   step, 2 steps and one checkpoint pair (run A); then the same with w0 a
   ``FlakyWorker`` that dies at its second task start (run B). B ends at A's
   checkpoint digest with every ``grad@s#k`` and ``apply@s`` digest equal and a
   ``NODE_REQUEUE`` journaled; each run launched the flash forward and backward
   2 layers x its ``grad_shard`` runs times (4 a step, one more for each shard w0
   had started when it was evicted); no journal record holds an array; torch's CPU
   and CUDA RNG states are unchanged by a run. Step 0 computed directly on one
   thread (each shard's task in order, the mean, AdamW) gives A's ``grad@0#k``
   and ``apply@0`` digests. Logs each step's seconds through the trainer beside
   the train phase's direct step (tokens/s), peak memory, the host's seconds in
   ``payload_digest``, in copies between the card and the host and in the fold
   (timers the phase puts around those calls) and each save's seconds;
6. hybrid: ``recurrentgemma-9b`` at full width, 19 of its 38 layers
   (HYBRID_SERVE_LAYERS: 13 rec, 6 attn, bfloat16) serves 8 requests of
   prompts on both sides of its 2048 window through
   ``ContinuousBatcher(slots=4, max_len=3072)``; the flash kernel ran in the
   attention layers of every prefill, the decode-attention kernel in them at
   every decode step, and the RG-LRU kernel in the recurrent layers of every
   prefill and decode step;
   each request's logits agree with a teacher-forced
   sequential run (fed the batched tokens) within LOGIT_TOL_BF16, and with
   the same run at the batcher's width bit for bit; a profiled prefill of
   one prompt gives the device time by kind of kernel (flash, RG-LRU,
   GEMMs, elementwise), a profiled window of decode steps the device's busy
   share;
7. exactness: a float32 copy of recurrentgemma-9b at full width and depth
   3 (rec, rec, attn) serves the same requests: tokens equal sequential
   greedy decoding, the float32 flash and decode-attention kernels counted
   in that run; decode across the window equals a fresh prefill within
   1e-4; one rec and one attn layer on the card equal the port's CPU path
   on a (1, 2100, 4096) input within 1e-4;
8. rwkv: ``rwkv6-7b`` at full width, 16 of its 32 layers (RWKV_SERVE_LAYERS,
   bfloat16) serves 8 requests (prompts up to 3000 tokens, one shorter than
   a WKV chunk) through ``ContinuousBatcher(slots=4, max_len=3072)``; the
   WKV6 kernel ran in every layer of every prefill and decode step and no
   other kernel ran; each request's logits equal a teacher-forced run at the
   batcher's width bit for bit and agree with it at batch 1 within
   LOGIT_TOL_RWKV; a profiled prefill of one prompt gives the device time by
   kind of kernel, a profiled window of decode steps the device's busy share;
9. rwkv exactness: a float32 copy of rwkv6-7b at full width and depth 2
   serves the same requests: tokens equal sequential greedy decoding; 32
   decode steps after a prompt equal a fresh prefill within 1e-4; one layer
   on the card equals the port's CPU path on a (1, 333, 4096) input within
   1e-4;
10. dense: the dense family at full width in bfloat16 (``qwen3-1.7b``,
   ``stablelm-1.6b``, ``yi-6b`` at half their depth, DENSE_DEPTH, for time;
   ``qwen1.5-110b`` at 4 of its 80 layers, as 222.4 GB of weights do not fit
   the card), one after the other,
   each serving 8 requests of 32 new tokens (prompts 64-1000 tokens, seed 0)
   through ``ContinuousBatcher(slots=4, max_len=1536)``: the flash kernel
   launched once per layer per prefill and the decode kernel once per layer
   per decode step; each request's logits equal a teacher-forced run at the
   batcher's width bit for bit and agree at batch 1 within LOGIT_TOL_BF16;
   tok/s, prefill and decode times, peak memory and a profiled decode window's
   busy share; then one full-width layer of a float32 copy on the card against
   the port's CPU path within 1e-4 on a (1, 777, d) input (with the tied
   unembed for qwen3-1.7b);
10b. moe: ``granite-moe-3b-a800m`` at full width, 16 of its 32 MoE layers
   (MOE_SERVE_LAYERS; 40 experts, top 8; bfloat16) serves 8 requests of 32 new
   tokens (prompts 64-2000 tokens, seed 0: three above 1,024 tokens through
   the einsum engine, five through the dropless sort engine) through
   ``ContinuousBatcher(slots=4, max_len=2048)``: the flash kernel once per
   layer per prefill, the decode kernel once per layer per decode step, no
   other kernel, and each engine called once per layer of each prefill on its
   side of 1,024 tokens (the sort engine in every decode step too); each
   request's logits equal a teacher-forced run at the batcher's width bit for
   bit and agree at batch 1 within LOGIT_TOL_MOE, with the decode steps'
   routing flips between the two counted; ``moe_block`` twice on one input of
   each engine with equal bits; tok/s, prefill and decode times beside their
   bounds, peak memory, a profiled prefill and decode window, and the decode
   step's device time split into attention, the router, the dispatch and
   combine, and the experts' products; then one full-width float32 MoE layer
   on the card against the port's CPU path on a (1, 777, d) input (routing
   compared first: a token routed differently must sit on a float32 tie; the
   output within 1e-4 of its scale, MOE_TOL, the cache within 1e-4), and both
   engines on the CPU path's routing of 2,000 rows, each no further from a
   float64 run than twice the CPU path;
10c. deepseek: ``deepseek-v3-671b`` at full width, 4 of its 61 layers (the 3
   first_k_dense layers and 1 MoE layer of 256 experts, top 8, one shared
   expert; MLA with 128 heads, q_lora 1536, kv_lora 512, qk 128 + 64, v 128;
   an untied vocabulary of 129,280; 15.8B params with the MTP subtree, drawn
   and not run, bfloat16) serves the moe phase's 8 requests through
   ``ContinuousBatcher(slots=4, max_len=2048)``: the flash kernel at key head
   dim 192 and value head dim 128 once per layer per prefill, no decode
   kernel (decode is MLA's absorbed form in float32 plain torch), each engine
   once per MoE layer of each prefill on its side of 1,024 tokens and of each
   decode step; each request's logits equal a teacher-forced run at the
   batcher's width bit for bit and agree at batch 1 within LOGIT_TOL_DEEPSEEK
   on every decode step whose routing did not flip, a flipped step held to
   the flip's terms (a top-8 boundary gap within the runs' rounding, the
   router's input within ROUTER_INPUT_TOL), the boundary gaps logged; the
   unembed at 7168 x 129,536; tok/s, prefill and decode times beside their
   bounds, peak memory, a profiled prefill and decode step by kind and split
   by block (the MLA block, the absorbed decode, the dense MLPs, the router,
   the dispatch and combine, the experts); then a float32 MLA layer on the
   card against the CPU path (a 777-token prefill and its latent cache, 4
   absorbed decode steps) and its decode steps against a fresh prefill, and
   a float32 MoE layer (46 GB) against the CPU path on a 64-token prefill
   and 2 decode steps, routing compared first;
10c. seamless: ``seamless-m4t-large-v2`` at full width and depth (24 encoder
   and 24 decoder layers, 1.63B params, bfloat16) through ``build(cfg).prefill``
   and greedy ``decode_step``, the reference's loop (its batcher takes tokens
   alone): a batch of 4 at 4,096 source frames and two requests alone at 1,000
   and 333, 32 tokens each; the flash kernel 72 times a prefill (the encoder
   without a mask, causal self-attention, cross-attention) and 24 times a
   decode step (the cross-attention at Sq = 1), the decode-attention kernel 24
   times a step, nothing else, counted by block; decode steps 0, 7, 15 and 31
   within min(TEACHER_GAPS times a fresh prefill's gap to a float32 copy,
   LOGIT_TOL_BF16); prefill
   and decode times beside their bounds, tok/s, peak memory, the encoder's share
   of a prefill and the cross-attention's of a decode step; a float32 enc layer
   and an xattn layer (prefill, decode through the grown cache) on the card
   against the CPU path;
10d. internvl: ``internvl2-2b`` at full width and depth (24 layers, 1.90B params,
   bfloat16, 256 patch embeddings before each text prompt) the same way, 4
   requests alone: 24 flash launches a prefill and 24 decode launches a step;
   a float32 copy cut to one layer (the frontend and the layer's prefill)
   against the CPU path;
11. dense train, in a process of its own (this file run with
   ``--dense-train``, set up as ``--train``): ``qwen3-1.7b`` at full width and
   depth in bfloat16 with remat "full" takes 3 AdamW steps (the train CLI's)
   on ``TokenSource(seed=0)`` batches of 2 x 4096; step 0 is run again from
   the same state with equal bits (torch.equal on the card over params, m, v,
   step and metrics; step 0's result waits on the host meanwhile); every step
   launches the bfloat16 backward once per layer and the forward twice (remat
   runs it again in each layer's recompute); step ms, tokens/s, peak memory
   and a profiled step; step 0 with ``attn_impl="ref"`` agrees in loss, grad
   norm and every gradient leaf within DENSE_TRAIN_GAPS times the plain path's
   own bfloat16-against-float32 gap; then 3 direct steps of the same model at 2 of its 28
   layers (DENSE_DURABLE_LAYERS), with the content digests of the checkpoint pair the
   durable trainer saves before step 2;
11b. dense durable, through the train CLI in processes of their own (``python -m
   repro_torch.launch.train --arch qwen3-1.7b --full --layers 2 --batch 2 --seq 4096
   --steps 3 --checkpoint-every 2``: full width, 2 of 28 layers, 412M params in bfloat16,
   a checkpoint pair of 4.1 GB): the durable phase's runs A and B and gates (journal
   shape, step digests equal the direct steps', the crash between the halves of
   ``step00000003``, B's restore through ``resolve()`` onto the card, step 2 re-executed
   to the journal's digest, ``step00000003`` re-saved with A's refs), 12 + 6 and 4 + 2
   flash launches; every param entry of the manifests says bfloat16; A's ``step00000002``
   refs equal the direct steps' digests; that pair as the trainer restores it
   (``restore_pair``) equals, under torch.equal leaf by leaf, the tree read from A's raw
   shards with numpy alone. Logs each save's seconds, bytes and MB/s, the
   restore's seconds, the journal's size and each step's ms through the trainer beside
   the direct step's;
12. hybrid train, in a process of its own (this file run with
   ``--hybrid-train``, set up as ``--train``): ``recurrentgemma-9b`` at full
   width, layers 0-5 (rec, rec, attn) x 2, in bfloat16 with remat "full", takes
   the same 3 AdamW steps on batches of 1 x 4096, with the same gates: step 0
   replayed with equal bits, every step launching the bf16 flash forward 2 x 2
   times and its backward (head dim 256, the split builds) twice, the RG-LRU
   forward 4 x 2 times and its backward kernel 4 times; step ms, tokens/s, peak
   memory and a profiled step (flash forward and backward, RG-LRU forward and
   backward, GEMMs, elementwise, optimizer); step 0 against attn_impl="ref"
   within DENSE_TRAIN_GAPS times the plain path's bf16-vs-f32 gap;
13. rwkv train, in a process of its own (this file run with ``--rwkv-train``,
   set up as ``--hybrid-train``): ``rwkv6-7b`` at full width, layers 0-3, in
   bfloat16 with remat "full", the same 3 AdamW steps on batches of 1 x 4096
   and the same gates: step 0 replayed with equal bits, every step launching
   the WKV6 chunk forward 2 x 4 times and its backward 4 times; step ms,
   tokens/s, peak memory and a profiled step (WKV6 forward and backward,
   GEMMs, elementwise, optimizer); step 0 against attn_impl="ref" (autograd
   through the plain chunked WKV6) within DENSE_TRAIN_GAPS times the plain
   path's bf16-vs-f32 gap;
14. moe train, in a process of its own (this file run with ``--moe-train``, set
   up as ``--hybrid-train``): ``granite-moe-3b-a800m`` at full width, 16 of its
   32 MoE layers of 40 experts, top 8, in bfloat16 with remat "full",
   the same 3 AdamW steps on batches of 1 x 4096, every MoE layer through the
   einsum engine (16 groups of 256 tokens, capacity 64, drops) and no call of the
   sort engine, and the same gates: step 0 replayed with equal bits (the gathers'
   gradients are gathers by inverse tables, in a fixed order), every step
   launching the bf16 flash forward 2 x 16 times and its backward (head dim 64,
   GQA group 3) 16 times; step ms, tokens/s, the aux loss, peak memory and a
   profiled step; step 0 against attn_impl="ref" within DENSE_TRAIN_GAPS times the
   plain path's bf16-vs-f32 gap, with the router's top-8 choices that differ
   between the kernel path, the plain path and float32 counted;
14b. deepseek train, in a process of its own (this file run with
   ``--deepseek-train``, set up as ``--hybrid-train``): ``deepseek-v3-671b`` at
   full width, its 3 dense MLA layers plus the MTP module (4,293,743,616 params),
   in bfloat16 with remat "full", the same 3 AdamW steps with m and v in bfloat16
   (the reference's memory mode for this config) on batches of 1 x 4096, the loss
   with the MTP term, and the same gates: step 0 replayed with equal bits, every
   step launching the flash forward (with the lse, key head dim 192, value head
   dim 128) 2 x 3 + 1 times and its backward (the split build <4, 2>) 3 + 1 times
   (the MTP layer, outside the remat, at 4,094 rows), no MoE engine call; ce,
   z_loss, aux_loss and mtp_loss a step, step ms, tokens/s, peak memory and a
   profiled step with the MTP head's forward and backward device time; step 0
   against attn_impl="ref" within DENSE_TRAIN_GAPS times the plain path's
   bf16-vs-f32 gap on the batch's first DEEPSEEK_PLAIN_SEQ tokens;
14c. encdec train, in a process of its own (this file run with ``--encdec-train``,
   set up as ``--hybrid-train``): ``seamless-m4t-large-v2`` at full size (24
   encoder and 24 decoder layers, 1,633,931,264 params) on 4,096 frames (N(0, 1)
   in bfloat16 from ``_gen``) beside 4,096 tokens, then ``internvl2-2b`` at full
   width and INTERNVL_TRAIN_LAYERS layers on 256 patch embeddings before 3,840
   tokens, each in bfloat16 with remat "full", the same 3 AdamW steps and gates:
   step 0 replayed with equal bits, the flash launches counted (seamless: 2 x (24
   encoder + 2 x 24 decoder attentions) forwards and 72 backwards a step; by
   shape and mask, ``_flash_shapes``), step 0 against attn_impl="ref" within
   DENSE_TRAIN_GAPS times the plain path's bf16-vs-f32 gap over every leaf, the
   encoder's and the frontend's included; seamless then takes one step on each
   SEAMLESS_RAGGED batch (its cross-attention at the shapes of the backward's
   rows without a mask, each step's launches gated) and the first of them, 4,000
   frames against 1,000 tokens, is held against the plain path too; step ms,
   tokens/s, peak memory and a profiled step each;
15. the JSON line of kernels, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.

Every model is freed before the next is built. It imports the port
(``src/repro_torch``) and never JAX or the JAX package. Without a CUDA card,
or outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The train phase runs in a process of its own, this file run as ``chip_smoke.py --train``:
# cuBLAS sums in a fixed order only with a fixed workspace, set before its first handle, and
# torch.use_deterministic_algorithms(True) raises without it. The serving phases run in the
# first process without it, as a server does.
TRAIN_ARG = "--train"
DIST_ARG = "--distributed"  # the distributed phase's process, set up as the train phase's
DENSE_TRAIN_ARG = "--dense-train"  # the dense train phase's process, set up the same way
HYBRID_TRAIN_ARG = "--hybrid-train"  # the hybrid train phase's process, set up the same way
RWKV_TRAIN_ARG = "--rwkv-train"  # the rwkv train phase's process, set up as the hybrid's
MOE_TRAIN_ARG = "--moe-train"  # the moe train phase's process, set up as the hybrid's
DEEPSEEK_TRAIN_ARG = "--deepseek-train"  # the deepseek train phase's process, set up the same
ENCDEC_TRAIN_ARG = "--encdec-train"  # the encdec train phase's process, set up the same
_BIG_TRAIN_ARGS = (
    HYBRID_TRAIN_ARG, RWKV_TRAIN_ARG, MOE_TRAIN_ARG, DEEPSEEK_TRAIN_ARG, ENCDEC_TRAIN_ARG
)
_TRAIN_ARGS = (TRAIN_ARG, DIST_ARG, DENSE_TRAIN_ARG, *_BIG_TRAIN_ARGS)
if sys.argv[1:] in ([arg] for arg in _TRAIN_ARGS):
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
if sys.argv[1:] in ([arg] for arg in _BIG_TRAIN_ARGS):
    # two copies of params, m and v (the out-of-place step) fill ~75 GB of the card: blocks
    # that grow in place keep the allocator's free pieces from splitting it further
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
import repro_torch.core.executor as executor_mod  # noqa: E402
import repro_torch.models.model as model_mod  # noqa: E402
import repro_torch.train.distributed as dist_mod  # noqa: E402
import repro_torch.wire.payload as payload_mod  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ClusterExecutor,
    Context,
    FlakyWorker,
    Gateway,
    InProcWorker,
    Journal,
    check_heartbeat,
)
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import _flatten  # noqa: E402
from repro_torch.data import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch.gateway_serve import (  # noqa: E402
    build_registry,
    generate_all,
    http_workers,
)
from repro_torch.launch.serve import drain, make_prompts, serve  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.layers import ParamStore, apply_norm, dense, softcap  # noqa: E402
from repro_torch.models.model import unembed_logits  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    apply_layer,
    init_layer,
    layer_pattern,
    run_stack,
)
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    tree_leaves,
    tree_map,
)
from repro_torch.params import count_params, init_params  # noqa: E402
from repro_torch.serve import ContinuousBatcher  # noqa: E402
from repro_torch.serve.batcher import _splice_cache  # noqa: E402
from repro_torch.train import (  # noqa: E402
    DistributedTrainer,
    DistTrainConfig,
    make_opt_init,
    make_train_step,
)
from repro_torch.train.host import to_host  # noqa: E402
from repro_torch.train.steps import value_and_grad  # noqa: E402
from repro_torch.train.trainer import restore_pair  # noqa: E402
from repro_torch.wire import payload_digest  # noqa: E402

DEV = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32 on
# CUDA cores, bfloat16 and TF32 on tensor cores, HBM bandwidth. A card with a
# lower power limit is slower.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# TF32 rates measured by tools/mma_probe.py on an NVIDIA H100 80GB HBM3 at 700 W, for the
# float32 backward's products over the head dim (S, dP) and over the walk (dV, dK, dQ):
# mma.sync m16n8k8 at 8-16 warps an SM (both); wgmma m64n32k8 with both operands in shared
# memory and m64n64k8 with A in registers, at 2 warpgroups an SM
PROBED_TF32_FLOPS = {"mma.sync": (311e12, 311e12), "wgmma": (318e12, 485e12)}

# (B, Hq, Hkv, Sq, Sk, D, causal, window, dtype): FLASH_CASES of tests/test_kernels.py
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, "float32"),
    (2, 4, 2, 128, 128, 64, True, None, "float32"),  # GQA
    (1, 8, 1, 256, 256, 128, True, None, "float32"),  # MQA
    (1, 2, 2, 128, 128, 64, False, None, "float32"),  # bidirectional
    (1, 2, 2, 128, 128, 64, True, 64, "float32"),  # local window
    (1, 2, 1, 100, 100, 32, True, None, "float32"),  # ragged
    (1, 2, 2, 64, 192, 32, True, None, "float32"),  # Sq < Sk
    (1, 2, 2, 128, 128, 64, True, None, "bfloat16"),
]
# edges the list above does not reach, with Dv: (..., dtype, Dv)
EDGE_CASES = [
    (3, 8, 2, 200, 300, 128, True, 48, "float32", 128),  # window with Sq < Sk, D = 128
    (2, 4, 4, 65, 65, 96, False, None, "bfloat16", 80),  # Dv not a multiple of 16
    (1, 6, 3, 1, 513, 64, True, None, "float32", 64),  # one query row over a long cache
    (1, 4, 1, 130, 130, 16, True, 1, "float32", 16),  # window 1: each row sees itself only
    (1, 2, 1, 77, 77, 200, True, None, "float32", 136),  # D > 128 with Dv <= 128
]
# bfloat16 on the tensor-core path: head dims 64 and 128 (GQA, MQA), ragged Sq,
# Sq < Sk with a window, window 1, Dv < D without masks, and head dims that are no
# multiple of 8 (the wrapper pads them)
BF16_CASES = [
    (1, 4, 2, 256, 256, 64, True, None, "bfloat16", 64),
    (2, 8, 1, 300, 300, 128, True, None, "bfloat16", 128),
    (1, 4, 2, 200, 515, 128, True, 64, "bfloat16", 128),
    (1, 4, 1, 130, 130, 256, True, 1, "bfloat16", 256),
    (1, 2, 2, 100, 100, 256, False, None, "bfloat16", 64),
    (1, 2, 1, 77, 77, 20, True, None, "bfloat16", 12),
    (1, 16, 8, 777, 777, 128, True, None, "bfloat16", 128),  # qwen3-1.7b's prefill
    (1, 32, 32, 777, 777, 64, True, None, "bfloat16", 64),  # stablelm-1.6b's
]
# float32 on the 3xTF32 path: head dims 16 to 200 that are no power of 2, one that is no
# multiple of 4 (4-byte copies), walks cut into pieces (Sq < Sk with a window, no mask)
F32_CASES = [
    (1, 4, 2, 300, 300, 20, True, None, "float32", 20),
    (2, 4, 1, 150, 400, 96, True, 100, "float32", 96),
    (1, 3, 3, 90, 90, 136, False, None, "float32", 136),
    (1, 2, 1, 700, 700, 18, True, None, "float32", 13),
    (1, 2, 2, 33, 33, 256, True, None, "float32", 256),
    (1, 4, 2, 1500, 1500, 64, False, None, "float32", 32),
    (1, 2, 1, 515, 515, 200, True, 300, "float32", 200),
]
# the same bits twice, and for a batch row alone as within a batch of 3: the bfloat16
# path, and the float32 path at the demo's heads and at head dim 256 with window 2048
DETERMINISM_CASES = (
    (3, 16, 1, 777, 777, 256, True, 512, "bfloat16", 256),
    (3, 12, 4, 777, 777, 64, True, None, "float32", 64),
    (3, 16, 1, 3000, 3000, 256, True, 2048, "float32", 256),
)
# recurrentgemma-9b's local attention: Hq=16, Hkv=1, D=Dv=256, window 2048
HYBRID_FLASH = [
    (1, 16, 1, s_q, s_k, 256, True, 2048, dt, 256)
    for dt in ("float32", "bfloat16")
    for s_q, s_k in ((3000, 3000), (1000, 3000), (2111, 2111))  # full, Sq < Sk, ragged
]
HYBRID_FLASH_JSON = (1, 16, 1, 3000, 3000, 256, True, 2048, "bfloat16", 256)
HYBRID_FLASH_F32_JSON = (1, 16, 1, 3000, 3000, 256, True, 2048, "float32", 256)
# granite-moe-3b-a800m's prefill at the moe phase's longest prompt (1711 tokens): 24 query
# heads on 8 KV heads of 64, a GQA group of 3; its row times SDPA's flash backend with K/V
# expanded beside the kernel
GRANITE_FLASH_JSON = (1, 24, 8, 1711, 1711, 64, True, None, "bfloat16", 64)
# deepseek-v3-671b's MLA prefill: 128 heads, key head dim 192 (128 nope + 64 rope), value head
# dim 128, the explicit scale 192^-0.5; at the deepseek phase's longest prompt (1711 tokens, its
# row in the kernels line) and at 128. D = 192 runs the DC = 4 build, whose fourth 64-column
# chunk of Q and K lies wholly past D (TMA fills it with zeros)
MLA_SCALE = (128 + 64) ** -0.5
MLA_FLASH_JSON = (1, 128, 128, 1711, 1711, 192, True, None, "bfloat16", 128)
MLA_FLASH_CASES = (MLA_FLASH_JSON, (1, 128, 128, 128, 128, 192, True, None, "bfloat16", 128))
# deepseek-v3-671b's train shape (1 x 4096 tokens, 128 heads with a group of 1, key head dim
# 192, value head dim 128, causal, the explicit scale): the forward with the logsumexp and the
# bf16 backward's split build <4, 2> (one part a key tile: no reduction launch); then an edge of
# the MTP layer's ragged 4,094 rows at a few heads, small enough for the plain versions
MLA_TRAIN = (1, 128, 128, 4096, 4096, 192, True, None, "bfloat16", 128)
MLA_TRAIN_EDGE = (1, 2, 2, 4094, 4094, 192, True, None, "bfloat16", 128)
# (B, T, W, x dtype, with h0): recurrentgemma-9b's prefill (T up to 3000) and
# decode (B = slots, T = 1) at lru_width 4096; a W that is no multiple of the
# ring kernel's 16 channels; float32 x; then the two kernels' edges: T on both
# sides of the step/ring threshold, one ring stage of 64 steps exactly and one
# step past it, a W that is no multiple of 8 (the wrapper pads it for the ring
# kernel), float32 at the decode shape
RGLRU_CASES = [
    (1, 3000, 4096, "bfloat16", True),
    (1, 3000, 4096, "bfloat16", False),
    (4, 1, 4096, "bfloat16", True),
    (2, 333, 1000, "bfloat16", True),
    (1, 3000, 4096, "float32", True),
    (1, rg.STEP_MAX_T, 4096, "bfloat16", True),
    (1, rg.STEP_MAX_T + 1, 4096, "bfloat16", True),
    (2, 64, 4096, "bfloat16", True),
    (2, 65, 4096, "float32", False),
    (3, 200, 50, "bfloat16", True),
    (4, 1, 4096, "float32", True),
]
RGLRU_JSON = (1, 3000, 4096, "bfloat16", True)  # prefill passes the zero state as h0
RGLRU_TIMED = (RGLRU_JSON, RGLRU_CASES[2])
# the same bits twice, and for batch row 0 alone as within a batch of 4, on each path
RGLRU_DETERMINISM = ((4, 777, 4096, "bfloat16", True), (4, 1, 4096, "bfloat16", True))
# The RG-LRU backward (csrc/rglru_bwd.cu) against ref.rglru_bwd_ref, bit for bit: the hybrid's
# train shape (1 x 4096 steps of 4096 channels, bfloat16 x, no initial state), then with an
# initial state and in float32, T = 1 and T = 32, ragged W with T below and above the
# kernel's 16-step batches
RGLRU_BWD_JSON = (1, 4096, 4096, "bfloat16", False)
RGLRU_BWD_CASES = [
    RGLRU_BWD_JSON,
    (1, 4096, 4096, "bfloat16", True),
    (1, 4096, 4096, "float32", False),
    (1, 4096, 4096, "float32", True),
    (2, 1, 4096, "bfloat16", True),
    (2, 32, 4096, "float32", True),
    (3, 13, 100, "bfloat16", True),
    (2, 45, 4100, "float32", False),
]
# a = 1 on every third step and x = 0 on every fifth channel: da is +-inf and NaN there
RGLRU_BWD_EDGE = (2, 40, 64, "float32", True)
RGLRU_BWD_DETERMINISM = (4, 777, 4096, "bfloat16", True)
# (B, H, KV, Sc, D, window, dtype, each slot's position): the cached decode of
# serpytor-demo-100m (12 query heads on 4 KV heads of 64, a linear float32 cache of
# max_len 1536: slots at different positions, one on the last slot, one past it, where
# every key is valid) and of recurrentgemma-9b (16 query heads on 1 KV head of 256, a
# ring of its 2048 window: slots wrapped, before the ring fills and on its last slot;
# bfloat16, and float32 as in its float32 copy); then the tests' smoke widths and the
# kernel's edges: small D and Sc, a D that is no power of 2, an Sc that is no
# multiple of the 64-key split, a ring of 50, position 0
DECODE_CASES = [
    (4, 12, 4, 1536, 64, None, "float32", (1031, 5, 1535, 1600)),
    (4, 16, 1, 2048, 256, 2048, "bfloat16", (2250, 100, 2047, 4000)),
    (4, 16, 1, 2048, 256, 2048, "float32", (2250, 100, 2047, 4000)),
    (2, 4, 2, 16, 32, None, "float32", (5, 11)),
    (3, 4, 1, 16, 32, 16, "bfloat16", (5, 29, 15)),
    (2, 6, 3, 130, 40, None, "bfloat16", (129, 64)),
    (1, 2, 2, 50, 8, 50, "float32", (77,)),
    (2, 16, 1, 300, 128, None, "float32", (0, 299)),
    # the dense family's cached decode in bfloat16 at max_len 1536: qwen3-1.7b (16 on 8 KV
    # heads of 128), stablelm-1.6b (32 heads of 64, no grouping), yi-6b (32 on 4),
    # qwen1.5-110b (64 on 8)
    (4, 16, 8, 1536, 128, None, "bfloat16", (1031, 5, 1535, 1600)),
    (4, 32, 32, 1536, 64, None, "bfloat16", (1031, 5, 1535, 1600)),
    (4, 32, 4, 1536, 128, None, "bfloat16", (1031, 5, 1535, 1600)),
    (4, 64, 8, 1536, 128, None, "bfloat16", (1031, 5, 1535, 1600)),
    # granite-moe-3b-a800m's at max_len 2048: 24 query heads on 8 KV heads of 64
    (4, 24, 8, 2048, 64, None, "bfloat16", (1742, 1031, 5, 2047)),
]
DECODE_DEMO_JSON, DECODE_JSON = DECODE_CASES[0], DECODE_CASES[1]
DECODE_GRANITE_JSON = DECODE_CASES[-1]
# the last decode step of seamless-m4t-large-v2's batch-4 request (16 heads of 64, no grouping,
# a cache of its 4-token prompt + 32) and of internvl2-2b's longest request (16 on 8 KV heads of
# 128, a cache of 256 patches + 513 tokens + 32)
DECODE_SEAMLESS_JSON = (4, 16, 16, 36, 64, None, "bfloat16", (35, 35, 35, 35))
DECODE_INTERNVL_JSON = (1, 16, 8, 801, 128, None, "bfloat16", (800,))
DECODE_CASES += [DECODE_SEAMLESS_JSON, DECODE_INTERNVL_JSON]
DECODE_TIMED = (
    DECODE_DEMO_JSON, DECODE_JSON, DECODE_GRANITE_JSON, DECODE_SEAMLESS_JSON, DECODE_INTERNVL_JSON
)
DECODE_DETERMINISM = DECODE_TIMED
# (B, H, T, K, V, dtype, with h0): WKV_CASES of tests/test_kernels.py, a ragged T,
# rwkv6-7b's prefill (T up to 3000, 64 heads of 64; prefill passes the zero
# state as h0) and decode (B = slots, T = 1) shapes; then the chunk kernel's edges
# (T around one and two chunks, a T whose 6 chunks end its 4-stage ring mid-way,
# K != V with widths that are no multiple of 8, which the wrapper pads) and the
# stream kernel's (float32 at the decode shape, T on both sides of the threshold)
WKV_CASES = [
    (1, 1, 32, 16, 16, "float32", False),
    (2, 3, 64, 32, 32, "float32", True),
    (1, 2, 128, 64, 64, "float32", True),
    (2, 1, 48, 16, 32, "float32", False),  # K != V
    (1, 2, 21, 16, 16, "float32", True),  # ragged T: a last chunk of 5 rows
    (1, 64, 3000, 64, 64, "bfloat16", True),
    (1, 64, 3000, 64, 64, "bfloat16", False),
    (4, 64, 1, 64, 64, "bfloat16", True),
    (1, 2, 15, 64, 64, "float32", True),
    (1, 2, 16, 64, 64, "float32", True),
    (2, 2, 17, 64, 64, "bfloat16", True),
    (1, 2, 33, 64, 64, "float32", False),
    (1, 3, 90, 64, 64, "float32", True),  # 6 chunks: the 4-stage ring wraps, ends in stage 1
    (2, 2, 50, 20, 12, "bfloat16", True),
    (1, 2, 50, 20, 12, "float32", True),
    (4, 64, 1, 64, 64, "float32", True),
    (4, 64, wk.STREAM_MAX_T, 64, 64, "bfloat16", True),
    (4, 64, wk.STREAM_MAX_T, 64, 64, "float32", True),
    (4, 64, wk.STREAM_MAX_T + 1, 64, 64, "bfloat16", True),
]
WKV_JSON = (1, 64, 3000, 64, 64, "bfloat16", True)
WKV_TIMED = (WKV_JSON, WKV_CASES[6], WKV_CASES[7])
# the same bits twice, and for batch row 0 alone as within a batch of 4, on each path
WKV_DETERMINISM = ((4, 64, 777, 64, 64, "bfloat16", True), (4, 64, 1, 64, 64, "bfloat16", True))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, tests/test_kernels.py:47
# The WKV6 backward (csrc/wkv6_bwd.cu) against ref.wkv6_bwd_ref, each gradient within TOL of the
# case's dtype times its largest entry. (B, H, T, K, V, dtype, with h0, with dS_T): rwkv6-7b's
# train shape (1 x 4096 tokens, 64 heads of 64, bfloat16, no initial state and no gradient of
# the final state, as training calls it), the same with both; the float32 cases of WKV_CASES
# (T from 1 to 128, 15, 16, 21 and 33 about the chunk's edges, K != V at 16/32 and 20/12), T =
# 17 in both dtypes
WKV_BWD_JSON = (1, 64, 4096, 64, 64, "bfloat16", False, False)
WKV_BWD_CASES = [
    WKV_BWD_JSON,
    (1, 64, 4096, 64, 64, "bfloat16", True, True),
    *(c + (c[6],) for c in WKV_CASES if c[5] == "float32"),
    (2, 2, 17, 64, 64, "float32", True, True),
    (2, 2, 17, 64, 64, "bfloat16", True, False),
]
# log w in U(-4, -3.9): chunk sums down to -64, where autodiff through the chunked form's k / D_t
# divides by an underflowed D_t^2 and gives NaN; every entry of the kernel's gradient is finite
WKV_BWD_DEEP = (2, 4, 300, 64, 64, "float32", True, True)
WKV_BWD_DETERMINISM = (4, 64, 777, 64, 64, "bfloat16", True, True)
# the gradients against float64 autograd through ref.wkv6_ref: the kernel's error at most this
# many times the plain version's, gradient by gradient (relative L2), on every float32 case;
# an error below WKV_BWD_F64_FLOOR (a few float32 roundings) counts as that floor
WKV_BWD_F64_RATIO = 2.0
WKV_BWD_F64_FLOOR = 1e-6
# the flash backward against its plain version: rtol = atol = 1e-4, ten times tighter than
# the 1e-3 of tests/test_kernels.py:63: a backward with one TF32 pass a product, or with dK and
# dV summed over a whole walk in the tensor cores, exceeds it (tests/test_torch_flash_bwd.py)
BWD_TOL = 1e-4
# the demo's train shape: a batch of 4 sequences of train_4k's 4096 tokens (its global batch
# of 256 cut to one card's step), 12 query heads on 4 KV heads of 64, causal
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 4, 3
FLASH_BWD_TRAIN = (TRAIN_BATCH, 12, 4, TRAIN_SEQ, TRAIN_SEQ, 64, True, None, "float32", 64)
# float32 cases of FLASH_CASES, then edges: MLA head dims, a window with Sq < Sk and GQA,
# no mask with Sq > Sk, head dim 128 (the kernels' widest: the mma.sync path's largest shared
# memory), window 1 with Sq < Sk, ragged; edges of the wgmma path's 128-row blocks and 32-row
# walk tiles: Sq and Sk no multiples of 128 with a window and GQA, a walk of one tile, head
# dims no multiples of 4 (the mma.sync path at head dims below 64)
FLASH_BWD_CASES = [c + (c[5],) for c in FLASH_CASES if c[8] == "float32"] + [
    (1, 2, 2, 64, 64, 48, True, None, "float32", 32),
    (2, 6, 2, 50, 130, 32, True, 20, "float32", 32),
    (1, 4, 1, 90, 40, 16, False, None, "float32", 24),
    (1, 4, 2, 300, 300, 128, True, None, "float32", 128),
    (1, 2, 2, 150, 400, 24, True, 1, "float32", 16),
    (1, 6, 2, 200, 333, 64, True, 100, "float32", 64),
    (2, 3, 1, 20, 20, 64, True, None, "float32", 64),
    (1, 2, 1, 70, 70, 30, True, None, "float32", 18),
    FLASH_BWD_TRAIN,
]
# The float32 backward at head dim 128 (the mma.sync path), timed at qwen3-1.7b's train shape
FLASH_BWD_F32_HD128 = (2, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, None, "float32", 128)
# The bfloat16 backward: qwen3-1.7b's train shape (batch 2 of 4096 tokens, 16 query heads on 8
# KV heads of 128, causal), then the cases of tests/test_torch_flash_bwd_bf16.py (head dims 64
# and 128, GQA groups 1, 2 and 8, a window with Sq < Sk, head dims no multiple of 8 that the
# wrapper pads, D != Dv with no mask and Sq > Sk; the edges of the kernels' 128-row blocks and
# 64-row walk tiles: ragged Sq and Sk with GQA and a window crossing tile edges, walks of one
# tile, Sq = 1, D != Dv at head dims up to 64 and on either side of 64: the kernels built for
# 1 or 2 chunks of 64 columns of each) and more edges: stablelm-1.6b's heads, a group of 16,
# window 1, one query row. Last, granite-moe-3b-a800m's train shape (1 x 4096 tokens, 24 query
# heads on 8 KV heads of 64, causal: a GQA group of 3 at head dim 64), and
# seamless-m4t-large-v2's decoder self-attention at its train shape (1 x 4096 tokens, 16 heads
# of 64, causal, group 1).
DENSE_TRAIN_BATCH = 2
FLASH_BWD_BF16_TRAIN = (
    DENSE_TRAIN_BATCH, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, None, "bfloat16", 128
)
MOE_TRAIN_BATCH = 1  # train_4k's 4096 tokens, its batch cut to one sequence on one card
FLASH_BWD_BF16_GRANITE = (
    MOE_TRAIN_BATCH, 24, 8, TRAIN_SEQ, TRAIN_SEQ, 64, True, None, "bfloat16", 64
)
FLASH_BWD_BF16_SEAMLESS = (1, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 64, True, None, "bfloat16", 64)
FLASH_BWD_BF16_CASES = [
    (1, 2, 2, 64, 64, 64, True, None, "bfloat16", 64),
    (2, 4, 2, 70, 70, 128, True, None, "bfloat16", 128),
    (1, 8, 1, 40, 96, 128, True, 24, "bfloat16", 128),
    (1, 4, 2, 33, 50, 60, True, None, "bfloat16", 60),
    (1, 2, 1, 48, 40, 36, False, None, "bfloat16", 20),
    (1, 4, 2, 150, 200, 128, True, 70, "bfloat16", 128),
    (1, 2, 2, 64, 64, 128, False, None, "bfloat16", 128),
    (1, 4, 1, 1, 70, 128, True, None, "bfloat16", 128),
    (1, 4, 2, 90, 90, 48, True, None, "bfloat16", 64),
    (1, 4, 2, 100, 130, 128, True, None, "bfloat16", 64),
    (1, 2, 1, 70, 70, 64, True, 30, "bfloat16", 96),
    (1, 32, 32, 777, 777, 64, True, None, "bfloat16", 64),
    (1, 16, 1, 300, 300, 128, True, None, "bfloat16", 128),
    (1, 4, 2, 150, 400, 24, True, 1, "bfloat16", 16),
    (2, 6, 2, 1, 130, 128, True, None, "bfloat16", 128),
    (1, 4, 2, 200, 333, 128, True, 100, "bfloat16", 128),
    (1, 2, 2, 37, 100, 64, False, None, "bfloat16", 64),
    (1, 2, 2, 200, 130, 64, False, None, "bfloat16", 64),
    FLASH_BWD_BF16_TRAIN,
    FLASH_BWD_BF16_GRANITE,
    FLASH_BWD_BF16_SEAMLESS,
]
# The bfloat16 backward against its plain version (float32 throughout, the gradients rounded
# once): the kernels round P and dS to bfloat16 where they enter a product, and the CPU model
# of that rounding in tests/test_torch_flash_bwd_bf16.py stays within 41% of 2^-6 of each
# gradient's largest entry. Held at 2^-6 of each gradient's largest entry, as there.
BWD_BF16_TOL = 2.0**-6
# The bfloat16 forward's logsumexp against the plain one: both float32 over the same
# bfloat16 products (sums in other orders, exp2 against exp): 1e-4, rtol = atol.
LSE_BF16_TOL = 1e-4
# the bfloat16 backward's same bits on two launches and for B = 1 against row 0 of B = 4: at
# head dim 128 with a group of 2, and at granite's head dim 64 with a group of 3
FLASH_BWD_BF16_DETERMINISM = (
    (4, 16, 8, 1024, 1024, 128, True, None, "bfloat16", 128),
    (4, 24, 8, 1024, 1024, 64, True, None, "bfloat16", 64),
)
# flash_bwd_bf16_<part>_kernel: the bfloat16 backward's launches, up to head dim 128 and in
# the split builds above it (the reduction runs where a key tile's walk is cut into parts)
BF16_KERNEL_PARTS = ("delta", "dkdv_wgmma", "dq_wgmma")
BF16_SPLIT_PARTS = ("delta", "dkdv_split", "dkdv_reduce", "dq_split")
# its wgmma kernels (up to head dim 128, then the split builds'), which ptxas must build with no
# spills and no wgmma serialized (its notes C7514, C7515, C7518); the split builds' reduction
# with no spills
BF16_WGMMA_KERNELS = (
    "flash_bwd_bf16_dkdv_wgmma_kernel",
    "flash_bwd_bf16_dq_wgmma_kernel",
    "flash_bwd_bf16_dkdv_split_kernel",
    "flash_bwd_bf16_dq_split_kernel",
)
BF16_REDUCE_KERNEL = "flash_bwd_bf16_dkdv_reduce_kernel"
# The bfloat16 backward at head dims above 128 (the split builds): recurrentgemma-9b's train
# shape (1 x 4096 tokens, 16 query heads on one KV head of 256, causal, window 2048), then edges:
# a group of 16 with ragged Sq = Sk, Sq < Sk with a window crossing the 64-row tiles and Dv 128,
# a group of 1 with a window, Sq = 1, no mask with GQA at B = 2, and chunks of 64 columns wholly
# past D or Dv, which the kernels zero instead of loading (D 64 with Dv 256, D 160); then Sq < Sk
# with a window and a group of 3, whose key tiles' walks (3 to 15 tiles) the 8 parts of
# flash_attention.bwd_split_plan cut unevenly, some parts empty; and walks of one tile, which
# the planner leaves in one part, so that the dK/dV kernel writes dK and dV itself.
FLASH_BWD_HD256_TRAIN = (1, 16, 1, TRAIN_SEQ, TRAIN_SEQ, 256, True, 2048, "bfloat16", 256)
FLASH_BWD_HD256_CASES = [
    (1, 16, 1, 300, 300, 256, True, None, "bfloat16", 256),
    (1, 16, 1, 150, 400, 256, True, 70, "bfloat16", 128),
    (1, 2, 2, 130, 130, 256, True, 100, "bfloat16", 256),
    (1, 4, 1, 1, 70, 256, True, None, "bfloat16", 256),
    (2, 4, 2, 100, 130, 256, False, None, "bfloat16", 256),
    (1, 2, 1, 70, 70, 64, True, 30, "bfloat16", 256),
    (1, 4, 2, 64, 64, 160, True, None, "bfloat16", 160),
    (1, 6, 2, 300, 500, 256, True, 150, "bfloat16", 256),
    (1, 2, 2, 64, 64, 256, True, None, "bfloat16", 256),
    FLASH_BWD_HD256_TRAIN,
]
FLASH_BWD_HD256_DETERMINISM = (4, 16, 1, 1024, 1024, 256, True, 512, "bfloat16", 256)
# the mma.sync bfloat16 backward that the wgmma kernels replaced, at qwen3-1.7b's train shape,
# for the record beside their time (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W)
BWD_BF16_MMA_SYNC_MS = 3.6506
# the split builds before their redesign (S and dP computed by both consumer warpgroups, one
# block a key tile), at recurrentgemma-9b's train shape (ms; PERF.md §6, same card)
BWD_HD256_BEFORE_MS = "1.6932-1.7129"
# AdamW as the train CLI sets it for TRAIN_STEPS steps (repro_torch.launch.train.opt_config,
# held equal in the train process): the durable phase's trainer steps take the same AdamW
TRAIN_OPT = dict(lr=3e-4, warmup_steps=10, total_steps=TRAIN_STEPS)
# Step 0 through the kernels against step 0 with attn_impl="ref" (plain attention under
# autograd, the same float32 GEMMs): the attention outputs differ by ~1e-6 of their size
# (3xTF32 against float32 products, other orders of summation), which 8 layers carry into
# the loss (~10.4) and the gradients at about that relative size. Loss within 1e-4
# absolute, grad norm within 1e-3 relative, every gradient leaf within 1e-3 of its largest
# entry: a missing or misplaced term of the attention's gradient moves a leaf by its own
# size.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
TRAIN_GRAD_TOL = 1e-3
# The durable and distributed phases train the demo at its full width and 2 of its 8 layers,
# to keep the script inside its 1200 s on a slow host (their checkpoints' zlib on one host
# thread and the gradients' hashing are most of their time; 4 layers until the script gained
# the moe phase); their direct-step comparisons run at that depth.
DEMO_CUT_LAYERS = 2
DEMO_SEQ = (128, 777, 2048)
JSON_SEQ = 777  # the demo prefill length whose times go into the kernels line
N_REQUESTS, SLOTS, MAX_LEN, NEW_TOKENS = 8, 4, 1536, 32
HYBRID_MAX_LEN = 3072
# Batched and teacher-forced sequential decoding run the same bfloat16 model at
# batch 4 and batch 1. cuBLAS may sum a product in another order at the two
# batch sizes, and a layer output rounded to bfloat16 (8 bits of mantissa) then
# differs by one unit in the last place, 2^-8 of its size. Summed over 38 layers
# that is at most ~0.15 of the residual stream's size, and the logits at this
# initialisation have a standard deviation of ~1.3 (unembed sigma 0.02 over
# d=4096): a bound of 0.25 on any logit. A fault (a wrong cache row, a
# misplaced state) moves logits by their own size, several units.
LOGIT_TOL_BF16 = 0.25
# The same teacher-forced run at the batcher's width (the request's cache in all
# rows of a 4-row batch) has the batched run's matmul shapes, and every op of a
# decode step is row-wise: equal bits, so a cache row or a state in the wrong
# slot shows at once.
SAME_SHAPE_TOL = 0.0
EXACT_TOL = 1e-4  # float32 both sides, XLA-free: summation order only
LAYER_CHECK_SHAPE = (1, 2100, 4096)
# The unembed on the card (bf16 operands, float32 accumulation and output) against the
# same bf16 values taken in float32: both sums are float32 over d = 4096 terms and differ
# only in their order, ~sqrt(d) * 2^-24 of the partial sums' size (~1e-5 at logits of
# ~1). A transposed or wrong matrix moves a logit by its own size, ~1.
UNEMBED_TOL = 1e-3
RWKV_MAX_LEN = 3072
# Batched and teacher-forced runs of bfloat16 rwkv6-7b at batch 4 and batch 1
# differ only where cuBLAS sums a product in another order at the two batch
# sizes: the WKV6 kernel (one block per batch row and head), the norms and the
# elementwise ops are row-wise and give the same bits at any batch. A GEMM
# output rounded to bfloat16 then differs by at most one unit in the last
# place, 2^-8 of its size. Summed over 32 layers (each adds a time-mix and a
# channel-mix output to the residual stream) that is at most 32 * 2^-8 = 0.125
# of the stream's size, which the final LayerNorm hands to the logits: each
# logit may move by 0.125 of its own size. Logits at this initialisation have
# a standard deviation of 0.02 * 0.88 (a normal truncated at 2 sigma) * sqrt(4096)
# = 1.13, and the largest of 65,536 is ~4.7 of those, 5.3: a bound of
# 0.125 * 5.3 = 0.66 on any logit. A fault (a state in the wrong slot, a lost
# token shift) moves logits by their own size. The norms go through
# F.layer_norm, whose float32 result for a row is the same at batch 1 and at
# batch 4 on an H100; with mean/var reductions in its place some elements differ
# in the last bit, and a request's logits at batch 1 and at batch 4 drift 2.19
# apart within 32 decode steps (tools/batch_invariance.py).
LOGIT_TOL_RWKV = 0.66
RWKV_LAYER_CHECK_SHAPE = (1, 333, 4096)  # ragged: a last WKV chunk of 13 rows
# recurrentgemma-9b and rwkv6-7b are served at half depth since the seamless and internvl
# phases came, to keep the script's phases inside the time limit (they took 71.0 s and 64.1 s
# at full depth): the hybrid's first 19 layers keep its (rec, rec, attn) pattern with 6 attn
# layers; every gate holds at any depth, and the kernel rows keep their shapes
HYBRID_SERVE_LAYERS = 19
RWKV_SERVE_LAYERS = 16
MOE_ARCH = "granite-moe-3b-a800m"
MOE_MAX_LEN = 2048
# the moe phase's prompts, make_prompts(8, vocab, 64, 2000, seed=0): 1711, 1297 and 1054
# tokens go through the einsum engine (above moe.DROPLESS_TOKENS), the rest dropless
# through the sort engine
MOE_PROMPT_LENS = (64, 2000)
# Batched and teacher-forced runs of bfloat16 granite-moe at batch 4 and batch 1 differ
# only where cuBLAS sums a product in another order at 1 row than at 4 (q, k, v, o, the
# router's logits, the experts' products at 1 or 4 rows an expert): the router's choice, the
# combine, the norms and the decode-attention kernel are row-wise. A bfloat16 output then
# differs by one unit in the last place, 2^-8 of its size. 32 layers each add an attention
# and a MoE output to the residual stream: at most 64 * 2^-8 = 0.25 of its size, which the
# final RMSNorm hands to the logits.
# Logits here have a standard deviation of 0.02 * 0.88 * sqrt(1536) = 0.69 (the tied table),
# and the largest of 49,155 is ~4.1 of those, 2.8: a bound of 0.25 * 2.8 = 0.70 on any logit.
# It holds while each token keeps its experts in both runs: a flipped expert moves a layer's
# output by a whole expert's share, so the phase counts the decode steps' routing flips at
# batch 1, and a flip that takes a logit past the bound fails it.
LOGIT_TOL_MOE = 0.70
# rows of the float32 MoE layer's (1, S, d) input (the dropless sort engine) and of the
# engines' own check on the CPU path's routing (the einsum engine drops at this size)
MOE_LAYER_CHECK = 777
MOE_ENGINE_CHECK = 2000
# The float32 MoE layer on the card against the CPU path: both sum the same float32 products
# in other orders, which moves a result by a few units in its last place, so the bound scales
# with the output. The reference's init law draws each expert matrix with sigma 1/sqrt(E) (its
# fan_in is the matrix's first axis, the experts), so the experts' outputs reach ~150 at full
# width, where float32's unit in the last place is 1.5e-5, and the CPU path's own float32
# result stands about 1e-4 from float64 (the engines' check prints both sides' distance),
# past EXACT_TOL's absolute 1e-4. So the layer's output is held to EXACT_TOL of its largest
# magnitude, ~50 units in the last place; a fault (a wrong expert, weight or slot) moves a
# token's output by a whole expert's share, ~10% of the scale.
MOE_TOL = EXACT_TOL
# granite-moe-3b-a800m is served at 16 of its 32 layers since the deepseek phase came, to keep
# the script's phases inside the time limit: every gate of the moe phase holds at any depth, and
# granite's kernel rows keep their shapes (its training stays at full depth)
MOE_SERVE_LAYERS = 16
DEEPSEEK_ARCH = "deepseek-v3-671b"
# of its 61 layers: the 3 first_k_dense layers and 1 MoE layer of 256 experts, so that every
# layer kind runs at full width: 15,801,029,632 params with the MTP subtree (drawn, not run),
# 31.6 GB in bfloat16 (the 61 layers hold 671.7B and fit on no one card)
DEEPSEEK_LAYERS = 4
# Batched and teacher-forced runs of the bfloat16 deepseek cut at batch 4 and batch 1 differ
# only where cuBLAS sums a product in another order at 1 row than at 4 (the MLA projections and
# the absorbed decode's float32 products, the dense MLPs, the router's logits, the experts' and
# the shared expert's products); the norms, the combine and the router's choice are row-wise. A
# bfloat16 output then differs by one unit in the last place, 2^-8 of its size. 4 layers each add
# an attention and an FFN output to the residual stream: at most 8 * 2^-8 = 0.031 of its size,
# which the final RMSNorm hands to the logits. Logits here have a standard deviation of
# 0.02 * 0.88 * sqrt(7168) = 1.49 (the untied unembed), and the largest of 129,280 is ~4.5 of
# those, 6.7: a bound of 0.031 * 6.7 = 0.21 on any logit. It holds while each token keeps its
# experts in both runs: a flipped expert moves the MoE layer's output by an expert's share. The
# MoE layer is the last layer, so a flip moves that decode step's logits alone (nothing after
# it is cached), and such a step is held instead to the flip's own terms (_flip_steps): the
# router's input within ROUTER_INPUT_TOL of the wide run's, and the batch-1 run's top-8
# boundary gap within what the two runs' rounding moves the probabilities. A fault (a cache row
# in the wrong slot, a lost position) moves the router's input by its own size, and the logits
# of every later step by several units.
LOGIT_TOL_DEEPSEEK = 0.21
# the router's input (the MoE layer's normed stream) at batch 1 against the batcher's width,
# max |a - b| over max |b|: 3 dense layers and the MoE layer's attention add 7 outputs, each up
# to one bfloat16 unit of its size
ROUTER_INPUT_TOL = 7 * 2**-8
DEEPSEEK_LAYER_CHECK = 777  # rows of the float32 MLA layer's prefill, then 4 decode steps
DEEPSEEK_MOE_CHECK = 64  # rows of the float32 MoE layer's prefill, then 2 decode steps
# The encoder-decoder and VLM serving phases (the reference serves these two only through its
# Model API: prefill, then greedy decode_step, as tests/test_archs_smoke.py does).
SEAMLESS_ARCH = "seamless-m4t-large-v2"
INTERNVL_ARCH = "internvl2-2b"
# (batch, source frames, prompt tokens) of each seamless request: a batch of 4 at the
# reference's source_len_for_decode with equal 4-token prompts, then two requests alone at
# ragged lengths (a last key tile of 1000 % 64 = 40 and 333 % 64 = 13 rows; a 37-token prompt
# and a 1-token one)
SEAMLESS_REQUESTS = ((4, 4096, 4), (1, 1000, 37), (1, 333, 1))
INTERNVL_REQUESTS = 4  # prompts of make_prompts(4, vocab, 16, 600, seed=0), each alone
INTERNVL_PROMPT_LENS = (16, 600)
TEACHER_STEPS = (0, 7, 15, 31)  # decode steps held against a fresh prefill
# A decode step against a fresh prefill over the prompt and the tokens fed so far, both in
# bfloat16 at the same batch: the encoder (seamless) and the vision prefix (internvl) see the
# same inputs at the same shapes and give the same bits; the decoder's products run at other
# row counts (cuBLAS may sum in another order) and its attention runs the decode kernel in
# place of the flash one, so its bfloat16 roundings fall elsewhere, and each layer's rounding
# moves the next layer's input. So each step is held within TEACHER_GAPS times the fresh
# prefill's own bfloat16 rounding: its distance to the same prefill run by a float32 copy of
# the same weights (max |a - b| over the logits, as the CPU tests hold a bfloat16 copy). As
# |decode - fresh| <= |decode - float32| + |fresh - float32|, a step within twice the gap
# rounds no more than the prefill does. The decode kernel takes P.V with P in bfloat16 hi/lo
# halves where the flash kernel rounds P to bfloat16 once, so decode lands nearer float32 and
# its distance to the prefill is about the prefill's own gap (1.00-1.35 of it; NVIDIA H100
# 80GB HBM3, 700 W). LOGIT_TOL_BF16 caps the limit, so that a fault that widened the gap itself
# (in the bfloat16 prefill or in the float32 copy) cannot widen the limit past it. A fault (a
# cross key in the wrong slot, a lost position, a cache too short for the patches: decode then
# writes every new key into the last slot) moves logits past any rounding.
TEACHER_GAPS = 2.0
# the float32 layer checks of the seamless phase: source rows, decoder rows, decode steps
SEAMLESS_LAYER_CHECK = (333, 37, 2)
# seamless's flash shapes without a mask, each timed: the encoder's self-attention at the
# batch-4 prefill (16 heads of 64, no GQA), a decode step's cross-attention, one query row
# against the 4,096 source rows, and a ragged request's prefill cross-attention (37 rows against
# 1,000); then edges small enough for the plain version: a decode step against 333, and more
# queries than keys
ENCODER_FLASH_JSON = (4, 16, 16, 4096, 4096, 64, False, None, "bfloat16", 64)
CROSS_DECODE_JSON = (4, 16, 16, 1, 4096, 64, False, None, "bfloat16", 64)
CROSS_PREFILL_JSON = (1, 16, 16, 37, 1000, 64, False, None, "bfloat16", 64)
ENCDEC_FLASH_TIMED = (ENCODER_FLASH_JSON, CROSS_DECODE_JSON, CROSS_PREFILL_JSON)
ENCDEC_FLASH_EDGES = (
    (1, 16, 16, 1, 333, 64, False, None, "bfloat16", 64),
    (1, 16, 16, 100, 40, 64, False, None, "bfloat16", 64),
)
# These rows are held tighter than TOL's rtol = atol = 2e-2. At N(0, 1) inputs the outputs are
# about sqrt(e / Sk) in size (0.026 at 4,096 keys), so an atol of 2e-2 would pass a key tile
# dropped from the walk. Both sides round the output to bfloat16 once and may differ by one unit
# in its last place, at most 2^-7 of the value; the kernel's P, rounded to bfloat16 before P.V,
# adds noise well below TOL times the output's RMS. So |got - want| <= SCALED_RTOL |want| +
# TOL * rms(want), and each row shows that planted faults fail that limit: the walk's last key
# tile dropped, and a ragged last tile's padding keys (zeros, as TMA fills them) folded into the
# softmax (_planted_faults).
SCALED_RTOL = 2.0**-7
KEY_TILE = 64  # the bfloat16 forward's key tile at head dim 64
# The bfloat16 backward without a mask at head dim 64 and a group of 1, the rows of the encdec
# train phase: seamless-m4t-large-v2's encoder and cross-attention at its train shape (4,096
# frames and 4,096 tokens), then the cross-attention of the phase's ragged steps: 1,000 tokens
# against 4,000 frames (Sq < Sk), 4,000 against 1,000 (Sq > Sk), and 37 against 1,000 at B = 2
# (both tails ragged, a walk of one query tile). The phase checks that its steps ran these
# shapes. Each row holds dQ, dK and dV against float64 autograd of dense attention on the card
# (_attention_f64) within SCALED_RTOL |want| + BWD_RMS_TOL * rms(want), element by element, and
# within BWD_LEAN_LIMIT by its lean (_bwd_used), and each shows that planted faults fail that
# limit (_bwd_faults): the walk's last key tile dropped, a ragged last key tile's zero padding
# keys folded into the softmax, the last query tile's rows dropped from dK and dV.
# The element-wise part allows 2^-5 of the gradient's RMS where the forward's rows allow TOL's
# 2e-2: each gradient element sums Sk (dQ) or Sq (dK, dV) products whose P or dS operand was
# rounded to bfloat16, as any FlashAttention-2 backward in bfloat16 rounds it. SDPA's backward
# (cuDNN) gives the kernels' very value at every row's worst element: 8 to 24 units in the last
# place off at an element of 0.2-0.4 of the gradient's RMS, the largest 0.018-0.019 of that RMS
# over the 10^5 to 4 x 10^6 elements of a gradient (on an H100, with 2e-2 there: 72-88% of the
# limit for both). A dropped key or query tile moves elements by 1 to 4 times the RMS.
BWD_RMS_TOL = 2.0**-5
ENCDEC_BWD_JSON = (1, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 64, False, None, "bfloat16", 64)
ENCDEC_BWD_CASES = (
    ENCDEC_BWD_JSON,
    (1, 16, 16, 1000, 4000, 64, False, None, "bfloat16", 64),
    (1, 16, 16, 4000, 1000, 64, False, None, "bfloat16", 64),
    (2, 16, 16, 37, 1000, 64, False, None, "bfloat16", 64),
)
# A gradient's lean: <got - want, want> / <want, want>, the share of the exact gradient that
# the error adds or takes away along itself. Rounding to nearest leans neither way: the kernels'
# roundings (P and dS to bfloat16 before their products, the gradients once) lean by about
# 2^-8 / sqrt(N) over N elements, 5.7e-5 at the smallest row's dQ (4,736 elements; a CPU model
# of the kernels' rounding gave 1e-5 to 5.3e-5 at these shapes). A key added to or taken from
# every row's softmax moves every gradient along itself: ragged padding keys folded in at 4,000
# keys lean by 4.7e-3 while they stay within 0.7 of the element-wise limit (a share of 0.48% of
# each row's softmax, below bfloat16's half unit of 2^-8). Held at 2^-10, 17x the smallest row's
# noise and a fifth of that fault.
BWD_LEAN_LIMIT = 2.0**-10
BWD_WALK = 64  # the bfloat16 backward's walk tiles at head dim 64: 64 query rows, 64 keys
# the prefills' self-attention of the other serving paths of this slice, timed beside their
# kernels-line entries: seamless's decoder at the 37-token request (causal, group 1) and
# internvl2-2b's at its longest request, 256 patch tokens and a 513-token prompt (16 heads on 8
# KV heads of 128); the phases check that they ran at these lengths
SEAMLESS_SELF_FLASH_JSON = (1, 16, 16, 37, 37, 64, True, None, "bfloat16", 64)
INTERNVL_FLASH_JSON = (1, 16, 8, 769, 769, 128, True, None, "bfloat16", 128)
SERVE_FLASH_TIMED = (SEAMLESS_SELF_FLASH_JSON, INTERNVL_FLASH_JSON)


# the WKV6 backward's kernels (both walks, the chunk pass, du), which ptxas must build with no
# spills and no wgmma serialized
WKV6_BWD_KERNELS = ("wkv6_bwd_walk_kernel", "wkv6_bwd_chunk_kernel", "wkv6_bwd_du_kernel")
# the RG-LRU backward's ring kernels (the forward's states re-walked, then the walk back), held
# the same way
RGLRU_BWD_KERNELS = ("rglru_bwd_states_kernel", "rglru_bwd_ring_kernel")
# the times of the right-first backwards these replaced, at the train shapes (ms; PERF.md §6,
# NVIDIA H100 80GB HBM3, 700.00 W), logged beside the new ones
WKV6_BWD_PR26_MS = "5.5087-5.5600"
RGLRU_BWD_PR25_MS = "0.9007-0.9058"
# the device-side names of the port's kernels (csrc/*.cu), as the profiler reports them
PORT_KERNEL_SYMBOLS = (
    "flash_fwd_wgmma_kernel",
    "flash_fwd_tf32_kernel",
    "flash_merge_kernel",
    "flash_bwd_delta_kernel",
    "flash_bwd_dkdv_wgmma_kernel",
    "flash_bwd_dq_wgmma_kernel",
    "flash_bwd_dkdv_kernel",
    "flash_bwd_dq_kernel",
    "flash_bwd_bf16_delta_kernel",
    *BF16_WGMMA_KERNELS,
    BF16_REDUCE_KERNEL,
    "decode_attention_kernel",
    "rglru_ring_kernel",
    "rglru_step_kernel",
    "wkv6_chunk_kernel",
    "wkv6_stream_kernel",
    *WKV6_BWD_KERNELS,
    *RGLRU_BWD_KERNELS,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls."""
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


def device_us(fn, name=None, launches: int = 50) -> float:
    """Device time of one call of ``fn`` in us, from torch.profiler over ``launches`` calls:
    the kernels whose name holds ``name``, or every kernel the call runs (``name=None``)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and (name is None or name in e.key)
    )
    return us / launches


def _kept_pairs(sq, sk, causal, window) -> int:
    """The (query, key) pairs of one head that the masks keep."""
    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, itemsize, form=None):
    """Least time for one attention forward: max(FLOPs / peak, bytes / bandwidth).

    ``form`` picks the peak: "bf16" the tensor cores' bfloat16 rate; "3xtf32" three TF32
    tensor-core products a float32 one (the form the float32 kernel runs: 3 x FLOPs at
    the TF32 rate); "cuda_core" float32 on the CUDA cores. By default the input's type:
    bfloat16 or 3xTF32."""
    flops = 2.0 * b * hq * _kept_pairs(sq, sk, causal, window) * (d + dv)
    nbytes = itemsize * (b * hq * sq * d + b * hkv * sk * (d + dv) + b * hq * sq * dv)
    form = form or ("bf16" if itemsize == 2 else "3xtf32")
    t_ops = {
        "bf16": flops / PEAK_BF16_FLOPS,
        "3xtf32": 3 * flops / PEAK_TF32_FLOPS,
        "cuda_core": flops / PEAK_F32_FLOPS,
    }[form]
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_floor_ms(b, hq, sq, sk, d, dv, causal, window, rates):
    """The tensor-core floor of the deterministic backward: the seven products it runs over
    the kept pairs, each three TF32 products; S and dP (in the dK/dV kernel and again in the
    dQ kernel) at ``rates[0]`` FLOP/s, dV, dK and dQ at ``rates[1]``. Above
    attention_bwd_bound_ms, which counts the five products of the function at the peak."""
    pairs = 2.0 * b * hq * _kept_pairs(sq, sk, causal, window)
    return 1e3 * 3 * pairs * (2 * (d + dv) / rates[0] + (2 * d + dv) / rates[1])


def attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, itemsize=4):
    """Least time for one attention backward: max(FLOPs / peak, bytes / bandwidth).
    FLOPs: the five products of the FlashAttention-2 form over the (query, key) pairs the
    masks keep (S and dQ, dK over D; dP and dV over Dv), 2 pairs (3D + 2Dv) a head, at the
    bfloat16 peak for bfloat16 inputs (``itemsize`` 2) and three times over at the TF32
    peak for float32 ones (3xTF32); bytes: q, k, v, o, dO read once and dq, dk, dv written
    once in the input type, lse read in float32. Returns (ms, what bounds it, the bytes'
    time alone in ms)."""
    flops = 2.0 * b * hq * _kept_pairs(sq, sk, causal, window) * (3 * d + 2 * dv)
    nbytes = itemsize * (2 * b * hq * sq * (d + dv) + 2 * b * hkv * sk * (d + dv))
    nbytes += 4 * b * hq * sq
    t_ops = flops / PEAK_BF16_FLOPS if itemsize == 2 else 3 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), bound_by, 1e3 * t_bytes


def rglru_bound_ms(b, t, w, itemsize, with_h0):
    """Least time for one RG-LRU scan: bytes / bandwidth (x, a, h0 read; h, hT written).
    Its ~6 flops an element are far below the ridge of any type."""
    nbytes = b * t * w * (itemsize + 4 + itemsize) + b * w * 4 * (2 if with_h0 else 1)
    return 1e3 * nbytes / PEAK_HBM_BYTES, "bytes"


def rglru_bwd_bound_ms(b, t, w, itemsize, with_h0):
    """Least time for one RG-LRU backward: bytes / bandwidth. x, a, dh read and dx, da
    written (a and da in float32, the others in x's type), the final state's gradient and
    h0 read and dh0 written in float32; the float32 states that the kernel recomputes into a
    scratch are its own traffic, not the function's."""
    nbytes = b * t * w * (3 * itemsize + 8) + b * w * 4 * (3 if with_h0 else 2)
    return 1e3 * nbytes / PEAK_HBM_BYTES, "bytes"


def decode_attention_bound_ms(b, h, kv, sc, d, positions, itemsize):
    """Least time for one cached-decode attention step: max(FLOPs / peak of the input
    type, bytes / bandwidth), counting the cache rows each slot's position makes valid
    (min(pos + 1, Sc), for a linear cache and a ring alike): those rows of K and V read
    once, q read and the output written in the input type, pos read."""
    valid = sum(min(p + 1, sc) for p in positions)
    nbytes = itemsize * (valid * kv * d * 2 + 2 * b * h * d) + 4 * b
    flops = 4.0 * valid * (h // kv) * kv * d  # q.k and p.v, 2 flops a multiply-add each
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wkv6_bound_ms(b, h, t, kd, vd, itemsize, with_h0):
    """Least time for one WKV6 pass: max(FLOPs / peak of the input type, bytes / bandwidth).

    Bytes: r, k, v read and the output written in the input type, w read in
    float32, h0 read and the final state written in float32. FLOPs: the
    chunked form (chunk 16) that the kernel and its plain version compute; a
    chunk of c rows does 4cKV (cross term, state update) + 2KV (state decay)
    + 2c^2(K + V) (attention tile, its product with v) + 13cK + 3cV
    (log, cumsum, exps and factors, the bonus, the sums)."""

    def per_chunk(c):
        return 4 * c * kd * vd + 2 * kd * vd + 2 * c * c * (kd + vd) + 13 * c * kd + 3 * c * vd

    full, rem = divmod(t, wk.CHUNK)
    flops = b * h * (full * per_chunk(wk.CHUNK) + (per_chunk(rem) if rem else 0))
    nbytes = b * h * t * ((2 * kd + 2 * vd) * itemsize + 4 * kd)
    nbytes += b * h * kd * vd * 4 * (2 if with_h0 else 1)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wkv6_bwd_bound_ms(b, h, t, kd, vd, itemsize, with_h0, with_ds, form="3xtf32"):
    """Least time for one WKV6 backward: max(FLOPs / peak, bytes / bandwidth); the arithmetic
    is float32 whatever the inputs' type. ``form`` picks the peak: "3xtf32" three TF32
    tensor-core products a float32 one (the form csrc/wkv6_bwd.cu runs its products in: 3 x
    FLOPs at the TF32 rate), "cuda_core" float32 on the CUDA cores.

    Bytes: r, k, v and dout read and dr, dk, dv written in the input type, w read and dw
    written in float32, u read and du written, h0 read and dS0 written and dS_T read in
    float32 where the call has them; the chunk-start states the kernel recomputes into its
    scratch are its own traffic, not the function's. FLOPs: the form csrc/wkv6_bwd.cu computes
    (:func:`_wkv6_bwd_chunk_flops`)."""
    full, rem = divmod(t, wk.CHUNK)
    flops = b * h * (full * _wkv6_bwd_chunk_flops(wk.CHUNK, kd, vd) + (
        _wkv6_bwd_chunk_flops(rem, kd, vd) if rem else 0
    ))
    nbytes = b * h * t * ((4 * kd + 3 * vd) * itemsize + 8 * kd)
    nbytes += 2 * h * kd * itemsize + b * h * kd * vd * 4 * ((2 if with_h0 else 0) + with_ds)
    t_ops = {"3xtf32": 3 * flops / PEAK_TF32_FLOPS, "cuda_core": flops / PEAK_F32_FLOPS}[form]
    t_bytes = nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), by, 1e3 * t_bytes


def _wkv6_bwd_chunk_flops(c, kd, vd):
    """FLOPs of one chunk of ``c`` rows in the backward's form: five K x V products a row (the
    states' walk, S_c dout, dS v, kw dS and the dS update), the 16 x 16 tiles' products over
    the rows that need them (vd for s <= t, A, the intra part of x and y for s < t, their
    product with dout), the pairs that straddle a row in dw, and the per-row factors, scans
    and sums (logs, exps, r^, k^, kw, dr, dk, du, the bonus: ~40 a row and channel)."""
    pairs = c * (c - 1)
    return (
        10 * c * kd * vd
        + 5 * kd * vd
        + c * (c + 1) * vd
        + pairs * vd
        + 3 * pairs * kd
        + 3 * pairs // 2 * kd
        + 40 * c * kd
        + 2 * c * vd
    )


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.monotonic()
    per_kernel = _build.build()
    log(f"[build] {time.monotonic() - t0:.1f} s total; per kernel {per_kernel}")
    for name in per_kernel:
        report = (_build.build_dir() / f"{name}.log").read_text().strip()
        log(f"[build] {name} ptxas:\n{report}")
    report = (_build.build_dir() / "flash_attention_bwd_bf16.log").read_text()
    faults = _ptxas_faults(report, (*BF16_WGMMA_KERNELS, BF16_REDUCE_KERNEL))
    if faults:
        raise AssertionError("[build] the bfloat16 backward's kernels: " + "; ".join(faults))
    log(
        f"[build] {', '.join(BF16_WGMMA_KERNELS)}, {BF16_REDUCE_KERNEL}: no spills, no wgmma "
        "serialized"
    )
    for lib, names in (("wkv6_bwd", WKV6_BWD_KERNELS), ("rglru_bwd", RGLRU_BWD_KERNELS)):
        faults = _ptxas_faults((_build.build_dir() / f"{lib}.log").read_text(), names)
        if faults:
            raise AssertionError(f"[build] the {lib} kernels: " + "; ".join(faults))
        log(f"[build] {', '.join(names)}: no spills, no wgmma serialized")


def _ptxas_faults(report: str, names) -> list:
    """What ptxas's ``-v`` report holds against the kernels whose mangled names contain one
    of ``names``: spill bytes, its notes that it serialized wgmma anywhere in the report
    (C7514, C7515, C7518, ...), and a name that no function of the report carries."""
    faults, seen, current = [], set(), None
    for line in report.splitlines():
        if "Function properties for" in line:
            current = next((n for n in names if n in line), None)
            seen.add(current)
        elif current is not None and "spill" in line:
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            if any(spills):
                faults.append(f"{current}: {line.strip()}")
            current = None
        if "(C75" in line and "serialized" in line:
            faults.append(line.strip())
    faults += [f"{n}: not in ptxas's report" for n in names if n not in seen]
    return faults


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    return rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv)


def _check(label, got, want, tol) -> float:
    """allclose with rtol = atol = tol, as tests/test_kernels.py holds the Pallas kernels."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    within = (diff <= tol * (1 + want.float().abs())).all()
    if not (torch.isfinite(got.float()).all() and within):
        raise AssertionError(f"[kernels] {label}: max |err| {err:.3e}, tol {tol}")
    return err


def _tol_used(got, want, tol) -> float:
    """The largest |err| / (tol (1 + |want|)) over the elements: 1 is at the tolerance."""
    diff = (got.float() - want.float()).abs()
    return (diff / (tol * (1 + want.float().abs()))).max().item()


def _sdpa_backend(q, k, v, mask, is_causal):
    """The backend SDPA's dispatcher picks for these inputs (private API; 'unknown' without it)."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    idx = int(choose(q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=is_causal, enable_gqa=True))
    names = {int(v_): n for n, v_ in torch.nn.attention.SDPBackend.__members__.items()}
    return names.get(idx, str(idx))


def _window_mask(sq, sk, window):
    qpos = torch.arange(sq, device=DEV)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=DEV)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def _flash_rows(gen):
    """Flash kernel vs plain on every case; times at the demo's, the hybrid's, granite's and
    the prefill shapes of SERVE_FLASH_TIMED."""
    cases = [c + (c[5],) for c in FLASH_CASES]  # Dv = D
    cases.append((1, 2, 2, 64, 64, 48, True, None, "float32", 32))  # MLA head dims
    cases += EDGE_CASES + BF16_CASES + F32_CASES
    cases += [(1, 12, 4, s, s, 64, True, None, "float32", 64) for s in DEMO_SEQ]
    cases += HYBRID_FLASH + [GRANITE_FLASH_JSON, *SERVE_FLASH_TIMED]
    rows, demo_err = {}, 0.0
    for case in cases:
        b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
        dtype = getattr(torch, dt)
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} {dt}"
        flags = f"causal={causal} window={window}"
        err = _check(f"flash_attention_fwd {shape} {flags}", got, want, TOL[dt])
        used = _tol_used(got, want, TOL[dt])
        log(
            f"[kernels] flash_attention_fwd {shape} {flags} ({fa.PATHS[dtype]} path): "
            f"max |err| {err:.3e} (tol {TOL[dt]}), {100 * used:.1f}% used"
        )
        demo = (hq, hkv, d) == (12, 4, 64)
        if not demo and case not in (*HYBRID_FLASH, GRANITE_FLASH_JSON, *SERVE_FLASH_TIMED):
            continue
        if demo:
            demo_err = max(demo_err, err)
        mask = None if window is None else _window_mask(sq, sk, window)

        def library(q=q, k=k, v=v, mask=mask, scale=d**-0.5):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=scale, enable_gqa=True
            )

        lib_err = (library().float() - want.float()).abs().max().item()
        backend = _sdpa_backend(q, k, v, mask, mask is None)
        bound, bound_by = attention_bound_ms(
            b, hq, hkv, sq, sk, d, dv, causal, window, q.element_size()
        )
        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return fa.flash_attention_fwd(q, k, v, causal=causal, window=window)

        row = {
            "ms": time_ms(kernel),
            "device_us": device_us(kernel, launches=20),
            "plain_ms": time_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window), iters=5
            ),
            "library_ms": time_ms(library, iters=10),
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        library_msg = f"library_ms (SDPA {backend}, |err| {lib_err:.1e}) {row['library_ms']:.4f}"
        if case == GRANITE_FLASH_JSON:  # the yardstick: SDPA's flash backend
            row["library_default_ms"] = row["library_ms"]
            row["library_ms"], flash_err = _flash_sdpa_ms(q, k, v, want)
            library_msg = (
                f"library_ms (SDPA flash, K/V expanded to {hq} heads, |err| {flash_err:.1e}) "
                f"{row['library_ms']:.4f}, SDPA {backend} (dispatched, enable_gqa) "
                f"{row['library_default_ms']:.4f}"
            )
        if dtype == torch.float32:  # the yardstick: SDPA's memory-efficient backend
            row["library_default_ms"] = row["library_ms"]
            row["library_ms"], eff_err = _efficient_sdpa_ms(q, k, v, mask, want)
            row["bound_cuda_core_ms"] = attention_bound_ms(
                b, hq, hkv, sq, sk, d, dv, causal, window, 4, form="cuda_core"
            )[0]
            faster = "faster" if row["ms"] < row["library_ms"] else "NOT faster"
            row["host_us"] = _host_cost(kernel)[0]
            library_msg = (
                f"library_ms (SDPA memory-efficient, K/V expanded to {hq} heads, |err| "
                f"{eff_err:.1e}) {row['library_ms']:.4f} (kernel {faster}), SDPA {backend} "
                f"(dispatched) {row['library_default_ms']:.4f}, the wrapper's host "
                f"{row['host_us']:.2f} us a call to enqueue, bound on the CUDA cores "
                f"{row['bound_cuda_core_ms']:.5f}"
            )
        rows[("demo", sq) if demo else case] = row
        log(
            f"[kernels]   {'demo S=' + str(sq) if demo else shape}: kernel_ms {row['ms']:.4f} "
            f"(device {row['device_us']:.2f} us a call), "
            f"plain_ms {row['plain_ms']:.4f}, {library_msg}, bound_ms {bound:.5f} ({bound_by}, "
            f"{'3xTF32' if dtype == torch.float32 else 'bf16'} tensor cores), "
            f"kernel/bound {row['ms'] / bound:.1f}"
        )
    _flash_determinism(gen)
    return rows, demo_err


def _efficient_sdpa_ms(q, k, v, mask, want):
    """SDPA on its memory-efficient backend, K and V expanded to q's heads beforehand (not
    timed): its time in ms by CUDA events, and its max |err| against ``want``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // k.shape[1]
    kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    scale = q.shape[-1] ** -0.5

    def efficient():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kx, vx, attn_mask=mask, is_causal=mask is None, scale=scale
        )

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        err = (efficient().float() - want.float()).abs().max().item()
        return time_ms(efficient, iters=10), err


def _flash_sdpa_ms(q, k, v, want):
    """SDPA on its flash backend (causal), K and V expanded to q's heads beforehand (not
    timed): its time in ms by CUDA events, and its max |err| against ``want``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // k.shape[1]
    kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)

    def flash():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kx, vx, is_causal=True, scale=q.shape[-1] ** -0.5
        )

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        err = (flash().float() - want.float()).abs().max().item()
        return time_ms(flash, iters=10), err


def _flash_determinism(gen) -> None:
    """Each path's bits: equal on two launches, and batch row 0 alone (B = 1) equal to
    row 0 of B = 3. A replayed request must give the same answer."""
    for b, hq, hkv, sq, sk, d, causal, window, dt, dv in DETERMINISM_CASES:
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, getattr(torch, dt))
        first = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        again = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        alone = fa.flash_attention_fwd(q[:1], k[:1], v[:1], causal=causal, window=window)
        torch.cuda.synchronize()
        relaunch = (first != again).sum().item()
        batch = (alone != first[:1]).sum().item()
        label = (
            f"flash_attention_fwd q{tuple(q.shape)} {dt} causal={causal} window={window} "
            f"({fa.PATHS[q.dtype]} path)"
        )
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B={b}"
            )
        log(
            f"[kernels] {label}: two launches equal bit for bit; B=1 equals row 0 of B={b} "
            "bit for bit"
        )


def _flash_bwd_inputs(gen, case):
    """q, k, v, dO on the card in the case's dtype, and the plain forward's output in float32
    (the backward's ``out``, as the forward saves it for training) and logsumexp on them."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
    dtype = getattr(torch, dt)
    q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype)
    dout = torch.randn(b, hq, sq, dv, generator=gen, device=DEV).to(dtype)
    out, lse = ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, return_lse=True, out_dtype=torch.float32
    )
    return q, k, v, dout, out, lse


def _flash_bwd_rows(gen):
    """The flash backward against its plain version on every case, on the same inputs (the
    plain forward's output and logsumexp); each case also holds the forward's logsumexp
    against the plain one, and its output with the logsumexp equal bit for bit to its
    output without. At the train shape: the times. Returns the rows of the kernels line."""
    rows = {}
    for case in FLASH_BWD_CASES:
        b, hq, hkv, sq, sk, d, causal, window, _, dv = case
        q, k, v, dout, out, lse = _flash_bwd_inputs(gen, case)
        masks = dict(causal=causal, window=window)
        got_out, got_lse, got_out32 = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
        same = torch.equal(got_out, fa.flash_attention_fwd(q, k, v, **masks))
        same = same and got_out32 is got_out
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
        torch.cuda.synchronize()
        label = f"flash_attention_bwd q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} " + (
            f"float32 causal={causal} window={window} ({fa.bwd_path(d, dv)} path)"
        )
        if not same:
            raise AssertionError(f"[kernels] {label}: the forward's output moved with lse")
        out_err = _check(f"{label} out", got_out, out, TOL["float32"])
        lse_err = _check(f"{label} lse", got_lse, lse, TOL["float32"])
        errs = [_check(f"{label} {n}", g, w, BWD_TOL) for n, g, w in zip("qkv", grads, want)]
        used = max(_tol_used(g, w, BWD_TOL) for g, w in zip(grads, want))
        log(
            f"[kernels] {label}: max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e} (tol {BWD_TOL}), {100 * used:.2f}% used; forward out max |err| "
            f"{out_err:.3e}, lse {lse_err:.3e} (tol {TOL['float32']}), output with lse equal "
            "bit for bit"
        )
        if case == FLASH_BWD_TRAIN:
            rows = _flash_bwd_timed(case, q, k, v, dout, out, lse, want, max(errs), out_err)
    _flash_bwd_determinism(gen)
    return rows


def _flash_bwd_timed(case, q, k, v, dout, out, lse, want, err, out_err):
    """Times at the train shape: the forward with and without its logsumexp, the backward
    against its plain version, SDPA's memory-efficient backward and the bound. ``err`` and
    ``out_err`` are the backward's and the forward's checked max |err|."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    masks = dict(causal=causal, window=window)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)

    lib_ms, lib_err = _efficient_sdpa_bwd_ms(q, k, v, dout, want)
    bound, bound_by, bytes_ms = attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window)
    bwd = {
        "ms": time_ms(kernel, iters=10),
        "device_us": device_us(kernel, launches=10),
        **{f"{n}_us": device_us(kernel, f"flash_bwd_{n}", launches=10) for n in KERNEL_PARTS},
        "plain_ms": time_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks), iters=3,
            warmup=1,
        ),
        "library_ms": lib_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": err,
    }
    floors = {
        name: attention_bwd_floor_ms(b, hq, sq, sk, d, dv, causal, window, rates)
        for name, rates in PROBED_TF32_FLOPS.items()
    }
    fwd_bound, fwd_bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, 4)
    fwd = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **masks), iters=10),
        "ms_without_lse": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **masks), iters=10),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **masks), iters=3, warmup=1),
        "library_ms": _efficient_sdpa_ms(q, k, v, None, out)[0],
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "max_abs_err": out_err,
    }
    parts = ", ".join(f"{n} {bwd[n + '_us']:.2f}" for n in KERNEL_PARTS)
    log(
        f"[kernels]   train shape q{tuple(q.shape)}: backward kernel_ms {bwd['ms']:.4f} "
        f"(device {bwd['device_us']:.2f} us a call: {parts}), plain_ms "
        f"{bwd['plain_ms']:.4f}, library_ms (SDPA memory-efficient backward alone, K/V "
        f"expanded to {hq} heads, |err| {lib_err:.1e}) {bwd['library_ms']:.4f} (kernel "
        f"{'faster' if bwd['ms'] < bwd['library_ms'] else 'NOT faster'}), bound_ms "
        f"{bound:.5f} ({bound_by}, 3xTF32: 3 x FLOPs at 495 TFLOP/s; bytes alone "
        f"{bytes_ms:.5f}), kernel/bound {bwd['ms'] / bound:.1f}; the seven products' tensor "
        "floor at the probed TF32 rates (head-dim / walk products): "
        + ", ".join(
            f"{n} {floors[n]:.5f} ms ({PROBED_TF32_FLOPS[n][0] / 1e12:.0f} / "
            f"{PROBED_TF32_FLOPS[n][1] / 1e12:.0f} TFLOP/s)"
            for n in floors
        )
        + f" ({fa.bwd_path(d, dv)} path)"
    )
    log(
        f"[kernels]   train shape forward: with lse {fwd['ms']:.4f} ms, without "
        f"{fwd['ms_without_lse']:.4f} ms; plain_ms {fwd['plain_ms']:.4f}, library_ms (SDPA "
        f"memory-efficient) {fwd['library_ms']:.4f}, bound_ms {fwd_bound:.5f} ({fwd_bound_by})"
    )
    return {"bwd": bwd, "fwd": fwd}


# flash_bwd_<part>_kernel: the backward's launches at the train shape (the wgmma path)
KERNEL_PARTS = ("delta", "dkdv_wgmma", "dq_wgmma")


def _efficient_sdpa_bwd_ms(q, k, v, dout, want):
    """SDPA's memory-efficient backward alone (its forward run once, not timed), K and V
    expanded to q's heads beforehand: ms by CUDA events, and its max |err| against ``want``
    (dk and dv summed over each group)."""
    from torch.nn.attention import SDPBackend

    sdpa = _sdpa_bwd(q, k, v, dout, SDPBackend.EFFICIENT_ATTENTION)
    err = max((x - w).abs().max().item() for x, w in zip(sdpa["grads"](), want))
    return time_ms(sdpa["backward"], iters=10), err


def _flash_bwd_determinism(gen, case=FLASH_BWD_TRAIN) -> None:
    """The backward's bits: equal on two launches, and batch row 0 alone (B = 1) equal to
    row 0 of B = 4 (the float32 train shape by default)."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
    q, k, v, dout, out, lse = _flash_bwd_inputs(gen, case)
    masks = dict(causal=causal, window=window)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    alone = fa.flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1], dout[:1], **masks)
    torch.cuda.synchronize()
    relaunch = sum((x != y).sum().item() for x, y in zip(first, again))
    batch = sum((x[:1] != y).sum().item() for x, y in zip(first, alone))
    label = (
        f"flash_attention_bwd q{tuple(q.shape)} {dt} causal={causal} "
        f"({fa.bwd_path(d, dv, q.dtype)} path)"
    )
    if relaunch or batch:
        raise AssertionError(
            f"[kernels] {label} not deterministic: {relaunch} gradient elements differ between "
            f"two launches, {batch} between B=1 and row 0 of B={b}"
        )
    log(f"[kernels] {label}: two launches equal bit for bit; B=1 equals row 0 of B={b} bit for bit")


def _share_of_largest(got, want, tol) -> float:
    """max |got - want| as a share of ``tol`` times want's largest entry (tests/
    test_torch_flash_bwd_bf16.py's measure), or times 1 where that entry is smaller, as
    ``_check``'s ``tol (1 + |want|)``: a gradient that is zero up to roundoff (window 1,
    where each row sees its own key alone and dS = 0) is held absolutely. 1 is at the
    tolerance."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / (tol * max(want.float().abs().max().item(), 1.0))


def _flash_bwd_bf16_rows(gen):
    """The bfloat16 backward against its plain version on every case, at BWD_BF16_TOL of
    each gradient's largest entry (:func:`_flash_bwd_bf16_case`); at qwen3-1.7b's,
    granite-moe-3b-a800m's and seamless-m4t-large-v2's decoder's train shapes the times and
    the float64 yardstick; the Δ check on keys with a common component
    (:func:`_common_key_row`). Returns the rows of the kernels line (granite's under
    "granite", seamless's under "seamless")."""
    rows = {}
    for case in FLASH_BWD_BF16_CASES:
        q, k, v, dout, err, out_err = _flash_bwd_bf16_case(gen, case)
        if case == FLASH_BWD_BF16_TRAIN:
            rows.update(_flash_bwd_bf16_timed(case, q, k, v, dout, err, out_err, "qwen3-1.7b"))
        elif case == FLASH_BWD_BF16_GRANITE:
            rows["granite"] = _flash_bwd_bf16_timed(case, q, k, v, dout, err, out_err, MOE_ARCH)
        elif case == FLASH_BWD_BF16_SEAMLESS:
            rows["seamless"] = _flash_bwd_bf16_timed(
                case, q, k, v, dout, err, out_err, f"{SEAMLESS_ARCH} decoder"
            )
    for case in FLASH_BWD_BF16_DETERMINISM:
        _flash_bwd_determinism(gen, case)
    _common_key_row()
    rows["f32_hd128"] = _flash_bwd_f32_hd128(gen)
    return rows


def _check_fwd_f32(label, got_out, got_out32, want32) -> float:
    """The bfloat16 forward's float32 output (``got_out32``) against the plain one at
    TOL["bfloat16"], and rounding to its bfloat16 output bit for bit; returns its max |err|."""
    if got_out32.dtype != torch.float32 or not torch.equal(got_out32.to(got_out.dtype), got_out):
        raise AssertionError(
            f"[kernels] {label}: the float32 output ({got_out32.dtype}) does not round to the "
            "bfloat16 output bit for bit"
        )
    return _check(f"{label} out in float32", got_out32, want32, TOL["bfloat16"])


def _flash_bwd_bf16_case(gen, case):
    """One bfloat16 case: the forward with the logsumexp (its output, its output in float32
    and its lse against the plain ones, the float32 output rounding to the output bit for bit,
    the output unchanged by asking for the lse), then the backward at BWD_BF16_TOL against
    its plain version on the same inputs, both on the plain forward's float32 output and
    logsumexp and on the kernel forward's, as training runs it; returns q, k, v, dout, the
    gradients' max |err| and the output's."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    q, k, v, dout, out32, lse = _flash_bwd_inputs(gen, case)
    masks = dict(causal=causal, window=window)
    got_out, got_lse, got_out32 = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
    same = torch.equal(got_out, fa.flash_attention_fwd(q, k, v, **masks))
    label = f"flash_attention_bwd q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} " + (
        f"bfloat16 causal={causal} window={window} ({fa.bwd_path(d, dv, q.dtype)} path)"
    )
    if not same:
        raise AssertionError(f"[kernels] {label}: the bfloat16 forward's output moved with lse")
    out_err = _check(f"{label} out", got_out, out32.to(q.dtype), TOL["bfloat16"])
    out32_err = _check_fwd_f32(label, got_out, got_out32, out32)
    lse_err = _check(f"{label} lse", got_lse, lse, LSE_BF16_TOL)
    lse_used = _tol_used(got_lse, lse, LSE_BF16_TOL)
    shares, errs = {}, None
    for source, o, l in (("plain", out32, lse), ("kernel", got_out32, got_lse)):
        grads = fa.flash_attention_bwd(q, k, v, o, l, dout, **masks)
        want = ref.flash_attention_bwd_ref(q, k, v, o, l, dout, **masks)
        torch.cuda.synchronize()
        if any(g.dtype != torch.bfloat16 or not torch.isfinite(g.float()).all() for g in grads):
            raise AssertionError(f"[kernels] {label}: gradients {[g.dtype for g in grads]}")
        shares[source] = [_share_of_largest(g, w, BWD_BF16_TOL) for g, w in zip(grads, want)]
        if source == "plain":
            errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
        del grads, want
    if max(max(x) for x in shares.values()) > 1.0:
        raise AssertionError(
            f"[kernels] {label}: max |err| {errs}; shares of {BWD_BF16_TOL} x each gradient's "
            f"largest entry on the plain and the kernel forward's outputs {shares}"
        )
    log(
        f"[kernels] {label}: max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
        f"{100 * max(shares['plain']):.1f}% of the tolerance ({BWD_BF16_TOL:.4g} x each "
        f"gradient's largest entry; on the kernel forward's float32 output and lse "
        f"{100 * max(shares['kernel']):.1f}%); forward out max |err| {out_err:.3e}, in float32 "
        f"{out32_err:.3e} (tol {TOL['bfloat16']}; rounds to out bit for bit), lse "
        f"{lse_err:.3e} (tol {LSE_BF16_TOL}, {100 * lse_used:.1f}% used), output with lse "
        "equal bit for bit"
    )
    return q, k, v, dout, max(errs), out_err


def _flash_bwd_hd256_rows(gen) -> dict:
    """The bfloat16 backward at head dims above 128 (the split builds) on every case, then
    its bits on two launches and for B = 1 against row 0 of B = 4; at the hybrid's train
    shape its time beside its plain version's, SDPA's and the bound, and the float64
    yardstick. Returns the row of the kernels line."""
    plans = {_hd256_parts(case) for case in FLASH_BWD_HD256_CASES}
    if not (1 in plans and max(plans) > 1):
        raise AssertionError(
            f"[kernels] the head-dim-256 cases plan parts {sorted(plans)}: they must hold the "
            "split builds both in one part and in more"
        )
    row = None
    for case in FLASH_BWD_HD256_CASES:
        q, k, v, dout, err, _ = _flash_bwd_bf16_case(gen, case)
        if case == FLASH_BWD_HD256_TRAIN:
            row = _flash_bwd_hd256_timed(case, q, k, v, dout, err)
    _flash_bwd_determinism(gen, FLASH_BWD_HD256_DETERMINISM)
    return row


def _hd256_parts(case) -> int:
    """The parts of each key tile's dK/dV walk that the split builds run a case in."""
    _, hq, hkv, sq, sk, _, causal, window, _, _ = case
    return fa.bwd_split_plan(sq, sk, hq, hkv, causal, window)


def _flash_bwd_hd256_timed(case, q, k, v, dout, err):
    """recurrentgemma-9b's train shape: the backward (on the kernel forward's float32 output
    and logsumexp, as training runs it) against its plain version, SDPA's backward with the window as a boolean mask
    (K and V expanded; the backend its dispatcher picks, named) and the bound; each launch's
    device time; the float64 yardstick."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    masks = dict(causal=causal, window=window)
    _, lse, out = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)

    mask = _window_mask(sq, sk, window)
    g = hq // hkv
    backend = _sdpa_backend(
        q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1), mask, False
    )
    sdpa = _sdpa_bwd(q, k, v, dout, None, mask=mask)
    bound, bound_by, bytes_ms = attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, 2)
    parts = _hd256_parts(case)
    walks = [hq // hkv * n for _, n in fa.bwd_split_walks(sq, sk, causal, window)]
    row = {
        "ms": time_ms(kernel, iters=10),
        "device_us": device_us(kernel, launches=10),
        **{
            f"{n}_us": device_us(kernel, f"flash_bwd_bf16_{n}", launches=10)
            for n in BF16_SPLIT_PARTS
        },
        "plain_ms": time_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks),
            iters=2,
            warmup=1,
        ),
        "library_ms": time_ms(sdpa["backward"], iters=5),
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": err,
    }
    launches = ", ".join(f"{n} {row[n + '_us']:.2f}" for n in BF16_SPLIT_PARTS)
    log(
        f"[kernels]   recurrentgemma-9b train shape: dK/dV grid {len(walks) * parts * hkv * b} "
        f"blocks ({len(walks)} key tiles x {parts} parts x {hkv} KV heads x B {b}), the busiest "
        f"of {fa.BWD_SPLIT_SMS} SMs {fa.bwd_split_longest(walks, parts, hkv)} walk tiles "
        f"({fa.bwd_split_longest(walks, 1, hkv)} with one part; even share "
        f"{sum(walks) * hkv / fa.BWD_SPLIT_SMS:.1f}); dQ grid {-(-sq // 128) * hq * b} blocks "
        f"(pairs of query tiles x {hq} heads x B {b}) on the dK/dV kernel's dS^T tiles"
    )
    log(
        f"[kernels]   recurrentgemma-9b train shape q{tuple(q.shape)} k{tuple(k.shape)} "
        f"bfloat16 window {window}: backward kernel_ms {row['ms']:.4f} (device "
        f"{row['device_us']:.2f} us a call: {launches}; the split builds before their redesign "
        f"{BWD_HD256_BEFORE_MS} ms), plain_ms {row['plain_ms']:.4f}, "
        f"library_ms (SDPA backward alone, the window as a boolean mask, K/V expanded to {hq} "
        f"heads, backend {backend}) {row['library_ms']:.4f} (kernel "
        f"{'faster' if row['ms'] < row['library_ms'] else 'NOT faster'}), bound_ms "
        f"{bound:.5f} ({bound_by}, bf16 tensor cores: 5 products at 989 TFLOP/s; bytes alone "
        f"{bytes_ms:.5f}), kernel/bound {row['ms'] / bound:.1f}"
    )
    _flash_bwd_bf16_yardstick(q, k, v, dout, out, lse, sdpa, masks)
    return row


def _flash_bwd_bf16_timed(case, q, k, v, dout, err, out_err, name):
    """A model's train shape (``name``'s): the bfloat16 forward with and without its
    logsumexp (with it, the float32 output too); the backward (on the kernel forward's float32
    output and logsumexp, as training runs it) against its plain version, SDPA's flash-backend backward and the bound; then the
    float64 yardstick: the kernel's and SDPA's errors against float64 autograd of the dense
    oracle on batch row 0's first KV group, the kernel held to twice SDPA's."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    masks = dict(causal=causal, window=window)
    _, lse, out = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)

    from torch.nn.attention import SDPBackend

    sdpa = _sdpa_bwd(q, k, v, dout, SDPBackend.FLASH_ATTENTION)
    bound, bound_by, _ = attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, 2)
    bwd = {
        "ms": time_ms(kernel, iters=10),
        "device_us": device_us(kernel, launches=10),
        **{
            f"{n}_us": device_us(kernel, f"flash_bwd_bf16_{n}", launches=10)
            for n in BF16_KERNEL_PARTS
        },
        "plain_ms": time_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks),
            iters=3,
            warmup=1,
        ),
        "library_ms": time_ms(sdpa["backward"], iters=10),
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": err,
    }
    fwd_bound, fwd_bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, 2)
    fwd = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **masks), iters=10),
        "ms_without_lse": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **masks), iters=10),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **masks), iters=3, warmup=1),
        "library_ms": time_ms(sdpa["forward"], iters=10),
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "max_abs_err": out_err,
    }
    parts = ", ".join(f"{n} {bwd[n + '_us']:.2f}" for n in BF16_KERNEL_PARTS)
    before = ""
    if case == FLASH_BWD_BF16_TRAIN:
        before = (
            f"; the mma.sync kernel it replaced {BWD_BF16_MMA_SYNC_MS} ms, "
            f"{BWD_BF16_MMA_SYNC_MS / bwd['ms']:.2f}x this one's"
        )
    log(
        f"[kernels]   {name} train shape q{tuple(q.shape)} bfloat16: backward kernel_ms "
        f"{bwd['ms']:.4f} (device {bwd['device_us']:.2f} us a call: {parts}), plain_ms "
        f"{bwd['plain_ms']:.4f}, library_ms (SDPA flash backend backward alone, K/V expanded "
        f"to {hq} heads) {bwd['library_ms']:.4f} (kernel "
        f"{'faster' if bwd['ms'] < bwd['library_ms'] else 'NOT faster'}), bound_ms "
        f"{bound:.5f} ({bound_by}, bf16 tensor cores: 5 products at 989 TFLOP/s), "
        f"kernel/bound {bwd['ms'] / bound:.1f}{before}"
    )
    log(
        f"[kernels]   {name} train shape forward (bfloat16, wgmma): with lse and the float32 "
        f"output {fwd['ms']:.4f} ms, without {fwd['ms_without_lse']:.4f} ms; plain_ms "
        f"{fwd['plain_ms']:.4f}, library_ms (SDPA flash backend, K/V expanded) "
        f"{fwd['library_ms']:.4f}, bound_ms {fwd_bound:.5f} ({fwd_bound_by})"
    )
    _flash_bwd_bf16_yardstick(q, k, v, dout, out, lse, sdpa, masks)
    return {"bwd": bwd, "fwd": fwd}


def _sdpa_bwd(q, k, v, dout, backend, mask=None, causal=True):
    """SDPA on ``backend`` (the dispatcher's choice for None; causal, the boolean ``mask``, or
    with ``causal`` False and no mask none; K and V expanded to q's heads beforehand, which at a
    group of 1 copies them as they are): its forward, its backward alone (the forward
    run once, not timed), and the backward's (dq, dk, dv), dk and dv summed over each group
    in float32 and rounded once to the inputs' dtype."""
    from torch.nn.attention import sdpa_kernel

    g = q.shape[1] // k.shape[1]
    qx = q.detach().clone().requires_grad_(True)
    kx = k.repeat_interleave(g, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(g, dim=1).requires_grad_(True)
    scale = q.shape[-1] ** -0.5

    def forward():
        with contextlib.nullcontext() if backend is None else sdpa_kernel(backend):
            return torch.nn.functional.scaled_dot_product_attention(
                qx, kx, vx, attn_mask=mask, is_causal=causal and mask is None, scale=scale
            )

    o = forward()

    def backward():
        return torch.autograd.grad(o, (qx, kx, vx), dout, retain_graph=True)

    def grads():
        dq, dk, dv = backward()
        b, hkv = k.shape[:2]
        dk = dk.float().reshape(b, hkv, g, *dk.shape[2:]).sum(2).to(k.dtype)
        dv = dv.float().reshape(b, hkv, g, *dv.shape[2:]).sum(2).to(v.dtype)
        return dq, dk, dv

    return {"forward": forward, "backward": backward, "grads": grads}


def _flash_bwd_bf16_yardstick(q, k, v, dout, out, lse, sdpa, masks) -> None:
    """Kernel and SDPA backward against float64 autograd through the dense oracle on batch
    row 0's first KV group (the same bfloat16 inputs): the kernel's error in each gradient
    may be at most twice SDPA's."""
    g = q.shape[1] // k.shape[1]
    kernel = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    lib = sdpa["grads"]()
    sl_q = (slice(0, 1), slice(0, g))
    sl_k = (slice(0, 1), slice(0, 1))
    x64 = [x[sl].double().requires_grad_(True) for x, sl in ((q, sl_q), (k, sl_k), (v, sl_k))]
    o64 = _attention_f64(*x64, **masks)
    want = torch.autograd.grad(o64, x64, dout[sl_q].double())
    parts = []
    for n, a, c, w, sl in zip("qkv", kernel, lib, want, (sl_q, sl_k, sl_k)):
        ka = (a[sl].double() - w).abs().max().item()
        la = (c[sl].double() - w).abs().max().item()
        parts.append(f"d{n} kernel {ka:.3e} SDPA {la:.3e} ({ka / la:.2f}x)")
        if ka > 2 * la:
            raise AssertionError(
                f"[kernels] bfloat16 backward vs float64: d{n} kernel {ka:.3e} > 2 x SDPA {la:.3e}"
            )
    del o64, want, x64
    log(
        f"[kernels]   float64 yardstick (batch row 0, KV head 0's {g} query heads, the dense "
        f"oracle's autograd): max |err| {'; '.join(parts)}; the kernel within 2x SDPA's"
    )


# Keys that share a component 8 times their spread and values offset by 3, the inputs of
# tests/test_torch_flash_bwd_bf16.py::test_delta_from_the_float32_output_keeps_dq_under_a_
# common_key_component (numpy's generator, seed 11; B, H, Sq, Sk, D). A row's dS that does not
# sum to zero reaches dQ = dS K times the common key: Δ from the bfloat16 output sums to
# dO.(O - bf16(O)), and the bfloat16 dS the kernels use to its roundings. Each gradient from
# the float32 output is held within COMMON_KEY_TOL of float64 autograd by relative L2; Δ from
# the bfloat16 output, the fault the float32 output removes, must fail that limit.
COMMON_KEY_CASE = (1, 2, 200, 300, 64)
COMMON_KEY_TOL = 2.0**-8


def _common_key_errors(d):
    """COMMON_KEY_CASE's inputs at head dim ``d`` (numpy's generator, seed 11), the kernel
    forward's outputs, then the relative L2 errors (dq, dk, dv) against float64 autograd of
    dense attention: the backward from the float32 output, from the bfloat16 output (upcast
    by the wrapper), and SDPA's backward as dispatched; and SDPA's backend."""
    rng = np.random.default_rng(11)
    b, h, sq, sk, _ = COMMON_KEY_CASE

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(DEV).bfloat16()

    q = bf16(rng.normal(size=(b, h, sq, d)))
    k = bf16(8 * rng.normal(size=(1, 1, 1, d)) + rng.normal(size=(b, h, sk, d)))
    v = bf16(3 + rng.normal(size=(b, h, sk, d)))
    dout = bf16(rng.normal(size=(b, h, sq, d)))
    want = _grads_f64(q, k, v, dout)
    out, lse, out32 = fa.flash_attention_fwd(q, k, v, causal=False, return_lse=True)

    def rel(grads):
        return [((g.double() - w).norm() / w.norm()).item() for g, w in zip(grads, want)]

    sdpa = _sdpa_bwd(q, k, v, dout, None, causal=False)["grads"]()
    return (
        rel(fa.flash_attention_bwd(q, k, v, out32, lse, dout, causal=False)),
        rel(fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)),
        rel(sdpa),
        _sdpa_backend(q, k, v, None, False),
    )


def _common_key_row() -> None:
    """The bfloat16 kernels' Δ and dQ on keys with a common component (COMMON_KEY_CASE,
    :func:`_common_key_errors`): from the float32 output every gradient within
    COMMON_KEY_TOL; from the bfloat16 output some gradient above it. Then the same inputs at
    head dim 256, the split builds, whose dQ lacks the row-sum step: logged, not held
    (ROADMAP Queue 3)."""
    b, h, sq, sk, d = COMMON_KEY_CASE
    for dim in (d, 256):
        from_f32, from_bf16, lib, backend = _common_key_errors(dim)
        shape = f"q,k,v,dO({b}, {h}, {sq}/{sk}, {dim}) bfloat16 no mask"
        msg = (
            f"relative L2 errors against float64 autograd (dq, dk, dv): Δ from the float32 "
            f"output {', '.join(f'{x:.3e}' for x in from_f32)}, from the bfloat16 output "
            f"{', '.join(f'{x:.3e}' for x in from_bf16)}; SDPA's backward as dispatched "
            f"({backend}) " + ", ".join(f"{x:.3e}" for x in lib)
        )
        if dim != d:
            log(
                f"[kernels] flash_attention_bwd {shape} ({fa.bwd_path(dim, dim, torch.bfloat16)} "
                f"path, the split builds: no row-sum step in dQ), keys with a common component: "
                f"{msg}; not held"
            )
            continue
        if max(from_f32) > COMMON_KEY_TOL or max(from_bf16) <= COMMON_KEY_TOL:
            raise AssertionError(
                f"[kernels] flash_attention_bwd {shape}, keys with a common component: {msg}; "
                f"the limit {COMMON_KEY_TOL:.4g} (from the bfloat16 output it must fail)"
            )
        log(
            f"[kernels] flash_attention_bwd {shape}, keys with a common component 8 times their "
            f"spread, values offset by 3: {msg}; within {COMMON_KEY_TOL:.4g} from the float32 "
            f"output, {max(from_bf16) / COMMON_KEY_TOL:.2f}x that limit from the bfloat16 one"
        )


def _flash_bwd_f32_hd128(gen) -> dict:
    """The float32 backward at head dim 128 (the mma.sync path) at qwen3-1.7b's train shape:
    against its plain version at BWD_TOL, then timed beside its bound and SDPA's
    memory-efficient backward."""
    case = FLASH_BWD_F32_HD128
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    q, k, v, dout, out, lse = _flash_bwd_inputs(gen, case)
    masks = dict(causal=causal, window=window)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)

    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
    label = f"flash_attention_bwd q{tuple(q.shape)} float32 ({fa.bwd_path(d, dv)} path)"
    errs = [_check(f"{label} d{n}", g, w, BWD_TOL) for n, g, w in zip("qkv", kernel(), want)]
    lib_ms, lib_err = _efficient_sdpa_bwd_ms(q, k, v, dout, want)
    bound, bound_by, bytes_ms = attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window)
    row = {
        "ms": time_ms(kernel, iters=5),
        "device_us": device_us(kernel, launches=5),
        "plain_ms": time_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks),
            iters=2,
            warmup=1,
        ),
        "library_ms": lib_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": max(errs),
    }
    log(
        f"[kernels] {label}: max |err| {max(errs):.3e} (tol {BWD_TOL}); kernel_ms "
        f"{row['ms']:.4f} (device {row['device_us']:.2f} us a call), plain_ms "
        f"{row['plain_ms']:.4f}, library_ms (SDPA memory-efficient backward alone, K/V "
        f"expanded, |err| {lib_err:.1e}) {lib_ms:.4f} (kernel "
        f"{'faster' if row['ms'] < lib_ms else 'NOT faster'}), bound_ms {bound:.5f} "
        f"({bound_by}, 3xTF32; bytes alone {bytes_ms:.5f}), kernel/bound {row['ms'] / bound:.1f}"
    )
    return row


def _rglru_inputs(gen, b, t, w, dtype, with_h0):
    x = torch.randn(b, t, w, generator=gen, device=DEV).to(dtype)
    # decays as the model makes them: exp(-8 softplus(lambda) sigmoid(.))
    lam = torch.randn(w, generator=gen, device=DEV)
    r = torch.sigmoid(torch.randn(b, t, w, generator=gen, device=DEV))
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    h0 = torch.randn(b, w, generator=gen, device=DEV) if with_h0 else None
    return x, a, h0


def _rglru_rows(gen):
    """RG-LRU kernels vs plain on every case, bit for bit, each logging the path that
    served it; times at recurrentgemma-9b's prefill and decode shapes."""
    rows = {}
    for case in RGLRU_CASES:
        b, t, w, dt, with_h0 = case
        x, a, h0 = _rglru_inputs(gen, b, t, w, getattr(torch, dt), with_h0)
        got, got_last = rg.rglru_scan(x, a, initial_state=h0)
        want, want_last = ref.rglru_ref(x, a, initial_state=h0)
        torch.cuda.synchronize()
        label = f"rglru_scan x{tuple(x.shape)} {dt} h0={with_h0} ({rg.path_for(t)} path)"
        err = max(_check(label, got, want, TOL[dt]), _check(label, got_last, want_last, TOL[dt]))
        if not (torch.equal(got, want) and torch.equal(got_last, want_last)):
            raise AssertionError(f"[kernels] {label}: not the plain version's bits (|err| {err})")
        msg = f"[kernels] {label}: h and final state equal the plain version bit for bit"
        if case not in RGLRU_TIMED:
            log(msg)
            continue
        bound, bound_by = rglru_bound_ms(b, t, w, x.element_size(), with_h0)

        def kernel(x=x, a=a, h0=h0):
            return rg.rglru_scan(x, a, initial_state=h0)

        row = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda x=x, a=a, h0=h0: ref.rglru_ref(x, a, initial_state=h0), iters=3, warmup=1
            ),
            "library_ms": None,  # no single PyTorch call computes a linear recurrence
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        rows[case] = row
        log(
            f"{msg}; kernel_ms {row['ms']:.4f} (device {device_us(kernel, 'rglru'):.2f} us a "
            f"launch), plain_ms {row['plain_ms']:.4f}, library_ms none, bound_ms {bound:.5f} "
            f"({bound_by}), kernel/bound {row['ms'] / bound:.1f}"
        )
    _rglru_determinism(gen)
    return rows


def _rglru_determinism(gen) -> None:
    """Each path's bits at the model's width: equal on two launches, and batch row 0
    alone (B = 1) equal to row 0 of B = 4, h and final state."""
    for case in RGLRU_DETERMINISM:
        b, t, w, dt, with_h0 = case
        x, a, h0 = _rglru_inputs(gen, b, t, w, getattr(torch, dt), with_h0)
        first = rg.rglru_scan(x, a, initial_state=h0)
        again = rg.rglru_scan(x, a, initial_state=h0)
        alone = rg.rglru_scan(x[:1], a[:1], initial_state=h0[:1])
        torch.cuda.synchronize()
        relaunch = sum((p != q).sum().item() for p, q in zip(first, again))
        batch = sum((p != q[:1]).sum().item() for p, q in zip(alone, first))
        label = f"rglru_scan x{tuple(x.shape)} {dt} ({rg.path_for(t)} path)"
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B={b}"
            )
        log(
            f"[kernels] {label}: h and final state equal bit for bit on two launches and for "
            f"B=1 against row 0 of B={b}"
        )


def _rglru_bwd_inputs(gen, case):
    """x, a, h0 as the forward's cases draw them, the gradients of h (x's type) and of the
    final state (float32)."""
    b, t, w, dt, with_h0 = case
    x, a, h0 = _rglru_inputs(gen, b, t, w, getattr(torch, dt), with_h0)
    dh = torch.randn(b, t, w, generator=gen, device=DEV).to(x.dtype)
    return x, a, h0, dh, torch.randn(b, w, generator=gen, device=DEV)


def _rglru_bwd_rows(gen) -> dict:
    """The RG-LRU backward against its plain version on every case, dx, da and dh0 bit for
    bit; the a = 1 edge (+-inf and NaN where the plain version has them); its bits on two
    launches and for a batch row alone as within a batch of 4; at the hybrid's train shape
    its time beside its plain version's and the bound. Returns the row of the kernels line."""
    row = None
    for case in RGLRU_BWD_CASES + [RGLRU_BWD_EDGE]:
        b, t, w, dt, with_h0 = case
        x, a, h0, dh, dlast = _rglru_bwd_inputs(gen, case)
        edge = case == RGLRU_BWD_EDGE
        if edge:
            a[:, ::3] = 1.0
            x[:, :, ::5] = 0.0
        got = rg.rglru_bwd(x, a, dh, initial_state=h0, dh_last=dlast)
        want = ref.rglru_bwd_ref(x, a, dh, initial_state=h0, dh_last=dlast)
        torch.cuda.synchronize()
        label = f"rglru_bwd x{tuple(x.shape)} {dt} h0={with_h0}" + (" a=1 edge" if edge else "")
        same = [bool(((p == q) | (p.isnan() & q.isnan())).all()) for p, q in zip(got, want)]
        if not all(same):
            errs = [(p.float() - q.float()).abs().max().item() for p, q in zip(got, want)]
            raise AssertionError(f"[kernels] {label}: not the plain version's bits {same} {errs}")
        msg = f"[kernels] {label}: dx, da and dh0 equal the plain version bit for bit"
        if edge:
            da, ones = got[1], a == 1.0
            nonfinite = (~torch.isfinite(da)).sum().item()
            if not (da[ones & (x != 0)].isinf().all() and da[ones & (x == 0)].isnan().all()):
                raise AssertionError(f"[kernels] {label}: da at a = 1 is not +-inf / NaN")
            if (got[0][ones] != 0).any() or nonfinite != int(ones.sum()):
                raise AssertionError(f"[kernels] {label}: dx at a = 1 or the non-finite count")
            msg += f" (NaN where NaN); da +-inf or NaN at the {nonfinite} steps with a = 1"
        if case != RGLRU_BWD_JSON:
            log(msg)
            continue
        bound, bound_by = rglru_bwd_bound_ms(b, t, w, x.element_size(), with_h0)

        def kernel(x=x, a=a, h0=h0, dh=dh, dlast=dlast):
            return rg.rglru_bwd(x, a, dh, initial_state=h0, dh_last=dlast)

        row = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(
                lambda: ref.rglru_bwd_ref(x, a, dh, initial_state=h0, dh_last=dlast),
                iters=2,
                warmup=1,
            ),
            "library_ms": None,  # no single PyTorch call computes a linear recurrence's gradient
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": 0.0,
        }
        scratch_ms = 1e3 * b * t * w * (8 + x.element_size() + 4) / PEAK_HBM_BYTES
        parts = ", ".join(f"{n} {device_us(kernel, n):.2f}" for n in RGLRU_BWD_KERNELS)
        log(
            f"{msg}; kernel_ms {row['ms']:.4f} (device {device_us(kernel, 'rglru_bwd'):.2f} us "
            f"a call: {parts}; PR 25's thread-a-channel kernel: {RGLRU_BWD_PR25_MS}), plain_ms "
            f"{row['plain_ms']:.4f}, library_ms none, bound_ms {bound:.5f} "
            f"({bound_by}; the float32 states it recomputes into its scratch, written and read, "
            f"and x and a read again add {scratch_ms:.5f}), kernel/bound {row['ms'] / bound:.1f}"
        )
    b, t, w, dt, with_h0 = RGLRU_BWD_DETERMINISM
    x, a, h0, dh, dlast = _rglru_bwd_inputs(gen, RGLRU_BWD_DETERMINISM)
    first = rg.rglru_bwd(x, a, dh, initial_state=h0, dh_last=dlast)
    again = rg.rglru_bwd(x, a, dh, initial_state=h0, dh_last=dlast)
    alone = rg.rglru_bwd(x[:1], a[:1], dh[:1], initial_state=h0[:1], dh_last=dlast[:1])
    torch.cuda.synchronize()
    relaunch = sum((p != q).sum().item() for p, q in zip(first, again))
    batch = sum((p[:1] != q).sum().item() for p, q in zip(first, alone))
    label = f"rglru_bwd x{tuple(x.shape)} {dt}"
    if relaunch or batch:
        raise AssertionError(
            f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
            f"launches, {batch} between B=1 and row 0 of B={b}"
        )
    log(
        f"[kernels] {label}: dx, da and dh0 equal bit for bit on two launches and for B=1 "
        f"against row 0 of B={b}"
    )
    return row


def _decode_inputs(gen, b, h, kv, sc, d, dtype, positions):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    return rnd(b, h, d), rnd(b, sc, kv, d), rnd(b, sc, kv, d), pos


def _decode_valid(sc, window, pos):
    """(B, Sc) validity of each cache slot, as the plain version masks it."""
    idx = torch.arange(sc, device=DEV)
    if window and sc == window:
        ages = torch.remainder(pos[:, None] - idx[None, :], window)
        return ages < torch.clamp(pos + 1, max=window)[:, None]
    return idx[None, :] <= pos[:, None]


def _decode_attention_rows(gen):
    """Decode-attention kernel vs its plain version on every case, with the share of the
    tolerance used; times at the demo's and the hybrid's decode shapes, with the device
    time of a launch against that of the plain version's ops."""
    rows = {}
    for case in DECODE_CASES:
        b, h, kv, sc, d, window, dt, positions = case
        q, k, v, pos = _decode_inputs(gen, b, h, kv, sc, d, getattr(torch, dt), positions)
        got = da.decode_attention(q, k, v, pos, window=window)
        want = ref.decode_attention_ref(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        label = (
            f"decode_attention q{tuple(q.shape)} cache{tuple(k.shape)} {dt} window={window} "
            f"pos={list(positions)}"
        )
        err = _check(label, got, want, TOL[dt])
        used = _tol_used(got, want, TOL[dt])
        msg = f"[kernels] {label}: max |err| {err:.3e} (tol {TOL[dt]}), {100 * used:.0f}% used"
        if case not in DECODE_TIMED:
            log(msg)
            continue
        mask = _decode_valid(sc, window, pos)[:, None, None, :]  # (B, 1, 1, Sc)
        kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # (B, KV, Sc, D) views

        def kernel(q=q, k=k, v=v, pos=pos, window=window):
            return da.decode_attention(q, k, v, pos, window=window)

        def plain(q=q, k=k, v=v, pos=pos, window=window):
            return ref.decode_attention_ref(q, k, v, pos, window=window)

        def library(q=q[:, :, None], kt=kt, vt=vt, mask=mask, scale=d**-0.5):
            return torch.nn.functional.scaled_dot_product_attention(
                q, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True
            )

        lib_err = (library()[:, :, 0].float() - want.float()).abs().max().item()
        bound, bound_by = decode_attention_bound_ms(b, h, kv, sc, d, positions, q.element_size())
        row = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain, iters=10),
            "library_ms": time_ms(library, iters=10),
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
            "device_us": device_us(kernel),
        }
        rows[case] = row
        log(
            f"{msg}; kernel_ms {row['ms']:.4f} (device {row['device_us']:.2f} us a call, one "
            f"launch), plain_ms {row['plain_ms']:.4f} (device "
            f"{device_us(plain):.2f} us a call), library_ms (SDPA "
            f"{_sdpa_backend(q[:, :, None], kt, vt, mask, False)}, |err| {lib_err:.1e}) "
            f"{row['library_ms']:.4f}, bound_ms {bound:.5f} ({bound_by}), "
            f"kernel/bound {row['ms'] / bound:.1f}"
        )
    _decode_attention_determinism(gen)
    return rows


def _decode_attention_determinism(gen) -> None:
    """The kernel's bits at the demo's and the hybrid's shapes: equal on two launches, and
    slot 0 alone (B = 1) equal to slot 0 of B = 4."""
    for case in DECODE_DETERMINISM:
        b, h, kv, sc, d, window, dt, positions = case
        q, k, v, pos = _decode_inputs(gen, b, h, kv, sc, d, getattr(torch, dt), positions)
        first = da.decode_attention(q, k, v, pos, window=window)
        again = da.decode_attention(q, k, v, pos, window=window)
        alone = da.decode_attention(q[:1], k[:1], v[:1], pos[:1], window=window)
        torch.cuda.synchronize()
        relaunch = (first != again).sum().item()
        batch = (alone != first[:1]).sum().item()
        label = f"decode_attention q{tuple(q.shape)} cache{tuple(k.shape)} {dt} window={window}"
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B={b}"
            )
        log(
            f"[kernels] {label}: two launches equal bit for bit; B=1 equals row 0 of B={b} "
            "bit for bit"
        )


def _wkv6_inputs(gen, b, h, t, kd, vd, dtype, with_h0):
    """r, k, v, w in the model's layout, (B, T, H, .) seen as (B, H, T, .); decays
    as the model makes them, exp(clamp(-exp(clip(x, -20, 1.3863)), -4, -1e-4))."""

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    r, k = (rnd(b, t, h, kd).to(dtype).transpose(1, 2) for _ in range(2))
    v = rnd(b, t, h, vd).to(dtype).transpose(1, 2)
    logw = -torch.exp(torch.clamp(rnd(b, t, h, kd), -20.0, 1.3863))
    w = torch.exp(torch.clamp(logw, -4.0, -1e-4)).transpose(1, 2)
    u = (0.5 * rnd(h, kd)).to(dtype)
    h0 = rnd(b, h, kd, vd) if with_h0 else None
    return r, k, v, w, u, h0


def _wkv6_rows(gen):
    """WKV6 kernels vs their plain version on every case, each logging the path that
    served it; times at rwkv6-7b's shapes. The final state is float32 on both sides
    and is held to the float32 tolerance."""
    rows = {}
    for case in WKV_CASES:
        b, h, t, kd, vd, dt, with_h0 = case
        r, k, v, w, u, h0 = _wkv6_inputs(gen, b, h, t, kd, vd, getattr(torch, dt), with_h0)
        got, got_state = wk.wkv6_chunked(r, k, v, w, u, initial_state=h0)
        want, want_state = ref.wkv6_chunked_ref(r, k, v, w, u, initial_state=h0)
        torch.cuda.synchronize()
        label = f"wkv6_chunked r{tuple(r.shape)} v{tuple(v.shape)} {dt} h0={with_h0}"
        err = _check(label, got, want, TOL[dt])
        state_err = _check(label + " state", got_state, want_state, TOL["float32"])
        used = max(_tol_used(got, want, TOL[dt]), _tol_used(got_state, want_state, TOL["float32"]))
        msg = (
            f"[kernels] {label} ({wk.path_for(t)} path): max |err| {err:.3e} (tol {TOL[dt]}), "
            f"state {state_err:.3e}; {100 * used:.0f}% of the tolerance used"
        )
        if case not in WKV_TIMED:
            log(msg)
            continue
        bound, bound_by = wkv6_bound_ms(b, h, t, kd, vd, r.element_size(), with_h0)

        def kernel(r=r, k=k, v=v, w=w, u=u, h0=h0):
            return wk.wkv6_chunked(r, k, v, w, u, initial_state=h0)

        def plain(r=r, k=k, v=v, w=w, u=u, h0=h0):
            return ref.wkv6_chunked_ref(r, k, v, w, u, initial_state=h0)

        row = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain, iters=3, warmup=1),
            "library_ms": None,  # no PyTorch call computes this recurrence
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": max(err, state_err),
        }
        rows[case] = row
        log(
            f"{msg}; kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, library_ms none, "
            f"bound_ms {bound:.5f} ({bound_by}), kernel/bound {row['ms'] / bound:.1f}"
        )
    _wkv6_determinism(gen)
    _wkv6_host_cost(gen)
    return rows


def _wkv6_determinism(gen) -> None:
    """Each path's bits at the model's widths: equal on two launches, and batch row 0
    alone (B = 1) equal to row 0 of B = 4, output and final state."""
    for case in WKV_DETERMINISM:
        b, h, t, kd, vd, dt, with_h0 = case
        r, k, v, w, u, h0 = _wkv6_inputs(gen, b, h, t, kd, vd, getattr(torch, dt), with_h0)
        first = wk.wkv6_chunked(r, k, v, w, u, initial_state=h0)
        again = wk.wkv6_chunked(r, k, v, w, u, initial_state=h0)
        alone = wk.wkv6_chunked(r[:1], k[:1], v[:1], w[:1], u, initial_state=h0[:1])
        torch.cuda.synchronize()
        relaunch = sum((x != y).sum().item() for x, y in zip(first, again))
        batch = sum((x != y[:1]).sum().item() for x, y in zip(alone, first))
        label = f"wkv6_chunked r{tuple(r.shape)} {dt} ({wk.path_for(t)} path)"
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B={b}"
            )
        log(
            f"[kernels] {label}: output and state equal bit for bit on two launches and for "
            f"B=1 against row 0 of B={b}"
        )


WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "dS0")
# wkv6_bwd_<part>_kernel: the WKV6 backward's launches
WKV6_BWD_PARTS = ("walk", "chunk", "du")


def _wkv6_bwd_inputs(gen, case, deep=False):
    """The forward's operands as _wkv6_inputs draws them (``deep``: log w in U(-4, -3.9)), the
    output's gradient in their dtype and the final state's in float32 or None."""
    b, h, t, kd, vd, dt, with_h0, with_ds = case
    r, k, v, w, u, h0 = _wkv6_inputs(gen, b, h, t, kd, vd, getattr(torch, dt), with_h0)
    if deep:
        logw = -3.9 - 0.1 * torch.rand(b, t, h, kd, generator=gen, device=DEV)
        w = torch.exp(logw).transpose(1, 2)
    dout = torch.randn(b, t, h, vd, generator=gen, device=DEV).to(r.dtype).transpose(1, 2)
    ds = torch.randn(b, h, kd, vd, generator=gen, device=DEV) if with_ds else None
    return r, k, v, w, u, h0, dout, ds


def _wkv6_bwd_case(label, got, want, tol) -> float:
    """Each gradient within ``tol`` times its plain version's largest entry, every entry
    finite; returns the largest share of its tolerance that a gradient used."""
    used = 0.0
    for name, g, p in zip(WKV_BWD_NAMES, got, want, strict=True):
        if g is None or p is None:
            if (g is None) != (p is None):
                raise AssertionError(f"[kernels] {label}: {name} is None on one side only")
            continue
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"[kernels] {label}: {name} has non-finite entries")
        scale = p.float().abs().max().clamp_min(1e-30)
        err = (g.float() - p.float()).abs().max()
        share = (err / (tol * scale)).item()
        if share > 1:
            raise AssertionError(
                f"[kernels] {label}: {name} max |err| {err.item():.3e} > {tol} x its largest "
                f"entry {scale.item():.3e}"
            )
        used = max(used, share)
    return used


def _wkv6_bwd_f64_errors(r, k, v, w, u, h0, dout, ds, grads):
    """Relative L2 error of each gradient in ``grads`` (a list of 6-tuples) against float64
    autograd through ref.wkv6_ref on the same (upcast) inputs."""
    leaves = [x.double().requires_grad_(True) for x in (r, k, v, w, u)]
    if h0 is not None:
        leaves.append(h0.double().requires_grad_(True))
    out, state = ref.wkv6_ref(*leaves[:5], initial_state=leaves[5] if h0 is not None else None)
    loss = (out * dout.double()).sum() + ((state * ds.double()).sum() if ds is not None else 0)
    want = torch.autograd.grad(loss, leaves)
    del out, state, loss, leaves
    errs = []
    for got in grads:
        errs.append(
            [
                ((g.double() - x).norm() / x.norm().clamp_min(1e-300)).item()
                for g, x in zip(got, want)
            ]
        )
    return errs


def _wkv6_bwd_rows(gen) -> dict:
    """The WKV6 backward against its plain version on every case, each gradient within TOL of
    its largest entry, and on the float32 cases both against float64; the deep-decay case
    finite where autodiff through the chunked form is not; its bits on two launches and for a
    batch row alone as within a batch of 4; at the train shape its time beside its plain
    version's and the bound. Returns the row of the kernels line."""
    row, worst = None, (0.0, "", 0.0)  # the kernel's float64 error over the plain's; where
    for case in WKV_BWD_CASES + [WKV_BWD_DEEP]:
        b, h, t, kd, vd, dt, with_h0, with_ds = case
        deep = case == WKV_BWD_DEEP
        r, k, v, w, u, h0, dout, ds = _wkv6_bwd_inputs(gen, case, deep)
        got = wk.wkv6_bwd(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)
        want = ref.wkv6_bwd_ref(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)
        want = want[:5] + (want[5] if h0 is not None else None,)
        torch.cuda.synchronize()
        label = (
            f"wkv6_bwd r{tuple(r.shape)} v{tuple(v.shape)} {dt} h0={with_h0} dS_T={with_ds}"
            + (" log w in U(-4, -3.9)" if deep else "")
        )
        used = _wkv6_bwd_case(label, got, want, TOL[dt])
        msg = f"[kernels] {label}: {100 * used:.0f}% of the tolerance ({TOL[dt]} of each largest)"
        if dt == "float32":
            err = _wkv6_bwd_f64_errors(r, k, v, w, u, h0, dout, ds, [got, want])
            for name, g, q in zip(WKV_BWD_NAMES, *err):
                ratio = g / max(q, WKV_BWD_F64_FLOOR)
                if ratio > WKV_BWD_F64_RATIO:
                    raise AssertionError(f"[kernels] {label}: {name} against float64 {err}")
                if ratio > worst[0]:
                    worst = (ratio, f"{name} of {label}", g)
        if deep:
            leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w, u, h0)]
            out, state = ref.wkv6_chunked_ref(*leaves[:5], initial_state=leaves[5])
            auto = torch.autograd.grad((out * dout).sum() + (state * ds).sum(), leaves)
            bad = int((~torch.isfinite(auto[3])).sum())
            msg += (
                f"; every entry finite, where autodiff through ref.wkv6_chunked_ref gives {bad} "
                f"non-finite dw entries of {auto[3].numel()}; relative L2 against float64 "
                + ", ".join(f"{n} {g:.2e} (plain {q:.2e})" for n, g, q in zip(WKV_BWD_NAMES, *err))
            )
        if case != WKV_BWD_JSON:
            log(msg)
            continue
        bound, bound_by, bytes_ms = wkv6_bwd_bound_ms(
            b, h, t, kd, vd, r.element_size(), with_h0, with_ds
        )

        def kernel(r=r, k=k, v=v, w=w, u=u, h0=h0, dout=dout, ds=ds):
            return wk.wkv6_bwd(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)

        def plain(r=r, k=k, v=v, w=w, u=u, h0=h0, dout=dout, ds=ds):
            return ref.wkv6_bwd_ref(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)

        err = max(
            (g.float() - p.float()).abs().max().item()
            for g, p in zip(got, want)
            if g is not None
        )
        row = {
            "ms": time_ms(kernel, iters=10),
            "plain_ms": time_ms(plain, iters=1, warmup=0),  # warm: it gave ``want`` above
            "library_ms": None,  # no PyTorch call computes this gradient
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        cuda_core, cuda_core_by, _ = wkv6_bwd_bound_ms(
            b, h, t, kd, vd, r.element_size(), with_h0, with_ds, form="cuda_core"
        )
        scratch_ms = 1e3 * 4 * b * h * -(-t // wk.CHUNK) * kd * vd * 4 / PEAK_HBM_BYTES
        dev_us = device_us(kernel, "wkv6_bwd", 10)
        parts = {n: device_us(kernel, f"wkv6_bwd_{n}_kernel", 10) for n in WKV6_BWD_PARTS}
        lib, bf16 = wk._bwd_lib(), int(r.dtype == torch.bfloat16)
        log(
            f"{msg}; kernel_ms {row['ms']:.4f} (device {dev_us:.2f} us a call: "
            + ", ".join(f"{n} {us:.2f}" for n, us in parts.items())
            + f"; PR 26's one-block-a-head kernel: {WKV6_BWD_PR26_MS}), plain_ms "
            f"{row['plain_ms']:.4f}, library_ms none, bound_ms {bound:.5f} ({bound_by}, the "
            f"tensor-core form: 3xTF32 at 495 TFLOP/s; bytes alone {bytes_ms:.5f}; on the CUDA "
            f"cores {cuda_core:.5f}, {cuda_core_by}; the chunk-start states and chunk-end "
            f"gradients it writes into its scratch and reads back add {scratch_ms:.5f}), "
            f"kernel/bound {row['ms'] / bound:.1f}; shared memory a block: walk "
            f"{lib.repro_wkv6_bwd_shared_bytes(0, bf16)}, chunk "
            f"{lib.repro_wkv6_bwd_shared_bytes(1, bf16)} bytes"
        )
    log(
        "[kernels] wkv6_bwd against float64 autograd through ref.wkv6_ref on every float32 case, "
        f"each gradient's relative L2 error at most {WKV_BWD_F64_RATIO}x the plain version's "
        f"(floored at {WKV_BWD_F64_FLOOR}): the largest ratio {worst[0]:.3f} ({worst[1]}, "
        f"{worst[2]:.2e})"
    )
    _wkv6_bwd_determinism(gen)
    return row


def _wkv6_bwd_determinism(gen) -> None:
    """The backward's bits at the model's widths: every gradient equal on two launches, and
    batch row 0 alone (B = 1) equal to row 0 of B = 4 in dr, dk, dv, dw and dS0 (du sums over
    the batch)."""
    case = WKV_BWD_DETERMINISM
    r, k, v, w, u, h0, dout, ds = _wkv6_bwd_inputs(gen, case)
    first = wk.wkv6_bwd(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)
    again = wk.wkv6_bwd(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)
    alone = wk.wkv6_bwd(
        r[:1], k[:1], v[:1], w[:1], u, dout[:1], initial_state=h0[:1], ds_last=ds[:1]
    )
    torch.cuda.synchronize()
    relaunch = sum((x != y).sum().item() for x, y in zip(first, again))
    batch = sum((x[:1] != y).sum().item() for i, (x, y) in enumerate(zip(first, alone)) if i != 4)
    label = f"wkv6_bwd r{tuple(r.shape)} {case[5]}"
    if relaunch or batch:
        raise AssertionError(
            f"[kernels] {label} not deterministic: {relaunch} elements differ between two "
            f"launches, {batch} between B=1 and row 0 of B={case[0]}"
        )
    log(
        f"[kernels] {label}: dr, dk, dv, dw, du and dS0 equal bit for bit on two launches; dr, "
        f"dk, dv, dw and dS0 for B=1 equal row 0 of B={case[0]}"
    )


def _host_cost(fn, calls: int = 200):
    """(host us a call to enqueue, CUDA events us a call) of ``fn`` over ``calls`` calls:
    the host clock stops before the device is done, the events at the device's pace."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    end.synchronize()
    return host_us, 1e3 * start.elapsed_time(end) / calls


def _wkv6_host_cost(gen, calls: int = 200) -> None:
    """The wrapper's cost a call at the decode shape: host clock (the host returns
    before the device is done) against CUDA events (the device's pace)."""
    b, h, t, kd, vd, dt, with_h0 = WKV_CASES[7]
    r, k, v, w, u, h0 = _wkv6_inputs(gen, b, h, t, kd, vd, getattr(torch, dt), with_h0)
    host_us, event_us = _host_cost(lambda: wk.wkv6_chunked(r, k, v, w, u, initial_state=h0), calls)
    log(
        f"[kernels] wkv6_chunked r{tuple(r.shape)} {dt} ({wk.path_for(t)} path): host "
        f"{host_us:.2f} us a call to enqueue, CUDA events {event_us:.2f} us a call, "
        f"over {calls} calls"
    )


def phase_kernels():
    gen = _gen(7)
    flash_rows, demo_err = _flash_rows(gen)
    bwd_rows = _flash_bwd_rows(gen)
    bwd_rows["bf16"] = _flash_bwd_bf16_rows(gen)
    bwd_rows["bf16_hd256"] = _flash_bwd_hd256_rows(gen)
    decode_rows, rglru_rows = _decode_attention_rows(gen), _rglru_rows(gen)
    rglru_rows["bwd"] = _rglru_bwd_rows(gen)
    wkv6_rows = _wkv6_rows(gen)
    wkv6_rows["bwd"] = _wkv6_bwd_rows(gen)
    flash_rows.update(_mla_flash_rows(gen))
    flash_rows.update(_encdec_flash_rows(gen))
    bwd_rows["mla_train"] = _mla_train_rows(gen)
    bwd_rows["encdec"] = _encdec_bwd_rows(gen)
    return flash_rows, demo_err, bwd_rows, decode_rows, rglru_rows, wkv6_rows


def _mla_flash_rows(gen) -> dict:
    """The bfloat16 flash forward at MLA's shapes (MLA_FLASH_CASES: key head dim 192, value
    head dim 128, 128 heads, the explicit scale): against its plain version at the bfloat16
    tolerance with the share of it used; equal bits on two launches and for a batch row alone
    as within a batch of 3; kernel ms, device us a call, plain ms, SDPA's ms on the backend
    its dispatcher picks for Dv != D (named), the bound and the DC = 4 build's own floor (its
    QK^T over 256 columns)."""
    rows = {}
    for case in MLA_FLASH_CASES:
        b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, torch.bfloat16)

        def kernel(q=q, k=k, v=v):
            return fa.flash_attention_fwd(q, k, v, causal=True, scale=MLA_SCALE)

        got = kernel()
        want = ref.flash_attention_ref(q, k, v, causal=True, scale=MLA_SCALE)
        shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} {dt} causal scale 192^-0.5"
        err = _check(f"flash_attention_fwd {shape}", got, want, TOL[dt])
        used = _tol_used(got, want, TOL[dt])
        q3, k3, v3 = _inputs(gen, 3, hq, hkv, sq, sk, d, dv, torch.bfloat16)
        first = fa.flash_attention_fwd(q3, k3, v3, causal=True, scale=MLA_SCALE)
        again = fa.flash_attention_fwd(q3, k3, v3, causal=True, scale=MLA_SCALE)
        alone = fa.flash_attention_fwd(q3[:1], k3[:1], v3[:1], causal=True, scale=MLA_SCALE)
        relaunch, batch = (first != again).sum().item(), (alone != first[:1]).sum().item()
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] flash_attention_fwd {shape}: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B=3"
            )
        del q3, k3, v3, first, again, alone

        def library(q=q, k=k, v=v):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=MLA_SCALE
            )

        backend = _sdpa_backend(q, k, v, None, True)
        lib_err = (library().float() - want.float()).abs().max().item()
        bound, bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, True, None, 2)
        floor = attention_bound_ms(b, hq, hkv, sq, sk, 256, dv, True, None, 2)[0]
        row = {
            "ms": time_ms(kernel),
            "device_us": device_us(kernel, launches=20),
            "plain_ms": time_ms(
                lambda q=q, k=k, v=v: ref.flash_attention_ref(
                    q, k, v, causal=True, scale=MLA_SCALE
                ),
                iters=5,
            ),
            "library_ms": time_ms(library, iters=10),
            "library_backend": backend,
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        rows[case] = row
        log(
            f"[kernels] flash_attention_fwd {shape} (MLA, {fa.PATHS[torch.bfloat16]} path, the "
            f"DC = 4 build): max |err| {err:.3e} (tol {TOL[dt]}), {100 * used:.1f}% used; two "
            f"launches equal bit for bit, B=1 equals row 0 of B=3 bit for bit; kernel_ms "
            f"{row['ms']:.4f} (device {row['device_us']:.2f} us a call), plain_ms "
            f"{row['plain_ms']:.4f}, library_ms (SDPA {backend}, dispatched for Dv != D, |err| "
            f"{lib_err:.1e}) {row['library_ms']:.4f}, bound_ms {bound:.5f} ({bound_by}, bf16 "
            f"tensor cores), the DC = 4 build's floor (QK^T over 256 columns) {floor:.5f}, "
            f"kernel/bound {row['ms'] / bound:.1f}"
        )
    return rows


def _scaled_used(got, want, rms_tol=TOL["bfloat16"]) -> float:
    """The largest |got - want| / (SCALED_RTOL |want| + rms_tol * rms(want)) over the elements:
    1 is at the limit the flash rows without a mask are held to."""
    w = want.float()
    limit = SCALED_RTOL * w.abs() + rms_tol * w.square().mean().sqrt()
    return ((got.float() - w).abs() / limit).max().item()


def _planted_faults(q, k, v, want) -> dict:
    """The share of the scaled limit that each planted fault of a walk without a mask reads,
    by name: the plain version with the walk's last key tile dropped (walks of more than one
    tile), and with the ragged last tile's padding keys and values, zeros, folded into the
    softmax (Sk no multiple of KEY_TILE)."""
    sk = k.shape[2]
    tail = sk - KEY_TILE * ((sk - 1) // KEY_TILE)  # keys in the walk's last tile
    faults = {}
    if sk > KEY_TILE:
        kept = sk - tail
        faults["last key tile dropped"] = (k[:, :, :kept], v[:, :, :kept])
    if tail < KEY_TILE:
        pad = (0, 0, 0, KEY_TILE - tail)
        faults["padding keys folded in"] = (
            torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        )
    return {
        name: _scaled_used(ref.flash_attention_ref(q, kf, vf, causal=False), want)
        for name, (kf, vf) in faults.items()
    }


def _encdec_flash_rows(gen) -> dict:
    """The bfloat16 flash forward without a mask at seamless-m4t-large-v2's shapes: its
    encoder's self-attention at the batch-4 prefill (ENCODER_FLASH_JSON), the cross-attention
    of a decode step, one query row against 4,096 source rows (CROSS_DECODE_JSON), and a ragged
    request's prefill cross-attention (CROSS_PREFILL_JSON), then the edges ENCDEC_FLASH_EDGES:
    each against its plain version within SCALED_RTOL |want| + TOL * rms(want), with the share
    of that limit used, and with the share each planted fault reads (each must fail it). The
    timed rows also give equal bits on two launches and for batch row 0 alone as within the
    batch, kernel ms, device us a call, plain ms, SDPA's ms on the backend its dispatcher picks
    (named) and the bound."""
    rows = {}
    for case in (*ENCDEC_FLASH_TIMED, *ENCDEC_FLASH_EDGES):
        b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, torch.bfloat16)

        def kernel(q=q, k=k, v=v):
            return fa.flash_attention_fwd(q, k, v, causal=False)

        got = kernel()
        want = ref.flash_attention_ref(q, k, v, causal=False)
        shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} {dt} no mask"
        err = (got.float() - want.float()).abs().max().item()
        used, rms = _scaled_used(got, want), want.float().square().mean().sqrt().item()
        faults = _planted_faults(q, k, v, want)
        limit = f"2^-7 |want| + {TOL[dt]} x rms {rms:.4f}"
        if not torch.isfinite(got.float()).all() or used > 1.0:
            raise AssertionError(
                f"[kernels] flash_attention_fwd {shape}: max |err| {err:.3e}, {100 * used:.1f}% "
                f"of the limit {limit}"
            )
        if min(faults.values()) <= 1.0:
            raise AssertionError(
                f"[kernels] flash_attention_fwd {shape}: a planted fault passes the limit "
                f"{limit}: {faults}"
            )
        msg = (
            f"[kernels] flash_attention_fwd {shape} ({fa.PATHS[torch.bfloat16]} path): max |err| "
            f"{err:.3e}, {100 * used:.1f}% of the limit {limit}; planted faults read "
            + ", ".join(f"{name} {x:.1f}x the limit" for name, x in faults.items())
        )
        if case in ENCDEC_FLASH_EDGES:
            log(msg)
            continue
        again, alone = kernel(), fa.flash_attention_fwd(q[:1], k[:1], v[:1], causal=False)
        relaunch, batch = (got != again).sum().item(), (alone != got[:1]).sum().item()
        if relaunch or batch:
            raise AssertionError(
                f"[kernels] flash_attention_fwd {shape}: {relaunch} elements differ between two "
                f"launches, {batch} between B=1 and row 0 of B={b}"
            )

        def library(q=q, k=k, v=v):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=False)

        backend = _sdpa_backend(q, k, v, None, False)
        lib_err = (library().float() - want.float()).abs().max().item()
        bound, bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, False, None, 2)
        row = {
            "ms": time_ms(kernel),
            "device_us": device_us(kernel, launches=20),
            "plain_ms": time_ms(
                lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v, causal=False), iters=5
            ),
            "library_ms": time_ms(library, iters=10),
            "library_backend": backend,
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        rows[case] = row
        blocks = b * hq * -(-sq // 128)
        log(
            f"{msg}; two launches equal bit for bit, B=1 equals row 0 of B={b} bit for bit; "
            f"kernel_ms {row['ms']:.4f} (device {row['device_us']:.2f} us a call, {blocks} blocks "
            f"of 128 query rows, each walking {-(-sk // KEY_TILE)} key tiles), plain_ms "
            f"{row['plain_ms']:.4f}, library_ms (SDPA {backend}, dispatched, |err| {lib_err:.1e}) "
            f"{row['library_ms']:.4f}, bound_ms {bound:.5f} ({bound_by}, bf16 tensor cores, "
            f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s), kernel/bound {row['ms'] / bound:.1f}"
        )
    return rows


def _attention_f64(q, k, v, causal=False, window=None, scale=None):
    """Dense attention in float64 for autograd, with ``ref._mask``'s masks: the exact function
    the bfloat16 kernels are held to (``ref.flash_attention_dense_ref`` computes in float32
    whatever its inputs' type)."""
    g = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kx, vx = (x.repeat_interleave(g, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kx) * scale
    sq, sk = q.shape[2], k.shape[2]
    valid = ref._mask(sq, torch.arange(sk, device=q.device), sk, causal, window)
    s = s.masked_fill(~valid, -torch.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vx)


def _grads_f64(q, k, v, dout, **masks):
    """(dq, dk, dv) of :func:`_attention_f64` on the bfloat16 inputs, in float64."""
    x64 = [x.double().requires_grad_(True) for x in (q, k, v)]
    out = _attention_f64(*x64, **masks)
    return torch.autograd.grad(out, x64, dout.double())


def _bwd_used(got, want) -> float:
    """The share of its limit that a gradient uses: the larger of the element-wise
    :func:`_scaled_used` at BWD_RMS_TOL and its lean, |<got - want, want>| / <want, want>,
    over BWD_LEAN_LIMIT."""
    g, w = got.double(), want.double()
    lean = ((g - w) * w).sum().abs().item() / max(w.square().sum().item(), 1e-300)
    return max(_scaled_used(got, want, BWD_RMS_TOL), lean / BWD_LEAN_LIMIT)


def _worst_element(got, want) -> str:
    """Where a gradient uses the most of its element-wise limit: that element's |want| over
    the gradient's RMS, and its error in units in the last place of a bfloat16 value at
    |want|."""
    w, g = want.double(), got.double()
    rms = w.square().mean().sqrt()
    limit = SCALED_RTOL * w.abs() + BWD_RMS_TOL * rms
    i = ((g - w).abs() / limit).flatten().argmax()
    wi, err = w.flatten()[i].abs(), (g - w).flatten()[i].abs()
    ulp = 2.0 ** (torch.floor(torch.log2(wi.clamp_min(1e-30))) - 7)
    return f"|want| {(wi / rms).item():.2f} x rms, off by {(err / ulp).item():.2f} units"


def _plain_bwd(q, k, v, dout):
    """The plain backward without a mask, on the plain forward's output and logsumexp."""
    out, lse = ref.flash_attention_ref(q, k, v, causal=False, return_lse=True)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)


def _bwd_faults(q, k, v, dout, want) -> dict:
    """The share of the limit (:func:`_bwd_used`, the largest over dQ, dK, dV) that each
    planted fault of a walk without a mask reads, by name: the plain backward with the walk's
    last key tile dropped (its keys' dK and dV zero; walks of more than one tile), with the
    ragged last tile's padding keys and values, zeros, folded into the softmax (Sk no multiple
    of BWD_WALK), and with the last query tile's rows dropped from dK and dV (walks of more
    than one query tile)."""
    sq, sk = q.shape[2], k.shape[2]
    tail = sk - BWD_WALK * ((sk - 1) // BWD_WALK)  # keys in the walk's last tile
    faults = {}
    if sk > BWD_WALK:
        kept = sk - tail
        dq, dk, dv = _plain_bwd(q, k[:, :, :kept], v[:, :, :kept], dout)
        pad = (0, 0, 0, tail)
        faults["last key tile dropped"] = (
            dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)
        )
    if tail < BWD_WALK:
        pad = (0, 0, 0, BWD_WALK - tail)
        kp, vp = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        dq, dk, dv = _plain_bwd(q, kp, vp, dout)
        faults["padding keys folded in"] = (dq, dk[:, :, :sk], dv[:, :, :sk])
    if sq > BWD_WALK:
        kept = BWD_WALK * ((sq - 1) // BWD_WALK)
        dq = _plain_bwd(q, k, v, dout)[0]
        _, dk, dv = _plain_bwd(q[:, :, :kept].contiguous(), k, v, dout[:, :, :kept].contiguous())
        faults["last query tile dropped from dK, dV"] = (dq, dk, dv)
    return {
        name: max(_bwd_used(g, w) for g, w in zip(grads, want))
        for name, grads in faults.items()
    }


def _encdec_bwd_rows(gen) -> dict:
    """The bfloat16 backward without a mask (ENCDEC_BWD_CASES) on the kernel forward's output
    and logsumexp, as training runs it: dQ, dK and dV against float64 autograd of dense
    attention (:func:`_grads_f64`) within the limit of :func:`_bwd_used`, the share used, the
    share each planted fault reads (each must fail it), the same bits on two launches, then
    the times: kernel ms, device us a call and by part (delta, dK/dV, dQ), the plain backward's
    ms, SDPA's backward as dispatched (no mask, group 1: no K/V expansion; the backend named,
    its share of the same limit logged) and the bound. At ENCDEC_BWD_JSON also the forward
    with the logsumexp: its output against the plain one within the scaled limit, its lse
    against the plain one at LSE_BF16_TOL, its output equal with and without the lse and on two
    launches, timed beside its plain version, SDPA's forward as dispatched and its bound.
    Returns the rows of the kernels line, by case, and the forward's under "fwd"."""
    rows = {}
    for case in ENCDEC_BWD_CASES:
        b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, torch.bfloat16)
        dout = torch.randn(b, hq, sq, dv, generator=gen, device=DEV).to(torch.bfloat16)
        out, lse, out32 = fa.flash_attention_fwd(q, k, v, causal=False, return_lse=True)

        def kernel(q=q, k=k, v=v, out=out32, lse=lse, dout=dout):
            return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)

        grads, again = kernel(), kernel()
        torch.cuda.synchronize()
        relaunch = sum((x != y).sum().item() for x, y in zip(grads, again))
        want = _grads_f64(q, k, v, dout)
        shape = f"q,dO{tuple(q.shape)} k,v{tuple(k.shape)} bfloat16 no mask"
        used = [_bwd_used(g, w) for g, w in zip(grads, want)]
        errs = [(g.double() - w).abs().max().item() for g, w in zip(grads, want)]
        faults = _bwd_faults(q, k, v, dout, want)
        finite = all(torch.isfinite(g.float()).all() for g in grads)
        if not finite or max(used) > 1.0 or relaunch:
            raise AssertionError(
                f"[kernels] flash_attention_bwd {shape}: {[f'{100 * x:.1f}%' for x in used]} of "
                f"the limit, max |err| {errs}; {relaunch} elements differ between two launches"
            )
        if min(faults.values()) <= 1.0:
            raise AssertionError(
                f"[kernels] flash_attention_bwd {shape}: a planted fault passes the limit: {faults}"
            )
        sdpa = _sdpa_bwd(q, k, v, dout, None, causal=False)
        lib_grads = sdpa["grads"]()
        lib_used = [_bwd_used(g, w) for g, w in zip(lib_grads, want)]
        worst = used.index(max(used))
        where = (
            f"the kernel's worst element (d{'qkv'[worst]}): "
            f"{_worst_element(grads[worst], want[worst])}; SDPA's (d"
            f"{'qkv'[lib_used.index(max(lib_used))]}): "
            + _worst_element(*max(zip(lib_grads, want), key=lambda gw: _bwd_used(*gw)))
        )
        lib_used = max(lib_used)
        del want, again, lib_grads
        backend = _sdpa_backend(q, k, v, None, False)
        bound, bound_by, bytes_ms = attention_bwd_bound_ms(
            b, hq, hkv, sq, sk, d, dv, False, None, 2
        )
        row = {
            "ms": time_ms(kernel, iters=10),
            "device_us": device_us(kernel, launches=10),
            **{
                f"{n}_us": device_us(kernel, f"flash_bwd_bf16_{n}", launches=10)
                for n in BF16_KERNEL_PARTS
            },
            "plain_ms": time_ms(
                lambda q=q, k=k, v=v, out=out32, lse=lse, dout=dout: ref.flash_attention_bwd_ref(
                    q, k, v, out, lse, dout, causal=False
                ),
                iters=3,
                warmup=1,
            ),
            "library_ms": time_ms(sdpa["backward"], iters=10),
            "library_backend": backend,
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": max(errs),
        }
        rows[case] = row
        parts = ", ".join(f"{n} {row[n + '_us']:.2f}" for n in BF16_KERNEL_PARTS)
        flops = 2.0 * b * hq * sq * sk * (3 * d + 2 * dv)
        log(
            f"[kernels] flash_attention_bwd {shape} ({fa.bwd_path(d, dv, q.dtype)} path): against "
            f"float64 autograd of dense attention, max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e}; the limit (2^-7 |want| + 2^-5 x rms(want) element by "
            f"element, a lean of {BWD_LEAN_LIMIT:.3g}) used dq {100 * used[0]:.1f}%, dk "
            f"{100 * used[1]:.1f}%, dv {100 * used[2]:.1f}% (SDPA's backward "
            f"{100 * lib_used:.1f}%; {where}); planted faults read "
            + ", ".join(f"{name} {x:.1f}x the limit" for name, x in faults.items())
            + "; two launches equal bit for bit"
        )
        log(
            f"[kernels]   {shape}: backward kernel_ms {row['ms']:.4f} (device "
            f"{row['device_us']:.2f} us a call: {parts}; {b * hkv * -(-sk // 128)} dK/dV blocks "
            f"walking {-(-sq // BWD_WALK)} query tiles, {b * hq * -(-sq // 128)} dQ blocks walking "
            f"{-(-sk // BWD_WALK)} key tiles), plain_ms {row['plain_ms']:.4f}, library_ms (SDPA "
            f"backward alone as dispatched, backend {backend}) {row['library_ms']:.4f} (kernel "
            f"{'faster' if row['ms'] < row['library_ms'] else 'NOT faster'}), bound_ms "
            f"{bound:.5f} ({bound_by}, bf16 tensor cores: 5 products, {flops:.4g} FLOPs at 989 "
            f"TFLOP/s; bytes alone {bytes_ms:.5f}), kernel/bound {row['ms'] / bound:.2f}"
        )
        if case == ENCDEC_BWD_JSON:
            rows["fwd"] = _encdec_fwd_lse_row(case, q, k, v, out, lse, out32)
        del sdpa, grads
    return rows


def _encdec_fwd_lse_row(case, q, k, v, out, lse, out32) -> dict:
    """The bfloat16 forward with the logsumexp and the float32 output, without a mask, at the
    train shape the phase saves: ``out``, ``lse`` and ``out32`` (its launch) against the plain
    forward (the float32 output within the same scaled limit, and rounding to ``out`` bit for
    bit), its bits unchanged by the lse and on two launches; its times beside the plain
    version's, SDPA's as dispatched and the bound."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
    want32, want_lse = ref.flash_attention_ref(
        q, k, v, causal=False, return_lse=True, out_dtype=torch.float32
    )
    want = want32.to(q.dtype)
    used = max(_scaled_used(out, want), _scaled_used(out32, want32))
    lse_err = _check("flash_attention_fwd lse, no mask", lse, want_lse, LSE_BF16_TOL)
    again = fa.flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    plain_out = fa.flash_attention_fwd(q, k, v, causal=False)
    shape = f"q,k,v{tuple(q.shape)} bfloat16 no mask, with the logsumexp and the float32 output"
    same = {
        "two launches": all(torch.equal(x, y) for x, y in zip((out, lse, out32), again)),
        "without the lse": torch.equal(out, plain_out),
        "the float32 output rounded": torch.equal(out, out32.to(q.dtype)),
    }
    if used > 1.0 or not all(same.values()):
        raise AssertionError(
            f"[kernels] flash_attention_fwd {shape}: {100 * used:.1f}% of the limit; equal "
            f"bits {same}"
        )

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=False)

    bound, bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, False, None, 2)
    train = dict(causal=False, return_lse=True)  # as FlashAttentionFunction
    row = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **train)),
        "device_us": device_us(lambda: fa.flash_attention_fwd(q, k, v, **train), launches=20),
        "ms_without_lse": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=False)),
        "plain_ms": time_ms(
            lambda: ref.flash_attention_ref(q, k, v, causal=False, return_lse=True), iters=5
        ),
        "library_ms": time_ms(library, iters=10),
        "library_backend": _sdpa_backend(q, k, v, None, False),
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": (out.float() - want.float()).abs().max().item(),
    }
    log(
        f"[kernels] flash_attention_fwd {shape} ({fa.PATHS[torch.bfloat16]} path): "
        f"{100 * used:.1f}% of the scaled limit, lse max |err| {lse_err:.3e} (tol "
        f"{LSE_BF16_TOL}); equal bit for bit on two launches, without the lse, and the float32 "
        f"output rounded to the bfloat16 one; kernel_ms with both {row['ms']:.4f} (device "
        f"{row['device_us']:.2f} us a call), without "
        f"{row['ms_without_lse']:.4f}, plain_ms {row['plain_ms']:.4f}, library_ms (SDPA "
        f"{row['library_backend']}, dispatched) {row['library_ms']:.4f}, bound_ms {bound:.5f} "
        f"({bound_by}), kernel/bound {row['ms'] / bound:.2f}"
    )
    return row


def _mla_train_case(gen, case):
    """One case at MLA's head dims with the explicit scale: the bfloat16 forward with the
    logsumexp against the plain one (its output equal bit for bit to its output without, its
    float32 output against the plain one and rounding to its output bit for bit), then the
    backward on the plain forward's float32 output and logsumexp against
    ``ref.flash_attention_bwd_ref`` and against ``ref.flash_attention_bwd_split_ref`` (the
    kernels' decomposition at the planned parts), each at BWD_BF16_TOL of each gradient's
    largest entry. Returns q, k, v, dO, the errors against the split plain version (the
    gradients' max |err|, the forward output's) and the split plain version's ms."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
    masks = dict(causal=True, scale=MLA_SCALE)
    q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, torch.bfloat16)
    dout = torch.randn(b, hq, sq, dv, generator=gen, device=DEV).to(torch.bfloat16)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, out_dtype=torch.float32, **masks)
    got_out, got_lse, got_out32 = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
    same = torch.equal(got_out, fa.flash_attention_fwd(q, k, v, **masks))
    parts = fa.bwd_split_plan(sq, sk, hq, hkv, True, None)
    label = (
        f"flash_attention_bwd q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} bfloat16 "
        f"causal scale 192^-0.5 ({fa.bwd_path(d, dv, q.dtype)} path, the split build <4, 2>, "
        f"{parts} part{'s' if parts > 1 else ''} a key tile)"
    )
    if not same:
        raise AssertionError(f"[kernels] {label}: the bfloat16 forward's output moved with lse")
    out_err = _check(f"{label} out", got_out, out.to(q.dtype), TOL["bfloat16"])
    out32_err = _check_fwd_f32(label, got_out, got_out32, out)
    lse_err = _check(f"{label} lse", got_lse, lse, LSE_BF16_TOL)
    lse_used = _tol_used(got_lse, lse, LSE_BF16_TOL)
    del got_out, got_lse, got_out32
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    if any(g.dtype != torch.bfloat16 or not torch.isfinite(g.float()).all() for g in grads):
        raise AssertionError(f"[kernels] {label}: gradients {[g.dtype for g in grads]}")
    report, errs = [], None
    for name, plain in (
        ("flash_attention_bwd_ref", ref.flash_attention_bwd_ref),
        ("flash_attention_bwd_split_ref", functools.partial(
            ref.flash_attention_bwd_split_ref, parts=parts
        )),
    ):
        t0 = time.monotonic()
        want = plain(q, k, v, out, lse, dout, **masks)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.monotonic() - t0)
        shares = [_share_of_largest(g, w, BWD_BF16_TOL) for g, w in zip(grads, want)]
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
        del want
        if max(shares) > 1.0:
            raise AssertionError(
                f"[kernels] {label} vs {name}: max |err| {errs}, "
                f"{[f'{100 * x:.1f}%' for x in shares]} of {BWD_BF16_TOL} x each gradient's "
                "largest entry"
            )
        report.append(
            f"vs {name} max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
            f"{100 * max(shares):.1f}% of the tolerance"
        )
    log(
        f"[kernels] {label}: {'; '.join(report)} ({BWD_BF16_TOL:.4g} x each gradient's largest "
        f"entry); forward out max |err| {out_err:.3e}, in float32 {out32_err:.3e} (tol "
        f"{TOL['bfloat16']}; rounds to out bit for bit), lse {lse_err:.3e} (tol "
        f"{LSE_BF16_TOL}, {100 * lse_used:.1f}% used), output with lse equal bit for bit"
    )
    return q, k, v, dout, max(errs), out_err, plain_ms


def _mla_train_rows(gen) -> dict:
    """The bfloat16 forward with the logsumexp and the backward (the split build <4, 2>) at
    deepseek-v3-671b's train shape MLA_TRAIN, then at MLA_TRAIN_EDGE, against their plain
    versions (:func:`_mla_train_case`); at the train shape equal bits on two launches and for
    batch row 0 alone against row 0 of a batch of 2, each launch's device us, kernel ms
    beside the plain versions', SDPA's as dispatched for Dv != D (the backend named), the
    bounds, the split design's floors and the dS^T scratch's bytes, and the float64
    yardstick. Returns the rows of the kernels line."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = MLA_TRAIN
    if sq != TRAIN_SEQ or fa.bwd_split_plan(sq, sk, hq, hkv, True, None) != 1:
        raise AssertionError(f"[kernels] MLA_TRAIN {MLA_TRAIN}: not the one-part train shape")
    masks = dict(causal=True, scale=MLA_SCALE)
    _mla_train_case(gen, MLA_TRAIN_EDGE)
    q, k, v, dout, err, out_err, split_ms = _mla_train_case(gen, MLA_TRAIN)
    _mla_train_determinism(gen)
    _, lse, out = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)

    backend = _sdpa_backend(q, k, v, None, True)
    sdpa = _sdpa_bwd(q, k, v, dout, None)
    bound, bound_by, bytes_ms = attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, True, None, 2)
    pairs = 2.0 * b * hq * _kept_pairs(sq, sk, True, None)
    split_floor = 1e3 * pairs * (4 * d + 3 * dv) / PEAK_BF16_FLOPS  # S and dP twice
    padded_floor = 1e3 * pairs * (4 * 256 + 3 * dv) / PEAK_BF16_FLOPS  # D padded to 4 chunks
    ds_bytes = b * hq * fa.bwd_ds_offsets(sq, sk, True, None)[-1] * fa.BWD_SPLIT_TILE**2 * 2
    walks = [n for _, n in fa.bwd_split_walks(sq, sk, True, None)]
    row = {
        "ms": time_ms(kernel, iters=10),
        "device_us": device_us(kernel, launches=10),
        **{
            f"{n}_us": device_us(kernel, f"flash_bwd_bf16_{n}", launches=10)
            for n in BF16_SPLIT_PARTS
        },
        "plain_ms": split_ms,
        "library_ms": time_ms(sdpa["backward"], iters=10),
        "bound_ms": bound,
        "bound_by": bound_by,
        "max_abs_err": err,
    }
    plain_ref_ms = time_ms(
        lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks), iters=2, warmup=1
    )
    launches = ", ".join(f"{n} {row[n + '_us']:.2f}" for n in BF16_SPLIT_PARTS)
    log(
        f"[kernels]   deepseek-v3-671b train shape: dK/dV grid {len(walks) * hkv * b} blocks "
        f"({len(walks)} key tiles x 1 part x {hkv} KV heads x B {b}; walks of 1 to "
        f"{max(walks)} tiles), the busiest of {fa.BWD_SPLIT_SMS} SMs "
        f"{fa.bwd_split_longest(walks, 1, hkv)} walk tiles (even share "
        f"{sum(walks) * hkv / fa.BWD_SPLIT_SMS:.1f}); dQ grid {-(-sq // 128) * hq * b} blocks; "
        f"the dS^T scratch {ds_bytes} bytes"
    )
    log(
        f"[kernels]   deepseek-v3-671b train shape q{tuple(q.shape)} k{tuple(k.shape)} "
        f"v{tuple(v.shape)} bfloat16 causal scale 192^-0.5: backward kernel_ms {row['ms']:.4f} "
        f"(device {row['device_us']:.2f} us a call: {launches}), plain_ms (the split plain "
        f"version, one call by the host clock) {split_ms:.4f}, flash_attention_bwd_ref "
        f"{plain_ref_ms:.4f}, library_ms (SDPA backward alone as dispatched for Dv != D, "
        f"backend {backend}) {row['library_ms']:.4f} (kernel "
        f"{'faster' if row['ms'] < row['library_ms'] else 'NOT faster'}), bound_ms "
        f"{bound:.5f} ({bound_by}, bf16 tensor cores: 5 products, {pairs * (3 * d + 2 * dv):.4g} "
        f"FLOPs at 989 TFLOP/s; bytes alone {bytes_ms:.5f}), the split design's floor (S and dP "
        f"twice) {split_floor:.5f}, with D padded to 256 {padded_floor:.5f}, kernel/bound "
        f"{row['ms'] / bound:.2f}"
    )
    _flash_bwd_bf16_yardstick(q, k, v, dout, out, lse, sdpa, dict(causal=True, window=None))
    del sdpa

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=MLA_SCALE
        )

    fwd_bound, fwd_bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, True, None, 2)
    floor = attention_bound_ms(b, hq, hkv, sq, sk, 256, dv, True, None, 2)[0]
    fwd = {
        "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **masks), iters=10),
        "device_us": device_us(
            lambda: fa.flash_attention_fwd(q, k, v, return_lse=True, **masks), launches=10
        ),
        "ms_without_lse": time_ms(lambda: fa.flash_attention_fwd(q, k, v, **masks), iters=10),
        "plain_ms": time_ms(
            lambda: ref.flash_attention_ref(q, k, v, return_lse=True, **masks), iters=3, warmup=1
        ),
        "library_ms": time_ms(library, iters=10),
        "bound_ms": fwd_bound,
        "bound_by": fwd_bound_by,
        "max_abs_err": out_err,
    }
    log(
        f"[kernels]   deepseek-v3-671b train shape forward (bfloat16, wgmma, the DC = 4 build): "
        f"with lse and the float32 output {fwd['ms']:.4f} ms (device {fwd['device_us']:.2f} us a call), without "
        f"{fwd['ms_without_lse']:.4f} ms; plain_ms {fwd['plain_ms']:.4f}, library_ms (SDPA "
        f"{backend}, dispatched for Dv != D) {fwd['library_ms']:.4f}, bound_ms {fwd_bound:.5f} "
        f"({fwd_bound_by}), the DC = 4 build's floor (QK^T over 256 columns) {floor:.5f}, "
        f"kernel/bound {fwd['ms'] / fwd_bound:.2f}"
    )
    return {"bwd": row, "fwd": fwd}


def _mla_train_determinism(gen) -> None:
    """At MLA_TRAIN's heads and length in a batch of 2: the forward with the logsumexp (and the
    float32 output) and the backward on them each equal bit for bit on two launches, and batch row 0 alone equal to row
    0 of the batch."""
    _, hq, hkv, sq, sk, d, _, _, _, dv = MLA_TRAIN
    masks = dict(causal=True, scale=MLA_SCALE)
    q, k, v = _inputs(gen, 2, hq, hkv, sq, sk, d, dv, torch.bfloat16)
    dout = torch.randn(2, hq, sq, dv, generator=gen, device=DEV).to(torch.bfloat16)
    first = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
    again = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
    alone = fa.flash_attention_fwd(q[:1], k[:1], v[:1], return_lse=True, **masks)
    _, lse, out = first
    bwd = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    bwd_again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    bwd_alone = fa.flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1], dout[:1], **masks)
    torch.cuda.synchronize()

    def differ(xs, ys, row0=False):
        return sum(((x[:1] if row0 else x) != y).sum().item() for x, y in zip(xs, ys))

    counts = {
        "forward relaunch": differ(first, again),
        "forward B=1": differ(first, alone, row0=True),
        "backward relaunch": differ(bwd, bwd_again),
        "backward B=1": differ(bwd, bwd_alone, row0=True),
    }
    label = f"q(2,{hq},{sq},{d}) v(2,{hkv},{sk},{dv}) bfloat16 causal scale 192^-0.5"
    if any(counts.values()):
        raise AssertionError(f"[kernels] MLA train shape {label}: elements that differ {counts}")
    log(
        f"[kernels] MLA train shape {label}: the forward with the lse and the backward (split "
        "build <4, 2>) each equal bit for bit on two launches; B=1 equals row 0 of B=2 bit for "
        "bit"
    )


def _sequential(model, params, prompt, n, max_len):
    """Greedy tokens of one request alone, and the logits after the last of them."""
    toks = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None, :]
    logits, cache = model.prefill(params, {"tokens": toks}, pad_to=max_len)
    tok = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(n):
        out.append(int(tok[0]))
        logits, cache = model.decode_step(params, cache, {"token": tok})
        tok = torch.argmax(logits, dim=-1)
    return out, logits


def _reset_launches() -> None:
    """Set every kernel's launch count to 0 just before a serving run."""
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    da.decode_attention.launches = 0
    rg.rglru_scan.launches = 0
    rg.rglru_bwd.launches = 0
    wk.wkv6_chunked.launches = 0
    wk.wkv6_bwd.launches = 0
    moe_mod._moe_sort.calls = moe_mod._moe_einsum.calls = 0


def _release() -> None:
    """Give the memory of the phase that just returned back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_demo() -> dict:
    """Serve the full-width demo model; returns the flash and decode-attention kernels'
    launch counts."""
    cfg = get_config("serpytor-demo-100m")
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    log(f"[demo] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {cfg.param_count()} params")
    prompts = make_prompts(N_REQUESTS, cfg.vocab_size, 64, 1000, seed=0)
    log(f"[demo] prompt lengths {[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")

    # reference first: sequential greedy decoding, one request at a time (also warms up)
    want = {
        f"r{i}": _sequential(model, params, p, NEW_TOKENS, MAX_LEN)[0]
        for i, p in enumerate(prompts)
    }

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=MAX_LEN)
    launches, decode_launches = fa.flash_attention_fwd.launches, da.decode_attention.launches
    peak = torch.cuda.max_memory_allocated()

    done = res["generations"]
    if set(done) != set(want):
        raise AssertionError(f"[demo] finished {sorted(done)}, submitted {sorted(want)}")
    for rid, toks in want.items():
        if done[rid].tokens != toks:
            raise AssertionError(f"[demo] {rid}: batched {done[rid].tokens} != sequential {toks}")
    expected = cfg.num_layers * len(prompts)
    expected_decode = cfg.num_layers * res["steps"]
    if (
        (launches, decode_launches) != (expected, expected_decode)
        or rg.rglru_scan.launches
        or wk.wkv6_chunked.launches
    ):
        raise AssertionError(
            f"[demo] flash launches {launches}, expected {expected}; decode_attention launches "
            f"{decode_launches}, expected {expected_decode}; rglru launches "
            f"{rg.rglru_scan.launches}, wkv6 launches {wk.wkv6_chunked.launches}, expected 0"
        )
    log(f"[demo] tokens of all {len(done)} requests equal sequential greedy decoding")
    check_against_cpu(cfg, model, params, min(prompts, key=len))
    log(
        f"[demo] flash_attention_fwd launches {launches} = {cfg.num_layers} layers x 8 prefills;"
        f" decode_attention launches {decode_launches} = {cfg.num_layers} layers x "
        f"{res['steps']} decode steps"
    )
    log(
        f"[demo] {res['tokens']} tokens in {res['wall_s']:.4f} s: {res['tok_per_s']:.2f} tok/s; "
        f"prefill {res['prefill_ms_mean']:.3f} ms mean; decode {res['decode_ms_per_step']:.3f} "
        f"ms/step over {res['steps']} steps; max_memory_allocated {peak} bytes"
    )
    serving = dict(
        cfg=cfg, model=model, params=params, prompts=prompts, want=want, tok_per_s=res["tok_per_s"]
    )
    return {"flash": launches, "decode_attention": decode_launches, "serving": serving}


GATEWAY_CRASH_REQUESTS = 4  # round 2: prompts 0-3 after w1's application is crashed


def _gateway_round(tag, gw, cfg, prompts, want, new_tokens=NEW_TOKENS):
    """One round through the gateway: every prompt's tokens equal the first ``new_tokens`` of
    ``want``'s, the flash and decode-attention kernels ran in every layer of every prefill and
    decode step and nothing else ran; logs the process's CPU seconds (user + system, every
    thread) over the round's wall, the cores busy on average. Returns the round's wall
    seconds, latencies and tokens."""
    _reset_launches()
    cpu = time.process_time()
    outs, wall, latency = generate_all(gw, [p.tolist() for p in prompts], new_tokens)
    cpu = time.process_time() - cpu
    counts = (
        fa.flash_attention_fwd.launches,
        da.decode_attention.launches,
        rg.rglru_scan.launches,
        wk.wkv6_chunked.launches,
    )
    for i, out in enumerate(outs):
        if out["tokens"] != want[f"r{i}"][:new_tokens]:
            raise AssertionError(
                f"[gateway] {tag} r{i}: through the gateway {out['tokens']} != sequential "
                f"{want[f'r{i}'][:new_tokens]}"
            )
    expected = (cfg.num_layers * len(prompts), cfg.num_layers * len(prompts) * new_tokens, 0, 0)
    if counts != expected:
        raise AssertionError(
            f"[gateway] {tag} launches flash, decode_attention, rglru, wkv6 {counts}, expected "
            f"{expected}"
        )
    log(
        f"[gateway] {tag}: tokens of all {len(outs)} requests equal sequential greedy decoding;"
        f" flash_attention_fwd launches {counts[0]} = {cfg.num_layers} layers x {len(prompts)} "
        f"prefills, decode_attention launches {counts[1]} = {cfg.num_layers} layers x "
        f"{len(prompts)} requests x {new_tokens} decode steps, rglru 0, wkv6 0; process CPU "
        f"{cpu:.4f} s over {wall:.4f} s wall = {cpu / wall:.3f} cores busy"
    )
    return wall, latency, sum(len(o["tokens"]) for o in outs)


def _log_latency(tag, wall, latency, tokens):
    lat = sorted(1e3 * t for t in latency)
    log(
        f"[gateway] {tag}: {tokens} tokens in {wall:.4f} s: {tokens / wall:.2f} tok/s; request "
        f"latency (submit to result) mean {sum(lat) / len(lat):.3f} ms, p50 "
        f"{float(np.median(lat)):.3f} ms, max {lat[-1]:.3f} ms"
    )


def _wire_bytes(client, ctx, inputs, want_tokens):
    """The HTTP bodies of one ``generate`` through ``client.run_task``, as ``urlopen`` sends
    and reads them (the gateway idle, so no other task is in flight): (request, response)."""
    sizes = {"request": 0, "response": 0}
    urlopen = urllib.request.urlopen

    def recording(req, *args, **kwargs):
        resp = urlopen(req, *args, **kwargs)
        if isinstance(req, urllib.request.Request) and req.full_url.endswith("/task"):
            sizes["request"] += len(req.data)
            read = resp.read

            def counted_read(*a):
                raw = read(*a)
                sizes["response"] += len(raw)
                return raw

            resp.read = counted_read
        return resp

    with mock.patch.object(urllib.request, "urlopen", recording):
        out = client.run_task("generate", ctx, inputs)
    if out.get("status") != "ok" or out["output"]["tokens"] != want_tokens:
        raise AssertionError(f"[gateway] {client.name} run_task: {out}")
    return sizes["request"], sizes["response"]


def phase_gateway(serving: dict) -> None:
    """Serve the demo phase's model and prompts through a Gateway and two HTTP workers
    (``launch.gateway_serve``: batch-1 greedy ``generate`` tasks, prefill padded to S + 32)
    sharing its one param tree. Round 1: 8 requests, tokens equal the demo phase's sequential
    ones, 64 flash and 2,048 decode-attention launches, both workers served; then r0 alone
    (the cost of one generation with nothing beside it); both heartbeats report the card;
    one request's HTTP bodies. Round 2: w1's
    application crashed (its heartbeat answers, its app does not), 4 more requests all served
    by w0 with the same tokens."""
    cfg, model, params = serving["cfg"], serving["model"], serving["params"]
    prompts, want = serving["prompts"], serving["want"]
    registries = [build_registry(cfg, model, params) for _ in range(2)]
    with http_workers(registries) as (servers, clients):
        with Gateway(clients, allocation=("context_affinity", "least_loaded")) as gw:
            torch.cuda.synchronize()
            wall, latency, tokens = _gateway_round("round 1", gw, cfg, prompts, want)
            stats = gw.stats()
            done = {name: w["completed"] for name, w in stats["workers"].items()}
            if min(done.values()) < 1:
                raise AssertionError(f"[gateway] round 1: a worker served nothing: {done}")
            _log_latency("round 1", wall, latency, tokens)
            log(
                f"[gateway] batcher (demo phase, ContinuousBatcher slots {SLOTS}, same prompts): "
                f"{serving['tok_per_s']:.2f} tok/s; the gateway's "
                f"{tokens / wall / serving['tok_per_s']:.3f}x of it"
            )
            log(
                f"[gateway] mean allocation {gw.mean_alloc_us():.3f} us over "
                f"{stats['metrics']['alloc_calls']} decisions; per worker "
                + ", ".join(
                    f"{n}: completed {w['completed']}, ewma_latency_s {w['ewma_latency_s']:.4f}"
                    for n, w in stats["workers"].items()
                )
            )
            # the same route with one request in flight: the cost of a generation alone,
            # against round 1's 8 at once on the workers' handler threads
            wall1, _, tokens1 = _gateway_round("r0 alone", gw, cfg, prompts[:1], want)
            log(
                f"[gateway] r0 alone: {tokens1} tokens in {wall1:.4f} s: {tokens1 / wall1:.2f} "
                f"tok/s, {1e3 * wall1 / (NEW_TOKENS + 1):.3f} ms a step (prefill + {NEW_TOKENS} "
                f"decode steps); round 1's 8 at once: {tokens / wall:.2f} tok/s"
            )
            for client in clients:
                t0 = time.monotonic()
                hb = client.heartbeat()
                probe_ms = 1e3 * (time.monotonic() - t0)
                if hb is None or hb["devices"] != {"backend": "cuda", "count": 1}:
                    raise AssertionError(f"[gateway] {client.name} heartbeat {hb}")
                log(
                    f"[gateway] {client.name} heartbeat: devices {hb['devices']}, probe "
                    f"{probe_ms:.3f} ms"
                )
            ctx = Context.origin({"session": "s0"})
            inputs = {"prompt": prompts[0].tolist(), "new_tokens": NEW_TOKENS}
            request, response = _wire_bytes(clients[0], ctx, inputs, want["r0"])
            log(
                f"[gateway] one generate on the wire (r0, {len(prompts[0])} prompt tokens, "
                f"w0's run_task): HTTP request body {request} bytes, response body {response} "
                f"bytes"
            )

            servers[1].crash_application()
            if clients[1].heartbeat() is None:
                raise AssertionError("[gateway] w1's heartbeat went down with its application")
            try:
                clients[1].run_task("health", Context(), {})
            except TimeoutError:
                pass
            else:
                raise AssertionError("[gateway] w1's application still answers after the crash")
            log("[gateway] w1's application crashed: its heartbeat answers, its app does not")
            before = {n: w["completed"] for n, w in gw.stats()["workers"].items()}
            n2 = GATEWAY_CRASH_REQUESTS
            wall2, latency2, tokens2 = _gateway_round("round 2", gw, cfg, prompts[:n2], want)
            after = {n: w["completed"] for n, w in gw.stats()["workers"].items()}
            if (after["w0"] - before["w0"], after["w1"] - before["w1"]) != (n2, 0):
                raise AssertionError(f"[gateway] round 2 completions {before} -> {after}")
            _log_latency("round 2", wall2, latency2, tokens2)
            log(
                f"[gateway] round 2: all {n2} requests served by w0; gateway metrics "
                f"{gw.stats()['metrics']}"
            )


def _host_tree(tree):
    """The tree's tensors as numpy arrays on the host, for ``payload_digest``."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _step_digest(params, state, metrics) -> str:
    tree = {"metrics": metrics, "params": params, "m": state["m"], "v": state["v"]}
    return payload_digest(_host_tree(tree))


def _train_batches(cfg, batch_size: int = TRAIN_BATCH):
    """The train steps' batches on the card, and each batch's ``payload_digest`` (the
    trainer's ``data@`` digest)."""
    source = TokenSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch_size, seed=0)
    )
    host = [source.batch_at(s) for s in range(TRAIN_STEPS)]
    batches = [{"tokens": torch.from_numpy(b["tokens"]).long().to(DEV)} for b in host]
    return batches, [payload_digest(b) for b in host]


def _metrics_digest(metrics, step, data_digest) -> str:
    """The digest the trainer journals for a step: its metrics as floats, the step and
    the batch's digest (``repro_torch.train.trainer``, ``run_step``)."""
    out = {key: float(x) for key, x in metrics.items()}
    return payload_digest({**out, "step": step, "data_digest": data_digest})


TRAIN_RESULT = "[train] launches "  # the train process's line of launch counts, ms and digests


def _in_process(arg: str, prefix: str, tag: str) -> dict:
    """Run this file with ``arg`` in a process of its own, its log passed on line by line;
    returns the JSON of its line that starts with ``prefix``."""
    cmd = [sys.executable, str(Path(__file__).resolve()), arg]
    result = None
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            log(line.rstrip("\n"))
            if line.startswith(prefix):
                result = json.loads(line[len(prefix) :])
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"{tag} the phase's process exited with code {proc.returncode}")
    return result


def _process_main(prefix: str, phase) -> int:
    """A phase's own process: check the card, run ``phase`` and log its result line."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a card")
    log(prefix + json.dumps(phase()))
    return 0


def phase_train() -> dict:
    """Run the train phase in a process of its own (this file with ``--train``); returns the
    launch counts, step ms and digests its log gives."""
    return _in_process(TRAIN_ARG, TRAIN_RESULT, "[train]")


def _train() -> dict:
    """Train the full-width demo 3 steps through the flash kernels, deterministically;
    returns the flash forward and backward launch counts of those steps, and each step's
    ms and metrics digest as the trainer journals it."""
    from repro_torch.launch.train import opt_config

    cfg = get_config("serpytor-demo-100m")
    model = build(cfg, DEV)
    params0 = init_params(cfg, _gen(0), DEV)
    opt = AdamWConfig(**TRAIN_OPT)
    if opt != opt_config(TRAIN_STEPS):
        raise AssertionError(f"[train] {opt} is not the train CLI's {opt_config(TRAIN_STEPS)}")
    state0 = make_opt_init(model, opt)(params0)
    train_step = make_train_step(model, opt)
    batches, data_digests = _train_batches(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(
        f"[train] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, remat={cfg.remat}; "
        f"batches of {TRAIN_BATCH} x {TRAIN_SEQ} tokens from TokenSource(seed=0); {opt}"
    )
    torch.use_deterministic_algorithms(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    params, state, step_ms, first, digests = params0, state0, [], None, []
    for step in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, state, metrics = train_step(params, state, batches[step])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.monotonic() - t0))
        digests.append(_metrics_digest(metrics, step, data_digests[step]))
        vals = {key: float(x) for key, x in metrics.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"[train] step {step}: metrics {vals}")
        if step == 0:
            first = (params, state, metrics)
        log(
            f"[train] step {step}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} z_loss "
            f"{vals['z_loss']:.4f} grad_norm {vals['grad_norm']:.6f} lr {vals['lr']:.4e}; "
            f"{step_ms[-1]:.3f} ms, {tokens / step_ms[-1] * 1e3:.1f} tokens/s (host clock "
            f"after a sync)"
        )
    launches = {
        "flash": fa.flash_attention_fwd.launches,
        "flash_bwd": fa.flash_attention_bwd.launches,
    }
    peak = torch.cuda.max_memory_allocated()
    expected = cfg.num_layers * TRAIN_STEPS
    others = (da.decode_attention.launches, rg.rglru_scan.launches, wk.wkv6_chunked.launches)
    if (launches["flash"], launches["flash_bwd"]) != (expected, expected) or any(others):
        raise AssertionError(
            f"[train] flash launches {launches}, expected {expected} each; decode, rglru, "
            f"wkv6 launches {others}, expected 0"
        )
    steady = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    log(
        f"[train] flash_attention_fwd launches {launches['flash']}, flash_attention_bwd "
        f"launches {launches['flash_bwd']} = {cfg.num_layers} layers x {TRAIN_STEPS} steps; "
        f"step ms {', '.join(f'{x:.3f}' for x in step_ms)} (steps 1-{TRAIN_STEPS - 1}: "
        f"{steady:.3f} ms, {tokens / steady * 1e3:.1f} tokens/s); max_memory_allocated "
        f"{peak} bytes ({peak - held} above the {held} held before the steps)"
    )

    # replay: step 0 again from the same state, equal bits
    again = train_step(params0, state0, batches[0])
    want_digest, got_digest = _step_digest(*first), _step_digest(*again)
    if want_digest != got_digest:
        trees = [tree_leaves({"p": x[0], "m": x[1]["m"], "v": x[1]["v"]}) for x in (first, again)]
        diff = sum(int((a != b).sum()) for a, b in zip(*trees))
        raise AssertionError(
            f"[train] step 0 replayed: digest {got_digest} != {want_digest}, {diff} elements "
            "of params and AdamW state differ"
        )
    log(
        f"[train] step 0 run again from the same state: payload_digest of metrics, params, m "
        f"and v {got_digest} both times (equal bits)"
    )
    del again
    _check_train_against_plain(cfg, model, params0, state0, batches[0], first[2], opt)
    _train_profile(model, params0, state0, batches[0], opt)
    log(f"[train] metrics digests as the trainer journals them: {digests}")
    del model, params0, state0, params, state, first
    _release()
    cut = _direct_steps(_demo_cut_config(), opt)
    return {**launches, "step_digests": digests, "step_ms": step_ms, "cut": cut}


def _demo_cut_config():
    """The demo at full width and its first DEMO_CUT_LAYERS layers (the durable and
    distributed phases' model)."""
    return dataclasses.replace(get_config("serpytor-demo-100m"), num_layers=DEMO_CUT_LAYERS)


def _direct_steps(cfg, opt, batch_size=TRAIN_BATCH, tag="[train]", pair_at=None) -> dict:
    """TRAIN_STEPS direct steps of ``cfg`` from the train CLI's initial params on TokenSource
    batches of ``batch_size`` x TRAIN_SEQ: each step's ms and metrics digest as the trainer
    journals it and, with ``pair_at``, the content digests of the checkpoint pair the trainer
    saves before step ``pair_at`` (params, then AdamW state)."""
    model = build(cfg, DEV)
    params = init_params(cfg, _gen(0), DEV)
    state = make_opt_init(model, opt)(params)
    train_step = make_train_step(model, opt)
    batches, data_digests = _train_batches(cfg, batch_size)
    step_ms, digests, pair = [], [], None
    for step in range(TRAIN_STEPS):
        if step == pair_at:
            pair = [CheckpointStore.content_digest(to_host(tree)) for tree in (params, state)]
        t0 = time.monotonic()
        params, state, metrics = train_step(params, state, batches[step])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.monotonic() - t0))
        digests.append(_metrics_digest(metrics, step, data_digests[step]))
    log(
        f"{tag} {cfg.num_layers} layers of {cfg.name} (a durable phase's depth), batches of "
        f"{batch_size} x {TRAIN_SEQ}: step ms {', '.join(f'{x:.3f}' for x in step_ms)}; "
        f"metrics digests {digests}"
        + (f"; the checkpoint pair before step {pair_at}: {pair}" if pair else "")
    )
    return {"step_digests": digests, "step_ms": step_ms, "pair": pair}


def _check_train_against_plain(cfg, model, params, state, batch, metrics, opt) -> None:
    """Step 0 with attn_impl="ref" (plain attention, autograd through it; remat="full" so
    that one layer's plain graph is held at a time): its loss and grad norm, and every
    gradient leaf, against the kernel path's."""
    plain = build(dataclasses.replace(cfg, attn_impl="ref", remat="full"), DEV)
    _, _, plain_metrics = make_train_step(plain, opt)(params, state, batch)
    dloss = abs(float(plain_metrics["loss"]) - float(metrics["loss"]))
    gn, plain_gn = float(metrics["grad_norm"]), float(plain_metrics["grad_norm"])
    dgn = abs(gn - plain_gn) / plain_gn
    _, grads = value_and_grad(model.loss_fn, params, batch)
    _, plain_grads = value_and_grad(plain.loss_fn, params, batch)
    worst = max(
        ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        for g, w in zip(tree_leaves(grads), tree_leaves(plain_grads))
    )
    msg = (
        f"step 0 kernel path vs attn_impl='ref': |loss diff| {dloss:.3e} (tol {TRAIN_LOSS_TOL}), "
        f"grad_norm {gn:.6f} vs {plain_gn:.6f}, relative diff {dgn:.3e} (tol "
        f"{TRAIN_GNORM_RTOL}); every gradient leaf within {worst:.3e} of its largest entry "
        f"(tol {TRAIN_GRAD_TOL})"
    )
    if dloss > TRAIN_LOSS_TOL or dgn > TRAIN_GNORM_RTOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"[train] {msg}")
    log(f"[train] {msg}")


def _train_profile(model, params, state, batch, opt, tag="[train]") -> None:
    """One step under torch.profiler, in two windows with a sync between: the gradient
    (forward, loss, backward) and the optimizer (clip and AdamW); device time by kind and
    the device's busy share of the two windows' host wall."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with _mtp_range(model.cfg.mtp), torch.profiler.profile(activities=acts) as prof_grad:
        t0 = time.monotonic()
        _, grads = value_and_grad(model.loss_fn, params, batch)
        torch.cuda.synchronize()
        grad_ms = 1e3 * (time.monotonic() - t0)
    with torch.profiler.profile(activities=acts) as prof_opt:
        t0 = time.monotonic()
        adamw_update(params, grads, state, opt)
        torch.cuda.synchronize()
        opt_ms = 1e3 * (time.monotonic() - t0)
    grad_rows = [r for r in _device_rows(prof_grad) if r[2] != MTP_RANGE]  # not the range's own
    kinds, n_grad = _device_kinds(grad_rows)
    opt_kinds, n_opt = _device_kinds(_device_rows(prof_opt))
    if not kinds or not opt_kinds:
        log(f"{tag} step profile: no device time recorded (not measured)")
        return
    kinds["optimizer"] = sum(opt_kinds.values())
    busy = sum(kinds.values())
    by_kind = "; ".join(
        f"{k} {ms:.3f} ms ({100 * ms / busy:.1f}%)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])
    )
    log(
        f"{tag} profiled step: gradient {grad_ms:.3f} ms + optimizer {opt_ms:.3f} ms host "
        f"wall, device busy {busy:.3f} ms ({100 * busy / (grad_ms + opt_ms):.1f}%), "
        f"{sum(n_grad.values()) + sum(n_opt.values())} kernels; device time by kind: {by_kind}"
    )
    top = "; ".join(f"{k[:70]} {us / 1e3:.3f} ms x{n}" for us, n, k in grad_rows[:8])
    log(f"{tag} profiled step: the gradient window's top kernels by device time: {top}")
    if model.cfg.mtp:
        head = _mtp_head_ms(prof_grad)
        grad_busy = busy - kinds["optimizer"]
        if head is None or not sum(head):
            log(f"{tag} profiled step: no device time under the MTP head's range (not measured)")
        else:
            log(
                f"{tag} profiled step: the MTP head (its norms, proj, dense layer, unembed and "
                f"CE): forward {head[0]:.3f} ms, backward {head[1]:.3f} ms of device time, "
                f"{100 * sum(head) / grad_busy:.1f}% of the gradient window's {grad_busy:.3f} ms"
            )


MTP_RANGE = "mtp head"


@contextlib.contextmanager
def _mtp_range(on: bool):
    """With ``on``, the port's MTP loss (``models.model._mtp_loss``, which ``loss_fn`` looks
    up when it runs) wrapped in a ``torch.profiler.record_function`` range named MTP_RANGE
    (this file's patch: the port's code carries none)."""
    fn = model_mod._mtp_loss

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(MTP_RANGE):
            return fn(*args, **kwargs)

    if on:
        model_mod._mtp_loss = ranged
    try:
        yield
    finally:
        model_mod._mtp_loss = fn


def _mtp_head_ms(prof):
    """Device ms of the MTP head in a profiled gradient: (forward, backward). The forward is
    the kernels under MTP_RANGE; the backward the autograd nodes its forward ops made,
    matched by their sequence numbers on the forward thread (each node's
    ``evaluate_function`` event carries the number of the op that made it). None without
    the range."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in events if e.name == MTP_RANGE and e.device_type == cpu]
    if not ranges:
        return None
    head = ranges[0]

    def under(e):
        p = e.cpu_parent
        while p is not None:
            if p is head:
                return True
            p = p.cpu_parent
        return False

    seqs = {e.sequence_nr for e in events if e.sequence_nr >= 0 and under(e)}
    bwd = sum(
        e.device_time_total
        for e in events
        if e.name.startswith("autograd::engine::evaluate_function")
        and e.sequence_nr in seqs
        and getattr(e, "fwd_thread", head.thread) == head.thread
    )
    return head.device_time_total / 1e3, bwd / 1e3


DURABLE_DIR = ROOT / "build" / "durable_train"  # the runs' directory; build/ is not committed
DURABLE_CMD = [
    "-m", "repro_torch.launch.train", "--arch", "serpytor-demo-100m", "--full",
    "--layers", str(DEMO_CUT_LAYERS), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
    "--steps", str(TRAIN_STEPS), "--checkpoint-every", "2",
]  # fmt: skip
LAUNCHES_LINE = "kernel launches "  # the train CLI's last line
# its counts of the kernels the dense train steps do not run (no rec or rwkv layers)
NO_LAUNCHES = {"rglru_scan": 0, "rglru_bwd": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}


def _cli_launches(cfg, steps: int) -> dict:
    """The launches the train CLI reports for ``steps`` steps of ``cfg``, whose layers are all
    attention layers: the flash backward once a layer, the forward once, or twice with remat
    "full" (which runs it again in the layer's recompute)."""
    n = len(layer_pattern(cfg)) * steps
    fwd = 2 * n if cfg.remat == "full" else n
    return {**NO_LAUNCHES, "flash_attention_fwd": fwd, "flash_attention_bwd": n}


def _run_trainer(tag: str, run_dir: Path, cmd: list) -> dict:
    """One run of the train CLI (``python`` with ``cmd``) in a process of its own, its output
    logged line by line under ``tag`` with the seconds since the process started; its heartbeat is polled once, when the first round's
    step line comes. Returns the launches the CLI reports, the heartbeat's report, the
    process's wall seconds and the run's ``summary.json``."""
    cmd = [sys.executable, *cmd, "--run-dir", str(run_dir)]
    path = [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    launches, address, beat = None, None, None
    t0 = time.monotonic()
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env) as proc:
        for line in proc.stdout:
            line = line.rstrip("\n")
            log(f"[{tag}] +{time.monotonic() - t0:.1f} s: {line}")
            if line.startswith("heartbeat at "):
                address = line[len("heartbeat at ") :]
            elif line.startswith("step ") and address and beat is None:
                beat = check_heartbeat(address, timeout=30.0)
                if beat is None:
                    raise AssertionError(f"[{tag}] the heartbeat at {address} is down")
            elif line.startswith(LAUNCHES_LINE):
                launches = json.loads(line[len(LAUNCHES_LINE) :])
    wall = time.monotonic() - t0
    if proc.returncode != 0 or launches is None:
        raise AssertionError(f"[{tag}] the train CLI exited with code {proc.returncode}")
    summary = json.loads((run_dir / "summary.json").read_text())
    return {"launches": launches, "heartbeat": beat, "wall_s": wall, "summary": summary}


def _journal(run_dir: Path) -> list:
    return list(Journal(str(run_dir / "journal.wal"), sync="never").records())


def _raw_bytes(man: dict) -> int:
    """The bytes of a checkpoint's arrays by its manifest: bfloat16 is 2 a value (numpy, which
    has no bfloat16 on the card's machine, cannot be asked)."""
    return sum(
        (2 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"]).itemsize)
        * int(np.prod(e["shape"]))
        for e in man["entries"].values()
    )


def _save_report(ckpt: Path, name: str, sec: float) -> str:
    """A checkpoint save's seconds beside its bytes, raw and on disk, and its rate."""
    raw = _raw_bytes(json.loads((ckpt / name / "manifest.json").read_text()))
    disk = (ckpt / name / "shard-0.npz.zst").stat().st_size
    return (
        f"{sec:.3f} s for {raw} bytes raw, {disk} on disk (ratio {disk / raw:.4f}), "
        f"{raw / sec / 1e6:.1f} MB/s of raw bytes"
    )


def _log_saves(tag: str, run_dir: Path, seconds: dict) -> None:
    """Each checkpoint save's seconds beside its bytes, raw and on disk."""
    for name, sec in sorted(seconds.items()):
        kind = "async" if name.endswith("-opt") else "sync"
        log(f"[{tag}] save {name} ({kind}): {_save_report(run_dir / 'ckpt', name, sec)}")


def _log_steps(tag: str, recs: list, direct_ms: list) -> None:
    """Each step's ms through the trainer (its NODE_START to its NODE_COMMIT, on the host's
    wall clock) beside the direct step's, and each round's wall."""
    start = {}
    for r in recs:
        if r.kind in ("NODE_START", "RUN_START"):
            start[r.node_id] = r.wall_time
        elif r.kind == "NODE_COMMIT" and r.node_id.startswith("step@"):
            s = int(r.node_id[5:])
            ms = 1e3 * (r.wall_time - start[r.node_id])
            log(
                f"[{tag}] {r.node_id}: {ms:.3f} ms through the trainer (NODE_START to "
                f"NODE_COMMIT), direct step {direct_ms[s]:.3f} ms: {ms - direct_ms[s]:+.3f} ms"
            )
        elif r.kind == "RUN_END":
            log(f"[{tag}] {r.node_id}: {r.wall_time - start[r.node_id]:.3f} s of round")


def _durable(name: str, cfg, cmd: list, run_dir: Path, direct: dict) -> dict:
    """Train ``cfg`` through the durable trainer (the train CLI run with ``cmd``), crash
    between the halves of its last checkpoint, restart and verify: run A, then run B, with
    the gates both durable phases share. ``direct`` holds the digests and ms of the same
    steps run directly at that depth. Returns both runs' results and A's CKPT refs."""
    a = _run_trainer(f"{name} A", run_dir, cmd)
    recs = _journal(run_dir)
    wal_a = (run_dir / "journal.wal").stat().st_size
    kinds = [r.kind for r in recs]
    commits = {r.node_id: r for r in recs if r.kind == "NODE_COMMIT"}
    want_nodes = {f"{k}@{s}" for k in ("data", "step") for s in range(TRAIN_STEPS)}
    want_nodes |= {"ckpt@2", f"ckpt@{TRAIN_STEPS}"}
    if (kinds.count("RUN_START"), kinds.count("RUN_END"), kinds.count("CKPT")) != (2, 2, 2):
        raise AssertionError(f"[{name} A] journal kinds {sorted(set(kinds))}: {kinds}")
    if set(commits) != want_nodes:
        raise AssertionError(f"[{name} A] commits {sorted(commits)}, want {want_nodes}")
    got = [commits[f"step@{s}"].output_digest for s in range(TRAIN_STEPS)]
    if got != direct["step_digests"]:
        raise AssertionError(
            f"[{name} A] journaled step digests {got} != the direct steps' "
            f"{direct['step_digests']}"
        )
    want_launches = _cli_launches(cfg, TRAIN_STEPS)
    if a["launches"] != want_launches or a["summary"]["steps"] != TRAIN_STEPS:
        raise AssertionError(
            f"[{name} A] launches {a['launches']} (want {want_launches}), summary {a['summary']}"
        )
    beat = a["heartbeat"]
    if beat is None or beat["devices"] != {"backend": "cuda", "count": 1}:
        raise AssertionError(f"[{name} A] heartbeat {beat}")
    log(
        f"[{name} A] journaled step digests {got} equal the direct steps'; flash launches "
        f"{a['launches']}; journal {wal_a} bytes, {len(recs)} records; CLI process "
        f"{a['wall_s']:.1f} s, trainer wall {a['summary']['wall_s']:.3f} s"
    )
    log(
        f"[{name} A] heartbeat: devices {beat['devices']}, worker {beat['worker']}, pid "
        f"{beat['pid']}, cpu load1 {beat['cpu']['load1']} of {beat['cpu']['ncpu']}, memory "
        f"used {beat['memory']['used_frac']:.4f}, uptime {beat['uptime_s']:.3f} s, probe "
        f"{1e3 * beat['probe_latency_s']:.3f} ms"
    )
    _log_steps(f"{name} A", recs, direct["step_ms"])
    _log_saves(f"{name} A", run_dir, a["summary"]["checkpoint_s"])
    ckpt_refs = [r.ref for r in recs if r.kind == "CKPT"]

    # the crash between the two halves of the last checkpoint
    last = f"step{TRAIN_STEPS:08d}"
    shutil.rmtree(run_dir / "ckpt" / f"{last}-opt")
    log(f"[{name}] deleted {last}-opt: the newest complete pair is step00000002")

    b = _run_trainer(f"{name} B", run_dir, cmd)
    new = _journal(run_dir)[len(recs) :]
    wal_b = (run_dir / "journal.wal").stat().st_size
    starts = [r.node_id for r in new if r.kind == "RUN_START"]
    ran = [r.node_id for r in new if r.kind == "NODE_START"]
    step2 = [r.output_digest for r in new if r.kind == "NODE_COMMIT" and r.node_id == "step@2"]
    refs = [r.ref for r in new if r.kind == "CKPT"]
    want_launches = _cli_launches(cfg, 1)
    if starts != ["round2"] or ran != ["step@2", f"ckpt@{TRAIN_STEPS}"]:
        raise AssertionError(f"[{name} B] rounds {starts}, nodes run {ran}")
    if step2 != [got[2]] or refs != [ckpt_refs[-1]]:
        raise AssertionError(
            f"[{name} B] step@2 {step2} (A: {got[2]}), CKPT {refs} (A: {ckpt_refs[-1]})"
        )
    if b["launches"] != want_launches or b["summary"]["steps"] != 1:
        raise AssertionError(
            f"[{name} B] launches {b['launches']} (want {want_launches}), summary {b['summary']}"
        )
    log(
        f"[{name} B] recovered from step00000002 in {b['summary']['restore_s']:.3f} s "
        f"(resolve with its content check, both shards, onto the card); step@2 re-executed "
        f"through the verify twin: digest {step2[0]} equals the journal's; {last} re-saved as "
        f"{refs[0]}, A's content digests; 1 step; flash launches {b['launches']}; journal "
        f"{wal_b} bytes; CLI process {b['wall_s']:.1f} s"
    )
    _log_steps(f"{name} B", new, direct["step_ms"])
    _log_saves(f"{name} B", run_dir, b["summary"]["checkpoint_s"])
    return {"a": a, "b": b, "refs": ckpt_refs}


def phase_durable(direct: dict) -> None:
    """Train through the durable trainer, crash between the halves of its last checkpoint,
    restart and verify (run A, then run B), at the demo's first DEMO_CUT_LAYERS layers;
    ``direct`` is the train phase's result, whose direct steps at that depth it checks."""
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    try:
        _durable("durable", _demo_cut_config(), DURABLE_CMD, DURABLE_DIR, direct["cut"])
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)


DIST_DIR = ROOT / "build" / "distributed_train"  # the runs' directories; build/ is not committed
# the data-parallel round at the train phase's sequence length: 4 shards of 2 sequences of
# 4096 tokens (a global batch of 8, train_4k's 256 cut to one card), 2 in-process workers of
# capacity 1 (at most 2 shards on the card at once), 2 steps, one checkpoint pair
DIST_SHARDS, DIST_WORKERS, DIST_STEPS = 4, 2, 2
DIST_BATCH = 2 * DIST_SHARDS
DIST_RESULT = "[distributed] result "  # the distributed process's line of launches and times


def phase_distributed(direct: dict) -> dict:
    """Run the distributed phase in a process of its own (this file with ``--distributed``),
    its log passed on line by line; log its step beside the train phase's direct step (in
    this call) and return what its result line gives."""
    result = _in_process(DIST_ARG, DIST_RESULT, "[distributed]")
    direct = direct["cut"]  # the direct steps at the phase's depth
    steady = sum(direct["step_ms"][1:]) / (len(direct["step_ms"]) - 1)
    direct_tps = TRAIN_BATCH * TRAIN_SEQ / steady * 1e3
    for tag in ("A", "B"):
        steps = result[f"step_s_{tag}"]
        tps = DIST_BATCH * TRAIN_SEQ / steps[-1]
        log(
            f"[distributed] run {tag}: {', '.join(f'{x:.3f}' for x in steps)} s a step through "
            f"the DistributedTrainer (sync@s NODE_START to apply@s NODE_COMMIT), step "
            f"{len(steps) - 1}: {tps:.1f} tokens/s of {DIST_BATCH} x {TRAIN_SEQ}; the train "
            f"phase's direct step at {DEMO_CUT_LAYERS} layers in this call {steady:.3f} ms, "
            f"{direct_tps:.1f} tokens/s of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: {tps / direct_tps:.4f}x its tokens/s "
            f"({result['smi']})"
        )
    return result


class _HostTimers:
    """Host seconds in the calls the distributed phase wraps, summed over the threads that
    make them, by kind: hashing (``payload_digest``, in the executor, the ``Digested``
    wrapper and the trainer), the copies between the card and the host (each timed after a
    device sync, whose wait is counted apart), and the fold (the shards' mean). The package
    is not changed: the phase replaces module attributes while it runs."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sec = collections.Counter()
        self.calls = collections.Counter()

    def reset(self) -> None:
        with self.lock:
            self.sec.clear()
            self.calls.clear()

    def snapshot(self) -> dict:
        with self.lock:
            return {k: (self.sec[k], self.calls[k]) for k in sorted(self.sec)}

    def _add(self, kind: str, sec: float) -> None:
        with self.lock:
            self.sec[kind] += sec
            self.calls[kind] += 1

    def _timed(self, kind: str, fn, sync: bool = False):
        def timed(*args, **kwargs):
            if sync:
                t = time.monotonic()
                torch.cuda.synchronize()
                self._add("device sync before a copy", time.monotonic() - t)
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self._add(kind, time.monotonic() - t0)
            return out

        return timed

    def installed(self):
        stack = contextlib.ExitStack()
        for mod, name, kind, sync in (
            (executor_mod, "payload_digest", "hashing", False),
            (payload_mod, "payload_digest", "hashing", False),
            (dist_mod, "payload_digest", "hashing", False),
            (dist_mod, "to_host", "device to host", True),
            (dist_mod, "from_numpy_tree", "host to device", True),
            (dist_mod, "_mean_pytrees", "fold", False),
        ):
            wrapped = self._timed(kind, getattr(mod, name), sync)
            stack.enter_context(mock.patch.object(mod, name, wrapped))
        return stack


def _dist_config(run_dir: Path) -> DistTrainConfig:
    from repro_torch.launch.train import opt_config

    return DistTrainConfig(
        run_dir=str(run_dir),
        num_steps=DIST_STEPS,
        checkpoint_every=DIST_STEPS,
        log_every=1,
        global_batch=DIST_BATCH,
        seq_len=TRAIN_SEQ,
        journal_sync="batch",
        heartbeat=False,
        num_shards=DIST_SHARDS,
        num_workers=DIST_WORKERS,
        opt=opt_config(DIST_STEPS),
    )


def _tensor_payloads(payload) -> int:
    """How many arrays a journal payload holds."""
    if isinstance(payload, dict):
        return sum(_tensor_payloads(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(_tensor_payloads(v) for v in payload)
    return int(hasattr(payload, "__array__") and np.ndim(payload) > 0)


def _dist_run(tag: str, cfg, run_dir: Path, smi: str, timers: _HostTimers, flaky=False) -> dict:
    """One ``DistributedTrainer.train()`` of DIST_STEPS steps in a fresh run dir, its
    ``grad_shard`` calls counted; w0 a ``FlakyWorker`` that dies at its second task start
    when ``flaky``. Checks the journal's nodes, that no commit holds a tensor, the launches
    and that torch's RNGs are untouched; returns what the checks across runs need."""
    per_step = cfg.num_layers
    tr = DistributedTrainer(cfg, _dist_config(run_dir), device=DEV)
    task, calls, lock = tr.registry.get("grad_shard"), [0], threading.Lock()

    def counted(ctx, sync):
        with lock:
            calls[0] += 1
        return task(ctx, sync)

    tr.registry.register("grad_shard", counted)
    if flaky:
        tr.workers = [FlakyWorker("w0", tr.registry, kill_after_starts=2, max_concurrency=1)]
        tr.workers += [
            InProcWorker(f"w{i}", tr.registry, max_concurrency=1) for i in range(1, DIST_WORKERS)
        ]
    rng = (torch.random.get_rng_state(), torch.cuda.get_rng_state())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    _reset_launches()
    t0 = time.monotonic()
    out = tr.train()
    wall = time.monotonic() - t0
    launches = [fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches]
    peak = torch.cuda.max_memory_allocated()
    host = timers.snapshot()
    if not (
        torch.equal(rng[0], torch.random.get_rng_state())
        and torch.equal(rng[1], torch.cuda.get_rng_state())
    ):
        raise AssertionError(f"[distributed {tag}] a task drew from torch's global RNG")
    recs = _journal(run_dir)
    commits = {r.node_id: r for r in recs if r.kind == "NODE_COMMIT"}
    want = {f"{k}@{s}" for k in ("sync", "reduce", "apply") for s in range(DIST_STEPS)}
    want |= {f"grad@{s}#{k}" for s in range(DIST_STEPS) for k in range(DIST_SHARDS)}
    want |= {f"ckpt@{DIST_STEPS}"}
    if set(commits) != want or out["steps"] != DIST_STEPS:
        raise AssertionError(f"[distributed {tag}] commits {sorted(commits)}, want {sorted(want)}")
    volatile = [n for n in want if n.startswith(("sync@", "grad@", "reduce@"))]
    bad = [n for n in volatile if commits[n].payload is not None or not commits[n].meta["volatile"]]
    arrays = sum(_tensor_payloads(r.payload) for r in recs)
    if bad or arrays:
        raise AssertionError(f"[distributed {tag}] payloads in volatile commits {bad}, {arrays}")
    kinds = collections.Counter(r.kind for r in recs)
    requeues = [(r.node_id, r.meta.get("reason")) for r in recs if r.kind == "NODE_REQUEUE"]
    # every shard of every step ran once, and again for each requeue of a shard that w0
    # had started before the gateway evicted it
    shard_runs = DIST_STEPS * DIST_SHARDS
    if launches != [per_step * calls[0]] * 2 or not (
        shard_runs <= calls[0] <= shard_runs + len(requeues)
    ):
        raise AssertionError(
            f"[distributed {tag}] flash launches {launches}, grad_shard calls {calls[0]}, "
            f"requeues {len(requeues)}"
        )
    if flaky != bool(requeues):
        raise AssertionError(f"[distributed {tag}] NODE_REQUEUE records {requeues}")
    starts = {r.node_id: r.wall_time for r in recs if r.kind == "NODE_START"}
    step_s = [
        commits[f"apply@{s}"].wall_time - starts[f"sync@{s}"] for s in range(DIST_STEPS)
    ]
    digest = tr.store.manifest(tr.store.latest())["digest"]
    wal = (run_dir / "journal.wal").stat().st_size
    killed = " (w0 dies at its 2nd task start)" if flaky else ""
    log(
        f"[distributed {tag}] {DIST_STEPS} steps of {DIST_SHARDS} shards x 2 x {TRAIN_SEQ} "
        f"tokens on {DIST_WORKERS} in-process workers{killed}: "
        f"train() {wall:.3f} s, steps {', '.join(f'{x:.3f}' for x in step_s)} s; grad_shard "
        f"calls {calls[0]}; flash_attention_fwd launches {launches[0]}, flash_attention_bwd "
        f"launches {launches[1]} = {per_step} layers x {calls[0]} shard runs; journal "
        f"{dict(sorted(kinds.items()))}, {wal} bytes, no array in any record; checkpoint "
        f"digest {digest}; max_memory_allocated {peak} bytes ({peak - held} above the {held} "
        f"held before); torch's CPU and CUDA RNG states unchanged ({smi})"
    )
    if requeues:
        log(f"[distributed {tag}] NODE_REQUEUE {requeues}")
    for kind, (sec, n) in host.items():
        log(
            f"[distributed {tag}] host {kind}: {sec:.3f} s in {n} calls over the run, "
            f"{sec / DIST_STEPS:.3f} s a step ({smi})"
        )
    for name, sec in sorted(out["checkpoint_s"].items()):
        report = _save_report(run_dir / "ckpt", name, sec)
        log(f"[distributed {tag}] save {name}: {report} ({smi})")
    result = {
        "digest": digest,
        "step_s": step_s,
        "launches": launches,
        "calls": calls[0],
        "requeues": len(requeues),
        "peak": peak,
        "grads": {n: commits[n].output_digest for n in want if n.startswith("grad@")},
        "applies": {n: commits[n].output_digest for n in want if n.startswith("apply@")},
    }
    del tr
    _release()
    return result


def _direct_step0(cfg, smi: str) -> dict:
    """Step 0 of the distributed round computed directly, on this thread, from the
    trainer's seed init: each shard's ``grad_shard`` in shard order, the mean, AdamW;
    returns each shard's output digest, the apply's metrics digest and the state after."""
    from repro_torch.train.host import to_host

    dev = torch.device(DEV)
    model = build(cfg, dev)
    opt = _dist_config(DIST_DIR / "direct").opt
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = make_opt_init(model, opt)(params)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=DIST_BATCH)
    task = dist_mod.build_grad_registry(model, data).get("grad_shard")
    sync = {"step": 0, "params": to_host(params)}
    _reset_launches()
    shards = [
        task(Context.origin({"shard": k, "num_shards": DIST_SHARDS}), sync)
        for k in range(DIST_SHARDS)
    ]
    launches = [fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches]
    if launches != [cfg.num_layers * DIST_SHARDS] * 2:
        raise AssertionError(f"[distributed] direct step 0: flash launches {launches}")
    mean = dist_mod._mean_pytrees([sh["grads"] for sh in shards])
    with torch.no_grad():
        grads = tree_map(lambda x: torch.from_numpy(x).to(dev), mean)
        new_params, new_state, metrics = adamw_update(params, grads, state, opt)
    out = {
        "step": 0,
        "loss": float(sum(sh["loss"] for sh in shards) / len(shards)),
        "grad_norm": float(metrics["grad_norm"]),
        "lr": float(metrics["lr"]),
    }
    log(
        f"[distributed] step 0 directly (this thread, shards in order): loss {out['loss']:.6f}, "
        f"grad_norm {out['grad_norm']:.6f}, lr {out['lr']:.4e}; flash launches {launches} ({smi})"
    )
    return {
        "grads": {f"grad@0#{k}": payload_digest(sh) for k, sh in enumerate(shards)},
        "apply": payload_digest(out),
        "state": {"params": new_params, "opt": new_state},
    }


def dist_main() -> int:
    """The distributed process: run A, run B with a worker killed, step 0 directly; checks A
    against B and against the direct step."""
    smi = phase_device()
    cfg = _demo_cut_config()
    torch.use_deterministic_algorithms(True)
    timers = _HostTimers()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    try:
        with timers.installed():
            a = _dist_run("A", cfg, DIST_DIR / "A", smi, timers)
            b = _dist_run("B", cfg, DIST_DIR / "B", smi, timers, flaky=True)
            same = b["grads"] == a["grads"] and b["applies"] == a["applies"]
            if b["digest"] != a["digest"] or not same:
                raise AssertionError(
                    f"[distributed] run B (a worker killed) ends at {b['digest']}, run A at "
                    f"{a['digest']}; grad digests equal: {b['grads'] == a['grads']}, apply "
                    f"digests equal: {b['applies'] == a['applies']}"
                )
            log(
                f"[distributed] run B's checkpoint digest {b['digest']} equals run A's, and "
                f"every grad@s#k and apply@s output digest equals A's; B requeued "
                f"{b['requeues']} shard(s), ran {b['calls']} grad_shard calls"
            )
            direct = _direct_step0(cfg, smi)
            want0 = {n: d for n, d in a["grads"].items() if n.startswith("grad@0#")}
            if direct["grads"] != want0 or direct["apply"] != a["applies"]["apply@0"]:
                raise AssertionError(
                    f"[distributed] step 0 directly: grads {direct['grads']} apply "
                    f"{direct['apply']}; run A: {want0} {a['applies']['apply@0']}"
                )
            log(
                f"[distributed] step 0 directly gives run A's grad@0#k digests and its apply@0 "
                f"metrics digest {direct['apply']}"
            )
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    result = {
        "smi": smi,
        "step_s_A": a["step_s"],
        "step_s_B": b["step_s"],
        "launches_A": a["launches"],
        "launches_B": b["launches"],
        "peak_A": a["peak"],
    }
    log(DIST_RESULT + json.dumps(result))
    return 0


def check_against_cpu(cfg, model, params, prompt) -> None:
    """Prefill logits on the card (kernel path) vs the port's CPU path (plain
    versions), same params, on the shortest prompt: finite, same shape, within
    1e-4 (the CPU parity tolerance of tests/test_torch_model.py)."""
    toks = torch.as_tensor(prompt, dtype=torch.long)[None, :]
    got, _ = model.prefill(params, {"tokens": toks.to(model.device)})
    want, _ = build(cfg, "cpu").prefill(_to_cpu(params), {"tokens": toks})
    got = got.cpu()
    err = (got - want).abs().max().item()
    if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all() or err > 1e-4:
        raise AssertionError(f"[demo] logits {tuple(got.shape)} vs CPU path: max |err| {err:.3e}")
    log(f"[demo] prefill logits (S={len(prompt)}) card vs CPU path: max |err| {err:.3e} (tol 1e-4)")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def hybrid_prompts(vocab: int, seed: int = 0):
    """8 prompts, lengths drawn in [64, 3000]; r0 and r5 above the window, r3
    (2032 tokens) below it, crossing it in its 17th decode step."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 3001, size=N_REQUESTS)
    lens[0], lens[5] = rng.integers(2049, 3001, size=2)
    lens[3] = 2048 - NEW_TOKENS // 2
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def _recording(model, engine_box):
    """``model`` with prefill and decode_step that keep each request's logits on the host."""
    seen = {"prefill": [], "decode": {}}

    def prefill(params, batch, pad_to=0):
        logits, cache = model.prefill(params, batch, pad_to=pad_to)
        seen["prefill"].append(logits[0].float().cpu())  # admission order: r0, r1, ...
        return logits, cache

    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch)
        host = logits.float().cpu()
        for i, slot in enumerate(engine_box[0]._slots):
            if slot.active:
                seen["decode"].setdefault(slot.rid, []).append(host[i])
        return logits, cache

    return dataclasses.replace(model, prefill=prefill, decode_step=decode_step), seen


def _serve_recorded(model, params, prompts, max_len):
    """Warm up, then drain ``prompts`` through a 4-slot batcher with every kernel's
    launch count set to 0 just before; returns (serving numbers, the logits each
    request saw, peak device memory). The caller reads the counts right after."""
    model.prefill(params, {"tokens": torch.zeros((1, 64), dtype=torch.long, device=DEV)})
    zeros = torch.zeros(SLOTS, dtype=torch.long, device=DEV)
    model.decode_step(params, model.init_cache(SLOTS, max_len), {"token": zeros})
    engine_box = []
    rec_model, seen = _recording(model, engine_box)
    eng = ContinuousBatcher(rec_model, params, slots=SLOTS, max_len=max_len)
    engine_box.append(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res = drain(eng, prompts, new_tokens=NEW_TOKENS)
    return res, seen, torch.cuda.max_memory_allocated()


def _teacher_forced(model, params, prompt, toks, rows, max_len=HYBRID_MAX_LEN):
    """Logits of one request decoded alone and fed ``toks``: at batch 1, or with its
    cache spliced into all ``rows`` rows of a batch (row 0's logits, the batcher's
    matmul shapes)."""
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
    logits, cache = model.prefill(params, {"tokens": ids}, pad_to=max_len)
    if rows > 1:
        fresh, cache = cache, model.init_cache(rows, max_len)
        for r in range(rows):
            _splice_cache(cache, fresh, r)
    out = [logits[0].float().cpu()]
    for t in toks:
        tok = torch.full((rows,), t, dtype=torch.long, device=DEV)
        logits, cache = model.decode_step(params, cache, {"token": tok})
        out.append(logits[0].float().cpu())
    return out


def _layer_counts(cfg):
    pattern = cfg.block_pattern
    return pattern.count("rec"), pattern.count("attn")


def phase_hybrid() -> dict:
    """Serve full-width recurrentgemma-9b at HYBRID_SERVE_LAYERS of its 38 layers; returns
    launch counts and serving numbers."""
    base = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(
        base,
        num_layers=HYBRID_SERVE_LAYERS,
        block_pattern=base.block_pattern[:HYBRID_SERVE_LAYERS],
    )
    n_rec, n_attn = _layer_counts(cfg)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    log(
        f"[hybrid] {cfg.name}: {cfg.num_layers} layers ({n_rec} rec, {n_attn} attn, window "
        f"{cfg.window}), d={cfg.d_model}, lru_width {cfg.lru_width}, {cfg.param_count()} params "
        f"{cfg.param_dtype} ({torch.cuda.memory_allocated()} bytes on the card); drawn in "
        f"{time.monotonic() - t0:.1f} s"
    )
    prompts = hybrid_prompts(cfg.vocab_size)
    log(f"[hybrid] prompt lengths {[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")
    res, seen, peak = _serve_recorded(model, params, prompts, HYBRID_MAX_LEN)
    flash_launches, rglru_launches = fa.flash_attention_fwd.launches, rg.rglru_scan.launches
    decode_launches, wkv6_launches = da.decode_attention.launches, wk.wkv6_chunked.launches

    want_flash = n_attn * len(prompts)
    want_decode = n_attn * res["steps"]
    want_rglru = n_rec * (len(prompts) + res["steps"])
    got = (flash_launches, decode_launches, rglru_launches, wkv6_launches)
    if got != (want_flash, want_decode, want_rglru, 0):
        raise AssertionError(
            f"[hybrid] launches flash {flash_launches} (expected {want_flash}), decode_attention "
            f"{decode_launches} (expected {want_decode}), rglru {rglru_launches} (expected "
            f"{want_rglru}), wkv6 {wkv6_launches} (expected 0)"
        )
    log(
        f"[hybrid] flash_attention_fwd launches {flash_launches} = {n_attn} attn layers x "
        f"{len(prompts)} prefills ({fa.PATHS[torch.bfloat16]} path); decode_attention launches "
        f"{decode_launches} = {n_attn} attn layers x {res['steps']} decode steps; rglru_scan "
        f"launches {rglru_launches} = {n_rec} rec layers x ({len(prompts)} prefills + "
        f"{res['steps']} decode steps)"
    )

    _check_teacher_forced("[hybrid]", model, params, prompts, res, seen, LOGIT_TOL_BF16)
    _check_unembed("[hybrid]", model, params, min(prompts, key=len))
    _log_serving("[hybrid]", res, peak)
    _prefill_profile(model, params, "[hybrid]", prompts[0], HYBRID_MAX_LEN)
    _decode_profile(model, params, "[hybrid]", HYBRID_MAX_LEN)
    return {"flash": flash_launches, "decode_attention": decode_launches, "rglru": rglru_launches}


@contextlib.contextmanager
def _decode_routes(rows: int, out: list):
    """Record, into ``out``, the experts the MoE router picks for row 0 of each decode step
    (a router call on ``rows`` tokens; prefills have a prompt's length), in call order."""
    router = moe_mod._router

    def recording(x_flat, *args):
        weights, idx, aux = router(x_flat, *args)
        if x_flat.shape[0] == rows:
            out.append(idx[0])
        return weights, idx, aux

    moe_mod._router = recording
    try:
        yield out
    finally:
        moe_mod._router = router


@contextlib.contextmanager
def _decode_router_rows(rows: int, out: list):
    """Record, into ``out``, row 0 of each router call on ``rows`` tokens (the decode steps;
    prefills have a prompt's length), in call order: its input in float32, its probabilities
    over the experts (recomputed with the router's own product on the call's whole input, so
    with its bits) and the expert ids it picked."""
    router = moe_mod._router

    def recording(x_flat, p, *args):
        weights, idx, aux = router(x_flat, p, *args)
        if x_flat.shape[0] == rows:
            probs = torch.softmax(dense(x_flat, p["router"]).float(), dim=-1)[0]
            out.append((x_flat[0].float(), probs, idx[0]))
        return weights, idx, aux

    moe_mod._router = recording
    try:
        yield out
    finally:
        moe_mod._router = router


def _flip_steps(tag, rid, alone: list, wide: list, k: int):
    """The decode steps (one MoE layer: router call j is step j) whose experts differ between
    the batch-1 and the wide run, each held to a flip's terms: the router's input within
    ROUTER_INPUT_TOL of the wide run's (max |a - b| over max |b|), and the batch-1 run's top-k
    boundary gap no larger than twice the largest difference of the two runs' probabilities
    (the most two rounding paths can move a boundary). Returns (flipped steps, every step's
    boundary gap at batch 1)."""
    if len(alone) != len(wide):
        raise AssertionError(f"{tag} {rid} router calls: {len(alone)} at batch 1, {len(wide)} wide")
    steps, gaps = set(), []
    for j, ((xa, pa, ia), (xw, pw, iw)) in enumerate(zip(alone, wide)):
        top = torch.sort(pa, descending=True).values
        gap = (top[k - 1] - top[k]).item()
        gaps.append(gap)
        if torch.equal(torch.sort(ia).values, torch.sort(iw).values):
            continue
        noise = 2 * (pa - pw).abs().max().item()
        drift = ((xa - xw).abs().max() / xw.abs().max()).item()
        log(
            f"{tag} {rid} decode step {j}: routing flipped at batch 1; top-{k} boundary gap "
            f"{gap:.3e} against the runs' probability difference x 2 {noise:.3e}; router input "
            f"drift {drift:.3e} of its scale (tol {ROUTER_INPUT_TOL:.4f})"
        )
        if gap > noise or drift > ROUTER_INPUT_TOL:
            raise AssertionError(f"{tag} {rid} decode step {j}: routing flipped without a tie")
        steps.add(j)
    return steps, gaps


def _route_flips(alone: list, wide: list) -> int:
    """Router calls (layers x decode steps) whose expert set differs between two runs."""
    if len(alone) != len(wide):
        raise AssertionError(f"router calls: {len(alone)} at batch 1, {len(wide)} wide")
    if not alone:
        return 0
    a = torch.sort(torch.stack(alone), dim=-1).values
    b = torch.sort(torch.stack(wide), dim=-1).values
    return int((a != b).any(dim=-1).sum())


def _check_teacher_forced(
    tag, model, params, prompts, res, seen, tol, max_len=HYBRID_MAX_LEN, routes=False,
    flip_steps=False,
):
    """Each request's batched logits (prefill and every decode step) against a
    teacher-forced run of it alone, fed its batched tokens: at batch 1 within
    ``tol``, at the batcher's width bit for bit (SAME_SHAPE_TOL). With ``routes``, the
    decode steps' MoE routing flips between the two runs are counted and logged. With
    ``flip_steps`` (one MoE layer, the last), a decode step whose routing flips is held to
    the flip's terms (_flip_steps) in place of ``tol``, and the top-k boundary gaps are
    logged."""
    done = res["generations"]
    worst, worst_wide, total, flips, route_flips = 0.0, 0.0, 0, 0, 0
    all_gaps = []
    for i, prompt in enumerate(prompts):
        rid = f"r{i}"
        toks = done[rid].tokens
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"{tag} {rid}: {len(toks)} tokens, expected {NEW_TOKENS}")
        batched = [seen["prefill"][i]] + seen["decode"][rid]
        alone_routes, wide_routes = [], []
        record = _decode_router_rows if flip_steps else _decode_routes
        with record(1, alone_routes) if routes else contextlib.nullcontext():
            forced = _teacher_forced(model, params, prompt, toks, rows=1, max_len=max_len)
        with record(SLOTS, wide_routes) if routes else contextlib.nullcontext():
            wide = _teacher_forced(model, params, prompt, toks, rows=SLOTS, max_len=max_len)
        if flip_steps:
            skip, gaps = _flip_steps(
                tag, rid, alone_routes, wide_routes, model.cfg.num_experts_per_tok
            )
            if len(gaps) != len(toks):
                raise AssertionError(f"{tag} {rid}: {len(gaps)} router calls, {len(toks)} steps")
            flipped = len(skip)
            all_gaps += gaps
        else:
            skip, flipped = set(), _route_flips(alone_routes, wide_routes)
        route_flips += flipped
        if not len(batched) == len(forced) == len(wide):
            raise AssertionError(f"{tag} {rid}: {len(batched)} logits, {len(forced)} sequential")
        errs = [(b_ - f_).abs().max().item() for b_, f_ in zip(batched, forced)]
        held = [e for i, e in enumerate(errs) if i - 1 not in skip]  # logits i: decode step i-1
        wide_err = max((b_ - w_).abs().max().item() for b_, w_ in zip(batched, wide))
        finite = all(torch.isfinite(b_).all() for b_ in batched)
        diff = sum(int(torch.argmax(f_)) != t for f_, t in zip(forced, toks))
        worst, total, flips = max(worst, max(held)), total + len(toks), flips + diff
        worst_wide = max(worst_wide, wide_err)
        if not finite or max(held) > tol or wide_err > SAME_SHAPE_TOL:
            raise AssertionError(
                f"{tag} {rid}: logits vs teacher-forced: {max(errs):.4f} at batch 1, "
                f"{wide_err:.4e} at batch {SLOTS}"
            )
        routed = f"; routing flips at batch 1 {flipped}/{len(alone_routes)}" if routes else ""
        if skip:
            routed += (
                f" (steps {sorted(skip)}: logits max |err| "
                f"{max(errs[j + 1] for j in skip):.4e}, held to the flip's terms)"
            )
        log(
            f"{tag} {rid} (prompt {len(prompt)}): logits vs teacher-forced sequential max |err| "
            f"{max(errs):.4e}, mean of per-step max {np.mean(errs):.4e}, greedy tokens that "
            f"differ {diff}/{len(toks)}; at the batcher's width {wide_err:.4e}{routed}"
        )
    routed = f"; routing flips at batch 1 {route_flips}" if routes else ""
    if all_gaps:
        g = np.asarray(all_gaps)
        routed += (
            f" in {len(g)} router calls; top-k boundary gaps at batch 1: min {g.min():.3e}, "
            f"median {np.median(g):.3e}, {int((g < 1e-4).sum())} below 1e-4"
        )
    held_at = "; steps without a flip" if flip_steps else ""
    log(
        f"{tag} all requests: max |err| {worst:.4e} (tol {tol}{held_at}), greedy tokens that "
        f"differ {flips}/{total}; at the batcher's width {worst_wide:.4e} (tol {SAME_SHAPE_TOL})"
        f"{routed}"
    )


def _check_unembed(tag, model, params, prompt) -> None:
    """``unembed_logits`` on one prefill's last hidden states, at decode's rows (SLOTS)
    and prefill's (1), against the final norm, a product of the bf16 operands taken in
    float32, the softcap and the padding, within UNEMBED_TOL."""
    cfg = model.cfg
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
    with torch.no_grad():
        h = params["embed"]["table"][ids].to(torch.bfloat16)
        positions = torch.arange(h.shape[1], device=DEV)
        h, _, _ = run_stack(h, params, cfg, model.segments, positions=positions, mode="prefill")
        w = params["embed"]["table"].t() if cfg.tie_embeddings else params["unembed"]
        if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise AssertionError(f"{tag} unembed operands {h.dtype} and {w.dtype}, not bfloat16")
        worst = 0.0
        for rows in (h[0, -SLOTS:, :], h[0, -1:, :]):
            got = unembed_logits(params, rows, cfg)
            hn = apply_norm(rows, params["final_norm"], cfg.norm, cfg.norm_eps).float()
            cols = range(0, w.shape[1], 32768)
            want = torch.cat([hn @ w[:, i : i + 32768].float() for i in cols], dim=1)
            want = softcap(want, cfg.logit_softcap)
            want[:, cfg.vocab_size :] = -1e30
            if got.shape != want.shape or not torch.isfinite(got[:, : cfg.vocab_size]).all():
                raise AssertionError(f"{tag} unembed: {tuple(got.shape)} vs {tuple(want.shape)}")
            worst = max(worst, (got - want).abs().max().item())
    if worst > UNEMBED_TOL:
        raise AssertionError(f"{tag} unembed vs float32 operands: max |err| {worst:.4e}")
    log(
        f"{tag} unembed (bf16 x bf16 -> float32, {tuple(w.shape)}) vs float32 operands at "
        f"{SLOTS} and 1 rows of a {len(prompt)}-token prefill: max |err| {worst:.4e} "
        f"({worst / UNEMBED_TOL:.1%} of tol {UNEMBED_TOL})"
    )


def _log_serving(tag, res, peak) -> None:
    log(
        f"{tag} {res['tokens']} tokens in {res['wall_s']:.4f} s: {res['tok_per_s']:.2f} tok/s; "
        f"prefill {res['prefill_ms_mean']:.3f} ms mean; decode {res['decode_ms_per_step']:.3f} "
        f"ms/step over {res['steps']} steps; max_memory_allocated {peak} bytes "
        f"(times include copying each step's logits to the host for the check)"
    )


def _kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name as the profiler reports it."""
    low = name.lower()
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy"
    if "flash_fwd" in name or "flash_merge" in name:
        return "flash"
    if "flash_bwd" in name:
        return "flash_bwd"
    if "decode_attention" in name:
        return "decode_attention"
    if "rglru_bwd" in name:
        return "rglru_bwd"
    if "rglru" in name:
        return "rglru"
    if "wkv6_bwd" in name:
        return "wkv6_bwd"
    if "wkv6" in name:
        return "wkv6"
    if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "gemm"
    if "at::native" in name or "at_cuda_detail" in name:
        return "elementwise"  # PyTorch's elementwise, reduction, copy, index kernels
    return "other"


def _device_rows(prof):
    """(device us, launches, name) of each kernel a profiler saw run, the longest first:
    device-side events only, since an aten op's row repeats its kernels' time."""
    return sorted(
        (
            (e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )


def _device_kinds(rows):
    """Device ms and launches by kind of kernel, from ``_device_rows``."""
    kinds, launches = {}, {}
    for us, n, name in rows:
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        launches[kind] = launches.get(kind, 0) + n
    return kinds, launches


def _prefill_profile(model, params, tag: str, prompt, max_len: int) -> None:
    """One prefill of ``prompt`` as the batcher runs it (padded to ``max_len``), warmed once,
    through ``_profile``."""
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]

    def prefill():
        model.prefill(params, {"tokens": ids}, pad_to=max_len)

    prefill()
    _profile(tag, f"prefill of {len(prompt)} tokens", prefill, host=True)


def _decode_profile(model, params, tag: str, max_len: int, steps: int = 5) -> None:
    """A 4-slot decode step, warmed twice, through ``_profile``."""
    cache = model.init_cache(SLOTS, max_len)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=DEV)

    def step():
        model.decode_step(params, cache, {"token": tok})

    for _ in range(2):
        step()
    _profile(tag, "decode step (4 slots)", step, steps, host=True)


def phase_exactness() -> dict:
    """Float32 recurrentgemma-9b at full width, depth 3: exact batched tokens,
    decode across the window = fresh prefill, layers on the card = CPU path.
    Returns the kernels' launch counts of the batched run."""
    base = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(
        base,
        name=base.name + "-f32-depth3",
        num_layers=3,
        block_pattern=("rec", "rec", "attn"),
        param_dtype="float32",
        compute_dtype="float32",
    )
    params = init_params(cfg, _gen(1), DEV)
    model = build(cfg, DEV)
    log(f"[exact] {cfg.name}: {cfg.param_count()} params float32, segments {model.segments}")
    prompts = hybrid_prompts(cfg.vocab_size)

    seq = {}
    for i, p in enumerate(prompts):
        seq[f"r{i}"] = _sequential(model, params, p, NEW_TOKENS, HYBRID_MAX_LEN)
    _reset_launches()
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=HYBRID_MAX_LEN)
    counts = {
        "flash": fa.flash_attention_fwd.launches,
        "decode_attention": da.decode_attention.launches,
    }
    if not all(counts.values()):
        raise AssertionError(f"[exact] a kernel of the float32 path never ran: {counts}")
    for rid, (toks, _) in seq.items():
        if res["generations"][rid].tokens != toks:
            got = res["generations"][rid].tokens
            raise AssertionError(f"[exact] {rid}: batched {got} != sequential {toks}")
    log(
        f"[exact] tokens of all {len(seq)} requests equal sequential greedy decoding; launches "
        f"in the batched run: flash {counts['flash']} ({fa.PATHS[torch.float32]} path), "
        f"decode_attention {counts['decode_attention']}"
    )

    crossing = next(i for i, p in enumerate(prompts) if len(p) < base.window < len(p) + NEW_TOKENS)
    toks, logits = seq[f"r{crossing}"]
    full = np.concatenate([prompts[crossing], np.asarray(toks, np.int32)])
    full_t = torch.as_tensor(full, dtype=torch.long, device=DEV)[None]
    fresh, _ = model.prefill(params, {"tokens": full_t})
    err = (logits - fresh).abs().max().item()
    if not torch.isfinite(logits).all() or err > EXACT_TOL:
        raise AssertionError(f"[exact] decode across the window vs prefill: max |err| {err:.3e}")
    log(
        f"[exact] r{crossing}: prompt {len(prompts[crossing])} + {NEW_TOKENS} decoded (window "
        f"{base.window}): last decode logits vs fresh prefill of {len(full)} tokens max |err| "
        f"{err:.3e} (tol {EXACT_TOL})"
    )

    x = np.random.default_rng(3).normal(size=LAYER_CHECK_SHAPE).astype(np.float32)
    positions = torch.arange(LAYER_CHECK_SHAPE[1])
    for si, (unit, _) in enumerate(model.segments):
        kind = unit[0]
        lp = _index(params[f"seg{si}"]["u0"], 0)
        got, got_cache, _ = apply_layer(
            torch.from_numpy(x).to(DEV), lp, cfg, kind, positions=positions.to(DEV), mode="prefill"
        )
        want, want_cache, _ = apply_layer(
            torch.from_numpy(x), _to_cpu(lp), cfg, kind, positions=positions, mode="prefill"
        )
        errs = {"h": (got.cpu() - want).abs().max().item()}
        for k, want_leaf in want_cache.items():
            errs[k] = (got_cache[k].cpu().float() - want_leaf.float()).abs().max().item()
        if not torch.isfinite(got).all() or max(errs.values()) > EXACT_TOL:
            raise AssertionError(f"[exact] {kind} layer card vs CPU path: {errs}")
        log(
            f"[exact] one {kind} layer on x{LAYER_CHECK_SHAPE}: card (kernel) vs CPU path (plain) "
            f"max |err| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {EXACT_TOL})"
        )
    return counts


def rwkv_prompts(vocab: int, seed: int = 0):
    """8 prompts, lengths drawn in [64, 3000]; r6 (11 tokens) is shorter than a
    WKV chunk and r2 (2048) a multiple of it."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 3001, size=N_REQUESTS)
    lens[6], lens[2] = 11, 2048
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def phase_rwkv() -> int:
    """Serve full-width rwkv6-7b at RWKV_SERVE_LAYERS of its 32 layers; returns the WKV6
    kernel's launch count."""
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=RWKV_SERVE_LAYERS)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    log(
        f"[rwkv] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_size} heads of {cfg.rwkv_head_size}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.param_count()} params {cfg.param_dtype}; segments "
        f"{model.segments}; drawn in {time.monotonic() - t0:.1f} s"
    )
    prompts = rwkv_prompts(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    ragged = sum(n % wk.CHUNK != 0 for n in lens)
    log(
        f"[rwkv] prompt lengths {lens} ({ragged} of {len(lens)} no multiple of {wk.CHUNK}), "
        f"{NEW_TOKENS} new tokens each"
    )
    res, seen, peak = _serve_recorded(model, params, prompts, RWKV_MAX_LEN)
    launches = wk.wkv6_chunked.launches
    others = (
        fa.flash_attention_fwd.launches + da.decode_attention.launches + rg.rglru_scan.launches
    )

    want = cfg.num_layers * (len(prompts) + res["steps"])
    if launches != want or others:
        raise AssertionError(
            f"[rwkv] wkv6 launches {launches} (expected {want}), flash + decode_attention + "
            f"rglru {others} (expected 0)"
        )
    log(
        f"[rwkv] wkv6_chunked launches {launches} = {cfg.num_layers} layers x ({len(prompts)} "
        f"prefills + {res['steps']} decode steps); flash, decode_attention and rglru 0"
    )
    _check_teacher_forced("[rwkv]", model, params, prompts, res, seen, LOGIT_TOL_RWKV, RWKV_MAX_LEN)
    _check_unembed("[rwkv]", model, params, min(prompts, key=len))
    _log_serving("[rwkv]", res, peak)
    _prefill_profile(model, params, "[rwkv]", prompts[0], RWKV_MAX_LEN)
    _decode_profile(model, params, "[rwkv]", RWKV_MAX_LEN)
    return launches


def phase_rwkv_exactness() -> None:
    """Float32 rwkv6-7b at full width, depth 2: exact batched tokens, decode =
    fresh prefill, one layer on the card = CPU path."""
    base = get_config("rwkv6-7b")
    cfg = dataclasses.replace(
        base,
        name=base.name + "-f32-depth2",
        num_layers=2,
        param_dtype="float32",
        compute_dtype="float32",
    )
    params = init_params(cfg, _gen(1), DEV)
    model = build(cfg, DEV)
    log(f"[rwkv-exact] {cfg.name}: {cfg.param_count()} params float32, segments {model.segments}")
    prompts = rwkv_prompts(cfg.vocab_size)

    seq = {}
    for i, p in enumerate(prompts):
        seq[f"r{i}"] = _sequential(model, params, p, NEW_TOKENS, RWKV_MAX_LEN)
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=RWKV_MAX_LEN)
    for rid, (toks, _) in seq.items():
        if res["generations"][rid].tokens != toks:
            got = res["generations"][rid].tokens
            raise AssertionError(f"[rwkv-exact] {rid}: batched {got} != sequential {toks}")
    log(f"[rwkv-exact] tokens of all {len(seq)} requests equal sequential greedy decoding")

    # the shortest prompt (under a chunk) and the longest
    for i in (int(np.argmin([len(p) for p in prompts])), int(np.argmax([len(p) for p in prompts]))):
        toks, logits = seq[f"r{i}"]
        full = np.concatenate([prompts[i], np.asarray(toks, np.int32)])
        fresh, _ = model.prefill(params, {"tokens": torch.as_tensor(full, device=DEV)[None].long()})
        err = (logits - fresh).abs().max().item()
        if not torch.isfinite(logits).all() or err > EXACT_TOL:
            raise AssertionError(f"[rwkv-exact] r{i}: decode vs prefill: max |err| {err:.3e}")
        log(
            f"[rwkv-exact] r{i}: prompt {len(prompts[i])} + {NEW_TOKENS} decoded: last decode "
            f"logits vs fresh prefill of {len(full)} tokens max |err| {err:.3e} (tol {EXACT_TOL})"
        )

    x = np.random.default_rng(3).normal(size=RWKV_LAYER_CHECK_SHAPE).astype(np.float32)
    positions = torch.arange(RWKV_LAYER_CHECK_SHAPE[1])
    lp = _index(params["seg0"]["u0"], 0)
    got, got_cache, _ = apply_layer(
        torch.from_numpy(x).to(DEV), lp, cfg, "rwkv", positions=positions.to(DEV), mode="prefill"
    )
    want, want_cache, _ = apply_layer(
        torch.from_numpy(x), _to_cpu(lp), cfg, "rwkv", positions=positions, mode="prefill"
    )
    errs = {"h": (got.cpu() - want).abs().max().item()}
    for k, want_leaf in want_cache.items():
        errs[k] = (got_cache[k].cpu() - want_leaf).abs().max().item()
    if not torch.isfinite(got).all() or max(errs.values()) > EXACT_TOL:
        raise AssertionError(f"[rwkv-exact] rwkv layer card vs CPU path: {errs}")
    log(
        f"[rwkv-exact] one rwkv layer on x{RWKV_LAYER_CHECK_SHAPE}: card (kernel) vs CPU path "
        f"(plain) max |err| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
        f"(tol {EXACT_TOL})"
    )


# The dense family at full width (src/repro_torch/configs/archs.py), served in bfloat16.
# qwen1.5-110b runs 4 of its 80 layers: at full depth its 111.2B bfloat16 parameters
# (222.4 GB) do not fit on one 80 GB card; the cut keeps every width (8 layers until the moe
# phase came and the script's time had to shrink). The other three run half their layers
# since the deepseek phase came, for the same reason: every gate holds at any depth (one
# host ran the script's phases 9% slower than another, 1049.6 s against 959.0 s).
DENSE_ARCHS = ("qwen3-1.7b", "stablelm-1.6b", "yi-6b", "qwen1.5-110b")
DENSE_DEPTH = {"qwen3-1.7b": 14, "stablelm-1.6b": 12, "yi-6b": 16, "qwen1.5-110b": 4}
DENSE_LAYER_CHECK = 777  # rows of the float32 layer check's (1, S, d) input


def _dense_config(arch):
    cfg = get_config(arch)
    if arch in DENSE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=DENSE_DEPTH[arch])
    return cfg


def phase_dense() -> dict:
    """Serve each dense model at full width, one after the other; returns each model's
    flash and decode-attention launch counts."""
    return {arch: _serve_dense(arch) for arch in DENSE_ARCHS}


def _serve_dense(arch) -> dict:
    """One dense model in bfloat16: 8 requests of NEW_TOKENS through the 4-slot batcher at
    MAX_LEN; the launch gates, teacher-forced logits, a float32 layer on the card against
    the CPU path, serving numbers and a profiled decode window. Frees the model after."""
    tag = f"[dense {arch}]"
    cfg = _dense_config(arch)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    depth = f"{cfg.num_layers} of {get_config(arch).num_layers}" if arch in DENSE_DEPTH else (
        f"{cfg.num_layers}"
    )
    log(
        f"{tag} {depth} layers, d={cfg.d_model}, {cfg.num_heads} heads on {cfg.num_kv_heads} "
        f"KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count()} params {cfg.param_dtype} ({torch.cuda.memory_allocated()} bytes "
        f"on the card); drawn in {time.monotonic() - t0:.1f} s"
    )
    prompts = make_prompts(N_REQUESTS, cfg.vocab_size, 64, 1000, seed=0)
    log(f"{tag} prompt lengths {[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")
    res, seen, peak = _serve_recorded(model, params, prompts, MAX_LEN)
    launches = {
        "flash": fa.flash_attention_fwd.launches,
        "decode_attention": da.decode_attention.launches,
    }
    others = (
        fa.flash_attention_bwd.launches,
        rg.rglru_scan.launches,
        wk.wkv6_chunked.launches,
    )
    want = {
        "flash": cfg.num_layers * len(prompts),
        "decode_attention": cfg.num_layers * res["steps"],
    }
    if launches != want or any(others):
        raise AssertionError(
            f"{tag} launches {launches}, expected {want}; flash backward, rglru, wkv6 "
            f"launches {others}, expected 0"
        )
    log(
        f"{tag} flash_attention_fwd launches {launches['flash']} = {cfg.num_layers} layers x "
        f"{len(prompts)} prefills ({fa.PATHS[torch.bfloat16]} path); decode_attention "
        f"launches {launches['decode_attention']} = {cfg.num_layers} layers x {res['steps']} "
        "decode steps"
    )
    _check_teacher_forced(tag, model, params, prompts, res, seen, LOGIT_TOL_BF16, MAX_LEN)
    _log_serving(tag, res, peak)
    _decode_profile(model, params, tag, MAX_LEN)
    del model, params, res, seen
    _release()
    _dense_layer_check(tag, cfg)
    _release()
    return launches


def _dense_layer_check(tag, cfg) -> None:
    """One full-width layer of a float32 copy on the card (the flash kernel's float32 path)
    against the port's CPU path on a (1, DENSE_LAYER_CHECK, d) input, within EXACT_TOL; with
    tied embeddings the unembed of its output too."""
    cfg32 = dataclasses.replace(
        cfg, num_layers=1, param_dtype="float32", compute_dtype="float32"
    )
    params = init_params(cfg32, _gen(1), DEV)
    lp = _index(params["seg0"]["u0"], 0)
    x = np.random.default_rng(3).normal(size=(1, DENSE_LAYER_CHECK, cfg.d_model))
    x = torch.from_numpy(x.astype(np.float32))
    positions = torch.arange(DENSE_LAYER_CHECK)
    _reset_launches()
    got, got_cache, _ = apply_layer(
        x.to(DEV), lp, cfg32, "dense", positions=positions.to(DEV), mode="prefill"
    )
    if fa.flash_attention_fwd.launches != 1:
        raise AssertionError(f"{tag} float32 layer: {fa.flash_attention_fwd.launches} flash")
    want, want_cache, _ = apply_layer(
        x, _to_cpu(lp), cfg32, "dense", positions=positions, mode="prefill"
    )
    errs = {"h": (got.cpu() - want).abs().max().item()}
    for key, leaf in want_cache.items():
        errs[key] = (got_cache[key].cpu().float() - leaf.float()).abs().max().item()
    if cfg.tie_embeddings:
        cpu = {"embed": _to_cpu(params["embed"]), "final_norm": _to_cpu(params["final_norm"])}
        logits = unembed_logits(params, got, cfg32).cpu()
        errs["tied unembed"] = (logits - unembed_logits(cpu, want, cfg32)).abs().max().item()
    if not torch.isfinite(got).all() or max(errs.values()) > EXACT_TOL:
        raise AssertionError(f"{tag} float32 layer card vs CPU path: {errs}")
    log(
        f"{tag} one float32 layer on x(1, {DENSE_LAYER_CHECK}, {cfg.d_model}): card (kernel, "
        f"{fa.PATHS[torch.float32]} path) vs CPU path (plain) max |err| "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {EXACT_TOL})"
    )


def phase_moe() -> dict:
    """Serve full-width granite-moe-3b-a800m at MOE_SERVE_LAYERS of its 32 MoE layers
    (bfloat16): 8 requests through the 4-slot batcher at MOE_MAX_LEN, both engines; the launch
    and engine gates, teacher-forced logits with routing flips counted, moe_block's bits twice
    in each engine, serving numbers beside their bounds and profiles; then a float32 layer on
    the card against the CPU path. Returns the flash and decode-attention launch counts."""
    tag = "[moe]"
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_SERVE_LAYERS)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated()
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} of its 32 MoE layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads "
        f"on {cfg.num_kv_heads} KV heads of {cfg.head_dim}, {cfg.num_experts} experts top "
        f"{cfg.num_experts_per_tok} of d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size} (tied), "
        f"moe_impl {cfg.moe_impl!r}; {cfg.param_count()} params ({cfg.active_param_count()} "
        f"active) {cfg.param_dtype}, {weight_bytes} bytes on the card; drawn in "
        f"{time.monotonic() - t0:.1f} s"
    )
    prompts = make_prompts(N_REQUESTS, cfg.vocab_size, *MOE_PROMPT_LENS, seed=0)
    lens = [len(p) for p in prompts]
    n_long = sum(n > moe_mod.DROPLESS_TOKENS for n in lens)
    if not 0 < n_long < len(prompts) or max(lens) != GRANITE_FLASH_JSON[3]:
        raise AssertionError(f"{tag} prompt lengths {lens}: both engines must serve")
    log(
        f"{tag} prompt lengths {lens}, {NEW_TOKENS} new tokens each: {n_long} above "
        f"{moe_mod.DROPLESS_TOKENS} tokens (einsum engine), {len(prompts) - n_long} at or below "
        "(dropless sort engine)"
    )
    res, seen, peak = _serve_recorded(model, params, prompts, MOE_MAX_LEN)
    launches = {
        "flash": fa.flash_attention_fwd.launches,
        "decode_attention": da.decode_attention.launches,
    }
    engines = {"sort": moe_mod._moe_sort.calls, "einsum": moe_mod._moe_einsum.calls}
    others = (
        fa.flash_attention_bwd.launches,
        rg.rglru_scan.launches,
        rg.rglru_bwd.launches,
        wk.wkv6_chunked.launches,
        wk.wkv6_bwd.launches,
    )
    L, n_short = cfg.num_layers, len(prompts) - n_long
    want = {"flash": L * len(prompts), "decode_attention": L * res["steps"]}
    want_engines = {"sort": L * (n_short + res["steps"]), "einsum": L * n_long}
    if launches != want or engines != want_engines or any(others):
        raise AssertionError(
            f"{tag} launches {launches}, expected {want}; engine calls {engines}, expected "
            f"{want_engines}; flash backward, rglru, wkv6 launches {others}, expected 0"
        )
    log(
        f"{tag} flash_attention_fwd launches {launches['flash']} = {L} layers x {len(prompts)} "
        f"prefills ({fa.PATHS[torch.bfloat16]} path); decode_attention launches "
        f"{launches['decode_attention']} = {L} layers x {res['steps']} decode steps; no other "
        f"kernel; sort engine calls {engines['sort']} = {L} x ({n_short} prefills + "
        f"{res['steps']} decode steps), einsum engine calls {engines['einsum']} = {L} x {n_long} "
        "prefills"
    )
    _check_teacher_forced(
        tag, model, params, prompts, res, seen, LOGIT_TOL_MOE, MOE_MAX_LEN, routes=True
    )
    _moe_block_bits(tag, cfg, params, (min(lens), max(lens)))
    _log_serving(tag, res, peak)
    _log_moe_bounds(tag, cfg, weight_bytes, lens, res)
    _prefill_profile(model, params, tag, prompts[int(np.argmax(lens))], MOE_MAX_LEN)
    _decode_profile(model, params, tag, MOE_MAX_LEN)
    _moe_decode_split(model, params, tag, MOE_MAX_LEN)
    del model, params, res, seen
    _release()
    _moe_layer_check(tag, cfg)
    _release()
    return launches


def _moe_block_bits(tag, cfg, params, lengths) -> None:
    """``moe_block`` of layer 0 twice on one input of each engine's side: equal bits."""
    lp = _index(params["seg0"]["u0"], 0)["moe"]
    gen = _gen(5)
    for n in lengths:
        x = torch.randn(1, n, cfg.d_model, generator=gen, device=DEV).to(torch.bfloat16)
        moe_mod._moe_sort.calls = moe_mod._moe_einsum.calls = 0
        (first, aux1), (again, aux2) = (moe_mod.moe_block(x, lp, cfg) for _ in range(2))
        engine = "sort" if moe_mod._moe_sort.calls else "einsum"
        differ = (first != again).sum().item()
        if differ or not torch.equal(aux1, aux2) or not torch.isfinite(first).all():
            raise AssertionError(f"{tag} moe_block twice on {n} tokens: {differ} elements differ")
        log(f"{tag} moe_block twice on x(1, {n}, {cfg.d_model}) bf16 ({engine} engine): equal bits")


def _moe_slots(cfg, n: int) -> int:
    """Slot rows of each expert in one MoE layer's prefill of ``n`` tokens, empty ones
    included: n under the dropless path, else the einsum engine's groups x capacity."""
    if n <= moe_mod.DROPLESS_TOKENS:
        return n
    groups = max(1, n // cfg.moe_group_size)
    cap = int((n // groups) * cfg.num_experts_per_tok / cfg.num_experts * cfg.moe_capacity_factor)
    return groups * max(1, cap)


def _moe_prefill_flops(cfg, n: int) -> float:
    """FLOPs of one prefill of ``n`` tokens as the reference defines its work: the experts'
    products over every slot row the engine dispatches (empty slots included), the attention
    projections, the router, causal attention, the last row's unembed."""
    E, d, ff, slots = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, _moe_slots(cfg, n)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * n * d * (2 * hq * hd + 2 * hkv * hd)
    attn = 4 * hq * hd * n * (n + 1) / 2
    layer = 2 * E * slots * 3 * d * ff + proj + attn + 2 * n * d * E
    return cfg.num_layers * layer + 2 * d * cfg.vocab_size


def _log_moe_bounds(tag, cfg, weight_bytes, lens, res) -> None:
    """The least time the card could take for the serving phase's work, beside the measured:
    a decode step reads every weight (every expert gets slots), a prefill's FLOPs at the
    bf16 peak or its weights' bytes, whichever is longer."""
    decode_ms = 1e3 * weight_bytes / PEAK_HBM_BYTES
    prefill = [
        1e3 * max(_moe_prefill_flops(cfg, n) / PEAK_BF16_FLOPS, weight_bytes / PEAK_HBM_BYTES)
        for n in lens
    ]
    experts = cfg.num_layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff * 2  # bf16
    log(
        f"{tag} bounds: a decode step reads {weight_bytes} bytes of weights ({experts} of them "
        f"the experts'): {decode_ms:.3f} ms at 3.35 TB/s against {res['decode_ms_per_step']:.3f} "
        f"ms/step measured ({res['decode_ms_per_step'] / decode_ms:.1f}x); the prefills "
        f"{', '.join(f'{n}: {b:.3f}' for n, b in zip(lens, prefill))} ms (the larger of FLOPs at "
        f"989 TFLOP/s and the weights' bytes), mean {np.mean(prefill):.3f} against "
        f"{res['prefill_ms_mean']:.3f} ms measured "
        f"({res['prefill_ms_mean'] / np.mean(prefill):.1f}x)"
    )


MOE_RANGES = ("attention", "moe", "moe.router", "moe.experts")
MLA_RANGES = MOE_RANGES + ("attention.absorbed", "mlp")


@contextlib.contextmanager
def _moe_ranges(mla=False):
    """The MoE block, its router, its experts' products and the attention block wrapped in
    ``torch.profiler.record_function`` ranges of MOE_RANGES' names (this file's patches: the
    port's code carries none); with ``mla``, the attention block is MLA's and the absorbed
    decode inside it and the dense layers' MLPs get ranges of their own (MLA_RANGES)."""
    saved = [
        (transformer_mod, "mla_attention" if mla else "gqa_attention", "attention"),
        (transformer_mod, "moe_block", "moe"),
        (moe_mod, "_router", "moe.router"),
        (moe_mod, "_expert_ffn", "moe.experts"),
    ]
    if mla:
        saved += [
            (attention_mod, "_mla_absorbed", "attention.absorbed"),
            (transformer_mod, "glu_mlp", "mlp"),
        ]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]

    def ranged(fn, label):
        def call(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return call

    for (mod, name, label), (_, _, fn) in zip(saved, originals):
        setattr(mod, name, ranged(fn, label))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def _moe_decode_split(model, params, tag: str, max_len: int, steps: int = 5, mla=False) -> None:
    """A profiled window of 4-slot decode steps split by block: the device time of the
    kernels launched inside the attention block, the MoE's router, its experts' products and
    the rest of the MoE (the dispatch: slot tables, sorts, gathers; the combine), per step."""
    cache = model.init_cache(SLOTS, max_len)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=DEV)

    def step():
        model.decode_step(params, cache, {"token": tok})

    step()
    _moe_split(tag, "decode step (4 slots)", step, steps, mla)


def _moe_prefill_split(model, params, tag: str, prompt, max_len: int) -> None:
    """One prefill of ``prompt`` as the batcher runs it, split by block as a decode step is."""
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]

    def prefill():
        model.prefill(params, {"tokens": ids}, pad_to=max_len)

    prefill()
    _moe_split(tag, f"prefill of {len(prompt)} tokens", prefill, 1, mla=True)


def _moe_split(tag: str, label: str, run, steps: int, mla: bool) -> None:
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _moe_ranges(mla), torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps
    ranges = {name: 0.0 for name in (MLA_RANGES if mla else MOE_RANGES)}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in ranges:
            ranges[e.name] += e.device_time_total / 1e3 / steps
    kernels = [r for r in _device_rows(prof) if r[2] not in ranges]  # not the ranges' own
    device_ms = sum(r[0] for r in kernels) / 1e3 / steps
    if not device_ms or not ranges["moe"]:
        log(f"{tag} {label} split: no device time under the ranges (not measured)")
        return
    dispatch = ranges["moe"] - ranges["moe.router"] - ranges["moe.experts"]
    if mla:
        parts = {
            "MLA block without the absorbed decode": ranges["attention"]
            - ranges["attention.absorbed"],
            "absorbed decode": ranges["attention.absorbed"],
            "dense layers' MLPs": ranges["mlp"],
        }
    else:
        parts = {"attention block": ranges["attention"]}
    parts.update(
        {
            "MoE router": ranges["moe.router"],
            "MoE dispatch and combine": dispatch,
            "MoE experts' products": ranges["moe.experts"],
        }
    )
    parts["the rest (norms, embed, unembed)"] = device_ms - sum(parts.values())
    per = "a step" if steps > 1 else "in all"
    log(
        f"{tag} {label} under the profiler with ranges: {wall_ms:.3f} ms wall, "
        f"device busy {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%); device ms {per}: "
        + "; ".join(f"{k} {v:.3f} ({100 * v / device_ms:.1f}%)" for k, v in parts.items())
    )


@contextlib.contextmanager
def _router_calls(out: list):
    """Record each MoE router call's input rows and expert ids into ``out``."""
    router = moe_mod._router

    def recording(x_flat, p, *args):
        weights, idx, aux = router(x_flat, p, *args)
        out.append((x_flat, p["router"], idx))
        return weights, idx, aux

    moe_mod._router = recording
    try:
        yield out
    finally:
        moe_mod._router = router


def _moe_layer_check(tag, cfg) -> None:
    """One full-width layer of a float32 copy on the card against the port's CPU path on a
    (1, MOE_LAYER_CHECK, d) input: the routing first (a token whose top-k differ must sit on
    a tie within the two sides' float32 rounding of its probabilities; counted and printed),
    then the output of every other token within MOE_TOL of its scale and the cache within
    EXACT_TOL. Then each engine on the CPU path's routing of MOE_ENGINE_CHECK rows."""
    cfg32 = dataclasses.replace(cfg, num_layers=1, param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg32, _gen(1), DEV)
    lp = _index(params["seg0"]["u0"], 0)
    cpu = _to_cpu(lp)
    x = np.random.default_rng(3).normal(size=(1, MOE_LAYER_CHECK, cfg.d_model))
    x = torch.from_numpy(x.astype(np.float32))
    positions = torch.arange(MOE_LAYER_CHECK)
    card_calls, cpu_calls = [], []
    _reset_launches()
    with _router_calls(card_calls):
        got, got_cache, _ = apply_layer(
            x.to(DEV), lp, cfg32, "moe", positions=positions.to(DEV), mode="prefill"
        )
    if fa.flash_attention_fwd.launches != 1 or moe_mod._moe_sort.calls != 1:
        raise AssertionError(f"{tag} float32 layer: {fa.flash_attention_fwd.launches} flash")
    with _router_calls(cpu_calls):
        want, want_cache, _ = apply_layer(x, cpu, cfg32, "moe", positions=positions, mode="prefill")
    k = cfg.num_experts_per_tok
    flipped, margin = _flipped_tokens(f"{tag} float32 layer", card_calls[0], cpu_calls[0], k)
    keep = ~flipped
    scale = want[0, keep].abs().max().item()
    err_h = (got.cpu()[0, keep] - want[0, keep]).abs().max().item()
    errs = {key: (got_cache[key].cpu().float() - leaf.float()).abs().max().item()
            for key, leaf in want_cache.items()}
    if not torch.isfinite(got).all() or err_h > MOE_TOL * scale or max(errs.values()) > EXACT_TOL:
        raise AssertionError(
            f"{tag} float32 layer card vs CPU path: h {err_h} (scale {scale}), {errs}"
        )
    log(
        f"{tag} one float32 MoE layer on x(1, {MOE_LAYER_CHECK}, {cfg.d_model}) (sort engine, "
        f"dropless): routing of {int(flipped.sum())} of {MOE_LAYER_CHECK} tokens differs "
        f"(each a tie within rounding); the smallest top-{k} boundary gap "
        f"{margin.min().item():.3e}; card vs CPU path max |err| h {err_h:.3e} of max |h| "
        f"{scale:.2f} ({err_h / scale:.2e}, tol {MOE_TOL}), "
        f"{', '.join(f'{k_} {v:.3e}' for k_, v in errs.items())} (tol {EXACT_TOL})"
    )
    _moe_engine_check(tag, cfg32, lp["moe"], cpu["moe"])


def _flipped_tokens(label, card_call, cpu_call, k: int):
    """The tokens of one router call that the card routed otherwise than the CPU path, each of
    which must sit on a tie: the CPU's top-k boundary gap within twice the largest difference
    of the two sides' probabilities (what two roundings can move it). Returns (flipped mask,
    the CPU's boundary gap of every token)."""
    (xc, rc, ic), (xw, rw, iw) = card_call, cpu_call
    p_card = torch.softmax(dense(xc, rc).float(), dim=-1).cpu()
    p_cpu = torch.softmax(dense(xw, rw).float(), dim=-1)
    flipped = (torch.sort(ic.cpu(), -1).values != torch.sort(iw, -1).values).any(-1)
    top = torch.sort(p_cpu, dim=-1, descending=True).values
    margin = top[:, k - 1] - top[:, k]  # the CPU's gap at the top-k boundary
    noise = 2 * (p_card - p_cpu).abs().amax(-1)  # what the two roundings can move it
    for t in flipped.nonzero().flatten().tolist():
        log(
            f"{label}: token {t} routed differently on the card; its top-{k} boundary gap "
            f"{margin[t].item():.3e} against the sides' probability difference x 2 "
            f"{noise[t].item():.3e}"
        )
        if margin[t] > noise[t]:
            raise AssertionError(f"{label}: token {t} flipped without a tie")
    return flipped, margin


def _moe_engine_check(tag, cfg32, p_card, p_cpu) -> None:
    """Both engines (the sort engine with its capacity, no override) on MOE_ENGINE_CHECK rows
    and the CPU path's routing of them: the card's float32 within MOE_TOL of the output's scale
    of the CPU path's, and no further from the same engine run in float64 on the card (the
    yardstick) than twice the CPU path is."""
    x = np.random.default_rng(4).normal(size=(MOE_ENGINE_CHECK, cfg32.d_model))
    x = torch.from_numpy(x.astype(np.float32))
    weights, idx, _ = moe_mod._router(x, p_cpu, cfg32)
    on_card = (x.to(DEV), weights.to(DEV), idx.to(DEV))
    p64 = tree_map(lambda t: t.double(), p_card)
    for name, engine in (("einsum", moe_mod._moe_einsum), ("sort", moe_mod._moe_sort)):
        got = engine(*on_card, p_card, cfg32).cpu()
        want = engine(x, weights, idx, p_cpu, cfg32)
        as64 = (t.double() if t.is_floating_point() else t for t in on_card)
        f64 = engine(*as64, p64, cfg32).cpu()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        err64 = {
            side: (v.double() - f64).abs().max().item()
            for side, v in (("card", got), ("cpu", want))
        }
        zero = int((want.abs().sum(-1) == 0).sum())
        bad = err > MOE_TOL * scale or err64["card"] > 2 * err64["cpu"]
        if not torch.isfinite(got).all() or bad:
            raise AssertionError(
                f"{tag} {name} engine card vs CPU path: max |err| {err:.3e} (scale {scale:.2f}), "
                f"against float64 {err64}"
            )
        log(
            f"{tag} {name} engine, float32, x({MOE_ENGINE_CHECK}, {cfg32.d_model}) on the CPU "
            f"path's routing: card vs CPU path max |err| {err:.3e} of max |out| {scale:.2f} "
            f"({err / scale:.2e}, tol {MOE_TOL}); against float64 on the card: card "
            f"{err64['card']:.3e}, CPU path {err64['cpu']:.3e}; {zero} rows with no expert "
            "output (dropped, or the einsum engine's tail)"
        )


def phase_deepseek() -> dict:
    """Serve deepseek-v3-671b at full width, DEEPSEEK_LAYERS of its 61 layers (3 dense, 1 MoE
    of 256 experts; MLA; bfloat16): 8 requests through the 4-slot batcher at MOE_MAX_LEN, both
    MoE engines; the launch and engine gates (the flash forward at key head dim 192 and value
    head dim 128 in every prefill layer, no decode-attention kernel: decode is the absorbed
    form), teacher-forced logits with routing flips held to their terms, the unembed, serving
    numbers beside their bounds, profiles split by block; then a float32 MLA layer (prefill,
    absorbed decode against the CPU path and against a fresh prefill) and a float32 MoE layer
    on the card against the CPU path. Returns the flash and decode-attention launch counts."""
    tag = "[deepseek]"
    cfg = dataclasses.replace(get_config(DEEPSEEK_ARCH), num_layers=DEEPSEEK_LAYERS)
    pattern = layer_pattern(cfg)
    if pattern != ("dense",) * cfg.first_k_dense + ("moe",):
        raise AssertionError(f"{tag} layer pattern {pattern}: expected 3 dense layers, 1 MoE")
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated()
    served = {k: v for k, v in params.items() if k not in ("mtp", "embed")}
    read_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(served))
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} of its 61 layers {pattern}, d={cfg.d_model}, MLA "
        f"with {cfg.num_heads} heads (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, qk "
        f"{cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v {cfg.v_head_dim}), d_ff "
        f"{cfg.d_ff}, {cfg.num_experts} experts top {cfg.num_experts_per_tok} of "
        f"{cfg.moe_d_ff} and {cfg.num_shared_experts} shared, vocab {cfg.vocab_size} (untied), "
        f"moe_impl {cfg.moe_impl!r}; {cfg.param_count()} params ({cfg.active_param_count()} "
        f"active; the MTP subtree drawn, not run) {cfg.param_dtype}, {weight_bytes} bytes on "
        f"the card; drawn in {time.monotonic() - t0:.1f} s"
    )
    prompts = make_prompts(N_REQUESTS, cfg.vocab_size, *MOE_PROMPT_LENS, seed=0)
    lens = [len(p) for p in prompts]
    n_long = sum(n > moe_mod.DROPLESS_TOKENS for n in lens)
    if not 0 < n_long < len(prompts) or max(lens) != MLA_FLASH_JSON[3]:
        raise AssertionError(f"{tag} prompt lengths {lens}: both engines must serve")
    log(
        f"{tag} prompt lengths {lens}, {NEW_TOKENS} new tokens each: {n_long} above "
        f"{moe_mod.DROPLESS_TOKENS} tokens (einsum engine), {len(prompts) - n_long} at or below "
        "(dropless sort engine)"
    )
    res, seen, peak = _serve_recorded(model, params, prompts, MOE_MAX_LEN)
    launches = {
        "flash": fa.flash_attention_fwd.launches,
        "decode_attention": da.decode_attention.launches,
    }
    engines = {"sort": moe_mod._moe_sort.calls, "einsum": moe_mod._moe_einsum.calls}
    others = (
        fa.flash_attention_bwd.launches,
        rg.rglru_scan.launches,
        rg.rglru_bwd.launches,
        wk.wkv6_chunked.launches,
        wk.wkv6_bwd.launches,
    )
    L, n_moe, n_short = cfg.num_layers, pattern.count("moe"), len(prompts) - n_long
    want = {"flash": L * len(prompts), "decode_attention": 0}
    want_engines = {"sort": n_moe * (n_short + res["steps"]), "einsum": n_moe * n_long}
    if launches != want or engines != want_engines or any(others):
        raise AssertionError(
            f"{tag} launches {launches}, expected {want}; engine calls {engines}, expected "
            f"{want_engines}; flash backward, rglru, wkv6 launches {others}, expected 0"
        )
    log(
        f"{tag} flash_attention_fwd launches {launches['flash']} = {L} layers x {len(prompts)} "
        f"prefills ({fa.PATHS[torch.bfloat16]} path, D 192, Dv 128); decode_attention launches 0 "
        f"(the absorbed decode, plain torch in float32); no other kernel; sort engine calls "
        f"{engines['sort']} = {n_moe} x ({n_short} prefills + {res['steps']} decode steps), "
        f"einsum engine calls {engines['einsum']} = {n_moe} x {n_long} prefills"
    )
    _check_teacher_forced(
        tag, model, params, prompts, res, seen, LOGIT_TOL_DEEPSEEK, MOE_MAX_LEN, routes=True,
        flip_steps=True,
    )
    _check_unembed(tag, model, params, min(prompts, key=len))
    _log_serving(tag, res, peak)
    longest = prompts[int(np.argmax(lens))]
    prefill = [
        1e3 * max(_deepseek_prefill_flops(cfg, n) / PEAK_BF16_FLOPS, read_bytes / PEAK_HBM_BYTES)
        for n in lens
    ]
    decode_ms = 1e3 * read_bytes / PEAK_HBM_BYTES
    log(
        f"{tag} bounds: a decode step reads {read_bytes} bytes of weights (every layer, all "
        f"{cfg.num_experts} experts under the dropless path, the unembed; not the embedding "
        f"table or the MTP subtree): {decode_ms:.3f} ms at 3.35 TB/s against "
        f"{res['decode_ms_per_step']:.3f} ms/step measured "
        f"({res['decode_ms_per_step'] / decode_ms:.1f}x); the prefills "
        f"{', '.join(f'{n}: {b:.3f}' for n, b in zip(lens, prefill))} ms (the larger of FLOPs "
        f"at 989 TFLOP/s and the weights' bytes), mean {np.mean(prefill):.3f} against "
        f"{res['prefill_ms_mean']:.3f} ms measured "
        f"({res['prefill_ms_mean'] / np.mean(prefill):.1f}x)"
    )
    _prefill_profile(model, params, tag, longest, MOE_MAX_LEN)
    _moe_prefill_split(model, params, tag, longest, MOE_MAX_LEN)
    _decode_profile(model, params, tag, MOE_MAX_LEN)
    _moe_decode_split(model, params, tag, MOE_MAX_LEN, mla=True)
    del model, params, served, res, seen
    _release()
    _mla_layer_check(tag, cfg)
    _release()
    _deepseek_moe_layer_check(tag, cfg)
    _release()
    return launches


def _deepseek_prefill_flops(cfg, n: int) -> float:
    """FLOPs of one prefill of ``n`` tokens as the reference defines its work: MLA's
    projections (the latent expanded to per-head K and V), causal attention over 192 + 128
    columns, the dense MLPs, the MoE layer's experts over every slot row the engine dispatches,
    its shared expert and router, the last row's unembed."""
    d, h = cfg.d_model, cfg.num_heads
    qn, qr, vh, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    proj = d * cfg.q_lora_rank + cfg.q_lora_rank * h * (qn + qr) + d * (r + qr)
    proj += r * h * (qn + vh) + h * vh * d
    mla = 2 * n * proj + 2 * h * (n * (n + 1) / 2) * (qn + qr + vh)
    E, ff, slots = cfg.num_experts, cfg.moe_d_ff, _moe_slots(cfg, n)
    moe = 2 * E * slots * 3 * d * ff + 2 * n * 3 * d * ff * cfg.num_shared_experts + 2 * n * d * E
    dense_mlp = 2 * n * 3 * d * cfg.d_ff
    n_moe = layer_pattern(cfg).count("moe")
    layers = cfg.num_layers * mla + (cfg.num_layers - n_moe) * dense_mlp + n_moe * moe
    return layers + 2 * d * cfg.vocab_size


def _grow_cache(cache, size: int):
    """One layer's prefill cache with its ckv and krope grown to ``size`` slots (zeros after)."""
    out = dict(cache)
    for key in ("ckv", "krope"):
        x = cache[key]
        out[key] = torch.nn.functional.pad(x, (0, 0, 0, size - x.shape[1]))
    return out


def _float32_layer(cfg32, kind: str, seed: int):
    """One layer of ``kind`` drawn on the card in bfloat16 and taken to float32 leaf by leaf: a
    float32 draw of the MoE layer's 11.3B expert params would need its float32 temporaries
    beside them (past 80 GB); the values are bfloat16's, the arithmetic float32."""
    store = ParamStore(_gen(seed), torch.bfloat16, torch.device(DEV))
    init_layer(store, cfg32, kind)

    def up(tree):
        return {k: up(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    return up(store.params)


def _to_host_staged(tree, chunk: int = 1 << 28):
    """A float32 tree's tensors copied to pageable host memory through one page-locked staging
    buffer of ``chunk`` elements (1 GiB): a pageable copy from the card runs at ~1.6 GB/s
    (27.9 s for the float32 MoE layer's 46 GB), and page-locking the whole tree would keep
    46 GB of host memory in torch's pinned cache for the rest of the run."""
    staging = torch.empty(chunk, dtype=torch.float32, pin_memory=True)

    def copy(x):
        if x.dtype != torch.float32:
            raise TypeError(f"_to_host_staged: {x.dtype}, expected float32")
        out = torch.empty(x.shape, dtype=x.dtype)
        src, dst = x.reshape(-1), out.view(-1)
        for i in range(0, src.numel(), chunk):
            n = min(chunk, src.numel() - i)
            staging[:n].copy_(src[i : i + n])
            dst[i : i + n].copy_(staging[:n])
        return out

    return tree_map(copy, tree)


def _mla_layer_check(tag, cfg) -> None:
    """A full-width float32 MLA layer (dense kind) on the card against the port's CPU path: a
    DEEPSEEK_LAYER_CHECK-token prefill (the flash kernel at D 192, Dv 128 in float32) and its
    cache (ckv, krope), then 4 absorbed decode steps; and the card's decode steps against a
    fresh prefill of all the tokens on the card (the absorbed form against the expanded one),
    each within EXACT_TOL."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    lp = _float32_layer(cfg32, "dense", 1)
    cpu = _to_cpu(lp)
    s, steps = DEEPSEEK_LAYER_CHECK, 4
    x = np.random.default_rng(3).normal(size=(1, s + steps, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x)
    pos = torch.arange(s)
    _reset_launches()
    got, got_cache, _ = apply_layer(
        x[:, :s].to(DEV), lp, cfg32, "dense", positions=pos.to(DEV), mode="prefill"
    )
    if fa.flash_attention_fwd.launches != 1:
        raise AssertionError(f"{tag} float32 MLA layer: {fa.flash_attention_fwd.launches} flash")
    want, want_cache, _ = apply_layer(x[:, :s], cpu, cfg32, "dense", positions=pos, mode="prefill")
    errs = {"h": (got.cpu() - want).abs().max().item()}
    for key, leaf in want_cache.items():
        errs[key] = (got_cache[key].cpu().float() - leaf.float()).abs().max().item()
    got_cache, want_cache = _grow_cache(got_cache, s + steps), _grow_cache(want_cache, s + steps)
    decoded = []
    for j in range(steps):
        xt, at = x[:, s + j : s + j + 1], torch.tensor([[s + j]])
        g, got_cache, _ = apply_layer(
            xt.to(DEV), lp, cfg32, "dense", positions=at.to(DEV), mode="decode", cache=got_cache
        )
        w, want_cache, _ = apply_layer(
            xt, cpu, cfg32, "dense", positions=at, mode="decode", cache=want_cache
        )
        errs[f"decode {j}"] = (g.cpu() - w).abs().max().item()
        decoded.append(g)
    fresh, _, _ = apply_layer(
        x.to(DEV), lp, cfg32, "dense", positions=torch.arange(s + steps, device=DEV),
        mode="prefill",
    )
    absorbed = (torch.cat(decoded, dim=1) - fresh[:, s:]).abs().max().item()
    if not torch.isfinite(got).all() or max(errs.values()) > EXACT_TOL or absorbed > EXACT_TOL:
        raise AssertionError(f"{tag} float32 MLA layer: {errs}, absorbed vs fresh {absorbed}")
    log(
        f"{tag} one float32 MLA layer (dense kind) on x(1, {s}, {cfg.d_model}), then {steps} "
        f"absorbed decode steps: card (flash kernel, D 192, Dv 128, {fa.PATHS[torch.float32]}) "
        f"vs CPU path (plain) max |err| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
        f"(tol {EXACT_TOL}); the card's decode steps vs a fresh prefill of {s + steps} tokens "
        f"(absorbed vs expanded) max |err| {absorbed:.3e} (tol {EXACT_TOL})"
    )


def _deepseek_moe_layer_check(tag, cfg) -> None:
    """A full-width float32 MoE layer (MLA, 256 experts, the shared expert; 46 GB) on the card
    against the port's CPU path: a DEEPSEEK_MOE_CHECK-token prefill (dropless sort engine) and
    2 decode steps. Routing is compared first: a token routed differently must sit on a float32
    tie (``_moe_layer_check``'s rule); the other tokens' outputs are held within MOE_TOL of the
    output's scale, the cache within EXACT_TOL."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    lp = _float32_layer(cfg32, "moe", 2)
    n_params = sum(x.numel() for x in tree_leaves(lp))
    t0 = time.monotonic()
    cpu = _to_host_staged(lp)
    copy_s = time.monotonic() - t0
    s, steps, k = DEEPSEEK_MOE_CHECK, 2, cfg.num_experts_per_tok
    x = np.random.default_rng(4).normal(size=(1, s + steps, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x)
    card_calls, cpu_calls = [], []

    def run(params, dev, calls):
        """The prefill and the decode steps on one side: (label, output) each."""
        with _router_calls(calls):
            out, cache, _ = apply_layer(
                x[:, :s].to(dev), params, cfg32, "moe", positions=torch.arange(s, device=dev),
                mode="prefill",
            )
            outs, cache = [("prefill", out)], _grow_cache(cache, s + steps)
            first = {key: v.clone() for key, v in cache.items()}
            for j in range(steps):
                xt, at = x[:, s + j : s + j + 1].to(dev), torch.tensor([[s + j]], device=dev)
                out, cache, _ = apply_layer(
                    xt, params, cfg32, "moe", positions=at, mode="decode", cache=cache
                )
                outs.append((f"decode {j}", out))
        return outs, first

    _reset_launches()
    t0 = time.monotonic()
    got, got_cache = run(lp, DEV, card_calls)
    counts = (fa.flash_attention_fwd.launches, moe_mod._moe_sort.calls)
    if counts != (1, 1 + steps):
        raise AssertionError(f"{tag} float32 MoE layer: flash launches, sort engine calls {counts}")
    want, want_cache = run(cpu, "cpu", cpu_calls)
    run_s = time.monotonic() - t0
    errs = {key: (got_cache[key].cpu().float() - leaf.float()).abs().max().item()
            for key, leaf in want_cache.items()}
    parts = [(label, g, w) for (label, g), (_, w) in zip(got, want)]
    worst, n_flipped, min_gap = 0.0, 0, float("inf")
    for (label, g, w), card_call, cpu_call in zip(parts, card_calls, cpu_calls):
        flipped, margin = _flipped_tokens(
            f"{tag} float32 MoE layer {label}", card_call, cpu_call, k
        )
        keep = ~flipped
        n_flipped, min_gap = n_flipped + int(flipped.sum()), min(min_gap, margin.min().item())
        if keep.any():
            scale = w[0, keep].abs().max().item()
            err = (g.cpu()[0, keep] - w[0, keep]).abs().max().item()
            if not torch.isfinite(g).all() or err > MOE_TOL * scale:
                raise AssertionError(f"{tag} float32 MoE layer {label}: {err} (scale {scale})")
            errs[label] = err / scale
            worst = max(worst, err / scale)
    if max(v for key, v in errs.items() if key in want_cache) > EXACT_TOL:
        raise AssertionError(f"{tag} float32 MoE layer cache: {errs}")
    log(
        f"{tag} one float32 MoE layer ({n_params} params on the card, {copy_s:.1f} s to copy to "
        f"the host) on x(1, {s}, {cfg.d_model}) (dropless sort engine), then {steps} decode "
        f"steps, card and CPU path in {run_s:.1f} s: routing of {n_flipped} of {s + steps} tokens "
        f"differs (each a tie within rounding); the smallest top-{k} boundary gap {min_gap:.3e}; "
        f"card vs CPU path max |err| over max |out| "
        f"{', '.join(f'{k_} {v:.3e}' for k_, v in errs.items() if k_ not in want_cache)} (tol "
        f"{MOE_TOL}), cache {', '.join(f'{k_} {errs[k_]:.3e}' for k_ in want_cache)} (tol "
        f"{EXACT_TOL})"
    )


@contextlib.contextmanager
def _encdec_ranges(counts: dict, spans=None):
    """Profiler ranges around an encoder-decoder's encoder stack ("encoder": ``run_stack`` in
    train mode inside prefill) and each ``xattn`` layer's cross-attention block ("cross"),
    this file's patches (the port's code carries none), each counting into ``counts`` the flash
    launches made inside it: "encoder", "cross prefill", "cross decode". With ``spans``, CUDA
    events recorded in the stream before and after each call go into ``spans[label]``."""
    run_stack, cross = model_mod.run_stack, transformer_mod._cross_attention

    def launched(label, fn, *args, **kwargs):
        n0 = fa.flash_attention_fwd.launches
        events = () if spans is None else [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        with torch.profiler.record_function(label.split()[0]):
            for e in events[:1]:
                e.record()
            out = fn(*args, **kwargs)
            for e in events[1:]:
                e.record()
        counts[label] = counts.get(label, 0) + fa.flash_attention_fwd.launches - n0
        if events:
            spans.setdefault(label, []).append(events)
        return out

    def ranged_stack(*args, **kwargs):
        if kwargs.get("mode") != "train":
            return run_stack(*args, **kwargs)
        return launched("encoder", run_stack, *args, **kwargs)

    def ranged_cross(h, lp, cfg, mode, *rest):
        return launched(f"cross {mode}", cross, h, lp, cfg, mode, *rest)

    model_mod.run_stack, transformer_mod._cross_attention = ranged_stack, ranged_cross
    try:
        yield
    finally:
        model_mod.run_stack, transformer_mod._cross_attention = run_stack, cross


def _profile(tag: str, label: str, run, steps: int = 1, ranges=(), host: bool = False) -> dict:
    """``run`` ``steps`` times under torch.profiler: wall ms a step, device busy ms a step and
    its share, the device ms by kind of kernel, the longest kernels, the port's kernels' device
    us a launch, and the device ms under each profiler range in ``ranges`` (whose patches the
    caller holds); with ``host``, first ``steps`` runs without the profiler: host wall ms a step
    and the peak memory above what was held before them. Logged, and returned by name."""
    note = ""
    torch.cuda.synchronize()
    if host:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        note = (
            f"{1e3 * (time.monotonic() - t0) / steps:.3f} ms host wall, peak memory {peak} bytes "
            f"({peak - held} above the {held} held before it); "
        )
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps
    spans = {name: 0.0 for name in ranges}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in spans:
            spans[e.name] += e.device_time_total / 1e3 / steps
    rows = [r for r in _device_rows(prof) if r[2] not in spans]
    if not rows:
        log(f"{tag} {label}: {note}profiler: no device time recorded (not measured)")
        return {}
    kinds, launches = _device_kinds(rows)
    device_ms = sum(kinds.values()) / steps
    by_kind = "; ".join(
        f"{k} {ms / steps:.3f} ms ({100 * ms / steps / device_ms:.1f}%, {launches[k] // steps} "
        "launches)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])
    )
    top = "; ".join(f"{k[:60]} {us / steps / 1e3:.3f} ms x{n // steps}" for us, n, k in rows[:6])
    ours = "; ".join(
        f"{name} {us / n:.2f} us a launch x{n // steps}"
        for us, n, k in rows
        for name in PORT_KERNEL_SYMBOLS
        if name in k
    )
    named = "".join(
        f"; under the range {name!r} {ms:.3f} ms ({100 * ms / device_ms:.1f}% of the device's)"
        for name, ms in spans.items()
    )
    per = "a step" if steps > 1 else "in all"
    log(
        f"{tag} {label}: {note}under the profiler {wall_ms:.3f} ms wall {per}, device busy "
        f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{sum(launches.values()) // steps} kernels; device ms by kind: {by_kind}; top kernels: "
        f"{top}; the port's kernels: {ours or 'none'}{named}"
    )
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kinds": kinds, **spans}


def _pad_to(batch, new_tokens: int) -> int:
    """The decode cache's length for ``batch``: a VLM's patch tokens, the prompt, the new ones."""
    patches = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    return patches + batch["tokens"].shape[1] + new_tokens


def _greedy(model, params, batch, new_tokens: int, keep=TEACHER_STEPS):
    """The reference's loop: prefill padded to ``_pad_to``, then greedy decode steps. Returns
    the tokens fed (B, new_tokens) on the host, the logits of the decode steps in ``keep``
    (float32, on the host), prefill ms and decode ms a step (host wall, synced)."""
    pad_to = _pad_to(batch, new_tokens)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = model.prefill(params, batch, pad_to=pad_to)
    tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    toks, kept = [], {}
    for j in range(new_tokens):
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, {"token": tok})
        if j in keep:
            kept[j] = logits.float().clone()
        tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    tokens = torch.stack(toks, dim=1).cpu()
    kept = {j: x.cpu() for j, x in kept.items()}
    return tokens, kept, 1e3 * (t1 - t0), 1e3 * (t2 - t1) / new_tokens


def _teacher_forced_steps(tag, models, batch, tokens, kept) -> tuple:
    """Each kept decode step's logits against the last position of a fresh prefill over the
    inputs and the prompt plus the tokens fed up to that step (the reference's
    test_prefill_decode_consistency), within min(TEACHER_GAPS times that prefill's distance to
    the same prefill by the float32 copy, LOGIT_TOL_BF16); the greedy tokens that differ from
    the fresh prefills' argmax. ``models`` is ((model, params), (float32 model, float32
    params)). Returns (max |err|, the largest err / gap, the gaps' range, the largest share of
    the limit used, tokens that differ)."""
    (model, params), (model32, params32) = models
    worst, ratio, gaps, used, differ = 0.0, 0.0, [], 0.0, 0
    dev_tokens = tokens.to(DEV)
    for j, got in kept.items():
        seq = torch.cat([batch["tokens"], dev_tokens[:, : j + 1]], dim=1)
        fresh, _ = model.prefill(params, {**batch, "tokens": seq})
        fresh = fresh.float().cpu()
        exact = model32.prefill(params32, {**batch, "tokens": seq})[0].cpu()
        err, gap = (got - fresh).abs().max().item(), (fresh - exact).abs().max().item()
        limit = min(TEACHER_GAPS * gap, LOGIT_TOL_BF16)
        if not torch.isfinite(got).all() or err > limit:
            raise AssertionError(
                f"{tag} decode step {j} vs a fresh prefill: max |err| {err:.4f}, the prefill's "
                f"own gap to float32 {gap:.4f}, limit {limit:.4f}"
            )
        worst, ratio, used = max(worst, err), max(ratio, err / gap), max(used, err / limit)
        gaps.append(gap)
        if j + 1 < tokens.shape[1]:
            differ += int((fresh.argmax(dim=-1) != tokens[:, j + 1]).sum())
    return worst, ratio, (min(gaps), max(gaps)), used, differ


def _float32_copy(cfg, params):
    """``cfg`` and ``params`` in float32 (the bfloat16 weights' values), built on the card."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    return build(cfg32, DEV), tree_map(lambda x: x.float(), params)


def _weights_bytes(tree, skip=()) -> int:
    """Bytes of the leaves of ``tree`` but those whose path ends in one of ``skip``'s
    (parent, name) pairs."""

    def walk(t, path):
        if isinstance(t, dict):
            return sum(walk(v, path + (k,)) for k, v in t.items())
        return 0 if path[-2:] in skip else t.numel() * t.element_size()

    return walk(tree, ())


def _dense_flops(cfg, n: int) -> float:
    """FLOPs of one self-attention layer's projections and MLP over ``n`` rows."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return 2.0 * n * (2 * d * h * hd + 2 * d * kv * hd + (3 if cfg.glu else 2) * d * cfg.d_ff)


def _encdec_prefill_flops(cfg, b: int, s_src: int, s_tgt: int) -> float:
    """FLOPs of one seamless prefill as the reference defines its work: the frontend
    projection, the encoder's layers (projections, MLP, attention without a mask), each decoder
    layer's self-attention (causal), cross K/V over the source rows, cross q/o and the
    cross-attention, its MLP, the last row's unembed."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    enc = _dense_flops(cfg, b * s_src) + 4.0 * b * h * s_src * s_src * hd
    dec = _dense_flops(cfg, b * s_tgt) + 4.0 * b * h * _kept_pairs(s_tgt, s_tgt, True, None) * hd
    dec += 2.0 * b * s_src * 2 * d * kv * hd + 2.0 * b * s_tgt * 2 * d * h * hd
    dec += 4.0 * b * h * s_tgt * s_src * hd
    front = 2.0 * b * s_src * cfg.frontend_dim * d
    return front + cfg.encoder_layers * enc + cfg.num_layers * dec + 2.0 * b * d * cfg.vocab_size


def phase_seamless() -> dict:
    """Serve seamless-m4t-large-v2 at full width and depth (24 encoder and 24 decoder layers,
    bfloat16) through ``build(cfg).prefill`` and greedy ``decode_step``, the reference's loop:
    a batch of 4 at 4,096 source frames and two requests alone at ragged lengths
    (SEAMLESS_REQUESTS), 32 tokens each; the launch gates (the flash forward 72 times a prefill
    and 24 a decode step, decode_attention 24 a decode step, nothing else), decode steps 0, 7,
    15, 31 against a fresh prefill, serving numbers beside their bounds, a profiled prefill
    with the encoder's share and a profiled decode window with the cross-attention's; then a
    float32 enc layer and an xattn layer (prefill and decode through the grown cache) on the
    card against the CPU path. Returns the flash launches by block (the encoder, the
    cross-attention at prefill and at decode, the decoder's self-attention) and the
    decode-attention launches."""
    tag = "[seamless]"
    cfg = get_config(SEAMLESS_ARCH)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(
        f"{tag} {cfg.name}: {cfg.encoder_layers} encoder and {cfg.num_layers} decoder layers, "
        f"d={cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim} ({cfg.num_kv_heads} KV), "
        f"{cfg.act} MLP of {cfg.d_ff} (glu {cfg.glu}), {cfg.norm}, vocab {cfg.vocab_size} "
        f"(untied), remat {cfg.remat!r}; {count_params(cfg)} params {cfg.param_dtype}, {held} "
        f"bytes on the card; segments {model.enc_segments} + {model.segments}; drawn in "
        f"{time.monotonic() - t0:.1f} s"
    )
    gen = _gen(11)

    def request(b, s_src, n_tok):
        frames = torch.randn(b, s_src, cfg.frontend_dim, generator=gen, device=DEV)
        toks = torch.randint(0, cfg.vocab_size, (b, n_tok), generator=gen, device=DEV)
        return {"frames": frames.to(torch.bfloat16), "tokens": toks}

    batches = [request(*r) for r in SEAMLESS_REQUESTS]
    L, E, counts = cfg.num_layers, cfg.encoder_layers, {}
    _, s_src, n_tok = SEAMLESS_REQUESTS[1]
    timed = {
        "cross prefill": CROSS_PREFILL_JSON[3:5],
        "self prefill": SEAMLESS_SELF_FLASH_JSON[3:5],
        "decode cache": DECODE_SEAMLESS_JSON[3:4],
    }
    path = {
        "cross prefill": (n_tok, s_src),
        "self prefill": (n_tok, n_tok),
        "decode cache": (SEAMLESS_REQUESTS[0][2] + NEW_TOKENS,),
    }
    if timed != path:
        raise AssertionError(f"{tag} the kernel rows' shapes {timed} are not the path's {path}")
    with torch.no_grad():
        _greedy(model, params, request(1, 64, 4), 2, keep=())  # load the kernels, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        runs = []
        t0 = time.monotonic()
        with _encdec_ranges(counts):
            for batch in batches:
                runs.append(_greedy(model, params, batch, NEW_TOKENS))
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {
            "flash": fa.flash_attention_fwd.launches,
            "decode_attention": da.decode_attention.launches,
        }
        others = (
            fa.flash_attention_bwd.launches,
            rg.rglru_scan.launches,
            rg.rglru_bwd.launches,
            wk.wkv6_chunked.launches,
            wk.wkv6_bwd.launches,
        )
        n_pre, n_steps = len(batches), len(batches) * NEW_TOKENS
        want = {"flash": (E + 2 * L) * n_pre + L * n_steps, "decode_attention": L * n_steps}
        want_split = {"encoder": E * n_pre, "cross prefill": L * n_pre, "cross decode": L * n_steps}
        if launches != want or counts != want_split or any(others):
            raise AssertionError(
                f"{tag} launches {launches} (expected {want}), by block {counts} (expected "
                f"{want_split}); flash backward, rglru, wkv6 launches {others}, expected 0"
            )
        log(
            f"{tag} flash_attention_fwd launches {launches['flash']} = {n_pre} prefills x ({E} "
            f"encoder + {L} self + {L} cross) + {n_steps} decode steps x {L} cross at Sq = 1 "
            f"({fa.PATHS[torch.bfloat16]} path; by block {counts}); decode_attention launches "
            f"{launches['decode_attention']} = {n_steps} decode steps x {L} layers; no other "
            "kernel"
        )
        models = ((model, params), _float32_copy(cfg, params))
        worst, worst_ratio, differ = 0.0, 0.0, 0
        for (b, s_src, n_tok), batch, (tokens, kept, pre_ms, dec_ms) in zip(
            SEAMLESS_REQUESTS, batches, runs
        ):
            err, ratio, gaps, used, diff = _teacher_forced_steps(tag, models, batch, tokens, kept)
            worst, worst_ratio, differ = max(worst, err), max(worst_ratio, ratio), differ + diff
            log(
                f"{tag} request B={b} Ssrc={s_src} prompt {n_tok}: prefill {pre_ms:.3f} ms, decode "
                f"{dec_ms:.3f} ms/step over {NEW_TOKENS} steps; decode steps {list(kept)} vs a "
                f"fresh prefill max |err| {err:.4e}, {ratio:.3f} of the prefill's own gap to "
                f"float32 ({gaps[0]:.4e}-{gaps[1]:.4e}), {100 * used:.1f}% of the limit "
                f"min({TEACHER_GAPS} x gap, {LOGIT_TOL_BF16}); greedy tokens that differ "
                f"{diff}/{b * (len(kept) - 1)}"
            )
        del models
        n_tokens = sum(b * NEW_TOKENS for b, _, _ in SEAMLESS_REQUESTS)
        log(
            f"{tag} all requests: {n_tokens} tokens in {wall:.4f} s: {n_tokens / wall:.2f} tok/s "
            f"(host wall, each prefill and decode loop synced); max_memory_allocated {peak} "
            f"bytes ({peak - held} above the weights); decode vs fresh prefill max |err| "
            f"{worst:.4e}, at most {worst_ratio:.3f} of the prefill's own gap to float32, greedy "
            f"tokens that differ {differ}"
        )
        _seamless_bounds(tag, cfg, params, runs[0])
        _seamless_profiles(tag, model, params, batches[0])
    del model, params, batches, runs
    _release()
    with torch.no_grad():
        _seamless_layer_checks(tag, cfg)
    _release()
    return {
        "flash_encoder": counts["encoder"],
        "flash_cross_prefill": counts["cross prefill"],
        "flash_cross_decode": counts["cross decode"],
        "flash_self": launches["flash"] - sum(counts.values()),
        "decode_attention": launches["decode_attention"],
    }


def _seamless_bounds(tag, cfg, params, run) -> None:
    """The batch-4 request's prefill and decode step beside their bounds: the prefill's FLOPs
    at the bfloat16 peak; a decode step's bytes (the decoder's weights but the cross K/V
    projections, the final norm, the unembed, the cross K/V caches, the self caches) at
    3.35 TB/s."""
    b, s_src, n_tok = SEAMLESS_REQUESTS[0]
    _, _, pre_ms, dec_ms = run
    itemsize = 2
    kv, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    cross_kv = tuple(("xattn", name) for name in ("wk", "wv", "bk", "bv"))  # prefill's alone
    weights = _weights_bytes(params["seg0"], skip=cross_kv) + _weights_bytes(
        {k: params[k] for k in ("final_norm", "unembed")}
    )
    cross = 2 * L * b * kv * s_src * hd * itemsize
    self_cache = 2 * L * b * (n_tok + NEW_TOKENS) * kv * hd * itemsize
    nbytes = weights + cross + self_cache
    decode_bound = 1e3 * nbytes / PEAK_HBM_BYTES
    flops = _encdec_prefill_flops(cfg, b, s_src, n_tok)
    pre_bound = 1e3 * max(flops / PEAK_BF16_FLOPS, _weights_bytes(params) / PEAK_HBM_BYTES)
    log(
        f"{tag} bounds at B={b}, Ssrc={s_src}: a decode step reads {nbytes} bytes ({weights} of "
        f"weights, {cross} of cross K/V, {self_cache} of self caches): {decode_bound:.4f} ms at "
        f"3.35 TB/s against {dec_ms:.4f} ms/step measured ({dec_ms / decode_bound:.2f}x); the "
        f"prefill's {flops:.4e} FLOPs: {pre_bound:.3f} ms at 989 TFLOP/s against {pre_ms:.3f} ms "
        f"measured ({pre_ms / pre_bound:.2f}x)"
    )


def _seamless_profiles(tag, model, params, batch) -> None:
    """The encoder's share of a prefill of ``batch``, by CUDA events around its stack and
    around the whole prefill; the prefill under the profiler by kind of kernel; and a
    profiled window of 5 decode steps at its batch with the cross-attention's share. The
    profiler's ranges count the kernels PyTorch launches inside them, not the port's own
    (launched through ctypes), which it lists apart by name: a decode step's flash launches
    are all the cross-attention's (the launch gate), so its share adds them to the range's."""
    b, s_src = batch["frames"].shape[:2]
    pad_to = _pad_to(batch, NEW_TOKENS)
    spans = {}
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with _encdec_ranges({}, spans):
        torch.cuda.synchronize()
        whole[0].record()
        model.prefill(params, batch, pad_to=pad_to)
        whole[1].record()
        torch.cuda.synchronize()
    total = whole[0].elapsed_time(whole[1])
    share = {k: sum(a.elapsed_time(z) for a, z in v) for k, v in spans.items()}
    log(
        f"{tag} prefill (B={b}, Ssrc={s_src}) by CUDA events: {total:.3f} ms from its first "
        f"launch to its last kernel's end; the encoder's stack {share['encoder']:.3f} ms of it "
        f"({100 * share['encoder'] / total:.1f}%), the 24 cross-attention blocks "
        f"{share['cross prefill']:.3f} ms ({100 * share['cross prefill'] / total:.1f}%)"
    )
    prefill = functools.partial(model.prefill, params, batch, pad_to=pad_to)
    _profile(tag, f"prefill (B={b}, Ssrc={s_src})", prefill, 1)
    _, cache = model.prefill(params, batch, pad_to=pad_to)
    tok = torch.zeros(b, dtype=torch.long, device=DEV)
    with _encdec_ranges({}):
        prof = _profile(
            tag,
            f"decode step (B={b}, Ssrc={s_src})",
            lambda: model.decode_step(params, cache, {"token": tok}),
            5,
            ("cross",),
        )
    if prof:
        flash = prof["kinds"].get("flash", 0.0) / 5
        cross = prof["cross"] + flash
        log(
            f"{tag} decode step (B={b}, Ssrc={s_src}): the cross-attention {cross:.3f} ms of the "
            f"device's {prof['device_ms']:.3f} ms a step ({100 * cross / prof['device_ms']:.1f}%): "
            f"its flash kernel at Sq = 1 {flash:.3f} ms (24 launches), its projections and norm "
            f"{prof['cross']:.3f} ms"
        )


def _seamless_layer_checks(tag, cfg) -> None:
    """Full-width float32 layers on the card against the port's CPU path, within EXACT_TOL:
    an enc layer (train mode, as the encoder runs) on x(1, 333, 1024); an xattn layer's prefill
    of 37 decoder rows against 333 source rows, its cache (self k, v; cross_k, cross_v); its
    decode steps through the cache grown by ``_pad_cache`` (the float32 flash at Sq = 1 for the
    cross-attention, decode_attention for the self-attention), each also against a fresh
    prefill on the card."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    s_src, s_tgt, steps = SEAMLESS_LAYER_CHECK
    rng = np.random.default_rng(3)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    lp = _float32_layer(cfg32, "enc", 1)
    x, pos = normal(1, s_src, cfg.d_model), torch.arange(s_src)
    _reset_launches()
    got, _, _ = apply_layer(x.to(DEV), lp, cfg32, "enc", positions=pos.to(DEV), mode="train")
    if fa.flash_attention_fwd.launches != 1:
        raise AssertionError(f"{tag} float32 enc layer: {fa.flash_attention_fwd.launches} flash")
    want, _, _ = apply_layer(x, _to_cpu(lp), cfg32, "enc", positions=pos, mode="train")
    err = (got.cpu() - want).abs().max().item()
    if not torch.isfinite(got).all() or err > EXACT_TOL:
        raise AssertionError(f"{tag} float32 enc layer card vs CPU path: max |err| {err:.3e}")
    log(
        f"{tag} one float32 enc layer on x(1, {s_src}, {cfg.d_model}): card (flash kernel, no "
        f"mask, {fa.PATHS[torch.float32]} path) vs CPU path (plain) max |err| {err:.3e} (tol "
        f"{EXACT_TOL})"
    )

    lp = _float32_layer(cfg32, "xattn", 2)
    cpu = _to_cpu(lp)
    enc, x = normal(1, s_src, cfg.d_model), normal(1, s_tgt + steps, cfg.d_model)
    segments = [(("xattn",), 1)]

    def run(params, dev):
        out, cache, _ = apply_layer(
            x[:, :s_tgt].to(dev), params, cfg32, "xattn", positions=torch.arange(s_tgt, device=dev),
            mode="prefill", enc_out=enc.to(dev),
        )
        first = {k: v for k, v in cache.items() if k != "self"} | {
            f"self {k}": v for k, v in cache["self"].items() if k != "pos"
        }
        first = {k: v.cpu().clone() for k, v in first.items()}
        grown = model_mod._pad_cache({"seg0": {"u0": cache}}, s_tgt + steps, cfg32, segments)
        cache, outs = grown["seg0"]["u0"], [out.cpu()]
        for j in range(steps):
            xt = x[:, s_tgt + j : s_tgt + j + 1].to(dev)
            at = torch.tensor([[s_tgt + j]], device=dev)
            out, cache, _ = apply_layer(
                xt, params, cfg32, "xattn", positions=at, mode="decode", cache=cache
            )
            outs.append(out.cpu())
        return outs, first

    _reset_launches()
    got, got_cache = run(lp, DEV)
    counts = (fa.flash_attention_fwd.launches, da.decode_attention.launches)
    if counts != (2 + steps, steps):
        raise AssertionError(f"{tag} float32 xattn layer: flash, decode_attention {counts}")
    want, want_cache = run(cpu, "cpu")
    errs = {"prefill h": (got[0] - want[0]).abs().max().item()}
    errs.update({k: (got_cache[k] - v).abs().max().item() for k, v in want_cache.items()})
    errs.update({f"decode {j}": (g - w).abs().max().item() for j, (g, w) in
                 enumerate(zip(got[1:], want[1:]))})
    fresh, _, _ = apply_layer(
        x.to(DEV), lp, cfg32, "xattn", positions=torch.arange(s_tgt + steps, device=DEV),
        mode="prefill", enc_out=enc.to(DEV),
    )
    vs_fresh = (torch.cat(got[1:], dim=1) - fresh[:, s_tgt:].cpu()).abs().max().item()
    finite = all(torch.isfinite(g).all() for g in got)
    if not finite or max(errs.values()) > EXACT_TOL or vs_fresh > EXACT_TOL:
        raise AssertionError(f"{tag} float32 xattn layer: {errs}, decode vs fresh {vs_fresh}")
    log(
        f"{tag} one float32 xattn layer: prefill of {s_tgt} rows against {s_src} source rows "
        f"(flash causal self and cross without a mask, {fa.PATHS[torch.float32]}), then {steps} "
        f"decode steps through the grown cache (cross: the flash at Sq = 1; self: "
        f"decode_attention); flash {counts[0]}, decode_attention {counts[1]} launches; card vs "
        f"CPU path max |err| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
        f"{EXACT_TOL}); the card's decode steps vs a fresh prefill of {s_tgt + steps} rows "
        f"{vs_fresh:.3e} (tol {EXACT_TOL})"
    )


def phase_internvl() -> dict:
    """Serve internvl2-2b at full width and depth (24 layers, 16 heads on 8 KV heads of 128,
    the vision stub's 256 patch tokens of 1,024; bfloat16) through ``build(cfg).prefill`` and
    greedy ``decode_step``, the reference's loop: 4 requests alone, each with its own patch
    embeddings and a text prompt of make_prompts, 32 tokens each; the launch gates (the flash
    forward 24 times a prefill, decode_attention 24 times a decode step, nothing else), decode
    steps 0, 7, 15, 31 against a fresh prefill, serving numbers beside their bounds, a profiled
    prefill and decode window; then a float32 copy cut to one layer on the card against the CPU
    path: the frontend's output and the layer's prefill. Returns the launch counts."""
    tag = "[internvl]"
    cfg = get_config(INTERNVL_ARCH)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {cfg.num_heads} heads on "
        f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, {cfg.act} GLU of {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (untied), the vision stub's {cfg.num_frontend_tokens} patch tokens of "
        f"{cfg.frontend_dim}; {count_params(cfg)} params {cfg.param_dtype}, {held} bytes on the "
        f"card; drawn in {time.monotonic() - t0:.1f} s"
    )
    prompts = make_prompts(INTERNVL_REQUESTS, cfg.vocab_size, *INTERNVL_PROMPT_LENS, seed=0)
    gen = _gen(12)

    def request(prompt):
        shape = (1, cfg.num_frontend_tokens, cfg.frontend_dim)
        patches = torch.randn(*shape, generator=gen, device=DEV)
        toks = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
        return {"patch_embeds": patches.to(torch.bfloat16), "tokens": toks}

    batches = [request(p) for p in prompts]
    L = cfg.num_layers
    with torch.no_grad():
        _greedy(model, params, request(prompts[0][:8]), 2, keep=())  # load the kernels, warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.monotonic()
        runs = [_greedy(model, params, batch, NEW_TOKENS) for batch in batches]
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {
            "flash": fa.flash_attention_fwd.launches,
            "decode_attention": da.decode_attention.launches,
        }
        others = (
            fa.flash_attention_bwd.launches,
            rg.rglru_scan.launches,
            rg.rglru_bwd.launches,
            wk.wkv6_chunked.launches,
            wk.wkv6_bwd.launches,
        )
        n_steps = len(batches) * NEW_TOKENS
        want = {"flash": L * len(batches), "decode_attention": L * n_steps}
        if launches != want or any(others):
            raise AssertionError(
                f"{tag} launches {launches} (expected {want}); flash backward, rglru, wkv6 "
                f"launches {others}, expected 0"
            )
        log(
            f"{tag} prompt lengths {[len(p) for p in prompts]} after {cfg.num_frontend_tokens} "
            f"patch tokens; flash_attention_fwd launches {launches['flash']} = {len(batches)} "
            f"prefills x {L} layers ({fa.PATHS[torch.bfloat16]} path, causal, GQA "
            f"{cfg.num_heads // cfg.num_kv_heads}); decode_attention launches "
            f"{launches['decode_attention']} = {n_steps} decode steps x {L} layers; no other kernel"
        )
        models = ((model, params), _float32_copy(cfg, params))
        worst, worst_ratio, differ = 0.0, 0.0, 0
        for prompt, batch, (tokens, kept, pre_ms, dec_ms) in zip(prompts, batches, runs):
            err, ratio, gaps, used, diff = _teacher_forced_steps(tag, models, batch, tokens, kept)
            worst, worst_ratio, differ = max(worst, err), max(worst_ratio, ratio), differ + diff
            log(
                f"{tag} request of {cfg.num_frontend_tokens} + {len(prompt)} tokens: prefill "
                f"{pre_ms:.3f} ms, decode {dec_ms:.3f} ms/step over {NEW_TOKENS} steps; decode "
                f"steps {list(kept)} vs a fresh prefill max |err| {err:.4e}, {ratio:.3f} of the "
                f"prefill's own gap to float32 ({gaps[0]:.4e}-{gaps[1]:.4e}), {100 * used:.1f}% "
                f"of the limit min({TEACHER_GAPS} x gap, {LOGIT_TOL_BF16}); greedy tokens that "
                f"differ {diff}/{len(kept) - 1}"
            )
        del models
        n_tokens = len(batches) * NEW_TOKENS
        served = {k: v for k, v in params.items() if k not in ("embed", "frontend")}
        nbytes = _weights_bytes(served)
        cache = 2 * L * (cfg.num_frontend_tokens + max(map(len, prompts)) + NEW_TOKENS)
        cache *= cfg.num_kv_heads * cfg.head_dim * 2
        decode_bound = 1e3 * (nbytes + cache) / PEAK_HBM_BYTES
        n = cfg.num_frontend_tokens + max(map(len, prompts))
        if (n, n + NEW_TOKENS) != (INTERNVL_FLASH_JSON[3], DECODE_INTERNVL_JSON[3]):
            raise AssertionError(
                f"{tag} the kernel rows' lengths {INTERNVL_FLASH_JSON[3]}, "
                f"{DECODE_INTERNVL_JSON[3]} are not the longest request's {n}, {n + NEW_TOKENS}"
            )
        pairs = _kept_pairs(n, n, True, None)
        flops = L * (_dense_flops(cfg, n) + 4.0 * cfg.num_heads * pairs * cfg.head_dim)
        flops += 2.0 * cfg.num_frontend_tokens * (cfg.frontend_dim + cfg.d_model) * cfg.d_model
        flops += 2.0 * cfg.d_model * cfg.vocab_size
        pre_bound = 1e3 * max(flops / PEAK_BF16_FLOPS, _weights_bytes(params) / PEAK_HBM_BYTES)
        longest = int(np.argmax([len(p) for p in prompts]))
        log(
            f"{tag} all requests: {n_tokens} tokens in {wall:.4f} s: {n_tokens / wall:.2f} tok/s "
            f"(host wall, each prefill and decode loop synced); max_memory_allocated {peak} "
            f"bytes ({peak - held} above the weights); decode vs fresh prefill max |err| "
            f"{worst:.4e}, at most {worst_ratio:.3f} of the prefill's own gap to float32, greedy "
            f"tokens that differ {differ}; bounds: a decode step reads "
            f"{nbytes + cache} bytes (the layers, final norm and unembed; the longest request's "
            f"K/V cache), {decode_bound:.4f} ms at 3.35 TB/s against "
            f"{np.mean([r[3] for r in runs]):.4f} ms/step measured (mean of the requests); the "
            f"longest prefill ({n} tokens, {flops:.4e} FLOPs) {pre_bound:.3f} ms against "
            f"{runs[longest][2]:.3f} ms measured"
        )
        batch = batches[longest]
        pad_to = _pad_to(batch, NEW_TOKENS)
        _profile(tag, f"prefill of {n} tokens", lambda: model.prefill(
            params, batch, pad_to=pad_to), 1)
        _, cache = model.prefill(params, batch, pad_to=pad_to)
        tok = torch.zeros(1, dtype=torch.long, device=DEV)
        _profile(tag, "decode step (B=1)", lambda: model.decode_step(
            params, cache, {"token": tok}), 5)
    del model, params, batches, runs, cache
    _release()
    with torch.no_grad():
        _internvl_float32_check(tag, cfg, prompts[longest])
    _release()
    return launches


def _internvl_float32_check(tag, cfg, prompt) -> None:
    """A float32 copy of internvl2-2b cut to one layer, drawn on the card: a prefill of the
    256 patch embeddings and ``prompt`` on the card and on the CPU path with the same params;
    the frontend's output (proj1, tanh-GELU, proj2: the first 256 rows that the stack takes),
    the layer's cache and the last position's logits within EXACT_TOL."""
    cfg32 = dataclasses.replace(
        cfg, num_layers=1, param_dtype="float32", compute_dtype="float32"
    )
    params = init_params(cfg32, _gen(1), DEV)
    rng = np.random.default_rng(5)
    patches = rng.normal(size=(1, cfg.num_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    batch = {
        "patch_embeds": torch.from_numpy(patches),
        "tokens": torch.as_tensor(prompt)[None].long(),
    }
    seen = []
    run_stack = model_mod.run_stack

    def recording(h, *args, **kwargs):
        seen.append(h[:, : cfg.num_frontend_tokens].cpu())
        return run_stack(h, *args, **kwargs)

    model_mod.run_stack = recording
    try:
        _reset_launches()
        got, got_cache = build(cfg32, DEV).prefill(
            params, {k: v.to(DEV) for k, v in batch.items()}
        )
        if (fa.flash_attention_fwd.launches, da.decode_attention.launches) != (1, 0):
            raise AssertionError(f"{tag} float32 layer: {fa.flash_attention_fwd.launches} flash")
        want, want_cache = build(cfg32, "cpu").prefill(_to_cpu(params), batch)
    finally:
        model_mod.run_stack = run_stack
    errs = {"frontend": (seen[0] - seen[1]).abs().max().item()}
    for k in ("k", "v"):
        got_k, want_k = got_cache["seg0"]["u0"][k].cpu(), want_cache["seg0"]["u0"][k]
        errs[k] = (got_k - want_k).abs().max().item()
    errs["logits"] = (got.cpu() - want).abs().max().item()
    if not torch.isfinite(got).all() or max(errs.values()) > EXACT_TOL:
        raise AssertionError(f"{tag} float32 one-layer prefill card vs CPU path: {errs}")
    log(
        f"{tag} float32 copy cut to one layer ({count_params(cfg32)} params), prefill of "
        f"{cfg.num_frontend_tokens} patches + {len(prompt)} tokens: card (flash kernel, "
        f"{fa.PATHS[torch.float32]} path) vs CPU path (plain) max |err| "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {EXACT_TOL}); the frontend "
        f"on x(1, {cfg.num_frontend_tokens}, {cfg.frontend_dim})"
    )


DENSE_TRAIN_ARCH = "qwen3-1.7b"
DENSE_TRAIN_RESULT = "[dense train] launches "  # the process's line of launch counts and times


def phase_dense_train() -> dict:
    """Run the dense train phase in a process of its own (this file with
    ``--dense-train``); returns its launch counts, step ms and peak memory."""
    return _in_process(DENSE_TRAIN_ARG, DENSE_TRAIN_RESULT, "[dense train]")


def _replay_differs(host, tree) -> dict:
    """Elements that differ between a tree kept on the host and one on the card, compared
    with torch.equal on the card leaf by leaf (each host leaf brought back in turn)."""

    def count(a, b):
        return sum(
            0 if torch.equal(x.to(DEV), y) else int((x.to(DEV) != y).sum())
            for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)
        )

    params, state, metrics = tree
    return {
        "params": count(host[0], params),
        "m": count(host[1]["m"], state["m"]),
        "v": count(host[1]["v"], state["v"]),
        "step": count(host[1]["step"], state["step"]),
        "metrics": count(host[2], metrics),
    }


def _pinned(tree):
    """The tree's tensors copied into page-locked host memory: the copies back to the card
    run at the link's rate, where pageable ones run at ~1.6 GB/s (PERF.md §6, PR 30)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x), tree)


def _dense_train() -> dict:
    """qwen3-1.7b at full width and depth in bfloat16 (remat "full"), 3 AdamW steps on
    TokenSource batches of DENSE_TRAIN_BATCH x TRAIN_SEQ: :func:`_bf16_train`; then the same
    steps directly at the dense durable phase's depth, with its first checkpoint pair's
    digests."""
    out = _bf16_train(get_config(DENSE_TRAIN_ARCH), DENSE_TRAIN_BATCH, "[dense train]")
    _release()
    opt = AdamWConfig(**TRAIN_OPT)
    cut = _direct_steps(_dense_cut_config(), opt, DENSE_TRAIN_BATCH, "[dense train]", pair_at=2)
    return {**out, "cut": cut}


def _layer_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` train steps of ``cfg`` with remat "full", which runs
    each layer's forward again in its backward: the flash forward twice and its backward
    once an attention layer (a dense, attn or moe layer, an encoder layer), twice and once
    for each of an xattn layer's two attentions (its causal self-attention, its
    cross-attention), the RG-LRU forward twice and its backward once a rec layer, the WKV6
    chunk forward twice and its backward once an rwkv layer; the MTP module's dense layer
    runs outside the remat, as the reference runs it outside ``jax.checkpoint``: its flash
    forward and backward once each."""
    kinds = layer_pattern(cfg)
    attn = sum(kind in ("dense", "attn", "moe") for kind in kinds)
    attn += 2 * sum(kind == "xattn" for kind in kinds) + cfg.encoder_layers
    rec = sum(kind == "rec" for kind in kinds)
    rwkv = sum(kind == "rwkv" for kind in kinds)
    mtp = int(cfg.mtp)
    return {
        "flash": (2 * attn + mtp) * steps,
        "flash_bwd": (attn + mtp) * steps,
        "rglru": 2 * rec * steps,
        "rglru_bwd": rec * steps,
        "wkv6": 2 * rwkv * steps,
        "wkv6_bwd": rwkv * steps,
    }


@contextlib.contextmanager
def _flash_shapes(counts: dict):
    """Count into ``counts`` the flash forward and backward launches made through
    ``FlashAttentionFunction`` (a train step's path), by shape and mask: the wrappers' own
    counters read before and after each call of its forward and backward (this file's patch;
    the port's code carries none). The backward's key is taken when its forward runs, since
    remat's saved tensors may be read once. Keys: "fwd q(B, Hq, Sq, D) k(B, Hkv, Sk) causal"
    (or "no mask"), and "bwd ..." the same."""
    cls = fa.FlashAttentionFunction
    forward, backward = cls.forward, cls.backward

    def add(key, n):
        counts[key] = counts.get(key, 0) + n

    def counted_forward(ctx, q, k, v, causal, window, scale):
        n0 = fa.flash_attention_fwd.launches
        out = forward(ctx, q, k, v, causal, window, scale)
        shape = f"q{tuple(q.shape)} k{tuple(k.shape[:3])} {'causal' if causal else 'no mask'}"
        ctx.counted_as = f"bwd {shape}"
        add(f"fwd {shape}", fa.flash_attention_fwd.launches - n0)
        return out

    def counted_backward(ctx, dout):
        n0 = fa.flash_attention_bwd.launches
        grads = backward(ctx, dout)
        add(ctx.counted_as, fa.flash_attention_bwd.launches - n0)
        return grads

    cls.forward, cls.backward = staticmethod(counted_forward), staticmethod(counted_backward)
    try:
        yield counts
    finally:
        cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)


def _bf16_train(
    cfg,
    batch_size: int,
    tag: str,
    state_dtype: str = "float32",
    plain_seq=None,
    seq: int = TRAIN_SEQ,
    inputs=None,
    ragged=(),
) -> dict:
    """``cfg`` (bfloat16, remat "full") takes 3 AdamW steps (the train CLI's, with m and v in
    ``state_dtype``) on TokenSource batches of batch_size x ``seq``, with the frontend's
    ``inputs(step)`` (frames or patch embeddings) beside the tokens where given,
    deterministically: the launch gates, step 0 replayed with equal bits, a profiled step,
    then one step on each ``ragged`` batch ((label, batch) pairs) with its own launch gate,
    then step 0 against attn_impl="ref" (on the first ``plain_seq`` tokens of its batch where
    given, the gradients waiting on the host during the float32 run), and the same on the
    first ragged batch. Step 0's result waits on the host while its replay runs (params, m and
    v of two states take most of the card), training goes on from the replay's, and the first
    params wait on the host over steps 1 and 2 for the checks against the plain path at the
    end. The flash launches are counted by shape and mask (:func:`_flash_shapes`)."""
    from repro_torch.launch.train import opt_config

    if (cfg.param_dtype, cfg.compute_dtype, cfg.remat) != ("bfloat16", "bfloat16", "full"):
        raise AssertionError(f"{tag} {cfg.name}: {cfg.param_dtype}, {cfg.remat}")
    t_set_up = time.monotonic()
    model = build(cfg, DEV)
    params0 = init_params(cfg, _gen(0), DEV)
    opt = AdamWConfig(**TRAIN_OPT, state_dtype=state_dtype)
    cli = dataclasses.replace(opt_config(TRAIN_STEPS), state_dtype=state_dtype)
    if opt != cli:
        raise AssertionError(f"{tag} {opt} is not the CLI's {cli}")
    state0 = make_opt_init(model, opt)(params0)
    train_step = make_train_step(model, opt)
    source = TokenSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch_size, seed=0)
    )
    batches = [
        {
            "tokens": torch.from_numpy(source.batch_at(s)["tokens"]).long().to(DEV),
            **(inputs(s) if inputs else {}),
        }
        for s in range(TRAIN_STEPS)
    ]
    tokens = batch_size * seq
    beside = "".join(
        f" and {key} {tuple(x.shape)} {str(x.dtype)[6:]}"
        for key, x in batches[0].items()
        if key != "tokens"
    )
    torch.cuda.synchronize()
    pattern = ", ".join(cfg.block_pattern) if cfg.block_pattern else layer_pattern(cfg)[0]
    heads = (
        f"{cfg.d_model // cfg.rwkv_head_size} WKV heads of {cfg.rwkv_head_size}"
        if cfg.family == "ssm"
        else f"{cfg.num_heads} heads on {cfg.num_kv_heads} KV heads of {cfg.head_dim}"
    )
    if cfg.mla:
        heads = (
            f"MLA with {cfg.num_heads} heads (q_lora {cfg.q_lora_rank}, kv_lora "
            f"{cfg.kv_lora_rank}, qk {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v "
            f"{cfg.v_head_dim}), d_ff {cfg.d_ff}"
        )
    if cfg.mtp:
        pattern += f"; the MTP module (a dense layer; mtp_coef {cfg.mtp_coef})"
    if cfg.is_encdec:
        pattern = f"{cfg.encoder_layers} encoder layers, then {pattern}"
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} layers ({pattern}), d={cfg.d_model}, {heads}"
        + (f", window {cfg.window}" if cfg.block_pattern else "")
        + f", vocab {cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} embeddings, "
        f"{cfg.param_count()} params {cfg.param_dtype}, remat={cfg.remat}; batches of "
        f"{batch_size} x {seq} tokens from TokenSource(seed=0){beside}; {opt}; "
        f"{torch.cuda.memory_allocated()} bytes held (params, AdamW m and v), drawn in "
        f"{time.monotonic() - t_set_up:.1f} s"
    )
    torch.use_deterministic_algorithms(True)
    _reset_launches()
    by_shape = {}

    def run(step, params, state, batch=None):
        t0 = time.monotonic()
        with _flash_shapes(by_shape):
            params, state, metrics = train_step(params, state, batch or batches[step])
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        vals = {key: float(x) for key, x in metrics.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"{tag} step {step}: metrics {vals}")
        mtp = f" mtp_loss {vals['mtp_loss']:.6f}" if "mtp_loss" in vals else ""
        n = tokens if batch is None else batch["tokens"].numel()
        log(
            f"{tag} step {step}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} z_loss "
            f"{vals['z_loss']:.4f} aux_loss {vals['aux_loss']:.6f}{mtp} grad_norm "
            f"{vals['grad_norm']:.6f} lr {vals['lr']:.4e}; "
            f"{ms:.3f} ms, {n / ms * 1e3:.1f} tokens/s (host clock after a sync); "
            f"max_memory_allocated so far {torch.cuda.max_memory_allocated()} bytes"
        )
        return (params, state, metrics), ms

    first, ms0 = run(0, params0, state0)
    t_host = time.monotonic()
    host = tuple(_pinned(tree) for tree in first)
    t_host = time.monotonic() - t_host
    del first  # its memory stays in the allocator's cache for the replay
    # replay: step 0 again from the same state, equal bits (the
    # trees are compared with torch.equal on the card)
    (params, state, metrics), ms_replay = run(0, params0, state0)
    t_diff = time.monotonic()
    diff = _replay_differs(host, (params, state, metrics))
    t_diff = time.monotonic() - t_diff
    if any(diff.values()):
        raise AssertionError(f"{tag} step 0 replayed: elements that differ {diff}")
    n = sum(x.numel() for x in tree_leaves(params))
    log(
        f"{tag} step 0 run again from the same state: params ({n} elements), AdamW m, "
        "v and step, and metrics equal bit for bit (torch.equal on the card); step 0's "
        f"result to pinned host memory {t_host:.1f} s, the comparison {t_diff:.1f} s"
    )
    params0 = _pinned(params0)
    del host, state0, metrics
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = [ms0, ms_replay]
    for step in range(1, TRAIN_STEPS):
        (params, state, _), ms = run(step, params, state)
        step_ms.append(ms)
    peak = torch.cuda.max_memory_allocated()
    launches = {
        "flash": fa.flash_attention_fwd.launches,
        "flash_bwd": fa.flash_attention_bwd.launches,
        "rglru": rg.rglru_scan.launches,
        "rglru_bwd": rg.rglru_bwd.launches,
        "wkv6": wk.wkv6_chunked.launches,
        "wkv6_bwd": wk.wkv6_bwd.launches,
    }
    steps = TRAIN_STEPS + 1  # 0, its replay, 1 and 2
    want = _layer_launches(cfg, steps)
    if launches != want or da.decode_attention.launches:
        raise AssertionError(
            f"{tag} launches {launches}, expected {want}; decode launches "
            f"{da.decode_attention.launches}, expected 0"
        )
    steady = sum(step_ms[1:]) / (len(step_ms) - 1)
    path = ""
    if want["flash_bwd"]:
        d, dv = cfg.head_dim, cfg.head_dim
        if cfg.mla:
            d, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
        path = f"; flash backward on the {fa.bwd_path(d, dv, torch.bfloat16)} path"
        if max(d, dv) > 128:
            h = cfg.num_heads
            parts = fa.bwd_split_plan(TRAIN_SEQ, TRAIN_SEQ, h, h, True, None)
            path += f" (the split builds at D {d}, Dv {dv}, {parts} part a key tile)"
    log(
        f"{tag} kernels launched {launches} over {steps} steps (0, its replay, 1, 2; remat full "
        f"runs each layer's forward again in its recompute: {want} expected{path}); step ms "
        f"(0, replay, 1, 2) {', '.join(f'{x:.3f}' for x in step_ms)} "
        f"(all but the first: {steady:.3f} ms, {tokens / steady * 1e3:.1f} tokens/s); "
        f"max_memory_allocated over steps 1-2 {peak} bytes ({peak - held} above the {held} "
        "held before them)"
    )
    log(f"{tag} flash launches by shape and mask over those steps: {by_shape}")
    main_shapes = dict(by_shape)
    _train_profile(model, params, state, batches[0], opt, tag=tag)
    ragged_out = {}
    for label, batch in ragged:
        _reset_launches()
        by_shape.clear()
        (params, state, _), ms = run(label, params, state, batch)
        got = {
            "flash": fa.flash_attention_fwd.launches,
            "flash_bwd": fa.flash_attention_bwd.launches,
        }
        expected = {k: n for k, n in _layer_launches(cfg, 1).items() if k in got}
        if got != expected:
            raise AssertionError(f"{tag} step {label}: launches {got}, expected {expected}")
        log(f"{tag} step {label}: launches {got} as expected; by shape and mask {by_shape}")
        ragged_out[label] = {**got, "by_shape": dict(by_shape), "ms": ms}
    del params, state
    _release()
    params0 = tree_map(lambda x: x.to(DEV), params0)
    t_check = time.monotonic()
    plain_batch = batches[0]
    if plain_seq:
        plain_batch = {"tokens": batches[0]["tokens"][:, :plain_seq].contiguous()}
    _check_bf16_train_against_plain(
        cfg, model, params0, plain_batch, tag, grads_to_host=bool(plain_seq)
    )
    for label, batch in ragged[:1]:
        _release()
        log(f"{tag} the check against the plain path on the batch of step {label}:")
        _check_bf16_train_against_plain(cfg, model, params0, batch, tag)
    log(f"{tag} the checks against the plain path took {time.monotonic() - t_check:.1f} s")
    return {
        **launches,
        "step_ms": step_ms,
        "peak": peak,
        "by_shape": main_shapes,
        "ragged": ragged_out,
    }


DENSE_DURABLE_LAYERS = 2  # of qwen3-1.7b's 28: a checkpoint pair of 4.1 GB, 412M params
DENSE_DURABLE_DIR = ROOT / "build" / "dense_durable_train"  # build/ is not committed
DENSE_DURABLE_CMD = [
    "-m", "repro_torch.launch.train", "--arch", DENSE_TRAIN_ARCH, "--full",
    "--layers", str(DENSE_DURABLE_LAYERS), "--batch", str(DENSE_TRAIN_BATCH),
    "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--checkpoint-every", "2",
]  # fmt: skip


def _dense_cut_config():
    """qwen3-1.7b at full width and its first DENSE_DURABLE_LAYERS layers, as the train CLI's
    ``--layers`` cuts it (the dense durable phase's model)."""
    cfg = get_config(DENSE_TRAIN_ARCH)
    n = DENSE_DURABLE_LAYERS
    return dataclasses.replace(cfg, num_layers=n, block_pattern=cfg.block_pattern[:n])


def phase_dense_durable(dense_train: dict, smi: str) -> dict:
    """qwen3-1.7b in bfloat16 through the durable trainer at full width and its first
    DENSE_DURABLE_LAYERS layers: :func:`_durable`'s runs A and B with their gates, every
    param checkpointed as bfloat16, A's first pair holding the direct steps' state (its
    content digests), and the tree run B restores equal leaf by leaf to the one A saved.
    ``dense_train`` is the dense train phase's
    result, whose direct steps at that depth it checks. Returns both runs' launches."""
    cfg = _dense_cut_config()
    direct = dense_train["cut"]
    run_dir = DENSE_DURABLE_DIR
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    log(
        f"[dense durable] {cfg.name}: {cfg.num_layers} of its layers at full width, "
        f"{cfg.param_count()} params {cfg.param_dtype}, remat={cfg.remat}; "
        f"{shutil.disk_usage(run_dir).free} bytes free on the run directory's disk ({smi})"
    )
    try:
        runs = _durable("dense durable", cfg, DENSE_DURABLE_CMD, run_dir, direct)
        ckpt = run_dir / "ckpt"
        for tag in ("step00000002", f"step{TRAIN_STEPS:08d}"):
            man = json.loads((ckpt / tag / "manifest.json").read_text())
            dtypes = sorted({e["dtype"] for e in man["entries"].values()})
            if dtypes != ["bfloat16"]:
                raise AssertionError(f"[dense durable] {tag}'s params are {dtypes}")
        want = "step00000002@{};step00000002-opt@{}".format(*direct["pair"])
        if runs["refs"][0] != want:
            raise AssertionError(
                f"[dense durable A] CKPT {runs['refs'][0]}, the direct steps' state {want}"
            )
        log(
            f"[dense durable] every param entry of step00000002 and step{TRAIN_STEPS:08d} "
            f"says bfloat16; CKPT {want} holds the direct steps' params and AdamW state "
            "(their content digests)"
        )
        _restored_bits(ckpt, cfg, smi)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    a, b = runs["a"]["launches"], runs["b"]["launches"]
    return {k: a[k] + b[k] for k in a}


def _shard_on_card(path: Path) -> dict:
    """A checkpoint's arrays read from its raw frame with numpy alone (the tag byte, then
    ``np.load``; bfloat16 members by the manifest's dtype), as tensors on the card by path."""
    entries = json.loads((path / "manifest.json").read_text())["entries"]
    out = {}
    with open(path / "shard-0.npz.zst", "rb") as fh:
        if fh.read(1) != b"\x00":
            raise AssertionError(f"[dense durable] {path.name}: not a raw frame")
        with np.load(fh) as npz:
            for member in npz.files:
                key, arr = member.replace("|", "/"), npz[member]
                t = torch.from_numpy(arr.view(np.int16) if arr.dtype == np.dtype("V2") else arr)
                bf16 = entries[key]["dtype"] == "bfloat16"
                out[key] = (t.view(torch.bfloat16) if bf16 else t).to(DEV)
    return out


def _restored_bits(ckpt: Path, cfg, smi: str) -> None:
    """The pair run B restored (step00000002) restored again as the trainer restores it
    (``restore_pair``: resolve with its content check, both shards, onto the card) against
    the tree run A saved, read from its shards with numpy alone: torch.equal leaf by leaf
    over params, m, v and step."""
    from repro_torch.launch.train import opt_config

    t0 = time.monotonic()
    store = CheckpointStore(str(ckpt))
    _, params, state = restore_pair(store, "step00000002", cfg, opt_config(TRAIN_STEPS), DEV)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    for tag, tree in (("step00000002", params), ("step00000002-opt", state)):
        saved = _shard_on_card(ckpt / tag)
        got = dict(_flatten(tree))  # the store's paths, its npz members' names
        if set(got) != set(saved):
            raise AssertionError(f"[dense durable] {tag}: paths {sorted(set(got) ^ set(saved))}")
        differ = [
            k for k in got if got[k].dtype != saved[k].dtype or not torch.equal(got[k], saved[k])
        ]
        if differ:
            raise AssertionError(f"[dense durable] {tag} restored != saved at {differ[:5]}")
        n = sum(t.numel() for t in got.values())
        kinds = sorted({str(t.dtype).replace("torch.", "") for t in got.values()})
        log(
            f"[dense durable] {tag} as the trainer restores it equals the tree A saved, read "
            f"with numpy alone: {len(got)} leaves, {n} elements ({', '.join(kinds)}), "
            "torch.equal on the card"
        )
    log(f"[dense durable] restore_pair of step00000002 here: {restore_s:.3f} s ({smi})")


HYBRID_TRAIN_ARCH = "recurrentgemma-9b"
# two (rec, rec, attn) periods of its 38 layers: 3.41B params, 40.9 GB of params, gradients and
# AdamW state at full depth would be 125 GB
HYBRID_TRAIN_LAYERS = 6
HYBRID_TRAIN_BATCH = 1  # train_4k's 4096 tokens, its batch cut to one sequence on one card
HYBRID_TRAIN_RESULT = "[hybrid train] launches "  # the process's line of launch counts and times


def phase_hybrid_train() -> dict:
    """Run the hybrid train phase in a process of its own (this file with
    ``--hybrid-train``); returns its launch counts, step ms and peak memory."""
    return _in_process(HYBRID_TRAIN_ARG, HYBRID_TRAIN_RESULT, "[hybrid train]")


def _hybrid_train() -> dict:
    """recurrentgemma-9b at full width, layers 0-5, in bfloat16 (remat "full"), 3 AdamW steps
    on TokenSource batches of HYBRID_TRAIN_BATCH x TRAIN_SEQ: :func:`_bf16_train`."""
    cfg = get_config(HYBRID_TRAIN_ARCH)
    cfg = dataclasses.replace(
        cfg,
        num_layers=HYBRID_TRAIN_LAYERS,
        block_pattern=cfg.block_pattern[:HYBRID_TRAIN_LAYERS],
    )
    return _bf16_train(cfg, HYBRID_TRAIN_BATCH, "[hybrid train]")


RWKV_TRAIN_ARCH = "rwkv6-7b"
# layers 0-3 of its 32 since the deepseek train phase came, to keep the script's phases inside
# the time limit (layers 0-7 before: 2.32B params, a peak of 54.3 GB on an H100 80GB HBM3;
# params, gradients, AdamW state and the out-of-place step's second copy take ~23 bytes a
# parameter, as the hybrid train phase's; 12 layers would need ~74 GB). Every gate holds at any
# depth, and the WKV6 rows keep their shapes.
RWKV_TRAIN_LAYERS = 4
RWKV_TRAIN_BATCH = 1  # train_4k's 4096 tokens, its batch cut to one sequence on one card
RWKV_TRAIN_RESULT = "[rwkv train] launches "  # the process's line of launch counts and times


def phase_rwkv_train() -> dict:
    """Run the rwkv train phase in a process of its own (this file with ``--rwkv-train``);
    returns its launch counts, step ms and peak memory."""
    return _in_process(RWKV_TRAIN_ARG, RWKV_TRAIN_RESULT, "[rwkv train]")


def _rwkv_train() -> dict:
    """rwkv6-7b at full width, layers 0-3, in bfloat16 (remat "full"), 3 AdamW steps on
    TokenSource batches of RWKV_TRAIN_BATCH x TRAIN_SEQ: :func:`_bf16_train`."""
    cfg = dataclasses.replace(get_config(RWKV_TRAIN_ARCH), num_layers=RWKV_TRAIN_LAYERS)
    return _bf16_train(cfg, RWKV_TRAIN_BATCH, "[rwkv train]")


MOE_TRAIN_RESULT = "[moe train] launches "  # the process's line of launch counts and times
# granite-moe-3b-a800m is trained at 16 of its 32 layers since the deepseek train phase came, to
# keep the script's phases inside the time limit (its full depth: 3,299,575,296 params, a peak of
# 75.9 GB, 1,160.7-1,204.0 ms a step; PERF.md §5): every gate holds at any depth, and granite's
# train-shape kernel rows keep their shapes
MOE_TRAIN_LAYERS = 16


def phase_moe_train() -> dict:
    """Run the moe train phase in a process of its own (this file with ``--moe-train``);
    returns its launch counts, step ms and peak memory."""
    return _in_process(MOE_TRAIN_ARG, MOE_TRAIN_RESULT, "[moe train]")


def _moe_train() -> dict:
    """granite-moe-3b-a800m at full width and MOE_TRAIN_LAYERS of its 32 MoE layers, in
    bfloat16 (remat "full"), 3 AdamW steps on TokenSource batches of MOE_TRAIN_BATCH x
    TRAIN_SEQ: every MoE layer through the einsum engine (16 groups of 256, capacity 64,
    drops); :func:`_bf16_train`."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    if cfg.moe_impl not in ("einsum", "a2a") or MOE_TRAIN_BATCH * TRAIN_SEQ <= 1024:
        raise AssertionError(f"[moe train] {cfg.moe_impl} at {MOE_TRAIN_BATCH} x {TRAIN_SEQ}")
    moe_mod._moe_sort.calls = moe_mod._moe_einsum.calls = 0
    out = _bf16_train(cfg, MOE_TRAIN_BATCH, "[moe train]")
    engines = {"sort": moe_mod._moe_sort.calls, "einsum": moe_mod._moe_einsum.calls}
    log(f"[moe train] engine calls over the phase {engines}")
    if engines["sort"] or not engines["einsum"]:
        raise AssertionError(f"[moe train] engine calls {engines}: the einsum engine alone")
    return out


DEEPSEEK_TRAIN_RESULT = "[deepseek train] launches "  # the process's line of launches and times
# deepseek-v3-671b trains at full width on its 3 first_k_dense layers (MLA and the dense MLP of
# 18,432) plus the MTP module (proj 14,336 x 7,168, two norms, a dense MLA layer): 4,293,743,616
# params, 34.4 GB for params, gradients and bfloat16 m and v. The transformer builds the
# first_k_dense dense layers whatever num_layers says (as the reference's layer_pattern does):
# num_layers=1 gives the same 3 layers, so num_layers is set to 3. A MoE layer of 256 experts
# holds 11.27B params, 90 GB at 8 bytes a param: it trains on no one card.
DEEPSEEK_TRAIN_LAYERS = 3
DEEPSEEK_TRAIN_PARAMS = 4_293_743_616
DEEPSEEK_TRAIN_BATCH = 1  # train_4k's 4096 tokens, its batch cut to one sequence on one card
# The plain-path gate runs on the first 2048 tokens of step 0's batch: at 4096 its float32 run
# holds 17.2 GB of float32 params, as many gradients, and the plain attention's saved scores
# and probabilities ((1, 128, 4096, 512) float32 blocks, ~25 GB a layer) for the MTP layer,
# which runs outside the remat, beside those of a recomputed layer: ~91 GB by count. The steps,
# the replay and the launch gates run at TRAIN_SEQ.
DEEPSEEK_PLAIN_SEQ = 2048


def phase_deepseek_train() -> dict:
    """Run the deepseek train phase in a process of its own (this file with
    ``--deepseek-train``); returns its launch counts, step ms and peak memory."""
    return _in_process(DEEPSEEK_TRAIN_ARG, DEEPSEEK_TRAIN_RESULT, "[deepseek train]")


def _deepseek_train() -> dict:
    """deepseek-v3-671b at full width, its 3 dense MLA layers and the MTP module, in bfloat16
    (remat "full"), 3 AdamW steps with bfloat16 m and v (the reference's memory mode for this
    config, ``repro.launch.dryrun.arch_run_defaults``) on TokenSource batches of
    DEEPSEEK_TRAIN_BATCH x TRAIN_SEQ: the MTP loss, the flash forward (with the lse) and the
    bf16 backward's split build at key head dim 192 and value head dim 128 in every layer
    (the MTP layer's at 4,094 rows); :func:`_bf16_train`. No MoE layer runs: 0 engine calls."""
    from repro_torch.params import count_params

    tag = "[deepseek train]"
    cfg = dataclasses.replace(get_config(DEEPSEEK_ARCH), num_layers=DEEPSEEK_TRAIN_LAYERS)
    if layer_pattern(cfg) != ("dense",) * 3 or not cfg.mtp:
        raise AssertionError(f"{tag} layer pattern {layer_pattern(cfg)}, mtp {cfg.mtp}")
    if count_params(cfg) != DEEPSEEK_TRAIN_PARAMS:
        raise AssertionError(f"{tag} {count_params(cfg)} params, not {DEEPSEEK_TRAIN_PARAMS}")
    moe_mod._moe_sort.calls = moe_mod._moe_einsum.calls = 0
    out = _bf16_train(
        cfg, DEEPSEEK_TRAIN_BATCH, tag, state_dtype="bfloat16", plain_seq=DEEPSEEK_PLAIN_SEQ
    )
    engines = {"sort": moe_mod._moe_sort.calls, "einsum": moe_mod._moe_einsum.calls}
    if any(engines.values()):
        raise AssertionError(f"{tag} MoE engine calls {engines}: no MoE layer runs")
    log(f"{tag} MoE engine calls over the phase {engines}")
    return out


ENCDEC_TRAIN_RESULT = "[encdec train] launches "  # the process's line of launches and times
# seamless-m4t-large-v2 trains at full size (24 encoder and 24 decoder layers, 1,633,931,264
# params) and internvl2-2b at full width and INTERNVL_TRAIN_LAYERS of its 24 layers (all of them:
# 1,895,925,760 params), each on one sequence of the reference's train shape
# (src/repro/configs/shapes.py): seamless 4,096 frames of 1,024 (the stub speech frontend's)
# beside 4,096 tokens, internvl 256 patch embeddings of 1,024 before 3,840 tokens; frames and
# patches N(0, 1) in bfloat16 from _gen, as the serving phases draw them. Cut internvl's depth
# first where the script needs time: its attention is qwen3-1.7b's train shape at batch 1.
SEAMLESS_TRAIN_PARAMS = 1_633_931_264
INTERNVL_TRAIN_LAYERS = 24
INTERNVL_TRAIN_SEQ = 3840
# seamless's ragged steps after its steps 0-2: (label, B, frames, tokens). Their
# cross-attention runs the shapes of ENCDEC_BWD_CASES' last three rows; the first batch is
# also held against the plain path. Speech utterances come in many lengths: a step whose
# frames and tokens are no multiple of the kernels' tiles is what such training runs.
SEAMLESS_RAGGED = (
    ("Sq < Sk", 1, 4000, 1000),
    ("Sq > Sk", 1, 1000, 4000),
    ("ragged", 2, 1000, 37),
)


def phase_encdec_train() -> dict:
    """Run the encdec train phase in a process of its own (this file with
    ``--encdec-train``); returns its launch counts, step ms and peak memory by model."""
    return _in_process(ENCDEC_TRAIN_ARG, ENCDEC_TRAIN_RESULT, "[encdec train]")


def _encdec_train() -> dict:
    """seamless-m4t-large-v2 at full size and internvl2-2b at full width and
    INTERNVL_TRAIN_LAYERS layers, each in bfloat16 (remat "full"), 3 AdamW steps on one
    sequence of the reference's train shape, frames or patches beside TokenSource's tokens:
    :func:`_bf16_train`; seamless then takes one step on each SEAMLESS_RAGGED batch, the first
    held against the plain path as well. The gradients of seamless's cross-attention reach its
    encoder through every decoder layer's ``wk`` and ``wv``; the gate holds the encoder's and
    the frontend's leaves with the rest."""
    tag = "[encdec train]"
    cfg = get_config(SEAMLESS_ARCH)
    if count_params(cfg) != SEAMLESS_TRAIN_PARAMS:
        raise AssertionError(f"{tag} {count_params(cfg)} params, not {SEAMLESS_TRAIN_PARAMS}")
    gen = _gen(13)

    def frames(b, n):
        x = torch.randn(b, n, cfg.frontend_dim, generator=gen, device=DEV)
        return x.to(torch.bfloat16)

    def ragged_batch(b, n_src, n_tok):
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=n_tok, global_batch=b, seed=0)
        toks = torch.from_numpy(TokenSource(data).batch_at(0)["tokens"]).long().to(DEV)
        return {"tokens": toks, "frames": frames(b, n_src)}

    cases = (*ENCDEC_BWD_CASES, FLASH_BWD_BF16_SEAMLESS)
    cross = {
        f"bwd q{c[0], c[1], c[3], c[5]} k{c[0], c[2], c[4]} {'causal' if c[6] else 'no mask'}"
        for c in cases
    }
    ragged = [(label, ragged_batch(*shape)) for label, *shape in SEAMLESS_RAGGED]
    seamless = _bf16_train(
        cfg,
        1,
        f"{tag} seamless",
        seq=TRAIN_SEQ,
        inputs=lambda step: {"frames": frames(1, TRAIN_SEQ)},
        ragged=ragged,
    )
    ran = set(seamless["by_shape"])
    for out in seamless["ragged"].values():
        ran |= set(out["by_shape"])
    if not cross <= ran:
        raise AssertionError(f"{tag} the kernel rows' shapes {sorted(cross - ran)} did not run")
    del ragged
    _release()
    cfg = dataclasses.replace(get_config(INTERNVL_ARCH), num_layers=INTERNVL_TRAIN_LAYERS)
    shape = (1, cfg.num_frontend_tokens, cfg.frontend_dim)
    internvl = _bf16_train(
        cfg,
        1,
        f"{tag} internvl",
        seq=INTERNVL_TRAIN_SEQ,
        inputs=lambda step: {
            "patch_embeds": torch.randn(*shape, generator=gen, device=DEV).to(torch.bfloat16)
        },
    )
    return {"seamless": seamless, "internvl": internvl}


@contextlib.contextmanager
def _routes(out: list):
    """Record, into ``out``, the experts the MoE router picks in each call, in call order
    (the expert ids alone: ``_router_calls``' inputs would hold each layer's rows, 0.8 GB a
    run of granite's train step, where the plain path's step has none to spare)."""
    router = moe_mod._router

    def recording(x_flat, *args):
        weights, idx, aux = router(x_flat, *args)
        out.append(idx.detach().clone())
        return weights, idx, aux

    moe_mod._router = recording
    try:
        yield out
    finally:
        moe_mod._router = router


def _route_changes(a: list, b: list) -> str:
    """Router calls of two runs compared call by call: tokens whose top-k set differs and
    choices (expert slots) that differ, of all."""
    if len(a) != len(b):
        raise AssertionError(f"router calls: {len(a)} against {len(b)}")
    tokens = choices = total = 0
    for x, y in zip(a, b):
        x, y = torch.sort(x, dim=-1).values, torch.sort(y, dim=-1).values
        tokens += int((x != y).any(dim=-1).sum())
        same = (x[:, :, None] == y[:, None, :]).any(-1).sum()
        choices += int(x.numel() - same)
        total += x.numel()
    return f"{tokens} tokens, {choices} of {total} choices"


def _grad_run(model, params, batch):
    (loss, _), grads = value_and_grad(model.loss_fn, params, batch)
    return float(loss), grads


# Step 0 through the kernels against attn_impl="ref" in bfloat16, each quantity within
# DENSE_TRAIN_GAPS times the plain path's own gap between its bfloat16 run and a float32 run
# of the same params: the loss and the grad norm by their difference, each gradient leaf by
# the relative L2 norm of its difference (a max over a leaf is one element's rounding, and in
# bfloat16 the leaves' largest differences reach a quarter of their largest entries). The two
# attention paths round at different places (the kernels round P and dS where they enter a
# product and take Δ from the saved bfloat16 output; the plain path's autograd takes the
# unrounded output), a rounding of the kind and size of the whole model's bfloat16 rounding
# that the gap measures. A missing or misplaced term of the attention's gradient moves a
# leaf by its own norm: the log gives the largest gap, so that the margin can be read.
DENSE_TRAIN_GAPS = 4.0


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix.lstrip("/"), tree)]


def _check_bf16_train_against_plain(
    cfg, model, params, batch, tag, grads_to_host=False
) -> None:
    """Step 0's gradient through the kernels against attn_impl="ref" (plain attention under
    autograd, the same bfloat16 GEMMs), within DENSE_TRAIN_GAPS times the plain path's gap
    between this bfloat16 run and a float32 run of the same params (upcast) on the same
    batch: the loss, the global grad norm and every gradient leaf. With ``grads_to_host``
    both bfloat16 runs' gradients wait in pinned host memory during the float32 run."""
    plain = build(dataclasses.replace(cfg, attn_impl="ref"), DEV)
    routes = {"kernel": [], "plain": [], "float32": []}
    park = _pinned if grads_to_host else (lambda tree: tree)
    torch.cuda.reset_peak_memory_stats()
    with _routes(routes["kernel"]):
        loss, grads = _grad_run(model, params, batch)
        grads = park(grads)
    with _routes(routes["plain"]):
        plain_loss, plain_grads = _grad_run(plain, params, batch)
        plain_grads = park(plain_grads)
    del plain
    _release()
    cfg32 = dataclasses.replace(
        cfg, attn_impl="ref", param_dtype="float32", compute_dtype="float32"
    )
    params32 = tree_map(lambda x: x.float(), params)
    with _routes(routes["float32"]):
        loss32, grads32 = _grad_run(build(cfg32, DEV), params32, batch)
    del params32
    _release()
    if grads_to_host:
        peak32 = torch.cuda.max_memory_allocated()
        grads, plain_grads = (tree_map(lambda x: x.to(DEV), t) for t in (grads, plain_grads))
        log(
            f"{tag} the plain-path gate on {batch['tokens'].shape[1]} tokens, both bfloat16 "
            f"runs' gradients on the host during the float32 run; max_memory_allocated "
            f"{peak32} bytes"
        )
    if routes["kernel"]:  # the MoE router's top-k at step 0: a flip moves an expert's gradient
        log(
            f"{tag} step 0 routing over {len(routes['kernel'])} router calls (each MoE layer "
            f"and its recompute): kernel path vs plain path "
            f"{_route_changes(routes['kernel'], routes['plain'])} differ; plain path vs float32 "
            f"{_route_changes(routes['plain'], routes['float32'])}; kernel path vs float32 "
            f"{_route_changes(routes['kernel'], routes['float32'])}"
        )
    del routes

    def gnorm(tree):
        return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree))).item()

    def rel_l2(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    gn, plain_gn, gn32 = gnorm(grads), gnorm(plain_grads), gnorm(grads32)
    rows = [("loss", abs(loss - plain_loss), abs(plain_loss - loss32))]
    rows.append(("grad_norm", abs(gn - plain_gn), abs(plain_gn - gn32)))
    own = [abs(loss - loss32) / max(rows[0][2], 1e-30), abs(gn - gn32) / max(rows[1][2], 1e-30)]
    named = zip(
        _named_leaves(grads), tree_leaves(plain_grads), tree_leaves(grads32), strict=True
    )
    widest, widest_abs = ("", 0.0), ("", 0.0)  # the largest relative L2 gap; max-abs gap
    for (name, g), p, w in named:
        rows.append((name, rel_l2(g, p), rel_l2(p, w)))
        own.append(rel_l2(g, w) / max(rows[-1][2], 1e-30))
        if rows[-1][2] > widest[1]:
            widest = (name, rows[-1][2])
        share = ((p.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        if share > widest_abs[1]:
            widest_abs = (name, share)
    worst, worst_ratio = "", 0.0
    for name, err, gap in rows:
        ratio = err / gap if gap > 0 else float("inf")
        if ratio > worst_ratio:
            worst, worst_ratio = name, ratio
        if err > DENSE_TRAIN_GAPS * gap:
            raise AssertionError(
                f"{tag} step 0 kernel path vs attn_impl='ref': {name} {err:.3e} > "
                f"{DENSE_TRAIN_GAPS} x the bfloat16-vs-float32 gap {gap:.3e}"
            )
    log(
        f"{tag} step 0 kernel path vs attn_impl='ref' (both bfloat16), each within "
        f"{DENSE_TRAIN_GAPS} x the plain path's bfloat16-vs-float32 gap: loss {loss:.6f} vs "
        f"{plain_loss:.6f} (|diff| {rows[0][1]:.3e}, gap {rows[0][2]:.3e}; float32 "
        f"{loss32:.6f}), grad_norm {gn:.6f} vs {plain_gn:.6f} (|diff| {rows[1][1]:.3e}, gap "
        f"{rows[1][2]:.3e}; float32 {gn32:.6f}), {len(rows) - 2} gradient leaves by relative "
        "L2 norm; the kernel path's own gap to float32 over the plain path's: median "
        f"{sorted(own)[len(own) // 2]:.3f}, largest {max(own):.3f} "
        f"({rows[own.index(max(own))][0]}); the largest "
        f"diff/gap {worst_ratio:.3f} ({worst}); the largest gap {widest[1]:.3e} ({widest[0]}); "
        f"by max |.| the largest gap is {widest_abs[1]:.3e} of its leaf's largest entry "
        f"({widest_abs[0]})"
    )


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _kernel_entry(name, source, replaces, launches, row, shape):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        **{k: row[k] for k in keys},
        "shape": shape,
    }


def _timed(name, phase):
    """Run one phase, log its wall time and give its memory back to the card."""
    t0 = time.monotonic()
    out = phase()
    _release()
    log(f"[time] {name}: {time.monotonic() - t0:.1f} s")
    return out


def main() -> int:
    t_start = time.monotonic()
    smi = phase_device()
    _timed("build", phase_build)
    kernel_rows = _timed("kernels", phase_kernels)
    flash_rows, demo_err, bwd_rows, decode_rows, rglru_rows, wkv6_rows = kernel_rows
    demo = _timed("demo", phase_demo)
    _timed("gateway", lambda: phase_gateway(demo.pop("serving")))
    train = _timed("train", phase_train)
    _timed("durable", lambda: phase_durable(train))
    _timed("distributed", lambda: phase_distributed(train))
    hybrid = _timed("hybrid", phase_hybrid)
    exact = _timed("exactness", phase_exactness)
    rwkv_launches = _timed("rwkv", phase_rwkv)
    _timed("rwkv exactness", phase_rwkv_exactness)
    _timed("dense", phase_dense)
    moe = _timed("moe", phase_moe)
    deepseek = _timed("deepseek", phase_deepseek)
    seamless = _timed("seamless", phase_seamless)
    internvl = _timed("internvl", phase_internvl)
    dense_train = _timed("dense train", phase_dense_train)
    dense_durable = _timed("dense durable", lambda: phase_dense_durable(dense_train, smi))
    hybrid_train = _timed("hybrid train", phase_hybrid_train)
    rwkv_train = _timed("rwkv train", phase_rwkv_train)
    moe_train = _timed("moe train", phase_moe_train)
    deepseek_train = _timed("deepseek train", phase_deepseek_train)
    encdec_train = _timed("encdec train", phase_encdec_train)

    flash_src = "src/repro_torch/kernels/csrc/flash_attention_fwd.cu"
    flash_tpu = "src/repro/kernels/flash_attention.py:39"
    bwd_bf16_src = "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu"
    bwd_tpu = "src/repro/kernels/flash_attention.py:139"
    seamless_train, internvl_train = encdec_train["seamless"], encdec_train["internvl"]

    def by_shape(out, which, case):
        """A train phase's launches of ``which`` at ``case``'s shape and mask."""
        b, hq, hkv, sq, sk, d, causal = case[:7]
        mask = "causal" if causal else "no mask"
        return out["by_shape"].get(f"{which} q{b, hq, sq, d} k{b, hkv, sk} {mask}", 0)

    # internvl2-2b's 256 patches and 3,840 tokens run qwen3-1.7b's train shape at batch 1
    internvl_case = (1,) + FLASH_BWD_BF16_TRAIN[1:]
    internvl_shape = {w: by_shape(internvl_train, w, internvl_case) for w in ("fwd", "bwd")}
    if internvl_shape != {"fwd": internvl_train["flash"], "bwd": internvl_train["flash_bwd"]}:
        raise AssertionError(
            f"[encdec train] internvl's launches {internvl_shape} at {internvl_case}"
        )
    ragged = dict(zip(ENCDEC_BWD_CASES[1:], seamless_train["ragged"].values()))
    demo_row = dict(flash_rows[("demo", JSON_SEQ)], max_abs_err=demo_err)
    kernels = [
        _kernel_entry(
            "flash_attention_fwd",
            flash_src,
            flash_tpu,
            demo["flash"],
            demo_row,
            f"q(1,12,{JSON_SEQ},64) k,v(1,4,{JSON_SEQ},64) float32 causal",
        ),
        _kernel_entry(
            "flash_attention_fwd_train",
            flash_src,
            flash_tpu,
            train["flash"],
            bwd_rows["fwd"],
            "q(4,12,4096,64) k,v(4,4,4096,64) float32 causal, with the logsumexp",
        ),
        _kernel_entry(
            "flash_attention_bwd",
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:139",
            train["flash_bwd"],
            bwd_rows["bwd"],
            "q,dO(4,12,4096,64) k,v(4,4,4096,64) float32 causal",
        ),
        _kernel_entry(
            "flash_attention_fwd_bf16_train",
            flash_src,
            flash_tpu,
            dense_train["flash"] + dense_durable["flash_attention_fwd"] + internvl_shape["fwd"],
            bwd_rows["bf16"]["fwd"],
            "q(2,16,4096,128) k,v(2,8,4096,128) bfloat16 causal, with the logsumexp; launches "
            "of the dense train and dense durable phases and internvl2-2b's in the encdec train "
            "phase (the same shape at batch 1)",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16",
            bwd_bf16_src,
            bwd_tpu,
            dense_train["flash_bwd"] + dense_durable["flash_attention_bwd"] + internvl_shape["bwd"],
            bwd_rows["bf16"]["bwd"],
            "q,dO(2,16,4096,128) k,v(2,8,4096,128) bfloat16 causal; flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[:2])
            + "; launches of the dense train and dense durable phases and internvl2-2b's in the "
            "encdec train phase (the same shape at batch 1)",
        ),
        _kernel_entry(
            "flash_attention_fwd_bf16_encdec_train",
            flash_src,
            flash_tpu,
            by_shape(seamless_train, "fwd", ENCDEC_BWD_JSON),
            bwd_rows["encdec"]["fwd"],
            "q,k,v(1,16,4096,64) bfloat16, no mask, with the logsumexp (seamless-m4t-large-v2's "
            "encoder and cross-attention at its train shape; library: SDPA "
            f"{bwd_rows['encdec']['fwd']['library_backend']}, as dispatched); launches of the "
            "encdec train phase's steps at that shape",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16_encdec",
            bwd_bf16_src,
            bwd_tpu,
            by_shape(seamless_train, "bwd", ENCDEC_BWD_JSON),
            bwd_rows["encdec"][ENCDEC_BWD_JSON],
            "q,k,v,dO(1,16,4096,64) bfloat16, no mask (seamless-m4t-large-v2's encoder and "
            "cross-attention at its train shape, group 1); flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[:2])
            + f"; library: SDPA's backward as dispatched "
            f"({bwd_rows['encdec'][ENCDEC_BWD_JSON]['library_backend']}); launches of the encdec "
            "train phase's steps at that shape",
        ),
        _kernel_entry(
            "flash_attention_fwd_bf16_seamless_self_train",
            flash_src,
            flash_tpu,
            by_shape(seamless_train, "fwd", FLASH_BWD_BF16_SEAMLESS),
            bwd_rows["bf16"]["seamless"]["fwd"],
            "q,k,v(1,16,4096,64) bfloat16 causal, with the logsumexp (seamless-m4t-large-v2's "
            "decoder self-attention at its train shape; library: SDPA flash backend); launches "
            "of the encdec train phase's steps at that shape",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16_seamless_self",
            bwd_bf16_src,
            bwd_tpu,
            by_shape(seamless_train, "bwd", FLASH_BWD_BF16_SEAMLESS),
            bwd_rows["bf16"]["seamless"]["bwd"],
            "q,k,v,dO(1,16,4096,64) bfloat16 causal (seamless-m4t-large-v2's decoder "
            "self-attention at its train shape, group 1); flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[:2])
            + "; library: SDPA flash backend's backward; launches of the encdec train phase's "
            "steps at that shape",
        ),
        *(
            _kernel_entry(
                f"flash_attention_bwd_bf16_cross_{name}",
                bwd_bf16_src,
                bwd_tpu,
                by_shape(out, "bwd", case),
                bwd_rows["encdec"][case],
                f"q,dO({case[0]},16,{case[3]},64) k,v({case[0]},16,{case[4]},64) bfloat16, no mask "
                f"(seamless-m4t-large-v2's cross-attention, {case[3]} tokens against {case[4]} "
                f"frames; library: SDPA's backward as dispatched, "
                f"{bwd_rows['encdec'][case]['library_backend']}); launches of the encdec train "
                f"phase's step {label!r}",
            )
            for (case, out), name, (label, *_) in zip(
                ragged.items(), ("short", "long", "ragged"), SEAMLESS_RAGGED
            )
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16_hd256",
            "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
            "src/repro/kernels/flash_attention.py:139",
            hybrid_train["flash_bwd"],
            bwd_rows["bf16_hd256"],
            "q,dO(1,16,4096,256) k,v(1,1,4096,256) bfloat16 causal window 2048; the split "
            "builds: flash_bwd_bf16_delta_kernel, "
            + ", ".join((*BF16_WGMMA_KERNELS[2:], BF16_REDUCE_KERNEL))
            + f" ({_hd256_parts(FLASH_BWD_HD256_TRAIN)} parts a key tile)",
        ),
        _kernel_entry(
            "rglru_bwd",
            "src/repro_torch/kernels/csrc/rglru_bwd.cu",
            "src/repro/kernels/rglru.py:29 (its gradient: jax.grad through "
            "src/repro/kernels/ref.py:227 rglru_scan_ref)",
            hybrid_train["rglru_bwd"],
            rglru_rows["bwd"],
            "x,dh(1,4096,4096) bfloat16, a float32, no h0; " + ", ".join(RGLRU_BWD_KERNELS),
        ),
        _kernel_entry(
            "flash_attention_fwd_hd256",
            flash_src,
            flash_tpu,
            hybrid["flash"],
            flash_rows[HYBRID_FLASH_JSON],
            "q(1,16,3000,256) k,v(1,1,3000,256) bfloat16 causal window 2048",
        ),
        _kernel_entry(
            "flash_attention_fwd_f32_hd256",
            flash_src,
            flash_tpu,
            exact["flash"],
            flash_rows[HYBRID_FLASH_F32_JSON],
            "q(1,16,3000,256) k,v(1,1,3000,256) float32 causal window 2048",
        ),
        _kernel_entry(
            "decode_attention",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "none: src/repro/models/attention.py:107 (cached decode in plain jnp)",
            demo["decode_attention"],
            decode_rows[DECODE_DEMO_JSON],
            "q(4,12,64) k,v cache(4,1536,4,64) float32, positions (1031,5,1535,1600)",
        ),
        _kernel_entry(
            "flash_attention_fwd_granite",
            flash_src,
            flash_tpu,
            moe["flash"],
            flash_rows[GRANITE_FLASH_JSON],
            "q(1,24,1711,64) k,v(1,8,1711,64) bfloat16 causal (granite-moe-3b-a800m's longest "
            "prompt; library: SDPA flash, K/V expanded)",
        ),
        _kernel_entry(
            "flash_attention_fwd_mla",
            flash_src,
            flash_tpu,
            deepseek["flash"],
            flash_rows[MLA_FLASH_JSON],
            "q,k(1,128,1711,192) v(1,128,1711,128) bfloat16 causal, scale 192^-0.5 "
            "(deepseek-v3-671b's MLA prefill at its longest prompt, the DC = 4 build; library: "
            f"SDPA {flash_rows[MLA_FLASH_JSON]['library_backend']}, as dispatched)",
        ),
        _kernel_entry(
            "flash_attention_fwd_encoder",
            flash_src,
            flash_tpu,
            seamless["flash_encoder"],
            flash_rows[ENCODER_FLASH_JSON],
            "q,k,v(4,16,4096,64) bfloat16, no mask (seamless-m4t-large-v2's encoder at its "
            "batch-4 prefill; library: SDPA "
            f"{flash_rows[ENCODER_FLASH_JSON]['library_backend']}, as dispatched); launches of "
            "the seamless phase's encoder",
        ),
        _kernel_entry(
            "flash_attention_fwd_cross_prefill",
            flash_src,
            flash_tpu,
            seamless["flash_cross_prefill"],
            flash_rows[CROSS_PREFILL_JSON],
            "q(1,16,37,64) k,v(1,16,1000,64) bfloat16, no mask (seamless-m4t-large-v2's "
            "cross-attention in the prefill of its 37-token request against 1,000 frames; "
            f"library: SDPA {flash_rows[CROSS_PREFILL_JSON]['library_backend']}, as dispatched); "
            "launches of the seamless phase's prefills' cross-attention",
        ),
        _kernel_entry(
            "flash_attention_fwd_cross_decode",
            flash_src,
            flash_tpu,
            seamless["flash_cross_decode"],
            flash_rows[CROSS_DECODE_JSON],
            "q(4,16,1,64) k,v(4,16,4096,64) bfloat16, no mask (seamless-m4t-large-v2's "
            "cross-attention in a batch-4 decode step; library: SDPA "
            f"{flash_rows[CROSS_DECODE_JSON]['library_backend']}, as dispatched); launches of the "
            "seamless phase's decode steps",
        ),
        _kernel_entry(
            "flash_attention_fwd_seamless_self",
            flash_src,
            flash_tpu,
            seamless["flash_self"],
            flash_rows[SEAMLESS_SELF_FLASH_JSON],
            "q,k,v(1,16,37,64) bfloat16 causal (seamless-m4t-large-v2's decoder self-attention "
            "in the prefill of its 37-token request); launches of the seamless phase's prefills' "
            "self-attention",
        ),
        _kernel_entry(
            "decode_attention_seamless",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "none: src/repro/models/attention.py:107 (cached decode in plain jnp)",
            seamless["decode_attention"],
            decode_rows[DECODE_SEAMLESS_JSON],
            "q(4,16,64) k,v cache(4,36,16,64) bfloat16, positions (35,35,35,35) "
            "(seamless-m4t-large-v2's last decode step at batch 4); launches of the seamless phase",
        ),
        _kernel_entry(
            "flash_attention_fwd_internvl",
            flash_src,
            flash_tpu,
            internvl["flash"],
            flash_rows[INTERNVL_FLASH_JSON],
            "q(1,16,769,128) k,v(1,8,769,128) bfloat16 causal (internvl2-2b's prefill of 256 "
            "patches and its longest prompt, 513 tokens); launches of the internvl phase",
        ),
        _kernel_entry(
            "decode_attention_internvl",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "none: src/repro/models/attention.py:107 (cached decode in plain jnp)",
            internvl["decode_attention"],
            decode_rows[DECODE_INTERNVL_JSON],
            "q(1,16,128) k,v cache(1,801,8,128) bfloat16, position 800 (internvl2-2b's last "
            "decode step of its longest request); launches of the internvl phase",
        ),
        _kernel_entry(
            "flash_attention_fwd_bf16_granite_train",
            flash_src,
            flash_tpu,
            moe_train["flash"],
            bwd_rows["bf16"]["granite"]["fwd"],
            "q(1,24,4096,64) k,v(1,8,4096,64) bfloat16 causal, with the logsumexp "
            "(granite-moe-3b-a800m's train shape); launches of the moe train phase",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16_granite",
            "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
            "src/repro/kernels/flash_attention.py:139",
            moe_train["flash_bwd"],
            bwd_rows["bf16"]["granite"]["bwd"],
            "q,dO(1,24,4096,64) k,v(1,8,4096,64) bfloat16 causal (GQA group 3); "
            "flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[:2])
            + "; launches of the moe train phase",
        ),
        _kernel_entry(
            "flash_attention_fwd_bf16_mla_train",
            flash_src,
            flash_tpu,
            deepseek_train["flash"],
            bwd_rows["mla_train"]["fwd"],
            "q,k(1,128,4096,192) v(1,128,4096,128) bfloat16 causal, scale 192^-0.5, with the "
            "logsumexp (deepseek-v3-671b's train shape, the DC = 4 build; library: SDPA as "
            "dispatched); launches of the deepseek train phase (the MTP layer's at 4094 rows)",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16_mla",
            "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
            "src/repro/kernels/flash_attention.py:139",
            deepseek_train["flash_bwd"],
            bwd_rows["mla_train"]["bwd"],
            "q,k(1,128,4096,192) v,dO(1,128,4096,128) bfloat16 causal, scale 192^-0.5 "
            "(deepseek-v3-671b's train shape, group 1); the split build <4, 2> at one part a key "
            "tile: flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[2:])
            + "; plain: ref.flash_attention_bwd_split_ref; library: SDPA's backward as "
            "dispatched; launches of the deepseek train phase",
        ),
        _kernel_entry(
            "decode_attention_granite",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "none: src/repro/models/attention.py:107 (cached decode in plain jnp)",
            moe["decode_attention"],
            decode_rows[DECODE_GRANITE_JSON],
            "q(4,24,64) k,v cache(4,2048,8,64) bfloat16, positions (1742,1031,5,2047)",
        ),
        _kernel_entry(
            "decode_attention_hd256",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "none: src/repro/models/attention.py:107 (cached decode in plain jnp)",
            hybrid["decode_attention"],
            decode_rows[DECODE_JSON],
            "q(4,16,256) k,v ring cache(4,2048,1,256) bfloat16, positions (2250,100,2047,4000)",
        ),
        _kernel_entry(
            "rglru_scan",
            "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru.py:29",
            hybrid["rglru"],
            rglru_rows[RGLRU_JSON],
            "x(1,3000,4096) bfloat16, a float32, h0 (1,4096) float32",
        ),
        _kernel_entry(
            "wkv6_chunked",
            "src/repro_torch/kernels/csrc/wkv6.cu",
            "src/repro/kernels/rwkv6.py:32",
            rwkv_launches + rwkv_train["wkv6"],
            wkv6_rows[WKV_JSON],
            "r,k,v(1,64,3000,64) bfloat16 in (B,T,H,K) layout, w float32, h0 (1,64,64,64) "
            "float32; launches of the rwkv serving and train phases",
        ),
        _kernel_entry(
            "wkv6_bwd",
            "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
            "src/repro/kernels/rwkv6.py:32 (its gradient: jax.grad through "
            "src/repro/kernels/ref.py:145 wkv6_chunked_ref)",
            rwkv_train["wkv6_bwd"],
            wkv6_rows["bwd"],
            "r,k,v,dout(1,64,4096,64) bfloat16 in (B,T,H,K) layout, w float32, no h0, no dS_T; "
            + ", ".join(WKV6_BWD_KERNELS),
        ),
    ]
    log(f"[done] every phase passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [TRAIN_ARG]:
        sys.exit(_process_main(TRAIN_RESULT, _train))
    if sys.argv[1:] == [DENSE_TRAIN_ARG]:
        sys.exit(_process_main(DENSE_TRAIN_RESULT, _dense_train))
    if sys.argv[1:] == [HYBRID_TRAIN_ARG]:
        sys.exit(_process_main(HYBRID_TRAIN_RESULT, _hybrid_train))
    if sys.argv[1:] == [RWKV_TRAIN_ARG]:
        sys.exit(_process_main(RWKV_TRAIN_RESULT, _rwkv_train))
    if sys.argv[1:] == [MOE_TRAIN_ARG]:
        sys.exit(_process_main(MOE_TRAIN_RESULT, _moe_train))
    if sys.argv[1:] == [DEEPSEEK_TRAIN_ARG]:
        sys.exit(_process_main(DEEPSEEK_TRAIN_RESULT, _deepseek_train))
    if sys.argv[1:] == [ENCDEC_TRAIN_ARG]:
        sys.exit(_process_main(ENCDEC_TRAIN_RESULT, _encdec_train))
    sys.exit(dist_main() if sys.argv[1:] == [DIST_ARG] else main())
