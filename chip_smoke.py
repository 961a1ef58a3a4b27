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
   Sq < Sk, window 1), on float32 cases of the 3xTF32 path (head dims 16
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
   cases of ``tests/test_torch_flash_bwd_bf16.py``, edges and qwen3-1.7b's
   train shape (2, 16, 4096, 128) at BWD_BF16_TOL of each gradient's largest
   entry, each case holding the bfloat16 forward's logsumexp against the plain
   one and its output bits unchanged by asking for it; its bits equal on two
   launches and for B = 1 against row 0 of B = 4; at the train shape its time
   against its plain version, SDPA's flash-backend backward and its bound, and
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
   yardstick. The RG-LRU backward
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
   shapes are among the flash and decode-attention cases. Each timed case
   prints the kernel's time, its plain version's, one PyTorch library call's
   where one computes the same function, and the least time the card could
   take;
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
   the HTTP bodies of one ``generate`` through w0's ``run_task``; a trace
   of round 1 (8 at once and r0 alone at 8 new tokens: a sampler of where
   the handler threads stand, and under torch.profiler recording every
   thread the device's busy share and the threads' time in ATen ops, in
   ``.item()`` syncs and outside ops); every round logs the process's cores
   busy;
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
   the heartbeat's report;
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
   and ``apply@0`` digests. Three one-step graphs follow (warm, host timers,
   ``torch.profiler``). Logs each step's seconds through the trainer beside the
   train phase's direct step (tokens/s), peak memory, the host's seconds in
   ``payload_digest``, in copies between the card and the host and in the fold
   (timers the phase puts around those calls), the device's busy share and
   each save's seconds;
6. hybrid: ``recurrentgemma-9b`` at full width and depth (38 layers,
   10.4B params, bfloat16) serves 8 requests of prompts on both sides of
   its 2048 window through ``ContinuousBatcher(slots=4, max_len=3072)``;
   the flash kernel ran in the 12 attention layers of every prefill, the
   decode-attention kernel in them at every decode step, and the RG-LRU
   kernel in the 26 recurrent layers of every prefill and decode step;
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
8. rwkv: ``rwkv6-7b`` at full width and depth (32 layers, 7.66B params,
   bfloat16) serves 8 requests (prompts up to 3000 tokens, one shorter than
   a WKV chunk) through ``ContinuousBatcher(slots=4, max_len=3072)``; the
   WKV6 kernel ran in the 32 layers of every prefill and decode step and no
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
   ``stablelm-1.6b``, ``yi-6b`` at full depth; ``qwen1.5-110b`` at 4 of its 80
   layers, as 222.4 GB of weights do not fit the card), one after the other,
   each serving 8 requests of 32 new tokens (prompts 64-1000 tokens, seed 0)
   through ``ContinuousBatcher(slots=4, max_len=1536)``: the flash kernel
   launched once per layer per prefill and the decode kernel once per layer
   per decode step; each request's logits equal a teacher-forced run at the
   batcher's width bit for bit and agree at batch 1 within LOGIT_TOL_BF16;
   tok/s, prefill and decode times, peak memory and a profiled decode window's
   busy share; then one full-width layer of a float32 copy on the card against
   the port's CPU path within 1e-4 on a (1, 777, d) input (with the tied
   unembed for qwen3-1.7b);
10b. moe: ``granite-moe-3b-a800m`` at full width and depth (32 MoE layers of
   40 experts, top 8; 3.30B params, bfloat16) serves 8 requests of 32 new
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
   own bfloat16-against-float32 gap;
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
   set up as ``--hybrid-train``): ``rwkv6-7b`` at full width, layers 0-7, in
   bfloat16 with remat "full", the same 3 AdamW steps on batches of 1 x 4096
   and the same gates: step 0 replayed with equal bits, every step launching
   the WKV6 chunk forward 2 x 8 times and its backward 8 times; step ms,
   tokens/s, peak memory and a profiled step (WKV6 forward and backward,
   GEMMs, elementwise, optimizer); step 0 against attn_impl="ref" (autograd
   through the plain chunked WKV6) within DENSE_TRAIN_GAPS times the plain
   path's bf16-vs-f32 gap;
14. the JSON line of kernels, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.

Every model is freed before the next is built. It imports the port
(``src/repro_torch``) and never JAX or the JAX package. Without a CUDA card,
or outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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
_TRAIN_ARGS = (TRAIN_ARG, DIST_ARG, DENSE_TRAIN_ARG, HYBRID_TRAIN_ARG, RWKV_TRAIN_ARG)
if sys.argv[1:] in ([arg] for arg in _TRAIN_ARGS):
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
if sys.argv[1:] in ([HYBRID_TRAIN_ARG], [RWKV_TRAIN_ARG]):
    # two copies of params, m and v (the out-of-place step) fill ~75 GB of the card: blocks
    # that grow in place keep the allocator's free pieces from splitting it further
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
import repro_torch.core.executor as executor_mod  # noqa: E402
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
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.layers import apply_norm, dense, softcap  # noqa: E402
from repro_torch.models.model import unembed_logits  # noqa: E402
from repro_torch.models.transformer import apply_layer, layer_pattern, run_stack  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    tree_leaves,
    tree_map,
)
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serve import ContinuousBatcher  # noqa: E402
from repro_torch.serve.batcher import _splice_cache  # noqa: E402
from repro_torch.train import (  # noqa: E402
    DistributedTrainer,
    DistTrainConfig,
    make_opt_init,
    make_train_step,
)
from repro_torch.train.steps import value_and_grad  # noqa: E402
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
DECODE_TIMED = (DECODE_DEMO_JSON, DECODE_JSON, DECODE_GRANITE_JSON)
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
# window 1, one query row.
DENSE_TRAIN_BATCH = 2
FLASH_BWD_BF16_TRAIN = (
    DENSE_TRAIN_BATCH, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, None, "bfloat16", 128
)
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
    FLASH_BWD_BF16_TRAIN,
]
# The bfloat16 backward against its plain version (float32 throughout, the gradients rounded
# once): the kernels round P and dS to bfloat16 where they enter a product, and the CPU model
# of that rounding in tests/test_torch_flash_bwd_bf16.py stays within 41% of 2^-6 of each
# gradient's largest entry. Held at 2^-6 of each gradient's largest entry, as there.
BWD_BF16_TOL = 2.0**-6
# The bfloat16 forward's logsumexp against the plain one: both float32 over the same
# bfloat16 products (sums in other orders, exp2 against exp): 1e-4, rtol = atol.
LSE_BF16_TOL = 1e-4
# the bfloat16 backward's same bits on two launches and for B = 1 against row 0 of B = 4
FLASH_BWD_BF16_DETERMINISM = (4, 16, 8, 1024, 1024, 128, True, None, "bfloat16", 128)
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
    """Flash kernel vs plain on every case; times at the demo and hybrid shapes."""
    cases = [c + (c[5],) for c in FLASH_CASES]  # Dv = D
    cases.append((1, 2, 2, 64, 64, 48, True, None, "float32", 32))  # MLA head dims
    cases += EDGE_CASES + BF16_CASES + F32_CASES
    cases += [(1, 12, 4, s, s, 64, True, None, "float32", 64) for s in DEMO_SEQ]
    cases += HYBRID_FLASH + [GRANITE_FLASH_JSON]
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
        if not demo and case not in HYBRID_FLASH and case != GRANITE_FLASH_JSON:
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
    """q, k, v, dO on the card in the case's dtype, and the plain forward's output and
    logsumexp on them."""
    b, hq, hkv, sq, sk, d, causal, window, dt, dv = case
    dtype = getattr(torch, dt)
    q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype)
    dout = torch.randn(b, hq, sq, dv, generator=gen, device=DEV).to(dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
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
        got_out, got_lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
        same = torch.equal(got_out, fa.flash_attention_fwd(q, k, v, **masks))
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
    """The bfloat16 backward against its plain version on every case (the plain forward's
    output and logsumexp as inputs), at BWD_BF16_TOL of each gradient's largest entry; each
    case also holds the bfloat16 forward's logsumexp against the plain one and its output
    with the logsumexp equal bit for bit to its output without. At qwen3-1.7b's train shape:
    the times and the float64 yardstick. Returns the rows of the kernels line."""
    rows = {}
    for case in FLASH_BWD_BF16_CASES:
        q, k, v, dout, err, out_err = _flash_bwd_bf16_case(gen, case)
        if case == FLASH_BWD_BF16_TRAIN:
            rows = _flash_bwd_bf16_timed(case, q, k, v, dout, err, out_err)
    _flash_bwd_determinism(gen, FLASH_BWD_BF16_DETERMINISM)
    rows["f32_hd128"] = _flash_bwd_f32_hd128(gen)
    return rows


def _flash_bwd_bf16_case(gen, case):
    """One bfloat16 backward case against its plain version at BWD_BF16_TOL, with the
    forward's logsumexp against the plain one and its output unchanged by asking for it;
    returns q, k, v, dout, the gradients' max |err| and the output's."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    q, k, v, dout, out, lse = _flash_bwd_inputs(gen, case)
    masks = dict(causal=causal, window=window)
    got_out, got_lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
    same = torch.equal(got_out, fa.flash_attention_fwd(q, k, v, **masks))
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
    torch.cuda.synchronize()
    label = f"flash_attention_bwd q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} " + (
        f"bfloat16 causal={causal} window={window} ({fa.bwd_path(d, dv, q.dtype)} path)"
    )
    if not same:
        raise AssertionError(f"[kernels] {label}: the bfloat16 forward's output moved with lse")
    if any(g.dtype != torch.bfloat16 for g in grads):
        raise AssertionError(f"[kernels] {label}: gradients {[g.dtype for g in grads]}")
    out_err = _check(f"{label} out", got_out, out, TOL["bfloat16"])
    lse_err = _check(f"{label} lse", got_lse, lse, LSE_BF16_TOL)
    lse_used = _tol_used(got_lse, lse, LSE_BF16_TOL)
    shares = [_share_of_largest(g, w, BWD_BF16_TOL) for g, w in zip(grads, want)]
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
    finite = all(torch.isfinite(g.float()).all() for g in grads)
    if not finite or max(shares) > 1.0:
        raise AssertionError(
            f"[kernels] {label}: max |err| {errs}, {[f'{100 * x:.1f}%' for x in shares]} "
            f"of {BWD_BF16_TOL} x each gradient's largest entry"
        )
    log(
        f"[kernels] {label}: max |err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
        f"{100 * max(shares):.1f}% of the tolerance ({BWD_BF16_TOL:.4g} x each gradient's "
        f"largest entry); forward out max |err| {out_err:.3e} (tol {TOL['bfloat16']}), lse "
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
    """recurrentgemma-9b's train shape: the backward (on the kernel forward's output and
    logsumexp) against its plain version, SDPA's backward with the window as a boolean mask
    (K and V expanded; the backend its dispatcher picks, named) and the bound; each launch's
    device time; the float64 yardstick."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    masks = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)

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


def _flash_bwd_bf16_timed(case, q, k, v, dout, err, out_err):
    """qwen3-1.7b's train shape: the bfloat16 forward with and without its logsumexp; the
    backward (on the kernel forward's output and logsumexp, as training runs it) against its
    plain version, SDPA's flash-backend backward and the bound; then the float64 yardstick:
    the kernel's and SDPA's errors against float64 autograd of the dense oracle on batch row
    0's first KV group, the kernel held to twice SDPA's."""
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    masks = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)

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
    log(
        f"[kernels]   qwen3-1.7b train shape q{tuple(q.shape)} bfloat16: backward kernel_ms "
        f"{bwd['ms']:.4f} (device {bwd['device_us']:.2f} us a call: {parts}), plain_ms "
        f"{bwd['plain_ms']:.4f}, library_ms (SDPA flash backend backward alone, K/V expanded "
        f"to {hq} heads) {bwd['library_ms']:.4f} (kernel "
        f"{'faster' if bwd['ms'] < bwd['library_ms'] else 'NOT faster'}), bound_ms "
        f"{bound:.5f} ({bound_by}, bf16 tensor cores: 5 products at 989 TFLOP/s), "
        f"kernel/bound {bwd['ms'] / bound:.1f}; the mma.sync kernel it replaced "
        f"{BWD_BF16_MMA_SYNC_MS} ms, {BWD_BF16_MMA_SYNC_MS / bwd['ms']:.2f}x this one's"
    )
    log(
        f"[kernels]   qwen3-1.7b train shape forward (bfloat16, wgmma): with lse "
        f"{fwd['ms']:.4f} ms, without {fwd['ms_without_lse']:.4f} ms; plain_ms "
        f"{fwd['plain_ms']:.4f}, library_ms (SDPA flash backend, K/V expanded) "
        f"{fwd['library_ms']:.4f}, bound_ms {fwd_bound:.5f} ({fwd_bound_by})"
    )
    _flash_bwd_bf16_yardstick(q, k, v, dout, out, lse, sdpa, masks)
    return {"bwd": bwd, "fwd": fwd}


def _sdpa_bwd(q, k, v, dout, backend, mask=None):
    """SDPA on ``backend`` (the dispatcher's choice for None; causal, or the boolean ``mask``;
    K and V expanded to q's heads beforehand): its forward, its backward alone (the forward
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
                qx, kx, vx, attn_mask=mask, is_causal=mask is None, scale=scale
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
    o64 = ref.flash_attention_dense_ref(*x64, **masks)
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
    return flash_rows, demo_err, bwd_rows, decode_rows, rglru_rows, wkv6_rows


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


GATEWAY_TRACE_TOKENS = 8  # new tokens a request in the rounds that trace round 1's host time
GATEWAY_SAMPLE_S = 0.002  # the stack sampler's period
SYNC_OP = "aten::_local_scalar_dense"  # the copy and stream sync under int(tok[0])


def _stack_site(frame):
    """Where a thread inside a ``generate`` task stands: its innermost frame and the innermost
    frame of the port's own code, or None for a thread outside a task."""
    port, f = None, frame
    while f is not None:
        code = f.f_code
        if port is None and "repro_torch" in code.co_filename:
            port = f"{Path(code.co_filename).name}:{f.f_lineno} {code.co_name}"
        if code.co_name == "generate" and code.co_filename.endswith("gateway_serve.py"):
            inner = frame.f_code
            site = f"{Path(inner.co_filename).name}:{frame.f_lineno} {inner.co_name}"
            return site if site == port else f"{site} <- {port}"
        f = f.f_back
    return None


def _sampled_round(tag, gw, cfg, prompts, want) -> None:
    """A round with a thread that takes every handler thread's stack each
    ``GATEWAY_SAMPLE_S``. A sample is taken with the interpreter lock held, so every handler
    thread stands where it last gave the lock up: inside a call that releases it (a sync, a
    ctypes launch, a lock) or at a forced switch in its Python."""
    sites, stop = collections.Counter(), threading.Event()

    def sample():
        while not stop.wait(GATEWAY_SAMPLE_S):
            for tid, frame in sys._current_frames().items():
                site = _stack_site(frame) if tid != threading.get_ident() else None
                if site is not None:
                    sites[site] += 1

    sampler = threading.Thread(target=sample, name="stack-sampler")
    sampler.start()
    try:
        _gateway_round(tag, gw, cfg, prompts, want, GATEWAY_TRACE_TOKENS)
    finally:
        stop.set()
        sampler.join()
    total = sum(sites.values())
    top = "; ".join(
        f"{site} {n} ({100 * n / total:.1f}%)" for site, n in sites.most_common(10)
    )
    log(f"[gateway] {tag}: {total} thread samples in generate tasks; where they stood: {top}")


def _thread_breakdown(prof):
    """For each thread that ran ``.item()`` syncs (the handler threads): (its span from its
    first CPU event to its last, the time inside CPU events (the union of ATen ops and runtime
    calls), the time inside the syncs (``aten::_local_scalar_dense``), the syncs), in us."""
    by_thread = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            by_thread[e.thread].append(e)
    rows = []
    for events in by_thread.values():
        syncs = [e.time_range.elapsed_us() for e in events if e.name == SYNC_OP]
        if not syncs:
            continue
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
        inside, (lo, hi) = 0.0, spans[0]
        for start, end in spans[1:]:
            if start > hi:
                inside, lo = inside + hi - lo, start
            hi = max(hi, end)
        inside += hi - lo
        span = max(end for _, end in spans) - spans[0][0]
        rows.append((span, inside, sum(syncs), len(syncs)))
    return rows


def _profiled_round(tag, gw, cfg, prompts, want) -> None:
    """A round under torch.profiler, every thread's CPU ops recorded: the device's busy share
    of the round's wall, and how the handler threads' spans split into ATen ops, ``.item()``
    syncs and the rest (Python, and waiting for the interpreter lock), a step (a prefill or a
    decode step) at a time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=config) as prof:
        t0 = time.monotonic()
        _, _, tokens = _gateway_round(tag, gw, cfg, prompts, want, GATEWAY_TRACE_TOKENS)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    rows = _device_rows(prof)
    if not rows:
        log(f"[gateway] {tag}: no device time recorded (busy share not measured)")
    else:
        kinds, launches = _device_kinds(rows)
        busy = sum(kinds.values())
        by_kind = "; ".join(
            f"{k} {ms:.3f} ms ({launches[k]} launches)"
            for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])
        )
        log(
            f"[gateway] {tag} profiled: {tokens} tokens in {wall_ms:.3f} ms wall, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}%), {sum(launches.values())} kernels: "
            f"{by_kind}"
        )
    threads = _thread_breakdown(prof)
    if not threads:
        log(f"[gateway] {tag}: no handler thread's ops recorded (host time not measured)")
        return
    span, inside, sync, n_sync = (sum(col) for col in zip(*threads))
    steps = len(prompts) * (GATEWAY_TRACE_TOKENS + 1)
    ops = inside - sync
    log(
        f"[gateway] {tag} profiled: {len(threads)} handler threads, spans {span / 1e3:.3f} ms "
        f"in all: ATen ops and runtime calls {ops / 1e3:.3f} ms ({100 * ops / span:.1f}%), "
        f".item() syncs {sync / 1e3:.3f} ms ({100 * sync / span:.1f}%, {n_sync} syncs), "
        f"outside ops (Python, waiting for the interpreter lock) {(span - inside) / 1e3:.3f} ms "
        f"({100 * (span - inside) / span:.1f}%); a step (prefill or decode, {steps} steps): "
        f"ops {ops / steps / 1e3:.3f} ms, syncs {sync / steps / 1e3:.3f} ms, outside "
        f"{(span - inside) / steps / 1e3:.3f} ms"
    )


def _trace_round_1(gw, cfg, prompts, want) -> None:
    """Where round 1's time goes: its 8 requests at ``GATEWAY_TRACE_TOKENS`` new tokens with
    the stack sampler, then profiled; then r0 alone profiled."""
    n, t0 = len(prompts), time.monotonic()
    _sampled_round(f"trace, {n} at once, sampled", gw, cfg, prompts, want)
    _profiled_round(f"trace, {n} at once", gw, cfg, prompts, want)
    _profiled_round("trace, r0 alone", gw, cfg, prompts[:1], want)
    log(f"[gateway] the trace's rounds and their profiles: {time.monotonic() - t0:.1f} s")


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
    one request's HTTP bodies; the trace of round 1 (``_trace_round_1``). Round 2: w1's
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
            _trace_round_1(gw, cfg, prompts, want)

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


def _train_batches(cfg):
    """The train steps' batches on the card, and each batch's ``payload_digest`` (the
    trainer's ``data@`` digest)."""
    source = TokenSource(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0
        )
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


def _direct_steps(cfg, opt) -> dict:
    """TRAIN_STEPS direct steps of ``cfg`` from the train CLI's initial params on the train
    phase's batches: each step's ms and metrics digest as the trainer journals it."""
    model = build(cfg, DEV)
    params = init_params(cfg, _gen(0), DEV)
    state = make_opt_init(model, opt)(params)
    train_step = make_train_step(model, opt)
    batches, data_digests = _train_batches(cfg)
    step_ms, digests = [], []
    for step in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, state, metrics = train_step(params, state, batches[step])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.monotonic() - t0))
        digests.append(_metrics_digest(metrics, step, data_digests[step]))
    log(
        f"[train] {cfg.num_layers} of the demo's layers (the durable and distributed phases' "
        f"depth): step ms {', '.join(f'{x:.3f}' for x in step_ms)}; metrics digests {digests}"
    )
    return {"step_digests": digests, "step_ms": step_ms}


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
    with torch.profiler.profile(activities=acts) as prof_grad:
        t0 = time.monotonic()
        _, grads = value_and_grad(model.loss_fn, params, batch)
        torch.cuda.synchronize()
        grad_ms = 1e3 * (time.monotonic() - t0)
    with torch.profiler.profile(activities=acts) as prof_opt:
        t0 = time.monotonic()
        adamw_update(params, grads, state, opt)
        torch.cuda.synchronize()
        opt_ms = 1e3 * (time.monotonic() - t0)
    grad_rows = _device_rows(prof_grad)
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


DURABLE_DIR = ROOT / "build" / "durable_train"  # the runs' directory; build/ is not committed
DURABLE_CMD = [
    "-m", "repro_torch.launch.train", "--arch", "serpytor-demo-100m", "--full",
    "--layers", str(DEMO_CUT_LAYERS), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
    "--steps", str(TRAIN_STEPS), "--checkpoint-every", "2",
]  # fmt: skip
LAUNCHES_LINE = "kernel launches "  # the train CLI's last line
# its counts of the kernels the demo's train steps do not run (it has no rec or rwkv layers)
NO_LAUNCHES = {"rglru_scan": 0, "rglru_bwd": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}


def _run_trainer(tag: str, run_dir: Path) -> dict:
    """One run of the train CLI in a process of its own, its output logged line by line;
    its heartbeat is polled once, when the first round's step line comes. Returns the
    launches the CLI reports, the heartbeat's report, the process's wall seconds and the
    run's ``summary.json``."""
    cmd = [sys.executable, *DURABLE_CMD, "--run-dir", str(run_dir)]
    path = [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    launches, address, beat = None, None, None
    t0 = time.monotonic()
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env) as proc:
        for line in proc.stdout:
            line = line.rstrip("\n")
            log(f"[durable {tag}] {line}")
            if line.startswith("heartbeat at "):
                address = line[len("heartbeat at ") :]
            elif line.startswith("step ") and address and beat is None:
                beat = check_heartbeat(address, timeout=30.0)
                if beat is None:
                    raise AssertionError(f"[durable {tag}] the heartbeat at {address} is down")
            elif line.startswith(LAUNCHES_LINE):
                launches = json.loads(line[len(LAUNCHES_LINE) :])
    wall = time.monotonic() - t0
    if proc.returncode != 0 or launches is None:
        raise AssertionError(f"[durable {tag}] the train CLI exited with code {proc.returncode}")
    summary = json.loads((run_dir / "summary.json").read_text())
    return {"launches": launches, "heartbeat": beat, "wall_s": wall, "summary": summary}


def _journal(run_dir: Path) -> list:
    return list(Journal(str(run_dir / "journal.wal"), sync="never").records())


def _log_saves(tag: str, run_dir: Path, seconds: dict) -> None:
    """Each checkpoint save's seconds beside its bytes, raw and on disk."""
    for name, sec in sorted(seconds.items()):
        man = json.loads((run_dir / "ckpt" / name / "manifest.json").read_text())
        entries = man["entries"].values()
        raw = sum(np.dtype(e["dtype"]).itemsize * int(np.prod(e["shape"])) for e in entries)
        disk = (run_dir / "ckpt" / name / "shard-0.npz.zst").stat().st_size
        kind = "async" if name.endswith("-opt") else "sync"
        log(
            f"[durable {tag}] save {name} ({kind}): {sec:.3f} s for {raw} bytes raw, {disk} on "
            f"disk (ratio {disk / raw:.4f}), {raw / sec / 1e6:.1f} MB/s of raw bytes"
        )


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
                f"[durable {tag}] {r.node_id}: {ms:.3f} ms through the trainer (NODE_START to "
                f"NODE_COMMIT), direct step {direct_ms[s]:.3f} ms: {ms - direct_ms[s]:+.3f} ms"
            )
        elif r.kind == "RUN_END":
            log(f"[durable {tag}] {r.node_id}: {r.wall_time - start[r.node_id]:.3f} s of round")


def phase_durable(direct: dict) -> None:
    """Train through the durable trainer, crash between the halves of its last checkpoint,
    restart and verify (run A, then run B), at the demo's first DEMO_CUT_LAYERS layers;
    ``direct`` is the train phase's result, whose direct steps at that depth it checks."""
    cfg = _demo_cut_config()
    per_step = cfg.num_layers
    direct = direct["cut"]
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    run_dir = DURABLE_DIR
    try:
        a = _run_trainer("A", run_dir)
        recs = _journal(run_dir)
        wal_a = (run_dir / "journal.wal").stat().st_size
        kinds = [r.kind for r in recs]
        commits = {r.node_id: r for r in recs if r.kind == "NODE_COMMIT"}
        want_nodes = {f"{k}@{s}" for k in ("data", "step") for s in range(TRAIN_STEPS)}
        want_nodes |= {"ckpt@2", f"ckpt@{TRAIN_STEPS}"}
        if (kinds.count("RUN_START"), kinds.count("RUN_END"), kinds.count("CKPT")) != (2, 2, 2):
            raise AssertionError(f"[durable A] journal kinds {sorted(set(kinds))}: {kinds}")
        if set(commits) != want_nodes:
            raise AssertionError(f"[durable A] commits {sorted(commits)}, want {want_nodes}")
        got = [commits[f"step@{s}"].output_digest for s in range(TRAIN_STEPS)]
        if got != direct["step_digests"]:
            raise AssertionError(
                f"[durable A] journaled step digests {got} != the direct steps' "
                f"{direct['step_digests']}"
            )
        n = per_step * 3
        want_launches = {**NO_LAUNCHES, "flash_attention_fwd": n, "flash_attention_bwd": n}
        if a["launches"] != want_launches or a["summary"]["steps"] != TRAIN_STEPS:
            raise AssertionError(f"[durable A] launches {a['launches']}, summary {a['summary']}")
        beat = a["heartbeat"]
        if beat is None or beat["devices"] != {"backend": "cuda", "count": 1}:
            raise AssertionError(f"[durable A] heartbeat {beat}")
        log(
            f"[durable A] journaled step digests {got} equal the direct steps'; flash launches "
            f"{a['launches']}; journal {wal_a} bytes, {len(recs)} records; CLI process "
            f"{a['wall_s']:.1f} s, trainer wall {a['summary']['wall_s']:.3f} s"
        )
        log(
            f"[durable A] heartbeat: devices {beat['devices']}, worker {beat['worker']}, pid "
            f"{beat['pid']}, cpu load1 {beat['cpu']['load1']} of {beat['cpu']['ncpu']}, memory "
            f"used {beat['memory']['used_frac']:.4f}, uptime {beat['uptime_s']:.3f} s, probe "
            f"{1e3 * beat['probe_latency_s']:.3f} ms"
        )
        _log_steps("A", recs, direct["step_ms"])
        _log_saves("A", run_dir, a["summary"]["checkpoint_s"])
        ckpt_refs = [r.ref for r in recs if r.kind == "CKPT"]

        # the crash between the two halves of the last checkpoint
        last = f"step{TRAIN_STEPS:08d}"
        shutil.rmtree(run_dir / "ckpt" / f"{last}-opt")
        log(f"[durable] deleted {last}-opt: the newest complete pair is step00000002")

        b = _run_trainer("B", run_dir)
        new = _journal(run_dir)[len(recs) :]
        wal_b = (run_dir / "journal.wal").stat().st_size
        starts = [r.node_id for r in new if r.kind == "RUN_START"]
        ran = [r.node_id for r in new if r.kind == "NODE_START"]
        step2 = [r.output_digest for r in new if r.kind == "NODE_COMMIT" and r.node_id == "step@2"]
        refs = [r.ref for r in new if r.kind == "CKPT"]
        n = per_step
        want_launches = {**NO_LAUNCHES, "flash_attention_fwd": n, "flash_attention_bwd": n}
        if starts != ["round2"] or ran != ["step@2", f"ckpt@{TRAIN_STEPS}"]:
            raise AssertionError(f"[durable B] rounds {starts}, nodes run {ran}")
        if step2 != [got[2]] or refs != [ckpt_refs[-1]]:
            raise AssertionError(
                f"[durable B] step@2 {step2} (A: {got[2]}), CKPT {refs} (A: {ckpt_refs[-1]})"
            )
        if b["launches"] != want_launches or b["summary"]["steps"] != 1:
            raise AssertionError(f"[durable B] launches {b['launches']}, summary {b['summary']}")
        log(
            f"[durable B] recovered from step00000002 in {b['summary']['restore_s']:.3f} s "
            f"(resolve with its content check, both shards, onto the card); step@2 re-executed "
            f"through the verify twin: digest {step2[0]} equals the journal's; {last} re-saved as "
            f"{refs[0]}, A's content digests; 1 step; flash launches {b['launches']}; journal "
            f"{wal_b} bytes; CLI process {b['wall_s']:.1f} s"
        )
        _log_steps("B", new, direct["step_ms"])
        _log_saves("B", run_dir, b["summary"]["checkpoint_s"])
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
        log(f"[distributed {tag}] save {name}: {sec:.3f} s ({smi})")
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


def _dist_profile(cfg, state: dict, smi: str, timers: _HostTimers) -> None:
    """Steps 1-3 of the round from the direct step 0's state, each a one-step graph of
    the trainer's (its checkpoint node dropped) on a ClusterExecutor over a Gateway and
    DIST_WORKERS in-process workers, with no journal: step 1 warms the new worker threads,
    step 2 gives the host's seconds by kind, step 3 runs under torch.profiler for the
    device's busy share."""
    tr = DistributedTrainer(cfg, _dist_config(DIST_DIR / "profile"), device=DEV)
    with Gateway(tr.workers, heartbeat_interval_s=0.1, name="profile-gateway") as gw:
        ex = ClusterExecutor(gw, speculative=False)

        def step(s):
            g = tr._round_graph(s, s + 1, state, {})
            del g.nodes[f"ckpt@{s + 1}"]
            t0 = time.monotonic()
            ex.run(g)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        step(1)
        timers.reset()
        wall = step(2)
        for kind, (sec, n) in timers.snapshot().items():
            log(
                f"[distributed] step 2 host {kind}: {sec:.3f} s in {n} calls, "
                f"{100 * sec / wall:.1f}% of the step's {wall:.3f} s wall ({smi})"
            )
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall = step(3)
    rows = _device_rows(prof)
    if not rows:
        log("[distributed] step 3 profiled: no device time recorded (busy share not measured)")
    else:
        kinds, launches = _device_kinds(rows)
        busy = sum(kinds.values())
        by_kind = "; ".join(
            f"{k} {ms:.3f} ms ({launches[k]} launches)"
            for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])
        )
        log(
            f"[distributed] step 3 profiled: {1e3 * wall:.3f} ms wall, device busy {busy:.3f} ms "
            f"({100 * busy / (1e3 * wall):.2f}%), {sum(launches.values())} kernels and copies: "
            f"{by_kind} ({smi})"
        )
    del tr
    _release()


def dist_main() -> int:
    """The distributed process: run A, run B with a worker killed, step 0 directly, the
    profiled steps; checks A against B and against the direct step."""
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
            _dist_profile(cfg, direct.pop("state"), smi, timers)
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
    """Serve full-width recurrentgemma-9b; returns launch counts and serving numbers."""
    cfg = get_config("recurrentgemma-9b")
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
    tag, model, params, prompts, res, seen, tol, max_len=HYBRID_MAX_LEN, routes=False
):
    """Each request's batched logits (prefill and every decode step) against a
    teacher-forced run of it alone, fed its batched tokens: at batch 1 within
    ``tol``, at the batcher's width bit for bit (SAME_SHAPE_TOL). With ``routes``, the
    decode steps' MoE routing flips between the two runs are counted and logged."""
    done = res["generations"]
    worst, worst_wide, total, flips, route_flips = 0.0, 0.0, 0, 0, 0
    for i, prompt in enumerate(prompts):
        rid = f"r{i}"
        toks = done[rid].tokens
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"{tag} {rid}: {len(toks)} tokens, expected {NEW_TOKENS}")
        batched = [seen["prefill"][i]] + seen["decode"][rid]
        alone_routes, wide_routes = [], []
        with _decode_routes(1, alone_routes) if routes else contextlib.nullcontext():
            forced = _teacher_forced(model, params, prompt, toks, rows=1, max_len=max_len)
        with _decode_routes(SLOTS, wide_routes) if routes else contextlib.nullcontext():
            wide = _teacher_forced(model, params, prompt, toks, rows=SLOTS, max_len=max_len)
        flipped = _route_flips(alone_routes, wide_routes)
        route_flips += flipped
        if not len(batched) == len(forced) == len(wide):
            raise AssertionError(f"{tag} {rid}: {len(batched)} logits, {len(forced)} sequential")
        errs = [(b_ - f_).abs().max().item() for b_, f_ in zip(batched, forced)]
        wide_err = max((b_ - w_).abs().max().item() for b_, w_ in zip(batched, wide))
        finite = all(torch.isfinite(b_).all() for b_ in batched)
        diff = sum(int(torch.argmax(f_)) != t for f_, t in zip(forced, toks))
        worst, total, flips = max(worst, max(errs)), total + len(toks), flips + diff
        worst_wide = max(worst_wide, wide_err)
        if not finite or max(errs) > tol or wide_err > SAME_SHAPE_TOL:
            raise AssertionError(
                f"{tag} {rid}: logits vs teacher-forced: {max(errs):.4f} at batch 1, "
                f"{wide_err:.4e} at batch {SLOTS}"
            )
        routed = f"; routing flips at batch 1 {flipped}/{len(alone_routes)}" if routes else ""
        log(
            f"{tag} {rid} (prompt {len(prompt)}): logits vs teacher-forced sequential max |err| "
            f"{max(errs):.4e}, mean of per-step max {np.mean(errs):.4e}, greedy tokens that "
            f"differ {diff}/{len(toks)}; at the batcher's width {wide_err:.4e}{routed}"
        )
    routed = f"; routing flips at batch 1 {route_flips}" if routes else ""
    log(
        f"{tag} all requests: max |err| {worst:.4e} (tol {tol}), greedy tokens that "
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
    """One prefill of ``prompt`` as the batcher runs it (padded to ``max_len``): host
    time, then under torch.profiler the device time by kind of kernel."""
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]

    def prefill():
        model.prefill(params, {"tokens": ids}, pad_to=max_len)

    prefill()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    prefill()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        prefill()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    rows = _device_rows(prof)
    if not rows:
        log(f"{tag} prefill profile: no device time recorded (not measured)")
        return
    kinds, launches = _device_kinds(rows)
    device_ms = sum(kinds.values())
    by_kind = "; ".join(
        f"{k} {ms:.3f} ms ({100 * ms / device_ms:.1f}%, {launches[k]} launches)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])
    )
    top = "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}" for us, n, k in rows[:6])
    log(
        f"{tag} prefill of {len(prompt)} tokens: {plain_ms:.3f} ms host wall, peak memory "
        f"{peak} bytes ({peak - held} above the {held} held before it); under the "
        f"profiler {wall_ms:.3f} ms wall, device busy {device_ms:.3f} ms "
        f"({100 * device_ms / wall_ms:.1f}%), {sum(launches.values())} kernels; device time "
        f"by kind: {by_kind}; top kernels: {top}"
    )


def _decode_profile(model, params, tag: str, max_len: int, steps: int = 5) -> None:
    """Host time of a 4-slot decode step, and under torch.profiler the device's
    busy share and the kernels that take most of its time."""
    cache = model.init_cache(SLOTS, max_len)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=DEV)
    for _ in range(2):
        model.decode_step(params, cache, {"token": tok})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    for _ in range(steps):
        model.decode_step(params, cache, {"token": tok})
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            model.decode_step(params, cache, {"token": tok})
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.monotonic() - t0)
    rows = _device_rows(prof)
    device_us = sum(r[0] for r in rows)
    if not rows:
        log(f"{tag} decode profile: no device time recorded (busy share not measured)")
        return
    top = "; ".join(f"{k[:60]} {us / steps:.0f} us x{n // steps}" for us, n, k in rows[:6])
    ours = "; ".join(  # the port's own kernels: device time of one launch at decode
        f"{name} {us / n:.2f} us a launch x{n // steps}"
        for us, n, k in rows
        for name in PORT_KERNEL_SYMBOLS
        if name in k
    )
    log(
        f"{tag} decode step (4 slots): {plain_ms:.3f} ms host wall, peak memory {peak} bytes "
        f"({peak - held} above the {held} held before it); under the profiler "
        f"{wall_us / 1e3 / steps:.3f} ms wall, device busy {device_us / 1e3 / steps:.3f} ms "
        f"({100 * device_us / wall_us:.1f}%), {sum(r[1] for r in rows) // steps} kernels a step; "
        f"top by device time per step: {top}; the port's kernels: {ours or 'none'}"
    )


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
    """Serve full-width rwkv6-7b; returns the WKV6 kernel's launch count."""
    cfg = get_config("rwkv6-7b")
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
# phase came and the script's time had to shrink).
DENSE_ARCHS = ("qwen3-1.7b", "stablelm-1.6b", "yi-6b", "qwen1.5-110b")
DENSE_DEPTH = {"qwen1.5-110b": 4}
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
    """Serve full-width granite-moe-3b-a800m at full depth (32 MoE layers, bfloat16): 8
    requests through the 4-slot batcher at MOE_MAX_LEN, both engines; the launch and engine
    gates, teacher-forced logits with routing flips counted, moe_block's bits twice in each
    engine, serving numbers beside their bounds and profiles; then a float32 layer on the card
    against the CPU path. Returns the flash and decode-attention launch counts."""
    tag = "[moe]"
    cfg = get_config(MOE_ARCH)
    t0 = time.monotonic()
    params = init_params(cfg, _gen(0), DEV)
    model = build(cfg, DEV)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated()
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} MoE layers, d={cfg.d_model}, {cfg.num_heads} heads "
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


def _moe_prefill_flops(cfg, n: int) -> float:
    """FLOPs of one prefill of ``n`` tokens as the reference defines its work: the experts'
    products over every slot row the engine dispatches (empty slots included), the attention
    projections, the router, causal attention, the last row's unembed."""
    E, k, d, ff = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model, cfg.moe_d_ff
    if n <= moe_mod.DROPLESS_TOKENS:
        slots = n  # dropless: every expert gets n slots
    else:
        groups = max(1, n // cfg.moe_group_size)
        per = n // groups
        slots = groups * max(1, int(per * k / E * cfg.moe_capacity_factor))
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


@contextlib.contextmanager
def _moe_ranges():
    """The MoE block, its router, its experts' products and the attention block wrapped in
    ``torch.profiler.record_function`` ranges of MOE_RANGES' names (this file's patches: the
    port's code carries none)."""
    saved = [
        (transformer_mod, "gqa_attention", "attention"),
        (transformer_mod, "moe_block", "moe"),
        (moe_mod, "_router", "moe.router"),
        (moe_mod, "_expert_ffn", "moe.experts"),
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


def _moe_decode_split(model, params, tag: str, max_len: int, steps: int = 5) -> None:
    """A profiled window of 4-slot decode steps split by block: the device time of the
    kernels launched inside the attention block, the MoE's router, its experts' products and
    the rest of the MoE (the dispatch: slot tables, sorts, gathers; the combine), per step."""
    cache = model.init_cache(SLOTS, max_len)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=DEV)
    model.decode_step(params, cache, {"token": tok})
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _moe_ranges(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            model.decode_step(params, cache, {"token": tok})
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / steps
    ranges = {name: 0.0 for name in MOE_RANGES}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in ranges:
            ranges[e.name] += e.device_time_total / 1e3 / steps
    kernels = [r for r in _device_rows(prof) if r[2] not in ranges]  # not the ranges' own
    device_ms = sum(r[0] for r in kernels) / 1e3 / steps
    if not device_ms or not ranges["moe"]:
        log(f"{tag} decode split: no device time under the ranges (not measured)")
        return
    dispatch = ranges["moe"] - ranges["moe.router"] - ranges["moe.experts"]
    parts = {
        "attention block": ranges["attention"],
        "MoE router": ranges["moe.router"],
        "MoE dispatch and combine": dispatch,
        "MoE experts' products": ranges["moe.experts"],
    }
    parts["the rest (norms, embed, unembed)"] = device_ms - sum(parts.values())
    log(
        f"{tag} decode step (4 slots) under the profiler with ranges: {wall_ms:.3f} ms wall, "
        f"device busy {device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f}%); device ms a step: "
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
    (xc, rc, ic), (xw, rw, iw) = card_calls[0], cpu_calls[0]
    k = cfg.num_experts_per_tok
    p_card = torch.softmax(dense(xc, rc).float(), dim=-1).cpu()
    p_cpu = torch.softmax(dense(xw, rw).float(), dim=-1)
    flipped = (torch.sort(ic.cpu(), -1).values != torch.sort(iw, -1).values).any(-1)
    top = torch.sort(p_cpu, dim=-1, descending=True).values
    margin = top[:, k - 1] - top[:, k]  # the CPU's gap at the top-k boundary
    noise = 2 * (p_card - p_cpu).abs().amax(-1)  # what the two roundings can move it
    for t in flipped.nonzero().flatten().tolist():
        log(
            f"{tag} float32 layer: token {t} routed differently on the card; its top-{k} "
            f"boundary gap {margin[t].item():.3e} against the sides' probability difference "
            f"x 2 {noise[t].item():.3e}"
        )
        if margin[t] > noise[t]:
            raise AssertionError(f"{tag} float32 layer: token {t} flipped without a tie")
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


def _dense_train() -> dict:
    """qwen3-1.7b at full width and depth in bfloat16 (remat "full"), 3 AdamW steps on
    TokenSource batches of DENSE_TRAIN_BATCH x TRAIN_SEQ: :func:`_bf16_train`."""
    return _bf16_train(get_config(DENSE_TRAIN_ARCH), DENSE_TRAIN_BATCH, "[dense train]")


def _layer_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` train steps of ``cfg`` with remat "full", which runs
    each layer's forward again in its backward: the flash forward twice and its backward
    once an attention layer, the RG-LRU forward twice and its backward once a rec layer, the
    WKV6 chunk forward twice and its backward once an rwkv layer."""
    kinds = layer_pattern(cfg)
    attn = sum(kind in ("dense", "attn") for kind in kinds)
    rec = sum(kind == "rec" for kind in kinds)
    rwkv = sum(kind == "rwkv" for kind in kinds)
    return {
        "flash": 2 * attn * steps,
        "flash_bwd": attn * steps,
        "rglru": 2 * rec * steps,
        "rglru_bwd": rec * steps,
        "wkv6": 2 * rwkv * steps,
        "wkv6_bwd": rwkv * steps,
    }


def _bf16_train(cfg, batch_size: int, tag: str) -> dict:
    """``cfg`` (bfloat16, remat "full") takes 3 AdamW steps (the train CLI's) on TokenSource
    batches of batch_size x TRAIN_SEQ, deterministically: the launch gates, step 0 replayed
    with equal bits, a profiled step, step 0 against attn_impl="ref". Step 0's result waits
    on the host while its replay runs (params, m and v of two states take most of the card),
    training goes on from the replay's, and the first params wait on the host over steps 1
    and 2 for the check against the plain path at the end."""
    from repro_torch.launch.train import opt_config

    if (cfg.param_dtype, cfg.compute_dtype, cfg.remat) != ("bfloat16", "bfloat16", "full"):
        raise AssertionError(f"{tag} {cfg.name}: {cfg.param_dtype}, {cfg.remat}")
    t_set_up = time.monotonic()
    model = build(cfg, DEV)
    params0 = init_params(cfg, _gen(0), DEV)
    opt = AdamWConfig(**TRAIN_OPT)
    if opt != opt_config(TRAIN_STEPS):
        raise AssertionError(f"{tag} {opt} is not the CLI's {opt_config(TRAIN_STEPS)}")
    state0 = make_opt_init(model, opt)(params0)
    train_step = make_train_step(model, opt)
    source = TokenSource(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=batch_size, seed=0)
    )
    batches = [
        {"tokens": torch.from_numpy(source.batch_at(s)["tokens"]).long().to(DEV)}
        for s in range(TRAIN_STEPS)
    ]
    tokens = batch_size * TRAIN_SEQ
    torch.cuda.synchronize()
    pattern = ", ".join(cfg.block_pattern) if cfg.block_pattern else layer_pattern(cfg)[0]
    heads = (
        f"{cfg.d_model // cfg.rwkv_head_size} WKV heads of {cfg.rwkv_head_size}"
        if cfg.family == "ssm"
        else f"{cfg.num_heads} heads on {cfg.num_kv_heads} KV heads of {cfg.head_dim}"
    )
    log(
        f"{tag} {cfg.name}: {cfg.num_layers} layers ({pattern}), d={cfg.d_model}, {heads}"
        + (f", window {cfg.window}" if cfg.block_pattern else "")
        + f", vocab {cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} embeddings, "
        f"{cfg.param_count()} params {cfg.param_dtype}, remat={cfg.remat}; batches of "
        f"{batch_size} x {TRAIN_SEQ} tokens from TokenSource(seed=0); {opt}; "
        f"{torch.cuda.memory_allocated()} bytes held (params, AdamW m and v), drawn in "
        f"{time.monotonic() - t_set_up:.1f} s"
    )
    torch.use_deterministic_algorithms(True)
    _reset_launches()

    def run(step, params, state):
        t0 = time.monotonic()
        params, state, metrics = train_step(params, state, batches[step])
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        vals = {key: float(x) for key, x in metrics.items()}
        if not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"{tag} step {step}: metrics {vals}")
        log(
            f"{tag} step {step}: loss {vals['loss']:.6f} ce {vals['ce']:.6f} z_loss "
            f"{vals['z_loss']:.4f} grad_norm {vals['grad_norm']:.6f} lr {vals['lr']:.4e}; "
            f"{ms:.3f} ms, {tokens / ms * 1e3:.1f} tokens/s (host clock after a sync); "
            f"max_memory_allocated so far {torch.cuda.max_memory_allocated()} bytes"
        )
        return (params, state, metrics), ms

    first, ms0 = run(0, params0, state0)
    host = tuple(tree_map(lambda x: x.cpu(), tree) for tree in first)
    del first  # its memory stays in the allocator's cache for the replay
    # replay: step 0 again from the same state, equal bits (to_host refuses bfloat16: the
    # trees are compared with torch.equal on the card)
    (params, state, metrics), ms_replay = run(0, params0, state0)
    diff = _replay_differs(host, (params, state, metrics))
    if any(diff.values()):
        raise AssertionError(f"{tag} step 0 replayed: elements that differ {diff}")
    n = sum(x.numel() for x in tree_leaves(params))
    log(
        f"{tag} step 0 run again from the same state: params ({n} elements), AdamW m, "
        "v and step, and metrics equal bit for bit (torch.equal on the card)"
    )
    params0 = tree_map(lambda x: x.cpu(), params0)
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
        bwd_path = fa.bwd_path(cfg.head_dim, cfg.head_dim, torch.bfloat16)
        path = f"; flash backward on the {bwd_path} path"
    log(
        f"{tag} kernels launched {launches} over {steps} steps (0, its replay, 1, 2; remat full "
        f"runs each layer's forward again in its recompute: {want} expected{path}); step ms "
        f"(0, replay, 1, 2) {', '.join(f'{x:.3f}' for x in step_ms)} "
        f"(all but the first: {steady:.3f} ms, {tokens / steady * 1e3:.1f} tokens/s); "
        f"max_memory_allocated over steps 1-2 {peak} bytes ({peak - held} above the {held} "
        "held before them)"
    )
    _train_profile(model, params, state, batches[0], opt, tag=tag)
    del params, state
    _release()
    params0 = tree_map(lambda x: x.to(DEV), params0)
    t_check = time.monotonic()
    _check_bf16_train_against_plain(cfg, model, params0, batches[0], tag)
    log(f"{tag} the check against the plain path took {time.monotonic() - t_check:.1f} s")
    return {**launches, "step_ms": step_ms, "peak": peak}


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
# layers 0-7 of its 32: 2.32B params, a peak of 54.3 GB on an H100 80GB HBM3 (params,
# gradients, AdamW state and the out-of-place step's second copy: ~23 bytes a parameter, as the
# hybrid train phase's); 12 layers would need ~74 GB
RWKV_TRAIN_LAYERS = 8
RWKV_TRAIN_BATCH = 1  # train_4k's 4096 tokens, its batch cut to one sequence on one card
RWKV_TRAIN_RESULT = "[rwkv train] launches "  # the process's line of launch counts and times


def phase_rwkv_train() -> dict:
    """Run the rwkv train phase in a process of its own (this file with ``--rwkv-train``);
    returns its launch counts, step ms and peak memory."""
    return _in_process(RWKV_TRAIN_ARG, RWKV_TRAIN_RESULT, "[rwkv train]")


def _rwkv_train() -> dict:
    """rwkv6-7b at full width, layers 0-7, in bfloat16 (remat "full"), 3 AdamW steps on
    TokenSource batches of RWKV_TRAIN_BATCH x TRAIN_SEQ: :func:`_bf16_train`."""
    cfg = dataclasses.replace(get_config(RWKV_TRAIN_ARCH), num_layers=RWKV_TRAIN_LAYERS)
    return _bf16_train(cfg, RWKV_TRAIN_BATCH, "[rwkv train]")


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


def _check_bf16_train_against_plain(cfg, model, params, batch, tag) -> None:
    """Step 0's gradient through the kernels against attn_impl="ref" (plain attention under
    autograd, the same bfloat16 GEMMs), within DENSE_TRAIN_GAPS times the plain path's gap
    between this bfloat16 run and a float32 run of the same params (upcast) on the same
    batch: the loss, the global grad norm and every gradient leaf."""
    plain = build(dataclasses.replace(cfg, attn_impl="ref"), DEV)
    loss, grads = _grad_run(model, params, batch)
    plain_loss, plain_grads = _grad_run(plain, params, batch)
    del plain
    _release()
    cfg32 = dataclasses.replace(
        cfg, attn_impl="ref", param_dtype="float32", compute_dtype="float32"
    )
    params32 = tree_map(lambda x: x.float(), params)
    loss32, grads32 = _grad_run(build(cfg32, DEV), params32, batch)
    del params32
    _release()

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
    dense_train = _timed("dense train", phase_dense_train)
    hybrid_train = _timed("hybrid train", phase_hybrid_train)
    rwkv_train = _timed("rwkv train", phase_rwkv_train)

    flash_src = "src/repro_torch/kernels/csrc/flash_attention_fwd.cu"
    flash_tpu = "src/repro/kernels/flash_attention.py:39"
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
            dense_train["flash"],
            bwd_rows["bf16"]["fwd"],
            "q(2,16,4096,128) k,v(2,8,4096,128) bfloat16 causal, with the logsumexp",
        ),
        _kernel_entry(
            "flash_attention_bwd_bf16",
            "src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu",
            "src/repro/kernels/flash_attention.py:139",
            dense_train["flash_bwd"],
            bwd_rows["bf16"]["bwd"],
            "q,dO(2,16,4096,128) k,v(2,8,4096,128) bfloat16 causal; flash_bwd_bf16_delta_kernel, "
            + ", ".join(BF16_WGMMA_KERNELS[:2]),
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
    sys.exit(dist_main() if sys.argv[1:] == [DIST_ARG] else main())
