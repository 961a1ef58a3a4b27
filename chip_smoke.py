"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the port from ``src/`` with nvcc,
   one process per source, in parallel, and print ptxas's register and
   spill report;
3. kernels: each kernel against its plain PyTorch version on the card:
   flash attention on the cases of ``tests/test_kernels.py`` (FLASH_CASES
   and the MLA 48/32 case), on edge cases, on the demo model's prefill
   shapes and at recurrentgemma-9b's head dim 256 (MQA, window 2048, float32
   and bfloat16); the RG-LRU scan at recurrentgemma-9b's prefill and decode
   shapes. Each timed case prints the kernel's time, its plain version's,
   one PyTorch library call's where one computes the same function, and
   the least time the card could take;
4. demo: ``serpytor-demo-100m`` at full width and depth serves 8 requests
   through ``ContinuousBatcher(slots=4, max_len=1536)``; tokens equal
   sequential greedy decoding, the flash kernel ran in every prefill
   layer, and prefill logits agree with the port's CPU path within 1e-4;
5. hybrid: ``recurrentgemma-9b`` at full width and depth (38 layers,
   10.4B params, bfloat16) serves 8 requests of prompts on both sides of
   its 2048 window through ``ContinuousBatcher(slots=4, max_len=3072)``;
   the flash kernel ran in the 12 attention layers of every prefill and
   the RG-LRU kernel in the 26 recurrent layers of every prefill and
   decode step; each request's logits agree with a teacher-forced
   sequential run (fed the batched tokens) within LOGIT_TOL_BF16, and with
   the same run at the batcher's width bit for bit; a profiled window of
   decode steps gives the device's busy share;
6. exactness: a float32 copy of recurrentgemma-9b at full width and depth
   3 (rec, rec, attn) serves the same requests: tokens equal sequential
   greedy decoding; decode across the window equals a fresh prefill within
   1e-4; one rec and one attn layer on the card equal the port's CPU path
   on a (1, 2100, 4096) input within 1e-4;
7. the JSON line of kernels, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.

Every model is freed before the next is built. It imports the port
(``src/repro_torch``) and never JAX or the JAX package. Without a CUDA card,
or outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru as rg  # noqa: E402
from repro_torch.launch.serve import drain, make_prompts, serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.transformer import apply_layer  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serve import ContinuousBatcher  # noqa: E402
from repro_torch.serve.batcher import _splice_cache  # noqa: E402

DEV = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32 on
# CUDA cores, bfloat16 on tensor cores, HBM bandwidth. A card with a lower
# power limit is slower.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

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
# recurrentgemma-9b's local attention: Hq=16, Hkv=1, D=Dv=256, window 2048
HYBRID_FLASH = [
    (1, 16, 1, s_q, s_k, 256, True, 2048, dt, 256)
    for dt in ("float32", "bfloat16")
    for s_q, s_k in ((3000, 3000), (1000, 3000), (2111, 2111))  # full, Sq < Sk, ragged
]
HYBRID_FLASH_JSON = (1, 16, 1, 3000, 3000, 256, True, 2048, "bfloat16", 256)
# (B, T, W, x dtype, with h0): recurrentgemma-9b's prefill (T up to 3000) and
# decode (B = slots, T = 1) at lru_width 4096; a W that is no multiple of the
# 64-thread block; float32 x
RGLRU_CASES = [
    (1, 3000, 4096, "bfloat16", True),
    (1, 3000, 4096, "bfloat16", False),
    (4, 1, 4096, "bfloat16", True),
    (2, 333, 1000, "bfloat16", True),
    (1, 3000, 4096, "float32", True),
]
RGLRU_JSON = (1, 3000, 4096, "bfloat16", True)  # prefill passes the zero state as h0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, tests/test_kernels.py:47
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


def attention_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, itemsize):
    """Least time for one attention forward: max(FLOPs / peak, bytes / bandwidth),
    the peak of the input's type (float32 CUDA cores, bfloat16 tensor cores)."""
    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())  # (query, key) pairs the masks keep
    flops = 2.0 * b * hq * pairs * (d + dv)
    nbytes = itemsize * (b * hq * sq * d + b * hkv * sk * (d + dv) + b * hq * sq * dv)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rglru_bound_ms(b, t, w, itemsize, with_h0):
    """Least time for one RG-LRU scan: bytes / bandwidth (x, a, h0 read; h, hT written).
    Its ~6 flops an element are far below the ridge of any type."""
    nbytes = b * t * w * (itemsize + 4 + itemsize) + b * w * 4 * (2 if with_h0 else 1)
    return 1e3 * nbytes / PEAK_HBM_BYTES, "bytes"


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
    cases += EDGE_CASES
    cases += [(1, 12, 4, s, s, 64, True, None, "float32", 64) for s in DEMO_SEQ]
    cases += HYBRID_FLASH
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
        log(f"[kernels] flash_attention_fwd {shape} {flags}: max |err| {err:.3e} (tol {TOL[dt]})")
        demo = (hq, hkv, d) == (12, 4, 64)
        if not demo and case not in HYBRID_FLASH:
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
        row = {
            "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal, window=window)),
            "plain_ms": time_ms(
                lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window), iters=5
            ),
            "library_ms": time_ms(library, iters=10),
            "bound_ms": bound,
            "bound_by": bound_by,
            "max_abs_err": err,
        }
        rows[("demo", sq) if demo else case] = row
        log(
            f"[kernels]   {'demo S=' + str(sq) if demo else shape}: kernel_ms {row['ms']:.4f}, "
            f"plain_ms {row['plain_ms']:.4f}, library_ms (SDPA {backend}, |err| {lib_err:.1e}) "
            f"{row['library_ms']:.4f}, bound_ms {bound:.5f} ({bound_by}), "
            f"kernel/bound {row['ms'] / bound:.1f}"
        )
    return rows, demo_err


def _rglru_rows(gen):
    """RG-LRU kernel vs plain on every case, with times."""
    rows = {}
    for case in RGLRU_CASES:
        b, t, w, dt, with_h0 = case
        dtype = getattr(torch, dt)
        x = torch.randn(b, t, w, generator=gen, device=DEV).to(dtype)
        # decays as the model makes them: exp(-8 softplus(lambda) sigmoid(.))
        lam = torch.randn(w, generator=gen, device=DEV)
        r = torch.sigmoid(torch.randn(b, t, w, generator=gen, device=DEV))
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
        h0 = torch.randn(b, w, generator=gen, device=DEV) if with_h0 else None
        got, got_last = rg.rglru_scan(x, a, initial_state=h0)
        want, want_last = ref.rglru_ref(x, a, initial_state=h0)
        torch.cuda.synchronize()
        label = f"rglru_scan x{tuple(x.shape)} {dt} h0={with_h0}"
        err = max(_check(label, got, want, TOL[dt]), _check(label, got_last, want_last, TOL[dt]))
        bound, bound_by = rglru_bound_ms(b, t, w, x.element_size(), with_h0)
        row = {
            "ms": time_ms(lambda x=x, a=a, h0=h0: rg.rglru_scan(x, a, initial_state=h0)),
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
            f"[kernels] {label}: max |err| {err:.3e} (tol {TOL[dt]}); kernel_ms {row['ms']:.4f}, "
            f"plain_ms {row['plain_ms']:.4f}, library_ms none, bound_ms {bound:.5f} ({bound_by}), "
            f"kernel/bound {row['ms'] / bound:.1f}"
        )
    return rows


def phase_kernels():
    gen = _gen(7)
    flash_rows, demo_err = _flash_rows(gen)
    return flash_rows, demo_err, _rglru_rows(gen)


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


def _release() -> None:
    """Give the memory of the phase that just returned back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_demo() -> int:
    """Serve the full-width demo model; returns the flash kernel's launch count."""
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
    fa.flash_attention_fwd.launches = 0
    rg.rglru_scan.launches = 0
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=MAX_LEN)
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()

    done = res["generations"]
    if set(done) != set(want):
        raise AssertionError(f"[demo] finished {sorted(done)}, submitted {sorted(want)}")
    for rid, toks in want.items():
        if done[rid].tokens != toks:
            raise AssertionError(f"[demo] {rid}: batched {done[rid].tokens} != sequential {toks}")
    expected = cfg.num_layers * len(prompts)
    if launches != expected or rg.rglru_scan.launches != 0:
        raise AssertionError(
            f"[demo] flash launches {launches}, expected {expected}; "
            f"rglru launches {rg.rglru_scan.launches}, expected 0"
        )
    log(f"[demo] tokens of all {len(done)} requests equal sequential greedy decoding")
    check_against_cpu(cfg, model, params, min(prompts, key=len))
    log(f"[demo] flash_attention_fwd launches {launches} = {cfg.num_layers} layers x 8 prefills")
    log(
        f"[demo] {res['tokens']} tokens in {res['wall_s']:.4f} s: {res['tok_per_s']:.2f} tok/s; "
        f"prefill {res['prefill_ms_mean']:.3f} ms mean; decode {res['decode_ms_per_step']:.3f} "
        f"ms/step over {res['steps']} steps; max_memory_allocated {peak} bytes"
    )
    return launches


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


def _teacher_forced(model, params, prompt, toks, rows):
    """Logits of one request decoded alone and fed ``toks``: at batch 1, or with its
    cache spliced into all ``rows`` rows of a batch (row 0's logits, the batcher's
    matmul shapes)."""
    ids = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
    logits, cache = model.prefill(params, {"tokens": ids}, pad_to=HYBRID_MAX_LEN)
    if rows > 1:
        fresh, cache = cache, model.init_cache(rows, HYBRID_MAX_LEN)
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
        f"{cfg.param_dtype}; drawn in {time.monotonic() - t0:.1f} s"
    )
    prompts = hybrid_prompts(cfg.vocab_size)
    log(f"[hybrid] prompt lengths {[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")

    # warm up: a short prefill and a 4-slot decode step (counted launches are reset below)
    model.prefill(params, {"tokens": torch.zeros((1, 64), dtype=torch.long, device=DEV)})
    zeros = torch.zeros(SLOTS, dtype=torch.long, device=DEV)
    model.decode_step(params, model.init_cache(SLOTS, HYBRID_MAX_LEN), {"token": zeros})

    engine_box = []
    rec_model, seen = _recording(model, engine_box)
    eng = ContinuousBatcher(rec_model, params, slots=SLOTS, max_len=HYBRID_MAX_LEN)
    engine_box.append(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    rg.rglru_scan.launches = 0
    res = drain(eng, prompts, new_tokens=NEW_TOKENS)
    flash_launches, rglru_launches = fa.flash_attention_fwd.launches, rg.rglru_scan.launches
    peak = torch.cuda.max_memory_allocated()

    want_flash = n_attn * len(prompts)
    want_rglru = n_rec * (len(prompts) + res["steps"])
    if (flash_launches, rglru_launches) != (want_flash, want_rglru):
        raise AssertionError(
            f"[hybrid] launches flash {flash_launches} (expected {want_flash}), rglru "
            f"{rglru_launches} (expected {want_rglru})"
        )
    log(
        f"[hybrid] flash_attention_fwd launches {flash_launches} = {n_attn} attn layers x "
        f"{len(prompts)} prefills; rglru_scan launches {rglru_launches} = {n_rec} rec layers x "
        f"({len(prompts)} prefills + {res['steps']} decode steps)"
    )

    # each request against a teacher-forced sequential run fed its batched tokens
    done = res["generations"]
    worst, worst_wide, total, flips = 0.0, 0.0, 0, 0
    for i, prompt in enumerate(prompts):
        rid = f"r{i}"
        toks = done[rid].tokens
        if len(toks) != NEW_TOKENS:
            raise AssertionError(f"[hybrid] {rid}: {len(toks)} tokens, expected {NEW_TOKENS}")
        batched = [seen["prefill"][i]] + seen["decode"][rid]
        forced = _teacher_forced(model, params, prompt, toks, rows=1)
        wide = _teacher_forced(model, params, prompt, toks, rows=SLOTS)
        if not len(batched) == len(forced) == len(wide):
            raise AssertionError(f"[hybrid] {rid}: {len(batched)} logits, {len(forced)} sequential")
        errs = [(b_ - f_).abs().max().item() for b_, f_ in zip(batched, forced)]
        wide_err = max((b_ - w_).abs().max().item() for b_, w_ in zip(batched, wide))
        finite = all(torch.isfinite(b_).all() for b_ in batched)
        diff = sum(int(torch.argmax(f_)) != t for f_, t in zip(forced, toks))
        worst, total, flips = max(worst, max(errs)), total + len(toks), flips + diff
        worst_wide = max(worst_wide, wide_err)
        if not finite or max(errs) > LOGIT_TOL_BF16 or wide_err > SAME_SHAPE_TOL:
            raise AssertionError(
                f"[hybrid] {rid}: logits vs teacher-forced: {max(errs):.4f} at batch 1, "
                f"{wide_err:.4e} at batch {SLOTS}"
            )
        log(
            f"[hybrid] {rid} (prompt {len(prompt)}): logits vs teacher-forced sequential max |err| "
            f"{max(errs):.4e}, mean of per-step max {np.mean(errs):.4e}, greedy tokens that "
            f"differ {diff}/{len(toks)}; at the batcher's width {wide_err:.4e}"
        )
    log(
        f"[hybrid] all requests: max |err| {worst:.4e} (tol {LOGIT_TOL_BF16}), greedy tokens that "
        f"differ {flips}/{total}; at the batcher's width {worst_wide:.4e} (tol {SAME_SHAPE_TOL})"
    )
    log(
        f"[hybrid] {res['tokens']} tokens in {res['wall_s']:.4f} s: {res['tok_per_s']:.2f} tok/s; "
        f"prefill {res['prefill_ms_mean']:.3f} ms mean; decode {res['decode_ms_per_step']:.3f} "
        f"ms/step over {res['steps']} steps; max_memory_allocated {peak} bytes "
        f"(times include copying each step's logits to the host for the check)"
    )
    _decode_profile(model, params)
    return {"flash": flash_launches, "rglru": rglru_launches}


def _decode_profile(model, params, steps: int = 5) -> None:
    """Host time of a 4-slot decode step, and under torch.profiler the device's
    busy share and the kernels that take most of its time."""
    cache = model.init_cache(SLOTS, HYBRID_MAX_LEN)
    tok = torch.zeros(SLOTS, dtype=torch.long, device=DEV)
    for _ in range(2):
        model.decode_step(params, cache, {"token": tok})
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        model.decode_step(params, cache, {"token": tok})
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            model.decode_step(params, cache, {"token": tok})
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.monotonic() - t0)
    kernels = [  # device-side events only: an aten op's row repeats its kernels' time
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows = sorted((r for r in kernels if r[0] > 0), reverse=True)
    device_us = sum(r[0] for r in rows)
    if not rows:
        log("[hybrid] decode profile: no device time recorded (busy share not measured)")
        return
    top = "; ".join(f"{k[:60]} {us / steps:.0f} us x{n // steps}" for us, n, k in rows[:6])
    log(
        f"[hybrid] decode step (4 slots): {plain_ms:.3f} ms host wall; under the profiler "
        f"{wall_us / 1e3 / steps:.3f} ms wall, device busy {device_us / 1e3 / steps:.3f} ms "
        f"({100 * device_us / wall_us:.1f}%), {sum(r[1] for r in rows) // steps} kernels a step; "
        f"top by device time per step: {top}"
    )


def phase_exactness() -> None:
    """Float32 recurrentgemma-9b at full width, depth 3: exact batched tokens,
    decode across the window = fresh prefill, layers on the card = CPU path."""
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
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=HYBRID_MAX_LEN)
    for rid, (toks, _) in seq.items():
        if res["generations"][rid].tokens != toks:
            got = res["generations"][rid].tokens
            raise AssertionError(f"[exact] {rid}: batched {got} != sequential {toks}")
    log(f"[exact] tokens of all {len(seq)} requests equal sequential greedy decoding")

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
        got, got_cache = apply_layer(
            torch.from_numpy(x).to(DEV), lp, cfg, kind, positions=positions.to(DEV), mode="prefill"
        )
        want, want_cache = apply_layer(
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


def main() -> int:
    smi = phase_device()
    phase_build()
    flash_rows, demo_err, rglru_rows = phase_kernels()
    demo_launches = phase_demo()
    _release()
    hybrid = phase_hybrid()
    _release()
    phase_exactness()

    flash_src = "src/repro_torch/kernels/csrc/flash_attention_fwd.cu"
    flash_tpu = "src/repro/kernels/flash_attention.py:39"
    demo_row = dict(flash_rows[("demo", JSON_SEQ)], max_abs_err=demo_err)
    kernels = [
        _kernel_entry(
            "flash_attention_fwd",
            flash_src,
            flash_tpu,
            demo_launches,
            demo_row,
            f"q(1,12,{JSON_SEQ},64) k,v(1,4,{JSON_SEQ},64) float32 causal",
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
            "rglru_scan",
            "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "src/repro/kernels/rglru.py:29",
            hybrid["rglru"],
            rglru_rows[RGLRU_JSON],
            "x(1,3000,4096) bfloat16, a float32, h0 (1,4096) float32",
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
