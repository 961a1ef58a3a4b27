"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile every CUDA kernel of the port from ``src/`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the flash-attention cases of ``tests/test_kernels.py`` (FLASH_CASES and
   the MLA 48/32 case) and on the demo model's prefill shapes, with times
   for the kernel, its plain version, one PyTorch library call computing
   the same function, and the least time the card could take;
4. main path: ``serpytor-demo-100m`` at full width and depth, params drawn
   from a seeded generator, serves 8 requests of ragged prompt lengths
   through ``ContinuousBatcher(slots=4, max_len=1536)``; every request's
   tokens must equal a sequential greedy prefill + decode run on the card,
   the kernels' launch counts must show that every prefill layer ran
   through the flash kernel, and the card's prefill logits on the shortest
   prompt must be finite and agree with the port's CPU path within 1e-4;
5. the JSON line of kernels, the card's name and power limit, and last the
   contract line ``{"ok": true, "device": {...}}``.

It imports the port (``src/repro_torch``) and never JAX or the JAX
package. Without a CUDA card, or outside a checkout of the repository, it
fails before printing any result.
"""

from __future__ import annotations

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
from repro_torch.launch.serve import make_prompts, serve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32 on
# CUDA cores and HBM bandwidth. A card with a lower power limit is slower.
PEAK_F32_FLOPS = 67e12
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
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, tests/test_kernels.py:47
DEMO_SEQ = (128, 777, 2048)
JSON_SEQ = 777  # the demo prefill length whose times go into the kernels line
N_REQUESTS, SLOTS, MAX_LEN, NEW_TOKENS = 8, 4, 1536, 32


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
    """Least time for one attention forward: max(FLOPs / peak, bytes / bandwidth)."""
    qpos = np.arange(sq) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())  # (query, key) pairs the masks keep
    flops = 2.0 * b * hq * pairs * (d + dv)
    nbytes = itemsize * (b * hq * sq * d + b * hkv * sk * (d + dv) + b * hq * sq * dv)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv)


def phase_kernels():
    """Flash kernel vs its plain version; returns (demo rows, max error at demo shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [c + (c[5],) for c in FLASH_CASES]  # Dv = D
    cases.append((1, 2, 2, 64, 64, 48, True, None, "float32", 32))  # MLA head dims
    cases += EDGE_CASES
    cases += [(1, 12, 4, s, s, 64, True, None, "float32", 64) for s in DEMO_SEQ]
    rows, demo_err = {}, 0.0
    for b, hq, hkv, sq, sk, d, causal, window, dt, dv in cases:
        dtype = getattr(torch, dt)
        q, k, v = _inputs(gen, b, hq, hkv, sq, sk, d, dv, dtype)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        shape = f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} {dt}"
        flags = f"causal={causal} window={window}"
        # allclose with rtol = atol = tol, as tests/test_kernels.py holds the Pallas kernel
        within = (diff <= TOL[dt] * (1 + want.float().abs())).all()
        if not (torch.isfinite(got.float()).all() and within):
            raise AssertionError(f"[kernels] {shape} {flags}: max |err| {err:.3e}, tol {TOL[dt]}")
        log(f"[kernels] flash_attention_fwd {shape} {flags}: max |err| {err:.3e} (tol {TOL[dt]})")
        if (hq, hkv, d) != (12, 4, 64):
            continue
        demo_err = max(demo_err, err)
        scale = d**-0.5

        def library(q=q, k=k, v=v, scale=scale):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True
            )

        lib_err = (library().float() - want.float()).abs().max().item()
        bound, bound_by = attention_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, 4)
        row = {
            "ms": time_ms(lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v, causal=True)),
            "plain_ms": time_ms(lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v), iters=5),
            "library_ms": time_ms(library),
            "bound_ms": bound,
            "bound_by": bound_by,
        }
        rows[sq] = row
        log(
            f"[kernels] demo S={sq}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
            f"library_ms (SDPA, |err| {lib_err:.1e}) {row['library_ms']:.4f}, "
            f"bound {1e3 * bound:.2f} us ({bound_by})"
        )
    return rows, demo_err


def _sequential(model, params, prompt, n, max_len):
    toks = torch.as_tensor(prompt, dtype=torch.long, device="cuda")[None, :]
    logits, cache = model.prefill(params, {"tokens": toks}, pad_to=max_len)
    tok = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(n):
        out.append(int(tok[0]))
        logits, cache = model.decode_step(params, cache, {"token": tok})
        tok = torch.argmax(logits, dim=-1)
    return out


def phase_main_path() -> int:
    """Serve the full-width demo model; returns the flash kernel's launch count."""
    cfg = get_config("serpytor-demo-100m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    model = build(cfg, "cuda")
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, {cfg.param_count()} params")
    prompts = make_prompts(N_REQUESTS, cfg.vocab_size, 64, 1000, seed=0)
    log(f"[main] prompt lengths {[len(p) for p in prompts]}, {NEW_TOKENS} new tokens each")

    # reference first: sequential greedy decoding, one request at a time (also warms up)
    want = {
        f"r{i}": _sequential(model, params, p, NEW_TOKENS, MAX_LEN) for i, p in enumerate(prompts)
    }

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    res = serve(model, params, prompts, new_tokens=NEW_TOKENS, slots=SLOTS, max_len=MAX_LEN)
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()

    done = res["generations"]
    if set(done) != set(want):
        raise AssertionError(f"[main] finished {sorted(done)}, submitted {sorted(want)}")
    for rid, toks in want.items():
        if done[rid].tokens != toks:
            raise AssertionError(f"[main] {rid}: batched {done[rid].tokens} != sequential {toks}")
    expected = cfg.num_layers * len(prompts)
    if launches != expected:
        raise AssertionError(f"[main] flash launches {launches}, expected {expected}")
    log(f"[main] tokens of all {len(done)} requests equal sequential greedy decoding")
    check_against_cpu(cfg, model, params, min(prompts, key=len))
    log(f"[main] flash_attention_fwd launches {launches} = {cfg.num_layers} layers x 8 prefills")
    log(
        f"[main] {res['tokens']} tokens in {res['wall_s']:.4f} s: {res['tok_per_s']:.2f} tok/s; "
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
        raise AssertionError(f"[main] logits {tuple(got.shape)} vs CPU path: max |err| {err:.3e}")
    log(f"[main] prefill logits (S={len(prompt)}) card vs CPU path: max |err| {err:.3e} (tol 1e-4)")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main() -> int:
    smi = phase_device()
    phase_build()
    rows, demo_err = phase_kernels()
    launches = phase_main_path()
    row = rows[JSON_SEQ]
    kernels = [
        {
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:39",
            "launches": launches,
            "max_abs_err": demo_err,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"q(1,12,{JSON_SEQ},64) k,v(1,4,{JSON_SEQ},64) float32 causal",
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    device = {"platform": "gpu", "kind": kind, "count": count}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
