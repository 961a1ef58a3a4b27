"""The WKV6 kernels alone, on one NVIDIA card.

    python3 tools/wkv6_check.py

Builds ``csrc/wkv6.cu`` alone and prints ptxas's report (registers, spills,
static shared memory of each instantiation) and the dynamic shared memory a
chunk-kernel block requests, then runs the WKV6 part of ``chip_smoke.py``'s
kernel phase: every case against the plain version at its tolerance with the
path that served it, the determinism check of both paths, the wrapper's host
cost a decode call, and the timed rows at rwkv6-7b's shapes. Then the numbers
behind the wrapper's stream/chunk threshold: device time a launch of each path
for T from 1 to 32 at the decode batch. About a minute; the first check after
an edit to the WKV6 kernels. It needs a card and a checkout of the repository,
and fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

SWEEP_T = (1, 2, 4, 8, 16, 32)


def _device_us(fn, launches: int = 50) -> float:
    """Device time of one WKV6 launch in us, from torch.profiler over ``launches`` calls."""
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
        if e.device_type == torch.autograd.DeviceType.CUDA and "wkv6" in e.key
    )
    return us / launches


def _forced(path: str):
    """``wkv6.path_for`` answering ``path`` for every T (for the sweep only)."""
    return 0 if path == "chunk" else 1 << 30


def sweep_paths(gen) -> None:
    keep = wk.STREAM_MAX_T
    for t in SWEEP_T:
        r, k, v, w, u, h0 = cs._wkv6_inputs(gen, 4, 64, t, 64, 64, torch.bfloat16, True)
        want = ref.wkv6_chunked_ref(r, k, v, w, u, initial_state=h0)
        times, errs = {}, {}
        for path in ("stream", "chunk"):
            wk.STREAM_MAX_T = _forced(path)
            got = wk.wkv6_chunked(r, k, v, w, u, initial_state=h0)
            cs._check(f"wkv6 {path} T={t}", got[0], want[0], cs.TOL["bfloat16"])
            # the stream kernel steps row by row, the plain version sums a chunk at once:
            # their float32 states part by more for T > 1 (logged; held where served)
            errs[path] = (got[1] - want[1]).abs().max().item()
            if path == wk.path_for(t):
                cs._check(f"wkv6 {path} T={t} state", got[1], want[1], cs.TOL["float32"])
            times[path] = _device_us(lambda: wk.wkv6_chunked(r, k, v, w, u, initial_state=h0))
        wk.STREAM_MAX_T = keep
        cs.log(
            f"[sweep] (4, 64, {t}, 64, 64) bfloat16: device us a launch, stream "
            f"{times['stream']:.2f}, chunk {times['chunk']:.2f}; state max |err| stream "
            f"{errs['stream']:.3e}, chunk {errs['chunk']:.3e}; the wrapper takes the "
            f"{wk.path_for(t)} path"
        )


def main() -> int:
    t0 = time.monotonic()
    cs.phase_device()
    seconds = _build.build(["wkv6"])
    cs.log(f"[build] wkv6 in {seconds['wkv6']:.1f} s; ptxas:")
    cs.log((_build.build_dir() / "wkv6.log").read_text().strip())
    lib = wk._lib()
    for is_bf16 in (1, 0):
        cs.log(
            f"[build] chunk kernel, {'bfloat16' if is_bf16 else 'float32'}: "
            f"{lib.repro_wkv6_shared_bytes(is_bf16)} bytes of dynamic shared memory a block"
        )
    gen = cs._gen(7)
    cs._wkv6_rows(gen)
    sweep_paths(gen)
    cs.log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
