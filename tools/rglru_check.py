"""The RG-LRU kernels alone, on one NVIDIA card.

    python3 tools/rglru_check.py

Builds ``csrc/rglru_scan.cu`` alone and prints ptxas's report (registers,
spills, shared memory of each instantiation), then runs the RG-LRU part of
``chip_smoke.py``'s kernel phase: every case against the plain version bit for
bit with the path that served it, the determinism check of both paths, and the
timed rows at recurrentgemma-9b's prefill and decode shapes. Then the numbers
behind the wrapper's step/ring threshold: device time a launch of each path
for T from 1 to 64 at batch 1 and at the decode batch of 4 (W = 4096, bfloat16
x, with an initial state). About a minute; the first check after an edit to
the RG-LRU kernels. It needs a card and a checkout of the repository, and fails
as ``chip_smoke.py`` does.
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
from repro_torch.kernels import rglru as rg  # noqa: E402

SWEEP_T = (1, 2, 4, 8, 16, 24, 32, 48, 64)
SWEEP_B = (1, 4)


def _forced(path: str) -> int:
    """``rglru.STEP_MAX_T`` that makes ``path_for`` answer ``path`` for every T (sweep only)."""
    return 1 << 30 if path == "step" else 0


def sweep_paths(gen) -> None:
    keep = rg.STEP_MAX_T
    for b in SWEEP_B:
        for t in SWEEP_T:
            x, a, h0 = cs._rglru_inputs(gen, b, t, 4096, torch.bfloat16, True)
            want = ref.rglru_ref(x, a, initial_state=h0)
            times = {}
            for path in ("step", "ring"):
                rg.STEP_MAX_T = _forced(path)
                got = rg.rglru_scan(x, a, initial_state=h0)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"[sweep] {path} path, B={b} T={t}: not the plain bits")
                times[path] = cs.device_us(
                    lambda x=x, a=a, h0=h0: rg.rglru_scan(x, a, initial_state=h0), "rglru"
                )
            rg.STEP_MAX_T = keep
            cs.log(
                f"[sweep] ({b}, {t}, 4096) bfloat16 with h0: device us a launch, step "
                f"{times['step']:.2f}, ring {times['ring']:.2f}; both bit for bit; the wrapper "
                f"takes the {rg.path_for(t)} path"
            )


def main() -> int:
    t0 = time.monotonic()
    cs.phase_device()
    seconds = _build.build(["rglru_scan"])
    cs.log(f"[build] rglru_scan in {seconds['rglru_scan']:.1f} s; ptxas:")
    cs.log((_build.build_dir() / "rglru_scan.log").read_text().strip())
    gen = cs._gen(7)
    cs._rglru_rows(gen)
    sweep_paths(gen)
    cs.log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
