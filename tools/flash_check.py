"""The flash-attention kernels alone, on one NVIDIA card.

    python3 tools/flash_check.py

Builds ``csrc/flash_attention_fwd.cu`` alone and prints ptxas's report
(registers, shared memory, spills of each instantiation), then runs the
flash part of ``chip_smoke.py``'s kernel phase: every case against the plain
version at its tolerance and the share of it used, with the path that served
it, the determinism checks of both paths (bfloat16 on wgmma, float32 in
3xTF32), and the timed rows (kernel, plain version, SDPA, bound) at the
demo's and recurrentgemma-9b's shapes. About a minute; the
quickest check after an edit to the flash kernel. It needs a card and a
checkout of the repository, and fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    t0 = time.monotonic()
    cs.phase_device()
    seconds = _build.build(["flash_attention_fwd"])
    cs.log(f"[build] flash_attention_fwd in {seconds['flash_attention_fwd']:.1f} s; ptxas:")
    cs.log((_build.build_dir() / "flash_attention_fwd.log").read_text().strip())
    cs._flash_rows(cs._gen(7))
    cs.log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
