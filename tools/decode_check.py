"""The cached-decode attention kernel alone, on one NVIDIA card.

    python3 tools/decode_check.py

Builds ``csrc/decode_attention.cu`` alone and prints ptxas's report
(registers, shared memory, spills of each instantiation), then runs the
decode part of ``chip_smoke.py``'s kernel phase: every case against the plain
version with the share of its tolerance used, the timed rows at the demo's and
recurrentgemma-9b's decode shapes (device time a call by ``torch.profiler``,
the plain version's ops, SDPA, the bound) and the determinism check (two
launches; a slot alone against its row in a batch of 4). The quickest check
after an edit to the kernel. It needs a card and a checkout of the repository,
and fails as ``chip_smoke.py`` does.
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
    seconds = _build.build(["decode_attention"])
    cs.log(f"[build] decode_attention in {seconds['decode_attention']:.1f} s; ptxas:")
    cs.log((_build.build_dir() / "decode_attention.log").read_text().strip())
    cs._decode_attention_rows(cs._gen(7))
    cs.log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
