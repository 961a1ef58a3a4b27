"""The bfloat16 flash backward of two checkouts in turns, on one NVIDIA card.

    python3 tools/ab_bwd_bf16.py OTHER_CHECKOUT

OTHER_CHECKOUT is another tree of this repository, for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). Each run, in a process of its own in its own tree, builds that
tree's ``flash_attention_fwd`` and ``flash_attention_bwd_bf16`` kernels and
times ``flash_attention_bwd`` at qwen3-1.7b's train shape (q, dO (2,16,4096,128),
k, v (2,8,4096,128), causal; chip_smoke.py's FLASH_BWD_BF16_TRAIN) by CUDA
events over 20 launches, three times; the runs go other, this, this, other, so
that both trees see the same card and host. It prints each run's times and,
at the end, the two trees' means side by side with their ratio.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN = """
import chip_smoke as cs
from repro_torch.kernels import _build
cs.phase_device()
_build.build(["flash_attention_fwd", "flash_attention_bwd_bf16"])
case = cs.FLASH_BWD_BF16_TRAIN
q, k, v, dout, _, _ = cs._flash_bwd_inputs(cs._gen(7), case)
masks = dict(causal=case[6], window=case[7])
out, lse = cs.fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
for _ in range(3):
    ms = cs.time_ms(lambda: cs.fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks))
    print(f"[ab] ms {ms:.4f}", flush=True)
"""


def run(tree: Path, label: str) -> list:
    print(f"[ab] {label}: {tree}", flush=True)
    proc = subprocess.run(
        [sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True, timeout=900
    )
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    times = [float(x) for x in re.findall(r"^\[ab\] ms ([\d.]+)$", proc.stdout, re.M)]
    if not times:
        raise SystemExit(f"[ab] {label}: no times in its output")
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another checkout of this repository")
    other = parser.parse_args().other.resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"{other} is no checkout of this repository")
    times = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        times[label] += run(tree, label)
    mean = {k: statistics.mean(v) for k, v in times.items()}
    print(
        f"[ab] flash_attention_bwd bf16 at qwen3-1.7b's train shape: other {mean['other']:.4f} "
        f"ms (runs {', '.join(f'{x:.4f}' for x in times['other'])}), this {mean['this']:.4f} ms "
        f"(runs {', '.join(f'{x:.4f}' for x in times['this'])}); this / other "
        f"{mean['this'] / mean['other']:.4f}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
