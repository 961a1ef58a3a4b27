"""A model served by two checkouts in turns, on one NVIDIA card.

    python3 tools/ab_hybrid.py OTHER_CHECKOUT [--phase hybrid|rwkv]

OTHER_CHECKOUT is another tree of this repository, for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). The script runs ``chip_smoke.py``'s device, build and serving
phases of the other tree and of this one in turns (other, this, this, other),
each in a process of its own, so that both sides see the same card and host.
The serving phase is recurrentgemma-9b's (``--phase hybrid``, the default),
rwkv6-7b's (``--phase rwkv``) or serpytor-demo-100m's (``--phase demo``).
Each run prints its own lines (serving numbers, checks, profiles); at the end
the script prints every run's mean prefill, decode ms/step and tokens/s side
by side. A run that fails stops the script with its exit code.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = "import chip_smoke as cs; cs.phase_device(); cs.phase_build(); cs.phase_{}()"
SERVING = (  # the serving line of phase {}, as chip_smoke.py logs it
    r"\[{}\] \d+ tokens in [\d.]+ s: ([\d.]+) tok/s; prefill ([\d.]+) ms mean; "
    r"decode ([\d.]+) ms/step"
)


def run(tree: Path, label: str, phase: str) -> dict:
    print(f"[ab] {label}: {tree}", flush=True)
    proc = subprocess.run(
        [sys.executable, "-c", PHASES.format(phase)],
        cwd=tree,
        capture_output=True,
        text=True,
        timeout=900,
    )
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    found = re.search(SERVING.format(phase), proc.stdout)
    if found is None:
        raise SystemExit(f"[ab] {label}: no serving line in its output")
    tok_s, prefill, decode = map(float, found.groups())
    return {"label": label, "prefill_ms_mean": prefill, "decode_ms_per_step": decode,
            "tok_per_s": tok_s}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another checkout of this repository")
    parser.add_argument("--phase", choices=("hybrid", "rwkv", "demo"), default="hybrid")
    args = parser.parse_args()
    other = args.other.resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"[ab] {other} holds no chip_smoke.py")
    sides = [(other, "other"), (ROOT, "this"), (ROOT, "this"), (other, "other")]
    results = [run(tree, label, args.phase) for tree, label in sides]
    for i, r in enumerate(results, 1):
        print(
            f"[ab] run {i} ({r['label']}): prefill {r['prefill_ms_mean']} ms mean, decode "
            f"{r['decode_ms_per_step']} ms/step, {r['tok_per_s']} tok/s",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
