"""The bfloat16 flash backward of two checkouts in turns, on one NVIDIA card.

    python3 tools/ab_bwd_bf16.py OTHER_CHECKOUT [--hd256] [--parts N[,N...]]

OTHER_CHECKOUT is another tree of this repository, for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). Each run, in a process of its own in its own tree, builds that
tree's ``flash_attention_fwd`` and ``flash_attention_bwd_bf16`` kernels and
times ``flash_attention_bwd`` by CUDA events over 20 launches, three times, then
each of its launches' device time (``torch.profiler`` over 10 calls). The shape
is qwen3-1.7b's train shape (q, dO (2,16,4096,128), k, v (2,8,4096,128), causal;
chip_smoke.py's FLASH_BWD_BF16_TRAIN), or with ``--hd256`` recurrentgemma-9b's
(q, dO (1,16,4096,256), k, v (1,1,4096,256), causal, window 2048;
FLASH_BWD_HD256_TRAIN), which runs the split builds. ``--parts N,M,...`` times
this tree's split builds with each key tile's walk cut into N parts, then M, ...
instead of what ``flash_attention.bwd_split_plan`` chooses (the other tree runs
as it is). The runs go other, this, this, other, so that both trees see the same
card and host. It prints each run's times and, at the end, the two trees' means
side by side with their ratio (one line for each number of parts).
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
import collections, torch
import chip_smoke as cs
from repro_torch.kernels import _build
cs.phase_device()
_build.build(["flash_attention_fwd", "flash_attention_bwd_bf16"])
case = cs.{case}
q, k, v, dout, _, _ = cs._flash_bwd_inputs(cs._gen(7), case)
masks = dict(causal=case[6], window=case[7])
fwd = cs.fa.flash_attention_fwd(q, k, v, return_lse=True, **masks)
out, lse = fwd[-1 if len(fwd) == 3 else 0], fwd[1]  # the float32 output where the tree gives it
def call():
    return cs.fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
plan = getattr(cs.fa, "bwd_split_plan", None)
for parts in {parts}:
    if parts:
        cs.fa.bwd_split_plan = lambda *args: parts
    for _ in range(3):
        print(f"[ab] parts {{parts}} ms {{cs.time_ms(call):.4f}}", flush=True)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    us = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "flash_bwd" in e.key:
            us[re.search(r"flash_bwd\\w*", e.key).group(0)] += e.self_device_time_total / 10
    print(
        f"[ab] parts {{parts}} device us a call: "
        + ", ".join(f"{{n}} {{t:.2f}}" for n, t in us.items()),
        flush=True,
    )
    cs.fa.bwd_split_plan = plan
"""


def run(tree: Path, label: str, case: str, parts: list) -> dict:
    """{parts: [ms, ...]} of one run in ``tree`` (parts 0: the tree's own plan)."""
    print(f"[ab] {label}: {tree}", flush=True)
    code = "import re\n" + RUN.format(case=case, parts=parts)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, timeout=900
    )
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(proc.returncode)
    times = {n: [] for n in parts}
    for n, ms in re.findall(r"^\[ab\] parts (\d+) ms ([\d.]+)$", proc.stdout, re.M):
        times[int(n)].append(float(ms))
    if not all(times.values()):
        raise SystemExit(f"[ab] {label}: no times in its output")
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another checkout of this repository")
    parser.add_argument("--hd256", action="store_true", help="recurrentgemma-9b's train shape")
    parser.add_argument(
        "--parts", default="0", help="this tree's split builds' parts, a comma list (0: the plan)"
    )
    args = parser.parse_args()
    parts = [int(x) for x in args.parts.split(",")]
    other = args.other.resolve()
    if not (other / "chip_smoke.py").exists():
        raise SystemExit(f"{other} is no checkout of this repository")
    case = "FLASH_BWD_HD256_TRAIN" if args.hd256 else "FLASH_BWD_BF16_TRAIN"
    shape = "recurrentgemma-9b's" if args.hd256 else "qwen3-1.7b's"
    other_ms, this_ms = [], {n: [] for n in parts}
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        if label == "other":
            other_ms += run(tree, label, case, [0])[0]
        else:
            for n, ms in run(tree, label, case, parts).items():
                this_ms[n] += ms
    base = statistics.mean(other_ms)
    for n, ms in this_ms.items():
        mean = statistics.mean(ms)
        print(
            f"[ab] flash_attention_bwd bf16 at {shape} train shape"
            + (f" (this tree at {n} parts)" if n else "")
            + f": other {base:.4f} ms (runs {', '.join(f'{x:.4f}' for x in other_ms)}), "
            f"this {mean:.4f} ms (runs {', '.join(f'{x:.4f}' for x in ms)}); "
            f"this / other {mean / base:.4f}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
