"""The flash-attention kernels alone, on one NVIDIA card.

    python3 tools/flash_check.py

Builds ``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_bf16.cu`` alone and prints ptxas's report
(registers, shared memory, spills of each instantiation), the dynamic
shared memory a block of the backward's wgmma kernels asks for (float32 and
bfloat16) and what ptxas holds against the bfloat16 ones (spills, wgmma
serialized), then runs the
flash part of ``chip_smoke.py``'s kernel phase: the backward first (every case
against its plain version at its tolerance and the share of it used, the
forward's logsumexp, the determinism check, the timed rows at the demo's train
shape; then the same for the bfloat16 backward, timed at qwen3-1.7b's train
shape beside SDPA's flash backward with its float64 yardstick, and the float32
backward timed at head dim 128), then the
forward (every case, with the path that served it, the determinism checks
of both paths, bfloat16 on wgmma and float32 in 3xTF32, and the timed rows
at the demo's and recurrentgemma-9b's shapes). About a minute and a half;
the quickest check after an edit to a flash kernel. Between the two, a
float64 yardstick at the train shape (batch row 0, the first KV head's
group of 3 query heads): the backward kernels' and the plain backward's
errors against float64 autograd through the dense oracle, to tell which of
the two float32 results carries the difference between them. It needs a
card and a checkout of the repository, and fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def float64_yardstick() -> None:
    """Kernel and plain backward against float64 gradients, one group at the train shape."""
    case = cs.FLASH_BWD_TRAIN
    _, hq, hkv, _, _, _, causal, window, _, _ = case
    q, k, v, dout, out, lse = cs._flash_bwd_inputs(cs._gen(11), case)
    g = hq // hkv
    q, dout, out, lse = (x[:1, :g].contiguous() for x in (q, dout, out, lse))
    k, v = k[:1, :1].contiguous(), v[:1, :1].contiguous()
    masks = dict(causal=causal, window=window)
    kernel = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
    x64 = [x.double().requires_grad_(True) for x in (q, k, v)]
    o64 = ref.flash_attention_dense_ref(*x64, **masks)
    want = torch.autograd.grad(o64, x64, dout.double())

    def err(got):
        return ", ".join(
            f"{n} {(a.double() - w).abs().max().item():.3e} "
            f"({100 * cs._tol_used(a.double(), w, cs.BWD_TOL):.2f}% of BWD_TOL)"
            for n, a, w in zip(("dq", "dk", "dv"), got, want)
        )

    cs.log(f"[float64] q{tuple(q.shape)} k{tuple(k.shape)}: kernels {err(kernel)}")
    cs.log(f"[float64] q{tuple(q.shape)} k{tuple(k.shape)}: plain backward {err(plain)}")


def main() -> int:
    t0 = time.monotonic()
    cs.phase_device()
    names = ["flash_attention_bwd", "flash_attention_bwd_bf16", "flash_attention_fwd"]
    seconds = _build.build(names)
    for name in names:
        cs.log(f"[build] {name} in {seconds[name]:.1f} s; ptxas:")
        cs.log((_build.build_dir() / f"{name}.log").read_text().strip())
    shared = _build.load("flash_attention_bwd").repro_flash_attention_bwd_shared_bytes
    cs.log(
        f"[build] wgmma backward: dK/dV {shared(1)} bytes, dQ {shared(0)} bytes of dynamic "
        "shared memory a block (232,448 at most)"
    )
    shared = _build.load("flash_attention_bwd_bf16").repro_flash_attention_bwd_bf16_shared_bytes
    cs.log(
        f"[build] bfloat16 backward: {shared(64, 64)} bytes (head dims up to 64), "
        f"{shared(128, 128)} (up to 128) of dynamic shared memory a block of either walk kernel"
    )
    report = (_build.build_dir() / "flash_attention_bwd_bf16.log").read_text()
    faults = "; ".join(cs._ptxas_faults(report, cs.BF16_WGMMA_KERNELS))
    faults = faults or "no spills, no wgmma serialized"
    cs.log(f"[build] bfloat16 backward's wgmma kernels: {faults}")
    cs._flash_bwd_rows(cs._gen(7))
    cs._flash_bwd_bf16_rows(cs._gen(7))
    float64_yardstick()
    cs._flash_rows(cs._gen(7))
    cs.log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
