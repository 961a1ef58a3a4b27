"""Throughput of the tensor cores on one NVIDIA card: ``mma.sync`` TF32 m16n8k8 and
bfloat16 m16n8k16, and ``wgmma`` TF32 m64nNk8.

    python3 tools/mma_probe.py

Builds ``tools/mma_probe.cu`` with nvcc and runs one block on each SM. For
``mma.sync`` each warp issues 8 independent accumulations in a loop, at 1, 2,
4, 8 and 16 warps an SM; it prints clock64 cycles a product for one warp, cycles
a product for a sub-partition (4 an SM), and the card's rate by CUDA events in
TFLOP/s. For ``wgmma`` (TF32 m64n64k8 and m64n32k8 with both operands in shared
memory, m64n64k8 with A in registers: the forms the float32 flash backward
runs) each warpgroup issues 16 instructions on two accumulators, commits and
waits, in a loop, at 1, 2 and 3 warpgroups an SM; it prints cycles an
instruction for one warpgroup and the card's rate. The numbers bound what the
float32 kernels, which run their products in 3xTF32, can reach. About 20 s of
command on the card; it needs a card, and fails without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: no CUDA card")
    out_dir = ROOT / "build" / "mma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmma_probe.so"
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(ROOT / "tools/mma_probe.cu")],
        check=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_mma_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    print(f"[mma_probe] {torch.cuda.get_device_name(0)}, {sms} SMs, 8 chains a warp, {iters} loops")
    shapes = ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8), (1, "bf16 m16n8k16", 2 * 16 * 8 * 16))
    for kind, name, flops in shapes:
        for warps in (1, 2, 4, 8, 16):
            threads = 32 * warps
            out = torch.empty(sms * threads, device="cuda")
            cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            args = (kind, sms, threads, iters, out.data_ptr(), cycles.data_ptr(), stream)
            assert lib.repro_mma_probe(*args) == 0
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            assert lib.repro_mma_probe(*args) == 0
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            per_warp = cycles.float().median().item() / (iters * 8)
            per_sp = per_warp / max(1, warps / 4)
            tflops = sms * warps * iters * 8 * flops / (ms * 1e-3) / 1e12
            print(
                f"[mma_probe] {name}: {warps} warps an SM: {per_warp:.2f} cycles a product a "
                f"warp, {per_sp:.2f} a sub-partition; {tflops:.1f} TFLOP/s ({ms:.3f} ms)"
            )
    wgmma = ((2, "wgmma tf32 m64n64k8 SS", 64), (3, "wgmma tf32 m64n32k8 SS", 32))
    for kind, name, n in wgmma + ((4, "wgmma tf32 m64n64k8 RS", 64),):
        flops = 2 * 64 * n * 8
        for groups in (1, 2, 3):
            threads = 128 * groups
            out = torch.empty(sms * threads, device="cuda")
            cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            args = (kind, sms, threads, iters, out.data_ptr(), cycles.data_ptr(), stream)
            assert lib.repro_mma_probe(*args) == 0
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            assert lib.repro_mma_probe(*args) == 0
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            per_group = cycles.float().median().item() / (iters * 16)
            tflops = sms * groups * iters * 16 * flops / (ms * 1e-3) / 1e12
            print(
                f"[mma_probe] {name}: {groups} warpgroups an SM: {per_group:.2f} cycles an "
                f"instruction a warpgroup; {tflops:.1f} TFLOP/s ({ms:.3f} ms)"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
