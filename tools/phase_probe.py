"""Where a block's time goes in the float32 flash and the decode-attention kernels.

    python3 tools/phase_probe.py

Builds copies of ``csrc/flash_attention_fwd.cu`` and ``csrc/decode_attention.cu``
with a ``clock64`` stamp written by thread 0 of block (0, 0, 0) at marked
points (each marked by a line of the source it precedes; the script fails if
a mark is missing), runs each at the demo's and recurrentgemma-9b's shapes,
and prints the cycles from the block's start to each mark, the median of five
launches. A mark inside a loop is stamped at the loop's first pass only. The
copies are for measurement: the port's libraries are not touched. About half a
minute on the card; it needs a card, and fails without one.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "phase_probe"

# (name, line the stamp goes before, stamp only on the loop's first pass)
FLASH_MARKS = [
    ("start", "  const Smem L(BK, d, dv, Q_REGS);", None),
    ("walk found", "  const int q0 = qt * BQ, offset = sk - sq;", None),
    ("first copies landed", "  uint32_t qh[Q_REGS ? 8 : 1][4], ql[Q_REGS ? 8 : 1][4];", None),
    ("Q fragments", "  float acc[DVT][4];", None),
    ("first tile split", "  for (int t = t_begin; t < t_end; ++t) {", None),
    ("first S", "      // scale; mask only a tile that an edge cuts", "t == t_begin"),
    ("first softmax", "      // O += P V. P stays in registers", "t == t_begin"),
    ("first P.V", "    if (t + 1 < t_end) {  // split the next tile", "t == t_begin"),
    ("walk done", "  l0 = quad_sum(l0);\n  l1 = quad_sum(l1);\n  if (!rows_live) return;", None),
]
DECODE_MARKS = [
    ("start", "  const Layout<T, DT> L(d);", None),
    ("Q fragments", "  // this warp's ring: stage s holds GROUP K rows", None),
    ("copies issued", "  float acc[DT][4];", None),
    ("first group landed", "    const T* kt = stage_k(i % STAGES);", "i == 0"),
    ("first S", "    // online softmax; slots past the block's valid end", "i == 0"),
    ("first P.V", "    __syncwarp();  // every lane is done with this stage", "i == 0"),
    ("groups done", "  // The warps' partials, then the block's", None),
    ("warps merged", "  // The cluster's blocks merged in split order", None),
    ("splits' weights", "  const int cw = ", None),
    ("out written", "  cluster.sync();  // the other blocks have read", None),
]


def _instrument(src: str, marks, block0: str, entry_guard: str) -> str:
    src = src.replace(
        '#include "mma_tf32.cuh"',
        f'#include "{CSRC / "mma_tf32.cuh"}"\n__device__ long long g_stamp[16];',
    )
    for i, (_, anchor, first_only) in enumerate(marks):
        if src.count(anchor) != 1:
            raise SystemExit(f"phase_probe: mark {anchor!r} found {src.count(anchor)} times")
        cond = f"threadIdx.x == 0 && {block0}" + (f" && {first_only}" if first_only else "")
        indent = anchor[: len(anchor) - len(anchor.lstrip())]
        src = src.replace(anchor, f"{indent}if ({cond}) g_stamp[{i}] = clock64();\n{anchor}")
    return src.replace(
        entry_guard,
        "int repro_stamps(void* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n}\n" + entry_guard,
    )


def _build_copy(name: str, src: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def _stamps(lib, marks, launch, reps: int = 5):
    runs = []
    for _ in range(reps):
        assert launch() == 0
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 16)()
        lib.repro_stamps(buf)
        runs.append([buf[i] - buf[0] for i in range(len(marks))])
    return [statistics.median(r[i] for r in runs) for i in range(len(marks))]


def _show(tag, marks, cycles):
    parts = [f"{name} {c:.0f}" for (name, _, _), c in zip(marks[1:], cycles[1:])]
    print(f"[phase_probe] {tag}: cycles from the block's start: " + "; ".join(parts), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe: no CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    guard = "const char* repro_cuda_error_string(int err) {"

    src = (CSRC / "flash_attention_fwd.cu").read_text()
    flash = _build_copy(
        "flash", _instrument(src, FLASH_MARKS, "blockIdx.x == 0 && blockIdx.y == 0", guard)
    )
    fn = flash.repro_flash_attention_fwd
    fn.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float] + [i32] * 3 + [ptr]
    for b, hq, hkv, s, d, win in ((1, 12, 4, 777, 64, None), (1, 16, 1, 3000, 256, 2048)):
        q = torch.randn(b, hq, s, d, device="cuda", generator=gen)
        k = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
        v = torch.randn(b, hkv, s, d, device="cuda", generator=gen)
        o = torch.empty_like(q)
        split, items = fa.f32_plan(s, s, True, win, d, d)
        ws = torch.empty(b * hq * items * fa.F32_BLOCK_Q * (d + 2), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ws.data_ptr(), None, None,
                b, hq, hkv, s, s, d, d, 1, win or 0, d**-0.5, split, items, 0, stream)
        _show(f"flash f32 q{tuple(q.shape)} window={win} (block 0: the last query tile's first "
              f"piece)", FLASH_MARKS, _stamps(flash, FLASH_MARKS, lambda: fn(*args)))

    src = (CSRC / "decode_attention.cu").read_text()
    block0 = "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
    dec = _build_copy("decode", _instrument(src, DECODE_MARKS, block0, guard))
    fn = dec.repro_decode_attention
    fn.argtypes = [ptr] * 5 + [i32] * 7 + [ctypes.c_float, i32, ptr]
    for b, h, kv, sc, d, dt, pos in ((4, 12, 4, 1536, 64, "float32", (1031, 5, 1535, 1600)),
                                     (4, 16, 1, 2048, 256, "bfloat16", (2250, 100, 2047, 4000))):
        dtype = getattr(torch, dt)
        q = torch.randn(b, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, sc, kv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, sc, kv, d, device="cuda", generator=gen).to(dtype)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        ring = sc if dt == "bfloat16" else 0
        stream = torch.cuda.current_stream().cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), out.data_ptr(), b, h, kv,
                sc, d, ring, da.split_plan(sc)[1], d**-0.5, int(dt == "bfloat16"), stream)
        _show(f"decode {dt} q{tuple(q.shape)} cache{tuple(k.shape)} (block 0 of slot 0)",
              DECODE_MARKS, _stamps(dec, DECODE_MARKS, lambda: fn(*args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
