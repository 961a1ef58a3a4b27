"""Where the bfloat16 flash backward's wgmma kernels spend their time, on one NVIDIA card.

    python3 tools/bwd_bf16_probe.py

Builds copies of ``csrc/flash_attention_bwd_bf16.cu`` into ``build/bwd_bf16_probe/`` and
runs each at qwen3-1.7b's train shape (q, dO (2,16,4096,128), k, v (2,8,4096,128), causal);
the port's library is not touched. Three kinds of copy:

- variants, whose gradients must equal the base's bit for bit: two or three ring stages
  instead of four, dS^T computed only once P^T dO has ended, the warpgroup's index read
  from ``threadIdx`` instead of broadcast by a shuffle;
- ablations, with one piece of work removed (their results are wrong; only their times are
  read): the exponentials, the element masks of the cut tiles, the products over the head
  dim (S, dP) or over the walk (dV, dK, dQ) cut to one k-step each;
- phases: ``clock64`` stamps before marked lines of the two walk loops (a mark missing from
  the source fails the script: update ``*_MARKS`` after an edit); consumer thread 0 of each
  warpgroup of the first four blocks (the longest walks) sums the cycles between
  consecutive marks over its walk, and the script prints them a tile.

Each copy prints ptxas's notes on it (C7514, C7515, C7518: wgmma serialized; C7519: waits
injected) and its spills, the backward's ms by CUDA events and the dK/dV and dQ launches'
device µs; what a piece costs is the base's time less its ablation's. About a minute and a
quarter of command; it needs a card, and fails without one.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from bwd_probe import _build_copies, _edit, _stamp  # noqa: E402  (tools/, the script's dir)
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "bwd_bf16_probe"
DKDV = ("flash_bwd_bf16_dkdv_wgmma_kernel(const", "// dQ of OWN query rows of one head.")
DQ = ("flash_bwd_bf16_dq_wgmma_kernel(const", "// Split builds: dK and dV of 64 keys")
# (what the cycles up to the mark went to, the line the stamp goes before)
DKDV_MARKS = [
    ("tile tests", "    mbar_wait(full(s), (it / STAGES) & 1);"),
    ("the tile's full barrier", "      wgmma_fence();\n      product_s<DC>(st"),
    ("S^T, dP^T issued; S^T waited", "      pin(st);"),
    ("P^T", "#pragma unroll\n      for (int c = 0; c < DVC; ++c) pin(dva[c]);\n      wgmma_fence"),
    ("P^T dO issued; dP^T waited", "      pin(dpt);"),
    ("dS^T", "#pragma unroll\n      for (int c = 0; c < DC; ++c) pin(dka[c]);\n      wgmma_fence"),
    ("dS^T Q issued", "      wgmma_commit();\n      wgmma_wait_pending<0>();"),
    ("dS^T Q waited", "    mbar_arrive(empty(s));"),
    ("the walk's end", "  const size_t kv_head = (size_t)b * hkv + hk;\n  store_acc"),
]
DQ_MARKS = [
    ("tile tests", "    mbar_wait(full(s), (it / STAGES) & 1);"),
    ("the tile's full barrier", "      wgmma_fence();\n      product_s<DC>(sc"),
    ("S, dP issued; S waited", "      pin(sc);"),
    ("P; dP waited", "      pin(dp);"),
    ("dS", "#pragma unroll\n      for (int c = 0; c < DC; ++c) pin(dqa[c]);\n      wgmma_fence"),
    ("dS K issued", "      wgmma_commit();\n      wgmma_wait_pending<0>();"),
    ("dS K waited", "    mbar_arrive(empty(s));"),
    ("the walk's end", "  store_acc<DC>(dq + head * sq * d, dqa"),
]
BROADCAST = "const int wgi = consumer_warpgroup(),"
# name -> (text, replacement) edits of the source (tools/bwd_probe.py's ``_edit``); variants keep the base's bits
VARIANTS = {
    "base": [],
    "two stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "three stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "dS^T after P^T dO": [
        ("wgmma_wait_pending<1>();  // dP^T (P^T dO may still run)", "wgmma_wait_pending<0>();")
    ],
    "warpgroup index not broadcast": [(BROADCAST, "const int wgi = (int)threadIdx.x / 128 - 1,")],
}
ABLATIONS = {
    "no exponentials": [
        ("exp2f(st[4 * nt + e] * scale_log2", "(st[4 * nt + e] * scale_log2"),
        ("exp2f(sc[4 * nt + e] * scale_log2", "(sc[4 * nt + e] * scale_log2"),
    ],
    "no element masks": [
        ("probs_kv<true>(", "probs_kv<false>("),
        ("probs_q<true>(", "probs_q<false>("),
    ],
    "products over the head dim: one k-step": [
        ("  for (int kk = 0; kk < NC * 4; ++kk) {", "  for (int kk = 0; kk < 1; ++kk) {")
    ],
    "products over the walk: one k-step": [
        ("  for (int j = 0; j < WALK / 16; ++j)\n    wgmma_bf16_rs_mn(",
         "  for (int j = 0; j < 1; ++j)\n    wgmma_bf16_rs_mn(")
    ],
}


def _phases_source(src: str) -> str:
    src = src.replace(
        '#include "hopper.cuh"',
        '#include "hopper.cuh"\n__device__ long long g_phase[2][4][2][16];\n'
        "__device__ int g_tiles[2][4];",
    )
    src = _stamp(src, DKDV, DKDV_MARKS, 0)
    src = _stamp(src, DQ, DQ_MARKS, 1)
    guard = "const char* repro_cuda_error_string(int err) {"
    return src.replace(
        guard,
        "int repro_phases(void* out, void* tiles) {\n"
        "  cudaMemcpyFromSymbol(tiles, g_tiles, sizeof(g_tiles));\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n" + guard,
    )


def main() -> int:
    cs.phase_device()
    src = (CSRC / "flash_attention_bwd_bf16.cu").read_text()
    sources = {name: _edit(src, edits) for name, edits in {**VARIANTS, **ABLATIONS}.items()}
    sources["phases"] = _phases_source(src)
    libs = _build_copies(sources, "flash_attention_bwd_bf16.cu", OUT)
    case = cs.FLASH_BWD_BF16_TRAIN
    b, hq, hkv, sq, sk, d, causal, window, _, dv = case
    q, k, v, dout, _, _ = cs._flash_bwd_inputs(cs._gen(7), case)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    delta = torch.empty_like(lse)
    base = None
    for name, lib in libs.items():
        fn = lib.repro_flash_attention_bwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float]
        fn.argtypes += [ctypes.c_void_p]
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        ptrs = [x.data_ptr() for x in (q, k, v, out, lse, dout, delta, *grads)]
        dims = (b, hq, hkv, sq, sk, d, dv, int(causal), window or 0)

        def run(fn=fn, ptrs=ptrs, dims=dims):
            err = fn(*ptrs, *dims, d**-0.5, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"bwd_bf16_probe: launch failed: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        if name == "base":
            base = tuple(g.clone() for g in grads)
        if name != "phases":
            same = all(torch.equal(g, w) for g, w in zip(grads, base))
            ms = cs.time_ms(run, iters=10)
            kv_us = cs.device_us(run, "flash_bwd_bf16_dkdv", launches=5)
            q_us = cs.device_us(run, "flash_bwd_bf16_dq", launches=5)
            bits = "the base's bits" if same else "other bits"
            if name in VARIANTS and not same:
                raise AssertionError(f"[bwd_bf16_probe] {name}: gradients differ from the base's")
            cs.log(f"[bwd_bf16_probe] {name}: {ms:.4f} ms; dK/dV {kv_us:.1f} us, dQ {q_us:.1f} "
                   f"us; {bits}")
            continue
        buf, tiles = (ctypes.c_longlong * (2 * 4 * 2 * 16))(), (ctypes.c_int * 8)()
        lib.repro_phases(buf, tiles)
        for slot, (kernel, marks) in enumerate((("dK/dV", DKDV_MARKS), ("dQ", DQ_MARKS))):
            for blk in range(4):
                n = max(tiles[slot * 4 + blk], 1)
                for wgi in range(2):
                    at = ((slot * 4 + blk) * 2 + wgi) * 16
                    cyc = [buf[at + i] / n for i in range(len(marks))]
                    parts = "; ".join(f"{m} {c:.0f}" for (m, _), c in zip(marks, cyc))
                    cs.log(f"[bwd_bf16_probe] {kernel} block {blk} warpgroup {wgi}: {n} tiles, "
                           f"{sum(cyc):.0f} cycles a tile: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
