"""Where the float32 flash backward's wgmma kernels spend a walk tile, on one NVIDIA card.

    python3 tools/bwd_probe.py

Builds copies of ``csrc/flash_attention_bwd.cu`` into ``build/bwd_probe/`` and
runs each at the demo's train shape (q, dO (4,12,4096,64), k, v (4,4,4096,64),
causal); the port's library is not touched. Two kinds of copy:

- phases: ``clock64`` stamps before marked lines of the two walk loops (a mark
  missing from the source fails the script: update ``*_MARKS`` after an edit);
  consumer thread 0 of each warpgroup of the first four blocks sums the cycles
  between consecutive marks over its whole walk, and the script prints them a
  tile;
- ablations: the kernels with one piece of work removed (their results are
  wrong; only their times are read): the exponentials, the splits of a walk
  tile, the products over the head dim (S, dP) or over the walk, or two of each
  product's three TF32 passes; and two design choices undone (right results):
  the warpgroup index read from ``threadIdx`` instead of broadcast by a shuffle
  (ptxas then serializes the wgmmas behind the per-tile skip test), and the
  blocks in a 3-D grid's order, tiles fastest. Each prints the backward's ms by CUDA
  events and the dK/dV and dQ launches' device µs; what a piece costs is the
  base's time less its ablation's.

It also prints ptxas's notes on the copies (C75xx: wgmma serialized, waits
injected). About a minute of command; it needs a card, and fails without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "bwd_probe"
DKDV = ("flash_bwd_dkdv_wgmma_kernel(const", "// dQ of ROWS query rows of one head.")
DQ = ("flash_bwd_dq_wgmma_kernel(const", "// A (B*H, rows, cols) float32 tensor as a 3-D")
# (what the cycles up to the mark went to, the line the stamp goes before)
DKDV_MARKS = [
    ("barriers and Q's split by columns", "    // Three commit groups a tile: S^T and dP^T"),
    ("S^T, dP^T issued; S^T waited", "      pin(st);"),
    ("P^T", "      wgmma_fence();\n      product_walk(tv"),
    ("P^T dO issued; dP^T, P^T dO waited", "      pin(dpt);"),
    ("dV summed; dS^T", "      wgmma_fence();\n      product_walk(tk"),
    ("dS^T Q issued", "    consumers_sync();  // the split by rows and dO's by columns are free"),
    ("barrier", "    if (it + 1 < n_tiles) {  // while the tensor cores run dS^T Q"),
    ("next tile's rows split", "    if (!skip) {\n      wgmma_wait_pending<0>();\n      pin(tk);"),
    ("dS^T Q waited; dK summed", "    consumers_sync();  // Q's split by columns is free"),
    ("the walk's end", "  store_acc(dk + kv_head * sk * d, dka"),
]
DQ_MARKS = [
    ("barriers and K's split by columns", "    // Two commit groups, S and dP"),
    ("S, dP issued; S waited", "      pin(s);"),
    ("P; dP waited", "      pin(dp);"),
    ("dS", "      wgmma_fence();\n      product_walk(tq"),
    ("dS K issued", "    consumers_sync();  // the split by rows is free"),
    ("barrier", "    if (it + 1 < n_tiles) {\n      mbar_wait(full((it + 1) % STAGES)"),
    ("next tile's rows split", "    if (!skip) {\n      wgmma_wait_pending<0>();\n      pin(tq);"),
    ("dS K waited; dQ summed", "    consumers_sync();  // the split by columns is free"),
    ("the walk's end", "  store_acc(dq + head * sq * d, dqa"),
]
S3 = """    wgmma_n32(c, kdesc(a_lo + ao), kdesc(b_hi + bo), kk != 0);
    wgmma_n32(c, kdesc(a_hi + ao), kdesc(b_lo + bo), 1);
    wgmma_n32(c, kdesc(a_hi + ao), kdesc(b_hi + bo), 1);"""
W3 = """    wgmma_n64_rs(t, xl[j], kdesc(b_hi + 32 * j), j != 0);
    wgmma_n64_rs(t, xh[j], kdesc(b_lo + 32 * j), 1);
    wgmma_n64_rs(t, xh[j], kdesc(b_hi + 32 * j), 1);"""
SPLIT_ROWS = """    store_split(hi, lo, (c >> 5) * ROWS_CHUNK + sw128(r, c & 31),
                *reinterpret_cast<const float4*>(raw + r * COLS + c));"""
SPLIT_WALK = """    store_split(hi, lo, sw128(n, 4 * u),
                make_float4(col[0], col[2 * COLS], col[4 * COLS], col[6 * COLS]));"""
# name -> (text, replacement) edits of the source
ABLATIONS = {
    "base": [],
    "no exponentials": [
        ("expf(st[4 * nt + e] * scale - lb[col])", "(st[4 * nt + e] * scale - lb[col])"),
        ("expf(s[4 * nt + e] * scale - (e < 2 ? lse0 : lse1))",
         "(s[4 * nt + e] * scale - (e < 2 ? lse0 : lse1))"),
    ],
    "no splits by rows": [(SPLIT_ROWS, "    (void)raw, (void)hi, (void)lo, (void)r, (void)c;")],
    "no splits by columns": [(SPLIT_WALK, "    (void)col, (void)hi, (void)lo, (void)n, (void)u;")],
    "no products over the head dim": [
        (S3, "    if (kk == 0) wgmma_n32(c, kdesc(a_lo + ao), kdesc(b_hi + bo), 0);")
    ],
    "no products over the walk": [(W3, "    if (j == 0) wgmma_n64_rs(t, xl[j], kdesc(b_hi), 0);")],
    "one TF32 pass a product": [
        (S3, "    wgmma_n32(c, kdesc(a_hi + ao), kdesc(b_hi + bo), kk != 0);"),
        (W3, "    wgmma_n64_rs(t, xh[j], kdesc(b_hi + 32 * j), j != 0);"),
    ],
    # the two choices that mattered most, undone
    "warpgroup index not broadcast": [("wgi = consumer_warpgroup(),", "wgi = ctid / 128,")],
    "blocks with the tiles fastest": [
        ("""  const int heads = hkv * batch;
  const int hk = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = (blockIdx.x / heads) * ROWS, off = sk - sq;""",
         """  const int heads = hkv * batch, tiles_ = (int)gridDim.x / heads;
  const int hk = blockIdx.x / tiles_ % hkv, b = blockIdx.x / tiles_ / hkv, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = (blockIdx.x % tiles_) * ROWS, off = sk - sq;"""),
        ("""  const int q0 = ((sq + ROWS - 1) / ROWS - 1 - (int)blockIdx.x / heads) * ROWS;
  const int h = blockIdx.x % heads % hq, b = blockIdx.x % heads / hq, hk = h / (hq / hkv);""",
         """  const int tiles_ = (sq + ROWS - 1) / ROWS;
  const int q0 = (tiles_ - 1 - (int)blockIdx.x % tiles_) * ROWS;
  const int h = blockIdx.x / tiles_ % hq, b = blockIdx.x / tiles_ / hq, hk = h / (hq / hkv);"""),
    ],
}


def _edit(src: str, edits) -> str:
    """Every occurrence of each text replaced; a text the source lacks fails the script."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"bwd_probe: {old[:60]!r} not in the source")
        src = src.replace(old, new)
    return src


def _stamp(src: str, span, marks, slot: int) -> str:
    """Stamps in the walk loop of one kernel (its source between the two span texts)."""
    a, b = src.index(span[0]), src.index(span[1])
    body = src[a:b]
    loop = "\n  for (int it = 0; it < n_tiles; ++it) {"
    if body.count(loop) != 1:
        raise SystemExit("bwd_probe: the consumers' walk loop moved")
    body = body.replace(loop, "\n  long long pt_ = clock64(), pa_[16] = {};" + loop)
    for i, (_, anchor) in enumerate(marks):
        if body.count(anchor) != 1:
            raise SystemExit(f"bwd_probe: mark {anchor!r} found {body.count(anchor)} times")
        ind = anchor[: len(anchor) - len(anchor.lstrip())]
        stamp = f"{ind}{{ const long long t_ = clock64(); pa_[{i}] += t_ - pt_; pt_ = t_; }}\n"
        body = body.replace(anchor, stamp + anchor)
    last = marks[-1][1]
    body = body.replace(
        last,
        "  if (tid == 0 && blockIdx.x < 4) {\n"
        f"    for (int i = 0; i < 16; ++i) g_phase[{slot}][blockIdx.x][wgi][i] = pa_[i];\n"
        f"    g_tiles[{slot}][blockIdx.x] = n_tiles;\n  }}\n" + last,
    )
    return src[:a] + body + src[b:]


def _phases_source(src: str) -> str:
    src = src.replace(
        '#include "mma_tf32.cuh"',
        '#include "mma_tf32.cuh"\n__device__ long long g_phase[2][4][2][16];\n'
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


def _build_copies(sources, filename="flash_attention_bwd.cu", out=OUT):
    """Compile each copy (as ``filename`` in a directory of its own under ``out``) with the
    port's flags, one nvcc each, in parallel."""
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        d = out / f"copy{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / filename).write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o", str(d / "lib.so"),
               str(d / filename)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d / "lib.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"bwd_probe: {name} failed to build:\n{log}")
        notes = sorted({line.split(")")[0] + ")" for line in log.splitlines() if "(C75" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "bytes spill" in line})
        cs.log(f"[bwd_probe] built {name}; ptxas notes: {', '.join(notes) or 'none'}; "
               f"{' | '.join(spills)}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    cs.phase_device()
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    sources = {name: _edit(src, edits) for name, edits in ABLATIONS.items()}
    sources["phases"] = _phases_source(src)
    libs = _build_copies(sources)
    b, hq, hkv, sq, sk, d, causal, window, _, dv = cs.FLASH_BWD_TRAIN
    q, k, v, dout, out, lse = cs._flash_bwd_inputs(cs._gen(7), cs.FLASH_BWD_TRAIN)
    dq, dk, dvv, delta = (torch.empty_like(x) for x in (q, k, v, lse))
    for name, lib in libs.items():
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float]
        fn.argtypes += [ctypes.c_void_p]
        ptrs = [x.data_ptr() for x in (q, k, v, out, lse, dout, delta, dq, dk, dvv)]
        dims = (b, hq, hkv, sq, sk, d, dv, int(causal), window or 0)

        def run(fn=fn, ptrs=ptrs, dims=dims):
            err = fn(*ptrs, *dims, d**-0.5, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"bwd_probe: launch failed: CUDA error {err}")

        if name != "phases":
            ms = cs.time_ms(run, iters=10)
            kv_us = cs.device_us(run, "flash_bwd_dkdv_wgmma", launches=5)
            q_us = cs.device_us(run, "flash_bwd_dq_wgmma", launches=5)
            cs.log(f"[bwd_probe] {name}: {ms:.4f} ms; dK/dV {kv_us:.1f} us, dQ {q_us:.1f} us")
            continue
        run()
        torch.cuda.synchronize()
        buf, tiles = (ctypes.c_longlong * (2 * 4 * 2 * 16))(), (ctypes.c_int * 8)()
        lib.repro_phases(buf, tiles)
        for slot, (kernel, marks) in enumerate((("dK/dV", DKDV_MARKS), ("dQ", DQ_MARKS))):
            for blk in range(4):
                n = max(tiles[slot * 4 + blk], 1)
                for wgi in range(2):
                    at = ((slot * 4 + blk) * 2 + wgi) * 16
                    cyc = [buf[at + i] / n for i in range(len(marks))]
                    parts = "; ".join(f"{m} {c:.0f}" for (m, _), c in zip(marks, cyc))
                    cs.log(f"[bwd_probe] {kernel} block {blk} warpgroup {wgi}: {n} tiles, "
                           f"{sum(cyc):.0f} cycles a tile: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
