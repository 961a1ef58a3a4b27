"""Where the WKV6 backward's launches spend their time, on one NVIDIA card.

    python3 tools/wkv6_bwd_probe.py

Builds copies of ``csrc/wkv6_bwd.cu`` into ``build/wkv6_bwd_probe/`` and runs each, through
the port's wrapper, at rwkv6-7b's train shape (r, k, v, dout (1,64,4096,64) bfloat16 in the
model's (B,T,H,K) layout, w float32, no initial state, no dS_T); the port's library is not
touched. Each copy but the base has one piece of work removed (its gradients are wrong; only
its times are read): the walks' stores of the scratch, their state updates, the logs and
exps of their preparation warps; the chunk pass's logs and exps, its products over 64 (q and
p, kw dS), dw's sums over rows, its copies; or the chunk pass cut short after its copies,
its factors, its 16 x 16 tiles and its products (each phase's cost is the difference of two
cuts). It prints each copy's device µs a launch of the walks and of the chunk pass
(torch.profiler) and its ms a call by CUDA events: what a piece costs is the base's time
less its ablation's. About two minutes of command; it needs a card, and fails
without one.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from bwd_probe import _build_copies, _edit  # noqa: E402  (tools/, the script's dir)
from repro_torch.kernels import wkv6 as wk  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "wkv6_bwd_probe"
SHAPE = (1, 64, 4096, 64, 64, "bfloat16", False, False)  # chip_smoke.WKV_BWD_JSON
# the first line of each phase of the chunk kernel after the copies, and a return before one
CHUNK_PHASE = [
    "  // ---- the chunk's factors: four threads a key channel, four rows each ----",
    "  // ---- the 16 x 16 tiles (warps 0-3, a column tile each) and each row's bonus ----",
    "  // ---- the products over 64 and 16, warp w on columns n0 = 8 w .. (channels i for q, p, x,",
    "  // ---- dw, a thread a (channel i, group z): first the pairs s < m < t of the t in group z,",
]
CUT = "  if (sreg[0] == 1e-30f) du_part[tid] = sreg[1] + sreg[15];\n  return;\n"
# name -> (text, replacement) edits of the source; a text the source lacks fails the script
ABLATIONS = {
    "base": [],
    "walks: no scratch stores": [
        ("if (row < a.kdim && j < a.vdim) out[(size_t)row * a.vp + j] = xr[kb][e];", "")
    ],
    "walks: no state updates": [
        ("if (walk_b || c + 1 < a.n_chunks) {  // walk A's final state is not needed", "if (0) {")
    ],
    "walks: no logs or exps": [
        ("const float lg = logf(fmaxf(st.w[t][kk], 1e-38f));", "const float lg = st.w[t][kk];"),
        (
            "st.a[t][kk] = walk_b ? x * expf(ct - own[i]) : x * expf(last - ct);",
            "st.a[t][kk] = walk_b ? x * (ct - own[i]) : x * (last - ct);",
        ),
        ("if (qq == 0) st.dlast[kk] = expf(last);", "if (qq == 0) st.dlast[kk] = last;"),
    ],
    "chunk: no logs or exps": [
        ("const float lg = logf(fmaxf(sm.w[t][kk], 1e-38f));", "const float lg = sm.w[t][kk];"),
        (
            "const float ee = expf(ct - own[i]), ec = expf(-ct), dec = expf(last - ct);",
            "const float ee = ct - own[i], ec = -ct, dec = last - ct;",
        ),
    ],
    "chunk: no q, p over 64": [
        ("for (int kk = 0; kk < MAX_V / 8; ++kk) {\n      const int j = kk * 8 + 2 * q;\n      "
         "const float2 g0", "for (int kk = 0; kk < 0; ++kk) {\n      const int j = kk * 8 + 2 * q;"
         "\n      const float2 g0"),
    ],
    "chunk: no kw dS": [
        ("for (int kk = 0; kk < MAX_K / 8; ++kk) {  // dv's kw dS",
         "for (int kk = 0; kk < 0; ++kk) {  // dv's kw dS"),
    ],
    "chunk: no copies (its arithmetic on stale shared memory)": [
        ("  copy_rows(sm.", "  if (0) copy_rows(sm."),
        ("      cp_async16(&sm.ds[i][j0], in ? src + (size_t)i * a.vp + j0 : src, bytes);", ""),
        ("sreg[2 * kk] = (i < kd && j < vdim) ? src[j] : 0.f;", "sreg[2 * kk] = 0.f;"),
        ("sreg[2 * kk + 1] = (i < kd && j + 1 < vdim) ? src[j + 1] : 0.f;",
         "sreg[2 * kk + 1] = 0.f;"),
    ],
    # cut the chunk pass short after each of its phases (the S_c loads kept alive)
    "chunk: the copies only": [(CHUNK_PHASE[0], CUT + CHUNK_PHASE[0])],
    "chunk: up to the factors": [(CHUNK_PHASE[1], CUT + CHUNK_PHASE[1])],
    "chunk: up to the 16 x 16 tiles": [(CHUNK_PHASE[2], CUT + CHUNK_PHASE[2])],
    "chunk: up to dr, dk, dv": [(CHUNK_PHASE[3], CUT + CHUNK_PHASE[3])],
    "chunk: no dw sums over rows": [
        ("if (pair_group(t) != z) continue;  // warp-uniform", "continue;"),
        ("      e += sm.ec[m][i];", ""),
        ("      later += sm.ee[m][i];", ""),
    ],
}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signature the wrapper's ``_bwd_lib`` declares."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.repro_wkv6_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr] * 16 + [ctypes.POINTER(i64), i32, i32, i64] + [i32] * 3 + [ptr]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def main() -> int:
    smi = cs.phase_device()
    src = (CSRC / "wkv6_bwd.cu").read_text()
    libs = _build_copies(
        {name: _edit(src, edits) for name, edits in ABLATIONS.items()}, "wkv6_bwd.cu", OUT
    )
    r, k, v, w, u, h0, dout, ds = cs._wkv6_bwd_inputs(cs._gen(7), SHAPE)
    for name, lib in libs.items():
        wk._bwd_lib = lambda lib=_declare(lib): lib

        def call():
            return wk.wkv6_bwd(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)

        ms = cs.time_ms(call, iters=10)
        parts = {n: cs.device_us(call, f"wkv6_bwd_{n}_kernel", 10) for n in cs.WKV6_BWD_PARTS}
        cs.log(
            f"[wkv6_bwd_probe] {name}: {ms:.4f} ms a call; device us "
            + ", ".join(f"{n} {us:.2f}" for n, us in parts.items())
        )
    torch.cuda.synchronize()
    cs.log(f"[wkv6_bwd_probe] {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
