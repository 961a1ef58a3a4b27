"""What bounds the WKV6 chunk kernel's two state products, on one NVIDIA card.

    python3 tools/wkv6_state_probe.py

Builds ``tools/wkv6_state_probe.cu`` with nvcc and runs each of the two
products that touch the state (the cross term r^ S and the update
D_last S + kw^T v, at one block's 64 x 32 slice of a head) in a loop over
chunks held in shared memory, one block an SM, in four forms: the FMA design
(operands read from shared memory), its loads alone, its FMAs alone (operands
in registers), and the kernel's 3xTF32 tensor-core form. It prints ptxas's
report, the clock64 cycles a chunk of each (form, product), the instructions of
each loop read from the SASS (``cuobjdump``; "not measured" where the toolkit
has none), and what bounds the FMA form. About half a minute on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "wkv6_state_probe.cu"
FORMS = ("FMA", "LOADS", "FMAS", "MMA")
PRODUCTS = ("cross", "update")
WARPS = {"FMA": 8, "LOADS": 8, "FMAS": 8, "MMA": 2}  # a block, one block an SM
SCHEDULERS = 4  # warp schedulers an SM; warp w issues on scheduler w % 4
N_CHUNKS = 4096
RUNS = 3


def build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    out = ROOT / "build" / "wkv6_state_probe" / digest.hexdigest()[:16]
    lib = out / "libwkv6_state_probe.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise SystemExit(f"[probe] build failed:\n{proc.stdout}{proc.stderr}")
    cs.log("[probe] ptxas:\n" + (out / "build.log").read_text().strip())
    return lib


def _cuobjdump() -> str | None:
    nvcc = Path(_build._nvcc())
    cand = nvcc.parent / "cuobjdump"
    return str(cand) if cand.exists() else shutil.which("cuobjdump")


def loop_counts(lib: Path) -> dict:
    """(form, product) -> instruction counts of its chunk loop, one warp's, from the SASS:
    the instructions from the target of the kernel's last backward branch to that branch."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0]
        found = re.search(r"wkv6_state_probe_kernelILi(\d)ELi(\d)E", name)
        if found is None:
            continue
        insts = [
            (int(a, 16), op.strip())
            for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)
        ]
        loop = None
        for addr, op in insts:
            target = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", op)
            if target and target.group(1) and int(target.group(1), 16) < addr:
                loop = (int(target.group(1), 16), addr)
        if loop is None:
            continue
        body = [op for addr, op in insts if loop[0] <= addr <= loop[1]]
        opc = [re.sub(r"^@!?P\w+\s+", "", op).split()[0] for op in body]
        counts[(FORMS[int(found.group(1))], PRODUCTS[int(found.group(2))])] = {
            "all": len(opc),
            "LDS": sum(o.startswith("LDS") for o in opc),
            "FFMA": sum(o == "FFMA" for o in opc),
            "HMMA": sum(o.startswith("HMMA") for o in opc),
            "SHFL": sum(o.startswith("SHFL") for o in opc),
        }
    return counts


def main() -> int:
    cs.phase_device()
    lib_path = build()
    lib = ctypes.CDLL(str(lib_path))
    lib.wkv6_state_probe.restype = ctypes.c_int
    lib.wkv6_state_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.wkv6_state_probe_error.restype = ctypes.c_char_p
    lib.wkv6_state_probe_error.argtypes = [ctypes.c_int]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(blocks * 256, device="cuda")
    cycles = torch.empty(blocks, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    counts = loop_counts(lib_path)
    if not counts:
        cs.log("[probe] SASS loop counts: not measured (no cuobjdump, or no loop found)")
    per_chunk = {}
    for form in FORMS:
        for pi, product in enumerate(PRODUCTS):
            runs = []
            for _ in range(RUNS + 1):  # the first is a warm-up
                err = lib.wkv6_state_probe(
                    FORMS.index(form), pi, N_CHUNKS, blocks, sink.data_ptr(), cycles.data_ptr(),
                    stream,
                )
                if err:
                    raise SystemExit(f"[probe] launch failed: {lib.wkv6_state_probe_error(err)}")
                torch.cuda.synchronize()
                runs.append(cycles.double().mean().item() / N_CHUNKS)
            if not torch.isfinite(sink).all():
                raise SystemExit(f"[probe] {form} {product}: a result is not finite")
            per_chunk[(form, product)] = statistics.median(runs[1:])
            c = counts.get((form, product))
            inst = (
                f"; a warp's loop: {c['all']} instructions, {c['LDS']} LDS, {c['FFMA']} FFMA, "
                f"{c['HMMA']} HMMA, {c['SHFL']} SHFL; the SM's {WARPS[form]} warps issue "
                f"{-(-WARPS[form] // SCHEDULERS) * c['all']} on the busiest scheduler and "
                f"{WARPS[form] * c['LDS']} LDS in all"
                if c
                else ""
            )
            cs.log(
                f"[probe] {form:5s} {product:6s}: {per_chunk[(form, product)]:.1f} cycles a chunk "
                f"(median of {RUNS} launches of {N_CHUNKS} chunks on {blocks} SMs){inst}"
            )
    for product in PRODUCTS:
        full, loads, fmas, mma = (per_chunk[(f, product)] for f in FORMS)
        cs.log(
            f"[probe] {product}: FMA form {full:.1f} cycles a chunk, its loads alone {loads:.1f} "
            f"({loads / full:.0%}), its FMAs alone {fmas:.1f} ({fmas / full:.0%}); tensor-core "
            f"form {mma:.1f} ({mma / full:.0%} of the FMA form)"
        )
    total = {f: sum(per_chunk[(f, p)] for p in PRODUCTS) for f in FORMS}
    cs.log(
        f"[probe] both products: FMA {total['FMA']:.1f}, LOADS {total['LOADS']:.1f}, FMAS "
        f"{total['FMAS']:.1f}, MMA {total['MMA']:.1f} cycles a chunk"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
