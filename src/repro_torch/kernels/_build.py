"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled for
``sm_90a`` into a shared library at first use. Libraries go to
``build/repro_torch_kernels/<hash of the sources, headers and flags>/`` at
the root of the checkout (``.gitignore`` lists ``build/``), so an edited
source or header (``csrc/*.cuh``) is rebuilt and an unchanged one is loaded
as it is. A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain versions.

Nothing here runs at import time; the tests import every module on a
machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build", "load", "build_dir", "count_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"

#: kernel name -> source file under csrc/
KERNEL_SOURCES: Dict[str, str] = {
    "decode_attention": "decode_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_bwd_bf16": "flash_attention_bwd_bf16.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "rglru_bwd": "rglru_bwd.cu",
    "rglru_scan": "rglru_scan.cu",
    "wkv6": "wkv6.cu",
    "wkv6_bwd": "wkv6_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _repo_root() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3]


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(KERNEL_SOURCES):
        digest.update(name.encode())
        digest.update((CSRC / KERNEL_SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return _repo_root() / "build" / "repro_torch_kernels" / digest.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch: nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin)")


def build(names: Iterable[str] = ()) -> Dict[str, float]:
    """Compile the named kernels (default: all), one ``nvcc`` each, in parallel.

    Returns seconds per kernel that was compiled (0.0 for one already built).
    The compiler's ``-Xptxas -v`` report is kept beside each library as
    ``<name>.log``. Raises ``RuntimeError`` with the compiler output if any
    build fails.
    """
    names = list(names) or sorted(KERNEL_SOURCES)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNEL_SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
            time.monotonic(),
        )
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a library
    if failures:
        raise RuntimeError("repro_torch: kernel build failed: " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches.

    The wrappers are called from several threads at once (a worker server's
    handler threads), and ``+= 1`` on an attribute is a read-modify-write the
    interpreter may switch threads inside; the lock keeps every launch
    counted. Callers read and reset ``wrapper.launches`` directly.
    """
    with _COUNT_LOCK:
        wrapper.launches += 1
