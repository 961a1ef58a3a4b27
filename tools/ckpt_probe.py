"""Where a checkpoint pair's seconds go on the card's host, piece by piece.

    python3 tools/ckpt_probe.py

qwen3-1.7b at full width and 2 of its 28 layers (``chip_smoke.py``'s dense durable model:
0.82 GB of bfloat16 params, 3.30 GB of float32 AdamW moments), drawn on the card, goes
through the port's save and restore path with each piece timed alone: the copy to the host
(``to_host``, and into pinned buffers beside it), the content digest (sha256), the raw
npz written into a file (the zip's CRC included) and its fsync, the whole ``save``; then the
shard read back (the bytes alone, ``_load_flat``: one buffer whose views are the arrays,
and ``np.load`` member by member beside it), the digest again, the copy to the card (``from_numpy_tree``) and the whole ``resolve``. It
prints seconds and GB/s for each, and sha256's and crc32's rates on one host thread. About
a minute of command; it needs a card, and fails without one.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import _flatten, _write_raw_npz  # noqa: E402
from repro_torch.launch.train import opt_config  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_leaves  # noqa: E402
from repro_torch.params import from_numpy_tree, init_params  # noqa: E402
from repro_torch.train.host import to_host  # noqa: E402
from repro_torch.wire import host_array  # noqa: E402

OUT = ROOT / "build" / "ckpt_probe"


def _timed(label, fn, nbytes):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    cs.log(f"[ckpt probe] {label}: {sec:.3f} s, {nbytes / sec / 1e9:.3f} GB/s of {nbytes} bytes")
    return out


def _pinned(tree):
    """Each leaf copied into a pinned host buffer of its own (the buffers' allocation timed
    apart from the copy)."""
    leaves = tree_leaves(tree)
    t0 = time.monotonic()
    bufs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in leaves]
    alloc = time.monotonic() - t0
    t0 = time.monotonic()
    for b, x in zip(bufs, leaves, strict=True):
        b.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    return alloc, time.monotonic() - t0


def _np_load(path):
    """A raw shard's members read by ``np.load``, each into an array of its own."""
    with open(path, "rb") as fh:
        fh.read(1)  # the raw frame's tag
        with np.load(fh) as npz:
            return {k: npz[k] for k in npz.files}


def main() -> int:
    smi = cs.phase_device()
    cfg = cs._dense_cut_config()
    params = init_params(cfg, cs._gen(0), cs.DEV)
    state = adamw_init(params, opt_config(cs.TRAIN_STEPS))
    for leaf in tree_leaves({"m": state["m"], "v": state["v"]}):
        leaf.normal_(0.0, 1e-3, generator=cs._gen(1))
    nb = {
        "params": sum(x.numel() * x.element_size() for x in tree_leaves(params)),
        "opt": sum(x.numel() * x.element_size() for x in tree_leaves(state)),
    }
    cs.log(f"[ckpt probe] {cfg.name}, {cfg.num_layers} layers: {nb} bytes ({smi})")

    one = os.urandom(1 << 30)
    _timed("sha256 of 1 GiB on one thread", lambda: hashlib.sha256(one).digest(), len(one))
    _timed("zlib.crc32 of 1 GiB", lambda: zlib.crc32(one), len(one))
    del one

    shutil.rmtree(OUT, ignore_errors=True)
    store = CheckpointStore(str(OUT))
    for name, tree in (("params", params), ("opt", state)):
        tag = "step00000002" + ("" if name == "params" else "-opt")
        host = _timed(f"{name}: to_host (pageable)", lambda t=tree: to_host(t), nb[name])
        alloc, copy = _pinned(tree)
        cs.log(
            f"[ckpt probe] {name}: pinned buffers {alloc:.3f} s to allocate, {copy:.3f} s to "
            f"copy into ({nb[name] / copy / 1e9:.3f} GB/s)"
        )
        flat = {k: host_array(v) for k, v in _flatten(host)}
        _timed(f"{name}: content digest", lambda: CheckpointStore._digest(flat), nb[name])
        path = OUT / f"{name}.npz.raw"
        with open(path, "wb") as fh:
            _timed(f"{name}: raw npz written", lambda fh=fh: _write_raw_npz(fh, flat), nb[name])
            _timed(f"{name}: fsync", lambda fh=fh: (fh.flush(), os.fsync(fh.fileno())), nb[name])
        ref = _timed(f"{name}: save", lambda t=tag, h=host: store.save(t, h), nb[name])
        shard = OUT / tag / "shard-0.npz.zst"
        _timed(f"{name}: the shard's bytes read", lambda: shard.read_bytes(), nb[name])
        got = _timed(f"{name}: _load_flat", lambda t=tag: store._load_flat(t), nb[name])
        _timed(f"{name}: digest of the loaded", lambda: CheckpointStore._digest(got), nb[name])
        each = _timed(f"{name}: np.load, member by member", lambda: _np_load(shard), nb[name])
        same = all(
            each[k.replace("/", "|")].tobytes() == np.asarray(got[k]).tobytes() for k in got
        )
        cs.log(f"[ckpt probe] {name}: np.load's arrays equal _load_flat's: {same}")
        del each
        like = tree if name == "params" else state
        back = _timed(f"{name}: resolve", lambda r=ref, lk=like: store.resolve(r, lk), nb[name])
        moved = back if name == "params" else {"m": back["m"], "v": back["v"]}
        _timed(f"{name}: from_numpy_tree", lambda: from_numpy_tree(moved, cs.DEV), nb[name])
        del host, flat, got, back, moved
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
