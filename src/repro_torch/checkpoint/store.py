"""Sharded, journal-integrated checkpoint store: a copy of ``repro.checkpoint.store``.

Layout: <root>/<tag>/
    manifest.json       — pytree structure, shapes, dtypes, shard map, digest
    shard-<i>.npz.zst   — npz of this host's param shards in a tagged frame

The layout, the frames' tags and the content digest are the reference's, so
each package resolves the other's ``tag@digest`` refs. This store writes raw
frames (tag 0x00: the npz as it is) where the reference writes zstd or zlib
(``compress(..., level=3)``); both packages' ``decompress`` read either. On
these tensors compression hardly pays for itself and costs the most of a save.
On qwen3-1.7b's checkpoints after two steps, on the H100 machine's host, zlib
levels 1 and 6 leave 0.79-0.80 of the bfloat16 params' bytes, 0.73-0.75 of the
AdamW m and 0.88-0.89 of v, at 7-26 MB/s on one thread: minutes for a 4.1 GB
pair, which raw frames write in ~10-13 s, most of it sha256, the zip's CRC
and fsync (``chip_smoke.py``'s dense durable phase). The frame is written
straight into the file that the atomic rename publishes, with no copy of the
shard in memory, and a raw shard is read into one buffer whose views are its
arrays.

bfloat16 leaves (the host form of ``repro_torch.wire.bfloat16``) are stored as
the reference stores an ``ml_dtypes.bfloat16`` array: an npz member of ``|V2``
holding the bits, ``"bfloat16"`` in the manifest and in the digest. The
manifest's dtype turns such a member back into bfloat16 on load, so the port
resolves its own bfloat16 checkpoints and the reference's; the reference
resolves neither, as its ``np.load`` gives the ``|V2`` member a digest of
``"|V2"``.

Design points:
  - atomic publish: writes go to <tag>.tmp/ and are renamed into place only
    after the manifest fsync — a crash mid-save never corrupts the latest
    complete checkpoint. Individual files are published by tmp-write +
    rename (:func:`atomic_write_bytes`, the reference's
    ``repro.cache.store.atomic_write_bytes``, and :func:`atomic_write`);
  - the journal stores only the checkpoint *ref* (tag + digest), never
    tensors (§4.2: event history + blob store);
  - async mode hands the (already host-side) arrays to a writer thread so
    the train step resumes immediately;
  - ``seconds[tag]``: what each save cost, its hashing on the caller's
    thread plus its write on whichever thread wrote it (waiting for an
    earlier async save not counted).

Trees hold numpy arrays (``repro_torch.train.host.to_host`` brings a tree of
tensors to the host); a tensor on a device raises.
"""
from __future__ import annotations

import hashlib
import io
import os
import shutil
import threading
import time
import zipfile
from typing import Any, BinaryIO, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.wire import JsonCodec, decompress, host_array
from repro_torch.wire.bfloat16 import BFLOAT16, BITS, BFloat16Array, dtype_name
from repro_torch.wire.compress import TAG_RAW

__all__ = ["CheckpointStore", "atomic_write", "atomic_write_bytes"]


def atomic_write(path: str, write: Callable[[BinaryIO], Any], fsync: bool = True) -> None:
    """Publish at ``path`` atomically what ``write`` writes into the file it is given
    (tmp file + rename).

    Readers either see the complete new bytes or whatever was there before —
    never a partial write.
    """
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as fh:
        write(fh)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Publish ``data`` at ``path`` atomically (:func:`atomic_write`)."""
    atomic_write(path, lambda fh: fh.write(data), fsync)


def _write_raw_npz(fh: BinaryIO, flat: Dict[str, np.ndarray]) -> None:
    """A raw frame: the tag byte, then the npz of ``flat`` written straight into ``fh``."""
    fh.write(bytes([TAG_RAW]))
    np.savez(fh, **{k.replace("/", "|"): v for k, v in flat.items()})


def _read_npz(npz) -> Dict[str, np.ndarray]:
    try:
        return {k.replace("|", "/"): npz[k] for k in npz.files}
    finally:
        npz.close()


_NPY_HEADERS = {1: np.lib.format.read_array_header_1_0, 2: np.lib.format.read_array_header_2_0}


def _read_raw_npz(fh: BinaryIO) -> Dict[str, np.ndarray]:
    """The npz of a raw frame as arrays over one buffer the whole file is read into.

    The zip's central directory gives each member's local header, and the npy header its
    dtype and shape: no member is copied again, where ``np.load`` reads each into an array
    of its own in 256 KiB pieces, 4x slower on the card's host. The members' CRCs are not
    read: ``resolve()``'s content digest is the check of the bytes.
    """
    buf = np.empty(os.fstat(fh.fileno()).st_size, np.uint8)
    fh.seek(0)
    view, got = memoryview(buf), 0
    while got < buf.size:
        n = fh.readinto(view[got:])
        if not n:
            raise ValueError("checkpoint shard: short read")
        got += n
    fh.seek(1)
    with zipfile.ZipFile(fh) as z:
        infos = z.infolist()  # offsets in the file: zipfile counts the tag byte before the zip
    flat = {}
    for info in infos:
        names, extra = (int(n) for n in np.frombuffer(buf, "<u2", 2, info.header_offset + 26))
        data = info.header_offset + 30 + names + extra  # past the local header: the npy
        npy = io.BytesIO(buf[data : data + 12 + (1 << 16)].tobytes())
        major, _ = np.lib.format.read_magic(npy)
        shape, fortran, dtype = _NPY_HEADERS[min(major, 2)](npy)
        if info.compress_type != zipfile.ZIP_STORED or dtype.hasobject:
            raise ValueError(f"checkpoint shard: {info.filename} is not a stored array")
        start = data + npy.tell()
        arr = np.frombuffer(buf, dtype, int(np.prod(shape)), start)
        arr = arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)
        flat[info.filename[: -len(".npy")].replace("|", "/")] = arr
    return flat


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _unflatten(flat: Dict[str, Any], like):
    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [build(v, path + (str(i),)) for i, v in enumerate(tree)]
            return type(tree)(vals)
        return flat["/".join(path)]

    return build(like, ())


class CheckpointStore:
    def __init__(self, root: str, host_index: int = 0, num_hosts: int = 1,
                 keep: int = 3):
        self.root = root
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_err: Optional[BaseException] = None
        self.seconds: Dict[str, float] = {}

    # -- save -------------------------------------------------------------
    def save(self, tag: str, tree: Any, extra_meta: Optional[dict] = None,
             async_: bool = False) -> str:
        """Returns the journal ref 'tag@digest'. async_: returns immediately
        after fetching arrays to host; IO happens on a writer thread."""
        t0 = time.monotonic()
        flat = {k: host_array(v) for k, v in _flatten(tree)}
        digest = self._digest(flat)  # hash the tensors exactly once per save
        host_s = time.monotonic() - t0

        def write():
            t1 = time.monotonic()
            self._write(tag, flat, tree, extra_meta, digest)
            self.seconds[tag] = host_s + time.monotonic() - t1

        if async_:
            self.wait()  # one in-flight save at a time

            def work():
                try:
                    write()
                except BaseException as e:  # surfaced on next wait()
                    self._async_err = e

            self._async_thread = threading.Thread(target=work, daemon=True)
            self._async_thread.start()
        else:
            write()
        return f"{tag}@{digest}"

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise err

    @classmethod
    def content_digest(cls, tree: Any) -> str:
        """The digest :meth:`save` gives ``tree`` (its ref after the '@'), nothing written."""
        return cls._digest({k: host_array(v) for k, v in _flatten(tree)})

    @staticmethod
    def _digest(flat: Dict[str, np.ndarray]) -> str:
        """Content-true digest: keys, dtypes, shapes AND the tensor bytes.

        The digest is the cache/journal contract for snapshots — a CKPT
        record's ref must be falsifiable against what the store actually
        holds. Hashing only the structure (the pre-fix behaviour) made
        ``resolve()`` blind to corruption and tag swaps with matching shapes.
        """
        h = hashlib.sha256()
        for k in sorted(flat):
            a = flat[k]
            h.update(k.encode())
            h.update(dtype_name(a).encode())  # bfloat16: "bfloat16", the reference's str(dtype)
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a))  # the bytes, through the buffer: no copy
        return h.hexdigest()[:16]

    def _write(self, tag: str, flat: Dict[str, np.ndarray], tree: Any,
               extra_meta: Optional[dict],
               digest: Optional[str] = None) -> None:
        final = os.path.join(self.root, tag)
        tmp = final + f".tmp.{self.host_index}"
        os.makedirs(tmp, exist_ok=True)
        # shard file for this host
        shard_path = os.path.join(tmp, f"shard-{self.host_index}.npz.zst")
        atomic_write(shard_path, lambda fh: _write_raw_npz(fh, flat))
        manifest = {
            "tag": tag,
            "digest": digest if digest is not None else self._digest(flat),
            "digest_kind": "content",  # keys+dtypes+shapes+tensor bytes
            "num_hosts": self.num_hosts,
            "written_by": self.host_index,
            "time": time.time(),  # record timestamp
            "entries": {k: {"dtype": dtype_name(v), "shape": list(v.shape)}
                        for k, v in flat.items()},
            "meta": extra_meta or {},
        }
        mpath = os.path.join(tmp, "manifest.json")
        atomic_write_bytes(mpath, JsonCodec().encode(manifest, pretty=True))
        # atomic publish
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        """GC by BASE tag: companion tags ('<base>-opt' etc.) live and die
        with their base checkpoint."""
        bases = [t for t in self.list() if "-" not in t]
        for base in bases[: -self.keep]:
            for tag in self.list():
                if tag == base or tag.startswith(base + "-"):
                    shutil.rmtree(os.path.join(self.root, tag),
                                  ignore_errors=True)

    # -- load -------------------------------------------------------------
    def list(self) -> List[str]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if os.path.exists(os.path.join(self.root, name, "manifest.json")):
                out.append(name)
        return out

    def latest(self, companions: Tuple[str, ...] = ()) -> Optional[str]:
        """Newest base tag, optionally requiring its companion tags.

        ``companions`` are tag suffixes (e.g. ``("-opt",)``) that must also
        exist for a base tag to count: a crash between the (sync) params
        save and the (async) optimizer save leaves a half-published pair,
        and recovery must fall back to the newest *complete* one instead of
        failing forever on the missing shard.
        """
        tags = [t for t in self.list() if "-" not in t]
        if companions:
            have = set(self.list())
            tags = [t for t in tags if all(t + c in have for c in companions)]
        return tags[-1] if tags else None

    def manifest(self, tag: str) -> dict:
        with open(os.path.join(self.root, tag, "manifest.json"), "rb") as fh:
            return JsonCodec().decode(fh.read())

    def _load_flat(self, tag: str, man: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """Load this host's full shard file as a flat {path: array} map; the members the
        manifest ``man`` (read if not given) calls bfloat16 come as ``BFloat16Array``."""
        man = self.manifest(tag) if man is None else man
        path = os.path.join(self.root, tag,
                            f"shard-{self.host_index}.npz.zst")
        with open(path, "rb") as fh:
            if fh.read(1) == bytes([TAG_RAW]):  # the npz follows the tag: read it in place
                flat = _read_raw_npz(fh)
            else:
                fh.seek(0)
                flat = _read_npz(np.load(io.BytesIO(decompress(fh.read()))))
        entries = man.get("entries", {})
        for k, a in flat.items():
            if a.dtype == BITS and entries.get(k, {}).get("dtype") == BFLOAT16:
                flat[k] = BFloat16Array(a)
        return flat

    def restore(self, tag: str, like: Any, dtype_map: Optional[Callable] = None
                ) -> Any:
        """Restore into the structure of ``like`` (shapes validated)."""
        return self._build(self._load_flat(tag), tag, like)

    @staticmethod
    def _build(flat: Dict[str, np.ndarray], tag: str, like: Any) -> Any:
        """Validate a loaded flat map against ``like`` and unflatten it."""
        like_flat = dict(_flatten(like))
        missing = set(like_flat) - set(flat)
        if missing:
            raise KeyError(f"checkpoint {tag} missing keys: {sorted(missing)[:5]}")
        for k, ref in like_flat.items():
            if tuple(flat[k].shape) != tuple(np.shape(ref)):
                raise ValueError(
                    f"shape mismatch at {k}: ckpt {flat[k].shape} vs "
                    f"model {np.shape(ref)}")
        return _unflatten(flat, like)

    def resolve(self, ref: str, like: Any) -> Any:
        """Resolve a journal ref 'tag@digest' with content verification.

        Two checks, both against the ref's digest: the manifest's recorded
        digest (catches a tag swapped for a different checkpoint) and a
        digest recomputed from the restored bytes (catches on-disk
        corruption or tampering the manifest cannot know about).

        Checkpoints written before digests became content-true (manifest
        lacks ``digest_kind: content``) get only the manifest-level check —
        their structure-only digests can never match a recomputed content
        hash, and wedging an intact legacy run_dir behind a false
        "tampered" error would be worse than the old blindness.
        """
        tag, _, digest = ref.partition("@")
        man = self.manifest(tag)
        if digest and man["digest"] != digest:
            raise ValueError(f"checkpoint digest mismatch for {ref}")
        flat = self._load_flat(tag, man)  # loaded once: verified AND restored from
        if digest and man.get("digest_kind") == "content":
            # recompute over the FULL stored shard, not the keys ``like``
            # happens to select — partial restores must not mask tampering
            got = self._digest(flat)
            if got != digest:
                raise ValueError(
                    f"checkpoint content mismatch for {ref}: stored bytes "
                    f"hash to {got} (corrupted or tampered shard)")
        return self._build(flat, tag, like)
