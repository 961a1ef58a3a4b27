"""The port's durable substrate against the JAX package's, on the same values and graphs.

``repro_torch.wire`` (canonical form, payload digest, the msgpack encoder the
port keeps instead of the ``msgpack`` package), ``repro_torch.core``
(contexts, the ``LocalExecutor``'s journal records and replay, the journal's
file format), ``repro_torch.checkpoint`` and ``repro_torch.obs.metrics``,
each held against its ``repro`` original. Digests and bytes are compared for
equality: the two packages must read, digest and replay each other's
records exactly. No tolerance is used anywhere in this file.
"""

import io
import math
import os
import time

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.checkpoint.store as jstore
import repro.core as jcore
import repro.obs.metrics as jmetrics
import repro.wire as jwire
import repro_torch.checkpoint as tstore
import repro_torch.core as tcore
import repro_torch.obs.metrics as tmetrics
import repro_torch.wire as twire
from repro.wire.msgpack_codec import pack_default
from repro_torch.train.host import to_host
from repro_torch.wire import packer

SETTINGS = settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])

# --------------------------------------------------------------------------
# wire: hypothesis trees
# --------------------------------------------------------------------------

_ARRAY_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_, np.float16)


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_ARRAY_DTYPES))
    shape = draw(st.lists(st.integers(0, 3), max_size=3))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 100).astype(dtype)


_INT64 = st.integers(-(2**63), 2**64 - 1)
_LEAVES = st.one_of(
    st.none(),
    st.booleans(),
    _INT64,
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(max_size=40),
    st.binary(max_size=300),
    _arrays(),
)
_TREES = st.recursive(
    _LEAVES,
    lambda children: st.one_of(
        st.lists(children, max_size=20),
        st.dictionaries(st.text(max_size=8), children, max_size=20),
    ),
    max_leaves=40,
)


@SETTINGS
@given(_TREES)
def test_canonical_form_and_payload_digest_equal_the_references(tree):
    assert twire.canonical_bytes(tree) == jwire.canonical_bytes(tree)
    assert twire.canonical_digest(tree) == jwire.canonical_digest(tree)
    assert twire.payload_digest(tree) == jwire.payload_digest(tree)


@SETTINGS
@given(_TREES)
def test_encoder_gives_msgpacks_bytes_and_each_package_reads_the_others_frames(tree):
    want = msgpack.packb(tree, default=pack_default, use_bin_type=True)
    assert packer.packb(tree) == want
    assert twire.decompress(twire.encode_payload(tree)) == want
    # decoded trees hold arrays: compare through the (shared) digest, against the
    # reference's own round trip (which turns a numpy float64 scalar into a float)
    want = jwire.payload_digest(jwire.decode_payload(jwire.encode_payload(tree)))
    for enc, dec in (
        (twire.encode_payload, jwire.decode_payload),
        (jwire.encode_payload, twire.decode_payload),
        (twire.encode_payload, twire.decode_payload),
    ):
        assert jwire.payload_digest(dec(enc(tree))) == want


_EDGES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
    0.0, -0.0, float("nan"), float("-inf"), "", "a" * 31, "a" * 32, "é" * 200, "b" * 70000,
    b"", b"x" * 255, b"x" * 256, b"y" * 70000, bytearray(b"ab"), memoryview(b"cd"),
    [], list(range(15)), list(range(16)), list(range(70000)), (1, "t"),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)}, {1: "int key", None: 2},
    np.zeros((), np.float64), np.float32(1.5), np.int64(3), np.bool_(True), np.array("abc"),
    np.float64(2.5), np.arange(6.0).reshape(2, 3), torch.arange(6).reshape(2, 3).float(),
    1 + 2j, {3, 1, 2}, frozenset({"b", "a"}),
]  # fmt: skip


@pytest.mark.parametrize("value", _EDGES, ids=range(len(_EDGES)))
def test_encoder_edges_equal_msgpack(value):
    want = msgpack.packb(value, default=pack_default, use_bin_type=True)
    assert packer.packb(value) == want
    from repro.wire.msgpack_codec import unpack_ext

    got = msgpack.unpackb(want, ext_hook=unpack_ext, raw=False, strict_map_key=False)
    assert repr(packer.unpackb(want)) == repr(got)


@pytest.mark.parametrize("value", [2**64, -(2**63) - 1, object()])
def test_encoder_refuses_what_msgpack_refuses(value):
    with pytest.raises(TypeError):
        msgpack.packb(value, default=pack_default, use_bin_type=True)
    with pytest.raises(TypeError):
        packer.packb(value)


def test_decoder_rejects_truncated_and_trailing_bytes():
    frame = packer.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        packer.unpackb(frame[:-1])
    with pytest.raises(ValueError, match="extra data"):
        packer.unpackb(frame + b"\x00")
    with pytest.raises(twire.PayloadDecodeError):
        twire.decode_payload(b"\x01garbage")


def test_tensors_that_numpy_cannot_read_raise_a_clear_error():
    """A tensor on a device (the meta device stands in for the card here) is refused by name
    instead of failing inside numpy. bfloat16, which numpy has no dtype for, digests,
    encodes and comes to the host by its bits (``repro_torch.wire.bfloat16``)."""
    bad = torch.ones(2, device="meta")
    for fn in (twire.payload_digest, twire.canonical_bytes, twire.encode_payload):
        with pytest.raises(TypeError, match="to_host"):
            fn({"x": bad})
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    host = to_host({"w": bf})
    assert type(host["w"]).__name__ == "BFloat16Array" and host["w"].shape == (3,)
    assert twire.canonical_bytes({"w": bf}) == b'{"w":[1.5,-2.25,3.0]}'
    assert twire.payload_digest({"w": bf}) == twire.payload_digest(host)
    back = twire.decode_payload(twire.encode_payload(host))["w"]
    assert back.bits().tolist() == bf.view(torch.int16).numpy().view(np.uint16).tolist()
    t = torch.arange(4.0)
    host = to_host({"w": t, "n": [t, 3]})
    t.add_(1)  # a copy: the host tree does not see later in-place updates
    assert host["w"].tolist() == [0.0, 1.0, 2.0, 3.0] and host["n"][1] == 3


# --------------------------------------------------------------------------
# context digests
# --------------------------------------------------------------------------


@SETTINGS
@given(
    st.dictionaries(st.text(max_size=6), _TREES, max_size=5),
    st.dictionaries(st.text(max_size=6), _TREES, max_size=5),
    st.dictionaries(st.text(max_size=6), _TREES, min_size=1, max_size=5),
)
def test_context_digests_equal_after_origin_with_data_and_union(a, b, data):
    def build(core):
        x = core.Context.origin(a, origin="x")
        y = core.Context.origin(b).with_data(data, origin="node")
        u = core.Context.union_all([x, y]).with_data({"k": 1}, origin="u")
        return [x, y, u, x | y]

    for got, want in zip(build(tcore), build(jcore), strict=True):
        assert got.digest() == want.digest()
        assert got.to_wire() == want.to_wire()


# --------------------------------------------------------------------------
# executor: the same graph through both LocalExecutors
# --------------------------------------------------------------------------


def _src(ctx):
    return {"x": 3, "arr": np.arange(4, dtype=np.int32)}


def _left(ctx, src):
    return {"l": src["x"] * 2, "seen": ctx.get("scale")}


def _right(ctx, src):
    return [src["x"], float(src["arr"].sum()), "r"]


def _join(ctx, left, right, flagged):
    return {"sum": left["l"] + right[0], "tag": ctx.get("tag"), "fact": ctx.get("flag")}


def _flagged(ctx, src):
    return {"done": True}


def _fail(ctx, join):
    raise ValueError("planned failure")


def _graph(core, wc):
    g = core.ContextGraph(origin=core.Context.origin({"run": "r1", "scale": 2}), name="g")
    g.add("src", _src, data={"tag": "s"})
    g.add("left", _left, deps=["src"], data={"scale": 5})
    g.add("right", _right, deps=["src"])
    g.add("flagged", lambda ctx, src: wc(_flagged(ctx, src), {"flag": "on"}), deps=["src"])
    g.add("join", _join, deps=["left", "right", "flagged"], data={"tag": "j"})
    return g


def _failing_graph(core):
    g = _graph(core, core.WithContext)
    g.add("boom", _fail, deps=["join"], retries=0)
    g.add("boom_retried", _fail, deps=["join"], retries=1)
    return g


def _records(path, journal_cls):
    """Journal records by (kind, node id, attempt), each a tuple of the compared fields."""
    out = {}
    for rec in journal_cls(path, sync="never").records():
        key = (rec.kind, rec.node_id, rec.attempt)
        fields = (rec.context_digest, rec.input_digest, rec.output_digest)
        # the payload by its msgpack bytes: it may hold arrays
        out.setdefault(key, []).append(fields + (packer.packb(rec.payload), rec.ref, rec.meta))
    return out


def _run(core, path, graph):
    journal = core.Journal(path, sync="never")
    policy = core.RetryPolicy(base_delay_s=0.0)
    try:
        return core.LocalExecutor(max_workers=4, journal=journal, retry=policy).run(graph)
    finally:
        journal.close()


def test_executor_records_and_replay_equal_the_references(tmp_path):
    runs = {}
    for name, core in (("torch", tcore), ("jax", jcore)):
        path = str(tmp_path / f"{name}.wal")
        first = _run(core, path, _graph(core, core.WithContext))
        assert sorted(first.executed) == ["flagged", "join", "left", "right", "src"]
        again = _run(core, path, _graph(core, core.WithContext))
        assert again.executed == () and sorted(again.replayed) == sorted(first.executed)
        assert again.outputs["join"] == first.outputs["join"] == {
            "sum": 9,
            "tag": "j",
            "fact": "on",
        }
        assert again.contexts["join"].digest() == first.contexts["join"].digest()
        with pytest.raises(ValueError, match="planned failure"):
            _run(core, path, _failing_graph(core))
        runs[name] = _records(path, core.Journal)
    assert runs["torch"] == runs["jax"]
    kinds = {k[0] for k in runs["torch"]}
    assert kinds == {"RUN_START", "NODE_START", "NODE_COMMIT", "RUN_END", "NODE_FAIL"}
    assert ("NODE_FAIL", "boom", 1) in runs["torch"]
    assert ("NODE_START", "boom_retried", 1) in runs["torch"]  # one retry, then the fail
    assert ("NODE_FAIL", "boom_retried", 2) in runs["torch"]


def test_union_node_and_volatile_replay_equal_the_references(tmp_path):
    """A two-node cycle contracts into one union node; a volatile node commits its digest
    only and re-executes on replay, verified against the journal."""

    def build(core):
        g = core.ContextGraph(origin=core.Context.origin({"run": 1}), name="u")
        g.add("a", lambda ctx, b: (b or 0) + 1, deps=["b"], data={"__seed__": 0})
        g.add("b", lambda ctx, a: (a or 0) * 10, deps=["a"])
        g.add("vol", lambda ctx, **kw: np.full(3, 7.0), deps=["a"], volatile=True)
        return g

    runs = {}
    for name, core in (("torch", tcore), ("jax", jcore)):
        path = str(tmp_path / f"{name}.wal")
        first = _run(core, path, build(core))
        again = _run(core, path, build(core))
        assert "vol" in again.executed and "∪(a+b)" in again.replayed
        runs[name] = _records(path, core.Journal)
    assert runs["torch"] == runs["jax"]


def test_each_journal_reads_the_others_file_and_torn_tails(tmp_path):
    for writer, readers in ((tcore, (tcore, jcore)), (jcore, (jcore, tcore))):
        path = str(tmp_path / f"{writer.__name__}.wal")
        _run(writer, path, _graph(writer, writer.WithContext))
        full = [_records(path, r.Journal) for r in readers]
        assert full[0] == full[1]
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size - 7)  # a crash mid-append: the last frame is torn
        torn = [
            [packer.packb(r.to_obj()) for r in reader.Journal(path, sync="never").records()]
            for reader in readers
        ]
        assert torn[0] == torn[1] and len(torn[0]) == sum(map(len, full[0].values())) - 1
        assert os.path.getsize(path) < size - 7  # the torn frame was cut off on open


def test_the_port_refuses_what_it_did_not_copy(tmp_path, monkeypatch):
    g = tcore.ContextGraph()
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        g.add("s", _src, stream="source")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        g.add("s", _src, check="warn")
    monkeypatch.setenv("REPRO_LINT", "error")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        g.add("s", _src)
    monkeypatch.setenv("REPRO_LINT", "off")
    g.add("s", _src)
    for kw in ({"cache": object()}, {"spill_put": lambda n, v: n}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            tcore.LocalExecutor(**kw)
    path = str(tmp_path / "snap.wal")
    with jcore.Journal(path, sync="never") as j:
        j.append(jcore.JournalRecord(kind="SNAPSHOT", meta={"version": 1, "records": []}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        list(tcore.Journal(path, sync="never").records())


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"table": rng.standard_normal((5, 3)).astype(np.float32)},
        "seg0": {"w": rng.standard_normal((2, 3, 3)).astype(np.float32)},
        "step": np.array(7, np.int32),
    }


def _like(tree):
    return {k: _like(v) for k, v in tree.items()} if isinstance(tree, dict) else np.zeros_like(tree)


@pytest.mark.parametrize("async_", [False, True])
def test_each_checkpoint_store_resolves_the_others_refs(tmp_path, async_):
    tree = _tree(0)
    for writer, reader in ((tstore, jstore), (jstore, tstore)):
        root = str(tmp_path / f"{writer.__name__}-{async_}")
        store = writer.CheckpointStore(root)
        ref = store.save("step00000002", tree, {"next_step": 2}, async_=async_)
        store.wait()
        got = reader.CheckpointStore(root).resolve(ref, _like(tree))
        for k in ("embed", "seg0"):
            (key,) = tree[k]
            np.testing.assert_array_equal(got[k][key], tree[k][key])
        assert got["step"] == 7 and got["step"].dtype == np.int32
    # the same tree gives the same content digest in both packages
    tref = tstore.CheckpointStore(str(tmp_path / "a")).save("t", tree)
    jref = jstore.CheckpointStore(str(tmp_path / "b")).save("t", tree)
    assert tref == jref


def test_flipped_byte_raises_content_mismatch_in_both(tmp_path):
    tree = _tree(1)
    for writer in (tstore, jstore):
        root = str(tmp_path / writer.__name__)
        ref = writer.CheckpointStore(root).save("step00000002", tree)
        shard = os.path.join(root, "step00000002", "shard-0.npz.zst")
        npz = np.load(io.BytesIO(twire.decompress(open(shard, "rb").read())))
        flat = {k: npz[k].copy() for k in npz.files}
        flat["embed|table"].reshape(-1)[0] += 1.0  # same shape and dtype, other bytes
        buf = io.BytesIO()
        np.savez(buf, **flat)
        tstore.atomic_write_bytes(shard, twire.compress(buf.getvalue(), level=3))
        for reader in (tstore, jstore):
            with pytest.raises(ValueError, match="content mismatch"):
                reader.CheckpointStore(root).resolve(ref, _like(tree))


def test_latest_falls_back_past_a_half_published_pair(tmp_path):
    import shutil

    root = str(tmp_path / "ck")
    store = tstore.CheckpointStore(root)
    for step in (2, 4):
        store.save(f"step{step:08d}", _tree(step))
        store.save(f"step{step:08d}-opt", _tree(step + 1), async_=True)
    store.wait()
    assert store.latest(companions=("-opt",)) == "step00000004"
    shutil.rmtree(os.path.join(root, "step00000004-opt"))
    for s in (tstore.CheckpointStore(root), jstore.CheckpointStore(root)):
        assert s.latest() == "step00000004"
        assert s.latest(companions=("-opt",)) == "step00000002"
    assert set(store.seconds) == {f"step{s:08d}{c}" for s in (2, 4) for c in ("", "-opt")}


# --------------------------------------------------------------------------
# heartbeat, retry policy, metrics
# --------------------------------------------------------------------------


def test_heartbeat_reports_and_does_not_start_cuda():
    assert tcore.telemetry()["devices"] == {"backend": "uninitialized", "count": 0}
    with tcore.HeartbeatServer(extra={"worker": "trainer"}) as hb:
        report = tcore.check_heartbeat(hb.address, timeout=10.0)
    assert report["ok"] and report["worker"] == "trainer" and report["probe_latency_s"] >= 0
    assert set(report) == set(jcore.telemetry({"worker": "trainer"})) | {"probe_latency_s"}
    assert tcore.check_heartbeat(hb.address, timeout=0.5) is None  # stopped: system failure


def test_retry_policy_and_straggler_watch_equal_the_references():
    for attempt in range(8):
        assert tcore.RetryPolicy().delay(attempt) == jcore.RetryPolicy().delay(attempt)
    for core in (tcore, jcore):
        watch = core.StragglerWatch(threshold=2.0, min_samples=3)
        for i in range(3):
            watch.started("t", i)
            watch.finished("t", i)
        watch.started("t", "slow")
        time.sleep(0.05)  # far beyond 2x the median of three empty tasks
        assert [s[:2] for s in watch.stragglers()] == [("t", "slow")]
        assert watch.should_speculate("t", "slow", copies=1)
        assert not watch.should_speculate("t", "slow", copies=3)


def test_metrics_registry_renders_as_the_references():
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("repro_train_steps_total").inc(3)
        reg.gauge("repro_train_loss").set(6.25)
        reg.gauge("repro_x", part="opt").add(-1.5)
        hist = reg.histogram("repro_ckpt_seconds")
        for v in (0.002, 0.3, 7.0, 100.0):
            hist.observe(v)
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].to_json() == regs[1].to_json()
    tmetrics.metrics().counter("c_total").inc()
    tmetrics.reset_metrics()
    assert tmetrics.metrics().snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert math.isclose(regs[0].snapshot()["gauges"]['repro_x{part="opt"}'], -1.5)
