"""bfloat16 across the port's durable host boundary, against the JAX package on the CPU.

The reference holds bfloat16 on the host as ``ml_dtypes.bfloat16`` arrays; the port, which
the card's machine runs without ``ml_dtypes``, as a ``BFloat16Array`` of the bits
(``repro_torch.wire.bfloat16``). On the same bits, drawn from a numpy seed, the port's
checkpoint digest, ``payload_digest``, ``canonical_digest`` and msgpack frames equal the
reference's; the port resolves its own bfloat16 checkpoints and the reference's, which the
reference itself does not (its ``np.load`` reads the member back as ``|V2``). Shards are
raw frames that both packages read. A bfloat16 smoke model trains through the port's
``Trainer``, crashes between the halves of a checkpoint pair, recovers and re-executes to
the journal's digests. The shard mean of bfloat16 gradients equals the reference's bit for
bit, and a bfloat16 ``DistributedTrainer`` round reduces to it.

Tolerance: none. Everything here is compared bit for bit (digests, bytes, ``torch.equal``).
"""

import dataclasses
import io
import json
import shutil
import zipfile

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import repro.wire as jwire
import repro_torch.wire as twire
from repro.checkpoint.store import CheckpointStore as JCheckpointStore
from repro.wire.msgpack_codec import pack_default, unpack_ext
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import Journal
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models import build
from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves
from repro_torch.params import from_numpy_opt_state, from_numpy_tree, init_params
from repro_torch.train import DistributedTrainer, DistTrainConfig, make_opt_init
from repro_torch.train import make_train_step
from repro_torch.train.host import to_host
from repro_torch.train.trainer import TrainConfig, Trainer, restore_pair
from repro_torch.wire import packer
from repro_torch.wire.bfloat16 import BFloat16Array
from repro_torch.wire.compress import TAG_RAW

SHAPES = [(), (0,), (3, 0), (5,), (2, 3, 4), (7, 129)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models run thousands of small ops: one intra-op thread, so that parallel test
    workers do not stall a pool as wide as the machine at each op (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SPECIALS = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0x0001, 0x7F7F], np.uint16)


def _bits(shape, seed=0):
    """Random bfloat16 bit patterns, with zeros, ±inf, a NaN, a subnormal and the largest
    finite value among them where there is room."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    flat = bits.reshape(-1)
    n = min(flat.size, SPECIALS.size)
    flat[:n] = SPECIALS[:n]
    return bits


def _trees(seed=0):
    """The same mixed tree twice: the reference's (ml_dtypes) and the port's host form."""
    rng = np.random.default_rng(seed)
    w, e, s = _bits((4, 6), seed), _bits((0, 3), seed), _bits((), seed + 1)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    bf = ml_dtypes.bfloat16
    ref = {"w": w.view(bf), "e": e.view(bf), "s": s.view(bf), "m": {"f": f32, "i": i32}}
    port = {
        "w": BFloat16Array(w),
        "e": BFloat16Array(e),
        "s": BFloat16Array(s),
        "m": {"f": f32, "i": i32},
    }
    return ref, port


def _same_bits(a, b):
    assert isinstance(a, BFloat16Array) and a.shape == b.shape
    assert np.array_equal(a.bits(), np.asarray(b).view(np.uint16))


# (a) ----------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_to_host_and_back_keeps_the_bits(shape):
    bits = _bits(shape)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    host = to_host({"t": t, "n": [t]})
    assert isinstance(host["t"], BFloat16Array) and host["t"].shape == shape
    assert np.array_equal(host["t"].bits(), bits)
    t.view(torch.int16).add_(1)  # a copy: the host tree does not see a later in-place update
    assert np.array_equal(host["n"][0].bits(), bits)
    back = from_numpy_tree({"t": host["t"]}, "cpu")["t"]
    assert back.dtype == torch.bfloat16 and back.shape == shape
    assert torch.equal(back.view(torch.int16), torch.from_numpy(bits.view(np.int16)))
    # the values are the reference's: ml_dtypes on the same bits, as float32
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(host["t"].float32(), want)


def test_the_host_form_refuses_arithmetic():
    x = BFloat16Array(_bits((4,)))
    for op in (
        lambda: x + 1,
        lambda: x * x,
        lambda: np.mean(x),
        lambda: x.sum(),
        lambda: np.asarray(x, dtype=np.float32),
        lambda: x.astype(np.float32),
    ):
        with pytest.raises((TypeError, ValueError)):
            op()
    with pytest.raises(TypeError, match="2-byte"):
        BFloat16Array(np.zeros(3, np.float32))
    assert isinstance(x[1:], BFloat16Array) and "BFloat16Array" in repr(x)


# (b) ----------------------------------------------------------------------------------


def _member_dtype(shard_path, name):
    with open(shard_path, "rb") as fh:
        raw = twire.decompress(fh.read())
    with zipfile.ZipFile(io.BytesIO(raw)) as z, z.open(name + ".npy") as member:
        version = np.lib.format.read_magic(member)
        _, _, dtype = np.lib.format._read_array_header(member, version)
    return dtype


def test_checkpoint_digest_equals_the_references_and_resolve_keeps_the_bits(tmp_path):
    ref, port = _trees()
    want = JCheckpointStore(str(tmp_path / "ref")).save("step_1", ref)
    store = CheckpointStore(str(tmp_path / "port"))
    got = store.save("step_1", port)
    assert got == want
    man = store.manifest("step_1")
    assert {k: e["dtype"] for k, e in man["entries"].items()} == {
        "e": "bfloat16",
        "m/f": "float32",
        "m/i": "int32",
        "s": "bfloat16",
        "w": "bfloat16",
    }
    assert man["entries"] == JCheckpointStore(str(tmp_path / "ref")).manifest("step_1")["entries"]
    shard = tmp_path / "port" / "step_1" / "shard-0.npz.zst"
    assert _member_dtype(shard, "w") == np.dtype("|V2")
    back = store.resolve(got, port)
    for k in ("w", "e", "s"):
        _same_bits(back[k], ref[k])
    np.testing.assert_array_equal(back["m"]["f"], ref["m"]["f"])
    assert back["m"]["i"].dtype == np.int32
    # the digest checks the bits: one flipped bit of a bfloat16 leaf is a different ref
    flipped = dict(port, w=BFloat16Array(port["w"].bits() ^ np.uint16(1)))
    assert CheckpointStore(str(tmp_path / "flip")).save("step_1", flipped) != got


# (c) ----------------------------------------------------------------------------------


def test_the_port_resolves_a_bfloat16_checkpoint_the_reference_wrote(tmp_path):
    ref, port = _trees(seed=3)
    jstore = JCheckpointStore(str(tmp_path))
    ref_id = jstore.save("step_1", ref)
    back = CheckpointStore(str(tmp_path)).resolve(ref_id, port)
    for k in ("w", "e", "s"):
        _same_bits(back[k], ref[k])
    np.testing.assert_array_equal(back["m"]["f"], ref["m"]["f"])


def test_the_reference_cannot_resolve_its_own_bfloat16_checkpoint(tmp_path):
    """The reference's fault the port does not reproduce: its bfloat16 member reads back as
    ``|V2`` and digests as ``"|V2"``, not as the ``"bfloat16"`` it was saved under."""
    ref, _ = _trees(seed=3)
    jstore = JCheckpointStore(str(tmp_path))
    ref_id = jstore.save("step_1", ref)
    with pytest.raises(ValueError, match="content mismatch"):
        jstore.resolve(ref_id, ref)
    assert jstore.restore("step_1", ref)["w"].dtype == np.dtype("|V2")


# (d) ----------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_payload_and_canonical_digests_equal_the_references(seed):
    ref, port = _trees(seed)
    assert twire.payload_digest(port) == jwire.payload_digest(ref)
    assert twire.canonical_digest(port) == jwire.canonical_digest(ref)
    assert twire.canonical_bytes(port) == jwire.canonical_bytes(ref)
    # a CPU tensor digests as its host form
    tens = {k: torch.from_numpy(port[k].bits().view(np.int16).copy()).view(torch.bfloat16)
            for k in ("w", "e", "s")}
    tens["m"] = port["m"]
    assert twire.payload_digest(tens) == twire.payload_digest(port)
    assert twire.canonical_digest(tens) == twire.canonical_digest(port)


# (e) ----------------------------------------------------------------------------------


def test_packer_encodes_bfloat16_as_the_reference_and_decodes_it_back():
    ref, port = _trees(seed=5)
    frame = packer.packb(port)
    assert frame == msgpack.packb(ref, default=pack_default, use_bin_type=True)
    back = packer.unpackb(frame)
    for k in ("w", "e", "s"):
        _same_bits(back[k], ref[k])
    assert twire.payload_digest(back) == twire.payload_digest(port)
    assert twire.payload_digest(twire.decode_payload(twire.encode_payload(port))) == (
        twire.payload_digest(port)
    )
    # what the reference reads from those bytes: a plain |V2 array of the same bits
    theirs = msgpack.unpackb(frame, raw=False, strict_map_key=False, ext_hook=unpack_ext)
    assert theirs["w"].dtype == np.dtype("|V2")
    assert np.array_equal(theirs["w"].view(np.uint16), port["w"].bits())


# (f) ----------------------------------------------------------------------------------


def test_raw_frame_shards_read_through_both_packages(tmp_path):
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((16, 8)).astype(np.float32), "b": {"c": np.float32(2.5)}}
    store = CheckpointStore(str(tmp_path))
    ref_id = store.save("step_4", tree)
    shard = tmp_path / "step_4" / "shard-0.npz.zst"
    data = shard.read_bytes()
    assert data[0] == TAG_RAW and data[1:3] == b"PK"  # the npz as it is, after the tag
    for decompress in (twire.decompress, jwire.decompress):
        npz = np.load(io.BytesIO(decompress(data)))
        np.testing.assert_array_equal(npz["a"], tree["a"])
    jstore = JCheckpointStore(str(tmp_path))
    np.testing.assert_array_equal(jstore.restore("step_4", tree)["a"], tree["a"])
    np.testing.assert_array_equal(jstore.resolve(ref_id, tree)["b"]["c"], 2.5)
    # and the port still reads the reference's compressed frames
    jref = JCheckpointStore(str(tmp_path / "ref")).save("step_4", tree)
    assert jref == ref_id
    back = CheckpointStore(str(tmp_path / "ref")).resolve(jref, tree)
    np.testing.assert_array_equal(back["a"], tree["a"])


# (g) ----------------------------------------------------------------------------------

BF16_ARCHS = ["qwen3-1.7b", "rwkv6-7b"]
STEPS, EVERY, BATCH, SEQ = 3, 2, 2, 32


def _bf16_smoke(arch):
    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


def _tc(run_dir):
    return TrainConfig(
        run_dir=str(run_dir),
        num_steps=STEPS,
        checkpoint_every=EVERY,
        log_every=100,
        global_batch=BATCH,
        seq_len=SEQ,
        heartbeat=False,
        opt=AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=STEPS),
    )


def _direct(cfg, tc, steps):
    """``steps`` steps of make_train_step from the trainer's seeded init and batches."""
    torch.use_deterministic_algorithms(True)
    try:
        model = build(cfg, "cpu")
        params = init_params(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
        state = make_opt_init(model, tc.opt)(params)
        step = make_train_step(model, tc.opt)
        src = TokenSource(DataConfig(cfg.vocab_size, tc.seq_len, tc.global_batch, seed=tc.seed))
        for s in range(steps):
            batch = {k: torch.from_numpy(v).long() for k, v in src.batch_at(s).items()}
            params, state, _ = step(params, state, batch)
        return params, state
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_smoke_model_crashes_between_halves_and_replays_bit_exact(arch, tmp_path):
    cfg, tc = _bf16_smoke(arch), _tc(tmp_path)
    Trainer(cfg, tc, device="cpu").train()
    recs = list(Journal(str(tmp_path / "journal.wal"), sync="never").records())
    steps_a = {r.node_id: r.output_digest for r in recs if r.kind == "NODE_COMMIT"}
    refs_a = [r.ref for r in recs if r.kind == "CKPT"]
    assert len(refs_a) == 2
    store = CheckpointStore(str(tmp_path / "ckpt"))
    for tag in ("step00000002", "step00000003"):
        kinds = {e["dtype"] for e in store.manifest(tag)["entries"].values()}
        assert kinds == {"bfloat16"}, (tag, kinds)  # every param is bfloat16
        assert "float32" in {e["dtype"] for e in store.manifest(tag + "-opt")["entries"].values()}

    # the pair holds the state of two direct steps, bit for bit
    _, params, state = restore_pair(store, "step00000002", cfg, tc.opt, torch.device("cpu"))
    want_p, want_s = _direct(cfg, tc, 2)
    got_leaves = tree_leaves({"p": params, "s": state})
    want_leaves = tree_leaves({"p": want_p, "s": want_s})
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves, strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)

    shutil.rmtree(tmp_path / "ckpt" / "step00000003-opt")  # the crash between the halves
    Trainer(cfg, tc, device="cpu").train()
    new = list(Journal(str(tmp_path / "journal.wal"), sync="never").records())[len(recs) :]
    assert [r.node_id for r in new if r.kind == "RUN_START"] == ["round2"]
    assert [r.node_id for r in new if r.kind == "NODE_START"] == ["step@2", "ckpt@3"]
    step2 = [r.output_digest for r in new if r.kind == "NODE_COMMIT" and r.node_id == "step@2"]
    assert step2 == [steps_a["step@2"]]
    assert [r.ref for r in new if r.kind == "CKPT"] == [refs_a[-1]]
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["steps"] == 1 and summary["restore_s"] > 0


def test_bf16_restore_reads_the_host_form_and_the_references_state():
    """``from_numpy_opt_state`` takes bfloat16 moments in either host form, by their bits."""
    bits = _bits((3, 4), seed=9)
    for host in (BFloat16Array(bits), bits.view(ml_dtypes.bfloat16)):
        st = from_numpy_opt_state({"m": {"a": host}, "v": {"a": host}, "step": np.int32(2)}, "cpu")
        assert st["m"]["a"].dtype == torch.bfloat16
        assert torch.equal(st["v"]["a"].view(torch.int16), torch.from_numpy(bits.view(np.int16)))


# (h) ----------------------------------------------------------------------------------


def _mean_cases(n, seed):
    """n shards of bfloat16 bits: random values; pairs whose float32 mean falls halfway
    between two bfloat16 (ties, to even both ways); subnormals and their halves; ±inf
    (inf - inf gives NaN); a NaN; the largest finite value twice (its float32 sum overflows to
inf, in both packages)."""
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 1 << 16, size=(64,), dtype=np.uint16) for _ in range(n)]
    edges = [
        (0x3F80, 0x3F81),  # 1 and the next bfloat16: the mean 0x3F808000 ties, to 0x3F80
        (0x3F81, 0x3F82),  # ties up to the even 0x3F82
        (0xBF81, 0xBF82),
        (0x0001, 0x0000),  # the least subnormal and zero: a subnormal tie
        (0x007F, 0x0001),
        (0x8003, 0x8000),
        (0x7F80, 0x3F80),  # +inf
        (0xFF80, 0x3F80),  # -inf
        (0x7F80, 0xFF80),  # NaN
        (0x7FC0, 0x3F80),  # NaN
        (0x7F7F, 0x7F7F),  # the largest finite
    ]
    for i, pair in enumerate(edges):
        for k, shard in enumerate(shards):
            shard[i] = pair[k % 2]
    return shards


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_bf16_shard_mean_is_bit_equal_to_the_references(n):
    """The port's ``_mean_pytrees`` on ``BFloat16Array`` leaves against the reference's on
    ``ml_dtypes`` arrays of the same bits, beside a float32 leaf: every bit equal (NaN
    included: the quiet NaN of its sign), the payload digests equal, the types kept."""
    from repro.train.distributed import _mean_pytrees as jmean_pytrees
    from repro_torch.train.distributed import _mean_pytrees

    rng = np.random.default_rng(n)
    bits = _mean_cases(n, seed=n)
    f32 = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(n)]
    got = _mean_pytrees([{"w": BFloat16Array(b), "f": f} for b, f in zip(bits, f32)])
    want = jmean_pytrees([{"w": b.view(ml_dtypes.bfloat16), "f": f} for b, f in zip(bits, f32)])
    _same_bits(got["w"], want["w"])
    assert np.array_equal(got["f"].view(np.uint32), np.asarray(want["f"]).view(np.uint32))
    assert twire.payload_digest(got) == jwire.payload_digest(
        {k: np.asarray(v) for k, v in want.items()}
    )
    values = got["w"].float32()
    assert np.isnan(values[9]) and np.isinf(values[6:8]).all()
    assert np.isinf(values[10]) == (n > 1)
    if n % 2 == 0:  # each pair's mean is its two values': ties, to even both ways; inf - inf
        assert got["w"].bits()[:3].tolist() == [0x3F80, 0x3F82, 0xBF82]
        assert np.isnan(values[8])


def test_a_bfloat16_distributed_round_reduces_to_the_shard_mean(tmp_path):
    """A bfloat16 smoke model through ``DistributedTrainer`` (2 shards on 2 in-process
    workers, 1 step): the checkpointed params equal, bit for bit, AdamW's step on the
    bfloat16 mean of the two shards' gradients computed here by the ``grad_shard`` task
    and the port's ``_mean_pytrees``, whose leaves are bfloat16."""
    from repro_torch.core import Context
    from repro_torch.train.distributed import _mean_pytrees, build_grad_registry

    cfg = _bf16_smoke("qwen3-1.7b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    tc = DistTrainConfig(
        run_dir=str(tmp_path / "run"),
        num_steps=1,
        checkpoint_every=1,
        log_every=100,
        global_batch=2,
        seq_len=SEQ,
        heartbeat=False,
        num_shards=2,
        num_workers=2,
        opt=opt,
    )
    trainer = DistributedTrainer(cfg, tc, device="cpu")
    assert trainer.train()["steps"] == 1
    _, params, _ = restore_pair(trainer.store, "step00000001", cfg, opt, torch.device("cpu"))

    torch.use_deterministic_algorithms(True)
    try:
        model = build(cfg, "cpu")
        params0 = init_params(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
        task = build_grad_registry(model, trainer.data_cfg).get("grad_shard")
        sync = {"step": 0, "params": to_host(params0)}
        shards = [
            task(Context.origin({"shard": k, "num_shards": 2}), sync)["grads"] for k in (0, 1)
        ]
        mean = _mean_pytrees(shards)
        assert all(isinstance(x, BFloat16Array) for x in tree_leaves(mean))
        state0 = make_opt_init(model, opt)(params0)
        with torch.no_grad():
            want, _, _ = adamw_update(params0, from_numpy_tree(mean, "cpu"), state0, opt)
    finally:
        torch.use_deterministic_algorithms(False)
    for got, w in zip(tree_leaves(params), tree_leaves(want), strict=True):
        assert got.dtype == w.dtype == torch.bfloat16 and torch.equal(got, w)
