"""The port's durable ``Trainer`` against the JAX package's, on the CPU.

The reference's ``Trainer.train()`` fails on the installed JAX (its sharding
rules), but its round graph runs when no rules are installed. The port's
round graph, started from the reference's own init, is held against that
graph's journal record by record: the run context, the ``data@`` records to
the byte, ``step@0``'s context and input digests, and the metrics of steps 0
and 1 within STEP_RTOL. The port's trainer then resumes the reference's run
from its checkpoint. The ten tests of ``tests/test_trainer.py`` are mirrored
under their names on ``device="cpu"``, with two added: the in-place step gives
the out-of-place step's bits, and a run killed between a step's commit and
its round's checkpoint re-executes and verifies the steps from the seed's
init. Last, the CLI in a subprocess.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.checkpoint.store import CheckpointStore as JCheckpointStore
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.wire.msgpack_codec import pack_default
from repro_torch.checkpoint import atomic_write_bytes
from repro_torch.configs import get_config, smoke_variant
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.params import from_numpy_opt_state, from_numpy_tree, init_params
from repro_torch.train import make_donating_train_step, make_opt_init, make_train_step
from repro_torch.train.host import to_host
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.wire import compress, decompress, payload_digest

REPO = Path(__file__).resolve().parents[1]
ARCH = "serpytor-demo-100m"
# Float32 on both sides, the same step summed in other orders (XLA against ATen): the
# metrics agree to ~2e-7 of their size. They are held at 1e-5 relative.
STEP_RTOL = 1e-5


def _tc(tmp, **kw):
    base = dict(
        run_dir=str(tmp),
        num_steps=6,
        checkpoint_every=3,
        log_every=100,
        global_batch=2,
        seq_len=32,
        heartbeat=False,
        journal_sync="batch",
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6, clip_norm=1.0),
    )
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def small_cfg():
    return smoke_variant(get_config(ARCH))


def _trainer(cfg, tc):
    return Trainer(cfg, tc, device="cpu")


def _records(path, core):
    return list(core.Journal(str(path), sync="never").records())


# --------------------------------------------------------------------------
# the round graph against the reference's
# --------------------------------------------------------------------------


def _wire(rec):
    """A record's msgpack bytes with its wall time zeroed."""
    return msgpack.packb({**rec.to_obj(), "t": 0.0}, default=pack_default, use_bin_type=True)


def test_round_graph_matches_the_references_journal(tmp_path):
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6, clip_norm=1.0)
    base = dict(num_steps=6, checkpoint_every=3, log_every=100, global_batch=2, seq_len=32)
    base.update(heartbeat=False, journal_sync="batch")
    jrun = tmp_path / "jax"
    jcfg = JTrainConfig(str(jrun), opt=JAdamWConfig(**opt), **base)
    jt = JTrainer(jsmoke(jget_config(ARCH)), jcfg)
    _, params, opt_state = jt.recover()
    np_params = jax.tree.map(lambda x: np.array(x, copy=True), params)
    np_opt = jax.tree.map(lambda x: np.array(x, copy=True), opt_state)
    jstate = {"params": params, "opt": opt_state}
    jcore.LocalExecutor(max_workers=4, journal=jt.journal).run(jt._round_graph(0, 2, jstate, {}))
    jt.store.wait()
    jt.journal.flush()

    trun = tmp_path / "torch"
    cfg = smoke_variant(get_config(ARCH))
    tt = Trainer(cfg, TrainConfig(str(trun), opt=AdamWConfig(**opt), **base), "cpu")
    tstate = {
        "params": from_numpy_tree(np_params, "cpu"),
        "opt": from_numpy_opt_state(np_opt, "cpu"),
    }
    tcore.LocalExecutor(max_workers=4, journal=tt.journal).run(tt._round_graph(0, 2, tstate, {}))
    tt.store.wait()
    tt.journal.flush()

    assert tt.run_context().digest() == jt.run_context().digest() == "849eecce13dfb434"
    want = {(r.kind, r.node_id): r for r in _records(jrun / "journal.wal", jcore)}
    got = {(r.kind, r.node_id): r for r in _records(trun / "journal.wal", tcore)}
    assert sorted(got) == sorted(want)
    for key in want:
        if key[1].startswith("data@"):
            assert _wire(got[key]) == _wire(want[key]), key
    assert want["NODE_COMMIT", "data@0"].output_digest == "959e49ceb0fb44ab"
    for kind in ("NODE_START", "NODE_COMMIT"):
        g, w = got[kind, "step@0"], want[kind, "step@0"]
        assert (g.context_digest, g.input_digest) == (w.context_digest, w.input_digest)
    assert want["NODE_COMMIT", "step@0"].context_digest == "b7b3a9a57ad18e63"
    for step in ("step@0", "step@1"):
        g, w = got["NODE_COMMIT", step].payload, want["NODE_COMMIT", step].payload
        assert sorted(g) == sorted(w)
        for k in ("loss", "ce", "z_loss", "aux_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL, atol=1e-7, err_msg=k)
        assert (g["step"], g["data_digest"]) == (w["step"], w["data_digest"])
    assert round(want["NODE_COMMIT", "step@1"].payload["loss"], 6) == 6.107254

    # the port's trainer resumes the reference's run from the reference's checkpoint
    resumed = tmp_path / "resumed"
    shutil.copytree(jrun, resumed)
    base["num_steps"] = 3
    tr = Trainer(cfg, TrainConfig(str(resumed), opt=AdamWConfig(**opt), **base), "cpu")
    out = tr.train()
    assert out["steps"] == 1 and [m["step"] for m in tr.metrics_log] == [2]
    graph = jt._round_graph(2, 3, jstate, {}, incarnation=1)
    jcore.LocalExecutor(max_workers=4, journal=jt.journal).run(graph)
    jt.store.wait()
    jstep2 = [r for r in _records(jrun / "journal.wal", jcore) if r.node_id == "step@2"][-1]
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(tr.metrics_log[0][k], jstep2.payload[k], rtol=STEP_RTOL)
    # and the reference reads the port's journal and resolves its checkpoint
    kinds = [r.kind for r in _records(resumed / "journal.wal", jcore)]
    assert kinds.count("CKPT") == 2 and kinds.count("RUN_END") == 2
    like = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), np_params)
    ref = [r.ref for r in _records(resumed / "journal.wal", jcore) if r.kind == "CKPT"][-1]
    ref_p = ref.split(";")[0]
    restored = JCheckpointStore(str(resumed / "ckpt")).resolve(ref_p, like)
    assert payload_digest(restored) == payload_digest(tr.store.resolve(ref_p, like))


# --------------------------------------------------------------------------
# tests/test_trainer.py, mirrored
# --------------------------------------------------------------------------


def test_train_runs_and_reduces_loss(tmp_path, small_cfg):
    tr = _trainer(small_cfg, _tc(tmp_path / "runA", num_steps=8, checkpoint_every=4))
    out = tr.train()
    assert out["steps"] == 8
    losses = [m["loss"] for m in tr.metrics_log]
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]  # learning on zipf data


def test_checkpoints_written_every_round(tmp_path, small_cfg):
    tr = _trainer(small_cfg, _tc(tmp_path / "runB"))
    tr.train()
    tags = tr.store.list()
    assert "step00000003" in tags and "step00000006" in tags


def test_restart_resumes_from_snapshot(tmp_path, small_cfg):
    run = tmp_path / "runC"
    tr1 = _trainer(small_cfg, _tc(run, num_steps=3, checkpoint_every=3))
    tr1.train()

    # same run_dir, more steps: must resume at 3, not recompute 0-2
    tr2 = _trainer(small_cfg, _tc(run, num_steps=6, checkpoint_every=3))
    out = tr2.train()
    assert out["steps"] == 3  # only the new steps ran
    steps_run = [m["step"] for m in tr2.metrics_log]
    assert steps_run == [3, 4, 5]


def test_crash_recovery_resumes_and_matches_uninterrupted(tmp_path, small_cfg):
    """Interrupted-at-step-4 run == uninterrupted run (durable execution)."""
    ref = _trainer(small_cfg, _tc(tmp_path / "runRef", num_steps=6, checkpoint_every=2))
    ref.train()
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}

    # crash after step 3 (two rounds committed: ckpt@2, ckpt@4)
    tr1 = _trainer(small_cfg, _tc(tmp_path / "runD", num_steps=4, checkpoint_every=2))
    tr1.train()
    del tr1  # "crash"

    tr2 = _trainer(small_cfg, _tc(tmp_path / "runD", num_steps=6, checkpoint_every=2))
    tr2.train()
    got = {m["step"]: m["loss"] for m in tr2.metrics_log}
    for s in (4, 5):
        # the reference test's bound; the port gives equal bits here
        assert abs(got[s] - ref_losses[s]) < 1e-4, f"step {s}: {got[s]} != {ref_losses[s]}"
        assert got[s] == ref_losses[s]


def test_journal_has_step_commits(tmp_path, small_cfg):
    run = tmp_path / "runE"
    tr = _trainer(small_cfg, _tc(run, num_steps=3, checkpoint_every=3))
    tr.train()
    kinds = {}
    for rec in tcore.Journal(str(run / "journal.wal"), sync="never").records():
        kinds.setdefault(rec.kind, []).append(rec.node_id)
    assert any(n.startswith("step@") for n in kinds.get("NODE_COMMIT", []))
    assert "CKPT" in kinds
    assert "RUN_START" in kinds and "RUN_END" in kinds


def test_summary_written(tmp_path, small_cfg):
    run = tmp_path / "runF"
    _trainer(small_cfg, _tc(run, num_steps=2, checkpoint_every=2)).train()
    summary = json.load(open(run / "summary.json"))
    assert summary["steps"] == 2 and len(summary["log"]) == 2
    assert summary["restore_s"] == 0.0 and set(summary["checkpoint_s"]) == {
        "step00000002",
        "step00000002-opt",
    }


def test_digest_mismatch_does_not_advance_params(tmp_path, small_cfg):
    """Replay verification is compute-then-verify-then-SWAP: a step whose
    recomputation disagrees with the journal must fail WITHOUT mutating
    state — the restored snapshot stays intact for forensics."""
    tr = _trainer(small_cfg, _tc(tmp_path / "runG", num_steps=2))
    start, params, opt_state = tr.recover()
    state = {"params": params, "opt": opt_state}
    before = payload_digest(to_host(state))

    # a journal claiming step 0 committed with a digest the (deterministic)
    # recomputation cannot possibly produce
    graph = tr._round_graph(0, 1, state, {0: "bogus-journal-digest"}, incarnation=1)
    with pytest.raises(RuntimeError, match="non-deterministic replay"):
        tcore.LocalExecutor(max_workers=2).run(graph)
    assert payload_digest(to_host(state)) == before  # the failed step did NOT advance params


def test_step_never_rerun_after_donation(tmp_path, small_cfg):
    """The in-place (fresh-execution) step consumes its input buffers; a
    second execution of the same step must be refused, not retried."""
    tr = _trainer(small_cfg, _tc(tmp_path / "runH", num_steps=1))
    start, params, opt_state = tr.recover()
    state = {"params": params, "opt": opt_state}
    try:
        g1 = tr._round_graph(0, 1, state, {}, incarnation=0)
        tcore.LocalExecutor(max_workers=2).run(g1)  # updates step 0's buffers in place
        # step nodes must opt out of executor-policy retries outright
        assert g1.nodes["step@0"].retries == 0
        g2 = tr._round_graph(0, 1, state, {}, incarnation=0)
        with pytest.raises(RuntimeError, match="donated"):
            tcore.LocalExecutor(max_workers=2).run(g2)
    finally:
        tr.store.wait()


def test_recover_falls_back_on_half_published_pair(tmp_path, small_cfg):
    """An async -opt write that never landed must not wedge recovery: the
    newest COMPLETE pair wins."""
    run = tmp_path / "runI"
    tr = _trainer(small_cfg, _tc(run, num_steps=4, checkpoint_every=2))
    tr.train()
    assert tr.store.latest() == "step00000004"
    # simulate the crash window: base tag published, companion lost
    shutil.rmtree(run / "ckpt" / "step00000004-opt")

    tr2 = _trainer(small_cfg, _tc(run, num_steps=4, checkpoint_every=2))
    start, params, opt_state = tr2.recover()
    assert start == 2  # fell back to the newest complete pair, didn't crash


def test_recover_rejects_corrupted_checkpoint(tmp_path, small_cfg):
    """Recovery restores through the digest-verified resolve() path: tensor
    bytes flipped on disk (shapes intact) must abort, not train onward."""
    import io

    run = tmp_path / "runJ"
    tr = _trainer(small_cfg, _tc(run, num_steps=2, checkpoint_every=2))
    tr.train()

    shard = run / "ckpt" / "step00000002" / "shard-0.npz.zst"
    npz = np.load(io.BytesIO(decompress(shard.read_bytes())))
    flat = {k: npz[k].copy() for k in npz.files}
    key = sorted(flat)[0]
    flat[key].reshape(-1)[0] += 1.0  # same shape/dtype, different bytes
    buf = io.BytesIO()
    np.savez(buf, **flat)
    atomic_write_bytes(str(shard), compress(buf.getvalue(), level=3))

    tr2 = _trainer(small_cfg, _tc(run, num_steps=4, checkpoint_every=2))
    with pytest.raises(ValueError, match="content mismatch"):
        tr2.recover()


# --------------------------------------------------------------------------
# added: the in-place step's bits, a run killed before its checkpoint
# --------------------------------------------------------------------------


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_in_place_step_gives_the_out_of_place_steps_bits(small_cfg, deterministic):
    """Three steps of the donating step and of make_train_step from the same init: equal
    digests of metrics, params, m, v and step after every step; the donating step
    returns the buffers it was given."""
    from repro_torch.data import DataConfig, TokenSource
    from repro_torch.models import build

    model = build(small_cfg, "cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6, clip_norm=0.5)
    src = TokenSource(DataConfig(vocab_size=small_cfg.vocab_size, seq_len=32, global_batch=2))

    def init():
        params = init_params(small_cfg, torch.Generator().manual_seed(0), "cpu")
        return params, make_opt_init(model, opt)(params)

    out_of_place, in_place = make_train_step(model, opt), make_donating_train_step(model, opt)
    (p1, s1), (p2, s2) = init(), init()
    for step in range(3):
        batch = {"tokens": torch.from_numpy(src.batch_at(step)["tokens"]).long()}
        p1, s1, m1 = out_of_place(p1, s1, batch)
        q2, t2, m2 = in_place(p2, s2, batch)
        assert q2 is p2 and t2 is s2
        want = payload_digest(to_host({"m": m1, "p": p1, "s": s1}))
        assert payload_digest(to_host({"m": m2, "p": p2, "s": s2})) == want, step
        assert int(s2["step"]) == step + 1


def test_run_killed_before_its_checkpoint_reexecutes_and_verifies(tmp_path, small_cfg):
    """step@0 and step@1 commit, then the round's checkpoint dies: a new trainer on the
    same run dir finds no checkpoint, draws the seed's init again, re-executes both
    steps through the verify twin and checks each against its journaled digest."""
    run = tmp_path / "runK"
    tr1 = _trainer(small_cfg, _tc(run, num_steps=2, checkpoint_every=2))

    def killed(*args, **kwargs):
        raise RuntimeError("killed before the checkpoint")

    tr1.store.save = killed
    with pytest.raises(RuntimeError, match="killed before the checkpoint"):
        tr1.train()
    first = _records(run / "journal.wal", tcore)
    commits = {r.node_id: r.output_digest for r in first if r.kind == "NODE_COMMIT"}
    assert {"step@0", "step@1"} <= set(commits) and not any(r.kind == "CKPT" for r in first)

    tr2 = _trainer(small_cfg, _tc(run, num_steps=2, checkpoint_every=2))
    calls = []
    verify = tr2._train_step_verify
    tr2._train_step_verify = lambda *a: calls.append(1) or verify(*a)
    out = tr2.train()
    assert out["steps"] == 2 and len(calls) == 2  # both steps went through the verify twin
    second = _records(run / "journal.wal", tcore)[len(first) :]
    again = {r.node_id: r.output_digest for r in second if r.kind == "NODE_COMMIT"}
    assert again["step@0"] == commits["step@0"] and again["step@1"] == commits["step@1"]
    assert not any(r.kind == "NODE_START" and r.node_id.startswith("data@") for r in second)
    assert any(r.kind == "CKPT" for r in second)


def test_trainer_refusals(tmp_path, small_cfg, monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        _trainer(small_cfg, _tc(tmp_path / "a", mesh_model_axis=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(small_cfg, _tc(tmp_path / "b"))  # cuda by default, and no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        Trainer(small_cfg, _tc(tmp_path / "c"), device="cuda")
    assert not os.path.exists(tmp_path / "c")


def test_train_restores_the_determinism_setting(tmp_path, small_cfg):
    before = torch.are_deterministic_algorithms_enabled()
    _trainer(small_cfg, _tc(tmp_path / "d", num_steps=1, checkpoint_every=1)).train()
    assert torch.are_deterministic_algorithms_enabled() == before


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_cli_trains_the_reduced_config_on_the_cpu(tmp_path):
    run = tmp_path / "cli"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH]
    cmd += ["--device", "cpu", "--steps", "2", "--run-dir", str(run)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(f"training {ARCH}-smoke:") and "on cpu" in lines[0]
    assert lines[1].startswith("heartbeat at http://127.0.0.1:")
    assert "done: 2 steps" in proc.stdout
    assert lines[-1] == (
        'kernel launches {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "rglru_scan": 0, '
        '"rglru_bwd": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}'
    )
    summary = json.load(open(run / "summary.json"))
    assert summary["steps"] == 2 and [m["step"] for m in summary["log"]] == [0, 1]
