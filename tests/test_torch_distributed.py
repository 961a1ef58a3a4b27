"""The port's data-parallel trainer against the JAX package's, on the CPU.

The reference's ``DistributedTrainer.train()`` fails on the installed JAX (its
sharding rules), but its ``grad_shard`` task and its round graph run when no
rules are installed. Here: the reference's ``grad_shard`` against the port's
on carried-across smoke params (loss and every gradient leaf), the fixed-order
mean bit for bit, and the reference's round graph run on its
``ClusterExecutor`` against the port's on the same params (node ids and
kinds, every context digest, the input digests of ``sync@0`` and
``grad@0#k``, the metrics within STEP_RTOL). Then the five tests of
``tests/test_distributed_train.py`` on ``device="cpu"``, a round over HTTP
workers, the RNG rule (no task draws torch randomness) and the CLI.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import build as jbuild
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.distributed import DistTrainConfig as JDistTrainConfig
from repro.train.distributed import DistributedTrainer as JDistributedTrainer
from repro.train.distributed import _mean_pytrees as jmean_pytrees
from repro.train.distributed import build_grad_registry as jbuild_grad_registry
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import FlakyWorker, InProcWorker, Journal, WorkerClient, WorkerServer
from repro_torch.data import DataConfig
from repro_torch.models import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.params import from_numpy_opt_state, from_numpy_tree
from repro_torch.train import DistributedTrainer, DistTrainConfig, Trainer, build_grad_registry
from repro_torch.train.distributed import _mean_pytrees
from repro_torch.train.trainer import TrainConfig
from repro_torch.wire import payload_digest

REPO = Path(__file__).resolve().parents[1]
ARCH = "serpytor-demo-100m"
# Float32 on both sides, the same model summed in other orders (XLA against ATen), the
# tolerances of tests/test_torch_train.py: losses 1e-5 relative, gradients 1e-4 relative to
# each leaf's largest entry; a step's metrics 1e-5 relative (tests/test_torch_trainer.py).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5


@pytest.fixture(scope="module")
def small_cfg():
    return smoke_variant(get_config(ARCH))


def _tc(run_dir, **kw):
    base = dict(
        run_dir=str(run_dir),
        num_steps=4,
        checkpoint_every=4,
        log_every=100,
        global_batch=4,
        seq_len=32,
        heartbeat=False,
        journal_sync="batch",
        num_shards=2,
        num_workers=2,
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4),
    )
    base.update(kw)
    return DistTrainConfig(**base)


def _trainer(cfg, tc, **kw):
    return DistributedTrainer(cfg, tc, device="cpu", **kw)


def _final_digest(trainer):
    """Content-true digest of the newest published checkpoint."""
    return trainer.store.manifest(trainer.store.latest())["digest"]


def _reference(small_cfg, tmp_path):
    ref = _trainer(small_cfg, _tc(tmp_path / "ref"))
    ref.train()
    return _final_digest(ref), ref


def _leaves(tree):
    """(path, leaf) pairs in jax.tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    return [("", tree)]


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


# --------------------------------------------------------------------------
# grad_shard, the mean and the round graph against the reference's
# --------------------------------------------------------------------------


def test_grad_shard_matches_the_references():
    """Shards 0 and 1 of 2 at steps 0 and 1 from the same params: equal shard ids, loss
    within LOSS_RTOL, every gradient leaf (host float32 arrays) within GRAD_RTOL; the
    port's task leaves torch's global RNG as it was."""
    jcfg, tcfg = jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))
    jmodel = jbuild(jcfg)
    params = _np(jmodel.init(jax.random.key(3))[0])
    data = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    jtask = jbuild_grad_registry(jmodel, JDataConfig(**data)).get("grad_shard")
    ttask = build_grad_registry(build(tcfg, "cpu"), DataConfig(**data)).get("grad_shard")
    for step in (0, 1):
        for shard in (0, 1):
            facts = {"shard": shard, "num_shards": 2}
            want = jtask(jcore.Context.origin(facts), {"step": step, "params": params})
            rng = torch.random.get_rng_state()
            got = ttask(tcore.Context.origin(facts), {"step": step, "params": params})
            assert torch.equal(torch.random.get_rng_state(), rng)
            assert got["shard"] == want["shard"] == shard and sorted(got) == sorted(want)
            assert isinstance(got["loss"], float)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
            for (path, g), (_, w) in zip(
                _leaves(got["grads"]), _leaves(want["grads"]), strict=True
            ):
                assert isinstance(g, np.ndarray) and g.dtype == np.float32, path
                assert g.shape == w.shape, path
                atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{step} {path}")


def test_mean_pytrees_is_bit_equal_to_the_references():
    rng = np.random.default_rng(0)

    def tree():
        return {
            "b": {"w": rng.standard_normal((17, 5)).astype(np.float32) * 1e-3},
            "a": rng.standard_normal((300,)).astype(np.float32),
            "h": rng.standard_normal((4, 3)).astype(np.float16),
        }

    for n in (1, 2, 3, 4):
        trees = [tree() for _ in range(n)]
        got, want = _mean_pytrees(trees), jmean_pytrees(trees)
        assert payload_digest(got) == payload_digest(jax.tree.map(np.asarray, want))
        for (path, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
            w = np.asarray(w)
            assert g.dtype == w.dtype, path
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path


def _journal(core, path):
    recs = {}
    for r in core.Journal(str(path), sync="never").records():
        recs.setdefault((r.kind, r.node_id), []).append(r)
    return recs


def test_round_graph_matches_the_references(tmp_path):
    """Two steps of two shards each, from the reference's init, on each package's
    ClusterExecutor over its own Gateway and workers, outside train()."""
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    base = dict(num_steps=2, checkpoint_every=2, log_every=100, global_batch=4, seq_len=32)
    base.update(heartbeat=False, journal_sync="batch", num_shards=2, num_workers=2)
    jtc = JDistTrainConfig(str(tmp_path / "jax"), opt=JAdamWConfig(**opt), **base)
    jt = JDistributedTrainer(jsmoke(jget_config(ARCH)), jtc)
    _, params, opt_state = jt.recover()
    np_params, np_opt = _np(params), _np(opt_state)
    jstate = {"params": params, "opt": opt_state}
    with jcore.Gateway(jt.workers) as gw:
        jex = jcore.ClusterExecutor(gw, journal=jt.journal, speculative=False)
        jex.run(jt._round_graph(0, 2, jstate, {}))
    jt.store.wait()
    jt.journal.flush()

    tc = DistTrainConfig(str(tmp_path / "torch"), opt=AdamWConfig(**opt), **base)
    tt = _trainer(smoke_variant(get_config(ARCH)), tc)
    tstate = {
        "params": from_numpy_tree(np_params, "cpu"),
        "opt": from_numpy_opt_state(np_opt, "cpu"),
    }
    with tcore.Gateway(tt.workers) as gw:
        tex = tcore.ClusterExecutor(gw, journal=tt.journal, speculative=False)
        report = tex.run(tt._round_graph(0, 2, tstate, {}))
    tt.store.wait()
    tt.journal.flush()

    assert tt.run_context().digest() == jt.run_context().digest()
    want = _journal(jcore, tmp_path / "jax" / "journal.wal")
    got = _journal(tcore, tmp_path / "torch" / "journal.wal")
    assert sorted(got) == sorted(want)
    nodes = {n for kind, n in got if kind == "NODE_COMMIT"}
    assert nodes == {f"{k}@{s}" for k in ("sync", "reduce", "apply") for s in (0, 1)} | {
        f"grad@{s}#{k}" for s in (0, 1) for k in (0, 1)
    } | {"ckpt@2"}
    assert sorted(report.executed) == sorted(nodes)
    for key in want:
        assert [r.context_digest for r in got[key]] == [r.context_digest for r in want[key]], key
    for nid in ("sync@0", "grad@0#0", "grad@0#1"):
        for kind in ("NODE_START", "NODE_COMMIT"):
            assert got[kind, nid][0].input_digest == want[kind, nid][0].input_digest, nid
    # sync@0 publishes the same params: the same output digest
    sync0 = [x["NODE_COMMIT", "sync@0"][0].output_digest for x in (got, want)]
    assert sync0[0] == sync0[1]
    for s in (0, 1):
        g, w = (x["NODE_COMMIT", f"apply@{s}"][0].payload for x in (got, want))
        assert sorted(g) == sorted(w) == ["grad_norm", "loss", "lr", "step"]
        assert g["step"] == w["step"] == s
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL, atol=1e-7, err_msg=k)
    for kind, nid in got:
        if kind == "NODE_COMMIT" and nid.startswith(("sync@", "grad@", "reduce@")):
            (rec,) = got[kind, nid]
            assert rec.payload is None and rec.meta.get("volatile") is True


# --------------------------------------------------------------------------
# tests/test_distributed_train.py, mirrored
# --------------------------------------------------------------------------


def test_distributed_round_trains_and_reduces_loss(tmp_path, small_cfg):
    tr = _trainer(small_cfg, _tc(tmp_path / "runA"))
    out = tr.train()
    assert out["steps"] == 4
    steps = [m["step"] for m in tr.metrics_log]
    assert steps == [0, 1, 2, 3]  # numeric order, not lexicographic
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]


def test_volatile_commits_keep_tensors_out_of_the_journal(tmp_path, small_cfg):
    tr = _trainer(small_cfg, _tc(tmp_path / "runB", num_steps=2))
    tr.train()
    tensor_nodes = 0
    for rec in Journal(str(tmp_path / "runB" / "journal.wal"), sync="never").records():
        if rec.kind != "NODE_COMMIT":
            continue
        if rec.node_id.startswith(("sync@", "grad@", "reduce@")):
            tensor_nodes += 1
            assert rec.meta.get("volatile") is True
            assert rec.payload is None  # digest-only: tensors never journaled
            assert rec.output_digest
    # 2 steps x (1 sync + 2 grads + 1 reduce)
    assert tensor_nodes == 8


def test_worker_killed_mid_round_converges_bit_identical(tmp_path, small_cfg):
    ref_digest, _ = _reference(small_cfg, tmp_path)

    tr = _trainer(small_cfg, _tc(tmp_path / "kill"))
    # the third task start flips the kill switch: w0 dies with a shard
    # accepted but unfinished — the gateway must requeue it on w1
    tr.workers = [
        FlakyWorker("w0", tr.registry, kill_after_starts=3),
        InProcWorker("w1", tr.registry),
    ]
    out = tr.train()
    assert out["steps"] == 4
    assert _final_digest(tr) == ref_digest  # bit-identical params
    kinds = Journal(str(tmp_path / "kill" / "journal.wal"), sync="never").kinds()
    assert kinds.get("NODE_REQUEUE", 0) >= 1  # the orphaned shard was absorbed


def test_run_killed_mid_round_resumes_bit_identical(tmp_path, small_cfg):
    ref_digest, _ = _reference(small_cfg, tmp_path)

    run = tmp_path / "crash"
    tr1 = _trainer(small_cfg, _tc(run))
    orig = tr1.registry.get("grad_shard")

    def bomb(ctx, sync):
        # the pre-commit kill point: the shard task dies at step 2 before its
        # result can commit, on every attempt of this incarnation
        if int(sync["step"]) == 2:
            raise RuntimeError("injected fault")
        return orig(ctx, sync)

    tr1.registry.register("grad_shard", bomb)
    with pytest.raises(RuntimeError):
        tr1.train()  # dies mid-round: steps 0-1 committed, no checkpoint

    # fresh incarnation, same run_dir: recovery replays the committed steps
    # from the journal (digest-verified) and finishes the run
    tr2 = _trainer(small_cfg, _tc(run))
    out = tr2.train()
    assert out["steps"] == 4  # no snapshot existed: the whole run re-executed
    assert _final_digest(tr2) == ref_digest
    kinds = Journal(str(run / "journal.wal"), sync="never").kinds()
    assert kinds["RUN_START"] == 2
    assert kinds.get("NODE_FAIL", 0) >= 1  # the crash is in the event history


def test_resume_after_completed_round_skips_finished_steps(tmp_path, small_cfg):
    run = tmp_path / "resume"
    tr1 = _trainer(small_cfg, _tc(run, num_steps=2, checkpoint_every=2))
    tr1.train()

    tr2 = _trainer(small_cfg, _tc(run, num_steps=4, checkpoint_every=2))
    out = tr2.train()
    assert out["steps"] == 2  # resumed at the snapshot, not from scratch
    assert [m["step"] for m in tr2.metrics_log] == [2, 3]


# --------------------------------------------------------------------------
# added: HTTP workers, the RNG rule, the refusal, the CLI
# --------------------------------------------------------------------------


def test_a_round_over_http_workers_gives_the_in_process_digest(tmp_path, small_cfg):
    """The same run with each shard's params and gradients crossing a WorkerServer /
    WorkerClient pair as wire frames ends at the in-process run's checkpoint digest."""
    inproc = _trainer(small_cfg, _tc(tmp_path / "inproc", num_steps=2, checkpoint_every=2))
    inproc.train()
    tr = _trainer(small_cfg, _tc(tmp_path / "http", num_steps=2, checkpoint_every=2))
    servers = [WorkerServer(f"w{i}", tr.registry).start() for i in range(2)]
    try:
        tr.workers = [
            WorkerClient(s.name, s.address, s.heartbeat_server.address, timeout=120.0)
            for s in servers
        ]
        tr.train()
    finally:
        for s in servers:
            s.stop()
    assert _final_digest(tr) == _final_digest(inproc)
    assert sum(s.state.completed for s in servers) == 4  # 2 steps x 2 shards, all over HTTP
    assert [m["loss"] for m in tr.metrics_log] == [m["loss"] for m in inproc.metrics_log]


def test_no_task_draws_torch_randomness(tmp_path, small_cfg):
    """The RNG rule: the init is drawn from a seeded torch.Generator of its own, and no
    task of the Trainer's or the DistributedTrainer's rounds (data fetch, step, sync,
    grad_shard, reduce, apply, checkpoint) draws from torch's global generator."""
    torch.manual_seed(1234)
    before = torch.random.get_rng_state()
    local = Trainer(
        small_cfg,
        TrainConfig(
            str(tmp_path / "local"),
            num_steps=2,
            checkpoint_every=1,
            global_batch=2,
            seq_len=32,
            heartbeat=False,
            log_every=100,
        ),
        device="cpu",
    )
    local.train()
    assert torch.equal(torch.random.get_rng_state(), before)
    dist = _trainer(small_cfg, _tc(tmp_path / "dist", num_steps=2, checkpoint_every=1))
    dist.train()
    assert torch.equal(torch.random.get_rng_state(), before)
    assert len(dist.metrics_log) == len(local.metrics_log) == 2


def test_global_batch_must_divide_across_shards(tmp_path, small_cfg):
    with pytest.raises(ValueError, match="must divide across num_shards"):
        _trainer(small_cfg, _tc(tmp_path / "bad", global_batch=3))


def _cli(run_dir, *extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train_distributed", "--device", "cpu"]
    cmd += ["--steps", "4", "--shards", "2", "--workers", "2", "--run-dir", str(run_dir)]
    # one intra-op thread: the smoke model runs thousands of small ops, and a pool as wide as
    # the machine waits at each of them for threads that parallel test workers keep off the
    # cores (the pair of runs took minutes under a full parallel test run, seconds alone)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        cmd + list(extra), capture_output=True, text=True, env=env, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_cli_with_and_without_a_killed_worker_ends_at_one_digest(tmp_path):
    calm, killed = _cli(tmp_path / "calm"), _cli(tmp_path / "killed", "--kill-worker")
    assert calm[0].startswith("arch=serpytor-demo-smoke shards=2 workers=2 batch 2x32")
    assert "on cpu" in calm[0] and "done: 4 steps" in "\n".join(calm)
    assert calm[-2] == (
        'kernel launches {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "rglru_scan": 0, '
        '"rglru_bwd": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}'
    )
    assert calm[-1].startswith("final params digest: ") and killed[-1] == calm[-1]
    assert not any(line.startswith("elastic re-shard") for line in calm)
    assert any(line.startswith("elastic re-shard: ") for line in killed)
