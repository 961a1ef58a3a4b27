"""The port's training slice against the JAX package's, on the same params and data.

``loss_fn`` and every gradient leaf on ``smoke_variant(serpytor-demo-100m)``
(and a copy with a padded vocab), with the reference's params carried in by
``from_numpy_tree``; the port's AdamW against ``repro.optim.adamw`` over 3
steps on a random tree (clip active and not, cosine and constant schedules,
bfloat16 state); 3 steps of ``make_train_step`` against
``jax.jit(make_train_step(build(cfg), opt))`` on ``TokenSource`` batches, and a
step resumed from the reference's params and AdamW state
(``from_numpy_opt_state``); the port's ``TokenSource`` against the
reference's, bit for bit; a step run twice on the CPU, bit for bit; and what
train mode refuses. The JAX side runs its ``ref`` attention dispatch, as its
own tests do on the CPU. Every tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenSource as JTokenSource
from repro.data.pipeline import batch_digest as jbatch_digest
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_opt_init as jmake_opt_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.data import DataConfig, ShardedLoader, TokenSource, batch_digest
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build
from repro_torch.optim import adamw as tadamw
from repro_torch.params import from_numpy_opt_state, from_numpy_tree
from repro_torch.train import make_opt_init, make_train_step
from repro_torch.train.steps import value_and_grad

ARCH = "serpytor-demo-100m"
SEQ, BATCH = 64, 4
# Float32 on both sides, the same model summed in other orders (XLA against ATen): the loss
# agrees to ~1e-7 of its size and the gradients to ~1e-6 of their largest entries. Losses
# are held at 1e-5 relative, gradients at 1e-4 relative to each leaf's largest entry.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _configs(**changes):
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """(path, leaf) pairs in jax.tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    return [("", tree)]


def _batch(step, vocab, seq=SEQ, batch=BATCH):
    src = JTokenSource(JDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=0))
    return src.batch_at(step)


def _assert_tree_close(got, want, rtol, what):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, path)
        atol = rtol * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {path}")


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

VARIANTS = {
    "smoke": {},
    "padded_vocab": {"vocab_size": 500},  # padded to 512: pad logits at -1e30
    "remat_full": {"remat": "full"},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_every_grad_leaf_match_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(3))
    tparams = from_numpy_tree(_np(jparams), device="cpu")
    batch = _batch(0, jcfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(batch["tokens"])}
    )
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    (tloss, tmetrics), tgrads = value_and_grad(
        build(tcfg, "cpu").loss_fn, tparams, {"tokens": torch.from_numpy(batch["tokens"])}
    )
    assert sorted(tmetrics) == sorted(jmetrics) == ["aux_loss", "ce", "loss", "z_loss"]
    for key in jmetrics:
        np.testing.assert_allclose(
            float(tmetrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, atol=1e-7, err_msg=key
        )
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_tree_close(tgrads, jgrads, GRAD_RTOL, "grad")
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0


def test_pad_vocab_slots_get_no_gradient():
    """The unembed's pad columns are written in place (-1e30) on the matmul's output;
    autograd gives them exactly zero gradient, as the reference's ``jnp.where``."""
    _, tcfg = _configs(vocab_size=500)
    from repro_torch.params import init_params

    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(_batch(0, 500)["tokens"])}
    _, grads = value_and_grad(build(tcfg, "cpu").loss_fn, params, batch)
    assert torch.count_nonzero(grads["unembed"][:, 500:]) == 0
    assert torch.count_nonzero(grads["unembed"][:, :500]) > 0


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def _random_tree(rng):
    shapes = {"b": {"w": (6, 5), "bias": (5,)}, "a": (7,), "c": {"z": (2, 3, 4)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)

    return draw(shapes)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_jax_over_three_steps(clip, schedule, state_dtype):
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule, state_dtype=state_dtype)
    rng = np.random.default_rng(11)
    params = _random_tree(rng)
    # gradients of norm ~ 20 (clipped to 1) or ~ 0.2 (left alone)
    gscale = 3.0 if clip == "active" else 0.03
    grads = [jax.tree.map(lambda x: x * gscale, _random_tree(rng)) for _ in range(3)]
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)
    jp, js = params, jadamw.adamw_init(params, jopt)
    tp = from_numpy_tree(params, "cpu")
    ts = tadamw.adamw_init(tp, topt)
    for step in range(3):
        jp, js, jm = jadamw.adamw_update(jp, grads[step], js, jopt)
        tp, ts, tm = tadamw.adamw_update(tp, from_numpy_tree(grads[step], "cpu"), ts, topt)
        # single float32 ops on both sides (pow and cos may differ in the last bit): the
        # metrics agree to 1e-6 relative, params and m to 1e-5 of each leaf's largest
        # entry, v (squares of the gradients) and bfloat16 state to their own rounding
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)
        _assert_tree_close(tp, jp, 1e-5, f"params step {step}")
        state_tol = 1e-2 if state_dtype == "bfloat16" else 1e-5
        _assert_tree_close(ts["m"], js["m"], state_tol, f"m step {step}")
        _assert_tree_close(ts["v"], js["v"], state_tol, f"v step {step}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        dt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
        assert all(x.dtype == dt for x in tadamw.tree_leaves(ts["m"]))
    clipped = float(tm["grad_norm"]) > topt.clip_norm
    assert clipped == (clip == "active")


def test_adamw_leaves_its_inputs_as_they_were():
    rng = np.random.default_rng(2)
    params = from_numpy_tree(_random_tree(rng), "cpu")
    grads = from_numpy_tree(_random_tree(rng), "cpu")
    cfg = tadamw.AdamWConfig()
    state = tadamw.adamw_init(params, cfg)
    before = [x.clone() for x in tadamw.tree_leaves((params, grads, state)[0])]
    tadamw.adamw_update(params, grads, state, cfg)
    assert all(torch.equal(a, b) for a, b in zip(before, tadamw.tree_leaves(params), strict=True))
    assert int(state["step"]) == 0 and all(
        torch.count_nonzero(x) == 0 for x in tadamw.tree_leaves(state["m"])
    )


def test_global_norm_sums_leaves_in_the_reference_order():
    tree = {"b": torch.tensor([3.0]), "a": {"y": torch.tensor([4.0]), "x": torch.tensor([12.0])}}
    assert [float(x) for x in tadamw.tree_leaves(tree)] == [12.0, 4.0, 3.0]
    assert float(tadamw.global_norm(tree)) == 13.0


@pytest.mark.parametrize("step", [0, 1, 19, 20, 500, 10_000, 20_000])
def test_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=20, total_steps=10_000)
    want = jadamw.linear_warmup_cosine(jadamw.AdamWConfig(**cfg))(jnp.int32(step))
    schedule = tadamw.linear_warmup_cosine(tadamw.AdamWConfig(**cfg))
    got = schedule(torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's 3 steps: params, AdamW state and metrics after each."""
    jcfg, _ = _configs()
    jmodel = jbuild(jcfg)
    jopt = jadamw.AdamWConfig(**OPT)
    params, _ = jmodel.init(jax.random.key(0))
    state = jmake_opt_init(jmodel, jopt)(params)
    step_fn = jax.jit(jmake_train_step(jmodel, jopt))
    out = [(_np(params), _np(state), None)]
    for step in range(3):
        batch = {"tokens": jnp.asarray(_batch(step, 512)["tokens"])}
        params, state, metrics = step_fn(params, state, batch)
        out.append((_np(params), _np(state), {k: float(v) for k, v in metrics.items()}))
    return out


# Three steps of float32 training. Metrics, and m after the last step, are held at 1e-5
# relative (of each leaf's largest entry for m). Params move through AdamW's m / sqrt(v),
# which divides a gradient entry by its own size: where an entry is tiny (an embedding row
# of a token seen once), its ~1e-6 relative rounding becomes a visible part of the update.
# So all but a thousandth of each leaf's entries are held at 1e-5 of the leaf's largest
# entry, and every entry within 1% of the most AdamW can move it in three steps (the sum
# of the learning rates); an update of the wrong sign moves an entry by twice the rate.
STEP_RTOL = 1e-5
OUTLIER_SHARE = 1e-3


def _assert_params_close(got, want, lr_sum, what):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        g, w = g.numpy(), np.asarray(w)
        diff = np.abs(g - w)
        loose = diff > STEP_RTOL * np.abs(w).max()
        assert loose.mean() <= OUTLIER_SHARE, (what, path, int(loose.sum()), diff.max())
        assert diff.max() <= 0.01 * lr_sum, (what, path, diff.max())


def test_three_train_steps_match_jax(jax_steps):
    _, tcfg = _configs()
    model = build(tcfg, "cpu")
    opt = tadamw.AdamWConfig(**OPT)
    params = from_numpy_tree(jax_steps[0][0], "cpu")
    state = make_opt_init(model, opt)(params)
    step_fn = make_train_step(model, opt)
    for step in range(3):
        batch = {"tokens": torch.from_numpy(_batch(step, 512)["tokens"])}
        params, state, metrics = step_fn(params, state, batch)
        want = jax_steps[step + 1][2]
        assert sorted(metrics) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(
                float(metrics[key]), w, rtol=STEP_RTOL, atol=1e-7, err_msg=f"{key} step {step}"
            )
    lr_sum = sum(jax_steps[s][2]["lr"] for s in (1, 2, 3))
    _assert_params_close(params, jax_steps[3][0], lr_sum, "params after step 2")
    _assert_tree_close(state["m"], jax_steps[3][1]["m"], STEP_RTOL, "m after step 2")
    assert int(state["step"]) == 3


def test_step_resumed_from_the_reference_state_matches_jax(jax_steps):
    """The reference's params and AdamW state after step 1, carried in by
    ``from_numpy_tree`` and ``from_numpy_opt_state``: the port's step 2 is the reference's."""
    _, tcfg = _configs()
    model = build(tcfg, "cpu")
    params = from_numpy_tree(jax_steps[2][0], "cpu")
    state = from_numpy_opt_state(jax_steps[2][1], "cpu")
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    batch = {"tokens": torch.from_numpy(_batch(2, 512)["tokens"])}
    params, state, metrics = make_train_step(model, tadamw.AdamWConfig(**OPT))(params, state, batch)
    for key, w in jax_steps[3][2].items():
        np.testing.assert_allclose(float(metrics[key]), w, rtol=STEP_RTOL, atol=1e-7, err_msg=key)
    _assert_params_close(params, jax_steps[3][0], jax_steps[3][2]["lr"], "params after step 2")


def test_opt_state_loader_refuses_a_state_without_step():
    with pytest.raises(ValueError, match="step"):
        from_numpy_opt_state({"m": {}, "v": {}}, "cpu")


def test_a_step_run_twice_gives_equal_bits_on_the_cpu(deterministic):
    """Under ``torch.use_deterministic_algorithms(True)``: the same step from the same
    state gives equal metrics, params and AdamW state, bit for bit (the digests too)."""
    from repro_torch.params import init_params
    from repro_torch.wire import payload_digest

    _, tcfg = _configs()
    model = build(tcfg, "cpu")
    opt = tadamw.AdamWConfig(**OPT)
    params = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    state = make_opt_init(model, opt)(params)
    batch = {"tokens": torch.from_numpy(_batch(0, 512)["tokens"])}
    step_fn = make_train_step(model, opt)
    runs = [step_fn(params, state, batch) for _ in range(2)]
    digests = []
    for new_params, new_state, metrics in runs:
        tree = {"metrics": metrics, "params": new_params, "m": new_state["m"], "v": new_state["v"]}
        digests.append(payload_digest(tadamw.tree_map(lambda x: x.numpy(), tree)))
    assert digests[0] == digests[1]
    for a, b in zip(tadamw.tree_leaves(runs[0][0]), tadamw.tree_leaves(runs[1][0]), strict=True):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        dict(vocab_size=512, seq_len=64, global_batch=4, seed=0),
        dict(vocab_size=32000, seq_len=33, global_batch=6, seed=7, num_hosts=3, host_index=2),
        dict(vocab_size=100, seq_len=5, global_batch=2, seed=3, zipf_a=1.1),
    ],
    ids=["smoke", "sharded", "zipf"],
)
def test_token_source_equals_the_reference_bit_for_bit(cfg):
    ours, theirs = TokenSource(DataConfig(**cfg)), JTokenSource(JDataConfig(**cfg))
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])
        assert batch_digest(a) == jbatch_digest(b)


def test_sharded_loader_resumes_at_any_step():
    src = TokenSource(DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=1))
    with ShardedLoader(src, start_step=5) as loader:
        got = [next(loader) for _ in range(3)]
    assert [s for s, _ in got] == [5, 6, 7]
    for step, batch in got:
        assert np.array_equal(batch["tokens"], src.batch_at(step)["tokens"])


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "arch, changes, match",
    [
        # rwkv layers train since the WKV6 backward (tests/test_torch_rwkv_train.py); their
        # train mode refuses what every kind's does
        ("rwkv6-7b", {"remat": "dots"}, "ROADMAP Queue 1 item 13"),
        (ARCH, {"remat": "dots"}, "ROADMAP Queue 1 item 13"),
    ],
    ids=["rwkv", "remat_dots"],
)
def test_train_mode_refuses_what_is_not_ported(arch, changes, match):
    cfg = dataclasses.replace(tsmoke(tconfigs.get_config(arch)), **changes)
    model = build(cfg, "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    from repro_torch.params import init_params

    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        model.loss_fn(params, {"tokens": tokens})
