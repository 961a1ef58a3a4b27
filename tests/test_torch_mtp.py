"""DeepSeek-V3's multi-token prediction (MTP) loss: the port's training against the reference's.

The ``deepseek-v3-671b`` smoke variant (1 dense + 3 MoE layers of 8 experts, top 2, 1 shared
expert, MLA with qk 32 + 16, v 32, latent 32; the ``mtp`` module on, remat "full" as the full
config trains) with the reference's params carried across by ``from_numpy_tree``, on
``TokenSource`` batches. The params are drawn once in bfloat16 and taken to float32 for the
float32 runs, so that the float32 reference is both the float32 case's target and the
bfloat16 case's yardstick. Cases: the loss, ce, z_loss, aux_loss, mtp_loss and every gradient
leaf (the ``mtp`` subtree, the shared expert and the router among them) against
``jax.value_and_grad`` of the reference's ``loss_fn``, in float32 at
``tests/test_torch_moe_train.py``'s tolerances through the dropless sort engine (2 x 256
tokens) and the einsum engine with capacity drops (2 x 520, above the dropless limit), and in
bfloat16 through the dropless engine within twice the reference's own bfloat16-against-float32
gap (its losses within a routing flip's share, ``BF16_ROUTED_LOSS_RTOL``); ``_mtp_loss`` alone
(the value, and its gradient in the params and in the stack's output) against the reference's
own ``_mtp_loss``, in float32 and in bfloat16 (twice the gap, no router on its path); the
metrics' keys in the reference's order; two ``make_train_step`` steps with bfloat16 AdamW state
(the reference's memory mode for this config) against the reference's step; the bfloat16 loss
and gradients equal on two runs. The JAX side runs its ``ref`` attention dispatch, as its own
tests do. Each reference function is compiled once and shared (``_jax_grad``): compiling the
model's gradient takes ~8 s on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import _f32, _tokens
from test_torch_moe_train import BF16_AUX_RTOL, BF16_GAPS, GRAD_RTOL, LOSS_RTOL, _port_run
from test_torch_train import OUTLIER_SHARE, STEP_RTOL, _assert_tree_close, _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_opt_init as jmake_opt_init
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import build
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.params import from_numpy_tree
from repro_torch.train import make_opt_init, make_train_step

ARCH = "deepseek-v3-671b"
BATCH = 2
# (tokens a sequence, the engine that runs, whether assignments drop)
PATHS = {"dropless": (256, "sort", False), "einsum-drops": (520, "einsum", True)}
MOE_LAYERS = 3
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
F32 = dict(param_dtype="float32", compute_dtype="float32")
METRICS = ("loss", "ce", "z_loss", "aux_loss", "mtp_loss")
# bfloat16 losses: the two packages' bfloat16 runs round the router's input in other orders,
# and a token whose top-2 sits on a near tie takes another expert in one of them (4 of 512
# tokens in a MoE layer of a 2-layer copy, 9 between each package's bfloat16 and float32
# runs). Each such token moves the mean cross-entropy by ~3e-4 with either sign, so the
# reference's own bfloat16-against-float32 gap in a loss is a sum of such steps that may
# cancel (1.3e-5 in that copy, where the port's bfloat16 loss stood 1.2e-3 from float32). The
# losses are held within 1e-3 of themselves, a few flips: a missing or misweighted MTP term
# moves the loss by a tenth of its size or more. The gradient leaves stay within BF16_GAPS x
# the gap, and so does every quantity of ``_mtp_loss`` alone, which has no router on its path.
BF16_ROUTED_LOSS_RTOL = 1e-3
# A loss with no router on its path (``_mtp_loss`` alone) is one mean of N tokens' losses,
# each carrying bfloat16 roundings of ~2^-8 of itself with either sign: the mean moves by
# ~2^-8 / sqrt(N) of itself, and the reference's own gap is one draw of that which may sit
# near zero (5.7e-6 of a 6.27 loss here). Such a value is held within twice the gap or
# 2^-8 / sqrt(N) of itself, whichever is larger (1.2e-4 at N = 1020).
BF16_MEAN_UNIT = 2.0**-8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, state_dtype="bfloat16")
# Params after two steps with bfloat16 m and v: each step rounds m and v to bfloat16, and the
# two packages' float32 values, ~1e-6 apart, may round to neighbouring bfloat16 values (2^-8
# apart): m / sqrt(v), about 1 at these steps, moves by up to 1.5 x 2^-8 of itself a step, and
# the state carries it into the next. So every entry is held within 2^-6 of the sum of the
# learning rates (2 x 1.5 x 2^-8 with room for a ratio above 1), and all but OUTLIER_SHARE of
# each leaf's entries at STEP_RTOL of its largest, as tests/test_torch_train.py holds them.
BF16_STATE_STEP = 2.0**-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the small ops of the smoke model stall a machine-wide pool when
    test workers run in parallel (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(dtype):
    changes = dict(BF16, **({} if dtype == "bfloat16" else F32))
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """The reference's params drawn in bfloat16, as a jax tree in ``dtype``."""
    jcfg, _ = _configs("bfloat16")
    if dtype == "bfloat16":
        return jbuild(jcfg).init(jax.random.key(0))[0]
    return jax.tree.map(lambda x: x.astype(jnp.float32), _params("bfloat16"))


def _batch_tokens(path):
    return _tokens(_configs("float32")[0].vocab_size, seq=PATHS[path][0], batch=BATCH)


@functools.lru_cache(maxsize=None)
def _jax_grad(dtype):
    """The reference's ``jax.value_and_grad(loss_fn, has_aux=True)``, jitted once a dtype."""
    return jax.jit(jax.value_and_grad(jbuild(_configs(dtype)[0]).loss_fn, has_aux=True))


def _jax_run(dtype, params, tokens):
    (_, metrics), grads = _jax_grad(dtype)(params, {"tokens": jnp.asarray(tokens)})
    return {**{k: _f32(v) for k, v in metrics.items()}, **dict(_leaves(_np(grads)))}


@functools.lru_cache(maxsize=None)
def _runs(path, dtype):
    """(reference metrics and leaves, port metrics and leaves, engine calls, drops) for one
    path and dtype."""
    _, tcfg = _configs(dtype)
    tokens = _batch_tokens(path)
    ref = _jax_run(dtype, _params(dtype), tokens)
    port, calls, drops = _port_run(tcfg, from_numpy_tree(_np(_params(dtype)), "cpu"), tokens)
    return ref, port, calls, drops


def _engine_ran(path, calls, drops):
    """Each MoE layer ran the path's engine twice (remat "full": the recompute)."""
    _, engine, dropping = PATHS[path]
    assert calls == {name: 2 * MOE_LAYERS * (name == engine) for name in calls}, calls
    assert (drops > 0) == dropping, drops


@pytest.mark.parametrize("path", list(PATHS))
def test_loss_and_every_grad_leaf_match_jax_grad_in_float32(path):
    ref, port, calls, drops = _runs(path, "float32")
    _engine_ran(path, calls, drops)
    assert float(port["aux_loss"]) > 0 and float(port["mtp_loss"]) > 0
    for key in METRICS:
        np.testing.assert_allclose(
            float(port[key]), float(ref[key]), rtol=LOSS_RTOL, atol=1e-9, err_msg=key
        )
    leaves = [k for k in ref if "/" in k]
    assert sorted(leaves) == sorted(k for k in port if "/" in k)
    for part in ("mtp/layer/", "mtp/proj/", "moe/shared/", "moe/router/"):
        assert any(part in k for k in leaves), part
    for key in leaves:
        w = ref[key]
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(port[key]), w, rtol=0, atol=atol, err_msg=key)
    for key in ("mtp/proj/", "mtp/norm_h/scale/", "mtp/norm_e/scale/"):
        assert np.abs(_f32(port[key])).max() > 0, key


def test_loss_and_every_grad_leaf_match_jax_grad_in_bfloat16():
    """Through the dropless engine, within BF16_GAPS x the reference's own bfloat16-against-
    float32 gap, or the float32 tolerance where that gap is smaller; the aux loss within
    BF16_AUX_RTOL of itself and the losses within BF16_ROUTED_LOSS_RTOL of themselves."""
    ref, port, calls, drops = _runs("dropless", "bfloat16")
    ref32 = _runs("dropless", "float32")[0]
    _engine_ran("dropless", calls, drops)
    np.testing.assert_allclose(
        float(port["aux_loss"]), float(ref["aux_loss"]), rtol=BF16_AUX_RTOL, err_msg="aux_loss"
    )
    wide = []
    for key in ref:
        if "/" in key:
            assert port[key].dtype == torch.bfloat16, key
        a, b, c = ref[key], ref32[key], _f32(port[key])
        gap, err = np.abs(a - b).max(), np.abs(c - a).max()
        rtol = GRAD_RTOL if "/" in key else max(LOSS_RTOL, BF16_ROUTED_LOSS_RTOL)
        floor = rtol * np.abs(a).max()
        print(f"{key}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        if key != "aux_loss" and not err <= max(BF16_GAPS * gap, floor):
            wide.append(f"{key}: {err:.3e} > max({BF16_GAPS} x {gap:.3e}, {floor:.3e})")
    assert not wide, wide


def test_metric_keys_follow_the_reference_order():
    """"loss" keeps its place after aux_loss and "mtp_loss" comes after it, as the
    reference's dict update leaves them (its keys read while it is traced: a jitted call
    returns them sorted)."""
    jcfg, tcfg = _configs("float32")
    tokens = _batch_tokens("dropless")[:1, :16]
    keys = []

    def traced(params, batch):
        loss, metrics = jbuild(jcfg).loss_fn(params, batch)
        keys.append(list(metrics))
        return loss

    jax.eval_shape(traced, _params("float32"), {"tokens": jnp.asarray(tokens)})
    params = from_numpy_tree(_np(_params("float32")), "cpu")
    _, metrics = build(tcfg, "cpu").loss_fn(params, {"tokens": torch.from_numpy(tokens)})
    assert list(metrics) == keys[0] == ["ce", "z_loss", "aux_loss", "loss", "mtp_loss"]


def _closure(fn, name):
    """A function the reference's ``build`` keeps in ``fn``'s closure (its ``_mtp_loss``)."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


@functools.lru_cache(maxsize=None)
def _mtp_alone(dtype):
    """``_mtp_loss`` of each package on the same params, stack output ``h`` (random, in the
    compute dtype) and tokens: (reference (value, d/dh, leaves by path), port (value, d/dh,
    leaves by path, None where the head does not reach))."""
    jcfg, tcfg = _configs(dtype)
    tokens = _batch_tokens("dropless")
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.normal(size=(*tokens.shape, jcfg.d_model)), jnp.dtype(dtype))
    jmtp = _closure(jbuild(jcfg).loss_fn, "_mtp_loss")
    want, (jg, jgh) = jax.jit(jax.value_and_grad(jmtp, argnums=(0, 1)))(
        _params(dtype), h, jnp.asarray(tokens)
    )
    tparams = from_numpy_tree(_np(_params(dtype)), "cpu")
    tparams = tadamw.tree_map(lambda x: x.requires_grad_(True), tparams)
    th = from_numpy_tree({"h": np.asarray(h)}, "cpu")["h"].requires_grad_(True)
    got = tmodel._mtp_loss(tparams, th, torch.from_numpy(tokens).long(), tcfg)
    grads = torch.autograd.grad(got, [th, *tadamw.tree_leaves(tparams)], allow_unused=True)
    paths = [p for p, _ in _leaves(_np(jg))]
    ref = (_f32(want), _f32(jgh), dict(_leaves(_np(jg))))
    port = (_f32(got), _f32(grads[0]), dict(zip(paths, grads[1:], strict=True)))
    return ref, port


def test_mtp_loss_alone_matches_the_reference_in_float32():
    """The value, and the gradient in ``h`` and in every param: the ``mtp`` subtree (its
    norms, ``proj``, its layer's MLA and MLP), ``embed``, ``final_norm`` and ``unembed``;
    every other leaf is zero in the reference and unreached in the port."""
    (want, jgh, jg), (got, gh, g) = _mtp_alone("float32")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gh, jgh, rtol=0, atol=GRAD_RTOL * np.abs(jgh).max())
    reached = [p for p in jg if g[p] is not None]
    assert all(not np.abs(jg[p]).max() for p in jg if g[p] is None)
    assert sorted(reached) == sorted(
        [p for p in jg if p.startswith("mtp/")] + ["embed/table/", "final_norm/scale/", "unembed/"]
    )
    for p in reached:
        atol = GRAD_RTOL * max(np.abs(jg[p]).max(), 1e-30)
        np.testing.assert_allclose(_f32(g[p]), jg[p], rtol=0, atol=atol, err_msg=p)


def test_mtp_loss_alone_matches_the_reference_in_bfloat16():
    """Within BF16_GAPS x the reference's own bfloat16-against-float32 gap in the value, the
    gradient in ``h`` and each reached leaf (no router on this path), or where that gap is
    smaller, the float32 tolerance (the gradients) or BF16_MEAN_UNIT / sqrt(N) (the value)."""
    (want, jgh, jg), (got, gh, g) = _mtp_alone("bfloat16")
    (want32, jgh32, jg32), _ = _mtp_alone("float32")
    n = BATCH * (PATHS["dropless"][0] - 2)  # the tokens the MTP head predicts
    rows = [("mtp_loss", got, want, want32, BF16_MEAN_UNIT / np.sqrt(n))]
    rows.append(("h", gh, jgh, jgh32, GRAD_RTOL))
    rows += [(p, _f32(g[p]), jg[p], jg32[p], GRAD_RTOL) for p in jg if g[p] is not None]
    wide = []
    for name, c, a, b, rtol in rows:
        gap, err = np.abs(a - b).max(), np.abs(c - a).max()
        floor = rtol * np.abs(a).max()
        print(f"_mtp_loss {name}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        if not err <= max(BF16_GAPS * gap, floor):
            wide.append(f"{name}: {err:.3e} > max({BF16_GAPS} x {gap:.3e}, {floor:.3e})")
    assert not wide, wide


def test_two_train_steps_with_bfloat16_adamw_state_match_jax():
    """Two ``make_train_step`` steps of the float32 model with AdamW's m and v kept in
    bfloat16 (``state_dtype="bfloat16"``) against the reference's step, which is its
    ``value_and_grad`` of ``loss_fn`` then its ``adamw_update`` (``repro.train.steps.
    make_train_step``; both jitted, the first shared with the float32 case): the metrics
    (mtp_loss among them) at STEP_RTOL, the params as BF16_STATE_STEP says, m and v to their
    own bfloat16 rounding (1e-2 of each leaf's largest entry, as the AdamW test of
    tests/test_torch_train.py holds bfloat16 state)."""
    jcfg, tcfg = _configs("float32")
    jopt, opt = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jparams = _params("float32")
    jstate = jmake_opt_init(jbuild(jcfg), jopt)(jparams)
    jupdate = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, jopt))
    model = build(tcfg, "cpu")
    params = from_numpy_tree(_np(jparams), "cpu")
    state = make_opt_init(model, opt)(params)
    step_fn = make_train_step(model, opt)
    tokens = _batch_tokens("dropless")
    lr_sum = 0.0
    for step in range(2):
        batch = np.roll(tokens, step, axis=1)
        (_, jm), jgrads = _jax_grad("float32")(jparams, {"tokens": jnp.asarray(batch)})
        jparams, jstate, jopt_m = jupdate(jparams, jgrads, jstate)
        jm = {**jm, **jopt_m}
        params, state, metrics = step_fn(params, state, {"tokens": torch.from_numpy(batch)})
        assert sorted(metrics) == sorted(jm)
        for key, w in jm.items():
            np.testing.assert_allclose(
                float(metrics[key]), float(w), rtol=STEP_RTOL, atol=1e-7, err_msg=f"{key} {step}"
            )
        lr_sum += float(jm["lr"])
    for key in ("m", "v"):
        assert all(x.dtype == torch.bfloat16 for x in tadamw.tree_leaves(state[key]))
        _assert_tree_close(state[key], _np(jstate[key]), 1e-2, f"{key} after step 1")
    for (path, g), (_, w) in zip(_leaves(params), _leaves(_np(jparams)), strict=True):
        diff = np.abs(g.numpy() - w)
        loose = diff > STEP_RTOL * np.abs(w).max()
        assert loose.mean() <= OUTLIER_SHARE, (path, int(loose.sum()), diff.max())
        assert diff.max() <= BF16_STATE_STEP * lr_sum, (path, diff.max())
    assert int(state["step"]) == int(jstate["step"]) == 2


def test_bfloat16_loss_and_gradients_equal_on_two_runs():
    _, tcfg = _configs("bfloat16")
    params = from_numpy_tree(_np(_params("bfloat16")), "cpu")
    tokens = _batch_tokens("dropless")
    torch.use_deterministic_algorithms(True)
    try:
        first, _, _ = _port_run(tcfg, params, tokens)
        second, _, _ = _port_run(tcfg, params, tokens)
    finally:
        torch.use_deterministic_algorithms(False)
    assert first.keys() == second.keys() and "mtp_loss" in first
    for key in first:
        assert torch.equal(first[key], second[key]), key
