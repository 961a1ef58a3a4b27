"""Training the MoE family: the port's gradients against ``jax.grad`` of the reference.

A 2-layer ``smoke_variant`` of ``granite-moe-3b-a800m`` with the reference's params
carried across by ``from_numpy_tree``, on ``TokenSource`` batches: the loss, its aux
loss and cross-entropy, and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``loss_fn``, through each way ``moe_block`` dispatches in training: the
dropless sort engine (2 x 512 tokens), the einsum engine with capacity drops (2 x 600
tokens, granite's ``moe_impl="a2a"`` without a mesh) and the sort engine with drops
(``moe_impl="sort"``, capacity factor 1.0). In float32 at ``tests/test_torch_train.py``'s
tolerances; in bfloat16 (remat "full", as the full config trains) each quantity within
twice the reference's own gap between its bfloat16 run and a float32 run of the same
params, ``tests/test_torch_dense.py``'s rule (never tighter than the float32 tolerance;
the aux loss, which moves in steps of one routing flip, within 1e-2 of itself). Then the
gathers' gradients: a token's gradient through the dispatch is, bit for bit, its kept
slots' gradients added in float32 in ascending expert id and rounded once (tables built
here from the reference's slot rules, a token with every assignment dropped among them);
the bfloat16 loss and gradients equal on two runs. The JAX side runs its ``ref``
attention dispatch, as its own tests do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import _f32, _tokens
from test_torch_moe import _moe_params, _routing, _x
from test_torch_train import _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.models import build as jbuild
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.params import from_numpy_tree
from repro_torch.train.steps import value_and_grad

ARCH = "granite-moe-3b-a800m"
LAYERS, BATCH = 2, 2
# (config changes, tokens a sequence, the engine that runs, whether assignments drop)
PATHS = {
    "dropless": ({}, 512, "sort", False),
    "einsum-drops": ({}, 600, "einsum", True),
    "sort-drops": (dict(moe_impl="sort", moe_capacity_factor=1.0), 600, "sort", True),
}
# float32 both sides, XLA against ATen: tests/test_torch_train.py's tolerances, the loss
# within 1e-5 relative and each gradient leaf within 1e-4 of its largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# bfloat16: each quantity within BF16_GAPS x the reference's own bfloat16-against-float32
# gap (max |a - b|), tests/test_torch_dense.py's, or within the float32 tolerance above
# where that gap is smaller: the z-loss moves by ~1e-7 of itself between the two runs, the
# size of a float32 sum's order over the batch
BF16_GAPS = 2.0
# The aux loss alone: a router flip (an expert picked in place of another by a bfloat16
# rounding) moves one of a layer's T·k assignments, and aux by E·coef·ΔP/(T·k), ~1.5e-6 or
# 1.5e-3 of aux here, whether or not the reference's own float32 run flips as well. Held
# within 1e-2 of aux: a few flips, where a wrong count or a missed layer moves it by its size.
BF16_AUX_RTOL = 1e-2
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the small ops of the smoke model stall a machine-wide pool when
    test workers run in parallel (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(path, dtype):
    changes = dict(PATHS[path][0], num_layers=LAYERS, **(BF16 if dtype == "bfloat16" else {}))
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


def _jax_run(cfg, params, tokens):
    fn = jax.jit(jax.value_and_grad(jbuild(cfg).loss_fn, has_aux=True))
    (_, metrics), grads = fn(params, {"tokens": jnp.asarray(tokens)})
    return {**{k: _f32(v) for k, v in metrics.items()}, **dict(_leaves(_np(grads)))}


def _port_run(cfg, params, tokens):
    """The port's loss metrics and gradient leaves, with the engine calls and the drops."""
    drops = []
    slots = tmoe._slots

    def counted(e, E, cap):
        pos, keep, src = slots(e, E, cap)
        drops.append(int((~keep).sum()))
        return pos, keep, src

    tmoe._moe_sort.calls = tmoe._moe_einsum.calls = 0
    tmoe._slots = counted
    try:
        (_, metrics), grads = value_and_grad(
            build(cfg, "cpu").loss_fn, params, {"tokens": torch.from_numpy(tokens)}
        )
    finally:
        tmoe._slots = slots
    calls = {"sort": tmoe._moe_sort.calls, "einsum": tmoe._moe_einsum.calls}
    return {**{k: v for k, v in metrics.items()}, **dict(_leaves(grads))}, calls, sum(drops)


@functools.lru_cache(maxsize=None)
def _runs(path, dtype):
    """(reference, reference in float32 on the same params or None, port, engine calls,
    drops) for one path and dtype."""
    jcfg, tcfg = _configs(path, dtype)
    jparams, _ = jbuild(jcfg).init(jax.random.key(0))
    tokens = _tokens(jcfg.vocab_size, seq=PATHS[path][1], batch=BATCH)
    ref = _jax_run(jcfg, jparams, tokens)
    ref32 = None
    if dtype == "bfloat16":
        jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
        ref32 = _jax_run(jcfg32, jax.tree.map(lambda x: x.astype(jnp.float32), jparams), tokens)
    port, calls, drops = _port_run(tcfg, from_numpy_tree(_np(jparams), "cpu"), tokens)
    return ref, ref32, port, calls, drops


def _engine_ran(path, calls, drops, remat="none"):
    """Each MoE layer ran the path's engine (twice under remat "full": the recompute)."""
    _, _, engine, dropping = PATHS[path]
    runs = LAYERS * (2 if remat == "full" else 1)
    assert calls == {name: runs * (name == engine) for name in calls}, calls
    assert (drops > 0) == dropping, drops


@pytest.mark.parametrize("path", list(PATHS))
def test_loss_and_every_grad_leaf_match_jax_grad_in_float32(path):
    ref, _, port, calls, drops = _runs(path, "float32")
    _engine_ran(path, calls, drops)
    assert float(port["aux_loss"]) > 0
    for key in ("loss", "ce", "z_loss", "aux_loss"):
        np.testing.assert_allclose(
            float(port[key]), float(ref[key]), rtol=LOSS_RTOL, atol=1e-9, err_msg=key
        )
    leaves = [k for k in ref if "/" in k]
    assert sorted(leaves) == sorted(k for k in port if "/" in k)
    for key in leaves:
        w = ref[key]
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(port[key]), w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("path", list(PATHS))
def test_loss_and_every_grad_leaf_match_jax_grad_in_bfloat16(path):
    ref, ref32, port, calls, drops = _runs(path, "bfloat16")
    _engine_ran(path, calls, drops, BF16["remat"])
    np.testing.assert_allclose(
        float(port["aux_loss"]), float(ref["aux_loss"]), rtol=BF16_AUX_RTOL, err_msg="aux_loss"
    )
    wide = []
    for key in ref:
        if "/" in key:
            assert port[key].dtype == torch.bfloat16, key
        a, b, c = ref[key], ref32[key], _f32(port[key])
        gap, err = np.abs(a - b).max(), np.abs(c - a).max()
        floor = (GRAD_RTOL if "/" in key else LOSS_RTOL) * np.abs(a).max()
        print(f"{path} {key}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        if key != "aux_loss" and not err <= max(BF16_GAPS * gap, floor):
            wide.append(f"{key}: {err:.3e} > max({BF16_GAPS} x {gap:.3e}, {floor:.3e})")
    assert not wide, wide


# --------------------------------------------------------------------------
# the gathers' gradients
# --------------------------------------------------------------------------


def _slot_rows(idx, G, S, cap, engine):
    """Each assignment's row of the experts' (E, G·cap) slots, or -1 where it is dropped, by
    the reference's rules: a group's slots fill token by token (sort: assignment s·k + r) or
    rank by rank (einsum: r·S + s), the first ``cap`` of an expert kept."""
    T, k = idx.shape
    rows = np.full((T, k), -1)
    for g in range(G):
        seen = {}
        order = [(s, r) for s in range(S) for r in range(k)]
        if engine == "einsum":
            order = [(s, r) for r in range(k) for s in range(S)]
        for s, r in order:
            e = int(idx[g * S + s, r])
            pos = seen.get(e, 0)
            seen[e] = pos + 1
            if pos < cap:
                rows[g * S + s, r] = e * G * cap + g * cap + pos
    return rows


@pytest.mark.parametrize("engine", ["sort", "einsum"])
def test_dispatch_gradient_is_the_float32_sum_in_expert_order_rounded_once(engine):
    """bfloat16, skewed routing (most of the mass on experts 0 and 1) at capacity factor
    1.25: experts 0 and 1 overflow, so some tokens lose one assignment and some lose both.
    x's gradient comes from the dispatch alone (the routing is an input), and must equal,
    bit for bit, the float32 sum of each token's kept slots' gradients in ascending expert
    id, rounded to bfloat16 once; zero for a token with every assignment dropped."""
    _, tcfg = _configs("dropless", "float32")
    _, tp = _moe_params("bfloat16")
    E, k, T = tcfg.num_experts, tcfg.num_experts_per_tok, 128
    S = T if engine == "sort" else tcfg.moe_group_size  # one group, or groups of 32
    G, cap = T // S, int(S * k / E * tcfg.moe_capacity_factor)
    _, x = _x(T, tcfg.d_model, "bfloat16", seed=5)
    w, idx = _routing(T, tcfg, skew=True, seed=6)
    weights, idx = torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(idx).long()
    x.requires_grad_(True)
    seen = {}
    ffn = tmoe._expert_ffn

    def recording(h, ep, cfg):
        h.retain_grad()
        seen["h"] = h
        return ffn(h, ep, cfg)

    tmoe._expert_ffn = recording
    try:
        fn = tmoe._moe_sort if engine == "sort" else tmoe._moe_einsum
        out = fn(x, weights, idx, tp, tcfg)
    finally:
        tmoe._expert_ffn = ffn
    g = torch.from_numpy(np.random.default_rng(7).normal(size=out.shape).astype(np.float32))
    out.backward(g.to(torch.bfloat16))
    h = seen["h"]
    assert h.shape == (E, G * cap, tcfg.d_model)
    rows = _slot_rows(idx.numpy(), G, T // G, cap, engine)
    dropped = (rows < 0).sum(-1)
    assert (dropped == k).any() and ((dropped > 0) & (dropped < k)).any(), dropped
    dh = h.grad.reshape(E * G * cap, -1).float().numpy()
    want = np.zeros((T, tcfg.d_model), np.float32)
    for t in range(T):
        for r in np.argsort(idx[t].numpy()):  # ascending expert id
            if rows[t, r] >= 0:
                want[t] += dh[rows[t, r]]
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, torch.from_numpy(want).to(torch.bfloat16))
    assert not x.grad[torch.from_numpy(dropped == k)].any()


@pytest.mark.parametrize("path", list(PATHS))
def test_bfloat16_loss_and_gradients_equal_on_two_runs(path):
    jcfg, tcfg = _configs(path, "bfloat16")
    jparams, _ = jbuild(jcfg).init(jax.random.key(0))
    params = from_numpy_tree(_np(jparams), "cpu")
    tokens = _tokens(jcfg.vocab_size, seq=PATHS[path][1], batch=BATCH)
    torch.use_deterministic_algorithms(True)
    try:
        first, _, _ = _port_run(tcfg, params, tokens)
        second, _, _ = _port_run(tcfg, params, tokens)
    finally:
        torch.use_deterministic_algorithms(False)
    assert first.keys() == second.keys()
    for key in first:
        assert torch.equal(first[key], second[key]), key
