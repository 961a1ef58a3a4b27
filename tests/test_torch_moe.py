"""The MoE family: ``models/moe.py`` and granite-moe as a whole model, against the JAX package.

Same inputs (numpy, seeded) and the reference's params carried across by
``from_numpy_tree``. The router (weights, expert ids, aux loss) in float32 and
bfloat16, and on constructed ties, where the lower expert id wins as with
``jax.lax.top_k``. Both engines against the reference's on the same routing:
with drops (capacity factor 1.25, routing skewed toward a few experts) and
without, the sort engine with ``cap_override``, the einsum engine at a T that is
no multiple of its groups (the tail gets zero expert output). The engines against
each other without drops. ``moe_block`` on both sides of its 1,024-token dropless
threshold, with the engine each side runs counted. Shared experts and
``first_k_dense``. The smoke model of ``granite-moe-3b-a800m``: prefill and 4
decode steps within 1e-4 with equal greedy tokens, the loss (aux included) within
1e-5 relative, the batcher at slots 1-3 against its own sequential decoding, a
bfloat16 copy within twice the reference's own bfloat16-against-float32 gap, and
the full config's total and active parameter counts. Last, the combine's bits on
two runs. The JAX side runs its ``ref`` attention dispatch, as its own tests do
on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batcher import _sequential_generate
from test_torch_dense import _f32, _tokens
from test_torch_train import _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro.models.layers import ParamStore as JParamStore
from repro.models.model import count_params_analytic
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.params import count_params, from_numpy_tree
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "granite-moe-3b-a800m"
FULL_PARAMS, ACTIVE_PARAMS = 3_299_575_296, 883_656_192
# float32 both sides, XLA against ATen: summation order only (tests/test_torch_model.py)
TOL = 1e-4
LOSS_RTOL = 1e-5  # tests/test_torch_train.py's
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(**changes):
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _moe_params(dtype="float32", seed=0, **changes):
    """One MoE block's params from the reference's ``init_moe``: (jax tree, torch tree)."""
    jcfg, _ = _configs(**changes)
    store = JParamStore(jax.random.key(seed), DTYPES[dtype][0])
    jmoe.init_moe(store, "moe", jcfg)
    jp = store.params["moe"]
    return jp, from_numpy_tree(_np(jp), "cpu")


def _x(T, d, dtype="float32", seed=0):
    x = np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(x).to(DTYPES[dtype][1])


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_matches_jax(dtype):
    jcfg, tcfg = _configs()
    jp, tp = _moe_params(dtype)
    jx, tx = _x(97, jcfg.d_model, dtype)
    jw, ji, ja = jmoe._router(jx, jp, jcfg)
    tw, ti, ta = tmoe._router(tx, tp, tcfg)
    assert tw.dtype == DTYPES[dtype][1] and ti.shape == (97, jcfg.num_experts_per_tok)
    assert ti.tolist() == np.asarray(ji).tolist()
    _close(tw, jw, 1e-6 if dtype == "float32" else 2**-8)
    np.testing.assert_allclose(float(ta), float(ja), rtol=LOSS_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_pick_the_lower_expert_as_jax_top_k(dtype):
    """Experts 1 = 5 and 2 = 6 = 7 have equal router columns, so their logits and
    probabilities tie exactly; among equal ones the lower id must win, in order."""
    jcfg, tcfg = _configs(num_experts_per_tok=4)
    jp, tp = _moe_params(dtype, num_experts_per_tok=4)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 1]
    router[:, 6] = router[:, 7] = router[:, 2]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=from_numpy_tree({"r": router}, "cpu")["r"])
    jx, tx = _x(301, jcfg.d_model, dtype, seed=3)
    jw, ji, _ = jmoe._router(jx, jp, jcfg)
    tw, ti, _ = tmoe._router(tx, tp, tcfg)
    probs = torch.softmax((tx @ tp["router"].to(tx.dtype)).float(), dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 5]) and torch.equal(probs[:, 6], probs[:, 7])
    ties = 0
    for row, p in zip(ti.tolist(), probs):
        for a, b in zip(row, row[1:]):
            assert p[a] > p[b] or (p[a] == p[b] and a < b), row
            ties += bool(p[a] == p[b])
    assert ties > 50, ties  # the draw puts tied experts side by side in many rows
    assert ti.tolist() == np.asarray(ji).tolist()
    _close(tw, jw, 1e-6 if dtype == "float32" else 2**-8)


# --------------------------------------------------------------------------
# the engines, on the same routing
# --------------------------------------------------------------------------


def _routing(T, cfg, skew, seed=1):
    """(weights (T, k) float32 summing to 1, distinct expert ids (T, k) int32): each token
    draws its k experts without replacement; ``skew`` puts most of the mass on experts 0-1."""
    rng = np.random.default_rng(seed)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    p = np.ones(E)
    if skew:
        p[:2] = 20.0
    p /= p.sum()
    idx = np.stack([rng.choice(E, size=k, replace=False, p=p) for _ in range(T)])
    w = rng.uniform(0.1, 1.0, size=(T, k))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32), idx.astype(np.int32)


def _engines(T, *, skew, dtype="float32", cap_override=0, **changes):
    """(reference out, port out) of both engines on one routing: {name: (jax, torch)}."""
    jcfg, tcfg = _configs(**changes)
    jp, tp = _moe_params(dtype, **changes)
    jx, tx = _x(T, jcfg.d_model, dtype)
    w, idx = _routing(T, jcfg, skew)
    jw, tw = jnp.asarray(w).astype(jx.dtype), torch.from_numpy(w).to(tx.dtype)
    ji, ti = jnp.asarray(idx), torch.from_numpy(idx).long()
    out = {
        "sort": (
            jmoe._moe_sort(jx, jw, ji, jp, jcfg, cap_override=cap_override),
            tmoe._moe_sort(tx, tw, ti, tp, tcfg, cap_override=cap_override),
        )
    }
    if not cap_override:
        out["einsum"] = (
            jmoe._moe_einsum(jx, jw, ji, jp, jcfg),
            tmoe._moe_einsum(tx, tw, ti, tp, tcfg),
        )
    return out, idx


def _drops(idx, E, group, cap):
    """Assignments past their expert's capacity, counted per group of ``group`` tokens."""
    return sum(
        max(0, int(np.sum(idx[g : g + group] == e)) - cap)
        for g in range(0, len(idx) - group + 1, group)
        for e in range(E)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew", [True, False], ids=["drops", "no-drops"])
def test_engines_match_jax(skew, dtype):
    """T = 128 in groups of 32: capacity int(32·2/8·1.25) = 10 a group. Skewed routing
    overflows experts 0-1 (drops); uniform routing with capacity factor 8 drops nothing."""
    changes = {} if skew else dict(moe_capacity_factor=8.0)
    jcfg, _ = _configs(**changes)
    out, idx = _engines(128, skew=skew, dtype=dtype, **changes)
    cap = int(32 * jcfg.num_experts_per_tok / jcfg.num_experts * jcfg.moe_capacity_factor)
    drops = _drops(idx, jcfg.num_experts, 32, cap)
    assert (drops > 0) == skew, drops
    for name, (want, got) in out.items():
        assert got.dtype == DTYPES[dtype][1]
        if dtype == "float32":
            _close(got, want, TOL, name)
        else:  # one bf16 rounding of each output apart, at most
            scale = np.abs(_f32(want)).max()
            _close(got, want, 2**-7 * scale, name)


def test_sort_engine_cap_override_matches_jax():
    """cap_override = T (moe_block's dropless path) on skewed routing, and a cap of 3
    that drops, both against the reference."""
    for cap in (128, 3):
        out, _ = _engines(128, skew=True, cap_override=cap)
        want, got = out["sort"]
        _close(got, want, TOL, f"cap_override={cap}")


def test_einsum_engine_zero_tail_matches_jax():
    """T = 100 in groups of 32: G = 3 groups of S = 33 tokens; token 99, past G·S, gets
    zero expert output, in the reference and in the port."""
    out, _ = _engines(100, skew=False)
    want, got = out["einsum"]
    _close(got, want, TOL, "einsum")
    assert torch.equal(got[99:], torch.zeros_like(got[99:]))
    assert bool((got[:99].abs().sum(-1) > 0).all())


def test_engines_agree_without_drops():
    """With no drops both engines hold every assignment, and in float32 each token's sum
    is the same ordered sum of the same exact products: equal bits."""
    _, tcfg = _configs(moe_capacity_factor=8.0)
    _, tp = _moe_params("float32", moe_capacity_factor=8.0)
    _, tx = _x(128, tcfg.d_model)
    weights, idx, _ = tmoe._router(tx, tp, tcfg)
    assert torch.equal(
        tmoe._moe_sort(tx, weights, idx, tp, tcfg), tmoe._moe_einsum(tx, weights, idx, tp, tcfg)
    )


# --------------------------------------------------------------------------
# moe_block and its dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "tokens,impl,engine",
    [(1024, "a2a", "sort"), (1025, "a2a", "einsum"), (1025, "sort", "sort")],
)
def test_moe_block_dispatch_matches_jax(tokens, impl, engine):
    """B·S <= 1024 goes through the dropless sort engine, above it the config's engine:
    granite's "a2a" falls through to einsum without a mesh, as in the reference."""
    jcfg, tcfg = _configs(moe_impl=impl)
    jp, tp = _moe_params()
    jx, tx = _x(tokens, jcfg.d_model, seed=4)
    jout, jaux = jmoe.moe_block(jx.reshape(1, tokens, -1), jp, jcfg)
    tmoe._moe_sort.calls = tmoe._moe_einsum.calls = 0
    tout, taux = tmoe.moe_block(tx.reshape(1, tokens, -1), tp, tcfg)
    calls = {"sort": tmoe._moe_sort.calls, "einsum": tmoe._moe_einsum.calls}
    assert calls == {name: int(name == engine) for name in calls}
    assert tout.shape == (1, tokens, jcfg.d_model)
    _close(tout, jout, TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

SHARED = dict(num_shared_experts=1, first_k_dense=1)


@functools.lru_cache(maxsize=None)
def _pair(shared=False, seed=0):
    jcfg, tcfg = _configs(**(SHARED if shared else {}))
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    tparams = from_numpy_tree(_np(jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, build(tcfg, "cpu"), tparams


def test_shared_experts_and_first_k_dense_layout():
    jcfg, _, jparams, tcfg, _, tparams = _pair(shared=True)
    assert tparams["seg0"]["u0"].keys() == {"ln1", "attn", "ln2", "mlp"}  # layer 0 dense
    assert set(tparams["seg1"]["u0"]["moe"]) == {"router", "experts", "shared"}
    assert count_params(tcfg) == count_params_analytic(jcfg)
    assert count_params(tcfg, active_only=True) == count_params_analytic(jcfg, active_only=True)


@pytest.mark.parametrize("shared", [False, True], ids=["granite", "shared+first-dense"])
def test_prefill_and_decode_match_jax(shared):
    _, jmodel, jparams, _, tmodel, tparams = _pair(shared)
    prompts = np.random.default_rng(11).integers(0, 512, size=(2, 13)).astype(np.int32)
    max_len = 24
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("pad_to",))(
        jparams, {"tokens": jnp.asarray(prompts)}, pad_to=max_len
    )
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()}, pad_to=max_len)
    _close(tl, jl, TOL)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        jl, jc = jdecode(jparams, jc, {"token": jtok})
        tl, tc = tmodel.decode_step(tparams, tc, {"token": ttok})
        _close(tl, jl, TOL)
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()


def test_long_prefill_through_the_einsum_engine_matches_jax():
    """A 1,100-token prompt: every MoE layer runs the einsum engine with capacity drops and
    a zero tail (G 34 groups of 32, 12 tokens past them, the last one among them)."""
    _, jmodel, jparams, _, tmodel, tparams = _pair()
    prompt = np.random.default_rng(12).integers(0, 512, size=(1, 1100)).astype(np.int32)
    jl, _ = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    tmoe._moe_sort.calls = tmoe._moe_einsum.calls = 0
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()})
    assert (tmoe._moe_sort.calls, tmoe._moe_einsum.calls) == (0, 4)
    _close(tl, jl, TOL)


@pytest.mark.parametrize(
    "shared,seq,remat",
    [(False, 32, "none"), (False, 32, "full"), (False, 600, "none"), (True, 32, "none")],
    ids=["sort", "sort-remat-full", "einsum", "shared"],
)
def test_loss_with_aux_matches_jax(shared, seq, remat):
    """The loss, the aux loss alone and the cross-entropy, within 1e-5 relative: 2 x 32
    tokens go through the sort engine, 2 x 600 through the einsum engine; under remat "full"
    each layer's aux comes out of its checkpointed unit."""
    _, jmodel, jparams, tcfg, _, tparams = _pair(shared)
    tokens = _tokens(tcfg.vocab_size, seq=seq)
    _, jmetrics = jax.jit(jmodel.loss_fn)(jparams, {"tokens": jnp.asarray(tokens)})
    tmodel = build(dataclasses.replace(tcfg, remat=remat), "cpu")
    tloss, tmetrics = tmodel.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)})
    assert float(tmetrics["aux_loss"]) > 0
    for key in jmetrics:
        np.testing.assert_allclose(
            float(tmetrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, atol=1e-9, err_msg=key
        )
    assert float(tloss) == float(tmetrics["loss"])


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_batched_equals_sequential(slots):
    _, _, _, _, tmodel, tparams = _pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, rng.integers(4, 12)).astype(np.int32) for _ in range(4)]
    want = {
        f"r{i}": _sequential_generate(tmodel, tparams, p, 5, 32) for i, p in enumerate(prompts)
    }
    eng = ContinuousBatcher(tmodel, tparams, slots=slots, max_len=32)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=5))
    assert {rid: g.tokens for rid, g in eng.run_until_drained().items()} == want


@functools.lru_cache(maxsize=None)
def _bf16_runs():
    """(reference bfloat16, reference float32 on the same params, port bfloat16): the last
    prefill logits and the loss of each, as float32 numpy."""
    jcfg, tcfg = _configs(**BF16)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams, _ = jbuild(jcfg).init(jax.random.key(1))
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tokens = _tokens(jcfg.vocab_size)

    def jax_run(cfg, params):
        model = jbuild(cfg)
        logits, _ = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(tokens)})
        loss, _ = jax.jit(model.loss_fn)(params, {"tokens": jnp.asarray(tokens)})
        return {"logits": _f32(logits), "loss": _f32(loss)}

    tmodel = build(tcfg, "cpu")
    tparams = from_numpy_tree(_np(jparams), "cpu")
    assert tparams["seg0"]["u0"]["moe"]["experts"]["w_up"].dtype == torch.bfloat16
    logits, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()})
    loss, _ = tmodel.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)})
    port = {"logits": _f32(logits), "loss": _f32(loss)}
    return jax_run(jcfg, jparams), jax_run(jcfg32, jparams32), port


@pytest.mark.parametrize("what", ["logits", "loss"])
def test_bf16_copy_matches_the_reference_bf16_run(what):
    """Within twice the reference's own bfloat16-against-float32 gap (max |a - b|) on the
    same params and tokens, tests/test_torch_dense.py's rule."""
    ref, ref32, port = _bf16_runs()
    gap = np.abs(ref[what] - ref32[what]).max()
    err = np.abs(port[what] - ref[what]).max()
    print(f"{ARCH} {what}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
    assert gap > 0
    assert err <= 2 * gap, f"{what}: {err} > 2 x {gap}"


def test_full_param_counts_match_the_reference():
    tcfg, jcfg = tconfigs.get_config(ARCH), get_config(ARCH)
    assert count_params(tcfg) == tcfg.param_count() == FULL_PARAMS
    assert count_params(tcfg, active_only=True) == tcfg.active_param_count() == ACTIVE_PARAMS
    assert count_params_analytic(jcfg) == FULL_PARAMS
    assert count_params_analytic(jcfg, active_only=True) == ACTIVE_PARAMS


@pytest.mark.parametrize("engine", ["sort", "einsum"])
def test_combine_gives_equal_bits_on_two_runs(engine):
    _, tcfg = _configs()
    _, tp = _moe_params("bfloat16")
    _, tx = _x(1100, tcfg.d_model, "bfloat16")
    fn = tmoe._moe_sort if engine == "sort" else tmoe._moe_einsum
    w, idx, _ = tmoe._router(tx, tp, tcfg)
    first, second = fn(tx, w, idx, tp, tcfg), fn(tx, w, idx, tp, tcfg)
    assert torch.equal(first, second)
