"""The port's RWKV6 model (rwkv6-7b's family) against the JAX package's.

The model is ``smoke_variant(rwkv6-7b)``: 4 ``rwkv`` layers, d=128, head
size 64 (2 heads), d_ff 256, vocab 512, LayerNorm, float32. The JAX params
are drawn by ``repro``'s ``model.init`` and loaded into the port with
``from_numpy_tree``. Logits, WKV states and token-shift states agree within
1e-4 (float32 both sides; XLA and ATen sum in different orders, and the
chunked WKV form re-associates the recurrence).

The reference's batcher splices every leaf of equal shape with
``jnp.maximum`` (ROADMAP Queue 3), which at ``slots=1`` reaches the RWKV
state too; the port splices by slot index, and the batcher is held to
sequential greedy decoding at slots 1 to 3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config, smoke_variant
from repro.kernels import ops as jops
from repro.models import build as jbuild
from repro.models import count_params_analytic
from repro.models import rwkv as jrw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import wkv6 as twkv
from repro_torch.models import build
from repro_torch.models import rwkv as trw
from repro_torch.models.model import _cache_pos
from repro_torch.params import count_params, from_numpy_tree, init_params
from repro_torch.serve import ContinuousBatcher, Request
from test_torch_hybrid import _assert_tree_close, _sequential, _shapes, _to_dtype, _tokens

TOL = 1e-4  # as test_torch_hybrid, whose tree and decoding helpers these tests share


def _configs():
    jcfg = smoke_variant(get_config("rwkv6-7b"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("rwkv6-7b"))
    assert jcfg.family == tcfg.family == "ssm" and jcfg.rwkv_head_size == 64
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build(tcfg, device="cpu"), tparams


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block_params(seed, clamp_ends=False):
    """One layer's ``rwkv`` params from the reference's init. The token-shift
    mixes and the static decay start at 0: draw them so they matter. With
    ``clamp_ends``, w0 puts a third of the channels past each end of the
    decay clip and clamp (w0 = 3: -exp(1.3863) < -4; w0 = -30: -exp(-20) >
    -1e-4)."""
    from repro.models.layers import ParamStore

    jcfg, tcfg = _configs()
    store = ParamStore(jax.random.key(seed), jnp.float32)
    jrw.init_rwkv_layer(store, "rwkv", jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.array, store.params["rwkv"])  # writable, for torch.from_numpy
    for group in ("time_mix", "channel_mix"):
        for name, value in params[group].items():
            if name.startswith("mu_"):
                params[group][name] = rng.uniform(-0.5, 1.5, size=value.shape).astype(np.float32)
    d = jcfg.d_model
    w0 = rng.normal(size=d)
    if clamp_ends:
        w0 = np.where(np.arange(d) % 3 == 0, 3.0, np.where(np.arange(d) % 3 == 1, -30.0, w0))
    params["time_mix"]["w0"] = w0.astype(np.float32)
    return jcfg, tcfg, params, rng


def _state(rng, cfg, b):
    hs = cfg.rwkv_head_size
    return {
        "wkv": rng.normal(size=(b, cfg.d_model // hs, hs, hs)).astype(np.float32),
        "tm_prev": rng.normal(size=(b, cfg.d_model)).astype(np.float32),
        "cm_prev": rng.normal(size=(b, cfg.d_model)).astype(np.float32),
    }


@pytest.mark.parametrize("with_prev", [False, True], ids=["zeros", "prev"])
def test_token_shift_matches_jax(with_prev):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 8)).astype(np.float32) if with_prev else None
    want = jrw._token_shift(jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    got = trw._token_shift(torch.from_numpy(x), None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("clamp_ends", [False, True], ids=["inside", "clamp_ends"])
@pytest.mark.parametrize("t", [1, 9, 21])
@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "state"])
def test_time_mix_matches_jax(with_state, t, clamp_ends):
    jcfg, tcfg, params, rng = _block_params(2, clamp_ends)
    x = rng.normal(size=(2, t, jcfg.d_model)).astype(np.float32)
    state = _state(rng, jcfg, 2) if with_state else None
    jout, jstate = jrw.rwkv_time_mix(
        jnp.asarray(x),
        jax.tree.map(jnp.asarray, params),
        jcfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state),
    )
    tout, tstate = trw.rwkv_time_mix(
        torch.from_numpy(x),
        from_numpy_tree(params, device="cpu"),
        tcfg,
        state=None if state is None else from_numpy_tree(state, device="cpu"),
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=TOL)
    if with_state:
        _assert_tree_close(tstate, jstate)
    else:
        assert tstate is None and jstate is None
    assert twkv.wkv6_chunked.launches == 0


def test_decay_reaches_both_ends_of_the_clamp_in_the_references_order(monkeypatch):
    """The decay handed to the WKV op: float32, clip to [-20, 1.3863], -exp, clamp
    to [-4, -1e-4], exp. With w0 past both ends, w takes exactly exp(-4) and
    exp(-1e-4), and equals the reference's everywhere."""
    jcfg, tcfg, params, rng = _block_params(3, clamp_ends=True)
    x = rng.normal(size=(1, 12, jcfg.d_model)).astype(np.float32)
    seen = {}

    def spy(store, fn):
        def wrapped(r, k, v, w, u, **kwargs):
            store.append(np.asarray(w))
            return fn(r, k, v, w, u, **kwargs)

        return wrapped

    seen["jax"], seen["torch"] = [], []
    monkeypatch.setattr(jops, "wkv6", spy(seen["jax"], jops.wkv6))
    monkeypatch.setattr(tops, "wkv6", spy(seen["torch"], tops.wkv6))
    jrw.rwkv_time_mix(jnp.asarray(x), jax.tree.map(jnp.asarray, params), jcfg)
    trw.rwkv_time_mix(torch.from_numpy(x), from_numpy_tree(params, device="cpu"), tcfg)
    jw, tw = seen["jax"][0], seen["torch"][0]
    assert tw.dtype == np.float32
    lo = torch.exp(torch.tensor(-4.0)).item()
    hi = torch.exp(torch.tensor(-1e-4)).item()
    assert tw.min() == lo and tw.max() == hi
    assert (tw == lo).mean() >= 1 / 3 - 0.01 and (tw == hi).mean() >= 1 / 3 - 0.01
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)


@pytest.mark.parametrize("t", [1, 9])
@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "state"])
def test_channel_mix_matches_jax(with_state, t):
    jcfg, tcfg, params, rng = _block_params(5)
    x = rng.normal(size=(2, t, jcfg.d_model)).astype(np.float32)
    state = _state(rng, jcfg, 2) if with_state else None
    jout, jstate = jrw.rwkv_channel_mix(
        jnp.asarray(x),
        jax.tree.map(jnp.asarray, params),
        jcfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state),
    )
    tout, tstate = trw.rwkv_channel_mix(
        torch.from_numpy(x),
        from_numpy_tree(params, device="cpu"),
        tcfg,
        state=None if state is None else from_numpy_tree(state, device="cpu"),
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=TOL)
    if with_state:
        _assert_tree_close(tstate, jstate)
    else:
        assert tstate is None and jstate is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_segment_layout_and_param_tree_match_eval_shape(pair):
    jmodel, _, tmodel, _ = pair
    _, tcfg = _configs()
    assert tmodel.segments == jmodel.segments == [(("rwkv",), 4)]
    want = _shapes(jax.eval_shape(lambda r: jmodel.init(r)[0], jax.random.key(0)))
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(params) == want
    layer = params["seg0"]["u0"]
    assert sorted(layer) == ["ln1", "ln2", "rwkv"] and sorted(layer["ln1"]) == ["bias", "scale"]
    assert count_params(tcfg) == sum(int(np.prod(s)) for s, _ in want.values())
    # u is drawn from a normal of scale 0.5, not 1/sqrt(fan_in)
    assert 0.3 < layer["rwkv"]["time_mix"]["u"].std().item() < 0.6


def test_full_config_param_count():
    cfg = tconfigs.get_config("rwkv6-7b")
    assert count_params(cfg) == 7_660_773_376
    assert count_params(cfg) == count_params_analytic(get_config("rwkv6-7b"))
    assert build(cfg, device="cpu").segments == [(("rwkv",), 32)]


@pytest.mark.parametrize("s", [1, 7, 16, 21, 40])
def test_prefill_logits_and_caches_match_jax(pair, s):
    jmodel, jparams, tmodel, tparams = pair
    toks = _tokens(s, s)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_tree_close(tc, jc)
    assert tc["seg0"]["u0"]["wkv"].shape == (4, 1, 2, 64, 64)


@pytest.mark.parametrize("prompt", [3, 12])
def test_decode_matches_jax(pair, prompt):
    jmodel, jparams, tmodel, tparams = pair
    toks = _tokens(prompt, 100 + prompt)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, pad_to=32)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, pad_to=32)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    for _ in range(6):
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jtok})
        tl, tc = tmodel.decode_step(tparams, tc, {"token": ttok})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    _assert_tree_close(tc, jc)


@pytest.mark.parametrize("prompt,steps", [(12, 8), (5, 20), (16, 1), (1, 17)])
def test_decode_equals_fresh_prefill(pair, prompt, steps):
    """Prefill, then decode one token at a time: the last logits equal a prefill
    of all the tokens (the O(1) state carries the whole prefix)."""
    _, _, tmodel, tparams = pair
    seq = torch.from_numpy(_tokens(prompt + steps, 7 * prompt + steps)).long()
    _, cache = tmodel.prefill(tparams, {"tokens": seq[:, :prompt]}, pad_to=40)
    for i in range(prompt, prompt + steps):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": seq[:, i]})
    want, want_cache = tmodel.prefill(tparams, {"tokens": seq})
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0, atol=TOL)
    _assert_tree_close(cache, want_cache)


@pytest.mark.parametrize("pad_to", [0, 9, 40])
def test_pad_cache_leaves_the_rwkv_state_alone(pair, pad_to):
    """The state has no k/v leaves to grow: any ``pad_to`` gives the same cache,
    of the batcher's shape at batch 1."""
    _, _, tmodel, tparams = pair
    toks = torch.from_numpy(_tokens(9, 9)).long()
    _, cache = tmodel.prefill(tparams, {"tokens": toks}, pad_to=pad_to)
    _, plain = tmodel.prefill(tparams, {"tokens": toks})
    empty = tmodel.init_cache(1, 40)
    for key in ("wkv", "tm_prev", "cm_prev"):
        assert torch.equal(cache["seg0"]["u0"][key], plain["seg0"]["u0"][key])
        assert cache["seg0"]["u0"][key].shape == empty["seg0"]["u0"][key].shape
    assert empty["seg0"]["u0"]["wkv"].dtype == torch.float32


def test_cache_pos_of_an_rwkv_cache_is_zeros(pair):
    """An RWKV cache has no 'pos' leaf: positions are zeros, as in the reference."""
    _, _, tmodel, _ = pair
    pos = _cache_pos(tmodel.init_cache(3, 16), 3)
    assert pos.dtype == torch.int32 and pos.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_rwkv_batched_equals_sequential(pair, slots):
    """The reference's ``jnp.maximum`` splice gives r0 another stream at
    ``slots=1`` on these prompts; the port's per-slot splice does not."""
    _, _, tmodel, tparams = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (8, 30, 5, 17)]
    max_len, new = 48, 6
    want = {f"r{i}": _sequential(tmodel, tparams, p, new, max_len) for i, p in enumerate(prompts)}
    eng = ContinuousBatcher(tmodel, tparams, slots=slots, max_len=max_len)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=new))
    got = {rid: g.tokens for rid, g in eng.run_until_drained().items()}
    assert got == want
    assert twkv.wkv6_chunked.launches == 0


def test_launch_serve_runs_rwkv_on_the_cpu(capsys):
    from repro_torch.launch import serve

    args = "--arch rwkv6-7b --smoke --requests 3 --slots 2 --max-len 40"
    serve.main(args.split() + "--min-prompt 4 --max-prompt 30 --new-tokens 4 --device cpu".split())
    out = capsys.readouterr().out
    assert "rwkv6-7b-smoke on cpu: 3 requests, 12 tokens" in out


def test_smoke_rwkv_with_bfloat16_runs_through_the_plain_versions(pair):
    """The full config computes in bfloat16: the same layers in that dtype on
    the CPU keep the WKV state in float32 and the shift states in bfloat16, and
    give finite logits close to the float32 ones."""
    _, tcfg = _configs()
    _, _, tmodel, tparams = pair
    bcfg = dataclasses.replace(tcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    bparams = _to_dtype(tparams, torch.bfloat16)
    toks = torch.from_numpy(_tokens(24, 3)).long()
    got, cache = build(bcfg, device="cpu").prefill(bparams, {"tokens": toks}, pad_to=32)
    want, _ = tmodel.prefill(tparams, {"tokens": toks})
    assert cache["seg0"]["u0"]["wkv"].dtype == torch.float32
    assert cache["seg0"]["u0"]["tm_prev"].dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0.1)

