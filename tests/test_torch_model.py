"""The port's dense decoder against the JAX package's, on the same params.

The JAX params are drawn by ``repro``'s ``model.init`` and loaded into the
port with ``from_numpy_tree``. Prefill logits at the last position and the
logits of 4 decode steps must agree within 1e-4 (float32 both sides; XLA and
ATen sum in different orders) and the greedy tokens must be identical. A
narrow demo variant runs at 2 layers (the reference unrolls that segment)
and at 8 layers (the reference scans it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.models import build as jbuild
from repro_torch.models import build
from repro_torch.params import count_params, from_numpy_tree, init_params

NARROW = dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512)
TOL = 1e-4


def _configs(num_layers):
    jcfg = dataclasses.replace(
        get_config("serpytor-demo-100m"), name="narrow", num_layers=num_layers, **NARROW
    )
    tcfg = dataclasses.replace(
        tconfigs.get_config("serpytor-demo-100m"), name="narrow", num_layers=num_layers, **NARROW
    )
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[2, 8], ids=["2_layers_unrolled", "8_layers_scanned"])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(request.param))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, tcfg, build(tcfg, device="cpu"), tparams


def test_segment_layout_matches(pair):
    jcfg, jmodel, _, _, tmodel, _ = pair
    assert tmodel.segments == jmodel.segments
    repeats = jcfg.num_layers
    assert jmodel.segments == [(("dense",), repeats)]  # <= 4 unrolled, > 4 scanned


def test_prefill_and_decode_match_jax(pair):
    _, jmodel, jparams, _, tmodel, tparams = pair
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, 512, size=(2, 13)).astype(np.int32)
    max_len = 24
    jprefill = jax.jit(jmodel.prefill, static_argnames=("pad_to",))
    jdecode = jax.jit(jmodel.decode_step)

    jl, jc = jprefill(jparams, {"tokens": jnp.asarray(prompts)}, pad_to=max_len)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()}, pad_to=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    for _ in range(4):
        jl, jc = jdecode(jparams, jc, {"token": jtok})
        tl, tc = tmodel.decode_step(tparams, tc, {"token": ttok})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    # the caches agree too: K/V rows written so far and the positions
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(
            tc["seg0"]["u0"][key].numpy(), np.asarray(jc["seg0"]["u0"][key]), rtol=0, atol=TOL
        )


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: (tuple(tree.shape), np.dtype(str(tree.dtype).replace("torch.", "")).name)}


@pytest.mark.parametrize("num_layers", [2, 8])
def test_init_params_tree_matches_jax_eval_shape(num_layers):
    jcfg, tcfg = _configs(num_layers)
    jmodel = jbuild(jcfg)
    want = _shapes(jax.eval_shape(lambda r: jmodel.init(r)[0], jax.random.key(0)))
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(params) == want
    assert count_params(tcfg) == sum(int(np.prod(s)) for s, _ in want.values())


def test_init_params_draw_is_seeded_and_bounded():
    _, tcfg = _configs(2)
    a = init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(tcfg, torch.Generator().manual_seed(4), device="cpu")
    wq = a["seg0"]["u0"]["attn"]["wq"]
    assert torch.equal(wq, b["seg0"]["u0"]["attn"]["wq"])
    assert not torch.equal(wq, c["seg0"]["u0"]["attn"]["wq"])
    std = 1 / np.sqrt(tcfg.d_model)
    assert wq.abs().max() <= 2 * std + 1e-6  # truncated at 2 sigma
    assert 0.6 * std < wq.std() < 1.0 * std  # the [-2, 2] truncation keeps 0.88 sigma
    assert torch.equal(a["final_norm"]["scale"], torch.ones(tcfg.d_model))


def test_demo_param_count_matches_the_reference():
    port = tconfigs.get_config("serpytor-demo-100m").param_count()
    assert port == get_config("serpytor-demo-100m").param_count()



VARIANTS = {
    "plain": {},
    "qk_norm": {"qk_norm": True},
    "qkv_bias": {"qkv_bias": True},
    "partial_rotary": {"rope_fraction": 0.25},
}


def _attention_setup(variant, seed):
    """Configs of the variant and one attention block's params as numpy."""
    from repro.models.attention import init_gqa
    from repro.models.layers import ParamStore

    jcfg, tcfg = (dataclasses.replace(c, **VARIANTS[variant]) for c in _configs(2))
    store = ParamStore(jax.random.key(seed), jnp.float32)
    init_gqa(store, "attn", jcfg)
    rng = np.random.default_rng(seed)
    params = {}
    for name, value in store.params["attn"].items():
        value = np.asarray(value)
        if value.ndim == 1:  # biases start at 0 and norm scales at 1: draw them so they matter
            value = (value + 0.5 * rng.normal(size=value.shape)).astype(np.float32)
        params[name] = value
    return jcfg, tcfg, params, rng


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gqa_full_sequence_matches_jax(variant):
    from repro.models.attention import gqa_attention as jgqa
    from repro_torch.models.attention import gqa_attention as tgqa

    jcfg, tcfg, params, rng = _attention_setup(variant, 21)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    pos = np.arange(37)
    want, _ = jgqa(jnp.asarray(x), jax.tree.map(jnp.asarray, params), jcfg, positions=pos)
    tparams = from_numpy_tree(params, device="cpu")
    got, _ = tgqa(torch.from_numpy(x), tparams, tcfg, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("ring", [False, True], ids=["linear_cache", "ring_cache"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gqa_cached_decode_matches_jax(variant, ring):
    """One decode step against a cache with per-sequence positions; with
    ``ring`` the cache is a local-window ring buffer (Sc == window) that
    has wrapped for one sequence and not for the other."""
    from repro.models.attention import gqa_attention as jgqa
    from repro_torch.models.attention import gqa_attention as tgqa

    jcfg, tcfg, params, rng = _attention_setup(variant, 22)
    b, sc = 2, 16
    kv, hd = jcfg.num_kv_heads, jcfg.head_dim
    pos = np.array([5, 29] if ring else [5, 11], np.int32)
    k = rng.normal(size=(b, sc, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sc, kv, hd)).astype(np.float32)
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    window = sc if ring else None
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    want, jnew = jgqa(
        jnp.asarray(x),
        jax.tree.map(jnp.asarray, params),
        jcfg,
        positions=jnp.asarray(pos)[:, None],
        cache=jcache,
        window=window,
    )
    tcache = from_numpy_tree({"k": k, "v": v, "pos": pos}, device="cpu")
    got, tnew = tgqa(
        torch.from_numpy(x),
        from_numpy_tree(params, device="cpu"),
        tcfg,
        positions=tcache["pos"][:, None].clone(),
        cache=tcache,
        window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), rtol=0, atol=TOL)
