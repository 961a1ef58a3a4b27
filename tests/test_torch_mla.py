"""MLA (DeepSeek-V3's multi-head latent attention) and deepseek-v3-671b, against the JAX package.

Same inputs (numpy, seeded) and the reference's params carried across by
``from_numpy_tree``. The JAX side's attention runs through
``flash_attention_pallas(interpret=True)`` (``attn_impl="pallas"``, as
``tests/test_kernels.py`` runs the kernel on the CPU); the port's on the CPU
through its wrapper's plain version. Cases: ``mla_attention``'s prefill and 4
absorbed decode steps at per-sequence positions; ``rope`` on the 3-D shared
rope key at both position shapes; the smoke model of ``deepseek-v3-671b`` (1
dense + 3 MoE layers with a shared expert, qk 32 + 16, v 32, latent 32, MTP
params present): the prefill caches grown by ``_pad_cache`` as the
reference's, prefill and 4 decode steps within 1e-4 with equal greedy tokens,
the absorbed decode against a fresh prefill, the batcher at slots 1-3 against
sequential decoding, a bfloat16 copy within twice the reference's own
bfloat16-against-float32 gap; the param tree (``mtp`` included) with the
reference's keys and shapes; the full config's parameter counts, whole and at
the 4 layers the chip smoke serves; the flash wrapper's CPU path at MLA's head
dims with an explicit scale. The MTP loss and training are in ``tests/test_torch_mtp.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batcher import _sequential_generate
from test_torch_dense import _f32
from test_torch_train import _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.layers import ParamStore as JParamStore
from repro.models.model import count_params_analytic
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.params import count_params, from_numpy_tree, init_params
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "deepseek-v3-671b"
# count_params of the full config and of its first 4 layers (3 dense, 1 MoE), the port's
# figures (the test holds them to the reference's)
FULL_PARAMS, ACTIVE_PARAMS = 671_716_332_544, 38_242_210_816
CUT_LAYERS = 4
CUT_PARAMS = 15_801_029_632
# float32 both sides, XLA against ATen: summation order only (tests/test_torch_model.py)
TOL = 1e-4
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
MAX_LEN = 24


def _configs(**changes):
    changes = {"attn_impl": "pallas", **changes}
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# the attention block
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mla_params(seed=0):
    """One MLA block's params from the reference's ``init_mla``: (jax tree, torch tree)."""
    jcfg, _ = _configs()
    store = JParamStore(jax.random.key(seed), jnp.float32)
    jattn.init_mla(store, "attn", jcfg)
    jp = store.params["attn"]
    return jp, from_numpy_tree(_np(jp), "cpu")


def test_mla_prefill_and_absorbed_decode_match_jax():
    """The block's prefill (flash at key head dim 48, value head dim 32, scale 48^-0.5), the
    cache built from it as the transformer builds it, then 4 absorbed decode steps with the
    rows at different positions (the second row overwrites its last 4 latents)."""
    jcfg, tcfg = _configs()
    jp, tp = _mla_params()
    rng = np.random.default_rng(7)
    b, s = 2, 13
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    positions = np.arange(s)
    jprefill = jax.jit(lambda x, pos: jattn.mla_attention(x, jp, jcfg, positions=pos))
    jout, _ = jprefill(jnp.asarray(x), jnp.asarray(positions))
    tout, _ = tattn.mla_attention(
        torch.from_numpy(x), tp, tcfg, positions=torch.from_numpy(positions)
    )
    _close(tout, jout, TOL, "prefill")

    jc = jtransformer._prefill_cache_from_full(
        jnp.asarray(x), {"attn": jp}, jcfg, "dense", jnp.asarray(positions), s
    )
    tc = ttransformer._prefill_cache_from_full(
        torch.from_numpy(x), {"attn": tp}, tcfg, "dense", torch.from_numpy(positions), s
    )
    assert set(tc) == set(jc) == {"ckv", "krope", "pos"}
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key], TOL, key)
        pad = [(0, 0), (0, MAX_LEN - s), (0, 0)]
        jc[key] = jnp.pad(jc[key], pad)
        tc[key] = torch.nn.functional.pad(tc[key], (0, 0, 0, MAX_LEN - s))
    start = np.array([s, s - 4], np.int32)
    jc["pos"], tc["pos"] = jnp.asarray(start), torch.from_numpy(start.copy())
    for step in range(4):
        xt = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
        pos = start + step
        jout, jc = jattn.mla_attention(
            jnp.asarray(xt), jp, jcfg, positions=jnp.asarray(pos)[:, None], cache=jc
        )
        tout, tc = tattn.mla_attention(
            torch.from_numpy(xt), tp, tcfg, positions=torch.from_numpy(pos)[:, None], cache=tc
        )
        _close(tout, jout, TOL, f"decode step {step}")
        for key in ("ckv", "krope", "pos"):
            _close(tc[key], jc[key], TOL, f"{key} after step {step}")


@pytest.mark.parametrize("shape", ["prefill", "decode"])
def test_rope_on_the_shared_rope_key(shape):
    """``krope`` is 3-D (B, S, qk_rope): positions (S,) in prefill, (B, 1) in decode."""
    rng = np.random.default_rng(3)
    if shape == "prefill":
        x = rng.normal(size=(2, 9, 16)).astype(np.float32)
        positions = np.arange(9)
    else:
        x = rng.normal(size=(3, 1, 16)).astype(np.float32)
        positions = np.array([[5], [0], [1234]])
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(positions), theta=10_000.0)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(positions), theta=10_000.0)
    assert got.shape == x.shape
    _close(got, want, 1e-5)


# --------------------------------------------------------------------------
# the whole smoke model
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    jcfg, tcfg = _configs()
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    tparams = from_numpy_tree(_np(jparams), "cpu")
    return jcfg, jmodel, jparams, tcfg, build(tcfg, "cpu"), tparams


def _prompts():
    return np.random.default_rng(11).integers(0, 512, size=(2, 13)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill():
    _, jmodel, jparams, _, _, _ = _pair()
    fn = jax.jit(jmodel.prefill, static_argnames=("pad_to",))
    return fn(jparams, {"tokens": jnp.asarray(_prompts())}, pad_to=MAX_LEN)


def test_param_tree_matches_the_reference_keys_and_shapes():
    jcfg, _, jparams, tcfg, _, _ = _pair()
    assert jcfg.mtp and tcfg.mtp
    ours = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {p: (x.shape, str(x.dtype)) for p, x in _leaves(_np(jparams))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in _leaves(ours)}
    assert got == want
    assert set(ours["mtp"]) == {"norm_h", "norm_e", "proj", "layer"}
    assert set(ours["mtp"]["layer"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"
    }
    assert set(ours["seg1"]["u0"]["moe"]) == {"router", "experts", "shared"}
    jc = jattn.init_mla_cache(jcfg, 2, 8, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, 2, 8, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}


def test_prefill_caches_grow_as_the_reference_pads_them():
    """``_pad_cache`` grows ``ckv`` and ``krope`` along their sequence axis to ``pad_to``, as
    the reference's ``_PAD_AXIS`` does; ``pos`` stays as it is."""
    _, _, _, _, tmodel, tparams = _pair()
    _, jcache = _jax_prefill()
    _, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(_prompts()).long()},
                               pad_to=MAX_LEN)
    want = dict(_leaves(_np(jcache)))
    got = dict(_leaves(tcache))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        _close(got[path], leaf, TOL, path)
    assert got["seg0/u0/ckv/"].shape[-2] == got["seg1/u0/krope/"].shape[-2] == MAX_LEN


def test_prefill_and_decode_match_jax():
    _, jmodel, jparams, _, tmodel, tparams = _pair()
    jl, jc = _jax_prefill()
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(_prompts()).long()},
                            pad_to=MAX_LEN)
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


def test_absorbed_decode_equals_a_fresh_prefill():
    """The absorbed form (latent space) against the expanded one (per-head K/V through the
    flash wrapper): the logits after 4 decode steps equal a prefill of the same tokens."""
    _, _, _, _, tmodel, tparams = _pair()
    prompt = torch.from_numpy(_prompts()[:1]).long()
    logits, cache = tmodel.prefill(tparams, {"tokens": prompt}, pad_to=MAX_LEN)
    toks = [torch.argmax(logits, dim=-1)]
    for _ in range(4):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": toks[-1]})
        toks.append(torch.argmax(logits, dim=-1))
    full = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
    fresh, _ = tmodel.prefill(tparams, {"tokens": full})
    _close(logits, fresh, TOL)


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
    """(reference bfloat16, reference float32 on the same params, port bfloat16): the prefill
    logits and those of 2 decode steps fed the reference's bfloat16 greedy tokens, as
    float32 numpy."""
    jcfg, tcfg = _configs(**BF16)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams, _ = jbuild(jcfg).init(jax.random.key(1))
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    prompts = _prompts()

    def jax_run(cfg, params, feed=None):
        model = jbuild(cfg)
        logits, cache = jax.jit(model.prefill, static_argnames=("pad_to",))(
            params, {"tokens": jnp.asarray(prompts)}, pad_to=MAX_LEN
        )
        out, toks = [_f32(logits)], []
        decode = jax.jit(model.decode_step)
        for step in range(2):
            tok = jnp.argmax(logits, axis=-1) if feed is None else jnp.asarray(feed[step])
            toks.append(np.asarray(tok))
            logits, cache = decode(params, cache, {"token": tok})
            out.append(_f32(logits))
        return {"prefill": out[0], "decode": np.stack(out[1:])}, toks

    ref, toks = jax_run(jcfg, jparams)
    ref32, _ = jax_run(jcfg32, jparams32, toks)
    tmodel = build(tcfg, "cpu")
    tparams = from_numpy_tree(_np(jparams), "cpu")
    assert tparams["seg0"]["u0"]["attn"]["wkv_b"].dtype == torch.bfloat16
    logits, cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},
                                   pad_to=MAX_LEN)
    out = [_f32(logits)]
    for tok in toks:
        logits, cache = tmodel.decode_step(tparams, cache, {"token": torch.tensor(tok).long()})
        out.append(_f32(logits))
    return ref, ref32, {"prefill": out[0], "decode": np.stack(out[1:])}


@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_bf16_copy_matches_the_reference_bf16_run(what):
    """Within twice the reference's own bfloat16-against-float32 gap (max |a - b|) on the
    same params and tokens, tests/test_torch_dense.py's rule."""
    ref, ref32, port = _bf16_runs()
    gap = np.abs(ref[what] - ref32[what]).max()
    err = np.abs(port[what] - ref[what]).max()
    print(f"{ARCH} {what} logits: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
    assert gap > 0
    assert err <= 2 * gap, f"{what}: {err} > 2 x {gap}"


@pytest.mark.parametrize("layers", [None, CUT_LAYERS], ids=["full", "cut"])
def test_full_param_counts_match_the_reference(layers):
    tcfg, jcfg = tconfigs.get_config(ARCH), get_config(ARCH)
    if layers:
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        assert count_params(tcfg) == CUT_PARAMS
    else:
        assert count_params(tcfg) == FULL_PARAMS
        assert count_params(tcfg, active_only=True) == ACTIVE_PARAMS
    assert count_params(tcfg) == count_params_analytic(jcfg)
    assert count_params(tcfg, active_only=True) == count_params_analytic(jcfg, active_only=True)


# --------------------------------------------------------------------------
# the flash wrapper at MLA's head dims
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d, dv", [(48, 32), (192, 128)])
def test_flash_wrapper_cpu_path_at_mla_head_dims(d, dv):
    """Key head dim != value head dim with an explicit scale, against
    ``flash_attention_pallas(interpret=True)`` (tests/test_kernels.py's tolerance)."""
    rng = np.random.default_rng(9)
    q, k = (rng.normal(size=(1, 2, 70, d)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(1, 2, 70, dv)).astype(np.float32)
    scale = 0.7 * d**-0.5
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), True, None, scale, 32, 32, True)
    got = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=True, scale=scale)
    assert got.shape == (1, 2, 70, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
