"""Encoder-decoder (seamless-m4t-large-v2) and VLM (internvl2-2b) serving, against the JAX package.

Smoke variants (seamless: 2 encoder and 4 decoder layers, source_len_for_decode 32;
internvl: 8 patch tokens of 64), the reference's params carried across by
``from_numpy_tree``, the JAX side with ``attn_impl="ref"``, seeded numpy inputs
(frames or patch embeddings, and tokens). Cases, each against the reference: the
param tree's keys and shapes (``encoder`` and ``frontend`` included); the full
configs' ``count_params``; prefill logits and the grown caches (an ``xattn`` layer's
``self`` subtree grown by ``_pad_cache``, its ``cross_k``/``cross_v`` at the
source's length); 4 greedy decode steps; the decode steps against a fresh prefill;
``init_cache`` then one ``decode_step`` at the reference's shapes; ``loss_fn`` over
the text positions; a bfloat16 copy within twice the reference's own
bfloat16-against-float32 gap. Then the flash wrapper's CPU path non-causal at
Sq != Sk against ``flash_attention_pallas(interpret=True)``, the encoder inside
prefill with remat "full" against "none", and each CLI's refusal of both archs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build as jbuild
from repro.models.model import count_params_analytic
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build
from repro_torch.params import count_params, from_numpy_tree, init_params

ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")
FULL_PARAMS = {"seamless-m4t-large-v2": 1_633_931_264, "internvl2-2b": 1_895_925_760}
# float32 both sides, XLA against ATen: summation order only (tests/test_torch_model.py)
TOL = 1e-4
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BATCH, PROMPT, SRC, MAX_LEN = 2, 9, 21, 24  # internvl: 8 patches + 9 + 4 steps fit
# A loss is one mean of N tokens' losses, each carrying bfloat16 roundings of ~2^-8 of itself
# with either sign: the mean moves by ~2^-8 / sqrt(N) of itself, and the reference's own gap is
# one draw of that which may sit near zero. So the bfloat16 loss is held within twice that gap
# or 2^-8 / sqrt(N) of itself, whichever is larger (tests/test_torch_mtp.py's BF16_MEAN_UNIT).
BF16_MEAN_UNIT = 2.0**-8


def _configs(arch, **changes):
    changes = {"attn_impl": "ref", **changes}
    jcfg = dataclasses.replace(jsmoke(get_config(arch)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(arch)), **changes)
    return jcfg, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, **changes):
    jcfg, tcfg = _configs(arch, **changes)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    return jcfg, jmodel, jparams, tcfg, build(tcfg, "cpu"), from_numpy_tree(_np(jparams), "cpu")


def _batch(cfg, seed, n_tok=PROMPT, src=SRC, batch=BATCH):
    """Numpy inputs: tokens, and the stub frontend's embeddings, N(0, 1) float32."""
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (batch, n_tok)).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = r.normal(size=(batch, src, cfg.frontend_dim)).astype(np.float32)
    else:
        nv = cfg.num_frontend_tokens
        out["patch_embeds"] = r.normal(size=(batch, nv, cfg.frontend_dim)).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch, device="cpu"):
    return {
        k: torch.from_numpy(v).to(device, torch.long if v.dtype == np.int32 else torch.float32)
        for k, v in batch.items()
    }


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _clone(tree):
    """A copy of a port cache: decode updates the cache in place."""
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# the param tree
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_has_the_reference_keys_and_shapes(arch):
    jcfg, _, jparams, tcfg, _, _ = _pair(arch)
    drawn = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {p: tuple(x.shape) for p, x in _paths(_np(jparams))}
    got = {p: tuple(x.shape) for p, x in _paths(drawn)}
    assert got == want
    assert list(drawn) == list(jparams)  # the reference's order of subtrees
    sub = "encoder" if jcfg.is_encdec else "frontend"
    assert sub in drawn and ("frontend" in drawn) == (jcfg.frontend == "vision_stub")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count_matches_the_reference(arch):
    full = tconfigs.get_config(arch)
    assert count_params(full) == FULL_PARAMS[arch] == count_params_analytic(get_config(arch))


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _served(arch):
    """Both sides' prefill (padded to MAX_LEN) and 4 greedy decode steps on the same batch:
    ((jax logits, jax cache), (port logits, port cache)) after each, the prefill first."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _pair(arch)
    batch = _batch(jcfg, 1)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("pad_to",))(
        jparams, _jax_batch(batch), pad_to=MAX_LEN
    )
    tl, tc = tmodel.prefill(tparams, _torch_batch(batch), pad_to=MAX_LEN)
    runs = [((_f32(jl), _np(jc)), (_f32(tl), _clone(tc)))]
    jdecode = jax.jit(jmodel.decode_step)
    jtok = jnp.argmax(jl, axis=-1)
    ttok = torch.argmax(tl, dim=-1)
    tokens = [(np.asarray(jtok).tolist(), ttok.tolist())]
    for _ in range(4):
        jl, jc = jdecode(jparams, jc, {"token": jtok})
        tl, tc = tmodel.decode_step(tparams, tc, {"token": ttok})
        runs.append(((_f32(jl), _np(jc)), (_f32(tl), _clone(tc))))
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        tokens.append((np.asarray(jtok).tolist(), ttok.tolist()))
    return batch, runs, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_grown_caches_match_jax(arch):
    jcfg = _pair(arch)[0]
    _, runs, _ = _served(arch)
    (jl, jc), (tl, tc) = runs[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    want = dict(_paths(jc))
    got = {p: x for p, x in _paths(tc)}
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        np.testing.assert_allclose(
            _f32(got[path]), _f32(leaf), rtol=0, atol=TOL, err_msg=str(path)
        )
    if jcfg.is_encdec:  # self grown to MAX_LEN; cross keys and values at the source's length
        xattn = tc["seg0"]["u0"]
        assert xattn["self"]["k"].shape[2] == MAX_LEN
        assert xattn["cross_k"].shape == (jcfg.num_layers, BATCH, jcfg.num_kv_heads, SRC, 32)
        assert xattn["cross_v"].shape == xattn["cross_k"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_steps_match_jax(arch):
    _, runs, tokens = _served(arch)
    for step, ((jl, jc), (tl, tc)) in enumerate(runs[1:]):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL, err_msg=f"step {step}")
        for path, leaf in _paths(jc):
            np.testing.assert_allclose(
                _f32(_leaf(tc, path)), _f32(leaf), rtol=0, atol=TOL, err_msg=f"{step} {path}"
            )
    for jtok, ttok in tokens:
        assert jtok == ttok


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_a_fresh_prefill(arch):
    """Each decode step's logits against the last position of a prefill over the prompt
    and the tokens fed so far (the reference's test_prefill_decode_consistency)."""
    _, _, _, tcfg, tmodel, tparams = _pair(arch)
    batch = _torch_batch(_batch(tcfg, 2, n_tok=6))
    toks = torch.randint(0, tcfg.vocab_size, (BATCH, 4), generator=torch.Generator().manual_seed(3))
    _, cache = tmodel.prefill(tparams, batch, pad_to=MAX_LEN)
    seq = batch["tokens"]
    for j in range(toks.shape[1]):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": toks[:, j]})
        seq = torch.cat([seq, toks[:, j : j + 1]], dim=1)
        fresh, _ = tmodel.prefill(tparams, {**batch, "tokens": seq})
        np.testing.assert_allclose(logits.numpy(), fresh.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_then_decode_step_has_the_reference_shapes(arch):
    """The reference's test_decode_step_shapes: init_cache(B, S) (a cross cache of
    source_len_for_decode for seamless), one decode step, the same tree back."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _pair(arch)
    jcache = jmodel.init_cache(BATCH, 32)
    tcache = tmodel.init_cache(BATCH, 32)
    want = {p: x.shape for p, x in _paths(jcache)}
    assert {p: tuple(x.shape) for p, x in _paths(tcache)} == want
    token = {"token": jnp.ones((BATCH,), jnp.int32)}
    jl, jc2 = jax.jit(jmodel.decode_step)(jparams, jcache, token)
    tl, tc2 = tmodel.decode_step(tparams, tcache, {"token": torch.ones(BATCH, dtype=torch.long)})
    assert tl.shape == (BATCH, tcfg.vocab_size) and torch.isfinite(tl).all()
    assert {p: tuple(x.shape) for p, x in _paths(tc2)} == {p: x.shape for p, x in _paths(jc2)}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    if tcfg.is_encdec:
        assert tcache["seg0"]["u0"]["cross_k"].shape[3] == tcfg.source_len_for_decode
        wide = tmodel.init_cache(1, 8, src_len=5)
        assert wide["seg0"]["u0"]["cross_v"].shape[3] == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax_over_the_text_positions(arch):
    jcfg, jmodel, jparams, _, tmodel, tparams = _pair(arch)
    batch = _batch(jcfg, 4, n_tok=12)
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, _jax_batch(batch))
    tloss, tmetrics = tmodel.loss_fn(tparams, _torch_batch(batch))
    assert sorted(tmetrics) == sorted(jmetrics)  # a jitted call returns its keys sorted
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for key, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[key]), float(v), rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _bf16_runs(arch):
    """(reference bfloat16, reference float32 on the same params, port bfloat16): prefill
    logits, the first decode step's logits and the loss, as float32 numpy."""
    jcfg, tcfg = _configs(arch, **BF16)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _pair(arch)[2])
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    batch = _batch(jcfg, 5)
    tok = np.arange(BATCH, dtype=np.int32) + 7

    def jax_run(cfg, params):
        model = jbuild(cfg)
        prefill = jax.jit(model.prefill, static_argnames=("pad_to",))
        logits, cache = prefill(params, _jax_batch(batch), pad_to=MAX_LEN)
        step, _ = jax.jit(model.decode_step)(params, cache, {"token": jnp.asarray(tok)})
        loss, _ = jax.jit(model.loss_fn)(params, _jax_batch(batch))
        return {"logits": _f32(logits), "decode": _f32(step), "loss": _f32(loss)}

    tmodel = build(tcfg, "cpu")
    tparams = from_numpy_tree(_np(jparams), "cpu")
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    logits, cache = tmodel.prefill(tparams, _torch_batch(batch), pad_to=MAX_LEN)
    step, _ = tmodel.decode_step(tparams, cache, {"token": torch.from_numpy(tok).long()})
    loss, _ = tmodel.loss_fn(tparams, _torch_batch(batch))
    port = {"logits": _f32(logits), "decode": _f32(step), "loss": _f32(loss)}
    return jax_run(jcfg, jparams), jax_run(jcfg32, jparams32), port


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_copy_matches_the_reference_bf16_run(arch):
    """Prefill logits and a decode step within twice the reference's own
    bfloat16-against-float32 gap, measured on the same params and inputs; the loss within
    twice that gap or BF16_MEAN_UNIT / sqrt(N) of itself."""
    ref, ref32, port = _bf16_runs(arch)
    n = BATCH * (PROMPT - 1)  # the next-token targets the loss averages
    for key in ref:
        a, b, c = (_f32(x[key]) for x in (ref, ref32, port))
        gap, err = np.abs(a - b).max(), np.abs(c - a).max()
        floor = BF16_MEAN_UNIT / np.sqrt(n) * np.abs(a).max() if key == "loss" else 0.0
        print(f"{arch} {key}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        assert gap > 0, key  # the bfloat16 run did round
        assert err <= max(2 * gap, floor), f"{key}: {err} > 2 x {gap} and {floor}"


def test_encoder_inside_prefill_checkpoints_nothing_without_autograd():
    """The encoder runs in train mode inside prefill; with remat "full" (seamless's
    setting) and autograd off it gives the bits of remat "none"."""
    _, _, jparams, _, _, _ = _pair(ARCHS[0])
    _, tcfg = _configs(ARCHS[0])
    batch = _torch_batch(_batch(tcfg, 6))
    params = from_numpy_tree(_np(jparams), "cpu")
    outs = []
    for remat in ("none", "full"):
        model = build(dataclasses.replace(tcfg, remat=remat), "cpu")
        with torch.no_grad():
            outs.append(model.prefill(params, batch)[0])
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# the flash wrapper without a mask at Sq != Sk (cross attention)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk", [(1, 40), (5, 40), (70, 33), (37, 100)])
def test_flash_non_causal_cross_shapes_match_pallas_interpret(sq, sk):
    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.normal(size=(2, 4, sq, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=False, interpret=True)
    got = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert tfa.flash_attention_fwd.launches == 0  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# the CLIs feed tokens alone, as the reference's do
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cli", ["serve", "gateway_serve", "train", "train_distributed"])
def test_clis_refuse_configs_with_more_than_tokens(cli, arch, monkeypatch):
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    if cli == "train_distributed":
        monkeypatch.setattr(mod, "ARCH", arch)
        argv = ["--device", "cpu", "--full"]
    else:
        argv = ["--arch", arch, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        mod.main(argv)
    msg = str(exc.value)
    takes = "frames" if "seamless" in arch else "patch_embeds"
    assert arch in msg and takes in msg and "build(cfg).prefill and decode_step" in msg
