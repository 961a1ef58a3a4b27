"""The dense family as whole models: the port against the JAX package, on the same params.

``smoke_variant`` of ``yi-6b`` (GQA), ``qwen1.5-110b`` (QKV bias),
``stablelm-1.6b`` (LayerNorm, partial rotary) and ``qwen3-1.7b`` (qk-norm,
tied embeddings), with the reference's params carried across by
``from_numpy_tree``: prefill logits and 4 decode steps within 1e-4 with
equal greedy tokens, the loss and every gradient leaf under ``remat`` "none"
and "full" at ``tests/test_torch_train.py``'s tolerances, and the port's
batcher at slots 1-3 against its own sequential decoding. Then bfloat16
copies of ``qwen3-1.7b`` and ``stablelm-1.6b`` (``param_dtype`` and
``compute_dtype`` bfloat16, the full configs' dtypes) against the
reference's bfloat16 run, within twice the reference's own gap between its
bfloat16 run and a float32 run of the same params on the same inputs; the
gaps are measured here and printed. Last, each full config's parameter
count against the reference's ``count_params_analytic``. The JAX side runs
its ``ref`` attention dispatch, as its own tests do on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batcher import _sequential_generate
from test_torch_train import _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenSource as JTokenSource
from repro.models import build as jbuild
from repro.models.model import count_params_analytic
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build
from repro_torch.params import count_params, from_numpy_tree
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.train.steps import value_and_grad

ARCHS = ["qwen3-1.7b", "stablelm-1.6b", "yi-6b", "qwen1.5-110b"]
BF16_ARCHS = ["qwen3-1.7b", "stablelm-1.6b"]
# count_params of each full config, the port's figure (the test holds it to the reference's)
FULL_PARAMS = {
    "qwen3-1.7b": 1_720_837_120,
    "stablelm-1.6b": 1_644_367_872,
    "yi-6b": 6_061_035_520,
    "qwen1.5-110b": 111_209_914_368,
}
# float32 both sides, XLA against ATen: summation order only (tests/test_torch_model.py)
LOGIT_TOL = 1e-4
# tests/test_torch_train.py's: the loss within 1e-5 relative, each gradient leaf within 1e-4
# of its largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ, BATCH = 32, 2
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _configs(arch, **changes):
    jcfg = dataclasses.replace(jsmoke(get_config(arch)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(arch)), **changes)
    return jcfg, tcfg


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    jcfg, tcfg = _configs(arch)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    return jcfg, jmodel, jparams, tcfg, build(tcfg, "cpu"), from_numpy_tree(_np(jparams), "cpu")


def _tokens(vocab, seq=SEQ, batch=BATCH):
    src = JTokenSource(JDataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=0))
    return src.batch_at(0)["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    _, jmodel, jparams, _, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, 512, size=(2, 13)).astype(np.int32)
    max_len = 24
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("pad_to",))(
        jparams, {"tokens": jnp.asarray(prompts)}, pad_to=max_len
    )
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts).long()}, pad_to=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        jl, jc = jdecode(jparams, jc, {"token": jtok})
        tl, tc = tmodel.decode_step(tparams, tc, {"token": ttok})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax(arch, remat):
    jcfg, tcfg = _configs(arch, remat=remat)
    _, _, jparams, _, _, tparams = _pair(arch)
    tokens = _tokens(jcfg.vocab_size)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens)}
    )
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    (tloss, tmetrics), tgrads = value_and_grad(
        build(tcfg, "cpu").loss_fn, tparams, {"tokens": torch.from_numpy(tokens)}
    )
    for key in jmetrics:
        np.testing.assert_allclose(
            float(tmetrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL, atol=1e-7, err_msg=key
        )
    for (path, g), (_, w) in zip(_leaves(tgrads), _leaves(jgrads), strict=True):
        w = _f32(w)
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(g), w, rtol=0, atol=atol, err_msg=f"grad {path}")
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_sequential(arch, slots):
    _, _, _, _, tmodel, tparams = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, rng.integers(4, 12)).astype(np.int32) for _ in range(4)]
    want = {
        f"r{i}": _sequential_generate(tmodel, tparams, p, 5, 32) for i, p in enumerate(prompts)
    }
    eng = ContinuousBatcher(tmodel, tparams, slots=slots, max_len=32)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=5))
    got = {rid: g.tokens for rid, g in eng.run_until_drained().items()}
    assert got == want


# --------------------------------------------------------------------------
# bfloat16 copies
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bf16_runs(arch):
    """(reference bfloat16, reference float32 on the same params, port bfloat16): each
    a dict of the last prefill logits, the loss and every gradient leaf, as float32 numpy."""
    jcfg, tcfg = _configs(arch, remat="full", **BF16)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams, _ = jbuild(jcfg).init(jax.random.key(1))
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tokens = _tokens(jcfg.vocab_size)

    def jax_run(cfg, params):
        model = jbuild(cfg)
        logits, _ = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(tokens)})
        (loss, _), grads = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens)}
        )
        return {"logits": _f32(logits), "loss": _f32(loss), **dict(_leaves(_np(grads)))}

    tmodel = build(tcfg, "cpu")
    tparams = from_numpy_tree(_np(jparams), "cpu")
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    logits, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()})
    (loss, _), grads = value_and_grad(tmodel.loss_fn, tparams, {"tokens": torch.from_numpy(tokens)})
    port = {"logits": _f32(logits), "loss": _f32(loss), **dict(_leaves(grads))}
    for path, g in _leaves(grads):
        assert g.dtype == torch.bfloat16, path
    return jax_run(jcfg, jparams), jax_run(jcfg32, jparams32), port


@pytest.mark.parametrize("what", ["logits", "loss", "grads"])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_copy_matches_the_reference_bf16_run(arch, what):
    """Each quantity within twice the reference's own bfloat16-against-float32 gap (max
    |a - b| over the quantity), measured on the same params and tokens: bfloat16 rounds at
    other places in XLA and ATen, and that rounding is the size of the gap."""
    ref, ref32, port = _bf16_runs(arch)
    keys = [k for k in ref if k not in ("logits", "loss")] if what == "grads" else [what]
    for key in keys:
        a, b, c = (_f32(x[key]) for x in (ref, ref32, port))
        gap = np.abs(a - b).max()
        err = np.abs(c - a).max()
        print(f"{arch} {key}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        assert gap > 0, key  # the bfloat16 run did round
        assert err <= 2 * gap, f"{key}: {err} > 2 x {gap}"


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_matches_the_reference(arch):
    assert count_params(tconfigs.get_config(arch)) == FULL_PARAMS[arch]
    assert count_params_analytic(get_config(arch)) == FULL_PARAMS[arch]
