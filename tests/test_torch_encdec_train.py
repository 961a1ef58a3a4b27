"""Training seamless-m4t-large-v2 (encoder-decoder) and internvl2-2b (VLM) against the JAX package.

Smoke variants cut to 2 layers (seamless: 2 encoder and 2 decoder layers; internvl: 2 layers,
8 patch tokens of 64) with remat "full", as the full configs train, the reference's params
drawn once in bfloat16 and carried across by ``from_numpy_tree`` (taken to float32 for the
float32 runs, so that the float32 reference is both the float32 case's target and the
bfloat16 case's yardstick), seeded numpy inputs: tokens, and frames or patch embeddings.
The JAX side runs its ``ref`` attention dispatch, as its own tests do; each of its functions
is jitted once and shared. Cases:

- the loss and every gradient leaf against ``jax.value_and_grad(loss_fn)`` in float32, at
  remat "full" and "none", through the port's default route (the flash wrappers' plain
  versions on the CPU, under ``FlashAttentionFunction``) and through ``attn_impl="ref"``.
  In seamless the cross-attention's dK and dV reach the encoder through every decoder
  layer's ``wk``, ``wv``: its ``encoder`` leaves are held like the rest;
- the same in bfloat16, each leaf within twice the reference's own bfloat16-against-float32
  gap by relative L2 norm;
- two ``make_train_step`` steps against the reference's step (its ``value_and_grad`` then
  ``adamw_update``, jitted) on the same batches and from the same state: metrics, AdamW state
  and params; internvl on the port's one trajectory, seamless from the reference's;
- the flash backward's CPU path without a mask at Sq != Sk, GQA 2, against ``jax.vjp`` of
  ``flash_attention_pallas(causal=False, interpret=True)``: the backward twin of
  ``tests/test_torch_encdec.py::test_flash_non_causal_cross_shapes_match_pallas_interpret``.

The CUDA kernels run only on the card (``chip_smoke.py``'s encdec train phase).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import STEP_RTOL, _assert_tree_close, _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_opt_init as jmake_opt_init
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build
from repro_torch.optim import adamw as tadamw
from repro_torch.params import from_numpy_opt_state, from_numpy_tree
from repro_torch.train import make_opt_init, make_train_step
from repro_torch.train.steps import value_and_grad

ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")
# the subtree whose gradient crosses into the model's inputs: the encoder, or the patches' MLP
INPUT_SUBTREE = {"seamless-m4t-large-v2": "encoder/", "internvl2-2b": "frontend/"}
LAYERS = 2
BATCH, SEQ, SRC = 2, 24, 37  # frames no multiple of the tokens: cross-attention at Sq != Sk
METRICS = ("loss", "ce", "z_loss", "aux_loss")
# float32 both sides, XLA against ATen: the loss within 1e-5 relative and each gradient leaf
# within 1e-4 of its largest entry (tests/test_torch_moe_train.py's, tests/test_torch_train.py's)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# bfloat16: each leaf's relative L2 gap to the reference's bfloat16 run within BF16_GAPS x the
# reference's own gap between its bfloat16 and float32 runs (tests/test_torch_mtp.py's rule, by
# the L2 norm of a leaf where a max over it is one element's rounding), or GRAD_RTOL where that
# gap is smaller. The two packages round at other places (XLA fuses, ATen does not), a rounding
# of the kind and size of the gap: a missing or misplaced term moves a leaf by its own norm.
BF16_GAPS = 2.0
# A loss is one mean of N tokens' losses, each carrying bfloat16 roundings of ~2^-8 of itself
# with either sign: the mean moves by ~2^-8 / sqrt(N) of itself, and the reference's own gap is
# one draw of that which may sit near zero. Held within twice the gap or 2^-8 / sqrt(N) of
# itself, whichever is larger (tests/test_torch_mtp.py's BF16_MEAN_UNIT).
BF16_MEAN_UNIT = 2.0**-8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# AdamW's m and v after a step from the same state: m is a sum of gradients and v of their
# squares, each at the float32 gradient tolerance (v's doubled, with room)
STATE_RTOL = 1e-3
# A step's update of an entry is lr (m / (sqrt(v) + eps) + decay): about lr x sign(g) at the
# first steps. Where the entry's gradient is well above float32 noise the two packages'
# updates agree to far below 1e-3 lr. Where it lies within GRAD_RTOL of its leaf's largest
# entry from zero (~eps, 1e-8, for a few entries of a leaf), g / (|g| + eps) takes that noise
# and the updates may part by up to the step's whole reach: two ratios of at most 1.0004 (the
# second step's bias-corrected m / sqrt(v) bound at b1 = 0.9, b2 = 0.95) of either sign.
UPDATE_LR_SHARE = 1e-3
ADAMW_REACH = 2.01
# the archs whose steps start from the reference's state, not the port's own
# (test_two_train_steps_match_jax)
RESTART = ("seamless-m4t-large-v2",)
# the flash backward's CPU path against the Pallas VJP, float32 both sides (tests/
# test_torch_flash_bwd.py's TOL: the same function summed in other orders)
FLASH_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the small ops of the smoke model stall a machine-wide pool when
    test workers run in parallel (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, dtype, **changes):
    changes = {
        "num_layers": LAYERS,
        "remat": "full",
        "param_dtype": dtype,
        "compute_dtype": dtype,
        **changes,
    }
    jcfg = dataclasses.replace(jsmoke(get_config(arch)), **{**changes, "attn_impl": "ref"})
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(arch)), **changes)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """The reference's params drawn in bfloat16, as a jax tree in ``dtype``."""
    if dtype == "bfloat16":
        return jbuild(_configs(arch, "bfloat16")[0]).init(jax.random.key(0))[0]
    return jax.tree.map(lambda x: x.astype(jnp.float32), _params(arch, "bfloat16"))


def _batch(arch, seed):
    """Numpy inputs: tokens, and the stub frontend's frames or patch embeddings, N(0, 1) on
    the bfloat16 grid (both packages start from the same numbers in either dtype)."""
    cfg = _configs(arch, "float32")[1]
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if cfg.is_encdec:
        key, shape = "frames", (BATCH, SRC, cfg.frontend_dim)
    else:
        key, shape = "patch_embeds", (BATCH, cfg.num_frontend_tokens, cfg.frontend_dim)
    x = torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16().float()
    out[key] = x.numpy()
    return out


def _torch_batch(batch):
    return {
        k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
        for k, v in batch.items()
    }


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grad(arch, dtype):
    """The reference's ``jax.value_and_grad(loss_fn, has_aux=True)``, jitted once."""
    return jax.jit(jax.value_and_grad(jbuild(_configs(arch, dtype)[0]).loss_fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    batch = {k: jnp.asarray(v) for k, v in _batch(arch, 0).items()}
    (_, metrics), grads = _jax_grad(arch, dtype)(_params(arch, dtype), batch)
    return {**{k: _f32(v) for k, v in metrics.items()}, **dict(_leaves(_np(grads)))}


def _port_run(arch, dtype, **changes):
    _, tcfg = _configs(arch, dtype, **changes)
    params = from_numpy_tree(_np(_params(arch, dtype)), "cpu")
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    (_, metrics), grads = value_and_grad(
        build(tcfg, "cpu").loss_fn, params, _torch_batch(_batch(arch, 0))
    )
    # a CPU tensor runs each wrapper's plain version, which launches nothing
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0
    return {**metrics, **dict(_leaves(grads))}


@pytest.mark.parametrize("attn_impl", ["auto", "ref"])
@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax_grad_in_float32(arch, remat, attn_impl):
    ref = _jax_run(arch, "float32")
    port = _port_run(arch, "float32", remat=remat, attn_impl=attn_impl)
    for key in METRICS:
        np.testing.assert_allclose(
            float(port[key]), float(ref[key]), rtol=LOSS_RTOL, atol=1e-9, err_msg=key
        )
    leaves = [k for k in ref if "/" in k]
    assert sorted(leaves) == sorted(k for k in port if "/" in k)
    inputs = [k for k in leaves if k.startswith(INPUT_SUBTREE[arch])]
    assert inputs
    for key in leaves:
        w = ref[key]
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(port[key]), w, rtol=0, atol=atol, err_msg=key)
    # the gradient reaches the model's inputs: every encoder or frontend leaf moves
    for key in inputs:
        assert np.abs(_f32(port[key])).max() > 0, key


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax_grad_in_bfloat16(arch):
    """Through the port's default route at remat "full": each leaf within BF16_GAPS x the
    reference's own bfloat16-against-float32 gap by relative L2 norm, or GRAD_RTOL where that
    gap is smaller; the losses within twice their gap or BF16_MEAN_UNIT / sqrt(N)."""
    ref, ref32 = _jax_run(arch, "bfloat16"), _jax_run(arch, "float32")
    port = _port_run(arch, "bfloat16")
    n = BATCH * (SEQ - 1)  # the tokens the loss predicts
    wide = []
    for key in ref:
        a, b, c = ref[key], ref32[key], _f32(port[key])
        if "/" in key:
            assert port[key].dtype == torch.bfloat16, key
            size = max(np.linalg.norm(a), 1e-30)
            gap, err = np.linalg.norm(a - b) / size, np.linalg.norm(c - a) / size
            limit = max(BF16_GAPS * gap, GRAD_RTOL)
        else:
            gap, err = abs(float(a) - float(b)), abs(float(c) - float(a))
            limit = max(BF16_GAPS * gap, BF16_MEAN_UNIT / np.sqrt(n) * abs(float(a)))
        print(f"{arch} {key}: |port - ref bf16| {err:.3e}, ref gap bf16 vs f32 {gap:.3e}")
        if not err <= limit:
            wide.append(f"{key}: {err:.3e} > {limit:.3e} (gap {gap:.3e})")
    assert not wide, wide


def _jax_tree(tree, like):
    """A tree of the port's tensors as the reference's arrays, in the dtypes of ``like``."""
    return jax.tree.map(lambda x, y: jnp.asarray(x.detach().numpy().copy(), y.dtype), tree, like)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """Two ``make_train_step`` steps in float32 against the reference's on batches with frames
    or patches, each package's step from the same params and AdamW state. The reference's step
    is the body of ``repro.train.steps.make_train_step``, its ``value_and_grad`` of
    ``loss_fn`` then its ``adamw_update``, each jitted (the first shared with the float32
    case, so that the model's gradient is compiled once). Held: the metrics at STEP_RTOL
    (tests/test_torch_train.py's), m and v at STATE_RTOL of each leaf's largest entry, and
    each param's update as UPDATE_LR_SHARE says; AdamW's step count. internvl runs the port's
    one trajectory: its second step starts from its own first step's params and state, and
    the reference's step is taken from that same state. seamless (RESTART) starts each step
    from the reference's state instead, because its trajectories part: after one step the two
    packages' params differ by float32 noise, and at the next step the encoder's ReLUs whose
    inputs sit that close to zero flip, which moves seamless's encoder gradients by up to 1.5%
    of their largest entry at either package's own params."""
    jcfg, tcfg = _configs(arch, "float32")
    jopt, opt = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jparams = _params(arch, "float32")
    jstate = jmake_opt_init(jbuild(jcfg), jopt)(jparams)
    jupdate = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, jopt))
    step_fn = make_train_step(build(tcfg, "cpu"), opt)
    params = from_numpy_tree(_np(jparams), "cpu")
    state = from_numpy_opt_state(_np(jstate), "cpu")
    for step in range(2):
        batch = _batch(arch, 10 + step)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if arch in RESTART:
            params = from_numpy_tree(_np(jparams), "cpu")
            state = from_numpy_opt_state(_np(jstate), "cpu")
        else:  # the port's own state, as the reference's
            jparams, jstate = _jax_tree(params, jparams), _jax_tree(state, jstate)
        (_, jm), jgrads = _jax_grad(arch, "float32")(jparams, jbatch)
        params, state, metrics = step_fn(params, state, _torch_batch(batch))
        before = dict(_leaves(_np(jparams)))
        jparams, jstate, opt_metrics = jupdate(jparams, jgrads, jstate)
        jm = {**jm, **opt_metrics}
        assert sorted(metrics) == sorted(jm)
        for key, w in jm.items():
            np.testing.assert_allclose(
                float(metrics[key]), float(w), rtol=STEP_RTOL, atol=1e-7, err_msg=f"{key} {step}"
            )
        for key in ("m", "v"):
            _assert_tree_close(state[key], _np(jstate[key]), STATE_RTOL, f"{key} step {step}")
        lr, grads = float(jm["lr"]), dict(_leaves(_np(jgrads)))
        for (path, g), (_, w) in zip(_leaves(params), _leaves(_np(jparams)), strict=True):
            diff = np.abs((g.numpy() - before[path]) - (w - before[path]))
            noise = np.abs(grads[path]) <= GRAD_RTOL * np.abs(grads[path]).max()
            far = diff > UPDATE_LR_SHARE * lr
            assert not (far & ~noise).any(), (step, path, int((far & ~noise).sum()), diff.max())
            assert diff.max() <= ADAMW_REACH * lr, (step, path, diff.max())
        assert int(state["step"]) == int(jstate["step"]) == step + 1


@pytest.mark.parametrize("sq,sk", [(1, 40), (5, 40), (70, 33), (37, 100)])
def test_flash_bwd_non_causal_cross_shapes_match_pallas_vjp(sq, sk):
    """The backward wrapper's CPU path (on the forward's output and logsumexp) and
    ``ops.flash_attention`` under autograd, without a mask at Sq != Sk with GQA 2, against
    ``jax.vjp`` of the Pallas forward in interpret mode (its custom VJP)."""
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.normal(size=(2, 4, sq, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, 32)).astype(np.float32)
    dout = rng.normal(size=(2, 4, sq, 32)).astype(np.float32)
    fn = functools.partial(flash_attention_pallas, causal=False, interpret=True)
    grads = jax.jit(lambda q, k, v, do: jax.vjp(fn, q, k, v)[1](do))
    want = [np.asarray(g) for g in grads(*map(jnp.asarray, (q, k, v, dout)))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    out, lse, _ = tfa.flash_attention_fwd(tq, tk, tv, causal=False, return_lse=True)
    wrapper = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=False)
    xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(tops.flash_attention(*xs, causal=False), xs, tdo)
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0
    for got in (wrapper, auto):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=FLASH_TOL, atol=FLASH_TOL, err_msg=name)
