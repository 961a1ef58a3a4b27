"""Training the hybrid family (recurrentgemma-9b's): the port against the JAX package.

The RG-LRU's gradient: the plain version of the Hopper backward kernel
(``ref.rglru_bwd_ref``) and ``ops.rglru`` under autograd (``RGLRUFunction``,
whose CPU path runs the plain forward and backward) against ``jax.grad``
through the reference's ``rglru_scan_ref`` and ``rglru_ref``, on seeded
numpy inputs; the a = 1 edge, where the gradient of sqrt(1 - a²) is
infinite; ``gradcheck`` of the walk's math in float64.

The flash backward at head dim 256 (the plain version, and in bfloat16 the
wrapper's CPU path and ``FlashAttentionFunction``) against ``jax.vjp``
through ``flash_attention_pallas(interpret=True)``.

The model: ``smoke_variant(recurrentgemma-9b)`` (rec, rec, attn, rec; d 128,
window 16) with the reference's params, the loss and every gradient leaf
under remat "none" and "full", two ``make_train_step`` steps against the
reference's step; bfloat16 copies, one at head dim 256, within twice the
reference's own bfloat16-against-float32 gap. The float32 copy at head dim
256 is refused by name: the float32 flash backward stops at 128 (ROADMAP
Queue 2 item 4). Last, serving's conv1d keeps its bits, and the train CLI
takes two steps of the smoke variant on the CPU.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _leaves, _np

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.configs.base import smoke_variant as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenSource as JTokenSource
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_opt_init as jmake_opt_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trg
from repro_torch.models import build
from repro_torch.models import rglru as trgm
from repro_torch.optim import adamw as tadamw
from repro_torch.params import from_numpy_tree
from repro_torch.train import make_opt_init, make_train_step
from repro_torch.train.steps import value_and_grad

ARCH = "recurrentgemma-9b"
# rtol = atol, tests/test_kernels.py:47: float32 sums in other orders (a reverse walk against
# the transpose of the reference's associative scan); bfloat16 one rounding of dx apart
RGLRU_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, T, W): tests/test_kernel_refs.py:125's shape, one step, a ragged channel count
RGLRU_SHAPES = [(2, 33, 16), (2, 1, 16), (3, 20, 13)]
# the flash backward's float32 tolerance, tests/test_kernels.py:63
FLASH_F32_TOL = 1e-3
# (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv): recurrentgemma-9b's MQA of 16 heads at head
# dim 256; ragged S from 40 to 150; a window crossing the kernels' 64-row tiles; Dv 128
FLASH_CASES = [
    (1, 16, 1, 40, 40, 256, True, None, 256),
    (1, 16, 1, 150, 150, 256, True, 70, 256),
    (1, 16, 1, 100, 130, 256, True, 50, 128),
    (2, 4, 2, 90, 90, 256, True, None, 256),
]
FLASH_IDS = [f"case{i}" for i in range(len(FLASH_CASES))]
# the model against the reference, float32 both sides: the loss within 1e-4 (absolute), each
# gradient leaf within 1e-3 of its largest entry
LOSS_TOL = 1e-4
GRAD_RTOL = 1e-3
# Params after two steps: every entry within STEP_SHARE of the most AdamW can move it (the sum
# of the learning rates). An entry whose gradient is within a few times AdamW's eps (1e-8) of
# zero moves by lr g / (|g| + eps): there a gradient that differs by 7e-10 (a millionth of the
# leaf's largest) moves the update by a twentieth of lr (seg0/u0/mlp/w_up, step 0). An update
# of the wrong sign moves an entry by twice lr.
STEP_SHARE = 0.05
SEQ, BATCH = 32, 2
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
OPT = dict(lr=3e-4, warmup_steps=10, total_steps=3)


# --------------------------------------------------------------------------
# the RG-LRU's gradient
# --------------------------------------------------------------------------


def _rglru_np(shape, seed, with_h0, ones=False):
    """x normal, a in (0.05, 0.98) as tests/test_kernel_refs.py draws them, h0, the
    gradients of h and of the final state; ``ones``: a = 1 on every third step, x = 0 on
    every fifth channel."""
    b, t, w = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    a = rng.uniform(0.05, 0.98, size=shape).astype(np.float32)
    if ones:
        a[:, ::3] = 1.0
        x[:, :, ::5] = 0.0
    h0 = rng.normal(size=(b, w)).astype(np.float32) * 0.5 if with_h0 else None
    dh = rng.normal(size=shape).astype(np.float32)
    dlast = rng.normal(size=(b, w)).astype(np.float32)
    return x, a, h0, dh, dlast


def _on_grid(x, dtype):
    """x rounded to ``dtype`` (bfloat16 or float32), as float32 numpy."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _jax_rglru_grads(fn, x, a, h0, dh, dlast, dtype):
    """jax.grad of sum(h * dh) + sum(S * dlast) through ``fn`` (x and h in ``dtype``):
    (dx, da, dh0 or None) as float32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(x, a, h0):
        h, s = fn(x, a, initial_state=h0)
        return jnp.sum(h.astype(jnp.float32) * jnp.asarray(dh, jdt).astype(jnp.float32)) + jnp.sum(
            s * dlast
        )

    args = (jnp.asarray(x, jdt), jnp.asarray(a), None if h0 is None else jnp.asarray(h0))
    grads = jax.grad(loss, argnums=(0, 1) if h0 is None else (0, 1, 2))(*args)
    out = [np.asarray(g, np.float32) for g in grads]
    return out[0], out[1], out[2] if h0 is not None else None


def _port_rglru_grads(how, x, a, h0, dh, dlast, dtype):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    at = torch.from_numpy(a)
    h0t = None if h0 is None else torch.from_numpy(h0)
    dht, dlt = torch.from_numpy(dh).to(tdt), torch.from_numpy(dlast)
    if how == "bwd_ref":
        dx, da, dh0 = tref.rglru_bwd_ref(xt, at, dht, initial_state=h0t, dh_last=dlt)
        return dx, da, dh0 if h0 is not None else None
    leaves = [xt.requires_grad_(True), at.requires_grad_(True)]
    if h0t is not None:
        leaves.append(h0t.requires_grad_(True))
    trg.rglru_bwd.launches = 0
    h, s = tops.rglru(xt, at, initial_state=h0t)
    assert h.grad_fn is not None and "RGLRUFunction" in type(h.grad_fn).__name__
    grads = torch.autograd.grad((h, s), leaves, (dht, dlt))
    assert trg.rglru_bwd.launches == 0  # the CPU path is the plain version
    return grads[0], grads[1], grads[2] if h0 is not None else None


@pytest.mark.parametrize("how", ["bwd_ref", "autograd"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RGLRU_SHAPES, ids=["T33", "T1", "W13"])
@pytest.mark.parametrize("fn", ["rglru_scan_ref", "rglru_ref"])
def test_rglru_grads_match_jax_grad(fn, shape, dtype, with_h0, how):
    x, a, h0, dh, dlast = _rglru_np(shape, 11 + shape[1], with_h0)
    x, dh = _on_grid(x, dtype), _on_grid(dh, dtype)
    want = _jax_rglru_grads(getattr(jref, fn), x, a, h0, dh, dlast, dtype)
    got = _port_rglru_grads(how, x, a, h0, dh, dlast, dtype)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    tol = RGLRU_TOL[dtype]
    for name, g, w in zip(("dx", "da", "dh0"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("how", ["bwd_ref", "autograd"])
@pytest.mark.parametrize("fn", ["rglru_scan_ref", "rglru_ref"])
def test_rglru_grads_at_a_equal_to_one_have_the_references_infinities(fn, how):
    """At a = 1 the derivative of sqrt(max(1 - a², 0)) is infinite: da is ±inf where x != 0
    and NaN where x = 0, and dx = 0, as jax.grad through the reference gives."""
    x, a, h0, dh, dlast = _rglru_np((2, 12, 10), 5, True, ones=True)
    want = _jax_rglru_grads(getattr(jref, fn), x, a, h0, dh, dlast, "float32")
    got = _port_rglru_grads(how, x, a, h0, dh, dlast, "float32")
    dx, da = got[0].numpy(), got[1].numpy()
    edge = a == 1.0
    assert np.isnan(want[1][edge & (x == 0)]).all() and np.isinf(want[1][edge & (x != 0)]).all()
    for check in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(check(da), check(want[1])), check.__name__
    assert (dx[edge] == 0).all() and (want[0][edge] == 0).all()
    finite = np.isfinite(want[1])
    np.testing.assert_allclose(da[finite], want[1][finite], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dx, want[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=2e-5, atol=2e-5)


class _Float64RGLRU(torch.autograd.Function):
    """The recurrence in float64 with ``rglru_bwd_ref`` as its gradient, for gradcheck."""

    @staticmethod
    def forward(ctx, x, a, h0):
        ctx.save_for_backward(x, a, h0)
        h, hs = h0, []
        for t in range(x.shape[1]):
            h = a[:, t] * h + torch.sqrt(torch.clamp(1.0 - a[:, t] * a[:, t], min=0.0)) * x[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1), h

    @staticmethod
    def backward(ctx, dh, dlast):
        x, a, h0 = ctx.saved_tensors
        return tref.rglru_bwd_ref(x, a, dh, initial_state=h0, dh_last=dlast)


def test_rglru_bwd_ref_passes_gradcheck_in_float64():
    x, a, h0, _, _ = _rglru_np((2, 7, 5), 3, True)
    args = [torch.from_numpy(v).double().requires_grad_(True) for v in (x, a, h0)]
    assert torch.autograd.gradcheck(_Float64RGLRU.apply, args, eps=1e-6, atol=1e-7)


def test_rglru_bwd_refuses_mismatched_gradients():
    x, a, _, dh, _ = _rglru_np((1, 4, 8), 0, False)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    with pytest.raises(ValueError, match="dh"):
        trg.rglru_bwd(xt, at, torch.from_numpy(dh).bfloat16())
    with pytest.raises(ValueError, match="dh_last"):
        trg.rglru_bwd(xt, at, torch.from_numpy(dh), dh_last=torch.zeros(1, 7))
    meta = [t.to("meta") for t in (xt, at, torch.from_numpy(dh))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trg.rglru_bwd(*meta)


# --------------------------------------------------------------------------
# the flash backward at head dim 256
# --------------------------------------------------------------------------


def _flash_np(i):
    b, hq, hkv, sq, sk, d, _, _, dv = FLASH_CASES[i]
    rng = np.random.default_rng(900 + i)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))
    # values on the bfloat16 grid, so that both dtypes start from the same numbers
    return tuple(_on_grid(rng.normal(size=s).astype(np.float32), "bfloat16") for s in shapes)


def _flash_masks(i):
    return dict(causal=FLASH_CASES[i][6], window=FLASH_CASES[i][7])


@functools.lru_cache(maxsize=None)
def _jax_flash_grads(i, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, dout = (jnp.asarray(x, jdt) for x in _flash_np(i))
    fn = functools.partial(
        flash_attention_pallas, **_flash_masks(i), block_q=64, block_k=64, interpret=True
    )
    _, vjp = jax.vjp(fn, q, k, v)
    return tuple(np.asarray(g, np.float32) for g in vjp(dout))


def _port_flash_grads(i, dtype, how):
    tdt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(x).to(tdt) for x in _flash_np(i))
    masks = _flash_masks(i)
    if how == "plain":
        out, lse = tref.flash_attention_ref(q, k, v, **masks, return_lse=True)
        return tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
    if how == "bwd_wrapper":
        out, lse, _ = tfa.flash_attention_fwd(q, k, v, **masks, return_lse=True)
        return tfa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = tops.flash_attention(*leaves, **masks)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("i", range(len(FLASH_CASES)), ids=FLASH_IDS)
def test_plain_flash_backward_at_head_dim_256_matches_jax_vjp_in_float32(i):
    got, want = _port_flash_grads(i, "float32", "plain"), _jax_flash_grads(i, "float32")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(
            g.numpy(), w, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL, err_msg=f"d{name}"
        )


@pytest.mark.parametrize("how", ["plain", "bwd_wrapper", "ops_auto"])
@pytest.mark.parametrize("i", range(len(FLASH_CASES)), ids=FLASH_IDS)
def test_bf16_flash_backward_at_head_dim_256_within_twice_the_references_gap(i, how):
    """In bfloat16 each gradient at most twice as far from the reference's float32 VJP as
    the reference's own bfloat16 VJP is, on the same inputs (max |.| over the gradient).
    Both bfloat16 results are rounded once at the end, so their gap to float32 is up to
    half a unit in the last place; held against each other, a value that the two round to
    neighbouring bfloat16 numbers alone would use up twice that gap."""
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    got = _port_flash_grads(i, "bfloat16", how)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, g, w, w32 in zip(
        "qkv", got, _jax_flash_grads(i, "bfloat16"), _jax_flash_grads(i, "float32")
    ):
        gap = np.abs(w - w32).max()
        err = np.abs(g.float().numpy() - w32).max()
        print(f"case{i} {how} d{name}: |port bf16 - ref f32| {err:.3e}, ref gap {gap:.3e}")
        assert 0 < gap and err <= 2 * gap, f"d{name}: {err} > 2 x {gap}"
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0


def test_float32_flash_backward_above_128_is_still_refused():
    q, k, v = (torch.randn(1, 2, 8, 256, requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="float32 heads above 128 wait for ROADMAP Queue 2 item 4"):
        tops.flash_attention(q, k, v)
    q, k, v = (
        torch.randn(1, 2, 8, 264, dtype=torch.bfloat16, requires_grad=True) for _ in range(3)
    )
    with pytest.raises(ValueError, match="above 256"):
        tops.flash_attention(q, k, v)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _configs(**changes):
    jcfg = dataclasses.replace(jsmoke(get_config(ARCH)), **changes)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get_config(ARCH)), **changes)
    return jcfg, tcfg


def _batch(step, vocab=512):
    src = JTokenSource(JDataConfig(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH, seed=0))
    return src.batch_at(step)["tokens"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _params(seed=0, **changes):
    jcfg, _ = _configs(**changes)
    jparams, _ = jbuild(jcfg).init(jax.random.key(seed))
    return jparams


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_grad_leaf_match_jax(remat):
    jcfg, tcfg = _configs(remat=remat)
    assert tcfg.block_pattern == ("rec", "rec", "attn", "rec")
    jparams = _params()
    tokens = _batch(0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens)}
    )
    trg.rglru_bwd.launches = trg.rglru_scan.launches = 0
    (tloss, tmetrics), tgrads = value_and_grad(
        build(tcfg, "cpu").loss_fn, from_numpy_tree(_np(jparams), "cpu"),
        {"tokens": torch.from_numpy(tokens)},
    )
    for key in jmetrics:
        np.testing.assert_allclose(
            float(tmetrics[key]), float(jmetrics[key]), rtol=0, atol=LOSS_TOL, err_msg=key
        )
    for (path, g), (_, w) in zip(_leaves(tgrads), _leaves(_np(jgrads)), strict=True):
        w = _f32(w)
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(g), w, rtol=0, atol=atol, err_msg=f"grad {path}")
    assert trg.rglru_bwd.launches == trg.rglru_scan.launches == 0


def test_float32_copy_at_head_dim_256_is_refused_by_name():
    _, tcfg = _configs(head_dim=256)
    model = build(tcfg, "cpu")
    params = from_numpy_tree(_np(_params(head_dim=256)), "cpu")
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 4"):
        value_and_grad(model.loss_fn, params, {"tokens": torch.from_numpy(_batch(0))})


def test_two_train_steps_match_the_references_step():
    """make_train_step twice from the reference's params against the reference's step
    called directly (jitted): each step's metrics within the loss tolerance, AdamW's m
    after them within GRAD_RTOL of each leaf's largest entry, the params as below."""
    jcfg, tcfg = _configs()
    jmodel = jbuild(jcfg)
    jparams = _params()
    jopt = jadamw.AdamWConfig(**OPT)
    jstate = jmake_opt_init(jmodel, jopt)(jparams)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    model = build(tcfg, "cpu")
    topt = tadamw.AdamWConfig(**OPT)
    params = from_numpy_tree(_np(jparams), "cpu")
    state = make_opt_init(model, topt)(params)
    step = make_train_step(model, topt)
    lr_sum = 0.0
    for s in range(2):
        tokens = _batch(s)
        jparams, jstate, jmetrics = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, metrics = step(params, state, {"tokens": torch.from_numpy(tokens)})
        for key, w in jmetrics.items():
            np.testing.assert_allclose(
                float(metrics[key]), float(w), rtol=1e-4, atol=LOSS_TOL, err_msg=f"{key} step {s}"
            )
        lr_sum += float(jmetrics["lr"])
    for (path, g), (_, w) in zip(_leaves(state["m"]), _leaves(_np(jstate["m"])), strict=True):
        w = np.asarray(w)
        atol = GRAD_RTOL * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(_f32(g), w, rtol=0, atol=atol, err_msg=f"m {path}")
    for (path, g), (_, w) in zip(_leaves(params), _leaves(_np(jparams)), strict=True):
        diff = np.abs(_f32(g) - np.asarray(w)).max()
        assert diff <= STEP_SHARE * lr_sum, (path, diff, lr_sum)
    assert int(state["step"]) == 2


@functools.lru_cache(maxsize=None)
def _bf16_runs(head_dim):
    """(reference bfloat16, reference float32 on the same params, port bfloat16) loss and
    gradient leaves at remat "full", as float32 numpy; the port's through the CPU paths of
    FlashAttentionFunction and RGLRUFunction."""
    jcfg, tcfg = _configs(remat="full", head_dim=head_dim, **BF16)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams, _ = jbuild(jcfg).init(jax.random.key(1))
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tokens = _batch(0)

    def jax_run(cfg, params):
        (loss, _), grads = jax.jit(jax.value_and_grad(jbuild(cfg).loss_fn, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens)}
        )
        return {"loss": _f32(loss), **dict(_leaves(_np(grads)))}

    tparams = from_numpy_tree(_np(jparams), "cpu")
    (loss, _), grads = value_and_grad(
        build(tcfg, "cpu").loss_fn, tparams, {"tokens": torch.from_numpy(tokens)}
    )
    for path, g in _leaves(grads):
        assert g.dtype == torch.bfloat16, path
    port = {"loss": _f32(loss), **dict(_leaves(grads))}
    return jax_run(jcfg, jparams), jax_run(jcfg32, jparams32), port


@pytest.mark.parametrize("head_dim", [32, 256])
def test_bf16_copy_matches_the_reference_bf16_run(head_dim):
    """The loss and each gradient leaf within twice the reference's own gap between its
    bfloat16 run and a float32 run of the same params (max |.| over the leaf)."""
    ref, ref32, port = _bf16_runs(head_dim)
    for key in ref:
        a, b, c = (_f32(x[key]) for x in (ref, ref32, port))
        gap, err = np.abs(a - b).max(), np.abs(c - a).max()
        print(f"head_dim {head_dim} {key}: |port - ref bf16| {err:.3e}, ref gap {gap:.3e}")
        assert gap > 0, key
        assert err <= 2 * gap, f"{key}: {err} > 2 x {gap}"


def _conv1d_before(x, weight, bias, tail):
    """_causal_conv1d as it was before its gradient form: float32 taps into one buffer."""
    b, t, w = x.shape
    k = weight.shape[0]
    if tail is None:
        tail = x.new_zeros((b, k - 1, w))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = torch.zeros((b, t, w), dtype=torch.float32, device=x.device)
    tap = torch.empty_like(y)
    for i in range(k):
        y.add_(torch.mul(xp[:, i : i + t, :], weight[i].float(), out=tap))
    return y.add_(bias.float()).to(x.dtype), xp[:, t:, :].clone()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_tail", [False, True])
def test_conv1d_keeps_its_bits_and_its_gradient_form_gives_the_same(dtype, with_tail):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 9, 24)).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.normal(size=(4, 24)).astype(np.float32) * 0.3).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(24,)).astype(np.float32)).to(dtype)
    tail = torch.from_numpy(rng.normal(size=(2, 3, 24)).astype(np.float32)).to(dtype)
    tail = tail if with_tail else None
    want_y, want_tail = _conv1d_before(x, weight, bias, tail)
    y, new_tail = trgm._causal_conv1d(x, weight, bias, tail)  # serving: no gradient
    assert torch.equal(y, want_y) and torch.equal(new_tail, want_tail)
    leaves = [z.clone().requires_grad_(True) for z in (x, weight, bias)]
    y_grad, _ = trgm._causal_conv1d(*leaves, tail)
    assert y_grad.grad_fn is not None and torch.equal(y_grad.detach(), want_y)
    grads = torch.autograd.grad(y_grad.float().sum(), leaves)
    assert all(g is not None and torch.isfinite(g.float()).all() for g in grads)


def test_cli_trains_the_first_layers_alone(tmp_path):
    """``--layers 3`` keeps (rec, rec, attn) of the smoke config's (rec, rec, attn, rec)."""
    root = Path(__file__).resolve().parents[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu"]
    cmd += ["--steps", "1", "--layers", "3", "--run-dir", str(tmp_path / "run")]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"training {ARCH}-smoke: 3 layers,")
    assert "done: 1 steps" in proc.stdout
    cmd[cmd.index("3")] = "5"
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode != 0 and "--layers 5" in proc.stderr


def test_cli_trains_the_hybrid_smoke_config_on_the_cpu(tmp_path):
    root = Path(__file__).resolve().parents[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu"]
    cmd += ["--steps", "2", "--checkpoint-every", "2", "--run-dir", str(tmp_path / "run")]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"training {ARCH}-smoke: 4 layers,")
    assert "done: 2 steps" in proc.stdout
    last = proc.stdout.strip().splitlines()[-1]
    assert last == (
        'kernel launches {"flash_attention_fwd": 0, "flash_attention_bwd": 0, "rglru_scan": 0, '
        '"rglru_bwd": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}'
    )
