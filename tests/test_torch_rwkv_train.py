"""Training the RWKV6 family (rwkv6-7b's): the port against the JAX package.

The WKV6 gradient: the plain version of the Hopper backward kernel
(``ref.wkv6_bwd_ref``) and ``ops.wkv6`` under autograd (``WKV6Function``,
whose CPU path runs the plain forward and backward) against ``jax.grad``
through the reference's ``ops.wkv6(impl="ref")`` (its chunked form) where
that gradient is finite, log w in U(-2.5, -1e-4); against float64 autograd
through ``ref.wkv6_ref`` over the model's whole clamp, log w in [-4, -1e-4],
where ``jax.grad`` through the reference's ``wkv6_chunked_ref`` gives NaN in
dw (the derivative of k / D_t divides by an underflowed D_t^2) and the port's
gradient is finite; ``gradcheck`` in float64; its bits; bfloat16 within twice
the reference's own bfloat16-against-float32 gap.

The model: ``smoke_variant(rwkv6-7b)`` (4 rwkv layers, d 128, 2 heads of 64)
with the reference's params, the loss and every gradient leaf under remat
"none" and "full", two ``make_train_step`` steps against the reference's
step; the train CLI on the smoke variant through the durable ``Trainer``,
and a bfloat16 copy refused by name at the durable host boundary.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train.steps import make_opt_init as jmake_opt_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as twk
from repro_torch.models import build
from repro_torch.optim import adamw as tadamw
from repro_torch.params import from_numpy_tree
from repro_torch.train import make_opt_init, make_train_step
from repro_torch.train.steps import value_and_grad

ARCH = "rwkv6-7b"
NAMES = ("dr", "dk", "dv", "dw", "du", "dS0")
# float32 both sides: sums in other orders (the reference's autodiff against the analytic
# chunked form), relative L2 of each gradient
GRAD_TOL = 1e-5
# (B, H, T, K, V): a ragged T (two chunks and 5 rows), T of 1, 16 and 17, K != V
WKV_SHAPES = [
    (2, 2, 37, 64, 64),
    (2, 3, 1, 16, 16),
    (1, 2, 16, 64, 64),
    (2, 2, 17, 32, 32),
    (1, 2, 40, 20, 12),
]
WKV_IDS = ["T37", "T1", "T16", "T17", "K20V12"]
# (initial state, gradient of the final state)
STATES = [(False, False), (True, False), (False, True), (True, True)]
STATE_IDS = ["none", "h0", "dsT", "h0_dsT"]
# the model against the reference, float32 both sides: the loss within 1e-4 (absolute), each
# gradient leaf within 1e-3 of its largest entry (tests/test_torch_hybrid_train.py)
LOSS_TOL = 1e-4
GRAD_RTOL = 1e-3
# Params after two steps: every entry within STEP_SHARE of the most AdamW can move it (the sum
# of the learning rates), as tests/test_torch_hybrid_train.py holds the hybrid's, except where
# a step's (clipped) gradient is not 0 but lies within NEAR_ZERO of it, a hundred times AdamW's
# eps (a gradient of exactly 0 leaves an entry where it is in both packages). There its
# update lr g / (|g| + eps) turns a gradient difference of ~1e-7 (a few millionths of the leaf's
# largest entry, as float32 sums in other orders give) into a move of the order of lr, of either
# sign: those entries are held within twice the sum of the learning rates (an update of the
# wrong sign) and their m with every other entry; no more than NEAR_ZERO_SHARE of the params
# may move by more than STEP_SHARE (4 of the smoke model's 1,351,424 do).
STEP_SHARE = 0.05
NEAR_ZERO = 1e-6
NEAR_ZERO_SHARE = 1e-4
SEQ, BATCH = 40, 2  # two chunks and a ragged third
OPT = dict(lr=3e-4, warmup_steps=10, total_steps=3)


# --------------------------------------------------------------------------
# the WKV6 gradient
# --------------------------------------------------------------------------


def _wkv_np(shape, seed, lo, hi, with_h0, with_ds, const=None):
    """r, k, v normal, log w in U(lo, hi) (or ``const``), u, h0, the gradients of the output
    and of the final state, as float32 numpy; w is the decay multiplier exp(log w)."""
    b, h, t, kd, vd = shape
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(b, h, t, kd)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, h, t, vd)).astype(np.float32)
    shape = (b, h, t, kd)
    logw = rng.uniform(lo, hi, size=shape) if const is None else np.full(shape, const)
    w = np.exp(logw).astype(np.float32)
    u = (0.5 * rng.normal(size=(h, kd))).astype(np.float32)
    h0 = rng.normal(size=(b, h, kd, vd)).astype(np.float32) if with_h0 else None
    dout = rng.normal(size=(b, h, t, vd)).astype(np.float32)
    ds = rng.normal(size=(b, h, kd, vd)).astype(np.float32) if with_ds else None
    return r, k, v, w, u, h0, dout, ds


def _on_grid(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def _jax_wkv_grads(fn, r, k, v, w, u, h0, dout, ds, dtype="float32"):
    """jax.grad of sum(out * dout) + sum(S * ds) through ``fn`` (r, k, v, u and the output in
    ``dtype``): (dr, dk, dv, dw, du, dS0 or None) as float32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(r, k, v, w, u, h0):
        out, s = fn(r, k, v, w, u, initial_state=h0)
        total = jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout, jdt).astype(jnp.float32))
        return total + (jnp.sum(s * ds) if ds is not None else 0.0)

    args = [jnp.asarray(x, jdt) for x in (r, k, v)] + [jnp.asarray(w), jnp.asarray(u, jdt)]
    args.append(None if h0 is None else jnp.asarray(h0))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4) if h0 is None else (0, 1, 2, 3, 4, 5))(*args)
    out = [np.asarray(g, np.float32) for g in grads]
    return tuple(out) + ((None,) if h0 is None else ())


def _jax_ops_ref(r, k, v, w, u, initial_state=None):
    return jops.wkv6(r, k, v, w, u, initial_state=initial_state, impl="ref")


def _port_wkv_grads(how, r, k, v, w, u, h0, dout, ds, dtype="float32", impl="auto"):
    """The port's gradients: ``bwd_ref`` calls the plain version, ``autograd`` runs
    ``ops.wkv6(impl)`` under autograd (``WKV6Function`` for "auto")."""
    tdt = getattr(torch, dtype)
    rt, kt, vt, ut = (torch.from_numpy(x).to(tdt) for x in (r, k, v, u))
    wt = torch.from_numpy(w)
    h0t = None if h0 is None else torch.from_numpy(h0)
    dot = torch.from_numpy(dout).to(tdt)
    dst = None if ds is None else torch.from_numpy(ds)
    if how == "bwd_ref":
        grads = tref.wkv6_bwd_ref(rt, kt, vt, wt, ut, dot, initial_state=h0t, ds_last=dst)
        return grads[:5] + (grads[5] if h0 is not None else None,)
    leaves = [x.requires_grad_(True) for x in (rt, kt, vt, wt, ut)]
    if h0t is not None:
        leaves.append(h0t.requires_grad_(True))
    twk.wkv6_bwd.launches = twk.wkv6_chunked.launches = 0
    out, s = tops.wkv6(*leaves[:5], initial_state=h0t, impl=impl)
    if impl == "auto":
        assert "WKV6Function" in type(out.grad_fn).__name__
    outputs, grads_in = (out, s), (dot, dst)
    if dst is None:
        outputs, grads_in = (out,), (dot,)
    grads = torch.autograd.grad(outputs, leaves, grads_in)
    assert twk.wkv6_bwd.launches == twk.wkv6_chunked.launches == 0  # CPU: the plain versions
    return tuple(grads[:5]) + (grads[5] if h0 is not None else None,)


def _rel_l2(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return np.linalg.norm((got - want).ravel()) / max(np.linalg.norm(want.ravel()), 1e-30)


@pytest.mark.parametrize("how", ["bwd_ref", "autograd"])
@pytest.mark.parametrize("state", STATES, ids=STATE_IDS)
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=WKV_IDS)
def test_wkv6_grads_match_jax_grad_where_it_is_finite(shape, state, how):
    """log w in U(-2.5, -1e-4): chunk sums down to -40, above the reference's NaN threshold."""
    args = _wkv_np(shape, 100 + shape[2], -2.5, -1e-4, *state)
    want = _jax_wkv_grads(_jax_ops_ref, *args)
    got = _port_wkv_grads(how, *args)
    assert got[3].dtype == torch.float32
    for name, g, w in zip(NAMES, got, want, strict=True):
        if w is None:
            assert g is None, name
            continue
        assert np.isfinite(w).all(), name
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= GRAD_TOL, (name, _rel_l2(g, w))


def _float64_grads(r, k, v, w, u, h0, dout, ds):
    """Float64 autograd through the port's sequential ``ref.wkv6_ref``."""
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (r, k, v, w, u)]
    if h0 is not None:
        leaves.append(torch.from_numpy(h0).double().requires_grad_(True))
    out, s = tref.wkv6_ref(*leaves[:5], initial_state=leaves[5] if h0 is not None else None)
    assert out.dtype == s.dtype == torch.float64
    loss = (out * torch.from_numpy(dout).double()).sum()
    if ds is not None:
        loss = loss + (s * torch.from_numpy(ds).double()).sum()
    grads = torch.autograd.grad(loss, leaves)
    return tuple(g.numpy() for g in grads) + ((None,) if h0 is None else ())


DEEP = [(-4.0, -1e-4, None), (-4.0, -4.0, -4.0), (-4.0, -3.9, None)]
DEEP_IDS = ["U(-4,-1e-4)", "const-4", "U(-4,-3.9)"]


@pytest.mark.parametrize("how", ["bwd_ref", "autograd"])
@pytest.mark.parametrize("decay", DEEP, ids=DEEP_IDS)
@pytest.mark.parametrize("shape", [(2, 2, 67, 64, 64), (1, 2, 40, 20, 12)], ids=["T67", "K20V12"])
def test_wkv6_grads_match_float64_over_the_whole_clamp(shape, decay, how):
    lo, hi, const = decay
    args = _wkv_np(shape, 7 + shape[2], lo, hi, True, True, const=const)
    want = _float64_grads(*args)
    got = _port_wkv_grads(how, *args)
    for name, g, w in zip(NAMES, got, want, strict=True):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= GRAD_TOL, (name, _rel_l2(g, w))


def test_jax_grad_through_the_references_chunked_form_is_not_finite_there():
    """The reference's fault that the port does not copy: at a constant log w of -2.8 (a chunk
    sum of -44.8) jax.grad through ``wkv6_chunked_ref`` gives a non-finite dw in every row of
    the chunk, and finite ones at -2.7; the port's dw is finite and matches float64 at both."""
    for const, finite in ((-2.7, True), (-2.8, False), (-4.0, False)):
        args = _wkv_np((1, 1, 16, 4, 4), 3, 0, 0, False, False, const=const)
        jgrads = _jax_wkv_grads(jref.wkv6_chunked_ref, *args)
        assert np.isfinite(jgrads[3]).all() == finite, const
        if not finite:
            assert (~np.isfinite(jgrads[3])).any(axis=-1).all(), const  # every row
        assert all(np.isfinite(g).all() for g in jgrads[:3] + jgrads[4:5]), const
        got = _port_wkv_grads("autograd", *args)
        want = _float64_grads(*args)
        assert _rel_l2(got[3], want[3]) <= GRAD_TOL, const


def test_plain_autograd_through_the_ports_chunked_form_keeps_the_references_nan():
    """impl="ref" is plain autograd through ``ref.wkv6_chunked_ref``, as the reference runs:
    at log w = -4 its dw is not finite; impl="auto" (WKV6Function) is finite."""
    args = _wkv_np((1, 2, 32, 64, 64), 9, 0, 0, False, False, const=-4.0)
    plain = _port_wkv_grads("autograd", *args, impl="ref")
    assert not torch.isfinite(plain[3]).all()
    assert all(torch.isfinite(g).all() for g in _port_wkv_grads("autograd", *args)[:5])


class _Float64WKV6(torch.autograd.Function):
    """The sequential WKV in float64 with ``wkv6_bwd_ref`` as its gradient, for gradcheck."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, h0):
        ctx.save_for_backward(r, k, v, w, u, h0)
        return tref.wkv6_ref(r, k, v, w, u, initial_state=h0)

    @staticmethod
    def backward(ctx, dout, ds):
        r, k, v, w, u, h0 = ctx.saved_tensors
        return tref.wkv6_bwd_ref(r, k, v, w, u, dout, initial_state=h0, ds_last=ds)


def test_wkv6_bwd_ref_passes_gradcheck_in_float64():
    args = _wkv_np((1, 2, 19, 4, 3), 5, -4.0, -1e-4, True, False)
    inputs = [torch.from_numpy(x).double().requires_grad_(True) for x in args[:6]]
    assert torch.autograd.gradcheck(_Float64WKV6.apply, inputs, eps=1e-6, atol=1e-7)


def test_wkv6_bwd_cpu_path_bits_twice_and_across_the_batch():
    args = _wkv_np((3, 2, 37, 64, 64), 8, -4.0, -1e-4, True, True)
    first = _port_wkv_grads("autograd", *args)
    again = _port_wkv_grads("autograd", *args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    alone = _port_wkv_grads("autograd", *(x[:1] if x.ndim == 4 else x for x in args))
    for name, a, b in zip(NAMES, first, alone):
        if name != "du":  # du sums over the batch
            assert torch.equal(a[:1], b), name


def test_wkv6_bwd_refuses_mismatched_gradients():
    args = _wkv_np((1, 2, 8, 16, 16), 0, -1.0, -0.1, False, False)
    r, k, v, w, u, _, dout, _ = (None if x is None else torch.from_numpy(x) for x in args)
    with pytest.raises(ValueError, match="dout"):
        twk.wkv6_bwd(r, k, v, w, u, dout.bfloat16())
    with pytest.raises(ValueError, match="ds_last"):
        twk.wkv6_bwd(r, k, v, w, u, dout, ds_last=torch.zeros(1, 2, 16, 15))
    meta = [x.to("meta") for x in (r, k, v, w, u, dout)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        twk.wkv6_bwd(*meta)


@pytest.mark.parametrize("shape", [(2, 2, 37, 64, 64), (1, 2, 40, 20, 12)], ids=["T37", "K20V12"])
def test_bf16_wkv6_grads_within_twice_the_references_gap(shape):
    """bfloat16 r, k, v, u and dout: the wrapper's CPU path against jax.grad through the
    reference's ops.wkv6(impl="ref") in bfloat16, within twice that reference's own gap to its
    float32 run on the same (rounded) inputs, gradient by gradient (max |.|). dw and dS0 are
    float32 on both sides, and the reference's two runs give them the same bits (its chunked
    form takes everything to float32 first): they are held at GRAD_TOL as in float32."""
    args = list(_wkv_np(shape, 21, -2.5, -1e-4, True, True))
    for i in (0, 1, 2, 4, 6):  # r, k, v, u and dout on the bfloat16 grid
        args[i] = _on_grid(args[i], "bfloat16")
    ref16 = _jax_wkv_grads(_jax_ops_ref, *args, dtype="bfloat16")
    ref32 = _jax_wkv_grads(_jax_ops_ref, *args)
    got = _port_wkv_grads("autograd", *args, dtype="bfloat16")
    for name, g, a, b in zip(NAMES, got, ref16, ref32, strict=True):
        assert g.dtype == (torch.float32 if name in ("dw", "dS0") else torch.bfloat16), name
        if name in ("dw", "dS0"):
            assert np.array_equal(a, b) and _rel_l2(g, a) <= GRAD_TOL, (name, _rel_l2(g, a))
            continue
        gap, err = np.abs(a - b).max(), np.abs(g.float().numpy() - a).max()
        print(f"{shape} {name}: |port - ref bf16| {err:.3e}, ref gap {gap:.3e}")
        assert gap > 0, name
        assert err <= 2 * gap, f"{name}: {err} > 2 x {gap}"


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
def _params(seed=0):
    jcfg, _ = _configs()
    jparams, _ = jbuild(jcfg).init(jax.random.key(seed))
    return jparams


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_grad_leaf_match_jax(remat):
    jcfg, tcfg = _configs(remat=remat)
    assert tcfg.d_model == 128 and tcfg.d_model // tcfg.rwkv_head_size == 2
    jparams = _params()
    tokens = _batch(0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens)}
    )
    twk.wkv6_bwd.launches = twk.wkv6_chunked.launches = 0
    (tloss, tmetrics), tgrads = value_and_grad(
        build(tcfg, "cpu").loss_fn,
        from_numpy_tree(_np(jparams), "cpu"),
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
    assert twk.wkv6_bwd.launches == twk.wkv6_chunked.launches == 0


def test_two_train_steps_match_the_references_step():
    """make_train_step twice from the reference's params against the reference's step
    called directly (jitted): each step's metrics within the loss tolerance, AdamW's m
    after them within GRAD_RTOL of each leaf's largest entry, the params within STEP_SHARE
    of the most AdamW can move them."""
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
    jgrad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))
    lr_sum = 0.0
    near_zero = None
    for s in range(2):
        tokens = _batch(s)
        grads = jgrad(jparams, {"tokens": jnp.asarray(tokens)})
        jparams, jstate, jmetrics = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        clip = min(1.0, jopt.clip_norm / float(jmetrics["grad_norm"]))
        small = [
            (g != 0) & (np.abs(g) * clip < NEAR_ZERO)
            for g in (np.asarray(g) for _, g in _leaves(_np(grads)))
        ]
        near_zero = small if near_zero is None else [a | b for a, b in zip(near_zero, small)]
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
    held = total = 0
    for (path, g), (_, w), near in zip(
        _leaves(params), _leaves(_np(jparams)), near_zero, strict=True
    ):
        diff = np.abs(_f32(g) - np.asarray(w))
        assert diff[~near].max(initial=0.0) <= STEP_SHARE * lr_sum, (path, diff.max(), lr_sum)
        assert diff.max() <= 2 * lr_sum + 1e-7, (path, diff.max(), lr_sum)
        held += int((diff > STEP_SHARE * lr_sum).sum())
        total += diff.size
    assert held <= NEAR_ZERO_SHARE * total, (held, total)
    assert int(state["step"]) == 2


# bfloat16 copies of the smoke model: the gradients through WKV6Function and through plain
# autograd (impl="ref") in the same bfloat16 model within this share of the reference's own
# gap between its bfloat16 and float32 runs (max |.| over a leaf); both paths take the WKV6 in
# float32 and round its gradients once, so they differ by a rounding of those gradients
BF16_PATHS_SHARE = 0.25


@functools.lru_cache(maxsize=None)
def _bf16_runs():
    """(reference bfloat16, reference float32 on the same params, port bfloat16 through
    WKV6Function, port bfloat16 with impl="ref") loss and gradient leaves at remat "full", as
    float32 numpy."""
    jcfg, tcfg = _configs(remat="full", param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32", compute_dtype="float32")
    jparams, _ = jbuild(jcfg).init(jax.random.key(1))
    jparams32 = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    tokens = _batch(0)

    def jax_run(cfg, params):
        (loss, _), grads = jax.jit(jax.value_and_grad(jbuild(cfg).loss_fn, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens)}
        )
        return {"loss": _f32(loss), **dict(_leaves(_np(grads)))}

    def port_run(cfg):
        (loss, _), grads = value_and_grad(
            build(cfg, "cpu").loss_fn,
            from_numpy_tree(_np(jparams), "cpu"),
            {"tokens": torch.from_numpy(tokens)},
        )
        for path, g in _leaves(grads):
            assert g.dtype == torch.bfloat16, path
        return {"loss": _f32(loss), **dict(_leaves(grads))}

    plain = port_run(dataclasses.replace(tcfg, attn_impl="ref"))
    return jax_run(jcfg, jparams), jax_run(jcfg32, jparams32), port_run(tcfg), plain


def test_bf16_copy_gradients_through_the_wkv6_function_match_plain_autograd():
    """In bfloat16 the smoke model's loss and gradient leaves through WKV6Function's CPU path
    equal those through plain autograd (impl="ref") within BF16_PATHS_SHARE of the reference's
    own bfloat16-against-float32 gap. Printed with -s beside it: each path against the
    reference's bfloat16 run, in units of that gap. Eager PyTorch rounds each bfloat16 op where
    XLA rounds a fused chain once, and both port paths stand up to ~3.4 gaps from the
    reference's bfloat16 run on some leaves (channel_mix/mu_k, time_mix/wo): a property of the
    bfloat16 model that serving's bits keep, not of the WKV6 gradient."""
    ref, ref32, port, plain = _bf16_runs()
    for key in ref:
        a, b, c, d = (_f32(x[key]) for x in (ref, ref32, port, plain))
        gap = np.abs(a - b).max()
        assert gap > 0, key
        paths = np.abs(c - d).max()
        print(
            f"{key}: |WKV6Function - plain| {paths / gap:.3f} gaps; against the reference's "
            f"bfloat16 run {np.abs(c - a).max() / gap:.2f} and {np.abs(d - a).max() / gap:.2f} "
            f"gaps (gap {gap:.3e})"
        )
        assert paths <= BF16_PATHS_SHARE * gap, f"{key}: {paths} > {BF16_PATHS_SHARE} x {gap}"


def test_cli_trains_the_rwkv_smoke_config_through_the_durable_trainer(tmp_path):
    root = Path(__file__).resolve().parents[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu"]
    cmd += ["--steps", "2", "--checkpoint-every", "2", "--run-dir", str(tmp_path / "run")]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"training {ARCH}-smoke: 4 layers,")
    assert "done: 2 steps" in proc.stdout
    assert (tmp_path / "run" / "summary.json").exists()


def test_bf16_rwkv_is_refused_by_name_at_the_durable_host_boundary(tmp_path):
    """Kept under its name from when the durable host boundary refused bfloat16: a bfloat16
    config (as ``--full`` gives) now trains through the Trainer to its summary, its params
    checkpointed as bfloat16 and its moments as float32."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.train.trainer import TrainConfig, Trainer

    _, tcfg = _configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    tc = TrainConfig(
        run_dir=str(tmp_path / "run"),
        num_steps=1,
        checkpoint_every=1,
        global_batch=BATCH,
        seq_len=SEQ,
        heartbeat=False,
        opt=tadamw.AdamWConfig(**OPT),
    )
    out = Trainer(tcfg, tc, device="cpu").train()
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])
    store = CheckpointStore(str(tmp_path / "run" / "ckpt"))
    dtypes = {e["dtype"] for e in store.manifest("step00000001")["entries"].values()}
    opt_dtypes = {e["dtype"] for e in store.manifest("step00000001-opt")["entries"].values()}
    assert dtypes == {"bfloat16"} and opt_dtypes == {"float32", "int32"}
