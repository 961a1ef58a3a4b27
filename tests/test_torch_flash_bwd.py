"""The port's flash-attention backward against the JAX package's gradients.

Inputs and the output's gradient come from seeded numpy and go through both
packages. The JAX gradients are ``jax.vjp`` through ``flash_attention_pallas``
(the Pallas forward in interpret mode and its custom VJP, the blocked
recompute of ``_vjp_bwd``) and ``jax.grad`` of the dense oracle. On the port's
side: ``ops.flash_attention`` under autograd (``FlashAttentionFunction``, which
on a CPU tensor runs the plain forward with its logsumexp and the plain
backward ``ref.flash_attention_bwd_ref``), that plain backward called alone,
and plain autograd through ``impl="ref"`` and ``impl="dense"``. Cases: the
float32 rows of ``FLASH_CASES`` (``tests/test_kernels.py``: causal, GQA, MQA,
non-causal, window, ragged, Sq < Sk), the MLA 48/32 head dims, a window with
Sq < Sk and GQA, and non-causal Sq > Sk. A CPU model of the kernels'
3xTF32 arithmetic is held at the tolerance ``chip_smoke.py`` holds the kernels
to on the card, and two models of weaker arithmetic (one TF32 pass a product;
dV summed over a whole walk in the tensor cores) are shown to exceed it. The
CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import mm_3xtf32, mm_tf32, tf32
from test_kernels import FLASH_CASES

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv)
CASES = [c[:8] + (c[5],) for c in FLASH_CASES if c[8] == jnp.float32] + [
    (1, 2, 2, 64, 64, 48, True, None, 32),  # MLA: key head dim != value head dim
    (2, 6, 2, 50, 130, 32, True, 20, 32),  # window with Sq < Sk, GQA, ragged
    (1, 4, 1, 90, 40, 16, False, None, 24),  # no mask, Sq > Sk (cross attention)
]
IDS = [f"case{i}" for i in range(len(CASES))]
# Float32 on both sides, the same function summed in other orders (XLA against ATen,
# blocks of 128 keys against 512): the gradients agree to ~1e-6 of their size. 1e-4
# (rtol = atol) leaves that room and is ten times tighter than the 1e-3 at which
# tests/test_kernels.py holds the Pallas kernel's gradients.
TOL = 1e-4


def _np_inputs(i):
    b, hq, hkv, sq, sk, d, _, _, dv = CASES[i]
    rng = np.random.default_rng(300 + i)
    return (
        rng.normal(size=(b, hq, sq, d)).astype(np.float32),
        rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
        rng.normal(size=(b, hkv, sk, dv)).astype(np.float32),
        rng.normal(size=(b, hq, sq, dv)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _jax_grads(i, oracle):
    _, _, _, _, _, _, causal, window, _ = CASES[i]
    q, k, v, dout = map(jnp.asarray, _np_inputs(i))
    if oracle == "pallas_vjp":
        fn = functools.partial(
            flash_attention_pallas,
            causal=causal,
            window=window,
            block_q=64,
            block_k=64,
            interpret=True,
        )
    else:
        fn = functools.partial(jref.flash_attention_dense_ref, causal=causal, window=window)
    _, vjp = jax.vjp(fn, q, k, v)
    return tuple(np.asarray(g) for g in vjp(dout))


def _port_grads(i, fn):
    _, _, _, _, _, _, causal, window, _ = CASES[i]
    q, k, v, dout = (torch.from_numpy(x) for x in _np_inputs(i))
    if fn == "bwd_ref":
        out, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
        return tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    impl = {"ops_auto": "auto", "ops_ref": "ref", "ops_dense": "dense"}[fn]
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out = tops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    return torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("oracle", ["pallas_vjp", "dense_grad"])
@pytest.mark.parametrize("fn", ["ops_auto", "bwd_ref", "ops_ref", "ops_dense"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_torch_flash_grads_match_jax(i, fn, oracle):
    tfa.flash_attention_bwd.launches = 0
    got = _port_grads(i, fn)
    want = _jax_grads(i, oracle)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=TOL, atol=TOL, err_msg=name)
    assert tfa.flash_attention_bwd.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_forward_lse_is_the_logsumexp_and_leaves_the_output_as_it_was(i):
    """The forward's plain version with ``return_lse`` gives the same output bit for bit,
    and an lse equal to the logsumexp of the dense oracle's masked, scaled logits."""
    _, hq, hkv, sq, sk, d, causal, window, _ = CASES[i]
    q, k, v, _ = _np_inputs(i)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse, out_f32 = tfa.flash_attention_fwd(
        tq, tk, tv, causal=causal, window=window, return_lse=True
    )
    assert out_f32 is out
    plain = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(out, plain) and lse.dtype == torch.float32
    kx = np.repeat(k, hq // hkv, axis=1)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kx) * d**-0.5
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    valid = np.ones((sq, sk), bool)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    logits = np.where(valid, logits, -np.inf)
    top = logits.max(-1, keepdims=True)
    want = (top + np.log(np.exp(logits - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=2e-5, atol=2e-5)


def _bwd_model(q, k, v, out, lse, dout, *, causal, window, block_k=tfa.BWD_WALK, mm=mm_3xtf32):
    """The backward kernels' arithmetic in float32 torch on the CPU: the five products by
    ``mm`` (3xTF32 as the kernels: hi/lo halves, lo*lo dropped), P = exp(S scale - lse) with
    accurate exp, over key tiles of ``block_k`` (the kernels' walk tile)."""
    g = q.shape[1] // k.shape[1]
    kf, vf = (x.repeat_interleave(g, dim=1) for x in (k, v))
    sq, sk = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    delta = (dout * out).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for k0 in range(0, sk, block_k):
        kb, vb = kf[:, :, k0 : k0 + block_k], vf[:, :, k0 : k0 + block_k]
        kpos = torch.arange(k0, k0 + kb.shape[2])[None, :]
        valid = torch.ones(sq, kb.shape[2], dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        s = mm(q, kb.transpose(-1, -2))
        p = torch.where(valid, torch.exp(s * scale - lse[..., None]), torch.zeros_like(s))
        ds = p * (mm(dout, vb.transpose(-1, -2)) - delta)
        dq += mm(ds, kb)
        dk[:, :, k0 : k0 + block_k] = mm(ds.transpose(-1, -2), q)
        dv[:, :, k0 : k0 + block_k] = mm(p.transpose(-1, -2), dout)
    b, hkv = k.shape[:2]
    dk = dk.reshape(b, hkv, g, sk, -1).sum(2)
    dv = dv.reshape(b, hkv, g, sk, -1).sum(2)
    return dq * scale, dk * scale, dv


# chip_smoke.py's tolerance (BWD_TOL) for the kernels against the plain backward (rtol =
# atol): ten times tighter than the 1e-3 of tests/test_kernels.py's gradient check, so that
# the weaker arithmetic of the two tests after the next one fails it
KERNEL_TOL = 1e-4
MODEL_CASES = {
    **{f"case{i}": c for i, c in enumerate(CASES)},
    "demo_train_heads": (1, 12, 4, 300, 300, 64, True, None, 64),
    "head_dim_128": (1, 2, 1, 200, 200, 128, True, None, 128),
}


def _model_share_of_tolerance(name, mm):
    """The largest share of KERNEL_TOL that ``_bwd_model`` with ``mm`` uses on a case, per
    gradient: the dense oracle's float64 gradients are the yardstick, so the model's own
    error is what is measured."""
    b, hq, hkv, sq, sk, d, causal, window, dv = MODEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, dout = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))
    )
    out, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    got = _bwd_model(q, k, v, out, lse, dout, causal=causal, window=window, mm=mm)
    q64, k64, v64 = (x.double().requires_grad_(True) for x in (q, k, v))
    o64 = tref.flash_attention_dense_ref(q64, k64, v64, causal=causal, window=window)
    want = torch.autograd.grad(o64, (q64, k64, v64), dout.double())
    return {
        name_: ((g.double() - w).abs() / (KERNEL_TOL * (1 + w.abs()))).max().item()
        for name_, g, w in zip(("dq", "dk", "dv"), got, want, strict=True)
    }


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_3xtf32_backward_rounding_fits_the_kernel_tolerance(name):
    """The kernels' 3xTF32 products keep the gradients within a tenth of the tolerance
    they are held to on the card."""
    for name_, used in _model_share_of_tolerance(name, mm_3xtf32).items():
        assert used < 0.1, (name_, used)


def test_single_pass_tf32_backward_exceeds_the_kernel_tolerance():
    """The companion of the test above: one TF32 pass a product fails the tolerance."""
    used = _model_share_of_tolerance("demo_train_heads", mm_tf32)
    assert max(used.values()) > 1, used


def _round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 to float32, rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _walk_sum_model(x, b, tile):
    """x.T @ b summed over the rows of a walk as the dK/dV kernels sum them: each
    tensor-core product (a wgmma m64nNk8 on the wgmma path, an mma.sync m16n8k8 on the
    mma.sync path) adds the products of 8 rows to its float32 accumulator three times (lo
    hi, hi lo, hi hi); the model takes each product's exact sum of products added to the
    accumulator, rounded once toward zero (the tensor cores' float32 sums do not round to
    nearest; this is kinder than truncating each addend). ``tile``: the rows summed from
    zero in the tensor cores before a float32 add to nearest into the running sum; None
    sums the whole walk in the tensor cores."""
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    xh, bh = tf32(xt), tf32(bt)
    xl, bl = tf32(xt - xh), tf32(bt - bh)
    passes = [(u.double().numpy(), w.double().numpy()) for u, w in ((xl, bh), (xh, bl), (xh, bh))]
    acc = np.zeros((x.shape[1], b.shape[1]), np.float32)
    t = np.zeros_like(acc)
    for r0 in range(0, x.shape[0], 8):
        for xs, bs in passes:
            t = _round_toward_zero(t.astype(np.float64) + xs[r0 : r0 + 8].T @ bs[r0 : r0 + 8])
        if tile is not None and (r0 + 8) % tile == 0:
            acc, t = acc + t, np.zeros_like(acc)
    return acc + t


@pytest.mark.parametrize(
    "tile, fits", [(tfa.BWD_WALK, True), (None, False)], ids=["tile", "whole_walk"]
)
def test_dv_summed_over_a_whole_walk_in_the_tensor_cores_exceeds_the_kernel_tolerance(
    tile, fits
):
    """dV of the first 64 keys at the demo's train shape (3 query heads a KV head, 4096
    rows each, causal: a walk of 12,288 rows) on seeded N(0, 1) inputs. Summed from zero
    a walk tile (the kernels' ``BWD_WALK`` rows) and then added in float32, it keeps within
    a tenth of the tolerance; summed over the whole walk in the tensor cores, it fails it."""
    rng = np.random.default_rng(18)
    g, s, d = 3, 4096, 64
    q = torch.from_numpy(rng.normal(size=(g, s, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32))
    dout = rng.normal(size=(g * s, d)).astype(np.float32)
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    p = []
    for h in range(g):  # the walk's order: each head's rows in turn
        logits = (q[h] @ k.T * d**-0.5).masked_fill(~causal, float("-inf"))
        p.append(torch.exp(logits[:, :64] - torch.logsumexp(logits, -1, keepdim=True)).numpy())
    p = np.concatenate(p)
    want = p.astype(np.float64).T @ dout.astype(np.float64)
    got = _walk_sum_model(p, dout, tile)
    used = (np.abs(got - want) / (KERNEL_TOL * (1 + np.abs(want)))).max()
    assert (used < 0.1) if fits else (used > 1), used


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_function_on_cpu_runs_the_plain_versions_and_launches_nothing(impl):
    q, k, v, dout = (torch.from_numpy(x) for x in _np_inputs(1))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    out = tops.flash_attention(q, k, v, impl=impl)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(dout)
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0


def test_no_grad_takes_the_forward_alone():
    """Serving (no input needs a gradient) calls the forward as before: no Function node."""
    q, k, v, _ = (torch.from_numpy(x) for x in _np_inputs(0))
    out = tops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, tref.flash_attention_ref(q, k, v))


@pytest.mark.parametrize(
    "d, dv, dtype, path",
    [
        (64, 64, torch.float32, "wgmma"),  # the demo's training
        (48, 32, torch.float32, "wgmma"),
        (16, 24, torch.float32, "wgmma"),
        (4, 4, torch.float32, "wgmma"),
        (65, 64, torch.float32, "mma.sync"),  # above the wgmma tiles' 64 columns
        (64, 128, torch.float32, "mma.sync"),
        (128, 128, torch.float32, "mma.sync"),
        # no multiple of 4: a TMA row stride is a multiple of 16 bytes
        (30, 18, torch.float32, "mma.sync"),
        (64, 62, torch.float32, "mma.sync"),
        # bfloat16: one pair of kernels at every head dim up to 128 (the wrapper pads those
        # that are no multiple of 8)
        (128, 128, torch.bfloat16, "bf16"),  # qwen3-1.7b's training
        (64, 64, torch.bfloat16, "bf16"),
        (60, 36, torch.bfloat16, "bf16"),
    ],
)
def test_backward_path_is_a_function_of_the_head_dims(d, dv, dtype, path):
    assert tfa.bwd_path(d, dv, dtype) == path
    if dtype == torch.float32:
        assert tfa.bwd_path(d, dv) == path  # float32 is the default


def test_head_dims_above_128_are_refused_with_grad_on_every_device():
    q, k, v = (torch.randn(1, 2, 8, 136, requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 4"):
        tops.flash_attention(q, k, v)
    out = tops.flash_attention(q.detach(), k.detach(), v.detach())  # the forward takes them
    assert out.shape == (1, 2, 8, 136)


def test_bfloat16_with_grad_is_refused_off_the_cpu():
    """Off the CPU a bfloat16 input that needs a gradient goes to the kernels, as float32
    does: on the ``meta`` device, which has none, the forward of ``FlashAttentionFunction``
    raises "no kernel for device" before anything runs, with no quiet fall back to the
    plain versions. The backward wrapper does the same."""
    q, k, v = (
        torch.empty(1, 2, 8, 64, dtype=torch.bfloat16, device="meta", requires_grad=True)
        for _ in range(3)
    )
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.flash_attention(q, k, v)
    out, dout = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), out, lse, dout)


def test_backward_wrapper_refuses_mismatched_saved_tensors():
    q, k, v, dout = (torch.from_numpy(x) for x in _np_inputs(0))
    out, lse = tref.flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="do not fit"):
        tfa.flash_attention_bwd(q, k, v, out, lse[..., :-1], dout)
