"""Cached-decode attention and the unembed of the PyTorch port against the JAX package.

``ops.decode_attention`` is the port's cached-decode step: on a CPU tensor it
runs ``ref.decode_attention_ref`` (the Hopper kernel's plain version, which
``chip_smoke.py`` holds the kernel to on the card). The reference has no
function of its own for this step: it is the cached-decode branch of
``repro.models.attention.gqa_attention``. With identity projections and no
rotary dims that branch returns the attention of q = x over the cache it was
given plus this step's key and value, so the two are compared directly.
Inputs are drawn with numpy from a seed and handed to both packages.

Tolerances: float32 2e-5 (summation order only: XLA's einsum against torch's
matmul), bfloat16 2e-2 (the output rounded to bfloat16 on both sides; the
kernels' bfloat16 tolerance, tests/test_kernels.py). A CPU model of the
kernel's tensor-core rounding (bf16 products with P in hi/lo halves, 3xTF32
for float32 caches) is held to the same tolerances.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import mm_3xtf32

import repro_torch.configs as tconfigs
from repro.configs import get_config
from repro.models import build as jbuild
from repro.models.attention import gqa_attention as jgqa
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build
from repro_torch.models.model import unembed_logits
from repro_torch.params import from_numpy_tree

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SC, HD = 16, 32
# (name, H, KV): GQA and MQA
HEADS = [("gqa", 4, 2), ("mqa", 4, 1)]
# (name, window, positions of 3 slots): a linear cache with a slot on its last slot
# and one past it (every key valid), and a ring of the window with slots before it
# fills, wrapped once and wrapped twice
CACHES = [("linear", None, (5, 15, 20)), ("ring", SC, (5, 29, 40))]


def _jcfg(h, kv):
    return dataclasses.replace(
        get_config("serpytor-demo-100m"),
        name="decode",
        num_layers=1,
        d_model=h * HD,
        num_heads=h,
        num_kv_heads=kv,
        head_dim=HD,
        rope_fraction=0.0,
    )


def _identity_params(h, kv, dtype):
    """wq = wo = I; wk and wv take the first and the last KV * HD features of x."""
    d = h * HD
    eye = np.eye(d, dtype=np.float32)
    params = {"wq": eye, "wk": eye[:, : kv * HD], "wv": eye[:, d - kv * HD :], "wo": eye}
    return {k: jnp.asarray(v, dtype) for k, v in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache", CACHES, ids=[c[0] for c in CACHES])
@pytest.mark.parametrize("heads", HEADS, ids=[h[0] for h in HEADS])
def test_decode_attention_matches_jax_cached_decode(heads, cache, dtype):
    _, h, kv = heads
    _, window, positions = cache
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(31 + h + kv)
    b = len(positions)
    x = rng.normal(size=(b, 1, h * HD)).astype(np.float32)
    k = rng.normal(size=(b, SC, kv, HD)).astype(np.float32)
    v = rng.normal(size=(b, SC, kv, HD)).astype(np.float32)
    pos = np.array(positions, np.int32)
    jcache = {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt), "pos": jnp.asarray(pos)}
    want, jnew = jgqa(
        jnp.asarray(x, jdt),
        _identity_params(h, kv, jdt),
        _jcfg(h, kv),
        positions=jnp.asarray(pos)[:, None],
        cache=jcache,
        window=window,
    )
    k_cache, v_cache = (torch.from_numpy(np.array(jnew[n], np.float32)).to(tdt) for n in "kv")
    q = torch.from_numpy(x).to(tdt).reshape(b, h, HD)
    got = tops.decode_attention(q, k_cache, v_cache, torch.from_numpy(pos), window=window)
    assert got.shape == (b, h, HD) and got.dtype == tdt
    np.testing.assert_allclose(
        got.float().reshape(b, 1, h * HD).numpy(),
        np.asarray(want, np.float32),
        rtol=TOL[dtype],
        atol=TOL[dtype],
    )


def _tensor_core_decode_model(q, k_cache, v_cache, pos):
    """The decode kernel's arithmetic in float32 torch on the CPU. bfloat16: q.k as exact
    bf16 products summed in float32, P split into bfloat16 hi and lo halves before P.V;
    float32: both products in 3xTF32. Softmax over the valid slots (j <= pos), accurate
    exp, the output rounded to q's dtype."""
    b, h, d = q.shape
    kv = k_cache.shape[2]
    qf = q.float().reshape(b, kv, h // kv, d)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k_cache, v_cache))  # (B, KV, Sc, D)
    bf16 = q.dtype == torch.bfloat16
    s = (qf @ kf.transpose(-1, -2) if bf16 else mm_3xtf32(qf, kf.transpose(-1, -2))) * d**-0.5
    valid = torch.arange(kf.shape[2])[None, :] <= pos[:, None].long()  # (B, Sc)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if bf16:
        p_hi = p.bfloat16().float()
        o = p_hi @ vf + (p - p_hi).bfloat16().float() @ vf
    else:
        o = mm_3xtf32(p, vf)
    return (o / p.sum(-1, keepdim=True)).to(q.dtype).reshape(b, h, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache", CACHES, ids=[c[0] for c in CACHES])
@pytest.mark.parametrize("heads", HEADS + [("g16", 16, 1)], ids=[h[0] for h in HEADS] + ["g16"])
def test_tensor_core_decode_rounding_fits_the_tolerance(heads, cache, dtype):
    """The kernel's tensor-core rounding (P in bf16 hi/lo halves for bfloat16 caches,
    3xTF32 for float32 ones) stays within TOL of the reference's cached decode, on the
    same inputs as test_decode_attention_matches_jax_cached_decode and on 16 heads a KV
    head (all 16 rows of the mma)."""
    _, h, kv = heads
    _, window, positions = cache
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(31 + h + kv)
    b = len(positions)
    x = rng.normal(size=(b, 1, h * HD)).astype(np.float32)
    k = rng.normal(size=(b, SC, kv, HD)).astype(np.float32)
    v = rng.normal(size=(b, SC, kv, HD)).astype(np.float32)
    pos = np.array(positions, np.int32)
    jcache = {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt), "pos": jnp.asarray(pos)}
    want, jnew = jgqa(
        jnp.asarray(x, jdt),
        _identity_params(h, kv, jdt),
        _jcfg(h, kv),
        positions=jnp.asarray(pos)[:, None],
        cache=jcache,
        window=window,
    )
    k_cache, v_cache = (torch.from_numpy(np.array(jnew[n], np.float32)).to(tdt) for n in "kv")
    q = torch.from_numpy(x).to(tdt).reshape(b, h, HD)
    got = _tensor_core_decode_model(q, k_cache, v_cache, torch.from_numpy(pos))
    np.testing.assert_allclose(
        got.float().reshape(b, 1, h * HD).numpy(),
        np.asarray(want, np.float32),
        rtol=TOL[dtype],
        atol=TOL[dtype],
    )


def _decode_inputs(b=3, h=4, kv=2, sc=SC, d=HD, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, d, generator=gen).to(dtype)
    k = torch.randn(b, sc, kv, d, generator=gen).to(dtype)
    v = torch.randn(b, sc, kv, d, generator=gen).to(dtype)
    pos = torch.tensor([5, 29, 40][:b], dtype=torch.int32)
    return q, k, v, pos


@pytest.mark.parametrize("window", [None, SC], ids=["linear", "ring"])
@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_ops_decode_attention_on_cpu_takes_the_plain_path_and_never_launches(impl, window):
    q, k, v, pos = _decode_inputs()
    got = tops.decode_attention(q, k, v, pos, window=window, impl=impl)
    assert tda.decode_attention.launches == 0
    assert torch.equal(got, tref.decode_attention_ref(q, k, v, pos, window=window))


def test_ops_decode_attention_rejects_unknown_impl():
    q, k, v, pos = _decode_inputs()
    with pytest.raises(ValueError, match="unknown decode attention impl"):
        tops.decode_attention(q, k, v, pos, impl="triton")


def test_decode_attention_slot_alone_equals_its_row_in_a_batch():
    """The plain version on the CPU: a slot's output alone and as row 0 of a batch of 3,
    each slot at its own position (the kernel's bit-for-bit form of this is checked by
    ``chip_smoke.py`` on the card)."""
    q, k, v, pos = _decode_inputs(dtype=torch.float32)
    batch = tref.decode_attention_ref(q, k, v, pos, window=SC)
    for i in range(3):
        alone = tref.decode_attention_ref(
            q[i : i + 1], k[i : i + 1], v[i : i + 1], pos[i : i + 1], window=SC
        )
        np.testing.assert_allclose(alone.numpy(), batch[i : i + 1].numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize(
    "case",
    [
        "d_not_multiple_of_8",
        "d_too_big",
        "group_too_big",
        "h_not_multiple_of_kv",
        "float16",
        "dtype_mismatch",
        "pos_int64",
        "pos_shape",
        "cache_strided",
        "window_zero",
        "batch_mismatch",
        "v_shape",
        "cache_too_long",
    ],
)
def test_decode_attention_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks run on every device, so the CPU sees what the card would refuse."""
    q, k, v, pos = _decode_inputs()
    kwargs = {}
    err = ValueError
    if case == "d_not_multiple_of_8":
        q, k, v, pos = _decode_inputs(d=20)
    elif case == "d_too_big":
        q, k, v, pos = _decode_inputs(d=264)
    elif case == "group_too_big":
        q, k, v, pos = _decode_inputs(h=34, kv=2)
    elif case == "h_not_multiple_of_kv":
        q, k, v, pos = _decode_inputs(h=5, kv=2)
    elif case == "float16":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "dtype_mismatch":
        k, err = k.to(torch.bfloat16), TypeError
    elif case == "pos_int64":
        pos, err = pos.long(), TypeError
    elif case == "pos_shape":
        pos, err = pos[:2], TypeError
    elif case == "cache_strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "window_zero":
        kwargs = {"window": 0}
    elif case == "batch_mismatch":
        q = q[:2]
    elif case == "v_shape":
        v = v[:, :, :, :16]
    else:
        sc = tda.MAX_CACHE + 1
        k, v = torch.empty(1, sc, 1, 8), torch.empty(1, sc, 1, 8)
        q, pos = torch.empty(1, 1, 8), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(err):
        tda.decode_attention(q, k, v, pos, **kwargs)


# ---------------------------------------------------------------------------
# the unembed
# ---------------------------------------------------------------------------

NARROW = dict(d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=500)


def _tied(tie):
    jcfg = dataclasses.replace(
        get_config("serpytor-demo-100m"), name="narrow", num_layers=2, tie_embeddings=tie, **NARROW
    )
    tcfg = dataclasses.replace(
        tconfigs.get_config("serpytor-demo-100m"),
        name="narrow",
        num_layers=2,
        tie_embeddings=tie,
        **NARROW,
    )
    return jcfg, tcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_unembed_cpu_path_gives_the_logits_it_gave(tie, dtype):
    """On the CPU both operands go to float32, as before the card's bf16 x bf16 -> f32
    product came in: the same bits as the formula the port used, pad slots at -1e30."""
    _, tcfg = _tied(tie)
    gen = torch.Generator().manual_seed(3)
    tdt = getattr(torch, dtype)
    vpad = 512
    params = {
        "final_norm": {"scale": 1 + 0.1 * torch.randn(64, generator=gen)},
        "embed": {"table": torch.randn(vpad, 64, generator=gen).to(tdt)},
    }
    if not tie:
        params["unembed"] = (0.1 * torch.randn(64, vpad, generator=gen)).to(tdt)
    h = torch.randn(3, 5, 64, generator=gen).to(tdt)
    got = unembed_logits(params, h, tcfg)
    from repro_torch.models.layers import apply_norm

    hn = apply_norm(h, params["final_norm"], tcfg.norm, tcfg.norm_eps)
    w = params["embed"]["table"].float().t() if tie else params["unembed"].float()
    want = torch.matmul(hn.float(), w)
    want[..., tcfg.vocab_size :] = -1e30
    assert got.dtype == torch.float32 and got.shape == (3, 5, vpad)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_prefill_logits_match_jax_with_tied_and_untied_embeddings(tie):
    jcfg, tcfg = _tied(tie)
    jmodel = jbuild(jcfg)
    jparams, _ = jmodel.init(jax.random.key(5))
    assert ("unembed" in jparams) != tie
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(6).integers(0, 500, size=(2, 9)).astype(np.int32)
    want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    got, _ = build(tcfg, device="cpu").prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 500)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :500], rtol=1e-4, atol=1e-4)
