"""The port's kernel plain versions and dispatch against the JAX package.

Inputs come from seeded numpy and go through both packages: the torch
``ref.flash_attention_ref`` (the Hopper kernel's plain version) and
``ref.flash_attention_dense_ref`` are held against the JAX dense oracle and
against the Pallas kernel in interpret mode, on every ``FLASH_CASES`` row
of ``tests/test_kernels.py`` and the MLA 48/32 case, at that file's
tolerances, and at head dim 256 (MQA, local window) against the dense
oracle. ``ref.rglru_ref`` (the RG-LRU kernel's plain version) and
``ref.rglru_scan_ref`` are held against ``rglru_ref``, ``rglru_scan_ref``
and the Pallas kernel in interpret mode. The CUDA kernels themselves are
compared with these plain versions on the card by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES, RGLRU_CASES

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rglru import rglru_pallas
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, Hq, Hkv, Sq, Sk, D, causal, window, jnp dtype, Dv)
CASES = [c + (c[5],) for c in FLASH_CASES] + [
    (1, 2, 2, 64, 64, 48, True, None, jnp.float32, 32)  # MLA: key head dim != value head dim
]
IDS = [f"case{i}" for i in range(len(CASES))]
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np_inputs(i):
    b, hq, hkv, sq, sk, d, _, _, _, dv = CASES[i]
    rng = np.random.default_rng(100 + i)
    return (
        rng.normal(size=(b, hq, sq, d)).astype(np.float32),
        rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
        rng.normal(size=(b, hkv, sk, dv)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _jax_outputs(i):
    """(dense oracle, Pallas kernel in interpret mode) for case ``i``, as float32 numpy."""
    _, _, _, _, _, _, causal, window, dtype, _ = CASES[i]
    q, k, v = (jnp.asarray(x, dtype) for x in _np_inputs(i))
    dense = jref.flash_attention_dense_ref(q, k, v, causal=causal, window=window)
    pallas = flash_attention_pallas(q, k, v, causal, window, None, 64, 64, True)
    return np.asarray(dense, np.float32), np.asarray(pallas, np.float32)


def _torch_inputs(i):
    dtype = TORCH_DTYPE[CASES[i][8]]
    return tuple(torch.from_numpy(x).to(dtype) for x in _np_inputs(i))


def _tol(i):
    return 2e-2 if CASES[i][8] == jnp.bfloat16 else 2e-5


@pytest.mark.parametrize("oracle", ["jax_dense", "pallas_interpret"])
@pytest.mark.parametrize("fn", ["ref", "dense_ref"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_torch_flash_plain_matches_jax(i, fn, oracle):
    _, _, _, _, _, _, causal, window, dtype, _ = CASES[i]
    q, k, v = _torch_inputs(i)
    f = tref.flash_attention_ref if fn == "ref" else tref.flash_attention_dense_ref
    got = f(q, k, v, causal=causal, window=window)
    assert got.dtype == TORCH_DTYPE[dtype]
    want = _jax_outputs(i)[0 if oracle == "jax_dense" else 1]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=_tol(i), atol=_tol(i))


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_ops_on_cpu_takes_the_plain_path_and_never_launches(impl):
    i = 1  # GQA case
    _, _, _, _, _, _, causal, window, _, _ = CASES[i]
    q, k, v = _torch_inputs(i)
    before = tfa.flash_attention_fwd.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    assert tfa.flash_attention_fwd.launches == before == 0
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_ops_rejects_unknown_impl():
    q, k, v = _torch_inputs(0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.flash_attention(q, k, v, impl="triton")


@pytest.mark.parametrize(
    "case",
    [
        "head_dim_too_big",
        "hq_not_multiple",
        "causal_sq_gt_sk",
        "dtype_mismatch",
        "float16",
        "non_contiguous",
        "zero_window",
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper's checks run on every device, so the CPU sees what the card would refuse."""
    rnd = functools.partial(torch.randn, dtype=torch.float32)
    q, k, v = rnd(1, 2, 8, 16), rnd(1, 2, 8, 16), rnd(1, 2, 8, 16)
    kwargs = {}
    err = ValueError
    if case == "head_dim_too_big":  # above MAX_HEAD_DIM = 256
        q, k, v = rnd(1, 2, 8, 288), rnd(1, 2, 8, 288), rnd(1, 2, 8, 288)
    elif case == "hq_not_multiple":
        q = rnd(1, 3, 8, 16)
    elif case == "causal_sq_gt_sk":
        q = rnd(1, 2, 9, 16)
    elif case == "dtype_mismatch":
        k, err = k.to(torch.bfloat16), TypeError
    elif case == "float16":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "non_contiguous":
        q = rnd(1, 8, 2, 16).transpose(1, 2)
    else:
        kwargs = {"window": 0}
    with pytest.raises(err):
        tfa.flash_attention_fwd(q, k, v, **kwargs)


def test_non_causal_sq_greater_than_sk_is_accepted():
    """Cross attention (no mask) takes any Sq, as the reference does."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 2, 12, 16)).astype(np.float32)
    k = rng.normal(size=(1, 1, 5, 16)).astype(np.float32)
    v = rng.normal(size=(1, 1, 5, 8)).astype(np.float32)
    got = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = jref.flash_attention_dense_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_not_ported_kernels_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.wkv6()


# ---------------------------------------------------------------------------
# flash attention at head dim 256 (recurrentgemma-9b: MQA, local window)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, D, causal, window)
WIDE_CASES = {
    "mqa_window": (1, 16, 1, 48, 48, 256, True, 16),
    "window_sq_lt_sk": (2, 4, 1, 20, 53, 256, True, 8),
    "ragged_causal": (1, 4, 2, 33, 33, 256, True, None),
    "wide_d_narrow_dv": (1, 2, 1, 17, 17, 200, True, 5),
}


@pytest.mark.parametrize("fn", ["ref", "dense_ref", "wrapper"])
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_torch_flash_plain_at_head_dim_256_matches_jax(name, fn):
    b, hq, hkv, sq, sk, d, causal, window = WIDE_CASES[name]
    dv = 136 if name == "wide_d_narrow_dv" else d
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, dv)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jref.flash_attention_dense_ref(jq, jk, jv, causal=causal, window=window)
    f = {
        "ref": tref.flash_attention_ref,
        "dense_ref": tref.flash_attention_dense_ref,
        "wrapper": tfa.flash_attention_fwd,
    }[fn]
    got = f(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert tfa.flash_attention_fwd.launches == 0


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

# (B, T, W): the shapes of RGLRU_CASES, one decode step, and a W that is no
# multiple of a block or of a warp
RG_SHAPES = [c[:3] for c in RGLRU_CASES] + [(3, 1, 64), (2, 37, 50)]
RG_IDS = [f"b{b}_t{t}_w{w}" for b, t, w in RG_SHAPES]
RG_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rg_np(shape, with_h0):
    b, t, w = shape
    rng = np.random.default_rng(b * 10_000 + t * 100 + w)
    x = rng.normal(size=(b, t, w)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.normal(size=(b, t, w))))).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32) if with_h0 else None
    return x, a, h0


@functools.lru_cache(maxsize=None)
def _rg_jax(shape, with_h0, dtype):
    """JAX (rglru_ref, rglru_scan_ref, Pallas in interpret mode), as float32 numpy."""
    x, a, h0 = _rg_np(shape, with_h0)
    jx, ja = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(a)
    jh0 = None if h0 is None else jnp.asarray(h0)
    outs = (
        jref.rglru_ref(jx, ja, initial_state=jh0),
        jref.rglru_scan_ref(jx, ja, initial_state=jh0),
        rglru_pallas(jx, ja, initial_state=jh0, chunk=32, block_w=64, interpret=True),
    )
    return [(np.asarray(h, np.float32), np.asarray(s, np.float32)) for h, s in outs]


def _rg_torch(shape, with_h0, dtype):
    x, a, h0 = _rg_np(shape, with_h0)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return tx, torch.from_numpy(a), None if h0 is None else torch.from_numpy(h0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["jax_ref", "jax_scan_ref", "pallas_interpret"])
@pytest.mark.parametrize("fn", ["rglru_ref", "rglru_scan_ref"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("shape", RG_SHAPES, ids=RG_IDS)
def test_torch_rglru_plain_matches_jax(shape, with_h0, fn, oracle, dtype):
    x, a, h0 = _rg_torch(shape, with_h0, dtype)
    h, h_last = getattr(tref, fn)(x, a, initial_state=h0)
    assert h.dtype == x.dtype and h_last.dtype == torch.float32
    assert h_last.shape == (shape[0], shape[2])
    want_h, want_last = _rg_jax(shape, with_h0, dtype)[
        ["jax_ref", "jax_scan_ref", "pallas_interpret"].index(oracle)
    ]
    tol = RG_TOL[dtype]
    np.testing.assert_allclose(h.float().numpy(), want_h, rtol=tol, atol=tol)
    np.testing.assert_allclose(h_last.numpy(), want_last, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_rglru_state_chaining_equals_one_shot(impl):
    x, a, _ = _rg_torch((2, 64, 32), False, "float32")
    full, s_full = tops.rglru(x, a, impl=impl)
    o1, s1 = tops.rglru(x[:, :29].contiguous(), a[:, :29].contiguous(), impl=impl)
    o2, s2 = tops.rglru(x[:, 29:].contiguous(), a[:, 29:].contiguous(), initial_state=s1, impl=impl)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), full.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_ops_rglru_on_cpu_takes_the_plain_path_and_never_launches(impl):
    x, a, h0 = _rg_torch((2, 37, 50), True, "float32")
    got, got_last = tops.rglru(x, a, initial_state=h0, impl=impl)
    assert trg.rglru_scan.launches == 0
    want, want_last = tref.rglru_ref(x, a, initial_state=h0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_last.numpy(), want_last.numpy(), rtol=2e-5, atol=2e-5)


def test_ops_rglru_rejects_unknown_impl():
    x, a, _ = _rg_torch((1, 4, 8), False, "float32")
    with pytest.raises(ValueError, match="unknown rglru impl"):
        tops.rglru(x, a, impl="triton")


@pytest.mark.parametrize(
    "case",
    [
        "a_not_float32",
        "x_float16",
        "shape_mismatch",
        "h0_shape",
        "h0_dtype",
        "non_contiguous",
        "empty_t",
    ],
)
def test_rglru_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, a, h0 = torch.randn(2, 5, 8), torch.rand(2, 5, 8), torch.randn(2, 8)
    err = ValueError
    if case == "a_not_float32":
        a, err = a.to(torch.bfloat16), TypeError
    elif case == "x_float16":
        x, err = x.half(), TypeError
    elif case == "shape_mismatch":
        a = torch.rand(2, 5, 9)
    elif case == "h0_shape":
        h0 = torch.randn(2, 9)
    elif case == "h0_dtype":
        h0, err = h0.to(torch.bfloat16), TypeError
    elif case == "non_contiguous":
        x = torch.randn(2, 8, 5).transpose(1, 2)
    else:
        x, a = x[:, :0], a[:, :0]
    with pytest.raises(err):
        trg.rglru_scan(x, a, initial_state=h0)
