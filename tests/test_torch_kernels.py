"""The port's flash-attention plain versions and dispatch against the JAX package.

Inputs come from seeded numpy and go through both packages: the torch
``ref.flash_attention_ref`` (the Hopper kernel's plain version) and
``ref.flash_attention_dense_ref`` are held against the JAX dense oracle and
against the Pallas kernel in interpret mode, on every ``FLASH_CASES`` row
of ``tests/test_kernels.py`` and the MLA 48/32 case, at that file's
tolerances. The CUDA kernel itself is compared with these plain versions
on the card by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FLASH_CASES

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tfa
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
    if case == "head_dim_too_big":
        q, k, v = rnd(1, 2, 8, 160), rnd(1, 2, 8, 160), rnd(1, 2, 8, 160)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.rglru()
