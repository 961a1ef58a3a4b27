"""The port's ``GradCompressor`` against the JAX package's, on the CPU.

The five tests of ``tests/test_compression.py`` on torch tensors, then both
packages on the same numpy inputs: bf16 bit for bit, int8 within one quantum
of its block's scale (the scales equal), and the error-feedback state after
each of 3 rounds to the same bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import GradCompressor as JGradCompressor
from repro_torch.optim.compression import GradCompressor

BLOCK = 256


def _np_grads(seed=0):
    r = np.random.default_rng(seed)
    return {
        "w": (r.normal(size=(64, 32)) * 1e-3).astype(np.float32),
        "b": (r.normal(size=(700,)) * 1e-2).astype(np.float32),
    }


def _grads(seed=0):
    return {k: torch.from_numpy(v) for k, v in _np_grads(seed).items()}


# --------------------------------------------------------------------------
# tests/test_compression.py, mirrored
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_roundtrip_error_bounded(kind):
    comp = GradCompressor(kind)
    g = _grads()
    state = comp.init_state(g)
    q, _ = comp.compress(g, state)
    deq = comp.decompress(q)
    for k in g:
        rel = float((deq[k] - g[k]).abs().max() / torch.clamp(g[k].abs().max(), min=1e-12))
        assert rel < (0.01 if kind == "bf16" else 0.02), (kind, k, rel)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_error_feedback_unbiased_accumulation(kind):
    """Σ_t Q(g+e_t) ≈ Σ_t g — error feedback prevents drift."""
    comp = GradCompressor(kind)
    g = _grads(1)
    state = comp.init_state(g)
    total_q = {k: torch.zeros_like(v) for k, v in g.items()}
    T = 50
    for _ in range(T):
        q, state = comp.compress(g, state)
        deq = comp.decompress(q)
        total_q = {k: total_q[k] + deq[k] for k in g}
    for k in g:
        want = g[k] * T
        got = total_q[k]
        # residual bounded by ONE quantization step, not T of them
        denom = float(want.abs().max())
        assert float((got - want).abs().max()) / denom < 0.02


def test_none_kind_passthrough():
    comp = GradCompressor("none")
    g = _grads()
    q, st = comp.compress(g, comp.init_state(g))
    assert q is g and comp.decompress(q) is g
    assert st is None


def test_bytes_ratio():
    assert GradCompressor("bf16").bytes_ratio() == 0.5
    assert GradCompressor("int8").bytes_ratio() < 0.3
    for kind in ("none", "bf16", "int8"):
        assert GradCompressor(kind).bytes_ratio() == JGradCompressor(kind).bytes_ratio()


def test_int8_ragged_shapes():
    comp = GradCompressor("int8")
    g = {"odd": torch.ones((13, 7), dtype=torch.float32) * 0.5}
    q, _ = comp.compress(g, comp.init_state(g))
    deq = comp.decompress(q)
    np.testing.assert_allclose(deq["odd"].numpy(), 0.5, rtol=0.02)
    assert tuple(deq["odd"].shape) == (13, 7)


# --------------------------------------------------------------------------
# against the reference on the same inputs
# --------------------------------------------------------------------------


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _quantum(scale, n):
    """Each element's int8 quantum: its block's scale, laid out as the flat input."""
    return np.repeat(np.asarray(scale, np.float32).reshape(-1), BLOCK)[:n]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_three_rounds_of_error_feedback_match_the_references(kind):
    """Three rounds on the same gradients and a nested tree: bf16 gives the reference's
    bits in the compressed tree, its decompression and the residual state; int8's scales
    equal the reference's, each code within 1, the decompression and the state within
    one quantum of the element's block."""
    np_grads = {"layer": _np_grads(2), "odd": np.linspace(-1, 1, 91 * 3, dtype=np.float32)}
    np_grads["odd"] = np_grads["odd"].reshape(91, 3)
    tg = {"layer": {k: torch.from_numpy(v) for k, v in np_grads["layer"].items()}}
    tg["odd"] = torch.from_numpy(np_grads["odd"])
    jg = {"layer": {k: jnp.asarray(v) for k, v in np_grads["layer"].items()}}
    jg["odd"] = jnp.asarray(np_grads["odd"])
    tcomp, jcomp = GradCompressor(kind), JGradCompressor(kind)
    tstate, jstate = tcomp.init_state(tg), jcomp.init_state(jg)
    paths = (("layer", "w"), ("layer", "b"), ("odd",))

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    for _ in range(3):
        tq, tstate = tcomp.compress(tg, tstate)
        jq, jstate = jcomp.compress(jg, jstate)
        tdeq, jdeq = tcomp.decompress(tq), jcomp.decompress(jq)
        for path in paths:
            got_q, want_q = at(tq, path), at(jq, path)
            got_d, want_d = at(tdeq, path).numpy(), np.asarray(at(jdeq, path))
            got_e, want_e = at(tstate, path).numpy(), np.asarray(at(jstate, path))
            assert got_d.shape == want_d.shape == at(np_grads, path).shape
            if kind == "bf16":
                assert got_q.dtype == torch.bfloat16
                assert np.array_equal(_bits(got_q), _bits(want_q)), path
                assert np.array_equal(got_d, want_d) and np.array_equal(got_e, want_e), path
                continue
            assert got_q["n"] == want_q["n"] and tuple(got_q["shape"]) == tuple(want_q["shape"])
            assert got_q["q"].dtype == torch.int8
            np.testing.assert_array_equal(got_q["scale"].numpy(), np.asarray(want_q["scale"]))
            codes = got_q["q"].numpy().astype(np.int32) - np.asarray(want_q["q"], np.int32)
            assert np.abs(codes).max() <= 1, path
            quantum = _quantum(want_q["scale"], want_q["n"]).reshape(want_d.shape)
            assert np.all(np.abs(got_d - want_d) <= quantum), path
            assert np.all(np.abs(got_e - want_e) <= quantum), path
