"""The WKV6 gradient in the Hopper kernels' decomposition, on the CPU.

``csrc/wkv6_bwd.cu`` splits the gradient by what depends on what: walk A
runs the chunk-start states S_c forward, walk B the chunk-end state gradients
dS_c back, and then every chunk's dr, dk, dv, dw and du part comes from its
own rows, S_c and dS_c alone, so the chunks run in any order. Its plain
version ``ref.wkv6_bwd_split_ref`` follows that decomposition (dw summed as
the kernel sums it, du in the kernel's fixed order: runs of chunks, then the
batch). Here it is held against the plain backward ``ref.wkv6_bwd_ref``
(float64 within 1e-10, float32 within 1e-5 of each gradient's largest entry)
with the chunks taken from the last and in a shuffled order (equal bits),
against ``jax.grad`` through the reference's ``ops.wkv6(impl="ref")`` where
that is finite, and against float64 autograd at the deep-decay end of the
model's clamp, where every output stays finite. Then the kernels' tensor-core
rounding: with every product in 3xTF32 (``tests/_tf32.py``; a bfloat16
operand is exact in TF32, so its lo half is zero and the product takes two
passes) the split stays within a tenth of chip_smoke.py's float32 tolerance
of its float32 self, and single-pass TF32 does not.
"""

import random

import numpy as np
import pytest
import torch
from _tf32 import mm_3xtf32, mm_tf32
from test_torch_rwkv_train import (
    GRAD_TOL,
    NAMES,
    _float64_grads,
    _jax_ops_ref,
    _jax_wkv_grads,
    _rel_l2,
    _wkv_np,
)

from repro_torch.kernels import ref as tref

# (initial state, gradient of the final state)
STATES = [(False, False), (True, False), (False, True), (True, True)]
STATE_IDS = ["none", "h0", "dsT", "h0_dsT"]
TS = [17, 64, 300]  # one chunk and a row, four chunks, 18 chunks and 12 rows
# each gradient within this share of its largest entry of the plain backward's
SPLIT_TOL = {"float64": 1e-10, "float32": 1e-5}
# chip_smoke.py's float32 tolerance of the kernel against the plain version (TOL["float32"]),
# of each gradient's largest entry; the tensor-core rounding may take a tenth of it
KERNEL_TOL = 2e-5
MODEL_SHARE = 0.1
SHAPE = (2, 2, 64, 48)  # (B, H, K, V): K != V


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions run hundreds of small ops a call: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(t, state, lo=-2.5, hi=-1e-4, seed=0):
    b, h, kd, vd = SHAPE
    return _wkv_np((b, h, t, kd, vd), seed + t, lo, hi, *state)


def _torch(args, dtype):
    ct = getattr(torch, dtype)
    return [None if x is None else torch.from_numpy(x).to(ct) for x in args]


def _grads(fn, args, **kw):
    r, k, v, w, u, h0, dout, ds = args
    g = fn(r, k, v, w, u, dout, initial_state=h0, ds_last=ds, **kw)
    return g[:5] + (g[5] if h0 is not None else None,)


def _shuffled(t, seed):
    order = list(range(-(-t // 16)))
    random.Random(seed).shuffle(order)
    return order


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("state", STATES, ids=STATE_IDS)
@pytest.mark.parametrize("t", TS, ids=[f"T{t}" for t in TS])
def test_split_matches_the_plain_backward_in_any_chunk_order(t, state, dtype):
    args = _torch(_args(t, state), dtype)
    want = _grads(tref.wkv6_bwd_ref, args)
    back = _grads(tref.wkv6_bwd_split_ref, args)
    shuffled = _grads(tref.wkv6_bwd_split_ref, args, order=_shuffled(t, t))
    for name, g, s, p in zip(NAMES, back, shuffled, want, strict=True):
        if p is None:
            assert g is None and s is None, name
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert torch.equal(g, s), name  # each chunk from its own S_c and dS_c alone
        err = (g - p).abs().max() / p.abs().max()
        assert err <= SPLIT_TOL[dtype], (name, err.item())


@pytest.mark.parametrize("state", STATES, ids=STATE_IDS)
@pytest.mark.parametrize("t", TS, ids=[f"T{t}" for t in TS])
def test_split_matches_jax_grad_where_it_is_finite(t, state):
    """log w in U(-2.5, -1e-4): chunk sums down to -40, above the reference's NaN threshold."""
    args = _args(t, state)
    want = _jax_wkv_grads(_jax_ops_ref, *args)
    got = _grads(tref.wkv6_bwd_split_ref, _torch(args, "float32"))
    for name, g, w in zip(NAMES, got, want, strict=True):
        if w is None:
            assert g is None, name
            continue
        assert np.isfinite(w).all(), name
        assert _rel_l2(g, w) <= GRAD_TOL, (name, _rel_l2(g, w))


def test_split_is_finite_and_matches_float64_at_the_deep_decay_clamp():
    """log w in U(-4, -3.9): chunk sums down to -64, where autodiff through the chunked form's
    k / D_t divides by an underflowed D_t^2."""
    args = _args(300, (True, True), lo=-4.0, hi=-3.9, seed=3)
    want = _float64_grads(*args)
    got = _grads(tref.wkv6_bwd_split_ref, _torch(args, "float32"), order=_shuffled(300, 1))
    for name, g, w in zip(NAMES, got, want, strict=True):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= GRAD_TOL, (name, _rel_l2(g, w))


def _model_shares(matmul, grid):
    """The largest |err| / (KERNEL_TOL x largest entry) of each gradient, the split with every
    tensor-core product through ``matmul`` against the split in float32 products, r, k, v, u
    and dout on the ``grid`` ("bfloat16": the train path's operands; or "float32")."""
    args = _torch(_args(300, (True, True), seed=5), "float32")
    if grid == "bfloat16":
        for i in (0, 1, 2, 4, 6):
            args[i] = args[i].bfloat16().float()
    plain = _grads(tref.wkv6_bwd_split_ref, args)
    model = _grads(tref.wkv6_bwd_split_ref, args, matmul=matmul)
    return [
        ((m - p).abs().max() / (KERNEL_TOL * p.abs().max())).item()
        for m, p in zip(model, plain, strict=True)
    ]


@pytest.mark.parametrize("grid", ["bfloat16", "float32"])
def test_tensor_core_rounding_stays_within_a_tenth_of_the_kernel_tolerance(grid):
    shares = _model_shares(mm_3xtf32, grid)
    print(f"3xTF32 ({grid} operands): shares of the tolerance {[f'{s:.3f}' for s in shares]}")
    assert max(shares) <= MODEL_SHARE, shares


def test_single_pass_tf32_misses_the_kernel_tolerance():
    """Why the float32 side of every product keeps its lo half: one TF32 pass a product moves
    dr, dk and dv by many times the tolerance, though r, k, v and dout are exact in TF32."""
    shares = _model_shares(mm_tf32, "bfloat16")
    assert min(shares[:3]) > 1, shares
