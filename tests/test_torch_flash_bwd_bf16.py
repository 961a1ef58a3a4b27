"""The port's bfloat16 flash-attention gradient against the JAX package's.

Inputs and the output's gradient are drawn by seeded numpy, rounded to
bfloat16, and go through both packages. The JAX gradients are ``jax.vjp``
through ``flash_attention_pallas(..., interpret=True)`` in bfloat16: its
custom VJP recomputes the blocked forward in float32 and differentiates it,
returning bfloat16 gradients. On the port's side: the backward wrapper's CPU
path (``ref.flash_attention_bwd_ref`` on the bfloat16 forward's output and
logsumexp) and ``ops.flash_attention`` under autograd
(``FlashAttentionFunction``). Cases: head dims 64 and 128, one that is no
multiple of 8 (the kernel's wrapper pads it), a key head dim other than the
value's, GQA groups 1, 2 and 8, a window, Sq < Sk, no mask; and the edges of
the kernels' tiles (128 owned rows a block, walk tiles of 64 rows): ragged Sq
and Sk with a window crossing tile edges, walks of one tile, Sq = 1, D != Dv
at head dims up to 64 and on either side of 64.

Where the two differ, and by how much. The port's Δ = rowsum(dO∘O) takes the
bfloat16 output the forward saved; the reference's VJP differentiates the
float32 forward, so its Δ is that of the unrounded output. The gap this
leaves is measured here (``test_the_saved_bfloat16_output_moves_the_gradients_
by_a_measured_gap``) and printed, beside a CPU model of the kernel's own
rounding (P and dS in bfloat16 where they enter a product).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv)
CASES = [
    (1, 2, 2, 64, 64, 64, True, None, 64),  # group 1, head dim 64
    (2, 4, 2, 70, 70, 128, True, None, 128),  # group 2, head dim 128, ragged
    (1, 8, 1, 40, 96, 128, True, 24, 128),  # group 8, window, Sq < Sk
    (1, 4, 2, 33, 50, 60, True, None, 60),  # head dim no multiple of 8, Sq < Sk
    (1, 2, 1, 48, 40, 36, False, None, 20),  # no mask, Sq > Sk, D != Dv, neither a multiple of 8
    # edges of the kernels' tiles: 128 owned rows a block, walk tiles of 64 rows
    (1, 4, 2, 150, 200, 128, True, 70, 128),  # ragged Sq, Sk; GQA; a window crossing tile edges
    (1, 2, 2, 64, 64, 128, False, None, 128),  # every walk exactly one tile
    (1, 4, 1, 1, 70, 128, True, None, 128),  # Sq = 1
    (1, 4, 2, 90, 90, 48, True, None, 64),  # D != Dv, both at most 64
    (1, 4, 2, 100, 130, 128, True, None, 64),  # D above 64, Dv at most 64
    (1, 2, 1, 70, 70, 64, True, 30, 96),  # D at most 64, Dv above 64, window
]
IDS = [f"case{i}" for i in range(len(CASES))]
# Both sides compute in float32 and round each gradient to bfloat16 once; they differ by
# the order of float32 sums, which can move a value across a rounding boundary (one unit in
# the last place, 2^-8 of its size), and by the Δ of the saved bfloat16 output (the port)
# against the unrounded one (the reference), measured below at up to 6.3e-3 (1.6 units of
# 2^-8) of each gradient's largest entry. 2^-6 of each gradient's largest entry holds both
# with room; a missing or misplaced term moves a gradient by its own size.
TOL = 2.0**-6


def _np_inputs(i):
    b, hq, hkv, sq, sk, d, _, _, dv = CASES[i]
    rng = np.random.default_rng(700 + i)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))
    # values already on the bfloat16 grid, so both packages start from the same numbers
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float().numpy()
        for s in shapes
    )


def _masks(i):
    return dict(causal=CASES[i][6], window=CASES[i][7])


@functools.lru_cache(maxsize=None)
def _jax_grads(i):
    q, k, v, dout = (jnp.asarray(x, jnp.bfloat16) for x in _np_inputs(i))
    fn = functools.partial(
        flash_attention_pallas, **_masks(i), block_q=64, block_k=64, interpret=True
    )
    out, vjp = jax.vjp(fn, q, k, v)
    assert out.dtype == jnp.bfloat16
    grads = vjp(dout)
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    return tuple(np.asarray(g, np.float32) for g in grads)


def _torch_inputs(i, requires_grad=False):
    return tuple(
        torch.from_numpy(x).bfloat16().requires_grad_(requires_grad and n < 3)
        for n, x in enumerate(_np_inputs(i))
    )


def _port_grads(i, fn):
    if fn == "bwd_wrapper":
        q, k, v, dout = _torch_inputs(i)
        out, lse = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
        return tfa.flash_attention_bwd(q, k, v, out, lse, dout, **_masks(i))
    q, k, v, dout = _torch_inputs(i, requires_grad=True)
    out = tops.flash_attention(q, k, v, **_masks(i))
    assert out.dtype == torch.bfloat16
    return torch.autograd.grad(out, (q, k, v), dout)


def _share(got, want):
    """max |got - want| as a share of TOL times want's largest entry."""
    return np.abs(got - want).max() / (TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("fn", ["bwd_wrapper", "ops_auto"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_bf16_grads_match_jax_vjp(i, fn):
    want = _jax_grads(i)
    tfa.flash_attention_fwd.launches = tfa.flash_attention_bwd.launches = 0
    got = _port_grads(i, fn)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert _share(g.float().numpy(), w) <= 1.0, f"{name}: {_share(g.float().numpy(), w)}"
    assert tfa.flash_attention_fwd.launches == tfa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_bf16_forward_on_the_cpu_returns_the_logsumexp(i):
    """The bfloat16 forward's lse is each row's logsumexp of its scaled, masked logits
    (float32, against float64 over the dense scores), and the output is the same with
    and without it."""
    q, k, v, _ = _torch_inputs(i)
    out, lse = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, tfa.flash_attention_fwd(q, k, v, **_masks(i)))
    b, hq, hkv, sq, sk, d, causal, window, _ = CASES[i]
    kq = k.double().repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kq) * d**-0.5
    qpos = torch.arange(sq)[:, None] + sk - sq
    kpos = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~keep, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.double().numpy(), want.numpy(), rtol=0, atol=1e-5)


def _rounded_bwd_model(q, k, v, out, lse, dout, *, causal, window):
    """The bfloat16 kernels' arithmetic on the CPU: products of bfloat16 operands summed in
    float32, P and dS rounded to bfloat16 where they enter dV, dK and dQ (P kept in float32
    in dS), Δ from the bfloat16 output; the gradients rounded once."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d**-0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, dout))
    kq, vq = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    delta = (dof * of).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kq)
    qpos = torch.arange(sq)[:, None] + sk - sq
    kpos = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), torch.zeros_like(s))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vq) - delta)
    pr, dsr = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kq) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf).reshape(b, hkv, g, sk, d).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof).reshape(b, hkv, g, sk, -1).sum(2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_the_saved_bfloat16_output_moves_the_gradients_by_a_measured_gap(i):
    """The port's Δ takes the saved bfloat16 output, the reference's the unrounded one.
    The plain backward run both ways shows that gap; the kernels' own rounding (a CPU model
    of it) shows the other. Each is printed as its share of TOL and must fit in it."""
    q, k, v, dout = _torch_inputs(i)
    out, lse = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
    out32 = tref.flash_attention_ref(q.float(), k.float(), v.float(), **_masks(i))
    saved = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **_masks(i))
    unrounded = [
        x.bfloat16()
        for x in tref.flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), out32, lse, dout.float(), **_masks(i)
        )
    ]
    model = _rounded_bwd_model(q, k, v, out, lse, dout, **_masks(i))
    for name, a, b, m in zip(("dq", "dk", "dv"), saved, unrounded, model):
        a, b, m = (x.float().numpy() for x in (a, b, m))
        gap, rounding = _share(a, b), _share(m, a)
        print(
            f"{IDS[i]} {name}: Δ of the saved output {100 * gap:.2f}% of TOL "
            f"({np.abs(a - b).max() / np.abs(b).max():.2e} of the largest entry); "
            f"the kernels' rounding {100 * rounding:.2f}% of TOL"
        )
        assert gap <= 1.0 and rounding <= 1.0, name
