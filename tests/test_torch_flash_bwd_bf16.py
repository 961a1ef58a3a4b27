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
at head dims up to 64 and on either side of 64; no mask at head dim 64 and group 1 with
both tails ragged, Sq < Sk and Sq > Sk.

Where the two differ, and by how much. The reference's VJP differentiates the
float32 forward, so its Δ = rowsum(dO∘O) is that of the unrounded output; the
port takes Δ from the forward's output in float32 as well (the third value of
``flash_attention_fwd(return_lse=True)``, saved by ``FlashAttentionFunction``).
The backward wrapper also takes the bfloat16 output: the gap that leaves is
measured here (``test_the_saved_bfloat16_output_moves_the_gradients_
by_a_measured_gap``) and printed, beside a CPU model of the kernel's own
rounding (P and dS in bfloat16 where they enter a product); keys that share a
common component much larger than their spread turn it into an error of dQ
that Δ from the float32 output does not have.
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
    # no mask at head dim 64, group 1 (seamless-m4t-large-v2's encoder and cross-attention),
    # both tails ragged: Sq < Sk and Sq > Sk, walks of several 64-row tiles
    (1, 2, 2, 37, 100, 64, False, None, 64),
    (1, 2, 2, 200, 130, 64, False, None, 64),
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
        out, lse, _ = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
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
    out, lse, _ = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
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


def _rounded_bwd_model(q, k, v, out, lse, dout, *, causal, window, row_sum_step=True):
    """The bfloat16 kernels' arithmetic on the CPU: products of bfloat16 operands summed in
    float32, P and dS rounded to bfloat16 where they enter dV, dK and dQ (P kept in float32
    in dS), Δ from ``out`` as given; dQ less each row's sum of its bfloat16 dS times kbar,
    the mean of the first walked tile's keys of its block of 128 rows, as the dQ kernel
    takes it (without ``row_sum_step``, dQ as the sum of dS K alone); the gradients rounded
    once."""
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
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kq)
    r = dsr.sum(-1, keepdim=True) if row_sum_step else torch.zeros_like(dsr[..., :1])
    for q0 in range(0, sq, 128):
        k_begin = 0 if window is None else max(0, q0 + sk - sq - window + 1) // 64 * 64
        kbar = kq[:, :, k_begin : k_begin + 64].mean(2, keepdim=True)
        dq[:, :, q0 : q0 + 128] -= r[:, :, q0 : q0 + 128] * kbar
    dq = dq * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf).reshape(b, hkv, g, sk, d).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof).reshape(b, hkv, g, sk, -1).sum(2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_the_saved_bfloat16_output_moves_the_gradients_by_a_measured_gap(i):
    """Δ from the bfloat16 output, against the reference's from the unrounded one. The
    plain backward run both ways shows that gap; the kernels' own rounding (a CPU model
    of it, against the plain backward, both on the float32 output the kernels take) shows
    the other. Each is printed as its share of TOL and must fit in it."""
    q, k, v, dout = _torch_inputs(i)
    out, lse, out_f32 = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
    out32 = tref.flash_attention_ref(q.float(), k.float(), v.float(), **_masks(i))
    saved = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **_masks(i))
    unrounded = [
        x.bfloat16()
        for x in tref.flash_attention_bwd_ref(
            q.float(), k.float(), v.float(), out32, lse, dout.float(), **_masks(i)
        )
    ]
    # the kernels' rounding against the plain backward on the output they take, in float32
    model = _rounded_bwd_model(q, k, v, out_f32, lse, dout, **_masks(i))
    plain = tref.flash_attention_bwd_ref(q, k, v, out_f32, lse, dout, **_masks(i))
    for name, a, b, m, c in zip(("dq", "dk", "dv"), saved, unrounded, model, plain):
        a, b, m, c = (x.float().numpy() for x in (a, b, m, c))
        gap, rounding = _share(a, b), _share(m, c)
        print(
            f"{IDS[i]} {name}: Δ of the saved output {100 * gap:.2f}% of TOL "
            f"({np.abs(a - b).max() / np.abs(b).max():.2e} of the largest entry); "
            f"the kernels' rounding {100 * rounding:.2f}% of TOL"
        )
        assert gap <= 1.0 and rounding <= 1.0, name


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_autograd_takes_delta_from_the_float32_output(i):
    """``ops.flash_attention`` under autograd gives the backward wrapper's gradients on the
    forward's float32 output, bit for bit, and that output rounds to the bfloat16 one."""
    q, k, v, dout = _torch_inputs(i)
    out, lse, out_f32 = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
    assert out_f32.dtype == torch.float32 and torch.equal(out_f32.bfloat16(), out)
    assert torch.equal(out, tfa.flash_attention_fwd(q, k, v, **_masks(i)))
    want = tfa.flash_attention_bwd(q, k, v, out_f32, lse, dout, **_masks(i))
    got = _port_grads(i, "ops_auto")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), name


def test_delta_from_the_float32_output_keeps_dq_under_a_common_key_component():
    """Keys that share a component 8 times their spread, values offset by 3: Δ from the
    bfloat16 output leaves each row's dS summing to dO·(O − bf16(O)) instead of zero, and
    dQ = dS·K·scale carries that sum times the common key, 37% of dQ here; from the float32
    output dQ stays within bfloat16's rounding of the float64 gradient, as dK and dV do."""
    rng = np.random.default_rng(11)
    b, h, sq, sk, d = 1, 2, 200, 300, 64

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16()

    q = bf16(rng.normal(size=(b, h, sq, d)))
    k = bf16(8 * rng.normal(size=(1, 1, 1, d)) + rng.normal(size=(b, h, sk, d)))
    v = bf16(3 + rng.normal(size=(b, h, sk, d)))
    dout = bf16(rng.normal(size=(b, h, sq, d)))
    x64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", x64[0], x64[1]) * d**-0.5, dim=-1)
    want = torch.autograd.grad(p @ x64[2], x64, dout.double())
    out, lse, out_f32 = tfa.flash_attention_fwd(q, k, v, causal=False, return_lse=True)

    def rel(o):
        grads = tfa.flash_attention_bwd(q, k, v, o, lse, dout, causal=False)
        return [((g.double() - w).norm() / w.norm()).item() for g, w in zip(grads, want)]

    from_bf16, from_f32 = rel(out), rel(out_f32)
    print(f"dq, dk, dv relative L2 errors: Δ from bf16 O {from_bf16}, from f32 O {from_f32}")
    assert max(from_f32) <= 2.0**-8
    assert from_bf16[0] > 16 * from_f32[0]


def test_the_dq_kernels_row_sum_step_keeps_dq_under_a_common_key_component():
    """The common-key inputs above through the CPU model of the kernels: the forward's output
    summed over P rounded to bfloat16 (as its P.V product takes P), kept in float32, then the
    backward's rounding model. Without the dQ kernel's row-sum step, dQ carries each row's
    sum of bfloat16 dS times the common key (3.6e-2 here, as the card read); with it, every
    gradient stays within 2^-8 of float64 autograd."""
    rng = np.random.default_rng(11)
    b, h, sq, sk, d = 1, 2, 200, 300, 64

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16()

    q = bf16(rng.normal(size=(b, h, sq, d)))
    k = bf16(8 * rng.normal(size=(1, 1, 1, d)) + rng.normal(size=(b, h, sk, d)))
    v = bf16(3 + rng.normal(size=(b, h, sk, d)))
    dout = bf16(rng.normal(size=(b, h, sq, d)))
    x64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", x64[0], x64[1]) * d**-0.5, dim=-1)
    want = torch.autograd.grad(p @ x64[2], x64, dout.double())
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d**-0.5
    m = s.max(-1, keepdim=True).values
    e = torch.exp(s - m)
    total = e.sum(-1, keepdim=True)
    out = (e.bfloat16().float() @ v.float()) / total  # the forward's P.V on bfloat16 P
    lse = (m + torch.log(total)).squeeze(-1)

    def rel(step):
        grads = _rounded_bwd_model(
            q, k, v, out, lse, dout, causal=False, window=None, row_sum_step=step
        )
        return [((g.double() - w).norm() / w.norm()).item() for g, w in zip(grads, want)]

    without, with_step = rel(False), rel(True)
    print(f"dq, dk, dv relative L2 errors: without the row-sum step {without}, with {with_step}")
    assert without[0] > 2.0**-8
    assert max(with_step) <= 2.0**-8
