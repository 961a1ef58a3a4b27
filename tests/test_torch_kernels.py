"""The port's kernel plain versions and dispatch against the JAX package.

Inputs come from seeded numpy and go through both packages: the torch
``ref.flash_attention_ref`` (the Hopper kernel's plain version) and
``ref.flash_attention_dense_ref`` are held against the JAX dense oracle and
against the Pallas kernel in interpret mode, on every ``FLASH_CASES`` row
of ``tests/test_kernels.py`` and the MLA 48/32 case, at that file's
tolerances, and at head dim 256 (MQA, local window) against the dense
oracle. ``ref.rglru_ref`` (the RG-LRU kernel's plain version) and
``ref.rglru_scan_ref`` are held against ``rglru_ref``, ``rglru_scan_ref``
and the Pallas kernel in interpret mode. ``ref.wkv6_ref`` and
``ref.wkv6_chunked_ref`` (the WKV6 kernel's plain version) are held against
the JAX ``wkv6_ref``, ``wkv6_chunked_ref`` and the Pallas kernel in
interpret mode on ``WKV_CASES`` at that file's 2e-4. CPU models of the flash
kernel's arithmetic (bfloat16 on wgmma; float32 in 3xTF32, ``_tf32.py``) are
held against the JAX dense oracle at the kernel tolerances, and its float32
split plan is checked to depend on the shapes alone. The CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import mm_3xtf32, mm_tf32, tf32
from test_kernels import FLASH_CASES, RGLRU_CASES, WKV_CASES

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rglru import rglru_pallas
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import wkv6 as twkv
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
    """Every Pallas kernel has a counterpart now (WKV6 was the last), and every layer kind
    is ported: the encoder-decoder kinds keep the reference's caches (``enc`` a dense
    layer's, ``xattn`` its self-attention's under ``self`` beside the cross keys and
    values at the source's length). The MoE kind (``models/moe.py``) keeps the attention
    cache of a dense one."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models.transformer import init_layer_cache as jinit_layer_cache
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_layer_cache

    cfg = get_config("serpytor-demo-100m")
    jcfg = jget_config("serpytor-demo-100m")
    for kind in ("enc", "xattn"):
        got = init_layer_cache(cfg, kind, 2, 8, torch.float32, "cpu", src_len=5)
        want = jinit_layer_cache(jcfg, kind, 2, 8, jnp.float32, src_len=5)
        shapes = jax.tree_util.tree_leaves_with_path(want)
        for path, leaf in shapes:
            node = got
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape and not node.any(), (kind, path)
        assert len(shapes) == (5 if kind == "xattn" else 3)
    moe = init_layer_cache(cfg, "moe", 1, 8, torch.float32, "cpu")
    dense = init_layer_cache(cfg, "dense", 1, 8, torch.float32, "cpu")
    assert {k: v.shape for k, v in moe.items()} == {k: v.shape for k, v in dense.items()}
    r = torch.zeros(1, 1, 1, 4)
    out, state = tops.wkv6(r, r, r, torch.ones(1, 1, 1, 4), torch.zeros(1, 4))
    assert out.shape == (1, 1, 1, 4) and state.shape == (1, 1, 4, 4)


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
# the bfloat16 path of the flash kernel (wgmma): its rounding, and its head-dim pad
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _wgmma_path_model(q, k, v, *, causal, window, scale, block_k=64):
    """What the kernel's bfloat16 path computes, in float32 torch on the CPU: q, k, v
    in bfloat16; scores in float32 (in the log2 domain); online softmax over key
    tiles of 64 with the running sum in float32; P rounded to bfloat16 before P.V,
    summed in float32; the output divided by the clamped sum and rounded to bfloat16."""
    g = q.shape[1] // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full(q.shape[:3] + (1,), -1e30)
    denom = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for k0 in range(0, sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, sk))[None, :]
        s = qf @ kf[:, :, k0 : k0 + block_k].transpose(-1, -2) * (scale * LOG2E)
        valid = torch.ones(sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        denom = denom * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0 : k0 + block_k]
        m = m_new
    return (acc / denom.clamp_min(1e-37)).bfloat16()


# WIDE_CASES and head dims 64 and 128, in bfloat16: (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv)
WGMMA_MODEL_CASES = {
    **{n: c + (136 if n == "wide_d_narrow_dv" else c[5],) for n, c in WIDE_CASES.items()},
    "head_dim_64_gqa": (2, 4, 2, 100, 100, 64, True, None, 64),
    "head_dim_128_window_sq_lt_sk": (1, 2, 1, 70, 150, 128, True, 32, 128),
}


@pytest.mark.parametrize("name", sorted(WGMMA_MODEL_CASES))
def test_wgmma_path_rounding_fits_the_bf16_tolerance(name):
    """Rounding P to bfloat16 before P.V (the JAX kernel keeps it in float32) stays
    within the bfloat16 tolerance of the JAX dense oracle, 2e-2 (tests/test_kernels.py)."""
    b, hq, hkv, sq, sk, d, causal, window, dv = WGMMA_MODEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, dv)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jref.flash_attention_dense_ref(jq, jk, jv, causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = _wgmma_path_model(tq, tk, tv, causal=causal, window=window, scale=d**-0.5)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2
    )


# ---------------------------------------------------------------------------
# the float32 path of the flash kernel (mma.sync in 3xTF32): its rounding, its split plan
# ---------------------------------------------------------------------------


def _tensor_core_f32_model(q, k, v, *, causal, window, mm, block_k=64):
    """The float32 kernel's arithmetic in float32 torch on the CPU: both products through
    ``mm``, online softmax over key tiles of 64 with accurate exp in float32, the output
    divided by the clamped sum."""
    g = q.shape[1] // k.shape[1]
    kf, vf = (x.repeat_interleave(g, dim=1) for x in (k, v))
    sq, sk = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full(q.shape[:3] + (1,), -1e30)
    denom = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for k0 in range(0, sk, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, sk))[None, :]
        s = mm(q, kf[:, :, k0 : k0 + block_k].transpose(-1, -2)) * scale
        valid = torch.ones(sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        denom = denom * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vf[:, :, k0 : k0 + block_k])
        m = m_new
    return acc / denom.clamp_min(1e-37)


# float32 rows of FLASH_CASES and the MLA 48/32 case (CASES), the demo's prefill and a head
# dim of 256 with a window: (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv)
TF32_MODEL_CASES = {
    **{f"case{i}": c[:8] + c[9:] for i, c in enumerate(CASES) if c[8] == jnp.float32},
    "demo_prefill": (1, 12, 4, 777, 777, 64, True, None, 64),
    "head_dim_256_window": (1, 4, 1, 300, 300, 256, True, 96, 256),
}


def _tf32_model_inputs(name):
    b, hq, hkv, sq, sk, d, causal, window, dv = TF32_MODEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 2)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, dv)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jref.flash_attention_dense_ref(jq, jk, jv, causal=causal, window=window)
    return [torch.from_numpy(x) for x in (q, k, v)], np.asarray(want), causal, window


@pytest.mark.parametrize("name", sorted(TF32_MODEL_CASES))
def test_3xtf32_path_rounding_fits_the_f32_tolerance(name):
    """Both products in 3xTF32 (hi/lo halves, the lo*lo term dropped) stay within the
    float32 tolerance of the JAX dense oracle, 2e-5 (tests/test_kernels.py)."""
    (q, k, v), want, causal, window = _tf32_model_inputs(name)
    got = _tensor_core_f32_model(q, k, v, causal=causal, window=window, mm=mm_3xtf32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_single_pass_tf32_exceeds_the_f32_tolerance():
    """The companion of the test above: one TF32 pass a product (about three decimal
    digits) does not fit 2e-5 at the demo's prefill shape, so the float32 path needs
    the split."""
    (q, k, v), want, causal, window = _tf32_model_inputs("demo_prefill")
    got = _tensor_core_f32_model(q, k, v, causal=causal, window=window, mm=mm_tf32)
    diff = np.abs(got.numpy() - want)
    assert (diff > 2e-5 * (1 + np.abs(want))).any(), diff.max()


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    """The model's rounding on hand-picked bits: below, at and above the half of the
    dropped 13 bits, for both signs."""
    x = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0xBF801000 - 2**32], dtype=torch.int32)
    got = tf32(x.view(torch.float32)).view(torch.int32).tolist()
    assert got == [0x3F800000, 0x3F802000, 0x3F802000, 0xBF802000 - 2**32]


@pytest.mark.parametrize(
    "sq, sk, causal, window, d, dv",
    [
        (128, 128, True, None, 64, 64),
        (777, 777, True, None, 64, 64),
        (2048, 2048, True, None, 64, 64),
        (3000, 3000, True, 2048, 256, 256),
        (1000, 3000, True, 2048, 256, 256),
        (1, 513, True, None, 64, 64),
        (700, 700, True, None, 18, 13),
        (1500, 1500, False, None, 64, 32),
    ],
)
def test_f32_split_plan_is_a_function_of_the_shapes_alone(sq, sk, causal, window, d, dv):
    """The float32 kernel's split plan depends on (Sq, Sk, the masks, D, Dv) and nothing
    else, so a row's reduction order is the same at any batch, head count or card; it
    cuts a walk only where a (batch, head) has fewer than F32_SPLIT_TARGET query tiles,
    into at most F32_MAX_PIECES pieces of at least F32_MIN_PIECE_TILES key tiles."""
    import inspect

    assert list(inspect.signature(tfa.f32_plan).parameters) == [
        "sq",
        "sk",
        "causal",
        "window",
        "d",
        "dv",
    ]
    split, n_items = tfa.f32_plan(sq, sk, causal, window, d, dv)
    tiles = tfa._f32_key_tiles(sq, sk, causal, window or 0, tfa.f32_key_block(d, dv))
    assert len(tiles) == -(-sq // tfa.F32_BLOCK_Q) and min(tiles) >= 1
    pieces = [-(-n // split) for n in tiles]
    assert n_items == sum(pieces) and max(pieces) <= tfa.F32_MAX_PIECES
    if len(tiles) >= tfa.F32_SPLIT_TARGET:
        assert n_items == len(tiles)  # enough query tiles: no walk is cut
    elif max(pieces) > 1:
        assert split >= tfa.F32_MIN_PIECE_TILES
    if (sq, d) == (777, 64):  # the demo's prefill: 13 query tiles, walks cut in 2 tiles
        assert (split, n_items) == (2, 49)


@pytest.mark.parametrize("d, dv", [(20, 12), (64, 40), (64, 64)])
def test_pad_head_dims_leaves_attention_unchanged(d, dv):
    """The wgmma path pads D and Dv to multiples of 8 with zeros: zero q and k columns
    leave the scores as they were, zero v columns are cut from the output, and the
    scale stays the unpadded D's. Shapes that need no pad come back as they are."""
    rng = np.random.default_rng(d * 1000 + dv)
    q = torch.from_numpy(rng.normal(size=(1, 4, 33, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 33, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 33, dv)).astype(np.float32))
    pq, pk, pv = tfa._pad_head_dims(q, k, v)
    assert pq.shape[-1] == pk.shape[-1] == -(-d // 8) * 8 and pv.shape[-1] == -(-dv // 8) * 8
    assert (pq is q) == (d % 8 == 0) and (pv is v) == (dv % 8 == 0)
    got = tref.flash_attention_ref(pq, pk, pv, causal=True, window=7, scale=d**-0.5)[..., :dv]
    want = tref.flash_attention_ref(q, k, v, causal=True, window=7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


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


@pytest.mark.parametrize("t", [1, 2, trg.STEP_MAX_T, trg.STEP_MAX_T + 1, 64, 65, 3000])
def test_rglru_launch_shape_is_a_function_of_t_and_w_alone(t):
    """The wrapper picks the step or the ring kernel by T and nothing else, and the ring
    kernel's channel grouping (16 a block, W padded to a multiple of 8) depends on W
    alone: the path code and the operands' width that ``_plan`` hands the C entry point
    are the same for every B; decode's T = 1 takes the step kernel."""
    import inspect

    assert list(inspect.signature(trg.path_for).parameters) == ["t"]
    assert trg.path_for(1) == "step" and trg.RING_CHANNELS == 16
    want = "step" if t <= trg.STEP_MAX_T else "ring"
    assert trg.path_for(t) == want
    for w in (4096, 1000, 50):
        width = w + (-w) % 8 if want == "ring" else w
        for b in (1, 4, 3):
            x, a, h0 = torch.zeros(b, t, w), torch.zeros(b, t, w), torch.zeros(b, w)
            code, x2, a2, h02 = trg._plan(x, a, h0)
            assert code == trg._C_PATH[want]
            assert x2.shape == a2.shape == (b, t, width) and h02.shape == (b, width)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_rglru_channel_padding_leaves_the_scan_unchanged(with_h0):
    """The ring kernel's operands padded along W with zeros (a = 0, x = 0 keep h = 0
    there) give the first W channels' bits unchanged: the plain version on both."""
    x, a, h0 = _rg_torch((2, 37, 50), with_h0, "bfloat16")
    code, xp, ap, h0p = trg._plan(x, a, h0)
    assert code == trg._C_PATH["ring"] and xp.shape[2] == 56
    assert not xp[..., 50:].any() and not ap[..., 50:].any()
    want, want_last = tref.rglru_ref(x, a, initial_state=h0)
    got, got_last = tref.rglru_ref(xp, ap, initial_state=h0p)
    assert torch.equal(got[..., :50], want) and torch.equal(got_last[:, :50], want_last)
    assert not got[..., 50:].any() and not got_last[:, 50:].any()


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

# (B, H, T, K, V, with_state): WKV_CASES of tests/test_kernels.py (chunk 16), a
# ragged T, one decode step, and a chunk shorter than 16; then the Hopper kernels'
# edges: T around one and two chunks, K != V with widths that are no multiple of 8,
# and the decode batch of 4 slots at T = 1
WKV_SHAPES = [c[:5] + (c[6],) for c in WKV_CASES] + [
    (1, 2, 21, 16, 16, True),
    (3, 2, 1, 64, 64, True),
    (2, 1, 7, 32, 16, False),
    (1, 2, 15, 64, 64, True),
    (1, 2, 16, 64, 64, True),
    (2, 2, 17, 64, 64, True),
    (1, 2, 33, 64, 64, False),
    (2, 2, 50, 20, 12, True),
    (4, 2, 1, 64, 64, True),
]
WKV_IDS = [f"b{b}_h{h}_t{t}_k{k}_v{v}_{'s0' if s else 'zeros'}" for b, h, t, k, v, s in WKV_SHAPES]
WKV_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py:128; bf16 as rglru


def _wkv_np(shape, seed=0):
    """r, k, v, w, u, s0 as float32 numpy; log w within the model's clamp [-4, -1e-4]."""
    b, h, t, kd, vd, with_state = shape
    rng = np.random.default_rng(seed + b * 1000 + h * 100 + t * 10 + kd + vd)
    r, k = rng.normal(size=(b, h, t, kd)), rng.normal(size=(b, h, t, kd))
    v = rng.normal(size=(b, h, t, vd))
    logw = -np.minimum(np.exp(rng.normal(size=(b, h, t, kd))), 4.0)
    w = np.exp(np.minimum(logw, -1e-4))
    u = rng.normal(size=(h, kd))
    s0 = rng.normal(size=(b, h, kd, vd)) if with_state else None
    return tuple(None if x is None else x.astype(np.float32) for x in (r, k, v, w, u, s0))


@functools.lru_cache(maxsize=None)
def _wkv_jax(shape, dtype):
    """JAX (wkv6_ref, wkv6_chunked_ref, Pallas in interpret mode), as float32 numpy.
    The chunked two go through the reference's ``ops.wkv6``, which pads T to the
    chunk and, on a CPU backend, runs ``wkv6_pallas(interpret=True)`` for "pallas"."""
    r, k, v, w, u, s0 = _wkv_np(shape)
    jdt = getattr(jnp, dtype)
    jr, jk, jv = (jnp.asarray(x, jdt) for x in (r, k, v))
    jw, ju = jnp.asarray(w), jnp.asarray(u, jdt)
    js0 = None if s0 is None else jnp.asarray(s0)
    outs = (
        jref.wkv6_ref(jr, jk, jv, jw, ju, initial_state=js0),
        jops.wkv6(jr, jk, jv, jw, ju, initial_state=js0, impl="ref"),
        jops.wkv6(jr, jk, jv, jw, ju, initial_state=js0, impl="pallas"),
    )
    return [(np.asarray(o, np.float32), np.asarray(s, np.float32)) for o, s in outs]


def _wkv_torch(shape, dtype="float32", seed=0):
    r, k, v, w, u, s0 = _wkv_np(shape, seed)
    dt = getattr(torch, dtype)
    tr, tk, tv, tu = (torch.from_numpy(x).to(dt) for x in (r, k, v, u))
    ts0 = None if s0 is None else torch.from_numpy(s0)
    return tr, tk, tv, torch.from_numpy(w), tu, ts0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["jax_ref", "jax_chunked_ref", "pallas_interpret"])
@pytest.mark.parametrize("fn", ["wkv6_ref", "wkv6_chunked_ref", "wrapper"])
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=WKV_IDS)
def test_torch_wkv6_plain_matches_jax(shape, fn, oracle, dtype):
    r, k, v, w, u, s0 = _wkv_torch(shape, dtype)
    f = {"wkv6_ref": tref.wkv6_ref, "wkv6_chunked_ref": tref.wkv6_chunked_ref}.get(
        fn, twkv.wkv6_chunked
    )
    out, state = f(r, k, v, w, u, initial_state=s0)
    b, h, t, kd, vd, _ = shape
    assert out.shape == (b, h, t, vd) and out.dtype == r.dtype
    assert state.shape == (b, h, kd, vd) and state.dtype == torch.float32
    want_out, want_state = _wkv_jax(shape, dtype)[
        ["jax_ref", "jax_chunked_ref", "pallas_interpret"].index(oracle)
    ]
    tol = WKV_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), want_out, rtol=tol, atol=tol)
    np.testing.assert_allclose(state.numpy(), want_state, rtol=tol, atol=tol)
    assert twkv.wkv6_chunked.launches == 0


def test_wkv6_chunked_ref_pads_as_the_reference_ops_does():
    """A ragged T (21) padded inside the plain version equals the reference's
    ``ops.wkv6`` padding plus ``wkv6_pallas`` in interpret mode, and the
    sequential oracle: the pad rows (r = k = 0, w = 1) are no-ops."""
    shape = (1, 2, 21, 16, 16, False)
    r, k, v, w, u, _ = _wkv_np(shape, seed=3)
    want, want_state = jops.wkv6(*map(jnp.asarray, (r, k, v, w, u)), impl="pallas")
    got, got_state = tops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state), rtol=2e-4, atol=2e-4)
    dense, dense_state = tops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)), impl="dense")
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_state.numpy(), dense_state.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("split", [16, 21, 63])
@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_wkv6_state_chaining_equals_one_shot(impl, split):
    """Two halves with the state carried equal one pass (what decode relies on),
    with the split on and off the chunk grid."""
    r, k, v, w, u, _ = _wkv_torch((1, 2, 64, 16, 16, False))
    full, s_full = tops.wkv6(r, k, v, w, u, impl=impl)
    first = [x[:, :, :split] for x in (r, k, v, w)]
    rest = [x[:, :, split:] for x in (r, k, v, w)]
    o1, s1 = tops.wkv6(*first, u, impl=impl)
    o2, s2 = tops.wkv6(*rest, u, initial_state=s1, impl=impl)
    np.testing.assert_allclose(torch.cat([o1, o2], 2).numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref", "dense"])
def test_ops_wkv6_on_cpu_takes_the_plain_path_and_never_launches(impl):
    r, k, v, w, u, s0 = _wkv_torch((2, 3, 21, 32, 16, True))
    got, got_state = tops.wkv6(r, k, v, w, u, initial_state=s0, impl=impl)
    assert twkv.wkv6_chunked.launches == 0
    want, want_state = tref.wkv6_ref(r, k, v, w, u, initial_state=s0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_state.numpy(), want_state.numpy(), rtol=2e-4, atol=2e-4)


def test_ops_wkv6_rejects_unknown_impl():
    r, k, v, w, u, _ = _wkv_torch((1, 1, 4, 8, 8, False))
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        tops.wkv6(r, k, v, w, u, impl="triton")


def test_wkv6_wrapper_takes_the_models_strided_layout():
    """The model hands over (B, T, H, K) projections seen as (B, H, T, K): the
    wrapper takes them as they are (strides, last axis contiguous)."""
    r, k, v, w, u, s0 = _wkv_torch((2, 3, 19, 16, 32, True))
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (r, k, v, w)]
    assert not strided[0].is_contiguous()
    got, got_state = twkv.wkv6_chunked(*strided, u, initial_state=s0)
    want, want_state = twkv.wkv6_chunked(r, k, v, w, u, initial_state=s0)
    assert torch.equal(got, want) and torch.equal(got_state, want_state)


@pytest.mark.parametrize("t", [1, 2, twkv.STREAM_MAX_T, twkv.STREAM_MAX_T + 1, 16, 17, 3000])
def test_wkv6_launch_shape_is_a_function_of_t_alone(t):
    """The wrapper picks the stream or the chunk kernel by T and nothing else: the
    choice takes T as its only argument, and the path code that a launch hands the
    C entry point (``_plan``, what the CUDA branch passes) is the same for every B
    and H (here one row, the decode batch at the model's heads, and an odd shape);
    decode's T = 1 streams."""
    import inspect

    assert list(inspect.signature(twkv.path_for).parameters) == ["t"]
    assert twkv.STREAM_MAX_T >= 1 and twkv.path_for(1) == "stream"
    want = "stream" if t <= twkv.STREAM_MAX_T else "chunk"
    assert twkv.path_for(t) == want
    for b, h in [(1, 1), (4, 64), (3, 7)]:
        r, k, w = (torch.empty(b, h, t, 8) for _ in range(3))
        v = torch.empty(b, h, t, 4)
        code, (*_, out, s_out), strides = twkv._plan(r, k, v, w, torch.empty(b, h, 8, 4))
        assert code == twkv._C_PATH[want]
        assert out.shape == (b, h, t, 4) and out.stride() == (t * h * 4, 4, h * 4, 1)
        assert s_out.shape == (b, h, 8, 4) and strides[-3:] == list(out.stride()[:3])


@pytest.mark.parametrize(
    "k, dtype", [(64, torch.bfloat16), (20, torch.bfloat16), (12, torch.float32)]
)
def test_wkv6_aligned_pads_only_what_the_copies_cannot_take(k, dtype):
    """The chunk kernel's 16-byte copies: an operand in the model's layout whose rows
    are whole 16 bytes goes in as it is; another is padded with zeros along K to a
    multiple of 16 bytes, its first K columns unchanged."""
    x = torch.randn(2, 5, 3, k).to(dtype).transpose(1, 2)  # (B, H, T, K) view of (B, T, H, K)
    got = twkv._aligned(x)
    per = 16 // x.element_size()
    if k % per == 0:
        assert got is x
    else:
        assert got.shape == (2, 3, 5, k + (-k) % per) and got.is_contiguous()
        assert torch.equal(got[..., :k], x) and not got[..., k:].any()


@pytest.mark.parametrize(
    "case",
    [
        "k_too_big",
        "v_too_big",
        "w_bfloat16",
        "r_float16",
        "kv_dtype_mismatch",
        "u_shape",
        "u_float16",
        "u_float32_with_bfloat16_r",
        "s0_shape",
        "s0_dtype",
        "last_axis_strided",
        "empty_t",
        "v_time_mismatch",
        "s0_strided",
        "u_strided",
        "b_over_grid",
    ],
)
def test_wkv6_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks run on every device, so the CPU sees what the card would refuse."""
    b, h, t, kd, vd = 2, 3, 5, 8, 8
    r, k, v = torch.randn(b, h, t, kd), torch.randn(b, h, t, kd), torch.randn(b, h, t, vd)
    w, u, s0 = torch.rand(b, h, t, kd), torch.randn(h, kd), torch.randn(b, h, kd, vd)
    err = ValueError
    if case == "k_too_big":
        r, k, w = torch.randn(1, 1, 2, 80), torch.randn(1, 1, 2, 80), torch.rand(1, 1, 2, 80)
        v, u, s0 = torch.randn(1, 1, 2, 8), torch.randn(1, 80), None
    elif case == "v_too_big":
        v, s0 = torch.randn(b, h, t, 72), None
    elif case == "w_bfloat16":
        w, err = w.to(torch.bfloat16), TypeError
    elif case == "r_float16":
        r, k, v, err = r.half(), k.half(), v.half(), TypeError
    elif case == "kv_dtype_mismatch":
        k, err = k.to(torch.bfloat16), TypeError
    elif case == "u_shape":
        u = torch.randn(h, kd + 1)
    elif case == "u_float16":
        u, err = u.half(), TypeError
    elif case == "u_float32_with_bfloat16_r":
        r, k, v, err = r.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16), TypeError
    elif case == "s0_shape":
        s0 = torch.randn(b, h, vd, kd + 1)
    elif case == "s0_dtype":
        s0, err = s0.to(torch.bfloat16), TypeError
    elif case == "last_axis_strided":
        r = torch.randn(b, h, kd, t).transpose(2, 3)
    elif case == "empty_t":
        r, k, v, w = (x[:, :, :0] for x in (r, k, v, w))
    elif case == "s0_strided":
        s0 = torch.randn(b, h, vd, kd).transpose(2, 3)
    elif case == "u_strided":
        u = torch.randn(kd, h).t()
    elif case == "b_over_grid":
        r, k, v = (torch.zeros(65536, 1, 1, 8) for _ in range(3))
        w, u, s0 = torch.ones(65536, 1, 1, 8), torch.zeros(1, 8), None
    else:
        v = torch.randn(b, h, t + 1, vd)
    with pytest.raises(err):
        twkv.wkv6_chunked(r, k, v, w, u, initial_state=s0)
