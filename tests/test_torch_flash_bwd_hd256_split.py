"""The bfloat16 flash backward's head-dim-256 "split" builds, in their decomposition, on the CPU.

Above head dim 128 ``csrc/flash_attention_bwd_bf16.cu`` runs kernels of its
own: dK and dV a block per (tile of 64 keys, part of its walk, KV head, batch),
the walk over the GQA group's (query head, query tile) pairs cut into parts of
equal length, each part's float32 partial summed with the others in part order
by a reduction kernel, and each walk tile's dS^T stored for the dQ kernel, which
sums dQ over the key tiles of its 64 query rows in order from those tiles. The
number of parts comes from ``flash_attention.bwd_split_plan``, a function of the
shapes and masks alone. Its plain version ``ref.flash_attention_bwd_split_ref`` follows
that decomposition (rounding P and dS to bfloat16 where they enter a product,
for bfloat16 inputs). Here it is held against the plain backward
``ref.flash_attention_bwd_ref`` (float64 within 1e-10, float32 within 1e-5 of
each gradient's largest entry) at the planner's parts and at parts that cut the
walks unevenly, and in bfloat16 against ``jax.vjp`` through
``flash_attention_pallas(interpret=True)`` within tests/
test_torch_flash_bwd_bf16.py's TOL. Then the plan: every (key tile, query head,
query tile) the masks keep is walked by exactly one part; the dQ kernel reads
exactly the dS^T tiles the dK/dV kernel stores, each query tile's in its own run
of slots, which together fill the scratch; the parts at
recurrentgemma-9b's train shape are within one tile of each other and leave the
busiest SM the even share; the plan takes no batch size, and the model's
gradients for batch row 0 are the same bits at B = 1 and B = 3; the planner's
constants are the kernels'.
"""

import functools
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

# (B, Hq, Hkv, Sq, Sk, D, causal, window, Dv, parts): tests/test_torch_hybrid_train.py's
# head-dim-256 cases (recurrentgemma-9b's MQA of 16 heads; ragged S; a window crossing the
# 64-row tiles; Dv 128; GQA at B = 2) at the planner's parts (None); the same 16-head MQA
# with Sq < Sk and a window at 5 and 3 parts, which cut its walks (16 to 64 tiles) unevenly;
# chip_smoke.py's case of a group of 3 whose walks of 3 to 15 tiles the planner's 8 parts
# cut unevenly, some parts empty; a walk of one tile, which the planner leaves in one part
# (the dK/dV kernel then writes dK and dV itself).
CASES = [
    (1, 16, 1, 40, 40, 256, True, None, 256, None),
    (1, 16, 1, 150, 150, 256, True, 70, 256, None),
    (1, 16, 1, 100, 130, 256, True, 50, 128, None),
    (2, 4, 2, 90, 90, 256, True, None, 256, None),
    (1, 16, 1, 200, 330, 256, True, 90, 256, 5),
    (1, 16, 1, 200, 330, 256, True, 90, 256, 3),
    (1, 6, 2, 300, 500, 256, True, 150, 256, None),
    (1, 2, 2, 64, 64, 256, True, None, 256, None),
]
IDS = [f"case{i}" for i in range(len(CASES))]
# each gradient within this share of its largest entry of the plain backward's: float64 sums
# in another order; float32 the same, over up to 64 x 16 terms a key
SPLIT_TOL = {"float64": 1e-10, "float32": 1e-5}
# tests/test_torch_flash_bwd_bf16.py's tolerance of the bfloat16 backward against the
# reference's VJP: 2^-6 of each gradient's largest entry (one rounding of each side, the Δ of
# the saved bfloat16 output and the kernels' P/dS rounding fit in it)
TOL = 2.0**-6
# recurrentgemma-9b's train shape (chip_smoke.py's FLASH_BWD_HD256_TRAIN): Sq, Sk, Hq, Hkv,
# causal, window
TRAIN = (4096, 4096, 16, 1, True, 2048)


@pytest.fixture(autouse=True)
def _one_thread():
    """The model runs hundreds of small ops a call: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores (restored after each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_inputs(i):
    b, hq, hkv, sq, sk, d, _, _, dv, _ = CASES[i]
    rng = np.random.default_rng(2800 + i)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))
    # values already on the bfloat16 grid, so every dtype and both packages start from them
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float().numpy()
        for s in shapes
    )


def _masks(i):
    return dict(causal=CASES[i][6], window=CASES[i][7])


def _parts(i):
    b, hq, hkv, sq, sk, _, causal, window, _, parts = CASES[i]
    return parts or tfa.bwd_split_plan(sq, sk, hq, hkv, causal, window)


def _share(got, want, tol):
    """max |got - want| as a share of tol times want's largest entry."""
    got, want = (x.double() for x in (got, want))
    return ((got - want).abs().max() / (tol * want.abs().max())).item()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_split_model_matches_the_plain_backward(i, dtype):
    q, k, v, dout = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in _np_inputs(i))
    out, lse = tref.flash_attention_ref(
        q.double(), k.double(), v.double(), **_masks(i), return_lse=True
    )
    out = out.to(q.dtype)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **_masks(i))
    got = tref.flash_attention_bwd_split_ref(
        q, k, v, out, lse, dout, **_masks(i), parts=_parts(i)
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == q.dtype and g.shape == w.shape, name
        assert _share(g, w, SPLIT_TOL[dtype]) <= 1.0, f"{name}: {_share(g, w, SPLIT_TOL[dtype])}"


@functools.lru_cache(maxsize=None)
def _jax_grads(i):
    q, k, v, dout = (jnp.asarray(x, jnp.bfloat16) for x in _np_inputs(i))
    fn = functools.partial(
        flash_attention_pallas, **_masks(i), block_q=64, block_k=64, interpret=True
    )
    _, vjp = jax.vjp(fn, q, k, v)
    return tuple(torch.from_numpy(np.asarray(g, np.float32)) for g in vjp(dout))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_split_model_in_bfloat16_matches_jax_vjp(i):
    """The model on bfloat16 inputs, from the bfloat16 forward's float32 output and logsumexp
    as the port saves them, rounding P and dS where the kernels do; printed as a share of TOL."""
    q, k, v, dout = (torch.from_numpy(x).bfloat16() for x in _np_inputs(i))
    _, lse, out = tfa.flash_attention_fwd(q, k, v, **_masks(i), return_lse=True)
    got = tref.flash_attention_bwd_split_ref(
        q, k, v, out, lse, dout, **_masks(i), parts=_parts(i)
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_grads(i)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        share = _share(g.float(), w, TOL)
        print(f"{IDS[i]} {name}: {100 * share:.1f}% of TOL at {_parts(i)} parts")
        assert share <= 1.0, name


def _kept_tiles(sq, sk, hq, hkv, causal, window):
    """The (key tile, query head, query tile) triples of one batch row and KV head 0's group
    in which the masks keep some (query, key) pair."""
    t, off = tfa.BWD_SPLIT_TILE, sk - sq
    i = np.arange(sq)[:, None] + off
    j = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    kept = set()
    for kt in range(-(-sk // t)):
        for qt in range(-(-sq // t)):
            if keep[qt * t : qt * t + t, kt * t : kt * t + t].any():
                kept.update((kt, h, qt) for h in range(hq // hkv))
    return kept


def _walked_tiles(sq, sk, hq, hkv, causal, window, parts):
    """The triples the parts' spans walk, each with the part that walks it."""
    walked = []
    walks = tfa.bwd_split_walks(sq, sk, causal, window)
    for kt, (t_begin, per_head) in enumerate(walks):
        for part, (lo, hi) in enumerate(tfa.bwd_split_spans(hq // hkv * per_head, parts)):
            walked += [
                (kt, idx // per_head, t_begin + idx % per_head, part) for idx in range(lo, hi)
            ]
    return walked


@pytest.mark.parametrize(
    "shape",
    [
        TRAIN,
        (300, 500, 6, 2, True, 150),
        (200, 330, 16, 1, True, 90),
        (150, 400, 16, 1, True, 70),
        (1, 70, 4, 1, True, None),
        (100, 130, 4, 2, False, None),
        (130, 130, 2, 2, True, 100),
        (40, 40, 16, 1, True, 1),
    ],
)
@pytest.mark.parametrize("parts", [None, 1, 3, 8])
def test_every_kept_tile_is_walked_by_exactly_one_part(shape, parts):
    parts = parts or tfa.bwd_split_plan(*shape)
    walked = _walked_tiles(*shape, parts)
    triples = [w[:3] for w in walked]
    assert len(triples) == len(set(triples)), "a tile walked twice"
    assert set(triples) == _kept_tiles(*shape)
    # each part's tiles are consecutive in the walk (its partial is one run of the group's
    # heads in order, each its tiles in order)
    for kt in {w[0] for w in walked}:
        order = [w[3] for w in walked if w[0] == kt]
        assert order == sorted(order)


@pytest.mark.parametrize(
    "shape",
    [
        (4096, 4096, True, 2048),
        (4096, 4096, True, None),
        (300, 500, True, 150),
        (150, 400, True, 70),
        (1, 70, True, None),
        (100, 130, False, None),
        (130, 130, True, 100),
        (40, 40, True, 1),
        (65, 65, False, 30),
    ],
)
def test_dq_reads_exactly_the_ds_tiles_dkdv_stores(shape):
    """The (key tile, query tile) pairs whose dS^T the dK/dV kernel stores (its walks) are
    the pairs the dQ kernel reads (its walks, the forward's), and their slots in a head's
    part of the dS scratch (``offsets[qt] + kt - kb``) fill it, each once."""
    stored = {
        (kt, t_begin + i)
        for kt, (t_begin, per_head) in enumerate(tfa.bwd_split_walks(*shape))
        for i in range(per_head)
    }
    walks = tfa.bwd_dq_walks(*shape)
    read = {(kt, qt) for qt, (kb, ke) in enumerate(walks) for kt in range(kb, ke)}
    assert read == stored
    offsets = tfa.bwd_ds_offsets(*shape)
    assert len(offsets) == len(walks) + 1
    slots = sorted(offsets[qt] + kt - walks[qt][0] for kt, qt in stored)
    assert slots == list(range(offsets[-1]))


def test_the_train_shapes_parts_are_even_and_fill_every_sm():
    """recurrentgemma-9b's train shape: 8 parts, the longest-first model of the 512 blocks on
    132 SMs (launch order, each block to the SM that frees first) gives the busiest SM the even
    share of the 25,344 walk tiles; each key tile's parts are within one tile of each other.
    The model's figures for 1, 2, 4 and 8 parts are PERF.md's."""
    sq, sk, hq, hkv, causal, window = TRAIN
    parts = tfa.bwd_split_plan(*TRAIN)
    walks = [hq // hkv * n for _, n in tfa.bwd_split_walks(sq, sk, causal, window)]
    even = sum(walks) * hkv / tfa.BWD_SPLIT_SMS
    longest = {g: tfa.bwd_split_longest(walks, g, hkv) for g in (1, 2, 4, 8)}
    print(f"parts {parts}; busiest SM by parts {longest}; even share {even}")
    assert parts == 8 and len(walks) * parts * hkv == 512
    assert longest == {1: 528, 2: 264, 4: 252, 8: 192}
    assert tfa.bwd_split_longest(walks, parts, hkv) <= even + 1
    for walk in walks:
        lengths = [hi - lo for lo, hi in tfa.bwd_split_spans(walk, parts)]
        assert max(lengths) - min(lengths) <= 1 and sum(lengths) == walk


def test_the_split_does_not_depend_on_the_batch():
    """The plan is a function of the shapes and masks alone, and batch row 0's gradients in
    the split's decomposition are the same bits alone and beside two other rows."""
    assert list(inspect.signature(tfa.bwd_split_plan).parameters) == [
        "sq", "sk", "hq", "hkv", "causal", "window",
    ]
    rng = np.random.default_rng(28)
    b, hq, hkv, sq, sk, d, dv = 3, 6, 2, 150, 200, 256, 128
    masks = dict(causal=True, window=70)
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes)
    out, lse = tref.flash_attention_ref(q, k, v, **masks, return_lse=True)
    parts = tfa.bwd_split_plan(sq, sk, hq, hkv, True, 70)
    assert parts > 1
    three = tref.flash_attention_bwd_split_ref(q, k, v, out, lse, dout, **masks, parts=parts)
    one = tref.flash_attention_bwd_split_ref(
        q[:1], k[:1], v[:1], out[:1], lse[:1], dout[:1], **masks, parts=parts
    )
    for name, x, y in zip(("dq", "dk", "dv"), three, one):
        assert torch.equal(x[:1], y), name


def test_the_cases_run_the_split_in_one_part_and_in_more():
    """With one part the dK/dV kernel writes dK and dV itself, with more its partials go to the
    reduction: the cases hold both."""
    assert {_parts(i) == 1 for i in range(len(CASES))} == {True, False}


def test_the_planners_constants_are_the_kernels():
    """``BWD_SPLIT_MAX_PARTS`` and ``BWD_SPLIT_TILE`` are MAX_PARTS and WALK of the kernels'
    source, which refuse more parts and index the dS scratch in tiles of WALK rows."""
    source = (Path(tfa.__file__).parent / "csrc" / "flash_attention_bwd_bf16.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))

    assert constant("MAX_PARTS") == tfa.BWD_SPLIT_MAX_PARTS
    assert constant("WALK") == tfa.BWD_SPLIT_TILE
