"""Flash attention, forward and backward: the hand-written Hopper kernels and their wrappers.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas`` and
its custom VJP. The kernels are in ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu`` (float32) and ``csrc/flash_attention_bwd_bf16.cu``
(CUDA C++ for ``sm_90a``, built by :mod:`._build`); their source notes say what
they replace and what bounds them.

Forward: both dtypes run on the tensor cores, one kernel a dtype with no
fallback between them: bfloat16 through ``wgmma`` fed by TMA, float32
through ``mma.sync`` in 3xTF32 (each operand split into TF32 hi and lo
halves, three products a step: float32 accuracy). The float32 kernel may
cut a long key walk into pieces that run on separate blocks and are merged
in a fixed order; :func:`f32_plan` chooses the cut from the shapes and
masks alone, never from B or the card, so a row's bits do not depend on
the batch it runs in. Asked for it, both paths also write each row's
logsumexp in float32, which the backward needs, and the bfloat16 path then
also its output in float32 before the rounding, from which the backward
takes Δ.

Backward (:func:`flash_attention_bwd`, head dims up to 256 in bfloat16 and up
to 128 in float32): the FlashAttention-2 form, three launches (Δ =
rowsum(dO∘O); dK and dV a block per key tile, summed over the GQA group in a
fixed order in float32; dQ a block per query tile), no atomics: a step
replays bit for bit. Δ comes from the forward's output in float32, so that
each row's dS sums to about zero with the P the backward recomputes, as in the
reference's VJP, which differentiates a float32 forward. The bfloat16 dQ
kernel (head dims up to 128) takes what is left of that sum, each row's sum of
the bfloat16 dS it used times a mean key, from dQ, where the keys' common
component would multiply it. float32 runs
in 3xTF32: head dims up to 64 that are multiples of 4 (the demo's training)
on ``wgmma`` fed by a TMA ring, every other one on ``mma.sync``. bfloat16
runs its own kernels, also ``wgmma`` fed by a TMA ring and warp-specialised,
bfloat16 operands with float32 sums, P and dS rounded to bfloat16 only where
they enter a product, dq, dk and dv returned in bfloat16 (:func:`bwd_path`
names the kernels from the dtype and head dims). Above head dim 128 the bfloat16
backward runs "split" builds: each key tile's dK/dV walk is cut into parts on
blocks of their own, summed in order by a fourth launch, and dQ is summed from
the dS tiles the dK/dV kernel stores; :func:`bwd_split_plan` chooses the number
of parts from the shapes and masks alone, never from B or the card.
:class:`FlashAttentionFunction` joins forward and backward under autograd in
either dtype.

On a CUDA tensor each wrapper launches its kernels or raises. On a CPU
tensor it runs the plain version (:func:`repro_torch.kernels.ref.
flash_attention_ref`, :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`),
and only because the tensor lies on the CPU. The same checks apply on both
devices, so the CPU tests see what the kernels would refuse.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Optional, Sequence, Tuple

import torch

from . import ref as _ref
from ._build import count_launch

__all__ = [
    "flash_attention_fwd",
    "flash_attention_bwd",
    "FlashAttentionFunction",
    "f32_plan",
    "bwd_split_plan",
    "bwd_split_longest",
    "bwd_split_walks",
    "bwd_split_spans",
    "bwd_dq_walks",
    "bwd_ds_offsets",
    "MAX_HEAD_DIM",
    "MAX_BWD_HEAD_DIM",
    "MAX_BWD_BF16_HEAD_DIM",
    "PATHS",
    "bwd_path",
]

MAX_HEAD_DIM = 256  # the C side's MAX_D in csrc/flash_attention_fwd.cu
MAX_BWD_HEAD_DIM = 128  # float32: the C side's MAX_D in csrc/flash_attention_bwd.cu
MAX_BWD_BF16_HEAD_DIM = 256  # bfloat16: MAX_D in csrc/flash_attention_bwd_bf16.cu
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
#: the kernel that serves each dtype, both on the tensor cores: wgmma (bfloat16) and
#: mma.sync in 3xTF32 (float32)
PATHS = {torch.bfloat16: "wgmma", torch.float32: "3xtf32"}
_TMA_ALIGN = 8  # bfloat16 head dims: a TMA row stride is a multiple of 16 bytes

# The float32 kernel's tiles and split plan (``f32`` in csrc/flash_attention_fwd.cu).
F32_BLOCK_Q = 64  # query rows a block
#: a (batch, head) with fewer query tiles than this has its long key walks cut into pieces
F32_SPLIT_TARGET = 80
F32_MIN_PIECE_TILES = 2  # key tiles a piece, at least
F32_MAX_PIECES = 16  # pieces a query tile, at most (the merge kernel's weights)

# The backward's wgmma path (``wg`` in csrc/flash_attention_bwd.cu).
BWD_WGMMA_MAX_HEAD_DIM = 64  # its tiles' head-dim columns
#: rows of a walk tile: query rows (dK/dV) or keys (dQ), on both paths; each is summed
#: from zero in the tensor cores before a float32 add into the walk's total
BWD_WALK = 32

# The bfloat16 backward's split builds (head dims above 128; ``SplitPlan`` in
# csrc/flash_attention_bwd_bf16.cu).
#: rows a block of the split builds owns, and rows of a walk tile (WALK there)
BWD_SPLIT_TILE = 64
BWD_SPLIT_MAX_PARTS = 8  # parts of a key tile's dK/dV walk, at most (MAX_PARTS there)
#: the SMs the dK/dV grid is planned for, an H100's: a constant, never read from the card,
#: so that the plan, and with it each gradient's order of summation, is the same on any
BWD_SPLIT_SMS = 132


def bwd_path(d: int, dv: int, dtype: torch.dtype = torch.float32) -> str:
    """The backward kernels that serve head dims ``d`` and ``dv`` in ``dtype``: "bf16"
    (``csrc/flash_attention_bwd_bf16.cu``, ``wgmma`` fed by a TMA ring) for bfloat16; in
    float32 "wgmma" (the same design in 3xTF32) for both up to 64 and multiples of 4 (a TMA
    row stride is a multiple of 16 bytes), else "mma.sync"."""
    if dtype == torch.bfloat16:
        return "bf16"
    small = d <= BWD_WGMMA_MAX_HEAD_DIM and dv <= BWD_WGMMA_MAX_HEAD_DIM
    return "wgmma" if small and d % 4 == 0 and dv % 4 == 0 else "mma.sync"


def f32_key_block(d: int, dv: int) -> int:
    """Keys a tile of the float32 kernel: 64 (Q in registers) up to head dims of 64, else 16."""
    return 64 if d <= 64 and dv <= 64 else 16


def _f32_key_tiles(sq: int, sk: int, causal: bool, window: int, bk: int):
    """Key tiles each query tile walks: those some row of it can see (``Walk::key_tiles``)."""
    offset, tiles = sk - sq, []
    for q0 in range(0, sq, F32_BLOCK_Q):
        first, last = q0 + offset, min(q0 + F32_BLOCK_Q, sq) - 1 + offset
        k_end = min(sk, last + 1) if causal else sk
        k_begin = (max(0, first - window + 1) if window > 0 else 0) // bk * bk
        tiles.append(-(-(k_end - k_begin) // bk))
    return tiles


@functools.lru_cache(maxsize=1024)
def f32_plan(
    sq: int, sk: int, causal: bool, window: Optional[int], d: int, dv: int
) -> Tuple[int, int]:
    """(key tiles a piece, pieces of all query tiles) for the float32 kernel.

    A function of the shapes and masks of one (batch, head) alone: never of B, of the
    head count or of the card, so the reduction order of a row, and with it its bits,
    is the same at any batch. A (batch, head) with at least ``F32_SPLIT_TARGET`` query
    tiles is not cut. Below that, the longest walk is cut into about
    ``F32_SPLIT_TARGET / tiles`` pieces (at most ``F32_MAX_PIECES``, each of at least
    ``F32_MIN_PIECE_TILES`` key tiles) and every walk into pieces of that length, split
    evenly; the pieces of a tile are merged in order by a second kernel.
    """
    tiles = _f32_key_tiles(sq, sk, bool(causal), window or 0, f32_key_block(d, dv))
    longest = max(tiles)
    if len(tiles) >= F32_SPLIT_TARGET:
        split = longest
    else:
        pieces = min(F32_MAX_PIECES, -(-F32_SPLIT_TARGET // len(tiles)))
        split = max(F32_MIN_PIECE_TILES, -(-longest // pieces))
    return split, sum(-(-n // split) for n in tiles)


def bwd_split_walks(
    sq: int, sk: int, causal: bool, window: Optional[int]
) -> Sequence[Tuple[int, int]]:
    """(first query tile, query tiles a head) of each tile of 64 keys: the query tiles
    that some key of it is visible to, which the split builds' dK/dV kernel walks for
    each query head of the group in turn."""
    t, off, walks = BWD_SPLIT_TILE, sk - sq, []
    for k0 in range(0, sk, t):
        k_last = min(k0 + t, sk) - 1
        i_begin = max(0, k0 - off) if causal else 0
        i_end = min(sq, k_last + window - off) if window else sq
        t_begin = i_begin // t
        walks.append((t_begin, -(-i_end // t) - t_begin if i_end > i_begin else 0))
    return walks


def bwd_dq_walks(
    sq: int, sk: int, causal: bool, window: Optional[int]
) -> Sequence[Tuple[int, int]]:
    """[first, end) key tiles of each tile of 64 query rows: the key tiles some row of it
    sees, which the split builds' dQ kernel walks (the forward's walk, in tiles of 64)."""
    t, off, walks = BWD_SPLIT_TILE, sk - sq, []
    for q0 in range(0, sq, t):
        k_end = min(sk, min(q0 + t, sq) - 1 + off + 1) if causal else sk
        kb = (max(0, q0 + off - window + 1) if window else 0) // t
        walks.append((kb, max(kb, -(-k_end // t))))
    return walks


def bwd_ds_offsets(sq: int, sk: int, causal: bool, window: Optional[int]) -> Sequence[int]:
    """Where each query tile's dS^T tiles start among a head's slots of the split builds' dS
    scratch, and (last) the slots a head: the prefix sums of the :func:`bwd_dq_walks`
    lengths. The tile of (query tile qt, key tile kt) is slot ``offsets[qt] + kt - kb(qt)``
    (``ds_offset`` in the kernels), so the scratch holds exactly the tiles walked."""
    offsets = [0]
    for kb, ke in bwd_dq_walks(sq, sk, causal, window):
        offsets.append(offsets[-1] + ke - kb)
    return offsets


def bwd_split_spans(walk: int, parts: int) -> Sequence[Tuple[int, int]]:
    """The spans [lo, hi) of a walk of ``walk`` tiles that its ``parts`` blocks take:
    equal within one tile, in order."""
    return [(walk * p // parts, walk * (p + 1) // parts) for p in range(parts)]


def bwd_split_longest(walks: Sequence[int], parts: int, hkv: int) -> int:
    """Walk tiles on the busiest of ``BWD_SPLIT_SMS`` SMs when the split builds' dK/dV
    blocks of one batch row (for each key tile of ``walks`` tiles, its ``parts`` parts, then
    the ``hkv`` KV heads: the kernel's order) go in that order each to the SM that frees
    first."""
    free = [0] * BWD_SPLIT_SMS
    for walk in walks:
        for lo, hi in bwd_split_spans(walk, parts):
            for _ in range(hkv):
                heapq.heappush(free, heapq.heappop(free) + hi - lo)
    return max(free)


@functools.lru_cache(maxsize=1024)
def bwd_split_plan(
    sq: int, sk: int, hq: int, hkv: int, causal: bool, window: Optional[int]
) -> int:
    """Parts of each key tile's dK/dV walk in the bfloat16 split builds: the fewest, up to
    ``BWD_SPLIT_MAX_PARTS`` and the longest walk's tiles, that leave the busiest of
    ``BWD_SPLIT_SMS`` SMs least work (:func:`bwd_split_longest`, one batch row).

    A function of the shapes and masks alone, never of B or the card, so each gradient is
    summed in the same order, and has the same bits, at any batch. recurrentgemma-9b's
    train shape (Sq = Sk = 4096, 16 query heads on one KV head, causal, window 2048): 8
    parts, 512 blocks, 192 walk tiles on the busiest SM, the even share (528 with one).
    """
    g = hq // hkv
    walks = [g * n for _, n in bwd_split_walks(sq, sk, bool(causal), window)]
    cap = max(1, min(BWD_SPLIT_MAX_PARTS, max(walks)))
    return min(range(1, cap + 1), key=lambda parts: (bwd_split_longest(walks, parts, hkv), parts))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    dv = v.shape[-1]
    if bk != b or v.shape[:3] != k.shape[:3] or dk != d:
        raise ValueError(
            f"flash_attention_fwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not agree"
        )
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_fwd: Hq={hq} is not a multiple of Hkv={hkv}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_fwd: head dims D={d}, Dv={dv} not in 1..{MAX_HEAD_DIM}")
    if sk < 1:
        raise ValueError("flash_attention_fwd: no keys (Sk = 0)")
    if (causal or window is not None) and sq > sk:
        raise ValueError(f"flash_attention_fwd: causal/window masks need Sq <= Sk, not {sq} > {sk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "all three must be float32 or all bfloat16"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_fwd: B={b}, Hq={hq} exceed the grid limit")


def _pad_head_dims(*xs: torch.Tensor):
    """The tensors with their last dim padded with zeros to a multiple of 8, for the
    bfloat16 kernels (q, k, v; in the backward also out and dout).

    Zero q and k columns leave every score as it was; zero v columns give output
    columns that the caller cuts off, and zero out and dout columns add nothing to Δ
    or dP. Tensors that need no pad come back as they are (a copy only where a base
    address is not 16-byte aligned, as TMA needs).
    """

    def pad(x: torch.Tensor) -> torch.Tensor:
        extra = -x.shape[-1] % _TMA_ALIGN
        if extra:
            return torch.nn.functional.pad(x, (0, extra))
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return tuple(pad(x) for x in xs)


def _lib(name: str, n_ptr: int, n_int: int, n_after: int) -> ctypes.CDLL:
    """Kernel library ``name``, its entry point ``repro_<name>`` declared as n_ptr pointers,
    n_int ints, the float scale, n_after ints and the stream."""
    from . import _build

    lib = _build.load(name)
    fn = getattr(lib, f"repro_{name}")
    if fn.argtypes is None:  # first use: declare the C signature
        # argtypes last: it is the flag another thread tests above
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ctypes.c_float] + [i32] * n_after + [ptr]
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, who: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{who}: launch failed: CUDA error {err} ({msg})")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention forward. q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv) -> (B,Hq,Sq,Dv).

    With ``return_lse`` it returns what :func:`flash_attention_bwd` takes beside it:
    (out, lse, out_f32), lse (B,Hq,Sq) float32 each row's logsumexp and out_f32 the
    output in float32 before its rounding to q's dtype (for a float32 q, ``out`` itself).
    The output's bits are the same either way. ``flash_attention_fwd.launches`` counts
    kernel launches (never the CPU path); :data:`PATHS` names the kernel that serves each
    dtype.
    """
    _check(q, k, v, causal, window)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if not return_lse:
            return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
        out_f32, lse = _ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale, return_lse=True,
            out_dtype=torch.promote_types(q.dtype, torch.float32),
        )  # fmt: skip
        return out_f32.to(q.dtype), lse, out_f32
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    tensor_cores = PATHS[q.dtype] == "wgmma"
    dv_out = v.shape[-1]
    if tensor_cores:
        q, k, v = _pad_head_dims(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    out_f32 = None
    if return_lse and q.dtype != torch.float32:
        out_f32 = torch.empty((b, hq, sq, dv), dtype=torch.float32, device=q.device)
    split_tiles, n_items, workspace = 0, 0, None
    if not tensor_cores and sq > 0 and b > 0:
        split_tiles, n_items = f32_plan(sq, sk, causal, window, d, dv)
        if n_items > -(-sq // F32_BLOCK_Q):  # some walk is cut: room for the pieces
            n = b * hq * n_items * F32_BLOCK_Q * (-(-dv // 8) * 8 + 2)
            workspace = torch.empty(n, dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_fwd", 7, 9, 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out_f32 is None else out_f32.data_ptr(),
            b,
            hq,
            hkv,
            sq,
            sk,
            d,
            dv,
            int(bool(causal)),
            int(window) if window is not None else 0,
            scale,
            split_tiles,
            n_items,
            int(tensor_cores),
            stream,
        )
    _raise_on(lib, err, "flash_attention_fwd")
    count_launch(flash_attention_fwd)
    if dv != dv_out:
        out = out[..., :dv_out].contiguous()
        out_f32 = None if out_f32 is None else out_f32[..., :dv_out].contiguous()
    if not return_lse:
        return out
    return out, lse, out if out_f32 is None else out_f32


flash_attention_fwd.launches = 0


def _check_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse what the backward kernels do not take, on every device alike: head dims above
    256 in bfloat16, above 128 in float32."""
    d, dv = q.shape[-1], v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    limit = MAX_BWD_BF16_HEAD_DIM if bf16 else MAX_BWD_HEAD_DIM
    if d > limit or dv > limit:
        raise ValueError(
            f"flash attention backward: head dims D={d}, Dv={dv} above {limit} in {q.dtype}; "
            + ("" if bf16 else "float32 heads above 128 wait for ")
            + "ROADMAP Queue 2 item 4"
        )


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward: (dq, dk, dv) from the forward's inputs, output and logsumexp
    and the output's gradient ``dout``, all contiguous; dk and dv summed over the GQA group.
    ``dout`` is in q's dtype (float32 or bfloat16), lse in float32, ``out`` in float32
    (the forward's ``out_f32``, from which Δ matches the P the kernels recompute) or in
    q's dtype, which the kernels take upcast: from a bfloat16 ``out`` each row's dS sums
    to dO·(O - bf16(O)) instead of zero, an error that the keys' common component
    carries into dQ. The gradients come back in the inputs' dtype.

    ``flash_attention_bwd.launches`` counts calls that launched the kernels (Δ, dK/dV, in
    the bfloat16 split builds the reduction of dK/dV's parts, and dQ: one count a call); on
    a CPU tensor it runs
    :func:`repro_torch.kernels.ref.flash_attention_bwd_ref` and counts nothing.
    :func:`bwd_path` names the kernels that serve the dtype and head dims.

    The split builds (bfloat16 above head dim 128) take two scratches that this function
    allocates for the call: the dS^T tiles, B·Hq·T tiles of 64 × 64 bfloat16 (8 KiB), T
    the key tiles all query tiles of a head see (:func:`bwd_ds_offsets`): about
    ⌈Sq/64⌉·⌈min(Sk, window)/64⌉ with a window, half of ⌈Sq/64⌉·⌈Sk/64⌉ causal without
    one, so O(Sq·Sk) without a window (recurrentgemma-9b's train shape, 16 heads, 4096
    tokens, window 2048: 207.6 MB; 16 heads of 8192 causal tokens with no window: 1.08 GB);
    and, where a key tile's walk is cut into more than one part, the float32 partials,
    B·Hkv·parts·Sk·(D + Dv)·4 bytes (67.1 MB at that train shape).
    """
    _check(q, k, v, causal, window)
    _check_grad(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    if out.shape != (b, hq, sq, dv) or dout.shape != out.shape or lse.shape != (b, hq, sq):
        raise ValueError(
            f"flash_attention_bwd: out{tuple(out.shape)} dout{tuple(dout.shape)} "
            f"lse{tuple(lse.shape)} do not fit q{tuple(q.shape)} v{tuple(v.shape)}"
        )
    scale = float(scale) if scale is not None else d**-0.5
    d_in, dv_in = d, dv
    if q.device.type == "cpu":
        return _ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    saved = (
        ("out", out, (q.dtype, torch.float32)),
        ("lse", lse, (torch.float32,)),
        ("dout", dout, (q.dtype,)),
    )
    for name, x, dtypes in saved:
        if x.dtype not in dtypes or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} must be {' or '.join(map(str, dtypes))}, "
                f"contiguous, on {q.device}"
            )
    if b == 0 or sq == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    path = bwd_path(d, dv, q.dtype)
    if path == "bf16":  # TMA rows of 16 bytes: head dims padded to multiples of 8
        q, k, v, out, dout = _pad_head_dims(q, k, v, out.float(), dout)
        d, dv = q.shape[-1], v.shape[-1]
    elif path == "wgmma":  # TMA reads from 16-byte-aligned bases
        q, k, v, dout = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v, dout))
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    pointers = [q, k, v, out, lse, dout, delta, dq, dk, dvv]
    ints = [b, hq, hkv, sq, sk, d, dv, int(bool(causal)), int(window) if window is not None else 0]
    if path == "bf16":
        # the split builds: the parts of each key tile's dK/dV walk, the float32 scratch of
        # their partials, and the scratch of dS^T tiles that the dK/dV kernel writes for dQ
        parts, ds_tiles, partial, ds = 1, 0, None, None
        if max(d, dv) > 128:
            parts = bwd_split_plan(sq, sk, hq, hkv, causal, window)
            ds_tiles = bwd_ds_offsets(sq, sk, causal, window)[-1]
            t = BWD_SPLIT_TILE
            ds = torch.empty((b * hq * ds_tiles, t, t), dtype=q.dtype, device=q.device)
        if parts > 1:
            n = b * hkv * parts * sk * (d + dv)
            partial = torch.empty(n, dtype=torch.float32, device=q.device)
        name, lib = "flash_attention_bwd_bf16", _lib("flash_attention_bwd_bf16", 12, 9, 2)
        scratch = [None if x is None else x.data_ptr() for x in (partial, ds)]
        args = [x.data_ptr() for x in pointers] + scratch + ints + [scale, parts, ds_tiles]
    else:
        name, lib = "flash_attention_bwd", _lib("flash_attention_bwd", 10, 9, 0)
        args = [x.data_ptr() for x in pointers] + ints + [scale]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"repro_{name}")(*args, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    count_launch(flash_attention_bwd)
    if path == "bf16" and (d, dv) != (d_in, dv_in):
        dq, dk = dq[..., :d_in].contiguous(), dk[..., :d_in].contiguous()
        dvv = dvv[..., :dv_in].contiguous()
    return dq, dk, dvv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its gradient: the forward kernel with the logsumexp and the output in
    float32 saved beside (q, k, v), the backward kernels on them, float32 or bfloat16 (the
    incoming gradient in that dtype). The counterpart of the reference's
    ``jax.custom_vjp`` around ``flash_attention_pallas``, whose backward differentiates a
    float32 forward: Δ from the float32 output keeps each row's dS summing to zero as
    there."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        _check_grad(q, k, v)
        out, lse, out_f32 = flash_attention_fwd(
            q, k, v, causal=causal, window=window, scale=scale, return_lse=True
        )
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.masks = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.masks
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal, window=window, scale=scale
        )
        return dq, dk, dv, None, None, None
