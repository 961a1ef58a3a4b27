// Flash-attention forward for Hopper (sm_90a): both dtypes on the tensor cores, bfloat16
// through wgmma, float32 through mma.sync in 3xTF32.
//
// Replaces the TPU kernel `_fwd_kernel` in src/repro/kernels/flash_attention.py
// (launched by `_fwd_impl` through `pl.pallas_call`). Same function: online-softmax
// attention with causal and local-window masks on right-aligned query positions
// (qpos = i + Sk - Sq), GQA/MQA through the KV head h / (Hq / Hkv), a value head dim
// that may differ from the key head dim, ragged Sq and Sk masked in the kernel (no
// padding copy), masked logits at -1e30, the sum in float32, the denominator clamped
// at 1e-37, and the output in the input dtype. One kernel serves each dtype; neither
// falls back to the other.
//
// What bounds it. The work is 2*Hq*pairs*(D+Dv) FLOPs, where pairs counts the (query,
// key) pairs the masks keep, against one read of q, k, v and one write of o. At the
// demo's prefill (Hq=12, Hkv=4, D=Dv=64, causal) that is about S/2 FLOPs a byte, and at
// recurrentgemma-9b's local attention (Hq=16, Hkv=1, D=Dv=256, window 2048) about
// 4*2048: both far above the ridge of an H100 (148 FLOP/byte for TF32 and 295 for
// bfloat16 on the tensor cores), so operations bound both paths. The float32 path does
// three TF32 products a float32 one, 3 x FLOPs at the 495 TFLOP/s TF32 peak.
//
// bfloat16: `flash_fwd_wgmma_kernel`. Operations bound it, so it runs both products on
// the tensor cores with `wgmma` and keeps the data movement off the threads that issue
// them (warp specialisation):
//   - A block owns (b, h, a tile of BQ = 128 query rows) and 384 threads: warpgroup 0 is
//     the producer, warpgroups 1 and 2 the consumers of 64 rows each. `setmaxnreg` moves
//     registers from the producer (40) to the consumers (232): a consumer thread holds
//     the (64 x Dv) float32 O accumulator (Dv/2 registers), the 64 x 64 scores (32) and P
//     in bfloat16 (16).
//   - The producer's one thread loads the Q tile once and the K and V tiles of BK = 64
//     keys into a ring of 2 stages by TMA (3-D tensor maps over (B*H, S, D), built on the
//     host per call), each in boxes of 64 columns (128 bytes, 128-byte swizzle), and
//     signals `mbarrier`s: one "full" barrier a stage for K and one for V, which the TMA
//     completes by bytes, and one "empty" barrier a stage on which the 256 consumer
//     threads arrive once they are done with it. Ragged Sq and Sk and head dims below
//     the padded 64/128/256 come in as TMA's zero fill; the mask still drops kpos >= Sk.
//   - S = Q K^T: `wgmma.m64n64k16`, both operands from shared memory through swizzled
//     descriptors (K-major), D/16 instructions a tile.
//   - Online softmax on the accumulator fragments in registers, in the log2 domain: a
//     row's max by two quad shuffles, the mask only on tiles that the diagonal, the
//     window edge or Sk cuts. A key tile wholly outside every row of the block is never
//     loaded; one wholly outside a warpgroup's rows is skipped by that warpgroup.
//   - O += P V: P goes to bfloat16 in registers, where the accumulator layout of S is the
//     A-operand layout of `wgmma`, and V is the B operand straight from its row-major tile
//     (MN-major, transposed by the instruction): no copy of P or V through shared memory.
//   - The running sum is per thread and is reduced across the quad once; O is divided by
//     the clamped denominator once and stored as bfloat16. Asked for it (an lse pointer),
//     the block also writes each row's logsumexp in float32, m ln 2 + log(l) with m the
//     log2-domain max, for the bfloat16 backward (flash_attention_bwd_bf16.cu), and (an
//     o32 pointer) the output in float32 before its rounding, from which that backward
//     takes D = rowsum(dO o O): with the bfloat16 output each row's dS would sum to
//     dO.(O - bf16(O)) instead of zero, and the keys' common component carries that into dQ
//     (seamless-m4t-large-v2's cross-attention: its ln_x, wq, wk gradients 5.7 times the
//     plain path's bfloat16-against-float32 gap from the plain path at its train shape on an
//     H100, tools/delta_probe.py). The output's bits are the same either way.
//   Shared memory at D = Dv = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB, one
//   block an SM. There is no split over keys and no atomic: a row's bits depend on its own
//   q and the keys it sees, not on B or on the other rows of its block.
//   Numerics: q.k in bfloat16 products with a float32 sum (another order than the
//   reference's); P rounded to bfloat16 before P.V (the reference keeps it in float32).
//   The wrapper pads a head dim that is no multiple of 8 (a TMA stride must be a multiple
//   of 16 bytes) with zeros.
//
// float32: `flash_fwd_tf32_kernel`, 3xTF32 on the tensor cores. One TF32 pass keeps about
// three decimal digits, which the reference's 2e-5 float32 tolerance rules out; each
// operand x is split into TF32 halves hi = tf32(x), lo = tf32(x - hi) and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi (mma_tf32.cuh), float32 accuracy (the CPU model in
// tests/test_torch_kernels.py holds it to 2e-5; one pass does not fit):
//   - A block owns (b, h, a tile of BQ = 64 query rows, a piece of their key walk) and 4
//     warps of 16 rows. Both products are mma.sync m16n8k8: S = Q K^T with Q's hi/lo A
//     fragments in registers for the whole walk (D <= 64; above, Q stays in shared memory
//     and is split as it is read), and O += P V with P taken from S's accumulator in
//     registers: with the k index of a k-step permuted (k = q <-> column or key 2q,
//     q + 4 <-> 2q + 1) a thread's accumulator pair is its A pair, no shuffle and no trip
//     through shared memory.
//   - K and V tiles of BK keys (64 up to head dims of 64, else 16) come in by 16-byte
//     `cp.async` copies (4-byte ones where D or Dv is no multiple of 4), zero-filled past
//     Sk and past D within the k-step; the next tile lands while this one is used. All
//     128 threads then split the landed tile once into hi/lo words laid out so that each
//     B fragment, hi and lo, is one conflict-free 16-byte load of two register pairs; the
//     warps that issue the products convert nothing.
//   - A warp issues in order, so the products of a k-step go in three passes (lo*hi,
//     hi*lo, hi*hi) over eight n-tiles: no product waits on the one just before it.
//   - Online softmax in float32 with accurate expf (no fast math), -1e30 masking on the
//     tiles an edge cuts, tiles wholly outside every row of a warp skipped.
//   - The grid fills the card at batch 1: items run from the last query tile (the longest
//     causal walk) to the first, and where a (batch, head) has fewer than 80 query tiles a
//     long walk is cut into pieces (flash_attention.f32_plan, a function of Sq, Sk, the
//     masks, D and Dv alone, never of B, the heads or the card). A piece writes its (m, l)
//     and unnormalised O to a float32 workspace, and `flash_merge_kernel` merges a tile's
//     pieces in piece order; no atomics, so a row's bits depend on its own q and keys.
//   - For training, the caller may pass an lse pointer: each row's logsumexp m + log(l)
//     (B, Hq, Sq) float32, written by the kernel that finishes the row (this one for a
//     walk that is not cut, the merge kernel for one that is), which the backward
//     (flash_attention_bwd.cu) recomputes the probabilities from. A null pointer writes
//     nothing and leaves the output's bits as they were.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*. The TMA
// encoder is reached through the runtime's driver entry point, so the library needs no
// -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

// Reductions over the four lanes of a quad: the lanes that hold one row of an mma
// accumulator fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync m16n8k8), fed by a cp.async ring
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;          // query rows a block: 4 warps of 16
constexpr int THREADS = 128;
constexpr int MAX_PIECES = 16;  // pieces a query tile's key walk is cut into, at most

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
// The least row stride >= cols (floats) that is r modulo 32: rows then start r banks apart.
__host__ __device__ __forceinline__ int bank_ld(int cols, int r) {
  return cols + ((r - cols) % 32 + 32) % 32;
}

// The key walk of each query tile and the split plan, the same on the host and in the
// kernels (flash_attention.f32_plan computes it in Python).
struct Walk {
  int sq, sk, causal, window, bk, split_tiles;

  __host__ __device__ int q_tiles() const { return (sq + BQ - 1) / BQ; }
  // Key tiles that some row of query tile qt can see, from *k_begin: no other is loaded.
  __host__ __device__ int key_tiles(int qt, int* k_begin) const {
    const int offset = sk - sq;  // right-aligned query positions
    const int qpos_first = qt * BQ + offset;
    const int qpos_last = imin(qt * BQ + BQ, sq) - 1 + offset;
    const int k_end = causal ? imin(sk, qpos_last + 1) : sk;
    *k_begin = (window > 0 ? imax(0, qpos_first - window + 1) : 0) / bk * bk;
    return (k_end - *k_begin + bk - 1) / bk;
  }
  __host__ __device__ int pieces(int tiles) const {
    return (tiles + split_tiles - 1) / split_tiles;
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a row-major (n, cols) float32 matrix into shared rows of ld
// floats: 16-byte copies (VEC) or 4-byte ones; rows past n are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0,
                                          int rows, int n, int cols) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  const int per_row = cols / W;
  // chunk i = r * per_row + c, walked as (r, c) without a division a chunk
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  const int dr = THREADS / per_row, dc = THREADS - dr * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      ++r;
      if (r >= rows) break;
    }
    const bool in = row0 + r < n;
    const float* s = src + (size_t)(in ? row0 + r : 0) * cols + c * W;
    if constexpr (VEC) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + r * ld + c * W)),
                   "l"(s), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_u32(dst + r * ld + c)),
                   "l"(s), "r"(in ? 4 : 0)
                   : "memory");
    }
  }
}

// Zeros in columns [c0, c1) of `rows` shared rows of ld floats: the pad of a k-step or an
// n-tile, which no copy writes.
__device__ __forceinline__ void zero_cols(float* dst, int ld, int rows, int c0, int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < rows * w; i += THREADS) dst[(i / w) * ld + c0 + i % w] = 0.f;
}

// Shared memory of a block, in 4-byte words (d8, dv8: D and Dv rounded up to 8):
//   Q    BQ x d8 floats (rows of ldq = 8 mod 32), when Q is not held in registers;
//   raw  the K and V rows of one tile as copied, BK x d8 and BK x dv8 floats;
//   K2   the tile's K split: row `key`, words 4p + (0, 1, 2, 3) = hi of columns 2p and 2p + 1,
//        then lo of the same two; a row is ldk2 = 16 (mod 32) words;
//   V2   the tile's V split by pairs of keys: row kp, words 4n + (0, 1, 2, 3) = hi of
//        V[2kp][n] and V[2kp + 1][n], then lo of the same two; a row is ldv2 = 8 (mod 32).
// Each B fragment of the two products, hi and lo, is then one conflict-free 16-byte load
// whose halves are the register pairs the mma takes, with no conversion in the warps that
// issue the products. With Q in registers, Q's tile is staged in the K2 words before the
// first tile is split.
struct Smem {
  int ldq, ldkr, ldvr, ldk2, ldv2;
  size_t q, kr, vr, k2, v2, total;  // offsets and total, in 4-byte words

  __host__ __device__ Smem(int bk, int d, int dv, bool q_regs) {
    const int d8 = round8(d), dv8 = round8(dv);
    ldq = bank_ld(d8, 8);
    ldkr = d8 + 4;
    ldvr = dv8 + 4;
    ldk2 = bank_ld(2 * d8, 16);
    ldv2 = bank_ld(4 * dv8, 8);
    kr = q_regs ? 0 : (size_t)BQ * ldq;
    vr = kr + (size_t)bk * ldkr;
    k2 = vr + (size_t)bk * ldvr;
    v2 = k2 + (size_t)bk * ldk2;
    size_t end = v2 + (size_t)(bk / 2) * ldv2;
    q = q_regs ? k2 : 0;
    if (q_regs && q + (size_t)BQ * ldq > end) end = q + (size_t)BQ * ldq;
    total = end;
  }
};

// The raw tile into its split form (all threads of the block).
__device__ __forceinline__ void split_tile(const float* kr, const float* vr, uint32_t* k2,
                                           uint32_t* v2, const Smem& L, int bk, int d8,
                                           int dv8) {
  const int kq = d8 / 4;  // 4 K columns an item
#pragma unroll 4
  for (int i = threadIdx.x; i < bk * kq; i += THREADS) {
    const int key = i / kq, c = (i - key * kq) * 4;
    const float4 x = *reinterpret_cast<const float4*>(kr + key * L.ldkr + c);
    const Tf32x2 a = split(x.x), b = split(x.y), e = split(x.z), f = split(x.w);
    uint4* dst = reinterpret_cast<uint4*>(k2 + key * L.ldk2 + 2 * c);
    dst[0] = make_uint4(a.hi, b.hi, a.lo, b.lo);
    dst[1] = make_uint4(e.hi, f.hi, e.lo, f.lo);
  }
  const int vq = dv8 / 4;  // 4 V columns of a pair of keys an item
#pragma unroll 2
  for (int i = threadIdx.x; i < (bk / 2) * vq; i += THREADS) {
    const int kp = i / vq, n = (i - kp * vq) * 4;
    const float4 x = *reinterpret_cast<const float4*>(vr + (2 * kp) * L.ldvr + n);
    const float4 y = *reinterpret_cast<const float4*>(vr + (2 * kp + 1) * L.ldvr + n);
    uint4* dst = reinterpret_cast<uint4*>(v2 + kp * L.ldv2 + 4 * n);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const Tf32x2 a = split(xs[u]), b = split(ys[u]);
      dst[u] = make_uint4(a.hi, b.hi, a.lo, b.lo);
    }
  }
}

// Q's A fragment of k-step kk for rows lr0 and lr0 + 8 of the tile, hi and lo, from Q's
// rows in shared memory. The k index of a k-step is permuted (k = q <-> column 2q, q + 4
// <-> 2q + 1) so that a thread's two columns are adjacent; K's B fragments follow the
// same order.
__device__ __forceinline__ void q_fragment(const float* qs, int ldq, int lr0, int kk, int qd,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(qs + lr0 * ldq + kk * 8 + 2 * qd);
  const float2 x1 = *reinterpret_cast<const float2*>(qs + (lr0 + 8) * ldq + kk * 8 + 2 * qd);
  const float xs[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32x2 s = split(xs[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

// BK keys a tile; DVT: n-tiles of 8 value columns a warp holds (Dv <= 8 DVT); Q_REGS: Q's
// hi/lo fragments in registers for the whole walk (D <= 64), else Q in shared memory, split
// as it is read; VEC: 16-byte copies (D and Dv multiples of 4, 16-byte aligned pointers).
template <int BK, int DVT, bool Q_REGS, bool VEC>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ part, float* __restrict__ lse, int hq, int hkv,
                          int d, int dv, Walk walk, float scale) {
  constexpr int NT = BK / 8;                // n-tiles of S, k-steps of P V
  constexpr int SETS = Q_REGS ? 1 : 2;      // sums of S taking alternate k-steps
  extern __shared__ __align__(16) float smem[];
  const int d8 = round8(d), dv8 = round8(dv);
  const Smem L(BK, d, dv, Q_REGS);
  float* qs = smem + L.q;
  float* kr = smem + L.kr;
  float* vr = smem + L.vr;
  uint32_t* k2 = reinterpret_cast<uint32_t*>(smem + L.k2);
  uint32_t* v2 = reinterpret_cast<uint32_t*>(smem + L.v2);
  const int h = blockIdx.y, b = blockIdx.z;
  const int sq = walk.sq, sk = walk.sk, causal = walk.causal, window = walk.window;

  // This block's query tile and piece of its key walk. Items run from the last query tile
  // (the longest walk under a causal mask) to the first.
  int qt = walk.q_tiles() - 1, item = blockIdx.x, k_begin = 0;
  int n_tiles = walk.key_tiles(qt, &k_begin), n_pieces = walk.pieces(n_tiles);
  while (item >= n_pieces) {
    item -= n_pieces;
    --qt;
    n_tiles = walk.key_tiles(qt, &k_begin);
    n_pieces = walk.pieces(n_tiles);
  }
  const int t_begin = item * n_tiles / n_pieces, t_end = (item + 1) * n_tiles / n_pieces;

  const int q0 = qt * BQ, offset = sk - sq;
  const int hk = h / (hq / hkv);
  const float* qb = q + ((size_t)b * hq + h) * (size_t)sq * d;
  const float* kb = k + ((size_t)b * hkv + hk) * (size_t)sk * d;
  const float* vb = v + ((size_t)b * hkv + hk) * (size_t)sk * dv;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;  // this thread's rows in the tile
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int r_lo = q0 + 16 * warp;  // the warp's rows, for the tile tests (warp-uniform)
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + offset, qpos_hi = imin(r_lo + 16, sq) - 1 + offset;
  const int qpos0 = row0 + offset, qpos1 = row1 + offset;
  const int nks = d8 / 8, nvt = dv8 / 8;

  // Q, K and V of the first tile in one group of copies; the pads no copy writes are zeros
  zero_cols(qs, L.ldq, BQ, d, d8);
  zero_cols(kr, L.ldkr, BK, d, d8);
  zero_cols(vr, L.ldvr, BK, dv, dv8);
  load_rows<VEC>(qs, L.ldq, qb, q0, BQ, sq, d);
  load_rows<VEC>(kr, L.ldkr, kb, k_begin + t_begin * BK, BK, sk, d);
  load_rows<VEC>(vr, L.ldvr, vb, k_begin + t_begin * BK, BK, sk, dv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qh[Q_REGS ? 8 : 1][4], ql[Q_REGS ? 8 : 1][4];  // Q's fragments, hi and lo
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nks) q_fragment(qs, L.ldq, lr0, kk, qd, qh[kk], ql[kk]);
    }
    __syncthreads();  // Q's words are K2's: every warp has its fragments
  }

  float acc[DVT][4];
#pragma unroll
  for (int nt = 0; nt < DVT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of each row
  float l0 = 0.f, l1 = 0.f;          // running sum of this thread's columns

  // One raw tile and one split tile: the copy of tile t + 1 lands while tile t is used,
  // then all threads split it.
  split_tile(kr, vr, k2, v2, L, BK, d8, dv8);
  __syncthreads();
  if (t_begin + 1 < t_end) {
    load_rows<VEC>(kr, L.ldkr, kb, k_begin + (t_begin + 1) * BK, BK, sk, d);
    load_rows<VEC>(vr, L.ldvr, vb, k_begin + (t_begin + 1) * BK, BK, sk, dv);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = k_begin + t * BK;
    const bool skip = !rows_live || (causal && k0 > qpos_hi) ||
                      (window > 0 && k0 + BK - 1 <= qpos_lo - window);
    if (!skip) {
      // S = Q K^T. One sum an n-tile (and SETS of them taking alternate k-steps when the
      // tile is narrow); the three products of a k-step go in three passes over the
      // n-tiles, so that no product waits on the one before it.
      float sc[SETS][NT][4];
#pragma unroll
      for (int u = 0; u < SETS; ++u) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][nt][e] = 0.f;
        }
      }
      auto s_step = [&](const uint32_t(&ah)[4], const uint32_t(&al)[4], int kk,
                        float(&c)[NT][4]) {
        uint4 kb4[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          kb4[nt] = *reinterpret_cast<const uint4*>(k2 + (nt * 8 + g) * L.ldk2 + 16 * kk + 4 * qd);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(c[nt], al[0], al[1], al[2], al[3], kb4[nt].x, kb4[nt].y);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(c[nt], ah[0], ah[1], ah[2], ah[3], kb4[nt].z, kb4[nt].w);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(c[nt], ah[0], ah[1], ah[2], ah[3], kb4[nt].x, kb4[nt].y);
      };
      if constexpr (Q_REGS) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk < nks) s_step(qh[kk], ql[kk], kk, sc[0]);
        }
      } else {
        int kk = 0;
        for (; kk + SETS <= nks; kk += SETS) {
#pragma unroll
          for (int u = 0; u < SETS; ++u) {
            uint32_t ah[4], al[4];
            q_fragment(qs, L.ldq, lr0, kk + u, qd, ah, al);
            s_step(ah, al, kk + u, sc[u]);
          }
        }
        if (kk < nks) {
          uint32_t ah[4], al[4];
          q_fragment(qs, L.ldq, lr0, kk, qd, ah, al);
          s_step(ah, al, kk, sc[0]);
        }
#pragma unroll
        for (int u = 1; u < SETS; ++u) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[0][nt][e] += sc[u][nt][e];
          }
        }
      }
      float(&s)[NT][4] = sc[0];

      // scale; mask only a tile that an edge cuts; online softmax with accurate expf
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qpos_lo) ||
                        (window > 0 && k0 <= qpos_hi - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[nt][e] * scale;
          float x1 = s[nt][2 + e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * nt + 2 * qd + e;
            const bool in = kpos < sk;
            if (!(in && (!causal || kpos <= qpos0) && (window <= 0 || kpos > qpos0 - window)))
              x0 = NEG_INF;
            if (!(in && (!causal || kpos <= qpos1) && (window <= 0 || kpos > qpos1 - window)))
              x1 = NEG_INF;
          }
          s[nt][e] = x0;
          s[nt][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = expf(m0 - mn0);
      const float alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = expf(s[nt][e] - mn0);
          s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
          rs0 += s[nt][e];
          rs1 += s[nt][2 + e];
        }
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int nt = 0; nt < DVT; ++nt) {
        acc[nt][0] *= alpha0;
        acc[nt][1] *= alpha0;
        acc[nt][2] *= alpha1;
        acc[nt][3] *= alpha1;
      }

      // O += P V. P stays in registers: S's accumulator fragment of keys 8j..8j+7 is the A
      // fragment of k-step j once the k index is permuted as for S (k = q <-> key 2q,
      // q + 4 <-> 2q + 1); V2 holds the B fragments in that order. Eight n-tiles at a
      // time, three passes.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        const float ps[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Tf32x2 x = split(ps[e]);
          ph[e] = x.hi;
          pl[e] = x.lo;
        }
        const uint32_t* vrow = v2 + (4 * j + qd) * L.ldv2 + 4 * g;
#pragma unroll
        for (int n0 = 0; n0 < DVT; n0 += 8) {
          if (n0 < nvt) {
            uint4 vb4[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (n0 + u < nvt) vb4[u] = *reinterpret_cast<const uint4*>(vrow + 32 * (n0 + u));
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (n0 + u < nvt)
                mma_tf32(acc[n0 + u], pl[0], pl[1], pl[2], pl[3], vb4[u].x, vb4[u].y);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (n0 + u < nvt)
                mma_tf32(acc[n0 + u], ph[0], ph[1], ph[2], ph[3], vb4[u].z, vb4[u].w);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (n0 + u < nvt)
                mma_tf32(acc[n0 + u], ph[0], ph[1], ph[2], ph[3], vb4[u].x, vb4[u].y);
          }
        }
      }
    }
    if (t + 1 < t_end) {  // split the next tile once it has landed and this one is done
      cp_async_wait<0>();
      __syncthreads();
      split_tile(kr, vr, k2, v2, L, BK, d8, dv8);
      __syncthreads();
      if (t + 2 < t_end) {
        load_rows<VEC>(kr, L.ldkr, kb, k_begin + (t + 2) * BK, BK, sk, d);
        load_rows<VEC>(vr, L.ldvr, vb, k_begin + (t + 2) * BK, BK, sk, dv);
        cp_async_commit();
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (!rows_live) return;
  if (n_pieces == 1) {  // the whole walk: normalise (one division a row) and store
    const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
    float* ob = o + ((size_t)b * hq + h) * (size_t)sq * dv;
#pragma unroll
    for (int nt = 0; nt < DVT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * qd + e;
        if (nt >= nvt || col >= dv) continue;
        if (row0 < sq) ob[(size_t)row0 * dv + col] = acc[nt][e] * inv0;
        if (row1 < sq) ob[(size_t)row1 * dv + col] = acc[nt][2 + e] * inv1;
      }
    }
    if (lse != nullptr && qd == 0) {
      float* lb = lse + ((size_t)b * hq + h) * (size_t)sq;
      if (row0 < sq) lb[row0] = m0 + logf(l0);
      if (row1 < sq) lb[row1] = m1 + logf(l1);
    }
    return;
  }
  // One piece of a split walk: its (m, l) and unnormalised O, for the merge kernel.
  const size_t slot = ((size_t)b * hq + h) * gridDim.x + blockIdx.x;
  float* po = part + slot * BQ * dv8;
  float* pml = part + (size_t)gridDim.z * hq * gridDim.x * BQ * dv8 + slot * BQ * 2;
  if (qd == 0) {
    pml[2 * lr0] = m0;
    pml[2 * lr0 + 1] = l0;
    pml[2 * lr1] = m1;
    pml[2 * lr1 + 1] = l1;
  }
#pragma unroll
  for (int nt = 0; nt < DVT; ++nt) {
    if (nt >= nvt) continue;
    *reinterpret_cast<float2*>(po + lr0 * dv8 + 8 * nt + 2 * qd) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(po + lr1 * dv8 + 8 * nt + 2 * qd) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Merges the pieces of each split query tile in piece order: M = max m, w = exp(m - M),
// O = sum w O / max(sum w l, 1e-37), and with an lse pointer M + log(sum w l). One block
// per (query tile, head, batch); a tile that was walked whole has nothing to merge.
__global__ void __launch_bounds__(THREADS)
    flash_merge_kernel(const float* __restrict__ part, float* __restrict__ o,
                       float* __restrict__ lse, int hq, int dv, Walk walk, int n_items) {
  __shared__ float wgt[MAX_PIECES][BQ];
  __shared__ float den[BQ];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_qt = walk.q_tiles(), qt = blockIdx.x;
  int first = 0, kb;
  for (int t = n_qt - 1; t > qt; --t) first += walk.pieces(walk.key_tiles(t, &kb));
  const int np = walk.pieces(walk.key_tiles(qt, &kb));
  if (np == 1) return;
  const int dv8 = round8(dv);
  const size_t slot0 = ((size_t)b * hq + h) * n_items + first;
  const float* po = part + slot0 * BQ * dv8;
  const float* pml = part + (size_t)gridDim.z * hq * n_items * BQ * dv8 + slot0 * BQ * 2;
  if (tid < BQ) {
    float ms[MAX_PIECES], ls[MAX_PIECES];  // every piece's (m, l) loaded before any is used
#pragma unroll
    for (int s = 0; s < MAX_PIECES; ++s) {
      if (s < np) {
        ms[s] = pml[(size_t)s * BQ * 2 + 2 * tid];
        ls[s] = pml[(size_t)s * BQ * 2 + 2 * tid + 1];
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_PIECES; ++s)
      if (s < np) mx = fmaxf(mx, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_PIECES; ++s) {
      if (s < np) {
        const float w = expf(ms[s] - mx);
        wgt[s][tid] = w;
        l += w * ls[s];
      }
    }
    den[tid] = fmaxf(l, 1e-37f);
    if (lse != nullptr && qt * BQ + tid < walk.sq)
      lse[((size_t)b * hq + h) * walk.sq + qt * BQ + tid] = mx + logf(l);
  }
  __syncthreads();
  // a thread 4 columns of a row; the pieces' values are loaded before they are summed
  const int q0 = qt * BQ, rows = imin(BQ, walk.sq - q0), quads = dv8 / 4;
  float* ob = o + (((size_t)b * hq + h) * walk.sq + q0) * dv;
  for (int i = tid; i < rows * quads; i += THREADS) {
    const int r = i / quads, c = (i - r * quads) * 4;
    float4 x[MAX_PIECES];
#pragma unroll
    for (int s = 0; s < MAX_PIECES; ++s)
      if (s < np) x[s] = *reinterpret_cast<const float4*>(po + (size_t)s * BQ * dv8 + r * dv8 + c);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < MAX_PIECES; ++s) {
      if (s < np) {
        const float w = wgt[s][r];
        a[0] += w * x[s].x;
        a[1] += w * x[s].y;
        a[2] += w * x[s].z;
        a[3] += w * x[s].w;
      }
    }
    const float inv = 1.f / den[r];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < dv) ob[(size_t)r * dv + c + e] = a[e] * inv;
  }
}

template <int BK, int DVT, bool Q_REGS, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, void* part, void* lse, int b,
           int hq, int hkv, int d, int dv, const Walk& walk, int n_items, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Smem(BK, d, dv, Q_REGS).total;
  auto kernel = flash_fwd_tf32_kernel<BK, DVT, Q_REGS, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_items, hq, b), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(part), static_cast<float*>(lse), hq, hkv, d, dv,
      walk, scale);
  return (int)cudaGetLastError();
}

template <int BK, int DVT, bool Q_REGS>
int launch_vec(bool vec, const void* q, const void* k, const void* v, void* o, void* part,
               void* lse, int b, int hq, int hkv, int d, int dv, const Walk& walk, int n_items,
               float scale, cudaStream_t stream) {
  if (vec)
    return launch<BK, DVT, Q_REGS, true>(q, k, v, o, part, lse, b, hq, hkv, d, dv, walk,
                                         n_items, scale, stream);
  return launch<BK, DVT, Q_REGS, false>(q, k, v, o, part, lse, b, hq, hkv, d, dv, walk,
                                        n_items, scale, stream);
}

// Key tiles of 64 with Q in registers for head dims up to 64; tiles of 16 with Q in shared
// memory above (flash_attention.f32_key_block). split_tiles and n_items are the wrapper's
// plan; a plan that does not fit these shapes is refused.
int run(const void* q, const void* k, const void* v, void* o, void* part, void* lse, int b,
        int hq, int hkv, int sq, int sk, int d, int dv, int causal, int window, float scale,
        int split_tiles, int n_items, cudaStream_t stream) {
  const bool small = d <= 64 && dv <= 64;
  const Walk walk{sq, sk, causal, window > 0 ? window : 0, small ? 64 : 16, split_tiles};
  if (split_tiles < 1) return (int)cudaErrorInvalidValue;
  int items = 0, most = 0, kb;
  for (int t = 0; t < walk.q_tiles(); ++t) {
    const int tiles = walk.key_tiles(t, &kb);
    if (tiles < 1) return (int)cudaErrorInvalidValue;
    items += walk.pieces(tiles);
    most = imax(most, walk.pieces(tiles));
  }
  if (items != n_items || most > MAX_PIECES || (most > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  const bool vec = d % 4 == 0 && dv % 4 == 0 && any % 16 == 0;
#define REPRO_LAUNCH(BK, DVT, Q_REGS)                                                         \
  launch_vec<BK, DVT, Q_REGS>(vec, q, k, v, o, part, lse, b, hq, hkv, d, dv, walk, n_items, \
                              scale, stream)
  const int err = small ? REPRO_LAUNCH(64, 8, true)
                        : (dv <= 128 ? REPRO_LAUNCH(16, 16, false) : REPRO_LAUNCH(16, 32, false));
#undef REPRO_LAUNCH
  if (err != 0 || most == 1) return err;
  flash_merge_kernel<<<dim3(walk.q_tiles(), hq, b), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(o), static_cast<float*>(lse), hq, dv,
      walk, n_items);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma on tensor cores, fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int BQ = 128;          // query rows a block: two consumer warpgroups of 64
constexpr int BK = 64;           // keys a tile
constexpr int STAGES = 2;        // K/V tiles in flight
constexpr int COLS = 64;         // head-dim columns a TMA box: 128 bytes, the swizzle span
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 = 65536 - 1024
constexpr uint32_t ROW_BYTES = COLS * 2;                // one row of a box
constexpr uint32_t Q_CHUNK = BQ * ROW_BYTES;            // 16 KB: 128 rows x 64 columns
constexpr uint32_t KV_CHUNK = BK * ROW_BYTES;           // 8 KB: 64 keys x 64 columns
constexpr uint32_t GROUP_BYTES = 8 * ROW_BYTES;         // 8 rows: one swizzle atom
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DC, DVC: 64-column chunks of D and Dv (1, 2 or 4). Shared memory, 1024-byte aligned:
// Q (DC chunks of 128 x 64), K (STAGES x DC chunks of 64 x 64), V (STAGES x DVC chunks),
// then the barriers.
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                           float* __restrict__ o32, int hq, int hkv, int sq, int sk, int dv,
                           int causal, int window, float scale_log2) {
  constexpr uint32_t K_BYTES = DC * KV_CHUNK;
  constexpr uint32_t V_BYTES = DVC * KV_CHUNK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + DC * Q_CHUNK;
  const uint32_t v_s = k_s + STAGES * K_BYTES;
  const uint32_t bars = v_s + STAGES * V_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest key ranges start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = sk - sq;  // right-aligned query positions

  // Key tiles any row of this block can see; the others are never loaded.
  const int qpos_first = q0 + offset;
  const int qpos_last = min(q0 + BQ, sq) - 1 + offset;
  const int k_end = causal ? min(sk, qpos_last + 1) : sk;
  const int k_begin = (window > 0 ? max(0, qpos_first - window + 1) : 0) / BK * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int q_bh = b * hq + h;
      const int kv_bh = b * hkv + h / (hq / hkv);
      mbar_expect_tx(q_full, DC * Q_CHUNK);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(q_s + c * Q_CHUNK, &q_map, q_full, c * COLS, q0, q_bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
        const int k0 = k_begin + t * BK;
        mbar_expect_tx(k_full(s), K_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(k_s + s * K_BYTES + c * KV_CHUNK, &k_map, k_full(s), c * COLS, k0, kv_bh);
        mbar_expect_tx(v_full(s), V_BYTES);
#pragma unroll
        for (int c = 0; c < DVC; ++c)
          tma_load(v_s + s * V_BYTES + c * KV_CHUNK, &v_map, v_full(s), c * COLS, k0, kv_bh);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int quad_col = 2 * (lane % 4);
    // this thread's two rows (wgmma fragment: warp w holds rows 16w..16w+15)
    const int row0 = q0 + 64 * cw + 16 * (tid / 32) + lane / 4;
    const int row1 = row0 + 8;
    const int qpos0 = row0 + offset;
    const int qpos1 = row1 + offset;
    // the warpgroup's rows that exist, for the tile tests (uniform in the warpgroup)
    const int r_lo = q0 + 64 * cw;
    const bool rows_live = r_lo < sq;
    const int qpos_lo = r_lo + offset;
    const int qpos_hi = min(r_lo + 64, sq) - 1 + offset;

    float acc[DVC][32];
#pragma unroll
    for (int c = 0; c < DVC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    }
    float m0 = NEG_INF, m1 = NEG_INF;  // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;          // running sum of this thread's columns
    const uint32_t q_wg = q_s + cw * 64 * ROW_BYTES;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = k_begin + t * BK;
      const bool skip = !rows_live || (causal && k0 > qpos_hi) ||
                        (window > 0 && k0 + BK - 1 <= qpos_lo - window);
      uint32_t p[4][4];  // P in bfloat16: the A operand of four k-steps of 16 keys

      mbar_wait(k_full(s), parity);
      if (!skip) {
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < DC; ++c) {
#pragma unroll
          for (int kk = 0; kk < COLS / 16; ++kk) {
            const uint64_t da = kmajor_bf16_desc(q_wg + c * Q_CHUNK + kk * 32);
            const uint64_t db = kmajor_bf16_desc(k_s + s * K_BYTES + c * KV_CHUNK + kk * 32);
            wgmma_bf16_ss(sc, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);

        // scale to the log2 domain; mask only a tile that an edge cuts
        const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qpos_lo) ||
                          (window > 0 && k0 <= qpos_hi - window);
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x0 = sc[4 * i + e] * scale_log2;
            float x1 = sc[4 * i + 2 + e] * scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * i + quad_col + e;
              const bool in = kpos < sk;
              if (!(in && (!causal || kpos <= qpos0) && (window <= 0 || kpos > qpos0 - window)))
                x0 = NEG_INF;
              if (!(in && (!causal || kpos <= qpos1) && (window <= 0 || kpos > qpos1 - window)))
                x1 = NEG_INF;
            }
            sc[4 * i + e] = x0;
            sc[4 * i + 2 + e] = x1;
            mx0 = fmaxf(mx0, x0);
            mx1 = fmaxf(mx1, x1);
          }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float alpha0 = exp2f(m0 - mn0);
        const float alpha1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * i + e] = exp2f(sc[4 * i + e] - mn0);
            sc[4 * i + 2 + e] = exp2f(sc[4 * i + 2 + e] - mn1);
            rs0 += sc[4 * i + e];
            rs1 += sc[4 * i + 2 + e];
          }
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
#pragma unroll
        for (int c = 0; c < DVC; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[c][4 * i] *= alpha0;
            acc[c][4 * i + 1] *= alpha0;
            acc[c][4 * i + 2] *= alpha1;
            acc[c][4 * i + 3] *= alpha1;
          }
        }
        // S's accumulator fragment of keys 16j..16j+15 is the A fragment of k-step j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
        }
      }

      mbar_wait(v_full(s), parity);
      if (!skip) {
#pragma unroll
        for (int c = 0; c < DVC; ++c) pin(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < DVC; ++c)
            wgmma_bf16_rs_mn(
                acc[c], p[j],
                mnmajor_bf16_desc(v_s + s * V_BYTES + c * KV_CHUNK + j * 2 * GROUP_BYTES));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < DVC; ++c) pin(acc[c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) pin(p[j]);
      }
      mbar_arrive(empty(s));  // this thread is done with stage s
    }

    if (rows_live) {
      const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
      const float den0 = fmaxf(sum0, 1e-37f);
      const float den1 = fmaxf(sum1, 1e-37f);
      __nv_bfloat16* ob = o + ((size_t)b * hq + h) * (size_t)sq * dv;
#pragma unroll
      for (int c = 0; c < DVC; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = c * COLS + 8 * i + quad_col;
          if (col >= dv) continue;
          if (row0 < sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * dv + col) =
                __floats2bfloat162_rn(acc[c][4 * i] / den0, acc[c][4 * i + 1] / den0);
          if (row1 < sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * dv + col) =
                __floats2bfloat162_rn(acc[c][4 * i + 2] / den1, acc[c][4 * i + 3] / den1);
        }
      }
      // the same values in float32, unrounded, where the backward asks for them
      if (o32 != nullptr) {
        float* of = o32 + ((size_t)b * hq + h) * (size_t)sq * dv;
#pragma unroll
        for (int c = 0; c < DVC; ++c) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = c * COLS + 8 * i + quad_col;
            if (col >= dv) continue;
            if (row0 < sq)
              *reinterpret_cast<float2*>(of + (size_t)row0 * dv + col) =
                  make_float2(acc[c][4 * i] / den0, acc[c][4 * i + 1] / den0);
            if (row1 < sq)
              *reinterpret_cast<float2*>(of + (size_t)row1 * dv + col) =
                  make_float2(acc[c][4 * i + 2] / den1, acc[c][4 * i + 3] / den1);
          }
        }
      }
      // each row's logsumexp in natural units, as the float32 path writes it: the running max
      // back from the log2 domain, plus the log of the row's sum
      if (lse != nullptr && lane % 4 == 0) {
        float* lb = lse + ((size_t)b * hq + h) * (size_t)sq;
        if (row0 < sq) lb[row0] = m0 * LN2 + logf(sum0);
        if (row1 < sq) lb[row1] = m1 * LN2 + logf(sum1);
      }
    }
  }
}

// A (B*H, rows, cols) bfloat16 tensor as a 3-D tensor map; boxes of (1, box_rows, COLS),
// 128-byte swizzle, zeros outside the tensor. cols must be a multiple of 8.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DC, int DVC>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
           void* lse, void* o32, int b, int hq, int hkv, int sq, int sk, int dv, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      1024 + DC * Q_CHUNK + STAGES * (DC + DVC) * KV_CHUNK + 8 * (1 + 3 * STAGES);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DC, DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_wgmma_kernel<DC, DVC><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<float*>(o32), hq, hkv, sq, sk, dv, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_dv(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
              void* lse, void* o32, int b, int hq, int hkv, int sq, int sk, int dv, int causal,
              int window, float scale, cudaStream_t stream) {
#define REPRO_LAUNCH(DVC) \
  launch<DC, DVC>(qm, km, vm, o, lse, o32, b, hq, hkv, sq, sk, dv, causal, window, scale, stream)
  if (dv <= 64) return REPRO_LAUNCH(1);
  if (dv <= 128) return REPRO_LAUNCH(2);
  return REPRO_LAUNCH(4);
#undef REPRO_LAUNCH
}

int run(const void* q, const void* k, const void* v, void* o, void* lse, void* o32, int b,
        int hq, int hkv, int sq, int sk, int d, int dv, int causal, int window, float scale,
        cudaStream_t stream) {
  if (d % 8 != 0 || dv % 8 != 0) return (int)cudaErrorInvalidValue;  // TMA strides: 16 bytes
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;  // TMA base addresses
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map(&qm, q, b * hq, sq, d, BQ);
  if (err == cudaSuccess) err = make_map(&km, k, b * hkv, sk, d, BK);
  if (err == cudaSuccess) err = make_map(&vm, v, b * hkv, sk, dv, BK);
  if (err != cudaSuccess) return (int)err;
#define REPRO_LAUNCH(DC) \
  launch_dv<DC>(qm, km, vm, o, lse, o32, b, hq, hkv, sq, sk, dv, causal, window, scale, stream)
  if (d <= 64) return REPRO_LAUNCH(1);
  if (d <= 128) return REPRO_LAUNCH(2);
  return REPRO_LAUNCH(4);
#undef REPRO_LAUNCH
}

}  // namespace bf16

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o (B,Hq,Sq,Dv), all contiguous and of
// one dtype (is_bf16: 0 float32 on the 3xTF32 path, 1 bfloat16 on the wgmma path, which
// also needs D and Dv multiples of 8 and 16-byte aligned pointers). window <= 0 means no
// window. float32 only: split_tiles and n_items are the wrapper's split plan (key tiles a
// piece of a query tile's walk, pieces of every query tile together; the call is refused
// if they do not fit the shapes), and workspace is float32 scratch of at least
// B*Hq*n_items*64*(round8(Dv) + 2) elements when some walk is split, else may be null. lse,
// when not null, receives each row's logsumexp (B, Hq, Sq) float32, in both dtypes; o32, when
// not null (bfloat16 only), the output (B, Hq, Sq, Dv) in float32 before its rounding. The
// caller has checked 1 <= D, Dv <= 256, Hq % Hkv == 0 and the grid limits. Returns the
// cudaError_t of the launches (0 on success). Does not synchronise.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                              void* workspace, void* lse, void* o32, int b, int hq, int hkv,
                              int sq, int sk, int d, int dv, int causal, int window, float scale,
                              int split_tiles, int n_items, int is_bf16, void* stream) {
  if (d < 1 || d > MAX_D || dv < 1 || dv > MAX_D || hkv < 1 || hq % hkv != 0 ||
      (o32 != nullptr && (!is_bf16 || reinterpret_cast<uintptr_t>(o32) % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bf16::run(q, k, v, o, lse, o32, b, hq, hkv, sq, sk, d, dv, causal, window, scale, s);
  return f32::run(q, k, v, o, workspace, lse, b, hq, hkv, sq, sk, d, dv, causal, window, scale,
                  split_tiles, n_items, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
