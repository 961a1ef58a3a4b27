// Flash-attention backward for Hopper (sm_90a): float32 in 3xTF32 on the tensor cores.
//
// Replaces the backward of the TPU kernel: `_vjp_bwd` in src/repro/kernels/flash_attention.py,
// the custom VJP of `flash_attention_pallas` (jax.vjp of the blocked plain forward; plain jnp,
// not a Pallas kernel). Same function: dQ, dK and dV of online-softmax attention with causal
// and local-window masks on right-aligned query positions (qpos = i + Sk - Sq), GQA/MQA
// through the KV head h / (Hq / Hkv), a value head dim that may differ from the key head dim,
// ragged Sq and Sk masked in the kernels (no padding copy).
//
// The FlashAttention-2 form, from the forward's output O and each row's logsumexp lse (which
// flash_attention_fwd.cu writes when asked):
//   D = rowsum(dO o O);  P = exp(S scale - lse);  dV = P^T dO;  dP = dO V^T;
//   dS = P o (dP - D);   dQ = dS K scale;         dK = dS^T Q scale.
// Three launches. Each output element is summed in a fixed order and written once: no
// atomics, so two launches give the same bits and a batch row's gradients do not depend on
// the batch it is in.
//   - flash_bwd_delta_kernel: D, one warp a row.
//   - dK and dV: one block per (tile of keys, KV head, batch). It walks the g = Hq / Hkv query
//     heads of its group in order and, for each, the tiles of query rows that some of its keys
//     are visible to, recomputing S^T = K Q^T and dP^T = V dO^T. dK and dV stay in registers
//     over the whole walk (the sum over the GQA group in a fixed order) and are written once;
//     a key tile that no query sees writes zeros. Blocks start from the first key tile (the
//     longest causal walk) to the last.
//   - dQ: one block per (tile of query rows, query head, batch), walking the tiles of keys its
//     rows see (the forward's walk) and recomputing S and dP; dQ stays in registers and is
//     written once. Blocks start from the last query tile (the longest causal walk) to the
//     first. Which block runs when never changes the order of a sum.
//
// What bounds it. Five products over the (query, key) pairs the masks keep, 2 pairs (3D + 2Dv)
// FLOPs a head, against one read of q, k, v, o, dO, lse and one write of dq, dk, dv: at the
// demo's train shape (B 4, Hq 12, Hkv 4, S 4096, D = Dv = 64, causal) about S/2 FLOPs a
// byte, far above the card's ridge, so operations bound it. Each product is three TF32 ones,
// 3 x FLOPs at the 495 TFLOP/s TF32 peak. Recomputing S and dP in the dQ kernel adds two
// products (seven in all): the price of writing dQ without atomics.
//
// Numerics (both paths). Every product is three TF32 products on the tensor cores (each
// operand split into TF32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi, mma_tf32.cuh's split):
// float32 accuracy, as the forward's float32 path. dQ, dK and dV sum over the whole walk in two
// levels: each walk tile's product from zero in the tensor cores, then a float32 add into
// registers (the tensor cores' float32 sums do not round to nearest: summed in them alone
// across the 12,288 query rows of a group at the train shape, dK and dV come out 3e-4 to 6e-4
// off float64, a hundred times the plain backward's error). expf is accurate (no fast math).
//
// wgmma path (`wg`, flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel): head dims D
// and Dv up to 64 and multiples of 4, the demo's training. Warp-specialised, as the bfloat16
// forward:
//   - A block owns ROWS = 128 rows (keys in dK/dV, query rows in dQ) and 384 threads:
//     warpgroup 0 is the producer, warpgroups 1 and 2 the consumers of 64 owned rows each
//     (`setmaxnreg` 24 / 240). At its start the consumers split the owned rows (K and V, or
//     Q and dO) once into TF32 hi and lo in shared memory, in wgmma's K-major 128-byte-swizzled
//     layout: the A operands of S and dP for the whole walk.
//   - The producer's first warp brings each walk tile of WALK = 32 rows (Q and dO, or K and
//     V) as raw float32 by TMA (3-D tensor maps over (B*H, S, D), boxes of 64 columns, zeros
//     past S and D) into a ring of 2 stages, with a full and an empty `mbarrier` a stage (in
//     dK/dV its 32 lanes also copy the tile's lse and D). The walk loop has no __syncthreads().
//   - The consumers split each arrived tile once, shared by both warpgroups, into the layouts
//     wgmma takes. For tf32 both shared-memory operands must be K-major, so a tile is written
//     twice: by rows (the B operand of S and dP, reduced over the head dim) and by columns,
//     walk-major (the B operand of dV = P^T dO, dK = dS^T Q and dQ = dS K, reduced over the
//     walk), each 8 walk rows in the order 0 2 4 6 1 3 5 7. With that order P and dS go from
//     the accumulators of S and dP straight into wgmma's register A fragments (k = q <-> column
//     2q, q + 4 <-> 2q + 1), split into hi and lo in registers: no shuffle, no trip through
//     shared memory. Raw float32 keeps the walk's L2 traffic at one copy of each tile.
//   - Products: S and dP by `wgmma.m64n32k8` with both operands in shared memory, the walk
//     products by `wgmma.m64n64k8` with A in registers; three passes each (lo hi, hi lo, hi hi).
//   - Overlap: P is computed while dP runs, and the next tile's split by rows (and, in dK/dV,
//     dO's by columns) while the last walk product runs; named barriers over the 256
//     consumer threads order the one set of split buffers (the owned rows take 128 KB of the
//     227). ptxas serializes every wgmma of a kernel (its notes C7514, C7518) when other work
//     runs between a shared-memory wgmma and its wait, or when a wgmma sits behind a branch
//     it cannot prove warp-uniform: the split runs under the register-A product alone, and the
//     warpgroup's index, which the per-tile skip tests read, is broadcast by a shuffle.
//   - Order: the grid is 1-D, tiles slowest, so that the longest causal walks of every head
//     and batch start first (a grid with the tiles fastest starts the last head's longest
//     walk near the end; tools/bwd_probe.py times that order).
//   Shared memory: dK/dV 226 KB (owned K, V hi/lo 128 KB, ring 32 KB, splits 64 KB), dQ 209 KB.
//
// mma.sync path (`mma`, flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, the first design):
// every other head dim up to 128. Blocks of 64 owned rows and 4 warps of 16, mma.sync
// m16n8k8; a walk tile of 32 rows is copied and split between two barriers, in two layouts of
// hi/lo words (by rows, and by pairs of rows), each B fragment one conflict-free 16-byte load;
// the owned rows stay raw float32 in shared memory and are split as they are read.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*. The TMA
// encoder is reached through the runtime's driver entry point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int MAX_D = 128;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

struct Masks {
  int sq, sk, causal, window;  // window <= 0: none

  // Query row i sees key j: the forward's mask on right-aligned positions, ragged edges out.
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int qpos = i + sk - sq;
    return i < sq && j < sk && (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
}

// D = rowsum(dO o O): one warp a row, lanes over columns, then a fixed butterfly.
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                           float* __restrict__ delta, size_t rows, int dv) {
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = o + row * dv;
  const float* b = dout + row * dv;
  float s = 0.f;
  for (int c = lane; c < dv; c += 32) s += a[c] * b[c];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// mma.sync path: every other head dim up to 128
// ---------------------------------------------------------------------------
namespace mma {

constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int BA = 64;        // the rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int BN = 32;        // the rows of a walk tile: query rows (dK/dV) or keys (dQ)
constexpr int NT = BN / 8;    // n-tiles of S over a walk tile, k-steps of a product over it

// The least row stride >= cols (words) that is r modulo 32: rows then start r banks apart.
__host__ __device__ __forceinline__ int bank_ld(int cols, int r) {
  return cols + ((r - cols) % 32 + 32) % 32;
}

// Row strides in 4-byte words of the three shared layouts, for c columns (c8 = round8(c)).
struct Strides {
  int raw, rows, pairs;
  __host__ __device__ explicit Strides(int c) {
    const int c8 = round8(c);
    raw = bank_ld(c8, 8);        // float32 rows, read as float2 A fragments
    rows = bank_ld(2 * c8, 16);  // split by rows
    pairs = bank_ld(4 * c8, 8);  // split by pairs of rows
  }
};

// Shared memory of a block, offsets in words. dK/dV: K and V raw (its own keys), the walk
// tile's Q and dO split by rows and by pairs, the tile's lse and D. dQ: Q and dO raw (its
// own rows), the walk tile's K and V split by rows, K split by pairs, the block's lse and D.
struct Smem {
  Strides sd, sv;
  size_t a_d, a_v, r_d, r_v, p_d, p_v, lse, dl, total;
  __host__ __device__ Smem(int d, int dv, bool dkdv) : sd(d), sv(dv) {
    a_d = 0;
    a_v = a_d + (size_t)BA * sd.raw;
    r_d = a_v + (size_t)BA * sv.raw;
    r_v = r_d + (size_t)BN * sd.rows;
    p_d = r_v + (size_t)BN * sv.rows;
    p_v = p_d + (size_t)(BN / 2) * sd.pairs;
    lse = p_v + (dkdv ? (size_t)(BN / 2) * sv.pairs : 0);
    dl = lse + (dkdv ? BN : BA);
    total = dl + (dkdv ? BN : BA);
  }
};

// Rows [row0, row0 + rows) of a row-major (n, cols) float32 matrix into shared rows of ld
// floats; rows past n and columns [cols, c8) are zeros.
__device__ __forceinline__ void load_raw(float* dst, int ld, const float* __restrict__ src,
                                         int row0, int rows, int n, int cols, int c8) {
  for (int i = threadIdx.x; i < rows * c8; i += THREADS) {
    const int r = i / c8, c = i - r * c8, row = row0 + r;
    dst[r * ld + c] = (row < n && c < cols) ? src[(size_t)row * cols + c] : 0.f;
  }
}

// The same rows split by rows: row r, words 4p + (0, 1, 2, 3) = hi of columns 2p and 2p + 1,
// then lo of the same two.
__device__ __forceinline__ void load_split_rows(uint32_t* dst, int ld,
                                                const float* __restrict__ src, int row0, int rows,
                                                int n, int cols, int c8) {
  const int pairs = c8 / 2;
  for (int i = threadIdx.x; i < rows * pairs; i += THREADS) {
    const int r = i / pairs, c = 2 * (i - r * pairs), row = row0 + r;
    const bool in = row < n;
    const float x0 = (in && c < cols) ? src[(size_t)row * cols + c] : 0.f;
    const float x1 = (in && c + 1 < cols) ? src[(size_t)row * cols + c + 1] : 0.f;
    const Tf32x2 a = split(x0), b = split(x1);
    *reinterpret_cast<uint4*>(dst + r * ld + 2 * c) = make_uint4(a.hi, b.hi, a.lo, b.lo);
  }
}

// The same rows split by pairs of rows: pair p, words 4c + (0, 1, 2, 3) = hi of column c of
// rows 2p and 2p + 1, then lo of the same two.
__device__ __forceinline__ void load_split_pairs(uint32_t* dst, int ld,
                                                 const float* __restrict__ src, int row0, int rows,
                                                 int n, int cols, int c8) {
  for (int i = threadIdx.x; i < (rows / 2) * c8; i += THREADS) {
    const int p = i / c8, c = i - p * c8, r0 = row0 + 2 * p, r1 = r0 + 1;
    const float x0 = (r0 < n && c < cols) ? src[(size_t)r0 * cols + c] : 0.f;
    const float x1 = (r1 < n && c < cols) ? src[(size_t)r1 * cols + c] : 0.f;
    const Tf32x2 a = split(x0), b = split(x1);
    *reinterpret_cast<uint4*>(dst + p * ld + 4 * c) = make_uint4(a.hi, b.hi, a.lo, b.lo);
  }
}

// The A fragment of k-step kk for rows lr0 and lr0 + 8 of a raw tile, hi and lo, with the
// k index permuted (k = q <-> column 2q, q + 4 <-> 2q + 1).
__device__ __forceinline__ void a_fragment(const float* xs, int ld, int lr0, int kk, int qd,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(xs + lr0 * ld + kk * 8 + 2 * qd);
  const float2 x1 = *reinterpret_cast<const float2*>(xs + (lr0 + 8) * ld + kk * 8 + 2 * qd);
  const float xv[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32x2 s = split(xv[e]);
    hi[e] = s.hi;
    lo[e] = s.lo;
  }
}

// c = A B^T over the head dim for this warp's 16 rows and the NT n-tiles of a walk tile: A
// raw (rows lr0, lr0 + 8), B split by rows; ks k-steps of 8 columns. The three products of a
// k-step go in three passes over the n-tiles, so that no product waits on the one before it.
__device__ __forceinline__ void product_rows(float (&c)[NT][4], const float* a, int lda,
                                             int lr0, const uint32_t* b, int ldb, int ks, int g,
                                             int qd) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  }
  for (int kk = 0; kk < ks; ++kk) {
    uint32_t ah[4], al[4];
    a_fragment(a, lda, lr0, kk, qd, ah, al);
    uint4 bf[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bf[nt] = *reinterpret_cast<const uint4*>(b + (nt * 8 + g) * ldb + 16 * kk + 4 * qd);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[nt], al[0], al[1], al[2], al[3], bf[nt].x, bf[nt].y);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[nt], ah[0], ah[1], ah[2], ah[3], bf[nt].z, bf[nt].w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[nt], ah[0], ah[1], ah[2], ah[3], bf[nt].x, bf[nt].y);
  }
}

// acc += X B over the walk tile, X (this warp's 16 rows by the tile's BN rows) from the
// accumulator fragments x of product_rows, B split by pairs of the tile's rows; live of the
// N n-tiles of the output (8 head-dim columns each) are computed, eight at a time. The tile's
// product is summed from zero in the tensor cores and then added to acc with a float32 add:
// the tensor cores' float32 sums do not round to nearest, and across a walk of thousands of
// rows (dK and dV sum over every query row of the group) their error grows with the length
// of the walk, where a chain of float32 adds of one tile's sum each does not.
template <int N>
__device__ __forceinline__ void product_pairs(float (&acc)[N][4], const float (&x)[NT][4],
                                              const uint32_t* b, int ldb, int live, int g,
                                              int qd) {
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 8) {
    if (n0 >= live) continue;
    float t[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) t[u][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t xh[4], xl[4];
      const float xs[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Tf32x2 s = split(xs[e]);
        xh[e] = s.hi;
        xl[e] = s.lo;
      }
      const uint32_t* row = b + (4 * j + qd) * ldb + 4 * g + 32 * n0;
      uint4 bf[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (n0 + u < live) bf[u] = *reinterpret_cast<const uint4*>(row + 32 * u);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (n0 + u < live) mma_tf32(t[u], xl[0], xl[1], xl[2], xl[3], bf[u].x, bf[u].y);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (n0 + u < live) mma_tf32(t[u], xh[0], xh[1], xh[2], xh[3], bf[u].z, bf[u].w);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (n0 + u < live) mma_tf32(t[u], xh[0], xh[1], xh[2], xh[3], bf[u].x, bf[u].y);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (n0 + u < live) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + u][e] += t[u][e];
      }
    }
  }
}

// Rows r0 and r1 (< n) of this warp's accumulator, times mul, into a row-major (n, cols)
// matrix: columns below cols.
template <int N>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[N][4], int r0, int r1,
                                           int n, int cols, float mul, int qd) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * nt + 2 * qd + e;
      if (col >= cols) continue;
      if (r0 < n) dst[(size_t)r0 * cols + col] = acc[nt][e] * mul;
      if (r1 < n) dst[(size_t)r1 * cols + col] = acc[nt][2 + e] * mul;
    }
  }
}

// DT, DVT: n-tiles of 8 columns of D and Dv the accumulators hold (D <= 8 DT, Dv <= 8 DVT).
template <int DT, int DVT>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv_out, int hq, int hkv,
                          int d, int dv, Masks mk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem L(d, dv, true);
  float* ka = smem + L.a_d;
  float* va = smem + L.a_v;
  uint32_t* q2 = reinterpret_cast<uint32_t*>(smem + L.r_d);
  uint32_t* o2 = reinterpret_cast<uint32_t*>(smem + L.r_v);
  uint32_t* qp = reinterpret_cast<uint32_t*>(smem + L.p_d);
  uint32_t* op = reinterpret_cast<uint32_t*>(smem + L.p_v);
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  const int d8 = round8(d), dv8 = round8(dv);
  const int hk = blockIdx.y, b = blockIdx.z, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = blockIdx.x * BA, off = sk - sq;
  const size_t kv_head = (size_t)b * hkv + hk;
  load_raw(ka, L.sd.raw, k + kv_head * sk * d, k0, BA, sk, d, d8);
  load_raw(va, L.sv.raw, v + kv_head * sk * dv, k0, BA, sk, dv, dv8);

  // The query rows that some key of this tile is visible to, [i_begin, i_end), as tiles.
  const int k_last = imin(k0 + BA, sk) - 1;
  const int i_begin = mk.causal ? imax(0, k0 - off) : 0;
  const int i_end = mk.window > 0 ? imin(sq, k_last + mk.window - off) : sq;
  const int t_begin = i_begin / BN, t_end = i_end > i_begin ? (i_end + BN - 1) / BN : t_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int lr0 = 16 * warp + g;
  const int key0 = k0 + lr0, key1 = key0 + 8;
  const int kw_lo = k0 + 16 * warp, kw_hi = imin(kw_lo + 15, sk - 1);  // the warp's keys
  float dka[DT][4], dva[DVT][4];
  zero(dka);
  zero(dva);

  for (int hh = 0; hh < grp; ++hh) {  // the group's query heads, in order
    const size_t head = (size_t)b * hq + hk * grp + hh;
    const float* qb = q + head * sq * d;
    const float* ob = dout + head * sq * dv;
    for (int t = t_begin; t < t_end; ++t) {
      const int i0 = t * BN;
      __syncthreads();  // every warp is done with the previous tile
      load_split_rows(q2, L.sd.rows, qb, i0, BN, sq, d, d8);
      load_split_rows(o2, L.sv.rows, ob, i0, BN, sq, dv, dv8);
      load_split_pairs(qp, L.sd.pairs, qb, i0, BN, sq, d, d8);
      load_split_pairs(op, L.sv.pairs, ob, i0, BN, sq, dv, dv8);
      if (threadIdx.x < BN) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < sq ? lse[head * sq + i] : 0.f;
        dl_s[threadIdx.x] = i < sq ? delta[head * sq + i] : 0.f;
      }
      __syncthreads();
      // a warp none of whose keys a row of the tile sees has nothing to add
      const int qpos_lo = i0 + off, qpos_hi = imin(i0 + BN, sq) - 1 + off;
      if (kw_lo >= sk || (mk.causal && kw_lo > qpos_hi) ||
          (mk.window > 0 && kw_hi <= qpos_lo - mk.window))
        continue;

      float st[NT][4], dpt[NT][4];  // S^T and dP^T: this warp's keys by the tile's rows
      product_rows(st, ka, L.sd.raw, lr0, q2, L.sd.rows, d8 / 8, g, qd);
      product_rows(dpt, va, L.sv.raw, lr0, o2, L.sv.rows, dv8 / 8, g, qd);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * qd + (e & 1);
          const float p = mk.visible(i0 + col, e < 2 ? key0 : key1)
                              ? expf(st[nt][e] * scale - lse_s[col])
                              : 0.f;
          st[nt][e] = p;                              // P^T
          dpt[nt][e] = p * (dpt[nt][e] - dl_s[col]);  // dS^T
        }
      }
      product_pairs(dva, st, op, L.sv.pairs, dv8 / 8, g, qd);   // dV += P^T dO
      product_pairs(dka, dpt, qp, L.sd.pairs, d8 / 8, g, qd);   // dK += dS^T Q
    }
  }
  store_rows(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd);
  store_rows(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd);
}

template <int DT, int DVT>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int hq, int hkv, int d, int dv, Masks mk,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem L(d, dv, false);
  float* qa = smem + L.a_d;
  float* oa = smem + L.a_v;
  uint32_t* k2 = reinterpret_cast<uint32_t*>(smem + L.r_d);
  uint32_t* v2 = reinterpret_cast<uint32_t*>(smem + L.r_v);
  uint32_t* kp = reinterpret_cast<uint32_t*>(smem + L.p_d);
  float* lse_s = smem + L.lse;
  float* dl_s = smem + L.dl;
  const int d8 = round8(d), dv8 = round8(dv);
  const int sq = mk.sq, sk = mk.sk, off = sk - sq;
  const int qt = (sq + BA - 1) / BA - 1 - blockIdx.x;  // the longest causal walk first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv), q0 = qt * BA;
  const size_t head = (size_t)b * hq + h, kv_head = (size_t)b * hkv + hk;
  const float* kb = k + kv_head * sk * d;
  const float* vb = v + kv_head * sk * dv;
  load_raw(qa, L.sd.raw, q + head * sq * d, q0, BA, sq, d, d8);
  load_raw(oa, L.sv.raw, dout + head * sq * dv, q0, BA, sq, dv, dv8);
  if (threadIdx.x < BA) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < sq ? lse[head * sq + i] : 0.f;
    dl_s[threadIdx.x] = i < sq ? delta[head * sq + i] : 0.f;
  }

  // The key tiles some row of this tile sees (the forward's walk, in tiles of BN keys).
  const int k_end = mk.causal ? imin(sk, imin(q0 + BA, sq) - 1 + off + 1) : sk;
  const int k_begin = (mk.window > 0 ? imax(0, q0 + off - mk.window + 1) : 0) / BN * BN;
  const int n_tiles = imax(0, (k_end - k_begin + BN - 1) / BN);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;
  const int r_lo = q0 + 16 * warp;  // the warp's rows, for the tile tests (warp-uniform)
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + off, qpos_hi = imin(r_lo + 16, sq) - 1 + off;
  float dqa[DT][4];
  zero(dqa);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BN;
    __syncthreads();  // every warp is done with the previous tile (the first: Q, dO landed)
    load_split_rows(k2, L.sd.rows, kb, k0, BN, sk, d, d8);
    load_split_rows(v2, L.sv.rows, vb, k0, BN, sk, dv, dv8);
    load_split_pairs(kp, L.sd.pairs, kb, k0, BN, sk, d, d8);
    __syncthreads();
    if (!rows_live || (mk.causal && k0 > qpos_hi) ||
        (mk.window > 0 && k0 + BN - 1 <= qpos_lo - mk.window))
      continue;

    float s[NT][4], dp[NT][4];  // S and dP: this warp's rows by the tile's keys
    product_rows(s, qa, L.sd.raw, lr0, k2, L.sd.rows, d8 / 8, g, qd);
    product_rows(dp, oa, L.sv.raw, lr0, v2, L.sv.rows, dv8 / 8, g, qd);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? lr0 : lr1;
        const float p = mk.visible(q0 + r, k0 + 8 * nt + 2 * qd + (e & 1))
                            ? expf(s[nt][e] * scale - lse_s[r])
                            : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl_s[r]);  // dS
      }
    }
    product_pairs(dqa, s, kp, L.sd.pairs, d8 / 8, g, qd);  // dQ += dS K
  }
  store_rows(dq + head * sq * d, dqa, q0 + lr0, q0 + lr1, sq, d, scale, qd);
}

template <int DT, int DVT>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv_out, int b, int hq, int hkv, int d,
           int dv, const Masks& mk, float scale, cudaStream_t stream) {
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  const size_t smem_kv = sizeof(float) * Smem(d, dv, true).total;
  const size_t smem_q = sizeof(float) * Smem(d, dv, false).total;
  auto kv_kernel = flash_bwd_dkdv_kernel<DT, DVT>;
  auto q_kernel = flash_bwd_dq_kernel<DT, DVT>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3((mk.sk + BA - 1) / BA, hkv, b), THREADS, smem_kv, stream>>>(
      fq, fk, fv, fo, fl, fd, static_cast<float*>(dk), static_cast<float*>(dv_out), hq, hkv, d,
      dv, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3((mk.sq + BA - 1) / BA, hq, b), THREADS, smem_q, stream>>>(
      fq, fk, fv, fo, fl, fd, static_cast<float*>(dq), hq, hkv, d, dv, mk, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// wgmma path: D, Dv <= 64, multiples of 4
// ---------------------------------------------------------------------------
namespace wg {

constexpr int ROWS = 128;      // owned rows a block: two consumer warpgroups of 64
constexpr int WALK = 32;       // rows of a walk tile
constexpr int STAGES = 2;      // walk tiles in flight
constexpr int COLS = 64;       // head-dim columns of every tile (zeros past D and Dv)
constexpr int KSTEPS = COLS / 8;  // k-steps of S and dP
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 = 65536 - 1024
constexpr uint32_t RAW_BYTES = WALK * COLS * 4;  // 8 KB: one raw walk tile, row-major
constexpr uint32_t OWN_CHUNK = ROWS * 128;       // 16 KB: 128 owned rows x 32 columns
constexpr uint32_t OWN_BYTES = 2 * OWN_CHUNK;    // 32 KB: hi or lo of an owned operand
constexpr uint32_t ROWS_CHUNK = WALK * 128;      // 4 KB: a walk tile by rows, 32 columns
constexpr uint32_t ROWS_BYTES = 2 * ROWS_CHUNK;  // 8 KB: hi or lo of a walk tile by rows
constexpr uint32_t WALK_BYTES = COLS * 128;      // 8 KB: hi or lo of a walk tile by columns

// Byte offset of element e (0..31) of row r in a K-major tile of 128-byte rows in the
// 128-byte swizzle (16-byte units XORed with r mod 8; 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint32_t sw128(int r, int e) {
  return r * 128 + ((((e >> 2) ^ r) & 7) << 4) + ((e & 3) << 2);
}

// wgmma descriptor of a K-major operand in that layout: a k-step of 8 tf32 columns advances
// the start address by 32 bytes inside the 128-byte row; the leading offset is unused.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// c (64 x 32) (+)= A (64 x 8, shared) B^T (B 32 x 8, shared), tf32, both K-major.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// c (64 x 64) (+)= A (64 x 8, tf32 in registers) B^T (B 64 x 8, shared, K-major).
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, uint32_t off, float4 x) {
  const Tf32x2 a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(a.hi, b.hi, c.hi, d.hi);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(a.lo, b.lo, c.lo, d.lo);
}

// Rows [row0, row0 + ROWS) of a row-major (n, cols) float32 matrix split into hi and lo,
// K-major in two chunks of 32 columns (OWN_CHUNK apart): zeros past n and cols. ctid: the
// thread's index among the consumers.
__device__ __forceinline__ void split_owned(uint8_t* hi, uint8_t* lo, const float* __restrict__ src,
                                            int row0, int n, int cols, int ctid) {
#pragma unroll
  for (int it = 0; it < ROWS * (COLS / 4) / CONSUMERS; ++it) {
    const int i = ctid + it * CONSUMERS, r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
    const int row = row0 + r;
    const float4 x = (row < n && c < cols)
                         ? *reinterpret_cast<const float4*>(src + (size_t)row * cols + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    store_split(hi, lo, (c >> 5) * OWN_CHUNK + sw128(r, c & 31), x);
  }
}

// A raw walk tile (WALK x COLS, row-major, as TMA wrote it) split by rows: the B operand of
// a product over the head dim, K-major in two chunks of 32 columns (ROWS_CHUNK apart).
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo, const float* raw, int ctid) {
#pragma unroll
  for (int it = 0; it < WALK * (COLS / 4) / CONSUMERS; ++it) {
    const int i = ctid + it * CONSUMERS, r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
    store_split(hi, lo, (c >> 5) * ROWS_CHUNK + sw128(r, c & 31),
                *reinterpret_cast<const float4*>(raw + r * COLS + c));
  }
}

// The same tile split by columns: row n is head-dim column n, its 32 K elements the walk's
// rows, each 8 in the order 0 2 4 6 1 3 5 7 (the A fragments' permuted k). One 16-byte unit
// u of a row holds rows 8(u / 2) + u % 2 + {0, 2, 4, 6}; the lanes of a warp take 32
// neighbouring columns, so both the reads and the writes are free of bank conflicts.
__device__ __forceinline__ void split_walk(uint8_t* hi, uint8_t* lo, const float* raw, int ctid) {
#pragma unroll
  for (int it = 0; it < COLS * 8 / CONSUMERS; ++it) {
    const int i = ctid + it * CONSUMERS, n = i % COLS, u = i / COLS;
    const float* col = raw + (8 * (u >> 1) + (u & 1)) * COLS + n;
    store_split(hi, lo, sw128(n, 4 * u),
                make_float4(col[0], col[2 * COLS], col[4 * COLS], col[6 * COLS]));
  }
}

// c (64 x WALK) = A B^T over the head dim in 3xTF32: A this warpgroup's 64 owned rows (hi and
// lo, chunks OWN_CHUNK apart), B a walk tile by rows. Each k-step's three products go lo hi,
// hi lo, hi hi; the first starts c from zero.
__device__ __forceinline__ void product_s(float (&c)[16], uint32_t a_hi, uint32_t a_lo,
                                          uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t ao = (kk >> 2) * OWN_CHUNK + (kk & 3) * 32;
    const uint32_t bo = (kk >> 2) * ROWS_CHUNK + (kk & 3) * 32;
    wgmma_n32(c, kdesc(a_lo + ao), kdesc(b_hi + bo), kk != 0);
    wgmma_n32(c, kdesc(a_hi + ao), kdesc(b_lo + bo), 1);
    wgmma_n32(c, kdesc(a_hi + ao), kdesc(b_hi + bo), 1);
  }
}

// x (64 x WALK, an accumulator of product_s) as the hi and lo A fragments of the walk's four
// k-steps: k-step j's k = q is column 8j + 2q, k = q + 4 is 8j + 2q + 1.
__device__ __forceinline__ void fragments(const float (&x)[16], uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Tf32x2 s = split(v[e]);
      hi[j][e] = s.hi;
      lo[j][e] = s.lo;
    }
  }
}

// t (64 x COLS) = X B over the walk tile in 3xTF32, from zero: X from its fragments, B a walk
// tile by columns.
__device__ __forceinline__ void product_walk(float (&t)[32], const uint32_t (&xh)[4][4],
                                             const uint32_t (&xl)[4][4], uint32_t b_hi,
                                             uint32_t b_lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_n64_rs(t, xl[j], kdesc(b_hi + 32 * j), j != 0);
    wgmma_n64_rs(t, xh[j], kdesc(b_lo + 32 * j), 1);
    wgmma_n64_rs(t, xh[j], kdesc(b_hi + 32 * j), 1);
  }
}

__device__ __forceinline__ void pin_fragments(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) pin(x[j]);
}

// Rows r0 and r1 (< n) of a warpgroup accumulator (64 x COLS), times mul, into a row-major
// (n, cols) matrix: columns below cols (a multiple of 4).
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[32], int r0, int r1,
                                          int n, int cols, float mul, int qd) {
#pragma unroll
  for (int nt = 0; nt < COLS / 8; ++nt) {
    const int col = 8 * nt + 2 * qd;
    if (col >= cols) continue;
    if (r0 < n)
      *reinterpret_cast<float2*>(dst + (size_t)r0 * cols + col) =
          make_float2(acc[4 * nt] * mul, acc[4 * nt + 1] * mul);
    if (r1 < n)
      *reinterpret_cast<float2*>(dst + (size_t)r1 * cols + col) =
          make_float2(acc[4 * nt + 2] * mul, acc[4 * nt + 3] * mul);
  }
}

// Shared memory of a block, byte offsets from a 1024-byte-aligned base. Owned operands (A of
// S and dP): hi and lo of the rows behind S (K or Q), then of those behind dP (V or dO). The
// ring: STAGES raw tiles of each of the two walked tensors. Split buffers: each walked
// tensor by rows (hi, lo), then by columns (hi, lo) for those the walk products take (dK/dV:
// both, dQ: K alone). Then dK/dV's lse and D: the ring's (STAGES x 2 x WALK floats), and the
// consumers' copy of the tile in use (2 x WALK); then the barriers (full, empty).
struct Smem {
  uint32_t own_s, own_p, raw, rows, walk, lse_ring, lse_buf, bars, total;
  __host__ __device__ explicit Smem(bool dkdv) {
    own_s = 0;
    own_p = own_s + 2 * OWN_BYTES;
    raw = own_p + 2 * OWN_BYTES;
    rows = raw + STAGES * 2 * RAW_BYTES;
    walk = rows + 2 * 2 * ROWS_BYTES;
    lse_ring = walk + (dkdv ? 2 : 1) * 2 * WALK_BYTES;
    lse_buf = lse_ring + (dkdv ? STAGES * 2 * WALK * 4 : 0);
    bars = lse_buf + (dkdv ? 2 * WALK * 4 : 0);
    total = bars + 2 * STAGES * 8;
  }
};

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// dK and dV of ROWS keys of one KV head, summed over the query heads of its group.
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap o_map,
                                const float* __restrict__ k, const float* __restrict__ v,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv_out, int batch,
                                int hq, int hkv, int d, int dv, Masks mk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_base(smem_raw);
  const Smem L(true);
  const uint32_t s0 = smem_u32(sm);
  auto full = [&](int s) { return s0 + L.bars + 8u * s; };
  auto empty = [&](int s) { return s0 + L.bars + 8u * (STAGES + s); };
  float* lse_ring = reinterpret_cast<float*>(sm + L.lse_ring);  // [stage][lse, D][WALK]

  // Blocks in the order of their key tiles across every (KV head, batch): the longest causal
  // walks, the first key tiles', start first on the card.
  const int heads = hkv * batch;
  const int hk = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = (blockIdx.x / heads) * ROWS, off = sk - sq;
  // The query rows that some key of this block is visible to, as tiles [t_begin, t_end).
  const int k_last = imin(k0 + ROWS, sk) - 1;
  const int i_begin = mk.causal ? imax(0, k0 - off) : 0;
  const int i_end = mk.window > 0 ? imin(sq, k_last + mk.window - off) : sq;
  const int t_begin = i_begin / WALK;
  const int per_head = i_end > i_begin ? (i_end + WALK - 1) / WALK - t_begin : 0;
  const int n_tiles = grp * per_head;  // the group's heads in order, each its tiles in order

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes, one with the TMA bytes
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp loads the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, hh = it / per_head, i0 = (t_begin + it % per_head) * WALK;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const int head = b * hq + hk * grp + hh, i = i0 + lane;
        lse_ring[(2 * s) * WALK + lane] = i < sq ? lse[(size_t)head * sq + i] : 0.f;
        lse_ring[(2 * s + 1) * WALK + lane] = i < sq ? delta[(size_t)head * sq + i] : 0.f;
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * RAW_BYTES);
          tma_load(s0 + L.raw + (2 * s) * RAW_BYTES, &q_map, full(s), 0, i0, head);
          tma_load(s0 + L.raw + (2 * s + 1) * RAW_BYTES, &o_map, full(s), 0, i0, head);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ctid = threadIdx.x - 128, wgi = consumer_warpgroup(), tid = ctid % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const size_t kv_head = (size_t)b * hkv + hk;
  uint8_t* kh = sm + L.own_s;
  uint8_t* vh = sm + L.own_p;
  split_owned(kh, kh + OWN_BYTES, k + kv_head * sk * d, k0, sk, d, ctid);
  split_owned(vh, vh + OWN_BYTES, v + kv_head * sk * dv, k0, sk, dv, ctid);
  const uint32_t a_k = s0 + L.own_s + wgi * 64 * 128, a_v = s0 + L.own_p + wgi * 64 * 128;
  uint8_t* q_rows = sm + L.rows;  // hi, lo; then dO's
  uint8_t* o_rows = q_rows + 2 * ROWS_BYTES;
  uint8_t* q_walk = sm + L.walk;  // hi, lo; then dO's
  uint8_t* o_walk = q_walk + 2 * WALK_BYTES;
  const uint32_t b_qr = s0 + L.rows, b_or = b_qr + 2 * ROWS_BYTES;
  const uint32_t b_qw = s0 + L.walk, b_ow = b_qw + 2 * WALK_BYTES;
  float* lse_buf = reinterpret_cast<float*>(sm + L.lse_buf);  // the tile's [lse, D][WALK]

  // One tile's split from ring stage s, in two parts: Q and dO by rows, dO by columns and
  // the tile's lse and D (free once S, dP and dV are done); then Q by columns (once dK is).
  auto split_tile_rows = [&](int it) {
    const int s = it % STAGES;
    const float* raw = reinterpret_cast<const float*>(sm + L.raw + 2 * s * RAW_BYTES);
    split_rows(q_rows, q_rows + ROWS_BYTES, raw, ctid);
    split_rows(o_rows, o_rows + ROWS_BYTES, raw + WALK * COLS, ctid);
    split_walk(o_walk, o_walk + WALK_BYTES, raw + WALK * COLS, ctid);
    if (ctid < 2 * WALK) lse_buf[ctid] = lse_ring[2 * s * WALK + ctid];
  };
  auto split_tile_walk = [&](int it) {
    const int s = it % STAGES;
    const float* raw = reinterpret_cast<const float*>(sm + L.raw + 2 * s * RAW_BYTES);
    split_walk(q_walk, q_walk + WALK_BYTES, raw, ctid);
    fence_async_smem();
    mbar_arrive(empty(s));  // this thread is done with stage s
  };

  const int key0 = k0 + 64 * wgi + 16 * (tid / 32) + g, key1 = key0 + 8;
  const int kw_lo = k0 + 64 * wgi, kw_hi = imin(kw_lo + 63, sk - 1);  // the warpgroup's keys
  float dka[32], dva[32];
  zero(dka);
  zero(dva);
  if (n_tiles > 0) {
    mbar_wait(full(0), 0);
    split_tile_rows(0);
    split_tile_walk(0);
  } else {
    fence_async_smem();
  }
  consumers_sync();  // the owned rows and tile 0 split by every consumer

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = (t_begin + it % per_head) * WALK;
    const int qpos_lo = i0 + off, qpos_hi = imin(i0 + WALK, sq) - 1 + off;
    // a warpgroup none of whose keys a row of the tile sees has nothing to add
    const bool skip = kw_lo >= sk || (mk.causal && kw_lo > qpos_hi) ||
                      (mk.window > 0 && kw_hi <= qpos_lo - mk.window);
    const bool edge = i0 + WALK > sq || kw_lo + 64 > sk || (mk.causal && kw_lo + 63 > qpos_lo) ||
                      (mk.window > 0 && kw_lo <= qpos_hi - mk.window);
    // Three commit groups a tile: S^T and dP^T (P computed while dP^T ends), P^T dO, and
    // dS^T Q, under which the next tile is split by rows (and dO by columns). ptxas
    // serializes wgmma when other work runs between a shared-memory wgmma and its wait, so
    // the split runs under the register-A product alone.
    float st[16], dpt[16];  // S^T and dP^T: this warpgroup's keys by the tile's rows
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    float tv[32], tk[32];
    if (!skip) {
      const float* lb = lse_buf;
      wgmma_fence();
      product_s(st, a_k, a_k + OWN_BYTES, b_qr, b_qr + ROWS_BYTES);
      wgmma_commit();
      product_s(dpt, a_v, a_v + OWN_BYTES, b_or, b_or + ROWS_BYTES);
      wgmma_commit();
      wgmma_wait_pending<1>();
      pin(st);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * qd + (e & 1);
          st[4 * nt + e] = (!edge || mk.visible(i0 + col, e < 2 ? key0 : key1))
                               ? expf(st[4 * nt + e] * scale - lb[col])
                               : 0.f;  // P^T
        }
      }
      fragments(st, ph, pl);
      wgmma_fence();
      product_walk(tv, ph, pl, b_ow, b_ow + WALK_BYTES);  // P^T dO
      wgmma_commit();
      wgmma_wait_pending<0>();  // dP^T and P^T dO
      pin(dpt);
      pin(tv);
      pin_fragments(ph);
      pin_fragments(pl);
#pragma unroll
      for (int e = 0; e < 32; ++e) dva[e] += tv[e];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * qd + (e & 1);
          dpt[4 * nt + e] = st[4 * nt + e] * (dpt[4 * nt + e] - lb[WALK + col]);  // dS^T
        }
      }
      fragments(dpt, sh, sl);
      wgmma_fence();
      product_walk(tk, sh, sl, b_qw, b_qw + WALK_BYTES);  // dS^T Q
      wgmma_commit();
    }
    consumers_sync();  // the split by rows and dO's by columns are free
    if (it + 1 < n_tiles) {  // while the tensor cores run dS^T Q: the next tile
      mbar_wait(full((it + 1) % STAGES), ((it + 1) / STAGES) & 1);
      split_tile_rows(it + 1);
    }
    if (!skip) {
      wgmma_wait_pending<0>();
      pin(tk);
      pin_fragments(sh);
      pin_fragments(sl);
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[e] += tk[e];
    }
    consumers_sync();  // Q's split by columns is free
    if (it + 1 < n_tiles) {
      split_tile_walk(it + 1);
      consumers_sync();  // the next tile split by every consumer
    }
  }
  store_acc(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd);
  store_acc(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd);
}

// dQ of ROWS query rows of one head.
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ q, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int batch, int hq, int hkv, int d, int dv,
                              Masks mk, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_base(smem_raw);
  const Smem L(false);
  const uint32_t s0 = smem_u32(sm);
  auto full = [&](int s) { return s0 + L.bars + 8u * s; };
  auto empty = [&](int s) { return s0 + L.bars + 8u * (STAGES + s); };

  // Blocks from the last query tile (the longest causal walk) to the first, each tile across
  // every (head, batch) before the next.
  const int sq = mk.sq, sk = mk.sk, off = sk - sq, heads = hq * batch;
  const int q0 = ((sq + ROWS - 1) / ROWS - 1 - (int)blockIdx.x / heads) * ROWS;
  const int h = blockIdx.x % heads % hq, b = blockIdx.x % heads / hq, hk = h / (hq / hkv);
  // The key tiles some row of this block sees (the forward's walk, in tiles of WALK keys).
  const int k_end = mk.causal ? imin(sk, imin(q0 + ROWS, sq) - 1 + off + 1) : sk;
  const int k_begin = (mk.window > 0 ? imax(0, q0 + off - mk.window + 1) : 0) / WALK * WALK;
  const int n_tiles = imax(0, (k_end - k_begin + WALK - 1) / WALK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kv_bh = b * hkv + hk;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, kt = k_begin + it * WALK;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * RAW_BYTES);
        tma_load(s0 + L.raw + (2 * s) * RAW_BYTES, &k_map, full(s), 0, kt, kv_bh);
        tma_load(s0 + L.raw + (2 * s + 1) * RAW_BYTES, &v_map, full(s), 0, kt, kv_bh);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ctid = threadIdx.x - 128, wgi = consumer_warpgroup(), tid = ctid % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const size_t head = (size_t)b * hq + h;
  uint8_t* qh = sm + L.own_s;
  uint8_t* oh = sm + L.own_p;
  split_owned(qh, qh + OWN_BYTES, q + head * sq * d, q0, sq, d, ctid);
  split_owned(oh, oh + OWN_BYTES, dout + head * sq * dv, q0, sq, dv, ctid);
  const uint32_t a_q = s0 + L.own_s + wgi * 64 * 128, a_o = s0 + L.own_p + wgi * 64 * 128;
  uint8_t* k_rows = sm + L.rows;  // hi, lo; then V's
  uint8_t* v_rows = k_rows + 2 * ROWS_BYTES;
  uint8_t* k_walk = sm + L.walk;  // hi, lo
  const uint32_t b_kr = s0 + L.rows, b_vr = b_kr + 2 * ROWS_BYTES, b_kw = s0 + L.walk;

  auto split_tile_rows = [&](int it) {
    const float* raw =
        reinterpret_cast<const float*>(sm + L.raw + 2 * (it % STAGES) * RAW_BYTES);
    split_rows(k_rows, k_rows + ROWS_BYTES, raw, ctid);
    split_rows(v_rows, v_rows + ROWS_BYTES, raw + WALK * COLS, ctid);
  };
  auto split_tile_walk = [&](int it) {
    const float* raw =
        reinterpret_cast<const float*>(sm + L.raw + 2 * (it % STAGES) * RAW_BYTES);
    split_walk(k_walk, k_walk + WALK_BYTES, raw, ctid);
    fence_async_smem();
    mbar_arrive(empty(it % STAGES));
  };

  const int r_lo = q0 + 64 * wgi;  // the warpgroup's rows, for the tile tests
  const int row0 = r_lo + 16 * (tid / 32) + g, row1 = row0 + 8;
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + off, qpos_hi = imin(r_lo + 64, sq) - 1 + off;
  const float lse0 = row0 < sq ? lse[head * sq + row0] : 0.f;
  const float lse1 = row1 < sq ? lse[head * sq + row1] : 0.f;
  const float dl0 = row0 < sq ? delta[head * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[head * sq + row1] : 0.f;
  float dqa[32];
  zero(dqa);
  if (n_tiles > 0) {
    mbar_wait(full(0), 0);
    split_tile_rows(0);
    split_tile_walk(0);
  } else {
    fence_async_smem();
  }
  consumers_sync();

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * WALK;
    const bool skip = !rows_live || (mk.causal && kt > qpos_hi) ||
                      (mk.window > 0 && kt + WALK - 1 <= qpos_lo - mk.window);
    const bool edge = r_lo + 64 > sq || kt + WALK > sk || (mk.causal && kt + WALK - 1 > qpos_lo) ||
                      (mk.window > 0 && kt <= qpos_hi - mk.window);
    // Two commit groups, S and dP (P computed while dP ends), then dS K, under which the next
    // tile is split by rows.
    float s[16], dp[16];  // S and dP: this warpgroup's rows by the tile's keys
    uint32_t xh[4][4], xl[4][4];
    float tq[32];
    if (!skip) {
      wgmma_fence();
      product_s(s, a_q, a_q + OWN_BYTES, b_kr, b_kr + ROWS_BYTES);
      wgmma_commit();
      product_s(dp, a_o, a_o + OWN_BYTES, b_vr, b_vr + ROWS_BYTES);
      wgmma_commit();
      wgmma_wait_pending<1>();
      pin(s);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          s[4 * nt + e] = (!edge || mk.visible(row, kt + 8 * nt + 2 * qd + (e & 1)))
                              ? expf(s[4 * nt + e] * scale - (e < 2 ? lse0 : lse1))
                              : 0.f;  // P
        }
      }
      wgmma_wait_pending<0>();
      pin(dp);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] *= dp[e] - ((e & 2) ? dl1 : dl0);  // dS
      fragments(s, xh, xl);
      wgmma_fence();
      product_walk(tq, xh, xl, b_kw, b_kw + WALK_BYTES);  // dS K
      wgmma_commit();
    }
    consumers_sync();  // the split by rows is free
    if (it + 1 < n_tiles) {
      mbar_wait(full((it + 1) % STAGES), ((it + 1) / STAGES) & 1);
      split_tile_rows(it + 1);
    }
    if (!skip) {
      wgmma_wait_pending<0>();
      pin(tq);
      pin_fragments(xh);
      pin_fragments(xl);
#pragma unroll
      for (int e = 0; e < 32; ++e) dqa[e] += tq[e];
    }
    consumers_sync();  // the split by columns is free
    if (it + 1 < n_tiles) {
      split_tile_walk(it + 1);
      consumers_sync();
    }
  }
  store_acc(dq + head * sq * d, dqa, row0, row1, sq, d, scale, qd);
}

// A (B*H, rows, cols) float32 tensor as a 3-D tensor map; boxes of (1, WALK, COLS), no
// swizzle, zeros outside the tensor. cols must be a multiple of 4 (a 16-byte row stride).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)cols * 4 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)COLS, (cuuint32_t)WALK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv_out, int b, int hq, int hkv, int d,
           int dv, const Masks& mk, float scale, cudaStream_t stream) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;  // TMA and float4 loads
  CUtensorMap qm, om, km, vm;
  cudaError_t err = make_map(&qm, q, b * hq, mk.sq, d);
  if (err == cudaSuccess) err = make_map(&om, dout, b * hq, mk.sq, dv);
  if (err == cudaSuccess) err = make_map(&km, k, b * hkv, mk.sk, d);
  if (err == cudaSuccess) err = make_map(&vm, v, b * hkv, mk.sk, dv);
  if (err != cudaSuccess) return (int)err;
  const float* fl = static_cast<const float*>(lse);
  const float* fd = static_cast<const float*>(delta);
  const size_t smem_kv = 1024 + Smem(true).total, smem_q = 1024 + Smem(false).total;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  // 1-D grids of (tile, head, batch), tiles slowest
  flash_bwd_dkdv_wgmma_kernel<<<(mk.sk + ROWS - 1) / ROWS * hkv * b, THREADS, smem_kv, stream>>>(
      qm, om, static_cast<const float*>(k), static_cast<const float*>(v), fl, fd,
      static_cast<float*>(dk), static_cast<float*>(dv_out), b, hq, hkv, d, dv, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma_kernel<<<(mk.sq + ROWS - 1) / ROWS * hq * b, THREADS, smem_q, stream>>>(
      km, vm, static_cast<const float*>(q), static_cast<const float*>(dout), fl, fd,
      static_cast<float*>(dq), b, hq, hkv, d, dv, mk, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o and dout (B,Hq,Sq,Dv), lse (B,Hq,Sq):
// float32, contiguous. Writes delta (B,Hq,Sq) (scratch: D = rowsum(dO o O)), dq, dk, dv
// (shaped as q, k, v), every element. window <= 0 means no window. The caller has checked
// 1 <= D, Dv <= 128, Hq % Hkv == 0, B, Sq, Sk >= 1, causal/window only with Sq <= Sk, and the
// grid limits. D and Dv up to 64 and multiples of 4 take the wgmma path, which needs q, k, v
// and dout 16-byte aligned (cudaErrorMisalignedAddress otherwise); every other head dim the
// mma.sync path. Returns the cudaError_t of the launches (0 on success). Does not synchronise.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* delta, void* dq, void* dk,
                              void* dv_out, int b, int hq, int hkv, int sq, int sk, int d, int dv,
                              int causal, int window, float scale, void* stream) {
  if (d < 1 || d > MAX_D || dv < 1 || dv > MAX_D || hkv < 1 || hq % hkv != 0 || b < 1 ||
      sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)b * hq * sq;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), static_cast<float*>(delta),
      rows, dv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Masks mk{sq, sk, causal, window > 0 ? window : 0};
  if (d <= 64 && dv <= 64 && d % 4 == 0 && dv % 4 == 0)
    return wg::launch(q, k, v, dout, lse, delta, dq, dk, dv_out, b, hq, hkv, d, dv, mk, scale, s);
  if (d <= 64 && dv <= 64)
    return mma::launch<8, 8>(q, k, v, dout, lse, delta, dq, dk, dv_out, b, hq, hkv, d, dv, mk,
                             scale, s);
  return mma::launch<16, 16>(q, k, v, dout, lse, delta, dq, dk, dv_out, b, hq, hkv, d, dv, mk,
                             scale, s);
}

// Dynamic shared memory a block of the wgmma path asks for: dK/dV (dkdv = 1) or dQ (0).
int repro_flash_attention_bwd_shared_bytes(int dkdv) {
  return (int)(1024 + wg::Smem(dkdv != 0).total);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
