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
// Three kernels. Each output element is summed by one thread in a fixed order and written
// once: no atomics, so two launches give the same bits and a batch row's gradients do not
// depend on the batch it is in.
//   - flash_bwd_delta_kernel: D, one warp a row.
//   - flash_bwd_dkdv_kernel: one block per (tile of BA = 64 keys, KV head, batch), 4 warps of
//     16 keys. It walks the g = Hq / Hkv query heads of its group in order and, for each,
//     the tiles of BN = 32 query rows that some of its keys are visible to, recomputing
//     S^T = K Q^T and dP^T = V dO^T. dK and dV stay in registers over the whole walk (the sum
//     over the GQA group in a fixed order) and are written once; a key tile that no query
//     sees writes zeros.
//   - flash_bwd_dq_kernel: one block per (tile of 64 query rows, query head, batch), 4 warps
//     of 16 rows, walking the tiles of 32 keys its rows see (the forward's walk) and
//     recomputing S and dP; dQ stays in registers and is written once. Blocks run from the
//     last query tile (the longest causal walk) to the first.
//
// What bounds it. Five products over the (query, key) pairs the masks keep, 2 pairs (3D + 2Dv)
// FLOPs a head, against one read of q, k, v, o, dO, lse and one write of dq, dk, dv: at the
// demo's train shape (B 4, Hq 12, Hkv 4, S 4096, D = Dv = 64, causal) about S/2 FLOPs a
// byte, far above the card's ridge, so operations bound it. Each product is three TF32 ones,
// 3 x FLOPs at the 495 TFLOP/s TF32 peak. Recomputing S and dP in the dQ kernel adds two
// products (seven in all): the price of writing dQ without atomics.
//
// Numerics and layout. Every product is three mma.sync m16n8k8 (mma_tf32.cuh: each operand
// split into TF32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi): float32 accuracy, as the
// forward's float32 path. The rows a block owns (keys in dK/dV, query rows in dQ) stay in
// float32 in shared memory (rows of 8 mod 32 words) and are split into A fragments as they
// are read. The tiles of its walk change at every step and are split once a tile into TF32
// hi/lo words, in the forward's two layouts: by rows (row r, words 4p.. = hi, hi, lo, lo of
// columns 2p and 2p + 1: the B operand of a product over the head dim) and by pairs of rows
// (pair p, words 4c.. = hi, hi, lo, lo of column c of rows 2p and 2p + 1: the B operand of a
// product over the walk); each B fragment, hi and lo, is one conflict-free 16-byte load. P and
// dS go from the accumulators of S and dP straight into the A fragments of the next product
// (each k-step's index permuted, k = q <-> column 2q, q + 4 <-> 2q + 1, as in the forward),
// never through shared memory. dQ, dK and dV sum over the whole walk in two levels: each
// tile's product from zero in the tensor cores, then a float32 add into registers (the
// tensor cores' float32 sums do not round to nearest: summed in them alone across the 12,288
// query rows of a group at the train shape, dK and dV come out 3e-4 to 6e-4 off float64, a
// hundred times the plain backward's error). expf is accurate (no fast math).
//
// Simple first: a walk tile is copied and split between two barriers (no copy in flight
// while the tensor cores work; the second block an SM hides some of it at head dims up to
// 64, where each block asks for under 108 KB of shared memory). Head dims up to 128.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int BA = 64;        // the rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int BN = 32;        // the rows of a walk tile: query rows (dK/dV) or keys (dQ)
constexpr int NT = BN / 8;    // n-tiles of S over a walk tile, k-steps of a product over it
constexpr int MAX_D = 128;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
// The least row stride >= cols (words) that is r modulo 32: rows then start r banks apart.
__host__ __device__ __forceinline__ int bank_ld(int cols, int r) {
  return cols + ((r - cols) % 32 + 32) % 32;
}

struct Masks {
  int sq, sk, causal, window;  // window <= 0: none

  // Query row i sees key j: the forward's mask on right-aligned positions, ragged edges out.
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int qpos = i + sk - sq;
    return i < sq && j < sk && (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
  }
};

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

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
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

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o and dout (B,Hq,Sq,Dv), lse (B,Hq,Sq):
// float32, contiguous. Writes delta (B,Hq,Sq) (scratch: D = rowsum(dO o O)), dq, dk, dv
// (shaped as q, k, v), every element. window <= 0 means no window. The caller has checked
// 1 <= D, Dv <= 128, Hq % Hkv == 0, B, Sq, Sk >= 1, causal/window only with Sq <= Sk, and the
// grid limits. Returns the cudaError_t of the launches (0 on success). Does not synchronise.
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
  if (d <= 64 && dv <= 64)
    return launch<8, 8>(q, k, v, dout, lse, delta, dq, dk, dv_out, b, hq, hkv, d, dv, mk, scale,
                        s);
  return launch<16, 16>(q, k, v, dout, lse, delta, dq, dk, dv_out, b, hq, hkv, d, dv, mk, scale,
                        s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
