// Flash-attention backward for Hopper (sm_90a), bfloat16: operands on the tensor cores by
// mma.sync m16n8k16 with float32 sums.
//
// Replaces the backward of the TPU kernel for bfloat16 inputs: `_vjp_bwd` in
// src/repro/kernels/flash_attention.py, the custom VJP of `flash_attention_pallas` (jax.vjp of
// the blocked plain forward; plain jnp, not a Pallas kernel). Same function as the float32
// backward in flash_attention_bwd.cu: dQ, dK and dV of online-softmax attention with causal
// and local-window masks on right-aligned query positions (qpos = i + Sk - Sq), GQA/MQA through
// the KV head h / (Hq / Hkv), a value head dim that may differ from the key head dim, ragged Sq
// and Sk masked in the kernels.
//
// The FlashAttention-2 form, from the forward's bfloat16 output O and each row's float32
// logsumexp lse (which flash_fwd_wgmma_kernel writes when asked):
//   D = rowsum(dO o O);  P = exp(S scale - lse);  dV = P^T dO;  dP = dO V^T;
//   dS = P o (dP - D);   dQ = dS K scale;         dK = dS^T Q scale.
// Three launches, as the float32 backward. Each output element is summed in a fixed order
// and written once: no atomics, so two launches give the same bits and a batch row's
// gradients do not depend on the batch it is in.
//   - flash_bwd_bf16_delta_kernel: D in float32, one warp a row.
//   - flash_bwd_bf16_dkdv_kernel: one block per (tile of 64 keys, KV head, batch), 4 warps of
//     16 keys. It walks the g = Hq / Hkv query heads of its group in order and, for each, the
//     tiles of 32 query rows that some of its keys are visible to, recomputing S^T = K Q^T and
//     dP^T = V dO^T. dK and dV stay in float32 registers over the whole walk (the sum over the
//     GQA group, in a fixed order) and are rounded to bfloat16 once; a key tile no query sees
//     writes zeros. Key tile 0 (the longest causal walk) is block 0.
//   - flash_bwd_bf16_dq_kernel: one block per (tile of 64 query rows, query head, batch), 4
//     warps of 16 rows, walking the tiles of 64 keys its rows see and recomputing S and dP; dQ
//     stays in float32 registers and is rounded once. The last query tile (the longest causal
//     walk) is block 0.
//
// What bounds it. Five products over the (query, key) pairs the masks keep, 2 pairs (3D + 2Dv)
// FLOPs a head, against one read of q, k, v, o, dO, lse and one write of dq, dk, dv: at
// qwen3-1.7b's train shape (B 2, Hq 16, Hkv 8, S 4096, D = Dv = 128, causal) about S FLOPs a
// byte, far above the card's ridge (295 FLOP/byte in bfloat16), so the tensor cores bound it:
// 3.44e11 FLOPs at 989 TFLOP/s. Recomputing S and dP in the dQ kernel adds two products (seven
// in all), the price of writing dQ without atomics.
//
// Design. Every product is mma.sync m16n8k16 with bfloat16 operands and float32 sums: the
// owned rows (K and V, or Q and dO) as A fragments by ldmatrix from shared memory, the walk
// tile's rows as B fragments by ldmatrix (S, dP: reduced over the head dim) or ldmatrix.trans
// (dV, dK, dQ: reduced over the walk). P and dS go from the accumulators of S and dP straight
// into the A fragments of the walk products (the accumulator of two n-tiles of 8 is the A
// fragment of one k-step of 16), rounded to bfloat16 there and only there: P stays float32
// in dS = P o (dP - D). The walk tile is double-buffered by 16-byte cp.async copies that
// zero-fill rows past Sq or Sk and head-dim columns past D up to the next multiple of 16; the
// next tile lands while this one is used. Shared-memory rows are padded by 16 bytes, so the
// eight rows an ldmatrix reads start in eight different bank groups.
//   Shared memory at D = Dv = 128: dK/dV 70,144 bytes (K, V 2 x 17 KB; 2 stages of Q, dO 34 KB;
//   lse, D), dQ 104,960 (Q, dO 34 KB; 2 stages of K, V 68 KB; lse, D).
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_D = 128;
constexpr int THREADS = 128;  // 4 warps of 16 owned rows
constexpr int OWN = 64;       // the rows a block owns: keys (dK/dV) or query rows (dQ)
constexpr int WALK_KV = 32;   // query rows of a dK/dV walk tile
constexpr int WALK_Q = 64;    // keys of a dQ walk tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

struct Masks {
  int sq, sk, causal, window;  // window <= 0: none

  // Query row i sees key j: the forward's mask on right-aligned positions, ragged edges out.
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int qpos = i + sk - sq;
    return i < sq && j < sk && (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !fill (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: m16n8k16, bfloat16 operands, float32 sums. Fragments (g = lane / 4, t = lane % 4):
// a0 (row g, k 2t, 2t + 1), a1 (row g + 8), a2 (k + 8), a3 (row g + 8, k + 8); b0 (k 2t, 2t + 1,
// column g), b1 (k + 8); d0 (row g, columns 2t), d1 (2t + 1), d2 (row g + 8, 2t), d3.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// Rows [row0, row0 + rows) of a row-major (n, cols) bfloat16 matrix (cols a multiple of 8)
// into shared rows of ld elements, columns [0, c16); rows past n and columns past cols are
// zeros. Issued as cp.async copies: the caller commits and waits.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int row0, int rows, int n, int cols, int c16) {
  const int chunks = c16 / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = 8 * (i - r * chunks), row = row0 + r;
    const bool in = row < n && c < cols;
    cp_async16(dst + r * ld + c, in ? src + (size_t)row * cols + c : src, in);
  }
}

// acc (16 owned rows x NT n-tiles of the walk) = A B^T over the head dim: A this warp's 16
// rows of an owned tile (ldmatrix), B the walk tile's rows (ldmatrix, not transposed), ks
// k-steps of 16 columns (at most KS).
template <int NT, int KS>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const bf16* own, const bf16* walk,
                                             int ld, int ks, int lane) {
  zero(acc);
  const bf16* a_row = own + (lane % 16) * ld + 8 * (lane / 16);
  const bf16* b_row = walk + ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= ks) break;
    uint32_t a[4];
    ldsm_x4(a, a_row + 16 * kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_row + 16 * np * ld + 16 * kk);
      mma16(acc[2 * np], a, b[0], b[1]);
      mma16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The accumulator of S-like products (NT n-tiles of 8 walk rows) as bfloat16 A fragments of
// NT / 2 k-steps of 16 walk rows.
template <int NT>
__device__ __forceinline__ void fragments(uint32_t (&x)[NT / 2][4], const float (&s)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    x[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    x[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    x[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    x[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// acc (16 owned rows x head-dim columns) += X B over the walk: X the fragments of this warp's
// 16 rows by the walk's KW rows, B the walk tile (rows = walk, columns = head dim) by
// ldmatrix.trans; the n-tiles below c16 columns (at most 8 NP).
template <int NP, int KW>
__device__ __forceinline__ void product_walk(float (&acc)[2 * NP][4], const uint32_t (&x)[KW][4],
                                             const bf16* walk, int ld, int c16, int lane) {
  const bf16* b_row = walk + ((lane % 8) + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16);
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    if (16 * np >= c16) break;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      uint32_t b[4];
      ldsm_x4_t(b, b_row + 16 * j * ld + 16 * np);
      mma16(acc[2 * np], x[j], b[0], b[1]);
      mma16(acc[2 * np + 1], x[j], b[2], b[3]);
    }
  }
}

// Rows r0 and r1 (< n) of this warp's accumulator, times mul, as bfloat16 into a row-major
// (n, cols) matrix: columns below cols (a multiple of 8).
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[N][4], int r0, int r1,
                                           int n, int cols, float mul, int qd) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    const int col = 8 * nt + 2 * qd;
    if (col >= cols) continue;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * cols + col) =
          __floats2bfloat162_rn(acc[nt][0] * mul, acc[nt][1] * mul);
    if (r1 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r1 * cols + col) =
          __floats2bfloat162_rn(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

// D = rowsum(dO o O) in float32: one warp a row, lanes over pairs of columns, then a fixed
// butterfly.
__global__ void __launch_bounds__(256)
    flash_bwd_bf16_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                float* __restrict__ delta, size_t rows, int dv) {
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(o + row * dv);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(dout + row * dv);
  float s = 0.f;
  for (int c = lane; c < dv / 2; c += 32) {
    const float2 x = __bfloat1622float2(a[c]), y = __bfloat1622float2(b[c]);
    s += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL_MASK, s, m);
  if (lane == 0) delta[row] = s;
}

// Shared-memory row stride in elements for head dims up to DMAX: 16 bytes of pad a row.
template <int DMAX>
__host__ __device__ constexpr int row_ld() {
  return DMAX + 8;
}

template <int DMAX>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * OWN + 4 * WALK_KV) * row_ld<DMAX>() +
         sizeof(float) * 4 * WALK_KV;
}

template <int DMAX>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * OWN + 4 * WALK_Q) * row_ld<DMAX>() +
         sizeof(float) * 2 * OWN;
}

// DMAX: 64 or 128, the widest head dim the accumulators hold (D16, Dv16 <= DMAX).
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv_out, int hq, int hkv,
                               int d, int dv, Masks mk, float scale) {
  constexpr int LD = row_ld<DMAX>();
  constexpr int NT = WALK_KV / 8;  // n-tiles of S^T over a walk tile
  constexpr int DT = DMAX / 8;     // n-tiles of the dK and dV accumulators
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + OWN * LD;
  bf16* qs = vs + OWN * LD;         // 2 stages of WALK_KV rows
  bf16* os = qs + 2 * WALK_KV * LD;  // 2 stages
  float* ls = reinterpret_cast<float*>(os + 2 * WALK_KV * LD);  // 2 stages: lse * log2(e)
  float* dls = ls + 2 * WALK_KV;                                 // 2 stages: D

  const int d16 = round16(d), dv16 = round16(dv);
  const int hk = blockIdx.y, b = blockIdx.z, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = blockIdx.x * OWN, off = sk - sq;
  const size_t kv_head = (size_t)b * hkv + hk;
  load_tile(ks, LD, k + kv_head * sk * d, k0, OWN, sk, d, d16);
  load_tile(vs, LD, v + kv_head * sk * dv, k0, OWN, sk, dv, dv16);
  cp_async_commit();

  // The query rows that some key of this tile is visible to, [i_begin, i_end), as tiles.
  const int k_last = imin(k0 + OWN, sk) - 1;
  const int i_begin = mk.causal ? imax(0, k0 - off) : 0;
  const int i_end = mk.window > 0 ? imin(sq, k_last + mk.window - off) : sq;
  const int t_begin = i_begin / WALK_KV;
  const int n_t = i_end > i_begin ? (i_end + WALK_KV - 1) / WALK_KV - t_begin : 0;
  const int n_walk = grp * n_t;  // (query head, tile) in head order, then tile order

  auto load_walk = [&](int w, int stage) {
    const int hh = w / n_t, i0 = (t_begin + w % n_t) * WALK_KV;
    const size_t head = (size_t)b * hq + hk * grp + hh;
    load_tile(qs + stage * WALK_KV * LD, LD, q + head * sq * d, i0, WALK_KV, sq, d, d16);
    load_tile(os + stage * WALK_KV * LD, LD, dout + head * sq * dv, i0, WALK_KV, sq, dv, dv16);
    if (threadIdx.x < WALK_KV) {
      const int i = i0 + threadIdx.x;
      ls[stage * WALK_KV + threadIdx.x] = i < sq ? lse[head * sq + i] * LOG2E : 0.f;
      dls[stage * WALK_KV + threadIdx.x] = i < sq ? delta[head * sq + i] : 0.f;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const int kw_lo = k0 + 16 * warp, kw_hi = imin(kw_lo + 15, sk - 1);  // the warp's keys
  const float scale_log2 = scale * LOG2E;
  float dka[DT][4], dva[DT][4];
  zero(dka);
  zero(dva);

  if (n_walk > 0) load_walk(0, 0);
  cp_async_commit();
  for (int w = 0; w < n_walk; ++w) {
    const int st = w & 1;
    if (w + 1 < n_walk) load_walk(w + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and tile w have landed
    __syncthreads();
    const int i0 = (t_begin + w % n_t) * WALK_KV;
    const bf16* qt = qs + st * WALK_KV * LD;
    const bf16* ot = os + st * WALK_KV * LD;
    const float* lt = ls + st * WALK_KV;
    const float* dt = dls + st * WALK_KV;
    // a warp none of whose keys a row of the tile sees has nothing to add
    const int qpos_lo = i0 + off, qpos_hi = imin(i0 + WALK_KV, sq) - 1 + off;
    const bool skip = kw_lo >= sk || (mk.causal && kw_lo > qpos_hi) ||
                      (mk.window > 0 && kw_hi <= qpos_lo - mk.window);
    if (!skip) {
      float pt[NT][4], dpt[NT][4];  // P^T and dP^T: this warp's keys by the tile's rows
      uint32_t x[NT / 2][4];
      product_rows<NT, DMAX / 16>(pt, ks + 16 * warp * LD, qt, LD, d16 / 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * qd + (e & 1);
          pt[nt][e] = mk.visible(i0 + col, e < 2 ? key0 : key1)
                          ? exp2f(pt[nt][e] * scale_log2 - lt[col])
                          : 0.f;
        }
      }
      fragments<NT>(x, pt);
      product_walk<DMAX / 16, NT / 2>(dva, x, ot, LD, dv16, lane);  // dV += P^T dO
      product_rows<NT, DMAX / 16>(dpt, vs + 16 * warp * LD, ot, LD, dv16 / 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - dt[8 * nt + 2 * qd + (e & 1)]);  // dS^T
      }
      fragments<NT>(x, dpt);
      product_walk<DMAX / 16, NT / 2>(dka, x, qt, LD, d16, lane);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with stage st before tile w + 2 lands in it
  }
  cp_async_wait<0>();
  store_rows(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd);
  store_rows(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd);
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int hq, int hkv, int d, int dv, Masks mk,
                             float scale) {
  constexpr int LD = row_ld<DMAX>();
  constexpr int NT = WALK_Q / 8;  // n-tiles of S over a walk tile
  constexpr int DT = DMAX / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* os = qs + OWN * LD;
  bf16* kt_s = os + OWN * LD;       // 2 stages of WALK_Q keys
  bf16* vt_s = kt_s + 2 * WALK_Q * LD;  // 2 stages
  float* ls = reinterpret_cast<float*>(vt_s + 2 * WALK_Q * LD);  // the block's rows: lse * log2(e)
  float* dls = ls + OWN;                                           // and D

  const int d16 = round16(d), dv16 = round16(dv);
  const int sq = mk.sq, sk = mk.sk, off = sk - sq;
  const int qt = (sq + OWN - 1) / OWN - 1 - blockIdx.x;  // the longest causal walk first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (hq / hkv), q0 = qt * OWN;
  const size_t head = (size_t)b * hq + h, kv_head = (size_t)b * hkv + hk;
  const bf16* kb = k + kv_head * sk * d;
  const bf16* vb = v + kv_head * sk * dv;
  load_tile(qs, LD, q + head * sq * d, q0, OWN, sq, d, d16);
  load_tile(os, LD, dout + head * sq * dv, q0, OWN, sq, dv, dv16);
  cp_async_commit();
  if (threadIdx.x < OWN) {
    const int i = q0 + threadIdx.x;
    ls[threadIdx.x] = i < sq ? lse[head * sq + i] * LOG2E : 0.f;
    dls[threadIdx.x] = i < sq ? delta[head * sq + i] : 0.f;
  }

  // The key tiles some row of this tile sees (the forward's walk, in tiles of WALK_Q keys).
  const int k_end = mk.causal ? imin(sk, imin(q0 + OWN, sq) - 1 + off + 1) : sk;
  const int k_begin = (mk.window > 0 ? imax(0, q0 + off - mk.window + 1) : 0) / WALK_Q * WALK_Q;
  const int n_tiles = imax(0, (k_end - k_begin + WALK_Q - 1) / WALK_Q);
  auto load_walk = [&](int t, int stage) {
    const int kt0 = k_begin + t * WALK_Q;
    load_tile(kt_s + stage * WALK_Q * LD, LD, kb, kt0, WALK_Q, sk, d, d16);
    load_tile(vt_s + stage * WALK_Q * LD, LD, vb, kt0, WALK_Q, sk, dv, dv16);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int lr0 = 16 * warp + g, lr1 = lr0 + 8;
  const int r_lo = q0 + 16 * warp;  // the warp's rows, for the tile tests (warp-uniform)
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + off, qpos_hi = imin(r_lo + 16, sq) - 1 + off;
  const float scale_log2 = scale * LOG2E;
  float dqa[DT][4];
  zero(dqa);

  if (n_tiles > 0) load_walk(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load_walk(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile t have landed
    __syncthreads();     // (the first time also the block's lse and D)
    const int kt0 = k_begin + t * WALK_Q;
    const bf16* kt = kt_s + st * WALK_Q * LD;
    const bf16* vt = vt_s + st * WALK_Q * LD;
    const bool skip = !rows_live || (mk.causal && kt0 > qpos_hi) ||
                      (mk.window > 0 && kt0 + WALK_Q - 1 <= qpos_lo - mk.window);
    if (!skip) {
      float s[NT][4], dp[NT][4];  // S (then P) and dP: this warp's rows by the tile's keys
      uint32_t x[NT / 2][4];
      product_rows<NT, DMAX / 16>(s, qs + 16 * warp * LD, kt, LD, d16 / 16, lane);
      product_rows<NT, DMAX / 16>(dp, os + 16 * warp * LD, vt, LD, dv16 / 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? lr0 : lr1;
          const float p = mk.visible(q0 + r, kt0 + 8 * nt + 2 * qd + (e & 1))
                              ? exp2f(s[nt][e] * scale_log2 - ls[r])
                              : 0.f;
          s[nt][e] = p * (dp[nt][e] - dls[r]);  // dS
        }
      }
      fragments<NT>(x, s);
      product_walk<DMAX / 16, NT / 2>(dqa, x, kt, LD, d16, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with stage st before tile t + 2 lands in it
  }
  cp_async_wait<0>();
  store_rows(dq + head * sq * d, dqa, q0 + lr0, q0 + lr1, sq, d, scale, qd);
}

template <int DMAX>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
           const float* delta, bf16* dq, bf16* dk, bf16* dv_out, int b, int hq, int hkv, int d,
           int dv, const Masks& mk, float scale, cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem_bytes<DMAX>(), smem_q = dq_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_dkdv_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_bf16_dq_kernel<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_dkdv_kernel<DMAX><<<dim3((mk.sk + OWN - 1) / OWN, hkv, b), THREADS, smem_kv,
                                     stream>>>(q, k, v, dout, lse, delta, dk, dv_out, hq, hkv, d,
                                               dv, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_bf16_dq_kernel<DMAX><<<dim3((mk.sq + OWN - 1) / OWN, hq, b), THREADS, smem_q,
                                   stream>>>(q, k, v, dout, lse, delta, dq, hq, hkv, d, dv, mk,
                                             scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o and dout (B,Hq,Sq,Dv): bfloat16,
// contiguous, 16-byte aligned (cudaErrorMisalignedAddress otherwise), D and Dv multiples of 8
// up to 128; lse (B,Hq,Sq) float32. Writes delta (B,Hq,Sq) float32 (scratch: D = rowsum(dO o
// O)), dq, dk, dv in bfloat16 (shaped as q, k, v), every element. window <= 0 means no window.
// The caller has checked Hq % Hkv == 0, B, Sq, Sk >= 1, causal/window only with Sq <= Sk, and
// the grid limits. Returns the cudaError_t of the launches (0 on success). Does not
// synchronise.
int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv_out, int b, int hq, int hkv, int sq, int sk,
                                   int d, int dv, int causal, int window, float scale,
                                   void* stream) {
  if (d < 8 || d > MAX_D || dv < 8 || dv > MAX_D || d % 8 != 0 || dv % 8 != 0 || hkv < 1 ||
      hq % hkv != 0 || b < 1 || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv_out);
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;  // 16-byte cp.async copies
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bo = static_cast<const bf16*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const size_t rows = (size_t)b * hq * sq;
  flash_bwd_bf16_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(o), bo, fd, rows, dv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Masks mk{sq, sk, causal, window > 0 ? window : 0};
  bf16* gq = static_cast<bf16*>(dq);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv_out);
  if (round16(d) <= 64 && round16(dv) <= 64)
    return launch<64>(bq, bk, bv, bo, fl, fd, gq, gk, gv, b, hq, hkv, d, dv, mk, scale, s);
  return launch<128>(bq, bk, bv, bo, fl, fd, gq, gk, gv, b, hq, hkv, d, dv, mk, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
