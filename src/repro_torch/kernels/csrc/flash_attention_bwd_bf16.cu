// Flash-attention backward for Hopper (sm_90a), bfloat16: wgmma fed by a TMA ring,
// warp-specialised, float32 sums.
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
// P and dS are rounded to bfloat16 only where they enter a product; P stays float32 in dS.
// Three launches. Each output element is summed in a fixed order in float32 and written once:
// no atomics, so two launches give the same bits and a batch row's gradients do not depend on
// the batch it is in.
//   - flash_bwd_bf16_delta_kernel: D in float32, one warp a row.
//   - flash_bwd_bf16_dkdv_wgmma_kernel: one block per (tile of 128 keys, KV head, batch). It
//     walks the g = Hq / Hkv query heads of its group in order and, for each, the tiles of 64
//     query rows that some of its keys are visible to, recomputing S^T = K Q^T and
//     dP^T = V dO^T. dK and dV stay in float32 registers over the whole walk (the sum over the
//     GQA group, in a fixed order) and are rounded to bfloat16 once; a key tile no query sees
//     writes zeros.
//   - flash_bwd_bf16_dq_wgmma_kernel: one block per (tile of 128 query rows, query head,
//     batch), walking the tiles of 64 keys its rows see and recomputing S and dP; dQ stays in
//     float32 registers and is rounded once.
//
// What bounds it. Five products over the (query, key) pairs the masks keep, 2 pairs (3D + 2Dv)
// FLOPs a head, against one read of q, k, v, o, dO, lse and one write of dq, dk, dv: at
// qwen3-1.7b's train shape (B 2, Hq 16, Hkv 8, S 4096, D = Dv = 128, causal) about S FLOPs a
// byte, far above the card's ridge (295 FLOP/byte in bfloat16), so the tensor cores bound it:
// 3.437e11 FLOPs at 989 TFLOP/s, 0.3475 ms. Recomputing S and dP in the dQ kernel adds two
// products, the price of writing dQ without atomics: the seven products as run take
// 0.487 ms at that rate.
//
// Design (both walk kernels; the float32 backward's wgmma path and the bfloat16 forward are
// the models):
//   - Warp specialisation: 384 threads, warpgroup 0 the producer, warpgroups 1 and 2 the
//     consumers of 64 owned rows each (keys in dK/dV, query rows in dQ); `setmaxnreg` moves
//     registers from the producer (24) to the consumers (240).
//   - TMA: 3-D tensor maps over (B*H, S, D), bfloat16, boxes of 64 rows by 64 columns with
//     the 128-byte swizzle, zeros past S and D from the copy itself. The producer's first warp
//     loads the owned rows once (K and V, or Q and dO) and then each walk tile (Q and dO, or
//     K and V) into a ring of STAGES stages, a full and an empty mbarrier a stage; in dK/dV
//     its lanes also copy the tile's lse (times log2 e) and D beside it. Boxes wholly past S
//     or D are never loaded and never read: a warpgroup whose rows all lie past S has nothing
//     to do, and a chunk of 64 columns wholly past D or Dv is not part of the kernel built for
//     those head dims. The walk loop has no __syncthreads().
//   - Products, each a wgmma m64n64k16: S (S^T) and dP (dP^T) with both operands in shared
//     memory, K-major, reduced over the head dim; dV += P^T dO, dK += dS^T Q and dQ += dS K
//     with A in registers, straight from the S and dP accumulators (the accumulator of 16
//     columns is the A fragment of one k-step: no shuffle, no trip through shared memory),
//     and B the walk tile in shared memory read MN-major through the descriptor's transpose
//     bit. One TMA copy of each tile serves both of its products.
//   - Masks by tile: each (warpgroup, walk tile) is classified once by warp-uniform tests:
//     skipped, fully visible, or cut by an edge (the causal diagonal, the window's edge, a
//     ragged end); only a cut tile runs the code that tests its elements (a select on every
//     element of every tile cost a fifth of the kernels' time: tools/bwd_bf16_probe.py). The
//     warpgroup's index is broadcast by a shuffle, so ptxas sees the tests as uniform: it
//     serializes every wgmma of a kernel behind a branch it cannot prove warp-uniform (notes
//     C7514, C7518).
//   - Overlap: P is computed while dP runs; in dK/dV, dS while P^T dO runs. The two consumer
//     warpgroups take turns on the tensor cores.
//   - Order: 1-D grids, tiles slowest, so that the longest causal walks of every head and
//     batch start first: dK/dV from key tile 0, dQ from the last query tile.
//   Registers at D = Dv = 128 (a consumer thread of dK/dV): dK and dV 64 + 64 float32, S^T
//   and dP^T 32 + 32, P and dS as bfloat16 fragments 16 + 16. Shared memory there: owned rows
//   64 KB, 4 stages of 32 KB, lse and D; 199,752 bytes a block, one block an SM. The kernels
//   are built for 1 or 2 chunks of 64 columns of D and of Dv, so that every loop over k-steps
//   and chunks has a fixed count: a branch between the wgmmas of a product makes the compiler
//   copy their accumulators, and ptxas then serializes every wgmma (its note C7515).
//
// Head dims above 128 (up to 256: recurrentgemma-9b's 256), the "split" builds of 4 chunks
// (`Plan::SPLIT`). The plan above does not carry over: at D = Dv = 256 a consumer's dK and dV
// for 64 owned keys would take 2 x 64 x 256 / 128 = 256 float32 registers a thread before S and
// dP, and 128 owned rows of K and V (128 KB) beside a ring of 4 stages of 64 KB exceed the
// 227 KB a block may have. So a block owns 64 rows, not 128, and both consumer warpgroups own
// all of them: each computes the same S^T and dP^T (S and dP in dQ) over the whole head dim and
// keeps half of the output's column chunks (warpgroup w the chunks [w DC/2, (w+1) DC/2) of dK
// or dQ and likewise of dV), so a thread holds the registers it holds at 128 (dK and dV 64 + 64
// at D = Dv = 256). S and dP are computed twice, rather than shared through shared memory and a
// barrier between the warpgroups: 9 products where 7 would do. Shared memory at D = Dv = 256:
// owned rows 64 KB, 2 stages of 64 KB, lse and D; 198,696 bytes. A chunk of 64 columns wholly
// past D or Dv (D <= 64 or 128 < D <= 192 in these builds) is zeroed once in every place it
// would occupy and never loaded. Every sum keeps its order: the GQA group's heads in order into
// float32 registers, each output element written once.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*. The TMA
// encoder comes from cudaGetDriverEntryPoint (hopper.cuh), so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_D = 256;
constexpr int BOX = 64;      // rows of a TMA box: an owned half, or a walk tile
constexpr int WALK = 64;     // rows of a walk tile: query rows (dK/dV) or keys (dQ)
constexpr int COLS = 64;     // head-dim columns of a box: 128 bytes, the swizzle span
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;  // 24 * 128 + 240 * 256 = 65536 - 1024
constexpr uint32_t ROW_BYTES = COLS * 2;
constexpr uint32_t BOX_BYTES = BOX * ROW_BYTES;    // 8 KB
constexpr uint32_t WALK_CHUNK = WALK * ROW_BYTES;  // 8 KB: a walk tile's 64 columns
constexpr uint32_t KSTEP_ROWS_BYTES = 2 * 8 * ROW_BYTES;  // 16 rows: an MN-major k-step
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

struct Masks {
  int sq, sk, causal, window;  // window <= 0: none

  // Query row i sees key j: the forward's mask on right-aligned positions, ragged edges out.
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int qpos = i + sk - sq;
    return i < sq && j < sk && (!causal || j <= qpos) && (window <= 0 || j > qpos - window);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
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

// The plan of a build of DC and DVC chunks of 64 columns of D and Dv: the rows a block owns,
// the ring's depth, the output chunks a consumer warpgroup keeps; then the shared memory of a
// block, byte offsets from a 1024-byte-aligned base: the owned rows (the operand behind S in DC
// chunks of OWN rows x 64 columns, then the one behind dP in DVC), the ring (STAGES x [the
// walked tensor behind S in DC chunks of WALK rows, then the one behind dP in DVC]), dK/dV's
// ring of lse and D (STAGES x 2 x WALK floats), then the barriers (own, full, empty).
template <int DC, int DVC>
struct Plan {
  static constexpr bool SPLIT = DC > 2 || DVC > 2;  // head dims above 128
  static constexpr int OWN = SPLIT ? 64 : 128;        // owned rows a block
  static constexpr int STAGES = SPLIT ? 2 : 4;        // walk tiles in flight
  static constexpr int KC = SPLIT ? DC / 2 : DC;      // chunks of dK or dQ a warpgroup keeps
  static constexpr int VC = SPLIT ? DVC / 2 : DVC;    // chunks of dV a warpgroup keeps
  static_assert(!SPLIT || (DC % 2 == 0 && DVC % 2 == 0), "split builds halve the chunks");
  static constexpr uint32_t OWN_CHUNK = OWN * ROW_BYTES;  // 16 KB, 8 KB split
  static constexpr uint32_t STAGE_BYTES = (DC + DVC) * WALK_CHUNK;
  static constexpr uint32_t own_s = 0;
  static constexpr uint32_t own_p = own_s + DC * OWN_CHUNK;
  static constexpr uint32_t ring = own_p + DVC * OWN_CHUNK;
  static constexpr uint32_t lse = ring + STAGES * STAGE_BYTES;
  static constexpr uint32_t bars = lse + STAGES * 2 * WALK * 4;
  static constexpr uint32_t total = bars + 8 * (1 + 2 * STAGES);
  static_assert(1024 + total <= 232448, "shared memory of a block");
};

__device__ __forceinline__ uint32_t aligned_base(const uint8_t* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// Initialises the barriers (full: `full_count` arrivals plus the TMA bytes; empty: every
// consumer thread) and makes them visible to the whole block.
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint32_t bars, uint32_t full_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8u * (1 + s), full_count);
      mbar_init(bars + 8u * (1 + STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's loads of the owned rows: rows [row0, row0 + OWN) of two (B*H, n, cols)
// tensors (dcl and dvcl live chunks of 64 columns) at head bh, in boxes of BOX rows; boxes
// wholly past n are not loaded (their warpgroup has no live row and never reads them).
template <int DC, int DVC>
__device__ __forceinline__ void load_owned(uint32_t dst_s, uint32_t dst_p,
                                           const CUtensorMap* map_s, const CUtensorMap* map_p,
                                           uint32_t bar, int row0, int n, int bh, int dcl,
                                           int dvcl) {
  using P = Plan<DC, DVC>;
  constexpr uint32_t chunk = P::OWN_CHUNK;
  const int halves = P::OWN > BOX && row0 + BOX < n ? 2 : 1;
  mbar_expect_tx(bar, halves * (dcl + dvcl) * BOX_BYTES);
  for (int h = 0; h < halves; ++h) {
    for (int c = 0; c < dcl; ++c)
      tma_load(dst_s + c * chunk + h * BOX_BYTES, map_s, bar, c * COLS, row0 + h * BOX, bh);
    for (int c = 0; c < dvcl; ++c)
      tma_load(dst_p + c * chunk + h * BOX_BYTES, map_p, bar, c * COLS, row0 + h * BOX, bh);
  }
}

// The chunks of 64 columns that hold some column below d: the ones the producer loads.
__device__ __forceinline__ int live_chunks(int nc, int d) {
  return imin(nc, (d + COLS - 1) / COLS);
}

// Split builds: zeros in every place a chunk wholly past D or Dv would occupy (owned rows and
// every ring stage), which the producer never loads, so that the products over the head dim
// add zeros there; then the fence that shows the generic proxy's stores to wgmma's async proxy.
// Runs before the barriers' __syncthreads().
template <int DC, int DVC>
__device__ __forceinline__ void zero_dead_chunks(uint8_t* base, int dcl, int dvcl) {
  using P = Plan<DC, DVC>;
  auto zero = [&](uint32_t off, uint32_t bytes) {
    for (uint32_t i = threadIdx.x * 16u; i < bytes; i += THREADS * 16u)
      *reinterpret_cast<uint4*>(base + off + i) = make_uint4(0u, 0u, 0u, 0u);
  };
  for (int c = dcl; c < DC; ++c) zero(P::own_s + c * P::OWN_CHUNK, P::OWN_CHUNK);
  for (int c = dvcl; c < DVC; ++c) zero(P::own_p + c * P::OWN_CHUNK, P::OWN_CHUNK);
  for (int s = 0; s < P::STAGES; ++s) {
    const uint32_t st = P::ring + s * P::STAGE_BYTES;
    for (int c = dcl; c < DC; ++c) zero(st + c * WALK_CHUNK, WALK_CHUNK);
    for (int c = dvcl; c < DVC; ++c) zero(st + (DC + c) * WALK_CHUNK, WALK_CHUNK);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// c (64 x 64) = A B^T over the head dim: A this warpgroup's 64 owned rows, B a walk tile's 64
// rows, both K-major in NC chunks of 64 columns (a_chunk and WALK_CHUNK bytes apart): 4 NC
// k-steps of 16 columns, every one run (columns past the head dim are zeros), so that no
// branch splits the wgmmas of a product.
template <int NC>
__device__ __forceinline__ void product_s(float (&c)[32], uint32_t a, uint32_t a_chunk,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NC * 4; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_bf16_ss(c, kmajor_bf16_desc(a + (kk >> 2) * a_chunk + col),
                  kmajor_bf16_desc(b + (kk >> 2) * WALK_CHUNK + col), kk != 0);
  }
}

// acc (64 x 64 columns, one chunk of the head dim) += X B over the walk tile: X from the
// fragments x of an S-like accumulator, B the walk tile's chunk read MN-major.
__device__ __forceinline__ void product_walk(float (&acc)[32], const uint32_t (&x)[4][4],
                                             uint32_t b) {
#pragma unroll
  for (int j = 0; j < WALK / 16; ++j)
    wgmma_bf16_rs_mn(acc, x[j], mnmajor_bf16_desc(b + j * KSTEP_ROWS_BYTES));
}

// Rows r0 and r1 (< n) of a warpgroup accumulator (NC chunks of 64 columns from chunk c0),
// times mul, as bfloat16 into a row-major (n, cols) matrix: columns below cols (a multiple of 8).
template <int NC>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[NC][32], int r0, int r1,
                                          int n, int cols, float mul, int qd, int c0) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int nt = 0; nt < COLS / 8; ++nt) {
      const int col = (c0 + c) * COLS + 8 * nt + 2 * qd;
      if (col >= cols) continue;
      if (r0 < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * cols + col) =
            __floats2bfloat162_rn(acc[c][4 * nt] * mul, acc[c][4 * nt + 1] * mul);
      if (r1 < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r1 * cols + col) =
            __floats2bfloat162_rn(acc[c][4 * nt + 2] * mul, acc[c][4 * nt + 3] * mul);
    }
  }
}

// P^T of a dK/dV walk tile in place of S^T (this thread's keys key0 and key1 by the tile's
// rows i0 + column): exp2(S^T scale log2(e) - lse log2(e)), lt the tile's lse log2(e); with
// MASKED (a tile an edge cuts) zero where the masks hide the pair.
template <bool MASKED>
__device__ __forceinline__ void probs_kv(float (&st)[32], const float* lt, float scale_log2,
                                         const Masks& mk, int i0, int key0, int key1, int qd) {
#pragma unroll
  for (int nt = 0; nt < WALK / 8; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(lt + 8 * nt + 2 * qd);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(st[4 * nt + e] * scale_log2 - ((e & 1) ? l.y : l.x));
      const int col = 8 * nt + 2 * qd + (e & 1);
      st[4 * nt + e] = !MASKED || mk.visible(i0 + col, e < 2 ? key0 : key1) ? p : 0.f;
    }
  }
}

// P of a dQ walk tile in place of S (this thread's rows row0 and row1, their lse log2(e)
// lse0 and lse1, by the tile's keys kt + column); with MASKED zero where the masks hide the
// pair.
template <bool MASKED>
__device__ __forceinline__ void probs_q(float (&sc)[32], float lse0, float lse1,
                                        float scale_log2, const Masks& mk, int kt, int row0,
                                        int row1, int qd) {
#pragma unroll
  for (int nt = 0; nt < WALK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[4 * nt + e] * scale_log2 - (e < 2 ? lse0 : lse1));
      const int key = kt + 8 * nt + 2 * qd + (e & 1);
      sc[4 * nt + e] = !MASKED || mk.visible(e < 2 ? row0 : row1, key) ? p : 0.f;
    }
  }
}

// dK and dV of OWN keys of one KV head, summed over the query heads of its group. DC, DVC: the
// chunks of 64 columns of D and Dv (1 or 2).
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_bf16_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap o_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const float* __restrict__ lse, const float* __restrict__ delta,
                                     bf16* __restrict__ dk, bf16* __restrict__ dv_out, int batch,
                                     int hq, int hkv, int d, int dv, Masks mk, float scale) {
  using L = Plan<DC, DVC>;
  constexpr int OWN = L::OWN, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = aligned_base(smem_raw);
  uint8_t* base = smem_raw + (s0 - smem_u32(smem_raw));
  float* lse_ring = reinterpret_cast<float*>(base + L::lse);
  const uint32_t own_full = s0 + L::bars;
  auto full = [&](int s) { return s0 + L::bars + 8u * (1 + s); };
  auto empty = [&](int s) { return s0 + L::bars + 8u * (1 + STAGES + s); };
  auto stage = [&](int s) { return s0 + L::ring + s * L::STAGE_BYTES; };
  // chunks the producer loads: all of them below 128 columns, where none lies wholly past D
  const int dcl = L::SPLIT ? live_chunks(DC, d) : DC;
  const int dvcl = L::SPLIT ? live_chunks(DVC, dv) : DVC;

  // Blocks in the order of their key tiles across every (KV head, batch): the longest causal
  // walks, the first key tiles', start first on the card.
  const int heads = hkv * batch;
  const int hk = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = (blockIdx.x / heads) * OWN, off = sk - sq;
  // The query rows that some key of this block is visible to, as tiles [t_begin, ...).
  const int k_last = imin(k0 + OWN, sk) - 1;
  const int i_begin = mk.causal ? imax(0, k0 - off) : 0;
  const int i_end = mk.window > 0 ? imin(sq, k_last + mk.window - off) : sq;
  const int t_begin = i_begin / WALK;
  const int per_head = i_end > i_begin ? (i_end + WALK - 1) / WALK - t_begin : 0;
  const int n_tiles = grp * per_head;  // the group's heads in order, each its tiles in order

  if constexpr (L::SPLIT) zero_dead_chunks<DC, DVC>(base, dcl, dvcl);
  init_barriers<STAGES>(s0 + L::bars, 32);  // full: the producer warp's lanes, one with TMA bytes

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp loads the owned rows, then the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0)
        load_owned<DC, DVC>(s0 + L::own_s, s0 + L::own_p, &k_map, &v_map, own_full, k0, sk,
                            b * hkv + hk, dcl, dvcl);
      int hh = 0, t = t_begin;  // the walk tile's query head in the group, and its tile
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, i0 = t * WALK;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const int head = b * hq + hk * grp + hh;
        for (int r = lane; r < WALK; r += 32) {
          const int i = i0 + r;
          lse_ring[(2 * s) * WALK + r] = i < sq ? lse[(size_t)head * sq + i] * LOG2E : 0.f;
          lse_ring[(2 * s + 1) * WALK + r] = i < sq ? delta[(size_t)head * sq + i] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), (dcl + dvcl) * WALK_CHUNK);
          for (int c = 0; c < dcl; ++c)
            tma_load(stage(s) + c * WALK_CHUNK, &q_map, full(s), c * COLS, i0, head);
          for (int c = 0; c < dvcl; ++c)
            tma_load(stage(s) + (DC + c) * WALK_CHUNK, &o_map, full(s), c * COLS, i0, head);
        } else {
          mbar_arrive(full(s));
        }
        if (++t == t_begin + per_head) {
          t = t_begin;
          ++hh;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each (split: the same 64, half the columns each) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int own0 = L::SPLIT ? 0 : 64 * wgi;  // the warpgroup's first row in the block
  const int kc0 = L::SPLIT ? wgi * L::KC : 0, vc0 = L::SPLIT ? wgi * L::VC : 0;  // its chunks
  const int key0 = k0 + own0 + 16 * (tid / 32) + g, key1 = key0 + 8;
  const int kw_lo = k0 + own0, kw_hi = imin(kw_lo + 63, sk - 1);  // the warpgroup's keys
  const uint32_t a_k = s0 + L::own_s + (L::SPLIT ? 0 : wgi * BOX_BYTES);
  const uint32_t a_v = s0 + L::own_p + (L::SPLIT ? 0 : wgi * BOX_BYTES);
  const float scale_log2 = scale * LOG2E;
  float dka[L::KC][32], dva[L::VC][32];
#pragma unroll
  for (int c = 0; c < L::KC; ++c) zero(dka[c]);
#pragma unroll
  for (int c = 0; c < L::VC; ++c) zero(dva[c]);
  mbar_wait(own_full, 0);

  int t = t_begin;  // the walk tile's index in its query head's walk
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, i0 = t * WALK;
    const int qpos_lo = i0 + off, qpos_hi = imin(i0 + WALK, sq) - 1 + off;
    // a warpgroup none of whose keys a row of the tile sees has nothing to add; one whose
    // keys every row sees masks nothing
    const bool skip = kw_lo >= sk || (mk.causal && kw_lo > qpos_hi) ||
                      (mk.window > 0 && kw_hi <= qpos_lo - mk.window);
    const bool edge = i0 + WALK > sq || kw_lo + 64 > sk || (mk.causal && kw_lo + 63 > qpos_lo) ||
                      (mk.window > 0 && kw_lo <= qpos_hi - mk.window);
    const uint32_t qt = stage(s), ot = stage(s) + DC * WALK_CHUNK;
    const float* lt = lse_ring + 2 * s * WALK;  // lse * log2(e), then D
    mbar_wait(full(s), (it / STAGES) & 1);
    if (!skip) {
      float st[32], dpt[32];  // S^T and dP^T: this warpgroup's keys by the tile's rows
      uint32_t pf[WALK / 16][4], sf[WALK / 16][4];
      wgmma_fence();
      product_s<DC>(st, a_k, L::OWN_CHUNK, qt);
      wgmma_commit();
      product_s<DVC>(dpt, a_v, L::OWN_CHUNK, ot);
      wgmma_commit();
      wgmma_wait_pending<1>();  // S^T
      pin(st);
      if (edge)  // P^T
        probs_kv<true>(st, lt, scale_log2, mk, i0, key0, key1, qd);
      else
        probs_kv<false>(st, lt, scale_log2, mk, i0, key0, key1, qd);
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[j][r] = pack_bf16(st[8 * j + 2 * r], st[8 * j + 2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < L::VC; ++c) pin(dva[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::VC; ++c)
        product_walk(dva[c], pf, ot + (vc0 + c) * WALK_CHUNK);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait_pending<1>();  // dP^T (P^T dO may still run)
      pin(dpt);
#pragma unroll
      for (int nt = 0; nt < WALK / 8; ++nt) {
        const float2 dl = *reinterpret_cast<const float2*>(lt + WALK + 8 * nt + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * nt + e] = st[4 * nt + e] * (dpt[4 * nt + e] - ((e & 1) ? dl.y : dl.x));  // dS^T
      }
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sf[j][r] = pack_bf16(dpt[8 * j + 2 * r], dpt[8 * j + 2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < L::KC; ++c) pin(dka[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::KC; ++c)
        product_walk(dka[c], sf, qt + (kc0 + c) * WALK_CHUNK);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < L::KC; ++c) pin(dka[c]);
#pragma unroll
      for (int c = 0; c < L::VC; ++c) pin(dva[c]);
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) {
        pin(pf[j]);
        pin(sf[j]);
      }
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
    t = t + 1 == t_begin + per_head ? t_begin : t + 1;
  }
  const size_t kv_head = (size_t)b * hkv + hk;
  store_acc<L::KC>(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd, kc0);
  store_acc<L::VC>(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd, vc0);
}

// dQ of OWN query rows of one head.
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_bf16_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap o_map,
                                   const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   bf16* __restrict__ dq, int batch, int hq, int hkv, int d,
                                   int dv, Masks mk, float scale) {
  using L = Plan<DC, DVC>;
  constexpr int OWN = L::OWN, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = aligned_base(smem_raw);
  // chunks the producer loads: all of them below 128 columns, where none lies wholly past D
  const int dcl = L::SPLIT ? live_chunks(DC, d) : DC;
  const int dvcl = L::SPLIT ? live_chunks(DVC, dv) : DVC;
  const uint32_t own_full = s0 + L::bars;
  auto full = [&](int s) { return s0 + L::bars + 8u * (1 + s); };
  auto empty = [&](int s) { return s0 + L::bars + 8u * (1 + STAGES + s); };
  auto stage = [&](int s) { return s0 + L::ring + s * L::STAGE_BYTES; };

  // Blocks from the last query tile (the longest causal walk) to the first, each tile across
  // every (head, batch) before the next.
  const int sq = mk.sq, sk = mk.sk, off = sk - sq, heads = hq * batch;
  const int q0 = ((sq + OWN - 1) / OWN - 1 - (int)blockIdx.x / heads) * OWN;
  const int h = blockIdx.x % heads % hq, b = blockIdx.x % heads / hq, hk = h / (hq / hkv);
  // The key tiles some row of this block sees (the forward's walk, in tiles of WALK keys).
  const int k_end = mk.causal ? imin(sk, imin(q0 + OWN, sq) - 1 + off + 1) : sk;
  const int k_begin = (mk.window > 0 ? imax(0, q0 + off - mk.window + 1) : 0) / WALK * WALK;
  const int n_tiles = imax(0, (k_end - k_begin + WALK - 1) / WALK);

  if constexpr (L::SPLIT) {
    zero_dead_chunks<DC, DVC>(smem_raw + (s0 - smem_u32(smem_raw)), dcl, dvcl);
  }
  init_barriers<STAGES>(s0 + L::bars, 1);

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads the owned rows, then the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      load_owned<DC, DVC>(s0 + L::own_s, s0 + L::own_p, &q_map, &o_map, own_full, q0, sq,
                          b * hq + h, dcl, dvcl);
      const int kv_bh = b * hkv + hk;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, kt = k_begin + it * WALK;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), (dcl + dvcl) * WALK_CHUNK);
        for (int c = 0; c < dcl; ++c)
          tma_load(stage(s) + c * WALK_CHUNK, &k_map, full(s), c * COLS, kt, kv_bh);
        for (int c = 0; c < dvcl; ++c)
          tma_load(stage(s) + (DC + c) * WALK_CHUNK, &v_map, full(s), c * COLS, kt, kv_bh);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each (split: the same 64, half the columns) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const size_t head = (size_t)b * hq + h;
  const int kc0 = L::SPLIT ? wgi * L::KC : 0;  // the warpgroup's chunks of dQ
  const int r_lo = q0 + (L::SPLIT ? 0 : 64 * wgi);  // the warpgroup's rows, for the tile tests
  const int row0 = r_lo + 16 * (tid / 32) + g, row1 = row0 + 8;
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + off, qpos_hi = imin(r_lo + 64, sq) - 1 + off;
  const float lse0 = row0 < sq ? lse[head * sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < sq ? lse[head * sq + row1] * LOG2E : 0.f;
  const float dl0 = row0 < sq ? delta[head * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[head * sq + row1] : 0.f;
  const uint32_t a_q = s0 + L::own_s + (L::SPLIT ? 0 : wgi * BOX_BYTES);
  const uint32_t a_o = s0 + L::own_p + (L::SPLIT ? 0 : wgi * BOX_BYTES);
  const float scale_log2 = scale * LOG2E;
  float dqa[L::KC][32];
#pragma unroll
  for (int c = 0; c < L::KC; ++c) zero(dqa[c]);
  mbar_wait(own_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, kt = k_begin + it * WALK;
    const bool skip = !rows_live || (mk.causal && kt > qpos_hi) ||
                      (mk.window > 0 && kt + WALK - 1 <= qpos_lo - mk.window);
    const bool edge = r_lo + 64 > sq || kt + WALK > sk || (mk.causal && kt + WALK - 1 > qpos_lo) ||
                      (mk.window > 0 && kt <= qpos_hi - mk.window);
    const uint32_t kt_s = stage(s), vt_s = stage(s) + DC * WALK_CHUNK;
    mbar_wait(full(s), (it / STAGES) & 1);
    if (!skip) {
      float sc[32], dp[32];  // S and dP: this warpgroup's rows by the tile's keys
      uint32_t sf[WALK / 16][4];
      wgmma_fence();
      product_s<DC>(sc, a_q, L::OWN_CHUNK, kt_s);
      wgmma_commit();
      product_s<DVC>(dp, a_o, L::OWN_CHUNK, vt_s);
      wgmma_commit();
      wgmma_wait_pending<1>();  // S
      pin(sc);
      if (edge)  // P
        probs_q<true>(sc, lse0, lse1, scale_log2, mk, kt, row0, row1, qd);
      else
        probs_q<false>(sc, lse0, lse1, scale_log2, mk, kt, row0, row1, qd);
      wgmma_wait_pending<0>();  // dP
      pin(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= dp[e] - ((e & 2) ? dl1 : dl0);  // dS
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sf[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < L::KC; ++c) pin(dqa[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::KC; ++c)
        product_walk(dqa[c], sf, kt_s + (kc0 + c) * WALK_CHUNK);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < L::KC; ++c) pin(dqa[c]);
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) pin(sf[j]);
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
  }
  store_acc<L::KC>(dq + head * sq * d, dqa, row0, row1, sq, d, scale, qd, kc0);
}

// A (B*H, rows, cols) bfloat16 tensor as a 3-D tensor map; boxes of (1, BOX, COLS), 128-byte
// swizzle, zeros outside the tensor. cols must be a multiple of 8 (a 16-byte row stride).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)COLS, (cuuint32_t)BOX, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DC, int DVC>
size_t shared_bytes() {
  return 1024 + Plan<DC, DVC>::total;
}

template <int DC, int DVC>
int launch(const CUtensorMap& qm, const CUtensorMap& om, const CUtensorMap& km,
           const CUtensorMap& vm, const float* lse, const float* delta, bf16* dq, bf16* dk,
           bf16* dv_out, int b, int hq, int hkv, int d, int dv, const Masks& mk, float scale,
           cudaStream_t stream) {
  constexpr int OWN = Plan<DC, DVC>::OWN;
  const size_t smem = shared_bytes<DC, DVC>();
  auto kv_kernel = flash_bwd_bf16_dkdv_wgmma_kernel<DC, DVC>;
  auto q_kernel = flash_bwd_bf16_dq_wgmma_kernel<DC, DVC>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 1-D grids of (tile, head, batch), tiles slowest
  kv_kernel<<<(mk.sk + OWN - 1) / OWN * hkv * b, THREADS, smem, stream>>>(
      qm, om, km, vm, lse, delta, dk, dv_out, b, hq, hkv, d, dv, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<(mk.sq + OWN - 1) / OWN * hq * b, THREADS, smem, stream>>>(
      qm, om, km, vm, lse, delta, dq, b, hq, hkv, d, dv, mk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o and dout (B,Hq,Sq,Dv): bfloat16,
// contiguous, 16-byte aligned (cudaErrorMisalignedAddress otherwise: TMA's base addresses),
// D and Dv multiples of 8 up to 256 (TMA's 16-byte row strides); lse (B,Hq,Sq) float32.
// Writes delta (B,Hq,Sq) float32 (scratch: D = rowsum(dO o O)), dq, dk, dv in bfloat16 (shaped
// as q, k, v), every element. window <= 0 means no window. The caller has checked
// Hq % Hkv == 0, B, Sq, Sk >= 1, causal/window only with Sq <= Sk, and the grid limits. Returns
// the cudaError_t of the launches (0 on success). Does not synchronise.
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
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  CUtensorMap qm, om, km, vm;
  cudaError_t err = make_map(&qm, q, b * hq, sq, d);
  if (err == cudaSuccess) err = make_map(&om, dout, b * hq, sq, dv);
  if (err == cudaSuccess) err = make_map(&km, k, b * hkv, sk, d);
  if (err == cudaSuccess) err = make_map(&vm, v, b * hkv, sk, dv);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* bo = static_cast<const bf16*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(delta);
  const size_t rows = (size_t)b * hq * sq;
  flash_bwd_bf16_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(o), bo, fd, rows, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Masks mk{sq, sk, causal, window > 0 ? window : 0};
  bf16* gq = static_cast<bf16*>(dq);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv_out);
#define REPRO_LAUNCH(DC, DVC) \
  launch<DC, DVC>(qm, om, km, vm, fl, fd, gq, gk, gv, b, hq, hkv, d, dv, mk, scale, s)
  if (d > 128 || dv > 128) {  // the split builds: 2 or 4 chunks of each
    if (d > 128) return dv > 128 ? REPRO_LAUNCH(4, 4) : REPRO_LAUNCH(4, 2);
    return REPRO_LAUNCH(2, 4);
  }
  if (d <= 64) return dv <= 64 ? REPRO_LAUNCH(1, 1) : REPRO_LAUNCH(1, 2);
  return dv <= 64 ? REPRO_LAUNCH(2, 1) : REPRO_LAUNCH(2, 2);
#undef REPRO_LAUNCH
}

// Dynamic shared memory a block of the dK/dV or dQ kernel asks for (the two are equal) at
// head dims D and Dv.
int repro_flash_attention_bwd_bf16_shared_bytes(int d, int dv) {
  if (d > 128 || dv > 128) {
    if (d > 128) return (int)(dv > 128 ? shared_bytes<4, 4>() : shared_bytes<4, 2>());
    return (int)shared_bytes<2, 4>();
  }
  if (d <= 64) return (int)(dv <= 64 ? shared_bytes<1, 1>() : shared_bytes<1, 2>());
  return (int)(dv <= 64 ? shared_bytes<2, 1>() : shared_bytes<2, 2>());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
