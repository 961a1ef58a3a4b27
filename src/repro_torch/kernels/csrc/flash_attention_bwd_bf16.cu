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
// The FlashAttention-2 form, from the forward's output O in float32 before its rounding and
// each row's float32 logsumexp lse (which flash_fwd_wgmma_kernel writes, both, when asked):
//   D = rowsum(dO o O);  P = exp(S scale - lse);  dV = P^T dO;  dP = dO V^T;
//   dS = P o (dP - D);   dQ = dS K scale;         dK = dS^T Q scale.
// P and dS are rounded to bfloat16 only where they enter a product; P stays float32 in dS.
// Three launches (four in a split build whose dK/dV walks are cut into parts: see the end of
// this note).
// Each output element is summed in a fixed order in float32 and written once:
// no atomics, so two launches give the same bits and a batch row's gradients do not depend on
// the batch it is in.
//   - flash_bwd_bf16_delta_kernel: D in float32, one warp a row. From O in float32, D is the
//     row's sum of P dP up to float32 rounding, and the row's dS sums to zero as in the exact
//     gradient. From the bfloat16 O it would sum to dO.(O - bf16(O)), a rounding of up to 2^-9
//     of each O entry, which dQ = dS K carries as that sum times the mean of the row's keys:
//     where the keys share a common component much larger than their spread (an encoder's
//     output after many layers of near-uniform attention), dQ would take a large share of
//     that error.
//   - flash_bwd_bf16_dkdv_wgmma_kernel: one block per (tile of 128 keys, KV head, batch). It
//     walks the g = Hq / Hkv query heads of its group in order and, for each, the tiles of 64
//     query rows that some of its keys are visible to, recomputing S^T = K Q^T and
//     dP^T = V dO^T. dK and dV stay in float32 registers over the whole walk (the sum over the
//     GQA group, in a fixed order) and are rounded to bfloat16 once; a key tile no query sees
//     writes zeros.
//   - flash_bwd_bf16_dq_wgmma_kernel: one block per (tile of 128 query rows, query head,
//     batch), walking the tiles of 64 keys its rows see and recomputing S and dP; dQ stays in
//     float32 registers and is rounded once. A row's exact dS sums to zero, but the dS that
//     enters dQ += dS K sums to r = (the row's sum of P dP) - D plus its roundings to bfloat16,
//     and D comes from an O that the forward summed over P rounded to bfloat16: dQ carries r
//     times the keys' common component (keys offset by 8 times their spread: dQ 3.5e-2 off by
//     relative L2 on an H100, 20 times the plain version's error, whose P and dS are float32).
//     So the block also sums r over its walk, each row in float32 from the bfloat16 dS it
//     used, and takes r kbar from dQ, kbar the mean of the first walked tile's keys (any
//     vector would keep the exact dQ, since the exact dS sums to zero; one near the keys'
//     common component leaves only their spread behind r). The producer warpgroup's idle warps
//     compute kbar from global memory while the walk runs. dK += dS^T Q needs no such step: a
//     key's dS column does not sum to zero.
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
// Head dims above 128 (up to 256: recurrentgemma-9b's 256), the "split" builds of 2 or 4
// chunks of 64 columns of D and of Dv, kernels of their own. The plan above does not carry
// over: at D = Dv = 256 a consumer's dK and dV for 64 owned keys would take 2 x 64 x 256 / 128 =
// 256 float32 registers a thread before S and dP, and 128 owned rows of K and V (128 KB) beside
// a ring of 4 stages of 64 KB exceed the 227 KB a block may have. So (`SplitPlan`):
//   - flash_bwd_bf16_dkdv_split_kernel: a block owns 64 keys, shared by both consumer
//     warpgroups, and S^T and dP^T are computed once a walk tile: consumer warpgroup w takes
//     the tile's 32 query rows [32w, 32w + 32), S^T and dP^T as wgmma m64n32 over the whole
//     head dim, then its half of P^T and dS^T in float32 registers, written as bfloat16 into
//     64 x 64 exchange tiles in shared memory laid out as TMA lays a box (128-byte swizzle),
//     which wgmma reads as a K-major A operand. A named barrier between the two consumer
//     warpgroups (the producer runs on) hands the tiles over; each warpgroup then runs its
//     half of dK's and dV's column chunks ([w DC/2, (w+1) DC/2) of dK, likewise of dV) over all
//     64 rows, both operands in shared memory: four products' work a tile. The exchange tiles
//     are double-buffered by the tile's parity, so one barrier a tile suffices. One thread then
//     stores the tile's dS^T with a TMA store into a bfloat16 scratch for dQ, which holds for
//     each (batch, query head) the tiles of every query tile's walk, one walk after another
//     (ds_offset): exactly the tiles walked.
//   - The walk of a key tile over the GQA group's (query head, query tile) pairs is cut into
//     `parts` spans of equal length (within one tile), each on a block of its own, so that the
//     longest walks spread over every SM: at recurrentgemma-9b's train shape (MQA, 16 heads,
//     causal, window 2048) 64 key tiles x 8 parts. The host chooses `parts` from the shapes
//     and masks alone, never from B (kernels/flash_attention.py bwd_split_plan). With one part
//     the block writes dK and dV; with more each writes its float32 partial into a scratch the
//     wrapper allocates, and flash_bwd_bf16_dkdv_reduce_kernel adds a key's partials in part
//     order and rounds once.
//   - flash_bwd_bf16_dq_split_kernel: dQ = scale sum of dS K over the key tiles in order, from
//     the stored dS^T tiles (one product a tile: S and dP are not recomputed), a block per two
//     tiles of 64 query rows of one head, a consumer warpgroup each, one copy of a K tile
//     serving both (`DqPlan`: a ring of 4 stages of K and the two dS^T tiles).
// Shared memory at D = Dv = 256: dK/dV owned rows 64 KB, 2 ring stages of 64 KB, the exchange
// tiles 2 x 16 KB, lse and D, 231,464 bytes; dQ 4 stages of 48 KB, 197,696 bytes. A chunk of 64
// columns wholly past D or Dv (D <= 64 or 128 < D <= 192 in these builds) is zeroed once in
// every place it would occupy and never loaded. Every sum keeps its order: within a part the
// heads in order, then each tile in order, into float32 registers; the parts in order; dQ's
// key tiles in order; each output element written once.
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
constexpr int MAX_PARTS = 8;  // pieces of a key tile's walk in the split builds
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

// Split builds: the key tiles [kb, ke) that some row of query tile qt sees (the forward's walk,
// in tiles of WALK keys): those the dQ kernel walks, whose dS^T tiles the dK/dV kernel stores.
__host__ __device__ __forceinline__ void dq_walk(const Masks& mk, int qt, int& kb, int& ke) {
  const int q0 = qt * WALK, off = mk.sk - mk.sq;
  const int k_end = mk.causal ? imin(mk.sk, imin(q0 + WALK, mk.sq) - 1 + off + 1) : mk.sk;
  kb = (mk.window > 0 ? imax(0, q0 + off - mk.window + 1) : 0) / WALK;
  ke = imax(kb, (k_end + WALK - 1) / WALK);
}

// Split builds: the dS scratch holds, for each (batch, query head), the dS^T tiles of every
// query tile's walk, the tiles in order, one walk after another: ds_tiles(mk) slots a head.
// Query tile qt's first is ds_offset(mk, qt), the sum of the walks before it
// (kernels/flash_attention.py bwd_ds_offsets); computed by a whole warp, every lane gets it.
__device__ __forceinline__ int ds_offset(const Masks& mk, int qt, int lane) {
  int sum = 0;
  for (int j = lane; j < qt; j += 32) {
    int kb, ke;
    dq_walk(mk, j, kb, ke);
    sum += ke - kb;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, o);
  return sum;
}

int ds_tiles(const Masks& mk) {
  int n = 0;
  for (int qt = 0; qt < (mk.sq + WALK - 1) / WALK; ++qt) {
    int kb, ke;
    dq_walk(mk, qt, kb, ke);
    n += ke - kb;
  }
  return n;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
}

// D = rowsum(dO o O) in float32, O in float32: one warp a row, lanes over pairs of columns,
// then a fixed butterfly.
__global__ void __launch_bounds__(256)
    flash_bwd_bf16_delta_kernel(const float* __restrict__ o, const bf16* __restrict__ dout,
                                float* __restrict__ delta, size_t rows, int dv) {
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float2* a = reinterpret_cast<const float2*>(o + row * dv);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(dout + row * dv);
  float s = 0.f;
  for (int c = lane; c < dv / 2; c += 32) {
    const float2 x = a[c], y = __bfloat1622float2(b[c]);
    s += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL_MASK, s, m);
  if (lane == 0) delta[row] = s;
}

// The plan of a build of DC and DVC chunks of 64 columns of D and Dv (1 or 2 each): the rows
// a block owns, the ring's depth; then the shared memory of a block, byte offsets from a
// 1024-byte-aligned base: the owned rows (the operand behind S in DC chunks of OWN rows x 64
// columns, then the one behind dP in DVC), the ring (STAGES x [the walked tensor behind S in DC
// chunks of WALK rows, then the one behind dP in DVC]), dK/dV's ring of lse and D (STAGES x 2 x
// WALK floats), dQ's kbar (DC x 64 floats), then the barriers (own, full, empty).
template <int DC, int DVC>
struct Plan {
  static constexpr int OWN = 128;   // owned rows a block
  static constexpr int STAGES = 4;  // walk tiles in flight
  static constexpr uint32_t OWN_CHUNK = OWN * ROW_BYTES;  // 16 KB
  static constexpr uint32_t STAGE_BYTES = (DC + DVC) * WALK_CHUNK;
  static constexpr uint32_t own_s = 0;
  static constexpr uint32_t own_p = own_s + DC * OWN_CHUNK;
  static constexpr uint32_t ring = own_p + DVC * OWN_CHUNK;
  static constexpr uint32_t lse = ring + STAGES * STAGE_BYTES;
  static constexpr uint32_t kbar = lse + STAGES * 2 * WALK * 4;
  static constexpr uint32_t bars = kbar + DC * COLS * 4;
  static constexpr uint32_t total = bars + 8 * (1 + 2 * STAGES);
  static_assert(1024 + total <= 232448, "shared memory of a block");
};

// The split builds' plan (DC and DVC chunks of 64 columns, 2 or 4 each, one of them 4): a block
// owns 64 rows, which both consumer warpgroups share; each keeps KC chunks of dK or dQ and VC
// of dV. Shared memory from a 1024-byte-aligned base: the owned rows, the ring as above, the
// exchange (2 buffers of [P^T, dS^T], 64 x 64 bfloat16 each; dQ uses the first tile of each),
// dK/dV's ring of lse and D, the barriers.
template <int DC, int DVC>
struct SplitPlan {
  static constexpr int OWN = 64;
  static constexpr int STAGES = 2;
  static constexpr int KC = DC / 2, VC = DVC / 2;
  static_assert(DC % 2 == 0 && DVC % 2 == 0, "split builds halve the output's chunks");
  static constexpr uint32_t OWN_CHUNK = OWN * ROW_BYTES;  // 8 KB
  static constexpr uint32_t STAGE_BYTES = (DC + DVC) * WALK_CHUNK;
  static constexpr uint32_t TILE = WALK * ROW_BYTES;  // 8 KB: a 64 x 64 exchange tile
  static constexpr uint32_t own_s = 0;
  static constexpr uint32_t own_p = own_s + DC * OWN_CHUNK;
  static constexpr uint32_t ring = own_p + DVC * OWN_CHUNK;
  static constexpr uint32_t xch = ring + STAGES * STAGE_BYTES;
  static constexpr uint32_t lse = xch + 2 * 2 * TILE;
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
// tensors (dcl and dvcl live chunks of 64 columns, OWN rows apart) at head bh, in boxes of BOX
// rows; boxes wholly past n are not loaded (their warpgroup has no live row and never reads
// them).
template <int OWN>
__device__ __forceinline__ void load_owned(uint32_t dst_s, uint32_t dst_p,
                                           const CUtensorMap* map_s, const CUtensorMap* map_p,
                                           uint32_t bar, int row0, int n, int bh, int dcl,
                                           int dvcl) {
  constexpr uint32_t chunk = OWN * ROW_BYTES;
  const int halves = OWN > BOX && row0 + BOX < n ? 2 : 1;
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
  using P = SplitPlan<DC, DVC>;
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

// Split builds. c (64 x 32) = A B^T over the head dim: A the 64 owned rows, B 32 rows of a walk
// tile (a consumer warpgroup's half), both K-major in NC chunks of 64 columns (a_chunk and
// WALK_CHUNK bytes apart): every k-step run, as product_s.
template <int NC>
__device__ __forceinline__ void product_half(float (&c)[16], uint32_t a, uint32_t a_chunk,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NC * 4; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_bf16_ss_n32(c, kmajor_bf16_desc(a + (kk >> 2) * a_chunk + col),
                      kmajor_bf16_desc(b + (kk >> 2) * WALK_CHUNK + col), kk != 0);
  }
}

// Split builds. acc (64 x 64 columns, one chunk of the head dim) += X B over the walk tile: X an
// exchange tile (64 x 64, K-major), B the walk tile's chunk read MN-major.
__device__ __forceinline__ void product_walk_ss(float (&acc)[32], uint32_t x, uint32_t b) {
#pragma unroll
  for (int j = 0; j < WALK / 16; ++j)
    wgmma_bf16_ss_mn(acc, kmajor_bf16_desc(x + j * 32),
                     mnmajor_bf16_desc(b + j * KSTEP_ROWS_BYTES));
}

// A warpgroup's m64n32 accumulator x (this thread's rows 16 warp + g and + 8, columns c0 +
// 8 nt + 2 qd and + 1 of a 64 x 64 tile) as bfloat16 into the exchange tile at `tile`, in the
// layout TMA gives a box (row r's 16-byte unit u at u ^ (r & 7)): what a K-major descriptor
// reads. Rows hold 128 bytes, so a warp's stores fall on 32 different banks.
__device__ __forceinline__ void store_half(uint8_t* tile, const float (&x)[16], int warp, int g,
                                           int qd, int c0) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int unit = ((c0 >> 3) + nt) ^ g;  // both rows are g mod 8
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + (16 * warp + g + 8 * h) * ROW_BYTES + unit * 16 +
                                   4 * qd) = pack_bf16(x[4 * nt + 2 * h], x[4 * nt + 2 * h + 1]);
  }
}

// Rows r0 and r1 (< n) of a warpgroup accumulator (NC chunks of 64 columns from chunk c0) in
// float32 into a row-major (n, cols) matrix: columns below cols.
template <int NC>
__device__ __forceinline__ void store_partial(float* dst, const float (&acc)[NC][32], int r0,
                                              int r1, int n, int cols, int qd, int c0) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int nt = 0; nt < COLS / 8; ++nt) {
      const int col = (c0 + c) * COLS + 8 * nt + 2 * qd;
      if (col >= cols) continue;
      if (r0 < n)
        *reinterpret_cast<float2*>(dst + (size_t)r0 * cols + col) =
            make_float2(acc[c][4 * nt], acc[c][4 * nt + 1]);
      if (r1 < n)
        *reinterpret_cast<float2*>(dst + (size_t)r1 * cols + col) =
            make_float2(acc[c][4 * nt + 2], acc[c][4 * nt + 3]);
    }
  }
}

// P^T of a dK/dV walk tile in place of S^T (this thread's keys key0 and key1 by the tile's
// rows i0 + column; N / 4 columns, 64 or 32): exp2(S^T scale log2(e) - lse log2(e)), lt the
// rows' lse log2(e); with MASKED (a tile an edge cuts) zero where the masks hide the pair.
template <bool MASKED, int N>
__device__ __forceinline__ void probs_kv(float (&st)[N], const float* lt, float scale_log2,
                                         const Masks& mk, int i0, int key0, int key1, int qd) {
#pragma unroll
  for (int nt = 0; nt < N / 4; ++nt) {
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
// lse0 and lse1, by the tile's keys kt + column; N / 4 columns); with MASKED zero where the
// masks hide the pair.
template <bool MASKED, int N>
__device__ __forceinline__ void probs_q(float (&sc)[N], float lse0, float lse1,
                                        float scale_log2, const Masks& mk, int kt, int row0,
                                        int row1, int qd) {
#pragma unroll
  for (int nt = 0; nt < N / 4; ++nt) {
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

  init_barriers<STAGES>(s0 + L::bars, 32);  // full: the producer warp's lanes, one with TMA bytes

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp loads the owned rows, then the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0)
        load_owned<OWN>(s0 + L::own_s, s0 + L::own_p, &k_map, &v_map, own_full, k0, sk,
                        b * hkv + hk, DC, DVC);
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
          mbar_expect_tx(full(s), (DC + DVC) * WALK_CHUNK);
          for (int c = 0; c < DC; ++c)
            tma_load(stage(s) + c * WALK_CHUNK, &q_map, full(s), c * COLS, i0, head);
          for (int c = 0; c < DVC; ++c)
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

  // ---- consumer warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int own0 = 64 * wgi;  // the warpgroup's first row in the block
  const int key0 = k0 + own0 + 16 * (tid / 32) + g, key1 = key0 + 8;
  const int kw_lo = k0 + own0, kw_hi = imin(kw_lo + 63, sk - 1);  // the warpgroup's keys
  const uint32_t a_k = s0 + L::own_s + wgi * BOX_BYTES;
  const uint32_t a_v = s0 + L::own_p + wgi * BOX_BYTES;
  const float scale_log2 = scale * LOG2E;
  float dka[DC][32], dva[DVC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c) zero(dka[c]);
#pragma unroll
  for (int c = 0; c < DVC; ++c) zero(dva[c]);
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
      for (int c = 0; c < DVC; ++c) pin(dva[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DVC; ++c) product_walk(dva[c], pf, ot + c * WALK_CHUNK);  // dV += P^T dO
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
      for (int c = 0; c < DC; ++c) pin(dka[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DC; ++c) product_walk(dka[c], sf, qt + c * WALK_CHUNK);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < DC; ++c) pin(dka[c]);
#pragma unroll
      for (int c = 0; c < DVC; ++c) pin(dva[c]);
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
  store_acc<DC>(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd, 0);
  store_acc<DVC>(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd, 0);
}

// dQ of OWN query rows of one head.
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_bf16_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                   const __grid_constant__ CUtensorMap o_map,
                                   const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap v_map,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   const bf16* __restrict__ k, bf16* __restrict__ dq, int batch,
                                   int hq, int hkv, int d, int dv, Masks mk, float scale) {
  using L = Plan<DC, DVC>;
  constexpr int OWN = L::OWN, STAGES = L::STAGES;
  constexpr int KBAR_THREADS = 96 + CONSUMERS;  // the producer's warps 1-3 and the consumers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = aligned_base(smem_raw);
  float* kbar = reinterpret_cast<float*>(smem_raw + (s0 - smem_u32(smem_raw)) + L::kbar);
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

  init_barriers<STAGES>(s0 + L::bars, 1);

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread loads the owned rows, then the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      load_owned<OWN>(s0 + L::own_s, s0 + L::own_p, &q_map, &o_map, own_full, q0, sq,
                      b * hq + h, DC, DVC);
      const int kv_bh = b * hkv + hk;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, kt = k_begin + it * WALK;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), (DC + DVC) * WALK_CHUNK);
        for (int c = 0; c < DC; ++c)
          tma_load(stage(s) + c * WALK_CHUNK, &k_map, full(s), c * COLS, kt, kv_bh);
        for (int c = 0; c < DVC; ++c)
          tma_load(stage(s) + (DC + c) * WALK_CHUNK, &v_map, full(s), c * COLS, kt, kv_bh);
      }
    } else if (threadIdx.x >= 32) {
      // warps 1-3: kbar, the mean of the first walked tile's keys, a column pair a thread
      const int pair = threadIdx.x - 32, n = imin(WALK, sk - k_begin);
      if (2 * pair < DC * COLS) {
        float2 sum = make_float2(0.f, 0.f);
        if (2 * pair < d) {
          const bf16* kp = k + ((size_t)(b * hkv + hk) * sk + k_begin) * d + 2 * pair;
          for (int j = 0; j < n; ++j) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kp));
            sum.x += x.x;
            sum.y += x.y;
            kp += d;
          }
        }
        const float inv = n > 0 ? 1.f / n : 0.f;
        kbar[2 * pair] = sum.x * inv;
        kbar[2 * pair + 1] = sum.y * inv;
      }
      asm volatile("bar.arrive 2, %0;\n" ::"n"(KBAR_THREADS) : "memory");
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const size_t head = (size_t)b * hq + h;
  const int r_lo = q0 + 64 * wgi;  // the warpgroup's rows, for the tile tests
  const int row0 = r_lo + 16 * (tid / 32) + g, row1 = row0 + 8;
  const bool rows_live = r_lo < sq;
  const int qpos_lo = r_lo + off, qpos_hi = imin(r_lo + 64, sq) - 1 + off;
  const float lse0 = row0 < sq ? lse[head * sq + row0] * LOG2E : 0.f;
  const float lse1 = row1 < sq ? lse[head * sq + row1] * LOG2E : 0.f;
  const float dl0 = row0 < sq ? delta[head * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[head * sq + row1] : 0.f;
  const uint32_t a_q = s0 + L::own_s + wgi * BOX_BYTES;
  const uint32_t a_o = s0 + L::own_p + wgi * BOX_BYTES;
  const float scale_log2 = scale * LOG2E;
  float dqa[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c) zero(dqa[c]);
  float rs0 = 0.f, rs1 = 0.f;  // rows row0, row1: the sums of the bfloat16 dS entering dQ
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
        for (int r = 0; r < 4; ++r) {  // r even: row0's pair, odd: row1's
          const __nv_bfloat162 ds2 =
              __floats2bfloat162_rn(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
          const float2 used = __bfloat1622float2(ds2);
          sf[j][r] = *reinterpret_cast<const uint32_t*>(&ds2);
          if (r & 1)
            rs1 += used.x + used.y;
          else
            rs0 += used.x + used.y;
        }
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) pin(dqa[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DC; ++c) product_walk(dqa[c], sf, kt_s + c * WALK_CHUNK);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < DC; ++c) pin(dqa[c]);
#pragma unroll
      for (int j = 0; j < WALK / 16; ++j) pin(sf[j]);
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
  }
  // dQ -= r kbar: each row's r over its quad of lanes in a fixed order
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    rs0 += __shfl_xor_sync(FULL_MASK, rs0, m);
    rs1 += __shfl_xor_sync(FULL_MASK, rs1, m);
  }
  named_barrier<2, KBAR_THREADS>();  // kbar is in place
#pragma unroll
  for (int c = 0; c < DC; ++c) {
#pragma unroll
    for (int nt = 0; nt < COLS / 8; ++nt) {
      const float2 kb = *reinterpret_cast<const float2*>(kbar + c * COLS + 8 * nt + 2 * qd);
      dqa[c][4 * nt] -= rs0 * kb.x;
      dqa[c][4 * nt + 1] -= rs0 * kb.y;
      dqa[c][4 * nt + 2] -= rs1 * kb.x;
      dqa[c][4 * nt + 3] -= rs1 * kb.y;
    }
  }
  store_acc<DC>(dq + head * sq * d, dqa, row0, row1, sq, d, scale, qd, 0);
}

// Split builds: dK and dV of 64 keys of one KV head over one part of their walk (the part's
// span of the group's (query head, query tile) pairs, heads in order, each its tiles in order).
// With one part it writes dK and dV; with more, its float32 partial into `partial`: (B*Hkv,
// parts, Sk, D) for dK, then (B*Hkv, parts, Sk, Dv) for dV. Each walk tile's dS^T (64 keys by
// 64 query rows, bfloat16, as it enters dK) goes to the dS scratch through ds_map, for dQ.
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_bf16_dkdv_split_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap o_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap ds_map,
                                     const float* __restrict__ lse, const float* __restrict__ delta,
                                     bf16* __restrict__ dk, bf16* __restrict__ dv_out,
                                     float* __restrict__ partial, int parts, int head_tiles,
                                     int batch, int hq, int hkv, int d, int dv, Masks mk,
                                     float scale) {
  using L = SplitPlan<DC, DVC>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = aligned_base(smem_raw);
  uint8_t* base = smem_raw + (s0 - smem_u32(smem_raw));
  float* lse_ring = reinterpret_cast<float*>(base + L::lse);
  const uint32_t own_full = s0 + L::bars;
  auto full = [&](int s) { return s0 + L::bars + 8u * (1 + s); };
  auto empty = [&](int s) { return s0 + L::bars + 8u * (1 + STAGES + s); };
  auto stage = [&](int s) { return s0 + L::ring + s * L::STAGE_BYTES; };
  const int dcl = live_chunks(DC, d), dvcl = live_chunks(DVC, dv);  // chunks the producer loads

  // Blocks in the order of their key tiles, each tile's parts, then (KV head, batch): the
  // longest causal walks, the first key tiles', start first on the card.
  const int heads = hkv * batch, per_tile = parts * heads;
  const int part = blockIdx.x % per_tile / heads, hk = blockIdx.x % heads % hkv;
  const int b = blockIdx.x % heads / hkv, grp = hq / hkv;
  const int sq = mk.sq, sk = mk.sk, k0 = (blockIdx.x / per_tile) * WALK, off = sk - sq;
  // The query rows that some key of this block is visible to, as tiles [t_begin, ...).
  const int k_last = imin(k0 + WALK, sk) - 1;
  const int i_begin = mk.causal ? imax(0, k0 - off) : 0;
  const int i_end = mk.window > 0 ? imin(sq, k_last + mk.window - off) : sq;
  const int t_begin = i_begin / WALK;
  const int per_head = i_end > i_begin ? (i_end + WALK - 1) / WALK - t_begin : 0;
  // This part's span [it0, it0 + n_tiles) of the walk over the group's heads, each its tiles.
  const int walk = grp * per_head;
  const int it0 = (int)((long long)walk * part / parts);
  const int n_tiles = (int)((long long)walk * (part + 1) / parts) - it0;
  const int hh0 = per_head > 0 ? it0 / per_head : 0;
  const int t0 = t_begin + (per_head > 0 ? it0 % per_head : 0);

  zero_dead_chunks<DC, DVC>(base, dcl, dvcl);
  init_barriers<STAGES>(s0 + L::bars, 32);  // full: the producer warp's lanes, one with TMA bytes

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp loads the owned rows, then the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0)
        load_owned<L::OWN>(s0 + L::own_s, s0 + L::own_p, &k_map, &v_map, own_full, k0, sk,
                           b * hkv + hk, dcl, dvcl);
      int hh = hh0, t = t0;  // the walk tile's query head in the group, and its tile
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

  // ---- consumer warpgroups: the block's 64 keys; 32 rows of each walk tile apiece for S^T
  // and dP^T, half of the output's column chunks apiece for dV and dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int r_lo = 32 * wgi;                                 // its rows of each walk tile
  const int kc0 = wgi * L::KC, vc0 = wgi * L::VC;            // its chunks of dK and dV
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const uint32_t a_k = s0 + L::own_s, a_v = s0 + L::own_p;
  const float scale_log2 = scale * LOG2E;
  float dka[L::KC][32], dva[L::VC][32];
#pragma unroll
  for (int c = 0; c < L::KC; ++c) zero(dka[c]);
#pragma unroll
  for (int c = 0; c < L::VC; ++c) zero(dva[c]);
  mbar_wait(own_full, 0);

  // the thread that stores dS^T tiles: the first of the first consumer warpgroup; its slots
  // in the dS scratch: query tile t's first among its head's, from the head's first tile's
  const bool storer = wgi == 0 && tid == 0;
  const int kt_idx = k0 / WALK, begin_slot = ds_offset(mk, t_begin, lane);
  int hh = hh0, t = t0, t_slot = ds_offset(mk, t0, lane);  // t: the walk tile's query tile
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, i0 = t * WALK + r_lo;  // the warpgroup's first row
    const int qpos_lo = i0 + off, qpos_hi = imin(i0 + 32, sq) - 1 + off;
    // a warpgroup whose rows see every key of the block masks nothing
    const bool edge = i0 + 32 > sq || k0 + WALK > sk || (mk.causal && k0 + WALK - 1 > qpos_lo) ||
                      (mk.window > 0 && k0 <= qpos_hi - mk.window);
    const uint32_t qt = stage(s), ot = stage(s) + DC * WALK_CHUNK;
    const float* lt = lse_ring + 2 * s * WALK + r_lo;  // the rows' lse * log2(e), D at + WALK
    const uint32_t xo = L::xch + (it & 1) * 2 * L::TILE;  // this tile's P^T, then dS^T
    float st[16], dpt[16];  // S^T and dP^T: the block's keys by the warpgroup's rows
    mbar_wait(full(s), (it / STAGES) & 1);
    wgmma_fence();
    product_half<DC>(st, a_k, L::OWN_CHUNK, qt + r_lo * ROW_BYTES);
    wgmma_commit();
    product_half<DVC>(dpt, a_v, L::OWN_CHUNK, ot + r_lo * ROW_BYTES);
    wgmma_commit();
    wgmma_wait_pending<1>();  // S^T
    pin(st);
    if (edge)  // P^T
      probs_kv<true>(st, lt, scale_log2, mk, i0, key0, key1, qd);
    else
      probs_kv<false>(st, lt, scale_log2, mk, i0, key0, key1, qd);
    store_half(base + xo, st, warp, g, qd, r_lo);
    wgmma_wait_pending<0>();  // dP^T
    pin(dpt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(lt + WALK + 8 * nt + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * nt + e] = st[4 * nt + e] * (dpt[4 * nt + e] - ((e & 1) ? dl.y : dl.x));  // dS^T
    }
    store_half(base + xo + L::TILE, dpt, warp, g, qd, r_lo);
    fence_proxy_async();
    if (storer) bulk_wait_read<0>();  // the last tile's dS^T store has read its buffer
    named_barrier<1, CONSUMERS>();  // both halves of P^T and dS^T are in place
    int kb, ke;  // the key tiles of query tile t's walk in dQ
    dq_walk(mk, t, kb, ke);
    if (storer) {
      const int head = b * hq + hk * grp + hh;
      tma_store(&ds_map, s0 + xo + L::TILE, 0, 0, head * head_tiles + t_slot + kt_idx - kb);
      bulk_commit();
    }
#pragma unroll
    for (int c = 0; c < L::VC; ++c) pin(dva[c]);
#pragma unroll
    for (int c = 0; c < L::KC; ++c) pin(dka[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < L::VC; ++c)
      product_walk_ss(dva[c], s0 + xo, ot + (vc0 + c) * WALK_CHUNK);  // dV += P^T dO
#pragma unroll
    for (int c = 0; c < L::KC; ++c)
      product_walk_ss(dka[c], s0 + xo + L::TILE, qt + (kc0 + c) * WALK_CHUNK);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_pending<0>();
#pragma unroll
    for (int c = 0; c < L::KC; ++c) pin(dka[c]);
#pragma unroll
    for (int c = 0; c < L::VC; ++c) pin(dva[c]);
    mbar_arrive(empty(s));  // this thread is done with stage s
    t_slot += ke - kb;
    if (++t == t_begin + per_head) {
      t = t_begin;
      t_slot = begin_slot;
      ++hh;
    }
  }
  if (storer) bulk_wait_all();
  const size_t kv_head = (size_t)b * hkv + hk;
  if (parts == 1) {
    store_acc<L::KC>(dk + kv_head * sk * d, dka, key0, key1, sk, d, scale, qd, kc0);
    store_acc<L::VC>(dv_out + kv_head * sk * dv, dva, key0, key1, sk, dv, 1.f, qd, vc0);
  } else {
    const size_t slot = kv_head * parts + part;
    float* pk = partial + slot * sk * d;
    float* pv = partial + (size_t)batch * hkv * parts * sk * d + slot * sk * dv;
    store_partial<L::KC>(pk, dka, key0, key1, sk, d, qd, kc0);
    store_partial<L::VC>(pv, dva, key0, key1, sk, dv, qd, vc0);
  }
}

// Split builds: dK and dV from the parts' float32 partials (more than one part): each element
// the sum of its partials in part order, dK times the scale, rounded to bfloat16 once; four
// elements a thread (D and Dv are multiples of 8).
__global__ void __launch_bounds__(256)
    flash_bwd_bf16_dkdv_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv_out, int kv_heads, int parts, int sk,
                                      int d, int dv, float scale) {
  const size_t nk = (size_t)kv_heads * sk * d, n = nk + (size_t)kv_heads * sk * dv;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const bool is_k = i < nk;
  const size_t j = is_k ? i : i - nk;                      // the element of dk or dv
  const size_t per_head = (size_t)sk * (is_k ? d : dv);    // a part's elements a KV head
  const float* src = partial + (is_k ? 0 : nk * parts) + (j / per_head) * parts * per_head +
                     j % per_head;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < parts; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + p * per_head);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float m = is_k ? scale : 1.f;
  *reinterpret_cast<uint2*>((is_k ? dk : dv_out) + j) =
      make_uint2(pack_bf16(acc.x * m, acc.y * m), pack_bf16(acc.z * m, acc.w * m));
}

// Split builds, dQ: the plan of a block. A ring of STAGES stages, each a key tile's DC chunks of K
// and the two query tiles' dS^T tiles (8 KB each), then the barriers (full, empty).
template <int DC>
struct DqPlan {
  static constexpr int STAGES = 4;
  static constexpr uint32_t STAGE_BYTES = (DC + 2) * WALK_CHUNK;
  static constexpr uint32_t ring = 0;
  static constexpr uint32_t bars = ring + STAGES * STAGE_BYTES;
  static constexpr uint32_t total = bars + 8 * 2 * STAGES;
  static_assert(1024 + total <= 232448, "shared memory of a block");
};

// Split builds: dQ of two tiles of 64 query rows of one head, a consumer warpgroup each, from
// the dS^T tiles the dK/dV kernel stored: dQ = scale sum over the key tiles a row sees, in
// order, of dS K (dS read from its transpose, K MN-major). The two tiles' walks share the key
// tiles they both see: one copy of a K tile serves both.
template <int DC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_bf16_dq_split_kernel(const __grid_constant__ CUtensorMap k_map,
                                   const __grid_constant__ CUtensorMap ds_map,
                                   bf16* __restrict__ dq, int head_tiles, int batch, int hq,
                                   int hkv, int d, Masks mk, float scale) {
  using L = DqPlan<DC>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = aligned_base(smem_raw);
  const int dcl = live_chunks(DC, d);  // chunks the producer loads
  auto full = [&](int s) { return s0 + L::bars + 8u * s; };
  auto empty = [&](int s) { return s0 + L::bars + 8u * (STAGES + s); };
  auto stage = [&](int s) { return s0 + L::ring + s * L::STAGE_BYTES; };

  // Blocks from the last pair of query tiles (the longest causal walks) to the first, each pair
  // across every (head, batch) before the next.
  const int sq = mk.sq, heads = hq * batch;
  const int n_qt = (sq + WALK - 1) / WALK, pairs = (n_qt + 1) / 2;
  const int pair = pairs - 1 - (int)blockIdx.x / heads;
  const int h = blockIdx.x % heads % hq, b = blockIdx.x % heads / hq, hk = h / (hq / hkv);
  const int head = b * hq + h;
  int kb0, ke0, kb1 = 0, ke1 = 0;  // the two query tiles' walks: [kb, ke), in key tiles
  dq_walk(mk, 2 * pair, kb0, ke0);
  const bool two = 2 * pair + 1 < n_qt;  // the pair's second tile exists
  if (two) dq_walk(mk, 2 * pair + 1, kb1, ke1);
  const int k_lo = kb0, k_hi = two ? imax(ke0, ke1) : ke0;  // the union of the two walks

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: its first warp finds the two tiles' first slots in the dS
    // scratch, then one thread loads the walk ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int slot0 = head * head_tiles + ds_offset(mk, 2 * pair, threadIdx.x);
      const int slot1 = slot0 + ke0 - kb0;
      if (threadIdx.x != 0) return;
      const int kv_bh = b * hkv + hk;
      for (int kt = k_lo; kt < k_hi; ++kt) {
        const int it = kt - k_lo, s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const bool in0 = kt >= kb0 && kt < ke0, in1 = two && kt >= kb1 && kt < ke1;
        mbar_expect_tx(full(s), (dcl + in0 + in1) * WALK_CHUNK);
        for (int c = 0; c < dcl; ++c)
          tma_load(stage(s) + c * WALK_CHUNK, &k_map, full(s), c * COLS, kt * WALK, kv_bh);
        if (in0)
          tma_load(stage(s) + DC * WALK_CHUNK, &ds_map, full(s), 0, 0, slot0 + kt - kb0);
        if (in1)
          tma_load(stage(s) + (DC + 1) * WALK_CHUNK, &ds_map, full(s), 0, 0, slot1 + kt - kb1);
      }
    }
    return;
  }

  // ---- consumer warpgroups: query tile 2 pair + w each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = consumer_warpgroup(), tid = threadIdx.x % 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int kb = wgi == 0 ? kb0 : kb1, ke = wgi == 0 ? ke0 : ke1;  // its walk (none past Sq)
  const int row0 = (2 * pair + wgi) * WALK + 16 * (tid / 32) + g, row1 = row0 + 8;
  float dqa[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c) zero(dqa[c]);
  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int it = kt - k_lo, s = it % STAGES;
    const uint32_t dst = stage(s) + (DC + wgi) * WALK_CHUNK;  // this tile's dS^T
    mbar_wait(full(s), (it / STAGES) & 1);
    if (kt >= kb && kt < ke) {
#pragma unroll
      for (int c = 0; c < DC; ++c) pin(dqa[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DC; ++c) {
#pragma unroll
        for (int j = 0; j < WALK / 16; ++j)  // dQ += dS K: k-steps of 16 keys
          wgmma_bf16_ss_tt(dqa[c], mnmajor_bf16_desc(dst + j * KSTEP_ROWS_BYTES),
                           mnmajor_bf16_desc(stage(s) + c * WALK_CHUNK + j * KSTEP_ROWS_BYTES));
      }
      wgmma_commit();
      wgmma_wait_pending<0>();
#pragma unroll
      for (int c = 0; c < DC; ++c) pin(dqa[c]);
    }
    mbar_arrive(empty(s));  // this thread is done with stage s
  }
  if (wgi == 0 || two)
    store_acc<DC>(dq + (size_t)head * sq * d, dqa, row0, row1, sq, d, scale, qd, 0);
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
size_t split_shared_bytes() {
  return 1024 + SplitPlan<DC, DVC>::total;
}

template <int DC, int DVC>
int launch(const CUtensorMap& qm, const CUtensorMap& om, const CUtensorMap& km,
           const CUtensorMap& vm, const float* lse, const float* delta, const bf16* k, bf16* dq,
           bf16* dk, bf16* dv_out, int b, int hq, int hkv, int d, int dv, const Masks& mk,
           float scale, cudaStream_t stream) {
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
      qm, om, km, vm, lse, delta, k, dq, b, hq, hkv, d, dv, mk, scale);
  return (int)cudaGetLastError();
}

// The split builds: dK/dV on (key tiles x parts x KV heads x B) blocks, which also store the dS
// scratch; the partials' reduction when there is more than one part; then dQ on (pairs of query
// tiles x Hq x B) blocks from the dS scratch.
template <int DC, int DVC>
int launch_split(const CUtensorMap& qm, const CUtensorMap& om, const CUtensorMap& km,
                 const CUtensorMap& vm, const CUtensorMap& dsm, const float* lse,
                 const float* delta, bf16* dq, bf16* dk, bf16* dv_out, float* partial, int parts,
                 int head_tiles, int b, int hq, int hkv, int d, int dv, const Masks& mk,
                 float scale, cudaStream_t stream) {
  const size_t kv_smem = split_shared_bytes<DC, DVC>(), q_smem = 1024 + DqPlan<DC>::total;
  auto kv_kernel = flash_bwd_bf16_dkdv_split_kernel<DC, DVC>;
  auto q_kernel = flash_bwd_bf16_dq_split_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(mk.sk + WALK - 1) / WALK * parts * hkv * b, THREADS, kv_smem, stream>>>(
      qm, om, km, vm, dsm, lse, delta, dk, dv_out, partial, parts, head_tiles, b, hq, hkv, d, dv,
      mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (parts > 1) {
    const size_t quads = (size_t)b * hkv * mk.sk * (d + dv) / 4;
    flash_bwd_bf16_dkdv_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
        partial, dk, dv_out, b * hkv, parts, mk.sk, d, dv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int pairs = ((mk.sq + WALK - 1) / WALK + 1) / 2;
  q_kernel<<<pairs * hq * b, THREADS, q_smem, stream>>>(km, dsm, dq, head_tiles, b, hq, hkv, d,
                                                        mk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), dout (B,Hq,Sq,Dv): bfloat16, o (B,Hq,Sq,Dv)
// float32 (the forward's output before its rounding), all contiguous, 16-byte aligned
// (cudaErrorMisalignedAddress otherwise: TMA's base addresses), D and Dv multiples of 8 up to
// 256 (TMA's 16-byte row strides); lse (B,Hq,Sq) float32.
// Writes delta (B,Hq,Sq) float32 (scratch: D = rowsum(dO o O)), dq, dk, dv in bfloat16 (shaped
// as q, k, v), every element. window <= 0 means no window. `parts`: the pieces of each key
// tile's walk in the split builds (head dims above 128; 1 below), at most MAX_PARTS; with more
// than one, `partial` is a float32 scratch of B * Hkv * parts * Sk * (D + Dv) elements (16-byte
// aligned). The split builds also take `ds`, a bfloat16 scratch of B * Hq * head_tiles tiles of
// 64 x 64 (16-byte aligned), head_tiles the key tiles all query tiles of a head see, their walks
// in tiles of 64 (kernels/flash_attention.py bwd_ds_offsets; a different count is refused); the
// others pass null and 0. The caller has checked Hq % Hkv == 0, B, Sq, Sk >= 1,
// causal/window only with Sq <= Sk, and the grid limits. Returns the cudaError_t of the
// launches (0 on success). Does not synchronise.
int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv_out, void* partial, void* ds, int b, int hq,
                                   int hkv, int sq, int sk, int d, int dv, int causal, int window,
                                   float scale, int parts, int head_tiles, void* stream) {
  const bool split = d > 128 || dv > 128;
  const Masks mk{sq, sk, causal, window > 0 ? window : 0};
  if (d < 8 || d > MAX_D || dv < 8 || dv > MAX_D || d % 8 != 0 || dv % 8 != 0 || hkv < 1 ||
      hq % hkv != 0 || b < 1 || sq < 1 || sk < 1 || parts < 1 || parts > MAX_PARTS ||
      (!split && parts != 1) || (parts > 1 && partial == nullptr) ||
      (split && (ds == nullptr || head_tiles != ds_tiles(mk))))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                        reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                        reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv_out);
  const uintptr_t scratch = reinterpret_cast<uintptr_t>(partial) | reinterpret_cast<uintptr_t>(ds);
  if (any % 16 != 0 || scratch % 16 != 0) return (int)cudaErrorMisalignedAddress;
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
      static_cast<const float*>(o), bo, fd, rows, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf16* gq = static_cast<bf16*>(dq);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv_out);
#define REPRO_LAUNCH(DC, DVC)                                                               \
  launch<DC, DVC>(qm, om, km, vm, fl, fd, static_cast<const bf16*>(k), gq, gk, gv, b, hq, hkv, d, \
                  dv, mk, scale, s)
#define REPRO_SPLIT(DC, DVC)                                                                 \
  launch_split<DC, DVC>(qm, om, km, vm, dsm, fl, fd, gq, gk, gv, static_cast<float*>(partial), \
                        parts, head_tiles, b, hq, hkv, d, dv, mk, scale, s)
  if (split) {  // the split builds: 2 or 4 chunks of each
    CUtensorMap dsm;  // the dS scratch as (tiles, 64, 64)
    err = make_map(&dsm, ds, b * hq * head_tiles, WALK, WALK);
    if (err != cudaSuccess) return (int)err;
    if (d > 128) return dv > 128 ? REPRO_SPLIT(4, 4) : REPRO_SPLIT(4, 2);
    return REPRO_SPLIT(2, 4);
  }
  if (d <= 64) return dv <= 64 ? REPRO_LAUNCH(1, 1) : REPRO_LAUNCH(1, 2);
  return dv <= 64 ? REPRO_LAUNCH(2, 1) : REPRO_LAUNCH(2, 2);
#undef REPRO_LAUNCH
#undef REPRO_SPLIT
}

// Dynamic shared memory a block of the dK/dV or dQ kernel asks for at head dims D and Dv (the two
// are equal up to 128; in the split builds, dK/dV's, the larger).
int repro_flash_attention_bwd_bf16_shared_bytes(int d, int dv) {
  if (d > 128 || dv > 128) {
    if (d > 128) return (int)(dv > 128 ? split_shared_bytes<4, 4>() : split_shared_bytes<4, 2>());
    return (int)split_shared_bytes<2, 4>();
  }
  if (d <= 64) return (int)(dv <= 64 ? shared_bytes<1, 1>() : shared_bytes<1, 2>());
  return (int)(dv <= 64 ? shared_bytes<2, 1>() : shared_bytes<2, 2>());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
