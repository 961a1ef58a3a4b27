// Flash-attention forward for Hopper (sm_90a): bfloat16 on the tensor cores, float32 on
// the CUDA cores.
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
// 4*2048: both far above the ridge of an H100 (20 FLOP/byte for float32 on CUDA cores,
// 295 for bfloat16 on tensor cores), so operations bound both paths.
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
//     the clamped denominator once and stored as bfloat16.
//   Shared memory at D = Dv = 256: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB, one
//   block an SM. There is no split over keys and no atomic: a row's bits depend on its own
//   q and the keys it sees, not on B or on the other rows of its block.
//   Numerics: q.k in bfloat16 products with a float32 sum (another order than the
//   reference's); P rounded to bfloat16 before P.V (the reference keeps it in float32).
//   The wrapper pads a head dim that is no multiple of 8 (a TMA stride must be a multiple
//   of 16 bytes) with zeros.
//
// float32: `flash_fwd_kernel`, FMA on CUDA cores. The reference's 2e-5 float32 tolerance
// rules out TF32 tensor cores (about three decimal digits). A block owns (b, h, a tile of
// BQ query rows) and loops over key tiles of BK keys staged in shared memory; the TPU's
// sequential grid axis is that loop. The running max, running sum and the (BQ x Dv)
// accumulator stay in registers for the whole loop and the output is written once. 128
// threads: thread (tr, tc) owns ROWS query rows ROWS*tr .. ROWS*tr+ROWS-1 and key / value
// columns tc + 16*j, so a row's max and sum are reductions over the 16 lanes of one
// half-warp (shuffles, no shared memory). Q and K tiles are stored with a row stride of
// D+1 so the 16 lanes of a half-warp read 16 different banks. The probabilities P go
// through shared memory to the P.V product. Key tiles wholly above the causal diagonal or
// wholly outside the window of every row of the block are skipped: they contribute
// exactly 0. Head dims up to 128 take BQ = BK = 64 (ROWS = 8); head dims up to 256 take
// BQ = BK = 32 (ROWS = 4): at Dv = 256 a thread holds 4 x 16 accumulators, where 8 x 16
// would spill, and the tiles take 102,784 bytes of shared memory, two blocks an SM.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*. The TMA
// encoder is reached through the runtime's driver entry point, so the library needs no
// -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: FMA on CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int THREADS = 128;
constexpr int ROW_GROUPS = THREADS / 16;  // half-warps: each owns ROWS query rows

// Reductions over the 16 lanes of a half-warp (xor offsets < 16 stay in the half).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NV: value columns per thread, so the block covers Dv <= 16 * NV; ROWS: query rows
// per thread, so a block has BQ = 8 * ROWS rows; BK: keys per shared-memory tile.
template <int NV, int ROWS, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int hq, int hkv, int sq, int sk, int d, int dv,
                     int causal, int window, float scale) {
  constexpr int BQ = ROWS * ROW_GROUPS;
  constexpr int KCOLS = BK / 16;  // key columns per thread
  constexpr int LDP = BK + 1;     // row stride of the P tile
  constexpr int LDV = 16 * NV;
  extern __shared__ float smem[];
  const int ldqk = d + 1;
  float* qs = smem;               // BQ x ldqk
  float* ks = qs + BQ * ldqk;     // BK x ldqk
  float* vs = ks + BK * ldqk;     // BK x LDV (columns >= dv hold zeros)
  float* ps = vs + BK * LDV;      // BQ x LDP

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = sk - sq;  // right-aligned query positions

  const float* qb = q + ((size_t)b * hq + h) * (size_t)sq * d;
  const float* kb = k + ((size_t)b * hkv + hk) * (size_t)sk * d;
  const float* vb = v + ((size_t)b * hkv + hk) * (size_t)sk * dv;
  float* ob = o + ((size_t)b * hq + h) * (size_t)sq * dv;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    const int qr = q0 + r;
    qs[r * ldqk + c] = qr < sq ? qb[(size_t)qr * d + c] : 0.f;
  }

  // Key range any row of this block can see.
  const int qpos_first = q0 + offset;
  const int qpos_last = min(q0 + BQ, sq) - 1 + offset;
  const int k_end = causal ? min(sk, qpos_last + 1) : sk;
  int k_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float acc[ROWS][NV];
  float m_i[ROWS];
  float l_i[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed; Q is stored
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d;
      const int c = i - r * d;
      const int kr = k0 + r;
      ks[r * ldqk + c] = kr < sk ? kb[(size_t)kr * d + c] : 0.f;
    }
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV;
      const int c = i - r * LDV;
      const int kr = k0 + r;
      vs[i] = (kr < sk && c < dv) ? vb[(size_t)kr * dv + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's ROWS rows x KCOLS columns.
    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float kv[KCOLS];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = ks[(tc + 16 * j) * ldqk + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = qs[(tr * ROWS + i) * ldqk + c];
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

    // Mask, online softmax update, P to shared memory.
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + tr * ROWS + i + offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr * ROWS + i) * LDP + tc + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's ROWS rows x NV value columns.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) vv[j] = vs[kk * LDV + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = ps[(tr * ROWS + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qr = q0 + tr * ROWS + i;
    if (qr >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tc + 16 * j;
      if (c < dv) ob[(size_t)qr * dv + c] = acc[i][j] / denom;
    }
  }
}

template <int NV, int ROWS, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
           int sk, int d, int dv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = ROWS * ROW_GROUPS;
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * 16 * NV +
                                        (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<NV, ROWS, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<NV, ROWS, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, sq, sk, d, dv, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_dv(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
              int sq, int sk, int d, int dv, int causal, int window, float scale,
              cudaStream_t stream) {
#define REPRO_LAUNCH(NV, ROWS, BK) \
  launch<NV, ROWS, BK>(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, stream)
  if (d <= 128 && dv <= 128) {  // 64-row tiles
    if (dv <= 32) return REPRO_LAUNCH(2, 8, 64);
    if (dv <= 64) return REPRO_LAUNCH(4, 8, 64);
    return REPRO_LAUNCH(8, 8, 64);
  }
  // 32-row tiles for head dims up to 256
  if (dv <= 128) return REPRO_LAUNCH(8, 4, 32);
  return REPRO_LAUNCH(16, 4, 32);
#undef REPRO_LAUNCH
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (columns, rows, batch*head) into shared memory; the
// barrier's transaction count falls by the box's bytes when it has landed.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle layout that TMA
// writes: 8-row groups (1024 bytes) apart by `sbo`; `lbo` is the other operand stride.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major (Q, K: the reduced dim contiguous). A k-step of 16 columns inside the 128-byte
// row advances the start address by 32 bytes; the leading offset is unused.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, GROUP_BYTES);
}

// MN-major (V as the B operand of P.V: the key dim is reduced, Dv is contiguous). One
// instruction covers 64 columns, one swizzle atom wide, and 16 keys, two 8-row groups
// GROUP_BYTES apart; both strides are set to that, so either reading of the fields holds.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, GROUP_BYTES, GROUP_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an asynchronous
// wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, float32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bfloat16 in registers) * B (16 x 64, shared,
// MN-major: transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// DC, DVC: 64-column chunks of D and Dv (1, 2 or 4). Shared memory, 1024-byte aligned:
// Q (DC chunks of 128 x 64), K (STAGES x DC chunks of 64 x 64), V (STAGES x DVC chunks),
// then the barriers.
template <int DC, int DVC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq, int sk, int dv,
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
            const uint64_t da = kmajor_desc(q_wg + c * Q_CHUNK + kk * 32);
            const uint64_t db = kmajor_desc(k_s + s * K_BYTES + c * KV_CHUNK + kk * 32);
            wgmma_ss(sc, da, db, (c | kk) != 0);
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
            wgmma_rs(acc[c], p[j],
                     mnmajor_desc(v_s + s * V_BYTES + c * KV_CHUNK + j * 2 * GROUP_BYTES));
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
      const float den0 = fmaxf(quad_sum(l0), 1e-37f);
      const float den1 = fmaxf(quad_sum(l1), 1e-37f);
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
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda at link time).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o, int b,
           int hq, int hkv, int sq, int sk, int dv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      1024 + DC * Q_CHUNK + STAGES * (DC + DVC) * KV_CHUNK + 8 * (1 + 3 * STAGES);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DC, DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_wgmma_kernel<DC, DVC><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk, dv, causal, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DC>
int launch_dv(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o, int b,
              int hq, int hkv, int sq, int sk, int dv, int causal, int window, float scale,
              cudaStream_t stream) {
#define REPRO_LAUNCH(DVC) \
  launch<DC, DVC>(qm, km, vm, o, b, hq, hkv, sq, sk, dv, causal, window, scale, stream)
  if (dv <= 64) return REPRO_LAUNCH(1);
  if (dv <= 128) return REPRO_LAUNCH(2);
  return REPRO_LAUNCH(4);
#undef REPRO_LAUNCH
}

int run(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
        int sk, int d, int dv, int causal, int window, float scale, cudaStream_t stream) {
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
  launch_dv<DC>(qm, km, vm, o, b, hq, hkv, sq, sk, dv, causal, window, scale, stream)
  if (d <= 64) return REPRO_LAUNCH(1);
  if (d <= 128) return REPRO_LAUNCH(2);
  return REPRO_LAUNCH(4);
#undef REPRO_LAUNCH
}

}  // namespace bf16

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o (B,Hq,Sq,Dv), all contiguous and of
// one dtype (is_bf16: 0 float32 on the FMA path, 1 bfloat16 on the tensor-core path,
// which also needs D and Dv multiples of 8 and 16-byte aligned pointers). window <= 0
// means no window. The caller has checked 1 <= D, Dv <= 256, Hq % Hkv == 0 and the grid
// limits. Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b, int hq,
                              int hkv, int sq, int sk, int d, int dv, int causal, int window,
                              float scale, int is_bf16, void* stream) {
  if (d < 1 || d > MAX_D || dv < 1 || dv > MAX_D || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return bf16::run(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, s);
  return f32::launch_dv(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
