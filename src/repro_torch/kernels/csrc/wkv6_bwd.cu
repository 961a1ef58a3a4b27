// RWKV6 WKV backward for Hopper (sm_90a): the gradient of the chunked WKV of wkv6.cu.
//
// Replaces the gradient of the TPU kernel `_wkv6_kernel` in src/repro/kernels/rwkv6.py: the
// reference trains rwkv6-7b by autodiff through its plain chunked form (`wkv6_chunked_ref`,
// src/repro/kernels/ref.py:145, which `repro.kernels.ops.wkv6` runs off the TPU; the Pallas
// kernel has no VJP). It computes what `ref.wkv6_bwd_ref` computes, whose docstring derives the
// form: chunk 16 in float32, the gradient of the state at a chunk's end dS (dS_T, or zeros, at
// the end of time). Per chunk, with cum the inclusive cumulative sum of log w over its rows,
// excl = cum - log w, last = cum of its last row, r^ = r exp(excl), k^ = k exp(-cum), dec =
// exp(last - cum), kw = k dec, vd[t][s] = dout_t . v_s, S_c the state at the chunk's start and,
// over the strictly lower 16 x 16 tile (s < t):
//   q  = dout S_c^T                       x = q + lower(vd) k^         y = lower(vd)^T r^
//   p  = v dS^T                           att = lower(r^ k^T)          bonus_t = sum_i r u k
//   dr = exp(excl) x + u vd[t][t] k       dk = exp(-cum) y + dec p + u vd[t][t] r
//   dv = att^T dout + bonus dout + kw dS  du += sum_t r k vd[t][t]
//   dlog w_m = sum_{t>m} r^_t q_t + sum_{s<m<t} r^_t k^_s vd[t][s]
//              + exp(last) sum_j dS S_c + sum_{s<m} kw_s p_s,      dw = dlog w / w
// Each sum of dlog w holds only terms that depend on log w_m (see the plain version on why).
// Every factor is an exponent of a cumulative sum or of a difference of two, and nothing is
// divided by D_t^2 as autodiff through the reference's k / D_t does: every output is finite over
// the model's clamp log w in [-4, -1e-4]. The factored exponents reach +-64, so the file must
// not be built with --use_fast_math (accurate expf/logf; the 1e-38 floor of w is a subnormal).
//
// What depends on what. Given S_c and dS at its end, every output of a chunk is local to it.
// The two states are the only sequential part, and each of their columns is a recurrence of its
// own: column j of S' = diag(e^last) S + kw^T v depends on column j of v alone, column j of
// dS <- diag(e^last) dS + r^T dout on column j of dout alone. So the gradient is three launches:
//
// `wkv6_bwd_walk_kernel`: both walks in one launch, a block per (walk, batch, head, VB = 64
//   state columns): 128 blocks at rwkv6-7b's train shape (1, 64, 4096, 64). Walk A runs the
//   chunks forward from S_0 and writes S_c at each chunk's start; walk B runs them back from dS_T
//   and writes dS at each chunk's end (then dS_0). Each block has the roles of the forward's
//   chunk kernel (wkv6.cu), meeting at `mbarrier`s of a ring of chunk stages: a producer warp
//   filling it with 16-byte `cp.async` copies (k, v, w or r, dout, w), eight preparation warps
//   computing the logs, cumulative sums and exps and the chunk's kw or r^ (free of the state,
//   so chunks ahead), and one state warp a 16 columns holding its columns of the state as the
//   accumulator of m16n8k8 tensor-core products (3xTF32, `mma_tf32.cuh`; 2 products where the
//   bfloat16 side is exact in TF32), storing them each chunk and then stepping them. On an
//   NVIDIA H100 80GB HBM3 at 700.00 W a block takes ~1.44 us a chunk with VB = 32 (256 blocks,
//   two an SM, each reading k or r and w once more) as with VB = 64, with a ring of 8 stages as
//   of 4, and 1.57 us with two state warps a 16 columns; no piece of its work sets the pace
//   alone (tools/wkv6_bwd_probe.py, PERF.md §6).
// `wkv6_bwd_chunk_kernel`: a block per (batch, head, chunk), 16,384 at the train shape, three
//   an SM: every `cp.async` of the chunk (r, k, v, dout, w and dS, 53 KB in bfloat16) issued at
//   once, S_c read into registers in the layout of the product that takes it; then the chunk's
//   factors on the CUDA cores, its products on the tensor cores (q, p and kw dS over 64, the
//   16 x 16 tiles vd and att, x, y and att^T dout over 16: 3xTF32 where both sides are float32,
//   2 products where one is bfloat16, 1 where both are; kw split into its TF32 halves once, not
//   by each warp), and dw's sums over rows on the CUDA cores, four threads a channel: each
//   takes the straddling pairs of a group of rows t (30 pairs), then the four partial sums of
//   four rows. Single-pass TF32 on a float32 operand is not used: it misses the float64 check
//   of chip_smoke.py. The three blocks of an SM start, copy and compute together, so the copies
//   (a third of its time on the same card) do not overlap the arithmetic: a persistent block
//   with a ring of chunks is the next step (tools/wkv6_bwd_probe.py, PERF.md §6).
// `wkv6_bwd_du_kernel`: du (H, K) from the chunk blocks' partials: for each batch row, the
//   chunks in DU_SPLITS runs of consecutive chunks each summed in order, the runs in order,
//   then the batch rows in order.
//
// Order of arithmetic. It depends on T, K and V only, never on B, H or which blocks share an SM,
// and there are no atomics: two launches give equal bits, and a batch row alone gives the bits
// of dr, dk, dv, dw and dS_0 that it gives within a batch.
//
// Bound on this card at the train shape (1, 64, 4096, 64), r, k, v and dout in bfloat16: the
// bytes the function must move (r, k, v, dout and w read, dr, dk, dv and dw written) are 369.1
// MB, 0.110 ms at 3.35 TB/s; the ~13.45 GFLOP of the chunked form are 0.20 ms on the float32
// CUDA cores (67 TFLOP/s), and three times over at the TF32 tensor-core rate (495 TFLOP/s)
// 0.082 ms: in the tensor-core form the bytes bound it. The split adds its own bytes: S_c and
// dS per chunk written and read (2 x 537 MB at the train shape) and the walks' second read of
// r, k, v, dout and w.
//
// Layout: r, k, v, w, dout and dr, dk, dv, dw are taken by strides (batch, head, time) with the
// last axis contiguous, so the model's (B, T, H, K) memory goes in and comes out without a
// transposing copy; u is (H, K), the states (B, H, K, V), contiguous. The 16-byte copies need
// r, k, v, w and dout 16-byte aligned with strides of whole 16 bytes; the wrapper pads what is
// not, as the forward's does.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int CHUNK = 16;
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
// Row of a (chunk, 64) tile: 72 elements, 16-byte rows for the copies; a float row read as
// [g][2q..2q+1] pairs or as [q][g] scalars by a warp hits 32 banks.
constexpr int TS = MAX_K + 8;
constexpr int SMALL = CHUNK + 8;  // row of the 16 x 16 tiles
constexpr unsigned FULL_MASK = 0xffffffffu;

// walk kernel
constexpr int VB = 64;  // state columns a walk block
constexpr int W_STAGES = 4;
constexpr int PRODUCER_THREADS = 32;
constexpr int W_PREP_THREADS = 256;
constexpr int W_STATE_THREADS = 2 * VB;  // one warp a 16 state columns
constexpr int WALK_THREADS = PRODUCER_THREADS + W_PREP_THREADS + W_STATE_THREADS;

// chunk kernel
constexpr int CP_THREADS = 256;

// du kernel
constexpr int DU_SPLITS = 16;  // runs of consecutive chunks, each summed in order
constexpr int DU_CH = 16;      // channels a block
constexpr int DU_THREADS = DU_SPLITS * DU_CH;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// elements col, col + 1 of a row as float32 (col even)
__device__ __forceinline__ float2 pair(const float* row, int col) {
  return *reinterpret_cast<const float2*>(row + col);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + col));
}

struct Strides {  // element strides of a (B, H, T, last) operand; the last axis is contiguous
  long long b, h, t;
};

struct Args {
  long long t_len;
  int kdim, vdim, n_heads, n_chunks, vp;  // vp: the row of a state in the scratch
  Strides rs, ks, vs, ws, gs, drs, dks, dvs, dws;  // r, k, v, w, dout; dr, dk, dv, dw
};

// 16 bytes from global to shared memory, of which the first `src_bytes` are read and the
// rest are zeros (src_bytes = 0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier receives one arrival once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// d += a b over one k-step of m16n8k8 from float32 values in fragment order (a0..a3, b0..b1,
// mma_tf32.cuh): 3xTF32, leaving out the lo half of a side that is exact in TF32 (EA, EB:
// bfloat16 values), one TF32 product where both are.
template <bool EA, bool EB>
__device__ __forceinline__ void mma_f(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  if constexpr (EA && EB) {
    mma_tf32(d, __float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
             __float_as_uint(a[3]), __float_as_uint(b[0]), __float_as_uint(b[1]));
  } else {
    Tf32x2 sa[4], sb[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[e] = EA ? Tf32x2{__float_as_uint(a[e]), 0u} : split(a[e]);
#pragma unroll
    for (int e = 0; e < 2; ++e) sb[e] = EB ? Tf32x2{__float_as_uint(b[e]), 0u} : split(b[e]);
    if (!EA) mma_tf32(d, sa[0].lo, sa[1].lo, sa[2].lo, sa[3].lo, sb[0].hi, sb[1].hi);
    if (!EB) mma_tf32(d, sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, sb[0].lo, sb[1].lo);
    mma_tf32(d, sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, sb[0].hi, sb[1].hi);
  }
}

// Rows t0 .. t0 + 15 of a (T, cols) operand into a [CHUNK][TS] tile by 16-byte copies, thread
// `tid` of `nthreads`: past T or cols, zeros.
template <typename T>
__device__ __forceinline__ void copy_rows(T (*dst)[TS], const T* src, long long st, int rows,
                                          int cols, int tid, int nthreads) {
  constexpr int PER = 16 / (int)sizeof(T);
  constexpr int SEG = MAX_K / PER;
  for (int e = tid; e < CHUNK * SEG; e += nthreads) {
    const int t = e / SEG, c0 = (e % SEG) * PER;
    const bool in = t < rows && c0 < cols;
    const uint32_t bytes = in ? (uint32_t)min(PER, cols - c0) * (uint32_t)sizeof(T) : 0u;
    cp_async16(&dst[t][c0], in ? src + t * st + c0 : src, bytes);
  }
}

// ---------------------------------------------------------------------------------------
// walk kernel
// ---------------------------------------------------------------------------------------

template <typename T>
struct __align__(16) WalkStage {  // one chunk
  float w[CHUNK][TS];       // decays as loaded
  float a[CHUNK][TS];       // kw (walk A) or r^ (walk B)
  float bf[CHUNK][VB + 8];  // the block's columns of v (walk A) or dout (walk B), float32
  float dlast[MAX_K];       // exp(last)
  T ar[CHUNK][TS];          // k or r as loaded
  T b[CHUNK][VB];           // v or dout columns as loaded
};

template <typename T>
struct __align__(16) WalkShared {
  WalkStage<T> stage[W_STAGES];
  uint64_t full[W_STAGES], ready[W_STAGES], empty[W_STAGES];
};

// Producer warp: chunk number c of the walk (chunk `ci`, from the end for walk B) into stage
// c % W_STAGES once the state warps have freed it.
template <typename T>
__device__ void walk_produce(WalkShared<T>& sm, const T* ap, const T* bp, const float* wp,
                             long long ast, long long bst, long long wst, const Args& a,
                             int vcols, bool back, int lane) {
  constexpr int ES = sizeof(T);
  constexpr int PER = 16 / ES;
  constexpr int VSEG = VB / PER;  // copies in a row of the block's columns
  const int tv = lane / VSEG, cv = (lane % VSEG) * PER;
  const uint32_t bv = cv < vcols ? (uint32_t)min(PER, vcols - cv) * ES : 0u;
  for (int c = 0; c < a.n_chunks; ++c) {
    const int s = c % W_STAGES;
    if (c >= W_STAGES) mbar_wait(smem_u32(&sm.empty[s]), ((c / W_STAGES) - 1) & 1);
    WalkStage<T>& st = sm.stage[s];
    const long long t0 = (long long)(back ? a.n_chunks - 1 - c : c) * CHUNK;
    const int rows = (int)min((long long)CHUNK, a.t_len - t0);
    copy_rows(st.ar, ap + t0 * ast, ast, rows, a.kdim, lane, PRODUCER_THREADS);
    copy_rows(st.w, wp + t0 * wst, wst, rows, a.kdim, lane, PRODUCER_THREADS);
#pragma unroll
    for (int j = 0; j < CHUNK * VSEG / PRODUCER_THREADS; ++j) {
      const int t = tv + j * (PRODUCER_THREADS / VSEG);
      const bool in = t < rows && bv;
      cp_async16(&st.b[t][cv], in ? bp + (t0 + t) * bst + cv : bp, in ? bv : 0u);
    }
    cp_async_arrive(&sm.full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Preparation warps (thread p of W_PREP_THREADS): the chunk's log decays and their cumulative
// sum, exp(last), and kw = k exp(last - cum) (walk A) or r^ = r exp(cum - log w) (walk B); the
// block's columns of v or dout in float32. Four threads a key channel take the logs of 4 rows
// each and share them, and each sums all 16 in row order, as the plain version's cumsum does.
template <typename T>
__device__ void walk_prepare(WalkShared<T>& sm, const Args& a, bool walk_b, int p) {
  constexpr int NQ = W_PREP_THREADS / MAX_K;  // threads a key channel
  constexpr int RQ = CHUNK / NQ;              // rows each: qq, qq + NQ, ...
  constexpr int CW = 32 / NQ;                 // key channels a warp
  const int lane = p % 32, qq = lane / CW, kk = (p / 32) * CW + lane % CW;
  for (int c = 0; c < a.n_chunks; ++c) {
    const int s = c % W_STAGES;
    mbar_wait(smem_u32(&sm.full[s]), (c / W_STAGES) & 1);
    WalkStage<T>& st = sm.stage[s];
    const long long t0 = (long long)(walk_b ? a.n_chunks - 1 - c : c) * CHUNK;
    const long long rows = min((long long)CHUNK, a.t_len - t0);
    float own[RQ], lw[CHUNK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int t = i * NQ + qq;
      const float lg = logf(fmaxf(st.w[t][kk], 1e-38f));
      own[i] = (t < rows && kk < a.kdim) ? lg : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int g = 0; g < NQ; ++g) lw[i * NQ + g] = __shfl_sync(FULL_MASK, own[i], g * CW + lane % CW);
    }
    float cum[CHUNK];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      acc += lw[t];
      cum[t] = acc;
    }
    const float last = cum[CHUNK - 1];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int t = i * NQ + qq;
      float ct = cum[i * NQ];
#pragma unroll
      for (int g = 1; g < NQ; ++g) ct = qq == g ? cum[i * NQ + g] : ct;
      const float x = to_f32(st.ar[t][kk]);
      st.a[t][kk] = walk_b ? x * expf(ct - own[i]) : x * expf(last - ct);
    }
    if (qq == 0) st.dlast[kk] = expf(last);
#pragma unroll
    for (int m = 0; m < CHUNK * VB / W_PREP_THREADS; ++m) {
      const int e = p + m * W_PREP_THREADS, t = e / VB, j = e % VB;
      st.bf[t][j] = to_f32(st.b[t][j]);
    }
    mbar_arrive(smem_u32(&sm.ready[s]));
  }
}

// State warps (thread i of W_STATE_THREADS): warp w holds X^T (X = S for walk A, dS for walk
// B) for its 16 columns n0 = 16 w .., all 64 rows, in registers as the accumulator of an
// m16n8k8 product per 8 rows, as wkv6.cu's state warps hold S: thread (g, q) has xr[kb] =
// X[8 kb + 2q + (0, 1)][column n0 + g], then the same at column n0 + g + 8. Per chunk it stores
// X into the scratch, then X^T <- X^T diag(exp(last)) + b^T a on the tensor cores, b the chunk's
// v or dout columns (exact in TF32 when bfloat16) and a its kw or r^.
template <typename T>
__device__ void walk_state(WalkShared<T>& sm, const Args& a, bool walk_b, int i_state, int j0,
                           const float* x0, float* scratch, float* x_end, size_t head) {
  constexpr bool B_EXACT = sizeof(T) == 2;
  const int lane = i_state % 32, g = lane / 4, q = lane % 4;
  const int n0 = (i_state / 32) * 16;
  const int ja = j0 + n0 + g, jb = ja + 8;  // this thread's two state columns
  const size_t kv = (size_t)a.kdim * a.vdim;
  float xr[MAX_K / 8][4];
#pragma unroll
  for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kb * 8 + 2 * q + (e & 1), j = e < 2 ? ja : jb;
      xr[kb][e] = (x0 != nullptr && row < a.kdim && j < a.vdim)
                      ? x0[head * kv + (size_t)row * a.vdim + j]
                      : 0.f;
    }
  }
  for (int c = 0; c < a.n_chunks; ++c) {
    const int s = c % W_STAGES;
    mbar_wait(smem_u32(&sm.ready[s]), (c / W_STAGES) & 1);
    const WalkStage<T>& st = sm.stage[s];
    const int ci = walk_b ? a.n_chunks - 1 - c : c;
    float* out = scratch + (head * a.n_chunks + ci) * a.kdim * (size_t)a.vp;
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = kb * 8 + 2 * q + (e & 1), j = e < 2 ? ja : jb;
        if (row < a.kdim && j < a.vdim) out[(size_t)row * a.vp + j] = xr[kb][e];
      }
    }
    if (walk_b || c + 1 < a.n_chunks) {  // walk A's final state is not needed
      Tf32x2 ba[2][4];
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        const float f[4] = {st.bf[sb * 8 + q][n0 + g], st.bf[sb * 8 + q][n0 + g + 8],
                            st.bf[sb * 8 + q + 4][n0 + g], st.bf[sb * 8 + q + 4][n0 + g + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) ba[sb][e] = split(f[e]);
      }
#pragma unroll
      for (int kb = 0; kb < MAX_K / 8; ++kb) {
        const float2 d = *reinterpret_cast<const float2*>(&st.dlast[kb * 8 + 2 * q]);
        xr[kb][0] = __fmul_rn(xr[kb][0], d.x);
        xr[kb][1] = __fmul_rn(xr[kb][1], d.y);
        xr[kb][2] = __fmul_rn(xr[kb][2], d.x);
        xr[kb][3] = __fmul_rn(xr[kb][3], d.y);
#pragma unroll
        for (int sb = 0; sb < 2; ++sb) {
          const Tf32x2 aw[2] = {split(st.a[sb * 8 + q][kb * 8 + g]),
                                split(st.a[sb * 8 + q + 4][kb * 8 + g])};
          mma_3xtf32<B_EXACT>(xr[kb], ba[sb], aw);
        }
      }
    }
    mbar_arrive(smem_u32(&sm.empty[s]));
  }
  if (x_end != nullptr) {
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = kb * 8 + 2 * q + (e & 1), j = e < 2 ? ja : jb;
        if (row < a.kdim && j < a.vdim) x_end[head * kv + (size_t)row * a.vdim + j] = xr[kb][e];
      }
    }
  }
}

// blockIdx.x = walk * (column blocks) + column block; walk 0 is A (S_c into `states`), 1 is B
// (dS into `dstates`, dS_0 into ds0).
template <typename T>
__global__ void __launch_bounds__(WALK_THREADS)
    wkv6_bwd_walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ w,
                         const float* __restrict__ s0, const T* __restrict__ dout,
                         const float* __restrict__ ds_last, float* __restrict__ states,
                         float* __restrict__ dstates, float* __restrict__ ds0, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  WalkShared<T>& sm = *reinterpret_cast<WalkShared<T>*>(smem);
  const int nvb = (a.vdim + VB - 1) / VB;
  const bool walk_b = blockIdx.x >= nvb;
  const int j0 = (blockIdx.x % nvb) * VB;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(smem_u32(&sm.full[s]), PRODUCER_THREADS);
      mbar_init(smem_u32(&sm.ready[s]), W_PREP_THREADS);
      mbar_init(smem_u32(&sm.empty[s]), W_STATE_THREADS);
    }
  }
  __syncthreads();
  if (tid < PRODUCER_THREADS) {
    const T* ap = walk_b ? r + b * a.rs.b + h * a.rs.h : k + b * a.ks.b + h * a.ks.h;
    const long long ast = walk_b ? a.rs.t : a.ks.t;
    const T* bp = walk_b ? dout + b * a.gs.b + h * a.gs.h + j0 : v + b * a.vs.b + h * a.vs.h + j0;
    const long long bst = walk_b ? a.gs.t : a.vs.t;
    walk_produce(sm, ap, bp, w + b * a.ws.b + h * a.ws.h, ast, bst, a.ws.t, a,
                 min(VB, a.vdim - j0), walk_b, tid);
  } else if (tid < PRODUCER_THREADS + W_PREP_THREADS) {
    walk_prepare(sm, a, walk_b, tid - PRODUCER_THREADS);
  } else {
    const size_t head = (size_t)b * a.n_heads + h;
    walk_state(sm, a, walk_b, tid - PRODUCER_THREADS - W_PREP_THREADS, j0,
               walk_b ? ds_last : s0, walk_b ? dstates : states, walk_b ? ds0 : nullptr, head);
  }
}

// ---------------------------------------------------------------------------------------
// chunk kernel
// ---------------------------------------------------------------------------------------

template <typename T>
struct __align__(16) ChunkShared {
  T r[CHUNK][TS], k[CHUNK][TS], v[CHUNK][TS], g[CHUNK][TS];  // as loaded; g is dout
  float w[CHUNK][TS];
  float rh[CHUNK][TS], kh[CHUNK][TS];                  // r^, k^
  uint32_t kwh[CHUNK][TS], kwl[CHUNK][TS];             // kw in TF32 halves, split once
  // exp(excl), exp(-cum), exp(last - cum); each entry's reader, the thread that writes dr, dk
  // at it, then writes r^ q over ee and kw p over ec there, for dw's sums over rows
  float ee[CHUNK][TS], ec[CHUNK][TS], dec[CHUNK][TS];
  float ds[MAX_K][TS];  // dS at the chunk's end; then dw's partial sums over pairs
  float vd[CHUNK][SMALL], att[CHUNK][SMALL];           // att strictly lower, zero elsewhere
  float u[MAX_K], dl[MAX_K], held[MAX_K], bonus[CHUNK];
};

// Which of the four thread groups takes the pairs (s, t), s < t, of row t in dw's straddling
// sums: {15, 14, 1}, {13, 12, 5}, {11, 10, 9}, {8, 7, 6, 4, 3, 2}, 30 pairs each.
__device__ __forceinline__ constexpr int pair_group(int t) {
  return (t == 15 || t == 14 || t == 1)   ? 0
         : (t == 13 || t == 12 || t == 5) ? 1
         : (t >= 9 && t <= 11)            ? 2
                                          : 3;
}

// the strictly lower part of vd
__device__ __forceinline__ float lower(const float (*vd)[SMALL], int t, int s) {
  return s < t ? vd[t][s] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(CP_THREADS, 3)
    wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ w,
                          const T* __restrict__ u, const T* __restrict__ dout,
                          const float* __restrict__ states, const float* __restrict__ dstates,
                          T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dw, float* __restrict__ du_part, Args a) {
  constexpr bool EXACT = sizeof(T) == 2;  // r, k, v, dout exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  ChunkShared<T>& sm = *reinterpret_cast<ChunkShared<T>*>(smem);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int kd = a.kdim, vdim = a.vdim;
  const long long t0 = (long long)c * CHUNK;
  const int rows = (int)min((long long)CHUNK, a.t_len - t0);
  const size_t head = (size_t)b * a.n_heads + h;
  const size_t state_off = (head * a.n_chunks + c) * kd * (size_t)a.vp;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;

  // ---- every copy of the chunk at once; S_c straight into registers ----
  copy_rows(sm.r, r + b * a.rs.b + h * a.rs.h + t0 * a.rs.t, a.rs.t, rows, kd, tid, CP_THREADS);
  copy_rows(sm.k, k + b * a.ks.b + h * a.ks.h + t0 * a.ks.t, a.ks.t, rows, kd, tid, CP_THREADS);
  copy_rows(sm.v, v + b * a.vs.b + h * a.vs.h + t0 * a.vs.t, a.vs.t, rows, vdim, tid,
            CP_THREADS);
  copy_rows(sm.g, dout + b * a.gs.b + h * a.gs.h + t0 * a.gs.t, a.gs.t, rows, vdim, tid,
            CP_THREADS);
  copy_rows(sm.w, w + b * a.ws.b + h * a.ws.h + t0 * a.ws.t, a.ws.t, rows, kd, tid, CP_THREADS);
  {
    const float* src = dstates + state_off;
    for (int e = tid; e < MAX_K * (MAX_V / 4); e += CP_THREADS) {
      const int i = e / (MAX_V / 4), j0 = (e % (MAX_V / 4)) * 4;
      const bool in = i < kd && j0 < vdim;
      const uint32_t bytes = in ? (uint32_t)min(4, vdim - j0) * 4u : 0u;
      cp_async16(&sm.ds[i][j0], in ? src + (size_t)i * a.vp + j0 : src, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // S_c in the layout of q = dout S_c^T below: this warp's rows i = 8 warp + g, at the k-step
  // kk the columns j = 8 kk + 2q and j + 1
  float sreg[2 * MAX_V / 8];
  {
    const int i = warp * 8 + g;
    const float* src = states + state_off + (size_t)i * a.vp;
#pragma unroll
    for (int kk = 0; kk < MAX_V / 8; ++kk) {
      const int j = kk * 8 + 2 * q;
      sreg[2 * kk] = (i < kd && j < vdim) ? src[j] : 0.f;
      sreg[2 * kk + 1] = (i < kd && j + 1 < vdim) ? src[j + 1] : 0.f;
    }
  }
  if (tid < MAX_K) sm.u[tid] = tid < kd ? to_f32(u[h * kd + tid]) : 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- the chunk's factors: four threads a key channel, four rows each ----
  {
    constexpr int NQ = 4, RQ = CHUNK / NQ, CW = 32 / NQ;
    const int qq = lane / CW, kk = warp * CW + lane % CW;
    float own[RQ], lw[CHUNK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int t = i * NQ + qq;
      const float lg = logf(fmaxf(sm.w[t][kk], 1e-38f));
      own[i] = (t < rows && kk < kd) ? lg : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int gg = 0; gg < NQ; ++gg) lw[i * NQ + gg] = __shfl_sync(FULL_MASK, own[i], gg * CW + lane % CW);
    }
    float cum[CHUNK];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      acc += lw[t];
      cum[t] = acc;
    }
    const float last = cum[CHUNK - 1];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int t = i * NQ + qq;
      float ct = cum[i * NQ];
#pragma unroll
      for (int gg = 1; gg < NQ; ++gg) ct = qq == gg ? cum[i * NQ + gg] : ct;
      const float ee = expf(ct - own[i]), ec = expf(-ct), dec = expf(last - ct);
      const float rv = to_f32(sm.r[t][kk]), kv = to_f32(sm.k[t][kk]);
      sm.ee[t][kk] = ee;
      sm.ec[t][kk] = ec;
      sm.dec[t][kk] = dec;
      sm.rh[t][kk] = rv * ee;
      sm.kh[t][kk] = kv * ec;
      const Tf32x2 kw = split(kv * dec);
      sm.kwh[t][kk] = kw.hi;
      sm.kwl[t][kk] = kw.lo;
    }
    if (qq == 0) sm.dl[kk] = expf(last);
  }
  __syncthreads();

  // ---- the 16 x 16 tiles (warps 0-3, a column tile each) and each row's bonus ----
  if (warp < 4) {
    const int n0 = (warp % 2) * 8;  // the tile's columns s
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < MAX_K / 8; ++kk) {  // k-slots q, q + 4 are columns 8 kk + 2q, + 1
      const int j = kk * 8 + 2 * q;
      if (warp < 2) {  // vd[t][s] = dout_t . v_s
        const float2 a0 = pair(sm.g[g], j), a1 = pair(sm.g[g + 8], j), bb = pair(sm.v[n0 + g], j);
        const float av[4] = {a0.x, a1.x, a0.y, a1.y}, bv[2] = {bb.x, bb.y};
        mma_f<EXACT, EXACT>(d, av, bv);
      } else {  // att[t][s] = r^_t . k^_s
        const float2 a0 = pair(sm.rh[g], j), a1 = pair(sm.rh[g + 8], j);
        const float2 bb = pair(sm.kh[n0 + g], j);
        const float av[4] = {a0.x, a1.x, a0.y, a1.y}, bv[2] = {bb.x, bb.y};
        mma_f<false, false>(d, av, bv);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = g + 8 * (e >> 1), s = n0 + 2 * q + (e & 1);
      if (warp < 2) {
        sm.vd[t][s] = d[e];
      } else {
        sm.att[t][s] = s < t ? d[e] : 0.f;
      }
    }
  } else if (warp < 6) {  // bonus_t = sum_i r u k: four threads a row
    const int p = tid - 128, tb = p / 4, qb = p % 4;
    float bo = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_K / 4; ++i) {
      const int ch = qb * (MAX_K / 4) + i;
      bo += to_f32(sm.r[tb][ch]) * sm.u[ch] * to_f32(sm.k[tb][ch]);
    }
    bo += __shfl_xor_sync(FULL_MASK, bo, 2);
    bo += __shfl_xor_sync(FULL_MASK, bo, 1);
    if (qb == 0) sm.bonus[tb] = bo;
  }
  __syncthreads();

  // ---- the products over 64 and 16, warp w on columns n0 = 8 w .. (channels i for q, p, x,
  //      y; value columns j for dv); then dr, dk, dv out ----
  {
    const int n0 = warp * 8;
    float qa[4] = {0.f, 0.f, 0.f, 0.f}, pa[4] = {0.f, 0.f, 0.f, 0.f};
    float held = 0.f;  // sum_j dS S_c over this thread's j of row n0 + g
#pragma unroll
    for (int kk = 0; kk < MAX_V / 8; ++kk) {
      const int j = kk * 8 + 2 * q;
      const float2 g0 = pair(sm.g[g], j), g1 = pair(sm.g[g + 8], j);
      const float ag[4] = {g0.x, g1.x, g0.y, g1.y}, bs[2] = {sreg[2 * kk], sreg[2 * kk + 1]};
      mma_f<EXACT, false>(qa, ag, bs);
      const float2 v0 = pair(sm.v[g], j), v1 = pair(sm.v[g + 8], j);
      const float2 dd = pair(sm.ds[n0 + g], j);
      const float av[4] = {v0.x, v1.x, v0.y, v1.y}, bd[2] = {dd.x, dd.y};
      mma_f<EXACT, false>(pa, av, bd);
      held = fmaf(sreg[2 * kk], dd.x, held);
      held = fmaf(sreg[2 * kk + 1], dd.y, held);
    }
    held += __shfl_xor_sync(FULL_MASK, held, 1);
    held += __shfl_xor_sync(FULL_MASK, held, 2);
    if (q == 0) sm.held[n0 + g] = sm.dl[n0 + g] * held;

    float xa[4] = {qa[0], qa[1], qa[2], qa[3]}, ya[4] = {0.f, 0.f, 0.f, 0.f};
    float d1[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < CHUNK / 8; ++ks) {
      const int k0 = ks * 8;
      {  // x += lower(vd) k^
        const float av[4] = {lower(sm.vd, g, k0 + q), lower(sm.vd, g + 8, k0 + q),
                             lower(sm.vd, g, k0 + q + 4), lower(sm.vd, g + 8, k0 + q + 4)};
        const float bv[2] = {sm.kh[k0 + q][n0 + g], sm.kh[k0 + q + 4][n0 + g]};
        mma_f<false, false>(xa, av, bv);
      }
      {  // y += lower(vd)^T r^
        const float av[4] = {lower(sm.vd, k0 + q, g), lower(sm.vd, k0 + q, g + 8),
                             lower(sm.vd, k0 + q + 4, g), lower(sm.vd, k0 + q + 4, g + 8)};
        const float bv[2] = {sm.rh[k0 + q][n0 + g], sm.rh[k0 + q + 4][n0 + g]};
        mma_f<false, false>(ya, av, bv);
      }
      {  // dv += att^T dout
        const float av[4] = {sm.att[k0 + q][g], sm.att[k0 + q][g + 8], sm.att[k0 + q + 4][g],
                             sm.att[k0 + q + 4][g + 8]};
        const float bv[2] = {to_f32(sm.g[k0 + q][n0 + g]), to_f32(sm.g[k0 + q + 4][n0 + g])};
        mma_f<false, EXACT>(d1, av, bv);
      }
    }
#pragma unroll
    for (int kk = 0; kk < MAX_K / 8; ++kk) {  // dv's kw dS, k-slots i = 8 kk + 2q, + 1
      const int i = kk * 8 + 2 * q;
      const uint2 h0 = *reinterpret_cast<const uint2*>(&sm.kwh[g][i]);
      const uint2 h1 = *reinterpret_cast<const uint2*>(&sm.kwh[g + 8][i]);
      const uint2 l0 = *reinterpret_cast<const uint2*>(&sm.kwl[g][i]);
      const uint2 l1 = *reinterpret_cast<const uint2*>(&sm.kwl[g + 8][i]);
      const Tf32x2 b0 = split(sm.ds[i][n0 + g]), b1 = split(sm.ds[i + 1][n0 + g]);
      mma_tf32(d2, l0.x, l1.x, l0.y, l1.y, b0.hi, b1.hi);
      mma_tf32(d2, h0.x, h1.x, h0.y, h1.y, b0.lo, b1.lo);
      mma_tf32(d2, h0.x, h1.x, h0.y, h1.y, b0.hi, b1.hi);
    }
    T* drp = dr + b * a.drs.b + h * a.drs.h;
    T* dkp = dk + b * a.dks.b + h * a.dks.h;
    T* dvp = dv + b * a.dvs.b + h * a.dvs.h;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = g + 8 * (e >> 1), col = n0 + 2 * q + (e & 1);
      const float ee = sm.ee[t][col], ec = sm.ec[t][col];
      const float kw = __uint_as_float(sm.kwh[t][col]) + __uint_as_float(sm.kwl[t][col]);
      sm.ee[t][col] = sm.rh[t][col] * qa[e];  // r^ q
      sm.ec[t][col] = kw * pa[e];             // kw p
      if (t >= rows) continue;
      if (col < kd) {
        const float ukd = sm.u[col] * sm.vd[t][t];
        store_out(drp + (t0 + t) * a.drs.t + col, ee * xa[e] + ukd * to_f32(sm.k[t][col]));
        store_out(dkp + (t0 + t) * a.dks.t + col,
                  ec * ya[e] + sm.dec[t][col] * pa[e] + ukd * to_f32(sm.r[t][col]));
      }
      if (col < vdim) {
        store_out(dvp + (t0 + t) * a.dvs.t + col,
                  (d1[e] + sm.bonus[t] * to_f32(sm.g[t][col])) + d2[e]);
      }
    }
  }
  __syncthreads();

  // ---- dw, a thread a (channel i, group z): first the pairs s < m < t of the t in group z,
  //      into partial sums over m; then, for rows m = z, z + 4, .., the four partials and the
  //      sums over rows; du's part of the chunk ----
  {
    const int i = (warp % 2) * 32 + lane, z = warp / 2;
    float* part = &sm.ds[0][0];  // [4][CHUNK][MAX_K]: dS is read no more
    {
      float khr[CHUNK], acc[CHUNK];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        khr[t] = sm.kh[t][i];
        acc[t] = 0.f;
      }
#pragma unroll
      for (int t = 1; t < CHUNK; ++t) {
        if (pair_group(t) != z) continue;  // warp-uniform
        const float rt = sm.rh[t][i];
        float run = 0.f;  // sum_{s<m} r^_t k^_s vd[t][s]
#pragma unroll
        for (int m = 0; m < t; ++m) {
          acc[m] += run;
          run = fmaf(rt * khr[m], sm.vd[t][m], run);
        }
      }
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) part[(z * CHUNK + m) * MAX_K + i] = acc[m];
    }
    const float held = sm.held[i];
    float early[CHUNK / 4];  // sum_{s<m} kw_s p_s of this thread's rows
    float e = 0.f;
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
      if (m % 4 == z) early[m / 4] = e;
      e += sm.ec[m][i];
    }
    __syncthreads();
    float* dwp = dw + b * a.dws.b + h * a.dws.h;
    float later = 0.f;  // sum_{t>m} r^_t q_t, from the chunk's end
#pragma unroll
    for (int m = CHUNK - 1; m >= 0; --m) {
      if (m % 4 == z && m < rows && i < kd) {  // warp-uniform but for the edges
        const float straddle = ((part[m * MAX_K + i] + part[(CHUNK + m) * MAX_K + i]) +
                                part[(2 * CHUNK + m) * MAX_K + i]) +
                               part[(3 * CHUNK + m) * MAX_K + i];
        const float dlw = ((later + straddle) + held) + early[m / 4];
        const float wm = sm.w[m][i];
        dwp[(t0 + m) * a.dws.t + i] = wm > 1e-38f ? dlw / wm : 0.f;
      }
      later += sm.ee[m][i];
    }
    if (z == 0 && i < kd) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        acc += to_f32(sm.r[t][i]) * to_f32(sm.k[t][i]) * sm.vd[t][t];
      }
      du_part[(head * a.n_chunks + c) * kd + i] = acc;
    }
  }
}

// ---------------------------------------------------------------------------------------
// du kernel
// ---------------------------------------------------------------------------------------

// du (H, K) from the partials (B, H, NC, K), in u's dtype: for each batch row the chunks in
// DU_SPLITS runs of ceil(NC / DU_SPLITS) consecutive chunks, each run summed in order, the
// runs added in order; then the batch rows added in order. Block (h, 16 channels).
template <typename T>
__global__ void __launch_bounds__(DU_THREADS)
    wkv6_bwd_du_kernel(const float* __restrict__ du_part, T* __restrict__ du, int b, int n_heads,
                       int n_chunks, int kdim) {
  __shared__ float runs[DU_SPLITS][DU_CH];
  const int h = blockIdx.x, ch = threadIdx.x % DU_CH, z = threadIdx.x / DU_CH;
  const int i = blockIdx.y * DU_CH + ch;
  const int per = (n_chunks + DU_SPLITS - 1) / DU_SPLITS;
  const int c0 = min(n_chunks, z * per), c1 = min(n_chunks, c0 + per);
  float total = 0.f;
  for (int bb = 0; bb < b; ++bb) {
    float run = 0.f;
    if (i < kdim) {
      const float* src = du_part + ((size_t)bb * n_heads + h) * n_chunks * kdim + i;
      for (int c = c0; c < c1; ++c) run += src[(size_t)c * kdim];
    }
    runs[z][ch] = run;
    __syncthreads();
    if (z == 0) {
      float row = runs[0][ch];
      for (int zz = 1; zz < DU_SPLITS; ++zz) row += runs[zz][ch];
      total = bb == 0 ? row : total + row;
    }
    __syncthreads();
  }
  if (z == 0 && i < kdim) store_out(du + (size_t)h * kdim + i, total);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, const void* dout, const float* ds_last, float* states, void* dr,
           void* dk, void* dv, float* dw, float* du_part, void* du, float* ds0, const Args& a,
           int b, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  float* dstates = states + (size_t)b * a.n_heads * a.n_chunks * a.kdim * a.vp;
  const size_t walk_smem = sizeof(WalkShared<T>);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_walk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)walk_smem);
  if (err != cudaSuccess) return (int)err;
  const int nvb = (a.vdim + VB - 1) / VB;
  wkv6_bwd_walk_kernel<T><<<dim3(2 * nvb, a.n_heads, b), WALK_THREADS, walk_smem, stream>>>(
      rt, kt, vt, w, s0, gt, ds_last, states, dstates, ds0, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t chunk_smem = sizeof(ChunkShared<T>);
  err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chunk_smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunk_kernel<T><<<dim3(a.n_chunks, a.n_heads, b), CP_THREADS, chunk_smem, stream>>>(
      rt, kt, vt, w, static_cast<const T*>(u), gt, states, dstates, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du_kernel<T><<<dim3(a.n_heads, (a.kdim + DU_CH - 1) / DU_CH), DU_THREADS, 0,
                          stream>>>(du_part, static_cast<T*>(du), b, a.n_heads, a.n_chunks,
                                    a.kdim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k (B,H,T,K), v and dout (B,H,T,V), u (H,K, contiguous) float32 or bfloat16 (is_bf16); w
// (B,H,T,K) float32; s0 and ds_last (B,H,K,V) float32 contiguous, or null for zeros; states
// float32 scratch of 2 x (B,H,ceil(T/16),K,vp) with vp = V rounded up to a multiple of 4 (S_c,
// then dS at each chunk's end). Writes dr, dk (B,H,T,K) and dv (B,H,T,V) in the dtype of r, dw
// (B,H,T,K) float32, du_part (B,H,ceil(T/16),K) float32 (each chunk's part), du (H,K) in the
// dtype of r, and ds0 (B,H,K,V) float32 contiguous unless it is null. `strides` holds 27
// element strides, (batch, head, time) of r, k, v, w, dout, dr, dk, dv and dw in that order;
// the last axis of each is contiguous, and r, k, v, w and dout must be 16-byte aligned with
// (batch, head, time) strides of whole 16 bytes. The caller has checked shapes, 1 <= K, V <=
// 64 and B, H <= 65535. Returns the cudaError_t of the launches (0 on success). Does not
// synchronise.
int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, const void* dout, const void* ds_last, void* states, void* dr,
                   void* dk, void* dv, void* dw, void* du_part, void* du, void* ds0,
                   const long long* strides, int b, int h, long long t_len, int kdim, int vdim,
                   int is_bf16, void* stream) {
  if (b < 0 || h < 0 || t_len < 0 || kdim < 1 || kdim > MAX_K || vdim < 1 || vdim > MAX_V ||
      b > 65535 || h > 65535 || (t_len + CHUNK - 1) / CHUNK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || t_len == 0) return 0;
  const long long es = is_bf16 ? 2 : 4;
  uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                  reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                  reinterpret_cast<uintptr_t>(dout);
  for (int i = 0; i < 15; ++i) any |= (uintptr_t)(strides[i] * (i / 3 == 3 ? 4 : es));
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Args a;
  a.t_len = t_len;
  a.kdim = kdim;
  a.vdim = vdim;
  a.n_heads = h;
  a.n_chunks = (int)((t_len + CHUNK - 1) / CHUNK);
  a.vp = (vdim + 3) / 4 * 4;
  Strides* dst[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs, &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int i = 0; i < 9; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  const float* dlf = static_cast<const float*>(ds_last);
  float* sf = static_cast<float*>(states);
  float* dwf = static_cast<float*>(dw);
  float* dpf = static_cast<float*>(du_part);
  float* d0f = static_cast<float*>(ds0);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, wf, u, s0f, dout, dlf, sf, dr, dk, dv, dwf, dpf, du, d0f,
                                 a, b, st);
  return launch<float>(r, k, v, wf, u, s0f, dout, dlf, sf, dr, dk, dv, dwf, dpf, du, d0f, a, b,
                       st);
}

// Dynamic shared memory of a block in bytes (for reports): part 0 the walk kernel, 1 the chunk
// kernel; is_bf16 picks the instantiation.
int repro_wkv6_bwd_shared_bytes(int part, int is_bf16) {
  if (part == 0) return (int)(is_bf16 ? sizeof(WalkShared<__nv_bfloat16>) : sizeof(WalkShared<float>));
  return (int)(is_bf16 ? sizeof(ChunkShared<__nv_bfloat16>) : sizeof(ChunkShared<float>));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
