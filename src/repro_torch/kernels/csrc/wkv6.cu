// RWKV6 WKV recurrence (data-dependent decay, K x V state per head) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` in src/repro/kernels/rwkv6.py (launched by
// `wkv6_pallas` through `pl.pallas_call`). Same function, the chunked form with chunk 16 in
// float32 and the state carried across chunks on chip. Per chunk of 16 rows:
//   logw = log(max(w, 1e-38)),  cum = cumsum_t(logw)
//   r^ = r * exp(cum - logw),  k^ = k / max(exp(cum), 1e-30)
//   out = r^ S  +  strict_lower(r^ k^T) v  +  (sum_k r u k) v
//   S'  = diag(exp(cum_last)) S  +  sum_s exp(cum_last - cum_s) k_s v_s^T
// Inputs r, k, v, u in float32 or bfloat16, w and the state in float32; the output in the
// dtype of r, the final state in float32. The reference pads T to the chunk with r = k = 0,
// w = 1; here the rows past T (and the key channels past K) are loaded as zeros and given
// log w = 0, the same no-op.
//
// Two kernels, picked by the wrapper by T alone:
//
// `wkv6_chunk_kernel` (prefill). Per chunk only two products touch the state, r^ S and the
// update; everything else (logs, cumulative sums, exps, r^, k^, the update weights, the
// 16 x 16 attention tile, its product with v, the bonus) is free of S and is computed chunks
// ahead. One block owns one (batch, head) and VB = 32 of its V state columns, with warps in
// three roles that meet only at `mbarrier`s of a ring of STAGES chunk stages in shared memory:
//   - a producer warp keeps the ring filled with `cp.async` (16-byte copies, zero fill past
//     T, K and V) and completes each stage's "full" barrier with `cp.async.mbarrier.arrive`;
//   - eight preparation warps turn a full stage into r^, the update weights, D_last, each
//     row's bonus, v in float32 and the intra-chunk part of the output, then arrive on its
//     "ready" barrier; their three phases meet at a named barrier of their own;
//   - one state warp a 16 columns holds S^T for them in registers, as the accumulator of
//     m16n8k8 tensor-core products, and per chunk waits on "ready" (its one wait), computes
//     the cross term and the update there in 3xTF32 (hi/lo halves: float32 accuracy, no
//     bf16 or single-pass TF32 operand touches S or the cross term), stores the output rows
//     and arrives on "empty".
// The FMA form of the two products is bound by its shared-memory loads (a 16-byte warp load
// for every 4 FMAs a thread, 4 cycles of an SM's each; tools/wkv6_state_probe.py measures
// it); on the tensor cores each operand read feeds eight products. A head's two column halves are two blocks, 128
// blocks at rwkv6-7b's prefill, one per SM, that each prepare the chunk: one block a head
// (VB = 64) prepares it once but leaves half the SMs idle, and was slower (PERF.md).
//
// `wkv6_stream_kernel` (decode, short T). One block per (batch, head) reads S once with
// 16-byte coalesced loads into registers (16 elements a thread), steps through the T rows
// as one-row chunks (D = exp(log(max(w, 1e-38))), y = r S + (sum r u k) v, S' = D S + k v^T)
// with one block-level reduction for y a row, and writes S' once.
//
// Order of arithmetic. For one (batch, head) it depends on T, K and V only: never on B, H or
// which blocks share an SM; no atomics. Two launches give equal bits, and a batch row alone
// gives the bits it gives within a batch.
//
// Range. The factored exponents reach |4 * 15| = 60 within a chunk (the model clamps
// log w to [-4, -1e-4]), inside float32's range, but only with accurate expf/logf: the file
// must not be built with --use_fast_math (whose __expf loses relative accuracy at large
// arguments and which flushes the 1e-38 floor, a subnormal, to zero).
//
// Bound on this card, at the prefill shape (1, 64, 3000, 64) with r, k, v in bfloat16: the
// bytes (r, k, v bf16, w f32, out bf16, h0 and the final state f32) are ~149.5 MB, 0.0446 ms
// at 3.35 TB/s; the chunked form's ~4.2 GFLOP would be 0.063 ms on the float32 CUDA cores.
// Decode (4, 64, 1, 64) reads and writes the 4.2 MB float32 state: 2.5 us.
//
// Layout: r, k, v, w and out are taken by strides (batch, head, time) with the last axis
// contiguous, so the model's (B, T, H, K) projections go in as they are, without a
// transposing copy; u is (H, K) and the states (B, H, K, V), contiguous. The chunk kernel's
// 16-byte copies need r, k, v, w 16-byte aligned with strides of whole 16 bytes; the
// wrapper pads what is not.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int CHUNK = 16;
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int STAGES = 4;
constexpr int PRODUCER_THREADS = 32;
constexpr int PREP_THREADS = 256;
constexpr int ROW = MAX_K + 8;  // padded row of a (chunk, K) tile
constexpr int PREP_BARRIER = 1;  // named barrier of the preparation warps (0 is __syncthreads)
constexpr int KH_ROW = MAX_K + 4;  // padded k^ row: 8 rows read at once hit 8 bank groups
constexpr int VB = 32;  // state columns a block of the chunk kernel
constexpr int STATE_THREADS = 2 * VB;  // one warp a 16 state columns
constexpr int CHUNK_THREADS = PRODUCER_THREADS + PREP_THREADS + STATE_THREADS;
constexpr int STREAM_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of a (B, H, T, last) operand; the last axis is contiguous
  long long b, h, t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

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

__device__ __forceinline__ void prep_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(PREP_BARRIER), "n"(PREP_THREADS) : "memory");
}

// ---------------------------------------------------------------------------------------
// chunk kernel
// ---------------------------------------------------------------------------------------

template <typename T>
struct __align__(16) Stage {  // one chunk of 16 rows; rows of ROW so that reads hit 32 banks
  float w[CHUNK][ROW];     // decays as loaded
  float rh[CHUNK][ROW];    // r^
  float kw[CHUNK][ROW];    // update weights k exp(cum_last - cum)
  float y[CHUNK][VB + 8];  // intra-chunk part of the output: strict_lower(r^ k^T) v
  float vf[CHUNK][VB + 8]; // v in float32
  float dlast[MAX_K];      // exp(cum_last)
  float bonus[CHUNK];      // sum_k r u k of each row
  T r[CHUNK][ROW];
  T k[CHUNK][ROW];
  T v[CHUNK][VB];          // the block's columns
};

template <typename T>
struct __align__(16) Shared {
  Stage<T> stage[STAGES];
  float kh[CHUNK][KH_ROW];  // k^ of the chunk being prepared
  float att[CHUNK][CHUNK + 4];  // rows of 16-byte reads
  float u[MAX_K];
  uint64_t full[STAGES], ready[STAGES], empty[STAGES];
};

struct ChunkArgs {
  long long t_len;
  int kdim, vdim, n_heads;
  Strides rs, ks, vs, ws, os;
};

// Producer warp: fills stage c % STAGES with chunk c once the state warps have freed it.
template <typename T>
__device__ void produce(Shared<T>& sm, const T* rp, const T* kp, const T* vp,
                        const float* wp, const ChunkArgs& a, int vcols, int n_chunks, int lane) {
  constexpr int ES = sizeof(T);
  constexpr int PER = 16 / ES;       // elements in a 16-byte copy
  constexpr int KSEG = MAX_K / PER;  // copies in a row of r or k
  constexpr int VSEG = VB / PER;     // in a row of the block's v columns
  constexpr int WSEG = MAX_K / 4;    // in a row of w
  // Each lane copies the same columns of every chunk, in rows t0 + t, t0 + t + 32 / SEG, ..
  const int tr = lane / KSEG, cr = (lane % KSEG) * PER;
  const int tv = lane / VSEG, cv = (lane % VSEG) * PER;
  const int tw = lane / WSEG, cw = (lane % WSEG) * 4;
  const uint32_t br = cr < a.kdim ? min(16, (a.kdim - cr) * ES) : 0;
  const uint32_t bv = cv < vcols ? min(16, (vcols - cv) * ES) : 0;
  const uint32_t bw = cw < a.kdim ? min(16, (a.kdim - cw) * 4) : 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    if (c >= STAGES) mbar_wait(&sm.empty[s], ((c / STAGES) - 1) & 1);
    Stage<T>& st = sm.stage[s];
    const long long t0 = (long long)c * CHUNK;
    const int rows = (int)min((long long)CHUNK, a.t_len - t0);
    const T* r0 = rp + (t0 + tr) * a.rs.t + cr;
    const T* k0 = kp + (t0 + tr) * a.ks.t + cr;
#pragma unroll
    for (int j = 0; j < CHUNK * KSEG / 32; ++j) {
      const int t = tr + j * (32 / KSEG);
      const bool in = t < rows && br;
      const long long dt = (long long)j * (32 / KSEG);
      cp_async16(&st.r[t][cr], in ? r0 + dt * a.rs.t : rp, in ? br : 0);
      cp_async16(&st.k[t][cr], in ? k0 + dt * a.ks.t : kp, in ? br : 0);
    }
    const T* v0 = vp + (t0 + tv) * a.vs.t + cv;
#pragma unroll
    for (int j = 0; j < CHUNK * VSEG / 32; ++j) {
      const int t = tv + j * (32 / VSEG);
      const bool in = t < rows && bv;
      cp_async16(&st.v[t][cv], in ? v0 + (long long)j * (32 / VSEG) * a.vs.t : vp, in ? bv : 0);
    }
    const float* w0 = wp + (t0 + tw) * a.ws.t + cw;
#pragma unroll
    for (int j = 0; j < CHUNK * WSEG / 32; ++j) {
      const int t = tw + j * (32 / WSEG);
      const bool in = t < rows && bw;
      cp_async16(&st.w[t][cw], in ? w0 + (long long)j * (32 / WSEG) * a.ws.t : wp, in ? bw : 0);
    }
    cp_async_arrive(&sm.full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Preparation warps (thread p of PREP_THREADS): everything of a chunk that does not depend
// on S.
template <typename T>
__device__ void prepare(Shared<T>& sm, const ChunkArgs& a, int n_chunks, int p) {
  constexpr int NQ = PREP_THREADS / MAX_K;  // phase 1: threads a key channel
  constexpr int RQ = CHUNK / NQ;            // rows each: qq, qq + NQ, ...
  constexpr int CW = 32 / NQ;               // key channels a warp
  const int lane = p % 32, qq = lane / CW, kk = (p / 32) * CW + lane % CW;
  // phase 2: thread p < 120 computes entry (ta, sa) of the strictly lower attention tile,
  // threads 128..191 the bonus of row tb over key channels 16 qb .. 16 qb + 15
  constexpr int TRI = CHUNK * (CHUNK - 1) / 2;
  int ta = 1, sa = p;
  while (sa >= ta) sa -= ta++;
  const int tb = (p - 128) / 4, qb = p % 4;
  constexpr int YR = CHUNK * VB / PREP_THREADS;  // phase 3: rows of column jy
  const int jy = p % VB, ty = (p / VB) * YR;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&sm.full[s], (c / STAGES) & 1);
    Stage<T>& st = sm.stage[s];
    const long long rows = min((long long)CHUNK, a.t_len - (long long)c * CHUNK);

    // 1. log decay and its cumulative sum along the chunk; r^, k^, update weights, D_last.
    //    The NQ threads of a channel take the logs of RQ rows each and share them, and each
    //    sums all 16 in row order, as the plain version's cumsum does: a sum split in parts
    //    would round the exponents (up to 60 in size) otherwise, and with them r^ k^.
    float own[RQ], lw[CHUNK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int t = i * NQ + qq;
      const float lg = logf(fmaxf(st.w[t][kk], 1e-38f));  // no branch: the logs overlap
      own[i] = (t < rows && kk < a.kdim) ? lg : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        lw[i * NQ + g] = __shfl_sync(FULL_MASK, own[i], g * CW + lane % CW);
      }
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
      const float rv = to_f32(st.r[t][kk]), kv = to_f32(st.k[t][kk]);
      st.rh[t][kk] = rv * expf(ct - own[i]);
      sm.kh[t][kk] = kv * fminf(expf(-ct), 1e30f);  // k / max(exp(cum), 1e-30), no divide
      st.kw[t][kk] = kv * expf(last - ct);
    }
    if (qq == 0) st.dlast[kk] = expf(last);
    prep_barrier();

    // 2. attention tile (strictly lower; its other entries stay 0) and each row's bonus
    if (p < TRI) {
      float d[2] = {0.f, 0.f};  // two sums, keys 0..31 and 32..63
      const float4* rrow = reinterpret_cast<const float4*>(st.rh[ta]);
      const float4* krow = reinterpret_cast<const float4*>(sm.kh[sa]);
#pragma unroll
      for (int i = 0; i < MAX_K / 4; ++i) {
        const float4 x = rrow[i], y = krow[i];
        const int h2 = i / (MAX_K / 8);
        d[h2] = fmaf(x.x, y.x, d[h2]);
        d[h2] = fmaf(x.y, y.y, d[h2]);
        d[h2] = fmaf(x.z, y.z, d[h2]);
        d[h2] = fmaf(x.w, y.w, d[h2]);
      }
      sm.att[ta][sa] = d[0] + d[1];
    } else if (p >= 128 && p < 192) {
      float bo = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_K / 4; ++i) {
        const int k2i = qb * (MAX_K / 4) + i;
        bo += __fmul_rn(to_f32(st.r[tb][k2i]) * sm.u[k2i], to_f32(st.k[tb][k2i]));
      }
      bo += __shfl_xor_sync(FULL_MASK, bo, 2);
      bo += __shfl_xor_sync(FULL_MASK, bo, 1);
      if (qb == 0) st.bonus[tb] = bo;
    }
    prep_barrier();

    // 3. the intra-chunk part of the output, y = att v, and v in float32
    {
      float vc[CHUNK];
#pragma unroll
      for (int s2 = 0; s2 < CHUNK; ++s2) vc[s2] = to_f32(st.v[s2][jy]);
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int t = ty + i;
        float y = 0.f;
#pragma unroll
        for (int s4 = 0; s4 < CHUNK / 4; ++s4) {
          const float4 at = *reinterpret_cast<const float4*>(&sm.att[t][4 * s4]);
          y = fmaf(at.x, vc[4 * s4], y);
          y = fmaf(at.y, vc[4 * s4 + 1], y);
          y = fmaf(at.z, vc[4 * s4 + 2], y);
          y = fmaf(at.w, vc[4 * s4 + 3], y);
        }
        st.y[t][jy] = y;
        st.vf[t][jy] = to_f32(st.v[t][jy]);
      }
    }
    mbar_arrive(&sm.ready[s]);
  }
}

// Tensor-core products in float32 accuracy (tf32, split, mma_tf32, mma_3xtf32):
// mma_tf32.cuh.

// State warps (thread i of STATE_THREADS): warp w holds S^T for its 16 columns n0 = 16 w ..,
// all 64 rows, in registers as the accumulator of an m16n8k8 product per 8 rows: thread
// (g, q) has sr[kb] = S[8 kb + 2q + (0, 1)][column n0 + g], then the same at column
// n0 + g + 8. Per chunk, on the tensor cores in 3xTF32:
//   cross^T (16 columns x 16 rows t) = S^T r^^T, S^T as the A operand straight from sr, with
//     the 8 rows of a k-step taken in the order 0, 2, 4, 6, 1, 3, 5, 7 so that r^ pairs are
//     one 8-byte read;
//   S'^T = S^T diag(D_last) + v^T kw, sr as the accumulator.
template <typename T>
__device__ void advance(Shared<T>& sm, const ChunkArgs& a, int n_chunks, int i_state,
                        int j0, const float* s0, float* s_out, T* op, size_t state_base) {
  constexpr bool V_EXACT = sizeof(T) == 2;
  const int lane = i_state % 32, g = lane / 4, q = lane % 4;
  const int n0 = (i_state / 32) * 16;
  const int ja = j0 + n0 + g, jb = ja + 8;  // this thread's two state columns
  float sr[MAX_K / 8][4];
#pragma unroll
  for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kb * 8 + 2 * q + (e & 1), j = e < 2 ? ja : jb;
      sr[kb][e] = (s0 != nullptr && row < a.kdim && j < a.vdim)
                      ? s0[state_base + (size_t)row * a.vdim + j]
                      : 0.f;
    }
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&sm.ready[s], (c / STAGES) & 1);
    const Stage<T>& st = sm.stage[s];

    // cross term: cx[tt] holds (column n0 + g + 8 (e / 2), row t = 8 tt + 2q + e % 2). Eight
    // independent sums (two row tiles, two halves of the keys, hi*hi and the corrections)
    // keep eight products in flight instead of one chain of 24.
    float cm[2][2][4] = {}, cc[2][2][4] = {};
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) {
      const Tf32x2 sa[4] = {split(sr[kb][0]), split(sr[kb][2]), split(sr[kb][1]),
                            split(sr[kb][3])};
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const float2 x = *reinterpret_cast<const float2*>(&st.rh[tt * 8 + g][kb * 8 + 2 * q]);
        const Tf32x2 r0 = split(x.x), r1 = split(x.y);
        float(&m)[4] = cm[tt][kb / 4];
        float(&cr)[4] = cc[tt][kb / 4];
        mma_tf32(cr, sa[0].lo, sa[1].lo, sa[2].lo, sa[3].lo, r0.hi, r1.hi);
        mma_tf32(cr, sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, r0.lo, r1.lo);
        mma_tf32(m, sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, r0.hi, r1.hi);
      }
    }
    float cx[2][4];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cx[tt][e] = (cm[tt][0][e] + cc[tt][0][e]) + (cm[tt][1][e] + cc[tt][1][e]);
      }
    }
    const long long t0 = (long long)c * CHUNK;
    const long long rows = min((long long)CHUNK, a.t_len - t0);
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tt * 8 + 2 * q + (e & 1), jl = n0 + g + 8 * (e >> 1), j = j0 + jl;
        if (t < rows && j < a.vdim) {  // (cross + intra) + bonus v, as the plain version sums
          const float diag = __fmul_rn(st.bonus[t], st.vf[t][jl]);
          store_out(op + (t0 + t) * a.os.t + j, (cx[tt][e] + st.y[t][jl]) + diag);
        }
      }
    }

    // state update: A = v^T (columns x the chunk's rows s), B = kw (rows s x key rows)
    Tf32x2 va[2][4];
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      va[sb][0] = split(st.vf[sb * 8 + q][n0 + g]);
      va[sb][1] = split(st.vf[sb * 8 + q][n0 + g + 8]);
      va[sb][2] = split(st.vf[sb * 8 + q + 4][n0 + g]);
      va[sb][3] = split(st.vf[sb * 8 + q + 4][n0 + g + 8]);
    }
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) {
      const float2 d = *reinterpret_cast<const float2*>(&st.dlast[kb * 8 + 2 * q]);
      sr[kb][0] = __fmul_rn(sr[kb][0], d.x);
      sr[kb][1] = __fmul_rn(sr[kb][1], d.y);
      sr[kb][2] = __fmul_rn(sr[kb][2], d.x);
      sr[kb][3] = __fmul_rn(sr[kb][3], d.y);
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        const Tf32x2 kb2[2] = {split(st.kw[sb * 8 + q][kb * 8 + g]),
                               split(st.kw[sb * 8 + q + 4][kb * 8 + g])};
        mma_3xtf32<V_EXACT>(sr[kb], va[sb], kb2);
      }
    }
    mbar_arrive(&sm.empty[s]);
  }
#pragma unroll
  for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = kb * 8 + 2 * q + (e & 1), j = e < 2 ? ja : jb;
      if (row < a.kdim && j < a.vdim) s_out[state_base + (size_t)row * a.vdim + j] = sr[kb][e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ w, const T* __restrict__ u,
                      const float* __restrict__ s0, T* __restrict__ out,
                      float* __restrict__ s_out, ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<T>& sm = *reinterpret_cast<Shared<T>*>(smem);
  const int j0 = blockIdx.x * VB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], PRODUCER_THREADS);
      mbar_init(&sm.ready[s], PREP_THREADS);
      mbar_init(&sm.empty[s], STATE_THREADS);
    }
  }
  for (int i = tid; i < MAX_K; i += CHUNK_THREADS) {
    sm.u[i] = i < a.kdim ? to_f32(u[h * a.kdim + i]) : 0.f;
  }
  for (int i = tid; i < CHUNK * (CHUNK + 4); i += CHUNK_THREADS) {
    (&sm.att[0][0])[i] = 0.f;  // the tile's diagonal and upper entries, never written again
  }
  __syncthreads();
  const int n_chunks = (int)((a.t_len + CHUNK - 1) / CHUNK);
  if (tid < PRODUCER_THREADS) {
    produce(sm, r + b * a.rs.b + h * a.rs.h, k + b * a.ks.b + h * a.ks.h,
            v + b * a.vs.b + h * a.vs.h + j0, w + b * a.ws.b + h * a.ws.h, a,
            min(VB, a.vdim - j0), n_chunks, tid);
  } else if (tid < PRODUCER_THREADS + PREP_THREADS) {
    prepare(sm, a, n_chunks, tid - PRODUCER_THREADS);
  } else {
    const size_t state_base = ((size_t)b * a.n_heads + h) * a.kdim * a.vdim;
    advance(sm, a, n_chunks, tid - PRODUCER_THREADS - PREP_THREADS, j0, s0, s_out,
            out + b * a.os.b + h * a.os.h, state_base);
  }
}

template <typename T>
int launch_chunk(const void* r, const void* k, const void* v, const float* w, const void* u,
                 const float* s0, void* out, float* s_out, const ChunkArgs& a, int b,
                 cudaStream_t stream) {
  const size_t smem = sizeof(Shared<T>);
  cudaError_t err = cudaFuncSetAttribute(wkv6_chunk_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.vdim + VB - 1) / VB, a.n_heads, b);
  wkv6_chunk_kernel<T><<<grid, CHUNK_THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), s0, static_cast<T*>(out), s_out, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// stream kernel
// ---------------------------------------------------------------------------------------

// Thread (rg, cg) = (tid / 16, tid % 16) holds rows 4 rg .. 4 rg + 3 and columns
// 4 cg .. 4 cg + 3 of S.
template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
    wkv6_stream_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ w, const T* __restrict__ u,
                       const float* __restrict__ s0, T* __restrict__ out,
                       float* __restrict__ s_out, ChunkArgs a) {
  __shared__ float part[2][STREAM_THREADS / 32][MAX_V];  // per-warp partial y, two rows apart
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = tid % 16, rg = tid / 16;
  const int kdim = a.kdim, vdim = a.vdim;
  const bool vec = vdim % 4 == 0;  // 16-byte rows of the state (the wrapper aligns its base)
  const size_t base = ((size_t)b * a.n_heads + h) * kdim * vdim;

  float S[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) S[i][jj] = 0.f;
    if (s0 == nullptr || row >= kdim) continue;
    const float* src = s0 + base + (size_t)row * vdim + cg * 4;
    if (vec && cg * 4 < vdim) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      S[i][0] = x.x, S[i][1] = x.y, S[i][2] = x.z, S[i][3] = x.w;
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (cg * 4 + jj < vdim) S[i][jj] = src[jj];
      }
    }
  }
  // u of the bonus's two channels a lane sums: lane and lane + 32
  const float u0 = lane < kdim ? to_f32(u[h * kdim + lane]) : 0.f;
  const float u1 = lane + 32 < kdim ? to_f32(u[h * kdim + lane + 32]) : 0.f;

  const T* rp = r + b * a.rs.b + h * a.rs.h;
  const T* kp = k + b * a.ks.b + h * a.ks.h;
  const T* vp = v + b * a.vs.b + h * a.vs.h;
  const float* wp = w + b * a.ws.b + h * a.ws.h;
  T* op = out + b * a.os.b + h * a.os.h;
  for (long long t = 0; t < a.t_len; ++t) {
    float rr[4], kv[4], dd[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 4 + i;
      const bool in = row < kdim;
      rr[i] = in ? to_f32(rp[t * a.rs.t + row]) : 0.f;
      kv[i] = in ? to_f32(kp[t * a.ks.t + row]) : 0.f;
      dd[i] = in ? expf(logf(fmaxf(wp[t * a.ws.t + row], 1e-38f))) : 1.f;
      const int col = cg * 4 + i;
      vv[i] = col < vdim ? to_f32(vp[t * a.vs.t + col]) : 0.f;
    }
    // r S over this thread's rows, then over the two row groups of the warp
    float y[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = fmaf(rr[i], S[i][jj], acc);
      y[jj] = acc + __shfl_xor_sync(FULL_MASK, acc, 16);
    }
    const int buf = (int)(t & 1);
    if (lane < 16) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) part[buf][warp][cg * 4 + jj] = y[jj];
    }
    // the bonus sum_k r u k, in the two warps that write the output
    float bo = 0.f;
    if (warp < 2) {
      if (lane < kdim) bo = to_f32(rp[t * a.rs.t + lane]) * u0 * to_f32(kp[t * a.ks.t + lane]);
      if (lane + 32 < kdim) {
        bo += __fmul_rn(to_f32(rp[t * a.rs.t + lane + 32]) * u1,
                        to_f32(kp[t * a.ks.t + lane + 32]));
      }
#pragma unroll
      for (int o = 16; o >= 1; o /= 2) bo += __shfl_xor_sync(FULL_MASK, bo, o);
    }
    // S' = D S + k v^T, in registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        S[i][jj] = __fmul_rn(dd[i], S[i][jj]) + __fmul_rn(kv[i], vv[jj]);
      }
    }
    __syncthreads();
    if (tid < vdim) {
      float acc = part[buf][0][tid];
#pragma unroll
      for (int wi = 1; wi < STREAM_THREADS / 32; ++wi) acc += part[buf][wi][tid];
      store_out(op + t * a.os.t + tid, acc + __fmul_rn(bo, to_f32(vp[t * a.vs.t + tid])));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg * 4 + i;
    float* dst = s_out + base + (size_t)row * vdim + cg * 4;
    if (row < kdim && vec && cg * 4 < vdim) {
      *reinterpret_cast<float4*>(dst) = make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
    } else if (row < kdim) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (cg * 4 + jj < vdim) dst[jj] = S[i][jj];
      }
    }
  }
}

template <typename T>
int launch_stream(const void* r, const void* k, const void* v, const float* w, const void* u,
                  const float* s0, void* out, float* s_out, const ChunkArgs& a, int b,
                  cudaStream_t stream) {
  const dim3 grid(a.n_heads, b);
  wkv6_stream_kernel<T><<<grid, STREAM_THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), s0, static_cast<T*>(out), s_out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int path, const void* r, const void* k, const void* v, const float* w, const void* u,
        const float* s0, void* out, float* s_out, const ChunkArgs& a, int b, cudaStream_t st) {
  if (path == 1) return launch_stream<T>(r, k, v, w, u, s0, out, s_out, a, b, st);
  return launch_chunk<T>(r, k, v, w, u, s0, out, s_out, a, b, st);
}

}  // namespace

extern "C" {

// r, k (B,H,T,K), v (B,H,T,V) and u (H,K, contiguous) float32 or bfloat16 (is_bf16); w
// (B,H,T,K) float32; s0 (B,H,K,V) float32 contiguous, or null for zeros; out (B,H,T,V) in
// the dtype of r; s_out (B,H,K,V) float32 contiguous. `strides` holds 15 element strides,
// (batch, head, time) of r, k, v, w and out in that order; the last axis of each is
// contiguous. path 0: the chunk kernel, whose copies need r, k, v, w 16-byte aligned with
// strides of whole 16 bytes; path 1: the stream kernel, which needs s0 and s_out 16-byte
// aligned. The caller has checked shapes,
// 1 <= K, V <= 64 and B, H <= 65535. Returns the cudaError_t of the launch (0 on success).
// Does not synchronise.
int repro_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, void* out, void* s_out, const long long* strides, int b, int h,
               long long t_len, int kdim, int vdim, int is_bf16, int path, void* stream) {
  if (b < 0 || h < 0 || t_len < 0 || kdim < 1 || kdim > MAX_K || vdim < 1 || vdim > MAX_V ||
      b > 65535 || h > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || t_len == 0) return 0;
  if (path == 0) {
    const size_t es = is_bf16 ? 2 : 4;
    uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w);
    for (int i = 0; i < 12; ++i) {
      any |= static_cast<uintptr_t>(strides[i] * (i < 9 ? es : 4));
    }
    if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  } else if ((reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s_out)) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  ChunkArgs a;
  a.t_len = t_len;
  a.kdim = kdim;
  a.vdim = vdim;
  a.n_heads = h;
  a.rs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.ws = Strides{strides[9], strides[10], strides[11]};
  a.os = Strides{strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_out);
  if (is_bf16) return run<__nv_bfloat16>(path, r, k, v, wf, u, s0f, out, sf, a, b, st);
  return run<float>(path, r, k, v, wf, u, s0f, out, sf, a, b, st);
}

// Dynamic shared memory of a chunk-kernel block, in bytes (for reports).
int repro_wkv6_shared_bytes(int is_bf16) {
  return (int)(is_bf16 ? sizeof(Shared<__nv_bfloat16>) : sizeof(Shared<float>));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
