// What bounds the two state products of the WKV6 chunk kernel, measured alone on one card.
//
// Per chunk of 16 rows only two products of `wkv6_chunk_kernel` (src/repro_torch/kernels/
// csrc/wkv6.cu) touch the state S (64 keys x 32 columns a block):
//   cross = r^ S                 (16 x 64 times 64 x 32)
//   S'    = diag(D_last) S + kw^T v   (64 x 16 times 16 x 32)
// This file runs each of them in a loop over chunks held in a ring of STAGES stages in shared
// memory, chunk c in stage c % STAGES as in the kernel (no pipeline, no preparation, no global
// traffic), one block an SM, in four forms:
//   FMA    the FMA design: 8 warps, S in registers (8 threads a column, 8 rows each), every
//          operand of r^, kw, v and D_last read from shared memory with float4 reads that a
//          warp's 4 columns share, the cross term reduce-scattered by shuffles;
//   LOADS  the same shared-memory reads of the FMA form and nothing else (volatile loads);
//   FMAS   the same FMAs of the FMA form with every shared operand taken from registers;
//   MMA    the kernel's form: 2 warps, S^T in registers as m16n8k8 accumulators, both products
//          on the tensor cores in 3xTF32 (bfloat16 v, exact in TF32, needs no lo half).
// The clock64 cycles a chunk of each (form, product) tell what the FMA form waits on: its
// loads (FMA close to LOADS, FMAS well below) or its arithmetic. tools/wkv6_state_probe.py
// builds it, runs it and reads the instruction counts of each loop from the SASS.
//
// The values are arbitrary (a hash); nothing is checked but that every result reaches memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;
constexpr int MAX_K = 64;
constexpr int VB = 32;
constexpr int ROW = MAX_K + 8;
constexpr int STAGES = 4;
constexpr int FMA_THREADS = 256;
constexpr int KG = FMA_THREADS / VB;  // FMA form: threads sharing a column
constexpr int R = MAX_K / KG;         // rows each
constexpr int M = R / 4;
constexpr int TP = CHUNK / KG;        // cross rows each after the reduce-scatter
constexpr int MMA_THREADS = 2 * VB;   // MMA form: one warp a 16 columns
constexpr int SMEM_BYTES = 120 * 1024;  // more than half an SM's: one block an SM
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Form { FMA = 0, LOADS = 1, FMAS = 2, MMA = 3 };
enum Product { CROSS = 0, UPDATE = 1 };

struct __align__(16) Stage {
  float rh[CHUNK][ROW];
  float kw[CHUNK][ROW];
  float vf[CHUNK][VB + 8];
  float dlast[MAX_K];
  __nv_bfloat16 v[CHUNK][VB];
};

__device__ __forceinline__ float hashf(uint32_t i) {  // in [-0.5, 0.5)
  return (float)((i * 2654435761u) >> 8) * (1.f / 16777216.f) - 0.5f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load_discard4(const float* p) {
  asm volatile("{\n .reg .f32 a, b, c, d;\n ld.volatile.shared.v4.f32 {a, b, c, d}, [%0];\n}\n" ::
                   "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void load_discard2(const void* p) {
  asm volatile("{\n .reg .b16 a;\n ld.volatile.shared.b16 a, [%0];\n}\n" ::"r"(smem_u32(p))
               : "memory");
}

// ---- FMA, LOADS, FMAS: thread i has column jl = i / KG and rows m 4 KG + 4 kg + (0..3)

template <int F>
__device__ __forceinline__ void fma_cross(const Stage& st, float (&S)[R], const float4 (&xr)[4],
                                          int kg, float& sum) {
  float p[CHUNK];
#pragma unroll
  for (int t = 0; t < CHUNK; ++t) {
    float acc = F == FMAS ? 1e-3f * t : 0.f;  // distinct chains: nothing to share
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* src = &st.rh[t][m * 4 * KG + kg * 4];
      if (F == LOADS) {
        load_discard4(src);
      } else {
        const float4 x = F == FMAS ? xr[(t * M + m) & 3] : *reinterpret_cast<const float4*>(src);
        acc = fmaf(x.x, S[m * 4 + 0], acc);
        acc = fmaf(x.y, S[m * 4 + 1], acc);
        acc = fmaf(x.z, S[m * 4 + 2], acc);
        acc = fmaf(x.w, S[m * 4 + 3], acc);
      }
    }
    p[t] = acc;
  }
  if constexpr (F != LOADS) {
#pragma unroll
    for (int lvl = 1; lvl < KG; lvl *= 2) {  // reduce-scatter over the KG threads of a column
      const int mask = KG / (2 * lvl), half = CHUNK / (2 * lvl);
      const bool up = (kg & mask) != 0;
#pragma unroll
      for (int n = 0; n < half; ++n) {
        const float send = up ? p[n] : p[n + half];
        const float keep = up ? p[n + half] : p[n];
        p[n] = keep + __shfl_xor_sync(FULL_MASK, send, mask);
      }
    }
#pragma unroll
    for (int n = 0; n < TP; ++n) sum += p[n];
    S[0] = fmaf(p[0], 1e-9f, S[0]);  // the next chunk depends on this one
  }
}

template <int F>
__device__ __forceinline__ void fma_update(const Stage& st, float (&S)[R], const float4 (&xr)[4],
                                           const float (&vr)[CHUNK], int kg, int jl) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float* src = &st.dlast[m * 4 * KG + kg * 4];
    if (F == LOADS) {
      load_discard4(src);
    } else {
      const float4 d = F == FMAS ? make_float4(0.9f, 0.9f, 0.9f, 0.9f)
                                 : *reinterpret_cast<const float4*>(src);
      S[m * 4 + 0] *= d.x;
      S[m * 4 + 1] *= d.y;
      S[m * 4 + 2] *= d.z;
      S[m * 4 + 3] *= d.w;
    }
  }
#pragma unroll
  for (int s = 0; s < CHUNK; ++s) {
    float vv = 0.f;
    if (F == LOADS) {
      load_discard2(&st.v[s][jl]);
    } else {
      vv = F == FMAS ? vr[s] : __bfloat162float(st.v[s][jl]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* src = &st.kw[s][m * 4 * KG + kg * 4];
      if (F == LOADS) {
        load_discard4(src);
      } else {
        const float4 x = F == FMAS ? xr[(s * M + m) & 3] : *reinterpret_cast<const float4*>(src);
        S[m * 4 + 0] = fmaf(x.x, vv, S[m * 4 + 0]);
        S[m * 4 + 1] = fmaf(x.y, vv, S[m * 4 + 1]);
        S[m * 4 + 2] = fmaf(x.z, vv, S[m * 4 + 2]);
        S[m * 4 + 3] = fmaf(x.w, vv, S[m * 4 + 3]);
      }
    }
  }
}

// ---- MMA: the chunk kernel's state warps (src/repro_torch/kernels/csrc/wkv6.cu, `advance`)

__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Tf32x2 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32x2 split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_cross(const Stage& st, float (&sr)[MAX_K / 8][4], int g,
                                          int q, float& sum) {
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
  float first = 0.f;
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cx = (cm[tt][0][e] + cc[tt][0][e]) + (cm[tt][1][e] + cc[tt][1][e]);
      sum += cx;
      if (tt == 0 && e == 0) first = cx;
    }
  }
  sr[0][0] = fmaf(first, 1e-9f, sr[0][0]);  // the next chunk depends on this one
}

__device__ __forceinline__ void mma_update(const Stage& st, float (&sr)[MAX_K / 8][4], int g,
                                           int q, int n0) {
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
      const Tf32x2 b0 = split(st.kw[sb * 8 + q][kb * 8 + g]);
      const Tf32x2 b1 = split(st.kw[sb * 8 + q + 4][kb * 8 + g]);
      const Tf32x2(&a)[4] = va[sb];
      mma_tf32(sr[kb], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
      mma_tf32(sr[kb], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
    }
  }
}

template <int F, int P>
__global__ void __launch_bounds__(FMA_THREADS, 1)
    wkv6_state_probe_kernel(int n_chunks, float* __restrict__ sink, long long* __restrict__ cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int tid = threadIdx.x;
  for (int s = 0; s < STAGES; ++s) {
    Stage& st = ring[s];
    const uint32_t o = s * 7;
    for (int i = tid; i < CHUNK * ROW; i += blockDim.x) {
      (&st.rh[0][0])[i] = hashf(i + o);
      (&st.kw[0][0])[i] = hashf(i + o + 7919);
    }
    for (int i = tid; i < CHUNK * (VB + 8); i += blockDim.x) {
      (&st.vf[0][0])[i] = hashf(i + o + 104729);
    }
    for (int i = tid; i < CHUNK * VB; i += blockDim.x) {
      (&st.v[0][0])[i] = __float2bfloat16(hashf(i + o + 1299709));
    }
    for (int i = tid; i < MAX_K; i += blockDim.x) {
      st.dlast[i] = 0.9f + 0.1f * hashf(i + o + 15485863);
    }
  }
  __syncthreads();

  float sum = 0.f, tail = 0.f;
  long long c0 = 0;
  if (F == MMA) {
    const int lane = tid % 32, g = lane / 4, q = lane % 4, n0 = (tid / 32) * 16;
    float sr[MAX_K / 8][4];
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sr[kb][e] = hashf(tid * 32 + kb * 4 + e);
    }
    __syncthreads();
    c0 = clock64();
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      const Stage& st = ring[c % STAGES];
      if (P == CROSS) {
        mma_cross(st, sr, g, q, sum);
      } else {
        mma_update(st, sr, g, q, n0);
      }
    }
#pragma unroll
    for (int kb = 0; kb < MAX_K / 8; ++kb) tail += (sr[kb][0] + sr[kb][1]) + (sr[kb][2] + sr[kb][3]);
  } else {
    const int kg = tid % KG, jl = tid / KG;
    float S[R], vr[CHUNK];
    float4 xr[4];
#pragma unroll
    for (int i = 0; i < R; ++i) S[i] = hashf(tid * R + i);
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) vr[s] = __bfloat162float(ring[0].v[s][jl]);
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = *reinterpret_cast<const float4*>(&ring[0].rh[i][kg * 4]);
    __syncthreads();
    c0 = clock64();
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      const Stage& st = ring[c % STAGES];
      if (P == CROSS) {
        fma_cross<F>(st, S, xr, kg, sum);
      } else {
        fma_update<F>(st, S, xr, vr, kg, jl);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) tail += S[i];
  }
  __syncthreads();
  const long long c1 = clock64();
  if (tid == 0) cycles[blockIdx.x] = c1 - c0;
  sink[blockIdx.x * FMA_THREADS + tid] = sum + tail;
}

template <int F, int P>
int launch(int n_chunks, int blocks, float* sink, long long* cycles, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wkv6_state_probe_kernel<F, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int threads = F == MMA ? MMA_THREADS : FMA_THREADS;
  wkv6_state_probe_kernel<F, P><<<blocks, threads, SMEM_BYTES, stream>>>(n_chunks, sink, cycles);
  return (int)cudaGetLastError();
}

template <int F>
int launch_product(int product, int n_chunks, int blocks, float* sink, long long* cycles,
                   cudaStream_t stream) {
  if (product == CROSS) return launch<F, CROSS>(n_chunks, blocks, sink, cycles, stream);
  return launch<F, UPDATE>(n_chunks, blocks, sink, cycles, stream);
}

}  // namespace

extern "C" {

// form 0 FMA, 1 LOADS, 2 FMAS, 3 MMA; product 0 the cross term, 1 the state update. One block
// an SM for `blocks` SMs, each running `n_chunks` chunks; sink holds blocks * 256 floats,
// cycles `blocks` int64 (clock64 cycles of each block's loop). Returns the cudaError_t of the
// launch; does not synchronise.
int wkv6_state_probe(int form, int product, int n_chunks, int blocks, void* sink, void* cycles,
                     void* stream) {
  if (form < 0 || form > 3 || product < 0 || product > 1 || n_chunks < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(sink);
  long long* c = static_cast<long long*>(cycles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case FMA: return launch_product<FMA>(product, n_chunks, blocks, s, c, st);
    case LOADS: return launch_product<LOADS>(product, n_chunks, blocks, s, c, st);
    case FMAS: return launch_product<FMAS>(product, n_chunks, blocks, s, c, st);
    default: return launch_product<MMA>(product, n_chunks, blocks, s, c, st);
  }
}

const char* wkv6_state_probe_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
