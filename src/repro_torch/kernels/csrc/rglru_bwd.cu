// RG-LRU backward for Hopper (sm_90a): the gradient of the recurrence of rglru_scan.cu, float32.
//
// Replaces the gradient of the TPU kernel `_rglru_kernel` in src/repro/kernels/rglru.py: the
// reference trains the hybrid by autodiff through the plain scan (`rglru_scan_ref`, reached from
// `repro.kernels.ops.rglru` with impl "ref"; the Pallas kernel has no VJP). The forward is
//   h_t = a_t h_{t-1} + b_t x_t,  b_t = sqrt(max(1 - a_t^2, 0)),  h_{-1} = h0 (zeros if none),
// and from the gradients dh_t of every h_t and dS of the final state h_{T-1} the kernels give,
// walking t from T-1 down to 0 with the carried gradient c (c = dS at the start):
//   g_t = dh_t + c;  dx_t = g_t b_t;  da_t = g_t (h_{t-1} - a_t x_t / b_t);  c = a_t g_t;
// and dh0 = c at the end. Each operation is rounded once, in that order, with the
// round-to-nearest intrinsics (no contraction into FMAs), so the kernels give the bits of
// `ref.rglru_bwd_ref` at any batch; no atomics. At a_t = 1 (b_t = 0) da_t is -inf or +inf where
// x_t != 0 and NaN where x_t = 0, and dx_t = 0: the pattern of jax.grad through the reference.
// A scan would re-associate the products and lose those bits, so each channel walks in order.
//
// Bound on this card: bytes. At the hybrid's train shape (1, 4096, 4096), x and dh in bfloat16,
// the gradient moves x, a, dh in and dx, da out, 234.9 MB, 0.0701 ms at 3.35 TB/s. da needs
// h_{t-1} in float32, which the forward writes only in x's dtype, so the backward re-walks the
// states into a float32 scratch (B, T, W) the caller provides, and reads x and a once more:
// ~235 MB more, ~0.14 ms of bytes in all. A channel's step is a chain of two rounded operations
// (~22 cycles on an NVIDIA H100 80GB HBM3 at 700.00 W, rglru_scan.cu), 4096 steps ~50 us: under
// the bytes, if the card keeps ~26 KB an SM in flight (Little's law at ~1 us). One thread a
// channel, 16 loads in flight (~7 KB an SM at W = 4096), ran at 12.9x the bound on that card.
//
// Two launches, each a ring over every SM with the roles of rglru_scan.cu's `rglru_ring_kernel`:
// one block per (batch row, CH = 16 channels), 256 blocks at B = 1, W = 4096, two an SM, whose
// warps meet only at `mbarrier`s of a ring of STAGES stages of TT time steps:
//   - a producer warp fills the ring with 16-byte `cp.async` copies, zero fill past T;
//   - eight preparation warps compute what is off the chain and, LAG stages later, store the
//     stage's results with coalesced 16-byte (8-byte for bfloat16 dx) stores;
//   - one chain half-warp, a lane a channel, walks the steps in order.
// `rglru_bwd_states_kernel` walks forward: the preparation warps compute the gate b_t x_t, the
//   chain h_t = a_t h_{t-1} + gate (the forward's rounding, so rglru_scan.cu's states' bits),
//   written over the gate, and the preparation warps store h_t in float32 into the scratch.
// `rglru_bwd_ring_kernel` walks back from the end of time, its stages holding x, a, dh and
//   h_{t-1} (shifted a row: h0, or zero, before the first): the preparation warps compute b_t
//   and the chain-free factor h_{t-1} - a_t x_t / b_t, the chain only g = dh_t + c and c =
//   a_t g, and the preparation warps dx = g b_t and da = g (factor).
// Their copies need W a multiple of 8 and every operand 16-byte aligned; the wrapper pads W.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CH = 16;  // channels a block, a chain lane each
constexpr int PRODUCER_THREADS = 32;
constexpr int PREP_THREADS = 256;
constexpr int CHAIN_THREADS = CH;
constexpr int RING_THREADS = PRODUCER_THREADS + PREP_THREADS + CHAIN_THREADS;
constexpr int CHAIN_UNROLL = 16;  // steps whose operands the chain loads ahead
// the forward walk: rglru_scan.cu's ring (10 KB a stage in bfloat16)
constexpr int F_TT = 64, F_STAGES = 8, F_LAG = 2;
// the walk back (10 KB a stage in bfloat16, 12 KB in float32)
constexpr int B_TT = 32, B_STAGES = 8, B_LAG = 2;
static_assert(CH % 16 == 0 && (F_TT * CH / 4) % PREP_THREADS == 0 && F_LAG < F_STAGES &&
                  B_LAG < B_STAGES && B_TT % CHAIN_UNROLL == 0 && F_TT % CHAIN_UNROLL == 0,
              "ring shape: CH a multiple of 16, whole quads a preparation thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// sqrt(max(1 - a^2, 0)), each operation rounded once
__device__ __forceinline__ float root(float a) {
  return __fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
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

// 4 consecutive elements from shared memory, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 consecutive elements to global memory, from float32 (16 bytes of float, 8 of bfloat16)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows t0 .. t0 + rows - 1 of a (T, W) operand, channels c0 .. c0 + CH - 1, into a [TT][CH]
// tile by 16-byte copies of producer lane `lane`: past `rows` or W, zeros.
template <int TT, typename T>
__device__ __forceinline__ void copy_rows(T (*dst)[CH], const T* src, long long t0, int rows,
                                          int c0, int w, int lane) {
  constexpr int EL = 16 / (int)sizeof(T);
  constexpr int COPIES = CH / EL;
#pragma unroll 4
  for (int i = lane; i < TT * COPIES; i += PRODUCER_THREADS) {
    const int t = i / COPIES, ch = (i % COPIES) * EL;
    const bool in = t < rows && c0 + ch < w;
    cp_async16(&dst[t][ch], in ? src + (size_t)(t0 + t) * w + c0 + ch : src, in ? 16u : 0u);
  }
}

struct RowArgs {  // offsets are to one batch row: x, a, dh, hs, dx, da (T, W); h0, ... (W)
  int t_len, w, c0, n_chunks;
};

template <int STAGES>
struct Barriers {
  uint64_t full[STAGES];   // copies landed (producer)
  uint64_t ready[STAGES];  // chain-free values written (preparation warps)
  uint64_t done[STAGES];   // the chain's results written (chain)
  uint64_t empty[STAGES];  // results stored (preparation warps)

  __device__ void init() {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), PRODUCER_THREADS);
      mbar_init(smem_u32(&ready[s]), PREP_THREADS);
      mbar_init(smem_u32(&done[s]), CHAIN_THREADS);
      mbar_init(smem_u32(&empty[s]), PREP_THREADS);
    }
  }
};

__device__ __forceinline__ void wait(uint64_t* bar, int k, int stages) {
  mbar_wait(smem_u32(bar), (k / stages) & 1);
}

// ---------------------------------------------------------------------------------------
// the forward walk: h_t in float32 into the scratch
// ---------------------------------------------------------------------------------------

template <typename T>
struct FStage {
  float a[F_TT][CH];
  float g[F_TT][CH];  // b_t x_t, then h_t (the chain writes it over the gate)
  T x[F_TT][CH];
};

template <typename T>
struct FRing {
  FStage<T> stage[F_STAGES];
  Barriers<F_STAGES> bar;
};

template <typename T>
__global__ void __launch_bounds__(RING_THREADS, 1)
    rglru_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ a,
                            const float* __restrict__ h0, float* __restrict__ hs, int t_len, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  FRing<T>& sm = *reinterpret_cast<FRing<T>*>(smem);
  const int tid = threadIdx.x;
  if (tid == 0) sm.bar.init();
  __syncthreads();
  const RowArgs r{t_len, w, (int)blockIdx.x * CH, (t_len + F_TT - 1) / F_TT};
  const size_t row = (size_t)blockIdx.y * t_len * w;
  x += row;
  a += row;
  hs += row;
  if (tid < PRODUCER_THREADS) {
    for (int c = 0; c < r.n_chunks; ++c) {
      const int s = c % F_STAGES;
      if (c >= F_STAGES) wait(&sm.bar.empty[s], c - F_STAGES, F_STAGES);
      const int t0 = c * F_TT, rows = min(F_TT, t_len - t0);
      copy_rows<F_TT>(sm.stage[s].a, a, t0, rows, r.c0, w, tid);
      copy_rows<F_TT>(sm.stage[s].x, x, t0, rows, r.c0, w, tid);
      cp_async_arrive(&sm.bar.full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (tid < PRODUCER_THREADS + PREP_THREADS) {
    const int p = tid - PRODUCER_THREADS;
    constexpr int QUADS = F_TT * CH / 4 / PREP_THREADS;
    for (int c = 0; c < r.n_chunks + F_LAG; ++c) {
      if (c < r.n_chunks) {  // the gate, 4 channels of a step at a time, every load first
        const int s = c % F_STAGES;
        wait(&sm.bar.full[s], c, F_STAGES);
        FStage<T>& st = sm.stage[s];
        float4 av[QUADS], xv[QUADS];
#pragma unroll
        for (int j = 0; j < QUADS; ++j) {
          const int qd = p + j * PREP_THREADS, t = qd / (CH / 4), ch = (qd % (CH / 4)) * 4;
          av[j] = load4(&st.a[t][ch]);
          xv[j] = load4(&st.x[t][ch]);
        }
#pragma unroll
        for (int j = 0; j < QUADS; ++j) {
          const int qd = p + j * PREP_THREADS, t = qd / (CH / 4), ch = (qd % (CH / 4)) * 4;
          *reinterpret_cast<float4*>(&st.g[t][ch]) =
              make_float4(__fmul_rn(root(av[j].x), xv[j].x), __fmul_rn(root(av[j].y), xv[j].y),
                          __fmul_rn(root(av[j].z), xv[j].z), __fmul_rn(root(av[j].w), xv[j].w));
        }
        mbar_arrive(smem_u32(&sm.bar.ready[s]));
      }
      const int cs = c - F_LAG;
      if (cs >= 0) {  // h of stage cs into the scratch
        const int s = cs % F_STAGES;
        wait(&sm.bar.done[s], cs, F_STAGES);
        const FStage<T>& st = sm.stage[s];
        const int t0 = cs * F_TT, rows = min(F_TT, t_len - t0);
#pragma unroll
        for (int i = p; i < F_TT * CH / 4; i += PREP_THREADS) {
          const int t = i / (CH / 4), ch = (i % (CH / 4)) * 4;
          if (t < rows && r.c0 + ch < w) {
            store4(hs + (size_t)(t0 + t) * w + r.c0 + ch, load4(&st.g[t][ch]));
          }
        }
        mbar_arrive(smem_u32(&sm.bar.empty[s]));
      }
    }
  } else {
    const int lane = tid - PRODUCER_THREADS - PREP_THREADS, ch = r.c0 + lane;
    float state = (h0 != nullptr && ch < w) ? h0[(size_t)blockIdx.y * w + ch] : 0.f;
    for (int c = 0; c < r.n_chunks; ++c) {
      const int s = c % F_STAGES;
      wait(&sm.bar.ready[s], c, F_STAGES);
      FStage<T>& st = sm.stage[s];
      const int rows = min(F_TT, t_len - c * F_TT);
      if (rows == F_TT) {
#pragma unroll
        for (int t0 = 0; t0 < F_TT; t0 += CHAIN_UNROLL) {
          float av[CHAIN_UNROLL], gv[CHAIN_UNROLL];
#pragma unroll
          for (int u = 0; u < CHAIN_UNROLL; ++u) {
            av[u] = st.a[t0 + u][lane];
            gv[u] = st.g[t0 + u][lane];
          }
#pragma unroll
          for (int u = 0; u < CHAIN_UNROLL; ++u) {
            state = __fadd_rn(__fmul_rn(av[u], state), gv[u]);
            st.g[t0 + u][lane] = state;
          }
        }
      } else {
        for (int t = 0; t < rows; ++t) {
          state = __fadd_rn(__fmul_rn(st.a[t][lane], state), st.g[t][lane]);
          st.g[t][lane] = state;
        }
      }
      mbar_arrive(smem_u32(&sm.bar.done[s]));
    }
  }
}

// ---------------------------------------------------------------------------------------
// the walk back
// ---------------------------------------------------------------------------------------

template <typename T>
struct BStage {
  float a[B_TT][CH];
  float f[B_TT][CH];   // h_{t-1} as copied in, then h_{t-1} - a_t x_t / b_t
  float bt[B_TT][CH];  // b_t
  float g[B_TT][CH];   // g_t (chain)
  T x[B_TT][CH];
  T dh[B_TT][CH];
};

template <typename T>
struct BRing {
  BStage<T> stage[B_STAGES];
  Barriers<B_STAGES> bar;
};

// Stage k of the walk back holds chunk n_chunks - 1 - k: rows t0 .. t0 + rows - 1.
__device__ __forceinline__ int back_t0(const RowArgs& r, int k) {
  return (r.n_chunks - 1 - k) * B_TT;
}

template <typename T>
__global__ void __launch_bounds__(RING_THREADS, 1)
    rglru_bwd_ring_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ h0, const T* __restrict__ dh,
                          const float* __restrict__ dh_last, const float* __restrict__ hs,
                          T* __restrict__ dx, float* __restrict__ da, float* __restrict__ dh0,
                          int t_len, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  BRing<T>& sm = *reinterpret_cast<BRing<T>*>(smem);
  const int tid = threadIdx.x;
  if (tid == 0) sm.bar.init();
  __syncthreads();
  const RowArgs r{t_len, w, (int)blockIdx.x * CH, (t_len + B_TT - 1) / B_TT};
  const size_t row = (size_t)blockIdx.y * t_len * w;
  x += row;
  a += row;
  dh += row;
  hs += row;
  dx += row;
  da += row;
  if (tid < PRODUCER_THREADS) {
    const float* first = h0 != nullptr ? h0 + (size_t)blockIdx.y * w : nullptr;
    for (int k = 0; k < r.n_chunks; ++k) {
      const int s = k % B_STAGES;
      if (k >= B_STAGES) wait(&sm.bar.empty[s], k - B_STAGES, B_STAGES);
      BStage<T>& st = sm.stage[s];
      const int t0 = back_t0(r, k), rows = min(B_TT, t_len - t0);
      copy_rows<B_TT>(st.a, a, t0, rows, r.c0, w, tid);
      copy_rows<B_TT>(st.x, x, t0, rows, r.c0, w, tid);
      copy_rows<B_TT>(st.dh, dh, t0, rows, r.c0, w, tid);
      if (t0 > 0) {  // h_{t-1}: the scratch's rows t0 - 1 ..
        copy_rows<B_TT>(st.f, hs, t0 - 1, rows, r.c0, w, tid);
      } else {  // .. and before the first step h0 (zeros if none), then rows 0 ..
        copy_rows<B_TT - 1>(&st.f[1], hs, 0, rows - 1, r.c0, w, tid);
        if (tid < CH / 4) {
          const int ch = tid * 4;
          const bool in = first != nullptr && r.c0 + ch < w;
          cp_async16(&st.f[0][ch], in ? first + r.c0 + ch : a, in ? 16u : 0u);
        }
      }
      cp_async_arrive(&sm.bar.full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (tid < PRODUCER_THREADS + PREP_THREADS) {
    const int p = tid - PRODUCER_THREADS;
    constexpr int QUAD_ROWS = PREP_THREADS / (CH / 4);  // a quad a thread at most
    const int qt = p / (CH / 4), qc = (p % (CH / 4)) * 4;
    for (int k = 0; k < r.n_chunks + B_LAG; ++k) {
      if (k < r.n_chunks) {  // b_t and the factor, every load first
        const int s = k % B_STAGES;
        wait(&sm.bar.full[s], k, B_STAGES);
        BStage<T>& st = sm.stage[s];
        if (qt < B_TT) {
          const float4 av = load4(&st.a[qt][qc]), xv = load4(&st.x[qt][qc]);
          const float4 hv = load4(&st.f[qt][qc]);
          const float bv[4] = {root(av.x), root(av.y), root(av.z), root(av.w)};
          const float f[4] = {
              __fsub_rn(hv.x, __fdiv_rn(__fmul_rn(av.x, xv.x), bv[0])),
              __fsub_rn(hv.y, __fdiv_rn(__fmul_rn(av.y, xv.y), bv[1])),
              __fsub_rn(hv.z, __fdiv_rn(__fmul_rn(av.z, xv.z), bv[2])),
              __fsub_rn(hv.w, __fdiv_rn(__fmul_rn(av.w, xv.w), bv[3]))};
          *reinterpret_cast<float4*>(&st.bt[qt][qc]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
          *reinterpret_cast<float4*>(&st.f[qt][qc]) = make_float4(f[0], f[1], f[2], f[3]);
        }
        mbar_arrive(smem_u32(&sm.bar.ready[s]));
      }
      const int ks = k - B_LAG;
      if (ks >= 0) {  // dx and da of stage ks out
        const int s = ks % B_STAGES;
        wait(&sm.bar.done[s], ks, B_STAGES);
        const BStage<T>& st = sm.stage[s];
        const int t0 = back_t0(r, ks), rows = min(B_TT, t_len - t0);
        if (qt < rows && r.c0 + qc < w) {
          const float4 gv = load4(&st.g[qt][qc]), bv = load4(&st.bt[qt][qc]);
          const float4 fv = load4(&st.f[qt][qc]);
          const size_t at = (size_t)(t0 + qt) * w + r.c0 + qc;
          store4(dx + at, make_float4(__fmul_rn(gv.x, bv.x), __fmul_rn(gv.y, bv.y),
                                      __fmul_rn(gv.z, bv.z), __fmul_rn(gv.w, bv.w)));
          store4(da + at, make_float4(__fmul_rn(gv.x, fv.x), __fmul_rn(gv.y, fv.y),
                                      __fmul_rn(gv.z, fv.z), __fmul_rn(gv.w, fv.w)));
        }
        mbar_arrive(smem_u32(&sm.bar.empty[s]));
      }
    }
    static_assert(QUAD_ROWS >= B_TT, "a quad of every stage a preparation thread");
  } else {
    const int lane = tid - PRODUCER_THREADS - PREP_THREADS, ch = r.c0 + lane;
    const size_t at = (size_t)blockIdx.y * w + ch;
    float carry = (dh_last != nullptr && ch < w) ? dh_last[at] : 0.f;
    for (int k = 0; k < r.n_chunks; ++k) {
      const int s = k % B_STAGES;
      wait(&sm.bar.ready[s], k, B_STAGES);
      BStage<T>& st = sm.stage[s];
      const int rows = min(B_TT, t_len - back_t0(r, k));
      if (rows == B_TT) {
#pragma unroll
        for (int t1 = B_TT; t1 > 0; t1 -= CHAIN_UNROLL) {  // steps t1 - 1 down to t1 - 16
          float av[CHAIN_UNROLL], dv[CHAIN_UNROLL];
#pragma unroll
          for (int u = 0; u < CHAIN_UNROLL; ++u) {
            av[u] = st.a[t1 - 1 - u][lane];
            dv[u] = to_f32(st.dh[t1 - 1 - u][lane]);
          }
#pragma unroll
          for (int u = 0; u < CHAIN_UNROLL; ++u) {
            const float g = __fadd_rn(dv[u], carry);
            st.g[t1 - 1 - u][lane] = g;
            carry = __fmul_rn(av[u], g);
          }
        }
      } else {
        for (int t = rows - 1; t >= 0; --t) {
          const float g = __fadd_rn(to_f32(st.dh[t][lane]), carry);
          st.g[t][lane] = g;
          carry = __fmul_rn(st.a[t][lane], g);
        }
      }
      mbar_arrive(smem_u32(&sm.bar.done[s]));
    }
    if (ch < w) dh0[at] = carry;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x, const float* a, const float* h0, const void* dh, const float* dh_last,
           float* hs, void* dx, float* da, float* dh0, int b, int t_len, int w,
           cudaStream_t stream) {
  const dim3 grid((w + CH - 1) / CH, b);
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = set_smem(rglru_bwd_states_kernel<T>, sizeof(FRing<T>));
  if (err != cudaSuccess) return (int)err;
  rglru_bwd_states_kernel<T><<<grid, RING_THREADS, sizeof(FRing<T>), stream>>>(xt, a, h0, hs,
                                                                              t_len, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem(rglru_bwd_ring_kernel<T>, sizeof(BRing<T>));
  if (err != cudaSuccess) return (int)err;
  rglru_bwd_ring_kernel<T><<<grid, RING_THREADS, sizeof(BRing<T>), stream>>>(
      xt, a, h0, static_cast<const T*>(dh), dh_last, hs, static_cast<T*>(dx), da, dh0, t_len, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B,T,W) float32 or bfloat16 (is_bf16), a (B,T,W) float32, h0 (B,W) float32 or null, dh
// (B,T,W) in the dtype of x, dh_last (B,W) float32 or null (no gradient of the final state);
// hs (B,T,W) float32 scratch; writes dx (B,T,W) in the dtype of x, da (B,T,W) float32 and dh0
// (B,W) float32, every element. All contiguous, 16-byte aligned, W a multiple of 8. The caller
// has checked the shapes and B <= 65535. Returns the cudaError_t of the launches (0 on
// success). Does not synchronise.
int repro_rglru_bwd(const void* x, const void* a, const void* h0, const void* dh,
                    const void* dh_last, void* hs, void* dx, void* da, void* dh0, int b, int t_len,
                    int w, int is_bf16, void* stream) {
  if (b < 0 || t_len < 0 || w < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0 || w == 0 || t_len == 0) return 0;
  const void* ptrs[9] = {x, a, h0, dh, dh_last, hs, dx, da, dh0};
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  if (w % 8 != 0 || any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  const float* dlf = static_cast<const float*>(dh_last);
  float* hsf = static_cast<float*>(hs);
  float* daf = static_cast<float*>(da);
  float* d0f = static_cast<float*>(dh0);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, af, h0f, dh, dlf, hsf, dx, daf, d0f, b, t_len, w, s);
  return launch<float>(x, af, h0f, dh, dlf, hsf, dx, daf, d0f, b, t_len, w, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
