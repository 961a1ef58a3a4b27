// RG-LRU diagonal recurrence for Hopper (sm_90a), float32 state in registers.
//
// Replaces the TPU kernel `_rglru_kernel` in src/repro/kernels/rglru.py (launched by
// `rglru_pallas` through `pl.pallas_call`). Same function:
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t
// with the gate computed in the kernel, the state carried in float32, h written in the
// dtype of x (float32 or bfloat16), the final state written in float32, and an initial
// state when one is given (zeros otherwise). Each step rounds as the plain version does
// (`a*a`, `1-.`, max, sqrt, `*x`, `a*h`, `+`), with the round-to-nearest intrinsics so that
// nvcc does not contract them into FMAs, and each channel walks its steps in order: both
// kernels give the same bits as `ref.rglru_ref`, whatever the batch.
//
// Bound on this card: bytes. ~6 flops an element against 2 + 4 + 2 bytes (bf16 x, f32 a,
// bf16 h): at recurrentgemma-9b's prefill (1, 3000, 4096) that is 98.3 MB, 0.0294 ms at
// 3.35 TB/s. The dependent chain of a channel is one rounded multiply and one rounded add a
// step, ~8 cycles: 3,000 steps take ~13 us, under the byte bound. So a walk in order (no
// scan, which would re-associate the products) can approach the bound, if the card keeps
// enough bytes in flight: ~26 KB an SM at ~1 us of latency (Little's law). One thread a
// channel with 8 loads in flight, the first design, kept ~3 KB an SM in flight on 64 SMs.
//
// Two kernels, picked by the wrapper by T alone (`rglru.path_for`):
//
// `rglru_ring_kernel` (prefill). One block per (batch row, CH = 16 channels): 256 blocks at
// B = 1, W = 4096, two an SM. Its warps meet only at `mbarrier`s of a ring of STAGES = 8
// stages of TT = 64 time steps (10 KB a stage with bf16 x):
//   - a producer warp fills the ring with 16-byte `cp.async` copies of x and a, zero fill
//     past T, and completes a stage's "full" barrier with `cp.async.mbarrier.arrive`; the
//     ring keeps up to ~5 stages of loads in flight;
//   - eight preparation warps turn a full stage's x and a into g = sqrt(max(1 - a^2, 0)) * x
//     in float32, 4 channels of a step at a time with every load issued first (the IEEE
//     sqrt is a chain of dependent instructions), and arrive on "ready"; LAG stages later
//     they copy the stage's h to global memory with coalesced 16-byte stores and arrive on
//     "empty";
//   - one chain half-warp, a lane a channel, keeps the state in a register; a step is two
//     shared loads (a, g), one __fmul_rn, one __fadd_rn and one store of h, in x's dtype,
//     over the stage's x; then it arrives on "done".
// The chain sets the pace: on an H100 a lane's step takes ~22 cycles, not the ~8 of its
// multiply and add. 32 channels a block (128 blocks, one chain an SM) ran 1.3x slower than
// 16, 64 slower again; 4 stages instead of 8 ran 1.2x slower; PERF.md §6 has the timings
// and cycle counts behind these constants.
// Its copies need W a multiple of 8 and x, a, h 16-byte aligned; the wrapper pads W.
//
// `rglru_step_kernel` (short T, decode's T = 1 among them). One thread a (batch row,
// channel) loops over time, loading UNROLL steps of x and a before it uses any of them:
// at T = 1 a ring has nothing to pipeline, and this launch is the cheaper one.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;  // channels a ring block, a chain lane each (the wrapper's RING_CHANNELS)
constexpr int TT = 64;  // time steps a stage
constexpr int STAGES = 8;
constexpr int LAG = 2;  // stages between preparing a stage and storing its h
constexpr int PRODUCER_THREADS = 32;
constexpr int PREP_THREADS = 256;
constexpr int CHAIN_THREADS = CH;
static_assert(CH % 16 == 0 && (TT * CH / 4) % PREP_THREADS == 0 && LAG < STAGES,
              "ring shape: CH a multiple of 16, whole quads a preparation thread");
constexpr int RING_THREADS = PRODUCER_THREADS + PREP_THREADS + CHAIN_THREADS;
constexpr int CHAIN_UNROLL = 16;  // steps whose a and g the chain loads ahead

constexpr int STEP_THREADS = 64;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// sqrt(max(1 - a^2, 0)) * x, each operation rounded once
__device__ __forceinline__ float gated(float a, float x) {
  return __fmul_rn(__fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f)), x);
}

// a * h + g, rounded after the product and after the sum
__device__ __forceinline__ float advance(float h, float a, float g) {
  return __fadd_rn(__fmul_rn(a, h), g);
}

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

// ---------------------------------------------------------------------------------------
// ring kernel
// ---------------------------------------------------------------------------------------

template <typename T>
struct Stage {
  float a[TT][CH];
  float g[TT][CH];  // sqrt(max(1 - a^2, 0)) * x
  T x[TT][CH];      // x as copied in; the chain warp writes h over it
};

template <typename T>
struct Ring {
  Stage<T> stage[STAGES];
  uint64_t full[STAGES];   // x and a landed (producer)
  uint64_t ready[STAGES];  // g written (preparation warps)
  uint64_t done[STAGES];   // h written, a and g read (chain warp)
  uint64_t empty[STAGES];  // h stored (preparation warps)
};

// Offsets below are to one batch row: x, a, h (T, W), h0 and h_last (W).
struct RowArgs {
  int t_len, w, c0, n_chunks;
};

template <typename T>
__device__ void produce(Ring<T>& sm, const T* x, const float* a, const RowArgs& r, int lane) {
  constexpr int A_COPIES = CH * 4 / 16;                  // a row of a: copies of 4
  constexpr int X_EL = 16 / (int)sizeof(T);              // elements of x a copy
  constexpr int X_COPIES = CH / X_EL;                    // a row of x
  for (int c = 0; c < r.n_chunks; ++c) {
    const int s = c % STAGES;
    if (c >= STAGES) mbar_wait(&sm.empty[s], ((c / STAGES) - 1) & 1);
    Stage<T>& st = sm.stage[s];
    const int t0 = c * TT;
    const int rows = min(TT, r.t_len - t0);
#pragma unroll 4
    for (int i = lane; i < TT * A_COPIES; i += PRODUCER_THREADS) {
      const int t = i / A_COPIES, ch = (i % A_COPIES) * 4;
      const bool in = t < rows && r.c0 + ch < r.w;
      const float* src = in ? a + (size_t)(t0 + t) * r.w + r.c0 + ch : a;
      cp_async16(&st.a[t][ch], src, in ? 16 : 0);
    }
#pragma unroll 4
    for (int i = lane; i < TT * X_COPIES; i += PRODUCER_THREADS) {
      const int t = i / X_COPIES, ch = (i % X_COPIES) * X_EL;
      const bool in = t < rows && r.c0 + ch < r.w;
      const T* src = in ? x + (size_t)(t0 + t) * r.w + r.c0 + ch : x;
      cp_async16(&st.x[t][ch], src, in ? 16 : 0);
    }
    cp_async_arrive(&sm.full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 consecutive elements from shared memory, as float32 (16 bytes of float, 8 of bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ void prepare_and_store(Ring<T>& sm, T* h, const RowArgs& r, int p) {
  constexpr int QUADS = TT * CH / 4 / PREP_THREADS;  // 4 channels of a step, 2 a thread at 32
  constexpr int X_EL = 16 / (int)sizeof(T);
  constexpr int X_COPIES = CH / X_EL;
  for (int c = 0; c < r.n_chunks + LAG; ++c) {
    if (c < r.n_chunks) {
      const int s = c % STAGES;
      mbar_wait(&sm.full[s], (c / STAGES) & 1);
      Stage<T>& st = sm.stage[s];
      float4 av[QUADS], xv[QUADS];
#pragma unroll
      for (int j = 0; j < QUADS; ++j) {  // all loads first: the quads' sqrt chains overlap
        const int q = p + j * PREP_THREADS, t = q / (CH / 4), ch = (q % (CH / 4)) * 4;
        av[j] = load4(&st.a[t][ch]);
        xv[j] = load4(&st.x[t][ch]);
      }
#pragma unroll
      for (int j = 0; j < QUADS; ++j) {
        const int q = p + j * PREP_THREADS, t = q / (CH / 4), ch = (q % (CH / 4)) * 4;
        *reinterpret_cast<float4*>(&st.g[t][ch]) =
            make_float4(gated(av[j].x, xv[j].x), gated(av[j].y, xv[j].y),
                        gated(av[j].z, xv[j].z), gated(av[j].w, xv[j].w));
      }
      mbar_arrive(&sm.ready[s]);
    }
    const int cs = c - LAG;
    if (cs >= 0) {
      const int s = cs % STAGES;
      mbar_wait(&sm.done[s], (cs / STAGES) & 1);
      const Stage<T>& st = sm.stage[s];
      const int t0 = cs * TT;
      const int rows = min(TT, r.t_len - t0);
#pragma unroll
      for (int i = p; i < TT * X_COPIES; i += PREP_THREADS) {
        const int t = i / X_COPIES, ch = (i % X_COPIES) * X_EL;
        if (t < rows && r.c0 + ch < r.w) {
          *reinterpret_cast<uint4*>(h + (size_t)(t0 + t) * r.w + r.c0 + ch) =
              *reinterpret_cast<const uint4*>(&st.x[t][ch]);
        }
      }
      mbar_arrive(&sm.empty[s]);
    }
  }
}

template <typename T>
__device__ void walk(Ring<T>& sm, const float* h0, float* h_last, const RowArgs& r, int lane) {
  const int c = r.c0 + lane;
  float state = (h0 != nullptr && c < r.w) ? h0[c] : 0.f;
  for (int k = 0; k < r.n_chunks; ++k) {
    const int s = k % STAGES;
    mbar_wait(&sm.ready[s], (k / STAGES) & 1);
    Stage<T>& st = sm.stage[s];
    const int rows = min(TT, r.t_len - k * TT);
    if (rows == TT) {
#pragma unroll
      for (int t0 = 0; t0 < TT; t0 += CHAIN_UNROLL) {
        float av[CHAIN_UNROLL];
        float gv[CHAIN_UNROLL];
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {
          av[u] = st.a[t0 + u][lane];
          gv[u] = st.g[t0 + u][lane];
        }
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {
          state = advance(state, av[u], gv[u]);
          store_out(&st.x[t0 + u][lane], state);
        }
      }
    } else {
      for (int t = 0; t < rows; ++t) {
        state = advance(state, st.a[t][lane], st.g[t][lane]);
        store_out(&st.x[t][lane], state);
      }
    }
    mbar_arrive(&sm.done[s]);
  }
  if (c < r.w) h_last[c] = state;
}

template <typename T>
__global__ void __launch_bounds__(RING_THREADS, 1)
    rglru_ring_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ h0, T* __restrict__ h,
                      float* __restrict__ h_last, int t_len, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ring<T>& sm = *reinterpret_cast<Ring<T>*>(smem);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], PRODUCER_THREADS);
      mbar_init(&sm.ready[s], PREP_THREADS);
      mbar_init(&sm.done[s], CHAIN_THREADS);
      mbar_init(&sm.empty[s], PREP_THREADS);
    }
  }
  __syncthreads();
  const RowArgs r{t_len, w, (int)blockIdx.x * CH, (t_len + TT - 1) / TT};
  const size_t row = (size_t)b * t_len * w;
  if (tid < PRODUCER_THREADS) {
    produce(sm, x + row, a + row, r, tid);
  } else if (tid < PRODUCER_THREADS + PREP_THREADS) {
    prepare_and_store(sm, h + row, r, tid - PRODUCER_THREADS);
  } else {
    walk(sm, h0 != nullptr ? h0 + (size_t)b * w : nullptr, h_last + (size_t)b * w, r,
         tid - PRODUCER_THREADS - PREP_THREADS);
  }
}

template <typename T>
int launch_ring(const void* x, const float* a, const float* h0, void* h, float* h_last, int b,
                int t_len, int w, cudaStream_t stream) {
  const size_t smem = sizeof(Ring<T>);
  cudaError_t err = cudaFuncSetAttribute(rglru_ring_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + CH - 1) / CH, b);
  rglru_ring_kernel<T><<<grid, RING_THREADS, smem, stream>>>(
      static_cast<const T*>(x), a, h0, static_cast<T*>(h), h_last, t_len, w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------
// step kernel
// ---------------------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
    rglru_step_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ h0, T* __restrict__ h, float* __restrict__ h_last,
                      int t_len, int w) {
  const int c = blockIdx.x * STEP_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= w) return;
  const size_t base = (size_t)b * t_len * w + c;
  float state = h0 != nullptr ? h0[(size_t)b * w + c] : 0.f;
  int t = 0;
  for (; t + UNROLL <= t_len; t += UNROLL) {
    float xv[UNROLL];
    float av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)(t + u) * w;
      xv[u] = to_f32(x[i]);
      av[u] = a[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      state = advance(state, av[u], gated(av[u], xv[u]));
      store_out(h + base + (size_t)(t + u) * w, state);
    }
  }
  for (; t < t_len; ++t) {
    const size_t i = base + (size_t)t * w;
    state = advance(state, a[i], gated(a[i], to_f32(x[i])));
    store_out(h + i, state);
  }
  h_last[(size_t)b * w + c] = state;
}

template <typename T>
int launch_step(const void* x, const float* a, const float* h0, void* h, float* h_last, int b,
                int t_len, int w, cudaStream_t stream) {
  const dim3 grid((w + STEP_THREADS - 1) / STEP_THREADS, b);
  rglru_step_kernel<T><<<grid, STEP_THREADS, 0, stream>>>(
      static_cast<const T*>(x), a, h0, static_cast<T*>(h), h_last, t_len, w);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int path, const void* x, const float* a, const float* h0, void* h, float* h_last, int b,
        int t_len, int w, cudaStream_t stream) {
  if (path == 1) return launch_step<T>(x, a, h0, h, h_last, b, t_len, w, stream);
  return launch_ring<T>(x, a, h0, h, h_last, b, t_len, w, stream);
}

}  // namespace

extern "C" {

// x (B,T,W) float32 or bfloat16 (is_bf16), a (B,T,W) float32, h0 (B,W) float32 or null,
// h (B,T,W) in the dtype of x, h_last (B,W) float32; all contiguous. path 0: the ring
// kernel, which needs W a multiple of 8 and x, a, h 16-byte aligned; path 1: the step
// kernel. The caller has checked the shapes and B <= 65535. Returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
int repro_rglru_scan(const void* x, const void* a, const void* h0, void* h, void* h_last, int b,
                     int t_len, int w, int is_bf16, int path, void* stream) {
  if (b < 0 || t_len < 0 || w < 0 || b > 65535 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || w == 0 || t_len == 0) return 0;
  if (path == 0) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(h);
    if (w % 8 != 0 || any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (is_bf16) return run<__nv_bfloat16>(path, x, af, h0f, h, hl, b, t_len, w, s);
  return run<float>(path, x, af, h0f, h, hl, b, t_len, w, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
