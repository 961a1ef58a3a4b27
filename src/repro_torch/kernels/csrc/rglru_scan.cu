// RG-LRU diagonal recurrence for Hopper (sm_90a), float32 state in registers.
//
// Replaces the TPU kernel `_rglru_kernel` in src/repro/kernels/rglru.py (launched by
// `rglru_pallas` through `pl.pallas_call`). Same function:
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t
// with the gate computed in the kernel, the state carried in float32, h written in the
// dtype of x (float32 or bfloat16), the final state written in float32, and an initial
// state when one is given (zeros otherwise).
//
// Design. One thread owns one (batch b, channel c) and loops over time; the TPU's
// sequential grid axis (time chunks carried in VMEM scratch) is that loop, and the
// state never leaves a register. Threads of a block take neighbouring channels, so
// every load of x and a and every store of h is coalesced across the warp. The loop
// loads UNROLL steps of x and a before it uses any of them, which keeps UNROLL loads
// per thread in flight against the memory latency. The W edge is masked (no padding
// copies). Each step rounds as the plain version does (`a*a`, `1-.`, max, sqrt, `*x`,
// `a*h`, `+`), with the round-to-nearest intrinsics so that nvcc does not contract
// them into FMAs: the kernel and `ref.rglru_ref` give the same bits.
//
// Bound on this card. The work is ~6 flops per element against 2 + 4 + 2 bytes
// (bf16 x, f32 a, bf16 h), far below any ridge: bytes bound it, about 100 MB at the
// recurrentgemma-9b prefill shape (1, 3000, 4096), 0.03 ms at 3.35 TB/s. At B*W = 4096
// threads the card is under-filled (64 blocks of 64 threads on 132 SMs) and each thread
// walks T steps in order, so the kernel runs far from that bound; a chunked two-pass
// scan that spreads T over the SMs is later work.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float step(float h, float a, float x) {
  const float g = __fmul_rn(__fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f)), x);
  return __fadd_rn(__fmul_rn(a, h), g);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ h0, T* __restrict__ h, float* __restrict__ h_last,
                      int t_len, int w) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
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
      state = step(state, av[u], xv[u]);
      store_out(h + base + (size_t)(t + u) * w, state);
    }
  }
  for (; t < t_len; ++t) {
    const size_t i = base + (size_t)t * w;
    state = step(state, a[i], to_f32(x[i]));
    store_out(h + i, state);
  }
  h_last[(size_t)b * w + c] = state;
}

}  // namespace

extern "C" {

// x (B,T,W) float32 or bfloat16 (is_bf16), a (B,T,W) float32, h0 (B,W) float32 or null,
// h (B,T,W) in the dtype of x, h_last (B,W) float32; all contiguous. The caller has
// checked the shapes and B <= 65535. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
int repro_rglru_scan(const void* x, const void* a, const void* h0, void* h, void* h_last, int b,
                     int t_len, int w, int is_bf16, void* stream) {
  if (b < 0 || t_len < 0 || w < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0 || w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + THREADS - 1) / THREADS, b);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (is_bf16)
    rglru_scan_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), af, h0f, static_cast<__nv_bfloat16*>(h), hl, t_len,
        w);
  else
    rglru_scan_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x), af, h0f,
                                                      static_cast<float*>(h), hl, t_len, w);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
