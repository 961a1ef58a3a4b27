// RG-LRU backward for Hopper (sm_90a): the gradient of the recurrence of rglru_scan.cu, float32.
//
// Replaces the gradient of the TPU kernel `_rglru_kernel` in src/repro/kernels/rglru.py: the
// reference trains the hybrid by autodiff through the plain scan (`rglru_scan_ref`, reached from
// `repro.kernels.ops.rglru` with impl "ref"; the Pallas kernel has no VJP). The forward is
//   h_t = a_t h_{t-1} + b_t x_t,  b_t = sqrt(max(1 - a_t^2, 0)),  h_{-1} = h0 (zeros if none),
// and from the gradients dh_t of every h_t and dS of the final state h_{T-1} the kernel gives,
// walking t from T-1 down to 0 with the carried gradient c (c = dS at the start):
//   g_t = dh_t + c;  dx_t = g_t b_t;  da_t = g_t (h_{t-1} - a_t x_t / b_t);  c = a_t g_t;
// and dh0 = c at the end. Each operation is rounded once, in that order, with the
// round-to-nearest intrinsics (no contraction into FMAs), so the kernel gives the bits of
// `ref.rglru_bwd_ref` at any batch; no atomics. At a_t = 1 (b_t = 0) da_t is -inf or +inf where
// x_t != 0 and NaN where x_t = 0, and dx_t = 0: the pattern of jax.grad through the reference.
//
// da needs h_{t-1} in float32, and the forward kernels write h only in the dtype of x. The
// backward re-walks them: a first pass runs the forward recurrence from h0 with the forward's
// rounding (the same bits as rglru_scan.cu's state) and writes each h_t into a float32 scratch
// (B, T, W) that the caller provides; the reverse pass reads it. That keeps the forward kernels
// and their launches as they are, at the price of one more read of x and a and a write and a read
// of the scratch (at (1, 4096, 4096) bfloat16: 167.8 MB more than the 234.9 MB the gradient
// itself must move).
//
// One thread a (batch row, channel), blocks of THREADS channels: a channel's steps are a chain
// and only channels run side by side. Each pass loads UNROLL steps of its operands before it
// uses any of them, to keep bytes in flight. Loads are of one element, so any W and any
// alignment are taken as they are (the forward's ring kernel needs W padded to a multiple of 8
// for its 16-byte copies; this one does not).
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// sqrt(max(1 - a^2, 0)), each operation rounded once (rglru_scan.cu's gate without the x)
__device__ __forceinline__ float root(float a) {
  return __fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_bwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ h0, const T* __restrict__ dh,
                     const float* __restrict__ dh_last, float* hs, T* __restrict__ dx,
                     float* __restrict__ da, float* __restrict__ dh0, int t_len, int w) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= w) return;
  const size_t base = (size_t)b * t_len * w + c;
  const float first = h0 != nullptr ? h0[(size_t)b * w + c] : 0.f;

  // forward pass: h_t in float32 into the scratch (this thread reads back what it wrote)
  float state = first;
  int t = 0;
  for (; t + UNROLL <= t_len; t += UNROLL) {
    float xv[UNROLL], av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)(t + u) * w;
      xv[u] = to_f32(x[i]);
      av[u] = a[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), __fmul_rn(root(av[u]), xv[u]));
      hs[base + (size_t)(t + u) * w] = state;
    }
  }
  for (; t < t_len; ++t) {
    const size_t i = base + (size_t)t * w;
    state = __fadd_rn(__fmul_rn(a[i], state), __fmul_rn(root(a[i]), to_f32(x[i])));
    hs[i] = state;
  }

  // reverse pass: the last t_len % UNROLL steps one by one, then UNROLL at a time
  float carry = dh_last != nullptr ? dh_last[(size_t)b * w + c] : 0.f;
  auto step = [&](float xt, float at, float dht, float prev, size_t i) {
    const float g = __fadd_rn(dht, carry);
    const float bt = root(at);
    store_out(dx + i, __fmul_rn(g, bt));
    da[i] = __fmul_rn(g, __fsub_rn(prev, __fdiv_rn(__fmul_rn(at, xt), bt)));
    carry = __fmul_rn(at, g);
  };
  t = t_len - 1;
  for (int r = t_len % UNROLL; r > 0; --r, --t) {
    const size_t i = base + (size_t)t * w;
    step(to_f32(x[i]), a[i], to_f32(dh[i]), t > 0 ? hs[i - w] : first, i);
  }
  for (; t >= 0; t -= UNROLL) {  // steps t, t-1, ..., t-UNROLL+1
    float xv[UNROLL], av[UNROLL], gv[UNROLL], pv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)(t - u) * w;
      xv[u] = to_f32(x[i]);
      av[u] = a[i];
      gv[u] = to_f32(dh[i]);
      pv[u] = t - u > 0 ? hs[i - w] : first;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) step(xv[u], av[u], gv[u], pv[u], base + (size_t)(t - u) * w);
  }
  dh0[(size_t)b * w + c] = carry;
}

template <typename T>
int launch(const void* x, const float* a, const float* h0, const void* dh, const float* dh_last,
           float* hs, void* dx, float* da, float* dh0, int b, int t_len, int w,
           cudaStream_t stream) {
  const dim3 grid((w + THREADS - 1) / THREADS, b);
  rglru_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), a, h0, static_cast<const T*>(dh), dh_last, hs,
      static_cast<T*>(dx), da, dh0, t_len, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B,T,W) float32 or bfloat16 (is_bf16), a (B,T,W) float32, h0 (B,W) float32 or null, dh
// (B,T,W) in the dtype of x, dh_last (B,W) float32 or null (no gradient of the final state);
// hs (B,T,W) float32 scratch; writes dx (B,T,W) in the dtype of x, da (B,T,W) float32 and dh0
// (B,W) float32, every element. All contiguous. The caller has checked the shapes and
// B <= 65535. Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int repro_rglru_bwd(const void* x, const void* a, const void* h0, const void* dh,
                    const void* dh_last, void* hs, void* dx, void* da, void* dh0, int b, int t_len,
                    int w, int is_bf16, void* stream) {
  if (b < 0 || t_len < 0 || w < 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0 || w == 0 || t_len == 0) return 0;
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
