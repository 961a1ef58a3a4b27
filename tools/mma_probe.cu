// Throughput of mma.sync on one card: clock64 cycles a product for a warp that issues
// CHAINS independent accumulations in a loop, at 1 to 16 warps an SM (one block an SM).
// Built and run by tools/mma_probe.py; not part of the port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %4, %4, %4}, "
      "{%5, %5}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a), "r"(b));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %4, %4, %4}, {%5, %5}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a), "r"(b));
}

// KIND 0: tf32 m16n8k8; 1: bf16 m16n8k16.
template <int KIND>
__global__ void mma_probe_kernel(float* out, long long* cycles, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a = 0x3f800000u ^ threadIdx.x, b = 0x3f000000u ^ (threadIdx.x << 3);
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0)
        mma_tf32(acc[c], a, b);
      else
        mma_bf16(acc[c], a, b);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" {

// Runs kind (0 tf32, 1 bf16) on `blocks` blocks of `threads`; cycles[blocks] gets each block's
// clock64 span. Returns the cudaError_t of the launch.
int repro_mma_probe(int kind, int blocks, int threads, int iters, void* out, void* cycles,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_probe_kernel<0><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                                  static_cast<long long*>(cycles), iters);
  else
    mma_probe_kernel<1><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                                  static_cast<long long*>(cycles), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
