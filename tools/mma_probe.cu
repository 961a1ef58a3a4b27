// Throughput of the tensor cores on one card. mma.sync: clock64 cycles a product for a warp
// that issues CHAINS independent accumulations in a loop, at 1 to 16 warps an SM (one block
// an SM). wgmma tf32: cycles an instruction for a warpgroup that issues 2 x 8 k-steps on two
// accumulators, then commits and waits, in a loop, at 1 to 3 warpgroups an SM; operands in
// shared memory in the 128-byte swizzle (or A in registers). Built and run by
// tools/mma_probe.py; not part of the port.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/hopper.cuh"

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

// c (64 x N) += A (64 x 8) B^T (B N x 8), tf32: both from shared memory (SS) or A from
// registers (RS).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %32, %32, %32}, "
      "%33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a), "l"(b));
}

constexpr int WGMMA_SMEM = 1024 + 2 * 64 * 128;  // A and B: 64 rows x 32 tf32, swizzled

// KIND 2: m64n64k8 SS; 3: m64n32k8 SS; 4: m64n64k8 RS. Each loop issues 8 k-steps on each of
// two accumulators (16 instructions), commits and waits.
template <int KIND>
__global__ void wgmma_probe_kernel(float* out, long long* cycles, int iters) {
  constexpr int N = KIND == 3 ? 32 : 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint32_t* words = reinterpret_cast<uint32_t*>(sm);
  for (int i = threadIdx.x; i < 2 * 64 * 32; i += blockDim.x)
    words[i] = (0x3f800000u ^ (i * 2654435761u >> 9)) & 0xffffe000u;  // TF32 values near 1
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a = smem_u32(sm), b = a + 64 * 128;
  const uint32_t ar = words[threadIdx.x % 64];
  float acc[2][N / 2] = {};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint64_t db = sw128_desc(b + (kk & 3) * 32, 16, 1024);
        if constexpr (KIND == 4)
          wgmma_rs64(acc[c], ar, db);
        else
          wgmma_ss<N>(acc[c], sw128_desc(a + (kk & 3) * 32, 16, 1024), db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc[0]);
    pin(acc[1]);
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[0][i] + acc[1][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int KIND>
int launch_wgmma(int blocks, int threads, int iters, void* out, void* cycles, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(wgmma_probe_kernel<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<KIND><<<blocks, threads, WGMMA_SMEM, s>>>(
      static_cast<float*>(out), static_cast<long long*>(cycles), iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs kind (0 mma.sync tf32, 1 mma.sync bf16; wgmma tf32: 2 m64n64k8 SS, 3 m64n32k8 SS,
// 4 m64n64k8 RS, threads a multiple of 128) on `blocks` blocks of `threads`; cycles[blocks]
// gets each block's clock64 span. Returns the cudaError_t of the launch.
int repro_mma_probe(int kind, int blocks, int threads, int iters, void* out, void* cycles,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) return launch_wgmma<2>(blocks, threads, iters, out, cycles, s);
  if (kind == 3) return launch_wgmma<3>(blocks, threads, iters, out, cycles, s);
  if (kind == 4) return launch_wgmma<4>(blocks, threads, iters, out, cycles, s);
  if (kind == 0)
    mma_probe_kernel<0><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                                  static_cast<long long*>(cycles), iters);
  else
    mma_probe_kernel<1><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                                  static_cast<long long*>(cycles), iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
