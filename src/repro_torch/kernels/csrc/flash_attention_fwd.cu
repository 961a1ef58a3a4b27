// Flash-attention forward for Hopper (sm_90a), float32 arithmetic on CUDA cores.
//
// Replaces the TPU kernel `_fwd_kernel` in src/repro/kernels/flash_attention.py
// (launched by `_fwd_impl` through `pl.pallas_call`). Same function: online-softmax
// attention with causal and local-window masks on right-aligned query positions
// (qpos = i + Sk - Sq), GQA/MQA through the KV head h / (Hq / Hkv), a value head dim
// that may differ from the key head dim, ragged Sq and Sk masked in the kernel (no
// padding copy), masked logits at -1e30, the sum in float32, the denominator clamped
// at 1e-37, and the output in the input dtype (float32 or bfloat16).
//
// Design. A block owns (batch b, query head h, a tile of BQ query rows) and loops over
// key tiles of BK keys staged in shared memory; the TPU's sequential grid axis is that
// loop. The running max, running sum and the (BQ x Dv) accumulator stay in registers
// for the whole loop and the output is written once. 128 threads: thread (tr, tc) owns
// ROWS query rows ROWS*tr .. ROWS*tr+ROWS-1 and key / value columns tc + 16*j, so a
// row's max and sum are reductions over the 16 lanes of one half-warp (shuffles, no
// shared memory). Q and K tiles are stored with a row stride of D+1 so the 16 lanes of
// a half-warp read 16 different banks. The probabilities P go through shared memory to
// the P.V product. Key tiles wholly above the causal diagonal or wholly outside the
// window of every row of the block are skipped: they contribute exactly 0.
//
// Two tilings. Head dims up to 128 take BQ = BK = 64 (ROWS = 8): at most 8 x 8
// accumulators a thread. Head dims up to 256 take BQ = BK = 32 (ROWS = 4): at Dv = 256
// a thread holds 4 x 16 accumulators, where 8 x 16 would spill, and the float32 tiles
// take (32+32)*257*4 + 32*256*4 + 32*33*4 = 102,784 bytes of shared memory, so two
// blocks fit on an SM (64-row tiles would need 213,760 bytes, one block an SM).
// With MQA (one KV head for 16 query heads) each block stages the same K and V again;
// the 16 reads of a tile come from L2, not memory (not yet shared across heads).
//
// Bound on this card. At the demo's prefill shapes (Hq=12, Hkv=4, D=Dv=64, causal) the
// work is 2*Hq*Sq*Sk*(D+Dv) FLOPs, halved by causality, against
// 4*(Hq*Sq*D + 2*Hkv*Sk*D + Hq*Sq*Dv) bytes: about S/2 FLOPs per byte, far above the
// float32 ridge of an H100 (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte) for S >= 128, so
// the kernel is bound by operations. The float32 path uses FMA on CUDA cores, not TF32
// tensor cores: the reference tolerance is 2e-5 and TF32 keeps about three digits.
// At recurrentgemma-9b's local attention (Hq=16, Hkv=1, D=Dv=256, window 2048, bf16)
// each query sees up to 2048 keys, about 4*2048 FLOPs per byte, so operations bound it
// there too; the bf16 path converts to float32 and also runs FMA on CUDA cores, far
// from the bf16 tensor-core peak (989 TFLOP/s).
// Not yet done (later work): wgmma / TMA, and a bf16 tensor-core path.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROW_GROUPS = THREADS / 16;  // half-warps: each owns ROWS query rows
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
template <typename T, int NV, int ROWS, int BK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int hq, int hkv, int sq, int sk, int d, int dv,
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

  const T* qb = q + ((size_t)b * hq + h) * (size_t)sq * d;
  const T* kb = k + ((size_t)b * hkv + hk) * (size_t)sk * d;
  const T* vb = v + ((size_t)b * hkv + hk) * (size_t)sk * dv;
  T* ob = o + ((size_t)b * hq + h) * (size_t)sq * dv;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    const int qr = q0 + r;
    qs[r * ldqk + c] = qr < sq ? to_f32(qb[(size_t)qr * d + c]) : 0.f;
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
      ks[r * ldqk + c] = kr < sk ? to_f32(kb[(size_t)kr * d + c]) : 0.f;
    }
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV;
      const int c = i - r * LDV;
      const int kr = k0 + r;
      vs[i] = (kr < sk && c < dv) ? to_f32(vb[(size_t)kr * dv + c]) : 0.f;
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
      if (c < dv) store_out(ob + (size_t)qr * dv + c, acc[i][j] / denom);
    }
  }
}

template <typename T, int NV, int ROWS, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int sq,
           int sk, int d, int dv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = ROWS * ROW_GROUPS;
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * 16 * NV +
                                        (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NV, ROWS, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, NV, ROWS, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, sq, sk, d, dv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
              int sq, int sk, int d, int dv, int causal, int window, float scale,
              cudaStream_t stream) {
#define REPRO_LAUNCH(NV, ROWS, BK) \
  launch<T, NV, ROWS, BK>(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, stream)
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

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv), o (B,Hq,Sq,Dv), all contiguous and of
// one dtype (is_bf16: 0 float32, 1 bfloat16). window <= 0 means no window. The caller
// has checked 1 <= D, Dv <= 256, Hq % Hkv == 0 and the grid limits. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b, int hq,
                              int hkv, int sq, int sk, int d, int dv, int causal, int window,
                              float scale, int is_bf16, void* stream) {
  if (d < 1 || d > MAX_D || dv < 1 || dv > MAX_D || hkv < 1 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dv<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, s);
  return launch_dv<float>(q, k, v, o, b, hq, hkv, sq, sk, d, dv, causal, window, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
