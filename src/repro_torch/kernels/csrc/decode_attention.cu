// Cached-decode attention for Hopper (sm_90a): one query token a slot against its KV cache,
// with a reduction order that does not depend on the batch.
//
// No TPU kernel: the reference computes this step in plain jnp (src/repro/models/attention.py,
// the cached-decode branch of `gqa_attention`); the port's plain version is
// `ref.decode_attention_ref`. Same function:
//   logits[h, j] = (q[h] . k[j, h // g]) * D^-0.5         (float32)
//   masked to -1e30 where key slot j is not valid for the slot's position pos:
//     linear cache (window 0):         j <= pos
//     ring of `window` slots (Sc = window): (pos - j) mod window < min(pos + 1, window)
//   out[h] = softmax_j(logits[h]) . v[j, h // g]        (float32, written in q's dtype)
// with q (B, H, D), the caches (B, Sc, KV, D) in q's dtype (float32 or bfloat16) and g = H/KV.
//
// Why a kernel. A slot's result must not depend on the batch it is decoded in: a replayed
// request gives the same tokens only if its logits are the same bits at batch 1 and at
// batch 4. Batched cuBLAS products and PyTorch's softmax pick their reduction order by
// shape, so the plain version's bits for one slot move with B (tools/batch_invariance.py).
// Here every sum has an order fixed by Sc, D and g alone: no atomics, nothing that depends on
// B or on which blocks share an SM.
//
// Design. Two launches.
//   1. `decode_attention_split_kernel`: one block per (key split, KV head, slot). A split is
//      KEYS = 64 consecutive cache slots, so the split count is ceil(Sc / 64), Sc's alone.
//      The block copies its K and V rows to shared memory with 16-byte `cp.async` copies
//      (coalesced, rows padded by 16 bytes so that 8 rows read at once hit 8 bank groups),
//      its g query rows in float32 beside them, then: the g x 64 logits (one thread a key
//      and a quarter of the heads, a sequential sum over D), the split's max m and
//      sum l = sum exp(logit - m) a head (warp butterflies, a fixed order), and the
//      unnormalised o = sum exp(logit - m) v (one thread 4 dims of a head, keys in order).
//      A split with no valid key writes l = 0 and nothing else.
//   2. `decode_attention_combine_kernel`: one block per (head, slot) merges the splits in
//      split order: M = max m, L = sum exp(m - M) l, out = sum exp(m - M) o / L, a thread
//      a dim, the splits' weights in shared memory.
// The partials (B, H, splits) of (m, l) and of o (D floats) live in a float32 workspace
// that the wrapper allocates.
//
// Bound on this card. Each valid cache row is read once (K and V), each output written once:
// at recurrentgemma-9b's decode (B = 4, 16 query heads on 1 KV head of 256, a bfloat16 ring of
// 2048) that is 8.4 MB, 2.5 us at 3.35 TB/s; its 134 MFLOP of float32 FMAs are 2.0 us at
// 67 TFLOP/s. The demo's float32 cache (B = 4, 12 / 4 heads of 64, 1536 slots) is at most
// 12.6 MB, 3.8 us. Splits of 64 keys put 128 blocks on the card at the hybrid's shape.
//
// No --use_fast_math: expf must be the accurate one (the plain version's softmax).
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KEYS = 64;  // cache slots a split
constexpr int SPLIT_THREADS = 256;
constexpr int HEAD_GROUPS = SPLIT_THREADS / KEYS;  // logits: a key's heads over 4 threads
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_G = 16;   // query heads a KV head
constexpr int HEADS_A_THREAD = MAX_G / HEAD_GROUPS;  // logits: heads hq, hq + 4, .. a thread
constexpr int MAX_SPLITS = 4096;  // Sc <= 262,144: the combine's weights in shared memory
constexpr int MAX_D = 256;  // head dim; a multiple of 8
constexpr float MASKED = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 4 consecutive elements from shared memory, as float32 (16 bytes of float, 8 of bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Key slot j of a cache holding position pos (window 0: linear; else a ring of `window`).
__device__ __forceinline__ bool key_valid(int j, int pos, int window) {
  if (window > 0) {
    int age = (pos - j) % window;
    if (age < 0) age += window;
    return age < min(pos + 1, window);
  }
  return j <= pos;
}

template <typename T>
__device__ __forceinline__ int padded_row(int d) {  // elements a K or V row in shared memory
  return d + 16 / (int)sizeof(T);
}

template <typename T>
size_t split_shared_bytes(int g, int d) {
  const size_t row = (size_t)(d + 16 / sizeof(T)) * sizeof(T);
  return (size_t)g * d * 4 + 2 * KEYS * row + (size_t)g * KEYS * 4;
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
    decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const int* __restrict__ pos_of,
                                  float* __restrict__ part_o, float* __restrict__ part_ml,
                                  int sc, int kv, int g, int d, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, h_all = kv * g;
  const int tid = threadIdx.x;
  const int j0 = split * KEYS;
  const int n = min(KEYS, sc - j0);
  const int pos = pos_of[b];
  // the partials of the group's first head; head hh's are n_split further on each
  const size_t part0 = ((size_t)b * h_all + (size_t)kvh * g) * n_split + split;

  const bool mine = tid < n && key_valid(j0 + tid, pos, window);
  if (!__syncthreads_or(mine)) {  // no valid key: the combine skips this split
    if (tid < g) part_ml[(part0 + (size_t)tid * n_split) * 2 + 1] = 0.f;
    return;
  }

  const int rs = padded_row<T>(d);
  float* q_s = reinterpret_cast<float*>(smem);                 // (g, d)
  T* k_s = reinterpret_cast<T*>(q_s + g * d);                  // (KEYS, rs)
  T* v_s = k_s + KEYS * rs;                                    // (KEYS, rs)
  float* p_s = reinterpret_cast<float*>(v_s + KEYS * rs);      // (g, KEYS)

  // K and V rows of the split: 16-byte copies, each row d * sizeof(T) / 16 of them
  const int per_row = d * (int)sizeof(T) / 16;
  const int per_copy = 16 / (int)sizeof(T);
  const size_t row_stride = (size_t)kv * d;
  const T* k0 = k + ((size_t)b * sc + j0) * row_stride + (size_t)kvh * d;
  const T* v0 = v + ((size_t)b * sc + j0) * row_stride + (size_t)kvh * d;
  for (int i = tid; i < n * per_row; i += SPLIT_THREADS) {
    const int j = i / per_row, c = (i % per_row) * per_copy;
    cp_async16(k_s + j * rs + c, k0 + j * row_stride + c);
    cp_async16(v_s + j * rs + c, v0 + j * row_stride + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const T* qg = q + ((size_t)b * h_all + (size_t)kvh * g) * d;
  for (int i = tid; i < g * d; i += SPLIT_THREADS) q_s[i] = to_f32(qg[i]);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // logits: thread (key jj, head group hq) takes heads hq, hq + 4, ..; each sums over D in
  // order, the key's row loaded once for its heads
  {
    const int jj = tid % KEYS, hq = tid / KEYS;
    if (jj < n) {
      const bool valid = key_valid(j0 + jj, pos, window);
      const T* krow = k_s + jj * rs;
      float acc[HEADS_A_THREAD];
#pragma unroll
      for (int u = 0; u < HEADS_A_THREAD; ++u) acc[u] = 0.f;
#pragma unroll 2
      for (int e = 0; e < d; e += 4) {
        const float4 kk = load4(krow + e);
#pragma unroll
        for (int u = 0; u < HEADS_A_THREAD; ++u) {
          const int hh = hq + u * HEAD_GROUPS;
          if (hh < g) {
            const float4 qq = load4(q_s + hh * d + e);
            acc[u] = fmaf(qq.x, kk.x, acc[u]);
            acc[u] = fmaf(qq.y, kk.y, acc[u]);
            acc[u] = fmaf(qq.z, kk.z, acc[u]);
            acc[u] = fmaf(qq.w, kk.w, acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HEADS_A_THREAD; ++u) {
        const int hh = hq + u * HEAD_GROUPS;
        if (hh < g) p_s[hh * KEYS + jj] = valid ? acc[u] * scale : MASKED;
      }
    }
  }
  __syncthreads();

  // per head: the split's max and sum of exponentials (warp w takes heads w, w + 8)
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int hh = warp; hh < g; hh += SPLIT_THREADS / 32) {
      float* row = p_s + hh * KEYS;
      const float x0 = lane < n ? row[lane] : -INFINITY;
      const float x1 = lane + 32 < n ? row[lane + 32] : -INFINITY;
      float m = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o >= 1; o /= 2) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
      const float e0 = lane < n ? expf(x0 - m) : 0.f;
      const float e1 = lane + 32 < n ? expf(x1 - m) : 0.f;
      if (lane < n) row[lane] = e0;
      if (lane + 32 < n) row[lane + 32] = e1;
      float l = e0 + e1;
#pragma unroll
      for (int o = 16; o >= 1; o /= 2) l += __shfl_xor_sync(FULL_MASK, l, o);
      if (lane == 0) {
        float* ml = part_ml + (part0 + (size_t)hh * n_split) * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
  }
  __syncthreads();

  // o = sum_j exp(logit_j - m) v_j: thread (head hh, dims 4c .. 4c + 3), keys in order
  const int quads = d / 4;
  for (int i = tid; i < g * quads; i += SPLIT_THREADS) {
    const int hh = i / quads, c = (i % quads) * 4;
    const float* p = p_s + hh * KEYS;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int jj = 0; jj < n; ++jj) {
      const float w = p[jj];
      const float4 vv = load4(v_s + jj * rs + c);
      acc.x = fmaf(w, vv.x, acc.x);
      acc.y = fmaf(w, vv.y, acc.y);
      acc.z = fmaf(w, vv.z, acc.z);
      acc.w = fmaf(w, vv.w, acc.w);
    }
    *reinterpret_cast<float4*>(part_o + (part0 + (size_t)hh * n_split) * d + c) = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    decode_attention_combine_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml, T* __restrict__ out,
                                    int n_split, int h_all, int d) {
  __shared__ float wgt[MAX_SPLITS];  // exp(m_s - M), 0 for a split with no valid key
  __shared__ float lsum[MAX_SPLITS];
  __shared__ float red[COMBINE_THREADS / 32];
  __shared__ float l_all;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t part0 = ((size_t)b * h_all + h) * n_split;
  const float* ml = part_ml + part0 * 2;
  float m_all = -INFINITY;  // the max is exact in any order
  for (int s = tid; s < n_split; s += COMBINE_THREADS) {
    const float l = ml[2 * s + 1];
    lsum[s] = l;
    if (l > 0.f) m_all = fmaxf(m_all, ml[2 * s]);
  }
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) m_all = fmaxf(m_all, __shfl_xor_sync(FULL_MASK, m_all, o));
  if (tid % 32 == 0) red[tid / 32] = m_all;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < COMBINE_THREADS / 32; ++i) m_all = fmaxf(m_all, red[i]);
  for (int s = tid; s < n_split; s += COMBINE_THREADS) {
    wgt[s] = lsum[s] > 0.f ? expf(ml[2 * s] - m_all) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {  // L = sum_s exp(m_s - M) l_s, in split order
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) l += wgt[s] * lsum[s];
    l_all = l;
  }
  __syncthreads();
  for (int e = tid; e < d; e += COMBINE_THREADS) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float w = wgt[s];
      if (w != 0.f) acc += w * part_o[(part0 + s) * d + e];
    }
    store_out(out + ((size_t)b * h_all + h) * d + e, acc / l_all);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           float* workspace, int b, int h, int kv, int sc, int d, int window, int n_split,
           float scale, cudaStream_t stream) {
  const int g = h / kv;
  const size_t smem = split_shared_bytes<T>(g, d);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* part_o = workspace;
  float* part_ml = workspace + (size_t)b * h * n_split * d;
  decode_attention_split_kernel<T><<<dim3(n_split, kv, b), SPLIT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, part_o,
      part_ml, sc, kv, g, d, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine_kernel<T><<<dim3(h, b), COMBINE_THREADS, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), n_split, h, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,D), k and v caches (B,Sc,KV,D), out (B,H,D), all contiguous in one dtype, float32 or
// bfloat16 (is_bf16); pos (B,) int32, each slot's position; window > 0 when the cache is a
// ring of that many slots (Sc == window), else 0; workspace float32 of at least
// B*H*n_split*(D + 2) elements, n_split = ceil(Sc / 64); scale multiplies the logits (the
// caller's D^-0.5, rounded to float32 as the plain version rounds it). The caller has
// checked the shapes: H a multiple of KV with H/KV <= 16, D a multiple of 8 up to 256, B and
// KV <= 65535, Sc <= 262,144. q, k and v must be 16-byte aligned (cudaErrorMisalignedAddress
// otherwise). Returns the cudaError_t of the launches (0 on success). Does not synchronise.
int repro_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                           void* out, void* workspace, int b, int h, int kv, int sc, int d,
                           int window, int n_split, float scale, int is_bf16, void* stream) {
  if (b < 1 || kv < 1 || h < kv || h % kv != 0 || h / kv > MAX_G || sc < 1 || d < 8 ||
      d > MAX_D || d % 8 != 0 || window < 0 || (window > 0 && window != sc) || b > 65535 ||
      kv > 65535 || n_split != (sc + KEYS - 1) / KEYS || n_split > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* ws = static_cast<float*>(workspace);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, p, out, ws, b, h, kv, sc, d, window, n_split, scale,
                                 s);
  return launch<float>(q, k, v, p, out, ws, b, h, kv, sc, d, window, n_split, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
