// RWKV6 WKV recurrence (data-dependent decay, K x V state per head) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv6_kernel` in src/repro/kernels/rwkv6.py (launched by
// `wkv6_pallas` through `pl.pallas_call`). Same function, the chunked form with chunk 16 in
// float32 and the state carried across chunks on chip. Per chunk of c <= 16 rows:
//   logw = log(max(w, 1e-38)),  cum = cumsum_t(logw)
//   r^ = r * exp(cum - logw),  k^ = k / max(exp(cum), 1e-30)
//   out = r^ S  +  strict_lower(r^ k^T) v  +  (sum_k r u k) v
//   S'  = diag(exp(cum_last)) S  +  sum_s exp(cum_last - cum_s) k_s v_s^T
// Inputs r, k, v in float32 or bfloat16, w and the state in float32, u in float32 or the
// dtype of r; the output in the dtype of r, the final state in float32. The reference pads T
// to the chunk with r = k = 0, w = 1, which changes no output row and not the state; here a
// last chunk of c < 16 rows runs the same arithmetic on its c rows, so decode (T = 1) costs
// one row, not sixteen.
//
// Design. The TPU kernel's grid is (B, H, T/chunk) with the chunk axis sequential and S in
// VMEM. Here one block of 256 threads owns one (batch, head) and 16 columns of S (grid
// (V/16, H, B): 256 blocks at rwkv6-7b's prefill shape, where (B, H) alone would fill 64 of
// 132 SMs); the columns of S and of the output are independent, so the blocks never talk.
// The block walks the chunks in order with its slice of S in shared memory. Each chunk takes
// five phases separated by barriers: load (r, k, log w; v of the block's columns), the
// cumulative sum along the chunk (one thread a key channel), the factored r^, k^ and the
// state-update weights, then thread (t, j) forms row t of the attention tile, cross and
// bonus terms, and last the output element (t, j) and the state rows j's thread owns. Tiles
// of K columns are padded to 65 floats a row so that the column walks hit 32 banks.
//
// Layout: r, k, v, w and out are taken by strides (batch, head, time) with the last axis
// contiguous, so the model's (B, T, H, K) projections go in as they are, without a
// transposing copy; u is (H, K) and the states (B, H, K, V), contiguous.
//
// Range. The factored exponents reach |4 * 15| = 60 within a chunk (the model clamps
// log w to [-4, -1e-4]), inside float32's range, but only with accurate expf/logf: the file
// must not be built with --use_fast_math (whose __expf loses relative accuracy at large
// arguments and which flushes the 1e-38 floor, a subnormal, to zero).
//
// Bound on this card, at the prefill shape (1, 64, 3000, 64) with r, k, v in bfloat16: the
// bytes (r, k, v bf16, w f32, out bf16) are ~148 MB, 0.044 ms at 3.35 TB/s; the chunked form's
// ~4.0 GFLOP are 0.059 ms on the float32 CUDA cores. This kernel runs float32 FMAs on CUDA
// cores with a barrier every phase, so it sits well above that; tensor cores, TMA and a
// longer pipeline belong to the kernel's redesign.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CHUNK = 16;
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int VB = 16;                   // state columns a block owns
constexpr int THREADS = CHUNK * VB;      // thread (t, j) = (tid / VB, tid % VB)
constexpr int ROW = MAX_K + 1;           // padded row of a (chunk, K) tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of a (B, H, T, last) operand; the last axis is contiguous
  long long b, h, t;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const T* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ s_out,
                Strides rs, Strides ks, Strides vs, Strides ws, Strides os, int n_heads,
                int t_len, int kdim, int vdim) {
  __shared__ float r_s[CHUNK][ROW], k_s[CHUNK][ROW], lw_s[CHUNK][ROW], cum_s[CHUNK][ROW];
  __shared__ float rh_s[CHUNK][ROW], kh_s[CHUNK][ROW], kw_s[CHUNK][ROW];
  __shared__ float v_s[CHUNK][VB];
  __shared__ float att_s[CHUNK][CHUNK + 1];
  __shared__ float S[MAX_K][VB];
  __shared__ float u_s[MAX_K], dlast_s[MAX_K];

  const int j0 = blockIdx.x * VB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ti = tid / VB;
  const int tj = tid % VB;
  const int vb = min(VB, vdim - j0);  // columns of S this block owns

  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h + j0;
  const float* wp = w + b * ws.b + h * ws.h;
  T* op = out + b * os.b + h * os.h + j0;
  const size_t state_base = ((size_t)b * n_heads + h) * kdim * vdim + j0;

  for (int i = tid; i < kdim; i += THREADS) {
    u_s[i] = to_f32(u[h * kdim + i]);
  }
  for (int i = tid; i < kdim * VB; i += THREADS) {
    const int kk = i / VB, jj = i % VB;
    S[kk][jj] = (s0 != nullptr && jj < vb) ? s0[state_base + (size_t)kk * vdim + jj] : 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += CHUNK) {
    const int c = min(CHUNK, t_len - t0);

    // 1. load the chunk: r, k, log w (c x K) and v (c x this block's columns)
    for (int i = tid; i < c * kdim; i += THREADS) {
      const int t = i / kdim, kk = i % kdim;
      const long long row = (long long)(t0 + t);
      r_s[t][kk] = to_f32(rp[row * rs.t + kk]);
      k_s[t][kk] = to_f32(kp[row * ks.t + kk]);
      lw_s[t][kk] = logf(fmaxf(wp[row * ws.t + kk], 1e-38f));
    }
    v_s[ti][tj] = (ti < c && tj < vb) ? to_f32(vp[(long long)(t0 + ti) * vs.t + tj]) : 0.f;
    __syncthreads();

    // 2. cumulative log decay along the chunk, one thread a key channel
    if (tid < kdim) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        acc += lw_s[t][tid];
        cum_s[t][tid] = acc;
      }
      dlast_s[tid] = expf(acc);
    }
    __syncthreads();

    // 3. r^ = r D_{t-1}, k^ = k / D_t, and the state-update weights k_s D_last / D_s
    for (int i = tid; i < c * kdim; i += THREADS) {
      const int t = i / kdim, kk = i % kdim;
      const float cum = cum_s[t][kk];
      rh_s[t][kk] = r_s[t][kk] * expf(cum - lw_s[t][kk]);
      kh_s[t][kk] = k_s[t][kk] / fmaxf(expf(cum), 1e-30f);
      kw_s[t][kk] = k_s[t][kk] * expf(cum_s[c - 1][kk] - cum);
    }
    __syncthreads();

    // 4. thread (ti, tj): attention entry (ti, s = tj), cross term (ti, tj), bonus of row ti
    float cross = 0.f, bonus = 0.f;
    if (ti < c) {
      float a = 0.f;
      if (tj < ti) {
        for (int kk = 0; kk < kdim; ++kk) a += rh_s[ti][kk] * kh_s[tj][kk];
      }
      att_s[ti][tj] = a;
      for (int kk = 0; kk < kdim; ++kk) {
        cross += rh_s[ti][kk] * S[kk][tj];
        bonus += (r_s[ti][kk] * u_s[kk]) * k_s[ti][kk];
      }
    }
    __syncthreads();

    // 5. output (ti, tj); the state rows kk = ti, ti + 16, ... of column tj
    if (ti < c && tj < vb) {
      float intra = 0.f;
      for (int s = 0; s < ti; ++s) intra += att_s[ti][s] * v_s[s][tj];
      store_out(op + (long long)(t0 + ti) * os.t + tj, cross + intra + bonus * v_s[ti][tj]);
    }
    for (int kk = ti; kk < kdim; kk += CHUNK) {
      float acc = 0.f;
      for (int s = 0; s < c; ++s) acc += kw_s[s][kk] * v_s[s][tj];
      S[kk][tj] = dlast_s[kk] * S[kk][tj] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < kdim * VB; i += THREADS) {
    const int kk = i / VB, jj = i % VB;
    if (jj < vb) s_out[state_base + (size_t)kk * vdim + jj] = S[kk][jj];
  }
}

}  // namespace

extern "C" {

// r, k (B,H,T,K), v (B,H,T,V) and u (H,K, contiguous) float32 or bfloat16 (is_bf16); w
// (B,H,T,K) float32; s0 (B,H,K,V) float32 contiguous, or null for zeros; out (B,H,T,V) in
// the dtype of r; s_out (B,H,K,V) float32 contiguous. `strides` holds 15 element strides,
// (batch, head, time) of r, k, v, w and out in that order; the last axis of each is
// contiguous. The caller has checked shapes, 1 <= K, V <= 64 and
// B, H <= 65535. Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int repro_wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, void* out, void* s_out, const long long* strides, int b, int h,
               int t_len, int kdim, int vdim, int is_bf16, void* stream) {
  if (b < 0 || h < 0 || t_len < 0 || kdim < 1 || kdim > MAX_K || vdim < 1 || vdim > MAX_V ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides ws{strides[9], strides[10], strides[11]};
  const Strides os{strides[12], strides[13], strides[14]};
  const dim3 grid((vdim + VB - 1) / VB, h, b);
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_out);
  if (is_bf16) {
    using T = __nv_bfloat16;
    wkv6_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), wf,
        static_cast<const T*>(u), s0f, static_cast<T*>(out), sf, rs, ks, vs, ws, os, h, t_len,
        kdim, vdim);
  } else {
    wkv6_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
        wf, static_cast<const float*>(u), s0f, static_cast<float*>(out), sf, rs, ks, vs, ws, os,
        h, t_len, kdim, vdim);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
