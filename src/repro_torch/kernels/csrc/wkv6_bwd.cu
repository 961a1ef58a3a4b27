// RWKV6 WKV backward for Hopper (sm_90a): the gradient of the chunked WKV of wkv6.cu.
//
// Replaces the gradient of the TPU kernel `_wkv6_kernel` in src/repro/kernels/rwkv6.py: the
// reference trains rwkv6-7b by autodiff through its plain chunked form (`wkv6_chunked_ref`,
// src/repro/kernels/ref.py:145, which `repro.kernels.ops.wkv6` runs off the TPU; the Pallas
// kernel has no VJP). It computes what `ref.wkv6_bwd_ref` computes, whose docstring derives the
// form: chunk 16 in float32, the chunks walked back carrying dS, the gradient of the state at a
// chunk's end (dS_T, or zeros, at the start). Per chunk, with cum the inclusive cumulative sum of
// log w over its rows, excl = cum - log w, last = cum of its last row, r^ = r exp(excl), k^ =
// k exp(-cum), dec = exp(last - cum), kw = k dec, vd[t][s] = dout_t . v_s, S_c the state at the
// chunk's start and, over the strictly lower 16 x 16 tile (s < t):
//   q  = dout S_c^T                       x = q + lower(vd) k^         y = lower(vd)^T r^
//   p  = v dS^T                           att = lower(r^ k^T)          bonus_t = sum_i r u k
//   dr = exp(excl) x + u vd[t][t] k       dk = exp(-cum) y + dec p + u vd[t][t] r
//   dv = att^T dout + bonus dout + kw dS  du += sum_t r k vd[t][t]
//   dlog w_m = sum_{t>m} r^_t q_t + sum_{s<m<t} r^_t k^_s vd[t][s]
//              + exp(last) sum_j dS S_c + sum_{s<m} kw_s p_s,      dw = dlog w / w
//   dS <- exp(last) dS + r^T dout
// Each sum of dlog w holds only terms that depend on log w_m (see the plain version on why).
// Every factor is an exponent of a cumulative sum or of a difference of two, and nothing is
// divided by D_t^2 as autodiff through the reference's k / D_t does: every output is finite over
// the model's clamp log w in [-4, -1e-4]. The factored exponents reach +-64, so the file must
// not be built with --use_fast_math (accurate expf/logf; the 1e-38 floor of w is a subnormal).
//
// Chunk states. The forward kernel keeps no state per chunk, and the backward needs S_c at every
// chunk's start. This kernel re-walks them itself, as rglru_bwd.cu does: a first pass runs the
// state update over the chunks from S_0 and writes each S_c into a float32 scratch (B, H, NC,
// K, V) that the caller provides; the walk back reads it. The forward kernel and its launches
// stay as they are. At rwkv6-7b's train shape (1, 64, 4096, 64) the scratch is 256 chunks x 64
// heads x 16 KB = 268 MB, written once and read once (0.16 ms of bytes at 3.35 TB/s), and the
// first pass reads k, v and w once more.
//
// One block of 256 threads a (batch, head), every product on the float32 CUDA cores from
// shared memory (tiles of 16 rows padded to 65 columns, so that a column read across rows hits
// 32 banks): the right-first form. At the train shape that is 64 blocks on 132 SMs, each
// walking 256 chunks twice in order. The first thing a redesign would change is that
// parallelism: a reverse walk of dS alone (one product a chunk) that writes dS per chunk, then
// every chunk's gradients in parallel, one block a (chunk, head), on the tensor cores.
//
// Order of arithmetic. For one (batch, head) it depends on T, K and V only, never on B, H or
// which blocks share an SM, and there are no atomics: each block writes its du partial over its
// rows, and a second launch adds the partials over the batch in order. Two launches give equal
// bits, and a batch row alone gives the bits of dr, dk, dv, dw and dS_0 that it gives within a
// batch.
//
// Bound on this card at the train shape (1, 64, 4096, 64), r, k, v and dout in bfloat16: the
// bytes the function must move (r, k, v, dout and w read, dr, dk, dv and dw written) are 369.1
// MB, 0.110 ms at 3.35 TB/s; the chunked form's ~12.9 GFLOP are ~0.19 ms on the float32 CUDA
// cores (67 TFLOP/s): bound by operations.
//
// Layout: r, k, v, w, dout and dr, dk, dv, dw are taken by strides (batch, head, time) with the
// last axis contiguous, so the model's (B, T, H, K) memory goes in and comes out without a
// transposing copy; u is (H, K), the states (B, H, K, V), contiguous. Loads are of one element,
// so any alignment is taken.
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;
constexpr int MAX_K = 64;
constexpr int MAX_V = 64;
constexpr int THREADS = 256;
constexpr int ROW = 65;  // padded row of a (chunk, 64) tile and of the 64 x 64 states
constexpr int PER_THREAD = CHUNK * 64 / THREADS;  // (row, column) entries of a tile a thread
constexpr int STATE_ROWS = MAX_K * MAX_V / THREADS;  // state rows a thread, at one column
constexpr int DU_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of a (B, H, T, last) operand; the last axis is contiguous
  long long b, h, t;
};

struct Args {
  long long t_len;
  int kdim, vdim, n_heads, n_chunks;
  Strides rs, ks, vs, ws, gs, drs, dks, dvs, dws;  // r, k, v, w, dout; dr, dk, dv, dw
};

struct Shared {
  float r[CHUNK][ROW], k[CHUNK][ROW], v[CHUNK][ROW], g[CHUNK][ROW], w[CHUNK][ROW];
  float lw[CHUNK][ROW], cum[CHUNK][ROW], ee[CHUNK][ROW], ec[CHUNK][ROW];
  float rh[CHUNK][ROW], kh[CHUNK][ROW], dec[CHUNK][ROW], kw[CHUNK][ROW];
  float q[CHUNK][ROW], x[CHUNK][ROW], y[CHUNK][ROW], p[CHUNK][ROW];
  float vd[CHUNK][CHUNK + 1], att[CHUNK][CHUNK + 1];
  float bonus[CHUNK], dl[MAX_K], u[MAX_K], held[MAX_K];
  float s[MAX_K][ROW], ds[MAX_K][ROW];
};

// Rows t0 .. t0 + 15 of a (T, cols) operand into a tile: past T or cols, `fill`.
template <typename T>
__device__ __forceinline__ void load_tile(float (*dst)[ROW], const T* __restrict__ src,
                                          long long st, long long t0, long long t_len, int cols,
                                          float fill, int tid) {
#pragma unroll
  for (int m = 0; m < PER_THREAD; ++m) {
    const int e = tid + m * THREADS, t = e >> 6, c = e & 63;
    dst[t][c] = (t0 + t < t_len && c < cols) ? to_f32(src[(t0 + t) * st + c]) : fill;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const T* __restrict__ u,
                    const float* __restrict__ s0, const T* __restrict__ dout,
                    const float* __restrict__ ds_last, float* __restrict__ states,
                    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ du_part, float* __restrict__ ds0,
                    Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int kd = a.kdim, vdim = a.vdim;
  r += b * a.rs.b + h * a.rs.h;
  k += b * a.ks.b + h * a.ks.h;
  v += b * a.vs.b + h * a.vs.h;
  w += b * a.ws.b + h * a.ws.h;
  dout += b * a.gs.b + h * a.gs.h;
  dr += b * a.drs.b + h * a.drs.h;
  dk += b * a.dks.b + h * a.dks.h;
  dv += b * a.dvs.b + h * a.dvs.h;
  dw += b * a.dws.b + h * a.dws.h;
  const size_t head = (size_t)b * a.n_heads + h;
  const size_t kv = (size_t)kd * vdim;
  states += head * a.n_chunks * kv;
  // the state entries this thread owns: rows si0 .. si0 + 15 at column sj
  const int sj = tid & 63, si0 = (tid >> 6) * STATE_ROWS;
  if (tid < MAX_K) sm.u[tid] = tid < kd ? to_f32(u[h * kd + tid]) : 0.f;

  // ---- pass 1: the chunk-start states S_c into the scratch ----
  float st[STATE_ROWS];
#pragma unroll
  for (int ii = 0; ii < STATE_ROWS; ++ii) {
    const int i = si0 + ii;
    st[ii] = (s0 != nullptr && i < kd && sj < vdim) ? s0[head * kv + i * vdim + sj] : 0.f;
  }
  for (int c = 0; c < a.n_chunks; ++c) {
    float* out = states + (size_t)c * kv;
#pragma unroll
    for (int ii = 0; ii < STATE_ROWS; ++ii) {
      const int i = si0 + ii;
      if (i < kd && sj < vdim) out[i * vdim + sj] = st[ii];
    }
    if (c + 1 == a.n_chunks) break;  // the final state is not needed
    const long long t0 = (long long)c * CHUNK;
    __syncthreads();  // the previous chunk's readers are done with the tiles
    load_tile(sm.k, k, a.ks.t, t0, a.t_len, kd, 0.f, tid);
    load_tile(sm.v, v, a.vs.t, t0, a.t_len, vdim, 0.f, tid);
    load_tile(sm.w, w, a.ws.t, t0, a.t_len, kd, 1.f, tid);
    __syncthreads();
    if (tid < MAX_K) {
      float acc = 0.f;
      for (int t = 0; t < CHUNK; ++t) {
        acc += logf(fmaxf(sm.w[t][tid], 1e-38f));
        sm.cum[t][tid] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int e = tid + m * THREADS, t = e >> 6, i = e & 63;
      const float last = sm.cum[CHUNK - 1][i];
      sm.kw[t][i] = sm.k[t][i] * expf(last - sm.cum[t][i]);
      if (t == 0) sm.dl[i] = expf(last);
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < STATE_ROWS; ++ii) {
      const int i = si0 + ii;
      float acc = sm.dl[i] * st[ii];
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) acc += sm.kw[s][i] * sm.v[s][sj];
      st[ii] = acc;
    }
  }

  // ---- pass 2: the chunks walked back ----
#pragma unroll
  for (int ii = 0; ii < STATE_ROWS; ++ii) {
    const int i = si0 + ii;
    sm.ds[i][sj] = (ds_last != nullptr && i < kd && sj < vdim) ? ds_last[head * kv + i * vdim + sj]
                                                              : 0.f;
  }
  float du_acc = 0.f;
  const int at = tid >> 4, as = tid & 15;  // this thread's entry of the 16 x 16 tiles
  for (int c = a.n_chunks - 1; c >= 0; --c) {
    const long long t0 = (long long)c * CHUNK;
    __syncthreads();  // the previous chunk's readers are done with the tiles and dS
    load_tile(sm.r, r, a.rs.t, t0, a.t_len, kd, 0.f, tid);
    load_tile(sm.k, k, a.ks.t, t0, a.t_len, kd, 0.f, tid);
    load_tile(sm.v, v, a.vs.t, t0, a.t_len, vdim, 0.f, tid);
    load_tile(sm.g, dout, a.gs.t, t0, a.t_len, vdim, 0.f, tid);
    load_tile(sm.w, w, a.ws.t, t0, a.t_len, kd, 1.f, tid);
    const float* in = states + (size_t)c * kv;
#pragma unroll
    for (int ii = 0; ii < STATE_ROWS; ++ii) {
      const int i = si0 + ii;
      sm.s[i][sj] = (i < kd && sj < vdim) ? in[i * vdim + sj] : 0.f;
    }
    __syncthreads();
    {
      float acc = 0.f;  // vd[t][s] = dout_t . v_s
#pragma unroll 16
      for (int j = 0; j < MAX_V; ++j) acc += sm.g[at][j] * sm.v[as][j];
      sm.vd[at][as] = acc;
    }
    if (tid < MAX_K) {
      float acc = 0.f;
      for (int t = 0; t < CHUNK; ++t) {
        const float lw = logf(fmaxf(sm.w[t][tid], 1e-38f));
        acc += lw;
        sm.lw[t][tid] = lw;
        sm.cum[t][tid] = acc;
      }
    } else if (tid < MAX_K + CHUNK) {
      const int t = tid - MAX_K;
      float acc = 0.f;
      for (int i = 0; i < MAX_K; ++i) acc += sm.r[t][i] * sm.u[i] * sm.k[t][i];
      sm.bonus[t] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int e = tid + m * THREADS, t = e >> 6, i = e & 63;
      const float cum = sm.cum[t][i], last = sm.cum[CHUNK - 1][i];
      const float ee = expf(cum - sm.lw[t][i]), ec = expf(-cum), dec = expf(last - cum);
      sm.ee[t][i] = ee;
      sm.ec[t][i] = ec;
      sm.dec[t][i] = dec;
      sm.rh[t][i] = sm.r[t][i] * ee;
      sm.kh[t][i] = sm.k[t][i] * ec;
      sm.kw[t][i] = sm.k[t][i] * dec;
      if (t == 0) sm.dl[i] = expf(last);
    }
    __syncthreads();
    {
      float acc = 0.f;  // att[t][s] = r^_t . k^_s for s < t
      if (as < at) {
#pragma unroll 16
        for (int i = 0; i < MAX_K; ++i) acc += sm.rh[at][i] * sm.kh[as][i];
      }
      sm.att[at][as] = acc;
    }
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int e = tid + m * THREADS, t = e >> 6, i = e & 63;
      float q = 0.f, p = 0.f;
#pragma unroll 16
      for (int j = 0; j < MAX_V; ++j) {
        q += sm.s[i][j] * sm.g[t][j];
        p += sm.ds[i][j] * sm.v[t][j];
      }
      float x = q, y = 0.f;
      for (int s = 0; s < t; ++s) x += sm.vd[t][s] * sm.kh[s][i];
      for (int s = t + 1; s < CHUNK; ++s) y += sm.vd[s][t] * sm.rh[s][i];
      sm.q[t][i] = q;
      sm.x[t][i] = x;
      sm.y[t][i] = y;
      sm.p[t][i] = p;
    }
    if (tid < MAX_K) {
      float acc = 0.f;  // sum_j dS S_c of row tid, times exp(last)
#pragma unroll 16
      for (int j = 0; j < MAX_V; ++j) acc += sm.ds[tid][j] * sm.s[tid][j];
      sm.held[tid] = sm.dl[tid] * acc;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int e = tid + m * THREADS, t = e >> 6, i = e & 63;
      if (t0 + t < a.t_len && i < kd) {
        const float ukd = sm.u[i] * sm.vd[t][t];
        store_out(dr + (t0 + t) * a.drs.t + i, sm.ee[t][i] * sm.x[t][i] + ukd * sm.k[t][i]);
        store_out(dk + (t0 + t) * a.dks.t + i,
                  sm.ec[t][i] * sm.y[t][i] + sm.dec[t][i] * sm.p[t][i] + ukd * sm.r[t][i]);
      }
    }
#pragma unroll
    for (int m = 0; m < PER_THREAD; ++m) {
      const int e = tid + m * THREADS, s = e >> 6, j = e & 63;
      if (t0 + s < a.t_len && j < vdim) {
        float acc = 0.f;
        for (int t = s + 1; t < CHUNK; ++t) acc += sm.att[t][s] * sm.g[t][j];
        acc += sm.bonus[s] * sm.g[s][j];
        float st_part = 0.f;
#pragma unroll 16
        for (int i = 0; i < MAX_K; ++i) st_part += sm.kw[s][i] * sm.ds[i][j];
        store_out(dv + (t0 + s) * a.dvs.t + j, acc + st_part);
      }
    }
    if (tid < MAX_K) {
      const int i = tid;
      float du_chunk = 0.f;  // the chunk's rows first, then into the walk's sum
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) du_chunk += sm.r[t][i] * sm.k[t][i] * sm.vd[t][t];
      du_acc += du_chunk;
      // dlog w of this channel's rows: the pairs s < m < t, a cumulative sum of kw p before m
      // and a reverse one of r^ q after m, each held apart from the terms they straddle
      float straddle[CHUNK], earlier[CHUNK];
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) straddle[m] = 0.f;
#pragma unroll
      for (int t = 1; t < CHUNK; ++t) {
        const float rt = sm.rh[t][i];
        float run = 0.f;  // sum over s < m of pair (t, s)
#pragma unroll
        for (int m = 0; m < t; ++m) {
          straddle[m] += run;
          run += rt * sm.kh[m][i] * sm.vd[t][m];
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) {
        earlier[m] = acc;
        acc += sm.kw[m][i] * sm.p[m][i];
      }
      const float held = sm.held[i];
      float later = 0.f;
#pragma unroll
      for (int m = CHUNK - 1; m >= 0; --m) {
        if (t0 + m < a.t_len && i < kd) {
          const float dlw = later + straddle[m] + held + earlier[m];
          const float wm = sm.w[m][i];
          dw[(t0 + m) * a.dws.t + i] = wm > 1e-38f ? dlw / wm : 0.f;
        }
        later += sm.rh[m][i] * sm.q[m][i];
      }
    }
    __syncthreads();  // every reader of this chunk's dS is done
#pragma unroll
    for (int ii = 0; ii < STATE_ROWS; ++ii) {
      const int i = si0 + ii;
      float acc = sm.dl[i] * sm.ds[i][sj];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) acc += sm.rh[t][i] * sm.g[t][sj];
      sm.ds[i][sj] = acc;
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int ii = 0; ii < STATE_ROWS; ++ii) {
      const int i = si0 + ii;
      if (i < kd && sj < vdim) ds0[head * kv + i * vdim + sj] = sm.ds[i][sj];
    }
  }
  if (tid < kd) du_part[head * kd + tid] = du_acc;
}

// du (H, K) = the partials (B, H, K) added over the batch in order, in u's dtype.
template <typename T>
__global__ void __launch_bounds__(DU_THREADS)
    wkv6_bwd_du_kernel(const float* __restrict__ du_part, T* __restrict__ du, int b, int n) {
  const int idx = blockIdx.x * DU_THREADS + threadIdx.x;
  if (idx >= n) return;
  float acc = du_part[idx];
  for (int i = 1; i < b; ++i) acc += du_part[(size_t)i * n + idx];
  store_out(du + idx, acc);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const void* u,
           const float* s0, const void* dout, const float* ds_last, float* states, void* dr,
           void* dk, void* dv, float* dw, float* du_part, void* du, float* ds0, const Args& a,
           int b, cudaStream_t stream) {
  const size_t smem = sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<T><<<dim3(a.n_heads, b), THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), s0, static_cast<const T*>(dout), ds_last, states,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, ds0, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = a.n_heads * a.kdim;
  wkv6_bwd_du_kernel<T><<<(n + DU_THREADS - 1) / DU_THREADS, DU_THREADS, 0, stream>>>(
      du_part, static_cast<T*>(du), b, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k (B,H,T,K), v and dout (B,H,T,V), u (H,K, contiguous) float32 or bfloat16 (is_bf16); w
// (B,H,T,K) float32; s0 and ds_last (B,H,K,V) float32 contiguous, or null for zeros; states
// (B,H,ceil(T/16),K,V) float32 scratch. Writes dr, dk (B,H,T,K) and dv (B,H,T,V) in the dtype
// of r, dw (B,H,T,K) float32, du_part (B,H,K) float32 (each (batch, head)'s part), du (H,K) in
// the dtype of r, and ds0 (B,H,K,V) float32 contiguous unless it is null. `strides` holds 27
// element strides, (batch, head, time) of r, k, v, w, dout, dr, dk, dv and dw in that order; the
// last axis of each is contiguous. The caller has checked shapes, 1 <= K, V <= 64 and B, H <=
// 65535. Returns the cudaError_t of the launches (0 on success). Does not synchronise.
int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, const void* dout, const void* ds_last, void* states, void* dr,
                   void* dk, void* dv, void* dw, void* du_part, void* du, void* ds0,
                   const long long* strides, int b, int h, long long t_len, int kdim, int vdim,
                   int is_bf16, void* stream) {
  if (b < 0 || h < 0 || t_len < 0 || kdim < 1 || kdim > MAX_K || vdim < 1 || vdim > MAX_V ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || t_len == 0) return 0;
  Args a;
  a.t_len = t_len;
  a.kdim = kdim;
  a.vdim = vdim;
  a.n_heads = h;
  a.n_chunks = (int)((t_len + CHUNK - 1) / CHUNK);
  Strides* dst[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs, &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int i = 0; i < 9; ++i) *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* s0f = static_cast<const float*>(s0);
  const float* dlf = static_cast<const float*>(ds_last);
  float* sf = static_cast<float*>(states);
  float* dwf = static_cast<float*>(dw);
  float* dpf = static_cast<float*>(du_part);
  float* d0f = static_cast<float*>(ds0);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, wf, u, s0f, dout, dlf, sf, dr, dk, dv, dwf, dpf, du, d0f,
                                 a, b, st);
  return launch<float>(r, k, v, wf, u, s0f, dout, dlf, sf, dr, dk, dv, dwf, dpf, du, d0f, a, b,
                       st);
}

// Dynamic shared memory of a backward block, in bytes (for reports).
int repro_wkv6_bwd_shared_bytes(void) { return (int)sizeof(Shared); }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
