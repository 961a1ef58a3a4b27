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
// In both kinds of cache slot j is valid exactly when j <= pos (a ring of Sc slots is full
// once pos >= Sc - 1); a masked logit's weight exp(-1e30 - max) is exactly 0 in float32, so
// the kernel walks slots 0 .. min(pos, Sc - 1) and never loads the others.
//
// Why a kernel. A slot's result must not depend on the batch it is decoded in: a replayed
// request gives the same tokens only if its logits are the same bits at batch 1 and at
// batch 4. Batched cuBLAS products and PyTorch's softmax pick their reduction order by
// shape, so the plain version's bits for one slot move with B (tools/batch_invariance.py).
// Here every sum has an order fixed by Sc, D and g alone: no atomics, nothing that depends on
// B or on which blocks share an SM.
//
// Design: one launch, `decode_attention_kernel`, a thread-block cluster a (KV head, slot).
//   - The cache is cut into n_split <= 8 splits of `split_keys(Sc)` slots, a function of Sc
//     alone (decode_attention.split_plan); split s is block s of the cluster. A block's
//     eight warps (four for float32 at D > 128) take its slots 8 at a time, in turn (warp w
//     the groups w, w + 8, ..), and each keeps its own online softmax: running max m, sum
//     l and unnormalised O.
//   - The products run on the tensor cores with `mma.sync`, the group's g <= 16 query heads
//     as the 16 rows (rows past g are zeros), so each K and V row is read from shared
//     memory once a block, not once a head:
//       bfloat16: S = Q K^T by m16n8k16 (Q and K by ldmatrix; a bf16 product is exact in
//       float32, only the order of the sum changes); O += P V by m16n8k8 with P split into
//       bfloat16 hi and lo halves, two products (V by ldmatrix.trans), so P keeps about 16
//       bits where the plain version keeps it in float32;
//       float32: both products in 3xTF32 (mma_tf32.cuh): Q split once into hi/lo in shared
//       memory, K and V split as they are read, P split in registers.
//     D a multiple of 8 but not of 16 (bf16) pads the last k-step of Q and K with zeros.
//   - Loads: each warp streams its groups through its own ring of 4 stages (2 where the rows
//     are long) with 16-byte `cp.async` copies, one commit group a group of 8 slots, so
//     the first products start while the rest land; slots past the block's end are
//     zero-filled. A warp waits only for its own copies (`cp.async.wait_group` and
//     `__syncwarp`).
//   - Merge, in a fixed order: the block merges its warps (warp order) in shared
//     memory; then, after a cluster barrier, block r reads every block's (m, l, O) through
//     distributed shared memory, merges them in split order (M = max m, w = exp(m - M),
//     out = sum w O / sum w l) for its 1/n_split of the D columns, and writes them in q's
//     dtype. A second cluster barrier keeps every block's shared memory alive until the
//     others have read it. No workspace, no atomics, no second launch.
//
// Bound on this card. Each valid cache row is read once (K and V), each output written once:
// at recurrentgemma-9b's decode (B = 4, 16 query heads on 1 KV head of 256, a bfloat16 ring of
// 2048) that is at most 8.4 MB, 2.5 us at 3.35 TB/s; the demo's float32 cache (B = 4,
// 12 / 4 heads of 64, 1536 slots) is 8.4 MB at the timed positions. Its 8 splits put 32
// blocks of 256 slots (hybrid) and 128 blocks of 192 slots (demo) on the card; a block's
// chain of dependent steps (a group's copies, S, softmax, P V; the merges and two cluster
// barriers), not the bytes, sets its time (tools/phase_probe.py; PERF.md).
//
// No --use_fast_math: expf must be the accurate one (the plain version's softmax).
//
// Plain C interface, loaded with ctypes; every pointer and the stream are void*.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int GROUP = 8;           // cache slots a warp takes at a time: one n-tile of S
constexpr int MAX_SPLITS = 8;      // blocks a (KV head, slot): one portable cluster
constexpr int MIN_SPLIT_KEYS = 64;
constexpr int MAX_G = 16;          // query heads a KV head: the 16 rows of an mma
constexpr int MAX_D = 256;         // head dim; a multiple of 8
constexpr int MAX_CACHE = 262144;  // cache slots; a block then walks at most 32,768
constexpr unsigned FULL_MASK = 0xffffffffu;

// Slots a split: ceil(Sc / 8) rounded up to whole groups, at least 64. Sc alone.
__host__ __device__ __forceinline__ int split_keys(int sc) {
  const int per = ((sc + MAX_SPLITS - 1) / MAX_SPLITS + GROUP - 1) / GROUP * GROUP;
  return per > MIN_SPLIT_KEYS ? per : MIN_SPLIT_KEYS;
}

__host__ __device__ __forceinline__ int n_splits(int sc) {
  return (sc + split_keys(sc) - 1) / split_keys(sc);
}

// The least count >= n that is r modulo m.
__host__ __device__ __forceinline__ int pad_mod(int n, int m, int r) {
  return n + ((r - n) % m + m) % m;
}

// Warps a block: 8, so that two warps share each sub-partition and one's loads and
// products hide the other's latency; 4 for float32 at D > 128, whose rows leave room for
// no more.
template <typename T, int DT>
__host__ __device__ constexpr int warps() {
  return sizeof(T) == 4 && DT > 16 ? 4 : 8;
}

// Ring stages of a warp: 4, or 2 where the rows are long (bfloat16 D > 128, float32
// D > 64).
template <typename T, int DT>
__host__ __device__ constexpr int stages() {
  return (sizeof(T) == 2 && DT > 16) || (sizeof(T) == 4 && DT > 8) ? 2 : 4;
}

// Shared memory, in bytes. Q first, as the A fragments of its k-steps in lane order, so a
// lane reads each with one conflict-free 16-byte load: bfloat16 4 words a lane a k-step
// of 16 (rows past g and columns past D zero); float32 the hi words, then the lo words, a
// lane a k-step of 8. Then the warps' rings of K and V rows: bfloat16 rows of
// roundup(D, 16) + 8 elements (16 bytes past a multiple of 32: 8 rows read at once hit 8
// bank groups); float32 K rows of 8 (mod 32) floats (a B fragment of S is one 8-byte
// load) and V rows of 4 (mod 32). Once every warp is done with its ring, the partials
// over the same bytes: the warps' O (warps x 16 rows of ldw floats) and (m, l), the
// block's O (16 x D) and (m, l).
template <typename T, int DT>
struct Layout {
  int ldk, ldv, ksteps;  // row strides in elements of T; Q's k-steps
  int ldw;               // a warp's O rows, 8 (mod 32) floats: its 8-byte stores hit 32 banks
  size_t q_bytes, stage_bytes, ring_bytes, wo, wml, bo, bml, total;

  __host__ __device__ explicit Layout(int d) {
    if (sizeof(T) == 2) {
      ldk = ldv = (d + 15) / 16 * 16 + 8;
      ksteps = (d + 15) / 16;
      q_bytes = (size_t)ksteps * 32 * 4 * 4;
    } else {
      ldk = pad_mod(d, 32, 8);
      ldv = pad_mod(d, 32, 4);
      ksteps = d / 8;
      q_bytes = (size_t)ksteps * 32 * 8 * 4;
    }
    stage_bytes = (size_t)GROUP * (ldk + ldv) * sizeof(T);
    ring_bytes = (size_t)warps<T, DT>() * stages<T, DT>() * stage_bytes;
    ldw = pad_mod(d, 32, 8);
    wo = q_bytes;
    wml = wo + (size_t)warps<T, DT>() * MAX_G * ldw * 4;
    bo = wml + (size_t)warps<T, DT>() * MAX_G * 2 * 4;
    bml = bo + (size_t)MAX_G * d * 4;
    const size_t parts = bml + (size_t)MAX_G * 2 * 4;
    total = parts > q_bytes + ring_bytes ? parts : q_bytes + ring_bytes;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x1_t(uint32_t& r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b, bfloat16 operands, float32 sums: m16n8k16 (a 4 registers, b 2) and m16n8k8
// (a 2, b 1). Accumulator fragment as in mma_tf32.cuh: d0 (g, 2q), d1 (g, 2q + 1),
// d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL_MASK, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL_MASK, x, 1);
  return x + __shfl_xor_sync(FULL_MASK, x, 2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// DT: n-tiles of 8 dims a warp holds for O (D <= 8 DT).
template <typename T, int DT>
__global__ void __launch_bounds__(32 * warps<T, DT>())
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ pos_of,
                            T* __restrict__ out, int sc, int kv, int g, int d, float scale) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int STAGES = stages<T, DT>();
  constexpr int WARPS = warps<T, DT>(), THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, DT> L(d);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, qd = lane % 4;
  const int h_all = kv * g, ndt = d / 8;

  // this block's slots, and the valid ones among them: 0 .. pos (see the note above)
  const int keys = split_keys(sc);
  const int j0 = rank * keys;
  const int end = min(min(j0 + keys, sc), pos_of[b] + 1);
  const int n_groups = end > j0 ? (end - j0 + GROUP - 1) / GROUP : 0;
  const int my_groups = n_groups > warp ? (n_groups - warp + WARPS - 1) / WARPS : 0;

  // Q of the group as A fragments (rows past g and columns past D zero): warp w builds
  // the k-steps w, w + WARPS, .. for every lane
  const T* qg = q + ((size_t)b * h_all + (size_t)kvh * g) * d;
  uint32_t* qf = reinterpret_cast<uint32_t*>(smem);
  for (int kk = warp; kk < L.ksteps; kk += WARPS) {
    if constexpr (BF16) {
      // m16n8k16: a0 (row gq, columns 2qd, 2qd + 1), a1 (row gq + 8), a2 (columns + 8), a3;
      // each a pair of bfloat16 read as one word
      auto pair = [&](int row, int col) {
        return row < g && col < d ? *reinterpret_cast<const uint32_t*>(qg + (size_t)row * d + col)
                                  : 0u;
      };
      const int c = 16 * kk + 2 * qd;
      *reinterpret_cast<uint4*>(qf + (kk * 32 + lane) * 4) =
          make_uint4(pair(gq, c), pair(gq + 8, c), pair(gq, c + 8), pair(gq + 8, c + 8));
    } else {
      // m16n8k8 with the k index permuted (k = q <-> column 2q, q + 4 <-> 2q + 1):
      // a0 (gq, 2qd), a1 (gq + 8, 2qd), a2 (gq, 2qd + 1), a3 (gq + 8, 2qd + 1)
      auto pair = [&](int row, int col) {
        return row < g ? *reinterpret_cast<const float2*>(qg + (size_t)row * d + col)
                       : make_float2(0.f, 0.f);
      };
      const int c = 8 * kk + 2 * qd;
      const float2 r0 = pair(gq, c), r1 = pair(gq + 8, c);
      const Tf32x2 a0 = split(r0.x), a1 = split(r1.x), a2 = split(r0.y), a3 = split(r1.y);
      *reinterpret_cast<uint4*>(qf + (kk * 64 + lane) * 4) = make_uint4(a0.hi, a1.hi, a2.hi, a3.hi);
      *reinterpret_cast<uint4*>(qf + (kk * 64 + 32 + lane) * 4) =
          make_uint4(a0.lo, a1.lo, a2.lo, a3.lo);
    }
  }

  // this warp's ring: stage s holds GROUP K rows, then GROUP V rows
  unsigned char* ring = smem + L.q_bytes + (size_t)warp * STAGES * L.stage_bytes;
  auto stage_k = [&](int s) { return reinterpret_cast<T*>(ring + s * L.stage_bytes); };
  auto stage_v = [&](int s) { return stage_k(s) + GROUP * L.ldk; };
  if constexpr (BF16) {  // the pad of the last k-step of K (D a multiple of 8, not of 16)
    if (d % 16 != 0) {
      for (int i = lane; i < STAGES * GROUP; i += 32)
        *reinterpret_cast<uint4*>(stage_k(i / GROUP) + (i % GROUP) * L.ldk + d) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const size_t row_stride = (size_t)kv * d;
  const T* kbase = k + (size_t)b * sc * row_stride + (size_t)kvh * d;
  const T* vbase = v + (size_t)b * sc * row_stride + (size_t)kvh * d;
  const int per_row = d * (int)sizeof(T) / 16, per_copy = 16 / (int)sizeof(T);
  auto issue = [&](int i) {  // the warp's i-th group of slots into stage i % STAGES
    if (i < my_groups) {
      const int key0 = j0 + (warp + i * WARPS) * GROUP;
      T* kd = stage_k(i % STAGES);
      T* vd = stage_v(i % STAGES);
      for (int c = lane; c < GROUP * per_row; c += 32) {
        const int r = c / per_row, e = (c - r * per_row) * per_copy;
        const bool in = key0 + r < end;
        const size_t off = (size_t)(in ? key0 + r : j0) * row_stride + e;
        cp_async16(kd + r * L.ldk + e, kbase + off, in);
        cp_async16(vd + r * L.ldv + e, vbase + off, in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  __syncthreads();  // Q is in shared memory

  float acc[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // rows gq and gq + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's columns of them

  for (int i = 0; i < my_groups; ++i) {
    issue(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const T* kt = stage_k(i % STAGES);
    const T* vt = stage_v(i % STAGES);
    const int key0 = j0 + (warp + i * WARPS) * GROUP;

    // S (16 heads x 8 slots) = Q K^T. A warp issues in order, so no product may wait on
    // the one just before it: four sets of sums take the k-steps in turn (and, in float32,
    // hi*hi and the two corrections go to separate sums).
    float s[4][3][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][c][e] = 0.f;
      }
    }
    if constexpr (BF16) {
      // B of m16n8k16: b0 = slot gq, columns 16kk + 2qd, + 1; b1 = the same + 8
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(kt) + gq * (L.ldk / 2) + qd;
      for (int k0 = 0; k0 < L.ksteps; k0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = k0 + u;
          if (kk < L.ksteps) {
            const uint4 a4 = *reinterpret_cast<const uint4*>(qf + (kk * 32 + lane) * 4);
            const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
            const uint32_t bb[2] = {krow[8 * kk], krow[8 * kk + 4]};
            mma_bf16_k16(s[u][0], a, bb);
          }
        }
      }
    } else {
      // B of m16n8k8: slot gq, columns 8kk + 2qd and + 1 (the permuted k index)
      const float* krow = reinterpret_cast<const float*>(kt) + gq * L.ldk + 2 * qd;
      for (int k0 = 0; k0 < L.ksteps; k0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kk = k0 + u;
          if (kk < L.ksteps) {
            const uint4 ah = *reinterpret_cast<const uint4*>(qf + (kk * 64 + lane) * 4);
            const uint4 al = *reinterpret_cast<const uint4*>(qf + (kk * 64 + 32 + lane) * 4);
            const float2 kk2 = *reinterpret_cast<const float2*>(krow + 8 * kk);
            const Tf32x2 b0 = split(kk2.x), b1 = split(kk2.y);
            mma_tf32(s[u][1], al.x, al.y, al.z, al.w, b0.hi, b1.hi);
            mma_tf32(s[u][2], ah.x, ah.y, ah.z, ah.w, b0.lo, b1.lo);
            mma_tf32(s[u][0], ah.x, ah.y, ah.z, ah.w, b0.hi, b1.hi);
          }
        }
      }
    }

    // online softmax; slots past the block's valid end weigh exactly 0
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float acc_s = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc_s += s[u][0][e] + (BF16 ? 0.f : s[u][1][e] + s[u][2][e]);
      x[e] = acc_s * scale;
      if (key0 + 2 * qd + (e & 1) >= end) x[e] = -INFINITY;
    }
    const float mn0 = fmaxf(m0, quad_max(fmaxf(x[0], x[1])));
    const float mn1 = fmaxf(m1, quad_max(fmaxf(x[2], x[3])));
    const float u0 = mn0 == -INFINITY ? 0.f : mn0, u1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = expf(m0 - u0), al1 = expf(m1 - u1);
    const float p0 = expf(x[0] - u0), p1 = expf(x[1] - u0);
    const float p2 = expf(x[2] - u1), p3 = expf(x[3] - u1);
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * al0 + (p0 + p1);
    l1 = l1 * al1 + (p2 + p3);
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }

    // O += P V
    if constexpr (BF16) {
      // A of m16n8k8 is S's accumulator fragment as it is: a0 = row gq, slots 2qd, 2qd + 1
      const uint32_t h01 = pack_bf16(p0, p1), h23 = pack_bf16(p2, p3);
      const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
      const uint32_t r01 = pack_bf16(p0 - f01.x, p1 - f01.y);
      const uint32_t r23 = pack_bf16(p2 - f23.x, p3 - f23.y);
      const __nv_bfloat16* vrow = reinterpret_cast<const __nv_bfloat16*>(vt) + (lane % 8) * L.ldv;
      // eight n-tiles at a time (two ldmatrix.x4.trans), the lo pass then the hi pass
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += 8) {
        if (n0 < ndt) {
          uint32_t bb[8];
          if (n0 + 8 <= ndt) {
            ldsm_x4_t(bb, vrow + 8 * n0 + (lane / 8) * 8);
            ldsm_x4_t(bb + 4, vrow + 8 * (n0 + 4) + (lane / 8) * 8);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (n0 + u < ndt) ldsm_x1_t(bb[u], vrow + 8 * (n0 + u));
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (n0 + u < ndt) mma_bf16_k8(acc[n0 + u], r01, r23, bb[u]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (n0 + u < ndt) mma_bf16_k8(acc[n0 + u], h01, h23, bb[u]);
        }
      }
    } else {
      // A is S's fragment with the k index permuted as for S (k = q <-> slot 2q, q + 4 <->
      // 2q + 1); B: V rows 2qd and 2qd + 1, column 8nt + gq. Eight n-tiles at a time, three
      // passes.
      const Tf32x2 pa[4] = {split(p0), split(p2), split(p1), split(p3)};
      const float* v0 = reinterpret_cast<const float*>(vt) + (2 * qd) * L.ldv + gq;
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += 8) {
        if (n0 < ndt) {
          Tf32x2 vb[8][2];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (n0 + u < ndt) {
              vb[u][0] = split(v0[8 * (n0 + u)]);
              vb[u][1] = split(v0[L.ldv + 8 * (n0 + u)]);
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (n0 + u < ndt)
              mma_tf32(acc[n0 + u], pa[0].lo, pa[1].lo, pa[2].lo, pa[3].lo, vb[u][0].hi,
                       vb[u][1].hi);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (n0 + u < ndt)
              mma_tf32(acc[n0 + u], pa[0].hi, pa[1].hi, pa[2].hi, pa[3].hi, vb[u][0].lo,
                       vb[u][1].lo);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (n0 + u < ndt)
              mma_tf32(acc[n0 + u], pa[0].hi, pa[1].hi, pa[2].hi, pa[3].hi, vb[u][0].hi,
                       vb[u][1].hi);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // The warps' partials, then the block's (warps merged in order).
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  __syncthreads();  // every warp is done with its ring: the partials reuse its bytes
  float* wo = reinterpret_cast<float*>(smem + L.wo);    // (WARPS, 16, ldw)
  float* wml = reinterpret_cast<float*>(smem + L.wml);  // (WARPS, 16, 2)
  float* bo = reinterpret_cast<float*>(smem + L.bo);    // (16, d)
  float* bml = reinterpret_cast<float*>(smem + L.bml);  // (16, 2)
  {
    float* w0 = wo + ((size_t)warp * MAX_G + gq) * L.ldw;
    float* w1 = w0 + 8 * L.ldw;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      if (nt < ndt) {
        *reinterpret_cast<float2*>(w0 + 8 * nt + 2 * qd) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(w1 + 8 * nt + 2 * qd) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    if (qd == 0) {
      wml[(warp * MAX_G + gq) * 2] = m0;
      wml[(warp * MAX_G + gq) * 2 + 1] = l0;
      wml[(warp * MAX_G + gq + 8) * 2] = m1;
      wml[(warp * MAX_G + gq + 8) * 2 + 1] = l1;
    }
  }
  __shared__ float wgt[MAX_SPLITS > WARPS ? MAX_SPLITS : WARPS][MAX_G];
  __shared__ float inv_l[MAX_G];
  __syncthreads();
  if (tid < g) {  // the warps' weights for head tid, in warp order
    float ms[WARPS], ls[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      ms[w] = wml[(w * MAX_G + tid) * 2];
      ls[w] = wml[(w * MAX_G + tid) * 2 + 1];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w]);
    const float u = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(ms[w] - u);
      wgt[w][tid] = c;
      l += c * ls[w];
    }
    bml[tid * 2] = mx;
    bml[tid * 2 + 1] = l;
  }
  __syncthreads();
  const int quads = d / 4;
  for (int i = tid; i < g * quads; i += THREADS) {  // 4 columns of a head an item
    const int row = i / quads, c = (i - row * quads) * 4;
    float4 x[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      x[w] = *reinterpret_cast<const float4*>(wo + ((size_t)w * MAX_G + row) * L.ldw + c);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c_w = wgt[w][row];
      a.x += c_w * x[w].x;
      a.y += c_w * x[w].y;
      a.z += c_w * x[w].z;
      a.w += c_w * x[w].w;
    }
    *reinterpret_cast<float4*>(bo + row * d + c) = a;
  }

  // The cluster's blocks merged in split order, through distributed shared memory; block r
  // writes columns [r cw, (r + 1) cw) of the group's heads. Every remote value a thread
  // needs is loaded before any is used.
  cluster.sync();
  if (tid < g) {
    float ms[MAX_SPLITS], ls[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < n_split) {
        const float* ml = cluster.map_shared_rank(bml, r);
        ms[r] = ml[tid * 2];
        ls[r] = ml[tid * 2 + 1];
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < n_split) mx = fmaxf(mx, ms[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < n_split) {
        const float c = expf(ms[r] - mx);
        wgt[r][tid] = c;
        l += c * ls[r];
      }
    }
    inv_l[tid] = 1.f / l;
  }
  __syncthreads();
  const int cw = ((d + n_split - 1) / n_split + 3) / 4 * 4, c0 = rank * cw, c1 = min(d, c0 + cw);
  if (c1 > c0) {
    T* og = out + ((size_t)b * h_all + (size_t)kvh * g) * d;
    const int wq = (c1 - c0) / 4;
    for (int i = tid; i < g * wq; i += THREADS) {
      const int row = i / wq, c = c0 + (i - row * wq) * 4;
      float4 x[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < n_split)
          x[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(bo, r) + row * d + c);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < n_split) {
          const float c_r = wgt[r][row];
          a[0] += c_r * x[r].x;
          a[1] += c_r * x[r].y;
          a[2] += c_r * x[r].z;
          a[3] += c_r * x[r].w;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) store_out(og + (size_t)row * d + c + e, a[e] * inv_l[row]);
    }
  }
  cluster.sync();  // the other blocks have read this block's shared memory
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out, int b, int h,
           int kv, int sc, int d, int n_split, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, DT>(d).total;
  auto kernel = decode_attention_kernel<T, DT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, kv, b);
  cfg.blockDim = dim3(32 * warps<T, DT>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), pos, static_cast<T*>(out), sc, kv, h / kv,
                           d, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* pos, void* out, int b,
             int h, int kv, int sc, int d, int n_split, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 8>(q, k, v, pos, out, b, h, kv, sc, d, n_split, scale, stream);
  if (d <= 128) return launch<T, 16>(q, k, v, pos, out, b, h, kv, sc, d, n_split, scale, stream);
  return launch<T, 32>(q, k, v, pos, out, b, h, kv, sc, d, n_split, scale, stream);
}

}  // namespace

extern "C" {

// q (B,H,D), k and v caches (B,Sc,KV,D), out (B,H,D), all contiguous in one dtype, float32 or
// bfloat16 (is_bf16); pos (B,) int32, each slot's position; window > 0 when the cache is a
// ring of that many slots (Sc == window), else 0; n_split the wrapper's split count, which
// must be ceil(Sc / split_keys(Sc)); scale multiplies the logits (the caller's D^-0.5,
// rounded to float32 as the plain version rounds it). The caller has checked the shapes: H a
// multiple of KV with H/KV <= 16, D a multiple of 8 up to 256, B and KV <= 65535,
// Sc <= 262,144. q, k and v must be 16-byte aligned (cudaErrorMisalignedAddress
// otherwise). Returns the cudaError_t of the launch (0 on success). Does not synchronise.
int repro_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                           void* out, int b, int h, int kv, int sc, int d, int window,
                           int n_split, float scale, int is_bf16, void* stream) {
  if (b < 1 || kv < 1 || h < kv || h % kv != 0 || h / kv > MAX_G || sc < 1 || sc > MAX_CACHE ||
      d < 8 || d > MAX_D || d % 8 != 0 || window < 0 || (window > 0 && window != sc) ||
      b > 65535 || kv > 65535 || n_split != n_splits(sc))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, p, out, b, h, kv, sc, d, n_split, scale, s);
  return launch_d<float>(q, k, v, p, out, b, h, kv, sc, d, n_split, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
