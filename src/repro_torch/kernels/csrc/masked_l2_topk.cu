// Fused masked squared-L2 distance + exact top-k, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_kernel` in src/repro/kernels/masked_l2.py
// (launched by `masked_l2_topk_kernel`).  For each query b it returns the k
// lexicographically smallest (dist, id) pairs over the corpus rows whose
// mask byte is set, where dist = max((|q|^2 + |x|^2) - 2 q.x, 0) in fp32.
// The (B, N) distance matrix is never written to device memory.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores):
//   * B=8,   N=2.14M, d=384: the corpus is 3.29 GB, read once -> ~0.98 ms,
//     memory-bound (8 queries give 16 flop per 4 bytes read).
//   * B=256, N=2.14M, d=384: 2*B*N*d = 421 GFLOP -> ~6.3 ms at the fp32
//     CUDA-core rate, compute-bound.
// What the design does about it:
//   * The TPU grid swept the corpus in order with one running top-k per
//     query tile.  Hopper's blocks run in parallel, so the corpus axis is
//     split across blocks (pass 1): each block takes a query tile (8
//     queries, or 1 when B == 1) and one corpus range, and keeps a partial
//     top-k per query.  A second kernel
//     (pass 2) merges each query's `splits * k` partial candidates down to k.
//     At B=8 that keeps every SM streaming instead of one.
//   * The query-tile index is the fastest grid axis, so the blocks that read
//     one corpus range for different query tiles run together and share it
//     through L2: HBM sees the corpus about once even at B=256.
//   * Each thread owns one corpus row of a 256-row tile and all queries of
//     the tile.  It reads its row straight from device memory in 16-byte
//     loads, each feeding 4 FMAs per query (plus 4 for |x|^2); the query
//     values come from shared memory as broadcast reads.  No block barrier
//     sits inside the sweep.  Rows whose mask byte is clear are never read,
//     so a mask that passes a fraction f of the rows moves about f of the
//     corpus.
//   * fp32 FMAs on CUDA cores only (no TF32, no tensor cores), summed over d
//     in index order.  A query's distances therefore do not depend on B or on
//     its position in the batch, and ties break to the lowest id in both
//     passes, as jax.lax.top_k does.  wgmma/TMA are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = THREADS;    // corpus rows per tile, one per thread
constexpr int KMAX = 128;
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;


__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Warp-cooperative insertion of each lane's candidate (cd, ci), where `want`
// is set, into a list (ld, li) of length k in shared memory, sorted
// ascending by (dist, id).  Every lane of the warp must call it.
__device__ void warp_insert(float* ld, int* li, int k, float cd, int ci, bool want) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  want = want && lex_less(cd, ci, ld[k - 1], li[k - 1]);
  while (true) {
    const unsigned m = __ballot_sync(FULL, want);
    if (m == 0) break;
    const int src = __ffs(m) - 1;
    const float vd = __shfl_sync(FULL, cd, src);
    const int vi = __shfl_sync(FULL, ci, src);
    if (lane == src) want = false;
    int pos = 0;  // entries below (vd, vi)
    for (int base = 0; base < k; base += 32) {
      const int s = base + lane;
      const bool below = s < k && lex_less(ld[s], li[s], vd, vi);
      pos += __popc(__ballot_sync(FULL, below));
    }
    if (pos < k) {  // shift the tail right by one and drop the last entry
      float od[KMAX / 32];
      int oi[KMAX / 32];
#pragma unroll
      for (int t = 0; t < KMAX / 32; ++t) {
        const int s = t * 32 + lane;
        if (s < k && s > pos) {
          od[t] = ld[s - 1];
          oi[t] = li[s - 1];
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < KMAX / 32; ++t) {
        const int s = t * 32 + lane;
        if (s < k && s >= pos) {
          ld[s] = s == pos ? vd : od[t];
          li[s] = s == pos ? vi : oi[t];
        }
      }
      __syncwarp();
    }
    want = want && lex_less(cd, ci, ld[k - 1], li[k - 1]);
  }
}

// acc[j] += q[j][i] * xv for the QT queries of the tile (broadcast float4
// reads of the query-minor tile when QT % 4 == 0), and ax2 += xv * xv.
template <int QT>
__device__ __forceinline__ void fma_q(const float* qs, int i, float xv, float* acc,
                                      float& ax2) {
  if constexpr (QT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < QT; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[i * QT + j]);
      acc[j] = fmaf(qv.x, xv, acc[j]);
      acc[j + 1] = fmaf(qv.y, xv, acc[j + 1]);
      acc[j + 2] = fmaf(qv.z, xv, acc[j + 2]);
      acc[j + 3] = fmaf(qv.w, xv, acc[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = fmaf(qs[i * QT + j], xv, acc[j]);
  }
  ax2 = fmaf(xv, xv, ax2);
}

// Pass 1: grid (query tiles, splits).  Writes each query's partial top-k
// over this block's corpus range to part_{d,i}[(b * splits + split) * k].
// Each thread streams its own corpus row straight from device memory
// (16-byte loads when d % 4 == 0; the row's other bytes of each sector are
// read by the thread's next load, out of L1), so the warps need no block
// barrier inside the sweep and hide each other's load latency.  QT is the
// query tile: 8, or 1 for a single query, which then pays no FMAs for
// empty tile slots.  A query's arithmetic is the same in either.
template <int QT, bool VEC4>
__global__ void __launch_bounds__(THREADS, 2) l2_topk_partial(
    const float* __restrict__ q, const float* __restrict__ x,
    const uint8_t* __restrict__ mask, int B, long long N, int d, int k,
    long long rows_per_split, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [d][QT], query-minor
  float* q2s = qs + d * QT;                      // [QT]
  float* ld = q2s + QT;                          // [WARPS][QT][k]
  int* li = reinterpret_cast<int*>(ld + WARPS * QT * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < d * QT; e += THREADS) {
    const int i = e / QT, j = e % QT, b = q0 + j;
    qs[e] = b < B ? q[(long long)b * d + i] : 0.f;
  }
  for (int e = tid; e < WARPS * QT * k; e += THREADS) {
    ld[e] = INFINITY;
    li[e] = EMPTY_ID;
  }
  __syncthreads();
  if (tid < QT) {
    float s = 0.f;
    for (int i = 0; i < d; ++i) {
      const float v = qs[i * QT + tid];
      s = fmaf(v, v, s);
    }
    q2s[tid] = s;
  }
  __syncthreads();

  for (long long t0 = r_begin; t0 < r_end; t0 += TN) {
    const long long row = t0 + tid;
    const bool in_range = row < r_end;
    const bool valid = in_range && mask[row] != 0;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.f;
    float ax2 = 0.f;
    if (valid) {
      if (VEC4) {
        const float4* xr = reinterpret_cast<const float4*>(x + row * d);
#pragma unroll 8
        for (int i4 = 0; i4 < d / 4; ++i4) {
          const float4 xv = __ldg(xr + i4);
          fma_q<QT>(qs, 4 * i4, xv.x, acc, ax2);
          fma_q<QT>(qs, 4 * i4 + 1, xv.y, acc, ax2);
          fma_q<QT>(qs, 4 * i4 + 2, xv.z, acc, ax2);
          fma_q<QT>(qs, 4 * i4 + 3, xv.w, acc, ax2);
        }
      } else {
        const float* xr = x + row * d;
#pragma unroll 8
        for (int i = 0; i < d; ++i) fma_q<QT>(qs, i, __ldg(xr + i), acc, ax2);
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      // explicit roundings: no contraction of the epilogue into an FMA
      const float dist = fmaxf(
          __fsub_rn(__fadd_rn(q2s[j], ax2), __fmul_rn(2.f, acc[j])), 0.f);
      float* wd = ld + (warp * QT + j) * k;
      int* wi = li + (warp * QT + j) * k;
      warp_insert(wd, wi, k, dist, (int)row, valid && q0 + j < B);
    }
  }
  __syncthreads();

  // warp j folds the WARPS per-warp lists of query j into warp 0's list
  for (int j = warp; j < QT; j += WARPS) {
    float* dd = ld + j * k;
    int* di = li + j * k;
    for (int w = 1; w < WARPS; ++w) {
      const float* sd = ld + (w * QT + j) * k;
      const int* si = li + (w * QT + j) * k;
      for (int base = 0; base < k; base += 32) {
        const int s = base + lane;
        const float cd = s < k ? sd[s] : INFINITY;
        const int ci = s < k ? si[s] : EMPTY_ID;
        warp_insert(dd, di, k, cd, ci, s < k && ci != EMPTY_ID);
      }
    }
    __syncwarp();
    const int b = q0 + j;
    if (b < B) {
      const long long off = ((long long)b * n_splits + split) * k;
      for (int s = lane; s < k; s += 32) {
        part_d[off + s] = dd[s];
        part_i[off + s] = di[s];
      }
    }
  }
}

// Pass 2: one block per query merges its n_splits partial lists.
__global__ void __launch_bounds__(THREADS) l2_topk_merge(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    int n_splits, int k, float empty_dist, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* ld = reinterpret_cast<float*>(smem4);  // [WARPS][k]
  int* li = reinterpret_cast<int*>(ld + WARPS * k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  for (int e = tid; e < WARPS * k; e += THREADS) {
    ld[e] = INFINITY;
    li[e] = EMPTY_ID;
  }
  __syncthreads();
  const long long total = (long long)n_splits * k;
  const float* pd = part_d + (long long)b * total;
  const int* pi = part_i + (long long)b * total;
  for (long long base = (long long)warp * 32; base < total; base += WARPS * 32) {
    const long long s = base + lane;
    const bool ok = s < total;
    const float cd = ok ? pd[s] : INFINITY;
    const int ci = ok ? pi[s] : EMPTY_ID;
    warp_insert(ld + warp * k, li + warp * k, k, cd, ci, ok && ci != EMPTY_ID);
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < WARPS; ++w) {
      for (int base = 0; base < k; base += 32) {
        const int s = base + lane;
        const float cd = s < k ? ld[w * k + s] : INFINITY;
        const int ci = s < k ? li[w * k + s] : EMPTY_ID;
        warp_insert(ld, li, k, cd, ci, s < k && ci != EMPTY_ID);
      }
    }
    __syncwarp();
    for (int s = lane; s < k; s += 32) {
      const bool empty = li[s] == EMPTY_ID;
      out_d[(long long)b * k + s] = empty ? empty_dist : ld[s];
      out_i[(long long)b * k + s] = empty ? -1 : li[s];
    }
  }
}

}  // namespace

extern "C" {

// q (B, d) f32, x (N, d) f32, mask (N,) u8, all contiguous on the device.
// qt: the query tile, 1 or 8.  part_{d,i}: (B, n_splits, k) scratch;
// out_{d,i}: (B, k).  Launches both passes on `stream` without
// synchronising; returns cudaGetLastError().
int masked_l2_topk_f32(const void* q, const void* x, const void* mask, int B,
                       long long N, int d, int k, int qt, int n_splits,
                       long long rows_per_split, void* part_d, void* part_i,
                       void* out_d, void* out_i, float empty_dist,
                       void* stream) {
  if (B < 1 || d < 1 || k < 1 || k > KMAX || n_splits < 1 || N < 0 ||
      (qt != 1 && qt != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // pass 1's dynamic shared memory: the query tile, |q|^2, the warp lists
  const size_t smem1 = sizeof(float) * ((size_t)d * qt + qt) +
                       (sizeof(float) + sizeof(int)) * WARPS * qt * k;
  // 16-byte row loads need d % 4 == 0 and a 16-byte aligned corpus
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = qt == 1 ? (vec4 ? l2_topk_partial<1, true> : l2_topk_partial<1, false>)
                        : (vec4 ? l2_topk_partial<8, true> : l2_topk_partial<8, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  const dim3 g1((B + qt - 1) / qt, n_splits);
  kernel<<<g1, THREADS, smem1, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const uint8_t*>(mask), B, N, d, k, rows_per_split,
      static_cast<float*>(part_d), static_cast<int*>(part_i));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = (sizeof(float) + sizeof(int)) * WARPS * k;
  l2_topk_merge<<<B, THREADS, smem2, st>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      n_splits, k, empty_dist, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
