// Fused masked squared-L2 distance + exact top-k, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_kernel` in src/repro/kernels/masked_l2.py
// (launched by `masked_l2_topk_kernel`).  For each query b it returns the k
// lexicographically smallest (dist, id) pairs over the corpus rows whose
// mask byte is set, where dist = max((|q|^2 + |x|^2) - 2 q.x, 0) in fp32.
// The (B, N) distance matrix is never written to device memory.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
// tensor cores), counting only the rows that pass the mask:
//   * B = 1 and 8 (the main path's query() and small batches): bytes.  Each
//     passing row is 4 d bytes for 2 B d flop, so below B ~ 10 the corpus
//     read bounds it: 0.49 ms at N = 2.14M, d = 384, half the rows passing.
//   * B >= 64: fp32 operations.  2 B d flop a passing row: 0.80 ms at
//     B = 64 and 3.15 ms at B = 256 over the same rows.
// The previous version of this file (one design for every B) took, by CUDA
// events at N = 2.14M, half passing, k = 10 [H100 80GB HBM3, 700.00 W]:
// 0.8619 ms at B = 1, 1.1308 at B = 8, 6.8201 at B = 64 and 32.4572 at
// B = 256, where the port's l2_topk (matmul + torch.topk) took 28.2170.
//
// Two paths, chosen by the wrapper's `plan` from (B, N, d, k) and the SM
// count only, never from the data.  A (query, row) distance is the same
// bits on both, at every B, tile and split: |q|^2, |x|^2 and q.x are fmaf
// chains over d in index order, and the epilogue rounds explicitly.  So a
// query's answer does not depend on the batch it came in.
//
// Streaming path (B < 32; QT = 1 or 8 queries a block):
//   * Each thread owns one corpus row of a 256-row tile and streams it from
//     device memory in 16-byte loads; the QT query values come from shared
//     memory as broadcast reads.  No block barrier inside the sweep, so the
//     warps hide each other's load latency; the byte bound is what counts.
//   * Each warp keeps a sorted per-query list and inserts every row of its
//     tile (ballot + compare with the list's tail).
//
// Tiled path (B >= 32; QT = 64 queries a block, or 32 when B < 64 or the
// lists of k do not fit beside 64):
//   1. The query tile stays in shared memory ([d][QT], query-minor) for the
//      whole sweep, |q|^2 computed once.  The block (512 threads) sweeps its
//      corpus split in tiles of TT = 256 passing rows, staged in shared
//      memory in chunks of KC = 32 columns through a 2-stage ring of 16-byte
//      cp.async copies: chunk c + 1 (of this tile or the next) is in flight
//      while chunk c is computed, one block barrier a chunk.
//   2. Masked rows are never read.  Before a tile is needed the block scans
//      the next stretch of the split's mask bytes (ballot + popc prefix
//      sums) into a ring of passing row ids and takes the next TT of them in
//      ascending order; the copies fetch those rows by id (each row chunk is
//      128 contiguous bytes).  No library call, no torch.nonzero.
//   3. Each thread accumulates a register micro-tile of QT/16 queries x 8
//      rows: per 4 columns, 8 float4 row reads and QT/16 broadcast float4
//      query reads feed 32 QT/16 FMAs, the next half-tile's reads issued
//      before this half's FMAs.  A warp holds 8 query groups x 4 rows, and a
//      staged row is padded to 36 floats, so its 16-byte reads are
//      conflict-free.  Threads 0..255 keep |x|^2 of one row each.
//   4. Threshold-filtered selection.  Each query keeps its sorted (dist, id)
//      list of length k in shared memory; its k-th key is the threshold tau.
//      After a tile, a thread reserves room for its candidates that are
//      lex_less than tau in the query's buffer of CAND = 64 entries (one
//      atomicAdd per thread and query) and writes them; one warp per query
//      then merges the buffer into the list and tau falls: up to 8 entries
//      by warp_insert, more by a warp bitonic sort of the buffer and a
//      merge by rank (binary search in the other array).  A
//      candidate that finds the buffer full stays pending for another round
//      of the same tile, filtered by the new tau.  The result is the k
//      smallest keys of a total order, so it does not depend on the order
//      of the atomics, and a final member is never filtered out (tau only
//      falls).  Ties go to the lowest id.
//   5. Grid: (query tiles, splits), the query-tile index fastest, so the
//      blocks that read one split run together and share it through L2.
//      One block per SM (~213 KB of shared memory at QT = 64, k = 10), at
//      most one wave.
// It runs the fp32 pipe at about half its peak at B = 256; the chunk
// barrier, the copy waits and the selection each cost a few per cent
// (PERF.md).  3xTF32 tensor-core products are the next lever.
//
// Both paths write each (query, split) list to scratch; pass 2 merges each
// query's `splits * k` partial candidates down to k.  fp32 FMAs on CUDA
// cores only: no TF32, no tensor cores.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = THREADS;    // streaming: corpus rows per tile, one per thread
constexpr int KMAX = 128;
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// tiled path
constexpr int TTHREADS = 512;        // threads a block
constexpr int TWARPS = TTHREADS / 32;
constexpr int QG = 16;               // query groups: thread (tq, tr) of QG x RG
constexpr int RG = TTHREADS / QG;    // row groups
constexpr int MR = 8;                // rows per thread's micro-tile
constexpr int TT = RG * MR;          // passing rows per tile
constexpr int KC = 32;               // columns per staged chunk
constexpr int XS = KC + 4;           // padded row stride of a staged chunk, in floats
constexpr int STAGES = 2;            // chunks in the copy ring
constexpr int CAND = 64;             // candidate buffer entries per query (warp_merge sorts 64)
constexpr int SMALL_MERGE = 8;       // buffers up to this size merge by warp_insert
static_assert(KC % 8 == 0 && MR % 2 == 0, "the micro-tile steps 8 columns, half its rows a time");
constexpr int RING = 2 * TTHREADS;   // passing row ids scanned ahead (>= TT - 1 + TTHREADS)


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

// Number of entries of the sorted list (ld, li)[0, n) that are lex_less
// than (xd, xi), or, with `or_equal`, not greater.
__device__ __forceinline__ int rank_in(const float* ld, const int* li, int n, float xd, int xi,
                                       bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool below = or_equal ? !lex_less(xd, xi, ld[mid], li[mid])
                                : lex_less(ld[mid], li[mid], xd, xi);
    if (below) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Bitonic sort, ascending by (dist, id), of the 64 keys a warp holds two a
// lane (key lane + 32 u in register u).
__device__ void warp_sort64(float (&kd)[2], int (&ki)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {   // pairs (lane, lane + 32): both registers of a lane, ascending
        if (lex_less(kd[1], ki[1], kd[0], ki[0])) {
          const float td = kd[0]; kd[0] = kd[1]; kd[1] = td;
          const int ti = ki[0]; ki[0] = ki[1]; ki[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = lane + 32 * u;
        const float pd = __shfl_xor_sync(FULL, kd[u], stride);
        const int pi = __shfl_xor_sync(FULL, ki[u], stride);
        const bool up = (i & size) == 0, lower = (i & stride) == 0;
        const bool mine_less = lex_less(kd[u], ki[u], pd, pi);
        if (lower == up ? !mine_less : mine_less) {
          kd[u] = pd;
          ki[u] = pi;
        }
      }
    }
  }
}

// Merges a buffer of c <= 64 candidates (bd, bi), in any order, into the
// sorted list (ld, li) of length k: the list becomes the k smallest keys of
// both.  The buffer is sorted in registers (warp_sort64) and written back
// sorted; each key's place in the merged order is its index plus its rank
// in the other array (list keys first on a tie, which only empty slots
// share), found by binary search.  Every lane of the warp must call it.
__device__ void warp_merge(float* ld, int* li, int k, float* bd, int* bi, int c) {
  const int lane = threadIdx.x & 31;
  float kd[2];
  int ki[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = lane + 32 * u;
    kd[u] = s < c ? bd[s] : INFINITY;
    ki[u] = s < c ? bi[s] : EMPTY_ID;
  }
  warp_sort64(kd, ki);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    bd[lane + 32 * u] = kd[u];
    bi[lane + 32 * u] = ki[u];
  }
  __syncwarp();
  int rb[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) rb[u] = lane + 32 * u + rank_in(ld, li, k, kd[u], ki[u], true);
  float od[KMAX / 32];
  int oi[KMAX / 32], ra[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int a = lane + 32 * t;
    ra[t] = KMAX;
    if (a < k) {
      od[t] = ld[a];
      oi[t] = li[a];
      ra[t] = a + rank_in(bd, bi, 64, od[t], oi[t], false);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t)
    if (ra[t] < k) {
      ld[ra[t]] = od[t];
      li[ra[t]] = oi[t];
    }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    if (rb[u] < k) {
      ld[rb[u]] = kd[u];
      li[rb[u]] = ki[u];
    }
  __syncwarp();
}

// Stages the query tile [d][QT] (query-minor, zero past B) and computes
// |q|^2 of each slot as an fmaf chain over d in index order.
template <int QT>
__device__ void load_query_tile(const float* __restrict__ q, int B, int d, int q0,
                                float* qs, float* q2s) {
  const int tid = threadIdx.x;
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    // 16-byte reads along each query row, all in flight together
    const int d4 = d / 4;
#pragma unroll 4
    for (int e = tid; e < d4 * QT; e += blockDim.x) {
      const int j = e / d4, i = 4 * (e % d4), b = q0 + j;
      const float4 v = b < B ? __ldg(reinterpret_cast<const float4*>(q + (long long)b * d + i))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      qs[i * QT + j] = v.x;
      qs[(i + 1) * QT + j] = v.y;
      qs[(i + 2) * QT + j] = v.z;
      qs[(i + 3) * QT + j] = v.w;
    }
  } else {
    for (int e = tid; e < d * QT; e += blockDim.x) {
      const int i = e / QT, j = e % QT, b = q0 + j;
      qs[i * QT + j] = b < B ? q[(long long)b * d + i] : 0.f;
    }
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
}

// The distance of one (query, row) pair from its sums; explicit roundings,
// so no contraction of the epilogue into an FMA.
__device__ __forceinline__ float l2_from_sums(float q2, float x2, float qx) {
  return fmaxf(__fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.f, qx)), 0.f);
}

// Writes this block's list of each of its queries to the scratch partials.
__device__ void write_partials(const float* ld, const int* li, int qt, int B, int k,
                               int q0, int split, int n_splits, float* part_d,
                               int* part_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < qt; j += blockDim.x >> 5) {
    const int b = q0 + j;
    if (b >= B) continue;
    const long long off = ((long long)b * n_splits + split) * k;
    for (int s = lane; s < k; s += 32) {
      part_d[off + s] = ld[j * k + s];
      part_i[off + s] = li[j * k + s];
    }
  }
}

// ---------------------------------------------------------------------------
// Streaming path
// ---------------------------------------------------------------------------

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

// Pass 1, streaming: grid (query tiles, splits).  Each thread streams its
// own corpus row straight from device memory (16-byte loads when d % 4 == 0
// and the corpus is 16-byte aligned), so the warps need no block barrier
// inside the sweep.  QT is 8, or 1 for a single query, which then pays no
// FMAs for empty tile slots.
template <int QT, bool VEC4>
__global__ void __launch_bounds__(THREADS, 2) l2_topk_stream(
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

  for (int e = tid; e < WARPS * QT * k; e += THREADS) {
    ld[e] = INFINITY;
    li[e] = EMPTY_ID;
  }
  load_query_tile<QT>(q, B, d, q0, qs, q2s);
  __syncthreads();

  for (long long t0 = r_begin; t0 < r_end; t0 += TN) {
    const long long row = t0 + tid;
    const bool valid = row < r_end && mask[row] != 0;
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
      const float dist = l2_from_sums(q2s[j], ax2, acc[j]);
      warp_insert(ld + (warp * QT + j) * k, li + (warp * QT + j) * k, k, dist,
                  (int)row, valid && q0 + j < B);
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
  }
  __syncthreads();
  write_partials(ld, li, QT, B, k, q0, split, n_splits, part_d, part_i);
}

// ---------------------------------------------------------------------------
// Tiled path
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The split's passing rows, handed out a tile at a time in ascending order.
// Every thread holds the same cursor/head/tail; all threads call next().
struct RowQueue {
  const uint8_t* mask;
  long long cursor, end;  // next mask byte to scan, end of the split
  int head, tail;         // ring[head..tail) are scanned, not yet handed out
  int* ring;              // [RING]
  int* wsum;              // [TWARPS]

  // Scans mask bytes (TTHREADS a step: ballot, then popc prefix sums across
  // the warps) until the ring holds TT ids or the split is exhausted, then
  // moves up to TT of them into ids; *n = their count.  Ends with a block
  // barrier.
  __device__ void next(int* ids, int* n) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    while (tail - head < TT && cursor < end) {
      const long long row = cursor + tid;
      const bool pass = row < end && mask[row] != 0;
      const unsigned m = __ballot_sync(FULL, pass);
      if (lane == 0) wsum[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < TWARPS; ++w) {
        const int c = wsum[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (pass) ring[(tail + before + __popc(m & ((1u << lane) - 1))) & (RING - 1)] = (int)row;
      tail += total;
      cursor += TTHREADS;
      __syncthreads();
    }
    const int got = min(TT, tail - head);
    if (tid < got) ids[tid] = ring[(head + tid) & (RING - 1)];
    if (tid == 0) *n = got;
    head += got;
    __syncthreads();
  }
};

// Starts the copies of columns [c KC, c KC + KC) of the n rows `ids` into a
// stage ([TT][XS]); commits a group even when there is nothing to copy.
__device__ __forceinline__ void issue_chunk(const float* __restrict__ x, int d,
                                            const int* ids, int n, int c, float* stage) {
  const int col0 = c * KC;
#pragma unroll
  for (int p = threadIdx.x; p < TT * (KC / 4); p += TTHREADS) {
    const int r = p / (KC / 4), c4 = (p % (KC / 4)) * 4;
    if (r < n && col0 + c4 < d)
      cp_async16(stage + r * XS + c4, x + (long long)ids[r] * d + col0 + c4);
  }
  cp_async_commit();
}

// Pass 1, tiled: grid (query tiles, splits).  Needs d % 4 == 0 and a
// 16-byte aligned corpus.  Thread (tq, tr) owns queries tq MQ ..
// tq MQ + MQ - 1 and rows tr, tr + RG, ..., tr + (MR - 1) RG of each tile;
// a warp holds 8 tq x 4 tr, so its 16-byte reads of a staged chunk touch 4
// rows (broadcast to 8 lanes each) and of the query tile 8 (contiguous).
template <int QT>
__global__ void __launch_bounds__(TTHREADS, 1) l2_topk_tiled(
    const float* __restrict__ q, const float* __restrict__ x,
    const uint8_t* __restrict__ mask, int B, long long N, int d, int k,
    long long rows_per_split, float* __restrict__ part_d,
    int* __restrict__ part_i) {
  constexpr int MQ = QT / QG;
  static_assert(MQ * MR <= 64 && MQ % 2 == 0, "one pending bit per micro-tile entry");
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [STAGES][TT][XS]
  float* qs = xs + STAGES * TT * XS;              // [d][QT]
  float* q2s = qs + d * QT;                       // [QT]
  float* x2s = q2s + QT;                          // [TT]
  float* ld = x2s + TT;                           // [QT][k]
  int* li = reinterpret_cast<int*>(ld + QT * k);  // [QT][k]
  float* bd = reinterpret_cast<float*>(li + QT * k);  // [QT][CAND]
  int* bi = reinterpret_cast<int*>(bd + QT * CAND);   // [QT][CAND]
  int* cnt = bi + QT * CAND;                      // [QT]
  int* ids = cnt + QT;                            // [2][TT]
  int* ring = ids + 2 * TT;                       // [RING]
  int* wsum = ring + RING;                        // [TWARPS]
  int* ntile = wsum + TWARPS;                     // [2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = (warp % (RG / 4)) * 4 + (lane >> 3), tq = (warp / (RG / 4)) * 8 + (lane & 7);
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const long long r_begin = (long long)split * rows_per_split;
  const int n_chunks = (d + KC - 1) / KC;

  for (int e = tid; e < QT * k; e += TTHREADS) {
    ld[e] = INFINITY;
    li[e] = EMPTY_ID;
  }
  if (tid < QT) cnt[tid] = 0;
  load_query_tile<QT>(q, B, d, q0, qs, q2s);

  RowQueue rows{mask, r_begin, min(N, r_begin + rows_per_split), 0, 0, ring, wsum};
  rows.next(ids, ntile);            // tile 0
  rows.next(ids + TT, ntile + 1);   // tile 1
  // the copy ring runs STAGES - 1 chunks ahead of the compute, over the
  // sequence (tile 0, chunk 0), (tile 0, chunk 1), ...; n_chunks >=
  // STAGES - 1 keeps it within the next tile, whose ids are always ready
  int it = 0, ic = 0, ist = 0;
  auto issue_next = [&]() {
    const int slot = it & 1;
    issue_chunk(x, d, ids + slot * TT, ntile[slot], ic, xs + ist * TT * XS);
    ist = ist + 1 == STAGES ? 0 : ist + 1;
    if (++ic == n_chunks) { ic = 0; ++it; }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue_next();

  int cst = 0;
  for (int t = 0;; ++t) {
    const int slot = t & 1;
    const int n = ntile[slot];
    if (n == 0) break;
    float acc[MQ][MR];
#pragma unroll
    for (int j = 0; j < MQ; ++j)
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[j][m] = 0.f;
    float ax2 = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // chunk c landed; the stage issue_next fills is free
      issue_next();
      const float* xc = xs + cst * TT * XS;
      const float* qc = qs + c * KC * QT + tq * MQ;
      const int width = min(KC, d - c * KC);
      if (tid < TT) {
        const float* xr = xc + tid * XS;
#pragma unroll
        for (int i = 0; i < KC; i += 4) {
          if (i < width) {
            const float4 v = *reinterpret_cast<const float4*>(xr + i);
            ax2 = fmaf(v.x, v.x, ax2);
            ax2 = fmaf(v.y, v.y, ax2);
            ax2 = fmaf(v.z, v.z, ax2);
            ax2 = fmaf(v.w, v.w, ax2);
          }
        }
      }
      if (width == KC) {
        // rows 0..MR/2-1 and MR/2..MR-1 of the micro-tile in turns: the
        // next half's row reads (and the next 4 columns' query reads) are
        // issued before this half's FMAs
        constexpr int H = MR / 2;
        float4 xa[H], xb[H];
        float qa[4][MQ], qb[4][MQ];
        auto load_x = [&](float4 (&xv)[H], int i, int h) {
#pragma unroll
          for (int m = 0; m < H; ++m)
            xv[m] = *reinterpret_cast<const float4*>(xc + (tr + RG * (h * H + m)) * XS + i);
        };
        auto load_q = [&](float (&qv)[4][MQ], int i) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            if constexpr (MQ % 4 == 0) {
#pragma unroll
              for (int j = 0; j < MQ; j += 4) {
                const float4 v = *reinterpret_cast<const float4*>(qc + (i + ii) * QT + j);
                qv[ii][j] = v.x; qv[ii][j + 1] = v.y; qv[ii][j + 2] = v.z; qv[ii][j + 3] = v.w;
              }
            } else {
              const float2 v = *reinterpret_cast<const float2*>(qc + (i + ii) * QT);
              qv[ii][0] = v.x; qv[ii][1] = v.y;
            }
          }
        };
        auto fma_half = [&](const float4 (&xv)[H], const float (&qv)[4][MQ], int h) {
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int m = 0; m < H; ++m) {
              const float xe = ii == 0 ? xv[m].x : ii == 1 ? xv[m].y : ii == 2 ? xv[m].z : xv[m].w;
#pragma unroll
              for (int j = 0; j < MQ; ++j) acc[j][h * H + m] = fmaf(qv[ii][j], xe, acc[j][h * H + m]);
            }
        };
        load_x(xa, 0, 0);
        load_q(qa, 0);
#pragma unroll
        for (int i = 0; i < KC; i += 8) {
          load_x(xb, i, 1);
          fma_half(xa, qa, 0);
          load_x(xa, i + 4, 0);
          load_q(qb, i + 4);
          fma_half(xb, qa, 1);
          load_x(xb, i + 4, 1);
          fma_half(xa, qb, 0);
          if (i + 8 < KC) {
            load_x(xa, i + 8, 0);
            load_q(qa, i + 8);
          }
          fma_half(xb, qb, 1);
        }
      } else {
  #pragma unroll
        for (int i = 0; i < KC; i += 4) {
          if (i < width) {
            float4 xv[MR];
  #pragma unroll
            for (int m = 0; m < MR; ++m)
              xv[m] = *reinterpret_cast<const float4*>(xc + (tr + RG * m) * XS + i);
  #pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              float qv[MQ];
              if constexpr (MQ % 4 == 0) {
  #pragma unroll
                for (int j = 0; j < MQ; j += 4) {
                  const float4 v = *reinterpret_cast<const float4*>(qc + (i + ii) * QT + j);
                  qv[j] = v.x; qv[j + 1] = v.y; qv[j + 2] = v.z; qv[j + 3] = v.w;
                }
              } else {
                const float2 v = *reinterpret_cast<const float2*>(qc + (i + ii) * QT);
                qv[0] = v.x; qv[1] = v.y;
              }
  #pragma unroll
              for (int m = 0; m < MR; ++m) {
                const float xe = ii == 0 ? xv[m].x : ii == 1 ? xv[m].y : ii == 2 ? xv[m].z : xv[m].w;
  #pragma unroll
                for (int j = 0; j < MQ; ++j) acc[j][m] = fmaf(qv[j], xe, acc[j][m]);
              }
            }
          }
        }
      }
      cst = cst + 1 == STAGES ? 0 : cst + 1;
    }

    // threshold-filtered selection of this tile's candidates
    if (tid < TT) x2s[tid] = ax2;
    __syncthreads();
    const int* tids = ids + slot * TT;
    float dist[MQ][MR];
    unsigned long long pending = 0;
#pragma unroll
    for (int j = 0; j < MQ; ++j)
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int r = tr + RG * m, qj = tq * MQ + j;
        dist[j][m] = l2_from_sums(q2s[qj], x2s[r], acc[j][m]);
        if (r < n && q0 + qj < B) pending |= 1ull << (j * MR + m);
      }
    while (true) {
      bool over = false;
#pragma unroll
      for (int j = 0; j < MQ; ++j) {
        const int qj = tq * MQ + j;
        const float taud = ld[qj * k + k - 1];
        const int taui = li[qj * k + k - 1];
        unsigned want = 0;   // rows m of query j that beat tau
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const unsigned long long bit = 1ull << (j * MR + m);
          if (!(pending & bit)) continue;
          if (lex_less(dist[j][m], tids[tr + RG * m], taud, taui)) want |= 1u << m;
          else pending &= ~bit;
        }
        if (want == 0) continue;
        int s = atomicAdd(&cnt[qj], __popc(want));   // one reservation per thread and query
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (!(want >> m & 1)) continue;
          if (s < CAND) {
            bd[qj * CAND + s] = dist[j][m];
            bi[qj * CAND + s] = tids[tr + RG * m];
            pending &= ~(1ull << (j * MR + m));
          } else {
            over = true;   // buffer full: filtered again after the merge
          }
          ++s;
        }
      }
      const bool again = __syncthreads_or(over);
      for (int qj = warp; qj < QT; qj += TWARPS) {
        const int c = min(cnt[qj], CAND);
        if (c > SMALL_MERGE) {
          warp_merge(ld + qj * k, li + qj * k, k, bd + qj * CAND, bi + qj * CAND, c);
        } else if (c > 0) {
          const bool ok = lane < c;
          warp_insert(ld + qj * k, li + qj * k, k, ok ? bd[qj * CAND + lane] : INFINITY,
                      ok ? bi[qj * CAND + lane] : EMPTY_ID, ok);
        }
        __syncwarp();
        if (lane == 0) cnt[qj] = 0;
      }
      __syncthreads();
      if (!again) break;
    }
    rows.next(ids + slot * TT, ntile + slot);   // tile t + 2 into this slot
  }
  cp_async_wait<0>();
  write_partials(ld, li, QT, B, k, q0, split, n_splits, part_d, part_i);
}

// ---------------------------------------------------------------------------
// Pass 2: one block per query merges its n_splits partial lists.
// ---------------------------------------------------------------------------
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

bool tiled_qt(int qt) { return qt == 32 || qt == 64; }

}  // namespace

extern "C" {

// Pass 1's dynamic shared memory in bytes for query tile qt (1 or 8:
// streaming; 32 or 64: tiled), width d and list length k.
long long masked_l2_topk_smem(int qt, int d, int k) {
  if (tiled_qt(qt))
    return (long long)sizeof(float) *
           ((long long)STAGES * TT * XS + (long long)d * qt + qt + TT + 2LL * qt * k +
            2LL * qt * CAND + qt + 2 * TT + RING + TWARPS + 2);
  return (long long)sizeof(float) * ((long long)d * qt + qt) + 8LL * WARPS * qt * k;
}

// q (B, d) f32, x (N, d) f32, mask (N,) u8, all contiguous on the device.
// qt: the query tile, 1 or 8 (streaming path) or 32 or 64 (tiled path,
// which needs d % 4 == 0 and a 16-byte aligned x).
// part_{d,i}: (B, n_splits, k) scratch; out_{d,i}: (B, k).  Launches both
// passes on `stream` without synchronising; returns cudaGetLastError().
int masked_l2_topk_f32(const void* q, const void* x, const void* mask, int B,
                       long long N, int d, int k, int qt, int n_splits,
                       long long rows_per_split, void* part_d, void* part_i,
                       void* out_d, void* out_i, float empty_dist,
                       void* stream) {
  const bool tiled = tiled_qt(qt);
  if (B < 1 || d < 1 || k < 1 || k > KMAX || n_splits < 1 || N < 0 ||
      (qt != 1 && qt != 8 && !tiled))
    return (int)cudaErrorInvalidValue;
  // 16-byte row loads need d % 4 == 0 and a 16-byte aligned corpus
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tiled && !(vec4 && (d + KC - 1) / KC >= STAGES - 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = (size_t)masked_l2_topk_smem(qt, d, k);
  auto kernel = qt == 64 ? l2_topk_tiled<64>
              : qt == 32 ? l2_topk_tiled<32>
              : qt == 1  ? (vec4 ? l2_topk_stream<1, true> : l2_topk_stream<1, false>)
                         : (vec4 ? l2_topk_stream<8, true> : l2_topk_stream<8, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  const dim3 g1((B + qt - 1) / qt, n_splits);
  kernel<<<g1, tiled ? TTHREADS : THREADS, smem1, st>>>(
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
