// Flash-decode GQA attention for one new token, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_kernel` in src/repro/kernels/decode_attention.py
// (launched by `decode_attention_kernel`).  For each sequence b and kv head
// it returns, for the GQ query heads grouped on that kv head,
//     out[g] = sum_p softmax_p(q[g] . k[p] / sqrt(dh)) v[p]
// over the positions p < length[b] of the (B, KV, S, dh) caches.  q, the
// accumulation and out are fp32; K/V are read as float or bf16.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): the bytes of K and V.  It
// reads sum_b length_b * KV * dh * 2 * sizeof(elem) bytes and does about 4
// flops (2 for q.k, 2 for p.v) per K/V element per head, so with GQ = 5 and
// bf16 about 5 flop/B, far below the card's ~295 flop/B ridge: memory-bound.
// For qwen3-14b (KV 8, dh 128, bf16) that is 4096 B per position per row:
//   * B=8 rows of ~1.2k positions: ~38 MB -> ~11 us at 3.35 TB/s;
//   * B=32 at S=32768 (decode_32k's context): 4.29 GB -> ~1.28 ms.
// What the design does about it:
//   * The TPU grid (B, KV, S_tiles) swept S in order, carrying the online
//     softmax state in VMEM.  Hopper's blocks run in parallel, so pass 1
//     cuts S into fixed CHUNK-position chunks, one block per (b, kv, chunk),
//     and writes each chunk's partial (m, l, acc[dh]) per head to fp32
//     scratch; pass 2 combines each (b, kv)'s chunks in chunk order.  Chunk
//     boundaries depend on the position only (never on B or the SM count),
//     so a row's result is bitwise the same alone or in any batch.
//   * Positions >= length[b] are never read: a chunk that starts at or past
//     the length exits at once, and the last chunk stops at the length.  (On
//     the TPU they were read and contributed exp(NEG - m) = 0.)
//   * One K/V read serves every query head of the group: the block keeps its
//     GQ queries in registers (fp32) and applies each loaded K/V element to
//     all of them.  Rows are read with 16-byte loads, a group of LPR lanes
//     per row, neighbouring lanes on neighbouring bytes.
//   * Each lane group issues U = 4 rows' 16-byte loads before it uses any,
//     so a warp keeps 4 loads per lane in flight: one row at a time left
//     the sweep bound by load latency, not by bandwidth.
//   * Warps take disjoint positions of the chunk; their V accumulators are
//     combined in fixed warp order, and every other sum has a fixed order
//     too, so the result does not vary from run to run.
// TMA, a persistent grid and a fused single pass are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;     // positions per pass-1 block (wrapper: CHUNK)
constexpr int THREADS = 256;   // one softmax position per thread
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;           // rows per lane group with loads in flight
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNK == THREADS, "the softmax step gives each thread one position");

// 16 bytes of K/V, loaded raw, then widened to floats.
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen(const uint4& raw, const float*, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(const uint4& raw, const __nv_bfloat16*, float* out) {
  alignas(16) __nv_bfloat16 e[8];
  *reinterpret_cast<uint4*>(e) = raw;
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// Pass 1: block (chunk c, kv head, row b).  GQM >= gq is the register width
// of the per-head state; heads g >= gq are skipped (warp-uniform branches).
template <typename T, int DH, int GQM>
__global__ void __launch_bounds__(THREADS)
decode_pass1(const float* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths, int KV,
             int S, int gq, int n_chunks, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int VEC = 16 / sizeof(T);                 // elements per load
  constexpr int LPR = (DH / VEC < 32) ? DH / VEC : 32;  // lanes per K/V row
  constexpr int EPL = DH / LPR;                       // elements per lane
  constexpr int NV = EPL / VEC;                       // loads per lane per row
  constexpr int RPW = 32 / LPR;                       // rows per warp step
  static_assert(NV * VEC * LPR == DH, "row split");

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], S);
  const int start = c * CHUNK;
  if (start >= len) return;                           // nothing valid here
  const int n = min(CHUNK, len - start);

  __shared__ float qa_s[GQM][DH];   // the queries, later the V accumulator
  __shared__ float s_s[GQM][CHUNK]; // scores, then exp(score - m)
  __shared__ float red_s[WARPS][GQM];
  __shared__ float m_s[GQM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR, row = lane / LPR;
  const size_t bk = (size_t)b * KV + kvh;
  const float* qb = q + bk * gq * DH;
  for (int i = tid; i < GQM * DH; i += THREADS)
    qa_s[i / DH][i % DH] = (i / DH < gq) ? qb[i] : 0.f;
  __syncthreads();

  // lane element e of a row sits at column col(e) = (e / VEC * LPR + sub) * VEC + e % VEC
  float qr[GQM][EPL];
#pragma unroll
  for (int g = 0; g < GQM; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = qa_s[g][(e / VEC * LPR + sub) * VEC + e % VEC];

  // ---- scores: s[g][p] = q[g] . k[p] * scale ------------------------------
  // A warp step covers U * RPW consecutive rows; each lane group issues its
  // U rows' loads before using any, so U loads per lane are in flight.
  const float scale = 1.0f / sqrtf((float)DH);
  const T* kb = k + (bk * S + start) * DH;
  for (int p0 = warp * RPW * U; p0 < n; p0 += WARPS * RPW * U) {
    uint4 raw[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * RPW + row;
#pragma unroll
      for (int t = 0; t < NV; ++t)
        raw[u][t] = p < n ? load16(kb + (size_t)p * DH + (t * LPR + sub) * VEC) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * RPW + row;
      float kx[EPL];
#pragma unroll
      for (int t = 0; t < NV; ++t) widen(raw[u][t], kb, kx + t * VEC);
      float dot[GQM];
#pragma unroll
      for (int g = 0; g < GQM; ++g) {
        dot[g] = 0.f;
        if (g < gq) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot[g] = fmaf(qr[g][e], kx[e], dot[g]);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1) dot[g] += __shfl_xor_sync(FULL, dot[g], off);
        }
      }
      if (p < n && sub == 0) {
#pragma unroll
        for (int g = 0; g < GQM; ++g)
          if (g < gq) s_s[g][p] = dot[g] * scale;
      }
    }
  }
  __syncthreads();

  // ---- chunk softmax: m = max_p s, s <- exp(s - m), l = sum_p s -----------
  float x[GQM];
#pragma unroll
  for (int g = 0; g < GQM; ++g) {
    x[g] = (g < gq && tid < n) ? s_s[g][tid] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[g] = fmaxf(x[g], __shfl_xor_sync(FULL, x[g], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GQM; ++g) red_s[warp][g] = x[g];
  }
  __syncthreads();
  if (tid < gq) {
    float m = red_s[0][tid];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_s[w][tid]);
    m_s[tid] = m;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GQM; ++g) {
    x[g] = 0.f;
    if (g < gq && tid < n) {
      x[g] = expf(s_s[g][tid] - m_s[g]);
      s_s[g][tid] = x[g];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[g] += __shfl_xor_sync(FULL, x[g], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GQM; ++g) red_s[warp][g] = x[g];
  }
  __syncthreads();
  const size_t part = bk * n_chunks + c;
  if (tid < gq) {
    float l = 0.f;
    for (int w = 0; w < WARPS; ++w) l += red_s[w][tid];
    part_m[part * gq + tid] = m_s[tid];
    part_l[part * gq + tid] = l;
  }

  // ---- acc[g] = sum_p s[g][p] v[p] ----------------------------------------
  float acc[GQM][EPL];
#pragma unroll
  for (int g = 0; g < GQM; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  const T* vb = v + (bk * S + start) * DH;
  for (int p0 = warp * RPW * U; p0 < n; p0 += WARPS * RPW * U) {
    uint4 raw[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * RPW + row;
#pragma unroll
      for (int t = 0; t < NV; ++t)
        raw[u][t] = p < n ? load16(vb + (size_t)p * DH + (t * LPR + sub) * VEC) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * RPW + row;
      if (p < n) {
        float vx[EPL];
#pragma unroll
        for (int t = 0; t < NV; ++t) widen(raw[u][t], vb, vx + t * VEC);
#pragma unroll
        for (int g = 0; g < GQM; ++g) {
          if (g < gq) {
            const float w = s_s[g][p];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w, vx[e], acc[g][e]);
          }
        }
      }
    }
  }
  // the warp's RPW row groups: lanes with equal `sub` hold the same columns
#pragma unroll
  for (int g = 0; g < GQM; ++g) {
    if (g < gq) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
  }
  // the warps, in warp order, into qa_s (the queries are in registers now)
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && row == 0) {
#pragma unroll
      for (int g = 0; g < GQM; ++g) {
        if (g < gq) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            float& dst = qa_s[g][(e / VEC * LPR + sub) * VEC + e % VEC];
            dst = (w == 0) ? acc[g][e] : dst + acc[g][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pa = part_acc + part * gq * DH;
  for (int i = tid; i < gq * DH; i += THREADS) pa[i] = qa_s[i / DH][i % DH];
}

// Pass 2: block (kv head, row b) combines the row's chunks in chunk order.
__global__ void __launch_bounds__(128)
decode_pass2(const int* __restrict__ lengths, int KV, int S, int gq, int dh,
             int n_chunks, const float* __restrict__ part_m,
             const float* __restrict__ part_l, const float* __restrict__ part_acc,
             float* __restrict__ out) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = min(lengths[b], S);
  const int nc = len > 0 ? (len + CHUNK - 1) / CHUNK : 0;
  const size_t bk = (size_t)b * KV + kvh;
  const size_t base = bk * n_chunks;
  for (int i = threadIdx.x; i < gq * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    float m = -INFINITY;
    for (int c = 0; c < nc; ++c) m = fmaxf(m, part_m[(base + c) * gq + g]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float e = expf(part_m[(base + c) * gq + g] - m);
      l += part_l[(base + c) * gq + g] * e;
      a += part_acc[((base + c) * gq + g) * dh + d] * e;
    }
    out[(bk * gq + g) * dh + d] = a / fmaxf(l, 1e-30f);
  }
}

template <typename T, int DH, int GQM>
void launch_pass1(const float* q, const T* k, const T* v, const int* lengths, int B,
                  int KV, int S, int gq, int n_chunks, float* pm, float* pl, float* pa,
                  cudaStream_t stream) {
  const dim3 grid(n_chunks, KV, B);
  decode_pass1<T, DH, GQM><<<grid, THREADS, 0, stream>>>(q, k, v, lengths, KV, S, gq,
                                                          n_chunks, pm, pl, pa);
}

template <typename T, int DH>
void launch_gq(const float* q, const T* k, const T* v, const int* lengths, int B, int KV,
               int S, int gq, int n_chunks, float* pm, float* pl, float* pa,
               cudaStream_t stream) {
  if (gq <= 4)
    launch_pass1<T, DH, 4>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream);
  else if (gq <= 8)
    launch_pass1<T, DH, 8>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream);
  else
    launch_pass1<T, DH, 16>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream);
}

template <typename T>
int decode_attention(const float* q, const T* k, const T* v, const int* lengths, int B,
                     int KV, int S, int gq, int dh, int n_chunks, float* pm, float* pl,
                     float* pa, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || KV < 1 || S < 1 || gq < 1 || gq > 16 ||
      n_chunks != (S + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: launch_gq<T, 32>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream); break;
    case 64: launch_gq<T, 64>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream); break;
    case 128: launch_gq<T, 128>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream); break;
    case 256: launch_gq<T, 256>(q, k, v, lengths, B, KV, S, gq, n_chunks, pm, pl, pa, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_pass2<<<dim3(KV, B), 128, 0, stream>>>(lengths, KV, S, gq, dh, n_chunks, pm, pl,
                                                 pa, out);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, KV, gq, dh) f32; k/v (B, KV, S, dh); lengths (B,) i32; scratch
// part_m/part_l (B, KV, n_chunks, gq) and part_acc (B, KV, n_chunks, gq, dh)
// f32; out (B, KV, gq, dh) f32.  All contiguous on one device.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int decode_attention_f32(const float* q, const float* k, const float* v,
                                    const int* lengths, int B, int KV, int S, int gq,
                                    int dh, int n_chunks, float* part_m, float* part_l,
                                    float* part_acc, float* out, void* stream) {
  return decode_attention<float>(q, k, v, lengths, B, KV, S, gq, dh, n_chunks, part_m,
                                 part_l, part_acc, out, stream);
}

extern "C" int decode_attention_bf16(const float* q, const void* k, const void* v,
                                     const int* lengths, int B, int KV, int S, int gq,
                                     int dh, int n_chunks, float* part_m, float* part_l,
                                     float* part_acc, float* out, void* stream) {
  return decode_attention<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      lengths, B, KV, S, gq, dh, n_chunks, part_m, part_l, part_acc, out, stream);
}
