// Flash-decode GQA attention for one new token, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_kernel` in src/repro/kernels/decode_attention.py
// (launched by `decode_attention_kernel`).  For each sequence b and kv head
// it returns, for the GQ query heads grouped on that kv head,
//     out[g] = sum_p softmax_p(cap(q[g] . k[p] / sqrt(dh))) v[p]
// over the positions length[b] - window <= p < length[b] of the (B, KV, S, dh)
// caches, where cap(x) = softcap * tanh(x / softcap) when softcap > 0 and x
// otherwise: the reference's decode_attention_xla contract (gemma2 decodes
// with a 4096 window on every other layer and a softcap of 50).  q, the
// accumulation and out are fp32; K/V are read as float, bf16, or int8 with an
// fp32 scale per (row, kv head, position): the int8 KV cache of
// repro/models/model.py (`kv_cache_int8`), whose decode dequantizes the whole
// cache, casts it to the model's compute type and runs decode_attention_xla.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): the bytes of K and V.  It
// reads sum_b length_b * KV * dh * 2 * sizeof(elem) bytes and does about 4
// flops (2 for q.k, 2 for p.v) per K/V element per head, so with GQ = 5 and
// bf16 about 5 flop/B, far below the card's ~295 flop/B ridge: memory-bound,
// and tensor cores do not help.  What matters is the bytes in flight on each
// SM and how many SMs have work.
//
// One launch per call.  The grid is one block per (position chunk, kv head,
// row b); a block past its row's length exits at once.  Each design point
// answers a cost the first, two-launch version of this kernel measured on the card
// [H100 80GB HBM3, 700 W; chip_smoke.py phase 3b, bf16, device time]:
// 0.3703 ms at B=1, S=32768 (SDPA 0.0618), 0.0581 ms at the serving shape
// B=8, S=2088 (bound 0.0110, SDPA 0.0428), 1.8314 ms at B=32, S=32768
// (bound 0.6511, SDPA 1.4150).
//   * No second pass.  The first version combined a row's chunks in a second
//     launch with B*KV blocks, each walking every chunk twice: 8 blocks at
//     B=1, the rest of the card idle.  Here each block writes its chunk's fp32
//     partial (m, l, acc) to a workspace and counts in on a per-(b, kv)
//     counter (one release/acquire atomic by one thread, after a block
//     barrier); the block that arrives last for its row combines the row's
//     partials in chunk order (never arrival order), spread over all its
//     threads with 16 chunks' loads in flight, writes out and resets the
//     counter to 0 for the next call.  A row of one chunk writes out
//     directly.  The counter's target is the row's live chunk count.  Only
//     the counter is atomic: no float atomics.
//   * K and V staged through shared memory by the copy engine.  A (b, kv)
//     run of rows is one contiguous byte range in the (B, KV, S, dh) layout,
//     so a 1-D `cp.async.bulk` with an mbarrier moves a sub-tile of rows
//     without a tensor map.  Each warp owns a ring of MAX_STAGES sub-tiles
//     (K and V of R rows, STAGE_BYTES together) and sweeps the chunk's
//     sub-tiles w, w + WARPS, ...; the copy of the next stage is in flight
//     while it computes on one.  The softmax is online across a warp's
//     sub-tiles (running m, l, acc, rescaled once per sub-tile), so the sweep
//     has no block barrier at all: the first version's K sweep -> barriers ->
//     block softmax -> V sweep kept K and V loads from overlapping.  One
//     end-of-chunk reduction combines the warps in warp order.  The last
//     sub-tile copies only the rows below the length (a row is dh * elem >= 64
//     bytes, a multiple of 16), so no byte past a length is read; rows of a
//     stage past the copied count are masked out of the scores and the V sum.
//   * Fewer instructions per byte.  At GQ = 5 and bf16 a sub-tile costs about
//     2.5 FMAs per K/V byte on the CUDA cores, so with all blocks of a short
//     cache waiting for data together and then computing together, the
//     instruction count shows in the time.  The q.k sums over a row's lanes
//     are reduced transposed (each lane keeps half of its rows at each level,
//     so the rows end up spread over the lanes instead of every lane summing
//     every row), which also leaves one exp per (row, head) instead of one
//     per lane; the p of a sub-tile reach the V sweep through shared memory.
//   * Chunk size from S, dh and the element type only, never from B or the
//     lengths (`chunk_positions`, mirrored by the wrapper, which passes it
//     in): a row alone and the same row in a batch split, sum and combine in
//     the same order and give the same bits.  It is whole passes of the
//     block's warps, as many as leave at least 17 chunks (136 blocks at B=1
//     over qwen3's 8 kv heads, for 132 SMs) up to 16 passes, and about S / 32
//     past that: few, large chunks share each block's fixed cost (the copy's
//     latency, the end-of-chunk reduction, the arrival) on short caches, and
//     32-63 chunks spread a long row over the SMs.
//   * Per-head state at the exact group sizes the repo's configs use (5 for
//     qwen3; 1, 2, 4, 8, 16 in the reference tests), padded to 8 or 16 with
//     warp-uniform skips for the other sizes up to 16.  Registers are held to
//     three blocks an SM at qwen3's group of 5 (`min_blocks`).
//   * Nothing is allocated per call but `out`: the wrapper caches the
//     workspace and its counters, zeroed once; the kernel leaves them zero.
//     Two calls that run at once on different streams must not share a
//     workspace, so the wrapper keys it on the stream.
//   * The window and the softcap are launch arguments, not template
//     parameters (a template flag would double the 64 instantiations' build).
//     With lo = max(0, len - window), a block whose chunk lies wholly below
//     lo exits at once, as one past the length does; the live chunks are
//     c_lo = lo / chunk .. the last, and the arrival count and the combine
//     span exactly those, so the counters are still left at zero.  In the
//     first live chunk the warps start at the sub-tile holding lo, and that
//     sub-tile's copies start at lo: no position below lo is read, and its
//     rows below lo get p = 0 and are left out of the V sum, as rows past the
//     copied count are.  The chunk grid does not move with the window, so a
//     row is bitwise the same alone or in a batch.  The softcap is applied in
//     natural units before the log2(e) factor.  With window >= len and no
//     softcap every block does what it did before both existed.
//   * int8 K/V (`decode_attention_int8`) are dequantized in registers and no
//     dequantized cache is ever written: a position costs dh + 4 bytes of K
//     and as many of V, against 2 dh in bf16.  Each value is q * scale in
//     fp32, then rounded to bf16 when the model computes in bf16 (a launch
//     argument), which is what the reference's `dequantize_kv(...).astype(
//     x.dtype)` hands its attention.  The lanes, rows and chunks are bf16's:
//     a lane reads 8 int8 values (8 bytes) where bf16 reads 8 values (16
//     bytes), so a sub-tile holds bf16's R rows in half the bytes and each
//     warp's ring has twice the stages.  A sub-tile's R scales of K and of V
//     arrive by 4-byte `cp.async` copies, one per lane and row, issued with
//     the sub-tile's bulk copies and awaited with `cp.async.wait_group`: a
//     window's first position need not be a multiple of 4, so the scales'
//     start is not 16-byte aligned for a bulk copy.
//   * One rank's KV heads of a cache it holds whole: tensor-parallel serving
//     keeps the reference's cache placement (replicated over the model axis)
//     and attends over the rank's KV groups only.  q and out are the rank's
//     (B, KV, gq, dh), and K/V (and the int8 scales) are addressed as heads
//     kv0 + kvh of the (B, KVC, S, dh) cache, in place: a head's positions are
//     one contiguous run whatever kv0, so no slice is copied and each rank
//     reads only its heads' bytes.  kv0 = 0 with KVC = KV is the whole-cache
//     launch, unchanged.
// Within a warp, a K/V row is read as 16-byte pieces by LPR lanes, the GQ
// queries sit in registers and one K/V element serves every head of the group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;               // warps per block (wrapper: WARPS)
constexpr int THREADS = WARPS * 32;
constexpr int STAGE_BYTES = 8192;      // K + V bytes of one sub-tile (wrapper: STAGE_BYTES)
constexpr int MAX_STAGES = 2;          // sub-tiles in each warp's ring (int8: twice as many)
constexpr int MIN_CHUNKS = 17;         // chunks a row has from S = 16 passes on (wrapper: MIN_CHUNKS)
constexpr int LONG_CHUNKS = 32;        // chunks a long row aims at (wrapper: LONG_CHUNKS)
constexpr int MAX_PASSES = 16;         // passes a chunk grows to before LONG_CHUNKS applies
constexpr int MAX_CHUNKS = 2 * LONG_CHUNKS;    // the rule never gives more
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// rows of K (and of V) in one sub-tile
__host__ __device__ constexpr int sub_rows(int dh, int elem) {
  return STAGE_BYTES / (2 * dh * elem);
}

// the element size that sets the tiling: int8 tiles as bf16 does
// (wrapper: the `elem` it passes to chunk_positions)
template <typename T>
__host__ __device__ constexpr int tile_elem() {
  return sizeof(T) == 1 ? 2 : (int)sizeof(T);
}

// sub-tiles in each warp's ring: an int8 stage is half of STAGE_BYTES
template <typename T>
__host__ __device__ constexpr int max_stages() {
  return sizeof(T) == 1 ? 2 * MAX_STAGES : MAX_STAGES;
}

// positions per chunk; mirrors kernels/decode_attention.py::chunk_positions
int chunk_positions(int s, int dh, int elem) {
  const int pass = WARPS * sub_rows(dh, elem);
  const int few = (s - 1) / ((MIN_CHUNKS - 1) * pass);   // passes that leave >= MIN_CHUNKS
  const int lng = s / (LONG_CHUNKS * pass);
  const int cap = lng > MAX_PASSES ? lng : MAX_PASSES;
  const int m = few < cap ? few : cap;
  return pass * (m > 1 ? m : 1);
}

// blocks per SM the register budget is held to: 3 for qwen3's group of 5
__host__ __device__ constexpr int min_blocks(int gqm) { return gqm <= 5 ? 3 : 1; }

// ---- PTX: mbarriers and bulk copies -----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait for the phase of parity `parity` to complete.  A copy that never lands
// is a bug: trap after ~10 s of cycles rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// 4 bytes from global `src` to shared `dst` (LDGSTS), in this thread's
// current cp.async group
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `newer` of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int newer) {
  switch (newer) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// Add 1 to a row's arrival counter with release and acquire semantics at
// device scope; returns the count before.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// One lane's piece of a K/V row in shared memory, widened to floats: 16
// bytes of float or bf16 (the scale and rounding are unused), or 8 int8
// values dequantized as q * scale in fp32, rounded to bf16 when `to_bf16`.
__device__ __forceinline__ void widen(const float* p, float* out, float, bool) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* out, float, bool) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // element 2i is the low half of word i
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const int8_t* p, float* out, float scale, bool to_bf16) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // byte b + 128 placed in the low byte of 2^23 is exactly the float 2^23 + b + 128
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q = __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7650 + j)) - 8388736.f;
      const float x = q * scale;
      out[4 * i + j] = to_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
    }
}

// Block (chunk c, kv head, row b).  GQM is the register width of the
// per-head state; PAD says gq < GQM, and heads g >= gq are skipped.
// Workspace: part_m, part_l (B, KV, n_chunks, gq) and part_acc
// (B, KV, n_chunks, gq, DH) f32, one after the other in `part`; counters
// (B, KV) int32, zero between calls.
// K/V are (B, KVC, S, dh) and the block reads cache head kv0 + kvh.  int8
// K/V also take k_scale/v_scale (B, KVC, S) f32 and `to_bf16`; the others
// pass null scales.
template <typename T, int DH, int GQM, bool PAD>
__global__ void __launch_bounds__(THREADS, min_blocks(GQM))
decode_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ lengths,
                        int B, int KV, int KVC, int kv0, int S, int gq, int chunk, int n_chunks,
                        int window, float softcap, bool to_bf16, int n_stages,
                        float* __restrict__ part, int* __restrict__ counters,
                        float* __restrict__ out) {
  constexpr int ELEM = sizeof(T);
  constexpr bool I8 = ELEM == 1;
  constexpr int VEC = (I8 ? 8 : 16) / ELEM;           // elements per piece (16 bytes; int8 8)
  constexpr int CPR = DH / VEC;                       // pieces per row
  constexpr int LPR = CPR < 32 ? CPR : 32;            // lanes per row
  constexpr int NV = CPR / LPR;                       // pieces per lane per row
  constexpr int EPL = NV * VEC;                       // elements per lane
  constexpr int RPW = 32 / LPR;                       // rows per warp step
  constexpr int R = sub_rows(DH, tile_elem<T>());     // rows per sub-tile
  constexpr int STEPS = R / RPW;
  constexpr int ROW_BYTES = DH * ELEM;
  constexpr int STAGE = 2 * R * ROW_BYTES;            // K + V bytes of one sub-tile
  constexpr int MST = max_stages<T>();
  constexpr int TL = ilog2(LPR) < ilog2(STEPS) ? ilog2(LPR) : ilog2(STEPS);  // transposed levels
  constexpr int JF = STEPS >> TL;                     // rows a lane ends with
  constexpr int DUP = LPR >> TL;                      // lanes that end with the same rows
  constexpr int GP = (GQM + 3) / 4 * 4;               // heads padded to a float4
  static_assert(NV * LPR == CPR && R % RPW == 0 && MST * STAGE == MAX_STAGES * STAGE_BYTES,
                "tile split");

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lengths[b], S);
  const size_t bk = (size_t)b * KV + kvh;             // q, out, partials, counters
  const size_t bc = (size_t)b * KVC + kv0 + kvh;      // the cache's (row, head)
  const int ng = PAD ? gq : GQM;                      // live heads
  float* outb = out + bk * ng * DH;
  if (len <= 0) {                                     // nothing to attend to
    if (c == 0)
      for (int i = tid; i < ng * DH; i += THREADS) outb[i] = 0.f;
    return;
  }
  const int start = c * chunk;
  if (start >= len) return;                           // past the row's length
  const int lo = len > window ? len - window : 0;     // the window's first position
  if (start + chunk <= lo) return;                    // wholly below the window
  const int n = min(chunk, len - start);
  const int c_lo = lo / chunk;                        // the row's first live chunk
  const int nc = (len + chunk - 1) / chunk - c_lo;    // the row's live chunks
  const int skip = lo > start ? lo - start : 0;       // rows of this chunk below lo

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[WARPS][MST];
  __shared__ float sc_s[I8 ? WARPS : 1][I8 ? MST : 1][2][I8 ? R : 1];  // int8 K, V scales
  __shared__ int is_last;
  __shared__ float chunk_m[GQM];
  __shared__ __align__(16) float p_s[WARPS][R][GP];   // p of the current sub-tile

  const int sub = lane % LPR, rg = lane / LPR;
  unsigned char* ring = smem + (size_t)warp * n_stages * STAGE;
  const int s_lo = skip / R;                          // the first live sub-tile
  const int n_live = (n + R - 1) / R - s_lo;          // live sub-tiles in the chunk
  const int mine = n_live > warp ? (n_live - 1 - warp) / WARPS + 1 : 0;
  const T* kb = k + (bc * S + start) * DH;
  const T* vb = v + (bc * S + start) * DH;

  // copy this warp's i-th sub-tile (chunk sub-tile s_lo + warp + i * WARPS)
  // into stage i % n_stages, K in the first half, V in the second, from the
  // row `first` on (rows below lo stay uncopied): lane 0 issues the bulk
  // copies; with int8 every lane then copies the scales of its rows and
  // commits a cp.async group (one per sub-tile, empty or not)
  auto fetch = [&](int i) {
    const int r0 = (s_lo + warp + i * WARPS) * R;
    const int first = skip > r0 ? skip - r0 : 0;
    const int rows = min(R, n - r0);
    const int stage = i % n_stages;
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(rows - first) * ROW_BYTES;
      const uint32_t dst = smem_u32(ring + stage * STAGE) + first * ROW_BYTES;
      const uint32_t bar = smem_u32(&bars[warp][stage]);
      mbar_expect(bar, 2 * bytes);
      bulk_load(dst, kb + (size_t)(r0 + first) * DH, bytes, bar);
      bulk_load(dst + STAGE / 2, vb + (size_t)(r0 + first) * DH, bytes, bar);
    }
    if constexpr (I8) {
      const size_t p0 = bc * S + start + r0;
      for (int r = lane; r < R; r += 32) {
        if (r >= first && r < rows) {
          cp_async4(smem_u32(&sc_s[warp][stage][0][r]), k_scale + p0 + r);
          cp_async4(smem_u32(&sc_s[warp][stage][1][r]), v_scale + p0 + r);
        }
      }
      cp_async_commit();
    }
  };
  if (lane == 0) {
    for (int s = 0; s < n_stages; ++s) mbar_init(smem_u32(&bars[warp][s]));
    fence_mbar_init();
  }
  __syncwarp();
  for (int i = 0; i < min(mine, n_stages); ++i) fetch(i);
  __syncwarp();

  // lane element e of a row sits at column col(e) = (e / VEC * LPR + sub) * VEC + e % VEC
  float qr[GQM][EPL];
  const float* qb = q + bk * ng * DH;
#pragma unroll
  for (int g = 0; g < GQM; ++g)
#pragma unroll
    for (int t = 0; t < NV; ++t)
#pragma unroll
      for (int h = 0; h < VEC; h += 4) {
        const float4 x = (!PAD || g < gq)
            ? __ldg(reinterpret_cast<const float4*>(qb + g * DH + (t * LPR + sub) * VEC + h))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[g][t * VEC + h] = x.x;
        qr[g][t * VEC + h + 1] = x.y;
        qr[g][t * VEC + h + 2] = x.z;
        qr[g][t * VEC + h + 3] = x.w;
      }

  // scores are kept as log2-domain logits: s = q.k * log2(e) / sqrt(dh), or
  // with a softcap s = softcap * tanh(q.k / sqrt(dh) / softcap) * log2(e)
  const float scale = LOG2E / sqrtf((float)DH);
  const float inv_sqrt_dh = 1.f / sqrtf((float)DH);
  float m_run[GQM], l_run[GQM], acc[GQM][EPL];
#pragma unroll
  for (int g = 0; g < GQM; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    const int stage = i % n_stages;
    mbar_wait(smem_u32(&bars[warp][stage]), (i / n_stages) & 1);
    const int r0 = (s_lo + warp + i * WARPS) * R;
    const int rows = min(R, n - r0);                  // rows [first, rows) are live
    const int first = skip > r0 ? skip - r0 : 0;
    const T* ks = reinterpret_cast<const T*>(ring + stage * STAGE);
    const T* vs = reinterpret_cast<const T*>(ring + stage * STAGE + STAGE / 2);
    if constexpr (I8) {              // this sub-tile's scales: every later group may pend
      cp_async_wait(min(mine, i + n_stages) - 1 - i);
      __syncwarp();
    }

    // partial dots: lane (rg, sub) holds q[g] . k[r] over its columns for
    // the rows r = j * RPW + rg of the sub-tile
    float pd[STEPS][GQM];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float kx[EPL];
      float k_sc = 0.f;
      if constexpr (I8) k_sc = sc_s[warp][stage][0][j * RPW + rg];
#pragma unroll
      for (int t = 0; t < NV; ++t)
        widen(ks + (j * RPW + rg) * DH + (t * LPR + sub) * VEC, kx + t * VEC, k_sc, to_bf16);
#pragma unroll
      for (int g = 0; g < GQM; ++g) {
        pd[j][g] = 0.f;
        if (!PAD || g < gq) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) pd[j][g] = fmaf(qr[g][e], kx[e], pd[j][g]);
        }
      }
    }
    // reduce over the row's LPR lanes, transposed: at each of the first TL
    // levels a lane keeps half of its rows and adds its partner's half of
    // them, so the rows end up spread over the lanes (JF a lane) instead of
    // every lane summing every row; plain levels finish the sums
#pragma unroll
    for (int lvl = 0; lvl < TL; ++lvl) {
      const int off = LPR >> (lvl + 1), half = STEPS >> (lvl + 1);
      const bool upper = sub & off;
#pragma unroll
      for (int j = 0; j < half; ++j)
#pragma unroll
        for (int g = 0; g < GQM; ++g) {
          if (PAD && g >= gq) continue;
          const float lo = pd[j][g], hi = pd[j + half][g];
          pd[j][g] = (upper ? hi : lo) + __shfl_xor_sync(FULL, upper ? lo : hi, off);
        }
    }
#pragma unroll
    for (int off = DUP / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < JF; ++j)
#pragma unroll
        for (int g = 0; g < GQM; ++g) pd[j][g] += __shfl_xor_sync(FULL, pd[j][g], off);

    // online softmax over sub-tiles: the sub-tile's max over every lane,
    // the running state rescaled once, one exp per (row, head); rows outside
    // [first, rows) (below the window, past the copied count) get p = 0
    const int j0 = (sub / DUP) * JF;                  // this lane's first row index
    float mt[GQM];
#pragma unroll
    for (int g = 0; g < GQM; ++g) {
      mt[g] = -INFINITY;
#pragma unroll
      for (int j = 0; j < JF; ++j) {
        const int r = (j0 + j) * RPW + rg;
        const bool live = r >= first && r < rows;
        if (softcap > 0.f)
          pd[j][g] = live ? softcap * tanhf(pd[j][g] * inv_sqrt_dh / softcap) * LOG2E : -INFINITY;
        else
          pd[j][g] = live ? pd[j][g] * scale : -INFINITY;
        mt[g] = fmaxf(mt[g], pd[j][g]);
      }
#pragma unroll
      for (int off = DUP; off < 32; off <<= 1) mt[g] = fmaxf(mt[g], __shfl_xor_sync(FULL, mt[g], off));
      const float m_new = fmaxf(m_run[g], mt[g]);
      const float alpha = exp2f(m_run[g] - m_new);
      m_run[g] = m_new;
      l_run[g] *= alpha;
      if (i > 0) {                     // acc is still 0 on the first sub-tile
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < JF; ++j) {
        pd[j][g] = exp2f(pd[j][g] - m_new);
        l_run[g] += pd[j][g];
      }
    }
    if (sub % DUP == 0) {
#pragma unroll
      for (int j = 0; j < JF; ++j)
#pragma unroll
        for (int g = 0; g < GQM; ++g) p_s[warp][(j0 + j) * RPW + rg][g] = pd[j][g];
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = j * RPW + rg;
      if (r >= first && r < rows) {
        float vx[EPL], w[GP];
        float v_sc = 0.f;
        if constexpr (I8) v_sc = sc_s[warp][stage][1][r];
#pragma unroll
        for (int t = 0; t < NV; ++t)
          widen(vs + r * DH + (t * LPR + sub) * VEC, vx + t * VEC, v_sc, to_bf16);
#pragma unroll
        for (int h = 0; h < GP; h += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&p_s[warp][r][h]);
          w[h] = x.x;
          w[h + 1] = x.y;
          w[h + 2] = x.z;
          w[h + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < GQM; ++g)
          if (!PAD || g < gq) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w[g], vx[e], acc[g][e]);
          }
      }
    }
    __syncwarp();                      // every lane is done with this stage
    if (i + n_stages < mine) {
      if (lane == 0) fence_proxy_async();
      fetch(i + n_stages);
    }
  }

  // the warp's row groups: lanes with equal `sub` hold the same columns
  // l: each lane summed its own rows, DUP lanes alike, so sum over the rest
#pragma unroll
  for (int g = 0; g < GQM; ++g) {
#pragma unroll
    for (int off = DUP; off < 32; off <<= 1) l_run[g] += __shfl_xor_sync(FULL, l_run[g], off);
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
  }

  // ---- end of chunk: the warps, in warp order, through shared memory ------
  fence_proxy_async();
  __syncthreads();                     // every ring is drained; reuse it
  float* red_acc = reinterpret_cast<float*>(smem);   // [WARPS][GQM][DH]
  float* red_m = red_acc + WARPS * GQM * DH;         // [WARPS][GQM]
  float* red_l = red_m + WARPS * GQM;
  if (rg == 0) {                       // a lane's columns come in runs of VEC
#pragma unroll
    for (int g = 0; g < GQM; ++g)
#pragma unroll
      for (int e = 0; e < EPL; e += 4)
        *reinterpret_cast<float4*>(red_acc + (warp * GQM + g) * DH + (e / VEC * LPR + sub) * VEC +
                                   e % VEC) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GQM; ++g) {
      red_m[warp * GQM + g] = m_run[g];
      red_l[warp * GQM + g] = l_run[g];
    }
  }
  __syncthreads();
  // one thread per head: the chunk's max, each warp's weight, the chunk's l
  if (tid < ng) {
    float m = red_m[tid];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_m[w * GQM + tid]);
    float l = 0.f;
    for (int w = 0; w < WARPS; ++w) {        // a warp with no sub-tile has m = -inf
      const float e = exp2f(red_m[w * GQM + tid] - m);
      red_m[w * GQM + tid] = e;
      l += red_l[w * GQM + tid] * e;
    }
    red_l[tid] = l;                          // warp 0's slot, read below
    chunk_m[tid] = m;
  }
  __syncthreads();

  // partials of the whole grid: m and l each padded to whole float4s, so
  // that acc starts 16-byte aligned whatever B * KV * n_chunks * gq is
  const size_t ml = ((size_t)B * KV * n_chunks * ng + 3) / 4 * 4;
  float* part_m = part;
  float* part_l = part + ml;
  float* part_acc = part + 2 * ml;
  const size_t pc = bk * n_chunks;                     // this row's first partial
  for (int i = tid; i < ng * DH / 4; i += THREADS) {  // four columns a thread
    const int g = i / (DH / 4), d = i % (DH / 4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = red_m[w * GQM + g];
      const float4 x = *reinterpret_cast<const float4*>(red_acc + (w * GQM + g) * DH + d);
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    if (nc == 1) {
      const float l = fmaxf(red_l[g], 1e-30f);
      reinterpret_cast<float4*>(outb)[i] = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
    } else {
      reinterpret_cast<float4*>(part_acc + (pc + c) * ng * DH)[i] = a;
    }
  }
  if (nc > 1 && tid < ng) {
    part_m[(pc + c) * ng + tid] = chunk_m[tid];
    part_l[(pc + c) * ng + tid] = red_l[tid];
  }
  if (nc == 1) return;

  // ---- arrival: the row's last block combines its chunks in chunk order ---
  // The barrier orders every thread's partial before thread 0's release;
  // its acquire, then the barrier, orders the other chunks' partials before
  // this block's reads of them.
  __syncthreads();
  if (tid == 0) is_last = arrive(counters + bk) == nc - 1;
  __syncthreads();
  if (!is_last) return;
  constexpr int BATCH = 16;
  const size_t pl = pc + c_lo;                         // the row's first live partial
  const float4* acc4 = reinterpret_cast<const float4*>(part_acc + pl * ng * DH);
  const size_t stride = (size_t)ng * DH / 4;           // one chunk's partial
  // this thread's first BATCH chunks' loads go out now and land while the
  // weights are made; loads are unconditional (a batch past the last chunk
  // re-reads it), so the compiler keeps all BATCH in flight
  float4 x[BATCH];
  if (tid < ng * DH / 4) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) x[j] = __ldcg(acc4 + tid + min(j, nc - 1) * stride);
  }
  // per (chunk, head): m into shared memory, then its weight exp2(m - max);
  // one thread per head takes the max and the l sum in chunk order
  float* w_s = red_acc;                                // [nc][ng]
  float* l_s = red_acc + MAX_CHUNKS * GQM;             // [nc][ng]
  float* inv_s = l_s + MAX_CHUNKS * GQM;               // [ng]
  for (int i = tid; i < nc * ng; i += THREADS) {
    w_s[i] = __ldcg(part_m + pl * ng + i);
    l_s[i] = __ldcg(part_l + pl * ng + i);
  }
  __syncthreads();
  if (tid < ng) {
    float m = -INFINITY, l = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc) m = fmaxf(m, w_s[cc * ng + tid]);
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc) {
      const float e = exp2f(w_s[cc * ng + tid] - m);
      w_s[cc * ng + tid] = e;
      l += l_s[cc * ng + tid] * e;
    }
    inv_s[tid] = l;
  }
  __syncthreads();
  // acc: four columns a thread, BATCH live chunks at a time, summed in chunk order
  for (int i = tid; i < ng * DH / 4; i += THREADS) {
    const int g = i / (DH / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nc; c0 += BATCH) {
      if (i != tid || c0 != 0) {
#pragma unroll
        for (int j = 0; j < BATCH; ++j) x[j] = __ldcg(acc4 + i + min(c0 + j, nc - 1) * stride);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (c0 + j < nc) {
          const float e = w_s[(c0 + j) * ng + g];
          a.x += x[j].x * e;
          a.y += x[j].y * e;
          a.z += x[j].z * e;
          a.w += x[j].w * e;
        }
      }
    }
    const float l = fmaxf(inv_s[g], 1e-30f);
    reinterpret_cast<float4*>(outb)[i] = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
  }
  if (tid == 0) counters[bk] = 0;      // ready for the next call
}

// The kernel's launch arguments past the element pointers, passed through
// the dispatch on dh and the group size.
struct Args {
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  int B, KV, KVC, kv0, S, gq, chunk, n_chunks, window;
  float softcap;
  bool to_bf16;
  float* part;
  int* counters;
  float* out;
  cudaStream_t stream;
};

template <typename T, int DH, int GQM, bool PAD>
int launch(const float* q, const T* k, const T* v, const Args& a) {
  constexpr int R = sub_rows(DH, tile_elem<T>());
  constexpr int STAGE = 2 * R * DH * (int)sizeof(T);
  const int passes = a.chunk / (WARPS * R);
  const int n_stages = passes < max_stages<T>() ? passes : max_stages<T>();
  const size_t ring = (size_t)WARPS * n_stages * STAGE;
  const size_t red_warps = (size_t)WARPS * GQM * DH + 2 * WARPS * GQM;
  const size_t red_chunks = (size_t)2 * MAX_CHUNKS * GQM + GQM;
  const size_t red = (red_warps > red_chunks ? red_warps : red_chunks) * sizeof(float);
  const size_t smem = ring > red ? ring : red;
  auto kernel = decode_attention_kernel<T, DH, GQM, PAD>;
  static size_t allowed = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kernel<<<dim3(a.n_chunks, a.KV, a.B), THREADS, smem, a.stream>>>(
      q, k, v, a.k_scale, a.v_scale, a.lengths, a.B, a.KV, a.KVC, a.kv0, a.S, a.gq, a.chunk,
      a.n_chunks, a.window, a.softcap, a.to_bf16, n_stages, a.part, a.counters, a.out);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_gq(const float* q, const T* k, const T* v, const Args& a) {
#define DECODE_LAUNCH(G, P) launch<T, DH, G, P>(q, k, v, a)
  switch (a.gq) {
    case 1: return DECODE_LAUNCH(1, false);
    case 2: return DECODE_LAUNCH(2, false);
    case 4: return DECODE_LAUNCH(4, false);
    case 5: return DECODE_LAUNCH(5, false);
    case 8: return DECODE_LAUNCH(8, false);
    case 16: return DECODE_LAUNCH(16, false);
    default: return a.gq < 8 ? DECODE_LAUNCH(8, true) : DECODE_LAUNCH(16, true);
  }
#undef DECODE_LAUNCH
}

template <typename T>
int decode_attention(const float* q, const T* k, const T* v, int dh, const Args& a) {
  if (a.B < 1 || a.B > 65535 || a.KV < 1 || a.KV > 65535 || a.kv0 < 0 || a.KVC < a.kv0 + a.KV ||
      a.S < 1 || a.gq < 1 || a.gq > 16 ||
      a.window < 1 || !(a.softcap >= 0.f && a.softcap <= 3.4e38f) ||
      (dh != 32 && dh != 64 && dh != 128 && dh != 256) ||
      a.chunk != chunk_positions(a.S, dh, tile_elem<T>()) ||
      a.n_chunks != (a.S + a.chunk - 1) / a.chunk || a.n_chunks > MAX_CHUNKS ||
      (sizeof(T) == 1) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (dh) {
#define DECODE_DH(D) launch_gq<T, D>(q, k, v, a)
    case 32: return DECODE_DH(32);
    case 64: return DECODE_DH(64);
    case 128: return DECODE_DH(128);
    default: return DECODE_DH(256);
#undef DECODE_DH
  }
}

}  // namespace

// q (B, KV, gq, dh) f32: the KV heads kv0 .. kv0 + KV - 1 of k/v (B, KVC, S,
// dh), 16-byte aligned, read in place (kv0 = 0 and KVC = KV: the whole
// cache); lengths (B,) i32; chunk = chunk_positions(S, dh, sizeof(elem)) and
// n_chunks = ceil(S / chunk); window >= 1 (S or more = full attention);
// softcap >= 0 (0 = none); part: 2 * ceil4(B*KV*n_chunks*gq) +
// B*KV*n_chunks*gq*dh f32; counters (B, KV) i32, zero on entry and left zero;
// out (B, KV, gq, dh) f32.  All contiguous on one device.  Launches one kernel
// on `stream` without synchronising; returns cudaGetLastError().
#ifndef DECODE_ATTENTION_INT8
extern "C" int decode_attention_f32(const float* q, const float* k, const float* v,
                                    const int* lengths, int B, int KV, int KVC, int kv0,
                                    int S, int gq, int dh, int chunk, int n_chunks, int window,
                                    float softcap, float* part, int* counters, float* out,
                                    void* stream) {
  const Args a{nullptr, nullptr, lengths, B, KV, KVC, kv0, S, gq, chunk, n_chunks, window,
               softcap, false, part, counters, out, static_cast<cudaStream_t>(stream)};
  return decode_attention<float>(q, k, v, dh, a);
}

extern "C" int decode_attention_bf16(const float* q, const void* k, const void* v,
                                     const int* lengths, int B, int KV, int KVC, int kv0,
                                     int S, int gq, int dh, int chunk, int n_chunks, int window,
                                     float softcap, float* part, int* counters, float* out,
                                     void* stream) {
  const Args a{nullptr, nullptr, lengths, B, KV, KVC, kv0, S, gq, chunk, n_chunks, window,
               softcap, false, part, counters, out, static_cast<cudaStream_t>(stream)};
  return decode_attention<__nv_bfloat16>(q, static_cast<const __nv_bfloat16*>(k),
                                         static_cast<const __nv_bfloat16*>(v), dh, a);
}

#else
// int8 k/v (B, KVC, S, dh) with f32 k_scale/v_scale (B, KVC, S); chunk =
// chunk_positions(S, dh, 2), bf16's; to_bf16 != 0 rounds each dequantized
// value to bf16 (a bf16 model), 0 keeps it fp32.  Otherwise as above.
extern "C" int decode_attention_int8(const float* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale,
                                     const int* lengths, int B, int KV, int KVC, int kv0,
                                     int S, int gq, int dh, int chunk, int n_chunks, int window,
                                     float softcap, int to_bf16, float* part, int* counters,
                                     float* out, void* stream) {
  const Args a{k_scale, v_scale, lengths, B, KV, KVC, kv0, S, gq, chunk, n_chunks, window,
               softcap, to_bf16 != 0, part, counters, out, static_cast<cudaStream_t>(stream)};
  return decode_attention<int8_t>(q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                                  dh, a);
}
#endif
