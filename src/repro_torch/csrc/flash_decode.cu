// Flash decode: one query token per (batch, kv head) against a KV cache.
//
// Replaces the TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode/kernel.py, `_decode_body`).
// For batch b and kv head h, with the G query heads that share h:
//   s[g, t] = q[g] . k[t] / sqrt(D)       (capped: c * tanh(s / c) if c > 0)
//   s[g, t] = -1e30 where valid[b, t] == 0
//   out[g]  = softmax_t(s[g]) . v
// q (B, KV, G, D) f32; k, v (B, T, KV, D) f32 or bf16; valid (B, T) int32;
// out (B, KV, G, D) f32; any T >= 1, G <= 16, D <= 256 with D % 8 == 0 (a
// cache row is whole 16-byte chunks) and k, v 16-byte aligned.
//
// Bound on the H100: device-memory bytes.  Every cache row is read once and
// does 2 * G multiply-adds per element it brings in, far below the card's
// operations-per-byte line; the work is reading k and v.
//
// Design: split-KV flash decoding in one launch.  The TPU kernel walks the
// cache of one (batch, kv head) in order on one core; here the cache of each
// (batch, kv head) is cut into n_split ranges of whole tiles, one block
// each, the grid one wave of blocks (the wrapper's `split_plan`).  A block
// walks its range with the online softmax.  Its k and v tiles arrive in a
// ring of NSTAGE stages, completing on an mbarrier per stage, so that two
// tiles are in flight while the block works on a third: where a tile's rows
// are contiguous on both sides (one kv head, unpadded rows) one bulk copy
// each for k and v (cp.async.bulk, the copy engine behind TMA: no thread
// spends instructions on the copy), else 16-byte cp.async by every thread
// (a bulk copy per row is slower: the engine pays per copy).  Each warp
// keeps its own running softmax state over its rows of every tile (no block
// barrier inside a tile); the warps are merged at the end.  The partials (m, l, acc) of the
// splits are combined in the same launch, weighed by exp(m_s - M).  Up to
// MAX_CLUSTER splits of a cache run as one thread block cluster: each block
// combines a slice of the output from the partials in the others' shared
// memory.  More splits (a long cache at a batch of a few) write their
// partials to device memory, and the last block of the (batch, kv head) to
// finish, found by an arrival counter that it resets to 0 for the next
// call, combines them.  The counters are scratch the wrapper keeps per
// device and stream (launches on one stream run in order; another stream
// gets its own counters).  With one split the block writes the output.
//
// Two kernels compute a tile:
// - `fma_kernel` (f32 caches, and bf16 caches whose D is not 64, 96, 128 or
//   256): tiles of 32 rows, 8 warps of 4 rows each.  A lane holds DPL = 8
//   dims (lane + 32 j, those below D) of q, of its rows of k and v and of
//   the accumulators: one instance serves every D, a dim past D skipped by
//   a runtime test.  The 4 G partial dot products of a warp are summed by a
//   reduce-scatter over the lanes (4 G - 1 shuffles, not 5 each) and shared
//   again by 4 G shuffles, and every lane runs the softmax of the warp's
//   rows itself.
//   G is rounded up to a power of two at compile time (GC; the extra query
//   rows are zeros).  f32 stays on the FMA units: TF32 tensor cores would not
//   hold 1e-5.
// - `mma_kernel` (bf16 caches): tiles of 64 rows, 4 warps of 16 rows.  The
//   scores S (16 heads x 8 rows) and the output O^T (16 dims x 8 heads) are
//   warp MMAs (mma.sync m16n8k16, bf16 in, f32 accumulate): S = Q K^T with
//   the heads in the MMA's 16 rows, so that S's accumulator fragment is the
//   B operand of O^T += V^T P^T without a shuffle; k and v come out of
//   shared memory by ldmatrix (v transposed).  For D = 64, 128 and 256 the
//   tiles arrive by the tensor copy (cp.async.bulk.tensor over a 4-d map of
//   the cache, one thread issuing D / 64 boxes each for k and v) in the
//   128-byte swizzle, which puts the 8 rows an ldmatrix reads on distinct
//   banks; at D = 96 rows padded by 16 bytes do the same, filled by
//   cp.async.  q and p are f32: each is split as hi + lo, two bf16
//   numbers, and multiplied twice, so the scores and the weights keep
//   about 16 bits more than one bf16 rounding (the 1e-4 band), at twice
//   the MMAs, which are not the limit.
//
// Masking keeps the reference's finite -1e30: a range with no valid row
// gives m = -1e30 and p = exp(0) = 1 on its rows, and any range with a valid
// row outweighs it in the combine by exp(-1e30 - M) = 0, as a later valid
// block cancels an early masked one in the TPU kernel (alpha = 0).  With no
// valid row in the whole cache every split has m = -1e30 and the output is
// the mean of v, as in the reference.  Rows past the range score -inf
// (p = 0, no part in the max); in shared memory they hold zeros or the
// cache's next rows (finite, as the reference needs them too).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NSTAGE = 3;               // tiles in the ring
constexpr int MAXG = 16;                // query heads per kv head
constexpr int MAXD = 256;               // head_dim
constexpr int MAX_SPLIT = 1024;         // ranges per (batch, kv head)
constexpr int MAX_CLUSTER = 8;          // splits combined in a cluster
constexpr float NEG_INF = -1e30f;
// fma_kernel
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 32;                  // cache rows per tile
constexpr int RW = BT / WARPS;          // rows a warp takes of each tile
constexpr int DPL = MAXD / 32;          // dims a lane holds (those < D)
// mma_kernel
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BTM = 16 * MMA_WARPS;     // cache rows per tile, 16 a warp

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int32_t* valid;
  float* m_part;        // (B KV, n_split, G)
  float* l_part;        // (B KV, n_split, G)
  float* acc_part;      // (B KV, n_split, G, D)
  int32_t* counters;    // (B KV,), 0 between calls
  float* out;           // (B, KV, G, D)
  int T, KVH, G, D, n_split, split_rows;
  float scale, softcap;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A score in the kernels' units: capped as the reference caps it, then
// times log2(e), so that every exponential is one exp2f (the running max,
// the combine's weights and the mask's -1e30 live in those units too).
__device__ __forceinline__ float score_log2(float s, float softcap) {
  constexpr float LOG2E = 1.4426950408889634f;
  return (softcap > 0.0f ? softcap * tanhf(s / softcap) : s) * LOG2E;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// the copy ring: bulk copies completing on an mbarrier per stage
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes global -> shared by the copy engine, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A (64 x 1 x BTM x 1) box of a 4-d tensor map (D, KV, T, B) to shared
// memory by the copy engine, counted on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes global -> shared by cp.async; ``bytes`` 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One tile into a stage: rows [t0, t0 + nt) of k and v (global row stride
// gstride bytes, row_bytes each) to shared rows of sstride bytes; rows
// nt..tile_rows-1 are zeroed, so that p = 0 never meets a stale NaN.
// Where the rows are contiguous on both sides (one kv head, unpadded) warp
// 0 issues one bulk copy each for k and v (the stage's mbarrier counts 1
// arrival and the bytes); else every thread copies 16-byte chunks by
// cp.async and arrives on the mbarrier when they land (it counts the
// block's threads).
__device__ __forceinline__ void issue_tile(bool bulk, char* ks, char* vs,
                                           const char* kg, const char* vg,
                                           long long gstride, int row_bytes,
                                           int sstride, int nt,
                                           int tile_rows, uint64_t* bar) {
  const int chunks = row_bytes / 16;
  if (!bulk) {
    for (int c = threadIdx.x; c < tile_rows * chunks; c += blockDim.x) {
      const int r = c / chunks, j = c - r * chunks;
      const bool in = r < nt;
      const long long off = (long long)(in ? r : 0) * gstride + 16 * j;
      cp_async16(ks + r * sstride + 16 * j, kg + off, in ? 16 : 0);
      cp_async16(vs + r * sstride + 16 * j, vg + off, in ? 16 : 0);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
    return;
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect(bar, 2u * nt * row_bytes);
    bulk_copy(ks, kg, nt * row_bytes, bar);
    bulk_copy(vs, vg, nt * row_bytes, bar);
  }
  if (nt < tile_rows) {
    for (int e = lane; e < (tile_rows - nt) * chunks; e += 32) {
      const int r = nt + e / chunks, c = e % chunks;
      *reinterpret_cast<uint4*>(ks + r * sstride + 16 * c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vs + r * sstride + 16 * c) = make_uint4(0, 0, 0, 0);
    }
    // order these writes before later bulk copies into the same rows
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// the end of a block: its warps merged, its partial out, and the combine by
// the last block
// ---------------------------------------------------------------------------

// pm, pl (G,) and pacc (G, D): this block's partial, in shared memory; wbuf
// shared scratch for n_split * G floats.  With one split the partial is the
// output; with a cluster the blocks combine it in place; else it goes to
// the scratch arrays, and the last block of (batch, kv head) bh to arrive
// combines them all:
//   out[g, d] = sum_s exp(m_s - M) acc_s[g, d] / sum_s exp(m_s - M) l_s.
template <bool CLUSTER>
__device__ void finish(const Args& a, float* pm, float* pl, float* pacc,
                       float* wbuf, int bh, int split) {
  const int G = a.G, D = a.D, ns = a.n_split, tid = threadIdx.x;
  const int nthr = blockDim.x;
  float* outb = a.out + (long long)bh * G * D;
  if (ns == 1) {
    for (int e = tid; e < G * D; e += nthr)
      outb[e] = pacc[e] / fmaxf(pl[e / D], 1e-30f);
    return;
  }
  if constexpr (CLUSTER) {
    // the splits of this cache are the blocks of one cluster: each block
    // combines a slice of the output from the partials in the others'
    // shared memory (no device-memory round trip, no fence, no counter)
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ float cw[MAX_CLUSTER][MAXG], cs[MAX_CLUSTER][MAXG], cls[MAXG];
    cluster.sync();                          // every partial is written
    for (int e = tid; e < ns * G; e += nthr) {   // one remote load each
      const int r = e / G, g = e - r * G;
      cw[r][g] = *cluster.map_shared_rank(pm + g, r);
      cs[r][g] = *cluster.map_shared_rank(pl + g, r);
    }
    __syncthreads();
    for (int g = tid; g < G; g += nthr) {
      float mx = NEG_INF;
      for (int r = 0; r < ns; ++r) mx = fmaxf(mx, cw[r][g]);
      float l = 0.0f;
      for (int r = 0; r < ns; ++r) {
        cw[r][g] = exp2f(cw[r][g] - mx);      // now the split's weight
        l = fmaf(cw[r][g], cs[r][g], l);
      }
      cls[g] = fmaxf(l, 1e-30f);
    }
    __syncthreads();
    const int chunk = (G * D + ns - 1) / ns;
    const int e_end = min(G * D, (split + 1) * chunk);
    for (int e = split * chunk + tid; e < e_end; e += nthr) {
      const int g = e / D;
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)    // the loads in flight at once
        v[r] = r < ns ? *cluster.map_shared_rank(pacc + e, r) : 0.0f;
      float o = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < ns) o = fmaf(cw[r][g], v[r], o);
      outb[e] = o / cls[g];
    }
    cluster.sync();                          // the others are done reading
    return;
  }
  const long long ps = (long long)bh * ns + split;
  for (int g = tid; g < G; g += nthr) {
    a.m_part[ps * G + g] = pm[g];
    a.l_part[ps * G + g] = pl[g];
  }
  for (int e = tid; e < G * D; e += nthr) a.acc_part[ps * G * D + e] = pacc[e];
  __shared__ int is_last;
  __shared__ float cm[MAXG], cl[MAXG];
  __threadfence();                 // the partial is visible before arriving
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.counters + bh, 1) == ns - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();                 // and the others' before reading them
  if (tid == 0) a.counters[bh] = 0;          // ready for the next call
  const float* mp = a.m_part + (long long)bh * ns * G;
  const float* lp = a.l_part + (long long)bh * ns * G;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  for (int g = warp; g < G; g += nwarps) {
    float mx = NEG_INF;
    for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, __ldcg(mp + s * G + g));
    mx = warp_max(mx);
    float l = 0.0f;
    for (int s = lane; s < ns; s += 32)
      l = fmaf(exp2f(__ldcg(mp + s * G + g) - mx), __ldcg(lp + s * G + g), l);
    l = warp_sum(l);
    if (lane == 0) {
      cm[g] = mx;
      cl[g] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  for (int e = tid; e < ns * G; e += nthr)
    wbuf[e] = exp2f(__ldcg(mp + e) - cm[e % G]);
  __syncthreads();
  const float* acc = a.acc_part + (long long)bh * ns * G * D;
  for (int e = tid; e < G * D; e += nthr) {
    const int g = e / D;
    float o = 0.0f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s)
      o = fmaf(wbuf[s * G + g], __ldcg(acc + (long long)s * G * D + e), o);
    outb[e] = o / cl[g];
  }
}

// The warps' states (wm, wl (NW, GC); wacc (NW, GC, D), in shared memory)
// merged into the block's partial and finished.  ``smem`` is the block's
// shared memory past the states, free for the partial and the weights.
template <int NW, int GC, bool CLUSTER>
__device__ void merge_and_finish(const Args& a, float* wm, const float* wl,
                                 const float* wacc, float* smem_free, int bh,
                                 int split) {
  const int G = a.G, D = a.D, tid = threadIdx.x, nthr = blockDim.x;
  float* pm = smem_free;           // (GC,)
  float* pl = pm + GC;             // (GC,)
  float* pacc = pl + GC;           // (G, D)
  for (int g = tid; g < G; g += nthr) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * GC + g]);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = exp2f(wm[w * GC + g] - mx);
      wm[w * GC + g] = e;                      // now the warp's weight
      l = fmaf(e, wl[w * GC + g], l);
    }
    pm[g] = mx;
    pl[g] = l;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += nthr) {
    const int g = e / D, d = e - g * D;
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      o = fmaf(wm[w * GC + g], wacc[(w * GC + g) * D + d], o);
    pacc[e] = o;
  }
  __syncthreads();
  finish<CLUSTER>(a, pm, pl, pacc, pacc + G * D, bh, split);
}

// shared bytes of the end phase: the warps' states, the partial, weights
template <int NW, int GC>
size_t end_bytes(int D, int n_split) {
  return (size_t)(NW * GC * (D + 2) + 2 * GC + GC * D + n_split * GC) *
         sizeof(float);
}

// ---------------------------------------------------------------------------
// fma_kernel: f32 caches (and bf16 at other head dims)
// ---------------------------------------------------------------------------

// Sums v[i] over the 32 lanes and leaves them spread: for N <= 32, lane l
// holds in v[0] the sum of index l >> (5 - log2 N); for N = 64, v[0] and
// v[1] hold indices 2 l and 2 l + 1.  N - 1 (+ 5 - log2 N) shuffles.
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int lv = 0; lv < 5; ++lv) {
    const int o = 16 >> lv;
    constexpr int kMax = N;
    const int cnt = kMax >> lv;              // values still held
    if (cnt >= 2) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < cnt / 2) {
          const float send = up ? v[i] : v[i + cnt / 2];
          const float keep = up ? v[i + cnt / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// log2 of a power of two up to 64, at compile time
__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// Shared memory, in bytes: NSTAGE stages of k and v tiles (BT rows of D,
// unpadded: a lane reads dims lane + 32 j), the stages' mbarriers, q (GC, D)
// when it does not stay in registers; the end phase reuses it all.
template <typename KV, int GC>
size_t fma_smem_bytes(int D, int n_split) {
  const size_t ring = 2 * (size_t)NSTAGE * BT * D * sizeof(KV) +
                      NSTAGE * sizeof(uint64_t) +
                      (size_t)GC * D * sizeof(float);
  const size_t end = end_bytes<WARPS, GC>(D, n_split);
  return ring > end ? ring : end;
}

// GC = G rounded up to a power of 2.
template <typename KV, int GC, bool CLUSTER>
__global__ void __launch_bounds__(THREADS) fma_kernel(
    Args a, const __grid_constant__ CUtensorMap, const __grid_constant__ CUtensorMap) {
  constexpr int N = RW * GC;                     // partial sums of a step
  constexpr int HOLD = N > 32 ? N / 32 : 1;      // sums a lane holds after
  constexpr int SHIFT = N > 32 ? 0 : 5 - ilog2(N);
  constexpr bool QREG = GC * DPL <= 32;          // q in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, KVH = a.KVH, G = a.G, D = a.D;
  const int tile = BT * D;                       // elements of one k tile
  KV* kv_s = reinterpret_cast<KV*>(smem);        // [stage][k | v][BT][D]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * NSTAGE * tile);
  float* q_s = reinterpret_cast<float*>(bars + NSTAGE);  // (GC, D)

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / KVH, h = bh - b * KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long gstride = (long long)KVH * D * sizeof(KV);
  const char* kb = static_cast<const char*>(a.k) +
                   ((long long)b * T * KVH + h) * D * sizeof(KV);
  const char* vb = static_cast<const char*>(a.v) +
                   ((long long)b * T * KVH + h) * D * sizeof(KV);
  const int32_t* valid_b = a.valid + (long long)b * T;
  const int row_bytes = D * (int)sizeof(KV);

  const int t_begin = split * a.split_rows;
  const int t_end = min(T, t_begin + a.split_rows);
  const int n_tiles = (t_end - t_begin + BT - 1) / BT;
  const bool bulk = KVH == 1;        // rows contiguous: a copy a tile
  auto issue = [&](int i) {
    if (bulk && warp != 0) return;
    const int t0 = t_begin + i * BT, st = i % NSTAGE;
    char* ks = reinterpret_cast<char*>(kv_s + 2 * st * tile);
    issue_tile(bulk, ks, ks + tile * sizeof(KV), kb + t0 * gstride,
               vb + t0 * gstride, gstride, row_bytes, row_bytes,
               min(BT, t_end - t0), BT, bars + st);
  };

  if (tid == 0) {
    for (int st = 0; st < NSTAGE; ++st) mbar_init(bars + st, bulk ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < NSTAGE - 1 && i < n_tiles; ++i) issue(i);
  const float* qb = a.q + (long long)bh * G * D;
  float qr[QREG ? GC : 1][QREG ? DPL : 1];
  if (QREG) {
#pragma unroll
    for (int g = 0; g < (QREG ? GC : 1); ++g)
#pragma unroll
      for (int j = 0; j < (QREG ? DPL : 1); ++j) {
        const int d = lane + 32 * j;
        qr[g][j] = g < G && d < D ? qb[g * D + d] : 0.0f;
      }
  } else {
    for (int e = tid; e < GC * D; e += THREADS)
      q_s[e] = e < G * D ? qb[e] : 0.0f;
  }
  __syncthreads();

  // this warp's state over its rows [RW warp, RW warp + RW) of every tile
  float m_run[GC], l_run[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }
  const int r0 = RW * warp;
  // the validity of the rows whose sums this lane holds, a tile ahead (a
  // load from device memory must not wait inside the tile's work): -1 past
  // the range, else valid > 0
  auto row_valid = [&](int i, int e) {
    const int idx = N > 32 ? HOLD * lane + e : lane >> SHIFT;
    const int t = t_begin + i * BT + r0 + idx / GC;
    return t >= t_end ? -1 : (valid_b[t] > 0 ? 1 : 0);
  };
  int vcur[HOLD], vnext[HOLD];
#pragma unroll
  for (int e = 0; e < HOLD; ++e) vcur[e] = vnext[e] = row_valid(0, e);

  for (int i = 0; i < n_tiles; ++i) {
    if (i + NSTAGE - 1 < n_tiles) issue(i + NSTAGE - 1);
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int e = 0; e < HOLD; ++e) vnext[e] = row_valid(i + 1, e);
    }
    mbar_wait(bars + i % NSTAGE, (i / NSTAGE) & 1);
    const KV* ks = kv_s + 2 * (i % NSTAGE) * tile + r0 * D;
    const KV* vs = ks + tile;
    // partial dot products of this lane's dims, i = r GC + g
    float part[N];
#pragma unroll
    for (int e = 0; e < N; ++e) part[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        float kd[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) kd[r] = to_f(ks[r * D + d]);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float qd = QREG ? qr[QREG ? g : 0][QREG ? j : 0]
                                : q_s[g * D + d];
#pragma unroll
          for (int r = 0; r < RW; ++r)
            part[r * GC + g] = fmaf(qd, kd[r], part[r * GC + g]);
        }
      }
    }
    reduce_scatter<N>(part, lane);
    // the sums this lane holds: scaled, capped, masked; rows past the range
    // -inf (p = 0, outside the max)
#pragma unroll
    for (int e = 0; e < HOLD; ++e) {
      const float s = score_log2(part[e] * a.scale, a.softcap);
      part[e] = vcur[e] < 0 ? -INFINITY : (vcur[e] ? s : NEG_INF);
      vcur[e] = vnext[e];
    }
    float sc[N];
#pragma unroll
    for (int e = 0; e < N; ++e)
      sc[e] = __shfl_sync(0xffffffffu, part[N > 32 ? e % HOLD : 0],
                          N > 32 ? e / HOLD : e << SHIFT);
    // the online softmax of the warp's rows, in every lane
    float alpha[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m_run[g];
#pragma unroll
      for (int r = 0; r < RW; ++r) mx = fmaxf(mx, sc[r * GC + g]);
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        sc[r * GC + g] = exp2f(sc[r * GC + g] - mx);
        sum += sc[r * GC + g];
      }
      alpha[g] = exp2f(m_run[g] - mx);
      l_run[g] = l_run[g] * alpha[g] + sum;
      m_run[g] = mx;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        float vd[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) vd[r] = to_f(vs[r * D + d]);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float x = acc[g][j] * alpha[g];
#pragma unroll
          for (int r = 0; r < RW; ++r) x = fmaf(sc[r * GC + g], vd[r], x);
          acc[g][j] = x;
        }
      }
    }
    __syncthreads();   // the stage is free for the copy a later turn issues
  }

  // the warps' states into shared memory (no copy is in flight), merged
  float* wm = reinterpret_cast<float*>(smem);          // (WARPS, GC)
  float* wl = wm + WARPS * GC;                         // (WARPS, GC)
  float* wacc = wl + WARPS * GC;                       // (WARPS, GC, D)
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == g) {         // the state is the same in every lane
      wm[warp * GC + g] = m_run[g];
      wl[warp * GC + g] = l_run[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) wacc[(warp * GC + g) * D + d] = acc[g][j];
    }
  }
  __syncthreads();
  merge_and_finish<WARPS, GC, CLUSTER>(a, wm, wl, wacc, wacc + WARPS * GC * D, bh,
                              split);
}

// ---------------------------------------------------------------------------
// mma_kernel: bf16 caches on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_elem, hi_elem);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo, each a bf16 pair, packed for the MMA
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: (16 x 16, row) bf16 times (16 x 8, col) bf16, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The MMA kernel's k and v tiles: with D a multiple of 64 (TMA), the tensor
// copy's 128-byte swizzle: 64-column segments of BTM rows of 128 bytes,
// the 16-byte chunk c of row r at c ^ (r % 8), so that the 8 rows an
// ldmatrix reads fall on distinct banks with no padding; else rows of
// D + 8 bf16 (16 bytes of padding do the same).
template <int ND>
struct MmaTile {
  static constexpr int D = 16 * ND;
  static constexpr bool TMA = ND % 4 == 0;
  static constexpr int BYTES = TMA ? BTM * D * 2 : BTM * (D + 8) * 2;
  // byte offset of 16-byte chunk cc (8 bf16) of row r
  __device__ static __forceinline__ int off(int r, int cc) {
    if constexpr (TMA)
      return (cc >> 3) * (BTM * 128) + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
    else
      return r * (D + 8) * 2 + cc * 16;
  }
};

// Shared memory, in bytes: (1 KiB of alignment for the swizzle) NSTAGE
// stages of k and v tiles, q's MMA fragments (ND, hi / lo, 32 lanes, 16
// bytes), then the stages' mbarriers; the end phase reuses it all.
template <int ND, int GC>
size_t mma_smem_bytes(int n_split) {
  constexpr int D = 16 * ND;
  const size_t ring = (MmaTile<ND>::TMA ? 1024 : 0) +
                      (size_t)NSTAGE * 2 * MmaTile<ND>::BYTES +
                      NSTAGE * sizeof(uint64_t) + (size_t)ND * 2 * 32 * 16;
  const size_t end = end_bytes<MMA_WARPS, GC>(D, n_split);
  return ring > end ? ring : end;
}

// ND = D / 16; GC = 8 (G <= 8: the heads 8-15 of the MMA rows are zeros and
// skipped) or 16.
template <int ND, int GC, bool CLUSTER>
__global__ void __launch_bounds__(MMA_THREADS) mma_kernel(
    Args a, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  constexpr int D = 16 * ND;
  constexpr int NB = GC / 8;                     // 8-head blocks of O^T
  using Tile = MmaTile<ND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, KVH = a.KVH, G = a.G;
  unsigned char* kv_s = smem;                    // [stage][k | v] tiles
  if constexpr (Tile::TMA)                       // the swizzle's alignment
    kv_s += (1024 - (smem_addr(smem) & 1023)) & 1023;
  uint4* qf = reinterpret_cast<uint4*>(kv_s + NSTAGE * 2 * Tile::BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(qf + ND * 2 * 32);

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / KVH, h = bh - b * KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long gstride = (long long)KVH * D * 2;
  const char* kb = static_cast<const char*>(a.k) +
                   ((long long)b * T * KVH + h) * D * 2;
  const char* vb = static_cast<const char*>(a.v) +
                   ((long long)b * T * KVH + h) * D * 2;
  const int32_t* valid_b = a.valid + (long long)b * T;

  const int t_begin = split * a.split_rows;
  const int t_end = min(T, t_begin + a.split_rows);
  const int n_tiles = (t_end - t_begin + BTM - 1) / BTM;
  // TMA: thread 0 asks the copy engine for the tile's 64-column segments
  // of k and v (rows past T arrive as zeros; rows past the range are read
  // and get p = 0); else every thread copies 16-byte chunks into padded
  // rows
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue = [&](int i) {
    const int t0 = t_begin + i * BTM, st = i % NSTAGE;
    char* ks = reinterpret_cast<char*>(kv_s + st * 2 * Tile::BYTES);
    if constexpr (Tile::TMA) {
      if (tid != 0) return;
      mbar_expect(bars + st, 2u * Tile::BYTES);
#pragma unroll
      for (int sg = 0; sg < D / 64; ++sg) {
        tma_load_4d(ks + sg * BTM * 128, mk, 64 * sg, h, t0, b, bars + st);
        tma_load_4d(ks + Tile::BYTES + sg * BTM * 128, mv, 64 * sg, h, t0,
                    b, bars + st);
      }
    } else {
      issue_tile(false, ks, ks + Tile::BYTES, kb + t0 * gstride,
                 vb + t0 * gstride, gstride, D * 2, (D + 8) * 2,
                 min(BTM, t_end - t0), BTM, bars + st);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < NSTAGE; ++st)
      mbar_init(bars + st, Tile::TMA ? 1 : MMA_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < NSTAGE - 1 && i < n_tiles; ++i) issue(i);
  // q as the A operand (16 heads x 16 dims a step), hi and lo parts:
  // a0 (head l/4, dims 2(l%4)..), a1 (head l/4 + 8), a2, a3 (dims + 8)
  const float* qb = a.q + (long long)bh * G * D;
  for (int e = tid; e < ND * 32; e += MMA_THREADS) {
    const int ks = e >> 5, ln = e & 31;
    const int g0 = ln >> 2, d0 = 16 * ks + 2 * (ln & 3);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + 8 * (j & 1), d = d0 + 8 * (j >> 1);
      const float x0 = g < G ? qb[g * D + d] : 0.0f;
      const float x1 = g < G ? qb[g * D + d + 1] : 0.0f;
      split_pack(x0, x1, hi[j], lo[j]);
    }
    qf[(ks * 2) * 32 + ln] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    qf[(ks * 2 + 1) * 32 + ln] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();

  // this warp's state; the heads of its score rows are hg = lane/4 (+ 8)
  float m_run[NB], l_run[NB];
  float acc[ND][NB][4];
#pragma unroll
  for (int hb = 0; hb < NB; ++hb) {
    m_run[hb] = NEG_INF;
    l_run[hb] = 0.0f;
#pragma unroll
    for (int mb = 0; mb < ND; ++mb)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mb][hb][j] = 0.0f;
  }
  const int r0 = 16 * warp;
  // ldmatrix: lane l gives row (l % 8) + 8 (l / 16), dims + 8 ((l / 8) % 2)
  const int lrow = r0 + (lane & 7) + 8 * (lane >> 4);
  const int lcol = 8 * ((lane >> 3) & 1);
  // the validity of this lane's score rows r0 + 8 nb + 2 (lane % 4) + j, a
  // tile ahead: -1 past the range, else valid > 0
  auto row_valid = [&](int i, int nb, int j) {
    const int t = t_begin + i * BTM + r0 + 8 * nb + 2 * (lane & 3) + j;
    return t >= t_end ? -1 : (valid_b[t] > 0 ? 1 : 0);
  };
  int vld[2][2], vnext[2][2];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) vld[nb][j] = vnext[nb][j] = row_valid(0, nb, j);

  for (int i = 0; i < n_tiles; ++i) {
    if (i + NSTAGE - 1 < n_tiles) issue(i + NSTAGE - 1);
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) vnext[nb][j] = row_valid(i + 1, nb, j);
    }
    mbar_wait(bars + i % NSTAGE, (i / NSTAGE) & 1);
    const unsigned char* ks = kv_s + (i % NSTAGE) * 2 * Tile::BYTES;
    const unsigned char* vs = ks + Tile::BYTES;
    // S (16 heads x 8 rows) for rows r0..r0+7 (sc[0]) and r0+8.. (sc[1])
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kst = 0; kst < ND; ++kst) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + Tile::off(lrow, 2 * kst + (lcol >> 3)));
      const uint4 qh = qf[(kst * 2) * 32 + lane];
      const uint4 ql = qf[(kst * 2 + 1) * 32 + lane];
      const uint32_t qh1 = NB > 1 ? qh.y : 0u, qh3 = NB > 1 ? qh.w : 0u;
      const uint32_t ql1 = NB > 1 ? ql.y : 0u, ql3 = NB > 1 ? ql.w : 0u;
      mma_bf16(sc[0], qh.x, qh1, qh.z, qh3, kf[0], kf[1]);
      mma_bf16(sc[0], ql.x, ql1, ql.z, ql3, kf[0], kf[1]);
      mma_bf16(sc[1], qh.x, qh1, qh.z, qh3, kf[2], kf[3]);
      mma_bf16(sc[1], ql.x, ql1, ql.z, ql3, kf[2], kf[3]);
    }
    // rows past the range score -inf (p = 0, outside the max), invalid
    // ones -1e30
    uint32_t ph[NB][2], pl[NB][2];
    float alpha[NB];
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
      float s[2][2], cmax = m_run[hb];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = score_log2(sc[nb][2 * hb + j] * a.scale, a.softcap);
          s[nb][j] = vld[nb][j] < 0 ? -INFINITY
                                    : (vld[nb][j] ? x : NEG_INF);
          cmax = fmaxf(cmax, s[nb][j]);
        }
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
      float p[2][2], sum = 0.0f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          p[nb][j] = exp2f(s[nb][j] - cmax);
          sum += p[nb][j];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hb] = exp2f(m_run[hb] - cmax);
      l_run[hb] = l_run[hb] * alpha[hb] + sum;
      m_run[hb] = cmax;
      // P^T as the B operand (16 rows x 8 heads): b0 rows 2(l%4).., b1 + 8
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        split_pack(p[nb][0], p[nb][1], ph[hb][nb], pl[hb][nb]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) vld[nb][j] = vnext[nb][j];
    // O^T (16 dims x 8 heads): this lane's columns are heads 2 (l%4) + j,
    // whose alpha the lanes 4 (2 (l%4) + j) hold
#pragma unroll
    for (int hb = 0; hb < NB; ++hb) {
      const float a0 = __shfl_sync(0xffffffffu, alpha[hb], 8 * (lane & 3));
      const float a1 = __shfl_sync(0xffffffffu, alpha[hb], 8 * (lane & 3) + 4);
#pragma unroll
      for (int mb = 0; mb < ND; ++mb) {
        acc[mb][hb][0] *= a0;
        acc[mb][hb][1] *= a1;
        acc[mb][hb][2] *= a0;
        acc[mb][hb][3] *= a1;
      }
    }
#pragma unroll
    for (int mb = 0; mb < ND; ++mb) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + Tile::off(lrow, 2 * mb + (lcol >> 3)));
#pragma unroll
      for (int hb = 0; hb < NB; ++hb) {
        mma_bf16(acc[mb][hb], vf[0], vf[1], vf[2], vf[3], ph[hb][0],
                 ph[hb][1]);
        mma_bf16(acc[mb][hb], vf[0], vf[1], vf[2], vf[3], pl[hb][0],
                 pl[hb][1]);
      }
    }
    __syncthreads();
  }

  // the warps' states into shared memory (no copy is in flight), merged
  float* wm = reinterpret_cast<float*>(smem);          // (WARPS, GC)
  float* wl = wm + MMA_WARPS * GC;                     // (WARPS, GC)
  float* wacc = wl + MMA_WARPS * GC;                   // (WARPS, GC, D)
#pragma unroll
  for (int hb = 0; hb < NB; ++hb) {
    if ((lane & 3) == 0) {
      wm[warp * GC + 8 * hb + (lane >> 2)] = m_run[hb];
      wl[warp * GC + 8 * hb + (lane >> 2)] = l_run[hb];
    }
#pragma unroll
    for (int mb = 0; mb < ND; ++mb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = 8 * hb + 2 * (lane & 3) + (j & 1);
        const int d = 16 * mb + (lane >> 2) + 8 * (j >> 1);
        wacc[(warp * GC + g) * D + d] = acc[mb][hb][j];
      }
  }
  __syncthreads();
  merge_and_finish<MMA_WARPS, GC, CLUSTER>(a, wm, wl, wacc,
                                  wacc + MMA_WARPS * GC * D, bh, split);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The kernel for (G, D, cache type), and for n_split 2..MAX_CLUSTER its
// cluster instance: calls fn(kernel, tile rows, threads, smem at n_split)
// on it.  Each kernel has both instances: the cluster code slows a kernel
// launched without a cluster (decode_32k, PERF.md §6).
template <bool CLUSTER, typename Fn>
cudaError_t dispatch_c(int G, int D, bool bf16, int n_split, Fn fn) {
  if (bf16 && (D == 64 || D == 96 || D == 128 || D == 256)) {
#define FD_MMA(ND, GC)                                                  \
  return fn(mma_kernel<ND, GC, CLUSTER>, BTM, MMA_THREADS,              \
            mma_smem_bytes<ND, GC>(n_split))
#define FD_MMA_G(ND)            \
  if (G <= 8) FD_MMA(ND, 8);    \
  FD_MMA(ND, 16)
    if (D == 64) { FD_MMA_G(4); }
    if (D == 96) { FD_MMA_G(6); }
    if (D == 128) { FD_MMA_G(8); }
    FD_MMA_G(16);
#undef FD_MMA_G
#undef FD_MMA
  }
#define FD_FMA(KV, GC)                                      \
  return fn(fma_kernel<KV, GC, CLUSTER>, BT, THREADS,       \
            fma_smem_bytes<KV, GC>(D, n_split))
#define FD_FMA_G(KV)                  \
  if (G <= 1) FD_FMA(KV, 1);          \
  if (G <= 2) FD_FMA(KV, 2);          \
  if (G <= 4) FD_FMA(KV, 4);          \
  if (G <= 8) FD_FMA(KV, 8);          \
  FD_FMA(KV, 16)
  if (bf16) { FD_FMA_G(__nv_bfloat16); }
  FD_FMA_G(float);
#undef FD_FMA_G
#undef FD_FMA
}

template <typename Fn>
cudaError_t dispatch(int G, int D, bool bf16, int n_split, Fn fn) {
  if (n_split > 1 && n_split <= MAX_CLUSTER)
    return dispatch_c<true>(G, D, bf16, n_split, fn);
  return dispatch_c<false>(G, D, bf16, n_split, fn);
}

bool bad_shape(int G, int D) {
  return G < 1 || G > MAXG || D < 8 || D > MAXD || D % 8;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The mma kernel's view of a bf16 cache (B, T, KV, D): a 4-d tensor map
// (D, KV, T, B) read in boxes of 64 columns x 1 head x BTM rows, with the
// 128-byte swizzle; rows past T read as zeros.
cudaError_t cache_map(CUtensorMap* m, const void* base, int B, int T,
                      int KVH, int D) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)T,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2,
                           (cuuint64_t)T * KVH * D * 2};
  cuuint32_t box[4] = {64, 1, BTM, 1}, elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// {tile rows, threads, blocks an SM holds, dynamic shared memory} of the
// kernel for (G, D, cache type) at one split; returns a CUDA error code.
extern "C" int flash_decode_geometry(int G, int D, int kv_bf16, int* out) {
  if (bad_shape(G, D)) return (int)cudaErrorInvalidValue;
  int rows = 0, threads = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t e = dispatch(
      G, D, kv_bf16 != 0, 1,
      [&](auto kernel, int r, int t, size_t s) {
        rows = r;
        threads = t;
        smem = s;
        cudaError_t err = prepare(kernel, s);
        if (err != cudaSuccess) return err;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                             t, s);
      });
  out[0] = rows;
  out[1] = threads;
  out[2] = blocks;
  out[3] = (int)smem;
  return (int)e;
}

extern "C" int flash_decode_launch(
    const float* q, const void* k, const void* v, const int32_t* valid,
    float* m_part, float* l_part, float* acc_part, int32_t* counters,
    float* out, int B, int T, int KVH, int G, int D, int n_split,
    int split_rows, int kv_bf16, float softcap, void* stream) {
  if (bad_shape(G, D) || T < 1 || n_split < 1 || n_split > MAX_SPLIT ||
      split_rows < 1 || (long long)(n_split - 1) * split_rows >= T ||
      B * KVH > 65535 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 ||
      (n_split > MAX_CLUSTER &&
       (!m_part || !l_part || !acc_part || !counters)))
    return (int)cudaErrorInvalidValue;
  const int cluster = n_split > 1 && n_split <= MAX_CLUSTER;
  CUtensorMap tk{}, tv{};
  if (kv_bf16 && (D == 64 || D == 128 || D == 256)) {  // the mma kernel's maps
    cudaError_t e = cache_map(&tk, k, B, T, KVH, D);
    if (e == cudaSuccess) e = cache_map(&tv, v, B, T, KVH, D);
    if (e != cudaSuccess) return (int)e;
  }
  const Args a{q, k, v, valid, m_part, l_part, acc_part, counters, out,
               T, KVH, G, D, n_split, split_rows, 1.0f / sqrtf((float)D),
               softcap};
  return (int)dispatch(
      G, D, kv_bf16 != 0, n_split,
      [&](auto kernel, int rows, int threads, size_t smem) {
        if (split_rows % rows) return cudaErrorInvalidValue;
        cudaError_t e = prepare(kernel, smem);
        if (e != cudaSuccess) return e;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(n_split, B * KVH);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr[1];
        if (cluster) {
          attr[0].id = cudaLaunchAttributeClusterDimension;
          attr[0].val.clusterDim.x = n_split;
          attr[0].val.clusterDim.y = 1;
          attr[0].val.clusterDim.z = 1;
          cfg.attrs = attr;
          cfg.numAttrs = 1;
        }
        e = cudaLaunchKernelEx(&cfg, kernel, a, tk, tv);
        return e != cudaSuccess ? e : cudaGetLastError();
      });
}

extern "C" const char* flash_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
