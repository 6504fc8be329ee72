// Hash-join routing of the distributed KRR step: the pack of per-point
// contributions into the flat all_to_all send buffer, and the unpack of the
// received values back onto the slot-blocked layout.
//
// Cells (core/distributed.py, _routing_maps): a distinct (instance, slot)
// bucket bound for owner rank o gets the wire cell o*cap + off[inst, o] +
// rank, so real cells are distinct across instances, and along one
// instance's slot-sorted layout they are non-decreasing.  All points of a
// bucket share its cell (or all carry the sentinel, when the bucket is
// dropped past capacity), and they are adjacent in the layout, since
// padding only trails a tile.  Each real cell is therefore ONE contiguous
// run of one instance's layout.  Any cell >= num_cells is a sentinel.
// The cells owner o receives are the dense range [o*cap, o*cap + used[o]),
// used[o] = min(distinct buckets bound for o, cap): every cell in it is
// reached by exactly one run, and none past it is reached.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 4;          // layout positions per thread: one 16-byte load
constexpr int TAIL_BLOCKS = 528;  // at least this many blocks zero the tails

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, once
}

// Zero p[0, count) with the threads tid of nth: 16-byte stores between
// scalar edges.  T is the element's storage (uint32_t or uint16_t).
template <typename T>
__device__ void zero_range(T* p, long long count, long long tid,
                           long long nth) {
  constexpr int PER = 16 / sizeof(T);
  long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                   sizeof(T);
  if (head > count) head = count;
  for (long long e = tid; e < head; e += nth) p[e] = 0;
  const long long nvec = (count - head) / PER;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  for (long long e = tid; e < nvec; e += nth) body[e] = make_uint4(0, 0, 0, 0);
  for (long long e = head + nvec * PER + tid; e < count; e += nth) p[e] = 0;
}

template <bool K1>
__device__ __forceinline__ void load_vals(const float* vrow, long long p,
                                          int k, int j, float* v) {
  if (K1) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + p);
    v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = vrow[(p + i) * k + j];
  }
}

// ---------------------------------------------------------------------------
// route_pack: replaces `route_pack_pallas`
// (src/repro/kernels/binning/kernel.py, `_route_pack_body`).
//   send[c, j] = sum_{(s,p): cell[s,p] = c} contrib[s, p, j]; cells that no
//   run reaches are 0; sentinel positions are skipped.
// The TPU kernel accumulates one-hot products over a tile-segmented visit
// list because the TPU has no scatter.  Here each run is summed in layout
// order, head first, in f32 (deterministic, no atomics, bit for bit the
// plain version's), and rounded once to the wire dtype.
// Bound: device-memory bytes (cells and contributions read once, every
// send cell written once).
// Design: one pass writes every cell exactly once, with no memset.  Rows
// 0..m-1 of the grid: each thread takes V = 4 consecutive positions of one
// instance with 16-byte loads (a warp reads 512 contiguous bytes), sums
// the runs that start among them in registers, left to right, and the
// thread holding a run's head walks on past its positions, 16 at a time,
// to finish a run that crosses its edge; a run's other threads skip it.
// All k columns in the same pass.  Row m: the owners' tails [o*cap +
// used[o], (o+1)*cap), never reached, as 16-byte zero stores.
// ---------------------------------------------------------------------------
template <typename OutT, bool K1>
__global__ void route_pack_kernel(const int32_t* __restrict__ cell,
                                  const float* __restrict__ contrib,
                                  OutT* __restrict__ send,
                                  const int32_t* __restrict__ used,
                                  long long cap, int n_shards, long long L,
                                  int k) {
  using Bits = typename std::conditional<sizeof(OutT) == 4, uint32_t,
                                         uint16_t>::type;
  if (blockIdx.y == gridDim.y - 1) {  // the owners' tails
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nth = (long long)gridDim.x * blockDim.x;
    for (int o = 0; o < n_shards; ++o) {
      const long long u = min((long long)used[o], cap);
      zero_range(reinterpret_cast<Bits*>(send) + (o * cap + u) * k,
                 (cap - u) * k, tid, nth);
    }
    return;
  }
  const long long p0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (p0 >= L) return;
  const unsigned long long num_cells = (unsigned long long)cap * n_shards;
  const int32_t* crow = cell + blockIdx.y * L;
  const float* vrow = contrib + blockIdx.y * L * k;
  const int4 c4 = *reinterpret_cast<const int4*>(crow + p0);
  const int32_t c[V] = {c4.x, c4.y, c4.z, c4.w};
  const int32_t before = p0 > 0 ? crow[p0 - 1] : -1;
  for (int j = 0; j < (K1 ? 1 : k); ++j) {
    float v[V];
    load_vals<K1>(vrow, p0, k, j, v);
    bool open = false;  // a run that started at one of my positions
    int32_t cur = 0, prev = before;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (c[i] != prev) {  // a run's head
        if (open) put(send + (long long)cur * k + j, acc);
        open = (unsigned long long)(uint32_t)c[i] < num_cells;
        cur = c[i];
        acc = 0.0f;
      }
      if (open) acc += v[i];
      prev = c[i];
    }
    if (!open) continue;
    // the open run may go on past my positions: walk on, 4V at a time
    // (-1 is never a real cell, so it ends the run at the row's end)
    for (long long q = p0 + V; q < L; q += 4 * V) {
      int32_t d[4 * V];
      float w[4 * V];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (q + b * V < L) {
          const int4 d4 = *reinterpret_cast<const int4*>(crow + q + b * V);
          d[b * V] = d4.x; d[b * V + 1] = d4.y;
          d[b * V + 2] = d4.z; d[b * V + 3] = d4.w;
          load_vals<K1>(vrow, q + b * V, k, j, w + b * V);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) { d[b * V + i] = -1; w[b * V + i] = 0; }
        }
      }
      bool done = false;
#pragma unroll
      for (int i = 0; i < 4 * V; ++i) {
        done = done || d[i] != cur;
        if (!done) acc += w[i];
      }
      if (done) break;
    }
    put(send + (long long)cur * k + j, acc);
  }
}

// ---------------------------------------------------------------------------
// route_unpack: replaces `route_unpack_pallas`
// (src/repro/kernels/binning/kernel.py, `_route_unpack_body`).
//   out[s, p, j] = coeff[s, p] * (cell[s,p] real ? back[cell[s,p], j] : 0)
// With no coeff (a null pointer) each output is the value read, unscaled
// (coefficient 1: the sharded predict, whose combine applies coeff).
// The TPU kernel gathers through one-hot products per (block, cell tile)
// visit; here it is one indexed load per output and at most one multiply,
// so every output is the plain version's bits.
// Bound: device-memory bytes (cell and coeff read once, out written once,
// one k-wide row of back read per distinct real cell).
// Design: the function does not depend on the instance, so the (m, L)
// positions are one flat array of m*L, cut into groups of 4 (one 16-byte
// load of cells and of coeff).  A warp takes a tile of 32*G groups, lane l
// the groups l, l + 32, ... of it, so each of its loads and stores covers
// 512 contiguous bytes; a flat 1-D grid holds one tile a warp, so the
// tiles in flight stay a narrow window of the arrays (a grid of SMs x
// resident blocks looping over the tiles was slower, and so were
// evict-first hints: PERF.md, PR 22).  A thread loads its 4G cells (and
// coefficients) past L1 (.cg: read once, they leave L1 to the back
// reads), then issues all 4G back reads before it uses any, so 4G
// independent loads are in flight instead of one dependent chain, then
// stores past L1.  The routing's cells ascend along a
// layout, so a warp's back reads fall in a few adjacent sectors and hit
// L1 after the first; correctness does not rest on that order (any
// cell, negative and sentinel ones included, reads back[c] or 0).  k > 1
// loops the columns of a position (float4 reads of a back row when k % 4
// == 0, no division by k).  A cell or coeff array that is not 16-byte
// aligned (a sliced row) is read with scalar loads in the same pattern;
// the positions past the last whole tile (fewer than 128G) are done
// one a thread at the end.  out is the wrapper's own allocation,
// always 16-byte aligned.
// ---------------------------------------------------------------------------
constexpr int UNPACK_G = 2;       // groups of 4 positions a thread: V = 8
constexpr int UNPACK_TILE = 32 * UNPACK_G;  // groups a warp's tile

__device__ __forceinline__ bool real_cell(int32_t c, uint32_t num_cells) {
  return (uint32_t)c < num_cells;  // negative cells wrap past num_cells
}

__device__ __forceinline__ int4 load_cells(const int32_t* p, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
}

__device__ __forceinline__ float4 load_coeff(const float* p, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
}

// W: the columns a read takes: 1 (k == 1, or any k one column at a time)
// or 4 (k % 4 == 0, float4 reads of a back row).  K1: k == 1, where a
// group's four outputs are one float4 store.
template <bool K1, int W, bool COEFF>
__global__ void __launch_bounds__(THREADS)
route_unpack_kernel(const int32_t* __restrict__ cell,
                    const float* __restrict__ coeff,
                    const float* __restrict__ back, float* __restrict__ out,
                    long long n, uint32_t num_cells, int k, bool cell_vec,
                    bool coeff_vec) {
  using Vec = typename std::conditional<W == 4, float4, float>::type;
  constexpr int P = 4 * UNPACK_G;  // positions a thread: V
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long tiles = n / (4LL * UNPACK_TILE);
  const Vec* vback = reinterpret_cast<const Vec*>(back);
  const int kw = k / W;  // back row and out row in Vec units
  for (long long t = warp; t < tiles; t += nwarps) {
    long long pos[UNPACK_G];
    int32_t c[P];
    float f[P];
#pragma unroll
    for (int g = 0; g < UNPACK_G; ++g) {
      pos[g] = (t * UNPACK_TILE + g * 32 + lane) * 4;
      const int4 c4 = load_cells(cell + pos[g], cell_vec);
      c[4 * g] = c4.x; c[4 * g + 1] = c4.y;
      c[4 * g + 2] = c4.z; c[4 * g + 3] = c4.w;
      if constexpr (COEFF) {
        const float4 f4 = load_coeff(coeff + pos[g], coeff_vec);
        f[4 * g] = f4.x; f[4 * g + 1] = f4.y;
        f[4 * g + 2] = f4.z; f[4 * g + 3] = f4.w;
      }
    }
    if constexpr (K1) {
      float v[P];
#pragma unroll
      for (int i = 0; i < P; ++i)
        v[i] = real_cell(c[i], num_cells) ? __ldg(back + c[i]) : 0.0f;
#pragma unroll
      for (int g = 0; g < UNPACK_G; ++g) {
        float4 o = make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2],
                               v[4 * g + 3]);
        if constexpr (COEFF) {
          o.x = f[4 * g] * o.x; o.y = f[4 * g + 1] * o.y;
          o.z = f[4 * g + 2] * o.z; o.w = f[4 * g + 3] * o.w;
        }
        __stcg(reinterpret_cast<float4*>(out + pos[g]), o);
      }
    } else {
      Vec* vout = reinterpret_cast<Vec*>(out);
      for (int q = 0; q < kw; ++q) {
        Vec v[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (real_cell(c[i], num_cells)) {
            v[i] = __ldg(vback + (long long)c[i] * kw + q);
          } else {
            v[i] = Vec{};
          }
        }
#pragma unroll
        for (int i = 0; i < P; ++i) {
          Vec o = v[i];
          if constexpr (COEFF) {
            const float s = f[i];
            if constexpr (W == 4) {
              o.x = s * o.x; o.y = s * o.y; o.z = s * o.z; o.w = s * o.w;
            } else {
              o = s * o;
            }
          }
          __stcg(vout + (pos[i / 4] + i % 4) * kw + q, o);
        }
      }
    }
  }
  // the positions past the last whole tile, one a thread
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long p = tiles * 4 * UNPACK_TILE + tid; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const int32_t cp = cell[p];
    const bool real = real_cell(cp, num_cells);
    const float s = COEFF ? coeff[p] : 1.0f;
    for (int j = 0; j < k; ++j) {
      const float v = real ? back[(long long)cp * k + j] : 0.0f;
      out[p * k + j] = COEFF ? s * v : v;
    }
  }
}

template <bool K1, int W, bool COEFF>
cudaError_t unpack(const int32_t* cell, const float* coeff,
                   const float* back, float* out, long long n,
                   long long num_cells, int k, cudaStream_t st) {
  const auto kernel = route_unpack_kernel<K1, W, COEFF>;
  const long long per_block = (long long)THREADS / 32 * 4 * UNPACK_TILE;
  // one tile a warp; the kernel's loop takes any rest
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT32_MAX) blocks = INT32_MAX;
  const auto vec = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      cell, coeff, back, out, n, (uint32_t)num_cells, k, vec(cell),
      coeff != nullptr && vec(coeff));
  return cudaGetLastError();
}

template <int W>
cudaError_t unpack_cols(const int32_t* cell, const float* coeff,
                        const float* back, float* out, long long n,
                        long long num_cells, int k, cudaStream_t st) {
  if (coeff)
    return unpack<false, W, true>(cell, coeff, back, out, n, num_cells, k,
                                  st);
  return unpack<false, W, false>(cell, coeff, back, out, n, num_cells, k,
                                 st);
}

template <typename OutT>
int pack(const int32_t* cell, const float* contrib, OutT* send,
         const int32_t* used, int m, long long L, long long cap,
         int n_shards, int k, cudaStream_t st) {
  const long long per_block = (long long)THREADS * V;
  long long blocks = (L + per_block - 1) / per_block;
  if (blocks < TAIL_BLOCKS) blocks = TAIL_BLOCKS;
  const dim3 grid((unsigned)blocks, m + 1);  // row m: the owners' tails
  if (k == 1)
    route_pack_kernel<OutT, true><<<grid, THREADS, 0, st>>>(
        cell, contrib, send, used, cap, n_shards, L, k);
  else
    route_pack_kernel<OutT, false><<<grid, THREADS, 0, st>>>(
        cell, contrib, send, used, cap, n_shards, L, k);
  return (int)cudaGetLastError();
}

}  // namespace

// send: (n_shards*cap, k) f32 (bf16 != 0: bf16); L % 4 == 0 and 16-byte
// aligned cell and contrib rows.
extern "C" int route_pack_launch(const int32_t* cell, const float* contrib,
                                 void* send, const int32_t* used, int m,
                                 long long L, long long cap, int n_shards,
                                 int k, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return pack(cell, contrib, (__nv_bfloat16*)send, used, m, L, cap,
                n_shards, k, st);
  return pack(cell, contrib, (float*)send, used, m, L, cap, n_shards, k, st);
}

// out (m, L[, k]) f32, 16-byte aligned (the wrapper's allocation); cell
// and coeff rows of any alignment; num_cells < 2^31.
extern "C" int route_unpack_launch(const int32_t* cell, const float* coeff,
                                   const float* back, float* out, int m,
                                   long long L, long long num_cells, int k,
                                   void* stream) {
  if (m == 0 || L == 0 || k == 0) return (int)cudaGetLastError();
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)m * L;
  if (k == 1) {
    if (coeff)
      return (int)unpack<true, 1, true>(cell, coeff, back, out, n,
                                        num_cells, k, st);
    return (int)unpack<true, 1, false>(cell, coeff, back, out, n, num_cells,
                                       k, st);
  }
  if (k % 4 == 0 && (reinterpret_cast<uintptr_t>(back) & 15) == 0)
    return (int)unpack_cols<4>(cell, coeff, back, out, n, num_cells, k, st);
  return (int)unpack_cols<1>(cell, coeff, back, out, n, num_cells, k, st);
}

extern "C" const char* route_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
