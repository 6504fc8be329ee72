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
// The TPU kernel gathers through one-hot products per (block, cell tile)
// visit; here it is one indexed load per output.
// Bound: device-memory bytes (cell and coeff read once, out written once,
// one k-wide row of back read per real position).
// Design: one thread per (position, column), consecutive threads on
// consecutive positions, so cell, coeff and out are coalesced; the back
// reads follow the ascending cells of the layout.
// ---------------------------------------------------------------------------
__global__ void route_unpack_kernel(const int32_t* __restrict__ cell,
                                    const float* __restrict__ coeff,
                                    const float* __restrict__ back,
                                    float* __restrict__ out, long long L,
                                    unsigned long long num_cells, int k) {
  const long long s = blockIdx.y;
  const int32_t* crow = cell + s * L;
  const float* frow = coeff + s * L;
  float* orow = out + s * L * k;
  const long long lk = L * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < lk; e += (long long)gridDim.x * blockDim.x) {
    const long long p = k == 1 ? e : e / k;
    const int32_t c = crow[p];
    const bool real = (unsigned long long)(uint32_t)c < num_cells;
    const float v = real ? back[(long long)c * k + (e - p * k)] : 0.0f;
    orow[e] = frow[p] * v;
  }
}

dim3 row_grid(long long work, int m) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return dim3((unsigned)(blocks < 65535 ? blocks : 65535), m);
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

extern "C" int route_unpack_launch(const int32_t* cell, const float* coeff,
                                   const float* back, float* out, int m,
                                   long long L, long long num_cells, int k,
                                   void* stream) {
  if (m == 0 || L == 0 || k == 0) return (int)cudaGetLastError();
  route_unpack_kernel<<<row_grid(L * k, m), THREADS, 0,
                        (cudaStream_t)stream>>>(
      cell, coeff, back, out, L, (unsigned long long)num_cells, k);
  return (int)cudaGetLastError();
}

extern "C" const char* route_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
