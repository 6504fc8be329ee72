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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// route_pack: replaces `route_pack_pallas`
// (src/repro/kernels/binning/kernel.py, `_route_pack_body`).
//   send[c, j] = sum_{(s,p): cell[s,p] = c} contrib[s, p, j]; cells that no
//   run reaches are 0; sentinel positions are skipped.
// The TPU kernel accumulates one-hot products over a tile-segmented visit
// list because the TPU has no scatter; here the thread at a run's head
// sums the run in layout order, so the sum is deterministic (no atomics)
// and equals the plain version's bit for bit.
// Bound: device-memory bytes (cells and contributions read once, the whole
// send buffer written once: the zero fill is real work, since most cells of
// a one-rank buffer are never reached).
// ---------------------------------------------------------------------------
__global__ void route_pack_kernel(const int32_t* __restrict__ cell,
                                  const float* __restrict__ contrib,
                                  float* __restrict__ send, long long L,
                                  unsigned long long num_cells, int k) {
  const long long s = blockIdx.y;
  const int32_t* crow = cell + s * L;
  const float* vrow = contrib + s * L * k;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < L;
       p += (long long)gridDim.x * blockDim.x) {
    const int32_t c = crow[p];
    if ((unsigned long long)(uint32_t)c >= num_cells) continue;
    if (p > 0 && crow[p - 1] == c) continue;  // not the run's head
    long long end = p + 1;
    while (end < L && crow[end] == c) ++end;
    for (int j = 0; j < k; ++j) {
      float acc = 0.0f;
      for (long long q = p; q < end; ++q) acc += vrow[q * k + j];
      send[(long long)c * k + j] = acc;
    }
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

}  // namespace

extern "C" int route_pack_launch(const int32_t* cell, const float* contrib,
                                 float* send, int m, long long L,
                                 long long num_cells, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(send, 0, (size_t)num_cells * k *
                                  sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (m == 0 || L == 0) return (int)cudaGetLastError();
  route_pack_kernel<<<row_grid(L, m), THREADS, 0, st>>>(
      cell, contrib, send, L, (unsigned long long)num_cells, k);
  return (int)cudaGetLastError();
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
