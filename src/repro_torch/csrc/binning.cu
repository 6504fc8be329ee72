// CountSketch binning: over the slot-blocked layout the fused matvec, the
// blocked scatter and the layout gather; over an index without a layout the
// point scatter and the point gather.
//
// Layout (core/wlsh.py, build_blocked_layout): per instance s, points are
// stably sorted by slot and packed so that table tile t (slots
// [t*bt, (t+1)*bt)) owns the contiguous layout range
// [blk_start[s,t]*bn, blk_start[s,t+1]*bn); its points come first, then
// padding positions (slot 0, coeff 0).  Positions from blk_start[s,T]*bn to
// L are padding.  The Pallas kernels walk this layout through visit lists
// because a TPU grid runs in order on one core; here every tile is its own
// CTA, found through blk_start, and the CTAs run in parallel.
//
// Multi-RHS: a (m, k, L) block shares the CTA's slot/coeff loads; columns
// run in chunks of kc, so the shared tile (kc * bt floats) stays within the
// 48 KB a block gets without opting in.
//
// Sums use shared-memory float atomics, so their order changes from run to
// run: results agree with the plain versions to rounding, stated relative
// to the output norm.  A segmented reduction over the slot-sorted range
// would pin the order; that is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// bin_fused_matvec: replaces `bin_fused_matvec_pallas`
// (src/repro/kernels/binning/kernel.py, `_fused_body`/`_fused_body_mrhs`).
//   out[s,j,p] = coeff[s,p] * sum_{q: slot[s,q] = slot[s,p]} coeff[s,q] *
//                beta[s,j,q]
// Bound: device-memory bytes (slot, coeff, beta read once, out written once:
// 16 B per layout position and column pair, 6.4 GB at m = 64, L = 6.3M).
// Design: one CTA per (instance, tile); the tile lives only in shared
// memory, filled by atomics from the tile's range, then read back for the
// same range.  The (m, B) table never exists in device memory.  CTA index T
// (one past the last tile) writes zeros over the all-padding tail.
// ---------------------------------------------------------------------------
__global__ void fused_matvec_kernel(
    const int32_t* __restrict__ blk_start, const int32_t* __restrict__ slot,
    const float* __restrict__ coeff, const float* __restrict__ beta,
    float* __restrict__ out, int num_tiles, int bn, int bt, long long L,
    int k, int kc) {
  extern __shared__ float tab[];
  const int t = blockIdx.x, s = blockIdx.y;
  const int32_t* bs = blk_start + (long long)s * (num_tiles + 1);
  const float* bsrc = beta + (long long)s * k * L;
  float* osrc = out + (long long)s * k * L;
  if (t == num_tiles) {  // padding tail: written, never accumulated
    const long long p0 = (long long)bs[num_tiles] * bn;
    for (int j = 0; j < k; ++j)
      for (long long p = p0 + threadIdx.x; p < L; p += blockDim.x)
        osrc[j * L + p] = 0.0f;
    return;
  }
  const long long p0 = (long long)bs[t] * bn, p1 = (long long)bs[t + 1] * bn;
  if (p0 == p1) return;  // tile without points owns no layout positions
  const int32_t* srow = slot + (long long)s * L;
  const float* crow = coeff + (long long)s * L;
  const int lo = t * bt;
  for (int j0 = 0; j0 < k; j0 += kc) {
    const int jn = min(kc, k - j0);
    for (int e = threadIdx.x; e < jn * bt; e += blockDim.x) tab[e] = 0.0f;
    __syncthreads();
    for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const unsigned b = (unsigned)(srow[p] - lo);
      if (b >= (unsigned)bt) continue;  // padding with slot outside the tile
      const float c = crow[p];
      for (int j = 0; j < jn; ++j)
        atomicAdd(&tab[j * bt + b], c * bsrc[(j0 + j) * L + p]);
    }
    __syncthreads();
    for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const unsigned b = (unsigned)(srow[p] - lo);
      const bool in = b < (unsigned)bt;
      const float c = crow[p];
      for (int j = 0; j < jn; ++j)
        osrc[(j0 + j) * L + p] = in ? c * tab[j * bt + b] : 0.0f;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bin_scatter_blocked: replaces `bin_scatter_blocked_pallas`
// (src/repro/kernels/binning/kernel.py, `_scatter_blocked_body`).
//   tables[s,j,b] = sum_{p: slot[s,p] = b} contrib[s,j,p], every tile
//   written, empty ones as zeros.
// Bound: device-memory bytes (slot and contrib read once, the (m, k, T*bt)
// tables written once).
// Design: the fused kernel's CTA per (instance, tile), with the shared tile
// written to device memory instead of read back.
// ---------------------------------------------------------------------------
__global__ void scatter_blocked_kernel(
    const int32_t* __restrict__ blk_start, const int32_t* __restrict__ slot,
    const float* __restrict__ contrib, float* __restrict__ tables,
    int num_tiles, int bn, int bt, long long L, int k, int kc) {
  extern __shared__ float tab[];
  const int t = blockIdx.x, s = blockIdx.y;
  const int32_t* bs = blk_start + (long long)s * (num_tiles + 1);
  const long long p0 = (long long)bs[t] * bn, p1 = (long long)bs[t + 1] * bn;
  const long long width = (long long)num_tiles * bt;
  const int32_t* srow = slot + (long long)s * L;
  const float* csrc = contrib + (long long)s * k * L;
  float* tsrc = tables + (long long)s * k * width + (long long)t * bt;
  const int lo = t * bt;
  for (int j0 = 0; j0 < k; j0 += kc) {
    const int jn = min(kc, k - j0);
    for (int e = threadIdx.x; e < jn * bt; e += blockDim.x) tab[e] = 0.0f;
    __syncthreads();
    for (long long p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
      const unsigned b = (unsigned)(srow[p] - lo);
      if (b >= (unsigned)bt) continue;
      for (int j = 0; j < jn; ++j)
        atomicAdd(&tab[j * bt + b], csrc[(j0 + j) * L + p]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < jn * bt; e += blockDim.x) {
      const int j = e / bt, b = e - j * bt;
      tsrc[(j0 + j) * width + b] = tab[e];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bin_gather: replaces `bin_gather_pallas`
// (src/repro/kernels/binning/kernel.py, `_gather_body`).
//   out[s,i,j] = tables[s, slot[s,i], j]   for tables (m, B, k)
// The TPU kernel is a one-hot product over the (point block x table tile)
// cross product; here it is one indexed load per output.
// Bound: device-memory bytes (slot read once, out written once, one k-wide
// row of the table read per point).
// Design: one thread per output element (grid rows = instances),
// consecutive threads on consecutive points (or columns), so slot loads and
// out stores are coalesced; the table reads are scattered 4*k-byte loads.
//
// bin_gather_blocked: replaces `bin_gather_blocked_pallas`
// (src/repro/kernels/binning/kernel.py, `_gather_blocked_body`).
//   out_lay[s,p,j] = tables[s, slot_lay[s,p], j]
// The same indexed load, run over the slot-blocked layout (the psum
// readout under `blocked_split`) instead of the points: the TPU kernel
// needs the layout so a block meets one table tile; here the layout's
// sorted slots make neighbouring threads read neighbouring table entries.
// Bound: device-memory bytes (slot_lay read once, out written once, one
// k-wide table row read per distinct slot).
// ---------------------------------------------------------------------------
__global__ void gather_kernel(const int32_t* __restrict__ slot,
                              const float* __restrict__ tables,
                              float* __restrict__ out, int n, long long B,
                              int k) {
  const long long s = blockIdx.y;
  const int32_t* srow = slot + s * n;
  const float* trow = tables + s * B * k;
  float* orow = out + s * n * k;
  const int nk = n * k;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nk;
       e += gridDim.x * blockDim.x) {
    const int i = k == 1 ? e : e / k;
    orow[e] = trow[(long long)srow[i] * k + (e - i * k)];
  }
}

// ---------------------------------------------------------------------------
// bin_scatter: replaces `bin_scatter_pallas`
// (src/repro/kernels/binning/kernel.py, `_scatter_body`).
//   tables[s,b,j] = sum_{i: slot[s,i] = b} contrib[s,i,j]   for an index
//   with no slot-blocked layout (the psum step without `blocked_split`).
// The TPU kernel is an O(n*B) one-hot cross product because the TPU has no
// scatter atomics; here it is O(n): the output is zeroed, then one thread
// per (point, column) adds into global memory with atomicAdd (all k
// columns in one launch).  The sum order varies from run to run.
// Bound: device-memory bytes (slot and contrib read once, the (m, B, k)
// tables written once).
// ---------------------------------------------------------------------------
__global__ void scatter_kernel(const int32_t* __restrict__ slot,
                               const float* __restrict__ contrib,
                               float* __restrict__ tables, long long n,
                               long long B, int k) {
  const long long s = blockIdx.y;
  const int32_t* srow = slot + s * n;
  const float* crow = contrib + s * n * k;
  float* trow = tables + s * B * k;
  const long long nk = n * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < nk; e += (long long)gridDim.x * blockDim.x) {
    const long long i = k == 1 ? e : e / k;
    atomicAdd(&trow[(long long)srow[i] * k + (e - i * k)], crow[e]);
  }
}

int shared_bytes(int kc, int bt) { return kc * bt * (int)sizeof(float); }

dim3 row_grid(long long work, int m) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return dim3((unsigned)(blocks < 65535 ? blocks : 65535), m);
}

}  // namespace

extern "C" int bin_fused_matvec_launch(
    const int32_t* blk_start, const int32_t* slot, const float* coeff,
    const float* beta, float* out, int m, int num_tiles, int bn, int bt,
    long long L, int k, int kc, void* stream) {
  dim3 grid(num_tiles + 1, m);
  fused_matvec_kernel<<<grid, THREADS, shared_bytes(kc, bt),
                        (cudaStream_t)stream>>>(
      blk_start, slot, coeff, beta, out, num_tiles, bn, bt, L, k, kc);
  return (int)cudaGetLastError();
}

extern "C" int bin_scatter_blocked_launch(
    const int32_t* blk_start, const int32_t* slot, const float* contrib,
    float* tables, int m, int num_tiles, int bn, int bt, long long L, int k,
    int kc, void* stream) {
  dim3 grid(num_tiles, m);
  scatter_blocked_kernel<<<grid, THREADS, shared_bytes(kc, bt),
                           (cudaStream_t)stream>>>(
      blk_start, slot, contrib, tables, num_tiles, bn, bt, L, k, kc);
  return (int)cudaGetLastError();
}

extern "C" int bin_gather_launch(const int32_t* slot, const float* tables,
                                 float* out, int m, int n, long long B, int k,
                                 void* stream) {
  const long long nk = (long long)n * k;
  if (nk == 0 || m == 0) return (int)cudaGetLastError();
  gather_kernel<<<row_grid(nk, m), THREADS, 0, (cudaStream_t)stream>>>(
      slot, tables, out, n, B, k);
  return (int)cudaGetLastError();
}

extern "C" int bin_gather_blocked_launch(const int32_t* slot_lay,
                                         const float* tables, float* out,
                                         int m, int L, long long B, int k,
                                         void* stream) {
  return bin_gather_launch(slot_lay, tables, out, m, L, B, k, stream);
}

extern "C" int bin_scatter_launch(const int32_t* slot, const float* contrib,
                                  float* tables, int m, long long n,
                                  long long B, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(tables, 0, (size_t)m * B * k *
                                  sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (n == 0 || m == 0 || k == 0) return (int)cudaGetLastError();
  scatter_kernel<<<row_grid(n * k, m), THREADS, 0, st>>>(slot, contrib,
                                                          tables, n, B, k);
  return (int)cudaGetLastError();
}

extern "C" const char* binning_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
