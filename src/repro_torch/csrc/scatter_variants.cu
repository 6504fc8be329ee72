// Yardsticks timed beside the kernels that replaced them in chip_smoke.py
// phase 5, on no path of the port: the first designs of B5 (bin_scatter: a
// memset of the whole (m, B, k) table, then one global atomicAdd per point
// and column), of B7 (route_pack: a memset of the whole send buffer, then
// one thread per layout position, the thread at a run's head walking the
// run once per column), of B2 (bin_fused_matvec: one block per
// (instance, tile), the tile's table in shared memory filled by float
// atomics, then read back over the tile's range; beta laid out beforehand)
// and of B8 (route_unpack: one thread per (position, column), a 4-byte
// cell load, the dependent back load and a 4-byte store; a row of blocks
// per instance).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

dim3 row_grid(long long work, int m) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return dim3((unsigned)(blocks < 65535 ? blocks : 65535), m);
}

__global__ void scatter_v1_kernel(const int32_t* __restrict__ slot,
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

__global__ void route_pack_v1_kernel(const int32_t* __restrict__ cell,
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

// B8's first design: out[s, p, j] = coeff[s, p] * (cell[s, p] real ?
// back[cell[s, p], j] : 0), coeff null for 1.
__global__ void route_unpack_v1_kernel(const int32_t* __restrict__ cell,
                                       const float* __restrict__ coeff,
                                       const float* __restrict__ back,
                                       float* __restrict__ out, long long L,
                                       unsigned long long num_cells, int k) {
  const long long s = blockIdx.y;
  const int32_t* crow = cell + s * L;
  const float* frow = coeff ? coeff + s * L : nullptr;
  float* orow = out + s * L * k;
  const long long lk = L * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < lk; e += (long long)gridDim.x * blockDim.x) {
    const long long p = k == 1 ? e : e / k;
    const int32_t c = crow[p];
    const bool real = (unsigned long long)(uint32_t)c < num_cells;
    const float v = real ? back[(long long)c * k + (e - p * k)] : 0.0f;
    orow[e] = frow ? frow[p] * v : v;
  }
}

// B2's first design: out[s,j,p] = coeff[s,p] * sum_{q: slot[s,q] =
// slot[s,p]} coeff[s,q] * beta_lay[s,j,q] over the slot-blocked layout.
// CTA index T (one past the last tile) writes zeros over the all-padding
// tail; columns run kc at a time so the shared tile stays within 48 KB.
__global__ void fused_matvec_v1_kernel(
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

}  // namespace

extern "C" int bin_scatter_v1_launch(const int32_t* slot,
                                     const float* contrib, float* tables,
                                     int m, long long n, long long B, int k,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(tables, 0, (size_t)m * B * k *
                                  sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (n == 0 || m == 0 || k == 0) return (int)cudaGetLastError();
  scatter_v1_kernel<<<row_grid(n * k, m), THREADS, 0, st>>>(
      slot, contrib, tables, n, B, k);
  return (int)cudaGetLastError();
}

extern "C" int route_pack_v1_launch(const int32_t* cell, const float* contrib,
                                    float* send, int m, long long L,
                                    long long num_cells, int k,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(send, 0, (size_t)num_cells * k *
                                  sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (m == 0 || L == 0) return (int)cudaGetLastError();
  route_pack_v1_kernel<<<row_grid(L, m), THREADS, 0, st>>>(
      cell, contrib, send, L, (unsigned long long)num_cells, k);
  return (int)cudaGetLastError();
}

extern "C" int route_unpack_v1_launch(const int32_t* cell,
                                      const float* coeff, const float* back,
                                      float* out, int m, long long L,
                                      long long num_cells, int k,
                                      void* stream) {
  if (m == 0 || L == 0 || k == 0) return (int)cudaGetLastError();
  route_unpack_v1_kernel<<<row_grid(L * k, m), THREADS, 0,
                           (cudaStream_t)stream>>>(
      cell, coeff, back, out, L, (unsigned long long)num_cells, k);
  return (int)cudaGetLastError();
}

// beta_lay and out (m, k, L) f32; kc columns a pass (kc * bt floats of
// shared memory, at most 48 KB).
extern "C" int fused_matvec_v1_launch(
    const int32_t* blk_start, const int32_t* slot, const float* coeff,
    const float* beta, float* out, int m, int num_tiles, int bn, int bt,
    long long L, int k, int kc, void* stream) {
  if (m == 0 || L == 0 || k == 0) return (int)cudaGetLastError();
  fused_matvec_v1_kernel<<<dim3(num_tiles + 1, m), THREADS,
                           kc * bt * (int)sizeof(float),
                           (cudaStream_t)stream>>>(
      blk_start, slot, coeff, beta, out, num_tiles, bn, bt, L, k, kc);
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_variants_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
