// Yardsticks for the distributed step's two scatter kernels, timed beside
// them in chip_smoke.py phase 5 and on no path of the port: the first
// designs of B5 (bin_scatter: a memset of the whole (m, B, k) table, then
// one global atomicAdd per point and column) and of B7 (route_pack: a
// memset of the whole send buffer, then one thread per layout position,
// the thread at a run's head walking the run once per column).

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

extern "C" const char* scatter_variants_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
