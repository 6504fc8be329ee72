// WLSH featurization: hash + weight + sign + CountSketch slot/coeff.
//
// Replaces the TPU kernel `featurize_pallas`
// (src/repro/kernels/featurize/kernel.py, `_featurize_body`).
// For instance s and point i, over the d coordinates:
//   t = (x_i - z_s) / w_s,  h = round_half_even(t),  u = h - t
//   weight = prod_d f(u_d)
//   key1/2 = fmix32(sum_d uint32(int32(h_d)) * r1/2_{s,d} mod 2^32)
//   sign   = 1 - 2 * (key2 >> 31)
//   slot   = key1 & (B - 1),  coeff = weight * sign      (fused epilogue)
//
// Bound on the H100: device-memory bytes.  It reads x (n, d) once and writes
// six (m, n) arrays; at n = 2^22, d = m = 64 that is 1.07 GB in and 6.4 GB
// out.  The arithmetic (an IEEE divide per (s, i, d)) is the next limit.
// Design: one thread per (instance, point).  A block stages its tile of
// TILE_N points in shared memory once (row stride d + 1, so the threads of
// a warp read distinct banks) and reuses it for INST_PER_BLOCK instances;
// the instance parameters are warp-uniform loads served by the L1 cache.
// Every output store is coalesced along the point axis.
//
// Exactness: the divide is __fdiv_rn (IEEE round-to-nearest; the build
// never uses fast math), rounding is rintf (half to even, as jnp.round;
// roundf would break keys at half-integers), the float-to-int conversion
// saturates and maps NaN to 0 (as XLA's), and the hash is native uint32
// arithmetic, so keys, slot and sign match the JAX package bitwise.  The
// weight is a product in another order than XLA's: atol 2e-6.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 128;
constexpr int INST_PER_BLOCK = 8;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The closed forms of core/bucket_fns.py, in the same float32 operations.
__device__ __forceinline__ float bucket_value(float u, int fn, float c) {
  if (fn == 0) {  // rect
    return fabsf(u) <= 0.5f ? 1.0f : 0.0f;
  }
  if (fn == 1) {  // tent: sqrt(3) * (1 - 2|u|)
    float ax = fabsf(u);
    return ax <= 0.5f ? __fmul_rn(c, __fsub_rn(1.0f, __fmul_rn(2.0f, ax)))
                      : 0.0f;
  }
  // smooth: c * G(|2u|)
  float t = fabsf(__fmul_rn(2.0f, u));
  float g;
  if (t <= 0.25f) {
    g = 1.0f / 16.0f;
  } else if (t <= 0.5f) {
    g = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(-0.5f, t), t),
                            __fmul_rn(0.25f, t)), 1.0f / 32.0f);
  } else if (t <= 0.75f) {
    float a = __fsub_rn(0.75f, t);
    g = __fmul_rn(0.5f, __fmul_rn(a, a));
  } else {
    g = 0.0f;
  }
  return __fmul_rn(c, g);
}

__global__ void featurize_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ z, const uint32_t* __restrict__ r1,
    const uint32_t* __restrict__ r2, uint32_t* __restrict__ key1,
    uint32_t* __restrict__ key2, float* __restrict__ weight,
    float* __restrict__ sign, int32_t* __restrict__ slot,
    float* __restrict__ coeff, int n, int d, int m, int fn, float fconst,
    uint32_t slot_mask) {
  extern __shared__ float xs[];  // TILE_N rows of stride d + 1
  const int stride = d + 1;
  const long long i0 = (long long)blockIdx.x * TILE_N;
  for (int e = threadIdx.x; e < TILE_N * d; e += blockDim.x) {
    int r = e / d, c = e - r * d;
    long long i = i0 + r;
    xs[r * stride + c] = i < n ? x[i * d + c] : 0.0f;
  }
  __syncthreads();
  const long long i = i0 + threadIdx.x;
  if (i >= n) return;
  const float* xr = xs + threadIdx.x * stride;
  const int s_end = min(m, (int)(blockIdx.y + 1) * INST_PER_BLOCK);
  for (int s = blockIdx.y * INST_PER_BLOCK; s < s_end; ++s) {
    const float* ws = w + (long long)s * d;
    const float* zs = z + (long long)s * d;
    const uint32_t* r1s = r1 + (long long)s * d;
    const uint32_t* r2s = r2 + (long long)s * d;
    float wt = 1.0f;
    uint32_t a1 = 0u, a2 = 0u;
    for (int c = 0; c < d; ++c) {
      float t = __fdiv_rn(__fsub_rn(xr[c], zs[c]), ws[c]);
      float h = rintf(t);
      wt = __fmul_rn(wt, bucket_value(__fsub_rn(h, t), fn, fconst));
      uint32_t hi = (uint32_t)__float2int_rz(h);  // saturating, NaN -> 0
      a1 += hi * r1s[c];
      a2 += hi * r2s[c];
    }
    const uint32_t k1 = fmix32(a1), k2 = fmix32(a2);
    const float sg = 1.0f - 2.0f * (float)(k2 >> 31);
    const long long o = (long long)s * n + i;
    key1[o] = k1;
    key2[o] = k2;
    weight[o] = wt;
    sign[o] = sg;
    slot[o] = (int32_t)(k1 & slot_mask);
    coeff[o] = __fmul_rn(wt, sg);
  }
}

}  // namespace

extern "C" int featurize_launch(
    const float* x, const float* w, const float* z, const uint32_t* r1,
    const uint32_t* r2, uint32_t* key1, uint32_t* key2, float* weight,
    float* sign, int32_t* slot, float* coeff, int n, int d, int m, int fn,
    float fconst, uint32_t slot_mask, void* stream) {
  size_t smem = (size_t)TILE_N * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        featurize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + TILE_N - 1) / TILE_N,
            (m + INST_PER_BLOCK - 1) / INST_PER_BLOCK);
  featurize_kernel<<<grid, TILE_N, smem, (cudaStream_t)stream>>>(
      x, w, z, r1, r2, key1, key2, weight, sign, slot, coeff, n, d, m, fn,
      fconst, slot_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* featurize_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
