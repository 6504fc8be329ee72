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
// Bound on the H100: instruction issue.  The bytes (x read once, six (m, n)
// arrays written) take 2.24 ms at n = 2^22, d = m = 64, but the work is
// m n d = 2^34 (instance, point, coordinate) elements, and an IEEE divide,
// a rint and a float-to-int conversion per element go through the
// special-function and conversion units (16 lanes a clock per SM, against
// 128 for FFMA and IMAD): that first design took 31.5 ms.  This one issues
// plain FP32 and INT32 instructions only, about ten per element:
//
//   a  = x - z                      FADD
//   q0 = a * y,   y = RN(1/w)       FMUL   (y once per (instance, coord))
//   r  = fma(-q0, w, a)             FFMA   the remainder
//   t  = fma(r, y, q0)              FFMA   = RN(a / w) (see below)
//   sb = bits(t + 0x1.8p23)         FADD   h = round_half_even(t), and
//                                          bits(sb) = 0x4B400000 + int(h)
//   k1 += sb * r1, k2 += sb * r2    IMAD x2 (0x4B400000 * sum_d r taken
//                                          off once per key at the end)
//   tent / smooth: h = sb - 0x1.8p23, u = h - t, weight *= f(u)
//   (rect needs nothing: |u| <= 1/2 holds, so f(u) = 1, on this path)
//
// Why each step is exact.  (1) The divide.  Markstein's theorem (P.
// Markstein, IBM J. Res. Dev. 34(1), 1990; Muller et al., Handbook of
// Floating-Point Arithmetic, the section on division by fma) says: if y is
// within half an ulp of 1/w and q0 within one ulp of a/w (faithful), then
// r = a - w q0 is exact and RN(q0 + r y) = RN(a / w), while no operand or
// intermediate leaves the normal range.  y = __frcp_rn(w) meets the first
// condition; q0 = RN(a y) does not always meet the second: when a's
// significand is below w's, a y can be off by up to 1 ulp of a/w before the
// multiply rounds, and q0 by up to 1.5 ulp.  So the theorem does not cover
// every operand, and t = RN(a / w) on this path is an empirical claim.  It
// rests on: the CPU tests, which model these steps exactly (an fma without
// intermediate rounding) and hold them bitwise against IEEE division over
// random operands, the edge operands, operands whose q0 is not faithful,
// and quotients next to a midpoint of two floats; and a check on the card
// (`featurize_quotient`, the same device function as the kernel's loop)
// over every one of the 2^23 significands of w, each at several quotients
// next to a midpoint (`chip_smoke.py` phase 2).  No operand of those
// differs.  A quotient one ulp off would change a key only where it moves
// t across a half-integer, and the weight by that ulp.
// (2) The rounding.  For |t| < 2^22, s = t + 1.5 * 2^23 lies in [2^23,
// 2^24], whose spacing is 1, so the add rounds t to an integer, half to
// even (as rintf), s - 1.5 * 2^23 is that integer exactly, and the bits of
// s are 0x4B400000 + h.
// The range guard: y is taken only for 2^-60 <= |w| <= 2^60 (else y = NaN);
// then for 2^-43 <= |t| < 2^22 every intermediate is normal, and for
// |t| < 2^-43 h = 0 and f(u) = f(0) whatever the last bits of t, so the
// outputs are the same.  The loop has no branch: it gathers
// whether any fast t of the thread's points was not below 2^22 in
// magnitude (large, inf, NaN, or a w outside the range), and if so the
// thread recomputes its points of that round with __fdiv_rn, rintf and the
// saturating __float2int_rz (NaN -> 0, as XLA's): the same function, taken
// by a branch a warp almost never enters.  Keys, slot and sign match the
// JAX package bitwise, and the weight is the product in coordinate order,
// as the plain version takes it.
//
// Layout.  A block holds a tile of TILE = tg * P points in shared memory
// (row stride xstride, = 2 mod 4 words, so a lane's 8-byte load of two
// coordinates is free of bank conflicts) and loops over all m instances, so
// x is read from device memory once.  Its ng groups of tg threads each take
// INST instances at a time; a thread holds P points (tile rows lt + p tg),
// so each parameter load (w, y, z, r1, r2 of two coordinates: two 16-byte
// and one 8-byte broadcast load from shared memory) serves 2 P elements and
// each x load serves INST.  Every output store is coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INST = 4;                       // instances a group carries
constexpr float MAGIC = 12582912.0f;          // 0x1.8p23
constexpr uint32_t MAGIC_BITS = 0x4B400000u;  // its bits
constexpr float FAST_LIMIT = 4194304.0f;      // 2^22
constexpr int MAX_SMEM = 232448;              // a block's limit on sm_90

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The closed forms of core/bucket_fns.py, in the same float32 operations.
template <int FN>
__device__ __forceinline__ float bucket_value(float u, float c) {
  if (FN == 0) {  // rect
    return fabsf(u) <= 0.5f ? 1.0f : 0.0f;
  }
  if (FN == 1) {  // tent: sqrt(3) * (1 - 2|u|)
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

// The reciprocal the fast path multiplies by; NaN sends every element of
// this (instance, coordinate) to the exact path.
__device__ __forceinline__ float guarded_rcp(float w) {
  const float aw = fabsf(w);
  return (aw >= 8.67361738e-19f && aw <= 1.15292150e18f)  // 2^-60, 2^60
             ? __frcp_rn(w) : __int_as_float(0x7fc00000);
}

// a / w on the fast path, y = guarded_rcp(w): Markstein's correction of
// the product by the reciprocal (see the header).
__device__ __forceinline__ float fast_quotient(float a, float w, float y) {
  const float q0 = __fmul_rn(a, y);
  const float r = __fmaf_rn(-q0, w, a);
  return __fmaf_rn(r, y, q0);
}

// The fast path's quotient alone, elementwise, for the check against IEEE
// division (no path runs it).
__global__ void quotient_kernel(const float* __restrict__ a,
                                const float* __restrict__ w,
                                float* __restrict__ t, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    t[i] = fast_quotient(a[i], w[i], guarded_rcp(w[i]));
}

// One coordinate of one instance for the thread's P points, the fast way,
// with no branch: ``bad`` gathers whether any fast t left the range where
// the fast path is exact (the caller then recomputes the point).
template <int FN, int P>
__device__ __forceinline__ void coord_step(const float (&xv)[P], float w,
                                           float y, float z, uint32_t r1,
                                           uint32_t r2, float c,
                                           float (&wt)[P], uint32_t (&a1)[P],
                                           uint32_t (&a2)[P], bool& bad) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float t = fast_quotient(__fsub_rn(xv[p], z), w, y);
    bad |= !(fabsf(t) < FAST_LIMIT);
    const float s = __fadd_rn(t, MAGIC);
    const uint32_t sb = __float_as_uint(s);
    a1[p] += sb * r1;
    a2[p] += sb * r2;
    if (FN != 0) {
      const float u = __fsub_rn(__fsub_rn(s, MAGIC), t);
      wt[p] = __fmul_rn(wt[p], bucket_value<FN>(u, c));
    }
  }
}

// Shared-memory parameters of one instance over coordinate pairs.
struct __align__(16) PairA { float w0, w1, y0, y1; };
struct __align__(16) PairB { float z0, z1; uint32_t r10, r11; };

struct Exact {
  float wt;
  uint32_t a1, a2;
};

// One (instance, point) over all d coordinates the exact way (the first
// design's operations: __fdiv_rn, rintf, the saturating __float2int_rz),
// with the keys summed over the bits 0x4B400000 + int(h) as the fast path
// sums them.  Returned by value: a call through references would put the
// caller's accumulators in local memory.
template <int FN>
__device__ __noinline__ Exact exact_point(const float* xr, const PairA* pa,
                                          const PairB* pb, const uint2* pc,
                                          int d, float c) {
  Exact e{1.0f, 0u, 0u};
  for (int k = 0; k < d; ++k) {
    const int cp = k >> 1;
    const bool hi = k & 1;
    const float w = hi ? pa[cp].w1 : pa[cp].w0;
    const float z = hi ? pb[cp].z1 : pb[cp].z0;
    const uint32_t r1 = hi ? pb[cp].r11 : pb[cp].r10;
    const uint32_t r2 = hi ? pc[cp].y : pc[cp].x;
    const float t = __fdiv_rn(__fsub_rn(xr[k], z), w);
    const float h = rintf(t);
    e.wt = __fmul_rn(e.wt, bucket_value<FN>(__fsub_rn(h, t), c));
    const uint32_t sb = (uint32_t)__float2int_rz(h) + MAGIC_BITS;
    e.a1 += sb * r1;
    e.a2 += sb * r2;
  }
  return e;
}

// Shared memory of a block, in bytes: the x tile, then per group its INST
// instances' PairA, PairB, r2 pairs and two key corrections.
__host__ __device__ inline size_t smem_bytes(int p, int tg, int ng, int d,
                                             int xstride) {
  const size_t npair = (d + 1) / 2;
  return (size_t)tg * p * xstride * 4 +
         (size_t)ng * INST * (npair * (16 + 16 + 8) + 8);
}

__host__ __device__ inline int x_stride(int d) {
  int s = (d + 1) & ~1;          // even, then 2 mod 4
  if (s % 4 == 0) s += 2;
  return s;
}

template <int FN, int P>
__global__ void __launch_bounds__(512) featurize_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ z, const uint32_t* __restrict__ r1,
    const uint32_t* __restrict__ r2, uint32_t* __restrict__ key1,
    uint32_t* __restrict__ key2, float* __restrict__ weight,
    float* __restrict__ sign, int32_t* __restrict__ slot,
    float* __restrict__ coeff, int n, int d, int m, int ng,
    int rounds_per_slice, float fconst, uint32_t slot_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tg = blockDim.x / ng;
  const int tile = tg * P;
  const int xstride = x_stride(d);
  const int npair = (d + 1) / 2;
  const int group_inst = ng * INST;              // instances of a round
  float* xs = reinterpret_cast<float*>(smem);
  PairA* pa = reinterpret_cast<PairA*>(xs + (size_t)tile * xstride);
  PairB* pb = reinterpret_cast<PairB*>(pa + group_inst * npair);
  uint2* pc = reinterpret_cast<uint2*>(pb + group_inst * npair);
  uint32_t* corr = reinterpret_cast<uint32_t*>(pc + group_inst * npair);

  const int tid = threadIdx.x;
  const int g = tid / tg, lt = tid - g * tg;
  const long long i0 = (long long)blockIdx.x * tile;
  for (int e = tid; e < tile * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d;
    const long long i = i0 + r;
    xs[r * xstride + c] = i < n ? x[i * d + c] : 0.0f;
  }

  const int n_rounds = (m + group_inst - 1) / group_inst;
  const int r_begin = blockIdx.y * rounds_per_slice;
  const int r_end = min(n_rounds, r_begin + rounds_per_slice);
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int round = r_begin; round < r_end; ++round) {
    const int s0 = round * group_inst;
    __syncthreads();   // the x tile is in; the last round's params are read
    for (int e = tid; e < group_inst * npair; e += blockDim.x) {
      const int si = e / npair, cp = e - si * npair;
      const int s = s0 + si;
      const int c0 = 2 * cp, c1 = c0 + 1;
      PairA A{1.0f, 1.0f, 1.0f, 1.0f};
      PairB B{0.0f, 0.0f, 0u, 0u};
      uint2 C{0u, 0u};
      if (s < m) {
        const long long o = (long long)s * d;
        A.w0 = w[o + c0];
        A.y0 = guarded_rcp(A.w0);
        B.z0 = z[o + c0];
        B.r10 = r1[o + c0];
        C.x = r2[o + c0];
        if (c1 < d) {
          A.w1 = w[o + c1];
          A.y1 = guarded_rcp(A.w1);
          B.z1 = z[o + c1];
          B.r11 = r1[o + c1];
          C.y = r2[o + c1];
        }
      }
      pa[e] = A;
      pb[e] = B;
      pc[e] = C;
    }
    // corrections 0x4B400000 * sum_d r (mod 2^32), one warp per instance
    for (int si = warp; si < group_inst; si += nwarps) {
      const int s = s0 + si;
      uint32_t c1s = 0u, c2s = 0u;
      if (s < m) {
        for (int c = lane; c < d; c += 32) {
          c1s += r1[(long long)s * d + c];
          c2s += r2[(long long)s * d + c];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        c1s += __shfl_xor_sync(0xffffffffu, c1s, o);
        c2s += __shfl_xor_sync(0xffffffffu, c2s, o);
      }
      if (lane == 0) {
        corr[2 * si] = c1s * MAGIC_BITS;
        corr[2 * si + 1] = c2s * MAGIC_BITS;
      }
    }
    __syncthreads();

    float wt[INST][P];
    uint32_t a1[INST][P], a2[INST][P];
#pragma unroll
    for (int k = 0; k < INST; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        wt[k][p] = 1.0f;
        a1[k][p] = 0u;
        a2[k][p] = 0u;
      }
    bool bad = false;
    const PairA* ga = pa + g * INST * npair;
    const PairB* gb = pb + g * INST * npair;
    const uint2* gc = pc + g * INST * npair;
    const float* xr = xs + lt * xstride;
#pragma unroll 1
    for (int cp = 0; cp < d / 2; ++cp) {
      float xa[P], xb[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 v = *reinterpret_cast<const float2*>(
            xr + p * tg * xstride + 2 * cp);
        xa[p] = v.x;
        xb[p] = v.y;
      }
#pragma unroll
      for (int k = 0; k < INST; ++k) {
        const PairA A = ga[k * npair + cp];
        const PairB B = gb[k * npair + cp];
        const uint2 C = gc[k * npair + cp];
        coord_step<FN, P>(xa, A.w0, A.y0, B.z0, B.r10, C.x, fconst,
                          wt[k], a1[k], a2[k], bad);
        coord_step<FN, P>(xb, A.w1, A.y1, B.z1, B.r11, C.y, fconst,
                          wt[k], a1[k], a2[k], bad);
      }
    }
    if (d & 1) {       // the last coordinate of an odd d
      const int cp = d / 2;
      float xa[P];
#pragma unroll
      for (int p = 0; p < P; ++p) xa[p] = xr[p * tg * xstride + 2 * cp];
#pragma unroll
      for (int k = 0; k < INST; ++k) {
        const PairA A = ga[k * npair + cp];
        const PairB B = gb[k * npair + cp];
        const uint2 C = gc[k * npair + cp];
        coord_step<FN, P>(xa, A.w0, A.y0, B.z0, B.r10, C.x, fconst, wt[k],
                          a1[k], a2[k], bad);
      }
    }
    // a point with any coordinate off the fast path: all of this thread's
    // points of the round again, the exact way (a branch a warp almost never
    // takes)
    if (__builtin_expect(bad, 0)) {
#pragma unroll
      for (int k = 0; k < INST; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const Exact e = exact_point<FN>(xr + p * tg * xstride,
                                          ga + k * npair, gb + k * npair,
                                          gc + k * npair, d, fconst);
          wt[k][p] = e.wt;
          a1[k][p] = e.a1;
          a2[k][p] = e.a2;
        }
    }
#pragma unroll
    for (int k = 0; k < INST; ++k) {
      const int s = s0 + g * INST + k;
      if (s >= m) break;
      const uint32_t c1 = corr[2 * (g * INST + k)];
      const uint32_t c2 = corr[2 * (g * INST + k) + 1];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long i = i0 + lt + p * tg;
        if (i >= n) continue;
        const uint32_t k1 = fmix32(a1[k][p] - c1);
        const uint32_t k2 = fmix32(a2[k][p] - c2);
        const float sg = 1.0f - 2.0f * (float)(k2 >> 31);
        const long long o = (long long)s * n + i;
        key1[o] = k1;
        key2[o] = k2;
        weight[o] = wt[k][p];
        sign[o] = sg;
        slot[o] = (int32_t)(k1 & slot_mask);
        coeff[o] = __fmul_rn(wt[k][p], sg);
      }
    }
  }
}

// (points a thread holds, threads a group, groups): the widest plan whose
// shared memory fits, the x tile first.
struct Plan {
  int p, tg, ng;
};

Plan choose_plan(int d) {
  static const Plan plans[] = {{4, 128, 4}, {4, 128, 2}, {2, 128, 4},
                               {2, 128, 2}, {1, 128, 4}, {1, 128, 2},
                               {1, 128, 1}, {1, 64, 1},  {1, 32, 1}};
  for (const Plan& pl : plans)
    if (smem_bytes(pl.p, pl.tg, pl.ng, d, x_stride(d)) <= MAX_SMEM) return pl;
  return Plan{0, 0, 0};
}

template <int FN, int P>
cudaError_t launch(const Plan& pl, const float* x, const float* w,
                   const float* z, const uint32_t* r1, const uint32_t* r2,
                   uint32_t* key1, uint32_t* key2, float* weight,
                   float* sign, int32_t* slot, float* coeff, int n, int d,
                   int m, float fconst, uint32_t slot_mask,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(P, pl.tg, pl.ng, d, x_stride(d));
  cudaError_t e = cudaFuncSetAttribute(
      featurize_kernel<FN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tile = pl.tg * P;
  const int blocks = (n + tile - 1) / tile;
  const int n_rounds = (m + pl.ng * INST - 1) / (pl.ng * INST);
  // few point tiles: split the instance rounds over grid rows, so that
  // about two blocks per SM run (each row re-reads its x tile)
  int slices = min(n_rounds, max(1, (2 * sms + blocks - 1) / blocks));
  slices = min(slices, 65535);
  const int per = (n_rounds + slices - 1) / slices;
  slices = (n_rounds + per - 1) / per;
  featurize_kernel<FN, P><<<dim3(blocks, slices), pl.tg * pl.ng, smem,
                            stream>>>(
      x, w, z, r1, r2, key1, key2, weight, sign, slot, coeff, n, d, m, pl.ng,
      per, fconst, slot_mask);
  return cudaGetLastError();
}

template <int FN>
cudaError_t launch_fn(const Plan& pl, const float* x, const float* w,
                      const float* z, const uint32_t* r1, const uint32_t* r2,
                      uint32_t* key1, uint32_t* key2, float* weight,
                      float* sign, int32_t* slot, float* coeff, int n, int d,
                      int m, float fconst, uint32_t slot_mask,
                      cudaStream_t s) {
#define FZ_LAUNCH(P)                                                        \
  return launch<FN, P>(pl, x, w, z, r1, r2, key1, key2, weight, sign, slot, \
                       coeff, n, d, m, fconst, slot_mask, s)
  if (pl.p == 4) FZ_LAUNCH(4);
  if (pl.p == 2) FZ_LAUNCH(2);
  FZ_LAUNCH(1);
#undef FZ_LAUNCH
}

}  // namespace

// The plan the launcher takes for d: {points per thread, threads per
// group, groups, instances per group}; all 0 when no plan fits.
extern "C" void featurize_plan(int d, int* out) {
  const Plan pl = d >= 1 ? choose_plan(d) : Plan{0, 0, 0};
  out[0] = pl.p;
  out[1] = pl.tg;
  out[2] = pl.ng;
  out[3] = INST;
}

extern "C" int featurize_launch(
    const float* x, const float* w, const float* z, const uint32_t* r1,
    const uint32_t* r2, uint32_t* key1, uint32_t* key2, float* weight,
    float* sign, int32_t* slot, float* coeff, int n, int d, int m, int fn,
    float fconst, uint32_t slot_mask, void* stream) {
  const Plan pl = d >= 1 ? choose_plan(d) : Plan{0, 0, 0};
  if (pl.p == 0 || n < 1 || m < 1 || fn < 0 || fn > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fn == 0)
    return (int)launch_fn<0>(pl, x, w, z, r1, r2, key1, key2, weight, sign,
                             slot, coeff, n, d, m, fconst, slot_mask, s);
  if (fn == 1)
    return (int)launch_fn<1>(pl, x, w, z, r1, r2, key1, key2, weight, sign,
                             slot, coeff, n, d, m, fconst, slot_mask, s);
  return (int)launch_fn<2>(pl, x, w, z, r1, r2, key1, key2, weight, sign,
                           slot, coeff, n, d, m, fconst, slot_mask, s);
}

// t[i] = the kernel's fast-path quotient of a[i] / w[i] (NaN where w is
// outside the guard's range), for n elements on ``stream``.
extern "C" int featurize_quotient(const float* a, const float* w, float* t,
                                  long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  quotient_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                    (cudaStream_t)stream>>>(a, w, t, n);
  return (int)cudaGetLastError();
}

extern "C" const char* featurize_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
