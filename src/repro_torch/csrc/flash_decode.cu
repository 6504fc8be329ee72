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
// Design: split-KV flash decoding.  The TPU kernel walks the cache of one
// (batch, kv head) in order on one core; here B * KV blocks alone would fill
// a few of the 132 SMs (8 in the gemma3-1b serve run), so the cache of each
// (batch, kv head) is cut into n_split ranges of split_rows rows, one block
// each (grid (n_split, B * KV), chosen by the wrapper for about 8 blocks per
// SM).  A block walks its range in tiles of BT rows with the online softmax.
// The k and v rows of the next tile are copied into shared memory by
// cp.async (16 bytes a thread, coalesced) while the block computes on the
// current one, so the copy of a tile overlaps the work on the one before:
// two stages of k and v tiles, 128 KB at D = 256 in f32 (above the 48 KB
// default, so the launcher raises the block's limit), 64 KB in bf16.  From
// shared memory each of the 8 warps scores 4 rows of the tile against the G
// query rows (held in shared memory and read once for the 4 rows; the lanes
// split D and a shuffle tree sums), the warps then rescale the running
// (m, l), and each thread adds the tile's p . v into the f32 accumulators of
// the column it owns, one per head.  G is rounded up to a power of two at
// compile time (GC; the extra query rows are zeros), so the inner loops have
// fixed counts and no per-head branch (a test of g < G inside loops
// unrolled to 16 heads costs an issue slot per head whether it runs or
// not).  Each block writes its partial (m, l, acc); `combine_kernel` weighs
// the splits by exp(m_s - M).
//
// Masking keeps the reference's finite -1e30: a range with no valid row
// gives m = -1e30 and p = exp(0) = 1 on its rows, and any range with a valid
// row outweighs it in the combine by exp(-1e30 - M) = 0, as a later valid
// block cancels an early masked one in the TPU kernel (alpha = 0).  With no
// valid row in the whole cache every split has m = -1e30 and the output is
// the mean of v, as in the reference.  -INFINITY would give -inf - -inf = NaN.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 32;                  // cache rows per tile
constexpr int MAXG = 16;                // query heads per kv head
constexpr int MAXD = 256;               // head_dim
constexpr int DLANE = MAXD / 32;        // dims of a row one lane scores
constexpr float NEG_INF = -1e30f;
static_assert(BT == 32, "the softmax step gives one tile row to each lane");
static_assert(THREADS == MAXD, "one accumulator column per thread");

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of a block, in bytes: two stages of k and v tiles, then
// the query rows (GC, D), the tile's scores / probabilities (BT, GC) and
// the running max, sum and rescale factor (GC each).
template <typename KV, int GC>
size_t smem_bytes(int D) {
  return 4 * (size_t)BT * D * sizeof(KV) +
         (size_t)(GC * D + BT * GC + 3 * GC) * sizeof(float);
}

// GC is G rounded up to a power of two: the query rows past G are zeros,
// so the inner loops run a fixed count with no per-head test.
template <typename KV, int GC>
__global__ void __launch_bounds__(THREADS) split_kernel(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const int32_t* __restrict__ valid,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int T, int KVH, int G, int D,
    int split_rows, float scale, float softcap) {
  constexpr int R = BT / WARPS;                  // rows a warp scores
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = BT * D;                       // elements of one k tile
  KV* kv_s = reinterpret_cast<KV*>(smem);        // [stage][k | v][BT][D]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * tile);  // (GC, D)
  float* p_s = q_s + GC * D;        // (BT, GC) scores, then probabilities
  float* m_s = p_s + BT * GC;       // (GC,) running max
  float* l_s = m_s + GC;            // (GC,) running sum
  float* a_s = l_s + GC;            // (GC,) this tile's rescale factor

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / KVH, h = bh - b * KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = (long long)KVH * D;  // stride between cache rows
  const KV* kb = k + ((long long)b * T * KVH + h) * D;
  const KV* vb = v + ((long long)b * T * KVH + h) * D;
  const int32_t* valid_b = valid + (long long)b * T;
  const int chunks = D * (int)sizeof(KV) / 16;   // 16-byte chunks of a row

  const int t_begin = split * split_rows;
  const int t_end = min(T, t_begin + split_rows);

  // rows [t0, t0 + nt) of k and v into stage st, asynchronously
  auto load_tile = [&](int st, int t0, int nt) {
    KV* ks = kv_s + 2 * st * tile;
    KV* vs = ks + tile;
    for (int c = tid; c < nt * chunks; c += THREADS) {
      const int r = c / chunks, j = c - r * chunks;
      const long long off = (long long)(t0 + r) * row;
      cp_async16(reinterpret_cast<char*>(ks + r * D) + 16 * j,
                 reinterpret_cast<const char*>(kb + off) + 16 * j);
      cp_async16(reinterpret_cast<char*>(vs + r * D) + 16 * j,
                 reinterpret_cast<const char*>(vb + off) + 16 * j);
    }
    cp_async_commit();
  };

  if (t_begin < t_end) load_tile(0, t_begin, min(BT, t_end - t_begin));
  for (int e = tid; e < GC * D; e += THREADS)
    q_s[e] = e < G * D ? q[(long long)bh * G * D + e] : 0.0f;
  for (int e = tid; e < BT * GC; e += THREADS) p_s[e] = 0.0f;
  for (int g = tid; g < GC; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.0f;
    a_s[g] = 1.0f;
  }
  float acc[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g] = 0.0f;

  int st = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += BT, st ^= 1) {
    const int nt = min(BT, t_end - t0);
    if (t0 + BT < t_end) {
      load_tile(st ^ 1, t0 + BT, min(BT, t_end - t0 - BT));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* ks = kv_s + 2 * st * tile;
    const KV* vs = ks + tile;
    // scores: warp w scores rows [w R, w R + R) together, each query value
    // read once for the R rows; the lanes split D, a shuffle tree sums
    {
      const int r0 = warp * R;
      float part[R][GC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < GC; ++g) part[r][g] = 0.0f;
#pragma unroll
      for (int j = 0; j < DLANE; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          float kd[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            kd[r] = r0 + r < nt ? to_f(ks[(r0 + r) * D + d]) : 0.0f;
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float qd = q_s[g * D + d];
#pragma unroll
            for (int r = 0; r < R; ++r) part[r][g] = fmaf(qd, kd[r], part[r][g]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < G) {
            float s = warp_sum(part[r][g]) * scale;
            if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
            if (lane == 0) p_s[(r0 + r) * GC + g] = s;
          }
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per query head, the lanes over the tile rows;
    // rows past the range take no part, invalid rows score -1e30
    const bool in = lane < nt;
    const bool ok = in && valid_b[t0 + lane] > 0;
    for (int g = warp; g < G; g += WARPS) {
      const float s = ok ? p_s[lane * GC + g] : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = in ? expf(s - m_new) : 0.0f;
      if (in) p_s[lane * GC + g] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . v over the tile; thread tid owns column tid
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < GC; ++g) acc[g] *= a_s[g];
#pragma unroll 4
      for (int r = 0; r < nt; ++r) {
        const float vd = to_f(vs[r * D + tid]);
        const float* pr = p_s + r * GC;
#pragma unroll
        for (int g = 0; g < GC; ++g) acc[g] = fmaf(pr[g], vd, acc[g]);
      }
    }
    __syncthreads();   // the stage is refilled by the next iteration's copy
  }

  const long long ps = (long long)bh * n_split + split;
  for (int g = tid; g < G; g += THREADS) {
    m_part[ps * G + g] = m_s[g];
    l_part[ps * G + g] = l_s[g];
  }
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g < G) acc_part[(ps * G + g) * D + tid] = acc[g];
  }
}

__device__ __forceinline__ float block_reduce(float x, bool is_max) {
  __shared__ float red[32];
  __syncthreads();                  // red may still be read from a last call
  x = is_max ? warp_max(x) : warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  x = lane < nw ? red[lane] : (is_max ? NEG_INF : 0.0f);
  return is_max ? warp_max(x) : warp_sum(x);
}

// out[g, d] = sum_s exp(m_s - M) acc_s[g, d] / sum_s exp(m_s - M) l_s,
// M = max_s m_s; one block per (batch, kv head, query head), which computes
// the split weights once into shared memory and then reads the n_split
// partial rows of its head, one column per thread.
__global__ void combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ acc_part,
                               float* __restrict__ out, int n_split, int G,
                               int D) {
  extern __shared__ float w_s[];    // (n_split,) split weights
  const int bh = blockIdx.x, g = blockIdx.y;
  const long long base = (long long)bh * n_split;
  float mx = NEG_INF;
  for (int s = threadIdx.x; s < n_split; s += blockDim.x)
    mx = fmaxf(mx, m_part[(base + s) * G + g]);
  mx = block_reduce(mx, true);
  float l = 0.0f;
  for (int s = threadIdx.x; s < n_split; s += blockDim.x) {
    const float w = expf(m_part[(base + s) * G + g] - mx);
    w_s[s] = w;
    l = fmaf(w, l_part[(base + s) * G + g], l);
  }
  l = fmaxf(block_reduce(l, false), 1e-30f);   // also orders the w_s stores
  const float* acc = acc_part + (base * G + g) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.0f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      o = fmaf(w_s[s], acc[(long long)s * G * D + d], o);
    out[((long long)bh * G + g) * D + d] = o / l;
  }
}

template <typename KV, int GC>
cudaError_t launch_split(const float* q, const void* k, const void* v,
                         const int32_t* valid, float* m_part, float* l_part,
                         float* acc_part, int B, int T, int KVH, int G,
                         int D, int n_split, int split_rows, float softcap,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes<KV, GC>(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel<KV, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(n_split, B * KVH);
  split_kernel<KV, GC><<<grid, THREADS, smem, stream>>>(
      q, (const KV*)k, (const KV*)v, valid, m_part, l_part, acc_part, T, KVH,
      G, D, split_rows, scale, softcap);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_g(int G, const float* q, const void* k, const void* v,
                     const int32_t* valid, float* m_part, float* l_part,
                     float* acc_part, int B, int T, int KVH, int D,
                     int n_split, int split_rows, float softcap,
                     cudaStream_t s) {
#define FD_LAUNCH(GC)                                                      \
  return launch_split<KV, GC>(q, k, v, valid, m_part, l_part, acc_part, B, \
                              T, KVH, G, D, n_split, split_rows, softcap, s)
  if (G <= 1) FD_LAUNCH(1);
  if (G <= 2) FD_LAUNCH(2);
  if (G <= 4) FD_LAUNCH(4);
  if (G <= 8) FD_LAUNCH(8);
  FD_LAUNCH(16);
#undef FD_LAUNCH
}

}  // namespace

extern "C" int flash_decode_launch(
    const float* q, const void* k, const void* v, const int32_t* valid,
    float* m_part, float* l_part, float* acc_part, float* out, int B, int T,
    int KVH, int G, int D, int n_split, int split_rows, int kv_bf16,
    float softcap, void* stream) {
  if (G < 1 || G > MAXG || D < 8 || D > MAXD || D % 8 || T < 1 ||
      n_split < 1 || n_split > 12288 || split_rows < 1 || B * KVH > 65535 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      kv_bf16 ? launch_g<__nv_bfloat16>(G, q, k, v, valid, m_part, l_part,
                                        acc_part, B, T, KVH, D, n_split,
                                        split_rows, softcap, s)
              : launch_g<float>(G, q, k, v, valid, m_part, l_part, acc_part,
                                B, T, KVH, D, n_split, split_rows, softcap,
                                s);
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<dim3(B * KVH, G), 256, n_split * sizeof(float), s>>>(
      m_part, l_part, acc_part, out, n_split, G, D);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_decode_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
