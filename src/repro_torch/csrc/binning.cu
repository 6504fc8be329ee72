// CountSketch binning: over the slot-blocked layout the fused matvec, the
// blocked scatter and the layout gather; over an index without a layout the
// point scatter, the point gather and the readout (the point gather with
// the combine over the instances fused in).
//
// Layout (core/wlsh.py, build_blocked_layout): per instance s, points are
// stably sorted by slot and packed so that table tile t (slots
// [t*bt, (t+1)*bt)) owns the contiguous layout range
// [blk_start[s,t]*bn, blk_start[s,t+1]*bn); its points come first, then
// padding positions (slot 0, coeff 0).  Positions from blk_start[s,T]*bn to
// L are padding.  The Pallas kernels walk this layout through visit lists
// because a TPU grid runs in order on one core.  Here the blocked scatter
// finds a tile through blk_start and gives each tile a warp's turn; the
// fused matvec needs no tiles: it cuts each instance's layout into chunks
// of equal length and sums the runs of equal slots across them.
//
// B2 sums each run of equal slots over fixed-size chunks of the layout,
// whatever the tiles, and B3 each tile's runs in registers: both in a fixed
// order, and the readout sums the instances in a fixed order, so all three
// give the same bits from launch to launch.  B5 sums with shared-memory
// float atomics (compare-and-swap loops on sm_90a), so its order changes
// from run to run: it agrees with its plain version to rounding, stated
// relative to the output norm.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// bin_fused_matvec: replaces `bin_fused_matvec_pallas`
// (src/repro/kernels/binning/kernel.py, `_fused_body`/`_fused_body_mrhs`).
//   T[s,p,j] = sum over the run of p of coeff[s,q] * beta[src[s,q], j]
// where a run is a maximal stretch of equal slots along instance s's
// layout.  The layout is sorted by slot within an instance (tiles ascend,
// each tile's points by slot, then its padding), so a run holds exactly the
// points of one slot and T is the table entry of p's slot.  Padding
// (src = n, coeff 0) is a run of one position of its own and comes out 0.
// Written as T (m, L, k) for the readout, or in the contract form
// out[s,j,p] = coeff[s,p] * T[s,p,j], (m, k, L).  beta (n, k) is read in
// point order through src.
// Bound: device-memory bytes: slot, coeff and src read once, beta once and
// the output written once (16 B a layout position at k = 1).
// Design: the work is cut by positions, not by tiles, so a slot that holds
// most of an instance's points (skewed data: at Table 2's forest layout
// one slot holds from 10k to all of an instance's 500k points) is spread
// over the card like any other.  Three kernels:
//   1. mv_chunk: a block per chunk of MV_CHUNK = 1024 positions (MV_PER =
//      4 a thread: one 16-byte load each of slot, src and coeff, few
//      registers, many blocks in flight for the random reads of beta).  Each thread sums the runs among its positions, a
//      segmented scan by shuffles carries the sums across lanes, and the
//      warps' last sums are carried across warps in warp order through
//      shared memory.  A reverse scan (copies, no sums) hands every
//      position the sum at its run's last position.  Positions whose run
//      begins and ends inside the chunk are written now.  The chunk's run
//      that comes in from the left and the one that goes on to the right
//      are not: the chunk records their partial sums (pre, suf), its flags
//      and their extents (meta).
//   2. mv_walk: a thread per chunk whose last run starts in it and goes on
//      to the right adds the partial sums of the chunks that run covers, in
//      chunk order, and stores the total at each boundary it crosses (tot).
//   3. mv_fix: a block per MV_FIX_GROUP chunks writes the totals over the
//      positions of the runs that cross a chunk's edges.
// Every sum is taken in an order fixed by the layout and the chunking
// (float adds and multiplies rounded as written, never contracted into an
// fma), so the result is the same bits from launch to launch and equals the
// numpy model in repro_torch/testing/matvec_model.py bit for bit.
// ---------------------------------------------------------------------------
constexpr int MV_THREADS = 256;
constexpr int MV_WARPS = MV_THREADS / 32;
constexpr int MV_PER = 4;                   // positions a thread
constexpr int MV_CHUNK = MV_THREADS * MV_PER;
constexpr int MV_FIX_GROUP = 32;            // chunks a block of mv_fix
constexpr int CROSS_L = 1;   // the chunk's first run comes in from the left
constexpr int CROSS_R = 2;   // its last run goes on to the right
constexpr int HAS_HEAD = 4;  // a run starts inside the chunk
constexpr int PAD_KEY = -1;  // the key of a padding position
constexpr int ROW_EDGE = -3; // the key before a row's first position and
                             // after its last
constexpr unsigned MV_FULL = 0xffffffffu;

struct MvArgs {
  const int32_t* slot;  // (m, L)
  const float* coeff;   // (m, L)
  const int32_t* src;   // (m, L), n at padding
  const float* beta;    // (n, k)
  float* out;           // (m, L, k) totals, else (m, k, L)
  int4* meta;           // (m, C): flags, first end, last head, length
  float* pre;           // (m, C, k) partial sum of the first run
  float* suf;           // (m, C, k) partial sum of the last run
  float* tot;           // (m, C, k) total of the run crossing into chunk c
  long long L;
  int n, k, C;
  bool totals;
};

__device__ __forceinline__ int mv_key(const MvArgs& a, long long at) {
  return (unsigned)a.src[at] < (unsigned)a.n ? a.slot[at] : PAD_KEY;
}

__device__ __forceinline__ long long mv_out(const MvArgs& a, int s,
                                            long long p, int j) {
  return a.totals ? ((long long)s * a.L + p) * a.k + j
                  : ((long long)s * a.k + j) * a.L + p;
}

// six blocks an SM (at most 40 registers a thread): more of the random
// reads of beta in flight
__global__ void __launch_bounds__(MV_THREADS, 6)
mv_chunk_kernel(MvArgs a) {
  // per warp, two buffers (columns alternate): the forward scan's last
  // lane (sum, head seen) and the reverse scan's lane 0 (value, end seen)
  __shared__ float fx[2][MV_WARPS], rx[2][MV_WARPS];
  __shared__ int ff[2][MV_WARPS], rf[2][MV_WARPS];
  __shared__ int w_end[MV_WARPS], w_head[MV_WARPS], w_any[MV_WARPS];
  __shared__ int edge_l, edge_r;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = blockIdx.x, s = blockIdx.y;
  const long long L = a.L, row = (long long)s * L;
  const long long c0 = (long long)c * MV_CHUNK;
  const int len = (int)min((long long)MV_CHUNK, L - c0);
  const int o0 = MV_PER * t;      // the thread's first offset in the chunk
  const long long p0 = c0 + o0;
  int key[MV_PER], sr[MV_PER];
  float cf[MV_PER];
#pragma unroll
  for (int h = 0; h < MV_PER / 4; ++h) {
    // len and c0 are multiples of 4: a group of 4 is in or out whole
    if (o0 + 4 * h < len) {
      const long long at = row + p0 + 4 * h;
      // streamed past L2 (evict-first), so beta's lines stay there
      const int4 s4 = __ldcs(reinterpret_cast<const int4*>(a.slot + at));
      const int4 q4 = __ldcs(reinterpret_cast<const int4*>(a.src + at));
      const float4 c4 = __ldcs(reinterpret_cast<const float4*>(a.coeff + at));
      const int sl[4] = {s4.x, s4.y, s4.z, s4.w};
      const int q[4] = {q4.x, q4.y, q4.z, q4.w};
      const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sr[4 * h + i] = q[i];
        cf[4 * h + i] = cc[i];
        key[4 * h + i] = (unsigned)q[i] < (unsigned)a.n ? sl[i] : PAD_KEY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sr[4 * h + i] = a.n;
        cf[4 * h + i] = 0.0f;
        key[4 * h + i] = PAD_KEY;
      }
    }
  }
  const bool live = o0 < len;
  // the keys just before and after the thread's positions: a neighbour
  // lane's, or at a warp's edge from memory
  int before = __shfl_up_sync(MV_FULL, key[MV_PER - 1], 1);
  int after = __shfl_down_sync(MV_FULL, key[0], 1);
  if (lane == 0)
    before = (live && p0 > 0) ? mv_key(a, row + p0 - 1) : ROW_EDGE;
  if (lane == 31 || !live || p0 + MV_PER >= L)
    after = (live && p0 + MV_PER < L) ? mv_key(a, row + p0 + MV_PER)
                                      : ROW_EDGE;
  // run heads and ends among the thread's positions, as bits
  unsigned hd = 0, en = 0;
#pragma unroll
  for (int i = 0; i < MV_PER; ++i) {
    const int prev = i ? key[i - 1] : before;
    const int next = i < MV_PER - 1 ? key[i + 1] : after;
    if (o0 + i < len) {
      if (key[i] == PAD_KEY || key[i] != prev) hd |= 1u << i;
      if (key[i] == PAD_KEY || key[i] != next) en |= 1u << i;
    }
  }
  {
    const int fe = en ? o0 + __ffs(en) - 1 : MV_CHUNK;
    const int lh = hd ? o0 + 31 - __clz(hd) : -1;
    const int wfe = __reduce_min_sync(MV_FULL, fe);
    const int wlh = __reduce_max_sync(MV_FULL, lh);
    const unsigned any = __ballot_sync(MV_FULL, hd != 0);
    if (lane == 0) {
      w_end[warp] = wfe;
      w_head[warp] = wlh;
      w_any[warp] = any != 0;
    }
    if (t == 0) edge_l = !(hd & 1u);                 // c0 is no run head
    if (live && len - 1 < o0 + MV_PER)
      edge_r = !((en >> (len - 1 - o0)) & 1u);       // c1 - 1 is no run end
  }
  __syncthreads();
  int first_end = len - 1, last_head = 0;
  bool any_head = false, heads_before = false, ends_after = false;
#pragma unroll
  for (int w = 0; w < MV_WARPS; ++w) {
    first_end = min(first_end, w_end[w]);
    last_head = max(last_head, w_head[w]);
    any_head = any_head || w_any[w];
    if (w < warp) heads_before = heads_before || w_any[w];
    if (w > warp) ends_after = ends_after || w_end[w] < MV_CHUNK;
  }
  {
    const unsigned hb = __ballot_sync(MV_FULL, hd != 0);
    const unsigned eb = __ballot_sync(MV_FULL, en != 0);
    heads_before = heads_before || (hb & ((1u << lane) - 1u));
    ends_after = ends_after || (lane < 31 && (eb >> (lane + 1)));
  }
  const bool cross_l = edge_l, cross_r = edge_r;
  const long long g = (long long)s * a.C + c;
  if (t == 0)
    a.meta[g] = make_int4((cross_l ? CROSS_L : 0) | (cross_r ? CROSS_R : 0) |
                              (any_head ? HAS_HEAD : 0),
                          first_end, last_head, len);
  // which positions this pass writes: not the first run when it comes in
  // from the left, not the last run when it goes on to the right
  unsigned wr = 0;
#pragma unroll
  for (int i = 0; i < MV_PER; ++i) {
    const bool seen = heads_before || (hd & ((2u << i) - 1u));
    const bool ended = ends_after || (en >> i);
    if (o0 + i < len && ended && !(cross_l && !seen)) wr |= 1u << i;
  }
  for (int j = 0; j < a.k; ++j) {
    const int buf = j & 1;
    float acc[MV_PER];
#pragma unroll
    for (int i = 0; i < MV_PER; ++i) {
      // random 4-byte reads, served by L2 (beta stays there): __ldcg keeps
      // them out of L1, where no line of them is read again soon
      const float b = (unsigned)sr[i] < (unsigned)a.n
                          ? __ldcg(a.beta + (long long)sr[i] * a.k + j)
                          : 0.0f;
      const float v = __fmul_rn(cf[i], b);
      acc[i] = (i == 0 || ((hd >> i) & 1u))
                   ? v : __fadd_rn(acc[i > 0 ? i - 1 : 0], v);
    }
    // segmented inclusive scan of the lanes' last sums
    float x = acc[MV_PER - 1];
    bool f = hd != 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(MV_FULL, x, o);
      const bool gf = __shfl_up_sync(MV_FULL, (int)f, o);
      if (lane >= o) {
        if (!f) x = __fadd_rn(y, x);
        f = f || gf;
      }
    }
    if (lane == 31) {
      fx[buf][warp] = x;
      ff[buf][warp] = f;
    }
    __syncthreads();
    // the sum carried into this warp: the warps before it, in order
    float carry = 0.0f;
    if (warp > 0) {
      carry = fx[buf][0];
      for (int u = 1; u < warp; ++u)
        carry = ff[buf][u] ? fx[buf][u] : __fadd_rn(carry, fx[buf][u]);
      if (!f) x = __fadd_rn(carry, x);
    }
    float ex = __shfl_up_sync(MV_FULL, x, 1);
    if (lane == 0) ex = carry;
    if (lane > 0 || warp > 0) {
#pragma unroll
      for (int i = 0; i < MV_PER; ++i)
        if (!(hd & ((2u << i) - 1u))) acc[i] = __fadd_rn(ex, acc[i]);
    }
    // reverse scan: the sum at the nearest run end at or after the thread
    float rv = 0.0f;
#pragma unroll
    for (int i = MV_PER - 1; i >= 0; --i)
      if ((en >> i) & 1u) rv = acc[i];
    int rh = en != 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(MV_FULL, rv, o);
      const int gh = __shfl_down_sync(MV_FULL, rh, o);
      if (lane + o < 32 && !rh) {
        rv = y;
        rh = gh;
      }
    }
    if (lane == 0) {
      rx[buf][warp] = rv;
      rf[buf][warp] = rh;
    }
    __syncthreads();
    // from the next lane, or where no end follows in the warp, from the
    // nearest later warp that has one
    float later = 0.0f;
#pragma unroll
    for (int u = MV_WARPS - 1; u > 0; --u)
      if (u > warp && rf[buf][u]) later = rx[buf][u];
    float r = __shfl_down_sync(MV_FULL, rv, 1);
    const int rh_next = __shfl_down_sync(MV_FULL, rh, 1);
    if (lane == 31 || !rh_next) r = later;
    float val[MV_PER];
#pragma unroll
    for (int i = MV_PER - 1; i >= 0; --i) {
      if ((en >> i) & 1u) r = acc[i];
      val[i] = a.totals ? r : __fmul_rn(cf[i], r);
    }
    if (a.k == 1) {
#pragma unroll
      for (int h = 0; h < MV_PER / 4; ++h) {
        const unsigned m4 = (wr >> (4 * h)) & 15u;
        float* dst = a.out + row + p0 + 4 * h;
        if (m4 == 15u) {
          __stcs(reinterpret_cast<float4*>(dst),
                 make_float4(val[4 * h], val[4 * h + 1], val[4 * h + 2],
                             val[4 * h + 3]));
        } else if (m4) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if ((m4 >> i) & 1u) dst[i] = val[4 * h + i];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < MV_PER; ++i)
        if ((wr >> i) & 1u) a.out[mv_out(a, s, p0 + i, j)] = val[i];
    }
    // the chunk's partial sums of its first and last runs
#pragma unroll
    for (int i = 0; i < MV_PER; ++i) {
      if (o0 + i == first_end) a.pre[g * a.k + j] = acc[i];
      if (o0 + i == len - 1) a.suf[g * a.k + j] = acc[i];
    }
  }
}

__global__ void mv_walk_kernel(MvArgs a, long long chunks) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= chunks) return;
  if ((a.meta[g].x & (CROSS_R | HAS_HEAD)) != (CROSS_R | HAS_HEAD)) return;
  // the run starts here and ends in chunk e: the first chunk after g that
  // has a head or does not go on (a row's last chunk never goes on)
  long long e = g + 1;
  for (;; e += 8) {
    int fl[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      fl[u] = e + u < chunks ? a.meta[e + u].x : HAS_HEAD;
    int stop = 8;
#pragma unroll
    for (int u = 7; u >= 0; --u)
      if ((fl[u] & HAS_HEAD) || !(fl[u] & CROSS_R)) stop = u;
    if (stop < 8) {
      e += stop;
      break;
    }
  }
  for (int j = 0; j < a.k; ++j) {
    float sum = a.suf[g * a.k + j];
#pragma unroll 8
    for (long long d = g + 1; d <= e; ++d)
      sum = __fadd_rn(sum, a.pre[d * a.k + j]);
    for (long long d = g + 1; d <= e; ++d) a.tot[d * a.k + j] = sum;
  }
}

// the run total of boundary b over chunk positions [lo, hi) of chunk g
__device__ void mv_fill(const MvArgs& a, long long g, int lo, int hi,
                        long long b) {
  const int s = (int)(g / a.C);
  const long long c0 = (g - (long long)s * a.C) * MV_CHUNK;
  const float* tot = a.tot + b * a.k;
  if (a.totals) {
    float* dst = a.out + ((long long)s * a.L + c0 + lo) * a.k;
    const int cnt = (hi - lo) * a.k;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x)
      dst[e] = tot[a.k == 1 ? 0 : e % a.k];
  } else {
    const float* crow = a.coeff + (long long)s * a.L + c0;
    for (int j = 0; j < a.k; ++j) {
      float* dst = a.out + ((long long)s * a.k + j) * a.L + c0;
      const float v = tot[j];
      for (int o = lo + threadIdx.x; o < hi; o += blockDim.x)
        dst[o] = __fmul_rn(crow[o], v);
    }
  }
}

__global__ void __launch_bounds__(MV_THREADS)
mv_fix_kernel(MvArgs a, long long chunks) {
  __shared__ int4 gm[MV_FIX_GROUP];
  const long long g0 = (long long)blockIdx.x * MV_FIX_GROUP;
  if (threadIdx.x < MV_FIX_GROUP)
    gm[threadIdx.x] = g0 + threadIdx.x < chunks ? a.meta[g0 + threadIdx.x]
                                                : make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int u = 0; u < MV_FIX_GROUP; ++u) {
    const int4 me = gm[u];
    const long long g = g0 + u;
    if (me.x & CROSS_L)   // the run from the left: to the first end
      mv_fill(a, g, 0, (me.x & HAS_HEAD) ? me.y + 1 : me.w, g);
    if ((me.x & CROSS_R) && (me.x & HAS_HEAD))  // from the last head on
      mv_fill(a, g, me.z, me.w, g + 1);
  }
}

// ---------------------------------------------------------------------------
// bin_scatter_blocked: replaces `bin_scatter_blocked_pallas`
// (src/repro/kernels/binning/kernel.py, `_scatter_blocked_body`).
//   tables[s,j,b] = sum_{p: slot[s,p] = b} contrib[s,j,p], every tile
//   written, empty ones as zeros.
// Bound: device-memory bytes: slot and contrib over the tiles' ranges read
// once (not the layout's slack past an instance's last tile), blk_start,
// and the (m, k, T*bt) tables written once; at the main phase's shape
// about 2.7 GB read and 2.15 GB written.
// Design: a tile's range is sorted by slot, so each slot's points form one
// contiguous run and no two positions of a run need an atomic.  A warp owns
// one (instance, tile) at a time and walks its range in chunks of 128
// positions, 4 a lane (16-byte loads): each lane sums the runs among its 4
// positions, a segmented scan by shuffles carries the sums across lanes,
// and the lane holding a run's last position stores the run's sum into the
// warp's shared tile (a plain store: one run per slot).  A run that goes on
// past the chunk is carried into the next chunk and stored where it ends.
// The tile then leaves shared memory as 16-byte stores and is zeroed for
// the warp's next tile.  Blocks are persistent: their warps walk the
// (instance, tile) items in order, so neighbouring warps write
// neighbouring tiles.  Columns run one at a time, each re-reading the
// tile's slots from cache.  The sum order is fixed by the layout: the
// result is the same bits from launch to launch.  It runs at about 81 % of
// its bound at the main phase's shape (PERF.md).
// Padding positions (slot 0, contrib 0) follow a tile's points; in tile 0
// slot 0 lies inside the tile, and a store of the padding's run would
// overwrite slot 0's sum.  So the first position whose slot falls below
// its predecessor's ends the tile's points, and nothing from it on is
// stored.
// ---------------------------------------------------------------------------
constexpr int SCAT_WARPS = 8;  // most warps a block of the blocked scatter
constexpr unsigned FULL = 0xffffffffu;

// The tile's run sums of one column into `tab` (bt floats, zeroed): the
// warp's share of scatter_blocked_kernel.  p0, p1: the tile's layout range;
// lo = t * bt.
__device__ __forceinline__ void scatter_runs(
    const int32_t* __restrict__ srow, const float* __restrict__ crow,
    float* tab, long long p0, long long p1, int lo, int bt, bool vec) {
  const int lane = threadIdx.x & 31;
  int carry_key = -1;     // slot of the run open at the chunk's end
  float carry = 0.0f;     // its sum so far
  int last = -1;          // the slot at the end of the previous chunk
  bool ended = false;     // a descent was seen: the rest is padding
  for (long long c = p0; c < p1; c += 128) {
    const long long q = c + 4 * lane;
    int sl[4];
    float v[4];
    if (vec) {             // p0, p1 and the rows 16-byte aligned
      if (q < p1) {
        const int4 a = *reinterpret_cast<const int4*>(srow + q);
        const float4 b = *reinterpret_cast<const float4*>(crow + q);
        sl[0] = a.x; sl[1] = a.y; sl[2] = a.z; sl[3] = a.w;
        v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) { sl[i] = 0; v[i] = 0.0f; }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sl[i] = q + i < p1 ? srow[q + i] : 0;
        v[i] = q + i < p1 ? crow[q + i] : 0.0f;
      }
    }
    // the first descent of the chunk: from it on, padding
    int up = __shfl_up_sync(FULL, sl[3], 1);
    if (lane == 0) up = last;
    int first = 4;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      const int prev = i ? sl[i - 1] : up;
      if (q + i < p1 && sl[i] < prev) first = i;
    }
    const unsigned ball = __ballot_sync(FULL, first < 4);
    int cut = ended ? 0 : 128;
    if (ball && !ended) {
      const int fl = __ffs(ball) - 1;
      cut = 4 * fl + __shfl_sync(FULL, first, fl);
      ended = true;
    }
    last = __shfl_sync(FULL, sl[3], 31);
    // keys: the slot of a live position, -1 past the points
    int key[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      key[i] = (4 * lane + i < cut && q + i < p1 &&
                (unsigned)(sl[i] - lo) < (unsigned)bt) ? sl[i] : -1;
    int kup = __shfl_up_sync(FULL, key[3], 1);
    if (lane == 0) {
      kup = carry_key;
      if (carry_key >= 0 && key[0] != carry_key)
        tab[carry_key - lo] = carry;     // the carried run ended before
    }
    int kdown = __shfl_down_sync(FULL, key[0], 1);
    bool head[4];
    bool any_head = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      head[i] = key[i] != (i ? key[i - 1] : kup);
      any_head |= head[i];
    }
    if (lane == 0 && !head[0]) v[0] = carry + v[0];   // the run goes on
    float a[4];
    a[0] = v[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) a[i] = head[i] ? v[i] : a[i - 1] + v[i];
    // segmented inclusive scan of the lanes' last partial sums
    float x = a[3];
    bool f = any_head;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      const bool g = __shfl_up_sync(FULL, (int)f, o);
      if (lane >= o) {
        if (!f) x = y + x;
        f = f || g;
      }
    }
    float ex = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) ex = 0.0f;
    bool open = true;     // before the lane's first head
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      open = open && !head[i];
      if (open) a[i] = ex + a[i];
    }
    // a run ends where the next key differs; the chunk's last run is
    // carried
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int next = i < 3 ? key[i + 1] : (lane < 31 ? kdown : key[i]);
      if (key[i] >= 0 && key[i] != next) tab[key[i] - lo] = a[i];
    }
    carry_key = __shfl_sync(FULL, key[3], 31);
    carry = __shfl_sync(FULL, a[3], 31);
  }
  if (lane == 0 && carry_key >= 0) tab[carry_key - lo] = carry;
}

__global__ void __launch_bounds__(SCAT_WARPS * 32)
scatter_blocked_kernel(const int32_t* __restrict__ blk_start,
                       const int32_t* __restrict__ slot,
                       const float* __restrict__ contrib,
                       float* __restrict__ tables, int m, int num_tiles,
                       int bn, int bt, long long L, int k, bool vec) {
  extern __shared__ float warp_tiles[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* tab = warp_tiles + warp * bt;
  const long long width = (long long)num_tiles * bt;
  const long long items = (long long)m * num_tiles;
  const bool vec_out = (bt & 3) == 0;
  for (int e = lane; e < bt; e += 32) tab[e] = 0.0f;
  __syncwarp();
  for (long long w = (long long)blockIdx.x * warps + warp; w < items;
       w += (long long)gridDim.x * warps) {
    const int s = (int)(w / num_tiles), t = (int)(w - (long long)s * num_tiles);
    const int32_t* bs = blk_start + (long long)s * (num_tiles + 1) + t;
    const long long p0 = (long long)bs[0] * bn, p1 = (long long)bs[1] * bn;
    const int32_t* srow = slot + (long long)s * L;
    for (int j = 0; j < k; ++j) {
      if (p0 < p1)
        scatter_runs(srow, contrib + ((long long)s * k + j) * L, tab, p0, p1,
                     t * bt, bt, vec);
      __syncwarp();
      float* dst = tables + ((long long)s * k + j) * width + (long long)t * bt;
      if (vec_out) {
        for (int e = 4 * lane; e < bt; e += 128) {
          float4* src = reinterpret_cast<float4*>(tab + e);
          *reinterpret_cast<float4*>(dst + e) = *src;
          *src = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int e = lane; e < bt; e += 32) {
          dst[e] = tab[e];
          tab[e] = 0.0f;
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// bin_gather: replaces `bin_gather_pallas`
// (src/repro/kernels/binning/kernel.py, `_gather_body`), in its contract
// form (the main path reads out through bin_readout below).
//   out[s,i,j] = tables[s, slot[s,i], j]   for tables (m, B, k)
// The TPU kernel is a one-hot product over the (point block x table tile)
// cross product; here it is one indexed load per output.
// Bound: device-memory bytes (slot read once, out written once, one k-wide
// row of the table read per point).
// Design: one thread per output element (grid rows = instances),
// consecutive threads on consecutive points (or columns), so slot loads and
// out stores are coalesced; the table reads are scattered 4*k-byte loads,
// one in flight a thread.
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
// bin_readout: replaces `bin_gather_pallas` on the main path, with the
// readout's combine (`table_readout`: coeff times the gathered value,
// mean or sum over the instances) fused in.
//   out[i,j] = (sum_s coeff[s,i] * tables[s, slot[s,i], j]) / div
// with div = m (mean) or 1 (sum).
// Bound: device-memory bytes (slot and coeff read once, one table entry a
// point and instance, out written once).  What holds it is the rate of
// random table reads: each moves a whole 32-byte sector, and where an
// instance's points are fewer than its table's sectors (predict: about a
// quarter of a read per sector) nearly every read goes to device memory;
// the gather alone runs at that rate (PERF.md).
// Design: a thread takes 4 consecutive points (16-byte slot and coeff
// loads, a float4 out) when k = 1 and the rows allow it, else one output
// element; it issues the slot and coeff loads of RU instances, then their
// table loads, so RU x 4 random reads are in flight a thread, and adds
// coeff * value into its sum in instance order with one fma each: the
// result is the same bits from launch to launch.  The instances run in
// groups of `group` a launch, each launch adding its group into out (the
// first writes it, the last divides).  Where the points read each sector
// of a table several times and one instance's table fits the 50 MB L2
// (the distributed step: 2^22 points, a 32 MiB table), a launch takes one
// instance, so its table stays in L2 while all the points read it; slot,
// coeff and out then stream past with evict-first loads and stores, so
// they do not push the table out.  Otherwise a launch takes a fixed group
// of instances (16: the fastest of 1, 4, 16 and 64 at predict's shape on
// an H100, chip_smoke.py phase 5).  The wrapper picks the group from the
// shape.
// With no slot (a null pointer) point i reads column i of each table (B =
// n): the combine alone, on values already read per point (the sharded
// predict's exchanged values), in the same order and with the same bits.
// ---------------------------------------------------------------------------
constexpr int RU = 4;        // instances whose loads a thread has in flight
constexpr int RO_THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(RO_THREADS)
readout_kernel(const int32_t* __restrict__ slot,
               const float* __restrict__ coeff,
               const float* __restrict__ tables, float* __restrict__ out,
               long long n, long long B, int k, int s0, int s1, bool first,
               float div) {
  const long long total = VEC ? n / 4 : n * k;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (VEC) {
      const long long i = 4 * e;
      float4 acc = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                         : __ldcs(reinterpret_cast<const float4*>(out + i));
      for (int s = s0; s < s1; s += RU) {
        int4 sl[RU];
        float4 c[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          if (s + u < s1) {
            const long long at = (s + u) * n + i;
            sl[u] = slot ? __ldcs(reinterpret_cast<const int4*>(slot + at))
                         : make_int4((int)i, (int)i + 1, (int)i + 2,
                                     (int)i + 3);
            c[u] = __ldcs(reinterpret_cast<const float4*>(coeff + at));
          }
        }
        float4 t[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          if (s + u < s1) {
            const float* tr = tables + (long long)(s + u) * B;
            t[u] = make_float4(__ldg(tr + sl[u].x), __ldg(tr + sl[u].y),
                               __ldg(tr + sl[u].z), __ldg(tr + sl[u].w));
          }
        }
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          if (s + u < s1) {
            acc.x = fmaf(c[u].x, t[u].x, acc.x);
            acc.y = fmaf(c[u].y, t[u].y, acc.y);
            acc.z = fmaf(c[u].z, t[u].z, acc.z);
            acc.w = fmaf(c[u].w, t[u].w, acc.w);
          }
        }
      }
      if (div != 1.0f) {
        acc.x /= div; acc.y /= div; acc.z /= div; acc.w /= div;
      }
      __stcs(reinterpret_cast<float4*>(out + i), acc);
    } else {
      const long long i = k == 1 ? e : e / k;
      const int j = (int)(e - i * k);
      float acc = first ? 0.0f : __ldcs(out + e);
      for (int s = s0; s < s1; s += RU) {
        int sl[RU];
        float c[RU], t[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          if (s + u < s1) {
            sl[u] = slot ? __ldcs(slot + (s + u) * n + i) : (int)i;
            c[u] = __ldcs(coeff + (s + u) * n + i);
          }
        }
#pragma unroll
        for (int u = 0; u < RU; ++u)
          if (s + u < s1)
            t[u] = __ldg(tables + ((long long)(s + u) * B + sl[u]) * k + j);
#pragma unroll
        for (int u = 0; u < RU; ++u)
          if (s + u < s1) acc = fmaf(c[u], t[u], acc);
      }
      if (div != 1.0f) acc /= div;
      __stcs(out + e, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// bin_scatter: replaces `bin_scatter_pallas`
// (src/repro/kernels/binning/kernel.py, `_scatter_body`).
//   tables[s,b,j] = sum_{i: slot[s,i] = b} contrib[s,i,j]   for an index
//   with no slot-blocked layout (the psum step without `blocked_split`).
// The TPU kernel is an O(n*B) one-hot cross product because the TPU has no
// scatter atomics; here it is O(n).
// Bound: device-memory bytes (slot and contrib read once, the (m, B, k)
// tables written once).
// Design: the slots are random, about half a point per slot, so a global
// atomic per point hits its own sector of a table far larger than the
// 50 MB L2; and into tables that fit L2 a global float atomic per point
// is still held to about 80 G adds/s on an H100 (PERF.md).  So no point
// reaches the table through a global atomic: points are partitioned into
// bins of W slots (W*kc floats fill a shared tile) and each bin summed in
// shared memory.  For each group of G instances, each group of at most kc
// columns and each window of at most P bins (one of each at the step's
// shapes; a wide table or many columns take several passes, each
// re-reading the group's slot rows and skipping the points outside its
// window):
//   1. part_hist: a block per chunk of C points counts them per bin in
//      shared memory, then adds its counts to the group's (G, P) counts;
//   2. part_scan: each instance's bin offsets, and a cursor per bin;
//   3. part_scatter: a block stages its chunk sorted by bin in shared
//      memory, reserves each bin's run at the bin's cursor (one global
//      atomic per bin and block) and writes the runs out, consecutive
//      threads on consecutive entries: (slot within the bin as uint16,
//      contrib) pairs;
//   4. bin_accumulate: a block per (instance, bin) adds the bin's pairs
//      into a zeroed shared tile and writes the tile to the table whole,
//      coalesced.
// Every table cell is written once, with no memset.  In one pass device
// memory moves slot twice, contrib once, the pairs (2 + 4kc bytes a point)
// once each way and the tables once.  The passes are latency-bound phases
// between barriers, so blocks are large (512 threads by default) and each
// thread loads its whole share of a chunk (at most ITEMS points) at once
// and keeps it in registers from the count to the placement; the
// accumulate loads ACC_ITEMS pairs a thread before adding them.  Float
// shared atomics are compare-and-swap loops on this card, and the sum
// order varies from run to run.
// ---------------------------------------------------------------------------
constexpr int MAX_WARPS = 32;  // of a block of the partition kernels
constexpr int ITEMS = 16;      // points a partition thread loads at once
constexpr int ACC_ITEMS = 8;   // pairs an accumulate thread loads at once

struct PartArgs {
  const int32_t* slot;   // the group's first instance row
  const float* contrib;  // its first row, at the pass's first column
  float* tables;         // likewise
  long long n, B;
  int k;                 // columns of a contrib and a table row
  int kc;                // columns this pass adds
  int W, P, C;           // bin slots, bins of this pass, chunk points
  int wshift;            // W = 1 << wshift
  int b0;                // this pass's first bin
  int* counts;           // (G, P) points per bin
  int* offsets;          // (G, P + 1) bin starts within an instance's n
  int* cursor;           // (G, P) next free pair of each bin
  uint16_t* pslot;       // (G * n) slot within the bin
  float* pval;           // (G * n * kc)
};

// The bin of slot s within this pass, or -1 for no point (s = -1) or a
// slot outside the pass's window.
__device__ __forceinline__ int pass_bin(const PartArgs& a, int s) {
  const int b = (s >> a.wshift) - a.b0;
  return (unsigned)b < (unsigned)a.P ? b : -1;
}

// Exclusive prefix sum over the block of one int per thread; the block's
// total in *total.  Every thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int t = warp_sums[w];
      warp_sums[w] = run;
      run += t;
    }
    *total = run;
  }
  __syncthreads();
  const int r = x - v + warp_sums[warp];
  __syncthreads();
  return r;
}

// out[b] = in[0] + ... + in[b - 1] for b < P (in and out may alias); the
// sum of all in *total.  Each thread takes a run of consecutive entries,
// an odd number of them, so a warp's reads fall in distinct banks.
__device__ void block_scan_bins(const int* in, int* out, int P,
                                int* warp_sums, int* total) {
  const int per = ((P + blockDim.x - 1) / blockDim.x) | 1;
  const int lo = min(P, (int)threadIdx.x * per), hi = min(P, lo + per);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += in[b];
  int run = block_exclusive_scan(sum, warp_sums, total);
  for (int b = lo; b < hi; ++b) {
    const int c = in[b];
    out[b] = run;
    run += c;
  }
}

// A thread's share of the block's entries [0, cnt) of src, cnt at most
// ITEMS * blockDim.x: positions threadIdx.x + u * blockDim.x, so each load
// is coalesced and all are in flight together; -1 past cnt.
template <typename T>
__device__ __forceinline__ void load_items(const T* src, int cnt, int* v) {
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int i = threadIdx.x + u * (int)blockDim.x;
    v[u] = i < cnt ? (int)src[i] : -1;
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
part_hist_kernel(PartArgs a) {
  extern __shared__ int hist[];  // P
  const int g = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * a.C;
  const int32_t* sp = a.slot + g * a.n + p0;
  const int cnt = (int)(min(p0 + a.C, a.n) - p0);
  int v[ITEMS];
  load_items(sp, cnt, v);
  for (int b = threadIdx.x; b < a.P; b += blockDim.x) hist[b] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int b = pass_bin(a, v[u]);
    if (b >= 0) atomicAdd(&hist[b], 1);
  }
  __syncthreads();
  int* counts = a.counts + (long long)g * a.P;
  for (int b = threadIdx.x; b < a.P; b += blockDim.x)
    if (hist[b]) atomicAdd(counts + b, hist[b]);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
part_scan_kernel(PartArgs a) {
  __shared__ int warp_sums[MAX_WARPS];
  __shared__ int total;
  const int g = blockIdx.x;
  int* off = a.offsets + (long long)g * (a.P + 1);
  block_scan_bins(a.counts + (long long)g * a.P, off, a.P, warp_sums, &total);
  __syncthreads();
  for (int b = threadIdx.x; b < a.P; b += blockDim.x)
    a.cursor[(long long)g * a.P + b] = (int)(g * a.n) + off[b];
  if (threadIdx.x == 0) off[a.P] = total;
}

// ONE_PASS: the pass holds every bin and column (the step's shapes).  It
// finds a point's bin by a division where the multi-pass case shifts:
// with the shift, this kernel measured about 10 % slower on an H100 at
// the same bytes (PERF.md).
template <bool ONE_PASS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
part_scatter_kernel(PartArgs a) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[MAX_WARPS];
  __shared__ int total;
  int* hist = smem;            // points per bin, then the rank counters
  int* lstart = hist + a.P;    // bin starts in the staged chunk
  int* gbase = lstart + a.P;   // bin runs reserved in the pair buffer
  float* sval = reinterpret_cast<float*>(gbase + a.P);            // C * kc
  uint16_t* sbin = reinterpret_cast<uint16_t*>(sval + a.C * a.kc);  // C
  uint16_t* sslot = sbin + a.C;                                     // C
  const int g = blockIdx.y, k = a.k, kc = ONE_PASS ? a.k : a.kc;
  const long long p0 = (long long)blockIdx.x * a.C;
  const int32_t* sp = a.slot + g * a.n + p0;
  const float* cp = a.contrib + (g * a.n + p0) * k;
  const int cnt = (int)(min(p0 + a.C, a.n) - p0);
  int v[ITEMS];
  float w[ITEMS];
  load_items(sp, cnt, v);
  if (k == 1) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = threadIdx.x + u * (int)blockDim.x;
      w[u] = i < cnt ? cp[i] : 0.0f;
    }
  }
  for (int b = threadIdx.x; b < a.P; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  // count; across passes keep each point as (bin << 16 | slot within the
  // bin), or -1 outside the pass's window
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    if (ONE_PASS) {
      if (v[u] >= 0) atomicAdd(&hist[v[u] / a.W], 1);
    } else {
      const int b = pass_bin(a, v[u]);
      if (b >= 0) atomicAdd(&hist[b], 1);
      v[u] = b >= 0 ? b << 16 | (v[u] & (a.W - 1)) : -1;
    }
  }
  __syncthreads();
  block_scan_bins(hist, lstart, a.P, warp_sums, &total);
  __syncthreads();
  int* cursor = a.cursor + (long long)g * a.P;
  for (int b = threadIdx.x; b < a.P; b += blockDim.x) {
    const int c = hist[b];
    gbase[b] = c ? atomicAdd(cursor + b, c) : 0;
    hist[b] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    if (v[u] < 0) continue;
    const int i = threadIdx.x + u * (int)blockDim.x;
    const int b = ONE_PASS ? v[u] / a.W : v[u] >> 16;
    const int q = lstart[b] + atomicAdd(&hist[b], 1);
    sbin[q] = (uint16_t)b;
    sslot[q] = (uint16_t)(ONE_PASS ? v[u] - b * a.W : v[u] & 0xffff);
    if (k == 1)
      sval[q] = w[u];
    else
      for (int j = 0; j < kc; ++j) sval[q * kc + j] = cp[(long long)i * k + j];
  }
  __syncthreads();
  const int staged = ONE_PASS ? cnt : total;  // points in the window
  for (int q = threadIdx.x; q < staged; q += blockDim.x) {
    const int b = sbin[q];
    a.pslot[gbase[b] + (q - lstart[b])] = sslot[q];
  }
  for (int e = threadIdx.x; e < staged * kc; e += blockDim.x) {
    const int q = kc == 1 ? e : e / kc, b = sbin[q];
    a.pval[(long long)(gbase[b] + (q - lstart[b])) * kc + (e - q * kc)] =
        sval[e];
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
bin_accumulate_kernel(PartArgs a) {
  extern __shared__ float tile[];  // W * kc
  const int b = blockIdx.x, g = blockIdx.y, k = a.k, kc = a.kc;
  const long long lo = (long long)(a.b0 + b) * a.W;
  const int width = (int)min((long long)a.W, a.B - lo) * kc;
  for (int e = threadIdx.x; e < width; e += blockDim.x) tile[e] = 0.0f;
  __syncthreads();
  const int* off = a.offsets + (long long)g * (a.P + 1);
  const long long q0 = g * a.n + off[b];
  const int run = off[b + 1] - off[b];
  const uint16_t* ps = a.pslot + q0;
  const float* pv = a.pval + q0 * kc;
  for (int e0 = threadIdx.x; e0 < run * kc; e0 += ACC_ITEMS * blockDim.x) {
    int cell[ACC_ITEMS];
    float val[ACC_ITEMS];
#pragma unroll
    for (int u = 0; u < ACC_ITEMS; ++u) {
      const int e = e0 + u * (int)blockDim.x, q = kc == 1 ? e : e / kc;
      cell[u] = e < run * kc ? ps[q] * kc + (e - q * kc) : -1;
      val[u] = e < run * kc ? pv[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < ACC_ITEMS; ++u)
      if (cell[u] >= 0) atomicAdd(&tile[cell[u]], val[u]);
  }
  __syncthreads();
  float* dst = a.tables + (g * a.B + lo) * k;
  if (kc == k) {
    for (int e = threadIdx.x; e < width; e += blockDim.x) dst[e] = tile[e];
  } else {  // one column group of wider table rows
    for (int e = threadIdx.x; e < width; e += blockDim.x) {
      const int r = e / kc;
      dst[(long long)r * k + (e - r * kc)] = tile[e];
    }
  }
}

dim3 row_grid(long long work, int m) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return dim3((unsigned)(blocks < 65535 ? blocks : 65535), m);
}

}  // namespace

// beta (n, k) f32 in point order; out (m, L, k) when `totals`, else
// (m, k, L); L % 4 == 0 and 16-byte aligned slot, src, coeff and out rows.
// Scratch: (m*C) int4 then 3 (m*C*k) f32, C = ceil(L / MV_CHUNK)
// (bin_fused_matvec_scratch gives its bytes).
extern "C" long long bin_fused_matvec_scratch(int m, long long L, int k) {
  const long long chunks = (long long)m * ((L + MV_CHUNK - 1) / MV_CHUNK);
  return chunks * (long long)(sizeof(int4) + 3 * sizeof(float) * k);
}

extern "C" int bin_fused_matvec_launch(
    const int32_t* slot, const float* coeff, const int32_t* src,
    const float* beta, float* out, int m, long long L, int n, int k,
    int totals, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0 || L == 0 || k == 0) return (int)cudaGetLastError();
  const long long C = (L + MV_CHUNK - 1) / MV_CHUNK;
  if ((L & 3) || m > 65535 || C > 0x7fffffffLL || n < 0 ||
      ((reinterpret_cast<uintptr_t>(slot) | reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(coeff) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(scratch)) & 15))
    return (int)cudaErrorInvalidValue;
  const long long chunks = m * C;
  MvArgs a;
  a.slot = slot; a.coeff = coeff; a.src = src; a.beta = beta; a.out = out;
  a.meta = static_cast<int4*>(scratch);
  a.pre = reinterpret_cast<float*>(a.meta + chunks);
  a.suf = a.pre + chunks * k;
  a.tot = a.suf + chunks * k;
  a.L = L; a.n = n; a.k = k; a.C = (int)C; a.totals = totals != 0;
  mv_chunk_kernel<<<dim3((unsigned)C, m), MV_THREADS, 0, st>>>(a);
  mv_walk_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(a,
                                                                   chunks);
  mv_fix_kernel<<<(unsigned)((chunks + MV_FIX_GROUP - 1) / MV_FIX_GROUP),
                  MV_THREADS, 0, st>>>(a, chunks);
  return (int)cudaGetLastError();
}

extern "C" int bin_scatter_blocked_launch(
    const int32_t* blk_start, const int32_t* slot, const float* contrib,
    float* tables, int m, int num_tiles, int bn, int bt, long long L, int k,
    void* stream) {
  const long long items = (long long)m * num_tiles;
  if (items == 0 || k == 0) return (int)cudaGetLastError();
  // a shared tile of bt floats a warp, within the 48 KB of a block
  const int tile = bt * (int)sizeof(float);
  if (bt < 1 || tile > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int warps = 48 * 1024 / tile < SCAT_WARPS ? 48 * 1024 / tile
                                                  : SCAT_WARPS;
  const int smem = warps * tile;
  const bool vec = (bn & 3) == 0 && (L & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(slot) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(contrib) & 15) == 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_blocked_kernel, warps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long want = (items + warps - 1) / warps;
  const long long room = (long long)sms * (per_sm > 0 ? per_sm : 1);
  scatter_blocked_kernel<<<(unsigned)(want < room ? want : room),
                           warps * 32, smem, (cudaStream_t)stream>>>(
      blk_start, slot, contrib, tables, m, num_tiles, bn, bt, L, k, vec);
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

// out (n[, k]) f32; the instances in launches of `group`, the last
// dividing by `div`.
extern "C" int bin_readout_launch(const int32_t* slot, const float* coeff,
                                  const float* tables, float* out, int m,
                                  long long n, long long B, int k, int group,
                                  float div, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0 || k == 0) return (int)cudaGetLastError();
  if (m < 1 || group < 1) return (int)cudaErrorInvalidValue;
  const bool vec = k == 1 && (n & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(slot) |
                     reinterpret_cast<uintptr_t>(coeff) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vec ? n / 4 : n * k;
  const long long blocks = (work + RO_THREADS - 1) / RO_THREADS;
  const unsigned grid = (unsigned)(blocks < (1 << 30) ? blocks : (1 << 30));
  for (int s0 = 0; s0 < m; s0 += group) {
    const int s1 = m - s0 < group ? m : s0 + group;
    const float d = s1 == m ? div : 1.0f;
    if (vec)
      readout_kernel<true><<<grid, RO_THREADS, 0, st>>>(
          slot, coeff, tables, out, n, B, k, s0, s1, s0 == 0, d);
    else
      readout_kernel<false><<<grid, RO_THREADS, 0, st>>>(
          slot, coeff, tables, out, n, B, k, s0, s1, s0 == 0, d);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" int bin_gather_blocked_launch(const int32_t* slot_lay,
                                         const float* tables, float* out,
                                         int m, int L, long long B, int k,
                                         void* stream) {
  return bin_gather_launch(slot_lay, tables, out, m, L, B, k, stream);
}

// tables (m, B, k) f32; W slots a bin (a power of 2, at most 2^16), C
// points a partition chunk (at most ITEMS * threads), G instances a group,
// blocks of `threads` (a multiple of 32, at most 1024); passes of at most
// `window`
// bins (at most 2^15) and kc columns.  Scratch for one pass: counts
// (G*window), offsets (G*(window+1)), cursor (G*window) int32, pslot (G*n)
// uint16, pval (G*n*kc) f32, with G*n < 2^31.
extern "C" int bin_scatter_launch(const int32_t* slot, const float* contrib,
                                  float* tables, int m, long long n,
                                  long long B, int k, int W, int window,
                                  int kc, int C, int G, int threads,
                                  int* counts, int* offsets, int* cursor,
                                  uint16_t* pslot, float* pval,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0 || B == 0 || k == 0) return (int)cudaGetLastError();
  if (C > ITEMS * threads || W < 1 || W > 65536 || (W & (W - 1)) ||
      window > 32768 || kc < 1)
    return (int)cudaErrorInvalidValue;
  const int hist_smem = window * (int)sizeof(int);
  const int scatter_smem = 3 * hist_smem + C * (4 * kc + 4);
  const int tile_smem = W * kc * (int)sizeof(float);
  const long long bins = (B + W - 1) / W;
  const bool one_pass = bins <= window && kc >= k;
  void (*scatter)(PartArgs) = one_pass ? part_scatter_kernel<true>
                                       : part_scatter_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, scatter_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bin_accumulate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned chunks = (unsigned)((n + C - 1) / C);
  PartArgs a;
  a.n = n; a.B = B; a.k = k; a.W = W; a.C = C;
  a.wshift = 0;
  while ((1 << a.wshift) < W) ++a.wshift;
  a.counts = counts; a.offsets = offsets; a.cursor = cursor;
  a.pslot = pslot; a.pval = pval;
  for (int g0 = 0; g0 < m; g0 += G) {
    const int groups = m - g0 < G ? m - g0 : G;
    for (int j0 = 0; j0 < k; j0 += kc) {
      a.kc = k - j0 < kc ? k - j0 : kc;
      a.slot = slot + g0 * n;
      a.contrib = contrib + g0 * n * k + j0;
      a.tables = tables + g0 * B * k + j0;
      for (long long b0 = 0; b0 < bins; b0 += window) {
        a.b0 = (int)b0;
        a.P = (int)(bins - b0 < window ? bins - b0 : window);
        e = cudaMemsetAsync(counts, 0, (size_t)groups * a.P * sizeof(int),
                            st);
        if (e != cudaSuccess) return (int)e;
        if (chunks)
          part_hist_kernel<<<dim3(chunks, groups), threads, hist_smem,
                             st>>>(a);
        part_scan_kernel<<<groups, threads, 0, st>>>(a);
        if (chunks)
          scatter<<<dim3(chunks, groups), threads, scatter_smem, st>>>(a);
        bin_accumulate_kernel<<<dim3(a.P, groups), threads, tile_smem,
                                st>>>(a);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
      }
    }
  }
  return (int)cudaSuccess;
}

extern "C" const char* binning_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
