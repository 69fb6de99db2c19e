// Device functions of the row-tight expansion (emission.cu): the
// row_extents math split into its per-gaussian and per-row halves, the
// two searches, the block scan and the decoupled look-back that K5 and K6
// are built from.
//
// The searches.  upper_bound_local is one thread's binary search, meant
// for a table a block has staged in shared memory, where a step costs a
// few dozen cycles.  warp_upper_bound is the search a whole warp makes
// over global memory, once for a block: each round probes 32 evenly
// spaced entries with one load per lane and keeps the interval between the
// last probe <= v and the next, so 2^20 entries take four dependent loads
// where one thread's binary search chains twenty.
//
// The look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", NVIDIA technical report NVR-2016-002).  A
// chain is one 64-bit status word per chunk, zero before the launch: the
// flag in the high half (kAggregate: the value is the chunk's own sum;
// kInclusive: the sum of every chunk up to and including it) and the value
// in the low half, stored and loaded as one word so that a flag is never
// seen without its value.  A chunk publishes its aggregate as soon as it
// has it and its inclusive sum once it knows it; its exclusive prefix is
// the sum of the aggregates back to the nearest inclusive sum.  Chunks
// take their numbers from an atomic ticket in the order they start, so a
// chunk only ever waits on chunks that are already running: no deadlock,
// whatever order the hardware starts blocks in.  Every value is an int32
// count, and an integer sum is the same in any order, so the result does
// not depend on which predecessors had published what.
#pragma once
#include <cuda_runtime.h>

namespace gs {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// binning.py::_row_extents, the terms that depend on the gaussian alone
// (its rect, mean, conic and 2 t_iso) and its depth bits: 56 bytes, read
// as seven 8-byte loads
struct __align__(8) GaussRows {
  float mx, my, t2, q, a_s, hx, hy, dyv, ncb, t2ca;
  int ymin, xmin, xmax, depth_bits;
};

__device__ __forceinline__ GaussRows gauss_terms(int ymin, int xmin, int xmax,
                                                 float mx, float my, float ca,
                                                 float cb, float cc, float t2,
                                                 int depth_bits) {
  GaussRows g;
  g.mx = mx;
  g.my = my;
  g.t2 = t2;
  g.q = ca * cc - cb * cb;
  const float qs = fmaxf(g.q, 1e-20f);
  const float cs = fmaxf(cc, 1e-20f);
  g.a_s = fmaxf(ca, 1e-20f);
  g.hx = sqrtf(fmaxf(t2 * cs / qs, 0.0f));
  g.hy = sqrtf(fmaxf(t2 * g.a_s / qs, 0.0f));
  g.ncb = -cb;
  g.dyv = g.ncb * sqrtf(fmaxf(t2 / (cs * qs), 0.0f));
  g.t2ca = t2 * ca;
  g.ymin = ymin;
  g.xmin = xmin;
  g.xmax = xmax;
  g.depth_bits = depth_bits;
  return g;
}

// x / tile_w, correctly rounded: for a power-of-two tile_w the product by
// its reciprocal, which is exact, is the same quotient without the IEEE
// division's instruction sequence
__device__ __forceinline__ float div_tile(float x, int tile_w) {
  if ((tile_w & (tile_w - 1)) == 0)
    return x * __int_as_float((127 - (__ffs(tile_w) - 1)) << 23);
  return x / (float)tile_w;
}

// binning.py::_row_extents, the rest, one operation at a time: tile row k
// of the gaussian (counted from its rect's first row) -> (ty, txmin, w) of
// that row's covering of the alpha >= 1/255 iso-ellipse.  The same
// operations on the same inputs as the expression written out in one
// piece, so the same bits (emission.cu builds with -fmad=false).
__device__ __forceinline__ void row_half(const GaussRows& g, int k, int tile_w,
                                         int tile_h, int* ty_out,
                                         int* txmin_out, int* w_out) {
  const int ty = g.ymin + k;
  const float lo = (float)ty * (float)tile_h - g.my - 0.25f;
  const float hi = lo + (float)(tile_h - 1) + 0.5f;
  const float lc = fmaxf(lo, -g.hy);
  const float uc = fminf(hi, g.hy);
  const float sd_l = sqrtf(fmaxf(g.t2ca - g.q * lc * lc, 0.0f));
  const float sd_u = sqrtf(fmaxf(g.t2ca - g.q * uc * uc, 0.0f));
  const float dxp_l = (g.ncb * lc + sd_l) / g.a_s;
  const float dxp_u = (g.ncb * uc + sd_u) / g.a_s;
  const float dxm_l = (g.ncb * lc - sd_l) / g.a_s;
  const float dxm_u = (g.ncb * uc - sd_u) / g.a_s;
  float xhi = fmaxf(dxp_l, dxp_u);
  if (g.dyv >= lc - 1.0f && g.dyv <= uc + 1.0f) xhi = fmaxf(xhi, g.hx);
  float xlo = fminf(dxm_l, dxm_u);
  const float ndyv = -g.dyv;
  if (ndyv >= lc - 1.0f && ndyv <= uc + 1.0f) xlo = fminf(xlo, -g.hx);

  int txmin = (int)fmaxf(floorf(div_tile(g.mx + xlo - 0.25f, tile_w)),
                         (float)g.xmin);
  int txmax = (int)fminf(
      floorf(div_tile(g.mx + xhi + 0.25f, tile_w)) + 1.0f, (float)g.xmax);
  const bool tight = g.t2 > 0.0f;
  if (!tight) {
    txmin = g.xmin;
    txmax = g.xmax;
  }
  int w = max(txmax - txmin, 0);
  if (!((lc <= uc) || !tight)) w = 0;
  *ty_out = ty;
  *txmin_out = txmin;
  *w_out = w;
}

// first i in [0, n) with a[i] > v, or n (a non-decreasing); one thread,
// plain loads (shared memory)
__device__ __forceinline__ int upper_bound_local(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the same search by a whole warp over global memory (every lane calls it
// and gets the result): the answer lies in [lo, hi]; a round's probes at
// lo + lane * step that hold an entry <= v are a prefix of the lanes, m of
// them, and the answer lies after the last of those and at or before the
// next probe
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ a,
                                                int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const bool le = i < hi && __ldg(a + i) <= v;
    const int m = __popc(__ballot_sync(kFullMask, le));
    if (m == 0) {
      hi = lo;
    } else {
      const int next = lo + m * step;
      lo += (m - 1) * step + 1;
      hi = min(next, hi);
    }
  }
  return lo;
}

// exclusive prefix sum of v over a block of kThreads threads (every thread
// calls it), the block's total in *total; s_warp holds kThreads / 32
// values.  A 64-bit T scans two 32-bit counts packed in one word.
template <int kThreads, typename T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* s_warp, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const T s = s_warp[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();  // s_warp may be written again after the return
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ void status_store(unsigned long long* p,
                                             unsigned long long flag,
                                             int value) {
  const unsigned long long w = flag | (unsigned)value;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_load(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// the value of chunk c's inclusive sum, once published (one thread)
__device__ __forceinline__ int wait_inclusive(const unsigned long long* chain,
                                              int c) {
  unsigned long long w;
  while (((w = status_load(chain + c)) >> 32) != 2) __nanosleep(64);
  return (int)(unsigned)w;
}

// the sum of chunks [0, c) of a chain (one whole warp calls it; every lane
// gets the sum): the loads of kDepth x 32 predecessors issued at once,
// then, 32 at a time from the nearest, each waited for until it has
// published something and their values added, back to the nearest
// inclusive sum.  Only the predecessors nearer than that sum are waited
// for: a chunk that has published nothing holds up no later inclusive sum
// either, and the chunks before an inclusive sum are already in it
template <int kDepth>
__device__ __forceinline__ int lookback_exclusive(
    const unsigned long long* chain, int c) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int end = c; end > 0; end -= 32 * kDepth) {
    unsigned long long w[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = end - 1 - 32 * k - lane;
      w[k] = i >= 0 ? status_load(chain + i) : kInclusive;
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      while (__any_sync(kFullMask, (w[k] >> 32) == 0)) {
        if ((w[k] >> 32) == 0) {
          __nanosleep(32);
          w[k] = status_load(chain + (end - 1 - 32 * k - lane));
        }
      }
      const unsigned incl = __ballot_sync(kFullMask, (w[k] >> 32) == 2);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      int v = lane <= stop ? (int)(unsigned)w[k] : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
      sum += v;
      if (incl) return sum;
    }
  }
  return sum;
}

}  // namespace gs
