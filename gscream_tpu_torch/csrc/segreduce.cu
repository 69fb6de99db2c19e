// Per-gaussian segment reductions for Hopper (sm_90a): K3 and K7 of the
// training path.
//
// K3 gs_segment_reduce replaces the Pallas kernel
//    gscream_tpu/ops/rasterize_tiled.py::_segreduce_cm_kernel (:899,
//    launched by segment_reduce_cm :939), the default GSCREAM_REORDER=cm.
// K7 gs_segment_reduce_rows replaces the Pallas kernel
//    gscream_tpu/ops/rasterize_tiled.py::_segreduce_kernel (:992,
//    launched by segment_reduce_grads :1087), GSCREAM_REORDER=gather,
//    scatter or sort.
//
// What they compute: out[g, k] = the sum over gaussian g's emission run
// [offsets[g], offsets[g+1]) of the gradient value (e, k), the offsets
// clamped to the capacity cap as the JAX builds clamp them (:958-959).
// K3 reads (16, cap) columns, K7 (cap, 16) rows, both in emission order,
// in which every gaussian's instances are contiguous.  The TPU summed each
// block with indicator matmuls on the MXU.
//
// The summation order, which the plain versions in ops/rasterize_tiled.py
// reproduce bit for bit.  Let n_live = min(offsets[N], cap) and cut the
// instances [0, n_live), in emission order, into chunks of kChunk = 32 (one
// warp; SEG_CHUNK there): chunk c = [32c, 32c + 32).  Inside a chunk, the
// instances of one gaussian form a segment.
//  1. Inside a chunk: a segmented Hillis-Steele inclusive scan over the 32
//     slots for d = 1, 2, 4, 8, 16.  Slot i, whose segment starts at slot s
//     (the slot of max(offsets[g], 32c)), takes v[i] + v_prev[i - d] if
//     i - d >= s and keeps v[i] otherwise.  A segment's chunk partial is v
//     at its last slot in the chunk.
//  2. Across chunks: a gaussian whose run lies in one chunk takes that
//     partial; one whose run spans chunks c0..c1 adds its partials left to
//     right, ((p[c0] + p[c0+1]) + ...) + p[c1], starting from p[c0].
//  3. An empty run, or one the capacity clamps away, gives a row of zeros.
//  4. Masking is a select, never a multiply: a NaN or inf in one
//     gaussian's instance cannot reach a neighbour in the same chunk, and
//     stays in that gaussian's own sum.
// The order depends on the offsets alone and every addition is made by
// one thread at a fixed place in it, so a rerun is bit-equal and K3 is
// bit-equal to K7 on the same values.
//
// Design.  Level 1 (segreduce_chunks, one template for both layouts): one
// warp per chunk, 8 chunks per CTA.  The warp loads its chunk (K3: lane i
// reads cols[k * cap + 32c + i], 16 coalesced 128-byte loads; K7: each lane
// its 64-byte row as four float4, 2 KB contiguous per warp), finds each
// lane's gaussian by binary search of the offsets (two searches over all
// gaussians bracket the chunk's first and last instance, then each lane
// searches inside that bracket), runs the scan with __shfl_up_sync (5 steps
// x 16 values) and writes each segment's partial: out[g] when the run
// starts and ends in the chunk, else into the scratch rows head[c] (the
// segment that holds slot 0) and tail[c] (the one that holds slot 31).
// Level 2 (segreduce_spans): one thread per gaussian leaves a one-chunk
// run to level 1 and sums a spanning run's tail[c0], head[c0+1..c1-1] and
// head[c1] in turn; each warp writes the zero rows of its empty runs
// together, 512 contiguous bytes per store.  No thread adds more than 32
// instances in level 1; the longest serial chain is level 2's, the longest
// run's chunk count.
//
// Bound on the H100: bytes.  Each live instance's 64 bytes read once and
// the (N, 16) sums written once; the offsets and the (2, chunks, 16)
// partials are a few MB and stay in the 50 MB L2.  The loads are coalesced
// and no lane waits on a long run, so the time follows the bytes, not the
// longest run.  Level 1 runs at full occupancy (32 registers): issuing the
// chunk's loads before the search took 40 registers and was slower, and
// two to eight chunks per warp (one search for all) gained a few percent
// at most.  TMA, clusters and persistent CTAs are left out: the work is
// one streaming pass with nothing to stage or reuse.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;        // floats per instance
constexpr int kChunk = 32;        // instances per chunk: one warp
constexpr int kWarps = 8;         // chunks per level-1 CTA
constexpr int kThreads = 256;     // level-2 threads per CTA
constexpr unsigned kFull = 0xffffffffu;

// the largest g in [lo, hi) with offsets[g] <= e, given offsets[lo] <= e <
// offsets[hi]
__device__ __forceinline__ int find_gaussian(const int* __restrict__ offsets,
                                             int lo, int hi, int e) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&v)[kLanes]) {
  float4* o = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kLanes / 4; ++q) {
    o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

template <bool kRows>   // false: (16, cap) columns (K3); true: (cap, 16) rows (K7)
__global__ void __launch_bounds__(kWarps * 32)
segreduce_chunks(const float* __restrict__ src, const int* __restrict__ offsets,
                 int n, int cap, float* __restrict__ head,
                 float* __restrict__ tail, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int base = c * kChunk;
  const int n_live = min(__ldg(offsets + n), cap);
  // the chunk's first and last instance that belongs to some gaussian
  const int e_first = max(base, __ldg(offsets));
  const int e_last = min(base + kChunk, n_live) - 1;
  if (e_first > e_last) return;               // uniform across the warp
  const int g_probe = find_gaussian(offsets, 0, n, lane < 16 ? e_first
                                                             : e_last);
  const int g_first = __shfl_sync(kFull, g_probe, 0);
  const int g_last = __shfl_sync(kFull, g_probe, 31);

  const int e = base + lane;
  const bool live = e >= e_first && e <= e_last;
  int g = 0, lo = 0, hi = 0;
  int s = kChunk;                             // no segment: never adds
  float v[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) v[k] = 0.0f;
  if (live) {
    g = find_gaussian(offsets, g_first, g_last + 1, e);
    lo = __ldg(offsets + g);
    hi = min(__ldg(offsets + g + 1), cap);
    s = max(lo, base) - base;
    if constexpr (kRows) {
      const float4* r = reinterpret_cast<const float4*>(src) +
                        (size_t)e * (kLanes / 4);
#pragma unroll
      for (int q = 0; q < kLanes / 4; ++q) {
        const float4 x = __ldg(r + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLanes; ++k) v[k] = __ldg(src + (size_t)k * cap + e);
    }
  }

#pragma unroll
  for (int d = 1; d < kChunk; d <<= 1) {
    const bool take = lane - d >= s;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const float up = __shfl_up_sync(kFull, v[k], d);
      if (take) v[k] += up;
    }
  }

  if (live && (lane == kChunk - 1 || e + 1 == hi)) {   // the segment's end
    const bool before = lo < base;            // holds slot 0, began earlier
    const bool after = hi > base + kChunk;    // holds slot 31, goes on
    if (!before && !after) store_row(out + (size_t)g * kLanes, v);
    if (before) store_row(head + (size_t)c * kLanes, v);
    if (after) store_row(tail + (size_t)c * kLanes, v);
  }
}

__global__ void __launch_bounds__(kThreads)
segreduce_spans(const int* __restrict__ offsets, int n, int cap,
                const float* __restrict__ head,
                const float* __restrict__ tail, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  if (g0 >= n) return;                        // uniform across the warp
  const int g = g0 + lane;
  int lo = 0, hi = 0;
  if (g < n) {
    lo = min(__ldg(offsets + g), cap);
    hi = min(__ldg(offsets + g + 1), cap);
  }
  // the warp writes its empty rows' zeros together, 512 contiguous bytes
  // per store, rather than each lane its own 64-byte row
  const int empty = g < n && hi <= lo;
  float4* o = reinterpret_cast<float4*>(out) + (size_t)g0 * (kLanes / 4);
#pragma unroll
  for (int f = lane; f < 32 * (kLanes / 4); f += 32) {
    if (__shfl_sync(kFull, empty, f / (kLanes / 4))) {
      o[f] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  if (g >= n || empty) return;
  float acc[kLanes];
  const int c0 = lo / kChunk;
  const int c1 = (hi - 1) / kChunk;
  if (c0 == c1) return;                       // level 1 wrote it
  const float4* t = reinterpret_cast<const float4*>(tail) +
                    (size_t)c0 * (kLanes / 4);
#pragma unroll
  for (int q = 0; q < kLanes / 4; ++q) {
    const float4 x = t[q];
    acc[4 * q] = x.x;
    acc[4 * q + 1] = x.y;
    acc[4 * q + 2] = x.z;
    acc[4 * q + 3] = x.w;
  }
#pragma unroll 4
  for (int cc = c0 + 1; cc <= c1; ++cc) {
    const float4* h = reinterpret_cast<const float4*>(head) +
                      (size_t)cc * (kLanes / 4);
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      const float4 x = h[q];
      acc[4 * q] += x.x;
      acc[4 * q + 1] += x.y;
      acc[4 * q + 2] += x.z;
      acc[4 * q + 3] += x.w;
    }
  }
  store_row(out + (size_t)g * kLanes, acc);
}

// both levels on ``stream``; ``scratch`` holds head then tail, each
// (ceil(cap / 32), 16) float32
template <bool kRows>
int segment_reduce(const float* src, const int* offsets, int n, int cap,
                   float* scratch, float* out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int chunks = (cap + kChunk - 1) / kChunk;
  if (chunks > 0) {
    segreduce_chunks<kRows><<<(chunks + kWarps - 1) / kWarps, kWarps * 32, 0,
                              stream>>>(src, offsets, n, cap, scratch,
                                        scratch + (size_t)chunks * kLanes,
                                        out);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  segreduce_spans<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      offsets, n, cap, scratch, scratch + (size_t)chunks * kLanes, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gs_segment_reduce(const float* cols, const int* offsets,
                                 int n, int cap, float* scratch, float* out,
                                 cudaStream_t stream) {
  return segment_reduce<false>(cols, offsets, n, cap, scratch, out, stream);
}

extern "C" int gs_segment_reduce_rows(const float* rows, const int* offsets,
                                      int n, int cap, float* scratch,
                                      float* out, cudaStream_t stream) {
  return segment_reduce<true>(rows, offsets, n, cap, scratch, out, stream);
}
