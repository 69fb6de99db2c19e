// Row-tight instance expansion for Hopper (sm_90a): K5 and K6 of the
// render path's tile binning, and K9's EXPAND1 and EXPAND2 of the
// Pallas-emission build (GSCREAM_EMIT=pallas).
//
// K5 gs_expand_gauss_rows replaces the Pallas kernel
//    gscream_tpu/ops/emission.py::_expand_gauss_kernel (:346, launched by
//    expand_gauss_rows :421) and the XLA ops around it in
//    gscream_tpu/ops/binning.py (the rect heights and their prefix sum, the
//    w_row prefix sum and the per-gaussian offsets: :178-213, :485-490).
//    gs_count_emission is K5 counting only (emission_counts).
// K6 gs_expand_rows replaces the Pallas kernel
//    gscream_tpu/ops/emission.py::_expand_rows_kernel (:321, launched by
//    expand_rows :467).
// K9a gs_expand1 replaces the Pallas kernel
//    gscream_tpu/ops/emission.py::_expand1_kernel (:118, launched by
//    _run_expand :226 from bin_instances_pallas :568).
// K9b gs_expand2 replaces the Pallas kernel
//    gscream_tpu/ops/emission.py::_expand2_kernel (:185, launched by
//    _run_expand :226 from bin_instances_pallas :611).
//
// What they compute (stage 1 and stage 2 of the XLA row-tight build,
// gscream_tpu/ops/binning.py:104-213 and :465-490):
//  K5: gaussian g emits rect height h[g] = rect_max.y - rect_min.y tile
//      rows if radius > 0 and rect_max.x > rect_min.x, else none; it owns
//      the rows [row_offs[g], row_offs[g+1]) of a table of row_cap slots
//      (row_offs the exclusive prefix sum of h), truncated at row_cap.
//      Slot r holds (tile_base, gid, depth_bits, w_row): the first tile and
//      width of that tile row's covering of the alpha >= 1/255 iso-ellipse
//      (_row_extents, expression for expression).  Slots at or past
//      total_rows = sum(h) hold zeros.  ioffs is the exclusive prefix sum
//      of w_row over the table; offsets[g] = min(ioffs_ext[min(row_offs[g],
//      row_cap)], capacity) (ioffs_ext = ioffs with the total appended: a
//      gaussian without rows takes the next start), offsets[N] the
//      clamped total; counts = (total_rows, total), the row demand and the
//      instances of the rows below row_cap.
//  K6: every row r with w_row[r] > 0 owns the instance slots
//      [ioffs[r], ioffs[r] + w_row[r]); slot s holds (tile_base[r] + s -
//      ioffs[r], gid[r], depth_bits[r]).  Slots at or past min(total,
//      capacity) hold (n_tiles, 0, 2^30): the invalid tile sorts them last.
//
//  K9a: K5's table over the COMPACTED emitting gaussians (stage A of
//      bin_instances_pallas), carrying the attribute payload: row slot r
//      holds the int32 (gid, ty, txmin, w_row) and the float32 (mx, my,
//      ca, cb, cc, depth, op, r, g, b, unc) of its gaussian, zeros where
//      r >= total_rows.  The same row_extents math as K5.
//  K9b: K6 over the compacted non-empty rows (stage C), writing whole
//      instance records: slot s holds the float32 [op, r, g, b, depth,
//      unc, k0..k5, sx, sy] of pack_instance_data (k0..k2 the tile-local
//      power coefficients, sx/sy the shift into the rounded-centre frame,
//      round half to even as jnp.round) and the int32 (tile, gid); slots
//      at or past min(total, capacity) hold zeros and tile n_tiles.
//
// K5's design: one pass over fixed chunks of kChunk = 512 gaussians, two
// per thread.  A chunk's rows are a contiguous range of the table, and so
// are its instances, so a chunk needs two numbers from the chunks before
// it, its row base and its instance base, each from a decoupled look-back
// (expand.cuh).  A CTA takes its chunk number from an atomic ticket,
// loads its gaussians' radius and rect, and block-scans their heights and
// their emit flags in one 64-bit scan; it publishes its row count at once
// and fills two maps in shared memory: each row's gaussian (for the first
// kRowCache rows; later rows search the chunk's 513-entry row prefix) and
// the emitting gaussians in order.  Warp 0 then looks back for the row
// base while the other warps compute the per-row-invariant terms of
// row_extents (q, a_s, hx, hy, dyv: three square roots and three
// divisions) once per emitting gaussian, packed onto consecutive threads
// (a quarter of the gaussians emit, so a thread per gaussian would run
// most lanes idle).  The threads walk the chunk's rows 256 at a time: the
// per-row half of row_extents, and the row's instance prefix inside the
// chunk from a block scan, both kept in shared memory (the first
// kRowCache rows; later rows go to the table and ioffs at once).  The
// chunk's instance count is published; warp 0 looks back for the
// instance base while the other warps write the kept rows' slots to the
// table's four columns (coalesced); then the CTA writes its rows' ioffs
// and its gaussians' offsets, and the last chunk offsets[N] and the
// counts.  CTAs with a ticket past the last chunk write the zero rows past
// total_rows once the last chunk has published its inclusive row count.
// Five CTAs per SM (at most 51 registers and 44 KB of shared memory
// each) hold all 640 chunks of N = 327,680 gaussians at once.
// The old design, one thread per row slot, ran a 19-step binary search
// over the whole row prefix in global memory per slot (a chain of
// dependent L2 loads, repeated by the ~20 slots of each gaussian),
// repeated the per-gaussian math per row, and needed ~21 PyTorch launches
// around it for the heights, the two scans and the offsets.
//
// K6's design: output-side, one CTA per kSpan = 1024 instance slots, so
// that a gaussian covering hundreds of tiles spreads over many CTAs.  Two
// warps of the CTA search global memory at once (warp_upper_bound: four
// dependent loads) for the rows that own its first and last live slot;
// the CTA stages those rows' ioffs, tile_base, gid and depth_bits in
// shared memory with coalesced loads (kSpan rows at a time: rows with
// w_row = 0 own no slot, so a range can span more rows than slots), and
// each thread finds the row of each of its slots by a binary search there.
// The writes stay attribute-major and coalesced.
//
// Bound on the H100: bytes.  K5 reads 20 bytes (radius and rect) of every
// gaussian and 28 more (mean2d, conic, t_iso, depth) of each emitting one,
// and writes the (4, row_cap) table, ioffs and the (N+1) offsets.  With
// every chunk resident, the phases run nearly in step across the card:
// the rect loads and the table writes at the memory's rate, with the row
// math (IEEE division and square root, several instructions each) and the
// two look-backs between them, each look-back waiting for the slowest
// chunk in its window to publish and then one or two rounds of L2 loads
// (an inclusive sum travels 256 chunks further per round).  K6 reads the
// live rows (16 bytes each) and writes 12 bytes per instance slot; its
// floor is the search's four L2 round trips and one staging load, in one
// wave of capacity / 1024 CTAs.  K9a reads 68 bytes per emitting gaussian
// and writes 60 per row slot; K9b reads 60 bytes per non-empty row and
// writes 64 per instance slot; both are still one thread per output slot
// with a binary search of the prefix in global memory.
//
// Numerics: built with -fmad=false and IEEE division and sqrt, so every
// float operation rounds exactly as PyTorch's elementwise ops do; the
// plain versions (gscream_tpu_torch/ops/emission.py) are then bit-equal
// on the card.  Every scan is an integer sum, the same in any order: a
// rerun is bit-equal.
#include <cuda_runtime.h>

#include "expand.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                   // gaussians per K5 thread
constexpr int kChunk = kThreads * kPer;   // gaussians per K5 chunk
constexpr int kRowCache = 1024;           // K5 rows with a shared-memory
                                          // slot (see s_row)
constexpr int kTailRows = 4096;           // row slots per K5 tail CTA
constexpr int kLookDepth = 8;             // K5 look-back: 8 x 32 chunks a
                                          // round
constexpr int kSpan = 1024;               // instance slots per K6 CTA

// first index i in [0, n) with a[i] > v, or n (K9a and K9b)
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// binning.py::_row_extents for K9a: tile row r of a gaussian whose rows
// start at r_off -> (ty, txmin, w)
__device__ __forceinline__ void row_extents(
    int r, int r_off, int r_ymin, int r_xmin, int r_xmax, float mx,
    float my, float ca, float cb, float cc, float t2, int tile_w,
    int tile_h, int* ty_out, int* txmin_out, int* w_out) {
  const gs::GaussRows g =
      gs::gauss_terms(r_ymin, r_xmin, r_xmax, mx, my, ca, cb, cc, t2, 0);
  gs::row_half(g, r - r_off, tile_w, tile_h, ty_out, txmin_out, w_out);
}

// K5's CTAs past the last chunk: the table rows [total_rows, row_cap) of
// their kTailRows slots hold zeros, once the last chunk has published its
// inclusive row count; with no chunk at all (n = 0) the first also writes
// offsets[0] and the counts
__device__ void write_tail(int k, int n, int n_chunks, int row_cap,
                           const unsigned long long* __restrict__ status,
                           int* __restrict__ rows, int* __restrict__ ioffs,
                           int* __restrict__ offsets,
                           int* __restrict__ counts, int* s_total) {
  const int r0 = k * kTailRows;
  const int r1 = min(r0 + kTailRows, row_cap);
  if (threadIdx.x == 0) {
    int total_rows = 0;
    if (n_chunks > 0) {
      total_rows = gs::wait_inclusive(status, n_chunks - 1);
    } else if (k == 0) {
      offsets[n] = 0;
      counts[0] = counts[1] = 0;
    }
    *s_total = total_rows;
  }
  __syncthreads();
  const size_t cap = (size_t)row_cap;
  for (int r = max(r0, *s_total) + threadIdx.x; r < r1; r += kThreads) {
    rows[r] = 0;
    rows[cap + r] = 0;
    rows[2 * cap + r] = 0;
    rows[3 * cap + r] = 0;
    ioffs[r] = 0;
  }
}

// K5; kCount: count only (gs_count_emission): no table, no truncation, the
// chunk's rows and instances added to counts, no ticket and no look-back.
// Five CTAs per SM (at most 51 registers) hold every chunk of N = 327,680
// gaussians at once.
template <bool kCount>
__global__ void __launch_bounds__(kThreads, 5) expand_gauss_rows_kernel(
    const int* __restrict__ radius,     // (n,)
    const int* __restrict__ rect_min,   // (n,2) tile rect start (x,y)
    const int* __restrict__ rect_max,   // (n,2) tile rect end (x,y)
    const float* __restrict__ mean2d,   // (n,2)
    const float* __restrict__ conic,    // (n,3)
    const float* __restrict__ t_iso,    // (n,)
    const float* __restrict__ depth,    // (n,)
    int n, int row_cap, int capacity, int tile_w, int tile_h, int grid_x,
    unsigned long long* __restrict__ status,  // (2 n_chunks + 1,) zeros:
                                              // row chain, instance chain,
                                              // ticket
    int* __restrict__ rows,             // (4,row_cap)
    int* __restrict__ ioffs,            // (row_cap,)
    int* __restrict__ offsets,          // (n+1,)
    int* __restrict__ counts) {         // (2,) total_rows, total
  static_assert(kRowCache >= kChunk, "s_emit lives in s_pre");
  __shared__ gs::GaussRows s_g[kChunk];
  __shared__ int s_off[kChunk + 1];
  // per row of the chunk below kRowCache: its gaussian j (then j | w << 16),
  // its tile_base, and its instance prefix inside the chunk; the rows past
  // it search s_off, and go to the table and ioffs at once
  __shared__ int s_row[kRowCache], s_tb[kRowCache], s_pre[kRowCache];
  int* s_emit = s_pre;      // until the terms: the emitting gaussians
  __shared__ int s_warp[kThreads / 32];
  __shared__ long long s_warp2[kThreads / 32];
  __shared__ int s_ticket, s_base[2];
  const int t = threadIdx.x;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  unsigned long long* row_chain = status;
  unsigned long long* inst_chain = status + n_chunks;
  int c = blockIdx.x;
  if (!kCount) {
    if (t == 0)
      s_ticket = atomicAdd(reinterpret_cast<int*>(status + 2 * n_chunks), 1);
    __syncthreads();
    c = s_ticket;
    if (c >= n_chunks) {
      write_tail(c - n_chunks, n, n_chunks, row_cap, status, rows, ioffs,
                 offsets, counts, s_base);
      return;
    }
  }

  // the thread's gaussians g0, g0 + 1: their rect heights; the row prefix
  // inside the chunk and the chunk's row count, published at once, and
  // each emitting gaussian's rank among them (one scan of both counts)
  const int g0 = c * kChunk + kPer * t;
  int h[kPer], h_sum = 0, n_emit = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int g = g0 + k;
    h[k] = 0;
    if (g < n) {
      const int x0 = __ldg(rect_min + 2 * g), x1 = __ldg(rect_max + 2 * g);
      if (__ldg(radius + g) > 0 && x1 > x0)
        h[k] = __ldg(rect_max + 2 * g + 1) - __ldg(rect_min + 2 * g + 1);
    }
    h_sum += h[k];
    n_emit += h[k] > 0;
  }
  long long both;
  const long long ex = gs::block_exclusive_sum<kThreads>(
      ((long long)h_sum << 32) | n_emit, s_warp2, &both);
  const int local_rows = (int)(both >> 32), chunk_emit = (int)both;
  if (t == 0) {
    s_off[kChunk] = local_rows;
    if (!kCount)
      gs::status_store(row_chain + c, c > 0 ? gs::kAggregate : gs::kInclusive,
                       local_rows);
  }
#pragma unroll
  for (int k = 0, o = (int)(ex >> 32), e = (int)ex; k < kPer;
       o += h[k], e += h[k] > 0, ++k) {
    const int j = kPer * t + k;
    s_off[j] = o;
    for (int r = o; r < min(o + h[k], kRowCache); ++r) s_row[r] = j;
    if (h[k] > 0) s_emit[e] = j;
  }
  __syncthreads();

  // the row base (the rows of the chunks before this one), looked back for
  // by warp 0 while the other warps compute the terms of the emitting
  // gaussians, packed onto their threads in order
  if (t < 32) {
    if (!kCount) {
      const int base =
          c > 0 ? gs::lookback_exclusive<kLookDepth>(row_chain, c) : 0;
      if (t == 0) {
        if (c > 0)
          gs::status_store(row_chain + c, gs::kInclusive, base + local_rows);
        s_base[0] = base;
      }
    }
  } else {
    for (int i = t - 32; i < chunk_emit; i += kThreads - 32) {
      const int j = s_emit[i], g = c * kChunk + j;
      s_g[j] = gs::gauss_terms(
          __ldg(rect_min + 2 * g + 1), __ldg(rect_min + 2 * g),
          __ldg(rect_max + 2 * g), __ldg(mean2d + 2 * g),
          __ldg(mean2d + 2 * g + 1), __ldg(conic + 3 * g),
          __ldg(conic + 3 * g + 1), __ldg(conic + 3 * g + 2),
          2.0f * __ldg(t_iso + g), __float_as_int(__ldg(depth + g)));
    }
  }
  __syncthreads();
  const int row_base = kCount ? 0 : s_base[0];

  // the rows below row_cap, 256 at a time: each one's tile_base and w, and
  // its instance prefix inside the chunk from a block scan (kCount: each
  // thread's sum)
  const int keep =
      kCount ? local_rows : min(max(row_cap - row_base, 0), local_rows);
  const size_t cap = (size_t)row_cap;
  int carry = 0;
  for (int p = 0; p < keep; p += kThreads) {
    const int lr = p + t;
    int w = 0;
    if (lr < keep) {
      const int j = lr < kRowCache
          ? s_row[lr] : gs::upper_bound_local(s_off, kChunk + 1, lr) - 1;
      int ty, txmin;
      gs::row_half(s_g[j], lr - s_off[j], tile_w, tile_h, &ty, &txmin, &w);
      if (!kCount) {
        if (lr < kRowCache) {
          s_row[lr] = j | (w << 16);
          s_tb[lr] = ty * grid_x + txmin;
        } else {
          const int r = row_base + lr;
          rows[r] = ty * grid_x + txmin;
          rows[cap + r] = c * kChunk + j;
          rows[2 * cap + r] = s_g[j].depth_bits;
          rows[3 * cap + r] = w;
        }
      }
    }
    if (kCount) {
      carry += w;
    } else {
      int sum;
      const int e = gs::block_exclusive_sum<kThreads>(w, s_warp, &sum);
      if (lr < keep) {
        if (lr < kRowCache) s_pre[lr] = carry + e;
        else ioffs[row_base + lr] = carry + e;
      }
      carry += sum;
    }
  }
  if (kCount) {
    int sum;
    gs::block_exclusive_sum<kThreads>(carry, s_warp, &sum);
    if (t == 0) {
      atomicAdd(counts, local_rows);
      atomicAdd(counts + 1, sum);
    }
    return;
  }

  // the chunk's instance count published; each gaussian's instance prefix
  // inside the chunk: at its first row, or the chunk's total where that
  // row is dropped or past the chunk.  Warp 0 looks back for the instance
  // base (the instances of the chunks before this one) while the other
  // warps write the table slots of the rows kept in shared memory
  if (t == 0)
    gs::status_store(inst_chain + c, c > 0 ? gs::kAggregate : gs::kInclusive,
                     carry);
  __syncthreads();      // s_row, s_tb, s_pre, and the ioffs past kRowCache
  int g_prefix[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int first = s_off[kPer * t + k];
    g_prefix[k] = first >= keep ? carry
        : first < kRowCache ? s_pre[first]
        : __ldcg(ioffs + row_base + first);
  }
  if (t < 32) {
    const int base =
        c > 0 ? gs::lookback_exclusive<kLookDepth>(inst_chain, c) : 0;
    if (t == 0) {
      if (c > 0)
        gs::status_store(inst_chain + c, gs::kInclusive, base + carry);
      s_base[1] = base;
    }
  } else {
    for (int lr = t - 32; lr < min(keep, kRowCache); lr += kThreads - 32) {
      const int v = s_row[lr], j = v & 0xffff, r = row_base + lr;
      rows[r] = s_tb[lr];
      rows[cap + r] = c * kChunk + j;
      rows[2 * cap + r] = s_g[j].depth_bits;
      rows[3 * cap + r] = v >> 16;
    }
  }
  __syncthreads();
  const int inst_base = s_base[1];
  for (int lr = t; lr < keep; lr += kThreads)
    ioffs[row_base + lr] = inst_base + (lr < kRowCache
                                        ? s_pre[lr]
                                        : ioffs[row_base + lr]);  // own write
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (g0 + k < n) offsets[g0 + k] = min(inst_base + g_prefix[k], capacity);
  if (c == n_chunks - 1 && t == 0) {
    offsets[n] = min(inst_base + carry, capacity);
    counts[0] = row_base + local_rows;
    counts[1] = inst_base + carry;
  }
}

__global__ void __launch_bounds__(kThreads) expand_rows_kernel(
    const int* __restrict__ ioffs,      // (row_cap,) exclusive prefix of w
    const int* __restrict__ rows,       // (4,row_cap) K5's table
    const int* __restrict__ counts,     // (2,) K5's total_rows, total
    int row_cap, int capacity, int n_tiles,
    int* __restrict__ out) {            // (3,capacity)
  __shared__ int s_io[kSpan], s_tb[kSpan], s_gid[kSpan], s_dep[kSpan];
  __shared__ int s_rows[2];
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kSpan;
  const int s_end = min(s0 + kSpan, capacity);
  const int n_rows = min(__ldg(counts), row_cap);
  const int live_end = min(s_end, __ldg(counts + 1));
  const size_t cap = (size_t)capacity;
  if (s0 < live_end) {
    // the rows that own the first and the last live slot
    if (t < 64) {
      const int r = gs::warp_upper_bound(ioffs, n_rows,
                                         t < 32 ? s0 : live_end - 1) - 1;
      if ((t & 31) == 0) s_rows[t >> 5] = r;
    }
    __syncthreads();
    const int r_stop = s_rows[1] + 1;
    int r_begin = s_rows[0], s_begin = s0;
    while (s_begin < live_end && r_begin < r_stop) {
      const int nb = min(kSpan, r_stop - r_begin);
      for (int i = t; i < nb; i += kThreads) {
        const int r = r_begin + i;
        s_io[i] = __ldg(ioffs + r);
        s_tb[i] = __ldg(rows + r);
        s_gid[i] = __ldg(rows + (size_t)row_cap + r);
        s_dep[i] = __ldg(rows + 2 * (size_t)row_cap + r);
      }
      // the slots these rows own: up to the next row's first slot
      const int b_end = r_begin + nb < r_stop
          ? min(__ldg(ioffs + r_begin + nb), live_end) : live_end;
      __syncthreads();
      for (int s = s_begin + t; s < b_end; s += kThreads) {
        const int j = gs::upper_bound_local(s_io, nb, s) - 1;
        out[s] = s_tb[j] + (s - s_io[j]);
        out[cap + s] = s_gid[j];
        out[2 * cap + s] = s_dep[j];
      }
      s_begin = max(s_begin, b_end);
      r_begin += nb;
      __syncthreads();
    }
  }
  for (int s = max(s0, live_end) + t; s < s_end; s += kThreads) {
    out[s] = n_tiles;
    out[cap + s] = 0;
    out[2 * cap + s] = 1 << 30;
  }
}

constexpr int kAttrs = 11;   // mx, my, ca, cb, cc, depth, op, r, g, b, unc
constexpr int kGaussF = 12;  // the same with t2 after cc: the K9a table
constexpr int kRecord = 14;  // op, r, g, b, depth, unc, k0..k5, sx, sy

__global__ void expand1_kernel(
    const int* __restrict__ ro,         // (n+1,) compacted row prefix
    const int* __restrict__ gi,         // (n,4) gid, ymin, xmin, xmax
    const float* __restrict__ gf,       // (n,12) mx my ca cb cc t2 depth
                                        //        op r g b unc
    int n, int row_cap, int tile_w, int tile_h,
    int* __restrict__ idx,              // (4,row_cap) gid ty txmin w_row
    float* __restrict__ attr) {         // (11,row_cap)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row_cap) return;
  const int total_rows = __ldg(ro + n);
  int gid = 0, ty = 0, txmin = 0, w = 0;
  float a[kAttrs];
#pragma unroll
  for (int k = 0; k < kAttrs; ++k) a[k] = 0.0f;
  if (r < total_rows) {
    const int g = upper_bound(ro, n + 1, r) - 1;
    const int* gr = gi + 4 * g;
    const float* f = gf + kGaussF * g;
    gid = __ldg(gr);
    row_extents(r, __ldg(ro + g), __ldg(gr + 1), __ldg(gr + 2),
                __ldg(gr + 3), __ldg(f), __ldg(f + 1), __ldg(f + 2),
                __ldg(f + 3), __ldg(f + 4), __ldg(f + 5), tile_w, tile_h,
                &ty, &txmin, &w);
#pragma unroll
    for (int k = 0; k < 5; ++k) a[k] = __ldg(f + k);          // mx..cc
#pragma unroll
    for (int k = 5; k < kAttrs; ++k) a[k] = __ldg(f + k + 1);  // depth..unc
  }
  idx[r] = gid;
  idx[row_cap + r] = ty;
  idx[2 * row_cap + r] = txmin;
  idx[3 * row_cap + r] = w;
#pragma unroll
  for (int k = 0; k < kAttrs; ++k) attr[(size_t)k * row_cap + r] = a[k];
}

__global__ void expand2_kernel(
    const int* __restrict__ io,         // (row_cap+1,) exclusive prefix of
                                        // the compacted w_row + total
    const int* __restrict__ ri,         // (3,row_cap) gid ty txmin
    const float* __restrict__ rf,       // (11,row_cap) as K9a's attr
    int row_cap, int capacity, int tile_w, int tile_h, int grid_x,
    int n_tiles,
    float* __restrict__ rec,            // (14,capacity) records
    int* __restrict__ ids) {            // (2,capacity) tile gid
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= capacity) return;
  const int total = __ldg(io + row_cap);
  int tile = n_tiles, gid = 0;
  float v[kRecord];
#pragma unroll
  for (int k = 0; k < kRecord; ++k) v[k] = 0.0f;
  if (s < min(total, capacity)) {
    const int r = upper_bound(io, row_cap + 1, s) - 1;
    gid = __ldg(ri + r);
    const int ty = __ldg(ri + row_cap + r);
    const int tx = __ldg(ri + 2 * row_cap + r) + (s - __ldg(io + r));
    tile = ty * grid_x + tx;
    const float ox = (float)(tx * tile_w);
    const float oy = (float)(ty * tile_h);
    const float mx = __ldg(rf + r);
    const float my = __ldg(rf + row_cap + r);
    const float ca = __ldg(rf + 2 * row_cap + r);
    const float cb = __ldg(rf + 3 * row_cap + r);
    const float cc = __ldg(rf + 4 * row_cap + r);
    // rasterize_tiled.py::pack_instance_data, one operation at a time
    const float mxl = mx - ox;
    const float myl = my - oy;
    v[0] = __ldg(rf + 6 * row_cap + r);                  // op
    v[1] = __ldg(rf + 7 * row_cap + r);                  // r
    v[2] = __ldg(rf + 8 * row_cap + r);                  // g
    v[3] = __ldg(rf + 9 * row_cap + r);                  // b
    v[4] = __ldg(rf + 5 * row_cap + r);                  // depth
    v[5] = __ldg(rf + 10 * row_cap + r);                 // unc
    v[6] = -0.5f * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl;
    v[7] = ca * mxl + cb * myl;
    v[8] = cc * myl + cb * mxl;
    v[9] = -0.5f * ca;
    v[10] = -cb;
    v[11] = -0.5f * cc;
    // rintf rounds half to even, as jnp.round and torch.round do (roundf
    // would round half away from zero)
    v[12] = ox - rintf(mx);
    v[13] = oy - rintf(my);
  }
#pragma unroll
  for (int k = 0; k < kRecord; ++k) rec[(size_t)k * capacity + s] = v[k];
  ids[s] = tile;
  ids[capacity + s] = gid;
}

}  // namespace

extern "C" int gs_expand_gauss_rows(
    const int* radius, const int* rect_min, const int* rect_max,
    const float* mean2d, const float* conic, const float* t_iso,
    const float* depth, int n, int row_cap, int capacity, int tile_w,
    int tile_h, int grid_x, unsigned long long* status, int* rows,
    int* ioffs, int* offsets, int* counts, cudaStream_t stream) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int n_tail = (row_cap + kTailRows - 1) / kTailRows;
  if (n_chunks + n_tail > 0)
    expand_gauss_rows_kernel<false><<<n_chunks + n_tail, kThreads, 0,
                                      stream>>>(
        radius, rect_min, rect_max, mean2d, conic, t_iso, depth, n, row_cap,
        capacity, tile_w, tile_h, grid_x, status, rows, ioffs, offsets,
        counts);
  return (int)cudaGetLastError();
}

extern "C" int gs_count_emission(
    const int* radius, const int* rect_min, const int* rect_max,
    const float* mean2d, const float* conic, const float* t_iso,
    const float* depth, int n, int tile_w, int tile_h, int* counts,
    cudaStream_t stream) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0)
    expand_gauss_rows_kernel<true><<<n_chunks, kThreads, 0, stream>>>(
        radius, rect_min, rect_max, mean2d, conic, t_iso, depth, n, 0, 0,
        tile_w, tile_h, 1, nullptr, nullptr, nullptr, nullptr, counts);
  return (int)cudaGetLastError();
}

extern "C" int gs_expand_rows(const int* ioffs, const int* rows,
                              const int* counts, int row_cap, int capacity,
                              int n_tiles, int* out, cudaStream_t stream) {
  if (capacity > 0) {
    const int blocks = (capacity + kSpan - 1) / kSpan;
    expand_rows_kernel<<<blocks, kThreads, 0, stream>>>(
        ioffs, rows, counts, row_cap, capacity, n_tiles, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_expand1(const int* ro, const int* gi, const float* gf,
                          int n, int row_cap, int tile_w, int tile_h,
                          int* idx, float* attr, cudaStream_t stream) {
  if (row_cap > 0) {
    const int blocks = (row_cap + kThreads - 1) / kThreads;
    expand1_kernel<<<blocks, kThreads, 0, stream>>>(
        ro, gi, gf, n, row_cap, tile_w, tile_h, idx, attr);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_expand2(const int* io, const int* ri, const float* rf,
                          int row_cap, int capacity, int tile_w, int tile_h,
                          int grid_x, int n_tiles, float* rec, int* ids,
                          cudaStream_t stream) {
  if (capacity > 0) {
    const int blocks = (capacity + kThreads - 1) / kThreads;
    expand2_kernel<<<blocks, kThreads, 0, stream>>>(
        io, ri, rf, row_cap, capacity, tile_w, tile_h, grid_x, n_tiles, rec,
        ids);
  }
  return (int)cudaGetLastError();
}
