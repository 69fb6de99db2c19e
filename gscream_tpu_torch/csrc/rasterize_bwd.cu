// Tile backward for Hopper (sm_90a): K2 of the training path.
//
// Replaces the Pallas kernel
//    gscream_tpu/ops/rasterize_tiled.py::_bwd_kernel (:513, launched by
//    _run_backward :807).
//
// What it computes: for every 32x32 tile, one 16-float gradient row per
// instance of the tile's depth-sorted range, from the K1 records
// [op, r, g, b, depth, unc, k0..k5, sx, sy, 0, 0] and the per-pixel rows
// [g_r, g_g, g_b, g_depth, g_unc, Total, gTT, 0] that _raster_bwd builds
// (Total = sum_c raw_c*g_c + D*g_D + U*g_U, gTT = (bg.g_color + g_T)*T_final):
//    lanes 1-5   sum over the tile's pixels of w*g_c   (w = alpha*T_before)
//    lanes 6-11  the moments of X = dL/dalpha * G against
//                [1, x', y', x'^2, x'y', y'^2], with x' = x + sx, y' = y + sy
//                the pixel in the gaussian's rounded-centre frame
//    lanes 0, 12-15  zero.
// The blend is walked front to back with K1's recurrence T <- T*(1-alpha);
// an instance gets a gradient only where K1 blended it (reference
// backward.cu:409-604), the gradient passing straight through the 0.99
// clamp.  The suffix sum sum_{j>i} gamma_j w_j that the CUDA original
// accumulates back to front comes from Total - prefix (module docstring
// of the Pallas file, :45-52), so nothing beyond K1's outputs is saved;
// that is right only where K2 makes K1's decisions, so both take power,
// alpha and the two tests from blend.cuh.  The shift into the
// rounded-centre frame is applied per pixel (x + sx is an integer, exact
// in float32).
//
// Every slot of the (capacity, 16) output is written: a tile's instances
// after its early stop get zero rows, and the slots before the first
// tile's range and past the last tile's (tile ranges are ascending and
// contiguous, as bin_instances lays them out) are zeroed by the CTAs once
// the tiles are done.  A band of a sharded grid (parallel/shard.py)
// passes its own tiles, whose ranges start past slot 0: the head fill
// leaves its rows zero outside the band, so the per-gaussian reductions
// (K4+K3, K7) sum the band's partials unmasked.
//
// Bound on the H100: operations.  Per evaluated (instance, pixel) pair the
// polynomial and exponential as in K1, per applied pair ~40 more float32
// operations, and the fold of each applied pair into its instance's 11
// sums; the 64 record bytes per instance are read once per tile.  What the
// one-thread-per-pixel version lost its time to (CUDA events at the
// training view's shapes, PERF.md): per instance, an 11-sum five-step
// shuffle butterfly in each of the ~20 one-row warps it touched (56% of
// the time), and 1024-thread staging with two barriers and a serial
// 32-warp sum per 32-record batch (31%).  The design:
//  * 256 threads per tile, each a 2x2 pixel quad (blend.cuh); a warp covers
//    a 16x8 block, so an instance touches ~4.6 of the tile's 8 warps where
//    it touched ~20 of 32.  A thread folds its four pixels into the sums in
//    a fixed order, without a branch (a pair that does not apply adds
//    zeros), so that the four pixels' work interleaves, and takes the six
//    moments from the quad's sums of X at once.
//  * Per batch each (instance, block) is tested once (may_pass, blend.cuh)
//    and a warp skips the instances that cannot reach alpha >= 1/255 in
//    its block.
//  * A transposed warp reduction over two instances at once: their 2 x 16
//    output lanes are halved recursively (offsets 16, 8, 4, 2, 1; 11 + 8 +
//    4 + 2 + 1 = 26 shuffles for both, where the butterfly took 110 for
//    one), and lane l ends with the warp's total for instance l >> 4,
//    output lane l & 15: the layout of a row.  A pair no pixel of the warp
//    applied is skipped (its partial row is zero).
//  * The 8 warps' partial rows are added in warp order from shared memory,
//    one batch behind, after the barrier that also finds the batch landed;
//    the records of the next batch arrive by cp.async during the current
//    one.
//  * A persistent grid takes tiles heaviest first from a counter (the one
//    atomic, which only schedules: a tile's rows do not depend on the CTA
//    that computes them), so no heavy tile is left for a last wave.  A warp
//    whose pixels are all done stops evaluating; the CTA stops a tile when
//    all are.
// There are no atomics on any sum and the order of every sum is fixed, so
// a rerun is bit-equal.
#include "blend.cuh"

namespace {

constexpr int kBatch = 32;            // instance records per staged batch
constexpr int kSums = 11;             // lanes 1..11 of an output row
constexpr int kRow = 16;              // floats per output row

// A quad's four values of one pixel row: (p0, p0 + 1, p0 + 32, p0 + 33).
__device__ __forceinline__ void load_quad(const float* row, float (&q)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(row);
  const float2 hi = *reinterpret_cast<const float2*>(row + gs::kTileW);
  q[0] = lo.x;
  q[1] = lo.y;
  q[2] = hi.x;
  q[3] = hi.y;
}

// Folds one instance into the thread's sums over its four pixels, in pixel
// order, advancing their T and prefix; `ap` is set where it applied.  No
// branch: the four pixels' work interleaves, and a pair that does not
// apply adds zeros.  base = Total + gTT, so the suffix is base - prefix.
// The six moments take the quad's four X at once (the pixels sit at
// offsets 0 and 1 from the first in x and y).
__device__ __forceinline__ void fold_instance(
    const float4* r, float x0, float y0, const float (&gr)[4],
    const float (&gg)[4], const float (&gb)[4], const float (&gd)[4],
    const float (&gu)[4], const float (&base)[4], float (&T)[4],
    float (&prefix)[4], unsigned& done, float (&v)[kSums], bool& ap) {
  const float4 a = r[0];      // op, r, g, b
  const float4 b = r[1];      // depth, unc, k0, k1
  const float4 c = r[2];      // k2, k3, k4, k5
  const float4 d = r[3];      // sx, sy, 0, 0
  float power[4], X[4];
  gs::power_quad(b, c, x0, y0, power);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float G, alpha, t_next;
    const bool pass = gs::passes(a.x, power[j], G, alpha) &
                      !(done & (1u << j));
    const bool stop = gs::stops(T[j], alpha, t_next);
    done |= (unsigned)(pass && stop) << j;
    const bool app = pass && !stop;
    ap |= app;
    const float w = app ? alpha * T[j] : 0.0f;
    const float gamma = a.y * gr[j] + a.z * gg[j] + a.w * gb[j] +
                        b.x * gd[j] + b.y * gu[j];
    prefix[j] += gamma * w;
    const float dalpha =
        gamma * T[j] - __fdividef(base[j] - prefix[j], 1.0f - alpha);
    X[j] = app ? dalpha * G : 0.0f;
    v[0] += w * gr[j];
    v[1] += w * gg[j];
    v[2] += w * gb[j];
    v[3] += w * gd[j];
    v[4] += w * gu[j];
    T[j] = app ? t_next : T[j];
  }
  // the moments over the quad from its sums: with (xs, ys) = the first
  // pixel in the rounded-centre frame and S, Sx, Sy, Sxy the sums of X over
  // the quad, over its right column, its lower row and its last pixel
  const float xs = x0 + d.x, ys = y0 + d.y;
  const float s = (X[0] + X[1]) + (X[2] + X[3]);
  const float sx = X[1] + X[3], sy = X[2] + X[3];
  const float my = fmaf(ys, s, sy);
  v[5] += s;
  v[6] += fmaf(xs, s, sx);
  v[7] += my;
  v[8] += fmaf(xs, fmaf(xs, s, 2.0f * sx), sx);
  v[9] += fmaf(xs, my, fmaf(ys, sx, X[3]));
  v[10] += fmaf(ys, fmaf(ys, s, 2.0f * sy), sy);
}

// One step of the transposed reduction: of the 2n values, lanes with
// `upper` keep the upper n and send the lower n, the others the reverse;
// each kept value adds the partner's.
template <int N>
__device__ __forceinline__ void halve(float* v, bool upper, int offset) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float send = upper ? v[k] : v[k + N];
    const float keep = upper ? v[k + N] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
  }
}

// The warp's totals of two instances' sums: lane l returns the total for
// instance l >> 4 (0: A, 1: B) at output lane l & 15.
__device__ __forceinline__ float reduce_pair(const float (&va)[kSums],
                                             const float (&vb)[kSums],
                                             int lane) {
  float v[16];
  const bool hi16 = lane & 16;
  v[0] = 0.0f;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {      // offset 16: output lanes 1..11
    const float send = hi16 ? va[k] : vb[k];
    const float keep = hi16 ? vb[k] : va[k];
    v[k + 1] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = kSums + 1; k < 16; ++k) v[k] = 0.0f;
  halve<8>(v, lane & 8, 8);
  halve<4>(v, lane & 4, 4);
  halve<2>(v, lane & 2, 2);
  halve<1>(v, lane & 1, 1);
  return v[0];
}

__global__ void __launch_bounds__(gs::kThreads, 2)
tile_backward_kernel(const float* __restrict__ inst,       // (cap,16)
                     const float* __restrict__ pix,        // (n_tiles,8,1024)
                     const int* __restrict__ tile_start,   // (n_tiles,)
                     const int* __restrict__ tile_count,   // (n_tiles,)
                     int n_tiles, int capacity,
                     int* __restrict__ work,               // (1+n_tiles,)
                     float* __restrict__ out) {            // (cap,16)
  __shared__ __align__(16) float4 rec[2][kBatch * 4];
  // part[warp][i * 16 + k]: the warp's total of batch instance i, output
  // lane k
  __shared__ __align__(16) float part[gs::kWarps][kBatch * kRow];
  __shared__ bool live[kBatch * gs::kWarps];   // may_pass per (i, block)
  __shared__ int s_slot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = gs::quad_pixel(tid);
  const float x0 = (float)gs::quad_x(tid);
  const float y0 = (float)gs::quad_y(tid);

  for (;;) {
    const int t = gs::next_tile(work, n_tiles, &s_slot);
    if (t < 0) break;
    const int start = tile_start[t];
    const int count = tile_count[t];
    const float4* src = reinterpret_cast<const float4*>(inst) +
                        (size_t)start * 4;
    float* dst = out + (size_t)start * kRow;

    float gr[4], gg[4], gb[4], gd[4], gu[4], base[4], gtt[4];
    float T[4], prefix[4];
    const float* px = pix + (size_t)t * 8 * gs::kPix + p0;
    load_quad(px, gr);
    load_quad(px + gs::kPix, gg);
    load_quad(px + 2 * gs::kPix, gb);
    load_quad(px + 3 * gs::kPix, gd);
    load_quad(px + 4 * gs::kPix, gu);
    load_quad(px + 5 * gs::kPix, base);
    load_quad(px + 6 * gs::kPix, gtt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      base[j] += gtt[j];                   // Total + gTT
      T[j] = 1.0f;
      prefix[j] = 0.0f;
    }
    unsigned done = 0;                     // bit j: pixel j has stopped

    if (tid < min(kBatch, count) * 4) gs::copy16(&rec[0][tid], src + tid);
    gs::copy_commit();
    int b0 = 0;
    for (int buf = 0;; b0 += kBatch, buf ^= 1) {
      gs::copy_wait_all();
      // batch b0 has landed in rec[buf]; every warp has written its
      // partials of batch b0 - kBatch and read rec[buf ^ 1] and live
      const int n_done = __syncthreads_count(done == 0xFu);
      if (b0 > 0) {                        // rows of the previous batch
        const int prev = b0 - kBatch;
        const int np = min(kBatch, count - prev);
#pragma unroll
        for (int m = 0; m < kBatch * kRow / gs::kThreads; ++m) {
          const int o = tid + m * gs::kThreads;
          if ((o >> 4) < np) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < gs::kWarps; ++w) s += part[w][o];
            dst[(size_t)prev * kRow + o] = s;
          }
        }
      }
      if (b0 >= count || n_done == gs::kThreads) break;
      const int nb = min(kBatch, count - b0);
      if (tid < min(kBatch, count - b0 - kBatch) * 4) {
        gs::copy16(&rec[buf ^ 1][tid], src + (size_t)(b0 + kBatch) * 4 + tid);
      }
      gs::copy_commit();
      for (int m = tid; m < nb * gs::kWarps; m += gs::kThreads) {
        live[m] = gs::may_pass_block(&rec[buf][4 * (m >> 3)], m & 7);
      }
      __syncthreads();                     // live is set, part is read
      float* mine = part[warp];
      const bool warp_done = __all_sync(0xffffffffu, done == 0xFu);
      for (int q = 0; 2 * q < nb; ++q) {
        const bool la = !warp_done && live[2 * q * gs::kWarps + warp];
        const bool lb = !warp_done && 2 * q + 1 < nb &&
                        live[(2 * q + 1) * gs::kWarps + warp];
        float va[kSums], vb[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
          va[k] = 0.0f;
          vb[k] = 0.0f;
        }
        bool ap = false;
        if (la) {
          fold_instance(&rec[buf][8 * q], x0, y0, gr, gg, gb, gd, gu, base,
                        T, prefix, done, va, ap);
        }
        if (lb) {
          fold_instance(&rec[buf][8 * q + 4], x0, y0, gr, gg, gb, gd, gu,
                        base, T, prefix, done, vb, ap);
        }
        mine[q * 32 + lane] = __any_sync(0xffffffffu, ap)
            ? reduce_pair(va, vb, lane) : 0.0f;
      }
    }
    // instances after the early stop: zero rows
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = b0 * 4 + tid; j < count * 4; j += gs::kThreads) {
      d4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // the slots before the first tile's range and past the last tile's
  const int head = n_tiles > 0 ? min(tile_start[0], capacity) : 0;
  const int end = n_tiles > 0
      ? min(tile_start[n_tiles - 1] + tile_count[n_tiles - 1], capacity) : 0;
  float4* o4 = reinterpret_cast<float4*>(out);
  const size_t first = (size_t)blockIdx.x * gs::kThreads + tid;
  const size_t stride = (size_t)gridDim.x * gs::kThreads;
  for (size_t j = first; j < (size_t)head * 4; j += stride) {
    o4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (size_t j = (size_t)max(end, head) * 4 + first;
       j < (size_t)capacity * 4; j += stride) {
    o4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

extern "C" int gs_tile_backward(const float* inst, const float* pix,
                                const int* tile_start, const int* tile_count,
                                int n_tiles, int capacity, int* work,
                                float* out, cudaStream_t stream) {
  if (capacity <= 0) return (int)cudaGetLastError();
  const int grid = max(1, min(n_tiles, gs::resident_ctas(
                                          tile_backward_kernel)));
  gs::launch_tile_order(tile_count, n_tiles, work, stream);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_backward_kernel<<<grid, gs::kThreads, 0, stream>>>(
      inst, pix, tile_start, tile_count, n_tiles, capacity, work, out);
  return (int)cudaGetLastError();
}

extern "C" int gs_tile_backward_attributes(int* out) {
  return gs::kernel_attributes(tile_backward_kernel, out);
}
