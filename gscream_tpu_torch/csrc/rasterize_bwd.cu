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
// an instance gets a gradient only where alpha > 0 and T_after >= 1e-4
// (reference backward.cu:409-604), the gradient passing straight through
// the 0.99 clamp.  The suffix sum sum_{j>i} gamma_j w_j that the CUDA
// original accumulates back to front comes from Total - prefix (module
// docstring of the Pallas file, :45-52), so nothing beyond K1's outputs is
// saved.  The shift into the rounded-centre frame is applied per pixel
// (x + sx is an integer, exact in float32) instead of to the tile-local
// moments afterwards (:711-719): the same sums, without the cancellation
// of the shifted moments.
//
// Every slot of the (capacity, 16) output is written: a tile's instances
// after its early exit get zero rows, and the slots past the last tile's
// range (tile ranges are ascending and contiguous from slot 0, as
// bin_instances lays them out) are zeroed by kTailBlocks extra CTAs.
//
// Design: one CTA per tile, one thread per pixel; records staged kBatch at
// a time in shared memory as K1 does.  Each instance's 11 sums over the
// tile's 1024 pixels are a fixed-order block reduction: a warp-shuffle
// butterfly (skipped when no pixel of the warp touched the instance), the
// 32 warp partials in shared memory, then one thread per (instance, lane)
// adding them in warp order.  There are no atomics, so a rerun is bit-equal.
//
// Bound on the H100: operations.  Per evaluated (instance, pixel) pair the
// polynomial and exponential as in K1, and per applied pair ~30 more
// float32 operations plus 11 five-step shuffle reductions per warp that
// touches the instance; the 64 record bytes per instance are read once per
// tile.  This first version is plain SIMT float32, untuned.
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kPix = 1024;          // pixels per tile = threads per CTA
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 32;          // instance records per shared batch
constexpr int kSums = 11;           // lanes 1..11 of an output row
constexpr int kTailBlocks = 64;     // CTAs zeroing the slots past the tiles

__global__ void __launch_bounds__(kPix)
tile_backward_kernel(const float* __restrict__ inst,       // (cap,16)
                     const float* __restrict__ pix,        // (n_tiles,8,1024)
                     const int* __restrict__ tile_start,   // (n_tiles,)
                     const int* __restrict__ tile_count,   // (n_tiles,)
                     int n_tiles, int capacity,
                     float* __restrict__ out) {            // (cap,16)
  __shared__ float4 rec[kBatch * 4];
  __shared__ float part[kWarps][kBatch][kSums];
  const int p = threadIdx.x;

  if ((int)blockIdx.x >= n_tiles) {
    // zero [end of the last tile's range, capacity)
    const int end = n_tiles > 0
        ? tile_start[n_tiles - 1] + tile_count[n_tiles - 1] : 0;
    const size_t lo = (size_t)end * 16, hi = (size_t)capacity * 16;
    const size_t stride = (size_t)kTailBlocks * kPix;
    for (size_t j = lo + (size_t)(blockIdx.x - n_tiles) * kPix + p; j < hi;
         j += stride) {
      out[j] = 0.0f;
    }
    return;
  }

  const int t = blockIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float x = (float)(p % kTileW);
  const float y = (float)(p / kTileW);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float alpha_min = (float)(1.0 / 255.0);
  const float t_stop = (float)1e-4;

  const float* px = pix + (size_t)t * 8 * kPix + p;
  const float g_r = px[0], g_g = px[kPix], g_b = px[2 * kPix];
  const float g_d = px[3 * kPix], g_u = px[4 * kPix];
  const float total = px[5 * kPix], gtt = px[6 * kPix];

  float T = 1.0f, prefix = 0.0f;
  int done = 0;
  const float4* src = reinterpret_cast<const float4*>(inst) +
                      (size_t)start * 4;
  float* dst = out + (size_t)start * 16;
  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    const int nb = min(kBatch, count - b0);
    __syncthreads();              // the previous batch's rec/part consumed
    if (p < nb * 4) rec[p] = src[(size_t)b0 * 4 + p];
    if (__syncthreads_count(done) == kPix) break;
    for (int i = 0; i < nb; ++i) {
      float v[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
      bool applied = false;
      if (!done) {
        const float4 a = rec[4 * i];       // op, r, g, b
        const float4 b = rec[4 * i + 1];   // depth, unc, k0, k1
        const float4 c = rec[4 * i + 2];   // k2, k3, k4, k5
        const float4 d = rec[4 * i + 3];   // sx, sy, 0, 0
        const float power = b.z + (b.w + c.y * x + c.z * y) * x +
                            (c.x + c.w * y) * y;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha = fminf(a.x * G, 0.99f);
          if (alpha >= alpha_min) {
            const float t_next = T * (1.0f - alpha);
            if (t_next < t_stop) {
              done = 1;
            } else {
              applied = true;
              const float w = alpha * T;
              const float gamma = a.y * g_r + a.z * g_g + a.w * g_b +
                                  b.x * g_d + b.y * g_u;
              prefix += gamma * w;
              const float suffix = total - prefix + gtt;
              const float dalpha = gamma * T - suffix / (1.0f - alpha);
              const float X = dalpha * G;
              const float xs = x + d.x;
              const float ys = y + d.y;
              v[0] = w * g_r;
              v[1] = w * g_g;
              v[2] = w * g_b;
              v[3] = w * g_d;
              v[4] = w * g_u;
              v[5] = X;
              v[6] = X * xs;
              v[7] = X * ys;
              v[8] = X * xs * xs;
              v[9] = X * xs * ys;
              v[10] = X * ys * ys;
              T = t_next;
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, applied)) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) part[warp][i][k] = v[k];
      }
    }
    __syncthreads();
    if (p < nb * 16) {
      const int i = p >> 4;
      const int k = p & 15;
      float s = 0.0f;
      if (k >= 1 && k <= kSums) {
        for (int w = 0; w < kWarps; ++w) s += part[w][i][k - 1];
      }
      dst[(size_t)(b0 + i) * 16 + k] = s;
    }
  }
  // instances after the early exit: zero rows
  for (int j = b0 * 16 + p; j < count * 16; j += kPix) dst[j] = 0.0f;
}

}  // namespace

extern "C" int gs_tile_backward(const float* inst, const float* pix,
                                const int* tile_start, const int* tile_count,
                                int n_tiles, int capacity, float* out,
                                cudaStream_t stream) {
  if (capacity > 0) {
    tile_backward_kernel<<<n_tiles + kTailBlocks, kPix, 0, stream>>>(
        inst, pix, tile_start, tile_count, n_tiles, capacity, out);
  }
  return (int)cudaGetLastError();
}
