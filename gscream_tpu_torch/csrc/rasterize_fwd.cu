// Tile forward blend for Hopper (sm_90a): K1 of the render path.
//
// Replaces the Pallas kernel
//    gscream_tpu/ops/rasterize_tiled.py::_fwd_kernel (:360, launched by
//    _run_forward :484), both of its bodies: the legacy records
//    (gs_tile_forward) and, under GSCREAM_KERNEL_COEFF=1, the raw ones
//    (gs_tile_forward_raw, the branch at :378-383).
//
// What it computes: for every 32x32 tile, the front-to-back blend of the
// tile's depth-sorted instance range [tile_start, tile_start + tile_count)
// at each of its 1024 pixels (reference forward.cu:441-568):
//    power = k0 + (k1 + k3*x + k4*y)*x + (k2 + k5*y)*y   (tile-local x, y)
//    alpha = min(op * exp(power), 0.99); skip if power > 0 or alpha < 1/255
//    T_next = T * (1 - alpha); if T_next < 1e-4 the pixel is done and this
//    instance is NOT blended; else accumulate w = alpha*T times rgb, depth,
//    uncertainty and set T = T_next.
// Power, alpha and both tests come from blend.cuh, which K2 shares, so the
// backward blends exactly the pairs this kernel blends.  Instance records
// are pack_instance_data's 16 floats [op, r, g, b, depth, unc, k0..k5, sx,
// sy, 0, 0].  Output rows per tile: 1-3 rgb, 4 depth, 5 uncertainty, 6
// final T; rows 0 and 7 are zero.  The transmittance is the sequential
// recurrence of the CUDA original; the Pallas kernel instead takes a
// log-domain prefix scan over rows of 8 (:433-460), which differs from
// this only by rounding and where the T < 1e-4 stop flips for one
// instance.
//
// Bound on the H100: operations.  Each evaluated (instance, pixel) pair
// costs the power polynomial and, where power <= 0, one exponential on the
// special-function pipe; a blended pair ~14 more float32 operations;
// against 64 bytes per instance read once per tile, so the arithmetic over
// the pairs the data needs dominates the record bytes.  The
// one-thread-per-pixel version spent its time on the accurate expf, on
// every (instance, pixel) pair of the tile up to its stop whether the
// gaussian reached the pixel or not, on lanes that idled once their pixel
// stopped, on a 16 KB batch load that nothing overlapped (two CTA
// barriers per batch), and on 1024-thread CTAs whose heaviest tiles ran
// last.  The design:
//  * each thread blends a 2x2 pixel quad, and a warp a 16x8 block of the
//    tile (blend.cuh): four T recurrences per thread, evaluated without a
//    branch (power by one polynomial and three exact steps, e^power as one
//    MUFU.EX2), so that they interleave;
//  * per 32-record chunk each lane tests one record against the warp's
//    block (may_pass, blend.cuh), and the warp walks only the records that
//    can reach alpha >= 1/255 somewhere in it: about 2.2 of the 8 blocks'
//    evaluations per instance are left on the training view;
//  * the warps work alone: a (tile, block) pair is one work item, the warps
//    of a persistent grid take items from a counter, tiles heaviest first,
//    and each stages its tile's records through a double buffer of its own
//    by cp.async, so no warp waits at a CTA barrier for a heavier block,
//    and a warp whose pixels are all done leaves its item.
// Raw records ([op, r, g, b, depth, unc, mx, my, ca, cb, cc, 0 x5]) take
// the same kernel with kRaw set: tile t's origin comes from its global id
// tile_base + t (a band of a sharded grid passes its first global tile),
// and each lane turns the record it staged into the legacy one
// (gs::to_legacy, one rounding per operation in the legacy pack's order)
// before the warp tests or blends it, so raw and legacy records of the same
// binning blend bit-equal.  The derivation costs ~20 operations per record
// and warp, against the ~2.2 blocks x 4 pixels x ~30 operations a record
// costs after it; the TPU's raw mode lost 5% to it on a VPU-bound kernel
// (rasterize_tiled.py:107-112).
#include "blend.cuh"

namespace {

constexpr int kChunk = 32;   // records per staged chunk: one per lane

__device__ __forceinline__ void store_quad(float* row, float a, float b,
                                           float c, float d) {
  *reinterpret_cast<float2*>(row) = make_float2(a, b);
  *reinterpret_cast<float2*>(row + gs::kTileW) = make_float2(c, d);
}

// Lane l copies record c0 + l of the tile (four 16-byte cp.async) into the
// warp's chunk buffer, if it exists.
__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int c0, int count, int lane) {
  if (c0 + lane < count) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gs::copy16(&dst[4 * lane + q], src + (size_t)(c0 + lane) * 4 + q);
    }
  }
  gs::copy_commit();
}

template <bool kRaw>
__global__ void __launch_bounds__(gs::kThreads, 4)
tile_forward_kernel(const float* __restrict__ inst,      // (cap,16)
                    const int* __restrict__ tile_start,  // (n_tiles,)
                    const int* __restrict__ tile_count,  // (n_tiles,)
                    int n_tiles, int grid_x, int tile_base,
                    int* __restrict__ work,              // (1+n_tiles,)
                    float* __restrict__ out) {           // (n_tiles,8,1024)
  // each warp's two chunk buffers
  __shared__ __align__(16) float4 rec[gs::kWarps][2][kChunk * 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (;;) {
    // the next (tile, block) by descending tile count: 8 per tile
    int k = 0;
    if (lane == 0) k = atomicAdd(work, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= n_tiles * gs::kWarps) break;
    const int t = work[1 + (k >> 3)];
    const int blk = k & 7;
    const int qi = blk * 32 + lane;      // the quad's thread index in a tile
    const float x0 = (float)gs::quad_x(qi);
    const float y0 = (float)gs::quad_y(qi);
    const int count = tile_count[t];
    const float4* src = reinterpret_cast<const float4*>(inst) +
                        (size_t)tile_start[t] * 4;
    float ox = 0.0f, oy = 0.0f;
    if (kRaw) gs::tile_origin(tile_base + t, grid_x, ox, oy);
    float T[4], cr[4], cg[4], cb[4], cd[4], cu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T[j] = 1.0f;
      cr[j] = cg[j] = cb[j] = cd[j] = cu[j] = 0.0f;
    }
    unsigned done = 0;                     // bit j: pixel j has stopped

    stage(rec[warp][0], src, 0, count, lane);
    for (int c0 = 0, buf = 0; c0 < count; c0 += kChunk, buf ^= 1) {
      gs::copy_wait_all();
      __syncwarp();                        // chunk c0 is in rec[warp][buf]
      if (__all_sync(0xffffffffu, done == 0xFu)) break;
      stage(rec[warp][buf ^ 1], src, c0 + kChunk, count, lane);
      if (kRaw) {
        if (c0 + lane < count) {
          gs::to_legacy(&rec[warp][buf][4 * lane], ox, oy);
        }
        __syncwarp();                      // the chunk holds legacy records
      }
      const float4* r = rec[warp][buf];
      unsigned live = __ballot_sync(
          0xffffffffu,
          c0 + lane < count && gs::may_pass_block(&r[4 * lane], blk));
      while (live) {
        const int i = __ffs(live) - 1;
        live &= live - 1;
        const float4 a = r[4 * i];         // op, r, g, b
        const float4 b = r[4 * i + 1];     // depth, unc, k0, k1
        const float4 c = r[4 * i + 2];     // k2, k3, k4, k5
        float power[4];
        gs::power_quad(b, c, x0, y0, power);
        // no branch: the four pixels' recurrences interleave
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float G, alpha, t_next;
          const bool pass = gs::passes(a.x, power[j], G, alpha) &
                            !(done & (1u << j));
          const bool stop = gs::stops(T[j], alpha, t_next);
          done |= (unsigned)(pass && stop) << j;
          const bool blend = pass && !stop;
          const float w = blend ? alpha * T[j] : 0.0f;
          cr[j] += w * a.y;
          cg[j] += w * a.z;
          cb[j] += w * a.w;
          cd[j] += w * b.x;
          cu[j] += w * b.y;
          T[j] = blend ? t_next : T[j];
        }
      }
      __syncwarp();                        // rec[warp][buf] is read
    }
    gs::copy_wait_all();                   // no copy is left in flight
    __syncwarp();
    float* o = out + (size_t)t * 8 * gs::kPix + gs::quad_pixel(qi);
    store_quad(o, 0.0f, 0.0f, 0.0f, 0.0f);
    store_quad(o + 1 * gs::kPix, cr[0], cr[1], cr[2], cr[3]);
    store_quad(o + 2 * gs::kPix, cg[0], cg[1], cg[2], cg[3]);
    store_quad(o + 3 * gs::kPix, cb[0], cb[1], cb[2], cb[3]);
    store_quad(o + 4 * gs::kPix, cd[0], cd[1], cd[2], cd[3]);
    store_quad(o + 5 * gs::kPix, cu[0], cu[1], cu[2], cu[3]);
    store_quad(o + 6 * gs::kPix, T[0], T[1], T[2], T[3]);
    store_quad(o + 7 * gs::kPix, 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <bool kRaw>
int launch(const float* inst, const int* tile_start, const int* tile_count,
           int n_tiles, int grid_x, int tile_base, int* work, float* out,
           cudaStream_t stream) {
  static int resident = 0;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  const int grid = min(n_tiles, gs::resident_ctas(tile_forward_kernel<kRaw>,
                                                  resident));
  gs::launch_tile_order(tile_count, n_tiles, work, stream);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_forward_kernel<kRaw><<<grid, gs::kThreads, 0, stream>>>(
      inst, tile_start, tile_count, n_tiles, grid_x, tile_base, work, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gs_tile_forward(const float* inst, const int* tile_start,
                               const int* tile_count, int n_tiles, int* work,
                               float* out, cudaStream_t stream) {
  return launch<false>(inst, tile_start, tile_count, n_tiles, 1, 0, work,
                       out, stream);
}

// Raw records; tile t of the launch is global tile tile_base + t of a grid
// grid_x tiles wide.
extern "C" int gs_tile_forward_raw(const float* inst, const int* tile_start,
                                   const int* tile_count, int n_tiles,
                                   int grid_x, int tile_base, int* work,
                                   float* out, cudaStream_t stream) {
  if (grid_x <= 0) return (int)cudaErrorInvalidValue;
  return launch<true>(inst, tile_start, tile_count, n_tiles, grid_x,
                      tile_base, work, out, stream);
}

extern "C" int gs_tile_forward_attributes(int* out) {
  return gs::kernel_attributes(tile_forward_kernel<false>, out);
}

extern "C" int gs_tile_forward_raw_attributes(int* out) {
  return gs::kernel_attributes(tile_forward_kernel<true>, out);
}
