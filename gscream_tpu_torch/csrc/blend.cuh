// The blend decisions shared by K1 (rasterize_fwd.cu) and K2
// (rasterize_bwd.cu), and the tile layout and work schedule both use.
//
// K2 takes the suffix sum of an instance from K1's outputs as
// Total - prefix, which is right only where K2 blends exactly the pairs K1
// blended: the same power, the same alpha, the same skip (power > 0 or
// alpha < 1/255) and the same stop (T * (1 - alpha) < 1e-4) at every
// (instance, pixel) pair.  So both kernels evaluate them here, with
// explicit round-to-nearest intrinsics that the compiler neither contracts
// nor reorders: the two kernels make bit-identical decisions on the same
// records.
//
// The exponential is one MUFU.EX2 (ex2.approx.ftz) of power * log2(e), as
// __expf: within 2 + 1.173 |power| ulp of e^power (CUDA C++ Programming
// Guide, intrinsic functions), at most 8 ulp where alpha can pass 1/255
// (power >= ln(1/255) ~ -5.5), where the accurate expf spends about ten
// more instructions on range reduction.  The power at a quad's other three
// pixels steps from the first by exact differences (power_quad), two
// additions where the polynomial takes five multiply-adds.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

constexpr int kTileW = 32;
constexpr int kPix = 1024;            // pixels of a 32x32 tile
constexpr int kThreads = 256;         // threads per tile: a 2x2 quad each
constexpr int kWarps = kThreads / 32;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTStop = 1e-4f;
constexpr float kLog2e = 1.4426950408889634f;

// The thread's quad: warp w covers the 16x8 block at (16 (w & 1), 8 (w >> 1))
// and lane l the 2x2 quad at (2 (l & 7), 2 (l >> 3)) inside it.  Pixel j of
// the quad (j = 0..3) is (qx + (j & 1), qy + (j >> 1)); its index in the
// tile's 1024-pixel rows is quad_pixel(tid) + (j & 1) + 32 (j >> 1).
__device__ __forceinline__ int quad_x(int tid) {
  return 16 * ((tid >> 5) & 1) + 2 * (tid & 7);
}
__device__ __forceinline__ int quad_y(int tid) {
  return 8 * (tid >> 6) + 2 * ((tid >> 3) & 3);
}
__device__ __forceinline__ int quad_pixel(int tid) {
  return quad_y(tid) * kTileW + quad_x(tid);
}

// power = k0 + (k1 + k3 x + k4 y) x + (k2 + k5 y) y at the four pixels of
// the quad at tile-local (x, y), in quad order; b = (depth, unc, k0, k1),
// c = (k2, k3, k4, k5) of the instance record.  The first pixel is the
// polynomial; the others step from it by the exact differences
// p(x+1, y) - p(x, y) = k1 + k3 (2x + 1) + k4 y and
// p(x, y+1) - p(x, y) = k2 + k4 x + k5 (2y + 1), and the same for the
// diagonal with k4 added.
__device__ __forceinline__ void power_quad(const float4 b, const float4 c,
                                           float x, float y, float (&p)[4]) {
  const float u = __fmaf_rn(c.z, y, __fmaf_rn(c.y, x, b.w));
  const float v = __fmaf_rn(c.w, y, c.x);
  const float p00 = __fmaf_rn(v, y, __fmaf_rn(u, x, b.z));
  const float dx = __fmaf_rn(c.y, __fmaf_rn(2.0f, x, 1.0f),
                             __fmaf_rn(c.z, y, b.w));
  const float dy = __fmaf_rn(c.w, __fmaf_rn(2.0f, y, 1.0f),
                             __fmaf_rn(c.z, x, c.x));
  p[0] = p00;
  p[1] = __fadd_rn(p00, dx);
  p[2] = __fadd_rn(p00, dy);
  p[3] = __fadd_rn(p[1], __fadd_rn(dy, c.z));
}

__device__ __forceinline__ float exp_fast(float power) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(power,
                                                            kLog2e)));
  return r;
}

// True where the instance is blended at the pixel unless it stops it:
// power <= 0 and alpha = min(op e^power, 0.99) >= 1/255.  Sets G = e^power
// and alpha (also where it returns false: no branch).
__device__ __forceinline__ bool passes(float op, float power, float& G,
                                       float& alpha) {
  G = exp_fast(power);
  alpha = fminf(__fmul_rn(op, G), kAlphaMax);
  return (power <= 0.0f) & (alpha >= kAlphaMin);
}

// T after the instance; true where that is below 1e-4: the pixel is done
// and the instance is not blended.
__device__ __forceinline__ bool stops(float T, float alpha, float& t_next) {
  t_next = __fmul_rn(T, __fsub_rn(1.0f, alpha));
  return t_next < kTStop;
}

// 16-byte copy global -> shared that completes asynchronously (cp.async)
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// False only where no pixel of the rectangle [xa, xb] x [ya, yb]
// (tile-local) can pass alpha >= 1/255: the largest power over it lies
// below ln(1/(255 op)) by more than the rounding of power_quad and of
// this test can account for.  A warp skips an instance that fails it for its
// block; it never changes a decision, so K1 and K2 stay bit-equal to what
// they give without it.  power is a concave quadratic (k3, k5 < 0,
// 4 k3 k5 > k4^2, the conic being positive definite): its largest value is
// at its vertex if that lies inside, else on an edge, where it is a
// concave parabola largest at its clamped vertex.  Anything else
// (non-finite or not concave) may pass.  Built with -DGS_NO_CULL, every
// pair may pass: the build that checks this test changes no output.
__device__ __forceinline__ bool may_pass(float op, const float4 b,
                                         const float4 c, float xa, float xb,
                                         float ya, float yb) {
#ifdef GS_NO_CULL
  return true;
#endif
  const float k0 = b.z, k1 = b.w, k2 = c.x, k3 = c.y, k4 = c.z, k5 = c.w;
  if (op <= 0.0f) return false;                    // alpha = 0 everywhere
  const float det = 4.0f * k3 * k5 - k4 * k4;
  if (!(op <= 1e30f) || !(k3 < 0.0f) || !(k5 < 0.0f) || !(det > 0.0f) ||
      !isfinite(k0 + k1 + k2 + det)) {
    return true;
  }
  // fast divisions: their error only moves where the maximum is sought
  const float cx = __fdividef(k4 * k2 - 2.0f * k5 * k1, det);
  const float cy = __fdividef(k4 * k1 - 2.0f * k3 * k2, det);
  if (cx >= xa && cx <= xb && cy >= ya && cy <= yb) return true;
  const float h5 = __fdividef(-0.5f, k5), h3 = __fdividef(-0.5f, k3);
  auto at = [&](float x, float y) {
    return k0 + (k1 + k3 * x + k4 * y) * x + (k2 + k5 * y) * y;
  };
  const float m = fmaxf(
      fmaxf(at(xa, fminf(fmaxf((k2 + k4 * xa) * h5, ya), yb)),
            at(xb, fminf(fmaxf((k2 + k4 * xb) * h5, ya), yb))),
      fmaxf(at(fminf(fmaxf((k1 + k4 * ya) * h3, xa), xb), ya),
            at(fminf(fmaxf((k1 + k4 * yb) * h3, xa), xb), yb)));
  // |power|'s terms over the tile bound the rounding of both evaluations
  const float scale = fabsf(k0) + 32.0f * (fabsf(k1) + fabsf(k2)) +
                      1024.0f * (fabsf(k3) + fabsf(k4) + fabsf(k5));
  const float lowest = -5.54126354516f - __logf(op);     // ln(1/(255 op))
  return !(m < lowest - 1e-2f - 1e-5f * scale);
}

// The block of warp w, for may_pass: x in [16 (w & 1), +15], y in
// [8 (w >> 1), +7].
__device__ __forceinline__ bool may_pass_block(const float4* r, int w) {
  const float xa = (float)(16 * (w & 1)), ya = (float)(8 * (w >> 1));
  return may_pass(r[0].x, r[1], r[2], xa, xa + 15.0f, ya, ya + 7.0f);
}

// Heavy tiles first: order[k] = work[1 + k] is the tile of rank k by
// descending count (ties by index), and work[0], the counter from which
// the persistent grids take their work (K2's CTAs a tile each, K1's warps
// a (tile, block) item each, 8 per tile, in rank order), is reset.  One
// warp per tile counts the tiles before it, its lanes striding over them.
constexpr int kOrderThreads = 256;
__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(const int* __restrict__ tile_count, int n_tiles,
                  int* __restrict__ work) {
  const int t = blockIdx.x * (kOrderThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) work[0] = 0;
  if (t >= n_tiles) return;
  const int c = tile_count[t];
  unsigned before = 0;
  for (int u = lane; u < n_tiles; u += 32) {
    const int cu = tile_count[u];
    before += (cu > c) || (cu == c && u < t);
  }
  before = __reduce_add_sync(0xffffffffu, before);
  if (lane == 0) work[1 + before] = t;
}

inline void launch_tile_order(const int* tile_count, int n_tiles, int* work,
                              cudaStream_t stream) {
  const int per = kOrderThreads / 32;
  tile_order_kernel<<<max(1, (n_tiles + per - 1) / per), kOrderThreads, 0,
                      stream>>>(tile_count, n_tiles, work);
}

// CTAs of `kernel` (kThreads threads, static shared memory only) that the
// card holds at once: the size of a persistent grid.  Asked once per
// process and kernel.
template <typename Kernel>
inline int resident_ctas(Kernel kernel) {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

// What the card reports for a compiled kernel: out = {registers per
// thread, static shared memory bytes, local memory bytes per thread (spills
// and local arrays), CTAs of kThreads resident per SM}.
template <typename Kernel>
inline int kernel_attributes(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = per_sm;
  return (int)e;
}

// The next tile a persistent CTA takes (K2), or -1 when none is left;
// every thread of the CTA calls it (it synchronises the CTA).
__device__ __forceinline__ int next_tile(int* work, int n_tiles,
                                         int* s_slot) {
  __syncthreads();                 // the previous tile's s_slot is read
  if (threadIdx.x == 0) *s_slot = atomicAdd(work, 1);
  __syncthreads();
  const int k = *s_slot;
  return k < n_tiles ? work[1 + k] : -1;
}

}  // namespace gs
