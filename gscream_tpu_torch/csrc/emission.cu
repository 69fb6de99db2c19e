// Row-tight instance expansion for Hopper (sm_90a): K5 and K6 of the
// render path's tile binning, and K9's EXPAND1 and EXPAND2 of the
// Pallas-emission build (GSCREAM_EMIT=pallas).
//
// K5 gs_expand_gauss_rows replaces the Pallas kernel
//    gscream_tpu/ops/emission.py::_expand_gauss_kernel (:346, launched by
//    expand_gauss_rows :421).
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
//  K5: every emitting gaussian g owns the tile rows
//      [row_offs[g], row_offs[g+1]) of a row table of row_cap slots (the
//      exclusive prefix sum of its rect height, computed by the caller).
//      Slot r holds (tile_base, gid, depth_bits, w_row): the first tile
//      and width of that tile row's covering of the alpha >= 1/255
//      iso-ellipse (_row_extents, expression for expression).  Slots at
//      or past total_rows = row_offs[n] hold zeros.
//  K6: every row r with w_row[r] > 0 owns the instance slots
//      [ioffs[r], ioffs[r] + w_row[r]) (exclusive prefix sum of w_row);
//      slot s holds (tile_base[r] + s - ioffs[r], gid[r], depth_bits[r]).
//      Slots at or past min(total, capacity) hold (n_tiles, 0, 2^30): the
//      invalid tile sorts them last.
//
//  K9a: K5 over the COMPACTED emitting gaussians (stage A of
//      bin_instances_pallas), carrying the attribute payload: row slot r
//      holds the int32 (gid, ty, txmin, w_row) and the float32 (mx, my,
//      ca, cb, cc, depth, op, r, g, b, unc) of its gaussian, zeros where
//      r >= total_rows.  The same row_extents device function as K5.
//  K9b: K6 over the compacted non-empty rows (stage C), writing whole
//      instance records: slot s holds the float32 [op, r, g, b, depth,
//      unc, k0..k5, sx, sy] of pack_instance_data (k0..k2 the tile-local
//      power coefficients, sx/sy the shift into the rounded-centre frame,
//      round half to even as jnp.round) and the int32 (tile, gid); slots
//      at or past min(total, capacity) hold zeros and tile n_tiles.
//
// Design: one thread per OUTPUT slot, which finds its source by a binary
// search over the caller's prefix sum (CUDA's duplicateWithKeys writes
// from the source side instead; searching from the output side writes
// every slot exactly once, so no fill pass is needed and the writes are
// coalesced).  On the TPU the sources had to be compacted and windowed
// into VMEM first and expanded by indicator matmuls; here the prefix
// arrays (a few MB) stay in the 50 MB L2 and every index is an int32, not
// a float32 that is exact only below 2^24.  No window exists, so nothing
// can be read out of bounds.  Every table is attribute-major ((C, slots)),
// so a warp's writes of one attribute are contiguous.
//
// Bound on the H100: bytes.  K5 reads the row prefix and 40 bytes per
// emitting gaussian and writes 16 per row slot; K6 reads 16 bytes per
// non-empty row (the binary search touches ~log2(rows) cached entries
// more) and writes 12 per instance slot; K9a reads 68 bytes per emitting
// gaussian and writes 60 per row slot; K9b reads 60 bytes per non-empty
// row and writes 64 per instance slot.  The arithmetic is a few dozen
// flops per slot.  Nothing here is tuned.
//
// Numerics: built with -fmad=false and IEEE division and sqrt, so every
// float operation rounds exactly as PyTorch's elementwise ops do; the
// plain version (gscream_tpu_torch/ops/emission.py) is then bit-equal on
// the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// first index i in [0, n) with a[i] > v, or n
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// binning.py::_row_extents, one operation at a time: tile row r of a
// gaussian whose rows start at r_off -> (ty, txmin, w) of that row's
// covering of the alpha >= 1/255 iso-ellipse
__device__ __forceinline__ void row_extents(
    int r, int r_off, int r_ymin, int r_xmin, int r_xmax, float mx,
    float my, float ca, float cb, float cc, float t2, int tile_w,
    int tile_h, int* ty_out, int* txmin_out, int* w_out) {
  const int ty = r_ymin + (r - r_off);
  const float lo = (float)ty * (float)tile_h - my - 0.25f;
  const float hi = lo + (float)(tile_h - 1) + 0.5f;
  const float q = ca * cc - cb * cb;
  const float qs = fmaxf(q, 1e-20f);
  const float cs = fmaxf(cc, 1e-20f);
  const float a_s = fmaxf(ca, 1e-20f);
  const float hx = sqrtf(fmaxf(t2 * cs / qs, 0.0f));
  const float hy = sqrtf(fmaxf(t2 * a_s / qs, 0.0f));
  const float lc = fmaxf(lo, -hy);
  const float uc = fminf(hi, hy);
  const float sd_l = sqrtf(fmaxf(t2 * ca - q * lc * lc, 0.0f));
  const float sd_u = sqrtf(fmaxf(t2 * ca - q * uc * uc, 0.0f));
  const float ncb = -cb;
  const float dxp_l = (ncb * lc + sd_l) / a_s;
  const float dxp_u = (ncb * uc + sd_u) / a_s;
  const float dxm_l = (ncb * lc - sd_l) / a_s;
  const float dxm_u = (ncb * uc - sd_u) / a_s;
  const float dyv = ncb * sqrtf(fmaxf(t2 / (cs * qs), 0.0f));
  float xhi = fmaxf(dxp_l, dxp_u);
  if (dyv >= lc - 1.0f && dyv <= uc + 1.0f) xhi = fmaxf(xhi, hx);
  float xlo = fminf(dxm_l, dxm_u);
  const float ndyv = -dyv;
  if (ndyv >= lc - 1.0f && ndyv <= uc + 1.0f) xlo = fminf(xlo, -hx);

  int txmin = (int)fmaxf(floorf((mx + xlo - 0.25f) / (float)tile_w),
                         (float)r_xmin);
  int txmax = (int)fminf(floorf((mx + xhi + 0.25f) / (float)tile_w) + 1.0f,
                         (float)r_xmax);
  const bool tight = t2 > 0.0f;
  if (!tight) {
    txmin = r_xmin;
    txmax = r_xmax;
  }
  int w = max(txmax - txmin, 0);
  if (!((lc <= uc) || !tight)) w = 0;
  *ty_out = ty;
  *txmin_out = txmin;
  *w_out = w;
}

__global__ void expand_gauss_rows_kernel(
    const int* __restrict__ row_offs,   // (n+1,) exclusive prefix + total
    const int* __restrict__ rect_min,   // (n,2) tile rect start (x,y)
    const int* __restrict__ rect_max,   // (n,2) tile rect end (x,y)
    const float* __restrict__ mean2d,   // (n,2)
    const float* __restrict__ conic,    // (n,3)
    const float* __restrict__ t_iso,    // (n,)
    const float* __restrict__ depth,    // (n,)
    int n, int row_cap, int tile_w, int tile_h, int grid_x,
    int* __restrict__ out) {            // (4,row_cap)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row_cap) return;
  const int total_rows = __ldg(row_offs + n);
  int tb = 0, gid = 0, dep = 0, w = 0;
  if (r < total_rows) {
    const int g = upper_bound(row_offs, n + 1, r) - 1;
    int ty, txmin;
    row_extents(r, __ldg(row_offs + g), __ldg(rect_min + 2 * g + 1),
                __ldg(rect_min + 2 * g), __ldg(rect_max + 2 * g),
                __ldg(mean2d + 2 * g), __ldg(mean2d + 2 * g + 1),
                __ldg(conic + 3 * g), __ldg(conic + 3 * g + 1),
                __ldg(conic + 3 * g + 2), 2.0f * __ldg(t_iso + g), tile_w,
                tile_h, &ty, &txmin, &w);
    tb = ty * grid_x + txmin;
    gid = g;
    dep = __float_as_int(__ldg(depth + g));
  }
  out[r] = tb;
  out[row_cap + r] = gid;
  out[2 * row_cap + r] = dep;
  out[3 * row_cap + r] = w;
}

__global__ void expand_rows_kernel(
    const int* __restrict__ ioffs,      // (row_cap,) exclusive prefix of w
    const int* __restrict__ rows,       // (4,row_cap) K5's table
    int row_cap, int capacity, int n_tiles,
    int* __restrict__ out) {            // (3,capacity)
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= capacity) return;
  const int* w_row = rows + 3 * row_cap;
  const int total = row_cap > 0
      ? __ldg(ioffs + row_cap - 1) + __ldg(w_row + row_cap - 1) : 0;
  int tile = n_tiles, gid = 0, dep = 1 << 30;
  if (s < min(total, capacity)) {
    const int r = upper_bound(ioffs, row_cap, s) - 1;
    tile = __ldg(rows + r) + (s - __ldg(ioffs + r));
    gid = __ldg(rows + row_cap + r);
    dep = __ldg(rows + 2 * row_cap + r);
  }
  out[s] = tile;
  out[capacity + s] = gid;
  out[2 * capacity + s] = dep;
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
    const int* row_offs, const int* rect_min, const int* rect_max,
    const float* mean2d, const float* conic, const float* t_iso,
    const float* depth, int n, int row_cap, int tile_w, int tile_h,
    int grid_x, int* out, cudaStream_t stream) {
  if (row_cap > 0) {
    const int blocks = (row_cap + kThreads - 1) / kThreads;
    expand_gauss_rows_kernel<<<blocks, kThreads, 0, stream>>>(
        row_offs, rect_min, rect_max, mean2d, conic, t_iso, depth, n,
        row_cap, tile_w, tile_h, grid_x, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_expand_rows(const int* ioffs, const int* rows, int row_cap,
                              int capacity, int n_tiles, int* out,
                              cudaStream_t stream) {
  if (capacity > 0) {
    const int blocks = (capacity + kThreads - 1) / kThreads;
    expand_rows_kernel<<<blocks, kThreads, 0, stream>>>(
        ioffs, rows, row_cap, capacity, n_tiles, out);
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
