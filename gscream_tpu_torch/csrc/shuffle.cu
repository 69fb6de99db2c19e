// Instance-row unpack and pack for Hopper (sm_90a): K4 and K8.
//
// K4 gs_unpack_columns replaces the Pallas kernel
//    gscream_tpu/ops/shuffle.py::_unpack_kernel (:75, launched by
//    unpack_columns :129).
// K8 gs_pack_columns replaces the Pallas kernel
//    gscream_tpu/ops/shuffle.py::_pack_kernel (:59, launched by
//    pack_columns :112).
//
// What they compute: the JAX kernels turn packed rows, 8 instances of 16
// lanes per 128-lane row, into dense attribute columns and back,
// cols[j, 8r+phi] = packed[r, 16phi+j].  The port's packed array is the
// (n, 16) record array itself (a (n/8, 128) view of the same memory), so
// K4 is the float32 transpose cols[j, i] = rec[i, j] and K8 its inverse
// rec[i, j] = cols[j, i].  The TPU did both as indicator matmuls on the
// MXU; here they are copies.  K4 feeds only the default gradient flow,
// whose sanitize (reduce_grads_cm, gscream_tpu/ops/rasterize_tiled.py:1073)
// it applies as it stores: a non-finite value becomes 0.
//
// Design: one CTA of 256 threads per 64 records.  The 64x16 tile is kept
// in shared memory with one float of padding per column against bank
// conflicts; the record side is read or written row-major (consecutive
// threads, consecutive addresses: 1024 contiguous floats per CTA) and the
// column side 64 consecutive floats per column row.
//
// Bound on the H100: bytes.  Each record is read once and written once:
// 2 * 64 bytes per instance over 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kTile = 64;           // records per CTA
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack_columns_kernel(const float* __restrict__ rec,   // (n,16)
                      int n, float* __restrict__ cols) {  // (16,n)
  __shared__ float s[kLanes][kTile + 1];
  const int base = blockIdx.x * kTile;
  for (int e = threadIdx.x; e < kTile * kLanes; e += kThreads) {
    const int i = e / kLanes;
    const int j = e % kLanes;
    if (base + i < n) s[j][i] = rec[(size_t)(base + i) * kLanes + j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kLanes; e += kThreads) {
    const int j = e / kTile;
    const int i = e % kTile;
    if (base + i < n) {
      const float v = s[j][i];
      cols[(size_t)j * n + base + i] = isfinite(v) ? v : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pack_columns_kernel(const float* __restrict__ cols,   // (16,n)
                    int n, float* __restrict__ rec) {  // (n,16)
  __shared__ float s[kLanes][kTile + 1];
  const int base = blockIdx.x * kTile;
  for (int e = threadIdx.x; e < kTile * kLanes; e += kThreads) {
    const int j = e / kTile;
    const int i = e % kTile;
    if (base + i < n) s[j][i] = cols[(size_t)j * n + base + i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kLanes; e += kThreads) {
    const int i = e / kLanes;
    const int j = e % kLanes;
    if (base + i < n) rec[(size_t)(base + i) * kLanes + j] = s[j][i];
  }
}

}  // namespace

extern "C" int gs_unpack_columns(const float* rec, int n, float* cols,
                                 cudaStream_t stream) {
  if (n > 0) {
    unpack_columns_kernel<<<(n + kTile - 1) / kTile, kThreads, 0, stream>>>(
        rec, n, cols);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_pack_columns(const float* cols, int n, float* rec,
                               cudaStream_t stream) {
  if (n > 0) {
    pack_columns_kernel<<<(n + kTile - 1) / kTile, kThreads, 0, stream>>>(
        cols, n, rec);
  }
  return (int)cudaGetLastError();
}
