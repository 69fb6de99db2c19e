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
// What they compute: out[g, k] = sum over gaussian g's emission run e in
// [offsets[g], offsets[g+1]) of the gradient value (e, k), the offsets
// clamped to the instance count as the JAX builds clamp them (:958-959).
// K3 reads (16, cap) columns, K7 (cap, 16) rows, both in emission order,
// in which every gaussian's instances are contiguous.  The TPU summed each
// block with indicator matmuls on the MXU (K7: 8 of them per 1024
// instances, one per 16-lane group of the packed 128-lane rows); a GPU
// thread can walk its run.
//
// Design: one thread per gaussian, 16 float32 accumulators, the run added
// in emission order.  Sequential sums, no atomics: deterministic, and
// bit-equal to the plain versions, which add in the same order.  K3's
// neighbouring threads walk neighbouring runs, so a warp's reads of one
// column row fall in a short contiguous window; K7 reads each instance's
// row as four 16-byte loads.
//
// Bound on the H100: bytes.  Every value inside some run is read once
// (16 * 4 bytes per instance) and the (N, 16) sums written once.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ cols,    // (16,cap)
                      const int* __restrict__ offsets,   // (n+1,)
                      int n, int cap, float* __restrict__ out) {  // (n,16)
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int lo = min(offsets[g], cap);
  const int hi = min(offsets[g + 1], cap);
  float acc[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
  for (int e = lo; e < hi; ++e) {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] += cols[(size_t)k * cap + e];
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)g * kLanes);
#pragma unroll
  for (int q = 0; q < kLanes / 4; ++q) {
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_rows_kernel(const float* __restrict__ rows,   // (cap,16)
                           const int* __restrict__ offsets,  // (n+1,)
                           int n, int cap,
                           float* __restrict__ out) {        // (n,16)
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int lo = min(offsets[g], cap);
  const int hi = min(offsets[g + 1], cap);
  float acc[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
  const float4* r = reinterpret_cast<const float4*>(rows);
  for (int e = lo; e < hi; ++e) {
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      const float4 v = __ldg(r + (size_t)e * (kLanes / 4) + q);
      acc[4 * q] += v.x;
      acc[4 * q + 1] += v.y;
      acc[4 * q + 2] += v.z;
      acc[4 * q + 3] += v.w;
    }
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)g * kLanes);
#pragma unroll
  for (int q = 0; q < kLanes / 4; ++q) {
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
  }
}

}  // namespace

extern "C" int gs_segment_reduce(const float* cols, const int* offsets,
                                 int n, int cap, float* out,
                                 cudaStream_t stream) {
  if (n > 0) {
    segment_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(cols, offsets, n, cap, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int gs_segment_reduce_rows(const float* rows, const int* offsets,
                                      int n, int cap, float* out,
                                      cudaStream_t stream) {
  if (n > 0) {
    segment_reduce_rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                 stream>>>(rows, offsets, n, cap, out);
  }
  return (int)cudaGetLastError();
}
