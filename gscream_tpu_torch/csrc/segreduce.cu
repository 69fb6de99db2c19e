// Per-gaussian segment reduction for Hopper (sm_90a): K3 of the training
// path.
//
// Replaces the Pallas kernel
//    gscream_tpu/ops/rasterize_tiled.py::_segreduce_cm_kernel (:899,
//    launched by segment_reduce_cm :939).
//
// What it computes: out[g, k] = sum of cols[k, e] over gaussian g's
// emission run e in [offsets[g], offsets[g+1]), the offsets clamped to the
// column count as the JAX build clamps them (:958-959).  The columns are
// the (16, cap) gradient rows in emission order, in which every gaussian's
// instances are contiguous.  The TPU summed each 128-instance sub-block
// with an indicator matmul on the MXU; a GPU thread can walk its run.
//
// Design: one thread per gaussian, 16 float32 accumulators, the run added
// in emission order.  Sequential sums, no atomics: deterministic, and
// bit-equal to the plain version, which adds in the same order.
// Neighbouring threads walk neighbouring runs, so a warp's reads of one
// column row fall in a short contiguous window.
//
// Bound on the H100: bytes.  Every column value inside some run is read
// once (16 * 4 bytes per instance) and the (N, 16) sums written once.
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
